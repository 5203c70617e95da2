"""The flash forward's two routes, on the CPU: which (dtype, head dim) takes
the wgmma kernel of ``csrc/flash_attention_fwd_sm90.cu`` ("sm90") and which
the mma kernel of ``csrc/flash_attention.cu`` ("mma"), that the forward and
the backward share one route rule, the C entry point and its argument
table, the forward wrapper's library, entry point and launch counters (with
a stand-in library), and the build's library name, which hashes the shared
``csrc/*.cuh`` headers.  Nothing here builds or loads a kernel; the kernel
itself is held against its plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import ctypes
import importlib.util
import pathlib
import re
import shutil

import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

FWD_SOURCE = "flash_attention_fwd_sm90"
ROUTE_SOURCES = {
    "sm90": {"fwd": FWD_SOURCE, "bwd_dq": "flash_attention_bwd_sm90",
             "bwd_dkv": "flash_attention_bwd_sm90"},
    "mma": {"fwd": "flash_attention", "bwd_dq": "flash_attention",
            "bwd_dkv": "flash_attention"},
}


class _FakeFn:
    """Stands in for one C entry point: records its calls, returns 0."""
    argtypes = None
    restype = None

    def __init__(self, name):
        self.name = name
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _FakeLib:
    def __init__(self, names):
        self.fns = {n: _FakeFn(n) for n in names}

    def __getattr__(self, name):
        try:
            return self.__dict__["fns"][name]
        except KeyError:
            raise AttributeError(name) from None


@pytest.fixture
def fake_libs(monkeypatch):
    """Every library of ``ENTRY_POINTS`` as a stand-in; returns (libs,
    names loaded in order)."""
    libs = {src: _FakeLib(fns) for src, fns in fa.ENTRY_POINTS.items()}
    loaded = []

    def fake_lib(name="flash_attention"):
        loaded.append(name)
        return fa._setup(libs[name], name)

    monkeypatch.setattr(fa, "_lib", fake_lib)
    return libs, loaded


@pytest.mark.parametrize("d", fa._HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(fa._DTYPE_CODE))
def test_one_route_for_the_forward_and_the_backward(fake_libs, dtype, d):
    """bf16 at d 64/128 is "sm90", the rest "mma", and each of the three
    kernels takes its entry point from that route's library."""
    libs, loaded = fake_libs
    want = "sm90" if dtype == torch.bfloat16 and d in (64, 128) else "mma"
    assert fa._route(dtype, d) == want
    q = torch.zeros((1, 4, 2, d), dtype=dtype)
    for which in ("fwd", "bwd_dq", "bwd_dkv"):
        loaded.clear()
        fn, sm90 = fa._entry(q, which)
        assert sm90 == (want == "sm90")
        assert loaded == [ROUTE_SOURCES[want][which]]
        assert fn.name == f"ptt_flash_{which}" + ("_sm90" if sm90 else "")


def _c_params(source, fn_name):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn_name + r"\(([^)]*)\)", text)
    assert m, f"{fn_name} not in {source}.cu"
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def test_entry_point_matches_its_source_and_the_mma_forward():
    """``ptt_flash_fwd_sm90`` takes ``ptt_flash_fwd``'s arguments: the same
    C parameter list and the same argument table."""
    assert set(fa.ENTRY_POINTS[FWD_SOURCE]) == {"ptt_flash_fwd_sm90"}
    assert FWD_SOURCE in _build.sources()
    argtypes = fa.ENTRY_POINTS[FWD_SOURCE]["ptt_flash_fwd_sm90"]
    assert argtypes == [ctypes.c_void_p] * 5 + fa._TAIL_ARGS
    assert argtypes == fa.ENTRY_POINTS["flash_attention"]["ptt_flash_fwd"]
    new = _c_params(FWD_SOURCE, "ptt_flash_fwd_sm90")
    assert len(new) == len(argtypes)
    assert new == _c_params("flash_attention", "ptt_flash_fwd")


def test_setup_sets_the_forward_table_without_loading():
    lib = _FakeLib(["ptt_flash_fwd_sm90"])
    assert fa._setup(lib, FWD_SOURCE) is lib
    fn = lib.fns["ptt_flash_fwd_sm90"]
    assert fn.argtypes == fa.ENTRY_POINTS[FWD_SOURCE]["ptt_flash_fwd_sm90"]
    assert fn.restype is ctypes.c_int


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 96),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64),
                                     (torch.float32, 128)])
@pytest.mark.parametrize("modes", ["", "mask", "dropout"])
def test_cuda_fwd_launches_the_routes_entry_point(monkeypatch, fake_libs,
                                                  dtype, d, modes):
    """``_cuda_fwd`` calls the route's entry point once with the tensors'
    pointers, the modes and the dims, and counts it in ``LAUNCHES_FWD`` and,
    on the sm90 route, in ``LAUNCHES_FWD_SM90`` (the device checks and the
    stream are stood in for, so it runs on CPU tensors here)."""
    libs, loaded = fake_libs
    monkeypatch.setattr(fa, "_check_cuda",
                        lambda q, k, v, causal, extra=(): [q, k, v])
    monkeypatch.setattr(fa, "_dims", lambda q, k, causal: (
        q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
        q.shape[3], int(causal), fa._DTYPE_CODE[q.dtype], 0))
    monkeypatch.setattr(fa, "LAUNCHES_FWD", 5)
    monkeypatch.setattr(fa, "LAUNCHES_FWD_SM90", 2)
    b, sq, sk, hq, hkv = 2, 48, 80, 4, 2
    q = torch.zeros((b, sq, hq, d), dtype=dtype)
    k = torch.zeros((b, sk, hkv, d), dtype=dtype)
    kw = {}
    if modes == "mask":
        kw["mask"] = torch.zeros((b, 1, sq, sk))
    elif modes == "dropout":
        kw.update(drop_p=0.25, seed=torch.tensor([3], dtype=torch.int32))
    out, lse = fa._cuda_fwd(q, k, k, True, **kw)
    route = fa._route(dtype, d)
    sm90 = route == "sm90"
    assert loaded == [ROUTE_SOURCES[route]["fwd"]]
    fn = getattr(libs[loaded[0]], "ptt_flash_fwd" + ("_sm90" if sm90 else ""))
    assert len(fn.calls) == 1
    args = fn.calls[0]
    assert len(args) == len(fa.ENTRY_POINTS["flash_attention"]["ptt_flash_fwd"])
    assert args[:5] == (q.data_ptr(), k.data_ptr(), k.data_ptr(),
                        out.data_ptr(), lse.data_ptr())
    assert args[-9:] == (b, sq, sk, hq, hkv, d, 1, fa._DTYPE_CODE[dtype], 0)
    assert (args[5] != 0) == (modes == "mask")
    assert (args[10] != 0) == (modes == "dropout")
    assert out.shape == q.shape and out.dtype == dtype
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert (fa.LAUNCHES_FWD, fa.LAUNCHES_FWD_SM90) == (6, 2 + sm90)


def test_cpu_forward_takes_the_plain_version(monkeypatch):
    """A CPU tensor on the sm90 route's dtype and head dim runs
    ``_reference_attention_lse``: no library, no launch counted."""
    def no_lib(*a, **k):
        raise AssertionError("a CPU tensor loaded a kernel library")

    monkeypatch.setattr(fa, "_lib", no_lib)
    n0 = (fa.LAUNCHES_FWD, fa.LAUNCHES_FWD_SM90)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 40, 2, 64), generator=g).to(torch.bfloat16)
               for _ in range(3))
    out, lse = fa.flash_forward(q, k, v, True)
    want, want_lse = fa._reference_attention_lse(q, k, v, True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert (fa.LAUNCHES_FWD, fa.LAUNCHES_FWD_SM90) == n0


def test_forward_source_includes_the_shared_headers():
    text = (_build.CSRC / f"{FWD_SOURCE}.cu").read_text()
    assert '#include "flash_common.cuh"' in text
    assert '#include "sm90.cuh"' in text
    # the kernel's name is the one profile_step.py sums as the forward
    assert "flash_fwd_sm90_kernel(" in text
    for definition in ("struct Modes {", "bool drop_keep(", "int kv_tiles(",
                       "Work work_of(", "Modes make_modes("):
        assert definition not in text


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


@pytest.mark.parametrize("header", ["sm90.cuh", "flash_common.cuh"])
def test_forward_target_changes_with_a_header(csrc_copy, header):
    before = _build._target(FWD_SOURCE)
    assert _build._target(FWD_SOURCE) == before
    path = csrc_copy / header
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    after = _build._target(FWD_SOURCE)
    assert after != before and after.parent == before.parent
    assert after.name.startswith(f"lib{FWD_SOURCE}-")


def test_mma_route_builds_no_bf16_forward_at_d64_or_d128():
    """bf16 at d 64/128 takes the sm90 forward only: the mma source's
    forward dispatches fp32 at every head dim and bf16 at d 96 and 256."""
    old = (_build.CSRC / "flash_attention.cu").read_text()
    body = old[old.index("#define PTT_DISPATCH_MMA"):]
    body = body[:body.index("} while (0)")]
    assert "FN<bf16, 96>" in body and "FN<bf16, 256>" in body
    assert "FN<bf16, 64>" not in body and "FN<bf16, 128>" not in body
    fn = old[old.index('extern "C" int ptt_flash_fwd('):]
    fn = fn[:fn.index("\n}")]
    assert "PTT_DISPATCH_MMA(fwd," in fn
    assert "#define PTT_DISPATCH(" not in old


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas_block(mangled, regs, spill):
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 0 barriers\n")


def test_chip_smoke_reads_the_sm90_kernels_ptxas_record():
    """``_sm90_ptxas`` names each sm90 kernel of a build log by its role,
    head dim and build, forward and backward alike."""
    cs = _chip_smoke()
    log = "".join(
        _ptxas_block(f"_ZN12_GLOBAL__N_1{len(nm)}{nm}ILi{d}ELb{m}EEEv14CUtensorMap",
                     168, 4 if (nm, d, m) == ("flash_fwd_sm90_kernel", 64, 1)
                     else 0)
        for nm in ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
                   "flash_bwd_dkv_sm90_kernel")
        for d in (64, 128) for m in (0, 1))
    rec = cs._sm90_ptxas(log)
    assert set(rec) == {f"{w} d{d}{m}" for w in ("fwd", "dq", "dkv")
                        for d in (64, 128) for m in ("", " modes")}
    assert rec["fwd d64 modes"]["spill_stores"] == 4
    assert rec["fwd d128"] == {"stack_bytes": 0, "spill_stores": 0,
                               "spill_loads": 0, "registers": 168}
