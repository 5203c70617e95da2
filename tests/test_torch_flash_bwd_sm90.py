"""The flash backward's two routes, on the CPU: which (dtype, head dim) takes
the wgmma kernels of ``csrc/flash_attention_bwd_sm90.cu`` ("sm90") and which
the mma kernels of ``csrc/flash_attention.cu`` ("mma"), the C entry points
and their argument tables, and the build's library names, which hash the
shared ``csrc/*.cuh`` headers.  Nothing here builds or loads a kernel; the
kernels themselves are held against their plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""

import ctypes
import re
import shutil

import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

SM90_SOURCE = "flash_attention_bwd_sm90"


@pytest.mark.parametrize("d", fa._HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(fa._DTYPE_CODE))
def test_bwd_route_by_dtype_and_head_dim(dtype, d):
    want = "sm90" if dtype == torch.bfloat16 and d in (64, 128) else "mma"
    assert fa._route(dtype, d) == want


class _FakeFn:
    argtypes = None
    restype = None

    def __init__(self, name):
        self.name = name


class _FakeLib:
    """Stands in for a loaded ``CDLL``: one function object per name."""

    def __init__(self, names):
        self.fns = {n: _FakeFn(n) for n in names}

    def __getattr__(self, name):
        try:
            return self.__dict__["fns"][name]
        except KeyError:
            raise AttributeError(name) from None


def _c_arg_count(source, fn_name):
    """Number of parameters of ``extern "C" int fn_name(...)`` in
    ``csrc/<source>.cu``."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn_name + r"\(([^)]*)\)", text)
    assert m, f"{fn_name} not in {source}.cu"
    return len(m.group(1).split(","))


@pytest.mark.parametrize("source,fn_name", [
    (src, fn) for src, fns in fa.ENTRY_POINTS.items() for fn in fns])
def test_entry_points_match_their_sources(source, fn_name):
    """Every entry point in the table is a C function of its source with as
    many parameters as the table has argument types; the sm90 ones take
    today's arguments."""
    argtypes = fa.ENTRY_POINTS[source][fn_name]
    assert _c_arg_count(source, fn_name) == len(argtypes)
    if fn_name.endswith("_sm90"):
        assert argtypes == fa.ENTRY_POINTS["flash_attention"][
            fn_name[:-len("_sm90")]]


@pytest.mark.parametrize("source", sorted(fa.ENTRY_POINTS))
def test_setup_sets_argument_tables_without_loading(source):
    names = list(fa.ENTRY_POINTS[source])
    lib = _FakeLib(names)
    assert fa._setup(lib, source) is lib
    for n in names:
        assert lib.fns[n].argtypes == fa.ENTRY_POINTS[source][n]
        assert lib.fns[n].restype is ctypes.c_int
    # a second setup keeps the tables (set once)
    kept = {n: lib.fns[n].argtypes for n in names}
    fa._setup(lib, source)
    assert {n: lib.fns[n].argtypes for n in names} == kept


def test_sm90_entry_points_are_in_the_table():
    assert set(fa.ENTRY_POINTS[SM90_SOURCE]) == {
        "ptt_flash_bwd_dq_sm90", "ptt_flash_bwd_dkv_sm90"}
    assert SM90_SOURCE in _build.sources()


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 96),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 128)])
@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_bwd_fn_takes_the_routes_library(monkeypatch, dtype, d, which):
    """``_entry`` picks a backward kernel's library and entry point by
    ``_route`` alone (no try, no fallback)."""
    libs = {src: _FakeLib(fns) for src, fns in fa.ENTRY_POINTS.items()}
    loaded = []

    def fake_lib(name="flash_attention"):
        loaded.append(name)
        return fa._setup(libs[name], name)

    monkeypatch.setattr(fa, "_lib", fake_lib)
    q = torch.zeros((1, 4, 2, d), dtype=dtype)
    fn, sm90 = fa._entry(q, f"bwd_{which}")
    route = fa._route(dtype, d)
    assert sm90 == (route == "sm90")
    src = SM90_SOURCE if sm90 else "flash_attention"
    assert loaded == [src]
    assert fn.name == (f"ptt_flash_bwd_{which}_sm90" if sm90
                       else f"ptt_flash_bwd_{which}")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


@pytest.mark.parametrize("header", ["sm90.cuh", "flash_common.cuh"])
@pytest.mark.parametrize("source", [SM90_SOURCE, "flash_attention"])
def test_target_changes_with_a_header(csrc_copy, header, source):
    """A changed ``csrc/*.cuh`` names a new library for every source (no
    stale library is loaded); unchanged files keep the name."""
    before = _build._target(source)
    assert _build._target(source) == before
    path = csrc_copy / header
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    after = _build._target(source)
    assert after != before and after.parent == before.parent
    assert after.name.startswith(f"lib{source}-")


def test_target_changes_with_a_new_header(csrc_copy):
    before = _build._target(SM90_SOURCE)
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build._target(SM90_SOURCE) != before


def test_sm90_source_includes_the_shared_headers():
    text = (_build.CSRC / f"{SM90_SOURCE}.cu").read_text()
    assert '#include "flash_common.cuh"' in text
    assert '#include "sm90.cuh"' in text
    old = (_build.CSRC / "flash_attention.cu").read_text()
    assert '#include "flash_common.cuh"' in old
    # the shared definitions live only in the header
    for definition in ("struct Modes {", "bool drop_keep(", "int kv_tiles(",
                       "bool masked(", "uint32_t drop_base("):
        assert definition not in old


def test_mma_route_builds_no_bf16_backward_at_d64_or_d128():
    """bf16 at d 64/128 takes the sm90 kernels only: the mma source's
    backward entry points dispatch fp32 at every head dim and bf16 at d 96
    and 256, so no unreachable kernel is built."""
    old = (_build.CSRC / "flash_attention.cu").read_text()
    body = old[old.index("#define PTT_DISPATCH_MMA"):]
    body = body[:body.index("} while (0)")]
    assert "FN<bf16, 96>" in body and "FN<bf16, 256>" in body
    assert "FN<bf16, 64>" not in body and "FN<bf16, 128>" not in body
    for entry in ("ptt_flash_bwd_dq", "ptt_flash_bwd_dkv"):
        fn = old[old.index(f'extern "C" int {entry}('):]
        fn = fn[:fn.index("\n}")]
        assert "PTT_DISPATCH_MMA(" in fn
