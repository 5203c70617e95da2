"""Rules of the PyTorch port: it never imports JAX or the JAX package, its
entry points default to the GPU and refuse to fall back to the CPU, and
``chip_smoke.py`` fails without a card before allocating anything."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"

torch.set_num_threads(2)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert PORT / "kernels" / "primitives.py" in files
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, bad


def test_importing_the_serving_stack_loads_no_jax():
    code = ("import paddle_tpu_torch.serving.server, "
            "paddle_tpu_torch.serving.__main__, paddle_tpu_torch.inference, "
            "sys; assert 'jax' not in sys.modules; "
            "assert 'paddle_tpu' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_importing_the_training_stack_loads_no_jax():
    code = ("import paddle_tpu_torch.models.pretrain, "
            "paddle_tpu_torch.kernels.flash_attention, "
            "paddle_tpu_torch.profile_step, sys; "
            "assert 'jax' not in sys.modules; "
            "assert 'paddle_tpu' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_default_device_is_cuda_and_raises_without_gpu():
    """Entry points run on the card unless the caller asks for the CPU:
    with no GPU the default raises instead of carrying on on the CPU."""
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            LlamaGenerator)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaGenerator(model)
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatchingEngine(model)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    from paddle_tpu_torch.serving.__main__ import build_engine, build_parser
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine(build_parser().parse_args([]))
    from paddle_tpu_torch.models import pretrain
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain.PretrainStep(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain.build_trainer(pretrain.build_parser().parse_args(
            ["--preset", "tiny"]))


def test_training_entry_point_defaults_to_the_card():
    """``python -m paddle_tpu_torch.models.pretrain`` with no --device
    refuses to run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.models.pretrain",
                        "--preset", "tiny", "--steps", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "cuda" in r.stderr
    assert '"loss"' not in r.stdout


def test_model_and_engine_devices_must_agree():
    from paddle_tpu_torch.inference import LlamaGenerator
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert LlamaGenerator(model, device="cpu", max_seq_len=32).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            LlamaGenerator(model, device="cuda")


def test_cuda_only_paths_refuse_cpu_fallback():
    """Flash attention, the grouped matmuls and the weight-only matmul take
    their plain versions only for a CPU tensor: a tensor on any other
    device launches a kernel or raises, forward and backward alike (checked
    through the dispatch on the device type; the CUDA launches are
    tests/test_torch_cuda_kernels.py's)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    meta = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(NotImplementedError, match="flash"):
        fa.flash_attention(meta, meta, meta, causal=True)
    lse = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(NotImplementedError, match="flash"):
        fa.flash_backward(meta, meta, meta, meta, lse, meta, True)
    # the grouped matmuls likewise, forward and backward modes
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    x = torch.empty((16, 64), device="meta")
    w = torch.empty((2, 64, 64), device="meta")
    tg = torch.zeros((2,), dtype=torch.int32, device="meta")
    for call in (lambda: gm.gmm(x, w, tg, bm=8),
                 lambda: gm.gmm(x, w, tg, bm=8, trans_rhs=True),
                 lambda: gm.tgmm(x, x, tg, 2, bm=8)):
        with pytest.raises(ValueError, match="device"):
            call()
    # the weight-only matmul and the linear over it, int8 and int4
    from paddle_tpu_torch.kernels import weight_only as wo
    from paddle_tpu_torch.quantization import weight_only_linear
    xq = torch.empty((4, 64), device="meta")
    q8 = torch.empty((64, 32), dtype=torch.int8, device="meta")
    q4 = torch.empty((32, 32), dtype=torch.int8, device="meta")
    s = torch.empty((32,), device="meta")
    for call in (lambda: wo.weight_only_matmul(xq, q8, s),
                 lambda: wo.weight_only_matmul(xq, q4, s, int4_rows=64),
                 lambda: weight_only_linear(xq, q8, weight_scale=s),
                 lambda: weight_only_linear(xq, q4, weight_scale=s,
                                            weight_dtype="int4")):
        with pytest.raises(ValueError, match="device"):
            call()


def test_new_routes_refuse_cpu_fallback(monkeypatch):
    """The gmm and tgmm sm90 routes (bf16) and the attention split route (T
    x group <= 16) take their plain versions only for CPU tensors: on a meta
    tensor each raises before any plain version runs, as the simt and tile
    routes do."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.kernels import paged_attention as pa

    def plain(*args, **kw):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(gm, "_gmm_reference", plain)
    monkeypatch.setattr(gm, "_tgmm_reference", plain)
    monkeypatch.setattr(pa, "_reference_ragged_paged_attention", plain)
    bf = dict(device="meta", dtype=torch.bfloat16)
    x, w = torch.empty((256, 64), **bf), torch.empty((2, 64, 128), **bf)
    for bm in (16, 128):                       # narrow and wide forms
        tg = torch.zeros((256 // bm,), dtype=torch.int32, device="meta")
        assert gm._route(x.dtype) == "sm90"
        for trans in (False, True):
            with pytest.raises(ValueError, match="device"):
                gm.gmm(x, w.transpose(1, 2) if trans else w, tg, bm=bm,
                       trans_rhs=trans)
        # tgmm, plain and with its fused gather and scale (cp.async and
        # TMA operands alike)
        y = torch.empty((256, 128), **bf)
        rows = torch.zeros((256,), dtype=torch.int32, device="meta")
        s = torch.empty((256,), **bf)
        for kw in ({}, {"lhs_rows": rows}, {"rhs_rows": rows,
                                            "rhs_scale": s}):
            with pytest.raises(ValueError, match="device"):
                gm.tgmm(x, y, tg, 2, bm=bm, **kw)
    kc = torch.empty((2, 8, 16, 64), **bf)
    bt = torch.zeros((3, 4), dtype=torch.int32, device="meta")
    ctx = torch.zeros((3,), dtype=torch.int32, device="meta")
    for T in (1, 4, 64):                      # split, split, tile
        q = torch.empty((3, T, 8, 64), **bf)
        assert pa.launch_plan(q, kc, bt)["route"] == \
            ("tile" if T == 64 else "split")
        with pytest.raises(ValueError, match="device"):
            pa.ragged_paged_attention(q, kc, kc, bt, ctx)
        with pytest.raises(ValueError, match="device"):
            pa.ragged_paged_attention(q, kc, kc, bt, ctx,
                                      k_scale=torch.empty((2, 8),
                                                          device="meta"),
                                      v_scale=torch.empty((2, 8),
                                                          device="meta"))


def test_primitives_refuse_cpu_fallback():
    """The primitive generators take their plain versions only for CPU
    tensors: a meta tensor raises, and so does a function with no CUDA body
    on any tensor that is not on the CPU (the CUDA launches are
    tests/test_torch_cuda_kernels.py's)."""
    from paddle_tpu_torch.kernels import primitives as P
    x = torch.empty((8, 32), device="meta")
    full = {"elementwise": P.KernelFn(lambda a, b: a * b, "return a * b;"),
            "reduce": P.KernelFn(torch.add, "return a + b;"),
            "matmul": P.KernelFn(lambda a: a * 2, "return a * 2.0f;")}
    plain = {k: P.KernelFn(f.torch) for k, f in full.items()}
    calls = {"elementwise": lambda fn: P.elementwise_kernel(fn)(x, x),
             "reduce": lambda fn: P.reduce_kernel(fn, 0.0)(x),
             "matmul": lambda fn: P.matmul_kernel(epilogue=fn)(x, x.T)}
    for kind, call in calls.items():
        with pytest.raises(ValueError, match="device"):
            call(full[kind])
        with pytest.raises(ValueError, match="CUDA body"):
            call(plain[kind])
    # a bare callable is a function with no CUDA body
    with pytest.raises(ValueError, match="CUDA body"):
        P.elementwise_kernel(lambda a: a)(x)
    # matmul with no epilogue has one (the identity), so it reaches the
    # device check
    with pytest.raises(ValueError, match="device"):
        P.matmul_kernel()(x, x.T)
    # and a CPU tensor still runs the plain version
    xc = torch.ones((2, 3))
    assert torch.equal(P.elementwise_kernel(lambda a: a + 1)(xc), xc + 1)


def test_importing_nn_functional_loads_no_jax():
    code = ("import paddle_tpu_torch.nn, paddle_tpu_torch.nn.functional, sys; "
            "assert 'jax' not in sys.modules; "
            "assert 'paddle_tpu' not in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_flash_modes_refuse_cpu_fallback(monkeypatch):
    """Masked, dropout and varlen calls (and nn.functional's flash ops) on a
    tensor that is neither on the CPU nor on a card raise, and never reach
    a plain version."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.kernels import flash_attention as fa
    reached = []

    def plain(*args, **kw):
        reached.append(args)
        raise AssertionError("the plain version ran")

    for name in ("_reference_attention_lse", "_flash_bwd_dq",
                 "_flash_bwd_dkv"):
        monkeypatch.setattr(fa, name, plain)
    x = torch.empty((1, 64, 2, 64), device="meta")
    mask = torch.empty((1, 1, 64, 64), device="meta")
    cu = torch.tensor([0, 30, 64], dtype=torch.int32, device="meta")
    lse = torch.empty((1, 2, 64), device="meta")
    seed = torch.zeros((1,), dtype=torch.int32, device="meta")
    F = nn.functional
    for call in (
            lambda: fa.flash_attention(x, x, x, causal=True, attn_mask=mask),
            lambda: fa.flash_attention(x, x, x, dropout=0.1),
            lambda: fa.flash_attention(x, x, x, attn_mask=mask, dropout=0.5),
            lambda: fa.flash_attn_varlen(x[0], x[0], x[0], cu, cu),
            lambda: fa.flash_backward(x, x, x, x, lse, x, False, mask=mask,
                                      drop_p=0.1, seed=seed),
            lambda: F.flash_attention(x, x, x, dropout=0.1, causal=True),
            lambda: F.flash_attn_qkvpacked(torch.stack([x, x, x], 2)),
            lambda: F.flash_attn_varlen_qkvpacked(
                torch.stack([x[0]] * 3, 1), cu, cu)):
        with pytest.raises(NotImplementedError, match="flash"):
            call()
    # the causal varlen's eager packing check cannot read meta values
    with pytest.raises(NotImplementedError):
        fa.flash_attn_varlen(x[0], x[0], x[0], cu, cu, causal=True)
    assert not reached


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CPU fallback: without CUDA the script exits non-zero and prints
    no result; alone in a directory (no package) it cannot pass either."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=60,
                       env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=60, env=env)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
