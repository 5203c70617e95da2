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


def test_model_and_engine_devices_must_agree():
    from paddle_tpu_torch.inference import LlamaGenerator
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    assert LlamaGenerator(model, device="cpu", max_seq_len=32).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            LlamaGenerator(model, device="cuda")


def test_cuda_only_paths_refuse_cpu_fallback():
    """The full-sequence flash attention has no Hopper kernel yet: a CUDA
    tensor raises rather than silently using the plain version.  (Checked
    through the dispatch on the tensor's device type.)"""
    from paddle_tpu_torch.kernels import flash_attention as fa
    meta = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(NotImplementedError, match="flash"):
        fa.flash_attention(meta, meta, meta, causal=True)


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
