"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu``'s serving and
training paths.

The JAX package ``paddle_tpu`` is the reference; this package serves and
trains the same Llama models on an NVIDIA Hopper card (sm_90a) with hand-written CUDA
kernels in place of the TPU's Pallas kernels.  It imports ``torch`` and never
``jax`` or ``paddle_tpu``.

Every entry point that makes tensors takes ``device=`` and defaults to
``"cuda"``: with no GPU the default raises instead of running on the CPU.
Pass ``device="cpu"`` to run the plain PyTorch versions of the kernels
(what the tests do).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"

# the card the port targets: H100 SXM, NVIDIA data sheet (dense rates)
PEAK_FLOPS = {"float32": 67e12,    # fp32 outside the tensor cores
              "bfloat16": 989e12}  # bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when a
    CUDA device is asked for and none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["__version__", "DEFAULT_DEVICE", "HBM_BYTES_PER_S", "PEAK_FLOPS",
           "resolve_device"]
