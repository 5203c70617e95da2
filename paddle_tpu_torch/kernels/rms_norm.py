"""RMSNorm with fp32 accumulation (port of ``paddle_tpu/kernels/rms_norm.py``).

Plain PyTorch: the reference leaves this to XLA fusion and has no Pallas
kernel for it.
"""

from __future__ import annotations

import torch


def rms_norm_fp32(x, weight, eps: float, bias=None, dim=(-1,)):
    """RMSNorm with fp32 accumulation over ``dim``, returning x.dtype."""
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=dim, keepdim=True) + eps)
    out = h * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


# Paddle-API tensors handed to a kernel's entry run it on plain tensors
from ..core.tensor import plain_module  # noqa: E402

plain_module(globals())
