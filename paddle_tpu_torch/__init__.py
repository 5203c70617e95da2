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

The Paddle API (``import paddle_tpu_torch as paddle``: ``paddle.nn``,
``paddle.optimizer``, ``paddle.amp``, ``paddle.vision``,
``paddle.incubate``, ``paddle.io``, ``paddle.metric``, ``paddle.Model``
with ``paddle.callbacks``, ``paddle.summary`` / ``paddle.flops``,
``paddle.save`` / ``paddle.load``, ``paddle.to_tensor``, ``paddle.seed`` and
the ops)
places its tensors on the device ``paddle.set_device`` chose, by default the
card; ``set_device("cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"
version = __version__

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


# the Paddle API (after resolve_device, which its modules import)
from . import dtypes  # noqa: E402
from .core.random import get_rng_state, seed, set_rng_state  # noqa: E402
from .core.tensor import Parameter, Tensor, is_tensor, to_tensor  # noqa: E402
from .device import device_count, get_device, set_device  # noqa: E402
from .dtypes import (bfloat16, bool_, complex64, complex128,  # noqa: E402
                     dtype, float8_e4m3fn, float8_e5m2, float16, float32,
                     float64, get_default_dtype, int8, int16, int32, int64,
                     pstring, raw, set_default_dtype, uint8)
from . import errors  # noqa: E402
from .flags import get_flags, set_flags  # noqa: E402
from .ops import *  # noqa: E402,F401,F403
from .ops import __all__ as _OPS  # noqa: E402
from . import (amp, autograd, device, incubate, nn, optimizer,  # noqa: E402
               regularizer, vision)
from .autograd import (enable_grad, grad, is_grad_enabled,  # noqa: E402
                       no_grad, set_grad_enabled)
from . import linalg  # noqa: E402
from .nn.layer import ParamAttr  # noqa: E402
from . import framework, hapi, io, metric  # noqa: E402
from .framework import load, save  # noqa: E402
from .hapi import Model, flops, summary  # noqa: E402
from .hapi import callbacks  # noqa: E402

def is_compiled_with_cuda() -> bool:
    """True: the port is built for the card."""
    return True


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False


__all__ = ["__version__", "Tensor", "complex64", "complex128", "dtype",
           "float8_e4m3fn", "float8_e5m2", "enable_grad",
           "set_grad_enabled", "is_grad_enabled", "get_flags", "set_flags",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "is_compiled_with_xpu", "errors", "version", "pstring", "raw",
           "linalg", "DEFAULT_DEVICE", "HBM_BYTES_PER_S", "PEAK_FLOPS",
           "resolve_device", "Model", "Parameter", "ParamAttr", "amp",
           "autograd", "bfloat16", "bool_", "callbacks", "device", "dtypes",
           "float16", "float32", "float64", "flops", "framework",
           "get_default_dtype", "get_device", "get_rng_state", "grad",
           "hapi", "incubate", "int8", "int16", "int32", "int64", "io",
           "is_tensor", "load", "metric", "nn", "no_grad", "optimizer",
           "save", "seed", "set_default_dtype", "set_device",
           "set_rng_state", "summary", "to_tensor", "uint8",
           "vision"] + _OPS
