"""Autocast state read by the Paddle-API path's functional ops (the port of
``paddle_tpu/core/amp_state.py``, with its lists copied as they are).

The reference casts at its op-dispatch seam (``paddle_tpu/ops/_prim.py``
``apply_op`` -> ``core/autograd.py`` ``_amp_cast``) by op name.  The port has
no such seam: each functional op names itself in :func:`cast` on its
inputs, so the same ops cast at the same places.  ``torch.autocast`` is not
used: its lists differ.
"""

from __future__ import annotations

import threading

import torch

# O1 allow list: ops that are fast and numerically safe in half precision
WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "conv3d_transpose", "einsum", "addmm",
    "flash_attention", "fused_linear",
}

# O1/O2 block list: numerically sensitive reductions stay float32
BLACK_LIST = {
    "exp", "expm1", "log", "log2", "log10", "log1p", "pow", "square", "sqrt",
    "rsqrt", "softmax", "log_softmax", "cross_entropy",
    "softmax_with_cross_entropy", "layer_norm", "rms_norm", "group_norm",
    "instance_norm", "batch_norm", "mean", "sum", "prod", "cumsum",
    "logsumexp", "sigmoid_cross_entropy_with_logits", "binary_cross_entropy",
    "nll_loss", "kl_div", "erf", "erfinv", "norm", "cos_sim", "dist",
    "renorm", "reduce_sum", "softplus", "linspace",
}

_tls = threading.local()


class AmpAttrs:
    __slots__ = ("enabled", "level", "dtype", "white", "black")

    def __init__(self, enabled=False, level="O0", dtype="bfloat16",
                 white=(), black=()):
        self.enabled = enabled
        self.level = level
        self.dtype = dtype
        self.white = set(white)
        self.black = set(black)


_DISABLED = AmpAttrs()


def current() -> AmpAttrs:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else _DISABLED


def push(attrs: AmpAttrs):
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    _tls.stack.append(attrs)


def pop():
    _tls.stack.pop()


def cast(name: str, *tensors):
    """``tensors`` as op ``name`` receives them under the current autocast
    state (the reference's ``_amp_cast``): a black-listed op takes its
    half-precision inputs in float32; a white-listed op, or any op at O2,
    takes its float32 inputs in the amp dtype; every other input (and
    every input with autocast off) is unchanged.  ``None`` entries pass
    through."""
    amp = current()
    if not amp.enabled:
        return tensors
    amp_dtype = torch.bfloat16 if amp.dtype == "bfloat16" else torch.float16
    in_white = name in amp.white or (name in WHITE_LIST and
                                     name not in amp.black)
    in_black = name in amp.black or (name in BLACK_LIST and
                                     name not in amp.white)
    if in_black:
        target, src = torch.float32, amp_dtype
    elif in_white or amp.level == "O2":
        target, src = amp_dtype, torch.float32
    else:
        return tensors
    return tuple(t.to(target) if torch.is_tensor(t) and t.dtype == src
                 else t for t in tensors)
