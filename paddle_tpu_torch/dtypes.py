"""Paddle's dtype names as ``torch.dtype`` (the port of
``paddle_tpu/dtypes.py``).

The reference keeps numpy dtypes with Paddle's aliases and a default float
dtype; here every name maps to its ``torch.dtype``, and the default is
float32 until :func:`set_default_dtype` changes it.
"""

from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2
# the reference's non-numeric placeholder dtypes (string tensors, opaque
# bytes): markers only
pstring = "pstring"
raw = "raw"
dtype = torch.dtype     # the ``paddle.dtype`` type

_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "fp16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "fp32": float32, "float64": float64, "fp64": float64,
    "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn, "float8_e5m2": float8_e5m2,
}

FLOATING = {float16, bfloat16, float32, float64}
INTEGRAL = {uint8, int8, int16, int32, int64}

_default: list = [float32]


def convert_dtype(dtype) -> torch.dtype:
    """A Paddle name, numpy dtype or ``torch.dtype`` as a ``torch.dtype``
    (``None``: the default float dtype)."""
    if dtype is None:
        return _default[0]
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype in _ALIASES:
            return _ALIASES[dtype]
        dtype = np.dtype(dtype)
    name = np.dtype(dtype).name
    if name not in _ALIASES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _ALIASES[name]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in FLOATING


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in INTEGRAL


def set_default_dtype(dtype) -> None:
    d = convert_dtype(dtype)
    if d not in FLOATING:
        raise ValueError(f"default dtype must be floating, got {d}")
    _default[0] = d


def get_default_dtype() -> torch.dtype:
    return _default[0]
