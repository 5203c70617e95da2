"""``paddle.linalg`` (the port of ``paddle_tpu/linalg.py``): the functions
of :mod:`paddle_tpu_torch.ops.linalg`, ``cholesky_inverse``,
``matrix_exp``, ``svd_lowrank`` and ``fp8_fp8_half_gemm_fused``."""

from __future__ import annotations

import torch

from . import dtypes as _d
from .core.tensor import boundary as _boundary
from .ops import linalg as _l
from .ops._prim import t_ as _t
from .ops.extras import cholesky_inverse, matrix_exp, svd_lowrank  # noqa: F401

__all__ = list(_l.__all__)
for _n in __all__:
    globals()[_n] = getattr(_l, _n)

__all__ += ["cholesky_inverse", "matrix_exp", "svd_lowrank",
            "fp8_fp8_half_gemm_fused"]


@_boundary
def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, scale=1.0,
                            output_dtype="float16", name=None):
    """``x`` and ``y`` rounded to float8 e4m3, multiplied with float32
    accumulation, scaled, the bias added, in ``output_dtype`` (the
    reference's arithmetic; the products of two e4m3 values are exact in
    float32)."""
    a = _t(x).to(torch.float8_e4m3fn).float()
    b = _t(y).to(torch.float8_e4m3fn).float()
    if transpose_x:
        a = a.transpose(-2, -1)
    if transpose_y:
        b = b.transpose(-2, -1)
    out = torch.matmul(a, b) * scale
    if bias is not None:
        out = out + _t(bias).float()
    return out.to(_d.convert_dtype(output_dtype))
