"""The rest of the public op surface (the port of
``paddle_tpu/ops/extras.py``) and the in-place ``op_`` family."""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .. import dtypes
from ..core.random import generator
from ..core.tensor import boundary_module
from ..device import current
from ._generated import _float
from ._prim import autocast_module, make_inplace, rebind, t_


# ---------------------------------------------------------------- creation

def vander(x, n=None, increasing=False, name=None):
    x = t_(x)
    n = x.shape[0] if n is None else n
    powers = torch.arange(n, device=x.device, dtype=x.dtype)
    if not increasing:
        powers = powers.flip(0)
    return x[:, None] ** powers


def fill_constant(shape, dtype, value, name=None):
    return torch.full([int(s) for s in shape], value,
                      dtype=dtypes.convert_dtype(dtype), device=current())


def block_diag(inputs, name=None):
    return torch.block_diag(*[torch.atleast_2d(t_(i)) for i in inputs])


def polar(abs, angle, name=None):  # noqa: A002
    return torch.polar(t_(abs), t_(angle)).to(torch.complex64)


# ------------------------------------------------------------------- math

def sgn(x, name=None):
    """sign for real; x/|x| for complex."""
    return torch.sgn(t_(x))


def add_n(inputs, name=None):
    if torch.is_tensor(inputs):
        inputs = [inputs]
    out = t_(inputs[0])
    for a in inputs[1:]:
        out = out + t_(a)
    return out


def increment(x, value=1.0, name=None):
    """``x + value`` written back into ``x``."""
    with torch.no_grad():
        return rebind(x, x + value)


def take(x, index, mode="raise", name=None):
    """Flat-index gather: out[i] = x.flat[index[i]] (negative indices count
    from the end; "wrap" and "clip" as numpy)."""
    flat = t_(x).reshape(-1)
    idx = t_(index).long()
    n = flat.shape[0]
    if mode == "wrap":
        idx = ((idx % n) + n) % n
    elif mode == "clip":
        idx = torch.clamp(idx, -n, n - 1)
    idx = torch.where(idx < 0, idx + n, idx)
    return flat[idx]


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return torch.isin(t_(x), t_(test_x), assume_unique=assume_unique,
                      invert=invert)


def isneginf(x, name=None):
    return torch.isneginf(t_(x))


def isposinf(x, name=None):
    return torch.isposinf(t_(x))


def isreal(x, name=None):
    return torch.isreal(t_(x))


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    from .math import _quantile

    def fn(a, qt, dim):
        return torch.nanquantile(a, qt, dim=dim, interpolation=interpolation)
    return _quantile(fn, x, q, axis, keepdim)


def histogram_bin_edges(input, bins=100, min=0, max=0,  # noqa: A002
                        name=None):
    v = t_(input)
    if min != 0 or max != 0:
        lo = torch.full((), float(min), device=v.device)
        hi = torch.full((), float(max), device=v.device)
    else:
        lo, hi = v.min().float(), v.max().float()
    steps = torch.linspace(0.0, 1.0, bins + 1, device=v.device)
    return (lo + (hi - lo) * steps).to(torch.float32)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.cumulative_trapezoid(t_(y), t_(x), dim=axis)
    return torch.cumulative_trapezoid(t_(y), dx=1.0 if dx is None else dx,
                                      dim=axis)


def frexp(x, name=None):
    m, e = torch.frexp(_float(t_(x)))
    return m, e.to(torch.int32)


def multigammaln(x, p, name=None):
    v = _float(t_(x))
    js = torch.arange(1, p + 1, dtype=v.dtype, device=v.device)
    return (p * (p - 1) / 4.0) * math.log(math.pi) + \
        torch.lgamma(v[..., None] + (1 - js) / 2.0).sum(-1)


def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(t_(x))


def cholesky_inverse(x, upper=False, name=None):
    return torch.cholesky_inverse(t_(x), upper=upper)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-distances by differences (no matmul shortcut), as the
    reference computes them."""
    a, b = t_(x), t_(y)
    diff = a[..., :, None, :] - b[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    if p == float("inf"):
        return diff.abs().amax(-1)
    return (diff.abs() ** p).sum(-1) ** (1.0 / p)


def cartesian_prod(x, name=None):
    if torch.is_tensor(x):
        x = [x]
    if len(x) == 1:
        return t_(x[0])
    return torch.cartesian_prod(*[t_(i) for i in x])


def combinations(x, r=2, with_replacement=False, name=None):
    v = t_(x)
    n = v.shape[0]
    it = itertools.combinations_with_replacement if with_replacement \
        else itertools.combinations
    idx = list(it(range(n), r))
    if not idx:
        return torch.zeros((0, r), dtype=v.dtype, device=v.device)
    return v[torch.tensor(idx, dtype=torch.long, device=v.device)]


def log_normal(mean=1.0, std=2.0, shape=None, dtype="float32", name=None):
    dev = current()
    z = torch.randn(tuple(shape or ()), dtype=torch.float32, device=dev,
                    generator=generator(dev))
    return torch.exp(mean + std * z).to(dtypes.convert_dtype(dtype))


def standard_gamma(alpha, name=None):
    a = t_(alpha)
    return torch._standard_gamma(a, generator=generator(a.device))


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD (the reference's algorithm: a Gaussian
    sketch, ``niter`` power steps, QR, the SVD of the projection)."""
    a = t_(x)
    A = a - t_(M) if M is not None else a
    m, n = A.shape[-2:]
    k = min(q, m, n)
    G = torch.randn(A.shape[:-2] + (n, k), dtype=A.dtype, device=A.device,
                    generator=generator(A.device))
    Y = A @ G
    for _ in range(niter):
        Y = A @ (A.transpose(-1, -2) @ Y)
    Q, _ = torch.linalg.qr(Y)
    B = Q.transpose(-1, -2) @ A
    u, s, vh = torch.linalg.svd(B, full_matrices=False)
    return Q @ u, s, vh.transpose(-1, -2)


# --------------------------------------------------------- scatter family

def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal_scatter(t_(x), t_(y), offset, axis1, axis2)


def select_scatter(x, values, axis, index, name=None):
    return torch.select_scatter(t_(x), t_(values), axis, index)


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    out, src = t_(x), t_(value)
    idx = [slice(None)] * out.ndim
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx[ax] = slice(s, e, st)
    out = out.clone()
    out[tuple(idx)] = src.to(out.dtype)
    return out


def masked_scatter(x, mask, value, name=None):
    """Masked positions of ``x`` filled with consecutive elements of
    ``value``."""
    v, m, src = t_(x), t_(mask).bool(), t_(value)
    m = m.expand(v.shape)
    flat_m = m.reshape(-1)
    pos = torch.cumsum(flat_m.to(torch.int64), 0) - 1
    gathered = src.reshape(-1)[torch.clamp(pos, 0, src.numel() - 1)]
    return torch.where(flat_m, gathered.to(v.dtype),
                       v.reshape(-1)).reshape(v.shape)


# ------------------------------------------------------------ dtype preds

def is_floating_point(x) -> bool:
    return torch.is_floating_point(t_(x))


def is_integer(x) -> bool:
    return dtypes.is_integer(t_(x).dtype)


def is_complex(x) -> bool:
    return torch.is_complex(t_(x))


def is_empty(x):
    x = t_(x)
    return torch.full((), x.numel() == 0, device=x.device)


# --------------------------------------------------------------- printing

_PRINT_OPTS = {"precision": 8, "threshold": 1000, "edgeitems": 3,
               "linewidth": 80, "sci_mode": None}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Applied to the numpy rendering of ``Tensor.__repr__``."""
    for k, v in (("precision", precision), ("threshold", threshold),
                 ("edgeitems", edgeitems), ("sci_mode", sci_mode),
                 ("linewidth", linewidth)):
        if v is not None:
            _PRINT_OPTS[k] = v
    np.set_printoptions(
        precision=_PRINT_OPTS["precision"],
        threshold=_PRINT_OPTS["threshold"],
        edgeitems=_PRINT_OPTS["edgeitems"],
        linewidth=_PRINT_OPTS["linewidth"],
        suppress=(_PRINT_OPTS["sci_mode"] is False))


def view_as(x, other, name=None):
    return t_(x).reshape(list(t_(other).shape))


def unfold(x, axis, size, step, name=None):
    """Sliding windows along ``axis``, the window last."""
    return t_(x).unfold(axis, size, step)


__all__ = ["vander", "fill_constant", "block_diag", "polar", "sgn", "add_n",
           "increment", "take", "isin", "isneginf", "isposinf", "isreal",
           "nanquantile", "histogram_bin_edges", "cumulative_trapezoid",
           "frexp", "multigammaln", "matrix_exp", "cholesky_inverse",
           "cdist", "cartesian_prod", "combinations", "log_normal",
           "standard_gamma", "svd_lowrank", "diagonal_scatter",
           "select_scatter", "slice_scatter", "masked_scatter",
           "is_floating_point", "is_integer", "is_complex", "is_empty",
           "set_printoptions", "view_as", "unfold"]
autocast_module(globals())
boundary_module(globals(), [n for n in __all__ if n not in (
    "increment", "is_floating_point", "is_integer", "is_complex",
    "set_printoptions")])


# ------------------------------------------------------- inplace variants

INPLACE_BASES = [
    "abs", "acos", "asin", "atan", "ceil", "cos", "cosh", "exp", "expm1",
    "floor", "log", "log2", "log10", "log1p", "neg", "reciprocal", "round",
    "rsqrt", "sigmoid", "sin", "sinh", "sqrt", "square", "tan", "tanh",
    "trunc", "frac", "erf", "erfinv", "digamma", "lgamma", "logit", "i0",
    "gammaln", "asinh", "acosh", "atanh",
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "pow", "clip", "lerp", "copysign", "hypot", "ldexp", "gcd", "lcm",
    "nan_to_num", "sinc",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "equal", "not_equal", "greater_equal", "greater_than", "less_equal",
    "less_than", "cumsum", "cumprod", "fill_diagonal", "squeeze",
    "unsqueeze", "flatten", "tril", "triu", "cast", "scatter", "index_add",
    "index_put", "masked_fill", "put_along_axis", "t", "transpose"]


def install_inplace_variants(ns: dict):
    """The ``op_`` family for every base in ``ns`` without one (reference
    ``generate_inplace_fn``): each writes its result back into its first
    argument (:func:`._prim.rebind`)."""
    made = {}
    for b in INPLACE_BASES:
        fn = ns.get(b)
        if fn is None or f"{b}_" in ns:
            continue
        made[f"{b}_"] = make_inplace(f"{b}_", fn)
    return made
