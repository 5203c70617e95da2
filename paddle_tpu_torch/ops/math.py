"""Elementwise math and reductions (the port of ``paddle_tpu/ops/math.py``):
the table ops of :mod:`._generated` and the ops with signatures of their
own.  Each takes and returns tensors on the Paddle-API boundary."""

from __future__ import annotations

import torch

from .. import dtypes
from ..core.tensor import boundary_module
from ._generated import *  # noqa: F401,F403
from ._generated import _float
from ._prim import autocast_module, axes, t_


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = t_(x)
    s = scale.to(x.dtype) if torch.is_tensor(scale) else scale
    return x * s + bias if bias_after_scale else (x + bias) * s


def multiplex(inputs, index, name=None):
    arrs = torch.stack([t_(i) for i in inputs])
    idx = t_(index).reshape(-1)
    return arrs[idx, torch.arange(idx.shape[0], device=idx.device)]


def clip(x, min=None, max=None, name=None):  # noqa: A002
    lo = min.item() if torch.is_tensor(min) else min
    hi = max.item() if torch.is_tensor(max) else max
    return torch.clamp(t_(x), lo, hi)


def lerp(x, y, weight, name=None):
    x, y = t_(x), t_(y)
    return x + weight * (y - x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * t_(x))


def _dims_or_none(x, axis):
    return None if axis is None else axes(x, axis)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _float(t_(x))
    return torch.std(x, dim=_dims_or_none(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _float(t_(x))
    return torch.var(x, dim=_dims_or_none(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim):
    """``fn`` (``torch.quantile`` / ``nanquantile``, linear) over one or
    more axes: the axes are moved last and merged first."""
    x = _float(t_(x))
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0)
        if keepdim:
            out = out.reshape(out.shape[:qt.ndim] + (1,) * x.ndim)
        return out
    dims = sorted(d % x.ndim for d in axes(x, axis))
    rest = [d for d in range(x.ndim) if d not in dims]
    xm = x.permute(rest + dims).reshape([x.shape[d] for d in rest] + [-1])
    out = fn(xm, qt, dim=-1)
    if qt.ndim:
        out = out.movedim(0, -1)
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d)
    if qt.ndim:
        out = out.movedim(-1, 0)
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    x = t_(x)
    dt = None if dtype is None else dtypes.convert_dtype(dtype)
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=dt)
    return torch.cumsum(x, int(axis), dtype=dt)


def cumprod(x, dim=None, dtype=None, name=None):
    x = t_(x)
    dt = None if dtype is None else dtypes.convert_dtype(dtype)
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=dt)
    return torch.cumprod(x, int(dim), dtype=dt)


def cummax(x, axis=None, dtype="int64", name=None):
    x = t_(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    v, i = torch.cummax(x, int(axis))
    return v, i.to(dtypes.convert_dtype(dtype))


def cummin(x, axis=None, dtype="int64", name=None):
    x = t_(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    v, i = torch.cummin(x, int(axis))
    return v, i.to(dtypes.convert_dtype(dtype))


def logcumsumexp(x, axis=None, name=None):
    x = _float(t_(x))
    if axis is None:
        return torch.logcumsumexp(x.reshape(-1), 0)
    return torch.logcumsumexp(x, int(axis))


def _arg(fn, x, axis, keepdim, dtype):
    x = t_(x)
    if axis is None:
        out = fn(x.reshape(-1), 0)
    else:
        out = fn(x, int(axis), keepdim=keepdim)
    return out.to(dtypes.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = t_(x), t_(y)
    return torch.tensor(torch.allclose(x, y.to(x.dtype), rtol=rtol,
                                       atol=atol, equal_nan=equal_nan),
                        device=x.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = t_(x), t_(y)
    return torch.isclose(x, y.to(x.dtype), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def equal_all(x, y, name=None):
    x, y = t_(x), t_(y)
    return torch.tensor(x.shape == y.shape and bool(torch.equal(
        x, y.to(x.dtype))), device=x.device)


def kron(x, y, name=None):
    return torch.kron(t_(x), t_(y))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(t_(x), n=n, dim=axis,
                      prepend=None if prepend is None else t_(prepend),
                      append=None if append is None else t_(append))


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = t_(y)
    if x is not None:
        return torch.trapezoid(y, t_(x), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(t_(x), nan=nan, posinf=posinf, neginf=neginf)


def renorm(x, p, axis, max_norm, name=None):
    """Slices along ``axis`` whose p-norm exceeds ``max_norm`` scaled down
    to it (the reference's formula, not torch's ``1e-7`` offset)."""
    x = t_(x)
    dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp(norms, min=1e-12),
                         torch.ones_like(norms))
    return x * factor


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return beta * t_(input) + alpha * (t_(x) @ t_(y))


def polygamma(x, n, name=None):
    return torch.polygamma(int(n), _float(t_(x)))


_OWN = ["scale", "multiplex", "clip", "lerp", "stanh", "std", "var",
        "median", "quantile", "nanmedian", "cumsum", "cumprod", "cummax",
        "cummin", "logcumsumexp", "argmax", "argmin", "allclose", "isclose",
        "equal_all", "kron", "diff", "trapezoid", "nan_to_num", "renorm",
        "addmm", "polygamma"]
autocast_module(globals())
boundary_module(globals(), _OWN)
