"""The table ops (the port of ``paddle_tpu/ops/schema.yaml`` and the
``_generated.py`` its generator writes): one row an op, ``(op, kind, impl,
aliases)``, made into functions by the factories of :mod:`._prim`.

The rows are the reference schema's, in its order, with the same kinds
and aliases (``tests/test_torch_ops_table.py`` reads the schema and holds
this table to it).  ``impl`` is the torch function: a unary ``f(x)``, a
binary ``f(x, y)``, a reduction ``f(x, dims, keepdim, dtype)``.
"""

from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from ._prim import binary_op, reduce_op, unary_op


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _real(x):
    return torch.real(x) if x.is_complex() else x


def _angle(x):
    out = torch.angle(x)
    return out if out.is_floating_point() else out.to(
        torch.get_default_dtype())


def _float(x):
    """Integer and bool inputs of a float-valued op in the default float
    dtype (jax promotes them so)."""
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.get_default_dtype())


def _unary_float(fn):
    return lambda x: fn(_float(x))


def _heaviside(x, y):
    return torch.heaviside(x, y.to(x.dtype))


def _floor_divide(x, y):
    """torch's floor division; for floats with a zero gradient, as the
    reference's (torch defines none)."""
    if x.is_floating_point() or y.is_floating_point():
        return torch.floor_divide(x.detach(), y.detach())
    return torch.floor_divide(x, y)


def _ldexp(x, y):
    return _float(x) * torch.pow(2.0, y.to(_float(x).dtype))


# ---- reductions: f(x, dims, keepdim, dtype) ----

def _sum(x, dims, keepdim, dtype):
    if x.dtype == torch.bool and dtype is None:
        dtype = torch.int64
    return torch.sum(x, dim=dims, keepdim=keepdim, dtype=dtype) if dims \
        else x.to(dtype or (torch.int64 if not x.is_floating_point() and
                            not x.is_complex() else x.dtype))


def _prod(x, dims, keepdim, dtype):
    if dtype is None and not x.is_floating_point() and not x.is_complex():
        dtype = torch.int64
    out = x.to(dtype) if dtype is not None else x
    for d in sorted((d % builtins.max(x.ndim, 1) for d in dims),
                    reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _mean(x, dims, keepdim, dtype):
    return torch.mean(_float(x), dim=dims, keepdim=keepdim) if dims \
        else _float(x)


def _amax(x, dims, keepdim, dtype):
    return torch.amax(x, dim=dims, keepdim=keepdim) if dims else x


def _amin(x, dims, keepdim, dtype):
    return torch.amin(x, dim=dims, keepdim=keepdim) if dims else x


def _nanmean(x, dims, keepdim, dtype):
    return torch.nanmean(_float(x), dim=dims, keepdim=keepdim) if dims \
        else _float(x)


def _nansum(x, dims, keepdim, dtype):
    return torch.nansum(x, dim=dims, keepdim=keepdim) if dims else x


def _logsumexp(x, dims, keepdim, dtype):
    return torch.logsumexp(_float(x), dim=dims, keepdim=keepdim) if dims \
        else _float(x)


def _all(x, dims, keepdim, dtype):
    return torch.all(x, dim=dims, keepdim=keepdim) if dims else x.bool()


def _any(x, dims, keepdim, dtype):
    return torch.any(x, dim=dims, keepdim=keepdim) if dims else x.bool()


def _count_nonzero(x, dims, keepdim, dtype):
    out = torch.count_nonzero(x, dim=dims) if dims else (x != 0).long()
    if keepdim:
        for d in sorted(d % x.ndim for d in dims):
            out = out.unsqueeze(d)
    return out


U, B, R = "unary", "binary", "reduce"

# (op, kind, impl, aliases[, dtype_arg])
TABLE = [
    # ---- unary: exponentials & powers ----
    ("exp", U, _unary_float(torch.exp), ()),
    ("expm1", U, _unary_float(torch.expm1), ()),
    ("exp2", U, _unary_float(torch.exp2), ()),
    ("log", U, _unary_float(torch.log), ()),
    ("log2", U, _unary_float(torch.log2), ()),
    ("log10", U, _unary_float(torch.log10), ()),
    ("log1p", U, _unary_float(torch.log1p), ()),
    ("sqrt", U, _unary_float(torch.sqrt), ()),
    ("rsqrt", U, _unary_float(torch.rsqrt), ()),
    ("cbrt", U, _unary_float(_cbrt), ()),
    ("square", U, torch.square, ()),
    # ---- unary: sign & rounding ----
    ("abs", U, torch.abs, ()),
    ("sign", U, torch.sign, ()),
    ("signbit", U, torch.signbit, ()),
    ("ceil", U, torch.ceil, ()),
    ("floor", U, torch.floor, ()),
    ("round", U, torch.round, ()),
    ("trunc", U, torch.trunc, ("fix",)),
    ("frac", U, torch.frac, ()),
    ("reciprocal", U, _unary_float(torch.reciprocal), ()),
    ("neg", U, torch.neg, ()),
    # ---- unary: trigonometric / hyperbolic ----
    ("sin", U, _unary_float(torch.sin), ()),
    ("cos", U, _unary_float(torch.cos), ()),
    ("tan", U, _unary_float(torch.tan), ()),
    ("asin", U, _unary_float(torch.asin), ()),
    ("acos", U, _unary_float(torch.acos), ()),
    ("atan", U, _unary_float(torch.atan), ()),
    ("sinh", U, _unary_float(torch.sinh), ()),
    ("cosh", U, _unary_float(torch.cosh), ()),
    ("tanh", U, _unary_float(torch.tanh), ()),
    ("asinh", U, _unary_float(torch.asinh), ()),
    ("acosh", U, _unary_float(torch.acosh), ()),
    ("atanh", U, _unary_float(torch.atanh), ()),
    ("sinc", U, _unary_float(torch.sinc), ()),
    ("deg2rad", U, _unary_float(torch.deg2rad), ()),
    ("rad2deg", U, _unary_float(torch.rad2deg), ()),
    # ---- unary: special functions ----
    ("erf", U, _unary_float(torch.erf), ()),
    ("erfc", U, _unary_float(torch.erfc), ()),
    ("erfinv", U, _unary_float(torch.erfinv), ()),
    ("lgamma", U, _unary_float(torch.lgamma), ("gammaln",)),
    ("digamma", U, _unary_float(torch.digamma), ()),
    ("i0", U, _unary_float(torch.i0), ()),
    ("i0e", U, _unary_float(torch.special.i0e), ()),
    ("i1", U, _unary_float(torch.special.i1), ()),
    ("i1e", U, _unary_float(torch.special.i1e), ()),
    ("logit", U, _unary_float(torch.logit), ()),
    ("sigmoid", U, _unary_float(torch.sigmoid), ()),
    ("logsigmoid", U, _unary_float(F.logsigmoid), ()),
    # ---- unary: complex & predicates ----
    ("angle", U, _angle, ()),
    ("conj", U, torch.conj_physical, ()),
    ("real", U, _real, ()),
    ("imag", U, _imag, ()),
    ("isnan", U, torch.isnan, ()),
    ("isinf", U, torch.isinf, ()),
    ("isfinite", U, torch.isfinite, ()),
    ("isreal", U, torch.isreal, ()),
    ("logical_not", U, torch.logical_not, ()),
    ("bitwise_not", U, torch.bitwise_not, ()),
    # ---- binary: arithmetic ----
    ("add", B, torch.add, ()),
    ("subtract", B, torch.subtract, ()),
    ("multiply", B, torch.multiply, ()),
    ("divide", B, torch.true_divide, ("true_divide",)),
    ("floor_divide", B, _floor_divide, ()),
    ("mod", B, torch.remainder, ("remainder", "floor_mod")),
    ("pow", B, torch.pow, ()),
    ("maximum", B, torch.maximum, ()),
    ("minimum", B, torch.minimum, ()),
    ("fmax", B, torch.fmax, ()),
    ("fmin", B, torch.fmin, ()),
    ("atan2", B, torch.atan2, ()),
    ("hypot", B, lambda x, y: torch.hypot(_float(x), _float(y)), ()),
    ("logaddexp", B, lambda x, y: torch.logaddexp(_float(x), _float(y)),
     ()),
    ("heaviside", B, _heaviside, ()),
    ("copysign", B, lambda x, y: torch.copysign(_float(x), y), ()),
    ("nextafter", B, torch.nextafter, ()),
    ("ldexp", B, _ldexp, ()),
    ("gcd", B, torch.gcd, ()),
    ("lcm", B, torch.lcm, ()),
    ("gammainc", B, torch.special.gammainc, ()),
    ("gammaincc", B, torch.special.gammaincc, ()),
    # ---- binary: comparison & logic ----
    ("equal", B, torch.eq, ()),
    ("not_equal", B, torch.ne, ()),
    ("less_than", B, torch.lt, ()),
    ("less_equal", B, torch.le, ()),
    ("greater_than", B, torch.gt, ()),
    ("greater_equal", B, torch.ge, ()),
    ("logical_and", B, torch.logical_and, ()),
    ("logical_or", B, torch.logical_or, ()),
    ("logical_xor", B, torch.logical_xor, ()),
    ("bitwise_and", B, torch.bitwise_and, ()),
    ("bitwise_or", B, torch.bitwise_or, ()),
    ("bitwise_xor", B, torch.bitwise_xor, ()),
    ("bitwise_left_shift", B, torch.bitwise_left_shift, ()),
    ("bitwise_right_shift", B, torch.bitwise_right_shift, ()),
    # ---- reductions ----
    ("sum", R, _sum, (), True),
    ("mean", R, _mean, ()),
    ("prod", R, _prod, (), True),
    ("max", R, _amax, ()),
    ("min", R, _amin, ()),
    ("amax", R, _amax, ()),
    ("amin", R, _amin, ()),
    ("nanmean", R, _nanmean, ()),
    ("nansum", R, _nansum, ()),
    ("logsumexp", R, _logsumexp, ()),
    ("all", R, _all, ()),
    ("any", R, _any, ()),
    ("count_nonzero", R, _count_nonzero, ()),
]

_FACTORY = {U: unary_op, B: binary_op}

__all__ = []
for _row in TABLE:
    _op, _kind, _impl, _aliases = _row[:4]
    if _kind == R:
        _fn = reduce_op(_op, _impl, dtype_arg=len(_row) > 4)
    else:
        _fn = _FACTORY[_kind](_op, _impl)
    for _n in (_op,) + tuple(_aliases):
        globals()[_n] = _fn
        __all__.append(_n)
__all__.sort()
