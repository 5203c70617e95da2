"""The functional op namespace and the ``Tensor`` method table (the port of
``paddle_tpu/ops/__init__.py``).

Every public op of the reference's ``ops`` package is here under its name;
:mod:`paddle_tpu_torch` exports them at its top level.  The reference
attaches its ops to ``Tensor`` as methods and operator dunders; so does
this module.  A method whose name ``torch.Tensor`` also has answers with
torch's method inside a boundary body (``core.tensor.dual``), so torch-style
code on parameters keeps its meaning there.
"""

from __future__ import annotations

import builtins

import torch

from ..core.tensor import Tensor, dual, is_tensor, to_tensor  # noqa: F401
from . import (array, compat, creation, extras, indexing, linalg,
               manipulation, math, random_ops, search)
from ._generated import __all__ as _TABLE
from ._prim import OP_REGISTRY, apply_op, register_op  # noqa: F401

# ---- re-export everything public ----
_MODULES = (creation, math, manipulation, linalg, search, random_ops, extras,
            array, compat)
__all__ = ["Tensor", "to_tensor", "apply_op", "register_op"]
for _m in _MODULES:
    # a name two modules define is the later module's, as in the reference
    _names = _TABLE + _m._OWN if _m is math else _m.__all__
    for _name in _names:
        globals()[_name] = getattr(_m, _name)
        if _name not in __all__:
            __all__.append(_name)

# ---- the in-place ``op_`` family (reference generate_inplace_fn) ----
for _name, _fn in extras.install_inplace_variants(dict(globals())).items():
    globals()[_name] = _fn
    __all__.append(_name)

install_inplace_variants = extras.install_inplace_variants
__all__.append("install_inplace_variants")
inverse = linalg.inv


# ---- operator dunders ----
def _binop(fn, reverse=False):
    def op(self, other):
        if reverse:
            return fn(other, self)
        return fn(self, other)
    return op


def _iop(fn):
    """``x op= y``: a new tensor bound to the name, as in the reference
    (torch's in-place form inside a boundary body)."""
    def op(self, other):
        return fn(self, other)
    return op


_DUNDERS = {
    "__add__": _binop(math.add), "__radd__": _binop(math.add, True),
    "__sub__": _binop(math.subtract),
    "__rsub__": _binop(math.subtract, True),
    "__mul__": _binop(math.multiply),
    "__rmul__": _binop(math.multiply, True),
    "__truediv__": _binop(math.divide),
    "__rtruediv__": _binop(math.divide, True),
    "__floordiv__": _binop(math.floor_divide),
    "__rfloordiv__": _binop(math.floor_divide, True),
    "__mod__": _binop(math.mod), "__rmod__": _binop(math.mod, True),
    "__pow__": _binop(math.pow), "__rpow__": _binop(math.pow, True),
    "__matmul__": _binop(linalg.matmul),
    "__rmatmul__": _binop(linalg.matmul, True),
    "__neg__": lambda self: math.neg(self),
    "__abs__": lambda self: math.abs(self),
    # logical for every dtype, as the reference's (ops/__init__.py:65-74)
    "__invert__": lambda self: math.logical_not(self),
    "__and__": _binop(math.logical_and),
    "__rand__": _binop(math.logical_and, True),
    "__or__": _binop(math.logical_or),
    "__ror__": _binop(math.logical_or, True),
    "__xor__": _binop(math.logical_xor),
    "__rxor__": _binop(math.logical_xor, True),
    "__eq__": _binop(math.equal), "__ne__": _binop(math.not_equal),
    "__lt__": _binop(math.less_than), "__le__": _binop(math.less_equal),
    "__gt__": _binop(math.greater_than),
    "__ge__": _binop(math.greater_equal),
    "__iadd__": _iop(math.add), "__isub__": _iop(math.subtract),
    "__imul__": _iop(math.multiply), "__itruediv__": _iop(math.divide),
    "__getitem__": indexing.getitem, "__setitem__": indexing.setitem,
}

# the reference's method table (_METHOD_SOURCES), its extras and its
# late-bound table (ref_tensor_methods.txt) by name; a name maps to the op
# of the same name unless given here
_METHOD_ALIASES = {"remainder": math.mod, "inverse": linalg.inv}
_METHODS = (
    # math
    "exp log sqrt rsqrt square abs sign sin cos tan tanh sigmoid ceil floor "
    "round reciprocal add subtract multiply divide pow mod remainder maximum "
    "minimum clip scale isnan isinf isfinite equal not_equal less_than "
    "less_equal greater_than greater_equal equal_all allclose isclose "
    "logical_and logical_or logical_not logical_xor sum mean prod max min "
    "amax amin std var argmax argmin cumsum cumprod logsumexp all any lerp "
    "kron trunc frac diff erf lgamma digamma nan_to_num "
    # manipulation
    "reshape reshape_ flatten unflatten transpose squeeze unsqueeze split "
    "chunk tile expand expand_as broadcast_to flip roll gather gather_nd "
    "scatter scatter_nd_add unbind unstack unique masked_fill masked_select "
    "index_select take_along_axis put_along_axis where nonzero diagonal "
    "tensordot repeat_interleave index_add index_put bincount pad moveaxis "
    "swapaxes index_sample one_hot "
    # linalg, search, creation, random
    "matmul mm dot bmm t norm dist trace cross cholesky inverse outer inner "
    "mv sort argsort topk kthvalue mode tril triu diag normal_ uniform_ "
    "exponential_ multinomial bernoulli "
    # extras
    "sgn take isin nanquantile frexp cdist view_as diagonal_scatter "
    "select_scatter slice_scatter masked_scatter vander cholesky_inverse "
    "matrix_exp multigammaln is_floating_point is_integer is_complex "
    "cumulative_trapezoid isneginf isposinf isreal unfold "
    # late-bound table
    "create_parameter create_tensor ormqr cov corrcoef cond lstsq histogram "
    "histogram_bin_edges histogramdd matrix_power qr householder_product "
    "pca_lowrank svd_lowrank eigvals eigvalsh acos asin atan cosh cummax "
    "cummin logcumsumexp logit expm1 increment logaddexp log2 log10 "
    "multiplex sinc sinh stanh reduce_as hypot nansum nanmean block_diag "
    "count_nonzero add_n fmax fmin floor_divide floor_mod log1p addmm "
    "broadcast_shape conj neg gammaincc gammainc is_empty is_tensor concat "
    "reverse scatter_nd shard_index slice tensor_split hsplit dsplit vsplit "
    "stack strided_slice unique_consecutive rot90 top_p_sampling median "
    "nanmedian quantile real imag gammaln bitwise_and bitwise_or "
    "bitwise_xor bitwise_not broadcast_tensors eig multi_dot solve "
    "cholesky_solve triangular_solve asinh atanh acosh lu lu_unpack "
    "as_complex as_real rad2deg deg2rad gcd lcm erfinv angle heaviside "
    "bucketize ldexp trapezoid polar nextafter as_strided view i0 i0e i1 "
    "i1e polygamma diag_embed atan2 diagflat pinv renorm copysign "
    "bitwise_left_shift bitwise_right_shift index_fill atleast_1d "
    "atleast_2d atleast_3d combinations signbit").split()

# methods the Tensor class defines itself (core/tensor.py)
_OWN_METHODS = {"numpy", "astype", "cast", "set_value", "scale_",
                "clear_grad", "clear_gradient", "retain_grads",
                "is_selected_rows", "element_size", "to", "pin_memory",
                "backward", "register_hook", "copy_", "fill_", "zero_"}


# torch's spellings that mean the same as the reference's and collide with
# nothing in it: ``dim=`` for ``axis=``, and sizes as varargs
_AXIS_KW = {"sum", "mean", "prod", "max", "min", "amax", "amin", "std",
            "var", "argmax", "argmin", "logsumexp", "all", "any", "cumsum",
            "nansum", "nanmean", "median", "nanmedian", "count_nonzero",
            "logcumsumexp", "flip", "squeeze", "unsqueeze", "quantile"}
_SIZE_VARARGS = {"reshape", "view", "expand", "tile", "broadcast_to"}


def _axis_kw(fn):
    def method(self, *args, **kwargs):
        if "dim" in kwargs:
            kwargs["axis"] = kwargs.pop("dim")
        return fn(self, *args, **kwargs)
    return method


def _size_varargs(fn):
    def method(self, *args, **kwargs):
        if args and builtins.all(isinstance(a, int) for a in args) and \
                (len(args) > 1 or fn is view):
            return fn(self, list(args), **kwargs)
        return fn(self, *args, **kwargs)
    return method


def _transpose(self, *args, **kwargs):
    """``transpose(perm)``, or torch's ``transpose(dim0, dim1)``."""
    if len(args) == 2 and builtins.all(isinstance(a, int) for a in args):
        return manipulation.swapaxes(self, *args)
    return manipulation.transpose(self, *args, **kwargs)


def _attach(name, fn):
    if name in _OWN_METHODS:
        return
    if name in _AXIS_KW:
        fn = _axis_kw(fn)
    elif name in _SIZE_VARARGS:
        fn = _size_varargs(fn)
    elif name == "transpose":
        fn = _transpose
    if hasattr(torch.Tensor, name):
        fn = dual(name, fn)
    setattr(Tensor, name, fn)


for _name, _fn in _DUNDERS.items():
    _attach(_name, _fn)
for _name in _METHODS:
    _attach(_name, _METHOD_ALIASES.get(_name) or globals()[_name])
for _name in __all__:
    if _name.endswith("_") and _name not in _METHODS:
        _attach(_name, globals()[_name])
