"""Op definition helpers (the port of ``paddle_tpu/ops/_prim.py``).

An op is a torch function over plain tensors made a Paddle-API entry by
:func:`~paddle_tpu_torch.core.tensor.boundary`: outside a boundary its
tensor inputs are unwrapped and its tensor results come back as
``Tensor``.  ``OP_REGISTRY`` records every table op by name, as the
reference's does; autograd is PyTorch's, so there is no pullback to
register.
"""

from __future__ import annotations

import functools
import numbers

import numpy as np
import torch

from .. import dtypes
from ..core import amp_state
from ..core.amp_state import cast as _amp
from ..core.tensor import (_DISABLE, OP_OBSERVERS, _observe, boundary,
                           inside)

OP_REGISTRY: dict = {}

# The ops the reference runs through its dispatch seam (``apply_op``), by
# module, each under the name it casts by under autocast ("fn=name" where
# the name is not the function's); the table ops cast in their factories.
# tests/test_torch_ops_table.py reads the reference's sources and holds
# this table to them.
AMP_NAMES = {
    "compat": "pdist reduce_as",
    "creation": "diag diagflat tril triu complex",
    "extras": "vander block_diag polar sgn add_n increment take isin "
              "isneginf isposinf isreal nanquantile histogram_bin_edges "
              "cumulative_trapezoid frexp multigammaln matrix_exp "
              "cholesky_inverse cdist cartesian_prod combinations "
              "svd_lowrank diagonal_scatter select_scatter slice_scatter "
              "masked_scatter unfold=tensor_unfold",
    "indexing": "getitem",
    "linalg": "matmul dot inner outer cross norm vector_norm matrix_norm "
              "dist=sub matrix_power qr svd eigh eigvalsh det slogdet inv "
              "pinv solve triangular_solve cholesky cholesky_solve trace "
              "einsum multi_dot cond ormqr householder_product lu_unpack",
    "manipulation": "cast reshape transpose moveaxis swapaxes squeeze "
                    "unsqueeze concat stack unstack split tile expand flip "
                    "roll rot90 repeat_interleave as_strided view=view_dtype "
                    "pad masked_fill index_select index_sample "
                    "take_along_axis put_along_axis gather gather_nd scatter "
                    "scatter_nd_add index_add index_put index_fill where "
                    "shard_index top_p_sampling one_hot diagonal diag_embed "
                    "crop strided_slice tensordot atleast_1d atleast_2d "
                    "atleast_3d hstack vstack dstack column_stack as_complex "
                    "as_real fill_diagonal fill_diagonal_tensor",
    "math": "scale clip lerp stanh std var median quantile cumsum cumprod "
            "logcumsumexp kron diff nan_to_num nanmedian renorm addmm "
            "polygamma",
    "search": "sort topk kthvalue",
}


def _cast_arg(name, a):
    if torch.is_tensor(a):
        return _amp(name, a)[0]
    if isinstance(a, (list, tuple)) and a and all(torch.is_tensor(v)
                                                  for v in a):
        return type(a)(_amp(name, *a))
    return a


def cast_inputs(name, fn):
    """``fn`` with its tensor arguments (and lists of them) cast as op
    ``name``'s inputs are under autocast, at every call."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        if amp_state.current().enabled:
            args = tuple(_cast_arg(name, a) for a in args)
        return fn(*args, **kwargs)
    return op


def autocast_module(ns: dict) -> None:
    """Give every op of module namespace ``ns`` that AMP_NAMES lists its
    autocast (before ``boundary_module`` makes them entries)."""
    for spec in AMP_NAMES.get(ns["__name__"].rsplit(".", 1)[-1], "").split():
        fname, _, name = spec.partition("=")
        ns[fname] = cast_inputs(name or fname, ns[fname])


def register_op(name, prim, spmd_rule=None):
    """Record an op in the registry (the schema's single source of
    truth)."""
    OP_REGISTRY[name] = {"prim": prim, "spmd_rule": spmd_rule}
    return prim


def apply_op(name, prim, tensors, kwargs=None):
    """``prim(*tensors, **kwargs)`` as op ``name`` runs it: inputs cast as
    autocast casts that op's inputs, on plain tensors."""
    if inside():
        out = prim(*_amp(name, *tensors), **(kwargs or {}))
        if OP_OBSERVERS:
            _observe(name, out)
        return out
    return boundary(lambda *ts: prim(*_amp(name, *ts), **(kwargs or {})),
                    op=name)(*tensors)


def device():
    from ..device import current
    return current()


def t_(x, dtype=None):
    """``x`` as a plain tensor: a tensor as it is, anything else on the
    current device (Python floats in the default float dtype)."""
    if torch.is_tensor(x):
        return x if dtype is None else x.to(dtypes.convert_dtype(dtype))
    if dtype is not None:
        return torch.as_tensor(np.asarray(x), device=device(),
                               dtype=dtypes.convert_dtype(dtype))
    arr = np.asarray(x)
    if arr.dtype == np.float64 and not isinstance(x, np.ndarray):
        return torch.as_tensor(arr, device=device(),
                               dtype=dtypes.get_default_dtype())
    return torch.as_tensor(arr, device=device())


def scalar_like(x, y):
    """The pair ``(x, y)`` as tensors where one may be a Python number: the
    number takes the dtype the pair promotes to, as a weak scalar does."""
    xs = isinstance(x, (numbers.Number, np.number, bool))
    ys = isinstance(y, (numbers.Number, np.number, bool))
    if not xs and not torch.is_tensor(x):
        x = t_(x)
    if not ys and not torch.is_tensor(y):
        y = t_(y)
    if xs and ys:
        x = t_(x)
        xs = False
    # the number is filled in on the tensor's device (``torch.tensor`` on
    # the card would copy it from the host and synchronize)
    if ys:
        rt = torch.result_type(x, y)
        return x.to(rt), torch.full((), y, dtype=rt, device=x.device)
    if xs:
        rt = torch.result_type(y, x)
        return torch.full((), x, dtype=rt, device=y.device), y.to(rt)
    return x, y


def axes(x, axis):
    """A Paddle ``axis`` as a tuple of dims (``None``: every dim)."""
    if axis is None:
        return tuple(range(x.ndim))
    if torch.is_tensor(axis):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


# ---- table-op factories (read by the table in _generated.py) ----

def unary_op(name, fn, spmd_rule="elementwise"):
    def op(x, name=None):
        (x,) = _amp(name_, t_(x))
        return fn(x)
    name_ = name
    op.__name__ = op.__qualname__ = name
    register_op(name, fn, spmd_rule=spmd_rule)
    return boundary(op, op=name)


def binary_op(name, fn, spmd_rule="elementwise"):
    def op(x, y, name=None):
        x, y = scalar_like(x, y)
        x, y = _amp(name_, x, y)
        return fn(x, y)
    name_ = name
    op.__name__ = op.__qualname__ = name
    register_op(name, fn, spmd_rule=spmd_rule)
    return boundary(op, op=name)


def reduce_op(name, fn, dtype_arg=False, spmd_rule="reduction"):
    """``fn(x, dims, keepdim, dtype)`` over ``axis`` (``None``: all)."""
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        (x,) = _amp(name_, t_(x))
        dt = dtypes.convert_dtype(dtype) if dtype_arg and dtype is not None \
            else None
        return fn(x, axes(x, axis), bool(keepdim), dt)
    name_ = name
    op.__name__ = op.__qualname__ = name
    register_op(name, fn, spmd_rule=spmd_rule)
    return boundary(op, op=name)


# ---- in place: the reference's ``op_`` family ----

def rebind(x, out):
    """``x`` made to hold ``out`` in place and returned (the reference
    rebinds the tensor to the result's autograd node,
    ``ops/extras.py:365``).  Same shape and dtype: an autograd-recorded
    ``copy_``, so the gradient flows through ``out``; a new shape: ``x``'s
    view is restrided first; a new dtype: ``x``'s data is replaced (not
    recorded by autograd).  torch refuses the first two on a leaf that
    requires grad."""
    with _DISABLE():
        if out.dtype != x.dtype:
            with torch.no_grad():
                x.data = out.detach()
            return x
        shape = tuple(out.shape)
        if tuple(torch.Tensor.shape.__get__(x)) != shape:
            torch.Tensor.as_strided_(x, shape, _contiguous(shape),
                                     x.storage_offset())
        torch.Tensor.copy_(x, out)
    return x


def _contiguous(shape):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= max(s, 1)
    return tuple(reversed(strides))


def make_inplace(name, fn):
    """``fn_``: ``fn`` on a copy of ``x``, the result written back into
    ``x`` by :func:`rebind` (the copy keeps the saved inputs of ``fn``'s
    backward apart from the write)."""
    def inplace(x, *args, **kwargs):
        with _DISABLE():
            src = torch.Tensor.clone(x)
        return rebind(x, fn(src, *args, **kwargs))
    inplace.__name__ = inplace.__qualname__ = name
    return inplace
