"""Creation ops (the port of ``paddle_tpu/ops/creation.py``): tensors on the
device ``set_device`` chose."""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes
from ..core.tensor import boundary_module, leaf, to_tensor  # noqa: F401
from ..device import current
from ._prim import autocast_module, t_


def _shape(shape):
    if torch.is_tensor(shape):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if torch.is_tensor(s) else int(s)
                 for s in shape)


def _dt(dtype):
    return None if dtype is None else dtypes.convert_dtype(dtype)


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                       device=current())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                      device=current())


def full(shape, fill_value, dtype=None, name=None):
    """A float fill with no ``dtype`` takes the default float dtype; an
    integer or bool fill keeps its own type, as in the reference."""
    if torch.is_tensor(fill_value):
        fill_value = fill_value.item()
    if dtype is None:
        dtype = dtypes.get_default_dtype() if isinstance(fill_value, float) \
            else None
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=current())


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(t_(x), dtype=_dt(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(t_(x), dtype=_dt(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(t_(x), fill_value, dtype=_dt(dtype))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """int64 when every bound is an integer, else the default float
    dtype."""
    if end is None:
        start, end = 0, start
    start, end, step = (v.item() if torch.is_tensor(v) else v
                        for v in (start, end, step))
    if dtype is None:
        dtype = "int64" if all(isinstance(v, (int, np.integer))
                               for v in (start, end, step)) else None
    return torch.arange(start, end, step, dtype=dtypes.convert_dtype(dtype),
                        device=current())


def linspace(start, stop, num, dtype=None, name=None):
    start = start.item() if torch.is_tensor(start) else start
    stop = stop.item() if torch.is_tensor(stop) else stop
    return torch.linspace(start, stop, int(num),
                          dtype=dtypes.convert_dtype(dtype), device=current())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(start, stop, int(num), base=base,
                          dtype=dtypes.convert_dtype(dtype), device=current())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(int(num_rows), int(num_rows if num_columns is None
                                        else num_columns),
                     dtype=dtypes.convert_dtype(dtype), device=current())


def diag(x, offset=0, padding_value=0, name=None):
    x = t_(x)
    out = torch.diag(x, offset)
    if x.ndim == 1 and padding_value != 0:
        mask = torch.ones_like(out, dtype=torch.bool).diagonal(offset)
        keep = torch.zeros_like(out, dtype=torch.bool)
        keep.diagonal(offset).copy_(mask)
        out = torch.where(keep, out, torch.full_like(out, padding_value))
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(t_(x), offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(t_(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(t_(x), diagonal)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return list(torch.meshgrid(*[t_(a) for a in args], indexing="ij"))


def assign(x, output=None):
    x = t_(x) if torch.is_tensor(x) else to_tensor(x)
    if output is not None:
        output.set_value(x)
        return output
    return leaf(x.detach().clone(), x.requires_grad)


def clone(x, name=None):
    return t_(x).clone()


def complex(real, imag, name=None):  # noqa: A001
    return torch.complex(t_(real), t_(imag))


def tril_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = row if col is None else col
    return torch.tril_indices(int(row), int(col), int(offset),
                              dtype=dtypes.convert_dtype(dtype),
                              device=current())


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset),
                              dtype=dtypes.convert_dtype(dtype),
                              device=current())


__all__ = ["zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
           "empty", "empty_like", "arange", "linspace", "logspace", "eye",
           "diag", "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
           "complex", "tril_indices", "triu_indices", "to_tensor"]
autocast_module(globals())
boundary_module(globals(), __all__[:-1])
