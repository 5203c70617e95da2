"""Creation ops (the port of ``paddle_tpu/ops/creation.py``'s ``zeros``,
``ones``, ``full`` and ``arange``): tensors on the device ``set_device``
chose."""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes
from ..device import current


def _shape(shape):
    if torch.is_tensor(shape):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


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
    return torch.full(_shape(shape), fill_value,
                      dtype=None if dtype is None else
                      dtypes.convert_dtype(dtype), device=current())


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """int64 when every bound is an integer, else the default float
    dtype."""
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = "int64" if all(isinstance(v, (int, np.integer))
                               for v in (start, end, step)) else None
    return torch.arange(start, end, step, dtype=dtypes.convert_dtype(dtype),
                        device=current())
