"""``paddle.tensor.array`` (the port of ``paddle_tpu/ops/array.py``): a
TensorArray is a Python list of tensors, as in the reference's dygraph
mode."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from ._prim import t_

__all__ = ["create_array", "array_length", "array_read", "array_write"]


def _tensor(v):
    from ..core.tensor import wrap
    return wrap(t_(v)) if not torch.is_tensor(v) else v


def create_array(dtype="float32", initialized_list=None):
    arr: List[Any] = []
    if initialized_list is not None:
        if not isinstance(initialized_list, (list, tuple)):
            raise TypeError(
                "initialized_list must be a list/tuple of Tensors, got "
                f"{type(initialized_list).__name__}")
        arr.extend(_tensor(t) for t in initialized_list)
    return arr


def array_length(array):
    if not isinstance(array, list):
        raise TypeError("array_length expects a TensorArray (python list)")
    return _tensor(len(array))


def array_read(array, i):
    if not isinstance(array, list):
        raise TypeError("array_read expects a TensorArray (python list)")
    idx = int(i)
    if not 0 <= idx < len(array):
        raise IndexError(f"array_read index {idx} out of range "
                         f"[0, {len(array)})")
    return array[idx]


def array_write(x, i, array: Optional[list] = None):
    """``x`` written at position ``i``, growing the array when i == len."""
    if array is None:
        array = create_array()
    if not isinstance(array, list):
        raise TypeError("array_write expects a TensorArray (python list)")
    idx = int(i)
    x = _tensor(x)
    if idx < len(array):
        array[idx] = x
    elif idx == len(array):
        array.append(x)
    else:
        raise IndexError(
            f"array_write index {idx} beyond append position {len(array)}")
    return array
