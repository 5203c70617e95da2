"""``paddle.save`` / ``paddle.load`` (the port of
``paddle_tpu/framework/io.py``).

A pickle of the (nested) object with every tensor replaced by a
:class:`_TensorPayload`: the tensor's values in numpy's own ``.npy`` format,
its dtype name, shape, whether it is a ``Parameter``, and its name.
bfloat16, which numpy cannot hold, is stored as float32 under the dtype name
``"bfloat16"`` and comes back as ``torch.bfloat16``.

Files the reference wrote name its payload class
(``paddle_tpu.framework.io._TensorPayload``); :func:`load` maps that one
name to this module's class, which has the same slots, and refuses any
other class of the reference.  Files written here name this module's
class, so the reference cannot read them.
"""

from __future__ import annotations

import io as _io
import os
import pickle
from typing import Any

import numpy as np
import torch

from ..core.tensor import boundary

from ..core.tensor import Parameter

_PROTOCOL = 4
_REFERENCE_MODULE = "paddle_tpu.framework.io"


class _TensorPayload:
    """Pickle-stable tensor representation (the dtype name survives
    bfloat16)."""

    __slots__ = ("buf", "dtype", "shape", "is_param", "name")

    def __init__(self, tensor: torch.Tensor):
        t = tensor.detach().cpu()
        if t.dtype == torch.bfloat16:
            arr = t.float().numpy()
            self.dtype = "bfloat16"
        else:
            arr = t.numpy()
            self.dtype = arr.dtype.name
        b = _io.BytesIO()
        np.save(b, arr, allow_pickle=False)
        self.buf = b.getvalue()
        self.shape = tuple(arr.shape)
        self.is_param = isinstance(tensor, torch.nn.Parameter)
        self.name = getattr(tensor, "name", None)

    def restore(self) -> torch.Tensor:
        """The tensor, on the device ``set_device`` chose."""
        from ..device import current
        arr = np.load(_io.BytesIO(self.buf), allow_pickle=False)
        t = torch.from_numpy(arr)
        if self.dtype == "bfloat16":
            t = t.to(torch.bfloat16)
        t = t.to(current())
        if self.is_param:
            return Parameter(t, trainable=t.is_floating_point(),
                             name=self.name)
        return t

    def numpy(self) -> np.ndarray:
        """The values as numpy (a bfloat16 tensor as float32)."""
        return np.load(_io.BytesIO(self.buf), allow_pickle=False)


class _Unpickler(pickle.Unpickler):
    """Reads the reference's files too: its payload class is this one."""

    def find_class(self, module, name):
        if module == _REFERENCE_MODULE and name == "_TensorPayload":
            return _TensorPayload
        if module.split(".")[0] == "paddle_tpu":
            raise pickle.UnpicklingError(
                f"{module}.{name} is a class of the JAX package, which this "
                "package cannot load")
        return super().find_class(module, name)


def _pack(obj: Any) -> Any:
    if torch.is_tensor(obj):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _unpack(obj: Any, return_numpy: bool) -> Any:
    if isinstance(obj, _TensorPayload):
        return obj.numpy() if return_numpy else obj.restore()
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_unpack(v, return_numpy) for v in obj]
        return out if isinstance(obj, list) else tuple(out)
    return obj


def save(obj: Any, path: str, protocol: int = _PROTOCOL, **configs) -> None:
    """Save a (nested) object holding tensors to ``path``."""
    if protocol < 2 or protocol > 5:
        raise ValueError(f"pickle protocol must be in [2, 5], got {protocol}")
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


@boundary
def load(path: str, return_numpy: bool = False, **configs) -> Any:
    """Load an object saved by :func:`save` (or by the reference's
    ``paddle.save``); tensors land on the device ``set_device`` chose."""
    if not os.path.exists(path):
        raise ValueError(f"Path {path!r} does not exist")
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy)
