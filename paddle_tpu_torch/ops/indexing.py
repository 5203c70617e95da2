"""``Tensor.__getitem__`` / ``__setitem__`` (the port of
``paddle_tpu/ops/indexing.py``): torch's indexing, with the reference's
index forms (tensors, lists, bool masks).  A bool-mask read has a shape
the data decides: on the card it is one marked sync, as the reference's
host read is."""

from __future__ import annotations

import torch

from ..core.tensor import _DISABLE, _to_plain, boundary
from ._prim import autocast_module


def _norm(idx):
    """Tensors as plain tensors, lists as index tensors (or tuples when
    they hold slices), tensor slice bounds as ints."""
    if torch.is_tensor(idx):
        return _to_plain(idx)
    if isinstance(idx, tuple):
        return tuple(_norm(i) for i in idx)
    if isinstance(idx, list):
        if any(isinstance(i, (slice, type(None), type(Ellipsis)))
               for i in idx):
            return tuple(_norm(i) for i in idx)
        if any(torch.is_tensor(i) for i in idx):
            return torch.stack([_to_plain(i) if torch.is_tensor(i)
                                else torch.tensor(i) for i in idx])
        return torch.tensor(idx)
    if isinstance(idx, slice):
        return slice(*(int(v.item()) if torch.is_tensor(v) else v
                       for v in (idx.start, idx.stop, idx.step)))
    return idx


def _has_mask(idx):
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(torch.is_tensor(i) and i.dtype == torch.bool and i.ndim > 0
               for i in items)


def _device_index(idx, device):
    if torch.is_tensor(idx):
        return idx.to(device)
    if isinstance(idx, tuple):
        return tuple(_device_index(i, device) for i in idx)
    return idx


def getitem(x, idx):
    nidx = _device_index(_norm(idx), x.device)
    out = x[nidx]
    if _has_mask(nidx) and x.device.type != "cpu":
        from ..observability import count_sync
        count_sync()
    return out


def setitem(x, idx, value):
    """``x[idx] = value`` in place (``value`` cast to ``x``'s dtype)."""
    nidx = _device_index(_norm(idx), x.device)
    if torch.is_tensor(value):
        value = _to_plain(value).to(x.dtype)
    elif not isinstance(value, (int, float, bool)):
        value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    with _DISABLE():
        torch.Tensor.__setitem__(x, nidx, value)


autocast_module(globals())
getitem = boundary(getitem)
