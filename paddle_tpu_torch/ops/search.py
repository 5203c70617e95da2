"""Sort and search ops (the port of ``paddle_tpu/ops/search.py``).  Sorts
are stable, as the reference's are."""

from __future__ import annotations

import torch

from ..core.tensor import boundary_module
from . import manipulation as _m
from ._prim import autocast_module, t_


def sort(x, axis=-1, descending=False, stable=False, name=None):
    """The sorted values (the reference returns no indices)."""
    return torch.sort(t_(x), dim=axis, descending=descending,
                      stable=True).values


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(t_(x), dim=axis, descending=descending,
                      stable=True).indices


def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa: A002
    if torch.is_tensor(k):
        k = int(k.item())
    v, i = torch.topk(t_(x), int(k), dim=-1 if axis is None else int(axis),
                      largest=largest, sorted=True)
    return v, i.to(torch.int64)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The k-th smallest along ``axis`` and its index in a stable sort."""
    s = torch.sort(t_(x), dim=axis, stable=True)
    v = s.values.select(axis, k - 1)
    i = s.indices.select(axis, k - 1)
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i.to(torch.int64)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the last index where it stands, as the reference's numpy does."""
    x = t_(x)
    xm = x.movedim(axis, -1)
    counts = (xm.unsqueeze(-1) == xm.unsqueeze(-2)).sum(-1)
    order = torch.sort(xm, dim=-1, stable=True)
    cnt_sorted = torch.gather(counts, -1, order.indices)
    first = torch.argmax(cnt_sorted, dim=-1, keepdim=True)
    val = torch.gather(order.values, -1, first)
    pos = torch.arange(xm.shape[-1], device=x.device)
    idx = torch.where(xm == val, pos, torch.full_like(pos, -1)).amax(-1)
    val = val.squeeze(-1)
    if keepdim:
        val, idx = val.unsqueeze(-1), idx.unsqueeze(-1)
        return val.movedim(-1, axis), idx.movedim(-1, axis)
    return val, idx


def index_select(x, index, axis=0, name=None):
    return _m.index_select(x, index, axis)


def masked_select(x, mask, name=None):
    return _m.masked_select(x, mask)


def where(condition, x=None, y=None, name=None):
    return _m.where(condition, x, y)


def nonzero(x, as_tuple=False):
    return _m.nonzero(x, as_tuple)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return _m.bucketize(x, sorted_sequence, out_int32, right)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return _m.searchsorted(sorted_sequence, values, out_int32, right)


__all__ = ["sort", "argsort", "topk", "kthvalue", "mode", "index_select",
           "masked_select", "where", "nonzero", "bucketize", "searchsorted"]
autocast_module(globals())
boundary_module(globals(), __all__[:5])
