"""Shape, layout, gather and scatter ops (the port of
``paddle_tpu/ops/manipulation.py``).  The ops whose output shape depends
on the data (``unique``,
``nonzero``, ``masked_select``, ``bincount``) read the card once each, a
marked sync (``observability.count_sync``), as the reference's read the
host."""

from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from .. import dtypes
from ..core.tensor import boundary_module
from ._prim import autocast_module, scalar_like, t_

_pyslice = builtins.slice


def _sync(t):
    if t.device.type != "cpu":
        from ..observability import count_sync
        count_sync()


def _ints(v):
    if torch.is_tensor(v):
        v = v.tolist()
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(s.item()) if torch.is_tensor(s) else int(s) for s in v]


def cast(x, dtype):
    x = t_(x)
    d = dtypes.convert_dtype(dtype)
    return x if x.dtype == d else x.to(d)


def reshape(x, shape, name=None):
    return torch.reshape(t_(x), _ints(shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis`` .. ``stop_axis`` merged into one (reference
    ``manipulation.py:39``)."""
    x = t_(x)
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return reshape(x, list(x.shape[:s]) + [-1] + list(x.shape[e + 1:]))


def unflatten(x, axis, shape, name=None):
    x = t_(x)
    axis = axis % x.ndim
    return reshape(x, list(x.shape[:axis]) + _ints(shape) +
                   list(x.shape[axis + 1:]))


def transpose(x, perm=None, name=None):
    x = t_(x)
    perm = list(range(x.ndim))[::-1] if perm is None else _ints(perm)
    return x.permute(perm)


def moveaxis(x, source, destination, name=None):
    return torch.movedim(t_(x), source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(t_(x), int(axis0), int(axis1))


def squeeze(x, axis=None, name=None):
    x = t_(x)
    if axis is None:
        return torch.squeeze(x)
    dims = tuple(a % max(x.ndim, 1) for a in _ints(axis))
    dims = tuple(a for a in dims if x.ndim and x.shape[a] == 1)
    return torch.squeeze(x, dims) if dims else x


def unsqueeze(x, axis, name=None):
    x = t_(x)
    ax = _ints(axis)
    nd = x.ndim + len(ax)
    for a in sorted(a % nd for a in ax):
        x = x.unsqueeze(a)
    return x


def concat(x, axis=0, name=None):
    if torch.is_tensor(axis):
        axis = int(axis.item())
    return torch.cat([t_(v) for v in x], dim=int(axis))


def stack(x, axis=0, name=None):
    return torch.stack([t_(v) for v in x], dim=int(axis))


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(t_(x), dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections`` equal parts (an int, which must divide the dim),
    or parts of the listed sizes (one may be -1)."""
    x = t_(x)
    if torch.is_tensor(axis):
        axis = int(axis.item())
    axis = int(axis) % x.ndim
    total = x.shape[axis]
    if isinstance(num_or_sections, (int, np.integer)):
        n = int(num_or_sections)
        if total % n:
            raise ValueError(f"split: {total} is not divisible by {n}")
        return list(torch.split(x, total // n, dim=axis))
    sections = _ints(num_or_sections)
    if -1 in sections:
        known = sum(s for s in sections if s != -1)
        sections = [total - known if s == -1 else s for s in sections]
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tile(x, repeat_times, name=None):
    return torch.tile(t_(x), _ints(repeat_times))


def expand(x, shape, name=None):
    x = t_(x)
    shape = _ints(shape)
    cur = [1] * (len(shape) - x.ndim) + list(x.shape)
    target = [c if s == -1 else s for s, c in zip(shape, cur)]
    return x.reshape(cur).expand(target)


def expand_as(x, y, name=None):
    return expand(x, list(t_(y).shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*[t_(i) for i in inputs]))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def flip(x, axis, name=None):
    return torch.flip(t_(x), _ints(axis))


def roll(x, shifts, axis=None, name=None):
    shifts = _ints(shifts) if not isinstance(shifts, (int, np.integer)) \
        else int(shifts)
    if axis is None:
        return torch.roll(t_(x), shifts)
    return torch.roll(t_(x), shifts, _ints(axis) if not isinstance(
        axis, (int, np.integer)) else int(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(t_(x), k, list(axes))


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(t_(x), repeats, dim=axis)


def as_strided(x, shape, stride, offset=0, name=None):
    return torch.as_strided(t_(x).contiguous(), _ints(shape), _ints(stride),
                            int(offset))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)) or \
            torch.is_tensor(shape_or_dtype):
        return reshape(x, shape_or_dtype)
    return t_(x).view(dtypes.convert_dtype(shape_or_dtype))


_PAD_ROWS = {}
_NP_MODE = {"reflect": "reflect", "replicate": "edge", "circular": "wrap"}


def _pad_rows(n, lo, hi, mode, device):
    key = (n, lo, hi, mode, str(device))
    rows = _PAD_ROWS.get(key)
    if rows is None:
        rows = torch.from_numpy(np.pad(np.arange(n), (lo, hi),
                                       mode=_NP_MODE[mode])).to(device)
        _PAD_ROWS[key] = rows
    return rows


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """``x`` padded by the reference's rule (``manipulation.py:210``): ``2
    ndim`` ints pad every dim in order (before, after); fewer pad the last
    dims backwards in (before, after) pairs, and for a channels-last
    ``data_format`` the last dims before the channels.  "constant" fills
    ``value``; "reflect", "replicate" and "circular" take rows as
    ``numpy.pad``'s "reflect", "edge" and "wrap" do (one gather a padded
    dim, its row indices cached)."""
    x = t_(x)
    pad = _ints(pad)
    nd = x.ndim
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        k = len(pad) // 2
        width = [(0, 0)] * nd
        last = nd - 1 if data_format.upper() in ("NCHW", "NCL", "NCDHW") \
            else nd - 2
        for i in range(k):
            width[last - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        return F.pad(x, [v for lo_hi in reversed(width) for v in lo_hi],
                     value=float(value))
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            x = x.index_select(d, _pad_rows(x.shape[d], lo, hi, mode,
                                            x.device))
    return x


def unbind(x, axis=0, name=None):
    return unstack(x, axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values (flattened when ``axis`` is None) and, as
    asked, the first index of each, the inverse and the counts (int64)."""
    x = t_(x)
    if axis is None:
        x = x.reshape(-1)
    out, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                    return_counts=True, dim=axis)
    _sync(x)
    if not (return_index or return_inverse or return_counts):
        return out
    res = [out]
    if return_index:
        n = x.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=x.device)
        first = torch.full((out.shape[0 if axis is None else axis],), n,
                           dtype=torch.int64, device=x.device)
        res.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        res.append(inv.to(torch.int64))
    if return_counts:
        res.append(counts.to(torch.int64))
    return tuple(res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    if axis is not None:
        raise NotImplementedError(
            "unique_consecutive with axis is not supported yet")
    x = t_(x).reshape(-1)
    out, inv, counts = torch.unique_consecutive(x, return_inverse=True,
                                                return_counts=True)
    _sync(x)
    res = [out]
    if return_inverse:
        res.append(inv.to(torch.int64))
    if return_counts:
        res.append(counts.to(torch.int64))
    return res[0] if len(res) == 1 else tuple(res)


def masked_fill(x, mask, value, name=None):
    x = t_(x)
    v = value.to(x.dtype) if torch.is_tensor(value) else \
        torch.full((), value, dtype=x.dtype, device=x.device)
    return torch.where(t_(mask).bool(), v, x)


def masked_select(x, mask, name=None):
    x = t_(x)
    m = t_(mask).bool()
    shape = torch.broadcast_shapes(x.shape, m.shape)
    out = x.expand(shape)[m.expand(shape)]
    _sync(x)
    return out


def _take(x, index, axis):
    """``jnp.take(x, index, axis)``: any index shape."""
    index = t_(index)
    axis = int(axis) % x.ndim
    out = x.index_select(axis, index.reshape(-1).long())
    return out.reshape(list(x.shape[:axis]) + list(index.shape) +
                       list(x.shape[axis + 1:]))


def index_select(x, index, axis=0, name=None):
    return _take(t_(x), index, axis)


def index_sample(x, index):
    return torch.gather(t_(x), 1, t_(index).long())


def take_along_axis(arr, indices, axis, broadcast=True):
    return torch.take_along_dim(t_(arr), t_(indices).long(), int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign",  # noqa: A002
                   include_self=True, broadcast=True):
    arr, idx = t_(arr), t_(indices).long()
    axis = int(axis) % arr.ndim
    v = values.to(arr.dtype) if torch.is_tensor(values) else \
        torch.tensor(values, dtype=arr.dtype, device=arr.device)
    v = v.expand(idx.shape)
    if reduce == "assign":
        return arr.scatter(axis, idx, v)
    if reduce == "add":
        return arr.scatter_add(axis, idx, v)
    red = {"multiply": "prod", "mul": "prod", "amin": "amin",
           "amax": "amax"}[reduce]
    return arr.scatter_reduce(axis, idx, v, red, include_self=True)


def gather(x, index, axis=0, name=None):
    x, index = t_(x), t_(index)
    if index.ndim == 2 and index.shape[1] == 1:
        index = index.reshape(-1)
    if torch.is_tensor(axis):
        axis = int(axis.item())
    return _take(x, index, axis)


def gather_nd(x, index, name=None):
    x, index = t_(x), t_(index).long()
    return x[tuple(index.movedim(-1, 0))]


def scatter(x, index, updates, overwrite=True, name=None):
    x, i, u = t_(x), t_(index).long().reshape(-1), t_(updates)
    if overwrite:
        return torch.index_put(x, (i,), u.to(x.dtype))
    zeroed = torch.index_put(x, (i,), torch.zeros_like(u, dtype=x.dtype))
    return torch.index_put(zeroed, (i,), u.to(x.dtype), accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x, i = t_(x), t_(index).long()
    return torch.index_put(x, tuple(i.movedim(-1, 0)),
                           t_(updates).to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    u = t_(updates)
    return scatter_nd_add(torch.zeros(_ints(shape), dtype=u.dtype,
                                      device=u.device), index, u)


def index_add(x, index, axis, value, name=None):
    x = t_(x)
    return torch.index_add(x, int(axis), t_(index).long(),
                           t_(value).to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x = t_(x)
    idx = tuple(t_(i).long() if not t_(i).dtype == torch.bool else t_(i)
                for i in indices)
    return torch.index_put(x, idx, t_(value).to(x.dtype),
                           accumulate=accumulate)


def index_fill(x, index, axis, value, name=None):
    x = t_(x)
    v = value.item() if torch.is_tensor(value) else value
    return torch.index_fill(x, int(axis), t_(index).long(), v)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x, y = scalar_like(x, y)
    return torch.where(t_(condition).bool(), x, y)


def nonzero(x, as_tuple=False):
    x = t_(x)
    out = torch.nonzero(x)
    _sync(x)
    if as_tuple:
        return tuple(out.unbind(1))
    return out


def numel(x, name=None):
    x = t_(x)
    return torch.full((), x.numel(), dtype=torch.int64, device=x.device)


def shard_index(input, index_num, nshards, shard_id,  # noqa: A002
                ignore_value=-1):
    i = t_(input)
    shard_size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * shard_size, (shard_id + 1) * shard_size
    ok = (i >= lo) & (i < hi)
    return torch.where(ok, i - lo, torch.full_like(i, ignore_value))


def top_p_sampling(x, ps, threshold=None, seed=None):
    """Nucleus sampling (reference ``manipulation.py:393``): a row's draw
    from the smallest prefix of its descending probabilities whose mass
    reaches ``ps``, tokens under ``threshold`` dropped.  Drawn from the
    device's generator (or one seeded by ``seed``).  Returns (probs,
    ids)."""
    from ..core.random import generator
    probs, p = t_(x), t_(ps)
    sorted_p, sorted_idx = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
    cum = torch.cumsum(sorted_p, dim=-1)
    keep = (cum - sorted_p) < p.reshape(-1, 1)
    if threshold is not None:
        keep = keep & (sorted_p >= t_(threshold).reshape(-1, 1))
    filt = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
    if seed not in (None, -1):
        gen = torch.Generator(device=probs.device).manual_seed(int(seed))
    else:
        gen = generator(probs.device)
    choice = torch.multinomial(filt.float(), 1, generator=gen)
    ids = torch.gather(sorted_idx, -1, choice)
    scores = torch.gather(sorted_p, -1, choice)
    return scores, ids.to(torch.int64)


def one_hot(x, num_classes, name=None):
    return F.one_hot(t_(x).long(), int(num_classes)).to(torch.float32)


def bincount(x, weights=None, minlength=0, name=None):
    x = t_(x)
    w = None if weights is None else t_(weights)
    out = torch.bincount(x, weights=w, minlength=minlength)
    _sync(x)
    if w is not None and out.dtype != w.dtype and w.is_floating_point():
        out = out.to(w.dtype)
    return out


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(t_(sorted_sequence), t_(values),
                              out_int32=out_int32, right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(t_(x), offset, axis1, axis2)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(t_(x), offset, dim1, dim2)


def _take_range(x, axis, s, e, st):
    if st > 0:
        return x[(_pyslice(None),) * axis + (_pyslice(s, e, st),)]
    rows = range(*_pyslice(s, e, st).indices(x.shape[axis]))
    idx = torch.tensor(list(rows), dtype=torch.long, device=x.device)
    return x.index_select(axis, idx)


def crop(x, shape=None, offsets=None, name=None):
    x = t_(x)
    shape = _ints(shape) if shape is not None else list(x.shape)
    offsets = _ints(offsets) if offsets is not None else [0] * x.ndim
    for d, (o, s) in enumerate(zip(offsets, shape)):
        x = x.narrow(d, o, x.shape[d] - o if s == -1 else s)
    return x


def strided_slice(x, axes, starts, ends, strides, name=None):
    x = t_(x)
    for ax, s, e, st in zip(_ints(axes), _ints(starts), _ints(ends),
                            _ints(strides)):
        x = _take_range(x, ax % x.ndim, s, e, st)
    return x


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    return strided_slice(x, axes, starts, ends, [1] * len(_ints(axes)))


def tensordot(x, y, axes=2, name=None):
    if torch.is_tensor(axes):
        axes = axes.tolist()
    if isinstance(axes, (list, tuple)):
        if all(isinstance(a, (int, np.integer)) for a in axes):
            axes = [[int(a) for a in axes], [int(a) for a in axes]]
        else:
            axes = [[a] if isinstance(a, (int, np.integer)) else list(a)
                    for a in axes]
    return torch.tensordot(t_(x), t_(y), dims=axes)


def atleast_1d(*inputs, name=None):
    outs = [torch.atleast_1d(t_(i)) for i in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [torch.atleast_2d(t_(i)) for i in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [torch.atleast_3d(t_(i)) for i in inputs]
    return outs[0] if len(outs) == 1 else outs


def hsplit(x, num_or_indices, name=None):
    x = t_(x)
    return split(x, num_or_indices, axis=1 if x.ndim > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    return split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices, name=None):
    return split(x, num_or_indices, axis=2)


def hstack(x, name=None):
    return torch.hstack([t_(t) for t in x])


def vstack(x, name=None):
    return torch.vstack([t_(t) for t in x])


def dstack(x, name=None):
    return torch.dstack([t_(t) for t in x])


def column_stack(x, name=None):
    return torch.column_stack([t_(t) for t in x])


def row_stack(x, name=None):
    return vstack(x)


def tensor_split(x, num_or_indices, axis=0, name=None):
    n = num_or_indices if isinstance(num_or_indices, (int, np.integer)) \
        else _ints(num_or_indices)
    return list(torch.tensor_split(t_(x), n, dim=axis))


def as_complex(x, name=None):
    x = t_(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    x = t_(x)
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """``value`` on the last two dims' diagonal ``offset`` (wrapping for
    a tall 2-D ``x`` when ``wrap``)."""
    x = t_(x)
    n, m = x.shape[-2], x.shape[-1]
    i = torch.arange(n, device=x.device)[:, None]
    j = torch.arange(m, device=x.device)[None, :]
    mask = (j - i) == offset
    if wrap and x.ndim == 2 and n > m:
        mask = (j - (i % (m + 1))) == offset
    return torch.where(mask, torch.tensor(value, dtype=x.dtype,
                                          device=x.device), x)


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``y`` written onto the (dim1, dim2) diagonal ``offset`` of ``x``."""
    x, y = t_(x), t_(y)
    am = x.movedim((dim1, dim2), (-2, -1))
    n, m = am.shape[-2], am.shape[-1]
    diag_len = builtins.max(builtins.min(n, m - offset) if offset >= 0
                            else builtins.min(n + offset, m), 0)
    di = torch.arange(diag_len, device=x.device)
    rows = di if offset >= 0 else di - offset
    cols = di + offset if offset >= 0 else di
    bb = y.to(x.dtype).expand(am.shape[:-2] + (diag_len,))
    out = am.index_put(_diag_index(am, rows, cols), bb)
    return out.movedim((-2, -1), (dim1, dim2))


def _diag_index(a, rows, cols):
    lead = [torch.arange(s, device=a.device).reshape(
        [-1 if k == d else 1 for k in range(a.ndim - 2)] + [1])
        for d, s in enumerate(a.shape[:-2])]
    return tuple(lead) + (rows, cols)


__all__ = [
    "cast", "reshape", "flatten", "unflatten", "transpose", "moveaxis",
    "swapaxes", "squeeze", "unsqueeze", "concat", "stack", "unstack",
    "split", "chunk", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "broadcast_shape", "flip", "roll", "rot90",
    "repeat_interleave", "as_strided", "view", "pad", "unbind", "unique",
    "unique_consecutive", "masked_fill", "masked_select", "index_select",
    "index_sample", "take_along_axis", "put_along_axis", "gather",
    "gather_nd", "scatter", "scatter_nd_add", "scatter_nd", "index_add",
    "index_put", "index_fill", "where", "nonzero", "numel", "shard_index",
    "top_p_sampling", "one_hot", "bincount", "searchsorted", "bucketize",
    "diagonal", "diag_embed", "crop", "strided_slice", "slice", "tensordot",
    "atleast_1d", "atleast_2d", "atleast_3d", "hsplit", "vsplit", "dsplit",
    "hstack", "vstack", "dstack", "column_stack", "row_stack",
    "tensor_split", "as_complex", "as_real", "fill_diagonal",
    "fill_diagonal_tensor"]
autocast_module(globals())
boundary_module(globals(), __all__)


def reshape_(x, shape, name=None):
    from ._prim import rebind
    return rebind(x, reshape(x, shape))


__all__.append("reshape_")
