"""Shape ops (the port of ``paddle_tpu/ops/manipulation.py``'s ``reshape``,
``flatten``, ``concat`` and ``pad``).  Each casts its inputs as the
reference's op of the same name does under autocast."""

from __future__ import annotations

import numpy as np
import torch

from ..core.amp_state import cast as _amp


def reshape(x, shape, name=None):
    (x,) = _amp("reshape", x)
    if torch.is_tensor(shape):
        shape = shape.tolist()
    return torch.reshape(x, [int(s) for s in shape])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis`` .. ``stop_axis`` merged into one (reference
    ``manipulation.py:39``)."""
    nd = x.ndim
    s = start_axis % nd if nd else 0
    e = stop_axis % nd if nd else 0
    return reshape(x, list(x.shape[:s]) + [-1] + list(x.shape[e + 1:]))


def concat(x, axis=0, name=None):
    xs = _amp("concat", *x)
    return torch.cat(xs, dim=int(axis))


# source rows of a padded dim, one a (size, before, after, mode, device)
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
    (x,) = _amp("pad", x)
    if torch.is_tensor(pad):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
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
        return torch.nn.functional.pad(
            x, [v for lo_hi in reversed(width) for v in lo_hi],
            value=float(value))
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            x = x.index_select(d, _pad_rows(x.shape[d], lo, hi, mode,
                                            x.device))
    return x
