"""Shape ops (the port of ``paddle_tpu/ops/manipulation.py``'s ``reshape``,
``flatten`` and ``concat``).  Each casts its inputs as the reference's op
of the same name does under autocast."""

from __future__ import annotations

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
