"""``add`` (the port of ``paddle_tpu/ops/_generated.py``'s): torch's ``+``
but under autocast, where an O2 ``add`` takes its float32 inputs in the amp
dtype, as the reference's ``Tensor.__add__`` does.  The residual adds of
the Paddle-API layers go through it."""

from __future__ import annotations

from ..core.amp_state import cast as _amp


def add(x, y, name=None):
    x, y = _amp("add", x, y)
    return x + y
