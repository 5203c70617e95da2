"""The fused functional ops the port's fused layers call (the port of
``paddle_tpu/incubate/nn/functional.py``'s ``fused_linear`` and
``fused_dropout_add``).  The rest of that module waits for a later slice
(``ROADMAP.md``)."""

from __future__ import annotations

from ...nn import functional as F
from ...ops.math import add


def fused_linear(x, weight, bias=None, transpose_weight=False):
    return F.linear(x, weight.t() if transpose_weight else weight, bias)


def fused_dropout_add(x, y, p=0.0, training=True, mode="upscale_in_train"):
    return add(F.dropout(x, p=p, training=training, mode=mode), y)


__all__ = ["fused_dropout_add", "fused_linear"]
