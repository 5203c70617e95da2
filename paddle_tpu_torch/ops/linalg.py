"""``matmul`` (the port of ``paddle_tpu/ops/linalg.py:32``): a plain
``torch.matmul``, which the reference leaves to XLA."""

from __future__ import annotations

import torch

from ..core.amp_state import cast as _amp


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = _amp("matmul", x, y)
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)
