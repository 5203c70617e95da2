"""Random creation ops (the port of ``paddle_tpu/ops/random_ops.py``'s
``randn`` and ``randint``), drawn from the current device's generator
(:mod:`paddle_tpu_torch.core.random`)."""

from __future__ import annotations

import torch

from .. import dtypes
from ..core.random import generator
from ..device import current
from .creation import _shape


def randn(shape, dtype=None, name=None):
    dev = current()
    return torch.randn(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                       device=dev, generator=generator(dev))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current()
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=dtypes.convert_dtype(dtype), device=dev,
                         generator=generator(dev))
