"""Weight initializers (the port of ``paddle_tpu/nn/initializer.py``): the
same 11 initializers, fans and gains.

An initializer is called as ``init(shape, dtype)`` and returns a tensor on
the device ``set_device`` chose, drawn from that device's generator
(:mod:`paddle_tpu_torch.core.random`).  The draws differ from the
reference's (another generator); the shapes, dtypes and distributions are
the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.random import generator
from ..device import current


def _draw(kind, shape, dtype, device=None):
    dev = current() if device is None else device
    fn = torch.randn if kind == "normal" else torch.rand
    return fn(tuple(shape), dtype=dtype, device=dev, generator=generator(dev))


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=current())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return self.mean + self.std * _draw("normal", shape, dtype)


class TruncatedNormal(Initializer):
    """``mean + std * z`` with z a standard normal truncated to [a, b]
    (by the inverse CDF of a uniform draw)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))  # noqa
        lo, hi = cdf(self.a), cdf(self.b)
        u = lo + (hi - lo) * _draw("uniform", shape, torch.float32)
        z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(self.a,
                                                                 self.b)
        return (self.mean + self.std * z).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return self.low + (self.high - self.low) * \
            _draw("uniform", shape, dtype)


def _fans(shape):
    """(fan_in, fan_out): the reference reads fan_in from dim 0, as Linear's
    weight is ``[in, out]``."""
    shape = tuple(shape)
    if len(shape) < 2:
        return (shape[0] if shape else 1,) * 2
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[0] * receptive, shape[1] * receptive


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return std * _draw("normal", shape, dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi, fo = self.fan_in or fi, self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, dtype):
        fi = self.fan_in or _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return (gain / math.sqrt(fi)) * _draw("normal", shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def __call__(self, shape, dtype):
        fi = self.fan_in or _fans(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        v = self.value
        v = v.detach() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        return v.to(device=current(), dtype=dtype).reshape(tuple(shape))


def _orthogonal(shape, dtype, scale=1.0):
    """JAX's ``nn.initializers.orthogonal`` (column axis -1): Q of the QR
    of a normal draw, its columns signed by diag(R)."""
    if len(shape) < 2:
        raise ValueError("orthogonal initializer needs at least 2 dims")
    n_cols = shape[-1]
    n_rows = int(np.prod(shape)) // n_cols
    mshape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
    a = _draw("normal", mshape, torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return (scale * q.reshape(tuple(shape))).to(dtype)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        return _orthogonal(tuple(shape), dtype, self.gain)


class Dirac(Initializer):
    """JAX's ``nn.initializers.delta_orthogonal`` as the reference calls it:
    an orthogonal ``shape[-2:]`` matrix at the centre of the leading
    dims, zeros elsewhere (3-, 4- or 5-D, ``shape[-2] <= shape[-1]``)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        shape = tuple(shape)
        if len(shape) not in (3, 4, 5):
            raise ValueError("Dirac needs a 3-, 4- or 5-D shape")
        if shape[-2] > shape[-1]:
            raise ValueError("`fan_in` must be less or equal than `fan_out`.")
        w = torch.zeros(shape, dtype=dtype, device=current())
        centre = tuple((k - 1) // 2 for k in shape[:-2])
        w[centre] = _orthogonal(shape[-2:], dtype)
        return w


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + (param or 0.01) ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


def _resolve(init, default=None):
    """A ``param_attr``-style value as an initializer."""
    if init is None:
        return default
    if isinstance(init, Initializer):
        return init
    if isinstance(init, bool):
        return default
    if hasattr(init, "initializer"):  # ParamAttr
        return init.initializer or default
    raise TypeError(f"Cannot interpret initializer {init!r}")
