"""Random ops (the port of ``paddle_tpu/ops/random_ops.py``), drawn from the
current device's generator (:mod:`paddle_tpu_torch.core.random`); a
nonzero ``seed`` draws from a generator of its own.  The draws differ from
the reference's threefry stream; their shapes, dtypes, supports and
moments do not."""

from __future__ import annotations

import torch

from .. import dtypes
from ..core.random import generator
from ..core.tensor import boundary_module
from ..device import current
from ._prim import t_
from .creation import _shape


def _gen(dev, seed=0):
    if seed:
        return torch.Generator(device=dev).manual_seed(int(seed))
    return generator(dev)


def randn(shape, dtype=None, name=None):
    dev = current()
    return torch.randn(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                       device=dev, generator=generator(dev))


def rand(shape, dtype=None, name=None):
    dev = current()
    return torch.rand(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                      device=dev, generator=generator(dev))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            name=None):
    dev = current()
    u = torch.rand(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                   device=dev, generator=_gen(dev, seed))
    return u * (max - min) + min


def normal(mean=0.0, std=1.0, shape=None, dtype=None, name=None):
    if torch.is_tensor(mean) or torch.is_tensor(std):
        m, s = t_(mean), t_(std)
        out_shape = torch.broadcast_shapes(m.shape, s.shape)
        dt = m.dtype if m.is_floating_point() else s.dtype
        z = torch.randn(out_shape, dtype=dt, device=m.device,
                        generator=generator(m.device))
        return m + s * z
    dev = current()
    z = torch.randn(_shape(shape or [1]), dtype=dtypes.convert_dtype(dtype),
                    device=dev, generator=generator(dev))
    return mean + std * z


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = current()
    z = torch.randn(_shape(shape), dtype=dtypes.convert_dtype(dtype),
                    device=dev, generator=_gen(dev, seed))
    return mean + std * z


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current()
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=dtypes.convert_dtype(dtype), device=dev,
                         generator=generator(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = t_(x)
    return randint(low, high, list(x.shape), dtype or x.dtype)


def randperm(n, dtype="int64", name=None):
    dev = current()
    return torch.randperm(int(n), dtype=dtypes.convert_dtype(dtype),
                          device=dev, generator=generator(dev))


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = t_(x)
    return torch.multinomial(x.float(), num_samples, replacement,
                             generator=generator(x.device))


def bernoulli(x, name=None):
    x = t_(x)
    return torch.bernoulli(x, generator=generator(x.device))


def poisson(x, name=None):
    x = t_(x)
    return torch.poisson(x, generator=generator(x.device))


def binomial(count, prob, name=None):
    """Draws of ``Binomial(count, prob)`` (int64): a sum of ``count``
    Bernoulli draws, at most ``max(count)`` of them an element."""
    n, p = t_(count), t_(prob)
    n, p = torch.broadcast_tensors(n, p)
    top = int(n.max()) if n.numel() else 0
    u = torch.rand((top,) + tuple(n.shape), dtype=torch.float32,
                   device=p.device, generator=generator(p.device))
    live = torch.arange(top, device=p.device).reshape(
        [-1] + [1] * n.ndim) < n
    return ((u < p.float()) & live).sum(0).to(torch.int64)


def _fill(x, value):
    from ._prim import rebind
    with torch.no_grad():
        return rebind(x, value)


def exponential_(x, lam=1.0, name=None):
    g = generator(x.device)
    u = torch.rand(tuple(x.shape), dtype=x.dtype, device=x.device,
                   generator=g).clamp_(min=1e-20)
    return _fill(x, -torch.log(u) / lam)


def normal_(x, mean=0.0, std=1.0, name=None):
    z = torch.randn(tuple(x.shape), dtype=x.dtype, device=x.device,
                    generator=generator(x.device))
    return _fill(x, mean + std * z)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    u = torch.rand(tuple(x.shape), dtype=x.dtype, device=x.device,
                   generator=_gen(x.device, seed))
    return _fill(x, u * (max - min) + min)


def rand_like(x, dtype=None, name=None):
    x = t_(x)
    return rand(list(x.shape), dtype or x.dtype)


def randn_like(x, dtype=None, name=None):
    x = t_(x)
    return randn(list(x.shape), dtype or x.dtype)


__all__ = ["randn", "rand", "uniform", "normal", "gaussian",
           "standard_normal", "randint", "randint_like", "randperm",
           "multinomial", "bernoulli", "poisson", "binomial",
           "exponential_", "normal_", "uniform_", "rand_like", "randn_like"]
boundary_module(globals(), [n for n in __all__ if not n.endswith("_")])
