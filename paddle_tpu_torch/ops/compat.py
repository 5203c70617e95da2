"""Top-level API shims (the port of ``paddle_tpu/ops/compat.py``): dtype
introspection, small tensor utilities, in-place variants with irregular
signatures, in-place random fills and the RNG-state aliases."""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes
from ..core.random import generator
from ..core.tensor import boundary_module
from ._prim import autocast_module, rebind, t_

__all__ = [
    "iinfo", "finfo", "shape", "rank", "tolist", "reverse", "pdist",
    "reduce_as", "create_parameter", "create_tensor", "check_shape",
    "disable_signal_handler", "LazyGuard",
    "addmm_", "where_", "mod_", "floor_mod_", "renorm_", "polygamma_",
    "gammainc_", "gammaincc_", "multigammaln_", "bitwise_left_shift_",
    "bitwise_right_shift_", "masked_scatter_", "index_fill_",
    "bernoulli_", "log_normal_", "cauchy_", "geometric_",
    "get_cuda_rng_state", "set_cuda_rng_state",
]


def iinfo(dtype):
    return torch.iinfo(dtypes.convert_dtype(dtype))


def finfo(dtype):
    return torch.finfo(dtypes.convert_dtype(dtype))


def shape(x):
    """The shape as an int32 tensor."""
    x = t_(x)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def rank(x):
    """The number of dims as a 0-d int32 tensor."""
    x = t_(x)
    return torch.full((), x.ndim, dtype=torch.int32, device=x.device)


def tolist(x):
    return t_(x).tolist()


def reverse(x, axis, name=None):
    from .manipulation import flip
    return flip(x, axis)


def pdist(x, p=2.0, name=None):
    """Condensed pairwise distances of [N, D] rows (p=0 counts nonzeros,
    p=inf is the max norm)."""
    a = t_(x)
    n = a.shape[0]
    d = a[:, None, :] - a[None, :, :]
    if p == 2.0:
        m = torch.sqrt(torch.clamp((d * d).sum(-1), min=0.0))
    elif p == 0.0:
        m = (d != 0).to(a.dtype).sum(-1)
    elif p == float("inf"):
        m = d.abs().amax(-1)
    else:
        m = (d.abs() ** p).sum(-1) ** (1.0 / p)
    iu = torch.triu_indices(n, n, 1, device=a.device)
    return m[iu[0], iu[1]]


def reduce_as(x, target, name=None):
    """``x`` summed down to ``target``'s shape."""
    a, tshape = t_(x), tuple(t_(target).shape)
    extra = a.ndim - len(tshape)
    dims = list(range(extra)) + [extra + i for i, td in enumerate(tshape)
                                 if a.shape[extra + i] != td]
    out = a.sum(dim=dims) if dims else a
    return out.reshape(tshape)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A ``Parameter`` drawn by ``attr``'s or the default initializer
    (``Constant(0)`` for a bias, ``XavierNormal`` otherwise)."""
    from ..nn.layer import Layer
    layer = Layer(dtype=dtype)
    p = layer.create_parameter(list(shape), attr=attr, dtype=dtype,
                               is_bias=is_bias,
                               default_initializer=default_initializer)
    if name is not None:
        p.name = name
    return p


def check_shape(shape):  # noqa: A002
    """Negative dims are rejected; tensor specs and elements pass."""
    if torch.is_tensor(shape):
        return True
    for d in shape:
        if torch.is_tensor(d):
            continue
        if not isinstance(d, (int, np.integer)):
            raise TypeError(f"shape entries must be ints, got {type(d)}")
        if d < 0:
            raise ValueError(
                f"invalid dimension {d}: negative dims are not accepted")
    return True


def create_tensor(dtype, name=None, persistable=False):
    """An empty tensor of ``dtype``."""
    from ..core.tensor import wrap
    from ..device import current
    t = wrap(torch.zeros((0,), dtype=dtypes.convert_dtype(dtype),
                         device=current()))
    if name is not None:
        t.name = name
    t.persistable = persistable
    return t


def disable_signal_handler():
    """None are installed; nothing to do."""


class LazyGuard:
    """A context that scopes lazy parameter creation (parameters here are
    made when their layer is)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _base(name):
    from .. import ops as _o
    return getattr(_o, name)


def addmm_(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return rebind(input, _base("addmm")(input, x, y, beta=beta, alpha=alpha))


def where_(condition, x, y, name=None):
    if not torch.is_tensor(x) or not torch.is_tensor(y):
        raise ValueError("where_ requires Tensor x and y")
    return rebind(x, _base("where")(condition, x, y))


def mod_(x, y, name=None):
    return rebind(x, _base("remainder")(x, y))


floor_mod_ = mod_


def renorm_(x, p, axis, max_norm):
    return rebind(x, _base("renorm")(x, p, axis, max_norm))


def polygamma_(x, n, name=None):
    return rebind(x, _base("polygamma")(x, n))


def gammainc_(x, y, name=None):
    return rebind(x, _base("gammainc")(x, y))


def gammaincc_(x, y, name=None):
    return rebind(x, _base("gammaincc")(x, y))


def multigammaln_(x, p, name=None):
    return rebind(x, _base("multigammaln")(x, p))


def bitwise_left_shift_(x, y, name=None):
    return rebind(x, _base("bitwise_left_shift")(x, y))


def bitwise_right_shift_(x, y, name=None):
    return rebind(x, _base("bitwise_right_shift")(x, y))


def masked_scatter_(x, mask, value, name=None):
    return rebind(x, _base("masked_scatter")(x, mask, value))


def index_fill_(x, index, axis, value, name=None):
    return rebind(x, _base("index_fill")(x, index, axis, value))


def _uniform(x, lo=0.0, hi=1.0):
    u = torch.rand(tuple(x.shape), dtype=torch.float32, device=x.device,
                   generator=generator(x.device))
    return u * (hi - lo) + lo


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        return rebind(x, (_uniform(x) < p).to(x.dtype))


def log_normal_(x, mean=1.0, std=2.0, name=None):
    z = torch.randn(tuple(x.shape), dtype=torch.float32, device=x.device,
                    generator=generator(x.device))
    with torch.no_grad():
        return rebind(x, torch.exp(mean + std * z).to(x.dtype))


def cauchy_(x, loc=0.0, scale=1.0, name=None):
    u = _uniform(x, 1e-7, 1.0 - 1e-7)
    with torch.no_grad():
        return rebind(x, (loc + scale * torch.tan(np.pi * (u - 0.5))
                          ).to(x.dtype))


def geometric_(x, probs, name=None):
    """log(u) / log1p(-probs), continuous, as the reference draws it."""
    u = _uniform(x, 1e-7, 1.0 - 1e-7)
    with torch.no_grad():
        return rebind(x, (torch.log(u) / np.log1p(-probs)).to(x.dtype))


def get_cuda_rng_state():
    from ..core import random as R
    return R.get_rng_state()


def set_cuda_rng_state(state):
    from ..core import random as R
    return R.set_rng_state(state)


autocast_module(globals())
boundary_module(globals(), ["shape", "rank", "reverse", "pdist",
                            "reduce_as"])
