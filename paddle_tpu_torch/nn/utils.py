"""``nn.utils`` (the port of ``paddle_tpu/nn/utils.py``): parameters to and
from one vector, the weight-norm and spectral-norm reparameterizations and
the gradient clips.

``weight_norm`` and ``spectral_norm`` are forward-pre-hooks, as in the
reference: the layer's ``weight`` stops being a parameter and is rebuilt
from ``weight_g`` / ``weight_v`` (or from ``weight_orig`` and the power
iteration's ``weight_u`` / ``weight_v`` buffers) before every call, so
autograd runs through the reparameterization.  State names are the
reference's.
"""

from __future__ import annotations

import torch

from ..core.random import generator
from ..core.tensor import Parameter
from .clip import _clip_grad_norm


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    offset = 0
    for p in parameters:
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape))
        offset += n


def _norm_except(v, dim):
    """The L2 norm over every dim but ``dim`` (kept, broadcastable)."""
    dims = [i for i in range(v.ndim) if i != dim % v.ndim]
    return torch.sqrt(torch.sum(torch.square(v), dim=dims, keepdim=True))


def _weight_norm_value(g, v, dim):
    return g * v / torch.clamp_min(_norm_except(v, dim), 1e-12)


def _drop_parameter(layer, name):
    if name in layer._parameters:
        del layer._parameters[name]


def weight_norm(layer, name="weight", dim=0):
    """``layer.<name>`` as ``g * v / ||v||`` (the norm over every dim but
    ``dim``): parameters ``<name>_g`` and ``<name>_v`` in its place, the
    weight rebuilt by a forward-pre-hook."""
    dim = 0 if dim is None else dim
    w = getattr(layer, name).detach()
    layer.add_parameter(f"{name}_g", Parameter(_norm_except(w, dim).clone()))
    layer.add_parameter(f"{name}_v", Parameter(w.clone()))
    _drop_parameter(layer, name)

    def _recompute(lyr, inputs):
        object.__setattr__(lyr, name, _weight_norm_value(
            getattr(lyr, f"{name}_g"), getattr(lyr, f"{name}_v"), dim))

    layer._weight_norm_hook = layer.register_forward_pre_hook(_recompute)
    layer._weight_norm_cfg = (name, dim)
    _recompute(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g * v / ||v||`` back into a plain ``<name>`` parameter."""
    if not hasattr(layer, "_weight_norm_hook"):
        return layer
    nm, dim = layer._weight_norm_cfg
    with torch.no_grad():
        eff = _weight_norm_value(getattr(layer, f"{nm}_g"),
                                 getattr(layer, f"{nm}_v"), dim)
    layer._weight_norm_hook.remove()
    _drop_parameter(layer, f"{nm}_g")
    _drop_parameter(layer, f"{nm}_v")
    layer.__dict__.pop(nm, None)
    layer.add_parameter(nm, Parameter(eff.clone()))
    del layer._weight_norm_hook, layer._weight_norm_cfg
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """``layer.<name>`` divided by its largest singular value, estimated by
    power iteration whose vectors persist in the buffers ``<name>_u`` and
    ``<name>_v`` (drawn from the device's generator, unit length) and are
    refined once a call without gradient; the raw weight is the parameter
    ``<name>_orig``."""
    dim = 0 if dim is None else dim
    w = getattr(layer, name).detach()
    rows = w.shape[dim]
    cols = w.numel() // rows
    gen = generator(w.device)
    u0 = torch.randn((rows,), generator=gen, device=w.device)
    v0 = torch.randn((cols,), generator=gen, device=w.device)
    layer.register_buffer(f"{name}_u", u0 / torch.linalg.vector_norm(u0))
    layer.register_buffer(f"{name}_v", v0 / torch.linalg.vector_norm(v0))
    layer.add_parameter(f"{name}_orig", Parameter(w.clone()))
    _drop_parameter(layer, name)

    def _recompute(lyr, inputs):
        w_orig = getattr(lyr, f"{name}_orig")
        u, v = getattr(lyr, f"{name}_u"), getattr(lyr, f"{name}_v")
        with torch.no_grad():
            wm = torch.movedim(w_orig, dim, 0).reshape(rows, cols).float()
            for _ in range(max(1, n_power_iterations)):
                v = wm.T @ u
                v = v / torch.clamp_min(torch.linalg.vector_norm(v), eps)
                u = wm @ v
                u = u / torch.clamp_min(torch.linalg.vector_norm(u), eps)
            getattr(lyr, f"{name}_u").copy_(u)
            getattr(lyr, f"{name}_v").copy_(v)
        wm = torch.movedim(w_orig, dim, 0).reshape(rows, cols)
        sigma = u.to(w_orig.dtype) @ wm @ v.to(w_orig.dtype)
        object.__setattr__(lyr, name,
                           w_orig / torch.clamp_min(sigma, eps))

    layer._spectral_norm_hook = layer.register_forward_pre_hook(_recompute)
    _recompute(layer, None)
    return layer


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place by ``min(max_norm /
    (total + 1e-6), 1)`` and return the total norm: ``nn.clip_grad_norm_``
    (:func:`paddle_tpu_torch.nn.clip.clip_grad_norm_`) with the reference's
    ``nn.utils`` denominator, ``total + 1e-6`` where the other takes
    ``max(total, 1e-6)``.  ``error_if_nonfinite`` reads the norm on the
    host (a marked sync) and raises if it is not finite."""
    return _clip_grad_norm(parameters, max_norm, norm_type,
                           lambda total: max_norm / (total + 1e-6),
                           error_if_nonfinite)


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    for p in parameters:
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)


__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "remove_weight_norm", "spectral_norm", "vector_to_parameters",
           "weight_norm"]

from ..core.tensor import boundary_module  # noqa: E402

boundary_module(globals(), __all__)
