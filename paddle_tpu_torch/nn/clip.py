"""Gradient clipping (the port of ``paddle_tpu/nn/clip.py``).

A clip object takes the optimizer's ``[(param, grad), ...]`` and returns
new pairs; the norms stay on the device (no host read).  Parameters with
``need_clip = False`` pass unclipped.  A row-sparse gradient
(``SelectedRowsTensor``) keeps its rows under ``ClipGradByGlobalNorm``,
whose norm is taken from its values (:56-95); ``ClipGradByValue`` and
``ClipGradByNorm`` densify it, as the reference does (:23-50).
"""

from __future__ import annotations

import torch

from ..core.selected_rows import SelectedRowsTensor
from ..core.tensor import boundary


class ClipGradBase:
    @boundary
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


def _skip(p, g):
    return g is None or not getattr(p, "need_clip", True)


def _dense(g):
    return g._dense() if isinstance(g, SelectedRowsTensor) else g


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _dygraph_clip(self, params_grads):
        return [(p, g if _skip(p, g) else
                 torch.clamp(_dense(g), self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skip(p, g):
                out.append((p, g))
                continue
            g = _dense(g)
            norm = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(norm, 1e-12), 1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken in float32 over all of them."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm_sq(self, params_grads):
        sq = None
        for p, g in params_grads:
            if _skip(p, g):
                continue
            if isinstance(g, SelectedRowsTensor):
                # coalesced rows: the values' norm is the dense one
                g = g._values
            s = torch.sum(torch.square(g.float()))
            sq = s if sq is None else sq + s
        return sq

    def _dygraph_clip(self, params_grads, extra_norm_sq=None):
        sq = self.global_norm_sq(params_grads)
        if sq is None:
            return params_grads
        if extra_norm_sq is not None:
            sq = sq + extra_norm_sq
        scale = self.clip_norm / torch.clamp_min(torch.sqrt(sq),
                                                 self.clip_norm)
        return [(p, g if _skip(p, g) else _scaled(g, scale))
                for p, g in params_grads]


def _scaled(g, scale):
    if isinstance(g, SelectedRowsTensor):
        return g._with_values(_scaled(g._values, scale))
    return (g.float() * scale).to(g.dtype)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place so their total
    ``norm_type`` norm is at most ``max_norm``; returns the total norm.
    After ``amp.GradScaler.unscale_`` a half-precision gradient is read
    and scaled as its float32 value, as the reference's is."""
    return _clip_grad_norm(
        parameters, max_norm, norm_type,
        lambda total: max_norm / torch.clamp_min(total, 1e-6))


def _clip_grad_norm(parameters, max_norm, norm_type, scale_of,
                    error_if_nonfinite=False):
    """The total ``norm_type`` norm of the gradients, each then scaled in
    place by ``min(scale_of(total), 1)`` (``nn.clip_grad_norm_`` and
    ``nn.utils.clip_grad_norm_`` differ only in ``scale_of``).  With
    ``error_if_nonfinite`` the norm is read on the host (a marked sync)."""
    from ..amp import float32_grad, keep_float32_grad
    if torch.is_tensor(parameters):
        parameters = [parameters]
    params = [p for p in parameters if p.grad is not None]
    grads = [float32_grad(p) for p in params]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.pow(sum(torch.sum(torch.pow(g.abs(), norm_type))
                              for g in grads), 1.0 / norm_type)
    if error_if_nonfinite:
        from ..observability import count_sync
        count_sync()
        if not bool(torch.isfinite(total)):
            raise RuntimeError("non-finite total norm in clip_grad_norm_")
    scale = torch.clamp_max(scale_of(total), 1.0)
    for p, g in zip(params, grads):
        g.mul_(scale)
        if g is not p.grad:
            keep_float32_grad(p, g)
    return total
