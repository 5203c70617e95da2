"""The MoE layer (the port of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

Capacity-based dispatch with static shapes: a token's place in its
expert's buffer is its rank among the entries routed there, k-major (every
token's first choice before any second choice), and entries past the
capacity drop (GShard).  Two dispatch forms compute the same function:

- ``"gather"`` (the default): int32 slot maps from
  :func:`paddle_tpu_torch.kernels.grouped_matmul.capacity_dispatch_plan`
  and row gathers (:func:`~paddle_tpu_torch.kernels.grouped_matmul.
  take_sentinel_rows`), no ``[N, E, C]`` tensor;
- ``"einsum"``: one-hot dispatch and combine tensors ``[N, E, C]``
  contracted with the tokens (the reference's oracle).

Experts of one architecture run together: their parameters are stacked on
a leading expert axis (a differentiable ``torch.stack``, so every expert
parameter gets its gradient) and applied with ``torch.func.vmap`` over
``torch.func.functional_call`` of the first expert, as the reference applies
``jax.vmap``.  Experts that differ run one by one (``_forward_python``).
Everything is plain PyTorch, as the reference's layer is XLA.  Expert
parallelism over a group (``moe_group``) waits for the port of
``distributed/`` and raises.
"""

from __future__ import annotations

import math
from typing import List

import torch

from .....kernels.grouped_matmul import (capacity_dispatch_plan,
                                          take_sentinel_rows)
from .....nn.layer import Layer, LayerList
from .....utils import extract_params
from .gate import GShardGate, NaiveGate, SwitchGate


def _dispatch_combine(gate_val, gate_idx, num_experts, capacity):
    """One-hot dispatch ``[N, E, C]`` (fp32, 0/1) and the weighted combine
    ``[N, E, C]``; tokens past an expert's capacity drop."""
    N, K = gate_idx.shape
    oh = torch.nn.functional.one_hot(gate_idx.long(), num_experts).float()
    flat = oh.transpose(0, 1).reshape(K * N, num_experts)       # k-major
    pos = torch.cumsum(flat, dim=0) - flat
    pos = pos.reshape(K, N, num_experts).transpose(0, 1)        # [N, K, E]
    pos = (pos * oh).sum(-1).long()                             # [N, K]
    keep = pos < capacity
    pos_oh = (pos[..., None] == torch.arange(
        capacity, device=pos.device)).float()                   # [N, K, C]
    disp = torch.einsum("nke,nkc->nkec", oh, pos_oh) * keep[..., None, None]
    dispatch = disp.sum(1).clamp(0.0, 1.0)
    combine = torch.einsum("nkec,nk->nec", disp, gate_val.float())
    return dispatch, combine


def _dispatch_indices(gate_val, gate_idx, num_experts, capacity):
    """The index form of :func:`_dispatch_combine` (same slots, priority
    and drops): ``(inv, slot, gate_keep)`` of
    :func:`capacity_dispatch_plan`."""
    inv, slot, gate_keep, _ = capacity_dispatch_plan(
        gate_idx, gate_val, num_experts, capacity)
    return inv, slot, gate_keep


class MoELayer(Layer):
    """``gate``: a dict (``{"type": "gshard" | "switch" | "naive", "top_k":
    k}``) or a gate layer; ``experts``: a list or ``LayerList`` of expert
    layers.  ``dispatch``: ``"gather"`` or ``"einsum"``.  ``capacity`` per
    expert is ``max(ceil(capacity_factor * N * k / E), 4)``; ``loss`` is
    the gate's auxiliary loss of the last forward.  ``mp_group`` and
    ``recompute_interval`` are accepted and unused, as in the reference."""

    def __init__(self, d_model: int, experts: List, gate=None, moe_group=None,
                 mp_group=None, recompute_interval: int = 0,
                 capacity_factor: float = 1.2, dispatch: str = "gather"):
        super().__init__()
        if dispatch not in ("gather", "einsum"):
            raise ValueError(
                f"dispatch must be 'gather' or 'einsum', got {dispatch!r}")
        if moe_group is not None:
            raise NotImplementedError(
                "MoELayer(moe_group=...): expert parallelism waits for the "
                "port of paddle_tpu.distributed (ROADMAP item 18)")
        self.dispatch = dispatch
        self.d_model = d_model
        if isinstance(experts, (list, tuple)):
            experts = LayerList(list(experts))
        self.experts = experts
        self.num_expert = len(experts)
        self.capacity_factor = capacity_factor

        if gate is None:
            gate = {"type": "gshard", "top_k": 2}
        if isinstance(gate, dict):
            cls = {"gshard": GShardGate, "switch": SwitchGate,
                   "naive": NaiveGate}[gate.get("type", "gshard")]
            gate = cls(d_model, self.num_expert, 1,
                       top_k=gate.get("top_k",
                                      2 if cls is not SwitchGate else 1))
        self.gate = gate

        # one architecture (parameter names and shapes, and the repr of the
        # layer tree) or expert 0's arithmetic would run every expert
        pds = [extract_params(e) for e in self.experts]
        same = (len({tuple(p) for p in pds}) == 1 and
                len({tuple(v.shape for v in p.values()) for p in pds}) == 1
                and len({repr(e) for e in self.experts}) == 1)
        self._template = self.experts[0] if same else None

    @property
    def loss(self):
        return self.gate.loss

    def _capacity(self, num_tokens: int) -> int:
        cap = int(math.ceil(self.capacity_factor * num_tokens *
                            self.gate.top_k / self.num_expert))
        return max(cap, 4)

    def forward(self, x):
        orig_shape = x.shape
        d = orig_shape[-1]
        xf = x.reshape(-1, d)
        cap = self._capacity(xf.shape[0])
        gate_val, gate_idx = self.gate(xf)
        if self._template is None:
            return self._forward_python(xf, gate_val, gate_idx, cap,
                                        orig_shape)
        E = self.num_expert
        keys = list(extract_params(self._template))
        stacked = {k: torch.stack([dict(e.named_parameters())[k]
                                   for e in self.experts])
                   for k in keys}
        if self.dispatch == "gather":
            inv, slot, gate_keep = _dispatch_indices(gate_val, gate_idx, E,
                                                     cap)
            xin = take_sentinel_rows(xf, inv[:-1]).reshape(E, cap, d)
        else:
            dispatch, combine = _dispatch_combine(gate_val, gate_idx, E, cap)
            xin = torch.einsum("nec,nd->ecd", dispatch.to(xf.dtype), xf)
        template = self._template
        eout = torch.func.vmap(
            lambda p, ein: torch.func.functional_call(template, p, (ein,)))(
                stacked, xin)                                   # [E, C, d]
        if self.dispatch == "gather":
            K, N = gate_idx.shape[1], xf.shape[0]
            picked = take_sentinel_rows(eout.reshape(E * cap, d), slot)
            y = (gate_keep[:, None].to(eout.dtype) * picked) \
                .reshape(K, N, d).sum(0)
        else:
            y = torch.einsum("nec,ecd->nd", combine.to(eout.dtype), eout)
        return y.reshape(orig_shape)

    def _forward_python(self, xf, gate_val, gate_idx, cap, orig_shape):
        dispatch, combine = _dispatch_combine(gate_val, gate_idx,
                                              self.num_expert, cap)
        xin = torch.einsum("nec,nd->ecd", dispatch.to(xf.dtype), xf)
        eout = torch.stack([e(xin[i]) for i, e in enumerate(self.experts)])
        y = torch.einsum("nec,ecd->nd", combine.to(xf.dtype), eout)
        return y.reshape(orig_shape)
