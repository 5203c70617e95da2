"""MoE gates (the port of
``paddle_tpu/incubate/distributed/models/moe/gate.py``).

Each gate maps tokens ``[N, d]`` to ``(weights [N, k], expert ids [N,
k])`` from fp32 softmax scores over ``x @ weight`` (``weight`` ``[d_model,
experts]``, Paddle's layout), and leaves its auxiliary loss in ``loss``.
``SwitchGate``'s training noise draws from the device's generator
(:mod:`paddle_tpu_torch.core.random`), not the reference's threefry keys;
in ``eval()`` it draws none.
"""

from __future__ import annotations

import torch

from .....core.random import generator
from .....nn import functional as F
from .....nn.layer import Layer


def _balance_loss(probs, top1, num_experts):
    """``E * sum(mean(probs) * mean(one_hot(top1)))`` (GShard / Switch)."""
    ce = torch.nn.functional.one_hot(top1, num_experts).float().mean(0)
    return (probs.mean(0) * ce).sum() * num_experts


class BaseGate(Layer):
    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 top_k: int = 2):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert            # experts per rank
        self.world_size = world_size
        self.tot_expert = num_expert * world_size
        self.top_k = top_k
        self.weight = self.create_parameter([d_model, self.tot_expert])
        self.loss = None

    def scores(self, x):
        return F.linear(x, self.weight, None)


class NaiveGate(BaseGate):
    """Top-k softmax gate, renormalised over the k, no auxiliary loss."""

    def forward(self, x):
        probs = torch.softmax(self.scores(x).float(), dim=-1)
        val, idx = torch.topk(probs, self.top_k, dim=-1)
        self.loss = None
        return val / val.sum(-1, keepdim=True), idx


class GShardGate(BaseGate):
    """Top-k gate with GShard's load-balancing loss.  ``capacity`` and
    ``random_routing`` are accepted and ignored, as in the reference (the
    layer sets the capacity)."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None):
        super().__init__(d_model, num_expert, world_size, top_k)
        self.capacity = capacity

    def forward(self, x):
        probs = torch.softmax(self.scores(x).float(), dim=-1)
        val, idx = torch.topk(probs, self.top_k, dim=-1)
        self.loss = _balance_loss(probs, idx[:, 0], self.tot_expert)
        return val / val.sum(-1, keepdim=True), idx


class SwitchGate(BaseGate):
    """Top-1 Switch Transformer gate with its load-balancing loss; in
    training the scores are scaled by noise uniform in ``[1 - switch_eps,
    1 + switch_eps)``."""

    def __init__(self, d_model, num_expert, world_size=1, top_k=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None):
        super().__init__(d_model, num_expert, world_size, top_k=1)
        self.switch_eps = switch_eps

    def forward(self, x):
        logits = self.scores(x).float()
        if self.training:
            noise = torch.rand(logits.shape, device=logits.device,
                               generator=generator(logits.device))
            logits = logits * (1.0 - self.switch_eps +
                               2.0 * self.switch_eps * noise)
        probs = torch.softmax(logits, dim=-1)
        val, idx = torch.topk(probs, 1, dim=-1)
        self.loss = _balance_loss(probs, idx[:, 0], self.tot_expert)
        return val, idx
