"""GPT-2 decoder family (port of ``paddle_tpu/models/gpt.py``; BASELINE.md
config 2).

Pre-LayerNorm blocks with learned position embeddings, causal attention
through the flash-attention kernels (on the card at d 64, bf16 takes their
"sm90" route), GELU with the tanh approximation, and a weight-tied LM head:
``logits = h @ gpt.wte.T``, one parameter whose gradient gathers both uses.
Weights keep the reference's ``[in, out]`` layout and parameter names
(``gpt.h.0.qkv.weight``), so
:func:`paddle_tpu_torch.utils.load_reference_state` carries a reference
model across; the LayerNorm parameters are fp32, as the
reference's are.

Where the port differs: the reference's LayerNorm multiplies by its fp32
weight, which promotes a bf16 model's activations to fp32 from the first
block on; the port normalises in fp32 and returns the model dtype, so a
bf16 model's projections and attention run in bf16.  fp32 models compute
the same function in both packages.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..kernels.flash_attention import flash_attention
from .llama import _Init, torch_dtype


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        base = dict(vocab_size=128, hidden_size=48, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=96,
                    max_position_embeddings=64, dtype="float32")
        base.update(kw)
        return GPTConfig(**base)

    @staticmethod
    def gpt2_base(**kw) -> "GPTConfig":
        return GPTConfig(**kw)

    @staticmethod
    def gpt2_medium(**kw) -> "GPTConfig":
        return GPTConfig(**{**dict(hidden_size=1024, num_hidden_layers=24,
                                   num_attention_heads=16,
                                   intermediate_size=4096), **kw})


class _Linear(nn.Module):
    """``x @ weight + bias``, weight [in, out] N(0, std²), bias zeros."""

    def __init__(self, in_f, out_f, init: _Init, std=0.02):
        super().__init__()
        self.weight = init.normal((in_f, out_f), std)
        self.bias = init.zeros((out_f,))

    def forward(self, x):
        return x @ self.weight + self.bias


class _LayerNorm(nn.Module):
    """LayerNorm over the last dim with fp32 weight and bias, computed in
    fp32 and returned in x's dtype."""

    def __init__(self, hidden, eps, init: _Init):
        super().__init__()
        self.weight = init.ones((hidden,), torch.float32)
        self.bias = init.zeros((hidden,), torch.float32)
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class GPTBlock(nn.Module):
    def __init__(self, c: GPTConfig, init: _Init):
        super().__init__()
        h = c.hidden_size
        resid_std = 0.02 / math.sqrt(2 * c.num_hidden_layers)
        self.ln_1 = _LayerNorm(h, c.layer_norm_epsilon, init)
        self.ln_2 = _LayerNorm(h, c.layer_norm_epsilon, init)
        self.qkv = _Linear(h, 3 * h, init)
        self.proj = _Linear(h, h, init, std=resid_std)
        self.fc_in = _Linear(h, c.intermediate_size, init)
        self.fc_out = _Linear(c.intermediate_size, h, init, std=resid_std)
        self._c = c

    def forward(self, x):
        c = self._c
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(self.ln_1(x)).reshape(b, s, 3, c.num_attention_heads,
                                             c.head_dim)
        att = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                              causal=True).reshape(b, s, c.hidden_size)
        x = x + self.proj(att)
        h = F.gelu(self.fc_in(self.ln_2(x)), approximate="tanh")
        return x + self.fc_out(h)


class GPTModel(nn.Module):
    def __init__(self, c: GPTConfig, init: _Init):
        super().__init__()
        self.config = c
        self.wte = init.normal((c.vocab_size, c.hidden_size), 0.02)
        self.wpe = init.normal((c.max_position_embeddings, c.hidden_size),
                               0.01)
        self.h = nn.ModuleList([GPTBlock(c, init)
                                for _ in range(c.num_hidden_layers)])
        self.ln_f = _LayerNorm(c.hidden_size, c.layer_norm_epsilon, init)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        x = F.embedding(input_ids, self.wte) + self.wpe[:s]
        for block in self.h:
            x = block(x)
        return self.ln_f(x)


def lm_loss(logits, labels, ignore_index=-100):
    """Mean fp32 cross-entropy over the labels that are not
    ``ignore_index`` (0 when every label is ignored), as the reference's
    ``F.cross_entropy``; nothing is read back to the host."""
    lf = logits.float().reshape(-1, logits.shape[-1])
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    logp = torch.log_softmax(lf, dim=-1)
    picked = torch.gather(logp, 1, torch.where(valid, lab, 0)[:, None])[:, 0]
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    return loss.sum() / torch.clamp(valid.sum().float(), min=1.0)


class GPTForCausalLM(nn.Module):
    """GPT-2 with a weight-tied head, random init from ``seed`` on
    ``device`` (default ``"cuda"``; raises without a GPU) with the
    reference's stds: 0.02, the residual projections 0.02/√(2L), ``wpe``
    0.01; biases 0, LayerNorm weights 1.  ``forward(input_ids[,
    labels])`` returns logits [b, s, vocab] (in the model dtype), or
    ``(logits, loss)`` with labels (``-100`` ignored).  Differentiable: the
    parameters require gradients."""

    def __init__(self, config: GPTConfig, *, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, _Init(dev, torch_dtype(config.dtype),
                                          seed))
        for p in self.parameters():
            p.requires_grad_(True)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.device

    def forward(self, input_ids, labels=None):
        logits = self.gpt(input_ids) @ self.gpt.wte.T
        if labels is None:
            return logits
        return logits, lm_loss(logits, labels)
