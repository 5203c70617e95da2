"""Llama-2 decoder family (port of ``paddle_tpu/models/llama.py``, dense).

Weights keep the reference's layout: every projection is ``[in, out]`` and
applied as ``y @ W``, and parameter names equal the reference's
``state_dict()`` names (``llama.layers.0.self_attn.q_proj.weight``), so
:func:`paddle_tpu_torch.utils.load_reference_state` carries a reference
model's weights over one to one.  RoPE rotates interleaved pairs
``(x[..., 0::2], x[..., 1::2])`` as the reference does.

MoE configurations (``moe_num_experts > 0``) are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..kernels.flash_attention import flash_attention
from ..kernels.rms_norm import rms_norm_fp32

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the reference configs ('bfloat16', ...) as torch's."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # MoE: 0 experts = dense.  Expert layers are not ported yet
    # (ROADMAP Queue 1 item 7, with the gmm kernel of Queue 2).
    moe_num_experts: int = 0

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128,
                    dtype="float32")
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**{**dict(hidden_size=4096, intermediate_size=11008,
                                     num_hidden_layers=32, num_attention_heads=32), **kw})

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(**{**dict(hidden_size=5120, intermediate_size=13824,
                                     num_hidden_layers=40, num_attention_heads=40), **kw})


def _rope_cos_sin(seq_len: int, head_dim: int, theta: float,
                  dtype=torch.float32, device=None):
    """[seq_len, head_dim/2] cos and sin tables (the reference's numpy math)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(seq_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)                      # [s, d/2]
    return (torch.as_tensor(np.cos(freqs), dtype=dtype, device=device),
            torch.as_tensor(np.sin(freqs), dtype=dtype, device=device))


def apply_rotary_pos_emb(x, cos, sin):
    """Rotate interleaved pairs (x[..., ::2], x[..., 1::2]).
    x: [b, s, h, d]; cos/sin: [s, d/2] (fp32); returns x.dtype."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def swiglu(gate, up):
    return F.silu(gate) * up


class _Init:
    """The reference's ``_scaled_init``: N(0, 1/fan_in) drawn in fp32 from
    one seeded ``torch.Generator`` on the target device, cast to the model
    dtype — full-width bf16 activations stay finite."""

    def __init__(self, device, dtype, seed: int):
        self.device, self.dtype = device, dtype
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def scaled(self, shape, fan_in):
        w = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32) * (1.0 / math.sqrt(fan_in))
        return nn.Parameter(w.to(self.dtype), requires_grad=False)

    def ones(self, shape):
        return nn.Parameter(torch.ones(shape, device=self.device,
                                       dtype=self.dtype), requires_grad=False)


class _ParamLinear(nn.Module):
    """Bias-free linear, weight [in, out] (Llama uses no biases)."""

    def __init__(self, in_f, out_f, init: _Init):
        super().__init__()
        self.weight = init.scaled((in_f, out_f), in_f)

    def forward(self, x):
        return x @ self.weight


class _Embedding(nn.Module):
    def __init__(self, vocab, hidden, init: _Init):
        super().__init__()
        self.weight = init.scaled((vocab, hidden), hidden)

    def forward(self, ids):
        return self.weight[ids]


class LlamaRMSNorm(nn.Module):
    """fp32-accumulating RMSNorm."""

    def __init__(self, hidden_size: int, eps: float, init: _Init):
        super().__init__()
        self.weight = init.ones((hidden_size,))
        self.eps = eps

    def forward(self, x):
        return rms_norm_fp32(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        c = config
        self.config = c
        hd, h = c.head_dim, c.hidden_size
        self.q_proj = _ParamLinear(h, c.num_attention_heads * hd, init)
        self.k_proj = _ParamLinear(h, c.num_key_value_heads * hd, init)
        self.v_proj = _ParamLinear(h, c.num_key_value_heads * hd, init)
        self.o_proj = _ParamLinear(c.num_attention_heads * hd, h, init)

    def forward(self, hidden, cos, sin):
        c = self.config
        b, s = hidden.shape[0], hidden.shape[1]
        q = self.q_proj(hidden).reshape(b, s, c.num_attention_heads, c.head_dim)
        k = self.k_proj(hidden).reshape(b, s, c.num_key_value_heads, c.head_dim)
        v = self.v_proj(hidden).reshape(b, s, c.num_key_value_heads, c.head_dim)
        q = apply_rotary_pos_emb(q, cos, sin)
        k = apply_rotary_pos_emb(k, cos, sin)
        out = flash_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, c.num_attention_heads * c.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        c = config
        self.gate_proj = _ParamLinear(c.hidden_size, c.intermediate_size, init)
        self.up_proj = _ParamLinear(c.hidden_size, c.intermediate_size, init)
        self.down_proj = _ParamLinear(c.intermediate_size, c.hidden_size, init)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.self_attn = LlamaAttention(config, init)
        self.mlp = LlamaMLP(config, init)
        self.input_layernorm = LlamaRMSNorm(config.hidden_size,
                                            config.rms_norm_eps, init)
        self.post_attention_layernorm = LlamaRMSNorm(config.hidden_size,
                                                     config.rms_norm_eps, init)

    def forward(self, hidden, cos, sin):
        h = hidden + self.self_attn(self.input_layernorm(hidden), cos, sin)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.config = config
        self.embed_tokens = _Embedding(config.vocab_size, config.hidden_size,
                                       init)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, init)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps, init)

    def forward(self, input_ids):
        c = self.config
        cos, sin = _rope_cos_sin(input_ids.shape[1], c.head_dim, c.rope_theta,
                                 device=input_ids.device)
        h = self.embed_tokens(input_ids)
        for layer in self.layers:
            h = layer(h, cos, sin)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """Dense Llama with random init from ``seed`` on ``device`` (default
    ``"cuda"``; raises without a GPU).  ``forward(input_ids [b, s])`` returns
    logits [b, s, vocab] (full-sequence causal attention; CPU tensors only
    until the flash-attention kernel is ported)."""

    def __init__(self, config: LlamaConfig, *, device=None, seed: int = 0):
        super().__init__()
        if config.moe_num_experts:
            raise NotImplementedError(
                "MoE Llama is not ported yet (ROADMAP Queue 1 item 7 and "
                "Queue 2 item 3, the gmm kernel)")
        dev = resolve_device(device)
        init = _Init(dev, torch_dtype(config.dtype), seed)
        self.config = config
        self.llama = LlamaModel(config, init)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = _ParamLinear(config.hidden_size, config.vocab_size,
                                        init)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def forward(self, input_ids):
        h = self.llama(input_ids)
        if self.lm_head is None:
            return h @ self.llama.embed_tokens.weight.T
        return self.lm_head(h)
