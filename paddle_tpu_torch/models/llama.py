"""Llama-2 decoder family and its Mixtral-style MoE form (port of
``paddle_tpu/models/llama.py``).

Weights keep the reference's layout: every projection is ``[in, out]`` and
applied as ``y @ W``, and parameter names equal the reference's
``state_dict()`` names (``llama.layers.0.self_attn.q_proj.weight``), so
:func:`paddle_tpu_torch.utils.load_reference_state` carries a reference
model's weights over one to one.  RoPE rotates interleaved pairs
``(x[..., 0::2], x[..., 1::2])`` as the reference does.

MoE configurations (``moe_num_experts > 0``) replace every layer's MLP with
:class:`LlamaMoEMLP`: a top-k router and stacked expert banks in one of the
reference's three dispatch forms: ``"grouped"`` runs the grouped-matmul
kernels, forward and backward (:class:`_GroupedFFN`); ``"gather"``
(:func:`moe_mlp_forward`) and ``"einsum"`` (:func:`moe_mlp_forward_einsum`)
are the capacity-bounded forms, plain PyTorch ops under autograd (the
reference leaves them to XLA).  The serving engine keeps its dense expert
loop for the two capacity forms.
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
from ..kernels.grouped_matmul import (capacity_dispatch_plan, gmm,
                                      sorted_dispatch_plan,
                                      take_sentinel_rows, tgmm)
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
    # MoE (Mixtral-style: every layer's MLP becomes a top-k expert mixture;
    # 0 experts = dense).  "grouped" runs the expert-sorted grouped-matmul
    # kernel; "gather"/"einsum" are the reference's capacity formulations.
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01
    moe_dispatch: str = "grouped"
    moe_groups: int = 0          # einsum only: token groups (0 -> batch dim)
    moe_block_m: int = 512       # grouped only: row-tile (group alignment)

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.moe_dispatch not in ("gather", "einsum", "grouped"):
            raise ValueError(
                f"moe_dispatch must be 'gather', 'einsum' or 'grouped', "
                f"got {self.moe_dispatch!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def _per_layer_params(self):
        """(dense per-layer params, expert-bank per-layer params)."""
        h, i = self.hidden_size, self.intermediate_size
        kvh = self.num_key_value_heads * self.head_dim
        attn = h * h + 2 * h * kvh + h * h + 2 * h
        if self.moe_num_experts:
            return attn + h * self.moe_num_experts, \
                self.moe_num_experts * 3 * h * i
        return attn + 3 * h * i, 0

    def _embed_params(self) -> int:
        return self.vocab_size * self.hidden_size * \
            (1 if self.tie_word_embeddings else 2) + self.hidden_size

    def num_params(self) -> int:
        dense, experts = self._per_layer_params()
        return self.num_hidden_layers * (dense + experts) + \
            self._embed_params()

    def num_active_params(self) -> int:
        """Parameters touched per token (MoE: only top_k of E experts), the
        N of the 6·N·T MFU formula for sparse models."""
        if not self.moe_num_experts:
            return self.num_params()
        dense, experts = self._per_layer_params()
        active = experts * self.moe_top_k // self.moe_num_experts
        return self.num_hidden_layers * (dense + active) + \
            self._embed_params()

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

    @staticmethod
    def mixtral_tiny(**kw) -> "LlamaConfig":
        """Mixtral-shaped MoE test config."""
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128,
                    moe_num_experts=4, moe_top_k=2, dtype="float32",
                    # tiny token counts: a 512-row tile would pad the
                    # grouped dispatch ~10x; 16 keeps M near the entries
                    moe_block_m=16)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def mixtral_8x7b(**kw) -> "LlamaConfig":
        """The published widths of Mixtral-8x7B-v0.1 (its Hugging Face
        ``config.json``): hidden 4096, intermediate 14336, 32 layers, 32
        heads over 8 kv heads, vocab 32000, rope_theta 1e6, rms_norm_eps
        1e-5, 8 experts, top-2."""
        base = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=32768, rms_norm_eps=1e-5,
                    rope_theta=1e6, moe_num_experts=8, moe_top_k=2)
        base.update(kw)
        return LlamaConfig(**base)


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
    dtype — full-width bf16 activations stay finite.  On the ``meta``
    device it makes shapes only (the trainer's template layer)."""

    def __init__(self, device, dtype, seed: int):
        self.device, self.dtype = torch.device(device), dtype
        self.gen = None if self.device.type == "meta" else \
            torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, std):
        """N(0, std²) drawn in fp32, cast to the model dtype."""
        if self.gen is None:
            return nn.Parameter(torch.empty(shape, device=self.device,
                                            dtype=self.dtype),
                                requires_grad=False)
        w = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32) * std
        return nn.Parameter(w.to(self.dtype), requires_grad=False)

    def scaled(self, shape, fan_in):
        return self.normal(shape, 1.0 / math.sqrt(fan_in))

    def ones(self, shape, dtype=None):
        return nn.Parameter(torch.ones(shape, device=self.device,
                                       dtype=dtype or self.dtype),
                            requires_grad=False)

    def zeros(self, shape, dtype=None):
        return nn.Parameter(torch.zeros(shape, device=self.device,
                                        dtype=dtype or self.dtype),
                            requires_grad=False)


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


def _route_topk(xf, gate_w, k):
    """Shared top-k router: returns (normalized gate weights [N, k] fp32,
    expert ids [N, k], GShard aux loss, first-choice load ce [E])."""
    N = xf.shape[0]
    E = gate_w.shape[-1]
    logits = xf.float() @ gate_w.float()                       # [N, E]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).index_add_(
        0, topi[:, 0], torch.ones(N, dtype=torch.float32,
                                  device=xf.device)) / N
    aux = E * torch.sum(me * ce)
    return topv, topi, aux, ce


def _token_rows(inv_flat, N, k):
    """Token row of each padded-buffer row (``inv_flat // k``), or ``N`` (the
    zero row of a zero-extended ``[N + 1, H]`` buffer) for padding rows."""
    return torch.where(inv_flat < N * k,
                       torch.div(inv_flat, k, rounding_mode="floor"),
                       torch.full_like(inv_flat, N))


def _zero_row(x):
    """``x`` [N, H] with a zero row appended: the sentinel padding rows and
    dropped entries gather."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)


def _grouped_ffn_fwd(xf, w_gate, w_up, w_down, gates, inv_flat, pos,
                     tile_groups, k, bm):
    """The expert mixture's forward: ``(y, h_g, h_u, o)``.  The dispatch
    gather rides inside the two up-projection ``gmm`` calls (``rows`` over
    the zero-extended ``xz``: padding rows read the zero row ``xz[N]``), and
    the combine is a gather through ``take_sentinel_rows``."""
    N, H = xf.shape
    xz = _zero_row(xf)
    tok_of = _token_rows(inv_flat, N, k)
    h_g = gmm(xz, w_gate, tile_groups, bm=bm, rows=tok_of)    # fused gather
    h_u = gmm(xz, w_up, tile_groups, bm=bm, rows=tok_of)
    a = F.silu(h_g) * h_u
    o = gmm(a, w_down, tile_groups, bm=bm)                     # [M, H]
    o_pos = take_sentinel_rows(o, pos).reshape(N, k, H)
    y = (o_pos * gates[..., None].to(o.dtype)).sum(dim=1)
    return y, h_g, h_u, o


def _grouped_ffn_bwd(dy, xf, w_gate, w_up, w_down, gates, inv_flat, pos,
                     tile_groups, h_g, h_u, o, E, k, bm):
    """The reference's ``_grouped_ffn_bwd``: ``(dxf, dw_gate, dw_up,
    dw_down, d_gates)``.  Dispatch and combine stay gathers in reverse; the
    combine weight and the token gather of ``dy`` ride inside the kernels as
    ``(rows, row_scale)``, so ``do = gate · dy[token]`` never materialises.
    Dropped entries (``pos >= M``) read the sentinel zero row: exactly zero
    gradient."""
    N, H = xf.shape
    xz = _zero_row(xf)
    tok_of = _token_rows(inv_flat, N, k)

    o_pos = take_sentinel_rows(o, pos).reshape(N, k, H)
    d_gates = (o_pos.float() * dy[:, None, :].float()).sum(-1)   # [N, k]
    del o_pos
    gate_pad = take_sentinel_rows(
        gates.reshape(N * k).to(dy.dtype), inv_flat)              # [M]
    dy_z = _zero_row(dy)

    sg = F.silu(h_g)
    dw_d = tgmm(sg * h_u, dy_z, tile_groups, E, bm=bm, rhs_rows=tok_of,
                rhs_scale=gate_pad)
    da = gmm(dy_z, w_down, tile_groups, bm=bm, trans_rhs=True,
             rows=tok_of, row_scale=gate_pad)                     # [M, I]
    sig = torch.sigmoid(h_g.float()).to(h_g.dtype)
    dsilu = sig + h_g * sig * (1 - sig)
    del sig
    dh_g = da * h_u * dsilu
    dh_u = da * sg
    del da, dsilu, sg
    dw_g = tgmm(xz, dh_g, tile_groups, E, bm=bm, lhs_rows=tok_of)
    dw_u = tgmm(xz, dh_u, tile_groups, E, bm=bm, lhs_rows=tok_of)
    dx_pad = gmm(dh_g, w_gate, tile_groups, bm=bm, trans_rhs=True) + \
        gmm(dh_u, w_up, tile_groups, bm=bm, trans_rhs=True)       # [M, H]
    # d(dispatch): token t accumulates its k buffer rows, a gather; dropped
    # entries read the sentinel zero row
    dxf = take_sentinel_rows(dx_pad, pos).reshape(N, k, H).sum(dim=1)
    return (dxf.to(xf.dtype), dw_g.to(w_gate.dtype), dw_u.to(w_up.dtype),
            dw_d.to(w_down.dtype), d_gates.to(gates.dtype))


class _GroupedFFN(torch.autograd.Function):
    """Grouped-GEMM SwiGLU expert mixture over pre-sorted tokens, the
    counterpart of the reference's ``_grouped_ffn`` custom VJP.

    xf [N, H]; w_gate/w_up [E, H, I]; w_down [E, I, H]; gates [N, k] fp32
    combine weights; inv_flat/pos/tile_groups from
    :func:`~paddle_tpu_torch.kernels.grouped_matmul.sorted_dispatch_plan`.
    The forward saves ``h_g``, ``h_u`` and ``o`` (under remat the block is
    recomputed anyway; without it this saves three of the nine grouped
    products).  ``pos`` entries >= M are a dropped-entry sentinel: they give
    exactly zero output and gradient."""

    @staticmethod
    def forward(ctx, xf, w_gate, w_up, w_down, gates, inv_flat, pos,
                tile_groups, E, k, bm):
        y, h_g, h_u, o = _grouped_ffn_fwd(xf, w_gate, w_up, w_down, gates,
                                          inv_flat, pos, tile_groups, k, bm)
        ctx.save_for_backward(xf, w_gate, w_up, w_down, gates, inv_flat, pos,
                              tile_groups, h_g, h_u, o)
        ctx.E, ctx.k, ctx.bm = E, k, bm
        return y

    @staticmethod
    def backward(ctx, dy):
        grads = _grouped_ffn_bwd(dy.contiguous(), *ctx.saved_tensors,
                                 ctx.E, ctx.k, ctx.bm)
        return grads + (None,) * 6


# (xf, w_gate, w_up, w_down, gates, inv_flat, pos, tile_groups, E, k, bm)
_grouped_ffn = _GroupedFFN.apply


def moe_mlp_forward_grouped(x, gate_w, w_gate, w_up, w_down, *, top_k,
                            block_m=512):
    """Grouped-GEMM (megablocks-style) MoE: tokens are sorted by expert
    and each expert runs one ragged GEMM over exactly its own tokens — no
    capacity bound, nothing dropped.  Returns (y [B, S, H], aux loss,
    stats [kept_frac = 1, max load x E])."""
    B, S, H = x.shape
    E = gate_w.shape[-1]
    N = B * S
    xf = x.reshape(N, H)
    topv, topi, aux, ce = _route_topk(xf, gate_w, top_k)
    inv_flat, pos, tile_groups = sorted_dispatch_plan(
        topi.reshape(N * top_k), E, block_m)
    y = _grouped_ffn(xf, w_gate, w_up, w_down, topv, inv_flat, pos,
                     tile_groups, E, top_k, block_m)
    stats = torch.stack([torch.ones((), device=x.device), ce.max() * E])
    return y.reshape(B, S, H), aux, stats


def _swiglu_experts(expert_in, w_gate, w_up, w_down):
    """The expert banks' SwiGLU FFN over ``[E, rows, H]`` buffers."""
    h1 = F.silu(torch.einsum("erh,ehi->eri", expert_in, w_gate)) * \
        torch.einsum("erh,ehi->eri", expert_in, w_up)
    return torch.einsum("eri,eih->erh", h1, w_down)


def moe_mlp_forward(x, gate_w, w_gate, w_up, w_down, *, top_k,
                    capacity_factor):
    """Capacity-bounded top-k expert mixture, the reference's ``gather``
    form: each expert takes at most ``cap = max(1, int(N·k·cf/E))`` of the
    (token, choice) entries in k-major priority
    (:func:`~paddle_tpu_torch.kernels.grouped_matmul.capacity_dispatch_plan`),
    the kept rows are gathered into a static ``[E, cap, H]`` buffer, and
    the outputs are gathered back and combined with the gate weights;
    dropped entries add nothing.  ``cap`` comes from shapes alone, so no
    value is read back to the host.

    x: [B, S, H]; gate_w: [H, E]; w_gate/w_up: [E, H, I]; w_down: [E, I, H].
    Returns (y [B, S, H], aux loss, stats fp32 [kept_frac, imbalance]):
    the share of routed entries that fit their expert's capacity, and the
    busiest expert's first-choice share x E (1.0 = uniform)."""
    B, S, H = x.shape
    E = gate_w.shape[-1]
    N = B * S
    k = top_k
    xf = x.reshape(N, H)
    topv, topi, aux, ce = _route_topk(xf, gate_w, k)
    cap = max(1, int(N * k * capacity_factor / E))
    inv, slot, gate_keep, keep = capacity_dispatch_plan(topi, topv, E, cap)
    expert_in = take_sentinel_rows(xf, inv[:-1]).reshape(E, cap, H)
    out_e = _swiglu_experts(expert_in, w_gate, w_up,
                            w_down).reshape(E * cap, H)
    yf = take_sentinel_rows(out_e, slot) * gate_keep[:, None].to(x.dtype)
    y = yf.reshape(k, N, H).sum(dim=0).reshape(B, S, H)
    stats = torch.stack([keep.float().mean(), ce.max() * E])
    return y, aux, stats


def moe_mlp_forward_einsum(x, gate_w, w_gate, w_up, w_down, *, top_k,
                           capacity_factor, groups=0):
    """The reference's ``einsum`` form (GShard / t5x one-hot dispatch):
    dispatch and combine are contractions against a ``[G, n, E, cap]``
    combine tensor, with capacity per token group of ``n = N / G`` tokens
    (``groups`` 0 means the batch dim; G = 1 routes as
    :func:`moe_mlp_forward`).  Raises ``ValueError`` when G does not divide
    the token count.  Shapes and returns as :func:`moe_mlp_forward`."""
    B, S, H = x.shape
    E = gate_w.shape[-1]
    N = B * S
    k = top_k
    G = groups or B
    if N % G:
        raise ValueError(f"moe_groups ({G}) must divide tokens ({N})")
    n = N // G
    dev = x.device
    xg = x.reshape(G, n, H)
    # the router over the flat batch (routing is per token)
    topv, topi, aux, ce = _route_topk(x.reshape(N, H), gate_w, k)
    topv, topi = topv.reshape(G, n, k), topi.reshape(G, n, k)
    cap = max(1, int(n * k * capacity_factor / E))
    # k-major priority within each group: first choices claim slots first
    idx = topi.transpose(1, 2).reshape(G, k * n)
    gate_v = topv.transpose(1, 2).reshape(G, k * n).float()
    oh = (idx[..., None] == torch.arange(E, device=dev)).float()  # [G, kn, E]
    pos = ((torch.cumsum(oh, dim=1) * oh).sum(-1) - 1).long()
    keep = pos < cap
    pos_oh = (pos[..., None] == torch.arange(cap, device=dev)).float()
    # combine[g, n, e, c]: the gate weight where token n routes to (e, c),
    # built one choice at a time so the transient stays [G, n, E, cap]
    combine = torch.zeros((G, n, E, cap), dtype=torch.float32, device=dev)
    for kk in range(k):
        sl = slice(kk * n, (kk + 1) * n)
        w = (gate_v[:, sl] * keep[:, sl])[..., None, None]
        combine = combine + w * (oh[:, sl, :, None] * pos_oh[:, sl, None])
    dispatch = (combine > 0).to(x.dtype)
    expert_in = torch.einsum("gnec,gnh->egch", dispatch, xg)
    out_e = _swiglu_experts(expert_in.reshape(E, G * cap, H), w_gate, w_up,
                            w_down).reshape(E, G, cap, H)
    y = torch.einsum("gnec,egch->gnh", combine.to(x.dtype), out_e)
    stats = torch.stack([keep.sum().float() / (k * N), ce.max() * E])
    return y.reshape(B, S, H), aux, stats


class LlamaMoEMLP(nn.Module):
    """Mixtral-style MoE FFN block (drop-in for LlamaMLP when
    ``config.moe_num_experts > 0``), with the reference's parameter names
    and layouts: ``gate.weight`` [H, E], ``experts_gate``/``experts_up``
    [E, H, I], ``experts_down`` [E, I, H]."""

    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        c = config
        self.config = c
        E, H, I = c.moe_num_experts, c.hidden_size, c.intermediate_size
        self.gate = _ParamLinear(H, E, init)
        self.experts_gate = init.scaled((E, H, I), H)
        self.experts_up = init.scaled((E, H, I), H)
        self.experts_down = init.scaled((E, I, H), I)
        # the last forward's aux loss and [kept_frac, imbalance] (the
        # trainer reads them right after the call, as the reference does)
        self._last_aux = None
        self._last_stats = None

    def forward(self, x):
        c = self.config
        w = (x, self.gate.weight, self.experts_gate, self.experts_up,
             self.experts_down)
        if c.moe_dispatch == "einsum":
            y, aux, stats = moe_mlp_forward_einsum(
                *w, top_k=c.moe_top_k, capacity_factor=c.moe_capacity_factor,
                groups=c.moe_groups)
        elif c.moe_dispatch == "grouped":
            y, aux, stats = moe_mlp_forward_grouped(
                *w, top_k=c.moe_top_k, block_m=c.moe_block_m)
        else:
            y, aux, stats = moe_mlp_forward(
                *w, top_k=c.moe_top_k, capacity_factor=c.moe_capacity_factor)
        self._last_aux = aux
        self._last_stats = stats
        return y


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.self_attn = LlamaAttention(config, init)
        self.mlp = LlamaMoEMLP(config, init) if config.moe_num_experts \
            else LlamaMLP(config, init)
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
    """Llama (dense or MoE) with random init from ``seed`` on ``device``
    (default ``"cuda"``; raises without a GPU).  ``forward(input_ids
    [b, s])`` returns logits [b, s, vocab] (full-sequence causal attention:
    the flash-attention forward kernel on the card, its plain version on
    the CPU).  Its parameters do not require gradients; the trainer
    (:mod:`paddle_tpu_torch.models.pretrain`) keeps its own."""

    def __init__(self, config: LlamaConfig, *, device=None, seed: int = 0):
        super().__init__()
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
