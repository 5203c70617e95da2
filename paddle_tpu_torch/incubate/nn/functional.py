"""The fused functional API (the port of
``paddle_tpu/incubate/nn/functional.py``): ``fused_rms_norm``,
``fused_layer_norm``, ``swiglu``, ``fused_rotary_position_embedding``,
``fused_bias_act``, ``fused_linear``, ``fused_linear_activation``,
``fused_dropout_add``, ``decode_attention`` (``block_multihead_attention``),
``masked_multihead_attention``, ``number_count``, ``fused_moe`` and the
re-exported ``flash_attention``.

Two of them reach Hopper kernels, as the reference's reach Pallas:

- :func:`decode_attention` calls
  :func:`paddle_tpu_torch.kernels.paged_attention.paged_attention`: a CUDA
  tensor launches the ragged paged-attention kernel (decode takes its
  "split" route), a CPU tensor takes its plain version; shapes the kernel
  refuses raise.
- ``flash_attention`` is :func:`paddle_tpu_torch.kernels.flash_attention.
  flash_attention`.

The rest is XLA in the reference and plain PyTorch here, with the
reference's arithmetic: ``fused_bias_act``'s GELU is the tanh
approximation (``jax.nn.gelu``'s default) and any ``act_method`` other than
``gelu`` / ``geglu`` / ``swiglu`` is ReLU; ``fused_linear_activation``
ignores ``trans_x``; ``fused_moe`` sums its experts in order 0 .. E-1 in
the input's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...kernels.flash_attention import flash_attention  # noqa: F401
from ...kernels.paged_attention import paged_attention
from ...kernels.rms_norm import rms_norm_fp32
from ...nn import functional as F
from ...ops.math import add


def _on(x, device):
    """``x`` as a tensor on ``device`` (numpy arrays and lists too)."""
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x),
                                                        device=device)


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kw):
    """RMSNorm with fp32 accumulation over the axes from
    ``begin_norm_axis`` on (the last one by default), in x's dtype."""
    ndim = x.dim()
    dims = tuple(range(begin_norm_axis % ndim, ndim)) \
        if begin_norm_axis != -1 else (-1,)
    return rms_norm_fp32(x, norm_weight, epsilon, bias=norm_bias, dim=dims)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5, **kw):
    return F.layer_norm(x, x.shape[-1:], weight=norm_weight, bias=norm_bias,
                        epsilon=epsilon)


def swiglu(x, y=None):
    """``silu(x) * y``, or with one operand ``silu(a) * b`` of its two
    halves along the last axis."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return TF.silu(x) * y


def _rope_table(t, d, style):
    """A cos or sin table ``[1, s, 1, d]``, ``[s, d]`` or ``[s, d/2]`` as
    ``[s, d/2]``: a full-width table gives its front half (neox) or its even
    columns (interleaved)."""
    if t.dim() == 4:
        t = t[0, :, 0, :]
    if t.shape[-1] == d:
        t = t[..., :d // 2] if style == "front" else t[..., ::2]
    return t


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """Rotary embedding of ``q`` (and ``k``, ``v`` where given), each ``[b,
    s, h, d]``; returns the three (None where not given), in their dtypes.

    ``use_neox_rotary_style`` rotates the two halves of d, else interleaved
    pairs.  ``sin``/``cos``: ``[1, s, 1, d]``, ``[s, d]`` or ``[s, d/2]``
    tables; without them the tables are the reference's (theta 10000, fp32,
    ``models.llama._rope_cos_sin``).  ``position_ids`` ``[b, s]`` picks each
    row's positions from the tables."""
    from ...models.llama import _rope_cos_sin

    d, seq = q.shape[-1], q.shape[1]
    if sin is None or cos is None:
        c_t, s_t = _rope_cos_sin(seq, d, 10000.0, torch.float32,
                                 device=q.device)
    else:
        style = "front" if use_neox_rotary_style else "interleaved"
        c_t = _rope_table(_on(cos, q.device), d, style)
        s_t = _rope_table(_on(sin, q.device), d, style)
    if position_ids is not None:
        pos = _on(position_ids, q.device).long()
        c, s = c_t[pos][:, :, None, :], s_t[pos][:, :, None, :]
    else:
        c, s = c_t[None, :, None, :], s_t[None, :, None, :]

    def rotate(a):
        if use_neox_rotary_style:
            x1, x2 = a.chunk(2, dim=-1)
            return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                             dim=-1).to(a.dtype)
        x1, x2 = a[..., 0::2], a[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                           dim=-1).reshape(a.shape).to(a.dtype)

    return tuple(None if t is None else rotate(t) for t in (q, k, v))


def fused_bias_act(x, bias=None, act_method="gelu", **kw):
    """``act(x + bias)``: ``gelu`` (tanh approximation), ``geglu`` /
    ``swiglu`` (the gate is the first half of the last axis), and ReLU for
    any other ``act_method``, as the reference maps it."""
    if bias is not None:
        x = x + bias
    if act_method == "gelu":
        return TF.gelu(x, approximate="tanh")
    if act_method in ("geglu", "swiglu"):
        a, b = x.chunk(2, dim=-1)
        gate = TF.gelu(a, approximate="tanh") if act_method == "geglu" \
            else TF.silu(a)
        return gate * b
    return torch.relu(x)


def fused_linear(x, weight, bias=None, transpose_weight=False):
    return F.linear(x, weight.t() if transpose_weight else weight, bias)


def fused_linear_activation(x, y, bias=None, trans_x=False, trans_y=False,
                            activation="gelu"):
    """``fused_bias_act(x @ y + bias, activation)``; ``trans_x`` is
    ignored, as the reference ignores it."""
    out = F.linear(x, y.t() if trans_y else y, bias)
    return fused_bias_act(out, act_method=activation)


def fused_dropout_add(x, y, p=0.0, training=True, mode="upscale_in_train"):
    return add(F.dropout(x, p=p, training=training, mode=mode), y)


def decode_attention(q, k_cache, v_cache, block_tables, context_lens):
    """Single-token decode attention over a paged KV cache: ``q`` ``[B, qh,
    d]``, pools ``[kvh, pages, page, d]``, ``block_tables`` ``[B,
    max_pages]``, ``context_lens`` ``[B]`` (the step's own K/V written to
    the pool first and counted).  The block tables and lengths are cast to
    int32 on q's device (no host read).  A CUDA ``q`` launches the paged
    attention kernel ("split" route), a CPU one takes its plain version."""
    bt, cl = (_on(t, q.device).to(device=q.device, dtype=torch.int32)
              .contiguous() for t in (block_tables, context_lens))
    return paged_attention(q, k_cache, v_cache, bt, cl)


block_multihead_attention = decode_attention


def masked_multihead_attention(x, cache_kv, seq_lens, **kw):
    """Single-token decode attention over a dense cache.

    ``x`` ``[B, 3 * heads * d]`` packs the token's q, k and v; ``cache_kv``
    ``[2, B, heads, max_seq, d]``; ``seq_lens`` ``[B]`` tokens already
    cached.  The token's k and v go to position ``seq_lens`` of a copy of
    the cache, and q attends over positions ``0 ..  seq_lens`` in fp32.
    Returns ``(out [B, heads * d] in x's dtype, the updated cache)``; the
    input cache is not written."""
    _, _, heads, S, d = cache_kv.shape
    B = x.shape[0]
    qkv = x.reshape(B, 3, heads, d)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    lens = _on(seq_lens, x.device).long()
    bidx = torch.arange(B, device=x.device)
    cache = cache_kv.clone()
    cache[0, bidx, :, lens] = k.to(cache.dtype)
    cache[1, bidx, :, lens] = v.to(cache.dtype)
    kc, vc = cache[0].float(), cache[1].float()
    s = torch.einsum("bhd,bhsd->bhs", q.float(), kc) / math.sqrt(d)
    live = torch.arange(S, device=x.device)[None, None, :] <= \
        lens[:, None, None]
    p = torch.softmax(torch.where(live, s, -1e30), dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, vc)
    return out.reshape(B, heads * d).to(x.dtype), cache


def number_count(numbers, upper_range):
    """int64 counts of each id in ``[0, upper_range)``; as the reference's
    ``bincount``, a negative id counts as 0 and an id past the range is
    dropped."""
    ids = _on(numbers, None).reshape(-1).long().clamp_min(0)
    keep = ids < upper_range
    counts = torch.zeros(upper_range, dtype=torch.int64, device=ids.device)
    return counts.scatter_add_(0, ids.clamp_max(upper_range - 1),
                               keep.long())


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn1_scale=None, ffn2_bias=None, ffn2_scale=None,
              quant_method="None", moe_topk=2, norm_topk_prob=True):
    """Inference MoE FFN as a dense mixture: every expert runs over every
    token and the outputs combine by the top-k gate weights.

    ``x`` ``[B, S, H]``; ``gate_weight`` ``[H, E]``; ``ffn1_weight`` ``[E,
    H, 2I]`` packs the SwiGLU's [gate | up]; ``ffn2_weight`` ``[E, I, H]``;
    biases ``[E, 1, 2I]`` / ``[E, 1, H]``.  Routing is fp32 softmax then
    top-k (renormalised when ``norm_topk_prob``); the combine weights are
    rounded to x's dtype and the experts summed in order 0 .. E-1 in that
    dtype, one expert's ``[N, 2I]`` transient at a time.  Quantized
    weights (``quant_method``, ``ffn*_scale``) raise, as in the
    reference."""
    if quant_method != "None" or ffn1_scale is not None \
            or ffn2_scale is not None:
        raise NotImplementedError(
            "fused_moe quantization (quant_method/ffn*_scale) is not "
            "supported; use quantization.weight_quantize + the weight-only "
            "matmul kernel instead")
    B, S, H = x.shape
    half = ffn1_weight.shape[-1] // 2
    xf = x.reshape(-1, H)
    probs = torch.softmax(xf.float() @ gate_weight.float(), dim=-1)
    topv, topi = torch.topk(probs, moe_topk, dim=-1)
    if norm_topk_prob:
        topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    comb = torch.zeros_like(probs).scatter_(1, topi, topv).t().to(x.dtype)
    y = torch.zeros_like(xf)
    for e in range(ffn1_weight.shape[0]):
        h1 = xf @ ffn1_weight[e]
        if ffn1_bias is not None:
            h1 = h1 + ffn1_bias[e][0]
        o = (TF.silu(h1[..., :half]) * h1[..., half:]) @ ffn2_weight[e]
        if ffn2_bias is not None:
            o = o + ffn2_bias[e][0]
        y = y + comb[e][:, None] * o
    return y.reshape(B, S, H)


__all__ = ["block_multihead_attention", "decode_attention",
           "flash_attention", "fused_bias_act", "fused_dropout_add",
           "fused_layer_norm", "fused_linear", "fused_linear_activation",
           "fused_moe", "fused_rms_norm", "fused_rotary_position_embedding",
           "masked_multihead_attention", "number_count", "swiglu"]

from ...core.tensor import boundary_module  # noqa: E402

boundary_module(globals(), __all__)
