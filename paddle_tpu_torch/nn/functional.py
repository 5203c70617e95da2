"""The attention ops of ``paddle_tpu.nn.functional`` (its
``scaled_dot_product_attention``, ``flash_attention``,
``flash_attn_qkvpacked`` and ``flash_attn_varlen_qkvpacked``), on
``[batch, seq, heads, head_dim]`` tensors.

The flash ops go through :mod:`paddle_tpu_torch.kernels.flash_attention`:
CUDA tensors launch its Hopper kernels, CPU tensors take their plain
versions.  :func:`scaled_dot_product_attention` has no kernel in the
reference (it is the XLA path) and is plain PyTorch here on either device.
Dropout draws one seed per call from the default generator of the
tensors' device; given the seed, the dropped positions equal the
reference's bit for bit.  Nothing else of ``nn.functional`` is ported yet.
"""

from __future__ import annotations

import math

import torch

from ..kernels import flash_attention as _fa


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, training=True,
                                 name=None):
    """Attention with the reference's own masking (``nn/functional.py``
    :777): scores in the inputs' dtype, a bool ``attn_mask`` selects (False
    -> -1e9) and any other is added, ``is_causal`` masks above the top-left
    diagonal with -1e9, and dropout, when ``training``, drops probabilities
    with the flash kernels' keep-mask."""
    qh, kh, vh = (x.transpose(1, 2) for x in (query, key, value))
    scale = 1.0 / math.sqrt(query.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, -1e9)
        else:
            scores = scores + attn_mask
    if is_causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=scores.device).tril()
        scores = torch.where(causal, scores, -1e9)
    probs = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0 and training:
        seed = _fa._draw_seed(query.device)
        keep = _fa._drop_keep_dense(probs.shape, seed, float(dropout_p),
                                    probs.device)
        probs = torch.where(keep, probs, 0.0) * (1.0 / (1.0 - dropout_p))
    dt = torch.promote_types(probs.dtype, vh.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(dt), vh.to(dt))
    return out.transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """Flash attention (``nn/functional.py`` :827): ``(out, None)``, or
    ``out`` alone when ``return_softmax is None``, as the reference
    returns."""
    out = _fa.flash_attention(query, key, value, causal=causal,
                              dropout=dropout, training=training)
    return (out, None) if return_softmax is not None else out


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         fixed_seed_offset=None, rng_name="", training=True,
                         name=None):
    """Flash attention over a packed ``[b, s, 3, h, d]`` input
    (``nn/functional.py`` :2373); returns ``(out, None)``."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, softmax = flash_attention(q, k, v, dropout=dropout, causal=causal,
                                   training=training)
    return out, softmax


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None):
    """Varlen attention over a packed ``[total, 3, h, d]`` input
    (``nn/functional.py`` :2384); ``dropout``, ``scale`` and
    ``max_seqlen_*`` are ignored, as in the reference.  Returns
    ``(out, None)``."""
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    out = _fa.flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                causal=causal)
    return out, None


__all__ = ["flash_attention", "flash_attn_qkvpacked",
           "flash_attn_varlen_qkvpacked", "scaled_dot_product_attention"]
