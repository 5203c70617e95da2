"""Full-sequence attention, layout ``[b, s, h, d]`` (port of the plain
``_reference_attention`` of ``paddle_tpu/kernels/flash_attention.py``).

Only the plain version is ported in this slice: it backs the full-sequence
``LlamaForCausalLM.forward`` on CPU tensors (the tests' oracle).  The Hopper
flash-attention kernels (forward and backward) come with the training slice;
until then a CUDA tensor raises.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _reference_attention_lse(q, k, v, causal):
    qh = q.transpose(1, 2).float()                 # [b, h, sq, d]
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    group = qh.shape[1] // kh.shape[1]
    if group > 1:
        kh = kh.repeat_interleave(group, dim=1)
        vh = vh.repeat_interleave(group, dim=1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=q.device).tril(diagonal=sk - sq)
        scores = torch.where(cm, scores, torch.full_like(scores, NEG_INF))
    lse = torch.logsumexp(scores, dim=-1)          # [b, h, sq]
    probs = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2).to(q.dtype), lse


def _reference_attention(q, k, v, causal):
    return _reference_attention_lse(q, k, v, causal)[0]


def flash_attention(query, key, value, causal=False):
    """Attention over ``[b, s, h, d]`` tensors; GQA when key/value have fewer
    heads (a divisor of the query heads).

    CPU tensors take the plain version.  CUDA tensors raise: the Hopper
    flash kernel is not ported yet.
    """
    if query.device.type == "cpu":
        return _reference_attention(query, key, value, causal)
    raise NotImplementedError(
        "flash_attention on a CUDA tensor needs the Hopper flash-attention "
        "kernel (ROADMAP Queue 2 item 5, paddle_tpu/kernels/"
        "flash_attention.py:_fa_fwd_kernel); it is not ported yet")
