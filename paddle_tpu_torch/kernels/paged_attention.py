"""Ragged paged-KV attention — the serving hot op (port of
``paddle_tpu/kernels/paged_attention.py``).

One mixed-mode call serves prefill chunks and decode tokens: the query is
``[batch, T, q_heads, head_dim]`` with per-sequence ``q_lens`` raggedness,
each sequence attends its cached context (``context_lens`` tokens in pages of
a ``[kv_heads, num_pages, page_size, head_dim]`` pool, addressed by a block
table) and then this step's own fresh K/V rows under a causal mask.

- On a CUDA tensor the wrapper launches the hand-written Hopper kernel
  ``csrc/ragged_paged_attention.cu`` (it replaces the Pallas
  ``_ragged_paged_attn_kernel``); every launch adds one to
  :data:`LAUNCHES`.  Shapes the kernel does not take raise.
- On a CPU tensor it runs the plain PyTorch version
  (:func:`_reference_ragged_paged_attention`), the tests' oracle.

The int8 pool mode (``k_scale``/``v_scale``) is not ported yet.

``write_kv_pages`` / ``write_kv_pages_all_layers`` commit fresh rows into
the pool in place (the reference's donated-buffer scatters).
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

# Launches of the CUDA kernel since import (or the last reset by a caller):
# a run shows it went through the kernel by reading this before and after.
LAUNCHES = 0

_SUPPORTED_D = (64, 128)
_MAX_T = 128
_MAX_PAGE = 128
_MAX_GROUP = 8


# --------------------------------------------------------------- oracles ---

def _reference_paged_attention(q, k_cache, v_cache, block_tables,
                               context_lens, with_lse=False):
    """Plain version of the decode form.  q: [B, qh, d]."""
    out, lse = _reference_ragged_paged_attention(
        q[:, None], k_cache, v_cache, block_tables, context_lens)
    return (out[:, 0], lse[:, 0]) if with_lse else out[:, 0]


def _reference_ragged_paged_attention(q, k_cache, v_cache, block_tables,
                                      context_lens, q_lens=None, k_new=None,
                                      v_new=None):
    """Plain version of the mixed prefill+decode form: gather pages, masked
    softmax.  q: [B, T, qh, d]; k_new/v_new: [B, T, kvh, d].  Rows with
    token index >= q_lens[b] are don't-care (finite).  Returns
    (out [B, T, qh, d] in q.dtype, lse [B, T, qh] fp32)."""
    b, t, qh, d = q.shape
    kvh, n_pages, page_size, _ = k_cache.shape
    group = qh // kvh
    max_pages = block_tables.shape[1]
    S = max_pages * page_size
    scale = 1.0 / math.sqrt(d)

    # table entries past the context are garbage: clamp so the gather stays
    # in bounds (the mask below drops them)
    flat = block_tables.reshape(-1).long().clamp(0, n_pages - 1)
    k = k_cache[:, flat].reshape(kvh, b, S, d).float()   # [kvh, B, S, d]
    v = v_cache[:, flat].reshape(kvh, b, S, d).float()

    qg = q.reshape(b, t, kvh, group, d).float()
    s = torch.einsum("btkgd,kbsd->btkgs", qg, k) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < context_lens.to(q.device)[:, None]        # [B, S]
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    parts_s, parts_v = [s], [v]
    if k_new is not None:
        kn = k_new.movedim(2, 0).float()                     # [kvh, B, T, d]
        vn = v_new.movedim(2, 0).float()
        s2 = torch.einsum("btkgd,kbjd->btkgj", qg, kn) * scale
        jq = torch.arange(t, device=q.device)
        ql = (q_lens if q_lens is not None
              else torch.full((b,), t, device=q.device)).to(q.device)
        causal = jq[None, :, None] >= jq[None, None, :]           # [1, T, T]
        valid = causal & (jq[None, None, :] < ql[:, None, None])
        s2 = torch.where(valid[:, :, None, None, :], s2,
                         torch.full_like(s2, NEG_INF))
        parts_s.append(s2)
        parts_v.append(vn)
    s_all = torch.cat(parts_s, dim=-1)
    p = torch.softmax(s_all, dim=-1)
    v_all = torch.cat(parts_v, dim=2)                         # [kvh, B, *, d]
    out = torch.einsum("btkgs,kbsd->btkgd", p, v_all)
    out = out.reshape(b, t, qh, d).to(q.dtype)
    lse = torch.logsumexp(s_all, dim=-1).reshape(b, t, qh)
    return out, lse


# ---------------------------------------------------------------- kernel ---

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel_fn():
    from . import _build
    fn = _build.load("ragged_paged_attention").ptt_ragged_paged_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_args(q, k_cache, v_cache, block_tables, context_lens, q_lens,
                     k_new, v_new):
    dev = q.device
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_tables": block_tables, "context_lens": context_lens,
               "q_lens": q_lens, "k_new": k_new, "v_new": v_new}
    for name, x in tensors.items():
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(
            "the ragged paged-attention kernel is built for sm_90a (H100/"
            f"H200); this card is sm_{''.join(map(str, torch.cuda.get_device_capability(dev)))}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    for name in ("k_cache", "v_cache", "k_new", "v_new"):
        x = tensors[name]
        if x is not None and x.dtype != q.dtype:
            raise TypeError(f"{name} dtype {x.dtype} != q dtype {q.dtype}")
    for name in ("block_tables", "context_lens", "q_lens"):
        x = tensors[name]
        if x is not None and x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    b, t, qh, d = q.shape
    kvh, _, page_size, dk = k_cache.shape
    if v_cache.shape != k_cache.shape or dk != d:
        raise ValueError("k_cache/v_cache must be [kvh, num_pages, page, d] "
                         "with q's head_dim")
    if d not in _SUPPORTED_D:
        raise ValueError(f"head_dim {d} not supported (64 or 128)")
    if page_size % 8 or not 8 <= page_size <= _MAX_PAGE:
        raise ValueError(f"page_size {page_size} must be a multiple of 8 "
                         f"up to {_MAX_PAGE}")
    if not 1 <= qh // kvh <= _MAX_GROUP:
        raise ValueError(f"GQA group {qh // kvh} not in 1..{_MAX_GROUP}")
    if not 1 <= t <= _MAX_T:
        raise ValueError(f"T={t} not in 1..{_MAX_T}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or \
            context_lens.shape != (b,) or \
            (q_lens is not None and q_lens.shape != (b,)):
        raise ValueError("block_tables must be [B, W]; context_lens and "
                         "q_lens [B]")
    if k_new is not None and k_new.shape != (b, t, kvh, d):
        raise ValueError(f"k_new must be {(b, t, kvh, d)}, got "
                         f"{tuple(k_new.shape)}")
    if k_new is not None and v_new.shape != k_new.shape:
        raise ValueError("v_new must match k_new's shape")


def _cuda_ragged_paged_attention(q, k_cache, v_cache, block_tables,
                                 context_lens, q_lens, k_new, v_new):
    """Launch the Hopper kernel on the current stream."""
    global LAUNCHES
    _check_cuda_args(q, k_cache, v_cache, block_tables, context_lens, q_lens,
                     k_new, v_new)
    b, t, qh, d = q.shape
    kvh, n_pages, page_size, _ = k_cache.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, t, qh), dtype=torch.float32, device=q.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = _kernel_fn()(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(block_tables),
        ptr(context_lens), ptr(q_lens), ptr(k_new), ptr(v_new), ptr(out),
        ptr(lse), b, t, qh, kvh, d, n_pages, page_size,
        block_tables.shape[1], _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out, lse


# ----------------------------------------------------------- entry points ---

def ragged_paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                           *, q_lens=None, k_new=None, v_new=None,
                           with_lse=False):
    """Mixed-mode serving attention: prefill chunks and decode tokens in one
    call over a paged KV cache.

    Args:
      q:            [batch, T, num_q_heads, head_dim].
      k_cache:      [num_kv_heads, num_pages, page_size, head_dim].
      v_cache:      same shape as k_cache.
      block_tables: [batch, max_pages_per_seq] int32 page ids.
      context_lens: [batch] int32 — tokens ALREADY in the cache (this step's
                    own tokens are NOT included).
      q_lens:       [batch] int32 — valid query tokens per sequence (None =
                    all T).  Output rows past q_lens[b] are don't-care.
      k_new/v_new:  [batch, T, num_kv_heads, head_dim] — the step's fresh
                    KV rows, folded in with a causal mask (token j attends
                    new tokens <= j).  Commit them after the call.
      with_lse:     also return the fp32 logsumexp [batch, T, q_heads].

    CUDA tensors launch the Hopper kernel; CPU tensors take the plain
    version.  Returns out [batch, T, num_q_heads, head_dim] (and lse).
    """
    qh, kvh = q.shape[2], k_cache.shape[0]
    if qh % kvh:
        raise ValueError(f"q heads ({qh}) must be a multiple of kv heads ({kvh})")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new must be given together")
    if q.device.type == "cuda":
        out, lse = _cuda_ragged_paged_attention(
            q, k_cache, v_cache, block_tables, context_lens, q_lens, k_new,
            v_new)
    elif q.device.type == "cpu":
        out, lse = _reference_ragged_paged_attention(
            q, k_cache, v_cache, block_tables, context_lens, q_lens, k_new,
            v_new)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return (out, lse) if with_lse else out


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    with_lse=False):
    """Single-token decode attention over a paged KV cache: the T=1,
    no-fresh-rows form of :func:`ragged_paged_attention`.
    q: [batch, num_q_heads, head_dim]."""
    res = ragged_paged_attention(q[:, None].contiguous(), k_cache, v_cache,
                                 block_tables, context_lens,
                                 with_lse=with_lse)
    if with_lse:
        out, lse = res
        return out[:, 0], lse[:, 0]
    return res[:, 0]


# ----------------------------------------------------------- cache writes ---

def _scatter_rows(flat, slots, rows):
    """In place: ``flat[..., slots[i], :] = rows[..., i, :]``, with slots of
    -1 dropped and no host sync.  A dropped token is redirected to repeat
    the write of the first kept token (same slot, same row), or, when none
    is kept, to rewrite slot 0 with its current value — duplicate indices
    then carry identical values, so the scatter stays deterministic."""
    slots = slots.to(device=flat.device, dtype=torch.long)
    keep = slots >= 0
    any_keep = keep.any()
    first = keep.to(torch.int8).argmax()
    fill_slot = torch.where(any_keep, slots[first], torch.zeros_like(slots[0]))
    target = torch.where(keep, slots, fill_slot)
    fill_row = torch.where(any_keep, rows[..., first, :], flat[..., 0, :])
    rows = torch.where(keep[:, None], rows, fill_row[..., None, :])
    flat.index_copy_(flat.dim() - 2, target, rows)


def write_kv_pages(k_cache, v_cache, k_new, v_new, slot_mapping):
    """Scatter new KV rows into the paged cache, in place.

    k_cache/v_cache: [kv_heads, num_pages, page_size, head_dim];
    k_new/v_new: [n_tokens, kv_heads, head_dim]; slot_mapping: [n_tokens]
    flat slots (page_id * page_size + offset; -1 = drop the token).
    Returns the (updated) caches.
    """
    kvh, n_pages, page_size, d = k_cache.shape
    flat_k = k_cache.view(kvh, n_pages * page_size, d)
    flat_v = v_cache.view(kvh, n_pages * page_size, d)
    _scatter_rows(flat_k, slot_mapping, k_new.transpose(0, 1).to(k_cache.dtype))
    _scatter_rows(flat_v, slot_mapping, v_new.transpose(0, 1).to(v_cache.dtype))
    return k_cache, v_cache


def write_kv_pages_all_layers(k_cache, v_cache, k_all, v_all, slot_mapping):
    """One in-place scatter committing every layer's new KV rows.

    k_cache/v_cache: [layers, kv_heads, num_pages, page_size, head_dim];
    k_all/v_all: [layers, n_tokens, kv_heads, head_dim]; slot_mapping:
    [n_tokens] (-1 = drop).  Attention reads the pre-step cache; this
    commit runs once at the end of the step.  Returns the caches.
    """
    L, kvh, n_pages, page_size, d = k_cache.shape
    flat_k = k_cache.view(L, kvh, n_pages * page_size, d)
    flat_v = v_cache.view(L, kvh, n_pages * page_size, d)
    _scatter_rows(flat_k, slot_mapping, k_all.transpose(1, 2).to(k_cache.dtype))
    _scatter_rows(flat_v, slot_mapping, v_all.transpose(1, 2).to(v_cache.dtype))
    return k_cache, v_cache
