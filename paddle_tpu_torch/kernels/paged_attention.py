"""Ragged paged-KV attention — the serving hot op (port of
``paddle_tpu/kernels/paged_attention.py``).

One mixed-mode call serves prefill chunks and decode tokens: the query is
``[batch, T, q_heads, head_dim]`` with per-sequence ``q_lens`` raggedness,
each sequence attends its cached context (``context_lens`` tokens in pages of
a ``[kv_heads, num_pages, page_size, head_dim]`` pool, addressed by a block
table) and then this step's own fresh K/V rows under a causal mask.

- On a CUDA tensor the wrapper launches a hand-written Hopper kernel of
  ``csrc/ragged_paged_attention.cu`` (it replaces the Pallas
  ``_ragged_paged_attn_kernel``, float and int8 modes), on the route
  :func:`_route` picks from the query rows a kv-head carries, ``R = T ·
  (q_heads / kv_heads)``: ``"split"`` for R <= 16 (decode at every GQA
  group, speculative verify up to R 16: the context cut into whole-page
  splits by :func:`split_plan`, merged by their lse weights) or ``"tile"``
  (prefill chunks: one CTA per 16-row tile walks the whole context).
  Every call over a float pool adds one to :data:`LAUNCHES`, every call
  over an int8 pool one to :data:`LAUNCHES_INT8`, on either route; the
  calls that took the split route also to :data:`LAUNCHES_SPLIT` /
  :data:`LAUNCHES_INT8_SPLIT`.  Shapes the kernels do not take raise.
- On a CPU tensor it runs the plain PyTorch version
  (:func:`_reference_ragged_paged_attention`), the tests' oracle.

The pool dtype is independent of the model dtype: q and the fresh rows
are fp32 or bf16, the pool fp32, bf16 or int8.  An int8 pool carries one
fp32 scale per (kv-head, page) in ``k_scale``/``v_scale``; pages are
dequantized right after they are loaded.

``write_kv_pages`` / ``write_kv_pages_all_layers`` commit fresh rows into
a float pool in place (the reference's donated-buffer scatters);
``write_kv_pages_all_layers_quantized`` is the int8 pool's page-level
read-modify-write commit.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

# Launches of the CUDA kernel since import (or the last reset by a caller),
# over float pools and over int8 pools: a run shows it went through the
# kernel by reading these before and after.
LAUNCHES = 0
LAUNCHES_INT8 = 0
# the calls that took the "split" route (a part of the above)
LAUNCHES_SPLIT = 0
LAUNCHES_INT8_SPLIT = 0

_SUPPORTED_D = (64, 128)
_MAX_T = 128
_MAX_PAGE = 128
_MAX_GROUP = 8
_SPLIT_ROWS = 16          # the split route's query rows a kv-head, at most
_SPLIT_CTAS = 2 * 132     # the split plan's aim: two CTAs an H100 SM
_SPLIT_MIN_KEYS = 64      # context keys a split holds at least
_SPLIT_MAX = 64           # splits the merge kernel takes


# --------------------------------------------------------------- oracles ---

def _reference_paged_attention(q, k_cache, v_cache, block_tables,
                               context_lens, with_lse=False):
    """Plain version of the decode form.  q: [B, qh, d]."""
    out, lse = _reference_ragged_paged_attention(
        q[:, None], k_cache, v_cache, block_tables, context_lens)
    return (out[:, 0], lse[:, 0]) if with_lse else out[:, 0]


def _reference_ragged_paged_attention(q, k_cache, v_cache, block_tables,
                                      context_lens, q_lens=None, k_new=None,
                                      v_new=None, k_scale=None, v_scale=None):
    """Plain version of the mixed prefill+decode form: gather pages, masked
    softmax.  q: [B, T, qh, d]; k_new/v_new: [B, T, kvh, d].  Rows with
    token index >= q_lens[b] are don't-care (finite).  With
    ``k_scale``/``v_scale`` ([kvh, num_pages] fp32, an int8 pool) gathered
    pages are dequantized to fp32 before the math.  Returns
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
    k = k_cache[:, flat].float()                  # [kvh, B*W, page, d]
    v = v_cache[:, flat].float()
    if k_scale is not None:
        k = k * k_scale[:, flat].float()[..., None, None]
        v = v * v_scale[:, flat].float()[..., None, None]
    k = k.reshape(kvh, b, S, d)                   # [kvh, B, S, d]
    v = v.reshape(kvh, b, S, d)

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

# dtype codes of the C entry point: q / fresh rows / out, and the pool
_Q_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10

# C entry point -> argument types: (q, k_cache, v_cache, k_scale, v_scale,
# block_tables, context_lens, q_lens, k_new, v_new, out, lse, B, T, qh, kvh,
# head_dim, num_pages, page_size, W, q_dtype, kv_dtype, [splits,
# workspace,] stream)
ENTRY_POINTS = {
    "ptt_ragged_paged_attention": _ARGS + [ctypes.c_void_p],
    "ptt_ragged_paged_attention_split": _ARGS + [ctypes.c_int] +
    [ctypes.c_void_p] * 2,
}


def _kernel_fn(name="ptt_ragged_paged_attention"):
    from . import _build
    fn = getattr(_build.load("ragged_paged_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = ENTRY_POINTS[name]
        fn.restype = ctypes.c_int
    return fn


def _route(T, group):
    """The kernel for T query tokens of a GQA group: ``"split"`` when the
    ``T · group`` rows a kv-head carries fit the split kernel's 16 (decode,
    speculative verify), else ``"tile"`` (prefill chunks)."""
    return "split" if T * group <= _SPLIT_ROWS else "tile"


def split_plan(B, kvh, W, page_size):
    """The split route's split count, a function of the shapes alone (the
    context lengths stay on the device): about ``_SPLIT_CTAS`` CTAs over
    ``B · kvh · splits``, never more splits than the block table's ``W``
    pages fill at ``_SPLIT_MIN_KEYS`` keys a split, nor than the merge
    kernel's ``_SPLIT_MAX``.  The kernel cuts each sequence's live pages,
    read on the device, into that many runs of whole pages (split s of S:
    pages [n s / S, n (s + 1) / S))."""
    min_pages = -(-_SPLIT_MIN_KEYS // page_size)
    want = max(1, round(_SPLIT_CTAS / (B * kvh)))
    return max(1, min(want, -(-W // min_pages), _SPLIT_MAX))


def launch_plan(q, k_cache, block_tables):
    """A launch's route, split count and partials workspace (fp32
    elements), from the operands' shapes alone: no value is read, so the
    context lengths stay on the device (meta tensors plan as well)."""
    b, t, qh, d = q.shape
    kvh, _, page_size, _ = k_cache.shape
    if _route(t, qh // kvh) == "tile":
        return {"route": "tile", "splits": None, "workspace": 0}
    splits = split_plan(b, kvh, block_tables.shape[1], page_size)
    return {"route": "split", "splits": splits,
            "workspace": b * kvh * splits * _SPLIT_ROWS * (d + 2)
            if splits > 1 else 0}


def _check_cuda_args(q, k_cache, v_cache, block_tables, context_lens, q_lens,
                     k_new, v_new, k_scale, v_scale):
    dev = q.device
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_tables": block_tables, "context_lens": context_lens,
               "q_lens": q_lens, "k_new": k_new, "v_new": v_new,
               "k_scale": k_scale, "v_scale": v_scale}
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
    if q.dtype not in _Q_DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    for name in ("k_new", "v_new"):
        x = tensors[name]
        if x is not None and x.dtype != q.dtype:
            raise TypeError(f"{name} dtype {x.dtype} != q dtype {q.dtype}")
    if k_cache.dtype not in _KV_DTYPE_CODE or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"pool dtypes {k_cache.dtype}/{v_cache.dtype} not "
                        "supported (one of float32, bfloat16, int8 for both)")
    if (k_cache.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("k_scale/v_scale go with an int8 pool, and only "
                         "with one")
    if k_scale is not None:
        want = tuple(k_cache.shape[:2])
        for name in ("k_scale", "v_scale"):
            x = tensors[name]
            if x.dtype != torch.float32 or tuple(x.shape) != want:
                raise TypeError(f"{name} must be float32 {want}, got "
                                f"{x.dtype} {tuple(x.shape)}")
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
                                 context_lens, q_lens, k_new, v_new,
                                 k_scale, v_scale):
    """Launch the route's kernel(s) on the current stream."""
    global LAUNCHES, LAUNCHES_INT8, LAUNCHES_SPLIT, LAUNCHES_INT8_SPLIT
    _check_cuda_args(q, k_cache, v_cache, block_tables, context_lens, q_lens,
                     k_new, v_new, k_scale, v_scale)
    b, t, qh, d = q.shape
    kvh, n_pages, page_size, _ = k_cache.shape
    W = block_tables.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((b, t, qh), dtype=torch.float32, device=q.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = (ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scale), ptr(v_scale),
            ptr(block_tables), ptr(context_lens), ptr(q_lens), ptr(k_new),
            ptr(v_new), ptr(out), ptr(lse), b, t, qh, kvh, d, n_pages,
            page_size, W, _Q_DTYPE_CODE[q.dtype],
            _KV_DTYPE_CODE[k_cache.dtype])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    plan = launch_plan(q, k_cache, block_tables)
    split = plan["route"] == "split"
    if split:
        # the partials (m, l, acc[d]) of every split, merged after
        ws = torch.empty((plan["workspace"],), dtype=torch.float32,
                         device=q.device) if plan["workspace"] else None
        err = _kernel_fn("ptt_ragged_paged_attention_split")(
            *args, plan["splits"], ptr(ws), stream)
    else:
        err = _kernel_fn()(*args, stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    if k_scale is None:
        LAUNCHES += 1
        LAUNCHES_SPLIT += split
    else:
        LAUNCHES_INT8 += 1
        LAUNCHES_INT8_SPLIT += split
    return out, lse


# ----------------------------------------------------------- entry points ---

def ragged_paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                           *, q_lens=None, k_new=None, v_new=None,
                           k_scale=None, v_scale=None, with_lse=False):
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
      k_scale/v_scale: [num_kv_heads, num_pages] fp32 — per-(kv-head,
                    page) dequant scales of an int8 pool.
      with_lse:     also return the fp32 logsumexp [batch, T, q_heads].

    CUDA tensors launch a Hopper kernel (the route :func:`_route` picks);
    CPU tensors take the plain version.  Returns out [batch, T,
    num_q_heads, head_dim] (and lse).
    """
    qh, kvh = q.shape[2], k_cache.shape[0]
    if qh % kvh:
        raise ValueError(f"q heads ({qh}) must be a multiple of kv heads ({kvh})")
    if (k_new is None) != (v_new is None):
        raise ValueError("k_new and v_new must be given together")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if q.device.type == "cuda":
        out, lse = _cuda_ragged_paged_attention(
            q, k_cache, v_cache, block_tables, context_lens, q_lens, k_new,
            v_new, k_scale, v_scale)
    elif q.device.type == "cpu":
        out, lse = _reference_ragged_paged_attention(
            q, k_cache, v_cache, block_tables, context_lens, q_lens, k_new,
            v_new, k_scale, v_scale)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return (out, lse) if with_lse else out


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    with_lse=False, k_scale=None, v_scale=None):
    """Single-token decode attention over a paged KV cache: the T=1,
    no-fresh-rows form of :func:`ragged_paged_attention`.
    q: [batch, num_q_heads, head_dim]."""
    res = ragged_paged_attention(q[:, None].contiguous(), k_cache, v_cache,
                                 block_tables, context_lens,
                                 k_scale=k_scale, v_scale=v_scale,
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


def _requantize_pages(flat, fresh, lslot, new_scale_shape):
    """Shared K/V half of the quantized commit: insert fresh fp32 rows into
    the dequantized gathered pages, recompute each page's absmax scale,
    requantize.  ``flat``: [L, kvh, G*page, d] fp32 (G gathered pages);
    ``lslot`` [n] window-local row of each fresh row, ``G*page`` = drop.
    Returns (int8 pages [L, kvh, G, page, d], scales [L, kvh, G])."""
    L, kvh, _, d = flat.shape
    G, page = new_scale_shape
    # one extra row takes the dropped entries (mode="drop" in the reference)
    flat = torch.cat([flat, flat.new_zeros((L, kvh, 1, d))], dim=2)
    flat.index_copy_(2, lslot, fresh)
    pages = flat[:, :, :G * page].reshape(L, kvh, G, page, d)
    amax = pages.abs().amax(dim=(3, 4))                      # [L, kvh, G]
    # amax/127 as a multiply by the fp32 reciprocal: the reference's XLA
    # lowers its division by the constant that way, so scales match bitwise
    scales = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(pages / scales[..., None, None]),
                    -127.0, 127.0).to(torch.int8)
    return q, scales


def write_kv_pages_all_layers_quantized(k_cache, v_cache, k_scale, v_scale,
                                        k_all, v_all, positions, q_lens,
                                        block_tables, max_len):
    """The int8 pool's batched all-layer commit, in place: quantize fresh
    K/V per page on the way in (one fp32 absmax scale per (layer, kv-head,
    page)).

    The scale is page-granular, so the commit is a page-level
    read-modify-write over at most ``Pmax`` pages per row: gather the pages
    this step's tokens land in, dequantize with the old scales, zero the
    rows past the sequence's post-step extent (a recycled page may hold a
    previous occupant's bytes, which must not inflate the new scale),
    insert the fresh fp32 rows, recompute each page's absmax scale
    (amax/127, or 1.0 for an all-zero page), round half to even, clip to
    ±127 and write pages and scales back.  Rows never share a write page.

    The LAST physical page of every plane is a scratch page that the
    allocator never hands out: untouched window entries write there (the
    reference drops them with ``mode="drop"``), so no real page is ever
    rewritten by a dropped entry and nothing syncs with the host.

    k_cache/v_cache: [L, kvh, num_pages + 1, page, d] int8;
    k_scale/v_scale: [L, kvh, num_pages + 1] fp32; k_all/v_all:
    [L, B*T, kvh, d] fresh rows; positions/q_lens: [B] (write cursor /
    valid tokens per row); block_tables: [B, W].  Returns the four planes.
    """
    L, kvh, P, page, d = k_cache.shape
    B, W = block_tables.shape
    T = k_all.shape[1] // B
    dev = k_cache.device
    scratch = P - 1
    # a T-token run starting anywhere in a page straddles at most Pmax
    # pages; gathering exactly that window keeps the RMW O(B * Pmax)
    Pmax = 1 + (max(T - 1, 0) + page - 1) // page

    i64 = torch.int64
    pos0 = positions.to(i64)
    ql = q_lens.to(i64)
    offs = torch.arange(T, dtype=i64, device=dev)
    pos = pos0[:, None] + offs[None, :]                            # [B, T]
    pos_c = torch.clamp(pos, max=max_len - 1)
    valid = (offs[None, :] < ql[:, None]) & (pos < max_len)        # [B, T]
    start = torch.clamp(pos0, max=max_len - 1)
    first = start // page                                          # [B]

    # touched pages per row: page-list indices [first, first + npg)
    ntok = valid.to(i64).sum(dim=1)                                # [B]
    npg = torch.where(ntok > 0, (start % page + ntok + page - 1) // page,
                      torch.zeros_like(ntok))
    j = torch.arange(Pmax, dtype=i64, device=dev)
    touched = j[None, :] < npg[:, None]                            # [B, Pmax]
    plist = torch.clamp(first[:, None] + j[None, :], max=W - 1)
    page_ids = torch.gather(block_tables.to(i64), 1, plist)        # [B, Pmax]
    flat_pid = torch.where(touched, page_ids.clamp(0, scratch - 1),
                           torch.full_like(page_ids, scratch)).reshape(-1)

    # live-extent mask: row r of window page j holds a valid token iff its
    # position is below the sequence's post-step extent
    r = torch.arange(page, dtype=i64, device=dev)
    gpos = ((first[:, None] + j[None, :]) * page)[:, :, None] + \
        r[None, None, :]                                       # [B, Pmax, page]
    live = (gpos < (pos0 + ntok)[:, None, None]).reshape(
        1, 1, B * Pmax * page, 1).to(torch.float32)

    # fresh rows land at window-local slots (invalid tokens -> drop row)
    b_ix = torch.arange(B, dtype=i64, device=dev)[:, None]
    rel = pos_c // page - first[:, None]                           # [B, T]
    lslot = torch.where(valid, (b_ix * Pmax + rel) * page + pos_c % page,
                        torch.full_like(pos_c, B * Pmax * page)).reshape(B * T)

    for cache, scale, rows in ((k_cache, k_scale, k_all),
                               (v_cache, v_scale, v_all)):
        g = cache[:, :, flat_pid].to(torch.float32) * \
            scale[:, :, flat_pid][..., None, None]       # [L, kvh, B*Pmax, page, d]
        g = g.reshape(L, kvh, B * Pmax * page, d) * live
        fresh = rows.transpose(1, 2).to(torch.float32)  # [L, kvh, B*T, d]
        qp, sc = _requantize_pages(g, fresh, lslot, (B * Pmax, page))
        cache.index_copy_(2, flat_pid, qp)
        scale.index_copy_(2, flat_pid, sc)
    return k_cache, v_cache, k_scale, v_scale
