"""Autoregressive generation over a paged KV cache — the serving decode loop
(port of ``paddle_tpu/inference/generation.py``).

- ``LlamaGenerator._step_fn`` is the one fused engine step: derive write
  slots from the block table, run every layer through the mixed-mode
  ``ragged_paged_attention`` kernel (the step's own K/V rows fold in with a
  causal mask), commit all layers' fresh KV in ONE in-place scatter at the
  end (attention reads the pre-step pool), then sample.  T=1 is pure
  decode; T=prefill_bucket is a chunked-prefill / mixed step.
- The pool is float (fp32/bf16, any model dtype) or int8 with per-(layer,
  kv-head, page) scales: pages dequantize inside the attention kernel and
  the commit requantizes per page, so both modes share the step.
- MoE models route every layer's FFN through :func:`_moe_ffn`: the
  expert-sorted grouped-matmul kernel for ``moe_dispatch="grouped"``, a
  plain loop over experts otherwise.
- EOS / budget / capacity tracking stays on the device (``finished``,
  ``counts``, ``budgets``): a step enqueues work and returns without reading
  anything back; the host drains results every ``sync_every`` steps.  Small
  per-step host inputs go up through pinned buffers with
  ``non_blocking=True``.
- The engine's optional serving features, each off by default: the prefix
  cache (``prefix_cache=``: radix-shared KV pages, copy-on-write, LRU
  eviction), speculative decoding (``spec_decode="ngram"``: the T=K verify
  step, ``_spec_verify_fn``; ``"fused"``: K decode steps per dispatch,
  ``_fused_decode_fn``) and the pinned host spill tier under the prefix
  cache (``kv_spill_pages=``).  Every pool write (step commit, COW page
  copy, swap-in) is enqueued on the one current stream, whose order is the
  only ordering they rely on.

- Telemetry (``metrics=``, default ``FLAGS_metrics``): per-request
  lifecycle timestamps, the ``serving.*`` registry series and the
  per-phase step attribution (``observability/``).  A step stamps host
  timestamps and appends to lists; TTFT, ITL and queue wait are folded from
  those stamps at the drain, so telemetry reads no device tensor.  Session
  migration (``inference/migration.py``) exports and imports an engine's
  sessions between steps.

- Tensor-parallel serving (``tensor_parallel=``, default
  ``FLAGS_serving_tensor_parallel``): ONE engine drives a list of shard
  devices (``device="cuda"``: shard i on ``cuda:i``; ``"cpu"``; or a list,
  repeats allowed, so ``["cuda:0", "cuda:0"]`` runs tp=2 on one card).
  Only the KV pool's storage (by kv head), attention (by kv head) and
  grouped MoE (by expert) are sharded; the weights, projections, norms,
  embedding and sampling stay on shard 0's device and run once there.
  Each shard's ``ragged_paged_attention`` launch plans its split from the
  global kv-head count, the shards' outputs join on the head axis in
  shard order and the expert partials sum left to right in shard order,
  so every token is bit-identical to tp=1.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import DEFAULT_DEVICE, flags, resolve_device
from .. import observability as _obs
from ..kernels.grouped_matmul import sorted_dispatch_plan
from ..kernels.paged_attention import (ragged_paged_attention,
                                       write_kv_pages_all_layers,
                                       write_kv_pages_all_layers_quantized)
from ..kernels.rms_norm import rms_norm_fp32
from ..models.llama import (LlamaForCausalLM, _grouped_ffn, _rope_cos_sin,
                            _route_topk)
from ..utils import extract_params
from . import speculative as _sp
from .kv_cache import PagedKVCache
from .kv_spill import HostSpillPool
from .prefix_cache import PrefixCache


def _cow_copy_pages(shards, src, dst):
    """Whole-page copies ``src[i] -> dst[i]`` across every layer and head
    of every pool plane of every shard (the prefix cache's copy-on-write),
    in place.  ``shards`` holds one pool tuple a shard: ``(k, v)`` float or
    ``(k, v, k_scale, v_scale)`` int8; each plane indexes pages on axis 2,
    so one loop copies them all.  ``src``/``dst``: int64 index tensors on
    shard 0's device, holding live pairs only (the caller drops the no-op
    ones on the host: on the int8 pool index ``num_pages`` is the commit's
    scratch page, not an out-of-range id)."""
    for planes in shards:
        dev = planes[0].device
        s, d = (src.to(dev, non_blocking=True),
                dst.to(dev, non_blocking=True))
        for arr in planes:
            arr.index_copy_(2, d, arr.index_select(2, s))


def shard_devices(device, tp: int) -> List[torch.device]:
    """The device of each of ``tp`` shards: a list of ``tp`` devices places
    shard i on entry i (repeats allowed); ``"cpu"`` puts every shard on the
    CPU; ``"cuda"`` (the default) puts shard i on ``cuda:i``.  Anything
    else raises: no other device or degree is ever chosen."""
    if isinstance(device, (list, tuple)):
        if len(device) != tp:
            raise ValueError(f"tensor_parallel={tp} needs {tp} devices, "
                             f"the list names {len(device)}")
        return [resolve_device(d) for d in device]
    if tp == 1:
        return [resolve_device(device)]
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cpu":
        return [dev] * tp
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if have < tp:
            raise ValueError(f"tensor_parallel={tp} needs {tp} devices, "
                             f"have {have}")
        return [resolve_device(f"cuda:{i}") for i in range(tp)]
    raise ValueError(f"tensor_parallel={tp} takes its devices as 'cuda', "
                     f"'cpu' or a list of {tp} devices, not {device!r}")


@dataclass
class GenerationConfig:
    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0        # 1.0 = disabled
    eos_token_id: Optional[int] = None
    seed: int = 0


def _rope_bt(x, cos, sin):
    """Rotary embedding with per-(row, token) tables.
    x: [B, T, h, d]; cos/sin: [B, T, d/2] (fp32)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(x.dtype)


def _moe_ffn(y, lp, top_k, dispatch="dense", block_m=128, banks=None):
    """Routed SwiGLU expert mixture for the serving path.

    - grouped (``dispatch="grouped"``): the expert-sorted grouped-matmul
      path (``models.llama._grouped_ffn``) — each expert runs over exactly
      its own rows.  Serves prefill chunks AND decode steps: the row tile
      shrinks to the 8-row multiple that covers the actual (token, choice)
      entry count, so a decode batch does not pay a full ``block_m`` of
      padding per expert.
    - dense (non-grouped configs): every expert runs over all rows in a
      plain loop, combined with the top-k gate weights — exact routing, no
      capacity.

    ``banks`` (tensor-parallel serving, grouped only): one ``(device,
    w_gate, w_up, w_down)`` a shard, its ``E / tp`` experts on its device.
    Each shard runs the grouped path over its own bank: non-owned (token,
    choice) entries go to a local discard group whose rows the combine's
    sentinel read returns as zero, and the partial outputs are summed left
    to right in shard order on ``y``'s device.  Bit-identical to the
    single-device mixture: a token has at most ``top_k`` nonzero expert
    terms, every other shard adds an exact zero, and IEEE addition of two
    values is order-insensitive (sharding is only enabled for top_k <= 2).
    """
    gw = lp["mlp.gate.weight"]              # [H, E]
    shape = y.shape
    xf = y.reshape(-1, shape[-1])
    E = gw.shape[-1]
    wg, wu, wd = (lp["mlp.experts_gate"], lp["mlp.experts_up"],
                  lp["mlp.experts_down"])
    if dispatch == "grouped":
        N = xf.shape[0]
        bm = max(8, min(block_m, -(-N * top_k // 8) * 8))
        topv, topi, _, _ = _route_topk(xf, gw, top_k)
        if banks is not None:
            return _moe_ffn_sharded(xf, topv, topi, banks, top_k,
                                    bm).reshape(shape)
        inv, pos, tg = sorted_dispatch_plan(topi.reshape(N * top_k), E, bm)
        out = _grouped_ffn(xf, wg, wu, wd, topv, inv, pos, tg, E, top_k, bm)
        return out.reshape(shape)
    probs = torch.softmax(xf.float() @ gw.float(), dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    comb = torch.zeros_like(probs).scatter_(1, topi, topv).to(xf.dtype)
    acc = torch.zeros_like(xf)
    for e in range(E):
        h = F.silu(xf @ wg[e]) * (xf @ wu[e])
        acc = acc + comb[:, e, None] * (h @ wd[e])
    return acc.reshape(shape)


def _moe_ffn_sharded(xf, topv, topi, banks, top_k, bm):
    """The expert-sharded grouped mixture (see :func:`_moe_ffn`): ``bm``
    comes from the global row count, so every shard's grouped matmuls tile
    as tp=1's do."""
    N = xf.shape[0]
    F = N * top_k
    dev0 = xf.device
    out = None
    for s, (dev, wg, wu, wd) in enumerate(banks):
        E_loc = wg.shape[0]
        x_s, v_s, i_s = (t.to(dev, non_blocking=True) for t in
                         (xf, topv, topi))
        own = torch.div(i_s, E_loc, rounding_mode="floor") == s
        # non-owned entries dispatch to local expert E_loc: a discard group
        # appended to the shard's bank purely as a sort destination
        local_e = torch.where(own, i_s % E_loc,
                              torch.full_like(i_s, E_loc)).reshape(F)
        inv, pos, tg = sorted_dispatch_plan(local_e, E_loc + 1, bm)
        M = inv.shape[0]
        own_flat = own.reshape(F)
        inv = torch.where(
            (inv < F) & own_flat[torch.clamp(inv, max=F - 1).long()],
            inv, torch.full_like(inv, F))
        keep = (pos < M) & own_flat
        gates = v_s * keep.reshape(N, top_k)
        pos = torch.where(keep, pos, torch.full_like(pos, M))
        tg = torch.clamp(tg, max=E_loc - 1)
        part = _grouped_ffn(x_s, wg, wu, wd, gates, inv, pos, tg, E_loc,
                            top_k, bm).to(dev0, non_blocking=True)
        # left to right in shard order: never an unordered reduction
        out = part if out is None else out + part
    return out


def _filter_logits(logits, gc: GenerationConfig):
    """Temperature / top-k / top-p logit filtering ([N, V] fp32)."""
    logits = logits / max(gc.temperature, 1e-6)
    neg_inf = torch.full_like(logits, -float("inf"))
    if gc.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -gc.top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if gc.top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # keep the smallest prefix with mass >= top_p (always >= 1 token)
        cutoff_idx = torch.sum(cum < gc.top_p, dim=-1)
        cutoff = torch.gather(sorted_l, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit integer hash (xor-shift-multiply) of int64 tensors holding
    values in [0, 2**32); multipliers stay below 2**31 so no product
    leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _uniform(seed: int, pos, n: int):
    """[N, n] uniforms in (0, 1), a pure function of (seed, pos[i], j)."""
    s = _mix32(seed & _M32)
    h = _mix32((pos.to(torch.int64) & _M32) ^ s)                     # [N]
    j = torch.arange(n, dtype=torch.int64, device=pos.device)
    h = _mix32(((h[:, None] * 0x01000193) + j[None, :]) & _M32)
    h = _mix32(h ^ s)
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _sample(logits, seed: int, pos, gc: GenerationConfig):
    """logits: [N, V] fp32, pos: [N] → [N] int32.

    Sampling is positional: row n draws from a counter-based generator
    keyed on (seed, pos[n]), where pos is the sequence index of the token
    being sampled — a draw depends only on (seed, position, logits), never
    on batch composition or step count.  It is the Gumbel-max form of a
    categorical draw.  Greedy takes the first maximum."""
    if not gc.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _filter_logits(logits, gc)
    u = _uniform(seed, pos, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


class LlamaGenerator:
    """Batch text generation for ``LlamaForCausalLM`` with paged KV, on
    ``device`` (default ``"cuda"``; the model must already live on shard
    0's device).  ``tensor_parallel`` (default
    ``FLAGS_serving_tensor_parallel``) shards the pool, attention and
    grouped MoE over the devices :func:`shard_devices` names."""

    def __init__(self, model: LlamaForCausalLM, *, max_batch: int = 8,
                 max_seq_len: Optional[int] = None, page_size: int = 32,
                 cache_dtype: Optional[str] = None,
                 prefill_bucket: int = 64, sync_every: int = 8,
                 num_pages: Optional[int] = None, device=None,
                 tensor_parallel: Optional[int] = None):
        c = model.config
        if tensor_parallel is None:
            tensor_parallel = int(flags.flag("serving_tensor_parallel") or 1)
        tp = max(int(tensor_parallel), 1)
        devs = shard_devices(device, tp)
        if tp > 1 and (c.num_key_value_heads % tp or
                       c.num_attention_heads % tp):
            raise ValueError(
                f"tensor_parallel={tp} must divide num_kv_heads="
                f"{c.num_key_value_heads} and num_heads="
                f"{c.num_attention_heads}")
        dev = devs[0]
        if model.device != dev:
            raise ValueError(f"the model lives on {model.device}, but the "
                             f"generator was asked for {dev}")
        self.device = dev
        self.devices = devs
        self.tp = tp
        # grouped MoE shards by expert only where the discard-group combine
        # is bit-exact (top_k <= 2: at most two nonzero terms a token) and
        # the bank divides; otherwise the mixture runs whole on shard 0
        self._moe_shards = tp if (
            tp > 1 and c.moe_num_experts and c.moe_dispatch == "grouped"
            and c.moe_top_k <= 2 and c.moe_num_experts % tp == 0) else None
        self.config = c
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len or c.max_position_embeddings
        if cache_dtype is None:
            fd = flags.flag("kv_cache_dtype")
            cache_dtype = None if fd == "auto" else fd
        cache_dtype = {"fp32": "float32", "bf16": "bfloat16"}.get(
            cache_dtype, cache_dtype)
        self.page_size = int(page_size)
        self.prefill_bucket = min(prefill_bucket, self.max_seq_len)
        self.sync_every = sync_every
        self.pages_per_seq = -(-self.max_seq_len // self.page_size)

        self.params = self._extract(model)
        # the pool may be smaller than the dense worst case: sequences share
        # it through the allocator; the engine finalizes a sequence early
        # when its growth finds the pool dry
        self.num_pages = num_pages or max_batch * self.pages_per_seq
        self.cache = PagedKVCache(
            num_layers=c.num_hidden_layers, num_pages=self.num_pages,
            page_size=self.page_size, num_kv_heads=c.num_key_value_heads,
            head_dim=c.head_dim, dtype=cache_dtype or c.dtype, devices=devs)
        # host-global pool bytes (all shards): what stats() and /statusz
        # advertise to the router's capacity-weighted placement
        self.pool_bytes = self.num_pages * PagedKVCache.bytes_per_page(
            c.num_hidden_layers, c.num_key_value_heads, self.page_size,
            c.head_dim, cache_dtype or c.dtype)
        self.shard_pool_bytes = self.pool_bytes // tp
        if self._moe_shards:
            # each shard's own slice of every layer's expert bank on its
            # device (a view where the device is shard 0's)
            E_loc = c.moe_num_experts // tp
            self._banks = [
                [(d,) + tuple(lp[n][s * E_loc:(s + 1) * E_loc].to(d)
                              for n in ("mlp.experts_gate", "mlp.experts_up",
                                        "mlp.experts_down"))
                 for s, d in enumerate(devs)]
                for lp in self.params["blocks"]]
        else:
            self._banks = [None] * len(self.params["blocks"])
        self._cos, self._sin = _rope_cos_sin(self.max_seq_len, c.head_dim,
                                             c.rope_theta, device=dev)
        self._metrics_on = _obs.metrics_enabled()
        if self._metrics_on:
            _obs.metrics.gauge("serving.tp.degree").set(tp)
            _obs.metrics.gauge("serving.tp.shard_pool_bytes").set(
                self.shard_pool_bytes)

    # ---- params ----
    def _extract(self, model: LlamaForCausalLM):
        """Views of the model's weights (no copies): per-layer dicts stand in
        for the reference's stacked scan operands."""
        embed = model.llama.embed_tokens.weight
        head = model.lm_head.weight if model.lm_head is not None else embed.T
        return {"embed": embed, "head": head,
                "norm": model.llama.norm.weight,
                "blocks": [extract_params(l) for l in model.llama.layers]}

    def upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without stalling the host: a pinned
        staging copy and a non-blocking transfer on CUDA (the caching host
        allocator keeps the staging buffer alive until the copy ran); a
        plain copy on the CPU (the host array is mutated later)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    # ---- the shared transformer core of every serving step ----
    def _forward_tokens(self, params, tokens, ql, positions, block_tables):
        """Run the whole model over this step's query tokens and commit all
        layers' fresh KV in one in-place commit; returns the final-norm
        hidden states for all T positions.

        tokens: [B, T] int32; ql: [B] valid tokens per row (0 = inert row);
        positions: [B] cache tokens BEFORE this step (the write cursor);
        block_tables: [B, W] int32.  The pool is ``self.cache.shards``: one
        (kc, vc) float, or (kc, vc, ks, vs) int8, plane tuple a shard,
        whose pages dequantize inside the attention kernel and whose commit
        requantizes per page.

        Under tensor parallelism shard s attends with q heads ``[s·qh/tp,
        (s+1)·qh/tp)`` over its own kv heads ``[s·kvh/tp, (s+1)·kvh/tp)``
        (q heads group per kv head, so that block is exactly the q heads
        that read them); the shards' outputs join on the head axis in shard
        order, the layout tp=1 computes, and feed the replicated
        ``o_proj``.  Each launch plans from the global kv-head count, so a
        shard's split route cuts the context as tp=1's does.
        """
        c = self.config
        B, T = tokens.shape
        page = self.page_size
        dev = tokens.device
        shards = self.cache.shards
        tp = self.tp

        offs = torch.arange(T, dtype=torch.int32, device=dev)
        pos = positions[:, None] + offs[None, :]                  # [B, T]
        pos_c = torch.clamp(pos, max=self.max_seq_len - 1)
        page_ids = torch.gather(block_tables, 1, (pos_c // page).long())
        valid = (offs[None, :] < ql[:, None]) & (pos < self.max_seq_len)
        slots = torch.where(valid, page_ids * page + pos_c % page,
                            torch.full_like(page_ids, -1)).reshape(B * T)

        cos = self._cos[pos_c.long()]                            # [B, T, d/2]
        sin = self._sin[pos_c.long()]
        ctx_prev = torch.clamp(positions, max=self.max_seq_len).to(torch.int32)
        ql = ql.to(torch.int32)
        # the step's small per-row inputs, once on each shard's device
        ins = [(block_tables, ctx_prev, ql, positions, slots)]
        if tp > 1:
            ins = [tuple(t.to(d, non_blocking=True) for t in ins[0])
                   for d in self.devices]
        toks = torch.clamp(tokens, 0, params["embed"].shape[0] - 1).long()
        h = params["embed"][toks]                                 # [B, T, H]

        qh, kvh, dh = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        qh_l, kvh_l = qh // tp, kvh // tp
        k_rows, v_rows = [], []
        for li, lp in enumerate(params["blocks"]):
            y = rms_norm_fp32(h, lp["input_layernorm.weight"], c.rms_norm_eps)
            q = (y @ lp["self_attn.q_proj.weight"]).reshape(B, T, qh, dh)
            k = (y @ lp["self_attn.k_proj.weight"]).reshape(B, T, kvh, dh)
            v = (y @ lp["self_attn.v_proj.weight"]).reshape(B, T, kvh, dh)
            q = _rope_bt(q, cos, sin)
            k = _rope_bt(k, cos, sin)
            # prior context from the pool + this step's own rows (causal),
            # one mixed-mode kernel call a shard; the commit follows all
            # layers
            if tp == 1:
                attn = self._attend(shards[0], li, q, k, v, ins[0])
            else:
                # one copy a tensor lays the head blocks out shard-major,
                # so shard s's block is a contiguous [s] view
                qkv = tuple(
                    x.reshape(B, T, tp, n, dh).permute(2, 0, 1, 3, 4)
                    .contiguous() for x, n in ((q, qh_l), (k, kvh_l),
                                               (v, kvh_l)))
                attn = torch.cat([
                    self._attend(planes, li, *(x[s].to(d, non_blocking=True)
                                               for x in qkv), ins[s])
                    .to(dev, non_blocking=True)
                    for s, (planes, d) in enumerate(zip(shards,
                                                        self.devices))],
                    dim=2)
            h = h + attn.reshape(B, T, -1) @ lp["self_attn.o_proj.weight"]
            y = rms_norm_fp32(h, lp["post_attention_layernorm.weight"],
                              c.rms_norm_eps)
            if "mlp.experts_gate" in lp:              # MoE model serving
                h = h + _moe_ffn(y, lp, c.moe_top_k, dispatch=c.moe_dispatch,
                                 block_m=c.moe_block_m,
                                 banks=self._banks[li])
            else:
                act = F.silu(y @ lp["mlp.gate_proj.weight"]) * \
                    (y @ lp["mlp.up_proj.weight"])
                h = h + act @ lp["mlp.down_proj.weight"]
            k_rows.append(k)
            v_rows.append(v)

        L = len(k_rows)
        k_all = torch.stack(k_rows).reshape(L, B * T, kvh, dh)
        v_all = torch.stack(v_rows).reshape(L, B * T, kvh, dh)
        # each shard commits its own heads' fresh rows to its planes; the
        # int8 scales are per (layer, kv head, page), so every shard's equal
        # tp=1's bit for bit
        if tp == 1:
            self._commit(shards[0], k_all, v_all, ins[0])
        else:
            for s, planes in enumerate(shards):
                d, blk = self.devices[s], self.cache.heads(s)
                self._commit(planes,
                             k_all[:, :, blk].to(d, non_blocking=True),
                             v_all[:, :, blk].to(d, non_blocking=True),
                             ins[s])
        return rms_norm_fp32(h, params["norm"], c.rms_norm_eps)

    def _attend(self, planes, li, q, k, v, ins):
        """One shard's attention at layer ``li``: its q heads and fresh
        k/v rows over its pool planes, planned from the global kv-head
        count; ``ins`` is the step's per-row inputs on its device."""
        bt, ctx_prev, ql = ins[:3]
        quant = len(planes) == 4
        return ragged_paged_attention(
            q, planes[0][li], planes[1][li], bt, ctx_prev, q_lens=ql,
            k_new=k, v_new=v, k_scale=planes[2][li] if quant else None,
            v_scale=planes[3][li] if quant else None,
            plan_kv_heads=self.config.num_key_value_heads)

    def _commit(self, planes, k_all, v_all, ins):
        """Write one shard's fresh K/V rows of every layer into its pool
        planes (the int8 pool quantizes them per page on the way in: a
        page-level RMW whose absmax scale covers every row of the page)."""
        bt, _ctx, ql, positions, slots = ins
        if len(planes) == 4:
            write_kv_pages_all_layers_quantized(
                *planes, k_all, v_all, positions, ql, bt, self.max_seq_len)
        else:
            write_kv_pages_all_layers(*planes, k_all, v_all, slots)

    # ---- the ONE engine step ----
    @torch.no_grad()
    def _step_fn(self, gc, T, tokens, q_lens, positions, finished,
                 decode_mask, commit_mask, counts, budgets, block_tables,
                 recent=None):
        """One fused serving step: attention over every layer → one batched
        KV commit → sample.  All arguments are device tensors ([B] or
        [B, T]); nothing is read back to the host.

        tokens: [B, T] this step's query tokens (decode rows use column 0);
        q_lens: [B] valid tokens per row; positions: [B] write cursor;
        decode_mask: [B] rows whose column-0 token is generated output;
        commit_mask: [B] rows whose sample is a real generated token;
        recent: [B, nmax] the n-gram drafter's ring of last committed
        tokens (ngram spec engines only), appended to on every committing
        row so the verify step's context is exact across prefill and mixed
        steps.
        Returns (out_tokens, new_positions, finished, all_done, counts) and,
        with ``recent``, the updated ring last.
        """
        B = tokens.shape[0]
        if gc.eos_token_id is not None:
            finished = finished | (decode_mask & (tokens[:, 0] == gc.eos_token_id))
        # a sequence that filled the cache freezes (no slot rewrite)
        finished = finished | (positions >= self.max_seq_len)
        ql = torch.where(finished, torch.zeros_like(q_lens), q_lens)

        h = self._forward_tokens(self.params, tokens, ql, positions,
                                 block_tables)
        rows = torch.arange(B, device=tokens.device)
        last_ix = torch.clamp(ql - 1, min=0).long()
        logits = (h[rows, last_ix] @ self.params["head"]).float()
        # positional sampling keys: the sampled token lands at sequence
        # index positions + ql
        sampled = _sample(logits, gc.seed, positions + ql, gc)
        last_in = tokens[rows, last_ix]
        out_tokens = torch.where(finished, last_in, sampled)
        new_positions = torch.where(
            finished, positions,
            torch.clamp(positions + ql, max=self.max_seq_len))
        committed = commit_mask & ~finished
        counts = counts + committed.to(torch.int32)
        finished = finished | (counts >= budgets)
        out = (out_tokens, new_positions, finished, finished.all(), counts)
        if recent is not None:
            recent = _sp.shift_append(recent, out_tokens[:, None],
                                      committed.to(torch.int32))
            return out + (recent,)
        return out

    # ---- the T=K speculative verify step (ngram mode) ----
    @torch.no_grad()
    def _spec_verify_fn(self, gc, K, nmax, last_tok, recent, hist, hist_len,
                        positions, finished, counts, budgets, write_caps,
                        block_tables):
        """One speculative decode step: draft K-1 tokens on the device from
        the history table, verify all of them in ONE mixed-mode T=K forward
        (one attention launch per layer), commit the longest accepted
        prefix plus the bonus token, and roll back the rest, all on the
        device.

        Rollback is positional: rejected rows' KV was written but
        ``positions`` only advances by the commit count, so the kernel
        (which masks by context length) never reads a stale row and the
        cursor overwrites it in place later.  ``write_caps`` [B] is the
        tokens each row's block table covers: a row never writes past it.

        Returns (sampled [B,K], n_commit [B], drafted [B], last_tok,
        positions, finished, all_done, counts, recent).
        """
        if gc.eos_token_id is not None:
            # EOS on the chained input token: the final prompt chunk's
            # sample is checked here as the plain step checks column 0
            finished = finished | (last_tok == gc.eos_token_id)
        finished = finished | (positions >= self.max_seq_len)
        drafts, draft_len = _sp.lookup_drafts(hist, hist_len, recent, K, nmax)
        cap_room = torch.clamp(write_caps - positions, min=0)
        ql = torch.where(finished, torch.zeros_like(draft_len),
                         torch.minimum(1 + draft_len, cap_room)
                         ).to(torch.int32)
        drafted = torch.clamp(ql - 1, min=0)      # drafts actually verified
        tokens = torch.cat([last_tok[:, None], drafts], dim=1)

        h = self._forward_tokens(self.params, tokens, ql, positions,
                                 block_tables)
        B = tokens.shape[0]
        logits = (h @ self.params["head"]).float()               # [B, K, V]
        # slot j samples the token at sequence index positions + j + 1
        pos_k = positions[:, None] + torch.arange(
            1, K + 1, dtype=torch.int32, device=positions.device)[None, :]
        sampled = _sample(logits.reshape(B * K, -1), gc.seed,
                          pos_k.reshape(B * K), gc).reshape(B, K)

        n_commit = _sp.accept_length(tokens, sampled, ql)
        if gc.eos_token_id is not None:
            n_commit, hit_eos = _sp.eos_clamp(sampled, n_commit,
                                              gc.eos_token_id)
            finished = finished | hit_eos
        n_commit = torch.minimum(n_commit, torch.clamp(budgets - counts,
                                                       min=0))
        n_commit = torch.minimum(
            n_commit, torch.clamp(self.max_seq_len - positions, min=0)
        ).to(torch.int32)
        counts = counts + n_commit
        finished = finished | (counts >= budgets)
        positions = positions + n_commit
        finished = finished | (positions >= self.max_seq_len)

        picked = torch.gather(
            sampled, 1, torch.clamp(n_commit - 1, min=0)[:, None].long())[:, 0]
        last_tok = torch.where(n_commit > 0, picked, last_tok)
        recent = _sp.shift_append(recent, sampled, n_commit)
        return (sampled, n_commit, drafted, last_tok, positions, finished,
                finished.all(), counts, recent)

    # ---- fused K-steps-per-dispatch decode (fused mode) ----
    @torch.no_grad()
    def _fused_decode_fn(self, gc, K, last_tok, positions, finished, counts,
                         budgets, write_caps, block_tables):
        """K sequential T=1 decode steps in ONE engine dispatch: every token
        is committed, so this amortizes the host's per-step work.  Each
        step replays the plain step's freezes (input EOS, capacity, budget),
        so the committed tokens are a prefix of the [B, K] output and greedy
        outputs equal the sequential engine's.

        Returns (out [B,K], n_commit [B], last_tok, positions, finished,
        all_done, counts).
        """
        outs, n_commit = [], None
        tok = last_tok
        for _ in range(K):
            if gc.eos_token_id is not None:
                finished = finished | (tok == gc.eos_token_id)
            finished = finished | (positions >= self.max_seq_len)
            # a row whose block table ran out of grown pages stalls; it
            # resumes next dispatch once the host grew or reclaimed pages
            ql = torch.where(finished | (positions >= write_caps),
                             torch.zeros_like(positions),
                             torch.ones_like(positions)).to(torch.int32)
            h = self._forward_tokens(self.params, tok[:, None], ql,
                                     positions, block_tables)
            logits = (h[:, 0] @ self.params["head"]).float()
            sampled = _sample(logits, gc.seed, positions + ql, gc)
            out = torch.where(ql > 0, sampled, tok)
            positions = positions + ql
            counts = counts + ql
            finished = finished | (counts >= budgets)
            outs.append(out)
            n_commit = ql if n_commit is None else n_commit + ql
            tok = out
        return (torch.stack(outs, dim=1), n_commit, tok, positions, finished,
                finished.all(), counts)

    # ---- host loop ----
    def generate(self, prompts: Sequence[Sequence[int]],
                 gen: Optional[GenerationConfig] = None) -> List[List[int]]:
        """prompts: per-sequence token-id lists → generated ids (no prompt)."""
        gen = gen or GenerationConfig()
        B = len(prompts)
        MB = self.max_batch
        if B > MB:
            raise ValueError(f"batch {B} > max_batch {MB}")
        dev = self.device
        alloc = self.cache.allocator
        lens = np.asarray([len(p) for p in prompts], np.int32)
        seq_ids = list(range(B))
        for i, p in enumerate(prompts):
            alloc.allocate(seq_ids[i], len(p))
        bt_width = self.pages_per_seq
        bt = np.zeros((MB, bt_width), np.int32)
        bt[:B] = alloc.block_table(seq_ids, max_pages=bt_width)
        bt_dev = self.upload(bt)

        i32 = torch.int32
        positions = torch.zeros((MB,), dtype=i32, device=dev)
        finished = self.upload(np.arange(MB) >= B)        # pad rows inert
        counts = torch.zeros((MB,), dtype=i32, device=dev)
        budgets_np = np.zeros((MB,), np.int32)
        budgets_np[:B] = gen.max_new_tokens
        budgets = self.upload(budgets_np)
        no_mask = torch.zeros((MB,), dtype=torch.bool, device=dev)
        all_mask = torch.ones((MB,), dtype=torch.bool, device=dev)
        first = torch.zeros((MB,), dtype=i32, device=dev)

        # chunked prefill: prompts stream through the step in T-sized chunks
        T = self.prefill_bucket
        n_chunks = max(1, -(-int(lens.max()) // T))
        for ci in range(n_chunks):
            s0 = ci * T
            chunk = np.zeros((MB, T), np.int32)
            ql = np.zeros((MB,), np.int32)
            for i, p in enumerate(prompts):
                n = min(max(len(p) - s0, 0), T)
                ql[i] = n
                if n:
                    chunk[i, :n] = np.asarray(p[s0:s0 + n], np.int32)
            commit = np.zeros((MB,), bool)
            commit[:B] = (lens > s0) & (lens <= s0 + T)   # prompt ends here
            commit_dev = self.upload(commit)
            out, positions, finished, _ad, counts = self._step_fn(
                gen, T, self.upload(chunk), self.upload(ql), positions,
                finished, no_mask, commit_dev, counts, budgets, bt_dev)
            first = torch.where(commit_dev, out, first)

        # device-resident decode loop (no host reads between drains)
        ql1 = torch.ones((MB,), dtype=i32, device=dev)
        tokens = first
        collected = [first]
        host_lens = lens.copy()
        steps_until_sync = self.sync_every
        for _ in range(gen.max_new_tokens - 1):
            if int(np.min(host_lens)) >= self.max_seq_len:
                break                        # every sequence is at capacity
            grew = False
            for i in range(B):
                if host_lens[i] < self.max_seq_len and \
                        host_lens[i] % self.page_size == 0 and \
                        alloc.context_len(seq_ids[i]) <= host_lens[i]:
                    alloc.extend(seq_ids[i],
                                 min(self.page_size,
                                     self.max_seq_len - host_lens[i]))
                    grew = True
            if grew:
                bt[:B] = alloc.block_table(seq_ids, max_pages=bt_width)
                bt_dev = self.upload(bt)

            tokens, positions, finished, all_done, counts = self._step_fn(
                gen, 1, tokens[:, None], ql1, positions, finished, all_mask,
                all_mask, counts, budgets, bt_dev)
            collected.append(tokens)
            host_lens = np.minimum(host_lens + 1, self.max_seq_len)

            steps_until_sync -= 1
            if gen.eos_token_id is not None and steps_until_sync <= 0:
                steps_until_sync = self.sync_every
                if self._metrics_on:
                    _obs.count_sync()
                if bool(all_done):           # single scalar sync at a drain
                    break

        for s in seq_ids:
            alloc.free(s)

        if self._metrics_on:
            _obs.count_sync()                # one bulk transfer
        mat = torch.stack(collected, dim=1).cpu().numpy()    # [MB, steps]
        out: List[List[int]] = []
        for i in range(B):
            row = mat[i].tolist()
            if gen.eos_token_id is not None and gen.eos_token_id in row:
                row = row[:row.index(gen.eos_token_id) + 1]
            limit = self.max_seq_len - int(lens[i])
            out.append(row[:max(1, limit)])
        return out


def generate(model: LlamaForCausalLM, prompts,
             gen: Optional[GenerationConfig] = None, **kw) -> List[List[int]]:
    """One-shot convenience: build a generator sized to the request."""
    gen = gen or GenerationConfig()
    max_len = max(len(p) for p in prompts) + gen.max_new_tokens
    g = LlamaGenerator(model, max_batch=len(prompts),
                       max_seq_len=min(max(64, max_len),
                                       model.config.max_position_embeddings),
                       **kw)
    return g.generate(prompts, gen)


class Request:
    """One in-flight generation request of the continuous-batching engine.
    ``output`` grows at the engine's drains; ``done`` flips at retirement.

    Lifecycle timestamps (host ``perf_counter``, stamped only with metrics
    on): ``t_enqueue`` at submit, ``t_admit`` at admission, ``t_first`` /
    ``t_last`` from the dispatch stamps of the steps that committed the
    first / latest token, folded in at the drain.  ``trace_id`` is the
    caller's trace context (the HTTP front door's response id): the
    request's lifecycle spans ride a trace lane named after it."""

    __slots__ = ("req_id", "prompt", "max_new_tokens", "output", "done",
                 "t_enqueue", "t_admit", "t_first", "t_last", "n_emitted",
                 "trace_id")

    def __init__(self, req_id, prompt, max_new_tokens, trace_id=None):
        self.req_id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.output: List[int] = []
        self.done = False
        self.t_enqueue = None
        self.t_admit = None
        self.t_first = None
        self.t_last = None
        self.n_emitted = 0
        self.trace_id = trace_id


class _ServingMetrics:
    """Registry handles of the serving hot path, resolved once at engine
    construction (plain attribute access per step)."""

    __slots__ = ("requests", "completed", "tokens", "prefill_tokens",
                 "queue_wait", "ttft", "itl", "queue_depth", "queue_now",
                 "occupancy", "steps", "drains", "pages_in_use",
                 "peak_pages", "active_seqs", "cached_pages",
                 "evictable_pages", "spec_drafted", "spec_accepted",
                 "spec_rejected", "accept_len", "digest_epoch")

    def __init__(self):
        m = _obs.metrics
        # speculative decoding: folded in at the drain, never per step
        self.spec_drafted = m.counter("serving.spec.drafted_tokens")
        self.spec_accepted = m.counter("serving.spec.accepted_tokens")
        self.spec_rejected = m.counter("serving.spec.rejected_tokens")
        self.accept_len = m.histogram(
            "serving.spec.accept_len",
            bounds=[0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0])
        self.requests = m.counter("serving.requests_total")
        self.completed = m.counter("serving.requests_completed")
        self.tokens = m.counter("serving.tokens_generated")
        self.prefill_tokens = m.counter("serving.prefill_tokens")
        self.queue_wait = m.histogram("serving.queue_wait_ms")
        self.ttft = m.histogram("serving.ttft_ms")
        self.itl = m.histogram("serving.itl_ms")
        self.queue_depth = m.histogram("serving.queue_depth")
        self.queue_now = m.gauge("serving.queue_depth_now")
        self.occupancy = m.histogram("serving.batch_occupancy")
        self.steps = m.counter("serving.steps")
        self.drains = m.counter("serving.drains")
        self.pages_in_use = m.gauge("serving.pages_in_use")
        self.peak_pages = m.gauge("serving.peak_pages_in_use")
        self.active_seqs = m.gauge("serving.active_seqs")
        self.cached_pages = m.gauge("serving.prefix_cached_pages")
        self.evictable_pages = m.gauge("serving.prefix_evictable_pages")
        self.digest_epoch = m.gauge("serving.prefix_digest_epoch")

    def update_pool(self, stats: dict) -> None:
        """Fold the allocator and prefix-cache gauges in from
        ``engine.stats()`` (at every drain)."""
        self.pages_in_use.set(stats["pages_in_use"])
        self.peak_pages.set(stats["peak_in_use"])
        self.active_seqs.set(stats["active_seqs"])
        if "prefix_cached_pages" in stats:
            self.cached_pages.set(stats["prefix_cached_pages"])
            self.evictable_pages.set(stats["prefix_evictable_pages"])
            self.digest_epoch.set(stats.get("prefix_digest_epoch", 0))


class ContinuousBatchingEngine:
    """Continuous batching over the fused serving step.

    Newly admitted prompts stream through the SAME step as decode, in
    ``prefill_bucket``-sized chunks, while running rows keep decoding in the
    same call (their single token rides column 0 of the chunk).  EOS /
    budget / capacity freezing happens on the device; every ``sync_every``
    steps the host drains sampled tokens, retires finished requests (their
    pages go back to the pool) and admits waiting ones.

    ``device`` defaults to ``"cuda"`` and must match the model's device
    (shard 0's under tensor parallelism).  ``tensor_parallel`` (default
    ``FLAGS_serving_tensor_parallel``) and the engine geometry kwargs
    (``max_seq_len``, ``page_size``, ``prefill_bucket``, ``num_pages``,
    ``cache_dtype``, ``sync_every``) go to :class:`LlamaGenerator`; the
    engine's carried state lives on shard 0's device.

    Optional features, each resolved from its flag when the argument is
    None and off by default:

    - ``prefix_cache=True``: admission consults the radix prefix cache
      (``inference/prefix_cache.py``).  A prompt's longest cached
      page-aligned prefix is attached to its block table by reference (no
      prefill and no KV writes for those tokens: the chunked prefill starts
      at the first uncached token), a fully cached prompt privatizes its
      last page copy-on-write, retired sequences park their prompt pages in
      an LRU pool evicted only under pressure, and rows that matched pages
      a concurrent producer is still writing idle until the producer's
      prefill has been enqueued past them.
    - ``spec_decode="ngram"`` / ``"fused"`` (``spec_k``, ``spec_ngram_max``):
      decode-only steps take the speculative lane, one dispatch committing
      up to K tokens a row (``inference/speculative.py``).
    - ``kv_spill_pages=N`` (with the prefix cache): evicted cached pages
      move to a pinned host ring of N pages and swap back in on a match
      (``inference/kv_spill.py``).

    Greedy outputs with any of them on equal the plain engine's.

    ``metrics`` (default ``FLAGS_metrics``) records the per-request
    lifecycle histograms, the pool gauges and the per-phase step
    attribution (``self.attribution``) from host timestamps; off, nothing
    is recorded.
    """

    def __init__(self, model: LlamaForCausalLM, *, max_batch: int = 8,
                 gen: Optional[GenerationConfig] = None, device=None,
                 prefix_cache: Optional[bool] = None,
                 spec_decode=None, spec_k: Optional[int] = None,
                 spec_ngram_max: Optional[int] = None,
                 kv_spill_pages: Optional[int] = None,
                 metrics: Optional[bool] = None,
                 tensor_parallel: Optional[int] = None, **kw):
        self.gen_cfg = gen or GenerationConfig()
        self.g = LlamaGenerator(model, max_batch=max_batch, device=device,
                                tensor_parallel=tensor_parallel, **kw)
        dev = self.g.device
        B = max_batch
        self.B = B
        i32 = torch.int32
        self.tokens = torch.zeros((B,), dtype=i32, device=dev)  # last sampled
        self.positions = torch.zeros((B,), dtype=i32, device=dev)
        self.finished = torch.ones((B,), dtype=torch.bool, device=dev)
        self.counts = torch.zeros((B,), dtype=i32, device=dev)
        self._budgets_np = np.zeros((B,), np.int32)               # host mirror
        self.budgets = self.g.upload(self._budgets_np)
        self.slot_req: List[Optional[Request]] = [None] * B
        self.prompt_pos = np.zeros((B,), np.int64)   # prompt tokens consumed
        self.host_lens = np.zeros((B,), np.int64)
        self.waiting: "deque[Request]" = deque()
        self.completed: dict = {}            # req_id -> generated tokens
        self._next_id = 0
        self._bt = np.zeros((B, self.g.pages_per_seq), np.int32)
        self._bt_dev = self.g.upload(self._bt)
        # pending window: ("step", out [B], commit np [B], None, t_disp)
        # for plain steps, ("spec", out [B, K], n_commit [B], drafted [B] |
        # None, t_disp) for speculative ones (device tensors until the
        # drain; t_disp the host's dispatch timestamp)
        self._pending: List[tuple] = []
        self._steps_since_drain = 0
        # per-slot cap on valid generated tokens, set when a sequence
        # freezes early because the pool ran dry mid-decode
        self._gen_cap: List[Optional[int]] = [None] * B
        self.steps = 0                # device dispatches, plain and spec
        self.spec_dispatches = 0      # of which speculative
        # ---- telemetry: lifecycle histograms and pool gauges, stamped on
        # the host at dispatch and folded in at the drain
        if metrics is None:
            metrics = _obs.metrics_enabled()
        self._obs: Optional[_ServingMetrics] = \
            _ServingMetrics() if metrics else None
        # per-phase step attribution: stamp() on the step path is one list
        # append; durations, histograms and baselines fold at the drain
        self.attribution: Optional[_obs.StepAttribution] = \
            _obs.StepAttribution() if metrics else None

        # ---- prefix cache: radix-shared KV pages ----
        if prefix_cache is None:
            prefix_cache = flags.flag("prefix_cache")
        self.prefix_cache: Optional[PrefixCache] = None
        # per-slot admission leftovers: the nodes a row waits on before its
        # first prefill chunk (their producer is still writing them) and
        # the COW page copies to enqueue once the row may start
        self._gate: List[tuple] = [()] * B
        self._cow_pairs: List[List[tuple]] = [[] for _ in range(B)]
        # ---- speculative decoding ----
        self.spec = _sp.resolve_spec_config(spec_decode, spec_k,
                                            spec_ngram_max)
        self._spec_counts = {"spec_steps": 0, "spec_committed_tokens": 0,
                             "spec_drafted_tokens": 0,
                             "spec_accepted_tokens": 0,
                             "spec_rejected_tokens": 0}
        if self.spec is not None and self.spec.mode == "ngram":
            # host-owned history table (uploaded at admission and drains
            # only) + the device-resident recent-token ring every step keeps
            self._hist = _sp.SpecHistory(B, self.g.max_seq_len,
                                         upload=self.g.upload)
            self._recent = torch.full((B, self.spec.ngram_max),
                                      int(_sp.CTX_PAD), dtype=i32, device=dev)
        else:
            self._hist = None
            self._recent = None
        # per-row write caps of the spec steps (tokens the block table
        # covers): uploaded only when an allocation, truncation or
        # admission changed them, so warm spec steps upload nothing
        self._caps_dev = torch.zeros((B,), dtype=i32, device=dev)
        self._caps_dirty = True
        self.spill: Optional[HostSpillPool] = None
        if prefix_cache:
            self.prefix_cache = PrefixCache(
                self.g.cache.allocator, self.g.page_size,
                min_pages=flags.flag("prefix_cache_min_pages"))
            # ---- pinned host spill tier: evicted cached pages move to a
            # host ring instead of being dropped, and swap back in on a
            # match (a copy instead of a re-prefill)
            if kv_spill_pages is None:
                kv_spill_pages = flags.flag("kv_spill_pages")
            if kv_spill_pages and kv_spill_pages > 0:
                self.spill = HostSpillPool(self.g.cache, int(kv_spill_pages))
                self.prefix_cache.set_spill(self.spill)
        self.last_stats: dict = self.stats()

    # ---- public api ----
    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               trace_id: Optional[str] = None) -> Request:
        """Enqueue a request and return its live ``Request``."""
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, prompt,
                      max_new_tokens or self.gen_cfg.max_new_tokens,
                      trace_id=trace_id)
        self.waiting.append(req)
        if self._obs is not None:
            req.t_enqueue = time.perf_counter()
            self._obs.requests.inc()
            self._obs.queue_now.set(len(self.waiting))
        return req

    def add_request(self, prompt: Sequence[int],
                    max_new_tokens: Optional[int] = None) -> int:
        return self.submit(prompt, max_new_tokens).req_id

    def cancel_waiting(self, req: Request) -> bool:
        """Retire a request still in the waiting queue (no pages, no
        prefill spent).  False once admission has picked it up."""
        try:
            self.waiting.remove(req)
        except ValueError:
            return False
        req.done = True
        if self._obs is not None:
            self._obs.queue_now.set(len(self.waiting))
        return True

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slot_req)

    def run(self) -> dict:
        """Drive to completion; returns {req_id: generated tokens} for every
        request completed so far."""
        while self.has_work():
            self.step()
        self._drain()
        return dict(self.completed)

    # ---- engine step ----
    def step(self) -> List[Request]:
        """Admit what fits, run ONE device step (plain or speculative),
        drain every ``sync_every`` steps.  Returns requests retired by this
        call."""
        t_host0 = time.perf_counter() if _obs.TRACER.enabled else None
        self._admit()
        # requests retired by a mid-step drain under pool pressure still
        # ride this call's return
        early_done: List[Request] = []
        if all(r is None for r in self.slot_req):
            return self._drain() if self._pending else []
        g = self.g
        B = self.B
        if self.prefix_cache is not None:
            self._open_gates()
        prompt_rows = [b for b in range(B)
                       if self.slot_req[b] is not None and not self._gate[b]
                       and self.prompt_pos[b] < len(self.slot_req[b].prompt)]
        # decode-only steps take the speculative lane: ONE dispatch commits
        # up to K tokens a row.  Steps with prefill chunks in flight, or
        # with rows gated on a producer, take the plain step
        spec_lane = (self.spec is not None and not prompt_rows
                     and not any(self._gate)
                     and any(r is not None for r in self.slot_req))
        T = g.prefill_bucket if prompt_rows else 1
        if spec_lane:
            # the step may commit up to K tokens a row: raise the host's
            # length bound first so the growth below covers every position
            # it can write (the drain resyncs the bound and rolls surplus
            # pages back)
            for b in range(B):
                req = self.slot_req[b]
                if req is not None and self.prompt_pos[b] >= len(req.prompt):
                    self.host_lens[b] = min(
                        int(self.host_lens[b]) + self.spec.k, g.max_seq_len)

        # grow pages BEFORE the step: every position this step writes must
        # already be inside the row's block table
        alloc = g.cache.allocator
        grew = False
        for b in range(B):
            req = self.slot_req[b]
            if req is None or self.prompt_pos[b] < len(req.prompt):
                continue
            while alloc.context_len(req.req_id) <= int(self.host_lens[b]) \
                    and alloc.context_len(req.req_id) < g.max_seq_len:
                if alloc.available_pages == 0:
                    if self.spec is not None and self._pending:
                        # the speculative overestimate may be what holds
                        # the pool: drain now (it resyncs host lengths and
                        # rolls surplus tail pages back), then retry this
                        # row's growth once, with the window empty
                        early_done.extend(self._drain())
                        if self.slot_req[b] is None:
                            break
                        continue
                    # pool ran dry mid-decode (undersized num_pages):
                    # finalize THIS sequence early — freeze it on the
                    # device and cap its valid output at what was
                    # generated before this step
                    if self._gen_cap[b] is None:
                        n = len(req.output)
                        for kind, _o, cm, _d, _t in self._pending:
                            if kind != "step":
                                # the in-flight spec commit count is a
                                # device tensor: one marked sync on this
                                # degraded path
                                _obs.count_sync()
                            n += int(cm[b])
                        self._gen_cap[b] = n
                        self.finished[b] = True
                    break
                alloc.extend(req.req_id,
                             min(g.page_size,
                                 g.max_seq_len - alloc.context_len(req.req_id)))
                self._bt[b] = alloc.block_table(
                    [req.req_id], max_pages=g.pages_per_seq)[0]
                grew = True
        if grew:
            self._bt_dev = g.upload(self._bt)
            self._caps_dirty = True

        if spec_lane:
            out_mat, ncommit, dlen = self._dispatch_spec()
            t_step = time.perf_counter()
            self._pending.append(("spec", out_mat, ncommit, dlen, t_step))
            self.steps += 1
            self.spec_dispatches += 1
            if self.attribution is not None:
                # commit counts stay on the device until the drain, which
                # credits them
                self.attribution.stamp(
                    "spec_verify" if self.spec.mode == "ngram"
                    else "fused_k", int(self.spec.k), t_step)
            if self._obs is not None:
                o = self._obs
                o.steps.inc()
                o.occupancy.observe(
                    sum(r is not None for r in self.slot_req) / B)
                o.queue_depth.observe(len(self.waiting))
                o.queue_now.set(len(self.waiting))
            if t_host0 is not None:
                _obs.TRACER.event("engine.step", t_host0, t_step - t_host0,
                                  cat="serving", tid="engine",
                                  args={"T": int(self.spec.k),
                                        "spec": self.spec.mode})
            self._steps_since_drain += 1
            if self._steps_since_drain >= g.sync_every:
                return early_done + self._drain()
            return early_done

        ql = np.zeros((B,), np.int32)
        decode = np.zeros((B,), bool)
        commit = np.zeros((B,), bool)
        chunk = np.zeros((B, T), np.int32)
        for b in range(B):
            req = self.slot_req[b]
            if req is None or self._gate[b]:
                # gated: this row's matched prefix pages are still being
                # written by their producer row
                continue
            rem = len(req.prompt) - int(self.prompt_pos[b])
            if rem > 0:                      # prefill chunk
                n = min(rem, T)
                ql[b] = n
                chunk[b, :n] = np.asarray(
                    req.prompt[self.prompt_pos[b]:self.prompt_pos[b] + n],
                    np.int32)
                commit[b] = n == rem         # consumes the final token
                self.prompt_pos[b] += n
                self.host_lens[b] += n
            else:                            # decode row
                ql[b] = 1
                decode[b] = True
                commit[b] = True
                self.host_lens[b] += 1

        tokens_in = g.upload(chunk)
        dm = g.upload(decode)
        # decode rows feed their last sampled token, still on the device
        tokens_in[:, 0] = torch.where(dm, self.tokens, tokens_in[:, 0])
        args = (self.gen_cfg, T, tokens_in, g.upload(ql), self.positions,
                self.finished, dm, g.upload(commit), self.counts,
                self.budgets, self._bt_dev)
        if self._recent is not None:
            # ngram engines carry the drafter's ring through EVERY step, so
            # the verify step's context is exact when the row reaches decode
            (self.tokens, self.positions, self.finished, _all_done,
             self.counts, self._recent) = g._step_fn(*args,
                                                     recent=self._recent)
        else:
            (self.tokens, self.positions, self.finished, _all_done,
             self.counts) = g._step_fn(*args)
        # the dispatch timestamp rides the pending window: the drain
        # stamps TTFT/ITL per committed token from it
        t_step = time.perf_counter()
        self._pending.append(("step", self.tokens, commit, None, t_step))
        self.steps += 1
        if self.attribution is not None:
            # a mixed step (prefill chunks in flight) is the prefill-chunk
            # shape; T=1 is pure decode.  Tokens: query tokens processed
            self.attribution.stamp("prefill" if T > 1 else "decode",
                                   int(T), t_step, int(ql.sum()))
        if self._obs is not None:
            o = self._obs
            o.steps.inc()
            o.occupancy.observe(
                sum(r is not None for r in self.slot_req) / B)
            o.queue_depth.observe(len(self.waiting))
            o.queue_now.set(len(self.waiting))
            n_prefill = int(ql.sum()) - int(decode.sum())
            if n_prefill:
                o.prefill_tokens.inc(n_prefill)
        if t_host0 is not None:
            _obs.TRACER.event("engine.step", t_host0, t_step - t_host0,
                              cat="serving", tid="engine",
                              args={"T": int(T)})
        if self.prefix_cache is not None:
            # this step's prefill writes are enqueued: pages wholly below
            # each row's prompt cursor are safe for later steps of other
            # rows to read (the stream runs work in enqueue order)
            for b in range(B):
                req = self.slot_req[b]
                if req is not None and ql[b] > 0 and not decode[b]:
                    self.prefix_cache.note_progress(
                        req.req_id, int(self.prompt_pos[b]))
        self._steps_since_drain += 1
        if self._steps_since_drain >= g.sync_every:
            return early_done + self._drain()
        return early_done

    # ---- prefix-cache gates: rows waiting on a producer's prefill ----
    def _open_gates(self):
        """Clear gates whose matched pages became ready, and enqueue the
        cleared rows' COW page copies BEFORE this step reads them.
        Producers advance every step, so every gate opens in bounded
        time."""
        starting = []
        for b in range(self.B):
            if self._gate[b] and all(x.ready for x in self._gate[b]):
                self._gate[b] = ()
            if not self._gate[b] and self._cow_pairs[b]:
                starting.extend(self._cow_pairs[b])
                self._cow_pairs[b] = []
        if starting:
            src = self.g.upload(np.asarray([s for s, _ in starting], np.int64))
            dst = self.g.upload(np.asarray([d for _, d in starting], np.int64))
            _cow_copy_pages(self.g.cache.shards, src, dst)
            if self.attribution is not None:
                self.attribution.stamp("cow_copy", 0)

    # ---- the speculative dispatch (decode-only batches) ----
    def _dispatch_spec(self):
        """Enqueue ONE speculative step: the T=K ngram verify step or the
        fused K-step decode.  Beyond the chained engine state it reads only
        the drain-refreshed history table and the cached write caps, so the
        warm spec loop uploads and reads back nothing.

        Returns the pending-window payload ``(out [B, K], n_commit [B],
        drafted [B] | None)``, device tensors read at the drain."""
        g = self.g
        spec = self.spec
        if self._caps_dirty:
            alloc = g.cache.allocator
            caps = np.zeros((self.B,), np.int32)
            for b in range(self.B):
                req = self.slot_req[b]
                if req is not None:
                    caps[b] = alloc.context_len(req.req_id)
            self._caps_dev = g.upload(caps)
            self._caps_dirty = False
        if spec.mode == "ngram":
            hist, hist_len = self._hist.device_arrays()
            (out, ncommit, dlen, self.tokens, self.positions, self.finished,
             _all_done, self.counts, self._recent) = g._spec_verify_fn(
                self.gen_cfg, spec.k, spec.ngram_max, self.tokens,
                self._recent, hist, hist_len, self.positions, self.finished,
                self.counts, self.budgets, self._caps_dev, self._bt_dev)
        else:
            (out, ncommit, self.tokens, self.positions, self.finished,
             _all_done, self.counts) = g._fused_decode_fn(
                self.gen_cfg, spec.k, self.tokens, self.positions,
                self.finished, self.counts, self.budgets, self._caps_dev,
                self._bt_dev)
            dlen = None
        return out, ncommit, dlen

    # ---- serving telemetry ----
    def stats(self) -> dict:
        """Pool, prefix-cache, spill and speculative telemetry and the count
        of device dispatches (with a feature off, its counters are absent
        or 0)."""
        s = self.g.cache.allocator.stats()
        s["kv_cache_dtype"] = str(self.g.cache.kv_dtype).replace("torch.",
                                                                 "")
        s["pool_bytes"] = self.g.pool_bytes
        s["tp"] = self.g.tp
        s["steps"] = self.steps
        s["prefix_cache_enabled"] = self.prefix_cache is not None
        if self.prefix_cache is not None:
            s["prefix_cached_pages"] = self.prefix_cache.cached_pages()
            s["prefix_evictable_pages"] = self.prefix_cache.evictable_pages()
            s["prefix_spilled_pages"] = self.prefix_cache.spilled_pages()
            s["prefix_digest_epoch"] = self.prefix_cache.digest_epoch
        # session-migration books, once the engine has exported or
        # imported a snapshot
        mc = getattr(self, "_migration_counts", None)
        if mc is not None:
            s.update(mc)
        s["kv_spill_enabled"] = self.spill is not None
        if self.spill is not None:
            s.update(self.spill.stats())
        s["spec_decode_enabled"] = self.spec is not None
        if self.spec is not None:
            s["spec_mode"] = self.spec.mode
            s["spec_k"] = self.spec.k
            s.update(self._spec_counts)
        return s

    def inflight_requests(self, top_k: int = 8) -> List[dict]:
        """The oldest in-flight requests (busy slots and the waiting queue)
        with their trace ids: the ``/statusz`` hung-request table.  Reads
        host state only, so the status thread may call it while the engine
        thread runs."""
        now = time.perf_counter()

        def row(req: Request, state: str, slot) -> dict:
            t0 = req.t_enqueue
            return {"req_id": req.req_id, "trace_id": req.trace_id,
                    "state": state, "slot": slot,
                    "age_s": None if t0 is None else round(now - t0, 3),
                    "prompt_tokens": len(req.prompt),
                    "generated": len(req.output)}

        rows = []
        for b in range(self.B):
            req = self.slot_req[b]
            if req is None:
                continue
            state = "prefill" if self.prompt_pos[b] < len(req.prompt) \
                else "decode"
            rows.append(row(req, state, b))
        for req in list(self.waiting):
            rows.append(row(req, "queued", None))
        rows.sort(key=lambda r: -(r["age_s"] or 0.0))
        return rows[:top_k]

    def prefix_digest(self, max_entries: Optional[int] = None,
                      since: Optional[str] = None):
        """Prefix-residency digest for router placement: the chain hashes
        of this engine's indexed KV pages and the page geometry a router
        needs to hash an incoming prompt (``prefix_cache.block_hashes``).
        ``None`` with the cache off.

        ``since="<gen>:<epoch>"`` asks for only the adds/evictions after a
        confirmed epoch: ``mode="delta"`` when the change log still covers
        that epoch of this cache instance, else ``mode="full"`` with the
        whole (truncated) set.  Past ``router_digest_sketch_threshold``
        entries the digest ships as the Bloom sketch (``mode="sketch"``)."""
        cache = self.prefix_cache
        if cache is None:
            return None
        if max_entries is None:
            max_entries = flags.flag("router_digest_max")
        out = {"page_size": self.g.page_size,
               "algo": "blake2b8-chain",
               "gen": cache.digest_gen,
               "epoch": cache.digest_epoch,
               # the subset demoted to the host ring, shipped whole
               "spilled": cache.spilled_hashes()}
        sk = cache.sketch_wire()
        if (sk is not None and sk["n"] >
                int(flags.flag("router_digest_sketch_threshold"))):
            out.update(mode="sketch", sketch=sk, count=sk["n"])
            return out
        if since:
            gen, _, ep = str(since).partition(":")
            if gen == cache.digest_gen:
                try:
                    delta = cache.digest_delta(int(ep))
                except ValueError:
                    delta = None
                if delta is not None:
                    adds, dels = delta
                    out.update(mode="delta", adds=adds, dels=dels)
                    return out
        out.update(mode="full", hashes=cache.digest(max_entries))
        return out

    # ---- drain: the ONLY host<->device sync of the steady state ----
    def _drain(self) -> List[Request]:
        done: List[Request] = []
        if not self._pending:
            self._steps_since_drain = 0
            return done
        obs = self._obs
        attr = self.attribution
        t_drain0 = time.perf_counter() if attr is not None else None
        if obs is not None:
            obs.drains.inc()
            _obs.count_sync()        # the window's host<->device transfer
        # one transfer: the finished flags and every pending output (and,
        # for spec steps, commit and draft counts), flattened together
        B = self.B
        parts = [self.finished.to(torch.int32)]
        for kind, out, cm, dl, _t in self._pending:
            parts.append(out.reshape(-1).to(torch.int32))
            if kind == "spec":
                parts.append(cm.to(torch.int32))
                if dl is not None:
                    parts.append(dl.to(torch.int32))
        flat = torch.cat(parts).cpu().numpy()
        fin = flat[:B].astype(bool)
        off = B
        window = []
        for kind, out, cm, dl, t in self._pending:
            n = out.numel()
            o = flat[off:off + n].reshape(tuple(out.shape))
            off += n
            if kind == "spec":
                c = flat[off:off + B]
                off += B
                d = None
                if dl is not None:
                    d = flat[off:off + B]
                    off += B
                window.append((kind, o, c, d, t))
            else:
                window.append((kind, o, cm, None, t))
        self._pending.clear()
        self._steps_since_drain = 0
        self._fold_spec_metrics(window)
        if attr is not None:
            # the window's stamps (the last closes against the drain's
            # entry), after the spec token credits landed
            attr.fold(t_drain0)
        alloc = self.g.cache.allocator
        eos = self.gen_cfg.eos_token_id
        bt_dirty = False
        for b in range(B):
            req = self.slot_req[b]
            if req is None:
                continue
            prev_len = len(req.output)
            # committed tokens this window and their dispatch stamps: a
            # plain step contributes its sample where the host marked the
            # row committing, a spec step its accepted prefix (frozen
            # rows: none)
            new_tok: List[int] = []
            tok_ts: List[float] = []
            for kind, out, cm, _dl, t in window:
                if kind == "step":
                    if cm[b]:
                        new_tok.append(int(out[b]))
                        tok_ts.append(t)
                else:
                    for v in out[b, :int(cm[b])]:
                        new_tok.append(int(v))
                        tok_ts.append(t)
            req.output.extend(new_tok)
            if obs is not None:
                # TTFT/ITL from the committing steps' dispatch stamps; the
                # commits the trims below drop (past the budget, past the
                # cache, frozen repeats after EOS) are not timed
                room = max(0, req.max_new_tokens - prev_len)
                cap_v = max(1, self.g.max_seq_len - len(req.prompt))
                if self._gen_cap[b] is not None:
                    cap_v = min(cap_v, max(1, self._gen_cap[b]))
                room = min(room, max(0, cap_v - prev_len))
                if eos is not None and eos in new_tok:
                    room = min(room, new_tok.index(eos) + 1)
                for tj in tok_ts[:room]:
                    if req.t_first is None:
                        req.t_first = tj
                        base = req.t_enqueue if req.t_enqueue is not None \
                            else tj
                        obs.ttft.observe((tj - base) * 1e3)
                    else:
                        obs.itl.observe((tj - req.t_last) * 1e3)
                    req.t_last = tj
            # the device freeze repeats the last token once finished: trim
            # to the true capacity / EOS / budget boundary here.  cap = what
            # fits in the cache (max_seq minus the prompt), lowered further
            # if the pool ran dry mid-decode
            cap = max(1, self.g.max_seq_len - len(req.prompt))
            if self._gen_cap[b] is not None:
                cap = min(cap, max(1, self._gen_cap[b]))
            if len(req.output) > cap:
                req.output = req.output[:cap]
            if eos is not None and eos in req.output:
                req.output = req.output[:req.output.index(eos) + 1]
            elif len(req.output) >= req.max_new_tokens:
                req.output = req.output[:req.max_new_tokens]
            elif len(req.output) < cap and not fin[b]:
                if obs is not None and len(req.output) > req.n_emitted:
                    obs.tokens.inc(len(req.output) - req.n_emitted)
                    req.n_emitted = len(req.output)
                if self.spec is not None and \
                        self.prompt_pos[b] >= len(req.prompt):
                    bt_dirty |= self._rollback_tail(b, req)
                if self._hist is not None and new_tok:
                    # the drafter's table grows only here, at the drain
                    self._hist.extend_row(b, new_tok)
                continue                     # still running
            req.done = True
            if obs is not None:
                if len(req.output) > req.n_emitted:
                    obs.tokens.inc(len(req.output) - req.n_emitted)
                    req.n_emitted = len(req.output)
                obs.completed.inc()
                if _obs.TRACER.enabled and req.t_enqueue is not None:
                    self._lifecycle_spans(b, req)
            if self.prefix_cache is not None:
                # its cached prefix pages fall to the LRU pool (evicted
                # only when an allocation needs the memory)
                self.prefix_cache.release(req.req_id)
            alloc.free(req.req_id)
            self.slot_req[b] = None
            self._gen_cap[b] = None
            self.finished[b] = True
            self.completed[req.req_id] = req.output
            done.append(req)
        if bt_dirty:
            self._bt_dev = self.g.upload(self._bt)
            self._caps_dirty = True
        self.last_stats = self.stats()
        if obs is not None:
            obs.update_pool(self.last_stats)
        if attr is not None:
            # the drain is a phase: the window's transfer and the retire
            # bookkeeping
            attr.observe_host("drain", time.perf_counter() - t_drain0)
        return done

    def _lifecycle_spans(self, b: int, req: Request) -> None:
        """Retroactive queued -> prefill -> decode spans of a retired
        request, on its trace lane (or its slot's)."""
        tr = _obs.TRACER
        t_adm = req.t_admit or req.t_enqueue
        t_f = req.t_first if req.t_first is not None else t_adm
        t_l = req.t_last if req.t_last is not None else t_f
        lane = req.trace_id or f"slot{b}"
        rid = req.req_id
        ctx = {"trace_id": req.trace_id, "slot": b} \
            if req.trace_id else {"slot": b}
        proc = getattr(self, "trace_proc", None)
        if proc:
            ctx["proc"] = proc
        tr.event(f"req{rid}.queued", req.t_enqueue, t_adm - req.t_enqueue,
                 cat="serving", tid=lane, args=ctx)
        tr.event(f"req{rid}.prefill", t_adm, t_f - t_adm, cat="serving",
                 tid=lane, args={**ctx, "prompt_tokens": len(req.prompt)})
        tr.event(f"req{rid}.decode", t_f, t_l - t_f, cat="serving",
                 tid=lane, args={**ctx, "generated": len(req.output)})

    def _fold_spec_metrics(self, window) -> None:
        """Fold the window's speculative counters (steps, committed,
        drafted, accepted, rejected tokens) into the engine's books and the
        registry (and the accept-length histogram), at the drain."""
        if self.spec is None:
            return
        obs = self._obs
        n_spec = c_tot = d_tot = a_tot = r_tot = 0
        for kind, _out, cm, dl, _t in window:
            if kind != "spec":
                continue
            n_spec += 1
            for b in range(self.B):
                n = int(cm[b])
                d = int(dl[b]) if dl is not None else 0
                if n <= 0 and d <= 0:
                    continue
                acc = min(max(n - 1, 0), d)
                c_tot += n
                d_tot += d
                a_tot += acc
                r_tot += d - acc
                if obs is not None and n > 0:
                    # ngram: accepted drafts a dispatch; fused: tokens
                    # beyond the first
                    obs.accept_len.observe(float(n - 1))
        if not n_spec:
            return
        if self.attribution is not None and c_tot:
            self.attribution.credit_tokens(
                "spec_verify" if self.spec.mode == "ngram" else "fused_k",
                c_tot)
        sc = self._spec_counts
        sc["spec_steps"] += n_spec
        sc["spec_committed_tokens"] += c_tot
        sc["spec_drafted_tokens"] += d_tot
        sc["spec_accepted_tokens"] += a_tot
        sc["spec_rejected_tokens"] += r_tot
        if obs is not None:
            if d_tot:
                obs.spec_drafted.inc(d_tot)
            if a_tot:
                obs.spec_accepted.inc(a_tot)
            if r_tot:
                obs.spec_rejected.inc(r_tot)

    def _rollback_tail(self, b: int, req: Request) -> bool:
        """Resync the host length bound to the device's true commit count
        and release surplus tail pages the speculative overestimate grew
        for tokens that were then rejected.  ``PageAllocator.truncate``
        drops only THIS sequence's references, so a shared or COW page is
        never taken from a sibling.  K tokens of headroom stay allocated.
        Returns True when the row's block table changed."""
        g = self.g
        true_len = len(req.prompt) + len(req.output)
        self.host_lens[b] = true_len
        alloc = g.cache.allocator
        keep = min(true_len + self.spec.k, g.max_seq_len)
        if alloc.context_len(req.req_id) > keep + g.page_size:
            alloc.truncate(req.req_id, keep)
            self._bt[b] = alloc.block_table(
                [req.req_id], max_pages=g.pages_per_seq)[0]
            return True
        return False

    # ---- admission (host-known free slots only; frees appear at drains) ----
    def _admit(self):
        free = [b for b in range(self.B) if self.slot_req[b] is None]
        if not free or not self.waiting:
            return
        g = self.g
        alloc = g.cache.allocator
        cache = self.prefix_cache
        admitted = []
        starts = np.zeros((self.B,), np.int32)
        while free and self.waiting:
            req = self.waiting[0]
            # truncate ONCE here; every later length derives from it
            req.prompt = req.prompt[: g.max_seq_len - 1]
            dense_need = -(-len(req.prompt) // g.page_size)
            # prefix match: the longest cached page-aligned prefix trims
            # both the fresh-page demand and the prefill schedule
            plan = cache.plan(req.prompt) if cache is not None else None
            need = plan.fresh_pages if plan is not None else dense_need
            # matched idle pages are about to be pinned, not evicted: they
            # cannot count as reclaimable supply
            avail = alloc.available_pages - (
                plan.idle_matched if plan is not None else 0)
            if plan is not None and plan.nodes and avail < need \
                    and len(free) == self.B and not admitted:
                # nothing is running: admit from scratch (and let reclaim
                # evict the cache) rather than wait forever
                plan = None
                need, avail = dense_need, alloc.available_pages
            if avail < need:
                if len(free) == self.B and not admitted \
                        and dense_need > alloc.num_pages:
                    raise MemoryError(
                        f"prompt needs {dense_need} pages but the pool only "
                        f"has {alloc.num_pages}; raise num_pages or "
                        "page_size")
                break                         # wait for pages to free up
            self.waiting.popleft()
            b = free.pop(0)
            if plan is not None:
                try:
                    # pin before any reclaim runs; spilled matches are
                    # copied back in here, ahead of the first chunk
                    cache.attach(plan)
                except MemoryError:
                    # a swap-in found no page: retry at the next admission
                    self.waiting.appendleft(req)
                    free.insert(0, b)
                    break
                shared = [x.page for x in plan.nodes]
            else:
                shared = ()
            try:
                alloc.allocate(req.req_id, len(req.prompt),
                               shared_pages=shared)
            except MemoryError:
                # the evictable estimate raced a structure change: roll
                # back and retry this request at the next admission
                if plan is not None:
                    cache.detach(plan)
                self.waiting.appendleft(req)
                free.insert(0, b)
                break
            if plan is not None:
                self._cow_pairs[b] = cache.admit(req.req_id, req.prompt,
                                                 plan)
                self._gate[b] = tuple(plan.wait)
                starts[b] = plan.start
            else:
                self._gate[b] = ()
                self._cow_pairs[b] = []
            admitted.append((b, req))
        if not admitted:
            return
        mask = np.zeros((self.B,), bool)
        budgets = self._budgets_np
        if self._obs is not None:
            now = time.perf_counter()
            for _, req in admitted:
                req.t_admit = now
                if req.t_enqueue is not None:
                    self._obs.queue_wait.observe(
                        (now - req.t_enqueue) * 1e3)
            self._obs.queue_now.set(len(self.waiting))
        for b, req in admitted:
            self.slot_req[b] = req
            self.prompt_pos[b] = int(starts[b])
            self.host_lens[b] = int(starts[b])
            mask[b] = True
            budgets[b] = req.max_new_tokens
            self._bt[b] = alloc.block_table(
                [req.req_id], max_pages=g.pages_per_seq)[0]
        m = g.upload(mask)
        zero = torch.zeros((), dtype=torch.int32, device=g.device)
        # rows with a prefix hit start mid-prompt: their write cursor and
        # RoPE positions begin at the first uncached token
        self.positions = torch.where(m, g.upload(starts), self.positions)
        self.counts = torch.where(m, zero, self.counts)
        self.budgets = g.upload(budgets)
        self.finished = self.finished & ~m
        self._bt_dev = g.upload(self._bt)
        self._caps_dirty = True
        if self._hist is not None:
            # seed the drafter: the full prompt into the history table, the
            # prompt's tail into the device recent ring
            nmax = self.spec.ngram_max
            rec = np.full((self.B, nmax), int(_sp.CTX_PAD), np.int32)
            for b, req in admitted:
                self._hist.reset_row(b, req.prompt)
                rec[b] = _sp.recent_window(req.prompt, nmax)
            self._recent = torch.where(m[:, None], g.upload(rec),
                                       self._recent)
