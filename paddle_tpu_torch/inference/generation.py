"""Autoregressive generation over a paged KV cache — the serving decode loop
(port of ``paddle_tpu/inference/generation.py``, dense float-pool path).

- ``LlamaGenerator._step_fn`` is the one fused engine step: derive write
  slots from the block table, run every layer through the mixed-mode
  ``ragged_paged_attention`` kernel (the step's own K/V rows fold in with a
  causal mask), commit all layers' fresh KV in ONE in-place scatter at the
  end (attention reads the pre-step pool), then sample.  T=1 is pure
  decode; T=prefill_bucket is a chunked-prefill / mixed step.
- EOS / budget / capacity tracking stays on the device (``finished``,
  ``counts``, ``budgets``): a step enqueues work and returns without reading
  anything back; the host drains results every ``sync_every`` steps.  Small
  per-step host inputs go up through pinned buffers with
  ``non_blocking=True``.

Not ported in this slice (each a later ROADMAP item; the constructors do not
take their options): the prefix cache, speculative decoding, the host spill
tier, tensor parallelism, int8 pages, and the metrics / attribution hooks.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import flags, resolve_device
from ..kernels.paged_attention import (ragged_paged_attention,
                                       write_kv_pages_all_layers)
from ..kernels.rms_norm import rms_norm_fp32
from ..models.llama import LlamaForCausalLM, _rope_cos_sin
from ..utils import extract_params
from .kv_cache import PagedKVCache


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
    ``device`` (default ``"cuda"``; the model must already live there)."""

    def __init__(self, model: LlamaForCausalLM, *, max_batch: int = 8,
                 max_seq_len: Optional[int] = None, page_size: int = 32,
                 cache_dtype: Optional[str] = None,
                 prefill_bucket: int = 64, sync_every: int = 8,
                 num_pages: Optional[int] = None, device=None):
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"the model lives on {model.device}, but the "
                             f"generator was asked for {dev}")
        self.device = dev
        c = model.config
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
            head_dim=c.head_dim, dtype=cache_dtype or c.dtype, device=dev)
        self.pool_bytes = self.num_pages * PagedKVCache.bytes_per_page(
            c.num_hidden_layers, c.num_key_value_heads, self.page_size,
            c.head_dim, cache_dtype or c.dtype)
        self._cos, self._sin = _rope_cos_sin(self.max_seq_len, c.head_dim,
                                             c.rope_theta, device=dev)

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
        layers' fresh KV in one in-place scatter; returns the final-norm
        hidden states for all T positions.

        tokens: [B, T] int32; ql: [B] valid tokens per row (0 = inert row);
        positions: [B] cache tokens BEFORE this step (the write cursor);
        block_tables: [B, W] int32.
        """
        c = self.config
        B, T = tokens.shape
        page = self.page_size
        dev = tokens.device
        kc, vc = self.cache.arrays

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
        toks = torch.clamp(tokens, 0, params["embed"].shape[0] - 1).long()
        h = params["embed"][toks]                                 # [B, T, H]

        qh, kvh, dh = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        k_rows, v_rows = [], []
        for li, lp in enumerate(params["blocks"]):
            y = rms_norm_fp32(h, lp["input_layernorm.weight"], c.rms_norm_eps)
            q = (y @ lp["self_attn.q_proj.weight"]).reshape(B, T, qh, dh)
            k = (y @ lp["self_attn.k_proj.weight"]).reshape(B, T, kvh, dh)
            v = (y @ lp["self_attn.v_proj.weight"]).reshape(B, T, kvh, dh)
            q = _rope_bt(q, cos, sin)
            k = _rope_bt(k, cos, sin)
            # prior context from the pool + this step's own rows (causal),
            # one mixed-mode kernel call; the commit follows all layers
            attn = ragged_paged_attention(q, kc[li], vc[li], block_tables,
                                          ctx_prev, q_lens=ql,
                                          k_new=k, v_new=v)
            h = h + attn.reshape(B, T, -1) @ lp["self_attn.o_proj.weight"]
            y = rms_norm_fp32(h, lp["post_attention_layernorm.weight"],
                              c.rms_norm_eps)
            act = F.silu(y @ lp["mlp.gate_proj.weight"]) * \
                (y @ lp["mlp.up_proj.weight"])
            h = h + act @ lp["mlp.down_proj.weight"]
            k_rows.append(k)
            v_rows.append(v)

        L = len(k_rows)
        write_kv_pages_all_layers(
            kc, vc, torch.stack(k_rows).reshape(L, B * T, kvh, dh),
            torch.stack(v_rows).reshape(L, B * T, kvh, dh), slots)
        return rms_norm_fp32(h, params["norm"], c.rms_norm_eps)

    # ---- the ONE engine step ----
    @torch.no_grad()
    def _step_fn(self, gc, T, tokens, q_lens, positions, finished,
                 decode_mask, commit_mask, counts, budgets, block_tables):
        """One fused serving step: attention over every layer → one batched
        KV commit → sample.  All arguments are device tensors ([B] or
        [B, T]); nothing is read back to the host.

        tokens: [B, T] this step's query tokens (decode rows use column 0);
        q_lens: [B] valid tokens per row; positions: [B] write cursor;
        decode_mask: [B] rows whose column-0 token is generated output;
        commit_mask: [B] rows whose sample is a real generated token.
        Returns (out_tokens, new_positions, finished, all_done, counts).
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
        return out_tokens, new_positions, finished, finished.all(), counts

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
                if bool(all_done):           # single scalar sync at a drain
                    break

        for s in seq_ids:
            alloc.free(s)

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
    ``output`` grows at the engine's drains; ``done`` flips at retirement."""

    __slots__ = ("req_id", "prompt", "max_new_tokens", "output", "done",
                 "trace_id")

    def __init__(self, req_id, prompt, max_new_tokens, trace_id=None):
        self.req_id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = max_new_tokens
        self.output: List[int] = []
        self.done = False
        self.trace_id = trace_id


class ContinuousBatchingEngine:
    """Continuous batching over the fused serving step.

    Newly admitted prompts stream through the SAME step as decode, in
    ``prefill_bucket``-sized chunks, while running rows keep decoding in the
    same call (their single token rides column 0 of the chunk).  EOS /
    budget / capacity freezing happens on the device; every ``sync_every``
    steps the host drains sampled tokens, retires finished requests (their
    pages go back to the pool) and admits waiting ones.

    ``device`` defaults to ``"cuda"`` and must match the model's device.
    Engine geometry kwargs (``max_seq_len``, ``page_size``,
    ``prefill_bucket``, ``num_pages``, ``cache_dtype``, ``sync_every``) go to
    :class:`LlamaGenerator`.
    """

    def __init__(self, model: LlamaForCausalLM, *, max_batch: int = 8,
                 gen: Optional[GenerationConfig] = None, device=None, **kw):
        self.gen_cfg = gen or GenerationConfig()
        self.g = LlamaGenerator(model, max_batch=max_batch, device=device,
                                **kw)
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
        # pending window: (out_tokens [B] on the device, commit np [B])
        self._pending: List[tuple] = []
        self._steps_since_drain = 0
        # per-slot cap on valid generated tokens, set when a sequence
        # freezes early because the pool ran dry mid-decode
        self._gen_cap: List[Optional[int]] = [None] * B
        self.steps = 0                       # fused device steps dispatched

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
        """Admit what fits, run ONE fused device step, drain every
        ``sync_every`` steps.  Returns requests retired by this call."""
        self._admit()
        if all(r is None for r in self.slot_req):
            return self._drain() if self._pending else []
        g = self.g
        B = self.B
        prompt_rows = [b for b in range(B) if self.slot_req[b] is not None
                       and self.prompt_pos[b] < len(self.slot_req[b].prompt)]
        T = g.prefill_bucket if prompt_rows else 1

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
                if alloc.free_pages == 0:
                    # pool ran dry mid-decode (undersized num_pages):
                    # finalize THIS sequence early — freeze it on the
                    # device and cap its valid output at what was
                    # generated before this step
                    if self._gen_cap[b] is None:
                        self._gen_cap[b] = len(req.output) + sum(
                            int(cm[b]) for _o, cm in self._pending)
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

        ql = np.zeros((B,), np.int32)
        decode = np.zeros((B,), bool)
        commit = np.zeros((B,), bool)
        chunk = np.zeros((B, T), np.int32)
        for b in range(B):
            req = self.slot_req[b]
            if req is None:
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
        (self.tokens, self.positions, self.finished, _all_done,
         self.counts) = g._step_fn(
            self.gen_cfg, T, tokens_in, g.upload(ql), self.positions,
            self.finished, dm, g.upload(commit), self.counts, self.budgets,
            self._bt_dev)
        self._pending.append((self.tokens, commit))
        self.steps += 1
        self._steps_since_drain += 1
        if self._steps_since_drain >= g.sync_every:
            return self._drain()
        return []

    # ---- serving telemetry ----
    def stats(self) -> dict:
        """Pool telemetry and the count of fused device steps."""
        s = self.g.cache.allocator.stats()
        s["kv_cache_dtype"] = str(self.g.cache.k.dtype).replace("torch.", "")
        s["pool_bytes"] = self.g.pool_bytes
        s["steps"] = self.steps
        return s

    # ---- drain: the ONLY host<->device sync of the steady state ----
    def _drain(self) -> List[Request]:
        done: List[Request] = []
        if not self._pending:
            self._steps_since_drain = 0
            return done
        outs = torch.stack([o for o, _cm in self._pending]).cpu().numpy()
        window = [(outs[i], cm) for i, (_o, cm) in enumerate(self._pending)]
        self._pending.clear()
        self._steps_since_drain = 0
        fin = self.finished.cpu().numpy()
        alloc = self.g.cache.allocator
        eos = self.gen_cfg.eos_token_id
        for b in range(self.B):
            req = self.slot_req[b]
            if req is None:
                continue
            for out, cm in window:
                if cm[b]:
                    req.output.append(int(out[b]))
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
                continue                     # still running
            req.done = True
            alloc.free(req.req_id)
            self.slot_req[b] = None
            self._gen_cap[b] = None
            self.finished[b] = True
            self.completed[req.req_id] = req.output
            done.append(req)
        return done

    # ---- admission (host-known free slots only; frees appear at drains) ----
    def _admit(self):
        free = [b for b in range(self.B) if self.slot_req[b] is None]
        if not free or not self.waiting:
            return
        g = self.g
        alloc = g.cache.allocator
        admitted = []
        while free and self.waiting:
            req = self.waiting[0]
            # truncate ONCE here; every later length derives from it
            req.prompt = req.prompt[: g.max_seq_len - 1]
            need = -(-len(req.prompt) // g.page_size)
            if alloc.free_pages < need:
                if len(free) == self.B and not admitted \
                        and need > alloc.num_pages:
                    raise MemoryError(
                        f"prompt needs {need} pages but the pool only "
                        f"has {alloc.num_pages}; raise num_pages or "
                        "page_size")
                break                         # wait for pages to free up
            self.waiting.popleft()
            b = free.pop(0)
            alloc.allocate(req.req_id, len(req.prompt))
            admitted.append((b, req))
        if not admitted:
            return
        mask = np.zeros((self.B,), bool)
        budgets = self._budgets_np
        for b, req in admitted:
            self.slot_req[b] = req
            self.prompt_pos[b] = 0
            self.host_lens[b] = 0
            mask[b] = True
            budgets[b] = req.max_new_tokens
            self._bt[b] = alloc.block_table(
                [req.req_id], max_pages=g.pages_per_seq)[0]
        m = g.upload(mask)
        zero = torch.zeros((), dtype=torch.int32, device=g.device)
        self.positions = torch.where(m, zero, self.positions)
        self.counts = torch.where(m, zero, self.counts)
        self.budgets = g.upload(budgets)
        self.finished = self.finished & ~m
        self._bt_dev = g.upload(self._bt)
