"""Paged KV cache: device page pool + host page allocator (port of
``paddle_tpu/inference/kv_cache.py``).

- **Device**: one K and one V pool, head-major
  ``[layers, kv_heads, num_pages, page_size, head_dim]``.  A layer's slice
  ``pool[l]`` is a contiguous ``[kv_heads, num_pages, page_size, head_dim]``
  tensor, the layout the ragged paged-attention kernel reads.  The engine
  step reads the pool and commits fresh rows in place once, at its end.
- **int8 plane** (``dtype="int8"``): int8 K/V pools plus fp32 scale planes
  ``[layers, kv_heads, num_pages]`` (one absmax scale per (layer, kv-head,
  page)).  Each int8 plane holds one physical scratch page past
  ``num_pages`` that the allocator never hands out: the quantized commit
  writes its dropped window entries there instead of over a real page.
- **Shards** (``devices=``, tensor-parallel serving): each shard stores
  its block of kv heads of every plane on its own device; page ids and
  everything host-side stay global.
- **Host**: a free-list page allocator (plain Python) producing the int32
  block tables the kernel consumes.

Pages are ref-counted: a page returns to the free list only when its last
reference drops, and releasing a free page raises (the double-free guard).
A prefix cache (``inference/prefix_cache.py``) shares pages between
sequences and registers itself as the allocator's reclaimer, so idle cached
pages are evicted exactly when an allocation finds the free list empty.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.llama import torch_dtype


def _serving_bump(key: str, n: int = 1) -> None:
    """Mirror a pool counter into the process-wide registry counter
    ``serving.<key>`` (what ``prefix_cache.serving_stats()`` and
    ``observability.snapshot()`` read).  The allocator is the one place
    each counter increments, so the per-engine and process-wide books
    cannot diverge."""
    from ..observability import metrics as _metrics
    _metrics.counter("serving." + key).inc(n)


class PageAllocator:
    """Free-list allocator mapping sequence ids to ref-counted page lists.

    The pool may be sized below the dense ``max_batch * pages_per_seq``
    worst case: freed pages recycle through the free list, the engine holds
    admission back on pressure and finalizes a sequence early when its
    decode growth finds the pool dry; ``stats()`` reports the high-water
    mark.

    With a prefix cache attached (:meth:`set_reclaimer`) the allocator asks
    the cache to evict idle cached pages back into the free list before it
    declares the pool exhausted."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: List[int] = [0] * num_pages     # per-page reference count
        self._pages: Dict[int, List[int]] = {}     # seq id -> page ids
        self._lens: Dict[int, int] = {}            # seq id -> token count
        self.peak_in_use = 0
        # the prefix cache's hooks: evict idle cached pages on demand /
        # count how many could be evicted right now
        self._reclaim: Optional[Callable[[int], int]] = None
        self._evictable: Optional[Callable[[], int]] = None
        # prefix-cache telemetry (all stay 0 with the cache off)
        self.prefix_hits = 0          # admissions that reused cached pages
        self.prefix_tokens_saved = 0  # prompt tokens whose prefill was skipped
        self.cow_copies = 0           # shared pages privatized copy-on-write
        self.evicted_pages = 0        # cached pages reclaimed under pressure

    def set_reclaimer(self, reclaim: Callable[[int], int],
                      evictable: Callable[[], int]) -> None:
        """Attach an eviction source: ``reclaim(n)`` moves up to ``n`` idle
        cached pages back to the free list (returns how many it moved);
        ``evictable()`` counts the pages reclaim could free right now."""
        self._reclaim = reclaim
        self._evictable = evictable

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages obtainable right now: free list + evictable cached pages."""
        extra = self._evictable() if self._evictable is not None else 0
        return len(self._free) + extra

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def stats(self) -> Dict[str, int]:
        """Pool telemetry: live and peak page use, active sequences, and
        the prefix-cache counters (all 0 with the cache off)."""
        return {"num_pages": self.num_pages,
                "pages_in_use": self.pages_in_use,
                "peak_in_use": self.peak_in_use,
                "active_seqs": len(self._pages),
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_saved": self.prefix_tokens_saved,
                "cow_copies": self.cow_copies,
                "evicted_pages": self.evicted_pages}

    def context_len(self, seq_id: int) -> int:
        return self._lens[seq_id]

    def page_list(self, seq_id: int) -> List[int]:
        return list(self._pages[seq_id])

    def ref_count(self, page: int) -> int:
        return self._ref[page]

    # ---- page-level refcounting ----
    def retain(self, page: int) -> None:
        if self._ref[page] <= 0:
            raise ValueError(f"page {page} is free; cannot retain it")
        self._ref[page] += 1

    def release_page(self, page: int) -> None:
        if self._ref[page] <= 0:
            raise ValueError(f"page {page} is already free (double free)")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)

    def _alloc_page(self) -> int:
        if not self._free and self._reclaim is not None:
            self._reclaim(1)
        if not self._free:
            raise MemoryError(
                f"KV cache exhausted: {self.num_pages} pages in use")
        p = self._free.pop()
        if self._ref[p] != 0:
            raise RuntimeError(f"free-list page {p} has live references")
        self._ref[p] = 1
        return p

    def acquire_page(self) -> int:
        """Allocate one standalone page holding a single reference (the
        spill tier's swap-in target; the holder releases it with
        :meth:`release_page`).  Reclaims from the prefix cache under
        pressure like any other allocation; raises MemoryError when dry."""
        p = self._alloc_page()
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return p

    def _grow(self, seq_id: int, new_len: int) -> None:
        pages = self._pages[seq_id]
        need = -(-new_len // self.page_size)       # ceil
        while len(pages) < need:
            pages.append(self._alloc_page())
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        self._lens[seq_id] = new_len

    def allocate(self, seq_id: int, num_tokens: int,
                 shared_pages: Sequence[int] = ()) -> np.ndarray:
        """Register a new sequence with ``num_tokens`` tokens (``shared_pages``
        attached first with a reference each).  Rolled back completely if
        the pool runs dry.  Returns the flat slot ids of its tokens."""
        if seq_id in self._pages:
            raise ValueError(f"sequence {seq_id} already allocated")
        pages: List[int] = []
        self._pages[seq_id] = pages
        self._lens[seq_id] = 0
        try:
            for p in shared_pages:
                self.retain(p)
                pages.append(p)
            self._grow(seq_id, num_tokens)
        except BaseException:
            for p in pages:
                self.release_page(p)
            del self._pages[seq_id]
            del self._lens[seq_id]
            raise
        return self.slots(seq_id, 0, num_tokens)

    def extend(self, seq_id: int, num_tokens: int = 1) -> np.ndarray:
        """Append token slots to an existing sequence (decode growth)."""
        start = self._lens[seq_id]
        self._grow(seq_id, start + num_tokens)
        return self.slots(seq_id, start, num_tokens)

    def truncate(self, seq_id: int, num_tokens: int) -> int:
        """Shrink a sequence's page list to cover ``num_tokens``; each
        dropped page loses this sequence's one reference.  Returns the
        number of references dropped."""
        pages = self._pages[seq_id]
        keep = max(0, -(-int(num_tokens) // self.page_size))
        dropped = pages[keep:]
        del pages[keep:]
        for p in dropped:
            self.release_page(p)
        self._lens[seq_id] = min(self._lens[seq_id], int(num_tokens))
        return len(dropped)

    def cow(self, seq_id: int, page_index: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: swap a shared page (refcount > 1) for a fresh one
        and return ``(src, dst)`` (the caller copies the page); None when
        the page is already exclusive."""
        pages = self._pages[seq_id]
        src = pages[page_index]
        if self._ref[src] <= 1:
            return None
        dst = self._alloc_page()
        pages[page_index] = dst
        self.release_page(src)
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        self.cow_copies += 1
        _serving_bump("cow_copies")
        return src, dst

    def record_prefix_hit(self, tokens_saved: int) -> None:
        """Count one admission that reused cached pages (both books)."""
        self.prefix_hits += 1
        self.prefix_tokens_saved += tokens_saved
        _serving_bump("prefix_hits")
        _serving_bump("prefix_tokens_saved", tokens_saved)

    def record_evictions(self, n: int = 1) -> None:
        """Count cached pages reclaimed under pressure (both books)."""
        self.evicted_pages += n
        _serving_bump("evicted_pages", n)

    def slots(self, seq_id: int, start: int, count: int) -> np.ndarray:
        pages = self._pages[seq_id]
        pos = np.arange(start, start + count)
        page_ids = np.asarray(pages, np.int32)[pos // self.page_size]
        return (page_ids * self.page_size + pos % self.page_size).astype(np.int32)

    def free(self, seq_id: int) -> None:
        """Release the sequence's reference on every page (not idempotent:
        an unknown ``seq_id`` raises KeyError)."""
        if seq_id not in self._pages:
            raise KeyError(
                f"seq id {seq_id} not allocated (double free or never "
                "allocated)")
        for p in self._pages.pop(seq_id):
            self.release_page(p)
        del self._lens[seq_id]

    def release(self, seq_id: int) -> None:
        """Alias of :meth:`free` (same contract, same KeyError)."""
        self.free(seq_id)

    def block_table(self, seq_ids: Sequence[int],
                    max_pages: Optional[int] = None) -> np.ndarray:
        """[batch, max_pages] int32 table, padded with page 0 (the kernel
        masks by context length, so pad entries are never read)."""
        rows = [self._pages[s] for s in seq_ids]
        width = max_pages if max_pages is not None else max(
            (len(r) for r in rows), default=1)
        width = max(width, 1)
        out = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            if len(r) > width:
                raise ValueError(
                    f"sequence needs {len(r)} pages > table width {width}")
            out[i, :len(r)] = r
        return out

    def context_lens(self, seq_ids: Sequence[int]) -> np.ndarray:
        return np.asarray([self._lens[s] for s in seq_ids], np.int32)


class PagedKVCache:
    """Device KV pool for all layers + the allocator that addresses it.

    ``devices`` (default ``[device]``) lists one device per tensor-parallel
    shard, repeats allowed.  Page *storage* is shard-local: shard ``s``
    holds kv heads ``[s·kvh/tp, (s+1)·kvh/tp)`` of every plane on
    ``devices[s]`` (:attr:`shards`), while page ids, block tables, the
    allocator, the prefix cache and the spill ring stay host-global.
    :meth:`page_planes`, :meth:`read_page` and :meth:`install_page` move
    one page as its host-global planes (``[L, kvh, page, d]`` K and V,
    ``[L, kvh]`` int8 scales), so migration snapshots and spill bytes are
    the same at any shard count."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, dtype="bfloat16",
                 device=None, devices=None):
        self.num_layers = num_layers
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.quantized = str(dtype) == "int8"
        self.devices = [torch.device("cpu" if d is None else d) for d in
                        (devices if devices is not None else [device])]
        self.tp = len(self.devices)
        if num_kv_heads % self.tp:
            raise ValueError(
                f"num_kv_heads={num_kv_heads} not divisible by "
                f"tensor-parallel degree {self.tp}")
        heads = num_kv_heads // self.tp
        # + 1 on the int8 pool: the scratch page of the quantized commit
        # (never handed out), one a shard
        pages = num_pages + 1 if self.quantized else num_pages
        shape = (num_layers, heads, pages, page_size, head_dim)
        dt = torch.int8 if self.quantized else torch_dtype(dtype)
        self.shards: List[Tuple[torch.Tensor, ...]] = []
        for dev in self.devices:
            planes = (torch.zeros(shape, dtype=dt, device=dev),
                      torch.zeros(shape, dtype=dt, device=dev))
            if self.quantized:
                # all-zero pages dequantize to exactly 0 under any scale;
                # 1.0 keeps untouched pages' dequant well-defined
                planes += (torch.ones(shape[:3], dtype=torch.float32,
                                      device=dev),
                           torch.ones(shape[:3], dtype=torch.float32,
                                      device=dev))
            self.shards.append(planes)
        if self.quantized:
            # pool bytes saved against an equal-page fp32 pool (K and V,
            # minus the scale planes)
            per = num_layers * num_kv_heads * num_pages
            saved = 2 * (per * page_size * head_dim * 3 - per * 4)
            _serving_bump("kv.quant_bytes_saved", max(saved, 0))
        self.allocator = PageAllocator(num_pages, page_size)

    @property
    def arrays(self):
        """The device state of one engine step at tp=1: ``(k, v)`` for a
        float pool, ``(k, v, k_scale, v_scale)`` when quantized.  A sharded
        pool has no single tuple: read :attr:`shards`, or move pages with
        the host-global accessors."""
        if self.tp != 1:
            raise RuntimeError(
                f"a pool of {self.tp} shards has no single plane tuple: "
                "read .shards or use page_planes / install_page")
        return self.shards[0]

    @property
    def k(self):
        return self.arrays[0]

    @property
    def v(self):
        return self.arrays[1]

    @property
    def k_scale(self):
        return self.arrays[2] if self.quantized else None

    @property
    def v_scale(self):
        return self.arrays[3] if self.quantized else None

    @property
    def kv_dtype(self) -> torch.dtype:
        """The K/V planes' storage dtype (``torch.int8`` when quantized)."""
        return self.shards[0][0].dtype

    def heads(self, shard: int) -> slice:
        """The global kv heads shard ``shard`` stores."""
        h = self.num_kv_heads // self.tp
        return slice(shard * h, (shard + 1) * h)

    def page_shapes(self) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of each host-global page plane, in
        :meth:`page_planes` order."""
        out = []
        for arr in self.shards[0]:
            shape = (arr.shape[0], self.num_kv_heads) + tuple(arr.shape[3:])
            out.append((shape, arr.dtype))
        return out

    def page_planes(self, page_id: int, device=None) -> Tuple[torch.Tensor,
                                                             ...]:
        """Page ``page_id``'s host-global planes as fresh tensors on
        ``device`` (default: shard 0's): each plane's shards joined on the
        head axis in shard order."""
        dev = self.devices[0] if device is None else device
        return tuple(
            torch.cat([shard[i][:, :, page_id].to(dev) for shard in
                       self.shards], dim=1)
            for i in range(len(self.shards[0])))

    def read_page(self, page_id: int, out: Sequence[torch.Tensor]) -> None:
        """Copy page ``page_id``'s planes into the host-global ``out``
        planes (a blocking copy when ``out`` is on the host)."""
        for s, shard in enumerate(self.shards):
            blk = self.heads(s)
            for dst, arr in zip(out, shard):
                dst[:, blk].copy_(arr[:, :, page_id])

    def install_page(self, page_id: int, planes: Sequence[torch.Tensor],
                     non_blocking: bool = False) -> None:
        """Copy host-global ``planes`` into page ``page_id``, each shard
        its head block, on the current streams.  Under shards a plane goes
        to shard 0's device whole first, so the per-shard head blocks are
        device copies."""
        for i, p in enumerate(planes):
            if self.tp > 1:
                p = p.to(self.devices[0], non_blocking=non_blocking)
            for s, shard in enumerate(self.shards):
                shard[i][:, :, page_id].copy_(p[:, self.heads(s)],
                                              non_blocking=non_blocking)

    @staticmethod
    def bytes_per_page(num_layers: int, num_kv_heads: int, page_size: int,
                       head_dim: int, dtype="bfloat16") -> int:
        """Device bytes one pool page costs (K + V + scales, all layers,
        all shards)."""
        per = num_layers * num_kv_heads
        if str(dtype) == "int8":
            return 2 * per * (page_size * head_dim + 4)
        itemsize = torch.empty((), dtype=torch_dtype(dtype)).element_size()
        return 2 * per * page_size * head_dim * itemsize
