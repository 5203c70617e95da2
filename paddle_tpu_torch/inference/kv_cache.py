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
- **Host**: a free-list page allocator (plain Python) producing the int32
  block tables the kernel consumes.

Pages are ref-counted: a page returns to the free list only when its last
reference drops, and releasing a free page raises (the double-free guard).
The host spill tier of the reference waits for the prefix cache.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.llama import torch_dtype


class PageAllocator:
    """Free-list allocator mapping sequence ids to ref-counted page lists.

    The pool may be sized below the dense ``max_batch * pages_per_seq``
    worst case: freed pages recycle through the free list, the engine holds
    admission back on pressure and finalizes a sequence early when its
    decode growth finds the pool dry; ``stats()`` reports the high-water
    mark."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: List[int] = [0] * num_pages     # per-page reference count
        self._pages: Dict[int, List[int]] = {}     # seq id -> page ids
        self._lens: Dict[int, int] = {}            # seq id -> token count
        self.peak_in_use = 0
        self.cow_copies = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def stats(self) -> Dict[str, int]:
        return {"num_pages": self.num_pages,
                "pages_in_use": self.pages_in_use,
                "peak_in_use": self.peak_in_use,
                "active_seqs": len(self._pages),
                "cow_copies": self.cow_copies}

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
        if not self._free:
            raise MemoryError(
                f"KV cache exhausted: {self.num_pages} pages in use")
        p = self._free.pop()
        self._ref[p] = 1
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
        except (MemoryError, ValueError):
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
        return src, dst

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


class PagedKVCache:
    """Device KV pool for all layers + the allocator that addresses it."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, dtype="bfloat16",
                 device=None):
        self.num_layers = num_layers
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.quantized = str(dtype) == "int8"
        if self.quantized:
            # + 1: the scratch page of the quantized commit (never handed out)
            shape = (num_layers, num_kv_heads, num_pages + 1, page_size,
                     head_dim)
            self.k = torch.zeros(shape, dtype=torch.int8, device=device)
            self.v = torch.zeros(shape, dtype=torch.int8, device=device)
            # all-zero pages dequantize to exactly 0 under any scale; 1.0
            # keeps untouched pages' dequant well-defined
            self.k_scale = torch.ones(shape[:3], dtype=torch.float32,
                                      device=device)
            self.v_scale = torch.ones(shape[:3], dtype=torch.float32,
                                      device=device)
        else:
            shape = (num_layers, num_kv_heads, num_pages, page_size,
                     head_dim)
            dt = torch_dtype(dtype)
            self.k = torch.zeros(shape, dtype=dt, device=device)
            self.v = torch.zeros(shape, dtype=dt, device=device)
            self.k_scale = None
            self.v_scale = None
        self.allocator = PageAllocator(num_pages, page_size)

    @property
    def arrays(self):
        """The device state of one engine step: ``(k, v)`` for a float
        pool, ``(k, v, k_scale, v_scale)`` when quantized."""
        if self.quantized:
            return self.k, self.v, self.k_scale, self.v_scale
        return self.k, self.v

    @staticmethod
    def bytes_per_page(num_layers: int, num_kv_heads: int, page_size: int,
                       head_dim: int, dtype="bfloat16") -> int:
        """Device bytes one pool page costs (K + V + scales, all layers)."""
        per = num_layers * num_kv_heads
        if str(dtype) == "int8":
            return 2 * per * (page_size * head_dim + 4)
        itemsize = torch.empty((), dtype=torch_dtype(dtype)).element_size()
        return 2 * per * page_size * head_dim * itemsize
