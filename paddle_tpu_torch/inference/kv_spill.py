"""Pinned host-memory spill tier for the paged KV pool (port of
``paddle_tpu/inference/kv_spill.py``).

Pool pages bound the serving stack: resident sessions and prefix-cache
capacity compete for the same pages.  Without this tier the prefix cache's
LRU eviction drops an evicted page's KV, and the next request sharing that
prefix pays a full re-prefill.  With it, eviction demotes the page:

- **Spill (evict)**: when the allocator's reclaim pass evicts an idle
  cached page, its bytes (every layer's K and V rows and, on the int8 pool,
  their fp32 scales) are copied device to host into a fixed ring of
  ``capacity`` page slots in page-locked memory, the device page returns to
  the free list, and the radix node stays indexed, marked *spilled*.  The
  copy runs on the engine's stream and then waits for it: the tier's one
  intended host<->device sync, on the eviction path, never on a warm step.
- **Swap-in (admission)**: a prompt that matches a spilled node gets a
  fresh device page and the slot's bytes are copied up with
  ``non_blocking=True`` on the same stream, ahead of the consumer's first
  prefill chunk, so the stream's order alone makes the page whole before
  any later step reads it.  An event recorded after the copy lets
  :meth:`HostSpillPool.peek` wait for it; a later spill into the slot is a
  copy on the same stream, ordered after the upload.
- **Ring pressure**: a full ring drops its coldest spilled node (the
  policy lives in :class:`~.prefix_cache.PrefixCache`).

The ring is sized once, at engine build, and never grows: one pinned
tensor per pool plane, ``[capacity, layers, kv_heads, page, head_dim]`` for
K and V and ``[capacity, layers, kv_heads]`` for each int8 scale plane.
Its slots are host-global under tensor parallelism: a spill copies each
shard's head block into the slot and a swap-in copies it back, so the
ring's bytes are the same at any shard count.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import observability as _obs

# swap-in host-time histogram ladder (ms)
_SWAPIN_BOUNDS = [0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0]


class HostSpillPool:
    """Fixed ring of pinned host page slots and the page copies in and out
    of the pool.  The policy (which page spills, which node swaps in, LRU
    order) lives in the prefix cache."""

    def __init__(self, cache, capacity: int):
        self.cache = cache               # PagedKVCache (live planes)
        self.capacity = int(capacity)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._used: Dict[int, None] = {}
        self._dev = cache.devices[0]
        cuda = self._dev.type == "cuda"
        # one page of every plane per slot: [L, kvh, page, d] / [L, kvh]
        self._ring = tuple(
            torch.empty((self.capacity,) + shape, dtype=dt, pin_memory=cuda)
            for shape, dt in cache.page_shapes())
        self._uploads: Dict[int, "torch.cuda.Event"] = {}
        self.spilled_pages = 0           # cumulative spills
        self.swapins = 0                 # cumulative swap-ins
        self.swapin_host_ms = 0.0        # host time spent enqueuing swap-ins
        m = _obs.metrics
        self._c_spilled = m.counter("serving.kv.spilled_pages")
        self._c_swapins = m.counter("serving.kv.swapins")
        self._h_wait = m.histogram("serving.kv.swapin_wait_ms",
                                   bounds=_SWAPIN_BOUNDS)

    @property
    def ring_bytes(self) -> int:
        """Pinned host bytes the ring holds."""
        return sum(r.numel() * r.element_size() for r in self._ring)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def resident(self) -> int:
        """Spilled pages currently held in the ring."""
        return len(self._used)

    def stats(self) -> Dict[str, int]:
        return {"kv_spill_capacity": self.capacity,
                "kv_spill_resident": self.resident,
                "kv_spilled_pages": self.spilled_pages,
                "kv_swapins": self.swapins}

    # ---- device -> host (eviction) ----
    def spill(self, page_id: int) -> Optional[int]:
        """Copy device page ``page_id`` (all layers, K + V + scales) into a
        free ring slot and return the slot id; None when the ring is full
        (the caller may drop a colder spilled node and retry).

        The blocking copy is the tier's one intended sync: it waits for
        every write to the page enqueued before it, so the slot holds
        exactly the bytes the pool held."""
        if not self._free:
            return None
        slot = self._free.pop()
        _obs.count_sync()                # eviction-path page readback
        self.cache.read_page(page_id, [ring[slot] for ring in self._ring])
        self._used[slot] = None
        self.spilled_pages += 1
        self._c_spilled.inc()
        return slot

    # ---- host -> device (admission) ----
    def swap_in(self, slot: int, page_id: int) -> None:
        """Copy slot ``slot``'s bytes into device page ``page_id`` and retire
        the slot.  Enqueued without a host wait, on the stream every pool
        write uses, so the page is whole before any later step reads it."""
        del self._used[slot]
        t0 = time.perf_counter()
        self.cache.install_page(page_id, [ring[slot] for ring in self._ring],
                                non_blocking=True)
        if self._dev.type == "cuda":
            # the slot's one upload reads the ring on shard 0's stream
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self._dev))
            self._uploads[slot] = ev
        ms = (time.perf_counter() - t0) * 1e3
        self.swapin_host_ms += ms
        self._h_wait.observe(ms)
        self._free.append(slot)
        self.swapins += 1
        self._c_swapins.inc()

    def peek(self, slot: int) -> Tuple[torch.Tensor, ...]:
        """A spilled page's host planes, without retiring the slot (session
        migration ships a spilled page's host bytes directly).  Waits for
        an upload still reading the slot."""
        ev = self._uploads.pop(slot, None)
        if ev is not None:
            _obs.count_sync()            # waits for the slot's upload
            ev.synchronize()
        if slot not in self._used:
            raise KeyError(f"spill slot {slot} holds no page")
        return tuple(ring[slot] for ring in self._ring)

    def free_slot(self, slot: int) -> None:
        """Retire a spilled page without swapping it in (its node was
        dropped from the index: ring pressure or a trie unlink)."""
        del self._used[slot]
        self._free.append(slot)
