"""Prefix cache: ref-counted shared KV pages with radix lookup, COW, LRU
(port of ``paddle_tpu/inference/prefix_cache.py``).

Serving traffic is dominated by shared prefixes: system prompts, few-shot
templates, multi-turn histories.  The paged pool already gives every
sequence page indirection, so sharing KV across sequences is bookkeeping: a
prompt that starts with an already-cached token run points its block table
at the shared pages (a reference each in ``PageAllocator``) and starts its
chunked prefill at the first uncached token, with the ragged paged-attention
kernel unchanged.

- **Index**: a trie whose edges are whole token *pages*, so a match is
  always page-aligned, the granularity a block table can share.  A node owns
  one physical page and the cache's own allocator reference on it.
- **Pending vs ready**: admission indexes a prompt's full pages *before*
  their KV is written (identical prompts admitted together still share); a
  row that matched pending pages is gated by the engine until the producer's
  prefill has been enqueued past them.  Work on the card runs in the order it
  was enqueued on the engine's one stream, so that is the whole ordering
  guarantee, with no host sync.
- **Copy-on-write**: a fully cached prompt still re-prefills its last token
  (only KV is cached, not logits), which writes inside the final shared
  page, so that page is privatized by ``PageAllocator.cow`` and one page
  copy the engine enqueues.
- **LRU free-pool**: when the last sequence using a node retires, the node
  stays indexed but becomes *idle*, in an LRU pool the allocator reclaims
  from (leaf first, oldest first) only when an allocation needs pages.  A
  sequence always holds a root-chain prefix of nodes, so an idle node's
  whole subtree is idle and ``len(idle)`` is exactly the evictable count.
- **Spill tier**: with a :class:`~.kv_spill.HostSpillPool` attached, an
  evicted page's bytes move to pinned host memory and its node stays
  indexed; a later match copies them back.

``block_hashes`` and :meth:`PrefixCache.digest` give the reference's hex
(blake2b chain hashes), since routers score replicas by those digests.
Nothing here runs unless the engine's ``prefix_cache=`` argument (or the
``prefix_cache`` flag) turns it on.
"""

from __future__ import annotations

import hashlib
import os
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from .. import flags
from ..controlplane.sketch import CountingBloom

# process-wide prefix-cache counters: ``serving.*`` registry series, summed
# over every engine in the process.  Each increment happens inside the
# allocator (``kv_cache._serving_bump``), which also keeps the per-engine
# books of ``PageAllocator.stats()``, so the two never diverge.
_SERVING_KEYS = ("prefix_hits", "prefix_tokens_saved", "cow_copies",
                 "evicted_pages")


def serving_stats() -> Dict[str, int]:
    """Process-wide prefix-cache counters (all engines summed), a view of
    the ``serving.*`` registry series."""
    from ..observability import metrics as _metrics
    return {k: int(_metrics.counter("serving." + k).value)
            for k in _SERVING_KEYS}


# ---------------------------------------------------------------------------
# Residency digest: stable chain hashes over token pages.
#
# Each cached page is identified by the hash chain of its WHOLE root path
# (parent chain digest + this page's token block), so digest membership of
# block k implies the full k-page prefix is resident — exactly the radix
# index's match semantics, collapsed to O(1) set lookups.  The router
# computes the same chain over an incoming prompt (``block_hashes``) and
# scores each replica by its longest leading match against the replica's
# advertised digest.  blake2b/8-byte keeps the wire size per entry at 16
# hex chars and is stable across processes and hosts (no PYTHONHASHSEED).
# ---------------------------------------------------------------------------

_DIGEST_ALGO = "blake2b8-chain"


def _chain(parent: bytes, tokens: Sequence[int]) -> bytes:
    blk = ",".join(str(int(t)) for t in tokens).encode()
    return hashlib.blake2b(parent + b"|" + blk, digest_size=8).digest()


def block_hashes(tokens: Sequence[int], page_size: int,
                 limit: Optional[int] = None) -> List[str]:
    """Chain hashes (hex) of the prompt's full token pages, in order.

    ``block_hashes(p, s)[k-1]`` identifies the k-page prefix of ``p``:
    the same value a :class:`PrefixCache` holding that prefix reports in
    its :meth:`~PrefixCache.digest`.  Partial trailing pages are not
    hashed (the index is page-granular)."""
    page = int(page_size)
    n = len(tokens) // page
    if limit is not None:
        n = min(n, int(limit))
    out: List[str] = []
    h = b""
    for i in range(n):
        h = _chain(h, tokens[i * page:(i + 1) * page])
        out.append(h.hex())
    return out


class _Node:
    """One cached page: an edge of the radix index.

    ``active`` counts live sequences holding this node (matched at
    admission, or the producer that inserted it); ``ready`` flips once
    the producer's prefill has dispatched the page's KV writes.  A node
    with ``active == 0`` and ``ready`` sits in the LRU idle pool.

    With a spill tier attached, an evicted node may be
    *spilled* instead of dropped: ``page`` becomes -1 and ``spill``
    holds its host-ring slot until an admission match swaps it back in.
    Spill only happens to idle device-leaves (nodes whose children, if
    any, are themselves spilled), so a spilled node's children are
    always spilled and a matched chain's spilled nodes form a
    contiguous tail run.
    """

    __slots__ = ("tokens", "page", "end", "parent", "children", "active",
                 "ready", "chain", "spill")

    def __init__(self, tokens: Tuple[int, ...], page: int, end: int,
                 parent: Optional["_Node"]):
        self.tokens = tokens       # this page's token block (the trie key)
        self.page = page           # physical page id in the pool
        self.end = end             # prompt offset one past this page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.active = 0
        self.ready = False
        self.spill = None          # host-ring slot id when spilled
        # root-path chain digest: membership in a residency digest implies
        # the whole prefix up to ``end`` is resident (see block_hashes)
        self.chain = _chain(parent.chain, tokens) if parent is not None \
            else b""


class MatchPlan:
    """A prompt's admission plan against the index (read-only until
    ``attach``): the matched node chain, where prefill starts, whether
    the final shared page needs COW, and the fresh-page demand."""

    __slots__ = ("nodes", "start", "cow", "fresh_pages", "wait",
                 "idle_matched")

    def __init__(self, nodes, start, cow, fresh_pages, wait, idle_matched):
        self.nodes: List[_Node] = nodes
        self.start: int = start            # first token prefill must compute
        self.cow: bool = cow               # privatize the last matched page
        self.fresh_pages: int = fresh_pages  # free-list demand at admission
        self.wait: List[_Node] = wait      # still-pending matched nodes
        self.idle_matched: int = idle_matched  # matched nodes now idle


class PrefixCache:
    """Radix index over cached KV pages + the LRU eviction pool.

    Owns one allocator reference per indexed page (so retired sequences'
    pages survive in the pool) and registers itself as the allocator's
    reclaimer (so those pages are evicted — leaf-first, LRU order — the
    moment admission or decode growth actually needs them).
    """

    def __init__(self, allocator, page_size: int, min_pages: int = 1):
        self.alloc = allocator
        self.page = int(page_size)
        self.min_pages = max(1, int(min_pages))
        self._root = _Node((), -1, 0, None)
        self._root.ready = True
        self._seq_nodes: Dict[int, List[_Node]] = {}
        self._seq_pending: Dict[int, List[_Node]] = {}
        # idle pool: insertion order IS the LRU order (oldest first)
        self._idle: Dict[_Node, None] = {}
        # spill tier: evicted-but-host-resident nodes, same
        # insertion-order-is-LRU idiom; None until set_spill() attaches
        self._spill_pool = None
        self._spilled: Dict[_Node, None] = {}
        # digest DELTA sync: every index membership change
        # (insert / unlink) bumps ``digest_epoch`` and lands in a bounded
        # change log, so a router that confirmed epoch E gets only the
        # adds/evictions since E instead of the full re-shipped set.
        # ``digest_gen`` nonces the epoch space per cache instance — a
        # restarted replica's epoch 50 is NOT the old process's epoch 50,
        # and a gen mismatch forces a full resync.
        log_cap = int(flags.flag("prefix_digest_log"))
        self.digest_gen = f"{os.getpid():x}-{os.urandom(4).hex()}"
        self.digest_epoch = 0
        self._digest_log: "deque" = deque(maxlen=max(0, log_cap) or None)
        self._digest_log_on = log_cap > 0
        # digest SKETCH: a counting-Bloom maintained on the
        # same membership-change hook, so past the size threshold a
        # /statusz poll ships m/8 flat bitmap bytes instead of one hash
        # per resident page.  Counters exist for removal; the wire form
        # is membership-only.
        self._sketch = CountingBloom() \
            if flags.flag("router_digest_sketch") else None
        allocator.set_reclaimer(self._reclaim, self.evictable_pages)

    # ---------------------------------------------- digest delta
    def _log_digest(self, op: str, node: "_Node") -> None:
        """Record one membership change (op '+'/'-') at a fresh epoch."""
        self.digest_epoch += 1
        if self._digest_log_on:
            self._digest_log.append((self.digest_epoch, op,
                                     node.chain.hex()))
        if self._sketch is not None:
            if op == "+":
                self._sketch.add(node.chain.hex())
            else:
                self._sketch.remove(node.chain.hex())

    def sketch_wire(self):
        """Wire form of the digest sketch (``None`` when sketching is
        off).  O(m/8) to serialize regardless of resident-page count —
        the flat-bytes property the sharded control plane ships past
        ``FLAGS_router_digest_sketch_threshold``."""
        return self._sketch.wire() if self._sketch is not None else None

    def digest_delta(self, since: int):
        """Adds/evictions since confirmed epoch ``since`` → ``(adds,
        dels)`` hash-hex lists, or None when the delta is not servable
        (epoch from another life, or older than the log covers — the
        caller must fall back to a full-set resync).  Safe from the
        statusz thread: iterates a GIL-atomic ``list()`` snapshot of the
        log while the engine thread appends."""
        since = int(since)
        if since == self.digest_epoch:
            return [], []
        if since > self.digest_epoch or not self._digest_log_on:
            return None
        log = list(self._digest_log)
        if not log or log[0][0] > since + 1:
            return None                     # log no longer covers `since`
        adds: Dict[str, None] = {}
        dels: Dict[str, None] = {}
        for epoch, op, h in log:
            if epoch <= since:
                continue
            if op == "+":
                dels.pop(h, None)
                adds[h] = None
            elif h in adds:
                del adds[h]                 # added then evicted: net zero
            else:
                dels[h] = None
        return list(adds), list(dels)

    def set_spill(self, pool) -> None:
        """Attach a :class:`~paddle_tpu_torch.inference.kv_spill.HostSpillPool`:
        LRU evictions now demote pages to host RAM instead of dropping
        them, and admission matches on spilled nodes swap them back."""
        self._spill_pool = pool

    # ------------------------------------------------------------- lookup
    def plan(self, tokens: Sequence[int]) -> MatchPlan:
        """Longest page-aligned cached prefix of ``tokens`` → MatchPlan.

        A full-prompt match keeps all pages but re-prefills the final
        token (only KV is cached; the first sampled token needs logits),
        so the last page goes copy-on-write.  Matches shorter than
        ``min_pages`` pages are treated as misses.
        """
        page = self.page
        n = len(tokens)
        node, nodes = self._root, []
        i = 0
        while i + page <= n:
            child = node.children.get(tuple(tokens[i:i + page]))
            if child is None:
                break
            nodes.append(child)
            node = child
            i += page
        cow = False
        start = i
        if nodes and i >= n:          # fully cached: recompute the last token
            cow = True
            start = n - 1
        if len(nodes) < self.min_pages:
            nodes, start, cow = [], 0, False
        # spilled matches (a contiguous tail run of the chain) each need
        # a fresh device page for their swap-in; they are NOT evictable
        # supply (no device page to reclaim)
        n_spilled = sum(1 for x in nodes if x.spill is not None)
        fresh = -(-n // page) - len(nodes) + (1 if cow else 0) + n_spilled
        wait = [x for x in nodes if not x.ready]
        idle_matched = sum(1 for x in nodes
                           if x.active == 0 and x.spill is None)
        return MatchPlan(nodes, start, cow, fresh, wait, idle_matched)

    # ------------------------------------------------- admission lifecycle
    def attach(self, plan: MatchPlan) -> None:
        """Pin the matched chain BEFORE allocating fresh pages, so the
        allocator's reclaim pass cannot evict pages this admission is
        about to share.  Spilled matches are swapped back in HERE (after
        the whole chain is pinned, so the swap-in's own page allocation
        cannot reclaim a node this admission needs): a fresh device page
        is acquired and the host bytes are copied up on the engine's
        stream, ordered before the consumer's first prefill chunk by the
        stream's order alone.  Raises MemoryError (after unpinning) if the pool
        cannot supply the swap-in page — callers retry the admission."""
        for x in plan.nodes:
            if x.active == 0:
                self._idle.pop(x, None)
            x.active += 1
        try:
            for x in plan.nodes:
                if x.spill is not None:
                    self._swap_in(x)
        except MemoryError:
            self.detach(plan)
            raise

    def detach(self, plan: MatchPlan) -> None:
        """Undo :meth:`attach` (allocation-failure rollback path).  A
        node swapped in by attach stays live-idle — its KV is back on
        device and valid; a still-spilled node stays in the spill LRU."""
        for x in plan.nodes:
            x.active -= 1
            if x.active == 0 and x.ready and x.spill is None:
                self._idle[x] = None

    def _swap_in(self, x: _Node) -> None:
        """Promote a spilled node back to a live device page."""
        page = self.alloc.acquire_page()
        self._spill_pool.swap_in(x.spill, page)
        self._spilled.pop(x, None)
        x.page = page
        x.spill = None

    def admit(self, seq_id: int, tokens: Sequence[int],
              plan: MatchPlan) -> List[Tuple[int, int]]:
        """Finish admission for an ``attach``-ed plan after the allocator
        registered the sequence (shared pages first, fresh after):
        privatize the COW page, record the hit telemetry, and index the
        prompt's remaining full pages as pending nodes.  Returns the
        device page-copy pairs [(src, dst)] the engine must dispatch
        before the sequence's first prefill chunk."""
        alloc, page = self.alloc, self.page
        cow_pairs: List[Tuple[int, int]] = []
        if plan.cow:
            pair = alloc.cow(seq_id, len(plan.nodes) - 1)
            if pair is not None:
                cow_pairs.append(pair)
        if plan.nodes:
            alloc.record_prefix_hit(plan.start)
        # commit: index the uncovered full pages (pending until this
        # sequence's prefill dispatches their writes), chained off the
        # last matched node
        held = list(plan.nodes)
        pending: List[_Node] = []
        pages = alloc.page_list(seq_id)
        parent = plan.nodes[-1] if plan.nodes else self._root
        for pi in range(len(plan.nodes), len(tokens) // page):
            key = tuple(tokens[pi * page:(pi + 1) * page])
            if key in parent.children:   # raced in by a concurrent admit
                break
            node = _Node(key, pages[pi], (pi + 1) * page, parent)
            alloc.retain(pages[pi])      # the cache's own reference
            parent.children[key] = node
            node.active = 1              # the producer holds it
            self._log_digest("+", node)
            pending.append(node)
            parent = node
        self._seq_nodes[seq_id] = held + pending
        self._seq_pending[seq_id] = list(pending)
        return cow_pairs

    def chain(self, tokens: Sequence[int]) -> List[_Node]:
        """The longest root-chain of indexed nodes matching ``tokens``
        page-by-page — the raw trie walk, with none of :meth:`plan`'s
        admission policy (no min_pages, no COW).  The session-migration
        plane exports from and imports onto this chain."""
        page = self.page
        node, out = self._root, []
        i = 0
        while i + page <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + page]))
            if child is None:
                break
            out.append(child)
            node = child
            i += page
        return out

    def install_node(self, parent: Optional[_Node],
                     key: Sequence[int], page: int) -> _Node:
        """Index one imported KV page (session migration): a
        READY, idle node under ``parent`` (None = root) whose allocator
        reference is the one the caller just acquired via
        ``acquire_page()`` — ownership transfers to the cache, and the
        node lands in the LRU idle pool exactly like a retired
        sequence's page (evictable under pressure, matchable by the
        next admission).  Raises if the edge already exists (callers
        skip existing nodes and keep walking)."""
        parent = parent if parent is not None else self._root
        key = tuple(int(t) for t in key)
        if key in parent.children:
            raise ValueError("node already indexed for this token block")
        node = _Node(key, int(page), parent.end + self.page, parent)
        node.ready = True
        parent.children[key] = node
        self._idle[node] = None
        self._log_digest("+", node)
        return node

    def note_progress(self, seq_id: int, tokens_done: int) -> None:
        """Producer's chunked prefill has dispatched writes for tokens
        [0, tokens_done) — flip its pending nodes up to there to ready."""
        pend = self._seq_pending.get(seq_id)
        if not pend:
            return
        while pend and pend[0].end <= tokens_done:
            pend.pop(0).ready = True

    def release(self, seq_id: int) -> None:
        """Drop a retiring sequence's node references.  Nodes left with no
        active user enter the LRU idle pool (most-recent end); nodes whose
        KV never became ready are unindexed immediately."""
        for x in self._seq_nodes.pop(seq_id, ()):
            x.active -= 1
            if x.active == 0:
                if x.ready:
                    self._idle[x] = None
                else:
                    self._unlink(x)
        self._seq_pending.pop(seq_id, None)

    # ------------------------------------------------------------ eviction
    def evictable_pages(self) -> int:
        """Exact count of pages `_reclaim` could free right now.  A
        sequence always references a root-chain prefix, so every idle
        node's subtree is idle or spilled: reclaim drains the idle pool
        completely, device-leaf-first (spilled descendants hold no
        device page and never block their ancestors)."""
        return len(self._idle)

    def cached_pages(self) -> int:
        """DEVICE pages the index currently pins (idle + in active use);
        spilled nodes hold host bytes, not pool pages — see
        :meth:`spilled_pages`."""
        n = 0
        stack = [self._root]
        while stack:
            x = stack.pop()
            stack.extend(x.children.values())
            if x.spill is None:
                n += 1
        return n - 1                     # minus the root sentinel

    def spilled_pages(self) -> int:
        """Indexed pages currently demoted to the host spill ring."""
        return len(self._spilled)

    def spilled_hashes(self) -> List[str]:
        """Chain hashes (hex) of the spilled-but-swappable nodes — the
        digest subset whose next hit costs a page upload instead of a
        re-prefill (a router scores
        these between resident and absent).  Bounded by the spill ring capacity; the
        ``list()`` snapshot is GIL-atomic against the engine thread
        (same advisory-read contract as ``digest``)."""
        return [n.chain.hex() for n in list(self._spilled)]

    def digest(self, max_entries: int = 4096) -> List[str]:
        """Residency digest: chain hashes (hex) of up to ``max_entries``
        indexed pages, breadth-first from the root so a truncated digest
        keeps the SHALLOW entries — the leading pages the router's
        longest-prefix scoring walks first.  Pending nodes are included:
        their KV is being written by a live producer and will be resident
        by the time a routed request's admission matches them.

        Unlike every other cache read, this one runs on the HTTP/statusz
        thread while the engine thread mutates the index — each
        ``list()`` below is a GIL-atomic snapshot of one children dict
        (no Python callbacks during the C-level copy), so a concurrent
        admit/evict can tear the digest across levels (advisory data)
        but can never raise "dict changed size during iteration"."""
        out: List[str] = []
        frontier = [self._root]
        while frontier and len(out) < max_entries:
            nxt: List[_Node] = []
            for node in frontier:
                for child in list(node.children.values()):
                    out.append(child.chain.hex())
                    if len(out) >= max_entries:
                        return out
                    nxt.append(child)
            frontier = nxt
        return out

    def _reclaim(self, n: int) -> int:
        """Evict up to ``n`` idle pages, leaf-first in LRU order, back to
        the allocator's free list.  Called by the allocator only when the
        free list runs dry."""
        freed = 0
        progress = True
        while freed < n and progress:
            progress = False
            for x in list(self._idle):   # insertion order = oldest first
                # interior: wait for its leaves.  A child demoted to the
                # spill ring holds no device page, so a node whose whole
                # child set is spilled is a device-leaf — evicting it
                # frees a page (and its spilled subtree stays matchable
                # behind it until ring pressure or a drop retires it)
                if any(c.spill is None for c in x.children.values()):
                    continue
                self._evict(x)
                freed += 1
                progress = True
                if freed >= n:
                    break
        return freed

    def _evict(self, x: _Node) -> None:
        del self._idle[x]
        pool = self._spill_pool
        if pool is not None and self.alloc.ref_count(x.page) == 1:
            # demote to host RAM instead of dropping: the device page
            # (cache-exclusively held, or spilling would free nothing)
            # returns to the free list, the node stays indexed
            slot = pool.spill(x.page)
            if slot is None:
                # ring full: drop the coldest unpinned spilled node
                # (strictly colder than the page being demoted) and
                # reuse its slot.  Pinned-but-not-yet-swapped nodes of
                # an in-flight admission are never victims.
                victim = next((s for s in self._spilled
                               if s.active == 0), None)
                if victim is not None:
                    self._unlink(victim)
                    slot = pool.spill(x.page)
            if slot is not None:
                self.alloc.release_page(x.page)
                x.page = -1
                x.spill = slot
                self._spilled[x] = None
                self.alloc.record_evictions(1)
                return
        self._unlink(x)
        self.alloc.record_evictions(1)

    def _unlink(self, x: _Node) -> None:
        # a dropped node orphans its subtree; live children cannot exist
        # here (reclaim is device-leaf-first, ring victims and never-
        # ready nodes are childless-or-spilled), but a spilled subtree's
        # host slots must be retired with it or they leak
        for c in list(x.children.values()):
            self._unlink(c)
        del x.parent.children[x.tokens]
        self._log_digest("-", x)
        if x.spill is not None:
            # spilled: no device page to release — retire the host slot
            # (the no-leak / no-double-free contract of the spill tier)
            self._spilled.pop(x, None)
            self._spill_pool.free_slot(x.spill)
            x.spill = None
        else:
            self.alloc.release_page(x.page)
