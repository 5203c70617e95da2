"""Placement: which replica serves this request (port of
``paddle_tpu/router/placement.py``).

Scored, not round-robin.  Each replica advertises
a prefix-residency digest via ``/statusz`` — the chain hashes of the KV
pages its radix index holds (``inference.prefix_cache.block_hashes``
semantics: membership of hash k implies the whole k-page prefix is
resident).  The router computes the same chain over the incoming prompt
and scores every candidate:

    score = hit_weight * expected_hit_tokens
          - load_weight * load * page_size

``expected_hit_tokens`` is the longest LEADING run of the prompt's page
hashes found in the replica's digest, times its page size — exactly the
prefill tokens its cache would skip.  ``load`` counts requests ahead of
this one (the router's own live in-flight count plus the replica's last
polled queue depth), priced in page-size token units so one queued
request offsets one cached page at the default weights
(``FLAGS_router_hit_weight`` / ``FLAGS_router_load_weight``).

Two refinements make the score robust without tight polling:

- **Routed overlay**: the instant a prompt is routed, its leading hashes
  are credited to that replica's digest view (bounded LRU).  The replica
  will hold those pages by the time any follow-up sharing them arrives —
  the prefix cache's pending->ready lifecycle even shares them within
  one admission batch — so placement concentrates shared prefixes
  without waiting for the next ``/statusz`` poll to confirm.
- **Session affinity**: ``X-Session-Id`` pins a conversation to the
  replica holding its pages (LRU-capped at ``FLAGS_router_session_cap``;
  an evicted or orphaned session is simply re-scored, and the digest
  steers it home).

``round_robin`` (``FLAGS_router_placement``) is the baseline arm of the
``router_serve`` A/B: plain rotation, no affinity, no digest.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from .. import flags
from .. import observability as _obs
from ..inference.prefix_cache import block_hashes

__all__ = ["ReplicaState", "Placer"]

# placement reasons, the `router.placement{reason=}` label set
AFFINITY, PREFIX, LOAD, ROUND_ROBIN = \
    "affinity", "prefix", "load", "round_robin"


class ReplicaState:
    """The router's live view of one replica: health, load, digest."""

    def __init__(self, client):
        self.client = client
        self.id = client.id
        # health: ok flips False the moment a poll (or a proxied connect)
        # fails — excluded from NEW placements immediately; `dead` is the
        # reported state after FLAGS_router_dead_after consecutive
        # failures.  Polling continues either way so a recovered replica
        # rejoins.
        self.ok = False
        self.ready = False
        self.fails = 0
        self.last_poll: Optional[float] = None
        self.next_poll: float = 0.0     # monotonic deadline for the poller
        # drain protocol: a draining replica is excluded from
        # NEW placements while its in-flight streams finish.  The pin is
        # the supervisor's immediate signal (set via mark_draining before
        # the replica's own /statusz can confirm); `reported_draining`
        # follows the replica's advertised state.
        self.drain_pin = False
        self.reported_draining = False
        # placement inputs from the last successful /statusz
        self.digest: frozenset = frozenset()
        # digest sketch: past the replica's sketch threshold
        # the exact set above stays empty and membership tests answer
        # from this counting-Bloom bitmap view instead — a bounded
        # OVER-estimate (no false negatives), flat bytes per poll
        self.digest_sketch = None
        # spill-aware scoring: the digest subset
        # demoted to the replica's host ring — swappable, so a hit there
        # scores between resident and absent
        self.spilled: frozenset = frozenset()
        # disaggregated serving: the replica's advertised
        # role; phase routing prefers prefill replicas for new streams
        # and decode replicas for handed-off generation legs
        self.role: str = "mixed"
        self.page_size: int = 0
        # capacity advertisement: tensor-parallel degree and
        # host-global KV pool bytes from /statusz engine stats — the
        # weighted-rank inputs that let a tp=4 replica outrank a tp=1
        # one at equal role/load (FLAGS_router_capacity_weight)
        self.tp: int = 1
        self.pool_bytes: int = 0
        # digest DELTA sync: the last confirmed epoch and its
        # generation nonce — the next poll asks for only the changes
        # since (gen, epoch); a gen mismatch or log miss ships the full
        # set again and re-anchors here
        self.digest_gen: Optional[str] = None
        self.digest_epoch: int = -1
        # failover-resume eligibility: replaying a journal is
        # bit-exact against a greedy replica (advertised in /statusz
        # engine.sampling); unknown = not eligible.  Not greedy-only:
        # greedy-only rule: ``sampling`` keeps the full advertised
        # config — a survivor whose seeded POSITIONAL sampling config
        # matches the dead replica's replays bit-exactly too.
        self.greedy = False
        self.sampling: Optional[dict] = None
        self.queue_depth: int = 0       # waiting + busy slots, replica-side
        self.slo_decision: str = "admit"
        self.retry_after_s: int = 1
        # sentinel view from the last poll: anomaly totals +
        # recent records, aggregated fleet-wide in the router's /statusz
        self.anomaly_total = 0
        self.anomalies_recent: list = []
        # router-side live signals
        self.inflight = 0               # proxied requests currently open
        # routed overlay: hash -> poll generation at credit time, so
        # entries the digest never confirms (page evicted replica-side,
        # or never committed) age out instead of scoring phantom hits
        # forever
        self.routed: "OrderedDict[str, int]" = OrderedDict()
        self._poll_gen = 0              # completed /statusz polls
        self.failovers = 0
        self._overlay_evictions = _obs.metrics.counter(
            "router.overlay_evictions")

    # ------------------------------------------------------------ state --
    @property
    def draining(self) -> bool:
        return self.drain_pin or self.reported_draining

    def statusz_path(self) -> str:
        """The poll target: once an epoch is confirmed, ask for the
        digest delta instead of the full set."""
        if self.digest_gen and self.digest_epoch >= 0:
            return (f"/statusz?digest_since="
                    f"{self.digest_gen}:{self.digest_epoch}")
        return "/statusz"

    def status(self, dead_after: int) -> str:
        if not self.ok:
            return "dead" if self.fails >= dead_after else "suspect"
        if self.draining:
            return "draining"
        return "ready" if self.ready else "warming"

    def apply_statusz(self, doc: dict,
                      dead_after: Optional[int] = None) -> None:
        """Fold one successful /statusz poll into the placement view.
        ``dead_after`` (the router passes its threshold) scopes rejoin
        handling to DEAD->live transitions only."""
        if not self.ok and self.fails > 0 and \
                (dead_after is None or self.fails >= dead_after):
            # dead -> live transition: the replica rejoined.  Reset
            # placement-score staleness — the routed overlay (and its
            # aging generations) predate the death, so a rejoined
            # replica must not be scored on phantom pre-death credits;
            # the fresh digest below is the only truth it restarts with.
            # (A single-poll suspect blip is NOT a rejoin: the replica
            # never stopped serving, its overlay credits are valid.)
            self.routed.clear()
            self._poll_gen = 0
            _obs.metrics.counter("router.replica_rejoins").inc()
            if _obs.TRACER.enabled:
                _obs.TRACER.instant("router.replica_rejoin",
                                    args={"replica": self.id,
                                          "after_fails": self.fails})
        self.ok = True
        self.fails = 0
        self.last_poll = time.perf_counter()
        self.ready = bool(doc.get("ready", True))
        self.reported_draining = bool(doc.get("draining", False))
        role = doc.get("role")
        self.role = role if role in ("prefill", "decode", "mixed") \
            else "mixed"
        eng = doc.get("engine") or {}
        self.queue_depth = int(eng.get("waiting", 0) or 0) + \
            int(eng.get("slots_busy", 0) or 0)
        try:
            self.tp = max(int(eng.get("tp", 1) or 1), 1)
        except (TypeError, ValueError):
            self.tp = 1
        try:
            self.pool_bytes = max(int(eng.get("pool_bytes", 0) or 0), 0)
        except (TypeError, ValueError):
            self.pool_bytes = 0
        samp = (eng.get("sampling") if isinstance(eng, dict) else None)
        self.greedy = isinstance(samp, dict) and \
            samp.get("do_sample") is False
        self.sampling = dict(samp) if isinstance(samp, dict) else None
        dig = doc.get("prefix_digest")
        if dig and str(dig.get("mode", "full")) == "sketch" \
                and dig.get("sketch"):
            # sketch mode: membership answers from the Bloom
            # bitmap; the exact set stays empty and epochs un-anchor so
            # the replica keeps shipping whole sketches (no deltas to
            # ask for — the sketch IS flat).
            from ..controlplane.sketch import BloomView
            self.page_size = int(dig.get("page_size", 0) or 0)
            self.digest_sketch = BloomView(dig["sketch"])
            self.digest = frozenset()
            self.digest_gen = None
            self.digest_epoch = -1
            self.spilled = frozenset(dig.get("spilled") or ())
            _obs.metrics.counter("router.digest_sync",
                                 mode="sketch").inc()
            # overlay aging under sketch confirmation: same two-poll
            # rule, with the sketch answering "confirmed"
            self._poll_gen += 1
            poll_gen = self._poll_gen
            sk = self.digest_sketch
            for h in [h for h, g in self.routed.items()
                      if h in sk or poll_gen - g >= 2]:
                del self.routed[h]
        elif dig:
            self.page_size = int(dig.get("page_size", 0) or 0)
            gen = dig.get("gen")
            is_delta = (str(dig.get("mode", "full")) == "delta"
                        and gen is not None and gen == self.digest_gen)
            self.digest_sketch = None
            if is_delta:
                # apply adds/evictions since the confirmed epoch to the
                # held set — the per-poll full-set re-ship is gone
                confirmed = (self.digest
                             | frozenset(dig.get("adds") or ())) \
                    - frozenset(dig.get("dels") or ())
            else:
                # full resync: first poll, epoch from another replica
                # life, or the replica's change log no longer covers us
                confirmed = frozenset(dig.get("hashes") or ())
            _obs.metrics.counter(
                "router.digest_sync",
                mode="delta" if is_delta else "full").inc()
            self.digest_gen = gen
            try:
                self.digest_epoch = int(dig.get("epoch", -1))
            except (TypeError, ValueError):
                self.digest_epoch = -1
            self.digest = confirmed
            # the spilled subset ships in FULL every poll (bounded by
            # the replica's spill ring) — spill transitions don't move
            # index membership, so the delta log cannot carry them
            self.spilled = frozenset(dig.get("spilled") or ())
            # overlay entries the index now confirms have served their
            # purpose; entries still unconfirmed after two full polls
            # were evicted (or never committed) replica-side — drop both
            # so the advertised truth is the steady-state signal.  Two
            # polls, not one: a credit from just before this poll may
            # predate its request's admission on the replica.
            self._poll_gen += 1
            poll_gen = self._poll_gen
            for h in [h for h, g in self.routed.items()
                      if h in confirmed or poll_gen - g >= 2]:
                del self.routed[h]
        else:
            self.digest = frozenset()
            self.digest_sketch = None
            self.spilled = frozenset()
            self.routed.clear()
            self.digest_gen = None
            self.digest_epoch = -1
        anomalies = doc.get("anomalies")
        if isinstance(anomalies, dict):
            try:
                self.anomaly_total = int(
                    anomalies.get("anomalies_total", 0) or 0)
            except (TypeError, ValueError):
                self.anomaly_total = 0
            recent = anomalies.get("recent")
            self.anomalies_recent = list(recent)[-16:] \
                if isinstance(recent, list) else []
        else:
            self.anomaly_total = 0
            self.anomalies_recent = []
        slo = doc.get("slo")
        if slo:
            self.slo_decision = str(slo.get("decision", "admit"))
            try:
                self.retry_after_s = max(1, int(slo.get(
                    "retry_after_s", 1)))
            except (TypeError, ValueError):
                self.retry_after_s = 1
        else:
            self.slo_decision = "admit"
            self.retry_after_s = 1

    def mark_failed(self) -> None:
        """A poll or proxied connect failed: out of the candidate set NOW
        (re-route first, diagnose later); backoff grows in the poller."""
        self.ok = False
        self.ready = False
        self.fails += 1

    # -------------------------------------------------------- placement --
    def expected_hits(self, hashes: Sequence[str]) -> Tuple[int, int]:
        """``(pages, spilled)`` over the longest leading run of
        ``hashes`` this replica holds (digest semantics: hash k
        resident => the whole k-page prefix is).  ``spilled`` counts
        the run members demoted to the replica's host ring — hittable
        after a swap-in upload, so they score between resident and
        absent.  An overlay credit outranks a
        stale spill mark: the page was just re-routed here and the
        admission swap-in re-promotes it."""
        n = sp = 0
        sk = self.digest_sketch
        for h in hashes:
            if h in self.routed:
                n += 1
            elif h in self.digest or (sk is not None and h in sk):
                n += 1
                if h in self.spilled:
                    sp += 1
            else:
                break
        return n, sp

    def expected_hit_pages(self, hashes: Sequence[str]) -> int:
        """Longest leading run of ``hashes`` this replica holds."""
        return self.expected_hits(hashes)[0]

    def credit_routed(self, hashes: Sequence[str],
                      cap: Optional[int] = None) -> None:
        """Optimistically credit the leading hashes of a prompt just
        routed here (global LRU bound at ``FLAGS_router_overlay_cap``;
        oldest credits fall off first, counted in
        ``router.overlay_evictions``)."""
        if cap is None:
            cap = int(flags.flag("router_overlay_cap"))
        for h in hashes:
            if h in self.routed:
                self.routed.move_to_end(h)
            self.routed[h] = self._poll_gen
        while len(self.routed) > cap:
            self.routed.popitem(last=False)
            self._overlay_evictions.inc()

    def load(self) -> int:
        """Requests ahead of a new arrival: the router's own live
        in-flight count plus the replica's last-polled queue depth."""
        return self.inflight + self.queue_depth

    def describe(self, dead_after: int) -> dict:
        age = None if self.last_poll is None else \
            round(time.perf_counter() - self.last_poll, 3)
        return {**self.client.describe(),
                "state": self.status(dead_after),
                "role": self.role,
                "draining": self.draining,
                "consecutive_fails": self.fails,
                "last_poll_age_s": age,
                "queue_depth": self.queue_depth,
                "inflight": self.inflight,
                "greedy": self.greedy,
                "digest_entries": len(self.digest),
                "digest_sketch": (None if self.digest_sketch is None
                                  else {"n": len(self.digest_sketch),
                                        "m": self.digest_sketch.m,
                                        "k": self.digest_sketch.k,
                                        "fp_bound": round(
                                            self.digest_sketch.fp_bound(),
                                            6)}),
                "digest_epoch": self.digest_epoch,
                "spilled_entries": len(self.spilled),
                "routed_overlay": len(self.routed),
                "page_size": self.page_size,
                "tp": self.tp,
                "pool_bytes": self.pool_bytes,
                "slo": {"decision": self.slo_decision,
                        "retry_after_s": self.retry_after_s},
                "anomalies": self.anomaly_total,
                "failovers": self.failovers}


# role tiers in the weighted successor rank are separated by a step no
# realistic load or capacity term crosses: the capacity fold
# differentiates WITHIN a tier (a tp=4 decode replica beats a tp=1
# decode replica) without ever promoting across tiers
_ROLE_STEP = 1e6


def capacity_score(s: ReplicaState) -> float:
    """A replica's advertised-capacity differentiator: tensor-parallel degree above baseline plus KV pool GiB.
    Zero for a vanilla tp=1 replica with nothing advertised, so
    homogeneous fleets order exactly as before at any weight."""
    return (s.tp - 1) + s.pool_bytes / float(1 << 30)


def weighted_rank(rank_map: Dict[str, int],
                  capacity_weight: Optional[float] = None):
    """Ascending sort key replacing the lexicographic (role, load)
    tuple: role tier first (scaled far above everything else), then
    load minus the capacity fold — so among same-role candidates a
    bigger replica absorbs the work unless it is proportionally more
    loaded."""
    w = float(flags.flag("router_capacity_weight")
              if capacity_weight is None else capacity_weight)

    def key(s: ReplicaState) -> float:
        return (_ROLE_STEP * rank_map.get(s.role, 1) + s.load()
                - w * capacity_score(s))

    return key


class Placer:
    """Policy object: ``place()`` picks one candidate and records why."""

    def __init__(self, policy: Optional[str] = None,
                 session_cap: Optional[int] = None,
                 hit_weight: Optional[float] = None,
                 load_weight: Optional[float] = None,
                 capacity_weight: Optional[float] = None):
        f = flags.flag
        self.policy = str(f("router_placement")
                          if policy is None else policy)
        if self.policy not in ("scored", "round_robin"):
            raise ValueError(
                f"router_placement must be 'scored' or 'round_robin', "
                f"got {self.policy!r}")
        self.session_cap = int(f("router_session_cap")
                               if session_cap is None else session_cap)
        self.hit_weight = float(f("router_hit_weight")
                                if hit_weight is None else hit_weight)
        self.load_weight = float(f("router_load_weight")
                                 if load_weight is None else load_weight)
        # a spilled page is worth this fraction of a resident one: the
        # bytes are one swap-in upload away, not a re-prefill away
        self.spill_weight = float(f("router_spill_hit_weight"))
        self.capacity_weight = float(f("router_capacity_weight")
                                     if capacity_weight is None
                                     else capacity_weight)
        self._sessions: "OrderedDict[str, str]" = OrderedDict()
        self._rr = 0
        m = _obs.metrics
        self._placed = {r: m.counter("router.placement", reason=r)
                        for r in (AFFINITY, PREFIX, LOAD, ROUND_ROBIN)}
        self._pins = m.gauge("router.session_pins")
        self._evictions = m.counter("router.session_evictions")
        self._hit_pages = m.histogram("router.prefix_hit_pages")

    # --------------------------------------------------------- sessions --
    def _pin(self, session_id: str, replica_id: str) -> None:
        if session_id in self._sessions:
            self._sessions.move_to_end(session_id)
        self._sessions[session_id] = replica_id
        while len(self._sessions) > self.session_cap:
            self._sessions.popitem(last=False)
            self._evictions.inc()
        self._pins.set(len(self._sessions))

    def pinned(self, session_id: Optional[str]) -> Optional[str]:
        return self._sessions.get(session_id) if session_id else None

    def pin(self, session_id: str, replica_id: str) -> None:
        """Public pin: the router's disaggregated handoff
        re-points a session at the decode replica its KV just shipped
        to, so follow-up turns land where the pages live."""
        self._pin(session_id, replica_id)

    def session_state(self) -> dict:
        return {"pins": len(self._sessions), "cap": self.session_cap,
                "evictions": int(self._evictions.value)}

    # -------------------------------------------------------- placement --
    def hashes_for(self, prompt: Sequence[int],
                   candidates: List[ReplicaState]) -> Dict[int, List[str]]:
        """Prompt page hashes per distinct candidate page size (one chain
        walk per geometry; a fleet normally has exactly one)."""
        out: Dict[int, List[str]] = {}
        if self.policy != "scored" or not prompt:
            return out
        # bounded: scoring stops at the first miss and the overlay credit
        # caps at router_digest_max anyway, so hashing pages past that
        # would be pure per-request overhead on huge prompts
        limit = int(flags.flag("router_digest_max"))
        for s in candidates:
            ps = s.page_size
            if ps > 0 and ps not in out:
                out[ps] = block_hashes(prompt, ps, limit=limit)
        return out

    def place(self, prompt: Sequence[int], session_id: Optional[str],
              candidates: List[ReplicaState]
              ) -> Tuple[ReplicaState, str]:
        """Pick one of ``candidates`` (non-empty, pre-filtered to ready &
        not-shedding).  Returns ``(state, reason)`` and records the
        decision, the routed-overlay credit, and the session pin."""
        if self.policy == "round_robin":
            choice = candidates[self._rr % len(candidates)]
            self._rr += 1
            self._placed[ROUND_ROBIN].inc()
            return choice, ROUND_ROBIN

        hashes = self.hashes_for(prompt, candidates)
        pin = self.pinned(session_id)
        choice = reason = None
        if pin is not None:
            for s in candidates:
                if s.id == pin:
                    choice, reason = s, AFFINITY
                    break
            # a pinned replica that is dead/shedding falls through to the
            # score — which the digest steers back to wherever the
            # session's pages actually live (possibly a survivor that
            # never saw it: then it is a plain cold re-place)
        if choice is None:
            best = None
            # load priced in ONE token unit fleet-wide: a digest-less
            # replica (page_size 0) must not get a discounted penalty
            # relative to page-ful peers, or it soaks up traffic
            # regardless of load
            unit = max((s.page_size for s in candidates), default=0) or 1
            for i, s in enumerate(candidates):
                hits, sp = s.expected_hits(hashes.get(s.page_size, ()))
                # spilled pages are discounted, not free: resident >
                # spilled > absent
                eff = (hits - sp) + self.spill_weight * sp
                # capacity fold: advertised tp
                # degree + pool bytes, in the fleet's token unit — a
                # pure differentiator (identical across a homogeneous
                # fleet, so scores shift uniformly and ordering holds)
                score = self.hit_weight * eff * s.page_size \
                    - self.load_weight * s.load() * unit \
                    + self.capacity_weight * capacity_score(s) * unit
                key = (score, -s.load(), -((i - self._rr) % len(candidates)))
                if best is None or key > best[0]:
                    best = (key, s, hits)
            _, choice, hits = best
            reason = PREFIX if hits > 0 else LOAD
            if reason == LOAD:
                self._rr += 1           # rotate ties among equal loads
            self._hit_pages.observe(float(hits))
        hs = hashes.get(choice.page_size)
        if hs:
            choice.credit_routed(hs)
        if session_id:
            self._pin(session_id, choice.id)
        self._placed[reason].inc()
        return choice, reason

    def repin(self, src: str, dst: str) -> int:
        """Re-point every session pinned to replica ``src`` at ``dst``
        (the supervisor's proactive rebalance: the sessions' KV was
        just pre-staged on ``dst`` over the migration plane, so their
        next turns should land there).  Returns the pin count moved."""
        n = 0
        for sid, rid in self._sessions.items():
            if rid == src:
                self._sessions[sid] = dst
                n += 1
        return n
