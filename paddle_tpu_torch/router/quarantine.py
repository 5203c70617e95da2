"""Poison-request quarantine: crash attribution at the router (port of
``paddle_tpu/router/quarantine.py``).

The replay journal has a sharp edge: it faithfully replays a dead
replica's in-flight requests onto a survivor — so a request that
*deterministically* crashes the engine (bad shape, pathological
grammar, a latent kernel bug) is replay-amplified into serial fleet
death, with the supervisor burning its restart budget behind it.

This module is the attribution layer that stops the serial part:

- A replica death **strikes** the journaled requests in flight on it
  whose current flight had relayed ZERO tokens — the death happened
  at/near their dispatch, which is the poison shape; a request that
  was mid-stream when its replica died is a victim, not a suspect.
  The strike lands against the request's *signature* — a blake2b hash
  of the prompt ids plus the sampling-relevant payload fields, so the
  same poison resubmitted under a fresh trace id still matches.
- A signature that reaches ``FLAGS_router_poison_strikes`` strikes is
  **quarantined** for ``FLAGS_router_quarantine_ttl_s`` seconds: replay
  is refused mid-flight and new submissions get a clean 503 with a
  ``quarantined`` error body instead of a third corpse.

  Known asymmetry: a *unary* request only surfaces its tokens at
  completion, so the zero-tokens exemption cannot clear it mid-flight —
  an innocent unary request co-located with ``poison_strikes``
  consecutive deaths (without completing in between) is quarantined
  too.  The blast radius is a TTL'd 503 with Retry-After, not data
  loss; completion still absolves through ``progress()``.
- **Progress absolves**: relaying a token also resets a signature's
  accumulated strikes.  An innocent request that strikes once (its
  replay was killed pre-token by a poison chasing the same survivor)
  and then streams is exonerated; a request that kills its replica at
  dispatch never makes progress, so its strikes are monotone.

Counted in ``router.quarantine{action=strike|quarantined|refused}``.
All state is bounded: strike records share the quarantine TTL, and the
table holds at most ``cap`` signatures (oldest evicted first).
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

from .. import flags
from .. import observability as _obs

__all__ = ["PoisonQuarantine", "request_signature"]

# payload fields that change what the engine executes for a prompt —
# the same token ids under a different sampling config are a different
# request as far as crash attribution goes
_SAMPLING_KEYS = ("do_sample", "temperature", "top_k", "top_p", "seed",
                  "max_tokens")


def request_signature(prompt: Sequence[int], payload: dict) -> str:
    """Stable signature of (prompt ids, sampling config)."""
    doc = {"prompt": [int(t) for t in prompt],
           "sampling": {k: payload[k] for k in _SAMPLING_KEYS
                        if k in payload}}
    raw = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(raw.encode(), digest_size=8).hexdigest()


class _Record:
    __slots__ = ("strikes", "stamp", "quarantined_at")

    def __init__(self, now: float):
        self.strikes = 0
        self.stamp = now                 # last strike (TTL anchor)
        self.quarantined_at: Optional[float] = None


class PoisonQuarantine:
    """Strike table + TTL'd quarantine set, keyed by request signature.

    ``clock`` is injectable for deterministic tests.  With
    ``strikes <= 0`` the quarantine is disabled (every query answers
    "not quarantined", strikes are not recorded).
    """

    def __init__(self, strikes: Optional[int] = None,
                 ttl_s: Optional[float] = None, cap: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        f = flags.flag
        self.strikes = int(f("router_poison_strikes")
                           if strikes is None else strikes)
        self.ttl_s = float(f("router_quarantine_ttl_s")
                           if ttl_s is None else ttl_s)
        self.cap = int(f("router_quarantine_cap") if cap is None else cap)
        # write verbs purge inline; read verbs (quarantined/progress on
        # the hot proxy path) sweep at most every sweep_s so a refuse-
        # only workload still sheds expired records
        self._sweep_s = float(f("router_quarantine_sweep_s"))
        self._last_sweep = clock()
        self._clock = clock
        self._records: "OrderedDict[str, _Record]" = OrderedDict()
        m = _obs.metrics
        # bounded by construction: callers pass strike/quarantined/refused
        self._count = lambda a: m.counter("router.quarantine", action=a)
        self._size = m.gauge("router.quarantine_entries")

    def __len__(self) -> int:
        return len(self._records)

    @property
    def enabled(self) -> bool:
        return self.strikes > 0

    # ------------------------------------------------------------ state --
    def _expired(self, rec: _Record, now: float) -> bool:
        anchor = rec.quarantined_at if rec.quarantined_at is not None \
            else rec.stamp
        return now - anchor >= self.ttl_s

    def _get(self, sig: str, now: float) -> Optional[_Record]:
        rec = self._records.get(sig)
        if rec is not None and self._expired(rec, now):
            del self._records[sig]
            rec = None
        return rec

    def _purge(self, now: float) -> None:
        self._last_sweep = now
        dead = [s for s, r in self._records.items()
                if self._expired(r, now)]
        for s in dead:
            del self._records[s]
        while len(self._records) > self.cap:
            self._records.popitem(last=False)
        self._size.set(len(self._records))

    def _maybe_sweep(self, now: float) -> None:
        """Time-gated purge for the read verbs: amortised O(1) per call,
        the table never carries expired records longer than sweep_s."""
        if now - self._last_sweep >= self._sweep_s:
            self._purge(now)

    # ----------------------------------------------------------- verbs --
    def strike(self, sig: Optional[str]) -> bool:
        """One death with this signature in flight.  Returns True when
        the signature is (now or already) quarantined."""
        if not self.enabled or sig is None:
            return False
        now = self._clock()
        rec = self._get(sig, now)
        if rec is None:
            rec = _Record(now)
            self._records[sig] = rec
        if rec.quarantined_at is not None:
            return True
        rec.strikes += 1
        rec.stamp = now
        self._count("strike").inc()
        if rec.strikes >= self.strikes:
            rec.quarantined_at = now
            self._count("quarantined").inc()
            if _obs.TRACER.enabled:
                _obs.TRACER.instant("router.quarantine",
                                    args={"signature": sig,
                                          "strikes": rec.strikes})
            self._purge(now)
            return True
        self._purge(now)
        return False

    def progress(self, sig: Optional[str]) -> None:
        """The request relayed a token: whatever replica it last landed
        on did real work for it — absolve its strikes.  (A quarantined
        signature stays quarantined until TTL: the verdict is final for
        this window, only the evidence resets.)"""
        if not self.enabled or sig is None:
            return
        self._maybe_sweep(self._clock())
        rec = self._records.get(sig)
        if rec is not None and rec.quarantined_at is None:
            del self._records[sig]
            self._size.set(len(self._records))

    def quarantined(self, sig: Optional[str]) -> bool:
        if not self.enabled or sig is None:
            return False
        now = self._clock()
        self._maybe_sweep(now)
        rec = self._get(sig, now)
        return rec is not None and rec.quarantined_at is not None

    def refuse(self, sig: str) -> int:
        """Count one refused submit/replay; returns the remaining TTL
        seconds (the client's Retry-After hint)."""
        self._count("refused").inc()
        rec = self._records.get(sig)
        if rec is None or rec.quarantined_at is None:
            return 1
        left = self.ttl_s - (self._clock() - rec.quarantined_at)
        return max(1, int(left))

    # ----------------------------------------------------------- status --
    def state(self) -> dict:
        now = self._clock()
        self._purge(now)
        q = sum(1 for r in self._records.values()
                if r.quarantined_at is not None)
        return {"enabled": self.enabled,
                "strikes_to_quarantine": self.strikes,
                "ttl_s": self.ttl_s,
                "tracked_signatures": len(self._records),
                "quarantined": q,
                "refused_total": int(_obs.metrics.counter(
                    "router.quarantine", action="refused").value)}
