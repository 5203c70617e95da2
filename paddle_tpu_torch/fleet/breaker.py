"""Cascade breaker: blast-radius containment for fleet death (port of
``paddle_tpu/fleet/breaker.py``).

The quarantine (``router/quarantine.py``) attributes *individual* poison
requests.  The breaker is the layer above it: when replicas are dying
faster than ``FLAGS_fleet_cascade_threshold`` per
``FLAGS_fleet_cascade_window_s`` — a poison burst the quarantine hasn't
converged on yet, a bad rollout, a shared-dependency outage — the fleet
must stop FEEDING the failure:

- **OPEN**: failover resume pauses (journal entries PARK at the router
  instead of replaying — a replay onto a survivor is exactly how a
  cascade propagates), new admissions shed with jittered ``Retry-After``,
  and crash restarts continue (the supervisor keeps rebuilding capacity
  behind the breaker).
- **HALF-OPEN**: after ``FLAGS_fleet_cascade_cooldown_s`` with no
  further deaths, ONE parked resume is released as a probe.
- **CLOSED**: the probe survived — parked entries replay, admission
  reopens.  Another death while half-open re-opens the breaker.

State rides the ``fleet.breaker_state`` gauge (0=closed, 1=half-open,
2=open); every transition lands as a ``fleet.breaker`` tracer instant
and — for CLOSED→OPEN, the incident moment — a flight-recorder dump
(reason ``cascade-breaker-open``) so the evidence ring is on disk while
the cascade is still fresh.

The breaker object is shared: the supervisor owns detection
(``record_death`` from its crash paths, ``update`` each tick) and the
router consumes state (``state`` reads, ``claim_probe``/``probe_result``
around the half-open resume).  All mutations are plain GIL-atomic
attribute writes — the supervisor's control-loop thread and the
router's event loop need no lock between them.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from .. import flags
from .. import observability as _obs

__all__ = ["CascadeBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_GAUGE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CascadeBreaker:
    """Death-rate circuit breaker over the supervised fleet.

    ``threshold <= 0`` disables it (state stays CLOSED forever).
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, threshold: Optional[int] = None,
                 window_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 flight_recorder=None):
        f = flags.flag
        self.threshold = int(f("fleet_cascade_threshold")
                             if threshold is None else threshold)
        self.window_s = float(f("fleet_cascade_window_s")
                              if window_s is None else window_s)
        self.cooldown_s = float(f("fleet_cascade_cooldown_s")
                                if cooldown_s is None else cooldown_s)
        self._clock = clock
        self._fr = flight_recorder
        self._state = CLOSED
        self._deaths: List[float] = []
        self._opened_at = 0.0
        self._probe_claimed = False
        self._transitions = 0
        self._gauge = _obs.metrics.gauge("fleet.breaker_state")
        self._gauge.set(0)

    # ------------------------------------------------------------- state --
    @property
    def state(self) -> str:
        return self._state

    @property
    def enabled(self) -> bool:
        return self.threshold > 0

    def _transition(self, new: str, reason: str, now: float) -> None:
        old, self._state = self._state, new
        self._transitions += 1
        self._gauge.set(_GAUGE_VALUE[new])
        if _obs.TRACER.enabled:
            _obs.TRACER.instant("fleet.breaker",
                                args={"from": old, "to": new,
                                      "reason": reason,
                                      "deaths_in_window":
                                          len(self._deaths)})
        if new == OPEN and old == CLOSED and self._fr is not None:
            # the incident moment: get the evidence ring on disk while
            # the cascade is fresh (rate-limited per reason by the
            # recorder itself; never raises)
            self._fr.dump(reason="cascade-breaker-open")

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._deaths and self._deaths[0] < cutoff:
            self._deaths.pop(0)

    # ------------------------------------------------------------- verbs --
    def record_death(self, now: Optional[float] = None) -> None:
        """One replica death (the supervisor's crash/wedge/drain-died
        paths).  Trips CLOSED→OPEN past the threshold and re-opens a
        HALF_OPEN breaker (the probe window failed)."""
        if not self.enabled:
            return
        now = self._clock() if now is None else now
        self._deaths.append(now)
        self._prune(now)
        if self._state == HALF_OPEN:
            self._opened_at = now
            self._probe_claimed = False
            self._transition(OPEN, "death-while-half-open", now)
        elif self._state == CLOSED and \
                len(self._deaths) >= self.threshold:
            self._opened_at = now
            self._transition(OPEN, "death-rate", now)
        elif self._state == OPEN:
            # an ongoing cascade extends the cooldown: HALF_OPEN comes
            # only after a death-FREE cooldown_s, not cooldown_s after
            # the original trip — a probe released into a fleet that is
            # still dying is just another corpse
            self._opened_at = now

    def update(self, now: Optional[float] = None) -> str:
        """Advance time-driven transitions (the supervisor calls this
        every tick): OPEN → HALF_OPEN after a death-free cooldown."""
        if not self.enabled:
            return self._state
        now = self._clock() if now is None else now
        self._prune(now)
        if self._state == OPEN and \
                now - self._opened_at >= self.cooldown_s:
            self._probe_claimed = False
            self._transition(HALF_OPEN, "cooldown", now)
        return self._state

    def claim_probe(self) -> bool:
        """HALF_OPEN only: the first caller wins the single probe slot
        (one parked resume replays; everyone else keeps waiting)."""
        if self._state != HALF_OPEN or self._probe_claimed:
            return False
        self._probe_claimed = True
        return True

    def release_probe(self) -> None:
        """The claimer never actually dispatched a replay (no eligible
        survivor, request turned out ineligible): hand the slot back so
        the half-open breaker is not wedged waiting on a probe that
        will never report."""
        if self._state == HALF_OPEN:
            self._probe_claimed = False

    def probe_result(self, ok: bool) -> None:
        """Outcome of the half-open probe: survival closes the breaker,
        death re-opens it (record_death may already have)."""
        now = self._clock()
        if ok:
            if self._state == HALF_OPEN:
                self._deaths.clear()
                self._transition(CLOSED, "probe-survived", now)
        else:
            if self._state == HALF_OPEN:
                self._opened_at = now
                self._probe_claimed = False
                self._transition(OPEN, "probe-died", now)

    # ------------------------------------------------------------ status --
    def state_dict(self) -> dict:
        now = self._clock()
        self._prune(now)
        return {"state": self._state,
                "enabled": self.enabled,
                "deaths_in_window": len(self._deaths),
                "threshold": self.threshold,
                "window_s": self.window_s,
                "cooldown_s": self.cooldown_s,
                "transitions": self._transitions}
