"""SLO-driven admission control and load shedding for the HTTP front door
(port of ``paddle_tpu/serving/slo.py``).

Admission reads the registry's latency histograms, not the queue length:
a deep queue of tiny requests is fine and a shallow queue behind a hung
prefill is not, and the histograms are what users feel.

The controller watches the ``serving.ttft_ms`` and ``serving.itl_ms``
histograms the engine records at its drains.  Over a rolling window of the
last ``FLAGS_serving_slo_window`` observations (deltas against a base
snapshot per histogram: O(1) a decision, no sample buffer) it computes the
violation rate: the share of observations whose bucket lies above the
target (``FLAGS_serving_slo_ttft_ms`` / ``_itl_ms``).  With a budget of
``1 - FLAGS_serving_slo_quantile`` (5% for a p95 SLO):

- rate <= budget                -> **admit**
- budget < rate <= burn*budget  -> **queue** (admitted, counted as
  at-risk)
- rate > burn*budget            -> **shed** (the HTTP layer answers 503
  with Retry-After; the engine never sees the request)

Every decision increments ``serving.http.slo_decision{decision=...}``;
sheds also bump ``serving.http.shed``.  With fewer than
``FLAGS_serving_slo_min_samples`` fresh observations it admits.
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, Optional, Tuple

from .. import flags
from ..observability import metrics as _metrics

__all__ = ["SLOController", "jittered_retry_after"]

ADMIT, QUEUE, SHED = "admit", "queue", "shed"


def jittered_retry_after(seconds: float, frac: float = 0.2,
                         rng: Optional[random.Random] = None) -> int:
    """``Retry-After`` seconds with ±``frac`` uniform jitter, clamped to
    [1, 60]: one identical Retry-After would bring a shed herd back onto a
    recovering replica all at once.  ``rng`` defaults to the module's."""
    r = (rng or random).uniform(1.0 - frac, 1.0 + frac)
    return int(min(60.0, max(1.0, math.ceil(seconds * r))))


def _over_target(h, target: float) -> int:
    """Observations in buckets wholly above ``target``: counts of every
    bucket whose LOWER edge is >= target (conservative — the bucket
    straddling the target is counted as meeting it)."""
    bad = 0
    counts = list(h.bucket_counts)
    for i, c in enumerate(counts):
        if not c:
            continue
        lo = h.bounds[i - 1] if i > 0 else 0.0
        if lo >= target:
            bad += c
    return bad


class SLOController:
    """Burn-rate admission decisions off the live serving histograms.

    Construction resolves every registry handle once; ``decide()`` is a
    handful of integer reads per call — cheap enough for the per-request
    HTTP path.  All thresholds default from flags so a serving process is
    tunable by env (``FLAGS_serving_slo_*``) without code."""

    def __init__(self, *, ttft_ms: Optional[float] = None,
                 itl_ms: Optional[float] = None,
                 quantile: Optional[float] = None,
                 burn: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 window: Optional[int] = None):
        f = flags.flag
        self.ttft_ms = float(f("serving_slo_ttft_ms")
                             if ttft_ms is None else ttft_ms)
        self.itl_ms = float(f("serving_slo_itl_ms")
                            if itl_ms is None else itl_ms)
        self.quantile = float(f("serving_slo_quantile")
                              if quantile is None else quantile)
        self.burn = float(f("serving_slo_burn") if burn is None else burn)
        self.min_samples = int(f("serving_slo_min_samples")
                               if min_samples is None else min_samples)
        self.window = int(f("serving_slo_window")
                          if window is None else window)
        self._hists = {
            "ttft": (_metrics.histogram("serving.ttft_ms"), self.ttft_ms),
            "itl": (_metrics.histogram("serving.itl_ms"), self.itl_ms),
        }
        # per-term window base: (count, over-target count) at last rebase,
        # plus the completed previous window's (n, bad) — burn is computed
        # over previous + current so a rebase never zeroes the evidence
        # (without the carry, sustained overload would flap back to admit
        # for min_samples observations after every rebase)
        self._base: Dict[str, Tuple[int, int]] = {
            k: (0, 0) for k in self._hists}
        self._prev: Dict[str, Tuple[int, int]] = {
            k: (0, 0) for k in self._hists}
        # wall-clock window epochs + completed-window observation rates:
        # the live traffic-rate estimate behind retry_after_s()
        now = time.perf_counter()
        self._t0: Dict[str, float] = {k: now for k in self._hists}
        self._prev_rate: Dict[str, float] = {k: 0.0 for k in self._hists}
        self._decisions = {
            d: _metrics.counter("serving.http.slo_decision", decision=d)
            for d in (ADMIT, QUEUE, SHED)}
        self._shed = _metrics.counter("serving.http.shed")
        self.last: Dict[str, dict] = {}

    # ------------------------------------------------------------ burn --
    def burn_rates(self) -> Dict[str, dict]:
        """Current-window violation rate per SLO term (also the /statusz
        payload).  Rebases a term's window once it accumulates
        ``window`` fresh observations."""
        out: Dict[str, dict] = {}
        now = time.perf_counter()
        for name, (h, target) in self._hists.items():
            if target <= 0:
                continue
            cnt, bad = h.count, _over_target(h, target)
            b_cnt, b_bad = self._base[name]
            if cnt < b_cnt:             # histogram was reset under us
                self._base[name] = (0, 0)
                self._prev[name] = (0, 0)
                self._t0[name] = now
                self._prev_rate[name] = 0.0
                b_cnt = b_bad = 0
            dc, db = cnt - b_cnt, bad - b_bad
            if dc >= self.window:
                self._prev[name] = (dc, db)
                self._base[name] = (cnt, bad)
                self._prev_rate[name] = dc / max(now - self._t0[name], 1e-6)
                self._t0[name] = now
                dc = db = 0             # current window restarts empty
            pc, pb = self._prev[name]
            n, nbad = dc + pc, db + pb  # previous + current window
            rate = (nbad / n) if n > 0 else 0.0
            out[name] = {"target_ms": target, "window_n": n,
                         "violation_rate": round(rate, 4),
                         "active": n >= self.min_samples}
        self.last = out
        return out

    def decide(self, record: bool = True) -> str:
        """One admission decision: ``"admit"`` / ``"queue"`` / ``"shed"``,
        counted in the registry unless ``record=False``."""
        budget = max(1.0 - self.quantile, 1e-9)
        worst = 0.0
        for term in self.burn_rates().values():
            if term["active"]:
                worst = max(worst, term["violation_rate"])
        if worst > self.burn * budget:
            decision = SHED
        elif worst > budget:
            decision = QUEUE
        else:
            decision = ADMIT
        if record:
            self._decisions[decision].inc()
            if decision == SHED:
                self._shed.inc()
        return decision

    def _obs_per_s(self, name: str) -> float:
        """Live observation-rate estimate for one term: the current
        window's throughput, falling back to the last completed window's
        rate early in a fresh window."""
        h, _target = self._hists[name]
        dc = h.count - self._base[name][0]
        dt = time.perf_counter() - self._t0[name]
        if dc >= 2 and dt > 0:
            return dc / dt
        return self._prev_rate[name]

    def retry_after_s(self) -> int:
        """``Retry-After`` seconds derived from the LIVE burn window (not
        a constant): for every term burning past the shed threshold,
        estimate how many healthy observations it takes to dilute the
        violation rate back under ``burn * budget`` and divide by the
        term's live observation rate.  ±20% jittered and clamped to
        [1, 60]s so synchronized clients don't re-herd a recovering
        replica; at least 1 even when no term is burning (shouldn't be
        asked, but never 0 — clients must always back off a beat)."""
        budget = max(1.0 - self.quantile, 1e-9)
        worst = 1.0
        for name, term in self.burn_rates().items():
            if not term["active"]:
                continue
            rate = term["violation_rate"]
            if rate <= self.burn * budget:
                continue
            n = term["window_n"]
            # healthy obs h with nbad/(n + h) == burn*budget
            need = (rate * n) / (self.burn * budget) - n
            per_s = self._obs_per_s(name)
            if per_s > 0:
                worst = max(worst, need / per_s)
            # a burning term with NO live rate estimate (traffic stopped
            # entirely) keeps the 1s floor: the next probe re-measures
        return jittered_retry_after(worst)

    def state(self) -> dict:
        """Config + live burn view for /statusz (also what the
        multi-replica router aggregates fleet admission from)."""
        return {"ttft_ms": self.ttft_ms, "itl_ms": self.itl_ms,
                "quantile": self.quantile, "burn": self.burn,
                "min_samples": self.min_samples, "window": self.window,
                "violation_budget": round(max(1.0 - self.quantile, 0.0), 4),
                "terms": self.burn_rates(),
                "decision": self.decide(record=False),
                "retry_after_s": self.retry_after_s(),
                "shed_total": int(self._shed.value)}
