"""Online regression sentinel (port of
``paddle_tpu/observability/sentinel.py``).

EWMA + absolute-deviation drift detectors (the streaming analog of a k-MAD
robust outlier test) watch selected registry series; when a sample breaks
from its learned baseline the sentinel

- bumps ``observability.anomaly{series=...,kind=...}`` (bounded labels:
  the watch list is fixed at construction),
- emits a tracer instant event with the anomaly record (so the flight
  recorder's ring, and any dump, holds the evidence),
- triggers a rate-limited flight-recorder dump with reason ``anomaly``,
- and keeps a bounded history for the server's ``/statusz``.

Watched series:

==========================  =========  ==================================
series                      kind       sample per sweep
==========================  =========  ==================================
serving.ttft_ms             drift      mean of NEW observations (Δsum/Δn)
serving.itl_ms              drift      mean of new observations
serving.queue_wait_ms       drift      mean of new observations
serving.step_ms{phase=...}  drift      mean of new observations, per phase
jit.backend_compiles        burst      Δcount: ANY kernel build after the
                                       warm-up window is an anomaly
serving.queue_depth_now     drift      gauge level
spec accept rate            drift      Δaccepted / Δdrafted
==========================  =========  ==================================

A sweep reads host-side registry floats only, so it never adds a device
sync.  A detector folds ``FLAGS_sentinel_min_samples`` samples into its
baseline before it may fire, so a fresh process learns its own normal
first.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .. import flags
from . import metrics as _metrics
from .attribution import Ewma
from .tracing import TRACER

__all__ = ["Drift", "Sentinel"]

# the threshold never collapses below 10% of the baseline level
_REL_FLOOR = 0.1
# absolute floor for ms/count-scale series: a baseline learned at exactly
# 0 must not make the first nonzero sample an anomaly; ratio-scale
# detectors (the accept rate) pass their own smaller floor
_ABS_FLOOR = 1.0
_RATE_FLOOR = 0.05


class Drift:
    """Drift detector for one scalar series: the shared ``Ewma`` baseline
    plus a k-of-deviation threshold.  ``update(v)`` returns the anomaly's
    deviation ratio (> 1 means fired) or None while normal or warming up.
    The baseline keeps learning through anomalies, so a lasting level shift
    fires for a while, then becomes the new normal."""

    __slots__ = ("ewma", "k", "min_samples", "min_dev", "fired")

    def __init__(self, alpha: float, k: float, min_samples: int,
                 min_dev: float = _ABS_FLOOR):
        self.ewma = Ewma(alpha)
        self.k = k
        self.min_samples = min_samples
        self.min_dev = min_dev
        self.fired = 0

    @property
    def mean(self) -> float:
        return self.ewma.mean

    @property
    def n(self) -> int:
        return self.ewma.n

    def update(self, v: float) -> Optional[float]:
        ratio = None
        e = self.ewma
        if e.n >= self.min_samples:
            floor = max(e.dev, _REL_FLOOR * abs(e.mean), self.min_dev)
            dev = abs(v - e.mean)
            if dev > self.k * floor:
                ratio = dev / (self.k * floor)
                self.fired += 1
        e.update(v)
        return ratio

    def state(self) -> Dict[str, float]:
        e = self.ewma
        return {"ewma": round(e.mean, 4), "dev": round(e.dev, 4),
                "n": e.n, "fired": self.fired}


class _HistDelta:
    """Mean of a histogram's NEW observations since the last sweep
    (Δsum / Δcount)."""

    __slots__ = ("count", "sum")

    def __init__(self):
        self.count = 0
        self.sum = 0.0

    def sample(self, h) -> Optional[float]:
        dc = h.count - self.count
        ds = h.sum - self.sum
        self.count = h.count
        self.sum = h.sum
        if dc <= 0:
            return None
        return ds / dc


class Sentinel:
    """Drift detection over the live registry.  Built once per process
    (the serving server does, behind ``FLAGS_serving_sentinel``);
    ``maybe_check()`` from the engine loop, ``state()`` for ``/statusz``."""

    # every label set of each family gets its own detector
    HIST_FAMILIES = ("serving.ttft_ms", "serving.itl_ms",
                     "serving.queue_wait_ms", "serving.step_ms")
    GAUGE_FAMILIES = ("serving.queue_depth_now",)

    def __init__(self, registry=_metrics.REGISTRY, tracer=TRACER,
                 flight_recorder=None, alpha: Optional[float] = None,
                 k: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 interval_s: Optional[float] = None,
                 history: Optional[int] = None):
        f = flags.flag
        self._registry = registry
        self._tracer = tracer
        self._fr = flight_recorder
        self.alpha = float(f("sentinel_alpha") if alpha is None else alpha)
        self.k = float(f("sentinel_k") if k is None else k)
        self.min_samples = int(f("sentinel_min_samples")
                               if min_samples is None else min_samples)
        self.interval_s = float(f("sentinel_interval_s")
                                if interval_s is None else interval_s)
        self._detectors: Dict[str, Drift] = {}
        self._hist_state: Dict[str, _HistDelta] = {}
        self._last_check: Optional[float] = None
        self.checks = 0
        self.anomalies_total = 0
        self.recent: deque = deque(maxlen=int(
            f("sentinel_history") if history is None else history))
        # burst probe: a build is anomalous only once the process has shown
        # it runs warm (min_samples sweeps without one)
        self._compiles = registry.counter("jit.backend_compiles")
        self._compiles_seen = self._compiles.value
        self._warm_sweeps = 0
        self._spec_acc = registry.counter("serving.spec.accepted_tokens")
        self._spec_drf = registry.counter("serving.spec.drafted_tokens")
        self._spec_seen = (self._spec_acc.value, self._spec_drf.value)

    # --------------------------------------------------------- detectors --
    def _detector(self, series: str,
                  min_dev: float = _ABS_FLOOR) -> Drift:
        d = self._detectors.get(series)
        if d is None:
            d = self._detectors[series] = Drift(self.alpha, self.k,
                                                self.min_samples,
                                                min_dev=min_dev)
        return d

    def _flag(self, series: str, kind: str, value: float, baseline: float,
              ratio: float, now: float) -> dict:
        # wall-clock stamp: records from several processes are merged
        rec = {"series": series, "kind": kind, "value": round(value, 4),
               "baseline": round(baseline, 4), "ratio": round(ratio, 3),
               "t": round(time.time(), 3)}
        self.anomalies_total += 1
        self.recent.append(rec)
        # label values come from the fixed watch list, never request data
        self._registry.counter("observability.anomaly",
                               series=str(series), kind=str(kind)).inc()
        if self._tracer.enabled:
            self._tracer.instant("observability.anomaly", cat="sentinel",
                                 tid="sentinel", args=rec)
        if self._fr is not None:
            # off the engine thread: a dump writes the whole ring to disk,
            # and a latency anomaly must not cause a latency spike
            threading.Thread(target=self._fr.dump,
                             kwargs={"reason": "anomaly"},
                             name="sentinel-dump", daemon=True).start()
        return rec

    # ------------------------------------------------------------- sweep --
    def maybe_check(self, now: Optional[float] = None) -> List[dict]:
        """Time-gated ``check()``: one float compare inside the
        interval."""
        now = time.perf_counter() if now is None else now
        if self._last_check is not None and \
                now - self._last_check < self.interval_s:
            return []
        return self.check(now)

    def check(self, now: Optional[float] = None) -> List[dict]:
        """One sweep over every watched series; returns the anomalies it
        flagged (none in the steady state)."""
        now = time.perf_counter() if now is None else now
        self._last_check = now
        self.checks += 1
        out: List[dict] = []

        for fam in self.HIST_FAMILIES:
            for h in self._registry.find(fam, "histogram"):
                name = _metrics._series_name(h.name, h.labels)
                st = self._hist_state.get(name)
                if st is None:
                    st = self._hist_state[name] = _HistDelta()
                v = st.sample(h)
                if v is None:
                    continue
                det = self._detector(name)
                base = det.mean
                ratio = det.update(v)
                if ratio is not None:
                    out.append(self._flag(name, "drift", v, base, ratio,
                                          now))

        for fam in self.GAUGE_FAMILIES:
            for g in self._registry.find(fam, "gauge"):
                name = _metrics._series_name(g.name, g.labels)
                det = self._detector(name)
                base = det.mean
                ratio = det.update(float(g.value))
                if ratio is not None:
                    out.append(self._flag(name, "drift", float(g.value),
                                          base, ratio, now))

        # kernel-build burst: after min_samples build-free sweeps the
        # process is warm, and any build after that is an anomaly
        c = self._compiles.value
        fresh = c - self._compiles_seen
        self._compiles_seen = c
        if fresh > 0:
            if self._warm_sweeps >= self.min_samples:
                out.append(self._flag("jit.backend_compiles", "burst",
                                      float(fresh), 0.0, float(fresh),
                                      now))
            self._warm_sweeps = 0
        else:
            self._warm_sweeps += 1

        # speculative accept rate per sweep against its baseline
        acc, drf = self._spec_acc.value, self._spec_drf.value
        da, dd = acc - self._spec_seen[0], drf - self._spec_seen[1]
        self._spec_seen = (acc, drf)
        if dd > 0:
            det = self._detector("serving.spec.accept_rate",
                                 min_dev=_RATE_FLOOR)
            base = det.mean
            ratio = det.update(da / dd)
            if ratio is not None:
                out.append(self._flag("serving.spec.accept_rate", "drift",
                                      da / dd, base, ratio, now))
        return out

    # ------------------------------------------------------------- export --
    def state(self) -> dict:
        """The /statusz ``anomalies`` section: totals, recent records and
        every detector's live baseline."""
        return {"checks": self.checks,
                "anomalies_total": self.anomalies_total,
                "recent": list(self.recent),
                "detectors": {name: d.state()
                              for name, d in sorted(
                                  dict(self._detectors).items())}}
