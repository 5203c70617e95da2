"""Process-wide metrics registry: counters, gauges and histograms with
labeled series, lock-free on the hot path, with a JSON snapshot and a
Prometheus-text exposition (port of ``paddle_tpu/observability/metrics.py``).

Every subsystem of the port increments series in ONE registry: the serving
engine's TTFT/ITL/queue histograms, the page-pool and prefix-cache books,
the kernel build counts, the watchdog.  "What is this process doing" is one
``snapshot()``.

Concurrency: the hot path (``Counter.inc``, ``Gauge.set``,
``Histogram.observe`` on an existing series) is plain Python arithmetic on
instance attributes, atomic enough under the GIL for monotonic telemetry;
only series creation takes the registry lock.  Callers resolve their handles
once (the engine at construction), so the steady state never looks a
series up.

The exposition keeps the reference's ``paddle_tpu_`` metric prefix, so a
scrape of either package reads the same names.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

from .. import flags

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "snapshot", "prometheus_text",
           "reset", "find", "set_help", "OVERFLOW_LABEL"]

# the label set every over-cap series of a family folds into (the
# FLAGS_metrics_max_series cardinality guard)
OVERFLOW_LABEL = "__overflow__"

# default bucket ladder: 1/2/5 per decade over 1e-3 .. 1e5, covering
# sub-microsecond spans (in ms) through minute-long steps and 0..1 ratios
_DEFAULT_BOUNDS = tuple(m * 10.0 ** e for e in range(-3, 6)
                        for m in (1.0, 2.0, 5.0))


class Counter:
    """Monotonic counter.  ``inc`` is the hot path: one add, no lock."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Fixed-bound histogram with count/sum/min/max and bucket counts.

    ``observe`` is the hot path: one bisect and five scalar updates.
    Percentiles are estimated from the cumulative bucket counts, linear
    within the winning bucket (good to the bucket ratio, <= 2.5x)."""

    __slots__ = ("name", "labels", "bounds", "bucket_counts", "count",
                 "sum", "min", "max")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 bounds: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.labels = labels
        self.bounds = tuple(bounds) if bounds else _DEFAULT_BOUNDS
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +1: +Inf
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.bucket_counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0, 1]) from the bucket counts."""
        if not self.count:
            return None
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.bucket_counts):
            if not c:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min if self.min != math.inf else lo)
                hi = min(hi, self.max if self.max != -math.inf else hi)
                if hi < lo:
                    hi = lo
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.max

    def summary(self) -> Dict[str, Optional[float]]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                    "max": None, "p50": None, "p95": None, "p99": None}
        return {"count": self.count, "sum": round(self.sum, 6),
                "mean": round(self.sum / self.count, 6),
                "min": round(self.min, 6), "max": round(self.max, 6),
                "p50": round(self.percentile(0.5), 6),
                "p95": round(self.percentile(0.95), 6),
                "p99": round(self.percentile(0.99), 6)}

    def nonzero_buckets(self) -> List[List[float]]:
        """[[le_bound, count], ...] for populated buckets (+Inf = None)."""
        out = []
        for i, c in enumerate(self.bucket_counts):
            if c:
                le = self.bounds[i] if i < len(self.bounds) else None
                out.append([le, c])
        return out


def _series_key(name: str, labels: Dict[str, str]):
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


def _series_name(name: str, labels) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricRegistry:
    """Name -> labeled-series map.  Looking up an existing series is one
    dict get (no lock); creation is double-checked under the lock.

    Cardinality guard: at most ``FLAGS_metrics_max_series`` LABELED series
    per (kind, family).  Past the cap every further label set resolves to
    the family's one ``{series=__overflow__}`` series and
    ``metrics.dropped_series`` counts the miss.  The unlabeled series and
    the overflow series never count toward the cap."""

    def __init__(self):
        self._counters: Dict[tuple, Counter] = {}
        self._gauges: Dict[tuple, Gauge] = {}
        self._histograms: Dict[tuple, Histogram] = {}
        self._nlabeled: Dict[tuple, int] = {}   # (kind, family) -> count
        self._help: Dict[str, str] = {}
        # reentrant: a SIGTERM handler (flight-recorder dump -> snapshot)
        # may interrupt a frame of the main thread that holds the lock
        self._lock = threading.RLock()
        # made directly: _get bumps it while holding the lock
        self._dropped = Counter("metrics.dropped_series")
        self._counters[_series_key("metrics.dropped_series", {})] = \
            self._dropped

    def _get(self, table, cls, name, labels, **kw):
        key = _series_key(name, labels)
        m = table.get(key)
        if m is None:
            with self._lock:
                m = table.get(key)
                if m is None:
                    fam = (cls.__name__, name)
                    cap = int(flags.flag("metrics_max_series"))
                    if key[1] and cap > 0 \
                            and self._nlabeled.get(fam, 0) >= cap:
                        # family at the cap: fold into the overflow series
                        okey = (name, (("series", OVERFLOW_LABEL),))
                        m = table.get(okey)
                        if m is None:
                            m = cls(name, okey[1], **kw)
                            table[okey] = m
                        self._dropped.inc()
                        return m
                    m = cls(name, key[1], **kw)
                    table[key] = m
                    if key[1] and key[1] != (("series", OVERFLOW_LABEL),):
                        self._nlabeled[fam] = self._nlabeled.get(fam, 0) + 1
        return m

    def set_help(self, name: str, text: str) -> None:
        """Attach a ``# HELP`` line to a family (the exposition falls back
        to the family's dotted name)."""
        self._help[name] = text

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, bounds=None, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels,
                         bounds=bounds)

    def find(self, name: str, kind: Optional[str] = None) -> list:
        """Every series of family ``name`` (all label sets)."""
        tables = {"counter": [self._counters], "gauge": [self._gauges],
                  "histogram": [self._histograms]}.get(
            kind, [self._counters, self._gauges, self._histograms])
        out = []
        for t in tables:
            out.extend(m for (n, _), m in list(t.items()) if n == name)
        return out

    def families(self) -> Dict[str, str]:
        """Family name -> kind for every series made in this process (the
        surface the catalog's drift test audits)."""
        out: Dict[str, str] = {}
        with self._lock:
            for table, kind in ((self._counters, "counter"),
                                (self._gauges, "gauge"),
                                (self._histograms, "histogram")):
                for (n, _lb) in table:
                    out.setdefault(n, kind)
        return out

    def reset(self, prefix: str = "") -> None:
        """Zero every series whose name starts with ``prefix`` ("" = all),
        in place, so handles the hot paths resolved keep recording into
        the same objects."""
        with self._lock:
            for t in (self._counters, self._gauges):
                for key, m in t.items():
                    if key[0].startswith(prefix):
                        m.value = 0
            for key, h in self._histograms.items():
                if key[0].startswith(prefix):
                    h.bucket_counts = [0] * (len(h.bounds) + 1)
                    h.count = 0
                    h.sum = 0.0
                    h.min = math.inf
                    h.max = -math.inf

    # ------------------------------------------------------------ export --
    def snapshot(self) -> Dict[str, dict]:
        """JSON-able view of every series; histograms carry their summary
        and their populated ``[le, count]`` buckets."""
        out: Dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        # copied under the lock: exports run beside series creation
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        for (n, lb), c in counters:
            out["counters"][_series_name(n, lb)] = c.value
        for (n, lb), g in gauges:
            out["gauges"][_series_name(n, lb)] = g.value
        for (n, lb), h in hists:
            out["histograms"][_series_name(n, lb)] = {
                **h.summary(), "buckets": h.nonzero_buckets()}
        return out

    def prometheus_text(self, namespace: str = "paddle_tpu") -> str:
        """Prometheus text exposition of the whole registry in the line
        format a strict parser accepts: ``# HELP`` and ``# TYPE`` once per
        family (help escaped), metric and label names sanitized, label
        values escaped, histograms as cumulative ``_bucket{le=...}``
        ladders ending at ``le="+Inf"`` plus ``_sum`` and ``_count``."""
        def sane(name):
            return re.sub(r"[^a-zA-Z0-9_:]", "_", namespace + "_" + name)

        def sane_label(name):
            return re.sub(r"[^a-zA-Z0-9_]", "_", name)

        def esc(v):
            return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                .replace("\n", "\\n")

        def esc_help(v):
            return str(v).replace("\\", "\\\\").replace("\n", "\\n")

        def lbl(labels, extra=()):
            items = tuple(labels) + tuple(extra)
            if not items:
                return ""
            return "{" + ",".join(
                f'{sane_label(k)}="{esc(v)}"' for k, v in items) + "}"

        def num(v):
            if v != v:
                return "NaN"
            if v == math.inf:
                return "+Inf"
            if v == -math.inf:
                return "-Inf"
            return repr(v) if isinstance(v, float) else str(v)

        def families(table):
            with self._lock:
                items = sorted(table.items())
            fams: Dict[str, list] = {}
            for (n, lb), m in items:
                fams.setdefault(n, []).append((lb, m))
            return sorted(fams.items())

        lines: List[str] = []

        def head(n, kind):
            lines.append(
                f"# HELP {sane(n)} {esc_help(self._help.get(n, n))}")
            lines.append(f"# TYPE {sane(n)} {kind}")

        for n, group in families(self._counters):
            head(n, "counter")
            for lb, c in group:
                lines.append(f"{sane(n)}{lbl(lb)} {num(c.value)}")
        for n, group in families(self._gauges):
            head(n, "gauge")
            for lb, g in group:
                lines.append(f"{sane(n)}{lbl(lb)} {num(g.value)}")
        for n, group in families(self._histograms):
            head(n, "histogram")
            base = sane(n)
            for lb, h in group:
                cum = 0
                for i, cnt in enumerate(h.bucket_counts):
                    cum += cnt
                    le = (f"{h.bounds[i]:g}" if i < len(h.bounds)
                          else "+Inf")
                    lines.append(
                        f"{base}_bucket{lbl(lb, (('le', le),))} {cum}")
                lines.append(f"{base}_sum{lbl(lb)} {num(h.sum)}")
                lines.append(f"{base}_count{lbl(lb)} {h.count}")
        return "\n".join(lines) + "\n"


REGISTRY = MetricRegistry()

# module-level conveniences bound to the process-wide registry
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
prometheus_text = REGISTRY.prometheus_text
reset = REGISTRY.reset
find = REGISTRY.find
set_help = REGISTRY.set_help
