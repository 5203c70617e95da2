"""Span-based host tracer with Chrome-trace / Perfetto JSON export (port of
``paddle_tpu/observability/tracing.py``).

Host spans (engine steps, the retroactive per-request serving lifecycles,
migrations) land in one in-memory event buffer exported as the Chrome
``traceEvents`` JSON that chrome://tracing and https://ui.perfetto.dev
load.  The device timeline is ``torch.profiler``'s job: ``device_trace``
wraps a ``torch.profiler.profile`` over the CPU and CUDA activities around a
block and writes its Chrome trace beside the host one.

Stopped (the default) the tracer costs one attribute check per
instrumentation site.  Started, each span is one buffer append; the buffer
is capped (``FLAGS_trace_max_events``) and the overflow is counted in the
exported file's metadata and in ``tracing.dropped_events``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

from .. import flags
from . import metrics as _metrics

__all__ = ["Tracer", "TRACER", "device_tracing_available"]

_DROPPED_EVENTS = _metrics.counter("tracing.dropped_events")


def device_tracing_available() -> bool:
    """True when a device trace may start: a CUDA device is present."""
    return torch.cuda.is_available()


class Tracer:
    """Chrome-trace event buffer.  Timestamps ride ``time.perf_counter()``
    (µs in the export), so retroactive events can be stamped from any
    saved reading."""

    def __init__(self, max_events: Optional[int] = None):
        self._events: List[dict] = []
        self._enabled = False
        self._active = False
        self._max = max_events
        self._ring = None           # flight-recorder sink (bounded deque)
        self._export = None         # span-export sink (collector shipping)
        self.dropped = 0
        self._tids: Dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        """True when spans are recorded anywhere: the flat buffer
        (``start``), an attached flight-recorder ring or an attached span
        exporter.  Every
        instrumentation site gates on this one attribute."""
        return self._active

    # -------------------------------------------------------- lifecycle --
    def start(self, clear: bool = True) -> "Tracer":
        if clear:
            self._events = []
            self.dropped = 0
            self._tids = {}
        self._enabled = True
        self._active = True
        return self

    def stop(self) -> "Tracer":
        self._enabled = False
        self._active = self._ring is not None or self._export is not None
        return self

    def attach_ring(self, ring) -> None:
        """Attach a bounded ``deque(maxlen=...)`` that receives every event
        from now on, with the flat buffer stopped or not (the flight
        recorder's always-on window).  The deque's maxlen is the bound."""
        self._ring = ring
        self._active = True

    def detach_ring(self) -> None:
        self._ring = None
        self._active = self._enabled or self._export is not None

    def attach_export(self, sink) -> None:
        """Attach a span-export sink (any object with a non-blocking
        ``offer(ev)``, such as ``SpanExporter``) that receives every event
        from now on: the fleet tracing's shipping lane.  As with the ring,
        attaching it alone turns span recording on; ``offer`` runs on the
        engine's and the event loop's threads, so the sink must be a
        bounded buffer, never a network call."""
        self._export = sink
        self._active = True

    def detach_export(self) -> None:
        self._export = None
        self._active = self._enabled or self._ring is not None

    # one named lane per request trace id: past this many lanes a name gets
    # a stable hashed tid with no stored metadata (bounded memory)
    MAX_NAMED_LANES = 8192

    # ------------------------------------------------------------ events --
    def _tid(self, tid) -> int:
        """Map a logical lane name ("slot3", a trace id) to a stable
        integer tid, emitting its thread_name metadata on first use."""
        if tid is None:
            return threading.get_ident() & 0x7FFFFFFF
        if isinstance(tid, int):
            return tid
        n = self._tids.get(tid)
        if n is None:
            with self._lock:
                n = self._tids.get(tid)
                if n is None:
                    if len(self._tids) >= self.MAX_NAMED_LANES:
                        return (hash(tid) & 0x3FFFFFFF) \
                            + self.MAX_NAMED_LANES + 1
                    n = len(self._tids) + 1
                    self._tids[tid] = n
                    self._append({"ph": "M", "pid": 0, "tid": n,
                                  "name": "thread_name",
                                  "args": {"name": tid}})
        return n

    def lane_names(self) -> Dict[int, str]:
        """Snapshot of the integer tid -> lane name map (request trace ids,
        "train", ...).  Span-export batches carry it, so the collector
        recovers trace ids from the compact integer tids."""
        with self._lock:
            return {n: name for name, n in self._tids.items()}

    def thread_metadata(self) -> List[dict]:
        """Fresh thread_name events for every known lane (a ring dump
        prepends them: the originals may have been evicted)."""
        return [{"ph": "M", "pid": 0, "tid": n, "name": "thread_name",
                 "args": {"name": name}}
                for name, n in sorted(self._tids.items(), key=lambda x: x[1])]

    def _append(self, ev: dict) -> None:
        ring = self._ring
        if ring is not None:
            ring.append(ev)         # deque(maxlen): oldest out
        exp = self._export
        if exp is not None:
            exp.offer(ev)           # a bounded append, never blocks
        if not self._enabled:
            return
        cap = self._max
        if cap is None:
            cap = int(flags.flag("trace_max_events"))
        if cap and len(self._events) >= cap:
            self.dropped += 1
            _DROPPED_EVENTS.inc()
            return
        self._events.append(ev)

    def event(self, name: str, t0: float, dur: float, *, cat: str = "host",
              tid=None, args: Optional[dict] = None) -> None:
        """Retroactive complete ("X") event: ``t0``/``dur`` in seconds on
        the perf_counter clock (the serving drain stamps request phases
        from timestamps it took at dispatch)."""
        if not self._active:
            return
        ev = {"ph": "X", "name": name, "cat": cat, "pid": 0,
              "tid": self._tid(tid), "ts": t0 * 1e6,
              "dur": max(dur, 0.0) * 1e6}
        if args:
            ev["args"] = args
        self._append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "host", tid=None,
             args: Optional[dict] = None):
        """Context-managed live span around host work."""
        if not self._active:
            yield self
            return
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.event(name, t0, time.perf_counter() - t0, cat=cat,
                       tid=tid, args=args)

    def instant(self, name: str, *, cat: str = "host", tid=None,
                args: Optional[dict] = None) -> None:
        if not self._active:
            return
        ev = {"ph": "i", "s": "t", "name": name, "cat": cat, "pid": 0,
              "tid": self._tid(tid), "ts": time.perf_counter() * 1e6}
        if args:
            ev["args"] = args
        self._append(ev)

    def counter(self, name: str, **values) -> None:
        """Chrome counter ("C") track, e.g. queue depth over time."""
        if not self._active:
            return
        self._append({"ph": "C", "name": name, "pid": 0,
                      "ts": time.perf_counter() * 1e6, "args": dict(values)})

    # ------------------------------------------------------------ export --
    def export_chrome_trace(self, path: str) -> str:
        """Write the buffered events as Chrome-trace JSON; returns path."""
        doc = {"traceEvents": list(self._events),
               "displayTimeUnit": "ms",
               "metadata": {"producer": "paddle_tpu_torch.observability",
                            "dropped_events": self.dropped}}
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Profile the block's CPU and CUDA activity with
        ``torch.profiler`` and write its Chrome trace to
        ``logdir/device_trace.json``; without a CUDA device the block runs
        unprofiled (the host tracer works either way).  Yields whether the
        device trace started."""
        if not device_tracing_available():
            yield False
            return
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        try:
            yield True
        finally:
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir,
                                                  "device_trace.json"))


# the process-wide tracer every subsystem emits into
TRACER = Tracer()
