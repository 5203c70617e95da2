"""Metrics and tracing runtime of the port (port of
``paddle_tpu/observability``).

One process-wide registry (``metrics``) and one span tracer (``tracer``)
behind every subsystem's telemetry:

- **serving**: the continuous-batching engine records per-request
  lifecycles (enqueue -> admission -> prefill -> first token -> decode ->
  retire) as TTFT/ITL/queue-wait/occupancy histograms and page-pool and
  prefix-cache gauges (``serving.*``), all stamped from host timestamps at
  the existing drain, so the step loop stays free of device syncs.
- **training**: ``StepTimer`` records step wall time, tokens/s, builds
  per step and analytic gradient-sync bytes (``train.*``) from host
  timestamps only.
- **compile**: the port compiles no graphs; its compiles are the CUDA
  kernel builds and library loads of ``kernels/_build.py``, which feed
  ``jit.backend_compiles`` / ``jit.backend_compile_ms`` through
  :func:`record_compile`.  After warm-up any of them is an anomaly.

``assert_overhead`` bounds both kernel builds and marked host<->device
syncs (``count_sync``) across a block: the warm-step contract of the
serving engine, asserted in tests.
"""

from __future__ import annotations

import time
from typing import Optional

from .. import flags
from . import catalog, metrics, tracing
from .attribution import StepAttribution
from .collector import (ClockSync, HttpTransport, InprocTransport,
                        SpanExporter, StoreTransport, TraceCollector)
from .flight_recorder import FlightRecorder
from .metrics import (REGISTRY, counter, find, gauge, histogram,
                      prometheus_text, reset, set_help, snapshot)
from .sentinel import Sentinel
from .tracing import TRACER, Tracer

tracer = TRACER

__all__ = ["metrics", "tracing", "catalog", "REGISTRY", "counter", "gauge",
           "histogram", "snapshot", "prometheus_text", "reset", "find",
           "set_help", "tracer", "Tracer", "TRACER", "FlightRecorder",
           "StepAttribution", "Sentinel",
           "ClockSync", "SpanExporter", "TraceCollector",
           "InprocTransport", "StoreTransport", "HttpTransport",
           "metrics_enabled", "count_sync", "device_syncs",
           "record_compile", "backend_compiles", "assert_overhead",
           "StepTimer", "export_chrome_trace"]


def metrics_enabled() -> bool:
    """Master switch for hot-path instrumentation (``FLAGS_metrics``)."""
    return bool(flags.flag("metrics"))


def export_chrome_trace(path: str) -> str:
    return TRACER.export_chrome_trace(path)


# ---------------------------------------------------------------------------
# compile telemetry: the process-wide kernel build counter
# ---------------------------------------------------------------------------

_BACKEND_COMPILES = metrics.counter("jit.backend_compiles")
_COMPILE_MS = metrics.histogram("jit.backend_compile_ms")


def record_compile(seconds: float) -> None:
    """Count one kernel build or library load that took ``seconds``
    (called by ``kernels/_build.py``)."""
    _BACKEND_COMPILES.inc()
    _COMPILE_MS.observe(seconds * 1e3)


def backend_compiles() -> int:
    """Process-wide kernel builds and loads so far."""
    return int(_BACKEND_COMPILES.value)


# ---------------------------------------------------------------------------
# marked host<->device syncs
# ---------------------------------------------------------------------------

_SYNCS = metrics.counter("host.device_syncs")


def count_sync(n: int = 1) -> None:
    """Mark an intentional blocking host<->device read (the serving drain,
    the spill tier's eviction copy, a migration's page readback).
    ``assert_overhead`` bounds the count across a block."""
    _SYNCS.inc(n)


def device_syncs() -> int:
    """Process-wide marked syncs so far."""
    return int(_SYNCS.value)


class assert_overhead:
    """Context manager bounding the overhead contract: at most
    ``max_compiles`` kernel builds and ``max_syncs`` marked host<->device
    syncs inside the block::

        with observability.assert_overhead(max_compiles=0, max_syncs=0):
            for _ in range(32):
                engine.step()          # warm steps: no build, no sync

    ``record=True`` never raises; ``.compiles`` / ``.syncs`` hold the
    observed deltas either way."""

    def __init__(self, max_compiles: int = 0, max_syncs: int = 0,
                 record: bool = False):
        self.max_compiles = max_compiles
        self.max_syncs = max_syncs
        self.record = record
        self.compiles = 0
        self.syncs = 0

    def __enter__(self):
        self._c0 = _BACKEND_COMPILES.value
        self._s0 = _SYNCS.value
        return self

    def __exit__(self, exc_type, exc, tb):
        self.compiles = _BACKEND_COMPILES.value - self._c0
        self.syncs = _SYNCS.value - self._s0
        if exc_type is None and not self.record:
            if self.compiles > self.max_compiles:
                raise AssertionError(
                    f"{self.compiles} kernel build(s) inside an "
                    f"assert_overhead(max_compiles={self.max_compiles}) "
                    "block: the warm path built a kernel")
            if self.syncs > self.max_syncs:
                raise AssertionError(
                    f"{self.syncs} marked device sync(s) inside an "
                    f"assert_overhead(max_syncs={self.max_syncs}) block: "
                    "instrumentation added a host<->device round trip")
        return False


# ---------------------------------------------------------------------------
# train-step telemetry
# ---------------------------------------------------------------------------

class StepTimer:
    """Per-step train telemetry from host timestamps only (wall time is
    dispatch-to-dispatch, which converges to the true step time in any
    steady loop whose caller eventually syncs).

    Records under ``<name>.``: ``steps`` (counter), ``step_ms`` (histogram,
    warm steps only), ``tokens_per_sec`` (gauge, last warm step),
    ``recompiles`` (counter: kernel builds inside a step; such steps stay
    out of ``step_ms``) and ``grad_comm_bytes`` (counter)."""

    def __init__(self, name: str = "train"):
        self.name = name
        self._steps = metrics.counter(f"{name}.steps")
        self._step_ms = metrics.histogram(f"{name}.step_ms")
        self._tps = metrics.gauge(f"{name}.tokens_per_sec")
        self._recompiles = metrics.counter(f"{name}.recompiles")
        self._comm = metrics.counter(f"{name}.grad_comm_bytes")
        self._last: Optional[float] = None
        self._compiles_seen = _BACKEND_COMPILES.value

    def begin_step(self) -> None:
        """Snapshot the build counter at step entry, so ``tick`` counts
        only the builds inside the step."""
        self._compiles_seen = _BACKEND_COMPILES.value

    def tick(self, tokens: int = 0, comm_bytes: int = 0) -> None:
        """Call once per dispatched step, after the dispatch."""
        now = time.perf_counter()
        self._steps.inc()
        c = _BACKEND_COMPILES.value
        fresh = c - self._compiles_seen
        self._compiles_seen = c
        if fresh:
            self._recompiles.inc(fresh)
        if comm_bytes:
            self._comm.inc(comm_bytes)
        if self._last is not None and not fresh:
            dt = now - self._last
            self._step_ms.observe(dt * 1e3)
            if tokens and dt > 0:
                self._tps.set(tokens / dt)
            if TRACER.enabled:
                TRACER.event(f"{self.name}.step", self._last, dt,
                             cat="train", tid=self.name,
                             args={"tokens": tokens})
        self._last = now
