"""Crash flight recorder: a bounded ring of recent trace spans plus periodic
registry snapshots, dumped as a Chrome-trace file when the process dies
badly (port of ``paddle_tpu/observability/flight_recorder.py``).

The recorder attaches a ``deque(maxlen=FLAGS_flight_recorder_events)`` as
the tracer's ring sink (every span lands there whether or not the flat
buffer is started; the deque bound makes eviction free), folds a registry
snapshot in every ``FLAGS_flight_recorder_snapshot_s`` seconds as an
instant event, and dumps the ring and a final snapshot on any wired
trigger:

- **watchdog timeout**: a ``CommTaskManager`` timeout hook
  (``distributed/watchdog.py``): a hung engine step dumps the window that
  led up to it;
- **SIGTERM**: the dump runs before the previous handler (or the default
  termination);
- **unhandled crash**: ``sys.excepthook`` and ``threading.excepthook``
  wrappers.

A dump file carries the trigger reason and the process id in its name, so
no dump clobbers another; ``metadata`` holds the final registry snapshot
and the reason.
"""

from __future__ import annotations

import json
import os
import re
import signal
import sys
import threading
import time
from collections import deque
from typing import Optional

from .. import flags
from . import metrics as _metrics
from .tracing import TRACER

__all__ = ["FlightRecorder"]

_DUMPS = _metrics.counter("flight_recorder.dumps")
# same-reason dumps swallowed by the rate limit
_SUPPRESSED = _metrics.counter("flight_recorder.suppressed_dumps")


class FlightRecorder:
    """Bounded span ring + snapshot folding + crash-triggered dump.

    Serving wiring::

        fr = FlightRecorder()
        fr.install()            # ring + watchdog hook + SIGTERM + excepthook
        fr.maybe_snapshot()     # from the engine loop, time-gated
        fr.uninstall()

    ``dump()`` can be called directly; the triggers call it with their
    reason."""

    def __init__(self, path: Optional[str] = None,
                 max_events: Optional[int] = None,
                 snapshot_every_s: Optional[float] = None,
                 min_interval_s: Optional[float] = None,
                 tracer=TRACER, registry=_metrics.REGISTRY):
        self.path = path or str(flags.flag("flight_recorder_path"))
        self.max_events = int(max_events
                              or flags.flag("flight_recorder_events"))
        self.snapshot_every_s = float(
            snapshot_every_s if snapshot_every_s is not None
            else flags.flag("flight_recorder_snapshot_s"))
        # per-REASON rate limit: a storm of same-reason triggers yields one
        # file a window; distinct reasons never shadow each other
        self.min_interval_s = float(
            min_interval_s if min_interval_s is not None
            else flags.flag("flight_recorder_min_interval_s"))
        self._last_reason_dump: dict = {}   # reason -> (t, path)
        self._tracer = tracer
        self._registry = registry
        self._ring: deque = deque(maxlen=self.max_events)
        self._last_snap: Optional[float] = None
        # reentrant: a SIGTERM arriving inside dump() dumps again
        self._dump_lock = threading.RLock()
        self._manager = None
        self._old_sigterm = None
        self._old_excepthook = None
        self._old_thread_excepthook = None
        self._installed = False
        self.last_dump: Optional[str] = None

    # ------------------------------------------------------------ ring --
    def attach(self) -> "FlightRecorder":
        """Start recording spans into the ring (idempotent)."""
        self._tracer.attach_ring(self._ring)
        return self

    def detach(self) -> None:
        if getattr(self._tracer, "_ring", None) is self._ring:
            self._tracer.detach_ring()

    def maybe_snapshot(self, now: Optional[float] = None) -> bool:
        """Fold a registry snapshot into the ring once the period has
        elapsed.  Cheap to call every engine-loop iteration."""
        now = time.perf_counter() if now is None else now
        if self._last_snap is not None and \
                now - self._last_snap < self.snapshot_every_s:
            return False
        self._last_snap = now
        self.snapshot_now(now)
        return True

    def events(self) -> list:
        """A copy of the ring's buffered events (the trace collector's
        fleet-dump provider).  Retries when a writer mutates the deque
        mid-copy."""
        while True:
            try:
                return list(self._ring)
            except RuntimeError:
                continue

    def snapshot_now(self, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        self._ring.append({"ph": "i", "s": "g", "pid": 0, "tid": 0,
                           "name": "registry.snapshot", "cat": "flightrec",
                           "ts": now * 1e6,
                           "args": self._registry.snapshot()})

    # ------------------------------------------------------------ dump --
    def _dump_path(self, reason: str) -> str:
        stem, ext = os.path.splitext(self.path)
        tag = re.sub(r"[^A-Za-z0-9_.-]", "_", reason) if reason else "manual"
        return f"{stem}_{tag}_p{os.getpid()}{ext or '.json'}"

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> str:
        """Write ring + final registry snapshot as Chrome-trace JSON;
        returns the path.  Safe from any thread (watchdog poller, signal
        handler, excepthook): serialized by a lock, never raises."""
        with self._dump_lock:
            prev = self._last_reason_dump.get(reason)
            if prev is not None and path is None and \
                    self.min_interval_s > 0 and \
                    time.perf_counter() - prev[0] < self.min_interval_s:
                # the window's first file stands as its evidence
                _SUPPRESSED.inc()
                return prev[1]
            out = path or self._dump_path(reason)
            try:
                # other threads may append spans while we copy: retry the
                # copy a few times, then settle for less
                events: list = []
                for _ in range(5):
                    try:
                        events = (self._tracer.thread_metadata()
                                  + list(self._ring))
                        break
                    except RuntimeError:
                        continue
                try:
                    registry = self._registry.snapshot()
                except Exception:
                    registry = None
                doc = {"traceEvents": events,
                       "displayTimeUnit": "ms",
                       "metadata": {
                           "producer":
                               "paddle_tpu_torch.observability."
                               "flight_recorder",
                           "reason": reason,
                           "ring_events": len(self._ring),
                           "ring_capacity": self.max_events,
                           "registry": registry}}
                d = os.path.dirname(os.path.abspath(out))
                if d:
                    os.makedirs(d, exist_ok=True)
                with open(out, "w") as f:
                    json.dump(doc, f)
            except Exception as e:      # a dying process must still die
                print(f"[paddle_tpu_torch flight_recorder] dump failed: "
                      f"{e}", file=sys.stderr)
                return out
            _DUMPS.inc()
            self._last_reason_dump[reason] = (time.perf_counter(), out)
            self.last_dump = out
            print(f"[paddle_tpu_torch flight_recorder] {reason}: dumped "
                  f"{len(events)} events -> {out}", file=sys.stderr)
            return out

    # ------------------------------------------------------ installation --
    def install(self, *, watchdog: bool = True, sigterm: bool = True,
                excepthook: bool = True, manager=None) -> "FlightRecorder":
        """Attach the ring and wire the dump triggers.  ``manager`` is a
        ``CommTaskManager`` (default: the process singleton).  The SIGTERM
        handler is skipped off the main thread."""
        if self._installed:
            # a second install would chain our hooks to themselves
            self.attach()
            return self
        self._installed = True
        self.attach()
        if watchdog:
            if manager is None:
                from ..distributed.watchdog import get_comm_task_manager
                manager = get_comm_task_manager()
            self._manager = manager
            manager.add_timeout_hook(self._on_watchdog_timeout)
        if sigterm:
            try:
                self._old_sigterm = signal.signal(signal.SIGTERM,
                                                  self._on_sigterm)
            except ValueError:          # not the main thread
                self._old_sigterm = None
        if excepthook:
            self._old_excepthook = sys.excepthook
            sys.excepthook = self._on_crash
            # the engine thread dies through threading.excepthook
            self._old_thread_excepthook = threading.excepthook
            threading.excepthook = self._on_thread_crash
        return self

    def uninstall(self) -> None:
        self.detach()
        if self._manager is not None:
            self._manager.remove_timeout_hook(self._on_watchdog_timeout)
            self._manager = None
        if self._old_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._old_sigterm)
            except ValueError:
                pass
            self._old_sigterm = None
        if self._old_excepthook is not None:
            sys.excepthook = self._old_excepthook
            self._old_excepthook = None
        if self._old_thread_excepthook is not None:
            threading.excepthook = self._old_thread_excepthook
            self._old_thread_excepthook = None
        self._installed = False

    # ------------------------------------------------------------ hooks --
    def _on_watchdog_timeout(self, task) -> None:
        self.dump(reason=f"watchdog-{task.name}")

    def _on_sigterm(self, signum, frame) -> None:
        self.dump(reason="sigterm")
        old = self._old_sigterm
        if callable(old):
            old(signum, frame)
        elif old != signal.SIG_IGN:
            # SIG_DFL (or a handler signal.signal could not report):
            # restore the default and re-deliver, so the process ends with
            # the SIGTERM status
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    def _on_crash(self, exc_type, exc, tb) -> None:
        self.dump(reason=f"crash-{exc_type.__name__}")
        (self._old_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    def _on_thread_crash(self, args) -> None:
        self.dump(reason=f"crash-{args.exc_type.__name__}"
                         f"-{args.thread.name if args.thread else 'thread'}")
        (self._old_thread_excepthook or threading.__excepthook__)(args)
