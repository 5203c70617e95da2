"""Hang watchdog over outstanding device work (port of
``paddle_tpu/distributed/watchdog.py``).

A hang shows up as a device step that never returns.  Work registers a
heartbeat before it blocks (``begin``/``end``, or the ``watch`` context); a
background thread flags work that runs past ``FLAGS_comm_timeout_s``,
prints the live task table and runs the registered timeout hooks (the
flight recorder's dump).  The serving front door watches every engine step
this way.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Dict, Optional

from .. import flags


@dataclass
class _Task:
    name: str
    started: float
    stack: str = ""
    done: bool = False


class CommTaskManager:
    """Watchdog thread over outstanding work.

    Registry telemetry: ``watchdog.last_heartbeat_age_s`` (seconds since the
    last ``begin()``, refreshed every poll), ``watchdog.outstanding_tasks``
    and ``watchdog.timeouts``.  ``poll_interval`` is an instance attribute
    so tests can tighten the tick."""

    poll_interval = 1.0

    def __init__(self):
        self._tasks: Dict[int, _Task] = {}
        self._lock = threading.Lock()
        self._next = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.timed_out: list = []
        self._last_heartbeat: Optional[float] = None
        self._timeout_hooks: list = []
        from ..observability import metrics as _metrics
        self._hb_gauge = _metrics.gauge("watchdog.last_heartbeat_age_s")
        self._out_gauge = _metrics.gauge("watchdog.outstanding_tasks")
        self._timeout_ctr = _metrics.counter("watchdog.timeouts")

    def add_timeout_hook(self, fn):
        """Register ``fn(task)`` to run on the poller thread whenever a
        watched task exceeds the timeout.  A hook's exception is printed
        and the watchdog keeps polling."""
        self._timeout_hooks.append(fn)
        return fn

    def remove_timeout_hook(self, fn):
        try:
            self._timeout_hooks.remove(fn)
        except ValueError:
            pass

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def begin(self, name: str) -> int:
        with self._lock:
            tid = self._next
            self._next += 1
            stack = "".join(traceback.format_stack(limit=8)) \
                if flags.flag("enable_async_trace") else ""
            self._tasks[tid] = _Task(name, time.time(), stack)
            self._last_heartbeat = time.time()
            self._hb_gauge.set(0.0)
            self._out_gauge.set(len(self._tasks))
            return tid

    def end(self, tid: int):
        with self._lock:
            self._tasks.pop(tid, None)
            self._out_gauge.set(len(self._tasks))

    def outstanding(self):
        with self._lock:
            return list(self._tasks.values())

    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            timeout = flags.flag("comm_timeout_s")
            now = time.time()
            with self._lock:
                hung = [t for t in self._tasks.values()
                        if now - t.started >= timeout]
                if self._last_heartbeat is not None:
                    self._hb_gauge.set(now - self._last_heartbeat)
                self._out_gauge.set(len(self._tasks))
            for t in hung:
                self.timed_out.append(t)
                self._timeout_ctr.inc()
                self._dump(t, now)
                for fn in list(self._timeout_hooks):
                    try:
                        fn(t)
                    except Exception as e:
                        print(f"[paddle_tpu_torch watchdog] timeout hook "
                              f"{fn!r} raised: {e}", file=sys.stderr)
                with self._lock:
                    self._tasks = {k: v for k, v in self._tasks.items()
                                   if v is not t}
                    self._out_gauge.set(len(self._tasks))

    def _dump(self, task: _Task, now: float):
        print(f"[paddle_tpu_torch watchdog] task '{task.name}' exceeded "
              f"{flags.flag('comm_timeout_s')}s (running "
              f"{now - task.started:.1f}s). Outstanding tasks: "
              f"{[t.name for t in self.outstanding()]}", file=sys.stderr)
        if task.stack:
            print(task.stack, file=sys.stderr)


_MANAGER: Optional[CommTaskManager] = None


def get_comm_task_manager() -> CommTaskManager:
    """The process's watchdog, started on first use."""
    global _MANAGER
    if _MANAGER is None:
        _MANAGER = CommTaskManager().start()
    return _MANAGER


class watch:
    """Context manager registering a named task with the watchdog."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._tid = get_comm_task_manager().begin(self.name)
        return self

    def __exit__(self, *exc):
        get_comm_task_manager().end(self._tid)
        return False
