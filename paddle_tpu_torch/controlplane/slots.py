"""Router slot handles: the supervisor's grip on one router (port of
``paddle_tpu/controlplane/slots.py``).

With the multi-router control plane the routers are supervised slots too,
through the replica slots' state machine (STARTING -> READY, crash ->
BACKOFF -> restart, one restart budget) and a simpler lifecycle: no drain,
since a router's in-flight streams fail over to the ring's survivors through
the store-replicated journal.

``InprocRouterHandle`` backs in-process fleets (no sockets, killable by the
chaos harness); ``ProcessRouterHandle`` spawns ``python -m
paddle_tpu_torch.router --store ... --router-id ...`` for the real launcher
(``python -m paddle_tpu_torch.fleet --routers N``).
"""

from __future__ import annotations

import subprocess
import sys
from typing import Callable, List, Optional

__all__ = ["RouterHandle", "InprocRouterHandle", "ProcessRouterHandle"]


class RouterHandle:
    """The lifecycle surface of one managed router slot."""

    def __init__(self, rid: str):
        self.id = rid

    def spawn(self) -> None:
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def ready(self) -> bool:
        raise NotImplementedError

    def stop(self, timeout_s: float = 5.0) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    def describe(self) -> dict:
        return {"kind": type(self).__name__}


class InprocRouterHandle(RouterHandle):
    """An in-process ``RouterServer`` as a supervised slot.

    ``factory(rid)`` builds the router (wired to its plane and peers by the
    harness).  ``kill`` marks the handle dead and calls ``on_kill``: the
    harness's hook to sever the victim's in-flight client streams, the
    in-process analogue of a SIGKILL mid-stream.  Nobody ticks a dead
    handle, so its heartbeats stop, its liveness expires and the ring moves
    its span."""

    def __init__(self, rid: str, factory: Callable[[str], object], *,
                 on_kill: Optional[Callable[["InprocRouterHandle"],
                                            None]] = None):
        super().__init__(rid)
        self._factory = factory
        self._on_kill = on_kill
        self.router = None
        self._alive = False

    def spawn(self) -> None:
        self.router = self._factory(self.id)
        self._alive = True

    def alive(self) -> bool:
        return self._alive

    def ready(self) -> bool:
        return self._alive

    def stop(self, timeout_s: float = 5.0) -> None:
        self._alive = False

    def kill(self) -> None:
        if not self._alive:
            return
        self._alive = False
        if self._on_kill is not None:
            self._on_kill(self)

    def describe(self) -> dict:
        return {**super().describe(), "alive": self._alive}


class ProcessRouterHandle(RouterHandle):
    """A ``python -m paddle_tpu_torch.router`` subprocess joined to the
    fleet's membership store.  ``ready`` probes ``/statusz`` (a router
    serves its status from its first listen; ``/readyz`` would wait on
    replica discovery, which the store delivers later)."""

    def __init__(self, rid: str, host: str, port: int, *,
                 store_host: str, store_port: int,
                 launch_args: Optional[List[str]] = None,
                 probe_timeout_s: float = 0.5):
        super().__init__(rid)
        self.host = host
        self.port = int(port)
        self.store_host = store_host
        self.store_port = int(store_port)
        self.launch_args = list(launch_args or [])
        self.probe_timeout_s = probe_timeout_s
        self.proc: Optional[subprocess.Popen] = None

    def spawn(self) -> None:
        # the port's router, never the JAX package's
        argv = [sys.executable, "-m", "paddle_tpu_torch.router",
                "--host", self.host, "--port", str(self.port),
                "--store", f"{self.store_host}:{self.store_port}",
                "--router-id", self.id]
        argv += self.launch_args
        self.proc = subprocess.Popen(argv)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def ready(self) -> bool:
        if not self.alive():
            return False
        import http.client
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.probe_timeout_s)
        try:
            conn.request("GET", "/statusz")
            return conn.getresponse().status == 200
        except Exception:      # refused, timed out, a half-written head
            return False
        finally:
            conn.close()

    def stop(self, timeout_s: float = 5.0) -> None:
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def describe(self) -> dict:
        return {**super().describe(),
                "target": f"{self.host}:{self.port}",
                "pid": self.proc.pid if self.proc is not None else None}
