"""FleetSupervisor: replica lifecycle, closed-loop (port of
``paddle_tpu/fleet/supervisor.py``).

The router places over whatever replica set it is handed and the
sentinel detects fleet-wide SLO burn and anomalies — but nothing
*acts* on either.  This module closes the loop: one supervisor owns N
replica slots end-to-end —

- **spawn** through a :class:`ReplicaHandle` (``ProcessReplicaHandle``
  runs the real ``paddle-tpu-torch-serve`` launcher as a subprocess;
  ``InprocReplicaHandle`` builds a ``ServingServer`` in this process —
  the tier-1/bench idiom, no sockets).  A spawned replica is registered
  with the router ONLY once it passes ``/readyz`` warmup gating: live
  traffic never lands on a cold engine.
- **crash restart** with exponential backoff (``FLAGS_fleet_backoff_*``)
  and a restart budget (``FLAGS_fleet_restart_budget``): a slot that
  keeps dying is marked permanently ``failed`` and left down for a human
  — counted in ``fleet.replicas{state=failed}``, never silently respun
  forever.  A replica continuously ready past
  ``FLAGS_fleet_backoff_reset_s`` earns its budget back (an old flap
  must not doom a now-stable replica).  A replica the router reports
  dead while its process is still alive is a **wedge** (the SIGSTOP
  shape): the supervisor kills and restarts it through the same budget.
- **autoscaling** off the router's aggregated placement view
  (:meth:`RouterServer.fleet_signals`): fleet SLO-burn state (every
  placeable replica shedding), the load/queue-depth gauges, and the
  sentinel's anomaly stream.  Hysteresis (``FLAGS_fleet_hot_ticks`` /
  ``_cold_ticks`` consecutive evaluations) plus a cooldown
  (``FLAGS_fleet_scale_cooldown_s``) keep one burst from flapping the
  fleet; an active anomaly stream blocks scale-DOWN (never shrink a
  misbehaving fleet).
- **graceful drain** for scale-down: the victim is pinned ``draining``
  router-side immediately (no new placements), its replica-side
  admission closes (``begin_drain``/SIGTERM), in-flight requests finish
  bounded by ``FLAGS_fleet_drain_timeout_s``, then the process exits
  clean and the slot is deregistered — shutdown is a bounded protocol,
  not a SIGKILL.

The control loop is an explicit, clock-injectable :meth:`tick` so tests
(and the chaos harness) drive it deterministically; ``run_forever``
paces it for production.  Supervisor-side router mutations are plain
GIL-atomic list operations against snapshot readers — the launcher runs
ticks on a side thread under the router's event loop safely.
"""

from __future__ import annotations

import inspect
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import flags
from .. import observability as _obs
from .breaker import CascadeBreaker

__all__ = ["FleetSupervisor", "ReplicaHandle", "InprocReplicaHandle",
           "ProcessReplicaHandle", "parse_roles", "STARTING", "READY",
           "DRAINING", "BACKOFF", "FAILED"]

# slot lifecycle states (the fleet.replicas{state=} label set)
STARTING, READY, DRAINING, BACKOFF, FAILED = \
    "starting", "ready", "draining", "backoff", "failed"
_STATES = (STARTING, READY, DRAINING, BACKOFF, FAILED)

# replica roles: disaggregated prefill/decode fleets
_ROLES = ("prefill", "decode", "mixed")


def parse_roles(spec: str) -> Optional[Dict[str, int]]:
    """``FLAGS_fleet_roles`` syntax: ``"prefill=1,decode=2"`` -> per-role
    replica targets.  Empty -> ``None`` (a plain mixed fleet; every
    pre-role behavior is preserved bit-for-bit)."""
    spec = (spec or "").strip()
    if not spec:
        return None
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        role, eq, n = part.partition("=")
        role = role.strip()
        if not eq or role not in _ROLES:
            raise ValueError(
                f"fleet_roles expects 'role=N' with role in {_ROLES}, "
                f"got {part!r}")
        try:
            count = int(n)
        except ValueError:
            raise ValueError(f"fleet_roles count must be int: {part!r}")
        if count < 1:
            raise ValueError(f"fleet_roles counts must be >= 1: {part!r}")
        out[role] = out.get(role, 0) + count
    return out or None


class _FleetMetrics:
    """Registry handles resolved once."""

    __slots__ = ("replicas", "target", "restarts", "crashes", "scale",
                 "drains", "migrations", "migrated_pages", "role_gauge",
                 "rebalances", "routers", "router_restarts")

    def __init__(self):
        m = _obs.metrics
        self.migrations = lambda o: m.counter("fleet.migrations",
                                              outcome=o)
        self.migrated_pages = m.counter("fleet.migrated_pages")
        self.role_gauge = lambda r: m.gauge("fleet.role", role=r)
        self.rebalances = lambda o: m.counter("fleet.rebalances",
                                              outcome=o)
        # the lambda-param labels below are bounded by construction:
        # every caller passes a literal or a _STATES member
        self.replicas = lambda s: m.gauge("fleet.replicas", state=s)
        self.target = m.gauge("fleet.target_replicas")
        self.restarts = m.counter("fleet.replica_restarts")
        self.crashes = lambda kind: m.counter("fleet.crashes", kind=kind)
        self.scale = lambda d: m.counter("fleet.scale_events", direction=d)
        self.drains = lambda o: m.counter("fleet.drains", outcome=o)
        # the multi-router control plane's supervised router slots
        self.routers = m.gauge("controlplane.routers")
        self.router_restarts = m.counter("fleet.router_restarts")


# ---------------------------------------------------------------------------
# replica handles: the supervisor's uniform grip on one replica
# ---------------------------------------------------------------------------

class ReplicaHandle:
    """One replica the supervisor owns, process or in-process.  The
    contract is non-blocking-ish probes (``alive``/``ready``/``drained``
    are cheap; ``ready`` may do one short bounded HTTP GET) plus
    lifecycle verbs; ``client()`` is what gets registered with the
    router once ready."""

    def __init__(self, rid: str):
        self.id = rid

    def spawn(self) -> None:
        raise NotImplementedError

    def alive(self) -> bool:
        raise NotImplementedError

    def ready(self) -> bool:
        raise NotImplementedError

    def client(self):
        raise NotImplementedError

    def begin_drain(self) -> None:
        raise NotImplementedError

    def drained(self) -> bool:
        raise NotImplementedError

    def stop(self, timeout_s: float = 5.0) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError

    # ---- session migration: optional per-transport ----
    def export_sessions(self) -> list:
        """Snapshot every live session's KV on this replica (the drain
        victim side).  Transports without a migration path raise
        NotImplementedError — the supervisor counts the drain migration
        ``skipped`` and proceeds with a plain drain."""
        raise NotImplementedError

    def import_sessions(self, snaps: list) -> dict:
        """Install exported snapshots on this replica (successor side)."""
        raise NotImplementedError

    def describe(self) -> dict:
        return {"id": self.id, "kind": type(self).__name__}


# engine/server builds are serialized: two respawning slots sharing one
# model must not race the kernel build cache or the card's allocator
_BUILD_LOCK = threading.Lock()


class InprocReplicaHandle(ReplicaHandle):
    """A ``ServingServer`` replica in THIS process (tier-1/bench idiom):
    ``spawn()`` builds the engine+server on a background thread (a real
    spawn doesn't block the control loop either) and ``client()`` hands
    the router an ``InprocReplica`` — optionally wrapped by the chaos
    harness's fault-injecting transport (``client_wrap``)."""

    def __init__(self, rid: str, engine_factory: Callable[..., object], *,
                 warmup: bool = False, client_wrap=None, server_kw=None,
                 engine_kwargs=None):
        super().__init__(rid)
        self._factory = engine_factory
        self._warmup = warmup
        self._wrap = client_wrap
        self._server_kw = dict(server_kw or {})
        # ONE dict for engine knobs: passed to the
        # factory as **kwargs so every knob (tensor_parallel,
        # cache_dtype, pool geometry) reaches the engine by NAME — the
        # old idiom baked geometry positionally into each factory
        # closure, and a knob added on one launch path silently dropped
        # on the other
        self._engine_kwargs = dict(engine_kwargs or {})
        self.server = None
        self._client = None
        self._builder: Optional[threading.Thread] = None
        self._killed = False
        self._build_error: Optional[BaseException] = None

    def spawn(self) -> None:
        from ..router.replica import InprocReplica
        from ..serving.server import ServingServer
        self._killed = False
        self._build_error = None

        def _build():
            try:
                with _BUILD_LOCK:
                    engine = self._factory(**self._engine_kwargs)
                kw = dict(slo=False, flight_recorder=False)
                kw.update(self._server_kw)
                srv = ServingServer(engine, warmup=self._warmup, **kw)
                srv.start()
                client = InprocReplica(self.id, srv)
                if self._wrap is not None:
                    client = self._wrap(client)
                # client last: `ready()` keys off it, so a half-built
                # replica can never be registered
                self.server = srv
                self._client = client
                if self._killed:
                    # killed mid-build (chaos / drain timeout): the
                    # corpse must not outlive its slot — stop the engine
                    # thread we just started instead of leaking it
                    srv.close()
            except BaseException as e:   # surfaces as a crash next tick
                self._build_error = e

        self._builder = threading.Thread(
            target=_build, name=f"fleet-spawn-{self.id}", daemon=True)
        self._builder.start()

    def alive(self) -> bool:
        if self._killed or self._build_error is not None:
            return False
        b = self._builder
        if b is not None and b.is_alive():
            return True                  # still building: not dead yet
        return self.server is not None and self.server.engine_alive()

    def ready(self) -> bool:
        return (not self._killed and self._client is not None
                and self.server is not None and self.server.ready())

    def client(self):
        return self._client

    def begin_drain(self) -> None:
        if self.server is not None:
            self.server.begin_drain()

    def drained(self) -> bool:
        # an engine that CRASHED mid-drain retired its streams with
        # synthesized errors, not clean completions — that is a death
        # (the supervisor's died path), never a clean drain
        return self.server is None or (self.server.drained() and
                                       self.server._engine_error is None)

    def stop(self, timeout_s: float = 5.0) -> None:
        if self.server is not None:
            self.server.close()

    def kill(self) -> None:
        """Die like a SIGKILLed process: sever in-flight responses
        mid-stream, refuse new connections, stop the engine thread."""
        self._killed = True
        c = self._client
        if c is not None:
            inner = getattr(c, "inner", c)   # unwrap a chaos client
            if hasattr(inner, "kill"):
                inner.kill()
        elif self.server is not None:
            self.server.close()

    def export_sessions(self) -> list:
        if self.server is None:
            return []
        return self.server.export_sessions()

    def import_sessions(self, snaps: list) -> dict:
        if self.server is None:
            raise RuntimeError(f"replica {self.id} has no server")
        return self.server.import_sessions(snaps)


class ProcessReplicaHandle(ReplicaHandle):
    """A real ``paddle-tpu-torch-serve`` subprocess on ``host:port``
    (production deployment: ``python -m paddle_tpu_torch.fleet``).  ``ready``
    polls ``/readyz`` with a short bounded GET; ``begin_drain`` sends
    SIGTERM — the replica's serve_forever path dumps the flight
    recorder, drains, and exits 0, so ``drained()`` is simply "the
    process exited"."""

    def __init__(self, rid: str, host: str, port: int, *,
                 launch_args: Optional[List[str]] = None,
                 probe_timeout_s: float = 0.5):
        super().__init__(rid)
        self.host = host
        self.port = int(port)
        self.launch_args = list(launch_args or [])
        self.probe_timeout_s = probe_timeout_s
        self.proc: Optional[subprocess.Popen] = None

    def spawn(self) -> None:
        # the port's replica launcher, never the JAX package's: a replica
        # of the other package would join this fleet with another model
        argv = [sys.executable, "-m", "paddle_tpu_torch.serving",
                "--host", self.host, "--port", str(self.port)]
        argv += self.launch_args
        self.proc = subprocess.Popen(argv)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def _get(self, path: str) -> int:
        import http.client
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.probe_timeout_s)
        try:
            conn.request("GET", path)
            return conn.getresponse().status
        finally:
            conn.close()

    def ready(self) -> bool:
        if not self.alive():
            return False
        try:
            return self._get("/readyz") == 200
        except Exception:      # conn refused, timeout, half-written head
            return False

    def client(self):
        from ..router.replica import HttpReplica
        return HttpReplica(self.id, self.host, self.port)

    def begin_drain(self) -> None:
        if self.alive():
            import signal as _signal
            self.proc.send_signal(_signal.SIGTERM)

    def drained(self) -> bool:
        # a drain completes by EXITING CLEAN (the serve_forever SIGTERM
        # path ends in rc 0); a nonzero exit mid-drain is a death, which
        # the supervisor's died/timeout paths handle
        return self.proc is None or self.proc.poll() == 0

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

    def _post_json(self, path: str, doc: dict,
                   timeout_s: float = 15.0) -> dict:
        import http.client
        import json as _json
        body = _json.dumps(doc).encode()
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout_s)
        try:
            conn.request("POST", path, body=body,
                         headers={"Content-Type": "application/json",
                                  "Content-Length": str(len(body))})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise RuntimeError(
                    f"{path} -> {resp.status}: {data[:200]!r}")
            return _json.loads(data.decode())
        finally:
            conn.close()

    def export_sessions(self) -> list:
        # page payloads ride base64 JSON over the replica's /migratez
        # endpoints; the timeout is generous relative to probes (the
        # readbacks are control-path syncs, not dispatches)
        return self._post_json("/migratez/export",
                               {"all": True}).get("sessions", [])

    def import_sessions(self, snaps: list) -> dict:
        return self._post_json("/migratez/import", {"sessions": snaps})

    def suspend(self) -> None:
        """SIGSTOP (the chaos harness's wedge on a real process)."""
        if self.alive():
            import signal as _signal
            self.proc.send_signal(_signal.SIGSTOP)

    def resume(self) -> None:
        if self.alive():
            import signal as _signal
            self.proc.send_signal(_signal.SIGCONT)

    def describe(self) -> dict:
        return {**super().describe(),
                "target": f"{self.host}:{self.port}",
                "pid": self.proc.pid if self.proc is not None else None}


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class _Slot:
    """Bookkeeping for one managed replica position."""

    __slots__ = ("handle", "state", "restarts", "deadline", "ready_since",
                 "registered", "role")

    def __init__(self, handle: ReplicaHandle, role: str = "mixed"):
        self.handle = handle
        self.state = STARTING
        self.restarts = 0
        self.deadline = 0.0          # backoff or drain deadline (clock units)
        self.ready_since: Optional[float] = None
        self.registered = False
        self.role = role             # sticky across crash-restarts


class FleetSupervisor:
    """Owns the replica set behind one :class:`RouterServer`.

    ``spawner(rid)`` builds a fresh :class:`ReplicaHandle` for a slot id
    (and is called again with the SAME id on crash-restart, so a process
    spawner can pin each slot's port).  ``on_spawn`` is called with
    EVERY handle generation — initial spawns and crash-restarts alike —
    which is how the chaos harness keeps its grip on the live
    generation (``on_spawn=chaos.register_handle``); a fault aimed at a
    stale, already-dead handle would silently no-op.  ``clock`` is
    injectable for deterministic tests; every knob defaults from its
    ``FLAGS_fleet_*`` flag."""

    def __init__(self, router, spawner: Callable[[str], ReplicaHandle], *,
                 target: Optional[int] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 restart_budget: Optional[int] = None,
                 backoff_base_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 backoff_reset_s: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None,
                 hot_ticks: Optional[int] = None,
                 cold_ticks: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 scale_up_load: Optional[float] = None,
                 scale_down_load: Optional[float] = None,
                 migrate_on_drain: Optional[bool] = None,
                 roles: Optional[Dict[str, int]] = None,
                 rebalance: Optional[bool] = None,
                 rebalance_cooldown_s: Optional[float] = None,
                 on_spawn: Optional[Callable[[ReplicaHandle],
                                             None]] = None,
                 breaker=None,
                 router_spawner: Optional[Callable[[str],
                                                   object]] = None,
                 router_target: int = 0,
                 on_router_spawn: Optional[Callable[[object],
                                                    None]] = None,
                 store=None,
                 collector=None,
                 clock: Callable[[], float] = time.monotonic):
        f = flags.flag
        self.router = router
        self._spawner = spawner
        # role-specialized fleets: a spawner whose signature
        # takes a second positional gets (rid, role) so it can launch
        # the replica with --role / FLAGS_serving_role; legacy
        # single-arg spawners keep working untouched
        try:
            params = [
                p for p in
                inspect.signature(spawner).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                              p.VAR_POSITIONAL)]
            self._spawner_roleful = len(params) >= 2 or any(
                p.kind == p.VAR_POSITIONAL for p in params)
        except (TypeError, ValueError):
            self._spawner_roleful = False
        self._on_spawn = on_spawn
        self.min_replicas = int(f("fleet_min_replicas")
                                if min_replicas is None else min_replicas)
        self.max_replicas = int(f("fleet_max_replicas")
                                if max_replicas is None else max_replicas)
        self.target = max(self.min_replicas,
                          min(self.max_replicas,
                              self.min_replicas if target is None
                              else int(target)))
        self.restart_budget = int(f("fleet_restart_budget")
                                  if restart_budget is None
                                  else restart_budget)
        self.backoff_base_s = float(f("fleet_backoff_base_s")
                                    if backoff_base_s is None
                                    else backoff_base_s)
        self.backoff_max_s = float(f("fleet_backoff_max_s")
                                   if backoff_max_s is None
                                   else backoff_max_s)
        self.backoff_reset_s = float(f("fleet_backoff_reset_s")
                                     if backoff_reset_s is None
                                     else backoff_reset_s)
        self.drain_timeout_s = float(f("fleet_drain_timeout_s")
                                     if drain_timeout_s is None
                                     else drain_timeout_s)
        self.hot_ticks = int(f("fleet_hot_ticks")
                             if hot_ticks is None else hot_ticks)
        self.cold_ticks = int(f("fleet_cold_ticks")
                              if cold_ticks is None else cold_ticks)
        self.cooldown_s = float(f("fleet_scale_cooldown_s")
                                if cooldown_s is None else cooldown_s)
        self.scale_up_load = float(f("fleet_scale_up_load")
                                   if scale_up_load is None
                                   else scale_up_load)
        self.scale_down_load = float(f("fleet_scale_down_load")
                                     if scale_down_load is None
                                     else scale_down_load)
        self.migrate_on_drain = bool(f("fleet_migrate_on_drain")
                                     if migrate_on_drain is None
                                     else migrate_on_drain)
        # disaggregated fleets: per-role targets; None keeps
        # the mixed single-pool behavior bit-for-bit
        self.roles = parse_roles(str(f("fleet_roles"))) \
            if roles is None else (dict(roles) or None)
        if self.roles is not None:
            if sum(self.roles.values()) > self.max_replicas:
                raise ValueError(
                    f"fleet_roles wants {sum(self.roles.values())} "
                    f"replicas > fleet_max_replicas={self.max_replicas}")
            self.target = sum(self.roles.values())
        # proactive rebalance: migrate hot sessions OFF an
        # SLO-burning decode replica before it sheds
        self._rebalance_on = bool(f("fleet_rebalance")
                                  if rebalance is None else rebalance)
        self.rebalance_cooldown_s = float(
            f("fleet_rebalance_cooldown_s")
            if rebalance_cooldown_s is None else rebalance_cooldown_s)
        self._last_rebalance = -1e18
        self._clock = clock
        self._slots: List[_Slot] = []
        self._next_slot = 0
        self._hot_streak = 0
        self._cold_streak = 0
        self._role_hot: Dict[str, int] = {}
        self._role_cold: Dict[str, int] = {}
        self._last_scale = -1e18     # first scale never cooldown-blocked
        self._last_anomaly_total = 0
        self._ticks = 0
        self._m = _FleetMetrics()
        # cascade breaker: the supervisor owns detection (it
        # sees every death), the router consumes state (parks resumes,
        # sheds admissions).  ``breaker=None`` builds a flag-configured
        # one on the same injectable clock; ``breaker=False`` disables.
        if breaker is None:
            breaker = CascadeBreaker(clock=clock)
        self.breaker: Optional[CascadeBreaker] = breaker or None
        if self.breaker is not None:
            # plain attribute write: GIL-atomic vs the event loop's reads
            self.router.breaker = self.breaker
        # multi-router control plane: the supervisor owns the membership
        # store and N router slots beside its replica slots, through the
        # same state machine with a simpler lifecycle (no drain: a dying
        # router's in-flight streams fail over to the ring's survivors over
        # the store-replicated journal, so a router death is a restart,
        # never a breaker-visible replica death).  ``store`` is a sync face
        # (StoreState or SyncStoreClient): the tick thread publishes
        # ``replica/<id>`` endpoints through it, so spawned routers
        # discover the replica set with no static --replica wiring.
        self._router_spawner = router_spawner
        self._on_router_spawn = on_router_spawn
        self.router_target = int(router_target)
        self._router_slots: List[_Slot] = []
        self._next_router_slot = 0
        self.store = store
        # fleet tracing: the supervisor owns the trace collector; replicas
        # publish span batches under ``trace/batch/*`` on the store (or
        # POST them to a router's ``/collectz``), and the tick thread
        # drains the store's here, so assembly needs no poller thread
        self.collector = collector
    # --------------------------------------------------------- population --
    def _build_handle(self, rid: str, role: str) -> ReplicaHandle:
        if self._spawner_roleful:
            return self._spawner(rid, role)
        return self._spawner(rid)

    def _spawn_slot(self, role: str = "mixed") -> _Slot:
        rid = f"fs{self._next_slot}"
        self._next_slot += 1
        slot = _Slot(self._build_handle(rid, role), role=role)
        slot.handle.spawn()
        if self._on_spawn is not None:
            self._on_spawn(slot.handle)
        self._slots.append(slot)
        return slot

    def _spawn_router_slot(self) -> _Slot:
        # rt0 is the launcher's in-process router; supervised peers start
        # at rt1, so the ids never collide
        self._next_router_slot += 1
        rid = f"rt{self._next_router_slot}"
        slot = _Slot(self._router_spawner(rid), role="router")
        slot.handle.spawn()
        if self._on_router_spawn is not None:
            self._on_router_spawn(slot.handle)
        self._router_slots.append(slot)
        return slot

    def _role_count(self, role: str) -> int:
        return sum(1 for s in self._slots
                   if s.role == role and s.state != FAILED)

    def start(self) -> "FleetSupervisor":
        """Spawn the initial ``target`` replica slots (idempotent);
        with roles, one slot per role unit."""
        if self._router_spawner is not None:
            while len(self._router_slots) < self.router_target:
                self._spawn_router_slot()
        if self.roles is not None:
            for role in sorted(self.roles):
                while self._role_count(role) < self.roles[role]:
                    self._spawn_slot(role)
        else:
            while len(self._slots) < self.target:
                self._spawn_slot()
        self._export_gauges()
        return self

    def set_target(self, n: int) -> None:
        """Explicit target override (ops seam; the autoscaler moves the
        same knob).  Convergence happens on the next ``tick``."""
        self.target = max(self.min_replicas, min(self.max_replicas, int(n)))

    # --------------------------------------------------------- the loop --
    def _router_state(self, rid: str):
        for s in self.router.states:
            if s.id == rid:
                return s
        return None

    def _deregister(self, slot: _Slot) -> None:
        if slot.registered:
            self.router.remove_replica(slot.handle.id)
            self._unpublish_replica(slot.handle)
            if self.collector is not None:
                self.collector.unregister_ring(slot.handle.id)
            slot.registered = False

    def _register_ring(self, handle: ReplicaHandle) -> None:
        """Hand the trace collector an in-process replica's flight-recorder
        ring, so a fleet-correlated anomaly dump merges its window.  Process
        replicas have no in-process ring: their tail-kept spans arrive by
        the export path instead."""
        if self.collector is None:
            return
        fr = getattr(getattr(handle, "server", None),
                     "flight_recorder", None)
        if fr is not None:
            self.collector.register_ring(handle.id, fr.events)

    # ------------------------------------------- store publication --
    def _publish_replica(self, handle: ReplicaHandle) -> None:
        """Advertise a READY replica's endpoint under ``replica/<id>``
        so store-discovering routers (the spawned rt1..rtN fleet) pick
        it up.  In-process handles have no endpoint to advertise — the
        harness registers their clients with each router directly."""
        if self.store is None:
            return
        host = getattr(handle, "host", None)
        port = getattr(handle, "port", None)
        if host is None or port is None:
            return
        try:
            self.store.set(f"replica/{handle.id}",
                           {"host": host, "port": int(port)})
        except Exception:
            pass    # the store being down must never wedge the loop

    def _unpublish_replica(self, handle: ReplicaHandle) -> None:
        if self.store is None:
            return
        try:
            self.store.delete(f"replica/{handle.id}")
        except Exception:
            pass

    # ------------------------------------------------ router slots --
    def _tick_routers(self, now: float, actions: list) -> None:
        """Supervise the router fleet exactly like replica slots minus
        the drain protocol and the breaker: a router death is a control-
        plane event (its ring span moves to survivors and store-journal
        takeover resumes its streams), not a capacity death the cascade
        breaker should trip on."""
        for slot in list(self._router_slots):
            h = slot.handle
            if slot.state in (STARTING, READY) and not h.alive():
                self._m.crashes("router").inc()
                if slot.ready_since is not None and \
                        now - slot.ready_since >= self.backoff_reset_s:
                    slot.restarts = 0
                if slot.restarts >= self.restart_budget:
                    slot.state = FAILED
                    actions.append(("router_failed", h.id))
                else:
                    slot.state = BACKOFF
                    slot.deadline = now + min(
                        self.backoff_max_s,
                        self.backoff_base_s * (2.0 ** min(slot.restarts,
                                                          16)))
                    actions.append(("router_backoff", h.id))
                continue
            if slot.state == BACKOFF and now >= slot.deadline:
                slot.restarts += 1
                self._m.router_restarts.inc()
                slot.handle = self._router_spawner(h.id)
                slot.handle.spawn()
                if self._on_router_spawn is not None:
                    self._on_router_spawn(slot.handle)
                slot.state = STARTING
                slot.ready_since = None
                actions.append(("router_restart", h.id))
                continue
            if slot.state == STARTING and h.ready():
                slot.state = READY
                slot.ready_since = now
                actions.append(("router_ready", h.id))

    def _crash(self, slot: _Slot, now: float, kind: str,
               actions: list) -> None:
        if kind == "wedged":
            slot.handle.kill()       # a wedge holds its port/engine hostage
        self._deregister(slot)
        self._m.crashes(kind).inc()
        if self.breaker is not None:
            self.breaker.record_death(now)
        if slot.ready_since is not None and \
                now - slot.ready_since >= self.backoff_reset_s:
            slot.restarts = 0        # long-stable replica earns budget back
        if slot.restarts >= self.restart_budget:
            slot.state = FAILED      # permanently: a human's problem now
            actions.append(("failed", slot.handle.id))
        else:
            slot.state = BACKOFF
            slot.deadline = now + min(
                self.backoff_max_s,
                self.backoff_base_s * (2.0 ** min(slot.restarts, 16)))
            actions.append(("backoff", slot.handle.id))

    def tick(self) -> list:
        """One control-loop evaluation.  Returns the actions taken as
        ``(verb, detail)`` tuples (test/log seam)."""
        now = self._clock()
        self._ticks += 1
        actions: list = []
        if self.breaker is not None:
            # time-driven breaker transitions (open -> half-open after a
            # death-free cooldown) ride the control loop's clock
            self.breaker.update(now)
        self._tick_routers(now, actions)
        for slot in list(self._slots):
            h = slot.handle
            if slot.state == DRAINING:
                # drained is checked BEFORE alive: a process replica
                # completes its drain by EXITING (clean, rc 0), which
                # must never read as a mid-drain death
                if h.drained():
                    h.stop()
                    self._deregister(slot)
                    self._m.drains("clean").inc()
                    self._slots.remove(slot)
                    actions.append(("drained", h.id))
                elif now >= slot.deadline:
                    # the bound expired: in-flight stragglers lose, the
                    # fleet's shape wins — this is the ONLY supervisor
                    # path that hard-kills mid-request
                    h.kill()
                    self._deregister(slot)
                    self._m.drains("timeout").inc()
                    self._slots.remove(slot)
                    actions.append(("drain_timeout", h.id))
                elif not h.alive():
                    # died mid-drain (nonzero exit / engine crash): it
                    # was leaving anyway — count the unclean exit, don't
                    # restart it (a death is still a death to the
                    # cascade breaker's rate window)
                    self._deregister(slot)
                    self._m.crashes("exit").inc()
                    self._m.drains("died").inc()
                    if self.breaker is not None:
                        self.breaker.record_death(now)
                    self._slots.remove(slot)
                    actions.append(("drain_died", h.id))
                continue
            if slot.state in (STARTING, READY):
                alive = h.alive()
                wedged = False
                if alive and slot.state == READY:
                    rs = self._router_state(h.id)
                    if rs is not None and not rs.ok and \
                            rs.fails >= self.router.dead_after:
                        # the process lives but the router can't reach
                        # it: the SIGSTOP/wedge shape — kill and restart
                        wedged = True
                if not alive or wedged:
                    self._crash(slot, now,
                                "wedged" if wedged else "exit", actions)
                    continue
            if slot.state == BACKOFF and now >= slot.deadline:
                slot.restarts += 1
                self._m.restarts.inc()
                # fresh handle, same id AND same role
                slot.handle = self._build_handle(h.id, slot.role)
                slot.handle.spawn()
                if self._on_spawn is not None:
                    self._on_spawn(slot.handle)
                slot.state = STARTING
                slot.ready_since = None
                actions.append(("restart", h.id))
                continue
            if slot.state == STARTING and h.ready():
                # /readyz warmup gate passed: ONLY now does the router
                # see it — live traffic never lands on a cold engine
                self.router.add_replica(h.client())
                self._publish_replica(h)
                self._register_ring(h)
                slot.state = READY
                slot.ready_since = now
                slot.registered = True
                actions.append(("ready", h.id))
        self._maybe_rebalance(now, actions)
        self._autoscale(now, actions)
        self._converge(now, actions)
        if self.collector is not None and self.store is not None:
            # drain the span batches published over the control plane; a
            # broken store face must not wedge the loop (poll_store
            # swallows transport errors)
            self.collector.poll_store(self.store)
        self._export_gauges()
        return actions

    # -------------------------------------------------------- autoscale --
    def _autoscale(self, now: float, actions: list) -> None:
        sig = self.router.fleet_signals()
        anomaly_delta = sig["anomaly_total"] - self._last_anomaly_total
        self._last_anomaly_total = sig["anomaly_total"]
        # hysteresis only accumulates on a SETTLED fleet: while a slot is
        # still starting/draining the capacity the signals were measured
        # against is in flux — a warming fleet must not read as "cold"
        # at boot, nor a half-landed scale-up as "still hot".  BACKOFF
        # slots do NOT freeze the hot side: their capacity is already
        # absent from the measured signals, and a crash-looping replica
        # must not pin the fleet at its degraded size while the
        # survivors shed their SLO (it still freezes cold — its capacity
        # is coming back, and shrinking under it would double-shrink).
        if any(s.state in (STARTING, DRAINING) for s in self._slots):
            self._hot_streak = self._cold_streak = 0
            self._role_hot.clear()
            self._role_cold.clear()
            return
        in_backoff = any(s.state == BACKOFF for s in self._slots)
        if self.roles is not None:
            self._autoscale_roles(sig, anomaly_delta, in_backoff, now,
                                  actions)
            return
        hot = sig["placeable"] > 0 and (
            sig["all_shedding"] or sig["mean_load"] > self.scale_up_load)
        # an outage (zero placeable replicas) is not "cold": never shrink
        # a fleet that isn't serving, nor one whose anomaly stream is hot
        cold = (not in_backoff and sig["placeable"] > 0
                and sig["shedding"] == 0 and anomaly_delta == 0
                and sig["mean_load"] < self.scale_down_load)
        self._hot_streak = self._hot_streak + 1 if hot else 0
        self._cold_streak = self._cold_streak + 1 if cold else 0
        cooled = now - self._last_scale >= self.cooldown_s
        if self._hot_streak >= self.hot_ticks and cooled and \
                self.target < self.max_replicas:
            self.target += 1
            self._last_scale = now
            self._hot_streak = 0
            self._m.scale("up").inc()
            actions.append(("scale_up", self.target))
        elif self._cold_streak >= self.cold_ticks and cooled and \
                self.target > self.min_replicas:
            self.target -= 1
            self._last_scale = now
            self._cold_streak = 0
            self._m.scale("down").inc()
            actions.append(("scale_down", self.target))

    def _autoscale_roles(self, sig: dict, anomaly_delta: int,
                         in_backoff: bool, now: float,
                         actions: list) -> None:
        """Per-role autoscaling: each role scales on ITS
        pressure signal — prefill burns TTFT in its admission queue
        (mean queue depth), decode/mixed burn ITL in resident load —
        with the same thresholds, hysteresis and shared cooldown as
        the mixed path."""
        cooled = now - self._last_scale >= self.cooldown_s
        for role in sorted(self.roles):
            rs = (sig.get("roles") or {}).get(role)
            if rs is None or rs["placeable"] == 0:
                # no live signal for this role (all down/warming):
                # neither hot nor cold — converge handles population
                self._role_hot[role] = self._role_cold[role] = 0
                continue
            metric = rs["mean_queue_depth"] if role == "prefill" \
                else rs["mean_load"]
            hot = rs["shedding"] == rs["placeable"] or \
                metric > self.scale_up_load
            cold = (not in_backoff and rs["shedding"] == 0
                    and anomaly_delta == 0
                    and metric < self.scale_down_load)
            self._role_hot[role] = \
                self._role_hot.get(role, 0) + 1 if hot else 0
            self._role_cold[role] = \
                self._role_cold.get(role, 0) + 1 if cold else 0
            total = sum(self.roles.values())
            if self._role_hot[role] >= self.hot_ticks and cooled and \
                    total < self.max_replicas:
                self.roles[role] += 1
                self._last_scale = now
                self._role_hot[role] = 0
                cooled = False
                self._m.scale("up").inc()
                actions.append(("scale_up", (role, self.roles[role])))
            elif self._role_cold[role] >= self.cold_ticks and cooled \
                    and self.roles[role] > 1:
                # per-role floor of 1: a disaggregated fleet never
                # scales a phase out of existence
                self.roles[role] -= 1
                self._last_scale = now
                self._role_cold[role] = 0
                cooled = False
                self._m.scale("down").inc()
                actions.append(("scale_down", (role, self.roles[role])))
        self.target = sum(self.roles.values())

    def _converge(self, now: float, actions: list) -> None:
        """Move the population toward ``target``: spawn for scale-up,
        drain victims for scale-down.  FAILED tombstones don't count —
        and are deliberately NOT replaced (the budget would mean
        nothing if exhaustion just minted a fresh slot)."""
        if self.roles is not None:
            for role in sorted(self.roles):
                want = self.roles[role]
                active = [s for s in self._slots if s.role == role
                          and s.state in (STARTING, READY, BACKOFF)]
                failed = sum(1 for s in self._slots
                             if s.role == role and s.state == FAILED)
                grow = want - len(active) - failed
                while grow > 0:
                    slot = self._spawn_slot(role)
                    actions.append(("spawn", slot.handle.id))
                    grow -= 1
                excess = len(active) - want
                while excess > 0:
                    victim = self._pick_victim(role)
                    if victim is None:
                        break
                    self._begin_drain(victim, now)
                    actions.append(("drain", victim.handle.id))
                    excess -= 1
            return
        active = [s for s in self._slots
                  if s.state in (STARTING, READY, BACKOFF)]
        grow = self.target - len(active) \
            - sum(1 for s in self._slots if s.state == FAILED)
        while grow > 0:
            slot = self._spawn_slot()
            actions.append(("spawn", slot.handle.id))
            grow -= 1
        excess = len(active) - self.target
        while excess > 0:
            victim = self._pick_victim()
            if victim is None:
                break                # nothing drainable yet (all starting)
            self._begin_drain(victim, now)
            actions.append(("drain", victim.handle.id))
            excess -= 1

    def _pick_victim(self, role: Optional[str] = None) -> Optional[_Slot]:
        """Scale-down victim: the least-loaded READY slot (its in-flight
        tail is shortest), newest-first on ties; role-scoped when the
        fleet is disaggregated."""
        ready = [s for s in self._slots if s.state == READY
                 and (role is None or s.role == role)]
        if not ready:
            return None

        def load(slot: _Slot) -> int:
            rs = self._router_state(slot.handle.id)
            return rs.load() if rs is not None else 0

        return min(reversed(ready), key=load)

    def _begin_drain(self, slot: _Slot, now: float) -> None:
        self.router.mark_draining(slot.handle.id, True)
        if self.migrate_on_drain:
            # ship the victim's live sessions' KV to a READY
            # successor BEFORE admission closes — scale-down becomes a
            # DMA instead of a re-prefill when those sessions' next
            # turns (or failover resumes) land on the successor.  Best
            # effort by design: a failed migration never blocks the
            # drain (the sessions still finish out on the victim).
            # The transfer runs inline in THIS tick, bounded by the
            # transport timeouts (2 x 15s worst case on the HTTP path):
            # a wedged victim costs the control loop one delayed beat,
            # after which crash/wedge handling resumes normally.
            self._migrate_out(slot)
        slot.handle.begin_drain()
        slot.state = DRAINING
        slot.deadline = now + self.drain_timeout_s

    # ------------------------------------- drain migration --
    def _pick_successor(self, victim: _Slot) -> Optional[_Slot]:
        """Where the victim's sessions go: the least-loaded READY slot
        other than the victim (the same load view scale-down uses); a
        same-role-or-mixed peer outranks a cross-role one —
        a prefill replica's sessions don't belong on the decode fleet."""
        ready = [s for s in self._slots
                 if s is not victim and s.state == READY]
        if not ready:
            return None

        def key(slot: _Slot):
            rs = self._router_state(slot.handle.id)
            load = rs.load() if rs is not None else 0
            kin = slot.role == victim.role or slot.role == "mixed"
            return (0 if kin else 1, load)

        return min(ready, key=key)

    def _migrate_out(self, victim: _Slot) -> Optional[dict]:
        succ = self._pick_successor(victim)
        # chaos seam (fleet/chaos.py migrate_interrupt/partial_transfer):
        # one-shot fault markers consumed by exactly one migration
        fault = getattr(victim.handle, "_chaos_migrate", None)
        victim.handle._chaos_migrate = None
        try:
            if succ is None:
                self._m.migrations("skipped").inc()
                return None
            snaps = victim.handle.export_sessions()
            if fault == "interrupt":
                # the transfer dies between export and import (the
                # victim exited / network cut): nothing installed, no
                # refs leaked anywhere — the drain proceeds bare
                raise RuntimeError("chaos: migrate_interrupt")
            if fault == "partial":
                # a truncated transfer: each snapshot loses the tail of
                # its page list mid-flight — the export-stamped
                # integrity digest no longer matches, so the importer
                # must REJECT the corrupt snapshot (counted
                # serving.kv.migration_rejected) and leak nothing
                snaps = [{**s, "pages": s["pages"][:len(s["pages"]) // 2]}
                         for s in snaps]
            if not snaps:
                self._m.migrations("skipped").inc()
                return None
            result = succ.handle.import_sessions(snaps)
            if not result.get("sessions") and result.get("aborted"):
                # the successor installed NOTHING (per-snapshot aborts
                # across the board — e.g. a geometry/dtype mismatch in
                # a mixed fleet): that is a failed migration, not a
                # success with zero pages
                self._m.migrations("failed").inc()
            else:
                self._m.migrations("ok").inc()
                self._m.migrated_pages.inc(int(result.get("imported", 0)))
            return result
        except NotImplementedError:
            self._m.migrations("skipped").inc()
            return None
        except Exception as e:
            from ..inference.migration import MigrationError
            if isinstance(e, MigrationError):
                # structurally unsupported (successor has no prefix
                # cache / geometry mismatch): not a transfer failure
                self._m.migrations("skipped").inc()
                return None
            # MigrationError (no prefix cache / geometry mismatch),
            # transport death, chaos interrupt: count it, drain anyway
            import sys
            print(f"[paddle_tpu_torch fleet] drain migration "
                  f"{victim.handle.id} -> "
                  f"{succ.handle.id if succ else '?'} failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            self._m.migrations("failed").inc()
            return None

    # ------------------------------- proactive rebalance --
    def _pick_rebalance_peer(self, src: _Slot) -> Optional[_Slot]:
        """A READY same-role-or-mixed peer the router reports ADMITTING
        (not shedding, not draining), least-loaded first."""
        best = None
        for slot in self._slots:
            if slot is src or slot.state != READY:
                continue
            if slot.role != src.role and slot.role != "mixed" \
                    and src.role != "mixed":
                continue
            rs = self._router_state(slot.handle.id)
            if rs is None or not rs.ok or rs.draining or \
                    rs.slo_decision == "shed":
                continue
            if best is None or rs.load() < best[0]:
                best = (rs.load(), slot)
        return best[1] if best is not None else None

    def _maybe_rebalance(self, now: float, actions: list) -> None:
        """Migrate hot sessions OFF an SLO-burning replica BEFORE it
        sheds: the first READY slot the router reports
        shedding, with an admitting same-role-or-mixed peer, gets its
        resident sessions' KV pre-staged on the peer over the migration
        plane and their pins re-pointed there.  In-flight streams
        finish out on the source (drain semantics); only FUTURE turns
        move.  At most one rebalance per cooldown window — this is a
        pressure valve, not a shuffle."""
        if not self._rebalance_on or not self.migrate_on_drain:
            return
        if now - self._last_rebalance < self.rebalance_cooldown_s:
            return
        for slot in self._slots:
            if slot.state != READY:
                continue
            rs = self._router_state(slot.handle.id)
            if rs is None or not rs.ok or rs.slo_decision != "shed":
                continue
            peer = self._pick_rebalance_peer(slot)
            if peer is None:
                continue
            self._last_rebalance = now
            ok = self._rebalance(slot, peer)
            actions.append(("rebalance" if ok else "rebalance_failed",
                            (slot.handle.id, peer.handle.id)))
            return

    def _rebalance(self, src: _Slot, dst: _Slot) -> bool:
        try:
            snaps = src.handle.export_sessions()
            if not snaps:
                self._m.rebalances("skipped").inc()
                return False
            result = dst.handle.import_sessions(snaps)
            if not result.get("sessions") and result.get("aborted"):
                self._m.rebalances("failed").inc()
                return False
            moved = self.router.restage(src.handle.id, dst.handle.id)
            self._m.rebalances("ok").inc()
            self._m.migrated_pages.inc(int(result.get("imported", 0)))
            if _obs.TRACER.enabled:
                _obs.TRACER.instant(
                    "fleet.rebalance",
                    args={"src": src.handle.id, "dst": dst.handle.id,
                          "sessions": len(snaps), "repinned": moved})
            return True
        except NotImplementedError:
            self._m.rebalances("skipped").inc()
            return False
        except Exception as e:
            from ..inference.migration import MigrationError
            if isinstance(e, MigrationError):
                self._m.rebalances("skipped").inc()
                return False
            print(f"[paddle_tpu_torch fleet] rebalance {src.handle.id} -> "
                  f"{dst.handle.id} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            self._m.rebalances("failed").inc()
            return False

    # ---------------------------------------------------------- status --
    def converged(self) -> bool:
        """Fleet shape matches intent: READY count == target (FAILED
        tombstones excepted) and nothing is mid-transition."""
        counts = {s: 0 for s in _STATES}
        for slot in self._slots:
            counts[slot.state] += 1
        want = max(0, self.target - counts[FAILED])
        routers_settled = all(s.state in (READY, FAILED)
                              for s in self._router_slots)
        return counts[READY] == want and routers_settled and \
            counts[STARTING] == counts[BACKOFF] == counts[DRAINING] == 0

    def _export_gauges(self) -> None:
        counts = {s: 0 for s in _STATES}
        role_counts = {r: 0 for r in _ROLES}
        for slot in self._slots:
            counts[slot.state] += 1
            if slot.state != FAILED:
                role_counts[slot.role] += 1
        for s, n in counts.items():
            self._m.replicas(s).set(n)
        for r, n in role_counts.items():
            self._m.role_gauge(r).set(n)
        self._m.target.set(self.target)
        self._m.routers.set(sum(1 for s in self._router_slots
                                if s.state != FAILED))

    def state(self) -> dict:
        """Introspection for the launcher / tests / statusz."""
        return {
            "target": self.target,
            "roles": dict(self.roles) if self.roles is not None else None,
            "ticks": self._ticks,
            "converged": self.converged(),
            "hot_streak": self._hot_streak,
            "cold_streak": self._cold_streak,
            "role_streaks": {"hot": dict(self._role_hot),
                             "cold": dict(self._role_cold)},
            "rebalance": {
                "enabled": self._rebalance_on,
                "cooldown_s": self.rebalance_cooldown_s,
                "outcomes": {o: int(_obs.metrics.counter(
                    "fleet.rebalances", outcome=o).value)
                    for o in ("ok", "skipped", "failed")}},
            "slots": [{"id": s.handle.id, "state": s.state,
                       "role": s.role, "restarts": s.restarts,
                       **s.handle.describe()} for s in self._slots],
            "router_slots": [{"id": s.handle.id, "state": s.state,
                              "restarts": s.restarts,
                              **s.handle.describe()}
                             for s in self._router_slots],
            "signals": self.router.fleet_signals(),
            "breaker": self.breaker.state_dict()
            if self.breaker is not None else None,
        }

    # -------------------------------------------------------- lifecycle --
    def run_forever(self, interval_s: Optional[float] = None,
                    stop: Optional[threading.Event] = None) -> None:
        """Paced control loop (the launcher runs this on a side thread
        under the router's event loop)."""
        interval = float(flags.flag("fleet_tick_interval_s")
                         if interval_s is None else interval_s)
        while stop is None or not stop.is_set():
            self.tick()
            if stop is not None:
                stop.wait(interval)
            else:
                time.sleep(interval)

    def shutdown(self, drain: bool = True,
                 timeout_s: Optional[float] = None) -> None:
        """Stop every managed replica (launcher teardown).  ``drain``
        gives in-flight requests a bounded chance first — bounded by
        ``FLAGS_fleet_drain_timeout_s`` unless overridden, the same
        window the drain protocol advertises everywhere else."""
        if timeout_s is None:
            timeout_s = float(flags.flag("fleet_drain_timeout_s")) \
                if drain else 10.0
        deadline = self._clock() + timeout_s
        if drain:
            for slot in self._slots:
                if slot.state in (STARTING, READY, DRAINING):
                    self.router.mark_draining(slot.handle.id, True)
                    slot.handle.begin_drain()
            while self._clock() < deadline and \
                    not all(s.handle.drained() for s in self._slots
                            if s.state in (STARTING, READY, DRAINING)):
                time.sleep(0.05)
        for slot in self._slots:
            self._deregister(slot)
            slot.handle.stop(timeout_s=max(0.1, deadline - self._clock()))
        self._slots.clear()
        # routers go last: the drains above may still relay through them
        for slot in self._router_slots:
            slot.handle.stop(timeout_s=max(0.1, deadline - self._clock()))
        self._router_slots.clear()
        self._export_gauges()
