"""Deterministic, seeded fault injection for the fleet (port of
``paddle_tpu/fleet/chaos.py``).

A robustness claim nobody has tried to break is a guess.  This module
makes the breaking reproducible: an explicit **fault plan** — a list of
``FaultEvent(tick, kind, target)`` records, written by hand or generated
from a seed — applied at supervisor-tick boundaries by a
:class:`ChaosController`.  Because faults fire at ticks the test/bench
controls (never wall-clock timers), the same plan against the same
traffic produces the same lifecycle every run.

Fault kinds and their real-world shapes:

- ``kill`` — SIGKILL: in-flight responses EOF mid-stream with no
  terminator, new connections refused, the engine/process is gone.
- ``wedge`` / ``unwedge`` — SIGSTOP/SIGCONT: connections still open (the
  kernel's backlog accepts for a stopped process) but nothing ever
  answers — health polls and stream heads time out.
- ``refuse`` / ``allow`` — connect refusals (crashed-but-port-closed,
  firewall flap): ``open()`` raises ``ConnectionRefusedError``.
- ``poll_timeout`` / ``poll_ok`` — only GETs (health polls) black-hole;
  completions still flow: the router must NOT kill a replica that
  serves traffic but answers status slowly... and when it does mark it
  dead, the supervisor must notice the process is actually fine.
- ``cut`` — mid-stream socket cut: every in-flight response severed,
  the replica itself stays healthy (the dropped-TCP shape).
- ``throttle`` / ``unthrottle`` — slow frames: each response line is
  delayed ``arg`` seconds (degraded network / overloaded replica).
- ``migrate_interrupt`` / ``partial_transfer`` — drain-migration faults
 : a one-shot marker on the target's HANDLE consumed by its
  next drain migration — ``migrate_interrupt`` kills the transfer
  between export and import (nothing installed anywhere),
  ``partial_transfer`` truncates every snapshot's page list mid-flight
  (with integrity digests on, the importer REJECTS the
  corrupt snapshot with zero leaked allocator refs).  Both leave the
  drain itself intact.
- ``router_kill`` — a SIGKILL aimed at a control-plane node: the target
  is a supervised router slot id (``rt1``...), gripped through
  ``ChaosController.register_router`` (the supervisor's
  ``on_router_spawn`` seam).  The victim's in-flight client streams
  sever, its heartbeats stop, its ring span moves to the survivors, and
  the store-replicated journal lets the new owner resume its sessions.
- ``poison`` — a deterministically-fatal request: the event
  ``target`` is the poison PROMPT as space-joined token ids (not a
  replica id — a poison kills whatever replica it is dispatched on).
  Once armed, any ``/v1/completions`` whose prompt matches kills its
  replica at dispatch through the ``InprocReplica`` seam (in-flight
  streams sever, the engine dies) — the replay-amplification shape the
  router's quarantine + the fleet's cascade breaker must contain.

Transport faults ride :class:`ChaosClient`, a ``ReplicaClient`` wrapper
the router speaks through (``ChaosController.wrap`` is the
``client_wrap`` seam on ``InprocReplicaHandle``); process faults
(``kill``, and ``wedge`` on a process handle with ``suspend``) act on
the registered :class:`ReplicaHandle`.
"""

from __future__ import annotations

import asyncio
import random
from typing import Dict, List, Sequence, Tuple

__all__ = ["FaultEvent", "ChaosPlan", "ChaosClient", "ChaosController",
           "KINDS"]

KINDS = ("kill", "wedge", "unwedge", "refuse", "allow", "poll_timeout",
         "poll_ok", "cut", "throttle", "unthrottle",
         "migrate_interrupt", "partial_transfer", "poison",
         "router_kill")
# (fault, recovery) pairs the seeded generator schedules together so a
# generated plan never leaves a replica permanently faulted by accident
_PAIRED = {"wedge": "unwedge", "refuse": "allow",
           "poll_timeout": "poll_ok", "throttle": "unthrottle"}


class FaultEvent:
    """One scheduled fault: at supervisor tick ``tick``, apply ``kind``
    to replica ``target`` (``arg`` = throttle delay seconds)."""

    __slots__ = ("tick", "kind", "target", "arg")

    def __init__(self, tick: int, kind: str, target: str,
                 arg: float = 0.0):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; have {KINDS}")
        self.tick = int(tick)
        self.kind = kind
        self.target = target
        self.arg = float(arg)

    def describe(self) -> dict:
        return {"tick": self.tick, "kind": self.kind,
                "target": self.target, "arg": self.arg}

    def __repr__(self):
        return (f"FaultEvent(tick={self.tick}, kind={self.kind!r}, "
                f"target={self.target!r})")


class ChaosPlan:
    """An ordered fault schedule.  Build it explicitly (the tier-1
    scenario names its faults) or generate one from a seed — the
    generator is pure ``random.Random(seed)``, so a plan is fully
    reproduced by its ``(seed, ticks, targets)`` triple."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.tick, e.kind, e.target))

    @classmethod
    def generate(cls, seed: int, *, ticks: int, targets: Sequence[str],
                 kinds: Sequence[str] = ("kill", "wedge", "refuse",
                                         "cut", "throttle"),
                 n_faults: int = 4,
                 recovery_ticks: int = 3) -> "ChaosPlan":
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            target = rng.choice(list(targets))
            tick = rng.randrange(max(1, ticks - recovery_ticks))
            arg = round(rng.uniform(0.01, 0.05), 4) \
                if kind == "throttle" else 0.0
            events.append(FaultEvent(tick, kind, target, arg))
            if kind in _PAIRED:
                events.append(FaultEvent(tick + recovery_ticks,
                                         _PAIRED[kind], target))
        return cls(events)

    def describe(self) -> list:
        return [e.describe() for e in self.events]


# ---------------------------------------------------------------------------
# transport-seam fault injection
# ---------------------------------------------------------------------------

class ChaosClient:
    """Fault-injecting wrapper around a ``ReplicaClient``: the router
    (and health poller) speak through this, so transport faults land on
    every code path a real network fault would.  ``inner`` stays
    reachable for handle-level verbs (kill severs the real streams)."""

    def __init__(self, inner, controller=None):
        self.inner = inner
        self.id = inner.id
        self.controller = controller     # poison lookups + kill verb
        self.refuse = False
        self.wedged = False
        self.poll_black_hole = False
        self.frame_delay_s = 0.0
        # open relays: (outer_reader, pump_task or None) for cut support
        self._open: set = set()

    def _poison_hit(self, path: str, body: bytes) -> bool:
        c = self.controller
        if c is None or not c.poison_prompts or \
                path != "/v1/completions":
            return False
        try:
            import json as _json
            p = _json.loads(body.decode() or "{}").get("prompt")
            return isinstance(p, list) and tuple(p) in c.poison_prompts
        except (ValueError, UnicodeDecodeError):
            return False

    async def open(self, method, path, headers=(), body=b""):
        if self.refuse:
            raise ConnectionRefusedError(
                f"chaos: replica {self.id} refusing connects")
        if self.wedged or (self.poll_black_hole and method == "GET"):
            # SIGSTOP shape: the connection opens, nothing ever answers.
            # The caller's wait_for owns the timeout; close() is a no-op
            # (there is nothing to tear down — exactly a frozen peer).
            return asyncio.StreamReader(), (lambda: None)
        reader, close = await self.inner.open(method, path,
                                              headers=headers, body=body)
        if method == "POST" and self._poison_hit(path, body):
            # poison: the dispatch is what kills the replica.
            # The request reached it — NOW the engine dies: in-flight
            # responses (this one included) sever, so the router sees a
            # post-dispatch death on THIS replica, exactly the
            # attribution evidence the quarantine strikes on.
            self.controller.kill_replica(self.id)
        if self.frame_delay_s <= 0:
            # track for cut(): severing rides the inner replica's writer
            # seam (InprocReplica.sever_streams), no relay needed
            return reader, close
        # throttled: relay line-by-line with a delay per frame line
        outer = asyncio.StreamReader()
        delay = self.frame_delay_s

        async def _pump():
            try:
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    await asyncio.sleep(delay)
                    outer.feed_data(line)
            except Exception:
                pass
            finally:
                try:
                    outer.feed_eof()
                except AssertionError:
                    pass

        task = asyncio.ensure_future(_pump())
        entry = (outer, task)
        self._open.add(entry)
        task.add_done_callback(lambda _t: self._open.discard(entry))

        def _close():
            task.cancel()
            self._open.discard(entry)
            close()

        return outer, _close

    def cut_streams(self) -> None:
        """Mid-stream socket cut: sever every in-flight response (the
        replica stays healthy; new connections succeed)."""
        inner = self.inner
        if hasattr(inner, "sever_streams"):
            inner.sever_streams()
        for outer, task in list(self._open):
            task.cancel()
            try:
                outer.feed_eof()
            except AssertionError:
                pass
            self._open.discard((outer, task))

    def describe(self) -> dict:
        d = dict(self.inner.describe())
        faults = [n for n, on in (("refuse", self.refuse),
                                  ("wedged", self.wedged),
                                  ("poll_black_hole",
                                   self.poll_black_hole),
                                  ("throttled", self.frame_delay_s > 0))
                  if on]
        d["chaos"] = faults
        return d


class ChaosController:
    """Applies a :class:`ChaosPlan` to a live fleet at tick boundaries.

    ``wrap()`` is handed to ``InprocReplicaHandle(client_wrap=...)`` so
    every replica generation (including crash-restarts) registers its
    transport here under its slot id; ``register_handle()`` adds the
    process-level grip.  ``advance(tick)`` applies every not-yet-applied
    event scheduled at or before ``tick`` and returns the applied list
    — drive it from the same loop that calls ``supervisor.tick()``."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._applied = 0
        self.log: List[Tuple[int, dict]] = []
        self._clients: Dict[str, ChaosClient] = {}
        self._handles: Dict[str, object] = {}
        self._routers: Dict[str, object] = {}   # supervised router slots
        # armed poison prompts (tuples of token ids) + kills they caused
        self.poison_prompts: set = set()
        self.poison_kills: List[str] = []

    def wrap(self, client) -> ChaosClient:
        wrapped = ChaosClient(client, controller=self)
        self._clients[client.id] = wrapped   # latest generation wins
        return wrapped

    def register_handle(self, handle) -> None:
        self._handles[handle.id] = handle

    def register_router(self, handle) -> None:
        """The supervisor's ``on_router_spawn`` seam: grip every router
        slot generation, so ``router_kill`` aims at the live handle (a
        fault against a stale one would do nothing)."""
        self._routers[handle.id] = handle

    def kill_replica(self, rid: str) -> None:
        """Kill one replica NOW (the poison dispatch seam): through its
        registered handle when the supervisor owns it, else the inner
        transport's kill."""
        self.poison_kills.append(rid)
        handle = self._handles.get(rid)
        client = self._clients.get(rid)
        if handle is not None:
            handle.kill()
        elif client is not None and hasattr(client.inner, "kill"):
            client.inner.kill()

    def _apply(self, e: FaultEvent) -> None:
        client = self._clients.get(e.target)
        handle = self._handles.get(e.target)
        if e.kind == "kill":
            if handle is not None:
                handle.kill()
            elif client is not None and hasattr(client.inner, "kill"):
                client.inner.kill()
        elif e.kind == "wedge":
            if client is not None:
                client.wedged = True
            if handle is not None and hasattr(handle, "suspend"):
                handle.suspend()
        elif e.kind == "unwedge":
            if client is not None:
                client.wedged = False
            if handle is not None and hasattr(handle, "resume"):
                handle.resume()
        elif e.kind == "refuse":
            if client is not None:
                client.refuse = True
        elif e.kind == "allow":
            if client is not None:
                client.refuse = False
        elif e.kind == "poll_timeout":
            if client is not None:
                client.poll_black_hole = True
        elif e.kind == "poll_ok":
            if client is not None:
                client.poll_black_hole = False
        elif e.kind == "cut":
            if client is not None:
                client.cut_streams()
        elif e.kind == "throttle":
            if client is not None:
                client.frame_delay_s = e.arg or 0.02
        elif e.kind == "unthrottle":
            if client is not None:
                client.frame_delay_s = 0.0
        elif e.kind == "migrate_interrupt":
            if handle is not None:
                handle._chaos_migrate = "interrupt"
        elif e.kind == "partial_transfer":
            if handle is not None:
                handle._chaos_migrate = "partial"
        elif e.kind == "poison":
            # target = the poison PROMPT as space-joined token ids (a
            # poison kills whatever replica it lands on, so no replica
            # id to aim at)
            self.poison_prompts.add(
                tuple(int(t) for t in e.target.split()))
        elif e.kind == "router_kill":
            router = self._routers.get(e.target)
            if router is not None:
                router.kill()

    def advance(self, tick: int) -> List[FaultEvent]:
        applied: List[FaultEvent] = []
        while self._applied < len(self.plan.events) and \
                self.plan.events[self._applied].tick <= tick:
            e = self.plan.events[self._applied]
            self._applied += 1
            self._apply(e)
            self.log.append((tick, e.describe()))
            applied.append(e)
        return applied

    def exhausted(self) -> bool:
        return self._applied >= len(self.plan.events)
