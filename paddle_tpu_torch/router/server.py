"""RouterServer: the multi-replica serving front door (port of
``paddle_tpu/router/server.py``).

One asyncio process fronting N ``ServingServer`` replicas behind the
same OpenAI-compatible API the replicas themselves speak:

- ``POST /v1/completions`` — placed by score (prefix residency + load +
  session affinity; see ``placement.py``), proxied to the chosen replica
  with the router's trace id in ``X-Trace-Id`` so replica engine spans
  land on the SAME Chrome-trace lane as the router span (one request,
  one correlated track, fleet-wide).  Streaming responses relay SSE
  frames as they arrive (client TTFT rides the replica's drain cadence,
  not the request's completion).
- ``GET /metrics`` — the router process registry (``router.*`` series;
  with in-process replicas this IS the fleet aggregate, because the
  registry is process-wide and carries every replica's ``serving.*``
  series too.  HTTP replicas export their own ``/metrics`` — point the
  scraper at each; ``/statusz`` here aggregates their placement view).
- ``GET /healthz`` — fleet liveness: 200 while >= 1 replica answers
  polls.  ``GET /readyz`` — fleet readiness: 200 while >= 1 replica is
  warm (a ``warmup=True`` replica is NOT ready until its warm-up run
  finishes — the router never places live traffic on a cold engine).
- ``GET /statusz`` — per-replica state (health, load, digest size, SLO
  burn), session-pin table, placement/failover counters.

Health: each replica is polled (``/statusz``) every
``FLAGS_router_health_interval_s`` with exponential backoff on failure
(up to 8x); ``FLAGS_router_dead_after`` consecutive failures report it
``dead``.  A failed poll excludes the replica from NEW placements
immediately — re-route first, diagnose later — while polling continues
so a recovered replica rejoins.  Without a background poll task (the
tier-1 tests run one event loop per request), stale state refreshes
inline before placement, so the router is correct, just lazier.

Failover: a replica dying mid-conversation
no longer has to cost the conversation.  A connect-phase failure
re-places the request on the next-best candidate
(``router.failover{phase=connect}``).  An upstream death AFTER dispatch
consults the per-request replay journal (``router/journal.py``): for a
journaled GREEDY session the router re-places on a survivor, replays
the prompt plus every already-relayed token as a prefill (prefix-cache
hits — and drain migration — make the replay a near no-op),
and keeps relaying from the next token: the client sees ONE unbroken
SSE stream, bit-identical to a no-fault run
(``router.resumes{outcome=resumed}``).  Post-dispatch unary deaths
re-run the same way (``outcome=unary``).  Only when replay is
impossible — journal evicted/overflowed, sampled session, no greedy
survivor — does the synthesized-error contract apply: a synthesized
``finish_reason: "error"`` chunk plus ``data: [DONE]`` for streams
(never a silent truncation), 502 for unary
(``router.failover{phase=stream}``, ``router.resumes{outcome=
ineligible|exhausted}``).

Fleet admission: per-replica SLO burn (the ``serving/slo.py`` windows,
read from each ``/statusz``) aggregates at the router — when every live
replica is shedding, the router sheds fleet-wide with ``Retry-After``
derived from the soonest replica's live burn window (min of their
``retry_after_s``), mirrored into the JSON error body.

Disaggregated serving: with prefill-role replicas in the fleet, a new
journaled stream runs a one-token leg on a prefill replica, its finished
prefix ships to a decode successor over ``/migratez`` (``_handoff_kv``),
and the decode leg splices into the same client stream.

Multi-router control plane: with a ``RouterControlPlane`` attached
(``controlplane=``) this router is one of N.  It heartbeats its membership
into the shared store, forwards a session it does not own one hop to the
session's ring owner (``X-Router-Forwarded`` guards against loops), mirrors
each in-flight journaled stream into the store, and adopts a dead peer's
record, so the dead router's streams resume here (``_maybe_takeover``).

Fleet tracing: ``router.collector`` (a ``TraceCollector``, attached by the
fleet launcher or a harness) backs ``GET /tracez`` (the merged, clock-aligned
timeline of one request) and ``POST /collectz`` (span-batch ingest and the
clock handshake).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from .. import flags
from .. import observability as _obs
from ..serving import http as _http
from ..serving.slo import jittered_retry_after
from .journal import SessionJournal
from .placement import Placer, ReplicaState, weighted_rank
from .quarantine import PoisonQuarantine, request_signature
from .replica import ReplicaClient

__all__ = ["RouterServer", "route_forever"]

_TRACE_ID_OK = _http.SAFE_ID_OK
_SESSION_ID_OK = _TRACE_ID_OK

# handoff successor preference: the decode fleet takes the
# generation leg; mixed absorbs; another prefill replica only as a last
# resort.  The FALLBACK rank (a failed handoff re-prefills instead)
# prefers mixed first — decode replicas keep their slots for handoffs.
_HANDOFF_RANK = {"decode": 0, "mixed": 1, "prefill": 2}
_FALLBACK_RANK = {"mixed": 0, "decode": 1, "prefill": 2}


class _RouterMetrics:
    """Registry handles resolved once."""

    __slots__ = ("requests", "streams", "responses", "inflight",
                 "request_ms", "failover", "shed", "slo_decision",
                 "health_polls", "replicas_gauge", "resumes", "handoff",
                 "overlay_entries", "forwarded")

    def __init__(self):
        m = _obs.metrics
        self.requests = m.counter("router.requests")
        self.streams = m.counter("router.streams")
        self.responses = lambda code: m.counter("router.responses",
                                                code=str(code))
        self.inflight = m.gauge("router.inflight")
        self.request_ms = m.histogram("router.request_ms")
        # the lambda-param labels below are bounded by construction:
        # every caller passes a literal ("connect"/"stream", "ok"/"fail",
        # "live"/"suspect"/"dead", admit/queue/shed)
        self.failover = lambda phase: m.counter("router.failover",
                                                phase=phase)
        self.resumes = lambda o: m.counter("router.resumes", outcome=o)
        self.handoff = lambda o: m.counter("router.handoff", outcome=o)
        self.overlay_entries = m.gauge("router.overlay_entries")
        self.forwarded = lambda o: m.counter("router.forwarded",
                                             outcome=o)
        self.shed = m.counter("router.shed")
        self.slo_decision = lambda d: m.counter("router.slo_decision",
                                                decision=d)
        self.health_polls = lambda r: m.counter("router.health_polls",
                                                result=r)
        self.replicas_gauge = lambda s: m.gauge("router.replicas", state=s)


class RouterServer:
    """Routes the replica-compatible API over N replica clients.

    ``replicas``: list of ``ReplicaClient`` (``InprocReplica`` handles
    for same-process fleets, ``HttpReplica`` for real deployments).
    ``policy`` overrides ``FLAGS_router_placement``.
    """

    def __init__(self, replicas: List[ReplicaClient], *,
                 model_name: str = "paddle-tpu",
                 policy: Optional[str] = None,
                 health_interval_s: Optional[float] = None,
                 dead_after: Optional[int] = None,
                 poll_timeout_s: Optional[float] = None,
                 allow_empty: bool = False,
                 router_id: str = "router0",
                 controlplane=None,
                 discover_replicas: bool = False):
        # an empty replica set is only sane when a fleet supervisor owns
        # the set and will register replicas as they warm; a
        # hand-launched router with zero upstreams is a misconfiguration
        if not replicas and not allow_empty:
            raise ValueError("RouterServer needs at least one replica "
                             "(or allow_empty=True under a supervisor)")
        ids = [r.id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        f = flags.flag
        self.states = [ReplicaState(r) for r in replicas]
        self.model_name = model_name
        self.placer = Placer(policy=policy)
        self.health_interval_s = float(f("router_health_interval_s")
                                       if health_interval_s is None
                                       else health_interval_s)
        self.dead_after = int(f("router_dead_after")
                              if dead_after is None else dead_after)
        self.poll_timeout_s = float(f("router_poll_timeout_s")
                                    if poll_timeout_s is None
                                    else poll_timeout_s)
        self._m = _RouterMetrics()
        # failover-resume journal: prompt + relayed tokens per
        # in-flight request, replayed onto a survivor on unplanned death
        self.journal = SessionJournal()
        self._resume_on = bool(f("router_failover_resume"))
        # poison-request quarantine: crash attribution per
        # request signature — a signature struck FLAGS_router_poison_
        # strikes times without progress is refused instead of replayed
        self.quarantine = PoisonQuarantine()
        # disaggregated prefill/decode serving: an eligible
        # new stream places on the prefill fleet with a 1-token budget
        # cap; the finished prefix ships to a decode successor over the
        # migration plane and the two legs splice into ONE client stream
        self._handoff_on = bool(f("router_prefill_handoff"))
        self._handoff_timeout_s = float(f("router_handoff_timeout_s"))
        # cascade breaker: attached by the fleet supervisor
        # (fleet/breaker.py); None = no breaker, resumes never park
        self.breaker = None
        self._park_timeout_s = float(f("router_breaker_park_timeout_s"))
        self._parked = 0              # resumes currently parked
        # multi-router control plane: with a RouterControlPlane attached
        # this router is one of N: it heartbeats membership, forwards the
        # sessions it does not own one hop to their ring owner, and adopts
        # a dead peer's store-replicated journal so its streams resume here
        self.router_id = (controlplane.rid if controlplane is not None
                          else router_id)
        self.cp = controlplane
        self._discover_replicas = bool(discover_replicas)
        self._cp_task: Optional[asyncio.Task] = None
        # fleet tracing: the launcher or a harness attaches a
        # TraceCollector here; /tracez serves its merged timelines and
        # /collectz is its HTTP span ingest
        self.collector = None
        # takeovers waiting for their first live token: id(journal entry)
        # -> the takeover's start, closed as a ``router.replay`` span
        self._replaying: Dict[int, float] = {}
        self._t0 = time.perf_counter()
        self._next_rid = 0
        self._health_tasks: Dict[str, asyncio.Task] = {}
        self._health_loop_obj: Optional[asyncio.AbstractEventLoop] = None
        self._refresh_task: Optional[asyncio.Task] = None
        self._asyncio_server = None

    # ------------------------------------------------------------ health --
    async def _get_json(self, client: ReplicaClient, path: str) -> dict:
        """One GET against a replica, parsed as JSON (poll path: the
        whole exchange is bounded by the poll timeout)."""
        reader, close = await asyncio.wait_for(
            client.open("GET", path), self.poll_timeout_s)
        try:
            status, headers, body = await asyncio.wait_for(
                _read_response(reader), self.poll_timeout_s)
        finally:
            close()
        if status != 200:
            raise ConnectionError(f"{path} -> {status}")
        return json.loads(body.decode())

    async def poll_replica(self, state: ReplicaState) -> bool:
        """Poll one replica's /statusz into its placement view."""
        try:
            doc = await self._get_json(state.client,
                                       state.statusz_path())
        except (Exception, asyncio.TimeoutError):
            state.mark_failed()
            self._m.health_polls("fail").inc()
            # exponent capped BEFORE the power: fails grows without bound
            # on a long-dead replica and 2.0**1024 is OverflowError, which
            # would kill the health loop and strand the replica dead even
            # after it recovers
            backoff = 2.0 ** min(state.fails, 3)
            state.next_poll = time.perf_counter() + \
                self.health_interval_s * backoff
            return False
        state.apply_statusz(doc, dead_after=self.dead_after)
        self._m.health_polls("ok").inc()
        state.next_poll = time.perf_counter() + self.health_interval_s
        return True

    async def poll_replicas(self) -> None:
        """Poll every replica once, concurrently (tests and the inline
        staleness refresh call this; the background loop paces itself)."""
        await asyncio.gather(*(self.poll_replica(s) for s in self.states))
        self._export_replica_gauges()

    def _export_replica_gauges(self) -> None:
        counts = {s: 0 for s in ("ready", "warming", "suspect", "dead",
                                 "draining")}
        for st in self.states:
            counts[st.status(self.dead_after)] += 1
        for s, n in counts.items():
            self._m.replicas_gauge(s).set(n)
        self._m.overlay_entries.set(
            sum(len(st.routed) for st in self.states))

    # ----------------------------------------- supervisor registration --
    def add_replica(self, client: ReplicaClient) -> ReplicaState:
        """Register a replica live (the fleet supervisor's seam: called
        once a spawned replica passes /readyz warmup).  A same-id
        re-register (crash-restart) replaces the stale state.  List
        append/replace is GIL-atomic against concurrent placement
        snapshots — candidates read a momentarily-old set at worst."""
        state = ReplicaState(client)
        for i, s in enumerate(self.states):
            if s.id == client.id:
                self.states[i] = state
                break
        else:
            self.states.append(state)
        loop = self._health_loop_obj
        if loop is not None and not loop.is_closed():
            # background polling is on: the new replica gets its poll
            # task too (threadsafe — the supervisor calls from its own
            # control-loop thread; the replaced state's task self-
            # terminates on its next wake, no longer being in states)
            loop.call_soon_threadsafe(self._spawn_health_task, state)
        self._export_replica_gauges()
        return state

    def remove_replica(self, rid: str) -> bool:
        """Drop a replica from the set (drained out or permanently
        failed).  In-flight relays hold their own state reference and
        finish unaffected; session pins to the id simply re-score."""
        for s in list(self.states):
            if s.id == rid:
                self.states.remove(s)
                loop = self._health_loop_obj
                if loop is not None and not loop.is_closed():
                    loop.call_soon_threadsafe(self._cancel_health_task,
                                              rid)
                self._export_replica_gauges()
                return True
        return False

    def mark_draining(self, rid: str, draining: bool = True) -> bool:
        """Pin a replica `draining` router-side IMMEDIATELY (excluded
        from new placements before its next /statusz can confirm);
        in-flight streams and honored session pins finish out."""
        for s in self.states:
            if s.id == rid:
                s.drain_pin = draining
                self._export_replica_gauges()
                return True
        return False

    def fleet_signals(self) -> dict:
        """The autoscaler's aggregate inputs, from the polled view: SLO
        burn (shedding placeable replicas), load (router in-flight +
        polled queue depth), and the sentinel's anomaly stream."""
        live = [s for s in self.states if s.ok]
        placeable = [s for s in live if s.ready and not s.draining]
        shedding = sum(1 for s in placeable if s.slo_decision == "shed")
        # per-role aggregates: the supervisor scales each
        # role on its own signal — prefill fleets on queue depth (TTFT
        # pressure), decode fleets on resident load (ITL pressure)
        by_role: Dict[str, List[ReplicaState]] = {}
        for s in placeable:
            by_role.setdefault(s.role, []).append(s)
        roles = {r: {
            "placeable": len(ss),
            "shedding": sum(1 for x in ss if x.slo_decision == "shed"),
            "mean_load": sum(x.load() for x in ss) / len(ss),
            "mean_queue_depth": sum(x.queue_depth for x in ss) / len(ss),
        } for r, ss in by_role.items()}
        return {
            "replicas": len(self.states),
            "live": len(live),
            "placeable": len(placeable),
            "shedding": shedding,
            "all_shedding": bool(placeable) and shedding == len(placeable),
            "mean_load": (sum(s.load() for s in placeable)
                          / len(placeable)) if placeable else 0.0,
            "roles": roles,
            "anomaly_total": sum(s.anomaly_total for s in self.states),
        }

    def restage(self, src: str, dst: str) -> int:
        """Supervisor seam for the proactive rebalance: the
        sessions pinned to ``src`` just had their KV pre-staged on
        ``dst`` over the migration plane — re-point their pins so their
        next turns land where the pages now live."""
        return self.placer.repin(src, dst)

    async def _health_loop(self, state: ReplicaState) -> None:
        while state in self.states:     # self-terminates after removal
            now = time.perf_counter()
            if now >= state.next_poll:
                await self.poll_replica(state)
                self._export_replica_gauges()
            await asyncio.sleep(
                max(0.05, min(self.health_interval_s,
                              state.next_poll - time.perf_counter())))
        # identity-guarded: a same-id replacement may already own the slot
        if self._health_tasks.get(state.id) is asyncio.current_task():
            self._health_tasks.pop(state.id, None)

    def _cancel_health_task(self, rid: str) -> None:
        t = self._health_tasks.pop(rid, None)
        if t is not None:
            t.cancel()

    def _spawn_health_task(self, state: ReplicaState) -> None:
        loop = self._health_loop_obj
        if loop is None or loop.is_closed():
            return      # background polling stopped since this was queued
        old = self._health_tasks.pop(state.id, None)
        if old is not None:
            old.cancel()
        self._health_tasks[state.id] = \
            loop.create_task(self._health_loop(state))

    def start_health(self) -> None:
        """Spawn one background poll task per replica on the RUNNING
        loop (production path; tests poll explicitly instead).  Replicas
        registered LATER (the fleet supervisor's add_replica) get their
        poll task on this loop too."""
        if self._health_tasks:
            return
        self._health_loop_obj = asyncio.get_running_loop()
        for s in self.states:
            self._spawn_health_task(s)

    def stop_health(self) -> None:
        for t in self._health_tasks.values():
            t.cancel()
        self._health_tasks = {}
        self._health_loop_obj = None

    async def _refresh_if_stale(self) -> None:
        """Inline refresh when no background poller owns freshness: a
        state never polled, or polled longer than the health interval
        ago, re-polls before placement (dead replicas respect their
        backoff deadline so a down upstream does not add a connect
        timeout to every request).  Concurrent arrivals share ONE
        in-flight refresh — a herd of requests landing on stale state
        must not each launch a full fleet of duplicate polls."""
        if self._health_loop_obj is not None:   # background poller owns it
            return
        task = self._refresh_task
        if task is None or task.done() or \
                task.get_loop() is not asyncio.get_running_loop():
            # (loop check: the in-process test idiom runs one event loop
            # per request — a task stranded on a finished loop is stale)
            task = asyncio.ensure_future(self._refresh_stale_now())
            self._refresh_task = task
        # awaiting a shared Task is cancel-safe: cancelling one awaiter
        # does not cancel the refresh the others are waiting on
        await task

    async def _refresh_stale_now(self) -> None:
        now = time.perf_counter()

        def stale(s: ReplicaState) -> bool:
            if s.ok:
                return s.last_poll is None or \
                    now - s.last_poll > self.health_interval_s
            # failing replicas respect their backoff deadline — a dead
            # upstream must not add a connect timeout to every request
            return now >= s.next_poll

        todo = [s for s in self.states if stale(s)]
        if todo:
            await asyncio.gather(*(self.poll_replica(s) for s in todo))
            self._export_replica_gauges()

    # ---------------------------------------------------- control plane --
    async def cp_tick(self) -> bool:
        """One control-plane beat: heartbeat + membership refresh (and,
        for store-discovered fleets, replica-set sync).  Tests and the
        in-proc supervisor call this explicitly; production routers run
        it on the background loop.  Returns True when the ring moved."""
        if self.cp is None:
            return False
        moved = await self.cp.tick()
        if self._discover_replicas:
            await self._sync_replicas_from_store()
        return moved

    async def _cp_loop(self) -> None:
        interval = float(flags.flag("controlplane_heartbeat_interval_s"))
        while True:
            try:
                await self.cp_tick()
            except Exception:
                pass                 # a store blip must not kill the loop
            await asyncio.sleep(max(0.05, interval))

    async def _sync_replicas_from_store(self) -> None:
        """Adopt the supervisor-published replica set (``replica/<id>``
        store keys): process routers launched with ``--store`` need no
        ``--replica`` flags and follow fleet scaling live."""
        try:
            members = await self.cp.replica_members()
        except Exception:
            return
        known = {s.id for s in self.states}
        for rid, addr in members.items():
            if rid not in known and isinstance(addr, dict) \
                    and "host" in addr:
                from .replica import HttpReplica
                self.add_replica(HttpReplica(rid, addr["host"],
                                             int(addr["port"])))
        for s in list(self.states):
            if s.id not in members:
                self.remove_replica(s.id)

    async def _cp_publish(self, entry) -> None:
        """Mirror a journaled stream's state into the store so the
        session's NEXT owner can resume it if this router dies.  Best
        effort: a store outage must not kill the live stream."""
        t0 = self._replaying.pop(id(entry), None)
        if t0 is not None and _obs.TRACER.enabled:
            # a takeover's first live token: the replay leg (re-prefilling
            # the prompt and the journaled tokens) is over
            _obs.TRACER.event("router.replay", t0, time.perf_counter() - t0,
                              cat="router", tid=entry.trace_id,
                              args={"trace_id": entry.trace_id,
                                    "proc": f"router:{self.router_id}",
                                    "session": entry.session_id})
        if (self.cp is None or entry is None
                or entry.session_id is None or not entry.resumable):
            return
        try:
            await self.cp.publish_journal(entry.session_id, {
                "router": self.cp.rid,
                "prompt": list(entry.prompt),
                "emitted": list(entry.emitted),
                "payload": entry.payload,
                "max_tokens": entry.max_tokens,
                # the originating trace id rides the replicated journal,
                # so a surviving router's takeover resume continues the
                # same trace lane
                "trace_id": entry.trace_id})
        except Exception:
            pass

    # ----------------------------------------------------------- handler --
    async def handle(self, reader, writer) -> None:
        """One client HTTP connection (asyncio.start_server signature;
        in-process stream stand-ins equally welcome)."""
        t0 = time.perf_counter()
        status = 500
        self._m.requests.inc()
        self._m.inflight.inc(1)
        try:
            try:
                method, path, headers, body = \
                    await _http.read_request(reader)
            except _http.HttpError as e:
                status = e.status
                writer.write(_http.error_response(e.status, e.message))
                await writer.drain()
                return
            status = await self._route(method, path, headers, body, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            status = 499
        except Exception as e:
            try:
                writer.write(_http.error_response(
                    500, f"{type(e).__name__}: {e}",
                    err_type="internal_error"))
                await writer.drain()
            except Exception:
                pass
        finally:
            self._m.inflight.inc(-1)
            self._m.responses(status).inc()
            self._m.request_ms.observe((time.perf_counter() - t0) * 1e3)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, method, path, headers, body, writer) -> int:
        path, _, query = path.partition("?")
        if path == "/metrics" and method == "GET":
            text = _obs.prometheus_text().encode()
            writer.write(_http.response(
                200, text, content_type="text/plain; version=0.0.4"))
            await writer.drain()
            return 200
        if path == "/healthz" and method == "GET":
            await self._refresh_if_stale()
            up = sum(s.ok for s in self.states)
            ok = up >= 1
            writer.write(_http.json_response(
                200 if ok else 503,
                {"status": "ok" if ok else "no replica answering",
                 "replicas_up": up, "replicas": len(self.states)}))
            await writer.drain()
            return 200 if ok else 503
        if path == "/readyz" and method == "GET":
            await self._refresh_if_stale()
            n = len(self._candidates(include_shedding=True))
            writer.write(_http.json_response(
                200 if n else 503,
                {"ready": bool(n), "replicas_ready": n}))
            await writer.drain()
            return 200 if n else 503
        if path == "/statusz" and method == "GET":
            await self._refresh_if_stale()
            writer.write(_http.json_response(200, self.statusz()))
            await writer.drain()
            return 200
        if path == "/v1/completions" and method == "POST":
            return await self._completions(headers, body, writer)
        if path == "/tracez" and method == "GET":
            return await self._tracez(query, writer)
        if path == "/collectz" and method == "POST":
            return await self._collectz(body, writer)
        if path in ("/metrics", "/healthz", "/readyz", "/statusz",
                    "/v1/completions", "/tracez", "/collectz"):
            writer.write(_http.error_response(405, f"{method} not allowed"))
            await writer.drain()
            return 405
        writer.write(_http.error_response(404, f"no route {path}"))
        await writer.drain()
        return 404

    # ---------------------------------------------------- fleet tracing --
    async def _tracez(self, query, writer) -> int:
        """``GET /tracez?trace_id=`` — the merged, clock-aligned fleet
        timeline for one request from the attached ``TraceCollector``
        (the fleet launcher / tests wire ``router.collector``); without
        ``trace_id``, an index of known traces."""
        col = self.collector
        if col is None:
            writer.write(_http.error_response(
                503, "no trace collector attached to this router"))
            await writer.drain()
            return 503
        trace_id = None
        if query:
            from urllib.parse import parse_qs
            trace_id = (parse_qs(query).get("trace_id") or [None])[0]
        if not trace_id:
            ids = col.traces()
            writer.write(_http.json_response(
                200, {"traces": ids[-64:], "known": len(ids),
                      "processes": col.processes()}))
            await writer.drain()
            return 200
        doc = col.assemble(trace_id)
        if doc is None:
            writer.write(_http.error_response(
                404, f"no spans collected for trace {trace_id!r}"))
            await writer.drain()
            return 404
        writer.write(_http.json_response(200, doc))
        await writer.drain()
        return 200

    async def _collectz(self, body, writer) -> int:
        """``POST /collectz`` — span-export ingest (the direct-HTTP
        transport for processes with no control-plane store) and the
        ``{"op": "clock"}`` handshake probe.  Ingest is one dict fold
        into the collector's in-memory store — cheap enough for the
        event loop; the response timestamp doubles as the NTP-style
        server time."""
        col = self.collector
        if col is None:
            writer.write(_http.error_response(
                503, "no trace collector attached to this router"))
            await writer.drain()
            return 503
        try:
            doc = json.loads(body.decode() or "{}")
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            writer.write(_http.error_response(400, f"bad JSON body: {e}"))
            await writer.drain()
            return 400
        if doc.get("op") == "clock":
            writer.write(_http.json_response(200, {"t": col.now()}))
            await writer.drain()
            return 200
        resp = col.ingest(doc)
        writer.write(_http.json_response(200, resp))
        await writer.drain()
        return 200

    # -------------------------------------------------------- completions --
    def _candidates(self, include_shedding: bool = False
                    ) -> List[ReplicaState]:
        # draining replicas are excluded from NEW placements (their
        # in-flight streams finish out; a pinned session re-scores)
        return [s for s in self.states if s.ok and s.ready
                and not s.draining
                and (include_shedding or s.slo_decision != "shed")]

    def _trace_id(self, headers) -> str:
        t = headers.get("x-trace-id", "")
        if t and _TRACE_ID_OK(t):
            return t
        n = self._next_rid
        self._next_rid += 1
        return f"cmpl-rtr-{os.getpid():x}-{n:06x}-{os.urandom(4).hex()}"

    def _session_id(self, headers) -> Optional[str]:
        s = headers.get("x-session-id", "")
        return s if s and _SESSION_ID_OK(s) else None

    async def _completions(self, headers, body, writer) -> int:
        # the replica owns request validation (vocab bounds, pool sizing);
        # the router only needs the token ids for placement hashing —
        # an unparseable prompt simply places by load and lets the
        # replica return its 400
        prompt: List[int] = []
        payload: dict = {}
        try:
            doc = json.loads(body.decode() or "{}")
            if isinstance(doc, dict):
                payload = doc
            p = payload.get("prompt")
            if isinstance(p, str):
                p = [int(t) for t in p.split()]
            if isinstance(p, list) and all(
                    isinstance(t, int) and not isinstance(t, bool)
                    for t in p):
                prompt = p
        except (ValueError, UnicodeDecodeError):
            pass
        stream = bool(payload.get("stream", False))
        session_id = self._session_id(headers)

        # session-sharded ownership: a session belongs to exactly one
        # router on the consistent-hash ring, where its pins, journal and
        # quarantine strikes live.  A request landing on another router
        # forwards one hop to the owner; the X-Router-Forwarded loop guard
        # makes a stale ring view degrade to local service, never a loop.
        if self.cp is not None and session_id is not None:
            if "x-router-forwarded" in headers:
                self._m.forwarded("received").inc()
            else:
                owner = self.cp.owner(session_id)
                if owner != self.cp.rid:
                    code = await self._forward(owner, headers, body,
                                               writer)
                    if code is not None:
                        return code
                    # owner unreachable: availability beats purity, so
                    # serve here off the stale ring view
                    self._m.forwarded("fallback").inc()

        # poison quarantine: a signature that has struck out
        # is refused with a clean 503 BEFORE any replica sees it — the
        # alternative is another corpse and another restart-budget burn
        sig = request_signature(prompt, payload) if prompt else None
        if sig is not None and self.quarantine.quarantined(sig):
            ra = jittered_retry_after(self.quarantine.refuse(sig))
            writer.write(_http.error_response(
                503, "request quarantined: this prompt+sampling "
                     "signature has crashed "
                     f"{self.quarantine.strikes} replica(s) "
                     "(see /statusz quarantine)",
                err_type="quarantined",
                extra_headers=(("Retry-After", str(ra)),),
                fields={"quarantined": True, "retry_after_s": ra}))
            await writer.drain()
            return 503

        # cascade breaker: while the fleet is dying faster
        # than the supervisor can attribute it, new admissions shed —
        # jittered so the herd doesn't re-synchronize on a recovering
        # fleet; crash restarts continue behind the breaker
        br = self.breaker
        if br is not None and br.state == "open":
            ra = jittered_retry_after(max(1.0, br.cooldown_s))
            self._m.slo_decision("breaker").inc()
            writer.write(_http.error_response(
                503, "cascade breaker open: the fleet's death rate "
                     "tripped FLAGS_fleet_cascade_threshold "
                     "(see /statusz breaker)",
                err_type="overloaded_error",
                extra_headers=(("Retry-After", str(ra)),),
                fields={"retry_after_s": ra, "breaker": "open"}))
            await writer.drain()
            return 503

        await self._refresh_if_stale()
        live = self._candidates(include_shedding=True)
        if not live:
            # nobody to route to: distinguish "down" from "warming"
            warming = any(s.ok and not s.ready for s in self.states)
            self._m.slo_decision("unavailable").inc()
            ra = jittered_retry_after(max(1.0, self.health_interval_s))
            writer.write(_http.error_response(
                503,
                "no replica ready (fleet warming)" if warming
                else "no replica available",
                err_type="overloaded_error" if warming
                else "internal_error",
                extra_headers=(("Retry-After", str(ra)),),
                fields={"retry_after_s": ra}))
            await writer.drain()
            return 503
        candidates = [s for s in live if s.slo_decision != "shed"]
        if not candidates:
            # fleet-wide shed: every live replica is burning its SLO —
            # 503 BEFORE any replica melts, Retry-After from the soonest
            # replica's live burn window (re-jittered: N shed clients
            # with one identical deadline would re-herd the fleet)
            ra = jittered_retry_after(min(s.retry_after_s for s in live))
            self._m.slo_decision("shed").inc()
            self._m.shed.inc()
            writer.write(_http.error_response(
                503, "shedding load: every replica is burning its "
                     "latency SLO (see /statusz)",
                err_type="overloaded_error",
                extra_headers=(("Retry-After", str(ra)),),
                fields={"retry_after_s": ra}))
            await writer.drain()
            return 503
        self._m.slo_decision("admit").inc()

        trace_id = self._trace_id(headers)
        if stream:
            self._m.streams.inc()
        t_accept = time.perf_counter()
        # cross-router takeover: when this session's previous owner died
        # mid-stream, its store-replicated journal waits here (the ring
        # moved the session to us); adopt it and resume the stream
        code = None
        if (self.cp is not None and stream and session_id is not None
                and self._resume_on and prompt):
            code = await self._maybe_takeover(trace_id, session_id,
                                              prompt, payload,
                                              candidates, writer, sig)
        if code is None:
            code = await self._proxy(trace_id, session_id, prompt,
                                     payload, body, candidates, writer,
                                     stream, sig=sig)
        if _obs.TRACER.enabled:
            _obs.TRACER.event("router.request", t_accept,
                              time.perf_counter() - t_accept,
                              cat="router", tid=trace_id,
                              args={"trace_id": trace_id,
                                    "stream": stream,
                                    "proc": f"router:{self.router_id}",
                                    "prompt_tokens": len(prompt)})
        return code

    async def _forward(self, owner: str, headers, body,
                       writer) -> Optional[int]:
        """Proxy this request one hop to its owning router.
        Returns the relayed status, or None when the owner could not be
        reached BEFORE anything was written — the caller serves locally
        off its (possibly stale) ring view instead."""
        peer = self.cp.peer(owner)
        if peer is None:
            return None
        fwd = [("X-Router-Forwarded", self.cp.rid),
               ("Content-Type", "application/json")]
        for h in ("x-session-id", "x-trace-id"):
            if h in headers:
                fwd.append((h, headers[h]))
        try:
            up, close = await peer.open("POST", "/v1/completions",
                                        headers=tuple(fwd), body=body)
            status, _headers, head_raw = await _read_head(up)
        except Exception:
            return None
        self._m.forwarded("out").inc()
        try:
            writer.write(_head_with(head_raw, (
                ("X-Router-Owner", owner),)))
            await writer.drain()
            # pump verbatim until the owner closes: SSE frames, unary
            # bodies, and error documents all relay unmodified — the
            # owner's resume/quarantine/breaker machinery already ran
            while True:
                chunk = await up.read(65536)
                if not chunk:
                    break
                writer.write(chunk)
                await writer.drain()
        finally:
            close()
        return status

    async def _maybe_takeover(self, trace_id, session_id, prompt,
                              payload, candidates, writer,
                              sig) -> Optional[int]:
        """Adopt a dead peer's store-replicated journal for this
        session, if one is waiting and matches the resubmitted request.
        Returns None (no takeover — serve normally) or the final
        status."""
        try:
            rec = await self.cp.take_journal(session_id)
        except Exception:
            return None
        if not isinstance(rec, dict):
            return None
        emitted = rec.get("emitted")
        if (rec.get("router") == self.cp.rid
                or rec.get("prompt") != prompt
                or not emitted
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in emitted)):
            # our own live record, a different conversation, or nothing
            # relayed yet (a fresh serve replays from scratch anyway)
            self.cp.takeover("stale")
            return None
        # trace continuity: the journaled record carries the originating
        # request's trace id; resume on that lane (the same logical
        # request, only the router died), so the takeover leg joins the
        # original merged timeline
        orig = rec.get("trace_id")
        if isinstance(orig, str) and orig and _TRACE_ID_OK(orig):
            trace_id = orig
        return await self._takeover_resume(trace_id, session_id, prompt,
                                           payload, emitted, candidates,
                                           writer, sig)

    async def _takeover_resume(self, trace_id, session_id, prompt,
                               payload, emitted, candidates, writer,
                               sig) -> Optional[int]:
        """Resume a dead peer's stream here: re-emit the journaled
        tokens the client already saw on the old connection's stream
        position zero, then splice a live replay leg (the journal's
        replay plane): concatenated, the client's token stream is the
        no-fault run's."""
        entry = self.journal.begin(trace_id, session_id, prompt,
                                   dict(payload))
        if entry is None or not entry.resumable:
            self.journal.finish(entry)
            self.cp.takeover("stale")
            return None
        if _obs.TRACER.enabled:
            self._replaying[id(entry)] = time.perf_counter()
            # the takeover marker on the originating lane: tail-kept by
            # the span exporter regardless of sampling
            _obs.TRACER.instant("router.takeover", cat="router",
                                tid=trace_id,
                                args={"trace_id": trace_id,
                                      "proc": f"router:{self.router_id}",
                                      "session": session_id,
                                      "replayed": len(emitted)})
        writer.write(_http.sse_headers((
            ("X-Router-Replica", "takeover"),)))
        writer.write(_http.sse_event({
            "id": trace_id, "object": "text_completion.chunk",
            "model": self.model_name,
            "choices": [{"index": 0, "text": "",
                         "token_ids": list(emitted),
                         "finish_reason": None}]}))
        await writer.drain()
        self.journal.record(entry, emitted)
        try:
            if not entry.resumable:
                # adoption overflowed the journal bound: terminate with
                # the synthesized error, never a silent truncation
                writer.write(_http.sse_event(self._finish_chunk(
                    trace_id, "error")))
                writer.write(_http.sse_done())
                await writer.drain()
                self.cp.takeover("failed")
                return 200
            rem = entry.remaining()
            if rem is not None and rem <= 0:
                # the dead peer had already delivered the whole budget;
                # only its finish frame was lost
                writer.write(_http.sse_event(self._finish_chunk(
                    trace_id, "length")))
                writer.write(_http.sse_done())
                await writer.drain()
                self.cp.takeover("resumed")
                return 200
            code = await self._proxy_dispatch(
                trace_id, session_id, prompt, b"", candidates, writer,
                True, entry, sig, resuming=True, head_sent=[True])
            self.cp.takeover("resumed" if code == 200 else "failed")
            return code
        finally:
            self._replaying.pop(id(entry), None)
            self.journal.finish(entry)
            try:
                await self.cp.drop_journal(session_id)
            except Exception:
                pass

    def _resume_candidates(self, tried: List[str],
                           entry=None) -> List[ReplicaState]:
        """Fresh placement candidates for a replay: live, ready, not yet
        tried this request, and replay-exact — GREEDY, or a survivor
        advertising the IDENTICAL seeded POSITIONAL sampling config as the
        replica the entry was dispatched on: the positional key stream
        makes a sampled replay bit-exact there too."""
        origin = entry.sampling if entry is not None else None
        seeded = (isinstance(origin, dict) and origin.get("positional")
                  and origin.get("do_sample"))
        out = []
        for s in self._candidates():
            if s.id in tried:
                continue
            if s.greedy or (seeded and s.sampling == origin):
                out.append(s)
        return out

    def _handoff_successors(self, tried: List[str],
                            entry) -> List[ReplicaState]:
        """Replay-exact successors for a disaggregated handoff,
        decode replicas first, then by weighted load-minus-capacity
        (FLAGS_router_capacity_weight): a tp=4 decode replica
        legitimately outranks an equally loaded tp=1 one."""
        out = self._resume_candidates(tried, entry)
        out.sort(key=weighted_rank(_HANDOFF_RANK))
        return out

    async def _post_json(self, client: ReplicaClient, path: str,
                         doc: dict, timeout_s: float
                         ) -> Tuple[int, dict]:
        """One bounded JSON POST against a replica (migration plane)."""
        body = json.dumps(doc).encode()
        reader, close = await asyncio.wait_for(
            client.open("POST", path,
                        headers=(("Content-Type", "application/json"),),
                        body=body), timeout_s)
        try:
            status, _headers, rbody = await asyncio.wait_for(
                _read_response(reader), timeout_s)
        finally:
            close()
        try:
            out = json.loads(rbody.decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            out = {}
        return status, out if isinstance(out, dict) else {}

    async def _handoff_kv(self, src: ReplicaState, dst: ReplicaState,
                          entry) -> str:
        """Ship the prefill leg's finished prefix from ``src`` to
        ``dst`` over the migration plane: export the full
        pages under the journal's token history, import them as ready
        prefix-cache nodes (``resume: false`` — the ROUTER re-dispatches
        the stream itself; ``handoff: true`` so the replica counts
        ``serving.kv.handoff_*``).  Returns ``"ok"`` /
        ``"export_failed"`` / ``"import_failed"``.

        Trace propagation: the journal entry's
        trace id rides both migration bodies, so the export/import legs
        land as ``migrate.*`` spans on the ORIGINATING request's lane on
        both replicas — and the transfer itself is a ``router.handoff``
        span on the same lane — one merged fleet timeline per request
        instead of three disjoint ones."""
        t = self._handoff_timeout_s
        t0 = time.perf_counter()
        verdict = "ok"
        try:
            status, doc = await self._post_json(
                src.client, "/migratez/export",
                {"tokens": entry.full_tokens,
                 "trace_id": entry.trace_id}, t)
            sessions = doc.get("sessions") if status == 200 else None
        except Exception:
            sessions = None
        if not sessions:
            verdict = "export_failed"
        else:
            try:
                status, doc = await self._post_json(
                    dst.client, "/migratez/import",
                    {"sessions": sessions, "resume": False,
                     "handoff": True, "trace_id": entry.trace_id}, t)
            except Exception:
                status, doc = 0, {}
            # a 200 with zero installed sessions (geometry mismatch,
            # integrity rejection — per-snapshot isolation aborts inside
            # the bulk import) left the successor with NO prefix: treat
            # it as failed so the stream falls back instead of paying a
            # full re-prefill on a decode replica
            if status != 200 or int(doc.get("sessions") or 0) < 1:
                verdict = "import_failed"
        if _obs.TRACER.enabled:
            _obs.TRACER.event("router.handoff", t0,
                              time.perf_counter() - t0, cat="router",
                              tid=entry.trace_id,
                              args={"trace_id": entry.trace_id,
                                    "proc": f"router:{self.router_id}",
                                    "src": src.id, "dst": dst.id,
                                    "verdict": verdict})
        return verdict

    async def _breaker_gate(self) -> Optional[str]:
        """Park a post-death re-dispatch while the cascade breaker is
        open: replaying dead requests onto survivors is
        exactly how a cascade propagates.  Returns ``"go"`` (breaker
        closed/absent), ``"probe"`` (this re-dispatch claimed the
        half-open probe slot — its outcome decides the breaker), or
        ``None`` (parked past FLAGS_router_breaker_park_timeout_s:
        fall back to the synthesized-error contract)."""
        br = self.breaker
        if br is None or not br.enabled or br.state == "closed":
            return "go"
        self._parked += 1
        try:
            deadline = time.perf_counter() + self._park_timeout_s
            while True:
                state = br.state
                if state == "closed":
                    return "go"
                if state == "half_open" and br.claim_probe():
                    return "probe"
                if time.perf_counter() >= deadline:
                    return None
                await asyncio.sleep(0.02)
        finally:
            self._parked -= 1

    async def _proxy(self, trace_id, session_id, prompt, payload, body,
                     candidates: List[ReplicaState], writer,
                     stream: bool = False, sig=None) -> int:
        """Place and relay; re-place on connect-phase failure; RESUME on
        post-dispatch death.

        An unplanned upstream death mid-SSE used to synthesize a
        ``finish_reason: "error"`` termination; with the journal on, the
        router re-places the session on a greedy survivor, replays the
        prompt plus every token the client already received as a
        prefill (drain migration / the prefix cache make that a near
        no-op), and keeps relaying from the next token — the client
        sees one unbroken stream.  A unary request that dies after
        dispatch re-runs the same way (generation is side-effect-free
        and greedy replay is bit-exact) instead of 502ing; 502 remains
        only when replay is impossible — journal evicted/overflowed, an
        unparseable prompt, or a sampled session with no seedable
        replay."""
        entry = None
        if self._resume_on and prompt and isinstance(payload, dict):
            entry = self.journal.begin(trace_id, session_id, prompt,
                                       payload)
        try:
            return await self._proxy_dispatch(trace_id, session_id,
                                              prompt, body, candidates,
                                              writer, stream, entry, sig)
        finally:
            # unconditional: a client disconnect (ConnectionResetError
            # raising out of a relay write) must not strand the entry
            # in the journal until LRU pressure pushes it out
            self.journal.finish(entry)
            # the store mirror is only for this router's death: a request
            # it finished (however it finished) must leave no record for
            # the session's next owner to misread
            if (self.cp is not None and entry is not None
                    and entry.session_id is not None):
                try:
                    await self.cp.drop_journal(entry.session_id)
                except Exception:
                    pass

    async def _proxy_dispatch(self, trace_id, session_id, prompt, body,
                              candidates: List[ReplicaState], writer,
                              stream, entry, sig=None,
                              resuming: bool = False,
                              head_sent: Optional[list] = None) -> int:
        # ``resuming=True`` with a pre-set ``head_sent`` is the cross-router
        # takeover's entry: the adopted journal replays from the first
        # dispatch and the client's head is already out
        tried: List[str] = []
        if head_sent is None:
            head_sent = [False]       # flipped by _relay at the SSE head
        resuming = bool(resuming)     # a replay body is in flight
        unary_replayed = False
        died_post_dispatch = False    # a death a replay COULD recover
        quarantined_out = False       # this signature struck out (15)
        probe = False                 # this dispatch IS the half-open probe
        # disaggregated prefill/decode: an eligible
        # new stream dispatches to the prefill fleet with a 1-token cap;
        # the decode leg continues on a successor after the KV handoff.
        # Eligible = streaming + journaled (the journal carries the
        # splice) + a declared budget of >= 2 tokens + prefill
        # candidates AND at least one non-prefill successor.  A session
        # pinned to a live candidate stays conversational — affinity
        # (and the prefix it implies) beats phase specialization.
        all_cands = list(candidates)
        handoff_on = (self._handoff_on and stream and entry is not None
                      and entry.resumable and not resuming
                      and entry.max_tokens is not None
                      and entry.max_tokens >= 2)
        if handoff_on:
            pin = self.placer.pinned(session_id)
            if pin is not None and any(s.id == pin for s in candidates):
                handoff_on = False
            else:
                pref = [s for s in candidates if s.role == "prefill"]
                if pref and len(pref) < len(candidates):
                    candidates = pref
                else:
                    handoff_on = False
        via_handoff = False           # a decode leg ran after a handoff
        forced: Optional[ReplicaState] = None
        max_attempts = 2 * max(1, len(self.states)) + 2
        for _attempt in range(max_attempts):
            if not candidates:
                if handoff_on and not head_sent[0]:
                    # the prefill arm exhausted before anything reached
                    # the client: fall back to the unrestricted set —
                    # disaggregation is an optimization, not a contract
                    handoff_on = False
                    candidates = [s for s in all_cands
                                  if s.id not in tried]
                    if candidates:
                        continue
                break
            if sig is not None and self.quarantine.quarantined(sig):
                # struck out (possibly by a concurrent flight of the
                # same signature): no more corpses
                quarantined_out = True
                break
            if forced is not None:
                # the handoff already chose (and pre-staged KV on) the
                # successor — placement scoring is moot
                state, reason = forced, "handoff"
                forced = None
            else:
                place_prompt = entry.full_tokens if resuming else prompt
                state, reason = self.placer.place(place_prompt,
                                                  session_id, candidates)
            tried.append(state.id)
            up = (("X-Trace-Id", trace_id),
                  ("X-Router-Reason", reason))
            armed = (handoff_on and not resuming
                     and state.role == "prefill")
            if armed:
                body_now = entry.capped_body(1)
            else:
                body_now = entry.resume_body() if resuming else body
            try:
                up_reader, close = await state.client.open(
                    "POST", "/v1/completions", headers=up, body=body_now)
            except Exception:
                # connect-phase death: this replica is out of the
                # candidate set NOW; the request re-places on the rest
                # (no strike — the replica was ALREADY dead; nothing
                # was dispatched, so this death is not attributable)
                state.mark_failed()
                state.failovers += 1
                self._m.failover("connect").inc()
                self._export_replica_gauges()
                candidates = [s for s in candidates
                              if s.id not in tried]
                continue
            if entry is not None and entry.sampling is None:
                # resume-eligibility evidence: the
                # sampling config this entry's tokens were produced under
                entry.sampling = state.sampling
            state.inflight += 1
            flight_tokens = [False]   # this flight relayed >= 1 token
            try:
                outcome, status = await self._relay(
                    state, up_reader, trace_id, writer, stream,
                    entry=entry, head_sent=head_sent, sig=sig,
                    flight_tokens=flight_tokens, handoff=armed)
            finally:
                state.inflight -= 1
                close()
            if outcome == "handoff":
                # the prefill leg delivered its capped token(s): ship
                # the finished prefix to a decode successor over the
                # migration plane and splice the decode leg
                # into the same client stream via the replay journal
                succ = self._handoff_successors(tried, entry)
                target = succ[0] if succ else None
                verdict = "no_successor" if target is None else \
                    await self._handoff_kv(state, target, entry)
                self._m.handoff(verdict).inc()
                if verdict == "ok":
                    via_handoff = True
                    if session_id is not None:
                        # the session's KV now lives on the decode
                        # replica: follow-up turns belong there
                        self.placer.pin(session_id, target.id)
                    forced = target
                    candidates = succ
                else:
                    # never a dropped stream: re-prefill on a survivor,
                    # mixed first; a refused import target goes to the
                    # back of the line, and the (healthy) source
                    # replica rejoins last — it still holds the prefix
                    # when nothing else does
                    tried = [t for t in tried if t != state.id]
                    fb = [s for s in
                          self._resume_candidates(tried, entry)
                          if target is None or s.id != target.id]
                    fb.sort(key=weighted_rank(_FALLBACK_RANK))
                    if target is not None:
                        fb.append(target)
                    if not fb:
                        break
                    forced = fb[0]
                    candidates = fb
                resuming = True
                entry.resumes += 1
                continue
            if outcome == "done":
                if probe and self.breaker is not None:
                    # the probe replica ANSWERED: 200 closes the
                    # breaker; a non-200 completion (shed, queue
                    # expiry) is neither death nor health evidence —
                    # hand the slot back so the next parked resume can
                    # probe instead of wedging HALF_OPEN forever
                    if status == 200:
                        self.breaker.probe_result(True)
                    else:
                        self.breaker.release_probe()
                    probe = False
                if status == 200:
                    if sig is not None:
                        # a completed pass is progress too (a unary
                        # relay only shows its tokens here)
                        self.quarantine.progress(sig)
                    if resuming:
                        self._m.resumes("handoff" if via_handoff
                                        else "resumed").inc()
                    elif unary_replayed:
                        self._m.resumes("unary").inc()
                return status
            if outcome == "resume_reject":
                # a healthy replica refused the replay (shed/400) after
                # the client's head was already out: try the next one
                candidates = [s for s in candidates if s.id not in tried]
                continue
            # the upstream died post-dispatch ("dead_prehead": nothing
            # reached the client; "dead_stream": mid-SSE, head is out)
            self._export_replica_gauges()
            if probe and self.breaker is not None:
                # the half-open probe died: the breaker re-opens
                self.breaker.probe_result(False)
                probe = False
            if sig is not None and not flight_tokens[0] and \
                    self.quarantine.strike(sig):
                # crash attribution: a death strikes only the
                # requests whose CURRENT flight relayed zero tokens —
                # the death happened at/near their dispatch, which is
                # the poison shape; a request that was mid-stream when
                # its replica died is a victim, not a suspect.  This
                # signature has now struck out (poison_strikes
                # dispatch-proximate deaths, no progress between) —
                # replay is refused, not amplified.
                quarantined_out = True
                break
            if outcome == "dead_prehead" and stream and not head_sent[0]:
                # stream died before its head: nothing was sent — a
                # plain transparent re-place, no replay needed (but the
                # cascade breaker gates it the same way: a post-death
                # re-dispatch is a post-death re-dispatch)
                gate = await self._breaker_gate()
                if gate is None:
                    break
                probe = gate == "probe"
                candidates = [s for s in candidates if s.id not in tried]
                continue
            # post-dispatch death with client-visible state (mid-SSE) or
            # a consumed unary dispatch: only a journal replay recovers
            died_post_dispatch = True
            if entry is None or not entry.resumable:
                break
            if stream:
                rem = entry.remaining()
                if rem is None:
                    break             # undeclared budget: cannot bound
                if rem <= 0:
                    # every budgeted token was already delivered — only
                    # the finish frame was lost: close the stream out.
                    # (Known approximation: if the final budgeted token
                    # was ALSO the EOS, the no-fault finish would say
                    # "stop"; the router cannot know the eos id, so
                    # budget exhaustion reports "length".)
                    writer.write(_http.sse_event(self._finish_chunk(
                        trace_id, "length")))
                    writer.write(_http.sse_done())
                    await writer.drain()
                    self._m.resumes("finished").inc()
                    return status if head_sent[0] else 200
            # cascade breaker: while the fleet is dying, the
            # journal entry PARKS instead of replaying — the client's
            # stream holds; a half-open breaker releases one parked
            # resume as its probe
            gate = await self._breaker_gate()
            if gate is None:
                break                 # parked out: synthesized-error contract below
            probe = gate == "probe"
            resume_cands = self._resume_candidates(tried, entry)
            if not resume_cands:
                break
            candidates = resume_cands
            if stream:
                resuming = True
            else:
                unary_replayed = True   # full re-run of the original body
            entry.resumes += 1
        if probe and self.breaker is not None:
            # we claimed the half-open probe but never completed a
            # replay (candidates ran out / request turned ineligible):
            # hand the slot back — an unreported probe must not wedge
            # the breaker half-open forever
            self.breaker.release_probe()
        # quarantined: refuse cleanly — 503 with a
        # `quarantined` body when nothing reached the client yet; an
        # open stream can only be terminated the synthesized-error way below
        if quarantined_out and not head_sent[0]:
            ra = jittered_retry_after(self.quarantine.refuse(sig))
            writer.write(_http.error_response(
                503, "request quarantined: this prompt+sampling "
                     "signature keeps killing replicas "
                     "(see /statusz quarantine)",
                err_type="quarantined",
                extra_headers=(("Retry-After", str(ra)),),
                fields={"quarantined": True, "retry_after_s": ra}))
            await writer.drain()
            return 503
        if quarantined_out:
            self.quarantine.refuse(sig)
        # out of candidates (or replay-ineligible): end the request the
        # synthesized-error way — synthesized error for an open stream, 502 otherwise
        if head_sent[0]:
            if self._resume_on:
                self._m.resumes(
                    "exhausted" if resuming else "ineligible").inc()
            writer.write(_http.sse_event(self._finish_chunk(
                trace_id, "error")))
            writer.write(_http.sse_done())
            await writer.drain()
            return 200
        if self._resume_on and died_post_dispatch:
            self._m.resumes(
                "exhausted" if unary_replayed else "ineligible").inc()
        writer.write(_http.error_response(
            502, f"every candidate replica failed "
                 f"(tried {tried}; the request was not resumable)",
            err_type="internal_error"))
        await writer.drain()
        return 502

    def _finish_chunk(self, trace_id, finish_reason: str) -> dict:
        return {"id": trace_id, "object": "text_completion.chunk",
                "model": self.model_name,
                "choices": [{"index": 0, "text": "", "token_ids": [],
                             "finish_reason": finish_reason}]}

    @staticmethod
    def _frame_data(frame: bytes):
        """The payload of one SSE frame's ``data:`` line (None when the
        frame has no data line)."""
        for ln in frame.splitlines():
            if ln.startswith(b"data:"):
                return ln[5:].strip()
        return None

    async def _relay(self, state: ReplicaState, up, trace_id,
                     writer, stream: bool = False, entry=None,
                     head_sent=None, sig=None,
                     flight_tokens=None,
                     handoff: bool = False) -> Tuple[str, int]:
        """Forward one upstream response; returns ``(outcome, status)``.

        ``("done", status)`` — fully relayed.  ``("dead_prehead", 0)`` —
        upstream died before anything reached the client (re-place or
        replay; the dispatch may have run).  ``("dead_stream", status)``
        — died mid-SSE with the head out (resume or synthesize).
        ``("resume_reject", status)`` — a replay got a non-SSE answer
        after the head was out (healthy refusal: try another survivor).
        ``("handoff", status)`` — the capped prefill leg finished
        (``handoff=True`` and the upstream reported ``length``): the
        finish frame is suppressed and the dispatch loop splices a
        decode leg into the same stream.

        SSE relays whole frames: lines buffer until the blank-line
        terminator and a frame is written (and its token ids journaled)
        only when complete, so a death mid-frame never leaks a partial
        event to the client — what the client holds is exactly what the
        journal replays."""
        head_sent = head_sent if head_sent is not None else [False]
        try:
            # a replica writes a STREAM head immediately at admission, so
            # a head slower than the poll timeout is the same wedge signal
            # a failed health poll reports — don't hang the client on a
            # replica that accepts connects but never answers.  A UNARY
            # head arrives only when generation completes: legitimately
            # unbounded, never timed.
            if stream and self.poll_timeout_s > 0:
                status, headers, head_raw = await asyncio.wait_for(
                    _read_head(up), self.poll_timeout_s)
            else:
                status, headers, head_raw = await _read_head(up)
        except (Exception, asyncio.IncompleteReadError):
            # died before the head: nothing new reached the client
            state.mark_failed()
            state.failovers += 1
            self._m.failover("stream").inc()
            return "dead_prehead", 0
        ctype = headers.get("content-type", "")
        if ctype.startswith("text/event-stream"):
            if not head_sent[0]:
                # re-emit the head with the serving replica stamped on
                # it; on a RESUMED stream the client's head is already
                # out and the new upstream's head is dropped
                writer.write(_head_with(head_raw, (
                    ("X-Router-Replica", state.id),)))
                await writer.drain()
                head_sent[0] = True
            frame = bytearray()
            done_seen = False
            died = False
            progressed = False        # first relayed token absolves (15)
            while True:
                line = await up.readline()
                if not line:          # close-delimited: EOF ends the body
                    # an incomplete trailing frame is DISCARDED (never
                    # reached the client, never journaled) — the stream
                    # state stays consistent for the replay
                    died = not done_seen
                    break
                frame.extend(line)
                if line not in (b"\n", b"\r\n"):
                    continue
                # one complete frame
                data = self._frame_data(bytes(frame))
                if data == b"[DONE]":
                    done_seen = True
                    writer.write(bytes(frame))
                    await writer.drain()
                    frame.clear()
                    continue
                finish = None
                toks = ()
                journaling = entry is not None and entry.resumable
                if data is not None and \
                        (journaling or handoff
                         or (sig is not None and not progressed)):
                    try:
                        choice = json.loads(data)["choices"][0]
                        finish = choice.get("finish_reason")
                        toks = choice.get("token_ids") or ()
                    except (ValueError, KeyError, IndexError, TypeError):
                        pass
                if finish in ("error", "server_shutdown") and \
                        self._resume_on and journaling:
                    # the replica's own crash/shutdown retire path: the
                    # transport survived but the session died — suppress
                    # the error frame and resume instead of relaying it
                    died = True
                    break
                if handoff and finish == "length":
                    # the capped prefill leg is complete:
                    # journal any tokens riding the finish frame but
                    # suppress the frame itself — the client's stream
                    # continues on the decode leg, whose own finish
                    # frame closes it out bit-identically
                    if toks:
                        if journaling:
                            self.journal.record(entry, toks)
                            await self._cp_publish(entry)
                        if flight_tokens is not None:
                            flight_tokens[0] = True
                        if not progressed and sig is not None:
                            self.quarantine.progress(sig)
                    return "handoff", status
                if toks:
                    if journaling:
                        self.journal.record(entry, toks)
                        await self._cp_publish(entry)
                    if flight_tokens is not None:
                        flight_tokens[0] = True
                    if not progressed and sig is not None:
                        # quarantine absolution: this replica
                        # did real work for this signature — an innocent
                        # co-flier of repeated crashes streams tokens
                        # between the deaths and never strikes out
                        self.quarantine.progress(sig)
                        progressed = True
                writer.write(bytes(frame))
                await writer.drain()
                frame.clear()
            if died:
                state.mark_failed()
                state.failovers += 1
                self._m.failover("stream").inc()
                return "dead_stream", status
            return "done", status
        # non-SSE: unary completion or an error document, bounded body
        try:
            n = int(headers.get("content-length", "0"))
            body = await up.readexactly(n) if n else b""
        except (Exception, asyncio.IncompleteReadError):
            state.mark_failed()
            state.failovers += 1
            self._m.failover("stream").inc()
            # the client has this response's bytes not at all (unary
            # head+body are written together below): replayable
            return "dead_prehead", 0
        if head_sent[0]:
            # a replay answered with a non-SSE document into an open
            # event stream — a healthy refusal (shed, 400), not a death
            return "resume_reject", status
        writer.write(_head_with(head_raw, (
            ("X-Router-Replica", state.id),)) + body)
        await writer.drain()
        return "done", status

    # ------------------------------------------------------------ status --
    def statusz(self) -> dict:
        return {
            "uptime_s": round(time.perf_counter() - self._t0, 3),
            "model": self.model_name,
            "role": "router",
            "policy": self.placer.policy,
            "weights": {"hit": self.placer.hit_weight,
                        "load": self.placer.load_weight},
            "health": {"interval_s": self.health_interval_s,
                       "dead_after": self.dead_after,
                       "poll_timeout_s": self.poll_timeout_s,
                       "background": self._health_loop_obj is not None},
            "replicas": [s.describe(self.dead_after)
                         for s in self.states],
            # fleet-wide sentinel view: per-replica anomaly
            # totals from the last polls plus a merged recent tail, each
            # record tagged with the replica that reported it
            "anomalies": self._fleet_anomalies(),
            "sessions": self.placer.session_state(),
            # failover-resume plane
            "resume": {
                "enabled": self._resume_on,
                "journal_entries": len(self.journal),
                "journal_cap": self.journal.cap,
                "outcomes": {o: int(_obs.metrics.counter(
                    "router.resumes", outcome=o).value)
                    for o in ("resumed", "unary", "handoff", "finished",
                              "ineligible", "exhausted")},
            },
            # disaggregated prefill/decode handoff plane
            "handoff": {
                "enabled": self._handoff_on,
                "timeout_s": self._handoff_timeout_s,
                "outcomes": {o: int(_obs.metrics.counter(
                    "router.handoff", outcome=o).value)
                    for o in ("ok", "export_failed", "import_failed",
                              "no_successor")},
            },
            # multi-router control plane: ring membership and forwarding
            # counters (None on a single router)
            "controlplane": self._controlplane_state(),
            # live size + cap of every per-session/per-signature table,
            # so "is the router's memory bounded?" is one statusz read
            "tables": self._tables_state(),
            # poison quarantine + cascade breaker
            "quarantine": self.quarantine.state(),
            "breaker": (self.breaker.state_dict()
                        if self.breaker is not None else None),
            "parked_resumes": self._parked,
            "failover": {
                "connect": int(_obs.metrics.counter(
                    "router.failover", phase="connect").value),
                "stream": int(_obs.metrics.counter(
                    "router.failover", phase="stream").value)},
            "shed_total": int(self._m.shed.value),
            "pid": os.getpid(),
        }

    def _controlplane_state(self) -> Optional[dict]:
        if self.cp is None:
            return None
        m = _obs.metrics
        return {**self.cp.describe(),
                "forwarded": {o: int(m.counter(
                    "router.forwarded", outcome=o).value)
                    for o in ("out", "received", "fallback")},
                "ring_moves": int(m.counter("router.ring_moves").value),
                "takeovers": {o: int(m.counter(
                    "controlplane.takeovers", outcome=o).value)
                    for o in ("resumed", "stale", "failed")}}

    def _tables_state(self) -> dict:
        sess = self.placer.session_state()
        return {
            "session_pins": {"size": sess["pins"], "cap": sess["cap"]},
            "journal": {"size": len(self.journal),
                        "cap": self.journal.cap},
            "routed_overlay": {
                "size": sum(len(s.routed) for s in self.states),
                # the overlay cap is per-replica (placement.py applies
                # it to each state's LRU), so the fleet bound scales
                # with the replica count
                "cap": int(flags.flag("router_overlay_cap"))
                * max(1, len(self.states))},
            "quarantine": {"size": len(self.quarantine),
                           "cap": self.quarantine.cap},
            # parked resumes are TIME-bounded, not count-capped: every
            # parked entry leaves within router_breaker_park_timeout_s
            "breaker_park": {"size": self._parked, "cap": None,
                             "bound_s": self._park_timeout_s},
        }

    def _fleet_anomalies(self) -> dict:
        recent = []
        for s in self.states:
            for rec in s.anomalies_recent:
                if isinstance(rec, dict):
                    recent.append({**rec, "replica": s.id})
        recent.sort(key=lambda r: r.get("t") or 0.0)
        return {"total": sum(s.anomaly_total for s in self.states),
                "by_replica": {s.id: s.anomaly_total
                               for s in self.states},
                "recent": recent[-32:]}

    # --------------------------------------------------------- lifecycle --
    async def start_http(self, host: str = "127.0.0.1", port: int = 0):
        """Bind a listener and start background health polling (and the
        control-plane heartbeat loop when a plane is attached)."""
        self.start_health()
        if self.cp is not None:
            await self.cp_tick()        # join membership before serving
            self._cp_task = asyncio.ensure_future(self._cp_loop())
        await self.poll_replicas()      # first view before first request
        self._asyncio_server = await asyncio.start_server(
            self.handle, host, port)
        return self._asyncio_server.sockets[0].getsockname()[:2]

    async def stop_http(self) -> None:
        self.stop_health()
        if self._cp_task is not None:
            self._cp_task.cancel()
            self._cp_task = None
        if self._asyncio_server is not None:
            self._asyncio_server.close()
            await self._asyncio_server.wait_closed()
            self._asyncio_server = None


# ---------------------------------------------------------------------------
# upstream response parsing helpers
# ---------------------------------------------------------------------------

async def _read_head(reader) -> Tuple[int, Dict[str, str], bytes]:
    """Status + headers + the raw head bytes (terminator included)."""
    raw = bytearray()
    while True:
        line = await reader.readline()
        if not line:
            raise ConnectionError("upstream EOF before response head")
        raw.extend(line)
        if line in (b"\r\n", b"\n"):
            break
        if len(raw) > _http.MAX_LINE * 4:
            raise ConnectionError("upstream head too large")
    text = bytes(raw).decode("latin-1")
    lines = [ln for ln in text.split("\r\n") if ln]
    parts = lines[0].split()
    status = int(parts[1])
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers, bytes(raw)


async def _read_response(reader) -> Tuple[int, Dict[str, str], bytes]:
    """Whole bounded response (poll path — never SSE)."""
    status, headers, _ = await _read_head(reader)
    n = int(headers.get("content-length", "0"))
    body = await reader.readexactly(n) if n else await reader.read()
    return status, headers, body


def _head_with(head_raw: bytes,
               extra: Tuple[Tuple[str, str], ...]) -> bytes:
    """Insert headers just before the head terminator."""
    ins = "".join(f"{k}: {v}\r\n" for k, v in extra).encode("latin-1")
    if head_raw.endswith(b"\r\n\r\n"):
        return head_raw[:-2] + ins + b"\r\n"
    return head_raw + ins      # defensive; replica heads are CRLF-framed


# ---------------------------------------------------------------------------
# production entry
# ---------------------------------------------------------------------------

async def _route_async(router: RouterServer, host: str, port: int):
    bound = await router.start_http(host, port)
    print(f"[paddle_tpu_torch router] listening on http://{bound[0]}:{bound[1]}"
          f"  ({len(router.states)} replicas, "
          f"policy={router.placer.policy})", flush=True)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        await router.stop_http()


def route_forever(replicas: List[ReplicaClient], *,
                  host: str = "127.0.0.1", port: int = 8080,
                  **kw) -> None:
    """Blocking convenience entry: build the router and serve until
    killed (``python -m paddle_tpu_torch.router`` wraps this)."""
    router = RouterServer(replicas, **kw)
    # fleet tracing: a spawned router ships its spans to the supervisor's
    # collector, over the control-plane store when it joined one (the fleet
    # launcher's tick drains ``trace/batch/*``), else by HTTP POST to
    # FLAGS_trace_collector
    exporter = None
    if float(flags.flag("trace_sample_rate")) > 0:
        from ..observability.collector import (HttpTransport,
                                               SpanExporter,
                                               StoreTransport)
        plane = kw.get("controlplane")
        sc = getattr(plane, "store", None)
        transport = None
        if sc is not None and hasattr(sc, "host"):
            from ..controlplane import SyncStoreClient
            transport = StoreTransport(
                SyncStoreClient(sc.host, sc.port))
        elif str(flags.flag("trace_collector")):
            transport = HttpTransport(str(flags.flag("trace_collector")))
        if transport is not None:
            rid = getattr(plane, "rid", None) or "router"
            exporter = SpanExporter(transport,
                                    proc=f"{rid}@{host}:{port}",
                                    role="router")
            exporter.start()
    try:
        asyncio.run(_route_async(router, host, port))
    except KeyboardInterrupt:
        pass
    finally:
        if exporter is not None:
            exporter.close()
