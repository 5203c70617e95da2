"""The port's multi-router control plane against the JAX package's, on the
CPU.

Host parity: the same operation script under a fake clock goes through both
packages' ``StoreState`` (results, versions, TTL expiry, LRU evictions, the
store's counters), ``HashRing`` (owners of 10 000 keys over several member
sets) and ``RouterControlPlane`` (membership failover, the ``cp/ring``
epoch, journal TTL); the logs must be equal.  The wire: the port's
``StoreClient`` / ``SyncStoreClient`` against the reference's
``StoreServer`` and the reference's clients against the port's, on
localhost sockets.  End to end: two routers over one ``LocalStore`` and one
tiny-Llama replica, the same script through both packages (weights through
``load_reference_state``): a one-hop forward to the session's owner, the
forwarded-header loop guard, the fallback when the owner is unreachable, a
takeover of a stream whose owner died mid-stream, stale and mismatched
journal records; tokens, headers, counters and ``/statusz``'s
``controlplane`` section must be the reference's.  Then the supervisor's
router slots (a killed slot restarts), its replica-endpoint publication,
store discovery, and the launchers' options.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from paddle_tpu import controlplane as jcp
from paddle_tpu import observability as jobs
from paddle_tpu.fleet import FleetSupervisor as JFleetSupervisor
from paddle_tpu.fleet.chaos import ChaosController as JChaosController
from paddle_tpu.fleet.chaos import ChaosPlan as JChaosPlan
from paddle_tpu.fleet.chaos import FaultEvent as JFaultEvent
from paddle_tpu.router import InprocReplica as JInprocReplica
from paddle_tpu.router import RouterServer as JRouterServer
from paddle_tpu.serving import ServingServer as JServingServer
from paddle_tpu_torch import controlplane as cp
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fleet import FleetSupervisor
from paddle_tpu_torch.fleet.chaos import ChaosController, ChaosPlan, FaultEvent
from paddle_tpu_torch.router import InprocReplica, RouterServer
from paddle_tpu_torch.serving import ServingServer

from test_serving_http import (MemWriter, completion_body, split_response,
                               sse_chunks)
from test_torch_router import (Clock, engine, jengine,  # noqa: F401
                               oracle_tokens, pair)

torch.set_num_threads(2)

PROMPT = [1, 2, 3, 4, 5]
NEW_TOKENS = 12


def _reset(prefixes=("router.", "controlplane.", "fleet.")):
    for p in prefixes:
        obs.reset(p)
        jobs.reset(p)


# ---------------------------------------------------------------------------
# store, ring, plane: one script through both packages
# ---------------------------------------------------------------------------

def _store_log(mod, registry):
    clock = Clock()
    s = mod.StoreState(max_keys=4, clock=clock)
    log = [s.get("k"), s.set("k", {"a": 1}), s.set("k", {"a": 2}, ttl=3.0),
           s.get("k"), s.cas("fresh", None, "v1"), s.cas("fresh", None, "v2"),
           s.cas("fresh", "v1", "v2"), s.delete("fresh"), s.delete("fresh"),
           s.get("fresh")]
    s.heartbeat("router/a", {"host": "h"}, ttl=5.0)
    s.heartbeat("router/b", {"host": "h"}, ttl=5.0)
    log += [sorted(s.members("router/")), len(s)]
    clock.t = 3.5                       # k's TTL is over
    log += [s.get("k"), len(s)]
    s.heartbeat("router/a", {"host": "h"}, ttl=5.0)
    clock.t = 6.0                       # b stopped beating
    log += [s.members("router/"), s.get("router/b")]
    for i in range(8):                  # past max_keys: LRU evictions
        log.append(s.set(f"e{i}", i, ttl=None if i % 2 else 100.0))
    log += [s.dump(), len(s), s.cas("e7", 7, 70), s.get("e7")]
    clock.t = 200.0
    log += [s.members(""), s.get("__now__")[0]]
    m = registry.metrics
    log.append({op: m.counter("controlplane.store_ops", op=op).value
                for op in ("set", "get", "cas", "del", "hb", "members")})
    log += [m.counter("controlplane.store_evictions").value,
            m.gauge("controlplane.store_keys").value]
    return log


def test_store_ops_match_the_reference():
    _reset(("controlplane.",))
    assert _store_log(cp, obs) == _store_log(jcp, jobs)


def test_local_store_wait():
    async def main():
        store = cp.LocalStore()
        missing = await store.wait("missing", timeout=0.05)

        async def setter():
            await asyncio.sleep(0.02)
            await store.set("soon", 42)

        t = asyncio.ensure_future(setter())
        got = await store.wait("soon", timeout=2.0)
        await t
        return missing, got

    assert asyncio.run(main()) == ((False, None), (True, 42))


class _ServedStore:
    """A ``StoreServer`` on a localhost socket, on its own thread and
    event loop."""

    def __init__(self, server):
        self.server = server
        self.loop = asyncio.new_event_loop()
        self.port = None
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.port = self.loop.run_until_complete(
                server.start("127.0.0.1", 0))
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert ready.wait(10)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.server.stop(),
                                         self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _client_log(async_cls, sync_cls, port):
    async def main():
        c = async_cls("127.0.0.1", port)
        log = [await c.set("k", {"x": 1}), await c.get("k"),
               await c.cas("k", {"x": 1}, {"x": 2}),
               await c.cas("k", {"x": 1}, {"x": 3})]
        await c.heartbeat("router/a", {"port": 1}, ttl=30.0)
        log += [await c.members("router/"), await c.wait("k", timeout=1.0),
                await c.wait("nope", timeout=0.05)]

        def sync_side():
            sc = sync_cls("127.0.0.1", port)
            try:
                out = [sc.get("k"), sc.set("replica/r0",
                                           {"host": "h", "port": 9}),
                       sc.members("replica/"), sc.delete("replica/r0"),
                       sc.delete("replica/r0"), sc.get("__now__")[0],
                       sc.set("trace/batch/p/0", {"events": ["e" * 200_000]},
                              ttl=120.0)]
            finally:
                sc.close()
            return out

        log += await asyncio.get_running_loop().run_in_executor(
            None, sync_side)
        log += [await c.get("replica/r0"), await c.delete("k")]
        await c.close()
        return log

    return asyncio.run(main())


def test_store_clients_talk_to_the_other_packages_server():
    """Each package's async and blocking clients against the other
    package's ``StoreServer``: the same results, line for line, as against
    their own.  A span batch of 200 KB is one request line: the port's
    server reads lines up to 1 MiB (asyncio's default reader limit of
    64 KiB would refuse it), so it goes to the port's server only."""
    servers = {"port": cp.StoreServer, "ref": jcp.StoreServer}
    logs = {}
    for srv in ("port", "ref"):
        for cli, mod in (("port", cp), ("ref", jcp)):
            sync_cls = mod.SyncStoreClient
            if srv == "ref":
                def small(self, key, value, ttl=None,
                          _set=mod.SyncStoreClient.set):
                    if key.startswith("trace/"):
                        value = {"events": ["e" * 2000]}
                    return _set(self, key, value, ttl)

                sync_cls = type("Small", (mod.SyncStoreClient,),
                                {"set": small})
            served = _ServedStore(servers[srv]())
            try:
                logs[srv, cli] = _client_log(mod.StoreClient, sync_cls,
                                             served.port)
            finally:
                served.close()
    assert logs["port", "port"] == logs["ref", "ref"] == \
        logs["port", "ref"] == logs["ref", "port"]
    # a line past 1 MiB is refused (counted) and answered with an error
    served = _ServedStore(cp.StoreServer())
    try:
        refused = obs.metrics.counter("controlplane.store_refused").value
        sc = cp.SyncStoreClient("127.0.0.1", served.port)
        with pytest.raises(KeyError):
            sc.set("big", "y" * (1 << 20))
        assert sc.get("big") == (False, None)
        sc.close()
        assert obs.metrics.counter(
            "controlplane.store_refused").value - refused == 1
    finally:
        served.close()


MEMBER_SETS = (["rt0"], ["rt0", "rt1"], ["rt0", "rt1", "rt2"],
               ["a", "b", "c", "d", "e"], ["router-x", "router-y"])


@pytest.mark.parametrize("members", MEMBER_SETS)
def test_ring_owners_match_the_reference(members):
    keys = [f"sess-{i}" for i in range(10_000)]
    for vnodes in (None, 8):
        ring, jring = cp.HashRing(members, vnodes), jcp.HashRing(members,
                                                                 vnodes)
        assert [ring.owner(k) for k in keys] == \
            [jring.owner(k) for k in keys]
        assert ring.spans() == jring.spans()
        assert sum(ring.spans().values()) == len(members) * ring.vnodes


def test_ring_removal_moves_only_the_dead_members_keys():
    before = cp.HashRing(["a", "b", "c"], vnodes=64)
    after = cp.HashRing(["a", "b"], vnodes=64)
    moved = 0
    for k in (f"sess-{i}" for i in range(10_000)):
        was, now = before.owner(k), after.owner(k)
        if was == "c":
            assert now in ("a", "b")
            moved += 1
        else:
            assert now == was
    assert 0 < moved < 10_000
    assert cp.HashRing(["solo"]).owner("anything") == "solo"
    assert cp.HashRing([]).owner("anything") is None


def _plane_log(mod, registry):
    clock = Clock()
    state = mod.StoreState(clock=clock)
    a = mod.RouterControlPlane("a", mod.LocalStore(state),
                               heartbeat_ttl_s=5.0, journal_ttl_s=10.0)
    b = mod.RouterControlPlane("b", mod.LocalStore(state),
                               heartbeat_ttl_s=5.0)
    log = []

    async def main():
        log.append(await a.tick())
        log.append(await b.tick())
        log.append(await a.tick())
        log.append((sorted(a.members), a.ring_epoch, b.ring_epoch))
        sids = [f"s-{i}" for i in range(200)]
        log.append([a.owner(s) for s in sids])
        clock.t = 6.0                   # b stops beating: a's span grows
        log.append(await a.tick())
        log.append((sorted(a.members), a.ring_epoch,
                    (await a.store.get("cp/ring"))[1], a.describe(),
                    [a.owner(s) for s in sids]))
        await a.publish_journal("s1", {"router": "a", "emitted": [1]})
        log.append(await a.take_journal("s1"))
        await a.drop_journal("s1")
        log.append(await a.take_journal("s1"))
        await a.publish_journal("s2", {"router": "a", "emitted": [2]})
        clock.t = 16.5                  # a dead router's record expires
        log.append(await a.take_journal("s2"))
        clock.t = 17.0
        log.append(await b.tick())      # b comes back
        log.append(await a.tick())
        log.append((sorted(a.members), a.ring_epoch, b.ring_epoch,
                    b.describe()))
        log.append(await a.replica_members())

    asyncio.run(main())
    m = registry.metrics
    log.append((m.counter("router.ring_moves").value,
                m.counter("controlplane.heartbeats").value,
                m.counter("controlplane.journal_replicated").value,
                m.gauge("controlplane.ring_epoch").value,
                m.gauge("controlplane.members").value))
    return log


def test_plane_failover_and_journal_ttl_match_the_reference():
    _reset(("router.", "controlplane."))
    assert _plane_log(cp, obs) == _plane_log(jcp, jobs)


# ---------------------------------------------------------------------------
# two routers over one LocalStore: the same script through both packages
# ---------------------------------------------------------------------------

class _DeadStore:
    """What a dead router reaches: nothing."""

    def __getattr__(self, name):
        async def dead(*a, **k):
            raise ConnectionResetError("router process is gone")
        return dead


class _DyingWriter(MemWriter):
    """A client connection whose router dies once ``after`` tokens went
    out: from then on its store face is gone (no heartbeat, no journal
    drop) and every write raises, as after a SIGKILL."""

    def __init__(self, plane, after):
        super().__init__()
        self.plane, self.after, self.seen = plane, after, 0

    def write(self, b):
        if self.seen >= self.after:
            raise ConnectionResetError("router killed")
        for c in sse_chunks(bytes(b).partition(b"\r\n\r\n")[2]
                            if b.startswith(b"HTTP/") else bytes(b)):
            self.seen += len(c["choices"][0].get("token_ids") or ())
        super().write(b)
        if self.seen >= self.after:
            self.plane.store = _DeadStore()


async def _send(router, body, headers=(), writer=None):
    head = ["POST /v1/completions HTTP/1.1", "Host: test"]
    head += [f"{k}: {v}" for k, v in headers]
    head.append(f"Content-Length: {len(body)}")
    r = asyncio.StreamReader()
    r.feed_data(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    r.feed_eof()
    w = writer if writer is not None else MemWriter()
    await router.handle(r, w)
    return w


def _tokens(status, headers, body):
    if headers.get("content-type", "").startswith("text/event-stream"):
        return [t for c in sse_chunks(body)
                for t in c["choices"][0].get("token_ids") or ()]
    return json.loads(body)["choices"][0]["token_ids"]


def _sharded(pkg, model, n_routers=2):
    """``n_routers`` routers, each with its own plane over one store and
    its own transport to the one replica; peers registered as in-process
    clients of the peer router."""
    state = pkg["StoreState"]()
    server = pkg["ServingServer"](pkg["engine"](model), slo=False,
                                  flight_recorder=False).start()
    planes, routers = [], []
    for i in range(n_routers):
        plane = pkg["RouterControlPlane"](f"rt{i}", pkg["LocalStore"](state))
        routers.append(pkg["RouterServer"](
            [pkg["InprocReplica"]("r0", server)], policy="scored",
            controlplane=plane, health_interval_s=1e9))
        planes.append(plane)
    for i, plane in enumerate(planes):
        for j, router in enumerate(routers):
            if i != j:
                plane.register_peer(f"rt{j}",
                                    pkg["InprocReplica"](f"rt{j}", router))
    return state, server, planes, routers


PORT = dict(StoreState=cp.StoreState, LocalStore=cp.LocalStore,
            RouterControlPlane=cp.RouterControlPlane,
            RouterServer=RouterServer, InprocReplica=InprocReplica,
            ServingServer=ServingServer, engine=engine, registry=obs)
REF = dict(StoreState=jcp.StoreState, LocalStore=jcp.LocalStore,
           RouterControlPlane=jcp.RouterControlPlane,
           RouterServer=JRouterServer, InprocReplica=JInprocReplica,
           ServingServer=JServingServer, engine=jengine, registry=jobs)


def _two_router_log(pkg, model):
    _reset(("router.", "controlplane."))
    state, server, planes, routers = _sharded(pkg, model)
    m = pkg["registry"].metrics
    log = []

    def counters():
        return ({o: m.counter("router.forwarded", outcome=o).value
                 for o in ("out", "received", "fallback")},
                {o: m.counter("controlplane.takeovers", outcome=o).value
                 for o in ("resumed", "stale", "failed")})

    def owned_by(rid, skip=()):
        return next(s for s in (f"sess-{n}" for n in range(10_000))
                    if planes[0].owner(s) == rid and s not in skip)

    def entry(name, w):
        status, headers, body = split_response(w.buf)
        log.append((name, status, headers.get("x-router-owner"),
                    headers.get("x-router-replica") == "takeover",
                    _tokens(status, headers, body), counters()))

    async def main():
        for _ in range(2):
            for r in routers:
                await r.cp_tick()
        log.append(("ring", planes[0].describe(), planes[1].describe()))
        sid = owned_by("rt1")
        # the wrong router forwards one hop; the owner pins the session
        entry("forward", await _send(
            routers[0], completion_body(PROMPT, NEW_TOKENS),
            (("X-Session-Id", sid),)))
        log.append(("pinned", sid in routers[1].placer._sessions,
                    sid in routers[0].placer._sessions))
        # a request that arrives forwarded is served where it lands
        entry("guard", await _send(
            routers[0], completion_body(PROMPT, NEW_TOKENS),
            (("X-Session-Id", sid), ("X-Router-Forwarded", "rt1"))))
        # the owner's transport is gone, its heartbeat not yet expired
        planes[0]._peers["rt1"].kill(close_server=False)
        entry("fallback", await _send(
            routers[0], completion_body(PROMPT, NEW_TOKENS),
            (("X-Session-Id", sid),)))
        # the owner dies mid-stream; the client reconnects to rt0, which
        # adopts the store-replicated journal and resumes the stream
        sid2 = owned_by("rt1", skip=(sid,))
        dying = await _send(
            routers[1], completion_body(PROMPT, NEW_TOKENS, stream=True),
            (("X-Session-Id", sid2),), _DyingWriter(planes[1], 3))
        head = [t for c in sse_chunks(split_response(dying.buf)[2])
                for t in c["choices"][0].get("token_ids") or ()]
        rec = (await planes[0].take_journal(sid2)) or {}
        log.append(("killed", head, rec.get("router"),
                    rec.get("emitted")))
        entry("takeover", await _send(
            routers[0], completion_body(PROMPT, NEW_TOKENS, stream=True),
            (("X-Session-Id", sid2),)))
        log.append(("consumed", await planes[0].take_journal(sid2)))
        # a different conversation's record under a session id, and this
        # router's own live record: neither is adopted
        await state_set("journal/sess-x", {
            "router": "rt-dead", "prompt": [9, 9, 9], "emitted": [1],
            "payload": {}, "max_tokens": 4})
        entry("mismatched", await _send(
            routers[0], completion_body(PROMPT, NEW_TOKENS, stream=True),
            (("X-Session-Id", "sess-x"),)))
        await state_set("journal/sess-y", {
            "router": "rt0", "prompt": list(PROMPT), "emitted": [1],
            "payload": {}, "max_tokens": NEW_TOKENS})
        entry("own", await _send(
            routers[0], completion_body(PROMPT, NEW_TOKENS, stream=True),
            (("X-Session-Id", "sess-y"),)))
        # streamed sessions replicate their journal; a finished request
        # leaves no record behind
        log.append(("replicated",
                    m.counter("controlplane.journal_replicated").value,
                    await planes[0].take_journal(sid)))

    async def state_set(key, value):
        state.set(key, value)

    try:
        asyncio.run(main())
        st = routers[0].statusz()
        log.append(("statusz", st["controlplane"], sorted(st["tables"])))
    finally:
        server.close()
    return log


@pytest.fixture(scope="module")
def ref_two_router_log(pair):
    return _two_router_log(REF, pair[0])


def test_two_routers_match_the_reference(pair, ref_two_router_log):
    """Forward, loop guard, fallback, takeover after the owner died
    mid-stream, stale and mismatched records: the port's tokens, headers,
    counters and ``/statusz`` ``controlplane`` equal the reference's, and
    every stream is the direct engine's greedy run."""
    log = _two_router_log(PORT, pair[1])
    assert log == ref_two_router_log
    want = oracle_tokens(pair[1], [PROMPT], NEW_TOKENS)[tuple(PROMPT)]
    by = {e[0]: e for e in log}
    for name in ("forward", "guard", "fallback", "takeover", "mismatched",
                 "own"):
        assert by[name][1] == 200 and by[name][4] == want, name
    assert by["forward"][2] == "rt1" and by["forward"][5][0]["out"] == 1
    assert by["guard"][5][0] == {"out": 1, "received": 2, "fallback": 0}
    assert by["fallback"][5][0]["fallback"] == 1
    assert by["takeover"][3] and by["takeover"][5][1]["resumed"] == 1
    # the record holds at least what reached the client before the death
    head, rec_emitted = by["killed"][1], by["killed"][3]
    assert len(head) >= 3 and rec_emitted[:len(head)] == head
    assert rec_emitted == want[:len(rec_emitted)]
    assert not by["mismatched"][3] and by["mismatched"][5][1]["stale"] == 1
    assert not by["own"][3] and by["own"][5][1]["stale"] == 2
    assert by["consumed"][1] is None
    assert by["replicated"][1] >= 1 and by["replicated"][2] is None
    st = by["statusz"][1]
    assert st["members"] == ["rt0", "rt1"] and st["takeovers"]["resumed"] == 1


# ---------------------------------------------------------------------------
# supervised router slots, store publication and discovery
# ---------------------------------------------------------------------------

def _router_slot_log(pkg):
    mods = pkg["mods"]
    clock = Clock()
    spawned = []

    def factory(rid):
        spawned.append(rid)
        return object()

    chaos = mods["ChaosController"](mods["ChaosPlan"](
        [mods["FaultEvent"](1, "router_kill", "rt1")]))
    router = mods["RouterServer"]([], allow_empty=True,
                                  health_interval_s=1e9)
    sup = mods["FleetSupervisor"](
        router, lambda rid: None, target=0, min_replicas=0,
        max_replicas=4,
        router_spawner=lambda rid: mods["InprocRouterHandle"](rid, factory),
        router_target=2, on_router_spawn=chaos.register_router,
        backoff_base_s=1.0, clock=clock)
    sup.start()
    log = [list(spawned), sup.tick(), sup.converged()]
    chaos.advance(1)
    log += [sup.tick(), sup.converged(),
            sup.breaker.state_dict()["deaths_in_window"]]
    clock.t = 2.0
    log += [sup.tick(), list(spawned), chaos._routers["rt1"].alive(),
            sup.tick(), sup.converged(), sup.state()["router_slots"]]
    m = pkg["registry"].metrics
    log += [m.counter("fleet.crashes", kind="router").value,
            m.counter("fleet.router_restarts").value,
            m.gauge("controlplane.routers").value]
    sup.shutdown(drain=False)
    log.append(sup.state()["router_slots"])
    return log


def test_supervisor_restarts_a_killed_router_slot_like_the_reference():
    """Router slots ride the replica state machine (backoff, budget,
    restart) and a router death never feeds the cascade breaker; the chaos
    grip follows each new generation."""
    _reset(("fleet.", "controlplane."))
    port = {"mods": dict(ChaosController=ChaosController,
                         ChaosPlan=ChaosPlan, FaultEvent=FaultEvent,
                         RouterServer=RouterServer,
                         FleetSupervisor=FleetSupervisor,
                         InprocRouterHandle=cp.InprocRouterHandle),
            "registry": obs}
    ref = {"mods": dict(ChaosController=JChaosController,
                        ChaosPlan=JChaosPlan, FaultEvent=JFaultEvent,
                        RouterServer=JRouterServer,
                        FleetSupervisor=JFleetSupervisor,
                        InprocRouterHandle=jcp.InprocRouterHandle),
           "registry": jobs}
    log = _router_slot_log(port)
    assert log == _router_slot_log(ref)
    assert ("router_restart", "rt1") in log[6] and log[7] == \
        ["rt1", "rt2", "rt1"]
    assert log[-4:-1] == [1, 1, 2]


class _EndpointHandle:
    """A replica with an advertised endpoint, driven by the tick."""

    def __init__(self, rid):
        self.id = rid
        self.host, self.port = "127.0.0.1", 9000 + int(rid[2:])
        self._alive = False

    def spawn(self):
        self._alive = True

    def alive(self):
        return self._alive

    def ready(self):
        return self._alive

    def client(self):
        from test_torch_router import FakeClient
        return FakeClient(self.id)

    def begin_drain(self):
        pass

    def drained(self):
        return True

    def stop(self, timeout_s=5.0):
        self._alive = False

    def kill(self):
        self._alive = False

    def describe(self):
        return {"kind": "endpoint"}


def _publication_log(mod, sup_cls, router_cls):
    state = mod.StoreState(clock=Clock())
    router = router_cls([], allow_empty=True, health_interval_s=1e9)
    sup = sup_cls(router, _EndpointHandle, target=2, min_replicas=1,
                  max_replicas=2, store=state, clock=Clock())
    sup.start()
    sup.tick()
    log = [state.members("replica/")]
    sup._slots[0].handle.kill()
    sup.tick()
    log.append(state.members("replica/"))
    sup.shutdown(drain=False)
    log.append(state.members("replica/"))
    return log


def test_supervisor_publishes_replica_endpoints_like_the_reference():
    """READY replicas advertise ``replica/<id>`` through the supervisor's
    sync store face; a death or a shutdown removes the key."""
    _reset(("fleet.",))
    log = _publication_log(cp, FleetSupervisor, RouterServer)
    assert log == _publication_log(jcp, JFleetSupervisor, JRouterServer)
    assert log[0] == {"replica/fs0": {"host": "127.0.0.1", "port": 9000},
                      "replica/fs1": {"host": "127.0.0.1", "port": 9001}}
    assert log[-1] == {}


def _discovery_log(mod, router_cls):
    state = mod.StoreState()
    plane = mod.RouterControlPlane("rt0", mod.LocalStore(state))
    router = router_cls([], allow_empty=True, health_interval_s=1e9,
                        controlplane=plane, discover_replicas=True)
    log = []

    async def main():
        state.set("replica/fs0", {"host": "127.0.0.1", "port": 9101})
        state.set("replica/fs1", {"host": "127.0.0.1", "port": 9102})
        await router.cp_tick()
        log.append([(s.id, s.client.describe()) for s in router.states])
        state.delete("replica/fs0")
        await router.cp_tick()
        log.append([s.id for s in router.states])

    asyncio.run(main())
    return log


def test_router_discovers_replicas_from_the_store_like_the_reference():
    log = _discovery_log(cp, RouterServer)
    assert log == _discovery_log(jcp, JRouterServer)
    assert log[-1] == ["fs1"]


def test_launchers_parse_the_control_plane_options_like_the_reference():
    from paddle_tpu.fleet.__main__ import build_parser as jfleet
    from paddle_tpu.router.__main__ import build_parser as jrouter
    from paddle_tpu_torch.fleet.__main__ import build_parser as fleet
    from paddle_tpu_torch.router.__main__ import build_parser as router
    for argv in ([], ["--routers", "3", "--router-port-base", "9500",
                      "--store-port", "7100"]):
        a, j = fleet().parse_args(argv), jfleet().parse_args(argv)
        assert (a.routers, a.router_port_base, a.store_port) == \
            (j.routers, j.router_port_base, j.store_port)
    argv = ["--store", "127.0.0.1:7000", "--router-id", "rt3"]
    a, j = router().parse_args(argv), jrouter().parse_args(argv)
    assert (a.store, a.router_id, a.replicas) == \
        (j.store, j.router_id, j.replicas) == ("127.0.0.1:7000", "rt3", [])


def test_process_router_handle_launches_the_ports_router(monkeypatch):
    from paddle_tpu_torch.controlplane import slots
    seen = []

    class Popen:
        pid = 4242

        def __init__(self, argv):
            seen.append(argv)

        def poll(self):
            return None

    monkeypatch.setattr(slots.subprocess, "Popen", Popen)
    h = cp.ProcessRouterHandle("rt2", "127.0.0.1", 8902,
                               store_host="127.0.0.1", store_port=7000,
                               launch_args=["--set", "x=1"])
    h.spawn()
    assert seen[0][1:3] == ["-m", "paddle_tpu_torch.router"]
    assert seen[0][3:] == ["--host", "127.0.0.1", "--port", "8902",
                           "--store", "127.0.0.1:7000", "--router-id",
                           "rt2", "--set", "x=1"]
    assert h.describe() == {"kind": "ProcessRouterHandle",
                            "target": "127.0.0.1:8902", "pid": 4242}


# ---------------------------------------------------------------------------
# slow tier: real processes, real sockets, real SIGKILL
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_process_router_fleet_sigkill_owner_resumes_on_survivor(tmp_path):
    """Over real sockets: a store server, two router processes joined to
    it, two CPU replica processes published through it.  SIGKILL the
    router that owns a mid-stream session; the resubmitted request on the
    survivor resumes it, and its stream is a no-fault run's; the ring
    record shows the span moved."""
    import http.client

    from paddle_tpu_torch.fleet import ProcessReplicaHandle
    n_tokens = 48
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    rep_ports = [_free_port(), _free_port()]
    rep_procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving", "--device", "cpu",
         "--port", str(p), "--max-batch", "2", "--max-seq-len", "256",
         "--page-size", "8", "--prefill-bucket", "16", "--max-new-tokens",
         "64", "--prefix-cache", "--seed", "0", "--set",
         f"flight_recorder_path={tmp_path / 'fr.json'}"], env=env)
        for p in rep_ports]
    rep_handles = [ProcessReplicaHandle(f"fs{i}", "127.0.0.1", p)
                   for i, p in enumerate(rep_ports)]
    for h, pr in zip(rep_handles, rep_procs):
        h.proc = pr
    state = cp.StoreState()
    store = _ServedStore(cp.StoreServer(state))
    routers = []
    try:
        deadline = time.time() + 300
        while not all(h.ready() for h in rep_handles):
            assert time.time() < deadline, "replicas never became ready"
            assert all(p.poll() is None for p in rep_procs)
            time.sleep(0.5)
        for h in rep_handles:
            state.set(f"replica/{h.id}", {"host": h.host, "port": h.port})
        routers = [cp.ProcessRouterHandle(
            f"rt{i + 1}", "127.0.0.1", _free_port(),
            store_host="127.0.0.1", store_port=store.port,
            launch_args=["--set", "controlplane_heartbeat_ttl_s=2.0",
                         "--set", "controlplane_heartbeat_interval_s=0.25"])
            for i in range(2)]
        for r in routers:
            r.spawn()
        deadline = time.time() + 120
        while not all(r.ready() for r in routers) or \
                len(state.members("router/")) < 2:
            assert time.time() < deadline, "routers never joined"
            assert all(r.alive() for r in routers), "a router died"
            time.sleep(0.25)
        _, ring0 = state.get("cp/ring")
        assert sorted(ring0["members"]) == ["rt1", "rt2"]
        prompt = [1, 2, 3, 4, 5]

        def stream(port, sid, consume):
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=120)
            body = json.dumps({"prompt": prompt, "stream": True,
                               "max_tokens": n_tokens}).encode()
            conn.request("POST", "/v1/completions", body=body,
                         headers={"Content-Type": "application/json",
                                  "Content-Length": str(len(body)),
                                  "X-Session-Id": sid})
            resp = conn.getresponse()
            assert resp.status == 200
            toks, buf = [], b""
            try:
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        return toks, False
                    buf += chunk
                    while b"\n\n" in buf:
                        frame, buf = buf.split(b"\n\n", 1)
                        if not frame.startswith(b"data:"):
                            continue
                        data = frame[5:].strip()
                        if data == b"[DONE]":
                            return toks, True
                        toks.extend(json.loads(data)["choices"][0]
                                    .get("token_ids", []))
                        if not consume(toks):
                            return toks, False
            finally:
                conn.close()

        ring = cp.HashRing(["rt1", "rt2"])
        sid = next(f"victim-{i}" for i in range(1000)
                   if ring.owner(f"victim-{i}") == "rt1")
        victim, survivor = routers
        want, done = stream(survivor.port, "no-fault", lambda t: True)
        assert done and len(want) == n_tokens

        def consume(toks):
            if len(toks) >= 8:
                victim.kill()
                return False
            return True

        head, done = stream(victim.port, sid, consume)
        assert not done and head == want[:len(head)]
        deadline = time.time() + 30
        while (state.get("cp/ring")[1] or {}).get("members") != ["rt2"]:
            assert time.time() < deadline, "the ring never moved"
            time.sleep(0.25)
        assert state.get("cp/ring")[1]["epoch"] > ring0["epoch"]
        tail, done = stream(survivor.port, sid, lambda t: True)
        assert done and tail == want
    finally:
        for r in routers:
            r.stop(timeout_s=5)
        for h in rep_handles:
            h.stop(timeout_s=5)
        store.close()
