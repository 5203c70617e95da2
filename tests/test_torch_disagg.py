"""Disaggregated prefill->decode serving in the port, against the JAX
package's.

``parse_roles`` gives the reference's results.  Over tiny CPU engines: a
new stream prefills on the prefill replica (a one-token leg), its finished
prefix ships to the decode replica over ``/migratez`` and the decode leg
splices into the same client stream, with the reference engine's greedy
tokens and the session pinned to the decode replica; a failed import falls
back without dropping the stream; unary requests and a fleet with the
handoff flag off route as a mixed fleet.  Role fleets spawn and autoscale
each role, rebalance and ``fleet_signals`` as the reference's do (one tick
script, both packages).  One handoff crosses the packages each way: the
prefill leg on a reference ``ServingServer`` and the decode leg on a port
one, or the other way round, with the reference's tokens.  Last, a real
process fleet: the port's launcher with a prefill and a decode replica on
the CPU answers one stream through a handoff.
"""

import asyncio
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu.fleet import FleetSupervisor as JFleetSupervisor
from paddle_tpu.fleet.supervisor import parse_roles as jparse_roles
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.router import RouterServer as JRouterServer
from paddle_tpu.serving import ServingServer as JServingServer
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fleet import FleetSupervisor
from paddle_tpu_torch.fleet.supervisor import parse_roles
from paddle_tpu_torch.inference import GenerationConfig
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.router import InprocReplica, RouterServer
from paddle_tpu_torch.serving import ServingServer

from test_serving_http import completion_body
from test_torch_fleet import FakeHandle
from test_torch_router import (Clock, FakeClient, Fleet, do,  # noqa: F401
                               engine, jengine, pair, port_fleet,
                               stream_tokens)

torch.set_num_threads(2)

PROMPT = list(range(1, 17))          # 2 full pages of 8


@pytest.fixture(scope="module")
def oracle(pair):
    """The reference engine's greedy tokens for PROMPT (a mixed run)."""
    jm, _tm = pair
    eng = jengine(jm, gen=JGen(max_new_tokens=32))
    rid = eng.add_request(list(PROMPT))
    return eng.run()[rid]


def _role_fleet(tm, roles, engine_kw=None):
    kw = {i: {"prefix_cache": True, **(engine_kw or {}).get(i, {})}
          for i in range(len(roles))}
    return port_fleet(tm, roles=roles, engine_kw=kw)


def _counts(family, outcomes):
    return {o: int(obs.metrics.counter(family, outcome=o).value)
            for o in outcomes}


HANDOFF = ("ok", "export_failed", "import_failed", "no_successor")
RESUMES = ("resumed", "handoff")


@pytest.mark.parametrize("spec", [
    "", "  ", "prefill=1,decode=2", "decode=1, mixed=2 ,decode=1",
    "turbo=1", "prefill=0", "prefill", "prefill=two", "mixed=3,"])
def test_parse_roles_matches_reference(spec):
    def run(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(parse_roles) == run(jparse_roles)


def test_serving_role_matches_reference(pair):
    """``role=`` is checked as the reference checks it, ``None`` reads
    ``FLAGS_serving_role``, ``--role`` sets that flag, and ``/statusz``
    and the trace lane carry the role."""
    from paddle_tpu.serving.__main__ import build_parser as jparser
    from paddle_tpu_torch.serving.__main__ import build_parser
    jm, tm = pair
    errors = []
    for cls, eng in ((ServingServer, engine(tm)), (JServingServer,
                                                   jengine(jm))):
        with pytest.raises(ValueError) as e:
            cls(eng, role="turbo", flight_recorder=False, slo=False)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert build_parser().parse_args(["--role", "decode"]).role == \
        jparser().parse_args(["--role", "decode"]).role == "decode"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--role", "turbo"])
    flags.set_flags({"serving_role": "prefill"})
    try:
        srv = ServingServer(engine(tm), flight_recorder=False, slo=False)
    finally:
        flags.set_flags({"serving_role": "mixed"})
    assert srv.role == "prefill" and srv.trace_proc.startswith("prefill-")
    assert srv.statusz()["role"] == "prefill"
    assert ServingServer(engine(tm), flight_recorder=False,
                         slo=False).role == "mixed"


# ---------------------------------------------------------------------------
# the handoff over tiny engines
# ---------------------------------------------------------------------------

def test_handoff_stream_matches_the_mixed_oracle(pair, oracle):
    """One new stream: a one-token prefill leg, the prefix shipped to the
    decode replica (0 re-prefilled tokens there), the decode leg spliced:
    one client stream with the reference's tokens and one finish."""
    _jm, tm = pair
    obs.reset("router.")
    obs.reset("serving.kv.handoff")
    fleet = _role_fleet(tm, ["prefill", "decode", "mixed"])
    try:
        async def main():
            await fleet.router.poll_replicas()
            roles = [s.role for s in fleet.router.states]
            resp = await do(fleet.router, "POST", "/v1/completions",
                            completion_body(PROMPT, 24, stream=True))
            st = await do(fleet.router, "GET", "/statusz")
            return roles, resp, json.loads(st[2])

        roles, (status, _h, body), doc = asyncio.run(main())
        stats = [s.engine.stats() for s in fleet.servers]
    finally:
        fleet.close()
    assert roles == ["prefill", "decode", "mixed"]
    toks, finishes, ids = stream_tokens(body)
    assert status == 200 and len(ids) == 1
    assert toks == oracle[:24]
    assert finishes == ["length"]
    assert body.rstrip().endswith(b"data: [DONE]")
    assert _counts("router.handoff", HANDOFF)["ok"] == 1
    assert _counts("router.resumes", RESUMES) == {"resumed": 0,
                                                  "handoff": 1}
    assert stats[0]["migration_exports"] >= 1
    assert stats[1]["migration_imports"] >= 1
    assert int(obs.metrics.counter("serving.kv.handoff_sessions",
                                   outcome="ok").value) == 1
    assert int(obs.metrics.counter(
        "serving.kv.handoff_reprefill_tokens").value) == 0
    assert doc["handoff"]["outcomes"]["ok"] == 1
    assert doc["resume"]["outcomes"]["handoff"] == 1


def test_handoff_pins_the_session_to_the_decode_replica(pair, oracle):
    """After a handoff the session's pin is the decode replica, and its
    next turn goes there directly: one handoff for two turns."""
    _jm, tm = pair
    obs.reset("router.")
    fleet = _role_fleet(tm, ["prefill", "decode"])
    try:
        async def main():
            await fleet.router.poll_replicas()
            hdr = [("X-Session-Id", "sess-1")]
            r1 = await do(fleet.router, "POST", "/v1/completions",
                          completion_body(PROMPT, 12, stream=True), hdr)
            pinned = fleet.router.placer.pinned("sess-1")
            await fleet.router.poll_replicas()
            r2 = await do(fleet.router, "POST", "/v1/completions",
                          completion_body(PROMPT, 12, stream=True), hdr)
            return r1, pinned, r2

        (s1, _h1, b1), pinned, (s2, h2, b2) = asyncio.run(main())
    finally:
        fleet.close()
    assert s1 == s2 == 200
    assert stream_tokens(b1)[0] == stream_tokens(b2)[0] == oracle[:12]
    assert pinned == "r1" and h2["x-router-replica"] == "r1"
    assert _counts("router.handoff", HANDOFF)["ok"] == 1


def test_failed_import_falls_back_and_never_drops_the_stream(pair, oracle):
    """A decode replica with another page size refuses the import: the
    stream re-prefills on the mixed replica, still one stream with the
    reference's tokens; nothing was installed on the decode replica."""
    _jm, tm = pair
    obs.reset("router.")
    fleet = _role_fleet(tm, ["prefill", "decode", "mixed"],
                        engine_kw={1: {"page_size": 16,
                                       "prefill_bucket": 16}})
    try:
        async def main():
            await fleet.router.poll_replicas()
            return await do(fleet.router, "POST", "/v1/completions",
                            completion_body(PROMPT, 24, stream=True))

        status, _h, body = asyncio.run(main())
        imports = fleet.servers[1].engine.stats().get("migration_imports", 0)
    finally:
        fleet.close()
    toks, finishes, ids = stream_tokens(body)
    assert status == 200 and len(ids) == 1
    assert toks == oracle[:24] and finishes == ["length"]
    assert _counts("router.handoff", HANDOFF) == {
        "ok": 0, "export_failed": 0, "import_failed": 1, "no_successor": 0}
    assert _counts("router.resumes", RESUMES) == {"resumed": 1,
                                                  "handoff": 0}
    assert imports == 0


@pytest.mark.parametrize("case", ["unary", "flag_off"])
def test_mixed_routing_without_a_handoff(pair, oracle, case):
    """A unary completion on a role fleet, and a stream with
    ``router_prefill_handoff`` off, place as in a mixed fleet: the
    reference's tokens and no handoff."""
    _jm, tm = pair
    obs.reset("router.")
    stream = case == "flag_off"
    if case == "flag_off":
        flags.set_flags({"router_prefill_handoff": False})
    try:
        fleet = _role_fleet(tm, ["prefill", "decode"])
        try:
            async def main():
                await fleet.router.poll_replicas()
                return await do(fleet.router, "POST", "/v1/completions",
                                completion_body(PROMPT, 12, stream=stream))

            status, _h, body = asyncio.run(main())
        finally:
            fleet.close()
    finally:
        flags.set_flags({"router_prefill_handoff": True})
    toks = stream_tokens(body)[0] if stream else \
        json.loads(body)["choices"][0]["token_ids"]
    assert status == 200 and toks == oracle[:12]
    assert _counts("router.handoff", HANDOFF) == dict.fromkeys(HANDOFF, 0)


# ---------------------------------------------------------------------------
# role fleets, rebalance and fleet_signals: one script, both packages
# ---------------------------------------------------------------------------

class MigHandle(FakeHandle):
    """A fake replica with a working migration plane."""

    def __init__(self, rid):
        super().__init__(rid)
        self.export_result = [{"tokens": list(range(16)), "pages": [0, 1]}]
        self.exports = 0
        self.imports = 0
        self.abort = False

    def export_sessions(self):
        self.exports += 1
        return list(self.export_result)

    def import_sessions(self, snaps):
        self.imports += 1
        if self.abort:
            return {"sessions": 0, "imported": 0, "skipped": 0,
                    "aborted": len(snaps)}
        return {"sessions": len(snaps), "imported": 2, "skipped": 0,
                "aborted": 0}


def _live(router, rid, **attrs):
    st = next(s for s in router.states if s.id == rid)
    st.ok = st.ready = True
    st.fails = 0
    for k, v in attrs.items():
        setattr(st, k, v)


def _roles_log(sup_cls, router_cls, registry):
    """Role slots, per-role autoscale (decode on load, prefill on queue
    depth), the per-role floor, sticky roles across a restart."""
    registry.reset("fleet.")
    clock = Clock()
    handles, spawned = {}, []

    def spawner(rid, role):
        h = MigHandle(rid)
        handles.setdefault(rid, []).append(h)
        spawned.append((rid, role))
        return h

    router = router_cls([], allow_empty=True, health_interval_s=1e9,
                        dead_after=2)
    sup = sup_cls(router, spawner, roles={"prefill": 1, "decode": 1},
                  min_replicas=1, max_replicas=6, hot_ticks=1,
                  cold_ticks=3, cooldown_s=0.0, scale_up_load=2.0,
                  scale_down_load=0.5, backoff_base_s=1.0,
                  backoff_max_s=8.0, backoff_reset_s=100.0,
                  restart_budget=2, drain_timeout_s=10.0, rebalance=False,
                  clock=clock)
    log = [sup._spawner_roleful]
    sup.start()

    def tick(t):
        clock.t = t
        actions = sup.tick()
        log.append((t, actions, dict(sup.roles), sup.target,
                    [(s["id"], s["state"], s["role"])
                     for s in sup.state()["slots"]],
                    {r: int(registry.metrics.gauge("fleet.role",
                                                   role=r).value)
                     for r in ("prefill", "decode", "mixed")}))

    for hs in handles.values():
        hs[-1].ready_now = True
    tick(0.0)
    _live(router, "fs0", role="decode", inflight=5)
    _live(router, "fs1", role="prefill", inflight=5)
    tick(1.0)
    handles["fs2"][-1].ready_now = True
    _live(router, "fs0", role="decode", inflight=0)
    tick(2.0)
    _live(router, "fs2", role="decode", inflight=0)
    _live(router, "fs1", role="prefill", queue_depth=9, inflight=0)
    tick(3.0)
    for hs in handles.values():
        hs[-1].ready_now = True
    _live(router, "fs1", role="prefill", queue_depth=0)
    tick(4.0)
    _live(router, "fs3", role="prefill")
    for t in (5.0, 6.0, 7.0):
        tick(t)
    for rid in list(handles):
        handles[rid][-1].drained_now = True
    tick(8.0)
    handles["fs0"][-1]._alive = False
    tick(9.0)
    tick(20.0)
    log.append(spawned)
    log.append(router.fleet_signals())
    sup.shutdown(drain=False, timeout_s=0.1)
    return log


def test_role_fleet_spawns_and_autoscales_like_the_reference():
    got = _roles_log(FleetSupervisor, RouterServer, obs)
    want = _roles_log(JFleetSupervisor, JRouterServer, jobs)
    assert got == want
    assert got[0] is True
    actions = [a for entry in got[1:-2] for a in entry[1]]
    assert ("scale_up", ("decode", 2)) in actions
    assert ("scale_up", ("prefill", 2)) in actions
    assert any(a[0] == "scale_down" for a in actions)


def _rebalance_log(sup_cls, router_cls, registry):
    registry.reset("fleet.")
    clock = Clock()
    handles = {}

    def spawner(rid):
        h = MigHandle(rid)
        handles.setdefault(rid, []).append(h)
        return h

    router = router_cls([], allow_empty=True, health_interval_s=1e9,
                        dead_after=2)
    sup = sup_cls(router, spawner, target=2, min_replicas=1, max_replicas=4,
                  hot_ticks=10**9, cold_ticks=10**9, cooldown_s=0.0,
                  migrate_on_drain=True, rebalance=True,
                  rebalance_cooldown_s=50.0, clock=clock)
    sup.start()
    for hs in handles.values():
        hs[-1].ready_now = True
    sup.tick()
    for sid, rid in (("sess-a", "fs0"), ("sess-b", "fs0"),
                     ("sess-c", "fs1")):
        router.placer.pin(sid, rid)
    _live(router, "fs0", slo_decision="shed")
    _live(router, "fs1")
    log = []
    for t, op in ((1.0, None), (2.0, None), (60.0, None),
                  (120.0, "empty"), (200.0, "abort")):
        clock.t = t
        if op == "empty":
            handles["fs0"][-1].export_result = []
        elif op == "abort":
            handles["fs0"][-1].export_result = [{"tokens": [1], "pages": [0]}]
            handles["fs1"][-1].abort = True
            router.placer.pin("sess-d", "fs0")
        log.append((t, sup.tick(),
                    {s: router.placer.pinned(s)
                     for s in ("sess-a", "sess-b", "sess-c", "sess-d")},
                    handles["fs0"][-1].exports, handles["fs1"][-1].imports,
                    sup.state()["rebalance"]))
    sup.shutdown(drain=False, timeout_s=0.1)
    return log


def test_rebalance_matches_the_reference():
    got = _rebalance_log(FleetSupervisor, RouterServer, obs)
    assert got == _rebalance_log(JFleetSupervisor, JRouterServer, jobs)
    assert got[-1][-1]["outcomes"] == {"ok": 2, "skipped": 1, "failed": 1}


def test_fleet_signals_aggregate_per_role_like_the_reference():
    out = []
    for cls in (RouterServer, JRouterServer):
        router = cls([], allow_empty=True, health_interval_s=1e9)
        for rid in ("p0", "d0", "d1", "m0"):
            router.add_replica(FakeClient(rid))
        for s, role, q, infl, slo in zip(
                router.states, ("prefill", "decode", "decode", "mixed"),
                (4, 0, 1, 2), (0, 3, 5, 1),
                ("admit", "shed", "admit", "admit")):
            s.ok = s.ready = True
            s.role, s.queue_depth, s.inflight = role, q, infl
            s.slo_decision = slo
        out.append(router.fleet_signals())
    assert out[0] == out[1]
    assert out[0]["roles"]["decode"]["mean_load"] == 4.5


# ---------------------------------------------------------------------------
# one handoff across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefill_side", ["reference", "port"])
def test_handoff_across_the_packages(pair, oracle, prefill_side):
    """The port's router hands a stream from a reference replica to a port
    one (or the other way round): the migration wire is shared, and the
    client's one stream carries the reference's mixed-run tokens."""
    jm, tm = pair
    obs.reset("router.")
    ref = JServingServer(jengine(jm, prefix_cache=True), flight_recorder=False,
                         slo=False,
                         role="prefill" if prefill_side == "reference"
                         else "decode").start()
    port = ServingServer(engine(tm, prefix_cache=True), flight_recorder=False,
                         slo=False,
                         role="decode" if prefill_side == "reference"
                         else "prefill").start()
    servers = [ref, port] if prefill_side == "reference" else [port, ref]
    fleet = Fleet(servers, InprocReplica, RouterServer)
    try:
        async def main():
            await fleet.router.poll_replicas()
            return await do(fleet.router, "POST", "/v1/completions",
                            completion_body(PROMPT, 20, stream=True))

        status, _h, body = asyncio.run(main())
        stats = [s.engine.stats() for s in servers]
    finally:
        fleet.close()
    toks, finishes, ids = stream_tokens(body)
    assert status == 200 and len(ids) == 1
    assert toks == oracle[:20] and finishes == ["length"]
    assert _counts("router.handoff", HANDOFF)["ok"] == 1
    assert stats[0]["migration_exports"] >= 1
    assert stats[1]["migration_imports"] >= 1


# ---------------------------------------------------------------------------
# a real process fleet on the CPU
# ---------------------------------------------------------------------------

def _free_port_run(n):
    """A base port with ``n`` consecutive free ports on localhost."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for i in range(n):
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    raise RuntimeError("no run of free ports")


def _get(port, path, timeout=10):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def test_cpu_process_fleet_hands_off_over_real_sockets(pair, tmp_path):
    """``python -m paddle_tpu_torch.fleet --device cpu`` with
    ``fleet_roles=prefill=1,decode=1``: once the router is ready, one
    streamed completion finishes as one client stream with a direct
    engine run's tokens, the router's /statusz shows a handoff outcome
    ``ok``, and SIGTERM drains the fleet to exit 0."""
    base = _free_port_run(3)
    router_port, replica_base = base, base + 1
    argv = [sys.executable, "-m", "paddle_tpu_torch.fleet",
            "--device", "cpu", "--preset", "tiny", "--replicas", "2",
            "--port", str(router_port),
            "--replica-port-base", str(replica_base), "--prefix-cache",
            "--set", "fleet_roles=prefill=1,decode=1",
            "--set", "fleet_tick_interval_s=0.2",
            "--set", "router_health_interval_s=0.2",
            "--set", "fleet_drain_timeout_s=10",
            "--set", f"flight_recorder_path={tmp_path / 'fr.json'}"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(argv, cwd=root, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    prompt = list(range(3, 43))
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, "the fleet launcher died"
            try:
                st, body = _get(router_port, "/readyz")
                if st == 200 and json.loads(body)["replicas_ready"] == 2:
                    break
            except OSError:
                pass
            assert time.time() < deadline, "the fleet never became ready"
            time.sleep(0.2)
        c = http.client.HTTPConnection("127.0.0.1", router_port, timeout=120)
        body = json.dumps({"prompt": prompt, "max_tokens": 12,
                           "stream": True}).encode()
        c.request("POST", "/v1/completions", body,
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        status, raw = r.status, r.read()
        c.close()
        _st, doc = _get(router_port, "/statusz")
        doc = json.loads(doc)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    model = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu",
                                   seed=0)
    eng = engine(model, gen=GenerationConfig(max_new_tokens=12),
                 max_seq_len=128, page_size=16, prefill_bucket=64)
    rid = eng.add_request(prompt)
    want = eng.run()[rid]
    toks, finishes, ids = stream_tokens(raw)
    assert status == 200 and len(ids) == 1
    assert finishes == ["length"] and toks == want
    assert sorted(r["role"] for r in doc["replicas"]) == ["decode",
                                                          "prefill"]
    assert doc["handoff"]["outcomes"]["ok"] == 1
    assert rc == 0
