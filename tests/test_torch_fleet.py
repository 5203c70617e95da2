"""The port's fleet supervisor, cascade breaker and chaos harness against the
JAX package's.

``ChaosPlan.generate`` from a seed gives the reference's event list;
``CascadeBreaker`` on one fake-clock script gives the reference's
transitions; ``FleetSupervisor`` over fake handles, on one tick script per
scenario (crash backoff and restart budget, a wedged replica, scale up and
down with hysteresis and cooldown, a drain timeout, an anomaly stream that
blocks scale-down), gives the reference's action log and slot states.  Then
the port's own fleet of tiny CPU engines: a chaos scenario (a mid-stream
kill, a wedge, a scale-down drain) keeps a direct engine run's tokens, and
a scale-down drain migrates the victim's live sessions to the survivor.
"""

import asyncio
import time

import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu.fleet import CascadeBreaker as JCascadeBreaker
from paddle_tpu.fleet import ChaosPlan as JChaosPlan
from paddle_tpu.fleet import FleetSupervisor as JFleetSupervisor
from paddle_tpu.router import RouterServer as JRouterServer
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fleet import (CascadeBreaker, ChaosController,
                                    ChaosPlan, FaultEvent, FleetSupervisor,
                                    InprocReplicaHandle)
from paddle_tpu_torch.fleet.supervisor import DRAINING, READY
from paddle_tpu_torch.inference import GenerationConfig
from paddle_tpu_torch.router import RouterServer

from test_serving_http import completion_body, sse_chunks
from test_torch_router import (Clock, FakeClient, do, engine,  # noqa: F401
                               oracle_tokens, pair)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# chaos plans and the cascade breaker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,kinds", [
    (0, None), (7, None), (12345, None),
    (3, ("kill", "cut", "migrate_interrupt", "partial_transfer",
         "poll_timeout", "throttle"))])
def test_chaos_plan_generation_matches_reference(seed, kinds):
    kw = dict(ticks=40, targets=["fs0", "fs1", "fs2"], n_faults=6,
              recovery_ticks=4)
    if kinds is not None:
        kw["kinds"] = kinds
    assert ChaosPlan.generate(seed, **kw).describe() == \
        JChaosPlan.generate(seed, **kw).describe()


def test_chaos_controller_applies_in_tick_order():
    plan = ChaosPlan([FaultEvent(5, "refuse", "fs0"),
                      FaultEvent(2, "throttle", "fs1", 0.03),
                      FaultEvent(9, "allow", "fs0")])
    assert [e.tick for e in plan.events] == [2, 5, 9]
    chaos = ChaosController(plan)
    c0 = chaos.wrap(FakeClient("fs0"))
    c1 = chaos.wrap(FakeClient("fs1"))
    assert [e.kind for e in chaos.advance(5)] == ["throttle", "refuse"]
    assert c0.refuse and c1.frame_delay_s == 0.03
    assert chaos.advance(8) == [] and not chaos.exhausted()
    chaos.advance(9)
    assert not c0.refuse and chaos.exhausted()
    assert [t for t, _ in chaos.log] == [5, 5, 9]
    with pytest.raises(ValueError):
        FaultEvent(1, "meteor", "fs0")


def _breaker_log(cls):
    clock = Clock()
    b = cls(threshold=3, window_s=10.0, cooldown_s=5.0, clock=clock)
    log = []
    script = [(0.0, "death"), (1.0, "death"), (2.0, "update"),
              (12.5, "death"), (13.0, "death"), (14.0, "death"),
              (15.0, "update"), (16.0, "death"), (20.0, "update"),
              (21.5, "update"), (21.6, "probe"), (21.7, "probe"),
              (22.0, "release"), (22.1, "probe"), (23.0, "died"),
              (27.9, "update"), (28.0, "update"), (28.5, "probe"),
              (29.0, "survived"), (29.5, "death"), (40.0, "update")]
    for t, verb in script:
        clock.t = t
        if verb == "death":
            out = b.record_death()
        elif verb == "update":
            out = b.update()
        elif verb == "probe":
            out = b.claim_probe()
        elif verb == "release":
            out = b.release_probe()
        else:
            out = b.probe_result(verb == "survived")
        log.append((t, verb, out, b.state, b.state_dict()))
    off = cls(threshold=0, clock=clock)
    off.record_death()
    log.append((off.enabled, off.update(), off.state))
    return log


def test_cascade_breaker_matches_reference():
    obs.reset("fleet.")
    jobs.reset("fleet.")
    assert _breaker_log(CascadeBreaker) == _breaker_log(JCascadeBreaker)


# ---------------------------------------------------------------------------
# the supervisor over fake handles: one tick script, both packages
# ---------------------------------------------------------------------------

class FakeHandle:
    """A replica the supervisor owns, driven by the script."""

    def __init__(self, rid):
        self.id = rid
        self._alive = False
        self.ready_now = False
        self.drained_now = False
        self.drain_begun = False
        self.killed = False

    def spawn(self):
        self._alive = True

    def alive(self):
        return self._alive

    def ready(self):
        return self._alive and self.ready_now

    def client(self):
        return FakeClient(self.id)

    def begin_drain(self):
        self.drain_begun = True

    def drained(self):
        return self.drained_now

    def stop(self, timeout_s=5.0):
        self._alive = False

    def kill(self):
        self.killed = True
        self._alive = False

    def export_sessions(self):
        raise NotImplementedError

    def import_sessions(self, snaps):
        raise NotImplementedError

    def describe(self):
        return {"id": self.id, "kind": "FakeHandle"}


SUP_DEFAULTS = dict(min_replicas=1, max_replicas=8, hot_ticks=10**9,
                    cold_ticks=10**9, cooldown_s=0.0, backoff_base_s=1.0,
                    backoff_max_s=8.0, backoff_reset_s=100.0,
                    restart_budget=2, drain_timeout_s=10.0, rebalance=False)

# scenario -> (supervisor options, [(clock, [operations])]); each step
# applies its operations, then ticks once
SCENARIOS = {
    "crash_backoff_budget": (dict(target=2), [
        (0.0, [("ready", "fs0"), ("ready", "fs1")]),
        (0.5, [("die", "fs0")]),
        (1.0, []),
        (1.6, []),
        (2.0, [("ready", "fs0")]),
        (3.0, [("die", "fs0")]),
        (4.0, []),
        (5.0, []),
        (5.1, [("die", "fs0")]),
        (20.0, []),
    ]),
    "wedged": (dict(target=2), [
        (0.0, [("ready", "fs0"), ("ready", "fs1")]),
        (0.5, [("live", "fs0", {}), ("fail", "fs1", 2)]),
        (1.0, []),
        (2.0, []),
        (2.5, [("ready", "fs1")]),
        (3.0, []),
    ]),
    "scale_hysteresis": (dict(target=2, hot_ticks=2, cold_ticks=3,
                              cooldown_s=5.0, scale_up_load=2.0,
                              scale_down_load=0.5, max_replicas=3), [
        (0.0, [("ready", "fs0"), ("ready", "fs1")]),
        (1.0, [("live", "fs0", {"inflight": 5}),
               ("live", "fs1", {"inflight": 5})]),
        (2.0, []),
        (3.0, [("ready", "fs2")]),
        (4.0, [("live", "fs0", {"inflight": 0}),
               ("live", "fs1", {"inflight": 0}),
               ("live", "fs2", {"inflight": 0})]),
        (5.0, []),
        (6.0, []),
        (7.0, []),
        (8.0, []),
        (9.0, [("drained", "fs2")]),
        (10.0, []),
    ]),
    "drain_timeout": (dict(target=2), [
        (0.0, [("ready", "fs0"), ("ready", "fs1")]),
        (1.0, [("live", "fs0", {"inflight": 1}),
               ("live", "fs1", {}), ("target", 1)]),
        (5.0, []),
        (11.5, []),
        (12.0, []),
    ]),
    "anomaly_block": (dict(target=2, cold_ticks=2, scale_down_load=1.0), [
        (0.0, [("ready", "fs0"), ("ready", "fs1")]),
        (1.0, [("live", "fs0", {"anomaly_total": 1}),
               ("live", "fs1", {})]),
        (2.0, [("live", "fs0", {"anomaly_total": 2})]),
        (3.0, [("live", "fs0", {"anomaly_total": 3})]),
        (4.0, []),
        (5.0, []),
        (6.0, []),
    ]),
}


def _supervisor_log(sup_cls, router_cls, registry, scenario):
    registry.reset("fleet.")
    opts, steps = SCENARIOS[scenario]
    clock = Clock()
    handles = {}

    def spawner(rid):
        h = FakeHandle(rid)
        handles.setdefault(rid, []).append(h)
        return h

    router = router_cls([], allow_empty=True, health_interval_s=1e9,
                        dead_after=2)
    kw = {**SUP_DEFAULTS, **opts}
    sup = sup_cls(router, spawner, clock=clock, **kw)
    sup.start()
    log = []
    for t, ops in steps:
        clock.t = t
        for op in ops:
            h = handles[op[1]][-1] if op[0] != "target" else None
            if op[0] == "ready":
                h.ready_now = True
            elif op[0] == "die":
                h._alive = False
            elif op[0] == "drained":
                h.drained_now = True
            elif op[0] == "target":
                sup.set_target(op[1])
            elif op[0] == "fail":
                st = next(s for s in router.states if s.id == op[1])
                for _ in range(op[2]):
                    st.mark_failed()
            elif op[0] == "live":
                st = next(s for s in router.states if s.id == op[1])
                st.ok = st.ready = True
                st.fails = 0
                for k, v in op[2].items():
                    setattr(st, k, v)
        actions = sup.tick()
        state = sup.state()
        log.append((t, actions, state["target"], state["converged"],
                    state["hot_streak"], state["cold_streak"],
                    [(s["id"], s["state"], s["restarts"], s["role"])
                     for s in state["slots"]],
                    sorted(s.id for s in router.states),
                    [h.killed for hs in handles.values() for h in hs]))
    counters = {name: {lbl: int(registry.metrics.counter(name, **{key: lbl})
                               .value) for lbl in lbls}
                for name, key, lbls in (
                    ("fleet.crashes", "kind", ("exit", "wedged")),
                    ("fleet.drains", "outcome",
                     ("clean", "timeout", "died")),
                    ("fleet.scale_events", "direction", ("up", "down")),
                    ("fleet.migrations", "outcome",
                     ("ok", "skipped", "failed")))}
    counters["restarts"] = int(registry.metrics.counter(
        "fleet.replica_restarts").value)
    sup.shutdown(drain=False, timeout_s=0.1)
    return log, counters


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervisor_action_log_matches_reference(scenario):
    got = _supervisor_log(FleetSupervisor, RouterServer, obs, scenario)
    want = _supervisor_log(JFleetSupervisor, JRouterServer, jobs, scenario)
    assert got == want
    assert any(actions for _t, actions, *_ in got[0])


# ---------------------------------------------------------------------------
# the port's fleet of tiny CPU engines
# ---------------------------------------------------------------------------

BUDGET = 48
PROMPTS = ([1, 2, 3, 4, 5], [9, 8, 7], [4, 5, 6, 7], [11, 12, 13])


def _warmed_factory(tm, step_sleep_s=0.0):
    """Engines warmed through both step shapes before their server starts;
    ``step_sleep_s`` paces each engine step so a stream stays in flight
    long enough for a scripted fault to land on it."""
    def factory():
        eng = engine(tm, gen=GenerationConfig(max_new_tokens=BUDGET),
                     max_seq_len=128, prefix_cache=True)
        eng.add_request(list(range(1, 13)), max_new_tokens=4)
        eng.run()
        if step_sleep_s:
            real = eng.step

            def paced():
                time.sleep(step_sleep_s)
                return real()
            eng.step = paced
        return eng
    return factory


async def _request(router, prompt, stream=False, headers=()):
    return await do(router, "POST", "/v1/completions",
                    completion_body(list(prompt), BUDGET, stream=stream),
                    headers=headers)


def _verdict(status, body, prompt, oracle):
    if status != 200 or b"data: [DONE]" not in body:
        return "hard_failure"
    chunks = sse_chunks(body)
    finishes = [c["choices"][0]["finish_reason"] for c in chunks
                if c["choices"][0]["finish_reason"]]
    toks = [t for c in chunks for t in c["choices"][0]["token_ids"]]
    if finishes and finishes[-1] in ("stop", "length") and \
            toks == oracle[tuple(prompt)]:
        return "ok"
    return "synth_error" if finishes and finishes[-1] == "error" \
        else "hard_failure"


async def _converge(sup, router, deadline_s=120.0):
    deadline = time.perf_counter() + deadline_s
    while True:
        sup.tick()
        await router.poll_replicas()
        if sup.converged() and len(router._candidates()) == sup.target:
            return
        assert time.perf_counter() < deadline, sup.state()
        await asyncio.sleep(0.02)


@pytest.fixture(scope="module")
def oracle(pair):
    return oracle_tokens(pair[1], PROMPTS, BUDGET)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_fleet_chaos_scenario_keeps_the_oracle_tokens(pair, oracle):
    """A mid-stream kill, a wedged replica and a scale-down drain, from one
    explicit fault plan: the killed replica's streams resume on the
    survivor with the oracle's tokens, the fleet converges back after each
    fault, and the drain's in-flight streams finish."""
    _jm, tm = pair
    obs.reset("router.")
    obs.reset("fleet.")
    plan = ChaosPlan([FaultEvent(100, "kill", "fs0"),
                      FaultEvent(200, "wedge", "fs1"),
                      FaultEvent(260, "unwedge", "fs1")])
    chaos = ChaosController(plan)
    router = RouterServer([], allow_empty=True, policy="round_robin",
                          health_interval_s=1e9, dead_after=2,
                          poll_timeout_s=0.25)
    sup = FleetSupervisor(
        router, lambda rid: InprocReplicaHandle(
            rid, _warmed_factory(tm, 0.004), client_wrap=chaos.wrap),
        target=2, min_replicas=1, max_replicas=3, restart_budget=3,
        backoff_base_s=0.05, backoff_max_s=0.5, backoff_reset_s=1e9,
        drain_timeout_s=20.0, hot_ticks=10**9, cold_ticks=10**9,
        cooldown_s=0.0, rebalance=False, on_spawn=chaos.register_handle)

    async def drive():
        sup.start()
        await _converge(sup, router)
        # mid-stream kill: both replicas hold streams past their first
        # drain when fs0 dies
        tasks = [asyncio.ensure_future(_request(router, p, stream=True))
                 for p in PROMPTS]
        deadline = time.perf_counter() + 60
        while True:
            live = {rid: any(st.sent > 0 for st in c.inner.server._live)
                    for rid, c in chaos._clients.items()}
            if live.get("fs0") and any(v for k, v in live.items()
                                       if k != "fs0"):
                break
            assert time.perf_counter() < deadline, "streams never started"
            await asyncio.sleep(0.005)
        chaos.advance(100)
        results = await asyncio.gather(*tasks)
        killed = [_verdict(st, bd, p, oracle)
                  for (st, _h, bd), p in zip(results, PROMPTS)]
        await _converge(sup, router)
        # wedge fs1: the router reports it dead, the supervisor kills and
        # restarts it
        chaos.advance(200)
        for _ in range(2):
            await router.poll_replicas()
        await _converge(sup, router)
        chaos.advance(260)
        after_wedge = await _request(router, PROMPTS[0])
        # scale-down drain with a stream on each replica
        tasks = [asyncio.ensure_future(_request(router, p, stream=True))
                 for p in PROMPTS[:2]]
        deadline = time.perf_counter() + 60
        while not all(c.inner.server._live for c in chaos._clients.values()
                      if c.inner.server.engine_alive()):
            assert time.perf_counter() < deadline
            await asyncio.sleep(0.005)
        sup.set_target(1)
        sup.tick()
        victim = [s.handle.id for s in sup._slots if s.state == DRAINING]
        during = await _request(router, PROMPTS[2])
        results = await asyncio.gather(*tasks)
        drained = [_verdict(st, bd, p, oracle)
                   for (st, _h, bd), p in zip(results, PROMPTS[:2])]
        await _converge(sup, router)
        return killed, after_wedge, victim, during, drained, \
            [s.state for s in sup._slots]

    try:
        killed, after_wedge, victim, during, drained, slots = \
            asyncio.run(drive())
    finally:
        sup.shutdown(drain=False, timeout_s=5.0)
    assert killed == ["ok"] * len(PROMPTS), killed
    assert obs.metrics.counter("router.resumes",
                               outcome="resumed").value >= 1
    assert int(obs.metrics.counter("fleet.replica_restarts").value) >= 1
    assert int(obs.metrics.counter("fleet.crashes",
                                   kind="wedged").value) >= 1
    assert after_wedge[0] == 200
    assert len(victim) == 1
    assert during[0] == 200 and during[1]["x-router-replica"] != victim[0]
    assert drained == ["ok", "ok"], drained
    assert slots == [READY]
    assert int(obs.metrics.counter("fleet.drains",
                                   outcome="clean").value) >= 1


def test_drain_migration_ships_sessions_to_the_successor(pair):
    """Scale-down with a live stream on each replica: the victim exports
    its in-flight sessions' pages to the survivor before draining, the
    streams finish clean, and the survivor holds the imported pages with
    balanced allocator books.  The engines are paced (a few ms a step)
    and the supervisor ticks only once both streams are two pages in, so
    the export always finds the sessions live."""
    _jm, tm = pair
    obs.reset("fleet.")
    router = RouterServer([], allow_empty=True, health_interval_s=1e9,
                          dead_after=2, poll_timeout_s=0.5)
    sup = FleetSupervisor(
        router, lambda rid: InprocReplicaHandle(
            rid, _warmed_factory(tm, 0.01)),
        target=2, min_replicas=1, max_replicas=3, hot_ticks=10**9,
        cold_ticks=10**9, cooldown_s=0.0, drain_timeout_s=30.0,
        rebalance=False)

    async def drive():
        sup.start()
        await _converge(sup, router)
        tasks = [asyncio.ensure_future(_request(
            router, [10 + i, 3, 5, 7, 11], stream=True,
            headers=(("X-Session-Id", f"sess{i}"),))) for i in range(2)]
        deadline = time.perf_counter() + 60
        while sum(any(st.sent >= 12 for st in s.handle.server._live)
                  for s in sup._slots) < 2:
            assert time.perf_counter() < deadline, "streams never started"
            await asyncio.sleep(0.002)
        sup.set_target(1)
        sup.tick()
        draining = [s.handle.id for s in sup._slots if s.state == DRAINING]
        results = await asyncio.gather(*tasks)
        await _converge(sup, router)
        return draining, results

    try:
        draining, results = asyncio.run(drive())
        assert len(draining) == 1
        for st, _h, bd in results:
            assert st == 200
            chunks = sse_chunks(bd)
            assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        assert int(obs.metrics.counter("fleet.migrations",
                                       outcome="ok").value) == 1
        migrated = int(obs.metrics.counter("fleet.migrated_pages").value)
        assert migrated >= 2
        surv = sup._slots[0]
        assert surv.state == READY and surv.handle.id != draining[0]
        eng = surv.handle.server.engine
        st = eng.stats()
        assert st["migration_imports"] >= 1
        assert st["migration_imported_pages"] == migrated
        alloc = eng.g.cache.allocator
        assert alloc.stats()["active_seqs"] == 0
        assert alloc.pages_in_use == eng.prefix_cache.cached_pages()
    finally:
        sup.shutdown(drain=False, timeout_s=5.0)


def test_fleet_launcher_arg_surface():
    """The launcher defaults to the card, forwards --device, --num-layers,
    --prefix-cache, --cache-dtype and every --set to each replica."""
    from paddle_tpu_torch.fleet.__main__ import (build_parser,
                                                 replica_launch_args)
    args = build_parser().parse_args([])
    assert args.device == "cuda" and args.routers == 1
    assert replica_launch_args(args) == ["--preset", "tiny",
                                         "--device", "cuda"]
    args = build_parser().parse_args(
        ["--device", "cpu", "--preset", "llama2_7b", "--num-layers", "4",
         "--prefix-cache", "--cache-dtype", "int8",
         "--set", "fleet_roles=prefill=1,decode=1"])
    assert replica_launch_args(args) == [
        "--preset", "llama2_7b", "--device", "cpu", "--num-layers", "4",
        "--prefix-cache", "--cache-dtype", "int8",
        "--set", "fleet_roles=prefill=1,decode=1"]
