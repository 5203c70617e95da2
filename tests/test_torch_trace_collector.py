"""The port's fleet tracing (span export, clock-aligned assembly, request
timelines) against the JAX package's, on the CPU.

Units first: ``ClockSync`` on the same handshake samples, per-trace
sampling and the keep markers give the reference's answers.  Then the same
span batches (and the same tracer events, through each package's exporter
and transport) go into both packages' ``TraceCollector``: the ingested
traces and processes, ``assemble``'s documents, ``critical_path`` and
``fleet_dump`` files are compared exactly, apart from the producer's name;
skewed process clocks align onto one monotonic axis and a drifting clock is
re-estimated as the reference does.  ``StoreTransport`` ships through the
store the supervisor's tick drains; the router's ``/tracez`` and
``/collectz`` answer as the reference's.  Last, two port routers over a
prefill and a decode replica: a session owned by the other router forwards
one hop, hands off prefill -> decode, and the collector renders one merged
timeline whose flow events run export before import.
"""

import asyncio
import json
import os
import time
import types
import zlib

import pytest
import torch

from paddle_tpu import controlplane as jcp
from paddle_tpu import observability as jobs
from paddle_tpu.observability import collector as jcol
from paddle_tpu.observability.flight_recorder import \
    FlightRecorder as JFlightRecorder
from paddle_tpu.observability.tracing import Tracer as JTracer
from paddle_tpu.router import RouterServer as JRouterServer
from paddle_tpu_torch import controlplane as cp
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import collector as col
from paddle_tpu_torch.observability.flight_recorder import FlightRecorder
from paddle_tpu_torch.observability.tracing import Tracer
from paddle_tpu_torch.router import InprocReplica, RouterServer
from paddle_tpu_torch.serving import ServingServer

from test_serving_http import completion_body
from test_torch_fleet import FakeHandle
from test_torch_router import Clock, do, engine, oracle_tokens, pair  # noqa: F401,E501

torch.set_num_threads(2)

PKGS = {"port": (col, Tracer, obs), "ref": (jcol, JTracer, jobs)}


def _same(a, b):
    """Equal apart from the producer's name."""
    def norm(x):
        if isinstance(x, dict):
            return {k: ("<producer>" if k == "producer" else norm(v))
                    for k, v in x.items()}
        if isinstance(x, list):
            return [norm(v) for v in x]
        return x
    return norm(a) == norm(b)


def _procs(c):
    """The collector's process table without wall-clock readings."""
    return {k: {f: v for f, v in d.items() if f != "last_seen"}
            for k, d in c.processes().items()}


# ---------------------------------------------------------------------------
# units: clock sync, sampling, keep markers
# ---------------------------------------------------------------------------

SAMPLES = [(10.0, 20.25, 10.5), (11.0, 21.002, 11.0), (0.0, 10.0, 0.002),
           (1.0, 11.05, 1.2), (2.0, 12.5, 2.02), (3.0, 12.9, 3.5),
           (4.0, 14.0, 4.0005), (5.0, 15.3, 5.001)]


@pytest.mark.parametrize("drift_s", [0.005, 0.2, None])
def test_clock_sync_matches_the_reference(drift_s):
    mine, ref = col.ClockSync(drift_s), jcol.ClockSync(drift_s)
    for s in SAMPLES:
        assert mine.observe(*s) == ref.observe(*s)
        assert (mine.offset, mine.rtt, mine.samples, mine.resyncs) == \
            (ref.offset, ref.rtt, ref.samples, ref.resyncs)
    if drift_s == 0.005:
        assert mine.resyncs > 0


def test_sampling_and_keep_markers_match_the_reference():
    ids = [f"tr-{i}" for i in range(500)] + ["engine", "slot3", ""]
    for rate in (0.0, 0.1, 0.5, 0.99, 1.0):
        assert [col._sampled(t, rate) for t in ids] == \
            [jcol._sampled(t, rate) for t in ids]
    kept = [t for t in ids if col._sampled(t, 0.5)]
    assert 0 < len(kept) < len(ids)
    frac = (zlib.crc32(b"tr-x") & 0xFFFFFFFF) / 2**32
    assert col._sampled("tr-x", frac + 1e-6) and \
        not col._sampled("tr-x", frac)
    events = [{"name": "router.handoff"},
              {"name": "kv.ship", "cat": "migrate.export"},
              {"name": "x", "args": {"outcome": "shed"}},
              {"name": "x", "args": {"reason": "failover"}},
              {"name": "x", "args": {"verdict": "Quarantine"}},
              {"name": "router.takeover", "cat": "router"},
              {"name": "router.replay", "cat": "router"},
              {"name": "engine.step", "cat": "host"},
              {"name": "x", "args": {"kind": 3}}, {"name": "x", "args": []}]
    assert [col._keep_event(e) for e in events] == \
        [jcol._keep_event(e) for e in events]
    assert [col._keep_event(e) for e in events][-3:] == [False] * 3


# ---------------------------------------------------------------------------
# the export pipeline: one script through both packages
# ---------------------------------------------------------------------------

def _export_log(pkg):
    c, tracer_cls, _reg = PKGS[pkg]
    log = []
    collector = c.TraceCollector(clock=lambda: 5.0)
    tr = tracer_cls()
    exp = c.SpanExporter(c.InprocTransport(collector), proc="p0",
                         role="replica", tracer=tr, clock=lambda: 5.0,
                         sample_rate=1.0, batch=1)
    tr.attach_export(exp)
    try:
        exp.probe_clock()
        tr.event("req0.prefill", 1.0, 0.1, tid="tr-a")
        tr.event("req0.decode", 1.1, 0.2, tid="tr-a")
        log.append(exp.flush())
    finally:
        tr.detach_export()
    log += [collector.traces(), _procs(collector),
            collector.track_names("tr-a")]
    # sampled out, with tail-keep on handoff markers, sticky per lane
    collector = c.TraceCollector()
    tr = tracer_cls()
    exp = c.SpanExporter(c.InprocTransport(collector), proc="p2", tracer=tr,
                         sample_rate=0.0)
    tr.attach_export(exp)
    try:
        tr.event("plain.step", 1.0, 0.1, tid="tr-plain")
        tr.event("router.handoff", 1.0, 0.1, tid="tr-hand")
        tr.event("shed.refuse", 1.0, 0.1)
        tr.event("engine.step", 1.0, 0.1)
        log += [exp.flush(), collector.traces()]
        tr.event("later.decode", 1.2, 0.1, tid="tr-hand")
        tr.event("later.step", 1.2, 0.1, tid="tr-plain")
        log.append(exp.flush())
    finally:
        tr.detach_export()
    log.append(collector.assemble("tr-hand"))
    return log


def test_exporter_ships_like_the_reference():
    """Named lanes ship (metadata does not), batches split at ``batch``;
    with sampling at 0 only the keep-marked lanes ship, stickily: the
    collectors' traces, processes and assembled documents are equal."""
    mine, ref = _export_log("port"), _export_log("ref")
    assert _same(mine, ref)
    assert mine[0] == 2 and mine[1] == ["tr-a"]
    assert mine[2]["p0"]["seq"] == 1 and mine[2]["p0"]["role"] == "replica"
    assert mine[4:7] == [2, ["tr-hand"], 1]
    assert [e["name"] for e in mine[7]["traceEvents"] if e["ph"] == "X"] \
        == ["router.handoff", "later.decode"]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_exporter_ring_is_bounded_and_drops_count(pkg):
    c, tracer_cls, reg = PKGS[pkg]
    family = "observability.collector.export_dropped"
    before = reg.metrics.counter(family).value
    exp = c.SpanExporter(c.InprocTransport(c.TraceCollector()), proc="p1",
                         tracer=tracer_cls(), max_events=2)
    for i in range(5):
        exp.offer({"ph": "X", "name": f"e{i}"})
    assert [e["name"] for e in exp._buf] == ["e3", "e4"]
    assert reg.metrics.counter(family).value - before == 3


def test_tracer_export_sink_counts_toward_enabled():
    tr = Tracer()
    assert not tr.enabled
    sink = types.SimpleNamespace(got=[], offer=lambda ev: sink.got.append(ev))
    tr.attach_export(sink)
    assert tr.enabled
    tr.event("x", 1.0, 0.1, tid="tr-1")
    tr.start(clear=False)
    tr.stop()
    assert tr.enabled                    # the sink still records
    tr.detach_export()
    assert not tr.enabled
    tr.attach_ring([])
    tr.attach_export(sink)
    tr.detach_export()
    assert tr.enabled                    # the ring still records
    assert [e["name"] for e in sink.got] == ["thread_name", "x"]
    assert tr.lane_names() == {1: "tr-1"}


def _store_log(pkg):
    c, tracer_cls, _reg = PKGS[pkg]
    state = (cp if pkg == "port" else jcp).StoreState()
    collector = c.TraceCollector()
    tr = tracer_cls()
    exp = c.SpanExporter(c.StoreTransport(state), proc="p9", tracer=tr,
                         sample_rate=1.0)
    tr.attach_export(exp)
    try:
        exp.probe_clock()
        tr.event("req1.decode", 1.0, 0.1, tid="tr-store")
        shipped = exp.flush()
    finally:
        tr.detach_export()
    keys = sorted(state.members(c.STORE_BATCH_PREFIX))
    return [exp.clock_sync.samples, shipped, keys,
            collector.poll_store(state), collector.traces(),
            state.members(c.STORE_BATCH_PREFIX), collector.poll_store(state)]


def test_store_transport_round_trip_like_the_reference():
    mine = _store_log("port")
    assert mine == _store_log("ref")
    assert mine[:5] == [1, 1, ["trace/batch/p9/0"], 1, ["tr-store"]]
    assert mine[5:] == [{}, 0]


def test_supervisor_tick_drains_the_store_and_registers_rings(tmp_path):
    from paddle_tpu_torch.fleet import FleetSupervisor
    state = cp.StoreState()
    collector = col.TraceCollector()
    router = RouterServer([], allow_empty=True, health_interval_s=1e9)
    sup = FleetSupervisor(router, FakeHandle, target=1, min_replicas=1,
                          max_replicas=2, hot_ticks=10**9, cold_ticks=10**9,
                          store=state, collector=collector, clock=Clock())
    sup.start()
    h = sup._slots[0].handle
    h.ready_now = True
    fr = FlightRecorder(path=str(tmp_path / "unused.json"), max_events=8,
                        tracer=Tracer())
    h.server = types.SimpleNamespace(flight_recorder=fr)
    state.set(f"{col.STORE_BATCH_PREFIX}px/0",
              {"proc": "px", "events": [{"ph": "X", "name": "req2.decode",
                                         "tid": 1, "ts": 1.0, "dur": 1.0}],
               "lanes": {"1": "tr-sup"}, "offset_us": 0.0})
    sup.tick()
    assert collector.traces() == ["tr-sup"]
    assert state.members(col.STORE_BATCH_PREFIX) == {}
    assert collector._rings[h.id] == fr.events
    sup._deregister(sup._slots[0])
    assert h.id not in collector._rings


# ---------------------------------------------------------------------------
# clock-aligned assembly under skew and drift
# ---------------------------------------------------------------------------

def _skew_doc(pkg):
    c, tracer_cls, _reg = PKGS[pkg]
    world = {"t": 100.0}
    collector = c.TraceCollector(clock=lambda: world["t"])
    tr_a, tr_b = tracer_cls(), tracer_cls()
    exp_a = c.SpanExporter(c.InprocTransport(collector), proc="A",
                           tracer=tr_a, clock=lambda: world["t"] + 0.5,
                           sample_rate=1.0)
    exp_b = c.SpanExporter(c.InprocTransport(collector), proc="B",
                           tracer=tr_b, clock=lambda: world["t"] - 0.5,
                           sample_rate=1.0)
    tr_a.attach_export(exp_a)
    tr_b.attach_export(exp_b)
    try:
        exp_a.probe_clock()
        exp_b.probe_clock()
        offsets = (exp_a.clock_sync.offset, exp_b.clock_sync.offset)
        # true order: A works at world 101.0, B at 101.2; A stamps 101.5
        # and B 100.7 (raw order inverted)
        tr_a.event("leg.a", 101.5, 0.1, tid="tr-skew")
        tr_b.event("leg.b", 100.7, 0.1, tid="tr-skew")
        exp_a.flush()
        exp_b.flush()
    finally:
        tr_a.detach_export()
        tr_b.detach_export()
    return offsets, collector.assemble("tr-skew")


def test_skewed_process_clocks_align_like_the_reference():
    (off, doc), (joff, jdoc) = _skew_doc("port"), _skew_doc("ref")
    assert off == joff and _same(doc, jdoc)
    assert off == pytest.approx((-0.5, 0.5))
    ts = {e["name"]: e["ts"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert ts["leg.a"] == pytest.approx(101.0e6)
    assert ts["leg.b"] == pytest.approx(101.2e6)
    assert set(doc["metadata"]["processes"]) == {"A/A", "B/B"}


def _drift_log(pkg):
    c, tracer_cls, _reg = PKGS[pkg]
    world = {"t": 0.0}
    skew, rtt = [0.0], [0.001]

    class DriftTransport:
        def clock(self):
            t = world["t"]
            world["t"] = t + rtt[0]
            return t + rtt[0] / 2 + skew[0]

        def send(self, batch):
            pass

    exp = c.SpanExporter(DriftTransport(), proc="d", tracer=tracer_cls(),
                         clock=lambda: world["t"])
    log = []
    for s, r in ((0.0, 0.001), (0.1, 0.002), (0.102, 0.004), (0.3, 0.0005)):
        skew[0], rtt[0] = s, r
        exp.probe_clock()
        log.append((exp.clock_sync.offset, exp.clock_sync.resyncs))
    return log


def test_drifting_clock_is_reestimated_like_the_reference():
    log = _drift_log("port")
    assert log == _drift_log("ref")
    assert log[1][0] == pytest.approx(0.1) and log[1][1] == 1
    assert log[2][0] == pytest.approx(0.1) and log[2][1] == 1


# ---------------------------------------------------------------------------
# assembly: tracks, flow ordering, critical path, fleet dumps
# ---------------------------------------------------------------------------

def _batch(proc, lanes, events, offset_us=0.0, role=""):
    return {"proc": proc, "pid": 1, "role": role, "seq": 0,
            "offset_us": offset_us, "rtt_us": 0.0, "lanes": lanes,
            "events": events}


def _x(name, ts, dur, tid=1, proc=None):
    ev = {"ph": "X", "name": name, "cat": "host", "pid": 0, "tid": tid,
          "ts": float(ts), "dur": float(dur)}
    if proc:
        ev["args"] = {"proc": proc}
    return ev


BATCHES = {
    "handoff": [
        _batch("rt0", {"1": "tr-9"}, [
            _x("router.request", 900, 5100, proc="router:rt0")],
            role="router"),
        _batch("replica-a", {"5": "tr-9"}, [
            _x("http.request", 1000, 2500, tid=5, proc="prefill-1"),
            _x("req0.queued", 1500, 500, tid=5, proc="prefill-1"),
            _x("req0.prefill", 2000, 1000, tid=5, proc="prefill-1"),
            _x("migrate.export", 3000, 400, tid=5, proc="prefill-1")]),
        _batch("replica-b", {"7": "tr-9"}, [
            _x("migrate.import", 3500, 400, tid=7, proc="decode-1"),
            _x("req0.decode", 3900, 2000, tid=7, proc="decode-1")],
            offset_us=100.0)],
    "replay": [
        _batch("pa", {"1": "tr-rp"}, [_x("req7.prefill", 1000, 1000),
                                      _x("migrate.export", 2000, 500)]),
        _batch("pb", {"2": "tr-rp"}, [_x("req7.prefill", 3000, 800, tid=2),
                                      _x("req7.decode", 3800, 1200, tid=2)])],
    "takeover": [
        _batch("fleet", {"3": "tr-tk"}, [
            {"ph": "i", "s": "t", "name": "router.takeover", "cat": "router",
             "pid": 0, "tid": 3, "ts": 5000.0,
             "args": {"proc": "router:rt0"}},
            _x("router.replay", 5000, 700, tid=3, proc="router:rt0"),
            _x("req3.queued", 5100, 100, tid=3, proc="mixed-1"),
            _x("req3.prefill", 5200, 400, tid=3, proc="mixed-1"),
            _x("req3.decode", 5700, 1500, tid=3, proc="mixed-1"),
            _x("router.request", 4990, 2300, tid=3, proc="router:rt0")]),
        _batch("fleet", {"3": "tr-tk"}, [
            _x("req1.queued", 1000, 200, tid=3, proc="mixed-1"),
            _x("req1.prefill", 1200, 600, tid=3, proc="mixed-1"),
            _x("req1.decode", 1800, 900, tid=3, proc="mixed-1")])],
    "loose": [_batch("pl", {}, [_x("engine.step", 10, 5, tid=99)]),
              _batch("pl", {"4": "tr-lo"}, [_x("req4.decode", 20, 5, tid=4)],
                     offset_us=-7.5)],
}


def _assembly_log(pkg, name):
    c, _tracer, _reg = PKGS[pkg]
    collector = c.TraceCollector()
    for b in BATCHES[name]:
        assert collector.ingest(b)["t"] > 0
    out = [collector.traces(), _procs(collector)]
    for tid in collector.traces():
        out += [collector.track_names(tid), collector.critical_path(tid),
                collector.assemble(tid)]
    out += [collector.find_traces("migrate"), collector.assemble("nope"),
            collector.critical_path("nope")]
    return out


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_assembly_matches_the_reference(name):
    mine = _assembly_log("port", name)
    assert _same(mine, _assembly_log("ref", name))
    if name == "handoff":
        doc = mine[4]
        flows = [e for e in doc["traceEvents"] if e.get("cat") == "flow"]
        assert [f["ph"] for f in flows] == ["s", "t", "t", "t", "t", "f"]
        cp_ = doc["metadata"]["critical_path"]
        assert cp_["phases_ms"] == {"queue": 0.5, "prefill": 1.0,
                                    "transfer": 1.0, "decode": 2.0}
        assert cp_["total_ms"] == pytest.approx(4.5)
    if name == "replay":
        assert mine[3]["phases_ms"] == {"prefill": 1.0, "transfer": 1.0,
                                        "replay": 0.8, "decode": 1.2}
    if name == "takeover":
        # the port's takeover span is classified as the replay phase
        assert mine[3]["phases_ms"]["replay"] == pytest.approx(0.7)
        assert sum(mine[3]["phases_ms"].values()) == \
            pytest.approx(mine[3]["total_ms"])


def _dump_doc(pkg, path):
    c, _tracer, _reg = PKGS[pkg]
    collector = c.TraceCollector(clock=lambda: 1000.0)
    collector.register_ring("r0", lambda: [
        {"ph": "X", "name": "ring.span", "pid": 0, "tid": 0,
         "ts": 999.5e6, "dur": 1.0},
        {"ph": "X", "name": "ring.old", "pid": 0, "tid": 0, "ts": 1.0,
         "dur": 1.0},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0, "ts": 1.0,
         "args": {"name": "slot0"}}])
    collector.register_ring("r1", lambda: 1 / 0)
    collector.register_ring("gone", lambda: [])
    collector.unregister_ring("gone")
    collector.ingest(_batch("pz", {"1": "tr-fd"},
                            [_x("req3.decode", 999.9e6, 1000),
                             _x("req3.prefill", 1.0, 1000)]))
    out = collector.fleet_dump(reason="test", path=str(path))
    with open(out) as f:
        return json.load(f)


def test_fleet_dump_matches_the_reference(tmp_path):
    doc = _dump_doc("port", tmp_path / "fd.json")
    assert _same(doc, _dump_doc("ref", tmp_path / "jfd.json"))
    names = [e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"]
    assert names == ["ring:r0", "ring:r1", "collector (aligned spans)"]
    xs = [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert xs == ["ring.span", "req3.decode"]


def test_anomaly_span_triggers_a_fleet_dump(tmp_path):
    old = flags.get_flags(["flight_recorder_path",
                           "flight_recorder_min_interval_s"])
    flags.set_flags({"flight_recorder_path": str(tmp_path / "fr.json"),
                     "flight_recorder_min_interval_s": 0.0})
    try:
        collector = col.TraceCollector()
        family = "observability.collector.fleet_dumps"
        dumps = obs.metrics.counter(family).value
        collector.ingest(_batch("ps", {"1": "tr-an"},
                                [_x("sentinel.anomaly", 1000, 0)]))
        assert (tmp_path / "fr_fleet_anomaly.json").exists()
        assert obs.metrics.counter(family).value - dumps == 1
    finally:
        flags.set_flags(old)


def test_flight_recorder_events_and_process_tag(tmp_path):
    for fr_cls, tracer_cls in ((FlightRecorder, Tracer),
                               (JFlightRecorder, JTracer)):
        tr = tracer_cls()
        fr = fr_cls(path=str(tmp_path / "fr.json"), max_events=2,
                    min_interval_s=0.0, tracer=tr).attach()
        for i in range(3):
            tr.event(f"e{i}", 1.0, 0.1)
        assert [e["name"] for e in fr.events()] == ["e1", "e2"]
        assert fr.dump(reason="sigterm").endswith(
            f"_sigterm_p{os.getpid()}.json")
        fr.detach()


# ---------------------------------------------------------------------------
# the router's /tracez and /collectz
# ---------------------------------------------------------------------------

def _endpoint_log(router_cls, collector_cls):
    router = router_cls([], allow_empty=True, health_interval_s=1e9)

    async def main():
        out = [await do(router, "GET", "/tracez")]
        router.collector = collector_cls(clock=lambda: 42.0)
        out.append(await do(router, "POST", "/collectz",
                            json.dumps({"op": "clock"}).encode()))
        out.append(await do(router, "POST", "/collectz", b"{nope"))
        out.append(await do(router, "POST", "/collectz", b"[1, 2]"))
        batch = _batch("pe", {"1": "tr-ep"}, [_x("req0.decode", 1000, 500)])
        out.append(await do(router, "POST", "/collectz",
                            json.dumps(batch).encode()))
        for path in ("/tracez", "/tracez?trace_id=nope",
                     "/tracez?trace_id=tr-ep"):
            out.append(await do(router, "GET", path))
        out.append(await do(router, "GET", "/collectz"))
        return out

    return [(status, json.loads(body) if body else None)
            for status, _h, body in asyncio.run(main())]


def test_tracez_and_collectz_answer_like_the_reference():
    mine = _endpoint_log(RouterServer, col.TraceCollector)
    ref = _endpoint_log(JRouterServer, jcol.TraceCollector)
    for m, r in zip(mine, ref):
        # error texts name the package's own JSON parser's message
        assert m[0] == r[0]
        if m[0] == 200:
            assert _same(m[1], r[1])
    assert [m[0] for m in mine] == [503, 200, 400, 400, 200, 200, 404, 200,
                                    405]
    assert mine[1][1] == {"t": 42.0}
    assert mine[5][1]["traces"] == ["tr-ep"] and mine[5][1]["known"] == 1
    assert mine[7][1]["metadata"]["trace_id"] == "tr-ep"


# ---------------------------------------------------------------------------
# two routers + a prefill and a decode replica: one merged timeline
# ---------------------------------------------------------------------------

HANDOFF_PROMPT = list(range(1, 17))            # 2 full pages of 8


def _wait_for(cond, what, limit_s=20.0, tick=None):
    deadline = time.perf_counter() + limit_s
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"no {what} in {limit_s} s")
        if tick is not None:
            tick()
        time.sleep(0.02)


def test_two_router_two_replica_handoff_assembles_one_timeline(pair):
    """A session owned by rt1 is POSTed to rt0 (the forward carries
    X-Trace-Id), rt1 prefills on the prefill replica and hands the prefix
    to the decode replica, and the collector renders one merged timeline:
    the owner router's and both replica legs' tracks on one axis, flow
    anchors with export before import, a critical path through prefill,
    transfer and decode that sums to the trace's extent.  Spans are
    emitted by the engine threads at retire, after the response is out:
    the test flushes until they have arrived (bounded)."""
    tm = pair[1]
    want = oracle_tokens(tm, [HANDOFF_PROMPT], 12)[tuple(HANDOFF_PROMPT)]
    obs.reset("router.")
    collector = col.TraceCollector()
    exp = col.SpanExporter(col.InprocTransport(collector), proc="fleet",
                           role="test", sample_rate=1.0)
    obs.TRACER.attach_export(exp)
    state = cp.StoreState()
    servers = [ServingServer(engine(tm, prefix_cache=True), role=role,
                             slo=False, flight_recorder=False).start()
               for role in ("prefill", "decode")]
    planes, routers = [], []
    for i in range(2):
        plane = cp.RouterControlPlane(f"rt{i}", cp.LocalStore(state))
        planes.append(plane)
        routers.append(RouterServer(
            [InprocReplica(f"r{j}", s) for j, s in enumerate(servers)],
            policy="scored", controlplane=plane, health_interval_s=1e9))
    for i, plane in enumerate(planes):
        for j, router in enumerate(routers):
            if i != j:
                plane.register_peer(f"rt{j}",
                                    InprocReplica(f"rt{j}", router))
    try:
        exp.probe_clock()

        async def main():
            for _ in range(2):
                for r in routers:
                    await r.cp_tick()
            for r in routers:
                await r.poll_replicas()
            sid = next(f"sess-{n}" for n in range(10_000)
                       if planes[0].owner(f"sess-{n}") == "rt1")
            return await do(
                routers[0], "POST", "/v1/completions",
                completion_body(HANDOFF_PROMPT, 12, stream=True),
                headers=[("X-Session-Id", sid),
                         ("X-Trace-Id", "tr-flagship")])

        status, headers, body = asyncio.run(main())
        assert status == 200 and headers["x-router-owner"] == "rt1"
        toks = [t for line in body.decode().splitlines()
                if line.startswith("data: {")
                for t in json.loads(line[6:])["choices"][0]["token_ids"]]
        assert toks == want
        assert obs.metrics.counter("router.handoff",
                                   outcome="ok").value == 1

        def legs():
            names = {e["name"] for e in
                     (collector.assemble("tr-flagship") or
                      {"traceEvents": []})["traceEvents"]}
            return {"router.request", "migrate.export", "migrate.import",
                    "http.request"} <= names and \
                any(n.endswith(".decode") for n in names) and \
                any(n.endswith(".prefill") for n in names)

        _wait_for(legs, "complete trace", tick=exp.flush)
    finally:
        obs.TRACER.detach_export()
        for s in servers:
            s.close()

    tracks = collector.track_names("tr-flagship")
    assert "fleet/router:rt1" in tracks
    assert any(t.startswith("fleet/prefill") for t in tracks)
    assert any(t.startswith("fleet/decode") for t in tracks)
    doc = collector.assemble("tr-flagship")
    by_name = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X":
            by_name.setdefault(e["name"], e)
    assert by_name["migrate.export"]["ts"] < by_name["migrate.import"]["ts"]
    assert by_name["migrate.export"]["pid"] != by_name["migrate.import"]["pid"]
    flows = [e for e in doc["traceEvents"] if e.get("cat") == "flow"]
    assert len(flows) >= 4 and flows[0]["ph"] == "s" and \
        flows[-1]["ph"] == "f"
    assert [f["ts"] for f in flows] == sorted(f["ts"] for f in flows)
    cpath = doc["metadata"]["critical_path"]
    for phase in ("prefill", "transfer", "decode"):
        assert cpath["phases_ms"].get(phase, 0) > 0, cpath
    # each phase and the total are rounded to 1 us apiece
    assert sum(cpath["phases_ms"].values()) == pytest.approx(
        cpath["total_ms"], abs=5e-4 * (len(cpath["phases_ms"]) + 1))
