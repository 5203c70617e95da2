"""The port's metrics registry, tracer, overhead contract and the serving
engine's lifecycle telemetry against the JAX package's.

The same sequence of calls into both packages' registries gives equal
snapshots and equal Prometheus text; the same greedy workload through the
reference engine and the port engine gives equal lifecycle counts,
histogram sample counts and per-phase attribution counts (the host
decisions of the two engines are the same, so every count is exact).  Each
package is read from its own process-wide registry.
"""

import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.models import llama as jllama
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.utils import load_reference_state

from test_observability import parse_prometheus

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _leave_the_serving_series_empty():
    """The registry is process-wide: a later test's SLO controller must
    not read this test's synthetic latencies."""
    yield
    obs.reset("serving.")


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm


def _port_engine(tm, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("gen", GenerationConfig(max_new_tokens=6))
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_bucket", 8)
    return ContinuousBatchingEngine(tm, device="cpu", **kw)


# ---------------------------------------------------------------------------
# registry and exposition: one call sequence, both packages
# ---------------------------------------------------------------------------

def _drive_registry(reg):
    """A call sequence over every registry feature: labeled splits, the
    cardinality guard, custom histogram bounds, awkward label values, help
    text, an in-place reset."""
    c = reg.counter("t9.hits")
    c.inc()
    c.inc(3)
    reg.counter("t9.hits", shard="a").inc(2)
    reg.counter("t9.hits", shard="b").inc()
    reg.gauge("t9.depth").set(7)
    g = reg.gauge("t9.level", pool="x")
    g.set(2.5)
    g.inc(-1.0)
    h = reg.histogram("t9.lat_ms")
    for v in (0.0005, 1.5, 2.5, 3.5, 100.0, 7000.0, 1e7):
        h.observe(v)
    hb = reg.histogram("t9.len", bounds=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 3.0, 9.0):
        hb.observe(v)
    reg.counter("t9.reqs", path='a"b\\c\nd,e={}').inc(3)
    reg.set_help("t9.reqs", "requests\nby path\\slash")
    # the cardinality guard (metrics_max_series = 4)
    series = [reg.counter("t9cap.reqs", tenant=f"t{i}") for i in range(10)]
    for s in series:
        s.inc()
    for i in range(6):
        reg.histogram("t9cap.lat_ms", tenant=f"t{i}").observe(float(i))
    reg.counter("t9.gone").inc(5)
    reg.reset("t9.gone")
    return series


def test_registry_snapshot_and_prometheus_text_equal_the_reference():
    old_j = jflags.get_flags(["metrics_max_series"])
    old_t = flags.get_flags(["metrics_max_series"])
    jflags.set_flags({"metrics_max_series": 4})
    flags.set_flags({"metrics_max_series": 4})
    try:
        jreg, treg = jmetrics.MetricRegistry(), tmetrics.MetricRegistry()
        jser, tser = _drive_registry(jreg), _drive_registry(treg)
    finally:
        jflags.set_flags(old_j)
        flags.set_flags(old_t)
    assert treg.snapshot() == jreg.snapshot()
    text = treg.prometheus_text()
    assert text == jreg.prometheus_text()
    assert treg.families() == jreg.families()
    # the guard folded six label sets into one overflow series
    assert len({id(s) for s in tser}) == len({id(s) for s in jser}) == 5
    assert dict(tser[-1].labels) == {"series": "__overflow__"}
    assert treg.counter("metrics.dropped_series").value == 6 + 2
    # a strict exposition parser accepts it, awkward labels round-trip
    fams = parse_prometheus(text)
    (name, labels, value), = fams["paddle_tpu_t9_reqs"]["samples"]
    assert labels == {"path": 'a"b\\c\nd,e={}'} and value == "3"
    assert fams["paddle_tpu_t9_lat_ms"]["type"] == "histogram"
    # percentiles and summaries are the same function of the buckets
    h = treg.histogram("t9.lat_ms")
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert h.percentile(q) == jreg.histogram("t9.lat_ms").percentile(q)


def test_tracer_cap_ring_and_export_match_the_reference(tmp_path):
    """The event cap, the ring sink and the Chrome export behave as the
    reference's: the same events (timestamps aside) in the same order."""
    from collections import deque

    def drive(mod, path):
        tr = mod.Tracer(max_events=5)
        ring = deque(maxlen=3)
        assert not tr.enabled
        tr.attach_ring(ring)
        assert tr.enabled
        for i in range(4):
            tr.instant(f"r{i}", tid="lane")
        assert tr._events == []          # the flat buffer stays empty
        tr.start()
        for i in range(4):
            tr.event(f"e{i}", time.perf_counter(), 0.001, tid="lane",
                     args={"i": i})
            tr.counter("depth", n=i)
        with tr.span("s", tid="other"):
            pass
        tr.stop()
        tr.detach_ring()
        assert not tr.enabled
        tr.instant("after")
        doc = json.loads(open(tr.export_chrome_trace(path)).read())

        def strip(evs):
            return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                    for e in evs]
        return strip(doc["traceEvents"]), strip(ring), tr.dropped, \
            doc["metadata"]["dropped_events"]

    d0 = obs.metrics.counter("tracing.dropped_events").value
    want = drive(jtracing, str(tmp_path / "j.json"))
    got = drive(ttracing, str(tmp_path / "t.json"))
    assert got == want
    assert got[2] == got[3] > 0
    assert obs.metrics.counter("tracing.dropped_events").value == \
        d0 + got[2]
    # the device trace is torch.profiler's, on a card only
    if not torch.cuda.is_available():
        with ttracing.TRACER.device_trace(str(tmp_path / "dev")) as started:
            assert started is False
        assert not (tmp_path / "dev").exists()


def test_assert_overhead_counts_kernel_builds_and_syncs():
    """The port's compiles are kernel builds and loads: each
    ``record_compile`` counts once, as each nvcc run or library load of
    ``kernels/_build.py`` does."""
    with obs.assert_overhead(record=True) as rec:
        obs.record_compile(1.5)
        obs.count_sync()
    assert rec.compiles == 1 and rec.syncs == 1
    assert obs.metrics.histogram("jit.backend_compile_ms").max >= 1500.0
    with pytest.raises(AssertionError, match="kernel build"):
        with obs.assert_overhead():
            obs.record_compile(0.1)
    with pytest.raises(AssertionError, match="sync"):
        with obs.assert_overhead():
            obs.count_sync()
    with obs.assert_overhead(max_syncs=2, max_compiles=1):
        obs.count_sync(2)
        obs.record_compile(0.1)


def test_kernel_loads_feed_the_compile_counter(monkeypatch, tmp_path):
    """A library built or loaded by ``kernels/_build.py`` counts in
    ``jit.backend_compiles`` (the nvcc run and the load itself faked: no
    toolkit here)."""
    from paddle_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "_start", lambda name, header="": None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_LIBS", {})
    c0 = obs.backend_compiles()
    lib = _build.load("primitives")
    assert lib[0] == "lib" and obs.backend_compiles() == c0 + 1
    assert _build.load("primitives") is lib          # loaded once
    assert obs.backend_compiles() == c0 + 1


def test_steptimer_records_warm_steps_and_builds():
    t = obs.StepTimer("t9train")
    for _ in range(3):
        t.begin_step()
        t.tick(tokens=64)
    assert obs.metrics.counter("t9train.steps").value == 3
    assert obs.metrics.histogram("t9train.step_ms").count == 2
    assert obs.metrics.gauge("t9train.tokens_per_sec").value > 0
    t.begin_step()
    obs.record_compile(0.2)
    t.tick(tokens=64)                     # a step that built a kernel
    assert obs.metrics.counter("t9train.recompiles").value == 1
    assert obs.metrics.histogram("t9train.step_ms").count == 2


def test_watchdog_timeout_fires_hooks_and_counts():
    from paddle_tpu_torch.distributed.watchdog import CommTaskManager

    m = CommTaskManager()
    m.poll_interval = 0.02
    seen = []
    m.add_timeout_hook(lambda task: seen.append(task.name))
    m.add_timeout_hook(lambda task: 1 / 0)          # swallowed, printed
    c0 = obs.metrics.counter("watchdog.timeouts").value
    old = flags.get_flags(["comm_timeout_s"])
    flags.set_flags({"comm_timeout_s": 0})
    try:
        m.start()
        m.begin("t9-hung-step")
        deadline = time.time() + 10
        while not seen and time.time() < deadline:
            time.sleep(0.01)
    finally:
        m.shutdown()
        flags.set_flags(old)
    assert seen == ["t9-hung-step"]
    assert obs.metrics.counter("watchdog.timeouts").value == c0 + 1
    assert m.outstanding() == []


# ---------------------------------------------------------------------------
# the engine's lifecycle series against the reference engine
# ---------------------------------------------------------------------------

LIFECYCLE_COUNTERS = ("serving.requests_total", "serving.requests_completed",
                      "serving.tokens_generated", "serving.prefill_tokens",
                      "serving.steps", "serving.drains",
                      "serving.prefix_hits", "serving.prefix_tokens_saved",
                      "serving.cow_copies", "serving.spec.drafted_tokens",
                      "serving.spec.accepted_tokens",
                      "serving.spec.rejected_tokens")
LIFECYCLE_HISTOGRAMS = ("serving.ttft_ms", "serving.itl_ms",
                        "serving.queue_wait_ms", "serving.queue_depth",
                        "serving.batch_occupancy", "serving.spec.accept_len")
PHASES = ("prefill", "decode", "spec_verify", "fused_k", "cow_copy",
          "drain")


def _counts(mod):
    m = mod.metrics
    out = {k: int(m.counter(k).value) for k in LIFECYCLE_COUNTERS}
    out.update({k: m.histogram(k).count for k in LIFECYCLE_HISTOGRAMS})
    out.update({f"step_ms/{p}": m.histogram("serving.step_ms",
                                            phase=p).count
                for p in PHASES})
    return out


_RNG = np.random.default_rng(3)
_SHARED = _RNG.integers(1, 256, 24).tolist()
WORKLOAD = [_SHARED + _RNG.integers(1, 256, 5).tolist(), _SHARED[:16],
            _RNG.integers(1, 256, 11).tolist(), [4, 5, 6]]
CONFIGS = {
    "plain": dict(),
    "prefix_ngram": dict(prefix_cache=True, spec_decode="ngram", spec_k=3),
    "fused": dict(spec_decode="fused", spec_k=3),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_lifecycle_counts_equal_the_reference(pair, config):
    """The same greedy workload in two waves (the second repeats the first
    wave's prompts: prefix hits, a fully cached prompt's COW) gives equal
    lifecycle counters, histogram sample counts and per-phase attribution
    counts in both packages."""
    jm, tm = pair
    kw = dict(max_batch=2, max_seq_len=64, page_size=8, prefill_bucket=8,
              sync_every=4, metrics=True, **CONFIGS[config])
    je = JEngine(jm, gen=JGen(max_new_tokens=7), **kw)
    te = ContinuousBatchingEngine(tm, gen=GenerationConfig(max_new_tokens=7),
                                  device="cpu", **kw)
    jobs.reset("serving.")
    obs.reset("serving.")
    outs = []
    for eng in (je, te):
        got = []
        for wave in (WORKLOAD, WORKLOAD[:2]):
            rids = [eng.add_request(p) for p in wave]
            res = eng.run()
            got.append([res[r] for r in rids])
        outs.append(got)
    assert outs[1] == outs[0]
    want, got = _counts(jobs), _counts(obs)
    assert got == want
    assert got["serving.requests_completed"] == 6
    assert got["step_ms/prefill"] > 0 and got["step_ms/drain"] > 0
    phase = {"plain": "decode", "prefix_ngram": "spec_verify",
             "fused": "fused_k"}[config]
    assert got[f"step_ms/{phase}"] > 0
    if config == "prefix_ngram":
        assert got["step_ms/cow_copy"] > 0 and got["serving.cow_copies"] > 0
    # every dispatch is attributed once; the cost tables share their keys
    assert sum(got[f"step_ms/{p}"] for p in PHASES
               if p not in ("drain", "cow_copy")) == got["serving.steps"]
    assert set(te.attribution.baselines()) == \
        set(je.attribution.baselines())
    # the pool gauges are folded at each drain, as the reference's
    for g in ("serving.pages_in_use", "serving.peak_pages_in_use",
              "serving.active_seqs"):
        assert obs.metrics.gauge(g).value == jobs.metrics.gauge(g).value


def test_engine_metrics_off_records_nothing(pair):
    obs.reset("serving.")
    eng = _port_engine(pair[1], metrics=False)
    rids = [eng.add_request([1, 2, 3]), eng.add_request([4, 5])]
    out = eng.run()
    assert all(len(out[r]) == 6 for r in rids)
    assert eng.attribution is None
    assert obs.metrics.counter("serving.tokens_generated").value == 0
    assert obs.metrics.counter("serving.requests_total").value == 0
    assert obs.metrics.histogram("serving.ttft_ms").count == 0
    assert obs.metrics.histogram("serving.step_ms",
                                 phase="decode").count == 0


def test_engine_ttft_itl_invariants_with_eos(pair):
    """One TTFT per request and one ITL per later token, EOS included:
    frozen repeats after a device-side EOS are trimmed and not timed."""
    tm = pair[1]
    probe = _port_engine(tm, gen=GenerationConfig(max_new_tokens=8),
                         metrics=False)
    r = probe.add_request([1, 2, 3, 4, 5])
    eos = probe.run()[r][2]
    obs.reset("serving.")
    eng = _port_engine(tm, gen=GenerationConfig(max_new_tokens=8,
                                                eos_token_id=int(eos)),
                       metrics=True, sync_every=8)
    rids = [eng.add_request([1, 2, 3, 4, 5]), eng.add_request([9, 8])]
    out = eng.run()
    total = sum(len(out[r]) for r in rids)
    assert out[rids[0]][-1] == eos and len(out[rids[0]]) < 8
    assert obs.metrics.counter("serving.tokens_generated").value == total
    assert obs.metrics.histogram("serving.ttft_ms").count == 2
    assert obs.metrics.histogram("serving.itl_ms").count == total - 2
    assert obs.metrics.histogram("serving.queue_wait_ms").count == 2


def test_warm_steps_zero_builds_zero_syncs_with_metrics_and_attribution(
        pair):
    """Warm engine steps with metrics and attribution on add no kernel
    build and no marked sync between drains; the drain is the one marked
    sync."""
    eng = _port_engine(pair[1], metrics=True, sync_every=64)
    eng.add_request([1, 2, 3])
    eng.run()
    for p in ([9, 8, 7], [2, 3]):
        eng.add_request(p)
    with obs.assert_overhead(max_compiles=0, max_syncs=0):
        for _ in range(6):
            eng.step()
    assert eng.attribution is not None and eng._pending
    with obs.assert_overhead(max_compiles=0, max_syncs=1):
        eng._drain()
    out = eng.run()
    assert all(len(v) == 6 for v in out.values())


def test_inflight_requests_table_matches_the_reference(pair):
    jm, tm = pair
    rows = []
    for eng in (JEngine(jm, gen=JGen(max_new_tokens=4), max_batch=1,
                        max_seq_len=64, page_size=8, prefill_bucket=8,
                        metrics=True),
                _port_engine(tm, max_batch=1, metrics=True)):
        r1 = eng.submit([1, 2, 3], max_new_tokens=4, trace_id="tr-1")
        r2 = eng.submit([4, 5, 6, 7], max_new_tokens=4)
        eng.step()
        got = eng.inflight_requests()
        assert [r["req_id"] for r in got] == [r1.req_id, r2.req_id]
        assert all(r["age_s"] >= 0 for r in got)
        rows.append([{k: v for k, v in r.items() if k != "age_s"}
                     for r in got])
        eng.run()
        assert eng.inflight_requests() == []
    assert rows[1] == rows[0]
    assert rows[1][1]["state"] == "queued" and rows[1][0]["slot"] == 0


def test_engine_request_spans_in_trace(pair, tmp_path):
    obs.tracer.start()
    try:
        eng = _port_engine(pair[1], metrics=True)
        rid = eng.add_request([1, 2, 3, 4, 5])
        eng.run()
    finally:
        obs.tracer.stop()
    doc = json.loads(open(obs.export_chrome_trace(
        str(tmp_path / "serve.json"))).read())
    names = [e["name"] for e in doc["traceEvents"]]
    assert "engine.step" in names
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    q, p, d = (spans[f"req{rid}.{s}"] for s in ("queued", "prefill",
                                                "decode"))
    assert q["ts"] <= p["ts"] <= d["ts"]
    assert d["args"]["generated"] == 6


def test_serving_stats_mirror_the_allocator_books(pair):
    """The process-wide prefix counters (``serving.*``) move with the
    allocator's per-engine books."""
    from paddle_tpu_torch.inference.prefix_cache import serving_stats
    s0 = serving_stats()
    eng = _port_engine(pair[1], prefix_cache=True)
    p = list(range(1, 25))
    for _ in range(2):
        eng.add_request(p)
        eng.run()
    s1 = serving_stats()
    st = eng.stats()
    for k in s0:
        assert s1[k] - s0[k] == st[k], k
    assert st["prefix_hits"] >= 1


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------

def test_every_emitted_family_is_cataloged_with_the_reference_kinds():
    """Every family this process created in the port's registry (bar the
    tests' throwaway ``t<digit>`` families) is in the port's catalog; a
    family both packages catalog has the same kind and labels."""
    import re

    from paddle_tpu.observability import catalog as jcatalog
    test_fam = re.compile(r"^t\d")
    extra = [n for n in obs.catalog.undocumented() if not test_fam.match(n)]
    assert extra == [], f"undocumented metric families: {extra}"
    for name, (kind, labels, _help) in obs.catalog.CATALOG.items():
        if name in jcatalog.CATALOG:
            assert jcatalog.CATALOG[name][:2] == (kind, labels), name
    fams = tmetrics.REGISTRY.families()
    for name, kind in fams.items():
        if not test_fam.match(name):
            assert obs.catalog.CATALOG[name][0] == kind, name
    md = obs.catalog.generate_markdown()
    assert "`serving.kv.migration_pages`" in md
    obs.catalog.apply_help()
    assert "# HELP paddle_tpu_host_device_syncs marked" in \
        obs.prometheus_text()
