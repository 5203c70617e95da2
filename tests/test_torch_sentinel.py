"""The port's regression sentinel, drift detectors, EWMA baselines, step
attribution and flight-recorder rate limit against the JAX package's.

``Ewma`` and ``Drift`` fed the same samples give equal floats; the
sentinel fires on an injected TTFT shift and on a kernel build after
warm-up (the port's compile: ``observability.record_compile``, what
``kernels/_build.py`` calls), and stays quiet through warm-up and on
steady traffic.
"""

import json
import random
import time

import numpy as np
import pytest
import torch

from paddle_tpu.observability import attribution as jattr
from paddle_tpu.observability import sentinel as jsent
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.observability import attribution as tattr
from paddle_tpu_torch.observability import sentinel as tsent

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _leave_the_serving_series_empty():
    """The registry is process-wide: a later test's SLO controller must
    not read this test's synthetic latencies."""
    yield
    obs.reset("serving.")


def _samples(seed, n=120):
    """A stream with warm-up, noise, a level shift and a spike."""
    rng = np.random.default_rng(seed)
    v = list(100.0 + rng.normal(0, 3, n // 2)) + \
        list(300.0 + rng.normal(0, 9, n // 2))
    v[n // 4] = 5000.0
    return [float(x) for x in v] + [0.0] * 8 + [1.0, 60.0]


@pytest.mark.parametrize("alpha,k,min_samples,min_dev",
                         [(0.2, 4.0, 16, 1.0), (0.3, 4.0, 3, 1.0),
                          (0.4, 2.5, 5, 0.05)])
def test_ewma_and_drift_equal_the_reference(alpha, k, min_samples, min_dev):
    je, te = jattr.Ewma(alpha), tattr.Ewma(alpha)
    jd = jsent.Drift(alpha, k, min_samples, min_dev=min_dev)
    td = tsent.Drift(alpha, k, min_samples, min_dev=min_dev)
    fired = 0
    for v in _samples(int(alpha * 10)):
        je.update(v)
        te.update(v)
        assert (te.mean, te.dev, te.n) == (je.mean, je.dev, je.n)
        r = td.update(v)
        assert r == jd.update(v)
        fired += r is not None
    assert td.state() == jd.state()
    assert fired == td.fired > 0


def test_drift_zero_baseline_and_warmup():
    d = tsent.Drift(alpha=0.3, k=4.0, min_samples=3)
    for _ in range(6):
        assert d.update(0.0) is None
    assert d.update(1.0) is None          # under the absolute floor
    assert d.update(60.0) is not None     # a real pile-up fires
    w = tsent.Drift(alpha=0.3, k=4.0, min_samples=5)
    assert all(w.update(v) is None for v in (100.0, 900.0, 5.0, 100.0))


def _sentinel(**kw):
    kw.setdefault("min_samples", 4)
    kw.setdefault("interval_s", 0.0)
    return obs.Sentinel(**kw)


def test_sentinel_detects_injected_ttft_shift():
    obs.reset("serving.ttft_ms")
    obs.reset("observability.anomaly")
    s = _sentinel()
    h = obs.metrics.histogram("serving.ttft_ms")
    for _ in range(6):
        h.observe(100.0)
        h.observe(102.0)
        assert s.check() == []
    h.observe(300.0)                      # injected 3x regression
    h.observe(310.0)
    found = s.check()
    assert any(a["series"] == "serving.ttft_ms" and a["kind"] == "drift"
               for a in found)
    assert obs.metrics.counter("observability.anomaly",
                               series="serving.ttft_ms",
                               kind="drift").value >= 1
    assert s.state()["recent"][-1]["series"] == "serving.ttft_ms"


def test_sentinel_flags_a_kernel_build_after_warmup_only():
    """A kernel build during warm-up is cold-start work; one after
    ``min_samples`` build-free sweeps is a burst anomaly."""
    s = _sentinel(min_samples=3)
    obs.record_compile(2.0)               # warm-up build: not anomalous
    assert s.check() == []
    for _ in range(4):
        assert s.check() == []
    obs.record_compile(0.5)               # a build on the warm path
    found = s.check()
    assert any(a["series"] == "jit.backend_compiles"
               and a["kind"] == "burst" for a in found)
    assert s.check() == []                # one burst, one anomaly


def test_sentinel_steady_workload_zero_anomalies():
    obs.reset("serving.ttft_ms")
    obs.reset("serving.itl_ms")
    s = _sentinel(min_samples=4)
    ttft = obs.metrics.histogram("serving.ttft_ms")
    itl = obs.metrics.histogram("serving.itl_ms")
    q = obs.metrics.gauge("serving.queue_depth_now")
    rng = random.Random(0)
    for i in range(40):
        for _ in range(3):
            ttft.observe(80.0 + rng.uniform(-8, 8))
            itl.observe(12.0 + rng.uniform(-1.5, 1.5))
        q.set(2 + (i % 2))
        assert s.check() == [], f"false positive at sweep {i}"
    assert s.anomalies_total == 0


def test_sentinel_anomaly_dump_carries_the_series(tmp_path):
    tr = obs.Tracer()
    fr = obs.FlightRecorder(path=str(tmp_path / "fr.json"),
                            min_interval_s=60.0, tracer=tr)
    fr.attach()
    try:
        obs.reset("serving.itl_ms")
        s = _sentinel(tracer=tr, flight_recorder=fr)
        h = obs.metrics.histogram("serving.itl_ms")
        for _ in range(6):
            h.observe(10.0)
            assert s.check() == []
        h.observe(50.0)                   # 5x ITL regression
        assert s.check()
        deadline = time.time() + 10
        while fr.last_dump is None and time.time() < deadline:
            time.sleep(0.01)
        doc = json.loads(open(fr.last_dump).read())
        assert doc["metadata"]["reason"] == "anomaly"
        assert any(e.get("name") == "observability.anomaly"
                   and e["args"]["series"] == "serving.itl_ms"
                   for e in doc["traceEvents"])
    finally:
        fr.detach()


def test_dump_rate_limit_per_reason(tmp_path):
    tr = obs.Tracer()
    fr = obs.FlightRecorder(path=str(tmp_path / "storm.json"),
                            min_interval_s=60.0, tracer=tr)
    dumps = obs.metrics.counter("flight_recorder.dumps")
    supp = obs.metrics.counter("flight_recorder.suppressed_dumps")
    d0, s0 = dumps.value, supp.value
    paths = {fr.dump(reason="anomaly") for _ in range(10)}
    assert len(paths) == 1
    assert dumps.value == d0 + 1 and supp.value == s0 + 9
    assert fr.dump(reason="watchdog-x") not in paths   # never shadowed
    quick = obs.FlightRecorder(path=str(tmp_path / "w.json"),
                               min_interval_s=0.05, tracer=tr)
    p1 = quick.dump(reason="anomaly")
    assert quick.dump(reason="anomaly") == p1
    time.sleep(0.06)
    d1 = dumps.value
    assert quick.dump(reason="anomaly") == p1 and dumps.value == d1 + 1
    off = obs.FlightRecorder(path=str(tmp_path / "n.json"),
                             min_interval_s=0.0, tracer=tr)
    s1 = supp.value
    for _ in range(3):
        off.dump(reason="anomaly")
    assert supp.value == s1


def test_step_attribution_fold_equals_the_reference():
    """The same stamps, credits and host blocks give the same histogram
    counts, gauges and cost table."""
    from paddle_tpu import observability as jobs
    from paddle_tpu.observability import metrics as jmetrics
    from paddle_tpu_torch.observability import metrics as tmetrics
    jreg, treg = jmetrics.MetricRegistry(), tmetrics.MetricRegistry()
    ja = jobs.StepAttribution(registry=jreg, alpha=0.2)
    ta = obs.StepAttribution(registry=treg, alpha=0.2)
    plan = [("prefill", 8, 0.0, 16), ("decode", 1, 0.004, 2),
            ("cow_copy", 0, 0.0045, 0), ("spec_verify", 4, 0.006, 0),
            ("decode", 1, 0.0101, 2)]
    for a in (ja, ta):
        for phase, bucket, t, tok in plan:
            a.stamp(phase, bucket, 10.0 + t, tok)
        a.credit_tokens("spec_verify", 5)
        a.fold(10.02)
        a.observe_host("drain", 0.0013, tokens=4)
    assert treg.snapshot() == jreg.snapshot()
    assert ta.baselines() == ja.baselines()


def test_engine_attribution_phases_tile_the_steps():
    torch.manual_seed(0)
    model = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    obs.reset("serving.")
    eng = ContinuousBatchingEngine(
        model, max_batch=2, gen=GenerationConfig(max_new_tokens=6),
        max_seq_len=64, page_size=8, prefill_bucket=8, sync_every=4,
        device="cpu", metrics=True)
    for p in ([1, 2, 3, 4, 5, 6, 7, 8, 9], [4, 5, 6]):
        eng.add_request(p)
    out = eng.run()
    assert all(len(v) == 6 for v in out.values())
    pre = obs.metrics.histogram("serving.step_ms", phase="prefill")
    dec = obs.metrics.histogram("serving.step_ms", phase="decode")
    drn = obs.metrics.histogram("serving.step_ms", phase="drain")
    assert pre.count + dec.count == obs.metrics.counter(
        "serving.steps").value
    assert drn.count == obs.metrics.counter("serving.drains").value
    assert obs.metrics.gauge("serving.tokens_per_sec",
                             phase="decode").value > 0
    assert obs.metrics.gauge("serving.tokens_per_sec",
                             phase="prefill").value == 0.0
    base = eng.attribution.baselines()
    assert base["decode/T1"]["n"] == dec.count and "prefill/T8" in base
