"""The port's serving front door beyond ``/v1/completions``: the metrics
scrape, SLO shedding, graceful drain (``/drainz``, SIGTERM, one real
process), the flight recorder's watchdog / SIGTERM / crash dumps, the
engine-crash path, queue expiry, ``/statusz`` and the ``/migratez``
transfer plane, driven through in-process transports on the tiny Llama
(CPU tensors).  The SLO controller's decisions and ``/statusz``'s key set
are held against the JAX package's.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu.serving import SLOController as JSLOController
from paddle_tpu_torch import flags
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.serving import ServingServer
from paddle_tpu_torch.serving.slo import SLOController, jittered_retry_after

from test_observability import parse_prometheus
from test_serving_http import (completion_body, do, mem_conn, http_bytes,
                               split_response, sse_chunks)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = ([1, 2, 3, 4, 5], [9, 8, 7], [4, 5, 6, 7])


@pytest.fixture(autouse=True)
def _leave_the_serving_series_empty():
    """The registry is process-wide: a later test's SLO controller must
    not read this test's synthetic latencies."""
    yield
    obs.reset("serving.")


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")


def _engine(model, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("gen", GenerationConfig(max_new_tokens=6))
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_bucket", 8)
    return ContinuousBatchingEngine(model, device="cpu", **kw)


def _server(model, **kw):
    eng = kw.pop("engine", None) or _engine(model)
    kw.setdefault("slo", False)
    kw.setdefault("flight_recorder", False)
    return ServingServer(eng, **kw).start()


@pytest.fixture(scope="module")
def oracle(model):
    eng = _engine(model)
    rids = [eng.add_request(p) for p in PROMPTS]
    out = eng.run()
    return {tuple(p): out[r] for p, r in zip(PROMPTS, rids)}


def _tokens(body):
    return [t for c in sse_chunks(body) for t in c["choices"][0]["token_ids"]]


def test_metrics_scrape_mid_stream_leaves_tokens_identical(model, oracle):
    obs.reset("serving.")
    server = _server(model)
    try:
        async def main():
            r, w = mem_conn(http_bytes(
                "POST", "/v1/completions",
                completion_body(list(PROMPTS[0]), 6, stream=True)))
            task = asyncio.create_task(server.handle(r, w))
            deadline = time.perf_counter() + 60
            while b"data: " not in w.buf:
                assert time.perf_counter() < deadline, "no first chunk"
                await asyncio.sleep(0.005)
            scrape = await do(server, "GET", "/metrics")
            await task
            return scrape, w.buf

        (status, headers, text), raw = asyncio.run(main())
        assert status == 200
        assert headers["content-type"].startswith("text/plain")
        fams = parse_prometheus(text.decode())
        assert fams["paddle_tpu_serving_ttft_ms"]["type"] == "histogram"
        count = [v for n, _lb, v in
                 fams["paddle_tpu_serving_ttft_ms"]["samples"]
                 if n.endswith("_count")]
        assert float(count[0]) >= 1
        sstatus, sheaders, sbody = split_response(raw)
        assert sstatus == 200 and _tokens(sbody) == oracle[tuple(PROMPTS[0])]
        assert {c["id"] for c in sse_chunks(sbody)} == \
            {sheaders["x-request-id"]}
        assert obs.metrics.counter("serving.http.streams").value >= 1
    finally:
        server.close()


# ---------------------------------------------------------------------------
# SLO shedding
# ---------------------------------------------------------------------------

def test_slo_decisions_equal_the_reference_on_synthetic_histograms():
    """Both controllers, fed the same histogram sequences through their own
    registries, take the same decision and report the same burn at every
    observation: queue at 1x budget, shed past burn x budget, TTFT and ITL
    terms independent, the window rebase carrying sustained burn."""
    def run(mod_obs, cls):
        mod_obs.reset("serving.")
        slo = cls(ttft_ms=100.0, itl_ms=100.0, quantile=0.9, burn=3.0,
                  min_samples=10, window=32)
        ttft = mod_obs.metrics.histogram("serving.ttft_ms")
        itl = mod_obs.metrics.histogram("serving.itl_ms")
        trace = [slo.decide(record=False)]
        rng = np.random.default_rng(0)
        for i in range(160):
            bad = (40 <= i < 48) or (60 <= i < 110)
            ttft.observe(9999.0 if bad else float(rng.uniform(1, 90)))
            itl.observe(9999.0 if 130 <= i < 150 else 5.0)
            trace.append((slo.decide(record=False), slo.burn_rates()))
        return trace

    want = run(jobs, JSLOController)
    got = run(obs, SLOController)
    assert got == want
    decisions = {d for d, _ in got[1:]}
    assert decisions == {"admit", "queue", "shed"}


def test_slo_shed_path_503_with_retry_after(model):
    obs.reset("serving.")
    slo = SLOController(ttft_ms=100.0, itl_ms=0.0, quantile=0.95,
                        burn=2.0, min_samples=8, window=64)
    server = _server(model, slo=slo)
    try:
        shed = obs.metrics.counter("serving.http.shed")
        ttft = obs.metrics.histogram("serving.ttft_ms")
        for _ in range(16):
            ttft.observe(5.0)
        status, _, _ = asyncio.run(do(server, "POST", "/v1/completions",
                                      completion_body([1, 2, 3], 2)))
        assert status == 200 and shed.value == 0
        for _ in range(32):
            ttft.observe(5000.0)
        status, headers, body = asyncio.run(do(
            server, "POST", "/v1/completions", completion_body([1, 2, 3],
                                                               2)))
        assert status == 503
        err = json.loads(body)["error"]
        assert err["type"] == "overloaded_error"
        ra = int(headers["retry-after"])
        assert 1 <= ra <= 60 and err["retry_after_s"] == ra
        assert shed.value == 1
        assert obs.metrics.counter("serving.http.slo_decision",
                                   decision="shed").value >= 1
        assert asyncio.run(do(server, "GET", "/metrics"))[0] == 200
        assert asyncio.run(do(server, "GET", "/healthz"))[0] == 200
    finally:
        server.close()
    for seed in range(50):
        import random
        v = jittered_retry_after(30, rng=random.Random(seed))
        assert 24 <= v <= 36


# ---------------------------------------------------------------------------
# drain
# ---------------------------------------------------------------------------

def test_drain_stops_admission_and_finishes_inflight(model, oracle):
    server = _server(model)
    try:
        async def main():
            t = asyncio.ensure_future(do(
                server, "POST", "/v1/completions",
                completion_body(list(PROMPTS[0]), 6, stream=True)))
            deadline = time.perf_counter() + 60
            while not server._live:
                assert time.perf_counter() < deadline
                await asyncio.sleep(0.005)
            drainz = await do(server, "POST", "/drainz")
            refused = await do(server, "POST", "/v1/completions",
                               completion_body([1, 2], 2))
            ready = await do(server, "GET", "/readyz")
            statusz = await do(server, "GET", "/statusz")
            method = await do(server, "GET", "/drainz")
            return await t, drainz, refused, ready, statusz, method

        (status, _, body), drainz, refused, ready, statusz, method = \
            asyncio.run(main())
        assert status == 200 and _tokens(body) == oracle[tuple(PROMPTS[0])]
        assert sse_chunks(body)[-1]["choices"][0]["finish_reason"] == \
            "length"
        assert drainz[0] == 200 and json.loads(drainz[2])["draining"]
        assert refused[0] == 503
        err = json.loads(refused[2])["error"]
        assert "draining" in err["message"]
        assert 1 <= int(refused[1]["retry-after"]) <= 60
        assert ready[0] == 503 and method[0] == 405
        assert json.loads(statusz[2])["draining"] is True
        deadline = time.perf_counter() + 30
        while not server.drained():
            assert time.perf_counter() < deadline
            time.sleep(0.01)
    finally:
        server.close()
    assert server.drain(timeout_s=1.0)


def test_sigterm_dumps_then_drains_active_streams(model, oracle, tmp_path):
    """``serve_forever``'s order: the drain handler first, the flight
    recorder's SIGTERM hook over it; SIGTERM during two streams dumps, then
    drains, and both streams finish with the oracle's tokens."""
    fr = obs.FlightRecorder(path=str(tmp_path / "term.json"),
                            max_events=64, snapshot_every_s=1e9)
    server = _server(model, flight_recorder=fr)
    prev = signal.getsignal(signal.SIGTERM)
    try:
        server.install_drain_signal()
        fr.install(watchdog=False, sigterm=True, excepthook=False)

        async def main():
            tasks = [asyncio.ensure_future(do(
                server, "POST", "/v1/completions",
                completion_body(list(p), 6, stream=True)))
                for p in PROMPTS[:2]]
            deadline = time.perf_counter() + 60
            while len(server._live) < 2:
                assert time.perf_counter() < deadline
                await asyncio.sleep(0.005)
            os.kill(os.getpid(), signal.SIGTERM)
            return await asyncio.gather(*tasks)

        results = asyncio.run(main())
        assert server.draining
        doc = json.loads(open(fr.last_dump).read())
        assert doc["metadata"]["reason"] == "sigterm"
        for (status, _, body), p in zip(results, PROMPTS[:2]):
            assert status == 200 and _tokens(body) == oracle[tuple(p)]
        deadline = time.perf_counter() + 30
        while not server.drained():
            assert time.perf_counter() < deadline
            time.sleep(0.01)
    finally:
        fr.uninstall()
        signal.signal(signal.SIGTERM, prev)
        server.close()
    assert not obs.TRACER.enabled


def test_sigterm_drain_real_process(tmp_path):
    """A launcher-spawned replica (``--device cpu``) holding an active
    stream gets SIGTERM: the stream completes with its whole budget and the
    process exits 0 (``serve_forever``'s drain), never a mid-stream cut."""
    import http.client

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving", "--device", "cpu",
         "--port", str(port), "--max-batch", "2", "--max-seq-len", "256",
         "--prefill-bucket", "16", "--max-new-tokens", "48",
         "--set", "fleet_drain_timeout_s=60",
         "--set", f"flight_recorder_path={tmp_path / 'fr.json'}"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=2)
                conn.request("GET", "/readyz")
                ok = conn.getresponse().status == 200
                conn.close()
                if ok:
                    break
            except OSError:
                pass
            assert time.time() < deadline, "replica never became ready"
            assert proc.poll() is None, proc.stderr.read().decode()
            time.sleep(0.2)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/v1/completions",
                     completion_body([5, 6, 7, 8], 48, stream=True))
        resp = conn.getresponse()
        assert resp.status == 200
        first = resp.fp.readline()
        proc.send_signal(signal.SIGTERM)
        body = first + resp.read()
        conn.close()
        assert b"data: [DONE]" in body
        assert len(_tokens(body)) == 48
        finishes = [c["choices"][0]["finish_reason"] for c in
                    sse_chunks(body) if c["choices"][0]["finish_reason"]]
        assert finishes == ["length"]
        assert proc.wait(timeout=60) == 0
        # the flight recorder dumped first, then chained into the drain
        dumps = list(tmp_path.glob("fr_sigterm_p*.json"))
        assert len(dumps) == 1
        assert json.loads(dumps[0].read_text())["metadata"][
            "reason"] == "sigterm"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# flight recorder, engine crash, queue expiry
# ---------------------------------------------------------------------------

def test_flight_recorder_watchdog_dump_carries_request_ids(model, tmp_path):
    from paddle_tpu_torch.distributed.watchdog import CommTaskManager

    fr = obs.FlightRecorder(path=str(tmp_path / "fr.json"),
                            max_events=256, snapshot_every_s=0.0)
    manager = CommTaskManager()
    manager.poll_interval = 0.02
    server = _server(model, flight_recorder=fr, watchdog=manager)
    old = flags.get_flags(["comm_timeout_s"])
    try:
        status, headers, _ = asyncio.run(do(
            server, "POST", "/v1/completions",
            completion_body([1, 2, 3, 4, 5], 4, stream=True)))
        assert status == 200
        rid = headers["x-request-id"]
        # the engine steps ran under the watchdog and all ended
        assert manager.outstanding() == []
        manager.add_timeout_hook(fr._on_watchdog_timeout)
        flags.set_flags({"comm_timeout_s": 0})
        manager.start()
        manager.begin("t9-hung-engine-step")
        deadline = time.time() + 10
        while fr.last_dump is None and time.time() < deadline:
            time.sleep(0.02)
        doc = json.loads(open(fr.last_dump).read())
        assert doc["metadata"]["reason"] == "watchdog-t9-hung-engine-step"
        events = doc["traceEvents"]
        assert rid in [e["args"]["name"] for e in events if e["ph"] == "M"]
        names = {e["name"] for e in events
                 if e.get("args", {}).get("trace_id") == rid}
        assert "http.request" in names
        assert any(n.endswith(".decode") for n in names)
        assert any(e["name"] == "registry.snapshot" for e in events)
    finally:
        manager.shutdown()
        flags.set_flags(old)
        server.close()


def test_flight_recorder_sigterm_and_crash_hooks(tmp_path):
    fr = obs.FlightRecorder(path=str(tmp_path / "sig.json"),
                            max_events=64, snapshot_every_s=1e9)
    chained, seen = [], []
    prev = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    old_hook = sys.excepthook
    sys.excepthook = lambda *a: seen.append(a[0])
    try:
        fr.install(watchdog=False, sigterm=True, excepthook=True)
        obs.TRACER.instant("pre-sigterm-marker", tid="t9-lane")
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while not chained and time.time() < deadline:
            time.sleep(0.01)
        assert chained == [signal.SIGTERM]
        doc = json.loads(open(fr.last_dump).read())
        assert doc["metadata"]["reason"] == "sigterm"
        assert any(e.get("name") == "pre-sigterm-marker"
                   for e in doc["traceEvents"])
        try:
            raise RuntimeError("simulated crash")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        assert seen == [RuntimeError]
        assert json.loads(open(fr.last_dump).read())["metadata"][
            "reason"] == "crash-RuntimeError"
    finally:
        fr.uninstall()
        signal.signal(signal.SIGTERM, prev)
        sys.excepthook = old_hook
    assert not obs.TRACER.enabled and sys.excepthook is old_hook


def test_engine_crash_retires_streams_and_rejects_new(model, tmp_path):
    fr = obs.FlightRecorder(path=str(tmp_path / "ec.json"), max_events=64,
                            snapshot_every_s=1e9)
    eng = _engine(model)
    server = _server(model, engine=eng, flight_recorder=fr)
    try:
        def exploding_step(*a, **k):
            raise RuntimeError("injected step failure")

        eng.step = exploding_step
        status, _, body = asyncio.run(do(
            server, "POST", "/v1/completions",
            completion_body([1, 2, 3], 4, stream=True)))
        assert status == 200
        assert sse_chunks(body)[-1]["choices"][0]["finish_reason"] == \
            "error"
        assert json.loads(open(fr.last_dump).read())["metadata"][
            "reason"] == "engine-crash-RuntimeError"
        assert not server.engine_alive()
        assert asyncio.run(do(server, "GET", "/healthz"))[0] == 503
        status, _, body = asyncio.run(do(server, "POST", "/v1/completions",
                                         completion_body([1, 2, 3], 4)))
        assert status == 503
        assert "RuntimeError" in json.loads(body)["error"]["message"]
        with pytest.raises(RuntimeError, match="engine thread down"):
            server.run_on_engine(lambda e: e.B)
    finally:
        server.close()


def test_queue_expired_request_retired_504(model):
    obs.reset("serving.http.")
    old = flags.get_flags(["serving_queue_timeout_s"])
    flags.set_flags({"serving_queue_timeout_s": 0.05})
    try:
        # the slot holder runs ~100 steps, far past the 0.05 s bound
        server = _server(model, engine=_engine(
            model, max_batch=1, max_seq_len=128,
            gen=GenerationConfig(max_new_tokens=100)))
    finally:
        flags.set_flags(old)
    try:
        async def main():
            first = asyncio.ensure_future(do(
                server, "POST", "/v1/completions",
                completion_body(list(PROMPTS[0]), 100)))
            deadline = time.perf_counter() + 30
            while not any(r is not None for r in server.engine.slot_req):
                assert time.perf_counter() < deadline
                await asyncio.sleep(0.005)
            second = await do(server, "POST", "/v1/completions",
                              completion_body(list(PROMPTS[1]), 4))
            return await first, second

        (st1, _, body1), (st2, _, body2) = asyncio.run(main())
        assert st2 == 504
        err = json.loads(body2)["error"]
        assert err["type"] == "timeout_error"
        assert "expired in queue" in err["message"]
        assert st1 == 200
        assert obs.metrics.counter("serving.http.queue_expired").value == 1
        assert len(server.engine.waiting) == 0
    finally:
        server.close()


# ---------------------------------------------------------------------------
# /statusz
# ---------------------------------------------------------------------------

def _key_tree(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _key_tree(v, depth - 1) for k, v in d.items()}


def test_statusz_keys_equal_the_reference(model):
    """The same key set as the reference's /statusz, with ``torch`` and
    ``device`` in place of ``jax`` and ``backend``."""
    import paddle_tpu as paddle
    from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
    from paddle_tpu.inference import GenerationConfig as JGen
    from paddle_tpu.models import llama as jllama
    from paddle_tpu.serving import ServingServer as JServer

    paddle.seed(0)
    jeng = JEngine(jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny()),
                   max_batch=2, gen=JGen(max_new_tokens=6), max_seq_len=64,
                   page_size=8, prefill_bucket=8)
    jdoc = JServer(jeng, flight_recorder=None).statusz()
    server = _server(model, slo=None, flight_recorder=None)
    try:
        status, _, body = asyncio.run(do(server, "GET", "/statusz"))
        assert status == 200
        doc = json.loads(body)
        assert set(doc) == set(jdoc)
        jbuild = set(jdoc["build"]) - {"jax", "backend"} | {"torch",
                                                            "device"}
        assert set(doc["build"]) == jbuild
        assert doc["build"]["torch"] == torch.__version__
        assert doc["build"]["device"] == "cpu"
        assert doc["build"]["pid"] == os.getpid()
        for key in ("slo", "flight_recorder", "anomalies"):
            assert set(doc[key]) == set(jdoc[key]), key
        # the engine section: the reference's keys, and the port's step
        # count beside them
        assert set(doc["engine"]) - set(jdoc["engine"]) == {"steps"}
        assert set(jdoc["engine"]) <= set(doc["engine"])
        assert doc["engine"]["slots"] == 2 and doc["role"] == "mixed"
        assert "backend_compiles" in doc["jit_cache"]["jit"]
        assert doc["slo"]["quantile"] == flags.flag("serving_slo_quantile")
        assert doc["flags"]["metrics"] == flags.flag("metrics")
        assert doc["anomalies"] is not None and "checks" in doc["anomalies"]
        assert doc["flight_recorder"]["ring_capacity"] == \
            flags.flag("flight_recorder_events")
        assert isinstance(doc["inflight_requests"], list)
        assert doc["prefix_digest"] is None is jdoc["prefix_digest"]
    finally:
        server.close()


# ---------------------------------------------------------------------------
# /migratez and run_on_engine
# ---------------------------------------------------------------------------

def test_migratez_export_import_and_follow_up_hits(model):
    kw = dict(prefix_cache=True, max_seq_len=128,
              gen=GenerationConfig(max_new_tokens=12))
    a = _server(model, engine=_engine(model, **kw))
    b = _server(model, engine=_engine(model, **kw))
    prompt = list(range(1, 14))
    try:
        async def main():
            st, _, resp = await do(a, "POST", "/v1/completions",
                                   completion_body(prompt, 12))
            toks = json.loads(resp)["choices"][0]["token_ids"]
            st, _, resp = await do(a, "POST", "/migratez/export",
                                   json.dumps({"tokens": prompt + toks,
                                               "trace_id": "t9-sess"})
                                   .encode())
            assert st == 200
            doc = json.loads(resp)
            assert doc["sessions"][0]["pages"]
            assert doc["sessions"][0]["trace_id"] == "t9-sess"
            wire = json.dumps({"sessions": doc["sessions"]}).encode()
            st, _, _ = await do(b, "POST", "/migratez/import",
                                wire[: len(wire) // 2])
            assert st == 400                      # truncated: nothing in
            assert b.engine.prefix_cache.cached_pages() == 0
            st, _, resp = await do(b, "POST", "/migratez/import", wire)
            assert st == 200
            res = json.loads(resp)
            st, _, resp = await do(b, "POST", "/v1/completions",
                                   completion_body(prompt, 12))
            assert json.loads(resp)["choices"][0]["token_ids"] == toks
            bad = [await do(a, "POST", "/migratez/export", b"{not json"),
                   await do(a, "POST", "/migratez/export", b"{}"),
                   await do(a, "POST", "/migratez/export",
                            json.dumps({"req_id": 999}).encode()),
                   await do(a, "GET", "/migratez/import")]
            return res, [s for s, _, _ in bad]

        res, bad = asyncio.run(main())
        assert res["imported"] >= 1 and res["aborted"] == 0
        assert bad == [400, 400, 400, 405]
        assert b.engine.stats()["prefix_hits"] >= 1
        assert b.engine.stats()["migration_imported_pages"] == \
            res["imported"]
        alloc = b.engine.g.cache.allocator
        assert alloc.stats()["active_seqs"] == 0
        assert alloc.pages_in_use == b.engine.prefix_cache.cached_pages()
        # a draining replica adopts nothing; no prefix cache is a 409
        b.begin_drain()
        assert asyncio.run(do(b, "POST", "/migratez/import", json.dumps(
            {"sessions": []}).encode()))[0] == 503
        c = _server(model)
        try:
            assert asyncio.run(do(c, "POST", "/migratez/import", json.dumps(
                {"sessions": []}).encode()))[0] == 409
        finally:
            c.close()
    finally:
        a.close()
        b.close()


def test_migratez_import_decodes_off_the_event_loop(model, monkeypatch):
    """An import's body is parsed and its planes decoded on a worker
    thread: a stream on the replica keeps receiving tokens while the
    decode is held open.  The route's body bound is the pool's worth of
    base64 pages: past it a request is refused with 413 before its body is
    read, and below it a body larger than every other route's cap is
    read."""
    from paddle_tpu_torch.inference import migration as mig
    from paddle_tpu_torch.serving import http as _http
    srv = _server(model, engine=_engine(
        model, prefix_cache=True, max_seq_len=128, sync_every=2,
        gen=GenerationConfig(max_new_tokens=96)))
    prompt = list(range(1, 14))
    real = mig.from_wire
    chunks = []
    try:
        async def main():
            st, _, resp = await do(srv, "POST", "/v1/completions",
                                   completion_body(prompt, 4))
            toks = json.loads(resp)["choices"][0]["token_ids"]
            st, _, resp = await do(srv, "POST", "/migratez/export",
                                   json.dumps({"tokens": prompt + toks})
                                   .encode())
            wire = json.dumps({"sessions": json.loads(resp)["sessions"]})
            r, w = mem_conn(http_bytes("POST", "/v1/completions",
                                       completion_body([7, 6, 5], 96,
                                                       stream=True)))
            stream = asyncio.create_task(srv.handle(r, w))
            deadline = time.perf_counter() + 60
            while b"data: " not in w.buf:
                assert time.perf_counter() < deadline, "no first chunk"
                await asyncio.sleep(0.005)

            def held(snap):
                # the body's decode waits for two more chunks of the
                # stream: they arrive only while the event loop and the
                # engine run (the install's own pass over the decoded
                # snapshot is not held)
                if chunks:
                    return real(snap)
                n0 = w.buf.count(b"data: ")
                stop = time.perf_counter() + 30
                while w.buf.count(b"data: ") < n0 + 2 and \
                        time.perf_counter() < stop:
                    time.sleep(0.005)
                chunks.append((n0, w.buf.count(b"data: ")))
                return real(snap)

            monkeypatch.setattr(mig, "from_wire", held)
            st, _, resp = await do(srv, "POST", "/migratez/import",
                                   wire.encode())
            await stream
            return st, json.loads(resp), w.buf

        st, res, raw = asyncio.run(main())
        assert st == 200 and res["sessions"] == 1 and res["aborted"] == 0
        assert chunks and chunks[0][1] >= chunks[0][0] + 2
        assert len(_tokens(split_response(raw)[2])) == 96
        limit = srv._import_limit
        pool = srv.engine.g.cache
        page_bytes = sum(a[:, :, 0].numel() * a.element_size()
                         for a in pool.arrays)
        assert limit >= pool.allocator.num_pages * page_bytes * 4 // 3 \
            > 0
        head = "POST {} HTTP/1.1\r\nContent-Length: {}\r\n\r\n"
        over = [split_response(asyncio.run(_handled(srv, head.format(
            path, n).encode())))[0]
            for path, n in (("/migratez/import", limit + 1),
                            ("/v1/completions", _http.MAX_BODY + 1))]
        assert over == [413, 413]
        big = b" " * (_http.MAX_BODY + 1)
        assert asyncio.run(do(srv, "POST", "/migratez/import", big))[0] \
            == 400                      # read, then refused as bad JSON
    finally:
        srv.close()


async def _handled(srv, raw):
    r, w = mem_conn(raw)
    await srv.handle(r, w)
    return w.buf


def test_run_on_engine_and_export_sessions(model):
    srv = _server(model, engine=_engine(
        model, prefix_cache=True, gen=GenerationConfig(max_new_tokens=40),
        max_seq_len=128))
    try:
        assert srv.run_on_engine(lambda eng: eng.B) == 2
        with pytest.raises(ZeroDivisionError):
            srv.run_on_engine(lambda eng: 1 / 0)
        req = srv.run_on_engine(lambda eng: eng.submit(list(range(1, 20))))
        deadline = time.time() + 30
        while len(req.output) < 4:
            assert time.time() < deadline
            time.sleep(0.01)
        snaps = srv.export_sessions()
        assert [s["prompt_len"] for s in snaps] == [19]
        assert len(snaps[0]["pages"]) >= 2
    finally:
        srv.close()
    with pytest.raises(RuntimeError):
        srv.run_on_engine(lambda eng: eng.B)
