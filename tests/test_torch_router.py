"""The port's multi-replica router against the JAX package's, on the tiny
Llama (CPU tensors).

Host parity: the same ``/statusz`` documents and the same request
sequence, under a fake clock, go to both packages' ``Placer`` /
``ReplicaState`` (scored and round-robin placement, session affinity with
its LRU cap, the routed overlay's aging, digest deltas and sketches,
``weighted_rank``), ``request_signature``, ``PoisonQuarantine`` and
``SessionJournal``; their logs must be equal.  End to end: the port's
``RouterServer`` over two port replicas gives the greedy tokens of the
reference's ``RouterServer`` over two reference replicas (weights through
``load_reference_state``), streamed and unary; a replica killed mid-stream
resumes from the journal with the same tokens; a wedged stream head is a
502; fleet-wide shedding, ``/statusz`` and ``/metrics`` match the
reference's.
"""

import asyncio
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jobs
from paddle_tpu.controlplane import sketch as jsketch
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference import prefix_cache as jprefix
from paddle_tpu.models import llama as jllama
from paddle_tpu.router import InprocReplica as JInprocReplica
from paddle_tpu.router import RouterServer as JRouterServer
from paddle_tpu.router import journal as jjournal
from paddle_tpu.router import placement as jplacement
from paddle_tpu.router import quarantine as jquarantine
from paddle_tpu.serving import ServingServer as JServingServer
from paddle_tpu.serving import SLOController as JSLOController
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.controlplane import sketch
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.inference import prefix_cache
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.router import InprocReplica, RouterServer
from paddle_tpu_torch.router import journal, placement, quarantine
from paddle_tpu_torch.serving import ServingServer, SLOController
from paddle_tpu_torch.utils import load_reference_state

from test_observability import parse_prometheus
from test_serving_http import (MemWriter, completion_body, split_response,
                               sse_chunks)

torch.set_num_threads(2)

PROMPTS = ([1, 2, 3, 4, 5], [9, 8, 7], [4, 5, 6, 7])
GEOMETRY = dict(max_batch=2, max_seq_len=96, page_size=8, prefill_bucket=8)


# ---------------------------------------------------------------------------
# shared harness (the fleet and disaggregation tests import it)
# ---------------------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def pair():
    """The tiny Llama in both packages, with the same weights."""
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm


def engine(tm, **kw):
    kw = {**GEOMETRY, **kw}
    kw.setdefault("gen", GenerationConfig(max_new_tokens=6))
    return ContinuousBatchingEngine(tm, device="cpu", **kw)


def jengine(jm, **kw):
    kw = {**GEOMETRY, **kw}
    kw.setdefault("gen", JGen(max_new_tokens=6))
    return JEngine(jm, **kw)


def oracle_tokens(tm, prompts, new_tokens):
    """Greedy tokens of one direct port engine run per prompt."""
    eng = engine(tm, gen=GenerationConfig(max_new_tokens=new_tokens))
    rids = [eng.add_request(list(p)) for p in prompts]
    out = eng.run()
    return {tuple(p): out[r] for p, r in zip(prompts, rids)}


class Fleet:
    """N started replicas of one package and a router over them."""

    def __init__(self, servers, inproc, router_cls, policy="scored",
                 **router_kw):
        self.servers = servers
        self.replicas = [inproc(f"r{i}", s) for i, s in enumerate(servers)]
        router_kw.setdefault("health_interval_s", 1e9)
        self.router = router_cls(self.replicas, policy=policy, **router_kw)

    def close(self):
        for s in self.servers:
            s.close()


def port_fleet(tm, n=2, roles=None, engine_kw=None, slo=False,
               **router_kw):
    roles = roles or ["mixed"] * n
    servers = [ServingServer(engine(tm, **(engine_kw or {}).get(i, {})),
                             role=r, flight_recorder=False,
                             slo=(slo() if callable(slo) else slo)).start()
               for i, r in enumerate(roles)]
    return Fleet(servers, InprocReplica, RouterServer, **router_kw)


def ref_fleet(jm, n=2, roles=None, engine_kw=None, slo=False, **router_kw):
    roles = roles or ["mixed"] * n
    servers = [JServingServer(jengine(jm, **(engine_kw or {}).get(i, {})),
                              role=r, flight_recorder=False,
                              slo=(slo() if callable(slo) else slo)).start()
               for i, r in enumerate(roles)]
    return Fleet(servers, JInprocReplica, JRouterServer, **router_kw)


async def do(router, method, path, body=b"", headers=()):
    head = [f"{method} {path} HTTP/1.1", "Host: test"]
    head += [f"{k}: {v}" for k, v in headers]
    head.append(f"Content-Length: {len(body)}")
    r = asyncio.StreamReader()
    r.feed_data(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    r.feed_eof()
    w = MemWriter()
    await router.handle(r, w)
    return split_response(w.buf)


def completion(router, prompt, max_tokens, stream=False, headers=()):
    return do(router, "POST", "/v1/completions",
              completion_body(list(prompt), max_tokens, stream=stream),
              headers=headers)


def stream_tokens(body):
    """(token ids, finish reasons, completion ids) of an SSE body."""
    chunks = sse_chunks(body)
    toks = [t for c in chunks for t in c["choices"][0]["token_ids"]]
    finishes = [c["choices"][0]["finish_reason"] for c in chunks
                if c["choices"][0]["finish_reason"]]
    return toks, finishes, {c["id"] for c in chunks}


class FakeClient:
    def __init__(self, rid):
        self.id = rid

    def describe(self):
        return {"id": self.id, "transport": "fake"}


def _reset_router_series():
    obs.reset("router.")
    jobs.reset("router.")


def _drop_router_series():
    """Remove every ``router.*`` series from both registries.  ``reset``
    zeroes a series but keeps it, and ``/metrics`` lists every family a
    registry holds, so without this the families compared would depend on
    which tests ran earlier in the process (a reference control-plane test
    leaves ``router.forwarded`` in the reference's registry alone)."""
    for reg in (obs.REGISTRY, jobs.REGISTRY):
        with reg._lock:
            for table in (reg._counters, reg._gauges, reg._histograms):
                for key in [k for k in table if k[0].startswith("router.")]:
                    del table[key]


# ---------------------------------------------------------------------------
# host parity: placement, quarantine, journal
# ---------------------------------------------------------------------------

def _statusz_docs(hashes_a, hashes_b):
    bloom = sketch.CountingBloom.from_items(hashes_b, 4096, 4).wire()
    return [
        {"ready": True, "role": "prefill",
         "engine": {"waiting": 1, "slots_busy": 1, "tp": 1,
                    "pool_bytes": 1 << 30,
                    "sampling": {"do_sample": False}},
         "prefix_digest": {"page_size": 8, "hashes": hashes_a[:2],
                           "gen": "g0", "epoch": 3,
                           "spilled": [hashes_a[1]]}},
        {"ready": True, "role": "decode",
         "engine": {"waiting": 0, "slots_busy": 2, "pool_bytes": 2 << 30,
                    "sampling": {"do_sample": True, "seed": 3,
                                 "positional": True}},
         "prefix_digest": {"page_size": 8, "mode": "sketch",
                           "sketch": bloom},
         "slo": {"decision": "queue", "retry_after_s": 3},
         "anomalies": {"anomalies_total": 2, "recent": [{"t": 1.0}]}},
        {"ready": True, "engine": {}},
    ]


def _describe(states):
    out = []
    for s in states:
        d = s.describe(3)
        d.pop("last_poll_age_s")
        out.append(d)
    return out


def _placement_log(pk, policy):
    """One scripted run of a package's placement layer; returns its log."""
    prompt_a = list(range(1, 33))
    prompt_b = list(range(100, 124))
    ha = pk.block_hashes(prompt_a, 8)
    hb = pk.block_hashes(prompt_b, 8)
    states = [pk.ReplicaState(FakeClient(f"r{i}")) for i in range(3)]
    for s, doc in zip(states, _statusz_docs(ha, hb)):
        s.apply_statusz(doc, dead_after=3)
    placer = pk.Placer(policy=policy, session_cap=2)
    log = [(s.role, s.queue_depth, s.greedy, s.tp, s.pool_bytes,
            s.statusz_path(), s.expected_hits(ha), s.expected_hits(hb))
           for s in states]
    turns = [(prompt_a, None), (prompt_b, "s1"), (prompt_a, "s2"),
             (prompt_b, "s2"), (prompt_b + [1, 2, 3], "s3"), (prompt_a, "s1"),
             ([5, 6, 7], None), (prompt_b, "s2"), (prompt_a, "s3"),
             ([5, 6, 7], "s4"), (list(range(40, 60)), None)]
    for p, sid in turns:
        choice, reason = placer.place(p, sid, states)
        log.append((choice.id, reason, placer.pinned(sid),
                    placer.session_state()))
    # a digest delta against the confirmed epoch, then two polls that
    # never confirm the overlay's credits: they age out
    states[0].apply_statusz(
        {"ready": True, "role": "prefill", "engine": {},
         "prefix_digest": {"page_size": 8, "mode": "delta", "gen": "g0",
                           "epoch": 4, "adds": [ha[2]], "dels": [ha[0]]}},
        dead_after=3)
    log.append((sorted(states[0].digest), states[0].statusz_path(),
                len(states[0].routed)))
    for _ in range(2):
        for s in states:
            s.apply_statusz({"ready": True, "engine": {},
                             "prefix_digest": {"page_size": 8,
                                               "hashes": []}},
                            dead_after=3)
        log.append([len(s.routed) for s in states])
    # death and rejoin: the overlay is reset on a dead -> live transition
    states[1].credit_routed(hb, cap=3)
    for _ in range(3):
        states[1].mark_failed()
    log.append((states[1].status(3), list(states[1].routed)))
    states[1].apply_statusz({"ready": True, "draining": True,
                             "engine": {}}, dead_after=3)
    log.append((states[1].status(3), len(states[1].routed)))
    log.append(_describe(states))
    rank = pk.weighted_rank({"decode": 0, "mixed": 1, "prefill": 2})
    log.append([s.id for s in sorted(states, key=rank)])
    log.append([s.id for s in sorted(
        states, key=pk.weighted_rank({"mixed": 0, "decode": 1,
                                      "prefill": 2}, 0.0))])
    log.append(placer.repin("r0", "r2"))
    log.append({r: int(pk.metrics.counter("router.placement",
                                          reason=r).value)
                for r in ("affinity", "prefix", "load", "round_robin")})
    return log


class _Pkg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


PORT = _Pkg(ReplicaState=placement.ReplicaState, Placer=placement.Placer,
            weighted_rank=placement.weighted_rank,
            block_hashes=prefix_cache.block_hashes, metrics=obs.metrics,
            PoisonQuarantine=quarantine.PoisonQuarantine,
            request_signature=quarantine.request_signature,
            SessionJournal=journal.SessionJournal,
            CountingBloom=sketch.CountingBloom, BloomView=sketch.BloomView,
            fp_rate=sketch.fp_rate)
REF = _Pkg(ReplicaState=jplacement.ReplicaState, Placer=jplacement.Placer,
           weighted_rank=jplacement.weighted_rank,
           block_hashes=jprefix.block_hashes, metrics=jobs.metrics,
           PoisonQuarantine=jquarantine.PoisonQuarantine,
           request_signature=jquarantine.request_signature,
           SessionJournal=jjournal.SessionJournal,
           CountingBloom=jsketch.CountingBloom, BloomView=jsketch.BloomView,
           fp_rate=jsketch.fp_rate)


@pytest.mark.parametrize("policy", ["scored", "round_robin"])
def test_placement_matches_reference(policy):
    _reset_router_series()
    assert _placement_log(PORT, policy) == _placement_log(REF, policy)


def test_sketch_matches_reference():
    items = [f"{i:016x}" for i in range(300)]
    for pk in (PORT, REF):
        pk.bloom = pk.CountingBloom.from_items(items, 2048, 4)
        pk.bloom.remove(items[0])
    assert PORT.bloom.wire() == REF.bloom.wire()
    view, jview = PORT.BloomView(PORT.bloom.wire()), \
        REF.BloomView(REF.bloom.wire())
    probes = items + [f"x{i}" for i in range(300)]
    assert [p in view for p in probes] == [p in jview for p in probes]
    assert view.fp_bound() == jview.fp_bound()
    assert PORT.fp_rate(500, 65536, 4) == REF.fp_rate(500, 65536, 4)


def _quarantine_log(pk):
    clock = Clock()
    q = pk.PoisonQuarantine(strikes=2, ttl_s=10.0, cap=3, clock=clock)
    sig = [pk.request_signature([1, 2, 3], {"max_tokens": 4}),
           pk.request_signature([1, 2, 3], {"max_tokens": 4, "seed": 1,
                                            "stream": True}),
           pk.request_signature([7], {"temperature": 0.5, "top_k": 3}),
           pk.request_signature([8, 9], {}),
           pk.request_signature([8, 9, 10], {"do_sample": True})]
    log = [sig]
    script = [(0.0, "strike", 0), (1.0, "strike", 1), (1.5, "progress", 1),
              (2.0, "strike", 0), (2.5, "quarantined", 0),
              (3.0, "refuse", 0), (3.0, "strike", 2), (3.5, "strike", 3),
              (4.0, "strike", 4), (4.0, "quarantined", 0),
              (6.0, "progress", 0), (9.0, "refuse", 0),
              (12.5, "quarantined", 0), (12.5, "quarantined", 4),
              (13.0, "strike", 0), (20.0, "progress", 2),
              (30.0, "quarantined", 1)]
    for t, verb, i in script:
        clock.t = t
        log.append((t, verb, getattr(q, verb)(sig[i]), len(q)))
    log.append(q.state())
    off = pk.PoisonQuarantine(strikes=0, clock=clock)
    log.append((off.enabled, off.strike(sig[0]), off.quarantined(sig[0])))
    return log


def test_quarantine_matches_reference():
    _reset_router_series()
    assert _quarantine_log(PORT) == _quarantine_log(REF)


def _journal_log(pk):
    j = pk.SessionJournal(cap=3, max_tokens=10)
    log = []
    e = j.begin("t0", "s0", [1, 2], {"prompt": [1, 2], "max_tokens": 24,
                                     "stream": True})
    j.record(e, [5, 6])
    log.append((e.full_tokens, e.remaining(), e.resume_body(),
                e.capped_body(1), e.resumable))
    j.record(e, range(9))                # crosses the per-entry cap
    log.append((e.resumable, e.emitted, e.remaining()))
    for i in range(4):
        f = j.begin(f"t{i + 1}", None, [i], {"max_tokens": True})
        log.append((len(j), f.max_tokens, f.remaining()))
    log.append((e.resumable, len(j)))
    j.finish(f)
    j.finish(None)
    log.append((len(j), int(pk.metrics.counter(
        "router.journal_evictions").value)))
    empty = j.begin("t9", None, [], {})
    log.append(empty.resumable)
    return log


def test_journal_matches_reference():
    _reset_router_series()
    assert _journal_log(PORT) == _journal_log(REF)


# ---------------------------------------------------------------------------
# end to end over engines: the port's router against the reference's
# ---------------------------------------------------------------------------

def _serve_both(fleet, requests):
    """Drive ``requests`` ((prompt, max_tokens, stream), ...) through a
    fleet's router, in turn; returns [(status, replica, tokens, finish)]."""
    async def main():
        await fleet.router.poll_replicas()
        out = []
        for prompt, n, stream in requests:
            status, headers, body = await completion(fleet.router, prompt,
                                                      n, stream=stream)
            if stream:
                toks, finishes, _ = stream_tokens(body)
                finish = finishes[-1] if finishes else None
            else:
                choice = json.loads(body)["choices"][0]
                toks, finish = choice["token_ids"], choice["finish_reason"]
            out.append((status, headers.get("x-router-replica"), toks,
                        finish))
        return out
    return asyncio.run(main())


def test_router_tokens_match_reference_router(pair):
    """Streamed and unary completions through the port's router over two
    port replicas carry the reference router's greedy tokens, land on the
    same replicas and finish the same way."""
    jm, tm = pair
    _reset_router_series()
    requests = [(PROMPTS[0], 6, True), (PROMPTS[1], 6, False),
                (PROMPTS[2], 5, True), (PROMPTS[0], 4, False)]
    fleets = [port_fleet(tm), ref_fleet(jm)]
    try:
        got, want = (_serve_both(f, requests) for f in fleets)
    finally:
        for f in fleets:
            f.close()
    assert [g[0] for g in got] == [200] * len(requests)
    assert got == want


def test_kill_mid_stream_resumes_with_the_same_tokens(pair):
    """A replica killed after the first chunk: the journal replays the
    prompt and the relayed tokens on the survivor, and the client's one
    stream carries the reference engine's uninterrupted greedy tokens."""
    jm, tm = pair
    _reset_router_series()
    je = jengine(jm, gen=JGen(max_new_tokens=48))
    rid = je.add_request(list(PROMPTS[0]))
    want = je.run()[rid]
    fleet = port_fleet(tm)
    try:
        async def main():
            r = asyncio.StreamReader()
            body = completion_body(list(PROMPTS[0]), 48, stream=True)
            r.feed_data((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                         f"Content-Length: {len(body)}\r\n\r\n").encode()
                        + body)
            r.feed_eof()
            w = MemWriter()
            task = asyncio.create_task(fleet.router.handle(r, w))
            deadline = time.perf_counter() + 60
            while b"data: " not in w.buf:
                assert time.perf_counter() < deadline, "no first chunk"
                await asyncio.sleep(0.005)
            victim = split_response(w.buf)[1]["x-router-replica"]
            next(rep for rep in fleet.replicas if rep.id == victim).kill()
            await asyncio.wait_for(task, 60)
            statusz = await do(fleet.router, "GET", "/statusz")
            return w.buf, victim, json.loads(statusz[2])

        raw, victim, doc = asyncio.run(main())
    finally:
        fleet.close()
    status, _headers, body = split_response(raw)
    toks, finishes, ids = stream_tokens(body)
    assert status == 200 and len(ids) == 1
    assert finishes == ["length"]
    assert toks == want
    assert body.rstrip().endswith(b"data: [DONE]")
    assert doc["resume"]["outcomes"]["resumed"] >= 1
    assert doc["failover"]["stream"] >= 1
    states = {r["id"]: r["state"] for r in doc["replicas"]}
    assert states[victim] in ("suspect", "dead")


def test_wedged_stream_head_is_a_502(pair):
    """A replica that takes the dispatch and never writes a head fails the
    stream within the poll timeout: 502 and a failover count, no hang."""
    _jm, tm = pair
    _reset_router_series()
    fleet = port_fleet(tm, n=1, poll_timeout_s=0.2)
    try:
        real = fleet.replicas[0]

        class Wedged:
            id = real.id

            async def open(self, method, path, headers=(), body=b""):
                if method == "GET":
                    return await real.open(method, path, headers, body)
                return asyncio.StreamReader(), (lambda: None)

            def describe(self):
                return real.describe()

        fleet.router.states[0].client = Wedged()
        t0 = time.perf_counter()
        status, _h, _b = asyncio.run(completion(fleet.router, PROMPTS[0], 4,
                                                stream=True))
        took = time.perf_counter() - t0
    finally:
        fleet.close()
    assert status == 502
    assert took < 5.0
    assert obs.metrics.counter("router.failover", phase="stream").value >= 1


def test_fleet_wide_shedding_matches_reference(pair):
    """Every replica burns its TTFT SLO: both routers shed before dispatch
    with the same status, error type and body keys, and a Retry-After in
    the same range; neither engine saw the request."""
    jm, tm = pair
    out = {}
    for name, fleet_fn, reg, slo_cls, model in (
            ("port", port_fleet, obs, SLOController, tm),
            ("ref", ref_fleet, jobs, JSLOController, jm)):
        reg.reset("serving.")
        reg.reset("router.")
        fleet = fleet_fn(model, slo=lambda cls=slo_cls: cls(
            ttft_ms=100.0, itl_ms=0.0, quantile=0.95, burn=2.0,
            min_samples=8, window=64))
        try:
            ttft = reg.metrics.histogram("serving.ttft_ms")
            for _ in range(32):
                ttft.observe(5000.0)

            async def main():
                await fleet.router.poll_replicas()
                shed = await completion(fleet.router, [1, 2, 3], 2)
                st = await do(fleet.router, "GET", "/statusz")
                return shed, json.loads(st[2])

            (status, headers, body), doc = asyncio.run(main())
            err = json.loads(body)["error"]
            out[name] = dict(
                status=status, type=err["type"], keys=sorted(err),
                ra_ok=1 <= int(headers["retry-after"]) <= 60 and
                err["retry_after_s"] == int(headers["retry-after"]),
                decisions=[r["slo"]["decision"] for r in doc["replicas"]],
                shed=int(reg.metrics.counter("router.shed").value),
                served=[len(s.engine.completed) for s in fleet.servers])
        finally:
            fleet.close()
            reg.reset("serving.")
    assert out["port"] == out["ref"]
    assert out["port"]["status"] == 503 and out["port"]["ra_ok"]


def _keys(doc, depth=2):
    if not isinstance(doc, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in doc.items()}


def test_statusz_and_metrics_carry_the_reference_families(pair):
    """After one completion, the port's router /statusz has the
    reference's keys (two levels deep, per replica too) and /metrics the
    reference's router.* families; /healthz, 404 and 405 agree."""
    jm, tm = pair
    docs = {}
    for name, fleet_fn, model in (("port", port_fleet, tm),
                                  ("ref", ref_fleet, jm)):
        _drop_router_series()
        fleet = fleet_fn(model)
        try:
            async def main():
                c = await completion(fleet.router, PROMPTS[0], 4)
                m = await do(fleet.router, "GET", "/metrics")
                h = await do(fleet.router, "GET", "/healthz")
                s = await do(fleet.router, "GET", "/statusz")
                nf = await do(fleet.router, "GET", "/nope")
                bad = await do(fleet.router, "GET", "/v1/completions")
                return c, m, h, s, nf, bad

            c, m, h, s, nf, bad = asyncio.run(main())
        finally:
            fleet.close()
        fams = parse_prometheus(m[2].decode())
        doc = json.loads(s[2])
        docs[name] = dict(
            codes=(c[0], m[0], h[0], nf[0], bad[0]),
            health=json.loads(h[2]),
            router_fams=sorted(f for f in fams
                               if f.startswith("paddle_tpu_router_")),
            keys=_keys({k: v for k, v in doc.items()
                        if k not in ("replicas", "pid", "uptime_s")}),
            replica_keys=sorted(doc["replicas"][0]),
            states=[r["state"] for r in doc["replicas"]],
            role=doc["role"], policy=doc["policy"])
    assert docs["port"] == docs["ref"]
    assert docs["port"]["codes"] == (200, 200, 200, 404, 405)
    assert "paddle_tpu_router_placement" in docs["port"]["router_fams"]


def test_sampled_session_resumes_on_a_matching_seeded_survivor(pair):
    """A sampled stream killed mid-flight resumes on a survivor with the
    identical seeded positional sampling config: the client's tokens equal
    a no-fault run of the same fleet (held within the port: the packages
    sample with different generators)."""
    _jm, tm = pair
    gen = dict(max_new_tokens=32, do_sample=True, temperature=0.8,
               top_k=20, seed=7)
    want_eng = engine(tm, gen=GenerationConfig(**gen))
    rid = want_eng.add_request(list(PROMPTS[1]))
    want = want_eng.run()[rid]
    _reset_router_series()
    fleet = port_fleet(tm, engine_kw={i: {"gen": GenerationConfig(**gen)}
                                      for i in range(2)})
    try:
        async def main():
            await fleet.router.poll_replicas()
            r = asyncio.StreamReader()
            body = completion_body(list(PROMPTS[1]), 32, stream=True)
            r.feed_data((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                         f"Content-Length: {len(body)}\r\n\r\n").encode()
                        + body)
            r.feed_eof()
            w = MemWriter()
            task = asyncio.create_task(fleet.router.handle(r, w))
            deadline = time.perf_counter() + 60
            while b"data: " not in w.buf:
                assert time.perf_counter() < deadline, "no first chunk"
                await asyncio.sleep(0.005)
            victim = split_response(w.buf)[1]["x-router-replica"]
            next(rep for rep in fleet.replicas if rep.id == victim).kill()
            await asyncio.wait_for(task, 60)
            return w.buf

        raw = asyncio.run(main())
    finally:
        fleet.close()
    toks, finishes, _ = stream_tokens(split_response(raw)[2])
    assert finishes == ["length"]
    assert toks == want
    assert obs.metrics.counter("router.resumes",
                               outcome="resumed").value >= 1
