"""The port's ServingServer, driven through IN-PROCESS transports (no
sockets): streamed ``/v1/completions`` tokens equal a direct port-engine run
and the JAX engine on the same weights; ``/healthz`` and ``/readyz`` report
liveness and post-warmup readiness; bad requests get their status codes.

The registry is process-wide, and a server's SLO controller sheds on the
``serving.ttft_ms`` / ``serving.itl_ms`` observations already in it (the
reference's controller counts them too).  Another file's engines, run in
the same worker before this one, can leave enough slow observations there
to shed this file's first requests; so each server here is built on empty
``serving.`` series (``_serve``), and the file leaves them empty.
"""

import asyncio
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import ContinuousBatchingEngine, GenerationConfig
from paddle_tpu_torch.models import llama
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.serving import ServingServer
from paddle_tpu_torch.serving.slo import SHED, SLOController
from paddle_tpu_torch.serving.__main__ import (build_engine, build_parser,
                                               engine_kwargs)
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

GEOM = dict(max_batch=2, max_seq_len=64, page_size=8, prefill_bucket=8)
PROMPTS = ([1, 2, 3, 4, 5], [9, 8, 7], list(range(20, 41)))


class MemWriter:
    def __init__(self):
        self.buf = bytearray()

    def write(self, b):
        self.buf.extend(b)

    async def drain(self):
        pass

    def close(self):
        pass

    async def wait_closed(self):
        pass


async def request(server, method, path, body=b""):
    r = asyncio.StreamReader()
    r.feed_data((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    r.feed_eof()
    w = MemWriter()
    await server.handle(r, w)
    head, _, payload = bytes(w.buf).partition(b"\r\n\r\n")
    return int(head.split()[1]), payload


def sse_ids(payload: bytes):
    ids, finish = [], None
    for ln in payload.decode().splitlines():
        if ln.startswith("data: ") and ln != "data: [DONE]":
            ch = json.loads(ln[6:])["choices"][0]
            ids.extend(ch["token_ids"])
            finish = ch["finish_reason"] or finish
    return ids, finish


def completion(prompt, max_tokens, stream):
    return json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                       "stream": stream}).encode()


def _serve(engine, **kw):
    """A server over ``engine`` whose SLO controller starts from empty
    ``serving.`` series."""
    obs.reset("serving.")
    return ServingServer(engine, **kw)


@pytest.fixture(scope="module", autouse=True)
def _serving_series_left_empty():
    obs.reset("serving.")
    yield
    obs.reset("serving.")


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm


@pytest.fixture(scope="module")
def oracles(models):
    """Direct port-engine and JAX-engine outputs for PROMPTS."""
    jm, tm = models
    je = JEngine(jm, gen=JGen(max_new_tokens=6), **GEOM)
    te = ContinuousBatchingEngine(tm, gen=GenerationConfig(max_new_tokens=6),
                                  device="cpu", **GEOM)
    jr = [je.add_request(p) for p in PROMPTS]
    tr = [te.add_request(p) for p in PROMPTS]
    jo, to = je.run(), te.run()
    return [to[r] for r in tr], [jo[r] for r in jr]


@pytest.fixture
def server(models):
    eng = ContinuousBatchingEngine(models[1],
                                   gen=GenerationConfig(max_new_tokens=6),
                                   device="cpu", **GEOM)
    srv = _serve(eng, warmup=True)
    yield srv
    srv.close()


def _wait_ready(srv, timeout=30.0):
    t0 = time.perf_counter()
    while not srv.ready():
        assert time.perf_counter() - t0 < timeout, "warmup did not finish"
        time.sleep(0.01)


def test_stream_matches_engine_and_jax(server, oracles):
    port_direct, jax_direct = oracles
    assert port_direct == jax_direct
    server.start()
    _wait_ready(server)

    async def go():
        return await asyncio.gather(*[
            request(server, "POST", "/v1/completions",
                    completion(p, 6, True)) for p in PROMPTS])

    res = asyncio.run(go())
    for (status, payload), want in zip(res, port_direct):
        assert status == 200
        ids, finish = sse_ids(payload)
        assert ids == want and finish == "length"


def test_health_and_ready_after_warmup(server):
    async def probe():
        return (await request(server, "GET", "/healthz"),
                await request(server, "GET", "/readyz"))

    (hs, _), (rs, rb) = asyncio.run(probe())
    assert hs == 503 and rs == 503               # engine thread not started
    assert json.loads(rb)["ready"] is False
    server.start()
    _wait_ready(server)
    (hs, hb), (rs, rb) = asyncio.run(probe())
    assert hs == 200 and json.loads(hb)["status"] == "ok"
    assert rs == 200 and json.loads(rb) == {"ready": True, "status": "ok"}
    # warmup drove both step shapes: T=bucket prefill chunks and T=1 decode
    assert server.engine.steps >= 2
    assert server.engine.g.cache.allocator.pages_in_use == 0


def test_unary_completion_and_errors(models, oracles):
    eng = ContinuousBatchingEngine(models[1],
                                   gen=GenerationConfig(max_new_tokens=6),
                                   device="cpu", num_pages=4, **GEOM)
    srv = _serve(eng).start()
    _wait_ready(srv)

    async def go():
        return [await request(srv, m, p, b) for m, p, b in (
            ("POST", "/v1/completions", completion(PROMPTS[1], 6, False)),
            ("POST", "/v1/completions", b"{not json"),
            ("POST", "/v1/completions", completion([1, 256], 4, False)),
            ("POST", "/v1/completions", completion([1, 2], 0, False)),
            ("POST", "/v1/completions", completion([1] * 40, 4, False)),
            ("GET", "/v1/completions", b""),
            ("GET", "/nope", b""))]

    try:
        res = asyncio.run(go())
    finally:
        srv.close()
    status, body = res[0]
    out = json.loads(body)
    assert status == 200
    assert out["choices"][0]["token_ids"] == oracles[0][1]
    assert out["usage"] == {"prompt_tokens": 3, "completion_tokens": 6,
                            "total_tokens": 9}
    # bad JSON, out-of-vocab id, bad max_tokens, a prompt needing more
    # pages (5) than the pool has (4), wrong method, unknown route
    assert [s for s, _ in res[1:]] == [400, 400, 400, 413, 405, 404]


def test_slow_observations_left_by_another_file_shed_nothing_here(
        models, oracles):
    """64 synthetic 1000 ms ITLs in the registry (what a slow engine of an
    earlier file leaves): a controller built on them sheds, which is how
    this file's streamed and unary requests got 503s.  A server built by
    ``_serve`` answers both with 200 and the oracle's tokens."""
    itl = obs.histogram("serving.itl_ms")
    for _ in range(64):
        itl.observe(1000.0)
    assert SLOController().decide(record=False) == SHED
    eng = ContinuousBatchingEngine(models[1],
                                   gen=GenerationConfig(max_new_tokens=6),
                                   device="cpu", **GEOM)
    srv = _serve(eng, warmup=True).start()
    _wait_ready(srv)

    async def go():
        return await asyncio.gather(
            request(srv, "POST", "/v1/completions",
                    completion(PROMPTS[0], 6, True)),
            request(srv, "POST", "/v1/completions",
                    completion(PROMPTS[1], 6, False)))

    try:
        (s_stream, p_stream), (s_unary, p_unary) = asyncio.run(go())
    finally:
        srv.close()
    assert (s_stream, s_unary) == (200, 200)
    assert sse_ids(p_stream) == (oracles[0][0], "length")
    assert json.loads(p_unary)["choices"][0]["token_ids"] == oracles[0][1]


def test_launcher_builds_the_engine_from_args():
    args = build_parser().parse_args(
        ["--preset", "tiny", "--device", "cpu", "--max-batch", "3",
         "--page-size", "8", "--set", "kv_cache_dtype=fp32"])
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.serving.__main__ import apply_flag_sets
    old = flags.get_flags(["kv_cache_dtype"])
    try:
        apply_flag_sets(args.flag_sets)
        eng = build_engine(args)
    finally:
        flags.set_flags(old)
    assert eng.B == 3 and eng.g.page_size == 8 and eng.g.max_seq_len == 1024
    assert eng.g.cache.k.dtype == torch.float32
    assert engine_kwargs(build_parser().parse_args([]))["device"] == "cuda"
    with pytest.raises(SystemExit):
        apply_flag_sets(["no_such_flag=1"])


def test_launcher_moe_preset_depth_cut_and_int8_pool():
    """``--preset mixtral_tiny --num-layers 1 --cache-dtype int8``: an MoE
    model cut to one layer over an int8 pool, served end to end."""
    args = build_parser().parse_args(
        ["--preset", "mixtral_tiny", "--num-layers", "1", "--device", "cpu",
         "--max-seq-len", "64", "--page-size", "8", "--prefill-bucket", "8",
         "--cache-dtype", "int8"])
    eng = build_engine(args)
    c = eng.g.config
    assert (c.num_hidden_layers, c.moe_num_experts) == (1, 4)
    assert eng.stats()["kv_cache_dtype"] == "int8"
    rid = eng.add_request([3, 1, 4, 1, 5], 4)
    assert len(eng.run()[rid]) == 4
