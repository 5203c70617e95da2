"""The port's session migration against the JAX package's, on the tiny
Llama (CPU tensors).

Snapshots cross between the packages both ways: a snapshot the reference
exports (fp32 pool, int8 pool) goes through ``to_wire`` into the port, and
the port's export of the same token chain gives wire JSON equal to the
reference's and the same ``snapshot_digest``; a port bf16 pool's snapshot
imports into the reference with an equal digest.  A session the reference
exports mid-decode resumes in the port with the reference's uninterrupted
greedy tokens.  The engine-level cases of the reference's tests follow,
each ending with balanced allocator books.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference import migration as jmig
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.inference import migration as mig
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

GEOMETRY = dict(max_batch=2, max_seq_len=128, page_size=8, prefill_bucket=8,
                prefix_cache=True)
PROMPT = list(range(1, 14))
CHAIN = list(range(1, 34))              # 4 full pages of 8


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


def _engine(tm, **kw):
    kw = {**GEOMETRY, **kw}
    kw.setdefault("gen", GenerationConfig(max_new_tokens=24))
    return ContinuousBatchingEngine(tm, device="cpu", **kw)


def _jengine(jm, **kw):
    kw = {**GEOMETRY, **kw}
    kw.setdefault("gen", JGen(max_new_tokens=24))
    return JEngine(jm, **kw)


def _books_balanced(eng):
    """No dangling allocator reference: with no active sequence every
    allocated page belongs to the prefix-cache index."""
    alloc = eng.g.cache.allocator
    assert alloc.stats()["active_seqs"] == 0
    assert alloc.pages_in_use == eng.prefix_cache.cached_pages()


def _served(eng, tokens, new=2):
    """Serve ``tokens`` once so its full pages park in the index."""
    req = eng.submit(list(tokens), max_new_tokens=new)
    while not req.done:
        eng.step()
    eng._drain()
    return req


def _wire_json(snap):
    return json.dumps(snap, sort_keys=True)


@pytest.fixture(scope="module")
def ref_chains(pair):
    """The reference's wire snapshots of CHAIN, fp32 and int8 pools."""
    jm, _ = pair
    out = {}
    for dtype in (None, "int8"):
        je = _jengine(jm, cache_dtype=dtype)
        _served(je, CHAIN)
        out[dtype] = jmig.to_wire(jmig.export_session(je, tokens=CHAIN))
    return out


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_reference_snapshot_imports_and_reexports_identically(
        pair, ref_chains, dtype):
    """Reference -> wire -> port import -> port export of the same chain:
    wire JSON equal to the reference's, the same digest, the planes bit for
    bit in the port's pool; then the way back into the reference."""
    jm, tm = pair
    wire = json.loads(json.dumps(ref_chains[dtype]))
    te = _engine(tm, cache_dtype=dtype)
    res = mig.import_session(te, wire)
    assert res == {"imported": 4, "skipped": 0, "pages": 4,
                   "resume_req_id": None}
    _books_balanced(te)
    back = mig.to_wire(mig.export_session(te, tokens=CHAIN))
    assert _wire_json(back) == _wire_json(wire)
    assert back["digest"] == mig.snapshot_digest(mig.from_wire(wire)) == \
        jmig.snapshot_digest(jmig.from_wire(wire))
    assert back["geometry"]["dtype"] == (dtype or "float32")
    # the other way round: the port's wire into the reference
    je = _jengine(jm, cache_dtype=dtype)
    assert jmig.import_session(je, json.loads(json.dumps(back)))[
        "imported"] == 4
    again = jmig.to_wire(jmig.export_session(je, tokens=CHAIN))
    assert _wire_json(again) == _wire_json(back)


def test_port_bf16_snapshot_imports_into_the_reference(pair):
    """bf16 planes travel as raw 16-bit patterns labelled "bfloat16": the
    reference decodes them (numpy bfloat16) to the same digest and stores
    the same bits."""
    jm, tm = pair
    te = _engine(tm, cache_dtype="bfloat16")
    _served(te, CHAIN)
    snap = mig.export_session(te, tokens=CHAIN)
    assert snap["geometry"]["dtype"] == "bfloat16"
    assert snap["pages"][0]["planes"][0].dtype == torch.bfloat16
    wire = json.loads(json.dumps(mig.to_wire(snap)))
    assert wire["pages"][0]["planes"][0]["dtype"] == "bfloat16"
    assert jmig.snapshot_digest(jmig.from_wire(wire)) == snap["digest"]
    je = _jengine(jm, cache_dtype="bfloat16")
    assert jmig.import_session(je, wire)["imported"] == 4
    again = jmig.to_wire(jmig.export_session(je, tokens=CHAIN))
    assert _wire_json(again) == _wire_json(wire)
    # and the decoded planes are the port's bits
    back = mig.from_wire(wire)
    for pg, pg2 in zip(snap["pages"], back["pages"]):
        for p, p2 in zip(pg["planes"], pg2["planes"]):
            assert p.dtype == p2.dtype and torch.equal(
                p.view(torch.int16), p2.view(torch.int16))


def test_reference_session_resumes_in_the_port(pair):
    """The reference exports a session mid-decode; the port imports it with
    ``resume=True`` and its continuation equals the reference's
    uninterrupted greedy tokens, with every migrated page a prefix hit."""
    jm, tm = pair
    oracle_eng = _jengine(jm)
    rid = oracle_eng.add_request(list(PROMPT))
    oracle = oracle_eng.run()[rid]
    je = _jengine(jm)
    req = je.submit(list(PROMPT))
    while len(req.output) < 10:
        je.step()
    je._drain()
    assert not req.done
    wire = json.loads(json.dumps(jmig.to_wire(
        jmig.export_session(je, req_id=req.req_id))))
    te = _engine(tm)
    saved0 = te.g.cache.allocator.prefix_tokens_saved
    res = mig.import_session(te, wire, resume=True)
    assert res["imported"] == len(wire["pages"]) >= 2
    out = te.run()[res["resume_req_id"]]
    assert wire["emitted"] + out == oracle
    saved = te.g.cache.allocator.prefix_tokens_saved - saved0
    assert saved >= res["imported"] * te.g.page_size
    assert te.stats()["migration_imported_pages"] == res["imported"]


def test_in_flight_export_and_resume_within_the_port(pair):
    _, tm = pair
    o = _engine(tm)
    rid = o.add_request(list(PROMPT))
    oracle = o.run()[rid]
    a = _engine(tm)
    req = a.submit(list(PROMPT))
    for _ in range(64):
        a.step()
        if len(req.output) >= 10:
            break
    a._drain()
    syncs = obs.metrics.counter("host.device_syncs").value
    snap = mig.export_session(a, req_id=req.req_id)
    # one marked readback for the write cursor and one a page
    assert obs.metrics.counter("host.device_syncs").value == \
        syncs + 1 + len(snap["pages"])
    assert snap["emitted"] == req.output and snap["n_ctx"] >= 8
    assert snap["sampling"] == {"do_sample": False, "seed": 0,
                                "temperature": 1.0, "top_k": 0,
                                "top_p": 1.0, "positional": True}
    b = _engine(tm)
    res = mig.import_session(b, snap, resume=True)
    assert snap["emitted"] + b.run()[res["resume_req_id"]] == oracle
    assert a.stats()["migration_exported_pages"] == len(snap["pages"])
    all_snaps = mig.export_all(a)
    assert [s["emitted"] for s in all_snaps] == [req.output]


def test_export_requires_exactly_one_selector(pair):
    eng = _engine(pair[1])
    with pytest.raises(ValueError):
        mig.export_session(eng)
    with pytest.raises(ValueError):
        mig.export_session(eng, req_id=0, tokens=[1, 2])
    with pytest.raises(mig.MigrationError):
        mig.export_session(eng, req_id=12345)


def test_wire_codec_roundtrip_int8(pair):
    eng = _engine(pair[1], cache_dtype="int8")
    _served(eng, PROMPT, new=6)
    snap = mig.export_session(eng, tokens=PROMPT)
    assert snap["pages"]
    back = mig.from_wire(json.loads(json.dumps(mig.to_wire(snap))))
    for pg, pg2 in zip(snap["pages"], back["pages"]):
        for p, p2 in zip(pg["planes"], pg2["planes"]):
            assert p.dtype == p2.dtype and p.shape == p2.shape
            assert torch.equal(p, p2)
    assert [p.dtype for p in back["pages"][0]["planes"]] == \
        [torch.int8, torch.int8, torch.float32, torch.float32]
    assert back["geometry"]["dtype"] == "int8"


def test_geometry_mismatch_and_no_prefix_cache_rejected(pair):
    _, tm = pair
    a = _engine(tm)
    _served(a, PROMPT, new=4)
    snap = mig.export_session(a, tokens=PROMPT)
    b = _engine(tm, page_size=16)
    with pytest.raises(mig.MigrationError):
        mig.import_session(b, snap)
    _books_balanced(b)
    with pytest.raises(mig.MigrationError):
        mig.import_session(_engine(tm, prefix_cache=False), snap)
    with pytest.raises(mig.MigrationError):
        mig.import_session(_engine(tm, cache_dtype="int8"), snap)


def test_import_under_pool_pressure_evicts_never_deadlocks(pair):
    _, tm = pair
    a = _engine(tm, max_seq_len=64)
    _served(a, range(1, 25))                       # 3 full pages
    snap = mig.export_session(a, tokens=list(range(1, 25)))
    assert len(snap["pages"]) == 3
    b = _engine(tm, max_seq_len=64, num_pages=4)
    b.add_request(list(range(40, 57)), max_new_tokens=4)   # 2 idle pages
    b.run()
    evicted0 = b.g.cache.allocator.evicted_pages
    assert mig.import_session(b, snap)["imported"] == 3
    assert b.g.cache.allocator.evicted_pages > evicted0
    _books_balanced(b)


def test_abort_mid_transfer_leaves_no_refs(pair):
    _, tm = pair
    o = _engine(tm)
    rid = o.add_request(list(PROMPT))
    oracle = o.run()[rid]
    a = _engine(tm)
    req = a.submit(list(PROMPT))
    while len(req.output) < 12:
        a.step()
    a._drain()
    snap = mig.export_session(a, req_id=req.req_id)
    assert len(snap["pages"]) >= 3
    b = _engine(tm)
    alloc = b.g.cache.allocator
    real = alloc.acquire_page
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 3:
            raise MemoryError("transfer died on page 3")
        return real()

    alloc.acquire_page = flaky
    with pytest.raises(MemoryError):
        mig.import_session(b, snap)
    alloc.acquire_page = real
    assert b.stats()["migration_aborts"] == 1
    assert b.stats()["migration_imported_pages"] == 2
    _books_balanced(b)
    res = mig.import_session(b, snap)             # the retry skips 2
    assert res["skipped"] == 2
    assert res["imported"] == len(snap["pages"]) - 2
    _books_balanced(b)
    r = b.submit(list(PROMPT) + list(snap["emitted"]),
                 max_new_tokens=24 - len(snap["emitted"]))
    while not r.done:
        b.step()
    b._drain()
    assert snap["emitted"] + r.output == oracle
    # the bulk path isolates a bad snapshot and installs the rest
    c = _engine(tm)
    bad = dict(snap, geometry=dict(snap["geometry"], page_size=4))
    total = mig.import_sessions(c, [bad, snap])
    assert total["aborted"] == 1 and total["imported"] == len(snap["pages"])


def test_a_device_copy_error_propagates_and_releases_the_page(pair,
                                                             monkeypatch):
    """What a bad snapshot raises is isolated per session; an error from
    the device copy itself (a CUDA error is a RuntimeError) is not: it
    fails the bulk call, and the in-flight page's reference still goes
    back."""
    _, tm = pair
    a = _engine(tm)
    _served(a, CHAIN)
    snap = mig.export_session(a, tokens=CHAIN)
    b = _engine(tm)

    def broken(engine, page_id, planes):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(mig, "_install_page", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        mig.import_sessions(b, [snap])
    _books_balanced(b)
    assert b.prefix_cache.cached_pages() == 0


def test_partial_snapshot_imports_a_contiguous_prefix(pair):
    _, tm = pair
    a = _engine(tm)
    _served(a, CHAIN)
    snap = mig.export_session(a, tokens=CHAIN)
    n = len(snap["pages"])
    assert n == 4
    cut = dict(snap, pages=snap["pages"][: n // 2])
    cut.pop("digest")                 # a hand-built partial, not corruption
    b = _engine(tm)
    assert mig.import_session(b, cut)["imported"] == n // 2
    _books_balanced(b)
    gappy = dict(snap, pages=[snap["pages"][0], snap["pages"][2]])
    gappy.pop("digest")
    c = _engine(tm)
    assert mig.import_session(c, gappy)["imported"] == 1
    _books_balanced(c)


def test_corrupt_snapshot_rejected_with_nothing_installed(pair):
    _, tm = pair
    a = _engine(tm)
    _served(a, CHAIN)
    snap = mig.export_session(a, tokens=CHAIN)
    wire = mig.to_wire(snap)
    assert wire["digest"] == snap["digest"] == \
        mig.snapshot_digest(mig.from_wire(wire))
    rej = obs.metrics.counter("serving.kv.migration_rejected")
    rej0 = rej.value
    b = _engine(tm)
    free0 = b.g.cache.allocator.free_pages
    with pytest.raises(mig.MigrationError, match="digest"):
        mig.import_session(b, dict(snap, pages=snap["pages"][:2]))
    # one flipped byte in a plane, still valid base64
    bad = json.loads(json.dumps(wire))
    plane = bad["pages"][1]["planes"][0]
    import base64
    raw = bytearray(base64.b64decode(plane["b64"]))
    raw[7] ^= 0x01
    plane["b64"] = base64.b64encode(bytes(raw)).decode("ascii")
    with pytest.raises(mig.MigrationError, match="digest"):
        mig.import_session(b, bad)
    assert b.g.cache.allocator.free_pages == free0
    assert b.prefix_cache.cached_pages() == 0
    assert b.stats()["migration_rejected"] == 2 and rej.value == rej0 + 2
    assert mig.import_session(b, snap)["imported"] == len(snap["pages"])
    _books_balanced(b)


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_spilled_prefix_ships_its_ring_bytes(pair, dtype):
    """A parked session whose pages were spilled to the host ring exports
    the ring bytes (no swap-in); the importer stores them bit for bit and
    the next turn on it hits them, token for token the source's."""
    _, tm = pair
    S = list(range(1, 17))                # 2 full pages of 8

    def eng():
        return _engine(tm, max_seq_len=64, num_pages=8, kv_spill_pages=8,
                       gen=GenerationConfig(max_new_tokens=8),
                       cache_dtype=dtype)

    src = eng()
    r0 = src.add_request(S + [30])
    first = src.run()[r0]
    for i in range(3):                    # crush the pool: S spills
        src.add_request(list(range(60 + 8 * i, 76 + 8 * i)),
                        max_new_tokens=12)
    src.run()
    assert src.prefix_cache.spilled_pages() >= 2
    swapins0 = src.spill.swapins
    snap = mig.export_session(src, tokens=S)
    assert src.spill.swapins == swapins0
    assert [p["source"] for p in snap["pages"]] == ["spill", "spill"]
    dst = eng()
    assert mig.import_session(dst, mig.to_wire(snap))["imported"] == 2
    for node, pg in zip(dst.prefix_cache.chain(S), snap["pages"]):
        for plane, arr in zip(pg["planes"], dst.g.cache.arrays):
            assert torch.equal(plane, arr[:, :, node.page])
    r1 = dst.add_request(S + [30])
    assert dst.run()[r1] == first
    assert dst.g.cache.allocator.prefix_tokens_saved >= 16
