"""Tensor-parallel serving in the port against the JAX package and against
the port's own tp=1 engine, on the CPU at tiny sizes.

The port runs ONE engine over a list of shard devices (``device="cpu"``
puts every shard on the CPU): the KV pool's storage and attention shard
by kv head, grouped MoE by expert, and everything else runs once on shard
0's device.  Every token must be bit-identical to tp=1, so tokens are
compared exactly throughout, and the fp32 final hidden states of a tp=2
engine are ``torch.equal`` to tp=1's.

- Against the JAX engine at the same degree (greedy at tp 1/2/4, prefix
  hits, ``ngram`` speculative decoding), on conftest's 8-device virtual
  mesh.  The reference's ``jax.shard_map`` runs with the replication check
  off, as its own compatibility shim in ``paddle_tpu/__init__.py`` sets it
  for the jax it was written for: on the installed jax the check rejects
  the carry of its layer scan.
- Where the reference's own tensor-parallel tests fail (``fused`` spec,
  int8 pages, MoE expert sharding, warm steps, migration across degrees,
  digests), the port's tp>1 engine is held against the port's tp=1 engine
  and the JAX tp=1 engine's greedy tokens.
- The split route's plan on meta tensors: a tp=2 shard's launch plans
  from the global kv-head count, so it takes tp=1's route and split count
  at the llama2_7b and Mixtral decode shapes.
"""

import functools
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.inference import migration as mig
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

PROMPTS = ([1, 2, 3, 4, 5, 6, 7], [9, 8, 7], [4, 4, 2, 2, 6, 6])
GEOMETRY = dict(max_batch=3, max_seq_len=128, page_size=8, prefill_bucket=8)
NEW_TOKENS = 12
# the reference's tiny configs: qh 4 / kvh 2, qh 8 / kvh 4, Mixtral (top-2
# of 4 experts, grouped dispatch)
CONFIGS = {
    "tiny": ("tiny", dict(num_hidden_layers=2, max_position_embeddings=128)),
    "wide": ("tiny", dict(num_attention_heads=8, num_key_value_heads=4,
                          num_hidden_layers=2, max_position_embeddings=128)),
    "moe": ("mixtral_tiny", dict(num_hidden_layers=2,
                                 max_position_embeddings=128)),
}


class _Models:
    """The module's models, each built on first use: the JAX model (seed 7)
    and the port's model carrying its weights; and the JAX tp=1 engine's
    greedy tokens a case needs (the oracle of the cases whose reference
    tp>1 tests fail), each run once."""

    def __init__(self):
        self._pairs, self._greedy = {}, {}

    def pair(self, name):
        if name not in self._pairs:
            preset, kw = CONFIGS[name]
            paddle.seed(7)
            jm = jllama.LlamaForCausalLM(
                getattr(jllama.LlamaConfig, preset)(**kw))
            arrays = {k: np.asarray(v._data)
                      for k, v in jm.state_dict().items()}
            tm = llama.LlamaForCausalLM(
                getattr(llama.LlamaConfig, preset)(**kw), device="cpu")
            load_reference_state(tm, arrays)
            self._pairs[name] = jm, tm
        return self._pairs[name]

    def jax_greedy(self, name, **kw):
        key = (name, repr(sorted(kw.items())))
        if key not in self._greedy:
            self._greedy[key] = _jax_run(self.pair(name)[0], 1, **kw)[0]
        return self._greedy[key]


@pytest.fixture(scope="module")
def models():
    return _Models()


@pytest.fixture
def jax_tp(monkeypatch):
    """The reference's shard_map with the replication check off."""
    monkeypatch.setattr(jax, "shard_map",
                        functools.partial(jax.shard_map, check_vma=False))


def _engine(tm, tp=1, gen=None, **kw):
    geo = {**GEOMETRY, **kw}
    return ContinuousBatchingEngine(
        tm, tensor_parallel=tp, device="cpu",
        gen=gen or GenerationConfig(max_new_tokens=NEW_TOKENS), **geo)


def _run(tm, tp=1, prompts=PROMPTS, **kw):
    eng = _engine(tm, tp, **kw)
    rids = [eng.add_request(list(p)) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids], eng


def _jax_run(jm, tp=1, prompts=PROMPTS, gen=None, **kw):
    eng = JEngine(jm, tensor_parallel=tp,
                  gen=gen or JGen(max_new_tokens=NEW_TOKENS),
                  **{**GEOMETRY, **kw})
    rids = [eng.add_request(list(p)) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids], eng


# ---------------------------------------------------------------------------
# (a) against the JAX engine at the same degree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,tp", [("tiny", 1), ("tiny", 2), ("wide", 2),
                                     ("wide", 4)])
def test_greedy_matches_jax_at_the_same_degree(models, jax_tp, name, tp):
    jm, tm = models.pair(name)
    want, _ = _jax_run(jm, tp)
    got, eng = _run(tm, tp)
    assert got == want
    assert got == _run(tm, 1)[0]
    st = eng.stats()
    assert st["tp"] == tp and eng.g.tp == tp and len(eng.g.devices) == tp
    assert st["pool_bytes"] == eng.g.pool_bytes > 0


def test_prefix_hits_match_jax_at_tp2(models, jax_tp):
    jm, tm = models.pair("tiny")
    shared = [3, 1, 4, 1, 5, 9, 2, 6]
    prompts = [shared + [t] for t in (11, 12, 13)]
    want, je = _jax_run(jm, 2, prompts=prompts, prefix_cache=True)
    got, eng = _run(tm, 2, prompts=prompts, prefix_cache=True)
    assert got == want == _run(tm, 1, prompts=prompts, prefix_cache=True)[0]
    saved = eng.g.cache.allocator.prefix_tokens_saved
    # the shared prefix was hit on the sharded pool, not recomputed
    assert saved == je.g.cache.allocator.prefix_tokens_saved >= len(shared)


def test_ngram_spec_matches_jax_at_tp2(models, jax_tp):
    jm, tm = models.pair("tiny")
    prompts = ([1, 4, 1, 4, 1, 4, 1, 4, 1], [5, 6, 7, 5, 6, 7, 5, 6])
    kw = dict(spec_decode="ngram", spec_k=4)
    want, je = _jax_run(jm, 2, prompts=prompts, gen=JGen(max_new_tokens=16),
                        **kw)
    got, eng = _run(tm, 2, prompts=prompts,
                    gen=GenerationConfig(max_new_tokens=16), **kw)
    assert got == want
    st, jst = eng.stats(), je.stats()
    for key in ("spec_steps", "spec_drafted_tokens", "spec_accepted_tokens"):
        assert st[key] == jst[key], key
    assert st["spec_steps"] > 0


# ---------------------------------------------------------------------------
# (b) where the reference's tp>1 tests fail: the port's tp=1 engine and the
# JAX tp=1 engine's greedy tokens are the oracle
# ---------------------------------------------------------------------------

def test_fused_spec_at_tp2_equals_tp1(models):
    _, tm = models.pair("tiny")
    prompts = ([1, 4, 1, 4, 1, 4, 1, 4, 1], [5, 6, 7, 5, 6, 7, 5, 6])
    kw = dict(gen=GenerationConfig(max_new_tokens=16), spec_decode="fused",
              spec_k=4)
    base, _ = _run(tm, 1, prompts=prompts, **kw)
    got, eng = _run(tm, 2, prompts=prompts, **kw)
    assert got == base
    assert got == models.jax_greedy("tiny", prompts=prompts,
                              gen=JGen(max_new_tokens=16))
    assert eng.stats()["spec_steps"] > 0


def test_int8_pages_at_tp2_equal_tp1(models):
    _, tm = models.pair("tiny")
    base, e1 = _run(tm, 1, cache_dtype="int8")
    got, e2 = _run(tm, 2, cache_dtype="int8")
    assert got == base == models.jax_greedy("tiny", cache_dtype="int8")
    # per-(kv-head, page) scales shard with their heads: 4 planes a shard,
    # kvh / 2 heads each, the scratch page past num_pages on every shard
    c1, c2 = e1.g.cache, e2.g.cache
    assert len(c2.shards) == 2 and all(len(p) == 4 for p in c2.shards)
    assert c2.shards[0][0].shape[1] == c1.k.shape[1] // 2
    assert c2.shards[0][0].shape[2] == c2.allocator.num_pages + 1
    # the joined planes are tp=1's, bit for bit, on every page
    for page in range(c1.allocator.num_pages):
        for a, b in zip(c1.page_planes(page), c2.page_planes(page)):
            assert torch.equal(a, b), page
    with pytest.raises(RuntimeError, match="shards"):
        c2.arrays


def test_moe_expert_sharding_at_tp2_equals_tp1(models):
    _, tm = models.pair("moe")
    base, _ = _run(tm, 1)
    got, eng = _run(tm, 2)
    assert eng.g._moe_shards == 2     # the sharded branch ran
    assert got == base == models.jax_greedy("moe")
    # each shard's bank holds its half of the experts; shard 0's is a view
    # of the model's weights
    (d0, wg0, _, _), (_, wg1, _, _) = eng.g._banks[0]
    full = eng.g.params["blocks"][0]["mlp.experts_gate"]
    assert wg0.data_ptr() == full.data_ptr() and wg0.shape[0] == 2
    assert torch.equal(wg1, full[2:])


def _hidden_states(tm, tp, **kw):
    """Every step's final hidden states of one engine run."""
    eng = _engine(tm, tp, **kw)
    real, seen = eng.g._forward_tokens, []

    def record(*a, **k):
        h = real(*a, **k)
        seen.append(h.clone())
        return h

    eng.g._forward_tokens = record
    for p in PROMPTS:
        eng.add_request(list(p))
    eng.run()
    return seen


@pytest.mark.parametrize("name,kw", [("tiny", {}), ("wide", {}),
                                     ("tiny", {"cache_dtype": "int8"}),
                                     ("moe", {})])
def test_fp32_hidden_states_equal_tp1(models, name, kw):
    """(d) prefill and decode steps alike."""
    _, tm = models.pair(name)
    one, two = _hidden_states(tm, 1, **kw), _hidden_states(tm, 2, **kw)
    assert len(one) == len(two) > 2
    assert {h.shape[1] for h in one} == {1, GEOMETRY["prefill_bucket"]}
    for i, (a, b) in enumerate(zip(one, two)):
        assert a.dtype == torch.float32 and torch.equal(a, b), i


def test_sampled_seed_matrix_across_degrees(models):
    """(c) the same seed gives the same sampled stream at tp 1, 2 and 4; a
    different seed diverges."""
    _, tm = models.pair("wide")
    outs = {}
    for seed in (0, 42):
        gc = GenerationConfig(max_new_tokens=10, do_sample=True,
                              temperature=0.8, top_k=16, top_p=0.9,
                              seed=seed)
        for tp in (1, 2, 4):
            outs[(seed, tp)], _ = _run(tm, tp, gen=gc)
        assert outs[(seed, 2)] == outs[(seed, 1)], seed
        assert outs[(seed, 4)] == outs[(seed, 1)], seed
    assert outs[(0, 1)] != outs[(42, 1)]


# ---------------------------------------------------------------------------
# (e) degrees the heads or devices cannot take raise
# ---------------------------------------------------------------------------

def test_tp_requires_divisible_heads_and_devices(models, monkeypatch):
    _, tm = models.pair("tiny")
    with pytest.raises(ValueError, match="num_kv_heads"):
        _engine(tm, 3)                       # kvh 2 % 3 != 0
    with pytest.raises(ValueError, match="devices"):
        ContinuousBatchingEngine(tm, tensor_parallel=2, device=["cpu"])
    with pytest.raises(ValueError, match="devices"):
        ContinuousBatchingEngine(tm, tensor_parallel=2, device="cuda:0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="devices"):
        ContinuousBatchingEngine(tm, tensor_parallel=2, device="cuda")
    # a list of shard devices places the shards (repeats allowed)
    eng = ContinuousBatchingEngine(tm, tensor_parallel=2,
                                   device=["cpu", "cpu"], **GEOMETRY)
    assert [d.type for d in eng.g.devices] == ["cpu", "cpu"]
    assert [p[0].shape[1] for p in eng.g.cache.shards] == [1, 1]


# ---------------------------------------------------------------------------
# (f) warm steps build nothing and sync nothing
# ---------------------------------------------------------------------------

def test_warm_tp2_steps_build_and_sync_nothing(models):
    _, tm = models.pair("tiny")
    eng = _engine(tm, 2, sync_every=64,
                  gen=GenerationConfig(max_new_tokens=16))
    for p in PROMPTS:
        eng.add_request(list(p))
    first = eng.run()
    with obs.assert_overhead(max_compiles=0, max_syncs=0):
        for p in PROMPTS:
            eng.add_request(list(p))
        for _ in range(12):            # < sync_every: no drain inside
            eng.step()
    out = eng.run()
    assert all(len(v) == 16 for v in out.values())
    assert [out[r] for r in sorted(out)][-3:] == \
        [first[r] for r in sorted(first)]


# ---------------------------------------------------------------------------
# migration across degrees: one wire format at any shard count
# ---------------------------------------------------------------------------

PROMPT = list(range(1, 14))


def _partial(tm, tp, after):
    eng = _engine(tm, tp, prefix_cache=True,
                  gen=GenerationConfig(max_new_tokens=24))
    req = eng.submit(list(PROMPT))
    for _ in range(64):
        eng.step()
        if len(req.output) >= after:
            break
    eng._drain()
    assert not req.done and len(req.output) >= after
    return eng, req


@pytest.mark.parametrize("tp_from,tp_to", [(2, 1), (1, 2), (2, 2)])
def test_midstream_resume_across_degrees(models, tp_from, tp_to):
    """A tp=X session exported mid-stream resumes on a tp=Y engine: the
    planes are host-global, the importer re-shards, and the joined stream
    equals the no-fault run."""
    _, tm = models.pair("tiny")
    gen = GenerationConfig(max_new_tokens=24)
    oracle, _ = _run(tm, 1, prompts=[PROMPT], gen=gen, prefix_cache=True)
    assert oracle[0] == models.jax_greedy("tiny", prompts=(PROMPT,),
                                    gen=JGen(max_new_tokens=24))[0]
    a, req = _partial(tm, tp_from, 10)
    snap = mig.from_wire(mig.to_wire(mig.export_session(a, req_id=req.req_id)))
    b = _engine(tm, tp_to, prefix_cache=True, gen=gen)
    res = mig.import_session(b, snap, resume=True)
    assert res["imported"] == len(snap["pages"]) and res["skipped"] == 0
    out = b.run()[res["resume_req_id"]]
    assert snap["emitted"] + out == oracle[0]


def test_snapshot_digests_equal_across_degrees(models):
    _, tm = models.pair("tiny")
    snaps = [mig.export_session(eng, req_id=req.req_id)
             for eng, req in (_partial(tm, tp, 8) for tp in (1, 2))]
    assert snaps[0]["pages"] and snaps[0]["digest"] == snaps[1]["digest"]
    assert mig.snapshot_digest(snaps[0]) == mig.snapshot_digest(snaps[1])
    assert snaps[0]["geometry"] == snaps[1]["geometry"]


def test_cow_and_spill_under_shards_equal_tp1(models):
    """The prefix cache's copy-on-write and the spill ring run once per
    shard; the ring's slots hold host-global pages at any degree."""
    _, tm = models.pair("tiny")
    shared = list(range(20, 36))              # two whole pages
    waves = [[shared, shared + [7, 7, 7]], [list(range(40, 70))] * 2,
             [shared, shared + [8]]]
    runs = {}
    for tp in (1, 2):
        eng = _engine(tm, tp, num_pages=10, prefix_cache=True,
                      kv_spill_pages=4)
        outs = []
        for wave in waves:
            rids = [eng.add_request(list(p)) for p in wave]
            res = eng.run()
            outs.append([res[r] for r in rids])
        runs[tp] = (outs, eng.stats())
    assert runs[2][0] == runs[1][0]
    for key in ("prefix_hits", "cow_copies", "kv_spilled_pages",
                "kv_swapins"):
        assert runs[2][1][key] == runs[1][1][key], key
    assert runs[1][1]["cow_copies"] > 0 and runs[1][1]["kv_swapins"] > 0


# ---------------------------------------------------------------------------
# (g) the split route plans from the global kv-head count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,kvh,splits", [(32, 32, 1), (32, 8, 4)])
@pytest.mark.parametrize("T", [1, 64])
def test_shard_launch_plans_as_tp1(heads, kvh, splits, T):
    """llama2_7b (qh 32, kvh 32) and Mixtral (qh 32, kvh 8) decode and
    prefill launches at B 8, W 64, page 16: a tp=2 shard's launch takes
    tp=1's route and split count; planned from its own heads it would
    split twice as often."""
    B, W, page, d = 8, 64, 16, 128

    def plan(tp, **kw):
        q = torch.empty((B, T, heads // tp, d), dtype=torch.bfloat16,
                        device="meta")
        kc = torch.empty((kvh // tp, 512, page, d), dtype=torch.bfloat16,
                         device="meta")
        bt = torch.empty((B, W), dtype=torch.int32, device="meta")
        new = torch.empty((B, T, kvh // tp, d), dtype=torch.bfloat16,
                          device="meta")
        return pa.launch_plan(q, kc, bt, v_cache=kc, k_new=new, v_new=new,
                              **kw)

    one, shard = plan(1), plan(2, plan_kv_heads=kvh)
    assert shard["route"] == one["route"]
    assert shard["splits"] == one["splits"]
    if T == 1:
        assert one["route"] == "split" and one["splits"] == splits
        assert plan(2)["splits"] == 2 * splits
        # the partials workspace covers the shard's own heads
        assert shard["workspace"] == one["workspace"] // 2
    else:
        assert one["route"] == "sm90"
    with pytest.raises(ValueError, match="plan_kv_heads"):
        plan(2, plan_kv_heads=kvh + 1)


def test_launches_run_under_their_tensors_device(monkeypatch):
    """A shard on another card launches with that card current (its stream
    and its function attributes belong to it); a launch on the current
    card, or off the card, changes nothing."""
    import contextlib

    from paddle_tpu_torch.kernels import on_device
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for dev in ("cpu", "cuda", "cuda:0"):
        assert isinstance(on_device(torch.device(dev)),
                          contextlib.nullcontext)
    guard = on_device(torch.device("cuda:1"))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1


# ---------------------------------------------------------------------------
# (h) the launchers thread tensor_parallel to the engine
# ---------------------------------------------------------------------------

def test_engine_kwargs_thread_tensor_parallel(models):
    from paddle_tpu_torch.fleet.supervisor import InprocReplicaHandle
    from paddle_tpu_torch.serving.__main__ import build_parser, engine_kwargs

    args = build_parser().parse_args(
        ["--tensor-parallel", "2", "--cache-dtype", "int8", "--max-batch",
         "3", "--page-size", "8", "--device", "cpu,cpu"])
    kw = engine_kwargs(args)
    assert kw["tensor_parallel"] == 2 and kw["cache_dtype"] == "int8"
    assert kw["device"] == ["cpu", "cpu"] and kw["max_batch"] == 3
    assert "tensor_parallel" not in engine_kwargs(build_parser().parse_args(
        ["--device", "cpu"]))

    _, tm = models.pair("tiny")
    built = {}

    def factory(**ekw):
        built.update(ekw)
        return ContinuousBatchingEngine(tm, device="cpu",
                                        **{**GEOMETRY, **ekw})

    h = InprocReplicaHandle("r0", factory,
                            engine_kwargs={"tensor_parallel": 2,
                                           "max_batch": 2})
    h.spawn()
    try:
        deadline = time.perf_counter() + 120.0
        while not h.ready():
            assert time.perf_counter() < deadline, "replica never ready"
            time.sleep(0.05)
        assert built == {"tensor_parallel": 2, "max_batch": 2}
        assert h.server.engine.g.tp == 2
        st = h.server.statusz()["engine"]
        assert st["tp"] == 2 and st["pool_bytes"] == \
            h.server.engine.g.pool_bytes > 0
    finally:
        h.kill()
