"""The port's generator and continuous-batching engine against the JAX
package on the tiny Llama (CPU tensors: the plain attention path).

Greedy token ids are compared exactly: both packages compute the same fp32
function from the same weights, and argmax takes the first maximum in
both.  Sampled output is held only inside the port (its counter-based
generator is not JAX's threefry): seed-deterministic whatever the batch
composition.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference import LlamaGenerator as JGenerator
from paddle_tpu.inference import PageAllocator as JAllocator
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig, LlamaGenerator,
                                        PageAllocator)
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm


def _run_both(pair, requests, gen_kw, **kw):
    """Run the same requests through both engines; returns the two
    {position: tokens} maps and the port engine."""
    jm, tm = pair
    je = JEngine(jm, gen=JGen(**gen_kw), **kw)
    te = ContinuousBatchingEngine(tm, gen=GenerationConfig(**gen_kw),
                                  device="cpu", **kw)
    jr = [je.add_request(p, n) for p, n in requests]
    tr = [te.add_request(p, n) for p, n in requests]
    jo, to = je.run(), te.run()
    return [jo[r] for r in jr], [to[r] for r in tr], te


def _mixed_workload(seed=1):
    """12 requests, prompts 16-96 tokens, budgets 8-32."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 256, int(rng.integers(16, 97))).tolist(),
             int(rng.integers(8, 33))) for _ in range(12)]


MIXED = dict(max_batch=4, max_seq_len=128, page_size=16, prefill_bucket=32)


def test_generate_greedy_matches_jax(pair):
    jm, tm = pair
    prompts = [[1, 2, 3, 4, 5], list(range(7, 20)), list(range(30, 60))]
    kw = dict(max_batch=3, max_seq_len=64, page_size=16, prefill_bucket=8)
    want = JGenerator(jm, **kw).generate(prompts, JGen(max_new_tokens=10))
    got = LlamaGenerator(tm, device="cpu", **kw).generate(
        prompts, GenerationConfig(max_new_tokens=10))
    assert got == want
    assert all(len(r) == 10 for r in got)


def test_engine_mixed_workload_matches_jax(pair):
    reqs = _mixed_workload()
    want, got, te = _run_both(pair, reqs, dict(max_new_tokens=32), **MIXED)
    assert got == want
    assert [len(g) for g in got] == [n for _, n in reqs]
    st = te.stats()
    assert st["pages_in_use"] == 0 and st["active_seqs"] == 0
    assert st["steps"] == te.steps > 0


def test_engine_eos_trim_matches_jax(pair):
    reqs = _mixed_workload(seed=2)[:6]
    e = ContinuousBatchingEngine(pair[1], gen=GenerationConfig(
        max_new_tokens=32), device="cpu", **MIXED)
    rids = [e.add_request(p, n) for p, n in reqs]
    plain = [e.run()[r] for r in rids]
    eos = plain[0][3]                     # a token the model does emit
    want, got, _ = _run_both(pair, reqs,
                             dict(max_new_tokens=32, eos_token_id=eos),
                             **MIXED)
    assert got == want
    assert got[0] == plain[0][:4]


def test_engine_undersized_pool_matches_jax(pair):
    """num_pages below the dense worst case: a sequence whose decode growth
    finds the pool dry is finalized early with a capped output — the same
    cap in both engines — and every page returns to the pool."""
    reqs = [([1, 2, 3, 4, 5], 40), ([7, 8, 9], 40)]
    want, got, te = _run_both(pair, reqs, dict(max_new_tokens=40),
                              max_batch=2, max_seq_len=64, page_size=8,
                              prefill_bucket=8, num_pages=3)
    assert got == want
    assert all(1 <= len(g) < 40 for g in got)
    alloc = te.g.cache.allocator
    assert alloc.free_pages == alloc.num_pages
    assert alloc.stats()["peak_in_use"] == 3


def test_engine_capacity_freeze_matches_jax(pair):
    """A request frozen at cache capacity returns exactly the tokens that
    fit (max_seq - prompt)."""
    reqs = [(list(range(1, 11)), 50)]
    want, got, _ = _run_both(pair, reqs, dict(max_new_tokens=50),
                             max_batch=2, max_seq_len=16, page_size=8,
                             prefill_bucket=8)
    assert got == want and len(got[0]) == 16 - 10


def test_sampled_run_is_seed_deterministic_across_batches(pair):
    """A sampled request's tokens depend only on (seed, position, logits):
    alone or beside other requests, in any slot, the stream is the same;
    another seed gives another stream."""
    _, tm = pair
    gen = dict(max_new_tokens=12, do_sample=True, temperature=0.8, top_k=50,
               top_p=0.95)
    target = list(range(3, 20))

    def run(seed, others, max_batch):
        e = ContinuousBatchingEngine(
            tm, max_batch=max_batch, gen=GenerationConfig(seed=seed, **gen),
            max_seq_len=64, page_size=8, prefill_bucket=8, device="cpu")
        ids = [e.add_request(p) for p in others]
        rid = e.add_request(target)
        ids += [e.add_request(p) for p in others[::-1]]
        return e.run()[rid]

    alone = run(7, [], 1)
    crowded = run(7, [[5, 6, 7], list(range(40, 70)), [9]], 3)
    assert alone == crowded and len(alone) == 12
    assert run(8, [], 1) != alone


def test_engine_rejects_unported_options(pair):
    _, tm = pair
    for kw in (dict(prefix_cache=True), dict(spec_decode="ngram"),
               dict(tensor_parallel=2), dict(kv_spill_pages=4)):
        with pytest.raises(TypeError):
            ContinuousBatchingEngine(tm, device="cpu", **kw)
    # the int8 plane is ported: the engine builds a quantized pool
    eng = ContinuousBatchingEngine(tm, device="cpu", cache_dtype="int8")
    assert eng.g.cache.quantized and len(eng.g.cache.arrays) == 4


def test_page_allocator_trace_matches_jax():
    """The same allocation trace gives the same block tables, slots,
    refcounts and pool stats as the reference allocator."""
    a, b = JAllocator(num_pages=10, page_size=4), PageAllocator(10, 4)
    keys = ("num_pages", "pages_in_use", "peak_in_use", "active_seqs",
            "cow_copies")
    assert a.allocate(0, 9).tolist() == b.allocate(0, 9).tolist()
    for op in [("allocate", 1, 3), ("extend", 0, 5), ("free", 1),
               ("allocate", 2, 4), ("retain", 2), ("cow", 2, 0),
               ("truncate", 0, 6), ("extend", 2, 9)]:
        outs = []
        for alloc in (a, b):
            if op[0] == "retain":
                alloc.retain(alloc.page_list(op[1])[0])
                outs.append(None)
            else:
                r = getattr(alloc, op[0])(*op[1:])
                outs.append(r.tolist() if isinstance(r, np.ndarray) else r)
        assert outs[0] == outs[1], op
        assert {k: a.stats()[k] for k in keys} == b.stats()
        ids = sorted(b._pages)
        np.testing.assert_array_equal(a.block_table(ids, max_pages=6),
                                      b.block_table(ids, max_pages=6))
        assert [a.ref_count(p) for p in range(10)] == \
            [b.ref_count(p) for p in range(10)]
    with pytest.raises(MemoryError):
        b.allocate(9, 100)
    assert 9 not in b._pages                      # rolled back
    with pytest.raises(KeyError):
        b.free(42)
