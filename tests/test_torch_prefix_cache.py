"""The port's prefix cache (radix index, COW, LRU eviction, digests) and the
allocator's reclaim seam against the JAX package, on the tiny Llama (CPU
tensors: the plain attention path).

Greedy tokens and the prefix counters are compared exactly: both engines
compute the same fp32 function from the same weights and make the same
host-side cache decisions.  Digests are compared as hex strings.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference import PageAllocator as JAllocator
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig, PageAllocator)
from paddle_tpu_torch.inference import prefix_cache as tpc
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

COUNTERS = ("prefix_hits", "prefix_tokens_saved", "cow_copies",
            "evicted_pages", "pages_in_use", "peak_in_use", "active_seqs",
            "prefix_cached_pages", "prefix_evictable_pages",
            "prefix_digest_epoch")
GEOMETRY = dict(max_batch=4, max_seq_len=128, page_size=16, prefill_bucket=32)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm


def _run_waves(pair, waves, gen_kw, **kw):
    """Serve each wave of (prompt, budget) requests to completion on one
    engine of each package; returns both engines' per-wave tokens and the
    two engines."""
    jm, tm = pair
    je = JEngine(jm, gen=JGen(**gen_kw), **kw)
    te = ContinuousBatchingEngine(tm, gen=GenerationConfig(**gen_kw),
                                  device="cpu", **kw)
    want, got = [], []
    for wave in waves:
        jr = [je.add_request(p, n) for p, n in wave]
        tr = [te.add_request(p, n) for p, n in wave]
        jo, to = je.run(), te.run()
        want.append([jo[r] for r in jr])
        got.append([to[r] for r in tr])
    return want, got, je, te


def _rand(rng, n):
    return rng.integers(1, 256, n).tolist()


def _shared_prefix():
    rng = np.random.default_rng(0)
    prefix = _rand(rng, 48)
    return [[(prefix + _rand(rng, int(rng.integers(4, 20))), 12)
             for _ in range(8)]], {}


def _identical_concurrent():
    rng = np.random.default_rng(1)
    p = _rand(rng, 40)
    return [[(list(p), 10) for _ in range(4)]], {}


def _fully_cached_cow():
    rng = np.random.default_rng(2)
    p = _rand(rng, 32)                    # two whole pages
    return [[(p, 8)], [(list(p), 8), (p + _rand(rng, 5), 8)]], {}


def _eviction_mid_decode():
    rng = np.random.default_rng(3)
    first = [(_rand(rng, 48), 4) for _ in range(4)]
    second = [(_rand(rng, 20), 48), (_rand(rng, 24), 48)]
    return [first, second], dict(num_pages=12)


def _undersized_pool():
    rng = np.random.default_rng(4)
    return [[(_rand(rng, 20), 90) for _ in range(4)]], dict(num_pages=12)


CASES = {"shared_prefix": (_shared_prefix, "prefix_hits"),
         "identical_concurrent": (_identical_concurrent, "prefix_hits"),
         "fully_cached_cow": (_fully_cached_cow, "cow_copies"),
         "eviction_mid_decode": (_eviction_mid_decode, "evicted_pages"),
         "undersized_pool": (_undersized_pool, None)}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_prefix_cache_matches_jax(pair, case):
    """Greedy tokens, the prefix/COW/eviction counters and the residency
    digest equal the reference engine's with ``prefix_cache=True``; the
    case's own counter moved; every page goes back to the pool or the
    cache."""
    make, moved = CASES[case]
    waves, geo = make()
    kw = {**GEOMETRY, **geo}
    want, got, je, te = _run_waves(pair, waves, dict(max_new_tokens=90),
                                   prefix_cache=True, **kw)
    assert got == want
    js, ts = je.stats(), te.stats()
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    if moved is not None:
        assert ts[moved] > 0, ts
    assert ts["active_seqs"] == 0
    assert ts["pages_in_use"] == ts["prefix_cached_pages"]
    jd, td = je.prefix_digest(), te.prefix_digest()
    assert td["mode"] == jd["mode"] == "full"
    assert td["hashes"] == jd["hashes"] and td["epoch"] == jd["epoch"]
    if case == "identical_concurrent":
        assert all(g == got[0][0] for g in got[0])
    if case == "undersized_pool":
        assert all(1 <= len(g) < 90 for g in got[0])


def test_cache_off_is_the_plain_engine(pair):
    """prefix_cache=False gives the plain engine's tokens and zero prefix
    counters."""
    waves, _ = _shared_prefix()
    _, tm = pair
    outs = []
    for on in (False, True):
        e = ContinuousBatchingEngine(tm, gen=GenerationConfig(
            max_new_tokens=12), device="cpu", prefix_cache=on, **GEOMETRY)
        ids = [e.add_request(p, n) for p, n in waves[0]]
        res = e.run()
        outs.append(([res[i] for i in ids], e.stats()))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1]["prefix_hits"] == 0 and outs[1][1]["prefix_hits"] > 0
    assert not outs[0][1]["prefix_cache_enabled"]


@pytest.mark.parametrize("page", [1, 4, 16])
def test_block_hashes_match_jax(page):
    rng = np.random.default_rng(page)
    toks = rng.integers(0, 32000, 70).tolist()
    for limit in (None, 0, 2):
        assert tpc.block_hashes(toks, page, limit) == \
            jpc.block_hashes(toks, page, limit)
    assert tpc.block_hashes(toks[:page - 1], page) == []


def _fake_cache(alloc):
    """A stand-in reclaimer holding cached page references (oldest first)."""
    held = []

    def reclaim(n):
        k = 0
        while held and k < n:
            alloc.release_page(held.pop(0))
            k += 1
        if k:
            alloc.record_evictions(k)
        return k

    alloc.set_reclaimer(reclaim, lambda: len(held))
    return held


def test_allocator_reclaim_seam_matches_jax():
    """One trace through both allocators with a reclaimer attached: the
    pool reclaims cached pages only when the free list is dry; block
    tables, slots, availability, context lengths, errors and stats stay
    equal to the reference's."""
    allocs = (JAllocator(num_pages=8, page_size=4), PageAllocator(8, 4))
    helds = [_fake_cache(a) for a in allocs]

    def state(a):
        return (a.free_pages, a.available_pages, a.stats(),
                {s: a.page_list(s) for s in sorted(a._pages)})

    ops = [("allocate", 0, 14), ("cache", 0, 3), ("free", 0),
           ("allocate", 1, 9), ("record_prefix_hit", 8), ("acquire",),
           ("allocate", 2, 12), ("context_lens", [1, 2]), ("release", 1),
           ("allocate", 3, 40), ("cow", 2, 0), ("truncate", 2, 2),
           ("extend", 2, 6), ("block_table", [2], 6), ("release", 2),
           ("free", 2)]
    for op in ops:
        outs = []
        for a, held in zip(allocs, helds):
            try:
                if op[0] == "cache":             # the cache's own references
                    for p in a.page_list(op[1])[:op[2]]:
                        a.retain(p)
                        held.append(p)
                    r = None
                elif op[0] == "acquire":
                    r = a.acquire_page()
                else:
                    r = getattr(a, op[0])(*op[1:])
            except (MemoryError, KeyError) as e:
                r = type(e).__name__
            outs.append(r.tolist() if isinstance(r, np.ndarray) else r)
        assert outs[0] == outs[1], op
        assert state(allocs[0]) == state(allocs[1]), op
    assert allocs[1].stats()["evicted_pages"] > 0
    assert allocs[1].stats()["prefix_tokens_saved"] == 8


def _replay(cache_mod, alloc_cls, prompts, page):
    """Admit, progress and retire prompts through a bare PrefixCache, with
    a pool small enough to evict; returns per-step observations."""
    alloc = alloc_cls(10, page)
    cache = cache_mod.PrefixCache(alloc, page)
    seen = []
    for sid, (p, keep) in enumerate(prompts):
        plan = cache.plan(p)
        seen.append((plan.start, plan.cow, plan.fresh_pages,
                     len(plan.nodes), len(plan.wait), plan.idle_matched))
        cache.attach(plan)
        alloc.allocate(sid, len(p), shared_pages=[x.page for x in plan.nodes])
        seen.append(cache.admit(sid, p, plan))
        cache.note_progress(sid, len(p))
        if not keep:
            cache.release(sid)
            alloc.free(sid)
        seen.append((cache.digest(), cache.digest(max_entries=3),
                     cache.cached_pages(), cache.evictable_pages(),
                     cache.digest_epoch, cache.sketch_wire(),
                     cache.digest_delta(max(cache.digest_epoch - 3, 0)),
                     alloc.stats()))
    return seen


def test_prefix_cache_index_and_digest_match_jax():
    """Plans, COW pairs, residency digests (full, truncated, delta) and the
    Bloom sketch equal the reference's over a trace with sharing, a fully
    cached prompt and LRU eviction."""
    rng = np.random.default_rng(7)
    page = 4
    a, b = _rand(rng, 12), _rand(rng, 10)
    prompts = [(a, False), (a + _rand(rng, 5), False), (list(a), True),
               (b, False), (b + _rand(rng, 8), False), (_rand(rng, 20), False),
               (a[:8], False)]
    want = _replay(jpc, JAllocator, prompts, page)
    got = _replay(tpc, PageAllocator, prompts, page)
    assert got == want
    assert any(pairs for pairs in got[1::3])            # a COW pair
    assert got[-1][-1]["evicted_pages"] > 0


def test_launcher_turns_the_features_on():
    """``--prefix-cache`` and ``--set`` flags reach the engine the launcher
    builds (the flags are read when the engine is built)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.serving.__main__ import (apply_flag_sets,
                                                   build_engine, build_parser)
    names = ("prefix_cache", "spec_decode", "spec_k", "kv_spill_pages")
    saved = flags.get_flags(list(names))
    args = build_parser().parse_args(
        ["--device", "cpu", "--max-seq-len", "64", "--prefix-cache",
         "--set", "spec_decode=ngram", "--set", "spec_k=3",
         "--set", "kv_spill_pages=8"])
    try:
        apply_flag_sets(args.flag_sets)
        eng = build_engine(args)
    finally:
        flags.set_flags(saved)
    plain = build_engine(build_parser().parse_args(
        ["--device", "cpu", "--max-seq-len", "64"]))
    s = eng.stats()
    assert s["prefix_cache_enabled"] and s["kv_spill_capacity"] == 8
    assert s["spec_mode"] == "ngram" and s["spec_k"] == 3
    # without the options: the spec and spill flags went back to off
    assert not plain.stats()["spec_decode_enabled"]
    assert not plain.stats()["prefix_cache_enabled"]
