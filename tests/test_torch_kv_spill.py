"""The port's pinned host spill tier against the JAX package: page bytes
through the spill ring (float and int8 pools, scale planes included), and
the engine's evict / spill / swap-in path over waves of shared-prefix
traffic on the tiny Llama (CPU tensors: the plain attention path), greedy
tokens and counters compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference import PagedKVCache as JCache
from paddle_tpu.inference.kv_spill import HostSpillPool as JSpill
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig, HostSpillPool,
                                        PagedKVCache)
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

COUNTERS = ("prefix_hits", "prefix_tokens_saved", "cow_copies",
            "evicted_pages", "pages_in_use", "peak_in_use",
            "prefix_cached_pages", "prefix_spilled_pages",
            "kv_spill_capacity", "kv_spill_resident", "kv_spilled_pages",
            "kv_swapins", "spec_steps", "spec_committed_tokens",
            "spec_drafted_tokens", "spec_accepted_tokens")


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm


def _pools(dtype, num_pages=6):
    """The same random page bytes in a reference and a port pool (the
    port's int8 planes hold one scratch page past ``num_pages``)."""
    geo = dict(num_layers=2, num_pages=num_pages, page_size=4,
               num_kv_heads=2, head_dim=8, dtype=dtype)
    jc, tc = JCache(**geo), PagedKVCache(**geo, device="cpu")
    rng = np.random.default_rng(0)
    planes = []
    for t in tc.arrays:
        shape = (t.shape[0], t.shape[1], num_pages) + tuple(t.shape[3:])
        if t.dtype == torch.int8:
            a = rng.integers(-127, 128, shape).astype(np.int8)
        else:
            a = rng.standard_normal(shape).astype(np.float32)
        t[:, :, :num_pages] = torch.from_numpy(a)
        planes.append(jnp.asarray(a))
    jc.update(*planes)
    return jc, tc


def _same_pools(jc, tc, num_pages=6):
    for j, t in zip(jc.arrays, tc.arrays):
        np.testing.assert_array_equal(t[:, :, :num_pages].numpy(),
                                      np.asarray(j))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_spill_ring_round_trip_matches_jax(dtype):
    """spill copies a page's every plane into a ring slot, peek reads it
    back, swap_in writes it into another page, a full ring refuses, and
    free_slot retires a slot: slots, bytes, pools and stats equal the
    reference's."""
    jc, tc = _pools(dtype)
    js, ts = JSpill(jc, 2), HostSpillPool(tc, 2)
    assert ts.ring_bytes == 2 * sum(
        p[:, :, 0].numel() * p.element_size() for p in tc.arrays)
    slots = [(js.spill(p), ts.spill(p)) for p in (1, 3, 4)]
    assert slots == [(0, 0), (1, 1), (None, None)]
    for jslot, tslot in slots[:2]:
        for j, t in zip(js.peek(jslot), ts.peek(tslot)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    js.swap_in(0, 5)                         # page 1's bytes
    ts.swap_in(0, 5)
    _same_pools(jc, tc)
    np.testing.assert_array_equal(tc.arrays[0][:, :, 5].numpy(),
                                  tc.arrays[0][:, :, 1].numpy())
    js.free_slot(1)
    ts.free_slot(1)
    assert ts.stats() == js.stats()
    assert ts.stats()["kv_spilled_pages"] == 2 and ts.free_slots == 2
    with pytest.raises(KeyError):
        ts.peek(1)


def _waves(seed=0, n=4, plen=32, tail=(16, 40)):
    """Wave 1 and 3 share a prefix, wave 2 another; wave 3's last prompt is
    the bare prefix (fully cached: COW)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 256, plen).tolist()
    b = rng.integers(1, 256, plen).tolist()

    def wave(prefix):
        return [prefix + rng.integers(1, 256, int(rng.integers(*tail))).tolist()
                for _ in range(n)]

    third = wave(a)
    third[-1] = list(a)
    return [wave(a), wave(b), third]


SPILL_CASES = {
    "float_pool": dict(prefix_cache=True, kv_spill_pages=4),
    "int8_pool_every_feature": dict(prefix_cache=True, kv_spill_pages=4,
                                    spec_decode="ngram", spec_k=4,
                                    cache_dtype="int8"),
}


@pytest.mark.parametrize("case", list(SPILL_CASES))
def test_engine_spill_waves_match_jax(pair, case):
    """A second wave evicts the first wave's prefix into the host ring and a
    third wave swaps it back in: greedy tokens and the prefix, COW,
    eviction, spill, swap-in (and spec) counters equal the reference
    engine's."""
    jm, tm = pair
    kw = dict(max_batch=4, max_seq_len=128, page_size=16, prefill_bucket=32,
              num_pages=12, **SPILL_CASES[case])
    je = JEngine(jm, gen=JGen(max_new_tokens=8), **kw)
    te = ContinuousBatchingEngine(tm, gen=GenerationConfig(max_new_tokens=8),
                                  device="cpu", **kw)
    for wave in _waves():
        jr = [je.add_request(p) for p in wave]
        tr = [te.add_request(p) for p in wave]
        jo, to = je.run(), te.run()
        assert [to[r] for r in tr] == [jo[r] for r in jr]
    js, ts = je.stats(), te.stats()
    assert {k: ts.get(k) for k in COUNTERS} == {k: js.get(k) for k in COUNTERS}
    for k in ("evicted_pages", "kv_spilled_pages", "kv_swapins",
              "cow_copies", "prefix_hits"):
        assert ts[k] > 0, (k, ts)
    jd, td = je.prefix_digest(), te.prefix_digest()
    assert td["spilled"] == jd["spilled"] and td["hashes"] == jd["hashes"]


def test_engine_takes_the_three_options(pair):
    """On the CPU the engine builds with prefix_cache, spec_decode and
    kv_spill_pages alone and together; the spill ring exists only under
    the prefix cache."""
    _, tm = pair
    for kw in (dict(prefix_cache=True), dict(spec_decode="ngram"),
               dict(spec_decode="fused", spec_k=3), dict(kv_spill_pages=4),
               dict(prefix_cache=True, spec_decode="ngram",
                    kv_spill_pages=4)):
        e = ContinuousBatchingEngine(tm, device="cpu", max_seq_len=64, **kw)
        s = e.stats()
        assert s["prefix_cache_enabled"] == bool(kw.get("prefix_cache"))
        assert s["spec_decode_enabled"] == ("spec_decode" in kw)
        assert s["kv_spill_enabled"] == (
            bool(kw.get("prefix_cache")) and "kv_spill_pages" in kw)
