"""The port's speculative decoding against the JAX package: the on-device
drafter and acceptance functions on random cases (pads included), and the
engine's ngram and fused lanes on the tiny Llama (CPU tensors: the plain
attention path), greedy tokens and spec counters compared exactly.

Sampled spec runs are held only inside the port (its counter-based
generator is not JAX's threefry): seed-deterministic whatever the batch
composition.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference import speculative as jsp
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.inference import ContinuousBatchingEngine, GenerationConfig
from paddle_tpu_torch.inference import speculative as tsp
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

SPEC_COUNTERS = ("spec_steps", "spec_committed_tokens", "spec_drafted_tokens",
                 "spec_accepted_tokens", "spec_rejected_tokens",
                 "prefix_hits", "prefix_tokens_saved", "cow_copies",
                 "evicted_pages", "pages_in_use", "peak_in_use")
GEOMETRY = dict(max_batch=4, max_seq_len=128, page_size=16, prefill_bucket=32)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm


def _np(x):
    return np.asarray(x)


# ------------------------------------------------ drafter and acceptance ---

def _history_case(seed, B=5, S=40, nmax=3, vocab=6):
    """Histories over a small vocabulary (many n-gram matches), padded past
    random lengths (one row empty, one full), and recent rings with and
    without the left CTX_PAD fill."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, vocab, (B, S)).astype(np.int32)
    lens = rng.integers(0, S + 1, B).astype(np.int32)
    lens[0], lens[1] = 0, S
    for b in range(B):
        hist[b, lens[b]:] = tsp.HIST_PAD
    recent = rng.integers(0, vocab, (B, nmax)).astype(np.int32)
    for b in range(B):
        recent[b, :int(rng.integers(0, nmax + 1))] = tsp.CTX_PAD
    return hist, lens, recent


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k,nmax", [(2, 1), (4, 3), (5, 2)])
def test_lookup_drafts_matches_jax(seed, k, nmax):
    hist, lens, recent = _history_case(seed, nmax=nmax)
    want = jsp.lookup_drafts(jnp.asarray(hist), jnp.asarray(lens),
                             jnp.asarray(recent), k, nmax)
    got = tsp.lookup_drafts(torch.from_numpy(hist), torch.from_numpy(lens),
                            torch.from_numpy(recent), k, nmax)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), _np(w))


@pytest.mark.parametrize("seed", range(4))
def test_accept_shift_and_eos_match_jax(seed):
    """accept_length (inert rows, short drafts, full acceptance),
    shift_append (0 to K commits) and eos_clamp (EOS before, inside and
    past the commit) equal the reference's."""
    rng = np.random.default_rng(seed)
    B, K, nmax = 7, 4, 3
    sampled = rng.integers(0, 3, (B, K)).astype(np.int32)
    tokens = rng.integers(0, 3, (B, K)).astype(np.int32)
    tokens[0, 1:] = sampled[0, :-1]                     # every draft accepted
    q_lens = rng.integers(0, K + 1, B).astype(np.int32)
    q_lens[0], q_lens[1] = K, 0
    j = (jnp.asarray(tokens), jnp.asarray(sampled), jnp.asarray(q_lens))
    t = (torch.from_numpy(tokens), torch.from_numpy(sampled),
         torch.from_numpy(q_lens))
    n_want = jsp.accept_length(*j)
    n_got = tsp.accept_length(*t)
    np.testing.assert_array_equal(n_got.numpy(), _np(n_want))
    assert int(n_got[0]) == K and int(n_got[1]) == 0

    recent = rng.integers(0, 9, (B, nmax)).astype(np.int32)
    recent[2, :2] = tsp.CTX_PAD
    np.testing.assert_array_equal(
        tsp.shift_append(torch.from_numpy(recent), t[1], n_got).numpy(),
        _np(jsp.shift_append(jnp.asarray(recent), j[1], n_want)))

    for eos in (0, 1, 2):
        want = jsp.eos_clamp(j[1], n_want, eos)
        got = tsp.eos_clamp(t[1], n_got, eos)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), _np(w))


def test_history_table_and_config_match_jax():
    """recent_window, SpecHistory's rows and lengths, and the flag / kwarg
    resolution of SpecConfig are the reference's."""
    for toks, n in (([], 3), ([5], 3), (list(range(10)), 4)):
        np.testing.assert_array_equal(tsp.recent_window(toks, n),
                                      jsp.recent_window(toks, n))
    hj, ht = jsp.SpecHistory(3, 10), tsp.SpecHistory(3, 10)
    for h in (hj, ht):
        h.reset_row(0, [1, 2, 3])
        h.extend_row(0, [4, 5])
        h.reset_row(2, list(range(12)))              # truncated to the row
        h.extend_row(2, [7])                         # no room: unchanged
        h.extend_row(1, [])
    for w, g in zip(hj.device_arrays(), ht.device_arrays()):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert [ht.length(b) for b in range(3)] == [5, 0, 10]
    for args in ((None, None, None), ("ngram", 2, 5), (True, None, 0),
                 ("fused", 3, None), (False, None, None)):
        assert tsp.resolve_spec_config(*args) == (
            None if jsp.resolve_spec_config(*args) is None else
            tsp.SpecConfig(**vars(jsp.resolve_spec_config(*args))))
    jold, told = jflags.flag("spec_decode"), tflags.flag("spec_decode")
    try:
        jflags.set_flags({"spec_decode": "fused"})
        tflags.set_flags({"spec_decode": "fused"})
        assert tsp.resolve_spec_config().mode == \
            jsp.resolve_spec_config().mode == "fused"
    finally:
        jflags.set_flags({"spec_decode": jold})
        tflags.set_flags({"spec_decode": told})
    for bad in (("beam", None, None), ("ngram", 1, None)):
        with pytest.raises(ValueError):
            tsp.resolve_spec_config(*bad)


# ----------------------------------------------------------------- engine ---

def _looping_requests(seed=0, n=6):
    """Prompts built from a repeated motif (the drafter finds matches in
    the prompt) with distinct heads."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        motif = rng.integers(1, 256, int(rng.integers(3, 7))).tolist()
        head = rng.integers(1, 256, int(rng.integers(2, 20))).tolist()
        out.append((head + motif * int(rng.integers(3, 6)),
                    int(rng.integers(16, 33))))
    return out


def _run_both(pair, waves, gen_kw, **kw):
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
    return want, got, je.stats(), te.stats()


def _prefix_waves():
    rng = np.random.default_rng(4)
    prefix = rng.integers(1, 256, 32).tolist()
    reqs = _looping_requests(5, 4)
    first = [(prefix + p, n) for p, n in reqs]
    return [first, [(list(prefix), 20), (prefix + reqs[0][0], 24)]]


def _undersized_waves():
    rng = np.random.default_rng(6)
    return [[(rng.integers(1, 256, 20).tolist(), 90) for _ in range(4)]]


SPEC_CASES = {
    "ngram_k2": (dict(spec_decode="ngram", spec_k=2), None),
    "ngram_k4": (dict(spec_decode="ngram", spec_k=4), None),
    "fused_k4": (dict(spec_decode="fused", spec_k=4), None),
    "ngram_over_prefix_cache": (dict(spec_decode="ngram", spec_k=4,
                                     prefix_cache=True), "prefix"),
    "fused_over_prefix_cache": (dict(spec_decode="fused", spec_k=4,
                                     prefix_cache=True), "prefix"),
    # the pool runs dry mid-decode: the engine drains inside the step to
    # roll the speculative overestimate back, then finalizes rows early
    "ngram_undersized_pool": (dict(spec_decode="ngram", spec_k=4,
                                   num_pages=12), "undersized"),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_engine_spec_matches_jax(pair, case):
    """Greedy tokens and the spec (and prefix) counters equal the
    reference engine's; the lane ran and, in ngram mode, accepted drafts;
    every speculative page is rolled back or freed."""
    kw, waves = SPEC_CASES[case]
    waves = {"prefix": _prefix_waves, "undersized": _undersized_waves}.get(
        waves, lambda: [_looping_requests()])()
    want, got, js, ts = _run_both(pair, waves, dict(max_new_tokens=90),
                                  **GEOMETRY, **kw)
    assert got == want
    assert {k: ts[k] for k in SPEC_COUNTERS} == \
        {k: js[k] for k in SPEC_COUNTERS}
    assert ts["spec_steps"] > 0 and ts["spec_mode"] == kw["spec_decode"]
    if kw["spec_decode"] == "ngram":
        assert ts["spec_accepted_tokens"] > 0
    if "prefix_cache" in kw:
        assert ts["prefix_hits"] > 0 and ts["cow_copies"] > 0
    if "num_pages" in kw:                 # rows finalized short of 90
        assert min(len(g) for g in got[0]) < 90
    assert ts["active_seqs"] == 0


def test_spec_greedy_equals_the_plain_engine(pair):
    """Both lanes give the spec-off engine's greedy tokens."""
    _, tm = pair
    reqs = _looping_requests()
    outs = []
    for kw in ({}, dict(spec_decode="ngram"), dict(spec_decode="fused")):
        e = ContinuousBatchingEngine(tm, gen=GenerationConfig(
            max_new_tokens=32), device="cpu", **GEOMETRY, **kw)
        ids = [e.add_request(p, n) for p, n in reqs]
        res = e.run()
        outs.append([res[i] for i in ids])
    assert outs[0] == outs[1] == outs[2]


def test_eos_inside_a_draft_matches_jax(pair, monkeypatch):
    """An EOS that the verify step accepts inside a draft cuts the commit
    there (EOS kept) in both engines."""
    _, tm = pair

    def run_port(prompts, eos=None, **kw):
        e = ContinuousBatchingEngine(tm, gen=GenerationConfig(
            max_new_tokens=16, eos_token_id=eos), device="cpu",
            **GEOMETRY, **kw)
        ids = [e.add_request(p) for p in prompts]
        res = e.run()
        return [res[i] for i in ids]

    # a prompt ending in its own greedy loop: the drafter proposes the
    # loop's next tokens from the prompt before the row has emitted them
    head = np.random.default_rng(0).integers(1, 256, 8).tolist()
    loop = ContinuousBatchingEngine(tm, gen=GenerationConfig(
        max_new_tokens=48), device="cpu", **GEOMETRY)
    rid = loop.add_request(head)
    reqs = [head + loop.run()[rid]] + \
        [p for p, _ in _looping_requests(seed=3, n=2)]
    plain = run_port(reqs, spec_decode="ngram")
    clamped = []
    real = tsp.eos_clamp

    def clamp_spy(sampled, n_commit, eos_id):
        n, hit = real(sampled, n_commit, eos_id)
        clamped.append(bool((n < n_commit).any()))
        return n, hit

    monkeypatch.setattr(tsp, "eos_clamp", clamp_spy)
    for eos in list(dict.fromkeys(plain[0]))[:4]:
        clamped.clear()
        run_port(reqs, eos, spec_decode="ngram")
        if any(clamped):
            break
    assert any(clamped)
    want, got, js, ts = _run_both(
        pair, [[(p, 16) for p in reqs]],
        dict(max_new_tokens=16, eos_token_id=eos), spec_decode="ngram",
        **GEOMETRY)
    assert got == want
    assert got[0][0][-1] == eos and len(got[0][0]) < len(plain[0])
    assert {k: ts[k] for k in SPEC_COUNTERS} == \
        {k: js[k] for k in SPEC_COUNTERS}


@pytest.mark.parametrize("mode", ["ngram", "fused"])
def test_sampled_spec_is_seed_deterministic_across_batches(pair, mode):
    """A sampled request's stream depends only on (seed, position, logits):
    alone or beside other requests, in any slot, the spec engine gives the
    same tokens; another seed gives another stream."""
    _, tm = pair
    gen = dict(max_new_tokens=16, do_sample=True, temperature=0.8, top_k=50)
    target = [5, 6, 7, 8] * 4

    def run(seed, others, max_batch):
        e = ContinuousBatchingEngine(
            tm, max_batch=max_batch, gen=GenerationConfig(seed=seed, **gen),
            max_seq_len=64, page_size=8, prefill_bucket=8, device="cpu",
            spec_decode=mode)
        ids = [e.add_request(p) for p in others]
        rid = e.add_request(target)
        ids += [e.add_request(p) for p in others[::-1]]
        return e.run()[rid]

    alone = run(7, [], 1)
    crowded = run(7, [[5, 6, 7], list(range(40, 70)), [9]], 3)
    assert alone == crowded and len(alone) == 16
    assert run(8, [], 1) != alone
