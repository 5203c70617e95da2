"""The port's MoE serving path against the JAX package (CPU tensors: the
grouped matmul's plain version).

- ``sorted_dispatch_plan`` equals JAX's exactly (``inv``, ``pos``,
  ``tile_groups``) for given expert ids, not ids from routing: the two
  frameworks' top-k may order equal probabilities differently.
- ``gmm`` (plain) against JAX ``_gmm_reference``, with and without the
  fused row gather; ``_route_topk``; ``_moe_ffn`` grouped and dense against
  JAX ``_moe_ffn``: fp32, tolerance 1e-5 (matmul summation order).
- ``mixtral_tiny`` full-sequence logits against JAX
  ``LlamaForCausalLM.forward`` (``moe_dispatch="grouped"``), weights
  carried by ``load_reference_state``: atol 1e-4, as the dense model's test.
- Greedy tokens of the port's generator and engine equal the JAX
  package's on ``mixtral_tiny`` (``moe_block_m=8``).

The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference import LlamaGenerator as JGenerator
from paddle_tpu.inference import generation as jgen
from paddle_tpu.kernels import grouped_matmul as jgm
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig, LlamaGenerator)
from paddle_tpu_torch.inference import generation
from paddle_tpu_torch.kernels import grouped_matmul as gm
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)

_jax_plan = jax.jit(jgm.sorted_dispatch_plan, static_argnums=(1, 2))
_jax_gmm = jax.jit(jgm._gmm_reference, static_argnames="bm")
_jax_moe_ffn = jax.jit(jgen._moe_ffn,
                       static_argnames=("top_k", "dispatch", "block_m"))
_jax_route = jax.jit(jllama._route_topk, static_argnums=2)


# -------------------------------------------------------- dispatch plan ---

@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("ids", [
    [2, 0, 2, 3, 0, 2, 2, 3, 0, 2, 3, 3, 0, 0, 2, 3],   # expert 1 empty
    [1] * 20,                                           # one expert only
    [3, 2, 1, 0, 0, 1, 2, 3, 3],                        # ragged F
])
def test_sorted_dispatch_plan_matches_jax(bm, ids):
    e = np.asarray(ids, np.int32)
    want = [np.asarray(a) for a in _jax_plan(jnp.asarray(e), 4, bm)]
    got = [a.numpy() for a in gm.sorted_dispatch_plan(
        torch.from_numpy(e), 4, bm)]
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    M = got[0].shape[0]
    assert M == -(-len(ids) // bm) * bm + 4 * bm
    assert (np.diff(got[2]) >= 0).all() and set(got[2]) == {0, 1, 2, 3}


def test_take_sentinel_rows():
    buf = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = gm.take_sentinel_rows(buf, torch.tensor([3, 4, 0, 9]))
    assert torch.equal(out, torch.tensor([[9., 10, 11], [0, 0, 0], [0, 1, 2],
                                          [0, 0, 0]]))


# ------------------------------------------------------------------ gmm ---

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("bm", [8, 16])
def test_gmm_plain_matches_jax(fused, bm):
    rng = np.random.default_rng(bm + fused)
    E, C, O = 4, 32, 48
    ids = rng.integers(0, E, 21).astype(np.int32)
    ids[ids == 2] = 1                                    # an empty expert
    inv, _pos, tg = (np.asarray(a) for a in _jax_plan(jnp.asarray(ids), E, bm))
    M = inv.shape[0]
    rhs = rng.standard_normal((E, C, O)).astype(np.float32)
    if fused:
        lhs = rng.standard_normal((22, C)).astype(np.float32)
        lhs[-1] = 0                                      # the zero sentinel
        rows = np.where(inv < 21, inv, 21).astype(np.int32)
    else:
        lhs = rng.standard_normal((M, C)).astype(np.float32)
        rows = None
    want = np.asarray(_jax_gmm(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(tg), bm=bm,
        rows=None if rows is None else jnp.asarray(rows)))
    got = gm.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs),
                 torch.from_numpy(tg), bm=bm,
                 rows=None if rows is None else torch.from_numpy(rows))
    assert got.shape == (M, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert gm.row_tile(bm) == bm
    if fused:
        assert not got[torch.from_numpy(rows) == 21].any()


def test_gmm_refuses_backward_modes_and_bad_tiles():
    # the backward modes compute now (held against JAX in
    # tests/test_torch_moe_train.py); the bad-tile checks stay
    lhs, rhs = torch.ones((16, 32)), torch.ones((2, 32, 64))
    tg = torch.zeros((2,), dtype=torch.int32)
    out = gm.gmm(lhs, rhs.transpose(1, 2).contiguous(), tg, bm=8,
                 trans_rhs=True)
    assert torch.equal(out, torch.full((16, 64), 32.0))
    out = gm.gmm(lhs, rhs, tg, bm=8, row_scale=torch.full((16,), 0.5))
    assert torch.equal(out, torch.full((16, 64), 16.0))
    with pytest.raises(ValueError, match="multiple"):
        gm.gmm(lhs, rhs, tg, bm=12)
    with pytest.raises(ValueError, match="multiple"):
        gm.tgmm(lhs, lhs, tg, 2, bm=12)
    assert [gm.row_tile(b) for b in (8, 24, 48, 96, 512)] == [8, 8, 16, 32, 64]


# --------------------------------------------------------- router + FFN ---

def test_route_topk_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 64)).astype(np.float32)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    want = [np.asarray(a) for a in _jax_route(jnp.asarray(x), jnp.asarray(w), 2)]
    got = [a.numpy() for a in llama._route_topk(torch.from_numpy(x),
                                                torch.from_numpy(w), 2)]
    np.testing.assert_array_equal(got[1], want[1])       # no ties here
    for i in (0, 2, 3):
        np.testing.assert_allclose(got[i], want[i], **TOL)


@pytest.fixture(scope="module")
def expert_layer():
    rng = np.random.default_rng(5)
    H, I, E = 64, 128, 4
    f = np.float32
    lp = {"mlp.gate.weight": rng.standard_normal((H, E)).astype(f),
          "mlp.experts_gate": (rng.standard_normal((E, H, I)) / 8).astype(f),
          "mlp.experts_up": (rng.standard_normal((E, H, I)) / 8).astype(f),
          "mlp.experts_down": (rng.standard_normal((E, I, H)) / 11).astype(f)}
    return lp


@pytest.mark.parametrize("dispatch,shape,block_m", [
    ("grouped", (3, 8, 64), 16),      # prefill-sized: bm = block_m
    ("grouped", (5, 1, 64), 512),     # decode: the row tile shrinks to 16
    ("dense", (3, 8, 64), 16),
])
def test_moe_ffn_matches_jax(expert_layer, dispatch, shape, block_m):
    y = np.random.default_rng(len(shape) + shape[0]).standard_normal(
        shape).astype(np.float32)
    want = np.asarray(_jax_moe_ffn(
        jnp.asarray(y), {k: jnp.asarray(v) for k, v in expert_layer.items()},
        top_k=2, dispatch=dispatch, block_m=block_m))
    got = generation._moe_ffn(
        torch.from_numpy(y), {k: torch.from_numpy(v)
                              for k, v in expert_layer.items()},
        2, dispatch=dispatch, block_m=block_m)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------- full model ---

def _moe_cfg(mod, **kw):
    return dataclasses.replace(mod.LlamaConfig.mixtral_tiny(),
                               moe_dispatch="grouped", moe_block_m=8, **kw)


@pytest.fixture(scope="module")
def pair():
    paddle.seed(7)
    jm = jllama.LlamaForCausalLM(_moe_cfg(jllama))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(_moe_cfg(llama), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm, arrays


def test_state_names_and_layouts_match_jax(pair):
    _, tm, arrays = pair
    assert [n for n, _ in tm.named_parameters()] == list(arrays)
    assert tuple(tm.llama.layers[0].mlp.gate.weight.shape) == (64, 4)
    assert tuple(tm.llama.layers[0].mlp.experts_down.shape) == (4, 128, 64)


def test_mixtral_tiny_logits_match_jax(pair):
    jm, tm, _ = pair
    ids = np.random.default_rng(0).integers(0, 256, (2, 13))
    # jitted (to_static): the eager JAX MoE forward costs ~9 s here
    want = np.asarray(paddle.jit.to_static(jm)(paddle.to_tensor(ids))._data)
    got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_non_grouped_dispatch_forward_is_not_ported(pair):
    """The ``gather`` and ``einsum`` dispatch forms of the full-sequence
    forward, ported since: mixtral_tiny logits equal the reference's
    model in the same form (jitted), weights carried from the pair; an
    unknown form still raises."""
    _, _, arrays = pair
    ids = np.random.default_rng(0).integers(0, 256, (2, 13))
    for dispatch in ("gather", "einsum"):
        paddle.seed(0)
        jm = jllama.LlamaForCausalLM(dataclasses.replace(
            _moe_cfg(jllama), moe_dispatch=dispatch))
        jm.set_state_dict(arrays)
        want = np.asarray(paddle.jit.to_static(jm)(
            paddle.to_tensor(ids))._data)
        m = llama.LlamaForCausalLM(dataclasses.replace(
            _moe_cfg(llama), moe_dispatch=dispatch), device="cpu")
        load_reference_state(m, arrays)
        np.testing.assert_allclose(m(torch.from_numpy(ids)).numpy(), want,
                                   rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="moe_dispatch"):
        llama.LlamaConfig.mixtral_tiny(moe_dispatch="nope")


def test_generate_greedy_matches_jax(pair):
    """The prompts of ``tests/test_inference.py``'s MoE serving test."""
    jm, tm, _ = pair
    prompts = [[3, 14, 15, 9, 2, 6], [5, 3]]
    kw = dict(max_batch=2, max_seq_len=64, page_size=8, prefill_bucket=8)
    want = JGenerator(jm, **kw).generate(prompts, JGen(max_new_tokens=8))
    got = LlamaGenerator(tm, device="cpu", **kw).generate(
        prompts, GenerationConfig(max_new_tokens=8))
    assert got == want and all(len(g) == 8 for g in got)


def test_engine_admission_midstream_matches_jax(pair):
    """Six requests through four slots: the last two are admitted while
    the first ones decode, so prefill chunks and decode rows share steps
    (the grouped FFN at bm 8 and the decode shrink in one run)."""
    jm, tm, _ = pair
    rng = np.random.default_rng(2)
    reqs = [([3, 14, 15, 9, 2, 6], 8), ([5, 3], 8)] + [
        (rng.integers(1, 256, int(n)).tolist(), int(b))
        for n, b in ((20, 6), (9, 10), (17, 5), (30, 7))]
    kw = dict(max_batch=4, max_seq_len=64, page_size=8, prefill_bucket=8)
    je = JEngine(jm, gen=JGen(max_new_tokens=10), **kw)
    te = ContinuousBatchingEngine(tm, gen=GenerationConfig(max_new_tokens=10),
                                  device="cpu", **kw)
    jr = [je.add_request(p, n) for p, n in reqs]
    tr = [te.add_request(p, n) for p, n in reqs]
    jo, to = je.run(), te.run()
    assert [to[r] for r in tr] == [jo[r] for r in jr]
    assert [len(to[r]) for r in tr] == [n for _, n in reqs]
    assert te.stats()["pages_in_use"] == 0
