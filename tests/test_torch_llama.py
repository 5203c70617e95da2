"""The port's Llama model, RMSNorm, RoPE and weight carry against the JAX
package.

A seeded JAX ``LlamaForCausalLM(LlamaConfig.tiny())`` is carried into the
port with ``load_reference_state``; both then compute the same function.
Tolerances: full-sequence logits fp32 atol 1e-4 (two frameworks' matmul
and softmax summation orders over 2 layers); elementwise pieces 2e-6 (a
few fp32 ulps); bf16 RMSNorm one bf16 ulp (2**-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.generation import _rope_bt as jax_rope_bt
from paddle_tpu.kernels.rms_norm import rms_norm_fp32 as jax_rms_norm
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.generation import _rope_bt
from paddle_tpu_torch.kernels.flash_attention import flash_attention
from paddle_tpu_torch.kernels.rms_norm import rms_norm_fp32
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils import (extract_params, load_reference_state,
                                    stack_params)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with the same weights, numpy state)."""
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm, arrays


def test_full_sequence_logits_match_jax(pair):
    jm, tm, _ = pair
    ids = np.random.default_rng(0).integers(0, 256, (3, 37))
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == (3, 37, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_state_names_and_layouts_match_jax(pair):
    _, tm, arrays = pair
    names = [n for n, _ in tm.named_parameters()]
    assert names == list(arrays)
    for n, p in tm.named_parameters():
        assert tuple(p.shape) == arrays[n].shape       # [in, out] weights
        np.testing.assert_array_equal(p.detach().numpy(), arrays[n])


def test_load_reference_state_rejects_mismatch(pair):
    _, tm, arrays = pair
    short = dict(arrays)
    short.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_reference_state(tm, short)
    bad = dict(arrays)
    bad["llama.norm.weight"] = np.ones((3,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_reference_state(tm, bad)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6),
                                       ("bfloat16", 2 ** -7)])
def test_rms_norm_fp32_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 5, 64)) * 3).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    want = np.asarray(jax_rms_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                                   1e-5).astype(jnp.float32))
    got = rms_norm_fp32(torch.from_numpy(x).to(llama.torch_dtype(dtype)),
                        torch.from_numpy(w).to(llama.torch_dtype(dtype)), 1e-5)
    assert got.dtype == llama.torch_dtype(dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_rope_tables_and_rotation_match_jax():
    cos, sin = llama._rope_cos_sin(50, 16, 10000.0)
    jcos, jsin = jllama._rope_cos_sin(50, 16, 10000.0, jnp.float32)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    x = np.random.default_rng(4).standard_normal((2, 50, 3, 16)).astype(np.float32)
    want = np.asarray(jllama.apply_rotary_pos_emb(jnp.asarray(x), jcos, jsin))
    got = llama.apply_rotary_pos_emb(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    # the per-(row, token) form of the serving step: gathered positions
    pos = np.asarray([[0, 7, 49], [3, 3, 12]])
    c_bt, s_bt = cos[torch.from_numpy(pos)], sin[torch.from_numpy(pos)]
    xb = x[:, :3]
    want_bt = np.asarray(jax_rope_bt(jnp.asarray(xb), jnp.asarray(c_bt.numpy()),
                                     jnp.asarray(s_bt.numpy())))
    np.testing.assert_allclose(_rope_bt(torch.from_numpy(xb), c_bt, s_bt).numpy(),
                               want_bt, rtol=2e-6, atol=2e-6)


def test_swiglu_and_attention_plain_versions():
    rng = np.random.default_rng(5)
    g, u = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        llama.swiglu(torch.from_numpy(g), torch.from_numpy(u)).numpy(),
        np.asarray(jllama.swiglu(jnp.asarray(g), jnp.asarray(u))),
        rtol=2e-6, atol=2e-6)
    from paddle_tpu.kernels.flash_attention import _reference_attention
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    want = np.asarray(_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_seeded_init_is_deterministic_and_scaled():
    cfg = llama.LlamaConfig.tiny()
    a = llama.LlamaForCausalLM(cfg, device="cpu", seed=3)
    b = llama.LlamaForCausalLM(cfg, device="cpu", seed=3)
    c = llama.LlamaForCausalLM(cfg, device="cpu", seed=4)
    wa = a.llama.layers[0].mlp.down_proj.weight
    assert torch.equal(wa, b.llama.layers[0].mlp.down_proj.weight)
    assert not torch.equal(wa, c.llama.layers[0].mlp.down_proj.weight)
    # N(0, 1/fan_in): down_proj's fan-in is the intermediate size
    assert abs(float(wa.std()) * cfg.intermediate_size ** 0.5 - 1.0) < 0.1
    assert torch.equal(a.llama.norm.weight, torch.ones(cfg.hidden_size))


def test_bf16_model_and_configs():
    cfg = llama.LlamaConfig.tiny(dtype="bfloat16")
    m = llama.LlamaForCausalLM(cfg, device="cpu")
    logits = m(torch.tensor([[1, 2, 3, 4]]))
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits.float()).all()
    for name in ("tiny", "llama2_7b", "llama2_13b", "mixtral_tiny"):
        mine = getattr(llama.LlamaConfig, name)()
        ref = getattr(jllama.LlamaConfig, name)()
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "max_position_embeddings",
                  "rms_norm_eps", "rope_theta", "dtype", "moe_num_experts",
                  "moe_top_k", "moe_capacity_factor", "moe_aux_loss_weight",
                  "moe_dispatch", "moe_groups", "moe_block_m"):
            assert getattr(mine, f) == getattr(ref, f), (name, f)
        assert mine.head_dim == ref.head_dim
    # MoE models build; only the grouped dispatch of the full-sequence
    # forward is ported
    m = llama.LlamaForCausalLM(
        llama.LlamaConfig.tiny(moe_num_experts=4, moe_dispatch="gather"),
        device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        m(torch.tensor([[1, 2, 3, 4]]))


def test_extract_and_stack_params_match_jax(pair):
    jm, tm, _ = pair
    from paddle_tpu.utils import extract_params as jextract
    from paddle_tpu.utils import stack_params as jstack
    mine = stack_params([extract_params(l) for l in tm.llama.layers])
    ref = jstack([jextract(l) for l in jm.llama.layers])
    assert list(mine) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))
    assert jax.default_backend() == "cpu"
