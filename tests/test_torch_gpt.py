"""The port's GPT-2 family against the JAX package.

A JAX ``GPTForCausalLM(GPTConfig.tiny())`` made under ``paddle.seed(0)`` is
carried into the port with ``load_reference_state``; both then compute the
same function (head dim 12: the reference attends through its XLA path,
the port through the flash kernels' plain version).  Tolerances (fp32, two
frameworks' summation orders over 2 layers): logits and loss 1e-5; every
gradient of the loss against ``jax.grad`` of the reference's, rtol 1e-4
atol 1e-6 (|grad| up to ~0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import functional as JF
from paddle_tpu.utils import functional_call
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with the same weights, numpy state)."""
    paddle.seed(0)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = gpt.GPTForCausalLM(gpt.GPTConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm, arrays


def _batch(seed=0, b=2, s=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (b, s))
    labels = rng.integers(0, 128, (b, s))
    labels[0, :5] = -100                      # ignored positions
    return ids, labels


@pytest.mark.parametrize("preset", ["tiny", "gpt2_base", "gpt2_medium"])
def test_configs_match_jax(preset):
    mine = getattr(gpt.GPTConfig, preset)()
    ref = getattr(jgpt.GPTConfig, preset)()
    for f in ("vocab_size", "hidden_size", "num_hidden_layers",
              "num_attention_heads", "intermediate_size",
              "max_position_embeddings", "layer_norm_epsilon", "dtype"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.head_dim == ref.head_dim


def test_state_names_shapes_and_dtypes_match_jax(pair):
    _, tm, arrays = pair
    assert [n for n, _ in tm.named_parameters()] == list(arrays)
    assert len(arrays) == 28
    for n, p in tm.named_parameters():
        assert tuple(p.shape) == arrays[n].shape, n
        np.testing.assert_array_equal(p.detach().numpy(), arrays[n])
    # bf16: LayerNorm parameters stay fp32, as the reference's
    paddle.seed(0)
    jb = jgpt.GPTForCausalLM(jgpt.GPTConfig.tiny(dtype="bfloat16"))
    tb = gpt.GPTForCausalLM(gpt.GPTConfig.tiny(dtype="bfloat16"),
                            device="cpu")
    want = {k: str(v._data.dtype) for k, v in jb.state_dict().items()}
    got = {n: str(p.dtype).replace("torch.", "")
           for n, p in tb.named_parameters()}
    assert got == want


def test_logits_loss_and_gradients_match_jax(pair):
    jm, tm, _ = pair
    ids, labels = _batch()
    params = {k: v._data for k, v in jm.named_parameters()}
    j_ids, j_labels = jnp.asarray(ids), jnp.asarray(labels)
    j_logits = jax.jit(lambda p: functional_call(jm, p, j_ids))(params)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: functional_call(jm, p, j_ids, j_labels)[1]))(params)
    logits, loss = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    assert logits.shape == (2, 40, 128) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[n]),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    # the forward without labels returns the same logits
    np.testing.assert_array_equal(
        tm(torch.from_numpy(ids)).detach().numpy(), logits.detach().numpy())


def test_tied_head_gradient_is_one_tensor(pair):
    """``gpt.wte`` is both the embedding and the head: one parameter, and
    its gradient is the sum of the two uses' gradients."""
    _, tm, _ = pair
    wte = tm.gpt.wte
    assert sum(p is wte for p in tm.parameters()) == 1
    assert not any(n.startswith("lm_head") for n, _ in tm.named_parameters())
    ids, labels = (torch.from_numpy(a) for a in _batch(seed=1))
    (g_all,) = torch.autograd.grad(tm(ids, labels)[1], [wte])
    with torch.no_grad():
        h = tm.gpt(ids)
    (g_head,) = torch.autograd.grad(gpt.lm_loss(h @ wte.T, labels), [wte])
    (g_embed,) = torch.autograd.grad(
        gpt.lm_loss(tm.gpt(ids) @ wte.detach().T, labels), [wte])
    assert float(g_head.abs().max()) > 0 and float(g_embed.abs().max()) > 0
    np.testing.assert_allclose(g_all.numpy(), (g_head + g_embed).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_loss_ignores_labels_as_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32)
    for labels in (rng.integers(0, 11, (2, 6)), np.full((2, 6), -100),
                   np.where(rng.random((2, 6)) < 0.5, -100,
                            rng.integers(0, 11, (2, 6)))):
        want = JF.cross_entropy(paddle.to_tensor(logits.reshape(-1, 11)),
                                paddle.to_tensor(labels.reshape(-1)))
        got = gpt.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
        np.testing.assert_allclose(float(got), float(want._data), rtol=1e-6,
                                   atol=1e-7)


def test_init_stds_and_bf16_forward():
    c = gpt.GPTConfig.tiny(vocab_size=2048, hidden_size=256,
                           intermediate_size=1024, num_hidden_layers=2)
    m = gpt.GPTForCausalLM(c, device="cpu", seed=1)
    g = m.gpt
    resid = 0.02 / (2 * c.num_hidden_layers) ** 0.5
    for w, std in ((g.wte, 0.02), (g.wpe, 0.01), (g.h[0].qkv.weight, 0.02),
                   (g.h[1].proj.weight, resid), (g.h[0].fc_out.weight, resid)):
        assert abs(float(w.std()) / std - 1.0) < 0.05
    assert not g.h[0].qkv.bias.any() and bool((g.ln_f.weight == 1).all())
    same = gpt.GPTForCausalLM(c, device="cpu", seed=1)
    assert torch.equal(same.gpt.h[1].fc_in.weight, g.h[1].fc_in.weight)
    mb = gpt.GPTForCausalLM(gpt.GPTConfig.tiny(dtype="bfloat16"),
                            device="cpu")
    ids, labels = (torch.from_numpy(a) for a in _batch(b=1, s=16))
    logits, loss = mb(ids, labels)
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    assert torch.isfinite(logits.float()).all() and torch.isfinite(loss)
