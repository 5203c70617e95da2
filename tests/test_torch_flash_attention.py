"""The port's flash attention (plain forward, dQ, dK/dV and the autograd
Function) against the JAX package's Pallas flash kernels run in interpret
mode on the CPU (the exact kernel code the TPU compiles).

Inputs come from numpy with a seed.  Tolerance 5e-5 (abs and rel), as the
JAX package's own flash tests use: fp32, the two packages sum in other
orders (blockwise online softmax against one dense softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.flash_attention as jfa
from paddle_tpu import flags
from paddle_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = flags.get_flags(["flash_attention_interpret",
                           "flash_attention_block_q",
                           "flash_attention_block_kv"])
    flags.set_flags({"flash_attention_interpret": True,
                     "flash_attention_block_q": 64,
                     "flash_attention_block_kv": 64})
    yield
    flags.set_flags(old)


def _inputs(seed, b, sq, sk, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                      (b, sq, hq, d))]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# (b, sq, sk, hq, hkv, d, causal): plain, causal, GQA group 4, and sq < sk
# (the shape of the JAX package's test_backward_decode_shape)
CASES = [
    (2, 128, 128, 4, 4, 64, False),
    (2, 128, 128, 4, 4, 64, True),
    (2, 128, 128, 8, 2, 64, False),
    (2, 128, 128, 8, 2, 64, True),
    (1, 64, 192, 2, 2, 64, True),
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", CASES)
def test_plain_forward_and_backward_match_pallas_kernels(b, sq, sk, hq, hkv,
                                                         d, causal):
    q, k, v, g = _inputs(sq + hkv + causal, b, sq, sk, hq, hkv, d)
    assert jfa._pallas_mode() == "interpret"
    j_out, j_lse = jfa._fa_pallas_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, None,
        None, (64, 64), "interpret")
    j_out = jnp.swapaxes(j_out, 1, 2)                  # [b, sq, hq, d]
    j_dq, j_dk, j_dv = jfa._fa_pallas_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_out, j_lse,
        jnp.asarray(g), causal, None, None, None, (64, 64), "interpret")

    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = fa._reference_attention_lse(tq, tk, tv, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0], **TOL)
    delta = fa._delta(out, tg)
    dq = fa._flash_bwd_dq(tq, tk, tv, tg, lse, delta, causal)
    dk, dv = fa._flash_bwd_dkv(tq, tk, tv, tg, lse, delta, causal)
    assert dq.shape == tq.shape and dk.shape == tk.shape and dv.shape == tv.shape
    for got, want in ((dq, j_dq), (dk, j_dk), (dv, j_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the public CPU dispatch takes the same plain steps
    f_out, f_lse = fa.flash_forward(tq, tk, tv, causal)
    assert torch.equal(f_out, out) and torch.equal(f_lse, lse)
    for got, want in zip(fa.flash_backward(tq, tk, tv, out, lse, tg, causal),
                         (dq, dk, dv)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_backward_matches_autograd_of_plain_forward(causal):
    """The Function's explicit backward (delta, dQ, dK/dV) against torch
    autograd through the plain forward, GQA group 2, sq < sk."""
    q, k, v, g = _inputs(7, 2, 48, 80, 4, 2, 16)
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    ref_leaves = [x.requires_grad_() for x in _t(q, k, v)]
    ref = fa._reference_attention(*ref_leaves, causal)
    want = torch.autograd.grad(ref, ref_leaves, torch.from_numpy(g))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


def test_mask_and_dropout_run_through_the_autograd_function():
    """A masked call and a dropout call both go through _FlashAttention
    (no plain autograd): the mask output equals the reference's, dropout
    runs and is off outside training, as in the reference."""
    q, k, v, _ = _inputs(3, 1, 32, 32, 2, 2, 16)
    mask = np.random.default_rng(4).standard_normal((1, 1, 32, 32)).astype(
        np.float32)
    want = jfa._reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True,
                                    mask=jnp.asarray(mask))
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    got = fa.flash_attention(*leaves, causal=True,
                             attn_mask=torch.from_numpy(mask))
    assert type(got.grad_fn).__name__ == "_FlashAttentionBackward"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    dropped = fa.flash_attention(*leaves, dropout=0.1,
                                 generator=torch.Generator().manual_seed(0))
    assert type(dropped.grad_fn).__name__ == "_FlashAttentionBackward"
    full = fa._reference_attention(*_t(q, k, v), False)
    assert bool(torch.isfinite(dropped).all())
    assert not torch.allclose(dropped.detach(), full)
    # dropout is off outside training, as in the reference
    torch.testing.assert_close(
        fa.flash_attention(*_t(q, k, v), dropout=0.1, training=False), full)
