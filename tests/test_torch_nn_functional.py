"""The port's ``nn.functional`` attention ops against the JAX package's:
``scaled_dot_product_attention`` (plain on both sides), ``flash_attention``,
``flash_attn_qkvpacked`` and ``flash_attn_varlen_qkvpacked`` (the reference
runs its Pallas flash kernels in interpret mode, blocks 64/64).

Inputs come from numpy with a seed; where dropout is on, the port is fed
the seed the reference draws from paddle's stream (through the port's
internal ``_draw_seed``).  Tolerances: fp32 2e-5 for outputs, 5e-5 for
gradients (summation order), as the flash tests.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.kernels.flash_attention  # noqa: F401  (defines the flags)
import paddle_tpu.nn.functional as JF
from paddle_tpu import flags
from paddle_tpu.core.random import next_key
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.kernels import flash_attention as fa

F = tnn.functional

torch.set_num_threads(2)

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)


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


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _feed_reference_seed(monkeypatch, value):
    """Seed paddle's stream with ``value``, and make the port draw the seed
    the reference's next op will draw."""
    P.seed(value)
    seed = int(jax.random.randint(next_key(), (1, 1), 0, 1 << 23)[0, 0])
    P.seed(value)
    monkeypatch.setattr(fa, "_draw_seed", lambda device, generator=None:
                        torch.tensor([seed], dtype=torch.int32, device=device))


@pytest.mark.parametrize("mask_kind,causal", [(None, False), (None, True),
                                              ("bool", False),
                                              ("additive", True)])
def test_sdpa_matches_reference(mask_kind, causal):
    """sq < sk: the causal diagonal is top-left (tril with no offset) and
    masks with -1e9; bool masks select, float masks add."""
    q, k, v = _arrays(1, (2, 24, 2, 16), (2, 40, 2, 16), (2, 40, 2, 16))
    mask = None
    if mask_kind == "bool":
        mask = np.random.default_rng(2).random((2, 1, 24, 40)) > 0.3
    elif mask_kind == "additive":
        mask = np.random.default_rng(3).standard_normal(
            (2, 2, 24, 40)).astype(np.float32)
    want = JF.scaled_dot_product_attention(
        P.to_tensor(q), P.to_tensor(k), P.to_tensor(v),
        attn_mask=None if mask is None else P.to_tensor(mask),
        is_causal=causal).numpy()
    got = F.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


def test_sdpa_dropout_matches_reference_given_the_seed(monkeypatch):
    q, k, v = _arrays(4, *[(1, 32, 2, 16)] * 3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    base = F.scaled_dot_product_attention(tq, tk, tv, is_causal=True)
    ev = F.scaled_dot_product_attention(tq, tk, tv, dropout_p=0.5,
                                        is_causal=True, training=False)
    torch.testing.assert_close(ev, base, rtol=0, atol=0)
    _feed_reference_seed(monkeypatch, 7)
    want = JF.scaled_dot_product_attention(
        *(P.to_tensor(x) for x in (q, k, v)), dropout_p=0.3,
        is_causal=True).numpy()
    got = F.scaled_dot_product_attention(tq, tk, tv, dropout_p=0.3,
                                         is_causal=True)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    assert not np.allclose(got.numpy(), base.numpy())


@pytest.mark.parametrize("dropout,causal", [(0.0, True), (0.2, False)])
def test_flash_attention_matches_reference(monkeypatch, dropout, causal):
    q, k, v, g = _arrays(5 + causal, *[(1, 64, 2, 64)] * 4)
    _feed_reference_seed(monkeypatch, 11)
    jq, jk, jv = (P.to_tensor(x, stop_gradient=False) for x in (q, k, v))
    out, sm = JF.flash_attention(jq, jk, jv, dropout=dropout, causal=causal)
    assert sm is None
    (out * P.to_tensor(g)).sum().backward()
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got, tsm = F.flash_attention(*leaves, dropout=dropout, causal=causal)
    assert tsm is None
    np.testing.assert_allclose(got.detach().numpy(), out.numpy(), **FWD)
    got.backward(torch.from_numpy(g))
    for leaf, ref in zip(leaves, (jq, jk, jv)):
        np.testing.assert_allclose(leaf.grad.numpy(), ref.grad.numpy(),
                                   **GRAD)
    # return_softmax=None returns the output alone, as the reference
    alone = F.flash_attention(*leaves, causal=causal, return_softmax=None)
    assert torch.is_tensor(alone)


def test_flash_attn_qkvpacked_matches_reference():
    (qkv,) = _arrays(8, (1, 64, 3, 2, 64))
    want, _ = JF.flash_attn_qkvpacked(P.to_tensor(qkv), causal=True)
    packed = torch.from_numpy(qkv).requires_grad_()
    got, sm = F.flash_attn_qkvpacked(packed, causal=True)
    assert sm is None and got.shape == (1, 64, 2, 64)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **FWD)
    got.sum().backward()
    assert packed.grad.shape == packed.shape
    assert bool(torch.isfinite(packed.grad).all())


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attn_varlen_qkvpacked_matches_reference(causal):
    lens = [70, 58]
    (qkv,) = _arrays(9 + causal, (sum(lens), 3, 2, 64))
    cu = np.cumsum([0] + lens).astype(np.int32)
    want, _ = JF.flash_attn_varlen_qkvpacked(
        P.to_tensor(qkv), P.to_tensor(cu), P.to_tensor(cu), dropout=0.5,
        scale=3.0, causal=causal)
    got, sm = F.flash_attn_varlen_qkvpacked(
        torch.from_numpy(qkv), torch.from_numpy(cu), torch.from_numpy(cu),
        dropout=0.5, scale=3.0, causal=causal)
    assert sm is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)
