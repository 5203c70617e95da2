"""The port's flash-attention modes (additive mask, segment ids / varlen,
dropout, head dims 96 and 256) against the JAX package's Pallas flash
kernels run in interpret mode on the CPU (the exact kernel code the TPU
compiles), blocks 64/64.

Inputs come from numpy with a seed.  Tolerances as the JAX package's own
flash tests state them: fp32 2e-5 for the forward, 5e-5 for the gradients
(the two packages sum in other orders: blockwise online softmax against one
dense softmax).  The dropout keep-mask is compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.flash_attention as jfa
from paddle_tpu import flags
from paddle_tpu_torch.kernels import flash_attention as fa

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


def _inputs(seed, b, sq, sk, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d),
                      (b, sq, hq, d))]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(x):
    return None if x is None else jnp.asarray(x)


def _seed_pair(value):
    """The same seed for both packages: the reference's fp32 (1, 1) operand
    and the port's int32 [1]."""
    return (jnp.full((1, 1), float(value), jnp.float32),
            torch.tensor([value], dtype=torch.int32))


def _pallas(q, k, v, g, causal, mask=None, seg_q=None, seg_k=None,
            drop_p=0.0, seed=None):
    """(out, lse, dq, dk, dv) of the interpreted Pallas kernels."""
    args = (_j(q), _j(k), _j(v))
    modes = (_j(mask), _j(seg_q), _j(seg_k))
    out, lse = jfa._fa_pallas_forward(*args, causal, *modes, (64, 64),
                                      "interpret", drop_p, seed)
    out = jnp.swapaxes(out, 1, 2)
    grads = jfa._fa_pallas_backward(*args, out, lse, _j(g), causal, *modes,
                                    (64, 64), "interpret", drop_p, seed)
    return (np.asarray(out), np.asarray(lse)[..., 0],
            *(np.asarray(x) for x in grads))


def _port(q, k, v, g, causal, **modes):
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = fa.flash_forward(tq, tk, tv, causal, **modes)
    return (out, lse, *fa.flash_backward(tq, tk, tv, out, lse, tg, causal,
                                         **modes))


def _assert_all_close(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b, **(FWD if i < 2 else GRAD),
                                   err_msg=("out", "lse", "dq", "dk", "dv")[i])


# ------------------------------------------------------------ keep-mask ---

@pytest.mark.parametrize("seed", [0, 7, (1 << 23) - 1])
def test_drop_keep_dense_is_bitwise_the_reference(seed):
    shape = (2, 3, 300, 260)
    want = np.asarray(jfa._drop_keep_dense(shape, jnp.uint32(seed), 0.3))
    got = fa._drop_keep_dense(shape, torch.tensor([seed], dtype=torch.int32),
                              0.3)
    assert got.dtype == torch.bool and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    # an fp32 seed is truncated through int32, as the reference's _seed_u32
    got_f = fa._drop_keep_dense(shape, torch.tensor([float(seed)]), 0.3)
    assert torch.equal(got_f, got)


def test_keep_mask_read_off_the_interpreted_forward():
    """q = 0 and v = I (sk = d): out[b, row, h, col] = keep * inv / sk, so
    the Pallas kernel's keep-mask reads off its output; it equals the
    port's, bit for bit, and so does the port's plain forward."""
    b, sq, h, d, p = 2, 64, 2, 64, 0.3
    q = np.zeros((b, sq, h, d), np.float32)
    v = np.broadcast_to(np.eye(d, dtype=np.float32)[None, :, None, :],
                        (b, d, h, d)).copy()
    k = np.random.default_rng(1).standard_normal((b, d, h, d)).astype(
        np.float32)
    jseed, tseed = _seed_pair(11)
    out, _ = jfa._fa_pallas_forward(_j(q), _j(k), _j(v), False, None, None,
                                    None, (64, 64), "interpret", p, jseed)
    out = np.asarray(out)                                 # [b, h, sq, d]
    kernel_keep = out != 0
    want = fa._drop_keep_dense((b, h, sq, d), tseed, p).numpy()
    np.testing.assert_array_equal(kernel_keep, want)
    inv = np.float32(1.0 / (1.0 - p))
    np.testing.assert_array_equal(out[kernel_keep],
                                  np.float32(inv / np.float32(d)))
    plain = fa._reference_attention(*_t(q, k, v), False, drop_p=p,
                                    seed=tseed).transpose(1, 2).numpy()
    np.testing.assert_array_equal(plain != 0, want)


# ----------------------------------------------------------------- mask ---

@pytest.mark.parametrize("mask_heads,causal,hkv", [(1, False, 4),
                                                   (4, False, 4),
                                                   (1, True, 2)])
def test_additive_mask_matches_pallas(mask_heads, causal, hkv):
    """mask_heads 1 and h, non-causal (mask 0 / -1e30, as the reference's
    test_additive_mask_parity), and with causal and GQA (a real-valued
    mask, as test_mask_composes_with_causal_and_gqa)."""
    b, s, hq, d = 1, 128, 4, 64
    q, k, v, g = _inputs(mask_heads + 10 * causal, b, s, s, hq, hkv, d)
    rng = np.random.default_rng(mask_heads)
    if causal:
        mask = (rng.standard_normal((b, 1, s, s)) * 0.5).astype(np.float32)
    else:
        mask = np.where(rng.random((b, mask_heads, s, s)) > 0.2, 0.0,
                        -1e30).astype(np.float32)
    want = _pallas(q, k, v, g, causal, mask=mask)
    got = _port(q, k, v, g, causal, mask=torch.from_numpy(mask))
    _assert_all_close(got, want)


def test_mask_gets_no_gradient_and_qkv_grads_equal_the_reference():
    """The reference's _fa_core_bwd returns zeros for the mask; the port
    returns None for it from _FlashAttention, on every device."""
    q, k, v, g = _inputs(5, 1, 16, 16, 2, 2, 64)
    mask = np.random.default_rng(6).standard_normal((1, 1, 16, 16)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b_, c, m: jfa._flash_attention_arrays(
        a, b_, c, False, mask=m), *map(_j, (q, k, v, mask)))
    want = vjp(_j(g))
    assert not np.any(np.asarray(want[3]))
    leaves = [x.requires_grad_() for x in _t(q, k, v, mask)]
    out = fa.flash_attention(*leaves[:3], causal=False, attn_mask=leaves[3])
    out.backward(torch.from_numpy(g))
    tm = leaves[3]
    assert tm.grad is None or not bool(tm.grad.any())
    for leaf, w in zip(leaves[:3], want[:3]):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD)


# --------------------------------------------------------------- varlen ---

def _cu(lens):
    return np.cumsum([0] + list(lens)).astype(np.int32)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_matches_reference_varlen(causal):
    """The scenario of test_varlen_segment_kernel_parity: the reference's
    flash_attn_varlen runs the interpreted segment-mode kernels."""
    lens = [70, 128, 58]
    total, h, d = sum(lens), 4, 64
    rng = np.random.default_rng(3 + causal)
    q, k, v = (rng.standard_normal((total, h, d)).astype(np.float32)
               for _ in range(3))
    cu = _cu(lens)
    want = jfa.flash_attn_varlen(_j(q), _j(k), _j(v), _j(cu), _j(cu),
                                 causal=causal)
    want = want.numpy() if hasattr(want, "numpy") else np.asarray(want)
    got = fa.flash_attn_varlen(*_t(q, k, v), torch.from_numpy(cu),
                               torch.from_numpy(cu), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    assert fa.flash_attn_unpadded is fa.flash_attn_varlen


def test_varlen_gradients_match_reference():
    """test_varlen_backward_grads: gradients through the causal varlen
    path against the reference's (interpreted kernels)."""
    lens = [60, 68]
    total = sum(lens)
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.standard_normal((total, 2, 64)).astype(np.float32)
                  for _ in range(4))
    cu = _cu(lens)

    def loss(a, b_, c):
        out = jfa.flash_attn_varlen(a, b_, c, _j(cu), _j(cu), causal=True)
        out = out._data if hasattr(out, "_data") else out
        return (out * _j(g)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    out = fa.flash_attn_varlen(*leaves, torch.from_numpy(cu),
                               torch.from_numpy(cu), causal=True)
    out.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), **GRAD)


def test_varlen_causal_with_different_packings_raises():
    x = torch.zeros((8, 2, 64))
    cu = torch.tensor([0, 4, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="identical"):
        fa.flash_attn_varlen(x, x[:6], x[:6], cu,
                             torch.tensor([0, 6], dtype=torch.int32),
                             causal=True)
    with pytest.raises(ValueError, match="differ"):
        fa.flash_attn_varlen(x, x, x, cu,
                             torch.tensor([0, 3, 8], dtype=torch.int32),
                             causal=True)


def test_segments_with_an_empty_key_segment_match_pallas():
    """Non-causal, different packings, the middle k segment empty: its
    queries have no live key, and the interpreted kernel gives them the
    uniform average of every key (p = 1 at -1e30); forward and backward."""
    qlens, klens = [100, 56, 100], [128, 0, 128]
    q, k, v, g = _inputs(21, 1, 256, 256, 2, 2, 64)
    segs = [torch.repeat_interleave(torch.arange(3), torch.tensor(n))[None]
            for n in (qlens, klens)]
    cu_q, cu_k = torch.from_numpy(_cu(qlens)), torch.from_numpy(_cu(klens))
    assert torch.equal(fa._segments_from_cu(cu_q, 256)[0][None], segs[0])
    assert torch.equal(fa._segments_from_cu(cu_k, 256)[0][None], segs[1])
    want = _pallas(q, k, v, g, False, seg_q=segs[0].float().numpy(),
                   seg_k=segs[1].float().numpy())
    got = _port(q, k, v, g, False, seg_q=segs[0], seg_k=segs[1])
    _assert_all_close(got, want)
    empty = got[0][0, 100:156]                            # [56, h, d]
    np.testing.assert_allclose(
        empty.numpy(), np.broadcast_to(v[0].mean(0), empty.shape), **FWD)


# -------------------------------------------------------------- dropout ---

@pytest.mark.parametrize("causal,hkv,p", [(False, 2, 0.3), (True, 2, 0.25),
                                          (False, 1, 0.2)])
def test_dropout_matches_pallas_with_the_same_seed(causal, hkv, p):
    """test_kernel_matches_dense_reference_with_same_mask,
    test_backward_matches_dense_reference and test_gqa_dropout_backward:
    forward and backward against the interpreted kernels, GQA included."""
    q, k, v, g = _inputs(30 + hkv + causal, 1, 128, 128, 2, hkv, 64)
    jseed, tseed = _seed_pair(7 if hkv == 2 else 3)
    want = _pallas(q, k, v, g, causal, drop_p=p, seed=jseed)
    got = _port(q, k, v, g, causal, drop_p=p, seed=tseed)
    _assert_all_close(got, want)


def test_dropout_p0_rate_seeds_and_eval():
    """test_p0_matches_no_dropout, test_keep_rate_and_mean_preservation,
    test_seed_determinism_and_variation and the training=False case of
    test_tensor_api_training_eval_and_paddle_seed, on the port alone."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4, 1, 64, 64, 2, 2, 64))
    base = fa.flash_attention_arrays(q, k, v, True)
    torch.testing.assert_close(
        fa.flash_attention_arrays(q, k, v, True, drop_p=0.0, seed=7), base,
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention_arrays(q, k, v, True, drop_p=0.1)
    keep = fa._drop_keep_dense((2, 4, 256, 256), 123, 0.3)
    assert abs(float(keep.float().mean()) - 0.7) < 0.01
    assert (keep[0, 0] != keep[0, 1]).float().mean() > 0.1
    assert (keep[0, 0] != keep[1, 0]).float().mean() > 0.1
    a1 = fa.flash_attention_arrays(q, k, v, False, drop_p=0.3, seed=5)
    a2 = fa.flash_attention_arrays(q, k, v, False, drop_p=0.3, seed=5)
    b = fa.flash_attention_arrays(q, k, v, False, drop_p=0.3, seed=6)
    assert torch.equal(a1, a2) and not torch.allclose(a1, b)
    ev = fa.flash_attention(q, k, v, dropout=0.3, training=False)
    torch.testing.assert_close(ev, fa.flash_attention(q, k, v), rtol=0,
                               atol=0)
    t1 = fa.flash_attention(q, k, v, dropout=0.3,
                            generator=torch.Generator().manual_seed(42))
    t2 = fa.flash_attention(q, k, v, dropout=0.3,
                            generator=torch.Generator().manual_seed(42))
    assert torch.equal(t1, t2)
    torch.manual_seed(42)
    t3 = fa.flash_attention(q, k, v, dropout=0.3, rng_name="local_seed")
    t4 = fa.flash_attention(q, k, v, dropout=0.3)      # the stream advanced
    assert not torch.allclose(t3, t4)
    assert abs(float(t1.mean()) - float(fa.flash_attention(q, k, v).mean())) \
        < 0.05


def test_public_flash_attention_mask_and_dropout_match_the_reference(
        monkeypatch):
    """kernels.flash_attention.flash_attention with attn_mask and dropout:
    the reference draws its seed from paddle's stream; the port is fed the
    same seed through _draw_seed."""
    import paddle_tpu as P
    from paddle_tpu.core.random import next_key
    q, k, v, _ = _inputs(12, 1, 64, 64, 2, 2, 64)
    mask = np.random.default_rng(2).standard_normal((1, 2, 64, 64)).astype(
        np.float32)
    P.seed(42)
    seed = int(jax.random.randint(next_key(), (1, 1), 0, 1 << 23)[0, 0])
    P.seed(42)
    want = jfa.flash_attention(*(P.to_tensor(x) for x in (q, k, v)),
                               causal=True, attn_mask=P.to_tensor(mask),
                               dropout=0.2).numpy()
    monkeypatch.setattr(fa, "_draw_seed", lambda device, generator=None:
                        torch.tensor([seed], dtype=torch.int32))
    got = fa.flash_attention(*_t(q, k, v), causal=True,
                             attn_mask=torch.from_numpy(mask), dropout=0.2)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


# ------------------------------------------------------------ head dims ---

@pytest.mark.parametrize("d,causal,modes", [(96, True, "mask+dropout"),
                                            (256, False, "dropout")])
def test_head_dims_96_and_256_match_pallas(d, causal, modes):
    q, k, v, g = _inputs(d, 1, 128, 128, 2, 1, d)
    jseed, tseed = _seed_pair(99)
    mask = None
    if "mask" in modes:
        mask = (np.random.default_rng(d).standard_normal((1, 1, 128, 128))
                * 0.5).astype(np.float32)
    want = _pallas(q, k, v, g, causal, mask=mask, drop_p=0.1, seed=jseed)
    got = _port(q, k, v, g, causal,
                mask=None if mask is None else torch.from_numpy(mask),
                drop_p=0.1, seed=tseed)
    _assert_all_close(got, want)
    assert d in fa._HEAD_DIMS
