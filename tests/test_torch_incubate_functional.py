"""The port's fused functional API (``paddle_tpu_torch.incubate.nn.
functional``) and ``nn.functional.flashmask_attention`` against the JAX
package, on the CPU.

The same seeded numpy inputs go through the reference's function and the
port's; floats are held in fp32 within TOL of the largest value compared
(ATTN_TOL where the port's flash or paged-attention plain version computes
the softmax in another order than the reference's einsum), integer outputs
exactly.  The reference's ``decode_attention`` takes its plain
``_reference_ragged_paged_attention`` on the CPU; the port's takes the
paged kernel's plain version.  Gradients of ``flashmask_attention`` are
held against ``jax.grad`` of the reference (jitted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.incubate.nn.functional as JF
import paddle_tpu.nn.functional as JNF
from paddle_tpu.core.tensor import Tensor as JT
import paddle_tpu_torch.incubate.nn.functional as TF_
import paddle_tpu_torch.nn.functional as TNF
from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)

TOL = 2e-5
ATTN_TOL = 1e-4
BF16_TOL = 2 ** -7          # one bf16 ulp at the largest value compared


def _x(*shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _np(v):
    if torch.is_tensor(v):
        return v.detach().float().numpy()
    v = v._data if isinstance(v, JT) else v
    return np.asarray(jnp.asarray(v, jnp.float32))


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _j(a):
    return P.to_tensor(a)


def _t(a):
    return torch.tensor(a)


def test_namespace_has_every_reference_name():
    want = {"fused_rms_norm", "fused_layer_norm", "swiglu",
            "fused_rotary_position_embedding", "fused_bias_act",
            "fused_linear", "fused_linear_activation", "fused_dropout_add",
            "decode_attention", "block_multihead_attention",
            "masked_multihead_attention", "number_count", "fused_moe",
            "flash_attention"}
    assert want <= set(TF_.__all__)
    assert all(callable(getattr(TF_, n)) for n in want)
    assert TF_.block_multihead_attention is TF_.decode_attention
    assert TF_.flash_attention is tfa.flash_attention


@pytest.mark.parametrize("axis,bias", [(-1, False), (-1, True), (1, False)])
def test_fused_rms_norm(axis, bias):
    x = _x(2, 6, 16)
    w = _x(*((16,) if axis == -1 else (6, 16)), seed=1)
    b = _x(*w.shape, seed=2) if bias else None
    want = JF.fused_rms_norm(_j(x), _j(w), None if b is None else _j(b),
                             epsilon=1e-6, begin_norm_axis=axis)
    got = TF_.fused_rms_norm(_t(x), _t(w), None if b is None else _t(b),
                             epsilon=1e-6, begin_norm_axis=axis)
    _close(got, want, TOL)


def test_fused_rms_norm_bf16_keeps_dtype():
    x = _x(4, 32).astype(jnp.bfloat16)
    w = _x(32, seed=1)
    want = JF.fused_rms_norm(_j(x), _j(w))
    got = TF_.fused_rms_norm(torch.tensor(x.astype(np.float32)).bfloat16(),
                             _t(w))
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_fused_layer_norm():
    x, w, b = _x(3, 5, 24), _x(24, seed=1), _x(24, seed=2)
    _close(TF_.fused_layer_norm(_t(x), _t(w), _t(b), epsilon=1e-5),
           JF.fused_layer_norm(_j(x), _j(w), _j(b), epsilon=1e-5), TOL)


def test_swiglu_one_and_two_operands():
    g, u = _x(2, 6, 16), _x(2, 6, 16, seed=1)
    want = JF.swiglu(_j(g), _j(u))
    _close(TF_.swiglu(_t(g), _t(u)), want, TOL)
    packed = np.concatenate([g, u], axis=-1)
    _close(TF_.swiglu(_t(packed)), JF.swiglu(_j(packed)), TOL)


ROPE_TABLES = ("none", "b1s1d", "sd", "sd2")


def _rope_tables(form, s, d, neox):
    """Tables of the given form, from the reference's frequencies."""
    from paddle_tpu.models.llama import _rope_cos_sin
    c, si = (np.asarray(a) for a in _rope_cos_sin(s, d, 10000.0,
                                                  jnp.float32))
    if form == "none":
        return None, None
    if form == "sd2":
        return si, c
    # full-width tables: each frequency twice, in the layout the style reads
    full = (lambda a: np.concatenate([a, a], -1)) if neox else \
        (lambda a: np.repeat(a, 2, axis=-1))
    si, c = full(si), full(c)
    if form == "b1s1d":
        return si[None, :, None, :], c[None, :, None, :]
    return si, c


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "interleaved"])
@pytest.mark.parametrize("form", ROPE_TABLES)
def test_fused_rotary_position_embedding(neox, form):
    b, s, h, d = 2, 8, 3, 16
    q, k, v = _x(b, s, h, d), _x(b, s, h, d, seed=1), _x(b, s, h, d, seed=2)
    sin, cos = _rope_tables(form, s, d, neox)
    # positions read backwards in row 0 and shifted in row 1
    pos = np.stack([np.arange(s)[::-1], (np.arange(s) + 3) % s]).astype(
        np.int64)
    for pid in (None, pos):
        want = JF.fused_rotary_position_embedding(
            _j(q), _j(k), _j(v), sin=None if sin is None else _j(sin),
            cos=None if cos is None else _j(cos),
            position_ids=None if pid is None else _j(pid),
            use_neox_rotary_style=neox)
        got = TF_.fused_rotary_position_embedding(
            _t(q), _t(k), _t(v), sin=None if sin is None else _t(sin),
            cos=None if cos is None else _t(cos),
            position_ids=None if pid is None else _t(pid),
            use_neox_rotary_style=neox)
        for g, w in zip(got, want):
            _close(g, w, TOL, f"{form} {pid is not None}")
    q_only = TF_.fused_rotary_position_embedding(_t(q),
                                                 use_neox_rotary_style=neox)
    assert q_only[1] is None and q_only[2] is None


@pytest.mark.parametrize("act", ["gelu", "geglu", "swiglu", "relu", "silu"])
def test_fused_bias_act(act):
    """``silu`` is not one of the reference's names: it gives ReLU."""
    x, b = _x(4, 32) * 2, _x(32, seed=1)
    want = JF.fused_bias_act(_j(x), _j(b), act_method=act)
    got = TF_.fused_bias_act(_t(x), _t(b), act_method=act)
    _close(got, want, TOL)
    if act == "silu":
        _close(got, torch.relu(_t(x) + _t(b)), 0.0)
    if act == "gelu":     # the tanh approximation, as jax.nn.gelu's default
        _close(got, torch.nn.functional.gelu(_t(x) + _t(b),
                                             approximate="tanh"), 1e-6)


@pytest.mark.parametrize("trans_y", [False, True])
def test_fused_linear_activation_ignores_trans_x(trans_y):
    x, b = _x(4, 16), _x(24, seed=2)
    y = _x(*((24, 16) if trans_y else (16, 24)), seed=1)
    for trans_x in (False, True):
        want = JF.fused_linear_activation(_j(x), _j(y), _j(b),
                                          trans_x=trans_x, trans_y=trans_y,
                                          activation="gelu")
        got = TF_.fused_linear_activation(_t(x), _t(y), _t(b),
                                          trans_x=trans_x, trans_y=trans_y,
                                          activation="gelu")
        _close(got, want, TOL)


def _paged_case(B=3, qh=8, kvh=2, d=64, page=8, pages=24, ctxs=(5, 17, 40),
                seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, qh, d)).astype(np.float32)
    kc = rng.standard_normal((kvh, pages, page, d)).astype(np.float32)
    vc = rng.standard_normal((kvh, pages, page, d)).astype(np.float32)
    per = -(-max(ctxs) // page)
    bt = rng.permutation(pages)[:B * per].reshape(B, per).astype(np.int64)
    return q, kc, vc, bt, np.asarray(ctxs, np.int64)


@pytest.mark.parametrize("qh,kvh", [(8, 2), (4, 4)], ids=["gqa4", "mha"])
def test_decode_attention(qh, kvh):
    """int64 block tables and lengths (the Paddle API's default) are cast
    on the device; ``block_multihead_attention`` is the same function."""
    q, kc, vc, bt, cl = _paged_case(qh=qh, kvh=kvh)
    want = JF.decode_attention(_j(q), _j(kc), _j(vc), _j(bt.astype(np.int32)),
                               _j(cl.astype(np.int32)))
    got = TF_.decode_attention(_t(q), _t(kc), _t(vc), _t(bt), _t(cl))
    _close(got, want, ATTN_TOL)
    got2 = TF_.block_multihead_attention(_t(q), _t(kc), _t(vc), bt, cl)
    assert torch.equal(got, got2)


def test_masked_multihead_attention_returns_the_updated_cache():
    B, h, S, d = 3, 4, 12, 8
    x = _x(B, 3 * h * d)
    cache = _x(2, B, h, S, d, seed=1)
    lens = np.array([0, 5, 11], np.int64)
    want_out, want_cache = JF.masked_multihead_attention(_j(x), _j(cache),
                                                         _j(lens))
    cache_t = _t(cache)
    got_out, got_cache = TF_.masked_multihead_attention(_t(x), cache_t,
                                                        _t(lens))
    _close(got_out, want_out, TOL)
    np.testing.assert_array_equal(_np(got_cache), _np(want_cache))
    np.testing.assert_array_equal(cache_t.numpy(), cache)   # not written


def test_number_count_is_exact():
    ids = np.random.default_rng(0).integers(-2, 9, size=(4, 25))
    want = JF.number_count(_j(ids), 7).numpy()
    got = TF_.number_count(_t(ids), 7)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _moe_weights(H=16, E=4, I=12, seed=0, bias=False):
    rng = np.random.default_rng(seed)
    w = dict(gate=rng.standard_normal((H, E)).astype(np.float32),
             w1=(rng.standard_normal((E, H, 2 * I)) / 4).astype(np.float32),
             w2=(rng.standard_normal((E, I, H)) / 4).astype(np.float32))
    if bias:
        w["b1"] = rng.standard_normal((E, 1, 2 * I)).astype(np.float32)
        w["b2"] = rng.standard_normal((E, 1, H)).astype(np.float32)
    return w


@pytest.mark.parametrize("topk,norm,bias", [(2, True, False),
                                            (1, False, True),
                                            (3, True, True)])
def test_fused_moe_fp32(topk, norm, bias):
    w = _moe_weights(bias=bias)
    x = _x(2, 5, 16, seed=3)

    def call(mod, conv):
        return mod.fused_moe(
            conv(x), conv(w["gate"]), conv(w["w1"]), conv(w["w2"]),
            ffn1_bias=conv(w["b1"]) if bias else None,
            ffn2_bias=conv(w["b2"]) if bias else None, moe_topk=topk,
            norm_topk_prob=norm)
    _close(call(TF_, _t), call(JF, _j), TOL)


def test_fused_moe_bf16_sums_in_the_input_dtype():
    w = _moe_weights()
    x = _x(2, 5, 16, seed=3)
    bf = jnp.bfloat16
    want = JF.fused_moe(*(_j(np.asarray(a).astype(bf)) for a in
                          (x, w["gate"], w["w1"], w["w2"])))
    got = TF_.fused_moe(*(torch.tensor(a).bfloat16() for a in
                          (x, w["gate"], w["w1"], w["w2"])))
    assert got.dtype == torch.bfloat16
    _close(got, want, 4 * BF16_TOL)


def test_fused_moe_quantized_raises():
    w = _moe_weights()
    args = [_t(a) for a in (_x(1, 2, 16), w["gate"], w["w1"], w["w2"])]
    with pytest.raises(NotImplementedError):
        TF_.fused_moe(*args, quant_method="weight_only_int8")
    with pytest.raises(NotImplementedError):
        TF_.fused_moe(*args, ffn1_scale=torch.ones(4))


# ---- flashmask_attention ----

def _doc_starts(rng, b, h, sk, docs):
    """Document-style ``startend_row_indices`` ``[b, h, sk, 1]``: key j is
    visible to rows before the end of its document, so start[j] > j."""
    out = np.empty((b, h, sk, 1), np.int32)
    for i in range(b):
        for j in range(h):
            cuts = np.sort(rng.choice(np.arange(1, sk), docs - 1,
                                      replace=False))
            ends = np.concatenate([cuts, [sk]])
            out[i, j, :, 0] = ends[np.searchsorted(ends, np.arange(sk),
                                                   side="right")]
    return out


FLASHMASK_CASES = {
    "causal": dict(hq=4, hkv=4, hm=1, sq=32, causal=True),
    "full": dict(hq=4, hkv=4, hm=1, sq=32, causal=False),
    "gqa_causal": dict(hq=4, hkv=2, hm=1, sq=32, causal=True),
    "per_head": dict(hq=4, hkv=2, hm=4, sq=32, causal=True),
    "sq_lt_sk_causal": dict(hq=2, hkv=2, hm=2, sq=24, causal=True),
}


@pytest.mark.parametrize("case", FLASHMASK_CASES)
def test_flashmask_attention_and_its_gradient(case, monkeypatch):
    c = FLASHMASK_CASES[case]
    b, sk, d = 2, 32, 16
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, c["sq"], c["hq"], d)).astype(np.float32)
    k = rng.standard_normal((b, sk, c["hkv"], d)).astype(np.float32)
    v = rng.standard_normal((b, sk, c["hkv"], d)).astype(np.float32)
    si = _doc_starts(rng, b, c["hm"], sk, docs=3)
    cot = rng.standard_normal(q.shape).astype(np.float32)

    def ref(q_, k_, v_):
        return JNF.flashmask_attention(JT(q_), JT(k_), JT(v_), JT(si),
                                       causal=c["causal"])._data

    want = jax.jit(ref)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: (ref(*a) * cot).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    masks = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a, **kw: (
        masks.append(kw["attn_mask"]), real(*a, **kw))[1])
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = TNF.flashmask_attention(tq, tk, tv, _t(si), dropout=0.5,
                                  causal=c["causal"])
    (got * _t(cot)).sum().backward()
    assert len(masks) == 1 and masks[0].dtype == torch.float32
    assert tuple(masks[0].shape) == (b, c["hm"], c["sq"], sk)
    _close(got, want, ATTN_TOL, "out")
    for g, w, n in zip((tq.grad, tk.grad, tv.grad), grads, "qkv"):
        _close(g, w, ATTN_TOL, f"d{n}")


@pytest.mark.parametrize("causal", [False, True])
def test_flashmask_attention_without_indices_is_sdpa(causal):
    q, k, v = (_x(2, 16, 2, 8, seed=s) for s in range(3))
    want = JNF.flashmask_attention(_j(q), _j(k), _j(v), causal=causal)
    got = TNF.flashmask_attention(_t(q), _t(k), _t(v), causal=causal)
    _close(got, want, TOL)
    assert torch.equal(got, TNF.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), is_causal=causal))


def test_flashmask_attention_bf16():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 32, 2, 16)).astype(np.float32)
               for _ in range(3))
    si = _doc_starts(rng, 1, 1, 32, docs=2)
    bf = jnp.bfloat16
    want = JNF.flashmask_attention(*(_j(a.astype(bf)) for a in (q, k, v)),
                                   _j(si), causal=True)
    got = TNF.flashmask_attention(*(torch.tensor(a).bfloat16()
                                    for a in (q, k, v)), _t(si), causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
