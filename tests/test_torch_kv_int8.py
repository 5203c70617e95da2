"""The port's int8 KV plane and mixed pool dtypes against the JAX package.

- Attention over an int8 pool (one fp32 scale per (kv-head, page)): the
  port's plain version against JAX ``_reference_ragged_paged_attention``
  with ``k_scale``/``v_scale``, fp32, tolerance 1e-5 (summation order).
- The quantized all-layer commit against JAX
  ``write_kv_pages_all_layers_quantized`` on the same fp32 rows: int8 bytes
  and scales equal.  A one-step byte difference is allowed only where the
  pre-rounding value ``x / scale`` lies within 1e-5 of a half-integer (the
  two frameworks may round such a value differently); the test counts
  those cases.  The port's planes carry one scratch page past ``num_pages``
  (the drop target); the first ``num_pages`` pages are compared.
- A pool dtype different from the model dtype: bf16 q with an fp32 pool
  and fp32 q with a bf16 pool, plain version against the JAX reference.
  The output is in q's dtype after fp32 math in both: bf16 outputs agree
  to one bf16 rounding (rtol 2**-7), fp32 to 1e-5.
- Engine: greedy tokens of the port's engine with ``cache_dtype="int8"`` on
  ``LlamaConfig.tiny()`` equal the JAX engine's (workload of
  ``tests/test_kv_quant.py``, page 8).

JAX references are jitted (eager JAX costs seconds per call here).  The
CUDA kernel's int8 mode is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference.kv_cache import PagedKVCache as JPagedKVCache
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig, PagedKVCache)
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

_jax_ragged = jax.jit(jpa._reference_ragged_paged_attention)
_jax_commit = jax.jit(jpa.write_kv_pages_all_layers_quantized,
                      static_argnames="max_len")


def _quantize(x):
    """Per-(…, page) absmax int8 of [..., page, d] fp32 (the pool's rule)."""
    amax = np.abs(x).max(axis=(-2, -1))
    sc = np.where(amax > 0, amax / np.float32(127.0), 1.0).astype(np.float32)
    q = np.clip(np.round(x / sc[..., None, None]), -127, 127).astype(np.int8)
    return q, sc


# ------------------------------------------------------------ attention ---

@pytest.mark.parametrize("page,kvh", [(8, 2), (16, 4), (32, 1)])
def test_int8_attention_plain_vs_jax(page, kvh):
    """Mixed prefill + decode over an int8 pool with all-zero pages (scale
    1.0), ragged q_lens incl. an idle row, every table entry in range."""
    rng = np.random.default_rng(page + kvh)
    B, T, qh, d, n_pages, W = 4, 6, 4, 64, 24, 5
    f = np.float32
    x = rng.standard_normal((2, kvh, n_pages, page, d)).astype(f)
    x[:, :, [0, 3]] = 0.0                             # fresh, never written
    kq, ks = _quantize(x[0])
    vq, vs = _quantize(x[1])
    q = rng.standard_normal((B, T, qh, d)).astype(f)
    kn = rng.standard_normal((B, T, kvh, d)).astype(f)
    vn = rng.standard_normal((B, T, kvh, d)).astype(f)
    bt = rng.permutation(n_pages)[:B * W].reshape(B, W).astype(np.int32)
    bt[1, 0] = 3                                      # a zero page in use
    ctx = np.asarray([0, page + 1, 3 * page, 2], np.int32)
    ql = np.asarray([6, 1, 4, 0], np.int32)
    ref, ref_lse = _jax_ragged(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt),
        jnp.asarray(ctx), jnp.asarray(ql), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(ks), jnp.asarray(vs))
    out, lse = pa.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(bt), torch.from_numpy(ctx),
        q_lens=torch.from_numpy(ql), k_new=torch.from_numpy(kn),
        v_new=torch.from_numpy(vn), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs), with_lse=True)
    for b in range(B):
        n = int(ql[b])
        np.testing.assert_allclose(out[b, :n].numpy(), np.asarray(ref[b, :n]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lse[b, :n].numpy(),
                                   np.asarray(ref_lse[b, :n]),
                                   rtol=1e-5, atol=1e-5)
    # the decode form takes the scales too
    dec = pa.paged_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(kq),
                             torch.from_numpy(vq), torch.from_numpy(bt),
                             torch.from_numpy(ctx), k_scale=torch.from_numpy(ks),
                             v_scale=torch.from_numpy(vs))
    want = pa._reference_ragged_paged_attention(
        torch.from_numpy(q[:, :1]), torch.from_numpy(kq), torch.from_numpy(vq),
        torch.from_numpy(bt), torch.from_numpy(ctx),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))[0][:, 0]
    assert torch.equal(dec, want)


def test_scales_must_come_in_pairs():
    q = torch.zeros((1, 1, 2, 64))
    kc = torch.zeros((2, 2, 8, 64), dtype=torch.int8)
    sc = torch.ones((2, 2))
    with pytest.raises(ValueError, match="together"):
        pa.ragged_paged_attention(q, kc, kc, torch.zeros((1, 1), dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32), k_scale=sc)


@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_pool_dtype_differs_from_model_dtype_vs_jax(q_dtype, pool_dtype):
    """The repair of the mixed-dtype fault: q / fresh rows in the model
    dtype, the pool in another; both sides upcast to fp32."""
    rng = np.random.default_rng(11)
    B, T, qh, kvh, d, page, n_pages, W = 3, 4, 4, 2, 64, 8, 12, 4
    f = np.float32
    q = rng.standard_normal((B, T, qh, d)).astype(f)
    kc = rng.standard_normal((kvh, n_pages, page, d)).astype(f)
    vc = rng.standard_normal((kvh, n_pages, page, d)).astype(f)
    kn = rng.standard_normal((B, T, kvh, d)).astype(f)
    vn = rng.standard_normal((B, T, kvh, d)).astype(f)
    bt = rng.permutation(n_pages)[:B * W].reshape(B, W).astype(np.int32)
    ctx = np.asarray([0, 9, 25], np.int32)
    ql = np.asarray([4, 1, 3], np.int32)

    def cast(a, dt):              # round through dt, keep the values exact
        return torch.from_numpy(a).to(dt)

    tq, tkn, tvn = (cast(a, q_dtype) for a in (q, kn, vn))
    tkc, tvc = (cast(a, pool_dtype) for a in (kc, vc))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    ref, ref_lse = _jax_ragged(
        *(jnp.asarray(t.float().numpy()).astype(jdt[t.dtype])
          for t in (tq, tkc, tvc)),
        jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(ql),
        *(jnp.asarray(t.float().numpy()).astype(jdt[t.dtype])
          for t in (tkn, tvn)))
    out, lse = pa.ragged_paged_attention(
        tq, tkc, tvc, torch.from_numpy(bt), torch.from_numpy(ctx),
        q_lens=torch.from_numpy(ql), k_new=tkn, v_new=tvn, with_lse=True)
    assert out.dtype == q_dtype
    rtol = 2 ** -7 if q_dtype == torch.bfloat16 else 1e-5
    for b in range(B):
        n = int(ql[b])
        np.testing.assert_allclose(
            out[b, :n].float().numpy(),
            np.asarray(ref[b, :n].astype(jnp.float32)), rtol=rtol, atol=1e-5)
        np.testing.assert_allclose(lse[b, :n].numpy(),
                                   np.asarray(ref_lse[b, :n]),
                                   rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- the commit ---

def _pre_round(kq, ks, fresh, positions, qlens, bt, page, max_len):
    """numpy mirror of the commit up to the rounding: {page id: x / scale}
    of every touched page, [L, kvh, page, d] fp32."""
    L, kvh, _, _, d = kq.shape
    B, T = qlens.shape[0], fresh.shape[1] // qlens.shape[0]
    out = {}
    for b in range(B):
        p0 = int(positions[b])
        n = sum(1 for t in range(T) if t < qlens[b] and p0 + t < max_len)
        if n == 0:
            continue
        end = p0 + n
        for pi in range(min(p0, max_len - 1) // page, (end - 1) // page + 1):
            pid = int(bt[b, pi])
            x = kq[:, :, pid].astype(np.float32) * ks[:, :, pid][..., None, None]
            live = (pi * page + np.arange(page)) < end
            x = x * live[None, None, :, None].astype(np.float32)
            for t in range(n):
                if (p0 + t) // page == pi:
                    x[:, :, (p0 + t) % page] = fresh[:, b * T + t]
            amax = np.abs(x).max(axis=(2, 3))
            sc = np.where(amax > 0, amax * np.float32(1 / 127), 1.0).astype(
                np.float32)
            out[pid] = x / sc[..., None, None]
    return out


@pytest.mark.parametrize("T,positions,qlens", [
    (6, [5, 0, 17, 3], [6, 3, 0, 2]),   # straddles a page; fresh prefill;
                                        # inert row; decode-sized run
    (1, [7, 8, 0, 31], [1, 1, 1, 1]),   # decode: page ends / starts
    (8, [60, 62, 0, 9], [8, 8, 8, 0]),  # writes past max_len are dropped
])
def test_quantized_commit_matches_jax(T, positions, qlens):
    rng = np.random.default_rng(T * 7 + positions[0])
    L, kvh, n_pages, page, d, B, W, max_len = 2, 2, 40, 8, 16, 4, 8, 64
    f = np.float32
    old = rng.standard_normal((L, kvh, n_pages, page, d)).astype(f) * 3
    kq, ks = _quantize(old)
    vq, vs = _quantize(old[::-1].copy())
    bt = rng.permutation(n_pages)[:B * W].reshape(B, W).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    ql = np.asarray(qlens, np.int32)
    # row 1 starts fresh on a recycled page still holding a predecessor's
    # large bytes: the rows past its extent must not inflate its scale
    kq[:, :, bt[1, pos[1] // page]] = 127
    ks[:, :, bt[1, pos[1] // page]] = 50.0
    k_all = rng.standard_normal((L, B * T, kvh, d)).astype(f)
    v_all = rng.standard_normal((L, B * T, kvh, d)).astype(f)

    jk, jv, jks, jvs = (np.asarray(a) for a in _jax_commit(
        jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(k_all), jnp.asarray(v_all), jnp.asarray(pos),
        jnp.asarray(ql), jnp.asarray(bt), max_len=max_len))

    def plane(a, fill):           # + the scratch page past num_pages
        pad = np.full(a.shape[:2] + (1,) + a.shape[3:], fill, a.dtype)
        return torch.from_numpy(np.concatenate([a, pad], axis=2))

    tk, tv, tks, tvs = plane(kq, 0), plane(vq, 0), plane(ks, 1.0), \
        plane(vs, 1.0)
    out = pa.write_kv_pages_all_layers_quantized(
        tk, tv, tks, tvs, torch.from_numpy(k_all), torch.from_numpy(v_all),
        torch.from_numpy(pos), torch.from_numpy(ql), torch.from_numpy(bt),
        max_len)
    assert all(o is t for o, t in zip(out, (tk, tv, tks, tvs)))   # in place

    ties = 0
    for got, want, gs, ws, src, srcs, fresh in (
            (tk, jk, tks, jks, kq, ks, k_all), (tv, jv, tvs, jvs, vq, vs,
                                                v_all)):
        np.testing.assert_array_equal(gs.numpy()[:, :, :n_pages], ws)
        g = got.numpy()[:, :, :n_pages].astype(np.int32)
        diff = np.abs(g - want.astype(np.int32))
        assert diff.max() <= 1
        if diff.max():
            ratios = _pre_round(src, srcs, fresh.transpose(0, 2, 1, 3),
                                pos, ql, bt, page, max_len)
            for pid in np.unique(np.nonzero(diff)[2]):
                r = ratios[int(pid)]
                near = np.abs(np.abs(r - np.trunc(r)) - 0.5) < 1e-5
                assert (near | (diff[:, :, pid] == 0)).all()
                ties += int(diff[:, :, pid].sum())
    # the recycled page's stale rows were zeroed before the absmax
    if pos[1] % page == 0 and ql[1] > 0:
        assert float(tks[0, 0, bt[1, pos[1] // page]]) < 50.0
    assert ties <= 4, f"{ties} half-integer rounding differences"


def test_int8_cache_geometry_matches_jax():
    c = PagedKVCache(num_layers=2, num_pages=6, page_size=8, num_kv_heads=2,
                     head_dim=16, dtype="int8", device="cpu")
    k, v, ks, vs = c.arrays
    assert c.quantized and k.dtype == torch.int8
    assert k.shape == (2, 2, 7, 8, 16) and ks.shape == (2, 2, 7)   # + scratch
    assert torch.equal(ks, torch.ones_like(ks)) and not k.any()
    assert c.allocator.num_pages == 6
    for dt in ("int8", "float32", "bfloat16"):
        assert PagedKVCache.bytes_per_page(32, 8, 16, 128, dt) == \
            JPagedKVCache.bytes_per_page(32, 8, 16, 128, dt)


# --------------------------------------------------------------- engine ---

@pytest.fixture(scope="module")
def tiny_pair():
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.tiny(), device="cpu")
    load_reference_state(tm, arrays)
    return jm, tm


ENGINE = dict(max_batch=3, max_seq_len=64, page_size=8, prefill_bucket=8)
PROMPTS = [list(range(1, 20)), [5, 6, 7, 8, 9, 10, 11], [9, 9, 9, 1, 2]]


@functools.lru_cache(maxsize=None)
def _jax_tokens(jm, cache_dtype):
    je = JEngine(jm, gen=JGen(max_new_tokens=6, do_sample=False),
                 cache_dtype=cache_dtype, **ENGINE)
    rids = [je.add_request(p) for p in PROMPTS]
    out = je.run()
    return [out[r] for r in rids]


def test_engine_int8_greedy_matches_jax(tiny_pair):
    jm, tm = tiny_pair
    te = ContinuousBatchingEngine(tm, gen=GenerationConfig(max_new_tokens=6),
                                  cache_dtype="int8", device="cpu", **ENGINE)
    rids = [te.add_request(p) for p in PROMPTS]
    out = te.run()
    got = [out[r] for r in rids]
    assert got == _jax_tokens(jm, "int8")
    assert te.stats()["kv_cache_dtype"] == "int8"
    assert te.stats()["pages_in_use"] == 0
    # the int8 planes were written (scales moved off 1.0), never the
    # scratch page's neighbours beyond the pool
    assert (te.g.cache.k_scale[:, :, :-1] != 1.0).any()


def test_engine_float_pool_other_dtype_runs(tiny_pair):
    """An fp32 model over a bf16 pool through the engine (the plain path
    here; the CUDA path is held on the card)."""
    _, tm = tiny_pair
    te = ContinuousBatchingEngine(tm, gen=GenerationConfig(max_new_tokens=6),
                                  cache_dtype="bf16", device="cpu", **ENGINE)
    rids = [te.add_request(p) for p in PROMPTS]
    out = te.run()
    assert [len(out[r]) for r in rids] == [6, 6, 6]
    assert te.stats()["kv_cache_dtype"] == "bfloat16"
