"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an sm_90 GPU (H100/H200): every test here carries the ``cuda`` marker
and skips without one (the kernels have no CPU mode; their plain versions
are what the CPU tests run).  Imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: fp32 2e-5 (summation order only); bf16 ``out`` 2e-2 abs +
1e-2 rel (one bf16 rounding of the output); ``lse`` is fp32 from bf16
inputs, 1e-3.  Grouped matmul: fp32 1e-4 rel + 2e-5 of the output's largest
magnitude (summation order over C); bf16 1e-2 rel + 1e-2 of the largest
magnitude (one bf16 rounding of the output).  Flash attention, each output
held as ``chip_smoke.py`` holds it: relative Frobenius error 1e-5 (fp32:
a blockwise online softmax against one dense softmax) or 1e-2 (bf16:
probabilities and ds rounded to bf16 before their products), and every
element within rtol x |want| + atol x the larger of its row's RMS and the
tensor's (fp32 1e-4 and 1e-4, bf16 2e-2 and 5e-2); ``lse`` 1e-4.
Primitives: ``reduce_kernel`` bit for bit; ``elementwise_kernel`` within one
ulp of the output dtype + 1e-6 x (|want| + max |want|) (the functor in fp32
on both sides); ``matmul_kernel`` within 1e-4 x |want| + 1e-4 x max |want|
(fp32 out: sums in other orders) plus one ulp of a bf16/fp16 output.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import grouped_matmul as gm
from paddle_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(2)


@pytest.fixture
def h100():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100/H200); the kernel has no "
                    "CPU mode — its plain version is what the CPU tests run")
    return torch.device("cuda")


def _inputs(h100, dtype, *, B, T, qh, kvh, d, page, n_pages, width, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(h100).to(dtype)

    return dict(q=rnd(B, T, qh, d), k_cache=rnd(kvh, n_pages, page, d),
                v_cache=rnd(kvh, n_pages, page, d), k_new=rnd(B, T, kvh, d),
                v_new=rnd(B, T, kvh, d),
                block_tables=torch.from_numpy(rng.integers(
                    0, n_pages, (B, width)).astype(np.int32)).to(h100))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol,lse_atol", [
    (torch.float32, 2e-5, 2e-5, 2e-5),
    (torch.bfloat16, 1e-2, 2e-2, 1e-3),
])
@pytest.mark.parametrize("kvh,d,page", [(8, 128, 16), (2, 128, 16),
                                        (1, 64, 8)])
def test_ragged_kernel_vs_plain_on_card(h100, dtype, rtol, atol, lse_atol,
                                        kvh, d, page):
    """Mixed prefill + decode: ragged q_lens with an idle row, a fresh
    prefill (context 0), page-exact contexts, GQA groups 1, 4 and 8."""
    t = _inputs(h100, dtype, B=4, T=8, qh=8, kvh=kvh, d=d, page=page,
                n_pages=16, width=12, seed=kvh)
    ctx = torch.tensor([0, 16, 33, 96], dtype=torch.int32, device=h100)
    ql = torch.tensor([8, 1, 5, 0], dtype=torch.int32, device=h100)
    n0 = pa.LAUNCHES
    out, lse = pa.ragged_paged_attention(
        t["q"], t["k_cache"], t["v_cache"], t["block_tables"], ctx,
        q_lens=ql, k_new=t["k_new"], v_new=t["v_new"], with_lse=True)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == n0 + 1
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    ref, ref_lse = pa._reference_ragged_paged_attention(
        t["q"], t["k_cache"], t["v_cache"], t["block_tables"], ctx, ql,
        t["k_new"], t["v_new"])
    keep = torch.arange(8, device=h100)[None, :] < ql[:, None]
    torch.testing.assert_close(out[keep].float(), ref[keep].float(),
                               rtol=rtol, atol=atol)
    torch.testing.assert_close(lse[keep], ref_lse[keep], rtol=2e-5,
                               atol=lse_atol)


@pytest.mark.cuda
def test_decode_form_and_argument_checks_on_card(h100):
    t = _inputs(h100, torch.float32, B=3, T=1, qh=4, kvh=4, d=128, page=16,
                n_pages=8, width=4, seed=0)
    ctx = torch.tensor([1, 16, 64], dtype=torch.int32, device=h100)
    out = pa.paged_attention(t["q"][:, 0], t["k_cache"], t["v_cache"],
                             t["block_tables"], ctx)
    ref = pa._reference_paged_attention(t["q"][:, 0], t["k_cache"],
                                        t["v_cache"], t["block_tables"], ctx)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    with pytest.raises(TypeError, match="int32"):
        pa.ragged_paged_attention(t["q"], t["k_cache"], t["v_cache"],
                                  t["block_tables"], ctx.long())
    with pytest.raises(ValueError, match="head_dim"):
        q = torch.zeros((3, 1, 4, 32), device=h100)
        kc = torch.zeros((4, 8, 16, 32), device=h100)
        pa.ragged_paged_attention(q, kc, kc, t["block_tables"], ctx)


def _int8_pool(h100, rng, kvh, n_pages, page, d, zero_pages=()):
    """An int8 pool with per-(kv-head, page) absmax scales; the listed pages
    are all-zero with scale 1.0, as a fresh pool holds them."""
    x = rng.standard_normal((kvh, n_pages, page, d)).astype(np.float32)
    x[:, list(zero_pages)] = 0.0
    amax = np.abs(x).max(axis=(2, 3))
    sc = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    qv = np.clip(np.round(x / sc[..., None, None]), -127, 127).astype(np.int8)
    return (torch.from_numpy(qv).to(h100), torch.from_numpy(sc).to(h100))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kvh,page", [(8, 8), (2, 16), (1, 32)])
def test_int8_pool_kernel_vs_plain_on_card(h100, dtype, atol, kvh, page):
    """int8 pages x fp32 scale per (kv-head, page), with all-zero pages,
    against the plain version's dequantized math."""
    rng = np.random.default_rng(kvh * 100 + page)
    t = _inputs(h100, dtype, B=4, T=8, qh=8, kvh=kvh, d=128, page=page,
                n_pages=24, width=12, seed=kvh + page)
    kc, ks = _int8_pool(h100, rng, kvh, 24, page, 128, zero_pages=(0, 5))
    vc, vs = _int8_pool(h100, rng, kvh, 24, page, 128, zero_pages=(0, 7))
    ctx = torch.tensor([0, page, 2 * page + 1, 90], dtype=torch.int32,
                       device=h100)
    ql = torch.tensor([8, 1, 5, 0], dtype=torch.int32, device=h100)
    n0, i0 = pa.LAUNCHES, pa.LAUNCHES_INT8
    out, lse = pa.ragged_paged_attention(
        t["q"], kc, vc, t["block_tables"], ctx, q_lens=ql, k_new=t["k_new"],
        v_new=t["v_new"], k_scale=ks, v_scale=vs, with_lse=True)
    torch.cuda.synchronize()
    assert (pa.LAUNCHES, pa.LAUNCHES_INT8) == (n0, i0 + 1)
    ref, ref_lse = pa._reference_ragged_paged_attention(
        t["q"], kc, vc, t["block_tables"], ctx, ql, t["k_new"], t["v_new"],
        ks, vs)
    keep = torch.arange(8, device=h100)[None, :] < ql[:, None]
    torch.testing.assert_close(out[keep].float(), ref[keep].float(),
                               rtol=1e-2 if dtype == torch.bfloat16 else 2e-5,
                               atol=atol)
    torch.testing.assert_close(lse[keep], ref_lse[keep], rtol=2e-5,
                               atol=1e-3 if dtype == torch.bfloat16 else 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_pool_dtype_differs_from_model_dtype_on_card(h100, q_dtype,
                                                     pool_dtype):
    t = _inputs(h100, q_dtype, B=4, T=8, qh=8, kvh=2, d=128, page=16,
                n_pages=16, width=12, seed=3)
    kc, vc = t["k_cache"].to(pool_dtype), t["v_cache"].to(pool_dtype)
    ctx = torch.tensor([0, 16, 33, 96], dtype=torch.int32, device=h100)
    ql = torch.tensor([8, 1, 5, 0], dtype=torch.int32, device=h100)
    out = pa.ragged_paged_attention(t["q"], kc, vc, t["block_tables"], ctx,
                                    q_lens=ql, k_new=t["k_new"],
                                    v_new=t["v_new"])
    ref, _ = pa._reference_ragged_paged_attention(
        t["q"], kc, vc, t["block_tables"], ctx, ql, t["k_new"], t["v_new"])
    keep = torch.arange(8, device=h100)[None, :] < ql[:, None]
    bf = torch.bfloat16 in (q_dtype, pool_dtype)
    torch.testing.assert_close(out[keep].float(), ref[keep].float(),
                               rtol=1e-2 if bf else 2e-5,
                               atol=2e-2 if bf else 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pool", [
    (torch.float32, None), (torch.bfloat16, None), (torch.float32, "int8"),
    (torch.bfloat16, "int8")])
@pytest.mark.parametrize("group,T", [(1, 1), (4, 1), (1, 4), (4, 4), (8, 2),
                                     (2, 8)])
@pytest.mark.parametrize("page", [8, 16])
def test_split_route_vs_plain_on_card(h100, dtype, pool, group, T, page):
    """R = T x group <= 16 takes the split route: contexts 0, 1, page - 1,
    page, page + 1 and long ones spread over several splits, float and
    int8 pools; valid rows within tolerance, every row finite, two runs bit
    for bit."""
    kvh, B = 2, 6
    rng = np.random.default_rng(group * 10 + T + page)
    W = 320 // page + 2
    t = _inputs(h100, dtype, B=B, T=T, qh=kvh * group, kvh=kvh, d=128,
                page=page, n_pages=64, width=W, seed=group + T + page)
    kc, vc, ks, vs = t["k_cache"], t["v_cache"], None, None
    if pool == "int8":
        kc, ks = _int8_pool(h100, rng, kvh, 64, page, 128, zero_pages=(0,))
        vc, vs = _int8_pool(h100, rng, kvh, 64, page, 128, zero_pages=(3,))
    ctx = torch.tensor([0, 1, page - 1, page, page + 1, 317],
                       dtype=torch.int32, device=h100)
    ql = torch.tensor([T, 1, T, max(T - 1, 0), T, T], dtype=torch.int32,
                      device=h100)
    assert pa._route(T, group, dtype, kc.dtype, 128) == "split"
    assert pa.split_plan(B, kvh, W, page) > 1
    n0, s0 = pa.LAUNCHES + pa.LAUNCHES_INT8, \
        pa.LAUNCHES_SPLIT + pa.LAUNCHES_INT8_SPLIT
    kw = dict(q_lens=ql, k_new=t["k_new"], v_new=t["v_new"], k_scale=ks,
              v_scale=vs, with_lse=True)
    out, lse = pa.ragged_paged_attention(t["q"], kc, vc, t["block_tables"],
                                         ctx, **kw)
    out2, lse2 = pa.ragged_paged_attention(t["q"], kc, vc,
                                           t["block_tables"], ctx, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES + pa.LAUNCHES_INT8 == n0 + 2
    assert pa.LAUNCHES_SPLIT + pa.LAUNCHES_INT8_SPLIT == s0 + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    ref, ref_lse = pa._reference_ragged_paged_attention(
        t["q"], kc, vc, t["block_tables"], ctx, ql, t["k_new"], t["v_new"],
        ks, vs)
    keep = torch.arange(T, device=h100)[None, :] < ql[:, None]
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(out[keep].float(), ref[keep].float(),
                               rtol=1e-2 if bf else 2e-5,
                               atol=2e-2 if bf else 2e-5)
    torch.testing.assert_close(lse[keep], ref_lse[keep], rtol=2e-5,
                               atol=1e-3 if bf else 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("T,group", [(5, 4), (17, 1), (8, 8)])
def test_more_than_16_rows_take_the_tile_route_on_card(h100, T, group):
    t = _inputs(h100, torch.float32, B=2, T=T, qh=2 * group, kvh=2, d=64,
                page=16, n_pages=16, width=6, seed=T)
    ctx = torch.tensor([40, 3], dtype=torch.int32, device=h100)
    assert pa._route(T, group, torch.float32, torch.float32, 64) == "tile"
    n0, s0 = pa.LAUNCHES, pa.LAUNCHES_SPLIT
    out = pa.ragged_paged_attention(t["q"], t["k_cache"], t["v_cache"],
                                    t["block_tables"], ctx, k_new=t["k_new"],
                                    v_new=t["v_new"])
    torch.cuda.synchronize()
    assert (pa.LAUNCHES, pa.LAUNCHES_SPLIT) == (n0 + 1, s0)
    ref, _ = pa._reference_ragged_paged_attention(
        t["q"], t["k_cache"], t["v_cache"], t["block_tables"], ctx, None,
        t["k_new"], t["v_new"])
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)



@pytest.mark.cuda
@pytest.mark.parametrize("pool", [None, "int8"])
@pytest.mark.parametrize("group,T,d", [(1, 64, 128), (4, 20, 128),
                                       (8, 12, 64), (1, 128, 128),
                                       (2, 40, 64)])
@pytest.mark.parametrize("page", [8, 16, 40, 96, 128])
def test_sm90_prefill_route_vs_plain_on_card(h100, pool, group, T, d, page):
    """R = T x group > 16 with bf16 q over a bf16 or int8 pool takes the
    sm90 route: contexts 0, 1, page - 1, page, page + 1 and a long one,
    q_lens T, 1, 0 and ragged; pages that divide 64, that 64 divides, and
    neither (40, 96: key tiles of 8- and 32-row boxes); valid rows within
    the bf16 tolerance, every row finite, two runs bit for bit."""
    kvh, B, long_ctx = 2, 6, 300
    rng = np.random.default_rng(group * 1000 + T + page)
    W = -(-long_ctx // page) + 2
    n_pages = 2 * W
    t = _inputs(h100, torch.bfloat16, B=B, T=T, qh=kvh * group, kvh=kvh,
                d=d, page=page, n_pages=n_pages, width=W, seed=T + page)
    kc, vc, ks, vs = t["k_cache"], t["v_cache"], None, None
    if pool == "int8":
        kc, ks = _int8_pool(h100, rng, kvh, n_pages, page, d,
                            zero_pages=(0,))
        vc, vs = _int8_pool(h100, rng, kvh, n_pages, page, d,
                            zero_pages=(1,))
    ctx = torch.tensor([0, 1, page - 1, page, page + 1, long_ctx],
                       dtype=torch.int32, device=h100)
    ql = torch.tensor([T, 1, 0, T - 5, T, T], dtype=torch.int32, device=h100)
    assert pa._route(T, group, torch.bfloat16, kc.dtype, d) == "sm90"
    n0 = pa.LAUNCHES + pa.LAUNCHES_INT8
    s0 = pa.LAUNCHES_SM90 + pa.LAUNCHES_INT8_SM90
    kw = dict(q_lens=ql, k_new=t["k_new"], v_new=t["v_new"], k_scale=ks,
              v_scale=vs, with_lse=True)
    out, lse = pa.ragged_paged_attention(t["q"], kc, vc, t["block_tables"],
                                         ctx, **kw)
    out2, lse2 = pa.ragged_paged_attention(t["q"], kc, vc,
                                           t["block_tables"], ctx, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES + pa.LAUNCHES_INT8 == n0 + 2
    assert pa.LAUNCHES_SM90 + pa.LAUNCHES_INT8_SM90 == s0 + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    ref, ref_lse = pa._reference_ragged_paged_attention(
        t["q"], kc, vc, t["block_tables"], ctx, ql, t["k_new"], t["v_new"],
        ks, vs)
    keep = torch.arange(T, device=h100)[None, :] < ql[:, None]
    torch.testing.assert_close(out[keep].float(), ref[keep].float(),
                               rtol=1e-2, atol=2e-2)
    torch.testing.assert_close(lse[keep], ref_lse[keep], rtol=2e-5,
                               atol=1e-3)

def _gmm_case(h100, dtype, *, E, counts, bm, C, O, seed, fused):
    """A dispatch over the given per-expert entry counts (zero allowed);
    with ``fused`` the rows gather from an un-permuted buffer whose last
    row is the zero sentinel."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(E), counts)
    rng.shuffle(ids)
    inv, _pos, tg = gm.sorted_dispatch_plan(
        torch.from_numpy(ids).to(h100), E, bm)
    F = len(ids)
    rhs = torch.from_numpy(rng.standard_normal((E, C, O)).astype(
        np.float32) / np.sqrt(C)).to(h100).to(dtype)
    if fused:
        n = F + 1
        lhs = torch.from_numpy(rng.standard_normal((n, C)).astype(
            np.float32)).to(h100).to(dtype)
        lhs[-1] = 0
        rows = torch.where(inv < F, inv, torch.full_like(inv, n - 1))
        return lhs, rhs, tg, rows
    lhs = torch.from_numpy(rng.standard_normal((inv.shape[0], C)).astype(
        np.float32)).to(h100).to(dtype)
    return lhs, rhs, tg, None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,counts,fused", [
    (8, [3, 0, 9, 1], True),            # an empty expert, sentinel rows
    (16, [16, 0, 0, 0], False),         # one expert holds everything
    (24, [5, 30, 0, 2], True),          # bm not a power of two: tile 8
    (128, [100, 7, 0, 200], True),
    (512, [600, 1, 3, 0], False),
])
def test_gmm_kernel_vs_plain_on_card(h100, dtype, bm, counts, fused):
    lhs, rhs, tg, rows = _gmm_case(h100, dtype, E=4, counts=counts, bm=bm,
                                   C=96, O=128, seed=bm, fused=fused)
    n0 = gm.LAUNCHES
    out = gm.gmm(lhs, rhs, tg, bm=bm, rows=rows)
    torch.cuda.synchronize()
    assert gm.LAUNCHES == n0 + 1
    ref = gm._gmm_reference(lhs, rhs, tg, bm=bm, rows=rows)
    scale = float(ref.float().abs().max())
    bf = dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=1e-2 if bf else 1e-4,
                               atol=(1e-2 if bf else 2e-5) * scale)
    if rows is not None:                # sentinel rows come out exactly 0
        pad = rows == lhs.shape[0] - 1
        assert torch.equal(out[pad], torch.zeros_like(out[pad]))



def _close(out, ref, bf):
    """Grouped-matmul tolerance: fp32 1e-4 rel + 2e-5 of the largest
    magnitude (summation order), bf16 1e-2 and 1e-2 (one output rounding)."""
    scale = float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=1e-2 if bf else 1e-4,
                               atol=(1e-2 if bf else 2e-5) * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,counts,fused,scaled", [
    (8, [3, 0, 9, 1], True, True),      # an empty expert, sentinel rows
    (16, [16, 0, 0, 0], False, True),   # one expert holds everything
    (24, [5, 30, 0, 2], True, False),   # bm not a power of two: tile 8
    (128, [100, 7, 0, 200], True, True),
    (512, [600, 1, 3, 0], False, False),
])
def test_gmm_trans_rhs_row_scale_kernel_vs_plain_on_card(
        h100, dtype, bm, counts, fused, scaled):
    lhs, rhs, tg, rows = _gmm_case(h100, dtype, E=4, counts=counts, bm=bm,
                                   C=96, O=128, seed=bm + 1, fused=fused)
    rhs_t = rhs.transpose(1, 2).contiguous()            # [E, O, C]
    M = tg.shape[0] * bm
    gen = torch.Generator(device=h100).manual_seed(bm)
    s = torch.rand((M,), generator=gen, device=h100) if scaled else None
    n0, t0 = gm.LAUNCHES, gm.LAUNCHES_TRANS
    out = gm.gmm(lhs, rhs_t, tg, bm=bm, rows=rows, trans_rhs=True,
                 row_scale=s)
    torch.cuda.synchronize()
    assert (gm.LAUNCHES, gm.LAUNCHES_TRANS) == (n0, t0 + 1)
    ref = gm._gmm_reference(lhs, rhs_t, tg, bm=bm, rows=rows, trans_rhs=True,
                            row_scale=s)
    _close(out, ref, dtype == torch.bfloat16)
    if scaled:                          # the forward form takes the scale too
        _close(gm.gmm(lhs, rhs, tg, bm=bm, rows=rows, row_scale=s),
               gm._gmm_reference(lhs, rhs, tg, bm=bm, rows=rows,
                                 row_scale=s), dtype == torch.bfloat16)
    if rows is not None:                # sentinel rows come out exactly 0
        pad = rows == lhs.shape[0] - 1
        assert torch.equal(out[pad], torch.zeros_like(out[pad]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(64, 192), (128, 256)])   # bf16 tiles 64, 128
@pytest.mark.parametrize("bm,counts,lfused,rfused,scaled,cut", [
    (8, [3, 0, 9, 1], True, False, False, False),   # empty expert, sentinels
    (16, [40, 0, 0, 0], False, True, True, False),  # one expert: every row
    (128, [100, 7, 0, 200], True, True, True, False),
    (512, [600, 1, 3, 0], False, False, False, True),   # expert 3 owns no tile
])
def test_tgmm_kernel_vs_plain_on_card(h100, dtype, K, N, bm, counts, lfused,
                                      rfused, scaled, cut):
    rng = np.random.default_rng(bm + K)
    ids = np.repeat(np.arange(4), counts)
    rng.shuffle(ids)
    inv, _pos, tg = gm.sorted_dispatch_plan(torch.from_numpy(ids).to(h100),
                                            4, bm)
    if cut:                             # a truncated plan, as the reference's
        keep = int((tg != 3).sum())
        inv, tg = inv[:keep * bm], tg[:keep]
    F, M = len(ids), inv.shape[0]
    rows = torch.where(inv < F, inv, torch.full_like(inv, F))

    def operand(width, fused):
        x = torch.from_numpy(rng.standard_normal(
            (F + 1 if fused else M, width)).astype(np.float32)).to(h100)
        if fused:
            x[-1] = 0
        return x.to(dtype), rows if fused else None

    lhs, lr = operand(K, lfused)
    rhs, rr = operand(N, rfused)
    s = torch.from_numpy(rng.random(M).astype(np.float32)).to(h100) \
        if scaled else None
    n0, s0 = gm.LAUNCHES_TGMM, gm.LAUNCHES_TGMM_SM90
    out = gm.tgmm(lhs, rhs, tg, 4, bm=bm, lhs_rows=lr, rhs_rows=rr,
                  rhs_scale=s)
    torch.cuda.synchronize()
    assert gm.LAUNCHES_TGMM == n0 + 1
    assert gm.LAUNCHES_TGMM_SM90 == s0 + (dtype == torch.bfloat16)   # route
    ref = gm._tgmm_reference(lhs, rhs, tg, 4, bm=bm, lhs_rows=lr,
                             rhs_rows=rr, rhs_scale=s)
    assert out.shape == (4, K, N) and out.dtype == dtype
    _close(out, ref, dtype == torch.bfloat16)
    if cut:
        assert torch.equal(out[3], torch.zeros_like(out[3]))
    # blocks the plain version gives as exact zeros are exact zeros
    zero = (ref.flatten(1) == 0).all(1)
    assert torch.equal(out[zero], torch.zeros_like(out[zero]))
    again = gm.tgmm(lhs, rhs, tg, 4, bm=bm, lhs_rows=lr, rhs_rows=rr,
                    rhs_scale=s)
    assert torch.equal(out, again)         # no atomics: the same bits


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("bm,counts,fused,scaled,C,O", [
    (8, [3, 0, 9, 1], True, True, 96, 128),      # narrow tm 8, sentinels
    (16, [16, 0, 0, 0], False, False, 96, 128),  # narrow tm 16, one expert
    (24, [5, 30, 0, 2], True, False, 160, 192),  # narrow tm 8, K tail 32
    (64, [70, 0, 5, 64], True, True, 128, 64),   # narrow tm 64
    (128, [100, 7, 0, 200], True, True, 96, 128),   # wide bn 128, K tail
    (128, [0, 300, 2, 0], False, True, 256, 192),   # wide, N tail 64
    (512, [600, 1, 3, 0], False, False, 96, 512),   # wide bn 256
    (512, [900, 0, 17, 130], True, False, 160, 256),
])
def test_gmm_sm90_route_vs_plain_on_card(h100, trans, bm, counts, fused,
                                         scaled, C, O):
    """Every bf16 gmm takes the sm90 route (wide for bm % 128 == 0, else
    narrow): each form against the plain version, sentinel rows exactly 0,
    two runs bit for bit; the same call in fp32 takes the simt route."""
    lhs, rhs, tg, rows = _gmm_case(h100, torch.bfloat16, E=4, counts=counts,
                                   bm=bm, C=C, O=O, seed=bm + C, fused=fused)
    if trans:
        rhs = rhs.transpose(1, 2).contiguous()          # [E, O, C]
    M = tg.shape[0] * bm
    gen = torch.Generator(device=h100).manual_seed(bm)
    s = torch.rand((M,), generator=gen, device=h100) if scaled else None
    form = gm.sm90_plan(bm, M, O)["form"]
    assert form == ("wide" if bm % 128 == 0 else "narrow")
    c0 = (gm.LAUNCHES, gm.LAUNCHES_TRANS, gm.LAUNCHES_SM90,
          gm.LAUNCHES_TRANS_SM90)
    out = gm.gmm(lhs, rhs, tg, bm=bm, rows=rows, trans_rhs=trans,
                 row_scale=s)
    again = gm.gmm(lhs, rhs, tg, bm=bm, rows=rows, trans_rhs=trans,
                   row_scale=s)
    torch.cuda.synchronize()
    step = (0, 2, 0, 2) if trans else (2, 0, 2, 0)
    assert (gm.LAUNCHES, gm.LAUNCHES_TRANS, gm.LAUNCHES_SM90,
            gm.LAUNCHES_TRANS_SM90) == tuple(a + b for a, b in zip(c0, step))
    assert torch.equal(out, again)
    ref = gm._gmm_reference(lhs, rhs, tg, bm=bm, rows=rows, trans_rhs=trans,
                            row_scale=s)
    _close(out, ref, True)
    if rows is not None:                # sentinel rows come out exactly 0
        pad = rows == lhs.shape[0] - 1
        assert pad.any()
        assert torch.equal(out[pad], torch.zeros_like(out[pad]))
    # fp32 stays on the simt route
    c1 = (gm.LAUNCHES_SM90, gm.LAUNCHES_TRANS_SM90)
    out32 = gm.gmm(lhs.float(), rhs.float(), tg, bm=bm, rows=rows,
                   trans_rhs=trans, row_scale=s)
    torch.cuda.synchronize()
    assert (gm.LAUNCHES_SM90, gm.LAUNCHES_TRANS_SM90) == c1
    _close(out32, gm._gmm_reference(lhs.float(), rhs.float(), tg, bm=bm,
                                    rows=rows, trans_rhs=trans, row_scale=s),
           False)


def _flash_inputs(h100, dtype, *, b, sq, sk, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(h100).to(dtype)

    return rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d), \
        rnd(b, sq, hq, d)


FLASH_TOL = {torch.float32: dict(rel=1e-5, rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rel=1e-2, rtol=2e-2, atol=5e-2)}


def _assert_flash_close(got, want, rel, rtol, atol):
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    err = (g - w).abs()
    assert float(err.norm()) <= rel * float(w.norm())
    scale = w.square().mean(-1, keepdim=True).sqrt().clamp_min(
        float(w.square().mean().sqrt()))
    need = float(((err - rtol * w.abs()) / scale).max())
    assert need <= atol, need


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 128, 128, 4, 4, 64, False),
    (2, 256, 256, 8, 2, 128, True),      # GQA group 4
    (1, 100, 300, 8, 1, 128, True),      # sq < sk, ragged tiles, group 8
    (3, 77, 77, 2, 2, 64, False),        # lengths off the 64-row tile
    (3, 192, 640, 8, 2, 128, True),      # sm90 route (bf16): sk > sq, ragged
    (2, 100, 300, 8, 1, 64, True),       # sm90 route (bf16): partial tiles
    (1, 300, 300, 4, 4, 128, False),     # full attention, three q tiles
])
def test_flash_kernels_vs_plain_on_card(h100, dtype, b, sq, sk, hq, hkv, d,
                                        causal):
    """Forward (out, lse), dQ and dK/dV against the plain versions on the
    same inputs (tolerances in the module docstring); all three take the
    route ``_route`` names (bf16 at d 64/128: the sm90 kernels)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v, g = _flash_inputs(h100, dtype, b=b, sq=sq, sk=sk, hq=hq,
                               hkv=hkv, d=d, seed=sq + hkv)
    n0 = (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
    s0 = (fa.LAUNCHES_FWD_SM90, fa.LAUNCHES_BWD_DQ_SM90,
          fa.LAUNCHES_BWD_DKV_SM90)
    out, lse = fa.flash_forward(q, k, v, causal)
    dq, dk, dv = fa.flash_backward(q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == \
        (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    sm90 = int(fa._route(dtype, d) == "sm90")
    assert (fa.LAUNCHES_FWD_SM90, fa.LAUNCHES_BWD_DQ_SM90,
            fa.LAUNCHES_BWD_DKV_SM90) == tuple(n + sm90 for n in s0)
    ref, ref_lse = fa._reference_attention_lse(q, k, v, causal)
    tol = FLASH_TOL[dtype]
    _assert_flash_close(out, ref, **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    delta = fa._delta(out, g)
    want = (fa._flash_bwd_dq(q, k, v, g, lse, delta, causal),
            *fa._flash_bwd_dkv(q, k, v, g, lse, delta, causal))
    for got, ref_grad in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref_grad.shape
        _assert_flash_close(got, ref_grad, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,modes", [
    (128, True, ""), (64, False, ""), (128, True, "mask"),
    (128, False, "dropout"), (64, True, "segments")])
def test_flash_bwd_sm90_repeats_bit_for_bit_on_card(h100, d, causal, modes):
    """The sm90 dQ and dK/dV write each output element once after a sum in
    a fixed order: a second launch on the same inputs gives the same bits,
    in the plain build and in the modes build."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, s, hq, hkv = 2, 200, 4, 2
    q, k, v, g = _flash_inputs(h100, torch.bfloat16, b=b, sq=s, sk=s, hq=hq,
                               hkv=hkv, d=d, seed=d + s)
    kw = {}
    if modes == "mask":
        kw["mask"] = torch.randn((b, 1, s, s), device=h100)
    elif modes == "dropout":
        kw.update(drop_p=0.2, seed=torch.tensor([7], dtype=torch.int32,
                                                device=h100))
    elif modes == "segments":
        seg = torch.tensor([[0] * 80 + [1] * 120, [0] * 200],
                           dtype=torch.int32, device=h100)
        kw.update(seg_q=seg, seg_k=seg)
    out, lse = fa._reference_attention_lse(q, k, v, causal, **kw)
    delta = fa._delta(out, g)
    s0 = (fa.LAUNCHES_BWD_DQ_SM90, fa.LAUNCHES_BWD_DKV_SM90)
    first = (fa._cuda_bwd_dq(q, k, v, g, lse, delta, causal, **kw),
             *fa._cuda_bwd_dkv(q, k, v, g, lse, delta, causal, **kw))
    second = (fa._cuda_bwd_dq(q, k, v, g, lse, delta, causal, **kw),
              *fa._cuda_bwd_dkv(q, k, v, g, lse, delta, causal, **kw))
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_BWD_DQ_SM90, fa.LAUNCHES_BWD_DKV_SM90) == \
        (s0[0] + 2, s0[1] + 2)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    want = (fa._flash_bwd_dq(q, k, v, g, lse, delta, causal, **kw),
            *fa._flash_bwd_dkv(q, k, v, g, lse, delta, causal, **kw))
    for got, ref in zip(first, want):
        _assert_flash_close(got, ref, **FLASH_TOL[torch.bfloat16])


def _fwd_modes(h100, mode, b, sq, sk, hq):
    """The forward's mode operands for ``mode`` at these dims."""
    gen = torch.Generator(device=h100).manual_seed(sq * 7 + sk)
    if mode == "mask":
        # a tenth of the keys at -1e30, key 0 never: every causal row keeps
        # a live key (a row with none averages only the keys the kernels
        # visit, not every key as the plain version does)
        x = torch.randn((b, hq, sq, sk), generator=gen, device=h100) * 0.5
        drop = torch.rand(x.shape, generator=gen, device=h100) < 0.1
        drop[..., 0] = False
        return {"mask": x.masked_fill(drop, -1e30)}
    if mode == "mask_h1":
        return {"mask": torch.randn((1, 1, sq, sk), generator=gen,
                                    device=h100)}
    if mode == "segments":
        seg_q = torch.randint(0, 3, (b, sq), generator=gen,
                              device=h100).sort(dim=1).values
        seg_k = torch.randint(0, 3, (b, sk), generator=gen,
                              device=h100).sort(dim=1).values
        return {"seg_q": seg_q.to(torch.int32), "seg_k": seg_k.to(torch.int32)}
    if mode == "dropout":
        return {"drop_p": 0.2,
                "seed": torch.tensor([11], dtype=torch.int32, device=h100)}
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["", "mask", "mask_h1", "segments",
                                  "dropout"])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d,causal", [
    (2, 128, 128, 4, 4, 64, False),
    (2, 256, 256, 8, 2, 128, True),      # GQA group 4
    (1, 100, 300, 8, 1, 128, True),      # sq < sk, ragged tiles, group 8
    (3, 77, 77, 2, 2, 64, False),        # lengths off the 64-row tile
    (2, 200, 136, 4, 1, 128, False),     # sq > sk (full), group 4
    (1, 300, 300, 4, 4, 64, True),       # three q tiles, a half-empty last
])
def test_flash_fwd_sm90_vs_plain_on_card(h100, mode, b, sq, sk, hq, hkv, d,
                                         causal):
    """The sm90 forward (bf16, d 64/128) against ``_reference_attention_lse``
    on the same inputs over shapes, GQA groups, causal/full and each mode;
    one launch, on the sm90 route."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    if causal and mode == "segments":
        sk = sq                          # causal segments: equal packings
    q, k, v, _ = _flash_inputs(h100, torch.bfloat16, b=b, sq=sq, sk=sk,
                               hq=hq, hkv=hkv, d=d, seed=sq + sk + d)
    modes = _fwd_modes(h100, mode, b, sq, sk, hq)
    if causal and mode == "segments":
        modes["seg_k"] = modes["seg_q"]
    n0 = (fa.LAUNCHES_FWD, fa.LAUNCHES_FWD_SM90)
    out, lse = fa.flash_forward(q, k, v, causal, **modes)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_FWD, fa.LAUNCHES_FWD_SM90) == (n0[0] + 1, n0[1] + 1)
    ref, ref_lse = fa._reference_attention_lse(q, k, v, causal, **modes)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _assert_flash_close(out, ref, **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,mode", [
    (128, True, ""), (64, False, ""), (128, True, "mask"),
    (128, False, "dropout"), (64, True, "segments")])
def test_flash_fwd_sm90_repeats_bit_for_bit_on_card(h100, d, causal, mode):
    """The sm90 forward writes each output once after a sum in a fixed
    order: a second launch gives the same bits, in both builds."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, s, hq, hkv = 2, 200, 4, 2
    q, k, v, _ = _flash_inputs(h100, torch.bfloat16, b=b, sq=s, sk=s, hq=hq,
                               hkv=hkv, d=d, seed=d + s + 1)
    modes = _fwd_modes(h100, mode, b, s, s, hq)
    if mode == "segments":
        modes["seg_k"] = modes["seg_q"]
    n0 = fa.LAUNCHES_FWD_SM90
    first = fa._cuda_fwd(q, k, v, causal, **modes)
    second = fa._cuda_fwd(q, k, v, causal, **modes)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_FWD_SM90 == n0 + 2
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_sm90_fully_masked_causal_row_on_card(h100, d):
    """A causal row whose every key the mask sets to -1e30 averages the keys
    it visits (the 64-key tiles its 64-row group needs): the sm90 forward
    (bf16) gives the mma route's average (fp32, the same values) and its
    lse, which the backward's p = exp(s - lse) expects."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, s, h = 1, 200, 2
    q, k, v, _ = _flash_inputs(h100, torch.bfloat16, b=b, sq=s, sk=s, hq=h,
                               hkv=h, d=d, seed=d)
    mask = torch.zeros((b, 1, s, s), device=h100)
    rows = [0, 70, 130, 199]             # in each 64-row group
    mask[:, :, rows] = -1e30
    n0 = fa.LAUNCHES_FWD_SM90
    out, lse = fa.flash_forward(q, k, v, True, mask=mask)
    assert fa.LAUNCHES_FWD_SM90 == n0 + 1
    want, want_lse = fa.flash_forward(q.float(), k.float(), v.float(), True,
                                      mask=mask)
    assert fa.LAUNCHES_FWD_SM90 == n0 + 1         # fp32: the mma route
    torch.cuda.synchronize()
    for r in rows:                      # the average over keys 0 .. 64 n - 1
        n = min(s, 64 * (r // 64 + 1))
        avg = v[:, :n].float().mean(dim=1)          # [b, h, d]
        torch.testing.assert_close(want[:, r], avg, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(out[:, r].float(), avg, rtol=1e-2,
                                   atol=2e-2)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    _assert_flash_close(out, want, **FLASH_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_attention_cuda_only_modes_raise_on_card(h100):
    """What the kernels do not take raises on CUDA tensors (d 72, a causal
    call with sq > sk, a mask of the wrong shape, float segment ids,
    dropout without a seed) and nothing falls back to the plain version;
    the mask and dropout modes launch the kernels through the autograd
    Function, and the mask gets no gradient."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v, _ = _flash_inputs(h100, torch.bfloat16, b=1, sq=64, sk=64,
                               hq=2, hkv=2, d=64, seed=0)
    n0 = fa.LAUNCHES_FWD
    q72 = torch.zeros((1, 64, 2, 72), device=h100, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q72, q72, q72, causal=True)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k[:, :32], v[:, :32], causal=True)
    with pytest.raises(ValueError, match="attn_mask"):
        fa.flash_attention(q, k, v, attn_mask=torch.zeros((1, 1, 64, 32),
                                                          device=h100))
    seg = torch.zeros((1, 64), device=h100)
    with pytest.raises(TypeError, match="seg_q"):
        fa.flash_forward(q, k, v, False, seg_q=seg, seg_k=seg)
    with pytest.raises(ValueError, match="seed"):
        fa.flash_forward(q, k, v, False, drop_p=0.1)
    assert fa.LAUNCHES_FWD == n0
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    mask = torch.zeros((1, 1, 64, 64), device=h100, requires_grad=True)
    out = fa.flash_attention(*leaves, causal=True, attn_mask=mask,
                             dropout=0.1)
    out.float().sum().backward()
    assert fa.LAUNCHES_FWD == n0 + 1
    assert mask.grad is None or not bool(mask.grad.any())
    assert all(x.grad is not None and torch.isfinite(x.grad.float()).all()
               for x in leaves)


def _flash_mode_inputs(h100, mode, dtype, hkv, d):
    """(q, k, v, g, causal, modes): b 2, sq 136 / sk 200 (segments 200 /
    200), 4 q-heads, with the mode's mask, segment ids or dropout."""
    gen = torch.Generator(device=h100).manual_seed(d + hkv)
    b, hq, sq, sk = 2, 4, 136, 200
    causal, modes = mode.endswith("causal"), {}
    if mode.startswith("seg"):
        sq = 200
        qlens = [(50, 70, 80), (136, 64)] if causal else [(60, 40, 100),
                                                           (100, 100)]
        klens = qlens if causal else [(90, 0, 110), (150, 50)]
        modes = {name: torch.stack([
            torch.repeat_interleave(torch.arange(3, device=h100)[:len(ln)],
                                    torch.tensor(ln, device=h100))
            for ln in lens]).to(torch.int32)
            for name, lens in (("seg_q", qlens), ("seg_k", klens))}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=h100).to(dtype)

    q, k, v, g = (rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d),
                  rnd(b, sq, hq, d))
    if mode.startswith("mask"):
        mh = hq if mode == "mask_hq" else 1
        x = torch.randn((b, mh, sq, sk), generator=gen, device=h100) * 0.5
        modes["mask"] = x.masked_fill(
            torch.rand(x.shape, generator=gen, device=h100) < 0.1, -1e30)
    if "drop" in mode:
        modes["drop_p"] = 0.5 if mode == "drop_full" else 0.1
        modes["seed"] = torch.tensor([7], dtype=torch.int32, device=h100)
    return q, k, v, g, causal, modes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["mask_h1", "mask_hq", "mask_causal",
                                  "seg_causal", "seg_full_empty",
                                  "drop_full", "drop_causal",
                                  "mask_drop_causal"])
@pytest.mark.parametrize("hkv,d", [(4, 64), (1, 96), (4, 128), (1, 256)])
def test_flash_modes_vs_plain_on_card(h100, dtype, mode, hkv, d):
    """Every mode's forward (out, lse), dQ and dK/dV against the plain
    versions on the same inputs, as chip_smoke.py's kernel_flash_modes
    holds them (tolerances in the module docstring)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    q, k, v, g, causal, modes = _flash_mode_inputs(h100, mode, dtype, hkv, d)
    n0 = (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
    ref, ref_lse = fa._reference_attention_lse(q, k, v, causal, **modes)
    out, lse = fa.flash_forward(q, k, v, causal, **modes)
    dq, dk, dv = fa.flash_backward(q, k, v, ref, ref_lse, g, causal, **modes)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == \
        (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    tol = FLASH_TOL[dtype]
    _assert_flash_close(out, ref, **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    delta = fa._delta(ref, g)
    want = (fa._flash_bwd_dq(q, k, v, g, ref_lse, delta, causal, **modes),
            *fa._flash_bwd_dkv(q, k, v, g, ref_lse, delta, causal, **modes))
    for got, ref_grad in zip((dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref_grad.shape
        _assert_flash_close(got, ref_grad, **tol)


@pytest.mark.cuda
def test_flash_forward_keep_mask_is_the_plain_one_on_card(h100):
    """q = 0 and v = I (sk = d, fp32): the forward's output is keep * inv /
    sk exactly, so the kernel's keep-mask reads off it; it equals
    _drop_keep_dense bit for bit."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, s, h, d = 2, 300, 2, 256
    q = torch.zeros((b, s, h, d), device=h100)
    k = torch.randn((b, d, h, d), device=h100)
    v = torch.eye(d, device=h100)[None, :, None, :].expand(b, d, h, d)
    seed = torch.tensor([(1 << 23) - 1], dtype=torch.int32, device=h100)
    out, _ = fa.flash_forward(q, k, v.contiguous(), False, drop_p=0.3,
                              seed=seed)
    want = fa._drop_keep_dense((b, h, s, d), seed, 0.3)
    assert torch.equal((out != 0).transpose(1, 2), want)


def _wo_close(out, ref):
    """Weight-only kernel vs plain: fp32 by the relative RMS error (1e-5;
    summation order over k) with every element within 1e-4 of the
    output's RMS; bf16/fp16 every element within one ulp of the largest
    output (both sum in fp32 and round once)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    o, r = out.float(), ref.float()
    assert bool(torch.isfinite(o).all())
    err = (o - r).abs()
    if out.dtype == torch.float32:
        rms = float(r.square().mean().sqrt())
        assert float(err.square().mean().sqrt()) <= 1e-5 * rms
        assert float(err.max()) <= 1e-4 * rms
    else:
        big = float(r.abs().max())
        ulp = torch.finfo(out.dtype).eps * 2.0 ** np.floor(np.log2(big)) \
            if big else 0.0
        assert float(err.max()) <= ulp


def _wo_weights(h100, k, n, int4, seed):
    from paddle_tpu_torch.quantization import weight_quantize
    gen = torch.Generator(device=h100).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=h100)
    return weight_quantize(w, "weight_only_int4" if int4 else
                           "weight_only_int8")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m,k,n", [
    (1, 64, 64), (7, 96, 200),           # n off the 16-byte vector
    (8, 4095, 256),                      # odd k: the int4 pad nibble
    (16, 256, 512), (100, 512, 320),     # 16- and 64-row tiles, ragged m
])
def test_weight_only_kernel_vs_plain_on_card(h100, dtype, int4, m, k, n):
    from paddle_tpu_torch.kernels import weight_only as wo
    q, s = _wo_weights(h100, k, n, int4, seed=m + k)
    x = torch.randn((m, k), device=h100).to(dtype)
    rows = k if int4 else None
    n0 = (wo.LAUNCHES, wo.LAUNCHES_INT4)
    out = wo.weight_only_matmul(x, q, s, int4_rows=rows)
    torch.cuda.synchronize()
    assert (wo.LAUNCHES, wo.LAUNCHES_INT4) == \
        (n0[0] + (not int4), n0[1] + int4)
    _wo_close(out, wo._wo_reference(x, q, s, int4, k, dtype))


@pytest.mark.cuda
def test_weight_only_edges_on_card(h100):
    """Extreme codes, a zero weight column (exactly 0), leading dims, an
    out_dtype apart from x's, the empty batch (no launch), a bias through
    weight_only_linear, a non-contiguous x (raises, no fallback) and dx
    against the same call on the CPU."""
    from paddle_tpu_torch.kernels import weight_only as wo
    from paddle_tpu_torch.quantization import weight_only_linear
    k, n = 256, 128
    x = torch.randn((2, 3, 5, k), device=h100, dtype=torch.bfloat16)
    for int4, code in ((False, 127), (False, -127), (True, 7), (True, -8)):
        full = torch.full((k, n), code, dtype=torch.int8, device=h100)
        full[:, 3] = 0
        if int4:
            from paddle_tpu_torch.quantization import _pack_int4
            full = _pack_int4(full)
        s = torch.full((n,), 1.0 / 127, device=h100)
        rows = k if int4 else None
        out = wo.weight_only_matmul(x, full, s, int4_rows=rows)
        assert out.shape == (2, 3, 5, n)
        ref = wo._wo_reference(x.reshape(-1, k), full, s, int4, k,
                               torch.bfloat16)
        _wo_close(out.reshape(-1, n), ref)
        assert not out[..., 3].any()
        out32 = wo.weight_only_matmul(x, full, s, int4_rows=rows,
                                      out_dtype=torch.float32)
        _wo_close(out32.reshape(-1, n), wo._wo_reference(
            x.reshape(-1, k), full, s, int4, k, torch.float32))
    q, s = _wo_weights(h100, k, n, False, seed=1)
    n0 = wo.LAUNCHES
    assert wo.weight_only_matmul(x[:, :0], q, s).shape == (2, 0, 5, n)
    assert wo.LAUNCHES == n0
    with pytest.raises(ValueError, match="contiguous"):
        wo.weight_only_matmul(x.transpose(1, 2), q, s)
    bias = torch.randn(n, device=h100)
    y = weight_only_linear(x, q, bias=bias, weight_scale=s)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, wo.weight_only_matmul(x, q, s) + bias,
                               rtol=0, atol=0)
    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.randn((8, k), device=h100).to(dtype)
        g = torch.randn((8, n), device=h100).to(dtype)
        grads = []
        for dev in (h100, torch.device("cpu")):
            xl = xs.detach().to(dev).requires_grad_(True)
            weight_only_linear(xl, q.to(dev), weight_scale=s.to(dev)
                               ).backward(g.to(dev))
            grads.append(xl.grad)
        _wo_close(grads[0].cpu(), grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m,k,n,route", [
    (8, 4096, 11008, "narrow"),          # llama2_7b gate/up at decode
    (1, 2048, 128, "narrow"),            # split-K
    (20, 200, 176, "narrow"),            # k and n off the tiles, 32-row tile
    (64, 256, 512, "narrow"),            # the largest narrow row tile
    (100, 200, 176, "wide"), (512, 4096, 4096, "wide"),
    (8, 96, 200, "legacy"),              # n off the 16-byte rows
])
def test_weight_only_routes_on_card(h100, dtype, int4, m, k, n, route):
    """Each route by its counter, against the plain version, and the same
    bits in two runs."""
    from paddle_tpu_torch.kernels import weight_only as wo
    q, s = _wo_weights(h100, k, n, int4, seed=m + n)
    x = torch.randn((m, k), device=h100).to(dtype)
    rows = k if int4 else None
    assert wo._route(x, q, k, n) == route
    counter = f"LAUNCHES_{route.upper()}"
    n0 = getattr(wo, counter)
    out = wo.weight_only_matmul(x, q, s, int4_rows=rows)
    again = wo.weight_only_matmul(x, q, s, int4_rows=rows)
    torch.cuda.synchronize()
    assert getattr(wo, counter) == n0 + 2
    _wo_close(out, wo._wo_reference(x, q, s, int4, k, dtype))
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))
    if route != "legacy":
        out32 = wo.weight_only_matmul(x, q, s, int4_rows=rows,
                                      out_dtype=torch.float32)
        _wo_close(out32, wo._wo_reference(x, q, s, int4, k, torch.float32))


@pytest.mark.cuda
def test_weight_only_fma_and_unaligned_routes_on_card(h100):
    """fp32 x takes "fma"; a bf16 x one element into its buffer, "legacy"."""
    from paddle_tpu_torch.kernels import weight_only as wo
    k, n = 256, 128
    q, s = _wo_weights(h100, k, n, False, seed=3)
    x = torch.randn((8, k), device=h100)
    n0 = (wo.LAUNCHES_FMA, wo.LAUNCHES_LEGACY)
    _wo_close(wo.weight_only_matmul(x, q, s),
              wo._wo_reference(x, q, s, False, k, torch.float32))
    buf = torch.randn((8 * k + 1,), device=h100).to(torch.bfloat16)
    xo = buf[1:].view(8, k)
    assert wo._route(xo, q, k, n) == "legacy"
    _wo_close(wo.weight_only_matmul(xo, q, s),
              wo._wo_reference(xo, q, s, False, k, torch.bfloat16))
    torch.cuda.synchronize()
    assert (wo.LAUNCHES_FMA, wo.LAUNCHES_LEGACY) == (n0[0] + 1, n0[1] + 1)


# ------------------------------------------------------------ primitives

def _prim_fns():
    from paddle_tpu_torch.kernels.primitives import KernelFn
    silu = "return a / (1.0f + expf(-a))"
    return {"silu_mul": KernelFn(lambda a, b: torch.nn.functional.silu(a) * b,
                                 silu + " * b;"),
            "relu2": KernelFn(lambda a: torch.clamp_min(a, 0) * 2.0,
                              "return fmaxf(a, 0.0f) * 2.0f;"),
            "fma3": KernelFn(lambda a, b, c: a * b + c, "return a * b + c;"),
            "max": KernelFn(torch.maximum, "float m = fmaxf(a, b); m = b != b"
                            " ? b : m; return a != a ? a : m;"),
            "add": KernelFn(torch.add, "return a + b;"),
            "silu": KernelFn(torch.nn.functional.silu, silu + ";")}


def _ulp(want):
    if want.dtype == torch.float32:
        return torch.zeros_like(want)
    fi = torch.finfo(want.dtype)
    return fi.eps * torch.exp2(torch.floor(torch.log2(
        want.float().abs().clamp_min(fi.tiny))))


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtypes", [
    ("relu2", (torch.float32,)), ("relu2", (torch.float16,)),
    ("silu_mul", (torch.bfloat16,) * 2), ("silu_mul", (torch.float32,) * 2),
    ("fma3", (torch.float32, torch.bfloat16, torch.float16)),
    ("fma3", (torch.bfloat16, torch.float16, torch.float32))])
@pytest.mark.parametrize("shape", [(1,), (37, 19), (1_000_003,)])
def test_primitives_elementwise_vs_plain_on_card(h100, name, dtypes, shape):
    from paddle_tpu_torch.kernels import primitives as P
    fn = _prim_fns()[name]
    gen = torch.Generator(device=h100).manual_seed(len(shape))
    ins = [torch.randn(shape, generator=gen, device=h100).to(dt)
           for dt in dtypes]
    n0 = P.LAUNCHES_ELEMENTWISE
    got = P.elementwise_kernel(fn)(*ins)
    torch.cuda.synchronize()
    assert P.LAUNCHES_ELEMENTWISE == n0 + 1
    want = P._elementwise_reference(fn, ins)
    assert got.dtype == dtypes[0] and got.shape == want.shape
    w = want.float()
    lim = _ulp(want) + 1e-6 * (w.abs() + float(w.abs().max()))
    assert bool(((got.float() - w).abs() <= lim).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtypes", [
    ("silu_mul", (torch.bfloat16,) * 2), ("silu_mul", (torch.float32,) * 2),
    ("relu2", (torch.float16,)),
    ("fma3", (torch.float32, torch.bfloat16, torch.float16))])
@pytest.mark.parametrize("n", [1, 7, 8, 4099 * 8 + 5, 1_000_003])
def test_primitives_elementwise_routes_bit_for_bit_on_card(h100, name,
                                                            dtypes, n):
    """Aligned inputs take the "vec16" route (an odd numel's tail masked in
    the kernel), the same values in views one element into their buffers
    the "scalar" route; both give the same bits, each counted on its
    route."""
    from paddle_tpu_torch.kernels import primitives as P
    kern = P.elementwise_kernel(_prim_fns()[name])
    gen = torch.Generator(device=h100).manual_seed(n)
    ins = [torch.randn((n,), generator=gen, device=h100).to(dt)
           for dt in dtypes]
    offs = []
    for x in ins:
        buf = torch.empty((n + 1,), dtype=x.dtype, device=h100)
        buf[1:] = x
        offs.append(buf[1:])
    out = torch.empty((n,), dtype=dtypes[0], device=h100)
    assert P._elementwise_route(ins, out) == "vec16"
    assert P._elementwise_route(offs, out) == "scalar"
    n0, v0 = P.LAUNCHES_ELEMENTWISE, P.LAUNCHES_ELEMENTWISE_VEC16
    vec = kern(*ins)
    torch.cuda.synchronize()
    assert (P.LAUNCHES_ELEMENTWISE, P.LAUNCHES_ELEMENTWISE_VEC16) == \
        (n0 + 1, v0 + 1)
    scalar = kern(*offs)
    torch.cuda.synchronize()
    assert (P.LAUNCHES_ELEMENTWISE, P.LAUNCHES_ELEMENTWISE_VEC16) == \
        (n0 + 2, v0 + 1)
    assert torch.equal(vec.view(torch.int16 if vec.element_size() == 2
                                else torch.int32),
                       scalar.view(torch.int16 if vec.element_size() == 2
                                   else torch.int32))

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("op", ["max", "add"])
@pytest.mark.parametrize("rows,cols", [(1, 1), (100, 19), (8192, 300),
                                       (33, 4096)])
@pytest.mark.parametrize("offset", [0, 1])
def test_primitives_reduce_bit_for_bit_on_card(h100, dtype, op, rows, cols,
                                               offset):
    """``offset`` 1 starts the view one element into its buffer (off the
    16-byte alignment: the "scalar" route); max gets NaNs in rows 3 and
    5 where there are rows."""
    from paddle_tpu_torch.kernels import primitives as P
    fn = _prim_fns()[op]
    gen = torch.Generator(device=h100).manual_seed(cols)
    buf = torch.randn((rows * cols + offset,), generator=gen,
                      device=h100).to(dtype)
    x = buf[offset:].view(rows, cols)
    if op == "max" and rows > 5:
        x[3, cols // 2] = float("nan")
        x[5] = float("nan")
    route = P._reduce_route(x)
    n0, v0 = P.LAUNCHES_REDUCE, P.LAUNCHES_REDUCE_VEC16
    got = P.reduce_kernel(fn, 0.0)(x)
    torch.cuda.synchronize()
    assert P.LAUNCHES_REDUCE == n0 + 1
    assert P.LAUNCHES_REDUCE_VEC16 == v0 + (route == "vec16")
    want = P._reduce_reference(fn, x)
    iv = torch.int32 if dtype == torch.float32 else torch.int16
    assert got.dtype == dtype and torch.equal(got.view(iv), want.view(iv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.float32, torch.bfloat16),
    (torch.bfloat16, None), (torch.bfloat16, torch.float32),
    (torch.float16, None), (torch.float16, torch.float32)])
@pytest.mark.parametrize("epilogue", [None, "relu2", "silu"])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (100, 70, 50), (16, 24, 8),
                                   (257, 4095, 129), (512, 4096, 1024)])
def test_primitives_matmul_vs_plain_on_card(h100, dtype, out_dtype, epilogue,
                                           m, k, n):
    from paddle_tpu_torch.kernels import primitives as P
    efn = _prim_fns()[epilogue] if epilogue else None
    gen = torch.Generator(device=h100).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=h100).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=h100) / k ** 0.5).to(dtype)
    n0 = P.LAUNCHES_MATMUL
    got = P.matmul_kernel(epilogue=efn, out_dtype=out_dtype)(x, w)
    torch.cuda.synchronize()
    assert P.LAUNCHES_MATMUL == n0 + 1
    odt = out_dtype or dtype
    want = P._matmul_reference(efn or P._IDENTITY, x, w, odt)
    assert got.dtype == odt and got.shape == (m, n)
    wf = want.float()
    lim = _ulp(want) + 1e-4 * (wf.abs() + float(wf.abs().max()))
    assert bool(((got.float() - wf).abs() <= lim).all())


@pytest.mark.cuda
def test_primitives_refuse_what_the_kernels_do_not_take_on_card(h100):
    """No fallback on the card: a function without a CUDA body, a
    non-contiguous input and a device mismatch raise; empty inputs return
    without a launch."""
    from paddle_tpu_torch.kernels import primitives as P
    x = torch.randn((8, 64), device=h100)
    with pytest.raises(ValueError, match="CUDA body"):
        P.elementwise_kernel(lambda a: a)(x)
    with pytest.raises(ValueError, match="CUDA body"):
        P.reduce_kernel(torch.add, 0.0)(x)
    with pytest.raises(ValueError, match="contiguous"):
        P.reduce_kernel(_prim_fns()["add"], 0.0)(x.T)
    with pytest.raises(ValueError, match="contiguous"):
        P.matmul_kernel()(x, x.T)
    with pytest.raises(ValueError):
        P.elementwise_kernel(_prim_fns()["silu_mul"])(x, x.cpu())
    counts = (P.LAUNCHES_ELEMENTWISE, P.LAUNCHES_REDUCE, P.LAUNCHES_MATMUL)
    assert P.elementwise_kernel(_prim_fns()["relu2"])(x[:0]).shape == (0, 64)
    assert P.reduce_kernel(_prim_fns()["max"], 0.0)(x[:0]).shape == (0,)
    assert P.matmul_kernel()(x[:0], x.T.contiguous()).shape == (0, 8)
    assert counts == (P.LAUNCHES_ELEMENTWISE, P.LAUNCHES_REDUCE,
                      P.LAUNCHES_MATMUL)
    # k = 0: the sum is 0, and the epilogue still runs on it
    y = P.matmul_kernel(epilogue=P.KernelFn(lambda a: a + 1,
                                            "return a + 1.0f;"))(
        x[:, :0], x[:0, :5].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(y, torch.ones((8, 5), device=h100))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, None), (torch.bfloat16, torch.float32),
    (torch.float16, None), (torch.float32, None)])
@pytest.mark.parametrize("m,k,n,offset", [
    (300, 200, 520, 0), (100, 72, 56, 0), (8192, 4096, 11008, 0),
    (100, 70, 50, 0), (64, 128, 64, 1)])
def test_primitives_matmul_routes_on_card(h100, dtype, out_dtype, m, k, n,
                                          offset):
    """Each route by its counter ("sm90" for bf16/fp16 with k, n multiples
    of 8 and aligned operands, "mma" for other bf16/fp16, "fma" for fp32),
    against the plain version; the "sm90" route repeats bit for bit."""
    from paddle_tpu_torch.kernels import primitives as P
    gen = torch.Generator(device=h100).manual_seed(m + k)
    x = torch.randn((m, k), generator=gen, device=h100).to(dtype)
    if offset:             # the same values off the 16-byte alignment
        xb = torch.empty((m * k + offset,), device=h100, dtype=dtype)
        xb[offset:].copy_(x.view(-1))
        x = xb[offset:].view(m, k)
    w = (torch.randn((k, n), generator=gen, device=h100) / k ** 0.5).to(dtype)
    route = P._matmul_route(x, w)
    want_route = "fma" if dtype == torch.float32 else \
        "sm90" if (k % 8 == 0 and n % 8 == 0 and not offset) else "mma"
    assert route == want_route
    counter = f"LAUNCHES_MATMUL_{route.upper()}"
    n0 = getattr(P, counter)
    mm = P.matmul_kernel(epilogue=_prim_fns()["silu"], out_dtype=out_dtype)
    got = mm(x, w)
    again = mm(x, w)
    torch.cuda.synchronize()
    assert getattr(P, counter) == n0 + 2
    odt = out_dtype or dtype
    want = P._matmul_reference(_prim_fns()["silu"], x, w, odt)
    wf = want.float()
    lim = _ulp(want) + 1e-4 * (wf.abs() + float(wf.abs().max()))
    assert bool(((got.float() - wf).abs() <= lim).all())
    if route == "sm90":
        assert torch.equal(got, again)


# ---- the Paddle-API entries that reach the kernels ----

def _decode_operands(dev, *, B=8, qh=32, kvh=32, d=128, page=16, pages=300,
                     ctxs=(1, 17, 100, 255, 256, 300, 448, 512), seed=0):
    g = torch.Generator().manual_seed(seed)
    per = -(-max(ctxs) // page)
    q = torch.randn(B, qh, d, generator=g)
    kc = torch.randn(kvh, pages, page, d, generator=g)
    vc = torch.randn(kvh, pages, page, d, generator=g)
    bt = torch.randperm(pages, generator=g)[:B * per].reshape(B, per)
    cl = torch.tensor(ctxs, dtype=torch.int64)
    return [t.to(dev) for t in (q.bfloat16(), kc.bfloat16(), vc.bfloat16(),
                                bt, cl)]


@pytest.mark.cuda
@pytest.mark.parametrize("qh,kvh", [(32, 32), (32, 8)], ids=["mha", "gqa4"])
def test_decode_attention_takes_the_split_route_on_card(h100, qh, kvh):
    """``incubate.nn.functional.decode_attention`` with int64 block tables
    and lengths: one launch on the "split" route, equal to the plain
    version on a CPU copy within the bf16 ``out`` tolerance."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    ops = _decode_operands(h100, qh=qh, kvh=kvh)
    split = pa.LAUNCHES_SPLIT
    got = IF.decode_attention(*ops)
    assert pa.LAUNCHES_SPLIT == split + 1
    want = IF.decode_attention(*(t.cpu() for t in ops))
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_decode_attention_refuses_what_the_kernel_does_not_take(h100):
    from paddle_tpu_torch.incubate.nn import functional as IF
    q, kc, vc, bt, cl = _decode_operands(h100, d=96, pages=40,
                                         ctxs=(5,) * 8)
    with pytest.raises(ValueError, match="head_dim"):
        IF.decode_attention(q, kc, vc, bt, cl)
    q, kc, vc, bt, cl = _decode_operands(h100, qh=32, kvh=2, pages=40,
                                         ctxs=(5,) * 8)
    with pytest.raises(ValueError, match="GQA group"):
        IF.decode_attention(q, kc, vc, bt, cl)


@pytest.mark.cuda
def test_flashmask_equals_flash_with_its_mask_on_card(h100):
    """``nn.functional.flashmask_attention`` builds the reference's mask on
    the card and takes the flash kernels' mask mode ("sm90" at bf16 d 128):
    out and dQ/dK/dV bit for bit those of ``flash_attention(attn_mask=...,
    causal=True)``, one launch of each kernel on "sm90"."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F
    g = torch.Generator().manual_seed(0)
    b, s, h, d = 2, 512, 4, 128
    q, k, v, cot = (torch.randn(b, s, h, d, generator=g).bfloat16().to(h100)
                    for _ in range(4))
    ends = torch.tensor([128, 320, 512])
    start = ends[torch.searchsorted(ends, torch.arange(s), right=True)]
    si = start.reshape(1, 1, s, 1).expand(b, 1, s, 1).contiguous().to(h100)
    rows = torch.arange(s, device=h100)[:, None]
    mask = torch.where(rows >= si[..., 0][:, :, None, :], -1e9, 0.0)

    def run(fn):
        a = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*a)
        (out.float() * cot.float()).sum().backward()
        return [out] + [t.grad for t in a]
    before = (fa.LAUNCHES_FWD_SM90, fa.LAUNCHES_BWD_DQ_SM90,
              fa.LAUNCHES_BWD_DKV_SM90)
    got = run(lambda *a: F.flashmask_attention(*a, si, causal=True))
    assert (fa.LAUNCHES_FWD_SM90, fa.LAUNCHES_BWD_DQ_SM90,
            fa.LAUNCHES_BWD_DKV_SM90) == tuple(n + 1 for n in before)
    want = run(lambda *a: fa.flash_attention(*a, causal=True,
                                             attn_mask=mask.float()))
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_quantization_on_card_equals_the_cpu(h100):
    """fp8 casts give NaN past e4m3's range on the card as on the CPU;
    ``llm_int8_linear`` and ``fp8_linear`` on the card against a CPU copy
    (fp32 sums in other orders)."""
    from paddle_tpu_torch import quantization as Q
    v = torch.tensor([1.0, 440, 460, 464, 464.1, 470, 1e5, -470, float("inf")])
    got, _ = Q.fp8_quantize(v.to(h100), scale=torch.tensor(1.0).to(h100))
    want, _ = Q.fp8_quantize(v, scale=torch.tensor(1.0))
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               equal_nan=True, rtol=0, atol=0)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 512, generator=g)
    x[:, [5, 77]] *= 20.0
    w = torch.randn(512, 256, generator=g)
    qw, s = Q.weight_quantize(w)
    for fn in (lambda *a: Q.llm_int8_linear(a[0], a[1], weight_scale=a[2]),
               lambda *a: Q.fp8_linear(a[0], a[3])):
        ref = fn(x, qw, s, w)
        out = fn(*(t.to(h100) for t in (x, qw, s, w))).cpu()
        torch.testing.assert_close(out, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
def test_sparse_embedding_step_reads_nothing_on_the_card(h100):
    """A row-sparse gradient is coalesced and a lazy Adam / clipped SGD
    step applied with no synchronizing CUDA call, and the step equals the
    CPU's (fp32, the same order of sums but for atomics: 1e-6)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import device as pdev
    weights = {}
    for dev in ("cpu", "cuda"):
        old = pdev._current[0]
        paddle.set_device(dev)
        ids = torch.tensor([[3, 1, 3, 9], [1, 1, 0, 7]], device=dev)
        try:
            paddle.seed(0)
            emb = paddle.nn.Embedding(12, 8, sparse=True)
            with torch.no_grad():
                emb.weight.copy_(torch.arange(96.0).reshape(12, 8) / 96)
            for opt in (paddle.optimizer.Adam(0.1, parameters=[emb.weight],
                                              lazy_mode=True),
                        paddle.optimizer.SGD(
                            1.0, parameters=[emb.weight],
                            grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error" if dev == "cuda"
                                               else mode)
                try:
                    (emb(ids) ** 2).sum().backward()
                    opt.step()
                    opt.clear_grad()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            weights[dev] = emb.weight.detach().cpu()
        finally:
            pdev._current[0] = old
    torch.testing.assert_close(weights["cuda"], weights["cpu"], rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
def test_scalar_operands_read_nothing_on_the_card(h100):
    """A Paddle op with a Python number beside a tensor fills the number in
    on the card: no synchronizing host-to-device copy."""
    import paddle_tpu_torch as paddle
    x = paddle.to_tensor(torch.arange(6.0), place="gpu")
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = (x ** 2 + 1.0) * 3 - 2 * x
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.testing.assert_close(y.cpu(), (torch.arange(6.0) ** 2 + 1) * 3 -
                               2 * torch.arange(6.0))
