"""The ragged paged attention's sm90 route (prefill chunks, ``T x group >
16`` query rows a kv-head, bf16 q over a bf16 or int8 pool) on the CPU.

The CUDA kernel (``csrc/ragged_paged_attention_sm90.cu``) cannot run here;
what surrounds it can.  This file holds

- the route rule across "split" / "sm90" / "tile" by dtype, T, group, head
  dim, page size and alignment, and the launch plan from shapes alone (meta
  tensors plan as well);
- a test-side emulation of the sm90 kernel's walk, in fp32: 64-row Q tiles
  of rows r = t x group + g; 64-key tiles of the context assembled from
  boxes of gcd(page, 64) rows, each inside one page (a box past the context
  is zeros); the online softmax per key tile (m from -1e30, keys past the
  context -inf); P rounded to bf16 before its product with V (or not); an
  int8 tile's codes taken exactly, k_scale on S's columns and v_scale on
  P's columns before the rounding; the fresh rows last, causal (masked keys
  at -1e30, keys past T -inf); a tile whose rows are all past q_lens reads
  nothing; l clamped to 1e-30.

The emulation is held against the port's plain
``_reference_ragged_paged_attention`` and the JAX package's
``_reference_ragged_paged_attention`` (jitted, called with fp32 pools and
scales in both modes; the Pallas interpret mode of this kernel does not
run on the installed jax), over tiny shapes with
contexts 0, 1, page - 1, page, page + 1 and a long one, q_lens 0, 1 and T,
GQA groups 1, 4 and 8 (one and two Q tiles), pages 8, 16, 40 and 128
(40: 8-row boxes, two pages in some tiles), float and int8 pools.  Rows past ``q_lens`` are don't-care and are not compared
(they must be finite).  Inputs are bf16 values (the kernel's operands).

Tolerance: without the P rounding the walk is the plain math summed in
another order, 2e-5 (fp32).  With it, each p carries one bf16 rounding
(relative 2^-9), so ``out`` moves by up to ~0.4% of the values it averages:
rtol 1e-2 + atol 2e-2, the card's bf16 tolerance for ``out``
(``tests/test_torch_cuda_kernels.py``); ``lse`` is taken from the unrounded
p and stays at 2e-5.

The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
TOL_BF16_OUT = dict(rtol=1e-2, atol=2e-2)
NEG = -1e30
BM = BN = 64                     # query rows of a CTA, keys of a tile

_jax_ragged = jax.jit(jpa._reference_ragged_paged_attention)
bf16, f32 = torch.bfloat16, torch.float32


# ------------------------------------------------------ route and plan ---

@pytest.mark.parametrize("T,group,q_dt,kv_dt,d,route", [
    (64, 1, bf16, bf16, 128, "sm90"),      # llama2_7b prefill chunk
    (64, 4, bf16, bf16, 128, "sm90"),      # Mixtral
    (64, 1, bf16, torch.int8, 128, "sm90"),
    (17, 1, bf16, bf16, 64, "sm90"),
    (5, 4, bf16, torch.int8, 64, "sm90"),
    (3, 8, bf16, bf16, 128, "sm90"),
    (128, 2, bf16, bf16, 128, "sm90"),
    (16, 1, bf16, bf16, 128, "split"),      # R 16: decode-sized
    (2, 8, bf16, torch.int8, 128, "split"),
    (64, 1, f32, f32, 128, "tile"),
    (64, 1, bf16, f32, 128, "tile"),        # pool dtype apart from q's
    (64, 1, f32, bf16, 128, "tile"),
    (64, 1, f32, torch.int8, 128, "tile"),
    (8, 3, bf16, bf16, 128, "tile"),        # a group that does not divide 64
    (8, 6, bf16, bf16, 128, "tile"),
    (64, 1, bf16, bf16, 96, "tile")])
def test_route_rule(T, group, q_dt, kv_dt, d, route):
    assert pa._route(T, group, q_dt, kv_dt, d) == route
    if route == "sm90":
        assert pa._route(T, group, q_dt, kv_dt, d, aligned=False) == "tile"


@pytest.mark.parametrize("page", [8, 16, 40, 128])
@pytest.mark.parametrize("pool,route", [(bf16, "sm90"), (torch.int8, "sm90"),
                                        (f32, "tile")])
def test_launch_plan_on_meta_tensors(page, pool, route):
    """Shapes, dtypes and pointers alone (a meta tensor's pointer is 0):
    every page size the kernels take plans the same route."""
    meta = dict(device="meta")
    q = torch.empty((8, 64, 32, 128), dtype=bf16, **meta)
    k = torch.empty((32, 300, page, 128), dtype=pool, **meta)
    bt = torch.empty((8, 64), dtype=torch.int32, **meta)
    fresh = torch.empty((8, 64, 32, 128), dtype=bf16, **meta)
    plan = pa.launch_plan(q, k, bt, v_cache=k, k_new=fresh, v_new=fresh)
    assert plan == {"route": route, "splits": None, "workspace": 0}
    # decode over the same pool keeps the split route
    assert pa.launch_plan(q[:, :1], k, bt)["route"] == "split"


def test_launch_plan_reads_alignment_and_pool_rows():
    """An operand that does not start on 16 bytes (an offset view) or a
    pool whose rows pass TMA's int32 coordinate takes the tile kernel."""
    buf = torch.zeros(2 * 24 * 8 * 64 + 1, dtype=bf16)
    q = buf[:2 * 24 * 8 * 64].view(2, 24, 8, 64)
    q_off = buf[1:].view(2, 24, 8, 64)
    k = torch.zeros((2, 10, 16, 64), dtype=bf16)
    bt = torch.zeros((2, 4), dtype=torch.int32)
    assert q.data_ptr() % 16 == 0 and q_off.data_ptr() % 16 == 2
    assert pa.launch_plan(q, k, bt)["route"] == "sm90"
    assert pa.launch_plan(q_off, k, bt)["route"] == "tile"
    fresh_buf = torch.zeros(2 * 24 * 2 * 64 + 8, dtype=bf16)
    k_new_off = fresh_buf[8 - 1:-1].view(2, 24, 2, 64)
    assert pa.launch_plan(q, k, bt, k_new=k_new_off,
                          v_new=k_new_off)["route"] == "tile"
    huge = torch.empty((32, 2 ** 22, 16, 128), dtype=bf16, device="meta")
    qm = torch.empty((8, 64, 32, 128), dtype=bf16, device="meta")
    assert pa.launch_plan(qm, huge, bt)["route"] == "tile"
    assert pa.launch_plan(qm, huge[:, :2 ** 21], bt)["route"] == "sm90"


# ------------------------------------------------- the kernel's arithmetic ---

def sm90_emulation(q, kc, vc, bt, ctx, ql, kn, vn, ks=None, vs=None):
    """What the sm90 prefill kernel computes, tile by tile, in fp32: returns
    (out with P rounded to bf16 before P V, as the kernel does; out with P
    left in fp32; lse, which is the same for both)."""
    B, T, qh, d = q.shape
    kvh, n_pages, page, _ = kc.shape
    W = bt.shape[1]
    g = qh // kvh
    R = T * g
    c2 = 1.0 / math.sqrt(d)
    box = math.gcd(page, BN)
    q, kc, vc = q.float(), kc.float(), vc.float()
    out = torch.zeros((B, T, qh, d))
    out_exact = torch.zeros((B, T, qh, d))
    lse = torch.zeros((B, T, qh))
    for b in range(B):
        c = max(0, min(int(ctx[b]), W * page))
        qlb = min(int(ql[b]), T)
        for h in range(kvh):
            qr = q[b, :, h * g:(h + 1) * g].reshape(R, d)
            for r0 in range(0, R, BM):
                rows = torch.arange(r0, min(r0 + BM, R))
                tr = rows // g
                live = r0 // g < qlb
                fresh_keys = min(qlb, (r0 + BM - 1) // g + 1) \
                    if kn is not None else 0
                tiles = []                    # (scores, values, v scales)
                for k0 in range(0, c if live else 0, BN):
                    K, V = torch.zeros((BN, d)), torch.zeros((BN, d))
                    ksc, vsc = torch.zeros(BN), torch.zeros(BN)
                    for j in range(BN // box):
                        key = k0 + j * box
                        if key >= c:
                            continue          # a box past the pool: zeros
                        pid = min(max(int(bt[b, key // page]), 0),
                                  n_pages - 1)
                        off = key % page
                        sl = slice(j * box, (j + 1) * box)
                        K[sl] = kc[h, pid, off:off + box]
                        V[sl] = vc[h, pid, off:off + box]
                        if ks is not None:
                            ksc[sl] = float(ks[h, pid])
                            vsc[sl] = float(vs[h, pid])
                    s = qr[rows] @ K.T
                    if ks is not None:
                        s = s * ksc[None, :]
                    keys = torch.arange(k0, k0 + BN)
                    s = torch.where(keys[None, :] >= c,
                                    torch.full_like(s, -math.inf), s)
                    tiles.append((s, V, vsc if ks is not None else None))
                for j0 in range(0, fresh_keys if live else 0, BN):
                    js = torch.arange(j0, j0 + BN)
                    K, V = torch.zeros((BN, d)), torch.zeros((BN, d))
                    n = max(0, min(BN, T - j0))
                    K[:n] = kn[b, j0:j0 + n, h].float()
                    V[:n] = vn[b, j0:j0 + n, h].float()
                    s = qr[rows] @ K.T
                    masked = (js[None, :] > tr[:, None]) | (js[None, :] >= qlb)
                    s = torch.where(masked, torch.full_like(s, NEG), s)
                    s = torch.where(js[None, :] >= T,
                                    torch.full_like(s, -math.inf), s)
                    tiles.append((s, V, None))
                m = torch.full((len(rows),), NEG)
                l = torch.zeros(len(rows))
                acc = torch.zeros((len(rows), d))      # P rounded to bf16
                acc_exact = torch.zeros((len(rows), d))
                for s, V, vsc in tiles:
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp((m - m_new) * c2)
                    p = torch.exp((s - m_new[:, None]) * c2)
                    l = l * alpha + p.sum(dim=1)
                    if vsc is not None:
                        p = p * vsc[None, :]
                    acc = acc * alpha[:, None] + p.to(bf16).float() @ V
                    acc_exact = acc_exact * alpha[:, None] + p @ V
                    m = m_new
                lc = torch.clamp(l, min=1e-30)
                t_of, g_of = rows // g, rows % g
                out[b, t_of, h * g + g_of] = acc / lc[:, None]
                out_exact[b, t_of, h * g + g_of] = acc_exact / lc[:, None]
                lse[b, t_of, h * g + g_of] = m * c2 + torch.log(lc)
    return out, out_exact, lse


def _jax_ragged_fp32_pool(x, ctx, ql):
    """The JAX reference on case ``x``, its pools as fp32 with scales: an
    int8 pool's codes as fp32 (the reference widens them so), a float pool
    with unit scales (x * 1.0 = x).  The values are the same as either
    mode's own call, and both modes of a shape share one compile."""
    kvh, n_pages = x["k_cache"].shape[:2]
    ones = np.ones((kvh, n_pages), np.float32)
    return _jax_ragged(
        jnp.asarray(x["q"]),
        jnp.asarray(x["k_cache"].astype(np.float32)),
        jnp.asarray(x["v_cache"].astype(np.float32)),
        jnp.asarray(x["block_tables"]), jnp.asarray(ctx), jnp.asarray(ql),
        jnp.asarray(x["k_new"]), jnp.asarray(x["v_new"]),
        jnp.asarray(x.get("k_scale", ones)),
        jnp.asarray(x.get("v_scale", ones)))


def _bf16(x):
    return torch.from_numpy(x).to(bf16).float().numpy()


def _case(seed, *, B, T, qh, kvh, d, page, n_pages, W, int8):
    """bf16-valued inputs (the kernel's operands); an int8 pool is the
    per-(kv-head, page) absmax quantization of an fp32 one, with an all-zero
    page (scale 1.0)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = dict(q=_bf16(rng.standard_normal((B, T, qh, d)).astype(f)),
             k_new=_bf16(rng.standard_normal((B, T, kvh, d)).astype(f)),
             v_new=_bf16(rng.standard_normal((B, T, kvh, d)).astype(f)),
             block_tables=rng.integers(0, n_pages, (B, W)).astype(np.int32))
    for name in ("k", "v"):
        pool = rng.standard_normal((kvh, n_pages, page, d)).astype(f)
        if int8:
            pool[:, 0] = 0.0
            amax = np.abs(pool).max(axis=(2, 3))
            sc = np.where(amax > 0, amax / 127.0, 1.0).astype(f)
            pool = np.clip(np.round(pool / sc[..., None, None]), -127,
                           127).astype(np.int8)
            x[f"{name}_scale"] = sc
        else:
            pool = _bf16(pool)
        x[f"{name}_cache"] = pool
    return x


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("group,T", [(1, 72), (4, 20), (8, 12)])
@pytest.mark.parametrize("page", [8, 16, 40, 128])
def test_sm90_emulation_matches_port_and_jax(int8, group, T, page):
    """Each case has two Q tiles (R = 72, 80 or 96 rows) and every listed
    context, q_lens 0, 1 and T among its six sequences."""
    kvh, d, B = 2, 64, 6
    long_ctx = 2 * BN + page + 3
    W = -(-long_ctx // page) + 1
    x = _case(group * 100 + T + page + int8, B=B, T=T, qh=kvh * group,
              kvh=kvh, d=d, page=page, n_pages=W + 3, W=W, int8=int8)
    ctx = np.asarray([0, 1, page - 1, page, page + 1, long_ctx], np.int32)
    ql = np.asarray([T, 1, T, 0, T - 3, T], np.int32)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    pool_dt = torch.int8 if int8 else bf16
    assert pa._route(T, group, bf16, pool_dt, d) == "sm90"
    args = (t["q"], t["k_cache"], t["v_cache"], t["block_tables"],
            torch.from_numpy(ctx), torch.from_numpy(ql), t["k_new"],
            t["v_new"], t.get("k_scale"), t.get("v_scale"))
    want, want_lse = pa._reference_ragged_paged_attention(*args)
    jw, jw_lse = _jax_ragged_fp32_pool(x, ctx, ql)
    keep = np.arange(T)[None, :] < ql[:, None]
    got, exact, got_lse = sm90_emulation(*args)
    for x in (got, exact, got_lse):
        assert torch.isfinite(x).all()
    for ref, ref_lse in ((want.numpy(), want_lse.numpy()),
                         (np.asarray(jw), np.asarray(jw_lse))):
        np.testing.assert_allclose(exact.numpy()[keep], ref[keep], **TOL)
        np.testing.assert_allclose(got.numpy()[keep], ref[keep],
                                   **TOL_BF16_OUT)
        np.testing.assert_allclose(got_lse.numpy()[keep], ref_lse[keep],
                                   **TOL)


def test_an_idle_tile_reads_nothing_and_stays_finite():
    """A tile whose rows are all past q_lens (here q_lens 0) walks no key
    tile: out 0 and lse = -1e30 / sqrt(d) + log(1e-30), finite."""
    x = _case(5, B=1, T=32, qh=2, kvh=2, d=64, page=16, n_pages=4, W=4,
              int8=False)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out, out_exact, lse = sm90_emulation(
        t["q"], t["k_cache"], t["v_cache"], t["block_tables"],
        torch.tensor([40], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32), t["k_new"], t["v_new"])
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(out_exact, torch.zeros_like(out))
    want = NEG / math.sqrt(64) + math.log(1e-30)
    np.testing.assert_allclose(lse.numpy(), np.full(lse.shape, want),
                               rtol=1e-6)
