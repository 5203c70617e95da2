"""The ragged paged attention's split route (decode and speculative verify,
``T x group <= 16`` query rows a kv-head) on the CPU.

The CUDA split kernel cannot run here; what surrounds it can.  This file
holds

- the route rule and the split plan (whole pages, capped by the block
  table's width, computed from shapes alone: meta tensors plan as well);
- a test-side emulation of the split kernel's arithmetic, in fp32: each
  split takes its whole pages of the live context (split s of S: pages
  [n s / S, n (s + 1) / S)), each of its four warps keeps an online softmax
  over its 8 keys of every 32-key chunk (m from -1e30, missing keys -inf),
  the last split also folds in the step's fresh rows (causal, masked keys
  at -1e30), the warps are combined, an empty split leaves m = -inf, and
  the partials are merged by their lse weights (l clamped to 1e-30).

The emulation is held against the port's plain
``_reference_ragged_paged_attention`` and the JAX package's
``_reference_ragged_paged_attention`` (jitted; the Pallas interpret mode of
this kernel does not run on the installed jax), over tiny shapes with
contexts 0, 1, page - 1, page and page + 1 and a long one, GQA groups 1 and
4, T 1 and 4, float and int8 pools, at the plan's split count and at a
forced larger one.  Rows past ``q_lens`` are don't-care and are not
compared.  Tolerance: fp32, 2e-5 (summation order only).

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
NEG = -1e30
CHUNK, WARPS = 32, 4

_jax_ragged = jax.jit(jpa._reference_ragged_paged_attention)


# ------------------------------------------------------ route and plan ---

@pytest.mark.parametrize("T,group,route", [
    (1, 1, "split"), (1, 8, "split"), (4, 4, "split"), (2, 8, "split"),
    (16, 1, "split"), (17, 1, "tile"), (5, 4, "tile"), (64, 1, "tile")])
def test_route_rule(T, group, route):
    assert pa._route(T, group) == route


def test_split_plan_is_whole_pages_capped_by_the_table():
    for B in (1, 2, 8, 64):
        for kvh in (1, 8, 32):
            for W in (1, 3, 64, 1024):
                for page in (8, 16, 128):
                    s = pa.split_plan(B, kvh, W, page)
                    min_pages = -(-pa._SPLIT_MIN_KEYS // page)
                    assert 1 <= s <= max(1, -(-W // min_pages))
                    assert s <= pa._SPLIT_MAX
    # llama2_7b decode (B 8, 32 kv-heads) fills ~2 x 132 CTAs with one
    # split; Mixtral (8 kv-heads) needs four
    assert pa.split_plan(8, 32, 64, 16) == 1
    assert pa.split_plan(8, 8, 64, 16) == 4
    assert pa.split_plan(1, 8, 64, 16) == 16     # capped by W: 64 pages / 4


def test_launch_plan_reads_no_value():
    """The plan comes from shapes alone: meta tensors (no data) plan."""
    meta = dict(device="meta")
    bt = torch.empty((8, 64), dtype=torch.int32, **meta)
    k = torch.empty((8, 300, 16, 128), **meta)
    plan = pa.launch_plan(torch.empty((8, 1, 32, 128), **meta), k, bt)
    assert plan == {"route": "split", "splits": 4,
                    "workspace": 8 * 8 * 4 * 16 * 130}
    plan = pa.launch_plan(torch.empty((8, 1, 32, 128), **meta),
                          torch.empty((32, 300, 16, 128), **meta), bt)
    assert plan == {"route": "split", "splits": 1, "workspace": 0}
    plan = pa.launch_plan(torch.empty((8, 64, 32, 128), **meta), k, bt)
    assert plan["route"] == "tile"


# ------------------------------------------------- the kernel's arithmetic ---

def _online(state, s, v):
    """One online-softmax step of a warp: s [R, n] scores (missing keys
    -inf), v [n, d]."""
    m, l, acc = state
    m_new = torch.maximum(m, s.max(dim=1).values)
    a = torch.exp(m - m_new)
    p = torch.exp(s - m_new[:, None])
    return m_new, a * l + p.sum(dim=1), a[:, None] * acc + p @ v


def _combine(states):
    """The warps' (or splits') states merged by their lse weights; entries
    at m = -inf weigh nothing."""
    ms = torch.stack([st[0] for st in states])            # [n, R]
    big = torch.clamp(ms.max(dim=0).values, min=NEG)
    w = torch.where(ms == -math.inf, torch.zeros_like(ms),
                    torch.exp(ms - big))
    l = sum(wi * st[1] for wi, st in zip(w, states))
    acc = sum(wi[:, None] * st[2] for wi, st in zip(w, states))
    return big, l, acc


def split_emulation(q, kc, vc, bt, ctx, ql, kn, vn, ks=None, vs=None, *,
                    splits):
    """What the split kernel computes, step by step, in fp32."""
    B, T, qh, d = q.shape
    kvh, _, page, _ = kc.shape
    W = bt.shape[1]
    g = qh // kvh
    R = T * g
    out = torch.zeros((B, T, qh, d))
    lse = torch.zeros((B, T, qh))
    for b in range(B):
        c = max(0, min(int(ctx[b]), W * page))
        n = -(-c // page)
        for h in range(kvh):
            qr = q[b, :, h * g:(h + 1) * g].reshape(R, d) / math.sqrt(d)
            rows_t = torch.arange(R) // g
            parts = []
            for sp in range(splits):
                lo = n * sp // splits * page
                hi = min(c, n * (sp + 1) // splits * page)
                warps = [(torch.full((R,), NEG), torch.zeros(R),
                          torch.zeros((R, d))) for _ in range(WARPS)]
                for c0 in range(lo, hi, CHUNK):
                    for w in range(WARPS):
                        pos = range(c0 + 8 * w, min(c0 + 8 * w + 8, hi))
                        if not len(pos):
                            continue
                        pid = [int(bt[b, p // page]) for p in pos]
                        kk = torch.stack([kc[h, i, p % page]
                                          for i, p in zip(pid, pos)])
                        vv = torch.stack([vc[h, i, p % page]
                                          for i, p in zip(pid, pos)])
                        if ks is not None:
                            kk = kk * torch.tensor([float(ks[h, i])
                                                    for i in pid])[:, None]
                            vv = vv * torch.tensor([float(vs[h, i])
                                                    for i in pid])[:, None]
                        warps[w] = _online(warps[w], qr @ kk.T, vv)
                fresh = sp == splits - 1 and kn is not None
                if fresh:
                    for w in range(2):
                        if 8 * w >= T:
                            continue
                        js = torch.arange(8 * w, min(8 * w + 8, T))
                        s = qr @ kn[b, js, h].T
                        ok = (js[None, :] <= rows_t[:, None]) & \
                            (js[None, :] < int(ql[b]))
                        s = torch.where(ok, s, torch.full_like(s, NEG))
                        warps[w] = _online(warps[w], s, vn[b, js, h])
                m, l, acc = _combine(warps)
                if hi <= lo and not fresh:
                    m = torch.full((R,), -math.inf)
                parts.append((m, l, acc))
            m, l, acc = _combine(parts) if splits > 1 else parts[0]
            lc = torch.clamp(l, min=1e-30)
            o = (acc / lc[:, None]).reshape(T, g, d)
            out[b, :, h * g:(h + 1) * g] = o
            lse[b, :, h * g:(h + 1) * g] = (m + torch.log(lc)).reshape(T, g)
    return out, lse


def _case(seed, *, B, T, qh, kvh, d, page, n_pages, W, int8):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = dict(q=rng.standard_normal((B, T, qh, d)).astype(f),
             k_new=rng.standard_normal((B, T, kvh, d)).astype(f),
             v_new=rng.standard_normal((B, T, kvh, d)).astype(f),
             block_tables=rng.integers(0, n_pages, (B, W)).astype(np.int32))
    for name in ("k", "v"):
        pool = rng.standard_normal((kvh, n_pages, page, d)).astype(f)
        if int8:
            pool[:, 0] = 0.0                      # an all-zero page
            amax = np.abs(pool).max(axis=(2, 3))
            sc = np.where(amax > 0, amax / 127.0, 1.0).astype(f)
            pool = np.clip(np.round(pool / sc[..., None, None]), -127,
                           127).astype(np.int8)
            x[f"{name}_scale"] = sc
        x[f"{name}_cache"] = pool
    return x


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("group,T", [(1, 1), (4, 1), (1, 4), (4, 4)])
def test_split_emulation_matches_port_and_jax(int8, group, T):
    page, kvh, d, B = 8, 2, 64, 6
    W = 8
    x = _case(group * 10 + T + int8, B=B, T=T, qh=kvh * group, kvh=kvh, d=d,
              page=page, n_pages=20, W=W, int8=int8)
    ctx = np.asarray([0, 1, page - 1, page, page + 1, W * page - 3],
                     np.int32)
    ql = np.asarray([T, 1, T, max(T - 1, 0), T, T], np.int32)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cache_args = (t["k_cache"].float(), t["v_cache"].float(),
                  t["block_tables"], torch.from_numpy(ctx),
                  torch.from_numpy(ql), t["k_new"], t["v_new"],
                  t.get("k_scale"), t.get("v_scale"))
    assert pa._route(T, group) == "split"
    want, want_lse = pa._reference_ragged_paged_attention(
        t["q"], t["k_cache"], t["v_cache"], t["block_tables"],
        torch.from_numpy(ctx), torch.from_numpy(ql), t["k_new"], t["v_new"],
        t.get("k_scale"), t.get("v_scale"))
    jw, jw_lse = _jax_ragged(
        *(jnp.asarray(x[k]) for k in ("q", "k_cache", "v_cache",
                                      "block_tables")),
        jnp.asarray(ctx), jnp.asarray(ql), jnp.asarray(x["k_new"]),
        jnp.asarray(x["v_new"]),
        *((jnp.asarray(x["k_scale"]), jnp.asarray(x["v_scale"])) if int8
          else ()))
    keep = np.arange(T)[None, :] < ql[:, None]
    plan = pa.split_plan(B, kvh, W, page)
    for splits in sorted({plan, 3}):
        out, lse = split_emulation(t["q"], *cache_args, splits=splits)
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        np.testing.assert_allclose(out.numpy()[keep], want.numpy()[keep],
                                   **TOL)
        np.testing.assert_allclose(lse.numpy()[keep],
                                   want_lse.numpy()[keep], **TOL)
        np.testing.assert_allclose(out.numpy()[keep], np.asarray(jw)[keep],
                                   **TOL)
        np.testing.assert_allclose(lse.numpy()[keep],
                                   np.asarray(jw_lse)[keep], **TOL)


def test_an_empty_split_weighs_nothing():
    """A split past the context leaves m = -inf and changes no bit of the
    merge: splits 1 and 4 agree on a context of one page."""
    x = _case(3, B=1, T=1, qh=2, kvh=2, d=64, page=8, n_pages=4, W=4,
              int8=False)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    args = (t["q"], t["k_cache"], t["v_cache"], t["block_tables"],
            torch.tensor([8], dtype=torch.int32),
            torch.tensor([1], dtype=torch.int32), t["k_new"], t["v_new"])
    one = split_emulation(*args, splits=1)
    four = split_emulation(*args, splits=4)
    np.testing.assert_allclose(four[0].numpy(), one[0].numpy(), **TOL)
    np.testing.assert_allclose(four[1].numpy(), one[1].numpy(), **TOL)
