"""The MoE weight gradient's sm90 route (bf16 tgmm on wgmma) on the CPU.

The CUDA kernel (``csrc/tgmm_sm90.cu``) cannot run here; what surrounds it
can.  This file holds

- the route rule: bf16 takes "sm90", fp32 "simt" (fp32 must match fp32
  references to 1e-5, where wgmma would need TF32);
- the plan, ``tgmm_sm90_plan``: 128 K rows x 256 (or 128) N columns a CTA,
  k-steps of 64 rows; TMA tiles where 64 divides bm, a gathered or scaled
  operand made contiguous first by the gather pass; else ``cp.async`` row
  by row with the gather in the kernel; CTA counts at the Mixtral training
  shape; every span's k-steps stay inside the span (with TMA each step is
  64 whole rows of it);
- ``ENTRY_POINTS`` against the C sources' signatures;
- a test-side emulation of the kernel's walk on bf16 operands: every
  expert's span found by a scan of ``tile_groups``, the experts ranked
  heaviest first, each (expert, K tile, N tile) CTA exactly once in the
  kernel's raster order; 64-row k-steps over the span, rows past it zero;
  on the ``cp.async`` route a step skipped when the rows of the gathered
  operand (lhs's, else rhs's) all read one row that is zero in the CTA's
  columns (``padding_tile``'s rule); ``rhs_scale`` multiplying the gathered
  rhs rows in bf16 (in the kernel or the gather pass: the same product);
  fp32 sums per step and one bf16 rounding at the end; zero blocks for
  experts with no row.

The emulation is held against the port's plain ``_tgmm_reference`` and the
JAX package's ``_tgmm_reference`` (jitted: the Pallas ``tgmm`` does not run
in interpret mode on the installed jax, whose ``pltpu.TPUCompilerParams``
is gone) over bm 8/16/24/128/512, empty experts, a cut plan, every
gather/scale form, K 64 and N 192.  Tolerance: bf16, 1e-2 relative plus
1e-2 of the output's largest magnitude (the sums run in other orders
before the one bf16 rounding), as the card tests use; a block the plain
version gives as exact zeros is exact zeros.

The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` kernel_tgmm.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import grouped_matmul as jgm
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import grouped_matmul as gm

torch.set_num_threads(2)

STEP, GROUP_K = 64, 8                   # the kernel's k-step, raster group
_jax_tgmm = jax.jit(jgm._tgmm_reference, static_argnums=3,
                    static_argnames="bm")


def test_route_rule():
    assert gm._route(torch.bfloat16) == "sm90"
    assert gm._route(torch.float32) == "simt"


@pytest.mark.parametrize("bm,lrows,rrows,scale,route,passed", [
    (8, False, False, False, "cp.async", ()),
    (16, True, False, False, "cp.async", ()),
    (24, False, True, True, "cp.async", ()),
    (64, False, False, False, "tma", ()),
    (128, True, False, False, "tma", ("lhs",)),
    (512, False, True, True, "tma", ("rhs",)),
    (512, False, False, True, "tma", ("rhs",)),
    (512, True, True, True, "tma", ("lhs", "rhs")),
])
def test_plan_loads_by_bm_and_form(bm, lrows, rrows, scale, route, passed):
    plan = gm.tgmm_sm90_plan(bm, 256, 512, 4, lhs_rows=lrows,
                             rhs_rows=rrows, rhs_scale=scale)
    assert (plan["lhs"], plan["rhs"]) == (route, route)
    assert plan["gather_pass"] == passed
    assert (plan["tk"], plan["bn"], plan["step"]) == (128, 256, 64)


def test_plan_tiles_and_cta_counts():
    # the Mixtral training shape: dw_gate / dw_up [8, 4096, 14336], dw_down
    # [8, 14336, 4096]
    gate = gm.tgmm_sm90_plan(512, 4096, 14336, 8, lhs_rows=True)
    assert (gate["tk"], gate["bn"], gate["ctas"], gate["gather_pass"]) == \
        (128, 256, 8 * 32 * 56, ("lhs",))
    down = gm.tgmm_sm90_plan(512, 14336, 4096, 8, rhs_rows=True,
                             rhs_scale=True)
    assert (down["tk"], down["bn"], down["ctas"], down["gather_pass"]) == \
        (128, 256, 8 * 112 * 16, ("rhs",))
    # N off 256 takes 128-column tiles, the last one ragged; K 64 is one
    # tile of which the second consumer's half lies past K
    assert gm.tgmm_sm90_plan(8, 64, 192, 8)["bn"] == 128
    assert gm.tgmm_sm90_plan(8, 64, 192, 8)["ctas"] == 8 * 1 * 2


def _first_tiles(tg, E):
    """first_s of the kernel's scan: expert e's tiles are [first[e],
    first[e + 1]) (tile_groups nondecreasing, clamped to [0, E))."""
    T = tg.numel()
    first = [None] * (E + 1)
    g_all = [min(max(int(g), 0), E - 1) for g in tg]
    for t in range(T):
        gp = g_all[t - 1] if t else -1
        for e in range(gp + 1, g_all[t] + 1):
            first[e] = t
        if t == T - 1:
            for e in range(g_all[t] + 1, E + 1):
                first[e] = T
    return first


def _ranked(first, E):
    """The experts by rows, heaviest first, ties by id (the kernel's rank)."""
    size = [first[e + 1] - first[e] for e in range(E)]
    return sorted(range(E), key=lambda e: (-size[e], e))


def _walk(E, K, N, tk, bn):
    """(e_rank, k0, n0) of each CTA in launch order, as the kernel maps
    blockIdx.x."""
    n_kt, n_nt = -(-K // tk), -(-N // bn)
    per_expert, per_group = n_kt * n_nt, GROUP_K * n_nt
    for cta in range(E * per_expert):
        rank, within = divmod(cta, per_expert)
        group = within // per_group
        g_k = min(GROUP_K, n_kt - group * GROUP_K)
        inner = within % per_group
        yield rank, (group * GROUP_K + inner % g_k) * tk, \
            (inner // g_k) * bn


def _steps(r0, r1):
    """Each k-step's rows [m0, m1) of the span [r0, r1)."""
    return [(m0, min(m0 + STEP, r1)) for m0 in range(r0, r1, STEP)]


@pytest.mark.parametrize("bm", [8, 16, 24, 64, 128, 512])
def test_k_steps_never_straddle_a_span(bm):
    rng = np.random.default_rng(bm)
    ids = torch.from_numpy(rng.integers(0, 4, 300))
    inv, _pos, tg = gm.sorted_dispatch_plan(ids, 4, bm)
    first = _first_tiles(tg, 4)
    owner = tg.repeat_interleave(bm)                  # expert of each row
    tma = gm.tgmm_sm90_plan(bm, 128, 128, 4)["lhs"] == "tma"   # bm % 64
    for e in range(4):
        r0, r1 = first[e] * bm, first[e + 1] * bm
        assert bool((owner[r0:r1] == e).all())
        for m0, m1 in _steps(r0, r1):
            assert r0 <= m0 < m1 <= r1
            if tma:                                   # TMA boxes: whole steps
                assert m1 - m0 == STEP and m0 % STEP == 0


def _c_params(source, fn_name):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn_name + r"\(([^)]*)\)", text)
    assert m, f"{fn_name} not in {source}.cu"
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


@pytest.mark.parametrize("source,fn_name", [
    (src, fn) for src, fns in gm.ENTRY_POINTS.items() for fn in fns])
def test_entry_points_match_their_sources(source, fn_name):
    """Every entry point in the table is a C function of its source with as
    many parameters as the table has argument types; the sm90 ones take the
    simt entry points' arguments, by name."""
    assert source in _build.sources()
    params = _c_params(source, fn_name)
    assert len(params) == len(gm.ENTRY_POINTS[source][fn_name])
    if fn_name.endswith("_sm90"):
        base = fn_name[:-len("_sm90")]
        assert gm.ENTRY_POINTS[source][fn_name] == \
            gm.ENTRY_POINTS["grouped_matmul"][base]
        assert params == _c_params("grouped_matmul", base)


def tgmm_sm90_emulation(lhs, rhs, tg, E, *, bm, lhs_rows=None,
                        rhs_rows=None, rhs_scale=None):
    """What ptt_tgmm_sm90 computes, CTA by CTA, on bf16 operands; with the
    number of k-steps it skipped as padding."""
    Ll, K = lhs.shape
    Lr, N = rhs.shape
    plan = gm.tgmm_sm90_plan(bm, K, N, E, lhs_rows=lhs_rows is not None,
                             rhs_rows=rhs_rows is not None,
                             rhs_scale=rhs_scale is not None)
    tk, bn = plan["tk"], plan["bn"]
    first = _first_tiles(tg, E)
    order = _ranked(first, E)
    out = torch.full((E, K, N), float("nan"))
    written = torch.zeros((E, K, N), dtype=torch.int32)
    scale = rhs_scale.to(torch.bfloat16) if rhs_scale is not None else None
    check, on_lhs = (lhs_rows, True) if lhs_rows is not None else \
        (rhs_rows, False)
    skipped = 0
    for rank, k0, n0 in _walk(E, K, N, tk, bn):
        e = order[rank]
        k1, n1 = min(k0 + tk, K), min(n0 + bn, N)
        written[e, k0:k1, n0:n1] += 1
        r0, r1 = first[e] * bm, first[e + 1] * bm
        acc = torch.zeros((tk, bn))
        for m0, m1 in _steps(r0, r1):
            if check is not None and plan["lhs"] == "cp.async":
                v = check[m0:m1].long().clamp(0, (Ll if on_lhs else Lr) - 1)
                cols = lhs[v[0], k0:k1] if on_lhs else rhs[v[0], n0:n1]
                if bool((v == v[0]).all()) and not bool(cols.float().any()):
                    skipped += 1                      # a padding step
                    continue
            # the step's rows, those past the span zero
            a = torch.zeros((STEP, tk), dtype=torch.bfloat16)
            b = torch.zeros((STEP, bn), dtype=torch.bfloat16)
            m = torch.arange(m0, m1)
            lr = lhs_rows[m].long().clamp(0, Ll - 1) if lhs_rows is not None \
                else m
            rr = rhs_rows[m].long().clamp(0, Lr - 1) if rhs_rows is not None \
                else m
            a[:m1 - m0, :k1 - k0] = lhs[lr, k0:k1]
            b[:m1 - m0, :n1 - n0] = rhs[rr, n0:n1]
            if scale is not None:
                b[:m1 - m0] = b[:m1 - m0] * scale[m, None]   # bf16 product
            acc += a.float().T @ b.float()            # fp32 sums of a step
        out[e, k0:k1, n0:n1] = acc[:k1 - k0, :n1 - n0]
    assert bool((written == 1).all()), "every output tile exactly once"
    return out.to(torch.bfloat16), skipped


FORMS = {  # form -> (lhs gathered, rhs gathered, rhs scaled)
    "plain": (False, False, False),
    "lrows": (True, False, False),
    "rrows_scale": (False, True, True),
    "both_scale": (True, True, True),
    "scale": (False, False, True),
}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("bm,counts,cut,K,N", [
    (8, [3, 0, 9, 1, 0, 0, 2, 1], False, 64, 64),    # empty experts, K 64
    (16, [40, 0, 0, 0], False, 128, 192),            # one expert, N 192
    (24, [5, 30, 0, 2], False, 192, 256),            # steps off bm
    (128, [100, 7, 0, 200], False, 256, 512),
    (512, [600, 1, 3, 0], True, 128, 192),           # expert 3 owns no tile
])
def test_sm90_emulation_matches_port_and_jax(form, bm, counts, cut, K, N):
    lf, rf, sf = FORMS[form]
    rng = np.random.default_rng(bm + K + N + len(form))
    E = len(counts)
    ids = np.repeat(np.arange(E), counts)
    rng.shuffle(ids)
    inv, _pos, tg = gm.sorted_dispatch_plan(torch.from_numpy(ids), E, bm)
    if cut:                             # a truncated plan, as the reference's
        keep = int((tg != E - 1).sum())
        inv, tg = inv[:keep * bm], tg[:keep]
    F, M = len(ids), inv.shape[0]
    rows = torch.where(inv < F, inv, torch.full_like(inv, F))

    def operand(width, fused):
        x = torch.from_numpy(rng.standard_normal(
            (F + 1 if fused else M, width)).astype(np.float32))
        if fused:
            x[-1] = 0                   # the zero sentinel row
        return x.to(torch.bfloat16), rows if fused else None

    lhs, lr = operand(K, lf)
    rhs, rr = operand(N, rf)
    s = torch.from_numpy(rng.random(M).astype(np.float32)) if sf else None
    got, skipped = tgmm_sm90_emulation(lhs, rhs, tg, E, bm=bm, lhs_rows=lr,
                                       rhs_rows=rr, rhs_scale=s)
    # every case has an expert whose rows are all padding: on the cp.async
    # route with a gather its steps are skipped; on the TMA route (after
    # the gather pass) and without a gather every row is computed
    assert (skipped > 0) == ((lf or rf) and bm % 64 != 0)
    want = gm._tgmm_reference(lhs, rhs, tg, E, bm=bm, lhs_rows=lr,
                              rhs_rows=rr, rhs_scale=s)
    jwant = _jax_tgmm(
        jnp.asarray(lhs.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(rhs.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(tg.numpy()), E, bm=bm,
        lhs_rows=None if lr is None else jnp.asarray(lr.numpy()),
        rhs_rows=None if rr is None else jnp.asarray(rr.numpy()),
        rhs_scale=None if s is None else jnp.asarray(s.numpy()))
    jwant = torch.from_numpy(np.array(jwant.astype(jnp.float32)))
    for ref in (want.float(), jwant):
        scale = float(ref.abs().max())
        torch.testing.assert_close(got.float(), ref, rtol=1e-2,
                                   atol=1e-2 * scale)
    zero = (want.flatten(1) == 0).all(1)
    assert torch.equal(got[zero], torch.zeros_like(got[zero]))
    if cut:
        assert bool(zero[E - 1])
