"""The grouped matmul's sm90 route (bf16 gmm on wgmma) on the CPU.

The CUDA kernel cannot run here; what surrounds it can.  This file holds

- the route rule: bf16 takes "sm90", fp32 "simt" (fp32 must match fp32
  references to 1e-5, where wgmma would need TF32);
- the tile plan, ``sm90_plan``: the wide form (128-row tiles) where 128
  divides bm, else the narrow form (64 output columns x ``row_tile(bm)``
  rows); no tile straddles two experts; the CTA counts at the Mixtral
  decode and training shapes;
- a test-side emulation of the kernel's arithmetic on bf16 operands: the
  CTAs of the plan in the kernel's walk order (the wide form's raster
  groups of 16 row tiles, the narrow form's row tiles fastest), each
  output tile written by exactly one CTA; a tile whose gathered rows all
  read one all-zero row writes zeros; otherwise the row scale multiplies
  the gathered rows in bf16, the product runs over k-steps of 64 in fp32
  (the narrow form as out^T = W^T rows^T), and the result is rounded to
  bf16 once.

The emulation is held against the port's plain ``_gmm_reference`` and the
JAX package's ``_gmm_reference`` (jitted) in every form: forward and
``trans_rhs``, with and without the fused gather and the row scale, at bm
8/16/24/64/128/512 with a K tail (C % 64 == 32) and, in the wide form, an N
tail (O % 128 == 64).  Tolerance: bf16, 1e-2 relative plus 1e-2 of the
output's largest magnitude (the sums run in other orders before the one
bf16 rounding), as the card tests use; sentinel rows exactly 0.

The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import grouped_matmul as jgm
from paddle_tpu_torch.kernels import grouped_matmul as gm

torch.set_num_threads(2)

GROUP_ROWS = 16                     # the wide form's raster group
_jax_gmm = jax.jit(jgm._gmm_reference,
                   static_argnames=("bm", "trans_rhs"))


def test_route_rule():
    assert gm._route(torch.bfloat16) == "sm90"
    assert gm._route(torch.float32) == "simt"


@pytest.mark.parametrize("bm,form,tm", [
    (8, "narrow", 8), (16, "narrow", 16), (24, "narrow", 8),
    (64, "narrow", 64), (128, "wide", 128), (512, "wide", 128)])
def test_plan_forms_never_straddle_two_experts(bm, form, tm):
    plan = gm.sm90_plan(bm, 4 * bm, 256)
    assert (plan["form"], plan["tm"]) == (form, tm)
    assert bm % plan["tm"] == 0
    # on a real dispatch plan every tile's rows belong to one expert
    ids = torch.from_numpy(np.random.default_rng(bm).integers(0, 4, 50))
    inv, _pos, tg = gm.sorted_dispatch_plan(ids, 4, bm)
    owner = tg.repeat_interleave(bm)                  # expert of each row
    tiles = owner.reshape(-1, plan["tm"])
    assert bool((tiles == tiles[:, :1]).all())


def test_cta_counts_at_the_mixtral_shapes():
    # decode gate/up: B 8 x top-2 = 16 entries, bm 16, M 16 + 8 x 16 = 144
    assert gm.sm90_plan(16, 144, 14336) == {
        "form": "narrow", "tm": 16, "bn": 64, "ctas": 9 * 224}
    # the training shape: M 20480 (16384 live), bm 512
    assert gm.sm90_plan(512, 20480, 14336) == {
        "form": "wide", "tm": 128, "bn": 256, "ctas": 160 * 56}
    assert gm.sm90_plan(512, 20480, 4096)["ctas"] == 160 * 16
    # an O that 256 does not divide takes 128-column tiles, the last ragged
    assert gm.sm90_plan(128, 256, 192)["bn"] == 128
    assert gm.sm90_plan(128, 256, 192)["ctas"] == 2 * 2


def _walk(plan, M, O):
    """(m0, n0) of each CTA in launch order, as the kernel maps blockIdx."""
    tm, bn = plan["tm"], plan["bn"]
    n_mt, n_nt = M // tm, -(-O // bn)
    for cta in range(plan["ctas"]):
        if plan["form"] == "narrow":
            yield (cta % n_mt) * tm, (cta // n_mt) * bn
            continue
        per_group = GROUP_ROWS * n_nt
        first = cta // per_group * GROUP_ROWS
        rows = min(GROUP_ROWS, n_mt - first)
        inner = cta % per_group
        yield (first + inner % rows) * tm, (inner // rows) * bn


def sm90_emulation(lhs, rhs, tg, *, bm, rows=None, trans_rhs=False,
                   row_scale=None):
    """What ptt_gmm_sm90 computes, CTA by CTA, on bf16 operands."""
    L, C = lhs.shape
    E = rhs.shape[0]
    O = rhs.shape[1] if trans_rhs else rhs.shape[2]
    M = rows.shape[0] if rows is not None else L
    plan = gm.sm90_plan(bm, M, O)
    out = torch.full((M, O), float("nan"))
    written = torch.zeros((M, O), dtype=torch.int32)
    src = rows.long().clamp(0, L - 1) if rows is not None else \
        torch.arange(M)
    scale = row_scale.to(torch.bfloat16) if row_scale is not None else None
    for m0, n0 in _walk(plan, M, O):
        r = slice(m0, m0 + plan["tm"])
        n1 = min(n0 + plan["bn"], O)
        written[r, n0:n1] += 1
        s = src[r]
        if rows is not None and bool((s == s[0]).all()) and \
                not bool(lhs[s[0]].float().any()):
            out[r, n0:n1] = 0.0                       # a padding tile
            continue
        a = lhs[s]
        if scale is not None:
            a = a * scale[r, None]                    # bf16 x bf16 -> bf16
        e = int(tg[m0 // bm].clamp(0, E - 1))
        w = rhs[e].transpose(0, 1) if trans_rhs else rhs[e]   # [C, O]
        w = w[:, n0:n1].float()
        acc = torch.zeros((plan["tm"], n1 - n0))
        for k0 in range(0, C, 64):                    # k-steps of 64
            ak, wk = a[:, k0:k0 + 64].float(), w[k0:k0 + 64]
            acc += (wk.T @ ak.T).T if plan["form"] == "narrow" else ak @ wk
        out[r, n0:n1] = acc
    assert bool((written == 1).all()), "every output tile exactly once"
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("bm,counts,fused,scaled,C,O", [
    (8, [3, 0, 9, 1], True, True, 96, 128),
    (16, [16, 0, 0, 0], False, False, 96, 128),
    (24, [5, 30, 0, 2], True, False, 160, 192),
    (64, [70, 0, 5, 64], True, True, 128, 64),
    (128, [100, 7, 0, 200], True, True, 96, 128),
    (128, [0, 300, 2, 0], False, True, 96, 192),
    (512, [600, 1, 3, 0], False, False, 96, 512),
])
def test_sm90_emulation_matches_port_and_jax(trans, bm, counts, fused,
                                             scaled, C, O):
    rng = np.random.default_rng(bm + C + O)
    ids = np.repeat(np.arange(4), counts)
    rng.shuffle(ids)
    inv, _pos, tg = gm.sorted_dispatch_plan(torch.from_numpy(ids), 4, bm)
    F, M = len(ids), inv.shape[0]
    shape = (4, O, C) if trans else (4, C, O)
    rhs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) /
                           np.sqrt(C)).to(torch.bfloat16)
    lhs = torch.from_numpy(rng.standard_normal(
        (F + 1 if fused else M, C)).astype(np.float32)).to(torch.bfloat16)
    rows = None
    if fused:
        lhs[-1] = 0
        rows = torch.where(inv < F, inv, torch.full_like(inv, F))
    s = torch.from_numpy(rng.random(M).astype(np.float32)) if scaled else None
    got = sm90_emulation(lhs, rhs, tg, bm=bm, rows=rows, trans_rhs=trans,
                         row_scale=s)
    want = gm._gmm_reference(lhs, rhs, tg, bm=bm, rows=rows,
                             trans_rhs=trans, row_scale=s)
    jwant = _jax_gmm(
        jnp.asarray(lhs.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(rhs.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(tg.numpy()), bm=bm, trans_rhs=trans,
        rows=None if rows is None else jnp.asarray(rows.numpy()),
        row_scale=None if s is None else jnp.asarray(s.numpy()))
    jwant = torch.from_numpy(np.array(jwant.astype(jnp.float32)))
    for ref in (want.float(), jwant):
        scale = float(ref.abs().max())
        torch.testing.assert_close(got.float(), ref, rtol=1e-2,
                                   atol=1e-2 * scale)
    if rows is not None:
        pad = rows == F
        assert pad.any()
        assert torch.equal(got[pad], torch.zeros_like(got[pad]))
