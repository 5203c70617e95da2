"""The weight-only matmul's sm90 routes (``paddle_tpu_torch.kernels.
weight_only``, ``csrc/weight_only_sm90.cu``) on the CPU, against the JAX
package's ``weight_only_matmul`` (its Pallas ``_wo_kernel`` in interpret
mode, blocks 8/128/128 as ``tests/test_torch_weight_only.py`` runs it) and
the port's plain version:

- the route rule ``_route(x2, wq, k, n)``: "fma" for fp32 x; "narrow"
  (m <= 64) or "wide" for bf16/fp16 when TMA can map the operands (n % 16,
  k % 8, both pointers 16-byte aligned), else "legacy"; the C entry points
  against ``ENTRY_POINTS``;
- ``wo_plan``: the split and CTA counts at llama2_7b's n 4096 / 11008 /
  32000 and k 4096 / 11008, at m 8 and 512, and the plan's invariants;
- the kernels' dequantization (an int8 byte placed in the mantissa of
  2^23, the offset removed in fp32; an int4 nibble in the mantissa of a
  bf16 128.0 or fp16 1024.0, the offset removed in that dtype) emulated
  bit for bit: every int8 byte and int4 nibble gives its code exactly, and
  in bf16 and fp16;
- a test-side emulation of both walks: narrow (64-column CTAs, steps of
  128 raw rows: 128 k deep, 256 for int4; out^T = deq(W)^T x^T summed by
  two consumers over the two halves of every step and added at the end, the rows past m and k
  past its end zero, split partials in fp32 summed in split order, the
  scale after, one cast)
  and wide (128 x 128 tiles, 64-deep k-steps, the scale on the fp32 sums,
  one cast), held against ``_wo_reference`` and the JAX kernel for int8
  and int4, an odd k, n off a multiple of 64, and m 1 / 7 / 8 / 16 / 100.

Tolerance: bf16 outputs within one bf16 ulp of the largest output (both
sum in fp32 and round once); where the reference cannot tile the shape
(m, n or k off its blocks) it takes its XLA fallback, which scales the
weight before the dot, so those shapes are compared in fp32 within 2e-5 x
|want| + 2e-5 x max |want|, as ``tests/test_torch_weight_only.py`` does.
The kernels themselves are held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py`` kernel_wo.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.weight_only as jwo
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import weight_only as wo

torch.set_num_threads(2)

BLOCKS = dict(block_m=8, block_n=128, block_k=128)   # the JAX tests' tiles


def _cdiv(a, b):
    return -(-a // b)


def test_route_rule():
    bf = torch.bfloat16
    q = torch.zeros((256, 128), dtype=torch.int8)
    x = torch.zeros((8, 256), dtype=bf)
    assert wo._route(x, q, 256, 128) == "narrow"
    assert wo._route(torch.zeros((64, 256), dtype=bf), q, 256, 128) == \
        "narrow"
    assert wo._route(torch.zeros((65, 256), dtype=bf), q, 256, 128) == "wide"
    assert wo._route(x.half(), q, 256, 128) == "narrow"
    assert wo._route(x.float(), q, 256, 128) == "fma"
    assert wo._route(torch.zeros((512, 256)), q, 256, 128) == "fma"
    # shapes TMA cannot map: an int8 row of n bytes off 16, x rows off 16
    assert wo._route(x, torch.zeros((256, 200), dtype=torch.int8), 256,
                     200) == "legacy"
    assert wo._route(torch.zeros((8, 4095), dtype=bf),
                     torch.zeros((2048, 128), dtype=torch.int8), 4095,
                     128) == "legacy"
    # the same shapes one element into their buffers
    xb = torch.zeros((8 * 256 + 1,), dtype=bf)
    assert wo._route(xb[1:].view(8, 256), q, 256, 128) == "legacy"
    qb = torch.zeros((256 * 128 + 16,), dtype=torch.int8)
    assert wo._route(x, qb[16:].view(256, 128), 256, 128) == "narrow"
    assert wo._route(x, qb[8:-8].view(256, 128), 256, 128) == "legacy"
    assert wo.NARROW_MAX_M == 64


def _c_params(source, fn_name):
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn_name + r"\(([^)]*)\)", text)
    assert m, f"{fn_name} not in {source}.cu"
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


@pytest.mark.parametrize("source,fn_name", [
    (src, fn) for src, fns in wo.ENTRY_POINTS.items() for fn in fns])
def test_entry_points_match_their_sources(source, fn_name):
    assert source in _build.sources()
    params = _c_params(source, fn_name)
    assert len(params) == len(wo.ENTRY_POINTS[source][fn_name])
    if fn_name == "ptt_weight_only_sm90":
        assert params == ["x", "w", "scale", "out", "ws", "m", "k", "n",
                          "int4", "x_dtype", "out_dtype", "tm", "splits",
                          "steps_per_split", "stream"]


# llama2_7b's projections: (k, n) -> (splits, steps a split, CTAs) at m 8
# for int8 and int4 (whose narrow steps are 256 deep), and the wide form's
# CTAs at m 512
LLAMA_PLANS = {(4096, 4096): ((5, 7, 320), (4, 4, 256), 128),    # q, k, v, o
               (4096, 11008): ((1, 32, 172), (1, 16, 172), 344),  # gate, up
               (11008, 4096): ((5, 18, 320), (5, 9, 320), 128),   # down
               (4096, 32000): ((1, 32, 500), (1, 16, 500), 1000)}  # LM head


@pytest.mark.parametrize("k,n", list(LLAMA_PLANS))
@pytest.mark.parametrize("int4", [False, True])
def test_plan_at_llama_widths(k, n, int4):
    *narrow, wide_ctas = LLAMA_PLANS[(k, n)]
    splits, sps, ctas = narrow[int4]
    p = wo.wo_plan(8, k, n, int4)
    assert (p["form"], p["tm"], p["k_step"]) == ("narrow", 8,
                                                  256 if int4 else 128)
    assert (p["splits"], p["steps_per_split"], p["ctas"]) == (splits, sps,
                                                               ctas)
    assert p["stages"] == (6 if int4 else 9)
    p = wo.wo_plan(512, k, n, int4)
    assert (p["form"], p["tm"], p["splits"], p["k_step"]) == ("wide", 0, 1,
                                                              64)
    assert p["ctas"] == wide_ctas


@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 32, 33, 64, 65, 100])
@pytest.mark.parametrize("k,n", [(64, 64), (200, 176), (1024, 128),
                                 (4096, 4096), (11008, 4096),
                                 (4096, 11008)])
def test_plan_invariants(m, k, n):
    p = wo.wo_plan(m, k, n)
    if m > wo.NARROW_MAX_M:
        assert p["form"] == "wide" and p["ctas"] == \
            _cdiv(m, 128) * _cdiv(n, 128)
        return
    # a narrow CTA's shared memory (its ring, the consumers' tiles) leaves
    # room for a second CTA on an SM, but for int4 at 64 rows
    for int4 in (False, True):
        q = wo.wo_plan(m, k, n, int4)
        stage = q["k_step"] // 64 * q["tm"] * 128 + 128 * 64
        total = q["stages"] * stage + q["k_step"] * 128 + 16 * q["stages"] + \
            1024
        assert 2 <= q["stages"] <= 10
        assert 2 * (total + 1024) <= 228 * 1024 or (int4 and q["tm"] == 64)
    nk, tiles = _cdiv(k, 128), _cdiv(n, 64)
    assert p["tm"] >= m and p["tm"] in (8, 16, 32, 64) and p["tm"] < 2 * m + 8
    # every step in exactly one split, none empty
    assert (p["splits"] - 1) * p["steps_per_split"] < nk <= \
        p["splits"] * p["steps_per_split"]
    assert p["ctas"] == tiles * p["splits"]
    if tiles >= 132:
        assert p["splits"] == 1
    else:
        assert p["ctas"] <= 2 * 132 + tiles
    assert p["splits"] == 1 or p["steps_per_split"] >= 4


def dequant(q, int4, dtype=torch.bfloat16):
    """The kernels' dequantization of the raw codes, emulated bit for bit
    and returned in fp32.  int8: a byte xor 0x80 is the code plus 128;
    placed in the mantissa of 2^23 it is 2^23 + code + 128 exactly, and one
    fp32 subtraction of 2^23 + 128 leaves the code.  int4: a nibble xor 8 is
    the code plus 8; in the mantissa of 128.0 (bf16 0x4300) or 1024.0 (fp16
    0x6400) it is 128 + u or 1024 + u exactly, and one subtraction of 136 or
    1032 in that dtype leaves the code; 2 ceil(k/2) rows, the low nibble the
    even one."""
    b = q.numpy().view(np.uint8)
    if int4:
        u = np.stack([(b & 0x0F) ^ 0x08, ((b >> 4) & 0x0F) ^ 0x08],
                     axis=1).reshape(-1, b.shape[1]).astype(np.uint16)
        if dtype == torch.bfloat16:
            v = torch.from_numpy((u | 0x4300).view(np.int16)).view(dtype)
            return (v - torch.tensor(136.0, dtype=dtype)).float()
        v = torch.from_numpy((u | 0x6400).view(np.int16)).view(dtype)
        return (v - torch.tensor(1032.0, dtype=dtype)).float()
    u = (b ^ 0x80).astype(np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32)
    return torch.from_numpy(f - np.float32(8388608 + 128))


def test_dequant_gives_every_code_exactly():
    every = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    assert torch.equal(dequant(every, False), every.float())
    pairs = torch.tensor([[lo, hi] for lo in range(-8, 8)
                          for hi in range(-8, 8)], dtype=torch.int8)
    packed = tq._pack_int4(pairs.T.contiguous())     # [1, 256]
    for dt in (torch.bfloat16, torch.float16):
        assert torch.equal(dequant(packed, True, dt), pairs.T.float())
    for dt in (torch.bfloat16, torch.float16):
        assert torch.equal(every.float().to(dt).float(), every.float())


def wo_sm90_emulation(x, q, scale, int4, k, out_dtype):
    """What ptt_weight_only_sm90 computes, CTA by CTA, on the plan's form."""
    m, n = x.shape[0], q.shape[1]
    plan = wo.wo_plan(m, k, n, int4)
    deq = dequant(q, int4, x.dtype).to(x.dtype)   # exact in bf16 / fp16
    out = torch.empty((m, n), dtype=out_dtype)
    if plan["form"] == "narrow":
        tm, step, sps = plan["tm"], plan["k_step"], plan["steps_per_split"]
        kp = _cdiv(k, step) * step
        xt = torch.zeros((tm, kp), dtype=x.dtype)   # rows past m, k past k: 0
        xt[:m, :k] = x
        for n0 in range(0, n, 64):
            a = torch.zeros((kp, 64), dtype=x.dtype)  # codes past the rows: 0
            cols = min(64, n - n0)
            a[:deq.shape[0], :cols] = deq[:, n0:n0 + cols]
            parts = []
            for s in range(plan["splits"]):
                # out^T; consumer 0 sums the first half of every step,
                # consumer 1 the second, and its sums are added last
                acc = [torch.zeros((64, tm)), torch.zeros((64, tm))]
                half = step // 2
                for k0 in range(s * sps * step, min(kp, (s + 1) * sps * step),
                                step):
                    for h in (0, 1):
                        k1 = k0 + half * h
                        acc[h] += a[k1:k1 + half].float().T @ \
                            xt[:, k1:k1 + half].float().T
                parts.append(acc[0] + acc[1])
            tot = parts[0]
            for p in parts[1:]:                      # split order
                tot = tot + p
            y = tot.T[:m, :cols] * scale[n0:n0 + cols].float()
            out[:, n0:n0 + cols] = y.to(out_dtype)
        return out
    step = plan["k_step"]
    kp = _cdiv(k, step) * step
    for m0 in range(0, m, 128):
        for n0 in range(0, n, 128):
            rows, cols = min(128, m - m0), min(128, n - n0)
            a = torch.zeros((128, kp), dtype=x.dtype)
            a[:rows, :k] = x[m0:m0 + 128]
            b = torch.zeros((kp, 128), dtype=x.dtype)
            b[:deq.shape[0], :cols] = deq[:, n0:n0 + cols]
            acc = torch.zeros((128, 128))
            for k0 in range(0, kp, step):
                acc += a[:, k0:k0 + step].float() @ b[k0:k0 + step].float()
            y = acc[:rows, :cols] * scale[n0:n0 + cols].float()
            out[m0:m0 + rows, n0:n0 + cols] = y.to(out_dtype)
    return out


def _case(seed, m, k, n, int4, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 1] = 0
    q, s = tq.weight_quantize(torch.from_numpy(w), algo="weight_only_int4"
                              if int4 else "weight_only_int8")
    x = rng.standard_normal((m, k)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), q, s


def _jax(x, q, s, int4, k, out_dtype):
    want = jwo.weight_only_matmul(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
        int4_rows=k if int4 else None, out_dtype=out_dtype, interpret=True,
        **BLOCKS)
    return torch.from_numpy(np.array(want.astype(jnp.float32)))


def _ulp_close(got, want):
    g, w = got.float(), want.float()
    big = float(w.abs().max())
    ulp = 2.0 ** (np.floor(np.log2(big)) - 7) if big else 0.0
    assert float((g - w).abs().max()) <= ulp


def _f32_close(got, want):
    big = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5 * big)


# shapes the JAX kernel tiles with blocks 8/128/128: bf16 out, one ulp
@pytest.mark.parametrize("m,k,n", [(8, 256, 128), (16, 256, 256),
                                   (8, 2048, 128), (104, 256, 128)])
@pytest.mark.parametrize("int4", [False, True])
def test_emulation_matches_plain_and_interpreted_kernel(m, k, n, int4):
    x, q, s = _case(m + k + n, m, k, n, int4)
    assert wo._route(x, q, k, n) == ("narrow" if m <= 64 else "wide")
    got = wo_sm90_emulation(x, q, s, int4, k, torch.bfloat16)
    plain = wo._wo_reference(x, q, s, int4, k, torch.bfloat16)
    _ulp_close(got, plain)
    _ulp_close(got, _jax(x, q, s, int4, k, jnp.bfloat16))
    assert not got[:, 1].any()                   # the zero column
    if k == 2048:                                # split-K
        assert wo.wo_plan(m, k, n, int4)["splits"] == (2 if int4 else 4)


# shapes off the JAX kernel's blocks (its XLA fallback): fp32 out
@pytest.mark.parametrize("m", [1, 7, 8, 16, 100])
@pytest.mark.parametrize("k,n", [(200, 176), (201, 176)])
@pytest.mark.parametrize("int4", [False, True])
def test_emulation_on_ragged_shapes(m, k, n, int4):
    """n 176 is off a multiple of 64 (a ragged column tile), k 200 off the
    k-steps; an odd k (201, whose int4 padding nibble must add nothing)
    takes the "legacy" route on the card, and the walk's arithmetic still
    holds there."""
    x, q, s = _case(m * 7 + k + int4, m, k, n, int4)
    got = wo_sm90_emulation(x, q, s, int4, k, torch.float32)
    _f32_close(got, wo._wo_reference(x, q, s, int4, k, torch.float32))
    _f32_close(got, _jax(x, q, s, int4, k, jnp.float32))
    gb = wo_sm90_emulation(x, q, s, int4, k, torch.bfloat16)
    _ulp_close(gb, wo._wo_reference(x, q, s, int4, k, torch.bfloat16))
    assert not got[:, 1].any()


def test_emulation_in_fp16():
    x, q, s = _case(3, 16, 256, 128, False, torch.float16)
    assert wo._route(x, q, 256, 128) == "narrow"
    got = wo_sm90_emulation(x, q, s, False, 256, torch.float16)
    want = wo._wo_reference(x, q, s, False, 256, torch.float16)
    big = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= \
        2.0 ** (np.floor(np.log2(big)) - 10)
