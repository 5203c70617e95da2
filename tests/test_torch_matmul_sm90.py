"""The primitive library's matmul on its "sm90" route
(``paddle_tpu_torch.kernels.primitives``, ``csrc/primitives.cu`` with
``csrc/wide_sm90.cuh``) on the CPU, against the JAX package's
``matmul_kernel`` in interpret mode and the port's plain version:

- the route rule ``_matmul_route(x, w)``: "fma" for fp32; "sm90" for bf16
  and fp16 with K > 0, K and N multiples of 8 and both operands 16-byte
  aligned; "mma" for every other bf16/fp16 case (an offset view of the
  same shape included); the C entry point's parameters;
- a test-side emulation of the kernel's walk: CTAs in the grouped raster
  order (each 128 x BN tile once, BN 256 for N > 128, else 128), 64-deep
  k-steps with the tail zero-filled (TMA's out-of-bounds fill), fp32 sums,
  the epilogue on each fp32 sum, one cast, stores masked to [M, N];
- the emulation held against ``_matmul_reference`` and against the JAX
  ``matmul_kernel(..., interpret=True)`` at small ragged shapes, with and
  without an epilogue, bf16 and fp16 in, the output in x's dtype or fp32.

Tolerance (``tests/test_torch_primitives.py``'s): fp32 outputs within 1e-5
x |want| + 1e-5 x max |want| (exact products, fp32 sums in other orders);
a bf16/fp16 output also within one ulp of each element (2^-7 / 2^-10 x
|want|).  The kernel itself is held against its plain version on the card
by ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``
kernel_primitives.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import primitives as jp
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import primitives as tp

torch.set_num_threads(2)

ROWS, STEP, GROUP = 128, 64, 16          # the kernel's tile rows, k-step, raster group
RELU2 = tp.KernelFn(lambda a: torch.clamp_min(a, 0) * 2.0,
                    "return fmaxf(a, 0.0f) * 2.0f;")
DT = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
      "float16": (torch.float16, jnp.float16),
      "float32": (torch.float32, jnp.float32)}


def _cdiv(a, b):
    return -(-a // b)


def test_route_rule():
    bf, f16 = torch.bfloat16, torch.float16
    x, w = torch.zeros((100, 72), dtype=bf), torch.zeros((72, 56), dtype=bf)
    assert tp._matmul_route(x, w) == "sm90"
    assert tp._matmul_route(x.half(), w.half()) == "sm90"
    assert tp._matmul_route(x.float(), w.float()) == "fma"
    # K or N off a multiple of 8: TMA's 16-byte row strides
    assert tp._matmul_route(torch.zeros((4, 70), dtype=bf),
                            torch.zeros((70, 56), dtype=bf)) == "mma"
    assert tp._matmul_route(x, torch.zeros((72, 50), dtype=f16)) == "mma"
    # K = 0 (the sum is 0) stays on "mma"
    assert tp._matmul_route(torch.zeros((4, 0), dtype=bf),
                            torch.zeros((0, 8), dtype=bf)) == "mma"
    # the same shape one element into its buffer: off the alignment
    buf = torch.zeros((100 * 72 + 1,), dtype=bf)
    xo = buf[1:].view(100, 72)
    assert xo.is_contiguous() and tp._matmul_route(xo, w) == "mma"
    wbuf = torch.zeros((72 * 56 + 8,), dtype=f16)
    assert tp._matmul_route(x.half(), wbuf[8:].view(72, 56)) == "sm90"
    assert tp._matmul_route(x.half(), wbuf[4:-4].view(72, 56)) == "mma"


def test_entry_point_takes_the_route():
    text = (_build.CSRC / "primitives.cu").read_text()
    m = re.search(r'extern "C" int ptt_matmul\(([^)]*)\)', text)
    params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert params == ["x", "w", "out", "m", "k", "n", "code", "out_code",
                      "route", "stream"]
    assert tp._MATMUL_ROUTE_CODE == {"fma": 0, "mma": 1, "sm90": 2}
    h = tp.generated_header("matmul", RELU2)
    assert "#define PTT_MATMUL 1" in h and RELU2.cuda in h


def tile_origins(M, N, bn):
    """The CTAs' tile origins in launch order (wide_sm90.cuh: tile_origin):
    groups of GROUP row tiles, the column tiles of a group outer."""
    n_mt, n_nt = _cdiv(M, ROWS), _cdiv(N, bn)
    out = []
    for bid in range(n_mt * n_nt):
        group = bid // (GROUP * n_nt)
        first = group * GROUP
        g_rows = min(GROUP, n_mt - first)
        i = bid % (GROUP * n_nt)
        out.append(((first + i % g_rows) * ROWS, (i // g_rows) * bn))
    return out


@pytest.mark.parametrize("M,N", [(1, 8), (100, 56), (130, 264), (8192, 11008),
                                 (8192, 4096), (8192, 32000), (2100, 300)])
def test_raster_covers_every_tile_once(M, N):
    bn = 256 if N > 128 else 128
    origins = tile_origins(M, N, bn)
    want = {(m, n) for m in range(0, M, ROWS) for n in range(0, N, bn)}
    assert len(origins) == len(want) and set(origins) == want
    # the CTAs of one raster group share their rows and walk all columns
    n_nt = _cdiv(N, bn)
    first = origins[:min(GROUP, _cdiv(M, ROWS)) * n_nt]
    assert {m for m, _ in first} == {m for m in range(0, min(M, GROUP * ROWS),
                                                      ROWS)}


def sm90_emulation(epilogue, x, w, out_dtype):
    """What ptt_matmul computes on its "sm90" route, CTA by CTA."""
    M, K = x.shape
    N = w.shape[1]
    bn = 256 if N > 128 else 128
    kp = _cdiv(K, STEP) * STEP
    out = torch.empty((M, N), dtype=out_dtype)
    for m0, n0 in tile_origins(M, N, bn):
        a = torch.zeros((ROWS, kp), dtype=x.dtype)           # TMA's zero fill
        b = torch.zeros((kp, bn), dtype=w.dtype)
        a[:min(ROWS, M - m0), :K] = x[m0:m0 + ROWS]
        b[:K, :min(bn, N - n0)] = w[:, n0:n0 + bn]
        acc = torch.zeros((ROWS, bn), dtype=torch.float32)
        for k0 in range(0, kp, STEP):
            acc += a[:, k0:k0 + STEP].float() @ b[k0:k0 + STEP].float()
        tile = epilogue.torch(acc).to(out_dtype)
        out[m0:m0 + ROWS, n0:n0 + bn] = tile[:min(ROWS, M - m0),
                                             :min(bn, N - n0)]
    return out


def _close(got, want):
    """Within 1e-5 x |want| + 1e-5 x max |want|, plus one ulp of a 16-bit
    output."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float().numpy(), want.float().numpy()
    tol = 1e-5 * np.abs(w) + 1e-5 * float(np.abs(w).max())
    if got.dtype != torch.float32:
        tol = tol + torch.finfo(got.dtype).eps * np.abs(w)
    assert np.all(np.abs(g - w) <= tol), float(np.abs(g - w).max())


def _inputs(seed, M, K, N, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    td, jd = DT[dtype]
    return (torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
            jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd))


@functools.lru_cache(maxsize=None)
def _jax_f32(M, K, N, blk, dtype, relu2):
    """The JAX ``matmul_kernel`` in interpret mode, fp32 output, on
    ``_inputs``' operands (one interpreted call per operand set)."""
    _, _, jx, jw = _inputs(M + K + N, M, K, N, dtype)
    want = jp.matmul_kernel(block_m=blk, block_n=blk, block_k=blk,
                            epilogue=(lambda a: jax.nn.relu(a) * 2.0)
                            if relu2 else None,
                            out_dtype=jnp.float32, interpret=True)(jx, jw)
    out = np.array(want)
    out.flags.writeable = False
    return out


@pytest.mark.parametrize("M,K,N,blk", [(16, 24, 8, 8), (100, 72, 56, 32),
                                       (130, 200, 264, 64)])
@pytest.mark.parametrize("dtype,out", [("bfloat16", "bfloat16"),
                                       ("bfloat16", "float32"),
                                       ("float16", "float16")])
@pytest.mark.parametrize("relu2", [False, True])
def test_emulation_matches_plain_and_jax(M, K, N, blk, dtype, out, relu2):
    tx, tw, _, _ = _inputs(M + K + N, M, K, N, dtype)
    assert tp._matmul_route(tx, tw) == "sm90"
    tout = DT[out][0]
    epi = RELU2 if relu2 else tp._IDENTITY
    got = sm90_emulation(epi, tx, tw, tout)
    _close(got, tp._matmul_reference(epi, tx, tw, tout))
    # the CPU wrapper is the plain version, bit for bit
    assert torch.equal(tp.matmul_kernel(epilogue=epi if relu2 else None,
                                        out_dtype=tout)(tx, tw),
                       tp._matmul_reference(epi, tx, tw, tout))
    # the reference's fp32 output cast once to the output dtype is its
    # output in that dtype (the kernel rounds its fp32 result once)
    want = _jax_f32(M, K, N, blk, dtype, relu2)
    _close(got, torch.tensor(want).to(tout))


def test_emulation_zero_fills_every_ragged_edge():
    """Rows, columns and k past the operands read as zeros: at a shape off
    every tile (M 70, K 136, N 200) the walk's sums are finite and equal
    the plain version's."""
    tx, tw, _, _ = _inputs(5, 70, 136, 200, "bfloat16")
    got = sm90_emulation(tp._IDENTITY, tx, tw, torch.float32)
    assert bool(torch.isfinite(got).all())
    _close(got, tp._matmul_reference(tp._IDENTITY, tx, tw, torch.float32))
