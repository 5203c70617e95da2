"""Weight-only quantized matmul, W8A16 / W4A16 (port of
``paddle_tpu/kernels/weight_only.py``).

``weight_only_matmul(x, wq, scale)`` computes ``x @ dequant(wq)`` with the
weight kept int8 in device memory: int8 ``[k, n]``, or int4 packed
``[ceil(k/2), n]`` (low nibble = even row, :func:`_pack_int4`), and a
per-output-channel fp32 ``scale [n]`` applied once after the fp32 sum (the
reference kernel's ``_finalize``).

- On a CUDA tensor it launches a hand-written Hopper kernel, which replaces
  the Pallas ``_wo_kernel`` (``paddle_tpu/kernels/weight_only.py:28``) for
  every shape, the ones the reference sends to its XLA fallback included.
  Each launch adds one to :data:`LAUNCHES` (int8) or :data:`LAUNCHES_INT4`,
  and one to the counter of its route.  Inputs the kernels do not take (a
  non-contiguous operand, another dtype) raise.
- On a CPU tensor it runs the plain version :func:`_wo_reference`, which
  follows the kernels' math: ``x.float() @ q.float()``, then ``* scale`` in
  fp32, then the cast.  Any other device raises.

**Routes** (:func:`_route`, which reads dtype, shape and alignment only;
each route has its counter):

- ``"narrow"`` (:data:`LAUNCHES_NARROW`): bf16/fp16 x with m <= 64
  (:data:`NARROW_MAX_M`) and a shape TMA can map: ``n % 16 == 0`` (a weight
  row of n bytes), ``k % 8 == 0`` (an x row of 16-byte multiples), x and
  wq 16-byte aligned.  ``csrc/weight_only_sm90.cu``'s decode form: the
  operands swapped on wgmma, the raw codes streamed by TMA and dequantized
  in shared memory, split-K where the column tiles do not fill the card
  (:func:`wo_plan`).
- ``"wide"`` (:data:`LAUNCHES_WIDE`): the same with m > 64: the primitive
  matmul's wgmma tile body with its B operand dequantized on the way in.
- ``"fma"`` (:data:`LAUNCHES_FMA`): fp32 x, ``csrc/weight_only.cu``'s FMA
  kernel (not TF32, which would round x).
- ``"legacy"`` (:data:`LAUNCHES_LEGACY`): bf16/fp16 shapes TMA cannot map
  (n % 16, k % 8, an unaligned pointer), ``csrc/weight_only.cu``'s WMMA
  kernel.

What bounds the kernels on the H100: at decode, bytes (the weight read
once: 45.1 MB int8 / 22.5 MB int4 for llama2_7b's gate/up, 0.0135 / 0.0068
ms at 3.35 TB/s); in a 512-row prefill chunk, operations (0.047 ms at 989
TFLOP/s).  The designs are described in the sources.

The reference's ``block_m``/``block_n``/``block_k``/``interpret`` are the
TPU's tile knobs and are not ported: the CUDA kernels pick their own tiles.

The gradient (:class:`_WeightOnlyMatmul`) is the reference's ``_wo_core_bwd``
in plain PyTorch on both devices: ``dx = ((g * scale) @ q.T)`` in fp32,
cast to x's dtype.  ``wq`` and ``scale`` get no gradient (the reference
returns zero cotangents for this frozen inference state).
"""

from __future__ import annotations

import ctypes
import math

import torch

# Launches of the CUDA kernels since import (or the last reset by a caller).
LAUNCHES = 0          # int8 weights
LAUNCHES_INT4 = 0     # int4 packed weights
# the same launches by route (_route)
LAUNCHES_NARROW = 0
LAUNCHES_WIDE = 0
LAUNCHES_FMA = 0
LAUNCHES_LEGACY = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the largest m on the "narrow" route (decode); above it "wide" (prefill)
NARROW_MAX_M = 64
_SMS = 132                      # the H100's SMs: the narrow plan fills them
_NARROW_COLS = 64               # output columns of a narrow CTA
_NARROW_RAW = 128               # raw rows of a narrow step: int8 k, int4 packed
_NARROW_BUDGET = 110 * 1024     # a narrow CTA's ring and tiles: two an SM
_WIDE_ROWS, _WIDE_COLS, _WIDE_K = 128, 128, 64

# C entry points and their ctypes argument types, by source
ENTRY_POINTS = {
    # (x, wq, scale, out, m, k, n, int4, x_dtype, out_dtype, stream)
    "weight_only": {"ptt_weight_only": [ctypes.c_void_p] * 4 +
                    [ctypes.c_int] * 6 + [ctypes.c_void_p]},
    # (x, wq, scale, out, ws, m, k, n, int4, x_dtype, out_dtype, tm,
    #  splits, steps_per_split, stream)
    "weight_only_sm90": {"ptt_weight_only_sm90": [ctypes.c_void_p] * 5 +
                         [ctypes.c_int] * 9 + [ctypes.c_void_p]},
}


def _pack_int4(q):
    """[in, out] int8 in [-8, 7] -> [ceil(in/2), out] int8, two nibbles per
    byte (low nibble = even row, high nibble = odd row); an odd row count
    is padded with a zero row."""
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros((1,) + tuple(q.shape[1:]))])
    lo = q[0::2] & 0x0F
    hi = q[1::2] << 4                 # int8: wraps as jnp.left_shift does
    return (lo | hi).to(torch.int8)


def _unpack_int4(p, rows):
    """[in/2, out] packed -> [rows, out] int8, sign-extended: ``(p << 4) >>
    4`` is the low nibble, ``p >> 4`` the high one (arithmetic shifts)."""
    lo = (p << 4) >> 4
    hi = p >> 4
    full = torch.stack([lo, hi], dim=1).reshape((-1,) + tuple(p.shape[1:]))
    return full[:rows]


def _unpack(wq, int4, k):
    return _unpack_int4(wq, k) if int4 else wq


def _wo_reference(x2, wq, scale, int4, k, out_dtype):
    """Plain version, the kernel's math: fp32 dot of x with the integer
    codes, the per-column scale after it, then the cast."""
    acc = x2.float() @ _unpack(wq, int4, k).float()
    return (acc * scale.float()).to(out_dtype)


def _cdiv(a, b):
    return -(-a // b)


def _route(x2, wq, k, n):
    """The kernel a launch takes: ``"fma"`` for fp32 x; for bf16/fp16 x
    ``"narrow"`` (m <= NARROW_MAX_M) or ``"wide"`` when TMA can map the
    operands (n % 16 == 0, k % 8 == 0, x and wq 16-byte aligned), else
    ``"legacy"``.  Reads dtype, shape and the pointers' alignment only."""
    if x2.dtype == torch.float32:
        return "fma"
    if n % 16 == 0 and k % 8 == 0 and x2.data_ptr() % 16 == 0 and \
            wq.data_ptr() % 16 == 0:
        return "narrow" if x2.shape[0] <= NARROW_MAX_M else "wide"
    return "legacy"


def wo_plan(m, k, n, int4=False):
    """The sm90 kernels' plan for ``x [m, k] @ q [k, n]`` (a pure function
    of the shape): ``form`` "narrow" (m <= 64) or "wide"; ``tm``, the rows
    of a narrow CTA (8, 16, 32 or 64; 0 for wide); ``k_step``, the logical
    k rows of a ring stage (narrow: 128 raw rows, so 256 for int4);
    ``splits`` and ``steps_per_split`` (narrow: split-K when the 64-column
    tiles do not fill the card's 132 SMs, up to two CTAs an SM and at least
    4 steps a split); ``stages`` (narrow: as many as fit 110 KB beside the
    two consumers' tiles, 2 to 10); ``ctas``."""
    if m <= NARROW_MAX_M:
        tm = next(t for t in (8, 16, 32, 64) if m <= t)
        k_step = _NARROW_RAW * (2 if int4 else 1)
        tiles, nk = _cdiv(n, _NARROW_COLS), _cdiv(k, k_step)
        splits = 1 if tiles >= _SMS else \
            max(1, min(_cdiv(2 * _SMS, tiles), nk // 4))
        sps = _cdiv(nk, splits)
        splits = _cdiv(nk, sps)
        stage = k_step // 64 * tm * 128 + _NARROW_RAW * _NARROW_COLS
        fit = (_NARROW_BUDGET - k_step * 128) // stage
        return {"form": "narrow", "tm": tm, "k_step": k_step,
                "splits": splits, "steps_per_split": sps,
                "stages": min(10, max(2, fit)), "ctas": tiles * splits}
    return {"form": "wide", "tm": 0, "k_step": _WIDE_K, "splits": 1,
            "steps_per_split": _cdiv(k, _WIDE_K), "stages": 5,
            "ctas": _cdiv(m, _WIDE_ROWS) * _cdiv(n, _WIDE_COLS)}


def _lib(name="weight_only"):
    from . import _build
    lib = _build.load(name)
    for fn_name, argtypes in ENTRY_POINTS[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _cuda_wo(x2, wq, scale, int4, k, out_dtype):
    global LAUNCHES, LAUNCHES_INT4, LAUNCHES_NARROW, LAUNCHES_WIDE, \
        LAUNCHES_FMA, LAUNCHES_LEGACY
    dev = x2.device
    for name, t in (("wq", wq), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"weight_only_matmul: {name} must be contiguous")
    if x2.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"weight_only_matmul: x {x2.dtype} -> {out_dtype} not "
                        "supported (float32, bfloat16, float16)")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"weight_only_matmul: wq must be int8 and scale "
                        f"float32, got {wq.dtype} and {scale.dtype}")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError("the weight-only kernel is built for sm_90a "
                           "(H100/H200)")
    m, n = x2.shape[0], wq.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    route = _route(x2, wq, k, n)
    if route in ("narrow", "wide"):
        plan = wo_plan(m, k, n, int4)
        ws = torch.empty((plan["splits"], m, n), dtype=torch.float32,
                         device=dev) if plan["splits"] > 1 else None
        err = _lib("weight_only_sm90").ptt_weight_only_sm90(
            x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, k, n, int(int4),
            _DTYPE_CODE[x2.dtype], _DTYPE_CODE[out_dtype], plan["tm"],
            plan["splits"], plan["steps_per_split"], stream)
    else:
        err = _lib().ptt_weight_only(
            x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, int(int4), _DTYPE_CODE[x2.dtype],
            _DTYPE_CODE[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"weight_only_matmul launch failed ({route}): "
                           f"CUDA error {err}")
    if int4:
        LAUNCHES_INT4 += 1
    else:
        LAUNCHES += 1
    if route == "narrow":
        LAUNCHES_NARROW += 1
    elif route == "wide":
        LAUNCHES_WIDE += 1
    elif route == "fma":
        LAUNCHES_FMA += 1
    else:
        LAUNCHES_LEGACY += 1
    return out


def _wo_forward(x2, wq, scale, int4, k, out_dtype):
    if x2.device.type == "cuda":
        return _cuda_wo(x2, wq, scale, int4, k, out_dtype)
    return _wo_reference(x2, wq, scale, int4, k, out_dtype)


class _WeightOnlyMatmul(torch.autograd.Function):
    """The counterpart of the reference's ``_wo_core`` custom VJP."""

    @staticmethod
    def forward(ctx, x2, wq, scale, int4, k, out_dtype):
        ctx.save_for_backward(wq, scale)
        ctx.int4, ctx.k, ctx.x_dtype = int4, k, x2.dtype
        return _wo_forward(x2, wq, scale, int4, k, out_dtype)

    @staticmethod
    def backward(ctx, g):
        wq, scale = ctx.saved_tensors
        gs = g.float() * scale.float()[None, :]
        dx = (gs @ _unpack(wq, ctx.int4, ctx.k).float().T).to(ctx.x_dtype)
        return dx, None, None, None, None, None


def weight_only_matmul(x, wq, scale, int4_rows=None, out_dtype=None):
    """``x [..., m, k] @ dequant(wq) -> [..., m, n]`` in ``out_dtype``
    (default x's dtype), with an fp32 sum and the scale applied after it.

    wq: int8 ``[k, n]``, or int4 packed ``[ceil(k/2), n]`` marked by passing
    ``int4_rows=k``; scale: fp32 ``[n]``.  Differentiable in ``x``.  A CUDA
    tensor launches the kernel, a CPU tensor takes the plain version, and
    an empty batch returns ``[..., 0, n]`` without a launch.
    """
    int4 = int4_rows is not None
    k = int4_rows if int4 else wq.shape[0]
    n = wq.shape[1]
    if x.shape[-1] != k:
        raise ValueError(
            f"contraction mismatch: x has k={x.shape[-1]}, wq has k={k}")
    if int4 and wq.shape[0] != (k + 1) // 2:
        raise ValueError(f"int4 wq must have {(k + 1) // 2} packed rows for "
                         f"k={k}, got {wq.shape[0]}")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be [{n}], got {tuple(scale.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    lead = tuple(x.shape[:-1])
    m = math.prod(lead)
    if m == 0:
        return x.new_empty(lead + (n,), dtype=out_dtype)
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("weight_only_matmul: x must be contiguous")
    out = _WeightOnlyMatmul.apply(x.reshape(m, k), wq, scale, int4, k,
                                  out_dtype)
    return out.reshape(lead + (n,))


# Paddle-API tensors handed to a kernel's entry run it on plain tensors
from ..core.tensor import plain_module  # noqa: E402

plain_module(globals())
