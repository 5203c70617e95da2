"""Weight-only quantized matmul, W8A16 / W4A16 (port of
``paddle_tpu/kernels/weight_only.py``).

``weight_only_matmul(x, wq, scale)`` computes ``x @ dequant(wq)`` with the
weight kept int8 in device memory: int8 ``[k, n]``, or int4 packed
``[ceil(k/2), n]`` (low nibble = even row, :func:`_pack_int4`), and a
per-output-channel fp32 ``scale [n]`` applied once after the fp32 sum (the
reference kernel's ``_finalize``).

- On a CUDA tensor it launches the hand-written Hopper kernel of
  ``csrc/weight_only.cu``, which replaces the Pallas ``_wo_kernel``
  (``paddle_tpu/kernels/weight_only.py:28``) for every shape, the ones the
  reference sends to its XLA fallback included.  Each launch adds one to
  :data:`LAUNCHES` (int8) or :data:`LAUNCHES_INT4`.  Inputs the kernel does
  not take (a non-contiguous operand, another dtype) raise.
- On a CPU tensor it runs the plain version :func:`_wo_reference`, which
  follows the kernel's math: ``x.float() @ q.float()``, then ``* scale`` in
  fp32, then the cast.  Any other device raises.

What bounds the kernel on the H100: at decode, bytes (the weight read once:
45.1 MB int8 / 22.5 MB int4 for llama2_7b's gate/up, 0.0135 / 0.0068 ms at
3.35 TB/s); in a 512-row prefill chunk, operations (0.047 ms at 989
TFLOP/s).  The design (tensor-core WMMA over a dequantized shared-memory
tile for bf16/fp16, FMA for fp32) is described in the source.

The reference's ``block_m``/``block_n``/``block_k``/``interpret`` are the
TPU's tile knobs and are not ported: the CUDA kernel picks its own tiles.

The gradient (:class:`_WeightOnlyMatmul`) is the reference's ``_wo_core_bwd``
in plain PyTorch on both devices: ``dx = ((g * scale) @ q.T)`` in fp32,
cast to x's dtype.  ``wq`` and ``scale`` get no gradient (the reference
returns zero cotangents for this frozen inference state).
"""

from __future__ import annotations

import ctypes
import math

import torch

# Launches of the CUDA kernel since import (or the last reset by a caller).
LAUNCHES = 0          # int8 weights
LAUNCHES_INT4 = 0     # int4 packed weights

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def _lib():
    from . import _build
    lib = _build.load("weight_only")
    if lib.ptt_weight_only.argtypes is None:
        lib.ptt_weight_only.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.ptt_weight_only.restype = ctypes.c_int
    return lib


def _cuda_wo(x2, wq, scale, int4, k, out_dtype):
    global LAUNCHES, LAUNCHES_INT4
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
    err = _lib().ptt_weight_only(
        x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k,
        n, int(int4), _DTYPE_CODE[x2.dtype], _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"weight_only_matmul launch failed: CUDA error "
                           f"{err}")
    if int4:
        LAUNCHES_INT4 += 1
    else:
        LAUNCHES += 1
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
