"""The block-primitive library (port of ``paddle_tpu/kernels/primitives.py``).

Building blocks that custom kernels assemble:

- tiling helpers (:func:`cdiv`, :func:`round_up_to`, :func:`min_tile`,
  :func:`pick_block`) that give the reference's answers, the TPU's
  sublane/lane table included (a caller sizing work the way the reference
  does gets the same numbers);
- the kernel generators :func:`elementwise_kernel`, :func:`reduce_kernel`
  and :func:`matmul_kernel`;
- :class:`OnlineSoftmax`, the streaming ``(m, l, acc)`` update;
- :func:`unpack_int4` and :func:`dequant_int8`, the weight-dequant blocks.

**The caller's function.**  Pallas traces a Python function into the kernel
body; a CUDA kernel cannot take a Python callable.  So each generator takes a
:class:`KernelFn`: ``torch``, a callable on fp32 tensors, which the plain
version runs, and ``cuda``, the body of a ``__device__ float`` function over
``float`` arguments named ``a``, ``b``, ``c``, ... in order, which is written
into a generated header and compiled into ``csrc/primitives.cu``
(``_build.load_generated``; the library is named by a hash of the template,
the header and the flags, so an unchanged function loads at once).  A plain
callable is taken as a :class:`KernelFn` with no CUDA body: it works on CPU
tensors, and a generator given one raises on any other device.

**Devices.**  A CPU tensor runs the plain version; a CUDA tensor launches the
kernel (each launch adds one to :data:`LAUNCHES_ELEMENTWISE`,
:data:`LAUNCHES_REDUCE` or :data:`LAUNCHES_MATMUL`; a reduce that took the
"vec16" route of :func:`_reduce_route` also to
:data:`LAUNCHES_REDUCE_VEC16`) or raises.  No path falls back.  Inputs are
fp32, bf16 or fp16.

**What is not ported.**  The reference's TPU tile knobs (``block``,
``block_rows``, ``block_m``/``block_n``/``block_k``) and ``interpret``: the
CUDA kernels pick their own tiles and handle ragged edges with masks, with
no padded copy.  ``pl_scratch`` (a VMEM accumulator spec) has no
counterpart: the CUDA matmul keeps its fp32 accumulator in registers.  None
of the generators has a gradient, as in the reference.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Optional

import torch

# ---------------------------------------------------------------- tiling

# The TPU's minimum tile: sublanes by dtype, 128 lanes (the reference's
# table, kept so the helpers give its answers).
_SUBLANE = {torch.float32: 8, torch.bfloat16: 16, torch.int8: 32,
            torch.float16: 16}
LANE = 128


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up_to(x: int, mult: int) -> int:
    return cdiv(x, mult) * mult


def min_tile(dtype) -> tuple:
    """Minimum legal (sublane, lane) tile for a dtype on the TPU."""
    return (_SUBLANE.get(dtype, 8), LANE)


def pick_block(dim: int, dtype, target: int = 512,
               axis: str = "sublane") -> int:
    """Largest tile-aligned block size <= target that divides ``dim`` if
    possible, else the aligned base (caller pads)."""
    base = LANE if axis == "lane" else _SUBLANE.get(dtype, 8)
    best = base
    b = base
    while b <= min(dim, target):
        if dim % b == 0:
            best = b
        b *= 2
    return best


# ------------------------------------------------------ kernel generators

# Launches of each generator's CUDA kernel since import (or a caller's reset).
LAUNCHES_ELEMENTWISE = 0
LAUNCHES_REDUCE = 0
LAUNCHES_MATMUL = 0
LAUNCHES_REDUCE_VEC16 = 0   # the reduce launches on the "vec16" route

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARG_NAMES = "abcdefgh"          # the CUDA body's arguments, in order


@dataclass(frozen=True)
class KernelFn:
    """A caller's function for a generator: ``torch`` on fp32 tensors (the
    plain version) and ``cuda``, the body of a ``__device__ float`` function
    over ``float`` arguments ``a``, ``b``, ... (the kernel), e.g.
    ``KernelFn(lambda a, b: a * b, "return a * b;")``.  The two must compute
    the same function."""
    torch: Callable
    cuda: Optional[str] = None


def _as_fn(fn) -> KernelFn:
    return fn if isinstance(fn, KernelFn) else KernelFn(fn)


_IDENTITY = KernelFn(lambda a: a, "return a;")

# kind -> (the header's switch, the functor's name, its arity or None)
_KINDS = {"elementwise": ("PTT_ELEMENTWISE", "ptt_elementwise_fn", None),
          "reduce": ("PTT_REDUCE", "ptt_reduce_fn", 2),
          "matmul": ("PTT_MATMUL", "ptt_epilogue_fn", 1)}


def generated_header(kind: str, fn: KernelFn,
                     arity: Optional[int] = None) -> str:
    """The header that compiles ``fn``'s CUDA body into ``csrc/primitives.cu``
    as the ``kind`` generator's functor (``arity`` inputs for elementwise)."""
    switch, name, fixed = _KINDS[kind]
    arity = fixed or arity
    if not arity or not 1 <= arity <= len(_ARG_NAMES):
        raise ValueError(f"{kind}: arity must be 1..{len(_ARG_NAMES)}, got "
                         f"{arity}")
    if fn.cuda is None:
        raise ValueError(f"{kind}_kernel: the function has no CUDA body "
                         "(KernelFn.cuda), so it runs only on CPU tensors")
    args = ", ".join(f"float {a}" for a in _ARG_NAMES[:arity])
    lines = ["// generated by paddle_tpu_torch.kernels.primitives",
             "#include <cuda_runtime.h>", f"#define {switch} 1"]
    if kind == "elementwise":
        lines.append(f"#define PTT_ELEMENTWISE_ARITY {arity}")
    lines += [f"__device__ __forceinline__ float {name}({args}) {{",
              fn.cuda, "}", ""]
    return "\n".join(lines)


def _kernel_lib(kind: str, fn: KernelFn, arity: Optional[int] = None):
    from . import _build
    lib = _build.load_generated("primitives",
                                generated_header(kind, fn, arity))
    f = getattr(lib, f"ptt_{kind}")
    if f.argtypes is None:
        f.argtypes = {
            "elementwise": [ctypes.POINTER(ctypes.c_uint64),
                            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
            "reduce": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p],
            "matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 +
                      [ctypes.c_void_p]}[kind]
        f.restype = ctypes.c_int
    return f


def _check_float(what, t):
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: {t.dtype} not supported (float32, "
                        "bfloat16, float16)")


def _cuda_ready(what, fn: KernelFn, tensors):
    """Checks before a launch: the CUDA body, the device, contiguity and the
    card; raises on any of them.  Runs for every non-CPU tensor, so a meta
    tensor or a function without a CUDA body never reaches a plain version."""
    if fn.cuda is None:
        raise ValueError(f"{what}: the function has no CUDA body "
                         "(KernelFn.cuda), so it runs only on CPU tensors")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev} (cuda or cpu)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"{what}: the kernel is built for sm_90a "
                           "(H100/H200)")
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(what, err):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _elementwise_reference(fn: KernelFn, tensors):
    """Plain version: every input widened to fp32, ``fn`` in fp32, one cast
    to the first input's dtype."""
    return fn.torch(*[t.float() for t in tensors]).to(tensors[0].dtype)


def elementwise_kernel(fn):
    """``apply(*tensors)`` computing ``fn(*tensors)`` elementwise over
    equally shaped inputs (any arity up to 8, each fp32, bf16 or fp16): the
    values are widened to fp32, ``fn`` runs in fp32 and the result is cast
    once to the first input's dtype, in the first input's shape."""
    fn = _as_fn(fn)
    libs = {}

    def apply(*tensors):
        global LAUNCHES_ELEMENTWISE
        if not tensors:
            raise ValueError("elementwise_kernel: no inputs")
        shape = tensors[0].shape
        for t in tensors:
            _check_float("elementwise_kernel", t)
            if t.shape != shape:
                raise ValueError(f"elementwise_kernel: shapes {tuple(shape)} "
                                 f"and {tuple(t.shape)} differ")
        if all(t.device.type == "cpu" for t in tensors):
            return _elementwise_reference(fn, tensors)
        stream = _cuda_ready("elementwise_kernel", fn, tensors)
        arity = len(tensors)
        if arity not in libs:
            libs[arity] = _kernel_lib("elementwise", fn, arity)
        out = torch.empty(shape, dtype=tensors[0].dtype,
                          device=tensors[0].device)
        if out.numel() == 0:
            return out
        ptrs = (ctypes.c_uint64 * arity)(*[t.data_ptr() for t in tensors])
        codes = (ctypes.c_int * arity)(*[_DTYPE_CODE[t.dtype]
                                         for t in tensors])
        _raise_on("elementwise_kernel", libs[arity](
            ptrs, codes, arity, out.data_ptr(), out.numel(), stream))
        LAUNCHES_ELEMENTWISE += 1
        return out

    return apply


def _reduce_reference(fn: KernelFn, x):
    """Plain version, the reference's left fold: ``acc = x[:, 0]``, then
    ``acc = fn(acc, x[:, i])`` in fp32 rounded to x's dtype, i = 1 ..
    cols - 1."""
    xf = x.float()
    acc = xf[:, 0]
    for i in range(1, x.shape[1]):
        acc = fn.torch(acc, xf[:, i])
        if x.dtype != torch.float32:
            acc = acc.to(x.dtype).float()
    return acc.to(x.dtype)


def _reduce_route(x):
    """How the reduce kernel stages ``x [rows, cols]``: ``"vec16"`` (16-byte
    ``cp.async`` copies) when every row is a whole number of 16-byte chunks
    (``cols * itemsize % 16 == 0``) and ``x.data_ptr()`` is 16-byte
    aligned, else ``"scalar"`` (element by element, the ragged edge
    masked).  The rule reads the pointer's alignment as well as dtype and
    shape: a view that starts inside a row (an offset slice) of the same
    shape can take the other route."""
    if (x.shape[1] * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0:
        return "vec16"
    return "scalar"


def reduce_kernel(fn, init):
    """``apply(x)`` reducing the last axis of a 2-D ``x [rows, cols]`` (fp32,
    bf16 or fp16) to ``[rows]`` in x's dtype, as the reference's left fold
    over the columns (``functools.reduce`` over ``x[:, i]``): each step is
    ``fn`` in fp32 rounded to x's dtype (nearest even), in column order, so
    the result is the same bits on the card and the CPU.  A CUDA tensor
    launches the kernel on the route :func:`_reduce_route` picks.  ``init``
    is accepted and ignored, as in the reference; 0 columns raise."""
    fn = _as_fn(fn)
    lib = None

    def apply(x):
        global LAUNCHES_REDUCE, LAUNCHES_REDUCE_VEC16
        nonlocal lib
        if x.dim() != 2:
            raise ValueError(f"reduce_kernel: x must be 2-D, got "
                             f"{tuple(x.shape)}")
        _check_float("reduce_kernel", x)
        rows, cols = x.shape
        if cols == 0:
            raise ValueError("reduce_kernel: x has no columns to reduce")
        if x.device.type == "cpu":
            return _reduce_reference(fn, x)
        stream = _cuda_ready("reduce_kernel", fn, [x])
        if lib is None:
            lib = _kernel_lib("reduce", fn)
        out = torch.empty((rows,), dtype=x.dtype, device=x.device)
        if rows == 0:
            return out
        vec = _reduce_route(x) == "vec16"
        _raise_on("reduce_kernel", lib(x.data_ptr(), out.data_ptr(), rows,
                                       cols, _DTYPE_CODE[x.dtype], int(vec),
                                       stream))
        LAUNCHES_REDUCE += 1
        LAUNCHES_REDUCE_VEC16 += vec
        return out

    return apply


def _matmul_reference(epilogue: KernelFn, x, w, out_dtype):
    """Plain version: the fp32 product, the epilogue on it, the cast."""
    return epilogue.torch(x.float() @ w.float()).to(out_dtype)


def matmul_kernel(epilogue=None, out_dtype=None):
    """``apply(x, w)``: ``[M, K] @ [K, N]`` with an fp32 sum, then
    ``epilogue`` on the fp32 sum, then the cast to ``out_dtype`` (default
    x's dtype).  x and w share a dtype: fp32, bf16 or fp16.  The epilogue
    is elementwise on the fp32 sum (a scaling, a bias constant, an
    activation): the kernel applies it to each output element alone."""
    epilogue = _IDENTITY if epilogue is None else _as_fn(epilogue)
    if out_dtype is not None and out_dtype not in _DTYPE_CODE:
        raise TypeError(f"matmul_kernel: out_dtype {out_dtype} not supported "
                        "(float32, bfloat16, float16)")
    lib = None

    def apply(x, w):
        global LAUNCHES_MATMUL
        nonlocal lib
        if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
            raise ValueError(f"matmul_kernel: [M, K] @ [K, N], got "
                             f"{tuple(x.shape)} @ {tuple(w.shape)}")
        _check_float("matmul_kernel", x)
        if w.dtype != x.dtype:
            raise TypeError(f"matmul_kernel: x is {x.dtype}, w {w.dtype}")
        dt = out_dtype or x.dtype
        if x.device.type == "cpu" and w.device.type == "cpu":
            return _matmul_reference(epilogue, x, w, dt)
        stream = _cuda_ready("matmul_kernel", epilogue, [x, w])
        if lib is None:
            lib = _kernel_lib("matmul", epilogue)
        (m, k), n = x.shape, w.shape[1]
        out = torch.empty((m, n), dtype=dt, device=x.device)
        if m == 0 or n == 0:
            return out
        _raise_on("matmul_kernel", lib(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[dt], stream))
        LAUNCHES_MATMUL += 1
        return out

    return apply


# ------------------------------------------------- streaming softmax state

class OnlineSoftmax:
    """The (m, l, acc) online-softmax update, the shared core of the flash
    and paged attention kernels, on tensors."""

    @staticmethod
    def init(block_q: int, dim: int, device="cuda"):
        return (torch.full((block_q,), -1e30, device=device),   # running max
                torch.zeros((block_q,), device=device),          # running sum
                torch.zeros((block_q, dim), device=device))      # weighted acc

    @staticmethod
    def update(state, scores, values):
        """state=(m, l, acc); scores [bq, bk] fp32; values [bk, d]."""
        m, l, acc = state
        m_new = torch.maximum(m, scores.amax(-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[:, None])
        l_new = l * correction + p.sum(-1)
        acc_new = acc * correction[:, None] + p.to(values.dtype) @ values
        return m_new, l_new, acc_new

    @staticmethod
    def finalize(state):
        m, l, acc = state
        return acc / torch.clamp_min(l, 1e-30)[:, None]

    @staticmethod
    def lse(state):
        m, l, _ = state
        return m + torch.log(torch.clamp_min(l, 1e-30))


# ------------------------------------------------------ dequant primitives

def unpack_int4(packed, orig_cols: int):
    """Sign-extending unpack of two int4 nibbles per int8 byte along the
    last axis, ``[r, c/2] -> [r, c]``: the low nibble is the even column,
    the high nibble the odd one.  (``quantization``'s int4 packing pairs
    rows instead: ``weight_only._unpack_int4``.)"""
    low = (packed << 4) >> 4                  # int8: wraps, then arithmetic
    high = packed >> 4
    out = torch.stack([low, high], dim=-1).reshape(packed.shape[0], -1)
    return out[:, :orig_cols]


def dequant_int8(q, scale, axis: int = -1):
    """Per-channel int8 -> float dequant: ``scale`` (one value per index of
    ``axis``) broadcast along every other axis, in ``scale``'s dtype."""
    shape = [1] * q.dim()
    shape[axis % q.dim()] = -1
    s = scale.reshape(shape)
    return q.to(s.dtype) * s
