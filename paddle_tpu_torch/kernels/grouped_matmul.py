"""Grouped (ragged) expert matmul — the MoE compute op (port of
``paddle_tpu/kernels/grouped_matmul.py``, forward form).

Tokens are sorted by expert outside the kernel (:func:`sorted_dispatch_plan`)
so each expert's rows fill a contiguous, ``bm``-aligned span of the padded
row buffer and every ``bm``-row tile belongs to one expert, named by
``tile_groups``.  :func:`gmm` then computes
``out[m] = lhs[rows[m]] @ rhs[tile_groups[m // bm]]`` with an fp32
accumulator.

- On a CUDA tensor :func:`gmm` launches the hand-written Hopper kernel
  ``csrc/grouped_matmul.cu`` (it replaces the Pallas ``_gmm_kernel`` and its
  fused row gather ``_gather_rows``); every launch adds one to
  :data:`LAUNCHES`.  Shapes the kernel does not take raise.
- On a CPU tensor it runs the plain PyTorch version
  (:func:`_gmm_reference`), the tests' oracle.

The dispatch plan is built on the device without reading anything back to
the host: expert counts come from a ``scatter_add_`` into a fixed ``[E]``
tensor (not ``bincount``, whose output size is read from the device), and
every size is static.  The backward modes of the reference (``trans_rhs``,
``row_scale``) and ``tgmm`` belong to the training slice and raise here.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel since import (or the last reset by a caller).
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROW_TILES = (64, 32, 16, 8)      # the kernel's row tiles (must divide bm)
_BK, _BN = 32, 64                 # C and O must be multiples of these


# --------------------------------------------------------------- oracles ---

def _gmm_reference(lhs, rhs, tile_groups, *, bm, rows=None):
    """Plain version: gather each row tile's expert weights and run one
    batched matmul in fp32 (M*C*O multiply-adds, no E-fold masking), the
    result in lhs's dtype."""
    if rows is not None:
        lhs = lhs[rows.long()]
    M, C = lhs.shape
    T = M // bm
    w = rhs[tile_groups.long()]                           # [T, C, O]
    out = torch.bmm(lhs.reshape(T, bm, C).float(), w.float())
    return out.reshape(M, -1).to(lhs.dtype)


# ------------------------------------------------------------ dispatch ---

def take_sentinel_rows(buf, idx):
    """Gather rows of ``buf`` treating any index >= ``buf.shape[0]`` as the
    dispatch maps' dropped/pad SENTINEL: those positions read an exact zero
    row."""
    z = torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))], dim=0)
    return z[torch.clamp(idx.long(), max=buf.shape[0])]


def sorted_dispatch_plan(expert_ids, num_groups, bm):
    """Build the gather maps for a grouped-GEMM dispatch.

    expert_ids: [F] int — the expert choice per (token, k) flat entry.
    Returns (inv_flat [M], pos [F], tile_groups [M // bm]), all int32, where
    M = ceil(F/bm)*bm + num_groups*bm (static):

    - ``inv_flat[p]`` = flat entry id occupying padded-buffer row p, or F
      for alignment-padding rows (callers gather against a zero row);
    - ``pos[f]`` = padded-buffer row of flat entry f;
    - ``tile_groups[i]`` = expert owning row tile i (nondecreasing; every
      expert owns >= 1 tile).

    Rows are grouped by expert in stable order, each expert padded to a bm
    multiple (>= bm).  Nothing is read back to the host.
    """
    F = expert_ids.shape[0]
    M = -(-F // bm) * bm + num_groups * bm
    dev = expert_ids.device
    i64 = torch.int64
    e = expert_ids.to(i64)
    order = torch.sort(e, stable=True).indices
    e_sorted = e[order]
    counts = torch.zeros(num_groups, dtype=i64, device=dev).scatter_add_(
        0, e, torch.ones_like(e))
    padded = torch.clamp((counts + bm - 1) // bm, min=1) * bm
    starts = torch.cumsum(counts, 0) - counts
    ends = torch.cumsum(padded, 0)
    offsets = ends - padded
    r = torch.arange(F, dtype=i64, device=dev)
    dest = offsets[e_sorted] + (r - starts[e_sorted])
    inv_flat = torch.full((M,), F, dtype=torch.int32, device=dev).scatter_(
        0, dest, order.to(torch.int32))
    pos = torch.zeros((F,), dtype=torch.int32, device=dev).scatter_(
        0, order, dest.to(torch.int32))
    tiles = torch.arange(M // bm, dtype=i64, device=dev) * bm
    tile_groups = torch.clamp(torch.searchsorted(ends, tiles, right=True),
                              max=num_groups - 1).to(torch.int32)
    return inv_flat, pos, tile_groups


# ---------------------------------------------------------------- kernel ---

def _kernel_fn():
    from . import _build
    fn = _build.load("grouped_matmul").ptt_gmm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def row_tile(bm: int) -> int:
    """The kernel's row tile for a group alignment ``bm``: the largest of
    64/32/16/8 that divides it, so no tile straddles two experts."""
    for tm in _ROW_TILES:
        if bm % tm == 0:
            return tm
    raise ValueError(f"bm ({bm}) must be a multiple of 8")


def _cuda_gmm(lhs, rhs, tile_groups, bm, rows):
    global LAUNCHES
    M = rows.shape[0] if rows is not None else lhs.shape[0]
    L, C = lhs.shape
    E, C2, O = rhs.shape
    dev = lhs.device
    tensors = {"lhs": lhs, "rhs": rhs, "tile_groups": tile_groups,
               "rows": rows}
    for name, x in tensors.items():
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, lhs on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError("the grouped-matmul kernel is built for sm_90a "
                           "(H100/H200)")
    if lhs.dtype not in _DTYPE_CODE or rhs.dtype != lhs.dtype:
        raise TypeError(f"lhs/rhs dtypes {lhs.dtype}/{rhs.dtype} not "
                        "supported (both float32 or both bfloat16)")
    for name in ("tile_groups", "rows"):
        x = tensors[name]
        if x is not None and x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if C2 != C:
        raise ValueError(f"rhs contracts over {C2}, lhs has {C} columns")
    if C % _BK or O % _BN:
        raise ValueError(f"C ({C}) must be a multiple of {_BK} and O ({O}) "
                         f"of {_BN}")
    if tile_groups.shape != (M // bm,):
        raise ValueError(f"tile_groups must be [{M // bm}], got "
                         f"{tuple(tile_groups.shape)}")
    out = torch.empty((M, O), dtype=lhs.dtype, device=dev)
    for name, x in (("lhs", lhs), ("rhs", rhs), ("out", out)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = _kernel_fn()(
        ptr(lhs), ptr(rhs), ptr(tile_groups), ptr(rows), ptr(out), M, C, O,
        E, L, bm, row_tile(bm), _DTYPE_CODE[lhs.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


# ----------------------------------------------------------- entry point ---

def gmm(lhs, rhs, tile_groups, *, bm, rows=None, trans_rhs=False,
        row_scale=None):
    """Grouped matmul: ``out[m, :] = lhs[m, :] @ rhs[tile_groups[m//bm]]``.

    lhs: [M, C] with rows grouped by expert, group spans bm-aligned; or,
    with ``rows`` ([M] int32, the fused dispatch gather), the un-permuted
    token buffer [L, C], and then ``out[m] = lhs[rows[m]] @ rhs[...]``
    without an [M, C] permuted copy.  rhs: [E, C, O].  tile_groups:
    [M//bm] int32, nondecreasing, expert id per row tile.  Returns [M, O]
    in lhs.dtype (fp32 accumulation).

    CUDA tensors launch the Hopper kernel; CPU tensors take the plain
    version.  ``trans_rhs`` and ``row_scale`` (the MoE backward) are not
    ported yet.
    """
    if trans_rhs or row_scale is not None:
        raise NotImplementedError(
            "gmm's trans_rhs/row_scale modes (the MoE backward) come with "
            "the training slice (ROADMAP Queue 2 item 4)")
    M = rows.shape[0] if rows is not None else lhs.shape[0]
    if M % bm:
        raise ValueError(f"M ({M}) must be a multiple of bm ({bm})")
    if lhs.device.type == "cuda":
        return _cuda_gmm(lhs, rhs, tile_groups, bm, rows)
    if lhs.device.type == "cpu":
        return _gmm_reference(lhs, rhs, tile_groups, bm=bm, rows=rows)
    raise ValueError(f"unsupported device {lhs.device}")
