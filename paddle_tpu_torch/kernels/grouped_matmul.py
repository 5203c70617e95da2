"""Grouped (ragged) expert matmul — the MoE compute op (port of
``paddle_tpu/kernels/grouped_matmul.py``).

Tokens are sorted by expert outside the kernel (:func:`sorted_dispatch_plan`)
so each expert's rows fill a contiguous, ``bm``-aligned span of the padded
row buffer and every ``bm``-row tile belongs to one expert, named by
``tile_groups``.  Three products, each with an fp32 accumulator:

- :func:`gmm` ``out[m] = s[m]·lhs[rows[m]] @ rhs[tile_groups[m // bm]]``
  with rhs ``[E, C, O]`` (the MoE forward), or ``[E, O, C]`` read
  transposed with ``trans_rhs`` (the backward's dlhs); ``rows`` fuses the
  dispatch gather and ``row_scale`` the combine weight;
- :func:`tgmm` ``out[e] = Σ_{m in e's tiles} lhs[lrows[m]]ᵀ ⊗
  s[m]·rhs[rrows[m]]``, ``[E, K, N]`` (the backward's weight gradient);
- :func:`grouped_matmul`, the differentiable entry point: ``gmm`` forward,
  ``gmm(trans_rhs=True)`` and ``tgmm`` backward.

On a CUDA tensor :func:`gmm` and :func:`tgmm` launch hand-written Hopper
kernels; on a CPU tensor they run the plain PyTorch versions
(:func:`_gmm_reference`, :func:`_tgmm_reference`), the tests' oracles.  Any
other device raises, and so do shapes the kernels do not take.  Both take
the route :func:`_route` picks by dtype: ``"sm90"`` for bf16 (wgmma fed by
a TMA / ``cp.async`` ring, warp-specialised: gmm in
``csrc/grouped_matmul_sm90.cu``, in the wide or narrow form
:func:`sm90_plan` picks from ``bm``; tgmm in ``csrc/tgmm_sm90.cu``, tiled
as :func:`tgmm_sm90_plan` says) or ``"simt"`` for fp32 (FMA, both in
``csrc/grouped_matmul.cu``).  Launches are counted apart: :data:`LAUNCHES`
(gmm, forward form; it replaces the Pallas ``_gmm_kernel`` and its fused
row gather ``_gather_rows``), :data:`LAUNCHES_TRANS` (gmm with
``trans_rhs``, the same Pallas kernel's backward mode) and
:data:`LAUNCHES_TGMM` (it replaces ``_tgmm_kernel``), each on either route,
with the launches that took the "sm90" route also in
:data:`LAUNCHES_SM90`, :data:`LAUNCHES_TRANS_SM90` and
:data:`LAUNCHES_TGMM_SM90`.

The reference's TPU tile knobs (the ``grouped_matmul_bn``/``_bk`` flags,
``validate_tile_flags``, ``_resolve_tiles`` and the autotune probe
``_tune``) are not ported: the CUDA kernels choose their own tiles from the
shapes.

The dispatch plan is built on the device without reading anything back to
the host: expert counts come from a ``scatter_add_`` into a fixed ``[E]``
tensor (not ``bincount``, whose output size is read from the device), and
every size is static.
"""

from __future__ import annotations

import ctypes

import torch

from . import on_device

# Launches of each CUDA kernel since import (or the last reset by a caller).
LAUNCHES = 0          # gmm, forward form (rhs [E, C, O])
LAUNCHES_TRANS = 0    # gmm with trans_rhs (rhs [E, O, C])
LAUNCHES_TGMM = 0     # tgmm
# the launches that took the "sm90" route (a part of the above)
LAUNCHES_SM90 = 0
LAUNCHES_TRANS_SM90 = 0
LAUNCHES_TGMM_SM90 = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROW_TILES = (64, 32, 16, 8)      # gmm's row tiles (must divide bm)
_BK, _BN = 32, 64                 # gmm: C and O must be multiples of these
_TG = 64                          # tgmm: K and N must be multiples of this
_TGMM_STEP = 64                   # sm90 tgmm: rows of a k-step
_TGMM_TILE_K = 128                # sm90 tgmm: K rows of a CTA
_TGMM_MAX_EXPERTS = 256           # sm90 tgmm: experts it ranks in a CTA
_WIDE_ROWS = 128                  # sm90 wide form: rows of a CTA
_NARROW_COLS = 64                 # sm90 narrow form: output columns of a CTA


# --------------------------------------------------------------- oracles ---

def _gmm_reference(lhs, rhs, tile_groups, *, bm, trans_rhs=False, rows=None,
                   row_scale=None):
    """Plain version: gather each row tile's expert weights and run one
    batched matmul in fp32 (M*C*O multiply-adds, no E-fold masking), the
    result in lhs's dtype.  ``row_scale`` is cast to lhs's dtype and
    multiplies the gathered rows in that dtype, before the matmul."""
    if rows is not None:
        lhs = lhs[rows.long()]
    if row_scale is not None:
        lhs = lhs * row_scale[:, None].to(lhs.dtype)
    M, C = lhs.shape
    T = M // bm
    w = rhs[tile_groups.long()]                   # [T, C, O] or [T, O, C]
    if trans_rhs:
        w = w.transpose(1, 2)
    out = torch.bmm(lhs.reshape(T, bm, C).float(), w.float())
    return out.reshape(M, -1).to(lhs.dtype)


def _tgmm_reference(lhs, rhs, tile_groups, num_groups, *, bm, lhs_rows=None,
                    rhs_rows=None, rhs_scale=None):
    """Plain version: per row tile ``lhsᵀ @ rhs`` in fp32, summed per group
    (a group that owns no tile gets zeros), cast to lhs's dtype.
    ``rhs_scale`` is cast to rhs's dtype and multiplies the gathered rhs
    rows in that dtype."""
    if lhs_rows is not None:
        lhs = lhs[lhs_rows.long()]
    if rhs_rows is not None:
        rhs = rhs[rhs_rows.long()]
    if rhs_scale is not None:
        rhs = rhs * rhs_scale[:, None].to(rhs.dtype)
    M, K = lhs.shape
    T = M // bm
    per_tile = torch.bmm(lhs.reshape(T, bm, K).float().transpose(1, 2),
                         rhs.reshape(T, bm, -1).float())      # [T, K, N]
    out = per_tile.new_zeros((num_groups,) + tuple(per_tile.shape[1:]))
    out.index_add_(0, tile_groups.long(), per_tile)
    return out.to(lhs.dtype)


# ------------------------------------------------------------ dispatch ---

def take_sentinel_rows(buf, idx):
    """Gather rows of ``buf`` treating any index >= ``buf.shape[0]`` as the
    dispatch maps' dropped/pad SENTINEL: those positions read an exact zero
    row."""
    z = torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))], dim=0)
    return z[torch.clamp(idx.long(), max=buf.shape[0])]


def capacity_dispatch_plan(expert_ids, gate_vals, num_groups, capacity):
    """k-major capacity dispatch maps of the ``gather`` MoE form
    (``models.llama.moe_mlp_forward``).

    expert_ids/gate_vals: [N, K] top-k routing.  Slot priority is k-major
    (every token's first choice beats any second choice); an entry's
    position in its expert's buffer is its rank among the entries routed
    there; entries ranked past ``capacity`` drop.  Returns
    (inv [E*capacity + 1], slot [K*N], gate_keep [K*N], keep [K*N]):
    ``inv[b]`` = token id in buffer slot b (N = empty); ``slot[f]`` =
    buffer slot of k-major flat entry f (E*capacity = the drop sentinel,
    combined through :func:`take_sentinel_rows`); ``gate_keep`` = fp32
    combine weight, zeroed for drops.  The sentinel slot ``inv[-1]`` holds
    the last dropped entry's token (N when nothing drops), as a sequential
    scatter of every entry leaves it.  Nothing is read back to the host."""
    N, K = expert_ids.shape
    dev = expert_ids.device
    i32 = torch.int32
    idx = expert_ids.t().reshape(K * N).long()
    val = gate_vals.t().reshape(K * N).float()
    oh = (idx[:, None] == torch.arange(num_groups, device=dev)).long()
    pos = ((torch.cumsum(oh, dim=0) * oh).sum(-1) - 1).to(i32)
    keep = pos < capacity
    slot = torch.where(keep, idx.to(i32) * capacity + pos,
                       torch.full_like(pos, num_groups * capacity))
    tok = torch.arange(N, dtype=i32, device=dev).repeat(K)
    inv = torch.full((num_groups * capacity + 1,), N, dtype=i32,
                     device=dev).scatter_(0, slot.long(), tok)
    last_drop = torch.where(keep, -1, torch.arange(K * N, device=dev)).max()
    inv[-1:] = torch.where(last_drop >= 0, last_drop % N, N).to(i32)
    return inv, slot, val * keep.float(), keep


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


# --------------------------------------------------------------- kernels ---

_GMM_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_TGMM_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

# library -> {C entry point: argument types}; ptt_gmm_sm90 takes ptt_gmm's
# (lhs, rhs, tile_groups, rows, scale, out, M, C, O, E, L, bm, tm, trans,
# dtype, stream), ptt_tgmm_sm90 ptt_tgmm's (lhs, rhs, tile_groups, lrows,
# rrows, rscale, out, M, K, N, E, Ll, Lr, bm, T, dtype, stream)
ENTRY_POINTS = {
    "grouped_matmul": {"ptt_gmm": _GMM_ARGS, "ptt_tgmm": _TGMM_ARGS},
    "grouped_matmul_sm90": {"ptt_gmm_sm90": _GMM_ARGS},
    "tgmm_sm90": {"ptt_tgmm_sm90": _TGMM_ARGS,
                  # (x, rows, scale, out, M, W, L, stream)
                  "ptt_gather_rows": [ctypes.c_void_p] * 4 +
                  [ctypes.c_int] * 3 + [ctypes.c_void_p]},
}


def _lib(name="grouped_matmul"):
    from . import _build
    lib = _build.load(name)
    for fn_name, argtypes in ENTRY_POINTS[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _route(dtype):
    """gmm's and tgmm's route for operands of ``dtype``: ``"sm90"`` (bf16:
    wgmma) or ``"simt"`` (fp32: FMA, which matches fp32 references to 1e-5
    where wgmma would need TF32)."""
    return "sm90" if dtype == torch.bfloat16 else "simt"


def tgmm_sm90_plan(bm, K, N, E, *, lhs_rows=False, rhs_rows=False,
                   rhs_scale=False):
    """The sm90 tgmm's tiling of ``out [E, K, N]`` with group alignment
    ``bm``: ``{"tk", "bn", "step", "lhs", "rhs", "gather_pass", "ctas"}``.

    - a CTA computes ``tk`` = 128 K rows x ``bn`` N columns (256 where 256
      divides N, else 128, the last one ragged) of one expert, summing its
      rows in k-steps of ``step`` = 64;
    - ``"lhs"`` / ``"rhs"``: how each operand reaches shared memory: as TMA
      tiles (``"tma"``) where 64 divides bm, since every expert's span then
      starts and ends on a k-step; else row by row by ``cp.async``
      (gathered and scaled in the kernel, rows past a span masked);
    - ``"gather_pass"``: on the TMA route, the operands a gather pass
      (``ptt_gather_rows``) makes contiguous first, a gathered one with its
      rows, the rhs with its scale; the kernel then reads them as tiles;
    - ``ctas``: E x ceil(K / 128) x ceil(N / bn)."""
    bn = 256 if N % 256 == 0 else 128
    tma = bm % _TGMM_STEP == 0
    passed = tuple(name for name, on in (("lhs", lhs_rows),
                                         ("rhs", rhs_rows or rhs_scale))
                   if tma and on)
    how = "tma" if tma else "cp.async"
    return {"tk": _TGMM_TILE_K, "bn": bn, "step": _TGMM_STEP,
            "lhs": how, "rhs": how, "gather_pass": passed,
            "ctas": E * -(-K // _TGMM_TILE_K) * -(-N // bn)}


def sm90_plan(bm, M, O):
    """The sm90 route's tiling of a gmm with group alignment ``bm`` over
    ``M`` rows and ``O`` output columns: ``{"form", "tm", "bn", "ctas"}``.

    - ``"wide"`` when 128 divides ``bm``: CTAs of ``tm`` = 128 rows x
      ``bn`` columns (256 where O allows, else 128, the last one ragged);
    - ``"narrow"`` otherwise: the operands swap, a CTA computes 64 output
      columns (``bn``) x ``tm`` rows, ``tm`` = :func:`row_tile` (64, 32,
      16 or 8; wgmma's n).

    ``tm`` divides ``bm``, so no tile straddles two experts."""
    if bm % _WIDE_ROWS == 0:
        bn = 256 if O % 256 == 0 else 128
        return {"form": "wide", "tm": _WIDE_ROWS, "bn": bn,
                "ctas": (M // _WIDE_ROWS) * -(-O // bn)}
    tm = row_tile(bm)
    return {"form": "narrow", "tm": tm, "bn": _NARROW_COLS,
            "ctas": (M // tm) * (O // _NARROW_COLS)}


def row_tile(bm: int) -> int:
    """gmm's row tile for a group alignment ``bm``: the largest of
    64/32/16/8 that divides it, so no tile straddles two experts."""
    for tm in _ROW_TILES:
        if bm % tm == 0:
            return tm
    raise ValueError(f"bm ({bm}) must be a multiple of 8")


def _check_operands(what, dev, tensors, dtype, ints):
    """The checks every launch makes: one device, contiguous, sm_90, the
    float operands of one supported dtype, int32 indices, 16-byte aligned
    float operands."""
    for name, x in tensors.items():
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, lhs on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"the {what} kernel is built for sm_90a "
                           "(H100/H200)")
    floats = [x for n, x in tensors.items() if n not in ints and x is not None]
    if dtype not in _DTYPE_CODE or any(x.dtype != dtype for x in floats):
        raise TypeError(f"{what}: dtypes {[x.dtype for x in floats]} not "
                        "supported (all float32 or all bfloat16)")
    for name in ints:
        x = tensors[name]
        if x is not None and x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    for x in floats:
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: float operands must be 16-byte "
                             "aligned")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _cuda_gmm(lhs, rhs, tile_groups, bm, rows, trans_rhs, row_scale):
    global LAUNCHES, LAUNCHES_TRANS, LAUNCHES_SM90, LAUNCHES_TRANS_SM90
    M = rows.shape[0] if rows is not None else lhs.shape[0]
    L, C = lhs.shape
    if trans_rhs:
        E, O, C2 = rhs.shape
    else:
        E, C2, O = rhs.shape
    if row_scale is not None:
        if tuple(row_scale.shape) != (M,):
            raise ValueError(f"row_scale must be [{M}], got "
                             f"{tuple(row_scale.shape)}")
        row_scale = row_scale.to(lhs.dtype).contiguous()
    out = torch.empty((M, O), dtype=lhs.dtype, device=lhs.device)
    _check_operands("grouped_matmul", lhs.device,
                    {"lhs": lhs, "rhs": rhs, "row_scale": row_scale,
                     "out": out, "tile_groups": tile_groups, "rows": rows},
                    lhs.dtype, ("tile_groups", "rows"))
    if C2 != C:
        raise ValueError(f"rhs contracts over {C2}, lhs has {C} columns")
    if C % _BK or O % _BN:
        raise ValueError(f"C ({C}) must be a multiple of {_BK} and O ({O}) "
                         f"of {_BN}")
    if tile_groups.shape != (M // bm,):
        raise ValueError(f"tile_groups must be [{M // bm}], got "
                         f"{tuple(tile_groups.shape)}")
    sm90 = _route(lhs.dtype) == "sm90"
    if sm90:
        fn = _lib("grouped_matmul_sm90").ptt_gmm_sm90
        tm = sm90_plan(bm, M, O)["tm"]
    else:
        fn, tm = _lib().ptt_gmm, row_tile(bm)
    with on_device(lhs.device):
        err = fn(_ptr(lhs), _ptr(rhs), _ptr(tile_groups), _ptr(rows),
                 _ptr(row_scale), _ptr(out), M, C, O, E, L, bm, tm,
                 int(trans_rhs), _DTYPE_CODE[lhs.dtype],
                 torch.cuda.current_stream(lhs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul launch failed: CUDA error {err}")
    if trans_rhs:
        LAUNCHES_TRANS += 1
        LAUNCHES_TRANS_SM90 += sm90
    else:
        LAUNCHES += 1
        LAUNCHES_SM90 += sm90
    return out


def _gather_pass(lib, x, rows, scale, M, stream):
    """``x[rows] * scale`` (bf16; row m where ``rows`` is None, no scale
    where ``scale`` is None) as a new [M, W] tensor, by the sm90 tgmm's
    gather pass."""
    out = torch.empty((M, x.shape[1]), dtype=x.dtype, device=x.device)
    err = lib.ptt_gather_rows(_ptr(x), _ptr(rows), _ptr(scale), _ptr(out), M,
                              x.shape[1], x.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"tgmm gather pass failed: CUDA error {err}")
    return out


def _cuda_tgmm(lhs, rhs, tile_groups, num_groups, bm, lhs_rows, rhs_rows,
               rhs_scale):
    global LAUNCHES_TGMM, LAUNCHES_TGMM_SM90
    M = lhs_rows.shape[0] if lhs_rows is not None else lhs.shape[0]
    Mr = rhs_rows.shape[0] if rhs_rows is not None else rhs.shape[0]
    Ll, K = lhs.shape
    Lr, N = rhs.shape
    if Mr != M:
        raise ValueError(f"lhs gives {M} rows, rhs {Mr}")
    if rhs_scale is not None:
        if tuple(rhs_scale.shape) != (M,):
            raise ValueError(f"rhs_scale must be [{M}], got "
                             f"{tuple(rhs_scale.shape)}")
        rhs_scale = rhs_scale.to(rhs.dtype).contiguous()
    # every element is written: a group that owns no tile gets zeros (the
    # reference's ``visited`` mask)
    out = torch.empty((num_groups, K, N), dtype=lhs.dtype, device=lhs.device)
    _check_operands("tgmm", lhs.device,
                    {"lhs": lhs, "rhs": rhs, "rhs_scale": rhs_scale,
                     "out": out, "tile_groups": tile_groups,
                     "lhs_rows": lhs_rows, "rhs_rows": rhs_rows},
                    lhs.dtype, ("tile_groups", "lhs_rows", "rhs_rows"))
    if K % _TG or N % _TG:
        raise ValueError(f"K ({K}) and N ({N}) must be multiples of {_TG}")
    if tile_groups.shape != (M // bm,):
        raise ValueError(f"tile_groups must be [{M // bm}], got "
                         f"{tuple(tile_groups.shape)}")
    sm90 = _route(lhs.dtype) == "sm90"
    if sm90 and (num_groups > _TGMM_MAX_EXPERTS or bm % 8):
        raise ValueError(f"tgmm: the sm90 kernel takes at most "
                         f"{_TGMM_MAX_EXPERTS} groups and bm a multiple of "
                         f"8, got {num_groups} and {bm}")
    if M == 0:                       # no rows: every group's block is zero
        return out.zero_()
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    if sm90:
        lib = _lib("tgmm_sm90")
        fn = lib.ptt_tgmm_sm90
        if bm % _TGMM_STEP == 0:
            # the TMA route: a gather pass makes a gathered (or scaled)
            # operand contiguous, and the kernel reads every operand as
            # tiles (the gather in the kernel, row by row by cp.async, is
            # slower at the Mixtral training shape: chip_smoke.py
            # kernel_tgmm's in_kernel_gather_ms)
            if lhs_rows is not None:
                lhs = _gather_pass(lib, lhs, lhs_rows, None, M, stream)
                Ll, lhs_rows = M, None
            if rhs_rows is not None or rhs_scale is not None:
                rhs = _gather_pass(lib, rhs, rhs_rows, rhs_scale, M, stream)
                Lr, rhs_rows, rhs_scale = M, None, None
    else:
        fn = _lib().ptt_tgmm
    err = fn(_ptr(lhs), _ptr(rhs), _ptr(tile_groups), _ptr(lhs_rows),
             _ptr(rhs_rows), _ptr(rhs_scale), _ptr(out), M, K, N, num_groups,
             Ll, Lr, bm, M // bm, _DTYPE_CODE[lhs.dtype], stream)
    if err != 0:
        raise RuntimeError(f"tgmm launch failed: CUDA error {err}")
    LAUNCHES_TGMM += 1
    LAUNCHES_TGMM_SM90 += sm90
    return out


# ----------------------------------------------------------- entry points ---

def gmm(lhs, rhs, tile_groups, *, bm, rows=None, trans_rhs=False,
        row_scale=None):
    """Grouped matmul: ``out[m, :] = lhs[m, :] @ rhs[tile_groups[m//bm]]``.

    lhs: [M, C] with rows grouped by expert, group spans bm-aligned; or,
    with ``rows`` ([M] int32, the fused dispatch gather), the un-permuted
    token buffer [L, C], and then ``out[m] = lhs[rows[m]] @ rhs[...]``
    without an [M, C] permuted copy.  rhs: [E, C, O], or [E, O, C] read
    transposed with ``trans_rhs``.  row_scale: optional [M] per-row
    multiplier, cast to lhs's dtype and applied to the gathered rows in
    that dtype before the matmul.  tile_groups: [M//bm] int32,
    nondecreasing, expert id per row tile.  Returns [M, O] in lhs.dtype
    (fp32 accumulation).

    CUDA tensors launch a Hopper kernel (the route :func:`_route` picks);
    CPU tensors take the plain version.
    """
    M = rows.shape[0] if rows is not None else lhs.shape[0]
    if M % bm:
        raise ValueError(f"M ({M}) must be a multiple of bm ({bm})")
    if lhs.device.type == "cuda":
        return _cuda_gmm(lhs, rhs, tile_groups, bm, rows, trans_rhs,
                         row_scale)
    if lhs.device.type == "cpu":
        return _gmm_reference(lhs, rhs, tile_groups, bm=bm,
                              trans_rhs=trans_rhs, rows=rows,
                              row_scale=row_scale)
    raise ValueError(f"unsupported device {lhs.device}")


def tgmm(lhs, rhs, tile_groups, num_groups, *, bm, lhs_rows=None,
         rhs_rows=None, rhs_scale=None):
    """Transposed grouped matmul (the weight gradient):
    ``out[e] = Σ over e's rows of lhs[m, :]ᵀ ⊗ rhs[m, :]``.

    lhs: [M, K]; rhs: [M, N]; both row-grouped as in :func:`gmm`.
    ``lhs_rows`` / ``rhs_rows``: optional fused row gathers ([M] int32, as
    ``rows`` in :func:`gmm`): the named operand is then an un-permuted
    [L, dim] buffer indexed per padded row.  ``rhs_scale``: optional [M]
    multiplier, cast to rhs's dtype and applied to the gathered rhs rows in
    that dtype.  tile_groups: [M//bm] int32, nondecreasing.  A group that
    owns no tile gets zeros.  Returns [E, K, N] in lhs.dtype (fp32
    accumulation).

    CUDA tensors launch a Hopper kernel (the route :func:`_route` picks);
    CPU tensors take the plain version.
    """
    M = lhs_rows.shape[0] if lhs_rows is not None else lhs.shape[0]
    if M % bm:
        raise ValueError(f"M ({M}) must be a multiple of bm ({bm})")
    if lhs.device.type == "cuda":
        return _cuda_tgmm(lhs, rhs, tile_groups, num_groups, bm, lhs_rows,
                          rhs_rows, rhs_scale)
    if lhs.device.type == "cpu":
        return _tgmm_reference(lhs, rhs, tile_groups, num_groups, bm=bm,
                               lhs_rows=lhs_rows, rhs_rows=rhs_rows,
                               rhs_scale=rhs_scale)
    raise ValueError(f"unsupported device {lhs.device}")


class _GroupedMatmul(torch.autograd.Function):
    """The counterpart of the reference's ``grouped_matmul`` custom VJP."""

    @staticmethod
    def forward(ctx, lhs, rhs, tile_groups, num_groups, bm):
        ctx.save_for_backward(lhs, rhs, tile_groups)
        ctx.num_groups, ctx.bm = num_groups, bm
        return gmm(lhs, rhs, tile_groups, bm=bm)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, tile_groups = ctx.saved_tensors
        dy = dy.contiguous()
        # dlhs[m] = dy[m] @ rhs[g]ᵀ: rhs's [E, C, O] is the trans_rhs
        # [E, out, contract] layout of this product
        dlhs = gmm(dy, rhs, tile_groups, bm=ctx.bm, trans_rhs=True)
        drhs = tgmm(lhs, dy, tile_groups, ctx.num_groups, bm=ctx.bm)
        return dlhs.to(lhs.dtype), drhs.to(rhs.dtype), None, None, None


def grouped_matmul(lhs, rhs, tile_groups, num_groups, bm=512):
    """Differentiable grouped matmul: :func:`gmm` forward; the backward runs
    ``gmm`` against the transposed expert weights (dlhs) and :func:`tgmm`
    (drhs).  lhs [M, C] row-grouped, rhs [E, C, O]; returns [M, O]."""
    return _GroupedMatmul.apply(lhs, rhs, tile_groups, num_groups, bm)


# Paddle-API tensors handed to a kernel's entry run it on plain tensors
from ..core.tensor import plain_module  # noqa: E402

plain_module(globals())
