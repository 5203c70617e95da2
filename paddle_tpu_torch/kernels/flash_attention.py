"""Flash attention, forward and backward, layout ``[b, s, h, d]`` (port of
``paddle_tpu/kernels/flash_attention.py``).

:class:`_FlashAttention` is a ``torch.autograd.Function`` (the counterpart
of the reference's ``_fa_core`` custom VJP): the forward returns ``out`` and
keeps ``lse`` (fp32 ``[b, hq, sq]``); the backward forms
``delta = rowsum(dO * out)`` and calls dQ and dK/dV with the kernels' own
formulas ``p = exp(s - lse)``, ``ds = p * (dp - delta)``.  The mask, the
segment ids and the seed are data: their cotangents are ``None`` (the
reference's ``zeros``).

- On CUDA tensors each of the three steps launches a hand-written Hopper
  kernel (it replaces the Pallas ``_fa_fwd_kernel``, ``_fa_bwd_dq_kernel``
  and ``_fa_bwd_dkv_kernel``); every launch adds one to
  :data:`LAUNCHES_FWD`, :data:`LAUNCHES_BWD_DQ` or :data:`LAUNCHES_BWD_DKV`,
  whatever the mode.  All three take the route :func:`_route` picks by
  dtype and head dim, so a forward and its backward never take different
  routes: ``"sm90"`` (bf16 at d 64 and 128:
  ``csrc/flash_attention_fwd_sm90.cu`` and
  ``csrc/flash_attention_bwd_sm90.cu``, wgmma fed by TMA rings, also
  counted in :data:`LAUNCHES_FWD_SM90`, :data:`LAUNCHES_BWD_DQ_SM90` and
  :data:`LAUNCHES_BWD_DKV_SM90`) or ``"mma"`` (fp32, and bf16 at d 96 and
  256: ``csrc/flash_attention.cu``).  A shape the kernels do not take
  raises; nothing falls back to another route.
- On CPU tensors the same steps run their plain PyTorch versions
  (:func:`_reference_attention_lse`, :func:`_flash_bwd_dq`,
  :func:`_flash_bwd_dkv`), the tests' oracle.

Every mode of the reference's kernels, each composable with the others and
with causal:

- GQA: key/value may have fewer heads (a divisor of the query heads);
- ``mask``: an additive mask ``[b|1, 1|hq, sq, sk]``, taken as fp32 and
  added to the scores before the causal and segment masks;
- ``seg_q`` / ``seg_k``: segment ids per token (``[b, sq]``, ``[b, sk]``);
  a query sees only the keys of its own segment (:func:`flash_attn_varlen`);
- ``drop_p`` / ``seed``: dropout on the probabilities, from a hash of
  (seed, batch, q-head, row, column) equal bit for bit to the reference's
  (:func:`_drop_keep_dense`); the seed is a one-element int32 tensor.

A row whose every key is masked (-1e30) gets, as in the reference's kernel,
the uniform average over the keys it visits: every key of the row when not
causal.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

# Launches of each CUDA kernel since import (or the last reset by a caller).
LAUNCHES_FWD = 0
LAUNCHES_BWD_DQ = 0
LAUNCHES_BWD_DKV = 0
# the launches that took the "sm90" route (a part of the above)
LAUNCHES_FWD_SM90 = 0
LAUNCHES_BWD_DQ_SM90 = 0
LAUNCHES_BWD_DKV_SM90 = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 96, 128, 256)
_SEED_RANGE = 1 << 23            # seeds are drawn in [0, 2^23), as the reference's

# _drop_mix's constants (reference :150)
_U32 = 0xFFFFFFFF
_C_ROW, _C_COL = 2654435761, 1013904223
_C_SEED, _C_B, _C_H = 2246822519, 3266489917, 668265263


# ---------------------------------------------------------------- dropout ---

def _drop_threshold(drop_p):
    """A position is kept when its hash is >= this (reference :147)."""
    return min(int(drop_p * (1 << 32)), (1 << 32) - 1)


def _drop_scale(drop_p):
    """``1 / (1 - p)`` as the fp32 the kernels multiply by."""
    return torch.tensor(1.0 / (1.0 - drop_p), dtype=torch.float32)


def _mul32(x, c):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant ``c``,
    without leaving int64 (c is split into 16-bit halves)."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & _U32


def _drop_mix(z):
    """The reference's murmur3-style finalizer (:155-159) on int64 holding
    uint32 values (CPU uint32 has no shift or compare in torch)."""
    z = z ^ (z >> 16)
    z = _mul32(z, _C_SEED)
    z = z ^ (z >> 13)
    z = _mul32(z, _C_B)
    return z ^ (z >> 16)


def _seed_u32(seed):
    """The seed as the hash takes it: int32 (an fp32 seed below 2^23 is
    truncated, as ``_seed_u32`` :125 does) read as uint32, in an int64
    tensor of one element."""
    if not torch.is_tensor(seed):
        seed = torch.tensor([int(seed)], dtype=torch.int32)
    return seed.reshape(-1)[:1].to(torch.int32).to(torch.int64) & _U32


def _drop_keep_dense(shape4, seed, drop_p, device=None):
    """Keep-mask over a dense ``[b, h, sq, sk]`` score tensor, bit for bit
    the reference's ``_drop_keep_dense`` (:163): the hash of (seed, batch,
    head, row, column) >= ``drop_p * 2^32``."""
    b, h, sq, sk = shape4
    s = _seed_u32(seed)
    device = s.device if device is None else device
    s = s.to(device)
    i64 = dict(dtype=torch.int64, device=device)
    rc = _mul32(torch.arange(sq, **i64), _C_ROW)[:, None] ^ \
        _mul32(torch.arange(sk, **i64), _C_COL)[None, :]
    bh = _mul32(torch.arange(b, **i64), _C_B)[:, None] ^ \
        _mul32(torch.arange(h, **i64), _C_H)[None, :] ^ _mul32(s, _C_SEED)
    z = _drop_mix(rc[None, None] ^ bh[:, :, None, None])
    return z >= _drop_threshold(drop_p)


def _draw_seed(device, generator=None):
    """One seed in [0, 2^23) per call, an int32 tensor ``[1]`` on ``device``,
    drawn from ``generator`` or the device's default generator (no host
    sync).  The tests replace it to feed the reference's seed."""
    return torch.randint(0, _SEED_RANGE, (1,), generator=generator,
                         device=device, dtype=torch.int32)


# --------------------------------------------------------------- oracles ---

def _heads_first(x, group=1):
    """[b, s, h, d] -> fp32 [b, h * group, s, d] (each head repeated
    ``group`` times, as the reference's repeat for GQA)."""
    x = x.transpose(1, 2).float()
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _scores(q, k, causal, mask=None, seg_q=None, seg_k=None):
    """Scaled fp32 scores [b, hq, sq, sk]: the additive mask added, then
    -1e30 past the causal diagonal (bottom-right) and between segments."""
    group = q.shape[2] // k.shape[2]
    qh, kh = _heads_first(q), _heads_first(k, group)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (1.0 / math.sqrt(q.shape[-1]))
    if mask is not None:
        s = s + mask.float()
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        cm = torch.ones((sq, sk), dtype=torch.bool,
                        device=q.device).tril(diagonal=sk - sq)
        s = torch.where(cm, s, torch.full_like(s, NEG_INF))
    if seg_q is not None:
        same = seg_q[:, :, None] == seg_k[:, None, :]
        s = torch.where(same[:, None], s, torch.full_like(s, NEG_INF))
    return s


def _reference_attention_lse(q, k, v, causal, mask=None, seg_q=None,
                             seg_k=None, drop_p=0.0, seed=None):
    """Plain forward: ``out`` [b, sq, hq, d] in q's dtype and ``lse``
    fp32 [b, hq, sq].  The kernel's finalisation: ``p = exp(s - max)``,
    ``out = (dropout(p) @ v) / sum(p)``, ``lse = max + log(sum(p))``, so a
    row with every key at -1e30 averages its keys, as the kernel does."""
    s = _scores(q, k, causal, mask, seg_q, seg_k)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(denom))[..., 0]
    if drop_p:
        keep = _drop_keep_dense(p.shape, seed, drop_p, p.device)
        p = torch.where(keep, p, 0.0) * _drop_scale(drop_p).to(p.device)
    vh = _heads_first(v, q.shape[2] // v.shape[2])
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh) / denom
    return out.transpose(1, 2).to(q.dtype), lse


def _reference_attention(q, k, v, causal, mask=None, seg_q=None, seg_k=None,
                         drop_p=0.0, seed=None):
    return _reference_attention_lse(q, k, v, causal, mask, seg_q, seg_k,
                                    drop_p, seed)[0]


def _probs_and_ds(q, k, v, dout, lse, delta, causal, mask=None, seg_q=None,
                  seg_k=None, drop_p=0.0, seed=None):
    """The backward kernels' shared step, fp32 [b, hq, sq, sk]: ``p =
    exp(s - lse)``; ``dp = dO v^T``, with dropout kept at ``1/(1-p)`` and
    dropped at 0; ``ds = p * (dp - delta)``.  Returns ``(pd, ds)``, ``pd``
    the probabilities dV sees (dropped and rescaled like ``dp``)."""
    p = torch.exp(_scores(q, k, causal, mask, seg_q, seg_k) - lse[..., None])
    vh = _heads_first(v, q.shape[2] // v.shape[2])
    dp = torch.einsum("bhqd,bhkd->bhqk", _heads_first(dout), vh)
    pd = p
    if drop_p:
        keep = _drop_keep_dense(p.shape, seed, drop_p, p.device)
        inv = _drop_scale(drop_p).to(p.device)
        dp = torch.where(keep, dp, 0.0) * inv
        pd = torch.where(keep, p, 0.0) * inv
    return pd, p * (dp - delta[..., None])


def _flash_bwd_dq(q, k, v, dout, lse, delta, causal, mask=None, seg_q=None,
                  seg_k=None, drop_p=0.0, seed=None):
    """Plain dQ (``_fa_bwd_dq_kernel``): ``scale * ds @ k``, in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, mask, seg_q,
                          seg_k, drop_p, seed)
    kh = _heads_first(k, q.shape[2] // k.shape[2])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * (1.0 / math.sqrt(q.shape[-1]))
    return dq.transpose(1, 2).to(q.dtype)


def _flash_bwd_dkv(q, k, v, dout, lse, delta, causal, mask=None, seg_q=None,
                   seg_k=None, drop_p=0.0, seed=None):
    """Plain dK/dV (``_fa_bwd_dkv_kernel``): per-q-head fp32 partials
    ``ds^T @ (scale q)`` and ``pd^T @ dO``, summed over each GQA group
    (reference ``:610``), then cast to k's and v's dtypes."""
    b, sk, hkv, d = k.shape
    group = q.shape[2] // hkv
    pd, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, mask, seg_q,
                           seg_k, drop_p, seed)
    qh = _heads_first(q) * (1.0 / math.sqrt(d))
    dk_p = torch.einsum("bhqk,bhqd->bhkd", ds, qh)     # [b, hq, sk, d]
    dv_p = torch.einsum("bhqk,bhqd->bhkd", pd, _heads_first(dout))
    dk = dk_p.reshape(b, hkv, group, sk, d).sum(dim=2)
    dv = dv_p.reshape(b, hkv, group, sk, d).sum(dim=2)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def _delta(out, dout):
    """``rowsum(dO * out)`` in fp32, [b, hq, sq] (reference ``:558``)."""
    return (out.float() * dout.float()).sum(dim=-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------- kernels ---

# mask, mask batch stride, mask head stride, seg_q, seg_k, seed, keep
# threshold, 1/(1-p); then the dims, dtype and the stream
_MODE_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float]
_TAIL_ARGS = _MODE_ARGS + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# library (``csrc/<name>.cu``) -> C entry point -> its argument types
ENTRY_POINTS = {
    "flash_attention": {
        "ptt_flash_fwd": [ctypes.c_void_p] * 5 + _TAIL_ARGS,
        "ptt_flash_bwd_dq": [ctypes.c_void_p] * 7 + _TAIL_ARGS,
        "ptt_flash_bwd_dkv": [ctypes.c_void_p] * 8 + _TAIL_ARGS,
    },
    "flash_attention_fwd_sm90": {
        "ptt_flash_fwd_sm90": [ctypes.c_void_p] * 5 + _TAIL_ARGS,
    },
    "flash_attention_bwd_sm90": {
        "ptt_flash_bwd_dq_sm90": [ctypes.c_void_p] * 7 + _TAIL_ARGS,
        "ptt_flash_bwd_dkv_sm90": [ctypes.c_void_p] * 8 + _TAIL_ARGS,
    },
}


def _setup(lib, name):
    """Sets the argument and result types of library ``name``'s entry
    points on ``lib`` (once)."""
    for fn_name, argtypes in ENTRY_POINTS[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _lib(name="flash_attention"):
    from . import _build
    return _setup(_build.load(name), name)


# the reference's flash_attention_block_q / _kv defaults
PALLAS_BLOCK = 512


def pallas_shape(sq, sk, d) -> bool:
    """Whether the reference's flash entry takes its Pallas kernels (not
    its XLA fallback) at these lengths and head dim: its blocks, min(512,
    s), must divide both lengths, and d must be 64, 96 or a multiple of 128
    (``paddle_tpu/kernels/flash_attention.py`` ``_blocks_for``).  The
    callers that ask the reference's question route by it."""
    bq, bkv = min(PALLAS_BLOCK, sq), min(PALLAS_BLOCK, sk)
    return sq % bq == 0 and sk % bkv == 0 and (d % 128 == 0 or
                                                d in (64, 96))


def _route(dtype, d):
    """The route of all three kernels for inputs of ``dtype`` at head dim
    ``d``: ``"sm90"`` (bf16 at d 64 and 128) or ``"mma"`` (the rest: fp32,
    where wgmma would need TF32, and bf16 at d 96, which wgmma's 64-column
    swizzle blocks do not tile, and 256, whose two 64 x 256 fp32
    accumulators do not fit a warpgroup's registers)."""
    return "sm90" if dtype == torch.bfloat16 and d in (64, 128) else "mma"


class _Modes:
    """The mode operands of one launch, checked and laid out for the
    kernels: fp32 mask with its batch and head strides (0 where the mask
    broadcasts), int32 segment ids, the int32 seed and the dropout
    threshold and scale."""

    def __init__(self, q, k, mask, seg_q, seg_k, drop_p, seed):
        dev = q.device
        b, sq, hq, _ = q.shape
        sk = k.shape[1]
        self.keep = []                      # tensors the launch reads
        self.mask, self.mask_sb, self.mask_sh = 0, 0, 0
        if mask is not None:
            if mask.device != dev:
                raise ValueError(f"attn_mask is on {mask.device}, query on "
                                 f"{dev}")
            if mask.dim() != 4 or tuple(mask.shape[2:]) != (sq, sk) or \
                    mask.shape[0] not in (1, b) or mask.shape[1] not in (1, hq):
                raise ValueError(f"attn_mask {tuple(mask.shape)} is not "
                                 f"[{b}|1, {hq}|1, {sq}, {sk}]")
            m = mask.float().contiguous()
            self.keep.append(m)
            self.mask = m.data_ptr()
            self.mask_sh = sq * sk if m.shape[1] > 1 else 0
            self.mask_sb = m.shape[1] * sq * sk if m.shape[0] > 1 else 0
        self.seg_q = self.seg_k = 0
        if (seg_q is None) != (seg_k is None):
            raise ValueError("seg_q and seg_k go together")
        if seg_q is not None:
            for name, s, n in (("seg_q", seg_q, sq), ("seg_k", seg_k, sk)):
                if s.device != dev:
                    raise ValueError(f"{name} is on {s.device}, query on {dev}")
                if tuple(s.shape) != (b, n):
                    raise ValueError(f"{name} {tuple(s.shape)} is not "
                                     f"[{b}, {n}]")
                if s.dtype.is_floating_point or s.dtype == torch.bool:
                    raise TypeError(f"{name} must hold integer ids, got "
                                    f"{s.dtype}")
            sq_i = seg_q.to(torch.int32).contiguous()
            sk_i = seg_k.to(torch.int32).contiguous()
            self.keep += [sq_i, sk_i]
            self.seg_q, self.seg_k = sq_i.data_ptr(), sk_i.data_ptr()
        self.seed, self.thresh, self.inv = 0, 0, 1.0
        if drop_p:
            if not 0.0 < drop_p < 1.0:
                raise ValueError(f"dropout {drop_p} is not in (0, 1)")
            if seed is None or not torch.is_tensor(seed) or \
                    seed.numel() != 1 or seed.device != dev:
                raise ValueError(f"dropout needs a one-element seed tensor "
                                 f"on {dev}")
            s = seed.reshape(1).to(torch.int32).contiguous()
            self.keep.append(s)
            self.seed = s.data_ptr()
            self.thresh = _drop_threshold(drop_p)
            self.inv = float(_drop_scale(drop_p))
        if any(t.data_ptr() % 4 for t in self.keep):
            raise ValueError("flash attention's mask, segment ids and seed "
                             "must be 4-byte aligned")

    def args(self):
        return (self.mask, self.mask_sb, self.mask_sh, self.seg_q, self.seg_k,
                self.seed, self.thresh, self.inv)


def _check_cuda(q, k, v, causal, extra=()):
    """What the kernels take: [b, s, h, d] tensors on one sm_90 device,
    float32 or bfloat16 alike, d 64, 96, 128 or 256, hkv dividing hq, and
    for a causal call sq <= sk (every query row sees a key).  Returns the
    contiguous operands (a no-op for the projections' output)."""
    dev = q.device
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError("the flash-attention kernels are built for sm_90a "
                           "(H100/H200)")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, x in (("key", k), ("value", v), *extra):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, query on {dev}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, query {q.dtype}")
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or \
            k.shape[3] != d:
        raise ValueError(f"key/value {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not fit query {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported by the kernels "
                         f"(one of {_HEAD_DIMS})")
    if hq % k.shape[2]:
        raise ValueError(f"kv heads ({k.shape[2]}) must divide query heads "
                         f"({hq})")
    if sq == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if causal and sq > k.shape[1]:
        raise ValueError(f"causal attention with sq ({sq}) > sk "
                         f"({k.shape[1]}) leaves rows without keys")
    out = [x.contiguous() for x in (q, k, v, *(t for _, t in extra))]
    if any(x.data_ptr() % 16 for x in out):
        raise ValueError("flash attention operands must be 16-byte aligned")
    return out


def _dims(q, k, causal):
    b, sq, hq, d = q.shape
    return (b, sq, k.shape[1], hq, k.shape[2], d, int(bool(causal)),
            _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _entry(q, which):
    """The C entry point of kernel ``which`` ("fwd", "bwd_dq" or
    "bwd_dkv") on ``q``'s route, and whether that route is "sm90"."""
    if _route(q.dtype, q.shape[-1]) == "sm90":
        lib = "flash_attention_fwd_sm90" if which == "fwd" else \
            "flash_attention_bwd_sm90"
        return getattr(_lib(lib), f"ptt_flash_{which}_sm90"), True
    return getattr(_lib(), f"ptt_flash_{which}"), False


def _cuda_fwd(q, k, v, causal, mask=None, seg_q=None, seg_k=None, drop_p=0.0,
              seed=None):
    global LAUNCHES_FWD, LAUNCHES_FWD_SM90
    q, k, v = _check_cuda(q, k, v, causal)
    md = _Modes(q, k, mask, seg_q, seg_k, drop_p, seed)
    b, sq, hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn, sm90 = _entry(q, "fwd")
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), *md.args(), *_dims(q, k, causal)),
              "flash_fwd")
    LAUNCHES_FWD += 1
    LAUNCHES_FWD_SM90 += sm90
    return out, lse


def _cuda_bwd_dq(q, k, v, dout, lse, delta, causal, mask=None, seg_q=None,
                 seg_k=None, drop_p=0.0, seed=None):
    global LAUNCHES_BWD_DQ, LAUNCHES_BWD_DQ_SM90
    q, k, v, dout = _check_cuda(q, k, v, causal, (("dout", dout),))
    md = _Modes(q, k, mask, seg_q, seg_k, drop_p, seed)
    dq = torch.empty_like(q)
    fn, sm90 = _entry(q, "bwd_dq")
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *md.args(),
                 *_dims(q, k, causal)), "flash_bwd_dq")
    LAUNCHES_BWD_DQ += 1
    LAUNCHES_BWD_DQ_SM90 += sm90
    return dq


def _cuda_bwd_dkv(q, k, v, dout, lse, delta, causal, mask=None, seg_q=None,
                  seg_k=None, drop_p=0.0, seed=None):
    global LAUNCHES_BWD_DKV, LAUNCHES_BWD_DKV_SM90
    q, k, v, dout = _check_cuda(q, k, v, causal, (("dout", dout),))
    md = _Modes(q, k, mask, seg_q, seg_k, drop_p, seed)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn, sm90 = _entry(q, "bwd_dkv")
    _raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), *md.args(), *_dims(q, k, causal)),
              "flash_bwd_dkv")
    LAUNCHES_BWD_DKV += 1
    LAUNCHES_BWD_DKV_SM90 += sm90
    return dk, dv


# ------------------------------------------------------- device dispatch ---

def _on(x, cpu, cuda):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return cpu
    if x.device.type == "cuda":
        return cuda
    raise NotImplementedError(f"flash attention has no kernel for device "
                              f"{x.device}")


def flash_forward(q, k, v, causal, mask=None, seg_q=None, seg_k=None,
                  drop_p=0.0, seed=None):
    """``(out, lse)``: out [b, sq, hq, d] in q's dtype, lse fp32
    [b, hq, sq]."""
    return _on(q, _reference_attention_lse, _cuda_fwd)(
        q, k, v, causal, mask, seg_q, seg_k, drop_p, seed)


def flash_backward(q, k, v, out, lse, dout, causal, mask=None, seg_q=None,
                   seg_k=None, drop_p=0.0, seed=None):
    """``(dq, dk, dv)`` of attention at ``(q, k, v)`` for the cotangent
    ``dout``, from the forward's ``out`` and ``lse`` (same modes)."""
    delta = _delta(out, dout)
    modes = (mask, seg_q, seg_k, drop_p, seed)
    dq = _on(q, _flash_bwd_dq, _cuda_bwd_dq)(q, k, v, dout, lse, delta,
                                             causal, *modes)
    dk, dv = _on(q, _flash_bwd_dkv, _cuda_bwd_dkv)(q, k, v, dout, lse, delta,
                                                   causal, *modes)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's ``_fa_core`` custom VJP; the
    mask, segment ids and seed get no cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seg_q, seg_k, seed, causal, drop_p):
        out, lse = flash_forward(q, k, v, causal, mask, seg_q, seg_k, drop_p,
                                 seed)
        ctx.save_for_backward(q, k, v, out, lse, mask, seg_q, seg_k, seed)
        ctx.causal, ctx.drop_p = causal, drop_p
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask, seg_q, seg_k, seed = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.causal, mask,
                                    seg_q, seg_k, ctx.drop_p, seed)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_arrays(q, k, v, causal, mask=None, seg_q=None, seg_k=None,
                           drop_p=0.0, seed=None):
    """Differentiable attention over ``[b, s, h, d]`` tensors in any mode
    (the reference's ``_flash_attention_arrays`` :723): ``seed`` is a
    one-element tensor (or an int), needed when ``drop_p`` is set."""
    if drop_p and seed is None:
        raise ValueError("flash attention dropout requires a seed")
    if drop_p and not torch.is_tensor(seed):
        seed = torch.tensor([int(seed)], dtype=torch.int32, device=q.device)
    return _FlashAttention.apply(q, k, v, mask, seg_q, seg_k,
                                 seed if drop_p else None, bool(causal),
                                 float(drop_p))


def flash_attention(query, key, value, causal=False, attn_mask=None,
                    dropout=0.0, training=True, rng_name=None, generator=None):
    """Attention over ``[b, s, h, d]`` tensors, differentiable; GQA when
    key/value have fewer heads (a divisor of the query heads).

    ``attn_mask``: additive mask ``[b, 1|h, sq, sk]`` (taken as fp32).
    ``dropout``: probability dropout, active when ``training``; one seed in
    [0, 2^23) is drawn per call from ``generator`` or the default generator
    of the tensors' device, and given the seed the kept positions equal the
    reference's bit for bit.  ``rng_name`` is accepted and unused, as in the
    reference.  CUDA tensors launch the Hopper kernels, CPU tensors take the
    plain versions.
    """
    drop_p = float(dropout) if training else 0.0
    seed = _draw_seed(query.device, generator) if drop_p else None
    return flash_attention_arrays(query, key, value, causal, mask=attn_mask,
                                  drop_p=drop_p, seed=seed)


# --------------------------------------------------------------- varlen ---

def _segments_from_cu(cu, total):
    """cu_seqlens [B+1] -> (segment id, position in segment) per token
    (reference :777)."""
    tok = torch.arange(total, device=cu.device, dtype=cu.dtype)
    seg = torch.searchsorted(cu[1:].contiguous(), tok, right=True)
    return seg, tok - cu[seg]


def flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, causal=False):
    """Unpadded variable-length attention: q/k/v ``[total, heads, dim]``
    packed back to back, ``cu_seqlens`` ``[batch + 1]`` cumulative lengths.
    Tokens attend only within their own segment (the kernels' segment
    mode: per-token ids, no ``[T, T]`` mask), causally if asked; causal
    needs identical q and k packings (checked eagerly, as the
    reference)."""
    tq, tk = q.shape[0], k.shape[0]
    if causal:
        if tq != tk or cu_seqlens_q.shape != cu_seqlens_k.shape:
            raise ValueError(
                "flash_attn_varlen(causal=True) requires identical "
                "q/k packings (cu_seqlens_q == cu_seqlens_k)")
        if not torch.equal(cu_seqlens_q, cu_seqlens_k):
            raise ValueError(
                "flash_attn_varlen(causal=True): cu_seqlens_q and "
                "cu_seqlens_k differ")
    seg_q, _ = _segments_from_cu(cu_seqlens_q, tq)
    seg_k, _ = _segments_from_cu(cu_seqlens_k, tk)
    out = flash_attention_arrays(q[None], k[None], v[None], causal,
                                 seg_q=seg_q[None], seg_k=seg_k[None])
    return out[0]


flash_attn_unpadded = flash_attn_varlen


# Paddle-API tensors handed to a kernel's entry run it on plain tensors
from ..core.tensor import plain_module  # noqa: E402

plain_module(globals())
