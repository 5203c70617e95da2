"""Flash attention, forward and backward, layout ``[b, s, h, d]`` (port of
``paddle_tpu/kernels/flash_attention.py``).

:func:`flash_attention` is a ``torch.autograd.Function`` (the counterpart of
the reference's ``_fa_core`` custom VJP): the forward returns ``out`` and
keeps ``lse`` (fp32 ``[b, hq, sq]``); the backward forms
``delta = rowsum(dO * out)`` and calls dQ and dK/dV with the kernels' own
formulas ``p = exp(s - lse)``, ``ds = p * (dp - delta)``.

- On CUDA tensors each of the three steps launches a hand-written Hopper
  kernel from ``csrc/flash_attention.cu`` (it replaces the Pallas
  ``_fa_fwd_kernel``, ``_fa_bwd_dq_kernel`` and ``_fa_bwd_dkv_kernel``);
  every launch adds one to :data:`LAUNCHES_FWD`, :data:`LAUNCHES_BWD_DQ` or
  :data:`LAUNCHES_BWD_DKV`.  A mode or shape the kernels do not take raises.
- On CPU tensors the same steps run their plain PyTorch versions
  (:func:`_reference_attention_lse`, :func:`_flash_bwd_dq`,
  :func:`_flash_bwd_dkv`), the tests' oracle.

GQA: key/value may have fewer heads (a divisor of the query heads).  The
reference's additive mask is taken by the plain version only; its segment
ids (``flash_attn_varlen``) and dropout are not ported.
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

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


# --------------------------------------------------------------- oracles ---

def _heads_first(x, group=1):
    """[b, s, h, d] -> fp32 [b, h * group, s, d] (each head repeated
    ``group`` times, as the reference's repeat for GQA)."""
    x = x.transpose(1, 2).float()
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _scores(q, k, causal, mask=None):
    """Scaled fp32 scores [b, hq, sq, sk] with the causal (and additive)
    mask applied, and the fp32 heads-first q, k."""
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
    return s


def _reference_attention_lse(q, k, v, causal, mask=None):
    """Plain forward: ``out`` [b, sq, hq, d] in q's dtype and ``lse``
    fp32 [b, hq, sq]."""
    s = _scores(q, k, causal, mask)
    lse = torch.logsumexp(s, dim=-1)                   # [b, h, sq]
    probs = torch.exp(s - lse[..., None])
    vh = _heads_first(v, q.shape[2] // v.shape[2])
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2).to(q.dtype), lse


def _reference_attention(q, k, v, causal, mask=None):
    return _reference_attention_lse(q, k, v, causal, mask)[0]


def _probs_and_ds(q, k, v, dout, lse, delta, causal, mask=None):
    """The backward kernels' shared step: ``p = exp(s - lse)`` and
    ``ds = p * (dO v^T - delta)``, both fp32 [b, hq, sq, sk]."""
    p = torch.exp(_scores(q, k, causal, mask) - lse[..., None])
    vh = _heads_first(v, q.shape[2] // v.shape[2])
    dp = torch.einsum("bhqd,bhkd->bhqk", _heads_first(dout), vh)
    return p, p * (dp - delta[..., None])


def _flash_bwd_dq(q, k, v, dout, lse, delta, causal, mask=None):
    """Plain dQ (``_fa_bwd_dq_kernel``): ``scale * ds @ k``, in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, mask)
    kh = _heads_first(k, q.shape[2] // k.shape[2])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * (1.0 / math.sqrt(q.shape[-1]))
    return dq.transpose(1, 2).to(q.dtype)


def _flash_bwd_dkv(q, k, v, dout, lse, delta, causal, mask=None):
    """Plain dK/dV (``_fa_bwd_dkv_kernel``): per-q-head fp32 partials
    ``ds^T @ (scale q)`` and ``p^T @ dO``, summed over each GQA group
    (reference ``:610``), then cast to k's and v's dtypes."""
    b, sk, hkv, d = k.shape
    group = q.shape[2] // hkv
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, mask)
    qh = _heads_first(q) * (1.0 / math.sqrt(d))
    dk_p = torch.einsum("bhqk,bhqd->bhkd", ds, qh)     # [b, hq, sk, d]
    dv_p = torch.einsum("bhqk,bhqd->bhkd", p, _heads_first(dout))
    dk = dk_p.reshape(b, hkv, group, sk, d).sum(dim=2)
    dv = dv_p.reshape(b, hkv, group, sk, d).sum(dim=2)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def _delta(out, dout):
    """``rowsum(dO * out)`` in fp32, [b, hq, sq] (reference ``:558``)."""
    return (out.float() * dout.float()).sum(dim=-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------- kernels ---

def _lib():
    from . import _build
    lib = _build.load("flash_attention")
    if lib.ptt_flash_fwd.argtypes is None:
        tail = [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.ptt_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.ptt_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.ptt_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
        for fn in (lib.ptt_flash_fwd, lib.ptt_flash_bwd_dq,
                   lib.ptt_flash_bwd_dkv):
            fn.restype = ctypes.c_int
    return lib


def _check_cuda(q, k, v, causal, extra=()):
    """What the kernels take: [b, s, h, d] tensors on one sm_90 device,
    float32 or bfloat16 alike, d 64 or 128, hkv dividing hq, and for a
    causal call sq <= sk (every query row sees a key).  Returns the
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
                         f"(64 or 128)")
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


def _cuda_fwd(q, k, v, causal):
    global LAUNCHES_FWD
    q, k, v = _check_cuda(q, k, v, causal)
    b, sq, hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _raise_on(_lib().ptt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), lse.data_ptr(),
                                   *_dims(q, k, causal)), "flash_fwd")
    LAUNCHES_FWD += 1
    return out, lse


def _cuda_bwd_dq(q, k, v, dout, lse, delta, causal):
    global LAUNCHES_BWD_DQ
    q, k, v, dout = _check_cuda(q, k, v, causal, (("dout", dout),))
    dq = torch.empty_like(q)
    _raise_on(_lib().ptt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_dims(q, k, causal)), "flash_bwd_dq")
    LAUNCHES_BWD_DQ += 1
    return dq


def _cuda_bwd_dkv(q, k, v, dout, lse, delta, causal):
    global LAUNCHES_BWD_DKV
    q, k, v, dout = _check_cuda(q, k, v, causal, (("dout", dout),))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _raise_on(_lib().ptt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, causal)), "flash_bwd_dkv")
    LAUNCHES_BWD_DKV += 1
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


def flash_forward(q, k, v, causal):
    """``(out, lse)``: out [b, sq, hq, d] in q's dtype, lse fp32
    [b, hq, sq]."""
    return _on(q, _reference_attention_lse, _cuda_fwd)(q, k, v, causal)


def flash_backward(q, k, v, out, lse, dout, causal):
    """``(dq, dk, dv)`` of attention at ``(q, k, v)`` for the cotangent
    ``dout``, from the forward's ``out`` and ``lse``."""
    delta = _delta(out, dout)
    dq = _on(q, _flash_bwd_dq, _cuda_bwd_dq)(q, k, v, dout, lse, delta,
                                             causal)
    dk, dv = _on(q, _flash_bwd_dkv, _cuda_bwd_dkv)(q, k, v, dout, lse, delta,
                                                   causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's ``_fa_core`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attention(query, key, value, causal=False, attn_mask=None,
                    dropout=0.0, training=True):
    """Attention over ``[b, s, h, d]`` tensors, differentiable; GQA when
    key/value have fewer heads (a divisor of the query heads).

    CUDA tensors launch the Hopper kernels (forward, and dQ and dK/dV in
    the backward); CPU tensors take the plain versions.  ``attn_mask`` (an
    additive fp32 mask ``[b, 1|h, sq, sk]``) runs on the plain version only
    and raises on CUDA tensors; ``dropout`` is not ported and raises.
    """
    if dropout and training:
        raise NotImplementedError(
            "flash_attention dropout (the reference's in-kernel _drop_mix "
            "keep-mask) is not ported (ROADMAP Queue 2 item 5)")
    if attn_mask is not None:
        if query.device.type != "cpu":
            raise NotImplementedError(
                "flash_attention's additive attn_mask has no Hopper kernel "
                "yet (ROADMAP Queue 2 item 5); only the plain version on "
                "CPU tensors takes it")
        return _reference_attention(query, key, value, causal, attn_mask)
    return _FlashAttention.apply(query, key, value, bool(causal))
