"""Weight-only quantization (port of the weight-only part of
``paddle_tpu/quantization/__init__.py``).

Quantized weights are plain int8 tensors with a per-output-channel fp32
scale: int8 ``[in, out]``, or int4 packed two nibbles per byte into
``[ceil(in/2), out]`` (low nibble = even row).  Every function runs on the
device of its inputs.  :func:`weight_only_linear` multiplies through
:func:`paddle_tpu_torch.kernels.weight_only.weight_only_matmul`: a CUDA
tensor launches the W8A16/W4A16 kernel, a CPU tensor takes its plain
version, any other device raises.

Not ported yet: ``llm_int8_linear``, the fake-quant and fp8 ops, and
``QuantConfig``/``QAT``/``PTQ`` (they need the ``nn.Layer`` surface).
"""

from __future__ import annotations

import torch

from ..kernels.weight_only import (_pack_int4, _unpack, _unpack_int4,
                                   weight_only_matmul)

ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")


def weight_quantize(x, algo="weight_only_int8", name=None):
    """``x``: [in, out] float weight -> (quantized weight, fp32 scale
    [out]).  ``scale = max(amax over in / qmax, 1e-10)`` by true division
    (bitwise the reference's), ``q = clip(round_half_even(w / scale),
    ±qmax)``; int4 (qmax 7) comes back packed (:func:`_pack_int4`)."""
    if algo not in ALGOS:
        raise ValueError(f"unknown weight_quantize algo {algo!r}")
    int4 = algo == "weight_only_int4"
    qmax = 7.0 if int4 else 127.0
    w = x.float()
    scale = torch.clamp_min(w.abs().amax(dim=0) / qmax, 1e-10)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    if int4:
        q = _pack_int4(q)
    return q, scale


def weight_dequantize(x, scale, algo="weight_only_int8", out_dtype="float32",
                      name=None, in_features=None):
    """``q.float() * scale`` in ``out_dtype``.  For int4, ``in_features``
    recovers an odd original row count (default: 2 * packed rows)."""
    int4 = algo == "weight_only_int4"
    rows = (in_features or 2 * x.shape[0]) if int4 else x.shape[0]
    if isinstance(out_dtype, str):
        out_dtype = getattr(torch, out_dtype)
    return (_unpack(x, int4, rows).float() * scale).to(out_dtype)


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1,
                       name=None):
    """``y = x @ dequant(weight) + bias``.  ``weight_dtype`` is ``"int8"``
    or ``"int4"`` (packed, from :func:`weight_quantize`); ``arch``,
    ``group_size`` and ``name`` are accepted and ignored, as the reference
    does.  The output takes ``x``'s dtype; the bias is added after the
    product in torch's type promotion (bf16 ``x`` with an fp32 bias gives
    fp32, as the reference's ``y + bias``)."""
    if weight_scale is None:
        raise ValueError(
            "weight_only_linear requires weight_scale (from weight_quantize)")
    int4 = weight_dtype == "int4"
    y = weight_only_matmul(x, weight, weight_scale.float(),
                           int4_rows=x.shape[-1] if int4 else None)
    if bias is not None:
        y = y + bias
    return y


__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear"]
