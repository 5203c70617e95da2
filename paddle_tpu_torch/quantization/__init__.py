"""``paddle.quantization`` (the port of
``paddle_tpu/quantization/__init__.py``): weight-only and LLM.int8
matmuls, fake quantization with straight-through gradients, the QAT / PTQ
flows, and fp8 scaling and matmuls.

Quantized weights are plain int8 tensors with a per-output-channel fp32
scale: int8 ``[in, out]``, or int4 packed two nibbles per byte into
``[ceil(in/2), out]`` (low nibble = even row).  Every function runs on the
device of its inputs.  :func:`weight_only_linear` multiplies through
:func:`paddle_tpu_torch.kernels.weight_only.weight_only_matmul`: a CUDA
tensor launches the W8A16/W4A16 kernel, a CPU tensor takes its plain
version, any other device raises.  The rest is XLA in the reference and
plain PyTorch here; its fp32 products run with TF32 off.

- fp8 casts follow the reference's: a value that rounds past
  ``float8_e4m3fn``'s 448 (``|v| > 464``, or an infinity) becomes NaN,
  where torch's own cast saturates; ``float8_e5m2`` overflows to inf in
  both.
- :class:`AbsmaxObserver` reads each calibration batch's abs-max to the
  host (a sync, during calibration only).
"""

from __future__ import annotations

import contextlib

import torch

from ..dtypes import convert_dtype
from ..kernels.weight_only import (_pack_int4, _unpack, _unpack_int4,
                                   weight_only_matmul)
from ..nn.layer import Layer

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




@contextlib.contextmanager
def _full_fp32():
    """fp32 matmuls without TF32 (the reference's fp32 products)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def llm_int8_linear(x, weight, bias=None, weight_scale=None, threshold=6.0,
                    name=None):
    """Outlier-aware int8 matmul: feature columns whose abs-max over the
    rows exceeds ``threshold`` multiply in fp32 against the dequantized
    weight, the rest through per-row int8 activation codes
    (``round_half_even(a / (amax / 127))``) against the int8 weight, the
    code products summed in fp32.  Output in x's dtype."""
    if weight_scale is None:
        raise ValueError(
            "llm_int8_linear requires weight_scale (from weight_quantize)")
    af = x.float()
    outlier = af.abs().amax(dim=tuple(range(af.dim() - 1))) > threshold
    qf = weight.float()
    a_out = torch.where(outlier, af, 0.0)
    a_in = torch.where(outlier, 0.0, af)
    a_scale = torch.clamp_min(a_in.abs().amax(dim=-1, keepdim=True) / 127.0,
                              1e-10)
    a_q = torch.round(a_in / a_scale)
    with _full_fp32():
        y = (a_q @ qf) * a_scale * weight_scale + a_out @ (qf * weight_scale)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


# ---- fake quantization (QAT / PTQ simulation) ----

def _straight_through(v, q):
    """``q`` forward, identity gradient to ``v``."""
    return v + (q - v).detach()


def fake_quantize_abs_max(x, bits: int = 8):
    """Per-tensor fake quantization with a straight-through gradient:
    ``round(x / s) * s``, ``s = max(amax / qmax, 1e-8)``."""
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp_min(x.detach().abs().amax() / qmax, 1e-8)
    return _straight_through(x, torch.round(x / scale) * scale)


def fake_channel_wise_quantize_abs_max(x, bits: int = 8, quant_axis: int = 0):
    """Per-channel (along ``quant_axis``) fake quantization with a
    straight-through gradient."""
    qmax = float(2 ** (bits - 1) - 1)
    dims = tuple(i for i in range(x.dim()) if i != quant_axis)
    scale = torch.clamp_min(
        x.detach().abs().amax(dim=dims, keepdim=True) / qmax, 1e-8)
    return _straight_through(x, torch.round(x / scale) * scale)


def quant_with_scale(x, scale, bits: int = 8):
    """Fake quantization with a fixed ``scale``:
    ``clip(round(x / scale), ±qmax) * scale``, straight-through."""
    qmax = float(2 ** (bits - 1) - 1)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax) * scale
    return _straight_through(x, q)


def fake_channel_wise_dequantize_max_abs(x, scales, quant_bits=(8,),
                                         quant_axis=0, name=None):
    """``x * scales / qmax`` in fp32, ``scales`` along ``quant_axis``."""
    bits = quant_bits[0] if isinstance(quant_bits, (list, tuple)) \
        else quant_bits
    qmax = float(2 ** (int(bits) - 1) - 1)
    shape = [1] * x.dim()
    shape[quant_axis] = -1
    return x.float() * (scales.reshape(shape) / qmax)


# ---- configuration ----

class QuantConfig:
    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight
        self._layer_configs = {}

    def add_layer_config(self, layer, activation=None, weight=None):
        self._layer_configs[id(layer)] = (activation, weight)


class FakeQuanterWithAbsMax(Layer):
    def __init__(self, bits=8, **kw):
        super().__init__()
        self.bits = bits

    def forward(self, x):
        return fake_quantize_abs_max(x, self.bits)


class AbsmaxObserver(Layer):
    """PTQ observer: the running abs-max of the activations it sees, read
    to the host at each batch (calibration only)."""

    def __init__(self, bits=8, **kw):
        super().__init__()
        self.bits = bits
        self.absmax = 0.0

    def forward(self, x):
        self.absmax = max(self.absmax, float(x.detach().abs().amax()))
        return x

    @property
    def scale(self):
        qmax = float(2 ** (self.bits - 1) - 1)
        return max(self.absmax / qmax, 1e-8)


def _linears(model):
    from .. import nn
    return [sub for _, sub in list(model.named_sublayers())
            if isinstance(sub, nn.Linear)]


class QAT:
    """Quantization-aware training: every ``Linear`` of the model sees its
    input through a :class:`FakeQuanterWithAbsMax`."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model, inplace=False):
        for sub in _linears(model):
            def wrapped(x, _f=sub.forward, _q=FakeQuanterWithAbsMax()):
                return _f(_q(x))
            sub.forward = wrapped
        return model


class PTQ:
    """Post-training quantization::

        m = PTQ(QuantConfig()).quantize(model)      # insert observers
        for batch in calibration_data: m(batch)     # calibrate
        q = PTQ.convert(m)                          # freeze scales

    After ``convert`` each ``Linear``'s weight holds its per-channel int8
    round trip (copied in place under ``no_grad``) and its input is
    fake-quantized with the frozen calibration scale."""

    def __init__(self, config: QuantConfig | None = None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace=False):
        observed = _linears(model)
        for sub in observed:
            obs = AbsmaxObserver()
            orig_forward = sub.forward

            def wrapped(x, _f=orig_forward, _o=obs):
                return _f(_o(x))
            sub.forward = wrapped
            sub._ptq_observer = obs
            sub._ptq_forward = orig_forward
        model._ptq_observed = observed
        return model

    @staticmethod
    def convert(model, inplace=True):
        for sub in getattr(model, "_ptq_observed", []):
            with torch.no_grad():
                sub.weight.copy_(fake_channel_wise_quantize_abs_max(
                    sub.weight, bits=8, quant_axis=1))

            def converted(x, _f=sub._ptq_forward, _s=sub._ptq_observer.scale):
                return _f(quant_with_scale(x, _s))
            sub.forward = converted
        return model


# ---- fp8 ----

_FP8_DTYPES = {"e4m3": torch.float8_e4m3fn,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "e5m2": torch.float8_e5m2, "float8_e5m2": torch.float8_e5m2}
_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
# float8_e4m3fn has no infinity: past the midpoint of 448 and 480 (and at
# an infinity) the reference's cast gives NaN
_E4M3_NAN_ABOVE = 464.0


def _to_fp8(v, dt):
    if dt == torch.float8_e4m3fn:
        v = torch.where(v.abs() > _E4M3_NAN_ABOVE, float("nan"), v)
    return v.to(dt)


def fp8_quantize(x, scale=None, dtype="e4m3"):
    """Scaled cast to fp8: ``(fp8(x / scale), scale)`` with an fp32
    ``scale``; without one, ``max(amax * (1 / fp8_max), 1e-12)`` (on the
    device, no host read)."""
    dt = _FP8_DTYPES[dtype]
    vf = x.float()
    if scale is not None:
        s = torch.as_tensor(scale, device=x.device).float()
    else:
        # amax / fp8_max as a multiply by the fp32 reciprocal: the
        # reference's XLA lowers its division by the constant that way
        s = torch.clamp_min(vf.abs().amax() * (1.0 / _FP8_MAX[dt]), 1e-12)
    return _to_fp8(vf / s, dt), s


def fp8_dequantize(x, scale, out_dtype="float32"):
    return (x.float() * scale.float()).to(convert_dtype(out_dtype))


def fp8_gemm(x, x_scale, w, w_scale, bias=None, out_dtype="bfloat16"):
    """fp8 x fp8 matmul: both operands widened to fp32 and multiplied with
    TF32 off, then scaled by ``x_scale * w_scale`` (+ bias) in fp32 and cast
    to ``out_dtype``."""
    with _full_fp32():
        acc = torch.matmul(x.float(), w.float())
    out = acc * (x_scale.float() * w_scale.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(convert_dtype(out_dtype))


def fp8_linear(x, weight, bias=None, dtype="e4m3", out_dtype=None):
    """Dynamic-scaling fp8 linear: activation and weight quantized per
    call, :func:`fp8_gemm`, output in ``out_dtype`` (x's dtype by
    default)."""
    qx, sx = fp8_quantize(x, dtype=dtype)
    qw, sw = fp8_quantize(weight, dtype=dtype)
    return fp8_gemm(qx, sx, qw, sw, bias=bias, out_dtype=out_dtype or x.dtype)


__all__ = ["AbsmaxObserver", "FakeQuanterWithAbsMax", "PTQ", "QAT",
           "QuantConfig", "fake_channel_wise_dequantize_max_abs",
           "fake_channel_wise_quantize_abs_max", "fake_quantize_abs_max",
           "fp8_dequantize", "fp8_gemm", "fp8_linear", "fp8_quantize",
           "llm_int8_linear", "quant_with_scale", "weight_dequantize",
           "weight_only_linear", "weight_quantize"]
