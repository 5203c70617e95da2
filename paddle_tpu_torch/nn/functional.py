"""The port of ``paddle_tpu.nn.functional``: the functional ops the
Paddle-API path calls, on torch tensors with the reference's arithmetic.

- Activations, ``linear``, ``conv2d``, the norms, pooling, dropout,
  ``embedding`` and the losses are plain torch ops (the reference leaves
  them to XLA; none is a Pallas kernel).  Each names itself to
  :func:`paddle_tpu_torch.core.amp_state.cast`, so it casts its inputs under
  autocast where the reference's op of the same name does.
- ``batch_norm`` keeps the reference's rule (``nn/functional.py:343``): in
  training it normalises by the batch's mean and biased variance, and
  moves the running statistics as ``momentum * running + (1 - momentum) *
  batch`` (the reverse of torch's convention, with the biased variance).
  Its gradient flows through the batch statistics, as in the reference's
  jitted path; the reference's eager path takes them as constants, a
  fault that makes a deep net's gradients explode (``ROADMAP.md``, Queue
  3).
- The flash ops go through :mod:`paddle_tpu_torch.kernels.flash_attention`:
  CUDA tensors launch its Hopper kernels, CPU tensors take their plain
  versions.  :func:`scaled_dot_product_attention` has no kernel in the
  reference (it is the XLA path) and is plain PyTorch here on either
  device.
- Dropout draws from the generator of the tensor's device
  (:mod:`paddle_tpu_torch.core.random`); the attention dropout of the
  flash ops and SDPA draws one seed a call, and given the seed the dropped
  positions equal the reference's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.amp_state import cast as _amp
from ..core.random import generator
from ..kernels import flash_attention as _fa
from ..ops.manipulation import pad as _pad


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


# ================= activations =================

def relu(x, name=None):
    (x,) = _amp("relu", x)
    return torch.relu(x)


def relu6(x, name=None):
    (x,) = _amp("relu6", x)
    return TF.relu6(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = _amp("leaky_relu", x)
    return TF.leaky_relu(x, negative_slope)


def gelu(x, approximate=False, name=None):
    (x,) = _amp("gelu", x)
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def silu(x, name=None):
    (x,) = _amp("silu", x)
    return TF.silu(x)


def swish(x, name=None):
    return silu(x)


def hardswish(x, name=None):
    (x,) = _amp("hardswish", x)
    return TF.hardswish(x)


def hardsigmoid(x, slope=1.0 / 6, offset=0.5, name=None):
    (x,) = _amp("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    (x,) = _amp("hardtanh", x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    (x,) = _amp("hardshrink", x)
    return torch.where(x.abs() > threshold, x, 0.0)


def softshrink(x, threshold=0.5, name=None):
    (x,) = _amp("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def tanhshrink(x, name=None):
    (x,) = _amp("tanhshrink", x)
    return x - torch.tanh(x)


def elu(x, alpha=1.0, name=None):
    (x,) = _amp("elu", x)
    return TF.elu(x, alpha)


def celu(x, alpha=1.0, name=None):
    (x,) = _amp("celu", x)
    return TF.celu(x, alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = _amp("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def mish(x, name=None):
    (x,) = _amp("mish", x)
    return TF.mish(x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    (x,) = _amp("softplus", x)
    return torch.where(beta * x > threshold, x,
                       torch.log1p(torch.exp(beta * x)) / beta)


def softsign(x, name=None):
    (x,) = _amp("softsign", x)
    return TF.softsign(x)


def sigmoid(x, name=None):
    (x,) = _amp("sigmoid", x)
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    (x,) = _amp("log_sigmoid", x)
    return TF.logsigmoid(x)


def tanh(x, name=None):
    (x,) = _amp("tanh", x)
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        from .. import dtypes
        x = x.to(dtypes.convert_dtype(dtype))
    (x,) = _amp("softmax", x)
    return torch.softmax(x, dim=int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        from .. import dtypes
        x = x.to(dtypes.convert_dtype(dtype))
    (x,) = _amp("log_softmax", x)
    return torch.log_softmax(x, dim=int(axis))


def glu(x, axis=-1, name=None):
    (x,) = _amp("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def maxout(x, groups, axis=1, name=None):
    (x,) = _amp("maxout", x)
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


# ================= linear / embedding =================

def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with ``weight`` laid out ``[in, out]``."""
    x, weight, bias = _amp("linear", x, weight, bias)
    return TF.linear(x, weight.t(), bias)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight``; the rows of ids equal to ``padding_idx`` are 0
    (and pass no gradient).  ``sparse`` is accepted: the port's gradient is
    dense."""
    (weight,) = _amp("embedding", weight)
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


# ================= dropout =================

def _keep_mask(shape, keep, device):
    return torch.rand(shape, device=device,
                      generator=generator(device)) < keep


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each entry (or each slice along ``axis``) with probability
    ``p``; ``upscale_in_train`` divides the kept ones by ``1 - p``,
    ``downscale_in_infer`` instead scales by ``1 - p`` in eval."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            (x,) = _amp("dropout_scale", x)
            return x * (1.0 - p)
        return x
    (x,) = _amp("dropout", x)
    shape = tuple(x.shape)
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(shape))
    keep = 1.0 - p
    mask = _keep_mask(shape, keep, x.device)
    if mode == "upscale_in_train":
        return torch.where(mask, x / keep, 0.0)
    return torch.where(mask, x, 0.0)


# ================= normalization =================

def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = _amp("layer_norm", x, weight, bias)
    return TF.layer_norm(x, list(normalized_shape), weight, bias,
                         float(epsilon))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """Batch norm by the reference's rule (module docstring): in training
    the batch's mean and biased variance normalise (and the gradient flows
    through them, as in the reference's jitted path), and the running
    statistics move by ``momentum`` with the batch's statistics taken in
    x's own dtype, before autocast; otherwise the running statistics
    normalise."""
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    batch_stats = training and not use_global_stats
    if batch_stats and running_mean is not None:
        with torch.no_grad():
            var, mean = torch.var_mean(
                x, dim=[i for i in range(x.ndim) if i != ch], correction=0)
            running_mean.mul_(momentum).add_(mean, alpha=1 - momentum)
            running_var.mul_(momentum).add_(var, alpha=1 - momentum)
    x, weight, bias = _amp("batch_norm", x, weight, bias)
    if ch != 1:
        x = x.movedim(ch, 1)
    if batch_stats:
        out = TF.batch_norm(x, None, None, weight, bias, training=True,
                            eps=float(epsilon))
    else:
        out = TF.batch_norm(x, running_mean.to(x.dtype),
                            running_var.to(x.dtype), weight, bias,
                            training=False, eps=float(epsilon))
    return out.movedim(1, ch) if ch != 1 else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalised over dims 2.. by its mean and
    biased variance, then ``weight`` / ``bias`` along dim 1.  The running
    statistics, ``use_input_stats``, ``momentum`` and ``data_format`` are
    ignored, as in the reference (:380)."""
    x, weight, bias = _amp("instance_norm", x, weight, bias)
    return TF.instance_norm(x, None, None, weight, bias,
                            use_input_stats=True, eps=float(eps))


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Group norm over "NCHW" (or "NHWC"): each group of channels
    normalised by its mean and biased variance.  A half-precision ``x``
    keeps the reference's roundings: the statistics are taken in float32
    and rounded to x's dtype before they normalise (``jnp.mean`` /
    ``jnp.var``)."""
    x, weight, bias = _amp("group_norm", x, weight, bias)
    channels_last = data_format == "NHWC"
    x = _channels_first(x, channels_last)
    if x.dtype == torch.float32:
        out = TF.group_norm(x, num_groups, weight, bias, float(epsilon))
    else:
        n, c = x.shape[:2]
        g = x.reshape(n, num_groups, -1)
        var, mean = torch.var_mean(g.float(), dim=-1, correction=0,
                                   keepdim=True)
        out = ((g - mean.to(x.dtype)) * torch.rsqrt(
            var.to(x.dtype) + epsilon)).reshape(x.shape)
        shape = [1, c] + [1] * (x.ndim - 2)
        if weight is not None:
            out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
    return _channels_back(out, channels_last)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s)^beta`` with ``s`` the sum of squares over the
    ``size`` channels around each (``size // 2`` before): the reference's
    rule (:435), with no division of the sum by ``size``, so not torch's
    ``local_response_norm``."""
    (x,) = _amp("lrn", x)
    ch = 1 if data_format.startswith("NC") else x.ndim - 1
    half = size // 2
    sq = x.movedim(ch, -1).square()
    sq = TF.pad(sq, (half, size - half - 1))
    n = x.shape[ch]
    acc = sq[..., 0:n]
    for i in range(1, size):
        acc = acc + sq[..., i:i + n]
    return x / torch.pow(k + alpha * acc.movedim(-1, ch), beta)


def sync_batch_norm(x, running_mean, running_var, weight=None, bias=None,
                    training=False, momentum=0.9, epsilon=1e-5,
                    data_format="NCHW", group=None, name=None):
    """Batch norm with the statistics of every rank of ``group``: in one
    process that is :func:`batch_norm` (the port's rule, its gradient
    through the batch statistics).  A group of more than one rank, or a
    default group of a process group over more than one rank, raises until
    the port's distributed module (``ROADMAP.md`` item 18)."""
    nranks = getattr(group, "nranks", 1) if group is not None else (
        torch.distributed.get_world_size()
        if torch.distributed.is_available() and
        torch.distributed.is_initialized() else 1)
    if training and nranks > 1:
        raise NotImplementedError("sync_batch_norm over more than one rank "
                                  "waits for the port's distributed module")
    return batch_norm(x, running_mean, running_var, weight, bias,
                      training=training, momentum=momentum, epsilon=epsilon,
                      data_format=data_format)


def spectral_norm(weight, n_power_iterations=1, eps=1e-12, dim=0, name=None):
    """``weight / sigma``, ``sigma`` from ``max(1, n_power_iterations)``
    power iterations over ``weight`` as a ``[shape[dim], -1]`` matrix that
    start from ones on every call (no kept ``u`` / ``v``), as in the
    reference (:1839); the gradient flows through the iterations."""
    (w,) = _amp("spectral_norm", weight)
    wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    u = torch.ones(wm.shape[0], dtype=torch.float32, device=w.device)
    v = torch.ones(wm.shape[1], dtype=torch.float32, device=w.device)
    for _ in range(max(1, n_power_iterations)):
        v = wm.T @ u
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), eps)
        u = wm @ v
        u = u / torch.clamp_min(torch.linalg.vector_norm(u), eps)
    return w / torch.clamp_min(u @ wm @ v, eps)


# ================= convolution =================

_CHANNELS_LAST = ("NHWC", "NLC", "NDHWC")
_TF_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_TF_TCONV = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
             3: TF.conv_transpose3d}


def _channels_first(x, channels_last):
    return x.movedim(-1, 1) if channels_last else x


def _channels_back(x, channels_last):
    return x.movedim(1, -1) if channels_last else x


def _same_pads(size, k, s, d):
    """XLA's 'SAME' padding of one spatial dim: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv_pads(padding, nd, spatial, kernel, stride, dilation, channels_last):
    """(low, high) a spatial dim from the reference's padding forms
    (``_conv_nd``, :460): "SAME" / "VALID", the full nested form, ``2 nd``
    ints (low, high a dim), or an int or one int a dim."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return ((0, 0),) * nd
        if padding.upper() == "SAME":
            return tuple(_same_pads(n, k, s, d) for n, k, s, d in
                         zip(spatial, kernel, stride, dilation))
        raise ValueError(f"bad padding {padding}")
    if isinstance(padding, (list, tuple)) and padding and \
            isinstance(padding[0], (list, tuple)):
        sp = padding[1:-1] if channels_last else padding[2:]
        return tuple(tuple(int(v) for v in p) for p in sp)
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * nd:
        return tuple((int(padding[2 * i]), int(padding[2 * i + 1]))
                     for i in range(nd))
    return tuple((p, p) for p in _pair(padding, nd))


def _conv_nd(name, x, weight, bias, stride, padding, dilation, groups, nd,
             data_format):
    x, weight, bias = _amp(name, x, weight, bias)
    channels_last = data_format in _CHANNELS_LAST
    x = _channels_first(x, channels_last)
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    pads = _conv_pads(padding, nd, x.shape[2:], weight.shape[2:], stride,
                      dilation, channels_last)
    if all(lo == hi for lo, hi in pads):
        out = _TF_CONV[nd](x, weight, bias, stride,
                           tuple(lo for lo, _ in pads), dilation, groups)
    else:
        x = TF.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])
        out = _TF_CONV[nd](x, weight, bias, stride, 0, dilation, groups)
    return _channels_back(out, channels_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """Convolution over ``[N, C, L]`` ("NCL") or ``[N, L, C]`` ("NLC")
    with a ``[out, in / groups, k]`` weight; ``padding`` as
    :func:`conv2d`'s, with two ints meaning (low, high)."""
    return _conv_nd("conv1d", x, weight, bias, stride, padding, dilation,
                    groups, 1, "NLC" if data_format == "NLC" else "NCL")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """Convolution with a ``[out, in / groups, kh, kw]`` weight; ``padding``
    is an int, a pair, four ints ``[top, bottom, left, right]``, the full
    ``[[0, 0], [0, 0], [t, b], [l, r]]`` form, or "SAME" / "VALID" (XLA's
    rule)."""
    return _conv_nd("conv2d", x, weight, bias, stride, padding, dilation,
                    groups, 2, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """Convolution over "NCDHW" or "NDHWC" with a ``[out, in / groups, kd,
    kh, kw]`` weight; ``padding`` as :func:`conv2d`'s, six ints meaning
    (low, high) a dim."""
    return _conv_nd("conv3d", x, weight, bias, stride, padding, dilation,
                    groups, 3, data_format)


def _tconv_output_padding(output_size, in_spatial, stride, padding, kernel,
                          dilation):
    """The output padding that makes a transposed convolution give
    ``output_size`` (one of the ``stride`` sizes it can reach)."""
    op = []
    for o, i, s, p, k, d in zip(output_size, in_spatial, stride, padding,
                                kernel, dilation):
        base = (i - 1) * s - 2 * p + (k - 1) * d + 1
        extra = int(o) - base
        if not 0 <= extra < s:
            raise ValueError(
                f"output_size {o} unreachable: valid range "
                f"[{base}, {base + s - 1}] for this stride/pad/kernel")
        op.append(extra)
    return tuple(op)


def _conv_transpose(name, x, weight, bias, stride, padding, output_padding,
                    groups, dilation, nd, channels_last, output_size):
    """Transposed convolution with a ``[in, out / groups, k...]`` weight.
    ``groups`` > 1 raises ``ValueError``, as the reference does: it swaps
    the whole weight's first two axes before a grouped convolution, whose
    feature counts then disagree."""
    if groups != 1:
        raise ValueError(f"{name}: groups={groups}: the transposed "
                         "convolution takes groups=1 only (its weight's "
                         "in / out axes are swapped as a whole)")
    x, weight, bias = _amp(name, x, weight, bias)
    x = _channels_first(x, channels_last)
    stride, dilation = _pair(stride, nd), _pair(dilation, nd)
    pad = _pair(padding, nd)
    if output_size is not None:
        sizes = output_size if isinstance(output_size, (list, tuple)) \
            else [output_size]
        op = _tconv_output_padding([int(v) for v in sizes][-nd:],
                                   x.shape[2:], stride, pad,
                                   weight.shape[2:], dilation)
    else:
        op = _pair(output_padding, nd)
    out = _TF_TCONV[nd](x, weight, bias, stride, pad, op, 1, dilation)
    return _channels_back(out, channels_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL", output_size=None, name=None):
    """The transpose of :func:`conv1d` (weight ``[in, out, k]``);
    ``output_size`` picks the output padding.  Named "conv2d_transpose"
    to autocast, as the reference's goes through its 2-D form."""
    return _conv_transpose("conv2d_transpose", x, weight, bias, stride,
                           padding, output_padding, groups, dilation, 1,
                           data_format == "NLC", output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    """The transpose of :func:`conv2d` (weight ``[in, out, kh, kw]``,
    ``padding`` an int or a pair)."""
    return _conv_transpose("conv2d_transpose", x, weight, bias, stride,
                           padding, output_padding, groups, dilation, 2,
                           data_format == "NHWC", output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    """The transpose of :func:`conv3d` (weight ``[in, out, kd, kh, kw]``,
    ``padding`` an int or one a dim)."""
    return _conv_transpose("conv3d_transpose", x, weight, bias, stride,
                           padding, output_padding, groups, dilation, 3,
                           data_format == "NDHWC", output_size)


# ================= pooling =================
#
# Every pool ignores ``ceil_mode``, as the reference's ``lax.reduce_window``
# pools do; padding is symmetric, one int a dim.

_TF_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_TF_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pool_args(kernel_size, stride, padding, nd):
    k = _pair(kernel_size, nd)
    return k, _pair(stride if stride is not None else k, nd), \
        _pair(padding, nd)


def _pad_sym(x, pads, value):
    """``x`` padded by ``pads[i]`` on both sides of its last
    ``len(pads)`` dims with ``value``."""
    if not any(pads):
        return x
    return TF.pad(x, [v for p in reversed(pads) for v in (p, p)],
                  value=value)


def _max_pool(name, x, kernel_size, stride, padding, nd, data_format):
    """Max over windows of ``x`` padded with -inf."""
    (x,) = _amp(name, x)
    channels_last = data_format in _CHANNELS_LAST
    k, s, p = _pool_args(kernel_size, stride, padding, nd)
    out = _TF_MAX[nd](_pad_sym(_channels_first(x, channels_last), p,
                               -math.inf), k, s)
    return _channels_back(out, channels_last)


def _avg_pool(name, x, kernel_size, stride, padding, nd, data_format,
              exclusive, divisor_override):
    """Window sums over ``divisor_override``, else (with ``exclusive``)
    over the count of input entries in the window, else over the window's
    size.  Padding beyond half a window, which torch's pools refuse, pads
    first.  A channels-last input is pooled from a contiguous copy: on the
    card, torch 2.11's avg_pool2d backward over a channels-last-strided
    input with padding and ``count_include_pad`` gave wrong gradients
    (``chip_smoke.py`` ``nn_spatial_parity``)."""
    (x,) = _amp(name, x)
    channels_last = data_format in _CHANNELS_LAST
    x = _channels_first(x, channels_last).contiguous()
    k, s, p = _pool_args(kernel_size, stride, padding, nd)
    extra = {} if nd == 1 else {"divisor_override": divisor_override or None}
    if all(pi <= ki // 2 for pi, ki in zip(p, k)):
        out = _TF_AVG[nd](x, k, s, p, count_include_pad=not exclusive,
                          **extra)
    else:
        out = _TF_AVG[nd](_pad_sym(x, p, 0.0), k, s)
        if divisor_override:
            out = out * (math.prod(k) / divisor_override)
        elif exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = out / _TF_AVG[nd](_pad_sym(ones, p, 0.0), k, s)
    return _channels_back(out, channels_last)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    """Max pooling over "NCL"; ``return_mask`` is ignored, as in the
    reference."""
    return _max_pool("max_pool1d", x, kernel_size, stride, padding, 1, "NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Max over windows padded with -inf; ``return_mask`` gives
    :func:`max_pool2d_with_index`'s ``(out, index)`` (over "NCHW")."""
    if return_mask:
        return max_pool2d_with_index(x, kernel_size, stride, padding)
    return _max_pool("max_pool2d", x, kernel_size, stride, padding, 2,
                     data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    if return_mask:
        return max_pool3d_with_index(x, kernel_size, stride, padding)
    return _max_pool("max_pool3d", x, kernel_size, stride, padding, 3,
                     data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    """Mean pooling over "NCL" that always divides by the window's size:
    ``exclusive`` is ignored, as in the reference (:612)."""
    return _avg_pool("avg_pool1d", x, kernel_size, stride, padding, 1, "NCL",
                     False, None)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Mean over windows; with ``exclusive`` the padding is not counted."""
    return _avg_pool("avg_pool2d", x, kernel_size, stride, padding, 2,
                     data_format, exclusive, divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool("avg_pool3d", x, kernel_size, stride, padding, 3,
                     data_format, exclusive, divisor_override)


def _max_pool_with_index(name, x, kernel_size, stride, padding, nd):
    """Max pooling over "NC..." and the int32 flat spatial index of each
    window's largest entry in the unpadded input (the first, on a tie)."""
    (x,) = _amp(name, x)
    k, s, p = _pool_args(kernel_size, stride, padding, nd)
    out, idx = _TF_MAX[nd](_pad_sym(x, p, -math.inf), k, s,
                           return_indices=True)
    if any(p):
        padded = [n + 2 * pi for n, pi in zip(x.shape[2:], p)]
        coords = []
        for n in reversed(padded):
            coords.append(idx % n)
            idx = torch.div(idx, n, rounding_mode="floor")
        idx = torch.zeros_like(coords[0])
        for c, n, pi in zip(reversed(coords), x.shape[2:], p):
            idx = idx * n + (c - pi)
    return out, idx.to(torch.int32)


def max_pool2d_with_index(x, kernel_size, stride=None, padding=0, name=None):
    return _max_pool_with_index("max_pool2d_with_index", x, kernel_size,
                                stride, padding, 2)


def max_pool3d_with_index(x, kernel_size, stride=None, padding=0, name=None):
    return _max_pool_with_index("max_pool3d_with_index", x, kernel_size,
                                stride, padding, 3)


def _max_unpool(name, x, indices, kernel_size, stride, padding, nd,
                output_size):
    """Each pooled value added at its flat spatial index of a zero output
    of ``output_size`` (or ``(n - 1) s - 2 p + k`` a dim): where windows
    overlap, a repeated index sums its values, as the reference's
    ``.at[...].add`` does (torch's ``max_unpool`` writes one)."""
    (x,) = _amp(name, x)
    k, s, p = _pool_args(kernel_size, stride, padding, nd)
    if output_size is not None:
        sizes = output_size if isinstance(output_size, (list, tuple)) \
            else [output_size]
        out_sp = [int(v) for v in sizes][-nd:]
    else:
        out_sp = [(n - 1) * si - 2 * pi + ki
                  for n, ki, si, pi in zip(x.shape[2:], k, s, p)]
    n, c = x.shape[:2]
    out = x.new_zeros((n, c, math.prod(out_sp))).scatter_add(
        2, indices.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return out.reshape(n, c, *out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool("max_unpool1d", x, indices, kernel_size, stride,
                       padding, 1, output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool("max_unpool2d", x, indices, kernel_size, stride,
                       padding, 2, output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool("max_unpool3d", x, indices, kernel_size, stride,
                       padding, 3, output_size)


def adaptive_avg_pool1d(x, output_size, name=None):
    """Mean over torch's adaptive bins (bin i of n spans [floor(i n_in /
    n), ceil((i + 1) n_in / n))), the bins the reference builds."""
    (x,) = _amp("adaptive_avg_pool1d", x)
    return TF.adaptive_avg_pool1d(x, int(output_size))


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    (x,) = _amp("adaptive_avg_pool2d", x)
    channels_last = data_format == "NHWC"
    out = TF.adaptive_avg_pool2d(_channels_first(x, channels_last),
                                 _pair(output_size))
    return _channels_back(out, channels_last)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    """Over dims 2-4 whatever ``data_format`` says, as in the reference
    (:1948)."""
    (x,) = _amp("adaptive_avg_pool3d", x)
    return TF.adaptive_avg_pool3d(x, _pair(output_size, 3))


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """Max over the adaptive bins; ``return_mask`` is ignored, as in the
    reference (so are the 2-D and 3-D forms')."""
    (x,) = _amp("adaptive_max_pool1d", x)
    return TF.adaptive_max_pool1d(x, int(output_size))


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    (x,) = _amp("adaptive_max_pool2d", x)
    return TF.adaptive_max_pool2d(x, _pair(output_size))


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    (x,) = _amp("adaptive_max_pool3d", x)
    return TF.adaptive_max_pool3d(x, _pair(output_size, 3))


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    """``(sum |x|^p)^(1/p)`` over windows: :func:`avg_pool1d` of ``|x|^p``
    times the window's size."""
    (x,) = _amp("lp_pow", x)
    ks = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    pooled = avg_pool1d(x.abs() ** float(norm_type), kernel_size, stride,
                        padding)
    (pooled,) = _amp("lp_root", pooled)
    return (pooled * ks) ** (1.0 / float(norm_type))


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    """As :func:`lp_pool1d` over "NCHW" (``data_format`` is ignored): the
    exclusive mean of :func:`avg_pool2d` times the window's full size, so
    with padding a border window's sum is scaled up, as in the reference
    (:2176)."""
    (x,) = _amp("lp_pow", x)
    count = kernel_size * kernel_size if isinstance(kernel_size, int) \
        else kernel_size[0] * kernel_size[1]
    pooled = avg_pool2d(x.abs() ** float(norm_type), kernel_size, stride,
                        padding, exclusive=True)
    (pooled,) = _amp("lp_root", pooled)
    return (pooled * count) ** (1.0 / float(norm_type))


def _fractional_edges(n_in, n_out, u):
    """The reference's bin edges (:1799): ``ceil(alpha (i + u)) -
    ceil(alpha u)`` with ``alpha = n_in / n_out``, the last at ``n_in``."""
    alpha = n_in / n_out
    i = np.arange(n_out + 1)
    e = np.ceil(alpha * (i + u)).astype(int) - int(np.ceil(alpha * u))
    e[-1] = n_in
    return np.clip(e, 0, n_in)


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """Max over pseudo-random bins (Graham 2014) of "NCHW" ``x``, the bins
    from ``random_u`` or, without it, from a draw of the CPU generator
    (not threefry's); ``kernel_size`` and ``return_mask`` are ignored.  A
    bin's max is taken over its rows, then its columns."""
    oh, ow = (output_size,) * 2 if isinstance(output_size, int) \
        else output_size
    u = float(random_u) if random_u is not None else float(
        torch.rand((), generator=generator("cpu")))
    (x,) = _amp("fractional_max_pool2d", x)
    eh = _fractional_edges(x.shape[2], oh, u)
    ew = _fractional_edges(x.shape[3], ow, u)
    x = torch.stack([x[:, :, eh[i]:max(eh[i + 1], eh[i] + 1)].amax(dim=2)
                     for i in range(oh)], dim=2)
    return torch.stack([x[..., ew[j]:max(ew[j + 1], ew[j] + 1)].amax(dim=-1)
                        for j in range(ow)], dim=-1)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """The reference's composition (:1823): (h, w) pooled with depth folded
    into the channels, then depth pooled over unit bins of the folded
    ``oh * ow`` (each call with its own draw when ``random_u`` is None)."""
    od, oh, ow = (output_size,) * 3 if isinstance(output_size, int) \
        else output_size
    n, c, d, h, w = x.shape
    hw = fractional_max_pool2d(x.reshape(n, c * d, h, w), (oh, ow),
                               random_u=random_u)
    out = fractional_max_pool2d(hw.reshape(n, c, d, oh * ow),
                                (od, oh * ow), random_u=random_u)
    return out.reshape(n, c, od, oh, ow)


# ================= padding / resampling =================

def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """:func:`paddle_tpu_torch.ops.pad`."""
    return _pad(x, pad, mode=mode, value=value, data_format=data_format)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, _pair(padding, 4), mode="constant", value=0.0,
               data_format=data_format)


# resampling matrices and gather indices, one a (n_in, n_out, rule, dtype,
# device): a warm step makes no host-to-device copy
_RESAMPLE = {}


def _keys_cubic(x):
    """Keys' cubic with a = -0.5 (``jax.image``'s; torch's bicubic takes
    -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _scale_matrix(n_in, n_out, rule):
    """``jax.image.resize``'s ``[n_out, n_in]`` weights for ``rule``
    ("linear" or "cubic"), in float64: half-pixel sample points, the kernel
    widened by the shrink factor when shrinking (antialiasing), each row
    normalised to sum 1."""
    inv = n_in / n_out
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    x = x / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x) if rule == "linear" else _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def _corner_matrix(n_in, n_out):
    """The reference's ``align_corners=True`` two-tap matrix (``_ac_weights``,
    :702), its sample points ``i (n_in - 1) / (n_out - 1)`` in float32."""
    w = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        w[:, 0] = 1.0
        return w
    src = np.arange(n_out, dtype=np.float32) * np.float32(n_in - 1) / \
        np.float32(n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int32), 0, n_in - 2)
    frac = src - lo.astype(np.float32)
    rows = np.arange(n_out)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, lo + 1), frac)
    return w


def _nearest_index(n_in, n_out):
    """``jax.image``'s nearest source rows, ``floor((i + 0.5) n_in /
    n_out)`` in float32 (torch's "nearest-exact", not its "nearest")."""
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * \
        np.float32(n_in) / np.float32(n_out)
    return np.floor(f).astype(np.int64)


def _resample_tensor(n_in, n_out, rule, dtype, device):
    key = (n_in, n_out, rule, dtype, str(device))
    t = _RESAMPLE.get(key)
    if t is None:
        if rule == "nearest":
            t = torch.from_numpy(_nearest_index(n_in, n_out)).to(device)
        else:
            w = _corner_matrix(n_in, n_out) if rule == "corners" else \
                _scale_matrix(n_in, n_out, rule)
            t = torch.from_numpy(np.ascontiguousarray(w.T)).to(
                device=device, dtype=dtype)
        _RESAMPLE[key] = t
    return t


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resampling by the reference's rule (:689), which is
    ``jax.image.resize``, not torch's ``interpolate``: "nearest" takes row
    ``floor((i + 0.5) n_in / n_out)``; "linear" / "bilinear" /
    "trilinear" / "area" are one separable linear resample with half-pixel
    centres that antialiases when it shrinks, "bicubic" the same with
    Keys' cubic (a = -0.5); with ``align_corners`` the linear modes take
    the two-tap corner-aligned matrix.  ``align_mode`` is ignored; a
    ``scale_factor`` gives ``int(n * f)``.  Each changed dim is one matmul
    with a cached ``[n_in, n_out]`` matrix (a gather for "nearest")."""
    (x,) = _amp("interpolate", x)
    nd = x.ndim - 2
    first = data_format.startswith("NC")
    axes = list(range(2, x.ndim)) if first else list(range(1, x.ndim - 1))
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nd
        size = [int(x.shape[a] * f) for a, f in zip(axes, sf)]
    size = [int(s) for s in (size if isinstance(size, (list, tuple))
                             else [size] * nd)]
    rule = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
            "trilinear": "linear", "bicubic": "cubic", "area": "linear"}[mode]
    if align_corners and rule == "linear":
        rule = "corners"
    out = x
    for ax, n_out in zip(axes, size):
        n_in = out.shape[ax]
        if n_in == n_out:
            continue
        t = _resample_tensor(n_in, n_out, rule, out.dtype, out.device)
        if rule == "nearest":
            out = out.index_select(ax, t)
        else:
            out = torch.matmul(out.movedim(ax, -1), t).movedim(-1, ax)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """``[N, C r^2, H, W] -> [N, C, H r, W r]``; ``data_format`` is
    ignored, as in the reference."""
    (x,) = _amp("pixel_shuffle", x)
    return TF.pixel_shuffle(x, int(upscale_factor))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """The inverse of :func:`pixel_shuffle` (``data_format`` ignored)."""
    (x,) = _amp("pixel_unshuffle", x)
    return TF.pixel_unshuffle(x, int(downscale_factor))


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """ShuffleNet's shuffle: channels as ``[groups, C / groups]``,
    transposed."""
    (x,) = _amp("channel_shuffle", x)
    g = int(groups)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(x.shape)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(x.shape)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift over ``[N T, C, H, W]``: the first ``int(C ratio)``
    channels one segment later in time, the next as many one earlier, zero
    where nothing shifts in; ``data_format`` is ignored, as in the
    reference."""
    (x,) = _amp("temporal_shift", x)
    nt, c, h, w = x.shape
    a = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    back = TF.pad(a[:, :-1, :fold], (0, 0, 0, 0, 0, 0, 1, 0))
    ahead = TF.pad(a[:, 1:, fold:2 * fold], (0, 0, 0, 0, 0, 0, 0, 1))
    return torch.cat([back, ahead, a[:, :, 2 * fold:]], dim=2).reshape(
        nt, c, h, w)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W] -> [N, C kh kw, L]`` (symmetric padding, one
    int a dim)."""
    (x,) = _amp("unfold", x)
    return TF.unfold(x, _pair(kernel_sizes), _pair(dilations),
                     _pair(paddings), _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of :func:`unfold`: overlapping patches sum."""
    (x,) = _amp("fold", x)
    return TF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   _pair(dilations), _pair(paddings), _pair(strides))


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The ``[N, H, W, 2]`` sampling grid of ``[N, 2, 3]`` affine matrices
    for ``out_shape`` ``[N, C, H, W]``, in float32 (the reference's is
    float64 under its x64 mode)."""
    if torch.is_tensor(out_shape):
        out_shape = out_shape.tolist()
    _, _, h, w = [int(v) for v in out_shape]
    (theta,) = _amp("affine_grid", theta)
    dev = theta.device

    def line(n):
        if align_corners:
            return torch.linspace(-1.0, 1.0, n, device=dev)
        return (torch.arange(n, device=dev) * 2 + 1) / n - 1.0
    ys, xs = line(h), line(w)
    base = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                        torch.ones((h, w), device=dev)], dim=-1)
    return torch.einsum("hwk,nik->nhwi", base, theta.float())


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``[N, C, H, W]`` at ``grid`` ``[N, Hg, Wg, 2]`` (x, y in [-1,
    1]) by the reference's gathers (:1492): "bilinear" or "nearest" (half
    to even); "zeros" zeroes out-of-bounds corners, "border" clamps the
    corner indices, "reflection" reflects the coordinates first."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode {mode!r} not supported")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample padding_mode {padding_mode!r}")
    x, grid = _amp("grid_sample", x, grid)
    n, c, h, w = x.shape
    hg, wg = grid.shape[1:3]

    def unnormalize(coord, size):
        if align_corners:
            return (coord + 1) * 0.5 * (size - 1)
        return ((coord + 1) * size - 1) * 0.5

    def reflect(coord, size):
        if align_corners:
            if size == 1:
                return torch.zeros_like(coord)
            span = 2 * (size - 1)
            m = torch.remainder(coord, span)
            return torch.where(m > size - 1, span - m, m)
        span = 2 * size
        m = torch.remainder(coord + 0.5, span)
        return torch.clamp(torch.where(m > size - 0.5, span - m, m) - 0.5,
                           0, size - 1)

    gx = unnormalize(grid[..., 0].float(), w)
    gy = unnormalize(grid[..., 1].float(), h)
    if padding_mode == "reflection":
        gx, gy = reflect(gx, w), reflect(gy, h)
    flat = x.reshape(n, c, h * w)

    def inb(iy, ix):
        return ((ix >= 0) & (ix <= w - 1) & (iy >= 0) &
                (iy <= h - 1)).to(x.dtype)

    def sample(iy, ix):
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, 1, -1)
        vals = torch.gather(flat, 2, idx.expand(n, c, -1)).reshape(
            n, c, hg, wg)
        if padding_mode == "zeros":
            vals = vals * inb(iy, ix).reshape(n, 1, hg, wg)
        return vals

    if mode == "nearest":
        return sample(torch.round(gy).long(), torch.round(gx).long())
    x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
    x1, y1 = x0 + 1, y0 + 1
    wx = (gx - x0).to(x.dtype).reshape(n, 1, hg, wg)
    wy = (gy - y0).to(x.dtype).reshape(n, 1, hg, wg)
    top = sample(y0, x0) * (1 - wx) + sample(y0, x1) * wx
    bot = sample(y1, x0) * (1 - wx) + sample(y1, x1) * wx
    return top * (1 - wy) + bot * wy


# ================= losses =================

def _reduce_loss(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """The reference's ``cross_entropy`` (``nn/functional.py:845``): hard
    labels skip ``ignore_index`` (a mean divides by the count of the rest,
    or by their weights' sum), soft labels take ``-sum(label * log p)``;
    ``label_smoothing`` mixes in the uniform distribution."""
    logits, label, weight = _amp("cross_entropy", input, label, weight)
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp_min(logits, 1e-30))
    n = logits.shape[axis]
    if soft_label:
        tgt = label
        if label_smoothing > 0:
            tgt = tgt * (1 - label_smoothing) + label_smoothing / n
        return _reduce_loss(-(tgt * logp).sum(dim=axis), reduction)
    lab = label
    if lab.ndim == logits.ndim:
        lab = lab.squeeze(axis)
    lab = lab.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    logp_last = logp.movedim(axis, -1)
    picked = torch.gather(logp_last, -1, safe[..., None])[..., 0]
    if label_smoothing > 0:
        picked = (1 - label_smoothing) * picked + \
            label_smoothing * logp_last.mean(dim=-1)
    loss = torch.where(valid, -picked, 0.0)
    if weight is not None:
        w = weight[safe]
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(
                torch.where(valid, w, 0.0).sum(), 1e-10)
    elif reduction == "mean":
        return loss.sum() / torch.clamp_min(valid.to(loss.dtype).sum(), 1.0)
    return _reduce_loss(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    a, b = _amp("mse_loss", input, label)
    return _reduce_loss(torch.square(a - b), reduction)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    a, b = _amp("l1_loss", input, label)
    return _reduce_loss(torch.abs(a - b), reduction)


# ================= attention =================

def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, training=True,
                                 name=None):
    """Attention with the reference's own masking (``nn/functional.py``
    :777): scores in the inputs' dtype, a bool ``attn_mask`` selects (False
    -> -1e9) and any other is added, ``is_causal`` masks above the top-left
    diagonal with -1e9, and dropout, when ``training``, drops probabilities
    with the flash kernels' keep-mask."""
    query, key, value, attn_mask = _amp("sdpa", query, key, value, attn_mask)
    qh, kh, vh = (x.transpose(1, 2) for x in (query, key, value))
    scale = 1.0 / math.sqrt(query.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, -1e9)
        else:
            scores = scores + attn_mask
    if is_causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=scores.device).tril()
        scores = torch.where(causal, scores, -1e9)
    probs = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0 and training:
        seed = _fa._draw_seed(query.device)
        keep = _fa._drop_keep_dense(probs.shape, seed, float(dropout_p),
                                    probs.device)
        probs = torch.where(keep, probs, 0.0) * (1.0 / (1.0 - dropout_p))
    dt = torch.promote_types(probs.dtype, vh.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(dt), vh.to(dt))
    return out.transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None):
    """Flash attention (``nn/functional.py`` :827): ``(out, None)``, or
    ``out`` alone when ``return_softmax is None``, as the reference
    returns."""
    out = _fa.flash_attention(query, key, value, causal=causal,
                              dropout=dropout, training=training)
    return (out, None) if return_softmax is not None else out


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, training=True, name=None):
    """Attention with a row-index mask (``nn/functional.py`` :2332) over
    ``[b, s, h, d]`` tensors, GQA when key/value have fewer heads.

    ``startend_row_indices`` ``[b, h|1, sk, 1|2]``: for key column j the
    rows from ``startend_row_indices[..., j, 0]`` on are masked.  The mask is
    built on the device as the reference builds it, fp32 ``[b, h|1, sq,
    sk]`` with -1e9 where masked, and goes to the flash kernels' mask mode
    (:func:`paddle_tpu_torch.kernels.flash_attention.flash_attention`, with
    ``causal``); ``dropout`` is ignored there, as in the reference.  The
    reference's causal mask is the top-left one: where sq != sk it is added
    to the mask (-1e9) and the kernel runs without ``causal``.  Without
    indices this is :func:`scaled_dot_product_attention`."""
    if startend_row_indices is None:
        return scaled_dot_product_attention(query, key, value,
                                            dropout_p=dropout,
                                            is_causal=causal,
                                            training=training)
    sq, sk = query.shape[1], key.shape[1]
    start = startend_row_indices[..., 0][:, :, None, :]
    rows = torch.arange(sq, device=query.device)[:, None]
    masked = rows >= start
    kernel_causal = bool(causal) and sq == sk
    if causal and not kernel_causal:
        masked = masked | (torch.arange(sk, device=query.device) > rows)
    mask = torch.where(masked, -1e9, 0.0).to(torch.float32)
    return _fa.flash_attention(query, key, value, causal=kernel_causal,
                               attn_mask=mask)


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         fixed_seed_offset=None, rng_name="", training=True,
                         name=None):
    """Flash attention over a packed ``[b, s, 3, h, d]`` input
    (``nn/functional.py`` :2373); returns ``(out, None)``."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, softmax = flash_attention(q, k, v, dropout=dropout, causal=causal,
                                   training=training)
    return out, softmax


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None):
    """Varlen attention over a packed ``[total, 3, h, d]`` input
    (``nn/functional.py`` :2384); ``dropout``, ``scale`` and
    ``max_seqlen_*`` are ignored, as in the reference.  Returns
    ``(out, None)``."""
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    out = _fa.flash_attn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k,
                                causal=causal)
    return out, None



# ================= the sequence half of nn.functional =================
#
# The reference's remaining functions outside the spatial ops
# (``paddle_tpu/nn/functional.py``), each with the reference's arithmetic
# and its op name given to the autocast rule.  None reaches a Pallas kernel
# in the reference: ``ctc_loss`` (:1231) and ``rnnt_loss`` (:1112) are
# ``lax.scan``s, the rest plain ``jnp``.  Random draws (``rrelu`` in
# training, ``gumbel_softmax``, ``class_center_sample``, the alpha
# dropouts) come from the device's ``torch.Generator``, not threefry.

_NEG = -1e30


def _gen(x):
    return generator(x.device)


# ---------------- activations ----------------

def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x >= 0, x, w * x)``; a weight of more than one entry runs
    along dim 1 for "NCHW" and along the last dim for every other
    ``data_format`` (the reference's rule, "NCL" included)."""
    x, weight = _amp("prelu", x, weight)
    if weight.numel() > 1:
        shape = [1] * x.ndim
        shape[1 if data_format == "NCHW" else x.ndim - 1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x >= 0, x, weight * x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    (x,) = _amp("thresholded_relu", x)
    return torch.where(x > threshold, x, value)


tanh_shrink = tanhshrink


def rrelu(x, lower=1.0 / 8, upper=1.0 / 3, training=True, name=None):
    """Randomized leaky ReLU: in training each negative entry's slope is
    drawn uniformly from ``[lower, upper)`` (float32, then x's dtype); in
    eval the slope is ``(lower + upper) / 2``."""
    (x,) = _amp("rrelu", x)
    if not training:
        return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)
    alpha = torch.rand(x.shape, device=x.device, generator=_gen(x)) * \
        (upper - lower) + lower
    return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g``; ``hard``
    gives the one-hot of the argmax with the soft gradient (the reference's
    two straight-through lines, as written)."""
    (x,) = _amp("gumbel_softmax", x)
    tiny = torch.finfo(x.dtype).tiny
    u = torch.rand(x.shape, device=x.device, generator=_gen(x),
                   dtype=x.dtype).clamp_min(tiny)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = y_hard + (-y).detach() + y
        y = y_hard - y.detach() + y
    return y


def _inplace(fn, fname):
    def act_(x, *args, **kwargs):
        out = fn(x.clone(), *args, **kwargs)
        if x.is_leaf and x.requires_grad:
            with torch.no_grad():
                return x.copy_(out)
        return x.copy_(out)
    act_.__name__ = act_.__qualname__ = fname
    act_.__doc__ = (f"``{fn.__name__}`` written into ``x`` (returns "
                    "``x``).  A leaf that requires grad takes the value "
                    "outside autograd, as the reference swaps a tensor's "
                    "data.")
    return act_


relu_ = _inplace(relu, "relu_")
elu_ = _inplace(elu, "elu_")
hardtanh_ = _inplace(hardtanh, "hardtanh_")
leaky_relu_ = _inplace(leaky_relu, "leaky_relu_")
softmax_ = _inplace(softmax, "softmax_")
tanh_ = _inplace(tanh, "tanh_")
thresholded_relu_ = _inplace(thresholded_relu, "thresholded_relu_")


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; without ``y`` x is split in half on its last
    dim."""
    if y is None:
        (x,) = _amp("swiglu", x)
        x, y = torch.chunk(x, 2, dim=-1)
    else:
        x, y = _amp("swiglu", x, y)
    return TF.silu(x) * y


def fused_softmax_mask(x, mask, scale=1.0, name=None):
    """``softmax(x * scale + mask)`` in float32, back in x's dtype."""
    x, mask = _amp("fused_softmax_mask", x, mask)
    return torch.softmax(x.float() * scale + mask.float(), dim=-1).to(x.dtype)


def fused_softmax_mask_upper_triangle(x, name=None):
    """Softmax with the entries above the (bottom-right aligned) diagonal
    at -1e30, in float32."""
    (x,) = _amp("fused_softmax_mask_upper_triangle", x)
    t_q, t_k = x.shape[-2], x.shape[-1]
    keep = torch.ones((t_q, t_k), dtype=torch.bool,
                      device=x.device).tril(t_k - t_q)
    return torch.softmax(torch.where(keep, x.float(), _NEG),
                         dim=-1).to(x.dtype)


# ---------------- dropouts ----------------

def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p=p, axis=axis, training=training)


def _alpha_keep(p):
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    return alpha_p, keep, a, -a * alpha_p * (1 - keep)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """Dropout that keeps SELU's mean and variance: dropped entries take
    ``-alpha * scale``, then ``a * x + b``."""
    if not training or p == 0.0:
        return x
    (x,) = _amp("alpha_dropout", x)
    alpha_p, keep, a, b = _alpha_keep(p)
    mask = _keep_mask(tuple(x.shape), keep, x.device)
    return a * torch.where(mask, x, alpha_p) + b


def feature_alpha_dropout(x, p=0.5, training=True, name=None):
    """Alpha dropout of whole channels (dim 1)."""
    if not training or p == 0.0:
        return x
    (x,) = _amp("feature_alpha_dropout", x)
    alpha_p, keep, a, b = _alpha_keep(p)
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.ndim - 2)
    mask = _keep_mask(shape, keep, x.device)
    return a * torch.where(mask, x, alpha_p) + b


# ---------------- sequence utilities ----------------

def one_hot(x, num_classes, name=None):
    """float32 one-hot rows; an id outside ``[0, num_classes)`` gives a row
    of zeros, as ``jax.nn.one_hot`` does."""
    return (x[..., None] == torch.arange(int(num_classes),
                                         device=x.device)).float()


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias)``."""
    x1, x2, weight, bias = _amp("bilinear", x1, x2, weight, bias)
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def rms_norm(x, weight, epsilon=1e-6, name=None):
    """``x * rsqrt(mean(x^2) + eps) * weight``, the mean in float32 and the
    scale cast to x's dtype."""
    x, weight = _amp("rms_norm", x, weight)
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + epsilon).to(x.dtype)) * weight


def _vnorm(a, p, dim, keepdim=False):
    return torch.linalg.vector_norm(a, ord=p, dim=dim, keepdim=keepdim)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    (x,) = _amp("normalize", x)
    return x / torch.clamp_min(_vnorm(x, p, axis, True), epsilon)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = _amp("cosine_similarity", x1, x2)
    num = torch.sum(x1 * x2, dim=axis)
    return num / torch.clamp_min(_vnorm(x1, 2, axis) * _vnorm(x2, 2, axis),
                                 eps)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The ``p``-norm of ``x - y + epsilon`` over the last dim (``p`` 0
    counts the nonzero entries, inf takes the largest)."""
    x, y = _amp("pairwise_distance", x, y)
    d = x - y + epsilon
    if p == float("inf"):
        return torch.amax(d.abs(), dim=-1, keepdim=keepdim)
    if p == 0.0:
        return torch.sum((d != 0).to(d.dtype), dim=-1, keepdim=keepdim)
    return torch.sum(d.abs() ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon / n``.  ``prior_dist`` is accepted
    and ignored, as in the reference (``nn/functional.py:1407``)."""
    (label,) = _amp("label_smooth", label)
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``arange(maxlen) < x[..., None]`` in ``dtype``; without ``maxlen``
    the largest length is read on the host (one marked sync)."""
    from .. import dtypes
    if maxlen is None:
        from ..observability import count_sync
        count_sync()
        maxlen = int(x.max())
    out = torch.arange(int(maxlen), device=x.device) < x[..., None]
    return out.to(dtypes.convert_dtype(dtype))


def gather_tree(ids, parents):
    """Beam-search backtrace over ``[max_time, batch, beam]`` ids and
    parents: from the last step back, each beam's token and then its
    parent."""
    T, B, W = ids.shape
    sel = torch.arange(W, device=ids.device, dtype=parents.dtype).expand(B, W)
    outs = [None] * T
    for t in range(T - 1, -1, -1):
        outs[t] = torch.gather(ids[t], 1, sel.long())
        sel = torch.gather(parents[t], 1, sel.long())
    return torch.stack(outs)


def edit_distance(hyps, refs, hyp_lengths, ref_lengths, normalized=True,
                  name=None):
    """Batched Levenshtein distance over padded ``[B, maxH]`` / ``[B,
    maxR]`` ids: ``([B] distances, [1] int64 count)``, the distance divided
    by the reference's length when ``normalized``.  One DP row a hypothesis
    position; the left-to-right minimum of a row is a running minimum of
    ``m[k] - k`` (exact on these small integers)."""
    B, maxH = hyps.shape
    maxR = refs.shape[1]
    dev = hyps.device
    hl, rl = hyp_lengths.long(), ref_lengths.long()
    j = torch.arange(maxR + 1, device=dev, dtype=torch.float32)
    row = j.expand(B, maxR + 1)
    for i in range(maxH):
        sub = (hyps[:, i:i + 1] != refs).float()
        m = torch.minimum(row[:, :-1] + sub, row[:, 1:] + 1.0)
        m = torch.cat([torch.full((B, 1), i + 1.0, device=dev), m], dim=1)
        new = torch.cummin(m - j, dim=1).values + j
        row = torch.where((i < hl)[:, None], new, row)
    dist = torch.gather(row, 1, rl[:, None])[:, 0]
    if normalized:
        dist = dist / torch.clamp_min(rl.float(), 1.0)
    return dist, torch.full((1,), B, dtype=torch.int64, device=dev)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Attention of ``[b, h, s, d]`` tensors over the CSR layout's nonzeros
    (``offset`` ``[b, h, s + 1]``, ``columns`` ``[b, h, nnz]``): the layout
    becomes a dense mask (others at -1e9) and the softmax and products run
    in float32; ``key_padding_mask`` and ``attn_mask`` are ignored, as in
    the reference (``nn/functional.py:2248``)."""
    q, k, v = _amp("sparse_attention", query, key, value)
    b, h, s, d = q.shape
    off, cols = sparse_csr_offset.long(), sparse_csr_columns.long()
    nnz = cols.shape[-1]
    i = torch.arange(nnz, device=q.device).expand(b, h, nnz).contiguous()
    r = torch.searchsorted(off.contiguous(), i, right=True) - 1
    valid = i < off[..., -1:]
    mask = torch.zeros((b, h, s + 1, s + 1), dtype=torch.bool,
                       device=q.device)
    bi = torch.arange(b, device=q.device)[:, None, None].expand(b, h, nnz)
    hi = torch.arange(h, device=q.device)[None, :, None].expand(b, h, nnz)
    mask[bi, hi, torch.where(valid, r, s), torch.where(valid, cols, s)] = True
    mask = mask[..., :s, :s]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * \
        (1.0 / math.sqrt(d))
    probs = torch.softmax(torch.where(mask, scores, -1e9), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


# ---------------- losses ----------------

def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The per-entry cross-entropy (``reduction="none"``) with ``axis``
    kept as a dim of 1; with ``return_softmax`` also the softmax."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    """``-input[n, label[n], ...]`` over dim 1, ``ignore_index`` skipped (a
    weighted mean divides by the kept entries' weights)."""
    logp, label, weight = _amp("nll_loss", input, label, weight)
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = torch.gather(logp, 1, safe.unsqueeze(1)).squeeze(1)
    loss = torch.where(valid, -picked, 0.0)
    if weight is not None:
        wt = weight[safe]
        loss = loss * wt
        if reduction == "mean":
            return loss.sum() / torch.clamp_min(
                torch.where(valid, wt, 0.0).sum(), 1e-10)
    return _reduce_loss(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0,  # noqa: A002
                   name=None):
    a, b = _amp("smooth_l1", input, label)
    d = torch.abs(a - b)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce_loss(loss, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean",  # noqa: A002
               name=None):
    a, b = _amp("huber_loss", input, label)
    diff = a - b
    ad = diff.abs()
    loss = torch.where(ad <= delta, 0.5 * diff * diff,
                       delta * (ad - 0.5 * delta))
    return _reduce_loss(loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean", name=None):
    p, y, weight = _amp("bce", input, label, weight)
    p = torch.clamp(p, 1e-12, 1 - 1e-12)
    loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, y, weight, pos_weight = _amp("bce_logits", logit, label, weight,
                                    pos_weight)
    max_val = torch.clamp_min(-z, 0.0)
    soft = torch.log1p(torch.exp(-z.abs()))
    if pos_weight is not None:
        loss = (1 - y) * z + ((pos_weight - 1) * y + 1) * (soft + max_val)
    else:
        loss = (1 - y) * z + soft + max_val
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y, normalizer = _amp("sigmoid_focal", logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False,  # noqa: A002
           name=None):
    logp, tgt = _amp("kl_div", input, label)
    if log_target:
        loss = torch.exp(tgt) * (tgt - logp)
    else:
        loss = tgt * (torch.log(torch.clamp_min(tgt, 1e-30)) - logp)
    if reduction == "batchmean":
        return loss.sum() / logp.shape[0]
    return _reduce_loss(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean", name=None):
    a, b, y = _amp("margin_ranking", input, other, label)
    return _reduce_loss(torch.clamp_min(-y * (a - b) + margin, 0.0),
                        reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    a, b, y = _amp("cosine_embedding", input1, input2, label)
    cos = torch.sum(a * b, dim=1) / torch.clamp_min(
        _vnorm(a, 2, 1) * _vnorm(b, 2, 1), 1e-8)
    loss = torch.where(y == 1, 1 - cos, torch.clamp_min(cos - margin, 0.0))
    return _reduce_loss(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2.0, epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = _amp("triplet_margin", input, positive, negative)
    dp = _vnorm(a - pos + epsilon, p, -1)
    dn = _vnorm(a - neg + epsilon, p, -1)
    if swap:
        dn = torch.minimum(dn, _vnorm(pos - neg + epsilon, p, -1))
    return _reduce_loss(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """``max(0, d(a, p) - d(a, n) + margin)``, ``d`` by default the 2-norm
    of the difference over the last dim (no epsilon)."""
    a, pos, neg = _amp("triplet_margin_with_distance_loss", input, positive,
                       negative)
    dist = distance_function if distance_function is not None else \
        (lambda u, w: _vnorm(u - w, 2, -1))
    d_pos, d_neg = dist(a, pos), dist(a, neg)
    if swap:
        d_neg = torch.minimum(d_neg, dist(pos, neg))
    return _reduce_loss(torch.clamp_min(d_pos - d_neg + margin, 0.0),
                        reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean", name=None):
    a, y = _amp("hinge_embedding", input, label)
    loss = torch.where(y == 1, a, torch.clamp_min(margin - a, 0.0))
    return _reduce_loss(loss, reduction)


def square_error_cost(input, label):  # noqa: A002
    a, b = _amp("square_error_cost", input, label)
    return torch.square(a - b)


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    p, y = _amp("log_loss", input, label)
    return -y * torch.log(p + epsilon) - (1.0 - y) * torch.log(
        1.0 - p + epsilon)


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    a, y = _amp("soft_margin_loss", input, label)
    return _reduce_loss(torch.log1p(torch.exp(-y * a)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean", name=None):
    a, y, weight = _amp("multi_label_soft_margin_loss", input, label, weight)
    loss = -(y * TF.logsigmoid(a) + (1 - y) * TF.logsigmoid(-a))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss.mean(dim=-1), reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,  # noqa: A002
                      reduction="mean", name=None):
    a, weight = _amp("multi_margin_loss", input, weight)
    n, c = a.shape
    y = label.long()
    correct = a[torch.arange(n, device=a.device), y][:, None]
    m = torch.clamp_min(margin - correct + a, 0.0)
    if p != 1:
        m = m ** p
    if weight is not None:
        m = m * weight[y][:, None]
    mask = 1.0 - one_hot(y, c).to(a.dtype)
    return _reduce_loss((m * mask).sum(dim=1) / c, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean", name=None):
    a, y = _amp("poisson_nll_loss", input, label)
    if log_input:
        loss = torch.exp(a) - y * a
    else:
        loss = a - y * torch.log(a + epsilon)
    if full:
        stirling = y * torch.log(y + epsilon) - y + \
            0.5 * torch.log(2 * math.pi * (y + epsilon))
        loss = loss + torch.where(y > 1, stirling, 0.0)
    return _reduce_loss(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False,  # noqa: A002
                      epsilon=1e-6, reduction="mean", name=None):
    a, y, var = _amp("gaussian_nll_loss", input, label, variance)
    var = torch.clamp_min(var, epsilon)
    loss = 0.5 * (torch.log(var) + (a - y) ** 2 / var)
    if full:
        loss = loss + 0.5 * torch.log(torch.full((), 2 * math.pi,
                                                 dtype=a.dtype,
                                                 device=a.device))
    return _reduce_loss(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    """``mean(1 - (2 |X n Y| + eps) / (|X| + |Y| + eps))`` over the
    flattened non-batch dims; integer labels of another shape than the
    input are one-hot over its last dim."""
    (a,) = _amp("dice_loss", input)
    n = a.shape[0]
    if tuple(label.shape) != tuple(a.shape):
        yf = one_hot(label.reshape(n, -1), a.shape[-1]).to(a.dtype)
    else:
        yf = label.reshape(n, -1)
    af, yf = a.reshape(n, -1), yf.reshape(n, -1)
    inter = (af * yf).sum(dim=1)
    union = af.sum(dim=1) + yf.sum(dim=1)
    return torch.mean(1.0 - (2 * inter + epsilon) / (union + epsilon))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    a, p = _amp("npair_loss", anchor, positive)
    sim = a @ p.T
    tgt = (labels[:, None] == labels[None, :]).to(a.dtype)
    tgt = tgt / tgt.sum(dim=1, keepdim=True)
    ce = -(torch.log_softmax(sim, dim=1) * tgt).sum(dim=1).mean()
    l2 = (torch.sum(a * a) + torch.sum(p * p)) / a.shape[0]
    return ce + l2_reg * l2 * 0.25


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0,
                         scale=64.0, group=None, return_softmax=False,
                         reduction="mean"):
    """ArcFace-style margin softmax cross-entropy over cosine logits: the
    target's logit becomes ``cos(margin1 * theta + margin2) - margin3``,
    all scaled by ``scale``, in float32.  ``group`` (classes sharded over
    ranks) raises until the port's distributed module (``ROADMAP.md`` item
    18)."""
    if group is not None:
        raise NotImplementedError("margin_cross_entropy(group=...) waits "
                                  "for the port's distributed module")
    (lg,) = _amp("margin_cross_entropy", logits)
    cos = torch.clamp(lg.float(), -1.0, 1.0)
    tgt = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    onehot = one_hot(label, lg.shape[-1])
    out = torch.where(onehot > 0, tgt, cos) * scale
    loss = torch.logsumexp(out, dim=-1) - torch.sum(out * onehot, dim=-1)
    loss = _reduce_loss(loss, reduction)
    if return_softmax:
        return loss, torch.softmax(out, dim=-1)
    return loss


def class_center_sample(label, num_classes, num_samples, group=None):
    """``num_samples`` class centres, the batch's positive classes first,
    each group in random order, returned sorted with the labels remapped
    to their positions among them (a label left out maps to
    ``num_samples - 1``).  ``group`` raises as in
    :func:`margin_cross_entropy`."""
    if group is not None:
        raise NotImplementedError("class_center_sample(group=...) waits "
                                  "for the port's distributed module")
    pos = torch.zeros((num_classes,), dtype=torch.float32,
                      device=label.device)
    pos[label.long()] = 1.0
    noise = torch.rand((num_classes,), device=label.device,
                       generator=_gen(label))
    rank = torch.argsort(-pos + noise * 0.5)
    sampled = torch.sort(rank[:num_samples]).values.to(label.dtype)
    idx = torch.searchsorted(sampled, label.contiguous())
    idx_c = torch.clamp(idx, 0, num_samples - 1)
    found = sampled[idx_c] == label
    return torch.where(found, idx_c, num_samples - 1).to(label.dtype), sampled


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid, the per-sample ``[N, 1]`` loss in float32.
    Without ``path_table`` / ``path_code`` class c's path is the binary
    expansion of ``c + num_classes`` from the root (internal node ``(code
    >> k) - 1``); a custom tree gives node ids (negative: padding) and bits
    a sample."""
    x, weight, bias = _amp("hsigmoid_loss", input, weight, bias)
    xf = x.float()

    def node_loss(node, bit, valid):
        nw = weight[torch.clamp(node, 0, weight.shape[0] - 1)].float()
        logit = torch.einsum("bd,bd->b", xf, nw)
        if bias is not None:
            logit = logit + bias[torch.clamp(node, 0,
                                             bias.shape[0] - 1)].float()
        bce = torch.clamp_min(logit, 0) - logit * bit + \
            torch.log1p(torch.exp(-logit.abs()))
        return torch.where(valid, bce, 0.0)

    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    if path_table is not None and path_code is not None:
        for k in range(path_table.shape[1]):
            node = path_table[:, k].long()
            total = total + node_loss(node, path_code[:, k].float(),
                                      node >= 0)
    else:
        depth = max(1, int(math.ceil(math.log2(max(2, num_classes)))))
        code = label.long() + num_classes
        for k in range(depth, 0, -1):
            node = (code >> k) - 1
            bit = ((code >> (k - 1)) & 1).float()
            total = total + node_loss(node, bit, node >= 0)
    return total[:, None]


def adaptive_log_softmax_with_loss(input, label, head_weight,  # noqa: A002
                                   head_bias, cutoffs, tail_weights,
                                   name=None):
    """The adaptive softmax of Grave et al. in float32: a head over the
    shortlist and one entry a cluster, two-matrix tails.  Returns (each
    sample's target log-probability, the mean negative of it)."""
    x, head_weight, head_bias = _amp("adaptive_log_softmax_with_loss",
                                     input, head_weight, head_bias)
    cutoffs = list(cutoffs)
    short = cutoffs[0]
    xf = x.float()
    head = xf @ head_weight.float().T
    if head_bias is not None:
        head = head + head_bias.float()
    head_lsm = torch.log_softmax(head, dim=-1)
    lab = label.long()
    out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    short_lp = torch.gather(head_lsm, 1,
                            torch.clamp(lab, 0, short - 1)[:, None])[:, 0]
    out = torch.where(lab < short, short_lp, out)
    for c in range(len(cutoffs) - 1):
        lo, hi = cutoffs[c], cutoffs[c + 1]
        w1, w2 = tail_weights[c]
        tail_lsm = torch.log_softmax((xf @ w1.float()) @ w2.float(), dim=-1)
        rel = torch.clamp(lab - lo, 0, hi - lo - 1)
        lp = head_lsm[:, short + c] + torch.gather(tail_lsm, 1,
                                                   rel[:, None])[:, 0]
        out = torch.where((lab >= lo) & (lab < hi), lp, out)
    return out, -torch.mean(out)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """Connectionist Temporal Classification loss, warpctc's semantics as
    the reference keeps them (``nn/functional.py:1231``): ``log_probs``
    ``[T, B, C]`` are logits (log_softmax is applied here, in float32),
    the alpha recursion over the extended label runs once a time step in
    log space with -1e30 for minus infinity (an input too short for its
    labels gives a huge finite loss, not inf), its gradient is autograd's
    through the steps.  ``norm_by_times`` divides each loss by its input
    length; ``"mean"`` divides each by its label length, then averages."""
    (lp,) = _amp("ctc_loss", log_probs)
    T, B, _ = lp.shape
    lp = torch.log_softmax(lp.float(), dim=-1)
    dev = lp.device
    lab = labels.long()
    L = lab.shape[1]
    S = 2 * L + 1
    s = torch.arange(S, device=dev)
    lab_at = lab[:, torch.clamp(torch.div(s - 1, 2, rounding_mode="floor"),
                                0, max(L - 1, 0))]
    ext = torch.where(s[None, :] % 2 == 0, blank, lab_at)
    prev2 = torch.cat([torch.full((B, 2), -1, dtype=ext.dtype, device=dev),
                       ext[:, :-2]], dim=1)
    skip = (s[None, :] % 2 == 1) & (ext != prev2)
    emit = torch.gather(lp, 2, ext[None].expand(T, B, S))   # [T, B, S]
    neg1 = torch.full((B, 1), _NEG, device=dev)
    alpha = torch.where(s[None, :] < 2, emit[0], _NEG)
    alphas = [alpha]
    for t in range(1, T):
        a2 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        a3 = torch.where(skip, torch.cat([neg1, neg1, alpha[:, :-2]], dim=1),
                         _NEG)
        m = torch.maximum(torch.maximum(alpha, a2), a3)
        tot = m + torch.log(torch.exp(alpha - m) + torch.exp(a2 - m) +
                            torch.exp(a3 - m))
        alpha = tot + emit[t]
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    t_idx = torch.clamp(input_lengths.long() - 1, 0, T - 1)
    a_last = alphas[t_idx, torch.arange(B, device=dev)]
    sl = 2 * label_lengths.long()
    a_end = torch.gather(a_last, 1, sl[:, None])[:, 0]
    a_end2 = torch.gather(a_last, 1, torch.clamp_min(sl - 1, 0)[:, None])[:, 0]
    m = torch.maximum(a_end, a_end2)
    loss = -(m + torch.log(torch.exp(a_end - m) + torch.exp(a_end2 - m)))
    if norm_by_times:
        loss = loss / torch.clamp_min(input_lengths.float(), 1.0)
    if reduction == "mean":
        return torch.mean(loss / torch.clamp_min(label_lengths.float(), 1.0))
    return _reduce_loss(loss, reduction)


def rnnt_loss(logits, labels, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-Transducer loss over ``[B, T, U + 1, V]`` logits (log_softmax
    applied here, in float32) and ``[B, U]`` labels, the reference's
    arithmetic (``nn/functional.py:1112``): alpha(t, u) =
    logaddexp(alpha(t - 1, u) + blank(t - 1, u), alpha(t, u - 1) +
    label(t, u - 1)), a plain sum on the first row and column.  The
    lattice is walked by anti-diagonals ``t + u = d`` (T + U - 1 steps,
    each a vector over u), not by a loop over u inside one over t; a
    missing term is -1e30, which logaddexp adds as exactly 0.
    ``fastemit_lambda`` is accepted and ignored, as in the reference;
    ``"mean"`` averages the per-sequence losses."""
    (lg,) = _amp("rnnt_loss", logits)
    B, T, U1, _ = lg.shape
    U = U1 - 1
    dev = lg.device
    lp = torch.log_softmax(lg.float(), dim=-1)
    blank_lp = lp[..., blank]                                   # [B, T, U+1]
    lab_lp = torch.gather(lp[:, :, :U, :], 3, labels.long()[:, None, :, None]
                          .expand(B, T, U, 1))[..., 0]          # [B, T, U]
    u = torch.arange(U1, device=dev)
    D = T + U
    d = torch.arange(1, D, device=dev)[:, None]                 # [D-1, 1]
    th, tv = d - 1 - u, d - u               # rows of the two moves into d
    ok_h = (th >= 0) & (th < T)
    ok_v = (tv >= 0) & (tv < T) & (u >= 1)
    horiz = torch.where(ok_h, blank_lp[:, th.clamp(0, T - 1), u], _NEG)
    lab_pad = torch.cat([torch.zeros((B, T, 1), device=dev), lab_lp], dim=2)
    vert = torch.where(ok_v, lab_pad[:, tv.clamp(0, T - 1), u], _NEG)
    diag = torch.where(u == 0, 0.0, _NEG).expand(B, U1)         # d = 0
    diags = [diag]
    neg1 = torch.full((B, 1), _NEG, device=dev)
    for k in range(D - 1):
        from_h = diag + horiz[:, k]
        from_v = torch.cat([neg1, diag[:, :-1]], dim=1) + vert[:, k]
        cell_ok = (tv[k] >= 0) & (tv[k] < T)
        diag = torch.where(cell_ok, torch.logaddexp(from_h, from_v), _NEG)
        diags.append(diag)
    alphas = torch.stack(diags, dim=1)                          # [B, D, U+1]
    t_idx = torch.clamp(input_lengths.long() - 1, 0, T - 1)
    u_len = label_lengths.long()
    bi = torch.arange(B, device=dev)
    a_end = alphas[bi, t_idx + u_len, u_len]
    loss = -(a_end + blank_lp[bi, t_idx, u_len])
    return _reduce_loss(loss, reduction)

__all__ = [
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_log_softmax_with_loss", "adaptive_max_pool1d",
    "adaptive_max_pool2d", "adaptive_max_pool3d", "affine_grid",
    "alpha_dropout", "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "batch_norm", "bilinear", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "celu", "channel_shuffle",
    "class_center_sample", "conv1d", "conv1d_transpose", "conv2d",
    "conv2d_transpose", "conv3d", "conv3d_transpose",
    "cosine_embedding_loss", "cosine_similarity", "cross_entropy",
    "ctc_loss", "dice_loss", "dropout", "dropout2d", "dropout3d",
    "edit_distance", "elu", "elu_", "embedding", "feature_alpha_dropout",
    "flash_attention", "flash_attn_qkvpacked",
    "flash_attn_varlen_qkvpacked", "flashmask_attention", "fold",
    "fractional_max_pool2d", "fractional_max_pool3d",
    "fused_softmax_mask", "fused_softmax_mask_upper_triangle",
    "gather_tree", "gaussian_nll_loss", "gelu", "glu", "grid_sample",
    "group_norm", "gumbel_softmax", "hardshrink", "hardsigmoid",
    "hardswish", "hardtanh", "hardtanh_", "hinge_embedding_loss",
    "hsigmoid_loss", "huber_loss", "instance_norm", "interpolate",
    "kl_div", "l1_loss", "label_smooth", "layer_norm", "leaky_relu",
    "leaky_relu_", "linear", "local_response_norm", "log_loss",
    "log_sigmoid", "log_softmax", "lp_pool1d", "lp_pool2d",
    "margin_cross_entropy", "margin_ranking_loss", "max_pool1d",
    "max_pool2d", "max_pool2d_with_index", "max_pool3d",
    "max_pool3d_with_index", "max_unpool1d", "max_unpool2d",
    "max_unpool3d", "maxout", "mish", "mse_loss",
    "multi_label_soft_margin_loss", "multi_margin_loss", "nll_loss",
    "normalize", "npair_loss", "one_hot", "pad", "pairwise_distance",
    "pixel_shuffle", "pixel_unshuffle", "poisson_nll_loss", "prelu",
    "relu", "relu6", "relu_", "rms_norm", "rnnt_loss", "rrelu",
    "scaled_dot_product_attention", "selu", "sequence_mask", "sigmoid",
    "sigmoid_focal_loss", "silu", "smooth_l1_loss", "soft_margin_loss",
    "softmax", "softmax_", "softmax_with_cross_entropy", "softplus",
    "softshrink", "softsign", "sparse_attention", "spectral_norm",
    "square_error_cost", "swiglu", "swish", "sync_batch_norm", "tanh",
    "tanh_", "tanh_shrink", "tanhshrink", "temporal_shift",
    "thresholded_relu", "thresholded_relu_", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "unfold", "upsample", "zeropad2d"]
