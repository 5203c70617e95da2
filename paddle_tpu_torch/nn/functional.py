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

import torch
import torch.nn.functional as TF

from ..core.amp_state import cast as _amp
from ..core.random import generator
from ..kernels import flash_attention as _fa


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


# ================= convolution =================

def _same_pads(size, k, s, d):
    """XLA's 'SAME' padding of one spatial dim: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """Convolution with a ``[out, in / groups, kh, kw]`` weight; ``padding``
    is an int, a pair, four ints ``[top, bottom, left, right]``, the full
    ``[[0, 0], [0, 0], [t, b], [l, r]]`` form, or "SAME" / "VALID"."""
    x, weight, bias = _amp("conv2d", x, weight, bias)
    channels_last = data_format == "NHWC"
    if channels_last:
        x = x.permute(0, 3, 1, 2)
    stride, dilation = _pair(stride), _pair(dilation)
    kh, kw = weight.shape[-2:]
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = ((0, 0), (0, 0))
        elif padding.upper() == "SAME":
            pads = tuple(_same_pads(n, k, s, d) for n, k, s, d in zip(
                x.shape[-2:], (kh, kw), stride, dilation))
        else:
            raise ValueError(f"bad padding {padding}")
    elif isinstance(padding, (list, tuple)) and padding and             isinstance(padding[0], (list, tuple)):
        sp = padding[1:-1] if channels_last else padding[2:]
        pads = tuple(tuple(int(v) for v in p) for p in sp)
    elif isinstance(padding, (list, tuple)) and len(padding) == 4:
        pads = ((int(padding[0]), int(padding[1])),
                (int(padding[2]), int(padding[3])))
    else:
        pads = tuple((p, p) for p in _pair(padding))
    if all(lo == hi for lo, hi in pads):
        out = TF.conv2d(x, weight, bias, stride, tuple(lo for lo, _ in pads),
                        dilation, groups)
    else:
        x = TF.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        out = TF.conv2d(x, weight, bias, stride, 0, dilation, groups)
    return out.permute(0, 2, 3, 1) if channels_last else out


# ================= pooling =================

def _nchw(x, data_format):
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(x, data_format):
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """Max over windows padded with -inf (``ceil_mode`` is ignored, as in
    the reference)."""
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported yet")
    (x,) = _amp("max_pool2d", x)
    k = _pair(kernel_size)
    out = TF.max_pool2d(_nchw(x, data_format), k,
                        _pair(stride if stride is not None else k),
                        _pair(padding))
    return _back(out, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Mean over windows; with ``exclusive`` the padding is not counted
    (``ceil_mode`` is ignored, as in the reference)."""
    (x,) = _amp("avg_pool2d", x)
    k = _pair(kernel_size)
    out = TF.avg_pool2d(_nchw(x, data_format), k,
                        _pair(stride if stride is not None else k),
                        _pair(padding), count_include_pad=not exclusive,
                        divisor_override=divisor_override or None)
    return _back(out, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over torch's adaptive bins (bin i of n spans [floor(i n_in /
    n), ceil((i + 1) n_in / n))), the bins the reference builds."""
    (x,) = _amp("adaptive_avg_pool2d", x)
    out = TF.adaptive_avg_pool2d(_nchw(x, data_format), _pair(output_size))
    return _back(out, data_format)


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


__all__ = [
    "adaptive_avg_pool2d", "avg_pool2d", "batch_norm", "celu",
    "conv2d", "cross_entropy", "dropout", "elu", "embedding",
    "flash_attention", "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked",
    "flashmask_attention",
    "gelu", "glu", "hardshrink", "hardsigmoid", "hardswish", "hardtanh",
    "l1_loss", "layer_norm", "leaky_relu", "linear", "log_sigmoid",
    "log_softmax", "max_pool2d", "maxout", "mish", "mse_loss",
    "relu", "relu6", "scaled_dot_product_attention", "selu", "sigmoid",
    "silu", "softmax", "softplus", "softshrink", "softsign", "swish", "tanh",
    "tanhshrink"]
