"""The port of ``paddle_tpu.nn``: ``Layer`` and the layers the Paddle-API
training path builds (``paddle_tpu/nn/__init__.py``), over
:mod:`paddle_tpu_torch.nn.functional`.

State names and layouts are the reference's: ``Linear.weight`` is ``[in,
out]``, a conv weight ``[out, in / groups, kh, kw]``, and BatchNorm keeps its
running statistics in the buffers ``_mean`` and ``_variance``.  The rest of
the reference's ``nn`` (conv variants, RNNs, the other losses,
``nn/utils.py``, ``nn/decode.py``) waits for a later slice (``ROADMAP.md``).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from . import functional  # noqa: F401
from . import functional as F
from . import initializer  # noqa: F401
from . import initializer as I
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer import Layer, LayerList, ParamAttr, ParameterList, Sequential
from ..ops.manipulation import flatten
from ..ops.math import add


def _bias_attr(attr):
    return None if attr in (None, True) else attr


class Linear(Layer):
    """``y = x W + b`` with ``W`` laid out ``[in_features, out_features]``
    (XavierNormal), ``b`` zeros."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=_bias_attr(bias_attr), is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)


class Identity(Layer):
    def forward(self, x):
        return x


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


def _act_layer(name, fn):
    """A layer class calling ``fn(x, *args, **kwargs)`` with the
    constructor's arguments (the reference's ``_act_layer``, :89)."""
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._args, self._kwargs = args, kwargs
            self._kwargs.pop("name", None)

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)
    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu)
GELU = _act_layer("GELU", F.gelu)
Silu = _act_layer("Silu", F.silu)
SiLU = Silu
Swish = _act_layer("Swish", F.swish)
Mish = _act_layer("Mish", F.mish)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
LogSigmoid = _act_layer("LogSigmoid", F.log_sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
Hardshrink = _act_layer("Hardshrink", F.hardshrink)
Softshrink = _act_layer("Softshrink", F.softshrink)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardtanh = _act_layer("Hardtanh", F.hardtanh)
ELU = _act_layer("ELU", F.elu)
CELU = _act_layer("CELU", F.celu)
SELU = _act_layer("SELU", F.selu)
Softplus = _act_layer("Softplus", F.softplus)
Softsign = _act_layer("Softsign", F.softsign)
Softmax = _act_layer("Softmax", F.softmax)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax)
Maxout = _act_layer("Maxout", F.maxout)
GLU = _act_layer("GLU", F.glu)


class Conv2D(Layer):
    """2-D convolution, weight ``[out, in / groups, kh, kw]`` drawn by
    ``KaimingUniform(fan_in)``, bias by ``Uniform(+-1/sqrt(fan_in))``
    (the reference's ``_ConvNd``, :141)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * 2
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = tuple(kernel_size)
        self._stride, self._padding, self._dilation = stride, padding, \
            dilation
        self._groups, self._data_format = groups, data_format
        fan_in = in_channels * int(np.prod(kernel_size)) // groups
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *kernel_size],
            attr=weight_attr, default_initializer=I.KaimingUniform(
                fan_in=fan_in))
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=_bias_attr(bias_attr), is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class _NormBase(Layer):
    """Batch norm over the channel dim: weight ones, bias zeros, running
    mean and variance in the float32 buffers ``_mean`` / ``_variance``."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_features],
                                  attr=_bias_attr(weight_attr),
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=_bias_attr(bias_attr), is_bias=True)
        self.register_buffer("_mean", I.Constant(0.0)([num_features],
                                                      torch.float32))
        self.register_buffer("_variance", I.Constant(1.0)([num_features],
                                                          torch.float32))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm(_NormBase):
    pass


class BatchNorm1D(_NormBase):
    pass


class BatchNorm2D(_NormBase):
    pass


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(self._normalized_shape,
                                  attr=_bias_attr(weight_attr),
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=_bias_attr(bias_attr), is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p,
                            data_format=self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive, self.divisor = exclusive, divisor_override
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p,
                            exclusive=self.exclusive,
                            divisor_override=self.divisor,
                            data_format=self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


# ---------------- attention / transformer ----------------

class MultiHeadAttention(Layer):
    """Self or cross attention through the plain
    ``scaled_dot_product_attention``, as in the reference (:474): the flash
    kernels are not on this layer's path."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim, vdim = kdim or embed_dim, vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        b, h, d = query.shape[0], self.num_heads, self.head_dim
        q = self.q_proj(query).reshape([b, -1, h, d])
        k = self.k_proj(key).reshape([b, -1, h, d])
        v = self.v_proj(value).reshape([b, -1, h, d])
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             dropout_p=self.dropout,
                                             training=self.training)
        return self.out_proj(out.reshape([b, -1, self.embed_dim]))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = {"relu": F.relu, "gelu": F.gelu}[activation]

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, attn_mask=src_mask)
        src = add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout_act(self.activation(
            self.linear1(src))))
        src = add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [
            copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


# ---------------- losses ----------------

class _Loss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction


class CrossEntropyLoss(_Loss):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__(reduction)
        self.weight, self.ignore_index = weight, ignore_index
        self.soft_label, self.axis = soft_label, axis
        self.use_softmax, self.label_smoothing = use_softmax, label_smoothing

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax,
                               label_smoothing=self.label_smoothing)


class MSELoss(_Loss):
    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class L1Loss(_Loss):
    def forward(self, input, label):  # noqa: A002
        return F.l1_loss(input, label, self.reduction)


__all__ = [
    "AdaptiveAvgPool2D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
    "BatchNorm2D", "CELU", "ClipGradByGlobalNorm", "ClipGradByNorm",
    "ClipGradByValue", "Conv2D", "CrossEntropyLoss", "Dropout", "ELU",
    "Embedding", "Flatten", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
    "Hardswish", "Hardtanh", "Identity", "L1Loss", "Layer", "LayerList",
    "LayerNorm", "LeakyReLU", "Linear", "LogSigmoid", "LogSoftmax", "MSELoss",
    "MaxPool2D", "Maxout", "Mish", "MultiHeadAttention", "ParamAttr",
    "ParameterList", "ReLU", "ReLU6", "SELU", "Sequential", "SiLU", "Sigmoid",
    "Silu", "Softmax", "Softplus", "Softshrink", "Softsign", "Swish", "Tanh",
    "Tanhshrink", "TransformerEncoder", "TransformerEncoderLayer",
    "clip_grad_norm_", "functional", "initializer"]
