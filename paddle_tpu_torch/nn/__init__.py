"""The port of ``paddle_tpu.nn``: ``Layer`` and the layers the Paddle-API
training path builds (``paddle_tpu/nn/__init__.py``), over
:mod:`paddle_tpu_torch.nn.functional`.

State names and layouts are the reference's: ``Linear.weight`` is ``[in,
out]``, a conv weight ``[out, in / groups, kh, kw]``, and BatchNorm keeps its
running statistics in the buffers ``_mean`` and ``_variance``.  The
recurrent layers (:mod:`.rnn`), beam search (:mod:`.decode`),
:mod:`.utils`, the Transformer decoder, the losses and the containers are
in, and so is the spatial half: the 1-D, 3-D and transposed convolutions,
every pool, the pads, resampling and the image norms (none of them a
Pallas kernel in the reference: XLA convolutions, ``reduce_window`` and
plain ``jnp``; here cuDNN / ATen, with the reference's own rules where
they are not torch's).
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
from ..core.amp_state import cast as _amp
from ..core.tensor import Parameter
from ..ops.manipulation import flatten
from ..ops.math import add

Tensor = torch.Tensor


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


class _ConvNd(Layer):
    """An ``nd``-D convolution's parameters: weight ``[out, in / groups,
    k...]`` drawn by ``KaimingUniform(fan_in)``, bias by
    ``Uniform(+-1/sqrt(fan_in))`` (the reference's ``_ConvNd``, :141)."""

    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * nd
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
        return self._conv(x, self.weight, self.bias, self._stride,
                          self._padding, self._dilation, self._groups,
                          self._data_format)


class Conv1D(_ConvNd):
    _conv = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv2D(_ConvNd):
    _conv = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv3D(_ConvNd):
    _conv = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class _ConvTransposeNd(Layer):
    """A transposed convolution's parameters: weight ``[in, out / groups,
    k...]`` drawn by ``XavierNormal``, bias zeros (the reference's
    ``Conv2DTranspose``, :195)."""

    def __init__(self, in_channels, out_channels, kernel_size, nd, stride,
                 padding, output_padding, dilation, groups, weight_attr,
                 bias_attr, data_format):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * nd
        self._stride, self._padding = stride, padding
        self._output_padding = output_padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, *kernel_size],
            attr=weight_attr, default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], attr=None, is_bias=True)

    def forward(self, x, output_size=None):
        return self._conv(x, self.weight, self.bias, self._stride,
                          self._padding, self._output_padding, self._groups,
                          self._dilation, self._data_format, output_size)


class Conv1DTranspose(_ConvTransposeNd):
    _conv = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format)


class Conv2DTranspose(_ConvTransposeNd):
    """(``dilation`` before ``groups`` in the constructor, as in the
    reference; the 1-D and 3-D forms take ``groups`` first.)"""
    _conv = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format)


class Conv3DTranspose(_ConvTransposeNd):
    _conv = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, output_padding, dilation, groups,
                         weight_attr, bias_attr, data_format)


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


class BatchNorm3D(_NormBase):
    pass


class SyncBatchNorm(_NormBase):
    """Batch norm over every rank of ``group`` (:func:`F.sync_batch_norm`:
    in one process, batch norm)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 group=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format)
        self._group = group

    def forward(self, x):
        return F.sync_batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            group=self._group)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every other batch norm in it replaced by a
        ``SyncBatchNorm`` that takes over its parameters, running
        statistics and mode (a batch norm ``layer`` is itself replaced and
        returned)."""
        if isinstance(layer, _NormBase) and not isinstance(layer, cls):
            new = cls(layer._num_features, momentum=layer._momentum,
                      epsilon=layer._epsilon, data_format=layer._data_format)
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            new.train(layer.training)
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


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


class AdaptiveMaxPool2D(Layer):
    """``return_mask`` is ignored, as in the reference (and by the 1-D and
    3-D forms)."""

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class MaxPool1D(Layer):
    """``return_mask`` is ignored, as in the reference."""

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return F.max_pool1d(x, self.k, self.s, self.p)


class AvgPool1D(Layer):
    """``exclusive`` is ignored, as in the reference: the window's size
    divides."""

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p)


class MaxPool3D(Layer):
    """With ``return_mask``, ``(out, index)`` (:func:`F.max_pool3d_with_index`,
    over "NCDHW")."""

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.return_mask, self.data_format = return_mask, data_format

    def forward(self, x):
        if self.return_mask:
            return F.max_pool3d_with_index(x, self.k, self.s, self.p)
        return F.max_pool3d(x, self.k, self.s, self.p,
                            data_format=self.data_format)


class AvgPool3D(AvgPool2D):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)

    def forward(self, x):
        return F.avg_pool3d(x, self.k, self.s, self.p,
                            exclusive=self.exclusive,
                            divisor_override=self.divisor,
                            data_format=self.data_format)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool3D(AdaptiveAvgPool2D):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size, data_format)

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(AdaptiveMaxPool2D):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool3D(AdaptiveMaxPool2D):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size)


class _MaxUnPool(Layer):
    """Unpooling by :func:`F.max_unpool1d` / ``2d`` / ``3d`` (``data_format``
    is not passed on, as in the reference)."""

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding
        self.output_size = output_size

    def forward(self, x, indices):
        return self._unpool(x, indices, self.k, self.s, self.p,
                            output_size=self.output_size)


class MaxUnPool1D(_MaxUnPool):
    _unpool = staticmethod(F.max_unpool1d)


class MaxUnPool2D(_MaxUnPool):
    _unpool = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPool):
    _unpool = staticmethod(F.max_unpool3d)


class FractionalMaxPool2D(Layer):
    def __init__(self, output_size, kernel_size=None, random_u=None,
                 return_mask=False, name=None):
        super().__init__()
        self.output_size, self.random_u = output_size, random_u

    def forward(self, x):
        return F.fractional_max_pool2d(x, self.output_size,
                                       random_u=self.random_u)


class FractionalMaxPool3D(FractionalMaxPool2D):
    def forward(self, x):
        return F.fractional_max_pool3d(x, self.output_size,
                                       random_u=self.random_u)


class LPPool1D(Layer):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__()
        self._args = (norm_type, kernel_size, stride, padding, ceil_mode,
                      data_format)

    def forward(self, x):
        n, k, s, p, c, df = self._args
        return F.lp_pool1d(x, n, k, stride=s, padding=p, ceil_mode=c,
                           data_format=df)


class LPPool2D(LPPool1D):
    def __init__(self, norm_type, kernel_size, stride=None, padding=0,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(norm_type, kernel_size, stride, padding, ceil_mode,
                         data_format)

    def forward(self, x):
        n, k, s, p, c, df = self._args
        return F.lp_pool2d(x, n, k, stride=s, padding=p, ceil_mode=c,
                           data_format=df)


class GroupNorm(Layer):
    """Group norm: weight ones, bias zeros (``weight_attr`` / ``bias_attr``
    False drop them; other attributes are not read, as in the
    reference)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_channels],
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm2D(Layer):
    """Instance norm with the reference's parameter names: ``scale`` (ones)
    and ``bias`` (zeros); ``momentum`` and ``data_format`` are not used."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.scale = None if weight_attr is False else \
            self.create_parameter([num_features],
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(InstanceNorm2D):
    pass


class InstanceNorm3D(InstanceNorm2D):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k)
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, *self.args,
                                     data_format=self.data_format)


class SpectralNorm(Layer):
    """:func:`F.spectral_norm` of the weight it is called on (no state:
    the power iteration starts from ones each call)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32"):
        super().__init__()
        self.dim, self.power_iters, self.epsilon = dim, power_iters, epsilon

    def forward(self, weight):
        return F.spectral_norm(weight, self.power_iters, self.epsilon,
                               self.dim)


class Pad1D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad2D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad1D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad1D(Pad1D):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class ZeroPad2D(Pad1D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class ZeroPad3D(Pad1D):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    """Bilinear with ``align_corners=True``."""

    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", align_corners=True,
                         data_format=data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.r)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r, self.data_format = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.r, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings,
                     dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


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


class NLLLoss(_Loss):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.weight, self.ignore_index = weight, ignore_index

    def forward(self, input, label):  # noqa: A002
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(_Loss):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(reduction)
        self.weight = weight

    def forward(self, input, label):  # noqa: A002
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(_Loss):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(reduction)
        self.weight, self.pos_weight = weight, pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class KLDivLoss(_Loss):
    def forward(self, input, label):  # noqa: A002
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(_Loss):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction)
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(_Loss):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin

    def forward(self, input, other, label):  # noqa: A002
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """The ``p``-norm of ``x - y`` over the last dim.  ``epsilon`` is
    accepted and not added, as in the reference's layer (its functional
    form adds it)."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        (d,) = _amp("norm", x - y)
        return torch.linalg.vector_norm(d, ord=self.p, dim=-1,
                                        keepdim=self.keepdim)


class CTCLoss(_Loss):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__(reduction)
        self.blank = blank

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class CosineEmbeddingLoss(_Loss):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class HingeEmbeddingLoss(_Loss):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin

    def forward(self, input, label):  # noqa: A002
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class MultiLabelSoftMarginLoss(_Loss):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(reduction)
        self.weight = weight

    def forward(self, input, label):  # noqa: A002
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class MultiMarginLoss(_Loss):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.p, self.margin, self.weight = p, margin, weight

    def forward(self, input, label):  # noqa: A002
        return F.multi_margin_loss(input, label, self.p, self.margin,
                                   self.weight, self.reduction)


class PoissonNLLLoss(_Loss):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.log_input, self.full, self.epsilon = log_input, full, epsilon

    def forward(self, input, label):  # noqa: A002
        return F.poisson_nll_loss(input, label, self.log_input, self.full,
                                  self.epsilon, self.reduction)


class GaussianNLLLoss(_Loss):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.full, self.epsilon = full, epsilon

    def forward(self, input, label, variance):  # noqa: A002
        return F.gaussian_nll_loss(input, label, variance, self.full,
                                   self.epsilon, self.reduction)


class SoftMarginLoss(_Loss):
    def forward(self, input, label):  # noqa: A002
        return F.soft_margin_loss(input, label, self.reduction)


class TripletMarginLoss(_Loss):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.margin, self.p, self.epsilon, self.swap = margin, p, epsilon, \
            swap

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class TripletMarginWithDistanceLoss(_Loss):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.distance_function, self.margin, self.swap = \
            distance_function, margin, swap

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, self.distance_function, self.margin,
            self.swap, self.reduction)


class RNNTLoss(_Loss):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.blank, self.fastemit_lambda = blank, fastemit_lambda

    def forward(self, input, label, input_lengths,  # noqa: A002
                label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths,
                           blank=self.blank, reduction=self.reduction,
                           fastemit_lambda=self.fastemit_lambda)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over a complete binary tree (or a custom one):
    ``weight`` ``[num_classes - 1, feature_size]`` ~ Normal(0, 0.1),
    ``bias`` zeros."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr,
            default_initializer=I.Normal(0.0, 0.1))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1], attr=_bias_attr(bias_attr), is_bias=True)

    def forward(self, input, label, path_table=None,  # noqa: A002
                path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               bias=self.bias, path_table=path_table,
                               path_code=path_code)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """The adaptive softmax (Grave et al.): ``head_weight`` ``[shortlist +
    clusters, in_features]``, tails ``[in, in / div^(c+1)]`` and ``[that,
    cluster size]`` in ``tail_weights`` (a ``ParameterList``), XavierNormal
    throughout."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0,
                 head_bias=False, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        cutoffs = list(cutoffs)
        if not cutoffs or cutoffs != sorted(set(cutoffs)) or \
                cutoffs[-1] > n_classes:
            raise ValueError(f"invalid cutoffs {cutoffs}")
        if cutoffs[-1] != n_classes:
            cutoffs = cutoffs + [n_classes]
        self.cutoffs = cutoffs
        self.n_clusters = len(cutoffs) - 1
        short = cutoffs[0]
        self.head_weight = self.create_parameter(
            [short + self.n_clusters, in_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.head_bias = self.create_parameter(
            [short + self.n_clusters], is_bias=True) if head_bias else None
        self.tail_weights = ParameterList()
        for c in range(self.n_clusters):
            hid = max(1, int(in_features / (div_value ** (c + 1))))
            self.tail_weights.append(self.create_parameter(
                [in_features, hid], default_initializer=I.XavierNormal()))
            self.tail_weights.append(self.create_parameter(
                [hid, cutoffs[c + 1] - cutoffs[c]],
                default_initializer=I.XavierNormal()))

    def forward(self, input, label):  # noqa: A002
        tails = [(self.tail_weights[2 * c], self.tail_weights[2 * c + 1])
                 for c in range(self.n_clusters)]
        return F.adaptive_log_softmax_with_loss(
            input, label, self.head_weight, self.head_bias, self.cutoffs,
            tails)

    def log_prob(self, input):  # noqa: A002
        raise NotImplementedError(
            "log_prob over the full vocabulary is not implemented; use "
            "forward(input, label) for target log-probs")

    def predict(self, input):  # noqa: A002
        raise NotImplementedError(
            "predict is not implemented; take argmax over forward log-probs")


# ---------------- activations, dropouts, the rest ----------------

class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self.threshold, self.value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold, self.value)


class Softmax2D(Layer):
    """Softmax over the channel dim of NCHW input."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    """``data_format`` is accepted and not passed on, as in the reference:
    the channel dim is 1."""

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, p=self.p, training=self.training)


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class Bilinear(Layer):
    """``out[b, o] = x1[b] W[o] x2[b]^T + bias``: ``weight`` ``[out, in1,
    in2]`` and ``bias`` ``[1, out]``, both ``Uniform(+-1/sqrt(in1))``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in1_features)
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=I.Uniform(-bound, bound))
        self.bias = None if bias_attr is False else self.create_parameter(
            [1, out_features], attr=None, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape_ = axis, shape

    def forward(self, x):
        axis = self.axis % x.ndim
        return x.reshape(list(x.shape[:axis]) + list(self.shape_) +
                         list(x.shape[axis + 1:]))


class ParameterDict(Layer):
    """Parameters by name (reference :1337)."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            self.update(parameters)

    def __setitem__(self, key, param):
        self.add_parameter(str(key), param)

    def __getitem__(self, key):
        return self._parameters[str(key)]

    def __contains__(self, key):
        return str(key) in self._parameters

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters)

    def keys(self):
        return self._parameters.keys()

    def values(self):
        return self._parameters.values()

    def items(self):
        return self._parameters.items()

    def update(self, parameters):
        items = parameters.items() if isinstance(parameters, dict) \
            else parameters
        for k, v in items:
            self[k] = v


class LayerDict(Layer):
    """Sublayers by name (reference :1376)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __setitem__(self, key, layer):
        self.add_sublayer(str(key), layer)

    def __getitem__(self, key):
        return self._modules[str(key)]

    def __delitem__(self, key):
        del self._modules[str(key)]

    def __contains__(self, key):
        return str(key) in self._modules

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        layer = self[key]
        del self[key]
        return layer

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in items:
            self[k] = v


# ---------------- transformer decoder / full transformer ----------------

class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention, FFN, each with a residual and a
    LayerNorm after (or, with ``normalize_before``, before) it (reference
    :1122).  ``cache`` is accepted and ignored, as in the reference."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.dropout_act = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = {"relu": F.relu, "gelu": F.gelu}[activation]

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask)
        tgt = add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout_act(self.activation(
            self.linear1(tgt))))
        tgt = add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [
            copy.deepcopy(decoder_layer) for _ in range(num_layers - 1)])
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    """The encoder-decoder Transformer (reference :1187); the defaults are
    the base model of Vaswani et al. 2017 (d_model 512, 8 heads, 6 + 6
    layers, FFN 2048, dropout 0.1)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                        dropout, activation, attn_dropout,
                                        act_dropout, normalize_before),
                num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                        dropout, activation, attn_dropout,
                                        act_dropout, normalize_before),
                num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        """float32 ``[length, length]``: 0 on and below the diagonal, -inf
        above, on the current device."""
        from ..device import current
        dev = current()
        r = torch.arange(length, device=dev)
        return torch.where(r[None, :] <= r[:, None], 0.0,
                           float("-inf")).to(torch.float32)


from .rnn import (BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN,  # noqa: E402
                  RNNCellBase, SimpleRNN, SimpleRNNCell)
from . import utils  # noqa: E402,F401
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: E402

__all__ = [
    "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveLogSoftmaxWithLoss", "AdaptiveMaxPool1D",
    "AdaptiveMaxPool2D", "AdaptiveMaxPool3D", "AlphaDropout", "AvgPool1D",
    "AvgPool2D", "AvgPool3D", "BCELoss", "BCEWithLogitsLoss", "BatchNorm",
    "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "BeamSearchDecoder",
    "BiRNN", "Bilinear", "CELU", "CTCLoss", "ChannelShuffle",
    "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "Conv1D",
    "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D",
    "Conv3DTranspose", "CosineEmbeddingLoss", "CosineSimilarity",
    "CrossEntropyLoss", "Dropout", "Dropout2D", "Dropout3D", "ELU",
    "Embedding", "FeatureAlphaDropout", "Flatten", "Fold",
    "FractionalMaxPool2D", "FractionalMaxPool3D", "GELU", "GLU", "GRU",
    "GRUCell", "GaussianNLLLoss", "GroupNorm", "HSigmoidLoss",
    "Hardshrink", "Hardsigmoid", "Hardswish", "Hardtanh",
    "HingeEmbeddingLoss", "Identity", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "KLDivLoss", "L1Loss", "LPPool1D", "LPPool2D",
    "LSTM", "LSTMCell", "Layer", "LayerDict", "LayerList", "LayerNorm",
    "LeakyReLU", "Linear", "LocalResponseNorm", "LogSigmoid",
    "LogSoftmax", "MSELoss", "MarginRankingLoss", "MaxPool1D",
    "MaxPool2D", "MaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "Maxout", "Mish", "MultiHeadAttention", "MultiLabelSoftMarginLoss",
    "MultiMarginLoss", "NLLLoss", "PReLU", "Pad1D", "Pad2D", "Pad3D",
    "PairwiseDistance", "ParamAttr", "Parameter", "ParameterDict",
    "ParameterList", "PixelShuffle", "PixelUnshuffle", "PoissonNLLLoss",
    "RMSNorm", "RNN", "RNNCellBase", "RNNTLoss", "RReLU", "ReLU", "ReLU6",
    "SELU", "Sequential", "SiLU", "Sigmoid", "Silu", "SimpleRNN",
    "SimpleRNNCell", "SmoothL1Loss", "SoftMarginLoss", "Softmax",
    "Softmax2D", "Softplus", "Softshrink", "Softsign", "SpectralNorm",
    "Swish", "SyncBatchNorm", "Tanh", "Tanhshrink", "Tensor",
    "ThresholdedReLU", "Transformer", "TransformerDecoder",
    "TransformerDecoderLayer", "TransformerEncoder",
    "TransformerEncoderLayer", "TripletMarginLoss",
    "TripletMarginWithDistanceLoss", "Unflatten", "Unfold", "Upsample",
    "UpsamplingBilinear2D", "UpsamplingNearest2D", "ZeroPad1D",
    "ZeroPad2D", "ZeroPad3D", "clip_grad_norm_", "dynamic_decode",
    "functional", "initializer", "utils"]
