"""The port's spatial half of ``nn`` (convolutions in 1-D, 3-D and
transposed, every pool, the image norms, padding and resampling) against
the JAX package, on the CPU.

Every function case of ``FUNCS`` takes numpy inputs from a seed through the
reference's function and the port's; the float outputs and the gradients
of the inputs the case names, from a random cotangent, are held in fp32
within ``TOL`` of the tensor's largest value (``_close``), integer outputs
(pool indices) exactly.  The reference's passes are its jitted arithmetic,
all cases in one ``jax.jit`` of ``jax.vjp`` (``ref_funcs``); its
``max_pool*_with_index`` reduce a (value, index) pair, which JAX cannot
differentiate, so those cases compare values only.  Every layer of
``LAYERS`` is built in both packages with the reference's state carried
into the port (``_pair``), run forward and backward through both, its
output, input and parameter gradients held the same way (BatchNorm3D and
SyncBatchNorm in training, their running statistics after the step too).
The named tests below hold the reference's own rules that the port keeps
where torch's differ (``ROADMAP.md`` Queue 3, "the quirks of item
17.3b").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.nn import functional as jF
import paddle_tpu_torch as T
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import amp_state as tamp_state
from paddle_tpu_torch.nn import functional as tF

from test_torch_nn_layers import (_assert_passes_equal, _close, _cpu, _pair,
                                  _port_pass, _ref_passes)

torch.set_num_threads(2)

TOL = 2e-5


@pytest.fixture(autouse=True)
def on_cpu():
    with _cpu():
        yield


def _f(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _u(r, *shape, lo=-1.0, hi=1.0):
    return r.uniform(lo, hi, shape).astype(np.float32)


def _unpool_index(r, n, c, n_in, n_out):
    """Flat indices into ``n_out`` output entries, drawn with repeats (the
    scatter-add rule: a repeated index sums)."""
    return r.integers(0, n_out, (n, c, n_in)).astype(np.int32)


def _pooled_mask(F, x, nd):
    """``max_pool{nd}d`` with ``return_mask`` into ``max_unpool{nd}d``
    (the with-index pool is not differentiable in the reference: values
    only)."""
    pool = F.max_pool2d if nd == 2 else F.max_pool3d
    unpool = F.max_unpool2d if nd == 2 else F.max_unpool3d
    out, idx = pool(x, 3, 2, 1, return_mask=True)
    return out, idx, unpool(out, idx, 3, 2, 1, output_size=list(x.shape))


# name -> (fn(F, *inputs), inputs(rng), indices of the inputs that get a
# gradient).  fn is called with each package's functional module.
FUNCS = {
    # ---- convolutions ----
    "conv1d_stride_dilation_pad_pair": (
        lambda F, x, w, b: F.conv1d(x, w, b, stride=2, padding=[1, 2],
                                    dilation=2),
        lambda r: [_f(r, 2, 4, 11), _f(r, 6, 4, 3), _f(r, 6)], [0, 1, 2]),
    "conv1d_nlc_same_groups": (
        lambda F, x, w: F.conv1d(x, w, stride=2, padding="SAME", groups=2,
                                 data_format="NLC"),
        lambda r: [_f(r, 2, 11, 4), _f(r, 6, 2, 3)], [0, 1]),
    "conv1d_valid": (lambda F, x, w: F.conv1d(x, w, padding="VALID"),
                     lambda r: [_f(r, 2, 3, 9), _f(r, 5, 3, 4)], [0, 1]),
    "conv1d_nested": (
        lambda F, x, w: F.conv1d(x, w, padding=[[0, 0], [0, 0], [2, 1]]),
        lambda r: [_f(r, 2, 3, 9), _f(r, 5, 3, 4)], [0, 1]),
    "conv3d_stride_dilation": (
        lambda F, x, w, b: F.conv3d(x, w, b, stride=(1, 2, 1), padding=1,
                                    dilation=(2, 1, 1)),
        lambda r: [_f(r, 1, 2, 6, 7, 5), _f(r, 3, 2, 3, 3, 2), _f(r, 3)],
        [0, 1, 2]),
    "conv3d_ndhwc_same": (
        lambda F, x, w: F.conv3d(x, w, stride=2, padding="SAME",
                                 data_format="NDHWC"),
        lambda r: [_f(r, 1, 5, 6, 7, 2), _f(r, 3, 2, 3, 2, 3)], [0, 1]),
    "conv3d_six_ints_groups": (
        lambda F, x, w: F.conv3d(x, w, padding=[1, 0, 0, 2, 1, 1],
                                 groups=2),
        lambda r: [_f(r, 1, 4, 5, 5, 4), _f(r, 4, 2, 3, 3, 3)], [0, 1]),
    "conv3d_nested": (
        lambda F, x, w: F.conv3d(
            x, w, padding=[[0, 0], [0, 0], [1, 1], [0, 1], [2, 0]]),
        lambda r: [_f(r, 1, 2, 5, 5, 4), _f(r, 3, 2, 3, 3, 3)], [0, 1]),
    "conv2d_nhwc_four_ints": (
        lambda F, x, w, b: F.conv2d(x, w, b, padding=[1, 0, 2, 1],
                                    data_format="NHWC"),
        lambda r: [_f(r, 2, 6, 5, 3), _f(r, 4, 3, 3, 3), _f(r, 4)],
        [0, 1, 2]),
    "conv1d_transpose": (
        lambda F, x, w, b: F.conv1d_transpose(x, w, b, stride=2, padding=1,
                                              output_padding=1, dilation=2),
        lambda r: [_f(r, 2, 4, 7), _f(r, 4, 3, 3), _f(r, 3)], [0, 1, 2]),
    "conv1d_transpose_nlc_output_size": (
        lambda F, x, w: F.conv1d_transpose(x, w, stride=3, padding=1,
                                           data_format="NLC",
                                           output_size=[20]),
        lambda r: [_f(r, 2, 7, 4), _f(r, 4, 3, 3)], [0, 1]),
    "conv2d_transpose": (
        lambda F, x, w, b: F.conv2d_transpose(
            x, w, b, stride=(2, 1), padding=(1, 0), output_padding=(1, 0),
            dilation=(1, 2)),
        lambda r: [_f(r, 2, 4, 5, 6), _f(r, 4, 3, 3, 2), _f(r, 3)],
        [0, 1, 2]),
    "conv2d_transpose_nhwc_output_size": (
        lambda F, x, w: F.conv2d_transpose(x, w, stride=2, padding=1,
                                           data_format="NHWC",
                                           output_size=[10, 12]),
        lambda r: [_f(r, 2, 5, 6, 4), _f(r, 4, 3, 3, 3)], [0, 1]),
    "conv3d_transpose": (
        lambda F, x, w, b: F.conv3d_transpose(x, w, b, stride=2),
        lambda r: [_f(r, 1, 3, 3, 4, 3), _f(r, 3, 2, 2, 2, 2), _f(r, 2)],
        [0, 1, 2]),
    "conv3d_transpose_ndhwc_output_size_dilation": (
        lambda F, x, w: F.conv3d_transpose(
            x, w, stride=(2, 1, 2), padding=(1, 0, 1), dilation=(1, 2, 1),
            data_format="NDHWC", output_size=[8, 8, 6]),
        lambda r: [_f(r, 1, 4, 4, 3, 2), _f(r, 2, 3, 3, 3, 3)], [0, 1]),
    # ---- pools ----
    "max_pool1d": (lambda F, x: F.max_pool1d(x, 3, 2, 1),
                   lambda r: [_f(r, 2, 3, 10)], [0]),
    "avg_pool1d_ignores_exclusive": (
        lambda F, x: F.avg_pool1d(x, 3, 2, 1, exclusive=True),
        lambda r: [_f(r, 2, 3, 10)], [0]),
    "max_pool2d_nhwc": (
        lambda F, x: F.max_pool2d(x, 3, 2, 1, data_format="NHWC"),
        lambda r: [_f(r, 2, 8, 9, 3)], [0]),
    "max_pool3d": (lambda F, x: F.max_pool3d(x, (2, 3, 2), (2, 2, 1),
                                             (1, 1, 0)),
                   lambda r: [_f(r, 1, 2, 6, 7, 5)], [0]),
    "max_pool3d_ndhwc": (
        lambda F, x: F.max_pool3d(x, 2, data_format="NDHWC"),
        lambda r: [_f(r, 1, 6, 4, 6, 3)], [0]),
    "avg_pool2d_wide_padding": (
        lambda F, x: F.avg_pool2d(x, 3, 1, 2),
        lambda r: [_f(r, 2, 3, 5, 6)], [0]),
    "avg_pool3d_exclusive": (lambda F, x: F.avg_pool3d(x, 3, 2, 1),
                             lambda r: [_f(r, 1, 2, 6, 7, 5)], [0]),
    "avg_pool3d_inclusive_ndhwc": (
        lambda F, x: F.avg_pool3d(x, 3, 2, 1, exclusive=False,
                                  data_format="NDHWC"),
        lambda r: [_f(r, 1, 6, 7, 5, 2)], [0]),
    "avg_pool3d_divisor": (
        lambda F, x: F.avg_pool3d(x, 2, 2, 1, divisor_override=3),
        lambda r: [_f(r, 1, 2, 5, 4, 5)], [0]),
    "max_pool2d_return_mask": (
        lambda F, x: F.max_pool2d(x, 3, 2, 1, return_mask=True),
        lambda r: [_f(r, 2, 3, 8, 9)], []),
    "max_pool2d_with_index": (
        lambda F, x: F.max_pool2d_with_index(x, 2, 2),
        lambda r: [_f(r, 2, 3, 8, 9)], []),
    "max_pool3d_with_index": (
        lambda F, x: F.max_pool3d_with_index(x, 3, 2, 1),
        lambda r: [_f(r, 1, 2, 6, 7, 5)], []),
    "max_pool2d_mask_unpool": (lambda F, x: _pooled_mask(F, x, 2),
                               lambda r: [_f(r, 2, 3, 8, 9)], []),
    "max_pool3d_mask_unpool": (lambda F, x: _pooled_mask(F, x, 3),
                               lambda r: [_f(r, 1, 2, 6, 7, 5)], []),
    "max_unpool1d": (
        lambda F, x, i: F.max_unpool1d(x, i, 2, 2),
        lambda r: [_f(r, 2, 3, 5), _unpool_index(r, 2, 3, 5, 10)], [0]),
    "max_unpool2d_repeated_index": (
        lambda F, x, i: F.max_unpool2d(x, i.reshape([2, 3, 4, 4]), 3, 1,
                                       output_size=[6, 6]),
        lambda r: [_f(r, 2, 3, 4, 4), _unpool_index(r, 2, 3, 16, 36)], [0]),
    "max_unpool3d": (
        lambda F, x, i: F.max_unpool3d(x, i.reshape([1, 2, 2, 3, 2]), 2, 2),
        lambda r: [_f(r, 1, 2, 2, 3, 2), _unpool_index(r, 1, 2, 12, 96)],
        [0]),
    "adaptive_avg_pool1d": (lambda F, x: F.adaptive_avg_pool1d(x, 4),
                            lambda r: [_f(r, 2, 3, 10)], [0]),
    "adaptive_avg_pool3d_ignores_format": (
        lambda F, x: F.adaptive_avg_pool3d(x, (3, 2, 4),
                                           data_format="NDHWC"),
        lambda r: [_f(r, 1, 2, 6, 7, 5)], [0]),
    "adaptive_max_pool1d": (lambda F, x: F.adaptive_max_pool1d(x, 4),
                            lambda r: [_f(r, 2, 3, 10)], [0]),
    "adaptive_max_pool2d": (lambda F, x: F.adaptive_max_pool2d(x, (3, 4)),
                            lambda r: [_f(r, 2, 3, 9, 10)], [0]),
    "adaptive_max_pool3d": (lambda F, x: F.adaptive_max_pool3d(x, 2),
                            lambda r: [_f(r, 1, 2, 6, 7, 5)], [0]),
    "lp_pool1d": (lambda F, x: F.lp_pool1d(x, 2, 3, 2),
                  lambda r: [_f(r, 2, 3, 10)], [0]),
    "lp_pool2d_padding": (lambda F, x: F.lp_pool2d(x, 3, 3, 2, 1),
                          lambda r: [_f(r, 2, 3, 7, 8)], [0]),
    "lp_pool2d_norm_1": (lambda F, x: F.lp_pool2d(x, 1, (2, 3)),
                         lambda r: [_f(r, 2, 3, 6, 9)], [0]),
    "fractional_max_pool2d": (
        lambda F, x: F.fractional_max_pool2d(x, (4, 5), random_u=0.3),
        lambda r: [_f(r, 2, 3, 11, 10)], [0]),
    "fractional_max_pool3d": (
        lambda F, x: F.fractional_max_pool3d(x, (3, 4, 5), random_u=0.6),
        lambda r: [_f(r, 1, 2, 7, 8, 9)], [0]),
    # ---- norms ----
    "instance_norm": (
        lambda F, x, w, b: F.instance_norm(x, weight=w, bias=b, eps=1e-3),
        lambda r: [_f(r, 2, 3, 5, 6), _f(r, 3), _f(r, 3)], [0, 1, 2]),
    "instance_norm_ignores_stats_and_format": (
        lambda F, x, m, v: F.instance_norm(x, m, v, use_input_stats=False,
                                           momentum=0.1, data_format="NHWC"),
        lambda r: [_f(r, 2, 4, 3, 3, 2), _f(r, 4), _u(r, 4, lo=0.5, hi=2)],
        [0]),
    "group_norm": (
        lambda F, x, w, b: F.group_norm(x, 3, 1e-5, w, b),
        lambda r: [_f(r, 2, 6, 4, 5), _f(r, 6), _f(r, 6)], [0, 1, 2]),
    "group_norm_nhwc": (
        lambda F, x, w, b: F.group_norm(x, 2, 1e-5, w, b,
                                        data_format="NHWC"),
        lambda r: [_f(r, 2, 4, 5, 6), _f(r, 6), _f(r, 6)], [0, 1, 2]),
    "group_norm_3d_no_affine": (lambda F, x: F.group_norm(x, 2),
                                lambda r: [_f(r, 2, 4, 3, 3, 3)], [0]),
    "local_response_norm": (
        lambda F, x: F.local_response_norm(x, 5, 1e-2, 0.75, 2.0),
        lambda r: [_f(r, 2, 7, 3, 4)], [0]),
    "local_response_norm_nhwc_3d": (
        lambda F, x: F.local_response_norm(x, 3, 0.1, 0.5, 1.0,
                                           data_format="NDHWC"),
        lambda r: [_f(r, 1, 3, 2, 4, 5)], [0]),
    "sync_batch_norm_training": (
        lambda F, x, m, v, w, b: F.sync_batch_norm(x, m, v, w, b,
                                                   training=True),
        lambda r: [_f(r, 4, 3, 5, 2), _f(r, 3), _u(r, 3, lo=0.5, hi=2),
                   _f(r, 3), _f(r, 3)], [0, 3, 4]),
    "sync_batch_norm_eval": (
        lambda F, x, m, v: F.sync_batch_norm(x, m, v, training=False),
        lambda r: [_f(r, 4, 3, 5), _f(r, 3), _u(r, 3, lo=0.5, hi=2)], [0]),
    "spectral_norm": (lambda F, w: F.spectral_norm(w, 2),
                      lambda r: [_f(r, 6, 4, 3)], [0]),
    "spectral_norm_dim_1": (lambda F, w: F.spectral_norm(w, 1, dim=1),
                            lambda r: [_f(r, 5, 7)], [0]),
    # ---- padding ----
    "pad_constant": (
        lambda F, x: F.pad(x, [1, 2, 0, 3], value=0.5),
        lambda r: [_f(r, 2, 3, 4, 5)], [0]),
    "pad_reflect_nhwc": (
        lambda F, x: F.pad(x, [2, 1, 1, 3], mode="reflect",
                           data_format="NHWC"),
        lambda r: [_f(r, 2, 5, 6, 3)], [0]),
    "pad_replicate_3d": (
        lambda F, x: F.pad(x, [1, 0, 2, 1, 0, 2], mode="replicate",
                           data_format="NCDHW"),
        lambda r: [_f(r, 1, 2, 3, 4, 5)], [0]),
    "pad_circular_ncl": (
        lambda F, x: F.pad(x, [3, 2], mode="circular", data_format="NCL"),
        lambda r: [_f(r, 2, 3, 6)], [0]),
    "pad_every_dim_reflect": (
        lambda F, x: F.pad(x, [0, 0, 1, 1, 2, 1], mode="reflect"),
        lambda r: [_f(r, 2, 4, 5)], [0]),
    "zeropad2d": (lambda F, x: F.zeropad2d(x, [1, 0, 2, 1],
                                           data_format="NHWC"),
                  lambda r: [_f(r, 2, 4, 5, 3)], [0]),
    # ---- resampling ----
    "interpolate_nearest_up": (
        lambda F, x: F.interpolate(x, size=[15, 13]),
        lambda r: [_f(r, 2, 3, 10, 6)], [0]),
    "interpolate_nearest_down_scale": (
        lambda F, x: F.interpolate(x, scale_factor=0.6, mode="nearest"),
        lambda r: [_f(r, 2, 3, 10, 9)], [0]),
    "interpolate_bilinear_up": (
        lambda F, x: F.interpolate(x, size=[13, 8], mode="bilinear"),
        lambda r: [_f(r, 2, 3, 7, 5)], [0]),
    "interpolate_bilinear_down_antialias": (
        lambda F, x: F.interpolate(x, size=[5, 4], mode="bilinear"),
        lambda r: [_f(r, 2, 3, 10, 9)], [0]),
    "interpolate_bilinear_corners_up_down": (
        lambda F, x: F.interpolate(x, size=[11, 4], mode="bilinear",
                                   align_corners=True),
        lambda r: [_f(r, 2, 3, 6, 9)], [0]),
    "interpolate_bicubic_up": (
        lambda F, x: F.interpolate(x, size=[20, 9], mode="bicubic"),
        lambda r: [_f(r, 2, 3, 10, 6)], [0]),
    "interpolate_bicubic_down": (
        lambda F, x: F.interpolate(x, size=[4, 5], mode="bicubic",
                                   align_corners=True),
        lambda r: [_f(r, 2, 3, 10, 9)], [0]),
    "interpolate_area_down": (
        lambda F, x: F.interpolate(x, size=[3, 4], mode="area"),
        lambda r: [_f(r, 2, 3, 9, 8)], [0]),
    "interpolate_linear_ncw": (
        lambda F, x: F.interpolate(x, size=[17], mode="linear",
                                   data_format="NCW"),
        lambda r: [_f(r, 2, 3, 7)], [0]),
    "interpolate_linear_down_corners": (
        lambda F, x: F.interpolate(x, size=[4], mode="linear",
                                   align_corners=True, align_mode=1),
        lambda r: [_f(r, 2, 3, 11)], [0]),
    "interpolate_trilinear_up_down": (
        lambda F, x: F.interpolate(x, size=[7, 3, 6], mode="trilinear"),
        lambda r: [_f(r, 1, 2, 4, 6, 6)], [0]),
    "interpolate_bilinear_nhwc_scale": (
        lambda F, x: F.interpolate(x, scale_factor=[1.5, 0.5],
                                   mode="bilinear", data_format="NHWC"),
        lambda r: [_f(r, 2, 6, 8, 3)], [0]),
    "upsample_nearest_3d": (
        lambda F, x: F.upsample(x, scale_factor=2, mode="nearest",
                                data_format="NCDHW"),
        lambda r: [_f(r, 1, 2, 3, 2, 4)], [0]),
    "pixel_shuffle_ignores_format": (
        lambda F, x: F.pixel_shuffle(x, 2, data_format="NHWC"),
        lambda r: [_f(r, 2, 8, 3, 5)], [0]),
    "pixel_unshuffle": (lambda F, x: F.pixel_unshuffle(x, 3),
                        lambda r: [_f(r, 2, 2, 6, 9)], [0]),
    "channel_shuffle": (lambda F, x: F.channel_shuffle(x, 3),
                        lambda r: [_f(r, 2, 6, 3, 4)], [0]),
    "channel_shuffle_nhwc": (
        lambda F, x: F.channel_shuffle(x, 2, data_format="NHWC"),
        lambda r: [_f(r, 2, 3, 4, 6)], [0]),
    "temporal_shift": (
        lambda F, x: F.temporal_shift(x, 3, 0.25, data_format="NHWC"),
        lambda r: [_f(r, 6, 8, 3, 4)], [0]),
    "unfold": (lambda F, x: F.unfold(x, 3, 2, 1),
               lambda r: [_f(r, 2, 3, 7, 8)], [0]),
    "unfold_dilated": (lambda F, x: F.unfold(x, [2, 3], 1, 0, 2),
                       lambda r: [_f(r, 2, 3, 7, 8)], [0]),
    "fold": (lambda F, x: F.fold(x, [7, 8], 3, 2, 1),
             lambda r: [_f(r, 2, 27, 16)], [0]),
    "affine_grid": (lambda F, t: F.affine_grid(t, [2, 3, 5, 7]),
                    lambda r: [_f(r, 2, 2, 3)], [0]),
    "affine_grid_half_pixel": (
        lambda F, t: F.affine_grid(t, [2, 1, 4, 6], align_corners=False),
        lambda r: [_f(r, 2, 2, 3)], [0]),
    "grid_sample_bilinear_zeros": (
        lambda F, x, g: F.grid_sample(x, g),
        lambda r: [_f(r, 2, 3, 5, 6), _u(r, 2, 4, 7, 2, lo=-1.3, hi=1.3)],
        [0, 1]),
    "grid_sample_bilinear_border_half_pixel": (
        lambda F, x, g: F.grid_sample(x, g, padding_mode="border",
                                      align_corners=False),
        lambda r: [_f(r, 2, 3, 5, 6), _u(r, 2, 4, 7, 2, lo=-1.3, hi=1.3)],
        [0, 1]),
    "grid_sample_bilinear_reflection": (
        lambda F, x, g: F.grid_sample(x, g, padding_mode="reflection"),
        lambda r: [_f(r, 2, 3, 5, 6), _u(r, 2, 4, 7, 2, lo=-2.5, hi=2.5)],
        [0, 1]),
    "grid_sample_bilinear_reflection_half_pixel": (
        lambda F, x, g: F.grid_sample(x, g, padding_mode="reflection",
                                      align_corners=False),
        lambda r: [_f(r, 2, 3, 5, 6), _u(r, 2, 4, 7, 2, lo=-2.5, hi=2.5)],
        [0, 1]),
    "grid_sample_nearest_zeros": (
        lambda F, x, g: F.grid_sample(x, g, mode="nearest"),
        lambda r: [_f(r, 2, 3, 5, 6), _u(r, 2, 4, 7, 2, lo=-1.3, hi=1.3)],
        [0]),
}


def _inputs(case):
    return FUNCS[case][1](np.random.default_rng(sorted(FUNCS).index(case)))


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _cots(outs):
    return [np.random.default_rng(11 + i).standard_normal(np.shape(o))
            .astype(np.float32) for i, o in enumerate(outs)]


@pytest.fixture(scope="module")
def ref_funcs():
    """Every case's reference pass, one ``jax.jit`` of ``jax.vjp`` (or of
    the function alone where it takes no gradient): (float outputs, integer
    outputs, the gradients of the case's grad inputs)."""
    def one(fn, inputs, grad_idx, floats):
        def f(floats):
            xs = [JT(a) for a in inputs]
            for i, a in zip(grad_idx, floats):
                xs[i] = JT(a)
            outs = [o._data for o in _leaves(fn(jF, *xs))]
            return (tuple(o for o in outs if o.dtype.kind == "f"),
                    tuple(o for o in outs if o.dtype.kind != "f"))
        if not grad_idx:
            fl, rest = f(floats)
            return fl, rest, ()
        fl, vjp, rest = jax.vjp(f, floats, has_aux=True)
        (grads,) = vjp(tuple(jnp.asarray(c, o.dtype) for c, o in
                             zip(_cots(fl), fl)))
        return fl, rest, grads

    cases = {c: (FUNCS[c][0], _inputs(c), FUNCS[c][2]) for c in FUNCS}

    def run(all_floats):
        return {c: one(fn, inputs, gi, all_floats[c])
                for c, (fn, inputs, gi) in cases.items()}
    floats = {c: [inputs[i] for i in gi] for c, (_, inputs, gi) in
              cases.items()}
    res = jax.jit(run)(floats)
    return {c: ([np.asarray(o) for o in fl], [np.asarray(o) for o in rest],
                [np.asarray(g) for g in grads])
            for c, (fl, rest, grads) in res.items()}


def _port(case):
    fn, _, grad_idx = FUNCS[case]
    xs = [torch.tensor(a) for a in _inputs(case)]
    for i in grad_idx:
        xs[i].requires_grad_(True)
    outs = _leaves(fn(tF, *xs))
    fl = [o for o in outs if o.is_floating_point()]
    rest = [o for o in outs if not o.is_floating_point()]
    if grad_idx:
        sum((o * torch.tensor(c)).sum()
            for o, c in zip(fl, _cots(fl))).backward()
    return fl, rest, [xs[i].grad for i in grad_idx]


@pytest.mark.parametrize("case", sorted(FUNCS))
def test_functional(case, ref_funcs):
    """Outputs and input gradients of ``case`` within TOL; integer outputs
    equal, in the reference's dtype."""
    fl, rest, grads = _port(case)
    want_fl, want_rest, want_grads = ref_funcs[case]
    assert len(fl) == len(want_fl) and len(rest) == len(want_rest)
    for i, (g, w) in enumerate(zip(fl, want_fl)):
        _close(g, w, TOL, f"out {i}")
    for g, w in zip(rest, want_rest):
        assert str(g.dtype) == f"torch.{w.dtype}", (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)
    for i, (g, w) in zip(FUNCS[case][2], zip(grads, want_grads)):
        _close(g, w, TOL, f"grad of input {i}")


# ---------------- layers ----------------

def _idx(r, shape, n_out):
    return r.integers(0, n_out, shape).astype(np.int32)


# name -> (make(nn), inputs(rng))
LAYERS = {
    "Conv1D": (lambda nn: nn.Conv1D(4, 6, 3, stride=2, padding=1,
                                    groups=2),
               lambda r: [_f(r, 2, 4, 9)]),
    "Conv3D": (lambda nn: nn.Conv3D(2, 4, 3, padding="SAME",
                                    data_format="NDHWC"),
               lambda r: [_f(r, 1, 4, 5, 3, 2)]),
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(4, 3, 3, stride=2,
                                                      padding=1),
                        lambda r: [_f(r, 2, 4, 6)]),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(3, 4, (2, 3),
                                                      stride=2,
                                                      output_padding=1),
                        lambda r: [_f(r, 2, 3, 4, 5)]),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(4, 2, 2, stride=2),
                        lambda r: [_f(r, 1, 4, 2, 3, 2)]),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(3, 2, 1, return_mask=True),
                  lambda r: [_f(r, 2, 3, 9)]),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(3, 2, 1),
                  lambda r: [_f(r, 2, 3, 9)]),
    "MaxPool3D": (lambda nn: nn.MaxPool3D(2, data_format="NDHWC"),
                  lambda r: [_f(r, 1, 4, 6, 4, 3)]),
    "AvgPool3D": (lambda nn: nn.AvgPool3D(3, 2, 1, exclusive=False),
                  lambda r: [_f(r, 1, 2, 5, 6, 4)]),
    "AdaptiveAvgPool1D": (lambda nn: nn.AdaptiveAvgPool1D(3),
                          lambda r: [_f(r, 2, 3, 8)]),
    "AdaptiveAvgPool3D": (lambda nn: nn.AdaptiveAvgPool3D((2, 3, 1)),
                          lambda r: [_f(r, 1, 2, 5, 6, 4)]),
    "AdaptiveMaxPool1D": (lambda nn: nn.AdaptiveMaxPool1D(3,
                                                          return_mask=True),
                          lambda r: [_f(r, 2, 3, 8)]),
    "AdaptiveMaxPool2D": (lambda nn: nn.AdaptiveMaxPool2D((2, 3)),
                          lambda r: [_f(r, 2, 3, 7, 8)]),
    "AdaptiveMaxPool3D": (lambda nn: nn.AdaptiveMaxPool3D(2),
                          lambda r: [_f(r, 1, 2, 5, 6, 4)]),
    "MaxUnPool1D": (lambda nn: nn.MaxUnPool1D(2, output_size=[11]),
                    lambda r: [_f(r, 2, 3, 5), _idx(r, (2, 3, 5), 11)]),
    "MaxUnPool2D": (lambda nn: nn.MaxUnPool2D(2, 2),
                    lambda r: [_f(r, 2, 3, 3, 4), _idx(r, (2, 3, 3, 4), 48)]),
    "MaxUnPool3D": (lambda nn: nn.MaxUnPool3D(2, 2),
                    lambda r: [_f(r, 1, 2, 2, 2, 3),
                               _idx(r, (1, 2, 2, 2, 3), 96)]),
    "FractionalMaxPool2D": (lambda nn: nn.FractionalMaxPool2D(
        3, random_u=0.45), lambda r: [_f(r, 2, 3, 8, 7)]),
    "FractionalMaxPool3D": (lambda nn: nn.FractionalMaxPool3D(
        (2, 3, 2), random_u=0.2), lambda r: [_f(r, 1, 2, 5, 7, 6)]),
    "LPPool1D": (lambda nn: nn.LPPool1D(3, 2),
                 lambda r: [_f(r, 2, 3, 8)]),
    "LPPool2D": (lambda nn: nn.LPPool2D(2, 3, 2, 1),
                 lambda r: [_f(r, 2, 3, 7, 6)]),
    "BatchNorm3D": (lambda nn: nn.BatchNorm3D(3),
                    lambda r: [_f(r, 2, 3, 3, 4, 2)]),
    "SyncBatchNorm": (lambda nn: nn.SyncBatchNorm(3, momentum=0.8),
                      lambda r: [_f(r, 4, 3, 5)]),
    "GroupNorm": (lambda nn: nn.GroupNorm(2, 4),
                  lambda r: [_f(r, 2, 4, 3, 5)]),
    "InstanceNorm1D": (lambda nn: nn.InstanceNorm1D(3),
                       lambda r: [_f(r, 2, 3, 7)]),
    "InstanceNorm2D": (lambda nn: nn.InstanceNorm2D(3, bias_attr=False),
                       lambda r: [_f(r, 2, 3, 4, 5)]),
    "InstanceNorm3D": (lambda nn: nn.InstanceNorm3D(2),
                       lambda r: [_f(r, 2, 2, 3, 4, 3)]),
    "LocalResponseNorm": (lambda nn: nn.LocalResponseNorm(3, 0.1),
                          lambda r: [_f(r, 2, 5, 3, 4)]),
    "SpectralNorm": (lambda nn: nn.SpectralNorm([4, 6], dim=1,
                                                power_iters=2),
                     lambda r: [_f(r, 4, 6)]),
    "Pad1D": (lambda nn: nn.Pad1D([2, 1], mode="reflect"),
              lambda r: [_f(r, 2, 3, 6)]),
    "Pad2D": (lambda nn: nn.Pad2D([1, 2, 0, 1], mode="replicate",
                                  data_format="NHWC"),
              lambda r: [_f(r, 2, 4, 5, 3)]),
    "Pad3D": (lambda nn: nn.Pad3D([1, 1, 0, 2, 1, 0], value=1.5),
              lambda r: [_f(r, 1, 2, 3, 4, 3)]),
    "ZeroPad1D": (lambda nn: nn.ZeroPad1D([0, 3]),
                  lambda r: [_f(r, 2, 3, 5)]),
    "ZeroPad2D": (lambda nn: nn.ZeroPad2D([1, 0, 2, 2]),
                  lambda r: [_f(r, 2, 3, 4, 5)]),
    "ZeroPad3D": (lambda nn: nn.ZeroPad3D([1, 0, 0, 1, 2, 0],
                                          data_format="NDHWC"),
                  lambda r: [_f(r, 1, 3, 4, 2, 2)]),
    "Upsample": (lambda nn: nn.Upsample(scale_factor=2, mode="bilinear"),
                 lambda r: [_f(r, 2, 3, 4, 5)]),
    "UpsamplingNearest2D": (lambda nn: nn.UpsamplingNearest2D(size=[7, 9]),
                            lambda r: [_f(r, 2, 3, 4, 5)]),
    "UpsamplingBilinear2D": (lambda nn: nn.UpsamplingBilinear2D(
        scale_factor=1.5), lambda r: [_f(r, 2, 3, 4, 6)]),
    "PixelShuffle": (lambda nn: nn.PixelShuffle(2),
                     lambda r: [_f(r, 2, 8, 3, 3)]),
    "PixelUnshuffle": (lambda nn: nn.PixelUnshuffle(2),
                       lambda r: [_f(r, 2, 2, 4, 6)]),
    "ChannelShuffle": (lambda nn: nn.ChannelShuffle(2),
                       lambda r: [_f(r, 2, 6, 3, 3)]),
    "Unfold": (lambda nn: nn.Unfold([2, 3], strides=2, paddings=1),
               lambda r: [_f(r, 2, 3, 6, 7)]),
    "Fold": (lambda nn: nn.Fold([5, 6], 2, strides=1),
             lambda r: [_f(r, 2, 12, 20)]),
}


def _layer_inputs(case):
    return LAYERS[case][1](np.random.default_rng(100 +
                                                 sorted(LAYERS).index(case)))


@pytest.fixture(scope="module")
def layer_refs():
    with _cpu():
        pairs = {case: _pair(make) for case, (make, _) in LAYERS.items()}
    refs = _ref_passes({case: (j, _layer_inputs(case))
                        for case, (j, _) in pairs.items()})
    return pairs, refs


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layers(case, layer_refs):
    """Output, input and parameter gradients within TOL (the batch norms in
    training, then their running statistics)."""
    pairs, refs = layer_refs
    j, t = pairs[case]
    _assert_passes_equal(refs[case], _port_pass(t, _layer_inputs(case)), TOL)
    for n, b in j.named_buffers():
        _close(dict(t.named_buffers())[n], np.asarray(b._data), TOL, n)


# ---------------- the reference's rules the port keeps ----------------

@pytest.mark.parametrize("nd", [1, 2, 3])
def test_grouped_transpose_raises_value_error(nd):
    """A grouped transposed convolution raises ``ValueError`` in both
    packages: the reference swaps the whole weight's first two axes before
    a grouped convolution."""
    shape = (1, 4) + (3,) * nd
    w = np.ones((4, 2) + (2,) * nd, np.float32)
    x = np.ones(shape, np.float32)
    name = {1: "conv1d_transpose", 2: "conv2d_transpose",
            3: "conv3d_transpose"}[nd]
    with pytest.raises(ValueError):
        getattr(jF, name)(JT(x), JT(w), groups=2)
    with pytest.raises(ValueError):
        getattr(tF, name)(torch.tensor(x), torch.tensor(w), groups=2)
    layer = {1: tnn.Conv1DTranspose, 2: tnn.Conv2DTranspose,
             3: tnn.Conv3DTranspose}[nd](4, 4, 2, groups=2)
    with pytest.raises(ValueError):
        layer(torch.tensor(x))


def test_max_pool2d_return_mask_gives_the_index_and_unpools(ref_funcs):
    """``max_pool2d(return_mask=True)`` returns the reference's ``(out,
    index)`` (int32 flat spatial indices), and ``max_unpool2d`` of them
    puts each maximum back where it was."""
    x = torch.tensor(_inputs("max_pool2d_mask_unpool")[0])
    out, idx = tF.max_pool2d(x, 3, 2, 1, return_mask=True)
    want_fl, want_rest, _ = ref_funcs["max_pool2d_mask_unpool"]
    _close(out, want_fl[0])
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), want_rest[0])
    back = tF.max_unpool2d(out, idx, 3, 2, 1, output_size=list(x.shape))
    flat = x.reshape(2, 3, -1)
    np.testing.assert_array_equal(
        torch.gather(flat, 2, idx.reshape(2, 3, -1).long()).numpy(),
        out.reshape(2, 3, -1).numpy())
    assert back.shape == x.shape
    np.testing.assert_array_equal((back != 0).sum().item(),
                                  len(np.unique(idx.numpy().reshape(2, 3, -1)
                                                + 100 * np.arange(6)
                                                .reshape(2, 3, 1))))


def test_max_unpool_sums_a_repeated_index():
    """Where windows overlap an index repeats: the reference's
    ``.at[...].add`` sums its values, torch's ``max_unpool2d`` writes one."""
    x = torch.tensor([[[[1.0, 2.0]]]])
    idx = torch.tensor([[[[3, 3]]]], dtype=torch.int32)
    port = tF.max_unpool2d(x, idx, 2, 1)
    ref = jF.max_unpool2d(JT(x.numpy()), JT(idx.numpy()), 2, 1)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref._data))
    assert port.shape == (1, 1, 2, 3) and port.flatten()[3] == 3.0
    torchs = TF.max_unpool2d(x, idx.long(), 2, 1)
    assert torchs.flatten()[3] in (1.0, 2.0)


def test_interpolate_is_jax_image_resize_not_torchs():
    """Without ``align_corners``, ``interpolate`` is ``jax.image.resize``:
    "nearest" is torch's "nearest-exact", "bilinear" shrinks with torch's
    antialias, "bicubic" is Keys' cubic with a = -0.5 (torch: -0.75)."""
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (1, 2, 10, 10)).astype(np.float32))
    near = tF.interpolate(x, size=[15, 15])
    assert torch.equal(near, TF.interpolate(x, size=[15, 15],
                                            mode="nearest-exact"))
    assert not torch.equal(near, TF.interpolate(x, size=[15, 15]))
    down = tF.interpolate(x, size=[5, 5], mode="bilinear")
    _close(down, TF.interpolate(x, size=[5, 5], mode="bilinear",
                                antialias=True).numpy(), 1e-6)
    assert (down - TF.interpolate(x, size=[5, 5], mode="bilinear")
            ).abs().max() > 1e-2
    cubic = tF.interpolate(x, size=[20, 20], mode="bicubic")
    assert (cubic - TF.interpolate(x, size=[20, 20], mode="bicubic")
            ).abs().max() > 1e-3
    ref = jF.interpolate(JT(x.numpy()), size=[20, 20], mode="bicubic")
    _close(cubic, np.asarray(ref._data))


def test_interpolate_caches_its_matrices():
    """A second call at the same sizes makes no new resampling matrix or
    index (a warm step copies nothing to the device)."""
    x = torch.ones((1, 1, 6, 7))
    tF.interpolate(x, size=[9, 4], mode="bilinear")
    tF.interpolate(x, size=[9, 4])
    n = len(tF._RESAMPLE)
    tF.interpolate(x * 2, size=[9, 4], mode="bilinear")
    tF.interpolate(x * 2, size=[9, 4])
    assert len(tF._RESAMPLE) == n


def test_local_response_norm_is_not_torchs():
    """The reference divides by ``(k + alpha sum x^2)^beta`` with no
    ``/ size``: torch's ``local_response_norm`` is another function."""
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 7, 3, 4)).astype(np.float32))
    port = tF.local_response_norm(x, 5, 1e-2, 0.75, 2.0)
    assert (port - TF.local_response_norm(x, 5, 1e-2, 0.75, 2.0)
            ).abs().max() > 1e-3
    sq = TF.pad(x.square(), (0, 0, 0, 0, 2, 2))
    acc = sum(sq[:, i:i + 7] for i in range(5))
    _close(port, (x / (2.0 + 1e-2 * acc) ** 0.75).numpy(), 1e-6)


def test_pools_ignore_ceil_mode():
    """``max_pool2d(3, 2, ceil_mode=True)`` on 10 x 10 gives 4 x 4 in both
    packages (torch's would give 5 x 5), and so do the other pools."""
    x = np.random.default_rng(2).standard_normal((1, 1, 10, 10)).astype(
        np.float32)
    for fn in ("max_pool2d", "avg_pool2d"):
        port = getattr(tF, fn)(torch.tensor(x), 3, 2, ceil_mode=True)
        ref = getattr(jF, fn)(JT(x), 3, 2, ceil_mode=True)
        assert tuple(port.shape) == tuple(ref.shape) == (1, 1, 4, 4)
        _close(port, np.asarray(ref._data))
    assert tF.max_pool1d(torch.tensor(x[0]), 3, 2, ceil_mode=True
                         ).shape[-1] == 4
    assert tF.avg_pool3d(torch.tensor(x[None]), (1, 3, 3), 2,
                         ceil_mode=True).shape[-1] == 4


def test_avg_pool1d_divides_by_the_window_even_when_exclusive():
    """``avg_pool1d`` / ``AvgPool1D`` divide a border window by the kernel
    size whatever ``exclusive`` says (torch's ``count_include_pad=True``),
    as the reference does; ``avg_pool2d`` honours it."""
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (2, 3, 10)).astype(np.float32))
    want = TF.avg_pool1d(x, 3, 2, 1, count_include_pad=True)
    for exclusive in (True, False):
        _close(tF.avg_pool1d(x, 3, 2, 1, exclusive=exclusive), want.numpy(),
               1e-6)
    _close(tnn.AvgPool1D(3, 2, 1, exclusive=True)(x), want.numpy(), 1e-6)
    assert (TF.avg_pool1d(x, 3, 2, 1, count_include_pad=False) - want
            ).abs().max() > 0.1
    x2 = x[:, :, None]
    _close(tF.avg_pool2d(x2, (1, 3), (1, 2), (0, 1), exclusive=True),
           TF.avg_pool2d(x2, (1, 3), (1, 2), (0, 1),
                         count_include_pad=False).numpy(), 1e-6)


@pytest.mark.parametrize("make, shape", [
    (lambda m: m.MaxPool1D(2, return_mask=True), (2, 3, 8)),
    (lambda m: m.MaxPool2D(2, return_mask=True), (2, 3, 4, 6)),
    (lambda m: m.AdaptiveMaxPool1D(3, return_mask=True), (2, 3, 8)),
    (lambda m: m.AdaptiveMaxPool2D(3, return_mask=True), (2, 3, 6, 6)),
    (lambda m: m.AdaptiveMaxPool3D(2, return_mask=True), (1, 2, 4, 4, 4)),
    (lambda m: m.FractionalMaxPool2D(3, random_u=0.5, return_mask=True),
     (2, 3, 7, 7)),
    (lambda m: m.FractionalMaxPool3D(2, random_u=0.5, return_mask=True),
     (1, 2, 5, 5, 5))])
def test_pools_that_ignore_return_mask(make, shape):
    """These pools return the pooled tensor alone with ``return_mask=True``
    in both packages (``MaxPool3D`` and the functional 2-D / 3-D max pools
    return ``(out, index)``)."""
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    port = make(tnn)(torch.tensor(x))
    ref = make(jnn)(JT(x))
    assert torch.is_tensor(port) and isinstance(ref, JT)
    _close(port, np.asarray(ref._data))


def test_max_pool3d_layer_return_mask():
    x = np.random.default_rng(5).standard_normal((1, 2, 4, 6, 4)).astype(
        np.float32)
    out, idx = tnn.MaxPool3D(2, return_mask=True)(torch.tensor(x))
    jout, jidx = jnn.MaxPool3D(2, return_mask=True)(JT(x))
    _close(out, np.asarray(jout._data))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx._data))


def test_lp_pool2d_scales_an_exclusive_mean_by_the_full_window():
    """With padding, ``lp_pool2d`` multiplies the exclusive mean of
    ``|x|^p`` (a border window divided by its in-bounds count) by the full
    window size: a border window's sum is scaled up."""
    x = torch.tensor(np.random.default_rng(6).standard_normal(
        (1, 2, 5, 5)).astype(np.float32))
    got = tF.lp_pool2d(x, 2, 3, 1, 1)
    powed = x.square()
    mean = TF.avg_pool2d(powed, 3, 1, 1, count_include_pad=False)
    _close(got, ((mean * 9) ** 0.5).numpy(), 1e-6)
    true_sum = TF.avg_pool2d(powed, 3, 1, 1, count_include_pad=True) * 9
    assert got[0, 0, 0, 0] > true_sum[0, 0, 0, 0] ** 0.5


def test_fractional_max_pool_draws_u_from_the_port_generator():
    """Without ``random_u`` the bins come from the CPU generator's draw:
    one seed gives one result, and it equals the pool at that ``u``."""
    x = torch.tensor(np.random.default_rng(7).standard_normal(
        (1, 2, 11, 13)).astype(np.float32))
    T.seed(11)
    a = tF.fractional_max_pool2d(x, (4, 5))
    T.seed(11)
    u = float(torch.rand((), generator=T.core.random.generator("cpu")))
    T.seed(11)
    b = tF.fractional_max_pool2d(x, (4, 5))
    assert torch.equal(a, b)
    assert torch.equal(a, tF.fractional_max_pool2d(x, (4, 5), random_u=u))
    ref = jF.fractional_max_pool2d(JT(x.numpy()), (4, 5), random_u=u)
    _close(a, np.asarray(ref._data))


def test_spectral_norm_keeps_no_state():
    """The power iteration restarts from ones on every call: one weight
    gives one result, and ``SpectralNorm`` holds no parameter or buffer."""
    w = torch.tensor(np.random.default_rng(8).standard_normal(
        (5, 4)).astype(np.float32))
    layer = tnn.SpectralNorm([5, 4])
    assert not list(layer.parameters()) and not list(layer.buffers())
    assert torch.equal(layer(w), layer(w))
    assert torch.equal(layer(w), tF.spectral_norm(w))


def test_group_norm_rounds_its_statistics_to_the_input_dtype():
    """A bf16 ``group_norm`` takes its mean and variance in float32 and
    rounds them to bf16 before they normalise, as the reference's
    ``jnp.mean`` / ``jnp.var`` of a bf16 input do."""
    r = np.random.default_rng(9)
    x = (r.standard_normal((2, 6, 4, 5)) * 3 + 1).astype(np.float32)
    w, b = r.standard_normal(6).astype(np.float32), \
        r.standard_normal(6).astype(np.float32)
    xb = torch.tensor(x).bfloat16()
    port = tF.group_norm(xb, 3, 1e-5, torch.tensor(w).bfloat16(),
                         torch.tensor(b).bfloat16())
    assert port.dtype == torch.bfloat16
    ref = jax.jit(lambda a, ww, bb: jF.group_norm(
        JT(a), 3, 1e-5, JT(ww), JT(bb))._data)(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16))
    assert str(ref.dtype) == "bfloat16"
    want = np.asarray(ref.astype(jnp.float32))
    # the normalising product, the scale and the shift each round to bf16
    # (8 bits of mantissa) where XLA may round once: a few bf16 ulps of
    # the output's largest value apart
    _close(port, want, 2 ** -7)


def test_sync_batch_norm_is_batch_norm_in_one_process():
    r = np.random.default_rng(10)
    x = torch.tensor(r.standard_normal((4, 3, 5)).astype(np.float32))
    m1, v1 = torch.zeros(3), torch.ones(3)
    m2, v2 = torch.zeros(3), torch.ones(3)
    a = tF.sync_batch_norm(x, m1, v1, training=True)
    b = tF.batch_norm(x, m2, v2, training=True)
    assert torch.equal(a, b) and torch.equal(m1, m2) and torch.equal(v1, v2)

    class TwoRanks:
        nranks = 2
    with pytest.raises(NotImplementedError):
        tF.sync_batch_norm(x, m1, v1, training=True, group=TwoRanks())


def test_convert_sync_batchnorm():
    """Every batch norm in a net becomes a ``SyncBatchNorm`` that takes over
    its parameters, statistics and mode, in both packages."""
    def make(nn):
        return nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4),
                             nn.Sequential(nn.BatchNorm(4)))
    j, t = _pair(make)
    for m in (j, t):
        m.eval()
    with torch.no_grad():
        t[1]._mean.fill_(0.5)
    weight = t[1].weight
    jc = jnn.SyncBatchNorm.convert_sync_batchnorm(j)
    tc = tnn.SyncBatchNorm.convert_sync_batchnorm(t)
    assert [type(m).__name__ for m in tc.sublayers()] == \
        [type(m).__name__ for m in jc.sublayers()]
    assert isinstance(tc[1], tnn.SyncBatchNorm) and not tc[1].training
    assert isinstance(tc[2][0], tnn.SyncBatchNorm)
    assert float(tc[1]._mean[0]) == 0.5 and tc[1].weight is weight
    assert list(tc.state_dict()) == list(jc.state_dict())


def test_affine_grid_and_grid_sample_defaults():
    """``affine_grid`` / ``grid_sample`` default to ``align_corners=True``
    and ``grid_sample`` takes "bilinear" and "nearest" only, in both
    packages."""
    r = np.random.default_rng(12)
    theta = r.standard_normal((1, 2, 3)).astype(np.float32)
    x = r.standard_normal((1, 2, 4, 5)).astype(np.float32)
    g = tF.affine_grid(torch.tensor(theta), [1, 2, 4, 5])
    _close(g, tF.affine_grid(torch.tensor(theta), [1, 2, 4, 5],
                             align_corners=True).numpy(), 0.0)
    _close(tF.grid_sample(torch.tensor(x), g),
           tF.grid_sample(torch.tensor(x), g, align_corners=True).numpy(),
           0.0)
    with pytest.raises(ValueError):
        tF.grid_sample(torch.tensor(x), g, mode="bicubic")
    with pytest.raises(ValueError):
        jF.grid_sample(JT(x), JT(g.numpy()), mode="bicubic")


def test_autocast_lists_cast_the_spatial_ops_as_the_reference():
    """Under O1 bf16 the convolutions (the transposes too) take bf16 and
    ``group_norm`` / ``instance_norm`` take float32, in both packages."""
    for name in ("conv1d", "conv3d", "conv2d_transpose", "conv3d_transpose"):
        assert name in tamp_state.WHITE_LIST
    for name in ("group_norm", "instance_norm"):
        assert name in tamp_state.BLACK_LIST
    r = np.random.default_rng(13)
    x1, w1 = r.standard_normal((1, 2, 6)).astype(np.float32), \
        r.standard_normal((3, 2, 3)).astype(np.float32)
    x3, w3 = r.standard_normal((1, 2, 3, 3, 3)).astype(np.float32), \
        r.standard_normal((2, 3, 2, 2, 2)).astype(np.float32)
    xb = torch.tensor(r.standard_normal((1, 4, 3, 3)).astype(
        np.float32)).bfloat16()

    def port():
        with tamp.auto_cast(level="O1", dtype="bfloat16"):
            return [tF.conv1d(torch.tensor(x1), torch.tensor(w1)).dtype,
                    tF.conv1d_transpose(torch.tensor(x1),
                                        torch.tensor(w1.transpose(1, 0, 2)
                                                     .copy())).dtype,
                    tF.conv3d_transpose(torch.tensor(x3),
                                        torch.tensor(w3)).dtype,
                    tF.group_norm(xb, 2).dtype,
                    tF.instance_norm(xb).dtype]

    def ref():
        with jamp.auto_cast(level="O1", dtype="bfloat16"):
            xbj = JT(jnp.asarray(xb.float().numpy(), jnp.bfloat16))
            return [jF.conv1d(JT(x1), JT(w1)).dtype,
                    jF.conv1d_transpose(JT(x1), JT(w1.transpose(1, 0, 2)
                                                   .copy())).dtype,
                    jF.conv3d_transpose(JT(x3), JT(w3)).dtype,
                    jF.group_norm(xbj, 2).dtype,
                    jF.instance_norm(xbj).dtype]
    got = [str(d).replace("torch.", "") for d in port()]
    want = [str(np.dtype(d)) if not hasattr(d, "name") else d.name
            for d in ref()]
    assert got == ["bfloat16", "bfloat16", "bfloat16", "float32", "float32"]
    assert [w.replace("paddle.", "") for w in want] == got


def test_cross_entropy_picks_along_its_axis():
    """Found in the reference: its hard-label ``cross_entropy`` with an
    ``axis`` other than the last takes the label's entry as if the classes
    were last (``take_along_axis`` with ``label[..., None]``), so it picks
    the wrong log-probabilities.  The port's moves ``axis`` last first: its
    ``axis=1`` equals the reference's over the classes moved last."""
    r = np.random.default_rng(14)
    x = r.standard_normal((2, 3, 4)).astype(np.float32)
    lab = r.integers(0, 3, (2, 4))
    last = np.ascontiguousarray(x.transpose(0, 2, 1))
    port = tF.cross_entropy(torch.tensor(x), torch.tensor(lab), axis=1)
    want = jF.cross_entropy(JT(last), JT(lab))
    _close(port, np.asarray(want._data), 1e-6)
    ref_axis_1 = jF.cross_entropy(JT(x), JT(lab), axis=1)
    assert abs(float(ref_axis_1) - float(want)) > 1e-2
