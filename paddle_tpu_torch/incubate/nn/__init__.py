"""``paddle.incubate.nn``'s fused layers (the port of
``paddle_tpu/incubate/nn/__init__.py``): ``FusedLinear``,
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer`` and ``FusedBiasDropoutResidualLayerNorm``.

``FusedMultiHeadAttention`` is the Paddle API's way into the flash kernels.
It attends through :func:`paddle_tpu_torch.kernels.flash_attention.
flash_attention` exactly where the reference's layer reaches its Pallas
kernel: ``s >= 256``, ``128 | s``, no mask and no attention dropout
(``incubate/nn/__init__.py:99``), and a shape the reference's flash entry
takes to Pallas (:func:`~paddle_tpu_torch.kernels.flash_attention.
pallas_shape`).  There a CUDA tensor launches the Hopper kernels (or the
call raises) and a CPU tensor takes their plain versions; everywhere else
the layer takes the reference's plain einsum-softmax, on either device.
The arithmetic around it is the reference's: its layer norm (in float32,
rounded back to the input's dtype before the affine), FusedFeedForward's
tanh-approximated gelu, dropout on the branch and never on the residual.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from . import functional  # noqa: F401
from ...core.amp_state import cast as _amp
from ...kernels.flash_attention import flash_attention, pallas_shape
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer import Layer
from ...ops.math import add


def _ln(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _affine(x, w, b):
    """``x @ w + b`` with the operands promoted to one dtype, as JAX
    promotes them."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return TF.linear(x.to(dt), w.to(dt).t(), b.to(dt))


def flash_gate(s: int, d: int, masked: bool, attn_drop: float) -> bool:
    """Whether ``FusedMultiHeadAttention`` attends through the flash
    kernels at sequence ``s`` and head dim ``d``."""
    return s >= 256 and s % 128 == 0 and not masked and attn_drop == 0 and \
        pallas_shape(s, s, d)


def _keep(shape, p, device):
    return F._keep_mask(shape, 1 - p, device)


class FusedLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, transpose_weight=False, name=None):
        super().__init__()
        self.transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight else \
            [in_features, out_features]
        self.weight = self.create_parameter(
            shape, attr=weight_attr, default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], is_bias=True)

    def forward(self, x):
        return functional.fused_linear(x, self.weight, self.bias,
                                       self.transpose_weight)


class FusedMultiHeadAttention(Layer):
    """Pre- or post-LN multi-head self-attention with its residual: LN,
    the packed qkv projection, attention, the output projection, dropout on
    the projection and the residual add."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        init = I.XavierNormal()
        self.qkv_weight = self.create_parameter(
            [embed_dim, 3 * embed_dim], attr=qkv_weight_attr,
            default_initializer=init)
        self.qkv_bias = self.create_parameter([3 * embed_dim], is_bias=True)
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr,
            default_initializer=init)
        self.linear_bias = self.create_parameter([embed_dim], is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], default_initializer=I.Constant(1.0))
        self.ln_bias = self.create_parameter([embed_dim], is_bias=True)

    def _attend(self, q, k, v, mask, attn_drop):
        b, s, h, hd = q.shape
        if flash_gate(s, hd, mask is not None, attn_drop):
            q, k, v = _amp("flash_attention", q, k, v)
            return flash_attention(q, k, v, causal=False)
        logits = torch.einsum("bshd,bthd->bhst", q, k) * \
            (1.0 / math.sqrt(hd))
        if mask is not None:
            logits = logits + mask
        p = torch.softmax(logits.float(), -1).to(q.dtype)
        if attn_drop > 0:
            p = torch.where(_keep(p.shape, attn_drop, p.device),
                            p / (1 - attn_drop), 0.0)
        return torch.einsum("bhst,bthd->bshd", p, v)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        e, h, hd = self.embed_dim, self.num_heads, self.head_dim
        attn_drop = self.attn_dropout_rate if self.training else 0.0
        x, qkv_w, qkv_b, lin_w, lin_b, ln_w, ln_b, mask = _amp(
            "fused_multihead_attention", query, self.qkv_weight,
            self.qkv_bias, self.linear_weight, self.linear_bias,
            self.ln_scale, self.ln_bias, attn_mask)
        if self.normalize_before:
            x = _ln(x, ln_w, ln_b, self.epsilon)
        b, s, _ = x.shape
        qkv = _affine(x, qkv_w, qkv_b).reshape(b, s, 3, h, hd)
        out = self._attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask,
                           attn_drop)
        # the dropout acts on the projection only, never on the residual
        proj = _affine(out.reshape(b, s, e), lin_w, lin_b)
        y = add(query, F.dropout(proj, self.dropout_rate,
                                 training=self.training))
        if self.normalize_before:
            return y
        y, ln_w, ln_b = _amp("fused_mha_post_ln", y, self.ln_scale,
                             self.ln_bias)
        return _ln(y, ln_w, ln_b, self.epsilon)


class FusedFeedForward(Layer):
    """Pre- or post-LN feed-forward block with its residual: LN, ``w1``,
    the activation (relu, or gelu by its tanh approximation), dropout,
    ``w2``, dropout on the branch and the residual add."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 nranks=1, ring_id=-1, name=None):
        super().__init__()
        self.normalize_before = normalize_before
        self.epsilon = epsilon
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = act_dropout_rate \
            if act_dropout_rate is not None else dropout_rate
        self.act = {"relu": torch.relu,
                    "gelu": lambda v: TF.gelu(v, approximate="tanh")
                    }[activation]
        init = I.XavierNormal()
        self.w1 = self.create_parameter([d_model, dim_feedforward],
                                        default_initializer=init)
        self.b1 = self.create_parameter([dim_feedforward], is_bias=True)
        self.w2 = self.create_parameter([dim_feedforward, d_model],
                                        default_initializer=init)
        self.b2 = self.create_parameter([d_model], is_bias=True)
        self.ln_scale = self.create_parameter(
            [d_model], default_initializer=I.Constant(1.0))
        self.ln_bias = self.create_parameter([d_model], is_bias=True)

    def forward(self, src, cache=None):
        act_drop = self.act_dropout_rate if self.training else 0.0
        x, w1, b1, w2, b2, ln_w, ln_b = _amp(
            "fused_feedforward", src, self.w1, self.b1, self.w2, self.b2,
            self.ln_scale, self.ln_bias)
        if self.normalize_before:
            x = _ln(x, ln_w, ln_b, self.epsilon)
        hid = self.act(_affine(x, w1, b1))
        if act_drop > 0:           # between the activation and w2
            hid = torch.where(_keep(hid.shape, act_drop, hid.device),
                              hid / (1 - act_drop), 0.0)
        ffn = _affine(hid, w2, b2)
        y = add(src, F.dropout(ffn, self.dropout_rate,
                               training=self.training))
        if self.normalize_before:
            return y
        y, ln_w, ln_b = _amp("fused_ffn_post_ln", y, self.ln_scale,
                             self.ln_bias)
        return _ln(y, ln_w, ln_b, self.epsilon)


class FusedTransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, name=None):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate if attn_dropout_rate
            is not None else dropout_rate,
            normalize_before=normalize_before)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedBiasDropoutResidualLayerNorm(Layer):
    """``layer_norm(residual + dropout(x + bias))``."""

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5,
                 bias_attr=None, epsilon_attr=None, name=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        self.linear_bias = self.create_parameter([embed_dim], is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], default_initializer=I.Constant(1.0))
        self.ln_bias = self.create_parameter([embed_dim], is_bias=True)

    def forward(self, x, residual):
        y = functional.fused_dropout_add(
            add(x, self.linear_bias), residual, p=self.dropout_rate,
            training=self.training)
        y, ln_w, ln_b = _amp("fused_bias_dropout_residual_ln", y,
                             self.ln_scale, self.ln_bias)
        return _ln(y, ln_w, ln_b, self.epsilon)


__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedFeedForward",
           "FusedLinear", "FusedMultiHeadAttention",
           "FusedTransformerEncoderLayer", "flash_gate", "functional"]
