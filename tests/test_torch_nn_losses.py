"""The port's ``nn.functional`` of the sequence half (the losses, the
sequence utilities, the activations and dropouts) and the matching ``nn``
layers and containers against the JAX package, on the CPU.

Every deterministic function is one case of ``FUNCS``: numpy inputs from a
seed go through the reference's function and the port's; the outputs, and
the gradients of the float inputs named in the case from a random
cotangent, are held in fp32 within ``TOL`` of the tensor's largest value
(``_close``).  The reference's passes are its jitted arithmetic, all cases
in one ``jax.jit`` of ``jax.vjp`` (``ref_funcs``).  The layers of
``LAYERS`` carry the reference's state into the port (``_pair``) and
compare their output, input and parameter gradients the same way
(``_ref_layer_passes``).  Random draws (``rrelu`` in
training, ``gumbel_softmax``, ``class_center_sample``, the dropouts) come
from a ``torch.Generator``, not threefry: they are held by shape, support
and moments.
"""

import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.nn import functional as jF
import paddle_tpu_torch as T
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as tF

from paddle_tpu.utils import functional_call
from test_torch_nn_layers import (_assert_passes_equal, _close, _cot, _cpu,
                                  _pair, _port_pass, _x)

torch.set_num_threads(2)

TOL = 2e-5


@pytest.fixture(autouse=True)
def on_cpu():
    with _cpu():
        yield


def _f(r, *shape, lo=None, hi=None):
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.standard_normal(shape).astype(np.float32)


def _logp(r, *shape):
    x = _f(r, *shape)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _softmax(r, *shape):
    x = np.exp(_f(r, *shape))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _pm1(r, *shape, dtype=np.float32):
    return np.where(r.random(shape) < 0.5, -1, 1).astype(dtype)


def _csr(r, b, h, s):
    """A CSR layout a (batch, head): each row keeps 1..s random columns;
    the column lists padded to the largest count."""
    offs, cols = [], []
    for _ in range(b * h):
        rows = [np.sort(r.choice(s, r.integers(1, s + 1), replace=False))
                for _ in range(s)]
        offs.append(np.concatenate([[0], np.cumsum([len(c) for c in rows])]))
        cols.append(np.concatenate(rows))
    nnz = max(len(c) for c in cols)
    cols = [np.pad(c, (0, nnz - len(c))) for c in cols]
    return (np.stack(offs).reshape(b, h, s + 1).astype(np.int32),
            np.stack(cols).reshape(b, h, nnz).astype(np.int32))


def _ctc_inputs(r):
    lab = r.integers(1, 6, (3, 4)).astype(np.int32)
    lab[0, 1] = lab[0, 0]                        # a repeat: no skip there
    return [_f(r, 12, 3, 6), lab, np.array([12, 10, 7], np.int64),
            np.array([4, 2, 3], np.int64)]


def _rnnt_inputs(r):
    return [_f(r, 2, 5, 4, 6), r.integers(1, 6, (2, 3)).astype(np.int32),
            np.array([5, 3], np.int32), np.array([3, 2], np.int32)]


def _als_inputs(r):
    cut = [5, 12, 20]
    return [_f(r, 6, 8), np.array([0, 4, 5, 11, 12, 19], np.int64),
            _f(r, 7, 8), _f(r, 7), _f(r, 8, 2), _f(r, 2, 7), _f(r, 8, 1),
            _f(r, 1, 8)], cut


# name -> (fn(F, *inputs), inputs(rng), indices of the inputs that get a
# gradient).  fn is called with each package's functional module.
FUNCS = {
    # ---- losses ----
    "nll_loss": (lambda F, x, l: F.nll_loss(x, l, ignore_index=1),
                 lambda r: [_logp(r, 6, 5), np.array([0, 1, 4, 2, 1, 3])],
                 [0]),
    "nll_loss_weighted_4d": (
        lambda F, x, l, w: F.nll_loss(x, l, weight=w, reduction="mean"),
        lambda r: [_logp(r, 2, 4, 3, 3).transpose(0, 3, 1, 2).copy(),
                   r.integers(0, 3, (2, 4, 3)), _f(r, 3, lo=0.5, hi=2.0)],
        [0, 2]),
    "binary_cross_entropy": (
        lambda F, p, y, w: F.binary_cross_entropy(p, y, w),
        lambda r: [_f(r, 6, 4, lo=0.05, hi=0.95), _f(r, 6, 4, lo=0, hi=1),
                   _f(r, 4, lo=0.5, hi=2)], [0, 1, 2]),
    "binary_cross_entropy_with_logits": (
        lambda F, z, y, w, pw: F.binary_cross_entropy_with_logits(
            z, y, w, "sum", pw),
        lambda r: [_f(r, 6, 4) * 3, _f(r, 6, 4, lo=0, hi=1),
                   _f(r, 4, lo=0.5, hi=2), _f(r, 4, lo=0.5, hi=3)],
        [0, 1, 2, 3]),
    "kl_div": (lambda F, x, t: F.kl_div(x, t, "batchmean"),
               lambda r: [_logp(r, 4, 6), _softmax(r, 4, 6)], [0, 1]),
    "kl_div_log_target": (
        lambda F, x, t: F.kl_div(x, t, "none", log_target=True),
        lambda r: [_logp(r, 4, 6), _logp(r, 4, 6)], [0, 1]),
    "smooth_l1_loss": (lambda F, a, b: F.smooth_l1_loss(a, b, delta=0.7),
                       lambda r: [_f(r, 5, 4), _f(r, 5, 4)], [0, 1]),
    "huber_loss": (lambda F, a, b: F.huber_loss(a, b, 0.7, "sum"),
                   lambda r: [_f(r, 5, 4), _f(r, 5, 4)], [0, 1]),
    "margin_ranking_loss": (
        lambda F, a, b, y: F.margin_ranking_loss(a, b, y, 0.1),
        lambda r: [_f(r, 8), _f(r, 8), _pm1(r, 8)], [0, 1]),
    "cosine_embedding_loss": (
        lambda F, a, b, y: F.cosine_embedding_loss(a, b, y, 0.1),
        lambda r: [_f(r, 6, 5), _f(r, 6, 5), _pm1(r, 6, dtype=np.int64)],
        [0, 1]),
    "hinge_embedding_loss": (
        lambda F, a, y: F.hinge_embedding_loss(a, y, 0.8, "none"),
        lambda r: [_f(r, 6, 5), _pm1(r, 6, 5)], [0]),
    "soft_margin_loss": (lambda F, a, y: F.soft_margin_loss(a, y),
                         lambda r: [_f(r, 6, 5), _pm1(r, 6, 5)], [0]),
    "multi_label_soft_margin_loss": (
        lambda F, a, y, w: F.multi_label_soft_margin_loss(a, y, w),
        lambda r: [_f(r, 6, 5), (r.random((6, 5)) < 0.4).astype(np.float32),
                   _f(r, 5, lo=0.5, hi=2)], [0, 2]),
    "multi_margin_loss": (
        lambda F, a, y, w: F.multi_margin_loss(a, y, 2, 0.8, w, "sum"),
        lambda r: [_f(r, 6, 5), r.integers(0, 5, (6,)),
                   _f(r, 5, lo=0.5, hi=2)], [0, 2]),
    "poisson_nll_loss": (
        lambda F, a, y: F.poisson_nll_loss(a, y, full=True),
        lambda r: [_f(r, 6, 5), r.integers(0, 5, (6, 5)).astype(
            np.float32)], [0]),
    "poisson_nll_loss_rates": (
        lambda F, a, y: F.poisson_nll_loss(a, y, log_input=False,
                                           reduction="sum"),
        lambda r: [_f(r, 6, 5, lo=0.2, hi=3), r.integers(0, 5, (6, 5))
                   .astype(np.float32)], [0]),
    "gaussian_nll_loss": (
        lambda F, a, y, v: F.gaussian_nll_loss(a, y, v, full=True),
        lambda r: [_f(r, 6, 5), _f(r, 6, 5), _f(r, 6, 5, lo=0.1, hi=2)],
        [0, 1, 2]),
    "triplet_margin_loss": (
        lambda F, a, p, n: F.triplet_margin_loss(a, p, n, 0.5, swap=True),
        lambda r: [_f(r, 6, 5), _f(r, 6, 5), _f(r, 6, 5)], [0, 1, 2]),
    "triplet_margin_with_distance_loss": (
        lambda F, a, p, n: F.triplet_margin_with_distance_loss(
            a, p, n, margin=2.0, swap=True),
        lambda r: [_f(r, 6, 5), _f(r, 6, 5), _f(r, 6, 5)], [0, 1, 2]),
    "square_error_cost": (lambda F, a, b: F.square_error_cost(a, b),
                          lambda r: [_f(r, 4, 3), _f(r, 4, 3)], [0, 1]),
    "log_loss": (lambda F, p, y: F.log_loss(p, y),
                 lambda r: [_f(r, 6, 1, lo=0.05, hi=0.95),
                            (r.random((6, 1)) < 0.5).astype(np.float32)],
                 [0]),
    "dice_loss": (lambda F, a, y: F.dice_loss(a, y),
                  lambda r: [_softmax(r, 2, 4, 4, 3),
                             r.integers(0, 3, (2, 4, 4, 1))], [0]),
    "npair_loss": (lambda F, a, p, y: F.npair_loss(a, p, y),
                   lambda r: [_f(r, 6, 5), _f(r, 6, 5),
                              np.array([0, 1, 2, 1, 0, 3])], [0, 1]),
    "sigmoid_focal_loss": (
        lambda F, z, y, n: F.sigmoid_focal_loss(z, y, n),
        lambda r: [_f(r, 6, 5) * 2, (r.random((6, 5)) < 0.3).astype(
            np.float32), np.array([3.0], np.float32)], [0]),
    "softmax_with_cross_entropy": (
        lambda F, x, l: F.softmax_with_cross_entropy(x, l, ignore_index=2),
        lambda r: [_f(r, 6, 5), r.integers(0, 5, (6, 1))], [0]),
    "softmax_with_cross_entropy_soft": (
        lambda F, x, l: F.softmax_with_cross_entropy(
            x, F.label_smooth(l, epsilon=0.1), soft_label=True, axis=1),
        lambda r: [_f(r, 3, 5, 4), np.eye(5, dtype=np.float32)[
            r.integers(0, 5, (3, 4))].transpose(0, 2, 1).copy()], [0]),
    "margin_cross_entropy": (
        lambda F, x, l: F.margin_cross_entropy(x, l, 1.0, 0.3, 0.1, 16.0,
                                               return_softmax=True),
        lambda r: [_f(r, 6, 10, lo=-0.9, hi=0.9), r.integers(0, 10, (6,))],
        [0]),
    "hsigmoid_loss": (
        lambda F, x, l, w, b: F.hsigmoid_loss(x, l, 10, w, b),
        lambda r: [_f(r, 6, 8), np.array([0, 3, 9, 5, 7, 1]), _f(r, 9, 8),
                   _f(r, 9)], [0, 2, 3]),
    "hsigmoid_loss_custom": (
        lambda F, x, l, w, pt, pc: F.hsigmoid_loss(
            x, l, 6, w, path_table=pt, path_code=pc),
        lambda r: [_f(r, 4, 8), np.array([0, 1, 2, 3]), _f(r, 5, 8),
                   np.array([[0, 1, -1], [0, 2, 4], [3, -1, -1],
                             [0, 1, 3]]),
                   r.integers(0, 2, (4, 3))], [0, 2]),
    "adaptive_log_softmax_with_loss": (
        lambda F, x, l, hw, hb, a1, a2, b1, b2: F.
        adaptive_log_softmax_with_loss(x, l, hw, hb, [5, 12, 20],
                                       [(a1, a2), (b1, b2)]),
        lambda r: _als_inputs(r)[0], [0, 2, 3, 4, 5, 6, 7]),
    "ctc_loss": (lambda F, *a: F.ctc_loss(*a, blank=0),
                 _ctc_inputs, [0]),
    "ctc_loss_norm_by_times": (
        lambda F, *a: F.ctc_loss(*a, blank=0, reduction="none",
                                 norm_by_times=True), _ctc_inputs, [0]),
    "rnnt_loss": (lambda F, *a: F.rnnt_loss(*a, blank=0), _rnnt_inputs,
                  [0]),
    "rnnt_loss_none": (lambda F, *a: F.rnnt_loss(*a, blank=5,
                                                 reduction="none"),
                       _rnnt_inputs, [0]),
    # ---- sequence utilities ----
    "one_hot": (lambda F, i: F.one_hot(i, 5),
                lambda r: [np.array([[0, 4, 2], [1, -1, 3]])], []),
    "sequence_mask": (lambda F, n: F.sequence_mask(n, 6, dtype="float32"),
                      lambda r: [np.array([0, 3, 6, 2])], []),
    "label_smooth": (lambda F, y: F.label_smooth(y, epsilon=0.2),
                     lambda r: [_softmax(r, 4, 5)], [0]),
    "edit_distance": (lambda F, h, g, hl, rl: F.edit_distance(h, g, hl, rl),
                      lambda r: [r.integers(0, 4, (4, 6)),
                                 r.integers(0, 4, (4, 5)),
                                 np.array([6, 3, 0, 5]),
                                 np.array([5, 5, 2, 0])], []),
    "edit_distance_raw": (
        lambda F, h, g, hl, rl: F.edit_distance(h, g, hl, rl,
                                                normalized=False),
        lambda r: [r.integers(0, 3, (3, 7)), r.integers(0, 3, (3, 4)),
                   np.array([7, 2, 5]), np.array([4, 3, 1])], []),
    "gather_tree": (lambda F, i, p: F.gather_tree(i, p),
                    lambda r: [r.integers(0, 9, (5, 2, 3)),
                               r.integers(0, 3, (5, 2, 3))], []),
    "normalize": (lambda F, x: F.normalize(x), lambda r: [_f(r, 3, 4, 2)],
                  [0]),
    "normalize_p1": (lambda F, x: F.normalize(x, p=1, axis=-1),
                     lambda r: [_f(r, 3, 4)], [0]),
    "cosine_similarity": (lambda F, a, b: F.cosine_similarity(a, b, axis=-1),
                          lambda r: [_f(r, 4, 6), _f(r, 4, 6)], [0, 1]),
    "pairwise_distance": (lambda F, a, b: F.pairwise_distance(a, b),
                          lambda r: [_f(r, 4, 6), _f(r, 4, 6)], [0, 1]),
    "pairwise_distance_inf": (
        lambda F, a, b: F.pairwise_distance(a, b, p=float("inf"),
                                            keepdim=True),
        lambda r: [_f(r, 4, 6), _f(r, 4, 6)], [0, 1]),
    "pairwise_distance_p1": (lambda F, a, b: F.pairwise_distance(a, b, 1.0),
                             lambda r: [_f(r, 4, 6), _f(r, 4, 6)], [0, 1]),
    "bilinear": (lambda F, a, b, w, c: F.bilinear(a, b, w, c),
                 lambda r: [_f(r, 4, 3), _f(r, 4, 5), _f(r, 2, 3, 5),
                            _f(r, 1, 2)], [0, 1, 2, 3]),
    "rms_norm": (lambda F, x, w: F.rms_norm(x, w, 1e-5),
                 lambda r: [_f(r, 3, 4, 8), _f(r, 8)], [0, 1]),
    "swiglu": (lambda F, x: F.swiglu(x), lambda r: [_f(r, 3, 8)], [0]),
    "swiglu_pair": (lambda F, x, y: F.swiglu(x, y),
                    lambda r: [_f(r, 3, 4), _f(r, 3, 4)], [0, 1]),
    "fused_softmax_mask": (
        lambda F, x, m: F.fused_softmax_mask(x, m, 0.5),
        lambda r: [_f(r, 2, 2, 4, 5), np.where(r.random((2, 1, 4, 5)) < 0.3,
                                               -1e4, 0).astype(np.float32)],
        [0]),
    "fused_softmax_mask_upper_triangle": (
        lambda F, x: F.fused_softmax_mask_upper_triangle(x),
        lambda r: [_f(r, 2, 2, 3, 5)], [0]),
    "sparse_attention": (
        lambda F, q, k, v, o, c: F.sparse_attention(q, k, v, o, c),
        lambda r: [_f(r, 1, 2, 4, 8), _f(r, 1, 2, 4, 8), _f(r, 1, 2, 4, 8),
                   *_csr(r, 1, 2, 4)], [0, 1, 2]),
    # ---- activations ----
    "prelu": (lambda F, x, w: F.prelu(x, w),
              lambda r: [_f(r, 2, 3, 4), _f(r, 3, lo=0.1, hi=0.5)], [0, 1]),
    "prelu_channels_last": (lambda F, x, w: F.prelu(x, w, "NCL"),
                            lambda r: [_f(r, 2, 3, 4),
                                       _f(r, 4, lo=0.1, hi=0.5)], [0, 1]),
    "prelu_shared": (lambda F, x, w: F.prelu(x, w),
                     lambda r: [_f(r, 2, 5), np.array([0.2], np.float32)],
                     [0, 1]),
    "rrelu": (lambda F, x: F.rrelu(x, 0.1, 0.3, training=False),
              lambda r: [_f(r, 4, 5)], [0]),
    "thresholded_relu": (lambda F, x: F.thresholded_relu(x, 0.5, 0.25),
                         lambda r: [_f(r, 4, 5)], [0]),
    "tanh_shrink": (lambda F, x: F.tanh_shrink(x), lambda r: [_f(r, 4, 5)],
                    [0]),
    "relu_": (lambda F, x: F.relu_(x * 1.0), lambda r: [_f(r, 4, 5)], [0]),
    "elu_": (lambda F, x: F.elu_(x * 1.0, 0.7), lambda r: [_f(r, 4, 5)],
             [0]),
    "leaky_relu_": (lambda F, x: F.leaky_relu_(x * 1.0, 0.2),
                    lambda r: [_f(r, 4, 5)], [0]),
    "hardtanh_": (lambda F, x: F.hardtanh_(x * 1.0, -0.5, 0.8),
                  lambda r: [_f(r, 4, 5)], [0]),
    "softmax_": (lambda F, x: F.softmax_(x * 1.0, axis=0),
                 lambda r: [_f(r, 4, 5)], [0]),
    "tanh_": (lambda F, x: F.tanh_(x * 1.0), lambda r: [_f(r, 4, 5)], [0]),
    "thresholded_relu_": (lambda F, x: F.thresholded_relu_(x * 1.0, 0.3),
                          lambda r: [_f(r, 4, 5)], [0]),
    # ---- dropouts outside training ----
    "alpha_dropout_eval": (lambda F, x: F.alpha_dropout(x, 0.3, False),
                           lambda r: [_f(r, 4, 5)], [0]),
    "feature_alpha_dropout_eval": (
        lambda F, x: F.feature_alpha_dropout(x, 0.3, False),
        lambda r: [_f(r, 2, 3, 4)], [0]),
    "dropout2d_eval": (lambda F, x: F.dropout2d(x, 0.3, False),
                       lambda r: [_f(r, 2, 3, 4, 4)], [0]),
    "dropout3d_eval": (lambda F, x: F.dropout3d(x, 0.3, False),
                       lambda r: [_f(r, 2, 3, 2, 2, 2)], [0]),
}


def _inputs(case):
    seed = sorted(FUNCS).index(case)
    return FUNCS[case][1](np.random.default_rng(seed))


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _is_float(a):
    return np.asarray(a).dtype.kind == "f"


def _cots(outs):
    return [np.random.default_rng(11 + i).standard_normal(np.shape(o))
            .astype(np.float32) for i, o in enumerate(outs)]


@pytest.fixture(scope="module")
def ref_funcs():
    """Every case's reference pass, one ``jax.jit`` of ``jax.vjp``: (the
    outputs, the gradients of the case's grad inputs)."""
    def one(fn, inputs, grad_idx, floats):
        def f(floats):
            xs = [JT(a) for a in inputs]
            for i, a in zip(grad_idx, floats):
                xs[i] = JT(a)
            outs = [o._data for o in _leaves(fn(jF, *xs))]
            fl = tuple(o for o in outs if o.dtype.kind == "f")
            rest = tuple(o for o in outs if o.dtype.kind != "f")
            return fl, rest
        fl, vjp, rest = jax.vjp(f, floats, has_aux=True)
        (grads,) = vjp(tuple(c.astype(o.dtype) for c, o in
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
    fn, make, grad_idx = FUNCS[case]
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
    equal."""
    fl, rest, grads = _port(case)
    want_fl, want_rest, want_grads = ref_funcs[case]
    assert len(fl) == len(want_fl) and len(rest) == len(want_rest)
    for i, (g, w) in enumerate(zip(fl, want_fl)):
        _close(g, w, TOL, f"out {i}")
    for g, w in zip(rest, want_rest):
        np.testing.assert_array_equal(g.numpy(), w)
        assert g.dtype == {"int64": torch.int64, "int32": torch.int32,
                           "bool": torch.bool}[str(w.dtype)], g.dtype
    for i, (g, w) in zip(FUNCS[case][2], zip(grads, want_grads)):
        _close(g, w, TOL, f"grad of input {i}")


def test_ctc_loss_too_short_is_huge_and_finite():
    """An input shorter than its labels need: the reference's -1e30 in
    place of -inf gives a huge finite loss (torch's ``F.ctc_loss`` gives
    inf), and the port gives the same."""
    lp = _x(4, 2, 5)
    lab = np.array([[1, 2, 1, 3], [2, 2, 0, 0]])
    args = [lp, lab, np.array([3, 4]), np.array([4, 2])]
    ref = jF.ctc_loss(*[JT(a) for a in args], reduction="none").numpy()
    got = tF.ctc_loss(*[torch.tensor(a) for a in args], reduction="none")
    assert np.isfinite(ref).all() and ref[0] > 1e29
    _close(got, ref)
    torch_ctc = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.tensor(lp), -1), torch.tensor(lab),
        torch.tensor([3, 4]), torch.tensor([4, 2]), reduction="none")
    assert torch.isinf(torch_ctc[0])


def test_sequence_mask_reads_the_longest_length():
    n = np.array([[1, 4], [0, 2]])
    ref = jF.sequence_mask(JT(n)).numpy()
    got = tF.sequence_mask(torch.tensor(n))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


def test_label_smooth_ignores_prior_dist():
    """The reference takes ``prior_dist`` and ignores it (kept in the port,
    ROADMAP Queue 3)."""
    y = np.eye(4, dtype=np.float32)[[0, 2, 3]]
    prior = np.array([0.7, 0.1, 0.1, 0.1], np.float32)
    ref = jF.label_smooth(JT(y), JT(prior), 0.2).numpy()
    got = tF.label_smooth(torch.tensor(y), torch.tensor(prior), 0.2)
    _close(got, ref)
    _close(got, 0.8 * y + 0.05)


def test_margin_losses_with_a_group_raise():
    x, lab = torch.rand(4, 6), torch.tensor([0, 1, 2, 3])
    with pytest.raises(NotImplementedError):
        tF.margin_cross_entropy(x, lab, group=object())
    with pytest.raises(NotImplementedError):
        tF.class_center_sample(lab, 6, 4, group=object())


def test_inplace_activations_write_their_input():
    x = torch.tensor(_x(3, 4))
    want = torch.tanh(x.clone())
    assert tF.tanh_(x) is x and torch.equal(x, want)
    leaf = torch.tensor(_x(3, 4), requires_grad=True)
    tF.relu_(leaf)
    assert (leaf >= 0).all() and leaf.requires_grad


# ---------------- random draws: shape, support, moments ----------------

def test_rrelu_training_slopes():
    T.seed(1)
    x = torch.tensor(_x(400, 50))
    y = tF.rrelu(x, 0.1, 0.3, training=True)
    pos = x >= 0
    assert torch.equal(y[pos], x[pos])
    slope = y[~pos] / x[~pos]
    assert slope.min() >= 0.1 - 1e-6 and slope.max() < 0.3 + 1e-6
    assert abs(slope.mean().item() - 0.2) < 0.005
    assert torch.equal(tnn.RReLU(0.1, 0.3).eval()(x),
                       tF.rrelu(x, 0.1, 0.3, training=False))


def test_gumbel_softmax_soft_and_hard():
    T.seed(2)
    x = torch.tensor(_x(64, 7), requires_grad=True)
    soft = tF.gumbel_softmax(x, temperature=0.5)
    _close(soft.sum(-1), np.ones(64, np.float32))
    hard = tF.gumbel_softmax(x, hard=True)
    assert ((hard == 0) | (hard == 1)).all() and (hard.sum(-1) == 1).all()
    (hard * torch.arange(7.0)).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    # the argmax follows x + Gumbel noise: over many draws the class
    # frequencies follow softmax(x)
    z = torch.tensor([[2.0, 1.0, 0.0]]).expand(20000, 3)
    freq = tF.gumbel_softmax(z, hard=True).mean(0)
    _close(freq, torch.softmax(z[0], 0).numpy(), tol=0.02)


def test_class_center_sample():
    T.seed(3)
    label = torch.tensor([3, 17, 3, 8, 29, 17])
    remapped, sampled = tF.class_center_sample(label, 40, 10)
    assert sampled.shape == (10,) and sampled.dtype == label.dtype
    assert torch.equal(sampled, torch.sort(sampled).values)
    assert len(set(sampled.tolist())) == 10
    assert set(label.tolist()) <= set(sampled.tolist())
    assert torch.equal(sampled[remapped], label)
    ref_r, ref_s = jF.class_center_sample(JT(label.numpy()), 40, 10)
    assert set(label.tolist()) <= set(ref_s.numpy().tolist())


@pytest.mark.parametrize("fn,p", [("alpha_dropout", 0.2),
                                  ("feature_alpha_dropout", 0.3)])
def test_alpha_dropouts_keep_selu_moments(fn, p):
    """Kept entries are ``a * x + b``, dropped ones ``a * alpha' + b``;
    a standard normal input keeps mean 0 and variance 1; the feature form
    drops whole channels."""
    T.seed(4)
    x = torch.randn(256, 64, 8, generator=torch.Generator().manual_seed(0))
    y = getattr(tF, fn)(x, p)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = 1 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    dropped = torch.isclose(y, torch.full_like(y, a * alpha_p + b))
    kept = ~dropped
    _close(y[kept], (a * x[kept] + b).numpy())
    assert abs(dropped.float().mean().item() - p) < 0.03
    assert abs(y.mean().item()) < 0.03 and abs(y.var().item() - 1) < 0.05
    if fn == "feature_alpha_dropout":
        assert (dropped.all(-1) | kept.all(-1)).all()


@pytest.mark.parametrize("fn,shape", [("dropout2d", (16, 32, 3, 3)),
                                      ("dropout3d", (16, 32, 2, 2, 2))])
def test_channel_dropouts(fn, shape):
    T.seed(5)
    x = torch.ones(shape)
    y = getattr(tF, fn)(x, 0.25)
    flat = y.reshape(shape[0], shape[1], -1)
    assert ((flat == 0).all(-1) | (flat == 1 / 0.75).all(-1)).all()
    assert abs((flat[..., 0] == 0).float().mean().item() - 0.25) < 0.06


# ---------------- layers ----------------

def _lab(r, n, k):
    return r.integers(0, k, (n,))


# name -> (make(nn), inputs(rng), eval mode)
LAYERS = {
    "NLLLoss": (lambda nn: nn.NLLLoss(ignore_index=1),
                lambda r: [_logp(r, 6, 5), _lab(r, 6, 5)], False),
    "BCELoss": (lambda nn: nn.BCELoss(reduction="sum"),
                lambda r: [_f(r, 6, 4, lo=0.05, hi=0.95),
                           _f(r, 6, 4, lo=0, hi=1)], False),
    "BCEWithLogitsLoss": (lambda nn: nn.BCEWithLogitsLoss(),
                          lambda r: [_f(r, 6, 4), _f(r, 6, 4, lo=0, hi=1)],
                          False),
    "KLDivLoss": (lambda nn: nn.KLDivLoss("sum"),
                  lambda r: [_logp(r, 4, 6), _softmax(r, 4, 6)], False),
    "SmoothL1Loss": (lambda nn: nn.SmoothL1Loss(delta=0.5),
                     lambda r: [_f(r, 5, 4), _f(r, 5, 4)], False),
    "MarginRankingLoss": (lambda nn: nn.MarginRankingLoss(0.2),
                          lambda r: [_f(r, 8), _f(r, 8), _pm1(r, 8)], False),
    "CTCLoss": (lambda nn: nn.CTCLoss(blank=0), _ctc_inputs, False),
    "RNNTLoss": (lambda nn: nn.RNNTLoss(), _rnnt_inputs, False),
    "CosineEmbeddingLoss": (lambda nn: nn.CosineEmbeddingLoss(0.2),
                            lambda r: [_f(r, 6, 5), _f(r, 6, 5),
                                       _pm1(r, 6, dtype=np.int64)], False),
    "HingeEmbeddingLoss": (lambda nn: nn.HingeEmbeddingLoss(),
                           lambda r: [_f(r, 6, 5),
                                      _pm1(r, 6, 5, dtype=np.int64)], False),
    "MultiLabelSoftMarginLoss": (
        lambda nn: nn.MultiLabelSoftMarginLoss(),
        lambda r: [_f(r, 6, 5), (r.random((6, 5)) < 0.4).astype(
            np.float32)], False),
    "MultiMarginLoss": (lambda nn: nn.MultiMarginLoss(),
                        lambda r: [_f(r, 6, 5), _lab(r, 6, 5)], False),
    "PoissonNLLLoss": (lambda nn: nn.PoissonNLLLoss(),
                       lambda r: [_f(r, 6, 5), r.integers(0, 4, (6, 5))
                                  .astype(np.float32)], False),
    "GaussianNLLLoss": (lambda nn: nn.GaussianNLLLoss(),
                        lambda r: [_f(r, 6, 5), _f(r, 6, 5),
                                   _f(r, 6, 5, lo=0.1, hi=2)], False),
    "SoftMarginLoss": (lambda nn: nn.SoftMarginLoss(),
                       lambda r: [_f(r, 6, 5), _pm1(r, 6, 5)], False),
    "TripletMarginLoss": (lambda nn: nn.TripletMarginLoss(margin=0.5),
                          lambda r: [_f(r, 6, 5), _f(r, 6, 5), _f(r, 6, 5)],
                          False),
    "TripletMarginWithDistanceLoss": (
        lambda nn: nn.TripletMarginWithDistanceLoss(margin=2.0),
        lambda r: [_f(r, 6, 5), _f(r, 6, 5), _f(r, 6, 5)], False),
    "HSigmoidLoss": (lambda nn: nn.HSigmoidLoss(8, 10),
                     lambda r: [_f(r, 6, 8), _lab(r, 6, 10)], False),
    "CosineSimilarity": (lambda nn: nn.CosineSimilarity(axis=-1),
                         lambda r: [_f(r, 4, 6), _f(r, 4, 6)], False),
    "PairwiseDistance": (lambda nn: nn.PairwiseDistance(keepdim=True),
                         lambda r: [_f(r, 4, 6), _f(r, 4, 6)], False),
    "PReLU": (lambda nn: nn.PReLU(3, 0.1), lambda r: [_f(r, 2, 3, 4)],
              False),
    "RReLU": (lambda nn: nn.RReLU(), lambda r: [_f(r, 4, 5)], True),
    "ThresholdedReLU": (lambda nn: nn.ThresholdedReLU(0.3),
                        lambda r: [_f(r, 4, 5)], False),
    "Softmax2D": (lambda nn: nn.Softmax2D(), lambda r: [_f(r, 2, 3, 4, 5)],
                  False),
    "AlphaDropout": (lambda nn: nn.AlphaDropout(0.3),
                     lambda r: [_f(r, 4, 5)], True),
    "FeatureAlphaDropout": (lambda nn: nn.FeatureAlphaDropout(0.3),
                            lambda r: [_f(r, 2, 3, 4)], True),
    "Dropout2D": (lambda nn: nn.Dropout2D(0.3),
                  lambda r: [_f(r, 2, 3, 4, 4)], True),
    "Dropout3D": (lambda nn: nn.Dropout3D(0.3),
                  lambda r: [_f(r, 2, 3, 2, 2, 2)], True),
    "RMSNorm": (lambda nn: nn.RMSNorm(8), lambda r: [_f(r, 3, 4, 8)], False),
    "Bilinear": (lambda nn: nn.Bilinear(3, 5, 2),
                 lambda r: [_f(r, 4, 3), _f(r, 4, 5)], False),
    "Unflatten": (lambda nn: nn.Unflatten(1, [2, 3]),
                  lambda r: [_f(r, 4, 6, 2)], False),
}


def _layer_inputs(case):
    return LAYERS[case][1](np.random.default_rng(100 +
                                                 sorted(LAYERS).index(case)))


def _ref_layer_passes(cases):
    """Each ``(layer, inputs)`` of ``cases`` through the reference, one
    jitted ``jax.vjp`` of ``functional_call`` (``test_torch_nn_layers``'s
    ``_ref_passes`` without buffers; the cotangent takes the output's dtype:
    the reference's ``rnnt_loss`` returns float64)."""
    def one(j, inputs, params, floats):
        fl = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"]

        def f(params, floats):
            xs = list(inputs)
            for i, a in zip(fl, floats):
                xs[i] = a
            return functional_call(j, params, *[JT(a) for a in xs])
        out, vjp = jax.vjp(f, params, floats)
        gp, gx = vjp(_cot(out.shape, 1).astype(out.dtype))
        return out, gx, gp

    def run(all_params, all_floats):
        return {k: one(j, inputs, all_params[k], all_floats[k])
                for k, (j, inputs) in cases.items()}
    params = {k: {n: p._data for n, p in j.named_parameters()}
              for k, (j, _) in cases.items()}
    floats = {k: [a for a in inputs if a.dtype.kind == "f"]
              for k, (_, inputs) in cases.items()}
    res = jax.jit(run)(params, floats)
    return {k: (np.asarray(o), [np.asarray(g) for g in gx],
                {n: np.asarray(g) for n, g in gp.items()})
            for k, (o, gx, gp) in res.items()}


@pytest.fixture(scope="module")
def layer_refs():
    with _cpu():
        pairs = {}
        for case, (make, _, evaluate) in LAYERS.items():
            j, t = _pair(make)
            if evaluate:
                j.eval()
                t.eval()
            pairs[case] = (j, t)
    refs = _ref_layer_passes({case: (j, _layer_inputs(case))
                        for case, (j, _) in pairs.items()})
    return pairs, refs


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layers(case, layer_refs):
    pairs, refs = layer_refs
    _assert_passes_equal(refs[case],
                         _port_pass(pairs[case][1], _layer_inputs(case)),
                         TOL)


def test_adaptive_log_softmax_layer():
    j, t = _pair(lambda nn: nn.AdaptiveLogSoftmaxWithLoss(
        8, 20, [5, 12], div_value=2.0, head_bias=True))
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    x, lab = _x(6, 8), np.array([0, 4, 5, 11, 12, 19])
    params = {n: p._data for n, p in j.named_parameters()}
    jo, jl = jax.jit(lambda ps: functional_call(j, ps, JT(x), JT(lab)))(
        params)
    tx = torch.tensor(x, requires_grad=True)
    to, tl = t(tx, torch.tensor(lab))
    _close(to, np.asarray(jo))
    _close(tl, np.asarray(jl))
    tl.backward()
    assert tx.grad is not None
    with pytest.raises(NotImplementedError):
        t.log_prob(tx)


def test_containers():
    d = tnn.ParameterDict({"a": T.Parameter(torch.ones(2)),
                           "b": T.Parameter(torch.zeros(3))})
    d["c"] = T.Parameter(torch.ones(1))
    assert list(d) == ["a", "b", "c"] and len(d) == 3 and "b" in d
    assert [n for n, _ in d.named_parameters()] == ["a", "b", "c"]
    layers = tnn.LayerDict({"x": tnn.Linear(2, 3)})
    layers.update([("y", tnn.ReLU())])
    assert list(layers.keys()) == ["x", "y"] and "y" in layers
    assert isinstance(layers.pop("y"), tnn.ReLU) and len(layers) == 1
    assert list(layers.state_dict()) == ["x.weight", "x.bias"]
    P.seed(0)
    jd = jnn.LayerDict({"x": jnn.Linear(2, 3)})
    assert list(jd.state_dict()) == list(layers.state_dict())
    layers.clear()
    assert len(layers) == 0
    assert tnn.Tensor is torch.Tensor and tnn.Parameter is T.Parameter
    assert math.isclose(float(tnn.PReLU()(torch.tensor([-2.0]))), -0.5)
