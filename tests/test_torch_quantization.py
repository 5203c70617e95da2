"""The port's quantization API beyond the weight-only matmul
(``paddle_tpu_torch.quantization``: ``llm_int8_linear``, the fake-quant
ops, ``QuantConfig`` / ``QAT`` / ``PTQ`` and the fp8 ops) against the JAX
package, on the CPU (``set_device("cpu")``).

Floats are held in fp32 within TOL of the largest value compared; quantized
codes and fp8 bytes exactly (NaN where the reference gives NaN);
``llm_int8_linear``'s fp32 sums of int8 code products within INT8_SUM_TOL
relative (both packages round past 2^24 in their own order).  The
straight-through gradients are held against ``jax.grad`` of the reference.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
import paddle_tpu.quantization as JQ
from paddle_tpu.core.tensor import Tensor as JT
import paddle_tpu_torch as T
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.quantization as TQ
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

TOL = 2e-5
INT8_SUM_TOL = 1e-5


@contextlib.contextmanager
def _cpu():
    old = tdevice._current[0]
    T.set_device("cpu")
    try:
        yield
    finally:
        tdevice._current[0] = old


@pytest.fixture(autouse=True)
def on_cpu():
    with _cpu():
        yield


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(v):
    if torch.is_tensor(v):
        return v.detach().float().numpy()
    v = v._data if isinstance(v, JT) else v
    return np.asarray(jnp.asarray(v, jnp.float32))


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _j(a):
    return P.to_tensor(a)


def _t(a):
    return torch.tensor(a)


def test_namespace_has_every_reference_name():
    want = {"weight_quantize", "weight_dequantize", "weight_only_linear",
            "llm_int8_linear", "fake_quantize_abs_max",
            "fake_channel_wise_quantize_abs_max", "quant_with_scale",
            "fake_channel_wise_dequantize_max_abs", "QuantConfig",
            "FakeQuanterWithAbsMax", "AbsmaxObserver", "QAT", "PTQ",
            "fp8_quantize", "fp8_dequantize", "fp8_gemm", "fp8_linear"}
    assert want == set(TQ.__all__)
    assert all(hasattr(TQ, n) for n in want)


@pytest.mark.parametrize("bias", [False, True])
def test_llm_int8_linear_with_outlier_columns(bias):
    x = _x(2, 6, 64)
    x[..., [3, 17, 40]] *= 12.0          # columns above the threshold
    w = _x(64, 48, seed=1)
    b = _x(48, seed=2) if bias else None
    qw, s = TQ.weight_quantize(_t(w))
    jqw, js = JQ.weight_quantize(_j(w))
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw._data))
    want = JQ.llm_int8_linear(_j(x), jqw, None if b is None else _j(b),
                              weight_scale=js, threshold=6.0)
    got = TQ.llm_int8_linear(_t(x), qw, None if b is None else _t(b),
                             weight_scale=s, threshold=6.0)
    assert got.dtype == torch.float32
    _close(got, want, INT8_SUM_TOL)
    with pytest.raises(ValueError):
        TQ.llm_int8_linear(_t(x), qw)


def _grad_of(fn_ref, fn_port, x, cot):
    gref = jax.jit(jax.grad(lambda a: (fn_ref(JT(a))._data * cot).sum()))(x)
    tx = _t(x).requires_grad_(True)
    out = fn_port(tx)
    (out * _t(cot)).sum().backward()
    return out, tx.grad, np.asarray(gref)


@pytest.mark.parametrize("op,kw", [
    ("fake_quantize_abs_max", dict(bits=8)),
    ("fake_quantize_abs_max", dict(bits=4)),
    ("fake_channel_wise_quantize_abs_max", dict(bits=8, quant_axis=0)),
    ("fake_channel_wise_quantize_abs_max", dict(bits=8, quant_axis=1)),
    ("quant_with_scale", dict(scale=0.02, bits=8))])
def test_fake_quant_forward_and_straight_through_gradient(op, kw):
    x, cot = _x(6, 10), _x(6, 10, seed=1)
    want = getattr(JQ, op)(_j(x), **kw)
    out, g, gref = _grad_of(lambda a: getattr(JQ, op)(a, **kw),
                            lambda a: getattr(TQ, op)(a, **kw), x, cot)
    _close(out, want, TOL)
    np.testing.assert_array_equal(g.numpy(), gref)      # identity
    np.testing.assert_array_equal(g.numpy(), cot)


def test_fake_channel_wise_dequantize_max_abs():
    q = np.random.default_rng(0).integers(-127, 128, (5, 7)).astype(
        np.float32)
    for axis, n in ((0, 5), (1, 7)):
        s = np.abs(_x(n, seed=axis)) + 0.1
        _close(TQ.fake_channel_wise_dequantize_max_abs(
                   _t(q), _t(s), quant_bits=[8], quant_axis=axis),
               JQ.fake_channel_wise_dequantize_max_abs(
                   _j(q), _j(s), quant_bits=[8], quant_axis=axis), TOL)


def _mlp(nn, width=16):
    return nn.Sequential(nn.Linear(width, 32), nn.ReLU(), nn.Linear(32, 8))


def _carried_mlp():
    P.seed(0)
    j = _mlp(jnn)
    t = load_reference_state(_mlp(tnn), {
        k: np.asarray(v._data) for k, v in j.state_dict().items()})
    return j, t


def test_qat_wraps_every_linear_with_a_straight_through_quanter():
    j, t = _carried_mlp()
    cfg = JQ.QuantConfig(activation=None, weight=None)
    JQ.QAT(cfg).quantize(j)
    TQ.QAT(TQ.QuantConfig(activation=None, weight=None)).quantize(t)
    x, cot = _x(4, 16, seed=3), _x(4, 8, seed=4)
    out, g, gref = _grad_of(j, t, x, cot)
    _close(out, j(_j(x)).numpy(), TOL)
    _close(g, gref, TOL)
    assert isinstance(TQ.FakeQuanterWithAbsMax()(_t(x)), torch.Tensor)


def test_ptq_calibrate_and_convert():
    """Observers see the same 3 calibration batches; the converted weights
    and outputs equal the reference's, and stay within the reference test's
    relative error of 0.1 of the float model."""
    j, t = _carried_mlp()
    xs = _x(8, 16, seed=5)
    ref_float = t(_t(xs)).detach()
    JQ.PTQ().quantize(j)
    TQ.PTQ(TQ.QuantConfig()).quantize(t)
    for seed in range(3):
        batch = _x(8, 16, seed=10 + seed)
        j(_j(batch))
        t(_t(batch))
    for sj, st in zip(j._ptq_observed, t._ptq_observed):
        assert st._ptq_observer.absmax == pytest.approx(
            sj._ptq_observer.absmax, rel=1e-6)
    JQ.PTQ.convert(j)
    TQ.PTQ.convert(t)
    for k, v in j.state_dict().items():
        _close(t.state_dict()[k], np.asarray(v._data), TOL, k)
    carried = load_reference_state(_mlp(tnn), {
        k: np.asarray(v._data) for k, v in j.state_dict().items()})
    for k, v in carried.state_dict().items():
        _close(v, t.state_dict()[k], TOL, f"carried {k}")
    out = t(_t(xs)).detach()
    _close(out, j(_j(xs)).numpy(), TOL)
    rel = float((out - ref_float).abs().max() / ref_float.abs().max())
    assert rel < 0.1


def test_quant_config_and_observer():
    cfg = TQ.QuantConfig(activation="a", weight="w")
    layer = tnn.Linear(2, 2)
    cfg.add_layer_config(layer, activation="x")
    assert cfg._layer_configs[id(layer)] == ("x", None)
    obs = TQ.AbsmaxObserver(bits=8)
    obs(_t(np.array([[-3.0, 1.0]], np.float32)))
    assert obs.absmax == 3.0 and obs.scale == pytest.approx(3.0 / 127)


FP8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


@pytest.mark.parametrize("dtype", FP8)
def test_fp8_quantize_dequantize(dtype):
    x = _x(6, 33) * 5
    jq, js = JQ.fp8_quantize(_j(x), dtype=dtype)
    tq, ts = TQ.fp8_quantize(_t(x), dtype=dtype)
    assert tq.dtype == FP8[dtype][1] and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.float().numpy(), _np(jq))
    assert float(ts) == float(np.asarray(js._data))
    _close(TQ.fp8_dequantize(tq, ts),
           JQ.fp8_dequantize(jq, js), 0.0)


@pytest.mark.parametrize("dtype", FP8)
def test_fp8_quantize_overflow_with_a_given_scale(dtype):
    """Past float8_e4m3fn's range the reference's cast gives NaN (470 ->
    NaN, 464 and 460 -> 448), where torch's own cast saturates; e5m2
    overflows to inf in both."""
    v = np.array([1.0, 440, 460, 464, 464.1, 470, 1e5, 6e4, 7e4, -470,
                  -464, np.inf, np.nan], np.float32)
    scale = np.float32(0.5)
    x = v * scale
    jq, _ = JQ.fp8_quantize(_j(x), scale=_j(scale), dtype=dtype)
    tq, ts = TQ.fp8_quantize(_t(x), scale=_t(scale), dtype=dtype)
    want = _np(jq)
    np.testing.assert_array_equal(tq.float().numpy(), want)
    if dtype == "e4m3":
        assert np.isnan(want[[4, 5, 6, 7, 8, 9, 11]]).all()
        assert want[3] == 448.0
    assert float(ts) == 0.5


@pytest.mark.parametrize("bias", [False, True])
def test_fp8_gemm_and_linear(bias):
    x, w = _x(4, 32), _x(32, 24, seed=1) / 4
    b = _x(24, seed=2) if bias else None
    for out_dtype in ("bfloat16", "float32"):
        jqx, jsx = JQ.fp8_quantize(_j(x))
        jqw, jsw = JQ.fp8_quantize(_j(w))
        want = JQ.fp8_gemm(jqx, jsx, jqw, jsw,
                           bias=None if b is None else _j(b),
                           out_dtype=out_dtype)
        tqx, tsx = TQ.fp8_quantize(_t(x))
        tqw, tsw = TQ.fp8_quantize(_t(w))
        got = TQ.fp8_gemm(tqx, tsx, tqw, tsw,
                          bias=None if b is None else _t(b),
                          out_dtype=out_dtype)
        assert got.dtype == getattr(torch, out_dtype)
        _close(got, want, TOL if out_dtype == "float32" else 2 ** -8)
    want = JQ.fp8_linear(_j(x), _j(w), bias=None if b is None else _j(b))
    got = TQ.fp8_linear(_t(x), _t(w), bias=None if b is None else _t(b))
    assert got.dtype == torch.float32
    _close(got, want, TOL)
