"""The port's fused layers (``paddle_tpu_torch.incubate.nn``) against the
JAX package, on the CPU (``set_device("cpu")``).

Each layer is built in both packages and the reference's state carried
into the port with ``set_state_dict``; the same numpy input goes forward
and backward through both (the reference's pass is one jitted ``jax.vjp``
of ``functional_call``), and the output, the input gradient and every
parameter gradient are held in fp32 within TOL of the largest value
compared.  Both of the reference's attention paths are held:

- s 128 (and any mask): the plain einsum-softmax in both packages;
- s 512 at head dim 64, no mask, no attention dropout: the reference runs
  its Pallas flash kernels (in interpret mode, flag
  ``flash_attention_interpret``, as its own tests run them on the CPU) and
  the port calls its flash entry, whose plain versions run on the CPU.
  Both routes are counted, so the case fails if either package attends
  another way.  Flash against the plain arithmetic differs in rounding
  order: FLASH_TOL.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import amp as jamp
from paddle_tpu import flags as jflags
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.incubate import nn as jinn
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.utils import functional_call
import paddle_tpu_torch as T
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.incubate import nn as tinn

torch.set_num_threads(2)

TOL = 2e-5
FLASH_TOL = 1e-4


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


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _pair(make):
    P.seed(0)
    j = make(jinn)
    T.seed(0)
    t = make(tinn)
    missing, unexpected = t.set_state_dict(
        {k: np.asarray(v._data) for k, v in j.state_dict().items()})
    assert not missing and not unexpected
    assert list(t.state_dict()) == list(j.state_dict())
    return j, t


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cot(shape, seed=1):
    return _x(*shape, seed=seed)


def _both(j, t, inputs, kwargs_ref=None, kwargs_port=None):
    """(reference, port) of (out, grads of the float inputs, parameter
    grads) from one forward and backward."""
    kwargs_ref, kwargs_port = kwargs_ref or {}, kwargs_port or {}
    tin = [torch.tensor(a, requires_grad=True) for a in inputs]
    tout = t(*tin, **kwargs_port)
    (tout * torch.tensor(_cot(tuple(tout.shape)))).sum().backward()
    params = {n: p._data for n, p in j.named_parameters()}

    def pass_(params, xs):
        out, vjp = jax.vjp(lambda p, a: functional_call(
            j, p, *[JT(v) for v in a], **kwargs_ref), params, xs)
        return (out,) + vjp(_cot(out.shape))
    out, gp, gx = jax.jit(pass_)(params, list(inputs))
    ref = (np.asarray(out), [np.asarray(g) for g in gx],
           {n: np.asarray(g) for n, g in gp.items()})
    port = (tout, [a.grad for a in tin],
            {n: p.grad for n, p in t.named_parameters()})
    return ref, port


def _assert_equal(ref, port, tol):
    _close(port[0], ref[0], tol, "out")
    for g, w in zip(port[1], ref[1]):
        _close(g, w, tol, "input grad")
    assert set(port[2]) == set(ref[2])
    for n, w in ref[2].items():
        _close(port[2][n], w, tol, f"grad {n}")


FORMS = [(pre, act) for pre in (False, True) for act in ("relu", "gelu")]
FORM_IDS = [f"{'pre' if p else 'post'}_ln_{a}" for p, a in FORMS]


@pytest.mark.parametrize("pre,act", FORMS, ids=FORM_IDS)
def test_encoder_layer_plain_path(pre, act):
    """s 128: the reference's plain einsum-softmax in both packages."""
    j, t = _pair(lambda nn: nn.FusedTransformerEncoderLayer(
        32, 4, 64, dropout_rate=0.0, attn_dropout_rate=0.0, activation=act,
        normalize_before=pre))
    _assert_equal(*_both(j, t, [_x(2, 128, 32)]), TOL)


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_attention_with_mask_takes_the_plain_path(pre, monkeypatch):
    j, t = _pair(lambda nn: nn.FusedMultiHeadAttention(
        16, 2, dropout_rate=0.0, attn_dropout_rate=0.0,
        normalize_before=pre))
    calls = []
    monkeypatch.setattr(tinn, "flash_attention",
                        lambda *a, **k: calls.append(a))
    mask = np.where(np.tril(np.ones((256, 256), bool)), 0.0,
                    -1e4).astype(np.float32)[None, None]
    ref, port = _both(j, t, [_x(1, 256, 16)],
                      {"attn_mask": JT(mask)},
                      {"attn_mask": torch.tensor(mask)})
    _assert_equal(ref, port, TOL)
    assert not calls


@pytest.fixture
def reference_pallas(monkeypatch):
    """The reference's flash entry in interpret mode, its Pallas forward
    and backward counted."""
    old = jflags.get_flags(["flash_attention_interpret"])
    jflags.set_flags({"flash_attention_interpret": True})
    seen = {"fwd": 0, "bwd": 0}
    fwd, bwd = jfa._fa_pallas_forward, jfa._fa_pallas_backward

    def count(key, fn):
        def wrapped(*a, **k):
            seen[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(jfa, "_fa_pallas_forward", count("fwd", fwd))
    monkeypatch.setattr(jfa, "_fa_pallas_backward", count("bwd", bwd))
    yield seen
    jflags.set_flags(old)


@pytest.mark.parametrize("pre", [False, True], ids=["post_ln", "pre_ln"])
def test_attention_flash_path(pre, reference_pallas, monkeypatch):
    """s 512, d 64: the reference's Pallas kernels and the port's flash
    entry, forward and backward."""
    j, t = _pair(lambda nn: nn.FusedMultiHeadAttention(
        128, 2, dropout_rate=0.0, attn_dropout_rate=0.0,
        normalize_before=pre))
    calls = []
    real = tinn.flash_attention

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(tinn, "flash_attention", counted)
    _assert_equal(*_both(j, t, [_x(1, 512, 128)]), FLASH_TOL)
    assert calls == [torch.Size([1, 512, 2, 64])]
    assert reference_pallas["fwd"] >= 1 and reference_pallas["bwd"] >= 1


def test_flash_gate_equals_the_reference_rule():
    """The layer's gate (``incubate/nn/__init__.py:99``) and the flash
    entry's Pallas rule (``_blocks_for`` at the default 512 blocks)."""
    for s in (128, 256, 384, 512, 640, 768, 1024, 1536, 2048):
        for d in (8, 32, 64, 72, 96, 128, 192, 256):
            for masked in (False, True):
                for drop in (0.0, 0.1):
                    want = s >= 256 and s % 128 == 0 and not masked and \
                        drop == 0 and jfa._blocks_for(s, s, d) is not None
                    assert tinn.flash_gate(s, d, masked, drop) == want, \
                        (s, d, masked, drop)


@pytest.mark.parametrize("pre,act", FORMS, ids=FORM_IDS)
def test_feed_forward(pre, act):
    j, t = _pair(lambda nn: nn.FusedFeedForward(
        16, 48, dropout_rate=0.0, act_dropout_rate=0.0, activation=act,
        normalize_before=pre))
    _assert_equal(*_both(j, t, [_x(2, 7, 16)]), TOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear(transpose):
    j, t = _pair(lambda nn: nn.FusedLinear(12, 5,
                                           transpose_weight=transpose))
    assert list(t.weight.shape) == ([5, 12] if transpose else [12, 5])
    _assert_equal(*_both(j, t, [_x(3, 12)]), TOL)


def test_bias_dropout_residual_layer_norm():
    j, t = _pair(lambda nn: nn.FusedBiasDropoutResidualLayerNorm(
        16, dropout_rate=0.0))
    with torch.no_grad():
        t.linear_bias.uniform_(-1, 1)
    j.set_state_dict({k: v.numpy() for k, v in t.state_dict().items()})
    ref, port = _both(j, t, [_x(2, 5, 16), _x(2, 5, 16, seed=3)])
    _assert_equal(ref, port, TOL)
    assert port[2]["linear_bias"].abs().sum() > 0


def test_dropout_acts_on_the_branch_only():
    """Projection dropout near 1 leaves the pre-LN attention's output equal
    to its input (the residual); the FFN's activation dropout changes a
    training output and not an eval one; dropout draws from the port's
    generator (same seed, same output)."""
    T.seed(0)
    attn = tinn.FusedMultiHeadAttention(16, 4, dropout_rate=1.0 - 1e-7,
                                        attn_dropout_rate=0.0,
                                        normalize_before=True)
    x = torch.tensor(_x(2, 6, 16))
    assert torch.allclose(attn(x), x, atol=1e-4)
    ffn = tinn.FusedFeedForward(16, 32, dropout_rate=0.0,
                                act_dropout_rate=0.5)
    ffn.eval()
    y_eval = ffn(x)
    ffn.train()
    T.seed(4)
    y1 = ffn(x)
    T.seed(4)
    assert torch.equal(ffn(x), y1) and not torch.allclose(y1, y_eval)
    enc = tinn.FusedTransformerEncoderLayer(16, 4, 32, dropout_rate=0.1)
    assert enc.fused_attn.attn_dropout_rate == 0.1
    assert torch.isfinite(enc(x)).all()


def test_o2_encoder_dtypes_equal_the_reference():
    """``decorate`` at O2 and ``auto_cast(level="O2")``: the parameter and
    output dtypes of the fused encoder layer equal the reference's."""
    def run(pkg):
        nn, amp = (jinn, jamp) if pkg == "ref" else (tinn, tamp)
        P.seed(0)
        T.seed(0)
        layer = amp.decorate(nn.FusedTransformerEncoderLayer(
            16, 2, 32, dropout_rate=0.0, attn_dropout_rate=0.0), level="O2")
        x = _x(1, 8, 16)
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            if pkg == "ref":        # one jitted forward (eager compiles per op)
                params = {n: p._data for n, p in layer.named_parameters()}
                out = jax.jit(lambda p, a: functional_call(
                    layer, p, JT(a)))(params, x)
            else:
                out = layer(torch.tensor(x))
        name = lambda v: str(v.dtype).split(".")[-1] if torch.is_tensor(v) \
            else np.dtype(v.dtype).name  # noqa: E731
        return [(n, name(p)) for n, p in layer.named_parameters()] + \
            [("out", name(out))]
    assert run("port") == run("ref")
