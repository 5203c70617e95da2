"""The port's optimizers, lr schedules, gradient clipping, amp, autograd
and ops against the JAX package, on the CPU (``set_device("cpu")``).

- Optimizers: the same parameters and the same gradients (numpy, a fresh
  draw each step) go through both packages for three steps, with weight
  decay, ``ClipGradByGlobalNorm``, parameter groups and an lr schedule;
  the parameters and every accumulator (``state_dict``) are held in fp32
  within OPT_TOL, and optimizer state crosses between the packages both
  ways.  Master weights under ``amp.decorate(level="O2")`` are held on
  bf16 parameters to one bf16 ulp.
- amp: the dtype of every intermediate of a conv -> bn -> relu -> flatten
  -> linear -> cross-entropy net under ``auto_cast`` O1 and O2 equals the
  reference's exactly; ``GradScaler``'s state machine (a normal step, a
  skipped step on inf, growth) equals the reference's.
- A ResNet BottleneckBlock net (stem, one block with downsample, pool, fc)
  built from both packages' classes: one train step's loss, every
  gradient, the parameters after ``Momentum.step()`` and the BatchNorm
  statistics, fp32 within STEP_TOL of the largest value compared.
"""

import contextlib
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.utils import functional_call
from paddle_tpu.vision.models import resnet as jresnet
import paddle_tpu_torch as T
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import autograd as tautograd
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.vision.models import resnet as tresnet

torch.set_num_threads(2)

OPT_TOL = 2e-6
STEP_TOL = 2e-5


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
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _np(t):
    """A float32 numpy copy (never a view of a tensor that later moves)."""
    return t.detach().float().numpy().copy() if torch.is_tensor(t) else \
        np.array(t._data if hasattr(t, "_data") else t, np.float32)


# ------------------------------------------------------------ optimizers ---

SHAPES = {"w0": (4, 3), "b0": (3,), "w1": (2, 2)}


def _params(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    vals = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    jp = [JParam(vals[n].astype(dtype), name=n) for n in SHAPES]
    tp = [T.Parameter(torch.tensor(vals[n]).to(
        T.dtypes.convert_dtype(np.dtype(dtype).name)), name=n)
        for n in SHAPES]
    return jp, tp


def _grads(step, scale=3.0):
    rng = np.random.default_rng(100 + step)
    return [rng.standard_normal(s).astype(np.float32) * scale
            for s in SHAPES.values()]


OPTIMIZERS = {
    "sgd": lambda o, lr, ps, clip: o.SGD(lr, parameters=ps,
                                         weight_decay=0.01, grad_clip=clip),
    "momentum": lambda o, lr, ps, clip: o.Momentum(
        lr, 0.9, parameters=ps, weight_decay=1e-3, grad_clip=clip),
    "momentum_nesterov": lambda o, lr, ps, clip: o.Momentum(
        lr, 0.9, parameters=ps, use_nesterov=True, weight_decay=1e-3,
        grad_clip=clip),
    "adam": lambda o, lr, ps, clip: o.Adam(lr, parameters=ps,
                                           weight_decay=0.01, grad_clip=clip),
    "adamw": lambda o, lr, ps, clip: o.AdamW(
        lr, parameters=ps, weight_decay=0.05, grad_clip=clip,
        apply_decay_param_fun=lambda n: not n.startswith("b"),
        lr_ratio=lambda p: 0.5 if p.name == "w1" else 1.0),
}


def _make(case, pkg, params):
    o, nn = (jopt, jnn) if pkg == "ref" else (topt, tnn)
    sched = o.lr.StepDecay(0.1 if "adam" not in case else 0.01,
                           step_size=2, gamma=0.5)
    groups = [{"params": params[:2]}, {"params": params[2:],
                                       "learning_rate": 0.3}]
    return OPTIMIZERS[case](o, sched, groups, nn.ClipGradByGlobalNorm(1.0))


def _step(opt, params, grads, pkg):
    for p, g in zip(params, grads):
        p.grad = JT(g) if pkg == "ref" else torch.tensor(g).to(p.dtype)
    opt.step()
    opt.clear_grad()
    opt._learning_rate.step()


def _assert_same_state(jo, to, jp, tp, tol=OPT_TOL):
    for a, b in zip(jp, tp):
        _close(b, _np(a), tol, a.name)
    js, ts = jo.state_dict(), to.state_dict()
    assert set(js) == set(ts)
    for k in js:
        if k == "LR_Scheduler":
            assert ts[k] == js[k]
        elif k == "@step":
            assert ts[k] == js[k]
        else:
            _close(ts[k], _np(js[k]), tol, k)


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizer_steps_and_state_crossing(case):
    jp, tp = _params()
    jo, to = _make(case, "ref", jp), _make(case, "port", tp)
    for step in range(3):
        g = _grads(step)
        _step(jo, jp, g, "ref")
        _step(to, tp, g, "port")
        _assert_same_state(jo, to, jp, tp)
    names = {"sgd": set(), "adam": {"moment1", "moment2"},
             "adamw": {"moment1", "moment2"}}.get(case, {"velocity"})
    assert {k.rsplit("_", 1)[0] for k in to.state_dict()
            if k not in ("@step", "LR_Scheduler")} == names
    # the port's state into a fresh reference optimizer, and the
    # reference's into a fresh port optimizer: one more step each
    jp2 = [JParam(_np(p), name=p.name) for p in tp]
    _, tp2 = _params()
    with torch.no_grad():
        for a, b in zip(tp2, jp):
            a.copy_(torch.tensor(_np(b)))
    jo2, to2 = _make(case, "ref", jp2), _make(case, "port", tp2)
    jo2.set_state_dict({k: (_np(v) if torch.is_tensor(v) else v)
                        for k, v in to.state_dict().items()})
    to2.set_state_dict({k: (np.asarray(v._data) if hasattr(v, "_data")
                            else v) for k, v in jo.state_dict().items()})
    g = _grads(3)
    for opt, ps, pkg in ((jo, jp, "ref"), (to, tp, "port"),
                         (jo2, jp2, "ref"), (to2, tp2, "port")):
        _step(opt, ps, g, pkg)
    _assert_same_state(jo, to2, jp, tp2)
    _assert_same_state(jo2, to, jp2, tp)


def test_master_weights_under_o2():
    """``decorate`` at O2 makes the optimizer keep float32 masters: bf16
    parameters move by float32 updates rounded back, as the reference's
    do."""
    jp, tp = _params(dtype=np.float32)
    P.seed(0)
    jo = jopt.AdamW(0.05, parameters=jp, weight_decay=0.01)
    to = topt.AdamW(0.05, parameters=tp, weight_decay=0.01)
    jlin, tlin = jnn.Linear(2, 2), tnn.Linear(2, 2)
    for p in jp:
        p._data = p._data.astype(P.dtypes.convert_dtype("bfloat16"))
    with torch.no_grad():
        for p in tp:
            p.data = p.data.to(torch.bfloat16)
    jamp.decorate(jlin, jo, level="O2")
    tamp.decorate(tlin, to, level="O2")
    assert to._use_master_weights and tlin.weight.dtype == torch.bfloat16
    for step in range(3):
        g = [a.astype(P.dtypes.convert_dtype("bfloat16")) for a in
             _grads(step)]
        for p, a in zip(jp, g):
            p.grad = JT(a)
        for p, a in zip(tp, g):
            p.grad = torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
        jo.step()
        to.step()
    for a, b in zip(jp, tp):
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(b), _np(a), rtol=2 ** -7, atol=1e-6)
        _close(to._master_weights[id(b)], np.asarray(
            jo._master_weights[id(a)], np.float32), OPT_TOL)


def test_gradient_clipping():
    rng = np.random.default_rng(4)
    gs = [rng.standard_normal(s).astype(np.float32) * 2
          for s in ((3, 4), (5,), (2, 2))]
    jp, tp = [], []
    for i, g in enumerate(gs):
        a, b = JParam(np.zeros_like(g)), T.Parameter(torch.zeros(g.shape))
        a.need_clip = b.need_clip = i != 2
        jp.append(a)
        tp.append(b)
    for clip in (lambda nn: nn.ClipGradByValue(1.0, -0.5),
                 lambda nn: nn.ClipGradByNorm(1.0),
                 lambda nn: nn.ClipGradByGlobalNorm(0.7)):
        want = clip(jnn)([(p, JT(g)) for p, g in zip(jp, gs)])
        got = clip(tnn)([(p, torch.tensor(g)) for p, g in zip(tp, gs)])
        for (_, w), (_, g) in zip(want, got):
            _close(g, _np(w), OPT_TOL)
    for norm in (2.0, float("inf")):
        for p, g in zip(jp, gs):
            p.grad = JT(g)
        for p, g in zip(tp, gs):
            p.grad = torch.tensor(g)
        jt = jnn.clip_grad_norm_(jp, 1.5, norm)
        tt = tnn.clip_grad_norm_(tp, 1.5, norm)
        _close(tt, _np(jt), OPT_TOL)
        for a, b in zip(jp, tp):
            _close(b.grad, _np(a.grad), OPT_TOL)


SCHEDULES = {
    "Noam": lambda lr: lr.NoamDecay(64, 4, 2.0),
    "Piecewise": lambda lr: lr.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
    "NaturalExp": lambda lr: lr.NaturalExpDecay(0.1, 0.3),
    "Exponential": lambda lr: lr.ExponentialDecay(0.1, 0.9),
    "InverseTime": lambda lr: lr.InverseTimeDecay(0.1, 0.5),
    "Polynomial": lambda lr: lr.PolynomialDecay(0.1, 5, cycle=True),
    "LinearWarmup": lambda lr: lr.LinearWarmup(
        lr.CosineAnnealingDecay(0.1, 8), 3, 0.0, 0.1),
    "CosineAnnealing": lambda lr: lr.CosineAnnealingDecay(0.1, 8, 0.01),
    "MultiStep": lambda lr: lr.MultiStepDecay(0.1, [2, 5]),
    "Step": lambda lr: lr.StepDecay(0.1, 3),
    "Lambda": lambda lr: lr.LambdaDecay(0.1, lambda e: 0.9 ** e),
    "Multiplicative": lambda lr: lr.MultiplicativeDecay(0.1,
                                                        lambda e: 0.95),
    "OneCycle": lambda lr: lr.OneCycleLR(0.1, 12),
    "Cyclic": lambda lr: lr.CyclicLR(0.01, 0.1, 3, mode="triangular2"),
    "CosineWarmRestarts": lambda lr: lr.CosineAnnealingWarmRestarts(
        0.1, 3, 2),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_lr_schedules(case):
    js, ts = SCHEDULES[case](jopt.lr), SCHEDULES[case](topt.lr)
    got, want = [], []
    for _ in range(12):
        want.append(js())
        got.append(ts())
        js.step()
        ts.step()
    assert got == want
    assert ts.state_dict() == js.state_dict()


def test_reduce_on_plateau():
    js, ts = jopt.lr.ReduceOnPlateau(0.1, patience=1), \
        topt.lr.ReduceOnPlateau(0.1, patience=1)
    for m in (1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6, 0.7):
        js.step(m)
        ts.step(m)
        assert ts() == js()


# ------------------------------------------------------------------- amp ---

def _amp_net(nn):
    return nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4), nn.ReLU(),
                         nn.Flatten(), nn.Linear(4 * 4 * 4, 5))


def _dtype_name(x):
    return str(x.dtype).split(".")[-1] if torch.is_tensor(x) else \
        np.dtype(x.dtype).name


def _amp_trace(pkg, level, **kw):
    """Output dtypes of each layer and of the loss under auto_cast at
    ``level`` (O2 after decorate), and the parameter dtypes."""
    nn, amp = (jnn, jamp) if pkg == "ref" else (tnn, tamp)
    P.seed(0)
    T.seed(0)
    net = _amp_net(nn)
    if level == "O2":
        net = amp.decorate(net, level="O2")
    seen = []
    for layer in net:
        layer.register_forward_post_hook(
            lambda l, i, o: seen.append((type(l).__name__, _dtype_name(o))))
    x = np.random.default_rng(0).standard_normal((2, 3, 6, 6)).astype(
        np.float32)
    lab = np.array([1, 3])
    with amp.auto_cast(level=level, dtype="bfloat16", **kw):
        if pkg == "ref":
            loss = nn.functional.cross_entropy(net(JT(x)), JT(lab))
        else:
            loss = nn.functional.cross_entropy(net(torch.tensor(x)),
                                               torch.tensor(lab))
    params = [(n, _dtype_name(p)) for n, p in net.named_parameters()]
    return seen + [("loss", _dtype_name(loss))], params


@pytest.mark.parametrize("level,kw", [
    ("O1", {}), ("O2", {}), ("O1", {"custom_black_list": {"conv2d"}}),
    ("O1", {"custom_white_list": {"relu"}})],
    ids=["O1", "O2", "O1_black_conv", "O1_white_relu"])
def test_auto_cast_dtypes_equal_the_reference(level, kw):
    assert _amp_trace("port", level, **kw) == _amp_trace("ref", level, **kw)


def test_amp_lists_and_state():
    assert tamp.white_list() == jamp.white_list()
    assert tamp.black_list() == jamp.black_list()
    assert not tamp.is_auto_cast_enabled()
    with tamp.auto_cast(level="O2", dtype="float16"):
        assert tamp.is_auto_cast_enabled() and \
            tamp.get_amp_dtype() == "float16"
        with tamp.auto_cast(enable=False):
            assert not tamp.is_auto_cast_enabled()
    with pytest.raises(ValueError):
        tamp.auto_cast(level="O3")


def test_grad_scaler_state_machine():
    """A normal step (grads unscaled, then stepped), a step with an inf
    gradient (skipped, scale halved), and growth after two good steps."""
    jp, tp = _params()
    jo = jopt.SGD(0.1, parameters=jp)
    to = topt.SGD(0.1, parameters=tp)
    js = jamp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
    ts = tamp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
    for step, bad in enumerate((False, True, False, False)):
        scale = js.get_loss_scaling()
        assert ts.get_loss_scaling() == scale
        g = [a * scale for a in _grads(step)]
        if bad:
            g[1][0] = np.inf
        for p, a in zip(jp, g):
            p.grad = JT(a)
        for p, a in zip(tp, g):
            p.grad = torch.tensor(a)
        js.step(jo)
        ts.step(to)
        jo.clear_grad()
        to.clear_grad()
        assert ts.state_dict() == js.state_dict()
        for a, b in zip(jp, tp):
            _close(b, _np(a), OPT_TOL, f"step {step}")
    assert ts.get_loss_scaling() == 1024.0
    loss = torch.tensor(2.0)
    assert float(ts.scale(loss)) == 2048.0


def _fp16_scaled_grads(scale):
    """fp16 gradients (scaled by ``scale``) of true values near 2^-20 and
    2^-26, both under fp16's normal range (2^-14) once unscaled, the second
    under its smallest subnormal (2^-24)."""
    rng = np.random.default_rng(11)
    true = [rng.uniform(0.5, 1.0, s) * 2.0 ** e * rng.choice([-1, 1], s)
            for s, e in zip(SHAPES.values(), (-20, -26, -20))]
    return [(t * scale).astype(np.float16) for t in true]


def test_grad_scaler_unscales_fp16_into_float32():
    """fp16 gradients under scale 2^16: the port's unscaled values (what
    its optimizer steps on) equal the reference's ``GradScaler.unscale_``,
    a float32 gradient each, bit for bit; none is flushed to 0, and the
    not-finite check reads the float32 values."""
    scale = 2.0 ** 16
    jp, tp = _params(dtype=np.float16)
    jo = jopt.SGD(0.1, parameters=jp)
    to = topt.SGD(0.1, parameters=tp)
    js = jamp.GradScaler(init_loss_scaling=scale)
    ts = tamp.GradScaler(init_loss_scaling=scale)
    g = _fp16_scaled_grads(scale)
    for p, a in zip(jp, g):
        p.grad = JT(a)
    for p, a in zip(tp, g):
        p.grad = torch.tensor(a)
    js.unscale_(jo)
    ts.unscale_(to)
    assert ts._found_inf is js._found_inf is False
    got = dict(to._collect_params_grads())
    for a, b in zip(jp, tp):
        want = np.asarray(a.grad._data)
        assert want.dtype == np.float32 and got[b].dtype == torch.float32
        np.testing.assert_array_equal(got[b].numpy(), want)
        assert (want != 0).all()
    # an fp16 gradient whose unscaled value is not finite: found in float32
    for p in tp:
        p.grad = torch.tensor(g[0] if p.shape == g[0].shape else
                              np.zeros(p.shape, np.float16))
    tp[0].grad[0, 0] = float("inf")
    ts._unscaled = False
    ts.unscale_(to)
    assert ts._found_inf is True


def _o2_fp16_momentum_step(edit=None):
    """One ``GradScaler`` step of ``Momentum`` under ``decorate(level="O2",
    dtype="float16")`` in both packages, on fp16 gradients of true values
    near 2^-20 and 2^-26.  ``edit(jp, tp)``, if given, runs between
    ``unscale_`` and the step.  Returns (jp, tp, jo, to, js, ts)."""
    scale = 2.0 ** 16
    jp, tp = _params(dtype=np.float32)
    for p in jp:
        p._data = p._data * 1e-3
    with torch.no_grad():
        for p in tp:
            p.mul_(1e-3)
    jo = jopt.Momentum(0.1, 0.9, parameters=jp, weight_decay=1e-3)
    to = topt.Momentum(0.1, 0.9, parameters=tp, weight_decay=1e-3)
    for p in jp:
        p._data = p._data.astype(np.float16)
    with torch.no_grad():
        for p in tp:
            p.data = p.data.half()
    jamp.decorate(jnn.Linear(2, 2), jo, level="O2", dtype="float16")
    with _cpu():
        tamp.decorate(tnn.Linear(2, 2), to, level="O2", dtype="float16")
    js = jamp.GradScaler(init_loss_scaling=scale)
    ts = tamp.GradScaler(init_loss_scaling=scale)
    g = _fp16_scaled_grads(scale)
    for p, a in zip(jp, g):
        p.grad = JT(a)
    for p, a in zip(tp, g):
        p.grad = torch.tensor(a)
    if edit is not None:
        js.unscale_(jo)
        ts.unscale_(to)
        edit(jp, tp)
    js.step(jo)
    ts.step(to)
    jo.clear_grad()
    to.clear_grad()
    return jp, tp, jo, to, js, ts


def _check_o2_fp16_step(jp, tp, jo, to, js, ts):
    """fp16 parameters bit for bit; float32 masters and velocities within
    OPT_TOL."""
    assert ts.state_dict() == js.state_dict()
    for a, b in zip(jp, tp):
        assert b.dtype == torch.float16
        np.testing.assert_array_equal(b.detach().numpy(),
                                      np.asarray(a._data))
        _close(to._master_weights[id(b)], np.asarray(
            jo._master_weights[id(a)], np.float32), OPT_TOL, a.name)
    jstate, tstate = jo.state_dict(), to.state_dict()
    for i, a in enumerate(jp):
        want = np.asarray(jstate[f"velocity_{i}"]._data
                          if hasattr(jstate[f"velocity_{i}"], "_data")
                          else jstate[f"velocity_{i}"], np.float32)
        got = tstate[f"velocity_{i}"]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=OPT_TOL,
                                   atol=0)


def test_o2_fp16_momentum_step_with_grad_scaler():
    """``decorate(level="O2", dtype="float16")`` and one ``GradScaler``
    step of ``Momentum`` on fp16 gradients of true values near 2^-20 and
    2^-26: the float32 master weights, the velocity and the fp16
    parameters equal the reference's step (fp32 within OPT_TOL; fp16
    bit for bit)."""
    _check_o2_fp16_step(*_o2_fp16_momentum_step())


def _clip_both(jp, tp):
    """``clip_grad_norm_`` to 1e-6, under the unscaled gradients' norm."""
    jt = jnn.clip_grad_norm_(jp, 1e-6)
    tt = tnn.clip_grad_norm_(tp, 1e-6)
    assert float(tt) > 1e-6
    np.testing.assert_allclose(float(tt), float(np.asarray(jt._data)),
                               rtol=OPT_TOL)


def _zero_both(jp, tp):
    for p in jp:
        p.grad = JT(np.zeros(p.shape, np.float32))
    for p in tp:
        p.grad.zero_()


@pytest.mark.parametrize("edit", [_clip_both, _zero_both],
                         ids=["clip_grad_norm_", "zero_"])
def test_o2_fp16_grad_edit_between_unscale_and_step(edit):
    """``unscale_``, then an edit of the gradients, then the step, as in
    the unscale-then-clip idiom: the step takes the edited gradients.
    ``clip_grad_norm_`` reads and scales a half-precision gradient's
    float32 value, as the reference's does on its float32 ``.grad``; an
    in-place edit of ``.grad`` itself is not thrown away.  The parameters,
    masters and velocities equal the reference's step by
    ``_check_o2_fp16_step``."""
    _check_o2_fp16_step(*_o2_fp16_momentum_step(edit))


# ------------------------------------------------- ResNet train step ---

def _bottleneck_net(nn, resnet):
    down = nn.Sequential(nn.Conv2D(8, 16, 1, stride=2, bias_attr=False),
                         nn.BatchNorm2D(16))
    return nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1, bias_attr=False), nn.BatchNorm2D(8),
        nn.ReLU(), resnet.BottleneckBlock(8, 4, stride=2, downsample=down),
        nn.AdaptiveAvgPool2D(1), nn.Flatten(), nn.Linear(16, 5))


def _ref_loss_and_grads(j, x, lab):
    """The reference's loss, its gradients (set as the parameters'
    ``.grad``) and the BatchNorm statistics it moves, from one jitted
    ``value_and_grad`` of ``functional_call`` (the buffers the trace moves
    come out as its aux and are set afterwards)."""
    params = {n: p._data for n, p in j.named_parameters()}
    bufs = dict(j.named_buffers())
    saved = {n: b._data for n, b in bufs.items()}

    def loss_fn(params):
        out = functional_call(j, params, JT(x))
        loss = jnn.functional.cross_entropy(JT(out), JT(lab))._data
        return loss, {n: b._data for n, b in bufs.items()}
    try:
        (loss, moved), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    finally:
        for n, b in bufs.items():
            b._data = saved[n]
    for n, b in bufs.items():
        b._data = moved[n]
    for n, p in j.named_parameters():
        p.grad = JT(grads[n])
    return np.asarray(loss)


def test_bottleneck_block_train_step():
    """The reference's step is its jitted arithmetic, whose BatchNorm
    gradient flows through the batch statistics (its eager path takes
    them as constants: ROADMAP.md, Queue 3); the port's gradient does the
    same."""
    P.seed(0)
    j = _bottleneck_net(jnn, jresnet)
    t = _bottleneck_net(tnn, tresnet)
    assert not any(t.set_state_dict({k: np.asarray(v._data) for k, v in
                                     j.state_dict().items()}))
    jo = jopt.Momentum(0.1, 0.9, parameters=j.parameters(),
                       weight_decay=1e-4)
    to = topt.Momentum(0.1, 0.9, parameters=t.parameters(),
                       weight_decay=1e-4)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
    lab = rng.integers(0, 5, (4,))
    jl = _ref_loss_and_grads(j, x, lab)
    tl = tnn.functional.cross_entropy(t(torch.tensor(x)), torch.tensor(lab))
    tl.backward()
    _close(tl, jl, STEP_TOL, "loss")
    jg = {n: _np(p.grad) for n, p in j.named_parameters()}
    for n, p in t.named_parameters():
        _close(p.grad, jg[n], STEP_TOL, f"grad {n}")
    jo.step()
    to.step()
    js = j.state_dict()
    for k, v in t.state_dict().items():
        _close(v, _np(js[k]), STEP_TOL, k)
    _close(to.state_dict()["velocity_0"],
           _np(jo.state_dict()["velocity_0"]), STEP_TOL, "velocity")


# ---------------------------------------------- autograd, ops, dtypes ---

def test_autograd_api():
    class Tanh(tautograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale=1.0):
            y = torch.tanh(x) * scale
            ctx.save_for_backward(y)
            ctx.scale = scale
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return dy * (1 - (y / 2) ** 2) * 2

    with pytest.raises(RuntimeError):
        Tanh()
    x = torch.linspace(-2, 2, 7, requires_grad=True)
    y = Tanh.apply(x, scale=2.0)
    (gx,) = tautograd.grad(y.sum(), x, retain_graph=True)
    assert torch.allclose(gx, 2 * (1 - torch.tanh(x) ** 2))
    tautograd.backward(y.sum())
    assert torch.allclose(x.grad, gx)
    with tautograd.no_grad():
        assert not (x * 2).requires_grad
    jx = JT(np.linspace(-2, 2, 7, dtype=np.float32), stop_gradient=False)
    (jg,) = P.autograd.grad((P.tanh(jx) * 2).sum(), jx)
    _close(gx, _np(jg), 1e-6)


def test_ops_match_the_reference():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    b = np.ones((4, 5), np.float32) * 0.5
    ja, ta = JT(a), torch.tensor(a)
    pairs = [
        (P.flatten(ja, 1), T.flatten(ta, 1)),
        (P.flatten(ja), T.flatten(ta)),
        (P.reshape(ja, [4, -1]), T.reshape(ta, [4, -1])),
        (P.concat([ja, ja], axis=1), T.concat([ta, ta], axis=1)),
        (P.matmul(ja, JT(b)), T.matmul(ta, torch.tensor(b))),
        (P.matmul(ja, JT(b.T), transpose_y=True),
         T.matmul(ta, torch.tensor(b.T), transpose_y=True)),
        (P.add(ja, ja), T.add(ta, ta)),
        (P.zeros([2, 3]), T.zeros([2, 3])),
        (P.ones([2], dtype="int32"), T.ones([2], dtype="int32")),
        (P.full([2, 2], 1.5), T.full([2, 2], 1.5)),
        (P.full([2], 3), T.full([2], 3)),
        (P.arange(5), T.arange(5)),
        (P.arange(0, 1, 0.25), T.arange(0, 1, 0.25)),
    ]
    for i, (want, got) in enumerate(pairs):
        assert _dtype_name(got) == want.dtype.name, i
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=i)


def test_seed_rng_state_and_dtypes():
    T.seed(11)
    a = T.randn([4])
    state = T.get_rng_state()
    b = T.randn([4])
    T.set_rng_state(state)
    assert torch.equal(T.randn([4]), b)
    T.seed(11)
    assert torch.equal(T.randn([4]), a)
    r = T.randint(0, 5, [100])
    assert r.dtype == torch.int64 and 0 <= int(r.min()) and int(r.max()) < 5
    for name in ("float32", "bfloat16", "float16", "int64", "bool", "fp32",
                 "bf16", "uint8"):
        assert str(T.dtypes.convert_dtype(name)).split(".")[-1] == \
            P.dtypes.convert_dtype(name).name
    assert T.dtypes.convert_dtype(np.float32) is torch.float32
    assert T.get_default_dtype() is torch.float32
    assert math.isclose(T.randn([4000]).std().item(), 1.0, abs_tol=0.1)
