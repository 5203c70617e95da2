"""The port's other optimizers, the regularizers, ``LookAhead`` and
``ModelAverage`` against the JAX package, on the CPU (``set_device("cpu")``).

- Each of the eleven optimizers (and its options: RMSProp centered and with
  momentum, Adagrad's initial accumulator, Lamb's exclusion, Lars, ASGD's
  window) takes 8 steps on the same parameters and the same gradients (a
  fresh numpy draw each step) in both packages: parameters and every
  accumulator within STEP_TOL of the largest entry compared (RAdam crosses
  its rectification at step 6); then ``state_dict`` crosses both ways and
  one more step agrees.
- LBFGS (Armijo and strong Wolfe) on a least-squares problem: the loss
  after each ``step(closure)`` within LBFGS_TOL relative and the same
  number of closure calls.
- ``LookAhead`` and ``ModelAverage``: parameters, their state and its
  crossing; ``apply`` / ``restore`` and the window rule.
- ``L1Decay`` / ``L2Decay`` on a parameter replace the optimizer's decay;
  a regularizer passed as ``weight_decay=`` raises ``TypeError`` at
  ``step()`` in both packages.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.incubate import optimizer as jinc
import paddle_tpu_torch as T
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.incubate import optimizer as tinc
from test_torch_optimizer_amp import _close, _cpu, _grads, _np, _params

torch.set_num_threads(2)

STEP_TOL = 1e-5
LBFGS_TOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    with _cpu():
        yield


def _clip(o):
    return (jnn if o is jopt else tnn).ClipGradByGlobalNorm(2.0)


OPTIMIZERS = {
    "adamax": lambda o, ps: o.Adamax(0.05, parameters=ps, weight_decay=0.01,
                                     grad_clip=_clip(o)),
    "rmsprop": lambda o, ps: o.RMSProp(0.01, parameters=ps,
                                       weight_decay=0.01),
    "rmsprop_centered": lambda o, ps: o.RMSProp(
        0.01, rho=0.9, momentum=0.5, centered=True, parameters=ps),
    "adagrad": lambda o, ps: o.Adagrad(0.1, parameters=ps,
                                       initial_accumulator_value=0.1,
                                       weight_decay=0.01),
    "adadelta": lambda o, ps: o.Adadelta(1.0, parameters=ps, rho=0.9,
                                         weight_decay=0.01),
    "nadam": lambda o, ps: o.NAdam(0.02, parameters=ps, weight_decay=0.01,
                                   grad_clip=_clip(o)),
    "radam": lambda o, ps: o.RAdam(0.05, parameters=ps, weight_decay=0.01),
    "asgd": lambda o, ps: o.ASGD(0.05, batch_num=3, parameters=ps,
                                 weight_decay=0.01),
    "rprop": lambda o, ps: o.Rprop(0.01, parameters=ps, etas=(0.5, 1.2),
                                   learning_rate_range=(1e-4, 0.05)),
    "lamb": lambda o, ps: o.Lamb(0.02, lamb_weight_decay=0.01, parameters=ps,
                                 grad_clip=_clip(o)),
    "lamb_exclude": lambda o, ps: o.Lamb(
        0.02, lamb_weight_decay=0.05, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: p.name.startswith("b")),
    "lars": lambda o, ps: o.Lars(0.5, momentum=0.9, lars_coeff=0.01,
                                 lars_weight_decay=0.001, parameters=ps),
    "lars_alias": lambda o, ps: o.LarsMomentumOptimizer(
        0.5, lars_weight_decay=0.0, parameters=ps,
        exclude_from_weight_decay=["b0"]),
}

ACCUMULATORS = {
    "adamax": {"moment", "inf_norm"}, "rmsprop": {"mean_square", "velocity"},
    "rmsprop_centered": {"mean_square", "mean_grad", "velocity"},
    "adagrad": {"moment"},
    "adadelta": {"avg_squared_grad", "avg_squared_update"},
    "nadam": {"moment1", "moment2", "mu_product"},
    "radam": {"moment1", "moment2"}, "asgd": {"d", "ys"},
    "rprop": {"prev_grad", "step_size"}, "lamb": {"moment1", "moment2"},
    "lamb_exclude": {"moment1", "moment2"}, "lars": {"velocity"},
    "lars_alias": {"velocity"},
}


def _set_grads(params, grads, pkg):
    for p, g in zip(params, grads):
        p.grad = JT(g) if pkg == "ref" else torch.tensor(g)


def _step(opt, params, grads, pkg):
    _set_grads(params, grads, pkg)
    opt.step()
    opt.clear_grad()


def _same(jo, to, jp, tp, tol=STEP_TOL):
    for a, b in zip(jp, tp):
        _close(b, _np(a), tol, a.name)
    js, ts = jo.state_dict(), to.state_dict()
    assert set(js) == set(ts)
    for k in js:
        if k == "@step" or k.startswith("@"):
            assert ts[k] == js[k], k
        else:
            _close(ts[k], _np(js[k]), tol, k)


def _to_ref(state):
    return {k: (_np(v) if torch.is_tensor(v) else v)
            for k, v in state.items()}


def _to_port(state):
    return {k: (np.asarray(v._data) if hasattr(v, "_data") else v)
            for k, v in state.items()}


def _copies(tp):
    """A reference and a port copy of the port's parameters ``tp``."""
    jp2 = [JParam(_np(p), name=p.name) for p in tp]
    _, tp2 = _params()
    with torch.no_grad():
        for a, b in zip(tp2, tp):
            a.copy_(b)
    return jp2, tp2


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_eight_steps_and_state_crossing(case):
    jp, tp = _params()
    jo, to = OPTIMIZERS[case](jopt, jp), OPTIMIZERS[case](topt, tp)
    for step in range(8):
        g = _grads(step)
        _step(jo, jp, g, "ref")
        _step(to, tp, g, "port")
        _same(jo, to, jp, tp)
    assert {k.rsplit("_", 1)[0] for k in to.state_dict()
            if k != "@step"} == ACCUMULATORS[case]
    # the port's state into a fresh reference optimizer, the reference's
    # into a fresh port optimizer: one more step each
    jp2, tp2 = _copies(tp)
    jo2, to2 = OPTIMIZERS[case](jopt, jp2), OPTIMIZERS[case](topt, tp2)
    jo2.set_state_dict(_to_ref(to.state_dict()))
    to2.set_state_dict(_to_port(jo.state_dict()))
    g = _grads(8)
    for opt, ps, pkg in ((jo, jp, "ref"), (to, tp, "port"),
                         (jo2, jp2, "ref"), (to2, tp2, "port")):
        _step(opt, ps, g, pkg)
    _same(jo, to2, jp, tp2)
    _same(jo2, to, jp2, tp)


def test_radam_crosses_its_rectification_at_step_six():
    """beta2 0.999: rho_t > 5 first holds at step 6, where the update
    changes form; each step's move against the reference's."""
    b2, rho_inf = 0.999, 2 / (1 - 0.999) - 1
    rho = [rho_inf - 2 * t * b2 ** t / (1 - b2 ** t) for t in range(1, 9)]
    assert [r > 5 for r in rho].index(True) == 5
    jp, tp = _params()
    jo, to = jopt.RAdam(0.05, parameters=jp), topt.RAdam(0.05, parameters=tp)
    for step in range(8):
        before = [_np(p) for p in tp]
        g = _grads(step)
        _step(jo, jp, g, "ref")
        _step(to, tp, g, "port")
        for a, b, w in zip(jp, tp, before):
            _close(_np(b) - w, _np(a) - w, STEP_TOL, f"step {step + 1}")


def _lsq(seed=11):
    """A least-squares problem whose columns span 4x in scale, so the three
    ``step`` calls of 4 iterations each stay well above the loss's float32
    floor (where the line search's accept decisions become rounding
    noise)."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((32, 8)) *
             np.logspace(0, 0.6, 8)).astype(np.float32),
            rng.standard_normal((32, 3)).astype(np.float32),
            (rng.standard_normal((8, 3)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_losses_and_closure_calls(line_search):
    x, y, w0 = _lsq()
    runs = {}
    for pkg, mk, tens, par in (
            ("ref", jopt, P.to_tensor, lambda a: JParam(a.copy(), name="w")),
            ("port", topt, T.to_tensor,
             lambda a: T.Parameter(torch.tensor(a), name="w"))):
        w = par(w0)
        xt, yt = tens(x), tens(y)
        calls = [0]
        opt = mk.LBFGS(0.2, max_iter=4, max_eval=10, history_size=4,
                       line_search_fn=line_search, parameters=[w],
                       weight_decay=0.01)

        def closure(w=w, xt=xt, yt=yt, calls=calls):
            calls[0] += 1
            loss = ((xt.matmul(w) - yt) ** 2).mean()
            loss.backward()
            return loss
        losses = [float(opt.step(closure)) for _ in range(3)]
        runs[pkg] = (losses, calls[0], _np(w))
    (jl, jc, jw), (tl, tc, tw) = runs["ref"], runs["port"]
    assert tc == jc
    np.testing.assert_allclose(tl, jl, rtol=LBFGS_TOL)
    assert tl[-1] < tl[0]
    _close(tw, jw, LBFGS_TOL)


def test_lookahead():
    jp, tp = _params()
    jin = jopt.Adam(0.05, parameters=jp)
    tin = topt.Adam(0.05, parameters=tp)
    jo = jinc.LookAhead(jin, alpha=0.4, k=3)
    to = tinc.LookAhead(tin, alpha=0.4, k=3)
    for step in range(7):
        g = _grads(step)
        _step(jo, jp, g, "ref")
        _step(to, tp, g, "port")
        _same(jo, to, jp, tp)
    assert to.state_dict()["@lookahead_k_count"] == 7
    assert {k for k in to.state_dict() if k.startswith("lookahead_slow_")} \
        == {f"lookahead_slow_{i}" for i in range(3)}
    jp2, tp2 = _copies(tp)
    jo2 = jinc.LookAhead(jopt.Adam(0.05, parameters=jp2), alpha=0.4, k=3)
    to2 = tinc.LookAhead(topt.Adam(0.05, parameters=tp2), alpha=0.4, k=3)
    jo2.set_state_dict(_to_ref(to.state_dict()))
    to2.set_state_dict(_to_port(jo.state_dict()))
    for step in (7, 8):
        g = _grads(step)
        for opt, ps, pkg in ((jo, jp, "ref"), (to, tp, "port"),
                             (jo2, jp2, "ref"), (to2, tp2, "port")):
            _step(opt, ps, g, pkg)
    _same(jo, to2, jp, tp2)
    _same(jo2, to, jp2, tp)


def test_model_average_apply_restore_and_window():
    jp, tp = _params()
    js, ts = jopt.SGD(0.1, parameters=jp), topt.SGD(0.1, parameters=tp)
    jm = jinc.ModelAverage(0.5, parameters=jp, min_average_window=2,
                           max_average_window=3)
    tm = tinc.ModelAverage(0.5, parameters=tp, min_average_window=2,
                           max_average_window=3)
    for step in range(6):                  # the window restarts at 4
        g = _grads(step)
        _step(js, jp, g, "ref")
        _step(ts, tp, g, "port")
        jm.step()
        tm.step()
        _same(jm, tm, jp, tp)
    trained = [_np(p) for p in tp]
    jm.apply()
    with tm.apply():
        for a, b in zip(jp, tp):
            _close(b, _np(a), STEP_TOL)
        tm.apply()                           # keeps the first backup
        jm.apply()
    jm.restore()
    for a, b, w in zip(jp, tp, trained):
        np.testing.assert_array_equal(_np(b), w)
        _close(b, _np(a), STEP_TOL)
    jp2, tp2 = _copies(tp)
    jm2 = jinc.ModelAverage(0.5, parameters=jp2, min_average_window=2,
                            max_average_window=3)
    tm2 = tinc.ModelAverage(0.5, parameters=tp2, min_average_window=2,
                            max_average_window=3)
    jm2.set_state_dict(_to_ref(tm.state_dict()))
    tm2.set_state_dict(_to_port(jm.state_dict()))
    for m in (jm, tm, jm2, tm2):
        m.step()
    _same(jm, tm2, jp, tp2)
    _same(jm2, tm, jp2, tp)


REGULARIZED = {
    "sgd_l2": (lambda o, ps: o.SGD(0.1, parameters=ps, weight_decay=0.3),
               lambda r: r.L2Decay(0.05)),
    "sgd_l1": (lambda o, ps: o.SGD(0.1, parameters=ps),
               lambda r: r.L1Decay(0.02)),
    "momentum_l1": (lambda o, ps: o.Momentum(0.1, 0.9, parameters=ps,
                                             weight_decay=0.01),
                    lambda r: r.L1Decay(0.05)),
    "adamw_l2": (lambda o, ps: o.AdamW(0.05, parameters=ps,
                                       weight_decay=0.1),
                 lambda r: r.L2Decay(0.1)),
}


@pytest.mark.parametrize("case", list(REGULARIZED))
def test_parameter_regularizer_replaces_the_decay(case):
    make, reg = REGULARIZED[case]
    jp, tp = _params()
    jp[0].regularizer, tp[0].regularizer = reg(jreg), reg(treg)
    jo, to = make(jopt, jp), make(topt, tp)
    for step in range(3):
        g = _grads(step)
        _step(jo, jp, g, "ref")
        _step(to, tp, g, "port")
        _same(jo, to, jp, tp)


def test_regularizer_as_weight_decay_raises_type_error():
    for o, r, ps in ((jopt, jreg, _params()[0]), (topt, treg, _params()[1])):
        opt = o.SGD(0.1, parameters=ps, weight_decay=r.L2Decay(0.1))
        _set_grads(ps, _grads(0), "ref" if o is jopt else "port")
        with pytest.raises(TypeError):
            opt.step()
    assert repr(treg.L1Decay(0.5)) == repr(jreg.L1Decay(0.5))
