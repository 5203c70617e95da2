"""The port's MoE layer and gates (``paddle_tpu_torch.incubate.distributed.
models.moe``) and the activation layers its experts use, against the JAX
package, on the CPU (``set_device("cpu")``).

A reference layer is built after ``paddle.seed(0)`` and its
``state_dict()`` carried into the port's with ``load_reference_state``; the
same seeded input goes forward and backward through both (the reference's
pass is one jitted ``jax.vjp`` of ``functional_call``), and the output, the
input gradient and every parameter gradient are held in fp32 within TOL of
the largest value compared.  Routing (expert ids, capacity maps) is held
exactly; the inputs have no exact ties between gate scores, where
``jax.lax.top_k`` and ``torch.topk`` may order apart.  ``SwitchGate`` is
held in ``eval()``, where it draws no noise.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml
from paddle_tpu.utils import functional_call
import paddle_tpu_torch as T
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.incubate.distributed.models import moe as tmoe
from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer as tml
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

TOL = 2e-5
D, E, HIDDEN = 16, 4, 32


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


def _close(got, want, tol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _arr(y):
    """A reference result as its array (``functional_call`` returns the
    array, a layer's call a ``Tensor``)."""
    return y._data if isinstance(y, JT) else y


def _experts(nn, n=E):
    return [nn.Sequential(nn.Linear(D, HIDDEN), nn.GELU(),
                          nn.Linear(HIDDEN, D)) for _ in range(n)]


def _pair(gate, dispatch="gather", experts=_experts, **kw):
    P.seed(0)
    j = jmoe.MoELayer(D, experts(jnn), gate=gate, dispatch=dispatch, **kw)
    t = tmoe.MoELayer(D, experts(tnn), gate=gate, dispatch=dispatch, **kw)
    load_reference_state(t, {k: np.asarray(v._data)
                             for k, v in j.state_dict().items()})
    j.eval()
    t.eval()
    return j, t


def _both(j, t, x):
    """(reference, port) of (out, input grad, {param: grad}, aux loss)."""
    cot = _x(*x.shape, seed=9)
    tx = torch.tensor(x, requires_grad=True)
    ty = t(tx)
    (ty * torch.tensor(cot)).sum().backward()
    params = {n: p._data for n, p in j.named_parameters()}

    def forward(p, v):
        out = _arr(functional_call(j, p, JT(v)))
        return out, (None if j.loss is None else _arr(j.loss))

    def pass_(params, a):
        out, vjp, loss = jax.vjp(forward, params, a, has_aux=True)
        return (out, loss) + vjp(cot)
    out, loss, gp, gx = jax.jit(pass_)(params, x)
    ref = (np.asarray(out), np.asarray(gx),
           {n: np.asarray(g) for n, g in gp.items()},
           None if loss is None else float(loss))
    port = (ty, tx.grad, {n: p.grad for n, p in t.named_parameters()},
            None if t.loss is None else float(t.loss.detach()))
    return ref, port


def _assert_equal(ref, port, tol=TOL):
    _close(port[0], ref[0], tol, "out")
    _close(port[1], ref[1], tol, "input grad")
    assert set(port[2]) == set(ref[2])
    for n, w in ref[2].items():
        assert port[2][n] is not None, n
        _close(port[2][n], w, tol, f"grad {n}")
    if ref[3] is None:
        assert port[3] is None
    else:
        np.testing.assert_allclose(port[3], ref[3], rtol=1e-6)


GATES = {"gshard": {"type": "gshard", "top_k": 2},
         "naive": {"type": "naive", "top_k": 2},
         "switch": {"type": "switch"}}


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("gate", GATES)
def test_moe_layer_forward_backward(gate, dispatch):
    j, t = _pair(GATES[gate], dispatch)
    assert t._template is not None
    _assert_equal(*_both(j, t, _x(2, 8, D)))


def test_moe_layer_python_path():
    """Experts of different widths run one by one, as the reference's
    (two experts: top 2 routes every token to both)."""
    def mixed(nn):
        return [nn.Sequential(nn.Linear(D, HIDDEN + 8 * i), nn.GELU(),
                              nn.Linear(HIDDEN + 8 * i, D)) for i in range(2)]
    j, t = _pair(GATES["gshard"], experts=mixed)
    assert j._template is None and t._template is None
    _assert_equal(*_both(j, t, _x(3, 5, D)))


def test_moe_layer_fast_and_python_paths_agree():
    _, t = _pair(GATES["naive"])
    x = torch.tensor(_x(3, 5, D))
    fast = t(x)
    t._template = None
    _close(t(x), fast.detach().numpy(), TOL)


def test_moe_layer_capacity_drops():
    """At capacity factor 0.25 entries drop in both packages (16 tokens x
    top 2 over 4 experts: capacity 4, the floor)."""
    j, t = _pair(GATES["gshard"], capacity_factor=0.25)
    assert t._capacity(16) == j._capacity(16) == 4
    assert t._capacity(1000) == j._capacity(1000) == 125
    x = _x(2, 8, D, seed=4)
    _, idx = t.gate(torch.tensor(x.reshape(-1, D)))
    assert int(torch.bincount(idx.reshape(-1), minlength=E).max()) > 4
    _assert_equal(*_both(j, t, x))


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_dispatch_maps_equal_the_reference(cap):
    """Both dispatch forms' maps, exactly: one-hot dispatch and combine,
    and the index form's inv / slot / gate_keep."""
    rng = np.random.default_rng(cap)
    N, K = 12, 2
    idx = np.stack([rng.permutation(E)[:K] for _ in range(N)]).astype(
        np.int32)
    val = rng.random((N, K)).astype(np.float32)
    jd, jc = jax.jit(jml._dispatch_combine, static_argnums=(2, 3))(
        jnp.asarray(val), jnp.asarray(idx), E, cap)
    td, tc = tml._dispatch_combine(torch.tensor(val), torch.tensor(idx), E,
                                   cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for got, want in zip(
            tml._dispatch_indices(torch.tensor(val), torch.tensor(idx), E,
                                  cap),
            jax.jit(jml._dispatch_indices, static_argnums=(2, 3))(
                jnp.asarray(val), jnp.asarray(idx), E, cap)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gate", GATES)
def test_gates_route_as_the_reference(gate):
    j, t = _pair(GATES[gate])
    x = _x(24, D, seed=5)
    jv, ji = j.gate(P.to_tensor(x))
    tv, ti = t.gate(torch.tensor(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji._data))
    _close(tv, np.asarray(jv._data), TOL)
    if gate == "naive":
        assert t.gate.loss is None and j.gate.loss is None
    else:
        np.testing.assert_allclose(float(t.gate.loss.detach()),
                                   float(np.asarray(j.gate.loss._data)),
                                   rtol=1e-6)
    assert tuple(t.gate.weight.shape) == (D, E)


def test_switch_gate_noise_in_training_only():
    _, t = _pair(GATES["switch"])
    x = torch.tensor(_x(24, D, seed=5))
    clean = torch.max(t.gate.scores(x).float().softmax(-1), -1).values
    t.gate.eval()
    assert torch.equal(t.gate(x)[0][:, 0], clean)
    t.gate.train()
    T.seed(3)
    a = t.gate(x)[0]
    T.seed(3)
    assert torch.equal(t.gate(x)[0], a)          # the device generator's
    assert not torch.equal(a[:, 0], clean)


def test_moe_group_and_bad_dispatch_raise():
    with pytest.raises(NotImplementedError, match="item 18"):
        tmoe.MoELayer(D, _experts(tnn), moe_group=object())
    with pytest.raises(ValueError):
        tmoe.MoELayer(D, _experts(tnn), dispatch="scatter")


def test_namespace_resolves_from_the_reference_path():
    import paddle_tpu_torch
    from paddle_tpu_torch.incubate.distributed.models.moe import (  # noqa
        BaseGate, GShardGate, MoELayer, NaiveGate, SwitchGate)
    assert paddle_tpu_torch.incubate.distributed.models.moe.MoELayer is \
        MoELayer
    assert issubclass(GShardGate, BaseGate)


ACTS = ["ReLU", "ReLU6", "LeakyReLU", "GELU", "Silu", "SiLU", "Swish", "Mish",
        "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink", "Hardshrink",
        "Softshrink", "Hardsigmoid", "Hardswish", "Hardtanh", "ELU", "CELU",
        "SELU", "Softplus", "Softsign", "Softmax", "LogSoftmax", "Maxout",
        "GLU"]


ACT_X = _x(2, 4, 6, 6) * 3


def _act_args(name):
    return (2,) if name == "Maxout" else ()


@pytest.fixture(scope="module")
def act_reference():
    """Every activation layer's reference output and input gradient, from
    one jitted function of ``jax.vjp``s."""
    layers = {n: getattr(jnn, n)(*_act_args(n)) for n in ACTS}

    def all_(x):
        out = {}
        for n, layer in layers.items():
            y, vjp = jax.vjp(lambda a: _arr(layer(JT(a))), x)
            out[n] = (y, vjp(_cot_like(y.shape))[0])
        return out
    return jax.jit(all_)(ACT_X)


def _cot_like(shape):
    return _x(*shape, seed=1)


@pytest.mark.parametrize("name", ACTS)
def test_activation_layers(name, act_reference):
    """The 26 activation layers (``nn/__init__.py`` :102-127), forward and
    input gradient."""
    t = getattr(tnn, name)(*_act_args(name))
    assert type(t).__name__ == ("Silu" if name == "SiLU" else name)
    tx = torch.tensor(ACT_X, requires_grad=True)
    ty = t(tx)
    (ty * torch.tensor(_cot_like(tuple(ty.shape)))).sum().backward()
    out, grad = act_reference[name]
    _close(ty, out, TOL, "out")
    _close(tx.grad, grad, TOL, "grad")
