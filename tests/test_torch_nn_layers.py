"""The port's ``nn`` (``Layer``, its layers and initializers) and ResNet-50
against the JAX package, on the CPU (``set_device("cpu")``).

Each layer is built in both packages, the reference's ``state_dict()`` is
carried into the port as numpy arrays with ``set_state_dict`` (no renaming),
and the same numpy inputs go forward and backward through both: the output,
the input gradient and every parameter gradient are held in fp32 within
``TOL`` relative to the largest value of the tensor compared
(``_close``).  BatchNorm is held over three training steps (its running
statistics too) and in eval; the reference's passes are its jitted
arithmetic (``jax.vjp`` of ``functional_call``), whose BatchNorm gradient
flows through the batch statistics.  Initializer draws come from different
generators, so they are held by shape, dtype and moments.  The reference's
ResNet-50 is built once and run forward once, jitted (``functional_call``),
in a module fixture.
"""

import contextlib
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.utils import functional_call
from paddle_tpu.vision.models import resnet as jresnet
import paddle_tpu_torch as T
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.utils import load_reference_state
from paddle_tpu_torch.vision.models import resnet as tresnet

torch.set_num_threads(2)

TOL = 2e-5


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


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _ref_state(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def _pair(make):
    """``make(nn)`` in both packages, the reference's state carried into
    the port."""
    P.seed(0)
    j = make(jnn)
    T.seed(0)
    t = make(tnn)
    missing, unexpected = t.set_state_dict(_ref_state(j))
    assert not missing and not unexpected, (missing, unexpected)
    return j, t


def _cot(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port_pass(t, inputs, cot_seed=1):
    """The port forward on ``inputs`` (numpy; float ones get gradients)
    and backward from a random cotangent: (out, input grads, param
    grads)."""
    tin = [torch.tensor(a, requires_grad=a.dtype.kind == "f")
           for a in inputs]
    tout = t(*tin)
    (tout * torch.tensor(_cot(tuple(tout.shape), cot_seed))).sum().backward()
    return (tout, [a.grad for a in tin if a.requires_grad],
            {n: p.grad for n, p in t.named_parameters()})


def _ref_passes(cases, cot_seed=1):
    """The same pass through the reference for every ``(layer, inputs)``
    of ``cases``, all in one jitted ``jax.vjp`` of ``functional_call`` (the
    reference's training arithmetic: its jitted path).  Buffers the trace
    moves (BatchNorm's statistics) come out beside the gradients and are
    set on the layers afterwards."""
    bufs = {k: dict(j.named_buffers()) for k, (j, _) in cases.items()}
    saved = {k: {n: b._data for n, b in d.items()} for k, d in bufs.items()}

    def one(k, j, inputs, params, floats):
        fl = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"]

        def f(params, floats):
            xs = list(inputs)
            for i, a in zip(fl, floats):
                xs[i] = a
            out = functional_call(j, params, *[JT(a) for a in xs])
            return out, {n: b._data for n, b in bufs[k].items()}
        out, vjp, moved = jax.vjp(f, params, floats, has_aux=True)
        gp, gx = vjp(_cot(out.shape, cot_seed))
        return out, gx, gp, moved

    def run(all_params, all_floats):
        return {k: one(k, j, inputs, all_params[k], all_floats[k])
                for k, (j, inputs) in cases.items()}
    params = {k: {n: p._data for n, p in j.named_parameters()}
              for k, (j, _) in cases.items()}
    floats = {k: [a for a in inputs if a.dtype.kind == "f"]
              for k, (_, inputs) in cases.items()}
    try:
        res = jax.jit(run)(params, floats)
    finally:
        for k, d in bufs.items():
            for n, b in d.items():
                b._data = saved[k][n]
    for k, d in bufs.items():
        for n, b in d.items():
            b._data = res[k][3][n]
    return {k: (np.asarray(o), [np.asarray(g) for g in gx],
                {n: np.asarray(g) for n, g in gp.items()})
            for k, (o, gx, gp, _) in res.items()}


def _passes(j, t, inputs, cot_seed=1):
    """(reference pass, port pass) of one layer."""
    port = _port_pass(t, inputs, cot_seed)
    return _ref_passes({0: (j, inputs)}, cot_seed)[0], port


def _assert_passes_equal(ref, port, tol=TOL):
    _close(port[0], ref[0], tol, "out")
    for i, (g, w) in enumerate(zip(port[1], ref[1])):
        _close(g, w, tol, f"input grad {i}")
    assert set(port[2]) == set(ref[2])
    for n, w in ref[2].items():
        _close(port[2][n], w, tol, f"grad {n}")


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


ACTIVATIONS = [
    ("ReLU", ()), ("ReLU6", ()), ("LeakyReLU", (0.1,)), ("GELU", ()),
    ("GELU", (True,)), ("Silu", ()), ("Swish", ()), ("Mish", ()),
    ("Sigmoid", ()), ("LogSigmoid", ()), ("Tanh", ()), ("Tanhshrink", ()),
    ("Hardshrink", ()), ("Softshrink", ()), ("Hardsigmoid", ()),
    ("Hardswish", ()), ("Hardtanh", ()), ("ELU", ()), ("CELU", ()),
    ("SELU", ()), ("Softplus", ()), ("Softsign", ()), ("Softmax", ()),
    ("LogSoftmax", ()), ("GLU", ())]


def _act_key(name, args):
    return f"{name}{len(args)}"


@pytest.fixture(scope="module")
def activation_refs():
    """The reference's pass of every activation layer, in one jit."""
    x = _x(3, 6) * 3
    return x, _ref_passes({_act_key(n, a): (getattr(jnn, n)(*a), [x])
                           for n, a in ACTIVATIONS})


@pytest.mark.parametrize("name,args", ACTIVATIONS,
                         ids=[_act_key(n, a) for n, a in ACTIVATIONS])
def test_activation_layers(name, args, activation_refs):
    x, refs = activation_refs
    port = _port_pass(getattr(tnn, name)(*args), [x])
    _assert_passes_equal(refs[_act_key(name, args)], port)


def test_maxout():
    make = lambda nn: nn.Maxout(2)  # noqa: E731
    _assert_passes_equal(*_passes(*_pair(make), [_x(2, 4, 3)]))


LAYERS = {
    "linear": (lambda nn: nn.Linear(8, 5), [(3, 8)]),
    "linear_no_bias": (lambda nn: nn.Linear(8, 5, bias_attr=False),
                       [(2, 4, 8)]),
    "identity": (lambda nn: nn.Identity(), [(3, 4)]),
    "conv_stride_pad": (lambda nn: nn.Conv2D(4, 6, 3, stride=2, padding=1),
                        [(2, 4, 9, 9)]),
    "conv_dilation_groups": (lambda nn: nn.Conv2D(4, 6, 3, padding=2,
                                                  dilation=2, groups=2),
                             [(2, 4, 8, 8)]),
    "conv_asymmetric_pad": (lambda nn: nn.Conv2D(3, 4, (3, 2),
                                                 padding=[1, 0, 2, 1],
                                                 bias_attr=False),
                            [(1, 3, 7, 6)]),
    "conv_same_stride2": (lambda nn: nn.Conv2D(3, 4, 3, stride=2,
                                               padding="SAME"),
                          [(1, 3, 8, 7)]),
    "conv_nhwc": (lambda nn: nn.Conv2D(3, 4, 3, padding=1,
                                       data_format="NHWC"),
                  [(2, 5, 5, 3)]),
    "layer_norm": (lambda nn: nn.LayerNorm(8), [(2, 3, 8)]),
    "layer_norm_2d": (lambda nn: nn.LayerNorm([3, 8]), [(2, 3, 8)]),
    "max_pool": (lambda nn: nn.MaxPool2D(3, 2, 1), [(2, 3, 9, 9)]),
    "avg_pool_exclusive": (lambda nn: nn.AvgPool2D(3, 2, 1), [(2, 3, 9, 9)]),
    "avg_pool_inclusive": (lambda nn: nn.AvgPool2D(3, 2, 1, exclusive=False),
                           [(2, 3, 9, 9)]),
    "adaptive_avg_1": (lambda nn: nn.AdaptiveAvgPool2D(1), [(2, 3, 7, 7)]),
    "adaptive_avg_uneven": (lambda nn: nn.AdaptiveAvgPool2D((3, 2)),
                            [(2, 3, 7, 5)]),
    "flatten": (lambda nn: nn.Flatten(), [(2, 3, 4, 5)]),
    "mha": (lambda nn: nn.MultiHeadAttention(8, 2), [(2, 5, 8)]),
    "encoder_layer_post_relu": (
        lambda nn: nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0),
        [(2, 5, 8)]),
    "encoder_layer_pre_gelu": (
        lambda nn: nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0,
                                              activation="gelu",
                                              normalize_before=True),
        [(2, 5, 8)]),
    "encoder": (lambda nn: nn.TransformerEncoder(
        nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0), 2,
        norm=nn.LayerNorm(8)), [(2, 5, 8)]),
    "sequential": (lambda nn: nn.Sequential(nn.Linear(6, 4), nn.ReLU(),
                                            nn.Linear(4, 3)), [(5, 6)]),
}


def _layer_inputs(case):
    return [_x(*shape, seed=i) for i, shape in enumerate(LAYERS[case][1])]


@pytest.fixture(scope="module")
def layer_refs():
    """Each case's layer pair and the reference's passes, in one jit."""
    with _cpu():
        pairs = {case: _pair(make) for case, (make, _) in LAYERS.items()}
    refs = _ref_passes({case: (j, _layer_inputs(case))
                        for case, (j, _) in pairs.items()})
    return pairs, refs


@pytest.mark.parametrize("case", list(LAYERS))
def test_layers(case, layer_refs):
    pairs, refs = layer_refs
    _assert_passes_equal(refs[case],
                         _port_pass(pairs[case][1], _layer_inputs(case)))


def test_mha_with_mask_and_dropout_off_in_eval():
    j, t = _pair(lambda nn: nn.MultiHeadAttention(8, 2, dropout=0.5))
    j.eval()
    t.eval()
    mask = np.tril(np.ones((5, 5), bool))[None, None]
    call_j = lambda x: j(x, attn_mask=JT(mask))  # noqa: E731
    call_t = lambda x: t(x, attn_mask=torch.tensor(mask))  # noqa: E731
    x = _x(2, 5, 8)
    _close(call_t(torch.tensor(x)), call_j(JT(x)).numpy())


def test_embedding_with_padding_idx():
    j, t = _pair(lambda nn: nn.Embedding(10, 4, padding_idx=2))
    assert not t.weight[2].any()
    ids = np.array([[1, 2, 3, 2], [9, 0, 2, 5]], np.int64)
    ref, port = _passes(j, t, [ids])
    _assert_passes_equal(ref, port)
    assert not port[2]["weight"][2].any()


def test_dropout_layer():
    """Eval: the identity (and ``downscale_in_infer`` scales by 1 - p).
    Training: a kept entry is x / (1 - p), the kept share is near 1 - p,
    and the same generator state gives the same mask."""
    d = tnn.Dropout(0.3)
    x = torch.ones(200, 100)
    d.eval()
    assert torch.equal(d(x), x)
    assert torch.allclose(tnn.Dropout(0.3, mode="downscale_in_infer").eval()(
        x), x * 0.7)
    d.train()
    T.seed(3)
    y = d(x)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    T.seed(3)
    assert torch.equal(d(x), y)
    col = tnn.functional.dropout(x, 0.5, axis=1)
    assert ((col == 0).all(0) | (col != 0).all(0)).all()


LOSSES = {
    "ce_hard_ignore": (lambda nn: nn.CrossEntropyLoss(ignore_index=1),
                       lambda r: r.integers(0, 5, (6,))),
    "ce_hard_label_dim": (lambda nn: nn.CrossEntropyLoss(),
                          lambda r: r.integers(0, 5, (6, 1))),
    "ce_sum_smoothing": (lambda nn: nn.CrossEntropyLoss(
        reduction="sum", label_smoothing=0.1),
        lambda r: r.integers(0, 5, (6,))),
    "ce_none": (lambda nn: nn.CrossEntropyLoss(reduction="none"),
                lambda r: r.integers(0, 5, (6,))),
    "ce_soft": (lambda nn: nn.CrossEntropyLoss(soft_label=True),
                lambda r: r.dirichlet(np.ones(5), 6).astype(np.float32)),
    "mse": (lambda nn: nn.MSELoss(), lambda r: r.standard_normal(
        (6, 5)).astype(np.float32)),
    "l1_sum": (lambda nn: nn.L1Loss("sum"), lambda r: r.standard_normal(
        (6, 5)).astype(np.float32)),
}


@pytest.mark.parametrize("case", list(LOSSES))
def test_losses(case):
    make, label = LOSSES[case]
    j, t = _pair(make)
    rng = np.random.default_rng(2)
    x, lab = _x(6, 5) * 2, label(rng)
    if lab.dtype.kind == "f":       # a label that gets no gradient
        lab = lab.astype(np.float32)
    jx, tx = JT(x, stop_gradient=False), torch.tensor(x, requires_grad=True)
    jl, tl = j(jx, JT(lab)), t(tx, torch.tensor(lab))
    jl.sum().backward()
    tl.sum().backward()
    _close(tl, jl.numpy(), what="loss")
    _close(tx.grad, jx.grad.numpy(), what="grad")


def test_cross_entropy_weighted_mean():
    x, lab = _x(6, 5), np.array([0, 4, 1, 1, 3, 2])
    w = np.array([1.0, 2.0, 0.5, 1.0, 3.0], np.float32)
    want = jnn.functional.cross_entropy(JT(x), JT(lab), weight=JT(w),
                                        ignore_index=3).numpy()
    got = tnn.functional.cross_entropy(torch.tensor(x), torch.tensor(lab),
                                       weight=torch.tensor(w),
                                       ignore_index=3)
    _close(got, want)


@pytest.mark.parametrize("cls", ["BatchNorm2D", "BatchNorm", "BatchNorm1D"])
def test_batch_norm_train_steps_then_eval(cls):
    """Three training steps (output, input and parameter gradients, then
    the running statistics), then an eval forward on the moved
    statistics.  The gradient flows through the batch statistics, as in
    the reference's jitted path (its eager path takes them as constants:
    ROADMAP.md, Queue 3)."""
    shape = (4, 3) if cls == "BatchNorm1D" else (4, 3, 5, 5)
    j, t = _pair(lambda nn: getattr(nn, cls)(3))
    for step in range(3):
        x = _x(*shape, seed=step) * (step + 1) + step
        _assert_passes_equal(*_passes(j, t, [x], cot_seed=step))
        for p in j.parameters():
            p.clear_grad()
        t.clear_gradients()
    _close(t._mean, j._mean.numpy(), what="_mean")
    _close(t._variance, j._variance.numpy(), what="_variance")
    j.eval()
    t.eval()
    x = _x(*shape, seed=9)
    _close(t(torch.tensor(x)), j(JT(x)).numpy(), what="eval")


def test_state_names_layouts_and_dtypes():
    """The reference's three layout cases, and a reference state_dict
    loading with no renaming."""
    make = lambda nn: nn.Sequential(  # noqa: E731
        nn.Conv2D(3, 4, 3, groups=1), nn.BatchNorm2D(4), nn.ReLU(),
        nn.Flatten(), nn.Linear(4 * 4 * 4, 5))
    j, t = _pair(make)
    js, ts = j.state_dict(), t.state_dict()
    assert list(ts) == list(js)
    for k in js:
        assert list(ts[k].shape) == js[k].shape, k
        assert str(ts[k].dtype).split(".")[-1] == js[k].dtype.name, k
    assert list(ts["0.weight"].shape) == [4, 3, 3, 3]
    assert list(ts["4.weight"].shape) == [64, 5]
    assert "1._mean" in ts and "1._variance" in ts


def test_port_state_loads_into_the_reference():
    """The reverse direction: the port's state_dict as numpy into the
    reference's set_state_dict gives the same outputs."""
    make = lambda nn: nn.Sequential(  # noqa: E731
        nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4), nn.ReLU(),
        nn.AdaptiveAvgPool2D(1), nn.Flatten(), nn.Linear(4, 3))
    T.seed(5)
    t = make(tnn)
    with torch.no_grad():
        t[1]._mean.uniform_(-1, 1)
        t[1]._variance.uniform_(0.5, 2)
    P.seed(7)
    j = make(jnn)
    j.set_state_dict({k: v.numpy() for k, v in t.state_dict().items()})
    j.eval()
    t.eval()
    x = _x(2, 3, 6, 6)
    _close(t(torch.tensor(x)), j(JT(x)).numpy())


def test_layer_api():
    class Net(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.a = tnn.Linear(4, 3)
            self.b = tnn.Sequential(("x", tnn.ReLU()), ("y", tnn.Linear(3, 2)))
            self.register_buffer("keep", torch.zeros(2))
            self.register_buffer("scratch", torch.zeros(2), persistable=False)
            self.extra = self.create_parameter(
                [2], attr=tnn.ParamAttr(name="extra_w", trainable=False,
                                        learning_rate=0.5),
                default_initializer=tnn.initializer.Constant(3.0))

        def forward(self, x):
            return self.b(self.a(x)) + self.extra

    net = Net()
    assert isinstance(net.parameters(), list) and len(net.parameters()) == 5
    assert [n for n, _ in net.named_sublayers()] == ["a", "b", "b.x", "b.y"]
    assert list(net.state_dict()) == ["extra", "a.weight", "a.bias",
                                      "b.y.weight", "b.y.bias", "keep"]
    assert net.extra.name == "extra_w" and net.extra.stop_gradient
    assert net.extra.optimize_attr["learning_rate"] == 0.5
    assert not net.extra.trainable and torch.equal(net.extra,
                                                   torch.full((2,), 3.0))
    order = []
    net.apply(lambda layer: order.append(type(layer).__name__))
    assert order == ["Net", "Linear", "Sequential", "ReLU", "Linear"]
    h1 = net.register_forward_pre_hook(lambda layer, inp: (inp[0] * 0,))
    h2 = net.register_forward_post_hook(lambda layer, inp, out: out + 1)
    x = torch.ones(1, 4)
    assert torch.allclose(net(x), net.b(net.a(x * 0)) + net.extra + 1)
    h1.remove()
    h2.remove()
    net(x).sum().backward()
    assert net.a.weight.grad is not None
    net.clear_gradients()
    assert net.a.weight.grad is None
    net.eval()
    assert not any(layer.training for layer in net.sublayers(True))
    net.train()
    net.to(dtype="bfloat16")
    assert net.a.weight.dtype == torch.bfloat16 and \
        net.keep.dtype == torch.bfloat16
    assert isinstance(net.a.weight, T.Parameter)
    missing, unexpected = net.set_state_dict({"a.bias": np.ones(3),
                                              "nope": np.ones(1)})
    assert unexpected == ["nope"] and "a.weight" in missing
    assert torch.equal(net.a.bias, torch.ones(3, dtype=torch.bfloat16))
    ll = tnn.LayerList([tnn.ReLU()]).append(tnn.Tanh())
    ll.insert(0, tnn.Identity())
    assert [type(m).__name__ for m in ll] == ["Identity", "ReLU", "Tanh"]
    assert type(ll[-1]).__name__ == "Tanh" and len(ll[1:]) == 2
    pl = tnn.ParameterList([T.Parameter(torch.zeros(2))])
    assert len(pl) == 1 and len(pl.parameters()) == 1
    seq = tnn.Sequential(tnn.Linear(2, 2), tnn.ReLU())
    assert len(seq) == 2 and isinstance(seq[0:1], tnn.Sequential)


def test_parameter_and_to_tensor():
    p = T.Parameter(torch.zeros(3))
    assert p.trainable and not p.stop_gradient and p.need_clip
    p.stop_gradient = True
    assert not p.requires_grad and not p.trainable
    t = T.to_tensor([1.0, 2.0])
    assert t.dtype == torch.float32 and not t.requires_grad
    t = T.to_tensor(np.arange(3), stop_gradient=False, dtype="float32")
    assert t.requires_grad and t.device.type == "cpu"
    assert T.to_tensor([1, 2]).dtype == torch.int64


def test_without_set_device_building_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tdevice._current[0] = None
    with pytest.raises(RuntimeError, match="cuda"):
        tnn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        T.to_tensor([1.0])
    with pytest.raises(RuntimeError, match="cuda"):
        T.set_device("gpu:0")
    assert T.get_device() == "cpu" if tdevice._current[0] else True


INITS = [
    ("Constant", (0.5,), 0.5, 0.0),
    ("Normal", (0.1, 2.0), 0.1, 2.0),
    ("TruncatedNormal", (0.0, 1.0), 0.0, 0.8796),   # std of N(0,1) on [-2, 2]
    ("Uniform", (-0.5, 1.5), 0.5, 2 / math.sqrt(12)),
    ("XavierNormal", (), 0.0, math.sqrt(2 / (128 + 64))),
    ("XavierUniform", (), 0.0, math.sqrt(6 / (128 + 64)) / math.sqrt(3)),
    ("KaimingNormal", (), 0.0, math.sqrt(2 / 128)),
    ("KaimingUniform", (), 0.0, math.sqrt(6 / 128) / math.sqrt(3)),
    ("Orthogonal", (), 0.0, 1 / math.sqrt(128)),
]


@pytest.fixture(scope="module")
def reference_draws():
    """The reference's draw of every initializer at [128, 64] in float32
    and bfloat16, in one jit (JAX's QR takes no bfloat16, so the reference
    has no bfloat16 Orthogonal)."""
    def draw():
        return {(name, dt): getattr(jnn.initializer, name)(*args)(
            [128, 64], P.dtypes.convert_dtype(dt))
            for name, args, _, _ in INITS for dt in ("float32", "bfloat16")
            if (name, dt) != ("Orthogonal", "bfloat16")}
    P.seed(0)
    return {k: np.asarray(v, np.float32) for k, v in jax.jit(draw)().items()}


@pytest.mark.parametrize("name,args,mean,std", INITS,
                         ids=[i[0] for i in INITS])
def test_initializers_shape_dtype_moments(name, args, mean, std,
                                          reference_draws):
    """Both packages' draws at [128, 64] in float32 and bfloat16: the
    shape and dtype, and mean / std near the distribution's (the port
    draws a bfloat16 Orthogonal in float32 and rounds it)."""
    T.seed(0)
    for dtype in ("float32", "bfloat16"):
        got = getattr(tnn.initializer, name)(*args)(
            [128, 64], T.dtypes.convert_dtype(dtype))
        assert got.dtype == T.dtypes.convert_dtype(dtype)
        draws = [got.float().numpy()]
        if (name, dtype) in reference_draws:
            draws.append(reference_draws[(name, dtype)])
        assert all(a.shape == (128, 64) for a in draws)
        for a in draws:
            assert abs(a.mean() - mean) < 4 * max(std, 1e-3) / \
                math.sqrt(a.size) + 1e-2 * (dtype == "bfloat16"), \
                (name, a.mean())
            assert abs(a.std() - std) < 0.05 * max(std, 1e-3) + 1e-3, \
                (name, a.std())


def test_orthogonal_dirac_assign_and_gain():
    q = tnn.initializer.Orthogonal()([64, 16], torch.float32)
    assert torch.allclose(q.T @ q, torch.eye(16), atol=1e-5)
    d = tnn.initializer.Dirac()([3, 3, 4, 6], torch.float32)
    jd = np.asarray(jnn.initializer.Dirac()([3, 3, 4, 6],
                                            P.dtypes.convert_dtype(
                                                "float32")))
    for w in (d.numpy(), jd):
        nz = np.argwhere(np.abs(w).sum((2, 3)) > 0)
        assert nz.tolist() == [[1, 1]]
        np.testing.assert_allclose(w[1, 1] @ w[1, 1].T, np.eye(4), atol=1e-5)
    a = tnn.initializer.Assign(np.arange(6.0))([2, 3], torch.float32)
    assert a.tolist() == [[0, 1, 2], [3, 4, 5]]
    for nl, param in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                      ("selu", None), ("linear", None)):
        assert tnn.initializer.calculate_gain(nl, param) == \
            jnn.initializer.calculate_gain(nl, param)


def test_default_initializers_of_the_layers():
    """Conv2D: KaimingUniform(fan_in) weight, Uniform(+-1/sqrt(fan_in))
    bias; Linear: XavierNormal weight, zero bias; BatchNorm: ones, zeros,
    running 0 / 1."""
    T.seed(1)
    conv = tnn.Conv2D(16, 32, 3)
    fan_in = 16 * 9
    assert conv.weight.abs().max() <= math.sqrt(6 / fan_in)
    assert conv.bias.abs().max() <= 1 / math.sqrt(fan_in)
    lin = tnn.Linear(256, 128)
    assert abs(lin.weight.std().item() - math.sqrt(2 / 384)) < 0.003
    assert not lin.bias.any()
    bn = tnn.BatchNorm2D(4)
    assert bn.weight.tolist() == [1.0] * 4 and bn._variance.tolist() == \
        [1.0] * 4 and bn._mean.dtype == torch.float32


# ------------------------------------------------------------- ResNet ---

@pytest.fixture(scope="module")
def resnet_pair():
    """The reference's resnet50(num_classes=4) (seed 0) and its eval
    logits at B 2, 32 px from one jitted forward; the port's resnet50 with
    the reference's state."""
    P.seed(0)
    j = jresnet.resnet50(num_classes=4)
    j.eval()
    x = _x(2, 3, 32, 32, seed=4)
    params = {k: p._data for k, p in j.named_parameters()}
    logits = np.asarray(jax.jit(lambda p, a: functional_call(
        j, p, JT(a)))(params, x))
    state = _ref_state(j)
    with _cpu():
        t = tresnet.resnet50(num_classes=4)
    return j, t, state, x, logits


def test_resnet50_state_names_shapes_dtypes(resnet_pair):
    j, t, state, _, _ = resnet_pair
    ts = t.state_dict()
    assert list(ts) == list(state) and len(ts) == 161 + 2 * 53
    for k, a in state.items():
        assert tuple(ts[k].shape) == a.shape, k
        assert str(ts[k].dtype).split(".")[-1] == a.dtype.name, k
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in j.named_sublayers()]


def test_resnet50_eval_forward_matches(resnet_pair):
    """The reference's state carried by ``load_reference_state``
    (parameters and the 106 BatchNorm buffers, every one required), then
    one eval forward."""
    _, t, state, x, logits = resnet_pair
    with pytest.raises(KeyError, match="_variance"):
        load_reference_state(t, {k: v for k, v in state.items()
                                 if k != "bn1._variance"})
    load_reference_state(t, state)
    t.eval()
    with torch.no_grad():
        out = t(torch.tensor(x))
    _close(out, logits, tol=1e-4)


def test_resnet_constructors_and_pretrained():
    with pytest.raises(NotImplementedError):
        tresnet.resnet18(pretrained=True)
    T.seed(0)
    for fn, blocks in ((tresnet.resnet18, 8), (tresnet.resnext50_32x4d, 16)):
        m = fn(num_classes=3)
        n = sum(isinstance(s, (tresnet.BasicBlock, tresnet.BottleneckBlock))
                for s in m.sublayers())
        assert n == blocks
    m = tresnet.resnext50_32x4d(num_classes=3)
    assert list(m.layer1[0].conv2.weight.shape) == [128, 4, 3, 3]
    assert list(tresnet.wide_resnet50_2(num_classes=2).layer1[0].conv1.
                weight.shape) == [128, 64, 1, 1]
