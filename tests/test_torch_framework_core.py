"""The rest of the framework core in the port against the JAX package, on
the CPU (``set_device("cpu")``): ``autograd``'s transforms and hooks,
``amp.debugging``, ``device`` and ``device.memory_debug``, and the public
names of every module of the slice.

- ``jacobian``, ``hessian``, ``jvp`` and ``vjp`` on one and on several
  inputs, with and without ``v``: the same structure and values within
  TRANSFORM_TOL.
- ``saved_tensors_hooks`` over ``PyLayer``; ``LegacyPyLayer``.
- ``check_numerics`` (its counts and message), the tensor checker's op
  lists, step window and modes, ``collect_operator_stats``' per-dtype
  counts of a small model at fp32 and under bf16 autocast (equal to the
  reference's), the layer numerics watcher.
- The device entries that run without a card: places, device lists, the
  memory namespaces, ``Stream`` / ``Event`` on the host clock,
  ``memory_analysis``, ``donation_audit``, ``live_arrays_report``.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu import autograd as jag
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch import autograd as tag
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.amp import debugging as tdbg
from test_torch_optimizer_amp import _cpu

torch.set_num_threads(2)

TRANSFORM_TOL = 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    with _cpu():
        yield


def _arr(t):
    return np.asarray(t._data if hasattr(t, "_data") else
                      t.detach().numpy(), np.float32)


def _same_tree(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
        return
    assert torch.is_tensor(got) and isinstance(got, T.Tensor)
    np.testing.assert_allclose(_arr(got), _arr(want), rtol=TRANSFORM_TOL,
                               atol=TRANSFORM_TOL)


_RNG = np.random.default_rng(21)
X = _RNG.standard_normal((3,)).astype(np.float32)
Y = _RNG.standard_normal((3,)).astype(np.float32)
V = _RNG.standard_normal((3,)).astype(np.float32)

# (transform, function of the package, inputs, extra: v), one per case
TRANSFORMS = {
    "jacobian_one": ("jacobian", lambda m: lambda x: m.tanh(x) * x, "x",
                     None),
    "jacobian_two": ("jacobian", lambda m: lambda x, y: m.sin(x) * y + x,
                     "xy", None),
    "jacobian_two_outputs": ("jacobian",
                             lambda m: lambda x: (x * x, m.exp(x)), "x",
                             None),
    "hessian_one": ("hessian", lambda m: lambda x: (m.sin(x) * x * x).sum(),
                    "x", None),
    "hessian_two": ("hessian", lambda m: lambda x, y: (x * x * y).sum(),
                    "xy", None),
    "jvp_ones": ("jvp", lambda m: lambda x: m.tanh(x) * x, "x", None),
    "jvp_v": ("jvp", lambda m: lambda x, y: x * y * y, "xy", "vv"),
    "vjp_ones": ("vjp", lambda m: lambda x: (m.sin(x) * x).sum(), "x", None),
    "vjp_v": ("vjp", lambda m: lambda x, y: m.exp(x) * y, "xy", "v"),
}


@pytest.mark.parametrize("case", list(TRANSFORMS))
def test_functional_transforms(case):
    name, fn, ins, v = TRANSFORMS[case]
    outs = {}
    for pkg, ag in ((P, jag), (T, tag)):
        vals = {"x": X, "y": Y, "v": V}
        xs = [pkg.to_tensor(vals[c]) for c in ins]
        args = [fn(pkg), xs[0] if len(xs) == 1 else xs]
        if v is not None:
            vs = [pkg.to_tensor(vals[c]) for c in v]
            args.append(vs[0] if len(vs) == 1 else vs)
        outs[pkg] = getattr(ag, name)(*args)
    _same_tree(outs[T], outs[P])


def test_saved_tensors_hooks_and_legacy_pylayer():
    for base in (tag.PyLayer, tag.LegacyPyLayer):
        packed, unpacked = [], []

        class Square(base):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensor()
                return g * 2.0 * x

        x = T.to_tensor(np.asarray([3.0, -1.0], np.float32))
        x.stop_gradient = False
        with tag.saved_tensors_hooks(
                lambda t: (packed.append(1), t.numpy().copy())[1],
                lambda h: (unpacked.append(1), T.to_tensor(h))[1]):
            y = Square.apply(x)
        assert packed == [1] and not unpacked
        y.sum().backward()
        assert unpacked == [1]
        np.testing.assert_allclose(x.grad.numpy(), [6.0, -2.0])
        # outside the block nothing is hooked
        x.clear_grad()
        Square.apply(x).sum().backward()
        assert packed == [1] and unpacked == [1]


@pytest.mark.parametrize("values", [[1.0, 2.0], [np.nan, 1.0, np.inf, np.nan],
                                    [-np.inf, 0.0]])
def test_check_numerics(values):
    a = np.asarray(values, np.float32)
    results = {}
    for pkg, dbg in ((P, jdbg), (T, tdbg)):
        try:
            out = dbg.check_numerics(pkg.to_tensor(a), "op", "var")
            results[pkg] = [int(_arr(o)) for o in out]
        except FloatingPointError as e:
            results[pkg] = str(e)
    assert results[T] == results[P]


def test_tensor_checker(tmp_path):
    """The reference's test (``test_jit_amp.py:183``) on the port."""
    bad = T.to_tensor(np.array([1.0, np.inf], np.float32))
    one = T.to_tensor(np.array([1.0, 1.0], np.float32))
    cfg = tdbg.TensorCheckerConfig(debug_mode=tdbg.DebugMode.CHECK_NAN_INF,
                                   output_dir=str(tmp_path))
    tdbg.enable_tensor_checker(cfg)
    try:
        assert tdbg.active_checker_config() is cfg
        _ = bad + one
        assert cfg.findings == [(0, "add", 0, 1)]
        assert (tmp_path / "tensor_checker.log").exists()
    finally:
        tdbg.disable_tensor_checker()
    assert tdbg.active_checker_config() is None
    _ = bad * one                              # checker off: no raise
    for kw, passes, raises in ((dict(skipped_op_list=["add"]), "+", "*"),
                               (dict(checked_op_list=["subtract"]), "*",
                                "-")):
        tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(**kw))
        try:
            eval(f"bad {passes} one")
            with pytest.raises(FloatingPointError):
                eval(f"bad {raises} one")
        finally:
            tdbg.disable_tensor_checker()
    cfg = tdbg.TensorCheckerConfig(debug_step=(5, 10))
    tdbg.enable_tensor_checker(cfg)
    try:
        cfg.update_step_id(2)
        _ = bad + one
        cfg.update_step_id(7)
        with pytest.raises(FloatingPointError):
            _ = bad + one
    finally:
        tdbg.disable_tensor_checker()
    with pytest.raises(NotImplementedError):
        tdbg.compare_accuracy("a", "b")


def test_operator_stats_equal_the_reference():
    x = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    stats = {}
    for pkg, dbg in ((P, jdbg), (T, tdbg)):
        P.seed(0)
        m = pkg.nn.Sequential(pkg.nn.Linear(4, 8), pkg.nn.ReLU(),
                              pkg.nn.LayerNorm(8), pkg.nn.Linear(8, 2))
        xt = pkg.to_tensor(x)
        runs = []
        for amp in (False, True):
            with contextlib.ExitStack() as stack:
                if amp:
                    stack.enter_context(pkg.amp.auto_cast(dtype="bfloat16"))
                st = stack.enter_context(dbg.collect_operator_stats())
                y = m(xt)
                _ = pkg.nn.functional.softmax(y) * 2.0 + y.sum()
            runs.append(dict(st))
        stats[pkg] = runs
    assert stats[T] == stats[P]
    assert stats[T][1]["bfloat16"] > 0


def test_layer_numerics_watcher():
    T.seed(0)
    m = T.nn.Sequential(T.nn.Linear(4, 8), T.nn.ReLU(), T.nn.Linear(8, 2))
    w = tdbg.check_layer_numerics(m)
    m(T.randn([3, 4]))
    assert w.first_bad_layer() is None and len(w.stats) == 3
    assert all(s["calls"] == 1 and np.isfinite(s["absmax"])
               for s in w.stats.values())
    m[0].weight.set_value(np.full((4, 8), np.nan, np.float32))
    m(T.randn([3, 4]))
    assert w.first_bad_layer() == "0" and "layer" in w.summary()
    w.unwatch()
    m(T.randn([3, 4]))
    assert w.stats["0"]["calls"] == 2


def test_places_and_device_lists_without_a_card():
    assert tdevice.CUDAPinnedPlace() == tdevice.CPUPlace()
    assert tdevice.TPUPlace(1) == tdevice.CUDAPlace(1) == tdevice.XPUPlace(1)
    assert tdevice.CustomPlace("gpu", 2) == tdevice.CUDAPlace(2)
    if torch.cuda.is_available():
        pytest.skip("the card answers these")
    assert tdevice.get_available_device() == ["cpu"]
    assert tdevice.get_available_custom_device() == ["cpu"]
    assert tdevice.get_all_custom_device_type() == []
    for ns in (tdevice.cuda, tdevice.tpu):
        assert ns.memory_allocated() == ns.max_memory_allocated() == 0
        assert ns.memory_reserved() == ns.max_memory_reserved() == 0
        assert ns.memory_summary() == \
            "memory stats unavailable on this backend"
        ns.empty_cache()
        assert ns.device_count() == 0


def test_stream_and_event_on_the_host():
    s = tdevice.current_stream()
    assert s.query()
    start = s.record_event()
    _ = T.randn([64, 64]).matmul(T.randn([64, 64]))
    end = tdevice.Event()
    end.record(tdevice.Stream())
    assert end.query()
    assert start.elapsed_time(end) >= 0.0
    with pytest.raises(RuntimeError):
        tdevice.Event().elapsed_time(end)
    s.wait_event(end)
    s.wait_stream(tdevice.Stream(priority=1))
    s.synchronize()


def test_memory_debug():
    import jax.numpy as jnp
    from paddle_tpu.device import memory_analysis as jma
    a = torch.ones(64, 64)
    want = jma(lambda x, y: x @ y, jnp.ones((64, 64), jnp.float32),
               jnp.ones((64, 64), jnp.float32))
    got = tdevice.memory_analysis(lambda x, y: x @ y, a, a)
    for k in ("argument_bytes", "output_bytes"):
        assert got[k] == want[k]
    assert got["peak_estimate_bytes"] >= got["argument_bytes"]
    assert got["temp_bytes"] is None and got["alias_bytes"] == 0
    inplace = tdevice.memory_analysis(lambda x: x.mul_(2.0), a.clone())
    assert inplace["alias_bytes"] == 64 * 64 * 4
    params = {"w": torch.ones(16, 16), "b": torch.ones(16)}
    aud = tdevice.donation_audit(
        lambda p, x: {"w": p["w"].sub_(0.1 * x), "b": p["b"].mul_(0.5)},
        params, torch.ones(16, 16), donate_argnums=(0,))
    assert aud["honored_all"] and aud["donated"][0]["leaves"] == 2
    assert aud["donated"][0]["bytes"] == (16 * 16 + 16) * 4
    aud = tdevice.donation_audit(lambda x: x.sum(), torch.ones(32, 32),
                                 donate_argnums=(0,))
    assert not aud["honored_all"] and aud["unhonored_bytes"] == 32 * 32 * 4
    keep = torch.ones(128, 128)  # noqa: F841  (held for the census)
    rep = tdevice.live_arrays_report(top=5)
    assert rep["total_arrays"] >= 1 and rep["total_bytes"] >= 128 * 128 * 4
    assert all({"device", "dtype", "shape", "count", "bytes"} <= set(r)
               for r in rep["top"])


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_") and
            not isinstance(getattr(mod, n), types.ModuleType)}


# names the reference's modules import for their own use (typing, jax)
_NOT_API = {"annotations", "Any", "Callable", "Counter", "Dict", "Enum",
            "List", "Optional", "Sequence", "Tuple", "partial"}


@pytest.mark.parametrize("module", [
    "optimizer", "regularizer", "incubate.optimizer", "autograd",
    "amp.debugging", "device", "device.memory_debug", "incubate"])
def test_every_public_name_of_the_reference(module):
    import importlib
    ref = importlib.import_module("paddle_tpu." + module)
    port = importlib.import_module("paddle_tpu_torch." + module)
    assert _public(ref) - _NOT_API - set(dir(port)) == set()


def test_namespace_gaps_closed():
    import paddle_tpu_torch.inference as inf
    import paddle_tpu_torch.models as models
    import paddle_tpu_torch.vision as vision
    from paddle_tpu_torch.vision import models as vmodels
    for n in ("ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
              "resnet50", "resnext152_64x4d", "wide_resnet101_2"):
        assert getattr(vision, n) is getattr(vmodels, n)
    for n in ("export_session", "import_session", "import_sessions",
              "MigrationError", "serving_stats"):
        assert n in inf.__all__ and callable(getattr(inf, n))
    assert models.LlamaModel.__name__ == "LlamaModel"
    assert T.incubate.autograd_enabled() is True
