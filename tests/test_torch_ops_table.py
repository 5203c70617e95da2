"""The port's op table (``paddle_tpu_torch/ops/_generated.py``), its math,
creation and search ops against the JAX package, on the CPU.

Each case runs one op in both packages on the same numpy inputs (made
from a seed): the outputs are held in value (floats within the case's
``tol`` relative to the largest value compared, integers, bools and
indices exactly), in dtype (the reference's numpy dtype name against the
port's torch dtype name, unless the case names the port's own, a
difference logged in ROADMAP Queue 3) and in shape.  For a
differentiable float op the input gradients under a seeded cotangent are
held too.  The reference's passes are one ``jax.jit`` of ``jax.vjp`` over
every case it can trace (``ops.apply_op`` leaves its tape under a
trace); the cases it cannot (host reads: ``unique``, ``nonzero``, ...)
run eagerly.  The same cases run again as ``Tensor`` methods where the
reference has the method (``test_torch_tensor.py``).

This module holds the harness the other ``test_torch_ops_*`` files and
``test_torch_tensor.py`` share.
"""

import builtins

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import paddle_tpu as P
from paddle_tpu.core.tensor import Tensor as JT
import paddle_tpu_torch as T
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.tensor import leaf

torch.set_num_threads(2)

TOL = 1e-5


# ------------------------------------------------------------------ harness

@pytest.fixture(autouse=True)
def on_cpu():
    old = tdevice._current[0]
    T.set_device("cpu")
    try:
        yield
    finally:
        tdevice._current[0] = old


_RNG = [None]


def seed(n):
    """Each case module draws its inputs from its own stream, so they do
    not depend on the order the modules are imported in."""
    _RNG[0] = np.random.default_rng(n)


seed(2500)


def f(*shape, lo=None, hi=None):
    """float32 normal draws (or uniform in [lo, hi))."""
    r = _RNG[0]
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.standard_normal(shape).astype(np.float32)


def i(*shape, lo=0, hi=5, dtype=np.int64):
    return _RNG[0].integers(lo, hi, shape).astype(dtype)


def b(*shape):
    return _RNG[0].random(shape) < 0.5


class Case:
    """One op call: ``call(M, *args, **kw)`` with ``M`` a package; numpy
    arguments become each package's tensors.  ``grad``: hold the input
    gradients (of the float32 array arguments).  ``port_dtype``: the
    port's dtype where it keeps its own (one name, or one an output).
    ``check(port_out, ref_out)``: a property check in place of the value
    comparison (random draws, decompositions).  ``method``: the case also
    runs as ``x.name(...)`` (``test_torch_tensor.py``)."""

    def __init__(self, name, call=None, args=(), kw=None, grad=False,
                 tol=TOL, port_dtype=None, check=None, method=True,
                 eager=False):
        self.id = name
        self.op = name.split("[")[0]
        self.call = call or (lambda M, *a, **k: getattr(M, self.op)(*a, **k))
        self.args = args
        self.kw = kw or {}
        self.grad = grad
        self.tol = tol
        self.port_dtype = port_dtype
        self.check = check
        self.method = method and call is None and bool(args) and \
            isinstance(args[0], np.ndarray)
        self.eager = eager

    def __repr__(self):
        return self.id


def _ref_args(case, arrays):
    it = iter(arrays)
    return [JT(next(it)) if isinstance(a, np.ndarray) else a
            for a in case.args]


def _port_args(case, grad):
    out = []
    for a in case.args:
        if isinstance(a, np.ndarray):
            t = torch.from_numpy(a.copy())
            out.append(leaf(t, grad and a.dtype == np.float32))
        else:
            out.append(a)
    return out


def _flat(x):
    """Outputs as a flat list of arrays (or Python values)."""
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    if isinstance(x, JT):
        return [x._data]
    if torch.is_tensor(x):
        return [x]
    return [x]


def _as_method(case, M):
    def call(M_, x, *a, **k):
        return getattr(x, case.op)(*a, **k)
    return call


def _ref_fn(case, method=False):
    call = _as_method(case, P) if method else case.call

    def fn(*arrays):
        return [jnp.asarray(v) for v in
                _flat(call(P, *_ref_args(case, arrays), **case.kw))]
    return fn


def _arrays(case):
    return [a for a in case.args if isinstance(a, np.ndarray)]


def _grad_slots(case):
    return [k for k, a in enumerate(_arrays(case)) if a.dtype == np.float32]


def _cots(case, outs):
    r = np.random.default_rng(7)
    return [r.standard_normal(o.shape).astype(o.dtype)
            if np.issubdtype(o.dtype, np.floating) else None for o in outs]


def reference(cases, method=False):
    """{case id: (outputs, cotangents, input grads or None)} for the
    reference: traceable cases in one jitted vjp, the rest eagerly."""
    traced, eager, res = [], [], {}
    for c in cases:
        if c.eager:
            eager.append(c)
            continue
        try:
            jax.eval_shape(_ref_fn(c, method), *_arrays(c))
            traced.append(c)
        except Exception:
            eager.append(c)
    for c in eager:
        outs = [np.asarray(v) for v in _ref_fn(c, method)(*_arrays(c))]
        res[c.id] = (outs, None, None)
    shapes = {c.id: jax.eval_shape(_ref_fn(c, method), *_arrays(c))
              for c in traced}
    cots = {c.id: _cots(c, shapes[c.id]) for c in traced}

    def run(all_arrays, all_cots):
        out = []
        for c, arrays, ct in zip(traced, all_arrays, all_cots):
            fn = _ref_fn(c, method)
            if not c.grad:
                out.append((fn(*arrays), None))
                continue
            slots = _grad_slots(c)

            def part(*g, arrays=arrays, slots=slots, fn=fn):
                full = list(arrays)
                for k, v in zip(slots, g):
                    full[k] = v
                return fn(*full)
            vals, vjp = jax.vjp(part, *[arrays[k] for k in slots])
            ct_full = [t if t is not None else
                       jnp.zeros(v.shape, jax.dtypes.float0)
                       if not jnp.issubdtype(v.dtype, jnp.inexact)
                       else jnp.zeros_like(v) for v, t in zip(vals, ct)]
            out.append((vals, vjp(ct_full)))
        return out
    got = jax.jit(run)([_arrays(c) for c in traced],
                       [[None if v is None else v for v in cots[c.id]]
                        for c in traced])
    for c, (vals, grads) in zip(traced, got):
        res[c.id] = ([np.asarray(v) for v in vals], cots[c.id],
                     None if grads is None else [np.asarray(g)
                                                 for g in grads])
    return res


def _dtype_name(v):
    if torch.is_tensor(v):
        return str(v.dtype).replace("torch.", "")
    return np.asarray(v).dtype.name


def _np(v):
    if torch.is_tensor(v):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return torch.Tensor.numpy(v.as_subclass(torch.Tensor))
    return np.asarray(v)


def close(got, want, tol, what=""):
    got, want = _np(got), np.asarray(want)
    if want.dtype.name == "bfloat16":
        want = want.astype(np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating) or \
            np.issubdtype(want.dtype, np.complexfloating):
        scale = builtins.max(1.0, float(np.nanmax(np.abs(want)))
                             if want.size and np.isfinite(want).any()
                             else 1.0)
        np.testing.assert_allclose(got.astype(want.dtype), want, rtol=tol,
                                   atol=tol * scale, err_msg=what,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def hold(case, ref, method=False):
    """Run ``case`` in the port and hold it against ``ref`` (from
    :func:`reference`)."""
    outs, cots, grads = ref[case.id]
    args = _port_args(case, case.grad)
    call = _as_method(case, T) if method else case.call
    T.seed(2500)        # a random case's draws do not hang on test order
    got = call(T, *args, **case.kw)
    flat = _flat(got)
    if case.check is not None:
        case.check(flat, outs)
        return
    assert len(flat) == len(outs), (case.id, len(flat), len(outs))
    for k, (g, w) in enumerate(zip(flat, outs)):
        if torch.is_tensor(g):
            assert isinstance(g, T.Tensor), (case.id, type(g))
        want_dt = np.asarray(w).dtype.name
        if case.port_dtype is not None:
            pd = case.port_dtype
            want_dt = pd if isinstance(pd, str) else pd[k]
        assert _dtype_name(g) == want_dt, (case.id, k, _dtype_name(g),
                                           want_dt)
        close(g, w, case.tol, f"{case.id} out {k}")
    if case.grad and grads is not None:
        leaves = [a for a in args if torch.is_tensor(a) and a.requires_grad]
        pairs = [(g, c) for g, c in zip(flat, cots) if c is not None and
                 torch.is_tensor(g) and g.requires_grad]
        if pairs:
            torch.autograd.backward([g for g, _ in pairs],
                                    [torch.from_numpy(c).to(g.dtype)
                                     for g, c in pairs])
        for k, (a, w) in enumerate(zip(leaves, grads)):
            # torch leaves an input the outputs do not reach without a
            # gradient: a zero one
            g = torch.zeros_like(a) if a.grad is None else a.grad
            close(g, w, case.tol * 10, f"{case.id} grad {k}")


def ids(cases):
    return [c.id for c in cases]


# ------------------------------------------------------------- the table

def test_table_matches_the_reference_schema():
    """Every row of the reference's ``schema.yaml`` is a row of the port's
    table, with the same kind and aliases (and nothing else)."""
    from paddle_tpu_torch.ops import _generated as G
    with open(P.ops.__path__[0] + "/schema.yaml") as fh:
        rows = yaml.safe_load(fh)["ops"]
    want = {r["op"]: (r["kind"], tuple(r.get("aliases", ())),
                      bool(r.get("dtype_arg", False))) for r in rows}
    got = {r[0]: (r[1], tuple(r[3]), len(r) > 4) for r in G.TABLE}
    assert got == want
    assert sorted(G.__all__) == sorted(P.ops._generated.__all__)
    for name in want:
        assert name in T.ops.OP_REGISTRY


_U_ANY = ["abs", "sign", "signbit", "ceil", "floor", "round", "trunc", "fix",
          "frac", "neg", "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh",
          "asinh", "sinc", "deg2rad", "rad2deg", "erf", "erfc", "sigmoid",
          "logsigmoid", "square", "exp", "expm1", "exp2", "cbrt", "angle",
          "conj", "real", "imag", "isnan", "isinf", "isfinite", "isreal",
          "i0", "i0e", "i1", "i1e"]
_U_POS = ["log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
          "lgamma", "gammaln", "digamma"]
_U_UNIT = ["asin", "acos", "atanh", "erfinv"]
_NO_GRAD = {"sign", "signbit", "ceil", "floor", "round", "trunc", "fix",
            "isnan", "isinf", "isfinite", "isreal", "angle", "i1", "i1e",
            "i0", "i0e"}

TABLE = (
    [Case(n, args=(f(3, 4),), grad=n not in _NO_GRAD) for n in _U_ANY] +
    [Case(n, args=(f(3, 4, lo=0.5, hi=2.5),), grad=True) for n in _U_POS] +
    [Case(n, args=(f(3, 4, lo=-0.9, hi=0.9),), grad=True)
     for n in _U_UNIT] +
    [Case("acosh", args=(f(3, 4, lo=1.5, hi=3.0),), grad=True),
     Case("logit", args=(f(3, 4, lo=0.1, hi=0.9),), grad=True),
     Case("logical_not", args=(b(3, 4),)),
     Case("bitwise_not", args=(i(3, 4, lo=-8, hi=8),)),
     Case("abs[int]", args=(i(3, 4, lo=-5, hi=5),)),
     Case("exp[int]", args=(i(3, 4),), port_dtype="float32"),
     Case("sqrt[int]", args=(i(3, 4),), port_dtype="float32"),
     Case("round[half]", args=(np.array([0.5, 1.5, 2.5, -0.5], np.float32),)),
     Case("isnan[nan]", args=(np.array([np.nan, 1.0, np.inf], np.float32),)),
     Case("isinf[inf]", args=(np.array([np.nan, 1.0, -np.inf], np.float32),)),
     ] +
    [Case(n, args=(f(3, 4), f(4)), grad=True)
     for n in ("add", "subtract", "multiply", "maximum", "minimum", "fmax",
               "fmin", "atan2", "hypot", "logaddexp")] +
    [Case("divide", args=(f(3, 4), f(4, lo=0.5, hi=2.0)), grad=True),
     Case("true_divide", args=(f(3, 4), f(4, lo=0.5, hi=2.0)), grad=True),
     Case("divide[int]", args=(i(3, 4), i(4, lo=1, hi=4)),
          port_dtype="float32"),
     Case("floor_divide", args=(f(3, 4), f(4, lo=0.5, hi=2.0))),
     Case("floor_divide[int]", args=(i(3, 4, lo=-9, hi=9),
                                     i(4, lo=1, hi=4))),
     Case("mod", args=(f(3, 4), f(4, lo=0.5, hi=2.0))),
     Case("remainder[int]", args=(i(3, 4, lo=-9, hi=9), i(4, lo=1, hi=4))),
     Case("floor_mod", args=(i(3, 4, lo=-9, hi=9), i(4, lo=1, hi=4))),
     Case("pow", args=(f(3, 4, lo=0.5, hi=2.0), f(4)), grad=True),
     Case("pow[scalar]", args=(f(3, 4), 2.0), grad=True),
     Case("add[scalar]", args=(f(3, 4), 2.0), grad=True),
     Case("multiply[int_scalar]", args=(i(3, 4), 3)),
     Case("subtract[int]", args=(i(3, 4), i(3, 4))),
     Case("heaviside", args=(np.array([-1.0, 0.0, 2.0], np.float32),
                             np.array([0.5, 0.5, 0.5], np.float32))),
     Case("copysign", args=(f(3, 4), f(3, 4)), grad=True),
     Case("nextafter", args=(f(3, 4), f(3, 4))),
     Case("ldexp", args=(f(3, 4), i(3, 4, dtype=np.int32))),
     Case("gcd", args=(i(3, 4, lo=1, hi=30), i(3, 4, lo=1, hi=30))),
     Case("lcm", args=(i(3, 4, lo=1, hi=12), i(3, 4, lo=1, hi=12))),
     Case("gammainc", args=(f(3, 4, lo=0.5, hi=3.0),
                            f(3, 4, lo=0.5, hi=3.0)), tol=1e-4),
     Case("gammaincc", args=(f(3, 4, lo=0.5, hi=3.0),
                             f(3, 4, lo=0.5, hi=3.0)), tol=1e-4)] +
    [Case(n, args=(i(3, 4), i(4))) for n in (
        "equal", "not_equal", "less_than", "less_equal", "greater_than",
        "greater_equal", "bitwise_and", "bitwise_or", "bitwise_xor")] +
    [Case(n + "[float]", args=(f(3, 4), f(4))) for n in (
        "equal", "less_than", "greater_equal")] +
    [Case(n, args=(b(3, 4), b(4))) for n in (
        "logical_and", "logical_or", "logical_xor")] +
    [Case(n, args=(i(3, 4, lo=0, hi=64), i(4, lo=0, hi=4)))
     for n in ("bitwise_left_shift", "bitwise_right_shift")] +
    [Case(f"{n}[{tag}]", args=(f(2, 3, 4),), kw=kw, grad=g)
     for n, g in (("sum", True), ("mean", True), ("prod", True),
                  ("max", True), ("min", True), ("amax", True),
                  ("amin", True), ("nanmean", True), ("nansum", True),
                  ("logsumexp", True))
     for tag, kw in (("all", {}), ("axis1_keep", dict(axis=1, keepdim=True)),
                     ("axes02", dict(axis=[0, 2])))] +
    [Case(f"{n}[{tag}]", args=(b(2, 3, 4),), kw=kw)
     for n in ("all", "any")
     for tag, kw in (("all", {}), ("axis1", dict(axis=1)))] +
    [Case("count_nonzero", args=(i(2, 3, 4, lo=0, hi=2),), kw=dict(axis=1)),
     Case("count_nonzero[keep]", args=(i(2, 3, 4, lo=0, hi=2),),
          kw=dict(axis=[0, 2], keepdim=True)),
     Case("sum[int32]", args=(i(3, 4, dtype=np.int32),)),
     Case("sum[bool]", args=(b(3, 4),), kw=dict(axis=0)),
     Case("sum[dtype]", args=(i(3, 4, dtype=np.int32),),
          kw=dict(dtype="int32")),
     Case("prod[int]", args=(i(3, 4, lo=1, hi=3),), kw=dict(axis=0)),
     Case("max[int]", args=(i(3, 4),), kw=dict(axis=-1)),
     Case("nanmean[nan]", args=(np.array([[1.0, np.nan], [3.0, 4.0]],
                                         np.float32),), kw=dict(axis=1)),
     Case("mean[int]", args=(i(3, 4),), port_dtype="float32")])

MATH = [
    Case("scale", args=(f(3, 4),), kw=dict(scale=2.0, bias=1.0), grad=True),
    Case("scale[before]", args=(f(3, 4),),
         kw=dict(scale=2.0, bias=1.0, bias_after_scale=False), grad=True),
    Case("multiplex", call=lambda M, a, c, idx: M.multiplex([a, c], idx),
         args=(f(4, 3), f(4, 3), i(4, 1, lo=0, hi=2))),
    Case("clip", args=(f(3, 4),), kw=dict(min=-0.5, max=0.5), grad=True),
    Case("clip[min]", args=(f(3, 4),), kw=dict(min=0.0)),
    Case("lerp", args=(f(3, 4), f(3, 4), 0.3), grad=True),
    Case("lerp[tensor]", args=(f(3, 4), f(3, 4), f(3, 4, lo=0, hi=1)),
         grad=True),
    Case("stanh", args=(f(3, 4),), grad=True),
    Case("std", args=(f(3, 5),), grad=True),
    Case("std[axis]", args=(f(3, 5),), kw=dict(axis=1, unbiased=False,
                                              keepdim=True), grad=True),
    Case("var", args=(f(3, 5),), kw=dict(axis=0), grad=True),
    Case("median", args=(f(4, 6),), grad=True),
    Case("median[axis]", args=(f(4, 6),), kw=dict(axis=1, keepdim=True)),
    Case("quantile", args=(f(4, 6), 0.3), kw=dict(axis=1)),
    Case("quantile[list]", args=(f(4, 6), [0.2, 0.7])),
    Case("quantile[axes]", args=(f(3, 4, 5), 0.5),
         kw=dict(axis=[0, 2], keepdim=True)),
    Case("nanmedian", args=(np.array([[1.0, np.nan, 3.0, 2.0],
                                      [4.0, 5.0, np.nan, np.nan]],
                                     np.float32),), kw=dict(axis=1)),
    Case("cumsum", args=(f(3, 4),), grad=True),
    Case("cumsum[axis]", args=(f(3, 4),), kw=dict(axis=1), grad=True),
    Case("cumsum[int]", args=(i(3, 4),), kw=dict(axis=0)),
    Case("cumprod", args=(f(3, 4, lo=0.5, hi=1.5),), kw=dict(dim=1),
         grad=True),
    Case("cummax", args=(i(3, 6, lo=0, hi=4).astype(np.float32),),
         kw=dict(axis=1)),
    Case("cummin", args=(f(3, 6),), kw=dict(axis=0)),
    Case("cummax[flat]", args=(f(3, 4),)),
    Case("logcumsumexp", args=(f(3, 4),), kw=dict(axis=1), grad=True),
    Case("logcumsumexp[flat]", args=(f(3, 4),), grad=True),
    Case("argmax", args=(f(3, 4),)),
    Case("argmax[axis]", args=(f(3, 4),), kw=dict(axis=1, keepdim=True)),
    Case("argmin", args=(f(3, 4),), kw=dict(axis=0)),
    Case("argmin[int32]", args=(f(3, 4),), kw=dict(axis=0, dtype="int32")),
    Case("allclose", args=(f(3, 4), f(3, 4))),
    Case("allclose[same]", call=lambda M, a: M.allclose(a, a),
         args=(f(3, 4),)),
    Case("isclose", args=(f(3, 4), f(3, 4)), kw=dict(atol=1.0)),
    Case("equal_all", args=(i(3, 4), i(3, 4))),
    Case("equal_all[same]", call=lambda M, a: M.equal_all(a, a),
         args=(i(3, 4),)),
    Case("kron", args=(f(2, 3), f(3, 2)), grad=True),
    Case("diff", args=(f(3, 5),), grad=True),
    Case("diff[n2]", args=(f(3, 5),), kw=dict(n=2, axis=0)),
    Case("diff[prepend]", args=(f(3, 5), f(3, 1)),
         call=lambda M, a, p: M.diff(a, prepend=p)),
    Case("trapezoid", args=(f(3, 5),), kw=dict(dx=0.5), grad=True),
    Case("trapezoid[x]", call=lambda M, y, x: M.trapezoid(y, x=x),
         args=(f(3, 5), np.sort(f(5)))),
    Case("nan_to_num", args=(np.array([np.nan, np.inf, -np.inf, 1.0],
                                      np.float32),), kw=dict(nan=0.5)),
    Case("renorm", args=(f(3, 4), 2.0, 0, 1.0), grad=True),
    Case("addmm", args=(f(3, 2), f(3, 4), f(4, 2)), kw=dict(beta=0.5,
                                                           alpha=2.0),
         grad=True),
    Case("polygamma", args=(f(3, 4, lo=0.5, hi=3.0), 1), grad=True,
         tol=1e-4),
]

CREATION = [
    Case("zeros", call=lambda M: M.zeros([2, 3])),
    Case("zeros[int]", call=lambda M: M.zeros([2, 3], "int32")),
    Case("ones", call=lambda M: M.ones([2, 3], "int64")),
    Case("full", call=lambda M: M.full([2, 3], 1.5)),
    Case("full[int]", call=lambda M: M.full([2, 3], 7)),
    Case("full[bool]", call=lambda M: M.full([2], True)),
    Case("zeros_like", args=(f(2, 3),)),
    Case("ones_like", args=(i(2, 3),), kw=dict(dtype="float32")),
    Case("full_like", args=(f(2, 3), 2.5)),
    Case("empty", call=lambda M: M.empty([2, 3])),
    Case("empty_like", args=(i(2, 3),)),
    Case("arange", call=lambda M: M.arange(5)),
    Case("arange[start]", call=lambda M: M.arange(2, 11, 3)),
    Case("arange[float]", call=lambda M: M.arange(0.0, 1.0, 0.25)),
    Case("arange[dtype]", call=lambda M: M.arange(0, 4, 1, "float32")),
    Case("linspace", call=lambda M: M.linspace(0.0, 1.0, 5)),
    Case("logspace", call=lambda M: M.logspace(0.0, 2.0, 3), tol=1e-5),
    Case("eye", call=lambda M: M.eye(3, 4)),
    Case("eye[square]", call=lambda M: M.eye(3)),
    Case("diag", args=(f(3),), grad=True),
    Case("diag[offset]", args=(f(3),), kw=dict(offset=1)),
    Case("diag[padding]", args=(f(3),), kw=dict(padding_value=2.0)),
    Case("diag[2d]", args=(f(3, 4),), kw=dict(offset=-1), grad=True),
    Case("diagflat", args=(f(2, 2),), kw=dict(offset=1)),
    Case("tril", args=(f(3, 4),), grad=True),
    Case("triu", args=(f(3, 4),), kw=dict(diagonal=1), grad=True),
    Case("meshgrid", call=lambda M, a, c: M.meshgrid(a, c),
         args=(f(3), f(4))),
    Case("meshgrid[list]", call=lambda M, a, c: M.meshgrid([a, c]),
         args=(f(2), f(3))),
    Case("assign", args=(f(2, 3),)),
    Case("clone", args=(f(2, 3),), grad=True),
    Case("complex", args=(f(3), f(3))),
    Case("tril_indices", call=lambda M: M.tril_indices(4, 3, 0)),
    Case("triu_indices", call=lambda M: M.triu_indices(3, 4, 1)),
    Case("to_tensor", call=lambda M: M.to_tensor([[1.0, 2.0], [3.0, 4.0]])),
    Case("to_tensor[int]", call=lambda M: M.to_tensor([1, 2, 3])),
    Case("to_tensor[dtype]", call=lambda M: M.to_tensor([1, 2],
                                                        dtype="float32")),
]

_TIES = np.array([[3.0, 1.0, 2.0, 1.0, 3.0], [0.0, 5.0, 5.0, -1.0, 2.0]],
                 np.float32)
SEARCH = [
    Case("sort", args=(f(3, 5),), grad=True),
    Case("sort[desc]", args=(f(3, 5),), kw=dict(axis=0, descending=True),
         grad=True),
    Case("argsort", args=(_TIES,)),
    Case("argsort[desc]", args=(_TIES,), kw=dict(descending=True)),
    Case("topk", args=(f(3, 6), 2), grad=True),
    Case("topk[small]", args=(f(3, 6), 3),
         kw=dict(axis=0, largest=False)),
    Case("kthvalue", args=(f(3, 6), 2)),
    Case("kthvalue[keep]", args=(_TIES, 3), kw=dict(axis=1, keepdim=True)),
    Case("mode", args=(np.array([[1.0, 2.0, 2.0, 3.0, 3.0],
                                 [4.0, 4.0, 1.0, 1.0, 0.0]], np.float32),)),
    Case("mode[int]", args=(i(4, 6, lo=0, hi=3),), kw=dict(axis=0)),
    Case("index_select[search]", args=(f(4, 3), np.array([2, 0, 2])),
         call=lambda M, x, idx: M.index_select(x, idx, axis=0)),
    Case("masked_select", args=(f(3, 4), b(3, 4))),
    Case("where", args=(b(3, 4), f(3, 4), f(3, 4)), grad=True),
    Case("where[scalar]", call=lambda M, c, x: M.where(c, x, 0.0),
         args=(b(3, 4), f(3, 4))),
    Case("where[nonzero]", call=lambda M, c: M.where(c), args=(b(3, 4),)),
    Case("nonzero", args=(b(3, 4),)),
    Case("nonzero[tuple]", args=(b(3, 4),), kw=dict(as_tuple=True)),
    Case("bucketize", args=(f(3, 4), np.sort(f(6)))),
    Case("searchsorted", args=(np.sort(f(6)), f(3, 4)), kw=dict(right=True)),
    Case("searchsorted[int32]", args=(np.sort(f(6)), f(5)),
         kw=dict(out_int32=True)),
]

def _amp_case(name, level, fn, *args, tol=1e-2):
    """``fn(M, *args)`` under ``amp.auto_cast(level, bfloat16)``; an input
    named in ``bf16`` goes in as bfloat16."""
    def call(M, *a):
        a = [v.astype("bfloat16") if k in bf16 else v
             for k, v in enumerate(a)]
        with M.amp.auto_cast(level=level, dtype="bfloat16"):
            return fn(M, *a)
    bf16 = {k for k, v in enumerate(args) if isinstance(v, tuple)}
    args = tuple(v[0] if isinstance(v, tuple) else v for v in args)
    return Case(f"{name}[amp_{level}]", call=call, args=args, tol=tol)


# each op casts under autocast as the reference's op of the same name does
# (a tuple marks a bfloat16 input)
AMP = [
    _amp_case("matmul", "O1", lambda M, x, y: M.matmul(x, y),
              f(3, 8), f(8, 4)),
    _amp_case("exp", "O1", lambda M, x: M.exp(x), (f(3, 4),)),
    _amp_case("sum", "O2", lambda M, x: M.sum(x, axis=1), (f(3, 4),)),
    _amp_case("cumsum", "O1", lambda M, x: M.cumsum(x, axis=1), (f(3, 4),)),
    _amp_case("norm", "O1", lambda M, x: M.norm(x), (f(3, 4),)),
    _amp_case("sin", "O1", lambda M, x: M.sin(x), f(3, 4)),
    _amp_case("sin", "O2", lambda M, x: M.sin(x), f(3, 4)),
    _amp_case("reshape", "O2", lambda M, x: M.reshape(x, [4, 3]), f(3, 4)),
    _amp_case("concat", "O2", lambda M, x, y: M.concat([x, y]),
              f(2, 4), f(1, 4)),
    _amp_case("getitem", "O2", lambda M, x: x[1:], f(3, 4)),
    _amp_case("clip", "O2", lambda M, x: M.clip(x, -0.5, 0.5), f(3, 4)),
    _amp_case("sort", "O2", lambda M, x: M.sort(x), f(3, 4)),
    _amp_case("dist", "O2", lambda M, x, y: M.dist(x, y), f(3, 4), f(3, 4)),
    _amp_case("einsum", "O1", lambda M, x, y: M.einsum("ij,jk->ik", x, y),
              f(3, 8), f(8, 4)),
    _amp_case("add", "O1", lambda M, x, y: x + y, f(3, 4), (f(3, 4),)),
    _amp_case("add", "O2", lambda M, x, y: x + y, f(3, 4), (f(3, 4),)),
]

CASES = TABLE + MATH + CREATION + SEARCH + AMP


@pytest.fixture(scope="module")
def ref():
    return reference(CASES)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op(case, ref):
    hold(case, ref)


def test_autocast_table_is_the_references():
    """The port's ops cast under autocast by the names the reference's
    ``apply_op`` calls carry (``_prim.AMP_NAMES``), read from the
    reference's sources."""
    import ast
    import pathlib
    want = {}
    for path in sorted(pathlib.Path(P.ops.__path__[0]).glob("*.py")):
        mod = path.stem
        if mod in ("gen", "coverage", "_generated", "_prim", "__init__"):
            continue
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, ast.FunctionDef) or \
                    node.name.startswith("_"):
                continue
            names = {c.args[0].value for c in ast.walk(node)
                     if isinstance(c, ast.Call) and
                     getattr(c.func, "id", None) == "apply_op" and c.args and
                     isinstance(c.args[0], ast.Constant)}
            if names:
                (name,) = names
                want.setdefault(mod, set()).add(
                    node.name if name == node.name else
                    f"{node.name}={name}")
    from paddle_tpu_torch.ops._prim import AMP_NAMES
    assert {m: set(v.split()) for m, v in AMP_NAMES.items()} == want


def test_every_case_id_is_unique():
    names = ids(CASES)
    assert len(names) == len(set(names))
