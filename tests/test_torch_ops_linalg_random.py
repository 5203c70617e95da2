"""The port's linear algebra (``ops/linalg.py`` and the ``paddle.linalg``
namespace), random ops (``ops/random_ops.py``), the rest of the op
surface (``ops/extras.py``) and the in-place ``op_`` family against the
JAX package, on the CPU, with the harness of ``test_torch_ops_table.py``.

Decompositions with a sign or phase freedom (``qr``, ``svd``, ``eig``,
``eigh``, ``pca_lowrank``, ``svd_lowrank``) are held by reconstruction and
orthogonality; random draws come from another generator than the
reference's threefry stream, so they are held by shape, dtype, support and
moments.  Each ``op_`` runs on a non-leaf: it returns its input, holds the
value of the reference's op and passes the gradient through.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from test_torch_ops_table import (Case, b, close, f, hold, i, ids,  # noqa: F401
                                  on_cpu, reference, seed)

torch.set_num_threads(2)
seed(2502)


def _spd(n):
    a = f(n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _recon(which):
    """A check of a decomposition by reconstruction (and orthogonality)."""
    def check(got, want):
        g = [_np(v) for v in got]
        w = [np.asarray(v) for v in want]
        assert [v.shape for v in g] == [v.shape for v in w]
        assert [v.dtype for v in g] == [v.dtype for v in w]
        if which == "qr":
            q, r = g
            close(q @ r, w[0] @ w[1], 1e-5)
            close(q.T @ q, np.eye(q.shape[1]), 1e-5)
        elif which == "svd":
            u, s, vh = g
            close(s, w[1], 1e-5)
            close((u * s) @ vh, (w[0] * w[1]) @ w[2], 1e-5)
        elif which == "eigh":
            vals, vecs = g
            close(vals, w[0], 1e-4)
            close((vecs * vals) @ vecs.T, (w[1] * w[0]) @ w[1].T, 1e-4)
        elif which == "eig":
            vals, vecs = g
            close(np.sort_complex(vals), np.sort_complex(w[0]), 1e-4)
            a = A_EIG.astype(np.complex64)
            close(a @ vecs, vecs * vals, 1e-4)
        elif which == "pca":
            u, s, v = g
            close(s, w[1], 1e-5)
            close((u * s) @ v.T, (w[0] * w[1]) @ w[2].T, 1e-5)
    return check


A_EIG = f(4, 4)
_SQ = f(4, 4) + 4 * np.eye(4, dtype=np.float32)
_LOW = (f(6, 2) @ f(2, 5)).astype(np.float32)
_GEQRF = torch.geqrf(torch.from_numpy(f(5, 3)))
_HH, _TAU = _GEQRF[0].numpy(), _GEQRF[1].numpy()

LINALG = [
    Case("matmul", args=(f(3, 4), f(4, 5)), grad=True),
    Case("matmul[batched_t]", args=(f(2, 4, 3), f(2, 5, 4)),
         kw=dict(transpose_x=True, transpose_y=True), grad=True),
    Case("matmul[vec]", args=(f(3, 4), f(4)), grad=True),
    Case("mm", args=(f(3, 4), f(4, 2)), grad=True),
    Case("dot", args=(f(5), f(5)), grad=True),
    Case("dot[batch]", args=(f(3, 5), f(3, 5))),
    Case("inner", args=(f(3, 4), f(2, 4)), grad=True),
    Case("outer", args=(f(3), f(4)), grad=True),
    Case("bmm", args=(f(2, 3, 4), f(2, 4, 2)), grad=True),
    Case("mv", args=(f(3, 4), f(4)), grad=True),
    Case("t", args=(f(3, 4),), grad=True),
    Case("t[1d]", args=(f(3),)),
    Case("cross", args=(f(3, 4), f(3, 4)), grad=True),
    Case("cross[axis]", args=(f(2, 3), f(2, 3)), kw=dict(axis=1)),
    Case("norm", args=(f(3, 4),), grad=True),
    Case("norm[p1]", args=(f(3, 4),), kw=dict(p=1, axis=1), grad=True),
    Case("norm[inf]", args=(f(3, 4),), kw=dict(p=float("inf"))),
    Case("norm[p3]", args=(f(3, 4),), kw=dict(p=3), grad=True),
    Case("norm[p0]", args=(f(3, 4),), kw=dict(p=0)),
    Case("norm[nuc]", args=(f(3, 4),), kw=dict(p="nuc", axis=[0, 1])),
    Case("norm[keep]", args=(f(3, 4),), kw=dict(keepdim=True)),
    Case("vector_norm", args=(f(3, 4),), kw=dict(p=3.0, axis=1), grad=True),
    Case("matrix_norm", args=(f(2, 3, 4),), grad=True),
    Case("matrix_norm[1]", args=(f(3, 4),), kw=dict(p=1)),
    Case("dist", args=(f(3, 4), f(3, 4)), grad=True),
    Case("transpose[linalg]", call=lambda M, x: M.linalg.transpose(x, [1, 0]),
         args=(f(3, 4),)),
    Case("histogram", args=(f(50),), kw=dict(bins=5)),
    Case("histogram[range]", args=(f(50),), kw=dict(bins=4, min=-1, max=1)),
    Case("histogramdd", args=(f(30, 2),), kw=dict(bins=3)),
    Case("matrix_power", args=(f(3, 3), 3), grad=True, tol=1e-4),
    Case("qr", args=(f(5, 3),), check=_recon("qr")),
    Case("svd", args=(f(5, 3),), check=_recon("svd")),
    Case("pca_lowrank", args=(f(6, 4),), kw=dict(q=2), check=_recon("pca")),
    Case("eig", args=(A_EIG,), check=_recon("eig")),
    Case("eigh", args=(_spd(4),), check=_recon("eigh")),
    Case("eigvals", args=(A_EIG,),
         check=lambda g, w: close(np.sort_complex(_np(g[0])),
                                  np.sort_complex(w[0]), 1e-4)),
    Case("eigvalsh", args=(_spd(4),), tol=1e-4),
    Case("det", args=(_SQ,), grad=True, tol=1e-4),
    Case("slogdet", args=(_SQ,), grad=True),
    Case("inv", args=(_SQ,), grad=True, tol=1e-4),
    Case("pinv", args=(f(4, 3),), grad=True, tol=1e-4),
    Case("solve", args=(_SQ, f(4, 2)), grad=True, tol=1e-4),
    Case("triangular_solve", args=(np.triu(_SQ), f(4, 2)), grad=True,
         tol=1e-4),
    Case("triangular_solve[lower_t]", args=(np.tril(_SQ), f(4, 2)),
         kw=dict(upper=False, transpose=True, unitriangular=True),
         tol=1e-4),
    Case("cholesky", args=(_spd(4),), grad=True, tol=1e-4),
    Case("cholesky[upper]", args=(_spd(4),), kw=dict(upper=True),
         tol=1e-4),
    Case("cholesky_solve", args=(f(4, 2), np.linalg.cholesky(_spd(4))
                                 .astype(np.float32)), tol=1e-4),
    Case("lu", args=(_SQ,), tol=1e-5),
    Case("lu[infos]", args=(_SQ,), kw=dict(get_infos=True)),
    Case("matrix_rank", args=(_LOW,)),
    Case("lstsq", args=(f(6, 3), f(6, 2)), tol=1e-4),
    Case("cov", args=(f(3, 6),), grad=True),
    Case("cov[cols]", args=(f(6, 3),), kw=dict(rowvar=False, ddof=False)),
    Case("corrcoef", args=(f(3, 6),), grad=True, tol=1e-4),
    Case("trace", args=(f(4, 4),), kw=dict(offset=1), grad=True),
    Case("trace[axes]", args=(f(2, 3, 3),), kw=dict(axis1=1, axis2=2)),
    Case("einsum", call=lambda M, a, c: M.einsum("bij,bjk->bik", a, c),
         args=(f(2, 3, 4), f(2, 4, 2)), grad=True),
    Case("multi_dot", call=lambda M, a, c, d: M.multi_dot([a, c, d]),
         args=(f(3, 4), f(4, 5), f(5, 2)), grad=True),
    Case("cond", args=(_SQ,), tol=1e-4),
    Case("cond[nuc]", args=(_SQ,), kw=dict(p="nuc"), tol=1e-4),
    Case("ormqr", args=(_HH, _TAU, f(5, 2)), tol=1e-5),
    Case("ormqr[right_t]", args=(_HH, _TAU, f(2, 5)),
         kw=dict(left=False, transpose=True), tol=1e-5),
    Case("householder_product", args=(_HH, _TAU), tol=1e-5),
    Case("lu_unpack", call=lambda M, a: M.lu_unpack(*M.lu(a)),
         args=(_SQ,)),
    Case("fp8_fp8_half_gemm_fused", call=lambda M, a, c, d:
         M.linalg.fp8_fp8_half_gemm_fused(a, c, d, transpose_y=True,
                                          scale=0.5),
         args=(f(4, 8), f(3, 8), f(3)), tol=1e-3),
    Case("cholesky_inverse[linalg]", call=lambda M, a:
         M.linalg.cholesky_inverse(a),
         args=(np.linalg.cholesky(_spd(3)).astype(np.float32),), tol=1e-4),
    Case("matrix_exp[linalg]", call=lambda M, a: M.linalg.matrix_exp(a),
         args=(f(3, 3) * 0.3,), tol=1e-5),
]


def _moments(mean=None, std=None, lo=None, hi=None, integral=False,
             tol=0.05, port_dtype=None):
    """A draw's check: the reference's shape and dtype (or the port's own,
    ``port_dtype``, ROADMAP Queue 3), the support [lo, hi] and the first
    two moments."""
    def check(got, want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert isinstance(g, T.Tensor)
            assert tuple(g.shape) == np.shape(w)
            assert str(g.dtype).replace("torch.", "") == \
                (port_dtype or np.asarray(w).dtype.name)
        v = _np(got[0]).astype(np.float64)
        if lo is not None:
            assert v.min() >= lo
        if hi is not None:
            assert v.max() <= hi
        if integral:
            assert (v == np.round(v)).all()
        if mean is not None:
            assert abs(v.mean() - mean) < tol * max(1.0, abs(mean)), v.mean()
        if std is not None:
            assert abs(v.std() - std) < tol * max(1.0, std), v.std()
    return check


_N = [100, 200]
RANDOM = [Case(n, call=c, args=a, check=k, eager=True) for n, c, a, k in (
    ("randn", lambda M: M.randn(_N), (), _moments(0.0, 1.0)),
    ("rand", lambda M: M.rand(_N), (), _moments(0.5, 12 ** -0.5, 0, 1)),
    ("uniform", lambda M: M.uniform(_N, min=2.0, max=4.0), (),
     _moments(3.0, 2 * 12 ** -0.5, 2, 4)),
    ("uniform[seed]", lambda M: M.uniform(_N, seed=3), (),
     _moments(0.0, 2 * 12 ** -0.5, -1, 1)),
    ("normal", lambda M: M.normal(1.0, 2.0, _N), (), _moments(1.0, 2.0)),
    ("normal[tensor]", lambda M, m: M.normal(m, 0.5),
     (np.full(_N, 3.0, np.float32),),
     _moments(3.0, 0.5, port_dtype="float32")),
    ("gaussian", lambda M: M.gaussian(_N, mean=-1.0, std=0.5), (),
     _moments(-1.0, 0.5)),
    ("standard_normal", lambda M: M.standard_normal(_N), (),
     _moments(0.0, 1.0)),
    ("randint", lambda M: M.randint(0, 10, _N), (),
     _moments(4.5, (99 / 12) ** 0.5, 0, 9, True)),
    ("randint_like", lambda M, x: M.randint_like(x, 3, 7), (i(100, 200),),
     _moments(4.5, (15 / 12) ** 0.5, 3, 6, True)),
    ("randperm", lambda M: M.randperm(1000), (),
     lambda g, w: np.testing.assert_array_equal(np.sort(_np(g[0])),
                                                np.arange(1000))),
    ("multinomial", lambda M, p: M.multinomial(p, 4000, True),
     (np.array([0.2, 0.3, 0.5], np.float32),),
     lambda g, w: close(np.bincount(_np(g[0]), minlength=3) / 4000.0,
                        [0.2, 0.3, 0.5], 0.05)),
    ("multinomial[no_repl]", lambda M, p: M.multinomial(p, 3),
     (np.array([[0.2, 0.3, 0.5, 0.0]] * 50, np.float32),),
     lambda g, w: [np.testing.assert_array_equal(np.sort(r), [0, 1, 2])
                   for r in _np(g[0])]),
    ("bernoulli", lambda M, p: M.bernoulli(p),
     (np.full(_N, 0.3, np.float32),), _moments(0.3, None, 0, 1, True)),
    ("poisson", lambda M, lam: M.poisson(lam),
     (np.full(_N, 4.0, np.float32),), _moments(4.0, 2.0, 0, None, True)),
    ("binomial", lambda M, n, p: M.binomial(n, p),
     (np.full(_N, 10, np.int64), np.full(_N, 0.3, np.float32)),
     _moments(3.0, 21 ** 0.5 / 10 ** 0.5, 0, 10, True)),
    ("exponential_", lambda M, x: M.exponential_(x, 2.0),
     (np.zeros(_N, np.float32),), _moments(0.5, 0.5, 0)),
    ("normal_", lambda M, x: M.normal_(x, 1.0, 3.0),
     (np.zeros(_N, np.float32),), _moments(1.0, 3.0)),
    ("uniform_", lambda M, x: M.uniform_(x, 0.0, 2.0),
     (np.zeros(_N, np.float32),), _moments(1.0, 2 * 12 ** -0.5, 0, 2)),
    ("rand_like", lambda M, x: M.rand_like(x), (f(100, 200),),
     _moments(0.5, 12 ** -0.5, 0, 1)),
    ("randn_like", lambda M, x: M.randn_like(x), (f(100, 200),),
     _moments(0.0, 1.0)),
    ("log_normal", lambda M: M.log_normal(0.0, 0.5, _N), (),
     lambda g, w: _moments(0.0, 0.5)([T.log(g[0])], w)),
    ("standard_gamma", lambda M, a: M.standard_gamma(a),
     (np.full(_N, 3.0, np.float32),),
     _moments(3.0, 3 ** 0.5, 0, port_dtype="float32")),
    ("svd_lowrank", lambda M, a: M.svd_lowrank(a, q=2), (_LOW,),
     lambda g, w: close((_np(g[0]) * _np(g[1])) @ _np(g[2]).T, _LOW,
                        1e-4)),
    ("top_p_sampling[draws]", lambda M, p, ps: M.top_p_sampling(p, ps),
     (np.tile(np.array([[0.1, 0.5, 0.4]], np.float32), (2000, 1)),
      np.full([2000], 0.8, np.float32)),
     lambda g, w: close(np.bincount(_np(g[1])[:, 0], minlength=3) / 2000.0,
                        [0.0, 0.5 / 0.9, 0.4 / 0.9], 0.06)),
)]


EXTRAS = [
    Case("vander", args=(f(4),), kw=dict(n=3), grad=True),
    Case("vander[inc]", args=(f(3),), kw=dict(increasing=True)),
    Case("fill_constant", call=lambda M: M.fill_constant([2, 3], "int32", 4)),
    Case("block_diag", call=lambda M, a, c: M.block_diag([a, c]),
         args=(f(2, 2), f(1, 3)), grad=True),
    Case("polar", args=(f(3, lo=0.5, hi=2), f(3))),
    Case("sgn", args=(f(3, 4),)),
    Case("add_n", call=lambda M, a, c, d: M.add_n([a, c, d]),
         args=(f(3, 4), f(3, 4), f(3, 4)), grad=True),
    Case("increment", call=lambda M, x: M.increment(x, 2.0),
         args=(f(1),)),
    Case("take", args=(f(3, 4), np.array([[0, 5], [-1, 11]])), grad=True),
    Case("take[wrap]", args=(f(3, 4), np.array([13, -14])),
         kw=dict(mode="wrap")),
    Case("take[clip]", args=(f(3, 4), np.array([20, -3])),
         kw=dict(mode="clip")),
    Case("isin", args=(i(3, 4), np.array([1, 3]))),
    Case("isin[invert]", args=(i(3, 4), np.array([1, 3])),
         kw=dict(invert=True)),
    Case("isneginf", args=(np.array([-np.inf, 0.0, np.inf], np.float32),)),
    Case("isposinf", args=(np.array([-np.inf, 0.0, np.inf], np.float32),)),
    Case("isreal[extras]", call=lambda M, x: M.isreal(x), args=(f(3),)),
    Case("nanquantile", args=(np.array([[1.0, np.nan, 3.0, 2.0],
                                        [4.0, 5.0, 7.0, np.nan]],
                                       np.float32), 0.25),
         kw=dict(axis=1)),
    Case("histogram_bin_edges", args=(f(20),), kw=dict(bins=4)),
    Case("histogram_bin_edges[range]", args=(f(20),),
         kw=dict(bins=3, min=-2, max=1)),
    Case("cumulative_trapezoid", args=(f(3, 5),), kw=dict(dx=0.5),
         grad=True),
    Case("cumulative_trapezoid[x]", call=lambda M, y, x:
         M.cumulative_trapezoid(y, x=x), args=(f(5), np.sort(f(5)))),
    Case("frexp", args=(f(3, 4) * 10,)),
    Case("multigammaln", args=(f(3, lo=2.0, hi=4.0), 3), grad=True,
         tol=1e-5),
    Case("matrix_exp", args=(f(3, 3) * 0.3,), grad=True, tol=1e-5),
    Case("cholesky_inverse", args=(np.linalg.cholesky(_spd(3))
                                   .astype(np.float32),), tol=1e-4),
    Case("cholesky_inverse[upper]", args=(np.linalg.cholesky(_spd(3)).T
                                          .astype(np.float32),),
         kw=dict(upper=True), tol=1e-4),
    Case("cdist", args=(f(4, 3), f(5, 3)), grad=True),
    Case("cdist[p1]", args=(f(4, 3), f(5, 3)), kw=dict(p=1.0)),
    Case("cdist[inf]", args=(f(4, 3), f(5, 3)), kw=dict(p=float("inf"))),
    Case("cartesian_prod", call=lambda M, a, c: M.cartesian_prod([a, c]),
         args=(i(3), i(2))),
    Case("combinations", args=(f(4),), grad=True),
    Case("combinations[repl]", args=(i(3),),
         kw=dict(r=3, with_replacement=True)),
    Case("diagonal_scatter", args=(f(3, 4), f(3)), kw=dict(offset=1),
         grad=True),
    Case("select_scatter", args=(f(3, 4), f(4), 0, 1), grad=True),
    Case("slice_scatter", args=(f(5, 4), f(2, 4), [0], [1], [5], [2]),
         grad=True),
    Case("masked_scatter", args=(f(3, 4), b(3, 4), f(12)), grad=True),
    Case("is_floating_point", args=(f(2),)),
    Case("is_integer", args=(i(2),)),
    Case("is_complex", args=(f(2),)),
    Case("is_empty", args=(f(0, 3),)),
    Case("view_as", args=(f(3, 4), f(6, 2)), grad=True),
    Case("unfold", args=(f(3, 8), 1, 3, 2), grad=True),
]


# (op_, its inputs) for the reference's op_ family; the first input is
# made a non-leaf (x * 1) before the call
_P = f(3, 4, lo=0.5, hi=2.0)
_U = f(3, 4, lo=-0.9, hi=0.9)
_INPLACE_ARGS = dict(
    [(n, (f(3, 4),)) for n in (
        "abs", "atan", "ceil", "cos", "cosh", "exp", "expm1", "floor", "neg",
        "round", "sigmoid", "sin", "sinh", "square", "tan", "tanh", "trunc",
        "frac", "erf", "asinh", "sinc", "nan_to_num")] +
    [(n, (_P,)) for n in ("log", "log2", "log10", "log1p", "reciprocal",
                          "rsqrt", "sqrt", "digamma", "lgamma", "gammaln",
                          "i0")] +
    [(n, (_U,)) for n in ("acos", "asin", "atanh", "erfinv")] +
    [("acosh", (_P + 1,)), ("logit", (f(3, 4, lo=0.1, hi=0.9),))] +
    [(n, (f(3, 4), f(3, 4))) for n in (
        "add", "subtract", "multiply", "copysign", "hypot")] +
    [(n, (f(3, 4), _P)) for n in ("divide", "floor_divide", "remainder")] +
    [("pow", (_P, f(3, 4))), ("ldexp", (f(3, 4), i(3, 4, dtype=np.int32))),
     ("gcd", (i(3, 4, lo=1, hi=20), i(3, 4, lo=1, hi=20))),
     ("lcm", (i(3, 4, lo=1, hi=9), i(3, 4, lo=1, hi=9))),
     ("clip", (f(3, 4), -0.5, 0.5)), ("lerp", (f(3, 4), f(3, 4), 0.25))] +
    [(n, (b(3, 4), b(3, 4))) for n in (
        "logical_and", "logical_or", "logical_xor")] +
    [("logical_not", (b(3, 4),)), ("bitwise_not", (i(3, 4),))] +
    [(n, (i(3, 4), i(3, 4))) for n in (
        "bitwise_and", "bitwise_or", "bitwise_xor", "equal", "not_equal",
        "greater_equal", "greater_than", "less_equal", "less_than")] +
    [("cumsum", (f(3, 4), 1)), ("cumprod", (_P, 1)),
     ("fill_diagonal", (f(3, 3), 2.0)), ("squeeze", (f(3, 1, 4), 1)),
     ("unsqueeze", (f(3, 4), 0)), ("flatten", (f(2, 3, 4),)),
     ("tril", (f(3, 4),)), ("triu", (f(3, 4), 1)),
     ("cast", (f(3, 4), "float64")),
     ("scatter", (f(4, 3), np.array([2, 0]), f(2, 3))),
     ("index_add", (f(4, 3), np.array([1, 1]), 0, f(2, 3))),
     ("index_put", (f(4, 3), (np.array([0, 2]),), f(2, 3))),
     ("masked_fill", (f(3, 4), b(3, 4), 0.5)),
     ("put_along_axis", (f(3, 4), np.array([[1], [0], [3]]),
                         np.float32(2.0), 1)),
     ("t", (f(3, 4),)), ("transpose", (f(2, 3, 4), [1, 2, 0])),
     ("reshape", (f(3, 4), [2, 6]))])


def _inplace_case(name, args):
    op = name + "_"

    def call(M, x, *a):
        a = tuple(tuple(M.to_tensor(v) if M is T else P.to_tensor(v)
                        for v in e) if isinstance(e, tuple) else e
                  for e in a)
        y = x * 1 if x.dtype != (torch.bool if M is T else np.bool_) else \
            M.logical_and(x, x)
        out = getattr(M, op)(y, *a)
        if M is T:
            assert out is y
        return out
    float_in = args[0].dtype == np.float32 and name not in (
        "ceil", "floor", "round", "trunc", "cast", "equal", "not_equal",
        "floor_divide",
        "greater_equal", "greater_than", "less_equal", "less_than")
    return Case(f"{op}[inplace]", call=call, args=args, grad=float_in,
                tol=1e-5)


INPLACE = [_inplace_case(n, a) for n, a in _INPLACE_ARGS.items()]

CASES = LINALG + RANDOM + EXTRAS + INPLACE


@pytest.fixture(scope="module")
def ref():
    return reference(CASES)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op(case, ref):
    hold(case, ref)


def test_the_inplace_family_is_the_references():
    want = sorted(n for n in set(P.ops.__all__) if n.endswith("_"))
    got = sorted(n for n in T.ops.__all__ if n.endswith("_"))
    assert got == want
    covered = {c.id.split("[")[0] for c in CASES + _compat_inplace()}
    assert set(want) - covered <= {"reshape_", "exponential_", "normal_",
                                   "uniform_", "bernoulli_", "log_normal_",
                                   "cauchy_", "geometric_"} | covered


def _compat_inplace():
    from test_torch_ops_shape import COMPAT
    return COMPAT


def test_inplace_on_a_leaf_that_requires_grad_is_refused():
    """torch refuses an in-place op on a leaf that requires grad (the
    reference rebinds it): ROADMAP Queue 3."""
    x = T.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError):
        x.exp_()
    with T.no_grad():
        assert x.exp_() is x
    np.testing.assert_allclose(x.numpy(), np.exp([1.0, 2.0]), rtol=1e-6)


def test_linalg_namespace_is_the_references():
    assert set(P.linalg.__all__) == set(T.linalg.__all__)
    for n in T.linalg.__all__:
        assert callable(getattr(T.linalg, n))


def test_every_case_id_is_unique():
    names = ids(CASES)
    assert len(names) == len(set(names))
