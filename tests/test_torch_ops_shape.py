"""The port's shape, gather/scatter, indexing, TensorArray and compat ops
against the JAX package, on the CPU (``paddle_tpu_torch/ops/
manipulation.py``, ``indexing.py``, ``array.py``, ``compat.py``), with the
harness of ``test_torch_ops_table.py``."""

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from test_torch_ops_table import Case, b, f, hold, i, ids, on_cpu, reference, seed  # noqa: F401,E501

torch.set_num_threads(2)
seed(2501)

_X = f(2, 3, 4)
MANIP = [
    Case("cast", args=(f(3, 4), "int32")),
    Case("cast[same]", args=(f(3, 4), "float32"), grad=True),
    Case("reshape", args=(_X, [4, -1]), grad=True),
    Case("flatten", args=(_X,), kw=dict(start_axis=1), grad=True),
    Case("unflatten", args=(f(2, 12), 1, [3, 4]), grad=True),
    Case("transpose", args=(_X, [2, 0, 1]), grad=True),
    Case("moveaxis", args=(_X, 0, 2), grad=True),
    Case("swapaxes", args=(_X, 0, 2), grad=True),
    Case("squeeze", args=(f(1, 3, 1),), grad=True),
    Case("squeeze[axis]", args=(f(1, 3, 1), [0, 1])),
    Case("unsqueeze", args=(f(3, 4), [0, -1]), grad=True),
    Case("concat", call=lambda M, a, c: M.concat([a, c], axis=1),
         args=(f(2, 3), f(2, 4)), grad=True),
    Case("stack", call=lambda M, a, c: M.stack([a, c], axis=1),
         args=(f(2, 3), f(2, 3)), grad=True),
    Case("unstack", args=(_X,), kw=dict(axis=1), grad=True),
    Case("split", args=(f(6, 4), 3), grad=True),
    Case("split[sections]", args=(f(6, 4), [1, -1, 2]), kw=dict(axis=0),
         grad=True),
    Case("chunk", args=(f(4, 6), 2), kw=dict(axis=1)),
    Case("tile", args=(f(2, 3), [2, 1, 2]), grad=True),
    Case("expand", args=(f(1, 3), [4, -1]), grad=True),
    Case("expand_as", args=(f(3, 1), f(3, 4))),
    Case("broadcast_to", args=(f(3, 1), [2, 3, 4]), grad=True),
    Case("broadcast_tensors", call=lambda M, a, c: M.broadcast_tensors(
        [a, c]), args=(f(3, 1), f(1, 4))),
    Case("broadcast_shape", call=lambda M: M.broadcast_shape([3, 1], [4])),
    Case("flip", args=(_X, [0, 2]), grad=True),
    Case("roll", args=(_X, 1), grad=True),
    Case("roll[axis]", args=(_X, [1, -1], [0, 2])),
    Case("rot90", args=(f(3, 4),), kw=dict(k=3), grad=True),
    Case("repeat_interleave", args=(f(2, 3), 2), kw=dict(axis=1),
         grad=True),
    Case("repeat_interleave[flat]", args=(i(2, 3), 2)),
    Case("as_strided", args=(f(12), [3, 2], [4, 1], 1), grad=True),
    Case("view", args=(f(3, 4), [2, 6]), grad=True),
    Case("view[dtype]", args=(f(3, 4), "int32")),
    Case("pad", args=(f(2, 3, 4), [1, 2]), grad=True),
    Case("pad[reflect]", args=(f(1, 2, 5, 5), [1, 2, 2, 1]),
         kw=dict(mode="reflect"), grad=True),
    Case("pad[all]", args=(f(2, 3), [1, 0, 0, 2]), kw=dict(value=1.5)),
    Case("unbind", args=(_X,), kw=dict(axis=2)),
    Case("unique", args=(i(12),)),
    Case("unique[all]", args=(i(12),), kw=dict(
        return_index=True, return_inverse=True, return_counts=True)),
    Case("unique[axis]", args=(np.array([[1, 2], [1, 2], [0, 5]]),),
         kw=dict(axis=0, return_counts=True)),
    Case("unique_consecutive", args=(np.array([1, 1, 2, 2, 2, 3, 1, 1]),),
         kw=dict(return_inverse=True, return_counts=True)),
    Case("masked_fill", args=(f(3, 4), b(3, 4), 2.0), grad=True),
    Case("masked_fill[bcast]", args=(f(3, 4), b(4), -1.0)),
    Case("masked_select[shape]", call=lambda M, x, m: M.masked_select(x, m),
         args=(f(3, 4), b(4))),
    Case("index_select", args=(f(4, 3), np.array([3, 0, 3])),
         kw=dict(axis=0), grad=True),
    Case("index_select[axis1]", args=(f(4, 3), np.array([2, 1])),
         kw=dict(axis=1)),
    Case("index_sample", args=(f(3, 5), i(3, 2, lo=0, hi=5)), grad=True),
    Case("take_along_axis", args=(f(3, 5), i(3, 2, lo=0, hi=5), 1),
         grad=True),
    Case("put_along_axis", args=(f(3, 5), np.array([[0], [2], [4]]),
                                 np.float32(9.0), 1)),
    Case("put_along_axis[add]", args=(f(3, 5), np.array([[0, 0], [2, 1],
                                                         [4, 3]]),
                                      f(3, 2), 1), kw=dict(reduce="add"),
         grad=True),
    Case("put_along_axis[amax]", args=(f(3, 5), np.array([[0], [2], [4]]),
                                       f(3, 1), 1), kw=dict(reduce="amax")),
    Case("gather", args=(f(5, 3), np.array([4, 0, 2])), grad=True),
    Case("gather[axis]", args=(f(5, 3), np.array([[2], [0]])),
         kw=dict(axis=0)),
    Case("gather[axis1]", args=(f(5, 3), np.array([1, 1])),
         kw=dict(axis=1)),
    Case("gather_nd", args=(f(3, 4, 2), np.array([[0, 1], [2, 3]])),
         grad=True),
    Case("scatter", args=(f(5, 3), np.array([3, 1]), f(2, 3)), grad=True),
    Case("scatter[add]", args=(f(5, 3), np.array([1, 1, 4]), f(3, 3)),
         kw=dict(overwrite=False)),
    Case("scatter_nd_add", args=(f(4, 3), np.array([[1], [1], [3]]),
                                 f(3, 3)), grad=True),
    Case("scatter_nd", call=lambda M, idx, u: M.scatter_nd(idx, u, [4, 3]),
         args=(np.array([[0], [2]]), f(2, 3))),
    Case("index_add", args=(f(4, 3), np.array([0, 0, 3]), 0, f(3, 3)),
         grad=True),
    Case("index_put", call=lambda M, x, r, c, v: M.index_put(x, (r, c), v),
         args=(f(4, 3), np.array([0, 3]), np.array([2, 1]), f(2)),
         grad=True),
    Case("index_put[acc]", call=lambda M, x, r, v: M.index_put(
        x, (r,), v, accumulate=True),
         args=(f(4, 3), np.array([1, 1]), f(2, 3))),
    Case("index_fill", args=(f(4, 3), np.array([0, 2]), 0, 7.5)),
    Case("where[manip]", call=lambda M, c, x, y: M.where(c, x, y),
         args=(b(3, 4), i(3, 4), i(4))),
    Case("nonzero[manip]", call=lambda M, x: M.nonzero(x),
         args=(i(3, 3, lo=0, hi=2),)),
    Case("numel", args=(_X,)),
    Case("shard_index", args=(i(6, 1, lo=0, hi=20), 20, 2, 1)),
    Case("one_hot", args=(i(5, lo=0, hi=4), 4)),
    Case("bincount", args=(i(10, lo=0, hi=5),)),
    Case("bincount[weights]", args=(i(10, lo=0, hi=5), f(10)),
         call=lambda M, x, w: M.bincount(x, weights=w, minlength=7)),
    Case("searchsorted[manip]", call=lambda M, s, v: M.searchsorted(s, v),
         args=(np.sort(f(5)), f(2, 3))),
    Case("diagonal", args=(_X,), kw=dict(offset=1, axis1=1, axis2=2),
         grad=True),
    Case("diag_embed", args=(f(2, 3),), kw=dict(offset=-1), grad=True),
    Case("crop", args=(f(4, 5),), kw=dict(shape=[2, 3], offsets=[1, 2]),
         grad=True),
    Case("strided_slice", args=(f(6, 7), [0, 1], [1, 6], [5, 0], [2, -2]),
         grad=True),
    Case("slice", args=(f(6, 7), [1], [2], [5])),
    Case("tensordot", args=(f(2, 3, 4), f(3, 4, 5)), grad=True, tol=1e-5),
    Case("tensordot[axes]", args=(f(2, 3, 4), f(4, 3)),
         kw=dict(axes=[[1, 2], [1, 0]])),
    Case("atleast_1d", call=lambda M, a: M.atleast_1d(a),
         args=(np.float32(3.0) * np.ones((), np.float32),)),
    Case("atleast_2d", call=lambda M, a: M.atleast_2d(a), args=(f(3),)),
    Case("atleast_3d", call=lambda M, a, c: M.atleast_3d(a, c),
         args=(f(3), f(2, 3))),
    Case("hsplit", args=(f(2, 6), 3)),
    Case("vsplit", args=(f(4, 3), [1, 3])),
    Case("dsplit", args=(f(2, 2, 4), 2)),
    Case("hstack", call=lambda M, a, c: M.hstack([a, c]),
         args=(f(2, 3), f(2, 1)), grad=True),
    Case("vstack", call=lambda M, a, c: M.vstack([a, c]),
         args=(f(3), f(3))),
    Case("dstack", call=lambda M, a, c: M.dstack([a, c]),
         args=(f(2, 3), f(2, 3))),
    Case("column_stack", call=lambda M, a, c: M.column_stack([a, c]),
         args=(f(3), f(3, 2))),
    Case("row_stack", call=lambda M, a, c: M.row_stack([a, c]),
         args=(f(2, 3), f(1, 3))),
    Case("tensor_split", args=(f(7, 2), 3)),
    Case("tensor_split[idx]", args=(f(7, 2), [2, 5])),
    Case("as_complex", args=(f(3, 2),)),
    Case("as_real", call=lambda M, a, c: M.as_real(M.complex(a, c)),
         args=(f(3), f(3))),
    Case("fill_diagonal", args=(f(3, 4), 2.0), kw=dict(offset=1)),
    Case("fill_diagonal[wrap]", args=(f(7, 3), 2.0), kw=dict(wrap=True)),
    Case("fill_diagonal_tensor", args=(f(2, 4, 4), f(2, 3)),
         kw=dict(offset=1, dim1=1, dim2=2), grad=True),
    Case("top_p_sampling", args=(np.array([[0.1, 0.6, 0.3], [0.7, 0.2, 0.1]],
                                          np.float32),
                                 np.array([0.5, 0.5], np.float32)),
         check=lambda got, want: _top_p_check(got), eager=True),
]


def _top_p_check(got):
    probs, ids = got
    # mass 0.5 keeps only each row's top token
    assert ids.dtype == torch.int64 and ids.shape == (2, 1)
    np.testing.assert_array_equal(ids.numpy(), [[1], [0]])
    np.testing.assert_allclose(probs.numpy(), [[0.6], [0.7]])


INDEXING = [
    Case("getitem[int]", call=lambda M, x: x[1], args=(_X,), grad=True),
    Case("getitem[slices]", call=lambda M, x: x[:, 1:, ::2], args=(_X,),
         grad=True),
    Case("getitem[neg]", call=lambda M, x: x[-1, ..., -2], args=(_X,)),
    Case("getitem[none]", call=lambda M, x: x[None, 0], args=(_X,)),
    Case("getitem[list]", call=lambda M, x: x[[1, 0, 1]], args=(_X,),
         grad=True),
    Case("getitem[tensor]", call=lambda M, x, idx: x[idx],
         args=(_X, np.array([1, 1, 0]))),
    Case("getitem[tensor0d]", call=lambda M, x, idx: x[:, idx],
         args=(_X, np.array(2))),
    Case("getitem[pair]", call=lambda M, x, r, c: x[r, c],
         args=(f(4, 5), np.array([0, 3]), np.array([4, 1])), grad=True),
    Case("getitem[mask]", call=lambda M, x, m: x[m],
         args=(f(3, 4), b(3, 4)), grad=True),
    Case("getitem[row_mask]", call=lambda M, x, m: x[m],
         args=(f(3, 4), np.array([True, False, True]))),
    Case("setitem[int]", call=lambda M, x: _set(x, 1, 5.0),
         args=(f(3, 4),)),
    Case("setitem[slice]", call=lambda M, x, v: _set(x, (slice(None),
                                                       slice(1, 3)), v),
         args=(f(3, 4), f(3, 2))),
    Case("setitem[mask]", call=lambda M, x, m: _set(x, m, 0.0),
         args=(f(3, 4), b(3, 4))),
    Case("setitem[list]", call=lambda M, x: _set(x, 0, [1.0, 2.0, 3.0,
                                                      4.0]),
         args=(f(3, 4),)),
    Case("setitem[tensor]", call=lambda M, x, idx, v: _set(x, idx, v),
         args=(f(4, 2), np.array([3, 1]), f(2, 2))),
]


def _set(x, idx, v):
    x[idx] = v
    return x


_ARR = f(2, 3)
ARRAY = [
    Case("create_array", call=lambda M, a: M.create_array(
        "float32", [a, a]), args=(_ARR,)),
    Case("array_length", call=lambda M, a: M.array_length(
        M.create_array("float32", [a, a, a])), args=(_ARR,)),
    Case("array_read", call=lambda M, a, c: M.array_read(
        M.create_array("float32", [a, c]), 1), args=(_ARR, f(2, 3))),
    Case("array_write", call=lambda M, a, c: M.array_write(
        c, 1, M.array_write(a, 0)), args=(_ARR, f(2, 3))),
]

COMPAT = [
    Case("shape", args=(_X,)),
    Case("rank", args=(_X,)),
    Case("tolist", args=(i(2, 3),)),
    Case("reverse", args=(_X, [1]), grad=True),
    Case("pdist", args=(f(4, 3),), grad=True),
    Case("pdist[p1]", args=(f(4, 3),), kw=dict(p=1.0)),
    Case("pdist[inf]", args=(f(4, 3),), kw=dict(p=float("inf"))),
    Case("reduce_as", args=(f(2, 3, 4), f(3, 1)), grad=True),
    Case("check_shape", call=lambda M: M.check_shape([2, 3])),
    Case("create_tensor", call=lambda M: M.create_tensor("int32")),
    Case("iinfo", call=lambda M: [M.iinfo("int32").max,
                                  M.iinfo("int8").min]),
    Case("finfo", call=lambda M: [M.finfo("float32").eps,
                                  M.finfo("float16").max,
                                  M.finfo("bfloat16").eps],
         port_dtype=("float64",) * 3),
] + [
    Case(f"{n}[compat]", call=call, args=args)
    for n, call, args in (
        ("addmm_", lambda M, a, x, y: M.addmm_(a, x, y, 0.5, 2.0),
         (f(3, 2), f(3, 4), f(4, 2))),
        ("where_", lambda M, c, x, y: M.where_(c, x, y),
         (b(3, 4), f(3, 4), f(3, 4))),
        ("mod_", lambda M, x, y: M.mod_(x, y), (f(3, 4), f(4, lo=1, hi=2))),
        ("floor_mod_", lambda M, x, y: M.floor_mod_(x, y),
         (i(3, 4, lo=-9, hi=9), i(4, lo=1, hi=4))),
        ("renorm_", lambda M, x: M.renorm_(x, 2.0, 0, 1.0), (f(3, 4),)),
        ("polygamma_", lambda M, x: M.polygamma_(x, 1),
         (f(3, lo=0.5, hi=2),)),
        ("gammainc_", lambda M, x, y: M.gammainc_(x, y),
         (f(3, lo=0.5, hi=2), f(3, lo=0.5, hi=2))),
        ("gammaincc_", lambda M, x, y: M.gammaincc_(x, y),
         (f(3, lo=0.5, hi=2), f(3, lo=0.5, hi=2))),
        ("multigammaln_", lambda M, x: M.multigammaln_(x, 2),
         (f(3, lo=2, hi=4),)),
        ("bitwise_left_shift_", lambda M, x, y: M.bitwise_left_shift_(x, y),
         (i(3, 4), i(4, lo=0, hi=3))),
        ("bitwise_right_shift_", lambda M, x, y:
         M.bitwise_right_shift_(x, y), (i(3, 4, lo=0, hi=64), i(4, hi=3))),
        ("masked_scatter_", lambda M, x, m, v: M.masked_scatter_(x, m, v),
         (f(3, 4), b(3, 4), f(12))),
        ("index_fill_", lambda M, x, idx: M.index_fill_(x, idx, 1, -2.0),
         (f(3, 4), np.array([0, 3]))))
]


def _rng_fill_check(name):
    def check(got, want):
        x = got[0]
        v = x.numpy()
        assert isinstance(x, T.Tensor) and x.dtype == torch.float32
        if name == "bernoulli_":
            assert set(np.unique(v)) <= {0.0, 1.0}
            assert abs(v.mean() - 0.3) < 0.03
        elif name == "log_normal_":
            assert (v > 0).all()
            assert abs(np.log(v).mean() - 1.0) < 0.05
            assert abs(np.log(v).std() - 0.5) < 0.05
        elif name == "cauchy_":
            assert abs(np.median(v) - 1.0) < 0.1
        else:   # geometric_: log(u) / log1p(-p), continuous, positive
            assert (v > 0).all()
            assert abs(v.mean() - (-1.0 / np.log1p(-0.4))) < 0.1
    return check


RNG_FILLS = [
    Case(f"{n}[compat]", call=call, args=(np.zeros((100, 100), np.float32),),
         check=_rng_fill_check(n), eager=True)
    for n, call in (
        ("bernoulli_", lambda M, x: [M.bernoulli_(x, 0.3)]),
        ("log_normal_", lambda M, x: [M.log_normal_(x, 1.0, 0.5)]),
        ("cauchy_", lambda M, x: [M.cauchy_(x, 1.0, 0.5)]),
        ("geometric_", lambda M, x: [M.geometric_(x, 0.4)]))]

CASES = MANIP + INDEXING + ARRAY + COMPAT + RNG_FILLS


@pytest.fixture(scope="module")
def ref():
    return reference(CASES)


@pytest.mark.parametrize("case", CASES, ids=ids(CASES))
def test_op(case, ref):
    hold(case, ref)


def test_in_place_compat_ops_return_their_input():
    x = T.to_tensor(np.ones((2, 3), np.float32))
    assert T.mod_(x, 0.7) is x
    assert T.index_fill_(x, T.to_tensor([1]), 1, 5.0) is x
    assert float(x[0, 1]) == 5.0


def test_create_parameter_and_lazy_guard():
    with T.LazyGuard():
        p = T.create_parameter([3, 4], "float32", name="w")
    assert isinstance(p, T.Parameter) and isinstance(p, T.Tensor)
    assert p.shape == [3, 4] and p.name == "w" and not p.stop_gradient
    bias = T.create_parameter([4], "float32", is_bias=True)
    assert (bias.numpy() == 0).all()
    assert T.check_shape([2, 3]) and T.disable_signal_handler() is None
    with pytest.raises(ValueError):
        T.check_shape([2, -1])
    st = T.get_cuda_rng_state()
    a = T.randn([3])
    T.set_cuda_rng_state(st)
    np.testing.assert_array_equal(T.randn([3]).numpy(), a.numpy())


def test_every_case_id_is_unique():
    names = ids(CASES)
    assert len(names) == len(set(names))
    assert P.ops.array.__all__ == T.ops.array.__all__
