"""``paddle_tpu_torch.Tensor`` against ``paddle_tpu.Tensor``, on the CPU.

The surface (every public attribute of the reference's ``Tensor`` but
``stft`` / ``istft``, every name of its ``ops`` and top level but the three
static-graph ones), the method table (the op cases of the
``test_torch_ops_*`` files run again as methods, where the reference has
the method), the operator dunders (``~ & | ^`` logical for every dtype),
the attributes and their idioms (``shape`` / ``size`` / ``grad`` /
``stop_gradient`` / ``place``), the subclass design (``torch.*`` on a
``Tensor`` returns one; torch's own Python code works on one; a ``Layer``
forward runs on plain tensors and enters ``__torch_function__`` only at its
boundary; ``Parameter`` is a ``Tensor`` and a ``torch.nn.Parameter``), and a
short training program in the reference's method style, run in both
packages.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.core import tensor as CT
import test_torch_ops_linalg_random as LR
import test_torch_ops_shape as SH
import test_torch_ops_table as TB
from test_torch_ops_table import Case, b, close, f, hold, i, ids, on_cpu, reference, seed  # noqa: F401,E501

torch.set_num_threads(2)
seed(2503)

# ------------------------------------------------------------------ surface

STATIC_ONLY = {"enable_static", "disable_static", "in_dynamic_mode"}
TOP_LEVEL_REST = {"complex64", "complex128", "float8_e4m3fn", "float8_e5m2",
                  "dtype", "enable_grad", "set_grad_enabled",
                  "is_grad_enabled", "get_flags", "set_flags",
                  "device_count", "is_compiled_with_cuda",
                  "is_compiled_with_tpu", "is_compiled_with_xpu", "errors",
                  "version", "pstring", "raw"}
WAITING_METHODS = {"stft", "istft"}     # signal.py, ROADMAP item 17.10
# the public attributes of paddle_tpu.Tensor after ``import paddle_tpu``
# (``paddle_tpu.distributed`` adds two more, item 18)
REF_TENSOR_ATTRS = (
    "T", "abs", "abs_", "acos", "acos_", "acosh", "acosh_", "add", "add_",
    "add_n", "addmm", "addmm_", "all", "allclose", "amax", "amin", "angle",
    "any", "argmax", "argmin", "argsort", "as_complex", "as_real",
    "as_strided", "asin", "asin_", "asinh", "asinh_", "astype", "atan",
    "atan2", "atan_", "atanh", "atanh_", "atleast_1d", "atleast_2d",
    "atleast_3d", "backward", "bernoulli", "bernoulli_", "bincount",
    "bitwise_and", "bitwise_and_", "bitwise_left_shift",
    "bitwise_left_shift_", "bitwise_not", "bitwise_not_", "bitwise_or",
    "bitwise_or_", "bitwise_right_shift", "bitwise_right_shift_",
    "bitwise_xor", "bitwise_xor_", "block_diag", "bmm", "broadcast_shape",
    "broadcast_tensors", "broadcast_to", "bucketize", "cast", "cast_",
    "cauchy_", "cdist", "ceil", "ceil_", "cholesky", "cholesky_inverse",
    "cholesky_solve", "chunk", "clear_grad", "clear_gradient", "clip",
    "clip_", "clone", "combinations", "concat", "cond", "conj", "contiguous",
    "copy_", "copysign", "copysign_", "corrcoef", "cos", "cos_", "cosh",
    "cosh_", "count_nonzero", "cov", "cpu", "create_parameter",
    "create_tensor", "cross", "cuda", "cummax", "cummin", "cumprod",
    "cumprod_", "cumsum", "cumsum_", "cumulative_trapezoid", "deg2rad",
    "detach", "diag", "diag_embed", "diagflat", "diagonal",
    "diagonal_scatter", "diff", "digamma", "digamma_", "dim", "dist",
    "divide", "divide_", "dot", "dsplit", "dtype", "eig", "eigvals",
    "eigvalsh", "element_size", "equal", "equal_", "equal_all", "erf",
    "erf_", "erfinv", "erfinv_", "exp", "exp_", "expand", "expand_as",
    "expm1", "expm1_", "exponential_", "fill_", "fill_diagonal_", "flatten",
    "flatten_", "flip", "floor", "floor_", "floor_divide", "floor_divide_",
    "floor_mod", "floor_mod_", "fmax", "fmin", "frac", "frac_", "frexp",
    "gammainc", "gammainc_", "gammaincc", "gammaincc_", "gammaln",
    "gammaln_", "gather", "gather_nd", "gcd", "gcd_", "geometric_", "grad",
    "greater_equal", "greater_equal_", "greater_than", "greater_than_",
    "heaviside", "histogram", "histogram_bin_edges", "histogramdd",
    "householder_product", "hsplit", "hypot", "hypot_", "i0", "i0_", "i0e",
    "i1", "i1e", "imag", "increment", "index_add", "index_add_",
    "index_fill", "index_fill_", "index_put", "index_put_", "index_sample",
    "index_select", "inner", "inverse", "is_complex", "is_contiguous",
    "is_dist", "is_empty", "is_floating_point", "is_integer", "is_leaf",
    "is_selected_rows", "is_tensor", "isclose", "isfinite", "isin", "isinf",
    "isnan", "isneginf", "isposinf", "isreal", "istft", "item", "kron",
    "kthvalue", "lcm", "lcm_", "ldexp", "ldexp_", "lerp", "lerp_",
    "less_equal", "less_equal_", "less_than", "less_than_", "lgamma",
    "lgamma_", "log", "log10", "log10_", "log1p", "log1p_", "log2", "log2_",
    "log_", "log_normal_", "logaddexp", "logcumsumexp", "logical_and",
    "logical_and_", "logical_not", "logical_not_", "logical_or",
    "logical_or_", "logical_xor", "logical_xor_", "logit", "logit_",
    "logsumexp", "lstsq", "lu", "lu_unpack", "masked_fill", "masked_fill_",
    "masked_scatter", "masked_scatter_", "masked_select", "matmul",
    "matrix_exp", "matrix_power", "max", "maximum", "mean", "median", "min",
    "minimum", "mm", "mod", "mod_", "mode", "moveaxis", "multi_dot",
    "multigammaln", "multigammaln_", "multinomial", "multiplex", "multiply",
    "multiply_", "mv", "name", "nan_to_num", "nan_to_num_", "nanmean",
    "nanmedian", "nanquantile", "nansum", "ndim", "ndimension", "neg",
    "neg_", "nextafter", "nonzero", "norm", "normal_", "not_equal",
    "not_equal_", "numel", "numpy", "one_hot", "ormqr", "outer", "pad",
    "pca_lowrank", "persistable", "pin_memory", "pinv", "place", "polar",
    "polygamma", "polygamma_", "pow", "pow_", "prod", "put_along_axis",
    "put_along_axis_", "qr", "quantile", "rad2deg", "rank", "real",
    "reciprocal", "reciprocal_", "reduce_as", "register_hook", "remainder",
    "remainder_", "renorm", "renorm_", "repeat_interleave", "reshape",
    "reshape_", "retain_grads", "reverse", "roll", "rot90", "round",
    "round_", "rsqrt", "rsqrt_", "scale", "scale_", "scatter", "scatter_",
    "scatter_nd", "scatter_nd_add", "select_scatter", "set_value", "sgn",
    "shape", "shard_index", "sigmoid", "sigmoid_", "sign", "signbit", "sin",
    "sin_", "sinc", "sinc_", "sinh", "sinh_", "size", "slice",
    "slice_scatter", "solve", "sort", "split", "sqrt", "sqrt_", "square",
    "square_", "squeeze", "squeeze_", "stack", "stanh", "std", "stft",
    "stop_gradient", "strided_slice", "subtract", "subtract_", "sum",
    "svd_lowrank", "swapaxes", "t", "t_", "take", "take_along_axis", "tan",
    "tan_", "tanh", "tanh_", "tensor_split", "tensordot", "tile", "to",
    "tolist", "top_p_sampling", "topk", "trace", "trainable", "transpose",
    "transpose_", "trapezoid", "triangular_solve", "tril", "tril_", "triu",
    "triu_", "trunc", "trunc_", "unbind", "unflatten", "unfold", "uniform_",
    "unique", "unique_consecutive", "unsqueeze", "unsqueeze_", "unstack",
    "vander", "var", "view", "view_as", "vsplit", "where", "where_", "zero_")


def test_top_level_has_every_reference_name_but_the_static_ones():
    ops = set(P.ops.__all__)
    assert len(ops) == 462 and len(P.ops.__all__) == 484
    assert ops <= set(dir(T))
    assert ops <= set(T.ops.__all__)
    # modules the reference loads later (other tests import them) aside
    ref = {n for n in dir(P) if not n.startswith("_") and
           not isinstance(getattr(P, n), types.ModuleType)}
    missing = {n for n in ref if not hasattr(T, n)}
    assert missing == STATIC_ONLY
    assert TOP_LEVEL_REST <= set(T.__all__)
    assert not (ref - ops - STATIC_ONLY) - set(dir(T))


# reference attributes the port's Tensor takes from torch.Tensor unchanged:
# the same meaning in both
SAME_AS_TORCH = {"clone", "contiguous", "cpu", "cuda", "detach", "dim",
                 "dtype", "is_contiguous", "is_leaf", "item", "ndim",
                 "ndimension", "numel", "tolist"}


def test_tensor_has_every_reference_attribute_but_stft_istft():
    ref = set(REF_TENSOR_ATTRS)
    assert len(ref) == 426 and all(hasattr(P.Tensor, a) for a in ref)
    assert all(hasattr(T.Tensor, a) for a in ref)
    own = {a for a in ref if any(a in k.__dict__ for k in T.Tensor.__mro__
                                 if k.__module__.startswith(
                                     "paddle_tpu_torch"))}
    assert ref - own - SAME_AS_TORCH == WAITING_METHODS


def test_top_level_rest():
    assert T.dtype is torch.dtype and isinstance(T.float32, T.dtype)
    assert T.float8_e4m3fn is torch.float8_e4m3fn
    assert T.complex64 is torch.complex64
    assert (T.pstring, T.raw) == (P.pstring, P.raw)
    assert T.version == T.__version__ == P.version
    assert T.is_compiled_with_cuda() and not T.is_compiled_with_tpu()
    assert not T.is_compiled_with_xpu()
    assert T.device_count() == torch.cuda.device_count()
    assert T.is_grad_enabled()
    with T.set_grad_enabled(False):
        assert not T.is_grad_enabled()
        with T.enable_grad():
            assert T.is_grad_enabled()
    old = T.get_flags(["prefix_cache"])
    T.set_flags({"prefix_cache": True})
    assert T.get_flags(["prefix_cache"]) == {"prefix_cache": True}
    T.set_flags(old)
    assert issubclass(T.errors.InvalidArgumentError, ValueError)
    for n in ("EnforceNotMet", "NotFoundError", "OutOfRangeError",
              "UnimplementedError", "enforce", "enforce_eq"):
        assert hasattr(T.errors, n) and hasattr(P.errors, n)
    with pytest.raises(T.errors.InvalidArgumentError):
        T.errors.enforce_shape_match([2, 3], (3, 2))


# ------------------------------------------------------------ method table

def _method_cases():
    out, seen = [], set()
    for c in TB.CASES + SH.CASES + LR.CASES:
        if not c.method or c.check is not None or c.eager or \
                not callable(getattr(P.Tensor, c.op, None)) or c.op in seen:
            continue
        seen.add(c.op)
        out.append(c)
    return out


METHOD_CASES = _method_cases()


@pytest.fixture(scope="module")
def ref_methods():
    return reference(METHOD_CASES, method=True)


@pytest.mark.parametrize("case", METHOD_CASES, ids=ids(METHOD_CASES))
def test_method(case, ref_methods):
    hold(case, ref_methods, method=True)


def test_the_method_table_covers_the_references():
    """Every method the reference attaches from its ops is attached here,
    and the methods whose torch name means something else keep the
    reference's meaning."""
    assert len(METHOD_CASES) > 200
    x = T.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert x.transpose([1, 0]).shape == [3, 2]
    assert x.sum(axis=0, keepdim=True).shape == [1, 3]
    assert x.max(axis=1).tolist() == [2.0, 5.0]
    assert x.sort(axis=1, descending=True).tolist() == [[2, 1, 0], [5, 4, 3]]
    assert x.gather(T.to_tensor([1]), axis=1).tolist() == [[1.0], [4.0]]
    assert x.index_select(T.to_tensor([0, 0]), axis=1).shape == [2, 2]
    assert x.flip(0).tolist() == [[3, 4, 5], [0, 1, 2]]
    assert x.cumsum().tolist() == [0, 1, 3, 6, 10, 15]
    assert [s.shape for s in x.split(3, axis=1)] == [[2, 1]] * 3
    assert [s.shape for s in x.split([1, 2], axis=1)] == [[2, 1], [2, 2]]
    assert x.astype("int32").dtype == torch.int32
    assert x.cast(T.float64).dtype == torch.float64
    assert x.expand([2, 2, 3]).shape == [2, 2, 3]
    assert x.tile([2, 1]).shape == [4, 3]


# ----------------------------------------------------------------- dunders

_A, _B = f(3, 4), f(3, 4, lo=0.5, hi=2.0)
_I, _J = i(3, 4, lo=-4, hi=4), i(3, 4, lo=1, hi=4)
# a Python float against an int tensor: float64 in the reference (x64), the
# default float dtype in the port (ROADMAP Queue 3)
_INT_TO_FLOAT = {"rsub", "truediv", "rtruediv"}
DUNDERS = [
    Case(f"{n}[{tag}]", call=fn, args=args, grad=g,
         port_dtype="float32" if tag == "int" and n in _INT_TO_FLOAT
         else None)
    for n, fn in (
        ("add", lambda M, x, y: x + y), ("radd", lambda M, x, y: 2 + x),
        ("sub", lambda M, x, y: x - y), ("rsub", lambda M, x, y: 1.5 - x),
        ("mul", lambda M, x, y: x * y), ("rmul", lambda M, x, y: 3 * x),
        ("truediv", lambda M, x, y: x / y),
        ("rtruediv", lambda M, x, y: 2.0 / y),
        ("floordiv", lambda M, x, y: x // y),
        ("mod", lambda M, x, y: x % y), ("pow", lambda M, x, y: y ** 2),
        ("rpow", lambda M, x, y: 2.0 ** x),
        ("neg", lambda M, x, y: -x), ("abs", lambda M, x, y: abs(x)),
        ("eq", lambda M, x, y: x == y), ("ne", lambda M, x, y: x != y),
        ("lt", lambda M, x, y: x < y), ("le", lambda M, x, y: x <= 0),
        ("gt", lambda M, x, y: x > y), ("ge", lambda M, x, y: x >= 0),
        ("invert", lambda M, x, y: ~x), ("and", lambda M, x, y: x & y),
        ("or", lambda M, x, y: x | y), ("xor", lambda M, x, y: x ^ y),
        ("iadd", lambda M, x, y: _iadd(x, y)))
    for tag, args, g in (("float", (_A, _B), True), ("int", (_I, _J), False))
    if not (tag == "int" and n in ("rpow",))
] + [
    Case("matmul[dunder]", call=lambda M, x, y: x @ y,
         args=(f(3, 4), f(4, 2)), grad=True),
    Case("rmatmul[dunder]", call=lambda M, x, y: x.__rmatmul__(y),
         args=(f(4, 2), f(3, 4)), grad=True),
    Case("bool_ops[dunder]", call=lambda M, x, y: [~x, x & y, x | y, x ^ y],
         args=(b(3, 4), b(3, 4))),
    Case("getitem[dunder]", call=lambda M, x: [x[0], x[:, 1], x[x > 0]],
         args=(f(3, 4),)),
]


def _iadd(x, y):
    z = x
    z += y
    return z


@pytest.fixture(scope="module")
def ref_dunders():
    return reference(DUNDERS)


@pytest.mark.parametrize("case", DUNDERS, ids=ids(DUNDERS))
def test_dunder(case, ref_dunders):
    hold(case, ref_dunders)


def test_logical_dunders_are_logical_for_every_dtype():
    a, c = T.to_tensor([1, 0, 2]), T.to_tensor([3, 3, 0])
    assert (~a).tolist() == [False, True, False]
    assert (a & c).tolist() == [True, False, False]
    assert (a | c).tolist() == [True, True, True]
    assert (a ^ c).tolist() == [False, True, True]
    x = T.to_tensor([1.0, 2.0])
    y = x
    y += 1.0        # a new tensor bound to y, as in the reference
    assert x.tolist() == [1.0, 2.0] and y.tolist() == [2.0, 3.0]


# ---------------------------------------------------- attributes and idioms

def test_shape_and_size_idioms():
    x = T.to_tensor(np.zeros((2, 3), np.float32))
    j = P.to_tensor(np.zeros((2, 3), np.float32))
    assert x.shape == [2, 3] == j.shape and x.shape == (2, 3)
    assert x.shape[:-1] + [4] == j.shape[:-1] + [4] == [2, 4]
    assert x.size == 6 == j.size and isinstance(x.size, int)
    assert x.numel() == 6 and x.ndim == 2 and x.rank == 2 and x.dim() == 2
    # torch's idioms on the same objects
    assert x.size(1) == 3 and x.size() == torch.Size([2, 3])
    assert x.shape + (1,) == (2, 3, 1) and x.shape.numel() == 6
    assert torch.zeros(x.shape).shape == (2, 3)
    assert repr(x.shape) == repr(j.shape) == "[2, 3]"


def test_grad_stop_gradient_place_and_leaves():
    x = T.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    j = P.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    assert x.is_leaf and not x.stop_gradient and x.place == "cpu:0"
    assert j.place == "cpu:0"
    (x * x).sum().backward()
    (j * j).sum().backward()
    assert isinstance(x.grad, T.Tensor) and x.grad is x.grad
    close(x.grad, j.grad.numpy(), 0)
    x.clear_grad()
    assert x.grad is None
    y = T.to_tensor([1.0])
    assert y.stop_gradient
    y.stop_gradient = False
    assert y.requires_grad and y.trainable
    assert x.name.startswith("generated_tensor_")
    x.name = "w"
    x.persistable = True
    assert x.name == "w" and x.persistable
    assert not x.is_dist and not x.is_selected_rows()
    assert x.T.shape == [3] and T.to_tensor(np.zeros((2, 3, 4))).T.shape == \
        [4, 3, 2]


def test_conversion_and_mutation_methods():
    x = T.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert isinstance(x.numpy(), np.ndarray) and x.tolist()[1] == [3, 4, 5]
    assert x.to("float64").dtype == torch.float64
    assert x.to("cpu").place == "cpu:0" and x.cpu().place == "cpu:0"
    assert x.clone().detach().element_size() == 4
    assert T.to_tensor([1.0], dtype="bfloat16").numpy().dtype == np.float32
    x.set_value(np.ones((2, 3)))
    assert x.tolist() == [[1.0] * 3] * 2
    x.fill_(2.0)
    x.scale_(3.0)
    assert x.tolist() == [[6.0] * 3] * 2
    x.zero_()
    assert float(x.sum()) == 0.0
    x.copy_(T.to_tensor(np.full((2, 3), 4.0)))
    assert float(x[1, 2]) == 4.0 and len(x) == 2
    assert [r.tolist() for r in x] == [[4.0] * 3] * 2
    p = T.Parameter(torch.ones(2))
    p.fill_(5.0)       # a leaf that requires grad, filled outside autograd
    assert p.tolist() == [5.0, 5.0] and p.is_leaf
    seen = []
    y = T.to_tensor([1.0, 2.0], stop_gradient=False)
    y.register_hook(lambda g: seen.append(type(g)) or g * 2)
    (y * 3).sum().backward()
    assert seen == [T.Tensor] and y.grad.tolist() == [6.0, 6.0]
    z = T.to_tensor([1.0, 2.0], stop_gradient=False) * 2
    z.retain_grads()
    (z * z).sum().backward()
    assert z.grad.tolist() == [4.0, 8.0]
    w = T.to_tensor(np.ones((2, 2), np.float32), stop_gradient=False)
    (w * 2).backward()          # a non-scalar seeds with ones
    assert w.grad.tolist() == [[2.0, 2.0], [2.0, 2.0]]


# ------------------------------------------------------------ the design

def test_torch_functions_on_a_tensor_return_a_tensor():
    x = T.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    for out in (torch.matmul(x, x.T), torch.exp(x), x.exp(), x + 1,
                torch.cat([x, x]), F.gelu(x), x.detach(), x.clone(),
                torch.where(x > 2, x, torch.zeros(2, 3))):
        assert isinstance(out, T.Tensor), type(out)
    vals, idx = torch.max(x, 1)
    assert isinstance(vals, T.Tensor) and isinstance(idx, T.Tensor)


def test_torch_python_code_works_on_a_tensor():
    """Torch functions whose Python body calls ``.size(d)`` / ``.view``
    (``local_response_norm``) and ``.transpose(a, b)`` / ``.size(d)``
    (``multi_head_attention_forward``) on their input see plain tensors and
    give torch's answers; ``.max(dim)`` is in the next test."""
    r = np.random.default_rng(3)
    a = r.standard_normal((2, 4, 5, 5)).astype(np.float32)
    got = F.local_response_norm(T.to_tensor(a), 3)
    want = F.local_response_norm(torch.from_numpy(a), 3)
    assert isinstance(got, T.Tensor)
    close(got, want.numpy(), 1e-6)
    q = r.standard_normal((5, 2, 8)).astype(np.float32)
    w_in = r.standard_normal((24, 8)).astype(np.float32)
    w_out = r.standard_normal((8, 8)).astype(np.float32)

    def mha(t, wi, wo):
        return F.multi_head_attention_forward(
            t, t, t, 8, 2, wi, None, None, None, False, 0.0, wo, None,
            training=False, need_weights=False)[0]
    got = mha(T.to_tensor(q), T.to_tensor(w_in), T.Parameter(
        torch.from_numpy(w_out)))
    want = mha(*map(torch.from_numpy, (q, w_in, w_out)))
    assert isinstance(got, T.Tensor)
    close(got, want.detach().numpy(), 1e-6)


def test_gumbel_softmax_max_dim_on_a_tensor():
    torch.manual_seed(0)
    a = T.to_tensor(np.random.default_rng(4).standard_normal((4, 6))
                    .astype(np.float32))
    y = F.gumbel_softmax(a, tau=0.5, hard=True)      # body: .max(dim)
    assert isinstance(y, T.Tensor)
    assert y.sum(axis=-1).tolist() == [1.0] * 4
    assert set(np.unique(y.numpy())) <= {0.0, 1.0}


def test_parameter_is_a_tensor_and_a_torch_parameter():
    lin = T.nn.Linear(3, 4)
    for p in lin.parameters():
        assert isinstance(p, T.Parameter) and isinstance(p, T.Tensor)
        assert isinstance(p, torch.nn.Parameter) and p.is_leaf
    w = lin.weight
    assert w.shape == [3, 4] and w.size(1) == 4 and w.numel() == 12
    assert w.reshape([12]).shape == [12] and w.reshape(4, 3).shape == [4, 3]
    assert isinstance(w * 2, T.Tensor) and not isinstance(w * 2, T.Parameter)
    import copy
    w2 = copy.deepcopy(w)
    assert type(w2) is T.Parameter and w2.name == w.name
    vec = T.nn.utils.parameters_to_vector(lin.parameters())
    assert isinstance(vec, T.Tensor) and vec.shape == [16]


def test_layer_forward_enters_torch_function_only_at_its_boundary():
    T.seed(0)
    enc = T.nn.TransformerEncoder(
        T.nn.TransformerEncoderLayer(16, 2, 32, dropout=0.0), 2)
    x = T.randn([2, 5, 16])
    assert isinstance(x, T.Tensor)
    n0 = CT.TORCH_FUNCTION_ENTRIES[0]
    out = enc(x)
    assert CT.TORCH_FUNCTION_ENTRIES[0] - n0 == 0
    assert isinstance(out, T.Tensor) and out.shape == [2, 5, 16]
    plain = enc(torch.Tensor.as_subclass(x, torch.Tensor))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    n0 = CT.TORCH_FUNCTION_ENTRIES[0]
    loss = out.mean()               # one op outside: one entry
    assert CT.TORCH_FUNCTION_ENTRIES[0] - n0 <= 2
    loss.backward()
    assert all(isinstance(p.grad, T.Tensor) for p in enc.parameters())


def test_paddle_api_entries_return_tensors():
    T.seed(1)
    x = T.to_tensor(np.random.default_rng(5).standard_normal((4, 6))
                    .astype(np.float32))
    assert isinstance(T.nn.functional.relu(x), T.Tensor)
    assert isinstance(T.nn.functional.softmax(torch.ones(3)), T.Tensor)
    assert isinstance(T.incubate.nn.functional.swiglu(x), T.Tensor)
    assert isinstance(T.zeros([2]), T.Tensor)
    ds = [(np.ones(3, np.float32), np.int64(1))] * 4
    loader = T.io.DataLoader(ds, batch_size=2)
    batch = next(iter(loader))
    assert all(isinstance(t, T.Tensor) for t in batch)


# ----------------------------------------------- a method-style program

def _method_style_train(M, w0, b0, xs, ys, steps=4, lr=0.1):
    """A two-parameter regression written only with the reference's
    methods; returns the losses and the last gradients."""
    w = M.create_parameter(list(w0.shape), "float32")
    bias = M.create_parameter(list(b0.shape), "float32", is_bias=True)
    w.set_value(w0)
    bias.set_value(b0)
    losses, grads = [], None
    for s in range(steps):
        x = M.to_tensor(xs[s])
        y = M.to_tensor(ys[s])
        h = x.matmul(w).add(bias).tanh()
        pred = h.transpose([1, 0]).sum(axis=0, keepdim=True).transpose(
            [1, 0])
        err = pred.subtract(y)
        loss = err.square().mean().add(h.abs().max(axis=1).mean().scale(
            0.01))
        loss.backward()
        losses.append(float(loss))
        grads = [w.grad.numpy().copy(), bias.grad.numpy().copy()]
        for p in (w, bias):
            p.set_value(p.numpy() - lr * p.grad.numpy())
            p.clear_grad()
    return losses, grads


def test_method_style_training_matches_the_reference():
    r = np.random.default_rng(6)
    w0 = r.standard_normal((5, 3)).astype(np.float32) * 0.5
    b0 = r.standard_normal((3,)).astype(np.float32) * 0.1
    xs = r.standard_normal((4, 8, 5)).astype(np.float32)
    ys = r.standard_normal((4, 8, 1)).astype(np.float32)
    jl, jg = _method_style_train(P, w0, b0, xs, ys)
    tl, tg = _method_style_train(T, w0, b0, xs, ys)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for a, c in zip(tg, jg):
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-6)
    assert tl[-1] < tl[0]
