"""The port's block-primitive library (``paddle_tpu_torch.kernels.primitives``)
against the JAX package's (``paddle_tpu.kernels.primitives``) on the CPU, on
numpy inputs from a seed; the JAX generators run their Pallas kernels in
interpret mode.

Tolerances:

- tiling helpers, ``unpack_int4``: equal;
- ``reduce_kernel``: bit for bit (both fold the columns left to right, each
  step rounded to x's dtype);
- ``OnlineSoftmax``: ``finalize`` and ``lse`` within 1e-6 (fp32, the same
  blocks); ``dequant_int8``: equal (one fp32 product each);
- ``elementwise_kernel``: fp32 within 1e-6 x |want| + 1e-6 x max |want|
  (the transcendentals differ); bf16 within 2^-7 x max |want|, two bf16
  roundings of the largest output (the reference rounds every op's result
  to bf16, the port computes in fp32 and rounds once);
- ``matmul_kernel``: fp32 within rtol 1e-4, atol 1e-4 (the reference test's
  limits; the sums run in other orders); bf16 inputs with an fp32 output
  within 1e-5 x |want| + 1e-5 x max |want| (exact products, fp32 sums in
  other orders), with a bf16 output also within one bf16 ulp of each
  element (2^-7 x |want|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import primitives as jp
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import primitives as tp

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16),
          "int8": (jnp.int8, torch.int8),
          "int32": (jnp.int32, torch.int32)}

SILU_MUL = tp.KernelFn(lambda a, b: torch.nn.functional.silu(a) * b,
                       "return a / (1.0f + expf(-a)) * b;")
RELU2 = tp.KernelFn(lambda a: torch.clamp_min(a, 0) * 2.0,
                    "return fmaxf(a, 0.0f) * 2.0f;")
FMA3 = tp.KernelFn(lambda a, b, c: a * b + c, "return a * b + c;")
ELEMENTWISE = {  # arity -> (port function, reference function)
    1: (RELU2, lambda x: jnp.maximum(x, 0) * 2.0),
    2: (SILU_MUL, lambda a, b: jax.nn.silu(a) * b),
    3: (FMA3, lambda a, b, c: a * b + c),
}
# max / min propagate NaN (the NaN operand itself) as torch.maximum,
# torch.minimum and jnp.maximum do; fmaxf / fminf alone would drop it
REDUCE = {"max": (tp.KernelFn(torch.maximum, "float m = fmaxf(a, b); "
                              "m = b != b ? b : m; return a != a ? a : m;"),
                  jnp.maximum, -np.inf),
          "min": (tp.KernelFn(torch.minimum, "float m = fminf(a, b); "
                              "m = b != b ? b : m; return a != a ? a : m;"),
                  jnp.minimum, np.inf),
          "add": (tp.KernelFn(torch.add, "return a + b;"), jnp.add, 0.0)}


def _pair(rng, shape, dtype):
    """One numpy draw as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bits(a):
    """The raw bits of a JAX array or torch tensor, as numpy."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.dtype(f"i{a.element_size()}"))
    a = np.asarray(a)
    return a.view(np.dtype(f"i{a.dtype.itemsize}"))


# ---------------------------------------------------------------- tiling

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tiling_helpers_match_the_reference(dtype):
    jd, td = DTYPES[dtype]
    assert tp.LANE == jp.LANE
    assert tp.min_tile(td) == jp.min_tile(jd)
    for dim in (1, 7, 8, 16, 100, 128, 192, 256, 384, 1000, 1024, 4096,
                11008, 32000):
        for target in (8, 128, 256, 512, 1024):
            for axis in ("sublane", "lane"):
                assert tp.pick_block(dim, td, target, axis) == \
                    jp.pick_block(dim, jd, target, axis), (dim, target, axis)
        for mult in (1, 8, 16, 128, 512):
            assert tp.cdiv(dim, mult) == jp.cdiv(dim, mult)
            assert tp.round_up_to(dim, mult) == jp.round_up_to(dim, mult)


# -------------------------------------------------------- building blocks

@pytest.mark.parametrize("bq,kv,d,blk", [(8, 64, 16, 16), (5, 48, 8, 12)])
def test_online_softmax_matches_the_reference(bq, kv, d, blk):
    rng = np.random.default_rng(bq)
    s = rng.standard_normal((bq, kv)).astype(np.float32) * 3
    v = rng.standard_normal((kv, d)).astype(np.float32)
    js = jp.OnlineSoftmax.init(bq, d)
    ts = tp.OnlineSoftmax.init(bq, d, device="cpu")
    update = jax.jit(jp.OnlineSoftmax.update)
    for i in range(0, kv, blk):
        js = update(js, jnp.asarray(s[:, i:i + blk]),
                    jnp.asarray(v[i:i + blk]))
        ts = tp.OnlineSoftmax.update(ts, torch.from_numpy(s[:, i:i + blk]),
                                     torch.from_numpy(v[i:i + blk]))
    for name in ("finalize", "lse"):
        got = getattr(tp.OnlineSoftmax, name)(ts)
        want = getattr(jp.OnlineSoftmax, name)(js)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    want = torch.softmax(torch.from_numpy(s), -1) @ torch.from_numpy(v)
    torch.testing.assert_close(tp.OnlineSoftmax.finalize(ts), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows,cols", [(4, 10), (3, 11), (1, 1), (6, 64)])
def test_unpack_int4_bit_for_bit(rows, cols):
    packed = np.random.default_rng(cols).integers(
        -128, 128, (rows, (cols + 1) // 2)).astype(np.int8)
    got = tp.unpack_int4(torch.from_numpy(packed), cols)
    want = np.asarray(jp.unpack_int4(jnp.asarray(packed), cols))
    assert got.dtype == torch.int8 and got.shape == (rows, cols)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,axis", [((6, 4), -1), ((6, 4), 0),
                                        ((3, 5, 4), -1), ((3, 5, 4), 0),
                                        ((3, 5, 4), 1)])
def test_dequant_int8_matches_the_reference(shape, axis):
    rng = np.random.default_rng(len(shape) + axis)
    q = rng.integers(-128, 128, shape).astype(np.int8)
    s = (rng.random(shape[axis]) + 0.1).astype(np.float32)
    got = tp.dequant_int8(torch.from_numpy(q), torch.from_numpy(s), axis)
    want = jp.dequant_int8(jnp.asarray(q), jnp.asarray(s), axis)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ generators

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 19), (8, 1024)])
@pytest.mark.parametrize("arity", [1, 2, 3])
def test_elementwise_kernel_matches_the_reference(arity, shape, dtype):
    rng = np.random.default_rng(arity)
    ins = [_pair(rng, shape, dtype) for _ in range(arity)]
    fn, ref = ELEMENTWISE[arity]
    want = jp.elementwise_kernel(ref, interpret=True)(*[j for j, _ in ins])
    got = tp.elementwise_kernel(fn)(*[t for _, t in ins])
    assert got.dtype == DTYPES[dtype][1] and got.shape == shape
    g, w = _np(got), _np(want)
    big = float(np.abs(w).max())
    if dtype == "float32":
        tol = 1e-6 * np.abs(w) + 1e-6 * big
    else:
        tol = 2.0 ** -7 * big
    assert np.all(np.abs(g - w) <= tol), float(np.abs(g - w).max())


def test_elementwise_kernel_mixed_dtypes_cast_once_to_the_first():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32))
    b, c = a.flip(0).to(torch.bfloat16), a.flip(1).to(torch.float16)
    got = tp.elementwise_kernel(FMA3)(a.to(torch.bfloat16), b, c)
    want = (a.to(torch.bfloat16).float() * b.float() + c.float()).to(
        torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert tp.elementwise_kernel(FMA3)(c, a, b).dtype == torch.float16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_elementwise_route(dtype):
    """"vec16" when every input and the output start on 16 bytes, whatever
    the numel (an odd one: the tail is masked in the kernel) and the dtype
    mix; a view that starts inside a vector, as an input or as the output,
    takes "scalar"; one that starts a whole vector in takes "vec16"."""
    dt = DTYPES[dtype][1]
    n = 37 * 19
    a, other = torch.zeros(n, dtype=dt), torch.zeros(n, dtype=torch.float32)
    out = torch.empty(n, dtype=dt)
    assert tp._elementwise_route([a, other], out) == "vec16"
    assert tp._elementwise_route([a.view(37, 19)], out.view(37, 19)) == \
        "vec16"
    per16 = 16 // a.element_size()
    buf = torch.zeros(n + per16, dtype=dt)
    assert tp._elementwise_route([buf[1:n + 1], other], out) == "scalar"
    assert tp._elementwise_route([a], buf[1:n + 1]) == "scalar"
    assert tp._elementwise_route([buf[per16:], other], out) == "vec16"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 32), (64, 300), (100, 19)])
@pytest.mark.parametrize("op", list(REDUCE))
def test_reduce_kernel_bit_for_bit(op, shape, dtype):
    """(100, 19) with 64-row blocks takes the reference's one-row-block
    path (rows not a multiple of the block)."""
    rng = np.random.default_rng(shape[1])
    jx, tx = _pair(rng, shape, dtype)
    fn, jfn, init = REDUCE[op]
    want = jp.reduce_kernel(jfn, init, block_rows=64, interpret=True)(jx)
    got = tp.reduce_kernel(fn, init)(tx)
    assert got.dtype == tx.dtype and got.shape == (shape[0],)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_reduce_kernel_is_a_left_fold_not_a_sum():
    """The fold rounds every step to x's dtype: a bf16 row sum differs from
    an fp32 sum rounded once, and the port keeps the fold."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 300)).astype(
        np.float32)).to(torch.bfloat16)
    got = tp.reduce_kernel(REDUCE["add"][0], 0.0)(x)
    acc = x[:, 0]
    for i in range(1, 300):
        acc = acc + x[:, i]           # bf16 + bf16: rounded every step
    assert torch.equal(got, acc)
    assert not torch.equal(got, x.float().sum(-1).to(torch.bfloat16))
    with pytest.raises(ValueError, match="no columns"):
        tp.reduce_kernel(REDUCE["add"][0], 0.0)(x[:, :0])
    assert tp.reduce_kernel(REDUCE["max"][0], -np.inf)(x[:, :1]).equal(x[:, 0])


@pytest.mark.parametrize("m,k,n,blk", [(100, 70, 50, 32), (16, 24, 8, 8)])
@pytest.mark.parametrize("dtype,out", [("float32", None),
                                       ("bfloat16", "float32"),
                                       ("bfloat16", "bfloat16")])
def test_matmul_kernel_matches_the_reference(m, k, n, blk, dtype, out):
    rng = np.random.default_rng(m)
    jx, tx = _pair(rng, (m, k), dtype)
    jw, tw = _pair(rng, (k, n), dtype)
    jout = DTYPES[out][0] if out else None
    tout = DTYPES[out][1] if out else None
    want = jp.matmul_kernel(block_m=blk, block_n=blk, block_k=blk,
                            epilogue=lambda acc: jax.nn.relu(acc) * 2.0,
                            out_dtype=jout, interpret=True)(jx, jw)
    got = tp.matmul_kernel(epilogue=RELU2, out_dtype=tout)(tx, tw)
    assert got.dtype == (tout or tx.dtype) and got.shape == (m, n)
    g, w = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        return
    big = float(np.abs(w).max())
    tol = 1e-5 * np.abs(w) + 1e-5 * big
    if out == "bfloat16":
        tol = tol + 2.0 ** -7 * np.abs(w)
    assert np.all(np.abs(g - w) <= tol), float(np.abs(g - w).max())


def test_matmul_kernel_default_epilogue_and_checks():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))
    torch.testing.assert_close(tp.matmul_kernel()(x, w), x @ w)
    y = tp.matmul_kernel(out_dtype=torch.float16)(x.half(), w.half())
    assert torch.equal(y, (x.half().float() @ w.half().float()).half())
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        tp.matmul_kernel()(x, w.T)
    with pytest.raises(TypeError, match="w"):
        tp.matmul_kernel()(x, w.double())
    with pytest.raises(TypeError, match="out_dtype"):
        tp.matmul_kernel(out_dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        tp.elementwise_kernel(SILU_MUL)(x, x[:3])
    with pytest.raises(TypeError, match="not supported"):
        tp.elementwise_kernel(RELU2)(x.double())


# ------------------------------------------------------- generated builds

def test_generated_header_names_its_own_library():
    """The header carries the functor's body and arity; two bodies give two
    library paths, the same body the same path (checked without nvcc)."""
    h_silu = tp.generated_header("elementwise", SILU_MUL, 2)
    assert "#define PTT_ELEMENTWISE 1" in h_silu
    assert "#define PTT_ELEMENTWISE_ARITY 2" in h_silu
    assert "float ptt_elementwise_fn(float a, float b)" in h_silu
    assert SILU_MUL.cuda in h_silu
    h_relu = tp.generated_header("elementwise", RELU2, 1)
    h_relu3 = tp.generated_header("elementwise",
                                  tp.KernelFn(RELU2.torch, RELU2.cuda), 3)
    h_max = tp.generated_header("reduce", REDUCE["max"][0])
    h_min = tp.generated_header("reduce", REDUCE["min"][0])
    assert "float ptt_reduce_fn(float a, float b)" in h_max
    h_mm = tp.generated_header("matmul", RELU2)
    assert "float ptt_epilogue_fn(float a)" in h_mm
    paths = {_build._target("primitives", h)
             for h in (h_silu, h_relu, h_relu3, h_max, h_min, h_mm, "")}
    assert len(paths) == 7
    assert _build._target("primitives", h_max) == _build._target(
        "primitives", tp.generated_header("reduce", tp.KernelFn(
            torch.maximum, REDUCE["max"][0].cuda)))
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    # the template builds alone: every switch the headers set has a default
    src = (_build.CSRC / "primitives.cu").read_text()
    for macro in ("PTT_ELEMENTWISE", "PTT_ELEMENTWISE_ARITY", "PTT_REDUCE",
                  "PTT_MATMUL", "ptt_elementwise_fn", "ptt_reduce_fn",
                  "ptt_epilogue_fn"):
        assert f"define {macro}" in src or f"float {macro}(" in src, macro
    assert "primitives" in _build.sources()
    with pytest.raises(ValueError, match="CUDA body"):
        tp.generated_header("reduce", tp.KernelFn(torch.add))
    with pytest.raises(ValueError, match="arity"):
        tp.generated_header("elementwise", FMA3, 9)


def test_a_loaded_library_is_found_without_hashing_its_source(monkeypatch):
    """Every kernel wrapper calls ``_build.load`` on each launch: once a
    library is loaded, neither the source nor the header is read or hashed
    again (a hash per launch cost the serve path 60% of its tokens/s)."""
    sentinel = object()
    monkeypatch.setitem(_build._LIBS, ("weight_only", ""), sentinel)
    header = tp.generated_header("reduce", REDUCE["add"][0])
    monkeypatch.setitem(_build._LIBS, ("primitives", header), sentinel)

    def no_target(*args):
        raise AssertionError("the source was hashed for a loaded library")

    monkeypatch.setattr(_build, "_target", no_target)
    assert _build.load("weight_only") is sentinel
    assert _build.load_generated("primitives", header) is sentinel
