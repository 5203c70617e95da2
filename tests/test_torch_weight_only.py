"""The port's weight-only quantization (``paddle_tpu_torch.quantization`` and
``paddle_tpu_torch.kernels.weight_only``) against the JAX package on the
CPU, on numpy inputs from a seed.

- ``weight_quantize``, ``weight_dequantize`` and the int4 nibble packing
  must equal the reference bitwise.
- ``weight_only_matmul``'s plain version (the CUDA kernel's oracle) is held
  against the Pallas ``_wo_kernel`` run in interpret mode (the exact kernel
  code the TPU compiles): fp32 within rtol 1e-5 + 1e-5 of the largest
  output (the two packages sum k in other orders), bf16 within one bf16
  ulp of the largest output (both sum in fp32 and round once).
- Shapes the reference cannot tile go to its XLA fallback, which applies
  the scale before the dot (one more fp32 rounding per weight): fp32 within
  rtol 2e-5 + 2e-5 of the largest output.
- ``dx`` is held against ``jax.vjp`` through the interpreted kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.weight_only as jwo
from paddle_tpu import flags
from paddle_tpu import quantization as jq
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import quantization as tq
from paddle_tpu_torch.kernels import weight_only as wo

torch.set_num_threads(2)

BLOCKS = dict(block_m=8, block_n=128, block_k=128)   # the JAX tests' tiles


def _weights(seed, k, n, algo="weight_only_int8"):
    """A numpy weight and the port's (q, scale) of it."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    q, s = tq.weight_quantize(torch.from_numpy(w), algo=algo)
    return w, q, s


def _x(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _np(a):
    """A JAX array or torch tensor as fp32 numpy (bf16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    big = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * big)
    else:  # one bf16 ulp of the largest output
        ulp = 2.0 ** (np.floor(np.log2(big)) - 7) if big else 0.0
        assert float(np.abs(got - want).max()) <= ulp


# ------------------------------------------------------- packing, bitwise ---

def test_int8_shifts_and_unpack_match_jnp_over_all_bytes():
    b = np.arange(-128, 128, dtype=np.int8).reshape(128, 2)
    t, j = torch.from_numpy(b), jnp.asarray(b)
    assert np.array_equal((t << 4).numpy(), np.asarray(jnp.left_shift(j, 4)))
    assert np.array_equal(((t << 4) >> 4).numpy(),
                          np.asarray(jnp.right_shift(jnp.left_shift(j, 4), 4)))
    assert np.array_equal((t >> 4).numpy(), np.asarray(jnp.right_shift(j, 4)))
    got = tq._unpack_int4(t, 256)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(jq._unpack_int4(j, 256)))


@pytest.mark.parametrize("k", [64, 33])
def test_pack_int4_matches_jnp_and_round_trips(k):
    q = np.random.default_rng(k).integers(-8, 8, (k, 24)).astype(np.int8)
    packed = tq._pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.int8 and packed.shape == ((k + 1) // 2, 24)
    assert np.array_equal(packed.numpy(),
                          np.asarray(jq._pack_int4(jnp.asarray(q))))
    assert np.array_equal(tq._unpack_int4(packed, k).numpy(), q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [64, 33])
@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4",
                                  "llm.int8"])
def test_weight_quantize_bitwise(algo, k, dtype):
    """q and the fp32 scale bit for bit; column 5 is all zero (the 1e-10
    clamp of its scale, codes 0)."""
    w = np.random.default_rng(k).standard_normal((k, 96)).astype(np.float32)
    w[:, 5] = 0
    jqw, js = jq.weight_quantize(Tensor(jnp.asarray(w).astype(dtype)),
                                 algo=algo)
    q, s = tq.weight_quantize(torch.from_numpy(w).to(getattr(torch, dtype)),
                              algo=algo)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jqw._data))
    assert np.array_equal(s.numpy().view(np.int32),
                          np.asarray(js._data).view(np.int32))
    assert float(s[5]) == np.float32(1e-10) and not q[:, 5].any()


def test_weight_quantize_unknown_algo_raises():
    with pytest.raises(ValueError, match="algo"):
        tq.weight_quantize(torch.zeros(4, 4), algo="int3")


@pytest.mark.parametrize("algo,k,in_features,out_dtype", [
    ("weight_only_int8", 64, None, "float32"),
    ("weight_only_int8", 64, None, "bfloat16"),
    ("weight_only_int4", 64, None, "float32"),
    ("weight_only_int4", 33, 33, "float32"),
    ("weight_only_int4", 33, 33, "bfloat16"),
])
def test_weight_dequantize_bitwise(algo, k, in_features, out_dtype):
    _, q, s = _weights(k, k, 48, algo)
    jd = jq.weight_dequantize(Tensor(jnp.asarray(q.numpy())),
                              Tensor(jnp.asarray(s.numpy())), algo=algo,
                              out_dtype=out_dtype, in_features=in_features)
    d = tq.weight_dequantize(q, s, algo=algo, out_dtype=out_dtype,
                             in_features=in_features)
    assert d.dtype == getattr(torch, out_dtype) and d.shape == (k, 48)
    assert np.array_equal(_np(d).view(np.int32), _np(jd._data).view(np.int32))


# --------------------------------------- matmul vs the interpreted kernel ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_plain_matches_interpreted_kernel(algo, dtype):
    """The block-aligned shape of tests/test_weight_only_kernel.py."""
    m, k, n = 8, 256, 512
    int4 = algo.endswith("int4")
    _, q, s = _weights(1, k, n, algo)
    jx, tx = _x(2, (m, k), dtype)
    want = jwo.weight_only_matmul(jx, jnp.asarray(q.numpy()),
                                  jnp.asarray(s.numpy()),
                                  int4_rows=k if int4 else None,
                                  interpret=True, **BLOCKS)
    got = wo.weight_only_matmul(tx, q, s, int4_rows=k if int4 else None)
    assert got.dtype == tx.dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("algo,dtype", [("weight_only_int8", "float32"),
                                        ("weight_only_int4", "bfloat16")])
def test_plain_matches_interpreted_kernel_leading_dims(algo, dtype):
    int4 = algo.endswith("int4")
    _, q, s = _weights(3, 128, 256, algo)
    jx, tx = _x(4, (2, 4, 128), dtype)
    want = jwo.weight_only_matmul(jx, jnp.asarray(q.numpy()),
                                  jnp.asarray(s.numpy()),
                                  int4_rows=128 if int4 else None,
                                  interpret=True, **BLOCKS)
    got = wo.weight_only_matmul(tx, q, s, int4_rows=128 if int4 else None)
    assert got.shape == (2, 4, 256)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("algo,m,k,n,dtype", [
    ("weight_only_int8", 3, 100, 130, "float32"),
    ("weight_only_int4", 5, 33, 64, "float32"),     # odd int4 k
    ("weight_only_int4", 4, 96, 200, "bfloat16"),
])
def test_untileable_shapes_vs_xla_fallback(algo, m, k, n, dtype):
    """The reference's XLA fallback scales the weight before the dot, so
    fp32 is held within rtol 2e-5 + 2e-5 of the largest output; bf16
    within one ulp of the largest output."""
    int4 = algo.endswith("int4")
    _, q, s = _weights(5, k, n, algo)
    jx, tx = _x(6, (m, k), dtype)
    want = jwo.weight_only_matmul(jx, jnp.asarray(q.numpy()),
                                  jnp.asarray(s.numpy()),
                                  int4_rows=k if int4 else None,
                                  interpret=True)
    got = wo.weight_only_matmul(tx, q, s, int4_rows=k if int4 else None)
    if dtype == "float32":
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(want).max()))
    else:
        _assert_close(got, want, dtype)


def test_empty_batch():
    _, q, s = _weights(7, 128, 256)
    want = jwo.weight_only_matmul(jnp.zeros((0, 128), jnp.float32),
                                  jnp.asarray(q.numpy()),
                                  jnp.asarray(s.numpy()), interpret=True)
    n0 = wo.LAUNCHES
    got = wo.weight_only_matmul(torch.zeros((2, 0, 128)), q, s)
    assert got.shape == (2, 0, 256) and want.shape == (0, 256)
    assert wo.LAUNCHES == n0


def test_contraction_mismatch_raises():
    _, q, s = _weights(8, 128, 256)
    with pytest.raises(ValueError, match="contraction mismatch"):
        jwo.weight_only_matmul(jnp.zeros((4, 64), jnp.float32),
                               jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                               interpret=True)
    with pytest.raises(ValueError, match="contraction mismatch"):
        wo.weight_only_matmul(torch.zeros((4, 64)), q, s)


def test_int4_packed_rows_and_scale_shape_are_checked():
    _, q, s = _weights(9, 64, 32, "weight_only_int4")
    with pytest.raises(ValueError, match="packed rows"):
        wo.weight_only_matmul(torch.zeros((2, 66)), q, s, int4_rows=66)
    with pytest.raises(ValueError, match="scale"):
        wo.weight_only_matmul(torch.zeros((2, 64)), q, s[:16], int4_rows=64)


# --------------------------------------------------- weight_only_linear ---

@pytest.fixture
def kernel_route():
    """The reference routes weight_only_linear to the (interpreted) Pallas
    kernel under this flag; restored afterwards."""
    old = flags.get_flags(["flash_attention_interpret"])
    flags.set_flags({"flash_attention_interpret": True})
    try:
        yield
    finally:
        flags.set_flags(old)


def _linear_pair(algo, with_bias, x_dtype, seed=10):
    k, n = 256, 256                 # tileable at the reference's default tiles
    dt = "int4" if algo.endswith("int4") else "int8"
    _, q, s = _weights(seed, k, n, algo)
    jx, tx = _x(seed + 1, (4, k), x_dtype)
    b = np.random.default_rng(seed + 2).standard_normal(n).astype(np.float32)
    jargs = dict(weight_scale=Tensor(jnp.asarray(s.numpy())), weight_dtype=dt)
    targs = dict(weight_scale=s, weight_dtype=dt)
    if with_bias:
        jargs["bias"] = Tensor(jnp.asarray(b))
        targs["bias"] = torch.from_numpy(b)
    want = jq.weight_only_linear(Tensor(jx), Tensor(jnp.asarray(q.numpy())),
                                 **jargs)
    got = tq.weight_only_linear(tx, q, **targs)
    return got, want


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_weight_only_linear_matches_reference_kernel_route(kernel_route, algo,
                                                           with_bias):
    got, want = _linear_pair(algo, with_bias, "float32")
    _assert_close(got, want._data, "float32")


def test_weight_only_linear_bias_promotes_as_reference(kernel_route):
    """bf16 x with an fp32 bias: the bias is added after the bf16 product,
    so the output is fp32 in both packages, and equal."""
    got, want = _linear_pair("weight_only_int8", True, "bfloat16")
    assert got.dtype == torch.float32 and want._data.dtype == jnp.float32
    np.testing.assert_array_equal(_np(got), _np(want._data))


def test_weight_only_linear_fp32_matches_flag_off_route():
    """With the flag off the reference multiplies by ``q * scale`` rounded
    to x's dtype (quantization/__init__.py:119-124), so that route is an
    oracle only for fp32 x, within the XLA fallback's tolerance."""
    for algo in ("weight_only_int8", "weight_only_int4"):
        got, want = _linear_pair(algo, True, "float32", seed=20)
        want = _np(want._data)
        np.testing.assert_allclose(_np(got), want, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(want).max()))


def test_weight_only_linear_requires_scale():
    _, q, _s = _weights(11, 16, 16)
    with pytest.raises(ValueError, match="weight_scale"):
        tq.weight_only_linear(torch.zeros(2, 16), q)


# ---------------------------------------------------------------- dx ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_dx_matches_jax_vjp_through_interpreted_kernel(algo, dtype):
    m, k, n = 8, 128, 256
    int4 = algo.endswith("int4")
    rows = k if int4 else None
    _, q, s = _weights(12, k, n, algo)
    jx, tx = _x(13, (m, k), dtype)
    jg, tg = _x(14, (m, n), dtype)
    jqw, js = jnp.asarray(q.numpy()), jnp.asarray(s.numpy())
    _, vjp = jax.vjp(lambda a: jwo.weight_only_matmul(
        a, jqw, js, int4_rows=rows, interpret=True, **BLOCKS), jx)
    (want,) = vjp(jg)
    tx.requires_grad_(True)
    wo.weight_only_matmul(tx, q, s, int4_rows=rows).backward(tg)
    assert tx.grad.dtype == tx.dtype
    _assert_close(tx.grad, want, dtype)


def test_wq_and_scale_get_no_gradient():
    """The quantized weight and its scale are frozen inference state: the
    reference returns zero cotangents, the port none (integer tensors carry
    no gradient in torch)."""
    _, q, s = _weights(15, 64, 32)
    s = s.clone().requires_grad_(True)
    x = torch.randn(4, 64, requires_grad=True)
    wo.weight_only_matmul(x, q, s).sum().backward()
    assert x.grad is not None and s.grad is None


# ------------------------------------ chip_smoke's library yardstick ---

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_library_check_holds_a_bf16_scale_call_and_refuses_wrong_answers(
        algo):
    """``chip_smoke._wo_library_check`` passes a call that rounds the scale
    and the dequantized weight ``q * s`` to bf16 before its product (as
    ``torch._weight_int4pack_mm`` does), and raises on one whose output
    columns are out of place."""
    m, k, n = 8, 512, 256
    int4 = algo.endswith("int4")
    _, q, s = _weights(16, k, n, algo)
    _, x = _x(17, (m, k), "bfloat16")
    s_lib = s.to(torch.bfloat16)
    w_lib = (wo._unpack(q, int4, k).float() * s_lib.float()).bfloat16()
    y = (x.float() @ w_lib.float()).bfloat16()
    check = _chip_smoke()._wo_library_check
    assert check("bf16 scale", y, x, q, s_lib, int4, k) <= 1
    with pytest.raises(AssertionError, match="tolerance"):
        check("columns rolled", y.roll(1, dims=1), x, q, s_lib, int4, k)
