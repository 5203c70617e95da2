"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an sm_90 GPU (H100/H200): every test here carries the ``cuda`` marker
and skips without one (the kernels have no CPU mode; their plain versions
are what the CPU tests run).  Imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: fp32 2e-5 (summation order only); bf16 ``out`` 2e-2 abs +
1e-2 rel (one bf16 rounding of the output); ``lse`` is fp32 from bf16
inputs, 1e-3.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(2)


@pytest.fixture
def h100():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 GPU (H100/H200); the kernel has no "
                    "CPU mode — its plain version is what the CPU tests run")
    return torch.device("cuda")


def _inputs(h100, dtype, *, B, T, qh, kvh, d, page, n_pages, width, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(h100).to(dtype)

    return dict(q=rnd(B, T, qh, d), k_cache=rnd(kvh, n_pages, page, d),
                v_cache=rnd(kvh, n_pages, page, d), k_new=rnd(B, T, kvh, d),
                v_new=rnd(B, T, kvh, d),
                block_tables=torch.from_numpy(rng.integers(
                    0, n_pages, (B, width)).astype(np.int32)).to(h100))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol,lse_atol", [
    (torch.float32, 2e-5, 2e-5, 2e-5),
    (torch.bfloat16, 1e-2, 2e-2, 1e-3),
])
@pytest.mark.parametrize("kvh,d,page", [(8, 128, 16), (2, 128, 16),
                                        (1, 64, 8)])
def test_ragged_kernel_vs_plain_on_card(h100, dtype, rtol, atol, lse_atol,
                                        kvh, d, page):
    """Mixed prefill + decode: ragged q_lens with an idle row, a fresh
    prefill (context 0), page-exact contexts, GQA groups 1, 4 and 8."""
    t = _inputs(h100, dtype, B=4, T=8, qh=8, kvh=kvh, d=d, page=page,
                n_pages=16, width=12, seed=kvh)
    ctx = torch.tensor([0, 16, 33, 96], dtype=torch.int32, device=h100)
    ql = torch.tensor([8, 1, 5, 0], dtype=torch.int32, device=h100)
    n0 = pa.LAUNCHES
    out, lse = pa.ragged_paged_attention(
        t["q"], t["k_cache"], t["v_cache"], t["block_tables"], ctx,
        q_lens=ql, k_new=t["k_new"], v_new=t["v_new"], with_lse=True)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == n0 + 1
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    ref, ref_lse = pa._reference_ragged_paged_attention(
        t["q"], t["k_cache"], t["v_cache"], t["block_tables"], ctx, ql,
        t["k_new"], t["v_new"])
    keep = torch.arange(8, device=h100)[None, :] < ql[:, None]
    torch.testing.assert_close(out[keep].float(), ref[keep].float(),
                               rtol=rtol, atol=atol)
    torch.testing.assert_close(lse[keep], ref_lse[keep], rtol=2e-5,
                               atol=lse_atol)


@pytest.mark.cuda
def test_decode_form_and_argument_checks_on_card(h100):
    t = _inputs(h100, torch.float32, B=3, T=1, qh=4, kvh=4, d=128, page=16,
                n_pages=8, width=4, seed=0)
    ctx = torch.tensor([1, 16, 64], dtype=torch.int32, device=h100)
    out = pa.paged_attention(t["q"][:, 0], t["k_cache"], t["v_cache"],
                             t["block_tables"], ctx)
    ref = pa._reference_paged_attention(t["q"][:, 0], t["k_cache"],
                                        t["v_cache"], t["block_tables"], ctx)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    with pytest.raises(TypeError, match="int32"):
        pa.ragged_paged_attention(t["q"], t["k_cache"], t["v_cache"],
                                  t["block_tables"], ctx.long())
    with pytest.raises(ValueError, match="head_dim"):
        q = torch.zeros((3, 1, 4, 32), device=h100)
        kc = torch.zeros((4, 8, 16, 32), device=h100)
        pa.ragged_paged_attention(q, kc, kc, t["block_tables"], ctx)
