"""The port's ragged paged attention and KV commit against the JAX package.

Inputs are made from a seed with numpy and fed to both packages.  The port's
entry points run on CPU tensors here (its plain PyTorch version); they are
held against JAX ``_reference_ragged_paged_attention`` (the plain
reference the JAX package's kernel is tested against) and a dense numpy
oracle, at the ``d=128`` shapes of ``tests/test_inference.py``.  The JAX
Pallas kernel's interpret mode does not run on the installed jax (its
``pltpu.TPUCompilerParams`` is gone; ``tests/test_inference.py``'s interpret
tests fail the same way), so it is not an oracle here.  Output rows past
``q_lens`` are don't-care in both packages and are masked out before any
comparison.

Tolerances: fp32 on the CPU, atol = rtol = 2e-5 (summation order only), as
``tests/test_inference.py`` uses; the numpy oracle 3e-5, as there.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py`` (skipped without a GPU) and by
``chip_smoke.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)

# jitted once per shape: op-by-op JAX dispatch costs seconds per call here
_jax_ragged = jax.jit(jpa._reference_ragged_paged_attention)
_jax_decode = jax.jit(jpa._reference_paged_attention,
                      static_argnames="with_lse")
_jax_write_all = jax.jit(jpa.write_kv_pages_all_layers)
_jax_write = jax.jit(jpa.write_kv_pages)


def _inputs(seed, *, B, T, qh, kvh, d, page, n_pages, width):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        q=rng.standard_normal((B, T, qh, d)).astype(f),
        k_cache=rng.standard_normal((kvh, n_pages, page, d)).astype(f),
        v_cache=rng.standard_normal((kvh, n_pages, page, d)).astype(f),
        k_new=rng.standard_normal((B, T, kvh, d)).astype(f),
        v_new=rng.standard_normal((B, T, kvh, d)).astype(f),
        block_tables=rng.integers(0, n_pages, (B, width)).astype(np.int32))


def _dense_oracle(x, ctx, qlens):
    """Per (row, token, head): softmax over the cached context plus the
    causal prefix of the fresh rows, in float64 numpy."""
    q, kc, vc, kn, vn, bt = (x[k].astype(np.float64) if k != "block_tables"
                             else x[k] for k in ("q", "k_cache", "v_cache",
                                                 "k_new", "v_new",
                                                 "block_tables"))
    B, T, qh, d = q.shape
    kvh = kc.shape[0]
    group = qh // kvh
    out = np.zeros_like(q)
    for b in range(B):
        keys = kc[:, bt[b]].reshape(kvh, -1, d)[:, :ctx[b]]
        vals = vc[:, bt[b]].reshape(kvh, -1, d)[:, :ctx[b]]
        for j in range(qlens[b]):
            for h in range(qh):
                hk = h // group
                ks = np.concatenate([keys[hk], kn[b, :j + 1, hk]], 0)
                vs = np.concatenate([vals[hk], vn[b, :j + 1, hk]], 0)
                s = q[b, j, h] @ ks.T / math.sqrt(d)
                p = np.exp(s - s.max())
                out[b, j, h] = (p / p.sum()) @ vs
    return out


# ------------------------------------------------ mixed prefill + decode ---

@pytest.mark.parametrize("kvh", [8, 4, 2, 1])       # GQA groups 1, 2, 4, 8
def test_ragged_mixed_mode_vs_jax_and_oracle(kvh):
    """Ragged q_lens incl. an idle row, zero prior context (a fresh
    prefill), page-exact contexts, every GQA group the kernel takes."""
    d, page, qh, T, B = 128, 16, 8, 8, 4
    x = _inputs(kvh, B=B, T=T, qh=qh, kvh=kvh, d=d, page=page, n_pages=16,
                width=6)
    ctx = np.asarray([0, 16, 33, 96], np.int32)
    qlens = np.asarray([8, 1, 5, 0], np.int32)
    jargs = [jnp.asarray(x[k]) for k in ("q", "k_cache", "v_cache",
                                         "block_tables")]
    jkw = dict(q_lens=jnp.asarray(qlens), k_new=jnp.asarray(x["k_new"]),
               v_new=jnp.asarray(x["v_new"]))
    ref, ref_lse = _jax_ragged(
        *jargs, jnp.asarray(ctx), jkw["q_lens"], jkw["k_new"], jkw["v_new"])

    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out, lse = pa.ragged_paged_attention(
        t["q"], t["k_cache"], t["v_cache"], t["block_tables"],
        torch.from_numpy(ctx), q_lens=torch.from_numpy(qlens),
        k_new=t["k_new"], v_new=t["v_new"], with_lse=True)
    assert out.shape == (B, T, qh, d) and lse.shape == (B, T, qh)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    oracle = _dense_oracle(x, ctx, qlens)
    for b in range(B):
        n = int(qlens[b])
        np.testing.assert_allclose(out[b, :n].numpy(),
                                   np.asarray(ref[b, :n]), **TOL)
        np.testing.assert_allclose(lse[b, :n].numpy(),
                                   np.asarray(ref_lse[b, :n]), **TOL)
        np.testing.assert_allclose(out[b, :n].numpy(), oracle[b, :n],
                                   rtol=3e-5, atol=3e-5)


# ------------------------------------------------------- decode edges ---

@pytest.mark.parametrize("qh,kvh,ctx", [
    (4, 4, (8, 64, 16, 32)),        # page-exact contexts, 1 and max pages
    (4, 2, (1, 64, 1, 40)),         # single-token next to max-page
    (8, 2, (5, 64, 8, 17)),         # GQA ratio 4, ragged
    (8, 1, (64, 1, 33, 24)),        # MQA-ish ratio 8
])
def test_paged_attention_edge_cases_vs_jax(qh, kvh, ctx):
    """The decode form (``paged_attention``, no fresh rows) vs the JAX
    reference and a dense oracle."""
    d, page, n_pages = 128, 8, 64
    x = _inputs(qh * 10 + kvh, B=4, T=1, qh=qh, kvh=kvh, d=d, page=page,
                n_pages=n_pages, width=8)
    q = x["q"][:, 0]
    cl = np.asarray(ctx, np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(x["k_cache"]),
             jnp.asarray(x["v_cache"]), jnp.asarray(x["block_tables"]),
             jnp.asarray(cl))
    ref, ref_lse = _jax_decode(*jargs, with_lse=True)
    out, lse = pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(x["k_cache"]),
        torch.from_numpy(x["v_cache"]), torch.from_numpy(x["block_tables"]),
        torch.from_numpy(cl), with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)
    # the port's own decode oracle agrees with its ragged form
    np.testing.assert_allclose(
        pa._reference_paged_attention(
            torch.from_numpy(q), torch.from_numpy(x["k_cache"]),
            torch.from_numpy(x["v_cache"]),
            torch.from_numpy(x["block_tables"]), torch.from_numpy(cl)).numpy(),
        out.numpy(), rtol=0, atol=0)
    # dense oracle over the cached context
    for b in range(4):
        keys = x["k_cache"][:, x["block_tables"][b]].reshape(kvh, -1, d)
        vals = x["v_cache"][:, x["block_tables"][b]].reshape(kvh, -1, d)
        for h in range(qh):
            hk = h // (qh // kvh)
            s = q[b, h] @ keys[hk, :ctx[b]].T / math.sqrt(d)
            p = np.exp(s - s.max())
            np.testing.assert_allclose(out[b, h].numpy(),
                                       (p / p.sum()) @ vals[hk, :ctx[b]],
                                       rtol=2e-5, atol=2e-5)


def test_table_entries_past_context_are_never_used():
    """Block-table entries past a sequence's context are garbage: any
    values there (even out of range) give the same output."""
    x = _inputs(7, B=3, T=4, qh=4, kvh=2, d=64, page=8, n_pages=12, width=5)
    ctx = np.asarray([8, 17, 0], np.int32)     # 1, 3 and 0 live pages
    qlens = np.asarray([4, 2, 3], np.int32)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    clean = t["block_tables"].clone()
    for b, live in enumerate((1, 3, 0)):
        clean[b, live:] = 0
    garbage = clean.clone()
    for b, live in enumerate((1, 3, 0)):
        garbage[b, live:] = torch.tensor([10 ** 6, -7, 99, 12, -1])[live:]
    outs = [pa.ragged_paged_attention(
        t["q"], t["k_cache"], t["v_cache"], bt, torch.from_numpy(ctx),
        q_lens=torch.from_numpy(qlens), k_new=t["k_new"], v_new=t["v_new"],
        with_lse=True) for bt in (clean, garbage)]
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


def test_entry_point_argument_checks():
    x = _inputs(0, B=1, T=1, qh=3, kvh=2, d=64, page=8, n_pages=2, width=1)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    with pytest.raises(ValueError, match="multiple"):
        pa.ragged_paged_attention(t["q"], t["k_cache"], t["v_cache"],
                                  t["block_tables"], torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="together"):
        pa.ragged_paged_attention(t["q"][:, :, :2], t["k_cache"],
                                  t["v_cache"], t["block_tables"],
                                  torch.ones(1, dtype=torch.int32),
                                  k_new=t["k_new"])


# ------------------------------------------------------------- commits ---

@pytest.mark.parametrize("slots", [
    [3, -1, 17, 40, -1, 0],          # dropped tokens mixed in
    [-1, -1, -1, -1, -1, -1],        # everything dropped
    [47, 46, 5, 6, 7, 8],            # nothing dropped
])
def test_write_kv_pages_all_layers_vs_jax(slots):
    rng = np.random.default_rng(len(slots) + slots[0])
    L, kvh, n_pages, page, d, n = 2, 2, 6, 8, 16, 6
    kc = rng.standard_normal((L, kvh, n_pages, page, d)).astype(np.float32)
    vc = rng.standard_normal((L, kvh, n_pages, page, d)).astype(np.float32)
    ka = rng.standard_normal((L, n, kvh, d)).astype(np.float32)
    va = rng.standard_normal((L, n, kvh, d)).astype(np.float32)
    sl = np.asarray(slots, np.int32)
    jk, jv = _jax_write_all(
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ka), jnp.asarray(va),
        jnp.asarray(sl))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    rk, rv = pa.write_kv_pages_all_layers(tk, tv, torch.from_numpy(ka),
                                          torch.from_numpy(va),
                                          torch.from_numpy(sl))
    assert rk is tk and rv is tv                     # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_write_kv_pages_single_layer_vs_jax():
    rng = np.random.default_rng(5)
    kvh, n_pages, page, d = 2, 4, 8, 16
    kc = rng.standard_normal((kvh, n_pages, page, d)).astype(np.float32)
    vc = rng.standard_normal((kvh, n_pages, page, d)).astype(np.float32)
    kn = rng.standard_normal((5, kvh, d)).astype(np.float32)
    vn = rng.standard_normal((5, kvh, d)).astype(np.float32)
    sl = np.asarray([9, -1, 31, 0, -1], np.int32)
    jk, jv = _jax_write(jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(kn), jnp.asarray(vn),
                                jnp.asarray(sl))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pa.write_kv_pages(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                      torch.from_numpy(sl))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
