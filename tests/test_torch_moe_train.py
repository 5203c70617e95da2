"""The port's MoE training path against the JAX package (CPU tensors: the
grouped-matmul kernels' plain versions).

The JAX side runs through its plain references: on the CPU, with the
grouped-matmul interpret flag off, its ``gmm``/``tgmm`` route to
``_gmm_reference``/``_tgmm_reference`` (its Pallas interpret mode does not
run on the installed jax: ROADMAP Queue 3).  Inputs come from numpy seeds;
everything is fp32.

Tolerances (rtol/atol 1e-5 unless stated; matmul summation order):
- ``gmm`` (``trans_rhs``, ``row_scale``), ``tgmm`` and the
  ``grouped_matmul``, ``_grouped_ffn`` and aux-loss gradients: 1e-5;
- ``PretrainStep`` on ``mixtral_tiny`` (3 steps from one carried state) as
  ``tests/test_torch_pretrain.py`` holds the dense model: losses rtol 1e-5,
  first-step gradients rtol 1e-4 atol 5e-6, after 3 steps params atol 1e-5,
  m rtol 1e-4 atol 2e-7, v rtol 1e-4 atol 2e-8.

The CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import grouped_matmul as jgm
from paddle_tpu.models import llama as jllama
from paddle_tpu.models.pretrain import ParallelConfig as JParallelConfig
from paddle_tpu.models.pretrain import PretrainStep as JPretrainStep
from paddle_tpu_torch.kernels import grouped_matmul as gm
from paddle_tpu_torch.models import llama, pretrain

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
E = 4

_jax_plan = jax.jit(jgm.sorted_dispatch_plan, static_argnums=(1, 2))
_jax_gmm = jax.jit(jgm._gmm_reference, static_argnames=("bm", "trans_rhs"))
_jax_tgmm_ref = jax.jit(jgm._tgmm_reference, static_argnums=3,
                        static_argnames="bm")
_jax_tgmm = jax.jit(jgm.tgmm, static_argnums=3, static_argnames="bm")


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _plan(ids, bm):
    return [np.asarray(a) for a in _jax_plan(jnp.asarray(ids), E, bm)]


def _ids(rng, F, drop=(2,)):
    """F expert ids over E experts; the experts in ``drop`` get none."""
    ids = rng.integers(0, E, F).astype(np.int32)
    for d in drop:
        ids[ids == d] = (d + 1) % E
    return ids


# ---------------------------------------------------------- gmm trans ---

@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("bm", [8, 16])
def test_gmm_trans_rhs_row_scale_plain_matches_jax(bm, fused, scaled):
    rng = np.random.default_rng(100 + bm + 2 * fused + scaled)
    F, C, O = 21, 32, 48
    inv, _pos, tg = _plan(_ids(rng, F), bm)          # expert 2 is empty
    M = inv.shape[0]
    rhs = rng.standard_normal((E, O, C)).astype(np.float32)   # [E, O, C]
    if fused:
        lhs = rng.standard_normal((F + 1, C)).astype(np.float32)
        lhs[-1] = 0                                  # the zero sentinel
        rows = np.where(inv < F, inv, F).astype(np.int32)
    else:
        lhs = rng.standard_normal((M, C)).astype(np.float32)
        rows = None
    scale = rng.standard_normal(M).astype(np.float32) if scaled else None
    want = np.asarray(_jax_gmm(_j(lhs), _j(rhs), _j(tg), bm=bm,
                               trans_rhs=True, rows=_j(rows),
                               row_scale=_j(scale)))
    got = gm.gmm(_t(lhs), _t(rhs), _t(tg), bm=bm, trans_rhs=True,
                 rows=_t(rows), row_scale=_t(scale))
    assert got.shape == (M, O) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if fused:                              # sentinel rows come out exactly 0
        assert not got[_t(rows) == F].any()


def test_gmm_row_scale_on_the_forward_form_matches_jax():
    rng = np.random.default_rng(7)
    inv, _pos, tg = _plan(_ids(rng, 30, drop=()), 8)
    M = inv.shape[0]
    lhs = rng.standard_normal((31, 32)).astype(np.float32)
    rhs = rng.standard_normal((E, 32, 64)).astype(np.float32)
    rows = np.where(inv < 30, inv, 30).astype(np.int32)
    scale = rng.standard_normal(M).astype(np.float32)
    want = np.asarray(_jax_gmm(_j(lhs), _j(rhs), _j(tg), bm=8,
                               rows=_j(rows), row_scale=_j(scale)))
    got = gm.gmm(_t(lhs), _t(rhs), _t(tg), bm=8, rows=_t(rows),
                 row_scale=_t(scale))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ----------------------------------------------------------------- tgmm ---

def _tgmm_case(rng, case, bm):
    if case == "empty_group":
        # a truncated plan: expert 3's span (padding only) is cut, so it
        # owns no tile; expert 2 routes nothing (padding rows only)
        ids = _ids(rng, 27, drop=(2, 3))
        inv, _pos, tg = _plan(ids, bm)
        keep = int((tg != 3).sum())
        return ids, inv[:keep * bm], tg[:keep]
    ids = np.full(27, 1, np.int32)                   # one expert, every row
    inv, _pos, tg = _plan(ids, bm)
    return ids, inv, tg


@pytest.mark.parametrize("rhs_scale", [False, True])
@pytest.mark.parametrize("rhs_rows", [False, True])
@pytest.mark.parametrize("lhs_rows", [False, True])
@pytest.mark.parametrize("case,bm", [("empty_group", 8),
                                     ("one_expert", 16)])
def test_tgmm_plain_matches_jax(case, bm, lhs_rows, rhs_rows, rhs_scale):
    rng = np.random.default_rng([bm, lhs_rows, rhs_rows, rhs_scale])
    ids, inv, tg = _tgmm_case(rng, case, bm)
    F = len(ids)
    M = inv.shape[0]
    K, N = 32, 48
    rows = np.where(inv < F, inv, F).astype(np.int32)

    def operand(width, fused):
        if fused:
            x = rng.standard_normal((F + 1, width)).astype(np.float32)
            x[-1] = 0
            return x, rows
        return rng.standard_normal((M, width)).astype(np.float32), None

    lhs, lr = operand(K, lhs_rows)
    rhs, rr = operand(N, rhs_rows)
    s = rng.standard_normal(M).astype(np.float32) if rhs_scale else None
    args = (_j(lhs), _j(rhs), _j(tg), E)
    kw = dict(bm=bm, lhs_rows=_j(lr), rhs_rows=_j(rr), rhs_scale=_j(s))
    want_ref = np.asarray(_jax_tgmm_ref(*args, **kw))
    want = np.asarray(_jax_tgmm(*args, **kw))
    got = gm.tgmm(_t(lhs), _t(rhs), _t(tg), E, bm=bm, lhs_rows=_t(lr),
                  rhs_rows=_t(rr), rhs_scale=_t(s))
    assert got.shape == (E, K, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if case == "empty_group":                 # a group with no tile: zeros
        assert 3 not in set(tg.tolist()) and not got[3].any()
    else:
        assert (got[1] != 0).any()


# ------------------------------------------------------- grouped_matmul ---

def test_grouped_matmul_gradients_match_jax():
    rng = np.random.default_rng(11)
    bm, C, O = 8, 32, 64
    inv, _pos, tg = _plan(_ids(rng, 29), bm)
    M = inv.shape[0]
    lhs = rng.standard_normal((M, C)).astype(np.float32)
    rhs = rng.standard_normal((E, C, O)).astype(np.float32)
    dy = rng.standard_normal((M, O)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a, b: jgm.grouped_matmul(a, b, jnp.asarray(tg),
                                                       E, bm), _j(lhs),
                       _j(rhs))
    dl_j, dr_j = vjp(jnp.asarray(dy))
    a, b = _t(lhs).requires_grad_(), _t(rhs).requires_grad_()
    y = gm.grouped_matmul(a, b, _t(tg), E, bm)
    dl, dr = torch.autograd.grad(y, (a, b), _t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(dl.numpy(), np.asarray(dl_j), **TOL)
    np.testing.assert_allclose(dr.numpy(), np.asarray(dr_j), **TOL)


# --------------------------------------------------------- _grouped_ffn ---

def _ffn_inputs(seed, N=19, H=64, I=128, k=2):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        xf=rng.standard_normal((N, H)).astype(f),
        wg=(rng.standard_normal((E, H, I)) / 8).astype(f),
        wu=(rng.standard_normal((E, H, I)) / 8).astype(f),
        wd=(rng.standard_normal((E, I, H)) / 11).astype(f),
        gates=rng.random((N, k)).astype(f),
        ids=_ids(rng, N * k),
        dy=rng.standard_normal((N, H)).astype(f))


@pytest.mark.parametrize("dropped", [False, True])
def test_grouped_ffn_forward_and_gradients_match_jax(dropped):
    k, bm = 2, 8
    d = _ffn_inputs(21 + dropped, k=k)
    N = d["xf"].shape[0]
    inv, pos, tg = _plan(d["ids"], bm)
    M = inv.shape[0]
    drop = np.zeros(N * k, bool)
    if dropped:
        # entries whose buffer rows are cut: pos -> the M sentinel, their
        # rows become padding; token 3 loses both of its entries
        drop[[6, 7, 10, 25]] = True
        inv = np.where(np.isin(inv, np.flatnonzero(drop)), N * k,
                       inv).astype(np.int32)
        pos = np.where(drop, M, pos).astype(np.int32)
    plan = (inv, pos, tg)

    def jf(xf, wg, wu, wd, g):
        return jllama._grouped_ffn(xf, wg, wu, wd, g, *map(jnp.asarray, plan),
                                   E, k, bm)

    names = ("xf", "wg", "wu", "wd", "gates")
    y_j, vjp = jax.jit(lambda *a: jax.vjp(jf, *a))(*(_j(d[n]) for n in names))
    g_j = vjp(jnp.asarray(d["dy"]))
    ins = [_t(d[n]).requires_grad_() for n in names]
    y = llama._grouped_ffn(*ins, *map(_t, plan), E, k, bm)
    g = torch.autograd.grad(y, ins, _t(d["dy"]))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    for n, a, w in zip(names, g, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=n,
                                   **TOL)
    if dropped:
        dg = g[4].reshape(N * k)
        assert torch.equal(dg[_t(drop)], torch.zeros(int(drop.sum())))
        assert not y[3].any() and not g[0][3].any()


# ------------------------------------------------------------- MoE block ---

def test_moe_mlp_forward_grouped_and_aux_gradient_match_jax():
    rng = np.random.default_rng(31)
    B, S, H, I, bm = 2, 9, 64, 128, 8
    f = np.float32
    x = rng.standard_normal((B, S, H)).astype(f)
    w = [(rng.standard_normal((H, E))).astype(f),
         (rng.standard_normal((E, H, I)) / 8).astype(f),
         (rng.standard_normal((E, H, I)) / 8).astype(f),
         (rng.standard_normal((E, I, H)) / 11).astype(f)]

    def jfwd(gw):
        return jllama.moe_mlp_forward_grouped(
            jnp.asarray(x), gw, *map(jnp.asarray, w[1:]), top_k=2,
            block_m=bm)

    y_j, aux_j, st_j = jax.jit(jfwd)(jnp.asarray(w[0]))
    daux_j = jax.jit(jax.grad(lambda gw: jfwd(gw)[1]))(jnp.asarray(w[0]))
    gw = _t(w[0]).requires_grad_()
    y, aux, st = llama.moe_mlp_forward_grouped(_t(x), gw, *map(_t, w[1:]),
                                               top_k=2, block_m=bm)
    (daux,) = torch.autograd.grad(aux, gw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(aux.item(), float(aux_j), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), **TOL)
    np.testing.assert_allclose(daux.numpy(), np.asarray(daux_j), **TOL)
    assert daux.abs().max() > 0


# -------------------------------------------------------------- trainer ---

B, T, STEPS = 2, 32, 3
CARRIED_CFG = dict(num_hidden_layers=1)    # the carried-state steps' model


def _host(tree):
    def conv(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            return (x.float() if x.is_floating_point() else x).numpy().copy()
        a = np.array(x, copy=True)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(conv, tree)


def _assert_tree_close(got, want, **tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, a in flat_g:
        np.testing.assert_allclose(a, flat_w[path], err_msg=str(path), **tol)


def _port_grads(g):
    out = {k: g[k] for k in ("embed", "head", "norm")}
    out["blocks"] = {n: torch.stack([lp[n] for lp in g["blocks"]])
                     for n in g["blocks"][0]}
    return _host(out)


def _jax_grads(g):
    out = dict(g)
    out["blocks"] = {k: np.asarray(v).reshape((-1,) + v.shape[2:])
                     for k, v in g["blocks"].items()}
    return _host(out)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (B, T)).astype(np.int32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def first_step_oracle():
    """The reference's loss and gradients at the carried state (seed 0) on
    the steps' batch, without remat and with one loss chunk: remat and
    loss chunking change how the reference computes them, not the
    function, so both parametrizations hold the port against this one
    jitted compile."""
    jps = JPretrainStep(jllama.LlamaConfig.mixtral_tiny(**CARRIED_CFG),
                        JParallelConfig(remat=False, loss_chunks=1))
    js = jps.init_state(seed=0)
    ids, labels = _batch()
    loss, grads = jax.jit(jax.value_and_grad(jps._forward_loss))(
        js["params"], jnp.asarray(ids), jnp.asarray(labels))
    return float(loss), _jax_grads(grads)


@pytest.mark.parametrize("kw", [dict(remat=False, loss_chunks=1),
                                dict(remat=True, loss_chunks=4)],
                         ids=["plain", "remat_full_chunked_ce"])
def test_mixtral_tiny_three_steps_match_jax_from_a_carried_state(
        kw, first_step_oracle):
    # one layer: the steps' cost is mostly JAX tracing and compiling it
    jps = JPretrainStep(jllama.LlamaConfig.mixtral_tiny(**CARRIED_CFG),
                        JParallelConfig(**kw))
    js = jps.init_state(seed=0)
    carried = jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                                     jps.canonical_state(js))
    tps = pretrain.PretrainStep(llama.LlamaConfig.mixtral_tiny(**CARRIED_CFG),
                                pretrain.ParallelConfig(**kw), device="cpu")
    ts = tps.restore_canonical(carried)
    ids, labels = _batch()

    j_loss, j_g = first_step_oracle
    t_loss, t_g = tps.loss_and_grads(ts["params"], ids, labels)
    np.testing.assert_allclose(float(t_loss), j_loss, rtol=1e-5)
    _assert_tree_close(_port_grads(t_g), j_g, rtol=1e-4, atol=5e-6)

    j_losses, t_losses = [], []
    for _ in range(STEPS):
        js, jl = jps.train_step(js, ids, labels)
        ts, tl = tps.train_step(ts, ids, labels)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]
    want = _host(jps.canonical_state(js))
    got = _host(tps.canonical_state(ts))
    assert int(got["step"]) == int(want["step"]) == STEPS
    _assert_tree_close(got["params"], want["params"], rtol=0, atol=1e-5)
    _assert_tree_close(got["m"], want["m"], rtol=1e-4, atol=2e-7)
    _assert_tree_close(got["v"], want["v"], rtol=1e-4, atol=2e-8)
    # the routing health after the steps, on the same batch
    want_rs = jps.router_stats(js, jnp.asarray(ids))
    got_rs = tps.router_stats(ts, ids)
    assert got_rs.keys() == want_rs.keys()
    for key in want_rs:
        np.testing.assert_allclose(got_rs[key], want_rs[key], rtol=1e-6)


def test_mixtral_tiny_remat_policies_match_no_remat_inside_the_port():
    cfg = llama.LlamaConfig.mixtral_tiny()
    ids, labels = _batch(seed=5)
    results = {}
    for policy in ("none", "full", "dots"):
        remat = policy != "none"
        pc = pretrain.ParallelConfig(
            remat=remat, remat_policy=policy if remat else "full",
            loss_chunks=4)
        ps = pretrain.PretrainStep(cfg, pc, device="cpu")
        state = ps.init_state(seed=1)
        loss, g = ps.loss_and_grads(state["params"], ids, labels)
        results[policy] = (float(loss), _port_grads(g))
    for policy in ("full", "dots"):
        assert results[policy][0] == pytest.approx(results["none"][0],
                                                   rel=1e-6)
        _assert_tree_close(results[policy][1], results["none"][1],
                           rtol=1e-5, atol=1e-7)


def _jax_config(cfg):
    return jllama.LlamaConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("preset", ["mixtral_tiny", "mixtral_8x7b"])
def test_router_stats_and_flops_per_token_match_jax(preset):
    cfg = getattr(llama.LlamaConfig, preset)()
    jcfg = _jax_config(cfg)
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.num_active_params() == jcfg.num_active_params()
    for kw in (dict(), dict(remat=True)):
        tps = pretrain.PretrainStep(cfg, pretrain.ParallelConfig(**kw),
                                    device="cpu")
        # the reference's accounting, config arithmetic only (its template
        # layer would allocate a full-width layer)
        jself = types.SimpleNamespace(config=jcfg, pc=JParallelConfig(**kw))
        for remat in (False, True):
            assert tps.flops_per_token(remat) == \
                JPretrainStep.flops_per_token(jself, remat)
    if preset == "mixtral_8x7b":
        # the published model: 46.7 B parameters, 12.9 B active
        assert round(cfg.num_params() / 1e9, 1) == 46.7
        assert round(cfg.num_active_params() / 1e9, 1) == 12.9
        return
    jps = JPretrainStep(jcfg, JParallelConfig())
    js = jps.init_state(seed=2)
    tps = pretrain.PretrainStep(cfg, device="cpu")
    ts = tps.restore_canonical(jax.tree_util.tree_map(
        lambda x: np.array(x, copy=True), jps.canonical_state(js)))
    ids, _ = _batch(seed=3)
    want = jps.router_stats(js, jnp.asarray(ids))
    got = tps.router_stats(ts, ids)
    assert got["kept_frac"] == want["kept_frac"] == 1.0
    np.testing.assert_allclose(got["imbalance"], want["imbalance"],
                               rtol=1e-6)


def test_trainer_refuses_unported_moe_dispatch():
    """The ``gather`` and ``einsum`` forms train since they were ported:
    with a capacity that holds every entry (factor E / top_k) their loss
    and gradients at one state equal the grouped form's (the same exact
    mixture), and every entry is kept."""
    ids, labels = _batch(seed=6)
    results = {}
    for dispatch in ("grouped", "gather", "einsum"):
        ps = pretrain.PretrainStep(
            llama.LlamaConfig.mixtral_tiny(moe_dispatch=dispatch,
                                           moe_capacity_factor=2.0),
            device="cpu")
        state = ps.init_state(seed=4)
        loss, g = ps.loss_and_grads(state["params"], ids, labels)
        results[dispatch] = (float(loss), _port_grads(g))
        assert ps.router_stats(state, ids)["kept_frac"] == 1.0
    for dispatch in ("gather", "einsum"):
        assert results[dispatch][0] == pytest.approx(results["grouped"][0],
                                                     rel=1e-6)
        _assert_tree_close(results[dispatch][1], results["grouped"][1],
                           rtol=1e-5, atol=1e-7)


def test_entry_point_trains_mixtral_tiny_on_the_cpu(capsys):
    assert pretrain.main(["--preset", "mixtral_tiny", "--batch", "2",
                          "--seq", "32", "--steps", "2", "--loss-chunks",
                          "4", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    losses = [x["loss"] for x in lines[:-1]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    last = lines[-1]
    cfg = llama.LlamaConfig.mixtral_tiny()
    assert last["device"] == "cpu" and last["preset"] == "mixtral_tiny"
    assert last["active_params"] == cfg.num_active_params()
    assert last["router_stats"]["kept_frac"] == 1.0
    assert last["router_stats"]["imbalance"] >= 1.0
