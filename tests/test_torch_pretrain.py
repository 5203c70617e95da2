"""The port's PretrainStep against the JAX package's, from one carried state.

``LlamaConfig.tiny(num_hidden_layers=2)``, fp32, B=2, T=32 (head_dim 16, so
the JAX side attends with its XLA reference and the port with its plain
version).  The JAX state's canonical form is taken before its first
``train_step`` (which donates its input state) and carried into the port
with ``restore_canonical``; both then take 3 AdamW steps on the same
batches.

Tolerances (fp32, two frameworks' summation orders over 2 layers):
- losses rtol 1e-5;
- first-step gradients rtol 1e-4, atol 5e-6 (|grad| up to ~0.1; sums over
  the batch's tokens that cancel, which XLA's threaded CPU reductions order
  differently from run to run);
- after 3 steps: params atol 1e-5 (3% of one step's lr: AdamW's
  m / sqrt(v) turns the grads' last-bit differences in near-zero entries
  into visible update differences), m rtol 1e-4 atol 2e-7 (|m| <= 0.06),
  v rtol 1e-4 atol 2e-8 (|v| <= 7e-3); a bf16 m within two bf16 ulps
  (rtol 2**-6) or 2e-6 (an entry near zero whose grads cancel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as jllama
from paddle_tpu.models.pretrain import ParallelConfig as JParallelConfig
from paddle_tpu.models.pretrain import PretrainStep as JPretrainStep
from paddle_tpu_torch.models import llama, pretrain

torch.set_num_threads(2)

B, T, STEPS = 2, 32, 3


def _host(tree):
    """A copy of a (JAX or port) canonical state as fp32/int numpy."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            return (x.float() if x.is_floating_point() else x).numpy().copy()
        a = np.array(x, copy=True)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(conv, tree)


def _batches(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (B, T)).astype(np.int32),
             rng.integers(0, vocab, (B, T)).astype(np.int32))
            for _ in range(n)]


def _jax_grads_canonical(g):
    out = dict(g)
    out["blocks"] = {k: np.asarray(v).reshape((-1,) + v.shape[2:])
                     for k, v in g["blocks"].items()}
    return _host(out)


def _port_grads_canonical(g):
    out = {k: g[k] for k in ("embed", "head", "norm")}
    out["blocks"] = {n: torch.stack([lp[n] for lp in g["blocks"]])
                     for n in g["blocks"][0]}
    return _host(out)


def _assert_tree_close(got, want, **tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, a in flat_g:
        np.testing.assert_allclose(a, flat_w[path], err_msg=str(path), **tol)


CONFIGS = {
    "plain": dict(remat=False, loss_chunks=1),
    "remat_full_chunked_ce": dict(remat=True, loss_chunks=4),
    "m_bf16": dict(remat=True, loss_chunks=4, m_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_match_jax_from_a_carried_state(name):
    kw = CONFIGS[name]
    jps = JPretrainStep(jllama.LlamaConfig.tiny(num_hidden_layers=2),
                        JParallelConfig(**kw))
    js = jps.init_state(seed=0)
    carried = jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                                     jps.canonical_state(js))
    tps = pretrain.PretrainStep(llama.LlamaConfig.tiny(num_hidden_layers=2),
                                pretrain.ParallelConfig(**kw), device="cpu")
    ts = tps.restore_canonical(carried)
    _assert_tree_close(_host(tps.canonical_state(ts)), _host(carried),
                       rtol=0, atol=0)
    batches = _batches(256, 1) * STEPS        # one batch, repeated (bench.py)

    if name == "plain":
        ids, labels = (jnp.asarray(x) for x in batches[0])
        j_loss, j_g = jax.jit(jax.value_and_grad(jps._forward_loss))(
            js["params"], ids, labels)
        t_loss, t_g = tps.loss_and_grads(ts["params"], *batches[0])
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
        _assert_tree_close(_port_grads_canonical(t_g),
                           _jax_grads_canonical(j_g), rtol=1e-4, atol=5e-6)
        # the forward alone, and the loss without gradients
        j_logits = jax.jit(jps.forward_logits)(js["params"], ids)
        t_logits = tps.forward_logits(ts["params"],
                                      torch.from_numpy(batches[0][0]).long())
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(tps.eval_loss(ts, *batches[0])),
                                   float(j_loss), rtol=1e-5)

    j_losses, t_losses = [], []
    for ids, labels in batches:
        js, jl = jps.train_step(js, ids, labels)
        ts, tl = tps.train_step(ts, ids, labels)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]

    want = _host(jps.canonical_state(js))
    got = _host(tps.canonical_state(ts))
    assert got["step"].shape == want["step"].shape == ()
    assert int(got["step"]) == int(want["step"]) == STEPS
    _assert_tree_close(got["params"], want["params"], rtol=0, atol=1e-5)
    m_tol = dict(rtol=2 ** -6, atol=2e-6) if name == "m_bf16" else \
        dict(rtol=1e-4, atol=2e-7)
    _assert_tree_close(got["m"], want["m"], **m_tol)
    _assert_tree_close(got["v"], want["v"], rtol=1e-4, atol=2e-8)
    assert ts["m"]["head"].dtype == llama.torch_dtype(kw.get("m_dtype",
                                                             "float32"))


def test_remat_policies_match_no_remat_inside_the_port():
    cfg = llama.LlamaConfig.tiny(num_hidden_layers=2)
    ids, labels = _batches(256, 1, seed=5)[0]
    results = {}
    for policy in ("none", "full", "dots"):
        remat = policy != "none"
        pc = pretrain.ParallelConfig(
            remat=remat, remat_policy=policy if remat else "full",
            loss_chunks=4)
        ps = pretrain.PretrainStep(cfg, pc, device="cpu")
        state = ps.init_state(seed=1)
        loss, g = ps.loss_and_grads(state["params"], ids, labels)
        results[policy] = (float(loss), _port_grads_canonical(g))
    for policy in ("full", "dots"):
        assert results[policy][0] == pytest.approx(results["none"][0],
                                                   rel=1e-6)
        _assert_tree_close(results[policy][1], results["none"][1],
                           rtol=1e-5, atol=1e-7)


def test_port_state_round_trips_through_jax_restore_canonical():
    kw = dict(remat=True, loss_chunks=4)
    tps = pretrain.PretrainStep(llama.LlamaConfig.tiny(num_hidden_layers=2),
                                pretrain.ParallelConfig(**kw), device="cpu")
    ts = tps.init_state(seed=3)
    ts, _ = tps.train_step(ts, *_batches(256, 1)[0])     # m, v, step != 0
    canon = _host(tps.canonical_state(ts))
    jps = JPretrainStep(jllama.LlamaConfig.tiny(num_hidden_layers=2),
                        JParallelConfig(**kw))
    back = _host(jps.canonical_state(jps.restore_canonical(canon)))
    _assert_tree_close(back, canon, rtol=0, atol=0)
    # and back into the port: the restored state shares no memory
    again = tps.restore_canonical(canon)
    _assert_tree_close(_host(tps.canonical_state(again)), canon, rtol=0,
                       atol=0)
    again["params"]["embed"].data.add_(1.0)
    assert not np.array_equal(again["params"]["embed"].detach().numpy(),
                              canon["params"]["embed"])


def test_unported_configurations_raise():
    # MoE trains with the grouped dispatch only (tests/test_torch_moe_train.py)
    pretrain.PretrainStep(llama.LlamaConfig.mixtral_tiny(), device="cpu")
    for dispatch in ("gather", "einsum"):
        with pytest.raises(NotImplementedError, match="MoE training"):
            pretrain.PretrainStep(
                llama.LlamaConfig.mixtral_tiny(moe_dispatch=dispatch),
                device="cpu")
    for kw in (dict(dp=2), dict(pp=2, micro_batches=2), dict(mp=2),
               dict(zero1=True), dict(schedule="1f1b"),
               dict(grad_comm="ring")):
        with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
            pretrain.ParallelConfig(**kw)
    with pytest.raises(ValueError, match="remat_policy"):
        pretrain.ParallelConfig(remat_policy="dots")
    with pytest.raises(ValueError, match="remat_policy"):
        pretrain.ParallelConfig(remat=True, remat_policy="some")
    ps = pretrain.PretrainStep(llama.LlamaConfig.tiny(), device="cpu")
    assert ps.flops_per_token() == 6.0 * ps.config.num_params()
    assert ps.config.num_params() == \
        jllama.LlamaConfig.tiny().num_params()
    with pytest.raises(ValueError, match="loss_chunks"):
        pretrain.PretrainStep(
            llama.LlamaConfig.tiny(),
            pretrain.ParallelConfig(loss_chunks=5), device="cpu").train_step(
                ps.init_state(), *_batches(256, 1)[0])


def test_entry_point_trains_on_the_cpu(capsys):
    assert pretrain.main(["--preset", "tiny", "--batch", "2", "--seq", "32",
                          "--steps", "3", "--loss-chunks", "4",
                          "--device", "cpu"]) == 0
    lines = [__import__("json").loads(x)
             for x in capsys.readouterr().out.splitlines()]
    losses = [x["loss"] for x in lines[:-1]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    last = lines[-1]
    assert last["device"] == "cpu" and last["mfu_6n"] is None
    assert last["tokens_per_s"] > 0
