"""The port's ``gather`` and ``einsum`` MoE dispatch forms against the JAX
package (CPU tensors; both forms are plain PyTorch ops in the port, as they
are XLA ops in the reference).

- ``capacity_dispatch_plan``: its four outputs equal the reference's element
  for element, with drops (capacity factor 0.5) and without;
- ``moe_mlp_forward`` (gather) and ``moe_mlp_forward_einsum`` (groups 0, 1,
  2): ``y``, the aux loss, the stats ``[kept_frac, imbalance]`` and the
  gradients of ``sum(y²) + aux`` w.r.t. x and every weight: rtol/atol 1e-5
  (fp32 matmul summation order); kept_frac rtol 1e-6 (a mean of 0s and 1s);
- einsum at one group routes as gather: equal within 1e-6;
- ``mixtral_tiny`` ``PretrainStep`` in each form, 3 steps from one carried
  state against the reference's trainer, held as
  ``tests/test_torch_moe_train.py`` holds the grouped one;
- the serving engine's greedy tokens with ``moe_dispatch="gather"`` (its
  dense expert loop, in both packages) equal the reference engine's;
- neither form reads a value back to the host: both run, forward and
  backward, on meta tensors, where any host read raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationConfig as JGen
from paddle_tpu.inference import LlamaGenerator as JGenerator
from paddle_tpu.kernels import grouped_matmul as jgm
from paddle_tpu.models import llama as jllama
from paddle_tpu.models.pretrain import ParallelConfig as JParallelConfig
from paddle_tpu.models.pretrain import PretrainStep as JPretrainStep
from paddle_tpu_torch.inference import GenerationConfig, LlamaGenerator
from paddle_tpu_torch.kernels import grouped_matmul as gm
from paddle_tpu_torch.models import llama, pretrain
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, H, I, E, K = 2, 9, 16, 32, 4, 2

_jax_plan = jax.jit(jgm.capacity_dispatch_plan, static_argnums=(2, 3))


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.standard_normal((B, S, H)).astype(f),
            rng.standard_normal((H, E)).astype(f),
            (rng.standard_normal((E, H, I)) / 4).astype(f),
            (rng.standard_normal((E, H, I)) / 4).astype(f),
            (rng.standard_normal((E, I, H)) / 6).astype(f)]


@pytest.mark.parametrize("cap", [1, 3, 12])
def test_capacity_dispatch_plan_matches_jax(cap):
    """N 12, top-2 over 4 experts: capacity 1 and 3 drop entries (capacity
    factor 0.5 is cap 3), 12 (= N) drops none."""
    rng = np.random.default_rng(cap)
    N = 12
    ids = np.stack([rng.permutation(E)[:K] for _ in range(N)]).astype(np.int32)
    vals = rng.random((N, K)).astype(np.float32)
    want = [np.asarray(a) for a in _jax_plan(jnp.asarray(ids),
                                             jnp.asarray(vals), E, cap)]
    got = [a.numpy() for a in gm.capacity_dispatch_plan(
        torch.from_numpy(ids), torch.from_numpy(vals), E, cap)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (not got[3].all()) == (cap < N)


def _form(name, groups):
    def port(*a):
        if name == "gather":
            return llama.moe_mlp_forward(*a, top_k=K, capacity_factor=1.25)
        return llama.moe_mlp_forward_einsum(*a, top_k=K, capacity_factor=1.25,
                                            groups=groups)

    def ref(*a):
        if name == "gather":
            return jllama.moe_mlp_forward(*a, top_k=K, capacity_factor=1.25)
        return jllama.moe_mlp_forward_einsum(*a, top_k=K,
                                             capacity_factor=1.25,
                                             groups=groups)
    return port, ref


@pytest.mark.parametrize("name,groups", [("gather", None), ("einsum", 0),
                                         ("einsum", 1), ("einsum", 2)])
def test_form_outputs_and_gradients_match_jax(name, groups):
    port, ref = _form(name, groups)
    w = _weights()

    def jloss(*a):
        y, aux, _ = ref(*a)
        return jnp.sum(y * y) + aux

    y_j, aux_j, st_j = jax.jit(ref)(*map(jnp.asarray, w))
    g_j = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        *map(jnp.asarray, w))
    args = [torch.from_numpy(a).requires_grad_() for a in w]
    y, aux, st = port(*args)
    g = torch.autograd.grad((y * y).sum() + aux, args)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(float(aux), float(aux_j), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=1e-6)
    assert float(st[0]) < 1.0                   # capacity 1.25 drops here
    for a, b in zip(g, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert float(g[1].abs().max()) > 0          # the router is trained


def test_einsum_at_one_group_equals_gather():
    w = [torch.from_numpy(a) for a in _weights(1)]
    for cf in (0.5, 1.25, 2.0):
        ya, auxa, sa = llama.moe_mlp_forward(*w, top_k=K, capacity_factor=cf)
        yb, auxb, sb = llama.moe_mlp_forward_einsum(*w, top_k=K,
                                                    capacity_factor=cf,
                                                    groups=1)
        np.testing.assert_allclose(yb.numpy(), ya.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(float(auxb), float(auxa), rtol=1e-6)
        np.testing.assert_allclose(sb.numpy(), sa.numpy(), rtol=1e-6)


def test_bad_moe_groups_raises():
    w = [torch.from_numpy(a) for a in _weights()]
    with pytest.raises(ValueError, match="moe_groups"):
        llama.moe_mlp_forward_einsum(*w, top_k=K, capacity_factor=1.25,
                                     groups=5)        # 18 tokens
    cfg = llama.LlamaConfig.mixtral_tiny(moe_dispatch="einsum", moe_groups=5)
    m = llama.LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="moe_groups"):
        m(torch.zeros((2, 9), dtype=torch.long))


def test_forms_read_nothing_back():
    """On meta tensors any host read (``.item()``, ``.tolist()``, a
    data-dependent shape such as ``nonzero``) raises: both forms run their
    forward and backward there, so on the card they enqueue without a
    sync."""
    meta = dict(device="meta")
    x = torch.empty((B, S, H), **meta, requires_grad=True)
    gw = torch.empty((H, E), **meta, requires_grad=True)
    wg, wu = (torch.empty((E, H, I), **meta, requires_grad=True)
              for _ in range(2))
    wd = torch.empty((E, I, H), **meta, requires_grad=True)
    for fn, kw in ((llama.moe_mlp_forward, {}),
                   (llama.moe_mlp_forward_einsum, dict(groups=3))):
        y, aux, st = fn(x, gw, wg, wu, wd, top_k=K, capacity_factor=1.25,
                        **kw)
        grads = torch.autograd.grad((y * y).sum() + aux, [x, gw, wg, wu, wd])
        assert y.shape == (B, S, H) and st.shape == (2,)
        assert [tuple(g.shape) for g in grads] == [
            (B, S, H), (H, E), (E, H, I), (E, H, I), (E, I, H)]
    with pytest.raises(RuntimeError, match="meta"):
        st.tolist()


# -------------------------------------------------------------- trainer ---

STEPS = 3


def _host(tree):
    def conv(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            return (x.float() if x.is_floating_point() else x).numpy().copy()
        return np.array(x, copy=True)
    return jax.tree_util.tree_map(conv, tree)


def _assert_tree_close(got, want, **tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, a in flat_g:
        np.testing.assert_allclose(a, flat_w[path], err_msg=str(path), **tol)


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_mixtral_tiny_trains_like_jax_in_each_form(dispatch):
    """One layer, B 2, T 32, capacity factor 0.5 (entries drop in both
    forms; einsum's groups are the batch rows), 3 AdamW steps from the
    reference's state carried with ``restore_canonical``."""
    kw = dict(num_hidden_layers=1, moe_dispatch=dispatch,
              moe_capacity_factor=0.5)
    jps = JPretrainStep(jllama.LlamaConfig.mixtral_tiny(**kw),
                        JParallelConfig())
    js = jps.init_state(seed=0)
    carried = jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                                     jps.canonical_state(js))
    tps = pretrain.PretrainStep(llama.LlamaConfig.mixtral_tiny(**kw),
                                device="cpu")
    ts = tps.restore_canonical(carried)
    rng = np.random.default_rng(0)
    ids, labels = (rng.integers(0, 256, (2, 32)).astype(np.int32)
                   for _ in range(2))
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
    _assert_tree_close(got["params"], want["params"], rtol=0, atol=1e-5)
    _assert_tree_close(got["m"], want["m"], rtol=1e-4, atol=2e-7)
    _assert_tree_close(got["v"], want["v"], rtol=1e-4, atol=2e-8)
    want_rs = jps.router_stats(js, jnp.asarray(ids))
    got_rs = tps.router_stats(ts, ids)
    assert got_rs["kept_frac"] < 1.0
    for key in want_rs:
        np.testing.assert_allclose(got_rs[key], want_rs[key], rtol=1e-6)


def test_engine_greedy_tokens_with_gather_dispatch_match_jax():
    cfg = dict(moe_dispatch="gather", moe_block_m=8)
    paddle.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.mixtral_tiny(**cfg))
    tm = llama.LlamaForCausalLM(llama.LlamaConfig.mixtral_tiny(**cfg),
                                device="cpu")
    load_reference_state(tm, {k: np.asarray(v._data)
                              for k, v in jm.state_dict().items()})
    prompts = [[3, 14, 15, 9, 2, 6], [5, 3]]
    kw = dict(max_batch=2, max_seq_len=64, page_size=8, prefill_bucket=8)
    want = JGenerator(jm, **kw).generate(prompts, JGen(max_new_tokens=8))
    got = LlamaGenerator(tm, device="cpu", **kw).generate(
        prompts, GenerationConfig(max_new_tokens=8))
    assert got == want and all(len(g) == 8 for g in got)
