"""The port's DiT family, its diffusion schedule and ``DiTTrainStep``
against the JAX package (the cases of ``tests/test_dit.py``, held against
the reference rather than alone).

``DiTConfig.tiny()`` (s 16, head dim 16: both packages attend with the
plain einsum-softmax).  The adaLN and head parameters start at zero, so
the forward cases first set them to random values in both packages; the
trainer cases carry the reference's ``init_state`` into the port with
``restore_canonical``.  The class dropout draws from JAX's threefry in the
reference and from a ``torch.Generator`` in the port, so the parity cases
run at ``class_dropout_prob=0``.  Tolerances (fp32):

- forward, ``eps_fn``: 1e-5 relative to the output's largest value;
- 3 train steps at lr 1e-3: losses rtol 1e-5; params: at most a share
  PARAM_FAR_SHARE of the entries further apart than 1e-5 and none further
  than 2 x lr x steps (Adam's m / sqrt(v) turns last-bit gradient
  differences in near-zero entries into update differences up to 2 x lr a
  step: ``chip_smoke.py``'s PARITY_FAR_SHARE rule); m rtol 1e-4 atol 2e-7,
  v rtol 1e-4 atol 2e-9;
- DDIM at eta 0 from one x_T: rtol 1e-5 atol 1e-5 x the largest |x| (the
  cosine schedule's first step divides by sqrt(alpha_bar) ~ 0.006);
- ``timestep_embedding``: 1.2e-4 (the two packages' exp may differ in a
  frequency's last bit, which t up to 999 scales to 999 x 2^-24 x 2 in the
  argument); the schedules' tables exactly; fp32 ``q_sample`` 2e-6; bf16
  ``q_sample`` one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.models import dit as jdit
from paddle_tpu.utils import functional_call
from paddle_tpu_torch.models import dit
from paddle_tpu_torch.utils import load_reference_state

torch.set_num_threads(2)

PRESETS = ("tiny", "dit_s_2", "dit_b_2", "dit_l_2", "dit_xl_2")
PARAM_FAR_SHARE = 1e-4
ZERO_INIT = ("ada_w", "ada_b", "head")


def _host(tree):
    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().numpy().copy() \
                if x.is_floating_point() else x.numpy().copy()
        return np.array(x, copy=True)
    return jax.tree_util.tree_map(conv, tree)


def _assert_tree_close(got, want, **tol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, a in flat_g:
        np.testing.assert_allclose(a, flat_w[path], err_msg=str(path), **tol)


def _perturb(name, a, rng):
    """A random value for a zero-initialised parameter, else ``a``."""
    if name.split(".")[-1] in ZERO_INIT or name.startswith("final_"):
        return (rng.standard_normal(a.shape) * 0.05).astype(a.dtype)
    return a


def _images(rng, b, c):
    return rng.standard_normal((b, c.in_channels, c.input_size,
                                c.input_size)).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """The reference's ``DiTTrainStep`` state (seed 0) with its zero
    parameters set to random values, as numpy; and the trainer."""
    c = jdit.DiTConfig.tiny(class_dropout_prob=0.0)
    js = jdit.DiTTrainStep(c, lr=1e-3).init_state(seed=0)
    rng = np.random.default_rng(0)
    state = jax.tree_util.tree_map(lambda x: np.array(x, copy=True), js)
    p = state["params"]
    for k in list(p):
        if k == "blocks":
            p[k] = {n: _perturb(n, a, rng) for n, a in p[k].items()}
        else:
            p[k] = _perturb(k, p[k], rng)
    return state


@pytest.mark.parametrize("preset", PRESETS)
def test_configs_and_accounting_match_jax(preset):
    mine = getattr(dit.DiTConfig, preset)()
    ref = getattr(jdit.DiTConfig, preset)()
    for f in ("input_size", "patch_size", "in_channels", "hidden_size",
              "depth", "num_heads", "mlp_ratio", "num_classes",
              "class_dropout_prob", "learn_sigma", "dtype"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert (mine.seq_len, mine.out_channels) == (ref.seq_len, ref.out_channels)
    assert mine.num_params() == ref.num_params()
    assert mine.flops_per_image() == ref.flops_per_image()
    big = getattr(dit.DiTConfig, preset)(input_size=64, learn_sigma=True)
    jbig = getattr(jdit.DiTConfig, preset)(input_size=64, learn_sigma=True)
    assert big.num_params() == jbig.num_params()
    assert big.flops_per_image() == jbig.flops_per_image()


def test_patchify_round_trip_and_zero_init():
    c = dit.DiTConfig.tiny()
    m = dit.DiT(c, device="cpu")
    x = _images(np.random.default_rng(0), 2, c)
    patches = m.patchify(torch.from_numpy(x))
    want = jdit.dit_patchify_raw(jnp.asarray(x), jdit.DiTConfig.tiny())
    np.testing.assert_array_equal(patches.numpy(), np.asarray(want))
    assert tuple(patches.shape) == (2, c.seq_len, 12)
    np.testing.assert_array_equal(m.unpatchify(patches).numpy(), x)
    out = m(torch.from_numpy(x), torch.tensor([0, 5]), torch.tensor([1, 2]))
    assert tuple(out.shape) == (2, c.out_channels, 8, 8)
    assert not out.detach().any()               # adaLN-Zero: eps = 0 at init


def test_timestep_embedding_and_schedules_match_jax():
    t = np.array([0, 1, 7, 100, 999], np.int32)
    for dim in (64, 65, 256):
        want = np.asarray(jdit.timestep_embedding(jnp.asarray(t), dim))
        got = dit.timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-4)
        np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=2e-6)
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    tt = np.array([0, 499, 999], np.int32)
    for schedule in ("linear", "cosine"):
        jd = jdit.GaussianDiffusion(1000, schedule)
        td = dit.GaussianDiffusion(1000, schedule)
        np.testing.assert_array_equal(td.sqrt_ab, np.asarray(jd.sqrt_ab))
        np.testing.assert_array_equal(td.sqrt_1mab, np.asarray(jd.sqrt_1mab))
        want = np.asarray(jd.q_sample(jnp.asarray(x0), jnp.asarray(tt),
                                      jnp.asarray(noise)))
        got = td.q_sample(torch.from_numpy(x0), torch.from_numpy(tt).long(),
                          torch.from_numpy(noise)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        # bf16: the coefficients are rounded to x0's dtype first
        want16 = np.asarray(jd.q_sample(
            jnp.asarray(x0, jnp.bfloat16), jnp.asarray(tt),
            jnp.asarray(noise, jnp.bfloat16)).astype(jnp.float32))
        got16 = td.q_sample(torch.from_numpy(x0).bfloat16(),
                            torch.from_numpy(tt).long(),
                            torch.from_numpy(noise).bfloat16()).float().numpy()
        np.testing.assert_allclose(got16, want16, rtol=2 ** -7, atol=2 ** -8)
    with pytest.raises(ValueError, match="schedule"):
        dit.GaussianDiffusion(10, "quadratic")


def test_forward_matches_jax_dit_and_eps_fn(carried):
    """The reference's eager ``DiT`` over the carried parameters, the
    port's ``DiT`` with them loaded, and the port's ``eps_fn`` over the
    same tree."""
    c = jdit.DiTConfig.tiny(class_dropout_prob=0.0)
    paddle.seed(0)
    jm = jdit.DiT(c)
    p = carried["params"]
    names = {"pos_embed": p["pos"], "patch_proj.weight": p["patch"],
             "t_embedder.fc1.weight": p["t_fc1"],
             "t_embedder.fc2.weight": p["t_fc2"],
             "y_embedder.table": p["label"], "final.ada_w": p["final_ada_w"],
             "final.ada_b": p["final_ada_b"], "final.head": p["final_head"]}
    for i in range(c.depth):
        names.update({f"blocks.{i}.{n}" + (".weight" if n in ("qkv", "proj",
                                                              "fc1", "fc2")
                                           else ""): a[i]
                      for n, a in p["blocks"].items()})
    rng = np.random.default_rng(2)
    x = _images(rng, 3, c)
    t, y = np.array([3, 70, 900], np.int32), np.array([0, 9, 10], np.int32)
    want = np.asarray(jax.jit(lambda pp: functional_call(
        jm, pp, Tensor(jnp.asarray(x)), Tensor(jnp.asarray(t)),
        Tensor(jnp.asarray(y))))({k: jnp.asarray(v)
                                  for k, v in names.items()}))
    tm = dit.DiT(dit.DiTConfig.tiny(class_dropout_prob=0.0), device="cpu")
    assert [n for n, _ in tm.named_parameters()] == list(jm.state_dict())
    load_reference_state(tm, names)
    args = (torch.from_numpy(x), torch.from_numpy(t).long(),
            torch.from_numpy(y).long())
    got = tm(*args).detach().numpy()
    scale = float(np.abs(want).max())
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    ts = dit.DiTTrainStep(dit.DiTConfig.tiny(class_dropout_prob=0.0),
                          device="cpu")
    state = ts.restore_canonical(carried)
    np.testing.assert_array_equal(
        ts.eps_fn(state["params"], *args).detach().numpy(), got)


@pytest.mark.parametrize("remat,wd", [(False, 0.0), (True, 0.05)],
                         ids=["plain", "remat_weight_decay"])
def test_three_train_steps_match_jax(carried, remat, wd):
    c = dict(class_dropout_prob=0.0)
    jstep = jdit.DiTTrainStep(jdit.DiTConfig.tiny(**c), remat=remat, lr=1e-3,
                              weight_decay=wd)
    tstep = dit.DiTTrainStep(dit.DiTConfig.tiny(**c), remat=remat, lr=1e-3,
                             weight_decay=wd, device="cpu")
    js = jax.tree_util.tree_map(jnp.asarray, carried)
    ts = tstep.restore_canonical(carried)
    rng = np.random.default_rng(3)
    x0 = _images(rng, 4, jstep.config)
    t, y = np.array([1, 50, 300, 999], np.int32), np.array([0, 3, 9, 10],
                                                            np.int32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    j_losses, t_losses = [], []
    for _ in range(3):
        js, jl = jstep.train_step(js, *jstep.shard_batch(x0, t, y, noise))
        ts, tl = tstep.train_step(ts, x0, t, y, noise)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]
    want, got = _host(js), _host(tstep.canonical_state(ts))
    assert int(got["step"]) == int(want["step"]) == 3
    g_leaves = jax.tree_util.tree_leaves(got["params"])
    w_leaves = jax.tree_util.tree_leaves(want["params"])
    err = np.concatenate([np.abs(a - b).ravel()
                          for a, b in zip(g_leaves, w_leaves)])
    assert (err > 1e-5).mean() <= PARAM_FAR_SHARE
    assert err.max() <= 2 * 1e-3 * 3
    _assert_tree_close(got["m"], want["m"], rtol=1e-4, atol=2e-7)
    _assert_tree_close(got["v"], want["v"], rtol=1e-4, atol=2e-9)


@pytest.mark.parametrize("guidance", [1.0, 4.0])
def test_ddim_at_eta0_matches_jax_from_one_x_t(carried, guidance):
    c = jdit.DiTConfig.tiny(class_dropout_prob=0.0)
    jstep = jdit.DiTTrainStep(c)
    params = jax.tree_util.tree_map(jnp.asarray, carried["params"])
    tstep = dit.DiTTrainStep(dit.DiTConfig.tiny(class_dropout_prob=0.0),
                             device="cpu")
    tparams = tstep.restore_canonical(carried)["params"]
    shape = (2, c.in_channels, c.input_size, c.input_size)
    key = jax.random.PRNGKey(0)
    # the reference's own draw of x_T: the first split of its key
    x_t = np.asarray(jax.random.normal(jax.random.split(key)[1], shape,
                                       jnp.float32))
    jd, td = jdit.GaussianDiffusion(50), dit.GaussianDiffusion(50)
    want = np.asarray(jd.ddim_sample(
        lambda x, t, y: jstep.eps_fn(params, x, t, y), shape,
        jnp.asarray([0, 1], jnp.int32), key, steps=5,
        guidance_scale=guidance, null_label=c.num_classes))
    calls = []

    def eps(x, t, y):
        calls.append(1)
        return tstep.eps_fn(tparams, x, t, y)

    with torch.no_grad():
        got = td.ddim_sample(eps, shape, torch.tensor([0, 1]), steps=5,
                             guidance_scale=guidance,
                             null_label=c.num_classes,
                             x_T=torch.from_numpy(x_t)).numpy()
    assert len(calls) == 5 * (2 if guidance != 1.0 else 1)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_ddim_draws_x_t_and_noise_from_the_generator():
    c = dit.DiTConfig.tiny()
    ts = dit.DiTTrainStep(c, device="cpu")
    params = ts.init_state(seed=1)["params"]
    td = dit.GaussianDiffusion(50)
    shape = (2, c.in_channels, c.input_size, c.input_size)

    def run(seed, eta):
        with torch.no_grad():
            return td.ddim_sample(
                lambda x, t, y: ts.eps_fn(params, x, t, y), shape,
                torch.tensor([0, 1]), torch.Generator().manual_seed(seed),
                steps=4, eta=eta)
    a, b, d = run(3, 0.5), run(3, 0.5), run(4, 0.5)
    assert torch.equal(a, b) and not torch.equal(a, d)
    assert torch.isfinite(a).all() and not torch.equal(a, run(3, 0.0))


def test_training_loss_is_the_mse_of_its_own_draw(carried):
    c = dit.DiTConfig.tiny(class_dropout_prob=0.0)
    ts = dit.DiTTrainStep(c, device="cpu")
    params = ts.restore_canonical(carried)["params"]
    td = ts.diffusion
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(_images(rng, 4, c))
    t, y = torch.tensor([1, 5, 50, 500]), torch.tensor([0, 1, 2, 3])

    def model(x, tt, yy):
        return ts.eps_fn(params, x, tt, yy)
    loss = td.training_loss(model, x0, t, y, torch.Generator().manual_seed(7))
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(7))
    want = ((model(td.q_sample(x0, t, noise), t, y) - noise) ** 2).mean()
    assert float(loss) == pytest.approx(float(want), rel=1e-6)


def test_null_class_row_trains():
    """``class_dropout_prob`` routes some rows to the null label (the
    reference's ``test_cfg_null_label_gets_trained``); the mask comes from
    a generator seeded from (0xD17, step): the same at a step, another at
    the next."""
    c = dit.DiTConfig.tiny(class_dropout_prob=0.5)
    ts = dit.DiTTrainStep(c, lr=1e-3, device="cpu")
    state = ts.init_state(seed=0)
    before = state["params"]["label"][c.num_classes].detach().clone()
    rng = np.random.default_rng(5)
    x0 = _images(rng, 8, c)
    y = np.zeros(8, np.int64)
    for i in range(3):
        t = np.full(8, 10 * (i + 1), np.int64)
        noise = rng.standard_normal(x0.shape).astype(np.float32)
        state, loss = ts.train_step(state, x0, t, y, noise)
        assert np.isfinite(float(loss))
    after = state["params"]["label"][c.num_classes].detach()
    assert not torch.allclose(before, after)
    yy = torch.zeros(64, dtype=torch.long)
    assert torch.equal(ts.class_drop(yy, 4), ts.class_drop(yy, 4))
    assert not torch.equal(ts.class_drop(yy, 4), ts.class_drop(yy, 5))
    assert 0 < int((ts.class_drop(yy, 4) == c.num_classes).sum()) < 64


def test_flash_route_equals_the_reference_rule():
    """``_patch_attention`` asks for flash at s >= 512, 128 | s, and the
    reference's flash entry then takes Pallas where ``_blocks_for`` gives
    blocks (else its XLA path)."""
    for s in (16, 64, 256, 384, 512, 640, 768, 1024, 1536, 2048, 4096):
        for d in (16, 32, 64, 72, 80, 96, 128, 192, 256):
            want = s >= 512 and s % 128 == 0 and \
                jfa._blocks_for(s, s, d) is not None
            assert dit.flash_route(s, d) == want, (s, d)
    assert not dit.flash_route(256, 72) and not dit.flash_route(1024, 72)
    assert dit.flash_route(1024, 64)


def test_flash_shapes_take_the_flash_entry(monkeypatch):
    """At s 1024, d 64 (DiT-L/2 at 512 px) the block calls the flash
    entry; at DiT-XL/2's d 72 it never does."""
    calls = []
    real = dit.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(dit, "flash_attention", counted)
    rng = np.random.default_rng(6)
    for heads, want in ((1, 1), (2, 0)):       # d 64, then d 32 (plain)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (1, 1024, heads, 64 // heads)).astype(np.float32))
            for _ in range(3))
        calls.clear()
        out = dit._patch_attention(q, k, v)
        assert len(calls) == want and out.shape == q.shape
        jout = jdit._patch_attention(*(jnp.asarray(a.numpy())
                                       for a in (q, k, v)))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-5)


def test_parallel_degrees_raise():
    for kw in (dict(dp=2), dict(mp=2)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 18"):
            dit.DiTTrainStep(dit.DiTConfig.tiny(), device="cpu", **kw)


def test_canonical_state_round_trips_with_the_jax_tree(carried):
    ts = dit.DiTTrainStep(dit.DiTConfig.tiny(class_dropout_prob=0.0),
                          device="cpu")
    state = ts.restore_canonical(carried)
    canon = ts.canonical_state(state)
    assert jax.tree_util.tree_structure(_host(canon)) == \
        jax.tree_util.tree_structure(carried)
    _assert_tree_close(_host(canon), carried, rtol=0, atol=0)
    assert canon["params"]["blocks"]["qkv"].shape == (2, 64, 192)
    again = ts.restore_canonical(canon)
    again["params"]["pos"].data.add_(1.0)
    assert torch.equal(canon["params"]["pos"],
                       torch.from_numpy(carried["params"]["pos"]))
    fresh = ts.init_state(seed=0)
    assert jax.tree_util.tree_structure(_host(ts.canonical_state(fresh))) \
        == jax.tree_util.tree_structure(carried)
    with pytest.raises(ValueError, match="blocks"):
        dit.DiTTrainStep(dit.DiTConfig.tiny(depth=3),
                         device="cpu").restore_canonical(carried)


def test_entry_point_trains_and_samples_on_the_cpu(capsys):
    import json
    assert dit.main(["--preset", "tiny", "--batch", "2", "--steps", "3",
                     "--sample", "--sample-steps", "2", "--device",
                     "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    losses = [x["loss"] for x in lines[:-1]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    last = lines[-1]
    assert last["device"] == "cpu" and last["flash"] is False
    assert last["images_per_s"] > 0 and last["sample_images_per_s"] > 0
    assert last["params"] == dit.DiTConfig.tiny().num_params()
