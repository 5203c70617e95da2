"""The spatial half of ``nn`` as a whole, on the CPU: the two networks of
``chip_smoke.py``'s ``spatial_models`` (its ``_ddpm_unet`` and
``_unet3d``, written against the Paddle API) at narrow widths, built from
each package's layers, trained two Adam steps in both.

- DDPM's U-Net (Ho et al. 2020, App. B): ``GroupNorm`` + SiLU residual
  blocks with a time-embedding projection, self-attention at one
  resolution, stride-2 "SAME" 3x3 convolutions down, ``Upsample(2,
  "nearest")`` + a 3x3 convolution up, skips concatenated; 2 levels, 16
  channels, ``GroupNorm(4)``, dropout 0, 16 px; the epsilon-prediction MSE
  with the sinusoidal time embedding made in numpy.
- The 3D U-Net (Cicek et al. 2016): two valid 3x3x3 ``Conv3D`` +
  ``BatchNorm3D`` (training) + ReLU a level, ``MaxPool3D(2)`` down,
  ``Conv3DTranspose(2, stride 2)`` up with center-cropped skips, a 1x1x1
  head to 3 classes; 2 levels, 4 base channels, a 20^3 tile to a 4^3
  output; softmax cross-entropy over the voxels.

Each step starts the port from the reference's parameters and BatchNorm
statistics (``_train_both``): the loss, every gradient (at least
``TRAIN_TOL`` of its tensor's largest value) and, after both Adam steps,
every parameter entry whose reference gradient was above ``NOISE`` at
each step and the running statistics, within ``TRAIN_TOL``.  Adam's
first updates are about lr x sign(grad), so an entry whose gradient is
rounding noise (a convolution's bias ahead of a norm, which cancels it)
moves 2 lr apart; those are left out and counted.  The reference's step
is one jitted ``value_and_grad`` of ``functional_call``, its moved
BatchNorm statistics returned beside the loss.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JT
from paddle_tpu.utils import functional_call
import paddle_tpu_torch as T
from paddle_tpu_torch import optimizer as topt

from chip_smoke import SPATIAL_MODELS, _ddpm_temb, _ddpm_unet, _unet3d
from test_torch_nn_layers import _close, _cpu, _pair

torch.set_num_threads(2)

TRAIN_TOL = 1e-4          # two Adam steps: fp32 sums in other orders
NOISE = 1e-6              # a gradient entry below this is rounding noise


@pytest.fixture(autouse=True)
def on_cpu():
    with _cpu():
        yield


def ddpm_unet(nn, c):
    """``chip_smoke.py``'s DDPM U-Net over ``nn``'s package."""
    return _ddpm_unet(P if nn is P.nn else T, c)


def unet3d(nn, c):
    """``chip_smoke.py``'s 3D U-Net over ``nn``'s package."""
    return _unet3d(P if nn is P.nn else T, c)


def ddpm_batch(r, batch, px, ch, steps=1000):
    """(x_t, temb, noise) of the epsilon-prediction loss: x_0 and the noise
    from ``r``, t uniform over the ``steps`` of a linear beta schedule
    1e-4 -> 0.02, temb its ``ch``-wide sinusoidal embedding."""
    abar = np.cumprod(1 - np.linspace(1e-4, 0.02, steps))
    x0 = r.uniform(-1, 1, (batch, 3, px, px))
    noise = r.standard_normal((batch, 3, px, px))
    t = r.integers(0, steps, batch)
    a = abar[t][:, None, None, None]
    xt = np.sqrt(a) * x0 + np.sqrt(1 - a) * noise
    return (xt.astype(np.float32), _ddpm_temb(torch.tensor(t), ch).numpy(),
            noise.astype(np.float32))


def _train_both(j, t, loss_of, batches, n_in, lr=1e-3):
    """Adam steps in both packages, one a batch (the model takes its first
    ``n_in`` arrays, ``loss_of(F, out, *batch)`` the rest), each starting
    the port from the reference's parameters and buffers (the buffers are
    an argument of the jitted step, or its trace would keep the first
    step's); returns the losses of both and the count of parameter entries left out (a gradient
    under NOISE at some step, nonzero)."""
    jo = jopt.Adam(lr, parameters=j.parameters())
    to = topt.Adam(lr, parameters=t.parameters())
    bufs = dict(j.named_buffers())

    def ref(params, buffers, *xs):
        for n, b in bufs.items():
            b._data = buffers[n]
        out = functional_call(j, params, *[JT(a) for a in xs[:n_in]])
        loss = loss_of(P.nn.functional, out, *[JT(a) for a in xs[n_in:]])
        return loss._data, {n: b._data for n, b in bufs.items()}
    jf = jax.jit(jax.value_and_grad(ref, has_aux=True))
    jl, tl, live, noise = [], [], {}, {}
    for xs in batches:
        t.set_state_dict({n: np.asarray(p._data) for n, p in
                          [*j.named_parameters(), *bufs.items()]})
        (loss, moved), grads = jf(
            {n: p._data for n, p in j.named_parameters()},
            {n: b._data for n, b in bufs.items()}, *xs)
        for n, b in bufs.items():
            b._data = moved[n]
        for n, p in j.named_parameters():
            p.grad = JT(grads[n])
        txs = [torch.tensor(a) for a in xs]
        lt = loss_of(T.nn.functional, t(*txs[:n_in]), *txs[n_in:])
        lt.backward()
        for n, p in t.named_parameters():
            g = np.asarray(grads[n])
            _close(p.grad, g, TRAIN_TOL, f"grad {n}")
            live[n] = live.get(n, True) & (np.abs(g) >= NOISE)
            noise[n] = noise.get(n, False) | ((g != 0) & (np.abs(g) < NOISE))
        for n, b in t.named_buffers():
            _close(b, np.asarray(moved[n]), TRAIN_TOL, f"buffer {n}")
        jo.step()
        jo.clear_grad()
        to.step()
        to.clear_grad()
        jp = dict(j.named_parameters())
        for n, p in t.named_parameters():
            m = live[n]
            _close(p.detach().numpy()[m], np.asarray(jp[n]._data)[m],
                   TRAIN_TOL, f"param {n}")
        jl.append(float(loss))
        tl.append(float(lt))
    return jl, tl, sum(int(v.sum()) for v in noise.values())


def _mse(F, out, noise):
    return F.mse_loss(out, noise)


def _voxel_ce(F, logits, labels):
    """Softmax cross-entropy over the classes of each voxel, the classes
    moved last (the reference's hard-label ``cross_entropy`` picks wrongly
    along any other axis: ``test_torch_nn_spatial.py``)."""
    perm = [0, 2, 3, 4, 1]
    last = logits.transpose(perm) if F is P.nn.functional else \
        logits.permute(*perm)
    return F.cross_entropy(last, labels)


def test_ddpm_unet_trains_two_adam_steps():
    ch = 16
    c = dict(ch=ch, ch_mult=(1, 2), num_res_blocks=1, attn_res=(8,),
             dropout=0.0, groups=4, px=16)
    j, t = _pair(lambda nn: ddpm_unet(nn, c))
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in j.named_parameters()]
    r = np.random.default_rng(0)
    batches = [ddpm_batch(r, 2, 16, ch) for _ in range(2)]
    jl, tl, left_out = _train_both(j, t, _mse, batches, 2)
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_TOL)
    n = sum(p.numel() for p in t.parameters())
    assert left_out < 0.05 * n, (left_out, n)


def test_unet3d_trains_two_adam_steps():
    j, t = _pair(lambda nn: unet3d(nn, dict(in_ch=1, base=4, levels=2,
                                            classes=3)))
    r = np.random.default_rng(1)
    batches = [(r.standard_normal((1, 1, 20, 20, 20)).astype(np.float32),
                r.integers(0, 3, (1, 4, 4, 4))) for _ in range(2)]
    x = torch.tensor(batches[0][0])
    assert tuple(t(x).shape) == (1, 3, 4, 4, 4)
    jl, tl, left_out = _train_both(j, t, _voxel_ce, batches, 1)
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_TOL)
    n = sum(p.numel() for p in t.parameters())
    assert left_out < 0.05 * n, (left_out, n)


def test_published_widths_count_their_parameters():
    """At their published widths the port's networks have the papers'
    sizes: 35.7M parameters for DDPM's CIFAR-10 U-Net (ch 128, (1, 2, 2,
    2), 2 blocks, attention at 16) and 19,069,955 for the 3D U-Net (32 ->
    512 channels, 3 classes).  Built on the meta device: no memory."""
    with torch.device("meta"):
        ddpm = _ddpm_unet(T, SPATIAL_MODELS["ddpm"])
        u3 = _unet3d(T, SPATIAL_MODELS["unet3d"])
    n = sum(p.numel() for p in ddpm.parameters())
    assert round(n / 1e6, 1) == 35.7, n
    assert sum(p.numel() for p in u3.parameters()) == 19069955
