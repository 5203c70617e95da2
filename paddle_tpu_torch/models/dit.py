"""DiT — the Diffusion Transformer family, its DDPM/DDIM schedule and its
training step (port of ``paddle_tpu/models/dit.py``; BASELINE.md config 4).

- :class:`DiT` (and :meth:`DiTTrainStep.eps_fn`, the same function over the
  trainer's parameter tree): patchify by reshape and permute, one patch
  projection, adaLN-Zero blocks (gates, modulation and head start at zero,
  so the model starts by predicting zero noise), GELU with the tanh
  approximation.  Parameter names equal the reference's ``state_dict()``
  names, so :func:`paddle_tpu_torch.utils.load_reference_state` carries a
  reference model across.
- Attention over patch tokens takes the flash-attention kernels where the
  reference takes its Pallas kernel, and a plain einsum-softmax where the
  reference takes XLA: :func:`flash_route` is that rule, by shape alone.
  At DiT-XL/2's head dim 72 no shape reaches the kernels; DiT-L/2 at 512 px
  (64x64 latents, s 1024, d 64) does.
- :class:`GaussianDiffusion`: the schedules in numpy float64, cast to fp32
  as the reference's; ``q_sample`` rounds its coefficients to x0's dtype;
  the DDIM sampler is a Python loop over static timesteps with no host read.
- :class:`DiTTrainStep`: the reference's step on one device, with its own
  Adam arithmetic (not the Llama trainer's AdamW) and per-block remat.

Randomness the reference draws from JAX keys comes from explicit
``torch.Generator`` objects: the class dropout's mask from one seeded from
(0xD17, step), DDIM's x_T and its per-step noise (``eta > 0``) from the
caller's.  The draws differ from the reference's; given the same x_T the
sampler at ``eta=0`` computes the same function.

Run a few steps (default device ``cuda``):

    python -m paddle_tpu_torch.models.dit --preset dit_l_2 --input-size 64 \\
        --batch 8 --steps 4 [--depth N] [--remat] [--sample]

It prints one JSON line a step and a last line with images/s, MFU (the
reference's ``flops_per_image`` over the bf16 dense peak), step ms, peak
memory and, with ``--sample``, the sampler's images/s.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .. import PEAK_FLOPS, resolve_device
from ..kernels.flash_attention import flash_attention, pallas_shape
from .llama import _Init, _ParamLinear, torch_dtype
from .pretrain import _to_torch

_FREQ_DIM = 256
_DROP_SEED = 0xD17
_BLOCK_KEYS = ("qkv", "proj", "fc1", "fc2", "ada_w", "ada_b")


@dataclass
class DiTConfig:
    """DiT-{S,B,L,XL}/p geometry (the DiT paper's family)."""
    input_size: int = 32            # latent spatial size (SD latents: 32x32)
    patch_size: int = 2
    in_channels: int = 4            # SD latent channels
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    learn_sigma: bool = False       # eps-only prediction (MSE on noise)
    dtype: str = "bfloat16"

    @property
    def seq_len(self) -> int:
        return (self.input_size // self.patch_size) ** 2

    @property
    def out_channels(self) -> int:
        return self.in_channels * (2 if self.learn_sigma else 1)

    @staticmethod
    def tiny(**kw) -> "DiTConfig":
        base = dict(input_size=8, patch_size=2, in_channels=3, hidden_size=64,
                    depth=2, num_heads=4, num_classes=10, dtype="float32")
        base.update(kw)
        return DiTConfig(**base)

    @staticmethod
    def dit_s_2(**kw) -> "DiTConfig":
        return DiTConfig(**{**dict(hidden_size=384, depth=12, num_heads=6),
                             **kw})

    @staticmethod
    def dit_b_2(**kw) -> "DiTConfig":
        return DiTConfig(**{**dict(hidden_size=768, depth=12, num_heads=12),
                             **kw})

    @staticmethod
    def dit_l_2(**kw) -> "DiTConfig":
        return DiTConfig(**{**dict(hidden_size=1024, depth=24, num_heads=16),
                             **kw})

    @staticmethod
    def dit_xl_2(**kw) -> "DiTConfig":
        return DiTConfig(**{**dict(hidden_size=1152, depth=28, num_heads=16),
                             **kw})

    def num_params(self) -> int:
        h = self.hidden_size
        i = int(h * self.mlp_ratio)
        p2c = self.patch_size ** 2 * self.in_channels
        # attention + MLP + adaLN
        per_block = (4 * h * h + 2 * h * i) + 6 * h * h + 6 * h
        final = h * (self.patch_size ** 2 * self.out_channels) + 2 * h * h
        # patch, position, label and timestep embeddings
        embed = p2c * h + self.seq_len * h + \
            (self.num_classes + 1) * h + (256 * h + h * h)
        return self.depth * per_block + final + embed

    def flops_per_image(self) -> float:
        """Forward+backward matmul flops for one image through the denoiser
        (6·params·tokens analog, computed from the actual block shapes)."""
        h = self.hidden_size
        i = int(h * self.mlp_ratio)
        s = self.seq_len
        attn_proj = 4 * h * h          # qkv+o per token
        attn_sdpa = 2 * s * h          # qk^T + av per token
        mlp = 2 * h * i
        adaln = 6 * h * h / s          # conditioning MLP is per-image
        per_token = self.depth * (attn_proj + attn_sdpa + mlp + adaln)
        per_token += self.patch_size ** 2 * self.in_channels * h \
            + h * self.patch_size ** 2 * self.out_channels
        return 6.0 * per_token * s     # fwd(2) + bwd(4) flops per MAC


# ---- the denoiser's pieces, over plain tensors ----

def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep features [b, dim] in fp32 (DDPM standard)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _layernorm_no_affine(x, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def flash_route(s: int, d: int) -> bool:
    """Whether the reference's attention over ``s`` patch tokens at head
    dim ``d`` runs its Pallas flash kernel: ``_patch_attention`` asks for
    flash when s >= 512 and 128 divides s, and its flash entry takes the
    Pallas path when its 512-row blocks divide s and d is 64, 96 or a
    multiple of 128 (``_blocks_for``); XLA runs the rest."""
    return s >= 512 and s % 128 == 0 and pallas_shape(s, s, d)


def _patch_attention(q, k, v):
    """[b, s, h, d] attention over patch tokens: the flash kernels where
    :func:`flash_route` says the reference runs Pallas, else the
    reference's plain einsum-softmax (scores in fp32, probabilities in q's
    dtype)."""
    b, s, h, d = q.shape
    if flash_route(s, d):
        return flash_attention(q, k, v, causal=False)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * \
        (1.0 / math.sqrt(d))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def dit_block_forward(x, cond, bp, num_heads: int):
    """The adaLN-Zero transformer block over the block's parameter dict
    {qkv, proj, fc1, fc2, ada_w, ada_b}."""
    b, s, h = x.shape
    mod = F.silu(cond) @ bp["ada_w"] + bp["ada_b"]                # [b, 6h]
    sa_shift, sa_scale, sa_gate, mlp_shift, mlp_scale, mlp_gate = \
        mod.chunk(6, dim=-1)
    y = modulate(_layernorm_no_affine(x), sa_shift, sa_scale)
    qkv = (y @ bp["qkv"]).reshape(b, s, 3, num_heads, h // num_heads)
    att = _patch_attention(qkv[:, :, 0], qkv[:, :, 1],
                           qkv[:, :, 2]).reshape(b, s, h) @ bp["proj"]
    x = x + sa_gate[:, None, :] * att
    y = modulate(_layernorm_no_affine(x), mlp_shift, mlp_scale)
    y = F.gelu(y @ bp["fc1"], approximate="tanh") @ bp["fc2"]
    return x + mlp_gate[:, None, :] * y


def dit_patchify_raw(x, c: DiTConfig):
    """[b, C, H, W] -> [b, s, p*p*C] by reshape and permute."""
    p = c.patch_size
    g = c.input_size // p
    b = x.shape[0]
    x = x.reshape(b, c.in_channels, g, p, g, p).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, g * g, p * p * c.in_channels)


def dit_unpatchify_raw(x, c: DiTConfig):
    p = c.patch_size
    g = c.input_size // p
    b = x.shape[0]
    x = x.reshape(b, g, g, p, p, c.out_channels).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, c.out_channels, g * p, g * p)


def _eps(params, x, t, y, c: DiTConfig, block=dit_block_forward):
    """The denoiser over the trainer's parameter tree (blocks a list of
    per-layer dicts); ``block`` runs one block (remat wraps it)."""
    h = dit_patchify_raw(x.to(params["patch"].dtype), c) @ params["patch"]
    h = h + params["pos"][None]
    temb = timestep_embedding(t, _FREQ_DIM).to(params["t_fc1"].dtype)
    temb = F.silu(temb @ params["t_fc1"]) @ params["t_fc2"]
    cond = temb + params["label"][y]
    for bp in params["blocks"]:
        h = block(h, cond, bp, c.num_heads)
    mod = F.silu(cond) @ params["final_ada_w"] + params["final_ada_b"]
    shift, scale = mod.chunk(2, dim=-1)
    out = modulate(_layernorm_no_affine(h), shift, scale) @ \
        params["final_head"]
    return dit_unpatchify_raw(out, c)


def _param_shapes(c: DiTConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (``blocks``: one block's)."""
    h = c.hidden_size
    i = int(h * c.mlp_ratio)
    return {"patch": (c.patch_size ** 2 * c.in_channels, h),
            "pos": (c.seq_len, h), "t_fc1": (_FREQ_DIM, h), "t_fc2": (h, h),
            "label": (c.num_classes + 1, h),
            "blocks": {"qkv": (h, 3 * h), "proj": (h, h), "fc1": (h, i),
                       "fc2": (i, h), "ada_w": (h, 6 * h), "ada_b": (6 * h,)},
            "final_ada_w": (h, 2 * h), "final_ada_b": (2 * h,),
            "final_head": (h, c.patch_size ** 2 * c.out_channels)}


# ---- the model as modules (the reference's Layer tree and names) ----

class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, init: _Init):
        super().__init__()
        self.fc1 = _ParamLinear(_FREQ_DIM, hidden_size, init)
        self.fc2 = _ParamLinear(hidden_size, hidden_size, init)


class LabelEmbedder(nn.Module):
    """Class embedding with a null row (index ``num_classes``) for
    classifier-free guidance."""

    def __init__(self, num_classes: int, hidden_size: int, init: _Init):
        super().__init__()
        self.table = init.scaled((num_classes + 1, hidden_size), hidden_size)


class DiTBlock(nn.Module):
    def __init__(self, c: DiTConfig, init: _Init):
        super().__init__()
        h = c.hidden_size
        i = int(h * c.mlp_ratio)
        self.ada_w = init.zeros((h, 6 * h))
        self.ada_b = init.zeros((6 * h,))
        self.qkv = _ParamLinear(h, 3 * h, init)
        self.proj = _ParamLinear(h, h, init)
        self.fc1 = _ParamLinear(h, i, init)
        self.fc2 = _ParamLinear(i, h, init)

    def block_params(self) -> Dict[str, torch.Tensor]:
        return {"qkv": self.qkv.weight, "proj": self.proj.weight,
                "fc1": self.fc1.weight, "fc2": self.fc2.weight,
                "ada_w": self.ada_w, "ada_b": self.ada_b}


class FinalLayer(nn.Module):
    def __init__(self, c: DiTConfig, init: _Init):
        super().__init__()
        h = c.hidden_size
        self.ada_w = init.zeros((h, 2 * h))
        self.ada_b = init.zeros((2 * h,))
        self.head = init.zeros((h, c.patch_size ** 2 * c.out_channels))


class DiT(nn.Module):
    """Noise-prediction transformer ``(x_t [b, C, H, W], t [b], y [b]) ->
    eps``, random init from ``seed`` on ``device`` (default ``"cuda"``):
    the reference's N(0, 1/fan_in) weights, ``pos_embed`` N(0, 0.02²), and
    the adaLN and head parameters at zero.  Differentiable."""

    def __init__(self, config: DiTConfig, *, device=None, seed: int = 0):
        super().__init__()
        c = config
        self.config = c
        init = _Init(resolve_device(device), torch_dtype(c.dtype), seed)
        p2c = c.patch_size ** 2 * c.in_channels
        self.patch_proj = _ParamLinear(p2c, c.hidden_size, init)
        self.pos_embed = init.normal((c.seq_len, c.hidden_size), 0.02)
        self.t_embedder = TimestepEmbedder(c.hidden_size, init)
        self.y_embedder = LabelEmbedder(c.num_classes, c.hidden_size, init)
        self.blocks = nn.ModuleList([DiTBlock(c, init)
                                     for _ in range(c.depth)])
        self.final = FinalLayer(c, init)
        for p in self.parameters():
            p.requires_grad_(True)

    def patchify(self, x):
        return dit_patchify_raw(x, self.config)

    def unpatchify(self, x):
        return dit_unpatchify_raw(x, self.config)

    def params(self) -> Dict[str, Any]:
        """The trainer's parameter tree over this model's parameters."""
        return {"patch": self.patch_proj.weight, "pos": self.pos_embed,
                "t_fc1": self.t_embedder.fc1.weight,
                "t_fc2": self.t_embedder.fc2.weight,
                "label": self.y_embedder.table,
                "blocks": [blk.block_params() for blk in self.blocks],
                "final_ada_w": self.final.ada_w,
                "final_ada_b": self.final.ada_b,
                "final_head": self.final.head}

    def forward(self, x, t, y):
        return _eps(self.params(), x, t, y, self.config)


# ---- diffusion schedule (DDPM / DDIM) ----

class GaussianDiffusion:
    """Linear or cosine beta schedule (numpy float64, kept as fp32 tables);
    the eps-prediction training loss and a DDIM sampler."""

    def __init__(self, num_timesteps: int = 1000, schedule: str = "cosine"):
        self.num_timesteps = int(num_timesteps)
        T = self.num_timesteps
        if schedule == "linear":
            betas = np.linspace(1e-4, 0.02, T, dtype=np.float64)
        elif schedule == "cosine":
            s = 0.008
            ts = np.arange(T + 1, dtype=np.float64) / T
            f = np.cos((ts + s) / (1 + s) * math.pi / 2) ** 2
            betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
        alphas_bar = np.cumprod(1.0 - betas)
        self.sqrt_ab = np.sqrt(alphas_bar).astype(np.float32)
        self.sqrt_1mab = np.sqrt(1 - alphas_bar).astype(np.float32)
        self._tables: Dict[torch.device, Any] = {}

    def _on(self, device):
        """The two tables on ``device`` (copied there once)."""
        if device not in self._tables:
            self._tables[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.sqrt_ab, self.sqrt_1mab))
        return self._tables[device]

    def q_sample(self, x0, t, noise):
        """x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps (t: int [b]), the
        coefficients rounded to x0's dtype."""
        sab, s1mab = self._on(x0.device)
        a = sab[t][:, None, None, None].to(x0.dtype)
        b = s1mab[t][:, None, None, None].to(x0.dtype)
        return a * x0 + b * noise

    def training_loss(self, model_fn, x0, t, y, generator=None,
                      null_label: Optional[int] = None,
                      class_dropout_prob: float = 0.0):
        """MSE(eps_hat, eps) in fp32, the DDPM simple loss; the noise, then
        (with ``null_label`` and ``class_dropout_prob``) the labels dropped
        to the null class, are drawn from ``generator``."""
        noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                            dtype=torch.float32).to(x0.dtype)
        if null_label is not None and class_dropout_prob > 0:
            drop = torch.rand(y.shape, generator=generator,
                              device=y.device) < class_dropout_prob
            y = torch.where(drop, null_label, y)
        eps_hat = model_fn(self.q_sample(x0, t, noise), t, y)
        eps_hat = eps_hat[:, : x0.shape[1]]      # learn_sigma: the eps half
        d = eps_hat.float() - noise.float()
        return torch.mean(d * d)

    def ddim_sample(self, model_fn, shape, y, generator=None, steps: int = 50,
                    eta: float = 0.0, guidance_scale: float = 1.0,
                    null_label: Optional[int] = None, x_T=None):
        """DDIM from ``x_T`` (``None``: drawn N(0, 1) in fp32 from
        ``generator``) over ``steps`` static timesteps, with classifier-free
        guidance (two model calls a step) when ``guidance_scale != 1`` and
        ``null_label`` is set; at ``eta > 0`` each step but the last adds
        noise from ``generator``.  The schedule's scalars are fp32, as the
        reference's; nothing is read back to the host."""
        T = self.num_timesteps
        ts = np.linspace(T - 1, 0, steps).round().astype(np.int64)
        dev = y.device
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32) if x_T is None else \
            x_T.to(device=dev, dtype=torch.float32)
        b = shape[0]
        guided = guidance_scale != 1.0 and null_label is not None
        if guided:
            nulls = torch.full((b,), null_label, dtype=y.dtype, device=dev)
        one = np.float32(1.0)
        for i in range(steps):
            t = int(ts[i])
            t_next = int(ts[i + 1]) if i + 1 < steps else -1
            tb = torch.full((b,), t, dtype=torch.int32, device=dev)
            if guided:
                e_c = model_fn(x, tb, y)
                e_u = model_fn(x, tb, nulls)
                eps = e_u + guidance_scale * (e_c - e_u)
            else:
                eps = model_fn(x, tb, y)
            eps = eps.float()[:, : shape[1]]
            ab_t = self.sqrt_ab[t] ** 2
            ab_n = self.sqrt_ab[t_next] ** 2 if t_next >= 0 else one
            x0 = (x - float(np.sqrt(one - ab_t)) * eps) / float(np.sqrt(ab_t))
            sigma = np.float32(eta) * np.sqrt((one - ab_n) / (one - ab_t)) * \
                np.sqrt(one - ab_t / ab_n)
            dir_xt = float(np.sqrt(max(one - ab_n - sigma ** 2,
                                       np.float32(0)))) * eps
            x = float(np.sqrt(ab_n)) * x0 + dir_xt
            if eta > 0 and t_next >= 0:
                x = x + float(sigma) * torch.randn(
                    shape, generator=generator, device=dev,
                    dtype=torch.float32)
        return x


# ---- the training step (bench config 4: images/s + MFU) ----

class DiTTrainStep:
    """The reference's diffusion training step on one device
    (``device=``, default ``"cuda"``): eps-prediction MSE through
    :meth:`GaussianDiffusion.q_sample`, the reference's Adam update, and
    per-block ``torch.utils.checkpoint`` with ``remat``.

    A state is ``{"params", "m", "v", "step"}``: ``params`` the tree of
    :meth:`DiT.params` (``blocks`` a list of per-layer dicts) as leaf
    tensors, ``m`` / ``v`` fp32 trees of the same shapes, ``step`` an int32
    0-d tensor kept on the host, since it seeds the class dropout's
    generator.  ``dp`` and ``mp`` stay 1 (ROADMAP Queue 1 item 18)."""

    def __init__(self, config: DiTConfig, dp: int = 1, mp: int = 1,
                 remat: bool = False, lr: float = 1e-4,
                 weight_decay: float = 0.0, betas=(0.9, 0.999),
                 diffusion: Optional[GaussianDiffusion] = None, *,
                 device=None):
        if dp * mp > 1:
            raise NotImplementedError(
                f"the port trains DiT on one device: dp={dp}, mp={mp} needs "
                "the distributed slice (ROADMAP Queue 1 item 18)")
        self.config = config
        self.dp, self.mp = dp, mp
        self.remat = remat
        self.lr, self.wd, self.betas = lr, weight_decay, betas
        self.diffusion = diffusion or GaussianDiffusion()
        self.device = resolve_device(device)
        self.dtype = torch_dtype(config.dtype)
        self._block = (lambda *a: checkpoint(dit_block_forward, *a,
                                             use_reentrant=False)) \
            if remat else dit_block_forward

    # ---- state ----
    @staticmethod
    def _leaves(tree) -> List[torch.Tensor]:
        out = []
        for k, v in tree.items():
            if k == "blocks":
                out.extend(t for bp in v for t in bp.values())
            else:
                out.append(v)
        return out

    @staticmethod
    def _map(fn, tree):
        return {k: ([{n: fn(t) for n, t in bp.items()} for bp in v]
                    if k == "blocks" else fn(v)) for k, v in tree.items()}

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """A :class:`DiT` initialised from ``seed`` on the device, its
        parameters as the tree; zero fp32 moments, step 0."""
        model = DiT(self.config, device=self.device, seed=seed)
        params = self._map(lambda p: p.detach().requires_grad_(),
                           model.params())
        return {"params": params, **self._zero_moments(params),
                "step": torch.zeros((), dtype=torch.int32)}

    def _zero_moments(self, params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"m": self._map(zeros, params), "v": self._map(zeros, params)}

    # ---- forward / loss ----
    def eps_fn(self, params, x, t, y):
        return _eps(params, x, t, y, self.config, self._block)

    def class_drop(self, y, step: int):
        """The labels with ``class_dropout_prob`` of them dropped to the
        null class, the mask drawn on y's device from a generator seeded
        from (0xD17, step)."""
        c = self.config
        g = torch.Generator(device=y.device).manual_seed(
            (_DROP_SEED << 32) + step)
        drop = torch.rand(y.shape, generator=g, device=y.device) < \
            c.class_dropout_prob
        return torch.where(drop, c.num_classes, y)

    def _loss(self, params, x0, t, y, noise, step: int):
        if self.config.class_dropout_prob > 0:
            y = self.class_drop(y, step)
        x_t = self.diffusion.q_sample(x0, t, noise)
        eps_hat = self.eps_fn(params, x_t, t, y)[:, : x0.shape[1]]
        d = eps_hat.float() - noise.float()
        return torch.mean(d * d)

    @torch.no_grad()
    def _update(self, state, grads):
        """The reference's ``_update``: fp32 m and v, ``u = (m / bc1) /
        (sqrt(v / bc2) + 1e-8)``, ``u += wd·p`` when ``wd``, ``p -= lr·u``;
        the bias corrections in fp32 from the host step.  In place."""
        b1, b2 = self.betas
        step = state["step"].add_(1)
        n = np.float32(int(step))
        bc1 = float(1 - np.float32(b1) ** n)
        bc2 = float(1 - np.float32(b2) ** n)
        for p, g, m, v in zip(self._leaves(state["params"]), grads,
                              self._leaves(state["m"]),
                              self._leaves(state["v"])):
            gf = g.float()
            m.copy_(b1 * m + (1 - b1) * gf)
            v.copy_(b2 * v + (1 - b2) * gf * gf)
            u = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
            if self.wd:
                u = u + self.wd * p.float()
            p.copy_(p.float() - self.lr * u)
        return state

    def loss_and_grads(self, params, x0, t, y, noise, step: int = 0):
        """``(loss, grads)`` with grads in the order of the tree's leaves."""
        with torch.enable_grad():
            loss = self._loss(params, x0, t, y, noise, step)
            grads = torch.autograd.grad(loss, self._leaves(params))
        return loss.detach(), list(grads)

    def train_step(self, state, x0, t, y, noise):
        """One step on ``(x0, t, y, noise)``; returns ``(state, loss)``,
        the state updated in place and the loss a device scalar (nothing is
        read back to the host)."""
        x0, t, y, noise = self.shard_batch(x0, t, y, noise)
        loss, grads = self.loss_and_grads(state["params"], x0, t, y, noise,
                                          int(state["step"]))
        with record_function("adam"):
            self._update(state, grads)
        return state, loss

    def shard_batch(self, x0, t, y, noise):
        """The batch on the device: x0 and noise in their float dtypes, t
        and y as int64."""
        return (_to_torch(x0).to(self.device), _to_torch(t).to(self.device,
                                                                torch.long),
                _to_torch(y).to(self.device, torch.long),
                _to_torch(noise).to(self.device))

    def flops_per_image(self) -> float:
        return self.config.flops_per_image()

    # ---- state carried across packages ----
    def canonical_state(self, state) -> Dict[str, Any]:
        """The reference's state tree as CPU tensors: block leaves stacked
        ``[L, ...]`` in layer order."""
        def canon(tree):
            out = {k: v.detach().cpu() for k, v in tree.items()
                   if k != "blocks"}
            out["blocks"] = {n: torch.stack([bp[n].detach().cpu()
                                             for bp in tree["blocks"]])
                             for n in _BLOCK_KEYS}
            return out
        return {"params": canon(state["params"]), "m": canon(state["m"]),
                "v": canon(state["v"]), "step": state["step"].detach().cpu()}

    def restore_canonical(self, canonical) -> Dict[str, Any]:
        """This device's state from a canonical one (the reference's or
        the port's: numpy arrays, jax arrays or tensors, blocks ``[L,
        ...]``).  Copies: the result shares no memory with ``canonical``."""
        shapes = _param_shapes(self.config)
        L = self.config.depth

        def tree(src, dtype, grad):
            def place(x, shape):
                t = _to_torch(x)
                if tuple(t.shape) != shape:
                    raise ValueError(f"shape {tuple(t.shape)} != {shape}")
                t = t.to(device=self.device, dtype=dtype, copy=True)
                return t.requires_grad_() if grad else t
            out = {k: place(src[k], s) for k, s in shapes.items()
                   if k != "blocks"}
            blocks = {n: _to_torch(src["blocks"][n]) for n in _BLOCK_KEYS}
            for n, b in blocks.items():
                if b.shape[0] != L:
                    raise ValueError(f"{n}: {b.shape[0]} blocks, config has "
                                     f"{L}")
            out["blocks"] = [{n: place(blocks[n][i], shapes["blocks"][n])
                              for n in _BLOCK_KEYS} for i in range(L)]
            return out

        return {"params": tree(canonical["params"], self.dtype, True),
                "m": tree(canonical["m"], torch.float32, False),
                "v": tree(canonical["v"], torch.float32, False),
                "step": _to_torch(canonical["step"]).to(torch.int32).clone()}


# ------------------------------------------------------------ entry point ---

PRESETS = ("tiny", "dit_s_2", "dit_b_2", "dit_l_2", "dit_xl_2")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.models.dit",
        description="DiT training steps (and optionally DDIM sampling) on "
                    "one device, random weights and a random batch of "
                    "latents from --seed (the same batch every step).")
    p.add_argument("--preset", default="dit_xl_2", choices=PRESETS)
    p.add_argument("--input-size", type=int, default=None,
                   help="latent size (default the preset's: 32)")
    p.add_argument("--depth", type=int, default=None,
                   help="cut the preset's depth (widths unchanged)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=4,
                   help="steps, the first of them the warm-up")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--sample", action="store_true",
                   help="then run the DDIM sampler once at --batch")
    p.add_argument("--sample-steps", type=int, default=25)
    p.add_argument("--guidance", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def build_trainer(args):
    """``(DiTTrainStep, state, batch)`` for parsed ``args``: the preset
    (``--input-size``, depth cut by ``--depth``), one random batch
    ``(x0, t, y, noise)`` on the device."""
    kw = {}
    if args.input_size is not None:
        kw["input_size"] = args.input_size
    if args.depth is not None:
        kw["depth"] = args.depth
    cfg = getattr(DiTConfig, args.preset)(**kw)
    ts = DiTTrainStep(cfg, remat=args.remat, device=args.device)
    state = ts.init_state(seed=args.seed)
    rng = np.random.default_rng(args.seed)
    shape = (args.batch, cfg.in_channels, cfg.input_size, cfg.input_size)
    batch = ts.shard_batch(
        rng.standard_normal(shape, dtype=np.float32),
        rng.integers(0, ts.diffusion.num_timesteps, args.batch),
        rng.integers(0, cfg.num_classes, args.batch),
        rng.standard_normal(shape, dtype=np.float32))
    return ts, state, batch


def run_steps(ts, state, batch, steps: int, log=None):
    """``steps`` train steps on one batch, each waited for (its loss read
    back).  Returns ``(state, losses, seconds)``; ``log(i, loss, seconds)``
    is called after each step."""
    losses, seconds = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = ts.train_step(state, *batch)
        losses.append(float(loss))            # waits for the step
        seconds.append(time.perf_counter() - t0)
        if log is not None:
            log(i, losses[-1], seconds[-1])
    return state, losses, seconds


def throughput(ts, batch, seconds) -> Dict[str, Any]:
    """Mean step ms and images/s over ``seconds``; on the card also the
    MFU (``flops_per_image`` x images/s over the bf16 dense peak) and the
    peak memory allocated."""
    step_s = sum(seconds) / len(seconds)
    img_s = batch[0].shape[0] / step_s
    cuda = ts.device.type == "cuda"
    return {"step_ms": step_s * 1e3, "images_per_s": img_s,
            "mfu": img_s * ts.flops_per_image() / PEAK_FLOPS["bfloat16"]
            if cuda else None,
            "max_memory_allocated": torch.cuda.max_memory_allocated(ts.device)
            if cuda else None}


def sample(ts, state, batch_size: int, steps: int, guidance: float,
           seed: int = 0):
    """DDIM over the state's model: ``batch_size`` images of classes
    ``0, 1, ...``, ``steps`` steps, guidance toward the null class.
    Returns ``(images, seconds)``, the images waited for."""
    c = ts.config
    params = state["params"]
    y = torch.arange(batch_size, device=ts.device) % c.num_classes
    g = torch.Generator(device=ts.device).manual_seed(seed)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = ts.diffusion.ddim_sample(
            lambda x, t, yy: ts.eps_fn(params, x, t, yy),
            (batch_size, c.in_channels, c.input_size, c.input_size), y, g,
            steps=steps, guidance_scale=guidance, null_label=c.num_classes)
        if ts.device.type == "cuda":
            torch.cuda.synchronize(ts.device)
    return out, time.perf_counter() - t0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ts, state, batch = build_trainer(args)
    cuda = ts.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(ts.device)

    def log(i, loss, s):
        print(json.dumps({"step": i, "loss": loss, "ms": s * 1e3}),
              flush=True)

    state, _, seconds = run_steps(ts, state, batch, args.steps, log)
    c = ts.config
    last = {"device": torch.cuda.get_device_name(ts.device) if cuda else "cpu",
            "preset": args.preset, "input_size": c.input_size,
            "depth": c.depth, "seq_len": c.seq_len,
            "head_dim": c.hidden_size // c.num_heads,
            "flash": flash_route(c.seq_len, c.hidden_size // c.num_heads),
            "params": c.num_params(), "batch": args.batch,
            "remat": args.remat,
            **throughput(ts, batch, seconds[1:] or seconds)}   # 1st warms up
    if args.sample:
        _, s = sample(ts, state, args.batch, args.sample_steps, args.guidance,
                      args.seed)
        last.update(sample_steps=args.sample_steps, guidance=args.guidance,
                    sample_s=s, sample_images_per_s=args.batch / s)
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
