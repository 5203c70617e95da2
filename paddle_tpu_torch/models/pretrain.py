"""Llama pretraining on one card, dense or MoE (port of
``paddle_tpu/models/pretrain.py``).

:class:`PretrainStep` keeps the reference's interface: ``init_state`` /
``train_step(state, ids, labels) -> (state, loss)`` with AdamW, the
per-layer remat policies, the chunked cross-entropy, the MoE load-balancing
aux loss and ``router_stats``, and the topology-free ``canonical_state`` /
``restore_canonical`` pair that carries a state between the two packages.
Attention runs the flash-attention kernels (forward, and dQ and dK/dV in
the backward) and the MoE expert FFN the grouped-matmul kernels (gmm
forward; gmm ``trans_rhs`` and ``tgmm`` in the backward) on the card, and
their plain versions on the CPU.

What differs from the reference, and why:

- One device.  :class:`ParallelConfig` keeps every field, but only
  ``remat``, ``remat_policy``, ``loss_chunks``, ``m_dtype`` and ``v_dtype``
  may leave their defaults; the mesh, pipeline, ZeRO and ``grad_comm``
  settings raise (ROADMAP Queue 1 item 18).  MoE trains with
  ``moe_dispatch="grouped"`` only; ``gather``/``einsum`` raise.
- No ``jit``: autograd computes the gradients, ``torch.utils.checkpoint``
  takes the place of ``jax.checkpoint``, and the layer loop is a Python
  loop over per-layer leaf tensors (stacked ``[L, ...]`` only at the state
  boundary).
- The state is updated in place (the reference donates it): a 7B state
  leaves no room on an 80 GB card for a second copy.  The stacked expert
  banks ``[E, ...]`` are updated one expert at a time, which bounds
  AdamW's fp32 transients (elementwise, so bitwise the same).

Run it (default device ``cuda``; ``--device cpu`` for the plain path):

    python -m paddle_tpu_torch.models.pretrain --preset llama2_7b \\
        --batch 4 --seq 2048 --steps 5 [--num-layers N] \\
        [--remat-policy full|dots|none] [--loss-chunks 16] [--m-dtype bfloat16]
    python -m paddle_tpu_torch.models.pretrain --preset mixtral_8x7b \\
        --num-layers 4 --batch 4 --seq 2048

It prints one JSON line per step (loss, ms) and a last line with tokens/s,
MFU (on the active parameters for MoE), the peak memory allocated and, for
MoE presets, the router's ``kept_frac`` and ``imbalance``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import PEAK_FLOPS, resolve_device
from ..kernels.rms_norm import rms_norm_fp32
from .llama import (LlamaConfig, LlamaDecoderLayer, _Init, _rope_cos_sin,
                    torch_dtype)

# ParallelConfig fields that only a multi-device run would change
_ONE_DEVICE = dict(dp=1, pp=1, mp=1, ep=1, sep=1, micro_batches=1,
                   schedule="gpipe", virtual_pp=1, sequence_parallel=False,
                   zero1=False, zero3=False, grad_comm="auto",
                   grad_comm_error_feedback=False)


# the reference's dots_with_no_batch_dims_saveable: keep the outputs of the
# plain 2-D matmuls (projections, MLP, head), recompute everything else
_SAVEABLE = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVEABLE else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(f, policy: str):
    """``torch.utils.checkpoint`` under a named policy (the reference's
    ``_remat``): 'full' recomputes the whole block in the backward; 'dots'
    keeps the matmul outputs and recomputes the rest."""
    if policy == "dots":
        return lambda *a: checkpoint(f, *a, use_reentrant=False,
                                     context_fn=_dots_context)
    if policy != "full":
        raise ValueError(f"unknown remat_policy {policy!r}")
    return lambda *a: checkpoint(f, *a, use_reentrant=False)


@dataclass
class ParallelConfig:
    dp: int = 1
    pp: int = 1
    mp: int = 1
    ep: int = 1
    sep: int = 1
    micro_batches: int = 1
    schedule: str = "gpipe"
    virtual_pp: int = 1
    sequence_parallel: bool = False
    zero1: bool = False
    zero3: bool = False
    remat: bool = False          # checkpoint each decoder layer
    remat_policy: str = "full"   # full: recompute everything in backward;
    #                              dots: keep the matmul outputs
    loss_chunks: int = 1         # chunked CE: never hold [B, T, V] fp32
    m_dtype: str = "float32"     # AdamW first-moment storage dtype
    v_dtype: str = "float32"     # second moment: keep fp32
    grad_comm: str = "auto"
    grad_comm_error_feedback: bool = False

    def __post_init__(self):
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} "
                "(expected 'full' or 'dots')")
        if self.remat_policy != "full" and not self.remat:
            raise ValueError(
                "remat_policy is set but remat=False — no checkpointing "
                "would be applied; set remat=True")
        if self.grad_comm not in ("auto", "ring", "ring_int8"):
            raise ValueError(
                f"unknown grad_comm {self.grad_comm!r} "
                "(expected 'auto', 'ring' or 'ring_int8')")
        if self.grad_comm_error_feedback and self.grad_comm != "ring_int8":
            raise ValueError(
                "grad_comm_error_feedback requires grad_comm='ring_int8' "
                "(the fp32 paths introduce no quantization error to feed "
                "back)")
        off = [f"{k}={getattr(self, k)!r}" for k, v in _ONE_DEVICE.items()
               if getattr(self, k) != v]
        if off:
            raise NotImplementedError(
                f"the port trains on one device: {', '.join(off)} needs the "
                "distributed slice (ROADMAP Queue 1 item 18)")
        for name in ("m_dtype", "v_dtype"):
            torch_dtype(getattr(self, name))          # KeyError if unknown


def _to_torch(x) -> torch.Tensor:
    """A host array (numpy, including ml_dtypes' bfloat16, or anything
    ``np.asarray`` reads) or a tensor, as a tensor sharing its memory."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    if not a.flags.c_contiguous:          # (ascontiguousarray makes 0-d 1-d)
        a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class PretrainStep:
    """Builds ``init_state()`` and ``train_step(state, ids, labels)`` for a
    dense Llama on one device (``device=``, default ``"cuda"``).

    A state is ``{"params", "m", "v", "step"}``; each of the first three is
    ``{"embed": [V, H], "head": [H, V], "norm": [H], "blocks": [{name:
    tensor} per layer]}`` with the reference's parameter names, and
    ``step`` is an int32 device scalar.
    """

    def __init__(self, config: LlamaConfig,
                 parallel: Optional[ParallelConfig] = None,
                 learning_rate: float = 3e-4, weight_decay: float = 0.1,
                 beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
                 *, device=None):
        if config.moe_num_experts and config.moe_dispatch != "grouped":
            raise NotImplementedError(
                f"MoE training with moe_dispatch={config.moe_dispatch!r} is "
                "not ported (ROADMAP Queue 1 item 7); use "
                "moe_dispatch='grouped'")
        self.config = config
        self._moe = bool(config.moe_num_experts)
        self.pc = parallel or ParallelConfig()
        self.device = resolve_device(device)
        self.lr, self.wd = learning_rate, weight_decay
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.dtype = torch_dtype(config.dtype)
        # one shape-only template layer provides the block math for every
        # layer (the reference's functional_call over self._template)
        self._template = LlamaDecoderLayer(
            config, _Init(torch.device("meta"), self.dtype, 0))
        self._shapes = {n: tuple(p.shape)
                        for n, p in self._template.named_parameters()}
        block = self._layer_aux if self._moe else self._layer
        self._block = _remat(block, self.pc.remat_policy) \
            if self.pc.remat else block
        self._rope: Dict[int, Any] = {}

    # ---- state ----
    def _tree(self, make) -> Dict[str, Any]:
        c = self.config
        return {"embed": make("embed", (c.vocab_size, c.hidden_size)),
                "head": make("head", (c.hidden_size, c.vocab_size)),
                "norm": make("norm", (c.hidden_size,)),
                "blocks": [{n: make(n, s) for n, s in self._shapes.items()}
                           for _ in range(c.num_hidden_layers)]}

    @staticmethod
    def _leaves(tree) -> List[torch.Tensor]:
        out = [tree["embed"], tree["head"], tree["norm"]]
        for lp in tree["blocks"]:
            out.extend(lp.values())
        return out

    def _unflatten(self, leaves) -> Dict[str, Any]:
        it = iter(leaves)
        return self._tree(lambda name, shape: next(it))

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters (N(0, 1/fan_in) in fp32 cast to the model
        dtype, norms 1) from ``seed`` on the device; zero moments."""
        c = self.config
        init = _Init(self.device, self.dtype, seed)
        blocks = [{n: p.detach().requires_grad_()
                   for n, p in LlamaDecoderLayer(c, init).named_parameters()}
                  for _ in range(c.num_hidden_layers)]
        params = {
            "embed": init.scaled((c.vocab_size, c.hidden_size),
                                 c.hidden_size).detach().requires_grad_(),
            "head": init.scaled((c.hidden_size, c.vocab_size),
                                c.hidden_size).detach().requires_grad_(),
            "norm": init.ones((c.hidden_size,)).detach().requires_grad_(),
            "blocks": blocks}
        return {"params": params,
                "m": self._zeros_like(params, self.pc.m_dtype),
                "v": self._zeros_like(params, self.pc.v_dtype),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def _zeros_like(self, params, dtype):
        dt = torch_dtype(dtype)
        return self._unflatten([torch.zeros_like(p, dtype=dt)
                                for p in self._leaves(params)])

    # ---- forward / loss ----
    def _layer(self, lp, x, cos, sin):
        return torch.func.functional_call(self._template, lp, (x, cos, sin))

    def _layer_aux(self, lp, x, cos, sin):
        """An MoE layer: ``(y, aux, stats)``, the aux loss and router stats
        read off the template's MoE block right after the call (the
        reference's ``block_aux``).  They leave as outputs of the function,
        so under remat nothing reads what the backward's recompute
        overwrites."""
        y = self._layer(lp, x, cos, sin)
        mlp = self._template.mlp
        return y, mlp._last_aux, mlp._last_stats

    def _rope_tables(self, T):
        if T not in self._rope:
            c = self.config
            self._rope[T] = _rope_cos_sin(T, c.head_dim, c.rope_theta,
                                          device=self.device)
        return self._rope[T]

    def _hidden(self, params, ids):
        """``(h, aux, stats)``: final-norm hidden states [B, T, H], the
        weighted MoE aux loss (``moe_aux_loss_weight`` · the layers' sum)
        and the layer mean of the router stats ``[kept_frac, imbalance]``
        (aux and stats None for a dense model).  The reference's
        ``_hidden`` at pp=1: the layer loop, then ``rms_norm_fp32``."""
        c = self.config
        cos, sin = self._rope_tables(ids.shape[1])
        h = F.embedding(ids, params["embed"])
        aux = stats = None
        for lp in params["blocks"]:
            if not self._moe:
                h = self._block(lp, h, cos, sin)
                continue
            h, a, st = self._block(lp, h, cos, sin)
            aux = a if aux is None else aux + a
            stats = st if stats is None else stats + st
        h = rms_norm_fp32(h, params["norm"], c.rms_norm_eps)
        if self._moe:
            aux = c.moe_aux_loss_weight * aux
            stats = stats / c.num_hidden_layers
        return h, aux, stats

    @staticmethod
    def _ce_sum(h, gold_ids, head):
        logits = (h @ head).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, gold_ids[..., None])[..., 0]
        return (lse - gold).sum()

    def _forward_loss(self, params, ids, labels):
        C = self.pc.loss_chunks
        h, aux, _ = self._hidden(params, ids)
        with record_function("ce_forward"):
            loss = self._ce_loss(h, labels, params["head"], C)
        return loss if aux is None else loss + aux

    def _ce_loss(self, h, labels, head, C):
        """Mean cross-entropy of ``h @ head`` against ``labels``."""
        if C <= 1:
            return self._ce_sum(h, labels, head) / labels.numel()
        # chunked CE: head matmul + logsumexp per token chunk under remat,
        # so the peak holds one [N/C, V] fp32 block
        H = h.shape[-1]
        hf = h.reshape(-1, H)
        lf = labels.reshape(-1)
        N = hf.shape[0]
        if N % C:
            raise ValueError(f"loss_chunks ({C}) must divide B*T ({N})")
        parts = [checkpoint(self._ce_sum, hc, lc, head, use_reentrant=False)
                 for hc, lc in zip(hf.chunk(C), lf.chunk(C))]
        return torch.stack(parts).sum() / N

    def forward_logits(self, params, ids):
        """fp32 logits [B, T, V] (no gradients)."""
        with torch.no_grad():
            return (self._hidden(params, ids)[0] @ params["head"]).float()

    def eval_loss(self, state, ids, labels):
        with torch.no_grad():
            return self._forward_loss(state["params"], *self._batch(ids,
                                                                    labels))

    def _loss_and_grad_leaves(self, params, ids, labels):
        leaves = self._leaves(params)
        with torch.enable_grad():
            loss = self._forward_loss(params, ids, labels)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def loss_and_grads(self, params, ids, labels):
        """``(loss, grads)``, grads shaped like ``params`` (the reference's
        ``jax.value_and_grad(_forward_loss)``)."""
        loss, grads = self._loss_and_grad_leaves(params,
                                                 *self._batch(ids, labels))
        return loss, self._unflatten(grads)

    # ---- adamw ----
    @torch.no_grad()
    def _update(self, state, grads):
        """AdamW as the reference writes it: fp32 arithmetic, ``m``/``v``
        stored in their dtypes, bias corrections from the device-side step
        counter, decoupled weight decay ``p - lr * (u + wd * p)``.  In
        place, one tensor at a time; nothing is read back to the host."""
        b1, b2, eps, lr, wd = self.b1, self.b2, self.eps, self.lr, self.wd
        step = state["step"].add_(1)
        t = step.float()
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)
        for p, g, m, v in zip(self._leaves(state["params"]), grads,
                              self._leaves(state["m"]),
                              self._leaves(state["v"])):
            # an expert bank [E, ...] one expert at a time: its fp32
            # transients (~5 copies) would otherwise hold 9.4 GB at
            # Mixtral widths
            for sl in (range(p.shape[0]) if p.dim() == 3 else (...,)):
                g32 = g[sl].float()
                m32 = m[sl].float().mul_(b1).add_(g32, alpha=1 - b1)
                v32 = v[sl].float().mul_(b2).addcmul_(g32, g32, value=1 - b2)
                u = (m32 / c1).div_(torch.sqrt(v32 / c2).add_(eps))
                pf = p[sl].float()
                p[sl].copy_(pf - u.add_(pf, alpha=wd).mul_(lr))
                m[sl].copy_(m32)
                v[sl].copy_(v32)
        return state

    # ---- the step ----
    def _batch(self, ids, labels):
        if not (isinstance(ids, torch.Tensor) and ids.device == self.device
                and isinstance(labels, torch.Tensor)
                and labels.device == self.device):
            ids, labels = self.shard_batch(ids, labels)
        return ids, labels

    def train_step(self, state, ids, labels):
        """One AdamW step on ``(ids, labels)`` [B, T]; returns ``(state,
        loss)`` with ``state`` updated in place and ``loss`` a device
        scalar (nothing is read back inside the step)."""
        ids, labels = self._batch(ids, labels)
        loss, grads = self._loss_and_grad_leaves(state["params"], ids, labels)
        with record_function("adamw"):
            self._update(state, grads)
        return state, loss

    def router_stats(self, state, ids):
        """Layer-mean MoE routing health on one batch (no gradients):
        ``kept_frac`` (routed entries that were computed; 1.0 for the
        grouped dispatch, which drops nothing) and ``imbalance`` (the
        busiest expert's first-choice share x E; 1.0 = balanced)."""
        ids, _ = self._batch(ids, ids)
        with torch.no_grad():
            st = self._hidden(state["params"], ids)[2]
        kept, imbalance = [1.0, 1.0] if st is None else st.tolist()
        return {"kept_frac": float(kept), "imbalance": float(imbalance)}

    # ---- accounting (BASELINE.md MFU formula) ----
    def flops_per_token(self, include_remat: bool = False) -> float:
        """6*N per token (N = the active parameters: for MoE only the
        top_k experts a token routes through count); with
        ``include_remat``, adds the 2*N recompute forward."""
        n = self.config.num_active_params()
        f = 6.0 * n
        if include_remat and self.pc.remat:
            f += 2.0 * n
        return f

    def shard_batch(self, ids, labels):
        """The batch as int64 tensors on the device."""
        return tuple(torch.as_tensor(np.asarray(x), dtype=torch.long).to(
            self.device) for x in (ids, labels))

    # ---- state carried across packages and topologies ----
    def canonical_state(self, state) -> Dict[str, Any]:
        """The reference's topology-free view of a state, as CPU tensors
        (numpy reads the float32 ones): block leaves stacked ``[L, ...]`` in
        layer order."""
        def canon(tree):
            return {"embed": tree["embed"].detach().cpu(),
                    "head": tree["head"].detach().cpu(),
                    "norm": tree["norm"].detach().cpu(),
                    "blocks": {n: torch.stack([lp[n].detach().cpu()
                                               for lp in tree["blocks"]])
                               for n in self._shapes}}
        return {"params": canon(state["params"]), "m": canon(state["m"]),
                "v": canon(state["v"]), "step": state["step"].detach().cpu()}

    def restore_canonical(self, canonical) -> Dict[str, Any]:
        """This device's state from a canonical one (the reference's or the
        port's: numpy arrays, jax arrays or tensors, blocks ``[L, ...]``),
        in the dtypes of this trainer.  Copies: the result shares no memory
        with ``canonical``."""
        c = self.config
        L = c.num_hidden_layers

        def place(x, shape, dtype, grad):
            t = _to_torch(x)
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"shape {tuple(t.shape)} != {tuple(shape)}")
            t = t.to(device=self.device, dtype=dtype, copy=True)
            return t.requires_grad_() if grad else t

        def tree(src, dtype, grad):
            blocks = {n: _to_torch(src["blocks"][n]) for n in self._shapes}
            for n, b in blocks.items():
                if b.shape[0] != L:
                    raise ValueError(f"{n}: {b.shape[0]} layers, config has "
                                     f"{L}")
            return {
                "embed": place(src["embed"], (c.vocab_size, c.hidden_size),
                               dtype, grad),
                "head": place(src["head"], (c.hidden_size, c.vocab_size),
                              dtype, grad),
                "norm": place(src["norm"], (c.hidden_size,), dtype, grad),
                "blocks": [{n: place(blocks[n][i], s, dtype, grad)
                            for n, s in self._shapes.items()}
                           for i in range(L)]}

        return {"params": tree(canonical["params"], self.dtype, True),
                "m": tree(canonical["m"], torch_dtype(self.pc.m_dtype), False),
                "v": tree(canonical["v"], torch_dtype(self.pc.v_dtype), False),
                "step": _to_torch(canonical["step"]).to(
                    device=self.device, dtype=torch.int32, copy=True)}


# ------------------------------------------------------------ entry point ---

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.models.pretrain",
        description="Llama (dense or MoE) pretraining steps on one device, "
                    "random weights and a random batch from --seed (the same "
                    "batch every step).")
    p.add_argument("--preset", default="llama2_7b",
                   choices=("tiny", "llama2_7b", "mixtral_tiny",
                            "mixtral_8x7b"))
    p.add_argument("--num-layers", type=int, default=None,
                   help="cut the preset's depth (widths unchanged)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--steps", type=int, default=5,
                   help="steps, the first of them the warm-up")
    p.add_argument("--remat-policy", default="full",
                   choices=("full", "dots", "none"))
    p.add_argument("--loss-chunks", type=int, default=16)
    p.add_argument("--m-dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def build_trainer(args):
    """``(PretrainStep, state, ids, labels)`` for parsed ``args``: the
    preset (depth cut by ``--num-layers``), bench.py's single-chip rung
    settings by default (remat full, 16 loss chunks, bf16 ``m``, fp32
    ``v``), and one random batch on the device."""
    kw = {} if args.num_layers is None else \
        {"num_hidden_layers": args.num_layers}
    cfg = getattr(LlamaConfig, args.preset)(**kw)
    remat = args.remat_policy != "none"
    pc = ParallelConfig(remat=remat,
                        remat_policy=args.remat_policy if remat else "full",
                        loss_chunks=args.loss_chunks, m_dtype=args.m_dtype)
    ps = PretrainStep(cfg, pc, device=args.device)
    state = ps.init_state(seed=args.seed)
    rng = np.random.default_rng(args.seed)
    shape = (args.batch, args.seq)
    ids, labels = ps.shard_batch(rng.integers(0, cfg.vocab_size, shape),
                                 rng.integers(0, cfg.vocab_size, shape))
    return ps, state, ids, labels


def use_expandable_segments() -> None:
    """Let the CUDA allocator grow segments rather than fragment: a 7B
    state leaves little room on an 80 GB card.  Call it before the first
    CUDA allocation, when the allocator reads the setting."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def run_steps(ps, state, ids, labels, steps: int, log=None):
    """``steps`` train steps on one batch, each waited for (its loss read
    back).  Returns ``(state, losses, seconds)``: each step's loss and wall
    seconds.  ``log(i, loss, seconds)`` is called after each step."""
    losses, seconds = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = ps.train_step(state, ids, labels)
        losses.append(float(loss))            # waits for the step
        seconds.append(time.perf_counter() - t0)
        if log is not None:
            log(i, losses[-1], seconds[-1])
    return state, losses, seconds


def throughput(ps, ids, seconds) -> Dict[str, Any]:
    """Mean step ms and tokens/s over timed steps of ``seconds``; on the
    card also the MFU (6·N and 8·N FLOP per token over the bf16 peak) and
    the peak memory allocated."""
    step_s = sum(seconds) / len(seconds)
    tok_s = ids.numel() / step_s
    cuda = ps.device.type == "cuda"
    peak = PEAK_FLOPS["bfloat16"]
    return {
        "step_ms": step_s * 1e3, "tokens_per_s": tok_s,
        "mfu_6n": tok_s * ps.flops_per_token() / peak if cuda else None,
        "mfu_8n": tok_s * ps.flops_per_token(include_remat=True) / peak
        if cuda else None,
        "max_memory_allocated": torch.cuda.max_memory_allocated(ps.device)
        if cuda else None}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    use_expandable_segments()
    ps, state, ids, labels = build_trainer(args)
    cuda = ps.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(ps.device)

    def log(i, loss, s):
        print(json.dumps({"step": i, "loss": loss, "ms": s * 1e3}),
              flush=True)

    state, _, seconds = run_steps(ps, state, ids, labels, args.steps, log)
    # the first step warms up
    last = {"device": torch.cuda.get_device_name(ps.device) if cuda else "cpu",
            "preset": args.preset, "layers": ps.config.num_hidden_layers,
            "params": ps.config.num_params(),
            "active_params": ps.config.num_active_params(),
            "batch": args.batch, "seq": args.seq,
            "remat_policy": args.remat_policy,
            **throughput(ps, ids, seconds[1:] or seconds)}
    if ps.config.moe_num_experts:
        last["router_stats"] = ps.router_stats(state, ids)
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
