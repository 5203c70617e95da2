"""Optimizers (the port of ``paddle_tpu/optimizer/__init__.py``'s
``Optimizer`` base, ``SGD``, ``Momentum``, ``Adam`` and ``AdamW``).

The updates are the reference's arithmetic, not ``torch.optim``'s, done in
place under ``no_grad`` with no host read:

- ``SGD``: ``p -= lr * (g + wd * p)``;
- ``Momentum`` (:240): ``g += wd * p; v = mu * v + g``, then ``p -= lr * v``
  (Nesterov: ``p -= lr * (g + mu * v)``);
- ``Adam`` (:269): ``g += wd * p`` (L2), ``m = b1 m + (1 - b1) g``, ``v = b2
  v + (1 - b2) g^2``, ``p -= lr * mhat / (sqrt(vhat) + eps)``;
- ``AdamW`` (:369): the same with the decay added to the update, ``p -= lr
  * (mhat / (sqrt(vhat) + eps) + wd * p)``, at ``lr * lr_ratio(p)``, and no
  decay where ``apply_decay_param_fun(p.name)`` is false.

A parameter's own ``regularizer`` replaces the optimizer's decay.  With fp32
master weights on (``amp.decorate`` at O2) a half-precision parameter is
updated through a float32 copy and rounded back.  Parameter groups are
flattened and their own settings ignored, as the reference does.
``state_dict`` keys the accumulators as the reference does (``velocity_0``,
``moment1_3``, ..., ``@step``, ``LR_Scheduler``), so optimizer state crosses
between the packages.  The reference's other optimizers wait for a later
slice (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.tensor import boundary

from ..amp import drop_grad, float32_grad
from . import lr  # noqa: F401
from .lr import LRScheduler

_HALF = (torch.float16, torch.bfloat16)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is not None:
            parameters = list(parameters)
        self._learning_rate = learning_rate
        self._parameter_list = self._flatten_param_groups(parameters)
        self._param_groups = parameters if \
            self._has_param_groups(parameters) else None
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = {}
        self._step_count = 0
        self._use_master_weights = False
        self._master_weights: Dict[int, torch.Tensor] = {}

    @staticmethod
    def _has_param_groups(parameters):
        return bool(parameters) and isinstance(parameters[0], dict)

    @staticmethod
    def _flatten_param_groups(parameters):
        if parameters is None:
            return None
        if parameters and isinstance(parameters[0], dict):
            return [p for group in parameters for p in group["params"]]
        return list(parameters)

    # ---- lr ----
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("optimizer's learning rate is an LRScheduler; "
                               "call scheduler.step() instead")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # ---- accumulators ----
    def _acc(self, name: str, p, like: torch.Tensor) -> torch.Tensor:
        """Accumulator ``name`` of parameter ``p``, zeros like ``like``
        (the parameter, or its float32 master) at first use."""
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = torch.zeros_like(like)
        return store[id(p)]

    # ---- main API ----
    @property
    def _params(self) -> List[torch.Tensor]:
        if self._parameter_list is None:
            raise ValueError("Optimizer created without parameters")
        return self._parameter_list

    def _collect_params_grads(self):
        return [(p, float32_grad(p)) for p in self._params
                if getattr(p, "trainable", p.requires_grad) and
                p.grad is not None]

    @torch.no_grad()
    @boundary
    def step(self):
        self._apply_optimize(self._collect_params_grads())

    def _apply_optimize(self, params_grads):
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr_val = self.get_lr()
        self._step_count += 1
        for p, g in params_grads:
            reg = getattr(p, "regularizer", None)
            if reg is not None:
                g = g + reg(p).to(g.dtype)
                wd = 0.0
            else:
                wd = self._decay_for(p)
            if self._use_master_weights and p.dtype in _HALF:
                master = self._master_weights.get(id(p))
                if master is None:
                    master = p.detach().float()
                    self._master_weights[id(p)] = master
                self._update_param(p, master, g.float(), lr_val, wd)
                p.copy_(master)
            else:
                self._update_param(p, p, g.to(p.dtype), lr_val, wd)

    def _decay_for(self, p) -> float:
        wd = self._weight_decay
        if wd is None:
            return 0.0
        fn = getattr(self, "_apply_decay_param_fun", None)
        if callable(fn) and not fn(p.name):
            return 0.0
        return float(wd) if not isinstance(wd, (list, tuple)) \
            else float(wd[0])

    def _update_param(self, p, data, g, lr_val: float, wd: float):
        """Update ``data`` (``p`` itself, or its float32 master) in place
        from gradient ``g``."""
        raise NotImplementedError

    @boundary
    def clear_grad(self, set_to_zero=True):
        for p in self._params:
            drop_grad(p)

    clear_gradients = clear_grad

    @boundary
    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # ---- state dict ----
    def state_dict(self):
        state = {}
        for name, store in self._accumulators.items():
            for i, p in enumerate(self._params):
                if id(p) in store:
                    state[f"{name}_{i}"] = store[id(p)]
        state["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        return state

    def set_state_dict(self, state_dict):
        """Load what ``state_dict`` (this package's or the reference's, its
        values tensors or numpy arrays) returned."""
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for name in list(self._accumulators) or self._acc_names():
            store = self._accumulators.setdefault(name, {})
            for i, p in enumerate(self._params):
                v = state_dict.get(f"{name}_{i}")
                if v is not None:
                    t = v.detach() if torch.is_tensor(v) else \
                        torch.tensor(np.asarray(v))
                    store[id(p)] = t.to(p.device, copy=True)

    def _acc_names(self):
        return []


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        data.sub_(lr_val * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _acc_names(self):
        return ["velocity"]

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        v = self._acc("velocity", p, data)
        v.mul_(self._momentum).add_(g)
        update = g + self._momentum * v if self._use_nesterov else v
        data.sub_(lr_val * update)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode
        self._multi_precision = multi_precision

    def _acc_names(self):
        return ["moment1", "moment2"]

    def _adam(self, p, data, g, lr_val, decoupled_wd):
        b1, b2, t = self._beta1, self._beta2, float(self._step_count)
        m = self._acc("moment1", p, data)
        v = self._acc("moment2", p, data)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        update = mhat / (torch.sqrt(vhat) + self._epsilon)
        if decoupled_wd is not None:
            update = update + decoupled_wd * data
        data.sub_(lr_val * update)

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        self._adam(p, data, g, lr_val, None)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _update_param(self, p, data, g, lr_val, wd):
        if self._lr_ratio is not None:
            lr_val = lr_val * self._lr_ratio(p)
        self._adam(p, data, g, lr_val, wd or 0.0)


__all__ = ["Adam", "AdamW", "Momentum", "Optimizer", "SGD", "lr"]
