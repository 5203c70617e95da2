"""Optimizers (the port of ``paddle_tpu/optimizer/__init__.py``): the
``Optimizer`` base and all fifteen of the reference's, ``SGD``,
``Momentum``, ``Adam``, ``AdamW``, ``Adamax``, ``RMSProp``, ``Adagrad``,
``Adadelta``, ``NAdam``, ``RAdam``, ``ASGD``, ``Rprop``, ``Lamb``, ``Lars``
(alias ``LarsMomentumOptimizer``) and ``LBFGS``.

The updates are the reference's arithmetic, not ``torch.optim``'s, done in
place under ``no_grad`` on ``data`` (the parameter, or its float32 master
at O2) with no host read, e.g.:

- ``SGD``: ``p -= lr * (g + wd * p)``;
- ``Momentum`` (:240): ``g += wd * p; v = mu * v + g``, then ``p -= lr * v``
  (Nesterov: ``p -= lr * (g + mu * v)``);
- ``Adam`` (:269): ``g += wd * p`` (L2), ``m = b1 m + (1 - b1) g``, ``v = b2
  v + (1 - b2) g^2``, ``p -= lr * mhat / (sqrt(vhat) + eps)``;
- ``AdamW`` (:369): the same with the decay added to the update, ``p -= lr
  * (mhat / (sqrt(vhat) + eps) + wd * p)``, at ``lr * lr_ratio(p)``, and no
  decay where ``apply_decay_param_fun(p.name)`` is false;
- ``Lamb`` (:618) and ``Lars`` (:648) scale by trust ratios of norms taken
  with ``torch.where``, on the device.

``RAdam``'s rectification branch (:520) is host arithmetic on the step
count (nothing is read from the device); ``LBFGS`` (:672) reads the loss
and its line-search scalars on the host, each read a marked sync
(``observability.count_sync``) on the card.

A parameter's own ``regularizer`` replaces the optimizer's decay; a
regularizer passed as ``weight_decay=`` raises ``TypeError`` at ``step()``
(the reference's ``_decay_for`` calls ``float()`` on it).  With fp32 master
weights on (``amp.decorate`` at O2) a half-precision parameter is updated
through a float32 copy and rounded back.  Parameter groups are flattened
and their own settings ignored, as the reference does.

**Row-sparse gradients** (``Embedding(sparse=True)``, a
``SelectedRowsTensor``) take the sparse branch where the reference does
(:110-118: no regularizer on the parameter, no master weights): ``SGD``
moves and decays only the touched rows (:218), ``Adam`` / ``AdamW`` update
the touched rows only (``lazy_mode``, :281) or every row with the
gradient scattered (:299), plain Adam's L2 decay densifying in exact mode
and decaying the touched rows in lazy mode (:328-354); every other
optimizer densifies (:158).  None of it reads the host.

``state_dict`` keys the accumulators as the reference does (``velocity_0``,
``moment1_3``, ``mu_product_0``, ..., ``@step``, ``LR_Scheduler``), so
optimizer state crosses between the packages both ways.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.selected_rows import SelectedRowsTensor, grad_of
from ..core.tensor import Parameter, Tensor, boundary  # noqa: F401

from ..amp import drop_grad
from ..nn.clip import ClipGradBase
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
    def _acc(self, name: str, p, like: torch.Tensor, init=None
             ) -> torch.Tensor:
        """Accumulator ``name`` of parameter ``p``: at first use zeros like
        ``like`` (the parameter, or its float32 master), or ``init()``."""
        store = self._accumulators.setdefault(name, {})
        if id(p) not in store:
            store[id(p)] = torch.zeros_like(like) if init is None \
                else init()
        return store[id(p)]

    # ---- main API ----
    @property
    def _params(self) -> List[torch.Tensor]:
        if self._parameter_list is None:
            raise ValueError("Optimizer created without parameters")
        return self._parameter_list

    def _collect_params_grads(self):
        pairs = []
        for p in self._params:
            if getattr(p, "trainable", p.requires_grad):
                g = grad_of(p)
                if g is not None:
                    pairs.append((p, g))
        return pairs

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
            if isinstance(g, SelectedRowsTensor):
                if reg is None and not self._use_master_weights:
                    self._update_param_sparse(p, g, lr_val,
                                              self._decay_for(p))
                    continue
                g = g._dense()
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

    def _update_param_sparse(self, p, g, lr_val: float, wd: float):
        """Update ``p`` from row-sparse ``g``; an optimizer with no sparse
        rule densifies."""
        self._update_param(p, p, g._dense().to(p.dtype), lr_val, wd)

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

    def _update_param_sparse(self, p, g, lr_val, wd):
        """Only the touched rows move, and only they decay (:218)."""
        rows, values, live = g._update_rows()
        old = p.index_select(0, rows)
        upd = values.to(p.dtype)
        if wd:
            upd = upd + wd * old
        p.index_copy_(0, rows, torch.where(live, old + (-lr_val) * upd, old))


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

    def _update_param_sparse(self, p, g, lr_val, wd):
        """Lazy mode moves the moments and weights of the touched rows only
        (:281); exact mode decays every row's moments and scatters the
        gradient in (:299), the dense arithmetic without a dense gradient.
        Plain Adam's L2 decay makes the gradient dense, so exact mode with
        it densifies; lazy mode decays the touched rows (:328-354)."""
        adamw = isinstance(self, AdamW)
        if not adamw and wd and not self._lazy_mode:
            return super()._update_param_sparse(p, g, lr_val, wd)
        if getattr(self, "_lr_ratio", None) is not None:
            lr_val = lr_val * self._lr_ratio(p)
        decoupled = (wd or 0.0) if adamw else None
        b1, b2, t = self._beta1, self._beta2, float(self._step_count)
        m = self._acc("moment1", p, p)
        v = self._acc("moment2", p, p)
        if not self._lazy_mode:
            values = g._values.to(m.dtype)
            m.mul_(b1).index_add_(0, g._rows, (1 - b1) * values)
            v.mul_(b2).index_add_(0, g._rows, (1 - b2) * torch.square(values))
            update = (m / (1 - b1 ** t)) / (
                torch.sqrt(v / (1 - b2 ** t)) + self._epsilon)
            if decoupled is not None:
                update = update + decoupled * p
            p.sub_(lr_val * update.to(p.dtype))
            return
        rows, values, live = g._update_rows()
        old = p.index_select(0, rows)
        if not adamw and wd:
            values = values + wd * old.to(values.dtype)
        gv = values.float()
        m_old, v_old = m.index_select(0, rows), v.index_select(0, rows)
        m_new = b1 * m_old + (1 - b1) * gv
        v_new = b2 * v_old + (1 - b2) * torch.square(gv)
        update = (m_new / (1 - b1 ** t)) / (
            torch.sqrt(v_new / (1 - b2 ** t)) + self._epsilon)
        if decoupled is not None:
            update = update + decoupled * old.float()
        new = old + (-lr_val * update).to(p.dtype)
        p.index_copy_(0, rows, torch.where(live, new, old))
        m.index_copy_(0, rows, torch.where(live, m_new.to(m.dtype), m_old))
        v.index_copy_(0, rows, torch.where(live, v_new.to(v.dtype), v_old))


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


class Adamax(Optimizer):
    """``u = max(b2 u, |g|)``; ``p -= lr / (1 - b1^t) * m / (u + eps)``
    (:391)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _acc_names(self):
        return ["moment", "inf_norm"]

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        m = self._acc("moment", p, data)
        u = self._acc("inf_norm", p, data)
        m.mul_(self._beta1).add_((1 - self._beta1) * g)
        torch.maximum(self._beta2 * u, torch.abs(g), out=u)
        data.sub_((lr_val / (1 - self._beta1 ** self._step_count)) * m /
                  (u + self._epsilon))


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g^2``; the step ``lr g / sqrt(ms + eps)``
    (centered: ``sqrt(ms - mg^2 + eps)``, epsilon inside the root) rides a
    momentum ``velocity`` (:413)."""

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _acc_names(self):
        return ["mean_square", "mean_grad", "velocity"]

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        rho = self._rho
        ms = self._acc("mean_square", p, data)
        ms.mul_(rho).add_((1 - rho) * torch.square(g))
        if self._centered:
            mg = self._acc("mean_grad", p, data)
            mg.mul_(rho).add_((1 - rho) * g)
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        vel = self._acc("velocity", p, data)
        vel.mul_(self._momentum).add_(lr_val * g / denom)
        data.sub_(vel)


class Adagrad(Optimizer):
    """``acc += g^2``; ``p -= lr g / (sqrt(acc) + eps)``, ``acc`` starting
    at ``initial_accumulator_value`` (:441)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _acc_names(self):
        return ["moment"]

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        acc = self._acc("moment", p, data,
                        lambda: torch.full_like(data, self._init_acc))
        acc.add_(torch.square(g))
        data.sub_(lr_val * g / (torch.sqrt(acc) + self._epsilon))


class Adadelta(Optimizer):
    """``update = sqrt(su + eps) / sqrt(sg + eps) g``, both averages at
    ``rho`` (:460)."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _acc_names(self):
        return ["avg_squared_grad", "avg_squared_update"]

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        rho, eps = self._rho, self._epsilon
        sg = self._acc("avg_squared_grad", p, data)
        su = self._acc("avg_squared_update", p, data)
        sg.mul_(rho).add_((1 - rho) * torch.square(g))
        update = torch.sqrt(su + eps) / torch.sqrt(sg + eps) * g
        su.mul_(rho).add_((1 - rho) * torch.square(update))
        data.sub_(lr_val * update)


class NAdam(Optimizer):
    """Adam with Nesterov momentum over the ``mu_product`` schedule (a 0-d
    float32 accumulator; :482)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._momentum_decay = momentum_decay

    def _acc_names(self):
        return ["moment1", "moment2", "mu_product"]

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        t = float(self._step_count)
        b1, b2, psi = self._beta1, self._beta2, self._momentum_decay
        mu_t = b1 * (1.0 - 0.5 * 0.96 ** (t * psi))
        mu_t1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * psi))
        mu_prod = self._acc("mu_product", p, data, lambda: torch.ones(
            (), dtype=torch.float32, device=data.device))
        mu_prod.mul_(mu_t)
        m = self._acc("moment1", p, data)
        v = self._acc("moment2", p, data)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = mu_t1 * m / (1 - mu_prod * mu_t1) + \
            (1 - mu_t) * g / (1 - mu_prod)
        vhat = v / (1 - b2 ** t)
        data.sub_(lr_val * mhat / (torch.sqrt(vhat) + self._epsilon))


class RAdam(Optimizer):
    """Rectified Adam (:520): while the rectification ``rho_t > 5`` does
    not hold (the first five steps at beta2 0.999) the step is
    ``lr * mhat``.  ``rho_t`` is host arithmetic on the step count, so the
    branch reads nothing from the device."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _acc_names(self):
        return ["moment1", "moment2"]

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        b1, b2 = self._beta1, self._beta2
        t = float(self._step_count)
        m = self._acc("moment1", p, data)
        v = self._acc("moment2", p, data)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / (1 - b1 ** t)
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        rho_t = rho_inf - 2.0 * t * (b2 ** t) / (1.0 - b2 ** t)
        if rho_t > 5.0:
            r = ((rho_t - 4) * (rho_t - 2) * rho_inf /
                 ((rho_inf - 4) * (rho_inf - 2) * rho_t)) ** 0.5
            vhat = torch.sqrt(v / (1 - b2 ** t))
            data.sub_(lr_val * r * mhat / (vhat + self._epsilon))
        else:
            data.sub_(lr_val * mhat)


class ASGD(Optimizer):
    """Averaged SGD over a window of the last ``batch_num`` gradients
    (``ys``, a ``[batch_num, ...]`` float32 ring; ``d`` their sum; :557)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = max(1, int(batch_num))

    def _acc_names(self):
        return ["d", "ys"]

    def _update_param(self, p, data, g, lr_val, wd):
        if wd:
            g = g + wd * data
        n = self._batch_num
        d = self._acc("d", p, data)
        ys = self._acc("ys", p, data, lambda: torch.zeros(
            (n,) + tuple(data.shape), dtype=torch.float32,
            device=data.device))
        slot = ys[(self._step_count - 1) % n]
        d.sub_(slot).add_(g.float())
        slot.copy_(g)
        data.sub_(lr_val * (d / min(self._step_count, n)).to(data.dtype))


class Rprop(Optimizer):
    """Resilient backprop (:587): per-weight step sizes (from ``lr``) grow
    by ``etas[1]`` while the gradient keeps its sign and shrink by
    ``etas[0]`` when it flips, within ``learning_rate_range``; a flipped
    gradient is zeroed for the next step.  No weight decay."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_range = learning_rate_range
        self._etas = etas

    def _acc_names(self):
        return ["prev_grad", "step_size"]

    def _update_param(self, p, data, g, lr_val, wd):
        lo, hi = self._lr_range
        eta_minus, eta_plus = self._etas
        prev = self._acc("prev_grad", p, data)
        step = self._acc("step_size", p, data, lambda: torch.full(
            tuple(data.shape), float(lr_val), dtype=torch.float32,
            device=data.device))
        g = g.float()
        sign = torch.sign(g * prev)
        factor = torch.where(sign > 0, eta_plus,
                             torch.where(sign < 0, eta_minus, 1.0))
        torch.clamp(step * factor, lo, hi, out=step)
        g_eff = torch.where(sign < 0, 0.0, g)
        data.sub_((torch.sign(g_eff) * step).to(data.dtype))
        self._accumulators["prev_grad"][id(p)] = g_eff


def _norm(x):
    return torch.linalg.vector_norm(x)


class Lamb(Optimizer):
    """Adam's direction plus the decay, scaled by the trust ratio ``|p| /
    |r|`` (1 where either norm is 0; :618)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _acc_names(self):
        return ["moment1", "moment2"]

    def _update_param(self, p, data, g, lr_val, wd):
        b1, b2, t = self._beta1, self._beta2, float(self._step_count)
        m = self._acc("moment1", p, data)
        v = self._acc("moment2", p, data)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        r = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) +
                                   self._epsilon)
        if wd and (self._exclude_fn is None or not self._exclude_fn(p)):
            r = r + wd * data
        w_norm, r_norm = _norm(data), _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        data.sub_(lr_val * trust * r)


class Lars(Momentum):
    """Momentum at the layer-wise rate ``coeff |p| / (|g| + wd |p| + eps)``
    (1 where either norm is 0; :648).  ``exclude_from_weight_decay`` is
    accepted and ignored, as in the reference."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0, name=None):
        super().__init__(learning_rate, momentum, parameters, False,
                         lars_weight_decay, grad_clip, name)
        self._lars_coeff = lars_coeff
        self._lars_eps = epsilon

    def _update_param(self, p, data, g, lr_val, wd):
        w_norm, g_norm = _norm(data), _norm(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm / (g_norm + wd * w_norm +
                                         self._lars_eps), 1.0)
        v = self._acc("velocity", p, data)
        v.mul_(self._momentum).add_(lr_val * local_lr * (g + wd * data))
        data.sub_(v)


LarsMomentumOptimizer = Lars


def _read(t) -> float:
    """``float(t)``: a marked sync on the card."""
    if torch.is_tensor(t):
        if t.device.type != "cpu":
            from ..observability import count_sync
            count_sync()
        t = t.detach()
    return float(t)


class LBFGS(Optimizer):
    """Limited-memory BFGS driven by a closure (:672): the two-loop
    recursion over the last ``history_size`` ``(s, y)`` pairs gives the
    direction, and the step halves from ``lr`` (1 once there is history)
    until Armijo's condition holds (with ``line_search_fn="strong_wolfe"``
    the curvature condition too, falling back to the best Armijo point).
    The loss, the gradient's max and the line search's dot products are
    read on the host, each a marked sync on the card."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay=weight_decay,
                         grad_clip=grad_clip, name=name)
        self.max_iter = max_iter
        self.max_eval = max_eval or max_iter * 5 // 4
        self.tol_grad = tolerance_grad
        self.tol_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s, self._y = [], []

    def _flat_params(self):
        return torch.cat([p.detach().reshape(-1).float()
                          for p in self._params])

    def _flat_grad(self):
        pgs = [(p, g) for p in self._params
               if (g := grad_of(p)) is not None]
        if self._grad_clip is not None and pgs:
            pgs = self._grad_clip(pgs)
        clipped = {id(p): g for p, g in pgs}
        parts = []
        for p in self._params:
            g = clipped.get(id(p))
            if isinstance(g, SelectedRowsTensor):
                g = g._dense()
            parts.append(g.reshape(-1).float() if g is not None else
                         torch.zeros(p.numel(), device=p.device))
        flat = torch.cat(parts)
        if self._weight_decay:
            flat = flat + float(self._weight_decay) * self._flat_params()
        return flat

    def _assign(self, flat):
        off = 0
        for p in self._params:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def _direction(self, g):
        """The two-loop recursion: the inverse-Hessian estimate applied to
        ``-g``."""
        q = -g
        alphas = []
        for s, y in reversed(list(zip(self._s, self._y))):
            rho = 1.0 / torch.clamp_min(torch.dot(y, s), 1e-10)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((a, rho, s, y))
        if self._s:
            s, y = self._s[-1], self._y[-1]
            q = q * (torch.dot(s, y) /
                     torch.clamp_min(torch.dot(y, y), 1e-10))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q

    @torch.no_grad()
    @boundary
    def step(self, closure=None):
        if closure is None:
            raise ValueError("LBFGS.step requires a closure")

        def evaluate():
            self.clear_grad()
            with torch.enable_grad():
                return _read(closure())

        loss = evaluate()
        evals = 1
        for _ in range(self.max_iter):
            g = self._flat_grad()
            if _read(torch.abs(g).max()) <= self.tol_grad:
                break
            d = self._direction(g)
            x0 = self._flat_params()
            g0, loss0 = g, loss
            t = self.get_lr() if not self._s else 1.0
            dg0 = _read(torch.dot(g0, d))
            if dg0 > -1e-15:     # not a descent direction: reset history
                self._s, self._y = [], []
                d = -g0
                dg0 = _read(torch.dot(g0, d))
            ok = False
            best_armijo = None               # (t, loss) armijo-only fallback
            for _ls in range(20):
                self._assign(x0 + t * d)
                loss = evaluate()
                evals += 1
                armijo = loss <= loss0 + 1e-4 * t * dg0
                wolfe = armijo
                if armijo and self.line_search_fn == "strong_wolfe":
                    if best_armijo is None or loss < best_armijo[1]:
                        best_armijo = (t, loss)
                    g_new = self._flat_grad()
                    if abs(_read(torch.dot(g_new, d))) > 0.9 * abs(dg0):
                        wolfe = False
                if wolfe:
                    ok = True
                    break
                t *= 0.5
                if evals >= self.max_eval:
                    break
            if not ok and best_armijo is not None:
                # the curvature condition cannot hold on the halving grid:
                # take the best sufficient-decrease point
                t, _ = best_armijo
                self._assign(x0 + t * d)
                loss = evaluate()
                evals += 1
                ok = True
            if not ok:
                self._assign(x0)
                loss = loss0
                break
            g_new = self._flat_grad()
            s = self._flat_params() - x0
            y = g_new - g0
            if _read(torch.dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.history_size:
                    self._s.pop(0)
                    self._y.pop(0)
            if _read(torch.abs(s).max()) <= self.tol_change or \
                    abs(loss - loss0) <= self.tol_change:
                break
            if evals >= self.max_eval:
                break
        return torch.tensor(loss, dtype=torch.float32,
                            device=self._params[0].device)


__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "ClipGradBase", "LBFGS", "Lamb", "Lars", "LarsMomentumOptimizer",
           "Momentum", "NAdam", "Optimizer", "RAdam", "RMSProp", "Rprop",
           "SGD", "SelectedRowsTensor", "lr"]
