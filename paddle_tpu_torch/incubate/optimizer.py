"""``paddle.incubate.optimizer`` (the port of
``paddle_tpu/incubate/optimizer.py``): ``LookAhead`` and ``ModelAverage``.

Both keep their own copies of the parameters on the parameters' device and
update them in place under ``no_grad``; nothing reads the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.tensor import Tensor, boundary  # noqa: F401
from ..optimizer import Optimizer

__all__ = ["LookAhead", "ModelAverage"]


def _tensor(v, like):
    t = v.detach() if torch.is_tensor(v) else torch.tensor(np.asarray(v))
    return t.to(like.device, copy=True)


class LookAhead(Optimizer):
    """``k`` fast steps of ``inner_optimizer``, then the slow weights move
    toward the fast ones, ``slow += alpha * (fast - slow)``, and the fast
    weights take the slow ones.  The slow weights start at the parameters,
    so the first pull is back toward the start."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not isinstance(inner_optimizer, Optimizer):
            raise TypeError("LookAhead wraps an Optimizer, got "
                            f"{type(inner_optimizer).__name__}")
        super().__init__(inner_optimizer._learning_rate,
                         inner_optimizer._parameter_list)
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        with torch.no_grad():
            self._slow: Dict[int, torch.Tensor] = {
                id(p): p.detach().clone() for p in self._params}
        self._k_count = 0

    @torch.no_grad()
    @boundary
    def step(self):
        self.inner_optimizer.step()
        self._k_count += 1
        if self._k_count % self.k:
            return
        for p in self._params:
            slow = self._slow[id(p)]
            slow.add_(self.alpha * (p - slow))
            p.copy_(slow)

    @boundary
    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def state_dict(self):
        state = self.inner_optimizer.state_dict()
        for i, p in enumerate(self._params):
            if id(p) in self._slow:
                state[f"lookahead_slow_{i}"] = self._slow[id(p)]
        state["@lookahead_k_count"] = self._k_count
        return state

    def set_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self._k_count = int(state_dict.pop("@lookahead_k_count", 0))
        for i, p in enumerate(self._params):
            v = state_dict.pop(f"lookahead_slow_{i}", None)
            if v is not None:
                self._slow[id(p)] = _tensor(v, p)
        self.inner_optimizer.set_state_dict(state_dict)


class ModelAverage(Optimizer):
    """A running sum of the parameters, one term a ``step()``; the window
    restarts (the sum at the current parameters) once it has more terms
    than ``min(max_average_window, max(min_average_window, num_updates *
    average_window_rate))``.  ``apply()`` swaps the average in (a second
    ``apply`` keeps the first backup) and ``restore()`` swaps the
    parameters back; ``apply()``'s result restores on leaving a ``with``
    block."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        super().__init__(0.0, parameters)
        self.rate = float(average_window_rate)
        self.min_window = int(min_average_window)
        self.max_window = int(max_average_window)
        self._sum: Dict[int, torch.Tensor] = {}
        self._num_updates = 0
        self._backup: Dict[int, torch.Tensor] = {}

    @torch.no_grad()
    @boundary
    def step(self):
        self._num_updates += 1
        for p in self._params:
            acc = self._sum.get(id(p))
            if acc is None:
                self._sum[id(p)] = p.detach().clone()
            else:
                acc.add_(p)
        window = min(self.max_window,
                     max(self.min_window,
                         int(self._num_updates * self.rate) or 1))
        if self._num_updates > window:
            for p in self._params:
                self._sum[id(p)].copy_(p)
            self._num_updates = 1

    @torch.no_grad()
    @boundary
    def apply(self, executor=None, need_restore=True):
        for p in self._params:
            if id(p) in self._sum and self._num_updates > 0:
                if id(p) not in self._backup:
                    self._backup[id(p)] = p.detach().clone()
                p.copy_((self._sum[id(p)] / self._num_updates).to(p.dtype))
        return _ApplyCtx(self) if need_restore else None

    @torch.no_grad()
    @boundary
    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup.pop(id(p)))

    def state_dict(self):
        state = super().state_dict()
        for i, p in enumerate(self._params):
            if id(p) in self._sum:
                state[f"modelavg_sum_{i}"] = self._sum[id(p)]
        state["@modelavg_num_updates"] = self._num_updates
        return state

    def set_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self._num_updates = int(state_dict.pop("@modelavg_num_updates", 0))
        for i, p in enumerate(self._params):
            v = state_dict.pop(f"modelavg_sum_{i}", None)
            if v is not None:
                self._sum[id(p)] = _tensor(v, p)
        super().set_state_dict(state_dict)


class _ApplyCtx:
    def __init__(self, ma):
        self.ma = ma

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.ma.restore()
        return False
