"""Numeric debugging (the port of ``paddle_tpu/amp/debugging.py``):
the tensor checker, ``check_numerics``, operator stats and the per-layer
numerics watcher.

The reference checks every eager op's output in ``core.autograd.apply``;
the port's ops are the functions ``core.tensor.boundary_module`` wraps
(``ops``, ``nn.functional``), which call ``core.tensor.OP_OBSERVERS`` with
each result, nested calls too.  The checker and ``collect_operator_stats``
observe there.  Every read of a count or a finiteness test is a host read:
a marked sync (``observability.count_sync``) on the card, so these tools
belong in a debugging session, not in a timed loop.
"""

from __future__ import annotations

import contextlib
import os
from enum import Enum
from typing import Optional

import torch

from ..core import tensor as _tensor
from ..core.tensor import Tensor, wrap  # noqa: F401

__all__ = ["DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "check_numerics", "collect_operator_stats",
           "compare_accuracy", "LayerNumericsWatcher", "check_layer_numerics",
           "active_checker_config"]


def _host(t):
    """``t.tolist()``: one marked sync on the card."""
    if t.device.type != "cpu":
        from ..observability import count_sync
        count_sync()
    return t.tolist()


def _nan_inf(t):
    """``(nan count, inf count)`` of ``t`` in one read."""
    return tuple(int(v) for v in _host(torch.stack(
        [torch.isnan(t).sum(), torch.isinf(t).sum()])))


def _floats(out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [o for o in outs if torch.is_tensor(o) and o.is_floating_point()]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    """What the tensor checker checks: op allow / skip lists, a
    ``debug_step`` window ``(start, end)`` of training steps
    (``update_step_id``), abort or report (``debug_mode``), and a findings
    log (``output_dir``/``tensor_checker.log``)."""

    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = set(checked_op_list) if checked_op_list \
            else None
        self.skipped_op_list = set(skipped_op_list) if skipped_op_list \
            else None
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit
        self._step = 0
        self.findings: list = []             # [(step, op, n_nan, n_inf)]

    def should_check(self, op_name: str) -> bool:
        if not self.enable:
            return False
        if self.debug_step is not None:
            start, end = self.debug_step
            if not start <= self._step < end:
                return False
        if self.skipped_op_list and op_name in self.skipped_op_list:
            return False
        if self.checked_op_list is not None:
            return op_name in self.checked_op_list
        return True

    def report(self, op_name: str, t) -> bool:
        """Record a NaN/Inf hit; True when the mode aborts."""
        n_nan, n_inf = _nan_inf(t)
        self.findings.append((self._step, op_name, n_nan, n_inf))
        if self.output_dir is not None:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir,
                                   "tensor_checker.log"), "a") as f:
                f.write(f"step={self._step} op={op_name} "
                        f"nan={n_nan} inf={n_inf}\n")
        return self.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT

    def update_step_id(self, step: int):
        self._step = int(step)


_ACTIVE_CHECKER: Optional[TensorCheckerConfig] = None


def active_checker_config() -> Optional[TensorCheckerConfig]:
    return _ACTIVE_CHECKER


def _check_op(name, out):
    cfg = _ACTIVE_CHECKER
    if cfg is None or not cfg.should_check(name):
        return
    for t in _floats(out):
        if not _host(torch.isfinite(t).all()):
            if cfg.report(name, t):
                raise FloatingPointError(
                    f"NaN/Inf detected in output of op '{name}'")


def enable_tensor_checker(config: TensorCheckerConfig):
    """Check every op's float outputs for NaN/Inf under ``config`` (one
    marked read an output, two on a hit)."""
    global _ACTIVE_CHECKER
    if config.enable:
        _ACTIVE_CHECKER = config
        if _check_op not in _tensor.OP_OBSERVERS:
            _tensor.OP_OBSERVERS.append(_check_op)


def disable_tensor_checker():
    global _ACTIVE_CHECKER
    _ACTIVE_CHECKER = None
    if _check_op in _tensor.OP_OBSERVERS:
        _tensor.OP_OBSERVERS.remove(_check_op)


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Raise ``FloatingPointError`` naming the NaN and Inf counts of
    ``tensor``; else return them as tensors (one marked read)."""
    t = _tensor._to_plain(tensor)
    num_nan, num_inf = _nan_inf(t)
    if num_nan or num_inf:
        raise FloatingPointError(
            f"[check_numerics] op={op_type} var={var_name}: "
            f"{num_nan} NaN, {num_inf} Inf values detected")
    return wrap(torch.tensor(num_nan)), wrap(torch.tensor(num_inf))


def _dtype_name(out):
    first = out[0] if isinstance(out, (tuple, list)) and out else out
    return str(first.dtype).replace("torch.", "") if torch.is_tensor(first) \
        else "other"


@contextlib.contextmanager
def collect_operator_stats():
    """Count the ops run in the block by their first output's dtype
    (``float16``, ``bfloat16``, ``float32``, ``other``); the dict is
    yielded and printed at the end, as the reference's."""
    stats = {"float16": 0, "bfloat16": 0, "float32": 0, "other": 0}

    def count(name, out):
        dt = _dtype_name(out)
        stats[dt if dt in stats else "other"] += 1

    _tensor.OP_OBSERVERS.append(count)
    try:
        yield stats
    finally:
        _tensor.OP_OBSERVERS.remove(count)
        print("<------------------------------ op list "
              "------------------------------->")
        for k, v in stats.items():
            print(f"  {k:<10} calls: {v}")


def compare_accuracy(dump_path, another_dump_path, output_filename=None,
                     loss_scale=1, dump_all_tensors=False):
    raise NotImplementedError(
        "compare_accuracy requires tensor dump files; use "
        "paddle_tpu_torch.amp.debugging.check_numerics for live checking")


class LayerNumericsWatcher:
    """Forward-post hooks on every sublayer recording each float output's
    mean, largest magnitude and NaN / Inf counts (one marked read an
    output)."""

    def __init__(self, model):
        self._model = model
        self._handles = []
        self.stats: dict = {}

    def _record(self, name):
        def hook(layer, inputs, outputs):
            for o in _floats(outputs):
                o = _tensor._to_plain(o).detach().float()
                mean, absmax, n_nan, n_inf = _host(torch.stack([
                    o.mean(), o.abs().max(), torch.isnan(o).sum(),
                    torch.isinf(o).sum()]))
                s = self.stats.setdefault(name, {
                    "calls": 0, "mean": 0.0, "absmax": 0.0,
                    "nan": 0, "inf": 0})
                s["calls"] += 1
                s["mean"] = float(mean)
                s["absmax"] = max(s["absmax"], float(absmax))
                s["nan"] += int(n_nan)
                s["inf"] += int(n_inf)
            return None
        return hook

    def watch(self):
        for name, sub in self._model.named_sublayers():
            self._handles.append(
                sub.register_forward_post_hook(self._record(name)))
        return self

    def unwatch(self):
        for h in self._handles:
            h.remove()
        self._handles.clear()

    def first_bad_layer(self):
        """The first layer whose output held a NaN or an Inf, else None."""
        for name, s in self.stats.items():
            if s["nan"] or s["inf"]:
                return name
        return None

    def summary(self) -> str:
        lines = [f"{'layer':<40} {'calls':>5} {'mean':>12} {'absmax':>12} "
                 f"{'nan':>6} {'inf':>6}"]
        for name, s in self.stats.items():
            lines.append(f"{name:<40} {s['calls']:>5} {s['mean']:>12.4g} "
                         f"{s['absmax']:>12.4g} {s['nan']:>6} {s['inf']:>6}")
        return "\n".join(lines)


def check_layer_numerics(model):
    """A :class:`LayerNumericsWatcher` watching every sublayer of
    ``model`` (``.unwatch()`` detaches it)."""
    return LayerNumericsWatcher(model).watch()
