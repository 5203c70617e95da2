"""``paddle.amp`` (the port of ``paddle_tpu/amp/__init__.py``): ``auto_cast``
(O0, O1, O2), ``decorate`` and ``GradScaler``.

``auto_cast`` pushes the state the port's functional ops read
(:mod:`paddle_tpu_torch.core.amp_state`): at O1 the white-listed ops take
half-precision inputs and the black-listed ones float32; at O2 every op
but the black-listed ones takes half precision.  ``decorate`` at O2 casts
a model's parameters to the amp dtype (the norm layers stay float32) and
turns on the optimizer's float32 master weights.  ``GradScaler`` keeps the
reference's dynamic loss-scaling state machine.
"""

from __future__ import annotations

import weakref

import torch

from ..core.tensor import boundary

from ..core import amp_state
from ..core.amp_state import BLACK_LIST, WHITE_LIST, AmpAttrs

__all__ = ["auto_cast", "autocast", "decorate", "GradScaler", "white_list",
           "black_list", "is_auto_cast_enabled", "get_amp_dtype"]


def white_list():
    return {"float16": set(WHITE_LIST), "bfloat16": set(WHITE_LIST)}


def black_list():
    return {"float16": set(BLACK_LIST), "bfloat16": set(BLACK_LIST)}


def is_auto_cast_enabled() -> bool:
    return amp_state.current().enabled


def get_amp_dtype() -> str:
    cur = amp_state.current()
    return cur.dtype if cur.enabled else "float32"


class auto_cast:
    """Context manager (and decorator) turning per-op autocast on."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"level must be O0/O1/O2, got {level}")
        if dtype not in ("float16", "bfloat16"):
            raise ValueError(f"amp dtype must be float16/bfloat16, got "
                             f"{dtype}")
        self.attrs = AmpAttrs(
            enabled=bool(enable) and level != "O0", level=level, dtype=dtype,
            white=set(custom_white_list or ()),
            black=set(custom_black_list or ()))

    def __enter__(self):
        amp_state.push(self.attrs)
        return self

    def __exit__(self, *exc):
        amp_state.pop()
        return False

    def __call__(self, fn):
        attrs = self.attrs

        def wrapper(*a, **k):
            amp_state.push(attrs)
            try:
                return fn(*a, **k)
            finally:
                amp_state.pop()
        return wrapper


autocast = auto_cast

_KEEP_FP32_LAYERS = ("BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm",
                     "SyncBatchNorm", "RMSNorm")


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False):
    """At O2: the float32 parameters of every layer whose class name holds
    none of the norm names become ``dtype``, and each optimizer keeps
    float32 master weights (unless ``master_weight=False``)."""
    single_model = not isinstance(models, (list, tuple))
    single_opt = optimizers is not None and \
        not isinstance(optimizers, (list, tuple))
    model_list = [models] if single_model else list(models)
    opt_list = [optimizers] if single_opt else list(optimizers or [])
    if level == "O2":
        target = torch.bfloat16 if dtype == "bfloat16" else torch.float16
        with torch.no_grad():
            for model in model_list:
                for layer in model.sublayers(include_self=True):
                    if any(k in type(layer).__name__
                           for k in _KEEP_FP32_LAYERS):
                        continue
                    for p in layer._parameters.values():
                        if p is not None and p.dtype == torch.float32:
                            p.data = p.data.to(target)
        for o in opt_list:
            if master_weight is None or master_weight:
                o._use_master_weights = True
    models_out = model_list[0] if single_model else model_list
    if optimizers is None:
        return models_out
    return models_out, (opt_list[0] if single_opt else opt_list)


def keep_float32_grad(p, g):
    """Write float32 ``g`` into ``p.grad`` (rounded to its dtype) and keep
    ``g`` as the gradient's value for ``float32_grad``."""
    p.grad.copy_(g)
    p._float32_grad = (weakref.ref(p.grad), p.grad._version, g)


def float32_grad(p):
    """The float32 value ``keep_float32_grad`` kept for ``p.grad``, while
    ``p.grad`` is the tensor it was kept beside and unchanged since; else
    ``p.grad``.  So an optimizer step or a clip after
    ``GradScaler.unscale_`` reads the float32 gradient, as the reference's
    does, and an edit of ``.grad`` in between is not lost."""
    kept = getattr(p, "_float32_grad", None)
    if kept is not None and p.grad is not None:
        grad, version, g = kept
        if grad() is p.grad and p.grad._version == version:
            return g
    return p.grad


def drop_grad(p):
    """``p.grad = None``, and the float32 value kept for it."""
    p.grad = None
    p.__dict__.pop("_float32_grad", None)


class GradScaler:
    """Dynamic loss scaling: scale the loss, unscale the gradients before
    the step, skip the step and shrink the scale when a gradient is not
    finite, grow it after ``incr_every_n_steps`` good steps.

    The gradients are unscaled into float32, as the reference's are (in
    fp16 an unscaled value under 2^-14 would otherwise lose bits, and one
    under 2^-25 would be 0).  Whether one is not finite is read once a step
    (the step is skipped on the host, as in the reference)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = bool(enable)
        self._scale = float(init_loss_scaling) if self._enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    @boundary
    def scale(self, loss):
        return loss * self._scale if self._enable else loss

    @torch.no_grad()
    @boundary
    def unscale_(self, optimizer):
        """Unscale every gradient into float32, as the reference does, and
        find whether one is not finite from those float32 values.  A float32
        gradient is unscaled in place.  A half-precision one cannot hold the
        float32 result (torch keeps a gradient in its parameter's dtype, and
        in fp16 a value under 2^-14 would lose bits): ``.grad`` gets it
        rounded to its dtype, and the float32 value is kept beside it for
        the step (``float32_grad``).  A row-sparse gradient is densified
        first, as the reference's is."""
        if not self._enable or self._unscaled:
            return
        from ..core.selected_rows import SelectedRowsTensor
        inv = 1.0 / self._scale
        bad = []
        for p in optimizer._params:
            if p.grad is None:
                continue
            if isinstance(p.grad, SelectedRowsTensor):
                p.grad = p.grad._dense()
            if p.grad.dtype == torch.float32:
                g = p.grad.mul_(inv)
            else:
                g = p.grad.float().mul_(inv)
                keep_float32_grad(p, g)
            bad.append(~torch.isfinite(g).all())
        self._found_inf = bool(torch.stack(bad).any()) if bad else False
        self._unscaled = True

    @boundary
    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update_scale()
        self._unscaled = False

    @boundary
    def update(self):
        """No-op kept for API parity; the scale moves in ``step``."""

    @boundary
    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def _update_scale(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


from . import debugging  # noqa: E402,F401
