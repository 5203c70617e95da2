"""``paddle.autograd`` over PyTorch's autograd (the port of
``paddle_tpu/autograd/__init__.py``).

The reference records its own tape (``paddle_tpu/core/autograd.py``); in the
port torch's autograd is that tape.  ``backward``, ``grad``, ``no_grad`` and
:class:`PyLayer` keep the reference's signatures over it.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.tensor import wrap

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext"]


def _list(xs):
    if xs is None:
        return None
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``
    (reference ``backward_mode.py:33``)."""
    torch.autograd.backward(_list(tensors), _list(grad_tensors),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Gradients of ``outputs`` with respect to ``inputs``, returned as a
    list (``None`` for an input ``outputs`` do not reach, with
    ``allow_unused``)."""
    out = torch.autograd.grad(_list(outputs), _list(inputs),
                              grad_outputs=_list(grad_outputs),
                              retain_graph=retain_graph,
                              create_graph=create_graph,
                              allow_unused=allow_unused)
    return wrap(list(out))


class PyLayerContext:
    """The ``ctx`` a :class:`PyLayer`'s ``forward`` and ``backward`` get."""

    def __init__(self, ctx):
        self._ctx = ctx

    def save_for_backward(self, *tensors):
        self._ctx.save_for_backward(*tensors)

    def saved_tensor(self) -> List[torch.Tensor]:
        return list(self._ctx.saved_tensors)


class PyLayerMeta(type):
    def __call__(cls, *args, **kwargs):
        raise RuntimeError(
            "PyLayer is not instantiated directly; call MyLayer.apply(...)")


def _function_of(layer_cls):
    """The ``torch.autograd.Function`` that runs ``layer_cls``'s forward
    and backward (made once a class)."""
    fn = layer_cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(ctx, kwargs, *args):
        ctx.pylayer = PyLayerContext(ctx)
        return layer_cls.forward(ctx.pylayer, *args, **kwargs)

    def backward(ctx, *grads):
        out = layer_cls.backward(ctx.pylayer, *grads)
        out = out if isinstance(out, tuple) else (out,)
        return (None,) + out

    fn = type(f"{layer_cls.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    layer_cls._torch_function = fn
    return fn


class PyLayer(metaclass=PyLayerMeta):
    """A differentiable function written by hand (``paddle.autograd.PyLayer``):
    subclass it with static ``forward(ctx, *args)`` and ``backward(ctx,
    *grads)`` and call ``MyLayer.apply(*args)``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_of(cls).apply(kwargs, *args)
