"""``paddle.autograd`` over PyTorch's autograd (the port of
``paddle_tpu/autograd/__init__.py``).

The reference records its own tape (``paddle_tpu/core/autograd.py``); in the
port torch's autograd is that tape.  ``backward``, ``grad``, ``no_grad`` and
:class:`PyLayer` keep the reference's signatures over it.  The functional
transforms ``jacobian``, ``hessian``, ``jvp`` and ``vjp`` (the reference's
``jax.jacrev`` / ``hessian`` / ``jvp`` / ``vjp``, :130-238) run on
``torch.func``; the function sees :class:`~paddle_tpu_torch.Tensor`
arguments, and the results keep the reference's structure: one tensor for
one input, tuples otherwise.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.tensor import Tensor, _to_plain, wrap

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled

__all__ = ["backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
           "is_grad_enabled", "PyLayer", "PyLayerContext", "LegacyPyLayer",
           "jacobian", "hessian", "jvp", "vjp", "saved_tensors_hooks"]


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
    """The ``ctx`` a :class:`PyLayer`'s ``forward`` and ``backward`` get.
    Under :class:`saved_tensors_hooks` ``save_for_backward`` keeps what the
    pack hook returns and ``saved_tensor`` gives it back through the unpack
    hook."""

    def __init__(self, ctx):
        self._ctx = ctx
        self._packed = None

    def save_for_backward(self, *tensors):
        hooks = saved_tensors_hooks._active[-1] \
            if saved_tensors_hooks._active else None
        if hooks is None:
            self._packed = None
            self._ctx.save_for_backward(*tensors)
        else:
            self._packed = (hooks, [hooks.pack_hook(t) for t in tensors])

    def saved_tensor(self) -> List[torch.Tensor]:
        if self._packed is not None:
            hooks, packed = self._packed
            return [hooks.unpack_hook(h) for h in packed]
        return list(self._ctx.saved_tensors)


class saved_tensors_hooks:
    """Hooks on what a :class:`PyLayer` saves (the reference's
    ``saved_tensors_hooks``): inside the block ``pack_hook(t)`` runs at
    ``ctx.save_for_backward`` and ``unpack_hook(packed)`` at
    ``ctx.saved_tensor()``.  Only ``PyLayer`` contexts are hooked, as in
    the reference; torch's own saved tensors are not (its global
    ``torch.autograd.graph.saved_tensors_hooks`` would hook every op)."""

    _active: list = []

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

    def __enter__(self):
        saved_tensors_hooks._active.append(self)
        return self

    def __exit__(self, *exc):
        saved_tensors_hooks._active.pop()
        return False


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


class LegacyPyLayer(PyLayer):
    pass


# ---- functional transforms (torch.func) ----

def _inputs(xs):
    """``(single, plain inputs)``."""
    single = torch.is_tensor(xs)
    return single, [_to_plain(x).detach() for x in ((xs,) if single else xs)]


def _lift(func):
    """``func`` over plain tensors: its arguments seen as ``Tensor``, its
    results (a list as a tuple) returned plain."""
    def plain_fn(*args):
        out = func(*[a.as_subclass(Tensor) for a in args])
        if isinstance(out, (tuple, list)):
            return tuple(_to_plain(o) for o in out)
        return _to_plain(out)
    return plain_fn


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, (tuple, list)) \
        else x


def jacobian(func, xs, is_batched=False):
    """The reverse-mode Jacobian of ``func`` at ``xs`` (``jax.jacrev`` in
    the reference, which ignores ``is_batched`` too): ``out.shape +
    x.shape`` for one input, a tuple over the inputs otherwise."""
    single, args = _inputs(xs)
    jac = torch.func.jacrev(_lift(func), argnums=tuple(range(len(args))))(
        *args)
    if single and isinstance(jac, tuple):
        jac = jac[0]
    return wrap(_tuples(jac))


def hessian(func, xs):
    """The Hessian of scalar ``func`` at ``xs``: ``x.shape + x.shape`` for
    one input, nested tuples ``[i][j]`` otherwise."""
    single, args = _inputs(xs)
    hes = torch.func.hessian(_lift(func), argnums=tuple(range(len(args))))(
        *args)
    if single and isinstance(hes, tuple):
        hes = hes[0][0]
    return wrap(_tuples(hes))


def jvp(func, xs, v=None):
    """``(func(xs), J v)``, ``v`` ones where not given."""
    single, args = _inputs(xs)
    if v is None:
        tangents = tuple(torch.ones_like(a) for a in args)
    else:
        tangents = tuple(_to_plain(t).detach() for t in
                         ((v,) if torch.is_tensor(v) else v))
    out, tangent = torch.func.jvp(_lift(func), tuple(args), tangents)
    return wrap(_tuples(out)), wrap(_tuples(tangent))


def vjp(func, xs, v=None):
    """``(func(xs), v^T J)``, ``v`` ones where not given; the gradient is
    one tensor for one input, a tuple otherwise."""
    single, args = _inputs(xs)
    out, pullback = torch.func.vjp(_lift(func), *args)
    if v is None:
        cot = tuple(torch.ones_like(o) for o in out) \
            if isinstance(out, tuple) else torch.ones_like(out)
    else:
        cot = tuple(_to_plain(t).detach() for t in v) \
            if isinstance(v, (tuple, list)) else _to_plain(v).detach()
    grads = pullback(cot)
    return wrap(_tuples(out)), wrap(grads[0] if single else _tuples(grads))
