"""Tensors of the Paddle-API path (the port of ``paddle_tpu/core/tensor.py``).

The reference wraps ``jax.Array`` in a ``Tensor`` of its own with a tape of
its own.  Here :class:`Tensor` is a ``torch.Tensor`` subclass and autograd
is PyTorch's (``stop_gradient`` is ``not requires_grad``).  It carries the
reference's attributes and methods with the reference's meaning
(``transpose(perm)``, ``shape`` as a list-like, ``size`` as an int, the
logical ``~ & | ^`` ...); :mod:`paddle_tpu_torch.ops` attaches the method
table.

**Unwrap in, rewrap out.**  ``Tensor.__torch_function__`` calls a torch
builtin on its arguments as they are with subclass dispatch off (the C++
behind it reads no Python attribute), and a torch function written in
Python on plain aliases of its tensor arguments, so torch's own Python code
never meets a Paddle method; tensor results come back as :class:`Tensor`.

**The boundary.**  The Paddle API's entries (the ops, ``Layer.__call__``,
``nn.functional``, the optimizers' steps, ...) run their bodies on plain
tensors through :func:`boundary`: inputs unwrapped, subclass dispatch off,
results wrapped.  Inside a body the only subclass objects left are
parameters, and there every Paddle method whose name torch also has answers
with torch's method (:func:`dual`), so the layers' torch-style code keeps
its meaning and pays no per-op dispatch.
"""

from __future__ import annotations

import copy
import functools
import itertools
import threading
import types
from collections import OrderedDict

import numpy as np
import torch

from .. import dtypes

_names = itertools.count(1)
_DISABLE = torch._C.DisableTorchFunctionSubclass


class _State(threading.local):
    depth = 0           # > 0 inside a boundary body (this thread)


_ST = _State()
# process-wide count of Tensor.__torch_function__ entries (read by tests and
# chip_smoke's tensor_paths phase)
TORCH_FUNCTION_ENTRIES = [0]


def inside() -> bool:
    """True inside a boundary body, where tensors are plain."""
    return _ST.depth > 0


# ---------------------------------------------------------------- wrapping

def _to_plain(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, Tensor) else t


def unwrap(x, params=True):
    """``x`` with every :class:`Tensor` in it (lists, tuples and dicts are
    walked) as a plain ``torch.Tensor`` alias; with ``params=False`` a
    :class:`Parameter` stays itself (a boundary body keeps its identity,
    its attributes and its ``.grad``)."""
    if isinstance(x, Tensor):
        if not params and isinstance(x, Parameter):
            return x
        return x.as_subclass(torch.Tensor)
    if type(x) in (list, tuple):
        return type(x)(unwrap(v, params) for v in x)
    if type(x) in (dict, OrderedDict):
        return type(x)((k, unwrap(v, params)) for k, v in x.items())
    return x


def wrap(x):
    """``x`` with every plain tensor in it as a :class:`Tensor` alias (lists,
    tuples, namedtuples and dicts are walked); the alias stays on the
    autograd graph.  A fresh leaf is made by :func:`leaf`."""
    t = type(x)
    if t is torch.Tensor:
        return x.as_subclass(Tensor)
    if t is list:
        return [wrap(v) for v in x]
    if t is tuple:
        return tuple(wrap(v) for v in x)
    if t in (dict, OrderedDict):
        return t((k, wrap(v)) for k, v in x.items())
    if isinstance(x, tuple) and hasattr(x, "_fields") or \
            t.__module__ == "torch.return_types":
        return t(wrap(tuple(x)))
    return x


def leaf(t, requires_grad=None):
    """``t``'s data as a new :class:`Tensor` leaf."""
    return torch.Tensor._make_subclass(
        Tensor, _to_plain(t).detach(),
        t.requires_grad if requires_grad is None else requires_grad)


# observers of every op's result (``amp.debugging``'s tensor checker and
# operator stats): each is called as ``observer(op_name, result)`` after an
# op of ``boundary_module`` returns, nested calls too, with subclass
# dispatch off
OP_OBSERVERS: list = []


def _observe(op, out):
    for observer in tuple(OP_OBSERVERS):
        observer(op, out)


def boundary(fn, op=None):
    """``fn`` as a Paddle-API entry: outside a boundary its tensor
    arguments but parameters are unwrapped, its body runs with subclass
    dispatch off, and its tensor results are wrapped; inside one it is
    called as it is.  ``op`` names an op for :data:`OP_OBSERVERS`."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if _ST.depth:
            out = fn(*args, **kwargs)
            if op is not None and OP_OBSERVERS:
                _observe(op, out)
            return out
        _ST.depth += 1
        try:
            with _DISABLE():
                out = fn(*unwrap(args, False), **unwrap(kwargs, False))
                if op is not None and OP_OBSERVERS:
                    _observe(op, out)
        finally:
            _ST.depth -= 1
        return wrap(out)
    entry.__wrapped_entry__ = fn
    return entry


def boundary_module(ns: dict, names) -> None:
    """Wrap every function of ``names`` in namespace ``ns`` (a module's
    ``globals()``) with :func:`boundary` as an op of its function's name;
    two names of one function keep
    one entry, and a function of another module (a re-export) or an
    in-place one (``*_``, which returns its input) stays as it is."""
    made = {}
    for n in names:
        f = ns.get(n)
        if isinstance(f, types.FunctionType) and not n.endswith("_") and \
                f.__module__ == ns["__name__"] and \
                not hasattr(f, "__wrapped_entry__"):
            if id(f) not in made:
                made[id(f)] = boundary(f, op=f.__name__)
            ns[n] = made[id(f)]


def _holds_tensor(args, kwargs):
    for a in (*args, *kwargs.values()):
        if isinstance(a, Tensor) or type(a) in (list, tuple) and \
                any(isinstance(v, Tensor) for v in a):
            return True
    return False


def plain(fn):
    """``fn`` (an entry of the code that keeps plain tensors: the kernels)
    with any :class:`Tensor` argument unwrapped and its body run with
    subclass dispatch off; its results stay as they are.  With no
    ``Tensor`` among its arguments it is called as it is."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        if _ST.depth or not _holds_tensor(args, kwargs):
            return fn(*args, **kwargs)
        _ST.depth += 1
        try:
            with _DISABLE():
                return fn(*unwrap(args, False), **unwrap(kwargs, False))
        finally:
            _ST.depth -= 1
    return entry


def plain_module(ns: dict) -> None:
    """:func:`plain` on every public function module namespace ``ns``
    defines (two names of one function keep one entry)."""
    made = {}
    for n, f in list(ns.items()):
        if isinstance(f, types.FunctionType) and not n.startswith("_") and \
                f.__module__ == ns["__name__"]:
            if id(f) not in made:
                made[id(f)] = plain(f)
            ns[n] = made[id(f)]


def tensor_batches(cls):
    """An iterator class whose ``__next__`` yields its batches with their
    tensors as :class:`Tensor` (the DataLoader's iterators)."""
    nxt = cls.__next__

    def __next__(self):
        return wrap(nxt(self))
    cls.__next__ = __next__
    return cls


def dual(name, fn):
    """The method ``name``: torch's own inside a boundary body, ``fn`` (the
    reference's meaning) outside."""
    torch_method = getattr(torch.Tensor, name)

    def method(self, *args, **kwargs):
        if _ST.depth:
            return torch_method(self, *args, **kwargs)
        return fn(self, *args, **kwargs)
    method.__name__ = name
    method.__qualname__ = f"Tensor.{name}"
    method.__doc__ = fn.__doc__
    return method


# Python-level torch functions that must see the subclass object itself
# (they read or set its identity, its grad or its __dict__)
_KEEP_SELF = {torch.Tensor.__deepcopy__, torch.Tensor.__reduce_ex__,
              torch.Tensor.__setstate__, torch.Tensor.backward,
              torch.Tensor.register_hook, torch.Tensor._reduce_ex_internal,
              torch.autograd.grad, torch.autograd.backward}


# ------------------------------------------------------------ shape, size

class Shape(tuple):
    """``Tensor.shape`` outside a boundary body: a tuple with
    ``torch.Size``'s ``numel`` that also equals a list and adds to a list
    or tuple (``x.shape == [2, 3]``, ``x.shape[:-1] + [n]``, ``w.shape +
    (1,)``, ``w.shape.numel()``).  Inside one it is torch's ``Size``
    (``torch.Size`` takes no subclass)."""

    def __eq__(self, other):
        if isinstance(other, list):
            return list(self) == other
        return tuple.__eq__(self, other)

    def __ne__(self, other):
        return not self.__eq__(other)

    __hash__ = tuple.__hash__

    def __getitem__(self, i):
        out = tuple.__getitem__(self, i)
        return Shape(out) if isinstance(i, slice) else out

    def numel(self) -> int:
        n = 1
        for s in self:
            n *= s
        return n

    def __repr__(self):
        return repr(list(self))

    def __add__(self, other):
        return Shape(tuple(self) + tuple(other))

    def __radd__(self, other):
        if isinstance(other, list):
            return list(other) + list(self)
        return Shape(tuple(other) + tuple(self))


class Size(int):
    """``Tensor.size``: the element count as an ``int`` (the reference's
    property), also callable as torch's ``size(dim=None)``."""

    def __call__(self, dim=None):
        return self.shape if dim is None else self.shape[dim]


# ------------------------------------------------------------------ Tensor

class Tensor(torch.Tensor):
    """``paddle.Tensor`` on a ``torch.Tensor``."""

    @classmethod
    def __torch_function__(cls, func, types_, args=(), kwargs=None):
        TORCH_FUNCTION_ENTRIES[0] += 1
        if kwargs is None:
            kwargs = {}
        if isinstance(func, types.FunctionType):
            if func in _KEEP_SELF:
                _ST.depth += 1
                try:
                    with _DISABLE():
                        out = func(*args, **kwargs)
                finally:
                    _ST.depth -= 1
                return out
            plain = [a for a in args if isinstance(a, Tensor)]
            with _DISABLE():
                out = func(*unwrap(args), **unwrap(kwargs))
            for a in plain:             # an in-place body returns its input
                if out is a:
                    return a
            return wrap(out)
        with _DISABLE():
            out = func(*args, **kwargs)
        return wrap(out)

    # ---- metadata ----
    @property
    def shape(self):
        if _ST.depth:
            return torch.Tensor.shape.__get__(self)
        return Shape(torch.Tensor.shape.__get__(self))

    @property
    def size(self):
        s = Size(self.numel())
        s.shape = torch.Tensor.shape.__get__(self)
        return s

    @property
    def place(self) -> str:
        """``"cpu:0"`` or ``"gpu:N"``, as the reference names a place."""
        dev = self.device
        return "cpu:0" if dev.type == "cpu" else f"gpu:{dev.index or 0}"

    @property
    def rank(self) -> int:
        return self.ndim

    @property
    def T(self):
        if _ST.depth:
            return torch.Tensor.T.__get__(self)
        return self.permute(*range(self.ndim - 1, -1, -1))

    @property
    def is_dist(self) -> bool:
        return False

    @property
    def name(self) -> str:
        n = self.__dict__.get("_name")
        if n is None:
            n = self.__dict__["_name"] = f"generated_tensor_{next(_names)}"
        return n

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def persistable(self) -> bool:
        return self.__dict__.get("_persistable", False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_persistable"] = bool(value)

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        if self.is_leaf or not value:
            self.requires_grad_(not value)
        # a non-leaf keeps its graph (torch cannot drop it in place)

    @property
    def trainable(self) -> bool:
        return self.__dict__.get("_trainable", self.requires_grad)

    @trainable.setter
    def trainable(self, value):
        self.__dict__["_trainable"] = bool(value)

    @property
    def grad(self):
        """The gradient as a :class:`Tensor`: a plain gradient autograd
        wrote is stored back as one, so every read returns one object.  A
        row-sparse gradient (``Embedding(sparse=True)``) reads as a
        coalesced ``SelectedRowsTensor``."""
        with _DISABLE():
            g = torch.Tensor.grad.__get__(self)
            if g is not None and g.layout is torch.sparse_coo:
                from .selected_rows import from_torch
                return from_torch(g)
            if g is None or type(g) is not torch.Tensor:
                return g
            g = g.as_subclass(Tensor)
            torch.Tensor.grad.__set__(self, g)
        return g

    @grad.setter
    def grad(self, value):
        if type(value) is torch.Tensor:
            value = value.as_subclass(Tensor)
        with _DISABLE():
            torch.Tensor.grad.__set__(self, value)

    # ---- conversion ----
    def numpy(self):
        """A numpy copy (one marked sync from the card; bfloat16 and
        float16 come back as float32 and float16 numpy arrays)."""
        t = self.detach()
        if t.device.type != "cpu":
            from ..observability import count_sync
            count_sync()
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return torch.Tensor.numpy(t)

    def astype(self, dtype):
        from ..ops.manipulation import cast
        return cast(self, dtype)

    cast = astype

    def element_size(self) -> int:
        return torch.Tensor.element_size(self)

    def is_selected_rows(self) -> bool:
        return False

    def _to(self, *args, **kwargs):
        """``to(dtype)`` / ``to(place)`` with Paddle's names too."""
        conv = []
        for a in args:
            if isinstance(a, str) and a in dtypes._ALIASES:
                a = dtypes.convert_dtype(a)
            elif isinstance(a, str) and a.startswith("gpu"):
                a = a.replace("gpu", "cuda")
            elif isinstance(a, np.dtype):
                a = dtypes.convert_dtype(a)
            conv.append(a)
        if "dtype" in kwargs:
            kwargs["dtype"] = dtypes.convert_dtype(kwargs["dtype"])
        kwargs.pop("blocking", None)
        return torch.Tensor.to(self, *conv, **kwargs)

    def _pin_memory(self):
        return torch.Tensor.pin_memory(self) if torch.cuda.is_available() \
            else self

    # ---- autograd ----
    def _backward(self, grad_tensor=None, retain_graph=False):
        """Seeds with ones when no ``grad_tensor`` is given, for any
        shape (the reference's ``run_backward``)."""
        if grad_tensor is None and self.numel() != 1:
            grad_tensor = torch.ones_like(self)
        torch.autograd.backward(_to_plain(self),
                                None if grad_tensor is None
                                else _to_plain(grad_tensor),
                                retain_graph=retain_graph)

    def _register_hook(self, hook):
        """``hook(grad)`` sees the gradient as a :class:`Tensor`; a result
        replaces it."""
        def h(g):
            out = hook(wrap(g))
            return None if out is None else _to_plain(out)
        torch.Tensor.register_hook(self, h)
        return hook

    def retain_grads(self):
        self.retain_grad()

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    # ---- mutation (in place, with the reference's copy semantics) ----
    def set_value(self, value):
        """Copy ``value`` (a tensor, array or number) into this tensor, cast
        to its dtype and reshaped to its shape; not recorded by autograd."""
        with torch.no_grad():
            src = value.detach() if torch.is_tensor(value) else \
                torch.as_tensor(np.asarray(value))
            torch.Tensor.copy_(
                self, _to_plain(src).to(device=self.device,
                                        dtype=self.dtype).reshape(
                    tuple(torch.Tensor.shape.__get__(self))))
        return self

    def _copy_(self, other, blocking=True):
        return self.set_value(other)

    def _fill_(self, value):
        with torch.no_grad():
            torch.Tensor.fill_(self, value)
        return self

    def _zero_(self):
        return self._fill_(0)

    def scale_(self, scale):
        with torch.no_grad():
            torch.Tensor.mul_(self, scale)
        return self

    # ---- python protocol ----
    def _len(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return torch.Tensor.shape.__get__(self)[0]

    def __repr__(self, *, tensor_contents=None):
        if _ST.depth:
            return torch.Tensor.__repr__(self)
        grad = "" if self.stop_gradient else ", stop_gradient=False"
        dt = str(self.dtype).replace("torch.", "")
        with _DISABLE():
            data = self.detach().cpu()
            body = np.asarray(data.float() if data.dtype == torch.bfloat16
                              else data)
        return (f"Tensor(shape={list(self.shape)}, dtype={dt}{grad},\n"
                f"       {body})")

    __hash__ = torch.Tensor.__hash__

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        with torch.no_grad(), _DISABLE():
            data = torch.Tensor.clone(self)
        out = torch.Tensor._make_subclass(type(self), data,
                                          self.requires_grad)
        memo[id(self)] = out
        for k, v in self.__dict__.items():
            setattr(out, k, copy.deepcopy(v, memo))
        return out


for _n, _f in (("to", Tensor._to), ("pin_memory", Tensor._pin_memory),
               ("backward", Tensor._backward),
               ("register_hook", Tensor._register_hook),
               ("copy_", Tensor._copy_), ("fill_", Tensor._fill_),
               ("zero_", Tensor._zero_), ("__len__", Tensor._len)):
    setattr(Tensor, _n, dual(_n, _f))


class Parameter(Tensor, torch.nn.Parameter):
    """A trainable tensor with the reference's attributes: ``name``,
    ``optimize_attr`` (its learning-rate scale), ``regularizer``,
    ``need_clip``, and ``stop_gradient`` / ``trainable`` over
    ``requires_grad``.  A :class:`Tensor` and a ``torch.nn.Parameter``."""

    def __new__(cls, data, trainable=True, name=None):
        if isinstance(data, Tensor):
            data = data.as_subclass(torch.Tensor)
        p = torch.Tensor._make_subclass(cls, data.detach(), bool(trainable))
        p.name = name if name is not None else \
            f"generated_tensor_{next(_names)}"
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.do_model_average = None
        p.need_clip = True
        p.is_distributed = False
        p.persistable = True
        return p

    def __init__(self, data, trainable=True, name=None):
        pass

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        with torch.no_grad(), _DISABLE():
            data = torch.Tensor.clone(self,
                                      memory_format=torch.preserve_format)
        p = type(self)(data, self.requires_grad, self.name)
        memo[id(self)] = p
        for k, v in self.__dict__.items():
            setattr(p, k, copy.deepcopy(v, memo))
        return p

    def __reduce_ex__(self, proto):
        return (_rebuild_parameter,
                (torch.Tensor.detach(self).as_subclass(torch.Tensor),
                 self.requires_grad, dict(self.__dict__)))

    def __repr__(self):
        return f"Parameter({self.name}, shape={list(self.shape)}, " \
               f"dtype={self.dtype}, stop_gradient={self.stop_gradient})"


def _rebuild_parameter(data, requires_grad, state):
    p = Parameter(data, requires_grad)
    p.__dict__.update(state)
    return p


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``data`` (a number, list, numpy array or tensor) as a :class:`Tensor`
    on ``place`` (default: the device ``set_device`` chose), with
    ``requires_grad = not stop_gradient`` (a leaf).  float64 data with no
    ``dtype`` takes the default float dtype, as in the reference."""
    from ..device import _place, current
    dev = current() if place is None else _place(place).torch_device()
    if torch.is_tensor(data):
        t = _to_plain(data).detach()
    else:
        if isinstance(data, (list, tuple)) and \
                any(torch.is_tensor(v) for v in data):
            data = [v.detach().cpu().numpy() if torch.is_tensor(v) else v
                    for v in data]
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
            dtype = dtypes.get_default_dtype()
        t = torch.as_tensor(arr)
    with _DISABLE():
        t = t.to(device=dev, dtype=None if dtype is None else
                 dtypes.convert_dtype(dtype), copy=True)
    return torch.Tensor._make_subclass(Tensor, t, not stop_gradient)


def is_tensor(x) -> bool:
    return torch.is_tensor(x)
