"""Tensors of the Paddle-API path (the port of ``paddle_tpu/core/tensor.py``).

The reference wraps ``jax.Array`` in its own ``Tensor`` with a tape of its
own; here a tensor is a ``torch.Tensor`` and autograd is PyTorch's
(``stop_gradient`` is ``not requires_grad``).  :class:`Parameter` is a
``torch.nn.Parameter`` that carries the reference's attributes.
"""

from __future__ import annotations

import copy
import itertools

import numpy as np
import torch

from .. import dtypes

_names = itertools.count(1)


class Parameter(torch.nn.Parameter):
    """A trainable tensor with the reference's attributes: ``name``,
    ``optimize_attr`` (its learning-rate scale), ``regularizer``,
    ``need_clip``, and ``stop_gradient`` / ``trainable`` over
    ``requires_grad``."""

    def __new__(cls, data, trainable=True, name=None):
        p = super().__new__(cls, data, requires_grad=bool(trainable))
        p._name = name if name is not None else \
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
    def name(self) -> str:
        return self._name

    @name.setter
    def name(self, value: str):
        self._name = value

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        self.requires_grad_(not value)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool):
        self.requires_grad_(bool(value))

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        p = type(self)(self.data.clone(memory_format=torch.preserve_format),
                       self.requires_grad, self.name)
        memo[id(self)] = p
        for k, v in self.__dict__.items():
            setattr(p, k, copy.deepcopy(v, memo))
        return p

    def __repr__(self):
        return f"Parameter({self.name}, shape={list(self.shape)}, " \
               f"dtype={self.dtype}, stop_gradient={self.stop_gradient})"


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``data`` (a number, list, numpy array or tensor) as a tensor on
    ``place`` (default: the device ``set_device`` chose), with
    ``requires_grad = not stop_gradient``.  float64 data with no ``dtype``
    takes the default float dtype, as in the reference."""
    from ..device import _place, current
    dev = current() if place is None else _place(place).torch_device()
    if torch.is_tensor(data):
        t = data.detach()
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
            dtype = dtypes.get_default_dtype()
        t = torch.as_tensor(arr)
    t = t.to(device=dev, dtype=None if dtype is None else
             dtypes.convert_dtype(dtype), copy=True)
    return t.requires_grad_(not stop_gradient)


def is_tensor(x) -> bool:
    return torch.is_tensor(x)
