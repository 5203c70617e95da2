"""``nn.Layer`` over ``torch.nn.Module`` (the port of
``paddle_tpu/nn/layer.py``).

A :class:`Layer` is a ``torch.nn.Module`` with the reference's API:
``create_parameter`` / ``ParamAttr``, ``add_parameter`` / ``add_sublayer``,
``register_buffer(..., persistable=)``, list-returning ``parameters()`` and
``sublayers()``, ``state_dict()`` / ``set_state_dict()`` under the
reference's names, ``to(device=, dtype=)``, ``apply`` in the reference's
order, forward pre/post hooks and ``clear_gradients``.  Parameters and
buffers are made on the device ``set_device`` chose.  A reference
``state_dict()`` given as numpy arrays loads into the same layer of the
port with no renaming, parameters and persistable buffers alike.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterator, Tuple

import numpy as np
import torch

from .. import dtypes
from ..core.tensor import Parameter, boundary
from ..device import _place, current
from . import initializer as I


class ParamAttr:
    """Parameter attribute bundle (``paddle.ParamAttr``)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtypes.convert_dtype(dtype)
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # ---- construction helpers ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Parameter:
        """A parameter of ``shape`` on the current device, drawn by
        ``attr``'s initializer, else ``default_initializer``, else
        ``Constant(0)`` for a bias and ``XavierNormal`` otherwise."""
        if attr is False:
            raise ValueError("attr=False means no parameter; caller should "
                             "skip creation")
        dtype = dtypes.convert_dtype(dtype or self._dtype)
        if default_initializer is None:
            default_initializer = I.Constant(0.0) if is_bias else \
                I.XavierNormal()
        init = I._resolve(attr, default_initializer)
        trainable, name = True, None
        if isinstance(attr, ParamAttr):
            trainable, name = attr.trainable, attr.name
        with torch.no_grad():
            data = init(list(shape), dtype)
        p = Parameter(data, trainable=trainable, name=name)
        if isinstance(attr, ParamAttr):
            p.optimize_attr["learning_rate"] = attr.learning_rate
            p.regularizer = attr.regularizer
            p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent=None):
        """A buffer; ``persistable=False`` keeps it out of ``state_dict``."""
        if persistent is not None:
            persistable = persistent
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    # ---- iteration (lists, as the reference returns) ----
    def parameters(self, include_sublayers=True, recurse=None):
        recurse = include_sublayers if recurse is None else recurse
        return [p for _, p in self.named_parameters(recurse=recurse)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True
                         ) -> Iterator[Tuple[str, Parameter]]:
        recurse = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=recurse,
                                        remove_duplicate=remove_duplicate)

    def named_sublayers(self, prefix="", include_self=False):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [layer for _, layer in
                self.named_sublayers(include_self=include_self)]

    def children(self):
        return list(super().children())

    def named_children(self):
        return list(super().named_children())

    def buffers(self, include_sublayers=True, recurse=None):
        recurse = include_sublayers if recurse is None else recurse
        return [b for _, b in self.named_buffers(recurse=recurse)]

    def apply(self, fn):
        """``fn`` on this layer, then on every sublayer (pre-order, as the
        reference walks)."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # ---- state dict ----
    def _state_items(self, prefix=""):
        """(name, tensor) of every parameter, then every persistable
        buffer: the reference's ``state_dict`` order."""
        yield from self.named_parameters(prefix=prefix)
        for mname, layer in self.named_modules(prefix=prefix):
            for bname, b in layer._buffers.items():
                if b is not None and \
                        bname not in layer._non_persistent_buffers_set:
                    yield (f"{mname}.{bname}" if mname else bname), b

    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=False):
        """Parameters and persistable buffers under the reference's names
        (detached, sharing storage)."""
        dest = destination if destination is not None else OrderedDict()
        pre = (structured_name_prefix if prefix is None else prefix)
        for name, t in self._state_items(pre.rstrip(".")):
            dest[name] = t if keep_vars else t.detach()
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors or numpy arrays) into the
        parameters and buffers of the same names, cast to their dtypes.
        Returns ``(missing, unexpected)`` names."""
        own = dict(self._state_items())
        unexpected = []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            t = own[k]
            src = v.detach() if torch.is_tensor(v) else \
                torch.tensor(np.asarray(v))
            t.copy_(src.to(device=t.device, dtype=t.dtype).reshape(t.shape))
        missing = [k for k in own if k not in state_dict]
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ---- dtype / device movement ----
    def to(self, *args, device=None, dtype=None, blocking=None, **kwargs):
        """Move to ``device`` (a Paddle name, ``torch.device`` or Place)
        and/or cast floating parameters and buffers to ``dtype``."""
        for a in args:
            if isinstance(a, torch.dtype) or (isinstance(a, str) and
                                              a in dtypes._ALIASES):
                dtype = a
            else:
                device = a
        kw = {}
        if device is not None:
            kw["device"] = _place(device).torch_device()
        if dtype is not None:
            self._set_dtype(dtypes.convert_dtype(dtype))
            kw["dtype"] = dtypes.convert_dtype(dtype)
        return super().to(**kw, **kwargs) if kw or kwargs else self

    def _set_dtype(self, dtype):
        for layer in self.sublayers(include_self=True):
            if isinstance(layer, Layer):
                layer._dtype = dtype

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype="float32")

    def bfloat16(self):
        return self.to(dtype="bfloat16")

    def half(self):
        return self.to(dtype="float16")

    # ---- hooks ----
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a result other than None
        replaces the outputs (``register_forward_pre_hook`` is torch's:
        ``hook(layer, inputs)``, a result replaces the inputs).  Returns a
        handle with ``remove()``."""
        return self.register_forward_hook(hook)

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    @boundary
    def __call__(self, *inputs, **kwargs):
        """torch's module call as a Paddle-API entry: the forward runs on
        plain tensors (parameters answer as torch's), the outputs come
        back as ``Tensor``."""
        return torch.nn.Module.__call__(self, *inputs, **kwargs)

    def clear_gradients(self, set_to_zero=True):
        from ..amp import drop_grad
        for p in self.parameters():
            drop_grad(p)

    def full_name(self):
        return self._name_scope


class Sequential(Layer):
    """Sublayers called in order; built from layers, ``(name, layer)``
    pairs, or one list of pairs."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self.add_sublayer(str(i), layer)

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return self._modules[str(idx % len(self) if idx < 0 else idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def append(self, parameter):
        self.add_parameter(str(len(self._parameters)), parameter)
        return self

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

