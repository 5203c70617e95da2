"""``paddle.summary`` and ``paddle.flops`` (the port of
``paddle_tpu/hapi/summary.py``): one forward of zeros through the network
with forward post-hooks on its layers."""

from __future__ import annotations

import numpy as np
import torch


def _zeros(shape, dtype):
    from .. import dtypes
    from ..device import current
    return torch.zeros(tuple(shape), dtype=dtypes.convert_dtype(
        dtype or "float32"), device=current())


def _trainable(p) -> bool:
    return bool(getattr(p, "trainable", p.requires_grad))


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a row a layer (its output shape and parameter count); returns
    ``{'total_params', 'trainable_params'}``."""
    rows = []
    hooks = []

    def register(layer, name):
        def hook(m, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            shape = list(out.shape) if torch.is_tensor(out) else "?"
            n_params = sum(p.numel() for p in m._parameters.values()
                           if p is not None)
            rows.append((name or m.__class__.__name__, shape, n_params))
        hooks.append(layer.register_forward_post_hook(hook))

    for name, sub in net.named_sublayers():
        register(sub, f"{sub.__class__.__name__}-{name}")

    if input is not None:
        x = input
    else:
        if input_size is None:
            raise ValueError("either input or input_size is required")
        sizes = input_size if isinstance(input_size, list) and \
            isinstance(input_size[0], (list, tuple)) else [input_size]
        dts = dtypes if isinstance(dtypes, (list, tuple)) \
            else [dtypes] * len(sizes)
        xs = [_zeros([1 if d is None or d == -1 else d for d in sz], dt)
              for sz, dt in zip(sizes, dts)]
        x = xs if len(xs) > 1 else xs[0]

    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*x) if isinstance(x, list) else net(x)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if _trainable(p))

    w = max([len(r[0]) for r in rows] + [20])
    print(f"{'Layer (type)':<{w}} {'Output Shape':<24} {'Param #':>12}")
    print("=" * (w + 38))
    for name, shape, n in rows:
        print(f"{name:<{w}} {str(shape):<24} {n:>12,}")
    print("=" * (w + 38))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    return {"total_params": total, "trainable_params": trainable}


def _classes(nn, *names):
    return tuple(c for c in (getattr(nn, n, None) for n in names) if c)


def flops(net, input_size, custom_ops=None, print_detail=False):
    """FLOPs of one forward pass, counted by forward hooks on the leaf
    layers: a multiply-accumulate is 2 FLOPs in convolutions and linears,
    norms count 2 an output element, activations and average pools 1."""
    from .. import nn

    custom_ops = custom_ops or {}
    counts = []
    handles = []
    conv_types = _classes(nn, "Conv1D", "Conv2D", "Conv3D")
    norm_types = _classes(nn, "BatchNorm", "BatchNorm1D", "BatchNorm2D",
                          "BatchNorm3D", "LayerNorm", "GroupNorm")
    act_types = _classes(nn, "ReLU", "GELU", "Sigmoid", "Tanh", "SiLU",
                         "Hardswish", "Softmax")
    pool_types = _classes(nn, "AvgPool1D", "AvgPool2D", "AdaptiveAvgPool2D")

    def count(layer, inputs, output):
        x = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
        if not torch.is_tensor(x) or not torch.is_tensor(output):
            return
        n_out = int(np.prod(output.shape))
        fl = 0
        if type(layer) in custom_ops:
            fl = custom_ops[type(layer)](layer, x, output)
        elif isinstance(layer, conv_types):
            k = int(np.prod(layer._kernel_size))
            cin = layer._in_channels // layer._groups
            fl = 2 * n_out * cin * k
        elif isinstance(layer, nn.Linear):
            fl = 2 * n_out * int(layer.weight.shape[0])
        elif isinstance(layer, norm_types):
            fl = 2 * n_out
        elif isinstance(layer, act_types + pool_types):
            fl = n_out
        if fl:
            counts.append((layer.full_name() if hasattr(layer, "full_name")
                           else type(layer).__name__, fl))

    leaves = [m for m in net.sublayers(include_self=True)
              if not list(m.children())] if hasattr(net, "sublayers") else []
    if not leaves:
        leaves = [net]
    for m in leaves:
        handles.append(m.register_forward_post_hook(count))
    try:
        x = _zeros(input_size, "float32")
        was_training = net.training
        net.eval()
        with torch.no_grad():
            net(x)
        if was_training:
            net.train()
    finally:
        for h in handles:
            h.remove()
    total = sum(f for _, f in counts)
    if print_detail:
        for name, f in counts:
            print(f"{name:40s} {f:>15,d}")
        print(f"{'Total':40s} {total:>15,d}")
    return total
