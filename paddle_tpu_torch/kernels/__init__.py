"""The port's kernels.  Each module keeps its plain PyTorch version beside
the wrapper of its hand-written Hopper kernel (sources under ``csrc/``,
built by ``_build`` at first use)."""

import contextlib

import torch


def on_device(dev: torch.device):
    """The context a kernel launch on ``dev`` runs in: ``dev`` made the
    current CUDA device where it is not already.  A launch takes a stream
    of the current device, and the sources set function attributes on it,
    so a tensor-parallel shard on another card launches under this."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
