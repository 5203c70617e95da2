"""The port of ``paddle_tpu.device``: where the Paddle-API path puts its
tensors.

``set_device`` picks the device that layers, ``to_tensor`` and the creation
ops place their tensors on (the reference's ``paddle_tpu/device/__init__.py``
:80).  Until it is called that device is the card: :func:`current` resolves
``"cuda"`` through :func:`paddle_tpu_torch.resolve_device`, which raises
without a GPU.  Nothing falls back to the CPU on its own; the tests ask for
it with ``set_device("cpu")``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import resolve_device

__all__ = ["set_device", "get_device", "device_count", "synchronize",
           "current", "Place", "CPUPlace", "CUDAPlace"]


class Place:
    """Device identity (``phi::Place``): a type and an index."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place) and
                self.device_type == other.device_type and
                self.device_id == other.device_id)

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device(f"cuda:{self.device_id}")


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


_current: List[Optional[Place]] = [None]


def _place(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        device = str(device)
    kind, _, idx = str(device).partition(":")
    if kind == "cpu":
        return CPUPlace()
    if kind in ("gpu", "cuda"):
        return CUDAPlace(int(idx) if idx else 0)
    raise ValueError(f"unsupported device {device!r}: expected 'cpu', "
                     f"'gpu', 'gpu:N', 'cuda' or 'cuda:N'")


def set_device(device) -> Place:
    """Make ``device`` (``"cpu"``, ``"gpu"``, ``"gpu:N"``, ``"cuda:N"`` or a
    :class:`Place`) the device of new tensors; a GPU asked for without one
    raises here."""
    place = _place(device)
    place.torch_device()
    _current[0] = place
    return place


def current() -> torch.device:
    """The ``torch.device`` new tensors go to: the one ``set_device`` chose,
    else the card (raises without a GPU)."""
    if _current[0] is None:
        return resolve_device(None)
    return _current[0].torch_device()


def get_device() -> str:
    """``"cpu"`` or ``"gpu:N"``, as the reference names them."""
    dev = current()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def device_count() -> int:
    return torch.cuda.device_count()


def synchronize(device=None) -> None:
    """Wait for the work queued on a card (nothing to wait for on the
    CPU)."""
    dev = current() if device is None else _place(device).torch_device()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
