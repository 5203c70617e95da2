"""The port of ``paddle_tpu.device``: where the Paddle-API path puts its
tensors.

``set_device`` picks the device that layers, ``to_tensor`` and the creation
ops place their tensors on (the reference's ``paddle_tpu/device/__init__.py``
:80).  Until it is called that device is the card: :func:`current` resolves
``"cuda"`` through :func:`paddle_tpu_torch.resolve_device`, which raises
without a GPU.  Nothing falls back to the CPU on its own; the tests ask for
it with ``set_device("cpu")``.

The rest of the reference's ``device`` (:1-266): the place classes
(``TPUPlace`` and ``XPUPlace`` name the card here, as the reference's
``CUDAPlace`` names its accelerator), ``Stream`` / ``Event`` /
``current_stream`` over ``torch.cuda``'s, the device lists, the ``cuda`` /
``tpu`` memory namespaces over torch's caching allocator, and
``memory_debug``'s tools.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import resolve_device

__all__ = ["set_device", "get_device", "device_count", "synchronize",
           "current", "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "CustomPlace", "TPUPlace", "XPUPlace", "get_all_custom_device_type",
           "get_available_device", "get_available_custom_device", "Event",
           "Stream", "current_stream", "cuda", "tpu", "memory_analysis",
           "donation_audit", "live_arrays_report"]


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


class CUDAPinnedPlace(Place):
    """Page-locked host memory: a CPU place (``pin_memory`` tensors)."""

    def __init__(self):
        super().__init__("cpu", 0)


class TPUPlace(Place):
    """The reference's accelerator place: card ``device_id`` here."""

    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


class XPUPlace(TPUPlace):
    pass


class CustomPlace(Place):
    pass


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


def get_all_custom_device_type() -> List[str]:
    """The accelerator types present: ``["gpu"]`` with a card, else
    ``[]``."""
    return ["gpu"] if torch.cuda.is_available() else []


def get_available_device() -> List[str]:
    """Every card as ``"gpu:N"``; ``["cpu"]`` without one."""
    n = torch.cuda.device_count()
    return [f"gpu:{i}" for i in range(n)] if n else ["cpu"]


get_available_custom_device = get_available_device


def _device(device) -> torch.device:
    return current() if device is None else _place(device).torch_device()


class Stream:
    """A CUDA stream (``torch.cuda.Stream``) on the card ``device`` names
    (default: the current device).  ``priority`` 1 is torch's high
    priority, else the default.  On the CPU, where work runs in order as
    it is issued, the methods order nothing and events take the host
    clock."""

    def __init__(self, device=None, priority=2, _stream=None):
        self.device = _device(device)
        if _stream is not None:
            self._stream = _stream
        elif self.device.type == "cuda":
            self._stream = torch.cuda.Stream(
                self.device, priority=-1 if priority == 1 else 0)
        else:
            self._stream = None

    def synchronize(self):
        if self._stream is not None:
            self._stream.synchronize()

    def query(self) -> bool:
        return True if self._stream is None else self._stream.query()

    def wait_event(self, event):
        if self._stream is not None:
            self._stream.wait_event(event._event)

    def wait_stream(self, stream):
        if self._stream is not None:
            self._stream.wait_stream(stream._stream)

    def record_event(self, event=None):
        ev = event or Event(enable_timing=True)
        ev.record(self)
        return ev


class Event:
    """A CUDA event (``torch.cuda.Event``): ``record`` on a stream,
    ``elapsed_time`` between two recorded events in milliseconds (a marked
    sync: it waits for the end event).  Recorded on a CPU stream it takes
    the host clock."""

    def __init__(self, enable_timing=True, blocking=False,
                 interprocess=False):
        self._args = (enable_timing, blocking, interprocess)
        self._event = None
        self._t = None

    def record(self, stream=None):
        stream = stream or current_stream()
        if stream._stream is None:
            import time
            self._t = time.perf_counter()
            return
        if self._event is None:
            timing, blocking, interprocess = self._args
            self._event = torch.cuda.Event(enable_timing=timing,
                                           blocking=blocking,
                                           interprocess=interprocess)
        self._event.record(stream._stream)

    def query(self) -> bool:
        return True if self._event is None else self._event.query()

    def synchronize(self):
        if self._event is not None:
            self._event.synchronize()

    def elapsed_time(self, end_event: "Event") -> float:
        """Milliseconds from this event's record to ``end_event``'s."""
        if self._event is not None and end_event._event is not None:
            from ..observability import count_sync
            count_sync()
            end_event._event.synchronize()
            return self._event.elapsed_time(end_event._event)
        if self._t is None or end_event._t is None:
            raise RuntimeError(
                "elapsed_time requires both events to be recorded")
        return (end_event._t - self._t) * 1e3


def current_stream(device=None) -> Stream:
    """The stream work is issued on (``torch.cuda.current_stream``)."""
    dev = _device(device)
    return Stream(dev, _stream=torch.cuda.current_stream(dev)
                  if dev.type == "cuda" else None)


_SUMMARY_KEYS = (("bytes_in_use", "allocated_bytes.all.current"),
                 ("peak_bytes_in_use", "allocated_bytes.all.peak"),
                 ("bytes_reserved", "reserved_bytes.all.current"),
                 ("peak_bytes_reserved", "reserved_bytes.all.peak"),
                 ("num_allocs", "allocation.all.allocated"))


class _MemNamespace:
    """``paddle.device.cuda``'s memory counters, read from torch's caching
    allocator on the card (the reference reads PJRT's ``memory_stats``);
    0 without a card, as the reference's where a backend has no stats."""

    @staticmethod
    def _card(device):
        """The card ``device`` names (an index, a place or a name; default
        the current card), or None for the CPU and without a card."""
        if not torch.cuda.is_available():
            return None
        if device is None:
            return torch.device("cuda", torch.cuda.current_device())
        if isinstance(device, int):
            return torch.device("cuda", device)
        dev = _place(device).torch_device()
        return dev if dev.type == "cuda" else None

    @classmethod
    def max_memory_allocated(cls, device=None):
        dev = cls._card(device)
        return torch.cuda.max_memory_allocated(dev) if dev else 0

    @classmethod
    def memory_allocated(cls, device=None):
        dev = cls._card(device)
        return torch.cuda.memory_allocated(dev) if dev else 0

    @classmethod
    def max_memory_reserved(cls, device=None):
        dev = cls._card(device)
        return torch.cuda.max_memory_reserved(dev) if dev else 0

    @classmethod
    def memory_reserved(cls, device=None):
        dev = cls._card(device)
        return torch.cuda.memory_reserved(dev) if dev else 0

    @staticmethod
    def empty_cache():
        """Return the allocator's cached, unused blocks to the driver."""
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    @classmethod
    def memory_summary(cls, device=None):
        """The allocator's state as the reference's table."""
        dev = cls._card(device)
        if dev is None:
            return "memory stats unavailable on this backend"
        stats = torch.cuda.memory_stats(dev)
        stats["bytes_limit"] = torch.cuda.get_device_properties(
            dev).total_memory
        gib = 1024 ** 3
        lines = ["| allocator stat            |        value |"]
        for key, src in _SUMMARY_KEYS + (("bytes_limit", "bytes_limit"),):
            if src in stats:
                v = int(stats[src])
                shown = f"{v / gib:10.3f} GiB" if "bytes" in key \
                    else f"{v:14d}"
                lines.append(f"| {key:25} | {shown:>12} |")
        return "\n".join(lines)

    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def synchronize(device=None):
        synchronize(device)


cuda = _MemNamespace()
tpu = _MemNamespace()

from . import memory_debug  # noqa: E402,F401
from .memory_debug import (donation_audit, live_arrays_report,  # noqa: E402
                           memory_analysis)
