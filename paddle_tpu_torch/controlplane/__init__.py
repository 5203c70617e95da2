"""The multi-router control plane of the port (port of
``paddle_tpu/controlplane``).

The router fleet's coordination layer: a TCPStore-shaped membership and
state store (``store.py``), a consistent-hash ring mapping ``X-Session-Id``
to its owning router (``ring.py``), the per-router facade that ties both to
``RouterServer`` (``plane.py``), the supervisor's router slots
(``slots.py``), and the counting-Bloom digest sketch that keeps a replica's
digest bytes flat as its prefix cache grows (``sketch.py``).

Host code only (stdlib asyncio): the store speaks newline-delimited JSON
over one socket, the ring is a sorted blake2b keyspace, and in-process
fleets run the same paths through ``LocalStore`` with no sockets.
"""

from . import sketch
from .ring import HashRing
from .sketch import BloomView, CountingBloom, fp_rate
from .store import (LocalStore, StoreClient, StoreServer, StoreState,
                    SyncStoreClient)
from .plane import RouterControlPlane
from .slots import InprocRouterHandle, ProcessRouterHandle, RouterHandle

__all__ = [
    "RouterHandle",
    "InprocRouterHandle",
    "ProcessRouterHandle",
    "HashRing",
    "BloomView",
    "CountingBloom",
    "fp_rate",
    "LocalStore",
    "StoreClient",
    "StoreServer",
    "StoreState",
    "SyncStoreClient",
    "RouterControlPlane",
]
