"""Fleet lifecycle supervisor of the port (port of ``paddle_tpu/fleet``):
sentinel-driven autoscaling, graceful drain with session migration, crash
restart with backoff, role-specialized (prefill/decode) fleets, the cascade
breaker and a deterministic chaos harness.  Stdlib only, like
``serving/`` and ``router/``.

Quickstart (supervisor + router + N replica processes in one command)::

    python -m paddle_tpu_torch.fleet --replicas 2 --port 8080

In-process fleets (tests) hand the supervisor an ``InprocReplicaHandle``
spawner over shared model weights instead: the same control loop minus
the sockets.
"""

from . import breaker, chaos, supervisor
from .breaker import CascadeBreaker
from .chaos import ChaosController, ChaosPlan, FaultEvent
from .supervisor import (FleetSupervisor, InprocReplicaHandle,
                         ProcessReplicaHandle, ReplicaHandle)

__all__ = ["FleetSupervisor", "ReplicaHandle", "InprocReplicaHandle",
           "ProcessReplicaHandle", "ChaosPlan", "ChaosController",
           "FaultEvent", "CascadeBreaker", "supervisor", "chaos",
           "breaker"]
