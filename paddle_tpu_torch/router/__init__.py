"""Multi-replica serving router of the port (port of ``paddle_tpu/router``):
prefix-aware, session-affine placement over N ``ServingServer`` replicas
with aggregated SLO shedding, journaled failover resume, poison quarantine
and the disaggregated prefill->decode handoff.  Stdlib asyncio, like
``paddle_tpu_torch/serving``.

Quickstart (N replica processes, one router)::

    python -m paddle_tpu_torch.serving --port 8001
    python -m paddle_tpu_torch.serving --port 8002
    python -m paddle_tpu_torch.router --replica 127.0.0.1:8001 \\
                                      --replica 127.0.0.1:8002 --port 8080

In-process fleets (tests) wrap started ``ServingServer`` instances in
``InprocReplica`` handles instead: the same code path minus the sockets.

Placement lives in ``router.placement``, transports in ``router.replica``,
the process in ``router.server``.
"""

from . import placement, quarantine, replica
from .placement import Placer, ReplicaState
from .quarantine import PoisonQuarantine
from .replica import HttpReplica, InprocReplica, ReplicaClient
from .server import RouterServer, route_forever

__all__ = ["RouterServer", "route_forever", "ReplicaClient",
           "InprocReplica", "HttpReplica", "Placer", "ReplicaState",
           "PoisonQuarantine", "placement", "quarantine", "replica"]
