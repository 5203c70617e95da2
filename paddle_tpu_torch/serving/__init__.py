"""Serving front door of the port: a stdlib asyncio HTTP process over the
continuous-batching engine (OpenAI-shaped streaming ``/v1/completions``,
``/healthz``, ``/readyz``, ``/metrics``, ``/statusz``, ``/drainz`` and the
``/migratez`` session-transfer endpoints), with SLO shedding
(``slo.SLOController``), graceful drain and the flight recorder.

Quickstart::

    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.serving import serve_forever
    serve_forever(ContinuousBatchingEngine(model, ...), port=8000)
"""

from . import http
from .server import ServingServer, serve_forever
from .slo import SLOController

__all__ = ["ServingServer", "SLOController", "serve_forever", "http"]
