"""The port of ``paddle_tpu.incubate``: so far ``nn``'s fused layers."""

from . import nn  # noqa: F401
