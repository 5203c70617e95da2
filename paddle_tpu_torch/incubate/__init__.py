"""The port of ``paddle_tpu.incubate``: ``nn``'s fused layers and functional
ops, and ``distributed.models.moe``."""

from . import distributed, nn  # noqa: F401
