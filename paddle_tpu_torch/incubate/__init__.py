"""The port of ``paddle_tpu.incubate``: ``nn``'s fused layers and functional
ops, ``distributed.models.moe``, and ``optimizer`` (``LookAhead``,
``ModelAverage``)."""

from . import distributed, nn, optimizer  # noqa: F401


def autograd_enabled():
    """True: the dygraph autograd is always on (torch's)."""
    return True
