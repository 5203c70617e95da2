"""The port of ``paddle_tpu.nn``: so far only the attention ops of
:mod:`paddle_tpu_torch.nn.functional`.  The layers (``nn.Layer``,
``MultiHeadAttention`` and the rest) are not ported yet."""

from . import functional

__all__ = ["functional"]
