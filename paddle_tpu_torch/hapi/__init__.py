"""``paddle.hapi`` (the port of ``paddle_tpu/hapi/``): ``Model``, its
callbacks, ``summary`` and ``flops``."""

from .callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
)
from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401
