"""The port of ``paddle_tpu.incubate.distributed``: so far ``models.moe``."""

from . import models  # noqa: F401
