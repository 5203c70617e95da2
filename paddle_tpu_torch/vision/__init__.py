"""The port of ``paddle_tpu.vision``: so far ``models`` (the ResNet
family)."""

from . import models  # noqa: F401
