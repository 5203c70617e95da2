"""``paddle.framework`` (the port of ``paddle_tpu/framework/__init__.py``):
``save`` / ``load``, the default dtype and the seed."""

from . import io  # noqa: F401
from .io import load, save  # noqa: F401

from ..core.random import seed  # noqa: F401
from ..dtypes import get_default_dtype, set_default_dtype  # noqa: F401
