"""The ops the Paddle-API path calls, with the reference's signatures
(``paddle_tpu/ops/``); :mod:`paddle_tpu_torch` exports them at its top
level.  The rest of the reference's ops wait for a later slice
(``ROADMAP.md``)."""

from .creation import arange, full, ones, zeros
from .linalg import matmul
from .manipulation import concat, flatten, pad, reshape
from .math import add
from .random_ops import randint, randn

__all__ = ["add", "arange", "concat", "flatten", "full", "matmul", "ones",
           "pad", "randint", "randn", "reshape", "zeros"]
