"""Control-plane pieces of the port (port of ``paddle_tpu/controlplane``).

Only the digest sketch is here: the replica side (``CountingBloom``, kept by
the prefix cache) and the router side (``BloomView``, read by
``router/placement.py``).  The membership store, the consistent-hash ring
and the multi-router plane are not ported yet.
"""

from . import sketch
from .sketch import BloomView, CountingBloom, fp_rate

__all__ = ["sketch", "BloomView", "CountingBloom", "fp_rate"]
