"""Counting-Bloom digest sketch (port of
``paddle_tpu/controlplane/sketch.py``).

The exact prefix-residency digest ships one blake2b-8 chain hash per
resident page, O(resident pages) bytes per ``/statusz`` poll.  Past
``FLAGS_router_digest_sketch_threshold`` pages the sketch replaces it:

- **Replica side** (``CountingBloom``): ``m`` one-byte saturating counters
  kept by the prefix cache's digest log hook (insert bumps ``k`` counters,
  unlink decrements them), so a poll serializes in O(m/8).  The wire form
  is the membership bitmap (``counter > 0``), base64-encoded.
- **Router side** (``BloomView``): membership tests against the wire
  bitmap.  No false negatives, so a resident page always scores; false
  positives over-score at rate ``(1 - e^{-kn/m})^k``.

Indices come from one blake2b-16 per item by double hashing
(``h1 + i*h2 mod m``), so replica and router agree bit for bit on every
probe, across packages too.
"""

from __future__ import annotations

import base64
import hashlib
import math
from typing import Iterable, List, Optional

from .. import flags

__all__ = ["CountingBloom", "BloomView", "fp_rate"]


def _indices(item: str, m: int, k: int) -> List[int]:
    d = hashlib.blake2b(item.encode(), digest_size=16).digest()
    h1 = int.from_bytes(d[:8], "big")
    h2 = int.from_bytes(d[8:], "big") | 1  # odd -> full-period stride
    return [(h1 + i * h2) % m for i in range(k)]


def fp_rate(n_items: int, m_bits: int, k_hashes: int) -> float:
    """Classic Bloom false-positive bound for ``n`` inserted items."""
    if n_items <= 0:
        return 0.0
    return (1.0 - math.exp(-k_hashes * n_items / float(m_bits))) ** k_hashes


class CountingBloom:
    """Replica-side sketch: one-byte saturating counters, added to and
    removed from as pages come and go."""

    __slots__ = ("m", "k", "counters", "items")

    def __init__(self, m_bits: Optional[int] = None,
                 k_hashes: Optional[int] = None):
        self.m = int(flags.flag("router_digest_sketch_bits")
                     if m_bits is None else m_bits)
        self.k = int(flags.flag("router_digest_sketch_hashes")
                     if k_hashes is None else k_hashes)
        self.counters = bytearray(self.m)
        self.items = 0

    def add(self, item: str) -> None:
        self.items += 1
        for i in _indices(item, self.m, self.k):
            if self.counters[i] < 255:  # saturate: never wraps
                self.counters[i] += 1

    def remove(self, item: str) -> None:
        self.items = max(0, self.items - 1)
        for i in _indices(item, self.m, self.k):
            # a saturated counter lost its true count: leaving it set only
            # risks a false positive, never a false negative
            if 0 < self.counters[i] < 255:
                self.counters[i] -= 1

    def __contains__(self, item: str) -> bool:
        return all(self.counters[i] for i in _indices(item, self.m, self.k))

    def wire(self) -> dict:
        """Membership bitmap (counter > 0), base64: m/8 bytes flat."""
        bits = bytearray((self.m + 7) // 8)
        for i, c in enumerate(self.counters):
            if c:
                bits[i >> 3] |= 1 << (i & 7)
        return {"m": self.m, "k": self.k, "n": self.items,
                "bits": base64.b64encode(bytes(bits)).decode("ascii")}

    @classmethod
    def from_items(cls, items: Iterable[str], m_bits=None,
                   k_hashes=None) -> "CountingBloom":
        s = cls(m_bits, k_hashes)
        for it in items:
            s.add(it)
        return s


class BloomView:
    """Router-side view of a wire sketch: membership and its fp bound."""

    __slots__ = ("m", "k", "n", "_bits")

    def __init__(self, doc: dict):
        self.m = int(doc["m"])
        self.k = int(doc["k"])
        self.n = int(doc.get("n", 0))
        self._bits = base64.b64decode(doc["bits"])

    def __contains__(self, item: str) -> bool:
        for i in _indices(item, self.m, self.k):
            if not self._bits[i >> 3] & (1 << (i & 7)):
                return False
        return True

    def fp_bound(self) -> float:
        return fp_rate(self.n, self.m, self.k)

    def __len__(self) -> int:
        return self.n
