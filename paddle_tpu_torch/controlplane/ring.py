"""Consistent-hash ring: ``X-Session-Id -> owning router`` (port of
``paddle_tpu/controlplane/ring.py``).

Every router hashes onto the ring at ``FLAGS_controlplane_vnodes`` virtual
points (blake2b of ``"{router_id}#{v}"``); a session is owned by the first
vnode clockwise of its own hash.  The points are the reference's byte for
byte, so both packages name the same owner for the same members.

- **Determinism**: every router computes the same owner from the same
  member set, with no coordination beyond membership itself.
- **Minimal movement**: removing a router moves only its spans (about
  ``1/N`` of the keyspace) onto the survivors; every other session stays
  where its pins, journal and quarantine state live.
- **Smoothness**: vnodes split each router's span into many small arcs, so
  a death spreads its load over every survivor.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

from .. import flags

__all__ = ["HashRing"]


def _point(s: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")


class HashRing:
    """A ring over one member set; rebuilt on a membership change."""

    def __init__(self, members: Iterable[str],
                 vnodes: Optional[int] = None):
        self.vnodes = int(flags.flag("controlplane_vnodes")
                          if vnodes is None else vnodes)
        self.members: Tuple[str, ...] = tuple(sorted(set(members)))
        pts: List[Tuple[int, str]] = []
        for m in self.members:
            for v in range(self.vnodes):
                pts.append((_point(f"{m}#{v}"), m))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [m for _, m in pts]

    def owner(self, key: str) -> Optional[str]:
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, _point(key))
        return self._owners[i % len(self._owners)]

    def spans(self) -> Dict[str, int]:
        """Vnode arcs per member (load-balance introspection)."""
        out = {m: 0 for m in self.members}
        for m in self._owners:
            out[m] += 1
        return out

    def __contains__(self, member: str) -> bool:
        return member in self.members

    def __len__(self) -> int:
        return len(self.members)

    def __eq__(self, other) -> bool:
        return (isinstance(other, HashRing)
                and self.members == other.members
                and self.vnodes == other.vnodes)

    def __hash__(self):
        return hash((self.members, self.vnodes))
