"""Per-router control-plane facade: membership, ring and peers (port of
``paddle_tpu/controlplane/plane.py``).

One ``RouterControlPlane`` rides inside each ``RouterServer`` and holds the
router's view of the fleet:

- **Liveness**: heartbeats ``router/<rid>`` into the store every tick (TTL
  ``FLAGS_controlplane_heartbeat_ttl_s``); a router that stops beating
  expires out of ``members("router/")`` and the survivors' rings rebuild
  without it.
- **Ownership**: ``owner(session_id)`` answers from the current
  ``HashRing``; a membership change rebuilds the ring, counts
  ``router.ring_moves`` and CAS-bumps the shared ``cp/ring`` record
  ``{"epoch": E, "members": [...]}``.
- **Peers**: in-process fleets register peer clients directly
  (``register_peer``); process fleets dial the host:port each router
  advertises in its heartbeat (a lazy ``HttpReplica``: a router peer speaks
  the replica's HTTP surface).
- **Journal replication**: the owning router mirrors each in-flight
  journaled stream to ``journal/<session_id>`` (TTL'd); after its death the
  session's new owner adopts the record and resumes the stream on the
  replay plane.

The keyspace (``router/``, ``replica/``, ``journal/``, ``cp/ring``) and the
record shapes are the reference's, so routers of both packages can share one
store.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .. import flags
from .. import observability as _obs
from .ring import HashRing

__all__ = ["RouterControlPlane"]

_RING_KEY = "cp/ring"
_ROUTER_PREFIX = "router/"
_REPLICA_PREFIX = "replica/"
_JOURNAL_PREFIX = "journal/"


class _PlaneMetrics:
    """Registry handles resolved once."""

    __slots__ = ("ring_moves", "members", "ring_epoch", "heartbeats",
                 "journal_replicated", "takeovers")

    def __init__(self):
        m = _obs.metrics
        self.ring_moves = m.counter("router.ring_moves")
        self.members = m.gauge("controlplane.members")
        self.ring_epoch = m.gauge("controlplane.ring_epoch")
        self.heartbeats = m.counter("controlplane.heartbeats")
        self.journal_replicated = m.counter("controlplane.journal_replicated")
        self.takeovers = lambda o: m.counter("controlplane.takeovers",
                                             outcome=o)


class RouterControlPlane:
    """Everything a ``RouterServer`` needs to be one of N."""

    def __init__(self, router_id: str, store, *,
                 advertise: Optional[Dict[str, Any]] = None,
                 vnodes: Optional[int] = None,
                 heartbeat_ttl_s: Optional[float] = None,
                 journal_ttl_s: Optional[float] = None):
        f = flags.flag
        self.rid = router_id
        self.store = store  # LocalStore or StoreClient (async verbs)
        self.advertise = dict(advertise or {})
        self.heartbeat_ttl_s = float(f("controlplane_heartbeat_ttl_s")
                                     if heartbeat_ttl_s is None
                                     else heartbeat_ttl_s)
        self.journal_ttl_s = float(f("controlplane_journal_ttl_s")
                                   if journal_ttl_s is None
                                   else journal_ttl_s)
        self.ring = HashRing([router_id], vnodes)
        self._vnodes = self.ring.vnodes
        self.members: Dict[str, Any] = {router_id: self.advertise}
        self.ring_epoch = 0
        self._peers: Dict[str, Any] = {}  # rid -> ReplicaClient-shaped
        self._m = _PlaneMetrics()

    # -- ownership ----------------------------------------------------

    def owner(self, session_id: str) -> str:
        return self.ring.owner(session_id) or self.rid

    def owns(self, session_id: str) -> bool:
        return self.owner(session_id) == self.rid

    # -- peers --------------------------------------------------------

    def register_peer(self, rid: str, client) -> None:
        """In-process fleets hand the peer transport over directly."""
        self._peers[rid] = client

    def peer(self, rid: str):
        """Transport to a live peer, or None (unknown, or no address)."""
        if rid == self.rid:
            return None
        client = self._peers.get(rid)
        if client is not None:
            return client
        addr = self.members.get(rid)
        if not isinstance(addr, dict) or "host" not in addr:
            return None
        from ..router.replica import HttpReplica  # circular at import time
        client = HttpReplica(rid, addr["host"], int(addr["port"]))
        self._peers[rid] = client
        return client

    # -- membership ---------------------------------------------------

    async def heartbeat(self) -> None:
        await self.store.heartbeat(_ROUTER_PREFIX + self.rid,
                                   self.advertise, self.heartbeat_ttl_s)
        self._m.heartbeats.inc()

    async def refresh(self) -> bool:
        """Re-read membership; rebuild the ring on a change.  Returns True
        when the ring moved."""
        raw = await self.store.members(_ROUTER_PREFIX)
        members = {k[len(_ROUTER_PREFIX):]: v for k, v in raw.items()}
        members.setdefault(self.rid, self.advertise)  # we are alive
        moved = tuple(sorted(members)) != self.ring.members
        self.members = members
        if moved:
            self.ring = HashRing(members, self._vnodes)
            for rid in list(self._peers):
                if rid not in members:
                    del self._peers[rid]
            self._m.ring_moves.inc()
            await self._bump_ring_record()
        self._m.members.set(len(members))
        return moved

    async def _bump_ring_record(self) -> None:
        """CAS ``cp/ring`` to the new member list (one winner a change;
        the losers adopt the winner's epoch)."""
        want = sorted(self.ring.members)
        _, cur = await self.store.get(_RING_KEY)
        if isinstance(cur, dict) and cur.get("members") == want:
            self.ring_epoch = int(cur.get("epoch", 0))
        else:
            doc = {"epoch": int((cur or {}).get("epoch", 0)) + 1,
                   "members": want}
            won, now = await self.store.cas(_RING_KEY, cur, doc)
            doc = doc if won else (now if isinstance(now, dict) else doc)
            self.ring_epoch = int(doc.get("epoch", 0))
        self._m.ring_epoch.set(self.ring_epoch)

    async def tick(self) -> bool:
        """One control-plane beat: stamp liveness, refresh the ring."""
        await self.heartbeat()
        return await self.refresh()

    async def replica_members(self) -> Dict[str, Any]:
        """The supervisor's published replica endpoints (store discovery
        for process routers launched with ``--store``)."""
        raw = await self.store.members(_REPLICA_PREFIX)
        return {k[len(_REPLICA_PREFIX):]: v for k, v in raw.items()}

    # -- journal replication -----------------------------------------

    async def publish_journal(self, session_id: str, doc: dict) -> None:
        await self.store.set(_JOURNAL_PREFIX + session_id, doc,
                             ttl=self.journal_ttl_s)
        self._m.journal_replicated.inc()

    async def take_journal(self, session_id: str) -> Optional[dict]:
        ok, doc = await self.store.get(_JOURNAL_PREFIX + session_id)
        return doc if ok and isinstance(doc, dict) else None

    async def drop_journal(self, session_id: str) -> None:
        await self.store.delete(_JOURNAL_PREFIX + session_id)

    def takeover(self, outcome: str) -> None:
        """Count one cross-router journal adoption attempt."""
        self._m.takeovers(outcome).inc()

    # -- introspection ------------------------------------------------

    def describe(self) -> dict:
        spans = self.ring.spans()
        total = sum(spans.values()) or 1
        return {
            "router_id": self.rid,
            "members": sorted(self.members),
            "ring_epoch": self.ring_epoch,
            "vnodes": self._vnodes,
            "owned_fraction": round(spans.get(self.rid, 0) / total, 4),
        }
