"""Membership and state store: the fleet's one shared KV endpoint (port of
``paddle_tpu/controlplane/store.py``).

TCPStore-shaped: ``set`` / ``get`` / ``wait`` / ``cas`` over one socket
endpoint, owned by the supervisor, plus heartbeat liveness, so a dead
router drops out of membership without anyone holding a lock on it.

Wire protocol (``StoreServer`` <-> ``StoreClient``), the reference's byte for
byte: newline-delimited JSON, one object per request and one per response,
many per connection:

    -> {"op": "set",  "key": K, "value": V, "ttl": null}
    <- {"ok": true, "version": 3}
    -> {"op": "cas",  "key": K, "old": V0, "new": V1}
    <- {"ok": false, "value": V_current}         # lost the race
    -> {"op": "hb",   "key": K, "value": V, "ttl": 5.0}
    <- {"ok": true}
    -> {"op": "members", "prefix": "router/"}
    <- {"ok": true, "members": {K: V, ...}}      # live heartbeats only

Clients and servers of either package talk to each other.  The state
(``StoreState``) is a dict and a lock behind three faces: the socket server,
the async in-process facade (``LocalStore``, no sockets) and the blocking
client of the supervisor's thread (``SyncStoreClient``).  ``wait`` blocks
until a key exists; async waiters poll at 10 ms.  ``get("__now__")`` answers
the store process's ``perf_counter`` (the span collector's clock handshake).

Bounds: every key carries an optional TTL (swept on writes and membership
reads) and the table is LRU-capped at ``FLAGS_controlplane_store_max_keys``.
A request line is at most ``_MAX_LINE`` (1 MiB) bytes: the server reads lines
that long (a span batch is one line), and a longer one is refused, counted
in ``controlplane.store_refused``, answered with an error and its
connection closed.
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from .. import flags
from .. import observability as _obs

__all__ = ["StoreState", "LocalStore", "StoreServer", "StoreClient",
           "SyncStoreClient"]

_WAIT_POLL_S = 0.01
_MAX_LINE = 1 << 20
# a response (a members() read of many span batches) is not capped; the
# async client reads lines up to this many bytes
_MAX_RESPONSE = 1 << 28

_TOMBSTONE = object()


class _StoreMetrics:
    """Registry handles resolved once."""

    __slots__ = ("ops", "keys", "evictions", "refused")

    def __init__(self):
        m = _obs.metrics
        self.ops = lambda op: m.counter("controlplane.store_ops", op=op)
        self.keys = m.gauge("controlplane.store_keys")
        self.evictions = m.counter("controlplane.store_evictions")
        self.refused = m.counter("controlplane.store_refused")


class StoreState:
    """The KV table.  Thread-safe; the clock is injectable for tests."""

    def __init__(self, *, max_keys: Optional[int] = None, clock=None):
        self._kv: "OrderedDict[str, Tuple[Any, int, Optional[float]]]" = \
            OrderedDict()  # key -> (value, version, expires_at | None)
        self._lock = threading.Lock()
        self._clock = clock or time.monotonic
        self.max_keys = int(flags.flag("controlplane_store_max_keys")
                            if max_keys is None else max_keys)
        self._m = _StoreMetrics()

    # -- core ops (each one lock hold; sweeps ride the write path) --

    def set(self, key: str, value: Any, ttl: Optional[float] = None) -> int:
        self._m.ops("set").inc()
        with self._lock:
            self._sweep_locked()
            _, version, _ = self._kv.pop(key, (None, 0, None))
            expires = self._clock() + ttl if ttl is not None else None
            self._kv[key] = (value, version + 1, expires)
            self._evict_locked()
            self._m.keys.set(len(self._kv))
            return version + 1

    def get(self, key: str) -> Tuple[bool, Any]:
        self._m.ops("get").inc()
        if key == "__now__":
            # virtual clock key: the store shares the collector's process,
            # so its perf_counter is the clock the exporters align to
            return True, {"t": time.perf_counter()}
        with self._lock:
            v = self._get_live_locked(key)
            return (False, None) if v is _TOMBSTONE else (True, v)

    def cas(self, key: str, old: Any, new: Any,
            ttl: Optional[float] = None) -> Tuple[bool, Any]:
        """Swap ``old -> new`` atomically; ``old=None`` means create if
        absent.  Returns ``(won, current_value)``."""
        self._m.ops("cas").inc()
        with self._lock:
            cur = self._get_live_locked(key)
            if cur is _TOMBSTONE:
                cur = None
            if cur != old:
                return False, cur
            _, version, _ = self._kv.pop(key, (None, 0, None))
            expires = self._clock() + ttl if ttl is not None else None
            self._kv[key] = (new, version + 1, expires)
            self._evict_locked()
            self._m.keys.set(len(self._kv))
            return True, new

    def delete(self, key: str) -> bool:
        self._m.ops("del").inc()
        with self._lock:
            hit = self._kv.pop(key, None) is not None
            self._m.keys.set(len(self._kv))
            return hit

    def heartbeat(self, key: str, value: Any, ttl: float) -> None:
        """Liveness stamp: a TTL'd set whose expiry is the death signal."""
        self._m.ops("hb").inc()
        with self._lock:
            _, version, _ = self._kv.pop(key, (None, 0, None))
            self._kv[key] = (value, version + 1, self._clock() + float(ttl))
            self._evict_locked()
            self._m.keys.set(len(self._kv))

    def members(self, prefix: str) -> Dict[str, Any]:
        """Unexpired keys under ``prefix``: the live-membership read."""
        self._m.ops("members").inc()
        with self._lock:
            self._sweep_locked()
            return {k: v for k, (v, _, _) in self._kv.items()
                    if k.startswith(prefix)}

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            self._sweep_locked()
            return {k: v for k, (v, _, _) in self._kv.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._kv)

    # -- internals (callers hold the lock) --

    def _get_live_locked(self, key: str):
        rec = self._kv.get(key)
        if rec is None:
            return _TOMBSTONE
        value, _, expires = rec
        if expires is not None and self._clock() >= expires:
            del self._kv[key]
            return _TOMBSTONE
        return value

    def _sweep_locked(self) -> None:
        now = self._clock()
        dead = [k for k, (_, _, exp) in self._kv.items()
                if exp is not None and now >= exp]
        for k in dead:
            del self._kv[k]

    def _evict_locked(self) -> None:
        while len(self._kv) > self.max_keys:
            self._kv.popitem(last=False)
            self._m.evictions.inc()


class LocalStore:
    """Async facade over an in-process ``StoreState``: the store with no
    sockets.  Same method shapes as ``StoreClient``, so
    ``RouterControlPlane`` cannot tell them apart."""

    def __init__(self, state: Optional[StoreState] = None):
        self.state = state if state is not None else StoreState()

    async def set(self, key, value, ttl=None):
        return self.state.set(key, value, ttl)

    async def get(self, key):
        return self.state.get(key)

    async def cas(self, key, old, new, ttl=None):
        return self.state.cas(key, old, new, ttl)

    async def delete(self, key):
        return self.state.delete(key)

    async def heartbeat(self, key, value, ttl):
        self.state.heartbeat(key, value, ttl)

    async def members(self, prefix):
        return self.state.members(prefix)

    async def wait(self, key, timeout: float = 5.0):
        deadline = time.monotonic() + timeout
        while True:
            ok, value = self.state.get(key)
            if ok:
                return True, value
            if time.monotonic() >= deadline:
                return False, None
            await asyncio.sleep(_WAIT_POLL_S)

    async def close(self):
        pass


class StoreServer:
    """The socket endpoint: newline-JSON requests against a
    ``StoreState``.  One per fleet, owned by the supervisor."""

    def __init__(self, state: Optional[StoreState] = None):
        self.state = state if state is not None else StoreState()
        self._server: Optional[asyncio.AbstractServer] = None

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    line = await reader.readline()
                except ValueError:    # past the reader's limit: too long
                    line = None
                if line is None or len(line) > _MAX_LINE:
                    self.state._m.refused.inc()
                    writer.write(json.dumps(
                        {"ok": False, "error": "request line over "
                         f"{_MAX_LINE} bytes"}).encode() + b"\n")
                    await writer.drain()
                    return
                if not line:
                    return
                try:
                    req = json.loads(line)
                    resp = await self._dispatch(req)
                except Exception as e:  # a malformed request, not a crash
                    resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                writer.write(json.dumps(resp).encode() + b"\n")
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, req: dict) -> dict:
        op, s = req.get("op"), self.state
        if op == "set":
            version = s.set(req["key"], req.get("value"), req.get("ttl"))
            return {"ok": True, "version": version}
        if op == "get":
            ok, value = s.get(req["key"])
            return {"ok": ok, "value": value}
        if op == "cas":
            won, cur = s.cas(req["key"], req.get("old"), req.get("new"),
                             req.get("ttl"))
            return {"ok": won, "value": cur}
        if op == "del":
            return {"ok": s.delete(req["key"])}
        if op == "hb":
            s.heartbeat(req["key"], req.get("value"), req.get("ttl", 5.0))
            return {"ok": True}
        if op == "members":
            return {"ok": True, "members": s.members(req.get("prefix", ""))}
        if op == "dump":
            return {"ok": True, "members": s.dump()}
        if op == "wait":
            deadline = time.monotonic() + float(req.get("timeout", 5.0))
            while True:
                ok, value = s.get(req["key"])
                if ok:
                    return {"ok": True, "value": value}
                if time.monotonic() >= deadline:
                    return {"ok": False, "value": None}
                await asyncio.sleep(_WAIT_POLL_S)
        return {"ok": False, "error": f"unknown op {op!r}"}

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        # the reader's limit admits a whole _MAX_LINE request (asyncio's
        # default of 64 KiB would cut a span batch)
        self._server = await asyncio.start_server(
            self.handle, host, port, limit=_MAX_LINE + 1)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


class StoreClient:
    """Async socket client (the router's side).  One lazy connection and
    one request in flight at a time (a lock serialises them: store ops run
    at control-plane cadence, not per token)."""

    def __init__(self, host: str, port: int, *,
                 connect_timeout_s: float = 5.0):
        self.host, self.port = host, int(port)
        self.connect_timeout_s = connect_timeout_s
        self._rw: Optional[Tuple[asyncio.StreamReader,
                                 asyncio.StreamWriter]] = None
        self._lock = asyncio.Lock()

    async def _call(self, req: dict) -> dict:
        async with self._lock:
            for attempt in (0, 1):  # one transparent reconnect
                if self._rw is None:
                    self._rw = await asyncio.wait_for(
                        asyncio.open_connection(self.host, self.port,
                                                limit=_MAX_RESPONSE),
                        self.connect_timeout_s)
                reader, writer = self._rw
                try:
                    writer.write(json.dumps(req).encode() + b"\n")
                    await writer.drain()
                    line = await reader.readline()
                    if not line:
                        raise ConnectionResetError("store closed")
                    return json.loads(line)
                except (ConnectionError, asyncio.IncompleteReadError):
                    self._rw = None
                    if attempt:
                        raise
        raise ConnectionResetError("store unreachable")

    async def set(self, key, value, ttl=None):
        return (await self._call({"op": "set", "key": key, "value": value,
                                  "ttl": ttl}))["version"]

    async def get(self, key):
        r = await self._call({"op": "get", "key": key})
        return r["ok"], r.get("value")

    async def cas(self, key, old, new, ttl=None):
        r = await self._call({"op": "cas", "key": key, "old": old,
                              "new": new, "ttl": ttl})
        return r["ok"], r.get("value")

    async def delete(self, key):
        return (await self._call({"op": "del", "key": key}))["ok"]

    async def heartbeat(self, key, value, ttl):
        await self._call({"op": "hb", "key": key, "value": value,
                          "ttl": ttl})

    async def members(self, prefix):
        return (await self._call({"op": "members",
                                  "prefix": prefix}))["members"]

    async def wait(self, key, timeout: float = 5.0):
        r = await self._call({"op": "wait", "key": key, "timeout": timeout})
        return r["ok"], r.get("value")

    async def close(self):
        if self._rw is not None:
            try:
                self._rw[1].close()
            except Exception:
                pass
            self._rw = None


class SyncStoreClient:
    """Blocking socket client for the supervisor's tick thread, the span
    exporter's thread and test harnesses: the same verbs over a plain
    ``socket``."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 5.0):
        self.host, self.port = host, int(port)
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._lock = threading.Lock()

    def _call(self, req: dict) -> dict:
        with self._lock:
            for attempt in (0, 1):
                if self._sock is None:
                    self._sock = socket.create_connection(
                        (self.host, self.port), timeout=self.timeout_s)
                    self._buf = b""
                try:
                    self._sock.sendall(json.dumps(req).encode() + b"\n")
                    while b"\n" not in self._buf:
                        chunk = self._sock.recv(65536)
                        if not chunk:
                            raise ConnectionResetError("store closed")
                        self._buf += chunk
                    line, self._buf = self._buf.split(b"\n", 1)
                    return json.loads(line)
                except (OSError, ConnectionError):
                    self._sock = None
                    if attempt:
                        raise
        raise ConnectionResetError("store unreachable")

    def set(self, key, value, ttl=None):
        return self._call({"op": "set", "key": key, "value": value,
                           "ttl": ttl})["version"]

    def get(self, key):
        r = self._call({"op": "get", "key": key})
        return r["ok"], r.get("value")

    def cas(self, key, old, new, ttl=None):
        r = self._call({"op": "cas", "key": key, "old": old, "new": new,
                        "ttl": ttl})
        return r["ok"], r.get("value")

    def delete(self, key):
        return self._call({"op": "del", "key": key})["ok"]

    def heartbeat(self, key, value, ttl):
        self._call({"op": "hb", "key": key, "value": value, "ttl": ttl})

    def members(self, prefix):
        return self._call({"op": "members", "prefix": prefix})["members"]

    def wait(self, key, timeout: float = 5.0):
        r = self._call({"op": "wait", "key": key, "timeout": timeout})
        return r["ok"], r.get("value")

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except Exception:
                pass
            self._sock = None
