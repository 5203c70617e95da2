"""Replica clients: one uniform byte-stream interface to an upstream
``ServingServer``, whether it lives in this process or behind a socket
(port of ``paddle_tpu/router/replica.py``).

The router never special-cases transports — both clients speak the same
HTTP/1.1 wire format the replica's handler parses, and both return an
``asyncio.StreamReader`` yielding the raw response bytes:

- :class:`InprocReplica` wraps a started ``ServingServer`` in THIS
  process: the request bytes feed the server's ``handle`` coroutine over
  an in-process stream pair (the tier-1 idiom — no sockets, so the full
  router->replica->engine path runs offline inside the test timeout).
  ``kill()`` simulates a replica process dying: in-flight responses EOF
  mid-stream WITHOUT clean termination (exactly what a dropped TCP
  connection looks like) and new connections are refused.
- :class:`HttpReplica` dials a real ``host:port`` via
  ``asyncio.open_connection`` (the production deployment: N replica
  processes spawned by ``python -m paddle_tpu_torch.serving``).

Note on in-process fleets: the observability registry is process-wide,
so N ``InprocReplica`` servers share one ``serving.*`` series family
(fleet-aggregate by construction).  Per-replica placement signals stay
exact because they ride ``/statusz`` — engine stats, the prefix digest,
and SLO state are all per-``ServingServer``.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional, Tuple

__all__ = ["ReplicaClient", "InprocReplica", "HttpReplica"]


def request_bytes(method: str, path: str,
                  headers: Tuple[Tuple[str, str], ...] = (),
                  body: bytes = b"") -> bytes:
    """Serialize one HTTP/1.1 request the replica's parser accepts."""
    head = [f"{method} {path} HTTP/1.1", "Host: router"]
    head += [f"{k}: {v}" for k, v in headers]
    head.append(f"Content-Length: {len(body)}")
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


class ReplicaClient:
    """One upstream replica.  ``open()`` dispatches a request and returns
    ``(reader, close)``: a StreamReader over the raw response bytes and a
    zero-arg closer the caller MUST invoke when done with the stream."""

    def __init__(self, rid: str):
        self.id = rid

    async def open(self, method: str, path: str,
                   headers: Tuple[Tuple[str, str], ...] = (),
                   body: bytes = b"") -> Tuple[asyncio.StreamReader,
                                               Callable[[], None]]:
        raise NotImplementedError

    def describe(self) -> dict:
        return {"id": self.id, "transport": type(self).__name__}


class _PipeWriter:
    """Writer stand-in feeding a StreamReader: the response half of an
    in-process connection.  After ``sever()`` the replica-side handler
    sees a ConnectionResetError at its next ``drain()`` — the same
    failure a real socket reports once the peer is gone — and the
    router-side reader sees EOF."""

    def __init__(self, reader: asyncio.StreamReader):
        self._reader = reader
        self.closed = False

    def write(self, b) -> None:
        if not self.closed:
            self._reader.feed_data(bytes(b))

    async def drain(self) -> None:
        if self.closed:
            raise ConnectionResetError("in-process peer severed")

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                self._reader.feed_eof()
            except AssertionError:      # reader already at EOF
                pass

    async def wait_closed(self) -> None:
        return None

    def sever(self) -> None:
        """Simulate the transport dying mid-response (no clean close)."""
        self.close()

    def get_extra_info(self, *a, **k):
        return None

    def is_closing(self) -> bool:
        return self.closed


class InprocReplica(ReplicaClient):
    """A ``ServingServer`` in this process, spoken to over in-process
    stream pairs.  The server must be ``start()``-ed by the owner; this
    client only opens per-request connections against its ``handle``."""

    def __init__(self, rid: str, server):
        super().__init__(rid)
        self.server = server
        self._killed = False
        self._conns: set = set()        # live (task, writer) pairs

    @property
    def engine(self):
        return self.server.engine

    async def open(self, method, path, headers=(), body=b""):
        if self._killed:
            raise ConnectionRefusedError(f"replica {self.id} is down")
        req = asyncio.StreamReader()
        req.feed_data(request_bytes(method, path, headers, body))
        req.feed_eof()
        resp = asyncio.StreamReader()
        writer = _PipeWriter(resp)
        task = asyncio.ensure_future(self.server.handle(req, writer))
        pair = (task, writer)
        self._conns.add(pair)
        task.add_done_callback(lambda _t: self._conns.discard(pair))

        def close():
            # the router is done with this stream: sever the writer so a
            # handler still mid-response sees the same ConnectionResetError
            # a dropped socket reports (and retires its engine request)
            # instead of generating the rest of the completion into a
            # buffer nobody reads; after a completed response this is a
            # no-op (the handler already closed the writer)
            self._conns.discard(pair)
            writer.sever()

        return resp, close

    def kill(self, *, close_server: bool = True) -> None:
        """Die like a process: refuse new connections and sever every
        in-flight response mid-stream (EOF with NO terminator — the
        router must turn that into clean client-side termination and a
        ``router.failover`` count).  ``close_server=True`` also stops the
        engine thread, so health polls and liveness agree it is gone."""
        self._killed = True
        self.sever_streams()
        if close_server:
            self.server.close()

    def sever_streams(self) -> None:
        """Cut every in-flight response mid-stream WITHOUT killing the
        replica (the chaos harness's dropped-TCP-connection fault): the
        handler side sees ConnectionResetError at its next drain, the
        router side sees EOF sans terminator.  New connections still
        succeed."""
        for task, writer in list(self._conns):
            writer.sever()

    def revive(self) -> None:
        """Bring a killed replica back (rejoin-after-recovery tests)."""
        self._killed = False
        self.server.start()

    def describe(self) -> dict:
        return {**super().describe(), "killed": self._killed}


class HttpReplica(ReplicaClient):
    """A replica process behind ``host:port`` (production deployment)."""

    def __init__(self, rid: str, host: str, port: int,
                 connect_timeout_s: Optional[float] = None):
        super().__init__(rid)
        self.host = host
        self.port = int(port)
        if connect_timeout_s is None:
            from .. import flags
            connect_timeout_s = float(flags.flag("router_poll_timeout_s"))
        self.connect_timeout_s = connect_timeout_s

    async def open(self, method, path, headers=(), body=b""):
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port),
            self.connect_timeout_s)

        def close():
            try:
                writer.close()
            except Exception:
                pass

        try:
            writer.write(request_bytes(method, path, headers, body))
            await writer.drain()
        except Exception:
            # connect succeeded but the replica reset before taking the
            # request: don't leak the transport — the caller only learns
            # close() on success
            close()
            raise

        return reader, close

    def describe(self) -> dict:
        return {**super().describe(),
                "target": f"{self.host}:{self.port}"}
