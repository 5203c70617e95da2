"""Minimal stdlib HTTP/1.1 wire format for the serving front door.

Request parsing and response formatting over ``asyncio`` stream pairs —
standard library only, and no socket assumption: the handler talks to
anything with ``readline`` / ``readexactly`` on one side and ``write`` /
``drain`` on the other, which is what lets the tests drive the full server
through in-process transports while serving binds real sockets via
``asyncio.start_server``.  (A copy of ``paddle_tpu/serving/http.py``: the
port imports nothing of the JAX package.)

Streaming responses use Server-Sent Events over a close-delimited body
(``Connection: close``, no Content-Length): the OpenAI streaming shape —
``data: {json}\\n\\n`` frames, terminated by ``data: [DONE]`` — readable
by any HTTP/1.x client without chunked-decoding support.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, Optional, Tuple

__all__ = ["HttpError", "read_request", "response", "sse_headers",
           "sse_event", "sse_done", "json_response", "error_response",
           "SAFE_ID_OK", "MAX_BODY"]

# charset a caller-supplied trace/session id must satisfy to be honored
# (anything else would leak into trace lanes, log lines, and response
# headers).  One definition shared by the replica server and the router:
# the router->replica X-Trace-Id propagation contract depends on both
# sides accepting the same ids, so the rule must not drift.
SAFE_ID_OK = re.compile(r"[A-Za-z0-9._:\-]{1,128}").fullmatch

MAX_LINE = 16 * 1024
MAX_HEADERS = 64
MAX_BODY = 8 * 1024 * 1024

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 409: "Conflict",
            413: "Payload Too Large",
            500: "Internal Server Error", 502: "Bad Gateway",
            503: "Service Unavailable", 504: "Gateway Timeout"}


class HttpError(Exception):
    """Maps to an HTTP error response at the connection handler."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


async def _readline(reader) -> bytes:
    # asyncio.StreamReader.readline raises ValueError once its own buffer
    # limit (64KB default) is hit — that's a malformed CLIENT request, not
    # a server fault, so surface it as a 400 like the MAX_LINE guard
    try:
        return await reader.readline()
    except ValueError:
        raise HttpError(400, "line too long")


async def read_request(reader, body_limit: Optional[Callable[[str, str],
                                                            int]] = None
                       ) -> Tuple[str, str, Dict[str, str], bytes]:
    """Parse one request: ``(method, path, headers, body)``.  Headers are
    lower-cased; the body is read per Content-Length (no request chunking
    — none of the served clients need it), up to ``MAX_BODY`` bytes or,
    given ``body_limit``, ``body_limit(method, path)``."""
    line = await _readline(reader)
    if not line:
        raise HttpError(400, "empty request")
    if len(line) > MAX_LINE:
        raise HttpError(400, "request line too long")
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, f"malformed request line: {line[:80]!r}")
    method, path = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    for _ in range(MAX_HEADERS):
        line = await _readline(reader)
        if len(line) > MAX_LINE:
            raise HttpError(400, "header line too long")
        s = line.decode("latin-1").strip()
        if not s:
            break
        if ":" not in s:
            raise HttpError(400, f"malformed header: {s[:80]!r}")
        k, v = s.split(":", 1)
        headers[k.strip().lower()] = v.strip()
    else:
        raise HttpError(400, "too many headers")
    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise HttpError(400, "bad Content-Length")
        limit = MAX_BODY if body_limit is None else body_limit(method, path)
        if n < 0 or n > limit:
            raise HttpError(413, f"body of {n} bytes exceeds {limit}")
        if n:
            body = await reader.readexactly(n)
    return method, path, headers, body


def response(status: int, body: bytes,
             content_type: str = "application/json",
             extra_headers: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    """A complete close-delimited response with Content-Length."""
    head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    head += [f"{k}: {v}" for k, v in extra_headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def json_response(status: int, obj,
                  extra_headers: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    return response(status, (json.dumps(obj) + "\n").encode(),
                    extra_headers=extra_headers)


def error_response(status: int, message: str, *,
                   err_type: str = "invalid_request_error",
                   extra_headers: Tuple[Tuple[str, str], ...] = (),
                   fields: Optional[Dict[str, object]] = None) -> bytes:
    """OpenAI-shaped error envelope.  ``fields`` merge into the error
    object (e.g. ``retry_after_s`` mirroring a ``Retry-After`` header so
    JSON-only clients see the backoff too)."""
    err: Dict[str, object] = {"message": message, "type": err_type,
                              "code": status}
    if fields:
        err.update(fields)
    return json_response(status, {"error": err},
                         extra_headers=extra_headers)


def sse_headers(extra_headers: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    """Response head opening a close-delimited SSE stream."""
    head = ["HTTP/1.1 200 OK",
            "Content-Type: text/event-stream",
            "Cache-Control: no-cache",
            "Connection: close"]
    head += [f"{k}: {v}" for k, v in extra_headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")


def sse_event(obj) -> bytes:
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


def sse_done() -> bytes:
    return b"data: [DONE]\n\n"
