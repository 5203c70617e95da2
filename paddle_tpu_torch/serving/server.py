"""The serving front door: a long-lived asyncio HTTP process over the port's
``ContinuousBatchingEngine`` (port of a subset of
``paddle_tpu/serving/server.py``).

- The **engine thread** owns the engine exclusively (its state is device
  tensors chained between steps).  It pulls submissions from a thread-safe
  inbox, runs the fused engine step in a loop, and after each step diffs
  every live request's ``output`` (which grows at the engine's drains) and
  posts fresh tokens to the owning connection through
  ``loop.call_soon_threadsafe``.
- The **event loop** parses HTTP and streams Server-Sent Events.

Endpoints: ``POST /v1/completions`` (OpenAI-shaped, token ids in and out,
``stream`` true or false), ``GET /healthz`` (engine thread up) and
``GET /readyz`` (503 until the warmup run has finished).

SLO shedding, the flight recorder, the sentinel, graceful drain,
``/statusz``, ``/metrics`` and ``/migratez`` are not ported yet.
"""

from __future__ import annotations

import asyncio
import json
import os
import queue
import sys
import threading
import traceback
from typing import List, Optional

from . import http as _http

__all__ = ["ServingServer", "serve_forever"]

_TRACE_ID_OK = _http.SAFE_ID_OK


class _Stream:
    """Bridge between one HTTP connection (event loop side) and its engine
    request (engine thread side)."""

    __slots__ = ("trace_id", "prompt", "max_new_tokens", "q", "loop",
                 "req", "sent", "cancelled")

    def __init__(self, trace_id, prompt, max_new_tokens, loop):
        self.trace_id = trace_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.q: asyncio.Queue = asyncio.Queue()
        self.loop = loop
        self.req = None               # engine Request, set on engine thread
        self.sent = 0                 # tokens already pushed to the client
        self.cancelled = False

    def post(self, item) -> None:
        """Engine thread -> event loop handoff."""
        if self.cancelled:
            return
        try:
            self.loop.call_soon_threadsafe(self.q.put_nowait, item)
        except RuntimeError:
            # the handler's event loop is closed: stop posting
            self.cancelled = True


class ServingServer:
    """Long-lived serving process over one ``ContinuousBatchingEngine``.

    The caller builds the engine (model and pool sizing are workload
    policy); the server owns its lifecycle from ``start()`` to ``close()``.
    With ``warmup=True`` the engine thread first drives one junk request
    through both step shapes, and ``/readyz`` reports ready only after.
    """

    def __init__(self, engine, *, model_name: str = "paddle-tpu-torch",
                 poll_s: float = 0.02, warmup: bool = False):
        self.engine = engine
        self.model_name = model_name
        self._warmup = warmup
        self._ready = threading.Event()
        self._poll_s = poll_s
        self._inbox: "queue.SimpleQueue[_Stream]" = queue.SimpleQueue()
        self._live: List[_Stream] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead = False            # set BEFORE the final inbox sweep
        self._engine_error: Optional[BaseException] = None
        self._next_rid = 0
        self._rid_lock = threading.Lock()
        self._asyncio_server = None

    # ------------------------------------------------------- lifecycle --
    def start(self) -> "ServingServer":
        """Start the engine thread."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._dead = False
        self._ready.clear()
        self._thread = threading.Thread(target=self._engine_loop,
                                        name="serving-engine", daemon=True)
        self._thread.start()
        return self

    def ready(self) -> bool:
        """The engine thread is up and (with ``warmup``) its warmup done."""
        return self.engine_alive() and self._ready.is_set()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=30)
            if t.is_alive():
                # a hung device step outlived the join: keep the thread so
                # start() never spawns a second owner of the engine
                print("[paddle_tpu_torch serving] engine thread did not exit "
                      "within 30s; refusing to forget it", file=sys.stderr)
            else:
                self._thread = None

    async def start_http(self, host: str = "127.0.0.1", port: int = 0):
        """Bind a socket listener; returns the bound (host, port)."""
        self.start()
        self._asyncio_server = await asyncio.start_server(
            self.handle, host, port)
        return self._asyncio_server.sockets[0].getsockname()[:2]

    async def stop_http(self) -> None:
        if self._asyncio_server is not None:
            self._asyncio_server.close()
            await self._asyncio_server.wait_closed()
            self._asyncio_server = None
        self.close()

    # ------------------------------------------------------ engine loop --
    def engine_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive() \
            and not self._dead

    def _engine_loop(self) -> None:
        eng = self.engine
        finish = "server_shutdown"
        flush = False                 # a step ran since the last idle flush
        try:
            if self._warmup:
                self._warm()
            self._ready.set()
            while not self._stop.is_set():
                while True:
                    try:
                        h = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                    h.req = eng.submit(h.prompt, h.max_new_tokens,
                                       trace_id=h.trace_id)
                    self._live.append(h)
                if eng.has_work():
                    eng.step()
                    self._publish()
                    flush = True
                else:
                    if flush:
                        # one idle step() after the last active one drains
                        # any pending window
                        eng.step()
                        self._publish()
                        flush = False
                    self._wake.wait(self._poll_s)
                    self._wake.clear()
        except Exception as e:
            # the engine died mid-serve: retire every waiter with 'error'
            # instead of leaving handlers hanging
            finish = "error"
            self._engine_error = e
            print(f"[paddle_tpu_torch serving] engine thread died: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            traceback.print_exc()
        finally:
            self._dead = True
            while True:
                try:
                    self._live.append(self._inbox.get_nowait())
                except queue.Empty:
                    break
            for h in list(self._live):
                h.post(("done", {"finish_reason": finish,
                                 "n": len(h.req.output) if h.req else 0}))
            self._live.clear()

    def _warm(self) -> None:
        """Drive one deterministic junk request through the T=bucket mixed
        step and the T=1 decode step (and build the kernel) before
        ``/readyz`` flips to ready."""
        eng = self.engine
        vocab = eng.g.config.vocab_size
        n = eng.g.prefill_bucket + 3      # chunked prefill + partial tail
        alloc = eng.g.cache.allocator
        n = max(1, min(n, alloc.num_pages * alloc.page_size - 2))
        prompt = [(i % (vocab - 1)) + 1 for i in range(n)]
        req = eng.submit(prompt, max_new_tokens=2, trace_id="warmup")
        while not req.done and not self._stop.is_set():
            eng.step()
        eng.step()                        # idle tail-flush drain

    def _publish(self) -> None:
        """Diff every live request's drained output; push fresh tokens."""
        eos = self.engine.gen_cfg.eos_token_id
        for h in list(self._live):
            req = h.req
            out = req.output
            if len(out) > h.sent:
                h.post(("tokens", list(out[h.sent:])))
                h.sent = len(out)
            if req.done:
                reason = "stop" if (eos is not None and out
                                    and out[-1] == eos) else "length"
                h.post(("done", {"finish_reason": reason, "n": len(out)}))
                self._live.remove(h)

    # ---------------------------------------------------------- handler --
    async def handle(self, reader, writer) -> None:
        """One HTTP connection (asyncio.start_server signature; equally
        happy with in-process stream stand-ins)."""
        try:
            try:
                method, path, headers, body = \
                    await _http.read_request(reader)
            except _http.HttpError as e:
                writer.write(_http.error_response(e.status, e.message))
                await writer.drain()
                return
            await self._route(method, path, headers, body, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                      # client went away mid-stream
        except Exception as e:
            try:
                writer.write(_http.error_response(
                    500, f"{type(e).__name__}: {e}",
                    err_type="internal_error"))
                await writer.drain()
            except Exception:
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, method, path, headers, body, writer) -> int:
        path = path.partition("?")[0]
        if path == "/healthz" and method == "GET":
            alive = self.engine_alive()
            writer.write(_http.json_response(
                200 if alive else 503,
                {"status": "ok" if alive else "engine thread down"}))
            await writer.drain()
            return 200 if alive else 503
        if path == "/readyz" and method == "GET":
            ready = self.ready()
            why = ("ok" if ready else
                   "engine warmup in progress"
                   if self.engine_alive() else "engine thread down")
            writer.write(_http.json_response(
                200 if ready else 503, {"ready": ready, "status": why}))
            await writer.drain()
            return 200 if ready else 503
        if path == "/v1/completions" and method == "POST":
            return await self._completions(headers, body, writer)
        if path in ("/healthz", "/readyz", "/v1/completions"):
            writer.write(_http.error_response(405, f"{method} not allowed"))
            await writer.drain()
            return 405
        writer.write(_http.error_response(404, f"no route {path}"))
        await writer.drain()
        return 404

    # ------------------------------------------------------ completions --
    def _parse_prompt(self, p) -> List[int]:
        if isinstance(p, str):
            try:
                p = [int(t) for t in p.split()]
            except ValueError:
                raise _http.HttpError(
                    400, "string prompts must be space-separated token ids "
                         "(no tokenizer in-tree)")
        if not isinstance(p, list) or not p or \
                not all(isinstance(t, int) and not isinstance(t, bool)
                        for t in p):
            raise _http.HttpError(
                400, "prompt must be a non-empty list of token ids")
        vocab = self.engine.g.config.vocab_size
        if not all(0 <= t < vocab for t in p):
            raise _http.HttpError(
                400, f"token ids must be in [0, {vocab})")
        return p

    def _trace_id(self, headers=None) -> str:
        """Request id: a safe ``X-Trace-Id`` header, else a fresh id."""
        if headers:
            t = headers.get("x-trace-id", "")
            if t and _TRACE_ID_OK(t):
                return t
        with self._rid_lock:
            n = self._next_rid
            self._next_rid += 1
        return f"cmpl-{os.getpid():x}-{n:06x}-{os.urandom(4).hex()}"

    async def _completions(self, headers, body, writer) -> int:
        try:
            payload = json.loads(body.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            writer.write(_http.error_response(400, f"bad JSON body: {e}"))
            await writer.drain()
            return 400
        try:
            prompt = self._parse_prompt(payload.get("prompt"))
        except _http.HttpError as e:
            writer.write(_http.error_response(e.status, e.message))
            await writer.drain()
            return e.status
        max_tokens = payload.get("max_tokens",
                                 self.engine.gen_cfg.max_new_tokens)
        if not isinstance(max_tokens, int) or isinstance(max_tokens, bool) \
                or max_tokens < 1:
            writer.write(_http.error_response(
                400, "max_tokens must be a positive integer"))
            await writer.drain()
            return 400
        # a prompt whose page demand exceeds the whole pool would raise in
        # admission and kill the engine thread: reject it here
        g = self.engine.g
        need = -(-min(len(prompt), g.max_seq_len - 1) // g.page_size)
        if need > g.num_pages:
            writer.write(_http.error_response(
                413, f"prompt needs {need} KV pages but the pool only has "
                     f"{g.num_pages}"))
            await writer.drain()
            return 413
        if not self.engine_alive():
            why = (f": {type(self._engine_error).__name__}"
                   if self._engine_error is not None else "")
            writer.write(_http.error_response(
                503, f"engine thread down{why}", err_type="internal_error"))
            await writer.drain()
            return 503
        stream = bool(payload.get("stream", False))
        h = _Stream(self._trace_id(headers), prompt, max_tokens,
                    asyncio.get_running_loop())
        self._inbox.put(h)
        self._wake.set()
        if self._dead:
            # the engine exited between the liveness check and the put: its
            # final sweep may have missed this submission
            h.post(("done", {"finish_reason": "error"
                             if self._engine_error else "server_shutdown",
                             "n": 0}))
        try:
            if stream:
                return await self._stream_response(h, writer)
            return await self._unary_response(h, writer)
        except BaseException:
            h.cancelled = True        # nobody reads this queue any more
            raise

    def _chunk(self, h: _Stream, token_ids, finish_reason=None) -> dict:
        return {"id": h.trace_id, "object": "text_completion.chunk",
                "model": self.model_name,
                "choices": [{"index": 0,
                             "text": " ".join(str(t) for t in token_ids),
                             "token_ids": list(token_ids),
                             "finish_reason": finish_reason}]}

    async def _stream_response(self, h: _Stream, writer) -> int:
        writer.write(_http.sse_headers(
            extra_headers=(("X-Request-Id", h.trace_id),)))
        await writer.drain()
        # the response head is out: failures now end the event stream
        try:
            while True:
                kind, payload = await h.q.get()
                if kind == "tokens":
                    writer.write(_http.sse_event(self._chunk(h, payload)))
                    await writer.drain()
                else:
                    writer.write(_http.sse_event(self._chunk(
                        h, (), finish_reason=payload["finish_reason"])))
                    writer.write(_http.sse_done())
                    await writer.drain()
                    return 200
        except (ConnectionError, RuntimeError,
                asyncio.IncompleteReadError):
            h.cancelled = True        # client gone; the engine finishes it
            return 499

    async def _unary_response(self, h: _Stream, writer) -> int:
        toks: List[int] = []
        while True:
            kind, payload = await h.q.get()
            if kind == "tokens":
                toks.extend(payload)
            else:
                finish = payload["finish_reason"]
                break
        if finish in ("error", "server_shutdown"):
            writer.write(_http.error_response(
                503, f"engine {finish} before the request completed",
                err_type="internal_error",
                extra_headers=(("X-Request-Id", h.trace_id),)))
            await writer.drain()
            return 503
        out = {"id": h.trace_id, "object": "text_completion",
               "model": self.model_name,
               "choices": [{"index": 0,
                            "text": " ".join(str(t) for t in toks),
                            "token_ids": toks,
                            "finish_reason": finish}],
               "usage": {"prompt_tokens": len(h.prompt),
                         "completion_tokens": len(toks),
                         "total_tokens": len(h.prompt) + len(toks)}}
        writer.write(_http.json_response(
            200, out, extra_headers=(("X-Request-Id", h.trace_id),)))
        await writer.drain()
        return 200


async def _serve_async(server: ServingServer, host: str, port: int):
    bound = await server.start_http(host, port)
    print(f"[paddle_tpu_torch serving] listening on "
          f"http://{bound[0]}:{bound[1]}  (/v1/completions, /healthz, "
          f"/readyz)", flush=True)
    try:
        await server._asyncio_server.serve_forever()
    finally:
        await server.stop_http()


def serve_forever(engine, *, host: str = "127.0.0.1", port: int = 8000,
                  **kw) -> None:
    """Blocking entry: build the server over ``engine`` and serve until
    interrupted (Ctrl-C)."""
    server = ServingServer(engine, **kw)
    try:
        asyncio.run(_serve_async(server, host, port))
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
