"""The serving front door: a long-lived asyncio HTTP process over the port's
``ContinuousBatchingEngine``, with its control and observability plane
(port of ``paddle_tpu/serving/server.py``).

- The **engine thread** owns the engine exclusively (its state is device
  tensors chained between steps).  It pulls submissions from a thread-safe
  inbox, runs control operations (``run_on_engine``: session migration)
  between steps, runs the fused engine step in a loop under the step
  watchdog, and after each step diffs every live request's ``output``
  (which grows at the engine's drains) and posts fresh tokens to the
  owning connection through ``loop.call_soon_threadsafe``.
- The **event loop** parses HTTP, makes the SLO admission decision
  (``slo.SLOController``: histogram burn, not queue length) and streams
  Server-Sent Events.

Endpoints:

- ``POST /v1/completions``: OpenAI-shaped, token ids in and out, ``stream``
  true or false; the response id is the request's trace id.
- ``GET /metrics``: Prometheus exposition of the whole registry.
- ``GET /healthz`` (engine thread up), ``GET /readyz`` (503 until warm-up
  has finished, and while draining).
- ``GET /statusz``: engine, pool and prefix-cache state, SLO burn,
  latency quantiles, the hung-request table, the step cost table, the
  sentinel's anomalies, the flight recorder, build and flag info.
- ``POST /drainz``: stop admission; in-flight requests finish.
- ``POST /migratez/export`` and ``POST /migratez/import``: session
  snapshots out of and into the engine (``inference/migration.py``).

Observability wiring: every request carries its trace id from accept to
retire, the flight recorder's span ring is attached for the server's
lifetime with periodic registry snapshots folded in from the engine loop,
the watchdog watches every engine step (a hung step fires the flight
recorder's dump), the sentinel sweeps the registry from the engine loop,
and SIGTERM drains (``install_drain_signal``) after the recorder's dump
(``install_crash_hooks``).
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import queue
import signal
import sys
import threading
import time
import traceback
from typing import List, Optional

from .. import flags
from .. import observability as _obs
from ..observability.flight_recorder import FlightRecorder
from . import http as _http
from .slo import SHED, SLOController, jittered_retry_after

__all__ = ["ServingServer", "serve_forever"]

_TRACE_ID_OK = _http.SAFE_ID_OK

# process-wide server ordinal: the per-replica track tag of lifecycle spans
_SERVER_SEQ = 0


# JSON around one page of a migration snapshot: its index and source, and
# each plane's dtype and shape
_PAGE_FRAMING = 1024


def _import_body_limit(engine) -> int:
    """Bound on a ``/migratez/import`` body: every page of the engine's
    pool once, base64-encoded, with its framing, plus ``MAX_BODY`` for the
    token lists and the rest.  A larger body carries more pages than the
    engine can adopt at once; the caller splits it."""
    cache = engine.g.cache
    page_b64 = sum(4 * -(-(math.prod(shape) * dt.itemsize) // 3)
                   for shape, dt in cache.page_shapes())
    return cache.allocator.num_pages * (page_b64 + _PAGE_FRAMING) \
        + _http.MAX_BODY


def _decode_import(body: bytes):
    """Parse a ``/migratez/import`` body and decode its snapshots' planes
    (a worker thread's job: hundreds of MB of base64 for a long session).
    Returns the payload's scalar keys and the decoded sessions; a session
    that does not decode is passed on as it came, for ``import_session``
    to reject and count."""
    from ..inference import migration as _mig
    payload = json.loads(body or b"{}")
    if not isinstance(payload, dict):
        raise ValueError("body must be a JSON object")
    sessions = payload.pop("sessions", None)
    if sessions is None and "version" in payload:
        sessions = [payload]
        payload = {k: v for k, v in payload.items() if k != "pages"}
    if not isinstance(sessions, list):
        raise ValueError("body needs a 'sessions' list (or one snapshot)")
    out = []
    for s in sessions:
        try:
            out.append(_mig.from_wire(s))
        except _mig.SNAPSHOT_ERRORS:
            out.append(s)
    return payload, out


class _HttpMetrics:
    """Registry handles of the HTTP layer, resolved once."""

    __slots__ = ("requests", "streams", "responses", "inflight",
                 "request_ms", "queue_expired")

    def __init__(self):
        m = _obs.metrics
        self.requests = m.counter("serving.http.requests")
        self.streams = m.counter("serving.http.streams")
        # one labeled series per status code: a bounded set
        self.responses = lambda code: m.counter("serving.http.responses",
                                                code=str(code))
        self.inflight = m.gauge("serving.http.inflight")
        self.request_ms = m.histogram("serving.http.request_ms")
        # requests retired from the inbox with 504 before dispatch
        self.queue_expired = m.counter("serving.http.queue_expired")


class _Stream:
    """Bridge between one HTTP connection (event loop side) and its engine
    request (engine thread side)."""

    __slots__ = ("trace_id", "prompt", "max_new_tokens", "q", "loop",
                 "req", "sent", "cancelled", "t_accept")

    def __init__(self, trace_id, prompt, max_new_tokens, loop):
        self.trace_id = trace_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.q: asyncio.Queue = asyncio.Queue()
        self.loop = loop
        self.req = None               # engine Request, set on engine thread
        self.sent = 0                 # tokens already pushed to the client
        self.cancelled = False
        self.t_accept = time.perf_counter()

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

    - ``slo=None`` builds a flag-configured ``SLOController``; ``False``
      disables shedding.
    - ``flight_recorder=None`` builds one and attaches its ring for the
      server's lifetime; its watchdog / SIGTERM / excepthook triggers are
      wired by ``install_crash_hooks`` (or ``serve_forever``), since signal
      handlers belong to the process owner; ``False`` runs without.
    - ``watchdog``: a ``CommTaskManager`` watching every engine step, or
      None.
    - ``sentinel=None`` builds one when ``FLAGS_serving_sentinel`` and the
      metrics are on; ``False`` disables it.
    - ``warmup=True`` drives one junk request through both step shapes on
      the engine thread before ``/readyz`` reports ready.
    - ``role`` ("mixed", "prefill" or "decode"; ``None`` reads
      ``FLAGS_serving_role``) is what ``/statusz`` advertises to a router.
    """

    def __init__(self, engine, *, model_name: str = "paddle-tpu-torch",
                 slo=None, flight_recorder=None, watchdog=None,
                 sentinel=None, poll_s: float = 0.02,
                 warmup: bool = False, role: Optional[str] = None):
        self.engine = engine
        self.model_name = model_name
        # the disaggregated-serving role advertised via /statusz: a routing
        # preference the router's phase placement reads, never an engine
        # capability (a decode replica still prefills what it is asked to)
        self.role = str(flags.flag("serving_role") if role is None
                        else role)
        if self.role not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"serving role must be mixed/prefill/decode, "
                f"got {self.role!r}")
        self._warmup = warmup
        self._ready = threading.Event()
        self.slo: Optional[SLOController] = \
            SLOController() if slo is None else (slo or None)
        self.flight_recorder: Optional[FlightRecorder] = \
            FlightRecorder() if flight_recorder is None \
            else (flight_recorder or None)
        if sentinel is None and flags.flag("serving_sentinel") \
                and _obs.metrics_enabled():
            sentinel = _obs.Sentinel(flight_recorder=self.flight_recorder)
        self.sentinel: Optional[_obs.Sentinel] = sentinel or None
        self._watchdog = watchdog     # CommTaskManager or None
        self._poll_s = poll_s
        # queue expiry: a request still in the inbox past this is retired
        # with 504 before dispatch
        self._queue_timeout_s = float(flags.flag("serving_queue_timeout_s"))
        self._inbox: "queue.SimpleQueue[_Stream]" = queue.SimpleQueue()
        # engine control operations: fn(engine) calls run on the engine
        # thread between steps (the migration endpoints use them)
        self._control: "queue.SimpleQueue" = queue.SimpleQueue()
        self._live: List[_Stream] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dead = False            # set BEFORE the final inbox sweep
        # graceful drain: once set, new completions 503 while in-flight
        # requests run to completion (bounded by
        # FLAGS_fleet_drain_timeout_s)
        self._draining = False
        self._conns_open = 0          # event-loop-side open connections
        self._t0 = time.perf_counter()
        self._engine_error: Optional[BaseException] = None
        self._next_rid = 0
        self._rid_lock = threading.Lock()
        self._m = _HttpMetrics()
        self._import_limit = _import_body_limit(engine)
        self._asyncio_server = None
        # tag of this server's lifecycle spans (several servers may share
        # a process)
        global _SERVER_SEQ
        _SERVER_SEQ += 1
        self.trace_proc = f"{self.role}-{_SERVER_SEQ}"

    # ------------------------------------------------------- lifecycle --
    def start(self) -> "ServingServer":
        """Attach the flight-recorder ring and start the engine thread."""
        if self._thread is not None:
            return self
        if self.flight_recorder is not None:
            self.flight_recorder.attach()
        self.engine.trace_proc = self.trace_proc
        self._stop.clear()
        self._dead = False
        self._draining = False
        self._ready.clear()
        self._thread = threading.Thread(target=self._engine_loop,
                                        name="serving-engine", daemon=True)
        self._thread.start()
        return self

    def ready(self) -> bool:
        """The engine thread is up, its warm-up (``warmup=True``) is done
        and the server is not draining."""
        return self.engine_alive() and self._ready.is_set() \
            and not self._draining

    # ------------------------------------------------------------- drain --
    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop admission: new completions 503 from here on; accepted
        streams and inbox submissions run to completion.  Idempotent, safe
        from any thread or signal handler (it only sets flags)."""
        self._draining = True
        self._wake.set()

    def drained(self) -> bool:
        """True once a begun drain has retired every in-flight request: no
        live streams, an empty inbox, an idle engine."""
        if not self._draining:
            return False
        if self._dead or self._thread is None:
            return True                  # engine gone: nothing to wait out
        return not self._live and self._inbox.empty() \
            and not self.engine.has_work()

    def drain(self, timeout_s: Optional[float] = None,
              poll_s: float = 0.02) -> bool:
        """Blocking graceful shutdown: stop admission, wait out in-flight
        requests bounded by ``FLAGS_fleet_drain_timeout_s`` (or
        ``timeout_s``), then close.  True when the drain completed inside
        the bound.  Call from a thread other than the event loop's."""
        self.begin_drain()
        deadline = time.perf_counter() + float(
            flags.flag("fleet_drain_timeout_s")
            if timeout_s is None else timeout_s)
        while time.perf_counter() < deadline and not self.drained():
            time.sleep(poll_s)
        ok = self.drained()
        self.close()
        return ok

    def install_drain_signal(self):
        """SIGTERM -> ``begin_drain()``, chaining any previous handler.
        Install BEFORE ``install_crash_hooks`` so the flight recorder's
        dump runs first and chains here.  Returns the previous handler
        (None off the main thread, where nothing is installed)."""
        prev = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            self.begin_drain()
            if callable(prev):
                prev(signum, frame)

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:               # not the main thread
            return None
        return prev

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
        if self.flight_recorder is not None:
            self.flight_recorder.detach()

    def install_crash_hooks(self, **kw) -> None:
        """Wire the flight recorder's watchdog / SIGTERM / excepthook dump
        triggers (a main-thread serving process)."""
        if self.flight_recorder is not None:
            self.flight_recorder.install(manager=self._watchdog, **kw)

    # ------------------------------------------------- engine control ops --
    def run_on_engine(self, fn, timeout_s: float = 30.0):
        """Run ``fn(engine)`` on the engine thread, between steps, and
        return its result: the one way for another thread to touch engine
        state.  Blocking; async handlers call it through
        ``run_in_executor``."""
        if not self.engine_alive():
            raise RuntimeError("engine thread down")
        box: dict = {}
        done = threading.Event()
        self._control.put((fn, box, done))
        self._wake.set()
        if not done.wait(timeout_s):
            raise TimeoutError(
                f"engine thread did not service the control op within "
                f"{timeout_s}s")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _body_limit(self, method: str, path: str) -> int:
        """Request body bound: a migration import carries raw KV pages, up
        to the pool's worth."""
        if method == "POST" and path.partition("?")[0] == "/migratez/import":
            return self._import_limit
        return _http.MAX_BODY

    def _run_control(self, eng) -> None:
        while True:
            try:
                fn, box, done = self._control.get_nowait()
            except queue.Empty:
                return
            try:
                box["result"] = fn(eng)
            except BaseException as e:
                box["error"] = e
            done.set()

    def export_sessions(self) -> List[dict]:
        """Snapshot every in-flight session's KV, on the engine thread
        (works while draining: exporting what a drain would strand is the
        point)."""
        from ..inference import migration as _mig
        return self.run_on_engine(_mig.export_all)

    def import_sessions(self, snaps: List[dict],
                        resume: bool = False) -> dict:
        """Install exported session snapshots into this server's prefix
        cache, on the engine thread.  Raises MigrationError when the engine
        has no prefix cache."""
        from ..inference import migration as _mig
        if self.engine.prefix_cache is None:
            raise _mig.MigrationError(
                "import needs the prefix cache (FLAGS_prefix_cache) on "
                "the successor replica")

        def op(eng):
            return _mig.import_sessions(eng, snaps, resume=resume)

        return self.run_on_engine(op, timeout_s=600.0)

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
        # _dead flips (before the final sweep) the moment the loop stops
        # serving, so liveness changes with the sweep's retirements
        return self._thread is not None and self._thread.is_alive() \
            and not self._dead

    def _engine_loop(self) -> None:
        eng = self.engine
        wd = self._watchdog
        fr = self.flight_recorder
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
                self._run_control(eng)
                if self._queue_timeout_s > 0 and self._live:
                    # a request admission has not picked up inside the
                    # bound is retired before its prefill is spent; an
                    # admitted one runs out
                    now = time.perf_counter()
                    for h in list(self._live):
                        if h.req is not None and not h.req.done and \
                                now - h.t_accept > self._queue_timeout_s \
                                and eng.cancel_waiting(h.req):
                            self._m.queue_expired.inc()
                            self._live.remove(h)
                            h.post(("done",
                                    {"finish_reason": "queue_expired",
                                     "n": 0}))
                if eng.has_work():
                    if wd is not None:
                        tid = wd.begin("serving.engine_step")
                        try:
                            eng.step()
                        finally:
                            wd.end(tid)
                    else:
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
                if fr is not None:
                    fr.maybe_snapshot()
                if self.sentinel is not None:
                    # host-side registry reads only, time-gated
                    self.sentinel.maybe_check()
        except Exception as e:
            # the engine died mid-serve: dump, then retire every waiter
            # with 'error' instead of leaving handlers hanging
            finish = "error"
            self._engine_error = e
            print(f"[paddle_tpu_torch serving] engine thread died: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            traceback.print_exc()
            if fr is not None:
                fr.dump(reason=f"engine-crash-{type(e).__name__}")
        finally:
            # _dead first: a handler that enqueues after this sweep sees it
            # and retires its own stream
            self._dead = True
            while True:
                try:
                    self._live.append(self._inbox.get_nowait())
                except queue.Empty:
                    break
            # fail queued control ops so their callers do not wait out
            # the timeout against a dead thread
            while True:
                try:
                    _fn, box, done = self._control.get_nowait()
                except queue.Empty:
                    break
                box["error"] = RuntimeError("engine thread down")
                done.set()
            for h in list(self._live):
                h.post(("done", {"finish_reason": finish,
                                 "n": len(h.req.output) if h.req else 0}))
            self._live.clear()

    def _warm(self) -> None:
        """Drive one deterministic junk request through the T=bucket mixed
        step and the T=1 decode step (and build the kernels) before
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
        t0 = time.perf_counter()
        status = 500
        # counted from accept, so responses{code} never outruns requests
        self._m.requests.inc()
        self._m.inflight.inc(1)
        self._conns_open += 1
        try:
            try:
                method, path, headers, body = await _http.read_request(
                    reader, body_limit=self._body_limit)
            except _http.HttpError as e:
                status = e.status
                writer.write(_http.error_response(e.status, e.message))
                await writer.drain()
                return
            status = await self._route(method, path, headers, body, writer)
        except (ConnectionError, asyncio.IncompleteReadError):
            status = 499              # client went away mid-stream
        except Exception as e:
            try:
                writer.write(_http.error_response(
                    500, f"{type(e).__name__}: {e}",
                    err_type="internal_error"))
                await writer.drain()
            except Exception:
                pass
        finally:
            self._conns_open -= 1
            self._m.inflight.inc(-1)
            self._m.responses(status).inc()
            self._m.request_ms.observe((time.perf_counter() - t0) * 1e3)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _route(self, method, path, headers, body, writer) -> int:
        path, _, query = path.partition("?")
        if path == "/drainz" and method == "POST":
            # SIGTERM's HTTP twin: stop admission now and report what is
            # still in flight (/statusz says when it is drained)
            self.begin_drain()
            writer.write(_http.json_response(200, {
                "draining": True,
                "streams_live": len(self._live),
                "waiting": len(self.engine.waiting),
                "drained": self.drained()}))
            await writer.drain()
            return 200
        if path == "/metrics" and method == "GET":
            text = _obs.prometheus_text().encode()
            writer.write(_http.response(
                200, text, content_type="text/plain; version=0.0.4"))
            await writer.drain()
            return 200
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
                   "draining" if self._draining and self.engine_alive()
                   else "engine warmup in progress"
                   if self.engine_alive() else "engine thread down")
            writer.write(_http.json_response(
                200 if ready else 503, {"ready": ready, "status": why}))
            await writer.drain()
            return 200 if ready else 503
        if path == "/statusz" and method == "GET":
            # ?digest_since=<gen>:<epoch> asks for the prefix digest's
            # changes since a confirmed epoch instead of the full set
            since = None
            if query:
                from urllib.parse import parse_qs
                since = (parse_qs(query).get("digest_since")
                         or [None])[0]
            writer.write(_http.json_response(
                200, self.statusz(digest_since=since)))
            await writer.drain()
            return 200
        if path == "/migratez/export" and method == "POST":
            return await self._migrate_export(body, writer)
        if path == "/migratez/import" and method == "POST":
            return await self._migrate_import(body, writer)
        if path == "/v1/completions" and method == "POST":
            return await self._completions(headers, body, writer)
        if path in ("/metrics", "/healthz", "/readyz", "/statusz",
                    "/v1/completions", "/drainz", "/migratez/export",
                    "/migratez/import"):
            writer.write(_http.error_response(405, f"{method} not allowed"))
            await writer.drain()
            return 405
        writer.write(_http.error_response(404, f"no route {path}"))
        await writer.drain()
        return 404

    # ------------------------------------------------- session migration --
    @staticmethod
    def _json_body(body):
        payload = json.loads(body.decode() or "{}")
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
        return payload

    async def _migrate_export(self, body, writer) -> int:
        """``POST /migratez/export``: ``{"req_id": N}`` one in-flight
        session, ``{"tokens": [...]}`` a parked session's prefix chain,
        ``{"all": true}`` every in-flight session.  Runs on the engine
        thread; allowed while draining.  The snapshots are assembled before
        the first response byte and an export changes no allocator
        state."""
        from ..inference import migration as _mig
        try:
            payload = self._json_body(body)
        except (ValueError, UnicodeDecodeError) as e:
            writer.write(_http.error_response(400, f"bad JSON body: {e}"))
            await writer.drain()
            return 400
        if not self.engine_alive():
            writer.write(_http.error_response(
                503, "engine thread down", err_type="internal_error"))
            await writer.drain()
            return 503

        def op(eng):
            if payload.get("all"):
                snaps = _mig.export_all(eng)
            elif "req_id" in payload:
                snaps = [_mig.export_session(
                    eng, req_id=int(payload["req_id"]))]
            elif "tokens" in payload:
                snaps = [_mig.export_session(
                    eng, tokens=list(payload["tokens"]))]
            else:
                raise _mig.MigrationError(
                    "body needs one of req_id / tokens / all")
            return [_mig.to_wire(s) for s in snaps]

        t0 = time.perf_counter()
        loop = asyncio.get_running_loop()
        try:
            snaps = await loop.run_in_executor(
                None, self.run_on_engine, op)
        except (_mig.MigrationError, ValueError, TypeError) as e:
            writer.write(_http.error_response(400, str(e)))
            await writer.drain()
            return 400
        except Exception as e:
            writer.write(_http.error_response(
                503, f"export failed: {type(e).__name__}: {e}",
                err_type="internal_error"))
            await writer.drain()
            return 503
        # the caller's trace id joins the export to its request's lane
        trace_id = payload.get("trace_id")
        if isinstance(trace_id, str) and trace_id and _TRACE_ID_OK(trace_id):
            for s in snaps:
                if not s.get("trace_id"):
                    s["trace_id"] = trace_id
        else:
            trace_id = next((s.get("trace_id") for s in snaps
                             if s.get("trace_id")), None)
        if _obs.TRACER.enabled and trace_id:
            _obs.TRACER.event("migrate.export", t0,
                              time.perf_counter() - t0, cat="migration",
                              tid=trace_id,
                              args={"trace_id": trace_id,
                                    "proc": self.trace_proc,
                                    "sessions": len(snaps)})
        writer.write(_http.json_response(200, {"sessions": snaps}))
        await writer.drain()
        return 200

    async def _migrate_import(self, body, writer) -> int:
        """``POST /migratez/import``: install exported snapshots
        (``{"sessions": [...]}`` or one bare snapshot) into this server's
        prefix cache; ``"resume": true`` also submits each session's
        continuation.  The body is parsed and its planes decoded on a
        worker thread, so the event loop keeps serving streams; the digest
        check and the install run on the engine thread.
        A truncated body fails JSON parsing (400, nothing installed); a
        partial page list imports a shorter contiguous chain."""
        from ..inference import migration as _mig
        loop = asyncio.get_running_loop()
        try:
            payload, sessions = await loop.run_in_executor(
                None, _decode_import, body)
        except ValueError as e:
            writer.write(_http.error_response(400, f"bad body: {e}"))
            await writer.drain()
            return 400
        if self._draining:
            writer.write(_http.error_response(
                503, "draining: this replica is leaving and cannot adopt "
                     "sessions", err_type="overloaded_error"))
            await writer.drain()
            return 503
        if not self.engine_alive():
            writer.write(_http.error_response(
                503, "engine thread down", err_type="internal_error"))
            await writer.drain()
            return 503
        resume = bool(payload.get("resume", False))
        # the caller's trace id: a resumed continuation inherits the lane
        trace_id = payload.get("trace_id")
        if isinstance(trace_id, str) and trace_id and _TRACE_ID_OK(trace_id):
            for s in sessions:
                if isinstance(s, dict) and not s.get("trace_id"):
                    s["trace_id"] = trace_id
        else:
            trace_id = next((s.get("trace_id") for s in sessions
                             if isinstance(s, dict) and s.get("trace_id")),
                            None)
        t0 = time.perf_counter()
        try:
            result = await loop.run_in_executor(
                None, self.import_sessions, sessions, resume)
        except _mig.MigrationError as e:
            writer.write(_http.error_response(409, str(e)))
            await writer.drain()
            return 409
        except Exception as e:
            writer.write(_http.error_response(
                503, f"import failed: {type(e).__name__}: {e}",
                err_type="internal_error"))
            await writer.drain()
            return 503
        if payload.get("handoff"):
            _mig.record_handoff(sessions, result)
        if _obs.TRACER.enabled and trace_id:
            _obs.TRACER.event("migrate.import", t0,
                              time.perf_counter() - t0, cat="migration",
                              tid=trace_id,
                              args={"trace_id": trace_id,
                                    "proc": self.trace_proc,
                                    "resume": resume,
                                    "handoff": bool(payload.get("handoff")),
                                    "sessions": len(sessions)})
        writer.write(_http.json_response(200, result))
        await writer.drain()
        return 200

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
            payload = self._json_body(body)
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
        stream = bool(payload.get("stream", False))

        if self._draining:
            # admission closed, in-flight requests finishing: a client
            # retries elsewhere (jittered, so clients do not re-herd)
            ra = jittered_retry_after(2)
            writer.write(_http.error_response(
                503, "draining: admission closed, in-flight requests "
                     "finishing (see /statusz)",
                err_type="overloaded_error",
                extra_headers=(("Retry-After", str(ra)),),
                fields={"retry_after_s": ra}))
            await writer.drain()
            return 503

        if not self.engine_alive():
            why = (f": {type(self._engine_error).__name__}"
                   if self._engine_error is not None else "")
            writer.write(_http.error_response(
                503, f"engine thread down{why}", err_type="internal_error"))
            await writer.drain()
            return 503

        # SLO-driven admission: histogram burn, not queue length; the
        # Retry-After comes from the live burn window and is mirrored into
        # the JSON body
        if self.slo is not None and self.slo.decide() == SHED:
            ra = self.slo.retry_after_s()
            writer.write(_http.error_response(
                503, "shedding load: serving latency SLO burn "
                     "(see /statusz)", err_type="overloaded_error",
                extra_headers=(("Retry-After", str(ra)),),
                fields={"retry_after_s": ra}))
            await writer.drain()
            return 503

        trace_id = self._trace_id(headers)
        h = _Stream(trace_id, prompt, max_tokens,
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
                self._m.streams.inc()
                code = await self._stream_response(h, writer)
            else:
                code = await self._unary_response(h, writer)
        except BaseException:
            h.cancelled = True        # nobody reads this queue any more
            raise
        if _obs.TRACER.enabled:
            _obs.TRACER.event("http.request", h.t_accept,
                              time.perf_counter() - h.t_accept,
                              cat="serving", tid=trace_id,
                              args={"trace_id": trace_id,
                                    "stream": stream,
                                    "proc": self.trace_proc,
                                    "prompt_tokens": len(prompt)})
        return code

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
        if finish == "queue_expired":
            # retired from the inbox before dispatch: no prefill spent
            writer.write(_http.error_response(
                504, "request expired in queue before dispatch "
                     f"(FLAGS_serving_queue_timeout_s="
                     f"{self._queue_timeout_s})",
                err_type="timeout_error",
                extra_headers=(("X-Request-Id", h.trace_id),)))
            await writer.drain()
            return 504
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

    # ----------------------------------------------------------- status --
    def statusz(self, digest_since: Optional[str] = None) -> dict:
        """Engine, pool and prefix-cache state, kernel-build stats, SLO
        burn, latency quantiles, the hung-request table, the step cost
        table, anomalies, the flight recorder, build and flag info.
        ``digest_since`` asks for a prefix-digest delta against a confirmed
        ``<gen>:<epoch>``."""
        import torch

        from ..inference.prefix_cache import serving_stats
        eng = self.engine
        dev = eng.g.device
        out = {
            "uptime_s": round(time.perf_counter() - self._t0, 3),
            "model": self.model_name,
            "role": self.role,
            "ready": self.ready(),
            "draining": self._draining,
            "drained": self.drained(),
            "engine": {
                **eng.last_stats,
                "waiting": len(eng.waiting),
                "slots_busy": sum(r is not None for r in eng.slot_req),
                "slots": eng.B,
                "streams_live": len(self._live),
                # capacity advertisement, explicit so that it never waits
                # on a drain to refresh last_stats: the router's
                # capacity_score reads both
                "tp": eng.g.tp,
                "pool_bytes": eng.g.pool_bytes,
                # greedy continuations are exact anywhere; sampled ones on
                # an engine with this exact positional config
                "sampling": {"do_sample": bool(eng.gen_cfg.do_sample),
                             "seed": int(eng.gen_cfg.seed),
                             "temperature": float(
                                 eng.gen_cfg.temperature),
                             "top_k": int(eng.gen_cfg.top_k),
                             "top_p": float(eng.gen_cfg.top_p),
                             "positional": True},
            },
            # which prefixes this replica holds, as chain hashes: the full
            # set, or the changes since `digest_since`
            "prefix_digest": eng.prefix_digest(since=digest_since),
            "slo": self.slo.state() if self.slo is not None else None,
            "latency": self._latency_summaries(),
            "inflight_requests": eng.inflight_requests(),
            "attribution": eng.attribution.baselines()
            if eng.attribution is not None else None,
            "anomalies": self.sentinel.state()
            if self.sentinel is not None else None,
            "flight_recorder": None,
            "jit_cache": {"jit": {"backend_compiles":
                                  _obs.backend_compiles()},
                          "serving": serving_stats()},
            "build": {
                "torch": torch.__version__,
                "device": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else str(dev),
                "python": sys.version.split()[0],
                "pid": os.getpid(),
            },
            "flags": flags.get_flags(),
        }
        fr = self.flight_recorder
        if fr is not None:
            out["flight_recorder"] = {
                "ring_events": len(fr._ring),
                "ring_capacity": fr.max_events,
                "last_dump": fr.last_dump,
                "dumps": int(_obs.metrics.counter(
                    "flight_recorder.dumps").value),
                "suppressed": int(_obs.metrics.counter(
                    "flight_recorder.suppressed_dumps").value),
                "min_interval_s": fr.min_interval_s,
            }
        return out

    @staticmethod
    def _latency_summaries() -> dict:
        """p50/p95/p99 per latency series (every label set, the per-phase
        ``serving.step_ms{phase=...}`` family included)."""
        from ..observability.metrics import _series_name
        out = {}
        for fam in ("serving.ttft_ms", "serving.itl_ms",
                    "serving.queue_wait_ms", "serving.step_ms"):
            for h in _obs.REGISTRY.find(fam, "histogram"):
                s = h.summary()
                out[_series_name(h.name, h.labels)] = {
                    k: s[k] for k in ("count", "p50", "p95", "p99")}
        return out


async def _serve_async(server: ServingServer, host: str, port: int):
    bound = await server.start_http(host, port)
    print(f"[paddle_tpu_torch serving] listening on "
          f"http://{bound[0]}:{bound[1]}  (/v1/completions, /metrics, "
          f"/healthz, /readyz, /statusz, /drainz, /migratez)", flush=True)
    try:
        while not server.draining:
            await asyncio.sleep(0.1)
        # SIGTERM (or /drainz) began a drain: wait out in-flight requests
        # bounded by FLAGS_fleet_drain_timeout_s, then give the handlers a
        # short grace to flush their final frames
        deadline = time.perf_counter() + float(
            flags.flag("fleet_drain_timeout_s"))
        while time.perf_counter() < deadline and not server.drained():
            await asyncio.sleep(0.05)
        t_flush = time.perf_counter()
        while time.perf_counter() - t_flush < 2.0 and server._conns_open:
            await asyncio.sleep(0.02)
        print("[paddle_tpu_torch serving] drain "
              f"{'complete' if server.drained() else 'TIMED OUT'}; "
              "shutting down", flush=True)
    finally:
        await server.stop_http()


def serve_forever(engine, *, host: str = "127.0.0.1", port: int = 8000,
                  **kw) -> None:
    """Blocking entry: build the server, wire the SIGTERM graceful drain
    and the crash hooks (watchdog, SIGTERM and excepthook flight-recorder
    dumps; the dump runs first, then chains into the drain) with the
    process's step watchdog, and serve until drained or interrupted.
    SIGTERM is a bounded drain: admission stops, in-flight requests finish
    (up to ``FLAGS_fleet_drain_timeout_s``), exit code 0."""
    from ..distributed.watchdog import get_comm_task_manager
    kw.setdefault("watchdog", get_comm_task_manager())
    server = ServingServer(engine, **kw)
    server.start()
    server.install_drain_signal()     # before the crash hooks: dump first
    server.install_crash_hooks()
    # fleet span export: with a collector address set (the fleet launcher
    # passes its router's host:port down as --set trace_collector=...),
    # ship this replica's spans by HTTP POST /collectz from a host daemon
    # thread, off the dispatch path (warm steps still make no sync)
    exporter = None
    addr = str(flags.flag("trace_collector"))
    if addr and float(flags.flag("trace_sample_rate")) > 0:
        from ..observability.collector import HttpTransport, SpanExporter
        exporter = SpanExporter(
            HttpTransport(addr),
            proc=f"{server.trace_proc}@{host}:{port}",
            role=server.role).start()
    try:
        asyncio.run(_serve_async(server, host, port))
    except KeyboardInterrupt:
        pass
    finally:
        if exporter is not None:
            exporter.close()
        server.close()
