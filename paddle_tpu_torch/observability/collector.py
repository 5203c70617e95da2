"""Fleet-wide distributed tracing: span export, clock-aligned assembly and
end-to-end request timelines (port of
``paddle_tpu/observability/collector.py``).

A request crosses processes (router -> one-hop forward -> prefill replica ->
``/migratez`` handoff -> decode replica -> a journal replay or a cross-router
takeover), and each process's tracer sees only its own part.  This module
joins them:

- ``SpanExporter``: the per-process shipper.  The tracer offers every event
  into a bounded ring (one deque append; it never blocks the engine or the
  event loop); a host daemon thread batches, samples (a stable per-trace
  hash against ``FLAGS_trace_sample_rate``; anomalous, shed, failover and
  handoff traces are kept whatever the rate) and ships over a transport.
- Transports: ``InprocTransport`` (a direct ``ingest``), ``StoreTransport``
  (the control-plane store: ``trace/batch/*`` keys the supervisor drains),
  ``HttpTransport`` (POST ``/collectz`` on the router or fleet launcher).
- ``ClockSync``: an NTP-style offset handshake.  The exporter brackets a
  collector clock read (t0, t_server, t1) and keeps the midpoint estimate
  ``t_server - (t0+t1)/2`` of the tightest round trip, taking a fresh one
  when it drifts past what round-trip jitter explains
  (``FLAGS_trace_clock_drift_ms``).
- ``TraceCollector``: the supervisor's assembly.  It groups aligned spans by
  the X-Trace-Id lane and renders one merged Chrome-trace / Perfetto
  timeline a request (one track a process, flow events stitching router
  dispatch -> replica admit -> handoff export -> import -> decode) with a
  critical-path breakdown (queue / prefill / transfer / decode / replay)
  stamped as ``serving.trace.critical_path_ms{phase=}``.  Sentinel anomaly
  spans in a batch trigger a fleet-correlated dump: the registered
  flight-recorder rings of every live in-process component and the
  collector's own spans for the window, merged into one file.

Batches, lanes and assembled documents have the reference's shapes, so a
collector of either package ingests the other's batches.  Everything here is
host code off the dispatch path: span args are host values, and warm engine
steps make no device sync with export on.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from .. import flags
from . import metrics as _metrics
from .tracing import TRACER

__all__ = ["ClockSync", "SpanExporter", "TraceCollector",
           "InprocTransport", "StoreTransport", "HttpTransport",
           "STORE_BATCH_PREFIX", "STORE_CLOCK_KEY"]

# store-transport keyspace (the control-plane store)
STORE_BATCH_PREFIX = "trace/batch/"
# virtual key the store answers with its own perf_counter reading — the
# round trip the NTP-style handshake brackets when shipping via the store
STORE_CLOCK_KEY = "__now__"

# substrings marking a span/trace as tail-keep: these traces ship even
# when sampled out (the interesting 1% is exactly the part a sampled
# fleet must never lose)
_KEEP_MARKERS = ("anomaly", "handoff", "failover", "shed", "takeover",
                 "quarantine", "breaker", "resume", "migrate")

# critical-path phases, the bounded label enum for
# serving.trace.critical_path_ms{phase=}
_PHASES = ("queue", "prefill", "transfer", "decode", "replay")


def _keep_event(ev: dict) -> bool:
    """True when ``ev`` marks its trace as tail-keep (anomalous / shed /
    failover / handoff / takeover...)."""
    hay = ev.get("name", "") + "|" + ev.get("cat", "")
    args = ev.get("args")
    if isinstance(args, dict):
        for k in ("outcome", "reason", "kind", "verdict"):
            v = args.get(k)
            if isinstance(v, str):
                hay += "|" + v
    hay = hay.lower()
    return any(m in hay for m in _KEEP_MARKERS)


def _sampled(trace_id: str, rate: float) -> bool:
    """Stable per-trace sampling decision: every process keeps or drops
    the SAME traces (hash of the trace id, not a coin flip)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) / 2**32 < rate


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------

class ClockSync:
    """NTP-style midpoint offset estimator between one process's
    ``perf_counter`` domain and the collector's.

    Each ``observe(t0, t_server, t1)`` sample brackets a collector clock
    read: the midpoint estimate is ``t_server - (t0+t1)/2`` with
    uncertainty ±rtt/2.  The estimator keeps the tightest-round-trip
    sample (minimum rtt = minimum uncertainty) and re-adopts a fresh
    measurement when it drifts beyond what its own round-trip jitter
    explains — ``|new - held| > drift_threshold + rtt/2`` — counting the
    resync so a wandering clock is visible telemetry, not silent skew.
    """

    def __init__(self, drift_s: Optional[float] = None):
        self._drift_s = drift_s
        self.offset = 0.0            # seconds to ADD to local timestamps
        self.rtt: Optional[float] = None
        self.samples = 0
        self.resyncs = 0

    def _threshold(self) -> float:
        if self._drift_s is not None:
            return self._drift_s
        return float(flags.flag("trace_clock_drift_ms")) / 1e3

    def observe(self, t0: float, t_server: float, t1: float) -> float:
        rtt = max(t1 - t0, 0.0)
        off = t_server - (t0 + t1) / 2.0
        self.samples += 1
        if self.rtt is None or rtt <= self.rtt:
            # tighter (or first) measurement: strictly better, adopt
            self.offset, self.rtt = off, rtt
        elif abs(off - self.offset) > self._threshold() + rtt / 2.0:
            # looser round trip but the disagreement exceeds what its
            # jitter explains: the clock really moved — re-estimate
            self.offset, self.rtt = off, rtt
            self.resyncs += 1
        return self.offset


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class InprocTransport:
    """Direct in-process transport: exporter -> collector method calls
    (tests, benches, and the fleet launcher's own process)."""

    def __init__(self, collector: "TraceCollector"):
        self.collector = collector

    def clock(self) -> Optional[float]:
        return self.collector.now()

    def send(self, batch: dict) -> None:
        self.collector.ingest(batch)


class StoreTransport:
    """Ship batches through the control-plane store: one
    ``trace/batch/<proc>/<seq>`` key per batch (TTL-bounded so a dead
    collector never leaks them), drained by the supervisor's
    ``TraceCollector.poll_store``.  The clock handshake brackets a read
    of the store's virtual ``__now__`` key — the store server lives in
    the collector's process, so its clock IS the collector clock."""

    _TTL_S = 120.0

    def __init__(self, store):
        self.store = store           # sync face: set/get (StoreState or
        #                              SyncStoreClient)

    def clock(self) -> Optional[float]:
        try:
            found, doc = self.store.get(STORE_CLOCK_KEY)
        except Exception:
            return None
        if found and isinstance(doc, dict):
            return doc.get("t")
        return None

    def send(self, batch: dict) -> None:
        key = f"{STORE_BATCH_PREFIX}{batch['proc']}/{batch['seq']}"
        self.store.set(key, batch, ttl=self._TTL_S)


class HttpTransport:
    """Direct HTTP POST to the collector's ingest endpoint
    (``POST /collectz`` on the router / fleet launcher) for processes
    with no control-plane store configured.  Blocking by design: it only
    ever runs on the exporter's own daemon thread."""

    def __init__(self, addr: str, timeout_s: float = 5.0):
        host, _, port = addr.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.timeout_s = timeout_s

    def _post(self, doc: dict) -> Optional[dict]:
        import http.client
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            body = json.dumps(doc).encode()
            conn.request("POST", "/collectz", body=body,
                         headers={"Content-Type": "application/json",
                                  "Content-Length": str(len(body))})
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                raise OSError(f"collector returned {resp.status}")
            return json.loads(raw) if raw else None
        finally:
            conn.close()

    def clock(self) -> Optional[float]:
        try:
            doc = self._post({"op": "clock"})
        except Exception:
            return None
        return doc.get("t") if isinstance(doc, dict) else None

    def send(self, batch: dict) -> None:
        self._post(batch)


# ---------------------------------------------------------------------------
# per-process span exporter
# ---------------------------------------------------------------------------

class _ExporterMetrics:
    """Registry handles resolved once."""

    __slots__ = ("batches", "spans", "dropped", "sampled_out", "errors",
                 "resyncs")

    def __init__(self):
        m = _metrics
        self.batches = m.counter("observability.collector.export_batches")
        self.spans = m.counter("observability.collector.export_spans")
        self.dropped = m.counter("observability.collector.export_dropped")
        self.sampled_out = m.counter("observability.collector.sampled_out")
        self.errors = m.counter("observability.collector.export_errors")
        self.resyncs = m.counter("observability.collector.clock_resyncs")


class SpanExporter:
    """Bounded, non-blocking span shipper for one process.

    ``offer`` (called by the tracer on engine / event-loop threads) is a
    single deque append — overflow evicts oldest and counts
    ``observability.collector.export_dropped``.  A daemon thread flushes
    every ``FLAGS_trace_export_interval_s``: it re-measures the clock
    offset, groups pending events by trace lane, applies per-trace
    sampling (``FLAGS_trace_sample_rate``) with tail-keep for marked
    traces (sticky per lane: once a trace shows an anomaly / handoff /
    shed / failover span, its later spans ship too), and sends batches of
    at most ``FLAGS_trace_export_batch`` events.
    """

    def __init__(self, transport, *, proc: str, role: str = "",
                 tracer=TRACER, clock=time.perf_counter,
                 interval_s: Optional[float] = None,
                 max_events: Optional[int] = None,
                 batch: Optional[int] = None,
                 sample_rate: Optional[float] = None):
        self.transport = transport
        self.proc = proc
        self.role = role
        self._tracer = tracer
        self._clock = clock
        self._interval_s = interval_s
        self._batch = batch
        self._rate = sample_rate
        cap = int(flags.flag("trace_export_events")
                  if max_events is None else max_events)
        self._buf: collections.deque = collections.deque(maxlen=cap)
        self._keep_lanes: set = set()        # sticky tail-keep trace ids
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.clock_sync = ClockSync()
        self._m = _ExporterMetrics()

    # ------------------------------------------------------ tracer sink --
    def offer(self, ev: dict) -> None:
        """Tracer -> exporter handoff; one bounded append, never blocks."""
        buf = self._buf
        if len(buf) == buf.maxlen:
            self._m.dropped.inc()
        buf.append(ev)

    # ------------------------------------------------------- lifecycle --
    def start(self) -> "SpanExporter":
        """Attach to the tracer and start the flush thread."""
        if self._thread is not None:
            return self
        self._tracer.attach_export(self)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="span-exporter", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Detach, stop the flush thread, ship what remains."""
        self._tracer.detach_export()
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None
        self.flush()

    def _run(self) -> None:
        interval = float(flags.flag("trace_export_interval_s")
                         if self._interval_s is None else self._interval_s)
        while not self._stop.wait(interval):
            self.probe_clock()
            self.flush()

    # ----------------------------------------------------------- flush --
    def probe_clock(self) -> None:
        """One NTP-style handshake sample: bracket a collector clock read
        with local timestamps and fold the midpoint into the estimator."""
        t0 = self._clock()
        try:
            ts = self.transport.clock()
        except Exception:
            ts = None
        t1 = self._clock()
        if ts is None:
            return
        before = self.clock_sync.resyncs
        self.clock_sync.observe(t0, ts, t1)
        if self.clock_sync.resyncs != before:
            self._m.resyncs.inc()

    def flush(self) -> int:
        """Drain pending events, sample per trace, ship.  Returns the
        number of events shipped."""
        buf = self._buf
        pending: List[dict] = []
        while True:
            try:
                pending.append(buf.popleft())
            except IndexError:
                break
        if not pending:
            return 0
        rate = float(flags.flag("trace_sample_rate")
                     if self._rate is None else self._rate)
        lanes = self._tracer.lane_names()
        # first pass: any keep-marked event makes its whole lane sticky
        for ev in pending:
            if _keep_event(ev):
                lane = lanes.get(ev.get("tid"))
                if lane is not None:
                    self._keep_lanes.add(lane)
        out: List[dict] = []
        for ev in pending:
            if ev.get("ph") == "M":
                continue                     # lane map ships separately
            lane = lanes.get(ev.get("tid"))
            if lane is None:
                # unnamed lane (thread-ident / counter tracks): process-
                # local unless the event itself is a keep marker (the
                # sentinel's anomaly instants must reach the collector)
                if not _keep_event(ev):
                    continue
            elif lane not in self._keep_lanes \
                    and not _sampled(lane, rate):
                self._m.sampled_out.inc()
                continue
            out.append(ev)
        if not out:
            return 0
        # bound sticky lane memory alongside the tracer's own lane cap
        if len(self._keep_lanes) > self._tracer.MAX_NAMED_LANES:
            self._keep_lanes.clear()
        shipped = 0
        size = int(flags.flag("trace_export_batch")
                   if self._batch is None else self._batch)
        for i in range(0, len(out), max(size, 1)):
            chunk = out[i:i + max(size, 1)]
            tids = {ev.get("tid") for ev in chunk}
            batch = {"proc": self.proc, "pid": os.getpid(),
                     "role": self.role, "seq": self._seq,
                     "offset_us": self.clock_sync.offset * 1e6,
                     "rtt_us": (self.clock_sync.rtt or 0.0) * 1e6,
                     "lanes": {str(t): n for t, n in lanes.items()
                               if t in tids},
                     "events": chunk}
            self._seq += 1
            try:
                self.transport.send(batch)
            except Exception:
                self._m.errors.inc()
                continue
            self._m.batches.inc()
            self._m.spans.inc(len(chunk))
            shipped += len(chunk)
        return shipped


# ---------------------------------------------------------------------------
# the fleet collector
# ---------------------------------------------------------------------------

class _CollectorMetrics:
    __slots__ = ("batches", "spans", "traces", "processes", "fleet_dumps")

    def __init__(self):
        m = _metrics
        self.batches = m.counter("observability.collector.batches")
        self.spans = m.counter("observability.collector.spans")
        self.traces = m.gauge("observability.collector.traces")
        self.processes = m.gauge("observability.collector.processes")
        self.fleet_dumps = m.counter("observability.collector.fleet_dumps")


class TraceCollector:
    """Supervisor-owned span store + timeline assembler.

    ``ingest(batch)`` aligns each event into the collector's clock domain
    (the batch carries its process's midpoint offset) and indexes it by
    trace id (the lane name = the request's X-Trace-Id).  ``assemble``
    renders one merged Chrome-trace JSON per request — one track per
    process, flow events stitching the dispatch -> admit -> export ->
    import -> decode chain — plus the critical-path breakdown.  Anomaly
    spans arriving in any batch trigger a rate-limited fleet-correlated
    dump of every registered flight-recorder ring.
    """

    MAX_TRACE_EVENTS = 4096          # per-trace span cap (oldest kept)

    def __init__(self, *, clock=time.perf_counter, max_traces: int = 1024):
        self._clock = clock
        self._max_traces = max_traces
        self._lock = threading.Lock()
        self._traces: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._procs: Dict[str, dict] = {}
        self._rings: Dict[str, Callable[[], List[dict]]] = {}
        self._loose: collections.deque = collections.deque(maxlen=1024)
        self._last_fleet_dump = -float("inf")
        self._store_seen: Dict[str, int] = {}
        self._m = _CollectorMetrics()

    # ------------------------------------------------------------ clock --
    def now(self) -> float:
        """The collector's clock — the timeline every process aligns to."""
        return self._clock()

    # ----------------------------------------------------------- ingest --
    def ingest(self, batch: dict) -> dict:
        """Fold one export batch in; returns ``{"t": now}`` so transports
        can piggyback a handshake timestamp on the response."""
        proc = str(batch.get("proc", "?"))
        off_us = float(batch.get("offset_us", 0.0))
        lanes = batch.get("lanes") or {}
        events = batch.get("events") or []
        anomaly = False
        with self._lock:
            self._procs[proc] = {
                "pid": batch.get("pid"), "role": batch.get("role", ""),
                "offset_us": off_us,
                "rtt_us": float(batch.get("rtt_us", 0.0)),
                "seq": batch.get("seq"), "last_seen": self.now()}
            self._m.processes.set(len(self._procs))
            for ev in events:
                ev2 = dict(ev)
                if "ts" in ev2:
                    ev2["ts"] = float(ev2["ts"]) + off_us
                args = ev2.get("args") or {}
                sub = args.get("proc") if isinstance(args, dict) else None
                ev2["_track"] = (proc, str(sub) if sub else proc)
                lane = lanes.get(str(ev.get("tid")))
                if _keep_event(ev2) and "anomaly" in \
                        (ev2.get("name", "") + ev2.get("cat", "")).lower():
                    anomaly = True
                if lane is None:
                    self._loose.append(ev2)
                    continue
                rec = self._traces.get(lane)
                if rec is None:
                    rec = {"events": [], "dropped": 0}
                    self._traces[lane] = rec
                    while len(self._traces) > self._max_traces:
                        self._traces.popitem(last=False)
                self._traces.move_to_end(lane)
                if len(rec["events"]) >= self.MAX_TRACE_EVENTS:
                    rec["dropped"] += 1
                else:
                    rec["events"].append(ev2)
            self._m.traces.set(len(self._traces))
        self._m.batches.inc()
        self._m.spans.inc(len(events))
        if anomaly:
            self.fleet_dump(reason="anomaly")
        return {"t": self.now()}

    def poll_store(self, store) -> int:
        """Drain ``trace/batch/*`` keys from the control-plane store's
        sync face (the supervisor tick calls this when a store is
        configured).  Returns ingested batch count."""
        try:
            members = store.members(STORE_BATCH_PREFIX)
        except Exception:
            return 0
        n = 0
        for key in sorted(members):
            doc = members[key]
            if isinstance(doc, dict) and "events" in doc:
                self.ingest(doc)
                n += 1
            try:
                store.delete(key)
            except Exception:
                pass
        return n

    # ------------------------------------------------------- inspection --
    def traces(self) -> List[str]:
        """Known trace ids, most recently touched last."""
        with self._lock:
            return list(self._traces)

    def processes(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._procs.items()}

    def track_names(self, trace_id: str) -> List[str]:
        """Sorted ``proc/subproc`` track labels present in one trace —
        how many distinct components contributed spans (harness seam:
        pick the most fleet-crossing trace without a full assemble)."""
        with self._lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                return []
            return sorted({f"{p}/{s}" for p, s in
                           (ev["_track"] for ev in rec["events"])})

    def find_traces(self, marker: str) -> List[str]:
        """Trace ids containing an event whose name or cat holds
        ``marker`` (bench/harness seam: pick a handed-off stream's
        timeline out of the run without assembling every trace)."""
        m = marker.lower()
        out = []
        with self._lock:
            for tid, rec in self._traces.items():
                for ev in rec["events"]:
                    if m in str(ev.get("name", "")).lower() or \
                            m in str(ev.get("cat", "")).lower():
                        out.append(tid)
                        break
        return out

    # --------------------------------------------------------- assembly --
    @staticmethod
    def _phase_of(name: str) -> Optional[str]:
        if name.endswith(".queued") or name == "serving.queue":
            return "queue"
        if name.endswith(".prefill"):
            return "prefill"
        if name.endswith(".decode"):
            return "decode"
        if name.startswith("migrate.") or "handoff" in name:
            return "transfer"
        if "replay" in name:
            return "replay"
        return None

    # flow-anchor classification: the dispatch -> admit -> export ->
    # import -> decode chain, in rank order for tie-breaking at equal ts
    _FLOW_RANK = {"router.request": 0, "http.request": 1, "queued": 1,
                  "export": 2, "handoff": 2, "import": 3, "decode": 4}

    def _flow_rank(self, name: str) -> Optional[int]:
        for frag, rank in self._FLOW_RANK.items():
            if frag in name:
                return rank
        return None

    def critical_path(self, trace_id: str) -> Optional[dict]:
        """Phase breakdown in ms for one trace: an interval sweep over
        the aligned, classified spans.  Gaps between consecutive
        intervals ride the ongoing (earlier) phase, so the phases sum
        exactly to the trace extent — which is what the client measured
        as TTFT + stream time."""
        with self._lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                return None
            evs = list(rec["events"])
        ivs: List[Tuple[float, float, str, tuple]] = []
        for ev in evs:
            if ev.get("ph") != "X":
                continue
            ph = self._phase_of(ev.get("name", ""))
            if ph is None:
                continue
            s = float(ev["ts"])
            ivs.append((s, s + float(ev.get("dur", 0.0)), ph,
                        ev.get("_track")))
        if not ivs:
            return None
        ivs.sort(key=lambda iv: iv[0])
        # a prefill on a DIFFERENT track after the transfer began is the
        # destination re-prefilling shipped context: that's replay time
        first_prefill = next((iv for iv in ivs if iv[2] == "prefill"), None)
        t_transfer = next((iv[0] for iv in ivs if iv[2] == "transfer"),
                          None)
        if first_prefill is not None and t_transfer is not None:
            ivs = [(s, e,
                    "replay" if (ph == "prefill" and s >= t_transfer
                                 and tr != first_prefill[3]) else ph, tr)
                   for s, e, ph, tr in ivs]
        phases = {ph: 0.0 for ph in _PHASES}
        t0 = ivs[0][0]
        pos, cur = t0, ivs[0][2]
        for s, e, ph, _tr in ivs:
            if s > pos:
                phases[cur] += s - pos       # gap rides the ongoing phase
                pos = s
            if e > pos:
                phases[ph] += e - pos
                pos = e
                cur = ph
        out = {ph: round(v / 1e3, 3) for ph, v in phases.items() if v > 0}
        total = round((pos - t0) / 1e3, 3)
        h = _metrics.histogram
        for ph in ("queue", "prefill", "transfer", "decode", "replay"):
            if ph in out:
                h("serving.trace.critical_path_ms", phase=ph).observe(
                    out[ph])
        return {"phases_ms": out, "total_ms": total}

    def assemble(self, trace_id: str) -> Optional[dict]:
        """One merged Chrome-trace/perfetto document for ``trace_id``:
        every process's spans clock-aligned on the collector axis, one
        track per process, flow events stitching the request chain."""
        with self._lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                return None
            evs = [dict(ev) for ev in rec["events"]]
            procs = {k: dict(v) for k, v in self._procs.items()}
            dropped = rec["dropped"]
        tracks = sorted({ev["_track"] for ev in evs})
        pid_of = {tr: i + 1 for i, tr in enumerate(tracks)}
        out: List[dict] = []
        for tr in tracks:
            batch_proc, sub = tr
            label = sub if sub == batch_proc else f"{sub} @ {batch_proc}"
            role = procs.get(batch_proc, {}).get("role", "")
            if role and role not in label:
                label = f"{label} ({role})"
            out.append({"ph": "M", "pid": pid_of[tr], "tid": 0,
                        "name": "process_name", "args": {"name": label}})
            out.append({"ph": "M", "pid": pid_of[tr], "tid": 0,
                        "name": "thread_name", "args": {"name": trace_id}})
        anchors: List[Tuple[float, int, dict]] = []
        for ev in evs:
            tr = ev.pop("_track")
            ev["pid"] = pid_of[tr]
            ev["tid"] = 0
            out.append(ev)
            rank = self._flow_rank(ev.get("name", "")) \
                if ev.get("ph") == "X" else None
            if rank is not None:
                anchors.append((float(ev["ts"]), rank, ev))
        flow_id = zlib.crc32(trace_id.encode()) & 0x7FFFFFFF
        anchors.sort(key=lambda a: (a[0], a[1]))
        for i, (ts, _rank, ev) in enumerate(anchors):
            ph = "s" if i == 0 else ("f" if i == len(anchors) - 1 else "t")
            if len(anchors) < 2:
                break
            flow = {"ph": ph, "id": flow_id, "name": "request",
                    "cat": "flow", "pid": ev["pid"], "tid": 0, "ts": ts}
            if ph == "f":
                flow["bp"] = "e"
            out.append(flow)
        cp = self.critical_path(trace_id)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "metadata": {"producer": "paddle_tpu_torch.observability",
                             "trace_id": trace_id,
                             "dropped_events": dropped,
                             "processes": {f"{p}/{s}": pid
                                           for (p, s), pid in
                                           pid_of.items()},
                             "critical_path": cp}}

    def write_trace(self, trace_id: str, path: str) -> Optional[str]:
        doc = self.assemble(trace_id)
        if doc is None:
            return None
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    # ------------------------------------------------ fleet-correlated dump --
    def register_ring(self, name: str,
                      provider: Callable[[], List[dict]]) -> None:
        """Register a flight-recorder ring provider (a callable returning
        that component's buffered span events) for fleet-correlated
        dumps.  In-process components register directly; remote processes
        are covered by the span store — their tail-kept spans already
        arrived through the export path."""
        self._rings[name] = provider

    def unregister_ring(self, name: str) -> None:
        self._rings.pop(name, None)

    def fleet_dump(self, reason: str = "anomaly",
                   window_s: float = 30.0,
                   path: Optional[str] = None) -> Optional[str]:
        """Merge every registered flight-recorder ring plus the
        collector's aligned span store for the anomalous window into ONE
        file.  Rate-limited like per-process dumps
        (``FLAGS_flight_recorder_min_interval_s``) unless an explicit
        path is given."""
        now = self.now()
        if path is None:
            min_gap = float(flags.flag("flight_recorder_min_interval_s"))
            if now - self._last_fleet_dump < min_gap:
                return None
            self._last_fleet_dump = now
            stem, ext = os.path.splitext(
                str(flags.flag("flight_recorder_path")))
            path = f"{stem}_fleet_{reason}{ext or '.json'}"
        horizon_us = (now - window_s) * 1e6
        out: List[dict] = []
        pid = 0
        for name, provider in sorted(self._rings.items()):
            pid += 1
            out.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name",
                        "args": {"name": f"ring:{name}"}})
            try:
                ring = list(provider())
            except Exception:
                continue
            for ev in ring:
                ev2 = dict(ev)
                ev2["pid"] = pid
                if float(ev2.get("ts", now * 1e6)) >= horizon_us \
                        or ev2.get("ph") == "M":
                    out.append(ev2)
        with self._lock:
            traces = {tid: list(rec["events"])
                      for tid, rec in self._traces.items()}
        pid += 1
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name",
                    "args": {"name": "collector (aligned spans)"}})
        tid_of: Dict[str, int] = {}
        for tid_name, evs in traces.items():
            for ev in evs:
                if float(ev.get("ts", 0.0)) < horizon_us:
                    continue
                n = tid_of.get(tid_name)
                if n is None:
                    n = len(tid_of) + 1
                    tid_of[tid_name] = n
                    out.append({"ph": "M", "pid": pid, "tid": n,
                                "name": "thread_name",
                                "args": {"name": tid_name}})
                ev2 = {k: v for k, v in ev.items() if k != "_track"}
                ev2["pid"], ev2["tid"] = pid, n
                out.append(ev2)
        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "metadata": {"producer": "paddle_tpu_torch.observability",
                            "reason": reason, "window_s": window_s,
                            "rings": sorted(self._rings)}}
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        self._m.fleet_dumps.inc()
        return path
