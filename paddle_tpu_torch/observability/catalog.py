"""Metric series catalog: the documented surface of the port's registry
(port of ``paddle_tpu/observability/catalog.py``).

One table maps every metric family the port can emit to its kind, label
set and meaning.  A family the JAX package emits too keeps that package's
kind and labels, so a dashboard reads either.  ``generate_markdown()``
renders the table (``python -m paddle_tpu_torch.observability.catalog``
prints it); the tests assert that every family a test process created is
cataloged.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import metrics as _metrics

__all__ = ["CATALOG", "undocumented", "generate_markdown", "apply_help"]

# family -> (kind, labels, meaning)
CATALOG: Dict[str, tuple] = {
    # ---- serving: request lifecycle ----
    "serving.requests_total": (
        "counter", "", "requests submitted to the engine"),
    "serving.requests_completed": (
        "counter", "", "requests retired by the engine"),
    "serving.tokens_generated": (
        "counter", "", "generated tokens retired across all requests"),
    "serving.prefill_tokens": (
        "counter", "", "prompt tokens prefilled (after the prefix-cache "
        "trim)"),
    "serving.steps": ("counter", "", "engine dispatches"),
    "serving.drains": (
        "counter", "", "host<->device drains (the steady state's only "
        "sync; one per sync_every steps)"),
    "serving.queue_wait_ms": (
        "histogram", "", "enqueue -> admission wait per request"),
    "serving.ttft_ms": (
        "histogram", "", "enqueue -> first token per request "
        "(dispatch-stamped, drain-folded)"),
    "serving.itl_ms": (
        "histogram", "", "inter-token latency per generated token after "
        "the first"),
    "serving.queue_depth": (
        "histogram", "", "waiting-queue depth observed at each step"),
    "serving.queue_depth_now": (
        "gauge", "", "live waiting-queue depth"),
    "serving.batch_occupancy": (
        "histogram", "", "busy slots / max_batch per step"),
    # ---- serving: per-phase step attribution ----
    "serving.step_ms": (
        "histogram", "phase=prefill|decode|spec_verify|fused_k|cow_copy"
        "|drain",
        "per-phase dispatch-to-dispatch engine step wall time "
        "(observability/attribution.py; folded at drains)"),
    "serving.tokens_per_sec": (
        "gauge", "phase=...",
        "per-phase throughput over the last drained window"),
    # ---- serving: KV pool + prefix cache ----
    "serving.pages_in_use": ("gauge", "", "allocated KV pages"),
    "serving.peak_pages_in_use": (
        "gauge", "", "high-water allocated KV pages"),
    "serving.active_seqs": ("gauge", "", "sequences holding pages"),
    "serving.prefix_cached_pages": (
        "gauge", "", "radix-indexed shared KV pages"),
    "serving.prefix_evictable_pages": (
        "gauge", "", "idle cached pages the LRU pool could reclaim"),
    "serving.prefix_digest_epoch": (
        "gauge", "", "prefix-digest change epoch (every index insert or "
        "eviction bumps it)"),
    "serving.prefix_hits": (
        "counter", "", "admissions that attached a cached prefix"),
    "serving.prefix_tokens_saved": (
        "counter", "", "prompt tokens skipped via cached prefixes"),
    "serving.cow_copies": (
        "counter", "", "copy-on-write page privatizations"),
    "serving.evicted_pages": (
        "counter", "", "cached pages reclaimed under memory pressure"),
    # ---- serving: int8 KV plane + host spill tier ----
    "serving.kv.quant_bytes_saved": (
        "counter", "", "pool bytes the int8 KV plane saves against an "
        "equal-page fp32 pool (stamped once per cache construction)"),
    "serving.kv.spilled_pages": (
        "counter", "", "LRU-evicted prefix-cache pages copied to the "
        "pinned host spill ring instead of dropped"),
    "serving.kv.swapins": (
        "counter", "", "spilled pages copied back into the device pool "
        "by an admission match"),
    "serving.kv.swapin_wait_ms": (
        "histogram", "", "host time enqueuing one spilled page's copy "
        "back to the card (no device sync)"),
    # ---- serving: session migration ----
    "serving.kv.migration_exports": (
        "counter", "", "session snapshots exported (inference/"
        "migration.py: raw pool bytes; int8 pages ship quantized, "
        "spilled pages ship their host-ring bytes)"),
    "serving.kv.migration_imports": (
        "counter", "", "session snapshots imported and indexed as ready "
        "prefix-cache pages (acquire_page, then one page copy a page on "
        "the current stream)"),
    "serving.kv.migration_pages": (
        "counter", "direction=out|in", "KV pages moved by session "
        "migration"),
    "serving.kv.migration_aborts": (
        "counter", "", "transfers that failed mid-flight (the in-flight "
        "page's allocator reference is released; pages already linked "
        "stay valid cache entries)"),
    "serving.kv.migration_rejected": (
        "counter", "", "snapshots refused by the blake2b integrity check "
        "at import (corrupt or truncated bytes: nothing installed, no "
        "allocator reference leaked)"),
    "serving.kv.handoff_sessions": (
        "counter", "outcome=ok|partial", "prefill->decode handoffs "
        "imported on this replica: ok = every full page under the "
        "journaled tokens arrived, partial = the decode leg re-prefills "
        "the shortfall"),
    "serving.kv.handoff_reprefill_tokens": (
        "counter", "", "tokens the decode leg re-prefills because their "
        "pages did not survive the handoff"),
    # ---- serving: tensor-parallel engine ----
    "serving.tp.degree": (
        "gauge", "", "tensor-parallel shard count of the serving engine "
        "(FLAGS_serving_tensor_parallel; 1 = one device): the KV pool and "
        "attention shard by kv head, grouped MoE by expert, with outputs "
        "bit-identical to tp=1"),
    "serving.tp.shard_pool_bytes": (
        "gauge", "", "per-shard KV page-pool bytes (host-global pool bytes "
        "/ tp): each shard stores only its kv heads' page planes and int8 "
        "scale rows"),
    # ---- serving: speculative decoding ----
    "serving.spec.drafted_tokens": (
        "counter", "", "draft tokens dispatched for verification"),
    "serving.spec.accepted_tokens": (
        "counter", "", "draft tokens accepted by the verifier"),
    "serving.spec.rejected_tokens": (
        "counter", "", "draft tokens rolled back"),
    "serving.spec.accept_len": (
        "histogram", "", "tokens committed per speculative dispatch "
        "beyond the first"),
    # ---- serving: HTTP front door ----
    "serving.http.requests": ("counter", "", "HTTP requests accepted"),
    "serving.http.streams": ("counter", "", "streaming completions"),
    "serving.http.responses": (
        "counter", "code=...", "responses by status code"),
    "serving.http.inflight": ("gauge", "", "open HTTP requests"),
    "serving.http.request_ms": (
        "histogram", "", "HTTP request wall time"),
    "serving.http.slo_decision": (
        "counter", "decision=admit|queue|shed", "SLO-burn admission "
        "decisions"),
    "serving.http.shed": (
        "counter", "", "requests shed with 503 + Retry-After"),
    "serving.http.queue_expired": (
        "counter", "", "requests retired from the engine inbox past "
        "FLAGS_serving_queue_timeout_s before dispatch (no prefill spent; "
        "unary = 504, stream = finish_reason queue_expired)"),
    # ---- regression sentinel ----
    "observability.anomaly": (
        "counter", "series=...,kind=drift|burst",
        "sentinel anomalies by watched series and detector kind "
        "(observability/sentinel.py; each also lands as a tracer instant "
        "event and a rate-limited flight-recorder dump)"),
    # ---- train loop (StepTimer, default name) ----
    "train.steps": ("counter", "", "train steps dispatched"),
    "train.step_ms": (
        "histogram", "", "warm train-step wall time (steps that built a "
        "kernel excluded)"),
    "train.tokens_per_sec": (
        "gauge", "", "throughput of the last warm train step"),
    "train.recompiles": (
        "counter", "", "kernel builds attributed to train steps"),
    "train.grad_comm_bytes": (
        "counter", "", "analytic gradient-sync traffic"),
    # ---- compile telemetry: the port's kernel builds ----
    "jit.backend_compiles": (
        "counter", "", "process-wide kernel builds and loads "
        "(kernels/_build.py: one nvcc run, or one library load, each); "
        "any after warm-up is an anomaly"),
    "jit.backend_compile_ms": (
        "histogram", "", "kernel build / load durations "
        "(kernels/_build.py)"),
    # ---- observability runtime guards ----
    "host.device_syncs": (
        "counter", "", "marked intentional host<->device syncs "
        "(count_sync; assert_overhead bounds these)"),
    "metrics.dropped_series": (
        "counter", "", "label sets folded into {series=__overflow__} by "
        "the FLAGS_metrics_max_series cardinality guard"),
    "tracing.dropped_events": (
        "counter", "", "trace events dropped at the "
        "FLAGS_trace_max_events cap"),
    "flight_recorder.dumps": (
        "counter", "", "flight-recorder dump files written"),
    "flight_recorder.suppressed_dumps": (
        "counter", "", "dumps swallowed by the per-reason rate limit "
        "(FLAGS_flight_recorder_min_interval_s)"),
    # ---- router ----
    "router.requests": ("counter", "", "router requests accepted"),
    "router.streams": ("counter", "", "router streaming completions"),
    "router.responses": (
        "counter", "code=...", "router responses by status code"),
    "router.inflight": ("gauge", "", "open router requests"),
    "router.request_ms": ("histogram", "", "router request wall time"),
    "router.placement": (
        "counter", "reason=affinity|prefix|load|round_robin",
        "placement decisions by reason"),
    "router.prefix_hit_pages": (
        "histogram", "", "expected prefix-hit depth of scored "
        "placements"),
    "router.session_pins": ("gauge", "", "live session-affinity pins"),
    "router.session_evictions": (
        "counter", "", "LRU-evicted session pins"),
    "router.failover": (
        "counter", "phase=connect|stream", "requests that hit a dead "
        "replica"),
    "router.slo_decision": (
        "counter", "decision=admit|shed|unavailable|breaker",
        "fleet admission decisions (breaker = shed because the cascade "
        "breaker is open)"),
    "router.shed": ("counter", "", "fleet-wide sheds"),
    "router.health_polls": (
        "counter", "result=ok|fail", "replica /statusz polls"),
    "router.replicas": (
        "gauge", "state=ready|warming|suspect|dead|draining",
        "replica count by health state"),
    "router.replica_rejoins": (
        "counter", "", "dead -> live replica transitions (the rejoined "
        "replica's routed-overlay staleness is reset)"),
    "router.resumes": (
        "counter",
        "outcome=resumed|unary|handoff|finished|ineligible|exhausted",
        "journaled failover-resume outcomes: resumed = a dead stream "
        "continued on a survivor, unary = a post-dispatch unary death "
        "re-ran, handoff = a prefill->decode splice completed, finished "
        "= only the finish frame was lost, ineligible = replay "
        "impossible (synthesized-error / 502 contract), exhausted = "
        "replay attempted but no survivor could finish it"),
    "router.journal_entries": (
        "gauge", "", "in-flight requests tracked by the replay journal"),
    "router.journal_evictions": (
        "counter", "", "journal entries LRU-evicted past "
        "FLAGS_router_journal_cap"),
    "router.digest_sync": (
        "counter", "mode=full|delta|sketch", "prefix-digest syncs by "
        "mode: delta = only the changes since the confirmed epoch, full "
        "= the complete set, sketch = a counting-Bloom bitmap"),
    "router.quarantine": (
        "counter", "action=strike|quarantined|refused",
        "poison-request crash attribution (router/quarantine.py)"),
    "router.quarantine_entries": (
        "gauge", "", "request signatures tracked by the quarantine"),
    "router.handoff": (
        "counter", "outcome=ok|export_failed|import_failed|no_successor",
        "prefill->decode KV handoffs (router/server.py): ok = the "
        "finished prefix shipped to a decode successor and the stream "
        "spliced; the failures re-prefill on a fallback replica"),
    "router.overlay_entries": (
        "gauge", "", "routed-overlay credits across all replica views"),
    "router.overlay_evictions": (
        "counter", "", "overlay credits LRU-evicted past "
        "FLAGS_router_overlay_cap"),
    # ---- fleet supervisor ----
    "fleet.replicas": (
        "gauge", "state=starting|ready|draining|backoff|failed",
        "supervised replica slots by lifecycle state "
        "(fleet/supervisor.py)"),
    "fleet.target_replicas": (
        "gauge", "", "the autoscaler's current fleet-size target"),
    "fleet.replica_restarts": (
        "counter", "", "crash-restarts performed (after exponential "
        "backoff, within FLAGS_fleet_restart_budget)"),
    "fleet.crashes": (
        "counter", "kind=exit|wedged|router",
        "deaths detected: process/engine exit, or a wedge (the router "
        "reports it dead while the process is still alive); router = a "
        "supervised router slot's death"),
    "fleet.scale_events": (
        "counter", "direction=up|down",
        "autoscale actions taken after hysteresis + cooldown"),
    "fleet.drains": (
        "counter", "outcome=clean|timeout|died",
        "graceful drains by outcome"),
    "fleet.migrations": (
        "counter", "outcome=ok|skipped|failed",
        "drain-triggered session migrations"),
    "fleet.migrated_pages": (
        "counter", "", "KV pages installed on successors by drain "
        "migrations and rebalances"),
    "fleet.role": (
        "gauge", "role=prefill|decode|mixed",
        "non-failed supervised slots by serving role"),
    "fleet.rebalances": (
        "counter", "outcome=ok|skipped|failed",
        "proactive session rebalances off an SLO-burning replica"),
    "fleet.breaker_state": (
        "gauge", "", "cascade-breaker state (fleet/breaker.py): "
        "0=closed, 1=half-open, 2=open"),
    # ---- multi-router control plane ----
    "router.forwarded": (
        "counter", "outcome=out|received|fallback",
        "consistent-hash ownership forwards (router/server.py): out = this "
        "router relayed a session it does not own one hop to its ring "
        "owner, received = it served a request forwarded to it (the "
        "X-Router-Forwarded loop guard: never forwarded again), fallback = "
        "the owner was unreachable, so the request was served here"),
    "router.ring_moves": (
        "counter", "", "consistent-hash ring rebuilds this router saw (a "
        "router joined, or one's heartbeat expired and its span moved)"),
    "fleet.router_restarts": (
        "counter", "", "supervised router-slot crash-restarts (after "
        "exponential backoff, within FLAGS_fleet_restart_budget)"),
    "controlplane.routers": (
        "gauge", "", "non-failed supervised router slots "
        "(fleet/supervisor.py; the launcher's in-process rt0 is no slot)"),
    "controlplane.store_ops": (
        "counter", "op=set|get|cas|del|hb|members",
        "membership-store operations served, by protocol verb "
        "(controlplane/store.py)"),
    "controlplane.store_keys": (
        "gauge", "", "keys resident in the membership store (TTL-swept on "
        "writes and membership reads, LRU-capped at "
        "FLAGS_controlplane_store_max_keys)"),
    "controlplane.store_evictions": (
        "counter", "", "store keys LRU-evicted past "
        "FLAGS_controlplane_store_max_keys"),
    "controlplane.store_refused": (
        "counter", "", "store request lines refused for passing the 1 MiB "
        "line cap (the connection is answered with an error and closed)"),
    "controlplane.members": (
        "gauge", "", "live routers on the consistent-hash ring as this "
        "router sees them (unexpired router/ heartbeats, itself included)"),
    "controlplane.ring_epoch": (
        "gauge", "", "epoch of the shared cp/ring record (CAS-bumped once "
        "a membership change; every router converges to the winner's)"),
    "controlplane.heartbeats": (
        "counter", "", "liveness stamps written to the store (TTL "
        "FLAGS_controlplane_heartbeat_ttl_s; expiry is the death signal)"),
    "controlplane.journal_replicated": (
        "counter", "", "in-flight journal records mirrored to the store "
        "under journal/<session_id> (TTL FLAGS_controlplane_journal_ttl_s) "
        "so the session's next owner can resume the stream"),
    "controlplane.takeovers": (
        "counter", "outcome=resumed|stale|failed",
        "cross-router journal adoptions: resumed = the new owner replayed "
        "the dead router's journal and went on with the stream, stale = "
        "the record did not match the request (another prompt, its own "
        "record, nothing emitted), failed = the replay could not finish"),
    # ---- fleet tracing ----
    "serving.trace.critical_path_ms": (
        "histogram", "phase=queue|prefill|transfer|decode|replay",
        "per-request critical-path breakdown at timeline assembly "
        "(observability/collector.py): an interval sweep over the "
        "clock-aligned spans, gaps riding the ongoing phase, so the phases "
        "sum to the trace's extent"),
    "observability.collector.export_batches": (
        "counter", "", "span batches shipped by this process's "
        "SpanExporter (store set, HTTP POST or in-process ingest)"),
    "observability.collector.export_spans": (
        "counter", "", "span events shipped in export batches"),
    "observability.collector.export_dropped": (
        "counter", "", "span events evicted from the bounded export ring "
        "before a flush shipped them (FLAGS_trace_export_events)"),
    "observability.collector.sampled_out": (
        "counter", "", "span events skipped by head sampling "
        "(FLAGS_trace_sample_rate; tail-kept lanes ship regardless)"),
    "observability.collector.export_errors": (
        "counter", "", "export batch sends that raised (the transport is "
        "down or refused the line; the batch is dropped, serving never "
        "waits)"),
    "observability.collector.clock_resyncs": (
        "counter", "", "clock-offset re-estimations taken because the "
        "midpoint drifted past FLAGS_trace_clock_drift_ms beyond the "
        "handshake's rtt/2"),
    "observability.collector.batches": (
        "counter", "", "export batches ingested by the collector"),
    "observability.collector.spans": (
        "counter", "", "span events ingested by the collector"),
    "observability.collector.traces": (
        "gauge", "", "trace ids held in the collector's bounded span store "
        "(LRU past max_traces)"),
    "observability.collector.processes": (
        "gauge", "", "exporting processes the collector has seen (each "
        "with its own clock offset)"),
    "observability.collector.fleet_dumps": (
        "counter", "", "fleet-correlated anomaly dumps written (every "
        "registered flight-recorder ring and the collector's aligned spans "
        "of the window, in one file)"),
    # ---- step watchdog ----
    "watchdog.timeouts": ("counter", "", "watchdog timeout fires"),
    "watchdog.outstanding_tasks": (
        "gauge", "", "watched tasks (engine steps) currently in flight"),
    "watchdog.last_heartbeat_age_s": (
        "gauge", "", "seconds since the last watched task began"),
}


def undocumented(families: Optional[Dict[str, str]] = None) -> list:
    """Families present in the registry but missing from the catalog
    (``StepTimer`` families under a custom name are the caller's to
    exclude)."""
    if families is None:
        families = _metrics.REGISTRY.families()
    return sorted(n for n in families if n not in CATALOG)


def apply_help() -> None:
    """Attach every entry's meaning as its family's ``# HELP`` text."""
    for name, (_kind, _labels, help_text) in CATALOG.items():
        _metrics.REGISTRY.set_help(name, help_text)


def generate_markdown() -> str:
    """The catalog as a markdown document, grouped by family prefix."""
    groups: Dict[str, list] = {}
    for name, (kind, labels, help_text) in CATALOG.items():
        groups.setdefault(name.split(".", 1)[0], []).append(
            (name, kind, labels, help_text))
    lines = [
        "# Metric series catalog (paddle_tpu_torch)",
        "",
        "Every registry family `paddle_tpu_torch` emits, generated from",
        "`paddle_tpu_torch/observability/catalog.py`.  Scrape them live",
        "from a serving replica's `/metrics` (Prometheus text, dots",
        "sanitized to underscores, prefix `paddle_tpu_`).",
        "",
        "`train.*` rows describe the default `StepTimer(\"train\")`;",
        "a custom timer name replaces the prefix.",
    ]
    for prefix in sorted(groups):
        lines += ["", f"## `{prefix}.*`", "",
                  "| series | kind | labels | meaning |",
                  "|---|---|---|---|"]
        for name, kind, labels, help_text in groups[prefix]:
            lbl = f"`{labels}`" if labels else "—"
            lines.append(f"| `{name}` | {kind} | {lbl} | {help_text} |")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    print(generate_markdown(), end="")
