"""Global flag registry (a copy of ``paddle_tpu/flags.py``'s registry).

Flags are seeded from the environment (``FLAGS_<name>``) at definition time
and set at run time with :func:`set_flags` (the launcher's ``--set``).  Only
the flags the port reads are registered here (the serving engine, the front
door, observability, the watchdog, the router, the fleet supervisor and
the DataLoader), with the reference's names and defaults.
"""

from __future__ import annotations

import os
from typing import Any, Dict

_DEFS: Dict[str, dict] = {}
_VALUES: Dict[str, Any] = {}


def define_flag(name: str, default: Any, help_str: str = "", flag_type: type | None = None) -> None:
    """Register a flag. Env var ``FLAGS_<name>`` overrides the default."""
    if flag_type is None:
        flag_type = type(default)
    _DEFS[name] = {"default": default, "help": help_str, "type": flag_type}
    env = os.environ.get("FLAGS_" + name)
    if env is not None:
        _VALUES[name] = _parse(env, flag_type)
    else:
        _VALUES[name] = default


def _parse(text: str, flag_type: type) -> Any:
    if flag_type is bool:
        return text.lower() in ("1", "true", "yes", "on")
    return flag_type(text)


def get_flags(flags=None) -> Dict[str, Any]:
    if flags is None:
        return dict(_VALUES)
    if isinstance(flags, str):
        flags = [flags]
    return {f: _VALUES[f] for f in flags}


def set_flags(flags: Dict[str, Any]) -> None:
    for k, v in flags.items():
        if k.startswith("FLAGS_"):
            k = k[len("FLAGS_"):]
        if k not in _DEFS:
            raise ValueError(f"Unknown flag {k!r}; known flags: {sorted(_DEFS)}")
        _VALUES[k] = _parse(v, _DEFS[k]["type"]) if isinstance(v, str) else _DEFS[k]["type"](v)


def flag(name: str) -> Any:
    return _VALUES[name]


define_flag("kv_cache_dtype", "auto",
            "Serving KV page-pool storage dtype: 'auto' follows the model "
            "dtype, 'fp32'/'float32'/'bf16'/'bfloat16' force a float pool, "
            "'int8' stores int8 pages with one fp32 absmax scale per "
            "(layer, kv-head, page).")
define_flag("prefix_cache", False,
            "Serving engine: share KV pages across requests with a common "
            "page-aligned token prefix (radix index + ref-counted pages + "
            "copy-on-write + LRU eviction; inference/prefix_cache.py). "
            "Off is the uncached engine; on, greedy outputs still match the "
            "cache-off engine.")
define_flag("prefix_cache_min_pages", 1,
            "Minimum cached-prefix length IN PAGES for an admission to "
            "take a prefix-cache hit; shorter matches prefill from "
            "scratch.")
define_flag("kv_spill_pages", 0,
            "Capacity (in pages) of the pinned-host-memory spill ring for "
            "LRU-evicted prefix-cache pages (inference/kv_spill.py): an "
            "evicted idle cached page copies its KV to host memory instead "
            "of being dropped, and a later admission that matches it "
            "copies it back.  0 = off.  Requires the prefix cache.")
define_flag("serving_tensor_parallel", 1,
            "Tensor-parallel shard count of the serving engine (engine "
            "kwarg tensor_parallel=): >1 shards the KV pool's storage and "
            "attention by kv head and grouped MoE by expert over the shard "
            "devices (device='cuda': shard i on cuda:i; 'cpu'; or a list, "
            "repeats allowed), while weights, projections, norms, embedding "
            "and sampling stay on shard 0's device, so greedy and seeded "
            "sampled outputs stay bit-identical to tp=1.  Page ids, block "
            "tables, the prefix cache, the spill ring and migration "
            "snapshots stay host-global.  num_kv_heads and "
            "num_attention_heads must be divisible by the shard count.")
define_flag("spec_decode", "",
            "Speculative decoding mode for the serving engine "
            "(inference/speculative.py): '' = off, 'ngram' = prompt-lookup "
            "drafts verified in one T=spec_k step with on-device "
            "longest-accepted-prefix acceptance, 'fused' = spec_k "
            "sequential decode steps per engine dispatch.  Greedy outputs "
            "in both modes match the spec-off engine.")
define_flag("spec_k", 4,
            "Tokens per speculative dispatch: the verify step runs at "
            "T=spec_k ('ngram' proposes spec_k-1 draft tokens per step), "
            "'fused' commits up to spec_k tokens per dispatch.")
define_flag("spec_ngram_max", 3,
            "Longest n-gram context the on-device drafter matches against "
            "the request's prompt+output history (longest match wins, most "
            "recent occurrence breaks ties).")
define_flag("prefix_digest_log", 4096,
            "Capacity of the prefix cache's digest change log (adds/"
            "evictions per epoch) behind digest delta sync; 0 = no log "
            "(every delta request falls back to the full set).")
define_flag("router_digest_max", 4096,
            "Cap on prefix-residency digest entries a replica advertises "
            "(breadth-first from the radix root, so a truncated digest "
            "keeps the leading pages).")
define_flag("router_digest_sketch", True,
            "Keep a counting-Bloom sketch of the prefix-residency digest "
            "beside the exact set; past router_digest_sketch_threshold "
            "entries the digest ships as the sketch's bitmap.")
define_flag("router_digest_sketch_threshold", 2048,
            "Resident-page count above which the sketch replaces the exact "
            "digest.")
define_flag("router_digest_sketch_bits", 65536,
            "Bloom filter width m in bits (wire form is m/8 bytes, "
            "base64-encoded).")
define_flag("router_digest_sketch_hashes", 4,
            "Bloom hash count k (indices from one blake2b by double "
            "hashing).")
define_flag("controlplane_heartbeat_ttl_s", 5.0,
            "Router-liveness TTL in the membership store: a router whose "
            "last heartbeat is older than this drops out of the "
            "consistent-hash ring and its span moves to the survivors.")
define_flag("controlplane_heartbeat_interval_s", 1.0,
            "Seconds between router heartbeats and membership refreshes "
            "against the store (the background control-plane loop).")
define_flag("controlplane_vnodes", 64,
            "Virtual nodes per router on the consistent-hash ring; more "
            "vnodes split the span more smoothly on a membership change.")
define_flag("controlplane_journal_ttl_s", 120.0,
            "TTL on the journal records a router replicates into the "
            "membership store for a cross-router takeover; past it an "
            "orphaned record is swept.")
define_flag("controlplane_store_max_keys", 65536,
            "Hard cap on membership-store keys (the oldest set is evicted "
            "first); bounds the store's memory under session churn.")
define_flag("enable_async_trace", False,
            "Step watchdog: record the stack of every watched task and "
            "print it when the task times out (distributed/watchdog.py).")
define_flag("comm_timeout_s", 600,
            "Step watchdog timeout in seconds: a watched task (the serving "
            "front door's engine step) running longer fires the timeout "
            "hooks (the flight recorder's dump).")
define_flag("metrics", True,
            "Process-wide metrics registry collection on the serving hot "
            "paths (paddle_tpu_torch/observability/): per-request TTFT/ITL "
            "histograms, per-phase step attribution, pool gauges.  Warm "
            "steps add no kernel build and no device sync with it on; 0 "
            "disables every hot-path instrumentation site.")
define_flag("trace_max_events", 200000,
            "Cap on buffered Chrome-trace events in the observability "
            "tracer (observability/tracing.py); the overflow is counted in "
            "the exported file's metadata and in tracing.dropped_events.")
define_flag("trace_sample_rate", 1.0,
            "Fraction of request traces the span exporter ships to the "
            "fleet collector (observability/collector.py), decided per "
            "trace id by a stable hash, so every process keeps or drops the "
            "same traces.  Anomalous, shed, failover and handoff traces are "
            "kept whatever the rate; 0 disables export (the exporter never "
            "attaches).")
define_flag("trace_export_events", 8192,
            "Bound on pending span-export events buffered per process (the "
            "SpanExporter ring).  The tracer's offer into the ring is one "
            "deque append; overflow evicts the oldest and bumps "
            "observability.collector.export_dropped, never blocking the "
            "engine or the event loop.")
define_flag("trace_export_batch", 512,
            "Most span events per export batch shipped to the collector; a "
            "flush splits a larger backlog into several batches.")
define_flag("trace_export_interval_s", 0.5,
            "Seconds between span-export flushes from each process's "
            "exporter thread to the fleet collector (a host daemon thread, "
            "off the dispatch path).")
define_flag("trace_collector", "",
            "host:port of the fleet trace collector's HTTP ingest (POST "
            "/collectz on the router or the fleet launcher).  Non-empty "
            "makes `python -m paddle_tpu_torch.serving` start a span "
            "exporter over HTTP; empty, tracing stays process-local unless "
            "a control-plane store carries the batches.")
define_flag("trace_clock_drift_ms", 5.0,
            "Clock-offset drift threshold of the collector's NTP-style "
            "handshake (observability/collector.py ClockSync): a fresh "
            "midpoint measurement differing from the held offset by more "
            "than this (and not explained by round-trip jitter) replaces "
            "it and bumps observability.collector.clock_resyncs.")
define_flag("metrics_max_series", 512,
            "Cap on LABELED series per metric family in the registry "
            "(observability/metrics.py).  A family at the cap folds every "
            "further label set into one {series=__overflow__} series and "
            "bumps metrics.dropped_series.")
define_flag("serving_slo_ttft_ms", 2000.0,
            "HTTP front door TTFT SLO target in ms (serving/slo.py): the "
            "serving.ttft_ms quantile FLAGS_serving_slo_quantile must stay "
            "under this.  <=0 disables the TTFT term.")
define_flag("serving_slo_itl_ms", 200.0,
            "HTTP front door inter-token-latency SLO target in ms "
            "(serving.itl_ms histogram).  <=0 disables the ITL term.")
define_flag("serving_slo_quantile", 0.95,
            "SLO quantile: the fraction of observations that must meet the "
            "TTFT/ITL targets (0.95 = a 5% violation budget).")
define_flag("serving_slo_burn", 2.0,
            "Load-shed threshold as a multiple of the SLO violation "
            "budget: an observed violation rate > burn * (1 - quantile) "
            "sheds new requests with 503; > 1x budget marks them 'queue' "
            "(admitted, counted as at-risk).")
define_flag("serving_slo_min_samples", 64,
            "Minimum fresh histogram observations in the current window "
            "before SLO burn decisions activate (a cold start admits).")
define_flag("serving_slo_window", 512,
            "Observations per SLO decision window: burn is computed over "
            "deltas since the window base, rebased every this many.")
define_flag("serving_sentinel", True,
            "Online regression sentinel (observability/sentinel.py) in the "
            "serving front door: EWMA+MAD drift detectors over TTFT/ITL, "
            "per-phase step_ms, kernel builds after warm-up, queue depth "
            "and spec accept rate, swept from the engine loop.")
define_flag("sentinel_alpha", 0.2,
            "EWMA smoothing factor for the sentinel's baseline mean and "
            "absolute-deviation trackers (observability/sentinel.py) and "
            "the step attribution's cost table.")
define_flag("sentinel_k", 4.0,
            "Sentinel anomaly threshold: a sample is anomalous when "
            "|value - ewma| > k * max(deviation, 10% of the baseline).")
define_flag("sentinel_min_samples", 16,
            "Observations a sentinel detector folds into its baseline "
            "before it may flag anomalies.")
define_flag("sentinel_interval_s", 1.0,
            "Minimum seconds between sentinel sweeps from the serving "
            "engine loop; a sweep reads host-side registry series only.")
define_flag("sentinel_history", 64,
            "Recent anomaly records the sentinel keeps for /statusz.")
define_flag("fleet_drain_timeout_s", 30.0,
            "Bound on a replica's graceful drain: after admission stops "
            "(SIGTERM or /drainz), in-flight requests get this many "
            "seconds to finish before the shutdown path stops waiting.")
define_flag("serving_queue_timeout_s", 0.0,
            "Queue-expiry shedding: a request still waiting in the engine "
            "inbox (never admitted, no prefill spent) past this many "
            "seconds is retired: unary replies 504, a stream gets a finish "
            "frame with finish_reason=queue_expired "
            "(serving.http.queue_expired).  <=0 disables expiry.")
define_flag("flight_recorder_min_interval_s", 30.0,
            "Per-reason rate limit on flight-recorder dumps: repeat dumps "
            "with the same reason inside this window are suppressed "
            "(flight_recorder.suppressed_dumps).  <=0 disables the limit.")
define_flag("flight_recorder_events", 4096,
            "Bounded ring of recent trace spans kept by the crash flight "
            "recorder (observability/flight_recorder.py), dumped as a "
            "Chrome trace on watchdog timeout / SIGTERM / crash.")
define_flag("flight_recorder_snapshot_s", 10.0,
            "Seconds between periodic registry snapshots folded into the "
            "flight-recorder ring (each is one instant event).")
define_flag("flight_recorder_path", "flight_record.json",
            "Base path for flight-recorder dumps; the trigger reason and "
            "the process id are suffixed to the stem.")

# -- the router, the fleet supervisor and disaggregated serving --------------
define_flag("router_placement", "scored",
            "Multi-replica router placement policy (paddle_tpu_torch/"
            "router/): 'scored' = expected prefix-hit pages (residency "
            "digest) minus load, with session affinity; 'round_robin' = "
            "naive rotation, no affinity (the A/B baseline arm).")
define_flag("router_health_interval_s", 2.0,
            "Seconds between router health polls of each replica "
            "(/statusz); consecutive failures back the poll off "
            "exponentially up to 8x this interval.")
define_flag("router_dead_after", 3,
            "Consecutive failed health polls before the router marks a "
            "replica dead (new traffic re-routes; polling continues so a "
            "recovered replica rejoins).")
define_flag("router_poll_timeout_s", 5.0,
            "Per-request timeout for router health polls, the connect "
            "phase of proxied completions, and a STREAMING completion's "
            "response head (written at admission, so slower means the "
            "replica is wedged); a unary head waits out generation "
            "unbounded.")
define_flag("router_session_cap", 4096,
            "Max tracked session-affinity pins in the router (LRU "
            "eviction; an evicted session is re-placed by score, which "
            "the residency digest steers back to its page-holding "
            "replica).")
define_flag("router_hit_weight", 1.0,
            "Placement score weight per expected prefix-hit TOKEN "
            "(digest match x page_size).")
define_flag("router_load_weight", 1.0,
            "Placement score penalty weight per queued/busy request on a "
            "replica, in page_size token units (one queued request "
            "offsets one cached page at 1.0).")
define_flag("router_capacity_weight", 1.0,
            "Weight folding a replica's advertised capacity (tensor-"
            "parallel degree + KV pool GiB from /statusz) into router "
            "ordering: handoff/fallback ranking and scored placement "
            "subtract capacity_weight * ((tp - 1) + pool_bytes/GiB).  0 "
            "restores the pure lexicographic role>load rank; homogeneous "
            "fleets order identically at any weight.")
define_flag("fleet_restart_budget", 3,
            "Consecutive crash-restarts the fleet supervisor grants one "
            "replica slot before marking it permanently failed (counted "
            "in fleet.replicas{state=failed}; a replica that stays ready "
            "past FLAGS_fleet_backoff_reset_s earns its budget back).")
define_flag("fleet_backoff_base_s", 0.5,
            "First crash-restart delay; doubles per consecutive restart "
            "up to FLAGS_fleet_backoff_max_s.")
define_flag("fleet_backoff_max_s", 30.0,
            "Cap on the exponential crash-restart backoff.")
define_flag("fleet_backoff_reset_s", 60.0,
            "A replica continuously ready this long has its restart "
            "count (and so its backoff and budget) reset at the next "
            "crash — an old flap must not doom a now-stable replica.")
define_flag("fleet_min_replicas", 1,
            "Autoscaler floor: scale-down never drains below this.")
define_flag("fleet_max_replicas", 8,
            "Autoscaler ceiling: scale-up never spawns above this.")
define_flag("fleet_scale_up_load", 4.0,
            "Autoscale-up threshold on mean placeable-replica load "
            "(router in-flight + polled queue depth, requests): hot "
            "when above this OR when every placeable replica is "
            "shedding its SLO.")
define_flag("fleet_scale_down_load", 0.5,
            "Autoscale-down threshold on mean placeable-replica load: "
            "cold only below this with zero shedding and a quiet "
            "anomaly stream (hysteresis gap vs fleet_scale_up_load).")
define_flag("fleet_hot_ticks", 3,
            "Consecutive hot supervisor ticks required before a "
            "scale-up (hysteresis: one burst must not grow the fleet).")
define_flag("fleet_cold_ticks", 10,
            "Consecutive cold supervisor ticks required before a "
            "scale-down (cold evidence is cheaper than a re-warmup).")
define_flag("fleet_scale_cooldown_s", 30.0,
            "Minimum seconds between autoscale actions in either "
            "direction, so a burst cannot flap the fleet.")
define_flag("fleet_tick_interval_s", 1.0,
            "Seconds between fleet-supervisor control-loop ticks when "
            "run_forever paces itself (tests tick explicitly).")
define_flag("fleet_migrate_on_drain", True,
            "Session-continuity migration: when the fleet supervisor "
            "drains a replica for scale-down, the victim exports its live "
            "sessions' KV pages to a supervisor-chosen READY successor "
            "(inference/migration.py) before admission closes, so the "
            "sessions' next turns / failover resumes hit the successor's "
            "prefix cache instead of re-prefilling.  Best-effort: a "
            "failed migration never blocks the drain.")
define_flag("router_failover_resume", True,
            "Journaled failover resume: an unplanned replica death "
            "mid-stream re-places the session on a survivor and REPLAYS "
            "its emitted tokens as a prefill (prefix-cache hits make the "
            "replay cheap), continuing the client's SSE stream with no "
            "synthesized error — greedy sessions (and survivors with the "
            "identical seeded positional sampling config) only.  "
            "Post-dispatch unary deaths re-run the same way instead of "
            "502.  Off restores the synthesized-error failover contract.")
define_flag("router_journal_cap", 512,
            "Max in-flight requests the router's replay journal tracks "
            "(LRU; an evicted entry's stream falls back to the "
            "synthesized-error failover path).")
define_flag("router_journal_max_tokens", 4096,
            "Per-request cap on journaled emitted tokens: a stream that "
            "outgrows it is marked non-resumable (bounded memory; the "
            "synthesized-error contract still applies to it).")
define_flag("router_poison_strikes", 2,
            "Poison-request quarantine: a replica death strikes every "
            "journaled request in-flight on it whose current flight had "
            "relayed ZERO tokens (the death happened at/near their "
            "dispatch — the poison shape; a mid-stream request is a "
            "victim, not a suspect).  A request signature (prompt-ids "
            "hash + sampling config) that accumulates this many strikes "
            "without progress in between (a relayed token absolves) is "
            "quarantined: replay stops and new submits are refused 503 "
            "with a 'quarantined' error body.  0 disables the "
            "quarantine.")
define_flag("router_quarantine_ttl_s", 300.0,
            "Seconds a quarantined request signature stays refused (and "
            "seconds an un-quarantined signature's strikes persist).  A "
            "latent kernel bug fixed by a restart should not ban the "
            "prompt forever — TTL expiry re-admits it on probation.")
define_flag("router_breaker_park_timeout_s", 20.0,
            "How long a journaled failover resume parks while the "
            "fleet's cascade breaker is open before giving up and "
            "falling back to the synthesized-error contract (the "
            "journal entry waits for a half-open probe slot or a "
            "closed breaker; it never replays into an open one).")
define_flag("fleet_cascade_threshold", 3,
            "Cascade breaker: replica deaths inside "
            "FLAGS_fleet_cascade_window_s that trip the breaker OPEN — "
            "failover resume parks, new router admissions shed with "
            "jittered Retry-After, crash restarts continue.  "
            "0 disables the breaker.")
define_flag("fleet_cascade_window_s", 30.0,
            "Sliding window (seconds) the cascade breaker counts "
            "replica deaths over.")
define_flag("fleet_cascade_cooldown_s", 10.0,
            "Seconds an OPEN cascade breaker waits (with no further "
            "deaths) before going HALF-OPEN: one parked resume is "
            "released as a probe; its survival closes the breaker, "
            "another death re-opens it.")
define_flag("serving_role", "mixed",
            "Disaggregated serving role this replica advertises via "
            "/statusz: 'prefill' replicas take new requests and run "
            "chunked prefill at full occupancy, 'decode' replicas adopt "
            "handed-off sessions and run the generation leg, 'mixed' "
            "does both (the classic fleet).  The role is a routing "
            "preference, not an engine capability — any role can serve "
            "any request.")
define_flag("router_prefill_handoff", True,
            "Prefill->decode handoff: with prefill-role replicas in the "
            "fleet, the router caps a new stream's first leg at one "
            "token on a prefill replica, ships the finished prefix KV "
            "over /migratez to a decode successor, and splices the "
            "decode leg into the SAME client stream (journal replay "
            "semantics; 0 re-prefilled full pages on the successor).  "
            "Off routes by role preference only, with no mid-stream "
            "handoff.")
define_flag("router_handoff_timeout_s", 30.0,
            "Bound on each handoff transfer call (/migratez export and "
            "import); past it the router falls back to re-prefilling "
            "the session on a mixed replica — the stream never drops.")
define_flag("router_spill_hit_weight", 0.5,
            "Placement score multiplier for an expected prefix hit "
            "whose page is SPILLED to the replica's host ring: swap-in "
            "costs a page upload, not a re-prefill, so a spilled hit "
            "scores between resident (1.0) and absent (0.0).")
define_flag("router_overlay_cap", 4096,
            "Global LRU cap on each replica's routed-overlay credit "
            "map (the optimistic just-routed prefix hashes scored "
            "before the next /statusz confirms them); evictions count "
            "in router.overlay_evictions.")
define_flag("router_quarantine_sweep_s", 5.0,
            "Min seconds between TTL sweeps of the poison-quarantine "
            "signature table on the read path (quarantined/progress "
            "checks); strikes always sweep inline.  Bounds the table "
            "even when no new strikes arrive.  <=0 sweeps every read.")
define_flag("router_quarantine_cap", 4096,
            "Max tracked poison-quarantine signatures (oldest evicted "
            "first; router.quarantine_entries gauges the table).")
define_flag("fleet_roles", "",
            "Role-specialized fleet spec: comma-separated role=target "
            "pairs, e.g. 'prefill=1,decode=2'.  Empty grows a classic "
            "mixed fleet.  Per-role autoscaling moves each role's target "
            "independently: prefill on queue depth / TTFT burn, decode "
            "on resident sessions / ITL burn.")
define_flag("fleet_rebalance", True,
            "Proactive hot-session rebalance: when a READY replica is "
            "shedding on SLO burn while a same-role peer still admits, "
            "the supervisor exports the burner's sessions, pre-stages "
            "them on the peer via the migration plane, and re-points the "
            "router's session pins — the burner cools instead of "
            "melting.  In-flight streams finish out on the source (drain "
            "semantics).")
define_flag("fleet_rebalance_cooldown_s", 10.0,
            "Min seconds between proactive rebalances (one victim per "
            "pass; the cooldown lets the SLO window react before the "
            "supervisor moves more state).")
define_flag("use_native_dataloader", False,
            "Route DataLoader prefetch through the C++ ring-buffer engine "
            "(native/ringbuf.cc) with worker threads.  Off by default: "
            "with num_workers > 0 the loader forks worker processes over "
            "the shared-memory ring (io/mp_loader.py).")
