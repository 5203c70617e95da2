"""Global flag registry (a copy of ``paddle_tpu/flags.py``'s registry).

Flags are seeded from the environment (``FLAGS_<name>``) at definition time
and set at run time with :func:`set_flags` (the launcher's ``--set``).  Only
the flags the port reads are registered here (the serving engine, the front
door, observability, the watchdog), with the reference's names and
defaults.
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
