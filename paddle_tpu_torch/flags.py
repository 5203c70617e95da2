"""Global flag registry (a copy of ``paddle_tpu/flags.py``'s registry).

Flags are seeded from the environment (``FLAGS_<name>``) at definition time
and set at run time with :func:`set_flags` (the launcher's ``--set``).  Only
the flags the ported serving path reads are registered here, with the
reference's names and defaults.
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
