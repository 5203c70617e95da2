"""Serving inference of the port: paged KV cache, the fused engine step,
continuous batching, the prefix cache, speculative decoding and the host
spill tier (port of ``paddle_tpu/inference``)."""

from .generation import (ContinuousBatchingEngine, GenerationConfig,
                         LlamaGenerator, Request, generate)
from .kv_cache import PagedKVCache, PageAllocator
from .kv_spill import HostSpillPool
from .migration import (MigrationError, export_session, import_session,
                        import_sessions)
from .prefix_cache import MatchPlan, PrefixCache, block_hashes, serving_stats
from .speculative import SpecConfig, SpecHistory, resolve_spec_config

__all__ = ["ContinuousBatchingEngine", "GenerationConfig", "HostSpillPool",
           "LlamaGenerator", "MatchPlan", "MigrationError", "PagedKVCache",
           "PageAllocator", "PrefixCache", "Request", "SpecConfig",
           "SpecHistory", "block_hashes", "export_session", "generate",
           "import_session", "import_sessions", "resolve_spec_config",
           "serving_stats"]
