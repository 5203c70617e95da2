"""Serving inference of the port: paged KV cache, the fused engine step,
continuous batching, the prefix cache, speculative decoding and the host
spill tier (port of ``paddle_tpu/inference``)."""

from .generation import (ContinuousBatchingEngine, GenerationConfig,
                         LlamaGenerator, Request, generate)
from .kv_cache import PagedKVCache, PageAllocator
from .kv_spill import HostSpillPool
from .prefix_cache import MatchPlan, PrefixCache, block_hashes
from .speculative import SpecConfig, SpecHistory, resolve_spec_config

__all__ = ["ContinuousBatchingEngine", "GenerationConfig", "HostSpillPool",
           "LlamaGenerator", "MatchPlan", "PagedKVCache", "PageAllocator",
           "PrefixCache", "Request", "SpecConfig", "SpecHistory",
           "block_hashes", "generate", "resolve_spec_config"]
