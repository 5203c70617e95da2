"""Serving inference of the port: paged KV cache, the fused engine step and
continuous batching (port of ``paddle_tpu/inference``)."""

from .generation import (ContinuousBatchingEngine, GenerationConfig,
                         LlamaGenerator, Request, generate)
from .kv_cache import PagedKVCache, PageAllocator

__all__ = ["ContinuousBatchingEngine", "GenerationConfig", "LlamaGenerator",
           "PagedKVCache", "PageAllocator", "Request", "generate"]
