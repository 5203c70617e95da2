"""Models of the port (dense Llama in this slice)."""

from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM"]
