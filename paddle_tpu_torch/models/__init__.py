"""Models of the port: Llama, dense and Mixtral-style MoE."""

from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM"]
