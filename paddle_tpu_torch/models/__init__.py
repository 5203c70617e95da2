"""Models of the port: Llama (dense and Mixtral-style MoE), GPT-2 and DiT
with its diffusion schedule and training step."""

from .dit import DiT, DiTConfig, DiTTrainStep, GaussianDiffusion
from .gpt import GPTConfig, GPTForCausalLM
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel

__all__ = ["DiT", "DiTConfig", "DiTTrainStep", "GaussianDiffusion",
           "GPTConfig", "GPTForCausalLM", "LlamaConfig", "LlamaForCausalLM",
           "LlamaModel"]
