"""Weight carry between the reference and the port (port of
``paddle_tpu/utils/__init__.py``'s ``extract_params`` / ``stack_params``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def extract_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Module -> {qualified_name: tensor} (insertion-ordered, no copies)."""
    return {name: p for name, p in module.named_parameters()}


def stack_params(param_dicts) -> Dict[str, torch.Tensor]:
    """[{name: tensor}, ...] -> {name: stacked tensor} (leading dim)."""
    keys = list(param_dicts[0])
    return {k: torch.stack([d[k] for d in param_dicts]) for k in keys}


@torch.no_grad()
def load_reference_state(model: nn.Module,
                         arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy a reference model's weights into ``model`` in place.

    ``arrays`` holds numpy arrays keyed by the reference's ``state_dict()``
    names (``llama.layers.0.self_attn.q_proj.weight``, ``[in, out]``; for
    MoE layers ``llama.layers.0.mlp.gate.weight`` ``[H, E]`` and the expert
    banks ``llama.layers.0.mlp.experts_gate``/``experts_up`` ``[E, H, I]``
    and ``experts_down`` ``[E, I, H]``) — the same names and layouts as the
    port's parameters, so both packages then compute the same function.  Every parameter must be given, with
    its exact shape; values are cast to the parameter's dtype.
    """
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, unexpected {extra}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(a).to(p.dtype))
    return model
