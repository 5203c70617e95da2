"""The Paddle-API path's random state (the port of
``paddle_tpu/core/random.py``).

The reference splits one JAX root key; the port keeps an explicit
``torch.Generator`` per device, seeded together by :func:`seed`.  The
initializers, dropout and the fused layers' masks draw from the generator of
the device they write to, so a draw never synchronises with the host.  The
values differ from the reference's (another generator); their shapes and
distributions do not.
"""

from __future__ import annotations

from typing import Dict

import torch

_DEFAULT_SEED = 0
_state = {"seed": _DEFAULT_SEED}
_generators: Dict[str, torch.Generator] = {}


def generator(device) -> torch.Generator:
    """The generator of ``device`` (made on first use from the current
    seed)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    g = _generators.get(key)
    if g is None:
        g = torch.Generator(device=dev)
        g.manual_seed(_state["seed"])
        _generators[key] = g
    return g


def seed(value: int) -> None:
    """Re-seed every device's generator (``paddle.seed``)."""
    _state["seed"] = int(value)
    for g in _generators.values():
        g.manual_seed(_state["seed"])


def get_rng_state() -> dict:
    """The seed and each device generator's state."""
    return {"seed": _state["seed"],
            "states": {k: g.get_state() for k, g in _generators.items()}}


def set_rng_state(state: dict) -> None:
    """Restore what :func:`get_rng_state` returned."""
    _state["seed"] = int(state["seed"])
    for key, s in state["states"].items():
        generator(key).set_state(s)
