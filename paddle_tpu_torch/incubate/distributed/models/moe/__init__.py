from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate  # noqa: F401
from .moe_layer import MoELayer  # noqa: F401

__all__ = ["BaseGate", "GShardGate", "MoELayer", "NaiveGate", "SwitchGate"]
