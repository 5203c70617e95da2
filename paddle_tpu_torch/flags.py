"""Global flag registry (a copy of ``paddle_tpu/flags.py``'s registry).

Flags are seeded from the environment (``FLAGS_<name>``) at definition time
and set at run time with :func:`set_flags` (the launcher's ``--set``).  Only
the flags the ported serving path reads are registered here.
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
            "dtype, 'fp32'/'float32'/'bf16'/'bfloat16' force a float pool. "
            "'int8' (quantized pages) is not ported yet and raises.")
