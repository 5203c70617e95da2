"""``python -m paddle_tpu_torch.serving`` — one serving replica as a process
(also the ``paddle-tpu-torch-serve`` console script).

The model is built with random weights from ``--seed`` directly on
``--device`` (default ``cuda``; with no GPU the launcher fails instead of
running on the CPU).  Any registered flag can be set with
``--set NAME=VALUE``.  The replica warms up before ``/readyz`` reports
ready unless ``--no-warmup`` is given.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .. import flags

_PRESETS = ("tiny", "llama2_7b", "llama2_13b", "mixtral_tiny",
            "mixtral_8x7b")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="paddle-tpu-torch-serve",
        description="One paddle_tpu_torch serving replica: OpenAI-shaped "
                    "streaming /v1/completions over the continuous-"
                    "batching engine, with /healthz and /readyz.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--preset", choices=_PRESETS, default="tiny",
                   help="model config preset (random-init weights)")
    p.add_argument("--num-layers", type=int, default=None,
                   help="cut the preset's depth to this many layers "
                        "(widths unchanged)")
    p.add_argument("--model-name", default=None,
                   help="name reported in completion responses "
                        "(default: the preset)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model and KV pool "
                        "(cuda or cpu)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="engine slots (continuous-batching width)")
    p.add_argument("--max-seq-len", type=int, default=1024)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--prefill-bucket", type=int, default=64)
    p.add_argument("--num-pages", type=int, default=None,
                   help="KV pool pages (default: engine sizing rule)")
    p.add_argument("--cache-dtype", default=None,
                   choices=("auto", "fp32", "float32", "bf16", "bfloat16",
                            "int8"),
                   help="KV page-pool storage dtype (FLAGS_kv_cache_dtype)")
    p.add_argument("--max-new-tokens", type=int, default=128,
                   help="default completion budget when the request "
                        "omits max_tokens")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the readiness warmup run")
    p.add_argument("--set", action="append", default=[],
                   metavar="NAME=VALUE", dest="flag_sets",
                   help="set any FLAGS_* by name, repeatable")
    return p


def apply_flag_sets(pairs: List[str]) -> None:
    """``--set NAME=VALUE`` pairs -> ``flags.set_flags``."""
    updates = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--set expects NAME=VALUE, got {pair!r}")
        name, value = pair.split("=", 1)
        updates[name.removeprefix("FLAGS_")] = value
    try:
        flags.set_flags(updates)
    except ValueError as e:
        raise SystemExit(str(e))


def engine_kwargs(args) -> dict:
    """The engine kwargs from parsed args (the one place launch geometry
    is threaded through to ``ContinuousBatchingEngine``)."""
    from ..inference import GenerationConfig

    kw = dict(max_batch=args.max_batch,
              gen=GenerationConfig(max_new_tokens=args.max_new_tokens),
              max_seq_len=args.max_seq_len, page_size=args.page_size,
              prefill_bucket=args.prefill_bucket, device=args.device)
    if args.num_pages is not None:
        kw["num_pages"] = args.num_pages
    if args.cache_dtype is not None:
        kw["cache_dtype"] = None if args.cache_dtype == "auto" \
            else args.cache_dtype
    return kw


def build_engine(args):
    """Model + engine from parsed args."""
    from ..inference import ContinuousBatchingEngine
    from ..models.llama import LlamaConfig, LlamaForCausalLM

    kw = {} if args.num_layers is None else \
        {"num_hidden_layers": args.num_layers}
    cfg = getattr(LlamaConfig, args.preset)(**kw)
    model = LlamaForCausalLM(cfg, device=args.device, seed=args.seed)
    return ContinuousBatchingEngine(model, **engine_kwargs(args))


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    apply_flag_sets(args.flag_sets)
    engine = build_engine(args)
    from .server import serve_forever
    serve_forever(engine, host=args.host, port=args.port,
                  model_name=args.model_name or args.preset,
                  warmup=not args.no_warmup)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
