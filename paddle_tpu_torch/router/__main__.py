"""``python -m paddle_tpu_torch.router`` — the multi-replica router as a
process (also the ``paddle-tpu-torch-router`` console script).

Replicas are ``--replica HOST:PORT`` upstreams (spawn each with
``python -m paddle_tpu_torch.serving``); placement policy and health and
scoring knobs ride the ``FLAGS_router_*`` flag family, settable with
``--set NAME=VALUE`` as in the replica launcher.  ``--store`` (joining a
multi-router control plane) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="paddle-tpu-torch-router",
        description="Prefix-aware, session-affine router over N "
                    "paddle_tpu_torch serving replicas: one OpenAI-"
                    "compatible front door with aggregate SLO shedding, "
                    "health checking and failover.")
    p.add_argument("--replica", action="append", default=[],
                   metavar="HOST:PORT", dest="replicas",
                   help="one serving replica upstream; repeat per replica")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--store", default=None, metavar="HOST:PORT",
                   help="membership store endpoint of a multi-router "
                        "control plane (not ported yet: raises)")
    p.add_argument("--router-id", default="router0",
                   help="this router's identity")
    p.add_argument("--policy", choices=("scored", "round_robin"),
                   default=None,
                   help="placement policy (default: "
                        "FLAGS_router_placement)")
    p.add_argument("--model-name", default="paddle-tpu-torch")
    p.add_argument("--set", action="append", default=[],
                   metavar="NAME=VALUE", dest="flag_sets",
                   help="set any FLAGS_* by name, repeatable "
                        "(e.g. --set router_health_interval_s=1.0)")
    return p


def parse_replicas(specs: List[str]):
    from .replica import HttpReplica
    out = []
    for i, spec in enumerate(specs):
        host, sep, port = spec.rpartition(":")
        if not sep or not port.isdigit():
            raise SystemExit(
                f"--replica expects HOST:PORT, got {spec!r}")
        out.append(HttpReplica(f"r{i}", host or "127.0.0.1", int(port)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.store:
        raise NotImplementedError(
            "--store (the multi-router control plane) is ROADMAP item 13b "
            "and not ported yet")
    from ..serving.__main__ import apply_flag_sets
    apply_flag_sets(args.flag_sets)
    if not args.replicas:
        raise SystemExit("need --replica HOST:PORT (repeatable)")
    replicas = parse_replicas(args.replicas)
    from .server import route_forever
    route_forever(replicas, host=args.host, port=args.port,
                  model_name=args.model_name, policy=args.policy,
                  router_id=args.router_id)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
