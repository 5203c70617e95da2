"""``python -m paddle_tpu_torch.router`` — the multi-replica router as a
process (also the ``paddle-tpu-torch-router`` console script).

Replicas are ``--replica HOST:PORT`` upstreams (spawn each with
``python -m paddle_tpu_torch.serving``); placement policy and health and
scoring knobs ride the ``FLAGS_router_*`` flag family, settable with
``--set NAME=VALUE`` as in the replica launcher.

Multi-router control plane: ``--store HOST:PORT --router-id R`` joins this
router to an N-router fleet through the shared membership store.  It
heartbeats its liveness, owns its consistent-hash span of ``X-Session-Id``
space, forwards the sessions it does not own one hop to their owner, and
discovers the replica set from the supervisor's ``replica/<id>`` keys
(``--replica`` becomes optional).  Such a router holds no tensors and
creates no CUDA context.
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
                   help="one serving replica upstream; repeat per "
                        "replica (optional with --store: the replica set "
                        "is discovered from the membership store)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--store", default=None, metavar="HOST:PORT",
                   help="membership store endpoint: join the "
                        "multi-router control plane")
    p.add_argument("--router-id", default="router0",
                   help="this router's identity on the consistent-hash "
                        "ring (unique in a fleet; default router0)")
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
    from ..serving.__main__ import apply_flag_sets
    apply_flag_sets(args.flag_sets)
    if not args.replicas and not args.store:
        raise SystemExit("need --replica HOST:PORT (repeatable) or "
                         "--store HOST:PORT for store discovery")
    replicas = parse_replicas(args.replicas)
    controlplane = None
    if args.store:
        host, sep, port = args.store.rpartition(":")
        if not sep or not port.isdigit():
            raise SystemExit(f"--store expects HOST:PORT, got "
                             f"{args.store!r}")
        from ..controlplane import RouterControlPlane, StoreClient
        controlplane = RouterControlPlane(
            args.router_id,
            StoreClient(host or "127.0.0.1", int(port)),
            advertise={"host": args.host, "port": args.port})
    from .server import route_forever
    route_forever(replicas, host=args.host, port=args.port,
                  model_name=args.model_name, policy=args.policy,
                  allow_empty=bool(args.store),
                  router_id=args.router_id,
                  controlplane=controlplane,
                  discover_replicas=bool(args.store))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
