"""``python -m paddle_tpu_torch.fleet`` — supervisor + router + N replica
processes in one command (also the ``paddle-tpu-torch-fleet`` console
script).

One process runs the RouterServer (asyncio, main thread) and the
FleetSupervisor control loop (side thread); each replica is a real
``python -m paddle_tpu_torch.serving`` subprocess on its own port,
registered with the router only after its ``/readyz`` warm-up gate passes.
``--device`` (default ``cuda``), ``--preset``, ``--num-layers``,
``--prefix-cache``, ``--cache-dtype`` and every ``--set`` are forwarded to
each replica; ``--set fleet_roles=prefill=1,decode=1`` grows a
disaggregated fleet whose replicas start with ``--role``.  Crash restart,
wedge detection, autoscaling between ``--min-replicas`` and
``--max-replicas`` and the SIGTERM graceful drain ride the
``FLAGS_fleet_*`` family.  ``--routers`` above 1 (the multi-router control
plane) and ``--tensor-parallel`` are not ported yet and raise.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

_PRESETS = ("tiny", "llama2_7b", "llama2_13b", "mixtral_tiny",
            "mixtral_8x7b")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="paddle-tpu-torch-fleet",
        description="Supervised elastic fleet: one router front door over "
                    "N paddle_tpu_torch serving replica processes with "
                    "sentinel-driven autoscaling, crash restart with "
                    "backoff, and graceful drain.")
    p.add_argument("--replicas", type=int, default=2,
                   help="initial fleet size (the autoscaler moves it "
                        "between --min-replicas and --max-replicas)")
    p.add_argument("--min-replicas", type=int, default=None,
                   help="autoscale floor (default: FLAGS_fleet_min_replicas)")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="autoscale ceiling (default: "
                        "FLAGS_fleet_max_replicas)")
    p.add_argument("--host", default="127.0.0.1",
                   help="router bind address (replicas bind the same "
                        "host on their own ports)")
    p.add_argument("--port", type=int, default=8080, help="router port")
    p.add_argument("--replica-port-base", type=int, default=8001,
                   help="replica slot i listens on base+i; a restarted "
                        "slot reuses its port")
    p.add_argument("--routers", type=int, default=1,
                   help="router fleet size; only 1 (one front door) is "
                        "ported, more raises")
    p.add_argument("--preset", choices=_PRESETS, default="tiny",
                   help="model preset forwarded to each replica")
    p.add_argument("--num-layers", type=int, default=None,
                   help="cut the preset's depth to this many layers on "
                        "every replica (widths unchanged)")
    p.add_argument("--device", default="cuda",
                   help="torch device forwarded to every replica (cuda or "
                        "cpu; a cuda replica without a GPU fails instead "
                        "of running on the CPU)")
    p.add_argument("--policy", choices=("scored", "round_robin"),
                   default=None,
                   help="router placement policy (default: "
                        "FLAGS_router_placement)")
    p.add_argument("--model-name", default=None,
                   help="name reported in completion responses "
                        "(default: the preset)")
    p.add_argument("--prefix-cache", action="store_true",
                   help="enable the shared-prefix KV cache on every "
                        "replica")
    p.add_argument("--tensor-parallel", type=int, default=None,
                   help="tensor-parallel shard count (not ported yet: "
                        "raises)")
    p.add_argument("--cache-dtype", default=None,
                   help="KV pool dtype forwarded to every replica")
    p.add_argument("--set", action="append", default=[],
                   metavar="NAME=VALUE", dest="flag_sets",
                   help="set any FLAGS_* by name, repeatable — applied "
                        "here AND forwarded to every replica "
                        "(e.g. --set fleet_restart_budget=5)")
    return p


def replica_launch_args(args) -> List[str]:
    """The options every replica subprocess is launched with."""
    launch: List[str] = ["--preset", args.preset, "--device", args.device]
    if args.num_layers is not None:
        launch += ["--num-layers", str(args.num_layers)]
    if args.prefix_cache:
        launch.append("--prefix-cache")
    if args.cache_dtype is not None:
        launch += ["--cache-dtype", args.cache_dtype]
    for pair in args.flag_sets:
        launch += ["--set", pair]
    return launch


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.routers > 1:
        raise NotImplementedError(
            "--routers > 1 (the multi-router control plane) is ROADMAP "
            "item 13b and not ported yet")
    if args.tensor_parallel is not None:
        raise NotImplementedError(
            "--tensor-parallel is ROADMAP item 14 and not ported yet")
    from ..serving.__main__ import apply_flag_sets
    apply_flag_sets(args.flag_sets)

    import asyncio
    import signal
    import threading

    from ..router.server import RouterServer
    from .supervisor import FleetSupervisor, ProcessReplicaHandle

    # a plain `kill` (SIGTERM) must run the same teardown Ctrl-C does:
    # without this the launcher dies on the default disposition and
    # orphans every replica subprocess on its port
    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)

    launch = replica_launch_args(args)

    def spawner(rid: str, role: str = "mixed") -> ProcessReplicaHandle:
        # slot ids are "fs<i>"; a restarted slot keeps its port so the
        # router's HttpReplica target stays valid across generations.  A
        # role-tagged slot launches its subprocess with --role, or the
        # replica advertises "mixed" and the router never hands off.
        port = args.replica_port_base + int(rid.removeprefix("fs"))
        extra = ["--role", role] if role != "mixed" else []
        return ProcessReplicaHandle(rid, args.host, port,
                                    launch_args=launch + extra)

    router = RouterServer([], policy=args.policy,
                          model_name=args.model_name or args.preset,
                          allow_empty=True)
    sup = FleetSupervisor(router, spawner, target=args.replicas,
                          min_replicas=args.min_replicas,
                          max_replicas=args.max_replicas)
    sup.start()
    stop = threading.Event()
    loop_thread = threading.Thread(target=sup.run_forever,
                                   kwargs={"stop": stop},
                                   name="fleet-supervisor", daemon=True)
    loop_thread.start()

    async def _serve():
        bound = await router.start_http(args.host, args.port)
        print(f"[paddle_tpu_torch fleet] router on "
              f"http://{bound[0]}:{bound[1]}  target={sup.target} "
              f"replicas (ports from {args.replica_port_base})",
              flush=True)
        try:
            while True:
                await asyncio.sleep(3600)
        finally:
            await router.stop_http()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        loop_thread.join(timeout=5)
        sup.shutdown(drain=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
