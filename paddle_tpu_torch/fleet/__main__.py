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
``FLAGS_fleet_*`` family.

``--routers N`` (N > 1) shards ``X-Session-Id`` space over a consistent-hash
ring of routers: this process runs router rt0 and the membership store, and
the supervisor runs rt1..rt<N-1> as ``python -m paddle_tpu_torch.router``
subprocesses on ``--router-port-base + i`` that discover the replicas from
the store.  The launcher owns the fleet's ``TraceCollector``: replicas POST
their spans to rt0's ``/collectz``, spawned routers ship theirs through the
store, and ``GET /tracez?trace_id=`` on rt0 serves one merged timeline.
``--tensor-parallel N`` is forwarded to every replica's launcher.
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
                   help="router fleet size: 1 keeps one front door; N>1 "
                        "shards X-Session-Id space over a consistent-hash "
                        "ring (this process runs router rt0 and the "
                        "membership store and spawns rt1..rt<N-1> as "
                        "python -m paddle_tpu_torch.router subprocesses)")
    p.add_argument("--router-port-base", type=int, default=8901,
                   help="spawned router rt<i> listens on base+i; a "
                        "restarted router slot reuses its port")
    p.add_argument("--store-port", type=int, default=0,
                   help="membership store bind port (0 = ephemeral; bound "
                        "only when --routers > 1)")
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
                   help="tensor-parallel shard count forwarded to every "
                        "replica subprocess (--tensor-parallel on each "
                        "replica's launcher)")
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
    if args.tensor_parallel is not None:
        launch += ["--tensor-parallel", str(args.tensor_parallel)]
    if args.cache_dtype is not None:
        launch += ["--cache-dtype", args.cache_dtype]
    for pair in args.flag_sets:
        launch += ["--set", pair]
    return launch


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
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

    # fleet tracing: the launcher owns the fleet's trace collector.
    # Replica (and spawned router) processes export span batches back
    # here, over the membership store when there is one, else by HTTP POST
    # to the router's /collectz, and /tracez on the in-process router
    # serves the merged, clock-aligned timelines.
    from .. import flags as _flags
    from ..observability.collector import (InprocTransport, SpanExporter,
                                           TraceCollector)
    collector = TraceCollector()
    trace_on = float(_flags.flag("trace_sample_rate")) > 0

    launch = replica_launch_args(args)
    if trace_on and not str(_flags.flag("trace_collector")):
        # replicas POST spans to the router's /collectz unless the
        # operator pointed them elsewhere
        launch += ["--set", f"trace_collector={args.host}:{args.port}"]

    def spawner(rid: str, role: str = "mixed") -> ProcessReplicaHandle:
        # slot ids are "fs<i>"; a restarted slot keeps its port so the
        # router's HttpReplica target stays valid across generations.  A
        # role-tagged slot launches its subprocess with --role, or the
        # replica advertises "mixed" and the router never hands off.
        port = args.replica_port_base + int(rid.removeprefix("fs"))
        extra = ["--role", role] if role != "mixed" else []
        return ProcessReplicaHandle(rid, args.host, port,
                                    launch_args=launch + extra)

    # multi-router control plane: with --routers N>1 this process owns the
    # membership store (on its own thread and loop, so its port exists
    # before the router subprocesses spawn) and runs rt0 in-process on a
    # socket-free LocalStore face; rt1.. are supervised subprocesses that
    # join over the socket and discover the replicas from the store.
    controlplane = None
    router_spawner = None
    router_target = 0
    store_state = None
    if args.routers > 1:
        from ..controlplane import (LocalStore, RouterControlPlane,
                                    StoreServer, StoreState)
        store_state = StoreState()
        store_ready = threading.Event()
        store_port: List[int] = []

        def _store_thread():
            async def _run():
                srv = StoreServer(store_state)
                store_port.append(await srv.start(args.host,
                                                  args.store_port))
                store_ready.set()
                while True:
                    await asyncio.sleep(3600)
            asyncio.run(_run())

        threading.Thread(target=_store_thread, name="fleet-store",
                         daemon=True).start()
        if not store_ready.wait(timeout=10):
            raise SystemExit("membership store failed to bind")
        controlplane = RouterControlPlane(
            "rt0", LocalStore(store_state),
            advertise={"host": args.host, "port": args.port})

        router_launch: List[str] = ["--model-name",
                                    args.model_name or args.preset]
        if args.policy is not None:
            router_launch += ["--policy", args.policy]
        for pair in args.flag_sets:
            router_launch += ["--set", pair]

        def router_spawner(rid: str):
            from ..controlplane import ProcessRouterHandle
            port = args.router_port_base + int(rid.removeprefix("rt"))
            return ProcessRouterHandle(rid, args.host, port,
                                       store_host=args.host,
                                       store_port=store_port[0],
                                       launch_args=router_launch)

        router_target = args.routers - 1
        print(f"[paddle_tpu_torch fleet] membership store on "
              f"{args.host}:{store_port[0]}  routers={args.routers} "
              f"(ports from {args.router_port_base + 1})", flush=True)

    router = RouterServer([], policy=args.policy,
                          model_name=args.model_name or args.preset,
                          allow_empty=True, controlplane=controlplane)
    router.collector = collector
    sup = FleetSupervisor(router, spawner, target=args.replicas,
                          min_replicas=args.min_replicas,
                          max_replicas=args.max_replicas,
                          router_spawner=router_spawner,
                          router_target=router_target,
                          store=store_state, collector=collector)
    # this process's own spans (router rt0 and the supervisor) join the
    # merged timelines through the in-process transport
    exporter = None
    if trace_on:
        exporter = SpanExporter(InprocTransport(collector),
                                proc=f"fleet@{args.host}:{args.port}",
                                role="router")
        exporter.start()
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
        if exporter is not None:
            exporter.close()
        sup.shutdown(drain=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
