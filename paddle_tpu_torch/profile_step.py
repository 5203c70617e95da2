"""Where the time of a serving step, or of a training step, goes on the card.

    python -m paddle_tpu_torch.profile_step [--preset llama2_7b]
        [--num-layers N] [--cache-dtype int8] [--batch 8] [--context 512]
        [--steps 16]
    python -m paddle_tpu_torch.profile_step --train [pretrain options]
        [--top 12]
    python -m paddle_tpu_torch.profile_step --metrics-ab 4 [serving options]

With ``--train`` every other option is the pretrain entry point's
(``python -m paddle_tpu_torch.models.pretrain --help``; its defaults are
the llama2_7b run at B=4, T=2048 and 5 steps).  It builds the trainer
through that entry point's ``build_trainer`` (random weights and batch from
``--seed``), takes one warm-up step, times ``--steps`` − 1 steps without
the profiler and as many under ``torch.profiler``, and prints one JSON line:
wall milliseconds per step, tokens/s and MFU, device-busy milliseconds, the
device's idle share, the three flash-attention kernels (ms and launches per
step, the launches on the "sm90" route, and the forward's and the
backward's shares of the device-busy time), for MoE presets
(``--preset mixtral_8x7b --num-layers 4``) the three
grouped-matmul kernels (gmm forward, gmm ``trans_rhs``, ``tgmm``; ms and
launches per step, gmm's on the sm90 route beside them), cuBLAS GEMMs, the AdamW update and the cross-entropy
forward (the device time of the kernels launched inside their
``record_function`` ranges), and the top kernels.
Without it, it profiles a serving step as follows.

(``--preset mixtral_8x7b --num-layers 16`` is the Mixtral-width MoE model
cut to 16 layers, as ``chip_smoke.py`` serves it.)  Builds the model (random
weights from ``--seed``) and the engine with the launcher's geometry (page
16, prefill bucket 64, max_seq_len 1024, the pool in ``--cache-dtype``),
admits
``--batch`` requests of ``--context`` prompt tokens after a warm-up request,
and times the prefill steps (host clock around synchronised work), with
their attention launches by route (all, "split", "sm90").  It then
times ``--steps`` decode steps without the profiler (a drain every
``sync_every`` steps, as in serving), profiles as many again with
``torch.profiler`` (CPU and CUDA activities), and prints one JSON line: wall
milliseconds per decode step (unprofiled, and profiled for reference),
device-busy milliseconds per step from the profile, the device's idle share
(busy over the unprofiled wall), and the kernels that took the most device
time, with the shares of the ragged paged-attention kernels and of the
grouped-matmul kernels (MoE models) and their launches per step (the
attention's on its split route, gmm's on its sm90 route beside them).
The engine's telemetry follows ``FLAGS_metrics`` (``FLAGS_metrics=0 python
-m paddle_tpu_torch.profile_step`` times the step without it); the line
says which.

``--metrics-ab N`` compares the telemetry's host cost inside one process
instead: two engines over the same model, one with ``metrics=True`` and one
with ``metrics=False``, each with ``--batch`` requests of ``--context``
tokens prefilled, then N rounds of ``--steps`` decode steps on each in
turn (on, off, then off, on), each window timed on the host clock around
synchronised work; then two profiled windows on each, in turn (device-busy
ms and idle share), and one window each under ``cProfile`` (the host
functions that take the most time).  The "on" windows also carry what a
default ``ServingServer`` adds around its engine: the flight recorder's
span ring attached (the tracer's ``engine.step`` events and request spans)
and, after every step, the recorder's snapshot fold and the sentinel's
sweep.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def _device_events(prof, annotations: bool):
    """The profile's device-timeline events: the kernels (and memcpys and
    memsets), or with ``annotations`` the spans the profiler mirrors there
    for each ``record_function`` range (a span covers its kernels and the
    gaps between them, so it is never counted as busy time)."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and bool(getattr(e, "is_user_annotation", False)) == annotations]


def _device_ms(prof):
    """{kernel name: device ms} summed over the profile."""
    by_name = defaultdict(float)
    for evt in _device_events(prof, annotations=False):
        by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    return by_name


def _range_device_ms(prof, name):
    """Device ms of the kernels that start inside the device-side spans of
    ``record_function(name)`` (one stream: the kernels launched in it)."""
    spans = [(e.time_range.start, e.time_range.end)
             for e in _device_events(prof, annotations=True) if e.name == name]
    return sum(e.time_range.elapsed_us()
               for e in _device_events(prof, annotations=False)
               if any(s <= e.time_range.start < t for s, t in spans)) / 1e3


GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


_GMM_KERNEL = re.compile(r"gmm_(?:f32|sm90_wide|sm90_narrow)_kernel<([^>]*)>")


def grouped_kind(name: str):
    """Which grouped-matmul kernel a device kernel name is: 'tgmm' (its
    kernels and the sm90 route's gather pass, tgmm_gather_rows_kernel),
    'gmm_trans' (gmm with trans_rhs), 'gmm' (forward form), or None.  Every
    gmm kernel's second template argument is its trans_rhs flag
    (grouped_matmul.cu's gmm_f32_kernel<TM, TRANS>, grouped_matmul_sm90.cu's
    narrow <TM, TRANS> and wide <BN, TRANS, GATHER>)."""
    if "tgmm_" in name:
        return "tgmm"
    m = _GMM_KERNEL.search(name)
    if m is None:
        return None
    args = [a.strip() for a in m.group(1).split(",")]
    return "gmm_trans" if args[1] == "true" else "gmm"


def profile_train(argv) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .kernels import flash_attention as fa
    from .kernels import grouped_matmul as gm
    from .models import pretrain

    p = pretrain.build_parser()
    p.prog = "python -m paddle_tpu_torch.profile_step --train"
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    if torch.device(args.device).type != "cuda":
        raise SystemExit("profile_step --train profiles the card: "
                         "--device cuda")
    pretrain.use_expandable_segments()
    ps, state, ids, labels = pretrain.build_trainer(args)
    n = max(args.steps - 1, 1)
    state, _, _ = pretrain.run_steps(ps, state, ids, labels, 1)  # warm-up
    state, _, seconds = pretrain.run_steps(ps, state, ids, labels, n)

    def counts():
        return (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV,
                gm.LAUNCHES, gm.LAUNCHES_TRANS, gm.LAUNCHES_TGMM,
                fa.LAUNCHES_BWD_DQ_SM90, fa.LAUNCHES_BWD_DKV_SM90,
                fa.LAUNCHES_FWD_SM90, gm.LAUNCHES_SM90,
                gm.LAUNCHES_TRANS_SM90, gm.LAUNCHES_TGMM_SM90)

    c0 = counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, losses, profiled = pretrain.run_steps(ps, state, ids, labels,
                                                     n)
    launches = [c - c_ for c, c_ in zip(counts(), c0)]
    by_name = _device_ms(prof)
    busy_ms = sum(by_name.values())
    wall_ms = sum(seconds) * 1e3

    def share(*keys):
        return sum(v for k, v in by_name.items() if any(x in k for x in keys))

    # each kernel on either route (flash_attention.cu's flash_fwd_kernel,
    # flash_attention_fwd_sm90.cu's flash_fwd_sm90_kernel,
    # flash_attention_bwd_sm90.cu's flash_bwd_dq_sm90_kernel, and so on)
    flash = {nm: share(f"flash_{nm}_kernel", f"flash_{nm}_sm90_kernel") / n
             for nm in ("fwd", "bwd_dq", "bwd_dkv")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]
    moe = {}
    if ps.config.moe_num_experts:
        grouped = defaultdict(float)
        for k, v in by_name.items():
            if grouped_kind(k):
                grouped[grouped_kind(k)] += v
        kinds = ("gmm", "gmm_trans", "tgmm")
        moe = {"grouped_ms_per_step": {k: grouped[k] / n for k in kinds},
               "grouped_launches_per_step": dict(zip(
                   kinds, (x / n for x in launches[3:6]))),
               "grouped_sm90_launches_per_step": dict(zip(
                   kinds, (x / n for x in launches[9:12]))),
               "grouped_share_of_busy": sum(grouped.values()) / busy_ms
               if busy_ms else None}
    return {
        "mode": "train", "preset": args.preset,
        "layers": ps.config.num_hidden_layers, "batch": args.batch,
        "seq": args.seq, "remat_policy": args.remat_policy,
        "loss_chunks": args.loss_chunks, "m_dtype": args.m_dtype,
        "steps": n, "loss": losses[-1],
        **pretrain.throughput(ps, ids, seconds),
        "step_ms_profiled": sum(profiled) * 1e3 / n,
        "device_busy_ms_per_step": busy_ms / n if busy_ms else None,
        "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
        "flash_ms_per_step": flash,
        "flash_launches_per_step": dict(zip(("fwd", "bwd_dq", "bwd_dkv"),
                                            (x / n for x in launches[:3]))),
        "flash_fwd_sm90_launches_per_step": launches[8] / n,
        "flash_bwd_sm90_launches_per_step": dict(zip(
            ("bwd_dq", "bwd_dkv"), (x / n for x in launches[6:8]))),
        "flash_fwd_share_of_busy": flash["fwd"] * n / busy_ms
        if busy_ms else None,
        "flash_bwd_share_of_busy": (flash["bwd_dq"] + flash["bwd_dkv"]) * n
        / busy_ms if busy_ms else None,
        **moe,
        "gemm_ms_per_step": share(*GEMM_NAMES) / n,
        "adamw_ms_per_step": _range_device_ms(prof, "adamw") / n,
        "ce_forward_ms_per_step": _range_device_ms(prof, "ce_forward") / n,
        "top_kernels_ms_per_step": [[k, v / n] for k, v in top],
    }


def metrics_ab(args) -> dict:
    """The engine's telemetry on against off, in one process (see the
    module docstring)."""
    import cProfile
    import pstats

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import observability as obs
    from . import resolve_device
    from .inference import ContinuousBatchingEngine, GenerationConfig
    from .models.llama import LlamaConfig, LlamaForCausalLM

    dev = resolve_device("cuda")
    kw = {} if args.num_layers is None else \
        {"num_hidden_layers": args.num_layers}
    cfg = getattr(LlamaConfig, args.preset)(**kw)
    model = LlamaForCausalLM(cfg, device=dev, seed=args.seed)
    n = args.steps
    budget = n * (args.metrics_ab + 3) + 24
    engines = {}
    for name, on in (("on", True), ("off", False)):
        eng = ContinuousBatchingEngine(
            model, max_batch=args.batch,
            gen=GenerationConfig(max_new_tokens=budget), max_seq_len=1024,
            page_size=16, prefill_bucket=64, device=dev,
            cache_dtype=args.cache_dtype, metrics=on)
        eng.submit(list(range(1, 70)), max_new_tokens=2)
        eng.run()
        rng = np.random.default_rng(args.seed)
        for _ in range(args.batch):
            eng.submit(rng.integers(1, cfg.vocab_size,
                                    args.context).tolist())
        while eng.waiting or any(
                r is not None and eng.prompt_pos[b] < len(r.prompt)
                for b, r in enumerate(eng.slot_req)):
            eng.step()
        for _ in range(4):
            eng.step()
        engines[name] = eng

    recorder = obs.FlightRecorder()
    sentinel = obs.Sentinel(flight_recorder=recorder)

    def window(name):
        eng = engines[name]
        on = name == "on"
        if on:
            recorder.attach()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
            if on:
                recorder.maybe_snapshot()
                sentinel.maybe_check()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
        recorder.detach()
        return wall

    walls = {"on": [], "off": []}
    for r in range(args.metrics_ab):
        order = ("on", "off") if r % 2 == 0 else ("off", "on")
        for name in order:
            walls[name].append(window(name))
    out = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": _smi(),
           "preset": args.preset, "layers": cfg.num_hidden_layers,
           "batch": args.batch, "context": args.context, "steps": n,
           "rounds": args.metrics_ab,
           "decode_wall_ms_per_step": walls,
           "median_ms": {k: float(np.median(v)) for k, v in walls.items()}}
    for name in engines:
        out[name] = {"profiled_wall_ms_per_step": [],
                     "device_busy_ms_per_step": []}
    # two profiled windows each, in turn (on, off, off, on): the first
    # window a process profiles pays the profiler's start-up
    for name in ("on", "off", "off", "on"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = window(name)
        out[name]["profiled_wall_ms_per_step"].append(wall)
        out[name]["device_busy_ms_per_step"].append(
            sum(_device_ms(prof).values()) / n)
    for name in engines:
        busy = float(np.median(out[name]["device_busy_ms_per_step"]))
        host = cProfile.Profile()
        host.enable()
        host_wall = window(name)
        host.disable()
        st = pstats.Stats(host).stats
        top = sorted(st.items(), key=lambda kv: -kv[1][2])[:args.top]
        out[name].update({
            "device_idle_share": 1 - busy / float(np.median(walls[name])),
            "cprofile_wall_ms_per_step": host_wall,
            "host_tottime_ms_per_step": [
                [f"{f[0].rsplit('/', 1)[-1]}:{f[1]}:{f[2]}",
                 v[2] * 1e3 / n, v[1]] for f, v in top]})
    # the span events the "on" windows recorded (the ring keeps the last
    # FLAGS_flight_recorder_events of them)
    out["on"]["ring_events"] = len(recorder._ring)
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--train" in argv:
        argv.remove("--train")
        import torch

        from . import resolve_device
        dev = resolve_device("cuda")
        print(json.dumps({"device": torch.cuda.get_device_name(dev),
                          "nvidia_smi": _smi(), **profile_train(argv)}))
        return 0
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.profile_step",
        description="Profiles a serving step; with --train a training step "
                    "(then the other options are the pretrain entry "
                    "point's, and --top).")
    p.add_argument("--preset", default="llama2_7b")
    p.add_argument("--num-layers", type=int, default=None,
                   help="cut the preset's depth (widths unchanged)")
    p.add_argument("--cache-dtype", default=None,
                   help="KV pool dtype (fp32, bf16 or int8; default: the "
                        "model's)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--context", type=int, default=512)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--metrics-ab", type=int, default=0, metavar="N",
                   help="compare decode windows with the engine's "
                        "telemetry on and off, N rounds, in one process")
    args = p.parse_args(argv)
    if args.metrics_ab:
        print(json.dumps(metrics_ab(args)))
        return 0

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import resolve_device
    from .inference import ContinuousBatchingEngine, GenerationConfig
    from .kernels import grouped_matmul as gm
    from .kernels import paged_attention as pa
    from .models.llama import LlamaConfig, LlamaForCausalLM

    dev = resolve_device("cuda")
    smi = _smi()
    kw = {} if args.num_layers is None else \
        {"num_hidden_layers": args.num_layers}
    cfg = getattr(LlamaConfig, args.preset)(**kw)
    model = LlamaForCausalLM(cfg, device=dev, seed=args.seed)
    budget = 2 * args.steps + 16
    eng = ContinuousBatchingEngine(
        model, max_batch=args.batch, gen=GenerationConfig(max_new_tokens=budget),
        max_seq_len=1024, page_size=16, prefill_bucket=64, device=dev,
        cache_dtype=args.cache_dtype)
    # warm-up: build the kernel and initialise cuBLAS outside the timings
    eng.submit(list(range(1, 70)), max_new_tokens=2)
    eng.run()
    rng = np.random.default_rng(args.seed)
    for _ in range(args.batch):
        eng.submit(rng.integers(1, cfg.vocab_size, args.context).tolist())

    def prefilling():
        return any(r is not None and eng.prompt_pos[b] < len(r.prompt)
                   for b, r in enumerate(eng.slot_req)) or bool(eng.waiting)

    def attention_counts():                 # (all, split, sm90), both pools
        return (pa.LAUNCHES + pa.LAUNCHES_INT8,
                pa.LAUNCHES_SPLIT + pa.LAUNCHES_INT8_SPLIT,
                pa.LAUNCHES_SM90 + pa.LAUNCHES_INT8_SM90)

    torch.cuda.synchronize()
    prefill0 = attention_counts()
    t0 = time.perf_counter()
    n_prefill = 0
    while prefilling():
        eng.step()
        n_prefill += 1
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = [a - b for a, b in zip(attention_counts(), prefill0)]
    for _ in range(4):                      # warm decode steps
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):             # unprofiled decode steps
        eng.step()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    launches0 = pa.LAUNCHES + pa.LAUNCHES_INT8
    split0 = pa.LAUNCHES_SPLIT + pa.LAUNCHES_INT8_SPLIT
    gmm0, sm90_0 = gm.LAUNCHES, gm.LAUNCHES_SM90
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = pa.LAUNCHES + pa.LAUNCHES_INT8 - launches0
    split = pa.LAUNCHES_SPLIT + pa.LAUNCHES_INT8_SPLIT - split0
    gmm_launches = gm.LAUNCHES - gmm0
    gmm_sm90 = gm.LAUNCHES_SM90 - sm90_0

    by_name = _device_ms(prof)
    busy_ms = sum(by_name.values())
    attn_ms = sum(v for k, v in by_name.items()
                  if "ragged_paged_attn" in k)
    gmm_ms = sum(v for k, v in by_name.items() if grouped_kind(k))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]
    n = args.steps
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
        "preset": args.preset, "layers": cfg.num_hidden_layers,
        "metrics": eng._obs is not None,
        "kv_cache_dtype": eng.stats()["kv_cache_dtype"], "batch": args.batch,
        "context": args.context, "prefill_steps": n_prefill,
        "prefill_ms": prefill_ms,
        "prefill_attention_launches": dict(zip(
            ("all", "split", "sm90"), prefill_launches)),
        "decode_steps": n,
        "decode_wall_ms_per_step": plain_wall_ms / n,
        "decode_wall_ms_per_step_profiled": wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n if busy_ms else None,
        "device_idle_share": 1 - busy_ms / plain_wall_ms if busy_ms else None,
        "attention_ms_per_step": attn_ms / n if busy_ms else None,
        "attention_share_of_busy": attn_ms / busy_ms if busy_ms else None,
        "attention_launches_per_step": launches / n,
        "attention_split_launches_per_step": split / n,
        "gmm_ms_per_step": gmm_ms / n if busy_ms else None,
        "gmm_share_of_busy": gmm_ms / busy_ms if busy_ms else None,
        "gmm_launches_per_step": gmm_launches / n,
        "gmm_sm90_launches_per_step": gmm_sm90 / n,
        "top_kernels_ms_per_step": [[k, v / n] for k, v in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
