"""Where the time of a serving step goes on the card.

    python -m paddle_tpu_torch.profile_step [--preset llama2_7b]
        [--num-layers N] [--cache-dtype int8] [--batch 8] [--context 512]
        [--steps 16]

(``--preset mixtral_8x7b --num-layers 16`` is the Mixtral-width MoE model
cut to 16 layers, as ``chip_smoke.py`` serves it.)  Builds the model (random
weights from ``--seed``) and the engine with the launcher's geometry (page
16, prefill bucket 64, max_seq_len 1024, the pool in ``--cache-dtype``),
admits
``--batch`` requests of ``--context`` prompt tokens after a warm-up request,
and times the prefill steps (host clock around synchronised work).  It then
times ``--steps`` decode steps without the profiler (a drain every
``sync_every`` steps, as in serving), profiles as many again with
``torch.profiler`` (CPU and CUDA activities), and prints one JSON line: wall
milliseconds per decode step (unprofiled, and profiled for reference),
device-busy milliseconds per step from the profile, the device's idle share
(busy over the unprofiled wall), and the kernels that took the most device
time, with the shares of the ragged paged-attention kernel and of the
grouped-matmul kernel (MoE models) and their launches per step.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.profile_step")
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
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import resolve_device
    from .inference import ContinuousBatchingEngine, GenerationConfig
    from .kernels import grouped_matmul as gm
    from .kernels import paged_attention as pa
    from .models.llama import LlamaConfig, LlamaForCausalLM

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
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

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_prefill = 0
    while prefilling():
        eng.step()
        n_prefill += 1
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(4):                      # warm decode steps
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):             # unprofiled decode steps
        eng.step()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    launches0 = pa.LAUNCHES + pa.LAUNCHES_INT8
    gmm0 = gm.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = pa.LAUNCHES + pa.LAUNCHES_INT8 - launches0
    gmm_launches = gm.LAUNCHES - gmm0

    by_name = defaultdict(float)
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    attn_ms = sum(v for k, v in by_name.items()
                  if "ragged_paged_attn" in k)
    gmm_ms = sum(v for k, v in by_name.items() if "gmm_" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]
    n = args.steps
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
        "preset": args.preset, "layers": cfg.num_hidden_layers,
        "kv_cache_dtype": eng.stats()["kv_cache_dtype"], "batch": args.batch,
        "context": args.context, "prefill_steps": n_prefill,
        "prefill_ms": prefill_ms, "decode_steps": n,
        "decode_wall_ms_per_step": plain_wall_ms / n,
        "decode_wall_ms_per_step_profiled": wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n if busy_ms else None,
        "device_idle_share": 1 - busy_ms / plain_wall_ms if busy_ms else None,
        "attention_ms_per_step": attn_ms / n if busy_ms else None,
        "attention_share_of_busy": attn_ms / busy_ms if busy_ms else None,
        "attention_launches_per_step": launches / n,
        "gmm_ms_per_step": gmm_ms / n if busy_ms else None,
        "gmm_share_of_busy": gmm_ms / busy_ms if busy_ms else None,
        "gmm_launches_per_step": gmm_launches / n,
        "top_kernels_ms_per_step": [[k, v / n] for k, v in top],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
