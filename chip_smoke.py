#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases, each printed as one JSON line and each raising on failure (nothing
is caught; there is no ``ok`` line unless every phase passed):

1. ``device``  — requires CUDA and compute capability (9, 0); prints the
   card's ``nvidia-smi`` name and power limit.
2. ``build``   — nvcc-builds every kernel under
   ``paddle_tpu_torch/kernels/csrc`` (one nvcc per source, in parallel).
3. ``kernel``  — the ragged paged-attention kernel against its plain
   PyTorch version on the card over a case matrix (decode and mixed
   prefill/decode, GQA groups 1/4/8, fp32 and bf16, ragged and page-exact
   contexts, idle rows), then CUDA-event times at the llama2_7b decode
   shape: kernel, plain version, ``scaled_dot_product_attention`` as a
   yardstick, and the memory-bound least time.
4. ``engine_parity`` — a 2-layer fp32 llama2_7b-width model served by the
   continuous-batching engine on the card, its greedy tokens held against
   the port's full-sequence forward on the CPU (teacher forcing).
5. ``serve``   — full llama2_7b (32 layers, bf16, random weights from a
   seed) behind ``ServingServer.start_http`` with the launcher's defaults;
   8 concurrent streamed completions.  Kernel launch counts are reset just
   before and read just after.
6. the ``kernels`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device.  Imports nothing
of JAX.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12,    # fp32 outside the tensor cores
              "bfloat16": 989e12}  # bf16 dense tensor-core peak
TOL = {  # (rtol, atol) per output and dtype
    ("out", "float32"): (2e-5, 2e-5),     # fp32: summation order only
    ("lse", "float32"): (2e-5, 2e-5),
    ("out", "bfloat16"): (1e-2, 2e-2),    # one bf16 rounding of the output
    ("lse", "bfloat16"): (0.0, 1e-3),     # fp32 lse from bf16 inputs
}
KERNEL_SOURCE = "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu"
KERNEL_REPLACES = "paddle_tpu/kernels/paged_attention.py:163"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ device ---

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA H100")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), "
                         f"found {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    # fp32 references must be full fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=name, nvidia_smi=smi, capability=list(cap),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return name, smi


# ------------------------------------------------------------- build ---

def phase_build():
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": b["seconds"],
                      "ptxas": [ln for ln in b["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for n, b in built.items()})


# ------------------------------------------------------------ kernel ---

def make_case(gen, *, B, T, qh, kvh, d, page, ctxs, qls, dtype):
    """Random inputs on the card; block-table entries past each context
    hold out-of-range garbage the kernel must never dereference."""
    import torch
    dev = "cuda"
    need = [-(-c // page) for c in ctxs]
    W = max(need) + 2
    n_pages = sum(need) + 8
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    bt = torch.empty((B, W), dtype=torch.int32, device=dev)
    bt[:, 0::2] = 1_000_000
    bt[:, 1::2] = -7
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[used:used + n]
        used += n

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return dict(q=rnd(B, T, qh, d), k_cache=rnd(kvh, n_pages, page, d),
                v_cache=rnd(kvh, n_pages, page, d), block_tables=bt,
                context_lens=torch.tensor(ctxs, dtype=torch.int32, device=dev),
                q_lens=torch.tensor(qls, dtype=torch.int32, device=dev),
                k_new=rnd(B, T, kvh, d), v_new=rnd(B, T, kvh, d))


def bound_ms(B, qh, kvh, d, ctxs, T, dtype):
    """Least time: the larger of bytes moved / HBM rate and flops / peak.
    Bytes: each live K/V row once, q, the fresh rows, out and lse once."""
    import torch
    it = torch.empty((), dtype=dtype).element_size()
    kv = sum(ctxs) * kvh * d * 2 * it
    io = B * T * (qh * d * 2 + kvh * d * 2) * it + B * T * qh * 4
    flops = sum(4 * T * qh * (c + T) * d for c in ctxs)
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = (kv + io) / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel():
    import torch
    from paddle_tpu_torch.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(0)
    decode = dict(B=8, T=1, ctxs=[1, 15, 16, 17, 255, 512, 1000, 1023],
                  qls=[1] * 8, page=16, d=128)
    mixed = dict(B=4, T=64, ctxs=[0, 16, 33, 960], qls=[64, 1, 17, 0],
                 page=16, d=128)
    shapes = [("decode", decode, 32), ("decode", decode, 8),
              ("decode", decode, 4), ("mixed", mixed, 32),
              ("mixed", mixed, 8), ("mixed", mixed, 4),
              ("mixed_d64_page8", {**mixed, "d": 64, "page": 8}, 8),
              ("mixed_page128", {**mixed, "page": 128}, 4)]
    cases, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, shp, kvh in shapes:
            c = make_case(gen, qh=32, kvh=kvh, dtype=dtype, **shp)
            out, lse = pa.ragged_paged_attention(
                c["q"], c["k_cache"], c["v_cache"], c["block_tables"],
                c["context_lens"], q_lens=c["q_lens"], k_new=c["k_new"],
                v_new=c["v_new"], with_lse=True)
            ref, ref_lse = pa._reference_ragged_paged_attention(
                c["q"], c["k_cache"], c["v_cache"], c["block_tables"],
                c["context_lens"], c["q_lens"], c["k_new"], c["v_new"])
            torch.cuda.synchronize()
            if not (torch.isfinite(out.float()).all()
                    and torch.isfinite(lse).all()):
                raise AssertionError(f"{label}/{dname}: non-finite output "
                                     "(idle and past-q_lens rows included)")
            # rows past q_lens are don't-care: compare only valid rows
            keep = torch.arange(shp["T"], device="cuda")[None, :] < \
                c["q_lens"][:, None]
            row = {"case": label, "dtype": dname, "qh": 32, "kvh": kvh,
                   "d": shp["d"], "page": shp["page"], "T": shp["T"]}
            for which, got, want in (("out", out, ref), ("lse", lse, ref_lse)):
                g, w = got[keep].float(), want[keep].float()
                err = (g - w).abs()
                rtol, atol = TOL[(which, dname)]
                bad = int((err > atol + rtol * w.abs()).sum())
                row[f"{which}_max_abs_err"] = float(err.max())
                row[f"{which}_tol"] = [rtol, atol]
                if bad:
                    raise AssertionError(f"{label}/{dname} {which}: {bad} "
                                         f"elements out of tolerance "
                                         f"(max err {float(err.max())})")
                worst[which] = max(worst.get(which, 0.0), float(err.max()))
            cases.append(row)

    # timing at the llama2_7b decode shape of the serve phase (bf16,
    # B=8, 32 heads, d=128, page 16, context 512 each)
    ctxs = [512] * 8
    c = make_case(gen, B=8, T=1, qh=32, kvh=32, d=128, page=16, ctxs=ctxs,
                  qls=[1] * 8, dtype=torch.bfloat16)
    args = (c["q"], c["k_cache"], c["v_cache"], c["block_tables"],
            c["context_lens"])
    kw = dict(q_lens=c["q_lens"], k_new=c["k_new"], v_new=c["v_new"])
    # the library yardstick attends the same keys: gathered cache + new row
    flat = c["block_tables"][:, :32].reshape(-1).long()
    kg = c["k_cache"][:, flat].reshape(32, 8, 512, 128).transpose(0, 1)
    vg = c["v_cache"][:, flat].reshape(32, 8, 512, 128).transpose(0, 1)
    k_all = torch.cat([kg, c["k_new"].transpose(1, 2)], dim=2).contiguous()
    v_all = torch.cat([vg, c["v_new"].transpose(1, 2)], dim=2).contiguous()
    q_sdpa = c["q"].transpose(1, 2).contiguous()          # [B, qh, 1, d]
    F = torch.nn.functional
    lib = F.scaled_dot_product_attention(q_sdpa, k_all, v_all)
    mine = pa.ragged_paged_attention(*args, **kw)
    torch.cuda.synchronize()
    lib_err = float((lib.transpose(1, 2).float() - mine.float()).abs().max())
    t = {}
    for key, fn in (("plain", lambda: pa._reference_ragged_paged_attention(
                        *args, c["q_lens"], c["k_new"], c["v_new"])),
                    ("kernel", lambda: pa.ragged_paged_attention(*args, **kw)),
                    ("library", lambda: F.scaled_dot_product_attention(
                        q_sdpa, k_all, v_all)),
                    ("kernel2", lambda: pa.ragged_paged_attention(*args, **kw)),
                    ("plain2", lambda: pa._reference_ragged_paged_attention(
                        *args, c["q_lens"], c["k_new"], c["v_new"]))):
        t[key] = cuda_ms(fn, 20 if key.startswith("plain") else 200)
    b_ms, b_by = bound_ms(8, 32, 32, 128, ctxs, 1, torch.bfloat16)
    timing = {"shape": "llama2_7b decode B=8 ctx=512 bf16",
              "kernel_ms": min(t["kernel"], t["kernel2"]),
              "kernel_ms_runs": [t["kernel"], t["kernel2"]],
              "plain_ms": min(t["plain"], t["plain2"]),
              "plain_ms_runs": [t["plain"], t["plain2"]],
              "library_ms": t["library"], "library_max_abs_err": lib_err,
              "bound_ms": b_ms, "bound_by": b_by}
    emit("kernel", cases=cases, max_abs_err=worst, timing=timing)
    return worst, timing


# ----------------------------------------------------- engine parity ---

def phase_engine_parity():
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    eng = ContinuousBatchingEngine(
        model, max_batch=4, gen=GenerationConfig(max_new_tokens=16),
        max_seq_len=256, page_size=16, prefill_bucket=64, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 64, 100, 200)]
    n0, s0 = pa.LAUNCHES, eng.steps
    rids = [eng.add_request(p) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    steps = eng.steps - s0
    launches = pa.LAUNCHES - n0
    if launches != cfg.num_hidden_layers * steps:
        raise AssertionError(f"kernel launches {launches} != layers x steps "
                             f"{cfg.num_hidden_layers} x {steps}")

    # teacher-force the engine's tokens through the full-sequence forward
    # on the CPU (fp32, the plain attention)
    cpu = model.to("cpu")
    near_ties, checked = 0, 0
    for p, rid in zip(prompts, rids):
        toks = out[rid]
        if len(toks) != 16:
            raise AssertionError(f"request {rid}: {len(toks)} tokens, want 16")
        seq = torch.tensor([p + toks[:-1]], dtype=torch.long)
        logits = cpu(seq)[0, len(p) - 1:].float()
        for j, tok in enumerate(toks):
            row = logits[j]
            checked += 1
            if int(row.argmax()) == tok:
                continue
            gap = float(row.max() - row[tok])
            if gap <= 1e-3 * float(row.abs().max()):
                near_ties += 1
                continue
            raise AssertionError(
                f"request {rid} token {j}: engine {tok}, CPU argmax "
                f"{int(row.argmax())}, logit gap {gap}")
    emit("engine_parity", layers=cfg.num_hidden_layers,
         hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
         prompt_lens=[len(p) for p in prompts], new_tokens=16,
         tokens_checked=checked, near_ties=near_ties, engine_steps=steps,
         kernel_launches=launches)


# ------------------------------------------------------------- serve ---

async def _client(host, port, prompt, max_tokens):
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                       "stream": True}).encode()
    t0 = time.perf_counter()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = (await reader.readline()).decode()
    ids, ttft, finish = [], None, None
    while True:
        line = await reader.readline()
        if not line:
            break
        if not line.startswith(b"data: ") or line.strip() == b"data: [DONE]":
            continue
        ch = json.loads(line[len(b"data: "):])["choices"][0]
        if ch["token_ids"] and ttft is None:
            ttft = time.perf_counter() - t0
        ids.extend(ch["token_ids"])
        finish = ch["finish_reason"] or finish
    writer.close()
    await writer.wait_closed()
    return {"status": status.strip(), "ids": ids, "ttft_s": ttft,
            "finish": finish, "seconds": time.perf_counter() - t0}


def phase_serve():
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.__main__ import build_engine, build_parser

    torch.cuda.reset_peak_memory_stats()
    args = build_parser().parse_args(["--preset", "llama2_7b"])
    t0 = time.perf_counter()
    engine = build_engine(args)
    cfg = engine.g.config
    srv = ServingServer(engine, model_name="llama2_7b", warmup=True)
    rng = np.random.default_rng(1)
    lens = [int(x) for x in np.linspace(32, 512, 8)]
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    max_tokens = 64

    async def go():
        host, port = await srv.start_http("127.0.0.1", 0)
        try:
            while not srv.ready():
                if not srv.engine_alive():
                    raise RuntimeError("engine thread died during warmup")
                await asyncio.sleep(0.05)
            t_ready = time.perf_counter() - t0
            # the main path's run: counts from zero, read right after
            pa.LAUNCHES = 0
            steps0 = engine.steps
            t1 = time.perf_counter()
            res = await asyncio.gather(*[
                _client(host, port, p, max_tokens) for p in prompts])
            wall = time.perf_counter() - t1
            return res, wall, pa.LAUNCHES, engine.steps - steps0, t_ready
        finally:
            await srv.stop_http()

    res, wall, launches, steps, t_ready = asyncio.run(go())
    for n, r in zip(lens, res):
        if r["finish"] != "length" or len(r["ids"]) != max_tokens or \
                not all(0 <= t < cfg.vocab_size for t in r["ids"]):
            raise AssertionError(f"prompt of {n} tokens: {r['status']}, "
                                 f"finish {r['finish']}, "
                                 f"{len(r['ids'])} ids")
    if launches == 0 or launches != cfg.num_hidden_layers * steps:
        raise AssertionError(f"kernel launches {launches} != layers x steps "
                             f"{cfg.num_hidden_layers} x {steps}")
    ttfts = sorted(r["ttft_s"] for r in res)
    emit("serve", preset="llama2_7b", layers=cfg.num_hidden_layers,
         dtype=cfg.dtype, max_batch=args.max_batch,
         max_seq_len=args.max_seq_len, page_size=args.page_size,
         prefill_bucket=args.prefill_bucket, num_pages=engine.g.num_pages,
         pool_bytes=engine.g.pool_bytes, prompt_lens=lens,
         max_tokens=max_tokens, requests=len(res),
         setup_and_warmup_s=t_ready, wall_s=wall,
         tokens_per_s=len(res) * max_tokens / wall,
         ttft_p50_s=float(np.median(ttfts)), ttft_max_s=ttfts[-1],
         engine_steps=steps, kernel_launches=launches,
         launches_per_step=launches / steps,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return launches


def main() -> int:
    name, _smi = phase_device()
    import torch
    phase_build()
    worst, timing = phase_kernel()
    phase_engine_parity()
    launches = phase_serve()
    print(json.dumps({"kernels": [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": worst["out"],
        "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
