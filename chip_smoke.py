#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

Run from the repository root on a machine with the card:

    python3 chip_smoke.py

Phases, each printed as one JSON line and each raising on failure (nothing
is caught; there is no ``ok`` line unless every phase passed):

1. ``device``  — requires CUDA and compute capability (9, 0); prints the
   card's ``nvidia-smi`` name and power limit.
2. ``build``   — nvcc-builds every kernel under
   ``paddle_tpu_torch/kernels/csrc`` and the generated primitive builds
   that ``kernel_primitives`` uses (one nvcc per source and per generated
   header, all in parallel).
3. ``kernel``  — the ragged paged-attention kernels (float pools) against
   their plain PyTorch version on the card over a case matrix (decode at
   contexts 0 to 1023, speculative verify at T 4, mixed prefill/decode at
   T 64, GQA groups 1/4/8, fp32 and bf16, ragged and page-exact contexts,
   idle rows, a pool dtype other than q's); every case with T x group <= 16
   must take the "split" route and every other the "tile" route (the
   route counters); then device times (CUDA-graph replays) at the
   llama2_7b decode shape: kernel (its split count, and its eager time
   beside), plain version, ``scaled_dot_product_attention`` as a
   yardstick, and the memory-bound least time.
4. ``kernel_int8`` — the same kernels over int8 pools (fp32 scale per
   (kv-head, page), pages 8/16/32, all-zero pages) against their plain
   version, routes as in ``kernel``, then times at the same decode shape
   with an int8 pool.
5. ``kernel_gmm`` — the grouped-matmul kernels against their plain version
   in fp32 and bf16, with and without the fused row gather (bm
   8/16/24/128/512, empty experts, one expert holding every row, zero
   sentinel rows, widths from 64 up to Mixtral's); every bf16 launch must
   take the "sm90" route (``grouped_matmul_sm90.cu``) and every fp32 launch
   the "simt" route, and ptxas must report 0 spill bytes for every sm90
   kernel (``gmm_sm90_ptxas``); then times at the Mixtral-width decode and
   prefill shapes, with ``torch._grouped_mm`` (or per-expert matmuls) as
   the yardstick.
6. ``engine_parity``, ``engine_parity_int8``, ``engine_parity_moe`` — a
   2-layer fp32 model (llama2_7b widths; the same over an int8 pool;
   Mixtral-8x7B widths) served by the continuous-batching engine on the
   card, its greedy tokens held against the port's full-sequence forward on
   the CPU (teacher forcing); near-ties are counted.
7. ``serve``, ``serve_int8``, ``serve_moe`` — through the launcher's
   ``build_engine`` and ``ServingServer.start_http`` with the launcher's
   geometry, 8 concurrent streamed completions each: full llama2_7b (32
   layers, bf16, random weights from a seed); the same over an int8 pool;
   Mixtral-8x7B widths cut to 16 layers, bf16.  Kernel launch counts are
   reset just before each run and read just after; decode steps take the
   attention's split route and prefill chunks its tile route, and every
   gmm launch the sm90 route.
8. ``kernel_flash`` — the three flash-attention kernels (forward, dQ,
   dK/dV) against their plain versions over every combination of causal
   or not, GQA groups 1/4/8, d 64/128, fp32/bf16 and five shapes (b 1 to 4,
   sq = sk from 128 to 2048, sq < sk, lengths off the 64-row tile), and at
   the training shape (b 4, s 2048, 32 heads, d 128, bf16, causal), each
   output held by its relative Frobenius error and elementwise against its
   RMS; then CUDA-event times at the training shape: each kernel, its plain
   version, its operations bound, and ``scaled_dot_product_attention``
   forward, backward and forward + backward as the yardstick.  All three
   kernels of every bf16 d 64/128 case must take the "sm90" route
   (``flash_attention_fwd_sm90.cu``, ``flash_attention_bwd_sm90.cu``:
   wgmma, TMA rings, warp specialisation) and every other case the "mma"
   route, by the route counters; at the training shape the forward, dQ and
   dK/dV must repeat bit for bit and ptxas must report no spill for the
   sm90 kernels at d 128; the line carries their ptxas record, the
   forward's and the backward pair's times and TFLOP/s beside SDPA's.
8b. ``kernel_flash_modes`` — the three flash kernels in every mode
    against their plain versions: an additive mask (one head plane or one
    per head, causal or not), segment ids (causal with equal packings; not
    causal with different ones and an empty key segment), dropout 0.1 and
    0.5 (causal or not), mask and dropout together; each in fp32 and bf16,
    GQA groups 1/4, d 64/96/128/256, b 2, sq 136 / sk 200 (lengths off the
    64-row tile); the forward's keep-mask read off its output (q = 0, v =
    I) on both routes (fp32 d 256, bf16 d 128) and held bit for bit
    against the plain ``_drop_keep_dense``; then, at llama2_7b attention
    widths (b 4, s 2048, 32 heads, d 128, bf16), the ``mask`` (fp32 [4, 1,
    2048, 2048], full), ``dropout`` (0.1, causal,
    ``nn.functional.flash_attention``) and ``varlen`` (one causal packing of
    8192 tokens through ``nn.functional.flash_attn_varlen_qkvpacked``)
    configurations: forward and backward through the public entry point
    (exactly one launch of each kernel, all on the "sm90" route), each
    kernel against its plain version, CUDA-event times beside the plain
    version, the operations bound and ``scaled_dot_product_attention``
    (with the mask in bf16; over
    the block-diagonal causal mask; with dropout as a cost reference only);
    then the port's ``nn.functional.scaled_dot_product_attention`` on the
    card against the CPU (fp32, bool and additive masks, causal, dropout).
9. ``train_parity`` — ``PretrainStep`` on the card (kernels) against the
   same step on the CPU (plain versions) from one ``restore_canonical``
   state: a 2-layer fp32 model at llama2_7b widths, B=2, T=256, remat and
   a 4-chunk loss, first-step gradients, then 3 steps' losses and
   parameters.
10. ``train`` — through the pretrain entry point's ``build_trainer``: full
    llama2_7b (bf16, remat full, 16 loss chunks, bf16 ``m``, fp32 ``v``),
    B=4, T=2048, 1 warm-up step then 4 timed steps; launch counts reset
    before the timed steps must be exactly 2·L·steps (forward, remat
    included) and L·steps (dQ, dK/dV); tokens/s, MFU and peak memory.
11. ``kernel_tgmm`` — first ptxas's record of the 4 ``tgmm_sm90`` kernels
    (0 spill bytes each, or it fails); then the MoE backward's grouped
    kernels against their plain versions in fp32 and bf16: ``tgmm`` with
    and without each fused row gather and the rhs scale, and ``gmm`` with
    ``trans_rhs`` and ``row_scale`` (bm 8/16/128/512, an expert with no
    rows, one expert holding every row, a truncated plan whose last expert
    owns no tile, zero sentinel rows, widths from 64 up to Mixtral's; each
    launch's route checked by the counters: bf16 on "sm90", fp32 on
    "simt"; every ``tgmm`` block the plain version gives as exact zeros is
    exact zeros); then, at the Mixtral training shape (8192 tokens, top-2,
    bm 512: M 20480 rows, 16384 of them live; H 4096, I 14336, bf16),
    ``tgmm`` for ``dw_gate`` and ``dw_down``, ``gmm`` ``trans_rhs`` for
    ``da`` and ``dx`` and the forward's gate/up and down ``gmm``, each
    held against its plain version (and the yardstick's output too; each
    on the sm90 route and bit for bit the same in two runs), then
    CUDA-event times beside the plain versions, the live rows' operations
    bound and ``torch._grouped_mm`` (or per-expert matmuls) as the
    yardstick.  The kernels line reports the launch-weighted mean of each
    kernel's forms on the training step.
12. ``moe_train_parity`` — ``PretrainStep`` on the card against the same
    step on the CPU from one ``restore_canonical`` state: 1 fp32 layer at
    Mixtral-8x7B widths (1.71 B parameters), B=2, T=256, remat and a
    4-chunk loss; first-step gradients, then 3 steps' losses and
    parameters (at most MOE_PARITY_FAR_SHARE further apart than 1e-6);
    tokens whose top-2 experts differ between card and CPU in the first
    forward are counted as near-ties.
13. ``train_moe`` — through the pretrain entry point's ``build_trainer``:
    Mixtral-8x7B widths cut to 4 layers (bf16, remat full, 16 loss chunks,
    bf16 ``m``, fp32 ``v``), B=4, T=2048, 1 warm-up step then 4 timed
    steps; launch counts reset before the timed steps must be exactly
    6·L·steps (gmm forward, remat included), 3·L·steps (gmm ``trans_rhs``),
    3·L·steps (``tgmm``), each all on the sm90 route, and the flash
    kernels' 2·L·steps, L·steps, L·steps; tokens/s, MFU on the active
    parameters, peak memory and the router's stats.
14. ``kernel_wo`` — the weight-only W8A16/W4A16 kernel against its plain
    version: int8 and int4, x in fp32/bf16/fp16, m 1/7/8/16/100/512, (k, n)
    from (64, 64) and (96, 200) up to every llama2_7b projection, with an
    odd int4 k (4095); each weight with an all-zero column (output exactly
    0); a [2, 3, 7, k] input through ``weight_only_linear`` with and
    without a bias; the empty batch; extreme codes; then CUDA-event times at
    llama2_7b's gate/up shape (k 4096, n 11008, bf16) for m 8 and 512:
    kernel, plain version, bound, the library call
    (``torch._weight_int8pack_mm`` for int8, ``torch._weight_int4pack_mm``
    for int4, each held against the plain version with its scale in bf16)
    and ``torch.matmul`` over the bf16 weight.
15. ``weight_only_path`` — all 225 projections of llama2_7b (32 layers, not
    cut, and the LM head; random bf16 weights from a seed) quantized on the
    card, int8 and int4, then ``weight_only_linear`` over all of them for
    m 8 and 512: launches counted from 0 over one untimed sweep per (m,
    mode), exactly 225 each; layer 0's and the head's outputs against the
    plain version; ms per sweep against the bytes bound and against the
    same sweep through ``torch.matmul`` in bf16; peak memory; ``dx`` on the
    card against the CPU.
16. ``kernel_primitives`` — the primitive library's generated kernels
    (``kernels/primitives.py``: each caller's function compiled into
    ``csrc/primitives.cu``) against their plain versions: elementwise
    ``silu(a) * b``, ``max(a, 0) * 2`` and ``a * b + c`` (mixed
    fp32/bf16/fp16 inputs) over 1, 37 x 19, 8 x 1024 and 1,000,003
    elements, within one ulp of the output + 1e-6 x (|want| + max |want|);
    reduce max/min/add, fp32/bf16/fp16, rows 1/100/8192, columns
    1/19/300/4096/32000 and, up to 4096 columns, an offset view off the
    16-byte alignment and for max/min rows with NaNs (the functors
    propagate NaN as torch.maximum does), bit for bit, each on the route ``_reduce_route`` names and both
    routes reached; matmul (1, 1, 1) up to llama2_7b's
    gate and down projections, fp32/bf16/fp16 in, the output in x's dtype
    and another, epilogues none/relu*2/silu, by PRIM_MM_TOL.  Then the
    library's path at llama2_7b widths (an FFN over 8192 rows, the LM head,
    the logits' row max, fp32 row sums, the gate with its silu fused), its
    launches counted from 0: 5 matmuls, 1 elementwise, 2 reduces (both on
    the "vec16" route); then CUDA-event times of SwiGLU [8192, 11008], row
    max [8192, 32000] (and its chain alone, ``chain_floor_ms``: the same
    kernel on 256 rows, with the NaN-propagating max and with ``fmaxf``
    alone), fp32 row sum [8192, 4096] and the gate projection with and
    without the silu epilogue, beside the plain versions, the bounds and
    ``torch.amax`` / ``torch.matmul`` (cost references where no one call
    computes the same function).
17. the ``kernels`` line (each kernel's launches on its routes under
    ``routes``), then the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device.  Imports nothing
of JAX.

    python3 chip_smoke.py --moe-parity-spread

runs only ``moe_train_parity``'s comparison over several seeds and with
TF32 on as a control, and prints the readings MOE_PARITY_FAR_SHARE is set
from (no ``ok`` line).

A phase runs alone after the device and build phases, e.g. the flash
kernels': ``python3 -c "import chip_smoke as c; c.phase_device();
c.phase_kernel_flash(c.phase_build())"`` (``phase_kernel_gmm`` and
``phase_kernel_tgmm`` take the build record too).
"""

from __future__ import annotations

import asyncio
import gc
import json
import math
import subprocess
import sys
import time

L2_BYTES = 50 * 2 ** 20            # H100 L2 cache
TOL = {  # (rtol, atol) per output and dtype
    ("out", "float32"): (2e-5, 2e-5),     # fp32: summation order only
    ("lse", "float32"): (2e-5, 2e-5),
    ("out", "bfloat16"): (1e-2, 2e-2),    # one bf16 rounding of the output
    ("lse", "bfloat16"): (0.0, 1e-3),     # fp32 lse from bf16 inputs
}
GMM_TOL = {"float32": (1e-4, 2e-5),    # (rtol, atol x max |ref|): sum order
           "bfloat16": (1e-2, 1e-2)}   # one bf16 rounding of the output
ATTN_SOURCE = "paddle_tpu_torch/kernels/csrc/ragged_paged_attention.cu"
ATTN_REPLACES = "paddle_tpu/kernels/paged_attention.py:163"
GMM_SOURCE = "paddle_tpu_torch/kernels/csrc/grouped_matmul.cu"
GMM_SM90_SOURCE = "paddle_tpu_torch/kernels/csrc/grouped_matmul_sm90.cu"
GMM_REPLACES = "paddle_tpu/kernels/grouped_matmul.py:205"
# the "sm90" route (bf16 at d 64 and 128): wgmma, TMA rings, warp
# specialisation; the libraries whose ptxas logs name its kernels
FLASH_FWD_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention_fwd_sm90.cu"
FLASH_BWD_SOURCE = "paddle_tpu_torch/kernels/csrc/flash_attention_bwd_sm90.cu"
FLASH_SM90_LIBRARIES = ("flash_attention_fwd_sm90", "flash_attention_bwd_sm90")
FLASH_REPLACES = {"fwd": "paddle_tpu/kernels/flash_attention.py:180",
                  "dq": "paddle_tpu/kernels/flash_attention.py:253",
                  "dkv": "paddle_tpu/kernels/flash_attention.py:317"}
# flash kernels vs plain, per output tensor: the relative Frobenius error
# ||got - want|| / ||want|| within `rel`, and every element within
# rtol x |want| + atol x the larger of its row's RMS and the tensor's (an
# RMS, not the largest magnitude: with causal attention row 0 is v_0
# itself, far above a long row's values)
FLASH_TOL = {"float32": dict(rel=1e-5, rtol=1e-4, atol=1e-4),  # sum order
             # p and ds rounded to bf16 before their matmuls, + the output
             "bfloat16": dict(rel=1e-2, rtol=2e-2, atol=5e-2)}
FLASH_LSE_ATOL = 1e-4                    # lse is fp32 in both dtypes
# (b, sq, sk) of the flash case matrix, and the training shape timed
FLASH_SHAPES = [(1, 128, 128), (2, 512, 512), (4, 2048, 2048),
                (3, 192, 640), (2, 100, 300)]
FLASH_TIMED = dict(b=4, s=2048, h=32, d=128)
# kernel_flash_modes: the mode matrix (name, causal, mask heads (0, 1 or
# "hq"), segments, dropout rate), its shape (b 2, sq 136, sk 200: lengths
# off the 64-row tile; 4 q-heads) and head dims; the segment packings
# (per batch row: q lengths, k lengths; "empty": a k segment of none, so
# its queries have no live key); the dropout seed; the keep-mask check
# (b, rows, heads, d = sk) and its rates; the varlen configuration's
# packing (timed at FLASH_TIMED's widths)
FLASH_MODE_CASES = (
    ("mask_h1_full", False, 1, None, 0.0),
    ("mask_h1_causal", True, 1, None, 0.0),
    ("mask_hq_full", False, "hq", None, 0.0),
    ("mask_hq_causal", True, "hq", None, 0.0),
    ("seg_causal", True, 0, "equal", 0.0),
    ("seg_full_empty_k", False, 0, "empty", 0.0),
    ("drop0.1_full", False, 0, None, 0.1),
    ("drop0.1_causal", True, 0, None, 0.1),
    ("drop0.5_full", False, 0, None, 0.5),
    ("drop0.5_causal", True, 0, None, 0.5),
    ("mask_drop0.1_causal", True, 1, None, 0.1),
)
FLASH_MODES_SHAPE = dict(b=2, sq=136, sk=200, hq=4)
FLASH_MODES_DIMS = (64, 96, 128, 256)
FLASH_MODE_SEGMENTS = {
    "equal": ([(50, 70, 80), (136, 64)], [(50, 70, 80), (136, 64)]),
    "empty": ([(60, 40, 100), (100, 100)], [(90, 0, 110), (150, 50)]),
}
FLASH_MODE_SEED = (1 << 23) - 1
# the keep-mask check on each route: (dtype, d = sk); b 2, s 2048, 4 heads
FLASH_KEEP_CHECK = dict(b=2, s=2048, h=4, routes=(("float32", 256),
                                                  ("bfloat16", 128)))
FLASH_KEEP_RATES = (0.1, 0.5)
FLASH_VARLEN_LENS = (512, 1024, 1536, 2048, 3072)
PARITY = dict(preset="llama2_7b", layers=2, batch=2, seq=256, steps=3)
# share of parameters further apart than 1e-6 after the parity steps:
# 8.4e-5 measured on an H100 80GB HBM3, with 6x room
PARITY_FAR_SHARE = 5e-4
TRAIN_ARGV = ["--preset", "llama2_7b", "--batch", "4", "--seq", "2048"]
TRAIN_STEPS = 4                    # timed, after one warm-up step
TGMM_REPLACES = "paddle_tpu/kernels/grouped_matmul.py:334"
# bf16 tgmm's route (fp32 stays on GMM_SOURCE's FMA kernel)
TGMM_SOURCE = "paddle_tpu_torch/kernels/csrc/tgmm_sm90.cu"
TGMM_SM90_KERNELS = 4              # its instantiations (BN x route)
# the Mixtral training shape of the grouped kernels: B=4 x T=2048 tokens,
# top-2 of 8 experts, bm 512 (M = 16384 live rows + 8 x 512 = 20480)
MOE_TIMED = dict(tokens=8192, E=8, k=2, bm=512, H=4096, I=14336)
# the MoE step's timed grouped forms with their launches per layer per step
# (models/llama.py _grouped_ffn_fwd, run twice with remat, and
# _grouped_ffn_bwd); the kernels line reports their launch-weighted means
MOE_MIX = {"forward": {"gmm_up": 4, "gmm_down": 2},
           "trans": {"trans_da": 1, "trans_dx": 2},
           "tgmm": {"tgmm_dw_gate": 2, "tgmm_dw_down": 1}}
MOE_PARITY = dict(preset="mixtral_8x7b", layers=1, batch=2, seq=256, steps=3)
# share of moe_train_parity's parameters further apart than 1e-6, set from
# `python3 chip_smoke.py --moe-parity-spread` on an H100 80GB HBM3: fp32
# read 1.3e-4 to 3.1e-4 over seeds 0-3, TF32 on (the control of a
# lower-precision step) 0.18 and 0.25; 6x above the one, 90x below the other
MOE_PARITY_FAR_SHARE = 2e-3
MOE_SPREAD_SEEDS = (0, 0, 1, 2, 3)
MOE_CONTROL_SEEDS = (0, 1)
TRAIN_MOE_ARGV = ["--preset", "mixtral_8x7b", "--num-layers", "4",
                  "--batch", "4", "--seq", "2048"]
WO_SOURCE = "paddle_tpu_torch/kernels/csrc/weight_only.cu"
WO_REPLACES = "paddle_tpu/kernels/weight_only.py:28"
# kernel_wo's case matrix: rows m, and (k, n) from tiny and ragged (n off
# the 16-byte vector, odd int4 k) up to every llama2_7b projection
WO_MS = (1, 7, 8, 16, 100, 512)
WO_KN = ((64, 64), (96, 200), (4095, 4096), (4096, 4096), (4096, 11008),
         (11008, 4096), (4096, 32000))
# the timed shape: llama2_7b's gate/up projection at decode (the serve
# phases' 8 slots) and in a 512-row prefill chunk, bf16 activations
WO_TIMED = dict(k=4096, n=11008, ms=(8, 512))
WO_PATH_MS = (8, 512)
WO_MODES = {"int8": "weight_only_int8", "int4": "weight_only_int4"}
# torch._weight_int4pack_mm's operands for the int4 library yardstick: the
# per-channel scale repeated in every group of 256 rows, zero points 0
WO_LIB_GROUP = 256
WO_LIB_INNER_K_TILES = 8
PRIM_SOURCE = "paddle_tpu_torch/kernels/csrc/primitives.cu"
PRIM_REPLACES = {"elementwise": "paddle_tpu/kernels/primitives.py:71",
                 "reduce": "paddle_tpu/kernels/primitives.py:102",
                 "matmul": "paddle_tpu/kernels/primitives.py:130"}
# kernel_primitives' matrix: elementwise sizes (flat element counts or
# shapes); reduce rows and columns; matmul (M, K, N), the last two
# llama2_7b's gate and down projections at B*T = 8192 rows
PRIM_EW_SHAPES = ((1,), (37, 19), (8, 1024), (1_000_003,))
PRIM_RED_ROWS = (1, 100, 8192)
PRIM_RED_COLS = (1, 19, 300, 4096, 32000)
# rows of the reduce matrix's offset-view and NaN cases
PRIM_RED_OFFSET_ROWS = 100
# rows of the reduce max's chain-floor timing (kernel_primitives)
PRIM_CHAIN_ROWS = 256
PRIM_MM_SHAPES = ((1, 1, 1), (100, 70, 50), (16, 24, 8), (257, 4095, 129),
                  (8192, 4096, 11008), (8192, 11008, 4096))
# matmul kernel vs plain, by output dtype, as _flash_check reads it: fp32
# sums in other orders (fp32 out); plus one rounding of the output, one ulp
# relative (bf16 2^-7, fp16 2^-10).  The fp32 relative Frobenius limit
# grows with k (_prim_mm_tol): sums of k terms in two orders, the tensor
# cores' fp32 accumulation among them, differ by ~sqrt(k) fp32 ulps (bf16
# in, fp32 out at k 11008 read 1.24e-5 on an H100 80GB HBM3)
PRIM_MM_TOL = {"float32": dict(rel=1e-5, rtol=1e-4, atol=1e-4),
               "bfloat16": dict(rel=1e-2, rtol=2.0 ** -7, atol=1e-4),
               "float16": dict(rel=2e-3, rtol=2.0 ** -10, atol=1e-4)}
# elementwise kernel vs plain: every element within one ulp of its output
# dtype (0 for fp32) + 1e-6 x |want| + 1e-6 x max |want| (the functor in
# fp32 on both sides; nvcc contracts a * b + c into one fma, expf rounds
# apart from torch's exp by an fp32 ulp)
PRIM_EW_TOL = 1e-6
# llama2_7b widths of the timed calls and of the path: B*T rows, hidden,
# FFN width, vocabulary
PRIM_WIDTHS = dict(rows=8192, hidden=4096, ffn=11008, vocab=32000)


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


def graph_ms(fn, calls: int, reps: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the device alone: ``calls``
    calls captured once into a CUDA graph, then ``reps`` replays between
    CUDA events.  For kernels shorter than their wrapper's host time, where
    ``cuda_ms`` would time the host; ``fn`` runs once before the capture
    (one-time set-up: library loads, kernel attributes)."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


# ------------------------------------------------------------ device ---

def _nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA H100")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), "
                         f"found {cap}")
    smi = _nvidia_smi()
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
    """Builds every library; returns ``_build.build_all``'s record (the
    ptxas logs among it)."""
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all(generated=_prim_headers())
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": b["seconds"],
                      "ptxas": [ln for ln in b["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for n, b in built.items()})
    return built


def _sm90_ptxas(log):
    """ptxas's record of each kernel of the sm90 route, from its libraries'
    build logs: ``{"fwd d128": {"registers", "spill_stores", "spill_loads",
    "stack_bytes"}, "dq d128": ..., ...}`` ("... modes" for the build with
    mask, segments and dropout).  ``registers`` is the launch count; the
    consumers raise theirs with setmaxnreg."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*flash_(?:bwd_)?(fwd|dq|dkv)"
                      r"_sm90_kernelILi(\d+)ELb(\d)", ln)
        if m:
            name = f"{m.group(1)} d{m.group(2)}" + (
                " modes" if m.group(3) == "1" else "")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


# ------------------------------------------------------------ kernel ---

def make_case(gen, *, B, T, qh, kvh, d, page, ctxs, qls, dtype,
              pool_dtype=None, zero_pages=0):
    """Random inputs on the card; block-table entries past each context
    hold out-of-range garbage the kernel must never dereference.  The pool
    is in ``pool_dtype`` (default: q's); an int8 pool is the per-(kv-head,
    page) absmax quantization of a random fp32 pool, with scales in
    ``k_scale``/``v_scale`` and its first ``zero_pages`` pages all-zero
    (scale 1.0, as a fresh pool holds them)."""
    import torch
    dev = "cuda"
    pool_dtype = pool_dtype or dtype
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
        return torch.randn(shape, generator=gen, device=dev)

    case = dict(q=rnd(B, T, qh, d).to(dtype), block_tables=bt,
                context_lens=torch.tensor(ctxs, dtype=torch.int32, device=dev),
                q_lens=torch.tensor(qls, dtype=torch.int32, device=dev),
                k_new=rnd(B, T, kvh, d).to(dtype),
                v_new=rnd(B, T, kvh, d).to(dtype))
    for name in ("k", "v"):
        pool = rnd(kvh, n_pages, page, d)
        if pool_dtype == torch.int8:
            pool[:, :zero_pages] = 0
            amax = pool.abs().amax(dim=(2, 3))
            sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            pool = torch.clamp(torch.round(pool / sc[..., None, None]),
                               -127, 127).to(torch.int8)
            case[f"{name}_scale"] = sc.contiguous()
        case[f"{name}_cache"] = pool.to(pool_dtype)
    return case


def _attn_args(c):
    return (c["q"], c["k_cache"], c["v_cache"], c["block_tables"],
            c["context_lens"])


def _attn_kw(c):
    return dict(q_lens=c["q_lens"], k_new=c["k_new"], v_new=c["v_new"],
                k_scale=c.get("k_scale"), v_scale=c.get("v_scale"))


def bound_ms(B, qh, kvh, d, ctxs, T, dtype, pool_dtype=None, page=16):
    """Least time: the larger of bytes moved / HBM rate and flops / peak.
    Bytes: each live K/V row once (plus one fp32 scale per live page and
    kv-head of an int8 pool), q, the fresh rows, out and lse once."""
    import torch
    it = torch.empty((), dtype=dtype).element_size()
    pool_dtype = pool_dtype or dtype
    kv_it = torch.empty((), dtype=pool_dtype).element_size()
    kv = sum(ctxs) * kvh * d * 2 * kv_it
    if pool_dtype == torch.int8:
        kv += sum(-(-c // page) for c in ctxs) * kvh * 2 * 4
    io = B * T * (qh * d * 2 + kvh * d * 2) * it + B * T * qh * 4
    flops = sum(4 * T * qh * (c + T) * d for c in ctxs)
    from paddle_tpu_torch import HBM_BYTES_PER_S, PEAK_FLOPS
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = (kv + io) / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _attention_matrix(gen, shapes, dtypes):
    """Run the kernel against its plain version over ``shapes`` (label,
    shape dict, kv heads, extra make_case kwargs) for each q dtype; returns
    (case rows, worst abs error per output)."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as pa
    cases, worst = [], {}
    for dtype in dtypes:
        for label, shp, kvh, extra in shapes:
            c = make_case(gen, qh=32, kvh=kvh, dtype=dtype, **shp, **extra)
            route = pa._route(shp["T"], 32 // kvh)
            n0 = pa.LAUNCHES_SPLIT + pa.LAUNCHES_INT8_SPLIT
            out, lse = pa.ragged_paged_attention(*_attn_args(c), **_attn_kw(c),
                                                 with_lse=True)
            took = pa.LAUNCHES_SPLIT + pa.LAUNCHES_INT8_SPLIT - n0
            if took != (route == "split"):
                raise AssertionError(f"{label}: the {route} route's case "
                                     f"counted {took} split launches")
            ref, ref_lse = pa._reference_ragged_paged_attention(
                *_attn_args(c), c["q_lens"], c["k_new"], c["v_new"],
                c.get("k_scale"), c.get("v_scale"))
            torch.cuda.synchronize()
            pool = str(c["k_cache"].dtype).replace("torch.", "")
            dname = str(dtype).replace("torch.", "")
            name = f"{label}/{dname}/pool {pool}"
            if not (torch.isfinite(out.float()).all()
                    and torch.isfinite(lse).all()):
                raise AssertionError(f"{name}: non-finite output (idle and "
                                     "past-q_lens rows included)")
            # rows past q_lens are don't-care: compare only valid rows
            keep = torch.arange(shp["T"], device="cuda")[None, :] < \
                c["q_lens"][:, None]
            bf = "bfloat16" in (dname, pool)
            tol_dt = "bfloat16" if bf else "float32"
            row = {"case": label, "dtype": dname, "pool": pool, "qh": 32,
                   "kvh": kvh, "d": shp["d"], "page": shp["page"],
                   "T": shp["T"], "route": route}
            if route == "split":
                row["splits"] = pa.split_plan(
                    shp["B"], kvh, c["block_tables"].shape[1], shp["page"])
            for which, got, want in (("out", out, ref), ("lse", lse, ref_lse)):
                g, w = got[keep].float(), want[keep].float()
                err = (g - w).abs()
                rtol, atol = TOL[(which, tol_dt)]
                bad = int((err > atol + rtol * w.abs()).sum())
                row[f"{which}_max_abs_err"] = float(err.max())
                row[f"{which}_tol"] = [rtol, atol]
                if bad:
                    raise AssertionError(f"{name} {which}: {bad} elements out "
                                         f"of tolerance (max err "
                                         f"{float(err.max())})")
                worst[which] = max(worst.get(which, 0.0), float(err.max()))
            cases.append(row)
    return cases, worst


def _attention_timing(gen, pool_dtype, library):
    """Device times at the llama2_7b decode shape of the serve phases (bf16
    q, B=8, 32 heads, d=128, page 16, context 512 each): kernel and plain
    version in turns (plain, kernel, kernel, plain), the bound, and
    ``scaled_dot_product_attention`` over the gathered keys when
    ``library``, each from CUDA-graph replays (``graph_ms``: the split
    kernel is shorter than its wrapper's host time); the kernel's eager
    time (``cuda_ms``, host included) beside them.  Each timed call takes
    the next of several independent cases whose pools together exceed the
    50 MB L2 cache, so every call reads its pool from device memory, as a
    serving step does."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as pa
    ctxs = [512] * 8
    pool_bytes = sum(ctxs) * 32 * 128 * 2 * \
        torch.empty((), dtype=pool_dtype).element_size()
    n_cases = -(-3 * L2_BYTES // pool_bytes)
    cases = [make_case(gen, B=8, T=1, qh=32, kvh=32, d=128, page=16,
                       ctxs=ctxs, qls=[1] * 8, dtype=torch.bfloat16,
                       pool_dtype=pool_dtype) for _ in range(n_cases)]
    args = [_attn_args(c) for c in cases]
    kws = [_attn_kw(c) for c in cases]
    plain_args = [(*_attn_args(c), c["q_lens"], c["k_new"], c["v_new"],
                   c.get("k_scale"), c.get("v_scale")) for c in cases]

    def rotate(call):
        it = iter(range(1 << 62))
        return lambda: call(next(it) % n_cases)

    fns = [("plain", rotate(lambda i: pa._reference_ragged_paged_attention(
                *plain_args[i]))),
           ("kernel", rotate(lambda i: pa.ragged_paged_attention(
               *args[i], **kws[i])))]
    timing = {}
    if library:
        # the library yardstick attends the same keys: gathered cache + new
        sdpa_in = []
        for c in cases:
            flat = c["block_tables"][:, :32].reshape(-1).long()
            kg = c["k_cache"][:, flat].reshape(32, 8, 512, 128).transpose(0, 1)
            vg = c["v_cache"][:, flat].reshape(32, 8, 512, 128).transpose(0, 1)
            sdpa_in.append((
                c["q"].transpose(1, 2).contiguous(),          # [B, qh, 1, d]
                torch.cat([kg, c["k_new"].transpose(1, 2)], 2).contiguous(),
                torch.cat([vg, c["v_new"].transpose(1, 2)], 2).contiguous()))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(*sdpa_in[0])
        mine = pa.ragged_paged_attention(*args[0], **kws[0])
        torch.cuda.synchronize()
        timing["library_max_abs_err"] = float(
            (lib.transpose(1, 2).float() - mine.float()).abs().max())
        fns.append(("library", rotate(lambda i: sdpa(*sdpa_in[i]))))
    t = {}
    calls = 8 * n_cases
    for key, fn in (fns[0], fns[1], *fns[2:], ("kernel2", fns[1][1]),
                    ("plain2", fns[0][1])):
        t[key] = graph_ms(fn, n_cases if key.startswith("plain") else calls)
    t["eager"] = cuda_ms(fns[1][1], 200)
    b_ms, b_by = bound_ms(8, 32, 32, 128, ctxs, 1, torch.bfloat16,
                          pool_dtype=pool_dtype)
    pool = str(pool_dtype).replace("torch.", "")
    W = cases[0]["block_tables"].shape[1]
    timing.update({"shape": f"llama2_7b decode B=8 ctx=512 bf16 q, {pool} pool",
                   "route": pa._route(1, 1),
                   "splits": pa.split_plan(8, 32, W, 16),
                   "rotated_cases": n_cases,
                   "timed_by": "CUDA graph replays",
                   "kernel_ms": min(t["kernel"], t["kernel2"]),
                   "kernel_ms_runs": [t["kernel"], t["kernel2"]],
                   "kernel_ms_eager": t["eager"],
                   "plain_ms": min(t["plain"], t["plain2"]),
                   "plain_ms_runs": [t["plain"], t["plain2"]],
                   "library_ms": t.get("library"),
                   "bound_ms": b_ms, "bound_by": b_by})
    return timing


def phase_kernel():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    decode = dict(B=8, T=1, ctxs=[1, 15, 16, 17, 255, 512, 1000, 1023],
                  qls=[1] * 8, page=16, d=128)
    short = dict(B=2, T=1, ctxs=[0, 1], qls=[1, 1], page=16, d=128)
    verify = dict(B=4, T=4, ctxs=[0, 1, 17, 700], qls=[4, 1, 3, 4], page=16,
                  d=128)
    mixed = dict(B=4, T=64, ctxs=[0, 16, 33, 960], qls=[64, 1, 17, 0],
                 page=16, d=128)
    shapes = [("decode", decode, 32, {}), ("decode", decode, 8, {}),
              ("decode", decode, 4, {}), ("decode_ctx01", short, 32, {}),
              ("decode_ctx01", short, 8, {}), ("verify_T4", verify, 32, {}),
              ("verify_T4", verify, 8, {}), ("verify_T4", verify, 4, {}),
              ("mixed", mixed, 32, {}),
              ("mixed", mixed, 8, {}), ("mixed", mixed, 4, {}),
              ("mixed_d64_page8", {**mixed, "d": 64, "page": 8}, 8, {}),
              ("mixed_page128", {**mixed, "page": 128}, 4, {})]
    cases, worst = _attention_matrix(gen, shapes,
                                     (torch.float32, torch.bfloat16))
    # the pool dtype is not the model dtype (cache_dtype= / the flag)
    for q_dt, pool_dt in ((torch.bfloat16, torch.float32),
                          (torch.float32, torch.bfloat16)):
        more, w = _attention_matrix(
            gen, [("mixed_dtypes", mixed, 8, {"pool_dtype": pool_dt}),
                  ("decode_mixed_dtypes", decode, 8, {"pool_dtype": pool_dt})],
            (q_dt,))
        cases += more
        worst = {k: max(worst[k], w[k]) for k in worst}
    timing = _attention_timing(gen, torch.bfloat16, library=True)
    emit("kernel", cases=cases, max_abs_err=worst, timing=timing)
    return worst, timing


def phase_kernel_int8():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    i8 = {"pool_dtype": torch.int8, "zero_pages": 3}
    decode = dict(B=8, T=1, ctxs=[1, 15, 16, 17, 255, 512, 1000, 1023],
                  qls=[1] * 8, page=16, d=128)
    short = dict(B=2, T=1, ctxs=[0, 1], qls=[1, 1], page=16, d=128)
    verify = dict(B=4, T=4, ctxs=[0, 1, 17, 700], qls=[4, 1, 3, 4], page=16,
                  d=128)
    mixed = dict(B=4, T=64, ctxs=[0, 16, 33, 960], qls=[64, 1, 17, 0],
                 page=16, d=128)
    shapes = [("decode", decode, 32, i8), ("decode", decode, 8, i8),
              ("decode_page8", {**decode, "page": 8}, 4, i8),
              ("decode_ctx01", short, 32, i8), ("decode_ctx01", short, 4, i8),
              ("verify_T4", verify, 8, i8), ("verify_T4", verify, 4, i8),
              ("mixed", mixed, 32, i8), ("mixed", mixed, 8, i8),
              ("mixed", mixed, 4, i8),
              ("mixed_page32", {**mixed, "page": 32}, 8, i8),
              ("mixed_d64_page8", {**mixed, "d": 64, "page": 8}, 8, i8),
              ("mixed_page128", {**mixed, "page": 128}, 4, i8)]
    cases, worst = _attention_matrix(gen, shapes,
                                     (torch.float32, torch.bfloat16))
    timing = _attention_timing(gen, torch.int8, library=False)
    timing["library_note"] = ("no single PyTorch call attends over an int8 "
                              "paged pool with per-page scales")
    emit("kernel_int8", cases=cases, max_abs_err=worst, timing=timing)
    return worst, timing


# --------------------------------------------------------------- gmm ---

def _routing_ids(gen, N, E, k):
    """Top-k expert ids of N tokens from random router logits."""
    import torch
    logits = torch.randn((N, E), generator=gen, device="cuda")
    return torch.topk(logits, k, dim=-1).indices.reshape(N * k)


def _gmm_case(gen, dtype, *, E, ids, bm, C, O, fused):
    """gmm operands for a dispatch of the flat expert ``ids``: with
    ``fused`` the rows gather from an un-permuted [F+1, C] buffer whose
    last row is the zero sentinel (as the MoE FFN's ``xz``)."""
    import torch
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    inv, _pos, tg = gm.sorted_dispatch_plan(ids, E, bm)
    F = ids.shape[0]
    rhs = (torch.randn((E, C, O), generator=gen, device="cuda")
           / C ** 0.5).to(dtype)
    if fused:
        lhs = torch.randn((F + 1, C), generator=gen, device="cuda").to(dtype)
        lhs[-1] = 0
        rows = torch.where(inv < F, inv, torch.full_like(inv, F))
        return lhs, rhs, tg, rows
    lhs = torch.randn((inv.shape[0], C), generator=gen,
                      device="cuda").to(dtype)
    return lhs, rhs, tg, None


def _gmm_bound_ms(lhs, rhs, tg, rows, M):
    """Least time of one gmm: the larger of bytes / HBM rate (the weights of
    every expert whose tiles this run needs, the lhs rows, the row and
    group indices and the output, each once) and 2 x rows x C x O flops /
    the dtype's peak.  With a gather, rows that read the zero sentinel
    (lhs's last row) add nothing and tiles made only of them need no
    weight, so the live rows and experts are counted."""
    C, O = rhs.shape[1], rhs.shape[2]
    it = lhs.element_size()
    if rows is not None:
        bm = M // tg.numel()
        live = rows != lhs.shape[0] - 1
        experts = int(tg[live.reshape(-1, bm).any(dim=1)].unique().numel())
        n_live = int(live.sum())
    else:
        experts, n_live = int(tg.unique().numel()), M
    nbytes = (experts * C * O + lhs.shape[0] * C + M * O) * it + \
        tg.numel() * 4 + (rows.numel() * 4 if rows is not None else 0)
    flops = 2 * n_live * C * O
    from paddle_tpu_torch import HBM_BYTES_PER_S, PEAK_FLOPS
    peak = PEAK_FLOPS[str(lhs.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _gmm_sm90_ptxas(log):
    """ptxas's record of each kernel of ``grouped_matmul_sm90``'s build log:
    ``{"wide bn256 trans1 gather0": {"registers", "spill_stores",
    "spill_loads", "stack_bytes"}, "narrow tm16 trans0": ..., ...}``
    (``registers`` is the launch count; the wide form's consumers raise
    theirs with setmaxnreg)."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*gmm_sm90_(wide|narrow)_"
                      r"kernelILi(\d+)ELb(\d)E(?:Lb(\d)E)?", ln)
        if m:
            name = (f"wide bn{m.group(2)} trans{m.group(3)} gather"
                    f"{m.group(4)}" if m.group(1) == "wide" else
                    f"narrow tm{m.group(2)} trans{m.group(3)}")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def _gmm_route_counts():
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    return (gm.LAUNCHES + gm.LAUNCHES_TRANS,
            gm.LAUNCHES_SM90 + gm.LAUNCHES_TRANS_SM90)


def _check_gmm_route(name, dtype, before, launches=1):
    """The gmm launches since ``before`` (``_gmm_route_counts``) took the
    route of their dtype: sm90 for bf16, simt for fp32."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    n, sm90 = (a - b for a, b in zip(_gmm_route_counts(), before))
    want = launches if gm._route(dtype) == "sm90" else 0
    if n != launches or sm90 != want:
        raise AssertionError(f"{name}: {n} gmm launches, {sm90} on the sm90 "
                             f"route; want {launches} and {want}")
    return gm._route(dtype)


def phase_kernel_gmm(built):
    """``built``: ``phase_build``'s record (the sm90 build's ptxas log)."""
    import torch
    from paddle_tpu_torch.kernels import grouped_matmul as gm

    ptxas = _gmm_sm90_ptxas(built.get("grouped_matmul_sm90", {})
                            .get("log", ""))
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if not ptxas or spills:
        raise AssertionError(f"grouped_matmul_sm90: ptxas record {ptxas} "
                             "(empty: built before phase_build; every "
                             "kernel must have 0 spill bytes)")

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"

    def ids_of(counts):
        e = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                    torch.tensor(counts, device=dev))
        return e[torch.randperm(e.numel(), generator=gen, device=dev)]

    matrix = [
        ("empty_experts_bm8", 8, ids_of([3, 0, 9, 1, 0, 0, 2, 1]), 8, 64, 64),
        ("one_expert_bm16", 8, ids_of([40, 0, 0, 0, 0, 0, 0, 0]), 16, 128,
         192),
        ("bm24_tile8", 4, ids_of([5, 30, 0, 2]), 24, 96, 128),
        ("bm128", 8, _routing_ids(gen, 300, 8, 2), 128, 512, 1024),
        ("bm512", 4, ids_of([600, 1, 3, 0]), 512, 256, 512),
        ("mixtral_decode_up", 8, _routing_ids(gen, 8, 8, 2), 16, 4096, 14336),
        ("mixtral_decode_down", 8, _routing_ids(gen, 8, 8, 2), 16, 14336,
         4096),
        ("mixtral_prefill_up", 8, _routing_ids(gen, 512, 8, 2), 512, 4096,
         14336),
    ]
    cases, worst = [], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, E, ids, bm, C, O in matrix:
            for fused in (True, False):
                if label.startswith("mixtral") and fused != ("up" in label):
                    continue        # the serve path's form of each shape
                lhs, rhs, tg, rows = _gmm_case(gen, dtype, E=E, ids=ids,
                                               bm=bm, C=C, O=O, fused=fused)
                name = f"{label}/{dname}/{'rows' if fused else 'plain'}"
                c0 = _gmm_route_counts()
                out = gm.gmm(lhs, rhs, tg, bm=bm, rows=rows)
                route = _check_gmm_route(name, dtype, c0)
                ref = gm._gmm_reference(lhs, rhs, tg, bm=bm, rows=rows)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs()
                scale = float(ref.float().abs().max())
                rtol, atol = GMM_TOL[dname]
                bad = int((err > atol * scale + rtol * ref.float().abs())
                          .sum())
                if bad:
                    raise AssertionError(f"gmm {name}: {bad} elements out of "
                                         f"tolerance (max err "
                                         f"{float(err.max())}, scale {scale})")
                if rows is not None:
                    pad = rows == lhs.shape[0] - 1
                    if pad.any() and out[pad].abs().max().item() != 0:
                        raise AssertionError(f"gmm {name}: sentinel rows "
                                             "are not exactly 0")
                M = int(out.shape[0])
                cases.append({"case": label, "dtype": dname, "rows": fused,
                              "E": E, "F": int(ids.numel()), "bm": bm,
                              "M": M, "C": C, "O": O, "route": route,
                              "plan": gm.sm90_plan(bm, M, O)
                              if route == "sm90" else
                              {"row_tile": gm.row_tile(bm)},
                              "max_abs_err": float(err.max()),
                              "ref_max_abs": scale,
                              "tol": [rtol, atol]})
                worst = max(worst, float(err.max()))
                del lhs, rhs, tg, rows, out, ref, err
        torch.cuda.empty_cache()

    # times at the Mixtral-width shapes of the serve path, bf16: decode
    # (B=8, T=1: N=8, F=16, bm=16, M=144) and a prefill chunk (B=8, T=64:
    # N=512, F=1024, bm=512, M=5120), gate/up (fused rows) and down
    have_grouped_mm = hasattr(torch, "_grouped_mm")
    timings = []
    for label, N, bm, C, O, fused in (
            ("decode_gate_up", 8, 16, 4096, 14336, True),
            ("decode_down", 8, 16, 14336, 4096, False),
            ("prefill_gate_up", 512, 512, 4096, 14336, True),
            ("prefill_down", 512, 512, 14336, 4096, False)):
        ids = _routing_ids(gen, N, 8, 2)
        lhs, rhs, tg, rows = _gmm_case(gen, torch.bfloat16, E=8, ids=ids,
                                       bm=bm, C=C, O=O, fused=fused)
        M = rows.shape[0] if fused else lhs.shape[0]
        # the library yardstick multiplies pre-gathered rows, expert spans
        # given by their padded ends
        a = lhs[rows.long()] if fused else lhs
        ends = torch.searchsorted(tg, torch.arange(8, device=dev,
                                                   dtype=torch.int32),
                                  right=True).to(torch.int32) * bm
        if have_grouped_mm:
            library_call = "torch._grouped_mm on pre-gathered rows"

            def lib():
                return torch._grouped_mm(a, rhs, offs=ends)
        else:
            library_call = "per-expert torch.matmul on pre-gathered rows"
            bounds = [0] + ends.tolist()

            def lib():
                return [a[bounds[e]:bounds[e + 1]] @ rhs[e] for e in range(8)]

        mine = gm.gmm(lhs, rhs, tg, bm=bm, rows=rows)
        lib_out = lib()
        torch.cuda.synchronize()
        lib_err = float((torch.cat(lib_out) if isinstance(lib_out, list)
                         else lib_out).float().sub(mine.float()).abs().max())
        big = label.startswith("prefill")
        t = {}
        for key, fn in (("plain", lambda: gm._gmm_reference(
                            lhs, rhs, tg, bm=bm, rows=rows)),
                        ("kernel", lambda: gm.gmm(lhs, rhs, tg, bm=bm,
                                                  rows=rows)),
                        ("library", lib),
                        ("kernel2", lambda: gm.gmm(lhs, rhs, tg, bm=bm,
                                                   rows=rows)),
                        ("plain2", lambda: gm._gmm_reference(
                            lhs, rhs, tg, bm=bm, rows=rows))):
            plain = key.startswith("plain")
            t[key] = cuda_ms(fn, (2 if big else 5) if plain else
                             (10 if big else 50))
        b_ms, b_by = _gmm_bound_ms(lhs, rhs, tg, rows, M)
        timings.append({
            "shape": f"mixtral {label} N={N} F={2 * N} bm={bm} M={M} "
                     f"C={C} O={O} bf16",
            "plan": gm.sm90_plan(bm, M, O),
            "kernel_ms": min(t["kernel"], t["kernel2"]),
            "kernel_ms_runs": [t["kernel"], t["kernel2"]],
            "plain_ms": min(t["plain"], t["plain2"]),
            "plain_ms_runs": [t["plain"], t["plain2"]],
            "library_ms": t["library"], "library_call": library_call,
            "library_max_abs_err": lib_err,
            "bound_ms": b_ms, "bound_by": b_by})
        del lhs, rhs, tg, rows, a, mine, lib_out
        torch.cuda.empty_cache()
    emit("kernel_gmm", cases=cases, max_abs_err=worst, timings=timings,
         gmm_sm90_ptxas=ptxas)
    return worst, timings


# ----------------------------------------------------- engine parity ---

def _expected_launches(cfg, quantized, steps):
    """Each engine step launches attention once per layer (over the float
    or the int8 pool) and, for an MoE model, gmm three times per layer."""
    L = cfg.num_hidden_layers
    return {"attention": 0 if quantized else L * steps,
            "attention_int8": L * steps if quantized else 0,
            "gmm": 3 * L * steps if cfg.moe_num_experts else 0}


def _engine_parity(phase, cfg, prompts, *, new_tokens, cache_dtype=None,
                   tie_rel=1e-3, max_tie_share=0.0):
    """Serve ``prompts`` on the card with the continuous-batching engine,
    then teacher-force its tokens through the full-sequence forward on the
    CPU (fp32, plain attention and plain gmm).  A token that is not the CPU
    argmax passes only as a near-tie: a logit gap <= ``tie_rel`` x the
    row's largest |logit|, and at most ``max_tie_share`` of the tokens."""
    import torch
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    eng = ContinuousBatchingEngine(
        model, max_batch=4, gen=GenerationConfig(max_new_tokens=new_tokens),
        max_seq_len=256, page_size=16, prefill_bucket=64, device="cuda",
        cache_dtype=cache_dtype)
    pa.LAUNCHES = pa.LAUNCHES_INT8 = gm.LAUNCHES = 0
    s0 = eng.steps
    rids = [eng.add_request(p) for p in prompts]
    out = eng.run()
    torch.cuda.synchronize()
    steps = eng.steps - s0
    launches = {"attention": pa.LAUNCHES, "attention_int8": pa.LAUNCHES_INT8,
                "gmm": gm.LAUNCHES}
    L = cfg.num_hidden_layers
    want = _expected_launches(cfg, cache_dtype == "int8", steps)
    if launches != want:
        raise AssertionError(f"{phase}: kernel launches {launches} != "
                             f"{want} ({L} layers x {steps} steps)")

    cpu = model.to("cpu")
    del eng
    torch.cuda.empty_cache()
    near_ties, checked, gaps = 0, 0, []
    for p, rid in zip(prompts, rids):
        toks = out[rid]
        if len(toks) != new_tokens:
            raise AssertionError(f"{phase} request {rid}: {len(toks)} "
                                 f"tokens, want {new_tokens}")
        seq = torch.tensor([p + toks[:-1]], dtype=torch.long)
        logits = cpu(seq)[0, len(p) - 1:].float()
        for j, tok in enumerate(toks):
            row = logits[j]
            checked += 1
            if int(row.argmax()) == tok:
                continue
            gap = float(row.max() - row[tok])
            gaps.append(gap / float(row.abs().max()))
            if gap <= tie_rel * float(row.abs().max()):
                near_ties += 1
                continue
            raise AssertionError(
                f"{phase} request {rid} token {j}: engine {tok}, CPU argmax "
                f"{int(row.argmax())}, logit gap {gap}")
    if near_ties > max_tie_share * checked:
        raise AssertionError(f"{phase}: {near_ties} near-ties of {checked} "
                             f"tokens (at most {max_tie_share:.0%})")
    emit(phase, layers=L, hidden=cfg.hidden_size,
         heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
         experts=cfg.moe_num_experts, cache_dtype=cache_dtype or cfg.dtype,
         prompt_lens=[len(p) for p in prompts], new_tokens=new_tokens,
         tokens_checked=checked, near_ties=near_ties,
         near_tie_rel_gaps=gaps, tie_rel=tie_rel, engine_steps=steps,
         kernel_launches=launches)
    del cpu, model
    gc.collect()


def phase_engine_parity():
    import numpy as np
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 64, 100, 200)]
    _engine_parity("engine_parity", cfg, prompts, new_tokens=16)


def phase_engine_parity_int8():
    """The int8 pool quantizes K/V per page (absmax / 127: at most 1/254 of
    the page's largest |value| per element), so a near-tie here is a logit
    gap <= 2% of the row's largest |logit| against the float forward, and
    at most a quarter of the tokens may be such ties."""
    import numpy as np
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 64, 100, 200)]
    _engine_parity("engine_parity_int8", cfg, prompts, new_tokens=16,
                   cache_dtype="int8", tie_rel=2e-2, max_tie_share=0.25)


def phase_engine_parity_moe():
    """Mixtral widths, 2 layers, fp32; block_m 64 keeps the CPU forward's
    padded rows (and its time) small and runs the kernel at bm 64 in
    prefill beside the decode steps' bm 16."""
    import numpy as np
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.mixtral_8x7b(num_hidden_layers=2, dtype="float32",
                                   moe_block_m=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 48, 64, 96)]
    _engine_parity("engine_parity_moe", cfg, prompts, new_tokens=16)


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


def phase_serve(phase, argv):
    """One serving replica built by the launcher from ``argv`` behind
    ``ServingServer.start_http``; 8 concurrent streamed completions of 64
    tokens.  Launch counts are set to 0 just before the requests and read
    just after; each kernel of the path must have run once per layer (gmm:
    three times per layer) and engine step.  Frees the model before it
    returns.  Returns the launch counts."""
    import numpy as np
    import torch
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.__main__ import build_engine, build_parser

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    engine = build_engine(args)
    cfg = engine.g.config
    srv = ServingServer(engine, model_name=args.preset, warmup=True)
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
            pa.LAUNCHES = pa.LAUNCHES_INT8 = gm.LAUNCHES = 0
            pa.LAUNCHES_SPLIT = pa.LAUNCHES_INT8_SPLIT = 0
            gm.LAUNCHES_SM90 = 0
            steps0 = engine.steps
            t1 = time.perf_counter()
            res = await asyncio.gather(*[
                _client(host, port, p, max_tokens) for p in prompts])
            wall = time.perf_counter() - t1
            launches = {"attention": pa.LAUNCHES,
                        "attention_int8": pa.LAUNCHES_INT8,
                        "gmm": gm.LAUNCHES}
            routes = {"attention_split": pa.LAUNCHES_SPLIT,
                      "attention_int8_split": pa.LAUNCHES_INT8_SPLIT,
                      "gmm_sm90": gm.LAUNCHES_SM90}
            return (res, wall, launches, routes, engine.steps - steps0,
                    t_ready)
        finally:
            await srv.stop_http()

    res, wall, launches, routes, steps, t_ready = asyncio.run(go())
    for n, r in zip(lens, res):
        if r["finish"] != "length" or len(r["ids"]) != max_tokens or \
                not all(0 <= t < cfg.vocab_size for t in r["ids"]):
            raise AssertionError(f"{phase}: prompt of {n} tokens: "
                                 f"{r['status']}, finish {r['finish']}, "
                                 f"{len(r['ids'])} ids")
    L = cfg.num_hidden_layers
    want = _expected_launches(cfg, engine.g.cache.quantized, steps)
    if steps == 0 or launches != want:
        raise AssertionError(f"{phase}: kernel launches {launches} != "
                             f"{want} ({L} layers x {steps} steps)")
    # decode steps (T 1) take the split route, prefill chunks the tile
    # route; a bf16 model's gmm launches all take the sm90 route
    split = routes["attention_split"] + routes["attention_int8_split"]
    if not 0 < split < launches["attention"] + launches["attention_int8"] \
            or routes["gmm_sm90"] != launches["gmm"]:
        raise AssertionError(f"{phase}: route launches {routes} against "
                             f"{launches}")
    ttfts = sorted(r["ttft_s"] for r in res)
    emit(phase, preset=args.preset, layers=L, hidden=cfg.hidden_size,
         intermediate=cfg.intermediate_size, experts=cfg.moe_num_experts,
         dtype=cfg.dtype, kv_cache_dtype=engine.stats()["kv_cache_dtype"],
         max_batch=args.max_batch, max_seq_len=args.max_seq_len,
         page_size=args.page_size, prefill_bucket=args.prefill_bucket,
         num_pages=engine.g.num_pages, pool_bytes=engine.g.pool_bytes,
         prompt_lens=lens, max_tokens=max_tokens, requests=len(res),
         setup_and_warmup_s=t_ready, wall_s=wall,
         tokens_per_s=len(res) * max_tokens / wall,
         ttft_p50_s=float(np.median(ttfts)), ttft_max_s=ttfts[-1],
         engine_steps=steps, kernel_launches=launches, route_launches=routes,
         launches_per_step={k: v / steps for k, v in launches.items()},
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del engine, srv
    gc.collect()
    torch.cuda.empty_cache()
    return {**launches, **routes}


# ------------------------------------------------------- flash attention ---

def _causal_pairs(sq, sk, causal):
    """(query, key) pairs the attention visits: every pair, or the causal
    ones (key <= query + sk - sq)."""
    if not causal:
        return sq * sk
    return sum(min(sk, i + 1 + sk - sq) for i in range(sq))


def _flash_bound_ms(which, b, sq, sk, hq, hkv, d, causal, itemsize,
                    pairs=None, extra_bytes=0):
    """Least time of one flash kernel: the larger of bytes / HBM rate (each
    input read once, each output written once, plus ``extra_bytes``: a
    mask, segment ids) and its matmul operations over the live (query, key)
    pairs / the bf16 or fp32 peak.  ``pairs``: the live pairs of one batch
    row and head where they are not the causal or full count (segments).
    forward: 2 matmuls (q k^T, p v); dQ: 3 (q k^T, dO v^T, ds k); dK/dV: 4
    (q k^T, dO v^T, p^T dO, ds^T q)."""
    q_bytes = b * sq * hq * d * itemsize
    kv_bytes = b * sk * hkv * d * itemsize
    rows = b * hq * sq * 4                       # one fp32 per query row
    nbytes, mm = {"fwd": (q_bytes + 2 * kv_bytes + q_bytes + rows, 2),
                  "dq": (3 * q_bytes + 2 * kv_bytes + 2 * rows, 3),
                  "dkv": (2 * q_bytes + 4 * kv_bytes + 2 * rows, 4)}[which]
    nbytes += extra_bytes
    if pairs is None:
        pairs = _causal_pairs(sq, sk, causal)
    flops = mm * 2 * b * hq * d * pairs
    from paddle_tpu_torch import HBM_BYTES_PER_S, PEAK_FLOPS
    peak = PEAK_FLOPS["bfloat16" if itemsize == 2 else "float32"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _flash_case(gen, dtype, b, sq, sk, hq, hkv, d):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return (rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d),
            rnd(b, sq, hq, d))


def _flash_check(got, want, tol):
    """``got`` against ``want``: max abs error, RMS(want), the relative
    Frobenius error and ``need``, the least ``atol`` that passes with
    ``tol["rtol"]``, in units of each element's scale: the RMS of its row
    (over d) or of the tensor, whichever is larger (an early causal row
    attends to few keys and holds values, and rounding errors, far above
    the tensor's RMS).  ``ok`` when finite and within ``tol``."""
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = float(w.square().mean().sqrt()) or 1.0
    rel = float(err.norm() / (w.norm() or 1.0))
    scale = w.square().mean(-1, keepdim=True).sqrt().clamp_min(rms)
    need = float(((err - tol["rtol"] * w.abs()) / scale).max())
    ok = bool(torch.isfinite(g).all()) and rel <= tol["rel"] and \
        need <= tol["atol"]
    return {"max_abs_err": float(err.max()), "rms": rms, "rel": rel,
            "need": need, "ok": ok}


def _flash_lse_check(got, want):
    """lse is fp32 in both dtypes and log-scaled: an absolute limit."""
    import torch
    err = float((got - want).abs().max())
    return {"max_abs_err": err, "ok": bool(torch.isfinite(got).all())
            and err <= FLASH_LSE_ATOL}


def _flash_checks(tol, got, want):
    """Checks of one case: got and want are (out, lse, dq, dk, dv)."""
    keys = ("out", "lse", "dq", "dk", "dv")
    return {k: (_flash_lse_check(g, w) if k == "lse" else
                _flash_check(g, w, tol))
            for k, g, w in zip(keys, got, want)}


def _flash_compare(q, k, v, g, causal, tol, **modes):
    """Each kernel against its plain version on the same inputs (and the
    same ``modes``: mask, seg_q/seg_k, drop_p/seed): the forward on q, k,
    v; dQ and dK/dV (through ``flash_backward``) on the plain forward's out
    and lse, so the forward's bf16 rounding of out does not reach the
    backward's inputs through delta = rowsum(dO * out).  Checks of (out,
    lse, dq, dk, dv)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    out, lse = fa._reference_attention_lse(q, k, v, causal, **modes)
    delta = fa._delta(out, g)
    want = (out, lse,
            fa._flash_bwd_dq(q, k, v, g, lse, delta, causal, **modes)) + \
        tuple(fa._flash_bwd_dkv(q, k, v, g, lse, delta, causal, **modes))
    del delta
    got = tuple(fa.flash_forward(q, k, v, causal, **modes)) + \
        tuple(fa.flash_backward(q, k, v, out, lse, g, causal, **modes))
    return _flash_checks(tol, got, want)


def _flash_worst(cases):
    """Per dtype and output, the worst value of each check statistic over
    ``cases`` ((dtype, label, checks) each), with the case's label."""
    summary = {}              # dtype -> output -> stat -> (worst, case)
    for dname, label, checks in cases:
        for key, c in checks.items():
            by_stat = summary.setdefault(dname, {}).setdefault(key, {})
            for stat, val in c.items():
                if stat != "ok" and val > by_stat.get(stat, (-1.0,))[0]:
                    by_stat[stat] = (val, label)
    return summary


def phase_kernel_flash(built):
    """The three kernels against their plain versions over the case matrix
    and at the training shape.  Every case is checked before any failure
    raises, and the line reports, per dtype and output, the worst max abs
    error, relative Frobenius error and ``need`` (least atol x RMS).  Each
    case's three kernels must take the route ``_route`` names (the "sm90"
    counters move for bf16 at d 64 and 128 and for nothing else); at the
    training shape the sm90 kernels must repeat bit for bit and their ptxas
    record (``built``, from the build phase) must show no spill."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(3)
    routes = {"sm90": 0, "mma": 0}
    cases, failed = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        tol = FLASH_TOL[dname]
        for (b, sq, sk), causal, hkv, d in (
                (shp, c, h, dd) for shp in FLASH_SHAPES for c in (False, True)
                for h in (8, 2, 1) for dd in (64, 128)):
            q, k, v, g = _flash_case(gen, dtype, b, sq, sk, 8, hkv, d)
            n0 = _flash_sm90_counts()
            checks = _flash_compare(q, k, v, g, causal, tol)
            label = (f"b{b} sq{sq} sk{sk} group{8 // hkv} d{d} "
                     f"{'causal' if causal else 'full'} {dname}")
            cases.append((dname, label, checks))
            failed += [f"{label} {k}: {c}" for k, c in checks.items()
                       if not c["ok"]]
            route = fa._route(dtype, d)
            moved = {key: n - n0[key] for key, n in
                     _flash_sm90_counts().items()}
            routes[route] += 1
            if moved != {key: int(route == "sm90") for key in moved}:
                failed.append(f"{label}: route {route}, sm90 launches "
                              f"{moved}")
            del q, k, v, g
        torch.cuda.empty_cache()
    timing, train_checks = _flash_timing(gen)
    failed += [f"training shape {k}: {c}" for k, c in train_checks.items()
               if not c["ok"]]
    if timing["routes"] != {"fwd": 1, "dq": 1, "dkv": 1, "fwd_sm90": 1,
                             "dq_sm90": 1, "dkv_sm90": 1}:
        failed.append(f"training shape routes: {timing['routes']}")
    failed += [f"training shape: {k} not bit for bit on a repeat"
               for k, same in timing["bitwise_repeat"].items() if not same]
    ptxas = _sm90_ptxas("\n".join(built[lib]["log"]
                                  for lib in FLASH_SM90_LIBRARIES))
    if set(ptxas) != {f"{w} d{dd}{m}" for w in ("fwd", "dq", "dkv")
                      for dd in (64, 128) for m in ("", " modes")}:
        failed.append(f"ptxas record of the sm90 kernels: {sorted(ptxas)}")
    failed += [f"{name}: ptxas spills {r}" for name, r in ptxas.items()
               if name in ("fwd d128", "fwd d128 modes", "dq d128", "dkv d128")
               and (r.get("spill_stores") or r.get("spill_loads"))]
    emit("kernel_flash", cases=len(cases), tol=FLASH_TOL,
         lse_atol=FLASH_LSE_ATOL, worst=_flash_worst(cases),
         cases_by_route=routes, sm90_ptxas=ptxas,
         training_shape_checks=train_checks, failed=failed, timing=timing)
    if failed:
        raise AssertionError(f"kernel_flash: {len(failed)} checks out of "
                             f"tolerance: {failed[:8]}")
    every = [c for _, _, c in cases] + [train_checks]
    err = {which: max(c[k]["max_abs_err"] for c in every for k in keys)
           for which, keys in (("fwd", ("out",)), ("dq", ("dq",)),
                               ("dkv", ("dk", "dv")))}
    return err, timing


def _flash_timing(gen):
    """At the training shape (b 4, s 2048, 32 heads, d 128, bf16, causal):
    each kernel's output against its plain version's, then CUDA-event times
    of each kernel and its plain version in turns (plain, kernel, kernel,
    plain), its bound, and scaled_dot_product_attention on the same inputs
    in [b, h, s, d]: forward, backward (autograd, computing dQ, dK and dV
    in one call) and forward + backward.  ``timing`` also holds the
    launches of the checked forward and backward, counted from 0 (``routes``:
    all three kernels on the "sm90" route), whether a second launch of the
    forward, of dQ and of dK/dV gives the same bits (``bitwise_repeat``),
    the forward's rate beside SDPA's forward (``fwd_rate``) and the
    backward pair's time and rates beside SDPA's backward (``bwd_pair``).
    Returns (timing, checks)."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, s, h, d = (FLASH_TIMED[x] for x in "bshd")
    q, k, v, g = _flash_case(gen, torch.bfloat16, b, s, s, h, h, d)
    _reset_flash_counts()
    checks = _flash_compare(q, k, v, g, True, FLASH_TOL["bfloat16"])
    counts = {**_flash_counts(), **_flash_sm90_counts()}
    routes = {key: counts[key] for key in ("fwd", "dq", "dkv", "fwd_sm90",
                                           "dq_sm90", "dkv_sm90")}
    torch.cuda.empty_cache()
    out, lse = fa.flash_forward(q, k, v, True)
    out2, lse2 = fa.flash_forward(q, k, v, True)
    fwd_same = {"out": torch.equal(out, out2), "lse": torch.equal(lse, lse2)}
    del out2, lse2
    delta = fa._delta(out, g)
    dq1 = fa._cuda_bwd_dq(q, k, v, g, lse, delta, True)
    dq2 = fa._cuda_bwd_dq(q, k, v, g, lse, delta, True)
    dk1, dv1 = fa._cuda_bwd_dkv(q, k, v, g, lse, delta, True)
    dk2, dv2 = fa._cuda_bwd_dkv(q, k, v, g, lse, delta, True)
    bitwise = {**fwd_same, "dq": torch.equal(dq1, dq2),
               "dk": torch.equal(dk1, dk2), "dv": torch.equal(dv1, dv2)}
    del dq1, dq2, dk1, dv1, dk2, dv2
    calls = {
        "fwd": (lambda: fa.flash_forward(q, k, v, True),
                lambda: fa._reference_attention_lse(q, k, v, True)),
        "dq": (lambda: fa._cuda_bwd_dq(q, k, v, g, lse, delta, True),
               lambda: fa._flash_bwd_dq(q, k, v, g, lse, delta, True)),
        "dkv": (lambda: fa._cuda_bwd_dkv(q, k, v, g, lse, delta, True),
                lambda: fa._flash_bwd_dkv(q, k, v, g, lse, delta, True)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, gh = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    leaves = [x.clone().requires_grad_() for x in (qh, kh, vh)]
    lib_out = sdpa(*leaves, is_causal=True)
    lib_err = float((lib_out.detach().transpose(1, 2).float()
                     - out.float()).abs().max())

    def lib_bwd():
        return torch.autograd.grad(lib_out, leaves, gh, retain_graph=True)

    def lib_fwd_bwd():
        o = sdpa(*leaves, is_causal=True)
        return torch.autograd.grad(o, leaves, gh)

    timing = {"shape": f"b={b} s={s} hq=hkv={h} d={d} bf16 causal",
              "routes": routes, "bitwise_repeat": bitwise,
              "library_max_abs_err_out": lib_err,
              "sdpa_fwd_ms": cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True),
                                     20),
              "sdpa_bwd_ms": cuda_ms(lib_bwd, 20),
              "sdpa_fwd_bwd_ms": cuda_ms(lib_fwd_bwd, 20)}
    for which, (kernel, plain) in calls.items():
        t = {}
        for key, fn in (("plain", plain), ("kernel", kernel),
                        ("kernel2", kernel), ("plain2", plain)):
            t[key] = cuda_ms(fn, 3 if key.startswith("plain") else 10)
        b_ms, b_by = _flash_bound_ms(which, b, s, s, h, h, d, True, 2)
        timing[which] = {"kernel_ms": min(t["kernel"], t["kernel2"]),
                         "kernel_ms_runs": [t["kernel"], t["kernel2"]],
                         "plain_ms": min(t["plain"], t["plain2"]),
                         "plain_ms_runs": [t["plain"], t["plain2"]],
                         "bound_ms": b_ms, "bound_by": b_by}
    timing["fwd"]["library_ms"] = timing["sdpa_fwd_ms"]
    # one PyTorch call computes dQ, dK and dV together: the SDPA backward
    timing["dq"]["library_ms"] = timing["dkv"]["library_ms"] = \
        timing["sdpa_bwd_ms"]
    # the backward pair (7 matmul units here, 5 in SDPA's backward, which
    # computes dS once) against SDPA's backward, and the rates of each
    unit = 2 * b * h * d * _causal_pairs(s, s, True)
    timing["fwd_rate"] = {
        "kernel_tflops": 2 * unit / timing["fwd"]["kernel_ms"] / 1e9,
        "sdpa_fwd_tflops": 2 * unit / timing["sdpa_fwd_ms"] / 1e9,
        "share_of_bound": timing["fwd"]["bound_ms"] / timing["fwd"]["kernel_ms"]}
    pair = timing["dq"]["kernel_ms"] + timing["dkv"]["kernel_ms"]
    timing["bwd_pair"] = {
        "kernel_ms": pair, "sdpa_bwd_ms": timing["sdpa_bwd_ms"],
        "kernel_tflops": 7 * unit / pair / 1e9,
        "dq_tflops": 3 * unit / timing["dq"]["kernel_ms"] / 1e9,
        "dkv_tflops": 4 * unit / timing["dkv"]["kernel_ms"] / 1e9,
        "sdpa_bwd_tflops": 5 * unit / timing["sdpa_bwd_ms"] / 1e9,
        "bound_ms": timing["dq"]["bound_ms"] + timing["dkv"]["bound_ms"]}
    del q, k, v, g, out, lse, delta, qh, kh, vh, gh, leaves, lib_out
    torch.cuda.empty_cache()
    return timing, checks


# ------------------------------------------------- flash attention modes ---

def _mode_mask(gen, shape, dev="cuda"):
    """An additive fp32 mask: N(0, 0.5) scores with a tenth of the
    positions at -1e30 (masked out)."""
    import torch
    x = torch.randn(shape, generator=gen, device=dev) * 0.5
    drop = torch.rand(shape, generator=gen, device=dev) < 0.1
    return x.masked_fill(drop, -1e30)


def _segment_ids(lens_per_row, dev="cuda"):
    """[b, sum(lens)] int32 segment ids, one packing per batch row."""
    import torch
    return torch.stack([
        torch.repeat_interleave(torch.arange(len(lens), device=dev),
                                torch.tensor(lens, device=dev))
        for lens in lens_per_row]).to(torch.int32)


def _flash_mode_case(gen, mode, dtype, hkv, d, dev="cuda"):
    """(q, k, v, g, causal, modes) of one kernel_flash_modes case: the
    matrix shape (b 2, sq 136 / sk 200, 4 q-heads; segments sq = sk =
    200) with the mode's mask, segment ids or dropout."""
    import torch
    name, causal, mask_heads, segs, drop_p = mode
    b, hq = FLASH_MODES_SHAPE["b"], FLASH_MODES_SHAPE["hq"]
    sq, sk = FLASH_MODES_SHAPE["sq"], FLASH_MODES_SHAPE["sk"]
    modes = {}
    if segs:
        qlens, klens = FLASH_MODE_SEGMENTS[segs]
        sq, sk = sum(qlens[0]), sum(klens[0])
        modes["seg_q"] = _segment_ids(qlens, dev)
        modes["seg_k"] = _segment_ids(klens, dev)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v, g = (rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d),
                  rnd(b, sq, hq, d))
    if mask_heads:
        modes["mask"] = _mode_mask(gen, (b, hq if mask_heads == "hq" else 1,
                                         sq, sk), dev)
    if drop_p:
        modes["drop_p"] = drop_p
        modes["seed"] = torch.tensor([FLASH_MODE_SEED], dtype=torch.int32,
                                     device=dev)
    return q, k, v, g, causal, modes


def _flash_keep_check(gen):
    """The forward kernel's keep-mask read off its output, on each route
    (``FLASH_KEEP_CHECK``: fp32 on the mma route, bf16 at d 128 on the sm90
    one): q = 0 and v the identity (sk = d) give out[b, row, h, col] = keep
    * inv / sk exactly (bf16: inv rounded to bf16, as P is, then / sk, a
    power of two), held bit for bit against ``_drop_keep_dense`` for each
    rate; each record names the route its launch took."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    b, s, h = (FLASH_KEEP_CHECK[x] for x in "bsh")
    res = {}
    for dname, d in FLASH_KEEP_CHECK["routes"]:
        dtype = getattr(torch, dname)
        q = torch.zeros((b, s, h, d), device="cuda", dtype=dtype)
        k = torch.randn((b, d, h, d), generator=gen, device="cuda").to(dtype)
        v = torch.eye(d, device="cuda", dtype=dtype)[None, :, None, :].expand(
            b, d, h, d).contiguous()
        for p in FLASH_KEEP_RATES:
            seed = torch.tensor([FLASH_MODE_SEED], dtype=torch.int32,
                                device="cuda")
            n0 = fa.LAUNCHES_FWD_SM90
            out, _ = fa._cuda_fwd(q, k, v, False, drop_p=p, seed=seed)
            kernel_keep = (out != 0).transpose(1, 2)          # [b, h, s, d]
            want = fa._drop_keep_dense((b, h, s, d), seed, p)
            inv = fa._drop_scale(p).to(dtype).float() / d
            kept = out.transpose(1, 2)[want].float()
            res[f"{dname} d{d} p={p}"] = {
                "route": "sm90" if fa.LAUNCHES_FWD_SM90 > n0 else "mma",
                "expected_route": fa._route(dtype, d),
                "positions": want.numel(),
                "mismatches": int((kernel_keep != want).sum()),
                "kept_share": float(want.float().mean()),
                "values_off": int((kept != inv.to(kept.device)).sum())}
    return res


def _varlen_pairs(lens):
    """Live (query, key) pairs of one head of a causal packing."""
    return sum(n * (n + 1) // 2 for n in lens)


def _flash_mode_timing(gen, cfg):
    """One configuration at llama2_7b attention widths (b 4, s 2048, 32
    q-heads, d 128, bf16; varlen: one causal packing of 8192 tokens):
    forward and backward through the public entry point with the launch
    counts read just after; each kernel held against its plain version on
    the same inputs; CUDA-event times of each kernel and its plain version
    in turns (plain, kernel, kernel, plain), its bound, and the library
    yardstick.  Returns (timing, checks, launches)."""
    import torch
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.kernels import flash_attention as fa
    F = tnn.functional
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    b, s, h, d = (FLASH_TIMED[x] for x in "bshd")
    pairs, extra = None, 0
    if cfg == "varlen":
        lens = FLASH_VARLEN_LENS
        total = sum(lens)
        cu = torch.tensor((0,) + tuple(
            sum(lens[:i + 1]) for i in range(len(lens))), dtype=torch.int32,
            device="cuda")
        qkv = torch.randn((total, 3, h, d), generator=gen, device="cuda").to(
            bf16)
        q, k, v = (qkv[:, i][None].contiguous() for i in range(3))
        g = torch.randn((1, total, h, d), generator=gen, device="cuda").to(
            bf16)
        seg = fa._segments_from_cu(cu, total)[0][None].to(torch.int32)
        causal, modes = True, dict(seg_q=seg, seg_k=seg)
        b, s = 1, total
        pairs, extra = _varlen_pairs(lens), 2 * total * 4
        leaf = qkv.clone().requires_grad_()

        def entry():
            return F.flash_attn_varlen_qkvpacked(leaf, cu, cu,
                                                 causal=True)[0][None]
        same = seg[0][:, None] == seg[0][None, :]
        lib_mask = same & torch.ones_like(same).tril()
    else:
        q, k, v, g = _flash_case(gen, bf16, b, s, s, h, h, d)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        if cfg == "mask":
            mask = _mode_mask(gen, (b, 1, s, s))
            causal, modes, extra = False, dict(mask=mask), mask.numel() * 4
            lib_mask = mask.to(bf16)

            def entry():
                return fa.flash_attention(*leaves, causal=False,
                                          attn_mask=mask)
        else:
            seed = torch.randint(0, 1 << 23, (1,), generator=gen,
                                 device="cuda", dtype=torch.int32)
            causal, modes = True, dict(drop_p=0.1, seed=seed)
            lib_mask = None

            def entry():
                return F.flash_attention(*leaves, dropout=0.1,
                                         causal=True)[0]
    checks = _flash_compare(q, k, v, g, causal, FLASH_TOL["bfloat16"],
                            **modes)
    torch.cuda.empty_cache()
    _reset_flash_counts()
    entry().backward(g)
    torch.cuda.synchronize()
    launches = _flash_counts()
    sm90 = _flash_sm90_counts()
    out, lse = fa.flash_forward(q, k, v, causal, **modes)
    delta = fa._delta(out, g)
    calls = {
        "fwd": (lambda: fa._cuda_fwd(q, k, v, causal, **modes),
                lambda: fa._reference_attention_lse(q, k, v, causal,
                                                    **modes)),
        "dq": (lambda: fa._cuda_bwd_dq(q, k, v, g, lse, delta, causal,
                                       **modes),
               lambda: fa._flash_bwd_dq(q, k, v, g, lse, delta, causal,
                                        **modes)),
        "dkv": (lambda: fa._cuda_bwd_dkv(q, k, v, g, lse, delta, causal,
                                         **modes),
                lambda: fa._flash_bwd_dkv(q, k, v, g, lse, delta, causal,
                                          **modes)),
    }
    timing = {"shape": f"b={b} s={s} hq=hkv={h} d={d} bf16 "
                       f"{'causal' if causal else 'full'} {cfg}",
              "sm90_launches": sm90}
    for which, (kernel, plain) in calls.items():
        t = {}
        for key, fn in (("plain", plain), ("kernel", kernel),
                        ("kernel2", kernel), ("plain2", plain)):
            t[key] = cuda_ms(fn, 2 if key.startswith("plain") else 5)
            torch.cuda.empty_cache()
        b_ms, b_by = _flash_bound_ms(which, b, s, s, h, h, d, causal, 2,
                                     pairs=pairs, extra_bytes=extra)
        timing[which] = {"kernel_ms": min(t["kernel"], t["kernel2"]),
                         "kernel_ms_runs": [t["kernel"], t["kernel2"]],
                         "plain_ms": min(t["plain"], t["plain2"]),
                         "plain_ms_runs": [t["plain"], t["plain2"]],
                         "bound_ms": b_ms, "bound_by": b_by}
    # the library yardstick (and, for dropout, a cost reference only: no
    # PyTorch call draws this keep-mask)
    qh, kh, vh, gh = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    lib_leaves = [x.clone().requires_grad_() for x in (qh, kh, vh)]
    lib_kw = dict(attn_mask=lib_mask) if lib_mask is not None else \
        dict(is_causal=True, dropout_p=0.1)
    lib_out = sdpa(*lib_leaves, **lib_kw)
    if lib_mask is not None:
        checks["library_out"] = _flash_check(
            lib_out.detach().transpose(1, 2), out, FLASH_TOL["bfloat16"])

    def lib_bwd():
        return torch.autograd.grad(lib_out, lib_leaves, gh, retain_graph=True)

    lib = {"call": "scaled_dot_product_attention " + (
        "attn_mask (bf16)" if cfg == "mask" else
        "block-diagonal causal bool mask" if cfg == "varlen" else
        "dropout_p=0.1, is_causal (cost reference only)"),
        "fwd_ms": cuda_ms(lambda: sdpa(qh, kh, vh, **lib_kw), 5),
        "bwd_ms": cuda_ms(lib_bwd, 5)}
    timing["sdpa"] = lib
    timing["sum"] = {
        key: sum(timing[w][key] for w in ("fwd", "dq", "dkv"))
        for key in ("kernel_ms", "plain_ms", "bound_ms")}
    timing["sum"]["library_ms"] = None if cfg == "dropout" else \
        lib["fwd_ms"] + lib["bwd_ms"]
    del q, k, v, g, out, lse, delta, qh, kh, vh, gh, lib_leaves, lib_out
    del lib_mask, modes, calls
    gc.collect()
    torch.cuda.empty_cache()
    return timing, checks, launches


def _sdpa_card_vs_cpu(gen):
    """The port's nn.functional.scaled_dot_product_attention (plain PyTorch,
    no kernel) on the card against the CPU, fp32, b 1, s 1024, 32 heads,
    d 128: bool mask, additive mask, causal, and dropout with one seed fed
    to both devices."""
    import torch
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.kernels import flash_attention as fa
    F = tnn.functional
    shape = (1, 1024, 32, 128)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    masks = {"bool_mask": dict(attn_mask=torch.rand(
                 (1, 1, 1024, 1024), generator=gen, device="cuda") > 0.2),
             "additive_mask": dict(attn_mask=_mode_mask(
                 gen, (1, 32, 1024, 1024))),
             "causal": dict(is_causal=True),
             "dropout": dict(is_causal=True, dropout_p=0.1)}
    draw = fa._draw_seed
    fa._draw_seed = lambda device, generator=None: torch.tensor(
        [FLASH_MODE_SEED], dtype=torch.int32, device=device)
    try:
        res = {}
        for name, kw in masks.items():
            got = F.scaled_dot_product_attention(q, k, v, **kw)
            cpu_kw = {a: (x.cpu() if torch.is_tensor(x) else x)
                      for a, x in kw.items()}
            want = F.scaled_dot_product_attention(q.cpu(), k.cpu(), v.cpu(),
                                                  **cpu_kw)
            res[name] = _flash_check(got.cpu(), want, FLASH_TOL["float32"])
    finally:
        fa._draw_seed = draw
    return res


def phase_kernel_flash_modes(smi=None):
    """The three flash kernels in every mode against their plain versions
    over the mode matrix (mask with 1 or every head, causal or not;
    segments, causal with equal packings and not with different ones and
    an empty key segment; dropout 0.1 and 0.5, causal and not; mask and
    dropout together) x fp32/bf16 x GQA groups 1/4 x d 64/96/128/256, at
    lengths off the 64-row tile; the forward's keep-mask bit for bit; then
    the mask, dropout and varlen configurations at llama2_7b attention
    widths through the public entry points (exact launch counts, checks,
    times beside the plain versions, bounds and SDPA); then the port's
    scaled_dot_product_attention on the card against the CPU."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(6)
    hq = FLASH_MODES_SHAPE["hq"]
    cases, failed = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for mode in FLASH_MODE_CASES:
            for hkv, d in ((hh, dd) for hh in (hq, hq // 4)
                           for dd in FLASH_MODES_DIMS):
                q, k, v, g, causal, modes = _flash_mode_case(
                    gen, mode, dtype, hkv, d)
                checks = _flash_compare(q, k, v, g, causal, FLASH_TOL[dname],
                                        **modes)
                label = f"{mode[0]} group{hq // hkv} d{d} {dname}"
                cases.append((dname, label, checks))
                failed += [f"{label} {key}: {c}" for key, c in checks.items()
                           if not c["ok"]]
        torch.cuda.empty_cache()
    matrix_s = time.perf_counter() - t0
    keep = _flash_keep_check(gen)
    failed += [f"keep-mask {key}: {r}" for key, r in keep.items()
               if r["mismatches"] or r["values_off"] or
               r["route"] != r["expected_route"]]
    timed, launches = {}, {}
    for cfg in ("mask", "dropout", "varlen"):
        timing, checks, counts = _flash_mode_timing(gen, cfg)
        timed[cfg] = dict(timing, checks=checks)
        launches[cfg] = counts
        failed += [f"{cfg} at llama2_7b widths {key}: {c}"
                   for key, c in checks.items() if not c["ok"]]
        if counts != {"fwd": 1, "dq": 1, "dkv": 1}:
            failed.append(f"{cfg}: launches {counts}, expected one of each "
                          f"kernel")
        if timing["sm90_launches"] != {"fwd_sm90": 1, "dq_sm90": 1,
                                       "dkv_sm90": 1}:
            failed.append(f"{cfg}: the kernels did not take the sm90 "
                          f"route: {timing['sm90_launches']}")
    sdpa = _sdpa_card_vs_cpu(gen)
    failed += [f"nn.functional sdpa {k}: {c}" for k, c in sdpa.items()
               if not c["ok"]]
    emit("kernel_flash_modes", nvidia_smi=smi or _nvidia_smi(),
         cases=len(cases), matrix_seconds=matrix_s, tol=FLASH_TOL,
         lse_atol=FLASH_LSE_ATOL, worst=_flash_worst(cases), keep_mask=keep,
         launches=launches, timed=timed, sdpa_card_vs_cpu=sdpa,
         failed=failed, seconds=time.perf_counter() - t0)
    if failed:
        raise AssertionError(f"kernel_flash_modes: {len(failed)} checks "
                             f"failed: {failed[:8]}")
    err = max(c[key]["max_abs_err"] for _, _, c in cases
              for key in ("out", "dq", "dk", "dv"))
    return {cfg: dict(timed[cfg]["sum"], launches=sum(launches[cfg].values()),
                      max_abs_err=max(err, *(
                          timed[cfg]["checks"][key]["max_abs_err"]
                          for key in ("out", "dq", "dk", "dv"))))
            for cfg in timed}


# ------------------------------------------------------------- train ---

def _flash_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    return {"fwd": fa.LAUNCHES_FWD, "dq": fa.LAUNCHES_BWD_DQ,
            "dkv": fa.LAUNCHES_BWD_DKV}


def _flash_sm90_counts():
    """The launches that took the "sm90" route."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    return {"fwd_sm90": fa.LAUNCHES_FWD_SM90,
            "dq_sm90": fa.LAUNCHES_BWD_DQ_SM90,
            "dkv_sm90": fa.LAUNCHES_BWD_DKV_SM90}


def _reset_flash_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    fa.LAUNCHES_FWD = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0
    fa.LAUNCHES_FWD_SM90 = 0
    fa.LAUNCHES_BWD_DQ_SM90 = fa.LAUNCHES_BWD_DKV_SM90 = 0


def phase_train_parity():
    """A 2-layer fp32 model at llama2_7b widths (remat full, 4 loss chunks,
    B=2, T=256): the trainer on the card (the flash kernels, cuBLAS fp32
    without TF32) against the same trainer on the CPU (plain versions),
    from one state carried with restore_canonical.

    Tolerances: losses rtol 1e-4; first-step gradients 1e-4 rel + 1e-4 x
    the leaf's largest |grad| (fp32 sums in other orders).  AdamW's first
    update is lr x sign(grad), so an entry whose gradient sits below the
    two devices' rounding noise moves the other way (2 x lr apart); after
    3 steps at most PARITY_FAR_SHARE of the parameters may lie further
    apart than 1e-6."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.pretrain import ParallelConfig, PretrainStep

    steps, B, T = PARITY["steps"], PARITY["batch"], PARITY["seq"]
    cfg = getattr(LlamaConfig, PARITY["preset"])(
        num_hidden_layers=PARITY["layers"], dtype="float32")
    pc = ParallelConfig(remat=True, loss_chunks=4)
    cpu = PretrainStep(cfg, pc, device="cpu")
    gpu = PretrainStep(cfg, pc, device="cuda")
    cs = cpu.init_state(seed=0)
    gs = gpu.restore_canonical(cpu.canonical_state(cs))
    rng = np.random.default_rng(0)
    ids, labels = (rng.integers(0, cfg.vocab_size, (B, T)) for _ in range(2))

    _reset_flash_counts()
    g_loss, g_grads = gpu.loss_and_grads(gs["params"], ids, labels)
    c_loss, c_grads = cpu.loss_and_grads(cs["params"], ids, labels)
    torch.cuda.synchronize()
    grad_err = 0.0
    for i, (a, w) in enumerate(zip(gpu._leaves(g_grads),
                                   cpu._leaves(c_grads))):
        err = (a.cpu() - w).abs()
        scale = float(w.abs().max())
        bad = int((err > 1e-4 * scale + 1e-4 * w.abs()).sum())
        if bad:
            raise AssertionError(f"train_parity: gradient leaf {i}: {bad} "
                                 f"entries out of tolerance (max err "
                                 f"{float(err.max())}, scale {scale})")
        grad_err = max(grad_err, float(err.max()))
    del g_grads, c_grads
    g_losses, c_losses = [], []
    for _ in range(steps):
        gs, gl = gpu.train_step(gs, ids, labels)
        cs, cl = cpu.train_step(cs, ids, labels)
        g_losses.append(float(gl))
        c_losses.append(float(cl))
    launches = _flash_counts()
    L = cfg.num_hidden_layers
    want = {"fwd": 2 * L * (steps + 1), "dq": L * (steps + 1),
            "dkv": L * (steps + 1)}
    if launches != want:
        raise AssertionError(f"train_parity: flash launches {launches} != "
                             f"{want}")
    np.testing.assert_allclose(g_losses, c_losses, rtol=1e-4)
    if not g_losses[-1] < g_losses[0]:
        raise AssertionError(f"train_parity: loss did not fall {g_losses}")
    total, far, worst = 0, 0, 0.0
    for a, w in zip(gpu._leaves(gs["params"]), cpu._leaves(cs["params"])):
        err = (a.detach().cpu() - w.detach()).abs()
        total += err.numel()
        far += int((err > 1e-6).sum())
        worst = max(worst, float(err.max()))
    if far > PARITY_FAR_SHARE * total:
        raise AssertionError(f"train_parity: {far} of {total} parameters "
                             f"differ by more than 1e-6 (max {worst})")
    emit("train_parity", layers=cfg.num_hidden_layers, hidden=cfg.hidden_size, batch=B, seq=T,
         steps=steps, dtype="float32", losses_card=g_losses,
         losses_cpu=c_losses, first_step_grad_max_abs_err=grad_err,
         params_max_abs_err=worst, params_further_than_1e6=far,
         params_total=total, flash_launches=launches)
    del gs, cs, gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


def phase_train():
    """The slice's run at full width through the entry point's
    ``build_trainer`` and ``run_steps``: 1 warm-up step, then
    ``TRAIN_STEPS`` timed steps with launch counts from 0.  Frees the state
    before it returns the launch counts."""
    import math
    import torch
    from paddle_tpu_torch.models import pretrain

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = pretrain.build_parser().parse_args(TRAIN_ARGV)
    t0 = time.perf_counter()
    ps, state, ids, labels = pretrain.build_trainer(args)
    L = ps.config.num_hidden_layers
    state, losses, _ = pretrain.run_steps(ps, state, ids, labels, 1)
    t_setup = time.perf_counter() - t0
    steps = TRAIN_STEPS
    _reset_flash_counts()
    state, timed, seconds = pretrain.run_steps(ps, state, ids, labels, steps)
    launches = _flash_counts()
    sm90 = _flash_sm90_counts()
    losses += timed
    want = {"fwd": 2 * L * steps if ps.pc.remat else L * steps,
            "dq": L * steps, "dkv": L * steps}
    if launches != want or sm90 != {"fwd_sm90": want["fwd"],
                                    "dq_sm90": L * steps,
                                    "dkv_sm90": L * steps}:
        raise AssertionError(f"train: flash launches {launches} != {want} "
                             f"({L} layers x {steps} steps), sm90 route "
                             f"{sm90}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses}")
    emit("train", preset=args.preset, layers=L, hidden=ps.config.hidden_size,
         intermediate=ps.config.intermediate_size,
         heads=ps.config.num_attention_heads, vocab=ps.config.vocab_size,
         params=ps.config.num_params(), batch=args.batch, seq=args.seq,
         remat_policy=args.remat_policy, loss_chunks=args.loss_chunks,
         m_dtype=args.m_dtype, v_dtype=ps.pc.v_dtype,
         setup_and_warmup_s=t_setup, step_ms_runs=[t * 1e3 for t in seconds],
         **pretrain.throughput(ps, ids, seconds),
         losses=losses, flash_launches=launches, flash_sm90_launches=sm90)
    del state, ps, ids, labels
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- MoE backward ---

def _grouped_counts():
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    return {"gmm": gm.LAUNCHES, "gmm_trans": gm.LAUNCHES_TRANS,
            "tgmm": gm.LAUNCHES_TGMM, "gmm_sm90": gm.LAUNCHES_SM90,
            "gmm_trans_sm90": gm.LAUNCHES_TRANS_SM90,
            "tgmm_sm90": gm.LAUNCHES_TGMM_SM90}


def _reset_grouped_counts():
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    gm.LAUNCHES = gm.LAUNCHES_TRANS = gm.LAUNCHES_TGMM = 0
    gm.LAUNCHES_SM90 = gm.LAUNCHES_TRANS_SM90 = gm.LAUNCHES_TGMM_SM90 = 0


def _tgmm_route_counts():
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    return gm.LAUNCHES_TGMM, gm.LAUNCHES_TGMM_SM90


def _check_tgmm_route(name, dtype, before):
    """One tgmm launch since ``before`` (``_tgmm_route_counts``), on the
    route of its dtype: sm90 for bf16, simt for fp32."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    n, sm90 = (a - b for a, b in zip(_tgmm_route_counts(), before))
    want = 1 if gm._route(dtype) == "sm90" else 0
    if n != 1 or sm90 != want:
        raise AssertionError(f"{name}: {n} tgmm launches, {sm90} on the sm90 "
                             f"route; want 1 and {want}")
    return gm._route(dtype)


def _tgmm_sm90_ptxas(log):
    """ptxas's record of each kernel of ``tgmm_sm90``'s build log:
    ``{"bn256 cp1": {"registers", "spill_stores", "spill_loads",
    "stack_bytes"}, ...}`` (``cp1``: the cp.async route, ``cp0`` TMA;
    ``registers`` is the launch count; the consumers raise theirs with
    setmaxnreg)."""
    import re
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*tgmm_sm90_kernelILi(\d+)E"
                      r"Lb(\d)E", ln)
        if m:
            name = f"bn{m.group(1)} cp{m.group(2)}"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def _dispatch_rows(ids, E, bm, cut=False):
    """``(rows, tile_groups)`` of the sorted dispatch of the flat expert
    ``ids``: ``rows`` indexes an un-permuted [F + 1, ...] buffer whose last
    row is the zero sentinel.  ``cut`` truncates the plan after the last
    tile of expert E - 2, so expert E - 1 owns no tile."""
    import torch
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    inv, _pos, tg = gm.sorted_dispatch_plan(ids, E, bm)
    if cut:
        keep = int((tg != E - 1).sum())
        inv, tg = inv[:keep * bm], tg[:keep]
    F = ids.numel()
    return torch.where(inv < F, inv, torch.full_like(inv, F)), tg


def _rows_operand(gen, dtype, F, M, width, fused):
    """A gathered operand: the un-permuted [F + 1, width] buffer with a zero
    last row (``fused``), else a pre-permuted [M, width] one."""
    import torch
    x = torch.randn((F + 1 if fused else M, width), generator=gen,
                    device="cuda")
    if fused:
        x[-1] = 0
    return x.to(dtype)


def _check_close(what, out, ref, dtype):
    """Every element within rtol x |ref| + atol x max |ref| (GMM_TOL)."""
    rtol, atol = GMM_TOL[str(dtype).replace("torch.", "")]
    err = (out.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    bad = int((err > atol * scale + rtol * ref.float().abs()).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} elements out of tolerance (max "
                             f"err {float(err.max())}, scale {scale})")
    return float(err.max()), scale, [rtol, atol]


def _grouped_bound_ms(operands, out, flops, dtype):
    """Least time of one grouped call: the larger of the bytes its operands
    and output move once each (over the HBM rate) and ``flops`` over the
    dtype's peak."""
    from paddle_tpu_torch import HBM_BYTES_PER_S, PEAK_FLOPS
    nbytes = sum(x.numel() * x.element_size() for x in operands
                 if x is not None) + out.numel() * out.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _moe_backward_matrix(gen):
    """tgmm and gmm trans_rhs/row_scale against their plain versions over
    the case matrix, fp32 and bf16.  Returns (cases, worst errors)."""
    import torch
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    dev = "cuda"

    def ids_of(counts):
        e = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                    torch.tensor(counts, device=dev))
        return e[torch.randperm(e.numel(), generator=gen, device=dev)]

    # (label, E, ids, bm, K, N, cut, forms): gmm trans reads rhs [E, N, K]
    # (contracting over K, out [M, N]); tgmm writes [E, K, N]
    every = ("trans_rows_scale", "trans_plain", "tgmm_lrows",
             "tgmm_rrows_scale", "tgmm_plain", "tgmm_both_scale")
    matrix = [
        ("empty_experts_bm8", 8, ids_of([3, 0, 9, 1, 0, 0, 2, 1]), 8, 64, 64,
         False, every),
        ("one_expert_bm16", 8, ids_of([40, 0, 0, 0, 0, 0, 0, 0]), 16, 128,
         192, False, every),
        ("cut_plan_bm512", 4, ids_of([600, 1, 3, 0]), 512, 256, 512, True,
         every),
        ("bm128", 8, _routing_ids(gen, 300, 8, 2), 128, 512, 1024, False,
         every),
        ("mixtral_h_i", 8, _routing_ids(gen, 512, 8, 2), 512, 4096, 14336,
         False, ("trans_rows_scale", "tgmm_lrows")),
        ("mixtral_i_h", 8, _routing_ids(gen, 512, 8, 2), 512, 14336, 4096,
         False, ("trans_plain", "tgmm_rrows_scale")),
    ]
    cases, worst = [], {"trans": 0.0, "tgmm": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for label, E, ids, bm, K, N, cut, forms in matrix:
            rows, tg = _dispatch_rows(ids, E, bm, cut)
            F, M = ids.numel(), rows.shape[0]
            scale = torch.rand((M,), generator=gen, device=dev)
            for form in forms:
                lf = form in ("trans_rows_scale", "tgmm_lrows",
                              "tgmm_both_scale")
                rf = form in ("tgmm_rrows_scale", "tgmm_both_scale")
                s = scale if form.endswith("scale") else None
                lhs = _rows_operand(gen, dtype, F, M, K, lf)
                lr = rows if lf else None
                if form.startswith("trans"):
                    rhs = (torch.randn((E, N, K), generator=gen, device=dev)
                           / K ** 0.5).to(dtype)
                    c0 = _gmm_route_counts()
                    out = gm.gmm(lhs, rhs, tg, bm=bm, rows=lr,
                                 trans_rhs=True, row_scale=s)
                    _check_gmm_route(f"{label}/{form}", dtype, c0)
                    ref = gm._gmm_reference(lhs, rhs, tg, bm=bm, rows=lr,
                                            trans_rhs=True, row_scale=s)
                    kind = "trans"
                else:
                    rhs = _rows_operand(gen, dtype, F, M, N, rf)
                    rr = rows if rf else None
                    c0 = _tgmm_route_counts()
                    out = gm.tgmm(lhs, rhs, tg, E, bm=bm, lhs_rows=lr,
                                  rhs_rows=rr, rhs_scale=s)
                    _check_tgmm_route(f"{label}/{form}", dtype, c0)
                    ref = gm._tgmm_reference(lhs, rhs, tg, E, bm=bm,
                                             lhs_rows=lr, rhs_rows=rr,
                                             rhs_scale=s)
                    kind = "tgmm"
                torch.cuda.synchronize()
                name = f"{label}/{dname}/{form}"
                err, ref_max, tol = _check_close(name, out, ref, dtype)
                if kind == "trans" and lf:
                    pad = rows == F
                    if pad.any() and out[pad].abs().max().item() != 0:
                        raise AssertionError(f"{name}: sentinel rows are "
                                             "not exactly 0")
                zero_blocks = []
                if kind == "tgmm":
                    # every block the plain version gives as exact zeros (an
                    # expert with no tile, the cut tail, an expert whose
                    # rows all read the zero sentinel) is exact zeros
                    zero_blocks = (ref.flatten(1) == 0).all(1).nonzero() \
                        .flatten().tolist()
                    if cut and E - 1 not in zero_blocks:
                        raise AssertionError(f"{name}: the plain version's "
                                             "cut tail is not 0")
                    for e in zero_blocks:
                        if out[e].abs().max().item() != 0:
                            raise AssertionError(f"{name}: expert {e}'s "
                                                 "block is not exactly 0")
                rec = {"case": label, "dtype": dname, "form": form, "E": E,
                       "F": F, "bm": bm, "M": M, "K": K, "N": N,
                       "route": gm._route(dtype), "max_abs_err": err,
                       "ref_max_abs": ref_max, "tol": tol}
                if kind == "tgmm":
                    rec["zero_blocks"] = zero_blocks
                    if rec["route"] == "sm90":
                        rec["plan"] = gm.tgmm_sm90_plan(
                            bm, K, N, E, lhs_rows=lf, rhs_rows=rf,
                            rhs_scale=s is not None)
                cases.append(rec)
                worst[kind] = max(worst[kind], err)
                del lhs, rhs, out, ref
            del rows, tg, scale
        torch.cuda.empty_cache()
    return cases, worst


def _moe_backward_timing(gen):
    """The MoE step's grouped calls at the Mixtral training shape (bf16):
    the backward's tgmm and gmm trans_rhs forms and the forward's gate/up
    gmm.  Each call takes the sm90 route (by the counters) and repeats bit
    for bit; each output is held against its plain version (GMM_TOL; rows
    that read the zero sentinel exactly 0), and so is the library
    yardstick's.  Then CUDA-event times of each beside its plain version
    (in turns: plain, kernel, library, kernel, plain), its bound (2 x the
    live rows x K x N over the bf16 peak, or the bytes, whichever is
    larger; the figure on all M rows beside it) and the library yardstick
    on pre-gathered (and pre-scaled) rows."""
    import torch
    from paddle_tpu_torch import PEAK_FLOPS
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    dev, bf = "cuda", torch.bfloat16
    c = MOE_TIMED
    E, bm, H, I = c["E"], c["bm"], c["H"], c["I"]
    ids = _routing_ids(gen, c["tokens"], E, c["k"])
    rows, tg = _dispatch_rows(ids, E, bm)
    F, M = ids.numel(), rows.shape[0]
    live = F
    xz = _rows_operand(gen, bf, F, M, H, True)        # [F + 1, H] buffers
    dy_z = _rows_operand(gen, bf, F, M, H, True)
    dh = _rows_operand(gen, bf, F, M, I, False)       # [M, I]
    a = _rows_operand(gen, bf, F, M, I, False)
    w_gate = (torch.randn((E, H, I), generator=gen, device=dev)
              / H ** 0.5).to(bf)
    w_down = (torch.randn((E, I, H), generator=gen, device=dev)
              / I ** 0.5).to(bf)
    s = torch.rand((M,), generator=gen, device=dev)
    ends = torch.searchsorted(tg, torch.arange(E, device=dev,
                                               dtype=torch.int32),
                              right=True).to(torch.int32) * bm
    bounds = [0] + ends.tolist()
    x_g = xz[rows.long()]                             # pre-gathered rows
    dy_gs = (dy_z[rows.long()] * s[:, None].to(bf)).contiguous()
    grouped_mm = hasattr(torch, "_grouped_mm")

    def per_expert_tn(p, q):
        return [p[bounds[e]:bounds[e + 1]].t() @ q[bounds[e]:bounds[e + 1]]
                for e in range(E)]

    def per_expert_nn(p, w):
        return [p[bounds[e]:bounds[e + 1]] @ w[e] for e in range(E)]

    def per_expert_nt(p, w):
        return [p[bounds[e]:bounds[e + 1]] @ w[e].t() for e in range(E)]

    calls = {
        "gmm_up": dict(     # the forward's gate/up form (fused gather)
            kernel=lambda: gm.gmm(xz, w_gate, tg, bm=bm, rows=rows),
            plain=lambda: gm._gmm_reference(xz, w_gate, tg, bm=bm,
                                            rows=rows),
            library=(lambda: torch._grouped_mm(x_g, w_gate, offs=ends))
            if grouped_mm else (lambda: per_expert_nn(x_g, w_gate)),
            operands=(xz, w_gate, rows, tg), K=H, N=I),
        "gmm_down": dict(   # the forward's down form (no gather)
            kernel=lambda: gm.gmm(a, w_down, tg, bm=bm),
            plain=lambda: gm._gmm_reference(a, w_down, tg, bm=bm),
            library=(lambda: torch._grouped_mm(a, w_down, offs=ends))
            if grouped_mm else (lambda: per_expert_nn(a, w_down)),
            operands=(a, w_down, tg), K=I, N=H),
        "tgmm_dw_gate": dict(
            kernel=lambda: gm.tgmm(xz, dh, tg, E, bm=bm, lhs_rows=rows),
            in_kernel=lambda: _tgmm_in_kernel_gather(xz, dh, tg, E, bm,
                                                     lrows=rows),
            plain=lambda: gm._tgmm_reference(xz, dh, tg, E, bm=bm,
                                             lhs_rows=rows),
            library=(lambda: torch._grouped_mm(x_g.t(), dh, offs=ends))
            if grouped_mm else
            (lambda: per_expert_tn(x_g, dh)),
            operands=(xz, dh, rows, tg), K=H, N=I),
        "tgmm_dw_down": dict(
            kernel=lambda: gm.tgmm(a, dy_z, tg, E, bm=bm, rhs_rows=rows,
                                   rhs_scale=s),
            in_kernel=lambda: _tgmm_in_kernel_gather(a, dy_z, tg, E, bm,
                                                     rrows=rows, scale=s),
            plain=lambda: gm._tgmm_reference(a, dy_z, tg, E, bm=bm,
                                             rhs_rows=rows, rhs_scale=s),
            library=(lambda: torch._grouped_mm(a.t(), dy_gs, offs=ends))
            if grouped_mm else
            (lambda: per_expert_tn(a, dy_gs)),
            operands=(a, dy_z, rows, s, tg), K=I, N=H),
        "trans_da": dict(
            kernel=lambda: gm.gmm(dy_z, w_down, tg, bm=bm, rows=rows,
                                  trans_rhs=True, row_scale=s),
            plain=lambda: gm._gmm_reference(dy_z, w_down, tg, bm=bm,
                                            rows=rows, trans_rhs=True,
                                            row_scale=s),
            library=(lambda: torch._grouped_mm(dy_gs, w_down.transpose(1, 2),
                                               offs=ends))
            if grouped_mm else (lambda: per_expert_nt(dy_gs, w_down)),
            operands=(dy_z, w_down, rows, s, tg), K=H, N=I),
        "trans_dx": dict(
            kernel=lambda: gm.gmm(dh, w_gate, tg, bm=bm, trans_rhs=True),
            plain=lambda: gm._gmm_reference(dh, w_gate, tg, bm=bm,
                                            trans_rhs=True),
            library=(lambda: torch._grouped_mm(dh, w_gate.transpose(1, 2),
                                               offs=ends))
            if grouped_mm else (lambda: per_expert_nt(dh, w_gate)),
            operands=(dh, w_gate, tg), K=I, N=H),
    }
    timings = {}
    for name, cl in calls.items():
        tg_form = name.startswith("tgmm")
        c0 = _tgmm_route_counts() if tg_form else _gmm_route_counts()
        mine = cl["kernel"]()
        route = (_check_tgmm_route if tg_form else _check_gmm_route)(
            f"training shape {name}", bf, c0)
        again = cl["kernel"]()
        torch.cuda.synchronize()
        if not torch.equal(mine, again):
            raise AssertionError(f"training shape {name}: two runs differ")
        del again
        ref = cl["plain"]()
        lib_out = cl["library"]()
        if isinstance(lib_out, list):
            lib_out = torch.stack(lib_out) if name.startswith("tgmm") else \
                torch.cat(lib_out)
        torch.cuda.synchronize()
        err, ref_max, tol = _check_close(f"training shape {name}", mine, ref,
                                         bf)
        lib_err = _check_close(f"training shape {name} library", lib_out,
                               ref, bf)[0]
        if name in ("gmm_up", "trans_da") and \
                mine[rows == F].abs().max().item() != 0:
            raise AssertionError(f"training shape {name}: sentinel rows are "
                                 "not exactly 0")
        del lib_out
        extra = {}
        if tg_form:
            # the gather (and scale) inside the kernel, by cp.async, where
            # the wrapper runs its gather pass and reads TMA tiles: the
            # comparison that chose the pass
            inner = cl["in_kernel"]()
            torch.cuda.synchronize()
            extra = {"in_kernel_gather_max_abs_err": _check_close(
                f"training shape {name} in-kernel gather", inner, ref,
                bf)[0],
                "in_kernel_gather_ms": min(cuda_ms(cl["in_kernel"], 5)
                                           for _ in range(2))}
            del inner
        del ref
        t = {}
        for key in ("plain", "kernel", "library", "kernel2", "plain2"):
            fn = cl[key.rstrip("2")]
            t[key] = cuda_ms(fn, 2 if key.startswith("plain") else 5)
            torch.cuda.empty_cache()
        K, N = cl["K"], cl["N"]
        # the live rows' products: the padding rows read the zero sentinel
        # (or are dropped by the tile's group) and add nothing
        b_ms, b_by = _grouped_bound_ms(cl["operands"], mine,
                                       2 * live * K * N, bf)
        ms = min(t["kernel"], t["kernel2"])
        lib_call = ("torch._grouped_mm" if grouped_mm else
                    "per-expert torch.matmul") + " on pre-gathered rows"
        timings[name] = {
            "shape": f"mixtral train {name} M={M} live={live} bm={bm} "
                     f"K={K} N={N} bf16",
            "route": route, "bitwise_repeat": True,
            "plan": gm.tgmm_sm90_plan(
                bm, K, N, E, lhs_rows=name == "tgmm_dw_gate",
                rhs_rows=name == "tgmm_dw_down",
                rhs_scale=name == "tgmm_dw_down")
            if tg_form else gm.sm90_plan(bm, M, N),
            "max_abs_err": err, "ref_max_abs": ref_max, "tol": tol,
            "kernel_ms": ms, "kernel_ms_runs": [t["kernel"], t["kernel2"]],
            "plain_ms": min(t["plain"], t["plain2"]),
            "plain_ms_runs": [t["plain"], t["plain2"]],
            "library_ms": t["library"], "library_call": lib_call,
            "library_max_abs_err": lib_err,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_padded_rows":
                2 * M * K * N / PEAK_FLOPS["bfloat16"] * 1e3,
            "tflops_live_rows": 2 * live * K * N / (ms * 1e9), **extra}
        del mine
    del xz, dy_z, dh, a, w_gate, w_down, s, x_g, dy_gs
    torch.cuda.empty_cache()
    return timings


def _tgmm_in_kernel_gather(lhs, rhs, tg, E, bm, lrows=None, rrows=None,
                           scale=None):
    """``tgmm`` on the sm90 kernel with the rows (and the scale) handed to
    ``ptt_tgmm_sm90``, which then gathers them in the kernel by cp.async,
    instead of the wrapper's gather pass and TMA tiles."""
    import torch
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    M = (lrows if lrows is not None else lhs).shape[0]
    K, N = lhs.shape[1], rhs.shape[1]
    out = torch.empty((E, K, N), dtype=lhs.dtype, device=lhs.device)
    sc = None if scale is None else scale.to(rhs.dtype).contiguous()
    ptr = gm._ptr
    err = gm._lib("tgmm_sm90").ptt_tgmm_sm90(
        ptr(lhs), ptr(rhs), ptr(tg), ptr(lrows), ptr(rrows), ptr(sc),
        ptr(out), M, K, N, E, lhs.shape[0], rhs.shape[0], bm, M // bm, 1,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tgmm in-kernel gather: CUDA error {err}")
    return out


def _launch_mix(timings, mix):
    """Launch-weighted means of the timed forms in ``mix`` ({form:
    launches}); ``bound_by`` of the form that weighs most in the bound."""
    n = sum(mix.values())
    out = {k: sum(w * timings[f][k] for f, w in mix.items()) / n
           for k in ("kernel_ms", "plain_ms", "bound_ms", "library_ms")}
    top = max(mix, key=lambda f: mix[f] * timings[f]["bound_ms"])
    out["bound_by"] = timings[top]["bound_by"]
    out["forms"] = {timings[f]["shape"]: w for f, w in mix.items()}
    return out


def phase_kernel_tgmm(built):
    """``built``: ``phase_build``'s record (the tgmm_sm90 build's ptxas
    log: every kernel must have 0 spill bytes)."""
    import torch
    ptxas = _tgmm_sm90_ptxas(built.get("tgmm_sm90", {}).get("log", ""))
    spills = {k: v for k, v in ptxas.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    if len(ptxas) != TGMM_SM90_KERNELS or spills:
        raise AssertionError(f"tgmm_sm90: ptxas record {ptxas} (empty: "
                             f"built before phase_build; {TGMM_SM90_KERNELS} "
                             "kernels, each with 0 spill bytes)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases, worst = _moe_backward_matrix(gen)
    timings = _moe_backward_timing(gen)
    for kind, mix in MOE_MIX.items():
        worst[kind] = max([worst.get(kind, 0.0)] +
                          [timings[f]["max_abs_err"] for f in mix])
    mixes = {kind: _launch_mix(timings, mix) for kind, mix in MOE_MIX.items()}
    emit("kernel_tgmm", cases=cases, max_abs_err=worst, timings=timings,
         launch_mix=mixes, tgmm_sm90_ptxas=ptxas)
    return worst, timings, mixes


def _first_layer_topk(ps, params, ids):
    """Top-k expert ids [B*T, k] of the first layer's router in the first
    forward, computed from the layer's own submodules."""
    import torch
    from paddle_tpu_torch.models.llama import _route_topk
    lp = params["blocks"][0]
    t = ps._template

    def sub(prefix):
        return {k[len(prefix) + 1:]: v for k, v in lp.items()
                if k.startswith(prefix + ".")}

    def call(mod, name, *args):
        return torch.func.functional_call(mod, sub(name), args)

    ids = ps.shard_batch(ids, ids)[0]
    cos, sin = ps._rope_tables(ids.shape[1])
    with torch.no_grad():
        h = torch.nn.functional.embedding(ids, params["embed"])
        h = h + call(t.self_attn, "self_attn",
                     call(t.input_layernorm, "input_layernorm", h), cos, sin)
        x = call(t.post_attention_layernorm, "post_attention_layernorm", h)
        topi = _route_topk(x.reshape(-1, x.shape[-1]),
                           lp["mlp.gate.weight"], ps.config.moe_top_k)[1]
    return torch.sort(topi, dim=-1).values.cpu()


def _moe_parity_run(seed, tf32=False):
    """One fp32 layer at Mixtral-8x7B widths (remat full, 4 loss chunks,
    B=2, T=256): the trainer on the card (the grouped and flash kernels,
    cuBLAS fp32) against the same trainer on the CPU (plain versions), from
    one state carried with restore_canonical; ``seed`` draws the state and
    the batch.  With ``tf32`` cuBLAS runs the card's dense matmuls in TF32
    (the control: a step of lower precision).  Returns the readings and
    checks nothing: first-step gradient entries out of train_parity's
    tolerance, 3 steps' losses, parameters further apart than 1e-6, launch
    counts, and the tokens routed to other experts on the card than on the
    CPU in the first forward (near-ties)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.pretrain import ParallelConfig, PretrainStep

    t0 = time.perf_counter()
    steps, B, T = MOE_PARITY["steps"], MOE_PARITY["batch"], MOE_PARITY["seq"]
    cfg = getattr(LlamaConfig, MOE_PARITY["preset"])(
        num_hidden_layers=MOE_PARITY["layers"], dtype="float32")
    pc = ParallelConfig(remat=True, loss_chunks=4)
    cpu = PretrainStep(cfg, pc, device="cpu")
    gpu = PretrainStep(cfg, pc, device="cuda")
    cs = cpu.init_state(seed=seed)
    gs = gpu.restore_canonical(cpu.canonical_state(cs))
    gc.collect()
    rng = np.random.default_rng(seed)
    ids, labels = (rng.integers(0, cfg.vocab_size, (B, T)) for _ in range(2))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    near_ties = int((_first_layer_topk(gpu, gs["params"], ids) !=
                     _first_layer_topk(cpu, cs["params"], ids))
                    .any(dim=-1).sum())

    _reset_flash_counts()
    _reset_grouped_counts()
    g_loss, g_grads = gpu.loss_and_grads(gs["params"], ids, labels)
    c_loss, c_grads = cpu.loss_and_grads(cs["params"], ids, labels)
    torch.cuda.synchronize()
    grad_err, grad_bad = 0.0, {}
    for i, (a, w) in enumerate(zip(gpu._leaves(g_grads),
                                   cpu._leaves(c_grads))):
        err = (a.cpu() - w).abs()
        bad = int((err > 1e-4 * float(w.abs().max()) + 1e-4 * w.abs()).sum())
        if bad:
            grad_bad[i] = bad
        grad_err = max(grad_err, float(err.max()))
    del g_grads, c_grads
    g_losses, c_losses = [], []
    for _ in range(steps):
        gs, gl = gpu.train_step(gs, ids, labels)
        cs, cl = cpu.train_step(cs, ids, labels)
        g_losses.append(float(gl))
        c_losses.append(float(cl))
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {**_flash_counts(), **_grouped_counts()}
    total, far, worst = 0, 0, 0.0
    for a, w in zip(gpu._leaves(gs["params"]), cpu._leaves(cs["params"])):
        err = (a.detach().cpu() - w.detach()).abs()
        total += err.numel()
        far += int((err > 1e-6).sum())
        worst = max(worst, float(err.max()))
    out = dict(seed=seed, tf32=tf32, layers=cfg.num_hidden_layers,
               hidden=cfg.hidden_size, intermediate=cfg.intermediate_size,
               experts=cfg.moe_num_experts, params=cfg.num_params(),
               batch=B, seq=T, steps=steps, dtype="float32",
               near_ties=near_ties, tokens=B * T, losses_card=g_losses,
               losses_cpu=c_losses, first_step_grad_max_abs_err=grad_err,
               first_step_grad_out_of_tol=grad_bad, params_max_abs_err=worst,
               params_further_than_1e6=far, params_total=total,
               far_share=far / total,
               router_stats_card=gpu.router_stats(gs, ids),
               router_stats_cpu=cpu.router_stats(cs, ids), launches=launches,
               seconds=time.perf_counter() - t0)
    del gs, cs, gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe_train_parity():
    """``_moe_parity_run`` at seed 0, held to train_parity's tolerances
    (losses rtol 1e-4; first-step gradients 1e-4 rel + 1e-4 x the leaf's
    largest |grad|), exact launch counts, a falling loss, and at most
    MOE_PARITY_FAR_SHARE of the parameters further apart than 1e-6."""
    import numpy as np
    r = _moe_parity_run(0)
    if r["first_step_grad_out_of_tol"]:
        raise AssertionError(f"moe_train_parity: gradient entries out of "
                             f"tolerance per leaf "
                             f"{r['first_step_grad_out_of_tol']} (max err "
                             f"{r['first_step_grad_max_abs_err']}; "
                             f"{r['near_ties']} near-ties)")
    n = r["layers"] * (r["steps"] + 1)
    # fp32: every gmm launch on the simt route
    want = {"fwd": 2 * n, "dq": n, "dkv": n, "gmm": 6 * n,
            "gmm_trans": 3 * n, "tgmm": 3 * n, "gmm_sm90": 0,
            "gmm_trans_sm90": 0, "tgmm_sm90": 0}
    if r["launches"] != want:
        raise AssertionError(f"moe_train_parity: launches {r['launches']} "
                             f"!= {want}")
    np.testing.assert_allclose(r["losses_card"], r["losses_cpu"], rtol=1e-4)
    if not r["losses_card"][-1] < r["losses_card"][0]:
        raise AssertionError(f"moe_train_parity: loss did not fall "
                             f"{r['losses_card']}")
    if r["far_share"] > MOE_PARITY_FAR_SHARE:
        raise AssertionError(f"moe_train_parity: {r['far_share']} of the "
                             f"parameters differ by more than 1e-6 (max "
                             f"{r['params_max_abs_err']}; limit "
                             f"{MOE_PARITY_FAR_SHARE})")
    emit("moe_train_parity", far_share_limit=MOE_PARITY_FAR_SHARE, **r)


def moe_parity_spread() -> int:
    """``python3 chip_smoke.py --moe-parity-spread``: the readings that
    MOE_PARITY_FAR_SHARE is set from.  ``_moe_parity_run`` at each of
    MOE_SPREAD_SEEDS in fp32 (seed 0 twice: the backward's atomics make
    repeats differ), then at MOE_CONTROL_SEEDS with TF32 on.  One line per
    run and a summary line; checks nothing and prints no ``ok`` line."""
    from paddle_tpu_torch.models.pretrain import use_expandable_segments
    use_expandable_segments()
    phase_device()
    phase_build()
    runs = []
    for seed, tf32 in ([(s, False) for s in MOE_SPREAD_SEEDS] +
                       [(s, True) for s in MOE_CONTROL_SEEDS]):
        runs.append(_moe_parity_run(seed, tf32))
        emit("moe_parity_spread_run", **runs[-1])
    share = {key: [r["far_share"] for r in runs if r["tf32"] == key]
             for key in (False, True)}
    emit("moe_parity_spread", fp32_far_share=share[False],
         tf32_far_share=share[True], fp32_max=max(share[False]),
         tf32_min=min(share[True]), limit=MOE_PARITY_FAR_SHARE)
    return 0


def phase_train_moe():
    """The slice's run at Mixtral-8x7B widths, 4 layers, through the entry
    point's ``build_trainer`` and ``run_steps``: 1 warm-up step, then
    ``TRAIN_STEPS`` timed steps with launch counts from 0.  Frees the state
    before it returns the launch counts."""
    import math
    import torch
    from paddle_tpu_torch.models import pretrain

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = pretrain.build_parser().parse_args(TRAIN_MOE_ARGV)
    t0 = time.perf_counter()
    ps, state, ids, labels = pretrain.build_trainer(args)
    L = ps.config.num_hidden_layers
    state, losses, _ = pretrain.run_steps(ps, state, ids, labels, 1)
    t_setup = time.perf_counter() - t0
    steps = TRAIN_STEPS
    _reset_flash_counts()
    _reset_grouped_counts()
    state, timed, seconds = pretrain.run_steps(ps, state, ids, labels, steps)
    launches = {**_flash_counts(), **_flash_sm90_counts(),
                **_grouped_counts()}
    losses += timed
    n = L * steps
    fwd = 2 if ps.pc.remat else 1
    want = {"fwd": fwd * n, "dq": n, "dkv": n, "fwd_sm90": fwd * n,
            "dq_sm90": n, "dkv_sm90": n, "gmm": 3 * fwd * n,
            "gmm_trans": 3 * n, "tgmm": 3 * n, "gmm_sm90": 3 * fwd * n,
            "gmm_trans_sm90": 3 * n, "tgmm_sm90": 3 * n}
    if launches != want:
        raise AssertionError(f"train_moe: launches {launches} != {want} "
                             f"({L} layers x {steps} steps)")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train_moe: losses {losses}")
    tp = pretrain.throughput(ps, ids, seconds)
    router = ps.router_stats(state, ids)
    cfg = ps.config
    emit("train_moe", preset=args.preset, layers=L, hidden=cfg.hidden_size,
         intermediate=cfg.intermediate_size,
         heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
         vocab=cfg.vocab_size, experts=cfg.moe_num_experts,
         top_k=cfg.moe_top_k, block_m=cfg.moe_block_m,
         params=cfg.num_params(), active_params=cfg.num_active_params(),
         batch=args.batch, seq=args.seq, remat_policy=args.remat_policy,
         loss_chunks=args.loss_chunks, m_dtype=args.m_dtype,
         v_dtype=ps.pc.v_dtype, setup_and_warmup_s=t_setup,
         step_ms_runs=[t * 1e3 for t in seconds], **tp, losses=losses,
         router_stats=router, launches=launches)
    del state, ps, ids, labels
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- weight-only ---

def _wo_counts():
    from paddle_tpu_torch.kernels import weight_only as wo
    return {"int8": wo.LAUNCHES, "int4": wo.LAUNCHES_INT4}


def _reset_wo_counts():
    from paddle_tpu_torch.kernels import weight_only as wo
    wo.LAUNCHES = wo.LAUNCHES_INT4 = 0


def _wo_check(what, out, ref):
    """The weight-only kernel against its plain version: fp32 by the
    relative RMS error, at most 1e-5 of the output's RMS, and every element
    within 1e-4 of that RMS (summation order over k); bf16/fp16 every
    element within one ulp of the largest output (both sum in fp32 and
    round once).  Returns (max abs error, the largest share of its limit
    that a check used); raises past 1."""
    import math
    import torch
    if out.dtype != ref.dtype or out.shape != ref.shape:
        raise AssertionError(f"{what}: {out.dtype} {tuple(out.shape)} vs "
                             f"{ref.dtype} {tuple(ref.shape)}")
    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (o - r).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if out.dtype == torch.float32:
        rms = float(r.square().mean().sqrt())
        limits = [(float(err.square().mean().sqrt()), 1e-5 * rms),
                  (max_err, 1e-4 * rms)]
    else:
        big = float(r.abs().max())
        ulp = torch.finfo(out.dtype).eps * 2.0 ** math.floor(math.log2(big)) \
            if big else 0.0
        limits = [(max_err, ulp)]
    need = max((e / lim) if lim else (math.inf if e else 0.0)
               for e, lim in limits)
    if need > 1:
        raise AssertionError(f"{what}: error {max_err} is {need:.3g} x its "
                             "tolerance")
    return max_err, need


def _wo_library_check(what, y, x, q, s_lib, int4, k):
    """A library yardstick against the plain version with the scale the
    library takes, ``s_lib`` in bf16: every element within one bf16 ulp of
    the largest output plus ``2u * (|x| @ |q|) * |s_lib|`` (u = 2^-8, the
    bf16 unit roundoff: room for a call that rounds the dequantized weight
    ``q * s`` to bf16 before its product).  Returns the largest share of its
    limit that an element used; raises past 1."""
    import math
    import torch
    from paddle_tpu_torch.kernels import weight_only as wo
    if y.shape != (x.shape[0], q.shape[1]) or \
            not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{what}: {tuple(y.shape)} or non-finite")
    codes = wo._unpack(q, int4, k).float()
    sb = s_lib.float()
    ref = (x.float() @ codes) * sb
    mag = (x.float().abs() @ codes.abs()) * sb.abs()
    big = float(ref.abs().max())
    ulp = torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(math.log2(big))
    need = float(((y.float() - ref).abs() / (ulp + 2 * 2.0 ** -8 * mag)).max())
    if need > 1:
        raise AssertionError(f"{what}: error is {need:.3g} x its tolerance")
    return need


def _wo_matrix(gen):
    """The weight-only kernel against its plain version over WO_MS x WO_KN,
    int8 and int4, x in fp32/bf16/fp16, each weight with an all-zero column
    (its output must be exactly 0); a [2, 3, 7, k] input through
    ``weight_only_linear`` with and without a bias; the empty batch (no
    launch); extreme codes (all -127/-8, all +127/+7)."""
    import torch
    from paddle_tpu_torch.kernels import weight_only as wo
    from paddle_tpu_torch.quantization import (_pack_int4, weight_only_linear,
                                               weight_quantize)
    dev = "cuda"
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    worst = {mode: {"max_abs_err": 0.0, "need": 0.0, "cases": 0,
                    "need_by_dtype": {}} for mode in WO_MODES}

    def check(mode, what, out, ref):
        err, need = _wo_check(f"kernel_wo {mode}/{what}", out, ref)
        w = worst[mode]
        w["max_abs_err"] = max(w["max_abs_err"], err)
        w["need"] = max(w["need"], need)
        w["cases"] += 1
        dn = str(out.dtype).replace("torch.", "")
        w["need_by_dtype"][dn] = max(w["need_by_dtype"].get(dn, 0.0), need)
        if out[..., 1].any():
            raise AssertionError(f"kernel_wo {mode}/{what}: the zero weight "
                                 "column's output is not 0")

    for mode, algo in WO_MODES.items():
        int4 = mode == "int4"
        rows_of = (lambda k: k) if int4 else (lambda k: None)
        for k, n in WO_KN:
            w = torch.randn((k, n), generator=gen, device=dev)
            w[:, 1] = 0
            q, s = weight_quantize(w, algo)
            del w
            for dtype in dtypes:
                dn = str(dtype).replace("torch.", "")
                for m in WO_MS:
                    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                    out = wo.weight_only_matmul(x, q, s, int4_rows=rows_of(k))
                    check(mode, f"{dn}/m{m}/k{k}/n{n}", out,
                          wo._wo_reference(x, q, s, int4, k, dtype))
                x = torch.randn((2, 3, 7, k), generator=gen,
                                device=dev).to(dtype)
                out = weight_only_linear(x, q, weight_scale=s,
                                         weight_dtype=mode)
                check(mode, f"{dn}/[2,3,7]/k{k}/n{n}", out, wo._wo_reference(
                    x.reshape(-1, k), q, s, int4, k, dtype).reshape(out.shape))
                bias = torch.randn((n,), generator=gen, device=dev)
                yb = weight_only_linear(x, q, bias=bias, weight_scale=s,
                                        weight_dtype=mode)
                if yb.dtype != torch.promote_types(dtype, torch.float32) or \
                        not torch.equal(yb, out + bias):
                    raise AssertionError(f"kernel_wo {mode}/{dn}: the bias is "
                                         "not added after the product")
                before = _wo_counts()
                empty = wo.weight_only_matmul(x[:, :, :0], q, s,
                                              int4_rows=rows_of(k))
                if tuple(empty.shape) != (2, 3, 0, n) or \
                        _wo_counts() != before:
                    raise AssertionError(f"kernel_wo {mode}: the empty batch")
        for code in ((-8, 7) if int4 else (-127, 127)):
            for k, n in ((96, 200), (4096, 4096)):
                c = torch.full((k, n), code, dtype=torch.int8, device=dev)
                c[:, 1] = 0
                q = _pack_int4(c) if int4 else c
                s = torch.full((n,), 1.0 / abs(code), device=dev)
                for dtype in dtypes:
                    x = torch.randn((8, k), generator=gen, device=dev).to(dtype)
                    out = wo.weight_only_matmul(x, q, s, int4_rows=rows_of(k))
                    check(mode, f"codes{code}/{dtype}/k{k}/n{n}", out,
                          wo._wo_reference(x, q, s, int4, k, dtype))
    torch.cuda.synchronize()
    return worst


def _wo_timing(gen):
    """CUDA-event times at llama2_7b's gate/up shape (k 4096, n 11008, bf16
    x) for each m of WO_TIMED, in turns (plain, kernel, yardsticks, kernel,
    plain): the kernel, its plain version, the library call and
    ``torch.matmul`` over the unquantized bf16 weight.  The library call is
    ``torch._weight_int8pack_mm`` for int8 (weight [n, k], its scale in
    bf16) and ``torch._weight_int4pack_mm`` for int4 (the codes + 8 packed
    once by ``torch._convert_weight_to_int4pack``, the scale in bf16
    repeated in every group of WO_LIB_GROUP rows, zero points 0, so it
    computes ``x @ ((q + 8 - 8) * scale)``); each is held against the plain
    version by :func:`_wo_library_check`.  Each timed call takes the next of
    several copies of its weight that together exceed 3x the 50 MB L2
    cache, so every call reads its weight from device memory, as a sweep
    over a model's projections does."""
    import itertools
    import torch
    from paddle_tpu_torch.kernels import weight_only as wo
    from paddle_tpu_torch.quantization import weight_quantize
    k, n = WO_TIMED["k"], WO_TIMED["n"]
    bf16 = torch.bfloat16
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(bf16)
    ws = [w] + [w.clone() for _ in range(-(-3 * L2_BYTES // (2 * w.numel()))
                                         - 1)]

    def rotate(call, count):
        it = itertools.count()
        return lambda: call(next(it) % count)

    timings = {}
    for mode, algo in WO_MODES.items():
        int4 = mode == "int4"
        rows = k if int4 else None
        q, s = weight_quantize(w, algo)
        copies = -(-3 * L2_BYTES // q.numel())
        qs = [q] + [q.clone() for _ in range(copies - 1)]
        s_lib = s.to(bf16)
        lib_fn, lib = None, {}
        try:
            if int4:
                gs = WO_LIB_GROUP
                u = (wo._unpack_int4(q, k).int() + 8).t().contiguous()
                pk = torch._convert_weight_to_int4pack(
                    ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8),
                    WO_LIB_INNER_K_TILES)
                del u
                lib_ws = [pk] + [pk.clone() for _ in range(copies - 1)]
                sz = torch.stack([s_lib.expand(k // gs, n),
                                  torch.zeros_like(s_lib).expand(k // gs, n)],
                                 dim=-1).contiguous()
                lib["library_call"] = (
                    f"torch._weight_int4pack_mm (group {gs}, inner k tiles "
                    f"{WO_LIB_INNER_K_TILES}, per-channel bf16 scale in every "
                    "group, zero points 0)")

                def lib_fn(x, i):
                    return torch._weight_int4pack_mm(x, lib_ws[i], gs, sz)
            else:
                lib_ws = [c.t().contiguous() for c in qs]
                lib["library_call"] = ("torch._weight_int8pack_mm (weight "
                                       "[n, k], bf16 scale)")

                def lib_fn(x, i):
                    return torch._weight_int8pack_mm(x, lib_ws[i], s_lib)
        except (RuntimeError, NotImplementedError) as e:
            lib_fn, lib_ws = None, []
            lib["library_note"] = (f"null: packing for the library call "
                                   f"raised on CUDA: {str(e)[:300]}")
        for m in WO_TIMED["ms"]:
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf16)
            out = wo.weight_only_matmul(x, q, s, int4_rows=rows)
            ref = wo._wo_reference(x, q, s, int4, k, bf16)
            err, need = _wo_check(f"kernel_wo timed {mode} m{m}", out, ref)
            fns = {"plain": rotate(lambda i: wo._wo_reference(
                       x, qs[i], s, int4, k, bf16), copies),
                   "kernel": rotate(lambda i: wo.weight_only_matmul(
                       x, qs[i], s, int4_rows=rows), copies),
                   "bf16_matmul": rotate(lambda i: torch.matmul(x, ws[i]),
                                         len(ws))}
            lib_m = dict(lib)
            if lib_fn is not None:
                try:
                    y = lib_fn(x, 0)
                    torch.cuda.synchronize()
                except (RuntimeError, NotImplementedError) as e:
                    y = None
                    lib_m["library_note"] = (f"null: the library call raised "
                                             f"on CUDA: {str(e)[:300]}")
                if y is not None:
                    lib_m["library_need"] = _wo_library_check(
                        f"kernel_wo library {mode} m{m}", y, x, q, s_lib,
                        int4, k)
                    lib_m["library_max_abs_err_vs_plain"] = float(
                        (y.float() - ref.float()).abs().max())
                    fns["library"] = rotate(lambda i: lib_fn(x, i), copies)
            iters = 100 if m <= 16 else 30
            t = {}
            for key in ("plain", "kernel", "bf16_matmul", "library", "kernel2",
                        "plain2"):
                fn = fns.get(key.rstrip("2"))
                if fn is not None:
                    t[key] = cuda_ms(fn, 10 if key.startswith("plain")
                                     else iters)
            b_ms, b_by = _grouped_bound_ms([x, q, s], out, 2 * m * k * n, bf16)
            timings[f"{mode}_m{m}"] = {
                "shape": f"llama2_7b gate/up m={m} k={k} n={n} bf16 x, {mode}",
                "weight_copies": copies, "max_abs_err": err, "need": need,
                "kernel_ms": min(t["kernel"], t["kernel2"]),
                "kernel_ms_runs": [t["kernel"], t["kernel2"]],
                "plain_ms": min(t["plain"], t["plain2"]),
                "plain_ms_runs": [t["plain"], t["plain2"]],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": t.get("library"), **lib_m,
                "bf16_matmul_ms": t["bf16_matmul"]}
        del qs, lib_ws
    return timings


def phase_kernel_wo():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = _wo_matrix(gen)
    timings = _wo_timing(gen)
    emit("kernel_wo", worst=worst, timings=timings)
    torch.cuda.empty_cache()
    return worst, timings


def phase_weight_only_path():
    """The slice at full width: every projection of llama2_7b (32 layers,
    not cut: q, k, v, o, gate, up, down) and its LM head, 225 random bf16
    weights from a seed, made one layer at a time and quantized on the
    card with ``weight_quantize``, int8 and int4; then ``weight_only_linear``
    over all 225 for bf16 activations of each m in WO_PATH_MS.  Launch
    counts are set to 0 just before one untimed sweep per (m, mode) and read
    just after: exactly 225 per sweep.  Layer 0's and the head's outputs are
    held against the plain version; then timed sweeps beside the same sweep
    through ``torch.matmul`` over the bf16 weights; then ``dx`` through
    ``weight_only_linear`` (layer 0's gate, fp32 and bf16 x) against the
    same call on the CPU.  Frees everything before it returns the launch
    counts and the sweep times."""
    import torch
    from paddle_tpu_torch import HBM_BYTES_PER_S, PEAK_FLOPS
    from paddle_tpu_torch.kernels import weight_only as wo
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.quantization import (weight_only_linear,
                                               weight_quantize)
    cfg = LlamaConfig.llama2_7b()
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    L = cfg.num_hidden_layers
    kv = (cfg.num_key_value_heads or cfg.num_attention_heads) * \
        (H // cfg.num_attention_heads)
    per_layer = (("q", H, H), ("k", H, kv), ("v", H, kv), ("o", H, H),
                 ("gate", H, I), ("up", H, I), ("down", I, H))
    bf16 = torch.bfloat16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(7)
    names, shapes, dense, quant = [], [], [], {mode: [] for mode in WO_MODES}
    t0 = time.perf_counter()
    for layer in [f"{i}." for i in range(L)] + [""]:
        for name, k, n in (per_layer if layer else (("lm_head", H, V),)):
            w = torch.randn((k, n), generator=gen, device="cuda",
                            dtype=bf16) * 0.02
            for mode, algo in WO_MODES.items():
                quant[mode].append(weight_quantize(w, algo))
            names.append(layer + name)
            shapes.append((k, n))
            dense.append(w)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    index = {nm: i for i, nm in enumerate(names)}
    checked = [f"0.{nm}" for nm, _, _ in per_layer] + ["lm_head"]
    xs = {m: {d: torch.randn((m, d), generator=gen, device="cuda").to(bf16)
              for d in (H, I)} for m in WO_PATH_MS}

    def sweep(m, mode, keep=()):
        kept, finite = {}, []
        for i, (k, _n) in enumerate(shapes):
            q, s = quant[mode][i]
            y = weight_only_linear(xs[m][k], q, weight_scale=s,
                                   weight_dtype=mode)
            if keep:
                finite.append(torch.isfinite(y).all())
                if names[i] in keep:
                    kept[names[i]] = y
        return kept, finite

    def sweep_dense(m):
        for i, (k, _n) in enumerate(shapes):
            torch.matmul(xs[m][k], dense[i])

    _reset_wo_counts()
    _reset_flash_counts()
    _reset_grouped_counts()
    outs = {(m, mode): sweep(m, mode, checked) for m in WO_PATH_MS
            for mode in WO_MODES}
    torch.cuda.synchronize()
    launches = _wo_counts()
    others = {**_flash_counts(), **_grouped_counts()}
    want = {mode: len(shapes) * len(WO_PATH_MS) for mode in WO_MODES}
    if launches != want or any(others.values()):
        raise AssertionError(f"weight_only_path: launches {launches} != "
                             f"{want}, other kernels {others}")
    checks = {}
    for (m, mode), (kept, finite) in outs.items():
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"weight_only_path m{m} {mode}: non-finite")
        worst = [0.0, 0.0]
        for nm, y in kept.items():
            i = index[nm]
            k = shapes[i][0]
            q, s = quant[mode][i]
            err, need = _wo_check(f"weight_only_path m{m} {mode} {nm}", y,
                                  wo._wo_reference(xs[m][k], q, s,
                                                   mode == "int4", k, bf16))
            worst = [max(worst[0], err), max(worst[1], need)]
        checks[f"{mode}_m{m}"] = {"outputs": len(kept), "max_abs_err": worst[0],
                                  "need": worst[1]}
    del outs

    def timed(fn, reps):
        """(device ms per sweep over ``reps`` sweeps, host ms to enqueue
        one sweep onto an idle card: 225 launches stay below the launch
        queue's depth, so the host is never held back by it)."""
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, host

    sweeps = {}
    for m in WO_PATH_MS:
        reps = 20 if m <= 16 else 5
        fns = {"bf16": lambda: sweep_dense(m)}
        for mode in WO_MODES:
            fns[mode] = (lambda md: lambda: sweep(m, md))(mode)
        order = ["bf16", *WO_MODES, *reversed(WO_MODES), "bf16"]
        runs = {key: [] for key in fns}
        sweep_dense(m)                              # warm the bf16 path
        for key in order:
            runs[key].append(timed(fns[key], reps))
        for key, rs in runs.items():
            nbytes, flops = 0, 0
            for i, (k, n) in enumerate(shapes):
                w = dense[i] if key == "bf16" else quant[key][i][0]
                s_bytes = 0 if key == "bf16" else 4 * n
                nbytes += 2 * m * k + w.numel() * w.element_size() + \
                    s_bytes + 2 * m * n
                flops += 2 * m * k * n
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
            sweeps[f"{key}_m{m}"] = {
                "ms_per_sweep": min(r[0] for r in rs),
                "ms_runs": [r[0] for r in rs],
                "host_enqueue_ms": min(r[1] for r in rs),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "calls": len(shapes)}

    gi = index["0.gate"]
    k, n = shapes[gi]
    grads = {}
    for mode in WO_MODES:
        q, s = quant[mode][gi]
        for dtype in (torch.float32, bf16):
            x = torch.randn((8, k), generator=gen, device="cuda").to(dtype)
            g = torch.randn((8, n), generator=gen, device="cuda").to(dtype)
            res = []
            for dev in ("cuda", "cpu"):
                xl = x.detach().to(dev).requires_grad_(True)
                y = weight_only_linear(xl, q.to(dev), weight_scale=s.to(dev),
                                       weight_dtype=mode)
                y.backward(g.to(dev))
                res.append((y.detach().cpu(), xl.grad.cpu()))
            dn = str(dtype).replace("torch.", "")
            what = f"weight_only_path dx {mode} {dn}"
            grads[f"{mode}_{dn}"] = {
                "forward": _wo_check(what + " forward", res[0][0], res[1][0]),
                "dx": _wo_check(what, res[0][1], res[1][1])}
    peak = torch.cuda.max_memory_allocated() / 1e9
    params = sum(k * n for k, n in shapes)
    emit("weight_only_path", preset="llama2_7b", layers=L, weights=len(shapes),
         params=params, setup_and_quantize_s=setup_s, ms=list(WO_PATH_MS),
         launches=launches, checks=checks, sweeps=sweeps, dx=grads,
         peak_gb=peak)
    del dense, quant, xs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, sweeps


# -------------------------------------------------------- primitives ---

def _prim_fns():
    """kernel_primitives' functions, each a KernelFn (torch + CUDA body):
    elementwise name -> (fn, arity); reduce name -> fn; matmul epilogue
    name -> fn (None: no epilogue)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.primitives import KernelFn
    silu = "return a / (1.0f + expf(-a))"
    # max / min propagate NaN as torch.maximum / torch.minimum do (the NaN
    # operand itself, the running value's first); fmaxf / fminf drop it.
    # Written as selects after the fmaxf: the nested ternary takes 42.9 ns
    # a fold step on an H100, this 21.8 (kernel_primitives' chain floor)
    nan_last = ("float m = {}(a, b); m = b != b ? b : m; "
                "return a != a ? a : m;")
    return {
        "elementwise": {
            "silu_mul": (KernelFn(lambda a, b: F.silu(a) * b,
                                  silu + " * b;"), 2),
            "relu2": (KernelFn(lambda a: torch.clamp_min(a, 0) * 2.0,
                               "return fmaxf(a, 0.0f) * 2.0f;"), 1),
            "fma3": (KernelFn(lambda a, b, c: a * b + c,
                              "return a * b + c;"), 3)},
        "reduce": {"max": KernelFn(torch.maximum, nan_last.format("fmaxf")),
                   "min": KernelFn(torch.minimum, nan_last.format("fminf")),
                   "add": KernelFn(torch.add, "return a + b;")},
        # timed beside max on the chain-floor shape: fmaxf alone (torch.fmax,
        # which drops NaN), the step's cost without the NaN test
        "reduce_timing": {"fmax": KernelFn(torch.fmax, "return fmaxf(a, b);")},
        "matmul": {"none": None,
                   "relu2": KernelFn(lambda a: torch.clamp_min(a, 0) * 2.0,
                                     "return fmaxf(a, 0.0f) * 2.0f;"),
                   "silu": KernelFn(F.silu, silu + ";")}}


def _prim_headers():
    """(source, header) of every generated build kernel_primitives uses, for
    phase_build to start beside the other sources."""
    from paddle_tpu_torch.kernels import primitives as P
    fns = _prim_fns()
    heads = [P.generated_header("elementwise", fn, arity)
             for fn, arity in fns["elementwise"].values()]
    heads += [P.generated_header("reduce", fn)
              for kind in ("reduce", "reduce_timing")
              for fn in fns[kind].values()]
    heads += [P.generated_header("matmul", fn or P._IDENTITY)
              for fn in fns["matmul"].values()]
    return [("primitives", h) for h in heads]


def _prim_counts():
    from paddle_tpu_torch.kernels import primitives as P
    return {"elementwise": P.LAUNCHES_ELEMENTWISE,
            "reduce": P.LAUNCHES_REDUCE, "matmul": P.LAUNCHES_MATMUL,
            "reduce_vec16": P.LAUNCHES_REDUCE_VEC16}


def _reset_prim_counts():
    from paddle_tpu_torch.kernels import primitives as P
    P.LAUNCHES_ELEMENTWISE = P.LAUNCHES_REDUCE = P.LAUNCHES_MATMUL = 0
    P.LAUNCHES_REDUCE_VEC16 = 0


def _ulp(want):
    """One ulp of each element of ``want`` in its own dtype (0 for fp32)."""
    import torch
    if want.dtype == torch.float32:
        return torch.zeros_like(want)
    fi = torch.finfo(want.dtype)
    mag = want.float().abs().clamp_min(fi.tiny)
    return fi.eps * torch.exp2(torch.floor(torch.log2(mag)))


def _ew_check(what, got, want):
    """The elementwise kernel against its plain version (PRIM_EW_TOL).
    Returns (max abs error, the largest share of its limit used); raises
    past 1."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = (g - w).abs()
    lim = _ulp(want) + PRIM_EW_TOL * (w.abs() + float(w.abs().max()))
    need = float((err / lim.clamp_min(1e-38)).max())
    if need > 1:
        raise AssertionError(f"{what}: error {float(err.max())} is "
                             f"{need:.3g} x its tolerance")
    return float(err.max()), need


def _bits_equal(a, b):
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    iview = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float16: torch.int16}[a.dtype]
    return torch.equal(a.view(iview), b.view(iview))


def _ms_once(fn):
    """Milliseconds of one call after one warm-up, CUDA events (for plain
    versions that issue thousands of small ops)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _nan_cells(cols):
    """(row, column) of the NaNs of a reduce NaN case: one in the middle of
    row 3, the first column of row 5, the last of row 7, and every column of
    row 9."""
    cells = [(3, cols // 2), (5, 0), (7, cols - 1)]
    return cells + [(9, c) for c in range(cols)]


def _prim_mm_tol(out_name, k):
    """PRIM_MM_TOL for an output dtype and a sum over k terms: the fp32
    relative limit is at least 4 sqrt(k) fp32 ulps."""
    tol = dict(PRIM_MM_TOL[out_name])
    if out_name == "float32":
        tol["rel"] = max(tol["rel"], 4 * math.sqrt(k) * 2.0 ** -24)
    return tol


def _prim_matrix(gen):
    """The three generators against their plain versions: elementwise (three
    functions, arity 1/2/3, over PRIM_EW_SHAPES, fp32/bf16/fp16 and mixed
    input dtypes), reduce (max/min/add x fp32/bf16/fp16 x PRIM_RED_ROWS x
    PRIM_RED_COLS, plus, up to 4096 columns, an offset view off the 16-byte
    alignment and, for max/min, rows with NaNs; bit for bit, each case on the route
    _reduce_route names, both routes reached) and matmul (PRIM_MM_SHAPES x fp32/bf16/fp16
    x out_dtype equal or not x epilogues none/relu2/silu).  Returns the
    worst errors by generator."""
    import torch
    from paddle_tpu_torch.kernels import primitives as P
    fns = _prim_fns()
    dev = "cuda"
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    worst = {"elementwise": {"max_abs_err": 0.0, "need": 0.0, "cases": 0},
             "reduce": {"max_abs_err": 0.0, "cases": 0, "mismatches": 0},
             "matmul": {"max_abs_err": 0.0, "rel": 0.0, "need": {},
                        "cases": 0}}

    we = worst["elementwise"]
    for name, (fn, arity) in fns["elementwise"].items():
        if arity == 3:
            mixes = [(f32, bf16, f16), (bf16, f16, f32), (f16, f32, bf16)]
        else:
            mixes = [(dt,) * arity for dt in (f32, bf16, f16)]
        apply = P.elementwise_kernel(fn)
        for shape in PRIM_EW_SHAPES:
            for mix in mixes:
                ins = [torch.randn(shape, generator=gen, device=dev).to(dt)
                       for dt in mix]
                got = apply(*ins)
                want = P._elementwise_reference(fn, ins)
                err, need = _ew_check(
                    f"elementwise {name} {shape} {mix}", got, want)
                we["max_abs_err"] = max(we["max_abs_err"], err)
                we["need"] = max(we["need"], need)
                we["cases"] += 1

    wr = worst["reduce"]
    wr.update(routes={"vec16": 0, "scalar": 0}, offset_cases=0, nan_cases=0)

    def red_case(label, apply, x, want):
        """One reduce launch, bit for bit against ``want``, on the route
        _reduce_route names (by the counters)."""
        route = P._reduce_route(x)
        n0, v0 = P.LAUNCHES_REDUCE, P.LAUNCHES_REDUCE_VEC16
        got = apply(x)
        if (P.LAUNCHES_REDUCE - n0, P.LAUNCHES_REDUCE_VEC16 - v0) != \
                (1, int(route == "vec16")):
            raise AssertionError(f"reduce {label}: launches on the wrong "
                                 f"route (want {route})")
        wr["cases"] += 1
        wr["routes"][route] += 1
        if not _bits_equal(got, want):
            wr["mismatches"] += 1
            diff = (got.float() - want.float()).abs()
            raise AssertionError(f"reduce {label} ({route}): not bit for "
                                 f"bit (max abs err {float(diff.max())})")

    for name, fn in fns["reduce"].items():
        apply = P.reduce_kernel(fn, None)
        for dt in (f32, bf16, f16):
            for cols in PRIM_RED_COLS:
                x = torch.randn((max(PRIM_RED_ROWS), cols), generator=gen,
                                device=dev).to(dt)
                want = P._reduce_reference(fn, x)   # rows fold apart
                for rows in PRIM_RED_ROWS:
                    red_case(f"{name} {dt} rows {rows} cols {cols}", apply,
                             x[:rows], want[:rows])
                if cols == max(PRIM_RED_COLS):
                    del x                  # the plain fold of 32000 is slow
                    continue
                # a view that starts one element into the buffer: the
                # same shape off the 16-byte alignment
                n = PRIM_RED_OFFSET_ROWS * cols
                xo = x.view(-1)[1:1 + n].view(PRIM_RED_OFFSET_ROWS, cols)
                red_case(f"{name} {dt} offset view cols {cols}", apply, xo,
                         P._reduce_reference(fn, xo))
                wr["offset_cases"] += 1
                if name in ("max", "min"):
                    xn = x[:PRIM_RED_OFFSET_ROWS].clone()
                    for r, c in _nan_cells(cols):
                        xn[r, c] = float("nan")
                    red_case(f"{name} {dt} NaN rows cols {cols}", apply, xn,
                             P._reduce_reference(fn, xn))
                    wr["nan_cases"] += 1
                    del xn
                del x, xo
    if not all(wr["routes"].values()):
        raise AssertionError(f"reduce: a route was not reached "
                             f"{wr['routes']}")
    wm = worst["matmul"]
    for m, k, n in PRIM_MM_SHAPES:
        for dt, other in ((f32, bf16), (bf16, f32), (f16, f32)):
            x = torch.randn((m, k), generator=gen, device=dev).to(dt)
            w = (torch.randn((k, n), generator=gen, device=dev) /
                 math.sqrt(k)).to(dt)
            acc = x.float() @ w.float()
            for ename, efn in fns["matmul"].items():
                pre = acc if efn is None else efn.torch(acc)
                for odt in (dt, other):
                    got = P.matmul_kernel(epilogue=efn, out_dtype=odt)(x, w)
                    want = pre.to(odt)
                    oname = str(odt).replace("torch.", "")
                    c = _flash_check(got, want, _prim_mm_tol(oname, k))
                    label = f"matmul {m}x{k}x{n} {dt}->{odt} {ename}"
                    if not c["ok"] or got.dtype != odt:
                        raise AssertionError(f"{label}: {c}")
                    wm["max_abs_err"] = max(wm["max_abs_err"],
                                            c["max_abs_err"])
                    wm["rel"] = max(wm["rel"], c["rel"])
                    wm["need"][oname] = max(wm["need"].get(oname, 0.0),
                                            c["need"])
                    wm["cases"] += 1
            del x, w, acc, pre
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return worst


def _prim_path(gen):
    """The library's main path at llama2_7b widths, through the public
    generators: the FFN of one layer (gate and up projections, silu(gate)
    * up, the down projection) over B*T = 8192 rows of bf16, the LM head,
    the row max of the logits, the fp32 row sums of the FFN output, and the
    gate projection again with the silu fused as its epilogue.  Launch
    counts are set to 0 just before and read just after: exactly 5
    matmuls, 1 elementwise, 2 reduces.  Each output is then held against
    its plain version on the same inputs."""
    import torch
    from paddle_tpu_torch.kernels import primitives as P
    fns = _prim_fns()
    R, H, I, V = (PRIM_WIDTHS[k] for k in ("rows", "hidden", "ffn", "vocab"))
    bf16 = torch.bfloat16

    def weight(k, n):
        return (torch.randn((k, n), generator=gen, device="cuda") /
                math.sqrt(k)).to(bf16)

    x = torch.randn((R, H), generator=gen, device="cuda").to(bf16)
    wg, wu, wd, wh = weight(H, I), weight(H, I), weight(I, H), weight(H, V)
    mm = P.matmul_kernel()
    mm_silu = P.matmul_kernel(epilogue=fns["matmul"]["silu"])
    swiglu = P.elementwise_kernel(fns["elementwise"]["silu_mul"][0])
    rmax = P.reduce_kernel(fns["reduce"]["max"], -math.inf)
    radd = P.reduce_kernel(fns["reduce"]["add"], 0.0)
    torch.cuda.synchronize()
    _reset_prim_counts()
    t0 = time.perf_counter()
    gate, up = mm(x, wg), mm(x, wu)
    h = swiglu(gate, up)
    y = mm(h, wd)
    logits = mm(y, wh)
    row_max = rmax(logits)
    yf = y.float()
    row_sum = radd(yf)
    gate_act = mm_silu(x, wg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _prim_counts()
    # both reduces stage 16-byte copies: fresh tensors, 16-byte rows
    if launches != {"elementwise": 1, "reduce": 2, "matmul": 5,
                    "reduce_vec16": 2}:
        raise AssertionError(f"primitives path: launches {launches}")
    tol = PRIM_MM_TOL["bfloat16"]
    checks = {
        "gate": _flash_check(gate, (x.float() @ wg.float()).to(bf16), tol),
        "down": _flash_check(y, (h.float() @ wd.float()).to(bf16), tol),
        "logits": _flash_check(logits, (y.float() @ wh.float()).to(bf16),
                               tol),
        "gate_silu": _flash_check(gate_act, torch.nn.functional.silu(
            x.float() @ wg.float()).to(bf16), tol)}
    bad = {k: c for k, c in checks.items() if not c["ok"]}
    if bad:
        raise AssertionError(f"primitives path: {bad}")
    ew = _ew_check("primitives path silu_mul", h, P._elementwise_reference(
        fns["elementwise"]["silu_mul"][0], [gate, up]))
    if not _bits_equal(row_max, torch.amax(logits, -1)):
        raise AssertionError("primitives path: the logits' row max is not "
                             "torch.amax's")
    if not _bits_equal(row_sum, P._reduce_reference(fns["reduce"]["add"],
                                                    yf)):
        raise AssertionError("primitives path: the row sums are not the "
                             "plain fold's")
    out = {"launches": launches, "seconds": seconds,
           "checks": {k: {"rel": c["rel"], "need": c["need"],
                          "max_abs_err": c["max_abs_err"]}
                      for k, c in checks.items()},
           "silu_mul": {"max_abs_err": ew[0], "need": ew[1]},
           "logits_shape": list(logits.shape)}
    del x, wg, wu, wd, wh, gate, up, h, y, logits, yf, gate_act
    torch.cuda.empty_cache()
    return out


def _prim_timing(gen):
    """CUDA-event times at llama2_7b widths, bf16 unless named: SwiGLU
    silu(gate) * up over [8192, 11008]; the row max of the logits [8192,
    32000]; the fp32 row sum of [8192, 4096]; the gate projection [8192,
    4096] @ [4096, 11008] without and with the silu epilogue.  Each beside
    its plain version, its bound and the one PyTorch call that computes the
    same function (``torch.amax``, ``torch.matmul``) or, where there is none,
    a cost reference (``F.silu(a) * b``; ``torch.sum``, another summation
    order; ``torch.matmul`` then ``F.silu``).  Every input exceeds the 50 MB
    L2 cache."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import primitives as P
    fns = _prim_fns()
    R, H, I, V = (PRIM_WIDTHS[k] for k in ("rows", "hidden", "ffn", "vocab"))
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}

    def rec(key, shape, kernel, plain, bound, library=None, cost=None,
            iters=20, plain_once=False, **extra):
        t = {"plain": (_ms_once(plain) if plain_once else cuda_ms(plain, 3)),
             "kernel": cuda_ms(kernel, iters)}
        t["kernel2"] = cuda_ms(kernel, iters)
        if library is not None:
            t["library"] = cuda_ms(library, iters)
        if cost is not None:
            t["cost_reference"] = cuda_ms(cost, iters)
        out[key] = {"shape": shape,
                    "kernel_ms": min(t["kernel"], t["kernel2"]),
                    "kernel_ms_runs": [t["kernel"], t["kernel2"]],
                    "plain_ms": t["plain"], "bound_ms": bound[0],
                    "bound_by": bound[1], "library_ms": t.get("library"),
                    "cost_reference_ms": t.get("cost_reference"), **extra}

    # SwiGLU: 5 fp32 operations an element (negate, exp, add, divide, multiply)
    fn = fns["elementwise"]["silu_mul"][0]
    sw = P.elementwise_kernel(fn)
    a = torch.randn((R, I), generator=gen, device="cuda").to(bf16)
    b = torch.randn((R, I), generator=gen, device="cuda").to(bf16)
    y = sw(a, b)
    err = _ew_check("timed silu_mul", y, P._elementwise_reference(fn, [a, b]))
    rec("elementwise_silu_mul", f"[{R}, {I}] bf16", lambda: sw(a, b),
        lambda: P._elementwise_reference(fn, [a, b]),
        _grouped_bound_ms([a, b], y, 5 * y.numel(), f32),
        cost=lambda: F.silu(a) * b, max_abs_err=err[0],
        library_note="null: no single PyTorch call computes silu(a) * b; "
                     "cost_reference_ms is F.silu(a) * b, two calls")
    del a, b, y

    # the logits' row max: one fp32 operation an element
    fn = fns["reduce"]["max"]
    rmax = P.reduce_kernel(fn, -math.inf)
    x = torch.randn((R, V), generator=gen, device="cuda").to(bf16)
    y = rmax(x)
    if not _bits_equal(y, P._reduce_reference(fn, x)) or \
            not _bits_equal(y, torch.amax(x, -1)):
        raise AssertionError("timed reduce max: not bit for bit")
    # the chain alone: 256 rows (8 warps) of the same 32000 columns move 16
    # MB, ~5 us of bytes, so nearly all of the time is each row's chain of
    # 32000 dependent steps; the same with fmaxf alone (no NaN test)
    xc = x[:PRIM_CHAIN_ROWS]
    fmax = P.reduce_kernel(fns["reduce_timing"]["fmax"], -math.inf)
    if not _bits_equal(fmax(xc), y[:PRIM_CHAIN_ROWS]):
        raise AssertionError("chain floor: fmaxf's fold differs on finite "
                             "rows")
    chain = {"chain_floor_ms": min(cuda_ms(lambda: rmax(xc), 10)
                                   for _ in range(2)),
             "chain_floor_fmaxf_ms": min(cuda_ms(lambda: fmax(xc), 10)
                                         for _ in range(2)),
             "chain_floor_shape": f"[{PRIM_CHAIN_ROWS}, {V}] bf16"}
    rec("reduce_max", f"[{R}, {V}] bf16", lambda: rmax(x),
        lambda: P._reduce_reference(fn, x),
        _grouped_bound_ms([x], y, x.numel(), f32),
        library=lambda: torch.amax(x, -1), iters=10, plain_once=True,
        max_abs_err=0.0, library_call="torch.amax(x, -1), bit for bit",
        route=P._reduce_route(x), **chain)
    del x, y, xc

    # fp32 row sum: torch.sum sums in another order, a cost reference only
    fn = fns["reduce"]["add"]
    radd = P.reduce_kernel(fn, 0.0)
    x = torch.randn((R, H), generator=gen, device="cuda")
    y = radd(x)
    if not _bits_equal(y, P._reduce_reference(fn, x)):
        raise AssertionError("timed reduce add: not bit for bit")
    rec("reduce_add", f"[{R}, {H}] fp32", lambda: radd(x),
        lambda: P._reduce_reference(fn, x),
        _grouped_bound_ms([x], y, x.numel(), f32),
        cost=lambda: torch.sum(x, -1), iters=10, plain_once=True,
        max_abs_err=0.0,
        sum_vs_fold_max_abs_diff=float((torch.sum(x, -1) - y).abs().max()),
        library_note="null: torch.sum sums in another order; "
                     "cost_reference_ms is torch.sum(x, -1)",
        route=P._reduce_route(x))
    del x, y

    # the gate projection, without and with the silu epilogue
    x = torch.randn((R, H), generator=gen, device="cuda").to(bf16)
    w = (torch.randn((H, I), generator=gen, device="cuda") /
         math.sqrt(H)).to(bf16)
    for key, efn in (("matmul", None), ("matmul_silu", fns["matmul"]["silu"])):
        mmk = P.matmul_kernel(epilogue=efn)
        e = efn or P._IDENTITY
        y = mmk(x, w)
        c = _flash_check(y, P._matmul_reference(e, x, w, bf16),
                         PRIM_MM_TOL["bfloat16"])
        if not c["ok"]:
            raise AssertionError(f"timed {key}: {c}")
        extra = {"max_abs_err": c["max_abs_err"], "rel": c["rel"]}
        if efn is None:
            lib = torch.matmul(x, w)
            extra["library_vs_plain"] = _flash_check(
                lib, P._matmul_reference(e, x, w, bf16),
                PRIM_MM_TOL["bfloat16"])
            kw = dict(library=lambda: torch.matmul(x, w),
                      library_call="torch.matmul")
        else:
            kw = dict(cost=lambda: F.silu(torch.matmul(x, w)),
                      library_note="null: no single PyTorch call fuses the "
                                   "silu; cost_reference_ms is torch.matmul "
                                   "then F.silu")
        rec(key, f"[{R}, {H}] @ [{H}, {I}] bf16", lambda: mmk(x, w),
            lambda: P._matmul_reference(e, x, w, bf16),
            _grouped_bound_ms([x, w], y, 2 * R * H * I, bf16), iters=10,
            **kw, **extra)
    del x, w, y
    torch.cuda.empty_cache()
    return out


def phase_kernel_primitives(smi=None):
    """The primitive library's three generated kernels (elementwise, reduce,
    matmul) against their plain versions over the case matrix, then the
    library's path at llama2_7b widths with exact launch counts, then the
    times of each generator at those widths."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = _prim_matrix(gen)
    matrix_s = time.perf_counter() - t0
    path = _prim_path(gen)
    timed = _prim_timing(gen)
    emit("kernel_primitives", nvidia_smi=smi or _nvidia_smi(),
         matrix_seconds=matrix_s, worst=worst, path=path, timed=timed,
         ew_tol=PRIM_EW_TOL, mm_tol=PRIM_MM_TOL,
         seconds=time.perf_counter() - t0)
    return worst, path, timed


def main() -> int:
    from paddle_tpu_torch.models.pretrain import use_expandable_segments
    use_expandable_segments()         # before CUDA's first allocation
    name, _smi = phase_device()
    import torch
    built = phase_build()
    attn_err, attn_t = phase_kernel()
    int8_err, int8_t = phase_kernel_int8()
    gmm_err, gmm_t = phase_kernel_gmm(built)
    phase_engine_parity()
    phase_engine_parity_int8()
    phase_engine_parity_moe()
    runs = [phase_serve("serve", ["--preset", "llama2_7b"]),
            phase_serve("serve_int8", ["--preset", "llama2_7b",
                                       "--cache-dtype", "int8"]),
            phase_serve("serve_moe", ["--preset", "mixtral_8x7b",
                                      "--num-layers", "16"])]
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    decode = gmm_t[0]              # the gmm line: the decode gate/up shape
    flash_err, flash_t = phase_kernel_flash(built)
    flash_modes = phase_kernel_flash_modes(_smi)
    phase_train_parity()
    flash_launches = phase_train()
    moe_err, moe_t, moe_mix = phase_kernel_tgmm(built)
    phase_moe_train_parity()
    moe_launches = phase_train_moe()
    wo_err, wo_t = phase_kernel_wo()
    wo_launches, _wo_sweeps = phase_weight_only_path()
    prim_err, prim_path, prim_t = phase_kernel_primitives(_smi)
    # each kernel's launches on its routes: the split and tile kernels of
    # the attention source, gmm's sm90 and simt kernels
    attn_routes = {
        key: {"split": launches[f"{key}_split"],
              "tile": launches[key] - launches[f"{key}_split"]}
        for key in ("attention", "attention_int8")}
    print(json.dumps({"kernels": [
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": ATTN_SOURCE, "replaces": ATTN_REPLACES,
         "launches": launches["attention"], "max_abs_err": attn_err["out"],
         "ms": attn_t["kernel_ms"], "plain_ms": attn_t["plain_ms"],
         "bound_ms": attn_t["bound_ms"], "bound_by": attn_t["bound_by"],
         "library_ms": attn_t["library_ms"],
         "routes": attn_routes["attention"]},
        {"name": "ragged_paged_attention_int8", "route": "cuda",
         "source": ATTN_SOURCE, "replaces": ATTN_REPLACES,
         "launches": launches["attention_int8"],
         "max_abs_err": int8_err["out"],
         "ms": int8_t["kernel_ms"], "plain_ms": int8_t["plain_ms"],
         "bound_ms": int8_t["bound_ms"], "bound_by": int8_t["bound_by"],
         "library_ms": None, "routes": attn_routes["attention_int8"]},
        {"name": "grouped_matmul", "route": "cuda",
         "source": GMM_SM90_SOURCE, "replaces": GMM_REPLACES,
         "launches": launches["gmm"], "max_abs_err": gmm_err,
         "ms": decode["kernel_ms"], "plain_ms": decode["plain_ms"],
         "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
         "library_ms": decode["library_ms"],
         "routes": {"sm90": launches["gmm_sm90"],
                    "simt": launches["gmm"] - launches["gmm_sm90"]}}] + [
        {"name": f"flash_attention_{nm}", "route": "cuda",
         "source": FLASH_FWD_SOURCE if key == "fwd" else FLASH_BWD_SOURCE,
         "replaces": FLASH_REPLACES[key],
         "launches": flash_launches[key], "max_abs_err": flash_err[key],
         "ms": flash_t[key]["kernel_ms"], "plain_ms": flash_t[key]["plain_ms"],
         "bound_ms": flash_t[key]["bound_ms"],
         "bound_by": flash_t[key]["bound_by"],
         "library_ms": flash_t[key]["library_ms"]}
        for nm, key in (("fwd", "fwd"), ("bwd_dq", "dq"),
                        ("bwd_dkv", "dkv"))] + [
        {"name": f"flash_attention_{cfg}", "route": "cuda",
         "source": FLASH_FWD_SOURCE, "replaces": FLASH_REPLACES["fwd"],
         "launches": m["launches"], "max_abs_err": m["max_abs_err"],
         "ms": m["kernel_ms"], "plain_ms": m["plain_ms"],
         "bound_ms": m["bound_ms"], "bound_by": "operations",
         "library_ms": m["library_ms"]}
        for cfg, m in flash_modes.items()] + [
        {"name": nm, "route": "cuda", "source": source,
         "replaces": replaces, "launches": moe_launches[key],
         "max_abs_err": moe_err[kind], "ms": moe_mix[kind]["kernel_ms"],
         "plain_ms": moe_mix[kind]["plain_ms"],
         "bound_ms": moe_mix[kind]["bound_ms"],
         "bound_by": moe_mix[kind]["bound_by"],
         "library_ms": moe_mix[kind]["library_ms"],
         "routes": {"sm90": moe_launches[f"{key}_sm90"],
                    "simt": moe_launches[key] - moe_launches[f"{key}_sm90"]}}
        for nm, source, replaces, key, kind in (
            ("grouped_matmul_train", GMM_SM90_SOURCE, GMM_REPLACES, "gmm",
             "forward"),
            ("grouped_matmul_trans_rhs", GMM_SM90_SOURCE, GMM_REPLACES,
             "gmm_trans", "trans"),
            ("grouped_matmul_tgmm", TGMM_SOURCE, TGMM_REPLACES, "tgmm",
             "tgmm"))] + [
        {"name": f"weight_only_{mode}", "route": "cuda", "source": WO_SOURCE,
         "replaces": WO_REPLACES, "launches": wo_launches[mode],
         "max_abs_err": wo_err[mode]["max_abs_err"],
         "ms": wo_t[f"{mode}_m8"]["kernel_ms"],
         "plain_ms": wo_t[f"{mode}_m8"]["plain_ms"],
         "bound_ms": wo_t[f"{mode}_m8"]["bound_ms"],
         "bound_by": wo_t[f"{mode}_m8"]["bound_by"],
         "library_ms": wo_t[f"{mode}_m8"]["library_ms"]}
        for mode in WO_MODES] + [
        {"name": f"primitives_{kind}", "route": "cuda", "source": PRIM_SOURCE,
         "replaces": PRIM_REPLACES[kind],
         "launches": prim_path["launches"][kind],
         "max_abs_err": max(prim_err[kind]["max_abs_err"],
                            prim_t[key]["max_abs_err"]),
         "ms": prim_t[key]["kernel_ms"], "plain_ms": prim_t[key]["plain_ms"],
         "bound_ms": prim_t[key]["bound_ms"],
         "bound_by": prim_t[key]["bound_by"],
         "library_ms": prim_t[key]["library_ms"],
         **({"routes": {"vec16": prim_path["launches"]["reduce_vec16"],
                        "scalar": prim_path["launches"]["reduce"] -
                        prim_path["launches"]["reduce_vec16"]}}
            if kind == "reduce" else {})}
        for kind, key in (("elementwise", "elementwise_silu_mul"),
                          ("reduce", "reduce_max"),
                          ("matmul", "matmul"))]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(moe_parity_spread() if sys.argv[1:] == ["--moe-parity-spread"]
             else main())
