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
3. ``kernel``  — first ptxas's record of the attention's split, merge and
   sm90 prefill kernels (0 spill bytes each, or it fails); then the ragged
   paged-attention kernels (float pools) against their plain PyTorch
   version on the card over a case matrix (decode at contexts 0 to 1023,
   speculative verify at T 4, mixed prefill/decode at T 64, prefill at T
   64 and 128 over pages 8, 16 and 128, GQA groups 1/4/8, fp32 and bf16,
   ragged and page-exact contexts, idle rows, a pool dtype other than
   q's); each case's route ("split" for T x group <= 16, "sm90" for the
   other bf16 cases, "tile" for the rest) by the route counters, and each
   case repeated bit for bit; then device times (CUDA-graph replays) at
   the llama2_7b decode shape: kernel (its split count, and its eager time
   beside), plain version, ``scaled_dot_product_attention`` as a
   yardstick, and the memory-bound least time; and at the llama2_7b
   prefill chunk (B 8, T 64, context 448): the sm90 kernel, the tile
   kernel at the same shape (the "before"), the plain version, SDPA with
   an explicit boolean mask, and the bound.
4. ``kernel_int8`` — the same kernels over int8 pools (fp32 scale per
   (kv-head, page), pages 8/16/32/128, all-zero pages) against their plain
   version, routes as in ``kernel``, then times at the same decode and
   prefill shapes with an int8 pool.
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
   2-layer fp32 model (llama2_7b widths; the same over an int8 pool) and a
   1-layer one at Mixtral-8x7B widths (2 before the sequence phases)
   served by the continuous-batching engine on the card, its greedy
   tokens held against the port's full-sequence forward on the CPU
   (teacher forcing); near-ties are counted.
6b. ``engine_parity_prefix_spec`` — the prefix cache, ngram speculative
    decoding (K 4) and the pinned host spill ring (8 pages) together, on
    the same 2-layer fp32 model over a float and an int8 pool, then the
    fused lane (K 4) on the float pool: three waves of 8 requests (waves 1
    and 3 share a 256-token prefix, wave 2 another; tails of 16-96 tokens
    built from repeated motifs; 32 new tokens each; one request a wave is
    whole cached pages, so copy-on-write) over a pool of one wave's pages
    + 8, so wave 2 evicts wave 1's cached pages into the ring and wave 3
    swaps its prefix back in.  Tokens held against the CPU teacher-forced
    forward as in ``engine_parity`` (the int8 pool's near-ties as in
    ``engine_parity_int8``); the prefix, COW, eviction, spill, swap-in and
    spec counters each > 0; each step's attention launches on the route
    ``_route`` names for its T (verify steps at T 4 on "split").
6c. ``engine_parity_migration`` — session migration on the same 2-layer
    fp32 model, over a float and an int8 pool: engine A serves 8 streams
    (prompts of 280-320 tokens, 32 new tokens) and exports every session
    mid-decode (``export_all``, once each has 8 tokens); the snapshots go
    through ``to_wire`` -> JSON -> ``from_wire`` with unchanged digests;
    engine B (prefix cache on) rejects a byte-flipped snapshot with 0 pages
    installed, then imports them with ``resume=True``: the imported pages'
    bytes equal the exported ones bit for bit, B's prefix hits cover
    exactly the full pages (only the partial-page tails re-prefill), each
    resumed step's attention launches take ``_route``'s route, and the
    resumed tokens pass ``_teacher_force`` against the CPU.  Then a parked
    session whose pages the spill ring holds ships the ring's bytes (no
    swap-in) and its next turn on the importer hits them.
7. ``serve``, ``serve_int8``, ``serve_moe`` — through the launcher's
   ``build_engine`` and ``ServingServer.start_http`` with the launcher's
   geometry, 8 concurrent streamed completions each: full llama2_7b (32
   layers, bf16, random weights from a seed); the same over an int8 pool;
   Mixtral-8x7B widths cut to 16 layers, bf16.  Kernel launch counts are
   reset just before each run and read just after; decode steps take the
   attention's split route and prefill chunks its sm90 route (none the
   tile route), and every gmm launch the sm90 route.
7b. ``serve_prefix_spec`` — full llama2_7b (bf16) through the launcher
    with ``--prefix-cache --set kv_spill_pages=64 --set
    spec_decode=ngram`` and a ``--num-pages`` of one wave's pages + 8,
    three waves of 8 streamed completions of 64 tokens (waves 1 and 3
    share a 384-token prefix, wave 2 another; tails of 32-128 tokens):
    per wave tokens/s and TTFT p50/p95; the run's prefix, COW, eviction,
    spill and swap-in counters, swap-in host ms, spec steps (drafted and
    accepted tokens), plain and spec step counts, attention launches per
    route, peak memory.  Decode and verify steps on "split", every
    prefill chunk (prefix hits' mid-context chunks among them) on "sm90",
    none on "tile"; every wave-1 request after the first a prefix hit;
    wave 3 swaps pages in; attention launches = layers x (plain + verify
    steps).  Its launches join the ``kernels`` line.
7c. ``serve_migrate`` — full llama2_7b (bf16), one model shared by two
    ``ServingServer``s in one process, each with its own pool and the
    prefix cache, with the metrics, the SLO controller and the sentinel on:
    8 streamed completions on A while ``/metrics`` is scraped;
    ``/migratez/export`` of each finished session on A, one
    ``/migratez/import`` on B; 8 follow-up turns on B (8 prefix hits over
    the migrated pages), then the same turns on A, both held by
    ``_teacher_force``'s rule against the card's full-sequence forward; no
    kernel built after warm-up; ``/statusz`` on both; ``/drainz`` on A with
    4 streams in flight, which finish before A reports drained.  Tokens/s,
    TTFT p50/p95, pages moved, export / import ms, the migration books and
    the sentinel's anomalies; its attention launches join the ``kernels``
    line.
7d. ``engine_parity_router`` — the router on the card: the 2-layer fp32
    model at llama2_7b widths shared by a prefill and a decode
    ``ServingServer`` (prefix cache on both) behind a ``RouterServer`` on
    a localhost socket; 4 streams each hand off prefill -> decode (every
    handoff ``ok``); a mixed pair serves the same prompts and loses the
    first stream's replica mid-stream (the stream resumes from the
    router's journal); no kernel built after warm-up; follow-ups on the
    decode engine hit the imported pages with no sync between drains; all
    tokens pass ``_teacher_force`` against the CPU.  Its launches join the
    ``kernels`` line.
7e. ``serve_disagg`` — full llama2_7b (bf16), a prefill and a decode
    replica on one model under an in-process ``FleetSupervisor``
    (``fleet_roles=prefill=1,decode=1``), the router on a localhost
    socket: 8 streamed completions of 32 tokens (prompts of 48-144 tokens)
    over HTTP, each handed off (at least 6 of 8 ``ok``); then the same
    traffic with fresh prompts on one mixed replica.  Every attention
    launch on "split" or "sm90"; no kernel built after warm-up; the bf16
    decode engine's steps between drains make no sync; tokens held by
    ``_teacher_force`` against the card's forward.  Tokens/s, TTFT and ITL
    p50/p95 of both, handoff export / import ms, pages and wire bytes.
    Its launches join the ``kernels`` line.
7f. ``fleet_failover`` — ``python -m paddle_tpu_torch.fleet --replicas 2
    --routers 2 --preset llama2_7b --num-layers 4 --device cuda`` as
    processes (router rt0, the membership store and the trace collector in
    the launcher, router rt1 and each replica a process of its own): one
    stream through rt0, its replica killed (SIGKILL) after the first chunk;
    the stream resumes on the survivor, the supervisor restarts the
    replica; then a stream of a session rt1 owns goes to rt1, rt1's process
    is killed (SIGKILL) after the first chunk and the client retries on
    rt0, which takes the stream over from rt1's store-replicated journal;
    the supervisor restarts rt1 on its port, rt1 holds no CUDA context, and
    rt0's ``/tracez`` returns the stream's merged timeline from 2 processes
    or more (tokens held by ``_teacher_force`` against the same model in
    this process; restart seconds reported); SIGTERM drains the fleet and
    the launcher exits 0 with no process left.
7g. ``serve_routers`` — the multi-router control plane at full width:
    llama2_7b (bf16), two mixed replicas on one model with HTTP listeners,
    an in-process ``FleetSupervisor`` publishing them to a ``StoreServer``,
    routers rt0 and rt1 (a supervised ``InprocRouterHandle``) each with a
    ``RouterControlPlane`` over a ``StoreClient`` and store discovery;
    spans of every component shipped by ``StoreTransport`` to the
    supervisor's ``TraceCollector``.  8 streamed completions of 32 tokens,
    four sessions a router, four one-hop forwards; rt1 killed once its
    streams have 8 tokens, its clients reconnect to rt0.  Gates: every
    stream whole, takeovers ``resumed`` = rt1's streams in flight, the ring
    epoch rises and rt1 is restarted (2 members again), every trace with a
    router and a replica track and a critical path within its stream's wall
    time, each taken-over trace with the ``router.takeover`` marker and a
    replay-phase span, no span dropped, no kernel build after warm-up,
    attention on "split"/"sm90" only, tokens by ``_teacher_force``; then
    follow-up turns on one replica's engine with the exporter attached make
    no sync between drains, and ``Tracer.device_trace`` around 2 of its
    decode steps holds the split attention kernel's events.  Its launches
    join the ``kernels`` line.
7h. ``serve_tp`` — tensor-parallel serving on the one card: one engine
    over the shard devices ``["cuda:0", "cuda:0"]`` (tp=2) against the tp=1
    engine over the same llama2_7b widths cut to 8 layers (bf16; cut
    from 32 to keep the whole script inside 900 s) at the launcher's
    geometry, 8 streams of 64 tokens (prompts 32-512): tokens equal, the
    final hidden states of a prefill and a decode step ``torch.equal``,
    every attention launch count 2x tp=1's on every route, each shard's
    launch planned with tp=1's split count (printed); the same over an
    int8 pool; the prefix cache, the spill ring and both spec modes (K 4)
    in short waves, tokens and counters equal; a session resumed across
    degrees (2->1, 1->2, 2->2) equal to the 1->1 resume, which passes
    ``_teacher_force`` with the no-fault run, a tp=1 and a tp=2 export
    with one digest; warm tp=2 steps with no sync and no build; 8 HTTP
    streams on the tp=2 engine with tp=1's tokens and ``/statusz`` tp 2;
    then Mixtral widths at 4 layers with the experts sharded (tokens equal,
    gmm launches 2x and all on sm90, hidden-state equality reported);
    tokens/s, decode step ms and idle share at tp=1 and tp=2.  The tp=2
    runs' launches (HTTP bf16, int8, Mixtral) join the ``kernels`` line.
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
   state: a 1-layer fp32 model at llama2_7b widths, B=2, T=256, remat and
   a 4-chunk loss, first-step gradients, then 2 steps' losses and
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
    Mixtral-8x7B widths (1.71 B parameters), B=1, T=256, remat and a
    4-chunk loss; first-step gradients, then 2 steps' losses and
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
13b. ``gpt_parity`` — GPT-2 medium widths (16 heads, d 64) at 2 layers,
    fp32, B 2, S 512: one set of weights on the card (the flash kernels on
    the "mma" route) and on the CPU: logits, loss and every gradient (the
    tied head's one), held by train_parity's rules; launches one forward,
    dQ and dK/dV a layer.
13c. ``gpt2`` — GPT-2 medium at full depth (24 layers), bf16, B 8, S
    1024: 1 warm-up, then 3 timed forward + loss + backward passes, flash
    launches exactly 24 of each kernel a pass, all on "sm90"; losses and
    gradients finite; tokens/s, pass ms, MFU (6·N), peak memory; the causal
    d 64 kernels timed at this shape against SDPA and their bound.
13d. ``dit_parity`` — DiT-L/2 widths at 512 px latents (s 1024, d 64), 1
    block (2 before the sequence phases), fp32, class dropout 0: the
    trainer on the card against the CPU from one carried state (adaLN-Zero
    parameters set to random values):
    ``eps_fn``, first-step gradients, 3 ``train_step``s (PARITY_FAR_SHARE
    rule), then an 8-step DDIM sample with guidance 4.0 from one x_T;
    launches one of each kernel a block a step on "mma", the sampler two
    forwards a block a step.
13e. ``dit_train`` — through the DiT entry point's ``build_trainer``, bf16,
    full depth, 1 warm-up + 3 timed steps each: DiT-XL/2 at 256 px (s 256,
    d 72, B 32), where the reference's attention is XLA: 0 flash launches;
    DiT-L/2 at 512 px (s 1024, d 64, B 8), where it is Pallas: 24 of each
    kernel a step, all on "sm90"; then DDIM on that model (B 4, 25 steps,
    guidance 4.0): 1200 forward launches, output finite.  images/s, MFU,
    step ms, peak memory; the sampler's images/s; the full d 64 kernels
    timed at the DiT-L/2 shape against SDPA and their bound.
13f. ``moe_forms`` — Mixtral-8x7B widths at 2 layers, bf16, B 1, T 1024,
    capacity factor 1.25: one ``PretrainStep.train_step`` with the
    ``gather`` and one with the ``einsum`` dispatch, each from
    ``init_state(seed=0)``: losses finite, flash launches as for grouped,
    no grouped-matmul launch; einsum at one group against gather on layer
    0's weights (bf16, MOE_FORMS_BF16_TOL; bit for bit reported), and both
    at a capacity that drops nothing against the grouped form in fp32.
13g. ``nn_parity`` — the Paddle-API path (``paddle_tpu_torch.nn``,
    ``optimizer``, ``vision``, ``incubate.nn``) on the card against itself
    on the CPU, fp32 with TF32 off for cuBLAS and cuDNN: every layer of the
    slice forward and backward (activations, Linear, Embedding, Conv2D with
    stride, groups and dilation, BatchNorm in training with its running
    statistics and in eval, LayerNorm, the pools, Flatten,
    MultiHeadAttention, the Transformer encoder layers, the losses), one
    ``resnet50(num_classes=10)`` train step at B 2, 64 px (loss, every
    gradient, the parameters and BatchNorm statistics after
    ``Momentum.step()``), and a 2-layer ``FusedTransformerEncoderLayer``
    stack at s 512, head dim 64 (one of each flash kernel a layer, on the
    "mma" route), by train_parity's rule; and one O2 fp16 ``Momentum``
    step with a ``GradScaler`` (2^16; true gradients near 2^-20, unscaled
    into float32, bit for bit a float64 unscale of the scaled gradients):
    fp16 parameters and float32 velocities by NN_PARITY_FP16_TOL, float32
    masters by NN_PARITY_MASTER_TOL.
13h. ``resnet50_train`` — ResNet-50 at full width (224 px, 1000 classes,
    NCHW, B 64, random images and labels from a seed) through the Paddle
    API's loop: forward under ``amp.auto_cast(level="O1",
    dtype="bfloat16")``, ``backward``, ``Momentum(0.1, 0.9, weight_decay
    1e-4)`` under ``CosineAnnealingDecay``; 2 warm-up steps, then 14 timed
    steps with no sync and no build; the loss finite and falling; ms a
    step, images/s, MFU (3 x 4.1 GFLOP an image), peak memory, one profiled
    step's busy and idle share and top kernels.
13i. ``encoder_train`` — 12 ``FusedTransformerEncoderLayer``s at
    ERNIE-3.0-base widths (768, 12 heads of 64, FFN 3072, gelu, dropout
    0.1, attention dropout 0) between ``Embedding(40000, 768)`` and
    ``Linear(768, 40000)`` with ``cross_entropy``, s 512, B 16, under
    ``amp.decorate(level="O2", dtype="bfloat16")`` with ``AdamW``: 2
    warm-up steps, 8 timed steps with no sync and no build, each launching
    the flash forward, dQ and dK/dV 12 times on "sm90" (counted from 0);
    ms a step, tokens/s, the flash kernels' share of one profiled step's
    busy time; then the kernels at this shape (b 16, s 512, 12 heads, d
    64, full, bf16) against their plain versions, timed beside their bound
    and SDPA.
13j. ``hapi_fit`` — ``paddle.Model.fit`` at full width, fp32, from
    ``DataLoader``s with 4 fork workers over the shared-memory ring: (a)
    ResNet-50 (224 px, 1000 classes, B 64) on synthetic 256 px images
    cropped, flipped and normalized in the workers, a seeded
    ``RandomSampler``, ``Momentum`` under ``CosineAnnealingDecay`` with the
    ``LRScheduler`` callback, ``Accuracy(topk=(1, 5))``; ``fit(eval_data,
    epochs=1, save_dir)``: 2 warm-up and 12 timed steps, then
    ``evaluate`` and ``predict`` over 2 batches each, ``Model.save`` and
    ``load`` into a fresh model (bit for bit; ``predict_batch`` within
    HAPI_PREDICT_TOL); (b) an ERNIE-3.0-base-width sentence classifier (the
    ``encoder_train`` stack, a mean pool, ``Linear(768, 2)``; s 512, B 16)
    through the same loop, its flash launches counted from 0 (12 forward,
    dQ and dK/dV a training step on "mma", 12 forwards an evaluated or
    predicted batch), then each kernel against its plain version at that
    shape (b 16, s 512, 12 heads, d 64, full, fp32) by FLASH_TOL.  Each:
    losses finite, every loader iteration served
    by the fork ring with 4 distinct worker pids, every timed step exactly
    1 + len(metrics) marked syncs and 0 builds under
    ``set_sync_debug_mode("error")``; ms a step, images or tokens/s, the
    loader-wait share, ``os.cpu_count()``, peak memory, one profiled
    ``train_batch``'s busy and idle share.
13k. ``incubate_paths`` — the Paddle-API entries that reach the kernels,
    at full width, one line a part: (a) a Llama-2-7B-width decode loop (4
    layers, bf16, B 8, contexts spread up to 512, page 16) written with
    ``incubate.nn.functional`` (``fused_rms_norm``, ``fused_linear``,
    ``fused_rotary_position_embedding`` with ``position_ids``, the K/V
    write into the pool, ``decode_attention`` over int64 block tables,
    ``swiglu``): one warm and 8 timed steps, every ``decode_attention``
    launch on the paged kernel's "split" route (counted from 0), each
    warm-step call against the plain version and layer 0's against
    ``masked_multihead_attention`` over the same keys in a dense cache (by
    TOL), 0 builds and 0 syncs in the timed steps under
    ``set_sync_debug_mode("error")``, ms a step and one profiled step's
    idle share; (b) ``nn.functional.flashmask_attention`` forward and
    backward at b 4, s 2048, 32 heads, d 128, bf16, causal, document-style
    ``startend_row_indices``: 1 launch of each flash kernel on "sm90", out
    and dQ/dK/dV bit for bit ``flash_attention(attn_mask=<the same mask>,
    causal=True)``, each kernel against its plain version by
    FLASH_TOL["bfloat16"], times; then rows with no live key, recorded
    against the plain version, the mean of V over all keys and over keys
    up to the row; (c) ``fused_moe`` at Mixtral-8x7B width (E 8, top 2,
    H 4096, I 14336, bf16, 512 tokens) against a per-token routed fp32
    oracle by FUSED_MOE_TOL; (d) ``MoELayer`` training (``GShardGate`` top
    2, 8 experts ``Linear(4096, 14336)``, GELU, ``Linear(14336, 4096)``,
    fp32, 4096 tokens, 2 ``AdamW`` steps): losses finite, every parameter
    a finite gradient, the two dispatch forms within MOE_LAYER_FORMS_TOL;
    (e) ``llm_int8_linear`` (outlier columns) and ``fp8_linear`` at [8,
    4096] @ [4096, 11008] against the same calls on a CPU copy
    (INCUBATE_QUANT_TOL), ``fp8_quantize`` overflowing a given scale (NaN
    and bytes equal the CPU's), ``PTQ`` on a width-4096 two-``Linear`` MLP
    within PTQ_REL_LIMIT.
    The flash rows of the ``kernels`` line count the launches of ``train``,
    ``gpt2``, ``dit_train`` (its sampler too), ``moe_forms``,
    ``encoder_train``, ``hapi_fit`` and ``incubate_paths``; the
    ``ragged_paged_attention`` row counts ``incubate_paths``' decode
    launches beside the serve phases'.
13l. ``nn_seq_parity`` — the sequence half of ``nn`` on the card
    against the port on the CPU, fp32 with TF32 off, by train_parity's
    rule at NN_PARITY_TOL: every deterministic function of the slice (the
    losses, ``ctc_loss`` and ``rnnt_loss`` among them, the sequence
    utilities, the activations) and every layer (the cells, ``RNN``,
    ``BiRNN``, a bidirectional 2-layer LSTM and a 2-layer GRU with
    ``sequence_length``, the Transformer decoder, the loss layers, the
    containers), outputs and input and parameter gradients; ``nn.utils``;
    one Adam step of a 2+2-layer seq2seq Transformer; the random draws by
    shape, support and moments.  No Pallas kernel is on this path.
13m. ``seq_models`` — the sequence half at full published width: (a) the
    Transformer base (``nn.Transformer()``'s defaults, 37000-token shared
    vocabulary, B 16 x 256 + 256 tokens, O1 bf16, label smoothing 0.1,
    ``Adam(0.9, 0.98, 1e-9)`` under ``NoamDecay(512, 4000)``), (b) the
    PTB-large LSTM LM (2 x 1500, 35 steps x batch 20, fp32, ``SGD(1.0)``,
    global-norm clip 10): each the first step's loss of two sequences on
    the card against the CPU (fp32, TF32 off, dropout off), then warm steps
    with 0 builds and 0 syncs, ms a step, tokens/s, busy and idle share,
    launches a step; (c) ``BeamSearchDecoder`` + ``dynamic_decode`` over
    (b)'s cells at beam 4, batch 8, 32 steps: ids, scores and lengths equal
    the CPU's but where a near-tie (NEAR_TIE_REL) excuses a row; ms a step
    and marked syncs a step.
13n. ``nn_spatial_parity`` — the spatial half of ``nn`` on the card
    against the port on the CPU, fp32 with TF32 off for cuBLAS and cuDNN,
    by train_parity's rule at NN_PARITY_TOL: 88 function cases (the 1-D,
    2-D, 3-D and transposed convolutions over every padding form,
    channels-last layout, stride, dilation and ``output_size``; every pool,
    ``return_mask`` through ``max_unpool``; the image norms; ``pad`` in
    every mode; ``interpolate`` in every mode up and down; ``grid_sample``'s
    three padding modes) and the 43 layers, outputs and input and
    parameter gradients, pool indices equal; beside it, torch's own
    channels-last ``avg_pool2d`` backward against a contiguous input's
    (``_channels_last_avg_pool_probe``).  No Pallas kernel is on this path.
13o. ``spatial_models`` — the spatial half at full published width, each
    under ``amp.auto_cast(level="O1", dtype="bfloat16")`` with Adam: (a)
    DDPM's CIFAR-10 U-Net (35.7M parameters, B 128 at 32 px, epsilon MSE
    over timesteps and noise drawn on the card each step), (b) the 3D
    U-Net (19,069,955 parameters, one 3 x 132 x 132 x 116 tile to 44 x 44
    x 28 voxels of 3 classes): the first step's loss against the CPU's in
    fp32 with TF32 off (DDPM at B 2, the 3D U-Net on a 92^3 tile), then
    warm steps with 0 builds and 0 syncs; ms a step, samples/s, busy and
    idle share, launches a step, busy ms by op family, peak memory.
13p. ``ops_parity`` — every op of the port's ``ops`` (the table of
    ``ops/_generated.py``, the math, creation, search, shape, gather and
    scatter, linalg, random, extras and compat ops), the ``Tensor`` method
    table, the operator dunders and the ``op_`` family on the card against
    the port on the CPU, fp32 with TF32 off: floats by train_parity's rule
    at NN_PARITY_TOL, integer, bool and index results exactly,
    decompositions by reconstruction, random ops by support and moments,
    each ``op_`` returning its input with its op's value; the worst case
    and its name.  No Pallas kernel is on this path.
13q. ``tensor_paths`` — (a) the Transformer base (SEQ_MODELS' widths, O1
    bf16, Adam over NoamDecay) trained twice, interleaved, from the same
    parameters and generator state: on a batch made by ``to_tensor`` and on
    the same batch as plain tensors; a bit-for-bit equal first-step loss,
    equal launches a step, 0 builds and 0 syncs in the timed steps; ms a
    step each, idle share, ``Tensor.__torch_function__`` entries a step;
    (b) the tensor's card-side surface (``place``, ``cpu()`` / ``cuda()``,
    ``numpy()`` one marked sync, ``astype``, ``stop_gradient``,
    ``set_value``, the ``shape`` / ``size`` idioms, one marked sync each
    for ``unique``, ``nonzero``, ``masked_select``, ``bincount``,
    ``histogram`` and a mask read).
13r. ``optim_parity`` — the optimizers and the rest of the framework core
    on the card against the port on the CPU, fp32 with TF32 off, at small
    shapes: all 15 optimizers 8 steps each (parameters and every
    accumulator), the L1 / L2 regularizers, ``LookAhead`` and
    ``ModelAverage``; ``Embedding(sparse=True)`` under SGD, lazy and exact
    Adam and AdamW with a global-norm clip (the gradient row-sparse each
    step; the rows the last step moved against the rows it touched:
    equal for the lazy rules); LBFGS (Armijo, strong Wolfe): losses and
    closure calls; ``jacobian``, ``hessian``, ``jvp``, ``vjp``;
    ``check_numerics``' counts; ``collect_operator_stats`` at fp32 and bf16
    (equal counts); ``Stream`` / ``Event`` timing against
    ``torch.cuda.Event``'s (EVENT_MS_TOL) and the memory counters against
    ``torch.cuda``'s (equal).  Each case's worst error within
    OPTIM_PARITY_TOL.  No Pallas kernel is on this path.
13s. ``optim_models`` — the slice's optimizers at full width
    (OPTIM_MODELS), each model trained on one repeated batch: (a)
    ResNet-50 (224 px, B 64, O1 bf16) under ``Lars``; (b) the
    ERNIE-3.0-base encoder (12 x 768, s 512, B 16) under ``Lamb`` at O2
    bf16 with float32 masters; (c) the PTB-large LSTM LM with
    ``Embedding(sparse=True)`` under ``SGD(1.0)`` + global-norm clip 10 and
    under ``Adam(lazy_mode=True)``, its embedding's rows moved in one step
    equal to the rows touched (none outside).  Warm-up, then timed steps
    with 0 builds and 0 syncs; losses finite and falling; ms a step,
    images or tokens/s, busy / idle share, peak memory, beside the same
    model's figures under its old optimizer in this run.
14. ``kernel_wo`` — ptxas's record of the 21 kernels of
    ``weight_only_sm90.cu`` (0 spill bytes each, or it fails); then the
    weight-only W8A16/W4A16 kernels against their plain version: int8 and
    int4, x in fp32/bf16/fp16, m 1/7/8/16/20/64/100/512 (every narrow row
    tile and the wide form), (k, n) from (64, 64), (96, 200) and (200, 176)
    up to every llama2_7b projection, with an odd int4 k (4095); each case's
    route by the counters (``kernels/weight_only.py:_route``: "narrow",
    "wide", "fma", "legacy"; every route reached in each mode); each weight
    with an all-zero column (output exactly 0); a [2, 3, 7, k] input
    through ``weight_only_linear`` with and without a bias; the empty batch;
    extreme codes at m 8 and 100; then, at llama2_7b's gate/up shape (k
    4096, n 11008, bf16) for m 8 and 512, a bitwise repeat on the route
    ``wo_plan`` names and device times by CUDA-graph replays: kernel, the
    library call (``torch._weight_int8pack_mm`` for int8,
    ``torch._weight_int4pack_mm`` for int4, each held against the plain
    version with its scale in bf16) and ``torch.matmul`` over the bf16
    weight, beside the plain version and the bound.
15. ``weight_only_path`` — all 225 projections of llama2_7b (32 layers, not
    cut, and the LM head; random bf16 weights from a seed) quantized on the
    card, int8 and int4, then ``weight_only_linear`` over all of them for
    m 8 and 512: launches counted from 0 over each untimed sweep per (m,
    mode), exactly 225 of its mode, all on the route of its m ("narrow" at
    8, "wide" at 512); layer 0's and the head's outputs against the plain
    version; ms per sweep (and the host's enqueue ms) against the bytes
    bound and against the same sweep through ``torch.matmul`` in bf16; peak
    memory; ``dx`` on the card against the CPU.
16. ``kernel_primitives`` — the primitive library's generated kernels
    (``kernels/primitives.py``: each caller's function compiled into
    ``csrc/primitives.cu``) against their plain versions: elementwise
    ``silu(a) * b``, ``max(a, 0) * 2`` and ``a * b + c`` (mixed
    fp32/bf16/fp16 inputs) over 1, 37 x 19, 8 x 1024 and 1,000,003
    elements, within one ulp of the output + 1e-6 x (|want| + max |want|),
    each case on the "vec16" route and again, bit for bit, on the "scalar"
    route (the same values in views one element into their buffers);
    reduce max/min/add, fp32/bf16/fp16, rows 1/100/8192, columns
    1/19/300/4096/32000 and, up to 4096 columns, an offset view off the
    16-byte alignment and for max/min rows with NaNs (the functors
    propagate NaN as torch.maximum does), bit for bit, each on the route ``_reduce_route`` names and both
    routes reached; matmul (1, 1, 1) up to llama2_7b's
    gate and down projections, fp32/bf16/fp16 in, the output in x's dtype
    and another, epilogues none/relu*2/silu, by PRIM_MM_TOL.  Then the
    library's path at llama2_7b widths (an FFN over 8192 rows, the LM head,
    the logits' row max, fp32 row sums, the gate with its silu fused), its
    launches counted from 0: 5 matmuls, 1 elementwise, 2 reduces (the
    elementwise and both reduces on the "vec16" route, the 5 matmuls on
    the "sm90" route); then CUDA-event times of SwiGLU [8192, 11008] (on
    both routes, bit for bit), row max [8192, 32000] (and its chain
    alone, ``chain_floor_ms``: the same kernel on 256 rows, with the
    NaN-propagating max and with ``fmaxf`` alone), fp32 row sum [8192,
    4096], the gate projection with and without the silu epilogue, the down
    projection [8192, 11008] @ [11008, 4096] and the LM head [8192, 4096]
    @ [4096, 32000] (each matmul on "sm90" and bit for bit the same in two
    runs), beside the plain versions, the bounds and ``torch.amax`` /
    ``torch.matmul`` (cost references where no one call computes the same
    function).  First ptxas's record of the sm90 matmul kernels of every
    generated matmul build and of the "vec16" elementwise kernel of every
    generated elementwise build: 0 spill bytes, or it fails.  The matrix checks
    each matmul's route by the counters (``_matmul_route``: "sm90", "mma",
    "fma"; every route reached).
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
import contextlib
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
ATTN_SM90_SOURCE = \
    "paddle_tpu_torch/kernels/csrc/ragged_paged_attention_sm90.cu"
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
# 1 layer and 2 steps (2 and 3 before the sequence phases, cut for the
# script's time)
PARITY = dict(preset="llama2_7b", layers=1, batch=2, seq=256, steps=2)
# share of parameters further apart than 1e-6 after the parity steps:
# 8.4e-5 measured on an H100 80GB HBM3 at 2 layers and 3 steps, with 6x
# room (a step fewer moves fewer parameters apart)
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
# 2 steps (3 before the Paddle-API phases) and batch 1 (2 before the
# optimizer phases), each cut for the script's time (its CPU side is the
# script's longest phase): the far share below was set from 3 steps at
# batch 2, and fewer steps and tokens move fewer parameters apart
MOE_PARITY = dict(preset="mixtral_8x7b", layers=1, batch=1, seq=256, steps=2)
# share of moe_train_parity's parameters further apart than 1e-6, set from
# `python3 chip_smoke.py --moe-parity-spread` on an H100 80GB HBM3 at 3
# steps: fp32 read 1.3e-4 to 3.1e-4 over seeds 0-3, TF32 on (the control
# of a lower-precision step) 0.18 and 0.25; 6x above the one, 90x below
# the other
MOE_PARITY_FAR_SHARE = 2e-3
MOE_SPREAD_SEEDS = (0, 0, 1, 2, 3)
MOE_CONTROL_SEEDS = (0, 1)
TRAIN_MOE_ARGV = ["--preset", "mixtral_8x7b", "--num-layers", "4",
                  "--batch", "4", "--seq", "2048"]
# the model families' phases: train_parity's gradient rule (each entry
# within PARITY_TOL x |want| + PARITY_TOL x the tensor's max |want|)
PARITY_TOL = 1e-4
GPT_PARITY = dict(layers=2, batch=2, seq=512)
GPT2 = dict(batch=8, seq=1024, passes=3)
# depth 1 (2 before the sequence phases, cut for the script's time)
DIT_PARITY = dict(input_size=64, depth=1, batch=2, steps=3, sample_steps=8,
                  guidance=4.0)
# DiT-XL/2 at 256 px (s 256, d 72: the reference's XLA attention) and
# DiT-L/2 at 512 px (s 1024, d 64: its Pallas flash kernels)
DIT_TRAIN = {"dit_xl_2_256": ["--preset", "dit_xl_2", "--batch", "32"],
             "dit_l_2_512": ["--preset", "dit_l_2", "--input-size", "64",
                             "--batch", "8"]}
DIT_STEPS = 3                      # timed, after one warm-up step
DIT_SAMPLE = dict(model="dit_l_2_512", batch=4, steps=25, guidance=4.0)
MOE_FORMS = dict(layers=2, batch=1, seq=1024, capacity_factor=1.25)
# the Paddle-API training path: nn_parity's sizes (fp32, card vs CPU),
# ResNet-50 at full width (4.1 GFLOP a 224 px image forward), the fused
# encoder at ERNIE-3.0-base widths
NN_PARITY = dict(resnet_batch=2, resnet_px=64, resnet_classes=10,
                 encoder_layers=2, encoder_width=128, encoder_heads=2,
                 batch=2, seq=512)
NN_PARITY_TOL = PARITY_TOL
NN_PARITY_FLOOR = 1e-5
# nn_parity's ResNet-50 step: the loss (rtol), float64 card vs CPU (the
# same arithmetic), float32 card vs CPU measured against the CPU's own
# float32 distance from float64 (_nn_parity_resnet)
RESNET50_PARITY_TOL = 1e-4
RESNET50_FP64_TOL = 1e-7
RESNET50_FP32_FACTOR = 10.0
RESNET50_TRAIN = dict(batch=64, px=224, classes=1000, warmup=2, steps=14,
                      lr=0.1, momentum=0.9, weight_decay=1e-4)
RESNET50_GFLOP = 4.1
ENCODER_TRAIN = dict(vocab=40000, width=768, heads=12, ffn=3072, layers=12,
                     batch=16, seq=512, warmup=2, steps=8, lr=1e-4)
# nn_parity's O2 fp16 step with a GradScaler: fp16 activations on the card
# and on the CPU may round an fp16 ulp (2^-11 relative) apart, and that
# reaches the fp16 gradients through a few more fp16 roundings; so the
# velocities (the unscaled gradients) and the fp16 parameters are held to
# 2^-8 of each value and of the tensor's largest (8 fp16 ulps).  The
# float32 masters move by lr x velocity (~1e-7 against values near 0.1),
# so a velocity apart by 2^-8 moves them far under one float32 ulp: they
# are held to 2^-22 of each value and of the largest (4 float32 ulps at
# the top).  The unscale itself is exact (an fp16 value times 2^-16 is a
# float32 value) and is held bit for bit.
NN_PARITY_FP16_TOL = 2.0 ** -8
NN_PARITY_MASTER_TOL = 2.0 ** -22
# hapi_fit: paddle.Model.fit over fork-worker DataLoaders, fp32 (the
# reference's Model runs no amp).  (a) ResNet-50 on synthetic 256 px uint8
# images, random-cropped to 224, flipped and normalized in the workers; (b)
# an ERNIE-3.0-base-width sentence classifier (the encoder_train stack, a
# mean pool and Linear(768, 2)) on token ids from a seed.  Each: warmup +
# steps training batches, then eval_batches through fit's evaluation and
# evaluate, predict_batches through predict
HAPI_FIT = {
    "resnet50": dict(batch=64, px=224, src_px=256, classes=1000, warmup=2,
                     steps=12, eval_batches=2, predict_batches=2, workers=4,
                     lr=0.025, momentum=0.9, weight_decay=1e-4, seed=1000),
    "ernie": dict(vocab=40000, width=768, heads=12, ffn=3072, layers=12,
                  classes=2, batch=16, seq=512, warmup=2, steps=12,
                  eval_batches=2, predict_batches=2, workers=4, lr=1e-4,
                  seed=2000),
}
# a saved and reloaded ResNet-50's predict_batch against the model it was
# saved from (the same weights, the same card): relative to max |want|
HAPI_PREDICT_TOL = 1e-5
# einsum at one group against gather, bf16: the combine rounds the k
# products once (a matmul) where gather rounds each product and their sum,
# up to about 1.5 ulps of the row's largest term: 2 bf16 ulps of the
# output's largest value, and 2 ulps of the entry
MOE_FORMS_BF16_TOL = 2 ** -7
MOE_FORMS_DROP_CF = 0.5            # a capacity factor at which entries drop
# incubate_paths: the Paddle-API entries that reach the kernels, at full
# width (Llama-2-7B, row 5m's flash shape, Mixtral-8x7B's FFN)
INCUBATE_PATHS = {
    "decode": dict(hidden=4096, heads=32, head_dim=128, ffn=11008, layers=4,
                   batch=8, min_ctx=32, max_ctx=512, page=16, steps=8,
                   eps=1e-5, seed=3000),
    "flashmask": dict(b=4, s=2048, h=32, d=128, docs=6, masked_keys=256,
                      seed=3100),
    "fused_moe": dict(E=8, k=2, H=4096, I=14336, tokens=512, seed=3200),
    "moe_layer": dict(E=8, k=2, H=4096, I=14336, tokens=4096, steps=2,
                      lr=1e-4, seed=3300),
    "quant": dict(m=8, k=4096, n=11008, outliers=6, ptq_width=4096,
                  calib=3, seed=3400),
}
# nn_seq_parity: the sequence half of nn on the card against the
# port on the CPU, fp32 with TF32 off, by train_parity's rule at
# NN_PARITY_TOL (NN_PARITY_FLOOR for gradients that are 0 but for
# rounding); small widths
NN_SEQ_PARITY = dict(seed=4000, rnn=dict(B=4, T=12, I=32, H=48),
                     ctc=dict(T=30, B=4, C=20, L=8),
                     rnnt=dict(B=3, T=12, U=6, V=16),
                     transformer=dict(vocab=40, d=32, heads=4, layers=2,
                                      ffn=64, batch=3, src=10, tgt=9,
                                      warmup_steps=4))
# a gradient entry below this is rounding noise: Adam moves it by about lr
# x sign(noise), which the two devices draw apart, so the parameters after
# nn_seq_parity's Adam step are held where the CPU's gradient is above it
NN_SEQ_NOISE = 1e-6
# seq_models: the sequence half at full published width.  (a) the
# Transformer base of Vaswani et al. 2017 (nn.Transformer's defaults) over
# a shared 37000-token vocabulary (WMT14 En-De BPE, their 5.1), label
# smoothing 0.1, Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000), O1 bf16;
# (b) Zaremba et al. 2014's "large" PTB LSTM language model (Paddle's PTB
# LM example): 2 x 1500, dropout 0.65, 35 unrolled steps at batch 20,
# SGD(1.0), global-norm clip 10, fp32; (c) beam search over (b)'s cells
SEQ_MODELS = {
    "transformer": dict(vocab=37000, d_model=512, heads=8, layers=6,
                        ffn=2048, dropout=0.1, batch=16, src=256, tgt=256,
                        smoothing=0.1, warmup_steps=4000, parity_rows=2,
                        warmup=2, steps=6, seed=4100),
    "lstm": dict(vocab=10000, hidden=1500, layers=2, dropout=0.65,
                 batch=20, unroll=35, lr=1.0, clip=10.0, parity_rows=2,
                 warmup=2, steps=6, seed=4200),
    "beam": dict(beam=4, batch=8, max_steps=32, start=0, end=1, seed=4300),
}
# nn_spatial_parity: the spatial half of nn on the card against the port on
# the CPU, fp32 with TF32 off (cuBLAS and cuDNN), by train_parity's rule at
# NN_PARITY_TOL (NN_PARITY_FLOOR for gradients that are 0 but for
# rounding); small shapes, every data_format, stride, dilation, padding
# form, output_size and resampling mode of the slice
NN_SPATIAL_PARITY = dict(seed=5000, n=2, c=4, l=19, hw=(13, 11),
                         dhw=(7, 9, 6))
# spatial_models: the spatial half at full published width, both under O1
# bf16 with Adam.  (a) DDPM's CIFAR-10 U-Net (Ho et al. 2020, App. B; the
# official diffusion repo's cifar10 config): ch 128, ch_mult (1, 2, 2, 2),
# 2 res blocks a level, attention at 16x16, dropout 0.1, GroupNorm(32),
# SiLU, epsilon-prediction MSE, T 1000, linear betas 1e-4 -> 0.02, batch
# 128 at 32 px, lr 2e-4.  (b) The 3D U-Net (Cicek et al. 2016, sec. 2): a
# 3 x 132 x 132 x 116 tile to a 44 x 44 x 28 output over 3 classes, 32 ->
# 512 channels, one tile a step (lr 1e-4, not in the paper: it trained
# with SGD; the slice's optimizer is Adam).  Parity: the first step's loss
# at batch 2 / the smallest valid tile (92^3 -> 4^3), card against CPU in
# fp32 with TF32 off
SPATIAL_MODELS = {
    "ddpm": dict(ch=128, ch_mult=(1, 2, 2, 2), num_res_blocks=2,
                 attn_res=(16,), dropout=0.1, groups=32, px=32, batch=128,
                 timesteps=1000, beta=(1e-4, 0.02), lr=2e-4, parity_batch=2,
                 warmup=2, steps=6, seed=5100),
    "unet3d": dict(in_ch=3, base=32, levels=4, classes=3,
                   tile=(132, 132, 116), parity_tile=(92, 92, 92), lr=1e-4,
                   warmup=2, steps=4, seed=5200),
}
# ops_parity: every op, method and dunder of the slice on the card against
# the port on the CPU (fp32, TF32 off); random ops by moments over ``draws``
# draws (5% of max(1, |moment|))
OPS_PARITY = dict(seed=6000, draws=200000)
# tensor_paths: (a) the Transformer base of SEQ_MODELS at its widths, once on
# a Tensor batch and once on the same batch as plain tensors; (b) the
# tensor's card-side surface
TENSOR_PATHS = {"transformer": dict(SEQ_MODELS["transformer"], warmup=2,
                                    steps=4, seed=6100)}
# optim_parity: every optimizer, LookAhead / ModelAverage, the
# regularizers, the row-sparse updates, LBFGS and the framework core on the
# card against the port on the CPU (fp32, TF32 off) at small shapes.
# OPTIM_PARITY_TOL is of the largest |value| compared: the updates are
# elementwise and agree to rounding; Lamb's and Lars' norms and the global
# norm clip sum in another order on the card
OPTIM_PARITY = dict(seed=7000, steps=8, shapes=((16, 12), (12,), (4, 4, 3)),
                    vocab=64, dim=16, ids=(4, 24), sparse_steps=4,
                    lbfgs=dict(rows=64, cols=8, outs=3, max_iter=4,
                               max_eval=10, calls=3))
OPTIM_PARITY_TOL = 1e-5
# an Event pair's elapsed time against torch.cuda.Event's on the same
# stream at the same points (both read the same CUDA clock)
EVENT_MS_TOL = dict(rel=0.05, abs=0.05)
# optim_models: this slice's optimizers on the models of resnet50_train,
# encoder_train and seq_models at their widths.  (a) LARS (You et al. 2017,
# trust coefficient 0.001, weight decay 5e-4; momentum 0.9) at lr 2.0 on
# ResNet-50, O1 bf16; (b) LAMB (You et al. 2019: beta 0.9 / 0.999, eps
# 1e-6, weight decay 0.01 off the biases and norms) at lr 2e-3 on the
# ERNIE-3.0-base encoder, O2 bf16 with float32 masters; (c) the PTB-large
# LSTM LM with Embedding(sparse=True) under SGD(1.0) + global-norm clip 10
# (its seq_models setting) and under Adam(lazy_mode=True) at lr 1e-3, fp32
OPTIM_MODELS = {
    "resnet50": dict(RESNET50_TRAIN, warmup=2, steps=8, lr=2.0,
                     lars_coeff=0.001, lars_weight_decay=5e-4, seed=7100),
    "encoder": dict(ENCODER_TRAIN, warmup=2, steps=6, lr=2e-3,
                    weight_decay=0.01, seed=7200),
    "lstm": dict(SEQ_MODELS["lstm"], warmup=2, steps=6, adam_lr=1e-3,
                 seed=7300),
}
# beam search: a step where the CPU's k-th and (k+1)-th totals lie this
# close (relative) may choose otherwise on the card
NEAR_TIE_REL = 1e-5
# fused_moe in bf16 against its per-token routed oracle in fp32: each expert
# product, the SwiGLU, the combine weights and the running sum are rounded
# to bf16 (about five roundings of 2^-9 on the way): relative Frobenius
# error and the largest error over max |oracle|
FUSED_MOE_TOL = dict(rel=1e-2, max_share=4e-2)
# MoELayer's "gather" and "einsum" forms, fp32 with TF32 off: the same
# expert products, the k terms of each token summed in another order
MOE_LAYER_FORMS_TOL = 1e-5
# quantization on the card against the same call on a CPU copy, relative to
# max |cpu|: llm_int8_linear sums int8 code products in fp32 in another
# order; fp8_linear's bf16 output may round one ulp apart
INCUBATE_QUANT_TOL = {"llm_int8_linear": 1e-5, "fp8_linear": 2 ** -7}
PTQ_REL_LIMIT = 0.1                # tests/test_ops_schema.py:182's limit
WO_SOURCE = "paddle_tpu_torch/kernels/csrc/weight_only.cu"
WO_SM90_SOURCE = "paddle_tpu_torch/kernels/csrc/weight_only_sm90.cu"
WO_REPLACES = "paddle_tpu/kernels/weight_only.py:28"
# kernel_wo's case matrix: rows m (every narrow row tile 8/16/32/64, the
# wide form above 64), and (k, n) from tiny and ragged (n off the 16-byte
# vector and odd int4 k: the "legacy" route; k and n off the sm90 tiles) up
# to every llama2_7b projection
WO_MS = (1, 7, 8, 16, 20, 64, 100, 512)
WO_KN = ((64, 64), (96, 200), (200, 176), (4095, 4096), (4096, 4096),
         (4096, 11008), (11008, 4096), (4096, 32000))
# the routes of kernels/weight_only.py:_route, each with its launch counter
WO_ROUTES = ("narrow", "wide", "fma", "legacy")
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


_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line; ``at_s`` is the seconds since the script
    started (what each phase costs of the run's time limit)."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - _T0}), flush=True)


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


# each phase's figures that a later phase prints beside its own
# (``_old_optimizer``), by phase
_PHASE_RESULTS = {}


# ------------------------------------------------------------ device ---

def _nvidia_smi(every_card=False):
    """The card's name and power limit, as ``nvidia-smi`` gives them (a
    list of every card's where ``every_card``)."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return lines if every_card else lines[0]


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


def _build_log(built, name):
    """The ptxas log of the library ``name`` (a source, or a generated
    build's library file name) in ``phase_build``'s record."""
    return (built or {}).get(name, {}).get("log", "")


def _ptxas_of(log, pattern, name):
    """ptxas's record of the kernels of a build log whose mangled names
    match ``pattern``, keyed by ``name(match)``: ``{"registers",
    "spill_stores", "spill_loads", "stack_bytes"}`` each."""
    import re
    out, key = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*" + pattern, ln)
        if m:
            key = name(m)
            out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[key].update(stack_bytes=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[key]["registers"] = int(m.group(1))
            key = None
    return out


def _no_spills(what, record, want):
    """Raises unless ``record`` (a ptxas record) has exactly ``want``
    kernels, each with 0 spill bytes."""
    if len(record) != want or any(
            r.get("spill_stores", 1) or r.get("spill_loads", 1)
            for r in record.values()):
        raise AssertionError(f"{what}: want {want} kernels without spills, "
                             f"ptxas says {record}")


def _sm90_ptxas(log):
    """ptxas's record of each kernel of the sm90 route, from its libraries'
    build logs: ``{"fwd d128": {"registers", "spill_stores", "spill_loads",
    "stack_bytes"}, "dq d128": ..., ...}`` ("... modes" for the build with
    mask, segments and dropout).  ``registers`` is the launch count; the
    consumers raise theirs with setmaxnreg."""
    return _ptxas_of(log, r"flash_(?:bwd_)?(fwd|dq|dkv)_sm90_kernelILi(\d+)"
                     r"ELb(\d)", lambda m: f"{m.group(1)} d{m.group(2)}" +
                     (" modes" if m.group(3) == "1" else ""))


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


def _attn_plan(c):
    """The launch plan (route, splits) of attention case ``c``."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    return pa.launch_plan(c["q"], c["k_cache"], c["block_tables"],
                          v_cache=c["v_cache"], k_new=c["k_new"],
                          v_new=c["v_new"])


def _attn_route_counts():
    """(all, split, sm90) attention launches so far, both pools."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    return (pa.LAUNCHES + pa.LAUNCHES_INT8,
            pa.LAUNCHES_SPLIT + pa.LAUNCHES_INT8_SPLIT,
            pa.LAUNCHES_SM90 + pa.LAUNCHES_INT8_SM90)


def _attn_ptxas(built):
    """ptxas's record of the split and merge kernels
    (``ragged_paged_attention.cu``) and the sm90 prefill kernels
    (``ragged_paged_attention_sm90.cu``), by template arguments:
    ``{"split q bf16 kv int8 d128 r16": {"registers", "spill_stores",
    "spill_loads", "stack_bytes"}, "merge q bf16 d128": ...,
    "sm90 d128 int8": ...}``."""
    ty = {"f": "fp32", "13__nv_bfloat16": "bf16", "a": "int8"}
    t = r"(f|13__nv_bfloat16|a)"
    # a pool of q's class type mangles as a substitution (S<n>_)
    rec = _ptxas_of(_build_log(built, "ragged_paged_attention"),
                    r"ragged_paged_attn_split_kernelI" + t +
                    r"(f|a|13__nv_bfloat16|S\d*_)Li(\d+)ELi(\d+)E",
                    lambda m: f"split q {ty[m.group(1)]} kv "
                    f"{ty.get(m.group(2), ty[m.group(1)])} d{m.group(3)} "
                    f"r{m.group(4)}")
    rec.update(_ptxas_of(_build_log(built, "ragged_paged_attention"),
                         r"ragged_paged_attn_merge_kernelI" + t +
                         r"Li(\d+)E",
                         lambda m: f"merge q {ty[m.group(1)]} d{m.group(2)}"))
    rec.update(_ptxas_of(_build_log(built, "ragged_paged_attention_sm90"),
                         r"ragged_paged_attn_prefill_sm90_kernel"
                         r"ILi(\d+)ELb(\d)E",
                         lambda m: f"sm90 d{m.group(1)} "
                         f"{'int8' if m.group(2) == '1' else 'bf16'}"))
    return rec


# the kernels _attn_ptxas must find: split 2 q x 3 pool dtypes x 5 (row
# bounds 1, 4, 16 at d 128; 1, 16 at d 64), merge 2 q x 2 d, sm90 2 d x 2
# pools
ATTN_PTXAS_KERNELS = 30 + 4 + 4


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
            route = _attn_plan(c)["route"]
            n0 = _attn_route_counts()
            out, lse = pa.ragged_paged_attention(*_attn_args(c), **_attn_kw(c),
                                                 with_lse=True)
            took = tuple(a - b for a, b in zip(_attn_route_counts(), n0))
            if took != (1, int(route == "split"), int(route == "sm90")):
                raise AssertionError(f"{label}: the {route} route's case "
                                     f"counted (all, split, sm90) launches "
                                     f"{took}")
            # no atomics: a second run gives the same bits
            out2, lse2 = pa.ragged_paged_attention(
                *_attn_args(c), **_attn_kw(c), with_lse=True)
            if not (_bits_equal(out, out2) and _bits_equal(lse, lse2)):
                raise AssertionError(f"{label} ({route}): two runs differ")
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
                   "T": shp["T"], "route": route, "bitwise_repeat": True}
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


def _prefill_shapes(extra):
    """The prefill cases beside ``mixed``: T 64 and 128, GQA groups 1, 4
    and 8 (kv heads 32, 8, 4 of 32), pages 8, 16, 128 and 40 (a page that
    neither divides 64 nor is divided by it), contexts from 0 to past a
    64-key tile and a page of 128, q_lens 0, 1, ragged and T."""
    p128 = dict(B=3, T=128, ctxs=[0, 200, 1000], qls=[128, 77, 1], page=16,
                d=128)
    p64 = dict(B=4, T=64, ctxs=[1, 127, 129, 500], qls=[0, 64, 33, 64],
               page=8, d=128)
    return [("prefill_T128", p128, 32, extra),
            ("prefill_T128", p128, 8, extra),
            ("prefill_T128", p128, 4, extra),
            ("prefill_page8", p64, 32, extra),
            ("prefill_page8", p64, 4, extra),
            ("prefill_page128", {**p64, "page": 128}, 8, extra),
            ("prefill_page40", {**p64, "page": 40}, 8, extra),
            ("prefill_T128_page128", {**p128, "page": 128}, 32, extra)]


def _route_tally(cases):
    """Cases per route of an attention matrix."""
    tally = {}
    for row in cases:
        tally[row["route"]] = tally.get(row["route"], 0) + 1
    return tally


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
                   "route": _attn_plan(cases[0])["route"],
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


PREFILL_TIMED = dict(B=8, T=64, qh=32, kvh=32, d=128, page=16, ctx=448)


def _tile_launch(c):
    """The tile kernel (the first prefill design) on case ``c`` through its C
    entry point, whatever the route rule says and with no counter: the
    "before" of the sm90 route at the same shape.  Returns (out, lse)."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as pa
    q = c["q"]
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = pa._kernel_fn()(*pa._entry_args(
        q, c["k_cache"], c["v_cache"], c["block_tables"], c["context_lens"],
        c["q_lens"], c["k_new"], c["v_new"], c.get("k_scale"),
        c.get("v_scale"), out, lse), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"tile kernel launch failed: CUDA error {err}")
    return out, lse


def _prefill_timing(gen, pool_dtype, library):
    """Device times at the serve phases' last llama2_7b prefill chunk
    (PREFILL_TIMED: bf16 q, B 8, T 64, 32 heads, d 128, page 16, context 448
    each): the route's kernel ("sm90"), the tile kernel at the same shape
    (``_tile_launch``, the "before") and the plain version, in turns (plain,
    kernel, tile, kernel, tile, plain), and, over a float pool when
    ``library``, ``scaled_dot_product_attention`` over the gathered context
    and the fresh rows with an explicit boolean mask (the context visible,
    the fresh block causal); each from CUDA-graph replays, each call on the
    next of several independent cases whose pools together exceed the
    50 MB L2 cache.  The kernel and the tile kernel are first held against
    the plain version on one case (TOL) and the kernel repeated bit for
    bit."""
    import torch
    from paddle_tpu_torch.kernels import paged_attention as pa
    P = PREFILL_TIMED
    B, T, qh, kvh, d, page = (P[k] for k in ("B", "T", "qh", "kvh", "d",
                                             "page"))
    ctxs = [P["ctx"]] * B
    pool_bytes = sum(ctxs) * kvh * d * 2 * \
        torch.empty((), dtype=pool_dtype).element_size()
    n_cases = -(-3 * L2_BYTES // pool_bytes)
    cases = [make_case(gen, B=B, T=T, qh=qh, kvh=kvh, d=d, page=page,
                       ctxs=ctxs, qls=[T] * B, dtype=torch.bfloat16,
                       pool_dtype=pool_dtype) for _ in range(n_cases)]
    route = _attn_plan(cases[0])["route"]
    if route != "sm90":
        raise AssertionError(f"prefill timing shape took the {route} route")
    args = [_attn_args(c) for c in cases]
    kws = [_attn_kw(c) for c in cases]
    plain_args = [(*_attn_args(c), c["q_lens"], c["k_new"], c["v_new"],
                   c.get("k_scale"), c.get("v_scale")) for c in cases]
    ref, ref_lse = pa._reference_ragged_paged_attention(*plain_args[0])
    mine, mine_lse = pa.ragged_paged_attention(*args[0], **kws[0],
                                               with_lse=True)
    again, again_lse = pa.ragged_paged_attention(*args[0], **kws[0],
                                                 with_lse=True)
    tile, tile_lse = _tile_launch(cases[0])
    torch.cuda.synchronize()
    if not (_bits_equal(mine, again) and _bits_equal(mine_lse, again_lse)):
        raise AssertionError("prefill timing: two runs of the kernel differ")
    errs = {}
    for key, (o, ls) in (("kernel", (mine, mine_lse)),
                         ("tile", (tile, tile_lse))):
        for which, got, want in (("out", o, ref), ("lse", ls, ref_lse)):
            err = (got.float() - want.float()).abs()
            rtol, atol = TOL[(which, "bfloat16")]
            if bool((err > atol + rtol * want.float().abs()).any()):
                raise AssertionError(f"prefill timing {key} {which}: max "
                                     f"err {float(err.max())}")
            errs[f"{key}_{which}_max_abs_err"] = float(err.max())

    def rotate(call):
        it = iter(range(1 << 62))
        return lambda: call(next(it) % n_cases)

    fns = {"plain": rotate(lambda i: pa._reference_ragged_paged_attention(
               *plain_args[i])),
           "kernel": rotate(lambda i: pa.ragged_paged_attention(
               *args[i], **kws[i])),
           "tile": rotate(lambda i: _tile_launch(cases[i]))}
    timing = {}
    if library:
        S = P["ctx"] + T
        mask = torch.ones((T, S), dtype=torch.bool, device="cuda")
        mask[:, P["ctx"]:] = torch.tril(mask[:, P["ctx"]:])
        sdpa_in = []
        for c in cases:
            W = -(-P["ctx"] // page)
            flat = c["block_tables"][:, :W].reshape(-1).long()
            kg = c["k_cache"][:, flat].reshape(kvh, B, W * page, d)[
                :, :, :P["ctx"]].transpose(0, 1)
            vg = c["v_cache"][:, flat].reshape(kvh, B, W * page, d)[
                :, :, :P["ctx"]].transpose(0, 1)
            sdpa_in.append((
                c["q"].transpose(1, 2).contiguous(),          # [B, qh, T, d]
                torch.cat([kg, c["k_new"].transpose(1, 2)], 2).contiguous(),
                torch.cat([vg, c["v_new"].transpose(1, 2)], 2).contiguous()))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(*sdpa_in[0], attn_mask=mask)
        torch.cuda.synchronize()
        timing["library_max_abs_err"] = float(
            (lib.transpose(1, 2).float() - mine.float()).abs().max())
        fns["library"] = rotate(lambda i: sdpa(*sdpa_in[i], attn_mask=mask))
    t = {}
    calls = 8 * n_cases
    order = ["plain", "kernel", "tile"] + (["library"] if library else []) + \
        ["kernel2", "tile2", "plain2"]
    for key in order:
        t[key] = graph_ms(fns[key.rstrip("2")],
                          n_cases if key.startswith("plain") else calls)
    b_ms, b_by = bound_ms(B, qh, kvh, d, ctxs, T, torch.bfloat16,
                          pool_dtype=pool_dtype, page=page)
    pool = str(pool_dtype).replace("torch.", "")
    timing.update({
        "shape": f"llama2_7b prefill chunk B={B} T={T} ctx={P['ctx']} bf16 "
                 f"q, {pool} pool, page {page}",
        "route": route, "rotated_cases": n_cases,
        "timed_by": "CUDA graph replays", "bitwise_repeat": True, **errs,
        "kernel_ms": min(t["kernel"], t["kernel2"]),
        "kernel_ms_runs": [t["kernel"], t["kernel2"]],
        "tile_ms": min(t["tile"], t["tile2"]),
        "tile_ms_runs": [t["tile"], t["tile2"]],
        "plain_ms": min(t["plain"], t["plain2"]),
        "plain_ms_runs": [t["plain"], t["plain2"]],
        "library_ms": t.get("library"), "bound_ms": b_ms, "bound_by": b_by})
    del cases, args, kws, plain_args
    torch.cuda.empty_cache()
    return timing


def phase_kernel(built):
    """``built``: ``phase_build``'s record (the attention sources' ptxas
    logs)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    decode = dict(B=8, T=1, ctxs=[1, 15, 16, 17, 255, 512, 1000, 1023],
                  qls=[1] * 8, page=16, d=128)
    short = dict(B=2, T=1, ctxs=[0, 1], qls=[1, 1], page=16, d=128)
    verify = dict(B=4, T=4, ctxs=[0, 1, 17, 700], qls=[4, 1, 3, 4], page=16,
                  d=128)
    mixed = dict(B=4, T=64, ctxs=[0, 16, 33, 960], qls=[64, 1, 17, 0],
                 page=16, d=128)
    ptxas = _attn_ptxas(built)
    _no_spills("attention split/merge/sm90 (empty: built before "
               "phase_build)", ptxas, ATTN_PTXAS_KERNELS)
    shapes = [("decode", decode, 32, {}), ("decode", decode, 8, {}),
              ("decode", decode, 4, {}), ("decode_ctx01", short, 32, {}),
              ("decode_ctx01", short, 8, {}), ("verify_T4", verify, 32, {}),
              ("verify_T4", verify, 8, {}), ("verify_T4", verify, 4, {}),
              ("mixed", mixed, 32, {}),
              ("mixed", mixed, 8, {}), ("mixed", mixed, 4, {}),
              ("mixed_d64_page8", {**mixed, "d": 64, "page": 8}, 8, {}),
              ("mixed_page128", {**mixed, "page": 128}, 4, {})] + \
        _prefill_shapes({})
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
    prefill = _prefill_timing(gen, torch.bfloat16, library=True)
    emit("kernel", cases=cases, max_abs_err=worst, timing=timing,
         prefill_timing=prefill, routes=_route_tally(cases),
         attention_ptxas=ptxas)
    return worst, timing, prefill


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
              ("mixed_page128", {**mixed, "page": 128}, 4, i8)] + \
        _prefill_shapes(i8)
    cases, worst = _attention_matrix(gen, shapes,
                                     (torch.float32, torch.bfloat16))
    note = ("no single PyTorch call attends over an int8 paged pool with "
            "per-page scales")
    timing = _attention_timing(gen, torch.int8, library=False)
    timing["library_note"] = note
    prefill = _prefill_timing(gen, torch.int8, library=False)
    prefill["library_note"] = note
    emit("kernel_int8", cases=cases, max_abs_err=worst, timing=timing,
         prefill_timing=prefill, routes=_route_tally(cases))
    return worst, timing, prefill


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
    return _ptxas_of(
        log, r"gmm_sm90_(wide|narrow)_kernelILi(\d+)ELb(\d)E(?:Lb(\d)E)?",
        lambda m: f"wide bn{m.group(2)} trans{m.group(3)} gather{m.group(4)}"
        if m.group(1) == "wide" else f"narrow tm{m.group(2)} trans{m.group(3)}")


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


def _teacher_force(phase, cpu, runs, *, new_tokens, tie_rel, max_tie_share,
                   memo=None):
    """Hold engine tokens against the full-sequence forward of ``cpu`` (the
    model on the CPU, fp32, plain attention and plain gmm): ``runs`` is a
    list of (request id, prompt, tokens).  A token that is not the CPU
    argmax passes only as a near-tie: a logit gap <= ``tie_rel`` x the
    row's largest |logit|, and at most ``max_tie_share`` of the tokens.
    Sequences go through the forward 8 at a time, padded on the right (the
    causal forward's logits at a position never see the padding);
    ``memo`` (sequence -> logits) spares a forward another run already
    made.  Returns (tokens checked, near-ties, their relative gaps)."""
    import torch
    memo = {} if memo is None else memo
    seqs = [tuple(p + toks[:-1]) for _rid, p, toks in runs]
    todo = list(dict.fromkeys(s for s in seqs if s not in memo))
    for i in range(0, len(todo), 8):
        batch = todo[i:i + 8]
        width = max(len(s) for s in batch)
        ids = torch.zeros((len(batch), width), dtype=torch.long)
        for j, seq in enumerate(batch):
            ids[j, :len(seq)] = torch.tensor(seq, dtype=torch.long)
        with torch.no_grad():
            logits = cpu(ids).float()
        for j, seq in enumerate(batch):
            memo[seq] = logits[j, :len(seq)]
        del logits
    near_ties, checked, gaps = 0, 0, []
    for (rid, p, toks), seq in zip(runs, seqs):
        if len(toks) != new_tokens:
            raise AssertionError(f"{phase} request {rid}: {len(toks)} "
                                 f"tokens, want {new_tokens}")
        logits = memo[seq][len(p) - 1:]
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
    return checked, near_ties, gaps


def _engine_parity(phase, cfg, prompts, *, new_tokens, cache_dtype=None,
                   tie_rel=1e-3, max_tie_share=0.0):
    """Serve ``prompts`` on the card with the continuous-batching engine
    (the steps between the first and the next drains without a sync:
    ``_steps_without_sync``), then teacher-force its tokens through the
    full-sequence forward on the CPU (``_teacher_force``)."""
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
    eng.step()                  # the first window may load a library
    sync_checked = _steps_without_sync(eng, "cuda")
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
    checked, near_ties, gaps = _teacher_force(
        phase, cpu, [(rid, p, out[rid]) for p, rid in zip(prompts, rids)],
        new_tokens=new_tokens, tie_rel=tie_rel, max_tie_share=max_tie_share)
    emit(phase, layers=L, hidden=cfg.hidden_size,
         heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
         experts=cfg.moe_num_experts, cache_dtype=cache_dtype or cfg.dtype,
         prompt_lens=[len(p) for p in prompts], new_tokens=new_tokens,
         tokens_checked=checked, near_ties=near_ties,
         near_tie_rel_gaps=gaps, tie_rel=tie_rel, engine_steps=steps,
         steps_checked_without_sync=sync_checked, kernel_launches=launches)
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
    """Mixtral widths, 1 layer (2 before the sequence phases, cut for the
    script's time), fp32; block_m 64 keeps the CPU forward's
    padded rows (and its time) small and runs the kernel at bm 64 in
    prefill beside the decode steps' bm 16."""
    import numpy as np
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = LlamaConfig.mixtral_8x7b(num_hidden_layers=1, dtype="float32",
                                   moe_block_m=64)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 48, 64, 96)]
    _engine_parity("engine_parity_moe", cfg, prompts, new_tokens=16)


# ---------------------------------- prefix cache, spec decode, spill ---

PREFIX_SPEC = dict(prefix=256, tails=(16, 96), new_tokens=32, spill=8,
                   spec_k=4, requests=8, page=16, bucket=64)
SERVE_PREFIX_SPEC = dict(prefix=384, tails=(32, 128), new_tokens=64,
                         spill=64, spec_k=4, requests=8, page=16)
PREFIX_SPEC_COUNTERS = ("prefix_hits", "prefix_tokens_saved", "cow_copies",
                        "evicted_pages", "kv_spilled_pages", "kv_swapins",
                        "spec_steps", "spec_drafted_tokens",
                        "spec_accepted_tokens", "spec_committed_tokens")


def _prefix_waves(vocab, prefix, tails, n, seed=0):
    """Three waves of ``n`` prompts: waves 1 and 3 share one ``prefix``-token
    prefix, wave 2 another.  Each prompt ends in its own tail (lengths in
    ``tails``, the same lengths in every wave): a few distinct tokens, then
    a short motif repeated, so the n-gram drafter finds matches.  Request
    0's tail is the longest; request 1's is its first 32 tokens, so request
    1's prompt is whole pages that request 0 caches (a fully cached prompt:
    copy-on-write)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = [rng.integers(1, vocab, prefix).tolist() for _ in range(2)]
    lens = [tails[1], 32] + [int(x) for x in
                             rng.integers(tails[0], tails[1] + 1, n - 2)]
    waves = []
    for w in range(3):
        wave = []
        for length in lens:
            head = rng.integers(1, vocab, 8).tolist()
            motif = rng.integers(1, vocab, int(rng.integers(3, 7))).tolist()
            wave.append(shared[w == 1] + (head + motif * length)[:length])
        wave[1] = wave[0][:prefix + 32]
        waves.append(wave)
    return waves


def _wave_pages(wave, prefix, page, new_tokens, spec_k):
    """Pool pages one wave holds at its peak: the shared prefix once, each
    request's own pages to the end of its budget (the speculative lane
    grows K tokens ahead)."""
    own = sum(-(-(len(p) + new_tokens + spec_k) // page) - prefix // page
              for p in wave)
    return prefix // page + own


def _count_steps(g):
    """Wrap the generator's device steps to count them by kind: plain
    steps by their T, speculative verify steps and fused K-steps."""
    kinds = {}
    for name in ("_step_fn", "_spec_verify_fn", "_fused_decode_fn"):
        real = getattr(g, name)

        def counted(gc, T, *args, _real=real, _name=name, **kw):
            key = f"T{T}" if _name == "_step_fn" else (
                "verify" if _name == "_spec_verify_fn" else "fused")
            kinds[key] = kinds.get(key, 0) + 1
            return _real(gc, T, *args, **kw)

        setattr(g, name, counted)
    return kinds


def _attn_counts():
    from paddle_tpu_torch.kernels import paged_attention as pa
    return {"attention": pa.LAUNCHES, "attention_int8": pa.LAUNCHES_INT8,
            "attention_split": pa.LAUNCHES_SPLIT,
            "attention_int8_split": pa.LAUNCHES_INT8_SPLIT,
            "attention_sm90": pa.LAUNCHES_SM90,
            "attention_int8_sm90": pa.LAUNCHES_INT8_SM90}


def _reset_attn_counts():
    from paddle_tpu_torch.kernels import paged_attention as pa
    pa.LAUNCHES = pa.LAUNCHES_INT8 = 0
    pa.LAUNCHES_SPLIT = pa.LAUNCHES_INT8_SPLIT = 0
    pa.LAUNCHES_SM90 = pa.LAUNCHES_INT8_SM90 = 0


def _expected_routes(cfg, kinds, k, q_dtype, kv_dtype):
    """Attention launches each route should take: one a layer a plain
    step (at its T) and a verify step (at T = k), k a layer a fused step
    (T = 1), each on the route ``paged_attention._route`` names for its
    T (the operands are aligned)."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    L = cfg.num_hidden_layers
    want = {"split": 0, "sm90": 0, "tile": 0}
    for kind, n in kinds.items():
        T, per = ((int(kind[1:]), 1) if kind.startswith("T") else
                  (k, 1) if kind == "verify" else (1, k))
        want[pa._route(T, group, q_dtype, kv_dtype, cfg.head_dim)] += \
            L * per * n
    return want


def _routes_of(counts, quantized):
    key = "attention_int8" if quantized else "attention"
    total = counts[key]
    split, sm90 = counts[f"{key}_split"], counts[f"{key}_sm90"]
    return {"split": split, "sm90": sm90, "tile": total - split - sm90}


def _prefix_spec_run(model, waves, *, num_pages, max_seq_len,
                     cache_dtype=None, spec_decode="ngram", device="cuda"):
    """Serve the waves one after another on one engine with the prefix
    cache, ``spec_decode`` and the spill ring on; launches counted from 0
    just before the first wave and read after the last.  Returns the
    per-wave tokens, the engine's stats, the step kinds and the attention
    launches."""
    import torch
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    c = PREFIX_SPEC
    eng = ContinuousBatchingEngine(
        model, max_batch=c["requests"],
        gen=GenerationConfig(max_new_tokens=c["new_tokens"]),
        max_seq_len=max_seq_len, page_size=c["page"],
        prefill_bucket=c["bucket"], num_pages=num_pages, device=device,
        cache_dtype=cache_dtype, prefix_cache=True, spec_decode=spec_decode,
        spec_k=c["spec_k"], kv_spill_pages=c["spill"])
    kinds = _count_steps(eng.g)
    _reset_attn_counts()
    outs = []
    for i, wave in enumerate(waves):
        rids = [eng.add_request(p) for p in wave]
        if i == 0:
            # wave 1 fits the pool (no eviction, no spill): its steps
            # between drains hold no sync
            eng.step()
            _steps_without_sync(eng, device)
        res = eng.run()
        outs.append([res[r] for r in rids])
    if device == "cuda":
        torch.cuda.synchronize()
    counts = _attn_counts()
    return outs, eng.stats(), kinds, counts, eng


def phase_engine_parity_prefix_spec(cfg=None, device="cuda"):
    """The prefix cache, ngram speculative decoding (K 4) and the spill
    ring (8 pages) together on the 2-layer fp32 model at llama2_7b widths,
    over a float and an int8 pool, then the fused lane (K 4) on the float
    pool: three waves of 8 requests (waves 1 and 3 share a 256-token
    prefix, wave 2 another; tails of 16-96 tokens; 32 new tokens each) over
    a pool of one wave's pages + 8, so wave 2 evicts wave 1's cached pages
    into the ring and wave 3 swaps its prefix back.  Every run's tokens are
    held against the CPU teacher-forced forward (near-ties as in
    ``engine_parity`` and ``engine_parity_int8``); the prefix, COW,
    eviction, spill, swap-in and spec counters must each be > 0 (fused:
    all but the spec accept counters, which ngram alone has); every
    attention launch takes the route ``_route`` names for its step."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    c = PREFIX_SPEC
    waves = _prefix_waves(cfg.vocab_size, c["prefix"], c["tails"],
                          c["requests"])
    num_pages = max(_wave_pages(w, c["prefix"], c["page"], c["new_tokens"],
                                c["spec_k"]) for w in waves) + 8
    max_seq_len = c["prefix"] + c["tails"][1] + c["new_tokens"] + 2 * c["page"]
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    runs = {}
    for name, dtype, mode in (("float", None, "ngram"),
                              ("int8", "int8", "ngram"),
                              ("float_fused", None, "fused")):
        outs, st, kinds, counts, eng = _prefix_spec_run(
            model, waves, num_pages=num_pages,
            max_seq_len=max_seq_len, cache_dtype=dtype, spec_decode=mode,
            device=device)
        quant = dtype == "int8"
        kv_dtype = eng.g.cache.kv_dtype
        want = _expected_routes(cfg, kinds, c["spec_k"], eng.g.params[
            "embed"].dtype, kv_dtype)
        got = _routes_of(counts, quant)
        other = counts["attention" if quant else "attention_int8"]
        if got != want or other:
            raise AssertionError(f"engine_parity_prefix_spec {name}: route "
                                 f"launches {got} != {want} ({kinds})")
        need = [k for k in PREFIX_SPEC_COUNTERS
                if mode == "ngram" or k not in ("spec_drafted_tokens",
                                                "spec_accepted_tokens")]
        low = [k for k in need if st[k] <= 0]
        if low:
            raise AssertionError(f"engine_parity_prefix_spec {name}: "
                                 f"counters {low} are 0: {st}")
        runs[name] = dict(outs=outs, stats={k: st[k] for k in
                                            PREFIX_SPEC_COUNTERS},
                          steps=kinds, routes=got,
                          pool_pages=eng.g.num_pages)
        del eng
    cpu = model.to("cpu")
    if device == "cuda":
        torch.cuda.empty_cache()
    memo = {}
    for name, r in runs.items():
        flat = [(f"w{w}r{i}", p, toks)
                for w, (wave, outs) in enumerate(zip(waves, r["outs"]))
                for i, (p, toks) in enumerate(zip(wave, outs))]
        tie = (2e-2, 0.25) if name == "int8" else (1e-3, 0.0)
        checked, near, gaps = _teacher_force(
            f"engine_parity_prefix_spec {name}", cpu, flat,
            new_tokens=c["new_tokens"], tie_rel=tie[0], max_tie_share=tie[1],
            memo=memo)
        r.update(tokens_checked=checked, near_ties=near,
                 near_tie_rel_gaps=gaps, tie_rel=tie[0])
        del r["outs"]
    emit("engine_parity_prefix_spec", layers=cfg.num_hidden_layers,
         hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
         kv_heads=cfg.num_key_value_heads, num_pages=num_pages,
         max_seq_len=max_seq_len, **{k: v for k, v in c.items()},
         prompt_lens=[[len(p) for p in w] for w in waves], runs=runs)
    del cpu, model
    gc.collect()


# ------------------------------------------------------------- serve ---

async def _client(host, port, prompt, max_tokens, first=None, headers=None,
                  send=(), mark=None):
    """One streamed completion over a socket.  Returns its status line, ids,
    TTFT, finish, seconds, the arrival time and token count of each token
    chunk (``chunks``) and the completion ids seen (``cmpl_ids``).
    ``first`` (an ``asyncio.Event``) is set at the first token chunk;
    ``headers`` (a dict) receives the response head's headers; ``send``
    holds extra request headers (name, value); ``mark`` (n, an
    ``asyncio.Event``) is set once n tokens have arrived."""
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                       "stream": True}).encode()
    t0 = time.perf_counter()
    extra = "".join(f"{k}: {v}\r\n" for k, v in send)
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                  f"{extra}Content-Length: {len(body)}\r\n\r\n").encode()
                 + body)
    await writer.drain()
    status = (await reader.readline()).decode()
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        if headers is not None:
            headers[k.strip().lower()] = v.strip()
    ids, ttft, finish, chunks, cmpl_ids = [], None, None, [], set()
    while True:
        try:
            line = await reader.readline()
        except ConnectionError:       # the server died mid-stream
            break
        if not line:
            break
        if not line.startswith(b"data: ") or line.strip() == b"data: [DONE]":
            continue
        doc = json.loads(line[len(b"data: "):])
        cmpl_ids.add(doc.get("id"))
        ch = doc["choices"][0]
        if ch["token_ids"]:
            chunks.append((time.perf_counter() - t0, len(ch["token_ids"])))
            if ttft is None:
                ttft = chunks[-1][0]
                if first is not None:
                    first.set()
        ids.extend(ch["token_ids"])
        finish = ch["finish_reason"] or finish
        if mark is not None and len(ids) >= mark[0]:
            mark[1].set()
    writer.close()
    try:
        await writer.wait_closed()
    except ConnectionError:
        pass
    return {"status": status.strip(), "ids": ids, "ttft_s": ttft,
            "finish": finish, "seconds": time.perf_counter() - t0,
            "chunks": chunks, "cmpl_ids": cmpl_ids}


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
            pa.LAUNCHES_SM90 = pa.LAUNCHES_INT8_SM90 = 0
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
                      "attention_sm90": pa.LAUNCHES_SM90,
                      "attention_int8_sm90": pa.LAUNCHES_INT8_SM90,
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
    # decode steps (T 1) take the split route, prefill chunks (bf16 q over
    # a bf16 or int8 pool) the sm90 route, none the tile route; a bf16
    # model's gmm launches all take the sm90 route
    split = routes["attention_split"] + routes["attention_int8_split"]
    sm90 = routes["attention_sm90"] + routes["attention_int8_sm90"]
    total = launches["attention"] + launches["attention_int8"]
    if not 0 < split < total or sm90 != total - split \
            or routes["gmm_sm90"] != launches["gmm"]:
        raise AssertionError(f"{phase}: route launches {routes} against "
                             f"{launches} (the tile route must take none)")
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


def phase_serve_prefix_spec(argv=None):
    """Full llama2_7b (32 layers, bf16, random weights from the seed) built
    by the launcher with ``--prefix-cache --set kv_spill_pages=64 --set
    spec_decode=ngram`` and a ``--num-pages`` of one wave's pages + 8,
    behind ``ServingServer.start_http``: three waves of 8 streamed
    completions of 64 tokens (waves 1 and 3 share a 384-token prefix, wave
    2 another; tails of 32-128 tokens), one wave after another.  Launch
    counts are set to 0 just before the first wave and read after the last.
    Gates: no attention launch on the tile route (decode and verify steps
    on split, every prefill chunk, prefix hits' mid-context chunks among
    them, on sm90); every request of wave 1 after the first is a prefix hit;
    wave 3 swaps pages in; attention launches = layers x (plain steps +
    verify steps).  Reports each wave's tokens/s and TTFT p50/p95 and the
    run's counters, swap-in host ms, steps, routes and peak memory.
    Returns the launch counts in ``phase_serve``'s form."""
    import numpy as np
    import torch
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.__main__ import (apply_flag_sets,
                                                   build_engine, build_parser)
    c = SERVE_PREFIX_SPEC
    base = argv or ["--preset", "llama2_7b"]
    args = build_parser().parse_args(base)
    from paddle_tpu_torch.models.llama import LlamaConfig
    vocab = getattr(LlamaConfig, args.preset)().vocab_size
    waves = _prefix_waves(vocab, c["prefix"], c["tails"], c["requests"],
                          seed=1)
    num_pages = max(_wave_pages(w, c["prefix"], c["page"], c["new_tokens"],
                                c["spec_k"]) for w in waves) + 8
    argv = base + ["--prefix-cache", "--set",
                   f"kv_spill_pages={c['spill']}", "--set",
                   "spec_decode=ngram", "--set", f"spec_k={c['spec_k']}",
                   "--num-pages", str(num_pages),
                   "--page-size", str(c["page"])]
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    args = build_parser().parse_args(argv)
    saved = flags.get_flags(["kv_spill_pages", "spec_decode", "spec_k"])
    try:
        apply_flag_sets(args.flag_sets)
        t0 = time.perf_counter()
        engine = build_engine(args)
    finally:
        flags.set_flags(saved)
    cfg = engine.g.config
    kinds = _count_steps(engine.g)
    srv = ServingServer(engine, model_name=args.preset, warmup=True)

    async def go():
        host, port = await srv.start_http("127.0.0.1", 0)
        try:
            while not srv.ready():
                if not srv.engine_alive():
                    raise RuntimeError("engine thread died during warmup")
                await asyncio.sleep(0.05)
            t_ready = time.perf_counter() - t0
            st0 = engine.stats()
            # the main path's run: counts from zero, read right after
            _reset_attn_counts()
            gm.LAUNCHES = gm.LAUNCHES_SM90 = 0
            kinds.clear()
            steps0, spec0 = engine.steps, engine.spec_dispatches
            per_wave, before = [], st0
            for wave in waves:
                t1 = time.perf_counter()
                res = await asyncio.gather(*[
                    _client(host, port, p, c["new_tokens"]) for p in wave])
                wall = time.perf_counter() - t1
                st = engine.stats()
                per_wave.append((res, wall, {k: st[k] - before[k] for k in
                                             PREFIX_SPEC_COUNTERS}))
                before = st
            counts = _attn_counts()
            counts["gmm"], counts["gmm_sm90"] = gm.LAUNCHES, gm.LAUNCHES_SM90
            return (per_wave, counts, engine.steps - steps0,
                    engine.spec_dispatches - spec0, t_ready, st0)
        finally:
            await srv.stop_http()

    per_wave, counts, steps, spec_steps, t_ready, st0 = asyncio.run(go())
    for w, (res, _wall, _st) in enumerate(per_wave):
        for r in res:
            if r["finish"] != "length" or len(r["ids"]) != c["new_tokens"] \
                    or not all(0 <= t < cfg.vocab_size for t in r["ids"]):
                raise AssertionError(
                    f"serve_prefix_spec wave {w + 1}: {r['status']}, finish "
                    f"{r['finish']}, {len(r['ids'])} ids")
    L = cfg.num_hidden_layers
    quant = engine.g.cache.quantized
    routes = _routes_of(counts, quant)
    total = counts["attention_int8" if quant else "attention"]
    plain = steps - spec_steps
    hits = [st["prefix_hits"] for _r, _w, st in per_wave]
    swaps = [st["kv_swapins"] for _r, _w, st in per_wave]
    fails = []
    dt = engine.g.params["embed"].dtype
    want = _expected_routes(cfg, kinds, c["spec_k"], dt,
                            engine.g.cache.kv_dtype)
    if routes != want or routes["tile"] or not routes["split"] \
            or not routes["sm90"]:
        fails.append(f"routes {routes}, want {want} (tile must take none; "
                     f"steps {kinds})")
    if hits[0] != c["requests"] - 1:
        fails.append(f"wave 1 prefix hits {hits[0]}, want "
                     f"{c['requests'] - 1}")
    if swaps[2] <= 0:
        fails.append(f"wave 3 swapped nothing in (swap-ins by wave {swaps})")
    if total != L * (plain + spec_steps) or spec_steps == 0:
        fails.append(f"attention launches {total} != {L} layers x "
                     f"({plain} plain + {spec_steps} verify steps)")
    if fails:
        raise AssertionError("serve_prefix_spec: " + "; ".join(fails))
    st = engine.stats()
    waves_out = []
    for res, wall, wst in per_wave:
        ttfts = sorted(r["ttft_s"] for r in res)
        waves_out.append(dict(
            wall_s=wall, tokens_per_s=len(res) * c["new_tokens"] / wall,
            ttft_p50_s=float(np.percentile(ttfts, 50)),
            ttft_p95_s=float(np.percentile(ttfts, 95)), counters=wst))
    emit("serve_prefix_spec", preset=args.preset, layers=L,
         hidden=cfg.hidden_size, dtype=cfg.dtype,
         kv_cache_dtype=st["kv_cache_dtype"], max_batch=args.max_batch,
         max_seq_len=args.max_seq_len, page_size=args.page_size,
         prefill_bucket=args.prefill_bucket, num_pages=engine.g.num_pages,
         pool_bytes=engine.g.pool_bytes,
         spill_ring_bytes=engine.spill.ring_bytes,
         prompt_lens=[[len(p) for p in w] for w in waves],
         new_tokens=c["new_tokens"], setup_and_warmup_s=t_ready,
         waves=waves_out,
         counters={k: st[k] - st0[k] for k in PREFIX_SPEC_COUNTERS},
         swapin_host_ms=engine.spill.swapin_host_ms,
         plain_steps=plain, spec_steps=spec_steps, step_kinds=dict(kinds),
         attention_routes=routes, kernel_launches=counts,
         max_memory_allocated=(torch.cuda.max_memory_allocated()
                               if cuda else None),
         nvidia_smi=_nvidia_smi() if cuda else None)
    del engine, srv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"attention": counts["attention"],
            "attention_int8": counts["attention_int8"], "gmm": counts["gmm"],
            "attention_split": counts["attention_split"],
            "attention_int8_split": counts["attention_int8_split"],
            "attention_sm90": counts["attention_sm90"],
            "attention_int8_sm90": counts["attention_int8_sm90"],
            "gmm_sm90": counts["gmm_sm90"]}


# --------------------------------------------------------- migration ---

MIGRATE = dict(prompts=(280, 320), requests=8, new_tokens=32,
               export_after=8, page=16, bucket=64, spill=16, spill_pages=12)
SERVE_MIGRATE = dict(prompts=(48, 144), requests=8, new_tokens=32,
                     follow=16, drain_requests=4, tie_rel=2e-2,
                     max_tie_share=0.25)
# serve_migrate's host-cost variants of wave A on server A: /metrics
# scraped every so many seconds (None: not scraped), A's flight-recorder
# ring attached (the tracer on) or detached
SERVE_MIGRATE_VARIANTS = {"scrape_100ms": (0.1, True),
                          "scrape_15s": (15.0, True),
                          "no_scrape": (None, True),
                          "no_scrape_ring_off": (None, False)}


def _planes_equal(a, b):
    """Two page planes hold the same bits (int8 codes, fp32 scales, float
    rows)."""
    import torch
    if a.dtype != b.dtype or tuple(a.shape) != tuple(b.shape):
        return False
    if a.dtype == torch.int8:
        return torch.equal(a, b)
    return _bits_equal(a.contiguous(), b.contiguous())


def _imported_bytes_equal(eng, snaps):
    """Every page a snapshot installed on ``eng`` holds the snapshot's
    bytes, bit for bit; returns the pages compared."""
    n = 0
    for snap in snaps:
        nodes = eng.prefix_cache.chain(snap["tokens"])
        if len(nodes) < len(snap["pages"]):
            raise AssertionError(f"{len(nodes)} indexed pages for a "
                                 f"snapshot of {len(snap['pages'])}")
        for node, pg in zip(nodes, snap["pages"]):
            for plane, got in zip(pg["planes"], eng.g.cache.page_planes(
                    node.page, device="cpu")):
                if not _planes_equal(got, plane):
                    raise AssertionError(
                        f"page {pg['index']} of a migrated session differs "
                        f"from the exported bytes")
                n += 1
    return n


def _flip_byte(wire_snap):
    """A copy of a wire snapshot with one byte of its first plane flipped
    (still valid base64)."""
    import base64
    bad = json.loads(json.dumps(wire_snap))
    plane = bad["pages"][0]["planes"][0]
    raw = bytearray(base64.b64decode(plane["b64"]))
    raw[len(raw) // 3] ^= 0x10
    plane["b64"] = base64.b64encode(bytes(raw)).decode("ascii")
    return bad


def _steps_without_sync(eng, device, windows=2):
    """Run ``windows`` stretches of ``sync_every - 1`` engine steps, each
    starting just after a drain (the first one at once), under
    ``assert_overhead(max_compiles=0, max_syncs=0)`` and, on the card,
    ``torch.cuda.set_sync_debug_mode("error")``: a step between drains
    that builds a kernel, marks a sync or makes any synchronizing CUDA call
    fails the phase.  Returns the steps checked."""
    import torch
    from paddle_tpu_torch import observability as obs
    cuda = device == "cuda"
    n = 0
    for _ in range(windows):
        while eng._pending:           # run on to the next drain
            eng.step()
        if not eng.has_work():
            break
        mode = torch.cuda.get_sync_debug_mode() if cuda else 0
        with obs.assert_overhead(max_compiles=0, max_syncs=0):
            if cuda:
                torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(eng.g.sync_every - 1):
                    eng.step()
                    n += 1
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(mode)
    if not n:
        raise AssertionError("no engine step was checked for syncs")
    return n


def _migrate_pool(model, cfg, prompts, dtype, device):
    """Serve ``prompts`` on engine A, export every session mid-decode, put
    the snapshots through the wire, import them on engine B (prefix cache
    on) with ``resume=True`` and run B to completion.  Returns the record
    and the (id, prompt, tokens) runs for teacher forcing."""
    import torch
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.inference import migration as mig
    c = MIGRATE
    max_seq = max(len(p) for p in prompts) + c["new_tokens"] + 2 * c["page"]
    kw = dict(max_batch=c["requests"],
              gen=GenerationConfig(max_new_tokens=c["new_tokens"]),
              max_seq_len=max_seq, page_size=c["page"],
              prefill_bucket=c["bucket"], device=device, cache_dtype=dtype)
    a = ContinuousBatchingEngine(model, **kw)
    reqs = [a.submit(p) for p in prompts]
    while min(len(r.output) for r in reqs) < c["export_after"]:
        a.step()
    t0 = time.perf_counter()
    snaps = mig.export_all(a)
    export_ms = (time.perf_counter() - t0) * 1e3
    if len(snaps) != len(prompts) or any(r.done for r in reqs):
        raise AssertionError(f"engine_parity_migration: {len(snaps)} "
                             f"sessions exported of {len(prompts)}")
    wire = json.dumps([mig.to_wire(s) for s in snaps])
    back = [mig.from_wire(s) for s in json.loads(wire)]
    if [mig.snapshot_digest(s) for s in back] != \
            [s["digest"] for s in snaps]:
        raise AssertionError("engine_parity_migration: a digest changed "
                             "through the wire")
    del a
    if device == "cuda":
        torch.cuda.empty_cache()
    b = ContinuousBatchingEngine(model, prefix_cache=True, **kw)
    alloc = b.g.cache.allocator
    free0 = alloc.free_pages
    try:
        mig.import_session(b, _flip_byte(json.loads(wire)[0]))
        rejected = False
    except mig.MigrationError:
        rejected = True
    if not rejected or alloc.free_pages != free0 or \
            b.prefix_cache.cached_pages() != 0:
        raise AssertionError("engine_parity_migration: a byte-flipped "
                             "snapshot was not rejected with 0 pages "
                             "installed")
    saved0, hits0 = alloc.prefix_tokens_saved, alloc.prefix_hits
    t0 = time.perf_counter()
    results = [mig.import_session(b, s, resume=True) for s in back]
    if device == "cuda":
        torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) * 1e3
    imported = sum(r["imported"] for r in results)
    compared = _imported_bytes_equal(b, back)
    kinds = _count_steps(b.g)
    _reset_attn_counts()
    checked_steps = _steps_without_sync(b, device)
    out = b.run()
    if device == "cuda":
        torch.cuda.synchronize()
    counts = _attn_counts()
    quant = dtype == "int8"
    kv_dtype = b.g.cache.kv_dtype
    want = _expected_routes(cfg, kinds, 1, b.g.params["embed"].dtype,
                            kv_dtype)
    got = _routes_of(counts, quant)
    saved = alloc.prefix_tokens_saved - saved0
    hits = alloc.prefix_hits - hits0
    fails = []
    if got != want or not got["split"]:
        fails.append(f"routes {got}, want {want} ({kinds})")
    if imported != sum(len(s["pages"]) for s in back) or \
            saved != imported * c["page"] or hits != len(back):
        fails.append(f"{imported} pages imported, {saved} prompt tokens "
                     f"skipped, {hits} hits: the resumed prefill must "
                     f"cover only the partial-page tails")
    if fails:
        raise AssertionError("engine_parity_migration: " + "; ".join(fails))
    runs = [(f"{dtype or 'float'}{i}", p, s["emitted"] +
             out[r["resume_req_id"]])
            for i, (p, s, r) in enumerate(zip(prompts, back, results))]
    st = b.stats()
    rec = dict(sessions=len(back), pages_imported=imported,
               pages_compared_bitwise=compared, wire_bytes=len(wire),
               export_ms=export_ms, import_ms=import_ms,
               emitted_at_export=[len(s["emitted"]) for s in back],
               prefix_hits=hits, prefix_tokens_saved=saved,
               resumed_steps=kinds, routes=got,
               steps_checked_without_sync=checked_steps,
               migration={k: v for k, v in st.items()
                          if k.startswith("migration_")})
    del b
    return rec, runs


def _migrate_spilled(model, prompts, device):
    """A parked session whose pages the spill ring holds ships the ring's
    bytes (no swap-in); the importer stores them bit for bit and its next
    turn hits them."""
    import torch
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.inference import migration as mig
    c = MIGRATE
    page = c["page"]
    parked = prompts[0][:4 * page]
    kw = dict(max_batch=2, gen=GenerationConfig(max_new_tokens=4),
              max_seq_len=8 * page, page_size=page,
              prefill_bucket=c["bucket"], device=device,
              num_pages=c["spill_pages"], prefix_cache=True,
              kv_spill_pages=c["spill"])
    src = ContinuousBatchingEngine(model, **kw)
    src.add_request(parked)
    src.run()
    for p in prompts[1:4]:                # crush the pool: parked spills
        src.add_request(p[:5 * page], max_new_tokens=8)
    src.run()
    swapins0 = src.spill.swapins
    snap = mig.export_session(src, tokens=parked)
    sources = [pg["source"] for pg in snap["pages"]]
    if src.spill.swapins != swapins0 or "spill" not in sources:
        raise AssertionError(f"engine_parity_migration spill: sources "
                             f"{sources}, swap-ins "
                             f"{src.spill.swapins - swapins0}")
    dst = ContinuousBatchingEngine(model, **kw)
    res = mig.import_session(dst, json.loads(json.dumps(mig.to_wire(snap))))
    compared = _imported_bytes_equal(dst, [snap])
    follow = parked + prompts[0][4 * page:4 * page + 5]
    rid = dst.add_request(follow, max_new_tokens=c["new_tokens"])
    out = dst.run()[rid]
    if device == "cuda":
        torch.cuda.synchronize()
    st = dst.stats()
    if st["prefix_hits"] != 1 or st["prefix_tokens_saved"] != 4 * page:
        raise AssertionError(f"engine_parity_migration spill: the next "
                             f"turn did not hit the migrated pages ({st})")
    rec = dict(sources=sources, pages_imported=res["imported"],
               pages_compared_bitwise=compared, swapins_at_export=0,
               follow_prefix_tokens_saved=st["prefix_tokens_saved"])
    del src, dst
    return rec, [("spill0", follow, out)]


def phase_engine_parity_migration(cfg=None, device="cuda"):
    """Session migration on the 2-layer fp32 model at llama2_7b widths,
    over a float and an int8 pool: engine A serves 8 streams with prompts
    of 280-320 tokens and exports every session mid-decode (``export_all``)
    once each has 8 tokens; the snapshots go through ``to_wire`` -> JSON ->
    ``from_wire`` with unchanged digests; engine B (prefix cache on)
    rejects a byte-flipped snapshot with 0 pages installed, then imports
    them with ``resume=True``: the imported pages' bytes on B equal A's
    exported bytes bit for bit, B's prefix hits cover exactly the full
    pages (prompt tokens skipped = pages x page size: only the partial-page
    tails re-prefill), each resumed step's attention launches take the
    route ``_route`` names for it, and the resumed tokens (A's before the
    export, B's after) pass ``_teacher_force`` against the CPU (near-ties
    as in ``engine_parity`` / ``engine_parity_int8``).  Then a parked
    session whose pages the spill ring holds ships the ring's bytes (no
    swap-in) and its next turn on the importer hits them."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    c = MIGRATE
    rng = np.random.default_rng(5)
    lens = np.linspace(c["prompts"][0], c["prompts"][1],
                       c["requests"]).astype(int)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    pools, runs = {}, {}
    for name, dtype in (("float", None), ("int8", "int8")):
        pools[name], runs[name] = _migrate_pool(model, cfg, prompts, dtype,
                                                device)
    pools["spill"], runs["spill"] = _migrate_spilled(model, prompts, device)
    cpu = model.to("cpu")
    if device == "cuda":
        torch.cuda.empty_cache()
    memo = {}
    for name, r in runs.items():
        tie = (2e-2, 0.25) if name == "int8" else (1e-3, 0.0)
        checked, near, gaps = _teacher_force(
            f"engine_parity_migration {name}", cpu, r,
            new_tokens=c["new_tokens"], tie_rel=tie[0], max_tie_share=tie[1],
            memo=memo)
        pools[name].update(tokens_checked=checked, near_ties=near,
                           near_tie_rel_gaps=gaps, tie_rel=tie[0])
    emit("engine_parity_migration", layers=cfg.num_hidden_layers,
         hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
         kv_heads=cfg.num_key_value_heads, prompt_lens=[int(n) for n in lens],
         **{k: v for k, v in c.items() if k != "prompts"}, pools=pools)
    del cpu, model
    gc.collect()


async def _http_call(host, port, method, path, body=b""):
    """One request over a socket; returns (status, body bytes)."""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload


def phase_serve_migrate(argv=None):
    """Full llama2_7b (32 layers, bf16, random weights from the seed), one
    model shared by two ``ServingServer``s in one process, each with its
    own pool (the launcher's geometry and ``--prefix-cache``) and with the
    metrics, the SLO controller and the sentinel on (server A with the
    flight recorder): 8 streamed completions of 32 tokens on A (prompts of
    48-144 tokens) while ``/metrics`` is scraped; ``/migratez/export`` of
    each finished session on A and one ``/migratez/import`` of all of them
    on B; 8 follow-up turns (each session's tokens + 16 new) on B, then the
    same turns on A.  Gates: every stream finishes with its budget, B's
    follow-ups are 8 prefix hits over at least the migrated pages, the
    follow-up tokens of both servers pass ``_teacher_force`` against the
    card's full-sequence forward (near-ties within SERVE_MIGRATE's
    tie_rel and share), no kernel is built after warm-up, every attention
    launch takes the split (decode) or sm90 (prefill) route; then
    ``/statusz`` on both servers, and ``/drainz`` on A with 4 streams in
    flight: each finishes with its budget, a new completion is refused and
    A reports drained.  Before wave 1, the same traffic with fresh prompts
    runs on A under each of ``SERVE_MIGRATE_VARIANTS`` (scrape interval,
    flight-recorder ring on or off), twice each, to take wave 1's host cost
    apart.  Launch counts are set to 0 just before A's first wave and read
    after the drain.  Returns them in ``phase_serve``'s
    form.  ``argv`` (launcher options) replaces ``--preset llama2_7b``."""
    import numpy as np
    import torch
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.__main__ import build_parser, engine_kwargs
    c = SERVE_MIGRATE
    args = build_parser().parse_args(
        (argv or ["--preset", "llama2_7b"]) + ["--prefix-cache"])
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = getattr(LlamaConfig, args.preset)()
    model = LlamaForCausalLM(cfg, device=args.device, seed=args.seed)
    engines = [ContinuousBatchingEngine(model, **engine_kwargs(args))
               for _ in range(2)]
    # the phase reads its own traffic: the SLO and the sentinel see the
    # serving series from zero
    obs.reset("serving.")
    fr = obs.FlightRecorder(path="flight_record_serve_migrate.json")
    servers = [ServingServer(engines[0], model_name=args.preset,
                             warmup=True, flight_recorder=fr),
               ServingServer(engines[1], model_name=args.preset,
                             warmup=True, flight_recorder=False)]
    rng = np.random.default_rng(7)
    lens = np.linspace(c["prompts"][0], c["prompts"][1],
                       c["requests"]).astype(int)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    extra = [rng.integers(1, cfg.vocab_size, c["follow"]).tolist()
             for _ in prompts]

    async def wave(addr, turns):
        t1 = time.perf_counter()
        res = await asyncio.gather(*[_client(*addr, p, c["new_tokens"])
                                     for p in turns])
        wall = time.perf_counter() - t1
        for r in res:
            if r["finish"] != "length" or len(r["ids"]) != c["new_tokens"] \
                    or not all(0 <= t < cfg.vocab_size for t in r["ids"]):
                raise AssertionError(f"serve_migrate: {r['status']}, finish "
                                     f"{r['finish']}, {len(r['ids'])} ids")
        ttfts = sorted(r["ttft_s"] for r in res)
        return res, dict(wall_s=wall,
                         tokens_per_s=len(res) * c["new_tokens"] / wall,
                         ttft_p50_s=float(np.percentile(ttfts, 50)),
                         ttft_p95_s=float(np.percentile(ttfts, 95)))

    async def go():
        addrs = [await s.start_http("127.0.0.1", 0) for s in servers]
        try:
            while not all(s.ready() for s in servers):
                if not all(s.engine_alive() for s in servers):
                    raise RuntimeError("engine thread died during warmup")
                await asyncio.sleep(0.05)
            t_ready = time.perf_counter() - t0

            async def scrape(interval, into):
                while True:
                    into.append(await _http_call(*addrs[0], "GET",
                                                 "/metrics"))
                    await asyncio.sleep(interval)

            # wave A's host cost taken apart: the same traffic (fresh
            # prompts of wave 1's lengths) on A under each variant, twice
            # each, in turn and then in reverse
            variants = {k: [] for k in SERVE_MIGRATE_VARIANTS}
            vrng = np.random.default_rng(11)
            for name in list(variants) + list(variants)[::-1]:
                interval, ring = SERVE_MIGRATE_VARIANTS[name]
                turns = [vrng.integers(1, cfg.vocab_size, int(n)).tolist()
                         for n in lens]
                if not ring:
                    fr.detach()
                seen = []
                scraper = asyncio.ensure_future(scrape(interval, seen)) \
                    if interval else None
                try:
                    _, w = await wave(addrs[0], turns)
                finally:
                    if scraper is not None:
                        scraper.cancel()
                    fr.attach()
                variants[name].append(dict(w, scrapes=len(seen)))
            compiles0 = obs.backend_compiles()
            _reset_attn_counts()
            steps0 = [e.steps for e in engines]
            # wave 1 on A, /metrics scraped while it streams
            scrapes = []
            scraper = asyncio.ensure_future(scrape(0.1, scrapes))
            res1, w1 = await wave(addrs[0], prompts)
            scraper.cancel()
            if not scrapes or any(st != 200 for st, _ in scrapes) or \
                    b"paddle_tpu_serving_ttft_ms_count" not in scrapes[-1][1]:
                raise AssertionError(f"serve_migrate: {len(scrapes)} "
                                     f"/metrics scrapes")
            turns = [p + r["ids"] for p, r in zip(prompts, res1)]
            # export each finished session from A, import all on B
            t1 = time.perf_counter()
            sessions = []
            for tokens in turns:
                st, body = await _http_call(*addrs[0], "POST",
                                            "/migratez/export", json.dumps(
                                                {"tokens": tokens}).encode())
                if st != 200:
                    raise AssertionError(f"serve_migrate: export {st} "
                                         f"{body[:200]!r}")
                sessions += json.loads(body)["sessions"]
            export_ms = (time.perf_counter() - t1) * 1e3
            payload = json.dumps({"sessions": sessions}).encode()
            t1 = time.perf_counter()
            st, body = await _http_call(*addrs[1], "POST",
                                        "/migratez/import", payload)
            import_ms = (time.perf_counter() - t1) * 1e3
            result = json.loads(body)
            pages = sum(len(s["pages"]) for s in sessions)
            if st != 200 or result["imported"] != pages or \
                    result["aborted"]:
                raise AssertionError(f"serve_migrate: import {st} {result}")
            st_b0 = engines[1].stats()
            follow = [t + x for t, x in zip(turns, extra)]
            res_b, wb = await wave(addrs[1], follow)
            st_b1 = engines[1].stats()
            res_a, wa = await wave(addrs[0], follow)
            statusz = []
            for addr in addrs:
                st, body = await _http_call(*addr, "GET", "/statusz")
                if st != 200:
                    raise AssertionError(f"serve_migrate: /statusz {st}")
                statusz.append(json.loads(body))
            compiles = obs.backend_compiles() - compiles0
            # drain A with streams in flight
            drain_turns = prompts[:c["drain_requests"]]
            tasks = [asyncio.ensure_future(_client(*addrs[0], p,
                                                   c["new_tokens"]))
                     for p in drain_turns]
            deadline = time.perf_counter() + 120
            while len(servers[0]._live) < len(tasks):
                if time.perf_counter() > deadline:
                    raise AssertionError("serve_migrate: drain streams "
                                         "never went live")
                await asyncio.sleep(0.005)
            st, body = await _http_call(*addrs[0], "POST", "/drainz")
            drainz = json.loads(body)
            refused, _ = await _http_call(
                *addrs[0], "POST", "/v1/completions",
                json.dumps({"prompt": prompts[0], "max_tokens": 4}).encode())
            res_d = await asyncio.gather(*tasks)
            deadline = time.perf_counter() + 60
            while not servers[0].drained():
                if time.perf_counter() > deadline:
                    raise AssertionError("serve_migrate: A never drained")
                await asyncio.sleep(0.01)
            drained_status = json.loads((await _http_call(
                *addrs[0], "GET", "/statusz"))[1])["drained"]
            steps = sum(e.steps - s for e, s in zip(engines, steps0))
            counts = _attn_counts()
            return dict(t_ready=t_ready, w1=w1, wb=wb, wa=wa, res_b=res_b,
                        res_a=res_a, res_d=res_d, sessions=sessions,
                        pages=pages, result=result, export_ms=export_ms,
                        import_ms=import_ms, wire_bytes=len(payload),
                        st_b=(st_b0, st_b1), statusz=statusz,
                        compiles=compiles, drainz=(st, drainz),
                        refused=refused, drained=drained_status,
                        steps=steps, counts=counts, scrapes=len(scrapes),
                        variants=variants)
        finally:
            for s in servers:
                await s.stop_http()

    r = asyncio.run(go())
    fails = []
    st_b0, st_b1 = r["st_b"]
    hits = st_b1["prefix_hits"] - st_b0["prefix_hits"]
    saved = st_b1["prefix_tokens_saved"] - st_b0["prefix_tokens_saved"]
    if hits != c["requests"] or saved < r["pages"] * args.page_size:
        fails.append(f"B's follow-ups: {hits} hits, {saved} prompt tokens "
                     f"skipped for {r['pages']} migrated pages")
    for d in r["res_d"]:
        if d["finish"] != "length" or len(d["ids"]) != c["new_tokens"]:
            fails.append(f"a drained stream ended {d['finish']} with "
                         f"{len(d['ids'])} ids")
    if r["drainz"][0] != 200 or r["refused"] != 503 or not r["drained"]:
        fails.append(f"drain: /drainz {r['drainz']}, new completion "
                     f"{r['refused']}, drained {r['drained']}")
    if r["compiles"]:
        fails.append(f"{r['compiles']} kernel builds after warm-up")
    routes = _routes_of(r["counts"], False)
    total = r["counts"]["attention"]
    if routes["tile"] or not routes["split"] or not routes["sm90"] or \
            total != cfg.num_hidden_layers * r["steps"] or \
            r["counts"]["attention_int8"]:
        fails.append(f"routes {routes}, {total} launches for "
                     f"{r['steps']} steps")
    device_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    for doc in r["statusz"]:
        if doc["draining"] or not doc["ready"] or \
                doc["build"]["device"] != device_name or \
                doc["latency"]["serving.ttft_ms"]["count"] == 0:
            fails.append(f"/statusz: ready {doc['ready']}, draining "
                         f"{doc['draining']}, {doc['build']}")
    if fails:
        raise AssertionError("serve_migrate: " + "; ".join(fails))
    # follow-up tokens of both servers against the card's full forward
    turns = [s["tokens"] for s in r["sessions"]]
    card = lambda ids: model(ids.to(args.device)).float().cpu()  # noqa: E731
    tf = {}
    memo = {}
    for name, res in (("B", r["res_b"]), ("A", r["res_a"])):
        runs = [(f"{name}{i}", t + x, q["ids"])
                for i, (t, x, q) in enumerate(zip(turns, extra, res))]
        checked, near, gaps = _teacher_force(
            f"serve_migrate {name}", card, runs,
            new_tokens=c["new_tokens"], tie_rel=c["tie_rel"],
            max_tie_share=c["max_tie_share"], memo=memo)
        tf[name] = dict(tokens_checked=checked, near_ties=near,
                        near_tie_rel_gaps=gaps)
    same = sum(a == b for qa, qb in zip(r["res_a"], r["res_b"])
               for a, b in zip(qa["ids"], qb["ids"]))
    stats = {n: {k: v for k, v in doc["engine"].items()
                 if k.startswith("migration_")}
             for n, doc in zip("AB", r["statusz"])}
    emit("serve_migrate", preset=args.preset, layers=cfg.num_hidden_layers,
         dtype=cfg.dtype, max_batch=args.max_batch,
         max_seq_len=args.max_seq_len, page_size=args.page_size,
         num_pages=engines[0].g.num_pages,
         prompt_lens=[int(n) for n in lens], new_tokens=c["new_tokens"],
         follow_tokens=c["follow"], setup_and_warmup_s=r["t_ready"],
         wave_a=r["w1"], follow_b=r["wb"], follow_a=r["wa"],
         wave_a_variants=r["variants"],
         metrics_scrapes=r["scrapes"], sessions=len(r["sessions"]),
         pages_moved=r["pages"], wire_bytes=r["wire_bytes"],
         export_ms=r["export_ms"], import_ms=r["import_ms"],
         import_result=r["result"], migration_stats=stats,
         follow_prefix_hits_b=hits, follow_prefix_tokens_saved_b=saved,
         follow_tokens_equal_a_b=same,
         follow_tokens_compared=c["requests"] * c["new_tokens"],
         teacher_forced=tf, tie_rel=c["tie_rel"],
         kernel_builds_after_warmup=r["compiles"],
         sentinel={n: {"checks": doc["anomalies"]["checks"],
                       "anomalies_total": doc["anomalies"]["anomalies_total"],
                       "recent": doc["anomalies"]["recent"][-4:]}
                   for n, doc in zip("AB", r["statusz"])},
         slo={n: doc["slo"]["decision"] for n, doc in zip("AB",
                                                           r["statusz"])},
         drainz=r["drainz"][1], engine_steps=r["steps"],
         attention_routes=routes, kernel_launches=r["counts"],
         max_memory_allocated=(torch.cuda.max_memory_allocated()
                               if cuda else None),
         nvidia_smi=_nvidia_smi() if cuda else None)
    del engines, servers, model, card
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    counts = r["counts"]
    return {"attention": counts["attention"],
            "attention_int8": counts["attention_int8"], "gmm": 0,
            "attention_split": counts["attention_split"],
            "attention_int8_split": counts["attention_int8_split"],
            "attention_sm90": counts["attention_sm90"],
            "attention_int8_sm90": counts["attention_int8_sm90"],
            "gmm_sm90": 0}


# ------------------------------------------------ router, fleet, disagg ---

ROUTER_PARITY = dict(prompts=(40, 200), requests=4, new_tokens=16, page=16,
                     bucket=64, max_seq=288, follow=8)
SERVE_DISAGG = dict(prompts=(48, 144), requests=8, new_tokens=32,
                    min_ok=6, follow=16, tie_rel=2e-2, max_tie_share=0.25)
FLEET_FAILOVER = dict(preset="llama2_7b", layers=4, prompt=96,
                      new_tokens=64, tie_rel=2e-2, max_tie_share=0.25,
                      ready_s=600, restart_s=300, drain_s=120,
                      router_restart_s=120, trace_s=30)
HANDOFF_OUTCOMES = ("ok", "export_failed", "import_failed", "no_successor")


def _router_counts(family, label, values):
    from paddle_tpu_torch import observability as obs
    return {v: int(obs.metrics.counter(family, **{label: v}).value)
            for v in values}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _itl_ms(results):
    """Inter-token latencies (ms) of streamed results: each token chunk's
    gap to the previous one, split evenly over its tokens."""
    out = []
    for r in results:
        for (t0, _n0), (t1, n1) in zip(r["chunks"], r["chunks"][1:]):
            out += [(t1 - t0) * 1e3 / n1] * n1
    return out


def _latency_summary(results, new_tokens, wall):
    import numpy as np
    ttfts = [r["ttft_s"] * 1e3 for r in results]
    itl = _itl_ms(results)
    return dict(wall_s=wall, tokens_per_s=len(results) * new_tokens / wall,
                ttft_p50_ms=float(np.percentile(ttfts, 50)),
                ttft_p95_ms=float(np.percentile(ttfts, 95)),
                itl_p50_ms=float(np.percentile(itl, 50)) if itl else None,
                itl_p95_ms=float(np.percentile(itl, 95)) if itl else None)


def _check_streams(phase, results, new_tokens, vocab):
    for r in results:
        if r["finish"] != "length" or len(r["ids"]) != new_tokens or \
                len(r["cmpl_ids"]) != 1 or \
                not all(0 <= t < vocab for t in r["ids"]):
            raise AssertionError(
                f"{phase}: {r['status']}, finish {r['finish']}, "
                f"{len(r['ids'])} ids, completion ids {r['cmpl_ids']}")


def _timed_migration_calls(router):
    """Wrap the router's migration POSTs: each call's path, ms and the
    bytes it moved (the export's response, the import's request)."""
    calls = []
    real = router._post_json

    async def timed(client, path, doc, timeout_s):
        t0 = time.perf_counter()
        status, out = await real(client, path, doc, timeout_s)
        ms = (time.perf_counter() - t0) * 1e3
        moved = out if path.endswith("export") else doc
        calls.append(dict(path=path, status=status, ms=ms,
                          pages=sum(len(x.get("pages", ()))
                                    for x in moved.get("sessions") or ()),
                          bytes=len(json.dumps(moved))))
        return status, out

    router._post_json = timed
    return calls


def _sum_calls(calls, suffix):
    sel = [c for c in calls if c["path"].endswith(suffix)]
    return dict(calls=len(sel), ms=[c["ms"] for c in sel],
                ms_total=sum(c["ms"] for c in sel),
                pages=sum(c["pages"] for c in sel),
                bytes=sum(c["bytes"] for c in sel))


def _attn_window(phase, counts, steps, layers, want_routes):
    """The attention launches of one window: every launch on the float
    pool, layers x engine steps of them, and on the routes asked for
    (``want_routes`` a set of the routes that must all be non-zero, none
    other taken)."""
    routes = _routes_of(counts, False)
    bad = counts["attention_int8"] or \
        counts["attention"] != layers * steps or \
        any(routes[r] for r in routes if r not in want_routes) or \
        not all(routes[r] for r in want_routes)
    if bad:
        raise AssertionError(f"{phase}: routes {routes}, "
                             f"{counts['attention']} launches for {steps} "
                             f"steps x {layers} layers")
    return routes


def _follow_up_without_sync(phase, eng, sessions, follow, new_tokens,
                            device, vocab):
    """On a stopped replica's engine: each session's tokens plus ``follow``
    fresh ones as a new request of ``new_tokens`` (a prefix hit on the
    session's pages), the steps between drains checked by
    ``_steps_without_sync``.  Returns the (id, prompt, tokens) runs, the
    steps checked and the prefix hits."""
    import numpy as np
    rng = np.random.default_rng(21)
    hits0 = eng.g.cache.allocator.prefix_hits
    prompts = [list(t) + rng.integers(1, vocab, follow).tolist()
               for t in sessions]
    rids = [eng.add_request(p, max_new_tokens=new_tokens) for p in prompts]
    eng.step()
    checked = _steps_without_sync(eng, device)
    out = eng.run()
    hits = eng.g.cache.allocator.prefix_hits - hits0
    if hits < len(prompts):
        raise AssertionError(f"{phase}: {hits} prefix hits for "
                             f"{len(prompts)} follow-ups on the imported "
                             f"pages")
    return ([(f"follow{i}", p, out[r]) for i, (p, r) in
             enumerate(zip(prompts, rids))], checked, hits)


def phase_engine_parity_router(cfg=None, device="cuda"):
    """The router over the continuous-batching engines on the card: the
    2-layer fp32 model at llama2_7b widths, one model shared by a prefill
    and a decode ``ServingServer`` (prefix cache on both) behind an
    in-process ``RouterServer`` bound to a localhost socket; 4 streamed
    completions (prompts of 40-200 tokens, 16 new tokens) each hand off
    from the prefill to the decode replica.  Then a mixed pair serves the
    same prompts, and the replica holding the first stream is killed after
    its first token chunk: that stream resumes on the survivor from the
    router's journal.  Gates: every stream finishes with its budget as one
    client stream; every handoff outcome is ``ok``; the killed stream
    resumed; no kernel is built after warm-up; the attention launches are
    layers x engine steps; after the servers stop, follow-up turns on the
    decode engine hit the imported pages and its steps between drains make
    no sync (``_steps_without_sync``); all tokens pass ``_teacher_force``
    against the CPU (fp32: near-ties as in ``engine_parity``).  Returns the
    launch counts in ``phase_serve``'s form."""
    import numpy as np
    import torch
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.router import InprocReplica, RouterServer
    from paddle_tpu_torch.serving import ServingServer
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    c = ROUTER_PARITY
    cuda = device == "cuda"
    rng = np.random.default_rng(13)
    lens = np.linspace(c["prompts"][0], c["prompts"][1],
                       c["requests"]).astype(int)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    kw = dict(max_batch=c["requests"],
              gen=GenerationConfig(max_new_tokens=c["new_tokens"]),
              max_seq_len=c["max_seq"], page_size=c["page"],
              prefill_bucket=c["bucket"], device=device, prefix_cache=True)

    def fleet(roles):
        servers = [ServingServer(ContinuousBatchingEngine(model, **kw),
                                 role=r, warmup=True, slo=False,
                                 flight_recorder=False, sentinel=False)
                   for r in roles]
        replicas = [InprocReplica(f"{r}{i}", s.start())
                    for i, (r, s) in enumerate(zip(roles, servers))]
        return servers, replicas, RouterServer(
            replicas, policy="scored", health_interval_s=0.5)

    async def serve(router, servers, kill=False):
        addr = await router.start_http("127.0.0.1", 0)
        try:
            while len(router._candidates()) < len(servers):
                if not all(s.engine_alive() for s in servers):
                    raise RuntimeError("engine thread died during warmup")
                await asyncio.sleep(0.05)
            first, head = asyncio.Event(), {}
            tasks = [asyncio.ensure_future(_client(
                *addr, p, c["new_tokens"],
                first=first if i == 0 else None,
                headers=head if i == 0 else None))
                for i, p in enumerate(prompts)]
            victim = None
            if kill:
                await asyncio.wait_for(first.wait(), 120)
                victim = head["x-router-replica"]
                next(r for r in router.states if r.id == victim) \
                    .client.kill()
            res = await asyncio.gather(*tasks)
            return res, victim
        finally:
            await router.stop_http()

    obs.reset("router.")
    d_servers, _d_reps, d_router = fleet(["prefill", "decode"])
    m_servers, _m_reps, m_router = fleet(["mixed", "mixed"])
    while not all(s.ready() for s in d_servers + m_servers):
        if not all(s.engine_alive() for s in d_servers + m_servers):
            raise RuntimeError("engine thread died during warmup")
        time.sleep(0.05)
    engines = [s.engine for s in d_servers + m_servers]
    compiles0 = obs.backend_compiles()
    _reset_attn_counts()
    steps0 = [e.steps for e in engines]
    res_d, _ = asyncio.run(serve(d_router, d_servers))
    handoffs = _router_counts("router.handoff", "outcome", HANDOFF_OUTCOMES)
    res_m, victim = asyncio.run(serve(m_router, m_servers, kill=True))
    resumes = _router_counts("router.resumes", "outcome",
                             ("resumed", "handoff"))
    for s in d_servers + m_servers:
        s.close()
    steps = sum(e.steps - s for e, s in zip(engines, steps0))
    counts = _attn_counts()
    compiles = obs.backend_compiles() - compiles0
    _check_streams("engine_parity_router", res_d + res_m, c["new_tokens"],
                   cfg.vocab_size)
    fails = []
    if handoffs != {**dict.fromkeys(HANDOFF_OUTCOMES, 0),
                    "ok": c["requests"]}:
        fails.append(f"handoff outcomes {handoffs}")
    if resumes["handoff"] != c["requests"] or resumes["resumed"] < 1:
        fails.append(f"resumes {resumes} (the killed stream of {victim})")
    if compiles:
        fails.append(f"{compiles} kernel builds after warm-up")
    if fails:
        raise AssertionError("engine_parity_router: " + "; ".join(fails))
    routes = _attn_window("engine_parity_router", counts, steps,
                          cfg.num_hidden_layers, {"split", "tile"}) \
        if cuda else None
    # the decode engine after the imports: follow-ups hit the imported
    # pages, no sync between drains
    decode = d_servers[1].engine
    sessions = [p + r["ids"][:1] for p, r in zip(prompts, res_d)]
    follow_new = 2 * decode.g.sync_every + 2
    follow, checked, hits = _follow_up_without_sync(
        "engine_parity_router", decode, sessions, c["follow"], follow_new,
        device, cfg.vocab_size)
    del d_servers, m_servers, engines, decode
    cpu = model.to("cpu")
    if cuda:
        torch.cuda.empty_cache()
    runs = [(f"disagg{i}", p, r["ids"]) for i, (p, r) in
            enumerate(zip(prompts, res_d))] + \
        [(f"mixed{i}", p, r["ids"]) for i, (p, r) in
         enumerate(zip(prompts, res_m))]
    memo = {}
    checked_tf, near, gaps = _teacher_force(
        "engine_parity_router", cpu, runs, new_tokens=c["new_tokens"],
        tie_rel=1e-3, max_tie_share=0.0, memo=memo)
    f_checked, f_near, f_gaps = _teacher_force(
        "engine_parity_router follow-ups", cpu, follow,
        new_tokens=follow_new,
        tie_rel=1e-3, max_tie_share=0.0, memo=memo)
    emit("engine_parity_router", layers=cfg.num_hidden_layers,
         hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
         kv_heads=cfg.num_key_value_heads, prompt_lens=[int(n) for n in lens],
         new_tokens=c["new_tokens"], handoff_outcomes=handoffs,
         resume_outcomes=resumes, killed_replica=victim,
         tokens_checked=checked_tf + f_checked, near_ties=near + f_near,
         near_tie_rel_gaps=gaps + f_gaps, tie_rel=1e-3,
         follow_up_prefix_hits=hits, steps_checked_without_sync=checked,
         kernel_builds_after_warmup=compiles, engine_steps=steps,
         attention_routes=routes, kernel_launches=counts)
    del cpu, model
    gc.collect()
    return {"attention": counts["attention"],
            "attention_int8": counts["attention_int8"], "gmm": 0,
            "attention_split": counts["attention_split"],
            "attention_int8_split": counts["attention_int8_split"],
            "attention_sm90": counts["attention_sm90"],
            "attention_int8_sm90": counts["attention_int8_sm90"],
            "gmm_sm90": 0}


def phase_serve_disagg(argv=None):
    """Disaggregated serving at full width: llama2_7b (32 layers, bf16,
    random weights from the seed), one model shared by a prefill and a
    decode replica (``InprocReplicaHandle``s, the launcher's geometry and
    ``--prefix-cache``) under an in-process ``FleetSupervisor`` with
    ``fleet_roles=prefill=1,decode=1`` and its control loop on a thread; the
    ``RouterServer`` bound to a localhost socket.  8 streamed completions of
    32 tokens (prompts of 48-144 tokens) go to the router over HTTP: each
    prefills one token on the prefill replica, its prefix ships over the
    migration wire and the decode leg splices into the same client stream.
    Then, in the same call, the same traffic with fresh prompts runs on one
    mixed replica behind the router.  Gates: every stream finishes with its
    budget as one client stream; at least 6 of 8 handoffs are ``ok``; no
    kernel is built after warm-up; every attention launch takes the split
    or the sm90 route (layers x engine steps of them); after the fleet
    stops, follow-up turns on the bf16 decode engine hit the imported pages
    and its steps between drains make no sync (``_steps_without_sync``);
    the tokens pass ``_teacher_force`` against the card's full-sequence
    forward under SERVE_DISAGG's near-tie rule.  Reports tokens/s, TTFT and
    ITL p50/p95 for both, the router-side export and import ms, and the
    pages and wire bytes moved.  ``argv`` (launcher options) replaces
    ``--preset llama2_7b``.  Returns the launch counts in ``phase_serve``'s
    form."""
    import threading

    import numpy as np
    import torch
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.fleet import FleetSupervisor, InprocReplicaHandle
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.router import InprocReplica, RouterServer
    from paddle_tpu_torch.serving import ServingServer
    from paddle_tpu_torch.serving.__main__ import build_parser, engine_kwargs
    c = SERVE_DISAGG
    args = build_parser().parse_args(
        (argv or ["--preset", "llama2_7b"]) + ["--prefix-cache"])
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kw = {} if args.num_layers is None else \
        {"num_hidden_layers": args.num_layers}
    cfg = getattr(LlamaConfig, args.preset)(**kw)
    model = LlamaForCausalLM(cfg, device=args.device, seed=args.seed)
    rng = np.random.default_rng(17)
    lens = np.linspace(c["prompts"][0], c["prompts"][1],
                       c["requests"]).astype(int)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    fresh = [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in lens]

    def factory():
        return ContinuousBatchingEngine(model, **engine_kwargs(args))

    def spawner(rid, role):
        return InprocReplicaHandle(rid, factory, warmup=True, server_kw=dict(
            role=role, model_name=args.preset, sentinel=False))

    old_roles = flags.flag("fleet_roles")
    flags.set_flags({"fleet_roles": "prefill=1,decode=1"})
    try:
        router = RouterServer([], allow_empty=True, policy="scored",
                              model_name=args.preset,
                              health_interval_s=0.5)
        sup = FleetSupervisor(router, spawner, min_replicas=1,
                              max_replicas=2, hot_ticks=10**9,
                              cold_ticks=10**9, rebalance=False)
    finally:
        flags.set_flags({"fleet_roles": old_roles})
    calls = _timed_migration_calls(router)
    stop = threading.Event()

    async def wave(addr, turns):
        t1 = time.perf_counter()
        res = await asyncio.gather(*[_client(*addr, p, c["new_tokens"])
                                     for p in turns])
        wall = time.perf_counter() - t1
        _check_streams("serve_disagg", res, c["new_tokens"], cfg.vocab_size)
        return res, _latency_summary(res, c["new_tokens"], wall)

    async def disagg():
        sup.start()
        ticker = threading.Thread(target=sup.run_forever,
                                  kwargs=dict(interval_s=0.2, stop=stop),
                                  name="fleet-supervisor", daemon=True)
        ticker.start()
        addr = await router.start_http("127.0.0.1", 0)
        try:
            deadline = time.perf_counter() + 900
            while len(router._candidates()) < 2 or not sup.converged():
                if time.perf_counter() > deadline:
                    raise AssertionError(f"serve_disagg: the fleet never "
                                         f"came up: {sup.state()}")
                await asyncio.sleep(0.1)
            t_ready = time.perf_counter() - t0
            roles = {s.handle.id: s.role for s in sup._slots}
            engines = {s.role: s.handle.server.engine for s in sup._slots}
            compiles0 = obs.backend_compiles()
            h0 = _router_counts("router.handoff", "outcome",
                                HANDOFF_OUTCOMES)
            _reset_attn_counts()
            steps0 = {k: e.steps for k, e in engines.items()}
            res, w = await wave(addr, prompts)
            counts = _attn_counts()
            steps = sum(e.steps - steps0[k] for k, e in engines.items())
            handoffs = _delta(_router_counts(
                "router.handoff", "outcome", HANDOFF_OUTCOMES), h0)
            st, body = await _http_call(*addr, "GET", "/statusz")
            statusz = json.loads(body)
            compiles = obs.backend_compiles() - compiles0
            return dict(t_ready=t_ready, roles=roles, engines=engines,
                        res=res, w=w, counts=counts, steps=steps,
                        handoffs=handoffs, statusz=statusz,
                        compiles=compiles)
        finally:
            await router.stop_http()
            stop.set()
            ticker.join(timeout=10)

    r = asyncio.run(disagg())
    decode = r["engines"]["decode"]
    sup.shutdown(drain=False, timeout_s=5.0)
    fails = []
    ok = r["handoffs"]["ok"]
    if ok < c["min_ok"]:
        fails.append(f"{ok} of {c['requests']} handoffs ok: "
                     f"{r['handoffs']}")
    if r["compiles"]:
        fails.append(f"{r['compiles']} kernel builds after warm-up")
    if fails:
        raise AssertionError("serve_disagg: " + "; ".join(fails))
    routes = _attn_window("serve_disagg", r["counts"], r["steps"],
                          cfg.num_hidden_layers, {"split", "sm90"}) \
        if cuda else None
    # the bf16 decode engine after the imports, its server stopped
    sessions = [p + q["ids"][:1] for p, q in zip(prompts, r["res"])]
    follow_new = 2 * decode.g.sync_every + 2
    _reset_attn_counts()
    s0 = decode.steps
    follow, checked, hits = _follow_up_without_sync(
        "serve_disagg", decode, sessions, c["follow"], follow_new,
        args.device, cfg.vocab_size)
    f_counts = _attn_counts()
    f_routes = _attn_window("serve_disagg follow-ups", f_counts,
                            decode.steps - s0, cfg.num_hidden_layers,
                            {"split", "sm90"}) if cuda else None
    del decode, r["engines"]
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the same traffic, fresh prompts, on one mixed replica
    async def mixed():
        srv = ServingServer(factory(), model_name=args.preset, warmup=True,
                            sentinel=False, flight_recorder=False)
        srv.start()
        m_router = RouterServer([InprocReplica("m0", srv)],
                                policy="scored", model_name=args.preset,
                                health_interval_s=0.5)
        addr = await m_router.start_http("127.0.0.1", 0)
        try:
            while not m_router._candidates():
                if not srv.engine_alive():
                    raise RuntimeError("engine thread died during warmup")
                await asyncio.sleep(0.05)
            compiles0 = obs.backend_compiles()
            _reset_attn_counts()
            s0 = srv.engine.steps
            res, w = await wave(addr, fresh)
            return dict(res=res, w=w, counts=_attn_counts(),
                        steps=srv.engine.steps - s0,
                        compiles=obs.backend_compiles() - compiles0)
        finally:
            await m_router.stop_http()
            srv.close()

    m = asyncio.run(mixed())
    if m["compiles"]:
        raise AssertionError(f"serve_disagg mixed: {m['compiles']} kernel "
                             f"builds after warm-up")
    m_routes = _attn_window("serve_disagg mixed", m["counts"], m["steps"],
                            cfg.num_hidden_layers, {"split", "sm90"}) \
        if cuda else None
    card = lambda ids: model(ids.to(args.device)).float().cpu()  # noqa: E731
    tf, memo = {}, {}
    for name, runs, n in (
            ("disagg", [(f"d{i}", p, q["ids"]) for i, (p, q) in
                        enumerate(zip(prompts, r["res"]))], c["new_tokens"]),
            ("mixed", [(f"m{i}", p, q["ids"]) for i, (p, q) in
                       enumerate(zip(fresh, m["res"]))], c["new_tokens"]),
            ("follow_up", follow, follow_new)):
        checked_tf, near, gaps = _teacher_force(
            f"serve_disagg {name}", card, runs, new_tokens=n,
            tie_rel=c["tie_rel"], max_tie_share=c["max_tie_share"],
            memo=memo)
        tf[name] = dict(tokens_checked=checked_tf, near_ties=near,
                        near_tie_rel_gaps=gaps)
    export, imp = _sum_calls(calls, "export"), _sum_calls(calls, "import")
    emit("serve_disagg", preset=args.preset, layers=cfg.num_hidden_layers,
         dtype=cfg.dtype, max_batch=args.max_batch,
         max_seq_len=args.max_seq_len, page_size=args.page_size,
         prompt_lens=[int(n) for n in lens], new_tokens=c["new_tokens"],
         roles=r["roles"], setup_and_warmup_s=r["t_ready"],
         disagg=r["w"], mixed=m["w"], handoff_outcomes=r["handoffs"],
         handoff_export=export, handoff_import=imp,
         router_statusz_handoff=r["statusz"]["handoff"],
         router_statusz_resume=r["statusz"]["resume"]["outcomes"],
         teacher_forced=tf, tie_rel=c["tie_rel"],
         kernel_builds_after_warmup=r["compiles"],
         follow_up_prefix_hits=hits, steps_checked_without_sync=checked,
         attention_routes={"disagg": routes, "follow_up": f_routes,
                           "mixed": m_routes},
         engine_steps={"disagg": r["steps"], "mixed": m["steps"]},
         max_memory_allocated=(torch.cuda.max_memory_allocated()
                               if cuda else None),
         nvidia_smi=_nvidia_smi() if cuda else None)
    del model, card
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    keys = ("attention", "attention_int8", "attention_split",
            "attention_int8_split", "attention_sm90", "attention_int8_sm90")
    total = {k: r["counts"][k] + f_counts[k] + m["counts"][k] for k in keys}
    return {**total, "gmm": 0, "gmm_sm90": 0}


SERVE_ROUTERS = dict(prompts=(48, 144), requests=8, new_tokens=32,
                     kill_after=8, tie_rel=2e-2, max_tie_share=0.25,
                     heartbeat_ttl_s=1.0, heartbeat_interval_s=0.2,
                     router_backoff_s=3.0, follow=16, trace_steps=2,
                     wait_s=60.0)
SPLIT_KERNEL = "ragged_paged_attn_split_kernel"


class _DeadStore:
    """What a killed router's control plane reaches: nothing."""

    def __getattr__(self, name):
        async def dead(*args, **kw):
            raise ConnectionResetError("the router is gone")
        return dead


def _served_store(host="127.0.0.1"):
    """A ``StoreServer`` on a localhost socket, on its own thread and event
    loop (as the fleet launcher runs it).  Returns (state, port, stop)."""
    import threading

    from paddle_tpu_torch.controlplane import StoreServer, StoreState
    state = StoreState()
    server = StoreServer(state)
    loop = asyncio.new_event_loop()
    port, ready = [], threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        port.append(loop.run_until_complete(server.start(host, 0)))
        ready.set()
        loop.run_forever()

    thread = threading.Thread(target=run, name="smoke-store", daemon=True)
    thread.start()
    if not ready.wait(10):
        raise AssertionError("the membership store did not bind")

    def stop():
        # close the listener and stop the loop without waiting for the
        # clients' connections (a killed router's never closes)
        loop.call_soon_threadsafe(server._server.close)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)

    return state, port[0], stop


def _wait_until(what, cond, limit_s, tick=None):
    deadline = time.perf_counter() + limit_s
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"no {what} in {limit_s} s")
        if tick is not None:
            tick()
        time.sleep(0.05)


async def _wait_until_async(what, cond, limit_s):
    deadline = time.perf_counter() + limit_s
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"no {what} in {limit_s} s")
        await asyncio.sleep(0.05)


def _kernel_events(path):
    """(all CUDA kernel event names, count) of a ``torch.profiler`` Chrome
    trace."""
    with open(path) as f:
        doc = json.load(f)
    names = [e.get("name", "") for e in doc.get("traceEvents", [])
             if e.get("cat") == "kernel"]
    return names


def phase_serve_routers(argv=None):
    """The multi-router control plane at full width: llama2_7b (32 layers,
    bf16, random weights from the seed), one model shared by two mixed
    replicas (the launcher's geometry and ``--prefix-cache``), each an
    in-process ``ServingServer`` with its HTTP listener on localhost, under
    an in-process ``FleetSupervisor`` that publishes their endpoints to a
    ``StoreServer`` (its own thread and loop, a localhost socket).  Two
    routers, rt0 (the launcher's, handed the replicas by the supervisor) and
    rt1 (a supervised ``InprocRouterHandle`` slot, ``router_target`` 1),
    each with a ``RouterControlPlane`` over a ``StoreClient`` and replica
    discovery from the store.  Spans of every component (one process-wide
    tracer, ``FLAGS_trace_sample_rate`` 1.0) ship through a
    ``StoreTransport``; the supervisor's tick drains them into its
    ``TraceCollector``.  8 streamed completions of 32 tokens (prompts of
    48-144 tokens), sessions chosen so the ring gives each router four; two
    of each router's sessions go to it, two to the other router (4 one-hop
    forwards).  Once every stream rt1 owns has 8 tokens, rt1 is killed
    (``InprocRouterHandle.kill``: its listener closes, its client
    connections abort, its store face goes dead); every client whose
    stream broke reconnects to rt0 with the same session and trace ids.
    Gates: every stream ends as one client stream with its budget; the
    takeovers ``resumed`` equal rt1's streams in flight at the kill, none
    ``failed``; the ``cp/ring`` epoch rises and ``router.ring_moves`` >= 1;
    the supervisor restarts rt1 (``fleet.router_restarts`` 1) and the ring
    has 2 members again; every request's trace assembles with a router and
    a replica track, its critical path no longer than the stream's wall
    time, each resumed stream's trace with the ``router.takeover`` marker
    and a span of the replay phase; the exporter dropped nothing; no
    kernel built after warm-up; every attention launch on "split" or
    "sm90" (layers x engine steps of them); tokens pass ``_teacher_force``
    against the card's forward under SERVE_DISAGG's near-tie rule.  Then,
    after the fleet stops, follow-up turns on one replica's bf16 engine
    with the exporter still attached make no sync between drains
    (``_steps_without_sync``), and ``Tracer.device_trace`` around 2 of its
    decode steps writes a ``torch.profiler`` trace holding the split
    attention kernel.  ``argv`` (launcher options) replaces ``--preset
    llama2_7b``.  Returns the launch counts in ``phase_serve``'s form."""
    import os
    import threading

    import numpy as np
    import torch
    from paddle_tpu_torch import flags
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.controlplane import (HashRing, InprocRouterHandle,
                                               RouterControlPlane,
                                               StoreClient, SyncStoreClient)
    from paddle_tpu_torch.fleet import FleetSupervisor, InprocReplicaHandle
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability.collector import (SpanExporter,
                                                          StoreTransport,
                                                          TraceCollector)
    from paddle_tpu_torch.router import RouterServer
    from paddle_tpu_torch.router.replica import HttpReplica
    from paddle_tpu_torch.serving.__main__ import build_parser, engine_kwargs
    c = SERVE_ROUTERS
    args = build_parser().parse_args(
        (argv or ["--preset", "llama2_7b"]) + ["--prefix-cache"])
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kw = {} if args.num_layers is None else \
        {"num_hidden_layers": args.num_layers}
    cfg = getattr(LlamaConfig, args.preset)(**kw)
    model = LlamaForCausalLM(cfg, device=args.device, seed=args.seed)
    rng = np.random.default_rng(19)
    lens = np.linspace(c["prompts"][0], c["prompts"][1],
                       c["requests"]).astype(int)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    host = "127.0.0.1"
    base = _free_port_run(4)
    rt_ports = {"rt0": base, "rt1": base + 1}
    replica_ports = {"fs0": base + 2, "fs1": base + 3}
    # sessions: the ring gives each router four; two of each go to their
    # owner, two to the other router
    ring = HashRing(["rt0", "rt1"])
    owned = {"rt0": [], "rt1": []}
    for n in range(10_000):
        sid = f"smoke-session-{n}"
        if len(owned[ring.owner(sid)]) < c["requests"] // 2:
            owned[ring.owner(sid)].append(sid)
        if all(len(v) == c["requests"] // 2 for v in owned.values()):
            break
    plan = []          # (session, owner, first router)
    for owner, other in (("rt0", "rt1"), ("rt1", "rt0")):
        for k, sid in enumerate(owned[owner]):
            plan.append((sid, owner, owner if k % 2 == 0 else other))
    old_flags = flags.get_flags(["controlplane_heartbeat_ttl_s",
                                 "controlplane_heartbeat_interval_s",
                                 "trace_sample_rate"])
    flags.set_flags({
        "controlplane_heartbeat_ttl_s": c["heartbeat_ttl_s"],
        "controlplane_heartbeat_interval_s": c["heartbeat_interval_s"],
        "trace_sample_rate": 1.0})
    store_state, store_port, stop_store = _served_store(host)
    collector = TraceCollector()
    exporter = SpanExporter(StoreTransport(SyncStoreClient(host,
                                                           store_port)),
                            proc=f"smoke@{host}", role="fleet",
                            sample_rate=1.0)
    m = obs.metrics

    def factory():
        return ContinuousBatchingEngine(model, **engine_kwargs(args))

    class ServedReplicaHandle(InprocReplicaHandle):
        """An in-process replica that also listens on a localhost port:
        the supervisor publishes its endpoint, routers dial it."""

        def __init__(self, rid, loop):
            super().__init__(rid, factory, warmup=True, server_kw=dict(
                model_name=args.preset, sentinel=False))
            self.host, self.port, self._loop = host, replica_ports[rid], loop
            self._http = None

        def ready(self):
            if not super().ready():
                return False
            if self._http is None:
                self._http = asyncio.run_coroutine_threadsafe(
                    self.server.start_http(self.host, self.port),
                    self._loop)
            return self._http.done() and self._http.exception() is None

        def client(self):
            return HttpReplica(self.id, self.host, self.port)

    def kill_router(handle):
        r = handle.router
        r.cp.store = _DeadStore()     # no heartbeat, publish or drop
        if r._cp_task is not None:
            r._cp_task.cancel()
        r.stop_health()
        if r._asyncio_server is not None:
            r._asyncio_server.close()
        for w in list(r.smoke_conns):
            w.transport.abort()

    generations = []
    publish_ms = []                   # each journal write's round trip

    async def fleet():
        loop = asyncio.get_running_loop()

        def router(rid):
            plane = RouterControlPlane(
                rid, StoreClient(host, store_port),
                advertise={"host": host, "port": rt_ports[rid]})
            r = RouterServer([], allow_empty=True, policy="scored",
                             model_name=args.preset, health_interval_s=0.5,
                             controlplane=plane, discover_replicas=True)
            publish = plane.publish_journal

            async def timed_publish(session_id, doc):
                t = time.perf_counter()
                await publish(session_id, doc)
                publish_ms.append((time.perf_counter() - t) * 1e3)

            plane.publish_journal = timed_publish
            r.smoke_conns = set()
            serve = r.handle

            async def handle(reader, writer):
                r.smoke_conns.add(writer)
                try:
                    await serve(reader, writer)
                finally:
                    r.smoke_conns.discard(writer)

            r.handle = handle
            return r

        def router_slot(rid):
            r = router(rid)
            generations.append(asyncio.run_coroutine_threadsafe(
                r.start_http(host, rt_ports[rid]), loop))
            return r

        rt0 = router("rt0")
        sup = FleetSupervisor(
            rt0, lambda rid: ServedReplicaHandle(rid, loop), target=2,
            min_replicas=2, max_replicas=2, hot_ticks=10**9,
            cold_ticks=10**9, rebalance=False,
            router_spawner=lambda rid: InprocRouterHandle(
                rid, router_slot, on_kill=kill_router),
            router_target=1, store=SyncStoreClient(host, store_port),
            collector=collector, backoff_base_s=c["router_backoff_s"])
        stop = threading.Event()
        exporter.start()
        sup.start()
        ticker = threading.Thread(target=sup.run_forever,
                                  kwargs=dict(interval_s=0.2, stop=stop),
                                  name="fleet-supervisor", daemon=True)
        ticker.start()
        await rt0.start_http(host, rt_ports["rt0"])
        try:
            return await traffic(sup, rt0)
        finally:
            stop.set()
            ticker.join(timeout=10)
            routers = [rt0] + [s.handle.router for s in sup._router_slots]
            for rt in routers:
                if rt._asyncio_server is not None:
                    await rt.stop_http()
            # the killed generation's handlers: their clients are gone
            for w in [w for rt in routers for w in rt.smoke_conns]:
                w.transport.abort()
            await asyncio.sleep(0.2)
            for slot in sup._slots:
                if slot.handle.server is not None:
                    await slot.handle.server.stop_http()
            sup.shutdown(drain=False, timeout_s=5.0)
            for rt in routers:
                if not isinstance(rt.cp.store, _DeadStore):
                    await rt.cp.store.close()

    async def traffic(sup, rt0):
        def rt1():
            return sup._router_slots[0].handle.router

        def up():
            routers = [rt0, rt1()]
            return sup.converged() and all(
                len(r._candidates()) == 2 and len(r.cp.members) == 2
                for r in routers) and generations and \
                generations[-1].done()

        await _wait_until_async("ready fleet", up, 900)
        t_ready = time.perf_counter() - t0
        engines = {s.handle.id: s.handle.server.engine for s in sup._slots}
        compiles0 = obs.backend_compiles()
        take0 = {o: m.counter("controlplane.takeovers", outcome=o).value
                 for o in ("resumed", "stale", "failed")}
        fwd0 = {o: m.counter("router.forwarded", outcome=o).value
                for o in ("out", "received", "fallback")}
        moves0 = m.counter("router.ring_moves").value
        restarts0 = m.counter("fleet.router_restarts").value
        epoch0 = store_state.get("cp/ring")[1]["epoch"]
        ops0 = {op: m.counter("controlplane.store_ops", op=op).value
                for op in ("set", "get", "cas", "del", "hb", "members")}
        _reset_attn_counts()
        steps0 = {k: e.steps for k, e in engines.items()}
        marks = {sid: asyncio.Event() for sid, owner, _ in plan
                 if owner == "rt1"}
        t_kill = [None]

        async def one(i, sid, owner, first):
            send = (("X-Session-Id", sid), ("X-Trace-Id", f"smoke-tr-{i}"))
            t1 = time.perf_counter()
            head = {}
            res = await _client(host, rt_ports[first], prompts[i],
                                c["new_tokens"], headers=head, send=send,
                                mark=(c["kill_after"], marks[sid])
                                if sid in marks else None)
            attempts = [dict(res, router=first, head=head)]
            if res["finish"] is None:         # its router died: reconnect
                head = {}
                t_retry = time.perf_counter()
                res = await _client(host, rt_ports["rt0"], prompts[i],
                                    c["new_tokens"], headers=head,
                                    send=send)
                attempts.append(dict(res, router="rt0", head=head,
                                     started=t_retry))
            res = dict(res, wall_s=time.perf_counter() - t1)
            return dict(i=i, sid=sid, owner=owner, first=first,
                        trace=f"smoke-tr-{i}", res=res, attempts=attempts)

        lag_ms = []                   # the event loop's lateness

        async def lag_probe():
            while True:
                t = time.perf_counter()
                await asyncio.sleep(0.01)
                lag_ms.append((time.perf_counter() - t - 0.01) * 1e3)

        probe = asyncio.ensure_future(lag_probe())
        publish_ms.clear()
        t1 = time.perf_counter()
        tasks = [asyncio.ensure_future(one(i, *p)) for i, p in
                 enumerate(plan)]
        await asyncio.wait_for(asyncio.gather(*(e.wait() for e in
                                                marks.values())), 300)
        victims = [p[0] for p, t in zip(plan, tasks)
                   if p[1] == "rt1" and not t.done()]
        sup._router_slots[0].handle.kill()
        t_kill[0] = time.perf_counter()
        results = await asyncio.wait_for(asyncio.gather(*tasks), 600)
        wall = time.perf_counter() - t1
        probe.cancel()
        counts = _attn_counts()
        steps_by = {k: e.steps - steps0[k] for k, e in engines.items()}
        steps = sum(steps_by.values())
        compiles = obs.backend_compiles() - compiles0
        # the ring drops rt1, then the supervisor brings it back
        await _wait_until_async(
            "ring without rt1", lambda: rt0.cp.members.keys() == {"rt0"}
            or m.counter("fleet.router_restarts").value > restarts0,
            c["wait_s"])
        await _wait_until_async(
            "rt1 restarted", lambda: m.counter(
                "fleet.router_restarts").value > restarts0 and
            len(rt0.cp.members) == 2 and len(rt1().cp.members) == 2 and
            generations[-1].done(), c["wait_s"])
        epoch1 = store_state.get("cp/ring")[1]["epoch"]
        takeovers = {o: m.counter("controlplane.takeovers", outcome=o).value
                     - take0[o] for o in take0}
        forwarded = {o: m.counter("router.forwarded", outcome=o).value
                     - fwd0[o] for o in fwd0}
        ops = {op: m.counter("controlplane.store_ops", op=op).value - ops0[op]
               for op in ops0}
        st, body = await _http_call(host, rt_ports["rt0"], "GET", "/statusz")
        return dict(t_ready=t_ready, engines=engines, results=results,
                    wall=wall, counts=counts, steps=steps,
                    compiles=compiles, victims=victims, t_kill=t_kill[0],
                    steps_by=steps_by, lag_ms=list(lag_ms),
                    publish_ms=list(publish_ms),
                    takeovers=takeovers, forwarded=forwarded,
                    ring_moves=m.counter("router.ring_moves").value - moves0,
                    router_restarts=m.counter(
                        "fleet.router_restarts").value - restarts0,
                    epochs=(epoch0, epoch1), store_ops=ops,
                    members=sorted(rt0.cp.members),
                    statusz_cp=json.loads(body)["controlplane"])

    try:
        r = asyncio.run(fleet())
        # every trace, assembled from the store-shipped batches
        want = {x["trace"] for x in r["results"]}

        def assembled():
            have = set(collector.traces())
            if not want <= have:
                return False
            return all(any(t.split("/")[1].startswith("router:")
                           for t in collector.track_names(tid)) and
                       any(not t.split("/")[1].startswith("router:")
                           for t in collector.track_names(tid))
                       for tid in want)

        poller = SyncStoreClient(host, store_port)

        def drain():
            exporter.flush()
            collector.poll_store(poller)

        _wait_until("assembled traces", assembled, c["wait_s"], tick=drain)
        dropped = m.counter("observability.collector.export_dropped").value
        export_errors = m.counter(
            "observability.collector.export_errors").value
        refused = m.counter("controlplane.store_refused").value
        traces = {}
        for x in r["results"]:
            doc = collector.assemble(x["trace"])
            names = {e.get("name") for e in doc["traceEvents"]}
            traces[x["trace"]] = dict(
                tracks=collector.track_names(x["trace"]),
                critical_path=doc["metadata"]["critical_path"],
                takeover="router.takeover" in names,
                replay_spans=sum(
                    1 for e in doc["traceEvents"] if e.get("ph") == "X"
                    and TraceCollector._phase_of(e["name"]) == "replay"))
        engine = r["engines"]["fs0"]
        # the bf16 engine after the fleet, the exporter still attached:
        # follow-up turns, the steps between drains checked for syncs
        follow_new = 2 * engine.g.sync_every + 2
        frng = np.random.default_rng(29)
        fprompts = [prompts[x["i"]] + x["res"]["ids"][:8] +
                    frng.integers(1, cfg.vocab_size, c["follow"]).tolist()
                    for x in r["results"][:4]]
        _reset_attn_counts()
        s0 = engine.steps
        frids = [engine.add_request(p, max_new_tokens=follow_new)
                 for p in fprompts]
        t_follow = time.perf_counter()
        engine.step()
        checked = _steps_without_sync(engine, args.device)
        fout = engine.run()
        follow_ms = (time.perf_counter() - t_follow) * 1e3 / \
            (engine.steps - s0)
        follow = [(f"follow{i}", p, fout[q]) for i, (p, q) in
                  enumerate(zip(fprompts, frids))]
        f_counts = _attn_counts()
        f_routes = _attn_window("serve_routers follow-ups", f_counts,
                                engine.steps - s0, cfg.num_hidden_layers,
                                {"split", "sm90"}) if cuda else None
        # Tracer.device_trace around decode steps of the same engine
        logdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "smoke_out", "device_trace")
        for p in prompts[:2]:
            engine.add_request(list(p), max_new_tokens=8)
        while engine.waiting or any(
                q is not None and engine.prompt_pos[b] < len(q.prompt)
                for b, q in enumerate(engine.slot_req)):
            engine.step()
        with obs.TRACER.device_trace(logdir) as traced:
            for _ in range(c["trace_steps"]):
                engine.step()
            if cuda:
                torch.cuda.synchronize()
        engine.run()
        trace_path = os.path.join(logdir, "device_trace.json")
        kernels = _kernel_events(trace_path) if traced else []
    finally:
        exporter.close()
        stop_store()
        flags.set_flags(old_flags)
    fails = []
    res = r["results"]
    _check_streams("serve_routers", [x["res"] for x in res],
                   c["new_tokens"], cfg.vocab_size)
    resumed = [x for x in res if x["sid"] in r["victims"]]
    if len(r["victims"]) != c["requests"] // 2 or \
            r["takeovers"]["resumed"] != len(r["victims"]) or \
            r["takeovers"]["failed"]:
        fails.append(f"takeovers {r['takeovers']} for rt1's "
                     f"{len(r['victims'])} streams in flight")
    if any(x["attempts"][-1]["head"].get("x-router-replica") != "takeover"
           for x in resumed):
        fails.append("a resumed stream was not a takeover")
    if r["forwarded"]["out"] < c["requests"] // 2:
        fails.append(f"forwards {r['forwarded']}")
    if not r["epochs"][1] > r["epochs"][0] or r["ring_moves"] < 1:
        fails.append(f"cp/ring epochs {r['epochs']}, ring moves "
                     f"{r['ring_moves']}")
    if r["router_restarts"] != 1 or r["members"] != ["rt0", "rt1"]:
        fails.append(f"router restarts {r['router_restarts']}, members "
                     f"{r['members']}")
    for x in res:
        t = traces[x["trace"]]
        total = (t["critical_path"] or {}).get("total_ms")
        if total is None or total > x["res"]["wall_s"] * 1e3:
            fails.append(f"{x['trace']}: critical path {total} ms over a "
                         f"{x['res']['wall_s'] * 1e3:.1f} ms stream")
        # the replay leg is a span of the replay phase; the critical path
        # credits it only where the dead leg's decode (the replica finishes
        # a request whose client left) no longer covers it
        if x in resumed and (not t["takeover"] or not t["replay_spans"]):
            fails.append(f"{x['trace']}: no takeover marker or replay "
                         f"span: {t['critical_path']}")
    if dropped:
        fails.append(f"the exporter dropped {dropped} spans")
    if r["compiles"]:
        fails.append(f"{r['compiles']} kernel builds after warm-up")
    if cuda and not any(SPLIT_KERNEL in k for k in kernels):
        fails.append(f"device_trace: no {SPLIT_KERNEL} among "
                     f"{len(kernels)} kernel events")
    if fails:
        raise AssertionError("serve_routers: " + "; ".join(fails))
    routes = _attn_window("serve_routers", r["counts"], r["steps"],
                          cfg.num_hidden_layers, {"split", "sm90"}) \
        if cuda else None
    card = lambda ids: model(ids.to(args.device)).float().cpu()  # noqa: E731
    memo = {}
    tf = {}
    for name, runs, n in (
            ("streams", [(x["trace"], prompts[x["i"]], x["res"]["ids"])
                         for x in res], c["new_tokens"]),
            ("follow_up", follow, follow_new)):
        checked_tf, near, gaps = _teacher_force(
            f"serve_routers {name}", card, runs, new_tokens=n,
            tie_rel=c["tie_rel"], max_tie_share=c["max_tie_share"],
            memo=memo)
        tf[name] = dict(tokens_checked=checked_tf, near_ties=near,
                        near_tie_rel_gaps=gaps)
    # ms from the kill to each resumed stream's first token past the ones
    # its client held
    resume_ms = []
    for x in resumed:
        before = len(x["attempts"][0]["ids"])
        last = x["attempts"][-1]
        n = 0
        for t_arr, k in last["chunks"]:
            n += k
            if n > before:
                resume_ms.append((last["started"] + t_arr - r["t_kill"])
                                 * 1e3)
                break
    phases = {}
    for t in traces.values():
        for ph, ms in t["critical_path"]["phases_ms"].items():
            phases.setdefault(ph, []).append(ms)
    emit("serve_routers", preset=args.preset, layers=cfg.num_hidden_layers,
         dtype=cfg.dtype, max_batch=args.max_batch,
         max_seq_len=args.max_seq_len, page_size=args.page_size,
         prompt_lens=[int(n) for n in lens], new_tokens=c["new_tokens"],
         setup_and_warmup_s=r["t_ready"],
         traffic=_latency_summary([x["res"] for x in res],
                                  c["new_tokens"], r["wall"]),
         plan=[dict(session=x["sid"], owner=x["owner"], first=x["first"],
                    attempts=[a["router"] for a in x["attempts"]],
                    tokens_before_kill=len(x["attempts"][0]["ids"]))
               for x in res],
         killed="rt1", streams_in_flight_at_kill=len(r["victims"]),
         takeovers=r["takeovers"], forwarded=r["forwarded"],
         kill_to_next_token_ms=resume_ms, ring_moves=r["ring_moves"],
         ring_epochs=r["epochs"], router_restarts=r["router_restarts"],
         members_after=r["members"], statusz_controlplane=r["statusz_cp"],
         store_ops=r["store_ops"], store_refused=refused,
         export_dropped=dropped, export_errors=export_errors,
         collector_processes=collector.processes(),
         critical_path_p50_ms={ph: float(np.percentile(v, 50))
                               for ph, v in sorted(phases.items())},
         traces={k: dict(tracks=v["tracks"],
                         phases_ms=v["critical_path"]["phases_ms"],
                         total_ms=v["critical_path"]["total_ms"],
                         wall_ms=x["res"]["wall_s"] * 1e3)
                 for x in res for k, v in traces.items()
                 if k == x["trace"]},
         teacher_forced=tf, tie_rel=c["tie_rel"],
         kernel_builds_after_warmup=r["compiles"],
         steps_checked_without_sync=checked,
         device_trace=dict(started=traced, path=os.path.relpath(
             trace_path, os.path.dirname(os.path.abspath(__file__))),
             kernel_events=len(kernels),
                           split_kernel_events=sum(SPLIT_KERNEL in k
                                                   for k in kernels)),
         attention_routes={"streams": routes, "follow_up": f_routes},
         engine_steps=r["steps"],
         ms_per_engine_step={k: r["wall"] * 1e3 / n
                             for k, n in r["steps_by"].items() if n},
         ms_per_step_one_engine_alone=follow_ms,
         loop_lag_ms={q: float(np.percentile(r["lag_ms"], q))
                      for q in (50, 95, 100)} if r["lag_ms"] else None,
         journal_publish_ms=dict(
             calls=len(r["publish_ms"]),
             p50=float(np.percentile(r["publish_ms"], 50)),
             p95=float(np.percentile(r["publish_ms"], 95)))
         if r["publish_ms"] else None,
         max_memory_allocated=(torch.cuda.max_memory_allocated()
                               if cuda else None),
         nvidia_smi=_nvidia_smi() if cuda else None)
    keys = ("attention", "attention_int8", "attention_split",
            "attention_int8_split", "attention_sm90", "attention_int8_sm90")
    total = {k: r["counts"][k] + f_counts[k] for k in keys}
    del model, card, engine, r
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {**total, "gmm": 0, "gmm_sm90": 0}


def _free_port_run(n):
    """A base port with ``n`` consecutive free localhost ports."""
    import socket
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for i in range(n):
                socks.append(socket.socket())
                socks[-1].bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    raise RuntimeError("no run of free localhost ports")


def _get_json(port, path, timeout=5.0):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def _cuda_contexts():
    """How many processes hold a CUDA context on the card (``nvidia-smi``'s
    compute apps; their pids are the host's, so only the count is read)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return len(out.split())


def _process_tree(pid):
    """``[(pid, state, command line)]`` of ``pid``'s living descendants, read
    from ``/proc``."""
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        try:
            with open(f"/proc/{p}/task/{p}/children") as f:
                kids = [int(k) for k in f.read().split()]
        except OSError:
            kids = []
        for k in kids:
            try:
                with open(f"/proc/{k}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode()[:200]
                with open(f"/proc/{k}/stat") as f:
                    state = f.read().rsplit(")", 1)[1].split()[0]
            except OSError:
                continue
            out.append((k, state, cmd))
            todo.append(k)
    return out


def _pid_alive(pid):
    import os
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def phase_fleet_failover(argv=None):
    """The real process topology: ``python -m paddle_tpu_torch.fleet
    --replicas 2 --min-replicas 2 --routers 2 --preset llama2_7b
    --num-layers 4 --device cuda`` (a depth cut, to keep each replica's
    start short): the launcher runs router rt0, the membership store, the
    trace collector and the supervisor; each replica is its own ``python -m
    paddle_tpu_torch.serving`` process on the card and router rt1 its own
    ``python -m paddle_tpu_torch.router`` process, which discovers the
    replicas from the store.  Once rt0's ``/statusz`` shows both replicas
    ready, one streamed completion of 64 tokens (a 96-token prompt) goes to
    rt0; after its first token chunk the replica serving it is killed with
    SIGKILL.  Then, once rt1 has joined the ring and discovered both
    replicas, one stream of a session rt1 owns goes to rt1's port; after
    its first chunk rt1's process is killed with SIGKILL and the client
    retries on rt0 with the same session and trace ids.  Gates: each stream
    finishes with its budget as one client stream (the first resumed on the
    survivor from the router's journal, the second taken over by rt0 from
    rt1's store-replicated journal), its tokens pass ``_teacher_force``
    against an in-process model of the same preset, seed and depth on the
    card; the supervisor restarts the dead replica on its port (2 ready
    replicas again) and rt1 on its port (the ring has 2 members again; the
    restart seconds are reported); killing rt1 frees no CUDA context (a
    router holds no tensors);
    ``GET /tracez?trace_id=`` on rt0 returns the taken-over stream's
    timeline with tracks from 2 processes or more (the replicas POST their
    spans to rt0's ``/collectz``, rt1 ships its own through the store) and
    the index reports each process's clock offset; SIGTERM to the launcher
    drains the fleet and it exits 0, with no router or replica process
    left.  ``argv`` replaces the launcher's model options (``--preset``,
    ``--num-layers``, ``--device``).  The replicas' kernel launches happen
    in their own processes and are not counted here."""
    import os
    import signal

    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    c = FLEET_FAILOVER
    model_argv = argv or ["--preset", c["preset"], "--num-layers",
                          str(c["layers"]), "--device", "cuda"]
    opts = dict(zip(model_argv[::2], model_argv[1::2]))
    device = opts["--device"]
    base = _free_port_run(4)
    port, replica_base = base, base + 1
    router_base = base + 2             # rt1 listens on router_base + 1
    rt1_port = router_base + 1
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "smoke_out"), exist_ok=True)
    log_path = os.path.join(root, "smoke_out", "fleet_failover.log")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.fleet", "--replicas", "2",
           "--min-replicas", "2", "--port", str(port),
           "--replica-port-base", str(replica_base),
           "--routers", "2", "--router-port-base", str(router_base),
           "--set", "fleet_tick_interval_s=0.25",
           "--set", "controlplane_heartbeat_ttl_s=1.0",
           "--set", "controlplane_heartbeat_interval_s=0.25",
           "--set", "trace_export_interval_s=0.25",
           "--set", "router_health_interval_s=0.25",
           "--set", "fleet_drain_timeout_s=30",
           "--set", "flight_recorder_path=smoke_out/fleet_failover_fr.json"
           ] + model_argv
    log = open(log_path, "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=log,
                            stderr=subprocess.STDOUT)
    pids = set()

    def replica_pid(i):
        st, doc = _get_json(replica_base + i, "/statusz")
        return doc["build"]["pid"] if st == 200 else None

    def log_tail():
        log.flush()
        with open(log_path) as f:
            return f.read()[-2000:]

    def wait(what, cond, limit):
        deadline = time.perf_counter() + limit
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"fleet_failover: the launcher exited "
                                     f"{proc.returncode} while waiting for "
                                     f"{what}; its log ends:\n{log_tail()}")
            try:
                if cond():
                    return
            except OSError:
                pass
            if time.perf_counter() > deadline:
                raise AssertionError(f"fleet_failover: no {what} in "
                                     f"{limit} s; the launcher's log "
                                     f"ends:\n{log_tail()}")
            time.sleep(0.2)

    def ready_replicas(at=port):
        st, doc = _get_json(at, "/statusz")
        return [r for r in doc.get("replicas", []) if r["state"] == "ready"]

    def router_pid(at):
        st, doc = _get_json(at, "/statusz")
        return doc.get("pid") if st == 200 else None

    def ring_members():
        st, doc = _get_json(port, "/statusz")
        return (doc.get("controlplane") or {}).get("members")

    rc = None
    try:
        wait("ready fleet", lambda: len(ready_replicas()) == 2,
             c["ready_s"])
        t_ready = time.perf_counter() - t0
        before = {i: replica_pid(i) for i in range(2)}
        pids |= set(before.values())
        kw = {"num_hidden_layers": int(opts["--num-layers"])} \
            if "--num-layers" in opts else {}
        cfg = getattr(LlamaConfig, opts["--preset"])(**kw)
        rng = np.random.default_rng(23)
        prompt = rng.integers(1, cfg.vocab_size, c["prompt"]).tolist()

        async def stream_and_kill():
            first, head = asyncio.Event(), {}
            task = asyncio.ensure_future(_client(
                "127.0.0.1", port, prompt, c["new_tokens"], first=first,
                headers=head))
            await asyncio.wait_for(first.wait(), 300)
            victim = head["x-router-replica"]
            slot = int(victim.removeprefix("fs"))
            os.kill(before[slot], signal.SIGKILL)
            t_kill = time.perf_counter()
            res = await asyncio.wait_for(task, 300)
            return res, victim, slot, t_kill

        res, victim, slot, t_kill = asyncio.run(stream_and_kill())
        _check_streams("fleet_failover", [res], c["new_tokens"],
                       cfg.vocab_size)
        tokens_before_kill = res["chunks"][0][1]
        wait("restarted replica",
             lambda: replica_pid(slot) not in (None, before[slot])
             and len(ready_replicas()) == 2, c["restart_s"])
        restart_s = time.perf_counter() - t_kill
        after = {i: replica_pid(i) for i in range(2)}
        pids |= set(after.values())
        # router rt1, a process of its own: a stream of a session it owns,
        # the process killed after the first chunk, the client retried on
        # rt0 with the same session and trace ids
        from paddle_tpu_torch.controlplane import HashRing
        wait("rt1 on the ring with both replicas",
             lambda: ring_members() == ["rt0", "rt1"]
             and len(ready_replicas(rt1_port)) == 2, c["ready_s"])
        rt1_before = router_pid(rt1_port)
        pids.add(rt1_before)
        ring = HashRing(["rt0", "rt1"])
        sid = next(f"smoke-failover-{n}" for n in range(10_000)
                   if ring.owner(f"smoke-failover-{n}") == "rt1")
        trace_id = "smoke-failover-router"
        prompt_rt = rng.integers(1, cfg.vocab_size, c["prompt"]).tolist()
        send = (("X-Session-Id", sid), ("X-Trace-Id", trace_id))
        contexts = {}
        # one short stream rt1 serves whole: its spans ship through the
        # store to the launcher's collector
        probe = asyncio.run(_client("127.0.0.1", rt1_port, prompt_rt[:16],
                                    2))
        if probe["finish"] != "length":
            raise AssertionError(f"fleet_failover: rt1 probe {probe}")
        wait("rt1's spans through the store", lambda: any(
            k.startswith("rt1@") for k in
            _get_json(port, "/tracez")[1].get("processes", {})),
            c["trace_s"])

        async def stream_and_kill_router():
            first, head = asyncio.Event(), {}
            task = asyncio.ensure_future(_client(
                "127.0.0.1", rt1_port, prompt_rt, c["new_tokens"],
                first=first, headers=head, send=send))
            await asyncio.wait_for(first.wait(), 300)
            if device == "cuda":
                contexts["rt1_alive"] = _cuda_contexts()
            os.kill(rt1_before, signal.SIGKILL)
            t_kill = time.perf_counter()
            if device == "cuda":
                while _pid_alive(rt1_before) and \
                        time.perf_counter() - t_kill < 10:
                    await asyncio.sleep(0.05)
                contexts["rt1_dead"] = _cuda_contexts()
            broken = await asyncio.wait_for(task, 300)
            head2 = {}
            res = await asyncio.wait_for(_client(
                "127.0.0.1", port, prompt_rt, c["new_tokens"],
                headers=head2, send=send), 300)
            return broken, res, head2, t_kill

        broken, res_rt, head_rt, t_kill_rt = asyncio.run(
            stream_and_kill_router())
        _check_streams("fleet_failover router", [res_rt], c["new_tokens"],
                       cfg.vocab_size)
        wait("restarted rt1", lambda: router_pid(rt1_port) not in
             (None, rt1_before) and ring_members() == ["rt0", "rt1"],
             c["router_restart_s"])
        router_restart_s = time.perf_counter() - t_kill_rt
        rt1_after = router_pid(rt1_port)
        pids.add(rt1_after)
        # the collector: the taken-over stream's merged timeline
        tracez = {}

        def traced():
            st, doc = _get_json(port, f"/tracez?trace_id={trace_id}")
            if st != 200:
                return False
            procs = {k.split("/")[0] for k in doc["metadata"]["processes"]}
            tracez.update(doc=doc, procs=sorted(procs))
            return len(procs) >= 2 and any(
                e.get("name") == "router.takeover"
                for e in doc["traceEvents"])

        wait("merged timeline", traced, c["trace_s"])
        st, index = _get_json(port, "/tracez")
        st, statusz = _get_json(port, "/statusz")
        proc.send_signal(signal.SIGTERM)
        t_term = time.perf_counter()
        try:
            rc = proc.wait(timeout=c["drain_s"])
        except subprocess.TimeoutExpired:
            print(f"fleet_failover: the launcher (pid {proc.pid}) outlived "
                  f"its {c['drain_s']} s drain after SIGTERM; its living "
                  f"children: {_process_tree(proc.pid)}; its log ends:\n"
                  f"{log_tail()}", flush=True)
            raise AssertionError(f"fleet_failover: the launcher did not exit "
                                 f"within {c['drain_s']} s of SIGTERM")
        drain_s = time.perf_counter() - t_term
        left = sorted(p for p in pids if p and _pid_alive(p))
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for i in range(2):
            try:
                pids.add(replica_pid(i))
            except OSError:
                pass
        for p in pids:
            if p and _pid_alive(p):
                os.kill(p, signal.SIGKILL)
        log.close()
    fails = []
    if rc != 0 or left:
        fails.append(f"launcher exit {rc} after SIGTERM, replica processes "
                     f"left {left}")
    if statusz["resume"]["outcomes"]["resumed"] < 1 or \
            statusz["failover"]["stream"] < 1:
        fails.append(f"router resume {statusz['resume']}, failover "
                     f"{statusz['failover']}")
    takeovers = statusz["controlplane"]["takeovers"]
    if broken["finish"] is not None or takeovers["resumed"] != 1 or \
            takeovers["failed"] or \
            head_rt.get("x-router-replica") != "takeover":
        fails.append(f"rt1's stream: first attempt finish "
                     f"{broken['finish']}, takeovers {takeovers}")
    # a router holds no tensors: its death takes no CUDA context with it
    if contexts.get("rt1_alive") != contexts.get("rt1_dead"):
        fails.append(f"CUDA contexts with rt1 alive / dead: {contexts}")
    if len(index.get("processes", {})) < 3:
        fails.append(f"collector processes {index.get('processes')}")
    if fails:
        raise AssertionError("fleet_failover: " + "; ".join(fails))
    if device == "cuda":
        torch.cuda.empty_cache()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    card = lambda ids: model(ids.to(device)).float().cpu()  # noqa: E731
    checked, near, gaps = _teacher_force(
        "fleet_failover", card, [("stream", prompt, res["ids"]),
                                 ("router_stream", prompt_rt,
                                  res_rt["ids"])],
        new_tokens=c["new_tokens"], tie_rel=c["tie_rel"],
        max_tie_share=c["max_tie_share"])
    emit("fleet_failover", preset=opts["--preset"],
         layers=cfg.num_hidden_layers, dtype=cfg.dtype, device=device,
         prompt_len=c["prompt"], new_tokens=c["new_tokens"],
         setup_and_ready_s=t_ready, killed_replica=victim,
         tokens_before_kill=tokens_before_kill, stream_s=res["seconds"],
         restart_s=restart_s, drain_s=drain_s, launcher_exit=rc,
         replica_pids={"before": before, "after": after},
         router_resume=statusz["resume"]["outcomes"],
         router_failover=statusz["failover"],
         router_kill=dict(
             session=sid, tokens_before_kill=len(broken["ids"]),
             stream_s=res_rt["seconds"], router_restart_s=router_restart_s,
             router_pids={"before": rt1_before, "after": rt1_after},
             controlplane=statusz["controlplane"],
             trace_processes=tracez["procs"],
             trace_tracks=sorted(tracez["doc"]["metadata"]["processes"]),
             critical_path=tracez["doc"]["metadata"]["critical_path"],
             collector_processes={
                 k: {f: v.get(f) for f in ("role", "offset_us", "rtt_us")}
                 for k, v in index["processes"].items()},
             cuda_contexts=contexts),
         tokens_checked=checked, near_ties=near, near_tie_rel_gaps=gaps,
         tie_rel=c["tie_rel"], log=os.path.relpath(log_path, root),
         nvidia_smi=_nvidia_smi() if device == "cuda" else None)
    del model, card
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------ tensor parallel ---

SERVE_TP = dict(layers=8, max_batch=8, max_seq_len=1024, page=16,
                bucket=64, num_pages=512, prompts=(32, 512), requests=8,
                new_tokens=64,
                timed_context=512, timed_steps=16, moe_layers=4,
                moe_new_tokens=32, waves=dict(prefix=128, tails=(16, 64),
                                              requests=4, new_tokens=16,
                                              spill=8, spec_k=4),
                migrate_prompt=200, migrate_after=8, migrate_new_tokens=32,
                migrate_pages=64, tie_rel=2e-2, max_tie_share=0.25)


def _tp_devices(tp, device, devices=None):
    """The shard devices of a ``tp``-degree engine: ``devices`` where it is
    given, else every shard on the one card (or the CPU for a
    rehearsal)."""
    if tp == 1 or device == "cpu":
        return device
    return devices or [f"{device}:0"] * tp


def _tp_engine(model, tp, device, *, devices=None, new_tokens=None, **kw):
    """An engine over ``model`` at the launcher's geometry (8 slots,
    max_seq_len 1024, page 16, bucket 64, 512 pages unless ``kw`` says
    otherwise) with ``tp`` shards (on ``devices`` where given)."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    c = SERVE_TP
    geo = dict(max_batch=c["max_batch"], max_seq_len=c["max_seq_len"],
               page_size=c["page"], prefill_bucket=c["bucket"],
               num_pages=c["num_pages"])
    geo.update(kw)
    return ContinuousBatchingEngine(
        model, tensor_parallel=tp,
        device=_tp_devices(tp, device, devices),
        gen=GenerationConfig(max_new_tokens=new_tokens or c["new_tokens"]),
        **geo)


def _tp_streams(eng, prompts, device):
    """Serve ``prompts`` to completion on ``eng`` with every launch count
    set to 0 just before and read just after.  Returns the tokens, the
    final hidden states of the first prefill step and the first decode step,
    the launch counts (attention by route, gmm and its sm90 launches), the
    attention launches' plans ((T, kv heads, route, splits) -> launches) and
    the wall seconds."""
    import collections

    import torch
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.kernels import paged_attention as pa
    g = eng.g
    real_fwd, real_plan = g._forward_tokens, pa.launch_plan
    hidden, plans = {}, collections.Counter()

    def record(params, tokens, *a, **k):
        h = real_fwd(params, tokens, *a, **k)
        hidden.setdefault("decode" if tokens.shape[1] == 1 else "prefill",
                          h.clone())
        return h

    def plan(q, k_cache, *a, **k):
        p = real_plan(q, k_cache, *a, **k)
        plans[(q.shape[1], k_cache.shape[0], p["route"], p["splits"])] += 1
        return p

    g._forward_tokens, pa.launch_plan = record, plan
    try:
        _reset_attn_counts()
        gm.LAUNCHES = gm.LAUNCHES_SM90 = 0
        t0 = time.perf_counter()
        rids = [eng.add_request(p) for p in prompts]
        out = eng.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _attn_counts()
        counts["gmm"], counts["gmm_sm90"] = gm.LAUNCHES, gm.LAUNCHES_SM90
    finally:
        del g._forward_tokens
        pa.launch_plan = real_plan
    return [out[r] for r in rids], hidden, counts, dict(plans), wall


def _tp_pair(what, model, prompts, device, *, tp=2, hidden_gate=True,
             devices=None, **kw):
    """The same streams through a tp=1 and a ``tp``-degree engine over one
    model: tokens equal; the final hidden states of the first prefill and
    the first decode step ``torch.equal`` (reported only where
    ``hidden_gate`` is false); each kernel's launches exactly ``tp`` x
    tp=1's on every route (one a shard); every sharded attention launch
    planned with tp=1's split count at its T.  ``devices`` places the
    shards (default: all on the one card).  Returns the record, the
    failures, tp=1's tokens and the sharded run's launch counts."""
    import torch
    runs = {}
    for n in (1, tp):
        eng = _tp_engine(model, n, device, devices=devices, **kw)
        # a short warm-up run first: the first calls' library loads and
        # allocations stay out of the timed run
        eng.add_request(prompts[0][:8], max_new_tokens=2)
        eng.run()
        s0 = eng.steps
        toks, hidden, counts, plans, wall = _tp_streams(eng, prompts, device)
        runs[n] = dict(tokens=toks, hidden=hidden, counts=counts,
                       plans=plans, wall=wall, steps=eng.steps - s0,
                       moe_shards=eng.g._moe_shards,
                       devices=[str(d) for d in eng.g.devices])
        del eng
        if device == "cuda":
            torch.cuda.empty_cache()
    one, many = runs[1], runs[tp]
    fails = []
    if one["tokens"] != many["tokens"]:
        bad = [i for i, (a, b) in enumerate(zip(one["tokens"],
                                                many["tokens"])) if a != b]
        fails.append(f"tokens differ on streams {bad}")
    hidden_equal = {k: bool(torch.equal(one["hidden"][k], many["hidden"][k]))
                    for k in ("prefill", "decode")}
    if hidden_gate and not all(hidden_equal.values()):
        fails.append(f"final hidden states differ: {hidden_equal}")
    off = {k: (one["counts"][k], many["counts"][k]) for k in one["counts"]
           if many["counts"][k] != tp * one["counts"][k]}
    if off or one["steps"] != many["steps"]:
        fails.append(f"launches not {tp}x tp=1's: {off} (steps "
                     f"{one['steps']} / {many['steps']})")
    splits = {1: {}, tp: {}}
    for n in (1, tp):
        for (T, _h, route, s), _n in runs[n]["plans"].items():
            splits[n].setdefault(f"T{T} {route}", set()).add(s)
    if splits[1] != splits[tp]:
        fails.append(f"split plans differ: tp=1 {splits[1]}, tp={tp} "
                     f"{splits[tp]}")
    if device == "cuda" and not (one["counts"]["attention_split"] +
                                 one["counts"]["attention_int8_split"]):
        fails.append("no launch took the split route")
    rec = dict(tp=tp, devices=many["devices"],
               tokens_equal=one["tokens"] == many["tokens"],
               hidden_equal=hidden_equal, steps=one["steps"],
               moe_shards=many["moe_shards"],
               launches={n: runs[n]["counts"] for n in (1, tp)},
               decode_splits={n: sorted(
                   s for (T, _h, r, s) in runs[n]["plans"]
                   if T == 1 and r == "split") for n in (1, tp)},
               plans={n: {f"T{T} kvh{h} {r} splits {s}": k
                          for (T, h, r, s), k in runs[n]["plans"].items()}
                      for n in (1, tp)},
               tokens_per_s={n: sum(map(len, runs[n]["tokens"])) /
                             runs[n]["wall"] for n in (1, tp)})
    return rec, fails, one["tokens"], many["counts"]


def _tp_decode_timing(model, device, prompts, steps, rounds=3):
    """Decode step wall ms at tp=1 and tp=2 over one model, B 8 at
    ``timed_context`` tokens of context: ``rounds`` unprofiled windows of
    ``steps`` steps a degree, in turn (tp=1, tp=2, tp=1, ...; the median
    reported), then one window each under ``torch.profiler`` for the device
    busy ms, attention ms and idle share (busy over the median wall)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.profile_step import _device_ms
    engs = {}
    for tp in (1, 2):
        eng = _tp_engine(model, tp, device,
                         new_tokens=(rounds + 1) * steps + 8)
        for p in prompts:
            eng.submit(p)
        while eng.waiting or any(
                r is not None and eng.prompt_pos[b] < len(r.prompt)
                for b, r in enumerate(eng.slot_req)):
            eng.step()
        for _ in range(4):
            eng.step()
        engs[tp] = eng
    walls = {1: [], 2: []}
    for _ in range(rounds):
        for tp, eng in engs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            walls[tp].append((time.perf_counter() - t0) * 1e3 / steps)
    out = {}
    for tp, eng in engs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
        by_name = _device_ms(prof)
        busy = sum(by_name.values()) / steps
        attn = sum(v for k, v in by_name.items()
                   if "ragged_paged_attn" in k) / steps
        wall = statistics.median(walls[tp])
        eng.run()
        out[f"tp{tp}"] = dict(decode_wall_ms_per_step=wall,
                              decode_wall_ms_windows=walls[tp],
                              device_busy_ms_per_step=busy or None,
                              attention_ms_per_step=attn if busy else None,
                              device_idle_share=1 - busy / wall
                              if busy else None)
    del engs, eng
    torch.cuda.empty_cache()
    return out


def _tp_feature_waves(model, vocab, device, devices=None):
    """Short waves with the prefix cache, the spill ring and each spec
    mode (K 4) at tp=1 and tp=2: three waves of 4 requests (waves 1 and 3
    share a prefix, wave 2 another) over a pool of one wave's pages + 8,
    so wave 2 spills wave 1's cached pages and wave 3 swaps them back in.
    Gates: tokens equal tp=1's in every wave; prefix tokens saved, spills
    and swap-ins > 0 and equal tp=1's."""
    w = SERVE_TP["waves"]
    waves = _prefix_waves(vocab, w["prefix"], w["tails"], w["requests"],
                          seed=3)
    num_pages = max(_wave_pages(x, w["prefix"], SERVE_TP["page"],
                                w["new_tokens"], w["spec_k"])
                    for x in waves) + 8
    keys = ("prefix_hits", "prefix_tokens_saved", "cow_copies",
            "kv_spilled_pages", "kv_swapins", "spec_steps",
            "spec_committed_tokens")
    rec, fails = {}, []
    for mode in ("ngram", "fused"):
        runs = {}
        for tp in (1, 2):
            eng = _tp_engine(model, tp, device, devices=devices,
                             new_tokens=w["new_tokens"],
                             num_pages=num_pages, prefix_cache=True,
                             kv_spill_pages=w["spill"], spec_decode=mode,
                             spec_k=w["spec_k"])
            outs = []
            for wave in waves:
                rids = [eng.add_request(p) for p in wave]
                res = eng.run()
                outs.append([res[r] for r in rids])
            st = eng.stats()
            runs[tp] = (outs, {k: st[k] for k in keys})
            del eng
        if runs[1][0] != runs[2][0]:
            fails.append(f"{mode}: tokens differ from tp=1's")
        if runs[1][1] != runs[2][1]:
            fails.append(f"{mode}: counters {runs[2][1]} != tp=1's "
                         f"{runs[1][1]}")
        low = [k for k in ("prefix_tokens_saved", "kv_spilled_pages",
                           "kv_swapins", "spec_steps") if runs[2][1][k] <= 0]
        if low:
            fails.append(f"{mode}: {low} are 0 at tp=2 ({runs[2][1]})")
        rec[mode] = dict(tokens_equal=runs[1][0] == runs[2][0],
                         counters=runs[2][1])
    return dict(num_pages=num_pages, **w, runs=rec), fails


def _tp_migration(model, vocab, device, devices=None):
    """A session exported mid-stream at one degree resumes at another
    (through the wire).  Gates: a tp=1 and a tp=2 export of the session at
    the same point have one digest; the joined streams tp=2 -> tp=1, tp=1
    -> tp=2 and tp=2 -> tp=2 equal tp=1 -> tp=1's; the joined 1 -> 1
    stream and the no-fault tp=1 run both pass ``_teacher_force`` against
    the model's full-sequence forward (near-ties as in ``serve_migrate``).
    The resume re-prefills the partial-page tail in a prefill chunk, where
    the no-fault run computed those rows in decode steps, so a bf16 resumed
    stream may part from the no-fault one at a near-tie: how many tokens
    they share is reported."""
    import numpy as np
    from paddle_tpu_torch.inference import migration as mig
    c = SERVE_TP
    prompt = np.random.default_rng(7).integers(
        1, vocab, c["migrate_prompt"]).tolist()
    kw = dict(new_tokens=c["migrate_new_tokens"], prefix_cache=True,
              num_pages=c["migrate_pages"])
    oracle = _tp_engine(model, 1, device, **kw)
    rid = oracle.add_request(prompt)
    want = oracle.run()[rid]
    del oracle
    snaps, wires = {}, {}
    for tp in (2, 1):
        eng = _tp_engine(model, tp, device, devices=devices, **kw)
        req = eng.submit(prompt)
        while len(req.output) < c["migrate_after"]:
            eng.step()
        eng._drain()
        snaps[tp] = mig.export_session(eng, req_id=req.req_id)
        wires[tp] = json.dumps(mig.to_wire(snaps[tp]))
        del eng
    joined = {}
    for src, dst in ((1, 1), (2, 1), (1, 2), (2, 2)):
        b = _tp_engine(model, dst, device, devices=devices, **kw)
        res = mig.import_session(b, mig.from_wire(json.loads(wires[src])),
                                 resume=True)
        joined[f"{src}->{dst}"] = snaps[src]["emitted"] + \
            b.run()[res["resume_req_id"]]
        del b
    fails = []
    if snaps[1]["digest"] != snaps[2]["digest"] or \
            snaps[1]["emitted"] != snaps[2]["emitted"] or \
            wires[1] != wires[2]:
        fails.append("tp=1 and tp=2 exports of one session differ")
    base = joined["1->1"]
    bad = [k for k, v in joined.items() if v != base]
    if bad:
        fails.append(f"resumed streams {bad} differ from 1->1's")
    same = next((i for i, (a, b) in enumerate(zip(base, want)) if a != b),
                min(len(base), len(want)))
    card = lambda ids: model(ids.to(device)).float().cpu()  # noqa: E731
    try:
        checked, near, gaps = _teacher_force(
            "serve_tp migration", card, [("1->1", prompt, base),
                                         ("no-fault", prompt, want)],
            new_tokens=c["migrate_new_tokens"], tie_rel=c["tie_rel"],
            max_tie_share=c["max_tie_share"])
    except AssertionError as e:
        fails.append(str(e))
        checked, near, gaps = None, None, None
    return dict(pages=len(snaps[2]["pages"]), wire_bytes=len(wires[2]),
                tokens_checked=checked, near_ties=near,
                near_tie_rel_gaps=gaps, tie_rel=c["tie_rel"],
                emitted_at_export=len(snaps[2]["emitted"]),
                digest=snaps[2]["digest"],
                digests_equal=snaps[1]["digest"] == snaps[2]["digest"],
                resumed_equal={k: v == base for k, v in joined.items()},
                equals_no_fault=base == want,
                tokens_equal_to_no_fault_before_first_difference=same,
                tokens=len(want)), fails


def _tp_http(eng, prompts, want, max_tokens, vocab):
    """A ``ServingServer`` on the tp=2 engine: 8 streams over HTTP with
    tokens equal to ``want`` (tp=1's); ``/statusz`` advertises tp and pool
    bytes.  Returns the record, failures and the launch counts of the
    streams (counted from 0 just before, read just after)."""
    from paddle_tpu_torch.kernels import grouped_matmul as gm
    from paddle_tpu_torch.serving import ServingServer
    import threading
    srv = ServingServer(eng, model_name="llama2_7b", warmup=True)
    holding = threading.Event()

    def hold(_eng):
        # the engine thread waits here, between steps, until every stream
        # is queued: all are admitted in one step, as in the oracle's run
        holding.set()
        t_end = time.perf_counter() + 60.0
        while srv._inbox.qsize() < len(prompts) and \
                time.perf_counter() < t_end:
            time.sleep(0.001)

    async def go():
        host, port = await srv.start_http("127.0.0.1", 0)
        try:
            while not srv.ready():
                if not srv.engine_alive():
                    raise RuntimeError("engine thread died during warmup")
                await asyncio.sleep(0.05)
            _reset_attn_counts()
            gm.LAUNCHES = gm.LAUNCHES_SM90 = 0
            held = asyncio.get_running_loop().run_in_executor(
                None, srv.run_on_engine, hold, 90.0)
            while not holding.is_set():
                await asyncio.sleep(0.001)
            t0 = time.perf_counter()
            res = await asyncio.gather(*[
                _client(host, port, p, max_tokens) for p in prompts])
            wall = time.perf_counter() - t0
            await held
            counts = _attn_counts()
            counts["gmm"], counts["gmm_sm90"] = gm.LAUNCHES, gm.LAUNCHES_SM90
            return res, wall, counts, srv.statusz()["engine"]
        finally:
            await srv.stop_http()

    res, wall, counts, st = asyncio.run(go())
    fails = []
    got = [r["ids"] for r in res]
    if got != want:
        fails.append("HTTP streams at tp=2 differ from tp=1's tokens: " +
                     str([(i, next(j for j, (a, b) in enumerate(zip(g, w))
                                   if a != b))
                          for i, (g, w) in enumerate(zip(got, want))
                          if g != w]))
    if st["tp"] != 2 or st["pool_bytes"] != eng.g.pool_bytes:
        fails.append(f"/statusz engine tp {st['tp']}, pool_bytes "
                     f"{st['pool_bytes']}")
    _check_streams("serve_tp http", res, max_tokens, vocab)
    ttfts = sorted(r["ttft_s"] for r in res)
    return dict(wall_s=wall, tokens_per_s=sum(map(len, got)) / wall,
                ttft_p50_s=ttfts[len(ttfts) // 2], statusz_tp=st["tp"],
                statusz_pool_bytes=st["pool_bytes"],
                launches=counts), fails, counts


def phase_serve_tp(cfg=None, moe_cfg=None, device="cuda"):
    """Tensor-parallel serving on one card: ONE engine over two shard
    devices, both ``cuda:0``, held against the tp=1 engine over the same
    model.  llama2_7b widths at SERVE_TP's depth (bf16, random weights from
    the seed) at the launcher's geometry, 8 streams (prompts 32-512, 64 new tokens):
    tokens equal, the final hidden states of the first prefill and the first
    decode step ``torch.equal``, every attention launch count exactly 2x
    tp=1's on every route and every tp=2 launch planned with tp=1's split
    count; the same over an int8 pool; the prefix cache with spill and swap-in
    and both spec modes (K 4) in short waves, tokens equal; a session
    exported mid-stream and resumed across degrees equal to the 1->1
    resume, which passes ``_teacher_force`` with the no-fault run, and a
    tp=1 and a tp=2 export of one session with one digest; warm tp=2 steps
    between drains under ``assert_overhead(0, 0)`` and ``torch.cuda.set_sync_debug_mode
    ("error")``; a ``ServingServer`` on the tp=2 engine serving 8 streams
    over HTTP with tp=1's tokens and ``/statusz`` carrying tp 2 and the pool
    bytes.  Then Mixtral widths cut to 4 layers (top-2 of 8 experts,
    grouped): experts sharded (``_moe_shards`` 2), tokens equal, gmm launches
    2x tp=1's and all on sm90; whether the hidden states are equal is
    reported.  Reports tokens/s, decode step ms and idle share at tp=1 and
    tp=2.  Returns the launch counts of the tp=2 runs (bf16 over HTTP, int8,
    Mixtral) in ``phase_serve``'s form."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    c = SERVE_TP
    cuda = device == "cuda"
    cfg = cfg or LlamaConfig.llama2_7b(num_hidden_layers=c["layers"])
    moe_cfg = moe_cfg or LlamaConfig.mixtral_8x7b(
        num_hidden_layers=c["moe_layers"])
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(11)
    lens = [int(x) for x in np.linspace(*c["prompts"], c["requests"])]
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    fails, rec = [], {}
    # the main path at tp=2 against tp=1, bf16 then int8 pools
    rec["bf16"], f, tokens1, _ = _tp_pair("bf16", model, prompts, device)
    fails += [f"bf16: {x}" for x in f]
    rec["int8"], f, _, int8_counts = _tp_pair("int8", model, prompts, device,
                                              cache_dtype="int8")
    fails += [f"int8: {x}" for x in f]
    # warm steps at tp=2: no sync and no build between drains
    eng = _tp_engine(model, 2, device)
    for p in prompts:
        eng.submit(p)
    eng.step()
    rec["steps_checked_without_sync"] = _steps_without_sync(eng, device)
    eng.run()
    del eng
    rec["features"], f = _tp_feature_waves(model, cfg.vocab_size, device)
    fails += [f"features: {x}" for x in f]
    rec["migration"], f = _tp_migration(model, cfg.vocab_size, device)
    fails += [f"migration: {x}" for x in f]
    if cuda:
        timed = [rng.integers(1, cfg.vocab_size, c["timed_context"]).tolist()
                 for _ in range(c["max_batch"])]
        rec["decode_timing"] = _tp_decode_timing(model, device, timed,
                                                 c["timed_steps"])
    eng = _tp_engine(model, 2, device)
    rec["http"], f, http_counts = _tp_http(eng, prompts, tokens1,
                                           c["new_tokens"], cfg.vocab_size)
    fails += [f"http: {x}" for x in f]
    del eng, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    moe = LlamaForCausalLM(moe_cfg, device=device, seed=0)
    rec["moe"], f, _, moe_counts = _tp_pair(
        "moe", moe, prompts, device, hidden_gate=False,
        new_tokens=c["moe_new_tokens"])
    fails += [f"moe: {x}" for x in f]
    shards = rec["moe"]["moe_shards"]
    m1, m2 = rec["moe"]["launches"][1], rec["moe"]["launches"][2]
    if shards != 2 or (cuda and (
            not m1["gmm"] or m2["gmm"] != 2 * m1["gmm"] or
            m1["gmm_sm90"] != m1["gmm"] or m2["gmm_sm90"] != m2["gmm"])):
        fails.append(f"moe: shards {shards}, gmm launches {m1['gmm']} / "
                     f"{m2['gmm']}, on sm90 {m1['gmm_sm90']} / "
                     f"{m2['gmm_sm90']}")
    del moe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    emit("serve_tp", preset="llama2_7b", layers=cfg.num_hidden_layers,
         moe_layers=moe_cfg.num_hidden_layers, devices=["cuda:0", "cuda:0"]
         if cuda else ["cpu", "cpu"], max_batch=c["max_batch"],
         max_seq_len=c["max_seq_len"], page_size=c["page"],
         prefill_bucket=c["bucket"], num_pages=c["num_pages"],
         prompt_lens=lens, new_tokens=c["new_tokens"], **rec,
         phase_s=time.perf_counter() - t_phase,
         max_memory_allocated=torch.cuda.max_memory_allocated()
         if cuda else None,
         nvidia_smi=_nvidia_smi() if cuda else None)
    if fails:
        raise AssertionError("serve_tp: " + "; ".join(fails))
    keys = ("attention", "attention_int8", "gmm", "attention_split",
            "attention_int8_split", "attention_sm90", "attention_int8_sm90",
            "gmm_sm90")
    return {k: http_counts[k] + int8_counts[k] + moe_counts[k] for k in keys}


TP_CARDS = dict(layers=8, moe_layers=4, new_tokens=32)


def tp_cards() -> int:
    """``python3 chip_smoke.py --tp-cards``: tensor-parallel serving with
    its shards on separate cards (a machine with 4).  llama2_7b at full
    width cut to ``TP_CARDS["layers"]`` layers (bf16, random weights from
    the seed), at ``serve_tp``'s geometry and streams: engines over
    ``["cuda:0", "cuda:1"]`` (tp=2; bf16 and int8 pools) and ``"cuda"``
    (tp=4, shard i on ``cuda:i``) held against the tp=1 engine on cuda:0,
    with ``_tp_pair``'s gates (tokens and final hidden states equal,
    launches tp x tp=1's, tp=1's split plans); warm tp=2 steps with no sync
    and no build; the prefix cache, spill ring and both spec modes, and a
    session migrated across degrees, at tp=2 over the two cards; Mixtral
    widths at ``TP_CARDS["moe_layers"]`` layers with the experts over the
    two cards (tokens equal, hidden states reported).  Prints one line and
    a summary line with ``ok``; exits 1 on a failed gate."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    phase_device()
    have = torch.cuda.device_count()
    if have < 4:
        raise SystemExit(f"--tp-cards needs 4 cards, found {have}")
    c, t = SERVE_TP, TP_CARDS
    pair = ["cuda:0", "cuda:1"]
    t_phase = time.perf_counter()
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=t["layers"])
    rng = np.random.default_rng(11)
    lens = [int(x) for x in np.linspace(*c["prompts"], c["requests"])]
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    fails, rec = [], {}
    for name, tp, devs, kw in (
            ("bf16_tp2", 2, pair, {}),
            ("int8_tp2", 2, pair, dict(cache_dtype="int8")),
            ("bf16_tp4", 4, "cuda", {})):
        rec[name], f, _, _ = _tp_pair(name, model, prompts, "cuda", tp=tp,
                                      devices=devs,
                                      new_tokens=t["new_tokens"], **kw)
        fails += [f"{name}: {x}" for x in f]
    eng = _tp_engine(model, 2, "cuda", devices=pair)
    for p in prompts:
        eng.submit(p)
    eng.step()
    rec["steps_checked_without_sync"] = _steps_without_sync(eng, "cuda")
    eng.run()
    del eng
    rec["features"], f = _tp_feature_waves(model, cfg.vocab_size, "cuda",
                                           devices=pair)
    fails += [f"features: {x}" for x in f]
    rec["migration"], f = _tp_migration(model, cfg.vocab_size, "cuda",
                                        devices=pair)
    fails += [f"migration: {x}" for x in f]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    moe = LlamaForCausalLM(LlamaConfig.mixtral_8x7b(
        num_hidden_layers=t["moe_layers"]), device="cuda", seed=0)
    rec["moe_tp2"], f, _, _ = _tp_pair("moe", moe, prompts, "cuda",
                                       hidden_gate=False, devices=pair,
                                       new_tokens=t["new_tokens"])
    fails += [f"moe: {x}" for x in f]
    if rec["moe_tp2"]["moe_shards"] != 2:
        fails.append(f"moe: shards {rec['moe_tp2']['moe_shards']}")
    del moe
    gc.collect()
    emit("tp_cards", preset="llama2_7b", layers=cfg.num_hidden_layers,
         moe_layers=t["moe_layers"], cards=have, prompt_lens=lens,
         new_tokens=t["new_tokens"], **rec,
         phase_s=time.perf_counter() - t_phase,
         max_memory_allocated={
             i: torch.cuda.max_memory_allocated(i) for i in range(have)},
         nvidia_smi=_nvidia_smi(every_card=True), failures=fails)
    print(json.dumps({"ok": not fails, "cards": have}), flush=True)
    return 1 if fails else 0


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
    failed += [f"training shape {f}"
               for f in _flash_timing_failures(timing, train_checks)]
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


def _flash_timing_failures(timing, checks):
    """What ``_flash_timing`` found wrong: an output out of FLASH_TOL
    against its plain version, a kernel launched other than once on "sm90",
    a repeat that is not bit for bit."""
    failed = [f"{k}: {c}" for k, c in checks.items() if not c["ok"]]
    if timing["routes"] != {"fwd": 1, "dq": 1, "dkv": 1, "fwd_sm90": 1,
                            "dq_sm90": 1, "dkv_sm90": 1}:
        failed.append(f"routes: {timing['routes']}")
    failed += [f"{k} not bit for bit on a repeat"
               for k, same in timing["bitwise_repeat"].items() if not same]
    return failed


def _flash_timing(gen, shape=FLASH_TIMED, causal=True):
    """At ``shape`` (default the training shape: b 4, s 2048, 32 heads, d
    128; bf16, ``causal``): each kernel's output against its plain
    version's, then CUDA-event times
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
    b, s, h, d = (shape[x] for x in "bshd")
    q, k, v, g = _flash_case(gen, torch.bfloat16, b, s, s, h, h, d)
    _reset_flash_counts()
    checks = _flash_compare(q, k, v, g, causal, FLASH_TOL["bfloat16"])
    counts = {**_flash_counts(), **_flash_sm90_counts()}
    routes = {key: counts[key] for key in ("fwd", "dq", "dkv", "fwd_sm90",
                                           "dq_sm90", "dkv_sm90")}
    torch.cuda.empty_cache()
    out, lse = fa.flash_forward(q, k, v, causal)
    out2, lse2 = fa.flash_forward(q, k, v, causal)
    fwd_same = {"out": torch.equal(out, out2), "lse": torch.equal(lse, lse2)}
    del out2, lse2
    delta = fa._delta(out, g)
    dq1 = fa._cuda_bwd_dq(q, k, v, g, lse, delta, causal)
    dq2 = fa._cuda_bwd_dq(q, k, v, g, lse, delta, causal)
    dk1, dv1 = fa._cuda_bwd_dkv(q, k, v, g, lse, delta, causal)
    dk2, dv2 = fa._cuda_bwd_dkv(q, k, v, g, lse, delta, causal)
    bitwise = {**fwd_same, "dq": torch.equal(dq1, dq2),
               "dk": torch.equal(dk1, dk2), "dv": torch.equal(dv1, dv2)}
    del dq1, dq2, dk1, dv1, dk2, dv2
    calls = {
        "fwd": (lambda: fa.flash_forward(q, k, v, causal),
                lambda: fa._reference_attention_lse(q, k, v, causal)),
        "dq": (lambda: fa._cuda_bwd_dq(q, k, v, g, lse, delta, causal),
               lambda: fa._flash_bwd_dq(q, k, v, g, lse, delta, causal)),
        "dkv": (lambda: fa._cuda_bwd_dkv(q, k, v, g, lse, delta, causal),
                lambda: fa._flash_bwd_dkv(q, k, v, g, lse, delta, causal)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, gh = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    leaves = [x.clone().requires_grad_() for x in (qh, kh, vh)]
    lib_out = sdpa(*leaves, is_causal=causal)
    lib_err = float((lib_out.detach().transpose(1, 2).float()
                     - out.float()).abs().max())

    def lib_bwd():
        return torch.autograd.grad(lib_out, leaves, gh, retain_graph=True)

    def lib_fwd_bwd():
        o = sdpa(*leaves, is_causal=causal)
        return torch.autograd.grad(o, leaves, gh)

    timing = {"shape": f"b={b} s={s} hq=hkv={h} d={d} bf16 "
                       f"{'causal' if causal else 'full'}",
              "routes": routes, "bitwise_repeat": bitwise,
              "library_max_abs_err_out": lib_err,
              "sdpa_fwd_ms": cuda_ms(
                  lambda: sdpa(qh, kh, vh, is_causal=causal), 20),
              "sdpa_bwd_ms": cuda_ms(lib_bwd, 20),
              "sdpa_fwd_bwd_ms": cuda_ms(lib_fwd_bwd, 20)}
    for which, (kernel, plain) in calls.items():
        t = {}
        for key, fn in (("plain", plain), ("kernel", kernel),
                        ("kernel2", kernel), ("plain2", plain)):
            t[key] = cuda_ms(fn, 3 if key.startswith("plain") else 10)
        b_ms, b_by = _flash_bound_ms(which, b, s, s, h, h, d, causal, 2)
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
    unit = 2 * b * h * d * _causal_pairs(s, s, causal)
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
    """A 1-layer fp32 model at llama2_7b widths (remat full, 4 loss chunks,
    B=2, T=256): the trainer on the card (the flash kernels, cuBLAS fp32
    without TF32) against the same trainer on the CPU (plain versions),
    from one state carried with restore_canonical.

    Tolerances: losses rtol 1e-4; first-step gradients 1e-4 rel + 1e-4 x
    the leaf's largest |grad| (fp32 sums in other orders).  AdamW's first
    update is lr x sign(grad), so an entry whose gradient sits below the
    two devices' rounding noise moves the other way (2 x lr apart); after
    the steps at most PARITY_FAR_SHARE of the parameters may lie further
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
    return _ptxas_of(log, r"tgmm_sm90_kernelILi(\d+)ELb(\d)E",
                     lambda m: f"bn{m.group(1)} cp{m.group(2)}")


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
    ptxas = _tgmm_sm90_ptxas(_build_log(built, "tgmm_sm90"))
    _no_spills("tgmm_sm90 (empty: built before phase_build)", ptxas,
               TGMM_SM90_KERNELS)
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
    MOE_PARITY's B and T): the trainer on the card (the grouped and flash kernels,
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


# ------------------------------------------------- model families ---

def _parity_bad(got, want, tol=PARITY_TOL, floor=0.0):
    """(entries of ``got`` not finite or further from ``want`` than ``tol``
    x |want| + ``tol`` x max |want| + ``floor``: train_parity's gradient
    rule, the largest error)."""
    import torch
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    err = (g - w).abs()
    bad = (err > tol * w.abs() + tol * float(w.abs().max()) + floor) | \
        ~torch.isfinite(g)
    return int(bad.sum()), float(err.nan_to_num(float("inf")).max())


def _flash_launches_check(phase, launches, L, n, sm90, fwd_per_layer=1):
    """``launches`` (counters from 0) must be ``fwd_per_layer`` x L x n
    forwards and L x n of dQ and dK/dV, all on the "sm90" route where
    ``sm90`` (bf16 at d 64/128) and none there otherwise."""
    k = L * n
    want = {"fwd": fwd_per_layer * k, "dq": k, "dkv": k}
    want.update({f"{key}_sm90": v if sm90 else 0 for key, v in want.items()})
    if launches != want:
        raise AssertionError(f"{phase}: flash launches {launches} != {want}")


def _flash_all_counts():
    return {**_flash_counts(), **_flash_sm90_counts()}


def _raise_timing_failures(phase, timing, checks):
    failed = _flash_timing_failures(timing, checks)
    if failed:
        raise AssertionError(f"{phase}: flash timing shape: {failed}")


def _profile_breakdown(fn, wall_ms, top=6, groups=None):
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA): device-busy
    ms, the idle share against ``wall_ms`` (the same work's unprofiled wall
    time), the device kernels launched, the flash kernels' and cuBLAS
    GEMMs' ms, the device ms of the
    kernels inside ``record_function("adam")`` (the DiT trainer's update),
    and the ``top`` kernels by device ms; with ``groups`` ({family: name
    keys}) also the busy ms by family (a kernel in the first family one of
    whose keys its lower-cased name holds, "other" the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.profile_step import (GEMM_NAMES, _device_events,
                                               _device_ms, _range_device_ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = _device_ms(prof)
    busy = sum(by_name.values())
    launches = sum(1 for _ in _device_events(prof, annotations=False))

    def ms(*keys):
        return sum(v for k, v in by_name.items() if any(x in k for x in keys))
    split = None
    if groups:
        split = dict.fromkeys([*groups, "other"], 0.0)
        for name, v in by_name.items():
            low = name.lower()
            split[next((f for f, keys in groups.items()
                        if any(k in low for k in keys)), "other")] += v
    return {"device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "launches": launches,
            "flash_ms": ms("flash_"), "gemm_ms": ms(*GEMM_NAMES),
            "adam_ms": _range_device_ms(prof, "adam"),
            "top_kernels_ms": [[k[:120], v] for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:top]],
            **({"busy_ms_by_op": split} if groups else {})}


def phase_gpt_parity(cfg=None, device="cuda"):
    """gpt2_medium widths at GPT_PARITY's depth, fp32, one set of weights
    on the card (the flash kernels on the "mma" route, cuBLAS fp32) and on
    the CPU (plain versions): logits, loss and every gradient of the loss,
    held by train_parity's rules (loss rtol 1e-4; each entry within 1e-4 x
    |want| + 1e-4 x the tensor's max |want|).  Launches: one forward, dQ
    and dK/dV a layer."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    c = GPT_PARITY
    cfg = cfg or GPTConfig.gpt2_medium(num_hidden_layers=c["layers"],
                                       dtype="float32")
    cpu = GPTForCausalLM(cfg, device="cpu", seed=0)
    card = GPTForCausalLM(cfg, device=device, seed=1)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    B, T = c["batch"], c["seq"]
    ids, labels = (rng.integers(0, cfg.vocab_size, (B, T)) for _ in range(2))
    labels[:, : T // 8] = -100
    _reset_flash_counts()
    out = {}
    for name, m in (("card", card), ("cpu", cpu)):
        logits, loss = m(torch.from_numpy(ids).to(m.device),
                         torch.from_numpy(labels).to(m.device))
        out[name] = (logits.detach(), loss.detach(),
                     torch.autograd.grad(loss, list(m.parameters())))
    launches = _flash_all_counts()
    L = cfg.num_hidden_layers
    if device == "cuda":
        _flash_launches_check("gpt_parity", launches, L, 1, sm90=False)
    logits_bad, logits_err = _parity_bad(out["card"][0], out["cpu"][0])
    np.testing.assert_allclose(float(out["card"][1]), float(out["cpu"][1]),
                               rtol=1e-4)
    grads = {}
    for (n, _), a, w in zip(cpu.named_parameters(), out["card"][2],
                            out["cpu"][2]):
        grads[n] = _parity_bad(a, w)
    bad = {n: g for n, g in grads.items() if g[0]}
    if logits_bad or bad:
        raise AssertionError(f"gpt_parity: logits entries out of tolerance "
                             f"{logits_bad} (max err {logits_err}); "
                             f"gradients {bad}")
    emit("gpt_parity", layers=L, hidden=cfg.hidden_size,
         heads=cfg.num_attention_heads, vocab=cfg.vocab_size, batch=B,
         seq=T, dtype="float32", loss_card=float(out["card"][1]),
         loss_cpu=float(out["cpu"][1]), logits_max_abs_err=logits_err,
         grad_max_abs_err=max(g[1] for g in grads.values()),
         tol=PARITY_TOL, flash_launches=launches,
         nvidia_smi=_nvidia_smi() if device == "cuda" else None)
    del card, cpu, out
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def phase_gpt2(cfg=None, device="cuda"):
    """gpt2_medium at full depth, bf16, GPT2's batch and sequence: one
    warm-up, then GPT2["passes"] timed forward + loss + backward passes
    (the model's ``forward(ids, labels)`` and ``torch.autograd.grad`` over
    every parameter), flash launches counted from 0: one forward, dQ and
    dK/dV a layer a pass, all on "sm90"; losses and gradients finite.
    tokens/s, pass ms, MFU (6 x parameters x tokens/s over the bf16 peak),
    peak memory; then the causal d 64 kernels timed at this shape against
    SDPA and their bound.  Returns (launches, timing)."""
    import math
    import torch
    from paddle_tpu_torch import PEAK_FLOPS
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    c = GPT2
    cfg = cfg or GPTConfig.gpt2_medium()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=device, seed=0)
    params = list(model.parameters())
    gen = torch.Generator(device=model.device).manual_seed(0)
    B, T = c["batch"], c["seq"]
    ids, labels = (torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                                 device=model.device) for _ in range(2))

    def one_pass():
        loss = model(ids, labels)[1]
        return loss, torch.autograd.grad(loss, params)

    losses = [float(one_pass()[0].detach())]
    setup = time.perf_counter() - t0
    _reset_flash_counts()
    seconds = []
    for _ in range(c["passes"]):
        t1 = time.perf_counter()
        loss, grads = one_pass()
        losses.append(float(loss))                # waits for the pass
        seconds.append(time.perf_counter() - t1)
    launches = _flash_all_counts()
    L = cfg.num_hidden_layers
    if cuda:
        _flash_launches_check("gpt2", launches, L, c["passes"], sm90=True)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    if not finite or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"gpt2: losses {losses}, gradients finite "
                             f"{finite}")
    n_params = sum(p.numel() for p in params)
    step_s = sum(seconds) / len(seconds)
    tok_s = B * T / step_s
    result = dict(
        preset="gpt2_medium", layers=L, hidden=cfg.hidden_size,
        heads=cfg.num_attention_heads, head_dim=cfg.head_dim,
        vocab=cfg.vocab_size, params=n_params, batch=B, seq=T,
        dtype=cfg.dtype, setup_and_warmup_s=setup,
        pass_ms_runs=[x * 1e3 for x in seconds], pass_ms=step_s * 1e3,
        tokens_per_s=tok_s,
        mfu_6n=6 * n_params * tok_s / PEAK_FLOPS["bfloat16"] if cuda else None,
        max_memory_allocated=torch.cuda.max_memory_allocated()
        if cuda else None, losses=losses, flash_launches=launches)
    if cuda:
        result["profile"] = _profile_breakdown(one_pass, step_s * 1e3)
    del model, params, grads, ids, labels
    gc.collect()
    timing = None
    if cuda:
        torch.cuda.empty_cache()
        timing, checks = _flash_timing(
            torch.Generator(device="cuda").manual_seed(5),
            dict(b=B, s=T, h=cfg.num_attention_heads, d=cfg.head_dim), True)
        _raise_timing_failures("gpt2", timing, checks)
        result["flash_timing"] = timing
    emit("gpt2", **result, nvidia_smi=_nvidia_smi() if cuda else None)
    return launches, timing


def _dit_perturbed(canon, seed):
    """``canon`` with its zero-initialised parameters (adaLN, final layer)
    set to N(0, 0.02²): the model's output and every gradient are then
    non-trivial from the first step."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def rnd(t):
        return torch.from_numpy(
            (rng.standard_normal(tuple(t.shape)) * 0.02).astype(np.float32))
    p = canon["params"]
    for k in ("final_ada_w", "final_ada_b", "final_head"):
        p[k] = rnd(p[k])
    for k in ("ada_w", "ada_b"):
        p["blocks"][k] = rnd(p["blocks"][k])
    return canon


def phase_dit_parity(cfg=None, device="cuda"):
    """DiT-L/2 widths at 512 px latents (s 1024, d 64) cut to DIT_PARITY's
    depth, fp32, class dropout 0: the trainer on the card (the flash
    kernels on "mma", cuBLAS fp32) against the same trainer on the CPU from
    one carried state (its adaLN-Zero parameters set to random values):
    ``eps_fn``, first-step gradients (train_parity's rules), 3
    ``train_step``s (losses rtol 1e-4; at most PARITY_FAR_SHARE of the
    parameters further apart than 1e-6), then one guided ``ddim_sample``
    from one x_T (each entry within train_parity's rule).  Launches: one
    forward, dQ and dK/dV a layer a step; the sampler two forwards a layer
    a step."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.dit import DiTConfig, DiTTrainStep
    c = DIT_PARITY
    cfg = cfg or DiTConfig.dit_l_2(input_size=c["input_size"],
                                   depth=c["depth"], dtype="float32",
                                   class_dropout_prob=0.0)
    cpu = DiTTrainStep(cfg, device="cpu")
    card = DiTTrainStep(cfg, device=device)
    canon = _dit_perturbed(cpu.canonical_state(cpu.init_state(seed=0)), 1)
    cs, gs = cpu.restore_canonical(canon), card.restore_canonical(canon)
    del canon
    rng = np.random.default_rng(0)
    B, steps, L = c["batch"], c["steps"], cfg.depth
    shape = (B, cfg.in_channels, cfg.input_size, cfg.input_size)
    batch = (rng.standard_normal(shape, dtype=np.float32),
             rng.integers(0, cpu.diffusion.num_timesteps, B),
             rng.integers(0, cfg.num_classes, B),
             rng.standard_normal(shape, dtype=np.float32))
    cb, gb = cpu.shard_batch(*batch), card.shard_batch(*batch)
    with torch.no_grad():
        eps_bad, eps_err = _parity_bad(card.eps_fn(gs["params"], *gb[:3]),
                                       cpu.eps_fn(cs["params"], *cb[:3]))
    _reset_flash_counts()
    g_loss, g_grads = card.loss_and_grads(gs["params"], *gb)
    c_loss, c_grads = cpu.loss_and_grads(cs["params"], *cb)
    np.testing.assert_allclose(float(g_loss), float(c_loss), rtol=1e-4)
    grad = [_parity_bad(a, w) for a, w in zip(g_grads, c_grads)]
    del g_grads, c_grads
    bad = {i: g for i, g in enumerate(grad) if g[0]}
    if eps_bad or bad:
        raise AssertionError(f"dit_parity: eps entries out of tolerance "
                             f"{eps_bad} (max err {eps_err}); gradient "
                             f"leaves {bad}")
    g_losses, c_losses = [], []
    for _ in range(steps):
        gs, gl = card.train_step(gs, *gb)
        cs, cl = cpu.train_step(cs, *cb)
        g_losses.append(float(gl))
        c_losses.append(float(cl))
    launches = _flash_all_counts()
    if device == "cuda":
        _flash_launches_check("dit_parity", launches, L, steps + 1,
                              sm90=False)
    np.testing.assert_allclose(g_losses, c_losses, rtol=1e-4)
    total, far, worst = 0, 0, 0.0
    for a, w in zip(card._leaves(gs["params"]), cpu._leaves(cs["params"])):
        err = (a.detach().cpu() - w.detach()).abs()
        total += err.numel()
        far += int((err > 1e-6).sum())
        worst = max(worst, float(err.max()))
    if far > PARITY_FAR_SHARE * total:
        raise AssertionError(f"dit_parity: {far} of {total} parameters "
                             f"differ by more than 1e-6 (max {worst})")
    x_t = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    y = torch.arange(B) % cfg.num_classes
    _reset_flash_counts()
    samples = {}
    for name, ts, st in (("card", card, gs), ("cpu", cpu, cs)):
        with torch.no_grad():
            samples[name] = ts.diffusion.ddim_sample(
                lambda x, t, yy, ts=ts, p=st["params"]: ts.eps_fn(p, x, t, yy),
                shape, y.to(ts.device), steps=c["sample_steps"],
                guidance_scale=c["guidance"], null_label=cfg.num_classes,
                x_T=x_t)
    sample_launches = _flash_all_counts()
    if device == "cuda" and sample_launches != {
            "fwd": 2 * L * c["sample_steps"], "dq": 0, "dkv": 0,
            "fwd_sm90": 0, "dq_sm90": 0, "dkv_sm90": 0}:
        raise AssertionError(f"dit_parity: sampler launches "
                             f"{sample_launches}")
    s_bad, s_err = _parity_bad(samples["card"], samples["cpu"])
    if s_bad:
        raise AssertionError(f"dit_parity: {s_bad} sample entries out of "
                             f"tolerance (max err {s_err})")
    emit("dit_parity", preset="dit_l_2", input_size=cfg.input_size,
         seq_len=cfg.seq_len, head_dim=cfg.hidden_size // cfg.num_heads,
         depth=L, batch=B, steps=steps, dtype="float32",
         eps_max_abs_err=eps_err, first_step_grad_max_abs_err=max(
             g[1] for g in grad), losses_card=g_losses, losses_cpu=c_losses,
         params_max_abs_err=worst, params_further_than_1e6=far,
         params_total=total, sample_steps=c["sample_steps"],
         guidance=c["guidance"], sample_max_abs_err=s_err,
         sample_max_abs=float(samples["cpu"].abs().max()), tol=PARITY_TOL,
         flash_launches=launches, sampler_flash_launches=sample_launches,
         nvidia_smi=_nvidia_smi() if device == "cuda" else None)
    del gs, cs, card, cpu, samples
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def phase_dit_train(runs=None, sample=None, device="cuda"):
    """Each of DIT_TRAIN's configurations at full depth, bf16, through the
    entry point's ``build_trainer`` and ``run_steps``: 1 warm-up step, then
    DIT_STEPS timed steps with flash launches counted from 0: none where
    ``flash_route`` says the reference runs XLA (DiT-XL/2 at 256 px, d 72),
    one forward (two with remat), dQ and dK/dV a layer a step on "sm90"
    where it says Pallas (DiT-L/2 at 512 px, d 64); losses finite.  Then
    the sampler on DIT_SAMPLE's model: ``dit.sample`` with guidance, two
    forwards a layer a step, output finite.  images/s, MFU, step ms and
    peak memory each; then the full (not causal) d 64 kernels timed at the
    flash configuration's shape against SDPA and the bound.  Returns
    (launches summed over the runs and the sampler, timing)."""
    import math
    import torch
    from paddle_tpu_torch.models import dit
    runs = runs or DIT_TRAIN
    sample = sample or DIT_SAMPLE
    cuda = device == "cuda"
    total = dict.fromkeys(_flash_all_counts(), 0)
    out, timing, flash_shape = {}, None, None
    for name, argv in runs.items():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        args = dit.build_parser().parse_args(argv + ["--device", device])
        t0 = time.perf_counter()
        ts, state, batch = dit.build_trainer(args)
        c = ts.config
        L, d = c.depth, c.hidden_size // c.num_heads
        flash = dit.flash_route(c.seq_len, d)
        state, losses, _ = dit.run_steps(ts, state, batch, 1)
        setup = time.perf_counter() - t0
        _reset_flash_counts()
        state, timed, seconds = dit.run_steps(ts, state, batch, DIT_STEPS)
        launches = _flash_all_counts()
        if cuda:
            _flash_launches_check(f"dit_train {name}", launches, L,
                                  DIT_STEPS if flash else 0, sm90=True,
                                  fwd_per_layer=2 if args.remat else 1)
        losses += timed
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"dit_train {name}: losses {losses}")
        r = dict(preset=args.preset, input_size=c.input_size,
                 seq_len=c.seq_len, head_dim=d, depth=L,
                 hidden=c.hidden_size, params=c.num_params(),
                 batch=args.batch, remat=args.remat, flash_route=flash,
                 setup_and_warmup_s=setup,
                 step_ms_runs=[x * 1e3 for x in seconds],
                 **dit.throughput(ts, batch, seconds), losses=losses,
                 flash_launches=launches)
        if cuda:
            r["profile"] = _profile_breakdown(
                lambda: dit.run_steps(ts, state, batch, 1), r["step_ms"])
        if name == sample["model"]:
            _reset_flash_counts()
            images, s = dit.sample(ts, state, sample["batch"],
                                   sample["steps"], sample["guidance"])
            sampled = _flash_all_counts()
            n = 2 * L * sample["steps"] if flash else 0
            if cuda and sampled != {"fwd": n, "dq": 0, "dkv": 0,
                                    "fwd_sm90": n, "dq_sm90": 0,
                                    "dkv_sm90": 0}:
                raise AssertionError(f"dit_train {name}: sampler launches "
                                     f"{sampled}, want {n} forwards")
            if not bool(torch.isfinite(images).all()):
                raise AssertionError("dit_train: the sampler's output is "
                                     "not finite")
            r["sampler"] = dict(batch=sample["batch"], steps=sample["steps"],
                                guidance=sample["guidance"], seconds=s,
                                images_per_s=sample["batch"] / s,
                                flash_launches=sampled)
            launches = {k: launches[k] + sampled[k] for k in launches}
        total = {k: total[k] + launches[k] for k in total}
        if flash:
            flash_shape = dict(b=args.batch, s=c.seq_len, h=c.num_heads, d=d)
        out[name] = r
        del ts, state, batch
        gc.collect()
    if cuda and flash_shape is not None:
        torch.cuda.empty_cache()
        timing, checks = _flash_timing(
            torch.Generator(device="cuda").manual_seed(6), flash_shape,
            False)
        _raise_timing_failures("dit_train", timing, checks)
    emit("dit_train", runs=out, flash_timing=timing,
         nvidia_smi=_nvidia_smi() if cuda else None)
    return total, timing


def phase_moe_forms(cfg=None, device="cuda"):
    """Mixtral-8x7B widths at MOE_FORMS' depth, bf16, capacity factor 1.25:
    one ``PretrainStep.train_step`` with ``moe_dispatch="gather"`` and one
    with ``"einsum"``, each from the state ``init_state(seed=0)`` makes
    (the same on one card): losses finite, flash launches as for grouped
    (one of each kernel a layer, on "sm90"), no grouped-matmul launch.
    Then the forms as functions over layer 0's weights and one batch of
    N(0, 1) hidden states: einsum at one group against gather in bf16 at
    the configuration's capacity factor and at MOE_FORMS_DROP_CF (y within
    MOE_FORMS_BF16_TOL x (|want| + max |want|), aux and stats within 1e-6,
    whether bit for bit reported), and at a capacity that
    drops nothing (factor E / top_k) both against the grouped form in fp32
    (train_parity's rule).  Returns the flash launches of the two steps."""
    import dataclasses
    import math
    import numpy as np
    import torch
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.pretrain import PretrainStep
    c = MOE_FORMS
    cfg = cfg or llama.LlamaConfig.mixtral_8x7b(
        num_hidden_layers=c["layers"],
        moe_capacity_factor=c["capacity_factor"])
    cuda = device == "cuda"
    rng = np.random.default_rng(0)
    B, T, L = c["batch"], c["seq"], cfg.num_hidden_layers
    ids, labels = (rng.integers(0, cfg.vocab_size, (B, T)) for _ in range(2))
    total = dict.fromkeys(_flash_all_counts(), 0)
    runs, w = {}, None
    for dispatch in ("gather", "einsum"):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ps = PretrainStep(dataclasses.replace(cfg, moe_dispatch=dispatch),
                          device=device)
        state = ps.init_state(seed=0)
        if w is None:
            lp = state["params"]["blocks"][0]
            w = [lp[f"mlp.{n}"].detach().clone() for n in (
                "gate.weight", "experts_gate", "experts_up", "experts_down")]
        ids_t, labels_t = ps.shard_batch(ids, labels)
        _reset_flash_counts()
        _reset_grouped_counts()
        t0 = time.perf_counter()
        state, loss = ps.train_step(state, ids_t, labels_t)
        loss = float(loss)
        seconds = time.perf_counter() - t0
        launches = _flash_all_counts()
        grouped = _grouped_counts()
        if cuda:
            _flash_launches_check(f"moe_forms {dispatch}", launches, L, 1,
                                  sm90=True)
        if any(grouped.values()):
            raise AssertionError(f"moe_forms {dispatch}: grouped-matmul "
                                 f"launches {grouped}")
        if not math.isfinite(loss):
            raise AssertionError(f"moe_forms {dispatch}: loss {loss}")
        runs[dispatch] = dict(loss=loss, step_s=seconds,
                              router_stats=ps.router_stats(state, ids_t),
                              max_memory_allocated=
                              torch.cuda.max_memory_allocated()
                              if cuda else None, flash_launches=launches)
        total = {k: total[k] + launches[k] for k in total}
        del ps, state, ids_t, labels_t
        gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    H, k, E = cfg.hidden_size, cfg.moe_top_k, cfg.moe_num_experts
    x = torch.randn((B, T, H), generator=torch.Generator(
        device=w[0].device).manual_seed(3), device=w[0].device).to(w[0].dtype)
    cf = cfg.moe_capacity_factor
    g1 = {}
    with torch.no_grad():
        # the configuration's capacity factor, and MOE_FORMS_DROP_CF, where
        # entries drop
        for f in (cf, MOE_FORMS_DROP_CF):
            ya, auxa, sa = llama.moe_mlp_forward(x, *w, top_k=k,
                                                 capacity_factor=f)
            yb, auxb, sb = llama.moe_mlp_forward_einsum(
                x, *w, top_k=k, capacity_factor=f, groups=1)
            tol = MOE_FORMS_BF16_TOL
            err = (yb.float() - ya.float()).abs()
            scale = float(ya.float().abs().max())
            y_bad = int((err > tol * ya.float().abs() + tol * scale).sum())
            np.testing.assert_allclose(float(auxb), float(auxa), rtol=1e-6)
            np.testing.assert_allclose(sb.cpu().numpy(), sa.cpu().numpy(),
                                       rtol=1e-6)
            if y_bad:
                raise AssertionError(
                    f"moe_forms: einsum (one group) against gather at "
                    f"capacity factor {f}: {y_bad} entries out of tolerance "
                    f"(max err {float(err.max())})")
            g1[f"cf_{f}"] = dict(
                y_max_abs_err=float(err.max()), y_max_abs=scale,
                kept_frac=float(sa[0]),
                bitwise=dict(y=torch.equal(ya, yb),
                             aux=torch.equal(auxa, auxb),
                             stats=torch.equal(sa, sb)))
            del ya, yb, err
        w32, x32 = [t.float() for t in w], x.float()
        del w
        y_g = llama.moe_mlp_forward_grouped(x32, *w32, top_k=k,
                                            block_m=cfg.moe_block_m)[0]
        no_drop = {}
        for name, fn, kw in (("gather", llama.moe_mlp_forward, {}),
                             ("einsum", llama.moe_mlp_forward_einsum,
                              dict(groups=1))):
            y, _, st = fn(x32, *w32, top_k=k, capacity_factor=E / k, **kw)
            n_bad, y_err = _parity_bad(y, y_g)
            if n_bad or float(st[0]) != 1.0:
                raise AssertionError(f"moe_forms: {name} without drops "
                                     f"against grouped: {n_bad} entries out "
                                     f"of tolerance (max err {y_err}), "
                                     f"kept_frac {float(st[0])}")
            no_drop[name] = dict(y_max_abs_err=y_err)
            del y
        del w32, x32, y_g
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    emit("moe_forms", preset="mixtral_8x7b", layers=L, hidden=H,
         intermediate=cfg.intermediate_size, experts=E, top_k=k, batch=B,
         seq=T, capacity_factor=cf, dtype=cfg.dtype, runs=runs,
         einsum_one_group_vs_gather=g1, bf16_tol=MOE_FORMS_BF16_TOL,
         no_drop_vs_grouped_fp32=no_drop, tol=PARITY_TOL,
         nvidia_smi=_nvidia_smi() if cuda else None)
    return total


# ---------------------------------------------------- the Paddle API ---

@contextlib.contextmanager
def _paddle_device(device):
    """``paddle_tpu_torch.set_device(device)`` for a block, then the device
    set before it."""
    from paddle_tpu_torch import device as pdev
    old = pdev._current[0]
    pdev.set_device(device)
    try:
        yield
    finally:
        pdev._current[0] = old


def _nn_parity_cases(nn):
    """(name, layer factory, inputs) of every layer of the Paddle-API path
    held in ``nn_parity``: an input is a float shape (it gets a gradient),
    ``("ids", shape, high)`` or ``("labels", shape, classes)`` /
    ``("soft", shape)`` for a loss's second argument."""
    acts = ["ReLU", "ReLU6", "LeakyReLU", "GELU", "Silu", "Swish", "Mish",
            "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink", "Hardshrink",
            "Softshrink", "Hardsigmoid", "Hardswish", "Hardtanh", "ELU",
            "CELU", "SELU", "Softplus", "Softsign", "Softmax", "LogSoftmax",
            "GLU"]
    cases = [(a, (lambda a=a: getattr(nn, a)()), [(8, 64)]) for a in acts]
    cases += [
        ("Maxout", lambda: nn.Maxout(2), [(4, 8, 5)]),
        ("Linear", lambda: nn.Linear(64, 48), [(8, 64)]),
        ("Embedding", lambda: nn.Embedding(100, 16, padding_idx=0),
         [("ids", (4, 12), 100)]),
        ("Identity", lambda: nn.Identity(), [(4, 8)]),
        ("Dropout_eval", lambda: nn.Dropout(0.5).eval(), [(4, 8)]),
        ("Conv2D_stride_groups", lambda: nn.Conv2D(8, 16, 3, stride=2,
                                                   padding=1, groups=2),
         [(2, 8, 17, 17)]),
        ("Conv2D_dilation", lambda: nn.Conv2D(8, 8, 3, padding=2,
                                              dilation=2), [(2, 8, 12, 12)]),
        ("BatchNorm2D_train", lambda: nn.BatchNorm2D(16), [(4, 16, 9, 9)]),
        ("BatchNorm1D_train", lambda: nn.BatchNorm1D(16), [(32, 16)]),
        ("BatchNorm_eval", lambda: nn.BatchNorm(16).eval(),
         [(4, 16, 5, 5)]),
        ("LayerNorm", lambda: nn.LayerNorm(64), [(4, 7, 64)]),
        ("MaxPool2D", lambda: nn.MaxPool2D(3, 2, 1), [(2, 8, 15, 15)]),
        ("AvgPool2D", lambda: nn.AvgPool2D(3, 2, 1), [(2, 8, 15, 15)]),
        ("AdaptiveAvgPool2D", lambda: nn.AdaptiveAvgPool2D((3, 2)),
         [(2, 8, 7, 5)]),
        ("Flatten", lambda: nn.Flatten(), [(2, 3, 4, 5)]),
        ("MultiHeadAttention", lambda: nn.MultiHeadAttention(64, 4),
         [(2, 33, 64)]),
        ("TransformerEncoderLayer", lambda: nn.TransformerEncoderLayer(
            64, 4, 128, dropout=0.0, activation="gelu"), [(2, 33, 64)]),
        ("TransformerEncoder", lambda: nn.TransformerEncoder(
            nn.TransformerEncoderLayer(64, 4, 128, dropout=0.0,
                                       normalize_before=True), 2,
            norm=nn.LayerNorm(64)), [(2, 33, 64)]),
        ("CrossEntropyLoss", lambda: nn.CrossEntropyLoss(ignore_index=1),
         [(32, 10), ("labels", (32,), 10)]),
        ("CrossEntropyLoss_soft", lambda: nn.CrossEntropyLoss(
            soft_label=True), [(32, 10), ("soft", (32, 10))]),
        ("MSELoss", lambda: nn.MSELoss(), [(8, 6), (8, 6)]),
        ("L1Loss", lambda: nn.L1Loss(), [(8, 6), (8, 6)]),
    ]
    return cases


def _nn_parity_inputs(gen, spec):
    import torch
    out = []
    for s in spec:
        if s[0] == "ids":
            out.append(torch.randint(0, s[2], s[1], generator=gen))
        elif s[0] == "labels":
            out.append(torch.randint(0, s[2], s[1], generator=gen))
        elif s[0] == "soft":
            out.append(torch.softmax(torch.randn(s[1], generator=gen), -1))
        else:
            out.append(torch.randn(s, generator=gen))
    return out


def _pass_on(layer, inputs, grad_first_only):
    """``layer(*inputs)`` forward and backward from a cotangent drawn on
    the CPU from a fixed seed: (out, input gradients, parameter
    gradients)."""
    import torch
    leaves = [x.clone().requires_grad_(x.is_floating_point() and
                                       (i == 0 or not grad_first_only))
              for i, x in enumerate(inputs)]
    out = layer(*leaves)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    (out * cot.to(out.device)).sum().backward()
    return (out.detach(), [x.grad for x in leaves if x.requires_grad],
            {n: p.grad for n, p in layer.named_parameters()})


def _resnet_step(c, dev, dtype):
    """One ``resnet50`` train step in ``dtype`` on ``dev`` from the state
    of seed 0 (built on the CPU in fp32, then moved): (loss, gradients,
    state after ``Momentum.step()``)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50
    with _paddle_device("cpu"):
        paddle.seed(0)
        m = resnet50(num_classes=c["resnet_classes"])
    m.to(device=dev, dtype=dtype)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((c["resnet_batch"], 3, c["resnet_px"], c["resnet_px"]),
                    generator=gen)
    y = torch.randint(0, c["resnet_classes"], (c["resnet_batch"],),
                      generator=gen)
    opt = paddle.optimizer.Momentum(0.1, 0.9, parameters=m.parameters(),
                                    weight_decay=1e-4)
    loss = paddle.nn.functional.cross_entropy(m(x.to(dev, dtype)),
                                              y.to(dev))
    loss.backward()
    grads = {n: p.grad.detach().double().cpu()
             for n, p in m.named_parameters()}
    opt.step()
    state = {k: v.double().cpu() for k, v in m.state_dict().items()}
    return float(loss.detach()), grads, state


def _nn_parity_resnet(c, device):
    """One ``resnet50`` train step (B, px from ``c``) on ``device`` against
    the CPU from one state.  In float64 the two must agree to
    RESNET50_FP64_TOL (the same arithmetic).  In float32 a 50-layer
    network's gradient at initialisation is ill-conditioned (the CPU's own
    float32 step is up to ~30% of a tensor's largest entry from its float64
    step), so the card's float32 gradients (then parameters and BatchNorm
    statistics after the step) must be no further from the CPU's float64
    ones than RESNET50_FP32_FACTOR x the CPU's float32 ones, over all
    tensors together (the Frobenius norm of the differences: a tensor
    alone is one draw of rounding noise).  TF32 would miss by ~1000x.
    Returns the readings and what failed."""
    import torch
    runs = {(dev, dt): _resnet_step(c, dev, dt)
            for dev in ("cpu", device)
            for dt in (torch.float64, torch.float32)}
    truth = runs[("cpu", torch.float64)]
    out, failed = {"loss": {f"{d}_{str(t)[6:]}": r[0]
                            for (d, t), r in runs.items()}}, {}
    fp64 = runs[(device, torch.float64)]
    if abs(fp64[0] - truth[0]) > RESNET50_FP64_TOL * abs(truth[0]):
        failed["fp64_loss"] = (fp64[0], truth[0])
    if abs(runs[(device, torch.float32)][0] - truth[0]) > \
            RESNET50_PARITY_TOL * abs(truth[0]):
        failed["fp32_loss"] = (runs[(device, torch.float32)][0], truth[0])
    card32, cpu32 = runs[(device, torch.float32)], runs[("cpu", torch.float32)]
    for group, idx in (("grads", 1), ("state_after_step", 2)):
        worst64, sq_card, sq_cpu = 0.0, 0.0, 0.0
        for n, w in truth[idx].items():
            e64 = float((fp64[idx][n] - w).abs().max())
            worst64 = max(worst64, e64 / max(float(w.abs().max()), 1e-30))
            sq_card += float((card32[idx][n] - w).square().sum())
            sq_cpu += float((cpu32[idx][n] - w).square().sum())
        e_card, e_cpu = math.sqrt(sq_card), math.sqrt(sq_cpu)
        out[group] = {"fp64_max_rel_err": worst64,
                      "fp32_card_err_norm": e_card,
                      "fp32_cpu_err_norm": e_cpu,
                      "fp32_card_over_cpu": e_card / max(e_cpu, 1e-30)}
        if worst64 > RESNET50_FP64_TOL:
            failed[f"resnet50_{group}_fp64"] = worst64
        if not e_card <= RESNET50_FP32_FACTOR * e_cpu:
            failed[f"resnet50_{group}_fp32"] = (e_card, e_cpu)
    return out, failed


def _amp_fp16_step(dev):
    """One ``Momentum`` step of a Linear-GELU-Linear net (64 -> 64 -> 16,
    the state of seed 0) under ``amp.decorate(level="O2",
    dtype="float16")`` and ``auto_cast(level="O2", dtype="float16")``, its
    loss (1e-5 x the mean square of the output: true gradients near 2^-20,
    under fp16's normal range) scaled by ``GradScaler(2^16)``, on ``dev``:
    (whether a gradient was not finite, how many unscaled gradient entries
    are not float32 or differ from a float64 unscale of the scaled fp16
    gradient, {name: fp16 parameter, float32 master, float32 velocity} as
    float64 CPU tensors)."""
    import torch
    import paddle_tpu_torch as paddle
    with _paddle_device("cpu"):
        paddle.seed(0)
        net = paddle.nn.Sequential(paddle.nn.Linear(64, 64),
                                   paddle.nn.GELU(), paddle.nn.Linear(64, 16))
    net.to(device=dev)
    opt = paddle.optimizer.Momentum(0.1, 0.9, parameters=net.parameters())
    net, opt = paddle.amp.decorate(net, opt, level="O2", dtype="float16")
    scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 16)
    x = torch.randn((32, 64), generator=torch.Generator().manual_seed(3))
    with paddle.amp.auto_cast(level="O2", dtype="float16"):
        out = net(x.to(dev))
    loss = out.float().square().mean() * 1e-5
    scaler.scale(loss).backward()
    params = list(net.named_parameters())
    scaled = {n: p.grad.double().cpu() for n, p in params}
    scaler.unscale_(opt)
    inexact = sum(int((paddle.amp.float32_grad(p).double().cpu() !=
                       scaled[n] / scaler.get_loss_scaling()).sum()) +
                  int(paddle.amp.float32_grad(p).dtype != torch.float32)
                  for n, p in params)
    scaler.step(opt)
    state = opt.state_dict()
    got = {}
    for i, (n, p) in enumerate(params):
        got[f"param_{n}"] = p.detach().double().cpu()
        got[f"master_{n}"] = opt._master_weights[id(p)].double().cpu()
        got[f"velocity_{n}"] = state[f"velocity_{i}"].double().cpu()
    return scaler._found_inf, inexact, got


def phase_nn_parity(cfg=None, device="cuda"):
    """The Paddle-API path on ``device`` against itself on the CPU, fp32
    with TF32 off for cuDNN and cuBLAS: every layer of the slice forward
    and backward (outputs, input and parameter gradients; BatchNorm's
    running statistics), one ``resnet50`` train step (loss, every
    gradient, then the parameters and BatchNorm statistics after
    ``Momentum.step()``; ``_nn_parity_resnet``'s rules), and a 2-layer
    ``FusedTransformerEncoderLayer`` stack at s 512, head dim 64 (the flash
    kernels on the card, on the "mma" route in fp32, their plain versions
    on the CPU; launches counted from 0: one of each kernel a layer).
    Entries are held by train_parity's rule at NN_PARITY_TOL, plus
    NN_PARITY_FLOOR for gradients that are zero but for rounding (a key
    projection's bias: softmax ignores a shift common to every key)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import nn as inn
    c = cfg or NN_PARITY
    cuda = device == "cuda"
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    layers, failed = {}, {}
    try:
        for name, make, spec in _nn_parity_cases(paddle.nn):
            built = {}
            for dev in ("cpu", device):
                with _paddle_device(dev):
                    paddle.seed(0)
                    built[dev] = make()
            built[device].set_state_dict(built["cpu"].state_dict())
            inputs = _nn_parity_inputs(gen, spec)
            loss_layer = name.endswith(("Loss", "Loss_soft"))
            got = _pass_on(built[device], [x.to(device) for x in inputs],
                           loss_layer)
            want = _pass_on(built["cpu"], inputs, loss_layer)
            tol = (NN_PARITY_TOL, NN_PARITY_FLOOR)
            checks = {"out": _parity_bad(got[0], want[0], *tol)}
            for i, (g, w) in enumerate(zip(got[1], want[1])):
                checks[f"input_grad_{i}"] = _parity_bad(g, w, *tol)
            for n, w in want[2].items():
                checks[f"grad_{n}"] = _parity_bad(got[2][n], w, *tol)
            for n, b in built["cpu"].named_buffers():
                checks[f"buffer_{n}"] = _parity_bad(
                    dict(built[device].named_buffers())[n], b, *tol)
            layers[name] = max(e for _, e in checks.values())
            bad = {k: v for k, v in checks.items() if v[0]}
            if bad:
                failed[name] = bad
        resnet, resnet_failed = _nn_parity_resnet(c, device)
        failed.update(resnet_failed)
        # an O2 fp16 step with a GradScaler (gradients unscaled into fp32)
        (inf_card, inexact_card, fp16_card), \
            (inf_cpu, inexact_cpu, fp16_cpu) = \
            _amp_fp16_step(device), _amp_fp16_step("cpu")
        # an fp16 parameter may round the other way: one fp16 ulp of room
        # (2^-10 of its largest value, 2^-24 among subnormals)
        amp_fp16 = {k: _parity_bad(
            fp16_card[k], w, NN_PARITY_MASTER_TOL
            if k.startswith("master") else NN_PARITY_FP16_TOL,
            2.0 ** -24 + 2.0 ** -10 * float(w.abs().max())
            if k.startswith("param") else 0.0) for k, w in fp16_cpu.items()}
        failed.update({f"amp_fp16_{k}": v for k, v in amp_fp16.items()
                       if v[0]})
        if inf_card or inf_cpu:
            failed["amp_fp16_found_inf"] = (inf_card, inf_cpu)
        if inexact_card or inexact_cpu:
            failed["amp_fp16_unscale_inexact"] = (inexact_card, inexact_cpu)
        zeros = sum(int(((v == 0) & (fp16_cpu[k] != 0)).sum())
                    for k, v in fp16_card.items() if k.startswith("velocity"))
        if zeros or not all(bool((v != 0).any()) for k, v in fp16_cpu.items()
                            if k.startswith("velocity")):
            failed["amp_fp16_velocity_zeros"] = zeros
        # the fused encoder at a flash shape
        stacks = {}
        for dev in ("cpu", device):
            with _paddle_device(dev):
                paddle.seed(0)
                stacks[dev] = paddle.nn.Sequential(*[
                    inn.FusedTransformerEncoderLayer(
                        c["encoder_width"], c["encoder_heads"],
                        4 * c["encoder_width"], dropout_rate=0.0,
                        attn_dropout_rate=0.0, activation="gelu")
                    for _ in range(c["encoder_layers"])])
        stacks[device].set_state_dict(stacks["cpu"].state_dict())
        x = torch.randn((c["batch"], c["seq"], c["encoder_width"]),
                        generator=gen)
        _reset_flash_counts()
        got = _pass_on(stacks[device], [x.to(device)], False)
        launches = _flash_all_counts()
        want = _pass_on(stacks["cpu"], [x], False)
        tol = (NN_PARITY_TOL, NN_PARITY_FLOOR)
        enc = {"out": _parity_bad(got[0], want[0], *tol),
               "input_grad": _parity_bad(got[1][0], want[1][0], *tol)}
        enc.update({f"grad_{n}": _parity_bad(got[2][n], w, *tol)
                    for n, w in want[2].items()})
        failed.update({f"encoder_{k}": v for k, v in enc.items() if v[0]})
        if cuda:
            _flash_launches_check("nn_parity", launches,
                                  c["encoder_layers"], 1, sm90=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    if failed:
        raise AssertionError(f"nn_parity: out of tolerance (entries, max "
                             f"err): {failed}")
    emit("nn_parity", dtype="float32", tf32=False, tol=NN_PARITY_TOL,
         floor=NN_PARITY_FLOOR, layers_max_abs_err=layers,
         amp_fp16_scaler=dict(
             level="O2", dtype="float16", optimizer="Momentum",
             loss_scale=2.0 ** 16, tol=NN_PARITY_FP16_TOL,
             master_tol=NN_PARITY_MASTER_TOL, unscale_exact=True,
             max_abs_err={k: e for k, (_, e) in amp_fp16.items()}),
         resnet50=dict(batch=c["resnet_batch"], px=c["resnet_px"],
                       classes=c["resnet_classes"],
                       fp64_tol=RESNET50_FP64_TOL,
                       fp32_factor=RESNET50_FP32_FACTOR,
                       loss_rtol=RESNET50_PARITY_TOL, **resnet),
         fused_encoder=dict(layers=c["encoder_layers"],
                            width=c["encoder_width"],
                            heads=c["encoder_heads"], batch=c["batch"],
                            seq=c["seq"], flash_launches=launches,
                            max_abs_err=max(e for _, e in enc.values())),
         nvidia_smi=_nvidia_smi() if cuda else None)


def _train_steps_without_sync(step, n, device):
    """``n`` calls of ``step`` (one training step, returning its loss
    unread) under ``assert_overhead(max_compiles=0, max_syncs=0)`` and, on
    the card, ``torch.cuda.set_sync_debug_mode("error")``: a step that
    builds a kernel, marks a sync or makes a synchronizing CUDA call fails
    the phase.  Returns (losses, seconds a step, host clock around the
    steps and a final synchronize)."""
    import torch
    from paddle_tpu_torch import observability as obs
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.assert_overhead(max_compiles=0, max_syncs=0):
        mode = torch.cuda.get_sync_debug_mode() if cuda else 0
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            losses = [step() for _ in range(n)]
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
    if cuda:
        torch.cuda.synchronize()
    return losses, (time.perf_counter() - t0) / n


def phase_resnet50_train(cfg=None, device="cuda"):
    """ResNet-50 at full width through the Paddle-API training loop:
    ``set_device``, ``vision.models.resnet50``, the forward under
    ``amp.auto_cast(level="O1", dtype="bfloat16")``, ``loss.backward()``,
    ``Momentum.step()`` under a ``CosineAnnealingDecay`` schedule that
    anneals over the run's steps, ``clear_grad()``.  NCHW, random images and labels from a seed, one
    repeated batch: ``warmup`` steps, then ``steps`` timed steps without a
    sync or a build (``_train_steps_without_sync``), the losses read after
    them: finite and falling.  ms a step, images/s, MFU (3 x 4.1 GFLOP an
    image over the bf16 peak), peak memory, and one profiled step's busy
    and idle share and top device kernels."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import PEAK_FLOPS
    from paddle_tpu_torch.vision.models import resnet50
    c = cfg or RESNET50_TRAIN
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _paddle_device(device):
        paddle.seed(0)
        model = resnet50(num_classes=c["classes"])
        sched = paddle.optimizer.lr.CosineAnnealingDecay(
            c["lr"], T_max=c["warmup"] + c["steps"])
        opt = paddle.optimizer.Momentum(
            sched, c["momentum"], parameters=model.parameters(),
            weight_decay=c["weight_decay"])
        x = paddle.randn([c["batch"], 3, c["px"], c["px"]])
        y = paddle.randint(0, c["classes"], [c["batch"]])

    def step():
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = paddle.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.detach()

    warm = [step() for _ in range(c["warmup"])]
    setup = time.perf_counter() - t0
    timed, step_s = _train_steps_without_sync(step, c["steps"], device)
    losses = [float(v) for v in warm + timed]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"resnet50_train: losses {losses}")
    img_s = c["batch"] / step_s
    result = dict(
        model="resnet50", layout="NCHW", batch=c["batch"], px=c["px"],
        classes=c["classes"], amp="O1 bfloat16", optimizer="Momentum",
        lr_schedule="CosineAnnealingDecay", setup_and_warmup_s=setup,
        warmup_steps=c["warmup"], timed_steps=c["steps"],
        steps_checked_without_sync=c["steps"], builds_after_warmup=0,
        step_ms=step_s * 1e3, images_per_s=img_s,
        mfu=3 * RESNET50_GFLOP * 1e9 * img_s / PEAK_FLOPS["bfloat16"]
        if cuda else None,
        max_memory_allocated=torch.cuda.max_memory_allocated()
        if cuda else None, losses=losses)
    if cuda:
        prof = _profile_breakdown(step, step_s * 1e3, top=8)
        prof["busy_share"] = 1 - prof["idle_share"]
        result["profile"] = prof
    _PHASE_RESULTS["resnet50_train"] = dict(
        optimizer="Momentum(0.1, 0.9, weight decay 1e-4)",
        step_ms=result["step_ms"],
        max_memory_allocated=result["max_memory_allocated"],
        busy_share=result.get("profile", {}).get("busy_share"))
    emit("resnet50_train", **result,
         nvidia_smi=_nvidia_smi() if cuda else None)
    del model, opt, x, y
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def _encoder_model(c):
    """``nn.Embedding(vocab, width)``, ``layers`` x
    ``FusedTransformerEncoderLayer(width, heads, ffn, dropout 0.1,
    attention dropout 0, gelu)`` and ``Linear(width, vocab)``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer

    class Encoder(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = paddle.nn.Embedding(c["vocab"], c["width"])
            self.layers = paddle.nn.LayerList([
                FusedTransformerEncoderLayer(
                    c["width"], c["heads"], c["ffn"], dropout_rate=0.1,
                    attn_dropout_rate=0.0, activation="gelu")
                for _ in range(c["layers"])])
            self.head = paddle.nn.Linear(c["width"], c["vocab"])

        def forward(self, ids):
            x = self.embed(ids)
            for layer in self.layers:
                x = layer(x)
            return self.head(x)
    return Encoder()


def phase_encoder_train(cfg=None, device="cuda"):
    """A transformer encoder of ``FusedTransformerEncoderLayer``s at
    ERNIE-3.0-base widths (12 layers, 768 wide, 12 heads of 64, FFN 3072,
    vocabulary 40000), s 512, B 16, token ids from a seed, through the
    Paddle-API loop under ``amp.decorate(level="O2", dtype="bfloat16")``
    and ``auto_cast(level="O2")`` with ``AdamW`` (float32 master weights):
    ``warmup`` steps, then ``steps`` timed steps without a sync or a build,
    the flash launches counted from 0 over them (forward, dQ and dK/dV
    ``layers`` times each a step, all on "sm90"); losses finite.  ms a
    step, tokens/s, MFU (6 x the matmul parameters), peak memory, one
    profiled step (the flash kernels' share of the busy time); then the kernels at this shape (b 16, s 512,
    12 heads, d 64, full, bf16) held against their plain versions and
    timed beside their bound and SDPA (``_flash_timing``).  Returns
    (launches, timing)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import PEAK_FLOPS
    c = cfg or ENCODER_TRAIN
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _paddle_device(device):
        paddle.seed(0)
        model = _encoder_model(c)
        opt = paddle.optimizer.AdamW(c["lr"], parameters=model.parameters(),
                                     weight_decay=0.01)
        model, opt = paddle.amp.decorate(model, opt, level="O2",
                                         dtype="bfloat16")
        ids = paddle.randint(0, c["vocab"], [c["batch"], c["seq"]])
        labels = paddle.randint(0, c["vocab"], [c["batch"] * c["seq"]])

    def step():
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(ids)
            loss = paddle.nn.functional.cross_entropy(
                logits.reshape([-1, c["vocab"]]), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    warm = [step() for _ in range(c["warmup"])]
    setup = time.perf_counter() - t0
    _reset_flash_counts()
    timed, step_s = _train_steps_without_sync(step, c["steps"], device)
    launches = _flash_all_counts()
    if cuda:
        _flash_launches_check("encoder_train", launches, c["layers"],
                              c["steps"], sm90=True)
    losses = [float(v) for v in warm + timed]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"encoder_train: losses {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    tok_s = c["batch"] * c["seq"] / step_s
    result = dict(
        widths="ERNIE-3.0-base", layers=c["layers"], width=c["width"],
        heads=c["heads"], head_dim=c["width"] // c["heads"], ffn=c["ffn"],
        vocab=c["vocab"], params=n_params, batch=c["batch"], seq=c["seq"],
        amp="O2 bfloat16", optimizer="AdamW (fp32 master weights)",
        setup_and_warmup_s=setup, warmup_steps=c["warmup"],
        timed_steps=c["steps"], steps_checked_without_sync=c["steps"],
        builds_after_warmup=0, step_ms=step_s * 1e3, tokens_per_s=tok_s,
        # 6 x the matmul parameters (all but the embedding table) x tokens/s
        mfu_6n=6 * (n_params - c["vocab"] * c["width"]) * tok_s /
        PEAK_FLOPS["bfloat16"] if cuda else None,
        max_memory_allocated=torch.cuda.max_memory_allocated()
        if cuda else None, losses=losses, flash_launches=launches)
    timing = None
    if cuda:
        prof = _profile_breakdown(step, step_s * 1e3, top=8)
        prof["flash_share_of_busy"] = prof["flash_ms"] / \
            prof["device_busy_ms"]
        result["profile"] = prof
    _PHASE_RESULTS["encoder_train"] = dict(
        optimizer="AdamW(1e-4, weight decay 0.01), fp32 masters",
        step_ms=result["step_ms"],
        max_memory_allocated=result["max_memory_allocated"],
        busy_share=1 - prof["idle_share"] if cuda else None)
    if cuda:
        del model, opt, ids, labels
        gc.collect()
        torch.cuda.empty_cache()
        timing, checks = _flash_timing(
            torch.Generator(device="cuda").manual_seed(6),
            dict(b=c["batch"], s=c["seq"], h=c["heads"],
                 d=c["width"] // c["heads"]), causal=False)
        _raise_timing_failures("encoder_train", timing, checks)
        result["flash_timing"] = timing
        result["flash_checks"] = checks
    emit("encoder_train", **result,
         nvidia_smi=_nvidia_smi() if cuda else None)
    return launches, timing


# ------------------------------------------------------ paddle.Model ---

def _hapi_datasets():
    """The synthetic datasets of ``hapi_fit`` (``paddle.io.Dataset``s whose
    samples are numpy arrays, made in the fork workers)."""
    import numpy as np
    from paddle_tpu_torch import io

    class SyntheticImages(io.Dataset):
        """Sample i: a uint8 ``src_px`` x ``src_px`` x 3 image drawn from
        ``default_rng(seed + i)``, random-cropped to ``px``, flipped half
        the time, normalized by the ImageNet mean and std to float32 CHW;
        label ``i % classes``."""

        MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255
        STD = np.array([0.229, 0.224, 0.225], np.float32) * 255

        def __init__(self, n, c, offset=0):
            self.n, self.c, self.offset = n, c, offset

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            c = self.c
            r = np.random.default_rng(c["seed"] + self.offset + i)
            img = r.integers(0, 256, (c["src_px"], c["src_px"], 3),
                             dtype=np.uint8)
            y0, x0 = r.integers(0, c["src_px"] - c["px"] + 1, 2)
            crop = img[y0:y0 + c["px"], x0:x0 + c["px"]]
            if r.integers(0, 2):
                crop = crop[:, ::-1]
            x = (crop.astype(np.float32) - self.MEAN) / self.STD
            return (np.ascontiguousarray(x.transpose(2, 0, 1)),
                    np.int64(i % c["classes"]))

    class SyntheticSentences(io.Dataset):
        """Sample i: ``seq`` token ids drawn from ``default_rng(seed +
        i)``; label ``i % classes``."""

        def __init__(self, n, c, offset=0):
            self.n, self.c, self.offset = n, c, offset

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            c = self.c
            r = np.random.default_rng(c["seed"] + self.offset + i)
            return (r.integers(0, c["vocab"], (c["seq"],), dtype=np.int64),
                    np.int64(i % c["classes"]))

    return SyntheticImages, SyntheticSentences


def _ernie_classifier(c):
    """``_encoder_model``'s embedding and encoder layers, a mean pool over
    the sequence and ``Linear(width, classes)``."""
    import paddle_tpu_torch as paddle
    enc = _encoder_model(c)

    class Classifier(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = enc.embed
            self.layers = enc.layers
            self.head = paddle.nn.Linear(c["width"], c["classes"])

        def forward(self, ids):
            x = self.embed(ids)
            for layer in self.layers:
                x = layer(x)
            return self.head(x.mean(axis=1))
    return Classifier()


def _timed_loader_class():
    """A ``DataLoader`` whose iterators record the host seconds each
    ``__next__`` waited (``waits``, in batch order)."""
    from paddle_tpu_torch import io

    class TimedLoader(io.DataLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.waits = []

        def __iter__(self):
            it = super().__iter__()
            waits = self.waits = []

            def timed():
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    waits.append(time.perf_counter() - t0)
                    yield batch
            return timed()
    return TimedLoader


def _step_clock(warmup, cuda):
    """A ``paddle.callbacks.Callback`` that records, for each training
    step from ``warmup`` on, its host seconds, marked syncs and kernel
    builds, with ``torch.cuda.set_sync_debug_mode("error")`` on from the
    first timed step's start to the last step's end (the loader's
    ``__next__`` between them included): a synchronizing call other than
    ``Model``'s marked reads fails the step."""
    import torch
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.hapi.callbacks import Callback

    class StepClock(Callback):
        def __init__(self):
            super().__init__()
            self.steps, self.window = [], None
            self.mode = 0

        def on_train_batch_begin(self, step, logs=None):
            if step == warmup:
                if cuda:
                    torch.cuda.synchronize()
                    self.mode = torch.cuda.get_sync_debug_mode()
                    torch.cuda.set_sync_debug_mode("error")
                self.window = [time.perf_counter(), None]
            self.t0 = time.perf_counter()
            self.s0, self.c0 = obs.device_syncs(), obs.backend_compiles()

        def on_train_batch_end(self, step, logs=None):
            if step < warmup:
                return
            self.steps.append(dict(
                s=time.perf_counter() - self.t0,
                syncs=obs.device_syncs() - self.s0,
                builds=obs.backend_compiles() - self.c0))
            if step == self.params["steps"] - 1:
                self.window[1] = time.perf_counter()
                self.restore()

        def restore(self):
            if cuda:
                torch.cuda.set_sync_debug_mode(self.mode)
    return StepClock()


def _hapi_fit_part(name, c, model, train, evaluate, predict, cuda,
                   save_dir=None):
    """``model.fit(train, eval_data=evaluate, epochs=1)`` with the step
    clock and the ``LRScheduler`` callback, then ``evaluate`` and
    ``predict(stack_outputs=True)``.  Fails the phase unless every loss is
    finite, every DataLoader iteration was served by the fork workers'
    ring (``io.ITERATORS``) by ``workers`` distinct processes, and every
    timed step marked exactly 1 + len(metrics) syncs and built nothing.
    Returns the readings and the predictions."""
    import os
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io
    clock = _step_clock(c["warmup"], cuda)
    used0 = dict(io.ITERATORS)
    pids = []
    t0 = time.perf_counter()
    try:
        history = model.fit(train, eval_data=evaluate, epochs=1, verbose=0,
                            save_dir=save_dir,
                            callbacks=[clock, paddle.callbacks.LRScheduler()])
    finally:
        clock.restore()
    fit_s = time.perf_counter() - t0
    pids += [train.worker_pids, evaluate.worker_pids]
    waits = train.waits
    logs = model.evaluate(evaluate, verbose=0)
    pids.append(evaluate.worker_pids)
    preds = model.predict(predict, stack_outputs=True)
    pids.append(predict.worker_pids)
    used = {k: io.ITERATORS[k] - used0[k] for k in used0}
    n_metrics = len(model._metrics)
    timed = clock.steps
    bad = {}
    if used != {k: (4 if k == "fork_ring" else 0) for k in used}:
        bad["loader_paths"] = used
        bad["fork_refused"] = [ld.fork_refused
                               for ld in (train, evaluate, predict)]
    if any(len(set(p)) != c["workers"] or os.getpid() in p for p in pids):
        bad["worker_pids"] = pids
    if len(timed) != c["steps"] or \
            any(st["syncs"] != 1 + n_metrics or st["builds"] for st in timed):
        bad["timed_steps"] = timed
    losses = [h["loss"] for h in history] + [logs["eval_loss"]]
    if not all(math.isfinite(v) for v in losses):
        bad["losses"] = losses
    if tuple(preds[0].shape) != (c["predict_batches"] * c["batch"],
                                 c["classes"]) or \
            not bool(torch.isfinite(preds[0]).all()):
        bad["predict"] = tuple(preds[0].shape)
    if bad:
        raise AssertionError(f"hapi_fit {name}: {bad}")
    window = clock.window[1] - clock.window[0]
    # the waits for the timed steps' batches after the first (the first
    # one's came before the window opened)
    in_window = waits[c["warmup"] + 1:c["warmup"] + c["steps"]]
    return dict(
        fit_s=fit_s, step_ms=window / c["steps"] * 1e3,
        compute_ms=sum(st["s"] for st in timed) / len(timed) * 1e3,
        loader_wait_share=sum(in_window) / window,
        loader_wait_ms=[w * 1e3 for w in in_window],
        syncs_per_step=[st["syncs"] for st in timed],
        builds_per_step=[st["builds"] for st in timed],
        worker_pids=pids, loader_paths=used,
        train_logs=history[-1], eval_logs=logs), preds


def _hapi_flash_check(c):
    """The three flash kernels against their plain versions at part (b)'s
    shape (b, s from ``c``, its heads and head dim; fp32, full attention),
    by FLASH_TOL["float32"]: one launch of each on the "mma" route, counted
    from 0 here (after the part's own counts were read).  Raises on a
    miss; returns each output's max abs error, relative error and need."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5)
    d = c["width"] // c["heads"]
    q, k, v, g = _flash_case(gen, torch.float32, c["batch"], c["seq"],
                             c["seq"], c["heads"], c["heads"], d)
    _reset_flash_counts()
    checks = _flash_compare(q, k, v, g, False, FLASH_TOL["float32"])
    routes = _flash_all_counts()
    want = {"fwd": 1, "dq": 1, "dkv": 1,
            "fwd_sm90": 0, "dq_sm90": 0, "dkv_sm90": 0}
    failed = [f"{key}: {ck}" for key, ck in checks.items() if not ck["ok"]]
    if routes != want:
        failed.append(f"launches {routes} != {want}")
    if failed:
        raise AssertionError(f"hapi_fit ernie: flash kernels at b "
                             f"{c['batch']} s {c['seq']} h {c['heads']} d "
                             f"{d} fp32: {failed}")
    return {key: {stat: val for stat, val in ck.items() if stat != "ok"}
            for key, ck in checks.items()}


def phase_hapi_fit(cfg=None, device="cuda"):
    """``paddle.Model`` at full width, fp32, trained by ``fit`` from
    ``DataLoader``s whose ``num_workers`` fork processes move batches
    through the shared-memory ring (``HAPI_FIT``):

    (a) ResNet-50 (224 px, 1000 classes, B 64, NCHW) on synthetic images
        decoded and augmented in the workers, a seeded ``RandomSampler``,
        ``Momentum(0.9, weight decay 1e-4)`` under ``CosineAnnealingDecay``
        with the ``LRScheduler`` callback, ``CrossEntropyLoss`` and
        ``Accuracy(topk=(1, 5))``: ``fit(eval_data=..., epochs=1,
        save_dir=...)``, ``evaluate``, ``predict(stack_outputs=True)``;
        then ``Model.save`` and ``load`` into a fresh model: parameters,
        BatchNorm statistics and optimizer state equal bit for bit, and
        ``predict_batch`` within HAPI_PREDICT_TOL of the saved model's;
    (b) the same loop over an ERNIE-3.0-base-width sentence classifier (s
        512, B 16) with ``AdamW``: the flash forward, dQ and dK/dV counted
        from 0 (12 of each a training step on the fp32 "mma" route, 12
        forwards an evaluated or predicted batch), then each held against
        its plain version at the part's shape (``_hapi_flash_check``).

    Each part: the losses finite, every DataLoader iteration served by the
    fork ring with distinct worker pids, every timed step exactly 1 +
    len(metrics) marked syncs and 0 builds under
    ``torch.cuda.set_sync_debug_mode("error")`` (``_step_clock``).  Prints
    ms a step (host clock, the loader's waits included), images or tokens
    per second, the share of the step spent in the loader's ``__next__``,
    ``os.cpu_count()``, peak memory and one profiled ``train_batch``'s busy
    and idle share.  Returns part (b)'s flash launches."""
    import os
    import tempfile
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import io
    from paddle_tpu_torch.vision.models import resnet50
    cfg = cfg or HAPI_FIT
    cuda = device == "cuda"
    Images, Sentences = _hapi_datasets()
    Loader = _timed_loader_class()
    out = {}

    def loaders(ds_cls, c):
        n_train = (c["warmup"] + c["steps"]) * c["batch"]
        train = Loader(ds_cls(n_train, c), batch_sampler=io.BatchSampler(
            sampler=io.RandomSampler(ds_cls(n_train, c),
                                     generator=c["seed"]),
            batch_size=c["batch"], drop_last=True),
            num_workers=c["workers"])
        evaluate = Loader(ds_cls(c["eval_batches"] * c["batch"], c,
                                 offset=10 ** 6),
                          batch_size=c["batch"], num_workers=c["workers"])
        predict = Loader(ds_cls(c["predict_batches"] * c["batch"], c,
                                offset=2 * 10 ** 6),
                         batch_size=c["batch"], num_workers=c["workers"])
        return train, evaluate, predict

    def profiled(model, batch, step_ms):
        if not cuda:
            return None
        ins, labs = [batch[0]], [batch[1]]
        prof = _profile_breakdown(lambda: model.train_batch(ins, labs),
                                  step_ms, top=6)
        prof["busy_share"] = 1 - prof["idle_share"]
        return prof

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with _paddle_device(device), tempfile.TemporaryDirectory() as tmp:
        # (a) ResNet-50
        c = cfg["resnet50"]
        paddle.seed(0)
        net = resnet50(num_classes=c["classes"])
        steps = c["warmup"] + c["steps"]

        def momentum(params):
            return paddle.optimizer.Momentum(
                paddle.optimizer.lr.CosineAnnealingDecay(c["lr"], T_max=steps),
                c["momentum"], parameters=params,
                weight_decay=c["weight_decay"])
        model = paddle.Model(net).prepare(
            momentum(net.parameters()), paddle.nn.CrossEntropyLoss(),
            paddle.metric.Accuracy(topk=(1, 5)))
        train, evaluate, predict = loaders(Images, c)
        res, preds = _hapi_fit_part("resnet50", c, model, train, evaluate,
                                    predict, cuda,
                                    save_dir=os.path.join(tmp, "ckpt"))
        ckpts = sorted(os.listdir(os.path.join(tmp, "ckpt")))
        # Model.save -> load into a fresh model
        path = os.path.join(tmp, "saved", "resnet50")
        model.save(path)
        paddle.seed(1)
        fresh_net = resnet50(num_classes=c["classes"])
        fresh = paddle.Model(fresh_net).prepare(
            momentum(fresh_net.parameters()), paddle.nn.CrossEntropyLoss(),
            paddle.metric.Accuracy(topk=(1, 5)))
        fresh.load(path)
        unequal = [k for (k, a), b in zip(
            net.state_dict().items(), fresh_net.state_dict().values())
            if not torch.equal(a, b)]
        sa, sb = model._optimizer.state_dict(), fresh._optimizer.state_dict()
        unequal += [k for k in sa if not (
            torch.equal(sa[k], sb[k]) if torch.is_tensor(sa[k])
            else sa[k] == sb.get(k))]
        x, y = next(iter(io.DataLoader(predict.dataset,
                                       batch_size=c["batch"])))
        want = model.predict_batch([x])
        got = fresh.predict_batch([x])
        err = float((got - want).abs().max())
        limit = HAPI_PREDICT_TOL * float(want.abs().max())
        if unequal or not err <= limit:
            raise AssertionError(f"hapi_fit resnet50: save/load unequal "
                                 f"{unequal[:8]}, predict err {err} > "
                                 f"{limit}")
        res.update(
            save_load=dict(bitwise_equal=True, entries=len(sa) + len(
                net.state_dict()), predict_max_abs_err=err,
                predict_tol=HAPI_PREDICT_TOL,
                predict_equal=bool(torch.equal(got, want))),
            checkpoints=ckpts, prediction_rows=int(preds[0].shape[0]),
            images_per_s=c["batch"] / (res["step_ms"] / 1e3),
            profile=profiled(model, (x, y), res["compute_ms"]))
        out["resnet50"] = res
        del model, fresh, net, fresh_net, preds, want, got, x, y
        gc.collect()

        # (b) the ERNIE-base-width sentence classifier
        c = cfg["ernie"]
        paddle.seed(0)
        net = _ernie_classifier(c)
        model = paddle.Model(net).prepare(
            paddle.optimizer.AdamW(c["lr"], parameters=net.parameters(),
                                   weight_decay=0.01),
            paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        train, evaluate, predict = loaders(Sentences, c)
        _reset_flash_counts()
        res, preds = _hapi_fit_part("ernie", c, model, train, evaluate,
                                    predict, cuda)
        launches = _flash_all_counts()
        steps = c["warmup"] + c["steps"]
        # fit's evaluation and evaluate each run eval_batches forwards
        forwards = steps + 2 * c["eval_batches"] + c["predict_batches"]
        want = {"fwd": c["layers"] * forwards, "dq": c["layers"] * steps,
                "dkv": c["layers"] * steps}
        want.update({f"{k}_sm90": 0 for k in list(want)})
        if cuda and launches != want:
            raise AssertionError(f"hapi_fit ernie: flash launches "
                                 f"{launches} != {want}")
        flash_check = _hapi_flash_check(c) if cuda else None
        x, y = next(iter(io.DataLoader(predict.dataset,
                                       batch_size=c["batch"])))
        res.update(tokens_per_s=c["batch"] * c["seq"] /
                   (res["step_ms"] / 1e3),
                   flash_launches=launches, flash_check=flash_check,
                   profile=profiled(model, (x, y), res["compute_ms"]))
        out["ernie"] = res
        del model, net, preds, x, y
        gc.collect()
    for part, res in out.items():
        c = cfg[part]
        emit("hapi_fit", part=part, dtype="float32", batch=c["batch"],
             workers=c["workers"], warmup_steps=c["warmup"],
             timed_steps=c["steps"], cpu_count=os.cpu_count(), **res,
             max_memory_allocated=torch.cuda.max_memory_allocated()
             if cuda else None,
             nvidia_smi=_nvidia_smi() if cuda else None)
    if cuda:
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------ the Paddle-API entry points ---

def _bf16_close(got, want):
    """Max abs error of ``got`` against ``want`` and whether every entry is
    within ``TOL[("out", "bfloat16")]`` (phase_kernel's attention rule)."""
    import torch
    rtol, atol = TOL[("out", "bfloat16")]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


def _incubate_decode(c, device):
    """Part (a): a decode loop written with ``incubate.nn.functional`` at
    Llama-2-7B widths (bf16, ``c["layers"]`` layers, random weights): per
    layer ``fused_rms_norm``, ``fused_linear`` q/k/v,
    ``fused_rotary_position_embedding`` with ``position_ids``, the step's
    K/V written into the layer's pool (``write_kv_pages``),
    ``decode_attention`` over int64 block tables and lengths, ``fused_linear``
    o and the residual, ``fused_rms_norm``, ``swiglu`` of gate and up,
    ``fused_linear`` down.  One warm step (its attention calls recorded),
    ``c["steps"]`` timed steps without a build or a sync, one profiled
    step.  Returns the part's record and its attention launches."""
    import torch
    import paddle_tpu_torch.incubate.nn.functional as IF
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models.llama import _rope_cos_sin
    cuda = device == "cuda"
    H, nh, d, I = c["hidden"], c["heads"], c["head_dim"], c["ffn"]
    L, B, page, steps = c["layers"], c["batch"], c["page"], c["steps"]
    gen = torch.Generator(device=device).manual_seed(c["seed"])

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) *
                scale).bfloat16()
    layers = [dict(ln1=1 + rnd(H, scale=0.1), ln2=1 + rnd(H, scale=0.1),
                   wq=rnd(H, H, scale=H ** -0.5),
                   wk=rnd(H, H, scale=H ** -0.5),
                   wv=rnd(H, H, scale=H ** -0.5),
                   wo=rnd(H, H, scale=H ** -0.5),
                   wg=rnd(H, I, scale=H ** -0.5),
                   wu=rnd(H, I, scale=H ** -0.5),
                   wd=rnd(I, H, scale=I ** -0.5)) for _ in range(L)]
    per = -(-c["max_ctx"] // page)
    pages = B * per + 8
    kc = [rnd(nh, pages, page, d) for _ in range(L)]
    vc = [rnd(nh, pages, page, d) for _ in range(L)]
    # int64, as a Paddle-API tensor is by default
    bt = torch.randperm(pages, generator=gen, device=device)[:B * per] \
        .reshape(B, per)
    # contexts spread up to max_ctx over the warm, timed and profiled steps
    last = c["max_ctx"] - (steps + 2)
    ctx0 = torch.linspace(c["min_ctx"], last, B, device=device).long()
    cos, sin = _rope_cos_sin(c["max_ctx"], d, 10000.0, torch.float32,
                             device=device)
    emb = rnd(steps + 2, B, 1, H)

    def step(h, ctx, record=None):
        pos = ctx[:, None]
        slot = bt.gather(1, (ctx // page)[:, None])[:, 0] * page + ctx % page
        lens = ctx + 1
        for li, w in enumerate(layers):
            x = IF.fused_rms_norm(h, w["ln1"], epsilon=c["eps"])
            q, k, v = (IF.fused_linear(x, w[n]).reshape(B, 1, nh, d)
                       for n in ("wq", "wk", "wv"))
            q, k, _ = IF.fused_rotary_position_embedding(
                q, k, sin=sin, cos=cos, position_ids=pos,
                use_neox_rotary_style=False)
            pa.write_kv_pages(kc[li], vc[li], k[:, 0], v[:, 0], slot)
            attn = IF.decode_attention(q[:, 0], kc[li], vc[li], bt, lens)
            if record is not None:
                record.append(dict(q=q[:, 0].clone(), k=k[:, 0].clone(),
                                   v=v[:, 0].clone(), kc=kc[li].clone(),
                                   vc=vc[li].clone(), lens=lens.clone(),
                                   out=attn.clone()))
            h = h + IF.fused_linear(attn.reshape(B, 1, H), w["wo"])
            x = IF.fused_rms_norm(h, w["ln2"], epsilon=c["eps"])
            h = h + IF.fused_linear(IF.swiglu(IF.fused_linear(x, w["wg"]),
                                              IF.fused_linear(x, w["wu"])),
                                    w["wd"])
        return h

    state = {"i": 1, "ctx": ctx0 + 1}

    def next_step():
        h = step(emb[state["i"]], state["ctx"])
        state["i"] += 1
        state["ctx"] = state["ctx"] + 1
        return h

    _reset_attn_counts()
    record = []
    warm = step(emb[0], ctx0, record)
    if cuda:
        torch.cuda.synchronize()
    outs, sec = _train_steps_without_sync(next_step, steps, device)
    counts = _attn_counts()
    want = {"attention": L * (1 + steps), "attention_split": L * (1 + steps),
            "attention_sm90": 0, "attention_int8": 0,
            "attention_int8_split": 0, "attention_int8_sm90": 0}
    if cuda and counts != want:
        raise AssertionError(f"incubate_paths decode: attention launches "
                             f"{counts} != {want}")
    wall_ms = sec * 1e3
    prof = _profile_breakdown(next_step, wall_ms) if cuda else None
    finite = all(bool(torch.isfinite(h).all()) for h in [warm] + outs)
    # each attention call of the warm step against the plain version on the
    # same operands, and layer 0's against masked_multihead_attention over
    # the same keys in a dense cache
    errs = []
    for r in record:
        plain = pa._reference_paged_attention(
            r["q"], r["kc"], r["vc"], bt.to(torch.int32),
            r["lens"].to(torch.int32))
        errs.append(_bf16_close(r["out"], plain))
    r = record[0]
    S = per * page
    dense = torch.stack([p[:, bt].reshape(nh, B, S, d).transpose(0, 1)
                         for p in (r["kc"], r["vc"])])
    packed = torch.stack([r["q"], r["k"], r["v"]], dim=1).reshape(B, 3 * H)
    mmha, _ = IF.masked_multihead_attention(packed, dense, r["lens"] - 1)
    mmha_err = _bf16_close(mmha, r["out"].reshape(B, H))
    failed = [f"layer {i}: max abs err {e}" for i, (e, ok) in enumerate(errs)
              if not ok]
    if not mmha_err[1]:
        failed.append(f"masked_multihead_attention: max abs err "
                      f"{mmha_err[0]}")
    if not finite:
        failed.append("non-finite hidden state")
    if failed:
        raise AssertionError(f"incubate_paths decode: {failed}")
    res = dict(layers=L, batch=B, steps=steps, page=page,
               contexts=[int(ctx0.min()), int(ctx0.max()) + steps + 2],
               ms_per_step=wall_ms, tokens_per_s=B / sec,
               attention_launches=counts,
               attention_max_abs_err=max(e for e, _ in errs),
               mmha_max_abs_err=mmha_err[0],
               attention_tol=list(TOL[("out", "bfloat16")]),
               builds_in_timed_steps=0, syncs_in_timed_steps=0,
               profile=prof)
    return res, counts


def _doc_starts(c, device):
    """Document-style ``startend_row_indices`` ``[b, 1, s, 1]`` int32 from
    the part's seed: key j is visible to the rows before the end of its
    document, so start[j] > j and every causal row keeps a key."""
    import torch
    gen = torch.Generator().manual_seed(c["seed"])
    s = c["s"]
    rows = []
    for _ in range(c["b"]):
        cuts = (torch.randperm(s - 1, generator=gen)[:c["docs"] - 1] +
                1).sort().values
        ends = torch.cat([cuts, torch.tensor([s])])
        rows.append(ends[torch.searchsorted(ends, torch.arange(s),
                                            right=True)])
    return torch.stack(rows)[:, None, :, None].to(torch.int32).to(device)


def _incubate_flashmask(c, device):
    """Part (b): ``nn.functional.flashmask_attention`` forward and backward
    at row 5m's shape, bf16, causal, document-style indices; the three
    launches counted from 0 (all "sm90" on the card), out and dQ/dK/dV bit
    for bit those of ``flash_attention(attn_mask=<the same mask>,
    causal=True)``, and each kernel against its plain version by
    FLASH_TOL["bfloat16"].  Then one case whose first ``masked_keys`` keys
    are masked for every row, so the first rows have no live key: recorded,
    not gated."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F
    cuda = device == "cuda"
    b, s, h, d = c["b"], c["s"], c["h"], c["d"]
    gen = torch.Generator(device=device).manual_seed(c["seed"])
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen,
                              device=device).bfloat16() for _ in range(4))
    si = _doc_starts(c, device)

    def run(fn):
        a = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*a)
        out.backward(g)
        return [out.detach()] + [t.grad for t in a]
    _reset_flash_counts()
    got = run(lambda *a: F.flashmask_attention(*a, si, causal=True))
    launches = _flash_all_counts()
    want_launches = {key: int(cuda) for key in (
        "fwd", "dq", "dkv", "fwd_sm90", "dq_sm90", "dkv_sm90")}
    rows = torch.arange(s, device=device)[:, None]
    mask = torch.where(rows >= si[..., 0][:, :, None, :], -1e9, 0.0)
    same = run(lambda *a: fa.flash_attention(*a, causal=True,
                                             attn_mask=mask))
    bitwise = [bool(torch.equal(x, y)) for x, y in zip(got, same)]
    checks = _flash_compare(q, k, v, g, True, FLASH_TOL["bfloat16"],
                            mask=mask)
    failed = [f"{key}: {ck}" for key, ck in checks.items() if not ck["ok"]]
    if launches != want_launches:
        failed.append(f"launches {launches} != {want_launches}")
    if not all(bitwise):
        failed.append(f"not bit for bit flash_attention(attn_mask=): "
                      f"{bitwise} (out, dq, dk, dv)")
    if failed:
        raise AssertionError(f"incubate_paths flashmask: {failed}")
    timing = None
    if cuda:
        fwd = cuda_ms(lambda: F.flashmask_attention(q, k, v, si,
                                                    causal=True), 10)
        a = [t.clone().requires_grad_(True) for t in (q, k, v)]
        pair = cuda_ms(lambda: F.flashmask_attention(
            *a, si, causal=True).backward(g), 5)
        timing = dict(fwd_ms=fwd, fwd_bwd_ms=pair,
                      mask_build_ms=cuda_ms(lambda: torch.where(
                          rows >= si[..., 0][:, :, None, :], -1e9, 0.0), 10))
    # the first masked_keys keys masked for every row: rows below
    # masked_keys keep no key (under causal)
    m = c["masked_keys"]
    si_dead = si.clone()
    si_dead[:, :, :m] = 0
    mask_dead = torch.where(rows >= si_dead[..., 0][:, :, None, :], -1e9, 0.0)
    dead = F.flashmask_attention(q, k, v, si_dead, causal=True)[:, :m].float()
    plain = fa._reference_attention(q, k, v, True, mask=mask_dead)[:, :m]
    vf = v.float()
    all_keys = vf.mean(1, keepdim=True)                 # the reference's
    prefix = vf[:, :m].cumsum(1) / torch.arange(
        1, m + 1, device=device)[None, :, None, None]   # keys <= row
    dead_rows = dict(rows=m, finite=bool(torch.isfinite(dead).all()),
                     max_abs_vs_plain=float((dead - plain.float()).abs()
                                            .max()),
                     max_abs_vs_mean_of_all_keys=float(
                         (dead - all_keys).abs().max()),
                     max_abs_vs_mean_of_keys_to_the_row=float(
                         (dead - prefix).abs().max()),
                     plain_vs_mean_of_all_keys=float(
                         (plain.float() - all_keys).abs().max()))
    res = dict(shape=[b, s, h, d], dtype="bfloat16", causal=True,
               docs=c["docs"], launches=launches,
               bitwise_flash_attention_with_mask=True,
               checks={key: {st: val for st, val in ck.items() if st != "ok"}
                       for key, ck in checks.items()},
               tol=FLASH_TOL["bfloat16"], timing=timing,
               fully_masked_rows=dead_rows)
    return res, launches


def _incubate_fused_moe(c, device):
    """Part (c): ``fused_moe`` at Mixtral-8x7B's FFN width, bf16, against
    a per-token routed oracle in fp32 on the same device (each expert over
    the tokens routed to it, fp32 weights, TF32 off) by FUSED_MOE_TOL."""
    import torch
    import torch.nn.functional as TF
    import paddle_tpu_torch.incubate.nn.functional as IF
    cuda = device == "cuda"
    E, k, H, I, N = c["E"], c["k"], c["H"], c["I"], c["tokens"]
    gen = torch.Generator(device=device).manual_seed(c["seed"])

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device) *
                scale).bfloat16()
    x = rnd(1, N, H)
    gw = rnd(H, E, scale=H ** -0.5)
    w1 = rnd(E, H, 2 * I, scale=H ** -0.5)
    w2 = rnd(E, I, H, scale=I ** -0.5)
    y = IF.fused_moe(x, gw, w1, w2, moe_topk=k)
    xf = x.reshape(N, H).float()
    probs = torch.softmax(xf @ gw.float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / topv.sum(-1, keepdim=True)
    oracle = torch.zeros(N, H, device=device)
    for e in range(E):
        tok, slot = (topi == e).nonzero(as_tuple=True)
        h1 = xf[tok] @ w1[e].float()
        o = (TF.silu(h1[:, :I]) * h1[:, I:]) @ w2[e].float()
        oracle.index_add_(0, tok, topv[tok, slot, None] * o)
    got = y.reshape(N, H).float()
    err = (got - oracle).abs()
    rel = float(err.norm() / oracle.norm())
    share = float(err.max() / oracle.abs().max())
    ok = bool(torch.isfinite(got).all()) and rel <= FUSED_MOE_TOL["rel"] \
        and share <= FUSED_MOE_TOL["max_share"]
    if not ok:
        raise AssertionError(f"incubate_paths fused_moe: rel {rel}, max "
                             f"share {share} > {FUSED_MOE_TOL}")
    ms = cuda_ms(lambda: IF.fused_moe(x, gw, w1, w2, moe_topk=k), 3) \
        if cuda else None
    return dict(E=E, k=k, H=H, I=I, tokens=N, dtype="bfloat16", rel=rel,
                max_share=share, tol=FUSED_MOE_TOL, ms=ms,
                tokens_per_expert=torch.bincount(topi.reshape(-1),
                                                 minlength=E).tolist())


def _incubate_moe_layer(c, device):
    """Part (d): ``MoELayer`` training, fp32: a ``GShardGate`` (top k) over
    E experts ``Sequential(Linear(H, I), GELU(), Linear(I, H))``,
    ``c["tokens"]`` tokens, ``c["steps"]`` steps of the port's ``AdamW``
    on an MSE loss plus 0.01 x the aux loss.  Losses finite, every
    expert's and the gate's parameters get a finite gradient in the first
    step, and the "gather" and "einsum" forms give the same output within
    MOE_LAYER_FORMS_TOL of max |out|."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    cuda = device == "cuda"
    E, k, H, I, N = c["E"], c["k"], c["H"], c["I"], c["tokens"]
    with _paddle_device(device):
        paddle.seed(c["seed"])
        moe = MoELayer(H, [nn.Sequential(nn.Linear(H, I), nn.GELU(),
                                         nn.Linear(I, H))
                           for _ in range(E)],
                       gate={"type": "gshard", "top_k": k})
        opt = paddle.optimizer.AdamW(c["lr"], parameters=moe.parameters())
        x, target = paddle.randn([N, H]), paddle.randn([N, H])
        losses, aux, step_ms, missing = [], [], [], []
        for i in range(c["steps"]):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = moe(x)
            loss = torch.nn.functional.mse_loss(y, target) + 0.01 * moe.loss
            loss.backward()
            if i == 0:
                missing = [n for n, p in moe.named_parameters()
                           if p.grad is None or
                           not bool(torch.isfinite(p.grad).all())]
            opt.step()
            opt.clear_grad()
            if cuda:
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.detach()))
            aux.append(float(moe.loss.detach()))
        with torch.no_grad():
            gather = moe(x)
            moe.dispatch = "einsum"
            einsum = moe(x)
            moe.dispatch = "gather"
        forms_err = float((gather - einsum).abs().max() /
                          gather.abs().max())
    failed = []
    if not all(math.isfinite(v) for v in losses + aux):
        failed.append(f"losses {losses}, aux {aux}")
    if missing:
        failed.append(f"no finite gradient: {missing[:8]}")
    if not forms_err <= MOE_LAYER_FORMS_TOL:
        failed.append(f"gather vs einsum {forms_err} > "
                      f"{MOE_LAYER_FORMS_TOL}")
    if failed:
        raise AssertionError(f"incubate_paths moe_layer: {failed}")
    return dict(E=E, k=k, H=H, I=I, tokens=N, dtype="float32",
                capacity=moe._capacity(N), losses=losses, aux_losses=aux,
                step_ms=step_ms, params_with_grad=len(moe.parameters()),
                forms_max_share=forms_err, forms_tol=MOE_LAYER_FORMS_TOL)


def _incubate_quant(c, device):
    """Part (e): quantization at Llama-2-7B's gate width ([m, k] @ [k, n]),
    each call against the same call on a CPU copy: ``llm_int8_linear`` (fp32,
    ``c["outliers"]`` columns above the threshold), ``fp8_linear`` (bf16)
    by INCUBATE_QUANT_TOL, ``fp8_quantize`` with a given scale that
    overflows (NaN where the CPU's reference semantics give NaN, every
    byte equal); then ``PTQ`` on a two-``Linear`` MLP of width
    ``c["ptq_width"]``: calibrate, convert, relative error under
    PTQ_REL_LIMIT."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn
    from paddle_tpu_torch import quantization as Q
    cuda = device == "cuda"
    m, kd, n = c["m"], c["k"], c["n"]
    gen = torch.Generator(device=device).manual_seed(c["seed"])
    x = torch.randn(m, kd, generator=gen, device=device)
    cols = torch.randperm(kd, generator=gen, device=device)[:c["outliers"]]
    x[:, cols] *= 20.0
    w = torch.randn(kd, n, generator=gen, device=device) * kd ** -0.5
    qw, s = Q.weight_quantize(w)
    res, failed = {}, []
    calls = {"llm_int8_linear": (lambda *a: Q.llm_int8_linear(
                 a[0], a[1], weight_scale=a[2]), (x, qw, s)),
             "fp8_linear": (lambda *a: Q.fp8_linear(a[0], a[1]),
                            (x.bfloat16(), w.bfloat16()))}
    for name, (fn, args) in calls.items():
        got = fn(*args)
        want = fn(*(a.cpu() for a in args))
        err = float((got.cpu().float() - want.float()).abs().max() /
                    want.float().abs().max())
        res[name] = dict(max_share=err, tol=INCUBATE_QUANT_TOL[name],
                         ms=cuda_ms(lambda: fn(*args), 20) if cuda else None)
        if not (err <= INCUBATE_QUANT_TOL[name] and
                bool(torch.isfinite(got).all())):
            failed.append(f"{name}: {err} > {INCUBATE_QUANT_TOL[name]}")
    outlier_cols = int((x.abs().amax(0) > 6.0).sum())
    scale = torch.tensor(0.5, device=device)
    v = torch.cat([torch.linspace(-600, 600, 241, device=device),
                   torch.tensor([464.0, 464.1, float("inf")],
                                device=device)]) * 0.5
    got, _ = Q.fp8_quantize(v, scale=scale)
    want, _ = Q.fp8_quantize(v.cpu(), scale=scale.cpu())
    g, wnt = got.cpu().float(), want.float()
    nan_same = bool(torch.equal(g.isnan(), wnt.isnan()))
    bytes_same = bool(torch.equal(got.cpu().view(torch.uint8),
                                  want.view(torch.uint8)))
    res["fp8_overflow"] = dict(values=int(v.numel()),
                               nan=int(wnt.isnan().sum()),
                               nan_equal=nan_same, bytes_equal=bytes_same)
    if not (nan_same and bytes_same and int(wnt.isnan().sum()) > 0):
        failed.append(f"fp8 overflow: {res['fp8_overflow']}")
    W = c["ptq_width"]
    with _paddle_device(device):
        paddle.seed(c["seed"])
        mlp = nn.Sequential(nn.Linear(W, W), nn.ReLU(), nn.Linear(W, W))
        xs = paddle.randn([m, W])
        ref = mlp(xs).detach()
        Q.PTQ(Q.QuantConfig()).quantize(mlp)
        for _ in range(c["calib"]):
            mlp(paddle.randn([m, W]))
        Q.PTQ.convert(mlp)
        out = mlp(xs).detach()
    rel = float((out - ref).abs().max() / ref.abs().max())
    res["ptq"] = dict(width=W, calibration_batches=c["calib"], rel=rel,
                      limit=PTQ_REL_LIMIT)
    if not rel < PTQ_REL_LIMIT:
        failed.append(f"PTQ rel {rel} >= {PTQ_REL_LIMIT}")
    if failed:
        raise AssertionError(f"incubate_paths quant: {failed}")
    res.update(m=m, k=kd, n=n, outlier_columns=outlier_cols)
    return res


def phase_incubate_paths(cfg=None, device="cuda"):
    """The Paddle-API entries that reach the ported kernels, at full width
    (INCUBATE_PATHS): (a) a Llama-2-7B-width decode loop through
    ``incubate.nn.functional`` (``decode_attention`` on the paged kernel's
    "split" route), (b) ``nn.functional.flashmask_attention`` at row 5m's
    shape (the flash kernels' mask mode), (c) ``fused_moe`` at
    Mixtral-8x7B's width, (d) ``MoELayer`` training with a GShard gate,
    (e) ``llm_int8_linear``, the fp8 ops and ``PTQ``.  One line per part;
    returns the paged-attention launches of (a) and the flash launches of
    (b), each counted from 0 around its part."""
    import torch
    cfg = cfg or INCUBATE_PATHS
    cuda = device == "cuda"
    parts = (("decode", _incubate_decode), ("flashmask", _incubate_flashmask),
             ("fused_moe", _incubate_fused_moe),
             ("moe_layer", _incubate_moe_layer), ("quant", _incubate_quant))
    launches = {}
    for part, fn in parts:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        res = fn(cfg[part], device)
        if part in ("decode", "flashmask"):
            res, launches[part] = res
        emit("incubate_paths", part=part, **res,
             max_memory_allocated=torch.cuda.max_memory_allocated()
             if cuda else None,
             nvidia_smi=_nvidia_smi() if cuda else None)
        gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------- the sequence half of nn ---

def _tree_leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def _seq_pass(call, module, inputs, grad_idx):
    """``call(module, *inputs)`` forward, then backward from cotangents
    drawn on the CPU from a fixed seed, one a float output leaf: (the
    outputs, the gradients of ``inputs[i]`` for i in ``grad_idx``, the
    parameter gradients)."""
    import torch
    xs = [x.clone().requires_grad_(i in grad_idx)
          for i, x in enumerate(inputs)]
    outs = _tree_leaves(call(module, *xs))
    gen = torch.Generator().manual_seed(7)
    total = sum((o * torch.randn(o.shape, generator=gen).to(o.device)).sum()
                for o in outs if o.is_floating_point())
    if torch.is_tensor(total) and total.requires_grad:
        total.backward()
    params = dict(module.named_parameters()) \
        if hasattr(module, "named_parameters") else {}
    return ([o.detach() for o in outs], [xs[i].grad for i in grad_idx],
            {n: p.grad for n, p in params.items()})


def _seq_checks(got, want):
    """train_parity's rule at NN_PARITY_TOL (+ NN_PARITY_FLOOR) over every
    output, input gradient and parameter gradient: {entry: (bad, err)}."""
    tol = (NN_PARITY_TOL, NN_PARITY_FLOOR)
    checks = {f"out_{i}": _parity_bad(g, w, *tol)
              for i, (g, w) in enumerate(zip(got[0], want[0]))}
    checks.update({f"input_grad_{i}": _parity_bad(g, w, *tol)
                   for i, (g, w) in enumerate(zip(got[1], want[1]))})
    checks.update({f"grad_{n}": _parity_bad(got[2][n], w, *tol)
                   for n, w in want[2].items() if w is not None})
    if len(got[0]) != len(want[0]) or any(
            g is None for g in got[1]) or set(got[2]) != set(want[2]):
        checks["structure"] = (1, float("inf"))
    return checks


def _seq_fn_cases(c):
    """(name, call(F, *xs), inputs(gen), grad indices) of every function of
    the slice whose value does not depend on a random draw."""
    import torch

    def gen_fns(g):
        """Draws from ``g``: normal, uniform in [lo, hi), integers below
        ``hi``, Bernoulli(0.4) as floats, and +-1."""
        def r(*s):
            return torch.randn(s, generator=g)

        def u(lo, hi, *s):
            return torch.rand(s, generator=g) * (hi - lo) + lo

        def i(hi, *s):
            return torch.randint(0, hi, s, generator=g)

        def b(*s):
            return (torch.rand(s, generator=g) < 0.4).float()

        def pm(*s):
            return torch.where(torch.rand(s, generator=g) < 0.5, -1.0, 1.0)
        return r, u, i, b, pm
    ctc, rt = c["ctc"], c["rnnt"]

    def ctc_in(g):
        r, u, i, b, pm = gen_fns(g)
        lens = torch.linspace(ctc["T"], ctc["T"] // 2, ctc["B"]).long()
        labs = torch.linspace(ctc["L"], 2, ctc["B"]).long()
        return [r(ctc["T"], ctc["B"], ctc["C"]),
                torch.randint(1, ctc["C"], (ctc["B"], ctc["L"]), generator=g),
                lens, labs]

    def rnnt_in(g):
        r, u, i, b, pm = gen_fns(g)
        return [r(rt["B"], rt["T"], rt["U"] + 1, rt["V"]),
                torch.randint(1, rt["V"], (rt["B"], rt["U"]), generator=g),
                torch.linspace(rt["T"], rt["T"] // 2, rt["B"]).long(),
                torch.linspace(rt["U"], 1, rt["B"]).long()]

    def csr(g):
        offs, cols = [], []
        for _ in range(2):
            rows = [torch.sort(torch.randperm(8, generator=g)[
                :int(torch.randint(1, 9, (1,), generator=g))]).values
                for _ in range(8)]
            offs.append(torch.cumsum(torch.tensor(
                [0] + [len(x) for x in rows]), 0))
            cols.append(torch.cat(rows))
        n = max(len(x) for x in cols)
        cols = [torch.nn.functional.pad(x, (0, n - len(x))) for x in cols]
        return [torch.stack(offs).reshape(1, 2, 9).int(),
                torch.stack(cols).reshape(1, 2, n).int()]

    def mk(f):
        return lambda g: f(*gen_fns(g))
    sm = torch.softmax
    return [
        ("nll_loss", lambda F, x, l: F.nll_loss(x, l, ignore_index=1),
         mk(lambda r, u, i, b, pm: [torch.log_softmax(r(16, 10), -1),
                                    i(10, 16)]), [0]),
        ("binary_cross_entropy", lambda F, p, y: F.binary_cross_entropy(p, y),
         mk(lambda r, u, i, b, pm: [u(.05, .95, 16, 8), u(0, 1, 16, 8)]),
         [0]),
        ("binary_cross_entropy_with_logits",
         lambda F, z, y, w, pw: F.binary_cross_entropy_with_logits(
             z, y, w, "mean", pw),
         mk(lambda r, u, i, b, pm: [r(16, 8) * 3, u(0, 1, 16, 8),
                                    u(.5, 2, 8), u(.5, 3, 8)]), [0]),
        ("kl_div", lambda F, x, t: F.kl_div(x, t, "batchmean"),
         mk(lambda r, u, i, b, pm: [torch.log_softmax(r(8, 10), -1),
                                    sm(r(8, 10), -1)]), [0]),
        ("smooth_l1_loss", lambda F, a, y: F.smooth_l1_loss(a, y, delta=0.7),
         mk(lambda r, u, i, b, pm: [r(16, 8), r(16, 8)]), [0, 1]),
        ("huber_loss", lambda F, a, y: F.huber_loss(a, y, 0.7),
         mk(lambda r, u, i, b, pm: [r(16, 8), r(16, 8)]), [0, 1]),
        ("margin_ranking_loss",
         lambda F, a, o, y: F.margin_ranking_loss(a, o, y, 0.1),
         mk(lambda r, u, i, b, pm: [r(32), r(32), pm(32)]), [0, 1]),
        ("cosine_embedding_loss",
         lambda F, a, o, y: F.cosine_embedding_loss(a, o, y, 0.1),
         mk(lambda r, u, i, b, pm: [r(16, 8), r(16, 8), pm(16).long()]),
         [0, 1]),
        ("hinge_embedding_loss", lambda F, a, y: F.hinge_embedding_loss(a, y),
         mk(lambda r, u, i, b, pm: [r(16, 8), pm(16, 8)]), [0]),
        ("soft_margin_loss", lambda F, a, y: F.soft_margin_loss(a, y),
         mk(lambda r, u, i, b, pm: [r(16, 8), pm(16, 8)]), [0]),
        ("multi_label_soft_margin_loss",
         lambda F, a, y: F.multi_label_soft_margin_loss(a, y),
         mk(lambda r, u, i, b, pm: [r(16, 8), b(16, 8)]), [0]),
        ("multi_margin_loss", lambda F, a, y: F.multi_margin_loss(a, y, 2),
         mk(lambda r, u, i, b, pm: [r(16, 8), i(8, 16)]), [0]),
        ("poisson_nll_loss",
         lambda F, a, y: F.poisson_nll_loss(a, y, full=True),
         mk(lambda r, u, i, b, pm: [r(16, 8), i(5, 16, 8).float()]), [0]),
        ("gaussian_nll_loss",
         lambda F, a, y, v: F.gaussian_nll_loss(a, y, v, full=True),
         mk(lambda r, u, i, b, pm: [r(16, 8), r(16, 8), u(.1, 2, 16, 8)]),
         [0, 1, 2]),
        ("triplet_margin_loss",
         lambda F, a, p, n: F.triplet_margin_loss(a, p, n, swap=True),
         mk(lambda r, u, i, b, pm: [r(16, 8), r(16, 8), r(16, 8)]),
         [0, 1, 2]),
        ("triplet_margin_with_distance_loss",
         lambda F, a, p, n: F.triplet_margin_with_distance_loss(
             a, p, n, margin=2.0),
         mk(lambda r, u, i, b, pm: [r(16, 8), r(16, 8), r(16, 8)]),
         [0, 1, 2]),
        ("square_error_cost", lambda F, a, y: F.square_error_cost(a, y),
         mk(lambda r, u, i, b, pm: [r(16, 8), r(16, 8)]), [0, 1]),
        ("log_loss", lambda F, p, y: F.log_loss(p, y),
         mk(lambda r, u, i, b, pm: [u(.05, .95, 16, 1), b(16, 1)]), [0]),
        ("dice_loss", lambda F, a, y: F.dice_loss(a, y),
         mk(lambda r, u, i, b, pm: [sm(r(4, 6, 6, 3), -1),
                                    i(3, 4, 6, 6, 1)]), [0]),
        ("npair_loss", lambda F, a, p, y: F.npair_loss(a, p, y),
         mk(lambda r, u, i, b, pm: [r(12, 8), r(12, 8), i(4, 12)]), [0, 1]),
        ("sigmoid_focal_loss",
         lambda F, z, y, n: F.sigmoid_focal_loss(z, y, n),
         mk(lambda r, u, i, b, pm: [r(16, 8) * 2, b(16, 8),
                                    torch.tensor([4.0])]), [0]),
        ("softmax_with_cross_entropy",
         lambda F, x, y: F.softmax_with_cross_entropy(x, y),
         mk(lambda r, u, i, b, pm: [r(16, 10), i(10, 16, 1)]), [0]),
        ("margin_cross_entropy",
         lambda F, x, y: F.margin_cross_entropy(x, y, 1.0, 0.3, 0.1, 16.0),
         mk(lambda r, u, i, b, pm: [u(-.9, .9, 16, 12), i(12, 16)]), [0]),
        ("hsigmoid_loss",
         lambda F, x, y, w, bb: F.hsigmoid_loss(x, y, 12, w, bb),
         mk(lambda r, u, i, b, pm: [r(16, 8), i(12, 16), r(11, 8), r(11)]),
         [0, 2, 3]),
        ("adaptive_log_softmax_with_loss",
         lambda F, x, y, hw, a1, a2, b1, b2: F.adaptive_log_softmax_with_loss(
             x, y, hw, None, [5, 15, 30], [(a1, a2), (b1, b2)]),
         mk(lambda r, u, i, b, pm: [r(16, 8), i(30, 16), r(7, 8), r(8, 4),
                                    r(4, 10), r(8, 2), r(2, 15)]),
         [0, 2, 3, 4, 5, 6]),
        ("ctc_loss", lambda F, *a: F.ctc_loss(*a), ctc_in, [0]),
        ("rnnt_loss", lambda F, *a: F.rnnt_loss(*a), rnnt_in, [0]),
        ("one_hot", lambda F, x: F.one_hot(x, 10),
         mk(lambda r, u, i, b, pm: [i(11, 16) - 1]), []),
        ("sequence_mask", lambda F, n: F.sequence_mask(n, 10, "float32"),
         mk(lambda r, u, i, b, pm: [i(11, 16)]), []),
        ("label_smooth", lambda F, y: F.label_smooth(y, epsilon=0.2),
         mk(lambda r, u, i, b, pm: [sm(r(8, 10), -1)]), [0]),
        ("edit_distance", lambda F, h, g, hl, rl: F.edit_distance(h, g, hl,
                                                                  rl),
         mk(lambda r, u, i, b, pm: [i(5, 8, 12), i(5, 8, 10), i(13, 8),
                                    i(11, 8)]), []),
        ("gather_tree", lambda F, x, p: F.gather_tree(x, p),
         mk(lambda r, u, i, b, pm: [i(20, 12, 4, 5), i(5, 12, 4, 5)]), []),
        ("normalize", lambda F, x: F.normalize(x),
         mk(lambda r, u, i, b, pm: [r(8, 16)]), [0]),
        ("cosine_similarity", lambda F, a, y: F.cosine_similarity(a, y, -1),
         mk(lambda r, u, i, b, pm: [r(8, 16), r(8, 16)]), [0, 1]),
        ("pairwise_distance", lambda F, a, y: F.pairwise_distance(a, y),
         mk(lambda r, u, i, b, pm: [r(8, 16), r(8, 16)]), [0, 1]),
        ("bilinear", lambda F, a, y, w, bb: F.bilinear(a, y, w, bb),
         mk(lambda r, u, i, b, pm: [r(8, 6), r(8, 7), r(5, 6, 7), r(1, 5)]),
         [0, 1, 2, 3]),
        ("rms_norm", lambda F, x, w: F.rms_norm(x, w),
         mk(lambda r, u, i, b, pm: [r(4, 12, 32), r(32)]), [0, 1]),
        ("swiglu", lambda F, x: F.swiglu(x),
         mk(lambda r, u, i, b, pm: [r(8, 32)]), [0]),
        ("fused_softmax_mask", lambda F, x, m: F.fused_softmax_mask(x, m, 0.5),
         mk(lambda r, u, i, b, pm: [r(2, 4, 16, 16),
                                    (b(2, 1, 16, 16) * -1e4)]), [0]),
        ("fused_softmax_mask_upper_triangle",
         lambda F, x: F.fused_softmax_mask_upper_triangle(x),
         mk(lambda r, u, i, b, pm: [r(2, 4, 16, 16)]), [0]),
        ("sparse_attention",
         lambda F, q, k, v, o, cc: F.sparse_attention(q, k, v, o, cc),
         lambda g: [torch.randn(1, 2, 8, 16, generator=g) for _ in range(3)]
         + csr(g), [0, 1, 2]),
        ("prelu", lambda F, x, w: F.prelu(x, w),
         mk(lambda r, u, i, b, pm: [r(4, 6, 5), u(.1, .5, 6)]), [0, 1]),
        ("rrelu", lambda F, x: F.rrelu(x, training=False),
         mk(lambda r, u, i, b, pm: [r(16, 8)]), [0]),
        ("thresholded_relu", lambda F, x: F.thresholded_relu(x, 0.5),
         mk(lambda r, u, i, b, pm: [r(16, 8)]), [0]),
        ("tanh_shrink", lambda F, x: F.tanh_shrink(x),
         mk(lambda r, u, i, b, pm: [r(16, 8)]), [0]),
    ] + [(name, (lambda F, x, name=name: getattr(F, name)(x * 1.0)),
          mk(lambda r, u, i, b, pm: [r(16, 8)]), [0])
         for name in ("relu_", "elu_", "leaky_relu_", "hardtanh_",
                      "softmax_", "tanh_", "thresholded_relu_")] + [
        (f"{name}_eval", (lambda F, x, name=name: getattr(F, name)(
            x, 0.3, training=False)),
         mk(lambda r, u, i, b, pm: [r(4, 6, 3, 3, 2)]), [0])
        for name in ("alpha_dropout", "feature_alpha_dropout", "dropout2d",
                     "dropout3d")]


def _seq_layer_cases(c, fn_inputs):
    """(name, make(nn), call(layer, *xs), inputs(gen), grad indices) of
    every layer of the slice; a loss layer takes its function's inputs
    (``fn_inputs``)."""
    import torch
    rc = c["rnn"]
    B, Tn, I, H = rc["B"], rc["T"], rc["I"], rc["H"]
    tc = c["transformer"]
    d = tc["d"]

    def seq(g):
        return [torch.randn(B, Tn, I, generator=g),
                torch.randint(1, Tn + 1, (B,), generator=g)]

    def dec_in(g):
        s = tc["tgt"]
        mask = torch.where(torch.ones(s, s, dtype=torch.bool).tril(), 0.0,
                           -1e9)
        return [torch.randn(tc["batch"], s, d, generator=g),
                torch.randn(tc["batch"], tc["src"], d, generator=g), mask]

    def x(*s):
        return lambda g: [torch.randn(s, generator=g)]

    def layer_of(cls, *args, fn=None, **kw):
        return (cls, lambda nn: getattr(nn, cls)(*args, **kw),
                lambda m, *xs: m(*xs), fn_inputs[fn], [0])
    cases = [
        ("SimpleRNNCell", lambda nn: nn.SimpleRNNCell(I, H),
         lambda m, x: m(x), x(B, I), [0]),
        ("LSTMCell", lambda nn: nn.LSTMCell(I, H),
         lambda m, x: m(x), x(B, I), [0]),
        ("GRUCell", lambda nn: nn.GRUCell(I, H), lambda m, x: m(x),
         x(B, I), [0]),
        ("RNN_lstm_lengths", lambda nn: nn.RNN(nn.LSTMCell(I, H)),
         lambda m, x, s: m(x, sequence_length=s), seq, [0]),
        ("BiRNN_gru_lengths",
         lambda nn: nn.BiRNN(nn.GRUCell(I, H), nn.GRUCell(I, H)),
         lambda m, x, s: m(x, sequence_length=s), seq, [0]),
        ("SimpleRNN_2_layers", lambda nn: nn.SimpleRNN(I, H, num_layers=2),
         lambda m, x, s: m(x), seq, [0]),
        ("LSTM_bidirect_2_layers_lengths",
         lambda nn: nn.LSTM(I, H, num_layers=2, direction="bidirect"),
         lambda m, x, s: m(x, sequence_length=s), seq, [0]),
        ("GRU_2_layers_lengths", lambda nn: nn.GRU(I, H, num_layers=2),
         lambda m, x, s: m(x, sequence_length=s), seq, [0]),
        ("TransformerDecoderLayer", lambda nn: nn.TransformerDecoderLayer(
            d, tc["heads"], tc["ffn"], dropout=0.0),
         lambda m, t, mem, msk: m(t, mem, tgt_mask=msk), dec_in, [0, 1]),
        ("TransformerDecoder", lambda nn: nn.TransformerDecoder(
            nn.TransformerDecoderLayer(d, tc["heads"], tc["ffn"],
                                       dropout=0.0, normalize_before=True),
            2, norm=nn.LayerNorm(d)),
         lambda m, t, mem, msk: m(t, mem, tgt_mask=msk), dec_in, [0, 1]),
        ("Transformer", lambda nn: nn.Transformer(
            d, tc["heads"], 2, 2, tc["ffn"], dropout=0.0),
         lambda m, t, mem, msk: m(mem, t, tgt_mask=msk), dec_in, [0, 1]),
        layer_of("NLLLoss", fn="nll_loss"),
        layer_of("BCELoss", fn="binary_cross_entropy"),
        ("BCEWithLogitsLoss", lambda nn: nn.BCEWithLogitsLoss(),
         lambda m, z, y, w, pw: m(z, y),
         fn_inputs["binary_cross_entropy_with_logits"], [0]),
        layer_of("KLDivLoss", "batchmean", fn="kl_div"),
        layer_of("SmoothL1Loss", fn="smooth_l1_loss"),
        layer_of("MarginRankingLoss", 0.1, fn="margin_ranking_loss"),
        layer_of("CTCLoss", fn="ctc_loss"),
        layer_of("RNNTLoss", fn="rnnt_loss"),
        layer_of("CosineEmbeddingLoss", fn="cosine_embedding_loss"),
        layer_of("HingeEmbeddingLoss", fn="hinge_embedding_loss"),
        layer_of("MultiLabelSoftMarginLoss",
                 fn="multi_label_soft_margin_loss"),
        layer_of("MultiMarginLoss", fn="multi_margin_loss"),
        layer_of("PoissonNLLLoss", fn="poisson_nll_loss"),
        layer_of("GaussianNLLLoss", fn="gaussian_nll_loss"),
        layer_of("SoftMarginLoss", fn="soft_margin_loss"),
        layer_of("TripletMarginLoss", fn="triplet_margin_loss"),
        layer_of("TripletMarginWithDistanceLoss",
                 fn="triplet_margin_with_distance_loss"),
        ("HSigmoidLoss", lambda nn: nn.HSigmoidLoss(8, 12),
         lambda m, x, y, w, b: m(x, y), fn_inputs["hsigmoid_loss"], [0]),
        ("AdaptiveLogSoftmaxWithLoss",
         lambda nn: nn.AdaptiveLogSoftmaxWithLoss(8, 30, [5, 15]),
         lambda m, x, y, *w: m(x, y),
         fn_inputs["adaptive_log_softmax_with_loss"], [0]),
        layer_of("CosineSimilarity", axis=-1, fn="cosine_similarity"),
        layer_of("PairwiseDistance", fn="pairwise_distance"),
        ("PReLU", lambda nn: nn.PReLU(6), lambda m, x: m(x),
         x(4, 6, 5), [0]),
        ("RReLU", lambda nn: nn.RReLU().eval(), lambda m, x: m(x),
         x(16, 8), [0]),
        ("ThresholdedReLU", lambda nn: nn.ThresholdedReLU(0.3),
         lambda m, x: m(x), x(16, 8), [0]),
        ("Softmax2D", lambda nn: nn.Softmax2D(), lambda m, x: m(x),
         x(2, 5, 4, 4), [0]),
        ("RMSNorm", lambda nn: nn.RMSNorm(32), lambda m, x: m(x),
         x(4, 12, 32), [0]),
        ("Bilinear", lambda nn: nn.Bilinear(6, 7, 5),
         lambda m, a, y: m(a, y),
         lambda g: [torch.randn(8, 6, generator=g),
                    torch.randn(8, 7, generator=g)], [0, 1]),
        ("Unflatten", lambda nn: nn.Unflatten(1, [4, 3]), lambda m, x: m(x),
         x(4, 12, 2), [0]),
        ("LayerDict", lambda nn: nn.LayerDict({"a": nn.Linear(8, 4)}),
         lambda m, x: m["a"](x), x(16, 8), [0]),
        ("ParameterDict", lambda nn: nn.ParameterDict(
            {"w": nn.Linear(8, 4).weight}), lambda m, x: x @ m["w"],
         x(16, 8), [0]),
    ] + [(cls, (lambda nn, cls=cls: getattr(nn, cls)(0.3).eval()),
          lambda m, x: m(x), x(4, 6, 3, 3, 2), [0])
         for cls in ("AlphaDropout", "FeatureAlphaDropout", "Dropout2D",
                     "Dropout3D")]
    return cases


def _seq_random_checks(device):
    """The slice's random draws on ``device`` (a ``torch.Generator`` of the
    card, not the reference's threefry): shape, support and moments."""
    import torch
    import paddle_tpu_torch as paddle
    F = paddle.nn.functional
    paddle.seed(1)
    x = torch.randn(512, 64, generator=torch.Generator().manual_seed(3)) \
        .to(device)
    out = {}
    y = F.rrelu(x, 0.1, 0.3, training=True)
    slope = (y[x < 0] / x[x < 0])
    out["rrelu"] = bool(torch.equal(y[x >= 0], x[x >= 0])) and \
        0.1 - 1e-6 <= float(slope.min()) and float(slope.max()) < 0.3 + 1e-6
    soft = F.gumbel_softmax(x, 0.5)
    hard = F.gumbel_softmax(x, hard=True)
    out["gumbel_softmax"] = bool((soft.sum(-1) - 1).abs().max() < 1e-5) and \
        bool((hard.sum(-1) == 1).all())
    lab = torch.tensor([3, 17, 3, 8, 29, 17], device=device)
    remap, sampled = F.class_center_sample(lab, 40, 10)
    out["class_center_sample"] = bool(torch.equal(sampled[remap], lab)) and \
        len(set(sampled.tolist())) == 10
    z = torch.randn(256, 64, 8, generator=torch.Generator().manual_seed(4)) \
        .to(device)
    for name in ("alpha_dropout", "feature_alpha_dropout"):
        v = getattr(F, name)(z, 0.2)
        out[name] = abs(float(v.mean())) < 0.03 and \
            abs(float(v.var()) - 1) < 0.05
    ones = torch.ones(16, 32, 2, 2, 2, device=device)
    for name, view in (("dropout2d", ones[..., 0]), ("dropout3d", ones)):
        v = getattr(F, name)(view, 0.25).reshape(16, 32, -1)
        out[name] = bool(((v == 0).all(-1) | (v == 1 / 0.75).all(-1)).all())
    return out


def _seq2seq_model(paddle, vocab, d, heads, layers, ffn, dropout, length):
    """Source and target Embeddings over one vocabulary, scaled by sqrt(d),
    plus sinusoidal positions (a non-persistable buffer), ``nn.Transformer``
    and a Linear to the vocabulary."""
    import torch
    nn = paddle.nn
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    i = torch.arange(d)[None, :]
    ang = pos / torch.pow(10000.0, (2 * (i // 2) / d).double())
    table = torch.where(i % 2 == 0, torch.sin(ang), torch.cos(ang)).float()

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embed = nn.Embedding(vocab, d)
            self.tgt_embed = nn.Embedding(vocab, d)
            self.transformer = nn.Transformer(d, heads, layers, layers, ffn,
                                              dropout=dropout)
            self.head = nn.Linear(d, vocab)
            self.register_buffer("pos", table.to(
                self.head.weight.device), persistable=False)
            self.scale = d ** 0.5

        def forward(self, src, tgt, tgt_mask):
            s = self.src_embed(src) * self.scale + self.pos[:src.shape[1]]
            t = self.tgt_embed(tgt) * self.scale + self.pos[:tgt.shape[1]]
            return self.head(self.transformer(s, t, tgt_mask=tgt_mask))
    return Seq2Seq()


def _smoothed_ce(F, logits, labels, vocab, eps):
    """Label-smoothed cross-entropy: ``label_smooth`` of the one-hot
    labels and ``softmax_with_cross_entropy(soft_label=True)``, the mean."""
    soft = F.label_smooth(F.one_hot(labels, vocab), epsilon=eps)
    return F.softmax_with_cross_entropy(logits, soft, soft_label=True).mean()


def _lstm_lm_model(paddle, vocab, hidden, layers, dropout, sparse=False):
    nn = paddle.nn

    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, hidden, sparse=sparse)
            self.rnn = nn.LSTM(hidden, hidden, num_layers=layers,
                               dropout=dropout)
            self.head = nn.Linear(hidden, vocab)

        def forward(self, ids):
            return self.head(self.rnn(self.embed(ids))[0])
    return LM()


def _stack_cell(nn, c1, c2):
    """Two LSTM cells as one cell: ``cell(x, [s1, s2]) -> (h2, [s1',
    s2'])``."""
    class StackCell(nn.Layer):
        def __init__(self):
            super().__init__()
            self.c1, self.c2 = c1, c2

        def forward(self, x, states):
            h1, s1 = self.c1(x, states[0])
            h2, s2 = self.c2(h1, states[1])
            return h2, [s1, s2]
    return StackCell()


def _transformer_adam_step(c, device):
    """One Adam step (NoamDecay) of a 2+2-layer seq2seq Transformer on
    ``device`` and on the CPU from one state, fp32: (checks, parameter
    entries left out as rounding noise)."""
    import torch
    import paddle_tpu_torch as paddle
    tc = c["transformer"]
    models, runs = {}, {}
    gen = torch.Generator().manual_seed(c["seed"] + 1)
    src = torch.randint(0, tc["vocab"], (tc["batch"], tc["src"]),
                        generator=gen)
    tgt = torch.randint(0, tc["vocab"], (tc["batch"], tc["tgt"] + 1),
                        generator=gen)
    for key, dev in (("cpu", "cpu"), ("dev", device)):
        with _paddle_device(dev):
            paddle.seed(0)
            models[key] = _seq2seq_model(paddle, tc["vocab"], tc["d"],
                                         tc["heads"], tc["layers"],
                                         tc["ffn"], 0.0, 64)
    models["dev"].set_state_dict(models["cpu"].state_dict())
    for key, m in models.items():
        dev = "cpu" if key == "cpu" else device
        with _paddle_device(dev):
            sched = paddle.optimizer.lr.NoamDecay(tc["d"], tc["warmup_steps"])
            opt = paddle.optimizer.Adam(sched, 0.9, 0.98, 1e-9,
                                        parameters=m.parameters())
            mask = m.transformer.generate_square_subsequent_mask(tc["tgt"])
            loss = _smoothed_ce(paddle.nn.functional,
                                m(src.to(dev), tgt[:, :-1].to(dev), mask),
                                tgt[:, 1:].to(dev), tc["vocab"], 0.1)
            loss.backward()
            grads = {n: p.grad.detach().clone()
                     for n, p in m.named_parameters()}
            opt.step()
            runs[key] = (loss.detach(), grads,
                         {n: p.detach() for n, p in m.named_parameters()})
    tol = (NN_PARITY_TOL, NN_PARITY_FLOOR)
    (gl, gg, gp), (cl, cg, cp) = runs["dev"], runs["cpu"]
    checks = {"loss": _parity_bad(gl, cl, *tol)}
    checks.update({f"grad_{n}": _parity_bad(gg[n], w, *tol)
                   for n, w in cg.items()})
    left_out = 0
    for n, w in cp.items():
        live = cg[n].abs() >= NN_SEQ_NOISE
        left_out += int((~live & (cg[n] != 0)).sum())
        if bool(live.any()):
            checks[f"param_{n}"] = _parity_bad(gp[n].cpu()[live], w[live],
                                               *tol)
    return checks, left_out


def phase_nn_seq_parity(cfg=None, device="cuda"):
    """The sequence half of ``nn`` on ``device`` against the port on
    the CPU, fp32 with TF32 off: every deterministic function of the slice
    and every layer, forward and backward (outputs, input and parameter
    gradients) by train_parity's rule at NN_PARITY_TOL (+ NN_PARITY_FLOOR),
    among them a bidirectional 2-layer LSTM and a 2-layer GRU with
    ``sequence_length``, ``ctc_loss`` and ``rnnt_loss`` with their
    gradients; ``nn.utils`` (weight norm, spectral norm, the clips); one
    Adam step of a 2+2-layer seq2seq Transformer (parameters held where the
    CPU's gradient is above NN_SEQ_NOISE); the random draws held by shape,
    support and moments on the card."""
    import torch
    import paddle_tpu_torch as paddle
    c = cfg or NN_SEQ_PARITY
    cuda = device == "cuda"
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F = paddle.nn.functional
    errs, failed = {}, {}
    t0 = time.perf_counter()
    try:
        fn_cases = _seq_fn_cases(c)
        fn_inputs = {name: make for name, _, make, _ in fn_cases}
        for k, (name, call, make, grad) in enumerate(fn_cases):
            xs = make(torch.Generator().manual_seed(c["seed"] + k))
            got = _seq_pass(call, F, [x.to(device) for x in xs], grad)
            want = _seq_pass(call, F, xs, grad)
            checks = _seq_checks(got, want)
            errs[name] = max([e for _, e in checks.values()], default=0.0)
            bad = {k2: v for k2, v in checks.items() if v[0]}
            if bad:
                failed[name] = bad
        layer_cases = _seq_layer_cases(c, fn_inputs)
        for k, (name, make, call, inputs, grad) in enumerate(layer_cases):
            built = {}
            for key, dev in (("cpu", "cpu"), ("dev", device)):
                with _paddle_device(dev):
                    paddle.seed(0)
                    built[key] = make(paddle.nn)
            built["dev"].set_state_dict(built["cpu"].state_dict())
            built["dev"].train(built["cpu"].training)
            xs = inputs(torch.Generator().manual_seed(c["seed"] + 500 + k))
            got = _seq_pass(call, built["dev"], [x.to(device) for x in xs],
                            grad)
            want = _seq_pass(call, built["cpu"], xs, grad)
            checks = _seq_checks(got, want)
            errs[name] = max([e for _, e in checks.values()], default=0.0)
            bad = {k2: v for k2, v in checks.items() if v[0]}
            if bad:
                failed[name] = bad
        # nn.utils: a weight-normed and a spectral-normed Linear, the clips
        utils = {}
        for name, wrap in (("weight_norm", lambda m: paddle.nn.utils
                            .weight_norm(m, dim=1)),
                           ("spectral_norm", lambda m: paddle.nn.utils
                            .spectral_norm(m, n_power_iterations=2))):
            built = {}
            for key, dev in (("cpu", "cpu"), ("dev", device)):
                with _paddle_device(dev):
                    paddle.seed(0)
                    built[key] = wrap(paddle.nn.Linear(24, 16))
            built["dev"].set_state_dict(built["cpu"].state_dict())
            xs = [torch.randn(8, 24, generator=torch.Generator()
                              .manual_seed(c["seed"] + 900))]
            call = (lambda m, x: m(x))
            got = _seq_pass(call, built["dev"], [xs[0].to(device)], [0])
            want = _seq_pass(call, built["cpu"], xs, [0])
            utils[name] = _seq_checks(got, want)
            grads = {key: [p.grad for p in m.parameters()]
                     for key, m in built.items()}
            for m in built.values():
                paddle.nn.utils.clip_grad_norm_(m.parameters(), 0.5)
                paddle.nn.utils.clip_grad_value_(m.parameters(), 0.01)
            utils[name].update({f"clipped_{i}": _parity_bad(
                g, grads["cpu"][i], NN_PARITY_TOL, NN_PARITY_FLOOR)
                for i, g in enumerate(grads["dev"])})
            utils[name]["to_vector"] = _parity_bad(
                paddle.nn.utils.parameters_to_vector(
                    built["dev"].parameters()),
                paddle.nn.utils.parameters_to_vector(
                    built["cpu"].parameters()), NN_PARITY_TOL, 0.0)
            if name == "weight_norm":
                for m in built.values():
                    paddle.nn.utils.remove_weight_norm(m)
                utils[name]["removed"] = _parity_bad(
                    built["dev"].weight, built["cpu"].weight,
                    NN_PARITY_TOL, NN_PARITY_FLOOR)
        for name, checks in utils.items():
            errs[name] = max(e for _, e in checks.values())
            bad = {k2: v for k2, v in checks.items() if v[0]}
            if bad:
                failed[name] = bad
        step_checks, left_out = _transformer_adam_step(c, device)
        errs["transformer_adam_step"] = max(e for _, e in
                                            step_checks.values())
        bad = {k2: v for k2, v in step_checks.items() if v[0]}
        if bad:
            failed["transformer_adam_step"] = bad
        random = _seq_random_checks(device)
        failed.update({f"random_{k2}": v for k2, v in random.items()
                       if not v})
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    if failed:
        raise AssertionError(f"nn_seq_parity: out of tolerance (entries, "
                             f"max err): {failed}")
    emit("nn_seq_parity", dtype="float32", tf32=False, tol=NN_PARITY_TOL,
         floor=NN_PARITY_FLOOR, functions=len(fn_cases),
         layers=len(layer_cases), max_abs_err=errs,
         adam_step_noise_entries_left_out=left_out,
         noise=NN_SEQ_NOISE, random_draws=random,
         seconds=time.perf_counter() - t0,
         nvidia_smi=_nvidia_smi() if cuda else None)


def _seq_train_report(name, model, step, c, device, tokens, groups=None):
    """``warmup`` steps, then ``steps`` timed steps without a sync or a build
    (``_train_steps_without_sync``), losses read after them (finite); ms a
    step, tokens/s, and on the card one profiled step's busy and idle share
    and its kernel launches."""
    import torch
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = [step() for _ in range(c["warmup"])]
    if cuda:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    timed, step_s = _train_steps_without_sync(step, c["steps"], device)
    losses = [float(v) for v in warm + timed]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"seq_models {name}: losses {losses}")
    result = dict(warmup_s=warm_s, warmup_steps=c["warmup"],
                  timed_steps=c["steps"],
                  steps_checked_without_sync=c["steps"],
                  builds_after_warmup=0, step_ms=step_s * 1e3,
                  tokens_per_s=tokens / step_s, losses=losses,
                  params=sum(p.numel() for p in model.parameters()),
                  max_memory_allocated=torch.cuda.max_memory_allocated()
                  if cuda else None)
    if cuda:
        prof = _profile_breakdown(step, step_s * 1e3, top=6, groups=groups)
        prof["busy_share"] = 1 - prof["idle_share"]
        result["profile"] = prof
        result["launches_a_step"] = prof["launches"]
    return result


def _first_step_loss(models, loss_of, device, rows):
    """The loss of ``rows`` of the batch on the card and on the CPU, the
    models in eval (no dropout) and fp32 with TF32 off: (card, cpu)."""
    import torch
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev, m in models.items():
            m.eval()
            with torch.no_grad():
                out[dev] = float(loss_of(m, dev, rows))
            m.train()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out[device], out["cpu"]


def _beam_decode(paddle, lm, c, device, record):
    """``dynamic_decode`` of a ``BeamSearchDecoder`` over ``lm``'s two
    LSTM cells as one cell (``embedding_fn`` its Embedding, ``output_fn``
    its Linear) from zero states: (ids, scores, lengths, the decoder)."""
    import torch
    nn = paddle.nn
    cls = nn.BeamSearchDecoder
    if record:
        class Recording(nn.BeamSearchDecoder):
            """Records each step's top ``beam + 1`` totals and the chosen
            flat indices."""

            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.trace = []

            def _select(self, total):
                vals, idx = torch.topk(total, self.beam_size + 1, dim=-1)
                self.trace.append((vals, idx[:, :self.beam_size]))
                return vals[:, :self.beam_size], idx[:, :self.beam_size]
        cls = Recording
    dec = cls(_stack_cell(nn, lm.rnn.cells[0], lm.rnn.cells[1]), c["start"],
              c["end"], c["beam"], embedding_fn=lm.embed,
              output_fn=lm.head)
    h = lm.rnn.hidden_size
    z = torch.zeros((c["batch"], h), device=device)
    with torch.no_grad():
        ids, scores, lens = nn.dynamic_decode(
            dec, [(z, z), (z, z)], max_step_num=c["max_steps"],
            return_length=True)
    return ids, scores, lens, dec


def _beam_compare(card, cpu, c):
    """The card's beam search against the CPU's: rows whose choices agree
    at every step must give equal ids and lengths and scores within
    NN_PARITY_TOL; a row whose choice differs must show a near-tie (the
    CPU's k-th and (k+1)-th totals, or two neighbours among the top
    ``beam + 1``, within NEAR_TIE_REL relative) at its first differing
    step.  Returns the readings and the failures."""
    import torch
    k = c["beam"]
    trace_card = [(v.cpu(), i.cpu()) for v, i in card[3].trace]
    trace_cpu = cpu[3].trace
    steps = min(len(trace_card), len(trace_cpu))
    near_k, near_any, diverged, fails = 0, 0, {}, []
    for s in range(len(trace_cpu)):
        v = trace_cpu[s][0]
        gap = (v[:, :-1] - v[:, 1:]).abs() <= NEAR_TIE_REL * v[:, :-1].abs()
        near_k += int(bool(gap[:, k - 1].any()))
        near_any += int(bool(gap.any()))
        if s >= steps:
            continue
        for b in torch.nonzero(~(trace_card[s][1] == trace_cpu[s][1])
                               .all(-1)).flatten().tolist():
            if b in diverged:
                continue
            diverged[b] = s
            if not bool(gap[b].any()):
                fails.append(f"row {b} chose otherwise at step {s} with no "
                             f"near-tie (CPU totals {v[b].tolist()})")
    same = [b for b in range(c["batch"]) if b not in diverged]
    ids_eq = bool(torch.equal(card[0].cpu()[same], cpu[0][same]))
    lens_eq = bool(torch.equal(card[2].cpu()[same], cpu[2][same]))
    score = _parity_bad(card[1].cpu()[same], cpu[1][same], NN_PARITY_TOL)
    if len(trace_card) != len(trace_cpu) and not diverged:
        fails.append(f"{len(trace_card)} steps on the card, "
                     f"{len(trace_cpu)} on the CPU")
    if not ids_eq or not lens_eq or score[0]:
        fails.append(f"rows {same}: ids equal {ids_eq}, lengths equal "
                     f"{lens_eq}, scores {score}")
    return dict(steps_card=len(trace_card), steps_cpu=len(trace_cpu),
                near_tie_steps=near_k, near_tie_steps_any_rank=near_any,
                rows_diverged_at_near_tie=diverged, rows_equal=len(same),
                scores_max_abs_err=score[1],
                lengths_card=card[2].cpu().tolist()), fails


def phase_seq_models(cfg=None, device="cuda"):
    """The sequence half of ``nn`` at full published width (SEQ_MODELS):
    (a) the Transformer base trained under O1 bf16 with label smoothing and
    Adam over NoamDecay, (b) the PTB-large LSTM language model trained in
    fp32 with SGD and global-norm clipping, (c) beam search over (b)'s
    cells.  Each model is built on the CPU from a seed and carried to the
    card; the loss of ``parity_rows`` of the first batch (eval, fp32, TF32
    off) on the card is held within NN_PARITY_TOL of the CPU's; then
    ``warmup`` steps and ``steps`` timed steps with 0 builds and 0 syncs
    (``_train_steps_without_sync``), every loss finite.  (c) runs on the
    card and on the CPU from (b)'s first state (fp32, TF32 off): the ids,
    scores and lengths agree but where a near-tie excuses a row
    (``_beam_compare``); then a timed card run, its marked syncs (one a
    step, the reference's own stop check)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import observability as obs
    cfg = cfg or SEQ_MODELS
    cuda = device == "cuda"
    F = paddle.nn.functional
    t_phase = time.perf_counter()
    # (a) the Transformer base
    c = cfg["transformer"]
    gen = torch.Generator().manual_seed(c["seed"])
    src = torch.randint(0, c["vocab"], (c["batch"], c["src"]), generator=gen)
    tgt = torch.randint(0, c["vocab"], (c["batch"], c["tgt"] + 1),
                        generator=gen)
    models = {}
    for dev in ("cpu", device):
        with _paddle_device(dev):
            paddle.seed(c["seed"])
            models[dev] = _seq2seq_model(
                paddle, c["vocab"], c["d_model"], c["heads"], c["layers"],
                c["ffn"], c["dropout"], max(c["src"], c["tgt"]))
    models[device].set_state_dict(models["cpu"].state_dict())
    masks = {}
    for dev, m in models.items():
        with _paddle_device(dev):
            masks[dev] = m.transformer.generate_square_subsequent_mask(
                c["tgt"])

    def t_loss(m, dev, rows):
        return _smoothed_ce(F, m(src[:rows].to(dev), tgt[:rows, :-1].to(dev),
                                 masks[dev]),
                            tgt[:rows, 1:].to(dev), c["vocab"],
                            c["smoothing"])
    card_l, cpu_l = _first_step_loss(models, t_loss, device,
                                     c["parity_rows"])
    if not abs(card_l - cpu_l) <= NN_PARITY_TOL * abs(cpu_l):
        raise AssertionError(f"seq_models transformer: first-step loss "
                             f"{card_l} on the card, {cpu_l} on the CPU")
    model = models[device]
    del models
    gc.collect()
    with _paddle_device(device):
        sched = paddle.optimizer.lr.NoamDecay(c["d_model"],
                                              c["warmup_steps"])
        opt = paddle.optimizer.Adam(sched, 0.9, 0.98, 1e-9,
                                    parameters=model.parameters())
    src_d, tgt_in, tgt_out = (src.to(device), tgt[:, :-1].to(device),
                              tgt[:, 1:].to(device))
    mask = masks[device]

    def t_step():
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = _smoothed_ce(F, model(src_d, tgt_in, mask), tgt_out,
                                c["vocab"], c["smoothing"])
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.detach()
    tr = _seq_train_report("transformer", model, t_step, c, device,
                           c["batch"] * c["tgt"])
    emit("seq_models", part="transformer_base", config=(
        "Vaswani et al. 2017 base: d_model 512, 8 heads, 6+6 layers, FFN "
        "2048, dropout 0.1; shared 37000-token vocabulary (WMT14 En-De "
        "BPE)"), vocab=c["vocab"], batch=c["batch"], src=c["src"],
        tgt=c["tgt"], amp="O1 bfloat16", optimizer="Adam(0.9, 0.98, 1e-9)",
        lr_schedule="NoamDecay(512, 4000)", label_smoothing=c["smoothing"],
        parity_rows=c["parity_rows"], first_step_loss_card=card_l,
        first_step_loss_cpu=cpu_l, parity_tol=NN_PARITY_TOL,
        target_tokens_per_step=c["batch"] * c["tgt"], **tr,
        nvidia_smi=_nvidia_smi() if cuda else None)
    del model, opt, t_step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # (b) the PTB-large LSTM language model
    c = cfg["lstm"]
    gen = torch.Generator().manual_seed(c["seed"])
    ids = torch.randint(0, c["vocab"], (c["batch"], c["unroll"] + 1),
                        generator=gen)
    lms = {}
    for dev in ("cpu", device):
        with _paddle_device(dev):
            paddle.seed(c["seed"])
            lms[dev] = _lstm_lm_model(paddle, c["vocab"], c["hidden"],
                                      c["layers"], c["dropout"])
    lms[device].set_state_dict(lms["cpu"].state_dict())

    def lm_loss(m, dev, rows):
        x = ids[:rows].to(dev)
        return F.cross_entropy(m(x[:, :-1]).reshape([-1, c["vocab"]]),
                               x[:, 1:].reshape([-1]))
    card_l, cpu_l = _first_step_loss(lms, lm_loss, device, c["parity_rows"])
    if not abs(card_l - cpu_l) <= NN_PARITY_TOL * abs(cpu_l):
        raise AssertionError(f"seq_models lstm: first-step loss {card_l} on "
                             f"the card, {cpu_l} on the CPU")
    # (c) beam search from the first state, card against CPU, fp32
    bc = cfg["beam"]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for m in lms.values():
            m.eval()
        beam_cpu = _beam_decode(paddle, lms["cpu"], bc, "cpu", True)
        beam_card = _beam_decode(paddle, lms[device], bc, device, True)
        beam, fails = _beam_compare(beam_card, beam_cpu, bc)
        if cuda:
            torch.cuda.synchronize()
        syncs0 = obs.device_syncs()
        t0 = time.perf_counter()
        out = _beam_decode(paddle, lms[device], bc, device, False)
        if cuda:
            torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        steps = out[0].shape[-1]
        beam.update(timed_steps=steps, ms_a_step=decode_s * 1e3 / steps,
                    marked_syncs_a_step=(obs.device_syncs() - syncs0) / steps)
        for m in lms.values():
            m.train()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if fails:
        raise AssertionError(f"seq_models beam search: {fails}")
    lm = lms[device]
    del lms
    gc.collect()
    with _paddle_device(device):
        opt = paddle.optimizer.SGD(
            c["lr"], parameters=lm.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(c["clip"]))
    x_in, x_out = ids[:, :-1].to(device), ids[:, 1:].reshape([-1]).to(device)

    def lm_step():
        loss = F.cross_entropy(lm(x_in).reshape([-1, c["vocab"]]), x_out)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    tr = _seq_train_report("lstm", lm, lm_step, c, device,
                           c["batch"] * c["unroll"])
    _PHASE_RESULTS["lstm"] = dict(
        optimizer="SGD(1.0) + ClipGradByGlobalNorm(10), dense embedding "
        "gradient", step_ms=tr["step_ms"],
        max_memory_allocated=tr["max_memory_allocated"],
        busy_share=tr.get("profile", {}).get("busy_share"))
    emit("seq_models", part="ptb_large_lstm", config=(
        "Zaremba et al. 2014 large: Embedding(10000, 1500), LSTM 2 x 1500, "
        "dropout 0.65, 35 unrolled steps, batch 20 (Paddle's PTB LM "
        "example)"), dtype="float32", optimizer="SGD(1.0)",
        grad_clip="ClipGradByGlobalNorm(10)", parity_rows=c["parity_rows"],
        first_step_loss_card=card_l, first_step_loss_cpu=cpu_l,
        parity_tol=NN_PARITY_TOL, **tr,
        nvidia_smi=_nvidia_smi() if cuda else None)
    emit("seq_models", part="beam_search", beam=bc["beam"],
         batch=bc["batch"], max_step_num=bc["max_steps"],
         near_tie_rel=NEAR_TIE_REL, dtype="float32", tf32=False, **beam,
         seconds=time.perf_counter() - t_phase,
         nvidia_smi=_nvidia_smi() if cuda else None)
    del lm, opt, lm_step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def _spatial_checks(got, want):
    """``_seq_checks``' rule over float outputs and gradients; integer
    outputs (pool indices) must be equal: {entry: (bad, err)}."""
    import torch
    fl = [i for i, w in enumerate(want[0]) if w.is_floating_point()]
    checks = _seq_checks(([got[0][i] for i in fl], got[1], got[2]),
                         ([want[0][i] for i in fl], want[1], want[2]))
    for i, w in enumerate(want[0]):
        if not w.is_floating_point():
            g = got[0][i].cpu()
            same = g.dtype == w.dtype and torch.equal(g, w)
            checks[f"out_{i}_exact"] = (0 if same else 1,
                                        0.0 if same else float("inf"))
    return checks


def _spatial_fn_cases(c):
    """(name, call(F, *xs), inputs(gen), grad indices) of every function of
    the spatial half: every data_format, stride, dilation, padding form and
    output_size; each interpolate mode up and down; the return_mask forms
    through max_unpool; grid_sample's three padding modes."""
    import torch
    n, ch, L = c["n"], c["c"], c["l"]
    H, W = c["hw"]
    D3, H3, W3 = c["dhw"]

    def xs(*shapes):
        return lambda g: [torch.randn(s, generator=g) for s in shapes]

    def unpool_in(shape, n_out):
        return lambda g: [torch.randn(shape, generator=g),
                          torch.randint(0, n_out, shape, generator=g).int()]

    def grid_in(lo, hi):
        return lambda g: [torch.randn(n, ch, H, W, generator=g),
                          torch.rand(n, 5, 7, 2, generator=g) * (hi - lo) +
                          lo]

    def stats_in(shape):
        return lambda g: [torch.randn(shape, generator=g),
                          torch.randn(shape[1], generator=g),
                          torch.rand(shape[1], generator=g) + 0.5]

    def tsize(i, s, p, k, d=1):
        """The largest size a transposed convolution reaches."""
        return (i - 1) * s - 2 * p + (k - 1) * d + 1 + s - 1

    def masked(nd):
        def call(F, x):
            pool = F.max_pool2d if nd == 2 else F.max_pool3d
            unpool = F.max_unpool2d if nd == 2 else F.max_unpool3d
            out, idx = pool(x, 3, 2, 1, return_mask=True)
            return out, idx, unpool(out, idx, 3, 2, 1,
                                    output_size=list(x.shape))
        return call
    x1, x2, x3 = (n, ch, L), (n, ch, H, W), (n, ch, D3, H3, W3)
    return [
        # convolutions
        ("conv1d_ncl", lambda F, x, w, b: F.conv1d(
            x, w, b, stride=2, padding=[1, 2], dilation=2),
         xs(x1, (6, ch, 3), (6,)), [0, 1, 2]),
        ("conv1d_nlc_same_groups", lambda F, x, w: F.conv1d(
            x, w, stride=2, padding="SAME", groups=2, data_format="NLC"),
         xs((n, L, ch), (6, ch // 2, 3)), [0, 1]),
        ("conv1d_valid", lambda F, x, w: F.conv1d(x, w, padding="VALID"),
         xs(x1, (5, ch, 4)), [0, 1]),
        ("conv1d_nested", lambda F, x, w: F.conv1d(
            x, w, padding=[[0, 0], [0, 0], [2, 1]]),
         xs(x1, (5, ch, 4)), [0, 1]),
        ("conv2d_same_stride_dilation", lambda F, x, w, b: F.conv2d(
            x, w, b, stride=2, padding="SAME", dilation=2),
         xs(x2, (6, ch, 3, 3), (6,)), [0, 1, 2]),
        ("conv2d_nhwc_four_ints", lambda F, x, w: F.conv2d(
            x, w, padding=[1, 0, 2, 1], data_format="NHWC"),
         xs((n, H, W, ch), (5, ch, 3, 2)), [0, 1]),
        ("conv2d_nested_groups", lambda F, x, w: F.conv2d(
            x, w, padding=[[0, 0], [0, 0], [1, 2], [0, 1]], groups=2),
         xs(x2, (6, ch // 2, 3, 3)), [0, 1]),
        ("conv3d_ncdhw", lambda F, x, w, b: F.conv3d(
            x, w, b, stride=(1, 2, 1), padding=1, dilation=(2, 1, 1)),
         xs(x3, (3, ch, 3, 3, 2), (3,)), [0, 1, 2]),
        ("conv3d_ndhwc_same", lambda F, x, w: F.conv3d(
            x, w, stride=2, padding="SAME", data_format="NDHWC"),
         xs((n, D3, H3, W3, ch), (3, ch, 3, 2, 3)), [0, 1]),
        ("conv3d_six_ints_groups", lambda F, x, w: F.conv3d(
            x, w, padding=[1, 0, 0, 2, 1, 1], groups=2),
         xs(x3, (4, ch // 2, 3, 3, 3)), [0, 1]),
        ("conv3d_nested", lambda F, x, w: F.conv3d(
            x, w, padding=[[0, 0], [0, 0], [1, 1], [0, 1], [2, 0]]),
         xs(x3, (3, ch, 3, 3, 3)), [0, 1]),
        ("conv1d_transpose", lambda F, x, w, b: F.conv1d_transpose(
            x, w, b, stride=2, padding=1, output_padding=1, dilation=2),
         xs(x1, (ch, 3, 3), (3,)), [0, 1, 2]),
        ("conv1d_transpose_nlc_output_size", lambda F, x, w:
         F.conv1d_transpose(x, w, stride=3, padding=1, data_format="NLC",
                            output_size=[tsize(L, 3, 1, 3)]),
         xs((n, L, ch), (ch, 3, 3)), [0, 1]),
        ("conv2d_transpose", lambda F, x, w, b: F.conv2d_transpose(
            x, w, b, stride=(2, 1), padding=(1, 0), output_padding=(1, 0),
            dilation=(1, 2)),
         xs(x2, (ch, 3, 3, 2), (3,)), [0, 1, 2]),
        ("conv2d_transpose_nhwc_output_size", lambda F, x, w:
         F.conv2d_transpose(x, w, stride=2, padding=1, data_format="NHWC",
                            output_size=[tsize(H, 2, 1, 3),
                                         tsize(W, 2, 1, 3)]),
         xs((n, H, W, ch), (ch, 3, 3, 3)), [0, 1]),
        ("conv3d_transpose", lambda F, x, w, b: F.conv3d_transpose(
            x, w, b, stride=2), xs(x3, (ch, 2, 2, 2, 2), (2,)), [0, 1, 2]),
        ("conv3d_transpose_ndhwc_output_size", lambda F, x, w:
         F.conv3d_transpose(x, w, stride=(2, 1, 2), padding=(1, 0, 1),
                            dilation=(1, 2, 1), data_format="NDHWC",
                            output_size=[tsize(D3, 2, 1, 3),
                                         tsize(H3, 1, 0, 3, 2),
                                         tsize(W3, 2, 1, 3)]),
         xs((n, D3, H3, W3, ch), (ch, 3, 3, 3, 3)), [0, 1]),
        # pools
        ("max_pool1d", lambda F, x: F.max_pool1d(x, 3, 2, 1), xs(x1), [0]),
        ("avg_pool1d", lambda F, x: F.avg_pool1d(x, 3, 2, 1), xs(x1), [0]),
        ("max_pool2d", lambda F, x: F.max_pool2d(x, 3, 2, 1), xs(x2), [0]),
        ("max_pool2d_nhwc", lambda F, x: F.max_pool2d(
            x, 2, data_format="NHWC"), xs((n, H, W, ch)), [0]),
        ("avg_pool2d_exclusive", lambda F, x: F.avg_pool2d(x, 3, 2, 1),
         xs(x2), [0]),
        ("avg_pool2d_inclusive_nhwc", lambda F, x: F.avg_pool2d(
            x, 3, 2, 1, exclusive=False, data_format="NHWC"),
         xs((n, H, W, ch)), [0]),
        ("avg_pool2d_divisor", lambda F, x: F.avg_pool2d(
            x, 2, 2, 1, divisor_override=3), xs(x2), [0]),
        ("avg_pool2d_wide_padding", lambda F, x: F.avg_pool2d(x, 3, 1, 2),
         xs(x2), [0]),
        ("max_pool3d", lambda F, x: F.max_pool3d(
            x, (2, 3, 2), (2, 2, 1), (1, 1, 0)), xs(x3), [0]),
        ("max_pool3d_ndhwc", lambda F, x: F.max_pool3d(
            x, 2, data_format="NDHWC"), xs((n, D3, H3, W3, ch)), [0]),
        ("avg_pool3d_exclusive", lambda F, x: F.avg_pool3d(x, 3, 2, 1),
         xs(x3), [0]),
        ("avg_pool3d_inclusive_ndhwc", lambda F, x: F.avg_pool3d(
            x, 3, 2, 1, exclusive=False, data_format="NDHWC"),
         xs((n, D3, H3, W3, ch)), [0]),
        ("avg_pool3d_divisor", lambda F, x: F.avg_pool3d(
            x, 2, 2, 1, divisor_override=3), xs(x3), [0]),
        ("max_pool2d_mask_unpool", masked(2), xs(x2), [0]),
        ("max_pool3d_mask_unpool", masked(3), xs(x3), [0]),
        ("max_pool2d_with_index", lambda F, x: F.max_pool2d_with_index(
            x, 2, 2), xs(x2), [0]),
        ("max_pool3d_with_index", lambda F, x: F.max_pool3d_with_index(
            x, 3, 2, 1), xs(x3), [0]),
        ("max_unpool1d_repeated_index", lambda F, x, i: F.max_unpool1d(
            x, i, 3, 1, output_size=[9]), unpool_in((n, ch, 7), 9), [0]),
        ("adaptive_avg_pool1d", lambda F, x: F.adaptive_avg_pool1d(x, 5),
         xs(x1), [0]),
        ("adaptive_avg_pool2d_nhwc", lambda F, x: F.adaptive_avg_pool2d(
            x, (4, 3), data_format="NHWC"), xs((n, H, W, ch)), [0]),
        ("adaptive_avg_pool3d", lambda F, x: F.adaptive_avg_pool3d(
            x, (3, 4, 2)), xs(x3), [0]),
        ("adaptive_max_pool1d", lambda F, x: F.adaptive_max_pool1d(x, 5),
         xs(x1), [0]),
        ("adaptive_max_pool2d", lambda F, x: F.adaptive_max_pool2d(
            x, (4, 3)), xs(x2), [0]),
        ("adaptive_max_pool3d", lambda F, x: F.adaptive_max_pool3d(x, 2),
         xs(x3), [0]),
        ("lp_pool1d", lambda F, x: F.lp_pool1d(x, 2, 3, 2), xs(x1), [0]),
        ("lp_pool2d_padding", lambda F, x: F.lp_pool2d(x, 3, 3, 2, 1),
         xs(x2), [0]),
        ("fractional_max_pool2d", lambda F, x: F.fractional_max_pool2d(
            x, (5, 4), random_u=0.3), xs(x2), [0]),
        ("fractional_max_pool3d", lambda F, x: F.fractional_max_pool3d(
            x, (3, 4, 2), random_u=0.6), xs(x3), [0]),
        # norms
        ("instance_norm", lambda F, x, w, b: F.instance_norm(
            x, weight=w, bias=b), xs(x2, (ch,), (ch,)), [0, 1, 2]),
        ("group_norm", lambda F, x, w, b: F.group_norm(x, 2, 1e-5, w, b),
         xs(x2, (ch,), (ch,)), [0, 1, 2]),
        ("group_norm_nhwc", lambda F, x: F.group_norm(
            x, 2, data_format="NHWC"), xs((n, H, W, ch)), [0]),
        ("group_norm_3d", lambda F, x: F.group_norm(x, 4), xs(x3), [0]),
        ("local_response_norm", lambda F, x: F.local_response_norm(
            x, 3, 1e-2, 0.75, 2.0), xs(x2), [0]),
        ("local_response_norm_ndhwc", lambda F, x: F.local_response_norm(
            x, 3, 0.1, 0.5, data_format="NDHWC"),
         xs((n, D3, H3, W3, ch)), [0]),
        ("sync_batch_norm_training", lambda F, x, m, v: F.sync_batch_norm(
            x, m.clone(), v.clone(), training=True), stats_in(x2), [0]),
        ("sync_batch_norm_eval", lambda F, x, m, v: F.sync_batch_norm(
            x, m, v), stats_in(x3), [0]),
        ("spectral_norm", lambda F, w: F.spectral_norm(w, 2),
         xs((6, ch, 3)), [0]),
        ("spectral_norm_dim_1", lambda F, w: F.spectral_norm(w, dim=1),
         xs((5, 7)), [0]),
        # padding
        ("pad_constant", lambda F, x: F.pad(x, [1, 2, 0, 3], value=0.5),
         xs(x2), [0]),
        ("pad_reflect_nhwc", lambda F, x: F.pad(
            x, [2, 1, 1, 3], mode="reflect", data_format="NHWC"),
         xs((n, H, W, ch)), [0]),
        ("pad_replicate_3d", lambda F, x: F.pad(
            x, [1, 0, 2, 1, 0, 2], mode="replicate", data_format="NCDHW"),
         xs(x3), [0]),
        ("pad_circular_ncl", lambda F, x: F.pad(
            x, [3, 2], mode="circular", data_format="NCL"), xs(x1), [0]),
        ("zeropad2d", lambda F, x: F.zeropad2d(x, [1, 0, 2, 1]), xs(x2),
         [0]),
        # resampling
        ("interpolate_nearest_up", lambda F, x: F.interpolate(
            x, size=[2 * H + 1, W + 3]), xs(x2), [0]),
        ("interpolate_nearest_down", lambda F, x: F.interpolate(
            x, scale_factor=0.6), xs(x2), [0]),
        ("interpolate_bilinear_up", lambda F, x: F.interpolate(
            x, size=[2 * H, W + 2], mode="bilinear"), xs(x2), [0]),
        ("interpolate_bilinear_down", lambda F, x: F.interpolate(
            x, size=[H // 2, W // 3], mode="bilinear"), xs(x2), [0]),
        ("interpolate_bilinear_corners", lambda F, x: F.interpolate(
            x, size=[2 * H, W // 2], mode="bilinear", align_corners=True),
         xs(x2), [0]),
        ("interpolate_bicubic_up", lambda F, x: F.interpolate(
            x, size=[2 * H, W + 1], mode="bicubic"), xs(x2), [0]),
        ("interpolate_bicubic_down", lambda F, x: F.interpolate(
            x, size=[H // 2, W // 2], mode="bicubic"), xs(x2), [0]),
        ("interpolate_area_down", lambda F, x: F.interpolate(
            x, size=[H // 3, W // 2], mode="area"), xs(x2), [0]),
        ("interpolate_linear_up", lambda F, x: F.interpolate(
            x, size=[2 * L + 1], mode="linear", data_format="NCW"),
         xs(x1), [0]),
        ("interpolate_linear_down_corners", lambda F, x: F.interpolate(
            x, size=[L // 3], mode="linear", align_corners=True), xs(x1),
         [0]),
        ("interpolate_trilinear_up_down", lambda F, x: F.interpolate(
            x, size=[2 * D3, H3 // 2, W3 + 1], mode="trilinear"), xs(x3),
         [0]),
        ("interpolate_bilinear_nhwc_scale", lambda F, x: F.interpolate(
            x, scale_factor=[1.5, 0.5], mode="bilinear", data_format="NHWC"),
         xs((n, H, W, ch)), [0]),
        ("upsample_nearest_3d", lambda F, x: F.upsample(
            x, scale_factor=2, data_format="NCDHW"), xs(x3), [0]),
        ("pixel_shuffle", lambda F, x: F.pixel_shuffle(x, 2),
         xs((n, 4 * ch, H, W)), [0]),
        ("pixel_unshuffle", lambda F, x: F.pixel_unshuffle(x, 2),
         xs((n, ch, 2 * H, 2 * W)), [0]),
        ("channel_shuffle", lambda F, x: F.channel_shuffle(x, 2), xs(x2),
         [0]),
        ("channel_shuffle_nhwc", lambda F, x: F.channel_shuffle(
            x, 2, data_format="NHWC"), xs((n, H, W, ch)), [0]),
        ("temporal_shift", lambda F, x: F.temporal_shift(x, 3, 0.25),
         xs((3 * n, ch, H, W)), [0]),
        ("unfold", lambda F, x: F.unfold(x, 3, 2, 1), xs(x2), [0]),
        ("unfold_dilated", lambda F, x: F.unfold(x, [2, 3], 1, 0, 2),
         xs(x2), [0]),
        ("fold", lambda F, x: F.fold(x, [H, W], 3, 2, 1),
         xs((n, 9 * ch, ((H - 1) // 2 + 1) * ((W - 1) // 2 + 1))), [0]),
        ("affine_grid", lambda F, t: F.affine_grid(t, [n, ch, H, W]),
         xs((n, 2, 3)), [0]),
        ("affine_grid_half_pixel", lambda F, t: F.affine_grid(
            t, [n, ch, H, W], align_corners=False), xs((n, 2, 3)), [0]),
        ("grid_sample_zeros", lambda F, x, g: F.grid_sample(x, g),
         grid_in(-1.3, 1.3), [0, 1]),
        ("grid_sample_border_half_pixel", lambda F, x, g: F.grid_sample(
            x, g, padding_mode="border", align_corners=False),
         grid_in(-1.3, 1.3), [0, 1]),
        ("grid_sample_reflection", lambda F, x, g: F.grid_sample(
            x, g, padding_mode="reflection"), grid_in(-2.5, 2.5), [0, 1]),
        ("grid_sample_reflection_half_pixel", lambda F, x, g:
         F.grid_sample(x, g, padding_mode="reflection",
                       align_corners=False), grid_in(-2.5, 2.5), [0, 1]),
        ("grid_sample_nearest", lambda F, x, g: F.grid_sample(
            x, g, mode="nearest"), grid_in(-1.3, 1.3), [0]),
    ]


def _spatial_layer_cases(c):
    """(name, make(nn), inputs(gen)) of every layer of the spatial half
    (its 43 classes)."""
    import torch
    n, ch, L = c["n"], c["c"], c["l"]
    H, W = c["hw"]
    D3, H3, W3 = c["dhw"]

    def xs(*shapes):
        return lambda g: [torch.randn(s, generator=g) for s in shapes]

    def unpool_in(shape, n_out):
        return lambda g: [torch.randn(shape, generator=g),
                          torch.randint(0, n_out, shape, generator=g).int()]
    x1, x2, x3 = (n, ch, L), (n, ch, H, W), (n, ch, D3, H3, W3)
    return [
        ("Conv1D", lambda nn: nn.Conv1D(ch, 6, 3, stride=2, padding=1,
                                        groups=2), xs(x1)),
        ("Conv3D", lambda nn: nn.Conv3D(ch, 3, 3, padding="SAME",
                                        data_format="NDHWC"),
         xs((n, D3, H3, W3, ch))),
        ("Conv1DTranspose", lambda nn: nn.Conv1DTranspose(
            ch, 3, 3, stride=2, padding=1), xs(x1)),
        ("Conv2DTranspose", lambda nn: nn.Conv2DTranspose(
            ch, 3, (2, 3), stride=2, output_padding=1), xs(x2)),
        ("Conv3DTranspose", lambda nn: nn.Conv3DTranspose(ch, 2, 2,
                                                          stride=2), xs(x3)),
        ("MaxPool1D", lambda nn: nn.MaxPool1D(3, 2, 1), xs(x1)),
        ("AvgPool1D", lambda nn: nn.AvgPool1D(3, 2, 1), xs(x1)),
        ("MaxPool3D", lambda nn: nn.MaxPool3D(2, data_format="NDHWC"),
         xs((n, D3, H3, W3, ch))),
        ("AvgPool3D", lambda nn: nn.AvgPool3D(3, 2, 1, exclusive=False),
         xs(x3)),
        ("AdaptiveAvgPool1D", lambda nn: nn.AdaptiveAvgPool1D(4), xs(x1)),
        ("AdaptiveAvgPool3D", lambda nn: nn.AdaptiveAvgPool3D((2, 3, 1)),
         xs(x3)),
        ("AdaptiveMaxPool1D", lambda nn: nn.AdaptiveMaxPool1D(4), xs(x1)),
        ("AdaptiveMaxPool2D", lambda nn: nn.AdaptiveMaxPool2D((3, 2)),
         xs(x2)),
        ("AdaptiveMaxPool3D", lambda nn: nn.AdaptiveMaxPool3D(2), xs(x3)),
        ("MaxUnPool1D", lambda nn: nn.MaxUnPool1D(2, output_size=[11]),
         unpool_in((n, ch, 5), 11)),
        ("MaxUnPool2D", lambda nn: nn.MaxUnPool2D(2, 2),
         unpool_in((n, ch, 3, 4), 48)),
        ("MaxUnPool3D", lambda nn: nn.MaxUnPool3D(2, 2),
         unpool_in((n, ch, 2, 2, 3), 96)),
        ("FractionalMaxPool2D", lambda nn: nn.FractionalMaxPool2D(
            3, random_u=0.45), xs(x2)),
        ("FractionalMaxPool3D", lambda nn: nn.FractionalMaxPool3D(
            (2, 3, 2), random_u=0.2), xs(x3)),
        ("LPPool1D", lambda nn: nn.LPPool1D(3, 2), xs(x1)),
        ("LPPool2D", lambda nn: nn.LPPool2D(2, 3, 2, 1), xs(x2)),
        ("BatchNorm3D", lambda nn: nn.BatchNorm3D(ch), xs(x3)),
        ("SyncBatchNorm", lambda nn: nn.SyncBatchNorm(ch, momentum=0.8),
         xs(x2)),
        ("GroupNorm", lambda nn: nn.GroupNorm(2, ch), xs(x2)),
        ("InstanceNorm1D", lambda nn: nn.InstanceNorm1D(ch), xs(x1)),
        ("InstanceNorm2D", lambda nn: nn.InstanceNorm2D(ch), xs(x2)),
        ("InstanceNorm3D", lambda nn: nn.InstanceNorm3D(ch), xs(x3)),
        ("LocalResponseNorm", lambda nn: nn.LocalResponseNorm(3, 0.1),
         xs(x2)),
        ("SpectralNorm", lambda nn: nn.SpectralNorm([6, 4], power_iters=2),
         xs((6, 4))),
        ("Pad1D", lambda nn: nn.Pad1D([2, 1], mode="reflect"), xs(x1)),
        ("Pad2D", lambda nn: nn.Pad2D([1, 2, 0, 1], mode="replicate",
                                      data_format="NHWC"),
         xs((n, H, W, ch))),
        ("Pad3D", lambda nn: nn.Pad3D([1, 1, 0, 2, 1, 0], value=1.5),
         xs(x3)),
        ("ZeroPad1D", lambda nn: nn.ZeroPad1D([0, 3]), xs(x1)),
        ("ZeroPad2D", lambda nn: nn.ZeroPad2D([1, 0, 2, 2]), xs(x2)),
        ("ZeroPad3D", lambda nn: nn.ZeroPad3D([1, 0, 0, 1, 2, 0]), xs(x3)),
        ("Upsample", lambda nn: nn.Upsample(scale_factor=2,
                                            mode="bilinear"), xs(x2)),
        ("UpsamplingNearest2D", lambda nn: nn.UpsamplingNearest2D(
            size=[H + 4, W + 2]), xs(x2)),
        ("UpsamplingBilinear2D", lambda nn: nn.UpsamplingBilinear2D(
            scale_factor=1.5), xs(x2)),
        ("PixelShuffle", lambda nn: nn.PixelShuffle(2),
         xs((n, 4 * ch, H, W))),
        ("PixelUnshuffle", lambda nn: nn.PixelUnshuffle(2),
         xs((n, ch, 2 * H, 2 * W))),
        ("ChannelShuffle", lambda nn: nn.ChannelShuffle(2), xs(x2)),
        ("Unfold", lambda nn: nn.Unfold([2, 3], strides=2, paddings=1),
         xs(x2)),
        ("Fold", lambda nn: nn.Fold([H, W], 2, strides=1),
         xs((n, 4 * ch, (H - 1) * (W - 1)))),
    ]


def _channels_last_avg_pool_probe(device):
    """torch's own ``avg_pool2d`` backward (count_include_pad, padding 1)
    over a channels-last-strided input against the same over a contiguous
    copy, on ``device``: the largest gradient difference (the port pools a
    contiguous copy, ``nn/functional.py`` ``_avg_pool``)."""
    import torch
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 13, 11, 4, generator=g).to(device)
    cot = torch.randn(2, 4, 7, 6, generator=g).to(device)
    grads = []
    for contiguous in (False, True):
        a = x.clone().requires_grad_(True)
        b = a.movedim(-1, 1)
        b = b.contiguous() if contiguous else b
        (torch.nn.functional.avg_pool2d(b, 3, 2, 1) * cot).sum().backward()
        grads.append(a.grad)
    return {"max_abs_diff": float((grads[0] - grads[1]).abs().max()),
            "max_abs_grad": float(grads[1].abs().max())}


def phase_nn_spatial_parity(cfg=None, device="cuda"):
    """The spatial half of ``nn`` on ``device`` against the port on the
    CPU, fp32 with TF32 off (cuBLAS and cuDNN): every function of the
    slice (``_spatial_fn_cases``) and every layer (``_spatial_layer_cases``,
    its 43 classes; BatchNorm3D and SyncBatchNorm in training, their
    running statistics after the pass), outputs and input and parameter
    gradients by train_parity's rule at NN_PARITY_TOL (+ NN_PARITY_FLOOR),
    pool indices equal.  No Pallas kernel is on this path."""
    import torch
    import paddle_tpu_torch as paddle
    c = cfg or NN_SPATIAL_PARITY
    cuda = device == "cuda"
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F = paddle.nn.functional
    errs, failed = {}, {}
    t0 = time.perf_counter()

    def record(name, checks):
        errs[name] = max([e for _, e in checks.values()], default=0.0)
        bad = {k: v for k, v in checks.items() if v[0]}
        if bad:
            failed[name] = bad
    try:
        fn_cases = _spatial_fn_cases(c)
        for k, (name, call, make, grad) in enumerate(fn_cases):
            xs = make(torch.Generator().manual_seed(c["seed"] + k))
            got = _seq_pass(call, F, [x.to(device) for x in xs], grad)
            want = _seq_pass(call, F, xs, grad)
            record(name, _spatial_checks(got, want))
        layer_cases = _spatial_layer_cases(c)
        for k, (name, make, inputs) in enumerate(layer_cases):
            built = {}
            for key, dev in (("cpu", "cpu"), ("dev", device)):
                with _paddle_device(dev):
                    paddle.seed(0)
                    built[key] = make(paddle.nn)
            built["dev"].set_state_dict(built["cpu"].state_dict())
            xs = inputs(torch.Generator().manual_seed(c["seed"] + 500 + k))
            got = _seq_pass(lambda m, *a: m(*a), built["dev"],
                            [x.to(device) for x in xs], [0])
            want = _seq_pass(lambda m, *a: m(*a), built["cpu"], xs, [0])
            checks = _spatial_checks(got, want)
            cpu_bufs = dict(built["cpu"].named_buffers())
            checks.update({f"buffer_{bn}": _parity_bad(
                b, cpu_bufs[bn], NN_PARITY_TOL, NN_PARITY_FLOOR)
                for bn, b in built["dev"].named_buffers()})
            record(name, checks)
        probe = _channels_last_avg_pool_probe(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    if failed:
        raise AssertionError(f"nn_spatial_parity: out of tolerance "
                             f"(entries, max err): {failed}")
    emit("nn_spatial_parity", dtype="float32", tf32=False,
         tol=NN_PARITY_TOL, floor=NN_PARITY_FLOOR, functions=len(fn_cases),
         layers=len(layer_cases), max_abs_err=errs,
         worst=max(errs.items(), key=lambda kv: kv[1]),
         channels_last_avg_pool2d_backward=probe,
         seconds=time.perf_counter() - t0,
         nvidia_smi=_nvidia_smi() if cuda else None)


def _ddpm_unet(paddle, c):
    """DDPM's CIFAR-10 U-Net (Ho et al. 2020, App. B) from the Paddle API
    of ``paddle`` (the port, or the JAX package in the CPU tests):
    ``forward(x, temb)`` with ``temb`` the ``[B, ch]`` sinusoidal embedding
    of the timesteps (``_ddpm_temb``).  Residual blocks GroupNorm -> SiLU
    -> 3x3 conv (+ the time embedding's projection) -> GroupNorm -> SiLU ->
    dropout -> 3x3 conv, a 1x1 conv on the skip where the width changes;
    self-attention (GroupNorm, 1x1 q/k/v/proj) at ``attn_res``; stride-2
    "SAME" 3x3 convolutions down, ``Upsample(2, "nearest")`` + a 3x3
    convolution up, the skips concatenated."""
    nn, F = paddle.nn, paddle.nn.functional
    ch, groups = c["ch"], c["groups"]

    class ResBlock(nn.Layer):
        def __init__(self, cin, cout):
            super().__init__()
            self.norm1 = nn.GroupNorm(groups, cin)
            self.conv1 = nn.Conv2D(cin, cout, 3, padding=1)
            self.temb_proj = nn.Linear(4 * ch, cout)
            self.norm2 = nn.GroupNorm(groups, cout)
            self.dropout = nn.Dropout(c["dropout"])
            self.conv2 = nn.Conv2D(cout, cout, 3, padding=1)
            self.nin = nn.Conv2D(cin, cout, 1) if cin != cout else None

        def forward(self, x, temb):
            h = self.conv1(F.silu(self.norm1(x)))
            t = self.temb_proj(F.silu(temb))
            h = h + t.reshape([t.shape[0], t.shape[1], 1, 1])
            h = self.conv2(self.dropout(F.silu(self.norm2(h))))
            return (x if self.nin is None else self.nin(x)) + h

    class Attn(nn.Layer):
        def __init__(self, cc):
            super().__init__()
            self.norm = nn.GroupNorm(groups, cc)
            self.q, self.k, self.v, self.proj = (nn.Conv2D(cc, cc, 1)
                                                 for _ in range(4))

        def forward(self, x):
            b, cc, hh, ww = x.shape
            h = self.norm(x)
            q, k, v = (m(h).reshape([b, cc, hh * ww])
                       for m in (self.q, self.k, self.v))
            w = F.softmax(paddle.matmul(q, k, transpose_x=True) *
                          (float(cc) ** -0.5), axis=-1)
            h = paddle.matmul(v, w, transpose_y=True).reshape(
                [b, cc, hh, ww])
            return x + self.proj(h)

    class Up(nn.Layer):
        def __init__(self, cc):
            super().__init__()
            self.up = nn.Upsample(scale_factor=2, mode="nearest")
            self.conv = nn.Conv2D(cc, cc, 3, padding=1)

        def forward(self, x):
            return self.conv(self.up(x))

    class UNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.temb1 = nn.Linear(ch, 4 * ch)
            self.temb2 = nn.Linear(4 * ch, 4 * ch)
            self.conv_in = nn.Conv2D(3, ch, 3, padding=1)
            self.down = nn.LayerList()
            chans, cur, res = [ch], ch, c["px"]
            for i, m in enumerate(c["ch_mult"]):
                for _ in range(c["num_res_blocks"]):
                    blocks = nn.LayerList([ResBlock(cur, ch * m)])
                    cur = ch * m
                    if res in c["attn_res"]:
                        blocks.append(Attn(cur))
                    self.down.append(blocks)
                    chans.append(cur)
                if i != len(c["ch_mult"]) - 1:
                    self.down.append(nn.Conv2D(cur, cur, 3, stride=2,
                                               padding="SAME"))
                    chans.append(cur)
                    res //= 2
            self.mid = nn.LayerList([ResBlock(cur, cur), Attn(cur),
                                     ResBlock(cur, cur)])
            self.up = nn.LayerList()
            for i, m in reversed(list(enumerate(c["ch_mult"]))):
                for _ in range(c["num_res_blocks"] + 1):
                    blocks = nn.LayerList([ResBlock(cur + chans.pop(),
                                                    ch * m)])
                    cur = ch * m
                    if res in c["attn_res"]:
                        blocks.append(Attn(cur))
                    self.up.append(blocks)
                if i != 0:
                    self.up.append(Up(cur))
                    res *= 2
            self.norm_out = nn.GroupNorm(groups, cur)
            self.conv_out = nn.Conv2D(cur, 3, 3, padding=1)

        @staticmethod
        def _block(blocks, h, temb):
            if isinstance(blocks, nn.LayerList):
                h = blocks[0](h, temb)
                for a in list(blocks)[1:]:
                    h = a(h)
                return h
            return blocks(h)

        def forward(self, x, temb):
            temb = self.temb2(F.silu(self.temb1(temb)))
            hs = [self.conv_in(x)]
            for blocks in self.down:
                hs.append(self._block(blocks, hs[-1], temb))
            h = self.mid[0](hs[-1], temb)
            h = self.mid[2](self.mid[1](h), temb)
            for blocks in self.up:
                if isinstance(blocks, nn.LayerList):
                    h = paddle.concat([h, hs.pop()], axis=1)
                h = self._block(blocks, h, temb)
            return self.conv_out(F.silu(self.norm_out(h)))
    return UNet()


def _ddpm_temb(t, dim):
    """DDPM's sinusoidal timestep embedding, ``[sin, cos]`` of ``t *
    exp(-log(10000) i / (dim / 2 - 1))``, on t's device."""
    import torch
    half = dim // 2
    freq = torch.exp(torch.arange(half, device=t.device) *
                     -(math.log(10000.0) / (half - 1)))
    ang = t.float()[:, None] * freq[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _ddpm_noised(x0, t, noise, abar):
    """``x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) noise``."""
    a = abar[t][:, None, None, None]
    return a.sqrt() * x0 + (1 - a).sqrt() * noise


def _unet3d(paddle, c):
    """The 3D U-Net (Cicek et al. 2016) from the Paddle API of ``paddle``
    (the port, or the JAX package in the CPU tests): ``levels``
    levels of two valid 3x3x3 ``Conv3D`` + ``BatchNorm3D`` + ReLU (the
    second doubling the channels), ``MaxPool3D(2)`` down,
    ``Conv3DTranspose(2, stride 2)`` up with the center-cropped skip
    concatenated, a 1x1x1 head.  The batch norms have no scale or shift
    and the up-convolutions no bias (Caffe's ``BatchNorm``; the paper's
    19,069,955 parameters)."""
    nn = paddle.nn
    base, levels = c["base"], c["levels"]

    def norm(cc):
        return nn.BatchNorm3D(cc, weight_attr=False, bias_attr=False)

    def double(cin, mid, cout):
        return nn.Sequential(nn.Conv3D(cin, mid, 3), norm(mid), nn.ReLU(),
                             nn.Conv3D(mid, cout, 3), norm(cout), nn.ReLU())

    class UNet3D(nn.Layer):
        def __init__(self):
            super().__init__()
            self.analysis = nn.LayerList()
            cin = c["in_ch"]
            for i in range(levels):
                cc = base * 2 ** i
                self.analysis.append(double(cin, cc if i else base, 2 * cc))
                cin = 2 * cc
            self.pool = nn.MaxPool3D(2)
            self.upconv, self.synthesis = nn.LayerList(), nn.LayerList()
            for i in reversed(range(levels - 1)):
                cc = base * 2 ** (i + 1)
                self.upconv.append(nn.Conv3DTranspose(
                    2 * cc, 2 * cc, 2, stride=2, bias_attr=False))
                self.synthesis.append(double(3 * cc, cc, cc))
            self.head = nn.Conv3D(2 * base, c["classes"], 1)

        def forward(self, x):
            skips = []
            for i, level in enumerate(self.analysis):
                x = level(x)
                if i != levels - 1:
                    skips.append(x)
                    x = self.pool(x)
            for up, level in zip(self.upconv, self.synthesis):
                x = up(x)
                s = skips.pop()
                o = [(a - b) // 2 for a, b in zip(s.shape[2:], x.shape[2:])]
                d, h, w = x.shape[2:]
                s = s[:, :, o[0]:o[0] + d, o[1]:o[1] + h, o[2]:o[2] + w]
                x = level(paddle.concat([x, s], axis=1))
            return self.head(x)
    return UNet3D()


def _unet3d_out(tile, levels):
    """The output size of a valid 3D U-Net on ``tile`` (4 lost a level
    each way, halved and doubled between)."""
    out = []
    for n in tile:
        for _ in range(levels - 1):
            n = (n - 4) // 2
        n -= 4
        for _ in range(levels - 1):
            n = 2 * n - 4
        out.append(n)
    return out


SPATIAL_OP_GROUPS = {  # kernel-name keys, lower case, first family wins
    "conv": ("fprop", "dgrad", "wgrad", "conv", "winograd", "nchwtonhwc",
             "nhwctonchw"),
    "gemm": ("gemm", "gemv", "nvjet", "cutlass"),
    "norm": ("norm", "moments", "internalgradients", "fusedparams",
             "gammabeta", "welford"),
    "pool_resample": ("pool", "index", "gather", "scatter", "upsample"),
}


def _spatial_train_report(name, model, step, c, device, samples):
    """``_seq_train_report``'s warm-up and timed steps (0 builds, 0 syncs)
    with the rate as samples/s and, on the card, the busy split by op
    (SPATIAL_OP_GROUPS)."""
    tr = _seq_train_report(name, model, step, c, device, samples,
                           groups=SPATIAL_OP_GROUPS)
    tr["samples_per_s"] = tr.pop("tokens_per_s")
    return tr


def phase_spatial_models(cfg=None, device="cuda"):
    """The spatial half of ``nn`` at full published width (SPATIAL_MODELS),
    both built from the port's Paddle-API layers and trained under
    ``amp.auto_cast(level="O1", dtype="bfloat16")`` with Adam: (a) DDPM's
    CIFAR-10 U-Net, epsilon-prediction MSE over fresh timesteps and noise
    each step (drawn on the card); (b) the 3D U-Net on one 132 x 132 x 116
    tile, softmax cross-entropy over its 44 x 44 x 28 output voxels.  Each
    model is built on the CPU from a seed and carried to the card; its
    first step's loss in fp32 with TF32 off (DDPM at ``parity_batch``
    with the same t and noise, in eval: no dropout; the 3D U-Net in
    training on the smallest valid tile) is held within NN_PARITY_TOL of
    the CPU's; then ``warmup`` and ``steps`` timed steps with 0 builds and
    0 syncs, losses finite; ms a step, samples/s, busy / idle share,
    launches a step, the busy split by op, peak memory (reckoned before:
    ``memory_reckoned_gb``)."""
    import torch
    import paddle_tpu_torch as paddle
    cfg = cfg or SPATIAL_MODELS
    cuda = device == "cuda"
    F = paddle.nn.functional
    t_phase = time.perf_counter()

    def first_loss(models, loss_of, train):
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = {}
            for dev, m in models.items():
                m.train(train)
                with torch.no_grad():
                    out[dev] = float(loss_of(m, dev))
                m.train()
        finally:
            torch.backends.cuda.matmul.allow_tf32, \
                torch.backends.cudnn.allow_tf32 = tf32
        return out[device], out["cpu"]

    def build(make, c):
        models = {}
        for dev in ("cpu", device):
            with _paddle_device(dev):
                paddle.seed(c["seed"])
                models[dev] = make(paddle, c)
        models[device].set_state_dict(models["cpu"].state_dict())
        return models
    # (a) DDPM's CIFAR-10 U-Net
    c = cfg["ddpm"]
    gen = torch.Generator().manual_seed(c["seed"])
    betas = torch.linspace(c["beta"][0], c["beta"][1], c["timesteps"],
                           dtype=torch.float64)
    abar = torch.cumprod(1 - betas, 0).float()
    pb = c["parity_batch"]
    x0 = torch.rand(pb, 3, c["px"], c["px"], generator=gen) * 2 - 1
    t = torch.randint(0, c["timesteps"], (pb,), generator=gen)
    noise = torch.randn(pb, 3, c["px"], c["px"], generator=gen)
    models = build(_ddpm_unet, c)

    def ddpm_loss(m, dev):
        xt = _ddpm_noised(x0, t, noise, abar).to(dev)
        return F.mse_loss(m(xt, _ddpm_temb(t, c["ch"]).to(dev)),
                          noise.to(dev))
    card_l, cpu_l = first_loss(models, ddpm_loss, False)
    if not abs(card_l - cpu_l) <= NN_PARITY_TOL * abs(cpu_l):
        raise AssertionError(f"spatial_models ddpm: first-step loss "
                             f"{card_l} on the card, {cpu_l} on the CPU")
    model = models[device]
    del models
    gc.collect()
    params = sum(p.numel() for p in model.parameters())
    with _paddle_device(device):
        opt = paddle.optimizer.Adam(c["lr"], parameters=model.parameters())
    dgen = torch.Generator(device=device).manual_seed(c["seed"] + 1)
    B = c["batch"]
    x0_d = (torch.rand(B, 3, c["px"], c["px"], generator=gen) * 2 - 1).to(
        device)
    abar_d = abar.to(device)

    def d_step():
        tt = torch.randint(0, c["timesteps"], (B,), device=device,
                           generator=dgen)
        eps = torch.randn(x0_d.shape, device=device, generator=dgen)
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.mse_loss(model(_ddpm_noised(x0_d, tt, eps, abar_d),
                                    _ddpm_temb(tt, c["ch"])), eps)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    # reckoned: fp32 parameters, gradients and two Adam moments (16 bytes
    # a parameter) plus the activations autograd keeps, about 60 tensors
    # of [B, 128..256, 32..4, 32..4] a level in bf16 and fp32 (the
    # GroupNorms run in fp32 under O1): ~5 GB at B 128
    reckoned_gb = (16 * params + 5e9) / 1e9
    tr = _spatial_train_report("ddpm", model, d_step, c, device, B)
    emit("spatial_models", part="ddpm_cifar10_unet", config=(
        "Ho et al. 2020 App. B, the official diffusion repo's cifar10 "
        "config: ch 128, ch_mult (1, 2, 2, 2), 2 res blocks a level, "
        "attention at 16x16, dropout 0.1, GroupNorm(32), SiLU; epsilon "
        "MSE, T 1000, linear betas 1e-4 -> 0.02"), batch=B, px=c["px"],
        amp="O1 bfloat16", optimizer=f"Adam({c['lr']})",
        parity_batch=pb, first_step_loss_card=card_l,
        first_step_loss_cpu=cpu_l, parity_tol=NN_PARITY_TOL,
        memory_reckoned_gb=reckoned_gb, **tr,
        nvidia_smi=_nvidia_smi() if cuda else None)
    del model, opt, d_step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # (b) the 3D U-Net
    c = cfg["unet3d"]
    gen = torch.Generator().manual_seed(c["seed"])
    models = build(_unet3d, c)
    pt = c["parity_tile"]
    px = torch.randn(1, c["in_ch"], *pt, generator=gen)
    plab = torch.randint(0, c["classes"],
                         (1, *_unet3d_out(pt, c["levels"])), generator=gen)

    def voxel_ce(logits, labels):
        return F.cross_entropy(logits.permute(0, 2, 3, 4, 1), labels)

    def u_loss(m, dev):
        return voxel_ce(m(px.to(dev)), plab.to(dev))
    card_l, cpu_l = first_loss(models, u_loss, True)
    if not abs(card_l - cpu_l) <= NN_PARITY_TOL * abs(cpu_l):
        raise AssertionError(f"spatial_models unet3d: first-step loss "
                             f"{card_l} on the card, {cpu_l} on the CPU")
    model = models[device]
    del models
    gc.collect()
    params = sum(p.numel() for p in model.parameters())
    with _paddle_device(device):
        opt = paddle.optimizer.Adam(c["lr"], parameters=model.parameters())
    out_sz = _unet3d_out(c["tile"], c["levels"])
    x = torch.randn(1, c["in_ch"], *c["tile"], generator=gen).to(device)
    lab = torch.randint(0, c["classes"], (1, *out_sz), generator=gen).to(
        device)

    def u_step():
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = voxel_ce(model(x), lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    # reckoned: the level-0 maps, 1.8M voxels x 32 / 64 channels, each
    # kept as the bf16 conv output, the fp32 BatchNorm output (BatchNorm
    # is on the O1 block list) and the ReLU output: ~2.6 GB; the deeper
    # levels an eighth as much each, the synthesis path about as much
    # again: ~7 GB with the parameters' 0.3 GB
    reckoned_gb = 7.0
    tr = _spatial_train_report("unet3d", model, u_step, c, device, 1)
    emit("spatial_models", part="unet3d", config=(
        "Cicek et al. 2016 sec. 2: two valid 3x3x3 convs + BN + ReLU a "
        "level, 32 -> 512 channels, 2x2x2 max pool, 2x2x2 up-conv stride "
        "2, 1x1x1 head to 3 classes; tile 3 x 132 x 132 x 116 -> 44 x 44 "
        "x 28"), tile=list(c["tile"]), out=out_sz, amp="O1 bfloat16",
        optimizer=f"Adam({c['lr']})", parity_tile=list(pt),
        first_step_loss_card=card_l, first_step_loss_cpu=cpu_l,
        parity_tol=NN_PARITY_TOL, memory_reckoned_gb=reckoned_gb, **tr,
        seconds=time.perf_counter() - t_phase,
        nvidia_smi=_nvidia_smi() if cuda else None)
    del model, opt, u_step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


# ------------------------------------------------ ops and the Tensor ---

def _ops_parity_cases(seed):
    """(name, call(paddle, *args), args, kind) of every op of the port's
    table, its other ops, the method table, the dunders and the ``op_``
    family; ``args`` are CPU tensors (or Python values) drawn from
    ``seed``.  ``kind``: "value" (held entry by entry), "qr" / "svd" /
    "eigh" / "eig" / "eigvals" (by reconstruction), "random" ((mean, std,
    lo, hi) of the draw), "inplace" (identity and value)."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops._generated import TABLE
    g = torch.Generator().manual_seed(seed)

    def f(*s, lo=None, hi=None):
        if lo is not None:
            return torch.rand(s, generator=g) * (hi - lo) + lo
        return torch.randn(s, generator=g)

    def i(*s, lo=0, hi=5):
        return torch.randint(lo, hi, s, generator=g)

    def b(*s):
        return torch.rand(s, generator=g) < 0.5

    def spd(n):
        a = f(n, n)
        return a @ a.T + n * torch.eye(n)

    cases = []

    def op(name, *args, kind="value", method=True, **kw):
        cases.append((name, lambda P, *a, _n=name.split("[")[0], _k=kw:
                      getattr(P, _n)(*a, **_k), args, kind))
        n = name.split("[")[0]
        if method and args and torch.is_tensor(args[0]) and \
                hasattr(paddle.Tensor, n) and kind == "value" and \
                n in ops._METHODS:
            cases.append((name + ".method", lambda P, x, *a, _n=n, _k=kw:
                          getattr(x, _n)(*a, **_k), args, kind))

    def call(name, fn, *args, kind="value"):
        cases.append((name, fn, args, kind))
    pos = {"log", "log2", "log10", "log1p", "sqrt", "rsqrt", "reciprocal",
           "lgamma", "gammaln", "digamma", "acosh", "pow", "gammainc",
           "gammaincc"}
    unit = {"asin", "acos", "atanh", "erfinv", "logit"}
    ints = {"bitwise_not", "gcd", "lcm", "bitwise_and", "bitwise_or",
            "bitwise_xor", "bitwise_left_shift", "bitwise_right_shift",
            "floor_mod", "remainder", "mod", "floor_divide"}
    bools = {"logical_not", "logical_and", "logical_or", "logical_xor",
             "all", "any"}

    def x_for(n):
        if n in bools:
            return b(6, 7)
        if n in ints:
            return i(6, 7, lo=1, hi=30)
        if n in pos:
            return f(6, 7, lo=1.1 if n == "acosh" else 0.5, hi=2.5)
        if n in unit:
            return f(6, 7, lo=0.1, hi=0.9)
        return f(6, 7)
    for row in TABLE:
        for n in (row[0],) + tuple(row[3]):
            x = x_for(n)
            if row[1] == "unary":
                op(n, x)
            elif row[1] == "binary":
                y = i(7, lo=0, hi=4) if n.startswith("bitwise_") and \
                    "shift" in n else x_for(n)[0]
                op(n, x, y)
                if n in ("add", "multiply", "divide", "pow", "maximum"):
                    op(n + "[scalar]", x, 2.0, method=False)
            else:
                op(n, x)
                op(n + "[axis]", x, axis=1, keepdim=True)
    sq = f(5, 5) + 5 * torch.eye(5)
    low = f(8, 2) @ f(2, 6)
    hh, tau = torch.geqrf(f(6, 4))
    chol = torch.linalg.cholesky(spd(4))
    x3 = f(3, 4, 5)
    for spec in (
            ("scale", (f(4, 5),), dict(scale=2.0, bias=1.0)),
            ("clip", (f(4, 5),), dict(min=-0.5, max=0.5)),
            ("lerp", (f(4, 5), f(4, 5), 0.3), {}),
            ("stanh", (f(4, 5),), {}), ("std", (f(4, 5),), dict(axis=1)),
            ("var", (f(4, 5),), {}), ("median", (f(4, 6),), dict(axis=1)),
            ("quantile", (f(4, 6), 0.3), dict(axis=1)),
            ("nanmedian", (f(4, 6),), {}), ("cumsum", (f(4, 5),),
                                            dict(axis=1)),
            ("cumprod", (f(4, 5),), dict(dim=0)),
            ("cummax", (f(4, 5),), dict(axis=1)),
            ("cummin", (f(4, 5),), dict(axis=0)),
            ("logcumsumexp", (f(4, 5),), dict(axis=1)),
            ("argmax", (f(4, 5),), dict(axis=1)), ("argmin", (f(4, 5),), {}),
            ("allclose", (f(4, 5), f(4, 5)), {}),
            ("isclose", (f(4, 5), f(4, 5)), dict(atol=1.0)),
            ("equal_all", (i(4, 5), i(4, 5)), {}),
            ("kron", (f(2, 3), f(3, 2)), {}), ("diff", (f(4, 5),), {}),
            ("trapezoid", (f(4, 5),), dict(dx=0.5)),
            ("nan_to_num", (f(4, 5).log(),), {}),
            ("renorm", (f(4, 5), 2.0, 0, 1.0), {}),
            ("addmm", (f(3, 2), f(3, 4), f(4, 2)), {}),
            ("polygamma", (f(4, lo=0.5, hi=2), 1), {}),
            ("multiplex", ([f(4, 3), f(4, 3)], i(4, 1, hi=2)), {}),
            ("zeros_like", (f(2, 3),), {}), ("ones_like", (f(2, 3),), {}),
            ("full_like", (f(2, 3), 2.5), {}),
            ("empty_like", (f(2, 3),), {}), ("diag", (f(4),), {}),
            ("diagflat", (f(2, 2),), {}), ("tril", (f(4, 5),), {}),
            ("triu", (f(4, 5),), dict(diagonal=1)),
            ("assign", (f(3),), {}), ("clone", (f(3),), {}),
            ("complex", (f(3), f(3)), {}),
            ("sort", (f(4, 6),), dict(descending=True)),
            ("argsort", (f(4, 6),), {}), ("topk", (f(4, 6), 2), {}),
            ("kthvalue", (f(4, 6), 2), {}), ("mode", (i(4, 6, hi=3),), {}),
            ("index_select", (f(5, 3), i(4, hi=5)), {}),
            ("masked_select", (f(4, 5), b(4, 5)), {}),
            ("where", (b(4, 5), f(4, 5), f(4, 5)), {}),
            ("nonzero", (b(4, 5),), {}),
            ("bucketize", (f(4, 5), torch.sort(f(6)).values), {}),
            ("searchsorted", (torch.sort(f(6)).values, f(4, 5)), {}),
            ("cast", (f(3, 4), "int32"), {}), ("reshape", (x3, [4, -1]), {}),
            ("flatten", (x3,), dict(start_axis=1)),
            ("unflatten", (f(2, 12), 1, [3, 4]), {}),
            ("transpose", (x3, [2, 0, 1]), {}), ("moveaxis", (x3, 0, 2), {}),
            ("swapaxes", (x3, 0, 2), {}), ("squeeze", (f(1, 3, 1),), {}),
            ("unsqueeze", (f(3, 4), [0, -1]), {}),
            ("concat", ([f(2, 3), f(2, 4)],), dict(axis=1)),
            ("stack", ([f(2, 3), f(2, 3)],), dict(axis=1)),
            ("unstack", (x3,), dict(axis=1)), ("split", (f(6, 4), 3), {}),
            ("split[sections]", (f(6, 4), [1, -1, 2]), {}),
            ("chunk", (f(4, 6), 2), dict(axis=1)),
            ("tile", (f(2, 3), [2, 1, 2]), {}),
            ("expand", (f(1, 3), [4, -1]), {}),
            ("expand_as", (f(3, 1), f(3, 4)), {}),
            ("broadcast_to", (f(3, 1), [2, 3, 4]), {}),
            ("broadcast_tensors", ([f(3, 1), f(1, 4)],), {}),
            ("flip", (x3, [0, 2]), {}), ("roll", (x3, 1), {}),
            ("rot90", (f(3, 4),), dict(k=3)),
            ("repeat_interleave", (f(2, 3), 2), dict(axis=1)),
            ("as_strided", (f(12), [3, 2], [4, 1], 1), {}),
            ("view", (f(3, 4), [2, 6]), {}),
            ("pad", (f(1, 2, 5, 5), [1, 2, 2, 1]), dict(mode="reflect")),
            ("unbind", (x3,), dict(axis=2)), ("unique", (i(20),), {}),
            ("unique[all]", (i(20),), dict(return_index=True,
                                           return_inverse=True,
                                           return_counts=True)),
            ("unique_consecutive", (i(20, hi=3),),
             dict(return_inverse=True, return_counts=True)),
            ("masked_fill", (f(3, 4), b(3, 4), 2.0), {}),
            ("index_sample", (f(3, 5), i(3, 2)), {}),
            ("take_along_axis", (f(3, 5), i(3, 2), 1), {}),
            ("put_along_axis", (f(3, 5), i(3, 1), f(3, 1), 1),
             dict(reduce="add")),
            ("gather", (f(5, 3), i(3, hi=5)), {}),
            ("gather_nd", (f(3, 4, 2), torch.tensor([[0, 1], [2, 3]])), {}),
            ("scatter", (f(5, 3), torch.tensor([3, 1]), f(2, 3)), {}),
            ("scatter_nd_add", (f(4, 3), torch.tensor([[1], [1], [3]]),
                                f(3, 3)), {}),
            ("scatter_nd", (torch.tensor([[0], [2]]), f(2, 3), [4, 3]), {}),
            ("index_add", (f(4, 3), torch.tensor([0, 0, 3]), 0, f(3, 3)),
             {}),
            ("index_put", (f(4, 3), (torch.tensor([0, 3]),), f(2, 3)),
             dict(accumulate=True)),
            ("index_fill", (f(4, 3), torch.tensor([0, 2]), 0, 7.5), {}),
            ("numel", (x3,), {}), ("shard_index", (i(6, 1, hi=20), 20, 2, 1),
                                   {}),
            ("one_hot", (i(5, hi=4), 4), {}), ("bincount", (i(30),), {}),
            ("diagonal", (x3,), dict(offset=1, axis1=1, axis2=2)),
            ("diag_embed", (f(2, 3),), {}),
            ("crop", (f(4, 5),), dict(shape=[2, 3], offsets=[1, 2])),
            ("strided_slice", (f(6, 7), [0, 1], [1, 6], [5, 0], [2, -2]),
             {}),
            ("slice", (f(6, 7), [1], [2], [5]), {}),
            ("tensordot", (x3, f(4, 5, 2)), {}),
            ("atleast_1d", (f(3),), {}), ("atleast_2d", (f(3),), {}),
            ("atleast_3d", (f(3),), {}), ("hsplit", (f(2, 6), 3), {}),
            ("vsplit", (f(4, 3), [1, 3]), {}),
            ("dsplit", (f(2, 2, 4), 2), {}),
            ("hstack", ([f(2, 3), f(2, 1)],), {}),
            ("vstack", ([f(3), f(3)],), {}),
            ("dstack", ([f(2, 3), f(2, 3)],), {}),
            ("column_stack", ([f(3), f(3, 2)],), {}),
            ("row_stack", ([f(2, 3), f(1, 3)],), {}),
            ("tensor_split", (f(7, 2), 3), {}),
            ("as_complex", (f(3, 2),), {}),
            ("fill_diagonal", (f(3, 4), 2.0), {}),
            ("fill_diagonal_tensor", (f(4, 4), f(4)), {}),
            ("matmul", (f(3, 4), f(4, 5)), {}), ("mm", (f(3, 4), f(4, 2)), {}),
            ("dot", (f(5), f(5)), {}), ("inner", (f(3, 4), f(2, 4)), {}),
            ("outer", (f(3), f(4)), {}),
            ("bmm", (f(2, 3, 4), f(2, 4, 2)), {}),
            ("mv", (f(3, 4), f(4)), {}), ("t", (f(3, 4),), {}),
            ("cross", (f(3, 4), f(3, 4)), {}), ("norm", (f(3, 4),), {}),
            ("norm[p1]", (f(3, 4),), dict(p=1, axis=1)),
            ("vector_norm", (f(3, 4),), dict(p=3.0, axis=1)),
            ("matrix_norm", (f(2, 3, 4),), {}),
            ("dist", (f(3, 4), f(3, 4)), {}),
            ("histogram", (f(50),), dict(bins=5)),
            ("histogramdd", (f(30, 2),), dict(bins=3)),
            ("matrix_power", (f(3, 3), 3), {}),
            ("eigvalsh", (spd(4),), {}), ("det", (sq,), {}),
            ("slogdet", (sq,), {}), ("inv", (sq,), {}),
            ("pinv", (f(4, 3),), {}), ("solve", (sq, f(5, 2)), {}),
            ("triangular_solve", (torch.triu(sq), f(5, 2)), {}),
            ("cholesky", (spd(4),), {}),
            ("cholesky_solve", (f(4, 2), chol), {}), ("lu", (sq,), {}),
            ("matrix_rank", (low,), {}), ("lstsq", (f(6, 3), f(6, 2)), {}),
            ("cov", (f(3, 6),), {}), ("corrcoef", (f(3, 6),), {}),
            ("trace", (f(4, 4),), dict(offset=1)),
            ("multi_dot", ([f(3, 4), f(4, 5), f(5, 2)],), {}),
            ("cond", (sq,), {}), ("ormqr", (hh, tau, f(6, 2)), {}),
            ("householder_product", (hh, tau), {}),
            ("vander", (f(4),), dict(n=3)),
            ("block_diag", ([f(2, 2), f(1, 3)],), {}),
            ("polar", (f(3, lo=0.5, hi=2), f(3)), {}), ("sgn", (f(3, 4),), {}),
            ("add_n", ([f(3, 4), f(3, 4)],), {}),
            ("take", (f(3, 4), torch.tensor([[0, 5], [-1, 11]])), {}),
            ("isin", (i(3, 4), torch.tensor([1, 3])), {}),
            ("isneginf", (f(5).log(),), {}), ("isposinf", (1 / f(5),), {}),
            ("nanquantile", (f(4, 6), 0.25), dict(axis=1)),
            ("histogram_bin_edges", (f(20),), dict(bins=4)),
            ("cumulative_trapezoid", (f(3, 5),), {}),
            ("frexp", (f(3, 4) * 10,), {}),
            ("multigammaln", (f(3, lo=2, hi=4), 3), {}),
            ("matrix_exp", (f(3, 3) * 0.3,), {}),
            ("cholesky_inverse", (chol,), {}),
            ("cdist", (f(4, 3), f(5, 3)), {}),
            ("cartesian_prod", ([i(3), i(2)],), {}),
            ("combinations", (f(4),), {}),
            ("diagonal_scatter", (f(3, 4), f(3)), dict(offset=1)),
            ("select_scatter", (f(3, 4), f(4), 0, 1), {}),
            ("slice_scatter", (f(5, 4), f(2, 4), [0], [1], [5], [2]), {}),
            ("masked_scatter", (f(3, 4), b(3, 4), f(12)), {}),
            ("is_empty", (f(0, 3),), {}), ("view_as", (f(3, 4), f(6, 2)), {}),
            ("unfold", (f(3, 8), 1, 3, 2), {}), ("shape", (x3,), {}),
            ("rank", (x3,), {}), ("reverse", (x3, [1]), {}),
            ("pdist", (f(4, 3),), {}),
            ("reduce_as", (f(2, 3, 4), f(3, 1)), {})):
        op(spec[0], *spec[1], **spec[2])
    for name, fn in (
            ("zeros", lambda P: P.zeros([2, 3], "int32")),
            ("ones", lambda P: P.ones([2, 3])),
            ("full", lambda P: P.full([2, 3], 1.5)),
            ("empty", lambda P: P.empty([2, 3])),
            ("arange", lambda P: P.arange(2, 11, 3)),
            ("linspace", lambda P: P.linspace(0.0, 1.0, 5)),
            ("logspace", lambda P: P.logspace(0.0, 2.0, 3)),
            ("eye", lambda P: P.eye(3, 4)),
            ("meshgrid", lambda P: P.meshgrid(P.arange(3), P.arange(2))),
            ("tril_indices", lambda P: P.tril_indices(4, 3, 0)),
            ("triu_indices", lambda P: P.triu_indices(3, 4, 1)),
            ("fill_constant", lambda P: P.fill_constant([2], "int32", 4)),
            ("to_tensor", lambda P: P.to_tensor([[1.0, 2.0]])),
            ("create_tensor", lambda P: P.create_tensor("int32")),
            ("array", lambda P: P.array_read(P.array_write(
                P.ones([2]), 0), 0))):
        call(name, fn)
    for name, args, k in (("qr", (f(5, 3),), "qr"),
                          ("svd", (f(5, 3),), "svd"),
                          ("eigh", (spd(4),), "eigh"),
                          ("eig", (f(4, 4),), "eig"),
                          ("eigvals", (f(4, 4),), "eigvals")):
        op(name, *args, kind=k)
    n = OPS_PARITY["draws"]
    for name, fn, moments in (
            ("randn", lambda P: P.randn([n]), (0.0, 1.0, None, None)),
            ("rand", lambda P: P.rand([n]), (0.5, 12 ** -0.5, 0.0, 1.0)),
            ("uniform", lambda P: P.uniform([n], min=2.0, max=4.0),
             (3.0, 2 * 12 ** -0.5, 2.0, 4.0)),
            ("normal", lambda P: P.normal(1.0, 2.0, [n]),
             (1.0, 2.0, None, None)),
            ("gaussian", lambda P: P.gaussian([n], mean=-1.0, std=0.5),
             (-1.0, 0.5, None, None)),
            ("standard_normal", lambda P: P.standard_normal([n]),
             (0.0, 1.0, None, None)),
            ("randint", lambda P: P.randint(0, 10, [n]),
             (4.5, (99 / 12) ** 0.5, 0, 9)),
            ("randperm", lambda P: P.randperm(n).float(),
             ((n - 1) / 2, ((n * n - 1) / 12) ** 0.5, 0, n - 1)),
            ("multinomial", lambda P: P.multinomial(
                P.to_tensor([0.2, 0.3, 0.5]), n, True).float(),
             (1.3, 0.61 ** 0.5, 0, 2)),
            ("bernoulli", lambda P: P.bernoulli(P.full([n], 0.3)),
             (0.3, 0.21 ** 0.5, 0, 1)),
            ("poisson", lambda P: P.poisson(P.full([n], 4.0)),
             (4.0, 2.0, 0, None)),
            ("binomial", lambda P: P.binomial(
                P.full([n], 10), P.full([n], 0.3)).float(),
             (3.0, 2.1 ** 0.5, 0, 10)),
            ("exponential_", lambda P: P.exponential_(P.zeros([n]), 2.0),
             (0.5, 0.5, 0.0, None)),
            ("normal_", lambda P: P.normal_(P.zeros([n]), 1.0, 3.0),
             (1.0, 3.0, None, None)),
            ("uniform_", lambda P: P.uniform_(P.zeros([n]), 0.0, 2.0),
             (1.0, 2 * 12 ** -0.5, 0.0, 2.0)),
            ("bernoulli_", lambda P: P.bernoulli_(P.zeros([n]), 0.3),
             (0.3, 0.21 ** 0.5, 0, 1)),
            ("log_normal_", lambda P: P.log(P.log_normal_(P.zeros([n]),
                                                          1.0, 0.5)),
             (1.0, 0.5, None, None)),
            ("geometric_", lambda P: P.geometric_(P.zeros([n]), 0.4),
             (-1 / math.log1p(-0.4), None, 0.0, None)),
            ("rand_like", lambda P: P.rand_like(P.zeros([n])),
             (0.5, 12 ** -0.5, 0.0, 1.0)),
            ("randn_like", lambda P: P.randn_like(P.zeros([n])),
             (0.0, 1.0, None, None)),
            ("randint_like", lambda P: P.randint_like(P.zeros([n]), 3, 7),
             (4.5, (15 / 12) ** 0.5, 3, 6)),
            ("log_normal", lambda P: P.log(P.log_normal(0.0, 0.5, [n])),
             (0.0, 0.5, None, None)),
            ("standard_gamma", lambda P: P.standard_gamma(P.full([n], 3.0)),
             (3.0, 3 ** 0.5, 0.0, None)),
            ("top_p_sampling", lambda P: P.top_p_sampling(
                P.to_tensor([[0.1, 0.5, 0.4]] * n), P.full([n], 0.8)
            )[1].float(), (1 + 0.4 / 0.9, (0.5 * 0.4) ** 0.5 / 0.9, 1, 2))):
        call(name, fn, kind=("random",) + moments)
    # the op_ family: identity and value on a non-leaf
    for name in [v for v in ops.__all__ if v.endswith("_") and
                 v[:-1] in ops.extras.INPLACE_BASES]:
        base = name[:-1]
        x = x_for(base)
        extra = {"clip": (-0.5, 0.5), "lerp": (x_for("lerp"), 0.25),
                 "cumsum": (1,), "cumprod": (1,), "fill_diagonal": (2.0,),
                 "squeeze": (0,), "unsqueeze": (0,), "cast": ("float64",),
                 "scatter": (torch.tensor([2, 0]), f(2, 7)),
                 "index_add": (torch.tensor([1, 1]), 0, f(2, 7)),
                 "index_put": ((torch.tensor([0, 2]),), f(2, 7)),
                 "masked_fill": (b(6, 7), 0.5),
                 "put_along_axis": (i(6, 1, hi=7), f(6, 1), 1),
                 "transpose": ([1, 0],), "t": (), "flatten": (),
                 "tril": (), "triu": (1,), "nan_to_num": ()}
        if base in extra:
            args = (x,) + extra[base]
        else:
            fn = getattr(ops, base)
            args = (x, x_for(base)) if any(
                r[0] == base and r[1] == "binary" for r in TABLE) or \
                base in ("remainder",) else (x,)
            del fn
        if base == "squeeze":
            args = (f(1, 6, 7), 0)
        def inplace(P, x, *a, _n=name):
            y = x * 1 if x.dtype != torch.bool else P.logical_and(x, x)
            out = getattr(P, _n)(y, *a)
            return out, out is y
        call(name, inplace, *args, kind="inplace")
    # the dunders
    xa, ya = f(4, 5), f(4, 5, lo=0.5, hi=2.0)
    xi, yi = i(4, 5, lo=-4, hi=4), i(4, 5, lo=1, hi=4)
    for tag, x, y in (("float", xa, ya), ("int", xi, yi)):
        for name, fn in (
                ("add", lambda P, x, y: x + y), ("radd", lambda P, x, y: 2 + x),
                ("sub", lambda P, x, y: x - y),
                ("rsub", lambda P, x, y: 1.5 - x),
                ("mul", lambda P, x, y: x * y), ("rmul", lambda P, x, y: 3 * x),
                ("truediv", lambda P, x, y: x / y),
                ("rtruediv", lambda P, x, y: 2.0 / y),
                ("floordiv", lambda P, x, y: x // y),
                ("mod", lambda P, x, y: x % y),
                ("pow", lambda P, x, y: y ** 2),
                ("neg", lambda P, x, y: -x), ("abs", lambda P, x, y: abs(x)),
                ("eq", lambda P, x, y: x == y), ("ne", lambda P, x, y: x != y),
                ("lt", lambda P, x, y: x < y), ("le", lambda P, x, y: x <= y),
                ("gt", lambda P, x, y: x > y), ("ge", lambda P, x, y: x >= y),
                ("invert", lambda P, x, y: ~x),
                ("and", lambda P, x, y: x & y), ("or", lambda P, x, y: x | y),
                ("xor", lambda P, x, y: x ^ y),
                ("getitem", lambda P, x, y: [x[1], x[:, 1:3], x[x > 0],
                                             x[[0, 2]]])):
            call(f"__{name}__[{tag}]", fn, x, y)
    call("__matmul__", lambda P, x, y: x @ y, f(3, 4), f(4, 2))
    return cases


def _ops_parity_compare(kind, got, want):
    """(bad, err) of one ops_parity case: floats by train_parity's rule at
    NN_PARITY_TOL (NaN where the CPU has NaN), integers, bools and indices
    exactly, decompositions by reconstruction, draws by moments."""
    import torch

    def leaves(v):
        """Flat, tensors as plain ones (the comparison is torch code)."""
        if isinstance(v, (list, tuple)):
            return [e for x in v for e in leaves(x)]
        return [v.as_subclass(torch.Tensor) if torch.is_tensor(v) else v]
    g, w = leaves(got), leaves(want)
    if kind == "value":
        if len(g) != len(w):
            return 1, float("inf")
        bad, err = 0, 0.0
        for a, c in zip(g, w):
            if not torch.is_tensor(c):
                bad += int(a != c)
                continue
            if a.dtype != c.dtype or tuple(a.shape) != tuple(c.shape):
                return 1, float("inf")
            a = a.detach().cpu()
            if c.is_floating_point() or c.is_complex():
                a, c = torch.view_as_real(a.cfloat()) if c.is_complex() \
                    else a.float(), torch.view_as_real(c.cfloat()) \
                    if c.is_complex() else c.float()
                both_nan = torch.isnan(a) & torch.isnan(c)
                a = torch.where(both_nan, torch.zeros_like(a), a)
                c = torch.where(both_nan, torch.zeros_like(c), c)
                same_inf = torch.isinf(c) & (a == c)
                a = torch.where(same_inf, torch.zeros_like(a), a)
                c = torch.where(same_inf, torch.zeros_like(c), c)
                nb, e = _parity_bad(a, c, NN_PARITY_TOL) if c.numel() \
                    else (0, 0.0)
                bad, err = bad + nb, max(err, e)
            else:
                nb = int((a != c).sum())
                bad, err = bad + nb, max(err, float(nb))
        return bad, err
    if kind in ("qr", "svd", "eigh", "eig", "eigvals"):
        a = [v.detach().cpu().double() if not v.is_complex()
             else v.detach().cpu().cdouble() for v in g]
        c = [v.double() if not v.is_complex() else v.cdouble() for v in w]
        if kind == "qr":
            e = (a[0] @ a[1] - c[0] @ c[1]).abs().max()
        elif kind == "svd":
            e = ((a[0] * a[1]) @ a[2] - (c[0] * c[1]) @ c[2]).abs().max()
        elif kind == "eigh":
            e = ((a[1] * a[0]) @ a[1].T - (c[1] * c[0]) @ c[1].T).abs().max()
        else:
            key = (lambda v: torch.sort(v.real * 1e3 + v.imag).values)
            e = (key(a[0]) - key(c[0])).abs().max()
        e = float(e)
        return int(e > 1e-3), e
    if kind[0] == "random":
        mean, std, lo, hi = kind[1:]
        v = g[0].detach().cpu().double()
        bad = int(tuple(g[0].shape) != tuple(w[0].shape) or
                  g[0].dtype != w[0].dtype)
        err = abs(float(v.mean()) - mean) / max(1.0, abs(mean))
        bad += int(err > 0.05)
        if std is not None:
            e2 = abs(float(v.std()) - std) / max(1.0, std)
            err = max(err, e2)
            bad += int(e2 > 0.05)
        if lo is not None:
            bad += int(float(v.min()) < lo)
        if hi is not None:
            bad += int(float(v.max()) > hi)
        return bad, err
    raise ValueError(kind)


def phase_ops_parity(cfg=None, device="cuda"):
    """Every op of the port's table, its other ops, the method table, the
    dunders and the ``op_`` family (``_ops_parity_cases``) on ``device``
    against the port on the CPU, fp32 with TF32 off: floats by
    train_parity's rule at NN_PARITY_TOL, integer, bool and index results
    exactly, decompositions by reconstruction, random ops by support and
    moments (OPS_PARITY["draws"] draws), each ``op_`` returning its input
    with the value of its op.  Prints the worst case and its name.  No
    Pallas kernel is on this path."""
    import torch
    import paddle_tpu_torch as paddle
    c = cfg or OPS_PARITY
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    worst, failed, counts = ("", 0.0), {}, {}

    def put(v, dev):
        if torch.is_tensor(v):
            return paddle.to_tensor(v, place=dev)
        if isinstance(v, (list, tuple)):
            return type(v)(put(e, dev) for e in v)
        return v
    try:
        cases = _ops_parity_cases(c["seed"])
        for name, fn, args, kind in cases:
            kname = kind if isinstance(kind, str) else kind[0]
            counts[kname] = counts.get(kname, 0) + 1
            outs = {}
            for dev in ("cpu", device):
                with _paddle_device(dev):
                    paddle.seed(c["seed"])
                    a = put(args, dev)
                    outs[dev] = fn(paddle, *a)
            if kind == "inplace":
                # identity: the op_ returns the non-leaf it wrote into;
                # value: the CPU's op_ result, entry by entry
                bad, err = _ops_parity_compare("value", outs[device][0],
                                               outs["cpu"][0])
                bad += int(not (outs[device][1] and outs["cpu"][1]))
            else:
                bad, err = _ops_parity_compare(kind, outs[device],
                                               outs["cpu"])
            if kname == "value" and err > worst[1]:
                worst = (name, err)
            if bad:
                failed[name] = (bad, err)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    emit("ops_parity", cases=len(cases), by_kind=counts,
         worst_case=worst[0], worst_err=worst[1], tol=NN_PARITY_TOL,
         failed=failed, seconds=time.perf_counter() - t0,
         nvidia_smi=_nvidia_smi() if device == "cuda" else None)
    if failed:
        raise AssertionError(f"ops_parity: {len(failed)} of {len(cases)} "
                             f"cases off: {failed}")
    return worst


def phase_tensor_paths(cfg=None, device="cuda"):
    """The slice at full published width.  (a) The Transformer base
    (TENSOR_PATHS["transformer"], SEQ_MODELS' widths, O1 bf16) trained
    twice in one call, interleaved, from the same parameters and the same
    generator state (so the same dropout draws): once on a batch made by
    ``paddle.to_tensor`` (``Tensor`` flows in), once on the same batch as
    plain tensors.  Gates: a bit-for-bit equal first-step loss, equal
    device kernel launches a step (the profiler's), 0 builds and 0 syncs in
    the timed steps, timed in turns (tensor, plain, plain, tensor).
    Printed: ms a step each, the idle share, the
    ``Tensor.__torch_function__`` entries a step.  (b) The tensor's
    card-side surface: ``place``, ``cpu()`` / ``cuda()``, ``numpy()`` one
    marked sync, ``astype``, ``stop_gradient``, ``set_value``, the
    ``shape`` / ``size`` idioms, and one marked sync each for the ops whose
    output shape the data decides."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.core import tensor as ct
    c = (cfg or TENSOR_PATHS)["transformer"]
    cuda = device == "cuda"
    F = paddle.nn.functional
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(c["seed"])
    src = torch.randint(0, c["vocab"], (c["batch"], c["src"]), generator=gen)
    tgt = torch.randint(0, c["vocab"], (c["batch"], c["tgt"] + 1),
                        generator=gen)
    with _paddle_device(device):
        paddle.seed(c["seed"])
        model_t = _seq2seq_model(paddle, c["vocab"], c["d_model"],
                                 c["heads"], c["layers"], c["ffn"],
                                 c["dropout"], max(c["src"], c["tgt"]))
        model_p = _seq2seq_model(paddle, c["vocab"], c["d_model"],
                                 c["heads"], c["layers"], c["ffn"],
                                 c["dropout"], max(c["src"], c["tgt"]))
        model_p.set_state_dict(model_t.state_dict())
        mask = model_t.transformer.generate_square_subsequent_mask(c["tgt"])
        batches = {
            "tensor": (paddle.to_tensor(src), paddle.to_tensor(
                tgt[:, :-1]), paddle.to_tensor(tgt[:, 1:])),
            "plain": (src.to(device), tgt[:, :-1].to(device),
                      tgt[:, 1:].to(device))}
        runs = {}
        for key, model in (("tensor", model_t), ("plain", model_p)):
            sched = paddle.optimizer.lr.NoamDecay(c["d_model"],
                                                  c["warmup_steps"])
            opt = paddle.optimizer.Adam(sched, 0.9, 0.98, 1e-9,
                                        parameters=model.parameters())
            s, ti, to = batches[key]

            def step(model=model, opt=opt, sched=sched, s=s, ti=ti, to=to):
                with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                    loss = _smoothed_ce(F, model(s, ti, mask), to,
                                        c["vocab"], c["smoothing"])
                loss.backward()
                opt.step()
                opt.clear_grad()
                sched.step()
                return loss.detach()
            runs[key] = step
    assert isinstance(batches["tensor"][0], paddle.Tensor)
    assert type(batches["plain"][0]) is torch.Tensor
    gen_state = (paddle.get_rng_state(), torch.get_rng_state(),
                 torch.cuda.get_rng_state_all() if cuda else None)
    first = {}
    for key in ("tensor", "plain"):
        paddle.set_rng_state(gen_state[0])
        torch.set_rng_state(gen_state[1])
        if cuda:
            torch.cuda.set_rng_state_all(gen_state[2])
        first[key] = runs[key]()
    first = {k: float(v) for k, v in first.items()}
    if first["tensor"] != first["plain"] or not math.isfinite(
            first["tensor"]):
        raise AssertionError(f"tensor_paths: first-step losses {first}")
    for _ in range(c["warmup"]):
        for key in ("tensor", "plain"):
            runs[key]()
    # timed in turns (tensor, plain, plain, tensor): the host's drift
    # between blocks falls on both runs alike
    result = {k: dict(block_ms=[], losses=[], entries=0)
              for k in ("tensor", "plain")}
    for key in ("tensor", "plain", "plain", "tensor"):
        entries0 = ct.TORCH_FUNCTION_ENTRIES[0]
        losses, step_s = _train_steps_without_sync(runs[key], c["steps"],
                                                   device)
        result[key]["entries"] += ct.TORCH_FUNCTION_ENTRIES[0] - entries0
        result[key]["block_ms"].append(step_s * 1e3)
        result[key]["losses"] += [float(v) for v in losses]
    for key, r in result.items():
        if not all(math.isfinite(v) for v in r["losses"]):
            raise AssertionError(f"tensor_paths {key}: losses {r['losses']}")
        step_s = sum(r["block_ms"]) / len(r["block_ms"]) / 1e3
        r.update(step_ms=step_s * 1e3, tokens_per_s=c["batch"] * c["tgt"] /
                 step_s, torch_function_entries_a_step=r.pop("entries") /
                 len(r["losses"]))
        if cuda:
            prof = _profile_breakdown(runs[key], step_s * 1e3, top=4)
            r.update(launches_a_step=prof["launches"],
                     idle_share=prof["idle_share"],
                     device_busy_ms=prof["device_busy_ms"])
    if cuda and result["tensor"]["launches_a_step"] != \
            result["plain"]["launches_a_step"]:
        raise AssertionError(f"tensor_paths: launches a step "
                             f"{result['tensor']['launches_a_step']} "
                             f"(Tensor batch) != "
                             f"{result['plain']['launches_a_step']} (plain)")
    emit("tensor_paths", part="transformer_base_tensor_vs_plain", config=(
        "Vaswani et al. 2017 base (SEQ_MODELS): d_model 512, 8 heads, 6+6 "
        "layers, FFN 2048, vocabulary 37000"), batch=c["batch"],
         src=c["src"], tgt=c["tgt"], amp="O1 bfloat16",
         first_step_loss=first, warmup_steps=c["warmup"],
         timed_steps=2 * c["steps"], builds_after_warmup=0,
         syncs_in_timed_steps=0, **result,
         nvidia_smi=_nvidia_smi() if cuda else None)
    del runs, model_t, model_p, batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    surface = _tensor_surface(paddle, device)
    emit("tensor_paths", part="card_surface", **surface,
         seconds=time.perf_counter() - t_phase)
    return result


def _tensor_surface(paddle, device):
    """The tensor's card-side surface, each check an assertion; returns
    the marked syncs each data-dependent-shape op counted."""
    import numpy as np
    import torch
    from paddle_tpu_torch import observability as obs
    cuda = device == "cuda"
    with _paddle_device(device):
        x = paddle.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
        want_place = f"gpu:{torch.cuda.current_device()}" if cuda \
            else "cpu:0"
        assert x.place == want_place, x.place
        host = x.cpu()
        assert isinstance(host, paddle.Tensor) and host.place == "cpu:0"
        if cuda:
            back = host.cuda()
            assert isinstance(back, paddle.Tensor) and \
                back.place == want_place
        s0 = obs.device_syncs()
        arr = x.numpy()
        numpy_syncs = obs.device_syncs() - s0
        assert numpy_syncs == (1 if cuda else 0), numpy_syncs
        assert arr.shape == (3, 4) and arr[2, 3] == 11.0
        y = x.astype("int32")
        assert y.dtype == torch.int32 and y.place == want_place
        assert x.stop_gradient
        x.stop_gradient = False
        assert x.requires_grad and x.is_leaf
        x.stop_gradient = True
        x.set_value(np.ones((3, 4)))
        assert float(x.sum()) == 12.0 and x.place == want_place
        assert x.shape == [3, 4] and x.shape[:-1] + [5] == [3, 5]
        assert x.size == 12 and x.size(1) == 4
        assert x.shape + (1,) == (3, 4, 1) and x.shape.numel() == 12
        v = paddle.to_tensor(np.array([3, 1, 3, 0, 2, 2], np.int64))
        m = v > 1
        data_dependent = {}
        for name, fn in (("unique", lambda: paddle.unique(v)),
                         ("nonzero", lambda: paddle.nonzero(m)),
                         ("masked_select", lambda: paddle.masked_select(
                             v, m)),
                         ("bincount", lambda: paddle.bincount(v)),
                         ("histogram", lambda: paddle.histogram(
                             v.astype("float32"), bins=4)),
                         ("getitem_mask", lambda: v[m])):
            s0 = obs.device_syncs()
            out = fn()
            data_dependent[name] = obs.device_syncs() - s0
            assert isinstance(out, paddle.Tensor)
        if cuda:
            assert all(n == 1 for n in data_dependent.values()), \
                data_dependent
    return dict(place=want_place, numpy_marked_syncs=numpy_syncs,
                marked_syncs=data_dependent)


# ------------------------------------------- optimizers, framework core ---

def _optim_cases(paddle):
    """(name, make(params) -> optimizer-like) for every optimizer of the
    port, the regularizers (``L1`` / ``L2`` on the first parameter),
    ``LookAhead`` over Adam and ``ModelAverage`` over SGD (its ``step``
    after the inner one, then ``apply``)."""
    o = paddle.optimizer
    clip = paddle.nn.ClipGradByGlobalNorm

    def reg(kind, make):
        def build(ps):
            ps[0].regularizer = getattr(paddle.regularizer, kind)(0.05)
            return make(ps)
        return build
    return [
        ("sgd", lambda ps: o.SGD(0.1, parameters=ps, weight_decay=0.01)),
        ("momentum", lambda ps: o.Momentum(0.1, 0.9, parameters=ps,
                                           use_nesterov=True,
                                           weight_decay=1e-3)),
        ("adam", lambda ps: o.Adam(0.01, parameters=ps, weight_decay=0.01,
                                   grad_clip=clip(2.0))),
        ("adamw", lambda ps: o.AdamW(0.01, parameters=ps, weight_decay=0.05,
                                     lr_ratio=lambda p: 0.5)),
        ("adamax", lambda ps: o.Adamax(0.05, parameters=ps,
                                       weight_decay=0.01)),
        ("rmsprop_centered", lambda ps: o.RMSProp(
            0.01, rho=0.9, momentum=0.5, centered=True, parameters=ps)),
        ("adagrad", lambda ps: o.Adagrad(0.1, parameters=ps,
                                         initial_accumulator_value=0.1)),
        ("adadelta", lambda ps: o.Adadelta(1.0, parameters=ps, rho=0.9)),
        ("nadam", lambda ps: o.NAdam(0.02, parameters=ps,
                                     weight_decay=0.01)),
        ("radam", lambda ps: o.RAdam(0.05, parameters=ps)),
        ("asgd", lambda ps: o.ASGD(0.05, batch_num=3, parameters=ps)),
        ("rprop", lambda ps: o.Rprop(0.01, parameters=ps,
                                     learning_rate_range=(1e-4, 0.05))),
        ("lamb", lambda ps: o.Lamb(0.02, lamb_weight_decay=0.01,
                                   parameters=ps, grad_clip=clip(2.0))),
        ("lars", lambda ps: o.Lars(0.5, 0.9, lars_coeff=0.01,
                                   lars_weight_decay=1e-3, parameters=ps)),
        ("l1_decay", reg("L1Decay", lambda ps: o.SGD(
            0.1, parameters=ps, weight_decay=0.3))),
        ("l2_decay", reg("L2Decay", lambda ps: o.Momentum(
            0.1, 0.9, parameters=ps, weight_decay=0.3))),
        ("lookahead", lambda ps: paddle.incubate.optimizer.LookAhead(
            o.Adam(0.05, parameters=ps), alpha=0.4, k=3)),
        ("model_average", lambda ps: _AveragedSGD(paddle, ps)),
    ]


class _AveragedSGD:
    """SGD steps with a ``ModelAverage`` over them (window 2..3, so it
    restarts); ``averaged()`` applies the average."""

    def __init__(self, paddle, ps):
        self.sgd = paddle.optimizer.SGD(0.1, parameters=ps)
        self.avg = paddle.incubate.optimizer.ModelAverage(
            0.5, parameters=ps, min_average_window=2, max_average_window=3)

    def step(self):
        self.sgd.step()
        self.avg.step()

    def clear_grad(self):
        self.sgd.clear_grad()

    def state_dict(self):
        return self.avg.state_dict()

    def averaged(self):
        self.avg.apply(need_restore=False)


def _rel_err(got, want):
    import torch
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    return float((got - want).abs().max()) / scale if want.numel() else 0.0


def _optim_dense_run(paddle, make, c, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(c["seed"])
    with _paddle_device(dev):
        ps = [paddle.Parameter(torch.tensor(
            rng.standard_normal(s).astype(np.float32), device=dev),
            name=f"p{i}") for i, s in enumerate(c["shapes"])]
        opt = make(ps)
        for _ in range(c["steps"]):
            for p in ps:
                p.grad = torch.tensor(rng.standard_normal(
                    tuple(p.shape)).astype(np.float32) * 3.0, device=dev)
            opt.step()
            opt.clear_grad()
        if isinstance(opt, _AveragedSGD):
            opt.averaged()
        state = {k: v for k, v in opt.state_dict().items()
                 if torch.is_tensor(v)}
    return ps, state


# which rows a sparse case's last step moves: the touched ones ("touched"),
# those and rows touched before (exact Adam's moments), or every row (exact
# AdamW's decoupled decay)
SPARSE_MOVES = {"sgd_wd": "touched", "adam_lazy": "touched",
                "adamw_lazy": "touched", "adam_exact": "superset",
                "adamw_exact": "all"}
SPARSE_CASES = {
    "sgd_wd": lambda o, ps, clip: o.SGD(1.0, parameters=ps,
                                        weight_decay=0.01, grad_clip=clip),
    "adam_lazy": lambda o, ps, clip: o.Adam(0.05, parameters=ps,
                                            lazy_mode=True, grad_clip=clip),
    "adam_exact": lambda o, ps, clip: o.Adam(0.05, parameters=ps,
                                             grad_clip=clip),
    "adamw_lazy": lambda o, ps, clip: o.AdamW(
        0.05, parameters=ps, lazy_mode=True, weight_decay=0.05,
        grad_clip=clip),
    "adamw_exact": lambda o, ps, clip: o.AdamW(0.05, parameters=ps,
                                               weight_decay=0.05,
                                               grad_clip=clip),
}


def _optim_sparse_run(paddle, name, c, dev, w0):
    """``sparse_steps`` steps of an ``Embedding(sparse=True)`` under
    ``SPARSE_CASES[name]`` with a global-norm clip; the weight, and the
    last step's rows moved and rows touched."""
    import numpy as np
    import torch
    rng = np.random.default_rng(c["seed"] + 1)
    with _paddle_device(dev):
        emb = paddle.nn.Embedding(c["vocab"], c["dim"], sparse=True)
        with torch.no_grad():
            emb.weight.copy_(torch.tensor(w0))
        opt = SPARSE_CASES[name](paddle.optimizer, emb.parameters(),
                                 paddle.nn.ClipGradByGlobalNorm(1.0))
        for _ in range(c["sparse_steps"]):
            ids = torch.tensor(rng.integers(0, c["vocab"] // 2, c["ids"]),
                               device=dev)
            scale = torch.tensor(rng.standard_normal(
                c["ids"] + (c["dim"],)).astype(np.float32), device=dev)
            before = emb.weight.detach().clone()
            (emb(ids) * scale).sum().backward()
            if not emb.weight.grad.is_selected_rows():
                raise AssertionError(f"optim_parity sparse_{name}: the "
                                     "embedding's gradient is dense")
            opt.step()
            opt.clear_grad()
        moved = (emb.weight.detach() != before).any(1)
        touched = torch.zeros(c["vocab"], dtype=torch.bool, device=dev)
        touched[ids.reshape(-1)] = True
    return emb.weight.detach(), int(moved.sum()), int(touched.sum()), \
        int((moved & ~touched).sum())


def _lbfgs_run(paddle, c, dev, line_search):
    import numpy as np
    import torch
    rng = np.random.default_rng(c["seed"] + 2)
    b = c["lbfgs"]
    x = (rng.standard_normal((b["rows"], b["cols"])) *
         np.logspace(0, 0.6, b["cols"])).astype(np.float32)
    y = rng.standard_normal((b["rows"], b["outs"])).astype(np.float32)
    w0 = (rng.standard_normal((b["cols"], b["outs"])) * 0.5).astype(
        np.float32)
    with _paddle_device(dev):
        w = paddle.Parameter(torch.tensor(w0, device=dev), name="w")
        xt, yt = paddle.to_tensor(x), paddle.to_tensor(y)
        opt = paddle.optimizer.LBFGS(
            0.2, max_iter=b["max_iter"], max_eval=b["max_eval"],
            history_size=4, line_search_fn=line_search, parameters=[w],
            weight_decay=0.01)
        calls = [0]

        def closure():
            calls[0] += 1
            loss = ((xt.matmul(w) - yt) ** 2).mean()
            loss.backward()
            return loss
        losses = [float(opt.step(closure)) for _ in range(b["calls"])]
    return losses, calls[0], w.detach()


def _transform_cases(paddle, dev):
    import numpy as np
    ag = paddle.autograd
    rng = np.random.default_rng(7400)
    with _paddle_device(dev):
        x, y, v = (paddle.to_tensor(rng.standard_normal(5).astype(
            np.float32)) for _ in range(3))
        return {
            "jacobian": ag.jacobian(lambda a, b: paddle.sin(a) * b + a,
                                    [x, y]),
            "hessian": ag.hessian(lambda a: (paddle.tanh(a) * a * a).sum(),
                                  x),
            "jvp": ag.jvp(lambda a: paddle.exp(a) * a, x, v),
            "vjp": ag.vjp(lambda a, b: paddle.sin(a) * b, [x, y], v),
        }


def _flat(tree):
    import torch
    if torch.is_tensor(tree):
        return [tree]
    return [t for v in tree for t in _flat(v)]


def _op_stats(paddle, dev):
    from paddle_tpu_torch.amp import debugging
    with _paddle_device(dev):
        paddle.seed(7500)
        m = paddle.nn.Sequential(paddle.nn.Linear(16, 32), paddle.nn.GELU(),
                                 paddle.nn.LayerNorm(32),
                                 paddle.nn.Linear(32, 4))
        x = paddle.randn([8, 16])
        out = []
        for amp in (False, True):
            with contextlib.ExitStack() as stack:
                stack.enter_context(contextlib.redirect_stdout(None))
                if amp:
                    stack.enter_context(paddle.amp.auto_cast(
                        dtype="bfloat16"))
                st = stack.enter_context(debugging.collect_operator_stats())
                y = m(x)
                _ = paddle.nn.functional.softmax(y) * 2.0 + y.sum()
            out.append(dict(st))
    return out


def _stream_and_memory(paddle):
    """Event timing on a side stream against ``torch.cuda.Event``'s at the
    same points, and the memory namespace against ``torch.cuda``'s
    counters."""
    import torch
    d = paddle.device
    a = torch.randn(2048, 2048, device="cuda")
    s = d.Stream()
    s.wait_stream(d.current_stream())
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0 = s.record_event()
    t0.record(s._stream)
    with torch.cuda.stream(s._stream):
        for _ in range(8):
            a = a @ a * 1e-3
    e1 = d.Event()
    e1.record(s)
    t1.record(s._stream)
    ms = e0.elapsed_time(e1)
    torch_ms = t0.elapsed_time(t1)
    d.current_stream().wait_stream(s)
    counters = {
        "memory_allocated": (d.cuda.memory_allocated(),
                             torch.cuda.memory_allocated()),
        "max_memory_allocated": (d.cuda.max_memory_allocated(),
                                 torch.cuda.max_memory_allocated()),
        "memory_reserved": (d.cuda.memory_reserved(),
                            torch.cuda.memory_reserved()),
        "max_memory_reserved": (d.tpu.max_memory_reserved(),
                                torch.cuda.max_memory_reserved())}
    ma = d.memory_analysis(lambda x: (x @ x).relu(), a)
    live = d.live_arrays_report(top=3)
    return dict(event_ms=ms, torch_event_ms=torch_ms, counters=counters,
                summary_lines=len(d.cuda.memory_summary().splitlines()),
                memory_analysis=ma, live_cuda_rows=sum(
                    r["device"].startswith("cuda") for r in live["top"]),
                available=d.get_available_device())


def phase_optim_parity(cfg=None, device="cuda"):
    """The slice on ``device`` against the port on the CPU, fp32 with TF32
    off, at small shapes (OPTIM_PARITY): every optimizer (and the L1 / L2
    regularizers, ``LookAhead``, ``ModelAverage``) for ``steps`` steps on
    the same parameters and gradients, parameters and every accumulator;
    the row-sparse SGD / Adam / AdamW updates (lazy and exact) under a
    global-norm clip, each step's gradient row-sparse, the last step's
    moved rows within the touched ones (equal under the lazy rules);
    LBFGS (Armijo and strong Wolfe): its losses (relative) and closure
    calls, the objective it promises (its iterate's difference is printed:
    near the minimum the objective is flat, and in the first card run the
    iterates were 1.2e-5 apart where the losses agreed to 1.4e-7); the four
    autograd transforms; ``check_numerics`` (its counts); the operator
    stats of a small model at fp32 and bf16 (equal counts); on the card,
    ``Stream`` / ``Event`` timing against ``torch.cuda.Event``'s and the
    memory counters against ``torch.cuda``'s.  Each case's worst error
    (of the largest |value|) within OPTIM_PARITY_TOL.  No Pallas kernel is
    on this path."""
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    c = cfg or OPTIM_PARITY
    cuda = device == "cuda"
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    errs, failed, extra = {}, {}, {}
    try:
        for name, make in _optim_cases(paddle):
            (cp, cs), (dp, ds) = (_optim_dense_run(paddle, make, c, dev)
                                  for dev in ("cpu", device))
            if set(cs) != set(ds):
                failed[name] = f"state keys {sorted(cs)} / {sorted(ds)}"
                continue
            errs[name] = max([_rel_err(b, a) for a, b in zip(cp, dp)] +
                             [_rel_err(ds[k], cs[k]) for k in cs])
        w0 = np.random.default_rng(c["seed"] + 3).standard_normal(
            (c["vocab"], c["dim"])).astype(np.float32)
        for name in SPARSE_CASES:
            (cw, *_), (dw, moved, touched, outside) = (
                _optim_sparse_run(paddle, name, c, dev, w0)
                for dev in ("cpu", device))
            errs[f"sparse_{name}"] = _rel_err(dw, cw)
            rows = dict(rows_moved=moved, rows_touched=touched,
                        rows_moved_untouched=outside, rule=SPARSE_MOVES[name])
            extra[f"sparse_{name}"] = rows
            ok = {"touched": moved == touched and not outside,
                  "superset": touched <= moved <= c["vocab"] // 2,
                  "all": moved == c["vocab"]}[SPARSE_MOVES[name]]
            if not ok:
                failed[f"sparse_{name}"] = rows
        for ls in (None, "strong_wolfe"):
            (cl, cc, cw), (dl, dc, dw) = (_lbfgs_run(paddle, c, dev, ls)
                                          for dev in ("cpu", device))
            key = f"lbfgs_{ls or 'armijo'}"
            errs[key] = max(abs(a - b) / abs(a) for a, b in zip(cl, dl))
            extra[key] = dict(closure_calls=(dc, cc), losses=dl,
                              losses_cpu=cl, iterate_err=_rel_err(dw, cw))
            if dc != cc:
                failed[key] = f"closure calls {dc} on {device}, {cc} on cpu"
        ct, dt = (_transform_cases(paddle, dev) for dev in ("cpu", device))
        for k in ct:
            errs[f"autograd_{k}"] = max(
                _rel_err(b, a) for a, b in zip(_flat(ct[k]), _flat(dt[k])))
        with _paddle_device(device):
            bad = paddle.to_tensor(np.array([np.nan, 1.0, np.inf, np.nan],
                                            np.float32))
            from paddle_tpu_torch.amp import debugging
            try:
                debugging.check_numerics(bad, "probe", "bad")
                failed["check_numerics"] = "no FloatingPointError"
            except FloatingPointError as e:
                extra["check_numerics"] = str(e)
                if "2 NaN, 1 Inf" not in str(e):
                    failed["check_numerics"] = str(e)
        stats = {dev: _op_stats(paddle, dev) for dev in ("cpu", device)}
        extra["operator_stats"] = stats[device]
        if stats[device] != stats["cpu"]:
            failed["operator_stats"] = stats
        if cuda:
            sm = _stream_and_memory(paddle)
            extra["stream_and_memory"] = sm
            if not abs(sm["event_ms"] - sm["torch_event_ms"]) <= \
                    EVENT_MS_TOL["rel"] * sm["torch_event_ms"] + \
                    EVENT_MS_TOL["abs"] or not sm["event_ms"] > 0:
                failed["event_ms"] = (sm["event_ms"], sm["torch_event_ms"])
            for k, (got, want) in sm["counters"].items():
                if got != want:
                    failed[k] = (got, want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    failed.update({k: v for k, v in errs.items()
                   if not v <= OPTIM_PARITY_TOL})
    worst = max(errs, key=errs.get)
    emit("optim_parity", cases=len(errs), errors=errs, worst_case=worst,
         worst_err=errs[worst], tol=OPTIM_PARITY_TOL, checks=extra,
         failed=failed, seconds=time.perf_counter() - t0,
         nvidia_smi=_nvidia_smi() if cuda else None)
    if failed:
        raise AssertionError(f"optim_parity: {failed}")


def _optim_train_report(name, model, step, c, device, units):
    """``warmup`` steps, ``steps`` timed steps with 0 builds and 0 syncs
    (``_train_steps_without_sync``); the losses finite and the last below
    the first; ms a step, units/s, peak memory and, on the card, one
    profiled step's busy and idle share."""
    import torch
    cuda = device == "cuda"
    warm = [step() for _ in range(c["warmup"])]
    timed, step_s = _train_steps_without_sync(step, c["steps"], device)
    losses = [float(v) for v in warm + timed]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"optim_models {name}: losses {losses}")
    result = dict(warmup_steps=c["warmup"], timed_steps=c["steps"],
                  steps_checked_without_sync=c["steps"],
                  builds_after_warmup=0, step_ms=step_s * 1e3,
                  per_s=units / step_s, losses=losses,
                  max_memory_allocated=torch.cuda.max_memory_allocated()
                  if cuda else None)
    if cuda:
        prof = _profile_breakdown(step, step_s * 1e3, top=4)
        result["busy_share"] = 1 - prof["idle_share"]
        result["idle_share"] = prof["idle_share"]
        result["device_busy_ms"] = prof["device_busy_ms"]
        result["launches_a_step"] = prof["launches"]
        result["top_kernels_ms"] = prof["top_kernels_ms"]
    return result


def _old_optimizer(key):
    """The same model's figures under its old optimizer, from its phase of
    this run (None where that phase did not run)."""
    r = _PHASE_RESULTS.get(key)
    return None if r is None else {k: r.get(k) for k in (
        "optimizer", "step_ms", "max_memory_allocated", "busy_share")}


def _cuda_fresh(cuda):
    import torch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def phase_optim_models(cfg=None, device="cuda"):
    """This slice's optimizers on full-width models (OPTIM_MODELS), each
    built on ``device`` from a seed and trained on one repeated batch:
    (a) ResNet-50 of ``resnet50_train`` (224 px, B 64, O1 bf16) under
    ``Lars``; (b) the ERNIE-3.0-base encoder of ``encoder_train`` (12 x
    768, s 512, B 16) under ``Lamb`` at O2 bf16 with float32 masters; (c)
    the PTB-large LSTM LM of ``seq_models`` with ``Embedding(sparse=True)``
    under ``SGD(1.0)`` + ``ClipGradByGlobalNorm(10)`` and under
    ``Adam(lazy_mode=True)``.  Each: ``warmup`` steps, ``steps`` timed
    steps with 0 builds and 0 syncs, losses finite and falling; ms a step,
    units/s, busy / idle share, peak memory, beside the same model's
    figures under its old optimizer in this run.  (c) also: one more step
    with the embedding's rows compared before and after (rows moved
    against rows touched: equal, none outside), and the coalesce mode."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.vision.models import resnet50
    cfg = cfg or OPTIM_MODELS
    cuda = device == "cuda"
    F = paddle.nn.functional
    t_phase = time.perf_counter()
    # (a) ResNet-50 under LARS
    c = cfg["resnet50"]
    _cuda_fresh(cuda)
    with _paddle_device(device):
        paddle.seed(c["seed"])
        model = resnet50(num_classes=c["classes"])
        opt = paddle.optimizer.Lars(
            c["lr"], c["momentum"], lars_coeff=c["lars_coeff"],
            lars_weight_decay=c["lars_weight_decay"],
            parameters=model.parameters())
        x = paddle.randn([c["batch"], 3, c["px"], c["px"]])
        y = paddle.randint(0, c["classes"], [c["batch"]])

    def r_step():
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    tr = _optim_train_report("resnet50", model, r_step, c, device,
                             c["batch"])
    emit("optim_models", part="resnet50_lars", batch=c["batch"],
         px=c["px"], amp="O1 bfloat16",
         optimizer=f"Lars(lr {c['lr']}, momentum {c['momentum']}, "
         f"coeff {c['lars_coeff']}, weight decay {c['lars_weight_decay']})",
         units="images", **tr,
         old_optimizer_this_run=_old_optimizer("resnet50_train"),
         nvidia_smi=_nvidia_smi() if cuda else None)
    del model, opt, x, y, r_step
    # (b) the ERNIE-3.0-base encoder under LAMB, O2
    c = cfg["encoder"]
    _cuda_fresh(cuda)
    with _paddle_device(device):
        paddle.seed(c["seed"])
        model = _encoder_model(c)
        opt = paddle.optimizer.Lamb(
            c["lr"], lamb_weight_decay=c["weight_decay"],
            parameters=model.parameters(),
            exclude_from_weight_decay_fn=lambda p: p.ndim < 2)
        model, opt = paddle.amp.decorate(model, opt, level="O2",
                                         dtype="bfloat16")
        ids = paddle.randint(0, c["vocab"], [c["batch"], c["seq"]])
        labels = paddle.randint(0, c["vocab"], [c["batch"] * c["seq"]])

    def e_step():
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss = F.cross_entropy(model(ids).reshape([-1, c["vocab"]]),
                                   labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    tr = _optim_train_report("encoder", model, e_step, c, device,
                             c["batch"] * c["seq"])
    emit("optim_models", part="encoder_lamb", layers=c["layers"],
         width=c["width"], batch=c["batch"], seq=c["seq"],
         amp="O2 bfloat16 (float32 masters)",
         optimizer=f"Lamb(lr {c['lr']}, weight decay {c['weight_decay']} "
         "off biases and norms)", units="tokens", **tr,
         old_optimizer_this_run=_old_optimizer("encoder_train"),
         nvidia_smi=_nvidia_smi() if cuda else None)
    del model, opt, ids, labels, e_step
    # (c) the PTB-large LSTM with a row-sparse embedding gradient
    c = cfg["lstm"]
    gen = torch.Generator().manual_seed(c["seed"])
    batch = torch.randint(0, c["vocab"], (c["batch"], c["unroll"] + 1),
                          generator=gen)
    x_in = batch[:, :-1].to(device)
    x_out = batch[:, 1:].reshape([-1]).to(device)
    for label, make in (
            ("sgd", lambda ps: paddle.optimizer.SGD(
                c["lr"], parameters=ps,
                grad_clip=paddle.nn.ClipGradByGlobalNorm(c["clip"]))),
            ("adam_lazy", lambda ps: paddle.optimizer.Adam(
                c["adam_lr"], parameters=ps, lazy_mode=True))):
        _cuda_fresh(cuda)
        with _paddle_device(device):
            paddle.seed(c["seed"])
            lm = _lstm_lm_model(paddle, c["vocab"], c["hidden"],
                                c["layers"], c["dropout"], sparse=True)
            opt = make(lm.parameters())

        def l_step():
            loss = F.cross_entropy(lm(x_in).reshape([-1, c["vocab"]]), x_out)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()
        tr = _optim_train_report(f"lstm {label}", lm, l_step, c, device,
                                 c["batch"] * c["unroll"])
        w = lm.embed.weight
        before = w.detach().clone()
        loss = F.cross_entropy(lm(x_in).reshape([-1, c["vocab"]]), x_out)
        loss.backward()
        sparse = w.grad.is_selected_rows()
        opt.step()
        opt.clear_grad()
        moved = (w.detach() != before).any(1)
        touched = torch.zeros_like(moved)
        touched[x_in.reshape(-1)] = True
        rows = dict(rows_moved=int(moved.sum()),
                    rows_touched=int(touched.sum()),
                    rows_moved_untouched=int((moved & ~touched).sum()),
                    vocab=c["vocab"])
        emit("optim_models", part=f"ptb_large_lstm_sparse_{label}",
             dtype="float32", optimizer=str(type(opt).__name__) +
             (" (lazy_mode)" if label == "adam_lazy" else
              f"({c['lr']}) + ClipGradByGlobalNorm({c['clip']})"),
             embedding_grad_row_sparse=sparse,
             coalesce_mode="fixed-size buffer, no host read",
             units="tokens", **tr, **rows,
             old_optimizer_this_run=_old_optimizer("lstm"),
             nvidia_smi=_nvidia_smi() if cuda else None)
        if not sparse or rows["rows_moved_untouched"] or \
                rows["rows_moved"] != rows["rows_touched"]:
            raise AssertionError(f"optim_models lstm {label}: {rows}, "
                                 f"row-sparse {sparse}")
        del lm, opt, l_step, w, before
    _cuda_fresh(cuda)
    emit("optim_models", part="done",
         seconds=time.perf_counter() - t_phase)


# ------------------------------------------------------- weight-only ---

def _wo_counts():
    from paddle_tpu_torch.kernels import weight_only as wo
    return {"int8": wo.LAUNCHES, "int4": wo.LAUNCHES_INT4}


def _wo_route_counts():
    from paddle_tpu_torch.kernels import weight_only as wo
    return {r: getattr(wo, f"LAUNCHES_{r.upper()}") for r in WO_ROUTES}


def _reset_wo_counts():
    from paddle_tpu_torch.kernels import weight_only as wo
    wo.LAUNCHES = wo.LAUNCHES_INT4 = 0
    for r in WO_ROUTES:
        setattr(wo, f"LAUNCHES_{r.upper()}", 0)


def _wo_sm90_ptxas(log):
    """ptxas's record of each kernel of ``weight_only_sm90``'s build log:
    ``{"narrow tm8 bf16 int4": {"registers", "spill_stores", "spill_loads",
    "stack_bytes"}, "wide fp16 int8": ..., "splitk_finish": ...}``."""
    def name(m):
        ty = "bf16" if "bfloat16" in m.group(2) else "fp16"
        mode = "int4" if m.group(3) == "1" else "int8"
        if m.group(1) == "narrow":
            return f"narrow tm{m.group(4)} {ty} {mode}"
        return f"wide {ty} {mode}"
    out = _ptxas_of(log, r"wo_(narrow|wide)_kernelI(13__nv_bfloat16|6__half)"
                    r"Lb(\d)E(?:Li(\d+)E)?", name)
    out.update(_ptxas_of(log, r"wo_splitk_finish", lambda m: "splitk_finish"))
    return out


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
                    "need_by_dtype": {}, "routes": dict.fromkeys(WO_ROUTES, 0)}
             for mode in WO_MODES}

    def routed(mode, x, q, s, k):
        """One launch on the route _route names (by its counter)."""
        route = wo._route(x, q, k, q.shape[1])
        before = _wo_route_counts()
        out = wo.weight_only_matmul(x, q, s, int4_rows=k if mode == "int4"
                                    else None)
        after = _wo_route_counts()
        if {r: after[r] - before[r] for r in WO_ROUTES} != \
                {r: int(r == route) for r in WO_ROUTES}:
            raise AssertionError(f"kernel_wo {mode}: a launch off its route "
                                 f"{route}")
        worst[mode]["routes"][route] += 1
        return out

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
                    out = routed(mode, x, q, s, k)
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
                    for m in (8, 100):
                        x = torch.randn((m, k), generator=gen,
                                        device=dev).to(dtype)
                        out = routed(mode, x, q, s, k)
                        check(mode, f"codes{code}/{dtype}/m{m}/k{k}/n{n}",
                              out, wo._wo_reference(x, q, s, int4, k, dtype))
        if not all(worst[mode]["routes"].values()):
            raise AssertionError(f"kernel_wo {mode}: a route was not "
                                 f"reached {worst[mode]['routes']}")
    torch.cuda.synchronize()
    return worst


def _wo_timing(gen):
    """Device times at llama2_7b's gate/up shape (k 4096, n 11008, bf16 x)
    for each m of WO_TIMED: the kernel, its plain version, the library call
    and ``torch.matmul`` over the unquantized bf16 weight.  The kernel, the
    library call and ``torch.matmul`` are timed by CUDA-graph replays
    (``graph_ms``: a kernel near its ~0.014 ms bound is shorter than its
    wrapper's host time, which CUDA events around eager calls would time),
    in turns (kernel, yardsticks, kernel); the plain version, which is slow,
    by CUDA events.  The library call is ``torch._weight_int8pack_mm`` for
    int8 (weight [n, k], its scale in bf16) and
    ``torch._weight_int4pack_mm`` for int4 (the codes + 8 packed once by
    ``torch._convert_weight_to_int4pack``, the scale in bf16 repeated in
    every group of WO_LIB_GROUP rows, zero points 0, so it computes ``x @
    ((q + 8 - 8) * scale)``); each is held against the plain version by
    :func:`_wo_library_check`.  Each timed call takes the next of several
    copies of its weight that together exceed 3x the 50 MB L2 cache, so
    every call reads its weight from device memory, as a sweep over a
    model's projections does.  Each kernel's output repeats bit for bit,
    and its route is the one ``wo_plan`` names."""
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
            route = wo._route(x, q, k, n)
            before = _wo_route_counts()
            out = wo.weight_only_matmul(x, q, s, int4_rows=rows)
            ref = wo._wo_reference(x, q, s, int4, k, bf16)
            err, need = _wo_check(f"kernel_wo timed {mode} m{m}", out, ref)
            again = wo.weight_only_matmul(x, q, s, int4_rows=rows)
            if _wo_route_counts()[route] - before[route] != 2 or \
                    route != wo.wo_plan(m, k, n, int4)["form"] or \
                    not _bits_equal(out, again):
                raise AssertionError(f"kernel_wo timed {mode} m{m}: route "
                                     f"{route} or not bit for bit")
            fns = {"kernel": rotate(lambda i: wo.weight_only_matmul(
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
            t = {"plain": cuda_ms(rotate(lambda i: wo._wo_reference(
                x, qs[i], s, int4, k, bf16), copies), 10)}
            calls = copies * (8 if m <= 16 else 2)
            for key in ("kernel", "bf16_matmul", "library", "kernel2"):
                fn = fns.get(key.rstrip("2"))
                if fn is not None:
                    t[key] = graph_ms(fn, calls)
            t["kernel_eager"] = cuda_ms(fns["kernel"], 50)
            b_ms, b_by = _grouped_bound_ms([x, q, s], out, 2 * m * k * n, bf16)
            timings[f"{mode}_m{m}"] = {
                "shape": f"llama2_7b gate/up m={m} k={k} n={n} bf16 x, {mode}",
                "route": route, "plan": wo.wo_plan(m, k, n, int4),
                "weight_copies": copies, "max_abs_err": err, "need": need,
                "kernel_ms": min(t["kernel"], t["kernel2"]),
                "kernel_ms_runs": [t["kernel"], t["kernel2"]],
                "kernel_ms_eager": t["kernel_eager"],
                "plain_ms": t["plain"],
                "bound_ms": b_ms, "bound_by": b_by,
                "kernel_over_bound": min(t["kernel"], t["kernel2"]) / b_ms,
                "library_ms": t.get("library"), **lib_m,
                "bf16_matmul_ms": t["bf16_matmul"]}
        del qs, lib_ws
    return timings


def phase_kernel_wo(built=None):
    """The weight-only kernels: ptxas's record of ``weight_only_sm90`` (0
    spill bytes in each of its 21 kernels, or it fails; empty, and failing,
    when the library was built before ``phase_build`` in the same call),
    then the case matrix on every route, then the times."""
    import torch
    ptxas = _wo_sm90_ptxas(_build_log(built, "weight_only_sm90"))
    _no_spills("kernel_wo weight_only_sm90", ptxas, 21)
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = _wo_matrix(gen)
    timings = _wo_timing(gen)
    emit("kernel_wo", worst=worst, timings=timings, ptxas=ptxas)
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
    through ``torch.matmul`` over the bf16 weights (CUDA events around the
    host loop, which the host's enqueue of 225 wrapper calls can hold back,
    and the device alone from a CUDA graph of one sweep); then ``dx`` through
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

    # one untimed sweep per (m, mode), its launches counted from 0: 225 of
    # its mode, all on the route of its m, and no other kernel
    outs, launches = {}, {mode: {"launches": 0, "routes": dict.fromkeys(
        WO_ROUTES, 0)} for mode in WO_MODES}
    for m in WO_PATH_MS:
        route = "narrow" if m <= wo.NARROW_MAX_M else "wide"
        for mode in WO_MODES:
            _reset_wo_counts()
            _reset_flash_counts()
            _reset_grouped_counts()
            outs[(m, mode)] = sweep(m, mode, checked)
            torch.cuda.synchronize()
            got = {"modes": _wo_counts(), "routes": _wo_route_counts(),
                   "others": {**_flash_counts(), **_grouped_counts()}}
            want = {"modes": {md: len(shapes) * (md == mode)
                              for md in WO_MODES},
                    "routes": {r: len(shapes) * (r == route)
                               for r in WO_ROUTES},
                    "others": dict.fromkeys(got["others"], 0)}
            if got != want:
                raise AssertionError(f"weight_only_path m{m} {mode}: "
                                     f"launches {got}, want {want}")
            launches[mode]["launches"] += len(shapes)
            launches[mode]["routes"][route] += len(shapes)
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
                # the device alone: one sweep captured in a CUDA graph
                "device_ms_per_sweep": graph_ms(fns[key], 1, reps=3),
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


PRIM_MM_ROUTES = ("sm90", "mma", "fma")   # kernels/primitives.py:_matmul_route


def _prim_counts():
    from paddle_tpu_torch.kernels import primitives as P
    return {"elementwise": P.LAUNCHES_ELEMENTWISE,
            "reduce": P.LAUNCHES_REDUCE, "matmul": P.LAUNCHES_MATMUL,
            "elementwise_vec16": P.LAUNCHES_ELEMENTWISE_VEC16,
            "reduce_vec16": P.LAUNCHES_REDUCE_VEC16,
            **{f"matmul_{r}": getattr(P, f"LAUNCHES_MATMUL_{r.upper()}")
               for r in PRIM_MM_ROUTES}}


def _reset_prim_counts():
    from paddle_tpu_torch.kernels import primitives as P
    P.LAUNCHES_ELEMENTWISE = P.LAUNCHES_REDUCE = P.LAUNCHES_MATMUL = 0
    P.LAUNCHES_REDUCE_VEC16 = P.LAUNCHES_ELEMENTWISE_VEC16 = 0
    for r in PRIM_MM_ROUTES:
        setattr(P, f"LAUNCHES_MATMUL_{r.upper()}", 0)


def _mm_sm90_ptxas(built):
    """ptxas's record of the sm90 matmul kernels of every generated matmul
    build: ``{"<library> bn256 bf16": {...}, ...}`` (4 a build)."""
    out = {}
    for key, b in (built or {}).items():
        if key.startswith("libprimitives-gen-") and \
                "mm_sm90_kernel" in b["log"]:
            out.update(_ptxas_of(
                b["log"], r"mm_sm90_kernelILi(\d+)E(13__nv_bfloat16|6__half)",
                lambda m, k=key: f"{k[18:26]} bn{m.group(1)} "
                f"{'bf16' if 'bfloat16' in m.group(2) else 'fp16'}"))
    return out


def _ew_vec16_ptxas(built):
    """ptxas's record of the "vec16" elementwise kernel of every generated
    elementwise build: ``{"<library>": {...}, ...}`` (one a build)."""
    out = {}
    for key, b in (built or {}).items():
        if key.startswith("libprimitives-gen-"):
            out.update(_ptxas_of(b["log"], r"elementwise_vec16_kernel",
                                 lambda m, k=key: k[18:26]))
    return out


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
    we["routes"] = {"vec16": 0, "scalar": 0}

    def offset_copy(x):
        """x's values in a view one element into its buffer (the "scalar"
        route)."""
        buf = torch.empty((x.numel() + 1,), dtype=x.dtype, device=dev)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(x.shape)

    def ew_case(apply, ins, route):
        """One elementwise launch on ``route`` (by the counters)."""
        n0, v0 = P.LAUNCHES_ELEMENTWISE, P.LAUNCHES_ELEMENTWISE_VEC16
        got = apply(*ins)
        if (P.LAUNCHES_ELEMENTWISE - n0, P.LAUNCHES_ELEMENTWISE_VEC16 - v0) \
                != (1, int(route == "vec16")):
            raise AssertionError(f"elementwise: launches on the wrong route "
                                 f"(want {route})")
        we["routes"][route] += 1
        return got

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
                got = ew_case(apply, ins, "vec16")
                # the same values through the scalar route: the same bits
                if not _bits_equal(got, ew_case(
                        apply, [offset_copy(x) for x in ins], "scalar")):
                    raise AssertionError(f"elementwise {name} {shape} {mix}: "
                                         "the vec16 and scalar routes differ")
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
    wm["routes"] = dict.fromkeys(PRIM_MM_ROUTES, 0)
    for m, k, n in PRIM_MM_SHAPES:
        for dt, other in ((f32, bf16), (bf16, f32), (f16, f32)):
            x = torch.randn((m, k), generator=gen, device=dev).to(dt)
            w = (torch.randn((k, n), generator=gen, device=dev) /
                 math.sqrt(k)).to(dt)
            acc = x.float() @ w.float()
            for ename, efn in fns["matmul"].items():
                pre = acc if efn is None else efn.torch(acc)
                for odt in (dt, other):
                    route = P._matmul_route(x, w)
                    before = _prim_counts()
                    got = P.matmul_kernel(epilogue=efn, out_dtype=odt)(x, w)
                    after = _prim_counts()
                    if any(after[f"matmul_{r}"] - before[f"matmul_{r}"] !=
                           (r == route) for r in PRIM_MM_ROUTES):
                        raise AssertionError(f"matmul {m}x{k}x{n}: a launch "
                                             f"off its route {route}")
                    wm["routes"][route] += 1
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
    if not all(wm["routes"].values()):
        raise AssertionError(f"matmul: a route was not reached "
                             f"{wm['routes']}")
    torch.cuda.synchronize()
    return worst


def _prim_path(gen):
    """The library's main path at llama2_7b widths, through the public
    generators: the FFN of one layer (gate and up projections, silu(gate)
    * up, the down projection) over B*T = 8192 rows of bf16, the LM head,
    the row max of the logits, the fp32 row sums of the FFN output, and the
    gate projection again with the silu fused as its epilogue.  Launch
    counts are set to 0 just before and read just after: exactly 5
    matmuls, 1 elementwise (on the "vec16" route), 2 reduces.  Each output
    is then held against its plain version on the same inputs."""
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
    # both reduces stage 16-byte copies: fresh tensors, 16-byte rows; the
    # five matmuls all take the wgmma route
    if launches != {"elementwise": 1, "reduce": 2, "matmul": 5,
                    "elementwise_vec16": 1, "reduce_vec16": 2,
                    "matmul_sm90": 5, "matmul_mma": 0, "matmul_fma": 0}:
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
    # the same values one element into their buffers: the "scalar" route
    a_off, b_off = (torch.empty((R * I + 1,), dtype=bf16, device="cuda")
                    for _ in range(2))
    a_off[1:], b_off[1:] = a.reshape(-1), b.reshape(-1)
    a_off, b_off = a_off[1:].view(R, I), b_off[1:].view(R, I)
    out_probe = torch.empty_like(a)
    routes = (P._elementwise_route([a, b], out_probe),
              P._elementwise_route([a_off, b_off], out_probe))
    y = sw(a, b)
    y_scalar = sw(a_off, b_off)
    if routes != ("vec16", "scalar") or not _bits_equal(y, sw(a, b)) or \
            not _bits_equal(y, y_scalar):
        raise AssertionError(f"timed silu_mul: routes {routes}, or the "
                             "vec16 route not bit for bit with itself and "
                             "the scalar route")
    err = _ew_check("timed silu_mul", y, P._elementwise_reference(fn, [a, b]))
    rec("elementwise_silu_mul", f"[{R}, {I}] bf16", lambda: sw(a, b),
        lambda: P._elementwise_reference(fn, [a, b]),
        _grouped_bound_ms([a, b], y, 5 * y.numel(), f32),
        cost=lambda: F.silu(a) * b, max_abs_err=err[0], route=routes[0],
        bitwise_repeat=True, bitwise_vs_scalar=True,
        library_note="null: no single PyTorch call computes silu(a) * b; "
                     "cost_reference_ms is F.silu(a) * b, two calls")
    t_sc = [cuda_ms(lambda: sw(a_off, b_off), 20) for _ in range(2)]
    out["elementwise_silu_mul"].update(scalar_ms=min(t_sc),
                                       scalar_ms_runs=t_sc)
    del a, b, y, a_off, b_off, y_scalar, out_probe

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

    # the gate projection, without and with the silu epilogue; the down
    # projection and the LM head without: each on the "sm90" route, its
    # output the same bits in two runs
    x = torch.randn((R, H), generator=gen, device="cuda").to(bf16)
    w = (torch.randn((H, I), generator=gen, device="cuda") /
         math.sqrt(H)).to(bf16)
    h = torch.randn((R, I), generator=gen, device="cuda").to(bf16)
    wd = (torch.randn((I, H), generator=gen, device="cuda") /
          math.sqrt(I)).to(bf16)
    wh = (torch.randn((H, V), generator=gen, device="cuda") /
          math.sqrt(H)).to(bf16)
    for key, a_in, b_in, efn in (
            ("matmul", x, w, None), ("matmul_silu", x, w, fns["matmul"]["silu"]),
            ("matmul_down", h, wd, None), ("matmul_lm_head", x, wh, None)):
        mmk = P.matmul_kernel(epilogue=efn)
        e = efn or P._IDENTITY
        route = P._matmul_route(a_in, b_in)
        before = _prim_counts()["matmul_sm90"]
        y = mmk(a_in, b_in)
        again = mmk(a_in, b_in)
        if route != "sm90" or _prim_counts()["matmul_sm90"] != before + 2 \
                or not _bits_equal(y, again):
            raise AssertionError(f"timed {key}: route {route} or not bit "
                                 "for bit")
        del again
        c = _flash_check(y, P._matmul_reference(e, a_in, b_in, bf16),
                         PRIM_MM_TOL["bfloat16"])
        if not c["ok"]:
            raise AssertionError(f"timed {key}: {c}")
        (M, K), N = a_in.shape, b_in.shape[1]
        extra = {"max_abs_err": c["max_abs_err"], "rel": c["rel"],
                 "route": route, "bitwise_repeat": True}
        if efn is None:
            lib = torch.matmul(a_in, b_in)
            extra["library_vs_plain"] = _flash_check(
                lib, P._matmul_reference(e, a_in, b_in, bf16),
                PRIM_MM_TOL["bfloat16"])
            del lib
            kw = dict(library=lambda: torch.matmul(a_in, b_in),
                      library_call="torch.matmul")
        else:
            kw = dict(cost=lambda: F.silu(torch.matmul(a_in, b_in)),
                      library_note="null: no single PyTorch call fuses the "
                                   "silu; cost_reference_ms is torch.matmul "
                                   "then F.silu")
        rec(key, f"[{M}, {K}] @ [{K}, {N}] bf16", lambda: mmk(a_in, b_in),
            lambda: P._matmul_reference(e, a_in, b_in, bf16),
            _grouped_bound_ms([a_in, b_in], y, 2 * M * K * N, bf16),
            iters=10, **kw, **extra)
        k_ms = out[key]["kernel_ms"]
        out[key]["tflops"] = 2 * M * K * N / k_ms / 1e9
        ref_ms = out[key]["library_ms"] or out[key]["cost_reference_ms"]
        out[key]["kernel_over_library"] = k_ms / ref_ms
        del y
    del x, w, h, wd, wh
    torch.cuda.empty_cache()
    return out


def phase_kernel_primitives(smi=None, built=None):
    """The primitive library's three generated kernels (elementwise, reduce,
    matmul) against their plain versions over the case matrix, then the
    library's path at llama2_7b widths with exact launch counts, then the
    times of each generator at those widths.  First ptxas's record of the
    sm90 matmul in each generated matmul build and of the "vec16"
    elementwise kernel in each generated elementwise build: 0 spill bytes
    in its 4 kernels (1) a build, or it fails (empty, and failing, when the
    libraries were built before ``phase_build`` in the same call)."""
    import torch
    ptxas = _mm_sm90_ptxas(built)
    n_mm = sum("#define PTT_MATMUL 1" in h for _, h in _prim_headers())
    _no_spills("kernel_primitives mm_sm90", ptxas, 4 * n_mm)
    ew_ptxas = _ew_vec16_ptxas(built)
    n_ew = sum("#define PTT_ELEMENTWISE 1" in h for _, h in _prim_headers())
    _no_spills("kernel_primitives elementwise vec16", ew_ptxas, n_ew)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = _prim_matrix(gen)
    matrix_s = time.perf_counter() - t0
    path = _prim_path(gen)
    timed = _prim_timing(gen)
    emit("kernel_primitives", nvidia_smi=smi or _nvidia_smi(),
         matrix_seconds=matrix_s, worst=worst, path=path, timed=timed,
         ew_tol=PRIM_EW_TOL, mm_tol=PRIM_MM_TOL, mm_sm90_ptxas=ptxas,
         ew_vec16_ptxas=ew_ptxas,
         seconds=time.perf_counter() - t0)
    return worst, path, timed


def main() -> int:
    from paddle_tpu_torch.models.pretrain import use_expandable_segments
    use_expandable_segments()         # before CUDA's first allocation
    name, _smi = phase_device()
    import torch
    built = phase_build()
    attn_err, attn_t, attn_p = phase_kernel(built)
    int8_err, int8_t, int8_p = phase_kernel_int8()
    gmm_err, gmm_t = phase_kernel_gmm(built)
    phase_engine_parity()
    phase_engine_parity_int8()
    phase_engine_parity_moe()
    phase_engine_parity_prefix_spec()
    phase_engine_parity_migration()
    router_parity = phase_engine_parity_router()
    runs = [phase_serve("serve", ["--preset", "llama2_7b"]),
            phase_serve("serve_int8", ["--preset", "llama2_7b",
                                       "--cache-dtype", "int8"]),
            phase_serve("serve_moe", ["--preset", "mixtral_8x7b",
                                      "--num-layers", "16"]),
            phase_serve_prefix_spec(),
            phase_serve_migrate(),
            phase_serve_disagg(),
            phase_serve_routers(),
            phase_serve_tp(),
            router_parity]
    phase_fleet_failover()
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    decode = gmm_t[0]              # the gmm line: the decode gate/up shape
    flash_err, flash_t = phase_kernel_flash(built)
    flash_modes = phase_kernel_flash_modes(_smi)
    phase_train_parity()
    flash_launches = phase_train()
    moe_err, moe_t, moe_mix = phase_kernel_tgmm(built)
    phase_moe_train_parity()
    moe_launches = phase_train_moe()
    phase_gpt_parity()
    gpt_launches, _gpt_t = phase_gpt2()
    phase_dit_parity()
    dit_launches, _dit_t = phase_dit_train()
    forms_launches = phase_moe_forms()
    phase_nn_parity()
    phase_resnet50_train()
    encoder_launches, _encoder_t = phase_encoder_train()
    hapi_launches = phase_hapi_fit()
    incubate = phase_incubate_paths()
    phase_nn_seq_parity()
    phase_seq_models()
    phase_nn_spatial_parity()
    phase_spatial_models()
    phase_ops_parity()
    phase_tensor_paths()
    phase_optim_parity()
    phase_optim_models()
    for key in ("attention", "attention_split"):
        launches[key] += incubate["decode"][key]
    # the flash kernels' launches on every training path: llama2_7b, GPT-2,
    # DiT (training and the sampler), the two MoE forms, the Paddle-API
    # fused encoder, paddle.Model's sentence classifier and
    # flashmask_attention
    flash_launches = {k: flash_launches[k] + gpt_launches[k] +
                      dit_launches[k] + forms_launches[k] +
                      encoder_launches[k] + hapi_launches[k] +
                      incubate["flashmask"][k]
                      for k in flash_launches}
    wo_err, wo_t = phase_kernel_wo(built)
    wo_launches, _wo_sweeps = phase_weight_only_path()
    prim_err, prim_path, prim_t = phase_kernel_primitives(_smi, built)
    # each kernel's launches on its routes: the split and tile kernels of
    # the attention source and the sm90 prefill kernel, gmm's sm90 and simt
    # kernels
    attn_routes = {
        key: {"split": launches[f"{key}_split"],
              "sm90": launches[f"{key}_sm90"],
              "tile": launches[key] - launches[f"{key}_split"] -
              launches[f"{key}_sm90"]}
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
         "library_ms": None, "routes": attn_routes["attention_int8"]}] + [
        {"name": name, "route": "cuda", "source": ATTN_SM90_SOURCE,
         "replaces": ATTN_REPLACES, "launches": launches[f"{key}_sm90"],
         "max_abs_err": err["out"], "ms": pt["kernel_ms"],
         "plain_ms": pt["plain_ms"], "bound_ms": pt["bound_ms"],
         "bound_by": pt["bound_by"], "library_ms": pt["library_ms"],
         "tile_ms": pt["tile_ms"], "routes": attn_routes[key]}
        for name, key, err, pt in (
            ("ragged_paged_attention_prefill", "attention", attn_err, attn_p),
            ("ragged_paged_attention_int8_prefill", "attention_int8",
             int8_err, int8_p))] + [
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
        {"name": f"weight_only_{mode}", "route": "cuda",
         "source": WO_SM90_SOURCE, "replaces": WO_REPLACES,
         "launches": wo_launches[mode]["launches"],
         "routes": wo_launches[mode]["routes"],
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
         **({"routes": {"vec16": prim_path["launches"][f"{kind}_vec16"],
                        "scalar": prim_path["launches"][kind] -
                        prim_path["launches"][f"{kind}_vec16"]}}
            if kind in ("elementwise", "reduce") else {}),
         **({"routes": {r: prim_path["launches"][f"matmul_{r}"]
                        for r in PRIM_MM_ROUTES}}
            if kind == "matmul" else {})}
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
             else tp_cards() if sys.argv[1:] == ["--tp-cards"] else main())
