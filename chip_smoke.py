#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``llm_quest_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the port's
kernels from ``llm_quest_tpu_torch/csrc`` at first use. These main paths
are driven: the ViT-B/224 encode of bench.py's ViT cell (through K7, K8 and
K9), the TinyViT CIFAR-10 training loop of ``scripts/vit_training.py``, the
ViT-B/224 training step at b 128, the int8-score ablation of
``scripts/ablate_int8_scores.py`` (K12), Qwen3.5-0.8B generation, its batched text decode at b 128 (bench.py's
decode sweep), the dense Qwen3 training step of bench.py's train
workload, the Qwen3-Next hybrid training step of
``scripts/bench_hybrid_training.py``, the Gemma-3 sliding-window training
step at Gemma-3-270M's widths, the MiMo-V2-Flash training step of
``scripts/mimo_training.py`` at ``MIMO_V2_SMALL_CONFIG``, the DeepSeek-V3
MTP training step of ``scripts/deepseek_training.py`` at
``DEEPSEEK_SMALL_CONFIG`` (and its cached generation), the dense Qwen3 step
under context parallelism (``scripts/context_parallel_training.py``'s path,
at world 1 on one card), int8 Qwen3.5-0.8B text generation and int8
Qwen3-Next cached decode, and the continuous-batching serving engine on
bench.py's two serving cells and the int8 serve, and through its chunked,
prefix and multimodal admissions, and the MoE families through the engine:
Qwen3-30B-A3B at full width and depth, int8 and bf16, Qwen3-Next-small,
Gemma-3-270M, DeepSeek-V3 small and MiMo-V2-Flash small. Phases, one JSON
line each on stdout:

1. device: the card's name and the kernels' build time;
2. kernels: each hand-written kernel against its plain PyTorch version on the
   card, fp32 and bf16, with the tolerances below, and the time of both
   versions at its main path's shape. K1's forward covers dk 64 and 128,
   dv beside them, s 1 to 300 and the hybrid step's shape (b 4, h 8,
   s 2048, dk = dv = 64, bf16); its bf16 calls take the chunked tensor-core
   kernels (csrc/gdn_tc.cu, ``tc_launches``), fp32 the SIMT scan. K1's
   backward is held to its plain version (the per-chunk replay) on the
   kernel's own anchors (every 32 tokens in fp32, 64 in bf16) — (dk, dv)
   (64, 64), (128, 128), (64, 128), s 300 (a partial last chunk),
   prev_state on and off, a nonzero final-state cotangent — and through
   autograd to autograd of the plain chunked form. At the hybrid step's
   shape the bf16 output, final state and five gradients are also held
   per 64-token tile (TILE_TOL) beside a dropped-chunk control (one
   chunk's state update left out), which must read above the bar; the
   backward runs twice and must be bit-equal; forward, backward and
   forward + backward are timed there (CUDA events and device time), the
   forward also at the Qwen3.5 prefill (b 1, h 16, s 156, dk = dv = 128).
   The flash backward's dq/dk/dv are held to autograd through the plain
   ``sdpa`` (d 64/128/256, key mask on/off, GQA 16/8 and 8/2; and, in bf16,
   one layer of the dense train step at b = 4, s = 2048, output included)
   and timed forward + backward at that shape and at b = 1. K10 (int8 flash
   decode) at the int8 decode shape, a long context at b 16 and b 1 and
   Qwen3's head dim, on the cache's layer views: fp32 q on the SIMT kernel,
   bf16 q on the tensor-core kernel (csrc/flash_decode_tc.cu,
   ``tc_launches``), each (batch, q head) row within K10_ROW_TOL beside a
   control with one 64-key tile masked out of the plain version, two runs
   bit-equal, device ms, share of the bound and host µs a call; then
   ``split_sweep``: every cluster size at b 1 and 16, S 96 and 8192;
   K11 (int8 grouped matmul) at Qwen3-Next-small's decode and prefill
   shapes: fp32 rows on the SIMT kernel (both its row tilings), bf16 rows
   on the tensor-core kernel (csrc/quantized_gmm_tc.cu, ``tc_launches``) at
   the wrapper's row tile and K split, two runs bit-equal, each (expert,
   64-channel) tile within TILE_TOL beside a control with one K chunk of
   one expert dropped, timed beside ``torch._grouped_mm`` on a bf16 copy of
   the stack (``bf16_grouped_mm_ms``); then ``tiling_sweep``: the
   tensor-core kernel's row tiles and K splits around the wrapper's choice
   from T 8 to 2400, and the SIMT tilings (fp32) from T 32 to 512;
   K2 (the GDN decode step, csrc/gdn.cu) at its four paths' shapes
   (``K2_SHAPES``: b 1, Qwen3-Next's b 4 at dk 64 with 4 qk heads for 8 v
   heads, b 32 and b 128), fp32 and bf16, on q/k/v as views of one fused
   projection and beta in the inputs' dtype, other layers bitwise
   unchanged, timed with the L2 cold (``step_timing``: launches back to
   back over distinct states of at least 128 MB in all; the warm time, CUDA
   events and host µs beside it). K4 at one Gemma-3-270M layer (b 4, q/kv heads 4/1,
   d 256, s 2048), fp32 and bf16, forward and forward + backward, each with
   window 512 and causal, and softcap 30 with sinks (dsink checked); then
   ``k4_window_ratio``: the windowed kernels' device times at most 0.6x the
   causal ones.
   K4 with v's head dim 32 beside q/k's 64 at one MiMo-V2-Flash small layer
   (b 4, s 2048): the SWA layers' 12/4 heads with window 128 and sinks, and
   the GA layers' 12/2 heads causal, forward and forward + backward.
   K4 at DeepSeek-V3's MLA head dims (q/k 96, v 64) at one layer of its
   train step (b 4, 12/12 heads, s 2048, causal), forward and forward +
   backward.
   K7 at ViT-B's encode shape (b 128, s 197, 12 x 64) and at d 32 (b 128,
   s 65, 8 x 32; TinyViT's training shape), with its row lse, and forward +
   backward at both (b 16 checked, b 128 timed; the ViT-B and TinyViT train
   steps' attention), beside K4's tensor-core forward at ViT-B's packed
   strides (what K7's bf16 forward borrowed before);
   K8 with dynamic and with static scales and K9 at ViT-B's shape, K9 equal
   to K8 static bit for bit, two runs bit-equal; in bf16 on the int8-score
   tensor-core kernel (``tc_launches``), held tile by tile (TILE_TOL) beside
   the plain version with one 64-key piece dropped, and timed by CUDA
   events and profiler (``device_ms``: the kernel; ``call_device_ms``: with
   K8 dynamic's scale reductions). K3 (one layer's decode step, K2's kernel)
   at b 1 and 32, 16 heads of 128, timed as K2. K5 (flash attention with its lse) at one layer of the
   context-parallel step (b 1, 16/8 heads, d 128, s 8192), causal and not,
   forward and forward + backward with a random lse cotangent, fp32
   against plain within NEW_TOL, bf16 (o, lse, dq, dk, dv) within TOL and
   tile by tile. K6 (short-sequence MHA) at ViT-B's heads
   (not causal) and causal at b 4, 16 heads of 128, s 300, forward (with
   its row lse) and forward + backward. K12 (the
   ablation's attention core, csrc/attn_core_tc.cu, both variants on the
   tensor cores) at its two shapes, bf16 scores (G 1536, M 208, D 64) and
   int8 scores (M 224, D 128 zero-padded): bf16 within one bf16 unit of max
   |plain|; int8 each output within one bf16 unit of its plain value plus
   the fp32 summation bound of p·(v + t) (``kernel_k12``), beside a control
   with one 64-key chunk dropped from the plain version; two runs
   bit-equal; the bf16 one beside two ``torch.bmm``. Each record
   carries its bound and, where one PyTorch call computes the same
   function, that call's time (none for K8 and K9: ``bf16_sdpa_ms`` stands
   beside them; ``sdpa`` beside K5 returns no lse);
2a. int8_vs_bf16_scores: K9 beside K7's bf16 forward on the same bf16
   inputs at ViT-B's encode shape (the same bytes), CUDA events in turns and
   profiler times: whether int8 scores speed up the attention core;
3. vit_fp32: ViT-B's widths cut to 2 layers, b 8, fp32: the logits through
   K7, K8 (dynamic, static) and K9 against the plain versions, within
   LOGIT_TOL;
4. vit_encode: ViT-B/224 at full width and depth, b 128, bf16, under
   ``torch.inference_mode``, launch counts reset first, once in each mode
   (bf16 through K7; int8 dynamic and int8 static through K8; int8 inkernel
   through K9; 12 launches each, all on the tensor cores), then img/s, MFU,
   peak memory, each int8 mode's encode ms over bf16's and its logits
   against the bf16 encode's;
4a. vit_train_fp32: ViT-B's widths cut to 2 layers, b 8, fp32, no dropout:
   one ``make_vit_train_step`` through K7 against the plain step, the loss
   within VIT_LOSS_RTOL and every gradient within VIT_GRAD_RTOL of its
   largest; vit_train: the TinyViT script's ``main`` (12 layers, d 32, b 128,
   dropout 0.3, 20 epochs of its 3 seeded batches), launch counts reset
   first: K7 launches 12 times a step forward and 12 backward; img/s, peak
   memory and the losses;
   vit_b_train: ``VIT_BASE_CONFIG`` (dropout 0.1), b 128, bf16, 1 warm-up
   and 4 timed steps: 12 K7 launches a step forward and 12 backward, finite
   losses, img/s, MFU by ``vit_train_flops_per_image``, peak memory;
4b. ablate_int8_scores: the ablation's ``main()`` with the counts reset
   first: each K12 variant launches WARMUP + N_ITERS times; both times and
   the speedup of int8 scores;
5. check_fp32: the full-width Qwen3.5-0.8B generation path (random weights
   from a seeded generator) in fp32, once through the kernels and once with
   the plain versions forced: prefill logits close, first 16 greedy tokens
   equal;
6. main_path: the same two entry points in bf16 with every launch count reset
   first — ``generate_multimodal`` (a 384 px image, the 156-token prompt of
   bench.py, 64 greedy tokens) and ``generate_kv_cache`` at b = 4 with a
   300-token prompt — and every kernel of the path must have launched, and
   K7 none (the tower's s 576 is above ``fused_mha_max_seq``: ``sdpa``);
7. timing: tok/s and TTFT of both, with the card's name and power limit;
7a. text_decode_b128: bench.py's batched decode cell, Qwen3.5-0.8B text (24
   layers, bf16) at b 128, prompt 32, 8 greedy tokens, counts reset first:
   K2 launches 18 times a decode step; the device ms a step, K2's part and
   share of it and the kernels a step (profiler), and tok/s;
8. train_fp32: a 2-layer Qwen3 at Qwen3-0.6B widths, b = 1, s = 2048, the
   loss and every gradient through the kernels against the plain versions;
9. train: bench.py's train configuration (16 layers, b = 4, s = 2048, bf16,
   fused-head CE) through ``make_optimizer`` → ``make_train_step``, launch
   counts reset first, 1 warm-up and 4 timed steps: the loss is finite and
   falls, flash forward and backward each launch 16 times a step, and tok/s,
   step ms and MFU are printed with the card's name and power limit;
10. hybrid_fp32: Qwen3-Next-small at full width cut to 4 layers (3 GDN + 1
    GatedAttention), b = 1, s = 512, the loss and every gradient through the
    kernels against the plain versions;
11. hybrid_train: ``QWEN3_NEXT_SMALL_CONFIG`` at full width and depth (8
    layers), b = 4, s = 2048, bf16, fused-head CE, exact (ragged) MoE
    dispatch, as phase 9: K1 forward and backward launch 6 times a step,
    flash forward and backward twice; then the same with capacity dispatch
    (factor 1.25);
12. gemma_fp32: Gemma-3-270M widths cut to 6 layers (5 SWA + 1 global),
    b 2, s 1024, the loss and every gradient through the kernels against the
    plain versions (full-logits CE: the Gemma-3 model has no fused head);
    gemma_fp32_cached: a 700-token prompt's cached prefill (``sdpa`` on the
    dense masks) against the uncached flash forward, last logits;
13. gemma_train: the 18-layer model, b 4, s 2048, bf16, as phase 9: K4
    forward and backward each launch 18 times a step, 15 with the window;
    MFU with the port's SWA FLOP count; gemma_generate: b 1, a 300-token
    prompt, 16 greedy tokens through the cache branch, tok/s and TTFT;
14. mimo_fp32: MiMo-V2-Flash small at full width cut to 6 layers (GA, 4 SWA
    with sinks, GA), b 1, s 512, fp32: the MTP loss (within 1e-5 relative)
    and every gradient (within 1e-4) through the kernels against the plain
    versions, the expert counts equal; mimo_train: 12 layers, b 4, s 2048,
    bf16, full-logits CE, through ``make_mimo_train_step`` (the bias fold
    after the optimizer step), as phase 9: K4 forward and backward launch
    14 times a step (11 windowed with sinks: 9 SWA layers and 2 MTP blocks;
    3 causal GA layers), with MFU by the port's MiMo FLOP count;
15. dsv3_fp32: DeepSeek-V3 small at full width cut to 5 layers (3 dense, 2
    MoE), b 1, s 512, MTP depth 2, a batch from the MTP collator, fp32: the
    loss (within 1e-5 relative) and every gradient (within 1e-4) through the
    kernels against the plain versions, the expert counts equal; dsv3_train:
    12 layers, b 4, s 2048, bf16, full-logits CE, through
    ``make_deepseek_train_step`` (the bias fold after the optimizer step), as
    phase 9: K4 at (96, 64) forward and backward launch 14 times a step (12
    layers, 2 MTP blocks at the full s), with MFU by the port's DeepSeek
    FLOP count and the last step's max_vio; dsv3_generate_fp32: 2 layers,
    b 1, a 300-token prompt, 16 greedy cached tokens (``sdpa`` over the
    q/k 96, v 64 cache) equal to ``generate_loop_uncached``'s (K4 at each
    step); dsv3_generate: 12 layers, bf16, the same prompt, tok/s and TTFT;
16. cp_fp32: the dense Qwen3 at Qwen3-0.6B widths cut to 2 layers, b 1,
    s 1024, fp32, under ``cfg["context_parallel"]`` with a group of one made
    in process from a local store: the loss (within 1e-5 relative) and every
    gradient (within 1e-4 of its largest) through K5 against the plain CP
    step and against the step without CP (K4); cp_train: 16 layers, b 1,
    s 8192, bf16, as phase 9 on the rank's slice: K5 forward and backward
    launch 16 times a step and K4 none; then the same step without CP in
    the same call, its losses within the bf16 tolerance; cp_fallback: 16
    layers with 16/16 heads, b 2, s 300 (will not shard), fp32: K6 launches
    16 times and the logits match the forward with ``use_fused_mha`` False;
    its tok/s and peak memory;
17. int8_generate_fp32, next_serve_fp32 (``serving_checks_fp32``, the one
    phase after the kernel phase where plain versions run): int8 Qwen3.5-0.8B
    text and int8 Qwen3-Next-small at full width cut to 4 layers, fp32,
    kernels against plain: prefill logits within INT8_LOGIT_TOL, 16 greedy
    tokens equal, and no tensor-core launch (K1, K10, K11 on the SIMT kernels);
18. int8_generate: Qwen3.5-0.8B text, 24 layers, bf16, weights, tied table
    and KV cache int8, b = 1, prompt 32, 64 greedy tokens (K1, K2, K10);
19. next_serve: Qwen3-Next-small, 8 layers, bf16, linears and expert stacks
    int8, b = 4, 300-token prompts, 64 greedy tokens (K1, K2 at dk 64, K11).
    Phases 18 and 19 reset the counts, drive the int8 model once, then print
    tok/s, TTFT and MBU beside the bf16 model's, the per-step cost of the
    int8 → bf16 weight copies, and the device time of K1's forward and of
    K11 in a TTFT call beside the call's whole device time, and K11's,
    K2's and all device time and the kernels launched per decode step (a
    17-token call less the TTFT call, over 16 steps; ``torch.profiler``);
20. engine_serve_fp32 (``engine_check_fp32``, outside ``phase``: plain
    versions run): the continuous-batching engine
    (``inference/serving.py``) on Qwen3.5-0.8B text cut to 4 layers, fp32,
    4 slots, buckets 32 and 64, eight requests (three admitted mid-flight),
    an EOS that retires one: every request's tokens equal
    ``generate_kv_cache``'s for its prompt alone, through the kernels and
    through the plain versions; engine_admission_bf16: the same widths at 4
    layers in bf16, the first wave's admission logits within 5e-2 × max
    |ref| of a b = 1 prefill (the port's tests' bf16 bar, at their depth),
    for the uniform and mixed traffic and the int8 serve;
21. engine_serve_uniform, engine_serve_hetero, engine_serve_int8
    (``engine_serving``): 12 layers (ENGINE_LAYERS; Qwen3.5-0.8B has 24), bf16,
    32 slots, chunk 64, 48 requests:
    ``bench_serving``'s traffic (prompts 32, budgets U[16, 64], greedy;
    K1, K2), ``bench_serving_hetero``'s (prompts U[8, 200] into buckets 32,
    64 and 256, the four samplers in turn; K1, K2, K4) and the uniform
    traffic with int8 weights, tied table and KV cache (K1, K2, K10). Each
    first holds the engine to the plain versions (``engine_vs_plain``; the
    plain runs are K1's, K2's, K4's and K10's and the model's with
    ``use_kernels`` False, none that ``phase`` watches): its first wave
    (32 requests; 24 in the int8 serve, so 8 slots stay empty) and one
    decode step, every kernel call in them against its plain version on
    its own inputs (TOL, tile bars beside dropped-chunk and dropped-tile
    controls, K10's empty rows finite), and their logits within
    ENGINE_PLAIN_BAR × max |plain| of the same calls through the plain
    versions, beside a control with 16 tokens of every prompt masked out.
    Then ``warmup``, useful tok/s over the median of 3 serves (the uniform
    traffic also at ``pipeline_depth`` 2, in turns with depth 1),
    ``stats()`` (TTFT p50, chunks, slot utilization), each kernel's
    launches in the first serve (every request its budget long, every
    token in the vocabulary; the first wave's admission logits bit-equal
    to a b = k prefill of the wave, their distance from a b = 1 prefill
    reported), device ms, kernels and busy share a decode step (a profiled
    8-step chunk), and the share of greedy tokens equal to
    ``generate_kv_cache``'s (reported, not gated: random weights give
    near-tied logits).
22. engine_chunked_prefill, engine_prefix, engine_vlm
    (``engine_admission_paths``): the engine's chunked, prefix and
    multimodal admissions at full width, bf16 (chunked and multimodal at
    ENGINE_LAYERS = 12 layers of 24). Chunked
    (``scripts/bench_serving_ttft_long.py``): Qwen3.5-0.8B text, 16 slots,
    chunk 16, bucket 32, ``prefill_chunk`` 512, max_len 8320; 15 short
    requests (32 tokens, budget 64) with one long prompt (4096, then 8192
    tokens) behind them, 5 times a length: the long prompt's TTFT p50/p95,
    the pool's useful tok/s, K1 and K4 calls a long admission (18 and 6 a
    chunk, checked) and K4's device ms a chunk index (profiled), beside
    the K4 record ``flash_attention_fwd_chunked`` (a chunk at every
    q_start against the 8320 columns, ``sdpa`` with the same mask).
    Prefix (``scripts/bench_prefix_caching.py``): its dense Qwen3 (16
    layers), 2 slots, chunk 1, prefixes 1024 and 4096 with a 32-token
    suffix, and Qwen3.5-0.8B text at prefix 2048: TTFT with and without
    the prefix (medians of 5), the speedup, the registration's seconds.
    Multimodal (``scripts/bench_vlm_serving.py``): the Qwen3.5-0.8B VLM,
    16 slots, bucket 160, max_len 256, chunk 16, 32 requests each with a
    uint8 384 px image normalized on the card by ``pixel_transform``, after
    ``warmup(image_shape=, image_dtype=uint8)``: useful tok/s and TTFT
    p50/p95, and the same prompts without their images. Before timing,
    each record holds every kernel call of its first admissions (the
    first long prompt's chunks, the prefix's registration and first
    suffix wave, the first 16-row multimodal wave) and of one decode step
    to its plain version (``HeldToPlain``: K1 with a carried state beside
    the output of its plain version started from zeros), and the logits
    to ``use_kernels`` False within ENGINE_PLAIN_BAR beside a control:
    each long prompt against one uncached prefill of it (control: the GDN
    updates of its last 64-token chunk left out), the suffix admission
    against a full-prompt admission (control: the suffix on a zeroed
    prefix row), the multimodal wave against the same wave (control:
    request 0's image zeroed); every request gets its budget, and the
    decode position after an image is its largest 3-D position + 1.
23. engine_serve_moe_bf16, engine_moe_weights, engine_serve_moe_int8,
    engine_serve_next, engine_serve_next_int8, engine_families
    (``engine_moe_paths``), ``bench_serving_hetero``'s traffic: Qwen3-30B-A3B
    (``qwen3_config_creator("30B-A3B")``: 48 layers, d 2048, 32/4 heads of
    128, 128 experts top-8 of 768, 30.53 B parameters, seeded random
    weights) in bf16 (16 slots, chunk 16, 16 requests, one serve; K4 at the
    256 bucket; the experts by the per-expert loop with its host read), then
    quantized in place (linears and expert stacks; its seconds, peak memory
    and sizes) with the int8 KV cache (32 slots, 48 requests, median of 3
    serves; K4, K10 and K11 at E 128), Qwen3-Next-small (8 layers) in bf16
    (K1, K2) and int8 with the int8 KV cache (K1, K2, K11), whose decode
    step's control also zeroes the GDN states. Each first
    ``engine_vs_plain`` with K11 held too (every call within TOL, its
    (expert, 64-channel) tiles within TILE_TOL beside a control with one
    K chunk of the largest expert dropped), then the record as phase 21
    with its peak memory, each kernel's launches a multiple of its calls a
    forward, and, for the int8 30B pool, one decode step under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync). Then
    Gemma-3 at Gemma-3-270M's widths (18 layers), DeepSeek-V3 small and
    MiMo-V2-Flash small (12 layers), bf16, 8 slots, 16 greedy requests: no
    kernel launches (``sdpa`` on the cache, as in JAX), useful tok/s, the
    share of tokens equal to ``generate_kv_cache``'s, finite admission
    logits, MiMo's cached prefill logits beside its uncached forward, and
    its fp32 cached tokens (4 layers) equal to ``generate_loop_uncached``'s.
    The kernel phase holds K4 (b 32, 32/4 heads, d 128, 256 queries against
    384 columns), K10 (b 32, 32/4 heads, d 128, S 384) and K11 (E 128,
    top-8, 2048 -> 768 and 768 -> 2048 at T 256 and 65,536) at these
    shapes.

K4, K5, K6 and K7 take two routes by dtype: in bf16, K4 and K5 run the
tensor-core kernels of ``csrc/attention_tc.cu``, K6 and K7 the
short-sequence tensor-core kernel of ``csrc/fused_mha_tc.cu`` forward and
``attention_tc.cu``'s backward kernels; in fp32 the SIMT kernels of
``csrc/attention.cu`` (and ``csrc/fused_mha.cu``, K6's forward). K1 takes
two routes the same way: bf16 the chunked kernels of ``csrc/gdn_tc.cu``,
fp32 the scan of ``csrc/gdn.cu``; K11 too: bf16 rows the tensor-core
kernel of ``csrc/quantized_gmm_tc.cu``, fp32 rows the SIMT one of
``csrc/quantized_gmm.cu``; and K10: bf16 q ``csrc/flash_decode_tc.cu``, fp32
q ``csrc/flash_decode.cu``. K12 has only the tensor-core kernel. Their
records keep the fp32 error as ``max_abs_err`` and add
``max_abs_err_bf16`` (the tensor-core error on the same bf16 inputs); K5's
bf16 records and the dense train shape's bf16 fwd + bwd are also held tile
by tile (TILE_TOL, LSE_TOL), beside the readings of a result with one key
tile dropped, which must exceed those bars, and so are K6's and K7's bf16
records (against the plain version in fp32 on the same values); the bf16
backward at the dense train shape runs twice and must be bit-equal; every
path's reading of the launch counts fails if a bf16 path's
K1/K4–K12 launches, forward and backward, were not all
tensor-core launches (``tc_launches``, ``tc_bwd_launches``, counted by the
C library where it launches those kernels), or an fp32 path's were not all
SIMT; and every phase after the kernel phase fails if K6's plain version,
the plain backward of K6, K7 or K8, or the plain version of K8, K9 or
K11 ran in it (``phase``).
``k4_window_ratio`` prints the CUDA-event ratio beside the checked device
ratio, and ``k4_host_cost`` where a bf16 K4 fwd + bwd call's time goes
(device, host, the C entry points). Every record carries ``tflops``, its
FLOPs over its ms. A record's ``device_ms`` is its kernels' time in a
``torch.profiler`` trace; where the profiler gives no trace of the card
(it sometimes stops doing so for the rest of a process), the call's whole
device time with the host's launch work hidden behind a sleep kernel
(``queued_ms``). The ``device_timing`` line says which records took it.

Then the kernels summary line, the ``nvidia-smi`` name/power-limit line and,
last, ``{"ok": true, "device": {...}}``. Any failure exits nonzero before the
last line; there is no CPU fallback.

    python3 chip_smoke.py --profile

runs only the device phase and a ``torch.profiler`` breakdown of the train
steps of phases 9, 11, 13, 14, 15, 16 (cp_train) and 4a (vit_b_train and
the TinyViT step of vit_train; 2 warm-up and 2 profiled steps each) and of the
ViT-B encode through K7 and through K8 with static scales (1 warm-up, 2
profiled encodes each): the device's busy share of the profiled wall and the
device time per step by kernel group (the short-sequence forward of K6
and K7, flash forward, dq, dk/dv (also K6's and K7's backward), GDN's
bf16 kernels by phase and its fp32 forward, backward and reduction, K8/K9's
tensor-core and SIMT kernels, cuBLAS GEMMs, the rest), one JSON line each.
"""

import contextlib
import json
import math
import statistics
from functools import partial
import subprocess
import sys
import time

# kernel-vs-plain tolerances on max |kernel - plain|, relative to max(1, max |plain|).
# fp32: both sides compute in fp32, in another summation order (the GDN kernel
# is the exact scan, its plain version the chunked form). bf16: the inputs and
# outputs are bf16 (8 bits of mantissa), so one output rounding step differs.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# K5's bf16 records and the dense train shape's bf16 fwd + bwd are also held
# tile by tile, beside TOL: ||kernel - plain|| / ||plain|| over each 64-row
# tile of the sequence axis (per batch and head) within TILE_TOL, and the
# fp32 lse within LSE_TOL absolute. TOL's bar scales with max |plain|, which
# in a causal call is row 0's |v|, while late rows are about sqrt(e/s) of it:
# a kernel wrong on late key tiles passes TOL. One 64-key tile dropped moves
# every tile that sees it by more than these bars (``dropped_tile``, checked
# in the same run); bf16 operand rounding moves a tile by far less.
TILE_TOL = 2e-2
LSE_TOL = 1e-3
# whole-path fp32 check: prefill logits, kernels vs plain, absolute
LOGIT_TOL = 2e-3
# fp32 train checks, kernels vs plain: the loss relative, each gradient's
# max |g_kernel - g_plain| relative to max |g_plain| (other summation orders
# through 2 to 4 layers and the 151,936-row head; the GDN kernels are the
# exact scan, their plain versions the chunked form)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# fp32 kernel-vs-plain bar of the kernels ported for context parallelism (K3,
# K5, K6), relative to max(1, max |plain|)
NEW_TOL = 1e-5
# the context-parallel fp32 check (2 layers, s 1024): the loss relative, each
# gradient relative to its largest value, kernels vs plain and CP vs not
CP_LOSS_RTOL = 1e-5
CP_GRAD_RTOL = 1e-4
# the ViT train step in fp32 at 2 layers, K7 vs plain: the loss relative, each
# gradient relative to its largest value (K7's SIMT forward and backward
# against autograd through the plain packed sdpa)
VIT_LOSS_RTOL = 1e-6
VIT_GRAD_RTOL = 1e-5
# fp32 serving checks at 4 layers, kernels vs plain: last prefill logits,
# absolute (the GDN kernel is the exact scan, its plain version the chunked form)
INT8_LOGIT_TOL = 1e-4
SEED = 0
DEVICE = "cuda"
CP_BACKEND = "nccl"  # the context-parallel group's backend on the card (world 1: no transfer is made)
# the card's published rates (H100 SXM, NVIDIA's data sheet, dense, at 700 W):
# device memory, bf16 on the tensor cores, fp32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


PROFILER = {"given_up": False, "empty_traces": 0, "queued_keys": []}  # how the run's device times were taken


def profiled(fn, iters, key=""):
    """A ``torch.profiler`` trace (host and card) of ``iters`` calls of
    ``fn`` after one warm-up call, and its device events. Now and then the
    profiler hands back a trace with none of the card's activity (or none
    of the kernels whose names contain ``key``), and once it has, later
    traces in the same process tend to come back empty too: such a trace is
    taken again, up to three times in all. After three empty traces the
    run stops asking the profiler and this returns ``(None, [])``, as it
    does from then on."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(0 if PROFILER["given_up"] else 3):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if any(key in e.name for e in events):
            return prof, events
        PROFILER["empty_traces"] += 1
    PROFILER["given_up"] = True
    return None, []


def queued_ms(fn, iters=20):
    """Device time per call of all the work ``fn`` puts on the card, taken
    without the profiler: a sleep kernel holds the stream while the host
    queues ``iters`` calls, and CUDA events around them time the card
    running them back to back, so the host's launch work is not counted.
    Where the sleep ran out before the host had queued every call (the
    first event had already passed), it is taken again with a sleep four
    times as long and half the calls (a full launch queue also blocks the
    host), up to four times in all."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(4e9 * iters * (time.perf_counter() - t0)) + 10**7  # twice the host's time at 2 GHz
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles, iters = 4 * cycles, max(1, iters // 2)
    raise AssertionError("the host could not queue the calls ahead of the card")


def device_ms(fn, key, iters=20):
    """Device time per call of the kernels whose names contain ``key``, summed
    from a ``torch.profiler`` trace of ``iters`` calls (CUDA events around a
    call of a few microseconds time the host's launch work instead). Where
    the profiler gives no such trace (``profiled``), the device time of all
    of the call's work by ``queued_ms``, and ``key`` is noted in
    ``PROFILER["queued_keys"]``."""
    events = [e for e in profiled(fn, iters, key)[1] if key in e.name]
    if not events:
        PROFILER["queued_keys"].append(key)
        return queued_ms(fn, iters)
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters


TC_KERNELS = "attention_tc_"  # the name stem of the bf16 tensor-core attention kernels (csrc/attention_tc.cu)
# the stem shared by those and the short-sequence tensor-core kernel (csrc/fused_mha_tc.cu)
TC_KEY = "_tc_"


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max()), float(ref.float().abs().max())


def check(name, got, ref, dtype, tol=None):
    """max |got - ref|, which must stay within ``tol`` (default TOL of the
    dtype) times max(1, max |ref|)."""
    err, scale = max_err(got, ref)
    tol = (tol or TOL[str(dtype).removeprefix("torch.")]) * max(1.0, scale)
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


def tile_rel_err(got, ref, rows=64):
    """max over the ``rows``-row tiles of the sequence axis (dim -2) of
    ||got - ref|| / ||ref||; a tile where both are zero reads 0."""
    import torch

    diff, ref = got.float() - ref.float(), ref.float()
    pad = (-ref.shape[-2]) % rows

    def tile_sq(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        return t.unflatten(-2, (-1, rows)).square().sum((-2, -1))

    num, den = tile_sq(diff), tile_sq(ref)
    return float((num / den.clamp_min(torch.finfo(torch.float32).tiny)).sqrt().max())


def tile_readings(got, ref, names):
    """TILE_TOL's reading of each (b, h, s, w) output in ``names`` and
    LSE_TOL's (max abs error) of the lse, against plain."""
    return {n: float((g.float() - r.float()).abs().max()) if n == "lse" else tile_rel_err(g, r)
            for n, g, r in zip(names, got, ref)}


def check_tiles(name, got, ref, names):
    """The bf16 attention outputs ``names`` against plain, tile by tile:
    each within TILE_TOL (the lse within LSE_TOL); returns the readings."""
    readings = tile_readings(got, ref, names)
    for n, e in readings.items():
        bar = LSE_TOL if n == "lse" else TILE_TOL
        if not e <= bar:  # also catches NaN
            raise AssertionError(f"{name} {n}: tile error {e} > {bar}")
    return readings


def dropped_tile(name, leaves, do, ref, names, *, causal, g_lse=None):
    """The readings of ``check_tiles`` for a deliberately wrong result: the
    plain version with the 64 keys [s - 128, s - 64) dropped (a key mask),
    against the plain reference ``ref``. Each must exceed its bar, or the
    bar could not see such a fault; returns the readings."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    q, k, v = (t.detach().requires_grad_() for t in leaves)
    b, s = k.shape[0], k.shape[2]
    keep = torch.ones(b, s, dtype=torch.bool, device=DEVICE)
    keep[:, s - 128 : s - 64] = False
    with torch.enable_grad():
        outs = [attn.flash_attention(q, k, v, attn_mask=keep, causal=causal, plain=True)]
        cts = [do]
        if "lse" in names:
            outs.append(attn._plain_lse(q, k, keep, causal, 0, q.shape[-1] ** -0.5))
            cts.append(g_lse)
        grads = torch.autograd.grad(outs, (q, k, v), cts) if "dq" in names else ()
    readings = tile_readings([t.detach() for t in outs] + list(grads), ref, names)
    for n, e in readings.items():
        bar = LSE_TOL if n == "lse" else TILE_TOL
        if not e > bar:
            raise AssertionError(f"{name} {n}: a dropped key tile reads {e}, within the bar {bar}")
    return readings


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, dtype="bfloat16"):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of the inputs' type;
    ``simt_bound_ms`` takes the fp32 rate outside the tensor cores instead."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "simt_bound_ms": max(t_bytes, flops / PEAK_FLOPS["float32"]) * 1e3, "bytes": n_bytes, "flops": flops}


def bound_int8(n_bytes, int8_ops, bf16_flops):
    """``bound`` for the int8-score kernels: the score products at the int8
    peak and p·V at the bf16 peak, in series; ``simt_bound_ms`` takes both at
    the fp32 rate outside the tensor cores."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = int8_ops / PEAK_FLOPS["int8"] + bf16_flops / PEAK_FLOPS["bfloat16"]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "simt_bound_ms": max(t_bytes, (int8_ops + bf16_flops) / PEAK_FLOPS["float32"]) * 1e3,
            "bytes": n_bytes, "flops": int8_ops + bf16_flops, "int8_ops": int8_ops}


def randn(gen, *shape, dtype=None, scale=1.0):
    import torch

    return (torch.randn(*shape, generator=gen, device=DEVICE) * scale).to(dtype or torch.float32)


# ------------------------------------------------------------------ kernels


def gdn_inputs(gen, b, h, s, dtype, dk=128, dv=128):
    import torch

    from llm_quest_tpu_torch.ops.gdn import l2_norm_clamp

    q = l2_norm_clamp(randn(gen, b, h, s, dk)).to(dtype)
    k = l2_norm_clamp(randn(gen, b, h, s, dk)).to(dtype)
    v = randn(gen, b, h, s, dv, dtype=dtype)
    beta = torch.sigmoid(randn(gen, b, h, s))
    alpha = torch.sigmoid(randn(gen, b, h, s, scale=0.3) + 2.0)
    s0 = randn(gen, b, h, dv, dk, scale=0.1)
    return q, k, v, beta, alpha, s0


GDN_HYBRID = (4, 8, 2048, 64, 64)  # b, h, s, dk, dv of the hybrid train step's GDN layers
GDN_PREFILL = (1, 16, 156, 128, 128)  # the Qwen3.5-0.8B prefill of the generation path
# the chunk of 64 whose state update the dropped-chunk control leaves out (of 32 at s 2048): the last
# chunk's output and the gradients see it; the final state's control leaves out the last chunk's update
# (an earlier chunk's reaches it only through gamma_C, about 3e-4 with these inputs)
GDN_SKIP = 30
GDN_TC_KEY = "gdn_tc_"  # the name stem of the bf16 tensor-core GDN kernels (csrc/gdn_tc.cu)


def gdn_flops(b, h, s, dk, dv):
    """The recurrence's 4 dk·dv multiply-adds a token and head (S·k, the
    rank-1 update, the decay, S·q), as FLOPs."""
    return 8 * dk * dv * b * h * s


def gdn_tiles(got, ref, names):
    """TILE_TOL's readings of K1's outputs: 64-token tiles of (b, h, s[, w])
    tensors (the state: 64-row tiles of its dv rows)."""
    def as_rows(t):
        return t.unsqueeze(-1) if t.dim() == 3 else t

    return {n: tile_rel_err(as_rows(g), as_rows(r)) for n, g, r in zip(names, got, ref)}


def gdn_skip_chunk(q, k, v, beta, alpha, skip, chunk=64):
    """The plain chunked form from a zero state with chunk ``skip``'s state
    update left out (its output kept): a fault the tile bars must catch."""
    import torch

    from llm_quest_tpu_torch.ops import gdn as gdn_ops

    b, h, s, dk = q.shape
    dv = v.shape[-1]
    qc, kc, vc, bc, ac, s_pad = gdn_ops.chunk_views(q, k, v, beta, alpha, chunk)
    state = torch.zeros(b, h, dv, dk, device=q.device)
    outs = []
    for i in range(qc.shape[2]):
        new, o = gdn_ops.gdn_chunk(qc[:, :, i], kc[:, :, i], vc[:, :, i], bc[:, :, i], ac[:, :, i], state)
        outs.append(o)
        state = state if i == skip else new
    return torch.stack(outs, 2).reshape(b, h, s_pad, dv)[:, :, :s].to(q.dtype), state


def check_gdn_tiles(name, got, ref, names, control):
    """K1's bf16 outputs against plain, tile by tile, each within TILE_TOL;
    the dropped-chunk ``control`` must read above it on every output."""
    readings, dropped = gdn_tiles(got, ref, names), gdn_tiles(control, ref, names)
    for n in names:
        if not readings[n] <= TILE_TOL:  # also catches NaN
            raise AssertionError(f"{name} {n}: tile error {readings[n]} > {TILE_TOL}")
        if not dropped[n] > TILE_TOL:
            raise AssertionError(f"{name} {n}: the dropped-chunk control reads {dropped[n]}, within {TILE_TOL}")
    return readings, dropped


def tc_count(wrapper, fn):
    """``fn()`` and how many of its launches of ``wrapper`` took the bf16 tensor-core kernels."""
    before = wrapper.tc_launches
    result = fn()
    return result, wrapper.tc_launches - before


def kernel_k1(gen, dtypes):
    import torch

    from llm_quest_tpu_torch.kernels import gdn

    fwd = gdn.gated_delta_rule_fwd
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        for b, h, s, dk, dv in ((1, 16, 156, 128, 128), (4, 16, 300, 128, 128), (2, 8, 300, 64, 64),
                                (2, 4, 37, 64, 128), (2, 4, 1, 128, 64)):
            q, k, v, beta, alpha, s0 = gdn_inputs(gen, b, h, s, dtype, dk=dk, dv=dv)
            (out, st), tc = tc_count(fwd, lambda: fwd(q, k, v, beta, alpha, s0))
            ref_out, ref_st = fwd(q, k, v, beta, alpha, s0, plain=True)
            torch_sync()
            if tc != int(dtype == torch.bfloat16):
                raise AssertionError(f"K1 {dtype}: {tc} tensor-core launches of 1")
            e = max(check(f"K1 out b={b} s={s} dk={dk} dv={dv} {dtype}", out, ref_out, dtype),
                    check(f"K1 state b={b} s={s} dk={dk} dv={dv} {dtype}", st, ref_st, dtype))
            cases.append({"b": b, "h": h, "s": s, "dk": dk, "dv": dv, "dtype": str(dtype), "max_abs_err": e,
                          "tc_launches": tc})
            (errs if dtype == dtypes[0] else errs_bf16).append(e)
    # the hybrid train step's shape, bf16, from a zero state: checked (whole and by tile, beside the
    # dropped-chunk control) and timed
    b, h, s, dk, dv = GDN_HYBRID
    q, k, v, beta, alpha, _ = gdn_inputs(gen, b, h, s, dtypes[-1], dk=dk, dv=dv)
    (out, st), tc = tc_count(fwd, lambda: fwd(q, k, v, beta, alpha))
    ref_out, ref_st = fwd(q, k, v, beta, alpha, plain=True)
    torch_sync()
    control = (gdn_skip_chunk(q, k, v, beta, alpha, GDN_SKIP)[0],
               gdn_skip_chunk(q, k, v, beta, alpha, s // 64 - 1)[1])
    readings, dropped = check_gdn_tiles("K1 hybrid shape", (out, st), (ref_out, ref_st), ("out", "state"), control)
    hybrid = {"shape": f"b {b}, h {h}, s {s}, dk {dk}, dv {dv}, {dtypes[-1]}", "tc_launches": tc,
              "max_abs_err": max(check("K1 out hybrid shape", out, ref_out, dtypes[-1]),
                                 check("K1 state hybrid shape", st, ref_st, dtypes[-1])),
              "tile_err": readings, "dropped_chunk_tile_err": dropped,
              "ms": cuda_ms(lambda: fwd(q, k, v, beta, alpha), iters=10, warmup=2),
              "device_ms": device_ms(lambda: fwd(q, k, v, beta, alpha), GDN_TC_KEY, iters=10),
              "plain_ms": cuda_ms(lambda: fwd(q, k, v, beta, alpha, plain=True), iters=5, warmup=1),
              **bound(nbytes(q, k, v, beta, alpha, out, st), gdn_flops(*GDN_HYBRID))}
    cases.append(hybrid)
    del q, k, v, beta, alpha, out, st, ref_out, ref_st
    torch.cuda.empty_cache()
    # the record's time: the generation path's prefill shape
    b, h, s, dk, dv = GDN_PREFILL
    q, k, v, beta, alpha, s0 = gdn_inputs(gen, b, h, s, dtypes[-1], dk=dk, dv=dv)
    ms = cuda_ms(lambda: fwd(q, k, v, beta, alpha, s0))
    plain_ms = cuda_ms(lambda: fwd(q, k, v, beta, alpha, s0, plain=True))
    out, st = fwd(q, k, v, beta, alpha, s0)
    extra = {**bound(nbytes(q, k, v, beta, alpha, s0, out, st), gdn_flops(*GDN_PREFILL)), "library_ms": None,
             "max_abs_err_bf16": max(errs_bf16), "tile_err_bf16": readings,
             "device_ms": device_ms(lambda: fwd(q, k, v, beta, alpha, s0), GDN_TC_KEY),
             "record": {"hybrid_fwd_ms": hybrid["ms"], "hybrid_fwd_device_ms": hybrid["device_ms"],
                        "hybrid_fwd_bound_ms": hybrid["bound_ms"]}}
    return max(errs), ms, plain_ms, cases, extra


def kernel_k1_bwd(gen, dtypes):
    """K1's backward against its plain version (the per-chunk replay) on the
    kernel's own anchors (every 32 tokens in fp32, every 64 in bf16), and the
    autograd Function against autograd through the plain chunked forward; at
    the hybrid step's shape in bf16 also tile by tile beside the
    dropped-chunk control, twice for bit-equal gradients, and forward,
    backward and forward + backward timed."""
    import torch

    from llm_quest_tpu_torch.kernels import gdn

    fwd, bwd = gdn.gated_delta_rule_fwd, gdn.gated_delta_rule_bwd
    names = ("dq", "dk", "dv", "dbeta", "dalpha", "d_prev")
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        c = gdn.anchor_chunk(dtype)
        for dk, dv in ((64, 64), (128, 128), (64, 128)):
            for with_prev in (False, True):
                q, k, v, beta, alpha, s0 = gdn_inputs(gen, 2, 8, 300, dtype, dk=dk, dv=dv)
                prev = s0 if with_prev else None
                d_out, d_state = randn(gen, 2, 8, 300, dv, dtype=dtype), randn(gen, 2, 8, dv, dk)
                _, _, anchors = gdn._launch_fwd(q, k, v, beta, alpha, prev, anchor_chunk=c)
                got, tc = tc_count(bwd, lambda: bwd(q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=c))
                ref = bwd(q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=c, plain=True)
                torch_sync()
                if tc != int(dtype == torch.bfloat16):
                    raise AssertionError(f"K1 bwd {dtype}: {tc} tensor-core launches of 1")
                e = max(check(f"K1 bwd {n} dk={dk} dv={dv} prev={with_prev} {dtype}", g, r, dtype)
                        for n, g, r in zip(names, got, ref))
                cases.append({"b": 2, "h": 8, "s": 300, "dk": dk, "dv": dv, "prev_state": with_prev, "d_state": True,
                              "anchor_chunk": c, "dtype": str(dtype), "max_abs_err": e, "tc_launches": tc})
                (errs if dtype == dtypes[0] else errs_bf16).append(e)
        # through autograd, from the wrapper a model calls
        q, k, v, beta, alpha, s0 = gdn_inputs(gen, 2, 8, 300, dtype, dk=64, dv=64)
        d_out, d_state = randn(gen, 2, 8, 300, 64, dtype=dtype), randn(gen, 2, 8, 64, 64)
        grads = []
        for plain in (False, True):
            args = [t.clone().requires_grad_() for t in (q, k, v, beta, alpha, s0)]
            out, st = fwd(*args, plain=plain)
            grads.append(torch.autograd.grad((out, st), args, (d_out, d_state)))
        torch_sync()
        e = max(check(f"K1 autograd {n} {dtype}", g, r, dtype) for n, g, r in zip(names, *grads))
        cases.append({"autograd": True, "b": 2, "h": 8, "s": 300, "dk": 64, "dtype": str(dtype), "max_abs_err": e})
    # the hybrid train step's shape, bf16
    dtype = dtypes[-1]
    c = gdn.anchor_chunk(dtype)
    b, h, s, dk, dv = GDN_HYBRID
    q, k, v, beta, alpha, _ = gdn_inputs(gen, b, h, s, dtype, dk=dk, dv=dv)
    d_out = randn(gen, b, h, s, dv, dtype=dtype)
    _, _, anchors = gdn._launch_fwd(q, k, v, beta, alpha, None, anchor_chunk=c)
    got = bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=c)
    again = bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=c)
    ref = bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=c, plain=True)
    torch_sync()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("K1 bwd hybrid shape: two runs from the same anchors differ")
    leaves = [t.clone().requires_grad_() for t in (q, k, v, beta, alpha)]
    with torch.enable_grad():
        control = torch.autograd.grad(gdn_skip_chunk(*leaves, GDN_SKIP)[0], leaves, d_out)
    readings, dropped = check_gdn_tiles("K1 bwd hybrid shape", got[:5], ref[:5], names[:5], control)
    case = {"shape": f"b {b}, h {h}, s {s}, dk {dk}, dv {dv}, {dtype}", "bitwise_equal_runs": True,
            "max_abs_err": {n: check(f"K1 bwd {n} hybrid shape", g, r, dtype) for n, g, r in zip(names, got, ref)},
            "max_abs_ref": {n: max_err(g, r)[1] for n, g, r in zip(names, got, ref)},
            "tile_err": readings, "dropped_chunk_tile_err": dropped}
    del got, again, ref, control
    args = [t.clone().requires_grad_() for t in (q, k, v, beta, alpha)]

    def kernel_fwd_bwd():
        out, _ = fwd(*args)
        return torch.autograd.grad(out, args, d_out)

    def plain_fwd_bwd():  # the plain halves at the JAX chunk of 64
        _, _, anc = gdn.gated_delta_rule_fwd_plain(q, k, v, beta, alpha, chunk_size=64, with_anchors=True)
        return bwd(q, k, v, beta, alpha, anc, d_out, None, chunk_size=64, plain=True)

    def kernel_bwd():
        return bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=c)

    case["fwd_bwd_ms"] = cuda_ms(kernel_fwd_bwd, iters=10, warmup=2)
    case["fwd_bwd_device_ms"] = device_ms(kernel_fwd_bwd, GDN_TC_KEY, iters=10)
    case["plain_fwd_bwd_ms"] = cuda_ms(plain_fwd_bwd, iters=3, warmup=1)
    case["fwd_anchors_ms"] = cuda_ms(lambda: gdn._launch_fwd(q, k, v, beta, alpha, None, anchor_chunk=c),
                                     iters=10, warmup=2)
    case["bwd_ms"] = cuda_ms(kernel_bwd, iters=10, warmup=2)
    case["bwd_device_ms"] = device_ms(kernel_bwd, GDN_TC_KEY, iters=10)
    case["plain_bwd_ms"] = cuda_ms(lambda: bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=c, plain=True),
                                   iters=3, warmup=1)
    # forward + backward: the inputs and d_out read, out and the five gradients
    # written; 3x the forward's 4 dk·dv multiply-adds a token and head. The
    # backward alone: the inputs, d_out and the chunk states read (their
    # fp32 size, which the hi + lo halves take; D^T, which the kernels also
    # keep, is not counted: it follows from the states), the gradients
    # written; 2x the forward's
    grads = nbytes(q, k, v) + 2 * nbytes(beta)
    case["bwd_bound"] = bound(nbytes(q, k, v, beta, alpha, d_out, anchors.states) + grads,
                              2 * gdn_flops(*GDN_HYBRID))
    cases.append(case)
    extra = {**bound(nbytes(q, k, v, beta, alpha, d_out) + nbytes(d_out) + grads, 3 * gdn_flops(*GDN_HYBRID)),
             "library_ms": None, "max_abs_err_bf16": max(errs_bf16), "tile_err_bf16": readings,
             "device_ms": case["fwd_bwd_device_ms"],
             "record": {"bwd_ms": case["bwd_ms"], "bwd_device_ms": case["bwd_device_ms"],
                        "bwd_bound_ms": case["bwd_bound"]["bound_ms"], "bitwise_equal_runs": True}}
    del q, k, v, beta, alpha, d_out, anchors, args
    torch.cuda.empty_cache()
    return max(errs), case["fwd_bwd_ms"], case["plain_fwd_bwd_ms"], cases, extra


# K2's shapes: (name, L, b, h, h_qk, dk = dv, layer). Qwen3.5-0.8B generation
# (b 1; the int8 and bf16 generation paths), Qwen3-Next-small serving (b 4, 8
# v heads reading 4 qk heads, dk 64), bench.py's decode sweep (b 32 and 128;
# ``text_decode_b128``). The record's top line is b 128, where the step moves
# the most bytes.
K2_SHAPES = (("b1", 18, 1, 16, 16, 128, 7), ("next", 6, 4, 8, 4, 64, 3), ("b32", 18, 32, 16, 16, 128, 7),
             ("b128", 18, 128, 16, 16, 128, 7))
K2_KEY = "gdn_step_stacked_kernel"  # the step kernel's name (csrc/gdn.cu), K2's and K3's
# the distinct states a cold timing rotates over hold at least this many bytes: 2.5 times the H100's 50 MB L2
ROTATE_BYTES = 128 * 2**20


def rotation(state, min_copies=2):
    """A contiguous (n, *state.shape) stack of copies of ``state``, n large enough that the stack holds
    ROTATE_BYTES (at least ``min_copies``)."""
    n = max(min_copies, -(-ROTATE_BYTES // nbytes(state)))
    return state[None].repeat(n, *(1,) * state.dim())


def rotated_device_ms(calls, key):
    """Device time a call of the kernels whose names contain ``key``, with the
    L2 cold: ``calls`` (each on its own state, together at least
    ROTATE_BYTES) made in turn, back to back, twice over (20 at least), in one
    ``torch.profiler`` trace (``device_ms``). No call finds its state in the
    L2, and the dirty lines each leaves there are written back inside later
    calls' time, as in a decode step, so the time a call includes all of its
    reads and writes of DRAM."""
    turn = iter(range(10**9))
    return device_ms(lambda: calls[next(turn) % len(calls)](), key, iters=max(20, 2 * len(calls)))


def step_inputs(gen, b, h, h_qk, d, dtype):
    """K2's and K3's inputs as the models give them: q, k (b, h_qk, d) and v
    (b, h, d) views of one fused projection, one element in (a bf16 view
    sits 2 bytes off 4-byte alignment), q and k l2-normalized; beta (b, h)
    from a sigmoid in ``dtype``; alpha (b, h) fp32, a view of (b, 1, h)."""
    import torch

    from llm_quest_tpu_torch.ops.gdn import l2_norm_clamp

    n = h_qk * d
    fused = randn(gen, b, 1 + 2 * n + h * d, dtype=dtype)
    q, k = fused[:, 1:1 + n].view(b, h_qk, d), fused[:, 1 + n:1 + 2 * n].view(b, h_qk, d)
    v = fused[:, 1 + 2 * n:].view(b, h, d)
    q.copy_(l2_norm_clamp(q))
    k.copy_(l2_norm_clamp(k))
    beta = torch.sigmoid(randn(gen, b, h)).to(dtype)
    alpha = torch.sigmoid(randn(gen, b, 1, h, scale=0.3) + 2.0)[:, 0]
    return q, k, v, beta, alpha


def step_timing(call, rotated_calls, plain_call, nbytes_moved, flops):
    """A K2/K3 call's times: ``ms`` (= ``device_ms``) the step kernel's cold
    device time (``rotated_device_ms`` over ``rotated_calls``, the same call
    on distinct states), ``device_ms_warm`` ``call`` launched back to back
    (a state that fits the L2 stays there), ``events_ms`` CUDA events around
    calls back to back, ``host_us`` the wrapper's time to return,
    ``plain_ms`` the plain version by events; and the bound."""
    cold = rotated_device_ms(rotated_calls, K2_KEY)
    return {"ms": cold, "device_ms": cold, "device_ms_warm": device_ms(call, K2_KEY), "events_ms": cuda_ms(call),
            "states_rotated": len(rotated_calls), "host_us": host_us(call), "plain_ms": cuda_ms(plain_call),
            **bound(nbytes_moved, flops)}


def kernel_k2(gen, dtypes):
    """K2 at K2_SHAPES, fp32 and bf16, on the models' inputs (``step_inputs``:
    strided views, bf16 beta in bf16, q/k at their own head count for
    Qwen3-Next) against the plain version: out within TOL (fp32: NEW_TOL),
    the layer's new state within NEW_TOL, every other layer bitwise
    unchanged; timed in bf16 at each shape (``step_timing``), the
    record's line at b 128."""
    import torch

    from llm_quest_tpu_torch.kernels import gdn

    errs, cases = [], []
    for name, n_layers, b, h, h_qk, d, layer in K2_SHAPES:
        for dtype in dtypes:
            q, k, v, beta, alpha = step_inputs(gen, b, h, h_qk, d, dtype)
            stacked = randn(gen, n_layers, b, h, d, d, scale=0.1)
            before = stacked.clone()
            ref_layer = stacked[layer].clone()
            out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer)
            ref_out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, ref_layer[None], 0, plain=True)
            torch_sync()
            if not all(torch.equal(stacked[i], before[i]) for i in range(n_layers) if i != layer):
                raise AssertionError(f"K2 {name} {dtype}: layers other than {layer} changed")
            tol = NEW_TOL if dtype == dtypes[0] else None  # bf16 out rounds once more
            e = max(check(f"K2 out {name} {dtype}", out, ref_out, dtype, tol),
                    check(f"K2 state {name} {dtype}", stacked[layer], ref_layer, torch.float32, NEW_TOL))
            case = {"shape": name, "L": n_layers, "b": b, "h": h, "h_qk": h_qk, "dk": d, "layer": layer,
                    "dtype": str(dtype), "beta_dtype": str(beta.dtype), "max_abs_err": e,
                    "others_bitwise_equal": True}
            del before
            if dtype == dtypes[-1]:
                def call(q=q, k=k, v=v, beta=beta, alpha=alpha, stacked=stacked, layer=layer):
                    return gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer)

                def plain_call(q=q, k=k, v=v, beta=beta, alpha=alpha, ref=ref_layer):
                    return gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, ref[None], 0, plain=True)

                rot = rotation(ref_layer)
                rotated = [lambda i=i, q=q, k=k, v=v, beta=beta, alpha=alpha, rot=rot:
                           gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, rot, i) for i in range(len(rot))]
                # one layer's fp32 state read and written in place, q/k/v/beta/alpha read, out written
                case.update(step_timing(call, rotated, plain_call,
                                        nbytes(q, k, v, beta, alpha, out) + 2 * nbytes(ref_layer), 8 * d * d * b * h))
                del rot, rotated
            cases.append(case)
            if dtype == dtypes[0]:
                errs.append(e)
            del stacked, ref_layer
            torch.cuda.empty_cache()
    rec = next(c for c in cases if c["shape"] == "b128" and "ms" in c)
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "device_ms",
                                       "device_ms_warm", "events_ms", "host_us")}
    extra["library_ms"] = None
    return max(errs), rec["ms"], rec["plain_ms"], cases, extra


def attn_inputs(gen, b, hq, hkv, sq, sk, d, dtype):
    import torch

    q = randn(gen, b, hq, sq, d, dtype=dtype)
    k = randn(gen, b, hkv, sk, d, dtype=dtype)
    v = randn(gen, b, hkv, sk, d, dtype=dtype)
    key_mask = torch.rand(b, sk, generator=gen, device=DEVICE) > 0.2
    key_mask[:, 0] = True  # every causal row sees at least one real key
    return q, k, v, key_mask


def kernel_k4(gen, dtypes):
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        for q_start in (0, 32):
            q, k, v, key_mask = attn_inputs(gen, 2, 8, 2, 300, 364, 256, dtype)
            for mask in (None, key_mask):
                out = attn.flash_attention(q, k, v, attn_mask=mask, q_start=q_start)
                ref = attn.flash_attention(q, k, v, attn_mask=mask, q_start=q_start, plain=True)
                torch_sync()
                e = check(f"K4 q_start={q_start} mask={mask is not None} {dtype}", out, ref, dtype)
                cases.append({"q_start": q_start, "key_mask": mask is not None, "dtype": str(dtype), "max_abs_err": e})
                (errs if dtype == dtypes[0] else errs_bf16).append(e)
    # main-path shape: b=4 prefill of 300 tokens into a 364-column cache
    q, k, v, _ = attn_inputs(gen, 4, 8, 2, 300, 364, 256, dtypes[-1])
    key_mask = torch.zeros(4, 364, dtype=torch.bool, device=DEVICE)
    key_mask[:, :300] = True
    ms = cuda_ms(lambda: attn.flash_attention(q, k, v, attn_mask=key_mask))
    plain_ms = cuda_ms(lambda: attn.flash_attention(q, k, v, attn_mask=key_mask, plain=True))
    # the same function in one library call: keys past 299 are masked by the
    # causal rule already (q_start 0: key j is visible to query i iff j <= i)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
    check("K4 vs sdpa (library)", lib(), attn.flash_attention(q, k, v, attn_mask=key_mask), dtypes[-1])
    pairs = 300 * 301 // 2  # visible (query, key) pairs of a causal 300-row block
    out = attn.flash_attention(q, k, v, attn_mask=key_mask)
    extra = {**bound(nbytes(q, k, v, key_mask, out) + 4 * 8 * 300 * 4, 4 * 256 * pairs * 4 * 8),
             "library_ms": cuda_ms(lib), "max_abs_err_bf16": max(errs_bf16),
             "device_ms": device_ms(lambda: attn.flash_attention(q, k, v, attn_mask=key_mask), TC_KERNELS)}
    return max(errs), ms, plain_ms, cases, extra


CHUNK_K4 = (1, 8, 2, 512, 8320, 256)  # b, hq, hkv, sq, sk, d: one chunk of engine_chunked_prefill's long admission
CHUNK_PROMPT = 8192  # its longest prompt: the keys past it are masked


def kernel_k4_chunked(gen, dtypes):
    """K4 at engine_chunked_prefill's shape: a 512-query chunk at q_start
    c·512 against the 8320-column cache view, keys past the prompt masked.
    Checked at three chunk indices in fp32 and bf16 (bf16 also tile by
    tile); timed at every chunk index (``ms_by_chunk``: the kernel reads
    only the keys up to its last query, so its time should grow with c),
    with the record's times, bound and ``sdpa``'s time at the last chunk."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    b, hq, hkv, sq, sk, d = CHUNK_K4
    starts = list(range(0, CHUNK_PROMPT, sq))
    errs, errs_bf16, tiles, cases = [], [], [], []
    key_mask = (torch.arange(sk, device=DEVICE) < CHUNK_PROMPT)[None].expand(b, sk).contiguous()
    for dtype in dtypes:
        q, k, v, _ = attn_inputs(gen, b, hq, hkv, sq, sk, d, dtype)
        for q_start in (0, starts[len(starts) // 2], starts[-1]):
            out = attn.flash_attention(q, k, v, attn_mask=key_mask, q_start=q_start)
            ref = attn.flash_attention(q, k, v, attn_mask=key_mask, q_start=q_start, plain=True)
            torch_sync()
            e = check(f"K4 chunked q_start={q_start} {dtype}", out, ref, dtype)
            cases.append({"q_start": q_start, "dtype": str(dtype), "max_abs_err": e})
            (errs if dtype == dtypes[0] else errs_bf16).append(e)
            if dtype == torch.bfloat16:
                tiles.append(tile_rel_err(out, ref))
                if not tiles[-1] <= TILE_TOL:
                    raise AssertionError(f"K4 chunked q_start={q_start}: tile error {tiles[-1]} > {TILE_TOL}")
    q_start = starts[-1]
    call = lambda: attn.flash_attention(q, k, v, attn_mask=key_mask, q_start=q_start)  # noqa: E731
    ms_by_chunk = [cuda_ms(lambda qs=qs: attn.flash_attention(q, k, v, attn_mask=key_mask, q_start=qs))
                   for qs in starts]
    plain_ms = cuda_ms(lambda: attn.flash_attention(q, k, v, attn_mask=key_mask, q_start=q_start, plain=True))
    # the same function in one library call: the causal rule at the offset and the key mask as one bool mask
    cols, rows = torch.arange(sk, device=DEVICE), torch.arange(sq, device=DEVICE)
    visible = (cols[None] <= q_start + rows[:, None]) & key_mask[0]
    k_rep, v_rep = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))  # sdpa's masked kernels take no GQA
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q, k_rep, v_rep, attn_mask=visible)  # noqa: E731
    check("K4 chunked vs sdpa (library)", lib(), call(), dtypes[-1])
    pairs = sq * q_start + sq * (sq + 1) // 2  # (query, key) pairs at or before each query
    seen = q_start + sq  # the keys the chunk can see
    moved = 2 * nbytes(q) + nbytes(key_mask[:, :seen]) + 2 * b * hkv * seen * d * q.element_size()  # q, out, mask, k/v
    extra = {**bound(moved, 4 * d * pairs * b * hq), "library_ms": cuda_ms(lib), "max_abs_err_bf16": max(errs_bf16),
             "tile_err_bf16": max(tiles), "device_ms": device_ms(call, TC_KERNELS),
             "record": {"q_starts": starts, "ms_by_chunk": ms_by_chunk, "q_start_timed": q_start}}
    return max(errs), ms_by_chunk[-1], plain_ms, cases, extra


def kernel_k4_bwd(gen, dtypes):
    """dq/dk/dv of the flash kernels against autograd through the plain sdpa."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        for d in (64, 128, 256):
            for hq, hkv in ((16, 8), (8, 2)):
                q, k, v, key_mask = attn_inputs(gen, 2, hq, hkv, 300, 300, d, dtype)
                do = randn(gen, 2, hq, 300, d, dtype=dtype)
                for mask in (None, key_mask):
                    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                    attn.flash_attention(qg, kg, vg, attn_mask=mask).backward(do)
                    refs = attn.flash_attention_bwd(q, k, v, None, None, do, attn_mask=mask, plain=True)
                    torch_sync()
                    e = max(check(f"K4 bwd {name} d={d} {hq}/{hkv} mask={mask is not None} {dtype}", got, ref, dtype)
                            for name, got, ref in zip("qkv", (qg.grad, kg.grad, vg.grad), refs))
                    cases.append({"d": d, "heads": [hq, hkv], "key_mask": mask is not None, "dtype": str(dtype),
                                  "max_abs_err": e})
                    (errs if dtype == dtypes[0] else errs_bf16).append(e)
    # training shape: one layer of bench.py's train step (b = 4) in bf16, the
    # output and dq/dk/dv held to plain, then fwd + bwd timed on the same
    # tensors; the b = 1 layer is timed too
    for b in (4, 1):
        dtype = dtypes[-1]
        q, k, v, _ = attn_inputs(gen, b, 16, 8, 2048, 2048, 128, dtype)
        do = randn(gen, b, 16, 2048, 128, dtype=dtype)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

        def fwd_bwd(plain):
            out = attn.flash_attention(qg, kg, vg, plain=plain)
            return (out.detach(),) + torch.autograd.grad(out, (qg, kg, vg), do)

        case = {"shape": f"q ({b}, 16, 2048, 128), kv ({b}, 8, 2048, 128) {dtype}"}
        if b == 4:
            got, ref = fwd_bwd(False), fwd_bwd(True)
            torch_sync()
            case["max_abs_err"] = {name: check(f"K4 fwd+bwd {name} train shape {dtype}", g, r, dtype)
                                   for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref)}
            case["max_abs_ref"] = {name: max_err(g, r)[1] for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref)}
            errs_bf16.extend(case["max_abs_err"].values())
            names = ("o", "dq", "dk", "dv")
            case["tile_err"] = check_tiles(f"K4 fwd+bwd train shape {dtype}", got, ref, names)
            case["tile_err_dropped_tile"] = dropped_tile(f"K4 fwd+bwd train shape {dtype}", (q, k, v), do, ref,
                                                         names, causal=True)
            tile_errs = list(case["tile_err"].values())
            del got, ref
        case["fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(False), iters=5, warmup=1)
        case["fwd_bwd_device_ms"] = device_ms(lambda: fwd_bwd(False), TC_KERNELS)
        case["plain_fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(True), iters=5, warmup=1)
        # the function's work, 3x the forward's 4·d per visible pair and head:
        # QKᵀ and PV forward, dV, dP, dQ and dK backward (the flash
        # backward's recompute of the scores is the algorithm's, not counted)
        case.update(bound(2 * nbytes(q, k, v, do), 3 * 4 * 128 * (2048 * 2049 // 2) * b * 16))
        if b == 4:
            def lib_fwd_bwd():
                out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
                return torch.autograd.grad(out, (qg, kg, vg), do)

            extra = {key: case[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops")}
            extra["device_ms"] = case["fwd_bwd_device_ms"]
            extra["library_ms"] = cuda_ms(lib_fwd_bwd, iters=5, warmup=1)
        o = attn.flash_attention(q, k, v)
        lse = attn._plain_lse(q, k, None, True, 0, 128**-0.5)
        case["bwd_ms"] = cuda_ms(lambda: attn.flash_attention_bwd(q, k, v, o, lse, do), iters=5, warmup=1)
        if b == 4:  # no atomics: the bf16 backward is the same to the bit run after run
            first, second = (attn.flash_attention_bwd(q, k, v, o, lse, do) for _ in range(2))
            torch_sync()
            if not all(torch.equal(x, y) for x, y in zip(first, second)):
                raise AssertionError("K4 bwd: two bf16 backward runs at the train shape differ")
            case["bwd_bit_equal"] = True
            del first, second
        case["fwd_ms"] = cuda_ms(lambda: attn.flash_attention(q, k, v), iters=5, warmup=1)
        cases.append(case)
        if b == 4:
            ms, plain_ms = case["fwd_bwd_ms"], case["plain_fwd_bwd_ms"]
        del q, k, v, do, qg, kg, vg, o, lse
        torch.cuda.empty_cache()
    extra["max_abs_err_bf16"] = max(errs_bf16)
    extra["tile_err_bf16"] = max(tile_errs)
    return max(errs), ms, plain_ms, cases, extra


# one attention layer of Gemma-3-270M's train step: b 4, q/kv heads 4/1, d 256, s 2048
GEMMA_K4 = {"b": 4, "hq": 4, "hkv": 1, "s": 2048, "d": 256}
GEMMA_WINDOW = 512
# one attention layer of MiMo-V2-Flash small's train step (b 4, s 2048, d 64,
# dv 32): the SWA layers' 12/4 heads (window 128, sinks), the GA layers' 12/2
MIMO_SWA_K4 = {"b": 4, "hq": 12, "hkv": 4, "s": 2048, "d": 64, "dv": 32}
MIMO_GA_K4 = {"b": 4, "hq": 12, "hkv": 2, "s": 2048, "d": 64, "dv": 32}
MIMO_WINDOW = 128
# one attention layer of DeepSeek-V3 small's train step: MLA's 12 heads (as
# many kv heads), q/k 96 (latent-up 64 and decoupled RoPE 32), v 64, causal
DSV3_K4 = {"b": 4, "hq": 12, "hkv": 12, "s": 2048, "d": 96, "dv": 64}


def visible_pairs(s, window=None):
    """(query, key) pairs a causal (optionally windowed) s-row block sees."""
    w = min(window or s, s)
    return w * (w + 1) // 2 + (s - w) * w


def k4_case(gen, dtypes, *, shape=GEMMA_K4, window=None, softcap=None, sink=False, backward=False):
    """K4 at ``shape`` (v's head dim ``dv``, default d) with the given
    features against its plain version in each dtype (the output, and with
    ``backward`` dq/dk/dv and dsink through autograd), then the kernel, the
    plain version and (without softcap or sinks) ``F.scaled_dot_product_attention``
    on the dense mask timed in bf16."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    b, hq, hkv, s, d = (shape[key] for key in ("b", "hq", "hkv", "s", "d"))
    dv = shape.get("dv", d)
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        # a softcap of 30 bends scores only where they reach its scale
        q = randn(gen, b, hq, s, d, dtype=dtype, scale=20.0 if softcap else 1.0)
        k, v = randn(gen, b, hkv, s, d, dtype=dtype), randn(gen, b, hkv, s, dv, dtype=dtype)
        do = randn(gen, b, hq, s, dv, dtype=dtype)
        # sinks near the rows' logsumexp, so their share and dsink are not negligible
        sk = randn(gen, hq, scale=0.5) + 5.0 if sink else None
        kw = {"window_size": window, "softcap": softcap}
        leaves = [t.clone().requires_grad_(backward) for t in (q, k, v) + ((sk,) if sink else ())]

        def run(plain, leaves=leaves, kw=kw, do=do):
            out = attn.flash_attention(*leaves[:3], sink=leaves[3] if sink else None, plain=plain, **kw)
            if not backward:
                return (out,)
            return (out.detach(),) + torch.autograd.grad(out, leaves, do)

        names = ("o", "dq", "dk", "dv", "dsink")[: (4 + sink) if backward else 1]
        got, ref = run(False), run(True)
        torch_sync()
        label = f"K4 {shape} window={window} softcap={softcap} sink={sink} bwd={backward} {dtype}"
        err = {n: check(f"{label} {n}", g, r, dtype) for n, g, r in zip(names, got, ref)}
        case = {"dtype": str(dtype), "max_abs_err": err, "max_abs_ref": {n: max_err(g, r)[1]
                                                                        for n, g, r in zip(names, got, ref)}}
        del got, ref
        # the record's error is the fp32 (SIMT) one, as for the other kernels; bf16 runs on the tensor cores
        (errs if dtype == dtypes[0] else errs_bf16).append(max(err.values()))
        if dtype == dtypes[-1]:
            iters = (5, 1) if backward else (10, 2)
            case["ms"] = cuda_ms(lambda: run(False), *iters)
            case["plain_ms"] = cuda_ms(lambda: run(True), *iters)
            # the kernels' own device time (CUDA events also count the card
            # waiting on the host between the wrapper's launches)
            case["device_ms"] = device_ms(lambda: run(False), TC_KERNELS)
            pairs = visible_pairs(s, window)
            # forward 2·(d + dv) FLOPs per visible pair and head (QKᵀ, PV);
            # backward 2× that (dV and dP over dv, dQ and dK over d)
            flops = (3 if backward else 1) * 2 * (d + dv) * pairs * b * hq
            # do stands for o (both (b, hq, s, dv)); the fp32 lse
            n_bytes = 2 * nbytes(q, k, v, do) if backward else nbytes(q, k, v, do) + 4 * b * hq * s
            case.update(bound(n_bytes, flops, "bfloat16"))
            case["library_ms"] = None
            if softcap is None and not sink:
                sdpa = torch.nn.functional.scaled_dot_product_attention
                allowed = None
                if window is not None:
                    pos = torch.arange(s, device=DEVICE)
                    allowed = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

                def lib():
                    lq, lk, lv = leaves[:3]
                    if allowed is None:
                        out = sdpa(lq, lk, lv, is_causal=True, enable_gqa=True)
                    else:
                        out = sdpa(lq, lk, lv, attn_mask=allowed, enable_gqa=True)
                    return torch.autograd.grad(out, leaves[:3], do) if backward else out

                if not backward:
                    check(f"{label} vs sdpa (library)", lib(), attn.flash_attention(q, k, v, **kw), dtype)
                case["library_ms"] = cuda_ms(lib, *iters)
        cases.append(case)
        del q, k, v, do, leaves
        torch.cuda.empty_cache()
    rec = cases[-1]
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "library_ms",
                                       "device_ms")}
    extra["shape"] = {**shape, "window": window, "softcap": softcap, "sink": sink, "backward": backward}
    extra["max_abs_err_bf16"] = max(errs_bf16)
    return max(errs), rec["ms"], rec["plain_ms"], cases, extra


# ViT-B/224's encode (bench.py:297): b 128, s 197 (196 patches + CLS), 12 heads of 64
VIT_B = (128, 197, 12, 64)
# TinyViT's heads (TINY_VIT_CONFIG: 256 = 8 x 32) at s 65 (64 patches + CLS), b 128
VIT_D32 = (128, 65, 8, 32)


def packed_inputs(gen, shape, dtype):
    b, s, h, d = shape
    return tuple(randn(gen, b, s, h * d, dtype=dtype) for _ in range(3))


def packed_flops(shape):
    """QKᵀ or PV of every (image, head): 2·s²·d each."""
    b, s, h, d = shape
    return 2 * b * h * s * s * d


def split_view(t, h):
    """The (b, h, s, d) view of a packed (b, s, h·d) tensor, for the library call."""
    b, s, hd = t.shape
    return t.view(b, s, h, hd // h).transpose(1, 2)


def short_check(label, got, ref, names, dtype, s, tol=None):
    """The short-sequence kernels' (K6, K7) results ``names`` against plain:
    each within ``tol`` (default TOL of the dtype) and, in bf16 at s >= 128,
    tile by tile (TILE_TOL, the lse within LSE_TOL); in bf16 the plain
    version runs in fp32 on the same values (in bf16 it rounds p before p·V
    and its gradients lose the cancellation in dP - delta). Returns (max
    error, the tile readings or None)."""
    err = max(check(f"{label} {n}", g, r, dtype, tol) for n, g, r in zip(names, got, ref))
    tiles = None
    if str(dtype) == "torch.bfloat16" and s >= 128:
        tiles = check_tiles(label, [t if t.dim() == 4 or n == "lse" else t.unflatten(-1, (-1, 64)).transpose(1, 2)
                                    for n, t in zip(names, got)],
                            [t if t.dim() == 4 or n == "lse" else t.unflatten(-1, (-1, 64)).transpose(1, 2)
                             for n, t in zip(names, ref)], names)
    return err, tiles


def tc_moved(label, counter, before, n):
    """A bf16 call's launches took the tensor-core kernels: ``counter``'s
    count (``tc_launches`` or ``tc_bwd_launches``) moved by ``n``."""
    if counter - before != n:
        raise AssertionError(f"{label}: {counter - before} tensor-core launches, expected {n}")


def kernel_k7(gen, dtypes, shape=VIT_B):
    """K7 at ``shape`` (ViT-B's encode, or TinyViT's d 32), fp32 (the SIMT
    flash forward) and bf16 (the short-sequence tensor-core kernel) against
    plain, with the row lse its forward keeps for the backward; timed in
    bf16 beside ``sdpa`` on the split-head view and, at d 64, beside K4's
    tensor-core forward at the same packed strides (the kernel K7's bf16
    forward borrowed before)."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    b, s, h, d = shape
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        q, k, v = packed_inputs(gen, shape, dtype)
        tc = attn.packed_mha.tc_launches
        out = attn.packed_mha(q, k, v, h)
        out_lse, lse = attn._packed_fwd(q, k, v, h, d**-0.5, with_lse=True)
        bf16 = dtype == dtypes[-1]
        tc_moved(f"K7 {shape}", attn.packed_mha.tc_launches, tc, 2 if bf16 else 0)
        ref = attn.packed_mha(*(t.float() for t in (q, k, v)), h, plain=True)
        torch_sync()
        e, tiles = short_check(f"K7 {shape} {dtype}", (out, out_lse), (ref, ref), ("o", "o_lse"), dtype, s)
        lse_err = check(f"K7 {shape} lse {dtype}", lse, attn.packed_mha_lse_plain(q, k, h), torch.float32,
                        LSE_TOL if bf16 else NEW_TOL)
        cases.append({"b": b, "s": s, "heads": h, "d": d, "dtype": str(dtype), "max_abs_err": e, "lse_err": lse_err,
                      "tile_err": tiles})
        (errs_bf16 if bf16 else errs).append(e)
    ms = cuda_ms(lambda: attn.packed_mha(q, k, v, h), iters=200, warmup=10)
    plain_ms = cuda_ms(lambda: attn.packed_mha(q, k, v, h, plain=True), iters=5, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(split_view(q, h), split_view(k, h), split_view(v, h))  # noqa: E731
    check("K7 vs sdpa (library)", lib().transpose(1, 2).reshape(b, s, -1), attn.packed_mha(q, k, v, h), dtypes[-1])
    extra = {**bound(4 * nbytes(q), 2 * packed_flops(shape)), "library_ms": cuda_ms(lib, iters=200, warmup=10),
             "shape": list(shape), "max_abs_err_bf16": max(errs_bf16),
             "device_ms": device_ms(lambda: attn.packed_mha(q, k, v, h), TC_KEY)}
    if (d, d) in attn.HEAD_DIMS:
        heads = [split_view(t, h) for t in (q, k, v)]
        k4 = lambda: attn._flash_fwd(*heads, None, None, False, 0, d**-0.5, None, None, False)  # noqa: E731
        check("K7 vs K4's tensor-core forward", k4()[0].transpose(1, 2).reshape(b, s, -1), attn.packed_mha(q, k, v, h),
              dtypes[-1])
        extra["k4_tc_fwd_ms"] = cuda_ms(k4, iters=200, warmup=10)
    return max(errs), ms, plain_ms, cases, extra


def kernel_k7_bwd(gen, dtypes, shape=VIT_B):
    """K7 forward + backward (the flash recompute kernels fed K7's lse,
    gradients written in the packed layout) against autograd of the plain
    version: fp32 and bf16 at b 16 and at the full b of ``shape``, held
    tile by tile in bf16, then forward + backward timed at the full b in
    bf16, beside ``sdpa`` and its backward."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    errs, errs_bf16, cases = [], [], []
    tiles_bf16 = []
    for dtype in dtypes:
        bf16 = dtype == dtypes[-1]
        for b in (16, shape[0]):
            cur = (b, *shape[1:])
            h, s = cur[2], cur[1]
            q, k, v = packed_inputs(gen, cur, dtype)
            do = randn(gen, *q.shape, dtype=dtype)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]

            def fwd_bwd(plain=False, leaves=leaves, do=do, h=h):
                out = attn.packed_mha(*leaves, h, plain=plain)
                return (out.detach(),) + torch.autograd.grad(out, leaves, do)

            tc, tc_bwd = attn.packed_mha.tc_launches, attn.packed_mha.tc_bwd_launches
            got = fwd_bwd()
            tc_moved(f"K7 fwd {cur}", attn.packed_mha.tc_launches, tc, 1 if bf16 else 0)
            tc_moved(f"K7 bwd {cur}", attn.packed_mha.tc_bwd_launches, tc_bwd, 1 if bf16 else 0)
            ref_leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
            ref = fwd_bwd(True, ref_leaves, do.float())
            torch_sync()
            e, tiles = short_check(f"K7 fwd+bwd b={b} {dtype}", got, ref, ("o", "dq", "dk", "dv"), dtype, s)
            cases.append({"b": b, "dtype": str(dtype), "max_abs_err": e, "tile_err": tiles})
            (errs_bf16 if bf16 else errs).append(e)
            if tiles:
                tiles_bf16.extend(tiles.values())
            del got, ref, ref_leaves
    ms = cuda_ms(fwd_bwd, iters=50, warmup=5)
    plain_ms = cuda_ms(lambda: fwd_bwd(True), iters=5, warmup=1)

    def lib():
        out = torch.nn.functional.scaled_dot_product_attention(*(split_view(t, h) for t in leaves))
        return torch.autograd.grad(out, leaves, split_view(do, h))

    # forward and backward: the inputs and do read, out and dq/dk/dv written;
    # 3x the forward's products (QKᵀ, PV; dV, dP, dQ, dK)
    extra = {**bound(2 * nbytes(q, k, v, do), 3 * 2 * packed_flops(cur)), "library_ms": cuda_ms(lib, 50, 5),
             "max_abs_err_bf16": max(errs_bf16), "shape": list(cur),
             "device_ms": device_ms(fwd_bwd, TC_KEY),
             "plain_bwd_ms": cuda_ms(lambda: attn.packed_mha_bwd_plain(q, k, v, do, h), iters=5, warmup=1)}
    if tiles_bf16:
        extra["tile_err_bf16"] = max(tiles_bf16)
    del q, k, v, do, leaves
    torch.cuda.empty_cache()
    return max(errs), ms, plain_ms, cases, extra


INT8_TC_KEY = "packed_mha_int8_tc_"  # the name stem of K8/K9's bf16 tensor-core kernel (csrc/packed_mha_int8_tc.cu)


def int8_static_scales(q, k):
    return float(q.float().abs().max()) / 127.0, float(k.float().abs().max()) / 127.0


def int8_dropped(q, k, v, h, ss, drop):
    """The plain int8-score attention with the keys ``drop`` left out (q and
    k quantized at the scales of all keys, as the kernel's): a fault the
    tile bar must catch."""
    import torch

    from llm_quest_tpu_torch.kernels import fused_mha as fm

    scale = (q.shape[-1] // h) ** -0.5
    if ss is None:
        (qi, qs), (ki, ks) = fm.quantize_sym(q), fm.quantize_sym(k)
        dq = qs * ks * scale
    else:
        qi, ki = fm.quantize_static(q, ss[0]), fm.quantize_static(k, ss[1])
        dq = fm._f32(ss[0] * ss[1] * scale)
    keep = torch.ones(k.shape[1], dtype=torch.bool, device=k.device)
    keep[drop] = False
    return fm._scores_attention(qi, ki[:, keep], v[:, keep], h, dq, q.dtype)


def kernel_int8(gen, dtypes, mode):
    """K8 (``mode`` "dynamic" or "static") or K9 ("inkernel") at ViT-B's
    encode shape, fp32 (the SIMT kernel) and bf16 (the tensor-core kernel,
    ``tc_launches``) against plain; in bf16 also each 64-row tile of each
    head (TILE_TOL) beside the plain version with the 64 keys [s - 128,
    s - 64) dropped, which must read above the bar. Two runs bit-equal, and
    K9 equal to K8 with the same static scales, bit for bit. Timed in bf16
    (CUDA events; ``device_ms`` the tensor-core kernel's profiler time, K8
    dynamic's scale reductions apart, ``call_device_ms`` all of the call's
    device work) beside bf16 ``sdpa`` (no PyTorch call computes int8-score
    attention: library_ms is null)."""
    import torch

    from llm_quest_tpu_torch.kernels import fused_mha as fm

    b, s, h, d = VIT_B
    errs, errs_bf16, cases = [], [], []
    extra = {}
    for dtype in dtypes:
        bf16 = dtype == dtypes[-1]
        q, k, v = packed_inputs(gen, VIT_B, dtype)
        ss = None if mode == "dynamic" else int8_static_scales(q, k)
        if mode == "inkernel":
            w = fm.packed_mha_int8_inkernel
            call = lambda plain=False: w(q, k, v, h, ss, plain=plain)  # noqa: E731
        else:
            w = fm.packed_mha_int8
            call = lambda plain=False: w(q, k, v, h, static_scales=ss, plain=plain)  # noqa: E731
        out, tc = tc_count(w, call)
        ref = call(True)
        torch_sync()
        tc_moved(f"K8/K9 {mode} {dtype}", tc, 0, 1 if bf16 else 0)
        case = {"b": b, "s": s, "heads": h, "d": d, "dtype": str(dtype), "static_scales": ss, "tc_launches": tc,
                "max_abs_err": check(f"K8/K9 {mode} {dtype}", out, ref, dtype)}
        if not torch.equal(out, call()):
            raise AssertionError(f"K8/K9 {mode} {dtype}: two runs differ")
        if mode == "inkernel":
            if not torch.equal(out, fm.packed_mha_int8(q, k, v, h, static_scales=ss)):
                raise AssertionError(f"K9 differs from K8 with the same static scales ({dtype})")
            case["equal_to_k8_static"] = True
        if bf16:
            heads = lambda t: split_view(t, h)  # noqa: E731
            case["tile_err"] = check_tiles(f"K8/K9 {mode} tiles", [heads(out)], [heads(ref)], ("o",))["o"]
            dropped = tile_readings([heads(int8_dropped(q, k, v, h, ss, slice(s - 128, s - 64)))], [heads(ref)],
                                    ("o",))["o"]
            if not dropped > TILE_TOL:
                raise AssertionError(f"K8/K9 {mode}: a dropped key piece reads {dropped}, within {TILE_TOL}")
            case["dropped_piece_tile_err"] = dropped
            extra["tile_err_bf16"] = case["tile_err"]
        cases.append(case)
        (errs_bf16 if bf16 else errs).append(case["max_abs_err"])
    ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: call(True), iters=5, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    extra.update({**bound_int8(4 * nbytes(q), packed_flops(VIT_B), packed_flops(VIT_B)), "library_ms": None,
                  "bf16_sdpa_ms": cuda_ms(lambda: sdpa(split_view(q, h), split_view(k, h), split_view(v, h))),
                  "shape": list(VIT_B), "max_abs_err_bf16": max(errs_bf16),
                  "device_ms": device_ms(call, INT8_TC_KEY),
                  "record": {"call_device_ms": device_ms(call, "")}})
    return max(errs), ms, plain_ms, cases, extra


def int8_vs_bf16_scores(card):
    """Whether int8 scores speed up the attention core on this card: K9 (q
    and k quantized in the kernel, s8 ``wgmma`` scores) beside K7's bf16
    forward (bf16 ``wgmma`` scores) on the same bf16 inputs at ViT-B's
    encode shape, which read and write the same bytes: CUDA events over 200
    launches in turns (K7, K9, K9, K7) and each kernel's profiler time."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn
    from llm_quest_tpu_torch.kernels import fused_mha as fm

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    b, s, h, d = VIT_B
    q, k, v = packed_inputs(gen, VIT_B, torch.bfloat16)
    ss = int8_static_scales(q, k)
    calls = {"k7_bf16": (lambda: attn.packed_mha(q, k, v, h), "fused_mha_tc_"),
             "k9_int8": (lambda: fm.packed_mha_int8_inkernel(q, k, v, h, ss), INT8_TC_KEY)}
    ms = {name: [] for name in calls}
    for name in ("k7_bf16", "k9_int8", "k9_int8", "k7_bf16"):
        ms[name].append(cuda_ms(calls[name][0], iters=200, warmup=10))
    dev = {name: device_ms(fn, key) for name, (fn, key) in calls.items()}
    emit({"phase": "int8_vs_bf16_scores", "card": card, "shape": list(VIT_B), "ms": ms, "device_ms": dev,
          "k9_over_k7_device": dev["k9_int8"] / dev["k7_bf16"],
          "k9_over_k7_ms": statistics.mean(ms["k9_int8"]) / statistics.mean(ms["k7_bf16"]),
          "bound_ms": bound(4 * nbytes(q), 2 * packed_flops(VIT_B))["bound_ms"]})
    del q, k, v
    torch.cuda.empty_cache()


def int8_cache_inputs(gen, b, hq, hkv, s_len, d, dtype):
    """q and one layer of the int8 KV cache as the model writes it (views of
    a (2, b, hkv, S, d) buffer), and a random key mask as the bias."""
    import torch

    from llm_quest_tpu_torch.inference import cache as kv_cache
    from llm_quest_tpu_torch.ops.masks import mask_value

    cache = kv_cache.init_kv_cache(2, b, hkv, s_len, d, quant="int8", device=DEVICE)
    _, k, v = kv_cache.write_layer(cache, 1, randn(gen, b, hkv, s_len, d, dtype=dtype),
                                   randn(gen, b, hkv, s_len, d, dtype=dtype), 0)
    valid = torch.rand(b, s_len, generator=gen, device=DEVICE) > 0.1
    valid[:, 0] = True
    bias = torch.where(valid, 0.0, mask_value(torch.float32)).float()
    return randn(gen, b, hq, 1, d, dtype=dtype), k, v, bias


# K10's shapes: (b, q heads, kv heads, S, d)
K10_SHAPES = {"decode": (1, 8, 2, 96, 256), "long": (16, 8, 2, 8192, 256), "long_b1": (1, 8, 2, 8192, 256),
              "qwen3": (4, 16, 8, 300, 128)}
# K10's bar on each (batch, q head) output row, ||kernel - plain|| / ||plain||:
# fp32 sums in another order; bf16 rounds p·v_s (relative to each warp's
# running max, where the plain version rounds it relative to the row's) and
# the output
K10_ROW_TOL = {"float32": NEW_TOL, "bfloat16": TILE_TOL}


def k10_rows(got, ref):
    """The largest ||got - ref|| / ||ref|| over the (batch, q head) output rows."""
    g, r = got.float().flatten(0, 2), ref.float().flatten(0, 2)
    return float(((g - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)).max())


def host_us(fn, iters=50):
    """µs a call takes to return (its launch work), over ``iters`` calls that are not waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / iters


def kernel_k10(gen, dtypes):
    """K10 at the int8 generation path's decode shape (b 1, 8/2 heads, d 256,
    S 96: 32 prompt + 64 generated), at a long context (b 16 and b 1, S
    8192) and at Qwen3's head dim 128 (b 4, 16/8 heads, S 300), on the int8
    cache's strided layer views. fp32 q on the SIMT kernel, bf16 q on the
    tensor-core kernel (``tc_launches``) at the wrapper's split: within TOL,
    each (batch, q head) row within K10_ROW_TOL beside a control that masks
    one 64-key tile out of the plain version, which must read beyond it, two
    runs bit-equal; bf16 timed by CUDA events and profiler beside its bound
    and the host's µs a call. Then ``split_sweep``: the tensor-core kernel at
    every cluster size around the wrapper's plan."""
    import torch

    from llm_quest_tpu_torch.kernels import flash_decode as fd
    from llm_quest_tpu_torch.ops.masks import mask_value

    w = fd.flash_decode
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        bf16 = dtype == torch.bfloat16
        row_tol = K10_ROW_TOL[str(dtype).removeprefix("torch.")]
        for name, (b, hq, hkv, s_len, d) in K10_SHAPES.items():
            q, k, v, bias = int8_cache_inputs(gen, b, hq, hkv, s_len, d, dtype)
            def call(plain=False, bias=bias, q=q, k=k, v=v):
                return w(q, k.data, k.scale, v.data, v.scale, bias, plain=plain)

            out, tc = tc_count(w, call)
            ref = call(True)
            torch_sync()
            tc_moved(f"K10 {name} {dtype}", tc, 0, int(bf16))
            e = check(f"K10 {name} {dtype}", out, ref, dtype)
            rows = k10_rows(out, ref)
            if not rows <= row_tol:  # also catches NaN
                raise AssertionError(f"K10 {name} {dtype}: row error {rows} > {row_tol}")
            tile = -(-s_len // fd.TILE) // 2  # the middle 64-key tile, masked out of the plain version
            bias_drop = bias.clone()
            bias_drop[:, tile * fd.TILE:(tile + 1) * fd.TILE] = mask_value(torch.float32)
            dropped = k10_rows(out, call(True, bias_drop))
            if not dropped > row_tol:
                raise AssertionError(f"K10 {name} {dtype}: a masked key tile reads {dropped}, within {row_tol}")
            if not torch.equal(out, call()):
                raise AssertionError(f"K10 {name} {dtype}: two runs differ")
            case = {"shape": name, "b": b, "heads": [hq, hkv], "S": s_len, "d": d, "dtype": str(dtype),
                    "max_abs_err": e, "row_err": rows, "dropped_tile_row_err": dropped, "tc_launches": tc}
            if bf16:
                case.update(split=fd.plan(b, hkv, s_len, sms), ms=cuda_ms(call), plain_ms=cuda_ms(lambda: call(True)),
                            device_ms=device_ms(call, "flash_decode"), host_us=host_us(call))
                # int8 K/V, their scales, the bias and q read once, the output written once
                case.update(bound(nbytes(q, k.data, k.scale, v.data, v.scale, bias, out), 4 * b * hq * s_len * d))
                case["share_of_bound"] = case["bound_ms"] / case["device_ms"]
                errs_bf16.append(e)
            else:
                errs.append(e)
            cases.append(case)
            del q, k, v, bias, bias_drop, out, ref
    torch.cuda.empty_cache()
    rec = next(c for c in cases if c["shape"] == "decode" and "ms" in c)
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "device_ms")}
    extra.update({"library_ms": None, "max_abs_err_bf16": max(errs_bf16),
                  "tile_err_bf16": max(c["row_err"] for c in cases if "ms" in c),
                  "split_sweep": k10_split_sweep(gen),
                  "record": {"cases_device_ms": {c["shape"]: c["device_ms"] for c in cases if "ms" in c},
                             "cases_share_of_bound": {c["shape"]: c["share_of_bound"] for c in cases if "ms" in c},
                             "cases_host_us": {c["shape"]: c["host_us"] for c in cases if "ms" in c}}})
    return max(errs), rec["ms"], rec["plain_ms"], cases, extra


def k10_split_sweep(gen):
    """The tensor-core kernel's device ms at b 1 and 16 (8/2 heads, d 256)
    and S 96 and 8192 with each (batch, kv head)'s keys split over 1 to 16
    blocks of a cluster, beside the wrapper's plan; each checked against plain."""
    import torch

    from llm_quest_tpu_torch.kernels import flash_decode as fd

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sweep = []
    for b in (1, 16):
        for s_len in (96, 8192):
            q, k, v, bias = int8_cache_inputs(gen, b, 8, 2, s_len, 256, torch.bfloat16)
            args = (q, k.data, k.scale, v.data, v.scale, bias)
            ref = fd.flash_decode(*args, plain=True)
            times = {}
            for split in (1, 2, 4, 8, 16):
                fn = lambda split=split: fd._launch(*args, 256**-0.5, split=split)  # noqa: E731
                check(f"K10 sweep b={b} S={s_len} split {split}", fn(), ref, torch.bfloat16)
                times[split] = device_ms(fn, "flash_decode")
            sweep.append({"b": b, "S": s_len, "plan": fd.plan(b, 2, s_len, sms), "device_ms": times})
    return sweep


K11_EXPERTS = 8  # Qwen3-Next-small's experts; lin1 and gate 896 -> 3584, lin2 3584 -> 896
K11_MATS = {"lin1": (896, 3584), "lin2": (3584, 896)}


def k11_routing(gen, tokens, e=K11_EXPERTS, top_k=2):
    """The group sizes (int64, on the card) of a top-``top_k`` routing of ``tokens`` tokens by random logits."""
    import torch

    logits = torch.randn(tokens, e, generator=gen, device=DEVICE)
    return torch.bincount(logits.topk(top_k, dim=-1).indices.reshape(-1), minlength=e)


def k11_stack(gen, k_dim, n_dim, e=K11_EXPERTS):
    import torch

    w_q = torch.randint(-127, 128, (e, k_dim, n_dim), generator=gen, device=DEVICE, dtype=torch.int8)
    return w_q, torch.rand(e, n_dim, generator=gen, device=DEVICE) * 0.02 + 1e-3


def k11_tiles(got, ref, group_sizes):
    """TILE_TOL's reading of K11's output: max over the (expert, 64-channel)
    tiles of ||got - ref|| / ||ref||, each expert's rows one tile's rows."""
    readings = []
    for rows_g, ref_g in zip(got.float().split(group_sizes.tolist()), ref.float().split(group_sizes.tolist())):
        if rows_g.shape[0]:
            readings.append(tile_rel_err(rows_g.T, ref_g.T))  # the channels on dim -2, 64 a tile
    return max(readings)


def k11_grouped_mm_ms(x, w_q, scale, group_sizes):
    """The time of ``torch._grouped_mm`` on a bf16 copy of the stack (made
    outside the timed region) times each row's scale, and its error against
    K11's plain version; (None, None) where this torch lacks the call."""
    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    if not hasattr(torch, "_grouped_mm"):
        return None, None
    wb = w_q.to(torch.bfloat16)
    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
    scale_rows = scale.repeat_interleave(group_sizes, dim=0, output_size=x.shape[0]).to(torch.bfloat16)
    try:
        out = torch._grouped_mm(x, wb, offs=offs) * scale_rows
    except (RuntimeError, TypeError) as e:
        print(f"K11: torch._grouped_mm refused ({e})", file=sys.stderr)
        return None, None
    err = max_err(out, qg.quantized_ragged_dot(x, w_q, scale, group_sizes, plain=True))[0]
    return cuda_ms(lambda: torch._grouped_mm(x, wb, offs=offs) * scale_rows), err


# widths the tensor-core kernel's TMA cannot address (K, N): bf16 rows with
# K % 8 != 0, stacks with N % 16 != 0; K11's SIMT kernel takes them
K11_TAILS = ((36, 40), (64, 40), (36, 64))


def k11_tail_widths():
    """K11 with bf16 rows (a top-2 routing of 10 tokens) at K11_TAILS: each
    call one launch of the SIMT kernel and none of the tensor-core kernel,
    within the bf16 tolerance of the plain version. {"KxN": max abs err}.
    Its inputs come from a generator of their own, so the records after K11
    keep theirs."""
    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    w = qg.quantized_ragged_dot
    group_sizes = k11_routing(gen, 10)
    errs = {}
    for k_dim, n_dim in K11_TAILS:
        w_q, scale = k11_stack(gen, k_dim, n_dim)
        x = randn(gen, 20, k_dim, dtype=torch.bfloat16)
        n = w.launches
        out, tc = tc_count(w, lambda: w(x, w_q, scale, group_sizes))
        torch_sync()
        if w.launches - n != 1:
            raise AssertionError(f"K11 bf16 K {k_dim} N {n_dim}: {w.launches - n} launches, expected 1")
        tc_moved(f"K11 bf16 K {k_dim} N {n_dim} (the SIMT kernel)", tc, 0, 0)
        errs[f"{k_dim}x{n_dim}"] = check(f"K11 bf16 K {k_dim} N {n_dim}", out,
                                         w(x, w_q, scale, group_sizes, plain=True), torch.bfloat16)
    return errs


def kernel_k11(gen, dtypes):
    """K11 at Qwen3-Next-small's shapes (8 experts, 896 -> 3584 for lin1 and
    gate, 3584 -> 896 for lin2) with a top-2 routing of b 4 tokens (decode,
    T = 8 rows) and of b 4 x 300 tokens (prefill, T = 2400 rows). fp32 rows
    on the SIMT kernel (both row tilings checked), bf16 rows on the
    tensor-core kernel (``tc_launches``) at the wrapper's row tile and K
    split: two runs bit-equal, each (expert, 64-channel) tile within TILE_TOL
    of the fp32 plain version beside a control with one 64-deep K chunk of
    the largest expert dropped, which must read above the bar; timed by CUDA
    events and profiler, beside ``torch._grouped_mm`` on a bf16 copy of the
    stack (``bf16_grouped_mm_ms``; no PyTorch call takes the int8 stack:
    library_ms is null). bf16 rows at widths the tensor-core kernel's TMA
    cannot address take the SIMT kernel (``k11_tail_widths``)."""
    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    w = qg.quantized_ragged_dot
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, errs_bf16, cases = [], [], []
    for tokens in (4, 1200):
        group_sizes = k11_routing(gen, tokens)
        t = 2 * tokens
        for mat, (k_dim, n_dim) in K11_MATS.items():
            w_q, scale = k11_stack(gen, k_dim, n_dim)
            for dtype in dtypes:
                bf16 = dtype == torch.bfloat16
                x = randn(gen, t, k_dim, dtype=dtype)
                call = lambda plain=False: w(x, w_q, scale, group_sizes, plain=plain)  # noqa: E731
                out, tc = tc_count(w, call)
                ref = call(True)
                torch_sync()
                tc_moved(f"K11 T={t} {mat} {dtype}", tc, 0, 1 if bf16 else 0)
                err = check(f"K11 T={t} {mat} {dtype}", out, ref, dtype)
                case = {"T": t, "matrix": mat, "K": k_dim, "N": n_dim, "group_sizes": group_sizes.tolist(),
                        "dtype": str(dtype), "tc_launches": tc}
                if not bf16:  # the SIMT kernel's two row tilings (16 and 64 rows a tile)
                    for rm in (1, 4):
                        err = max(err, check(f"K11 T={t} {mat} {16 * rm}-row tiles {dtype}",
                                             qg._launch(x, w_q, scale, group_sizes, rows_per_thread=rm), ref, dtype))
                    case["max_abs_err"] = err
                    errs.append(err)
                    cases.append(case)
                    continue
                if not torch.equal(out, call()):
                    raise AssertionError(f"K11 T={t} {mat}: two runs differ")
                ref32 = qg.quantized_ragged_dot(x.float(), w_q, scale, group_sizes, plain=True)
                tile_err = k11_tiles(out, ref32, group_sizes)
                if not tile_err <= TILE_TOL:  # also catches NaN
                    raise AssertionError(f"K11 T={t} {mat}: tile error {tile_err} > {TILE_TOL}")
                big = int(group_sizes.argmax())
                w_drop = w_q.clone()
                w_drop[big, 64:128] = 0  # one 64-deep K chunk of the largest expert
                dropped = k11_tiles(qg.quantized_ragged_dot(x.float(), w_drop, scale, group_sizes, plain=True), ref32,
                                    group_sizes)
                if not dropped > TILE_TOL:
                    raise AssertionError(f"K11 T={t} {mat}: a dropped K chunk reads {dropped}, within {TILE_TOL}")
                rows, split = qg.plan(t, k_dim, n_dim, K11_EXPERTS, sms)
                hit = int((group_sizes > 0).sum())  # the weights of the experts with rows are read
                gmm_ms, gmm_err = k11_grouped_mm_ms(x, w_q, scale, group_sizes)
                case.update({"max_abs_err": err, "rows": rows, "split": split, "tile_err": tile_err,
                             "dropped_chunk_tile_err": dropped, "ms": cuda_ms(call),
                             "plain_ms": cuda_ms(lambda: call(True)), "device_ms": device_ms(call, "quantized_gmm"),
                             "bf16_grouped_mm_ms": gmm_ms, "bf16_grouped_mm_err": gmm_err,
                             **bound(nbytes(x, out, group_sizes) + hit * (k_dim * n_dim + 4 * n_dim),
                                     2 * t * k_dim * n_dim)})
                errs_bf16.append(err)
                cases.append(case)
    rec = next(c for c in cases if c["T"] == 8 and c["matrix"] == "lin1" and "ms" in c)
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "device_ms",
                                       "bf16_grouped_mm_ms")}
    extra.update({"library_ms": None, "max_abs_err_bf16": max(errs_bf16),
                  "tile_err_bf16": max(c["tile_err"] for c in cases if "tile_err" in c),
                  "tiling_sweep": k11_tiling_sweep(gen), "tail_widths_err_bf16": k11_tail_widths(),
                  "record": {"cases_device_ms": {f"T{c['T']}_{c['matrix']}": c["device_ms"]
                                                 for c in cases if "device_ms" in c}}})
    return max(errs), rec["ms"], rec["plain_ms"], cases, extra


def k11_tiling_sweep(gen):
    """K11's regimes between decode and prefill (8 experts, top-2 routing):
    in bf16 the tensor-core kernel's device ms at the wrapper's (row tile,
    K split) and beside it with half and twice the row tile and with 1, 2
    and 3 K parts; in fp32 (T 32 to 512) the SIMT kernel's 16- and 64-row
    tilings, between which the wrapper switches at ``qg._FEW_ROWS`` rows.
    Each tiling checked against plain."""
    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sweep = []
    for t in (8, 32, 64, 128, 256, 512, 1024, 2400):
        group_sizes = k11_routing(gen, t // 2)
        row = {"T": t, "max_group": int(group_sizes.max())}
        for mat, (k_dim, n_dim) in K11_MATS.items():
            w_q, scale = k11_stack(gen, k_dim, n_dim)
            x = randn(gen, t, k_dim, dtype=torch.bfloat16)
            ref = qg.quantized_ragged_dot(x, w_q, scale, group_sizes, plain=True)
            rows, split = qg.plan(t, k_dim, n_dim, K11_EXPERTS, sms)
            max_split = min(qg.MAX_SPLIT, -(-k_dim // qg.K_STAGE))
            options = {(rows, split)}
            options |= {(r, split) for r in (rows // 2, rows * 2) if r in qg.ROW_TILES}
            options |= {(rows, s) for s in (1, 2, 3) if s <= max_split}
            times = {}
            for r, sp in sorted(options):
                fn = lambda r=r, sp=sp: qg._launch(x, w_q, scale, group_sizes, row_tile=r, split=sp)  # noqa: E731
                check(f"K11 sweep T={t} {mat} {r} rows x {sp} K parts", fn(), ref, torch.bfloat16)
                times[f"{r}x{sp}"] = device_ms(fn, "quantized_gmm")
            row[mat] = {"plan": f"{rows}x{split}", "device_ms": times}
            if 32 <= t <= 512:
                x32 = x.float()
                ref32 = qg.quantized_ragged_dot(x32, w_q, scale, group_sizes, plain=True)
                simt = {}
                for rm in (1, 4):
                    fn = lambda rm=rm: qg._launch(x32, w_q, scale, group_sizes, rows_per_thread=rm)  # noqa: E731
                    check(f"K11 sweep T={t} {mat} {16 * rm}-row tiles fp32", fn(), ref32, torch.float32)
                    simt[16 * rm] = device_ms(fn, "quantized_gmm")
                row[mat]["fp32_simt_device_ms"] = simt
        sweep.append(row)
    return sweep


# Qwen3-30B-A3B in the engine (``engine_moe_paths``): 32 slots, the 256-token admission bucket, 384 cache
# columns, 32 q heads over 4 kv heads of 128, 128 experts top-8 with lin1/gate 2048 -> 768 and lin2 768 -> 2048
MOE_SLOTS, MOE_BUCKET, MOE_MAX_LEN = 32, 256, 384
MOE_HEADS = (32, 4, 128)  # q heads, kv heads, head dim
MOE_EXPERTS, MOE_TOP_K = 128, 8
MOE_MATS = {"lin1": (2048, 768), "lin2": (768, 2048)}


def prompt_mask(gen, b, s_len, lo=8, hi=200):
    """(b, s_len) key mask of right-padded prompts of U[lo, hi] real tokens (the hetero traffic's lengths)."""
    import torch

    lens = torch.randint(lo, hi + 1, (b,), generator=gen, device=DEVICE)
    return torch.arange(s_len, device=DEVICE)[None] < lens[:, None], lens


def kernel_k4_gqa8(gen, dtypes):
    """K4 at Qwen3-30B-A3B's admission wave: b 32, 32/4 heads of 128 (8 q
    heads a kv head), 256 queries at q_start 0 against the 384-column view
    of the wave's fresh cache, each row's keys real up to its prompt length
    (U[8, 200]). fp32 and bf16 against the plain version, bf16 also tile by
    tile (TILE_TOL) beside the plain version with the keys [64, 128) masked
    out, which must read above the bar; timed (events and profiler) beside
    ``sdpa`` with the same visibility as one boolean mask (k/v repeated to
    the q heads: the masked kernels take no GQA)."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    b, (hq, hkv, d), sq, sk = MOE_SLOTS, MOE_HEADS, MOE_BUCKET, MOE_MAX_LEN
    key_mask, lens = prompt_mask(gen, b, sk)
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        q, k, v, _ = attn_inputs(gen, b, hq, hkv, sq, sk, d, dtype)
        out = attn.flash_attention(q, k, v, attn_mask=key_mask)
        ref = attn.flash_attention(q, k, v, attn_mask=key_mask, plain=True)
        torch_sync()
        e = check(f"K4 gqa8 {dtype}", out, ref, dtype)
        case = {"dtype": str(dtype), "max_abs_err": e}
        if dtype == torch.bfloat16:
            case["tile_err"] = tile_rel_err(out, ref)
            if not case["tile_err"] <= TILE_TOL:
                raise AssertionError(f"K4 gqa8: tile error {case['tile_err']} > {TILE_TOL}")
            drop = key_mask.clone()
            drop[:, 64:128] = False
            case["dropped_tile"] = tile_rel_err(attn.flash_attention(q, k, v, attn_mask=drop, plain=True), ref)
            if not case["dropped_tile"] > TILE_TOL:
                raise AssertionError(f"K4 gqa8: a dropped key tile reads {case['dropped_tile']}, within {TILE_TOL}")
            errs_bf16.append(e)
        else:
            errs.append(e)
        cases.append(case)
    call = lambda: attn.flash_attention(q, k, v, attn_mask=key_mask)  # noqa: E731
    ms, plain_ms = cuda_ms(call), cuda_ms(lambda: attn.flash_attention(q, k, v, attn_mask=key_mask, plain=True))
    cols, rows = torch.arange(sk, device=DEVICE), torch.arange(sq, device=DEVICE)
    visible = (cols[None, None] <= rows[None, :, None]) & key_mask[:, None, :]  # (b, sq, sk)
    k_rep, v_rep = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q, k_rep, v_rep, attn_mask=visible[:, None])  # noqa: E731
    check("K4 gqa8 vs sdpa (library)", lib(), call(), dtypes[-1])
    # each query sees the keys at or before it that are real: sum over queries of min(i + 1, len)
    pairs = int(torch.minimum(rows[None] + 1, lens[:, None]).sum())
    moved = 2 * nbytes(q) + nbytes(key_mask[:, :sq]) + 2 * b * hkv * sq * d * q.element_size()  # q, out, mask, k/v
    extra = {**bound(moved, 4 * d * pairs * hq), "library_ms": cuda_ms(lib), "max_abs_err_bf16": max(errs_bf16),
             "tile_err_bf16": cases[-1]["tile_err"], "device_ms": device_ms(call, TC_KERNELS),
             "record": {"shape": {"b": b, "heads": [hq, hkv], "d": d, "sq": sq, "sk": sk}}}
    return max(errs), ms, plain_ms, cases, extra


def kernel_k10_gqa8(gen, dtypes):
    """K10 on Qwen3-30B-A3B's int8 cache in the engine's decode step: b 32,
    32/4 heads of 128 (8 q heads a kv head, the kernel's most), 384 columns,
    on the cache's strided layer views; fp32 q on the SIMT kernel, bf16 q on
    the tensor-core kernel (``tc_launches``). Checked as ``kernel_k10``:
    within TOL, each (batch, q head) row within K10_ROW_TOL beside a control
    with one 64-key tile masked out of the plain version, two runs
    bit-equal; bf16 timed by events and profiler beside its bound and the
    host's µs a call."""
    import torch

    from llm_quest_tpu_torch.kernels import flash_decode as fd
    from llm_quest_tpu_torch.ops.masks import mask_value

    w = fd.flash_decode
    b, (hq, hkv, d), s_len = MOE_SLOTS, MOE_HEADS, MOE_MAX_LEN
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        bf16 = dtype == torch.bfloat16
        row_tol = K10_ROW_TOL[str(dtype).removeprefix("torch.")]
        q, k, v, bias = int8_cache_inputs(gen, b, hq, hkv, s_len, d, dtype)

        def call(plain=False, bias=bias, q=q, k=k, v=v):
            return w(q, k.data, k.scale, v.data, v.scale, bias, plain=plain)

        out, tc = tc_count(w, call)
        ref = call(True)
        torch_sync()
        tc_moved(f"K10 gqa8 {dtype}", tc, 0, int(bf16))
        e = check(f"K10 gqa8 {dtype}", out, ref, dtype)
        rows = k10_rows(out, ref)
        if not rows <= row_tol:  # also catches NaN
            raise AssertionError(f"K10 gqa8 {dtype}: row error {rows} > {row_tol}")
        bias_drop = bias.clone()
        bias_drop[:, 128:192] = mask_value(torch.float32)
        dropped = k10_rows(out, call(True, bias_drop))
        if not dropped > row_tol:
            raise AssertionError(f"K10 gqa8 {dtype}: a masked key tile reads {dropped}, within {row_tol}")
        if not torch.equal(out, call()):
            raise AssertionError(f"K10 gqa8 {dtype}: two runs differ")
        case = {"dtype": str(dtype), "max_abs_err": e, "row_err": rows, "dropped_tile_row_err": dropped,
                "tc_launches": tc}
        if bf16:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            case.update(split=fd.plan(b, hkv, s_len, sms), ms=cuda_ms(call), plain_ms=cuda_ms(lambda: call(True)),
                        device_ms=device_ms(call, "flash_decode"), host_us=host_us(call),
                        **bound(nbytes(q, k.data, k.scale, v.data, v.scale, bias, out), 4 * b * hq * s_len * d))
            case["share_of_bound"] = case["bound_ms"] / case["device_ms"]
            errs_bf16.append(e)
        else:
            errs.append(e)
        cases.append(case)
    rec = cases[-1]
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "device_ms",
                                       "host_us")}
    extra.update({"library_ms": None, "max_abs_err_bf16": max(errs_bf16), "tile_err_bf16": rec["row_err"],
                  "record": {"shape": {"b": b, "heads": [hq, hkv], "d": d, "S": s_len}, "split": rec["split"],
                             "share_of_bound": rec["share_of_bound"]}})
    return max(errs), rec["ms"], rec["plain_ms"], cases, extra


def k11_drop_control(x, w_q, scale, group_sizes, ref32):
    """TILE_TOL's reading, against ``ref32`` (the fp32 plain output), of the
    plain output with the K rows [64, 128) of the largest expert's weights
    left out: only that expert's rows are recomputed."""
    sizes = group_sizes.tolist()
    big = max(range(len(sizes)), key=sizes.__getitem__)
    lo, hi = sum(sizes[:big]), sum(sizes[: big + 1])
    wd = w_q[big].float().clone()
    wd[64:128] = 0
    ctrl = ref32.clone()
    ctrl[lo:hi] = (x[lo:hi].float() @ wd) * scale[big].float()
    return k11_tiles(ctrl, ref32, group_sizes)


def kernel_k11_e128(gen, dtypes):
    """K11 at Qwen3-30B-A3B's expert stacks (128 experts, top-8; lin1 and
    gate 2048 -> 768, lin2 768 -> 2048) at the engine's two row counts: a
    decode step of 32 slots (T = 256 rows on about 111 experts) and a full
    admission wave (32 rows x 256 tokens, T = 65,536 on all 128). fp32 rows
    on the SIMT kernel, bf16 rows on the tensor-core kernel at the wrapper's
    ``plan``; two runs bit-equal, each (expert, 64-channel) tile within
    TILE_TOL of the fp32 plain version beside a control with one 64-deep K
    chunk of the largest expert dropped; timed by events and profiler beside
    ``torch._grouped_mm`` on a bf16 copy of the stack. The record's times are
    the decode step's lin1."""
    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    w = qg.quantized_ragged_dot
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, errs_bf16, cases = [], [], []
    for tokens in (MOE_SLOTS, MOE_SLOTS * MOE_BUCKET):
        group_sizes = k11_routing(gen, tokens, MOE_EXPERTS, MOE_TOP_K)
        t = MOE_TOP_K * tokens
        for mat, (k_dim, n_dim) in MOE_MATS.items():
            w_q, scale = k11_stack(gen, k_dim, n_dim, MOE_EXPERTS)
            for dtype in dtypes:
                x = randn(gen, t, k_dim, dtype=dtype)
                call = lambda plain=False: w(x, w_q, scale, group_sizes, plain=plain)  # noqa: E731
                out, tc = tc_count(w, call)
                ref = call(True)
                torch_sync()
                bf16 = dtype == torch.bfloat16
                tc_moved(f"K11 e128 T={t} {mat} {dtype}", tc, 0, int(bf16))
                err = check(f"K11 e128 T={t} {mat} {dtype}", out, ref, dtype)
                case = {"T": t, "matrix": mat, "K": k_dim, "N": n_dim, "dtype": str(dtype), "max_abs_err": err,
                        "experts_hit": int((group_sizes > 0).sum()), "max_group": int(group_sizes.max()),
                        "tc_launches": tc}
                if not bf16:
                    errs.append(err)
                    cases.append(case)
                    continue
                if not torch.equal(out, call()):
                    raise AssertionError(f"K11 e128 T={t} {mat}: two runs differ")
                ref32 = qg.quantized_ragged_dot(x.float(), w_q, scale, group_sizes, plain=True)
                tile_err = k11_tiles(out, ref32, group_sizes)
                if not tile_err <= TILE_TOL:  # also catches NaN
                    raise AssertionError(f"K11 e128 T={t} {mat}: tile error {tile_err} > {TILE_TOL}")
                dropped = k11_drop_control(x, w_q, scale, group_sizes, ref32)
                if not dropped > TILE_TOL:
                    raise AssertionError(f"K11 e128 T={t} {mat}: a dropped K chunk reads {dropped}, within {TILE_TOL}")
                rows, split = qg.plan(t, k_dim, n_dim, MOE_EXPERTS, sms)
                gmm_ms, gmm_err = k11_grouped_mm_ms(x, w_q, scale, group_sizes)
                hit = case["experts_hit"]  # the weights of the experts with rows are read
                case.update({"rows": rows, "split": split, "tile_err": tile_err, "dropped_chunk_tile_err": dropped,
                             "ms": cuda_ms(call), "plain_ms": cuda_ms(lambda: call(True), iters=3, warmup=1),
                             "device_ms": device_ms(call, "quantized_gmm"), "bf16_grouped_mm_ms": gmm_ms,
                             "bf16_grouped_mm_err": gmm_err,
                             **bound(nbytes(x, out, group_sizes) + hit * (k_dim * n_dim + 4 * n_dim),
                                     2 * t * k_dim * n_dim)})
                errs_bf16.append(err)
                cases.append(case)
                del ref32
            del w_q, scale
    torch.cuda.empty_cache()
    rec = next(c for c in cases if c["T"] == MOE_TOP_K * MOE_SLOTS and c["matrix"] == "lin1" and "ms" in c)
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "device_ms",
                                       "bf16_grouped_mm_ms")}
    extra.update({"library_ms": None, "max_abs_err_bf16": max(errs_bf16),
                  "tile_err_bf16": max(c["tile_err"] for c in cases if "tile_err" in c),
                  "record": {key: {f"T{c['T']}_{c['matrix']}": c[val] for c in cases if "ms" in c}
                             for key, val in (("cases_ms", "ms"), ("cases_device_ms", "device_ms"),
                                              ("cases_bound_ms", "bound_ms"), ("cases_plain_ms", "plain_ms"),
                                              ("cases_grouped_mm_ms", "bf16_grouped_mm_ms"),
                                              ("cases_plan", "rows"), ("cases_split", "split"))}})
    return max(errs), rec["ms"], rec["plain_ms"], cases, extra


def kernel_k3(gen, dtypes):
    """K3, one layer's decode step (16 heads, dk = dv = 128) at b 1 and b 32,
    fp32 and bf16, on ``step_inputs`` against plain, the state updated in
    place; timed in bf16 at both sizes with the L2 cold (``step_timing``),
    the record's line at b 32."""
    import torch

    from llm_quest_tpu_torch.kernels import gdn

    errs, cases = [], []
    for dtype in dtypes:
        for b in (1, 32):
            q, k, v, beta, alpha = step_inputs(gen, b, 16, 16, 128, dtype)
            state = randn(gen, b, 16, 128, 128, scale=0.1)
            ref_state = state.clone()
            out, new = gdn.gated_delta_rule_step(q, k, v, beta, alpha, state)
            ref_out, _ = gdn.gated_delta_rule_step(q, k, v, beta, alpha, ref_state, plain=True)
            torch_sync()
            if new is not state:
                raise AssertionError("K3: the state was not updated in place")
            tol = NEW_TOL if dtype == dtypes[0] else None  # bf16 out rounds once more
            e = max(check(f"K3 out b={b} {dtype}", out, ref_out, dtype, tol),
                    check(f"K3 state b={b} {dtype}", state, ref_state, torch.float32, NEW_TOL))
            case = {"b": b, "h": 16, "dk": 128, "dtype": str(dtype), "max_abs_err": e}
            if dtype == dtypes[-1]:
                def run(q=q, k=k, v=v, beta=beta, alpha=alpha, state=state):
                    return gdn.gated_delta_rule_step(q, k, v, beta, alpha, state)

                def plain_run(q=q, k=k, v=v, beta=beta, alpha=alpha, state=ref_state):
                    return gdn.gated_delta_rule_step(q, k, v, beta, alpha, state, plain=True)

                rot = rotation(state)
                rotated = [lambda i=i, q=q, k=k, v=v, beta=beta, alpha=alpha, rot=rot:
                           gdn.gated_delta_rule_step(q, k, v, beta, alpha, rot[i]) for i in range(len(rot))]
                # the fp32 state read and written once, q/k/v/β/α read, out written
                case.update(step_timing(run, rotated, plain_run,
                                        nbytes(q, k, v, beta, alpha, out) + 2 * nbytes(state), 8 * 128 * 128 * 16 * b))
                del rot, rotated
            cases.append(case)
            if dtype == dtypes[0]:
                errs.append(e)
    rec = next(c for c in cases if c["b"] == 32 and "ms" in c)
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "device_ms",
                                       "device_ms_warm", "events_ms", "host_us")}
    extra["library_ms"] = None
    return max(errs), rec["ms"], rec["plain_ms"], cases, extra


# one attention layer of the context-parallel train step: Qwen3-0.6B's 16/8
# heads of 128 at b 1, s 8192 (the rank's whole sequence at world 1)
CP_K5 = {"b": 1, "hq": 16, "hkv": 8, "s": 8192, "d": 128}


def kernel_k5(gen, dtypes, *, causal, backward=False, shape=CP_K5):
    """K5 (K4's forward with its lse, and K4's backward with the lse
    cotangent) at ``shape`` against its plain version (the output, the lse
    and, with ``backward``, dq/dk/dv for a random output and lse cotangent),
    fp32 (the SIMT kernels) within NEW_TOL and bf16 (the tensor-core
    kernels) within TOL, timed in bf16 beside
    ``F.scaled_dot_product_attention``, which computes the same output but
    returns no lse."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    b, hq, hkv, s, d = (shape[key] for key in ("b", "hq", "hkv", "s", "d"))
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        q, k, v = randn(gen, b, hq, s, d, dtype=dtype), randn(gen, b, hkv, s, d, dtype=dtype), \
            randn(gen, b, hkv, s, d, dtype=dtype)
        do, g_lse = randn(gen, b, hq, s, d, dtype=dtype), randn(gen, b, hq, s)
        leaves = [t.clone().requires_grad_(backward) for t in (q, k, v)]

        def run(plain, leaves=leaves, do=do, g_lse=g_lse):
            out, lse = attn.flash_attention_with_lse(*leaves, causal=causal, plain=plain)
            if not backward:
                return out, lse
            return (out.detach(), lse.detach()) + torch.autograd.grad((out, lse), leaves, (do, g_lse))

        names = ("o", "lse", "dq", "dk", "dv")[: 5 if backward else 2]
        label = f"K5 causal={causal} bwd={backward} {dtype}"
        got, ref = run(False), run(True)
        torch_sync()
        # fp32 (SIMT) within NEW_TOL; bf16 (tensor cores: p and ds rounded to bf16) within TOL
        err = {n: check(f"{label} {n}", g, r, dtype, NEW_TOL if dtype == dtypes[0] else None)
               for n, g, r in zip(names, got, ref)}
        cases.append({"dtype": str(dtype), "max_abs_err": err,
                      "max_abs_ref": {n: max_err(g, r)[1] for n, g, r in zip(names, got, ref)}})
        (errs if dtype == dtypes[0] else errs_bf16).append(max(err.values()))
        if dtype != dtypes[0]:  # the tensor cores, also tile by tile
            cases[-1]["tile_err"] = check_tiles(label, got, ref, names)
            cases[-1]["tile_err_dropped_tile"] = dropped_tile(label, leaves, do, ref, names, causal=causal,
                                                              g_lse=g_lse)
        del got, ref
        if dtype != dtypes[0]:
            iters = (5, 1) if backward else (10, 2)
            case = {"dtype": str(dtype), "ms": cuda_ms(lambda: run(False), *iters),
                    "plain_ms": cuda_ms(lambda: run(True), *iters),
                    "device_ms": device_ms(lambda: run(False), TC_KERNELS)}
            pairs = s * (s + 1) // 2 if causal else s * s
            # forward 4·d per visible pair and head (QKᵀ, PV); backward 2× that
            flops = (3 if backward else 1) * 4 * d * pairs * b * hq
            # q/k/v read and o (+ its fp32 lse) written; the backward also reads
            # do, o, the lse and its cotangent and writes dq/dk/dv
            lse_bytes = 4 * b * hq * s
            n_bytes = 2 * nbytes(q, k, v, do) + 4 * lse_bytes if backward else nbytes(q, k, v, do) + lse_bytes
            case.update(bound(n_bytes, flops, "bfloat16"))
            sdpa = torch.nn.functional.scaled_dot_product_attention

            def lib(leaves=leaves, do=do):
                out = sdpa(*leaves, is_causal=causal, enable_gqa=True)
                return torch.autograd.grad(out, leaves, do) if backward else out

            if not backward:
                check(f"{label} vs sdpa (library)", lib(), attn.flash_attention_with_lse(q, k, v, causal=causal)[0],
                      dtype)
            case["library_ms"] = cuda_ms(lib, *iters)
            case["library_note"] = "F.scaled_dot_product_attention: the same output, no lse"
            cases.append(case)
        del q, k, v, do, leaves
        torch.cuda.empty_cache()
    rec = cases[-1]
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "library_ms",
                                       "device_ms")}
    extra["shape"] = {**shape, "causal": causal, "backward": backward}
    extra["max_abs_err_bf16"] = max(errs_bf16)
    extra["tile_err_bf16"] = max(cases[-2]["tile_err"].values())
    return max(errs), rec["ms"], rec["plain_ms"], cases, extra


# K6's shapes: ViT-B's heads (b 128, 12 heads, s 197, d 64), not causal; and
# the context-parallel fallback's causal call at Qwen3-0.6B's head dim
K6_VIT = {"b": 128, "h": 12, "s": 197, "d": 64}
K6_CAUSAL = {"b": 4, "h": 16, "s": 300, "d": 128}


def kernel_k6(gen, dtypes, *, causal=False, shape=K6_VIT, backward=False):
    """K6 at ``shape``, fp32 (the SIMT kernel, within NEW_TOL) and bf16 (the
    short-sequence tensor-core kernel; tile by tile at s >= 128) against
    its plain version (``sdpa`` with the causal mask), with the row lse its
    forward keeps; with ``backward``, forward + backward (the flash
    recompute kernels fed that lse). Timed in bf16 beside
    ``F.scaled_dot_product_attention`` (and its backward)."""
    import torch

    from llm_quest_tpu_torch.kernels import fused_mha as fm

    b, h, s, d = (shape[key] for key in ("b", "h", "s", "d"))
    errs, errs_bf16, cases, tiles_bf16 = [], [], [], []
    w = fm.fused_mha
    for dtype in dtypes:
        bf16 = dtype == dtypes[-1]
        q, k, v, do = (randn(gen, b, h, s, d, dtype=dtype) for _ in range(4))
        leaves = [t.clone().requires_grad_(backward) for t in (q, k, v)]

        def run(plain=False, leaves=leaves, do=do):
            out = fm.fused_mha(*leaves, causal=causal, plain=plain)
            if not backward:
                return (out,)
            return (out.detach(),) + torch.autograd.grad(out, leaves, do)

        label = f"K6 {shape} causal={causal} bwd={backward} {dtype}"
        tc, tc_bwd = w.tc_launches, w.tc_bwd_launches
        got = run()
        tc_moved(label, w.tc_launches, tc, 1 if bf16 else 0)
        tc_moved(label, w.tc_bwd_launches, tc_bwd, 1 if bf16 and backward else 0)
        ref = run(True, [t.detach().float().requires_grad_(backward) for t in (q, k, v)], do.float())
        names = ("o", "dq", "dk", "dv")[: len(got)]
        torch_sync()
        e, tiles = short_check(label, got, ref, names, dtype, s, None if bf16 else NEW_TOL)
        _, lse = fm._fused_fwd(q, k, v, causal, d**-0.5, with_lse=True)
        lse_err = check(f"{label} lse", lse, fm.fused_mha_lse_plain(q, k, causal=causal), torch.float32,
                        LSE_TOL if bf16 else NEW_TOL)
        cases.append({**shape, "causal": causal, "dtype": str(dtype), "max_abs_err": e, "lse_err": lse_err,
                      "tile_err": tiles})
        (errs_bf16 if bf16 else errs).append(e)
        if tiles:
            tiles_bf16.extend(tiles.values())
        del got, ref
    iters = (50, 5) if backward else (200, 10)
    ms = cuda_ms(run, *iters)
    plain_ms = cuda_ms(lambda: run(True), iters=5, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib():
        out = sdpa(*leaves, is_causal=causal)
        return torch.autograd.grad(out, leaves, do) if backward else out

    if not backward:
        check("K6 vs sdpa (library)", lib(), fm.fused_mha(q, k, v, causal=causal), dtypes[-1])
    pairs = s * (s + 1) // 2 if causal else s * s
    # forward: q/k/v read, o written, 4·d per visible pair and head (QKᵀ, PV);
    # with the backward also do read and dq/dk/dv written, 3x the products
    n_bytes, flops = (2 * nbytes(q, k, v, do), 3 * 4 * d * pairs * b * h) if backward else \
        (4 * nbytes(q), 4 * d * pairs * b * h)
    extra = {**bound(n_bytes, flops), "library_ms": cuda_ms(lib, *iters), "shape": {**shape, "causal": causal},
             "max_abs_err_bf16": max(errs_bf16), "device_ms": device_ms(run, TC_KEY)}
    if tiles_bf16:
        extra["tile_err_bf16"] = max(tiles_bf16)
    del q, k, v, do, leaves
    torch.cuda.empty_cache()
    return max(errs), ms, plain_ms, cases, extra


def kernel_k12(gen, dtypes, *, int8):
    """K12 at the ablation's shape (bf16: G 1536, M 208, D 64; int8: M 224,
    D 128 zero-padded), on the tensor cores (``tc_launches``), against its
    plain version within ``k12_tolerance`` (bf16: one bf16 unit of max
    |plain|; int8: one bf16 unit of each plain value plus the fp32 summation
    bound of p·(v + t)) beside a control, the plain version with one 64-key
    chunk dropped (its key rows zeroed, so p = 0 there), which must read
    beyond it; two runs bit-equal. Timed by CUDA events and profiler beside
    the plain version and, for bf16, two ``torch.bmm`` (no PyTorch call
    takes int8 batched products on the card)."""
    import torch

    from llm_quest_tpu_torch.kernels import attn_core as ac
    from llm_quest_tpu_torch.scripts import ablate_int8_scores as ab

    bf16_inputs, int8_inputs = ab.inputs()
    q, k, v = int8_inputs if int8 else bf16_inputs
    del bf16_inputs, int8_inputs
    label = f"K12 {'int8' if int8 else 'bf16'}"
    t = torch.full((1, 1, ab.K), 0.01, dtype=torch.bfloat16, device=DEVICE)
    out, tc = tc_count(ac.attn_core, lambda: ac.attn_core(t, q, k, v))
    ref = ac.attn_core(t, q, k, v, plain=True)
    torch_sync()
    tc_moved(label, tc, 0, 1)
    err = (out.float() - ref.float()).abs()
    tol = ac.k12_tolerance(t, q, k, v, ref)
    if not bool((err <= tol).all()):  # also catches NaN
        raise AssertionError(f"{label}: max abs err {float(err.max())}, {int((err > tol).sum())} outputs beyond "
                             "the tolerance")
    if not torch.equal(out, ac.attn_core(t, q, k, v)):
        raise AssertionError(f"{label}: two runs differ")
    e = float(err.max())
    case = {"shape": list(q.shape), "dtype": str(q.dtype), "max_abs_err": e, "max_abs_plain": float(ref.float().abs().max()),
            "n_beyond_one_bf16_unit_of_plain": int((err > ac.bf16_unit(ref)).sum()), "tc_launches": tc}
    del ref, err, tol
    k_drop = k.clone()
    k_drop[:, ac.CHUNK:2 * ac.CHUNK] = 0
    ref_drop = ac.attn_core(t, q, k_drop, v, plain=True)
    beyond = int(((out.float() - ref_drop.float()).abs() > ac.k12_tolerance(t, q, k_drop, v, ref_drop)).sum())
    if beyond == 0:
        raise AssertionError(f"{label}: the plain version without one 64-key chunk reads within the tolerance")
    case["dropped_chunk_outputs_beyond"] = beyond
    del k_drop, ref_drop, out
    flops = 4 * ab.G * ab.M * ab.M * ab.K  # the useful count, both variants
    call = lambda: ac.attn_core(t, q, k, v)  # noqa: E731
    ms = cuda_ms(call, iters=50, warmup=5)
    plain_ms = cuda_ms(lambda: ac.attn_core(t, q, k, v, plain=True), iters=5, warmup=1)
    g, m, d = q.shape
    n_bytes = nbytes(q, k, v, v)  # q, k, v read and o (v's shape and type) written
    if int8:
        kv = v.shape[-1]
        extra = {**bound_int8(n_bytes, 2 * g * m * m * d, 2 * g * m * m * kv), "library_ms": None}
    else:
        lib = lambda: torch.bmm(torch.bmm(q, k.transpose(1, 2)), v + t)  # noqa: E731
        check("K12 vs two bmm (library)", lib(), call(), torch.bfloat16)
        extra = {**bound(n_bytes, flops), "library_ms": cuda_ms(lib, iters=50, warmup=5)}
    extra.update(useful_flops=flops, tflops=flops / ms / 1e9, shape=list(q.shape),
                 device_ms=device_ms(call, "attn_core"))
    case["device_ms"] = extra["device_ms"]
    return e, ms, plain_ms, [case], extra


def torch_sync():
    import torch

    torch.cuda.synchronize()  # a fault inside a kernel surfaces here, at its phase


# the main paths
GENERATE, TRAIN, HYBRID = "generate", "train", "hybrid_train"
INT8_GENERATE, NEXT_SERVE = "int8_generate", "next_serve"
TEXT_B128 = "text_decode_b128"
GEMMA = "gemma_train"
VIT = "vit_encode"
MIMO = "mimo_train"
DSV3 = "dsv3_train"
VIT_TRAIN, VIT_B_TRAIN = "vit_train", "vit_b_train"
ABLATE = "ablate_int8_scores"
CP_TRAIN, CP_FALLBACK = "cp_train", "cp_fallback"
ENGINE_UNIFORM, ENGINE_HETERO, ENGINE_INT8 = "engine_serve_uniform", "engine_serve_hetero", "engine_serve_int8"
ENGINE_CHUNKED, ENGINE_PREFIX, ENGINE_VLM = "engine_chunked_prefill", "engine_prefix", "engine_vlm"
ENGINE_PATHS = (ENGINE_UNIFORM, ENGINE_HETERO, ENGINE_INT8, ENGINE_CHUNKED, ENGINE_PREFIX, ENGINE_VLM)
# the MoE families through the engine: Qwen3-30B-A3B int8 and bf16, Qwen3-Next-small bf16 and int8, and
# Gemma-3 / DeepSeek-V3 / MiMo-V2-Flash (no kernel: ``sdpa`` on the cache, as in JAX)
ENGINE_MOE_INT8, ENGINE_MOE_BF16 = "engine_serve_moe_int8", "engine_serve_moe_bf16"
ENGINE_NEXT, ENGINE_NEXT_INT8 = "engine_serve_next", "engine_serve_next_int8"
ENGINE_FAMILIES = "engine_families"
# the attention records' sources by dtype: bf16 takes the tensor-core
# kernels, fp32 the SIMT ones
ATTN_SRC = {"bfloat16": "llm_quest_tpu_torch/csrc/attention_tc.cu",
            "float32": "llm_quest_tpu_torch/csrc/attention.cu"}
FUSED_SRC = {"bfloat16": "llm_quest_tpu_torch/csrc/fused_mha_tc.cu",
             "float32": "llm_quest_tpu_torch/csrc/fused_mha.cu"}
PACKED_SRC = {"bfloat16": "llm_quest_tpu_torch/csrc/fused_mha_tc.cu",
              "float32": "llm_quest_tpu_torch/csrc/attention.cu"}
# K8's and K9's: bf16 takes the int8-score tensor-core kernel, fp32 the SIMT one
INT8_SRC = {"bfloat16": "llm_quest_tpu_torch/csrc/packed_mha_int8_tc.cu",
            "float32": "llm_quest_tpu_torch/csrc/packed_mha_int8.cu"}
# K1's: bf16 takes the chunked tensor-core kernels, fp32 the SIMT scan
GDN_SRC = {"bfloat16": "llm_quest_tpu_torch/csrc/gdn_tc.cu", "float32": "llm_quest_tpu_torch/csrc/gdn.cu"}
# K11's: bf16 rows take the tensor-core kernel, fp32 rows the SIMT one
QGMM_SRC = {"bfloat16": "llm_quest_tpu_torch/csrc/quantized_gmm_tc.cu",
            "float32": "llm_quest_tpu_torch/csrc/quantized_gmm.cu"}
# K10's: bf16 q takes the tensor-core kernel, fp32 q the SIMT one
FD_SRC = {"bfloat16": "llm_quest_tpu_torch/csrc/flash_decode_tc.cu",
          "float32": "llm_quest_tpu_torch/csrc/flash_decode.cu"}
FP32_PATHS = (VIT_TRAIN, CP_FALLBACK)  # the paths that run in fp32
KERNELS = [
    # name, wrapper (module, attribute[, which launches: "window" = those with a
    # sliding window, "full" = those without, "softcap_sink" = those with a
    # softcap or sinks, "static" = those with static scales, "dynamic" = those
    # without, "causal" / "noncausal" and "causal_bwd" / "noncausal_bwd" the
    # forward and backward launches with and without causality, "int8" /
    # "bf16" those with int8 or bf16 scores]), source (or the source of each
    # dtype's kernel), replaced TPU kernel, check, main paths that launch it
    ("gdn_prefill", ("gdn", "gated_delta_rule_fwd"), GDN_SRC,
     "llm_quest_tpu/kernels/gdn_pallas.py:205", kernel_k1,
     (GENERATE, HYBRID, INT8_GENERATE, NEXT_SERVE, TEXT_B128, *ENGINE_PATHS, ENGINE_NEXT, ENGINE_NEXT_INT8)),
    ("gdn_prefill_bwd", ("gdn", "gated_delta_rule_bwd"), GDN_SRC,
     "llm_quest_tpu/kernels/gdn_pallas.py:255", kernel_k1_bwd, (HYBRID,)),
    # K2 and K3: the step kernel (csrc/gdn.cu) for both dtypes; their records' ms is the kernel's
    # device time with the L2 cold (step_timing)
    ("gdn_step_stacked", ("gdn", "gated_delta_rule_step_stacked"), "llm_quest_tpu_torch/csrc/gdn.cu",
     "llm_quest_tpu/kernels/gdn_pallas.py:350", kernel_k2,
     (GENERATE, INT8_GENERATE, NEXT_SERVE, TEXT_B128, *ENGINE_PATHS, ENGINE_NEXT, ENGINE_NEXT_INT8)),
    ("flash_attention_fwd", ("attention", "flash_attention"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544", kernel_k4,
     (GENERATE, TRAIN, HYBRID, ENGINE_HETERO, ENGINE_CHUNKED, ENGINE_PREFIX)),
    # K4 at one chunk of the chunked admission (q_start up to 7680 against 8320 cache columns)
    ("flash_attention_fwd_chunked", ("attention", "flash_attention"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544", kernel_k4_chunked, (ENGINE_CHUNKED,)),
    ("flash_attention_bwd", ("attention", "flash_attention_bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:175", kernel_k4_bwd, (TRAIN, HYBRID)),
    # K7: its bf16 forward is the short-sequence tensor-core kernel (fp32: the
    # SIMT flash forward of attention.cu); its backward the flash recompute
    # kernels (attention_tc.cu in bf16, attention.cu in fp32), counted as "bwd"
    ("packed_mha", ("attention", "packed_mha"), PACKED_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:422", kernel_k7, (VIT, VIT_B_TRAIN)),
    ("packed_mha_d32", ("attention", "packed_mha"), PACKED_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:422", partial(kernel_k7, shape=VIT_D32), (VIT_TRAIN,)),
    ("packed_mha_fwd_bwd", ("attention", "packed_mha", "bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:442", kernel_k7_bwd, (VIT_B_TRAIN,)),
    ("packed_mha_fwd_bwd_d32", ("attention", "packed_mha", "bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:442", partial(kernel_k7_bwd, shape=VIT_D32), (VIT_TRAIN,)),
    # K8 and K9: bf16 on the int8-score tensor-core kernel, fp32 on the SIMT one
    ("packed_mha_int8", ("fused_mha", "packed_mha_int8", "dynamic"), INT8_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:405", partial(kernel_int8, mode="dynamic"), (VIT,)),
    ("packed_mha_int8_static", ("fused_mha", "packed_mha_int8", "static"), INT8_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:405", partial(kernel_int8, mode="static"), (VIT,)),
    ("packed_mha_int8_inkernel", ("fused_mha", "packed_mha_int8_inkernel"), INT8_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:372", partial(kernel_int8, mode="inkernel"), (VIT,)),
    ("flash_decode", ("flash_decode", "flash_decode"), FD_SRC,
     "llm_quest_tpu/kernels/flash_decode.py:91", kernel_k10, (INT8_GENERATE, ENGINE_INT8)),
    ("quantized_ragged_dot", ("quantized_gmm", "quantized_ragged_dot"), QGMM_SRC,
     "llm_quest_tpu/kernels/quantized_gmm.py:71", kernel_k11, (NEXT_SERVE, ENGINE_NEXT_INT8)),
    # Qwen3-30B-A3B's shapes in the engine: K4 at the 256-token admission bucket (32/4 heads, d 128), K10 on
    # its int8 cache (b 32, 32/4 heads, d 128), K11 over its 128 int8 experts (top-8) at decode and admission T
    ("flash_attention_fwd_gqa8", ("attention", "flash_attention"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544", kernel_k4_gqa8, (ENGINE_MOE_INT8, ENGINE_MOE_BF16)),
    ("flash_decode_gqa8", ("flash_decode", "flash_decode"), FD_SRC,
     "llm_quest_tpu/kernels/flash_decode.py:91", kernel_k10_gqa8, (ENGINE_MOE_INT8,)),
    ("quantized_ragged_dot_e128", ("quantized_gmm", "quantized_ragged_dot"), QGMM_SRC,
     "llm_quest_tpu/kernels/quantized_gmm.py:71", kernel_k11_e128, (ENGINE_MOE_INT8,)),
    # K4 at one Gemma-3-270M layer: the SWA layers' window, the global layers'
    # causal call at the same shape, and the softcap and sinks (on no path yet)
    ("flash_attention_fwd_window", ("attention", "flash_attention", "window"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544", partial(k4_case, window=GEMMA_WINDOW), (GEMMA,)),
    ("flash_attention_fwd_bwd_window", ("attention", "flash_attention_bwd", "window"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, window=GEMMA_WINDOW, backward=True), (GEMMA,)),
    ("flash_attention_fwd_causal_d256", ("attention", "flash_attention", "full"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:544",
     k4_case, (GEMMA,)),
    ("flash_attention_fwd_bwd_causal_d256", ("attention", "flash_attention_bwd", "full"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, backward=True), (GEMMA,)),
    # softcap and sinks at the Gemma-3 shape; MiMo-V2-Flash's sinks launch it
    ("flash_attention_softcap_sink", ("attention", "flash_attention_bwd", "softcap_sink"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, softcap=30.0, sink=True, backward=True), (MIMO,)),
    # K4 at d 64 / dv 32, one MiMo-V2-Flash small layer: the SWA layers' window
    # 128 with sinks (12/4 heads), the GA layers' causal call (12/2 heads)
    ("flash_attention_fwd_window_sink_dv32", ("attention", "flash_attention", "window"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:544",
     partial(k4_case, shape=MIMO_SWA_K4, window=MIMO_WINDOW, sink=True), (MIMO,)),
    ("flash_attention_fwd_bwd_window_sink_dv32", ("attention", "flash_attention_bwd", "window"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, shape=MIMO_SWA_K4, window=MIMO_WINDOW, sink=True, backward=True), (MIMO,)),
    ("flash_attention_fwd_causal_dv32", ("attention", "flash_attention", "full"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:544",
     partial(k4_case, shape=MIMO_GA_K4), (MIMO,)),
    ("flash_attention_fwd_bwd_causal_dv32", ("attention", "flash_attention_bwd", "full"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, shape=MIMO_GA_K4, backward=True), (MIMO,)),
    # K4 at DeepSeek-V3's MLA head dims (96, 64), one layer of its train step
    ("flash_attention_fwd_causal_d96_dv64", ("attention", "flash_attention", "full"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:544",
     partial(k4_case, shape=DSV3_K4), (DSV3,)),
    ("flash_attention_fwd_bwd_causal_d96_dv64", ("attention", "flash_attention_bwd", "full"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, shape=DSV3_K4, backward=True), (DSV3,)),
    # K3: one layer's decode step (no model calls it, as in JAX)
    ("gdn_step", ("gdn", "gated_delta_rule_step"), "llm_quest_tpu_torch/csrc/gdn.cu",
     "llm_quest_tpu/kernels/gdn_pallas.py:406", kernel_k3, ()),
    # K5 at one layer of the context-parallel step: causal (the diagonal block,
    # the only one at world 1) and not (the past blocks of a larger ring)
    ("flash_attention_with_lse_causal", ("attention", "flash_attention_with_lse", "causal"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:627",
     partial(kernel_k5, causal=True), (CP_TRAIN,)),
    ("flash_attention_with_lse_fwd_bwd_causal", ("attention", "flash_attention_with_lse", "causal_bwd"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:613",
     partial(kernel_k5, causal=True, backward=True), (CP_TRAIN,)),
    ("flash_attention_with_lse_noncausal", ("attention", "flash_attention_with_lse", "noncausal"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:627",
     partial(kernel_k5, causal=False), ()),
    ("flash_attention_with_lse_fwd_bwd_noncausal", ("attention", "flash_attention_with_lse", "noncausal_bwd"),
     ATTN_SRC, "llm_quest_tpu/kernels/flash_attention.py:613",
     partial(kernel_k5, causal=False, backward=True), ()),
    # K6: ViT-B's heads (not causal), and the CP fallback's causal call; bf16
    # (timed) on the short-sequence tensor-core kernel, fp32 on fused_mha.cu;
    # forward + backward (the flash recompute kernels) at both shapes
    ("fused_mha", ("fused_mha", "fused_mha", "noncausal"), FUSED_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:139", kernel_k6, ()),
    ("fused_mha_causal", ("fused_mha", "fused_mha", "causal"), FUSED_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:139", partial(kernel_k6, causal=True, shape=K6_CAUSAL), (CP_FALLBACK,)),
    ("fused_mha_fwd_bwd", ("fused_mha", "fused_mha", "noncausal_bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:126", partial(kernel_k6, backward=True), ()),
    ("fused_mha_fwd_bwd_causal", ("fused_mha", "fused_mha", "causal_bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:126", partial(kernel_k6, causal=True, shape=K6_CAUSAL, backward=True), ()),
    # K12: the int8-score ablation's attention core, bf16 and int8 scores, both on the tensor cores
    ("attn_core_bf16", ("attn_core", "attn_core", "bf16"), "llm_quest_tpu_torch/csrc/attn_core_tc.cu",
     "scripts/ablate_int8_scores.py:55", partial(kernel_k12, int8=False), (ABLATE,)),
    ("attn_core_int8", ("attn_core", "attn_core", "int8"), "llm_quest_tpu_torch/csrc/attn_core_tc.cu",
     "scripts/ablate_int8_scores.py:55", partial(kernel_k12, int8=True), (ABLATE,)),
]


def wrapper(spec):
    import importlib

    return getattr(importlib.import_module(f"llm_quest_tpu_torch.kernels.{spec[0]}"), spec[1])


def launch_count(spec):
    """The wrapper's launches of the kind ``spec`` names (see KERNELS): all,
    those with a sliding window, those without, those with a softcap or
    sinks, those with static scales or those without, the causal ones or
    the others (forward, or with ``_bwd`` the backward), the int8 ones or
    the bf16 ones."""
    w = wrapper(spec)
    kind = spec[2] if len(spec) > 2 else "all"
    if kind == "full":
        return w.launches - w.window_launches
    if kind == "dynamic":
        return w.launches - w.static_launches
    if kind == "noncausal":
        return w.launches - w.causal_launches
    if kind == "noncausal_bwd":
        return w.bwd_launches - w.causal_bwd_launches
    if kind == "bf16":
        return w.launches - w.int8_launches
    return w.launches if kind == "all" else getattr(w, f"{kind}_launches")


def kernel_phase():
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    records = []
    for name, spec, source, replaces, fn, paths in KERNELS:
        err, ms, plain_ms, cases, extra = fn(gen, (torch.float32, torch.bfloat16))
        emit({"phase": "kernel", "name": name, "cases": cases, "ms_bf16": ms, "plain_ms_bf16": plain_ms, **extra})
        routes = {}
        if isinstance(source, dict):  # the kernel of the paths' dtype (bf16 where no path runs it)
            routes = {"sources": source}
            source = source["float32" if paths and all(p in FP32_PATHS for p in paths) else "bfloat16"]
        records.append({"name": name, "route": "cuda", "source": source, **routes, "replaces": replaces,
                        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": extra["bound_ms"], "bound_by": extra["bound_by"],
                        "library_ms": extra["library_ms"], "simt_bound_ms": extra["simt_bound_ms"],
                        "tflops": extra.get("tflops", extra["flops"] / ms / 1e9),
                        **{key: extra[key] for key in ("bf16_sdpa_ms", "bf16_grouped_mm_ms", "max_abs_err_bf16",
                                                       "tile_err_bf16", "device_ms", "device_ms_warm",
                                                       "events_ms", "host_us") if key in extra},
                        **extra.get("record", {}),
                        "paths": list(paths)})
        torch.cuda.empty_cache()
    return records


COUNTERS = ("launches", "window_launches", "softcap_sink_launches", "static_launches", "bwd_launches",
            "causal_launches", "causal_bwd_launches", "int8_launches", "tc_launches", "tc_bwd_launches")


def reset_launches():
    for spec in KERNELS:
        w = wrapper(spec[1])
        for counter in COUNTERS:
            if hasattr(w, counter):
                setattr(w, counter, 0)


def saved_launches():
    """Every wrapper's counters, for ``restore_launches``: a check inside a
    path's run leaves its launches out of the path's counts."""
    return {(spec[1][:2], counter): getattr(wrapper(spec[1]), counter)
            for spec in KERNELS for counter in COUNTERS if hasattr(wrapper(spec[1]), counter)}


def restore_launches(saved):
    for (spec, counter), n in saved.items():
        setattr(wrapper(spec), counter, n)


# the attention wrappers' (K4, K4 bwd, K5, K6 and K7, forward and backward;
# K8 forward and backward, K9), K1's (forward and backward), K10's, K11's and
# K12's launch counters (module, wrapper, launches) and, beside each, the
# count of those that took the tensor-core kernels (K12 has no other: both
# its variants count)
TC_COUNTERS = (("gdn", "gated_delta_rule_fwd", "launches", "tc_launches"),
               ("gdn", "gated_delta_rule_bwd", "launches", "tc_launches"),
               ("attention", "flash_attention", "launches", "tc_launches"),
               ("attention", "flash_attention_bwd", "launches", "tc_launches"),
               ("attention", "flash_attention_with_lse", "launches", "tc_launches"),
               ("attention", "flash_attention_with_lse", "bwd_launches", "tc_bwd_launches"),
               ("fused_mha", "fused_mha", "launches", "tc_launches"),
               ("fused_mha", "fused_mha", "bwd_launches", "tc_bwd_launches"),
               ("attention", "packed_mha", "launches", "tc_launches"),
               ("attention", "packed_mha", "bwd_launches", "tc_bwd_launches"),
               ("fused_mha", "packed_mha_int8", "launches", "tc_launches"),
               ("fused_mha", "packed_mha_int8", "bwd_launches", "tc_bwd_launches"),
               ("fused_mha", "packed_mha_int8_inkernel", "launches", "tc_launches"),
               ("flash_decode", "flash_decode", "launches", "tc_launches"),
               ("quantized_gmm", "quantized_ragged_dot", "launches", "tc_launches"),
               ("attn_core", "attn_core", "launches", "tc_launches"))


def check_routes(path, bf16):
    """On a bf16 path every K1/K4–K12 launch, forward and backward, took the
    tensor-core kernels; on an fp32 path none did (the SIMT kernels)."""
    for module, name, total, tc in TC_COUNTERS:
        w = wrapper((module, name))
        n, n_tc = getattr(w, total), getattr(w, tc)
        if n_tc != (n if bf16 else 0):
            raise AssertionError(f"{path}: {name} {total} {n}, on the tensor cores {n_tc}; "
                                 f"expected {'all' if bf16 else 'none'} ({'bf16' if bf16 else 'fp32'} path)")


# K6's plain version, the plain backward of K6, K7 and K8, and the plain
# versions of K8, K9 and K11 run on the card only in comparisons (the kernel
# records, ``vit_fp32``, ``serving_checks_fp32``): after the kernel phase
# every call of these counts (``install_plain_sentinels``), and a phase in
# which one ran fails (``phase``).
PLAIN_SENTINELS = (("attention", "packed_mha_bwd_plain"), ("fused_mha", "packed_mha_bwd_plain"),
                   ("fused_mha", "fused_mha_plain"), ("fused_mha", "packed_mha_int8_plain"),
                   ("quantized_gmm", "quantized_ragged_dot_plain"))
PLAIN_CALLS = {"packed_mha_bwd_plain": 0, "fused_mha_plain": 0, "packed_mha_int8_plain": 0,
               "quantized_ragged_dot_plain": 0}
PLAIN_ORIGINALS = {}  # (module, name): the plain version itself, uncounted


def install_plain_sentinels():
    import importlib

    def counted(name, fn):
        def call(*args, **kwargs):
            PLAIN_CALLS[name] += 1
            return fn(*args, **kwargs)

        return call

    for module, name in PLAIN_SENTINELS:
        mod = importlib.import_module(f"llm_quest_tpu_torch.kernels.{module}")
        PLAIN_ORIGINALS[module, name] = getattr(mod, name)
        setattr(mod, name, counted(name, PLAIN_ORIGINALS[module, name]))


def plain_version(module, name):
    """The plain version ``name`` of kernels/``module``.py, uncounted by the sentinels."""
    import importlib

    return PLAIN_ORIGINALS.get((module, name)) or getattr(
        importlib.import_module(f"llm_quest_tpu_torch.kernels.{module}"), name)


@contextlib.contextmanager
def unwatched():
    """A comparison that runs plain versions inside a phase (the model with
    ``use_kernels`` False beside the kernels): the sentinels uncount it."""
    import importlib

    mods = {module: importlib.import_module(f"llm_quest_tpu_torch.kernels.{module}") for module, _ in PLAIN_SENTINELS}
    counted = {key: getattr(mods[key[0]], key[1]) for key in PLAIN_ORIGINALS}
    for (module, name), fn in PLAIN_ORIGINALS.items():
        setattr(mods[module], name, fn)
    try:
        yield
    finally:
        for (module, name), fn in counted.items():
            setattr(mods[module], name, fn)


PHASE_SECONDS = {}  # each phase's wall seconds, printed on the ``phase_seconds`` line


def phase(fn, *args):
    """Run a phase after the kernel phase; fails if a plain version that
    ``PLAIN_SENTINELS`` names ran in it."""
    before = dict(PLAIN_CALLS)
    t0 = time.perf_counter()
    fn(*args)
    PHASE_SECONDS[fn.__name__] = time.perf_counter() - t0
    if PLAIN_CALLS != before:
        raise AssertionError(f"{fn.__name__}: the plain versions ran on the card: {before} -> {PLAIN_CALLS}")


def read_launches(path, records, *, add=True):
    """The launch counts of the path just driven, added to ``records`` (with
    ``add``; a record of all its wrapper's launches also adds those that took
    the tensor-core kernels, ``tc_launches``); fails if a kernel of the path
    never launched, or if the path's K1 and attention launches did not take
    the route of its dtype (bf16: the tensor-core kernels; the FP32_PATHS:
    the SIMT ones)."""
    check_routes(path, path not in FP32_PATHS)
    counts = {}
    for (name, spec, *_, paths), rec in zip(KERNELS, records):
        n = launch_count(spec)
        counts[name] = n
        if add and path in paths:
            rec["launches"] += n
            w = wrapper(spec)
            if len(spec) == 2 and hasattr(w, "tc_launches"):  # all the wrapper's launches: those on the tensor cores
                rec["tc_launches"] = rec.get("tc_launches", 0) + w.tc_launches
            elif spec[-1] in ("dynamic", "static", "bf16", "int8"):  # K8's by scales, K12's by scores: all or
                # none on the tensor cores (check_routes)
                rec["tc_launches"] = rec.get("tc_launches", 0) + n * (path not in FP32_PATHS)
    missing = [name for (name, *_, paths) in KERNELS if path in paths and counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {counts}")
    return counts


# ---------------------------------------------------------------- main path


def make_inputs(cfg, gen):
    """The bench.py multimodal prompt (4 text + 144 image + 8 text tokens,
    one 384 px image repeated over 2 frames) and a b = 4, 300-token text prompt."""
    import torch

    n_vis = (cfg["img_height"] // cfg["patch_size"]) ** 2 // cfg["spatial_merge_size"] ** 2
    text_a = torch.randint(1, 1000, (4,), generator=gen, device=DEVICE)
    text_b = torch.randint(1, 1000, (8,), generator=gen, device=DEVICE)
    image = torch.full((n_vis,), cfg["image_token_id"], device=DEVICE)
    mm_ids = torch.cat([text_a, image, text_b])[None]
    pixels = torch.randn(1, 3, 2, cfg["img_height"], cfg["img_width"], generator=gen, device=DEVICE)
    text_ids = torch.randint(0, 1000, (4, 300), generator=gen, device=DEVICE)
    return mm_ids, pixels, text_ids


def run_main_path(model, cfg, mm_ids, pixels, text_ids, max_gen):
    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import qwen3_5

    px = pixels.to(cfg["dtype"])
    mm = qwen3_5.generate_multimodal(model, cfg, mm_ids, px, max_gen=max_gen, eos_ids=-1, pad_id=0)
    text = gen.generate_kv_cache(qwen3_5.TextOnly, model.text, cfg, text_ids, max_gen=max_gen, eos_ids=-1, pad_id=0)
    return mm["sequences"], text["sequences"]


def prefill_logits(model, cfg, mm_ids, pixels, text_ids):
    """Last-position logits of the cached prefill of both prompts."""
    import torch

    from llm_quest_tpu_torch.models import qwen3_5

    with torch.inference_mode():
        cache = qwen3_5.init_cache(cfg, 1, mm_ids.shape[1] + 1, device=DEVICE)
        mask = torch.ones(1, mm_ids.shape[1] + 1, dtype=torch.bool, device=DEVICE)
        mask[:, -1] = False
        mm, _, _ = qwen3_5.apply(model, cfg, mm_ids, image_pixels=pixels.to(cfg["dtype"]), attn_mask=mask, cache=cache)
        cache = qwen3_5.init_cache(cfg, text_ids.shape[0], text_ids.shape[1] + 1, device=DEVICE)
        mask = torch.ones(text_ids.shape[0], text_ids.shape[1] + 1, dtype=torch.bool, device=DEVICE)
        mask[:, -1] = False
        text, _, _ = qwen3_5.apply_text(model.text, cfg, text_ids, attn_mask=mask, cache=cache)
    return mm[:, -1].float(), text[:, -1].float()


def build_model(cfg):
    import torch

    from llm_quest_tpu_torch.models import qwen3_5

    return qwen3_5.init(cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)


def check_fp32(base_cfg, inputs):
    import torch

    cfg = dict(base_cfg, dtype=torch.float32)
    model = build_model(cfg)
    plain_cfg = dict(cfg, use_kernels=False)
    lk = prefill_logits(model, cfg, *inputs)
    lp = prefill_logits(model, plain_cfg, *inputs)
    errs = [float((a - b).abs().max()) for a, b in zip(lk, lp)]
    if not all(e <= LOGIT_TOL for e in errs):
        raise AssertionError(f"fp32 prefill logits, kernels vs plain: max abs err {errs} > {LOGIT_TOL}")
    seq_k = run_main_path(model, cfg, *inputs, max_gen=16)
    seq_p = run_main_path(model, plain_cfg, *inputs, max_gen=16)
    for name, a, b in zip(("multimodal", "text_b4"), seq_k, seq_p):
        if not torch.equal(a, b):
            raise AssertionError(f"fp32 {name} greedy tokens differ, kernels vs plain:\n{a[:, -16:]}\n{b[:, -16:]}")
    emit({"phase": "check_fp32", "logit_max_abs_err": {"multimodal": errs[0], "text_b4": errs[1]},
          "logit_tol": LOGIT_TOL, "greedy_tokens_equal": 16})
    del model
    torch.cuda.empty_cache()


def timed(fn, n):
    import torch

    samples = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples), samples


def main_path(cfg, inputs, records, card):
    import torch

    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import qwen3_5

    model = build_model(cfg)
    mm_ids, pixels, text_ids = inputs
    lm, lt = prefill_logits(model, cfg, *inputs)
    if not (torch.isfinite(lm).all() and torch.isfinite(lt).all()):
        raise AssertionError("bf16 prefill logits are not finite")

    reset_launches()
    mm_seq, text_seq = run_main_path(model, cfg, *inputs, max_gen=64)
    torch.cuda.synchronize()
    launches = read_launches(GENERATE, records)
    # the 384 px tower's s 576 is above fused_mha_max_seq: split-heads sdpa, as in JAX
    if launches["packed_mha"] != 0:
        raise AssertionError(f"packed_mha launched {launches['packed_mha']} times on the {GENERATE} path")
    vocab = cfg["vocab_size"]
    expected = ((1, mm_ids.shape[1] + 64), (text_ids.shape[0], text_ids.shape[1] + 64))
    for name, seq, shape in zip(("multimodal", "text_b4"), (mm_seq, text_seq), expected):
        if tuple(seq.shape) != shape or not bool(((seq >= 0) & (seq < vocab)).all()):
            raise AssertionError(f"{name}: bad sequences {tuple(seq.shape)}")
    emit({"phase": "main_path", "dtype": "bfloat16", "launches": launches,
          "multimodal_tokens": mm_seq[0, -64:-48].tolist(), "text_b4_tokens": text_seq[0, -64:-48].tolist()})

    px = pixels.to(cfg["dtype"])
    mm = lambda n: qwen3_5.generate_multimodal(model, cfg, mm_ids, px, max_gen=n, eos_ids=-1, pad_id=0)  # noqa: E731
    tx = lambda n: gen.generate_kv_cache(  # noqa: E731
        qwen3_5.TextOnly, model.text, cfg, text_ids, max_gen=n, eos_ids=-1, pad_id=0
    )
    mm_s, mm_all = timed(lambda: mm(64), 3)
    mm_ttft, _ = timed(lambda: mm(1), 5)
    tx_s, tx_all = timed(lambda: tx(64), 3)
    tx_ttft, _ = timed(lambda: tx(1), 5)
    emit({"phase": "timing", "card": card, "dtype": "bfloat16",
          "multimodal": {"tok_s": 64 / mm_s, "ttft_ms": mm_ttft * 1e3, "run_s": mm_all},
          "text_b4": {"tok_s": 4 * 64 / tx_s, "ttft_ms": tx_ttft * 1e3, "run_s": tx_all}})


def text_decode_b128(records, card, max_gen=8):
    """``bench.py``'s batched decode cell (its sweep at b 128): Qwen3.5-0.8B
    text, 24 layers, bf16, random weights from the seed, b 128, prompt 32,
    ``max_gen`` greedy tokens through ``generate_kv_cache``, launch counts
    reset first (K1's prefill, 18 K2 steps a token); then a 1-token and a
    9-token call under the profiler: the device ms a decode step, K2's part
    of it, its share and the kernels a step; tok/s of 16-token calls."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.models import qwen3_5

    cfg = dict(QWEN3_5_08B_CONFIG, dtype=torch.bfloat16)
    model = text_model(cfg)
    ids = ids_on_card(128, 32)
    reset_launches()
    seq = generate(qwen3_5.TextOnly, model, cfg, ids, max_gen)
    torch.cuda.synchronize()
    launches = read_launches(TEXT_B128, records)
    n_gdn = len(qwen3_5.gdn_layer_indices(cfg))
    if launches["gdn_step_stacked"] != n_gdn * (max_gen - 1):
        raise AssertionError(f"{TEXT_B128}: K2 launched {launches['gdn_step_stacked']} times, "
                             f"expected {n_gdn} a decode step over {max_gen - 1} steps")
    if tuple(seq.shape) != (128, 32 + max_gen) or not bool(((seq >= 0) & (seq < cfg["vocab_size"])).all()):
        raise AssertionError(f"{TEXT_B128}: bad sequences {tuple(seq.shape)}")
    short = call_device_ms(lambda: generate(qwen3_5.TextOnly, model, cfg, ids, 1), iters=1, keys=(K2_KEY,))
    long = call_device_ms(lambda: generate(qwen3_5.TextOnly, model, cfg, ids, 9), iters=1, keys=(K2_KEY,))
    k2_ms, step_ms, kernels = per_step(short, long, 8)
    run_s, runs = timed(lambda: generate(qwen3_5.TextOnly, model, cfg, ids, 16), 2)
    emit({"phase": TEXT_B128, "card": card, "dtype": "bfloat16", "layers": cfg["n_layers"], "gdn_layers": n_gdn,
          "b": 128, "prompt": 32, "launches": launches, "tokens": seq[0, 32:].tolist(),
          "device_ms_per_step": step_ms, "k2_device_ms_per_step": k2_ms,
          "k2_share": None if step_ms is None else k2_ms / step_ms, "kernels_per_step": kernels,
          "tok_s": 128 * 16 / run_s, "run_s": runs})
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ ViT encode path


VIT_ENCODES = 4  # encodes in one timed run


def vit_cfg(n_layers, dtype):
    """bench.py:304's ViT-B/224: ``VIT_BASE_CONFIG`` without dropout (224 px,
    patch 16, emb 768, 12 heads of 64: s 197)."""
    from llm_quest_tpu_torch.config import VIT_BASE_CONFIG

    return dict(VIT_BASE_CONFIG, n_layers=n_layers, drop_rate=0.0, dtype=dtype)


def vit_mode_cfgs(cfg, scales):
    """The encode through K7, and through K8 (dynamic, then calibrated static
    scales) and K9 (the static scales, quantized inside the kernel)."""
    int8 = dict(cfg, int8_scores=True)
    return {"bf16": cfg, "int8_dynamic": int8, "int8_static": dict(int8, int8_qk_scales=scales),
            "int8_inkernel": dict(int8, int8_qk_scales=scales, int8_scores_mode="inkernel")}


def images(b, dtype):
    import torch

    return randn(torch.Generator(device=DEVICE).manual_seed(SEED + 1), b, 3, 224, 224, dtype=dtype)


def vit_fp32():
    """ViT-B's widths cut to 2 layers, b 8, fp32: the logits through each
    packed kernel against the plain versions, within LOGIT_TOL."""
    import torch

    from llm_quest_tpu_torch.models import vit

    cfg = vit_cfg(2, torch.float32)
    model = init_model(vit, cfg)
    x = images(8, torch.float32)
    scales = vit.calibrate_int8_scales(model, cfg, x)
    errs = {}
    with torch.inference_mode():
        for name, mode_cfg in vit_mode_cfgs(cfg, scales).items():
            got, ref = vit.apply(model, mode_cfg, x), vit.apply(model, dict(mode_cfg, use_kernels=False), x)
            errs[name] = float((got - ref).abs().max())
    if not all(e <= LOGIT_TOL for e in errs.values()):
        raise AssertionError(f"vit fp32 logits, kernels vs plain: {errs} > {LOGIT_TOL}")
    emit({"phase": "vit_fp32", "layers": 2, "b": 8, "logit_max_abs_err": errs, "logit_tol": LOGIT_TOL,
          "int8_qk_scales": scales})
    del model
    torch.cuda.empty_cache()


def vit_encode(records, card, b=128):
    """The ViT-B/224 encode at full width and depth, b 128, bf16, under
    ``torch.inference_mode``: once in each mode with the launch counts reset
    first (K7, K8 dynamic, K8 static, K9: 12 launches each), then img/s
    (median of 3 timed runs of VIT_ENCODES encodes), MFU, peak memory and,
    for the int8 modes, the logits' distance from the bf16 encode's."""
    import torch

    from llm_quest_tpu_torch.models import vit
    from llm_quest_tpu_torch.training import flops as F

    cfg = vit_cfg(12, torch.bfloat16)
    model = init_model(vit, cfg)
    x = images(b, torch.bfloat16)
    scales = vit.calibrate_int8_scales(model, cfg, x)  # before the reset: it runs K7
    cfgs = vit_mode_cfgs(cfg, scales)
    reset_launches()
    with torch.inference_mode():
        logits = {name: vit.apply(model, mode_cfg, x) for name, mode_cfg in cfgs.items()}
    torch.cuda.synchronize()
    launches = read_launches(VIT, records)
    per_encode = {name: launches[name] for name, *_, paths in KERNELS if VIT in paths}
    if any(n != cfg["n_layers"] for n in per_encode.values()):
        raise AssertionError(f"vit_encode launches {per_encode}, expected {cfg['n_layers']} each")
    for name, out in logits.items():
        if tuple(out.shape) != (b, cfg["num_classes"]) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"vit_encode {name}: bad logits {tuple(out.shape)}")
    ref = logits["bf16"].float()
    flops = F.vit_flops_per_image(cfg)
    modes = {}
    for name, mode_cfg in cfgs.items():
        torch.cuda.reset_peak_memory_stats()

        def encodes(mode_cfg=mode_cfg):
            with torch.inference_mode():
                for _ in range(VIT_ENCODES):
                    vit.apply(model, mode_cfg, x)

        encodes()  # warm
        run_s, runs = timed(encodes, 3)
        img_s = b * VIT_ENCODES / run_s
        modes[name] = {"img_s": img_s, "mfu": F.mfu(img_s, flops), "encode_ms": 1e3 * run_s / VIT_ENCODES,
                       "run_s": runs, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name != "bf16":
            modes[name]["encode_ms_over_bf16"] = modes[name]["encode_ms"] / modes["bf16"]["encode_ms"]
            out = logits[name].float()
            modes[name]["max_abs_dlogits_vs_bf16"] = float((out - ref).abs().max())
            modes[name]["argmax_agreement"] = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    emit({"phase": "vit_encode", "card": card, "dtype": "bfloat16", "layers": cfg["n_layers"], "b": b,
          "launches_per_encode": per_encode, "flops_per_image": flops, "encodes_per_run": VIT_ENCODES,
          "max_abs_logit_bf16": float(ref.abs().max()), "modes": modes})
    del model, logits
    torch.cuda.empty_cache()


def vit_paths(records, card):
    """``vit_fp32`` (kernels against the plain versions, which it runs on
    purpose), then the encode path, checked as a phase."""
    vit_fp32()
    phase(vit_encode, records, card)


# ------------------------------------------------------------ ViT training


class GradRecorder:
    """An optimizer that keeps the gradients it is handed and updates
    nothing: the train step's loss and gradients, read through the entry point."""

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        self.grads = grads
        return state


def vit_train_fp32(b=8):
    """ViT-B's widths cut to 2 layers, b 8, fp32, no dropout: one
    ``make_vit_train_step`` through K7 against the same step through the
    plain versions (``use_kernels=False``), the loss within
    VIT_LOSS_RTOL and every gradient within VIT_GRAD_RTOL of its largest
    (the key biases', zero in exact arithmetic, of the key weight's)."""
    import torch

    from llm_quest_tpu_torch.kernels import attention
    from llm_quest_tpu_torch.models import vit
    from llm_quest_tpu_torch.training import vit_engine

    cfg = vit_cfg(2, torch.float32)
    model = init_model(vit, cfg)
    batch = {"image": images(b, torch.float32),
             "label": torch.randint(0, cfg["num_classes"], (b,), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                                    device=DEVICE)}
    results = []
    for use_kernels in (True, False):
        rec = GradRecorder()
        step = vit_engine.make_vit_train_step(vit, dict(cfg, use_kernels=use_kernels), rec)
        n = attention.packed_mha.launches
        _, _, loss = step(model, rec.init(model), batch, torch.Generator(device=DEVICE).manual_seed(SEED))
        torch_sync()
        results.append((float(loss), rec.grads, attention.packed_mha.launches - n))
    (loss_k, grads_k, n_k), (loss_p, grads_p, n_p) = results
    if (n_k, n_p) != (cfg["n_layers"], 0):
        raise AssertionError(f"vit_train_fp32: K7 launched {n_k} times with kernels, {n_p} without")
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    grads_k, grads_p = (dict(zip((n for n, _ in model.named_parameters()), g)) for g in (grads_k, grads_p))
    # the key biases' gradient is zero in exact arithmetic (a key bias shifts
    # every score of a row alike): both sides hold rounding noise, held to
    # the key weight's gradient scale
    scale = {n: float(grads_p[n.replace("wk.b", "wk.w")].abs().max()) for n in grads_p}
    grad_err = {n: float((grads_k[n] - grads_p[n]).abs().max()) / scale[n] for n in grads_p}
    worst = max(grad_err, key=grad_err.get)
    if not (loss_err <= VIT_LOSS_RTOL and grad_err[worst] <= VIT_GRAD_RTOL):
        raise AssertionError(f"vit_train_fp32: loss rel err {loss_err}, gradient rel err {grad_err[worst]} ({worst})")
    key_bias = max(float(grads_p[n].abs().max()) / scale[n] for n in grads_p if n.endswith("wk.b"))
    emit({"phase": "vit_train_fp32", "layers": 2, "b": b, "loss": loss_k, "loss_rel_err": loss_err,
          "grad_max_rel_err": grad_err[worst], "grad_max_rel_err_leaf": worst, "key_bias_grad_rel": key_bias,
          "loss_rtol": VIT_LOSS_RTOL, "grad_rtol": VIT_GRAD_RTOL})
    del model, results
    torch.cuda.empty_cache()


def vit_train(records, card, eval_freq=10):
    """The TinyViT CIFAR-10 script's loop (``scripts/vit_training.py``: 12
    layers, 8 heads of 32, b 128, dropout 0.3, its 448 seeded training
    images, VIT_EPOCHS epochs) on the card, the launch counts reset first:
    K7 at d 32 launches 12 times a step; img/s over the whole loop and the
    losses at every ``eval_freq``-th step, finite."""
    import math

    import torch

    from llm_quest_tpu_torch.scripts import vit_training

    lines = []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = vit_training.main(eval_freq=eval_freq, log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(VIT_TRAIN, records)  # TinyViT trains in fp32
    steps = 3 * vit_training.NUM_EPOCH  # 3 whole batches of 128 an epoch
    for name in ("packed_mha_d32", "packed_mha_fwd_bwd_d32"):  # forward and backward
        if launches[name] != 12 * steps:
            raise AssertionError(f"vit_train: {launches[name]} {name} launches in {steps} steps, expected 12 a step")
    if not all(math.isfinite(x) for x in metrics["train_loss"]):
        raise AssertionError(f"vit_train: losses {metrics['train_loss']}")
    emit({"phase": "vit_train", "card": card, "dtype": "float32", "layers": 12, "b": vit_training.BATCH_SIZE,
          "epochs": vit_training.NUM_EPOCH, "steps": steps, "wall_s": wall,
          "img_s": steps * vit_training.BATCH_SIZE / wall, "k7_launches_per_step": launches["packed_mha_d32"] / steps,
          "k7_bwd_launches_per_step": launches["packed_mha_fwd_bwd_d32"] / steps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "train_loss": metrics["train_loss"], "val_acc": metrics["val_acc"], "log": lines[-2:]})
    torch.cuda.empty_cache()


def vit_b_train(records, card, b=128, steps=4):
    """ViT-B/224 (``VIT_BASE_CONFIG``, dropout 0.1) at b 128, bf16, through
    ``make_optimizer`` → ``make_vit_train_step``, launch counts reset first:
    1 warm-up and ``steps`` timed steps, each ended by a device sync; K7
    launches 12 times a step forward (the short-sequence tensor-core kernel)
    and 12 backward (the flash recompute kernels); img/s, MFU by
    ``vit_train_flops_per_image`` against 989 TFLOP/s, peak memory, finite
    losses."""
    import math

    import torch

    from llm_quest_tpu_torch.config import VIT_BASE_CONFIG
    from llm_quest_tpu_torch.models import vit
    from llm_quest_tpu_torch.training import engine, vit_engine
    from llm_quest_tpu_torch.training import flops as F

    cfg = dict(VIT_BASE_CONFIG, dtype=torch.bfloat16)
    model = init_model(vit, cfg)
    optimizer = engine.make_optimizer(3e-4)
    opt_state = optimizer.init(model)
    step = vit_engine.make_vit_train_step(vit, cfg, optimizer)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    batch = {"image": images(b, torch.bfloat16),
             "label": torch.randint(0, cfg["num_classes"], (b,), generator=gen, device=DEVICE)}

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    model, opt_state, loss0 = step(model, opt_state, batch, gen)  # warm-up
    torch.cuda.synchronize()
    losses, step_s = [loss0], []
    for _ in range(steps):
        t0 = time.perf_counter()
        model, opt_state, loss = step(model, opt_state, batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_launches(VIT_B_TRAIN, records)
    losses = [float(x) for x in losses]
    for name in ("packed_mha", "packed_mha_fwd_bwd"):  # forward and backward
        if launches[name] != cfg["n_layers"] * (steps + 1):
            raise AssertionError(f"vit_b_train: {launches[name]} {name} launches in {steps + 1} steps")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"vit_b_train: losses {losses}")
    dt = sum(step_s) / steps
    flops = F.vit_train_flops_per_image(cfg)
    emit({"phase": "vit_b_train", "card": card, "dtype": "bfloat16", "layers": cfg["n_layers"], "b": b,
          "drop_rate": cfg["drop_rate"], "k7_launches_per_step": launches["packed_mha"] / (steps + 1),
          "k7_bwd_launches_per_step": launches["packed_mha_fwd_bwd"] / (steps + 1),
          "losses": losses, "step_ms": dt * 1e3, "step_ms_each": [x * 1e3 for x in step_s], "img_s": b / dt,
          "flops_per_image": flops, "mfu": F.mfu(b / dt, flops), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del model, opt_state
    torch.cuda.empty_cache()


def vit_train_paths(records, card):
    vit_train_fp32()
    vit_train(records, card)
    vit_b_train(records, card)


def ablate_path(records, card):
    """The int8-score ablation's ``main()`` (``scripts/ablate_int8_scores.py``)
    with the launch counts reset first: each variant launches K12 WARMUP +
    N_ITERS times."""
    import torch

    from llm_quest_tpu_torch.scripts import ablate_int8_scores as ab

    reset_launches()
    result = ab.main()
    torch.cuda.synchronize()
    launches = read_launches(ABLATE, records)
    per_variant = {name: launches[name] for name in ("attn_core_bf16", "attn_core_int8")}
    if any(n != ab.WARMUP + ab.N_ITERS for n in per_variant.values()):
        raise AssertionError(f"ablate_int8_scores launches {per_variant}, expected {ab.WARMUP + ab.N_ITERS} each")
    emit({"phase": "ablate_int8_scores", "card": card, "launches": per_variant, "bf16_ms": result["bf16_s"] * 1e3,
          "int8_ms": result["int8_s"] * 1e3, "speedup": result["speedup"], "useful_flops": result["flops"],
          "bf16_tflops": result["flops"] / result["bf16_s"] / 1e12,
          "int8_tflops": result["flops"] / result["int8_s"] / 1e12})


# ------------------------------------------------------------ train paths


def train_cfg(n_layers, dtype):
    """bench.py's train workload: Qwen3-0.6B widths, 16 layers at s = 2048,
    no remat (``bench.py::bench_train_step``)."""
    from llm_quest_tpu_torch.config import qwen3_config_creator

    return dict(
        qwen3_config_creator("temp_dense"), n_layers=n_layers, emb_dim=1024, n_heads=16, num_kv_groups=8,
        hidden_dim=3072, context_length=2048, dtype=dtype, gradient_checkpointing=False,
    )


def hybrid_cfg(n_layers, dtype, capacity_factor=None):
    """``scripts/bench_hybrid_training.py``'s configuration: Qwen3-Next-small
    at s = 2048, no dropout, no remat; exact MoE dispatch, or capacity
    dispatch at ``capacity_factor``."""
    from llm_quest_tpu_torch.config import QWEN3_NEXT_SMALL_CONFIG

    return dict(
        QWEN3_NEXT_SMALL_CONFIG, n_layers=n_layers, context_length=2048, dtype=dtype, p_dropout=0.0,
        gradient_checkpointing=False, moe_capacity_factor=capacity_factor,
    )


def train_batch(b, s):
    import numpy as np
    import torch

    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 32_000, (b, s)), device=DEVICE)
    return {"input_ids": ids, "targets": torch.roll(ids, -1, 1)}


def init_model(model_mod, cfg):
    import torch

    return model_mod.init(cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)


def grads_check(phase, model_mod, cfg, b, s, *, fused=True, invariant=None, loss_fn=None,
                loss_rtol=TRAIN_LOSS_RTOL, grad_rtol=TRAIN_GRAD_RTOL, batch=None):
    """One fp32 step's loss and gradients, kernels vs plain, same weights;
    ``fused``: the fused-head CE (a model without it takes the full logits).
    ``loss_fn(cfg, model, batch)``, when given, is the loss instead of
    ``make_loss_fn``'s; ``batch`` (default ``train_batch(b, s)``) its
    input. ``invariant`` maps the name of a leaf whose gradient
    is zero in exact arithmetic (fp32 noise on both sides, so no relative
    bar) to the leaf that scales it: both its gradients must stay under
    ``grad_rtol`` times that leaf's (plain) gradient."""
    import torch

    from llm_quest_tpu_torch.training import engine

    model = init_model(model_mod, cfg)
    names = [n for n, _ in model.named_parameters()]
    batch = train_batch(b, s) if batch is None else batch
    results = []
    for use_kernels in (True, False):
        run_cfg = dict(cfg, use_kernels=use_kernels)
        if loss_fn is None:
            loss = engine.make_loss_fn(model_mod, run_cfg, fused_head_ce=fused)(model, batch)
        else:
            loss = loss_fn(run_cfg, model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append((float(loss.detach()), [g.detach() for g in grads]))
    (lk, gk), (lp, gp) = results
    loss_rel = abs(lk - lp) / abs(lp)
    if not loss_rel <= loss_rtol:
        raise AssertionError(f"{phase} loss, kernels {lk} vs plain {lp}: rel {loss_rel} > {loss_rtol}")
    worst_name, worst, worst_zero = None, 0.0, 0.0
    by_name = dict(zip(names, gp))
    for name, a, r in zip(names, gk, gp):
        ref_name = invariant(name) if invariant else None
        if ref_name is not None:
            rel = max(float(a.abs().max()), float(r.abs().max())) / float(by_name[ref_name].abs().max())
            if not rel <= grad_rtol:
                raise AssertionError(f"{phase} grad {name} (zero in exact arithmetic): {rel} of {ref_name}'s")
            worst_zero = max(worst_zero, rel)
            continue
        diff, scale = float((a - r).abs().max()), float(r.abs().max())
        rel = diff / scale if scale > 0 else diff  # a leaf no token reached: both must be zero
        if not rel <= grad_rtol:
            raise AssertionError(f"{phase} grad {name}: max |kernel - plain| / max |plain| = {rel} > {grad_rtol}")
        if rel >= worst:
            worst_name, worst = name, rel
    emit({"phase": phase, "layers": cfg["n_layers"], "b": b, "s": s, "loss_kernels": lk, "loss_plain": lp,
          "loss_rel_err": loss_rel, "loss_rtol": loss_rtol, "n_grads": len(names),
          "worst_grad": worst_name, "worst_grad_rel_err": worst, "grad_rtol": grad_rtol,
          **({"worst_zero_grad_ratio": worst_zero} if invariant else {})})
    del model, results
    torch.cuda.empty_cache()


def train_run(phase, model_mod, cfg, records, card, path, per_step, *, add=True, steps=4, b=4, s=2048, fused=True,
              lr=3e-4, make_step=None, batch=None):
    """A bf16 train step through the port's entry points (``make_optimizer``
    → ``make_train_step``, fused-head CE unless not ``fused``; or
    ``make_step(model_mod, cfg, optimizer)``) on ``batch`` (default
    ``train_batch(b, s)``): 1 warm-up and ``steps`` timed
    steps, each ended by a device sync; every kernel of ``per_step`` must
    launch that many times a step, and the loss must be finite and fall."""
    import math

    import torch

    from llm_quest_tpu_torch.training import engine
    from llm_quest_tpu_torch.training import flops as F

    model = init_model(model_mod, cfg)
    optimizer = engine.make_optimizer(lr)
    opt_state = optimizer.init(model)
    if make_step is None:
        step = engine.make_train_step(model_mod, cfg, optimizer, fused_head_ce=fused)
    else:
        step = make_step(model_mod, cfg, optimizer)
    batch = train_batch(b, s) if batch is None else batch

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    model, opt_state, loss0 = step(model, opt_state, batch)  # warm-up
    torch.cuda.synchronize()
    losses, step_s = [loss0], []
    for _ in range(steps):
        t0 = time.perf_counter()
        model, opt_state, loss = step(model, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    dt = sum(step_s) / steps
    launches = read_launches(path, records, add=add)
    losses = [float(x) for x in losses]
    n_steps = steps + 1
    for name, n in per_step.items():
        if launches[name] != n * n_steps:
            raise AssertionError(f"{phase} {name}: {launches[name]} launches in {n_steps} steps, expected {n} per step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} bf16 losses not finite and falling: {losses}")
    tok_s = b * s / dt
    flops_per_token = F.text_train_flops_per_token(cfg, seq_len=s)
    emit({"phase": phase, "card": card, "dtype": "bfloat16", "layers": cfg["n_layers"], "b": b, "s": s, "lr": lr,
          "moe_capacity_factor": cfg.get("moe_capacity_factor"), "fused_head_ce": fused, "launches": launches,
          "launches_per_step": {name: n / n_steps for name, n in launches.items()}, "losses": losses,
          "step_ms": dt * 1e3, "step_ms_each": [x * 1e3 for x in step_s], "tok_s": tok_s,
          "flops_per_token": flops_per_token, "mfu": F.mfu(tok_s, flops_per_token),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del model, opt_state
    torch.cuda.empty_cache()
    return launches, losses


def train_paths(records, card):
    import torch

    from llm_quest_tpu_torch.models import qwen3, qwen3_next

    grads_check("train_fp32", qwen3, train_cfg(2, torch.float32), 1, 2048)
    train_run("train", qwen3, train_cfg(16, torch.bfloat16), records, card, TRAIN,
              {"flash_attention_fwd": 16, "flash_attention_bwd": 16})
    # 4 layers keep one GatedAttention layer (the 4th); s = 512 takes flash
    grads_check("hybrid_fp32", qwen3_next, hybrid_cfg(4, torch.float32), 1, 512)
    hybrid = {"gdn_prefill": 6, "gdn_prefill_bwd": 6, "flash_attention_fwd": 2, "flash_attention_bwd": 2}
    train_run("hybrid_train", qwen3_next, hybrid_cfg(8, torch.bfloat16), records, card, HYBRID, hybrid)
    train_run("hybrid_train", qwen3_next, hybrid_cfg(8, torch.bfloat16, 1.25), records, card, HYBRID, hybrid,
              add=False)


# ------------------------------------------------------------ Gemma-3 path


def gemma_cfg(n_layers, dtype):
    """Gemma-3-270M's published widths (google/gemma-3-270m ``config.json``,
    typed in) on the repo's Gemma-3 architecture: 18 layers, 15 of them SWA
    (window 512, every 6th global), 4/1 heads of 256, about 268 M parameters.
    The one RoPE base is Gemma's local one."""
    return {
        "vocab_size": 262_144, "context_length": 32_768, "emb_dim": 640, "n_layers": n_layers, "n_heads": 4,
        "num_kv_groups": 1, "head_dim": 256, "hidden_dim": 2048, "window_size": GEMMA_WINDOW,
        "local_global_att_ratio": 5, "rope_base": 10_000, "dtype": dtype,
    }


def k4_window_ratio(records):
    """The windowed K4 against the causal one at the same shape: skipping the
    key tiles outside the window must make it at most 0.6× as long (its
    visible work is 0.44×), in the kernels' device time (``device_ms``;
    where the profiler gave no trace, the device time of the whole call,
    whose few torch ops add the same time to both). The CUDA-event ratio
    stands beside it, unchecked: at these speeds the events also time the
    host's work between launches (``k4_host_cost``)."""
    ms = {rec["name"]: rec["device_ms"] for rec in records if "device_ms" in rec}
    event_ms = {rec["name"]: rec["ms"] for rec in records}
    pairs = {"fwd": ("flash_attention_fwd_window", "flash_attention_fwd_causal_d256"),
             "fwd_bwd": ("flash_attention_fwd_bwd_window", "flash_attention_fwd_bwd_causal_d256")}
    ratios = {key: ms[w] / ms[c] for key, (w, c) in pairs.items()}
    event_ratios = {key: event_ms[w] / event_ms[c] for key, (w, c) in pairs.items()}
    work = visible_pairs(GEMMA_K4["s"], GEMMA_WINDOW) / visible_pairs(GEMMA_K4["s"])
    by = "queued_ms" if TC_KERNELS in PROFILER["queued_keys"] else "profiler"
    emit({"phase": "k4_window_ratio", "ms_ratio": ratios, "ms_ratio_by": by, "event_ms_ratio": event_ratios,
          "visible_work_ratio": work, "limit": 0.6})
    if not all(r <= 0.6 for r in ratios.values()):
        raise AssertionError(f"windowed K4 not faster than 0.6x causal: {ratios}")


def k4_host_cost(iters=20):
    """Where a bf16 K4 fwd + bwd call's time goes at one Gemma-3 layer
    (window 512, and causal) and one MiMo-V2-Flash SWA layer (window 128,
    sinks): its CUDA-event ms; the device time of all its work by
    ``queued_ms``; from one profiled run, the device time of the
    tensor-core kernels, of everything the call runs on the card and of its
    largest kernels, and the host ops with the most CPU time of their own
    (µs a call, profiler overhead included); the host's ms to issue one call
    (``iters`` calls back to back, the clock read before the card is waited
    on); and the host µs a call inside the C entry points (``build.launch``
    timed around each: ctypes, the tensor-map encodes, the shared-memory
    attribute and the launches)."""
    import collections

    import torch

    from llm_quest_tpu_torch.kernels import attention as attn
    from llm_quest_tpu_torch.kernels import build

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for name, shape, window, sink in (("gemma_window", GEMMA_K4, GEMMA_WINDOW, False),
                                      ("gemma_causal", GEMMA_K4, None, False),
                                      ("mimo_swa_sink", MIMO_SWA_K4, MIMO_WINDOW, True)):
        b, hq, hkv, s, d = (shape[key] for key in ("b", "hq", "hkv", "s", "d"))
        dv = shape.get("dv", d)
        q = randn(gen, b, hq, s, d, dtype=torch.bfloat16).requires_grad_()
        k = randn(gen, b, hkv, s, d, dtype=torch.bfloat16).requires_grad_()
        v = randn(gen, b, hkv, s, dv, dtype=torch.bfloat16).requires_grad_()
        do = randn(gen, b, hq, s, dv, dtype=torch.bfloat16)
        sk = (randn(gen, hq, scale=0.5) + 5.0).requires_grad_() if sink else None
        leaves = [q, k, v] + ([sk] if sink else [])

        def call(q=q, k=k, v=v, sk=sk, leaves=leaves, do=do, window=window):
            o = attn.flash_attention(q, k, v, window_size=window, sink=sk)
            return torch.autograd.grad(o, leaves, do)

        rec = {"event_ms": cuda_ms(call, iters=iters, warmup=3)}
        rec["queued_all_ms"] = queued_ms(call, iters)
        prof, events = profiled(call, iters, TC_KERNELS)
        if prof is None:  # the profiler gives no trace in this run
            rec["device_tc_ms"] = rec["device_all_ms"] = rec["device_top_us"] = "not measured"
            rec["host_top_self_us"] = "not measured"
        else:
            device = collections.Counter()
            for e in events:
                device[e.name] += e.time_range.elapsed_us() / iters
            rec["device_tc_ms"] = sum(t for n, t in device.items() if TC_KERNELS in n) / 1e3
            rec["device_all_ms"] = sum(device.values()) / 1e3
            rec["device_top_us"] = dict(device.most_common(5))
            host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
            rec["host_top_self_us"] = {e.key: e.self_cpu_time_total / iters for e in host}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        rec["host_issue_ms"] = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        spent, launch = collections.Counter(), build.launch

        def timed_launch(fn, *args):
            t = time.perf_counter()
            launch(fn, *args)
            spent[fn] += (time.perf_counter() - t) * 1e6 / iters

        build.launch = timed_launch
        try:
            for _ in range(iters):
                call()
        finally:
            build.launch = launch
        torch.cuda.synchronize()
        rec["c_entry_us"] = dict(spent)
        out[name] = rec
        del q, k, v, do, sk, leaves
    emit({"phase": "k4_host_cost", "iters": iters, **out})


def gemma_generate_check(model, cfg, ids):
    """fp32: the cached prefill (``sdpa`` on the dense SWA and global masks)
    against the uncached forward through the flash kernels, last-position
    logits within LOGIT_TOL."""
    import torch

    from llm_quest_tpu_torch.models import gemma3

    with torch.inference_mode():
        uncached, _, _ = gemma3.apply(model, cfg, ids)
        cache = gemma3.init_cache(cfg, ids.shape[0], ids.shape[1], device=DEVICE)
        cached, _, _ = gemma3.apply(model, cfg, ids, cache=cache)
    err = float((uncached[:, -1].float() - cached[:, -1].float()).abs().max())
    if not err <= LOGIT_TOL:
        raise AssertionError(f"gemma fp32 cached vs uncached (flash) logits: max abs err {err} > {LOGIT_TOL}")
    return err


def gemma_paths(records, card):
    """Gemma-3-270M: the fp32 check (6 layers, 5 SWA + 1 global, b 2, s 1024:
    loss and gradients kernels vs plain, cached vs flash logits), the bf16
    train step at full depth and the bf16 cached generation."""
    import torch

    from llm_quest_tpu_torch.models import gemma3

    fp32 = gemma_cfg(6, torch.float32)
    # a shift common to every key adds one constant to a row's scores, which
    # the softmax cancels: the k-norm shifts' gradients are zero but for noise
    grads_check("gemma_fp32", gemma3, fp32, 2, 1024, fused=False,
                invariant=lambda n: n.replace(".shift", ".scale") if n.endswith("k_norm.shift") else None)
    model = init_model(gemma3, fp32)
    err = gemma_generate_check(model, fp32, ids_on_card(1, 700))
    emit({"phase": "gemma_fp32_cached", "layers": 6, "prompt": 700, "logit_max_abs_err": err, "logit_tol": LOGIT_TOL})
    del model
    torch.cuda.empty_cache()

    per_step = {"flash_attention_fwd_window": 15, "flash_attention_fwd_bwd_window": 15,
                "flash_attention_fwd_causal_d256": 3, "flash_attention_fwd_bwd_causal_d256": 3,
                "flash_attention_fwd": 18, "flash_attention_bwd": 18}
    cfg = gemma_cfg(18, torch.bfloat16)
    # 1e-4: at 3e-4 Adam's first steps overshoot on the N(0, 1) tied table (loss ~120)
    train_run("gemma_train", gemma3, cfg, records, card, GEMMA, per_step, fused=False, lr=1e-4)

    # cached generation: b 1, a 300-token prompt, 16 greedy tokens (the cache
    # branch runs sdpa on the dense masks, as JAX's flash_ok=cache is None)
    model = init_model(gemma3, cfg)
    ids = ids_on_card(1, 300)
    reset_launches()
    seq = generate(gemma3, model, cfg, ids, 16)
    torch.cuda.synchronize()
    launches = {name: launch_count(spec) for name, spec, *_ in KERNELS}
    if tuple(seq.shape) != (1, ids.shape[1] + 16) or not bool(((seq >= 0) & (seq < cfg["vocab_size"])).all()):
        raise AssertionError(f"gemma generation: bad sequences {tuple(seq.shape)}")
    rates = serve_rates(gemma3, model, cfg, ids, max_gen=16)
    emit({"phase": "gemma_generate", "card": card, "dtype": "bfloat16", "layers": 18, "b": 1, "prompt": 300,
          "max_gen": 16, "tokens": seq[0, -16:].tolist(), "launches": launches, **rates})
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ MiMo-V2-Flash path


def mimo_cfg(n_layers, dtype):
    """``MIMO_V2_SMALL_CONFIG`` at full width, ``context_length`` set to the
    sequence length as ``scripts/mimo_training.py`` does (it lengthens only
    the RoPE tables)."""
    from llm_quest_tpu_torch.config import MIMO_V2_SMALL_CONFIG

    return dict(MIMO_V2_SMALL_CONFIG, n_layers=n_layers, context_length=2048, dtype=dtype)


def mimo_paths(records, card):
    """MiMo-V2-Flash small: the fp32 check (6 layers: GA, 4 SWA with sinks, GA;
    b 1, s 512: the MTP loss and every gradient through the kernels against
    the plain versions, with the same routing), then the bf16 12-layer
    train step at b 4, s 2048 through ``make_mimo_train_step``: K4 forward
    and backward 14 times a step (11 windowed with sinks: 9 SWA layers and
    2 MTP blocks; 3 causal GA layers)."""
    import torch

    from llm_quest_tpu_torch.models import mimo_v2_flash as mimo
    from llm_quest_tpu_torch.training import mtp_engine

    counts = []

    def loss_fn(cfg, model, batch):
        loss, aux = mimo.loss(model, cfg, batch["input_ids"], batch["targets"])
        counts.append(torch.stack(aux["moe_counts"]))
        return loss

    grads_check("mimo_fp32", mimo, mimo_cfg(6, torch.float32), 1, 512, loss_fn=loss_fn, loss_rtol=1e-5,
                grad_rtol=1e-4)
    if not torch.equal(counts[0], counts[1]):  # a near-tie routed one token to another expert
        raise AssertionError(f"mimo_fp32: expert counts differ, kernels vs plain:\n{counts[0]}\n{counts[1]}")

    per_step = {"flash_attention_fwd": 14, "flash_attention_bwd": 14,
                "flash_attention_fwd_window_sink_dv32": 11, "flash_attention_fwd_bwd_window_sink_dv32": 11,
                "flash_attention_fwd_causal_dv32": 3, "flash_attention_fwd_bwd_causal_dv32": 3,
                "flash_attention_softcap_sink": 11}
    cfg = mimo_cfg(12, torch.bfloat16)
    launches, losses = train_run("mimo_train", mimo, cfg, records, card, MIMO, per_step, fused=False,
                                 make_step=mtp_engine.make_mimo_train_step)
    emit({"phase": "mimo_train_launches", "k4_fwd": launches["flash_attention_fwd"],
          "k4_fwd_window_sink": launches["flash_attention_fwd_window_sink_dv32"],
          "k4_fwd_causal": launches["flash_attention_fwd_causal_dv32"], "k4_bwd": launches["flash_attention_bwd"],
          "moe_host_syncs_per_step": sum(mimo.is_moe_layer(cfg, i) for i in range(cfg["n_layers"])),
          "final_loss": losses[-1]})


# ------------------------------------------------------------ DeepSeek-V3 path


def dsv3_cfg(n_layers, dtype):
    """``DEEPSEEK_SMALL_CONFIG`` at full width (q_rank 1536, the default),
    ``context_length`` set to the sequence length as
    ``scripts/deepseek_training.py`` does (it lengthens only the RoPE
    tables); ``n_layers`` below 12 keeps the 3 dense layers first."""
    from llm_quest_tpu_torch.config import DEEPSEEK_SMALL_CONFIG

    return dict(DEEPSEEK_SMALL_CONFIG, n_layers=n_layers, context_length=2048, dtype=dtype)


def mtp_batch(b, s, seed=SEED):
    """b rows of s random ids through the MTP collator (its 1-shifted targets
    and 2 pre-shifted pairs), on the card."""
    import numpy as np

    from llm_quest_tpu_torch.data.datasets import collate_function_mtp
    from llm_quest_tpu_torch.training.engine import as_tensors

    rows = np.random.default_rng(seed).integers(0, 50_000, (b, s)).tolist()
    return as_tensors(collate_function_mtp(rows, 2), DEVICE)


def dsv3_paths(records, card):
    """DeepSeek-V3 small: the fp32 check (5 layers: 3 dense, 2 MoE; b 1, s
    512: the MTP loss and every gradient through the kernels against the
    plain versions, with the same routing), the bf16 12-layer train step at
    b 4, s 2048 through ``make_deepseek_train_step`` (K4 at (96, 64) forward
    and backward 14 times a step: 12 layers and 2 MTP blocks), then cached
    generation: fp32 tokens against the uncached oracle at 2 layers, and the
    bf16 12-layer model's tok/s and TTFT."""
    import types

    import torch

    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import deepseek_v3 as dsv3
    from llm_quest_tpu_torch.ops import moe as moe_ops
    from llm_quest_tpu_torch.training import mtp_engine

    counts = []

    def loss_fn(cfg, model, batch):
        loss, aux = dsv3.loss(model, cfg, batch["input_ids"], batch["targets"], batch["shifted_inputs"],
                              batch["shifted_targets"])
        counts.append(torch.stack(aux["moe_counts"]))
        return loss

    # wk_up's bias adds one vector to every key of a head, so one constant
    # to each row's scores, which the softmax cancels: its gradients are zero
    # but for noise (the decoupled key's bias is RoPE'd per position: not so)
    grads_check("dsv3_fp32", dsv3, dsv3_cfg(5, torch.float32), 1, 512, loss_fn=loss_fn, loss_rtol=1e-5,
                grad_rtol=1e-4, batch=mtp_batch(1, 512),
                invariant=lambda n: n.replace(".b", ".w") if n.endswith("att.wk_up.b") else None)
    if not torch.equal(counts[0], counts[1]):  # a near-tie routed one token to another expert
        raise AssertionError(f"dsv3_fp32: expert counts differ, kernels vs plain:\n{counts[0]}\n{counts[1]}")

    # the train step, its bias fold recording each step's max_vio (the mean
    # over the MoE layers of (max - mean) / mean of the expert counts)
    vios = []

    def fold(params, cfg, moe_counts):
        vios.append(torch.stack([moe_ops.max_violation(c) for c in moe_counts]).mean())
        return dsv3.update_moe_biases(params, cfg, moe_counts)

    step_model = types.SimpleNamespace(loss=dsv3.loss, update_moe_biases=fold)
    per_step = {"flash_attention_fwd": 14, "flash_attention_bwd": 14,
                "flash_attention_fwd_causal_d96_dv64": 14, "flash_attention_fwd_bwd_causal_d96_dv64": 14}
    cfg = dsv3_cfg(12, torch.bfloat16)
    launches, losses = train_run(
        "dsv3_train", dsv3, cfg, records, card, DSV3, per_step, fused=False, batch=mtp_batch(4, 2048),
        make_step=lambda _, cfg, opt: mtp_engine.make_deepseek_train_step(step_model, cfg, opt))
    emit({"phase": "dsv3_train_launches", "k4_fwd": launches["flash_attention_fwd"],
          "k4_bwd": launches["flash_attention_bwd"], "max_vio_last_step": float(vios[-1]),
          "max_vio_each_step": [float(v) for v in vios], "moe_host_syncs_per_step": cfg["n_layers"] - cfg["num_ffn"],
          "final_loss": losses[-1]})

    # cached generation: the cache holds k at 96 and v at 64 and the calls
    # run sdpa (JAX's flash_ok=cache is None); the uncached oracle runs K4
    fp32 = dsv3_cfg(2, torch.float32)
    model = init_model(dsv3, fp32)
    ids = ids_on_card(1, 300)
    cached = generate(dsv3, model, fp32, ids, 16)
    uncached = gen.generate_loop_uncached(dsv3, model, fp32, ids, max_gen=16)
    if not torch.equal(cached, uncached):
        raise AssertionError(f"dsv3 fp32 cached vs uncached tokens differ:\n{cached[0, -16:]}\n{uncached[0, -16:]}")
    emit({"phase": "dsv3_generate_fp32", "layers": 2, "b": 1, "prompt": 300, "greedy_tokens_equal": 16})
    del model
    torch.cuda.empty_cache()

    model = init_model(dsv3, cfg)
    reset_launches()
    seq = generate(dsv3, model, cfg, ids, 16)
    torch.cuda.synchronize()
    launches = {name: launch_count(spec) for name, spec, *_ in KERNELS}
    if tuple(seq.shape) != (1, ids.shape[1] + 16) or not bool(((seq >= 0) & (seq < cfg["vocab_size"])).all()):
        raise AssertionError(f"dsv3 generation: bad sequences {tuple(seq.shape)}")
    rates = serve_rates(dsv3, model, cfg, ids, max_gen=16)
    emit({"phase": "dsv3_generate", "card": card, "dtype": "bfloat16", "layers": 12, "b": 1, "prompt": 300,
          "max_gen": 16, "tokens": seq[0, -16:].tolist(), "launches": launches, **rates})
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ context-parallel path


CP_SEQ = 8192  # the long-context shape CP exists for, b 1
CP_FP32_SEQ = 1024
CP_FALLBACK_SEQ = 300  # 300 % 8 != 0: the sequence will not shard


def cp_group():
    """The context-parallel group at world 1, made in this process from a
    local store (no network): the ring is one diagonal block."""
    import torch.distributed as dist

    from llm_quest_tpu_torch.parallel import init_cp_group

    return init_cp_group(0, 1, store=dist.HashStore(), backend=CP_BACKEND)


def cp_cfg(n_layers, dtype, group, s=CP_SEQ):
    """``train_cfg``'s Qwen3-0.6B widths under ``cfg["context_parallel"]``,
    ``context_length`` s (it lengthens only the RoPE tables)."""
    return dict(train_cfg(n_layers, dtype), context_length=max(s, 2048), context_parallel={"group": group})


def without_cp(cfg):
    return {key: val for key, val in cfg.items() if key != "context_parallel"}


def cp_fp32(group):
    """2 layers, b 1, s 1024, fp32, fused-head CE: the CP loss and gradients
    (the rank's slice through ``make_value_and_grad``: the ring, K5) against
    the CP step on the plain versions and against the step without CP (K4)."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn
    from llm_quest_tpu_torch.models import qwen3
    from llm_quest_tpu_torch.parallel import shard_batch
    from llm_quest_tpu_torch.training import engine

    cfg = cp_cfg(2, torch.float32, group, CP_FP32_SEQ)
    model = init_model(qwen3, cfg)
    batch = train_batch(1, CP_FP32_SEQ)
    runs = {"cp_kernels": (cfg, shard_batch(batch, group)),
            "cp_plain": (dict(cfg, use_kernels=False), shard_batch(batch, group)),
            "no_cp": (without_cp(cfg), batch)}
    results, counts = {}, {}
    for name, (run_cfg, run_batch) in runs.items():
        reset_launches()
        results[name] = engine.make_value_and_grad(qwen3, run_cfg, fused_head_ce=True)(model, run_batch)
        torch_sync()
        counts[name] = {"k5": attn.flash_attention_with_lse.launches, "k5_bwd": attn.flash_attention_with_lse.bwd_launches,
                        "k4": attn.flash_attention.launches, "k4_bwd": attn.flash_attention_bwd.launches}
    if counts["cp_kernels"] != {"k5": 2, "k5_bwd": 2, "k4": 0, "k4_bwd": 0} or counts["no_cp"]["k4"] != 2:
        raise AssertionError(f"cp_fp32 launches: {counts}")
    names = [n for n, _ in model.named_parameters()]
    report = {}
    loss_k, grads_k = results["cp_kernels"]
    for other in ("cp_plain", "no_cp"):
        loss_o, grads_o = results[other]
        loss_rel = abs(float(loss_k) - float(loss_o)) / abs(float(loss_o))
        worst, worst_name = 0.0, None
        for name, a, r in zip(names, grads_k, grads_o):
            scale = float(r.abs().max())
            rel = float((a - r).abs().max()) / scale if scale > 0 else float(a.abs().max())
            if rel >= worst:
                worst, worst_name = rel, name
        if not (loss_rel <= CP_LOSS_RTOL and worst <= CP_GRAD_RTOL):
            raise AssertionError(f"cp_fp32 against {other}: loss rel {loss_rel}, grad {worst_name} rel {worst}")
        report[other] = {"loss": float(loss_o), "loss_rel_err": loss_rel, "worst_grad": worst_name,
                         "worst_grad_rel_err": worst}
    emit({"phase": "cp_fp32", "world": 1, "layers": 2, "b": 1, "s": CP_FP32_SEQ, "loss_kernels": float(loss_k),
          "against": report, "launches": counts, "loss_rtol": CP_LOSS_RTOL, "grad_rtol": CP_GRAD_RTOL})
    del model, results
    torch.cuda.empty_cache()


def cp_fallback(records, group):
    """A 16-layer forward at the same widths with equal head counts (16/16),
    fp32, b 2, s 300 under CP: the batch will not shard, so each layer takes
    the short-sequence kernel (K6, causal, 16 launches); the logits against
    the same forward with ``use_fused_mha`` False (K4); then tok/s (median of
    3 timed forwards) and peak memory."""
    import torch

    from llm_quest_tpu_torch.models import qwen3
    from llm_quest_tpu_torch.parallel import shard_batch

    cfg = dict(cp_cfg(16, torch.float32, group, CP_FALLBACK_SEQ), num_kv_groups=16)
    model = init_model(qwen3, cfg)
    batch = shard_batch(train_batch(2, CP_FALLBACK_SEQ), group)
    if "position_ids" in batch:
        raise AssertionError("cp_fallback: a 300-token batch was sharded")
    with torch.inference_mode():
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        got, _, _ = qwen3.apply(model, cfg, batch["input_ids"])
        torch_sync()
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = read_launches(CP_FALLBACK, records)
        ref, _, _ = qwen3.apply(model, dict(cfg, use_fused_mha=False), batch["input_ids"])
        run_s, runs = timed(lambda: qwen3.apply(model, cfg, batch["input_ids"]), 3)
    if launches["fused_mha_causal"] != 16:
        raise AssertionError(f"cp_fallback: K6 launched {launches['fused_mha_causal']} times, expected 16")
    err = float((got.float() - ref.float()).abs().max())
    if not err <= LOGIT_TOL:
        raise AssertionError(f"cp_fallback logits, K6 vs K4: max abs err {err} > {LOGIT_TOL}")
    emit({"phase": "cp_fallback", "layers": 16, "heads": [16, 16], "b": 2, "s": CP_FALLBACK_SEQ, "dtype": "float32",
          "k6_launches": launches["fused_mha_causal"], "logit_max_abs_err": err, "logit_tol": LOGIT_TOL,
          "forward_ms": run_s * 1e3, "run_s": runs, "tok_s": 2 * CP_FALLBACK_SEQ / run_s, "peak_mem_gb": peak})
    del model
    torch.cuda.empty_cache()


def cp_paths(records, card):
    """Context-parallel training of the dense Qwen3 at world 1: cp_fp32,
    cp_train (16 layers, b 1, s 8192, bf16, beside the same step without CP)
    and cp_fallback."""
    import torch
    import torch.distributed as dist

    from llm_quest_tpu_torch.models import qwen3
    from llm_quest_tpu_torch.parallel import shard_batch

    group = cp_group()
    try:
        cp_fp32(group)
        cfg = cp_cfg(16, torch.bfloat16, group)
        per_step = {"flash_attention_with_lse_causal": 16, "flash_attention_with_lse_fwd_bwd_causal": 16,
                    "flash_attention_fwd": 0, "flash_attention_bwd": 0}
        _, cp_losses = train_run("cp_train", qwen3, cfg, records, card, CP_TRAIN, per_step, b=1, s=CP_SEQ,
                                 batch=shard_batch(train_batch(1, CP_SEQ), group))
        _, ref_losses = train_run("cp_train_reference", qwen3, without_cp(cfg), records, card, TRAIN,
                                  {"flash_attention_fwd": 16, "flash_attention_bwd": 16}, add=False, b=1, s=CP_SEQ)
        rel = max(abs(a - r) / abs(r) for a, r in zip(cp_losses, ref_losses))
        emit({"phase": "cp_train_vs_reference", "cp_losses": cp_losses, "reference_losses": ref_losses,
              "max_rel_diff": rel, "tol": TOL["bfloat16"]})
        if not rel <= TOL["bfloat16"]:
            raise AssertionError(f"cp_train losses {cp_losses} vs the step without CP {ref_losses}")
        cp_fallback(records, group)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ serving paths


def ids_on_card(b, s, seed=SEED):
    import numpy as np
    import torch

    return torch.as_tensor(np.random.default_rng(seed).integers(0, 32_000, (b, s)), device=DEVICE)


def text_int8_cfg(n_layers, dtype):
    """Qwen3.5-0.8B's text model (``bench.py:129``'s int8 decode cell) with
    the int8 KV cache."""
    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG

    return dict(QWEN3_5_08B_CONFIG, n_layers=n_layers, dtype=dtype, kv_quant="int8")


def next_serve_cfg(n_layers, dtype):
    """Qwen3-Next-small as published in the JAX package's config (context 512)."""
    from llm_quest_tpu_torch.config import QWEN3_NEXT_SMALL_CONFIG

    return dict(QWEN3_NEXT_SMALL_CONFIG, n_layers=n_layers, dtype=dtype, p_dropout=0.0)


def generate(entry, model, cfg, ids, max_gen):
    from llm_quest_tpu_torch.inference import generate as gen

    return gen.generate_kv_cache(entry, model, cfg, ids, max_gen=max_gen, eos_ids=-1, pad_id=0)["sequences"]


def last_prefill_logits(mod, model, cfg, ids):
    import torch

    apply = mod.apply_text if hasattr(mod, "apply_text") else mod.apply
    with torch.inference_mode():
        logits, _, _ = apply(model, cfg, ids, cache=mod.init_cache(cfg, ids.shape[0], ids.shape[1], device=DEVICE))
    return logits[:, -1].float()


def serve_check_fp32(phase, mod, entry, model, cfg, ids, max_gen=16):
    """fp32, the same int8 model through the kernels and through the plain
    versions: prefill logits within INT8_LOGIT_TOL and equal greedy tokens."""
    import torch

    plain = dict(cfg, use_kernels=False)
    err = float((last_prefill_logits(mod, model, cfg, ids) - last_prefill_logits(mod, model, plain, ids)).abs().max())
    if not err <= INT8_LOGIT_TOL:
        raise AssertionError(f"{phase}: prefill logits, kernels vs plain, max abs err {err} > {INT8_LOGIT_TOL}")
    seq_k, seq_p = generate(entry, model, cfg, ids, max_gen), generate(entry, model, plain, ids, max_gen)
    if not torch.equal(seq_k, seq_p):
        raise AssertionError(f"{phase}: greedy tokens differ, kernels vs plain:\n{seq_k[:, -max_gen:]}\n{seq_p[:, -max_gen:]}")
    emit({"phase": phase, "layers": cfg["n_layers"], "b": ids.shape[0], "prompt": ids.shape[1],
          "logit_max_abs_err": err, "logit_tol": INT8_LOGIT_TOL, "greedy_tokens_equal": max_gen})


def serve_rates(entry, model, cfg, ids, max_gen=64):
    """Generated tok/s (median of 3 whole calls) and TTFT (median of 5 calls
    generating one token), each call ended by a device sync."""
    run_s, runs = timed(lambda: generate(entry, model, cfg, ids, max_gen), 3)
    ttft_s, _ = timed(lambda: generate(entry, model, cfg, ids, 1), 5)
    return {"tok_s": ids.shape[0] * max_gen / run_s, "ttft_ms": ttft_s * 1e3, "run_s": runs}


def int8_copy_ms(model):
    """Device time of converting every int8 weight matrix that a decode step
    converts to bf16 once (the linears, the tied table, the shared expert;
    not the routed expert stacks, which K11 reads as int8)."""
    import torch

    mats = [t for n, t in model.state_dict().items() if t.dtype == torch.int8 and ".experts." not in n]
    return cuda_ms(lambda: [t.to(torch.bfloat16) for t in mats], iters=5, warmup=1), sum(map(nbytes, mats))


QGMM_KEY = "quantized_gmm"  # the name stem of K11's kernels (csrc/quantized_gmm.cu, csrc/quantized_gmm_tc.cu)


def call_device_ms(fn, iters=3, keys=(GDN_TC_KEY, QGMM_KEY)):
    """Per call of ``fn``, from one ``torch.profiler`` trace: the device
    time of the kernels whose names contain each of ``keys`` (K1's forward
    and K11's), of all its work, and the number of kernels it launched (the
    copies and fills left out); Nones where the profiler gives none."""
    _, events = profiled(fn, iters, GDN_TC_KEY)
    if not events:
        return (None,) * (len(keys) + 2)
    ms = [sum(e.time_range.elapsed_us() for e in events if key in e.name) / 1e3 / iters for key in (*keys, "")]
    kernels = sum(not e.name.startswith(("Memcpy", "Memset")) for e in events) / iters
    return (*ms, kernels)


def per_step(short, long, steps):
    """(long - short) / steps for each pair of readings (None where either is)."""
    return [None if a is None or b is None else (b - a) / steps for a, b in zip(short, long)]


def serve_path(phase, path, make_model, entry, cfg_bf16, cfg_int8, ids, records, card, quant_options):
    """The bf16 model's rates, then the same weights quantized in place
    (``quantize_params_int8``) driven once with the launch counts reset, then
    timed; MBU from ``training/flops.py``'s byte count at the mean context."""
    import torch

    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8
    from llm_quest_tpu_torch.training import flops as F

    max_gen = 64
    kv_len = ids.shape[1] + max_gen // 2
    model = make_model(cfg_bf16)
    bf16 = serve_rates(entry, model, cfg_bf16, ids)
    bf16["mbu"] = F.mbu(bf16["tok_s"], F.decode_bytes_per_token(model, cfg_bf16, kv_len=kv_len, batch=ids.shape[0]))
    quantize_params_int8(model, **quant_options)
    torch.cuda.empty_cache()
    reset_launches()
    seq = generate(entry, model, cfg_int8, ids, max_gen)
    torch.cuda.synchronize()
    launches = read_launches(path, records)
    if tuple(seq.shape) != (ids.shape[0], ids.shape[1] + max_gen) or not bool(
            ((seq >= 0) & (seq < cfg_int8["vocab_size"])).all()):
        raise AssertionError(f"{phase}: bad sequences {tuple(seq.shape)}")
    tc = {name: getattr(wrapper((module, name)), counter) for module, name, total, counter in TC_COUNTERS
          if total == "launches"}
    int8 = serve_rates(entry, model, cfg_int8, ids)
    # a TTFT call (the prefill and one token), then a 17-token call: the
    # device time a decode step, and the kernels it launches (K2's step with
    # q/k at their own heads and beta as it comes: no repeat, no cast), are
    # their difference over 16 steps
    ttft = call_device_ms(lambda: generate(entry, model, cfg_int8, ids, 1), keys=(GDN_TC_KEY, QGMM_KEY, K2_KEY))
    int8["k1_fwd_device_ms"], int8["k11_device_ms"], _, int8["ttft_device_ms"], _ = ttft
    long = call_device_ms(lambda: generate(entry, model, cfg_int8, ids, 17), iters=1,
                          keys=(GDN_TC_KEY, QGMM_KEY, K2_KEY))
    _, int8["k11_device_ms_per_step"], int8["k2_device_ms_per_step"], int8["device_ms_per_step"], \
        int8["kernels_per_step"] = per_step(ttft, long, 16)
    bytes_per_token = F.decode_bytes_per_token(model, cfg_int8, kv_len=kv_len, batch=ids.shape[0])
    int8["mbu"] = F.mbu(int8["tok_s"], bytes_per_token)
    copy_ms, int8_bytes = int8_copy_ms(model)
    emit({"phase": phase, "card": card, "dtype": "bfloat16", "layers": cfg_int8["n_layers"], "b": ids.shape[0],
          "prompt": ids.shape[1], "max_gen": max_gen, "launches": launches, "tc_launches": tc,
          "tokens": seq[0, -64:-48].tolist(),
          "int8": int8, "bf16": bf16, "decode_bytes_per_token": bytes_per_token, "mbu_kv_len": kv_len,
          "int8_weight_bytes": int8_bytes, "int8_to_bf16_copy_ms_per_step": copy_ms,
          "step_ms": 1e3 * ids.shape[0] / int8["tok_s"]})
    del model
    torch.cuda.empty_cache()


def text_model(cfg):
    import torch

    from llm_quest_tpu_torch.models import qwen3_5

    return qwen3_5.init_text(cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)


def serving_checks_fp32():
    """The int8 serving paths at 4 layers in fp32, kernels against plain (the
    plain versions run here, outside ``phase``): Qwen3.5-0.8B text and
    Qwen3-Next-small. The tables stay fp32 (an int8 table gathers bf16 rows,
    which would make them bf16 checks)."""
    import torch

    from llm_quest_tpu_torch.models import qwen3_5, qwen3_next
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    text = text_int8_cfg(4, torch.float32)
    model = quantize_params_int8(text_model(text))
    reset_launches()
    serve_check_fp32("int8_generate_fp32", qwen3_5, qwen3_5.TextOnly, model, text, ids_on_card(1, 32))
    check_routes("int8_generate_fp32", bf16=False)  # K1, K10 and K11 on the SIMT kernels
    nxt = next_serve_cfg(4, torch.float32)
    model = quantize_params_int8(init_model(qwen3_next, nxt))
    serve_check_fp32("next_serve_fp32", qwen3_next, qwen3_next, model, nxt, ids_on_card(2, 64))
    check_routes("next_serve_fp32", bf16=False)
    del model
    torch.cuda.empty_cache()


def serving_paths(records, card):
    """Qwen3.5-0.8B int8 text generation (int8 linears, tied table and KV
    cache; K1, K2, K10) and Qwen3-Next-small int8 cached decode (int8
    linears and expert stacks; K1, K2 at dk 64, K11), bf16, after
    ``serving_checks_fp32``."""
    import torch

    from llm_quest_tpu_torch.models import qwen3_5, qwen3_next

    text_bf16 = {k: v for k, v in text_int8_cfg(24, torch.bfloat16).items() if k != "kv_quant"}
    serve_path("int8_generate", INT8_GENERATE, text_model, qwen3_5.TextOnly, text_bf16,
               text_int8_cfg(24, torch.bfloat16), ids_on_card(1, 32), records, card, {"quantize_embeddings": True})
    nxt = next_serve_cfg(8, torch.bfloat16)
    serve_path("next_serve", NEXT_SERVE, lambda cfg: init_model(qwen3_next, cfg), qwen3_next, nxt, nxt,
               ids_on_card(4, 300), records, card, {})


# ------------------------------------------------- continuous-batching engine


SAMPLERS = (dict(temp=0.0), dict(temp=0.8, top_k=50), dict(temp=0.7, top_p=0.9), dict(temp=1.0, min_p=0.05))
ENGINE_REQUESTS = 48
ENGINE_CHECK_ROWS = 4  # first-wave rows whose admission logits are held to a b = 1 prefill
ENGINE_BAR_LAYERS = 4  # the depth at which the port's tests hold bf16 logits to BF16_LOGIT_BAR
ENGINE_AGREE_ROWS = 4  # greedy requests compared with generate_kv_cache, over their first ENGINE_AGREE_TOKENS
ENGINE_AGREE_TOKENS = 16
ENGINE_PROFILE_STEPS = 8  # the profiled chunk's steps
ENGINE_EMPTY_SLOTS = 8  # slots the int8 serve's plain check leaves empty, so K10 sees fully masked rows
BF16_LOGIT_BAR = 5e-2  # of max |b = 1 logits|: the port's tests' bf16 bar (test_torch_qwen3_5.py)
# the 24-layer bf16 engine against the same calls through the plain versions (``use_kernels`` False, the
# same batch shapes): admission and decode-step logits within ENGINE_PLAIN_BAR × max |plain|, beside a
# control, the plain call with ENGINE_DROP_TOKENS real tokens of every row masked out, which must read
# beyond the bar. Set from readings on an H100: the kernels' outputs sit within 2e-3 of plain tile by
# tile at these shapes, and 24 bf16 layers of random weights amplify that to 8.6-10.6 % of max |plain|
# at admission and 3.6-3.9 % at a decode step (a b = 1 prefill of the same prompts, through the same
# kernels, is 7.1-7.7 % from the b = k one); the control reads 122-129 % at admission and 56-82 % at a
# decode step. The bar sits twice above the largest reading.
ENGINE_PLAIN_BAR = 0.2
ENGINE_DROP_TOKENS = 16
# Qwen3.5-0.8B's depth in engine_serving, engine_chunked_prefill and engine_vlm: cut from 24 to 12 layers
# (3 attention layers, 9 GDN) so that the MoE paths fit the run's time; full width
ENGINE_LAYERS = 12


def engine_traffic(kind):
    """``bench_serving``'s uniform traffic (48 requests, 32-token prompts,
    budgets U[16, 64], seed 0) or ``bench_serving_hetero``'s (prompts
    U[8, 200], budgets U[16, 64], seed 1, the four samplers in turn):
    [(ids, max_gen, sampler kwargs)]."""
    import numpy as np

    if kind == "uniform":
        rng = np.random.default_rng(0)
        ids = rng.integers(1, 32_000, (ENGINE_REQUESTS, 32))
        gens = rng.integers(16, 65, ENGINE_REQUESTS)
        return [(list(map(int, ids[i])), int(gens[i]), {}) for i in range(ENGINE_REQUESTS)]
    rng = np.random.default_rng(1)
    lens = rng.integers(8, 201, ENGINE_REQUESTS)
    gens = rng.integers(16, 65, ENGINE_REQUESTS)
    return [(list(map(int, rng.integers(1, 32_000, n))), int(g), SAMPLERS[i % len(SAMPLERS)])
            for i, (n, g) in enumerate(zip(lens, gens))]


def model_module(model):
    """The port's module of ``model`` (``models.qwen3_5`` for its text model)."""
    from llm_quest_tpu_torch.models import deepseek_v3, gemma3, mimo_v2_flash, qwen3, qwen3_next

    for mod, cls in ((qwen3, qwen3.Qwen3), (qwen3_next, qwen3_next.Qwen3Next), (gemma3, gemma3.Gemma3),
                     (deepseek_v3, deepseek_v3.DeepSeekV3), (mimo_v2_flash, mimo_v2_flash.MiMoV2Flash)):
        if isinstance(model, cls):
            return mod
    from llm_quest_tpu_torch.models import qwen3_5

    return qwen3_5


def entry_of(model):
    """What the engine and ``generate_kv_cache`` drive ``model`` through: its
    module, or ``qwen3_5.TextOnly`` for Qwen3.5's text model."""
    mod = model_module(model)
    return mod.TextOnly if hasattr(mod, "TextOnly") else mod


def engine_for(model, cfg, kind, **kw):
    from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine

    shape = (dict(n_slots=32, max_len=128, decode_chunk=64, prefill_buckets=(32,)) if kind == "uniform" else
             dict(n_slots=32, max_len=384, decode_chunk=64, prefill_buckets=(32, 64, 256),
                  per_request_sampling=kind == "hetero"))
    return ContinuousBatchingEngine(entry_of(model), model, cfg, eos_ids=-1, pad_id=0, **{**shape, **kw})


def drive(engine, traffic, first_wave=False):
    """Submit ``traffic`` and step the engine to the end: (tokens a request,
    seconds, with ``first_wave`` the admission logits of the first wave's
    slots, read right after its admission)."""
    import torch

    t0 = time.perf_counter()
    rids = [engine.submit(ids, gen, **knobs) for ids, gen, knobs in traffic]
    first = None
    if first_wave:
        engine._admit_pending()
        first = engine.state["last_logits"][: min(engine.n_slots, len(traffic))].clone()
    while engine.step():
        pass
    torch.cuda.synchronize()
    return [engine.result(r)[0] for r in rids], time.perf_counter() - t0, first


def middle_tokens(n):
    """The ENGINE_DROP_TOKENS positions in the middle of an n-token prompt
    (all but its first and last token where it is shorter)."""
    lo = max(1, n // 2 - ENGINE_DROP_TOKENS // 2)
    return slice(lo, min(n - 1, lo + ENGINE_DROP_TOKENS))


def wave_logits(engine, model, cfg, wave, drop=False):
    """The last-real-token logits of one b = k prefill of the ``wave``'s
    prompts, right-padded to its bucket, on a fresh max_len cache: what the
    engine's admission computes, without the engine. ``drop`` masks the
    ``middle_tokens`` of every prompt out (the control)."""
    import torch

    entry = entry_of(model)
    lb = max(engine._bucket_len(len(ids)) for ids, _, _ in wave)
    prompt = torch.zeros(len(wave), lb, dtype=torch.long, device=DEVICE)
    mask = torch.zeros(len(wave), engine.max_len, dtype=torch.bool, device=DEVICE)
    last = []
    for j, (ids, _, _) in enumerate(wave):
        prompt[j, : len(ids)] = torch.tensor(ids, device=DEVICE)
        mask[j, : len(ids)] = True
        if drop:
            mask[j, middle_tokens(len(ids))] = False
        last.append(len(ids) - 1)
    with torch.inference_mode():
        cache = entry.init_cache(cfg, len(wave), engine.max_len, device=DEVICE)
        logits, _, _ = entry.apply(model, cfg, prompt, attn_mask=mask, cache=cache)
    return logits[torch.arange(len(wave), device=DEVICE), torch.tensor(last, device=DEVICE)].float()


def b1_logits(model, cfg, traffic):
    """Last-token logits of a b = 1 prefill of each of the first
    ENGINE_CHECK_ROWS prompts, alone and unpadded."""
    import torch

    return torch.stack([last_prefill_logits(entry_of(model), model, cfg, torch.tensor([ids], device=DEVICE))[0]
                        for ids, _, _ in traffic[:ENGINE_CHECK_ROWS]])


def held_to_bar(name, got, ref, control):
    """``got`` within ENGINE_PLAIN_BAR × max |ref| of the plain ``ref``, and
    the ``control`` beyond it (else the bar could not see a fault of its
    size): the readings."""
    import torch

    err, scale = max_err(got, ref)
    bar = ENGINE_PLAIN_BAR * scale
    per_row = (control.float() - ref.float()).abs().amax(-1)
    if not (torch.isfinite(got).all() and err <= bar):
        raise AssertionError(f"{name}: the engine's logits differ from the plain versions' by {err} > {bar}")
    if not float(per_row.max()) > bar:
        raise AssertionError(f"{name}: the dropped-token control reads {float(per_row.max())}, within {bar}")
    return {"max_abs_err": err, "bar": bar, "control": float(per_row.max()), "control_min_row": float(per_row.min()),
            "control_rows_beyond_bar": int((per_row > bar).sum()), "rows": int(per_row.numel())}


class HeldToPlain:
    """While entered, the engine path's kernel wrappers (K1's forward, K2,
    K4's forward, K10) launch their kernels as the model calls them, then
    hold each result against the plain version on the same inputs: K1's
    output and state within TOL and tile by tile within TILE_TOL beside
    controls: from a zero state, the dropped-chunk ones (the state without
    the last chunk that holds a real token; the output without the chunk
    before it, where there is one); from a carried nonzero state (a chunked
    or prefix admission), the output of the plain version started from zeros
    instead. The state control must read above TILE_TOL at every call. The
    output controls must at the strongest call of a session (``OUT_CONTROLS``
    on leaving it): with random weights some GDN layers forget their state
    within a token or two, so there a missing chunk or state moves the
    output's 64-token tiles by less than the bar (at b 1, s 512 the
    dropped-chunk output control reads 0.0005 to 0.41 by layer: CPU, fp32,
    the plain version), and a kernel that dropped them would be seen at the
    other layers. K2's output and updated layer within TOL; K4's
    output within TOL and TILE_TOL beside the plain version with the keys
    [64, 128) masked out; K10's within TOL, each (batch, q head) row within
    K10_ROW_TOL beside the plain version with the first 64 keys masked out,
    and finite on the fully masked rows of empty slots; K11's within TOL of
    its plain version in the rows' dtype and each (expert, 64-channel) tile
    within TILE_TOL of its plain version in fp32, beside that version with
    one 64-deep K chunk of the largest expert's weights left out (run
    uncounted by the sentinels: ``plain_version``). ``readings``: per
    kernel, the calls' shapes and their worst readings."""

    CHECKED = (("gdn", "gated_delta_rule_fwd"), ("gdn", "gated_delta_rule_step_stacked"),
               ("attention", "flash_attention"), ("flash_decode", "flash_decode"),
               ("quantized_gmm", "quantized_ragged_dot"))
    OUT_CONTROLS = ("dropped_chunk_out", "zero_state_out")

    def __init__(self):
        self.readings = {}
        self.out_controls = {}

    def note(self, kernel, shape, errs, controls=None):
        r = self.readings.setdefault(kernel, {"calls": 0, "shapes": [], "worst": {}, "controls": {}})
        r["calls"] += 1
        if list(shape) not in r["shapes"]:
            r["shapes"].append(list(shape))
        for key, val in errs.items():
            r["worst"][key] = max(r["worst"].get(key, 0.0), val)
        for key, val in (controls or {}).items():
            r["controls"][key] = min(r["controls"].get(key, float("inf")), val)

    def k1(self, q, k, v, beta, alpha, prev_state=None, *, chunk_size=64, plain=False):
        out, st = self.orig["gated_delta_rule_fwd"](q, k, v, beta, alpha, prev_state, chunk_size=chunk_size,
                                                      plain=plain)
        if plain:
            return out, st
        ref = self.orig["gated_delta_rule_fwd"](q, k, v, beta, alpha, prev_state, chunk_size=chunk_size, plain=True)
        name = f"K1 engine {tuple(q.shape)}"
        errs = {"max_abs_err": max(check(f"{name} out", out, ref[0], q.dtype),
                                   check(f"{name} state", st, ref[1], q.dtype))}
        tiles = gdn_tiles((out, st), ref, ("out", "state"))
        for n, e in tiles.items():
            if not e <= TILE_TOL:  # also catches NaN
                raise AssertionError(f"{name} {n}: tile error {e} > {TILE_TOL}")
        errs.update({f"tile_err_{n}": e for n, e in tiles.items()})
        controls = {}
        if prev_state is None or not bool(prev_state.any()):
            last = int((beta != 0).any(0).any(0).nonzero().max()) // 64  # the last chunk with a real token
            controls["dropped_chunk_state"] = gdn_tiles(
                (gdn_skip_chunk(q, k, v, beta, alpha, last)[1],), ref[1:], ("state",))["state"]
            if last:
                controls["dropped_chunk_out"] = gdn_tiles(
                    (gdn_skip_chunk(q, k, v, beta, alpha, last - 1)[0],), ref[:1], ("out",))["out"]
        else:  # a carried state: the kernel must start from it, not from zeros
            zero = self.orig["gated_delta_rule_fwd"](q, k, v, beta, alpha, None, chunk_size=chunk_size, plain=True)
            controls["zero_state_out"] = gdn_tiles(zero[:1], ref[:1], ("out",))["out"]
        for n, e in controls.items():
            if n in self.OUT_CONTROLS:
                self.out_controls.setdefault(n, []).append(e)
            elif not e > TILE_TOL:
                raise AssertionError(f"{name}: the {n} control reads {e}, within {TILE_TOL}")
        self.note("K1", q.shape, errs, controls)
        return out, st

    def k2(self, q_t, k_t, v_t, beta_t, alpha_t, stacked, layer, *, plain=False):
        step = self.orig["gated_delta_rule_step_stacked"]
        if plain:
            return step(q_t, k_t, v_t, beta_t, alpha_t, stacked, layer, plain=True)
        before = stacked[layer : layer + 1].clone()
        out, stacked = step(q_t, k_t, v_t, beta_t, alpha_t, stacked, layer)
        ref_out, ref_st = step(q_t, k_t, v_t, beta_t, alpha_t, before, 0, plain=True)
        name = f"K2 engine {tuple(v_t.shape)}"
        self.note("K2", v_t.shape, {"max_abs_err": max(check(f"{name} out", out, ref_out, q_t.dtype),
                                                       check(f"{name} state", stacked[layer], ref_st[0], q_t.dtype))})
        return out, stacked

    def k4(self, q, k, v, *, plain=False, **kw):
        import torch

        attn = self.orig["flash_attention"]
        out = attn(q, k, v, plain=plain, **kw)
        if plain:
            return out
        ref = attn(q, k, v, plain=True, **kw)
        name = f"K4 engine {tuple(q.shape)} against {tuple(k.shape)}"
        errs = {"max_abs_err": check(name, out, ref, q.dtype), "tile_err": tile_rel_err(out, ref)}
        if not errs["tile_err"] <= TILE_TOL:
            raise AssertionError(f"{name}: tile error {errs['tile_err']} > {TILE_TOL}")
        keep = kw.get("attn_mask")
        keep = torch.ones(k.shape[0], k.shape[2], dtype=torch.bool, device=DEVICE) if keep is None else keep.clone()
        keep[:, 64:128] = False
        dropped = tile_rel_err(attn(q, k, v, plain=True, **{**kw, "attn_mask": keep}), ref)
        if not dropped > TILE_TOL:
            raise AssertionError(f"{name}: a dropped key tile reads {dropped}, within {TILE_TOL}")
        self.note("K4", q.shape, errs, {"dropped_tile": dropped})
        return out

    def k10(self, q, k_q, k_s, v_q, v_s, bias, *, plain=False, **kw):
        import torch

        from llm_quest_tpu_torch.ops.masks import mask_value

        decode = self.orig["flash_decode"]
        out = decode(q, k_q, k_s, v_q, v_s, bias, plain=plain, **kw)
        if plain:
            return out
        ref = decode(q, k_q, k_s, v_q, v_s, bias, plain=True, **kw)
        name = f"K10 engine {tuple(q.shape)} over {bias.shape[-1]} columns"
        tol = K10_ROW_TOL[str(q.dtype).removeprefix("torch.")]
        errs = {"max_abs_err": check(name, out, ref, q.dtype), "row_err": k10_rows(out, ref)}
        if not errs["row_err"] <= tol:  # also catches NaN
            raise AssertionError(f"{name}: row error {errs['row_err']} > {tol}")
        masked = mask_value(torch.float32)
        empty = (bias <= masked).all(-1)
        if not bool(torch.isfinite(out[empty]).all()):
            raise AssertionError(f"{name}: the fully masked rows of empty slots are not finite")
        drop = bias.clone()
        drop[:, :64] = masked
        dropped = k10_rows(out, decode(q, k_q, k_s, v_q, v_s, drop, plain=True, **kw))
        if not dropped > tol:
            raise AssertionError(f"{name}: a masked key tile reads {dropped}, within {tol}")
        self.note("K10", q.shape, errs, {"dropped_tile_row_err": dropped})
        self.readings["K10"]["empty_rows"] = int(empty.sum())
        return out

    def k11(self, x, w_q, scale, group_sizes, *, plain=False):
        gmm = self.orig["quantized_ragged_dot"]
        out = gmm(x, w_q, scale, group_sizes, plain=plain)
        if plain:
            return out
        plain_fn = plain_version("quantized_gmm", "quantized_ragged_dot_plain")
        ref, ref32 = plain_fn(x, w_q, scale, group_sizes), plain_fn(x.float(), w_q, scale, group_sizes)
        name = f"K11 engine {tuple(x.shape)} over {tuple(w_q.shape)}"
        errs = {"max_abs_err": check(name, out, ref, x.dtype), "tile_err": k11_tiles(out, ref32, group_sizes)}
        if not errs["tile_err"] <= TILE_TOL:  # also catches NaN
            raise AssertionError(f"{name}: tile error {errs['tile_err']} > {TILE_TOL}")
        dropped = k11_drop_control(x, w_q, scale, group_sizes, ref32)
        if not dropped > TILE_TOL:
            raise AssertionError(f"{name}: a dropped K chunk reads {dropped}, within {TILE_TOL}")
        self.note("K11", x.shape, errs, {"dropped_chunk_tile_err": dropped})
        return out

    def __enter__(self):
        import importlib

        def hook(method, orig):
            def call(*args, **kwargs):
                return method(*args, **kwargs)

            call.__dict__.update(orig.__dict__)  # the wrapper counts its launches on the module's name
            return call

        self.mods = [(importlib.import_module(f"llm_quest_tpu_torch.kernels.{m}"), n) for m, n in self.CHECKED]
        self.orig = {n: getattr(mod, n) for mod, n in self.mods}
        for (mod, n), method in zip(self.mods, (self.k1, self.k2, self.k4, self.k10, self.k11)):
            setattr(mod, n, hook(method, self.orig[n]))
        return self

    def __exit__(self, *exc):
        for mod, n in self.mods:
            setattr(mod, n, self.orig[n])
        if exc[0] is None:
            for n, reads in self.out_controls.items():
                self.readings["K1"]["controls"][f"{n}_max"] = max(reads)
                self.readings["K1"][f"{n}_calls"] = len(reads)
                if not max(reads) > TILE_TOL:
                    raise AssertionError(f"K1 engine: the {n} control reads at most {max(reads)} over "
                                         f"{len(reads)} calls, within {TILE_TOL}")
        return False


def engine_vs_plain(model, cfg, kind, traffic, rows, step_control="mask", **engine_kw):
    """The engine's first admission wave (the first ``rows`` requests; fewer
    than the slots leaves some empty) and its first decode step, at the
    record's width, depth and dtype, each kernel call in them held to its
    plain version on its own inputs (``HeldToPlain``), and their logits held
    to the same calls through the plain versions (``use_kernels`` False:
    the admission to a b = k prefill of the padded wave, the step to the
    step from the same pool and generator state) within ENGINE_PLAIN_BAR
    beside the dropped-token control (``held_to_bar``). With
    ``step_control`` "mask_and_state" the decode step's control also starts
    from zeroed GDN states (conv taps and recurrent states): Qwen3-Next-small's
    decode step runs its kernels (K2, K11) in the GDN and MoE layers, and
    its 2 attention layers of 8 see too little of the dropped tokens (13.5 %
    of max |plain| against the 20 % bar on an H100), nor does a zeroed
    recurrent state alone move it more (13.9 %: random GDN layers forget
    their state within a token or two). Plain versions run here, uncounted by
    the sentinels (``unwatched``): no launch of it is counted (the record
    resets the counts after)."""
    import torch

    from llm_quest_tpu_torch.inference.serving import _clone

    engine = engine_for(model, cfg, kind, **{**engine_kw, "decode_chunk": 1})
    wave = traffic[:rows]
    for ids, gen, knobs in wave:
        engine.submit(ids, gen, **knobs)
    plain_cfg = dict(cfg, use_kernels=False)
    with torch.inference_mode():
        with HeldToPlain() as held:
            engine._admit_pending()
        with unwatched():
            admission = held_to_bar(f"{kind} admission", engine.state["last_logits"][:rows],
                                    wave_logits(engine, model, plain_cfg, wave),
                                    wave_logits(engine, model, plain_cfg, wave, drop=True))
        saved, gen_state = _clone(engine.state), engine.generator.get_state()
        logits = {}
        for run in ("kernels", "plain", "control"):
            engine.state, engine.cfg = _clone(saved), cfg if run == "kernels" else plain_cfg
            engine.generator.set_state(gen_state)
            if run == "control":
                for j, (ids, _, _) in enumerate(wave):
                    engine.state["mask_buf"][j, middle_tokens(len(ids))] = False
                if step_control == "mask_and_state":
                    for leaf in ("conv_q", "conv_k", "conv_v", "recurrent"):
                        engine.state["cache"][leaf].zero_()
            toks = torch.full((1, engine.n_slots), engine.pad_id, dtype=torch.long, device=DEVICE)
            if run == "kernels":
                with held:
                    engine._decode_step(0, engine.eos_arr, toks, None)
            else:
                with unwatched():
                    engine._decode_step(0, engine.eos_arr, toks, None)
            logits[run] = engine.state["last_logits"].clone()
        engine.cfg = cfg
    if not bool(torch.isfinite(logits["kernels"]).all()):
        raise AssertionError(f"{kind}: the decode step's logits are not finite (empty slots included)")
    step = held_to_bar(f"{kind} decode step", *(logits[run][:rows] for run in ("kernels", "plain", "control")))
    return {"rows": rows, "empty_slots": engine.n_slots - rows, "admission_vs_plain": admission,
            "decode_step_vs_plain": step, "kernel_calls_vs_plain": held.readings}


def engine_admission_bf16():
    """engine_admission_bf16: Qwen3.5-0.8B text cut to ENGINE_BAR_LAYERS
    layers, bf16, the uniform and the mixed traffic and the int8 serve: the
    first wave's admission logits within BF16_LOGIT_BAR × max |ref| of a
    b = 1 prefill of each of its first ENGINE_CHECK_ROWS prompts (the port's
    tests' bf16 bar, at their depth)."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    cfg = dict(QWEN3_5_08B_CONFIG, n_layers=ENGINE_BAR_LAYERS, dtype=torch.bfloat16)
    model = text_model(cfg)
    readings = {}
    for name, kind in (("uniform", "uniform"), ("hetero", "hetero"), ("int8", "uniform")):
        if name == "int8":
            quantize_params_int8(model, quantize_embeddings=True)
            cfg = dict(cfg, kv_quant="int8")
        traffic = engine_traffic(kind)
        engine = engine_for(model, cfg, kind)
        for ids, gen, knobs in traffic[: engine.n_slots]:  # the serve's first wave
            engine.submit(ids, gen, **knobs)
        engine._admit_pending()
        got = engine.state["last_logits"][:ENGINE_CHECK_ROWS].float()
        ref = b1_logits(model, cfg, traffic)
        err, bar = float((got - ref).abs().max()), BF16_LOGIT_BAR * float(ref.abs().max())
        if not (torch.isfinite(got).all() and err <= bar):
            raise AssertionError(f"engine_admission_bf16 ({name}): admission logits differ from the b = 1 "
                                 f"prefill by {err} > {bar}")
        readings[name] = {"max_abs_err": err, "bar": bar}
    emit({"phase": "engine_admission_bf16", "layers": ENGINE_BAR_LAYERS, "rows": ENGINE_CHECK_ROWS, **readings})
    del model
    torch.cuda.empty_cache()


def engine_chunk_profile(model, cfg, kind, traffic, steps=ENGINE_PROFILE_STEPS, **engine_kw):
    """A decode chunk of ``steps`` steps over a pool of live slots (the
    first ``n_slots`` requests, budgets past the chunk) under
    ``torch.profiler``, after one warm-up chunk from the same admitted
    state: device ms a step (all the card's work), kernels a step and the
    card's busy share of the chunk's wall. Nones where the profiler gives no
    trace of the card."""
    import torch
    from torch.autograd import DeviceType

    from llm_quest_tpu_torch.inference.serving import _clone

    engine = engine_for(model, cfg, kind, **{**engine_kw, "decode_chunk": steps})
    for ids, _, knobs in traffic[: engine.n_slots]:
        engine.submit(ids, steps + 2, **knobs)
    engine._admit_pending()
    admitted = _clone(engine.state)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        engine._decode_chunk(engine.eos_arr)
        for _ in range(0 if PROFILER["given_up"] else 3):
            engine.state = _clone(admitted)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=activities) as prof:
                t0 = time.perf_counter()
                engine._decode_chunk(engine.eos_arr)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if events:
                break
            PROFILER["empty_traces"] += 1
        else:
            PROFILER["given_up"] = True
            return {"device_ms_per_step": None, "kernels_per_step": None, "busy_share": None, "chunk_wall_ms": None}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:  # union of the device intervals
        if a > hi:
            busy_us, lo = busy_us + hi - lo, a
        hi = max(hi, b)
    busy_us += hi - lo
    kernels = sum(not e.name.startswith(("Memcpy", "Memset")) for e in events)
    return {"device_ms_per_step": sum(e.time_range.elapsed_us() for e in events) / 1e3 / steps,
            "kernels_per_step": kernels / steps, "busy_share": busy_us / 1e3 / wall_ms,
            "chunk_wall_ms": wall_ms, "steps": steps}


def engine_record(path, model, cfg, kind, records, card, check_rows, depths=(), *, requests=ENGINE_REQUESTS,
                  serves=3, layer_calls=None, sync_check=False, step_control="mask", warm=True, agree=True,
                  profile_steps=ENGINE_PROFILE_STEPS, **engine_kw):
    """One serving record: the engine held to the plain versions
    (``engine_vs_plain`` over the first ``check_rows`` requests), then
    ``warmup`` (resolving ``pipeline_depth``; without ``warm`` none: the
    plain check has run the first wave's admission and a decode step at
    the serve's shapes already) and ``serves`` serves on fresh
    engines at that depth, and as many at each of ``depths`` in turn with
    them: useful tok/s (generated tokens over each serve's wall; their
    median and spread) and the last serve's ``stats()``. The first serve
    runs with the launch counts reset; its tokens must all be vocabulary
    ids, each request its budget long, and its first wave's admission
    logits equal, bit for bit, to one b = k prefill of the same padded wave
    (their distance from a b = 1 prefill of each of the first prompts is
    reported); K1 must launch once per GDN layer and wave, and each kernel
    of ``layer_calls`` ({record name: calls in one forward}) a multiple of
    its calls. Then the profiled decode chunk (``profile_steps`` steps), with ``sync_check`` one
    decode step of the live pool under ``torch.cuda.set_sync_debug_mode``
    "error" (``decode_step_syncs``), with ``agree`` the share of greedy
    tokens equal to ``generate_kv_cache``'s (the first ENGINE_AGREE_TOKENS
    of ENGINE_AGREE_ROWS greedy requests) and the peak memory of the
    serves.
    ``requests``: the first of the traffic's 48; ``step_control``:
    ``engine_vs_plain``'s; ``engine_kw``: the engine's shape over
    ``engine_for``'s."""
    import torch

    t_start = time.perf_counter()
    traffic = engine_traffic(kind)[:requests]
    plain = engine_vs_plain(model, cfg, kind, traffic, check_rows, step_control, **engine_kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = engine_for(model, cfg, kind, **engine_kw)
    if warm:
        engine.warmup()
    depth = engine.pipeline_depth
    runs = {d: [] for d in (depth, *depths)}
    for i in range(serves):
        for d in runs:
            if i or d != depth:
                engine = engine_for(model, cfg, kind, **{**engine_kw, "pipeline_depth": d})
            else:
                reset_launches()
            got, seconds, wave = drive(engine, traffic, first_wave=not i and d == depth)
            runs[d].append(sum(map(len, got)) / seconds)
            if not i and d == depth:
                toks, first, counted = got, wave, engine.stats()
                launches = read_launches(path, records)
                tc = {name: getattr(wrapper((module, name)), counter) for module, name, total, counter
                      in TC_COUNTERS if total == "launches"}
            if d == depth:
                stats = engine.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mod = model_module(model)
    n_gdn = len(mod.gdn_layer_indices(cfg)) if hasattr(mod, "gdn_layer_indices") else 0
    if launches["gdn_prefill"] != n_gdn * counted["admit_waves"]:
        raise AssertionError(f"{path}: K1 launched {launches['gdn_prefill']} times over "
                             f"{counted['admit_waves']} admission waves of {n_gdn} GDN layers")
    for name, calls in (layer_calls or {}).items():
        if launches[name] % calls:
            raise AssertionError(f"{path}: {name} launched {launches[name]} times, not a multiple of its "
                                 f"{calls} calls a forward")
    vocab = cfg["vocab_size"]
    for (_, gen, _), got in zip(traffic, toks):
        if len(got) != gen or not all(0 <= t < vocab for t in got):
            raise AssertionError(f"{path}: a request got {len(got)} tokens for a budget of {gen}, "
                                 f"or a token outside the vocabulary")
    wave = traffic[: engine.n_slots]
    if not (torch.isfinite(first).all() and torch.equal(first, wave_logits(engine, model, cfg, wave))):
        raise AssertionError(f"{path}: first-wave admission logits differ from a b = k prefill of the wave")
    refs = b1_logits(model, cfg, traffic)
    greedy = [i for i, (_, _, knobs) in enumerate(traffic) if not knobs.get("temp")][:ENGINE_AGREE_ROWS * agree]
    equal = total = 0
    for i in greedy:
        ids, gen, _ = traffic[i]
        n = min(gen, ENGINE_AGREE_TOKENS)
        ref = generate(entry_of(model), model, cfg, torch.tensor([ids], device=DEVICE), n)[0, len(ids):].tolist()
        equal += sum(a == b for a, b in zip(toks[i][:n], ref))
        total += n
    profile = engine_chunk_profile(model, cfg, kind, traffic, profile_steps, **engine_kw)
    syncs = decode_step_syncs(model, cfg, kind, traffic, **engine_kw) if sync_check else None
    emit({"phase": path, "card": card, "dtype": "bfloat16", "model": mod.__name__.rsplit(".", 1)[-1],
          "layers": cfg["n_layers"], "kv_quant": cfg.get("kv_quant"),
          "int8_weights": any(t.dtype == torch.int8 for t in model.state_dict().values()),
          "requests": len(traffic), "n_slots": engine.n_slots, "max_len": engine.max_len,
          "decode_chunk": engine.decode_chunk, "buckets": list(engine.buckets),
          "per_request_sampling": engine._row_sampling, "pipeline_depth": depth,
          "useful_tok_s": statistics.median(runs[depth]), "useful_tok_s_runs": runs[depth],
          **{f"useful_tok_s_depth{d}": statistics.median(runs[d]) for d in depths},
          **{f"useful_tok_s_depth{d}_runs": runs[d] for d in depths},
          "ttft_p50_ms": None if stats.get("ttft_p50_s") is None else stats["ttft_p50_s"] * 1e3,
          "stats": stats, "decode_chunks": stats["decode_chunks"], "slot_utilization": stats["slot_utilization"],
          **profile, "launches": launches, "tc_launches": tc, "vs_plain": plain,
          "admission_equals_wave_prefill": True,
          "admission_vs_b1_max_abs_err": float((first[:ENGINE_CHECK_ROWS] - refs).abs().max()),
          "tests_bar": BF16_LOGIT_BAR * float(refs.abs().max()),
          "warmup": warm, "greedy_agreement": equal / total if total else None, "greedy_compared": total,
          "decode_step_host_syncs": syncs, "peak_memory_gb": peak_gb, "seconds": time.perf_counter() - t_start})


def decode_step_syncs(model, cfg, kind, traffic, **engine_kw):
    """One decode step of a live pool (the traffic's first wave admitted, one
    step taken to warm it) run again under ``torch.cuda.set_sync_debug_mode``
    "error", which raises at any operation that makes the host wait for the
    card: 0 on success (a sync fails the record)."""
    import torch

    engine = engine_for(model, cfg, kind, **{**engine_kw, "decode_chunk": 2})
    for ids, gen, knobs in traffic[: engine.n_slots]:
        engine.submit(ids, gen, **knobs)
    with torch.inference_mode():
        engine._admit_pending()
        toks = torch.full((2, engine.n_slots), engine.pad_id, dtype=torch.long, device=DEVICE)
        engine._decode_step(0, engine.eos_arr, toks, None)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine._decode_step(1, engine.eos_arr, toks, None)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return 0


def engine_check_fp32():
    """engine_serve_fp32: Qwen3.5-0.8B text cut to 4 layers, fp32, 4 slots,
    buckets (32, 64), chunk 8: eight requests (three submitted after the
    first scheduler step), an EOS taken from request 0's free run; every
    request's greedy tokens equal ``generate_kv_cache``'s for its prompt
    alone (EOS included, what follows it trimmed), through the kernels and
    through the plain versions (``use_kernels`` False; run outside
    ``phase``), and no tensor-core launch."""
    import numpy as np
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.inference import generate as gen_module
    from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine
    from llm_quest_tpu_torch.models import qwen3_5

    t0 = time.perf_counter()
    cfg = dict(QWEN3_5_08B_CONFIG, n_layers=4, dtype=torch.float32)
    model = text_model(cfg)
    rng = np.random.default_rng(2)
    traffic = [(list(map(int, rng.integers(1, 32_000, n))), int(g))
               for n, g in zip(rng.integers(8, 61, 8), rng.integers(8, 25, 8))]
    free = generate(qwen3_5.TextOnly, model, cfg, torch.tensor([traffic[0][0]], device=DEVICE), traffic[0][1])
    eos = int(free[0, len(traffic[0][0]) + 4])

    def reference(ids, gen):
        out = gen_module.generate_kv_cache(qwen3_5.TextOnly, model, cfg, torch.tensor([ids], device=DEVICE),
                                           max_gen=gen, eos_ids=eos, pad_id=0)["sequences"][0, len(ids):].tolist()
        return out[: out.index(eos) + 1] if eos in out else out

    refs = [reference(ids, gen) for ids, gen in traffic]
    reset_launches()
    for run_cfg in (cfg, dict(cfg, use_kernels=False)):
        engine = ContinuousBatchingEngine(qwen3_5.TextOnly, model, run_cfg, n_slots=4, max_len=128, decode_chunk=8,
                                          prefill_buckets=(32, 64), eos_ids=eos, pad_id=0)
        rids = [engine.submit(ids, gen) for ids, gen in traffic[:5]]
        engine.step()
        rids += [engine.submit(ids, gen) for ids, gen in traffic[5:]]
        while engine.step():
            pass
        got = [engine.result(r)[0] for r in rids]
        got = [g[: g.index(eos) + 1] if eos in g else g for g in got]
        if got != refs:
            raise AssertionError(f"engine_serve_fp32 (use_kernels {run_cfg.get('use_kernels', True)}): engine tokens "
                                 f"differ from generate_kv_cache's:\n{got}\n{refs}")
    check_routes("engine_serve_fp32", bf16=False)
    emit({"phase": "engine_serve_fp32", "layers": cfg["n_layers"], "requests": len(traffic), "eos": eos,
          "retired_by_eos": sum(eos in r for r in refs), "tokens_equal": sum(map(len, refs)),
          "waves": engine.stats()["admit_waves"], "seconds": time.perf_counter() - t0})
    del model
    torch.cuda.empty_cache()


def engine_serving(records, card):
    """Qwen3.5-0.8B text at ENGINE_LAYERS layers, bf16, through the
    continuous-batching engine: bench_serving's uniform traffic (K1, K2; pipeline depth 2 timed
    beside the resolved depth), bench_serving_hetero's mixed prompts and
    samplers (K1, K2, K4 at the 256-token bucket), then the uniform traffic
    with int8 weights (tied table included) and the int8 KV cache (K1, K2,
    K10; its plain check leaves ENGINE_EMPTY_SLOTS slots empty)."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    t0 = time.perf_counter()
    cfg = dict(QWEN3_5_08B_CONFIG, n_layers=ENGINE_LAYERS, dtype=torch.bfloat16)
    model = text_model(cfg)
    engine_record(ENGINE_UNIFORM, model, cfg, "uniform", records, card, 32, depths=(2,))
    engine_record(ENGINE_HETERO, model, cfg, "hetero", records, card, 32)
    quantize_params_int8(model, quantize_embeddings=True)
    torch.cuda.empty_cache()
    engine_record(ENGINE_INT8, model, dict(cfg, kv_quant="int8"), "uniform", records, card, 32 - ENGINE_EMPTY_SLOTS)
    emit({"phase": "engine_serving", "seconds": time.perf_counter() - t0})
    del model
    torch.cuda.empty_cache()


# ------------------------------- the engine's chunked, prefix and multimodal admissions


LONG_PROMPTS = (4096, 8192)  # bench_serving_ttft_long's prompt lengths
LONG_SLOTS, LONG_REPS, LONG_GEN, SHORT_GEN = 16, 5, 8, 64
PREFILL_CHUNK = CHUNK_K4[3]
LONG_MAX_LEN = CHUNK_K4[4]  # the longest prompt + 128, as the script sizes it
PREFIX_LENS, PREFIX_SUFFIX, PREFIX_REPS = (1024, 4096), 32, 5  # bench_prefix_caching's (its 2048 is the hybrid row)
HYBRID_PREFIX = 2048
VLM_REQUESTS, VLM_SLOTS, VLM_RUNS = 32, 16, 2
VLM_IMAGE = (3, 2, 384, 384)


def nearest_rank(values, q):
    """The ``q`` quantile of ``values`` by the nearest-rank rule (of 5
    values, p95 is the largest)."""
    return sorted(values)[math.ceil(q * len(values)) - 1]


def long_traffic():
    """bench_serving_ttft_long's stream (seed 0), drawn in its order: the
    warm-up pool's 16 short requests (32 tokens, budget 64), then for each
    length its long prompt and, for each of its LONG_REPS submissions, the
    LONG_SLOTS - 1 short requests submitted with it."""
    import numpy as np

    rng = np.random.default_rng(0)

    def short():
        return list(map(int, rng.integers(1, 1000, size=32))), SHORT_GEN

    warm = [short() for _ in range(LONG_SLOTS)]
    longs = []
    for n in LONG_PROMPTS:
        ids = list(map(int, rng.integers(1, 1000, size=n)))
        longs.append((ids, [[short() for _ in range(LONG_SLOTS - 1)] for _ in range(LONG_REPS)]))
    return warm, longs


class DroppedChunk:
    """While entered, every K1 call runs its plain version with the state
    updates of the 64 tokens of chunk ``skip`` left out (beta 0 there: the
    state only decays over them): the control of the chunked admission's
    logits. The chunk is the one that holds the prompt's last token: with
    random weights the GDN layers forget their state within a few tokens
    (``HeldToPlain``), so a chunk further back moves the last token's
    logits by less than the bar, and the bar could not see it go missing."""

    def __init__(self, skip):
        self.skip = skip

    def __enter__(self):
        from llm_quest_tpu_torch.kernels import gdn

        self.mod, self.orig = gdn, gdn.gated_delta_rule_fwd

        def call(q, k, v, beta, alpha, prev_state=None, *, chunk_size=64, plain=False):
            beta = beta.clone()
            beta[..., self.skip * 64 : (self.skip + 1) * 64] = 0
            return self.orig(q, k, v, beta, alpha, prev_state, chunk_size=chunk_size, plain=True)

        call.__dict__.update(self.orig.__dict__)
        gdn.gated_delta_rule_fwd = call
        return self

    def __exit__(self, *exc):
        self.mod.gated_delta_rule_fwd = self.orig
        return False


def one_shot_logits(model, cfg, ids, skip=None):
    """Last-token logits of one uncached b = 1 ``apply_text`` of ``ids``
    (``skip``: with that chunk's GDN state update left out)."""
    import contextlib

    import torch

    from llm_quest_tpu_torch.models import qwen3_5

    with torch.inference_mode(), DroppedChunk(skip) if skip is not None else contextlib.nullcontext():
        logits, _, _ = qwen3_5.apply_text(model, cfg, torch.tensor([ids], device=DEVICE))
    return logits[:, -1].float()


def counted(fn):
    """``fn()`` and the K1 and K4 launches it made."""
    k1, k4 = wrapper(("gdn", "gated_delta_rule_fwd")), wrapper(("attention", "flash_attention"))
    before = k1.launches, k4.launches
    fn()
    return {"K1": k1.launches - before[0], "K4": k4.launches - before[1]}


def k4_ms_by_chunk(fn, n_chunks):
    """Device ms of the K4 kernels in one call of ``fn`` (a chunked
    admission) summed chunk by chunk (a chunk's calls: one an attention
    layer), from a ``torch.profiler`` trace; None where the profiler gives
    no trace of them."""
    import torch
    from torch.autograd import DeviceType

    if PROFILER["given_up"]:
        return None
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and TC_KERNELS in e.name),
                    key=lambda e: e.time_range.start)
    if not events or len(events) % n_chunks:
        PROFILER["empty_traces"] += not events
        return None
    per = len(events) // n_chunks
    return {"ms": [sum(e.time_range.elapsed_us() for e in events[c * per : (c + 1) * per]) / 1e3
                   for c in range(n_chunks)], "kernels_per_chunk": per}


def chunked_engine(model, cfg, **kw):
    from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine
    from llm_quest_tpu_torch.models import qwen3_5

    return ContinuousBatchingEngine(qwen3_5.TextOnly, model, cfg, **{
        **dict(n_slots=LONG_SLOTS, max_len=LONG_MAX_LEN, decode_chunk=16, prefill_buckets=(32,),
               prefill_chunk=PREFILL_CHUNK, eos_ids=-1, pad_id=0), **kw})


def chunked_checks(model, cfg, longs):
    """The first long prompt's chunked admission (k = 1, 4096 tokens: 8
    chunks) and one decode step with every K1/K2/K4 call held to its plain
    version (``HeldToPlain``; K1 with a carried state from chunk 2 on,
    beside its zero-state control; K4 at q_start c·512 against the 8320
    columns); then the second's (8192 tokens), counted and profiled for
    K4's device ms a chunk. Each long prompt's admission logits within
    ENGINE_PLAIN_BAR of one uncached b = 1 prefill of it through the plain
    versions, beside the same prefill with the GDN state updates of the
    64-token chunk that holds its last token left out (``DroppedChunk``,
    the control)."""
    import torch

    from llm_quest_tpu_torch.models import qwen3_5

    plain_cfg = dict(cfg, use_kernels=False)
    engine = chunked_engine(model, cfg, decode_chunk=1)
    got, calls = [], {}
    with torch.inference_mode(), HeldToPlain() as held:
        engine.submit(longs[0][0], LONG_GEN)
        engine._admit_pending()
        got.append(engine.state["last_logits"][0:1].clone())
        toks = torch.full((1, engine.n_slots), engine.pad_id, dtype=torch.long, device=DEVICE)
        engine._decode_step(0, engine.eos_arr, toks, None)
    calls[LONG_PROMPTS[0]] = {k: held.readings.get(k, {}).get("calls", 0) for k in ("K1", "K4")}
    engine.submit(longs[1][0], LONG_GEN)
    calls[LONG_PROMPTS[1]] = counted(engine._admit_pending)
    n_gdn, n_attn = len(qwen3_5.gdn_layer_indices(cfg)), len(qwen3_5.attn_layer_indices(cfg))
    for n, c in calls.items():  # every chunk runs every layer's kernel once
        chunks = -(-n // PREFILL_CHUNK)
        if c != {"K1": n_gdn * chunks, "K4": n_attn * chunks}:
            raise AssertionError(f"{ENGINE_CHUNKED}: the {n}-token admission made {c} calls, not {n_gdn} K1 and "
                                 f"{n_attn} K4 calls for each of its {chunks} chunks")
    got.append(engine.state["last_logits"][1:2].clone())
    engine.submit(longs[1][0], LONG_GEN)
    k4_chunk_ms = k4_ms_by_chunk(engine._admit_pending, LONG_PROMPTS[1] // PREFILL_CHUNK)
    del engine
    torch.cuda.empty_cache()
    bars = {}
    for n, (ids, _), logits in zip(LONG_PROMPTS, longs, got):
        bars[n] = held_to_bar(f"{ENGINE_CHUNKED} {n}", logits, one_shot_logits(model, plain_cfg, ids),
                              one_shot_logits(model, plain_cfg, ids, skip=(n - 1) // 64))
        torch.cuda.empty_cache()
    return {"kernel_calls_vs_plain": held.readings, "calls_per_admission": calls, "logits_vs_plain": bars,
            "k4_device_ms_by_chunk": k4_chunk_ms}


def engine_chunked_prefill(records, card):
    """engine_chunked_prefill (``scripts/bench_serving_ttft_long.py``'s
    workload): Qwen3.5-0.8B text, ENGINE_LAYERS layers, bf16, 16 slots, chunk 16,
    bucket 32, ``prefill_chunk`` 512, max_len 8320 (the model's RoPE tables
    taken to 8320 columns: the port refuses positions past them). A busy
    pool of 15 short requests (32 tokens, budget 64) with one long prompt
    (4096, then 8192 tokens; budget 8) submitted behind them, LONG_REPS
    times a length: TTFT p50/p95 of the long prompt, the pool's useful
    tok/s, after ``chunked_checks``."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG

    t_start = time.perf_counter()
    cfg = dict(QWEN3_5_08B_CONFIG, n_layers=ENGINE_LAYERS, dtype=torch.bfloat16, context_length=LONG_MAX_LEN)
    model = text_model(cfg)
    warm, longs = long_traffic()
    checks = chunked_checks(model, cfg, longs)
    engine = chunked_engine(model, cfg)
    reset_launches()
    engine.serve(warm)
    results = {}
    for n, (ids, reps) in zip(LONG_PROMPTS, longs):
        t0 = time.perf_counter()
        engine.serve([(ids, LONG_GEN)])
        first_s = time.perf_counter() - t0
        ttfts, rates = [], []
        for shorts in reps:
            t0 = time.perf_counter()
            rids = [engine.submit(*req) for req in shorts + [(ids, LONG_GEN)]]
            while engine.step():
                pass
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            reqs = [engine._requests[r] for r in rids]
            if [len(r.tokens) for r in reqs] != [g for _, g in shorts] + [LONG_GEN]:
                raise AssertionError(f"{ENGINE_CHUNKED}: a request did not get its budget in tokens")
            ttfts.append((reqs[-1].t_first - reqs[-1].t_submit) * 1e3)
            rates.append(sum(len(r.tokens) for r in reqs) / seconds)
        ttfts.sort()
        results[str(n)] = {"ttft_p50_ms": statistics.median(ttfts), "ttft_p95_ms": nearest_rank(ttfts, 0.95),
                           "ttft_ms": ttfts,
                           "busy_pool_useful_tok_s": statistics.median(rates), "busy_pool_useful_tok_s_runs": rates,
                           "n_chunks": -(-n // PREFILL_CHUNK), "first_submission_s": first_s}
    launches = read_launches(ENGINE_CHUNKED, records)
    emit({"phase": ENGINE_CHUNKED, "card": card, "dtype": "bfloat16", "layers": cfg["n_layers"],
          "n_slots": LONG_SLOTS, "max_len": LONG_MAX_LEN, "decode_chunk": 16, "buckets": [32],
          "prefill_chunk": PREFILL_CHUNK, "busy_pool": f"{LONG_SLOTS - 1} short requests (32 tokens, budget 64)",
          "reps": LONG_REPS, "results": results,
          **checks, "launches": launches, "seconds": time.perf_counter() - t_start})
    del engine, model
    torch.cuda.empty_cache()


def prefix_cfg(dtype):
    """bench_prefix_caching's dense Qwen3 (the bench_int8_kv model)."""
    return {"vocab_size": 32_000, "context_length": 8192, "emb_dim": 1024, "n_layers": 16, "n_heads": 8,
            "num_kv_groups": 4, "head_dim": 128, "hidden_dim": 3072, "rope_base": 500_000, "tie_embeddings": True,
            "qk_norm": True, "dtype": dtype}


def prefix_engine(mod, model, cfg, plen, **kw):
    from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine

    return ContinuousBatchingEngine(mod, model, cfg, **{
        **dict(n_slots=2, max_len=plen + PREFIX_SUFFIX + 32, decode_chunk=1,
               prefill_buckets=(PREFIX_SUFFIX, plen + PREFIX_SUFFIX), eos_ids=-1, pad_id=0, pipeline_depth=1),
        **kw})


def prefix_checks(mod, model, cfg, prefix, suffix):
    """The prefix's registration, its first suffix wave and one decode step
    with every kernel call held to its plain version (``HeldToPlain``: on
    the hybrid, K1 at the suffix with the prefix's state); the suffix
    admission's logits within ENGINE_PLAIN_BAR of a full-prompt admission
    of prefix + suffix through the plain versions, beside the suffix
    admitted on a zeroed copy of the prefix row (the control)."""
    import torch

    engine = prefix_engine(mod, model, cfg, len(prefix))
    with torch.inference_mode(), HeldToPlain() as held:
        pid = engine.register_prefix(prefix)
        engine.submit(suffix, 2, prefix=pid)
        engine._admit_pending()
        got = engine.state["last_logits"][0:1].clone()
        toks = torch.full((1, engine.n_slots), engine.pad_id, dtype=torch.long, device=DEVICE)
        engine._decode_step(0, engine.eos_arr, toks, None)
    pcache, plen = engine._prefixes[pid]
    zeroed = {name: torch.zeros_like(t) if torch.is_tensor(t) else t for name, t in pcache.items()}
    engine._prefixes[pid + 1] = (zeroed, plen)
    engine.submit(suffix, 2, prefix=pid + 1)
    engine._admit_pending()
    control = engine.state["last_logits"][1:2].clone()
    plain = prefix_engine(mod, model, dict(cfg, use_kernels=False), len(prefix))
    plain.submit(prefix + suffix, 2)
    plain._admit_pending()
    bar = held_to_bar(f"{ENGINE_PREFIX} {plen}", got, plain.state["last_logits"][0:1], control)
    return {"kernel_calls_vs_plain": held.readings, "logits_vs_plain": bar}


def ttft_once(engine, ids, prefix=None):
    rid = engine.submit(ids, 2, prefix=prefix)
    while engine.step():
        pass
    req = engine._requests[rid]
    if len(req.tokens) != 2:
        raise AssertionError(f"{ENGINE_PREFIX}: a request got {len(req.tokens)} tokens for a budget of 2")
    return (req.t_first - req.t_submit) * 1e3


def prefix_row(mod, model, cfg, plen):
    """One row of bench_prefix_caching (seed 0): after ``prefix_checks``,
    the prefix registered once (timed), one full-prompt and one suffix
    request untimed, then PREFIX_REPS of each: TTFT medians and the
    speedup."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    prefix = list(map(int, rng.integers(1, 1000, size=plen)))
    suffix = list(map(int, rng.integers(1, 1000, size=PREFIX_SUFFIX)))
    saved = saved_launches()
    checks = prefix_checks(mod, model, cfg, prefix, suffix)
    restore_launches(saved)
    torch.cuda.empty_cache()
    engine = prefix_engine(mod, model, cfg, plen)
    t0 = time.perf_counter()
    pid = engine.register_prefix(prefix)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    ttft_once(engine, prefix + suffix)
    ttft_once(engine, suffix, pid)
    with_prefix = [ttft_once(engine, suffix, pid) for _ in range(PREFIX_REPS)]
    without = [ttft_once(engine, prefix + suffix) for _ in range(PREFIX_REPS)]
    row = {"ttft_full_ms": statistics.median(without), "ttft_prefix_ms": statistics.median(with_prefix),
           "ttft_full_ms_runs": without, "ttft_prefix_ms_runs": with_prefix,
           "speedup": statistics.median(without) / statistics.median(with_prefix), "register_s": register_s, **checks}
    del engine
    torch.cuda.empty_cache()
    return row


def engine_prefix(records, card):
    """engine_prefix (``scripts/bench_prefix_caching.py``'s workload): its
    dense Qwen3 in bf16 (vocab 32000, emb 1024, 16 layers, 8/4 heads of
    128, hidden 3072, tied), 2 slots, chunk 1, pipeline depth 1, buckets
    (32, plen + 32): prefixes of 1024 and 4096 tokens with a 32-token
    suffix (K4 in the registration and the full-prompt admission), then
    one row on Qwen3.5-0.8B text (24 layers) at prefix 2048 (K4; K1 with
    the prefix's state at the suffix; K2)."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.models import qwen3, qwen3_5

    t_start = time.perf_counter()
    cfg = prefix_cfg(torch.bfloat16)
    model = init_model(qwen3, cfg)
    reset_launches()
    rows = {f"dense_{n}": prefix_row(qwen3, model, cfg, n) for n in PREFIX_LENS}
    del model
    torch.cuda.empty_cache()
    hcfg = dict(QWEN3_5_08B_CONFIG, dtype=torch.bfloat16)
    model = text_model(hcfg)
    rows[f"hybrid_{HYBRID_PREFIX}"] = prefix_row(qwen3_5.TextOnly, model, hcfg, HYBRID_PREFIX)
    launches = read_launches(ENGINE_PREFIX, records)
    emit({"phase": ENGINE_PREFIX, "card": card, "dtype": "bfloat16", "dense_layers": cfg["n_layers"],
          "hybrid_layers": hcfg["n_layers"], "suffix": PREFIX_SUFFIX, "reps": PREFIX_REPS, "rows": rows,
          "launches": launches, "seconds": time.perf_counter() - t_start})
    del model
    torch.cuda.empty_cache()


def vlm_traffic(cfg):
    """bench_vlm_serving's requests (seed 0): 4 text + 144 image + 8 text
    tokens, a uint8 (3, 2, 384, 384) image each, budgets U[16, 64]."""
    import numpy as np

    n_vis = (VLM_IMAGE[-1] // cfg["patch_size"]) ** 2 // cfg["spatial_merge_size"] ** 2
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(VLM_REQUESTS):
        prompt = (list(map(int, rng.integers(1, 1000, size=4))) + [cfg["image_token_id"]] * n_vis
                  + list(map(int, rng.integers(1, 1000, size=8))))
        image = rng.integers(0, 256, size=VLM_IMAGE, dtype=np.uint8)
        reqs.append((prompt, int(rng.integers(16, 65)), image))
    return reqs


def vlm_transform(px):
    import torch

    return (px.to(torch.bfloat16) - 127.5) / 58.0


def vlm_engine(model, cfg, **kw):
    from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine
    from llm_quest_tpu_torch.models import qwen3_5

    return ContinuousBatchingEngine(qwen3_5, model, cfg, **{
        **dict(n_slots=VLM_SLOTS, max_len=256, decode_chunk=16, prefill_buckets=(160,), eos_ids=-1, pad_id=0,
               pixel_transform=vlm_transform), **kw})


def vlm_checks(model, cfg, reqs):
    """The first multimodal wave (16 rows) and one decode step with every
    K1/K2 call held to its plain version (``HeldToPlain``); the wave's
    logits within ENGINE_PLAIN_BAR of the same wave through the plain
    versions, beside that wave with request 0's image zeroed (the
    control)."""
    import numpy as np
    import torch

    from llm_quest_tpu_torch.models import qwen3_5

    def first_wave(engine, zero_first=False):
        for j, (ids, gen, image) in enumerate(reqs[:VLM_SLOTS]):
            engine.submit(ids, gen, pixels=np.zeros_like(image) if zero_first and not j else image)
        engine._admit_pending()
        return engine.state["last_logits"][:VLM_SLOTS].clone()

    engine = vlm_engine(model, cfg, decode_chunk=1)
    with torch.inference_mode(), HeldToPlain() as held:
        got = first_wave(engine)
        toks = torch.full((1, engine.n_slots), engine.pad_id, dtype=torch.long, device=DEVICE)
        engine._decode_step(0, engine.eos_arr, toks, None)
    ids = reqs[0][0]
    feeds = qwen3_5.get_feeds_3d_shape(cfg, (1,) + VLM_IMAGE)
    next_pos = int(qwen3_5.compute_3d_position_ids(cfg, [ids], feeds).max()) + 1
    if int(engine.state["seqpos"][0]) != next_pos + 1:  # one step past the largest 3-D position + 1
        raise AssertionError(f"{ENGINE_VLM}: decode position {int(engine.state['seqpos'][0])} after one step, "
                             f"not {next_pos + 1} (the prompt's largest 3-D position + 2)")
    plain_cfg = dict(cfg, use_kernels=False)
    bar = held_to_bar(f"{ENGINE_VLM} admission", got, first_wave(vlm_engine(model, plain_cfg)),
                      first_wave(vlm_engine(model, plain_cfg), zero_first=True))
    return {"kernel_calls_vs_plain": held.readings, "logits_vs_plain": bar,
            "decode_position_after_one_step": next_pos + 1, "prompt_tokens": len(ids)}


def vlm_serve(engine, reqs, images=True):
    """Serve ``reqs`` (with their images, or their prompts alone): (useful
    tok/s, TTFT ms of each request, sorted)."""
    import torch

    t0 = time.perf_counter()
    rids = [engine.submit(ids, gen, pixels=image if images else None) for ids, gen, image in reqs]
    while engine.step():
        pass
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    done = [engine._requests[r] for r in rids]
    if [len(r.tokens) for r in done] != [gen for _, gen, _ in reqs]:
        raise AssertionError(f"{ENGINE_VLM}: a request did not get its budget in tokens")
    return sum(len(r.tokens) for r in done) / seconds, sorted((r.t_first - r.t_submit) * 1e3 for r in done)


def engine_vlm(records, card):
    """engine_vlm (``scripts/bench_vlm_serving.py``'s workload): the
    Qwen3.5-0.8B VLM (12 vision blocks, 24 text layers), bf16, 16 slots,
    max_len 256, bucket 160, chunk 16, uint8 pixels through the on-device
    ``pixel_transform``; after ``vlm_checks``, ``warmup(image_shape=,
    image_dtype=uint8)``, then VLM_RUNS serves of the 32 requests (useful
    tok/s; TTFT p50/p95 of the last; the launch counts of the first) and
    as many of the same prompts without their images through the same
    engine (the script's ``VS_TEXT_ONLY`` A/B), the two in turns."""
    import numpy as np
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG

    t_start = time.perf_counter()
    cfg = dict(QWEN3_5_08B_CONFIG, n_layers=ENGINE_LAYERS, dtype=torch.bfloat16)
    model = build_model(cfg)
    reqs = vlm_traffic(cfg)
    checks = vlm_checks(model, cfg, reqs)
    torch.cuda.empty_cache()
    engine = vlm_engine(model, cfg)
    engine.warmup(image_shape=VLM_IMAGE, image_dtype=np.uint8)
    runs = {"images": [], "text_only": []}
    reset_launches()
    runs["images"].append(vlm_serve(engine, reqs))
    launches = read_launches(ENGINE_VLM, records)
    for i in range(2 * VLM_RUNS - 1):  # in turns: text, images, text, ...
        kind = "images" if i % 2 else "text_only"
        runs[kind].append(vlm_serve(engine, reqs, images=kind == "images"))
    out = {}
    for kind, done in runs.items():
        ttft = done[-1][1]
        out[kind] = {"useful_tok_s": statistics.median(r[0] for r in done), "useful_tok_s_runs": [r[0] for r in done],
                     "ttft_p50_ms": statistics.median(ttft), "ttft_p95_ms": nearest_rank(ttft, 0.95)}
    emit({"phase": ENGINE_VLM, "card": card, "dtype": "bfloat16", "vision_layers": cfg["vision_n_layers"],
          "layers": cfg["n_layers"], "requests": VLM_REQUESTS, "n_slots": VLM_SLOTS, "max_len": 256,
          "decode_chunk": 16, "buckets": [160], "image": list(VLM_IMAGE), **out, **checks, "launches": launches,
          "seconds": time.perf_counter() - t_start})
    del engine, model
    torch.cuda.empty_cache()


def engine_admission_paths(records, card):
    """The engine's chunked, prefix and multimodal admissions at full width
    and depth: ``engine_chunked_prefill``, ``engine_prefix``,
    ``engine_vlm``."""
    t0 = time.perf_counter()
    engine_chunked_prefill(records, card)
    engine_prefix(records, card)
    engine_vlm(records, card)
    emit({"phase": "engine_admission_paths", "seconds": time.perf_counter() - t0})


# ------------------------------------------------- the MoE families through the engine


MOE_BF16_SLOTS = 16  # the bf16 30B serve: 16 slots and 16 requests (its per-expert loop is the host's)
# its decode chunk: a step takes ~0.77 s of host wall (~28,700 kernels; H100 80GB HBM3, 700 W), so the
# warm-up's chunk and the chunks of the serve are 16 steps, not 64
MOE_BF16_CHUNK = 16
FAMILY_SLOTS, FAMILY_REQUESTS = 8, 16


def moe_cfg():
    """Qwen3-30B-A3B as the repo's config gives it (``qwen3_config_creator``;
    Qwen/Qwen3-30B-A3B's ``config.json``): 48 layers, d 2048, 32/4 heads of
    128, 128 experts top-8 of hidden 768, untied head, bf16."""
    from llm_quest_tpu_torch.config import qwen3_config_creator

    return qwen3_config_creator("30B-A3B")


def weight_gb(model):
    return sum(t.numel() * t.element_size() for t in model.state_dict().values()) / 1e9


def engine_moe_paths(records, card):
    """Qwen3-30B-A3B at full width and depth through the engine (the hetero
    traffic): bf16 (``engine_serve_moe_bf16``: 16 slots, 16 requests, one
    serve; K4), then the same weights quantized in place, linears and expert
    stacks, with the int8 KV cache (``engine_serve_moe_int8``: 32 slots, 48
    requests, median of 3 serves, one decode step under the sync check; K4,
    K10, K11), neither warmed by ``warmup`` (a 30B step takes 0.3-1 s of
    host wall; the plain check runs the first wave at the serve's shapes),
    their profiled chunks 1 and 2 steps (a trace of a bf16 30B step holds
    ~29,000 kernels: 8 steps took 147 s to record and read on an H100's
    host); Qwen3-Next-small (8 layers) bf16 (``engine_serve_next``: K1, K2) and
    int8 with the int8 KV cache (``engine_serve_next_int8``: K1, K2, K11),
    one serve each, their decode step's control with the GDN states zeroed
    too (``engine_vs_plain``); then ``engine_families``."""
    import torch

    from llm_quest_tpu_torch.models import qwen3, qwen3_next
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = moe_cfg()
    model = init_model(qwen3, cfg)
    weights = {"params": sum(p.numel() for p in model.parameters()), "bf16_gb": weight_gb(model),
               "init_s": time.perf_counter() - t0}
    n = cfg["n_layers"]
    engine_record(ENGINE_MOE_BF16, model, cfg, "hetero", records, card, MOE_BF16_SLOTS, requests=MOE_BF16_SLOTS,
                  serves=1, layer_calls={"flash_attention_fwd_gqa8": n}, warm=False, agree=False, profile_steps=1,
                  n_slots=MOE_BF16_SLOTS, decode_chunk=MOE_BF16_CHUNK)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    quantize_params_int8(model)
    torch.cuda.synchronize()
    weights.update(quantize_s=time.perf_counter() - t1, quantize_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   int8_gb=weight_gb(model))
    torch.cuda.empty_cache()
    emit({"phase": "engine_moe_weights", "card": card, **weights})
    engine_record(ENGINE_MOE_INT8, model, dict(cfg, kv_quant="int8"), "hetero", records, card,
                  MOE_SLOTS - ENGINE_EMPTY_SLOTS, sync_check=True, warm=False, profile_steps=2,
                  layer_calls={"flash_attention_fwd_gqa8": n, "flash_decode_gqa8": n, "quantized_ragged_dot_e128": 3 * n})
    del model
    torch.cuda.empty_cache()
    nxt = next_serve_cfg(8, torch.bfloat16)
    model = init_model(qwen3_next, nxt)
    engine_record(ENGINE_NEXT, model, nxt, "hetero", records, card, MOE_SLOTS - ENGINE_EMPTY_SLOTS, serves=1,
                  step_control="mask_and_state")
    quantize_params_int8(model)
    torch.cuda.empty_cache()
    engine_record(ENGINE_NEXT_INT8, model, dict(nxt, kv_quant="int8"), "hetero", records, card,
                  MOE_SLOTS - ENGINE_EMPTY_SLOTS, serves=1, layer_calls={"quantized_ragged_dot": 3 * nxt["n_layers"]},
                  step_control="mask_and_state")
    del model
    torch.cuda.empty_cache()
    engine_families(records, card)
    emit({"phase": "engine_moe_paths", "seconds": time.perf_counter() - t0})


def mimo_cached_check():
    """MiMo-V2-Flash's cached generation on the card: ``MIMO_V2_SMALL_CONFIG``
    cut to 4 layers (GA, then SWA with sinks), fp32, b 1, a 100-token
    prompt: 16 greedy ``generate_kv_cache`` tokens (``sdpa`` on the padded
    cache) equal to the uncached oracle's (``generate_loop_uncached``)."""
    import torch

    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import mimo_v2_flash

    cfg = mimo_cfg(4, torch.float32)
    model = init_model(mimo_v2_flash, cfg)
    ids = ids_on_card(1, 100, seed=5)
    cached = generate(mimo_v2_flash, model, cfg, ids, 16)
    uncached = gen.generate_loop_uncached(mimo_v2_flash, model, cfg, ids, max_gen=16)
    if not torch.equal(cached, uncached):
        raise AssertionError(f"mimo fp32 cached vs uncached tokens differ:\n{cached[0, -16:]}\n{uncached[0, -16:]}")
    return {"layers": cfg["n_layers"], "prompt": ids.shape[1], "greedy_tokens_equal": 16}


def engine_families(records, card):
    """Gemma-3 at Gemma-3-270M's widths (18 layers), DeepSeek-V3 small and
    MiMo-V2-Flash small (12 layers each), bf16, through the engine: 8 slots,
    the hetero traffic's first 16 prompts, greedy, buckets 32/64/256. No
    kernel launches (``sdpa`` on the cache, as in JAX). Per model: useful
    tok/s of one serve after ``warmup``, every request its budget long in
    vocabulary ids, the first wave's admission logits finite, and the share
    of greedy tokens equal to ``generate_kv_cache``'s (ENGINE_AGREE_ROWS
    requests, ENGINE_AGREE_TOKENS each; reported); MiMo's last prefill
    logits through its cache beside its uncached forward (within
    ENGINE_PLAIN_BAR × max |uncached|), and ``mimo_cached_check``."""
    import torch

    from llm_quest_tpu_torch.models import deepseek_v3, gemma3, mimo_v2_flash

    t0 = time.perf_counter()
    traffic = [(ids, gen, {}) for ids, gen, _ in engine_traffic("hetero")[:FAMILY_REQUESTS]]
    out = {}
    for name, mod, cfg in (("gemma3", gemma3, gemma_cfg(18, torch.bfloat16)),
                           ("deepseek_v3", deepseek_v3, dsv3_cfg(12, torch.bfloat16)),
                           ("mimo_v2_flash", mimo_v2_flash, mimo_cfg(12, torch.bfloat16))):
        model = init_model(mod, cfg)
        engine = engine_for(model, cfg, "greedy", n_slots=FAMILY_SLOTS, decode_chunk=16)
        engine.warmup()
        reset_launches()
        toks, seconds, first = drive(engine, traffic, first_wave=True)
        launches = read_launches(ENGINE_FAMILIES, records, add=False)
        if any(launches.values()):
            raise AssertionError(f"{ENGINE_FAMILIES} {name}: kernels launched on the cache path: {launches}")
        for (_, gen, _), got in zip(traffic, toks):
            if len(got) != gen or not all(0 <= t < cfg["vocab_size"] for t in got):
                raise AssertionError(f"{ENGINE_FAMILIES} {name}: {len(got)} tokens for a budget of {gen}, "
                                     f"or a token outside the vocabulary")
        if not bool(torch.isfinite(first).all()):
            raise AssertionError(f"{ENGINE_FAMILIES} {name}: first-wave admission logits not finite")
        equal = total = 0
        for (ids, gen, _), got in zip(traffic[:ENGINE_AGREE_ROWS], toks):
            n = min(gen, ENGINE_AGREE_TOKENS)
            ref = generate(mod, model, cfg, torch.tensor([ids], device=DEVICE), n)[0, len(ids):].tolist()
            equal += sum(a == b for a, b in zip(got[:n], ref))
            total += n
        rec = {"layers": cfg["n_layers"], "useful_tok_s": sum(map(len, toks)) / seconds, "serve_s": seconds,
               "stats": engine.stats(), "greedy_agreement": equal / total, "greedy_compared": total}
        if name == "mimo_v2_flash":
            ids = torch.tensor([traffic[0][0]], device=DEVICE)
            with torch.inference_mode():
                uncached = mod.apply(model, cfg, ids)[0][:, -1].float()
            cached = last_prefill_logits(mod, model, cfg, ids)
            err, scale = max_err(cached, uncached)
            if not err <= ENGINE_PLAIN_BAR * scale:
                raise AssertionError(f"mimo cached prefill logits differ from the uncached forward by {err}")
            rec["cached_vs_uncached_max_abs_err"], rec["cached_vs_uncached_bar"] = err, ENGINE_PLAIN_BAR * scale
        out[name] = rec
        del model, engine
        torch.cuda.empty_cache()
    out["mimo_v2_flash"]["fp32_cached_vs_uncached"] = mimo_cached_check()
    emit({"phase": ENGINE_FAMILIES, "card": card, "dtype": "bfloat16", "n_slots": FAMILY_SLOTS,
          "requests": len(traffic), **out, "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()


PROFILE_GROUPS = {  # kernel group: a substring of its kernels' names
    # bf16: the tensor-core kernels (csrc/attention_tc.cu); fp32: the SIMT ones (csrc/attention.cu);
    # K6 and K7 run the short-sequence forward (csrc/fused_mha_tc.cu in bf16; in fp32 K6 csrc/fused_mha.cu,
    # K7 the SIMT flash forward) and the flash backward kernels
    "short_fwd": "fused_mha_tc_kernel", "short_fwd_simt": "fused_mha_kernel",
    "flash_fwd": "attention_tc_fwd_kernel", "flash_bwd_dq": "attention_tc_dq_kernel",
    "flash_bwd_dkv": "attention_tc_dkv_kernel", "flash_fwd_simt": "attention_fwd_kernel",
    "flash_bwd_dq_simt": "attention_bwd_dq_kernel", "flash_bwd_dkv_simt": "attention_bwd_dkv_kernel",
    "gdn_fwd_simt": "gdn_prefill_kernel",
    "gdn_bwd_simt": "gdn_prefill_bwd_kernel", "gdn_bwd_reduce_simt": "gdn_bwd_reduce_kernel",
    # bf16 K1 (csrc/gdn_tc.cu): the chunk-local kernel of the forward and the backward, the state pass,
    # the output, the reverse pass and the per-chunk gradients
    "gdn_tc_chunk": "gdn_tc_chunk_kernel", "gdn_tc_state": "gdn_tc_state_kernel", "gdn_tc_out": "gdn_tc_out_kernel",
    "gdn_tc_reverse": "gdn_tc_reverse_kernel", "gdn_tc_grad": "gdn_tc_grad_kernel",
    # K8/K9: the int8-score tensor-core kernel (bf16; csrc/packed_mha_int8_tc.cu) and the SIMT one (fp32)
    "packed_mha_int8_tc": "packed_mha_int8_tc_kernel", "packed_mha_int8_simt": "packed_mha_int8_kernel",
    # K11: the tensor-core kernel (bf16 rows; csrc/quantized_gmm_tc.cu) and the SIMT one (fp32 rows)
    "qgmm_tc": "quantized_gmm_tc_kernel", "qgmm_simt": "quantized_gmm_kernel",
}


def profile_window(phase, card, run, steps=2):
    """``torch.profiler`` breakdown of ``steps`` calls of ``run`` (already
    warm): device busy share of the profiled wall, and device time by kernel
    group (the hand-written kernels, cuBLAS GEMMs, everything else). One
    JSON line."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):  # a trace with none of the card's activity is taken again (see ``profiled``)
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    else:
        raise AssertionError("the profiler recorded no device kernel in three traces")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:  # union of the kernel intervals
        if s > hi:
            busy_us, lo = busy_us + hi - lo, s
        hi = max(hi, e)
    busy_us += hi - lo
    by_group = dict.fromkeys([*PROFILE_GROUPS, "gemm", "other"], 0.0)
    by_name = {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        group = next((g for g, key in PROFILE_GROUPS.items() if key in e.name), None)
        if group is None:
            gemm = any(t in e.name.lower() for t in ("gemm", "xmma", "cutlass", "nvjet"))
            group = "gemm" if gemm else "other"
        by_group[group] += ms
    total_ms = sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit({"phase": phase, "card": card, "steps": steps, "wall_ms": wall_ms,
          "device_kernel_ms": total_ms, "device_busy_ms": busy_us / 1e3, "busy_share": busy_us / 1e3 / wall_ms,
          "group_ms_per_step": {g: ms / steps for g, ms in by_group.items()},
          "group_share": {g: ms / total_ms for g, ms in by_group.items()},
          "top_ms_per_step": [[name[:90], ms / steps] for name, ms in top]})


def profile_step(phase, model_mod, cfg, card, fused=True, make_step=None, batch=None):
    """The breakdown of a bf16 train step (b = 4, s = 2048) after 2 warm-up
    steps (``make_step`` and ``batch`` as in ``train_run``)."""
    import torch

    from llm_quest_tpu_torch.training import engine

    model = init_model(model_mod, cfg)
    optimizer = engine.make_optimizer(3e-4)
    state = {"model": model, "opt": optimizer.init(model)}
    if make_step is None:
        step = engine.make_train_step(model_mod, cfg, optimizer, fused_head_ce=fused)
    else:
        step = make_step(model_mod, cfg, optimizer)
    batch = train_batch(4, 2048) if batch is None else batch

    def run():
        state["model"], state["opt"], _ = step(state["model"], state["opt"], batch)

    for _ in range(2):  # warm-up: kernels built, allocator filled
        run()
    profile_window(phase, card, run)
    del model, state
    torch.cuda.empty_cache()


def profile_vit(card, b=128):
    """The breakdown of the bf16 ViT-B/224 encode at b 128, through K7 and
    through K8 with calibrated static scales, after a warm-up encode each."""
    import torch

    from llm_quest_tpu_torch.models import vit

    cfg = vit_cfg(12, torch.bfloat16)
    model = init_model(vit, cfg)
    x = images(b, torch.bfloat16)
    cfgs = vit_mode_cfgs(cfg, vit.calibrate_int8_scales(model, cfg, x))
    for name in ("bf16", "int8_static"):
        def run(mode_cfg=cfgs[name]):
            with torch.inference_mode():
                vit.apply(model, mode_cfg, x)

        run()
        profile_window(f"profile_vit_encode_{name}", card, run)
    del model
    torch.cuda.empty_cache()


def profile_vit_train(card, phase, cfg, b=128):
    """The breakdown of a ViT train step at b 128 (K7 is in the flash
    forward group) after 2 warm-up steps: ViT-B/224 in bf16, or TinyViT in
    fp32 as its script trains it."""
    import torch

    from llm_quest_tpu_torch.models import vit
    from llm_quest_tpu_torch.training import engine, vit_engine

    model = init_model(vit, cfg)
    optimizer = engine.make_optimizer(3e-4)
    state = {"opt": optimizer.init(model)}
    step = vit_engine.make_vit_train_step(vit, cfg, optimizer)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    x = randn(gen, b, cfg["num_channels"], cfg["img_height"], cfg["img_width"], dtype=cfg.get("dtype"))
    batch = {"image": x, "label": torch.randint(0, cfg["num_classes"], (b,), generator=gen, device=DEVICE)}

    def run():
        _, state["opt"], _ = step(model, state["opt"], batch, gen)

    for _ in range(2):
        run()
    profile_window(phase, card, run)
    del model, state
    torch.cuda.empty_cache()


def profile_paths(card):
    import torch

    from llm_quest_tpu_torch.models import deepseek_v3, gemma3, mimo_v2_flash, qwen3, qwen3_next
    from llm_quest_tpu_torch.training import mtp_engine

    profile_step("profile_train", qwen3, train_cfg(16, torch.bfloat16), card)
    profile_step("profile_hybrid_train", qwen3_next, hybrid_cfg(8, torch.bfloat16), card)
    profile_step("profile_gemma_train", gemma3, gemma_cfg(18, torch.bfloat16), card, fused=False)
    profile_step("profile_mimo_train", mimo_v2_flash, mimo_cfg(12, torch.bfloat16), card,
                 make_step=mtp_engine.make_mimo_train_step)
    profile_step("profile_dsv3_train", deepseek_v3, dsv3_cfg(12, torch.bfloat16), card,
                 make_step=mtp_engine.make_deepseek_train_step, batch=mtp_batch(4, 2048))
    profile_vit(card)
    from llm_quest_tpu_torch.config import TINY_VIT_CONFIG, VIT_BASE_CONFIG

    profile_vit_train(card, "profile_vit_b_train", dict(VIT_BASE_CONFIG, dtype=torch.bfloat16))
    profile_vit_train(card, "profile_tiny_vit_train", dict(TINY_VIT_CONFIG))
    import torch.distributed as dist

    from llm_quest_tpu_torch.parallel import shard_batch

    group = cp_group()
    try:  # the context-parallel step at b 1, s 8192
        profile_step("profile_cp_train", qwen3, cp_cfg(16, torch.bfloat16, group), card,
                     batch=shard_batch(train_batch(1, CP_SEQ), group))
    finally:
        dist.destroy_process_group()


def main(argv):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="only profile the bf16 dense, hybrid, Gemma-3, MiMo-V2-Flash, DeepSeek-V3, "
                             "context-parallel and ViT-B train steps and the ViT-B encode (torch.profiler) and print "
                             "the breakdowns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    try:
        from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
        from llm_quest_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons need full-fp32 matmuls
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = build.library()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": lib.build_seconds, "load_s": time.perf_counter() - t0})
    if args.profile:
        profile_paths(smi)
        return 0

    t_kernels = time.perf_counter()
    records = kernel_phase()
    PHASE_SECONDS["kernel_phase"] = time.perf_counter() - t_kernels
    install_plain_sentinels()
    phase(k4_window_ratio, records)
    phase(k4_host_cost)
    phase(int8_vs_bf16_scores, smi)
    t_vit = time.perf_counter()
    vit_paths(records, smi)
    PHASE_SECONDS["vit_paths"] = time.perf_counter() - t_vit
    phase(vit_train_paths, records, smi)
    phase(ablate_path, records, smi)
    cfg = dict(QWEN3_5_08B_CONFIG)
    inputs = make_inputs(cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    phase(check_fp32, cfg, inputs)
    phase(main_path, cfg, inputs, records, smi)
    phase(text_decode_b128, records, smi)
    phase(train_paths, records, smi)
    phase(gemma_paths, records, smi)
    phase(mimo_paths, records, smi)
    phase(dsv3_paths, records, smi)
    phase(cp_paths, records, smi)
    t_checks = time.perf_counter()
    serving_checks_fp32()
    PHASE_SECONDS["serving_checks_fp32"] = time.perf_counter() - t_checks
    phase(serving_paths, records, smi)
    t_checks = time.perf_counter()
    engine_check_fp32()
    PHASE_SECONDS["engine_check_fp32"] = time.perf_counter() - t_checks
    phase(engine_admission_bf16)
    phase(engine_serving, records, smi)
    phase(engine_admission_paths, records, smi)
    phase(engine_moe_paths, records, smi)

    emit({"phase": "device_timing", **PROFILER})
    emit({"phase": "phase_seconds", "build_s": lib.build_seconds, **PHASE_SECONDS,
          "total_s": time.perf_counter() - t0})
    emit({"kernels": records})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
