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
Qwen3-30B-A3B at full width (12 of 48 layers), int8 and bf16, Qwen3-Next-small,
Gemma-3-270M, DeepSeek-V3 small and MiMo-V2-Flash small, multi-LoRA serving
of int8 Qwen3.5-0.8B, speculative serving of Qwen3-4B with a Qwen3-0.6B
draft, GPT-2 124M training (and ``training_eval_loop`` at
``scripts/gpt_training.py``'s settings), Llama-3.2-1B training and serving,
Hyper-Qwen3 training at Qwen3-0.6B's widths, and the alignment stack over
GPT-2 124M (classifier tuning, DPO, the reward model, RLHF-GRPO with its
losses, RLVR and RPT), the ViT→GPT-2 VLM trained and captioning, the folded
uint8 ViT-B encoder, the HF checkpoint loaders and the model-agnostic
training ops, int4 serving of Qwen3.5-0.8B text and Qwen3-30B-A3B (its
expert stacks streamed packed through K11), and the classic and latent MoE
layers with the 30B routing replay. Phases, one JSON line each on stdout:

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
    ``generate_kv_cache``'s (reported, not gated here: random weights give
    near-tied logits; ``engine_families`` gates it at a bf16 near-tie bar).
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
    (``qwen3_config_creator("30B-A3B")``: d 2048, 32/4 heads of 128, 128
    experts top-8 of 768, cut to MOE_LAYERS = 12 of its 48 layers, seeded
    random weights) in bf16 (16 slots, chunk 16, 16 requests, one serve; K4 at the
    256 bucket; the experts by the per-expert loop with its host read), then
    quantized in place (linears and expert stacks; its seconds, peak memory
    and sizes) with the int8 KV cache (32 slots, 48 requests, one serve; K4, K10 and K11 at E 128), Qwen3-Next-small (8 layers) in bf16
    (K1, K2) and int8 with the int8 KV cache (K1, K2, K11), whose decode
    step's control also zeroes the GDN states. Each first
    ``engine_vs_plain`` with K11 held too (every call within TOL, its
    (expert, 64-channel) tiles within TILE_TOL beside a control with one
    K chunk of the largest expert dropped), then the record as phase 21
    with its peak memory, each kernel's launches a multiple of its calls a
    forward, and, for the int8 30B pool, one decode step under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync). Then
    GPT-2 124M (12 layers), Gemma-3 at Gemma-3-270M's widths (18 layers),
    DeepSeek-V3 small and MiMo-V2-Flash small (12 layers), bf16, 8 slots, 16
    greedy requests: no kernel launches (``sdpa`` on the cache, as in JAX),
    useful tok/s, the greedy tokens against ``generate_kv_cache``'s, gated
    (a request leaves the reference only at a bf16 near-tie: ``near_tie``
    at BF16_LOGIT_BAR), finite admission logits, MiMo's cached prefill
    logits beside its uncached forward, and its fp32 cached tokens (4
    layers) equal to ``generate_loop_uncached``'s.
    The kernel phase holds K4 (b 32, 32/4 heads, d 128, 256 queries against
    384 columns), K10 (b 32, 32/4 heads, d 128, S 384) and K11 (E 128,
    top-8, 2048 -> 768 and 768 -> 2048 at T 256 and 65,536) at these
    shapes.
24. engine_multi_lora_base, engine_multi_lora, engine_multi_lora_checks
    (``engine_multi_lora``): int8 Qwen3.5-0.8B text, 12 layers of 24
    (ENGINE_LAYERS), int8 KV,
    uniform traffic, without and with 8 stacked r-16 adapters (request i on
    adapter i mod 9), every first-wave row against an fp32 prefill through
    its merged adapter within LORA_BAR beside the next adapter's merge.
25. engine_spec_fp32, engine_spec, engine_spec_int8, engine_spec_summary
    (``engine_spec``): speculative serving on
    ``bench_spec_serving_flagship``'s traffic (32 greedy requests, 16
    slots, chunk 8, γ 4, budgets U[16, 64]) with prompts U[8, 200]: first
    Qwen3-4B (4 layers) with Qwen3-0.6B (2)
    in fp32, every request's tokens equal to the plain engine's (a
    near-tie within SPEC_TIE_BAR excepted and printed), the target as its
    own draft committing γ + 1 every window, ``speculative_generate``
    equal to ``generate_kv_cache``; then both at full width, 18 and 14
    layers (SPEC_LAYERS: half their depth, for the script's time), in
    bf16 and, quantized in place, int8 with the int8 KV cache: the first
    wave's admission (K4 in both models at the 256 bucket) and a window
    (K10 in the draft's steps over the int8 cache) held to the plain
    versions (``HeldToPlain``), a window under the sync check, the serve
    with the counts reset (each request its budget; every committed token's
    logit, from an uncached forward, within ENGINE_PLAIN_BAR × max |row| of
    its row's max beside a random-token control), windows and the mean
    accepted n, the window's wall, device ms, kernels and busy share
    (profiled), peak memory, useful tok/s beside the plain engine's (both)
    and the rates projected at acceptance 0.56, 0.8 and 1.0 (not claimed:
    random weights accept nothing). The kernel phase holds K4 (b 16, 32/8
    heads, d 128, 256 queries against 384 columns) and K10 (b 16, 16/8
    heads, d 128, S 384) at these shapes.
26. gpt2_fp32, gpt2_train, gpt2_training_eval_loop (``gpt2_train``):
    GPT-2 124M widths cut to 2 layers, b 2, s 1024, fp32, the loss and every
    gradient through the kernels against the plain versions; then
    ``GPT_CONFIG_124M`` at full width and depth, b 8, s 1024, bf16,
    fused-head CE, as phase 9: K4 forward and backward 12 times a step; then
    ``training_eval_loop`` at ``scripts/gpt_training.py``'s settings
    (``GPT_SMALL_CONFIG``, b 8, s 256, 2 epochs of its seeded synthetic
    corpus, dropout 0.1 from a generator on the card): the evaluated train
    losses finite and falling, K4 backward 12 times a step;
27. llama_fp32, llama_train (``llama_train``): Llama-3.2-1B's widths
    (``LLAMA32_SMALL_CONFIG_1B``) cut to 2 layers in fp32 (b 1, s 2048,
    kernels against plain), then all 16 layers at b 4, s 2048, bf16, as
    phase 9: K4 (GQA 32/8, d 64) forward and backward 16 times a step;
28. hyper_qwen3_fp32_{hc,mhc,mhc-lite}, hyper_qwen3_train
    (``hyper_qwen3_train``): Hyper-Qwen3 at Qwen3-0.6B's widths with 4
    streams, each hc_type at 2 layers in fp32 (b 1, s 2048, kernels against
    plain), then mHC-lite at HYPER_LAYERS = 8 of 28 layers, b 4, s 2048,
    bf16, as phase 9: K4 forward and backward 8 times a step;
29. engine_serve_llama, engine_serve_llama_int8 (``engine_llama``, last):
    Llama-3.2-1B at full width and depth through the engine on
    ``bench_serving_hetero``'s traffic (32 slots, chunk 64, 48 requests), in
    bf16 and quantized in place (linears and tied table) with the int8 KV
    cache, one serve each, each as phase 21 (held to the plain
    versions first; no kernel runs on this path, as in JAX). The kernel
    phase holds K4 at one layer of GPT-2 124M's step (b 8, 12/12 heads of
    64, s 1024; forward, and forward + backward) and of Llama-3.2-1B's (b 4,
    32/8 heads of 64, s 2048; forward + backward), each bf16 result per
    64-row tile within TILE_TOL beside the dropped-key-tile control.
30. classifier_train, dpo_train, rm_train, grpo_rlhf, rlvr_rpt (after
    hyper_qwen3_train): the alignment stack over GPT-2 124M
    (``GPT_SMALL_CONFIG`` at context 512, seeded random weights and ids),
    each first an fp32 check at 2 layers (the loss and every gradient
    through the kernels against the plain versions), then K4 forward and
    backward in bf16 at the phase's own (b, s) and key mask (the batch's
    padding mask, the sampled experience's holed one, none in DPO) against
    the plain version (``phase_k4``: within TOL, per 64-row tile within
    TILE_TOL beside the dropped-tile control, masked keys' dk/dv exactly
    zero), then 12 layers in bf16: classifier tuning (b 8, U[200, 512] right-padded, 1 + 4 steps and
    ``classifier_accuracy``), DPO (8 pairs, prompts U[64, 128], responses
    U[128, 384], 1 + 4 steps and ``dpo_evaluate``), the reward model (the
    same pairs through ``pref_reward_collate``, a step of each readout and
    ``rm_evaluate``), RLHF-GRPO (4 prompts U[128, 256] × 4 samples, 128
    tokens at temperature 1.0, a reward model of the same widths: one
    ``rlhf_grpo_training_loop`` batch with 2 updates, then one update of
    dapo, dr_grpo, sapo, gspo, OPSM 0.5 and the unbiased KL on a new
    experience, whose masks, finite log-probabilities and zero-mean
    advantages are checked), and one ``rlvr_grpo_training_loop`` batch each
    with the verifier and with RPT's prefix-matching reward (2 prompts × 4,
    64 tokens, a byte tokenizer). Every loss finite; K4 (with the padding
    or holed key masks, or causal alone in DPO) launches the counts each
    docstring gives, all on the tensor cores; step ms, tokens a second,
    peak GB. The kernel phase holds K4 at the GRPO update's shape (b 16,
    12/12 heads of 64, s 384) on a holed key mask, forward and backward
    (``flash_attention_fwd_bwd_grpo``): a masked key's dk/dv exactly zero,
    bf16 per 64-row tile within TILE_TOL beside the dropped-tile control,
    timed beside ``sdpa`` + backward on the same bool mask.
31. vlm_fp32, vlm_train, vlm_generate, uint8_encode, hf_loaders,
    training_ops (after rlvr_rpt): the ViT→GPT-2 VLM (``multimodal/vlm.py``:
    ViT-B/16 at 224 px frozen, an "ffn" adapter 768 → 3,072 → 768, GPT-2
    124M, seeded random weights, b 32, captions of U[8, 64] random ids
    right-padded to 64: the fused s 261). ``vlm_train``: an fp32 check at 2
    layers (b 4: the loss and the adapter's and GPT-2's gradients through
    the kernels against the plain versions), K4 fwd + bwd and K7 in bf16 at
    the step's shapes and key mask against plain (``phase_k4``,
    ``phase_k7``), then 12 layers in bf16 through
    ``scripts/vlm_training.py``'s step (``adamw(1e-4)``), 1 + 3 steps: K4
    forward and backward 12 times a step, K7 12 times, all on the tensor
    cores, the loss finite and falling. ``vlm_generate``: greedy captions
    (b 32, 30 tokens) against the reference's re-run of the whole fused
    sequence each step, fp32 at 2 layers (equal but at a near-tie within
    SPEC_TIE_BAR, also with an EOS mid-caption) and bf16 at 12 (rows leave
    it only at near-ties within BF16_LOGIT_BAR); K7 12 launches a call, no
    K4; ms a call. ``uint8_encode``: ``make_uint8_encoder`` on 256-pixel
    uint8 images resized to 224 against resize, normalize, ``vit.apply``
    (fp32 2 layers, bf16 12 layers), K7 12 launches an encode, img/s at b
    128 beside ``vit.apply`` on the same images pre-normalized.
    ``hf_loaders``: HF-named bf16 state dicts written from seeded GPT-2 124M
    and Qwen3.5-0.8B VLM models, loaded into models of another seed: every
    leaf bit-equal, nothing missing, equal greedy tokens. ``training_ops``:
    QK-Clip on Llama-3.2-1B (16 layers, fp32) capping at τ·1.01 the maxima
    on the collecting forward's inputs and layer 0's in the next forward, the Number-Token Loss against JAX's full-softmax form
    and RAL on GPT-2 124M at b 8, s 1,024, ``l2_norm`` and DyT against
    fp64. The kernel phase holds K4 at the fused shape and mask (b 32,
    12/12 heads of 64, s 261; forward, and forward + backward, bf16 per
    64-row tile beside the dropped-tile control) and K7 at b 32, s 197.
32. engine_spec_hybrid_fp32, engine_spec_hybrid_plain, engine_spec_hybrid,
    engine_spec_hybrid_small, engine_spec_next, engine_spec_hybrid
    (``engine_spec_hybrid``, after ``engine_spec``): speculative serving
    over hybrid caches, each window rolling every row's GDN states and conv
    taps back to its committed tokens. First Qwen3.5-0.8B's widths at 4
    layers and Qwen3-Next-small's at 2, fp32, each its own draft on 8 of
    ``bench_spec_serving_flagship``'s requests: tokens equal to the plain
    engine's (a near-tie within SPEC_TIE_BAR excepted), γ + 1 committed in
    every window no budget cuts, both pools' states and taps a prefill of
    each row's committed tokens but the last within HSPEC_STATE_TOL, and a
    control keeping every window token beyond it. Then that script's
    workload (32 greedy requests, 32-token prompts of ids in [1, 1000),
    budgets U[16, 64], 16 slots, chunk 8, γ 4, 160 columns, bucket 32) on
    Qwen3.5-0.8B at full width and depth, bf16: the plain engine, the model
    as its own draft and the script's 4-layer, 512-d draft, each with
    useful tok/s, tokens a row-window, a profiled window's device ms and
    kernels, the rollback's ms (a captured window's ``roll_window`` calls
    and the draft's state copy replayed) and its share, the greedy tokens
    against the plain engine's by ``bf16_tie`` (the first difference within
    twice the bf16 forward's error of the fp32 twin's largest logit, beside
    a random-token control); Qwen3-Next-small (8 layers, bf16) as its own
    draft on 16 requests; ``speculative_generate`` of Qwen3.5-0.8B as its
    own draft (b 1, 64 tokens) against ``generate``; and
    ``scripts/spec_decoding_generate.py`` at γ 4, max_gen 50. The kernel
    phase holds K1 at a window's shapes (b 16, s 2, 5, 9 from a carried
    state with a frozen tail; 16 heads of 128, 8 of 64) and K2 at the small
    draft's (3 layers, b 16, 8 heads of 64).
33. engine_serve_int4_fp32 (``engine_check_fp32(bits=4)``, after
    ``engine_serving``, outside ``phase``): phase 20's check with the
    linears quantized to int4 (block scales of INT4_BLOCK = 128): the
    engine's tokens equal ``generate_kv_cache``'s of the same int4 model,
    through the kernels and the plain versions.
34. engine_serve_int8_hetero, engine_serve_int4, engine_serve_moe_int4
    (``engine_int4_paths``, after ``engine_moe_paths``), each int4 record
    beside the int8 record of the same model and traffic
    (``<path>_beside_int8``: useful tok/s, TTFT p50, device ms, kernels and
    busy share a step, weight GB, K11's ms and share a step, peak memory):
    Qwen3.5-0.8B text at ENGINE_LAYERS, bf16, quantized as phase 21's
    engine_serve_int8 (a copy of the model) and then in place with
    ``bits=4``, block scales of 128 and the int4 tied table, the int8 KV
    cache, both on ``bench_serving_hetero``'s traffic (K1, K2, K4, K10); then
    Qwen3-30B-A3B at MOE_LAYERS quantized in place from bf16 (linears with
    block scales of 128, expert stacks per (expert, channel), all 4-bit),
    the int8 KV cache, 32 slots, one serve and one decode step under the
    sync check (K4, K10 and K11 over the packed stacks: every K11 launch
    an int4 one on the tensor cores). Each first held to the plain versions
    as phase 21.
35. moe_variants (after ``engine_int4_paths``): the classic MoE at GPT-2
    124M's widths (emb 768, 8 experts top-2 of 1,536, x (8, 1,024, 768))
    and the latent MoE at Qwen3-30B-A3B's (emb 2,048, 128 experts top-8 of
    768 in the latent width 512, x (4, 2,048, 2,048)): bf16 forward and
    backward against fp32 on the tokens both route alike (at least
    MOE_ROUTE_AGREE of them), the output and every gradient within
    MOE_VARIANT_BAR beside a control; int8 and int4 (quantized in place
    from the bf16 copy) forwards through K11 against K11's plain version,
    the int4 ones counted (every K11 launch an int4 one on the tensor
    cores); and the routing replay: Qwen3-30B-A3B at MOE_LAYERS, b 2,
    s 64, fed its own ``gate_probas`` gives the same logits bit for bit,
    another batch's move them by more than REPLAY_CONTROL.
    The kernel phase holds K11 over int4 stacks (``k11_int4``) at E 8
    (T 8 and 2,400; 896 <-> 3,584) and E 128 (T 256 and 65,536; 2,048 <->
    768), fp32 and bf16 rows, an odd K and tail widths: within the
    tolerances of the plain version, per (expert, 64-channel) tile beside
    the dropped-chunk control, timed beside the int8 kernel on the same
    values, warm and (T up to 4,096) with the L2 cold, and beside
    ``torch._grouped_mm`` on a bf16 copy.

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
import copy
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


def dropped_tile(name, leaves, do, ref, names, *, causal, g_lse=None, attn_mask=None):
    """The readings of ``check_tiles`` for a deliberately wrong result: the
    plain version with the 64 keys [e - 128, e - 64) dropped (a key mask,
    over ``attn_mask`` when the call has one; e is s, or one past the last
    column any row of ``attn_mask`` keeps), against the plain reference
    ``ref``. Each must exceed its bar, or the bar could not see such a
    fault; returns the readings."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    q, k, v = (t.detach().requires_grad_() for t in leaves)
    b, s = k.shape[0], k.shape[2]
    e = s if attn_mask is None else int(attn_mask.any(0).nonzero().max()) + 1
    keep = torch.ones(b, s, dtype=torch.bool, device=DEVICE)
    keep[:, e - 128 : e - 64] = False
    if attn_mask is not None:
        keep &= attn_mask
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
# K2 at the flagship's small draft's steps (``engine_spec_hybrid``): its 3 GDN layers, 16 slots, 8/8 heads of 64
HSPEC_K2 = (("spec_draft", 3, 16, 8, 8, 64, 1),)
K2_KEY = "gdn_step_stacked_kernel"  # the step kernel's name (csrc/gdn.cu), K2's and K3's
# the distinct states a cold timing rotates over hold at least this many bytes: 2.5 times the H100's 50 MB L2
# K1 at a speculative window over a hybrid pool (``engine_spec_hybrid``): b, h, s = γ + 1, dk, dv of the
# Qwen3.5-0.8B target's verify and re-advance at 16 slots, and of the flagship's small draft (8 heads of 64);
# each also held at s 2 and 9
HSPEC_K1 = (16, 16, 5, 128, 128)
HSPEC_K1_D64 = (16, 8, 5, 64, 64)
HSPEC_K1_S = (2, 9)


def kernel_k1_spec(gen, dtypes, shape=HSPEC_K1):
    """K1 as a speculative window runs it: s = γ + 1 tokens from a carried
    state, each row's tail past a random count in [0, s] frozen (β 0, α 1,
    as ``ops/gdn.py::roll_window`` freezes rejected drafts), fp32 and bf16
    against the plain version at s 2, γ + 1 and 9 (out and state within
    TOL; a row with count 0 keeps its state within TOL); bf16 calls all on
    the tensor cores. Timed in bf16 at ``shape``."""
    import torch

    from llm_quest_tpu_torch.kernels import gdn
    from llm_quest_tpu_torch.ops.gdn import freeze_masked_updates

    fwd = gdn.gated_delta_rule_fwd
    b, h, s, dk, dv = shape
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        for s_len in (HSPEC_K1_S[0], s, HSPEC_K1_S[1]):
            q, k, v, beta, alpha, s0 = gdn_inputs(gen, b, h, s_len, dtype, dk=dk, dv=dv)
            counts = torch.randint(0, s_len + 1, (b,), generator=gen, device=DEVICE)
            counts[0] = 0
            beta, alpha = freeze_masked_updates(beta, alpha, torch.arange(s_len, device=DEVICE) < counts[:, None])
            (out, st), tc = tc_count(fwd, lambda: fwd(q, k, v, beta, alpha, s0))
            ref_out, ref_st = fwd(q, k, v, beta, alpha, s0, plain=True)
            torch_sync()
            if tc != int(dtype == torch.bfloat16):
                raise AssertionError(f"K1 spec {dtype}: {tc} tensor-core launches of 1")
            label = f"K1 spec b={b} h={h} s={s_len} dk={dk} dv={dv} {dtype}"
            e = max(check(f"{label} out", out, ref_out, dtype), check(f"{label} state", st, ref_st, dtype),
                    check(f"{label} frozen row", st[0], s0[0], dtype))
            cases.append({"b": b, "h": h, "s": s_len, "dk": dk, "dv": dv, "dtype": str(dtype), "max_abs_err": e,
                          "counts": counts.tolist(), "tc_launches": tc})
            (errs if dtype == dtypes[0] else errs_bf16).append(e)
    q, k, v, beta, alpha, s0 = gdn_inputs(gen, b, h, s, dtypes[-1], dk=dk, dv=dv)

    def call():
        return fwd(q, k, v, beta, alpha, s0)

    out, st = call()
    extra = {**bound(nbytes(q, k, v, beta, alpha, s0, out, st), gdn_flops(*shape)), "library_ms": None,
             "max_abs_err_bf16": max(errs_bf16), "device_ms": device_ms(call, GDN_TC_KEY),
             "record": {"shape": list(shape)}}
    return max(errs), cuda_ms(call), cuda_ms(lambda: fwd(q, k, v, beta, alpha, s0, plain=True)), cases, extra


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


def kernel_k2(gen, dtypes, shapes=K2_SHAPES, timed="b128"):
    """K2 at ``shapes`` (K2_SHAPES), fp32 and bf16, on the models' inputs
    (``step_inputs``: strided views, bf16 beta in bf16, q/k at their own
    head count for Qwen3-Next) against the plain version: out within TOL
    (fp32: NEW_TOL), the layer's new state within NEW_TOL, every other layer
    bitwise unchanged; timed in bf16 at each shape (``step_timing``), the
    record's line at the shape named ``timed``."""
    import torch

    from llm_quest_tpu_torch.kernels import gdn

    errs, cases = [], []
    for name, n_layers, b, h, h_qk, d, layer in shapes:
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
    rec = next(c for c in cases if c["shape"] == timed and "ms" in c)
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
# one attention layer of GPT-2 124M's train step (b 8, s 1024, 12 heads of 64)
# and of Llama-3.2-1B's (b 4, s 2048, 32 q / 8 kv heads of 64), causal
GPT2_K4 = {"b": 8, "hq": 12, "hkv": 12, "s": 1024, "d": 64}
LLAMA_K4 = {"b": 4, "hq": 32, "hkv": 8, "s": 2048, "d": 64}
# one attention layer of the GRPO update over GPT-2 124M (``grpo_rlhf``): 4 prompts × 4 samples, 12/12 heads
# of 64, prompts padded to 256 columns and 128 generated ones
GRPO_PROMPT, GRPO_GEN, GRPO_PROMPTS, GRPO_SAMPLES = 256, 128, 4, 4
GRPO_K4 = {"b": GRPO_PROMPTS * GRPO_SAMPLES, "hq": 12, "hkv": 12, "s": GRPO_PROMPT + GRPO_GEN, "d": 64}


# the ViT→GPT-2 VLM (``multimodal/vlm.py``): ViT-B/16 at 224 px (196 patches + CLS), captions right-padded to
# 64 tokens, b 32; GPT-2 124M's attention over the fused [vision ‖ text] sequence of 261 (not a multiple of 64)
VLM_B, VLM_VISION, VLM_TEXT = 32, 197, 64
VLM_K4 = {"b": VLM_B, "hq": 12, "hkv": 12, "s": VLM_VISION + VLM_TEXT, "d": 64}
VLM_K7 = (VLM_B, VLM_VISION, 12, 64)


def vlm_caption_lens(b, seed=SEED):
    """``b`` caption lengths U[8, VLM_TEXT], the first VLM_TEXT (the padded width)."""
    import numpy as np

    lens = np.random.default_rng(seed).integers(8, VLM_TEXT + 1, b)
    lens[0] = VLM_TEXT
    return lens


def vlm_key_mask(b, s):
    """The VLM's fused key mask (``multimodal/vlm.py::fuse``): the s - VLM_TEXT
    vision columns all real, then each row's caption (``vlm_caption_lens``)
    right-padded."""
    import torch

    nv = s - VLM_TEXT
    mask = torch.zeros(b, s, dtype=torch.bool)
    mask[:, :nv] = True
    for i, n in enumerate(vlm_caption_lens(b)):
        mask[i, nv : nv + n] = True
    return mask.to(DEVICE)


def grpo_key_mask(b, s, prompt=GRPO_PROMPT, seed=SEED):
    """A GRPO update's key mask (``alignment/grpo.py::batched_responses_collator``)
    with holes: each row's real prompt tokens (U[128, 256]), its pads up to
    ``prompt`` columns, then its response, every other row cut after a first
    EoS at U[0, s - prompt)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    mask = torch.zeros(b, s, dtype=torch.bool)
    for i in range(b):
        mask[i, : int(rng.integers(128, prompt + 1))] = True
        cut = int(rng.integers(0, s - prompt)) if i % 2 else s - prompt - 1
        mask[i, prompt : prompt + cut + 1] = True
    return mask.to(DEVICE)


def visible_pairs(s, window=None):
    """(query, key) pairs a causal (optionally windowed) s-row block sees."""
    w = min(window or s, s)
    return w * (w + 1) // 2 + (s - w) * w


def k4_case(gen, dtypes, *, shape=GEMMA_K4, window=None, softcap=None, sink=False, backward=False, tiles=False,
            key_mask=None, timed=True):
    """K4 at ``shape`` (v's head dim ``dv``, default d) with the given
    features against its plain version in each dtype (the output, and with
    ``backward`` dq/dk/dv and dsink through autograd), then the kernel, the
    plain version and (without softcap or sinks) ``F.scaled_dot_product_attention``
    on the dense mask timed in bf16. With ``tiles`` (a causal call without
    window, softcap or sinks) the bf16 results are also held per 64-row tile
    (TILE_TOL) beside the dropped-key-tile control (``dropped_tile``).
    ``key_mask(b, s)``: a (b, s) key mask (True = real key) for every call,
    the library's included; then the visible pairs and the K/V bytes count
    only the real keys, and with ``backward`` a masked key's dk and dv must
    be exactly zero. Without ``timed`` nothing is timed and the last dtype's
    readings are returned."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    b, hq, hkv, s, d = (shape[key] for key in ("b", "hq", "hkv", "s", "d"))
    dv = shape.get("dv", d)
    mask = None if key_mask is None else key_mask(b, s)
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        # a softcap of 30 bends scores only where they reach its scale
        q = randn(gen, b, hq, s, d, dtype=dtype, scale=20.0 if softcap else 1.0)
        k, v = randn(gen, b, hkv, s, d, dtype=dtype), randn(gen, b, hkv, s, dv, dtype=dtype)
        do = randn(gen, b, hq, s, dv, dtype=dtype)
        # sinks near the rows' logsumexp, so their share and dsink are not negligible
        sk = randn(gen, hq, scale=0.5) + 5.0 if sink else None
        kw = {"window_size": window, "softcap": softcap, "attn_mask": mask}
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
        if mask is not None and backward:  # a masked key reaches no output: its dk and dv are exactly zero
            hidden = ~mask[:, None, :, None]
            case["masked_keys"] = int((~mask).sum())
            case["masked_key_grad_max"] = max((float(h.abs().max()) for h in
                                               (g.masked_select(hidden.expand_as(g)) for g in got[2:4]) if h.numel()),
                                              default=0.0)
            if case["masked_key_grad_max"] != 0.0:
                raise AssertionError(f"{label}: a masked key's dk/dv reads {case['masked_key_grad_max']}")
        if tiles and dtype == dtypes[-1]:
            case["tile_err"] = check_tiles(label, got, ref, names)
            case["tile_err_dropped_tile"] = dropped_tile(label, leaves[:3], do, ref, names, causal=True,
                                                         attn_mask=mask)
        del got, ref
        # the record's error is the fp32 (SIMT) one, as for the other kernels; bf16 runs on the tensor cores
        (errs if dtype == dtypes[0] else errs_bf16).append(max(err.values()))
        if timed and dtype == dtypes[-1]:
            iters = (5, 1) if backward else (10, 2)
            case["ms"] = cuda_ms(lambda: run(False), *iters)
            case["plain_ms"] = cuda_ms(lambda: run(True), *iters)
            # the kernels' own device time (CUDA events also count the card
            # waiting on the host between the wrapper's launches)
            case["device_ms"] = device_ms(lambda: run(False), TC_KERNELS)
            if mask is None:
                pairs, kv_bytes = visible_pairs(s, window) * b, nbytes(k, v)
            else:  # each query sees the real keys at or before it; of K/V only the real keys are read
                pairs = int(mask.long().cumsum(-1).sum())
                kv_bytes = nbytes(k, v) * float(mask.float().mean()) + nbytes(mask)
            # forward 2·(d + dv) FLOPs per visible pair and head (QKᵀ, PV);
            # backward 2× that (dV and dP over dv, dQ and dK over d)
            flops = (3 if backward else 1) * 2 * (d + dv) * pairs * hq
            # do stands for o (both (b, hq, s, dv)); the fp32 lse. With the backward: q, k, v, do read and
            # dq, dk, dv, o written
            n_bytes = nbytes(q, do) + kv_bytes + (nbytes(q, k, v, do) if backward else 4 * b * hq * s)
            case.update(bound(n_bytes, flops, "bfloat16"))
            case["library_ms"] = None
            if softcap is None and not sink:
                sdpa = torch.nn.functional.scaled_dot_product_attention
                allowed = None
                if window is not None or mask is not None:
                    pos = torch.arange(s, device=DEVICE)
                    allowed = pos[None, :] <= pos[:, None]
                    if window is not None:
                        allowed = allowed & (pos[None, :] > pos[:, None] - window)
                    if mask is not None:  # the same bool mask, (b, 1, s, s)
                        allowed = allowed[None, None] & mask[:, None, None, :]

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
    if not timed:
        return rec
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "library_ms",
                                       "device_ms")}
    extra["shape"] = {**shape, "window": window, "softcap": softcap, "sink": sink, "backward": backward,
                      "key_mask": mask is not None}
    extra["max_abs_err_bf16"] = max(errs_bf16)
    if tiles:
        extra["tile_err_bf16"] = max(rec["tile_err"].values())
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
# speculative serving (engine_spec): 16 slots, windows of gamma 4, 384 columns (a 256-token bucket, a 64-token
# budget and the window's 4 columns past it fit); K4 at Qwen3-4B's heads in the admission wave, K10 at
# Qwen3-0.6B's (the draft's steps over the int8 cache)
SPEC_SLOTS, SPEC_GAMMA, SPEC_MAX_LEN = 16, 4, 384
SPEC_K4 = (SPEC_SLOTS, (32, 8, 128), 256, SPEC_MAX_LEN)
SPEC_K10 = (SPEC_SLOTS, (16, 8, 128), SPEC_MAX_LEN)
MOE_HEADS = (32, 4, 128)  # q heads, kv heads, head dim
MOE_EXPERTS, MOE_TOP_K = 128, 8
MOE_MATS = {"lin1": (2048, 768), "lin2": (768, 2048)}


def prompt_mask(gen, b, s_len, lo=8, hi=200):
    """(b, s_len) key mask of right-padded prompts of U[lo, hi] real tokens (the hetero traffic's lengths)."""
    import torch

    lens = torch.randint(lo, hi + 1, (b,), generator=gen, device=DEVICE)
    return torch.arange(s_len, device=DEVICE)[None] < lens[:, None], lens


def kernel_k4_gqa8(gen, dtypes, shape=None, label="K4 gqa8"):
    """K4 at Qwen3-30B-A3B's admission wave: b 32, 32/4 heads of 128 (8 q
    heads a kv head), 256 queries at q_start 0 against the 384-column view
    of the wave's fresh cache, each row's keys real up to its prompt length
    (U[8, 200]); or at ``shape`` (b, (q heads, kv heads, d), sq, sk). fp32
    and bf16 against the plain version, bf16 also tile by tile (TILE_TOL)
    beside the plain version with the keys [64, 128) masked out, which must
    read above the bar; timed (events and profiler) beside ``sdpa`` with the
    same visibility as one boolean mask (k/v repeated to the q heads: the
    masked kernels take no GQA)."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    b, (hq, hkv, d), sq, sk = shape or (MOE_SLOTS, MOE_HEADS, MOE_BUCKET, MOE_MAX_LEN)
    key_mask, lens = prompt_mask(gen, b, sk)
    errs, errs_bf16, cases = [], [], []
    for dtype in dtypes:
        q, k, v, _ = attn_inputs(gen, b, hq, hkv, sq, sk, d, dtype)
        out = attn.flash_attention(q, k, v, attn_mask=key_mask)
        ref = attn.flash_attention(q, k, v, attn_mask=key_mask, plain=True)
        torch_sync()
        e = check(f"{label} {dtype}", out, ref, dtype)
        case = {"dtype": str(dtype), "max_abs_err": e}
        if dtype == torch.bfloat16:
            case["tile_err"] = tile_rel_err(out, ref)
            if not case["tile_err"] <= TILE_TOL:
                raise AssertionError(f"{label}: tile error {case['tile_err']} > {TILE_TOL}")
            drop = key_mask.clone()
            drop[:, 64:128] = False
            case["dropped_tile"] = tile_rel_err(attn.flash_attention(q, k, v, attn_mask=drop, plain=True), ref)
            if not case["dropped_tile"] > TILE_TOL:
                raise AssertionError(f"{label}: a dropped key tile reads {case['dropped_tile']}, within {TILE_TOL}")
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
    check(f"{label} vs sdpa (library)", lib(), call(), dtypes[-1])
    # each query sees the keys at or before it that are real: sum over queries of min(i + 1, len)
    pairs = int(torch.minimum(rows[None] + 1, lens[:, None]).sum())
    # q, out and the mask whole; of k/v only the real keys a query can see: min(len, sq) columns a row
    kv_cols = int(lens.clamp_max(sq).sum())
    moved = 2 * nbytes(q) + nbytes(key_mask[:, :sq]) + 2 * hkv * d * kv_cols * q.element_size()
    extra = {**bound(moved, 4 * d * pairs * hq), "library_ms": cuda_ms(lib), "max_abs_err_bf16": max(errs_bf16),
             "tile_err_bf16": cases[-1]["tile_err"], "device_ms": device_ms(call, TC_KERNELS),
             "record": {"shape": {"b": b, "heads": [hq, hkv], "d": d, "sq": sq, "sk": sk}}}
    return max(errs), ms, plain_ms, cases, extra


def kernel_k10_gqa8(gen, dtypes, shape=None, label="K10 gqa8"):
    """K10 on Qwen3-30B-A3B's int8 cache in the engine's decode step: b 32,
    32/4 heads of 128 (8 q heads a kv head, the kernel's most), 384 columns;
    or at ``shape`` (b, (q heads, kv heads, d), S). On the cache's strided
    layer views; fp32 q on the SIMT kernel, bf16 q on
    the tensor-core kernel (``tc_launches``). Checked as ``kernel_k10``:
    within TOL, each (batch, q head) row within K10_ROW_TOL beside a control
    with one 64-key tile masked out of the plain version, two runs
    bit-equal; bf16 timed by events and profiler beside its bound and the
    host's µs a call."""
    import torch

    from llm_quest_tpu_torch.kernels import flash_decode as fd
    from llm_quest_tpu_torch.ops.masks import mask_value

    w = fd.flash_decode
    b, (hq, hkv, d), s_len = shape or (MOE_SLOTS, MOE_HEADS, MOE_MAX_LEN)
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
        tc_moved(f"{label} {dtype}", tc, 0, int(bf16))
        e = check(f"{label} {dtype}", out, ref, dtype)
        rows = k10_rows(out, ref)
        if not rows <= row_tol:  # also catches NaN
            raise AssertionError(f"{label} {dtype}: row error {rows} > {row_tol}")
        bias_drop = bias.clone()
        bias_drop[:, 128:192] = mask_value(torch.float32)
        dropped = k10_rows(out, call(True, bias_drop))
        if not dropped > row_tol:
            raise AssertionError(f"{label} {dtype}: a masked key tile reads {dropped}, within {row_tol}")
        if not torch.equal(out, call()):
            raise AssertionError(f"{label} {dtype}: two runs differ")
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
    (an int4 stack's unpacked) left out: only that expert's rows are
    recomputed."""
    import torch

    from llm_quest_tpu_torch.ops.int4 import integer_weight

    sizes = group_sizes.tolist()
    big = max(range(len(sizes)), key=sizes.__getitem__)
    lo, hi = sum(sizes[:big]), sum(sizes[: big + 1])
    wd = integer_weight(w_q[big:big + 1], x.shape[1], torch.float32)[0].clone()
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


# K11 over packed int4 stacks: (experts, top-k, tokens, matrices) at Qwen3-Next-small's widths (decode T 8,
# prefill T 2400) and Qwen3-30B-A3B's (a decode step of 32 slots, T 256; a full admission wave, T 65,536)
K11_INT4_CASES = ((K11_EXPERTS, 2, 4, K11_MATS), (K11_EXPERTS, 2, 1200, K11_MATS),
                  (MOE_EXPERTS, MOE_TOP_K, MOE_SLOTS, MOE_MATS),
                  (MOE_EXPERTS, MOE_TOP_K, MOE_SLOTS * MOE_BUCKET, MOE_MATS))
# an odd K (its pad nibble), and widths TMA cannot address (bf16 rows on the SIMT kernel)
K11_INT4_TAILS = ((37, 64), (36, 40), (64, 40))
K11_COLD_ROWS = 4096  # up to this many rows a case is also timed with the L2 cold (its weights stream)


def k11_int4_stack(gen, k_dim, n_dim, e):
    """An int8 stack of values in [-7, 7] and the same values packed int4, and the scales."""
    import torch

    from llm_quest_tpu_torch.ops.int4 import pack_int4

    w8 = torch.randint(-7, 8, (e, k_dim, n_dim), generator=gen, device=DEVICE, dtype=torch.int8)
    return w8, pack_int4(w8), torch.rand(e, n_dim, generator=gen, device=DEVICE) * 0.2 + 1e-2


def k11_int4_tails(gen):
    """K11 int4 at K11_INT4_TAILS (a top-2 routing of 10 tokens over 8
    experts), fp32 and bf16 rows: one launch each, counted in
    ``int4_launches``, on the tensor cores only where ``tc_route`` says,
    within the tolerance of the plain version. {"KxN dtype": max abs err}."""
    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    w = qg.quantized_ragged_dot
    group_sizes = k11_routing(gen, 10)
    errs = {}
    for k_dim, n_dim in K11_INT4_TAILS:
        _, w4, scale = k11_int4_stack(gen, k_dim, n_dim, K11_EXPERTS)
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(gen, 20, k_dim, dtype=dtype)
            n, n4 = w.launches, w.int4_launches
            out, tc = tc_count(w, lambda: w(x, w4, scale, group_sizes))
            torch_sync()
            if (w.launches - n, w.int4_launches - n4) != (1, 1):
                raise AssertionError(f"K11 int4 K {k_dim} N {n_dim} {dtype}: {w.launches - n} launches, "
                                     f"{w.int4_launches - n4} int4 ones, expected 1 and 1")
            tc_moved(f"K11 int4 K {k_dim} N {n_dim} {dtype}", tc, 0, int(qg.tc_route(dtype, k_dim, n_dim)))
            errs[f"{k_dim}x{n_dim} {dtype}"] = check(f"K11 int4 K {k_dim} N {n_dim} {dtype}", out,
                                                    w(x, w4, scale, group_sizes, plain=True), dtype)
    return errs


def kernel_k11_int4(gen, dtypes):
    """K11 over packed int4 stacks (``pack_int4``: half a byte a weight) at
    K11_INT4_CASES, fp32 rows on the SIMT kernel and bf16 rows on the
    tensor-core kernel at the wrapper's ``plan`` for 4-bit weights: every
    call one launch counted in ``int4_launches``; in bf16 two runs bit-equal,
    each (expert, 64-channel) tile within TILE_TOL of the fp32 plain version
    beside the control with one 64-deep K chunk of the largest expert
    dropped; timed by events and profiler (``device_ms``, warm: the calls
    back to back, as the int8 records are timed), beside the int8 kernel on
    the same values at the same shape (``int8_device_ms``), and, up to
    K11_COLD_ROWS rows, both with the L2 cold (``rotated_device_ms`` over
    copies of the stack); ``torch._grouped_mm`` on a bf16 copy of the stack
    (``bf16_grouped_mm_ms``). The bound: the packed bytes of the experts hit,
    x and y over the memory rate, or the products over the bf16 peak.
    ``tail_widths_err``: ``k11_int4_tails``. The record's times are
    Qwen3-30B-A3B's decode step's lin1 (T 256)."""
    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    w = qg.quantized_ragged_dot
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, errs_bf16, cases = [], [], []
    for e, top_k, tokens, mats in K11_INT4_CASES:
        group_sizes = k11_routing(gen, tokens, e, top_k)
        t = top_k * tokens
        for mat, (k_dim, n_dim) in mats.items():
            w8, w4, scale = k11_int4_stack(gen, k_dim, n_dim, e)
            for dtype in dtypes:
                bf16 = dtype == torch.bfloat16
                x = randn(gen, t, k_dim, dtype=dtype)
                call = lambda plain=False: w(x, w4, scale, group_sizes, plain=plain)  # noqa: E731
                n4 = w.int4_launches
                out, tc = tc_count(w, call)
                ref = call(True)
                torch_sync()
                label = f"K11 int4 E {e} T={t} {mat} {dtype}"
                if w.int4_launches - n4 != 1:
                    raise AssertionError(f"{label}: {w.int4_launches - n4} int4 launches, expected 1")
                tc_moved(label, tc, 0, int(bf16))
                err = check(label, out, ref, dtype)
                case = {"E": e, "T": t, "matrix": mat, "K": k_dim, "N": n_dim, "dtype": str(dtype), "max_abs_err": err,
                        "experts_hit": int((group_sizes > 0).sum()), "max_group": int(group_sizes.max()),
                        "tc_launches": tc}
                if not bf16:
                    errs.append(err)
                    cases.append(case)
                    continue
                if not torch.equal(out, call()):
                    raise AssertionError(f"{label}: two runs differ")
                ref32 = qg.quantized_ragged_dot(x.float(), w4, scale, group_sizes, plain=True)
                tile_err = k11_tiles(out, ref32, group_sizes)
                if not tile_err <= TILE_TOL:  # also catches NaN
                    raise AssertionError(f"{label}: tile error {tile_err} > {TILE_TOL}")
                dropped = k11_drop_control(x, w4, scale, group_sizes, ref32)
                if not dropped > TILE_TOL:
                    raise AssertionError(f"{label}: a dropped K chunk reads {dropped}, within {TILE_TOL}")
                del ref32
                int8_call = lambda: w(x, w8, scale, group_sizes)  # noqa: E731
                gmm_ms, gmm_err = k11_grouped_mm_ms(x, w8, scale, group_sizes)
                hit = case["experts_hit"]  # the packed weights of the experts with rows are read
                case.update({"plan": list(qg.plan(t, k_dim, n_dim, e, sms, 4)),
                             "plan_int8": list(qg.plan(t, k_dim, n_dim, e, sms)),
                             "tile_err": tile_err, "dropped_chunk_tile_err": dropped,
                             "ms": cuda_ms(call), "plain_ms": cuda_ms(lambda: call(True), iters=3, warmup=1),
                             "device_ms": device_ms(call, QGMM_KEY), "int8_device_ms": device_ms(int8_call, QGMM_KEY),
                             "bf16_grouped_mm_ms": gmm_ms, "bf16_grouped_mm_err": gmm_err,
                             **bound(nbytes(x, out, group_sizes) + hit * (w4.shape[1] * n_dim + 4 * n_dim),
                                     2 * t * k_dim * n_dim)})
                if t <= K11_COLD_ROWS:
                    cold = {}
                    for bits, stack in ((4, w4), (8, w8)):
                        copies = rotation(stack)
                        cold[bits] = rotated_device_ms(
                            [lambda c=c: w(x, c, scale, group_sizes) for c in copies], QGMM_KEY)
                        del copies
                    case.update({"device_ms_cold": cold[4], "int8_device_ms_cold": cold[8]})
                errs_bf16.append(err)
                cases.append(case)
            del w8, w4, scale
    torch.cuda.empty_cache()
    rec = next(c for c in cases if c["E"] == MOE_EXPERTS and c["T"] == MOE_TOP_K * MOE_SLOTS
               and c["matrix"] == "lin1" and "ms" in c)
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "device_ms",
                                       "bf16_grouped_mm_ms")}
    key = lambda c: f"E{c['E']}_T{c['T']}_{c['matrix']}"  # noqa: E731
    extra.update({"library_ms": rec["bf16_grouped_mm_ms"], "max_abs_err_bf16": max(errs_bf16),
                  "tile_err_bf16": max(c["tile_err"] for c in cases if "tile_err" in c),
                  "tail_widths_err": k11_int4_tails(gen),
                  "record": {"int8_device_ms": rec["int8_device_ms"], "device_ms_cold": rec["device_ms_cold"],
                             "int8_device_ms_cold": rec["int8_device_ms_cold"],
                             **{name: {key(c): c.get(val) for c in cases if "ms" in c}
                                for name, val in (("cases_ms", "ms"), ("cases_device_ms", "device_ms"),
                                                  ("cases_int8_device_ms", "int8_device_ms"),
                                                  ("cases_device_ms_cold", "device_ms_cold"),
                                                  ("cases_int8_device_ms_cold", "int8_device_ms_cold"),
                                                  ("cases_bound_ms", "bound_ms"), ("cases_plain_ms", "plain_ms"),
                                                  ("cases_grouped_mm_ms", "bf16_grouped_mm_ms"),
                                                  ("cases_plan", "plan"))}}})
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
    if not timed:
        return rec
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
ENGINE_INT4 = "engine_serve_int4"  # int4 Qwen3.5-0.8B text (block scales of 128, the int4 table), int8 KV
ENGINE_INT8_HETERO = "engine_serve_int8_hetero"  # ENGINE_INT8's model on the int4 serve's traffic
ENGINE_PATHS = (ENGINE_UNIFORM, ENGINE_HETERO, ENGINE_INT8, ENGINE_INT8_HETERO, ENGINE_INT4, ENGINE_CHUNKED,
                ENGINE_PREFIX, ENGINE_VLM)
# the MoE families through the engine: Qwen3-30B-A3B int8 and bf16, Qwen3-Next-small bf16 and int8, and
# Gemma-3 / DeepSeek-V3 / MiMo-V2-Flash (no kernel: ``sdpa`` on the cache, as in JAX)
ENGINE_MOE_INT8, ENGINE_MOE_BF16 = "engine_serve_moe_int8", "engine_serve_moe_bf16"
# int4 Qwen3-30B-A3B (its expert stacks streamed packed through K11) with the int8 KV cache; the classic and
# latent MoE layers
ENGINE_MOE_INT4, MOE_VARIANTS = "engine_serve_moe_int4", "moe_variants"
INT4_PATHS = (ENGINE_MOE_INT4, MOE_VARIANTS)  # every K11 launch of these is over an int4 stack
ENGINE_NEXT, ENGINE_NEXT_INT8 = "engine_serve_next", "engine_serve_next_int8"
ENGINE_FAMILIES = "engine_families"
# multi-LoRA: int8 Qwen3.5-0.8B text at ENGINE_LAYERS with 8 stacked adapters, and the same engine without them
ENGINE_LORA, ENGINE_LORA_BASE = "engine_multi_lora", "engine_multi_lora_base"
# speculative serving: Qwen3-4B with a Qwen3-0.6B draft, bf16, then int8 weights with the int8 KV cache
ENGINE_SPEC, ENGINE_SPEC_INT8 = "engine_spec", "engine_spec_int8"
# speculative serving over hybrid caches (bench_spec_serving_flagship.py's workload): Qwen3.5-0.8B as its own
# draft and with the flagship's small draft, Qwen3-Next-small as its own draft, and ``speculative_generate``
ENGINE_SPEC_HYBRID, ENGINE_SPEC_HYBRID_SMALL = "engine_spec_hybrid", "engine_spec_hybrid_small"
ENGINE_SPEC_NEXT, SPEC_GENERATE_HYBRID = "engine_spec_next", "speculative_generate_hybrid"
# GPT-2 124M, Llama-3.2-1B and Hyper-Qwen3 trained; Llama-3.2-1B served, bf16, then int8 weights with the
# int8 KV cache (no kernel: ``sdpa`` on the cache, as in JAX)
GPT2_TRAIN, LLAMA_TRAIN, HYPER_TRAIN = "gpt2_train", "llama_train", "hyper_qwen3_train"
ENGINE_LLAMA, ENGINE_LLAMA_INT8 = "engine_serve_llama", "engine_serve_llama_int8"
# the alignment stack over GPT-2 124M (``GPT_SMALL_CONFIG`` at context 512): classifier tuning, DPO, the reward
# model, RLHF-GRPO, and RLVR with RPT
CLASSIFIER_TRAIN, DPO_TRAIN, RM_TRAIN = "classifier_train", "dpo_train", "rm_train"
GRPO_RLHF, RLVR_RPT = "grpo_rlhf", "rlvr_rpt"
ALIGN_PATHS = (CLASSIFIER_TRAIN, DPO_TRAIN, RM_TRAIN, GRPO_RLHF, RLVR_RPT)
# the ViT→GPT-2 VLM trained and captioning, and the folded uint8 ViT-B encoder
VLM_TRAIN, VLM_GENERATE, UINT8_ENCODE = "vlm_train", "vlm_generate", "uint8_encode"
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
     (GENERATE, HYBRID, INT8_GENERATE, NEXT_SERVE, TEXT_B128, *ENGINE_PATHS, ENGINE_NEXT, ENGINE_NEXT_INT8,
      ENGINE_LORA, ENGINE_LORA_BASE)),
    ("gdn_prefill_bwd", ("gdn", "gated_delta_rule_bwd"), GDN_SRC,
     "llm_quest_tpu/kernels/gdn_pallas.py:255", kernel_k1_bwd, (HYBRID,)),
    # K2 and K3: the step kernel (csrc/gdn.cu) for both dtypes; their records' ms is the kernel's
    # device time with the L2 cold (step_timing)
    ("gdn_step_stacked", ("gdn", "gated_delta_rule_step_stacked"), "llm_quest_tpu_torch/csrc/gdn.cu",
     "llm_quest_tpu/kernels/gdn_pallas.py:350", kernel_k2,
     (GENERATE, INT8_GENERATE, NEXT_SERVE, TEXT_B128, *ENGINE_PATHS, ENGINE_NEXT, ENGINE_NEXT_INT8, ENGINE_LORA,
      ENGINE_LORA_BASE, ENGINE_SPEC_HYBRID, ENGINE_SPEC_NEXT, SPEC_GENERATE_HYBRID)),
    # the speculative windows over hybrid pools: K1 at s = γ + 1 from a carried state with a frozen tail (the
    # verify and the re-advance), at the Qwen3.5-0.8B target's heads and at the small draft's (which Qwen3-Next
    # shares); K2 at the small draft's steps. A path's count is all of its wrapper's launches
    ("gdn_prefill_spec", ("gdn", "gated_delta_rule_fwd"), GDN_SRC,
     "llm_quest_tpu/kernels/gdn_pallas.py:205", kernel_k1_spec,
     (ENGINE_SPEC_HYBRID, ENGINE_SPEC_HYBRID_SMALL, SPEC_GENERATE_HYBRID)),
    ("gdn_prefill_spec_d64", ("gdn", "gated_delta_rule_fwd"), GDN_SRC,
     "llm_quest_tpu/kernels/gdn_pallas.py:205", partial(kernel_k1_spec, shape=HSPEC_K1_D64),
     (ENGINE_SPEC_HYBRID_SMALL, ENGINE_SPEC_NEXT)),
    ("gdn_step_stacked_spec", ("gdn", "gated_delta_rule_step_stacked"), "llm_quest_tpu_torch/csrc/gdn.cu",
     "llm_quest_tpu/kernels/gdn_pallas.py:350", partial(kernel_k2, shapes=HSPEC_K2, timed="spec_draft"),
     (ENGINE_SPEC_HYBRID_SMALL,)),
    ("flash_attention_fwd", ("attention", "flash_attention"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544", kernel_k4,
     (GENERATE, TRAIN, HYBRID, HYPER_TRAIN, ENGINE_HETERO, ENGINE_INT8_HETERO, ENGINE_INT4, ENGINE_CHUNKED,
      ENGINE_PREFIX)),
    # K4 at one chunk of the chunked admission (q_start up to 7680 against 8320 cache columns)
    ("flash_attention_fwd_chunked", ("attention", "flash_attention"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544", kernel_k4_chunked, (ENGINE_CHUNKED,)),
    ("flash_attention_bwd", ("attention", "flash_attention_bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:175", kernel_k4_bwd, (TRAIN, HYBRID, HYPER_TRAIN)),
    # K4 at one layer of GPT-2 124M's train step (forward, and forward + backward) and of Llama-3.2-1B's
    # (forward + backward), each held per 64-row tile in bf16 beside the dropped-tile control. The alignment
    # paths count their launches here and in the GRPO record; each also holds K4 at its own (b, s) and key
    # mask to plain before its counted window (``phase_k4``)
    ("flash_attention_fwd_gpt2", ("attention", "flash_attention"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544", partial(k4_case, shape=GPT2_K4, tiles=True),
     (GPT2_TRAIN, *ALIGN_PATHS)),
    ("flash_attention_fwd_bwd_gpt2", ("attention", "flash_attention_bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:175", partial(k4_case, shape=GPT2_K4, backward=True, tiles=True),
     (GPT2_TRAIN, CLASSIFIER_TRAIN, DPO_TRAIN, RM_TRAIN)),
    ("flash_attention_fwd_bwd_llama", ("attention", "flash_attention_bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:175", partial(k4_case, shape=LLAMA_K4, backward=True, tiles=True),
     (LLAMA_TRAIN,)),
    # K4 at one layer of the GRPO update over GPT-2 124M, on its key mask with holes (the prompts' pads between
    # prompt and response, the cut after the first EoS), forward and backward, held per 64-row tile in bf16
    ("flash_attention_fwd_bwd_grpo", ("attention", "flash_attention_bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, shape=GRPO_K4, backward=True, tiles=True, key_mask=grpo_key_mask), (GRPO_RLHF, RLVR_RPT)),
    # K4 at one layer of the VLM's GPT-2 124M over the fused sequence (b 32, s 261: 197 vision columns, then
    # captions right-padded to 64), forward and forward + backward, held per 64-row tile in bf16
    ("flash_attention_fwd_vlm", ("attention", "flash_attention"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544",
     partial(k4_case, shape=VLM_K4, tiles=True, key_mask=vlm_key_mask), (VLM_TRAIN,)),
    ("flash_attention_fwd_bwd_vlm", ("attention", "flash_attention_bwd"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, shape=VLM_K4, backward=True, tiles=True, key_mask=vlm_key_mask), (VLM_TRAIN,)),
    # K7: its bf16 forward is the short-sequence tensor-core kernel (fp32: the
    # SIMT flash forward of attention.cu); its backward the flash recompute
    # kernels (attention_tc.cu in bf16, attention.cu in fp32), counted as "bwd"
    ("packed_mha", ("attention", "packed_mha"), PACKED_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:422", kernel_k7, (VIT, VIT_B_TRAIN, UINT8_ENCODE)),
    # K7 at the VLM's frozen ViT-B/16 encode (b 32), in training and captioning
    ("packed_mha_vlm", ("attention", "packed_mha"), PACKED_SRC,
     "llm_quest_tpu/kernels/fused_mha.py:422", partial(kernel_k7, shape=VLM_K7), (VLM_TRAIN, VLM_GENERATE)),
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
     "llm_quest_tpu/kernels/flash_decode.py:91", kernel_k10,
     (INT8_GENERATE, ENGINE_INT8, ENGINE_INT8_HETERO, ENGINE_INT4, ENGINE_LORA, ENGINE_LORA_BASE)),
    ("quantized_ragged_dot", ("quantized_gmm", "quantized_ragged_dot"), QGMM_SRC,
     "llm_quest_tpu/kernels/quantized_gmm.py:71", kernel_k11, (NEXT_SERVE, ENGINE_NEXT_INT8)),
    # Qwen3-30B-A3B's shapes in the engine: K4 at the 256-token admission bucket (32/4 heads, d 128), K10 on
    # its int8 cache (b 32, 32/4 heads, d 128), K11 over its 128 int8 experts (top-8) at decode and admission T
    ("flash_attention_fwd_gqa8", ("attention", "flash_attention"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544", kernel_k4_gqa8,
     (ENGINE_MOE_INT8, ENGINE_MOE_BF16, ENGINE_MOE_INT4)),
    ("flash_decode_gqa8", ("flash_decode", "flash_decode"), FD_SRC,
     "llm_quest_tpu/kernels/flash_decode.py:91", kernel_k10_gqa8, (ENGINE_MOE_INT8, ENGINE_MOE_INT4)),
    # the speculative engine's: K4 at Qwen3-4B's admission wave (its launches count the draft's admission too),
    # K10 at the Qwen3-0.6B draft's steps over the int8 cache
    ("flash_attention_fwd_spec", ("attention", "flash_attention"), ATTN_SRC,
     "llm_quest_tpu/kernels/flash_attention.py:544", partial(kernel_k4_gqa8, shape=SPEC_K4, label="K4 spec"),
     (ENGINE_SPEC, ENGINE_SPEC_INT8)),
    ("flash_decode_spec", ("flash_decode", "flash_decode"), FD_SRC,
     "llm_quest_tpu/kernels/flash_decode.py:91", partial(kernel_k10_gqa8, shape=SPEC_K10, label="K10 spec"),
     (ENGINE_SPEC_INT8,)),
    ("quantized_ragged_dot_e128", ("quantized_gmm", "quantized_ragged_dot"), QGMM_SRC,
     "llm_quest_tpu/kernels/quantized_gmm.py:71", kernel_k11_e128, (ENGINE_MOE_INT8,)),
    # K11 over packed int4 stacks (JAX sends those to ragged_dot; the port to K11): its int4 launches
    ("k11_int4", ("quantized_gmm", "quantized_ragged_dot", "int4"), QGMM_SRC,
     "llm_quest_tpu/kernels/quantized_gmm.py:71", kernel_k11_int4, (ENGINE_MOE_INT4, MOE_VARIANTS)),
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
            "causal_launches", "causal_bwd_launches", "int8_launches", "int4_launches", "tc_launches",
            "tc_bwd_launches")


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
    never launched, if the path's K1 and attention launches did not take
    the route of its dtype (bf16: the tensor-core kernels; the FP32_PATHS:
    the SIMT ones), or if a K11 launch of an INT4_PATHS path was over an
    int8 stack."""
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
            elif spec[-1] in ("dynamic", "static", "bf16", "int8", "int4"):  # K8's by scales, K12's by scores,
                # K11's by weights: all or none on the tensor cores (check_routes)
                rec["tc_launches"] = rec.get("tc_launches", 0) + n * (path not in FP32_PATHS)
    missing = [name for (name, *_, paths) in KERNELS if path in paths and counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {counts}")
    k11 = wrapper(("quantized_gmm", "quantized_ragged_dot"))
    if path in INT4_PATHS and k11.int4_launches != k11.launches:  # and check_routes: all on the tensor cores
        raise AssertionError(f"{path}: {k11.launches} K11 launches, {k11.int4_launches} of them over int4 stacks")
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


def grads_check(phase, model_mod, cfg, b, s, *, fused=True, invariant=None, group=None, loss_fn=None,
                loss_rtol=TRAIN_LOSS_RTOL, grad_rtol=TRAIN_GRAD_RTOL, batch=None):
    """One fp32 step's loss and gradients, kernels vs plain, same weights;
    ``fused``: the fused-head CE (a model without it takes the full logits).
    ``loss_fn(cfg, model, batch)``, when given, is the loss instead of
    ``make_loss_fn``'s; ``batch`` (default ``train_batch(b, s)``) its
    input. ``invariant`` maps the name of a leaf whose gradient
    is zero in exact arithmetic (fp32 noise on both sides, so no relative
    bar) to the leaf that scales it: both its gradients must stay under
    ``grad_rtol`` times that leaf's (plain) gradient. ``group`` maps a
    leaf's name to a group (or None): a grouped leaf's error is taken
    relative to the largest plain gradient of its group, not its own (for
    leaves whose own gradient is a sum that cancels down to fp32 noise)."""
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
        # a leaf the loss does not read (the reward model's unused vocabulary head) gets zeros
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True, materialize_grads=True)
        results.append((float(loss.detach()), [g.detach() for g in grads]))
    (lk, gk), (lp, gp) = results
    loss_rel = abs(lk - lp) / abs(lp)
    if not loss_rel <= loss_rtol:
        raise AssertionError(f"{phase} loss, kernels {lk} vs plain {lp}: rel {loss_rel} > {loss_rtol}")
    worst_name, worst, worst_zero = None, 0.0, 0.0
    by_name = dict(zip(names, gp))
    group_scale = {}
    for name, r in by_name.items():
        if group is not None and group(name) is not None:
            group_scale[group(name)] = max(group_scale.get(group(name), 0.0), float(r.abs().max()))
    for name, a, r in zip(names, gk, gp):
        ref_name = invariant(name) if invariant else None
        if ref_name is not None:
            rel = max(float(a.abs().max()), float(r.abs().max())) / float(by_name[ref_name].abs().max())
            if not rel <= grad_rtol:
                raise AssertionError(f"{phase} grad {name} (zero in exact arithmetic): {rel} of {ref_name}'s")
            worst_zero = max(worst_zero, rel)
            continue
        diff, scale = float((a - r).abs().max()), float(r.abs().max())
        if group is not None and group(name) is not None:
            scale = group_scale[group(name)]
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


# ------------------------------------------ GPT-2, Llama-3.2 and Hyper-Qwen3 training


GPT2_STEP = {"flash_attention_fwd_gpt2": 12, "flash_attention_fwd_bwd_gpt2": 12}  # K4 launches a 124M step
# scripts/gpt_training.py's settings (its synthetic corpus: 40 windows of 256 ids below 1000, seed 0)
GPT_SCRIPT = {"batch_size": 8, "num_epoch": 2, "peak_lr": 4e-4, "init_lr": 1e-5, "min_lr": 1e-5, "warmup_steps": 10,
              "decay": "cosine", "weight_decay": 0.1, "eval_freq": 5, "eval_iter": 2, "max_length": 256}
HC_STREAMS = 4  # Hyper-Qwen3's expansion rate (scripts/hyper_qwen3_training.py's)
HYPER_LAYERS = 8  # of Qwen3-0.6B's 28


def gpt2_cfg(base, n_layers, dtype, **kw):
    return dict(base, n_layers=n_layers, dtype=dtype, **kw)


def gpt_script_corpus():
    """``scripts/gpt_training.py``'s synthetic fallback corpus and its
    loaders: 36 training windows (4 batches of 8, shuffled with seed 0) and
    4 validation windows (no full batch: an empty loader, as in JAX)."""
    import numpy as np

    from llm_quest_tpu_torch.data.datasets import data_loader

    n = GPT_SCRIPT["max_length"]
    ids = np.random.default_rng(0).integers(0, 1000, size=(40 * n + 1,))
    inputs, targets = ids[:-1].reshape(-1, n).astype(np.int32), ids[1:].reshape(-1, n).astype(np.int32)
    split = int(0.9 * len(inputs))
    bs = GPT_SCRIPT["batch_size"]
    return (data_loader((inputs[:split], targets[:split]), bs, shuffle=True),
            data_loader((inputs[split:], targets[split:]), bs))


def gpt2_train(records, card):
    """GPT-2: the fp32 check (124M widths cut to 2 layers, b 2, s 1024: loss
    and gradients through the kernels against the plain versions, the key
    biases' against their weights' scale), then
    ``GPT_CONFIG_124M`` at full width and depth (12 layers, vocabulary
    50,257), b 8, s 1024, bf16, fused-head CE, 1 + 4 steps: K4 forward and
    backward 12 times a step, all on the tensor cores; then
    ``training_eval_loop`` at ``scripts/gpt_training.py``'s settings on its
    seeded synthetic corpus (``GPT_SMALL_CONFIG``, bf16, b 8, s 256, 2
    epochs, dropout 0.1 from a generator on the card): the evaluated train
    losses finite and falling, K4 on the tensor cores."""
    import math

    import torch

    from llm_quest_tpu_torch.config import GPT_CONFIG_124M, GPT_SMALL_CONFIG
    from llm_quest_tpu_torch.models import gpt2
    from llm_quest_tpu_torch.training import engine

    # a bias common to every key adds one constant to a row's scores, which the softmax cancels: the key
    # biases' gradients are zero but for noise
    grads_check("gpt2_fp32", gpt2, gpt2_cfg(GPT_CONFIG_124M, 2, torch.float32), 2, 1024,
                invariant=lambda n: n[:-2] + ".w" if n.endswith("att.wk.b") else None)
    train_run(GPT2_TRAIN, gpt2, gpt2_cfg(GPT_CONFIG_124M, 12, torch.bfloat16), records, card, GPT2_TRAIN, GPT2_STEP,
              b=8, s=1024)

    cfg = gpt2_cfg(GPT_SMALL_CONFIG, GPT_SMALL_CONFIG["n_layers"], torch.bfloat16, drop_rate=0.1)
    train_loader, val_loader = gpt_script_corpus()
    model = gpt2.init(cfg, generator=torch.Generator(device=DEVICE).manual_seed(123), device=DEVICE)
    knobs = {k: GPT_SCRIPT[k] for k in ("num_epoch", "peak_lr", "init_lr", "min_lr", "warmup_steps", "decay",
                                         "weight_decay", "eval_freq", "eval_iter")}
    logs = []
    reset_launches()
    t0 = time.perf_counter()
    _, train_losses, val_losses = engine.training_eval_loop(
        gpt2, cfg, model, train_loader, val_loader, timing=True, log=logs.append,
        generator=torch.Generator(device=DEVICE).manual_seed(SEED), **knobs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(GPT2_TRAIN, records, add=False)
    if not all(math.isfinite(x) for x in train_losses) or not train_losses[-1] < train_losses[0]:
        raise AssertionError(f"gpt2 training_eval_loop: train losses not finite and falling: {train_losses}")
    steps = len(train_loader) * GPT_SCRIPT["num_epoch"]
    emit({"phase": "gpt2_training_eval_loop", "card": card, "dtype": "bfloat16", "drop_rate": cfg["drop_rate"],
          "b": GPT_SCRIPT["batch_size"], "s": GPT_SCRIPT["max_length"], "steps": steps,
          "train_losses": train_losses, "val_losses": [None if math.isnan(x) else x for x in val_losses], "log": logs,
          "k4_fwd": launches["flash_attention_fwd_gpt2"], "k4_bwd": launches["flash_attention_fwd_bwd_gpt2"],
          "seconds": seconds, "tok_s": steps * GPT_SCRIPT["batch_size"] * GPT_SCRIPT["max_length"] / seconds})
    if launches["flash_attention_fwd_bwd_gpt2"] != 12 * steps:
        raise AssertionError(f"gpt2 training_eval_loop: {launches['flash_attention_fwd_bwd_gpt2']} K4 backward "
                             f"launches in {steps} steps")
    del model
    torch.cuda.empty_cache()


def llama_cfg(n_layers, dtype):
    """``LLAMA32_SMALL_CONFIG_1B`` (Llama-3.2-1B's widths: d 2048, 32 q / 8 kv
    heads of 64, FFN 8192, vocabulary 128,256, tied head) at ``n_layers`` of
    its 16; the model runs the unscaled RoPE tables (its "rope_freq" is
    refused by ``rope_tables(scaled=True)``, as JAX's is)."""
    from llm_quest_tpu_torch.config import LLAMA32_SMALL_CONFIG_1B

    return dict(LLAMA32_SMALL_CONFIG_1B, n_layers=n_layers, dtype=dtype)


def llama_train(records, card):
    """Llama-3.2-1B: the fp32 check (2 layers, b 1, s 2048: loss and
    gradients through the kernels against the plain versions), then the
    full model (16 layers) at b 4, s 2048, bf16, fused-head CE over the tied
    table, 1 + 4 steps: K4 forward and backward 16 times a step (GQA 32/8,
    d 64), all on the tensor cores."""
    import torch

    from llm_quest_tpu_torch.models import llama3

    grads_check("llama_fp32", llama3, llama_cfg(2, torch.float32), 1, 2048)
    n = llama_cfg(16, torch.bfloat16)["n_layers"]
    train_run(LLAMA_TRAIN, llama3, llama_cfg(n, torch.bfloat16), records, card, LLAMA_TRAIN,
              {"flash_attention_fwd": n, "flash_attention_fwd_bwd_llama": n})


def hyper_model(hc_type):
    """``models.hyper_qwen3`` with ``init`` building ``hc_type`` bundles over
    HC_STREAMS streams (the entry the train step and ``grads_check`` take)."""
    import types

    from llm_quest_tpu_torch.models import hyper_qwen3

    return types.SimpleNamespace(
        __name__=f"hyper_qwen3[{hc_type}]", apply=hyper_qwen3.apply, head_weights=hyper_qwen3.head_weights,
        init=partial(hyper_qwen3.init, hc_type=hc_type, expansion_rate=HC_STREAMS))


def hyper_cfg(n_layers, dtype):
    """``qwen3_config_creator("0.6B")`` (Qwen/Qwen3-0.6B's widths: d 1024,
    16 q / 8 kv heads of 128, FFN 3072, vocabulary 151,936, tied head) at
    ``n_layers`` of its 28."""
    from llm_quest_tpu_torch.config import qwen3_config_creator

    return dict(qwen3_config_creator("0.6B"), n_layers=n_layers, dtype=dtype)


def hyper_qwen3_train(records, card):
    """Hyper-Qwen3 at Qwen3-0.6B's widths with HC_STREAMS streams: the fp32
    check of each ``hc_type`` (hc, mhc, mhc-lite; 2 layers, b 1, s 2048:
    loss and gradients, the bundles' included, through the kernels against
    the plain versions, each bundle leaf relative to its bundle's largest
    gradient), then mHC-lite at HYPER_LAYERS of 28 layers, b 4, s
    2048, bf16, fused-head CE, 1 + 4 steps: K4 forward and backward once a
    layer a step (16/8 heads of 128), all on the tensor cores."""
    import torch

    # at init the streams are equal: an H_pre gradient is a sum over tokens that nearly cancels (the
    # RMSNorm after it is almost scale-invariant), and mHC's H_res gradients pass through a projection
    # near a permutation (exp(-8) off its diagonal). Such a leaf's fp32 noise is its own scale (0.1 of
    # it on the CPU, fp32 against fp64), but at most 2e-5 of its bundle's largest gradient: every
    # bundle leaf is held to that
    for hc_type in ("hc", "mhc", "mhc-lite"):
        grads_check(f"hyper_qwen3_fp32_{hc_type}", hyper_model(hc_type), hyper_cfg(2, torch.float32), 1, 2048,
                    group=lambda n: n.split(".hc_")[0] + ".hc_" + n.split(".hc_")[1].split(".")[0]
                    if ".hc_" in n else None)
    train_run(HYPER_TRAIN, hyper_model("mhc-lite"), hyper_cfg(HYPER_LAYERS, torch.bfloat16), records, card,
              HYPER_TRAIN, {"flash_attention_fwd": HYPER_LAYERS, "flash_attention_bwd": HYPER_LAYERS})


# ------------------------------------------ the alignment stack over GPT-2 124M

ALIGN_CONTEXT = 512  # the alignment scripts' context (scripts/dpo_training.py:23 and the others)
ALIGN_PAD = 50256  # GPT-2's <|endoftext|>: the pad and the EoS
# the loops' learning rates: classifier_training_loop's, dpo_training_loop's, and scripts/rlhf_grpo_training.py's
# RM_LR and POLICY_LR (RLVR's peak_lr default too)
CLASSIFIER_LR, DPO_LR, RM_LR, POLICY_LR = 5e-5, 5e-6, 1e-5, 1e-6
RM_READOUTS = ("scores_mean_pooling", "hidden_states_pooling", "last_token")
# the update's other losses, each run once on the GRPO phase's experience
GRPO_OTHER_LOSSES = ({"variant": "dapo"}, {"variant": "dr_grpo"}, {"variant": "sapo"}, {"variant": "gspo"},
                     {"opsm_delta": 0.5}, {"unbiased_kl": True})
RLVR_GEN, RLVR_PROMPTS = 64, 2
# GSM8K-like entries for RLVR and RPT: no dataset ships with the repository (the scripts' synthetic fallback)
RLVR_ENTRIES = [
    {"question": "Natalia sold clips to 48 of her friends in April, and then she sold half as many clips in May. "
                 "How many clips did Natalia sell altogether in April and May? Answer with one number only.",
     "answer": "In May she sold 48 / 2 = 24 clips. Altogether she sold 48 + 24 = 72 clips.\n#### 72"},
    {"question": "Weng earns 12 dollars an hour for babysitting. Yesterday, she just did 50 minutes of babysitting. "
                 "How much did she earn? Answer with one number only, in dollars, without the unit.",
     "answer": "She earns 12 / 60 = 0.2 dollars a minute. For 50 minutes she earned 0.2 x 50 = 10 dollars.\n#### 10"},
]


class ByteTokenizer:
    """UTF-8 bytes as ids 0-255, inside GPT-2's vocabulary (the scripts'
    ``_ByteTok``); decoding drops any other id."""

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return bytes(int(i) for i in ids if int(i) < 256).decode("utf-8", errors="ignore")


def align_cfg(n_layers, dtype):
    """The alignment scripts' model: ``GPT_SMALL_CONFIG`` (GPT-2 124M's
    widths: d 768, 12 heads of 64, vocabulary 50,304, no q/k/v bias) at
    context 512 and ``n_layers`` of its 12."""
    from llm_quest_tpu_torch.config import GPT_SMALL_CONFIG

    return dict(GPT_SMALL_CONFIG, context_length=ALIGN_CONTEXT, n_layers=n_layers, dtype=dtype)


def classifier_batch(b, seed=SEED):
    """``b`` texts of U[200, 512] random ids right-padded with the EoS id,
    with 0/1 labels (``spam_dataset``'s layout)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(200, ALIGN_CONTEXT + 1, b)
    ids = np.full((b, lens.max()), ALIGN_PAD, np.int32)
    mask = np.zeros(ids.shape, bool)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(0, ALIGN_PAD, n)
        mask[i, :n] = True
    return {"input_ids": ids, "targets": rng.integers(0, 2, b).astype(np.int32), "attn_mask": mask}


def pref_pairs(n, seed=SEED):
    """``n`` preference pairs: prompts of U[64, 128] random ids, chosen and
    rejected each the prompt and a response of U[128, 384]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        prompt = rng.integers(0, ALIGN_PAD, rng.integers(64, 129)).tolist()
        out.append({"prompt": prompt, **{key: prompt + rng.integers(0, ALIGN_PAD, rng.integers(128, 385)).tolist()
                                         for key in ("chosen", "rejected")}})
    return out


def grpo_prompt_batch(seed=SEED):
    """GRPO_PROMPTS prompts of U[128, 256] random ids (the last 256 long, so
    the phase pads to GRPO_PROMPT columns), ``prompt_collator``'s."""
    import numpy as np

    from llm_quest_tpu_torch.alignment import grpo

    rng = np.random.default_rng(seed)
    lens = [*rng.integers(128, GRPO_PROMPT + 1, GRPO_PROMPTS - 1), GRPO_PROMPT]
    return grpo.prompt_collator([rng.integers(0, ALIGN_PAD, n).tolist() for n in lens], ALIGN_PAD)


def rm_module():
    """``alignment.grpo`` as a model module for ``init_model`` / ``grads_check``: the reward model."""
    import types

    from llm_quest_tpu_torch.alignment import grpo

    return types.SimpleNamespace(__name__="reward_model", init=grpo.init_reward_model)


def rm_loss(cfg, model, batch, readout="scores_mean_pooling"):
    """The Bradley–Terry loss of a ``pref_reward_collate`` batch."""
    from llm_quest_tpu_torch.alignment import grpo

    rewards = [grpo.reward_model_apply(model, cfg, batch[key], attn_mask=batch[f"{key}_attn_mask"],
                                       reward_mask=batch[f"{key}_mask"], readout=readout)
               for key in ("chosen", "rejected")]
    return grpo.bt_loss(*rewards)


def rm_reward(rm, cfg):
    """The RLHF loop's reward function over ``rm`` (the default readout)."""
    from llm_quest_tpu_torch.alignment import grpo

    return lambda responses, reward_masks, attn_masks: grpo.reward_model_apply(
        rm, cfg, responses, attn_mask=attn_masks, reward_mask=reward_masks)


def on_card(batch, rows=None):
    from llm_quest_tpu_torch.training import engine

    return engine.as_tensors({k: v[:rows] for k, v in batch.items()}, DEVICE)


def timed_steps(step, n):
    """``step()`` ``n`` times, each ended by a device sync: (its results, the ms of each)."""
    import torch

    outs, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        outs.append(step())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def finite(phase, values):
    """``values`` (numbers or 0-d tensors) as floats; fails unless all are finite."""
    values = [float(x) for x in values]
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"{phase}: values not finite: {values}")
    return values


def align_launches(phase, records, expect):
    """``read_launches`` of the path just driven; each count of ``expect``
    (record name: launches) must be exact. Returns the counts, with the K4
    launches on the tensor cores."""
    from llm_quest_tpu_torch.kernels import attention as attn

    launches = read_launches(phase, records)
    for name, n in expect.items():
        if launches[name] != n:
            raise AssertionError(f"{phase} {name}: {launches[name]} launches, expected {n}")
    return {"k4_fwd": attn.flash_attention.launches, "k4_fwd_tc": attn.flash_attention.tc_launches,
            "k4_bwd": attn.flash_attention_bwd.launches, "k4_bwd_tc": attn.flash_attention_bwd.tc_launches}


def phase_k4(mask=None, s=None, b=8):
    """K4 forward and backward in bf16 at a phase's own (b, s) (the shape of
    ``mask``, its batch's key mask, where the phase has one), GPT-2's 12 heads
    of 64, causal, against the plain version: within TOL, per 64-row tile within
    TILE_TOL beside the dropped-tile control, a masked key's dk and dv exactly
    zero. Run before the phase's counted window, so its launches are not the
    path's. Returns the readings."""
    import torch

    if mask is not None:
        b, s = mask.shape
    case = k4_case(torch.Generator(device=DEVICE).manual_seed(SEED + 4), (torch.bfloat16,),
                   shape=dict(GPT2_K4, b=b, s=s), backward=True, tiles=True,
                   key_mask=None if mask is None else lambda *_: mask, timed=False)
    reading = {"b": b, "s": s, "key_mask": mask is not None, "max_abs_err": case["max_abs_err"],
               "tile_err": case["tile_err"], "tile_err_dropped_tile": case["tile_err_dropped_tile"]}
    if mask is not None:
        reading.update({key: case[key] for key in ("masked_keys", "masked_key_grad_max")})
    return reading


def align_emit(phase, card, launches, ms, tokens, **extra):
    """The phase's line: step ms (the mean past the first step), tokens a
    second over the step, peak memory and the K4 launches."""
    import torch

    step_ms = statistics.mean(ms[1:]) if len(ms) > 1 else ms[0]
    emit({"phase": phase, "card": card, "dtype": "bfloat16", "layers": 12, "step_ms": step_ms, "step_ms_each": ms,
          "tokens_per_step": tokens, "tok_s": tokens / step_ms * 1e3,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **launches, **extra})


def classifier_train(records, card):
    """Classifier tuning (``training/classifier.py``) over GPT-2 124M: the
    fp32 check (2 layers, 2 rows: the last-token CE and every gradient
    through the kernels against the plain versions), then 12 layers in bf16
    at b 8, texts of U[200, 512] ids right-padded (K4 with the padding key
    mask), 1 + 4 steps of ``make_classifier_train_step`` at
    ``classifier_training_loop``'s settings and ``classifier_accuracy``: K4
    forward and backward 12 times a step, 12 more forwards in the accuracy."""
    import torch

    from llm_quest_tpu_torch.models import gpt2
    from llm_quest_tpu_torch.training import classifier, engine

    batch = classifier_batch(8)
    small = on_card(batch, 2)
    grads_check("classifier_fp32", gpt2, align_cfg(2, torch.float32), 2, small["input_ids"].shape[1],
                loss_fn=lambda cfg, model, b: engine.make_loss_fn(gpt2, cfg, classification=True)(model, b),
                batch=small)
    tb = on_card(batch)
    k4 = phase_k4(tb["attn_mask"])
    cfg = align_cfg(12, torch.bfloat16)
    model = init_model(gpt2, cfg)
    optimizer = engine.adamw(CLASSIFIER_LR, weight_decay=0.1)
    state = optimizer.init(model)
    step = classifier.make_classifier_train_step(gpt2, cfg, optimizer)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(lambda: step(model, state, tb)[2], 5)
    accuracy = classifier.classifier_accuracy([tb], classifier.make_classifier_eval_step(gpt2, cfg), model)
    torch.cuda.synchronize()
    launches = align_launches(CLASSIFIER_TRAIN, records, {"flash_attention_fwd_gpt2": 12 * 6,
                                                          "flash_attention_fwd_bwd_gpt2": 12 * 5})
    align_emit(CLASSIFIER_TRAIN, card, launches, ms, tb["input_ids"].numel(), b=8, s=tb["input_ids"].shape[1],
               lr=CLASSIFIER_LR, losses=finite(CLASSIFIER_TRAIN, losses), accuracy=accuracy, k4_check=k4)
    del model, state
    torch.cuda.empty_cache()


def dpo_train(records, card):
    """DPO (``alignment/dpo.py``) over GPT-2 124M: the fp32 check (2 layers,
    2 pairs, a reference of other weights: the loss and every policy
    gradient through the kernels against the plain versions), then 12
    layers in bf16 at b 8 pairs (prompts U[64, 128], responses U[128, 384],
    ``dpo_collate`` cut at 512), 1 + 4 steps of ``make_dpo_train_step`` at
    ``dpo_training_loop``'s settings (the reference a copy of the policy)
    and one ``dpo_evaluate``: K4 (causal, no key mask) 48 forwards and 24
    backwards a step, 48 forwards in the evaluation."""
    import copy

    import torch

    from llm_quest_tpu_torch.alignment import dpo
    from llm_quest_tpu_torch.data.datasets import dpo_collate
    from llm_quest_tpu_torch.models import gpt2
    from llm_quest_tpu_torch.training import engine

    batch = dpo_collate(pref_pairs(8), ALIGN_PAD, allowed_max_length=ALIGN_CONTEXT)
    cfg32 = align_cfg(2, torch.float32)
    ref32 = gpt2.init(cfg32, generator=torch.Generator(device=DEVICE).manual_seed(SEED + 1), device=DEVICE)
    small = on_card(batch, 2)
    grads_check("dpo_fp32", gpt2, cfg32, 2, small["chosen"].shape[1], batch=small,
                loss_fn=lambda cfg, model, b: dpo.dpo_forward(gpt2, cfg, model, ref32, b)[0])
    del ref32
    tb = on_card(batch)
    k4 = phase_k4(s=tb["chosen"].shape[1])  # chosen and rejected share the length; causal, no key mask
    cfg = align_cfg(12, torch.bfloat16)
    policy = init_model(gpt2, cfg)
    reference = copy.deepcopy(policy)
    optimizer = engine.adamw(DPO_LR)
    state = optimizer.init(policy)
    step = dpo.make_dpo_train_step(gpt2, cfg, optimizer)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    metrics, ms = timed_steps(lambda: step(policy, state, reference, tb)[2], 5)
    val_loss, val_margin = dpo.dpo_evaluate(gpt2, cfg, policy, reference, [tb])
    launches = align_launches(DPO_TRAIN, records, {"flash_attention_fwd_gpt2": 48 * 6,
                                                   "flash_attention_fwd_bwd_gpt2": 24 * 5})
    align_emit(DPO_TRAIN, card, launches, ms, tb["chosen"].numel() + tb["rejected"].numel(), b=8,
               s=tb["chosen"].shape[1], lr=DPO_LR, losses=finite(DPO_TRAIN, [m["loss"] for m in metrics]),
               margins=finite(DPO_TRAIN, [m["chosen_rewards"] - m["rejected_rewards"] for m in metrics]),
               val_loss=finite(DPO_TRAIN, [val_loss])[0], val_margin=val_margin, k4_check=k4)
    del policy, reference, state
    torch.cuda.empty_cache()


def rm_train(records, card):
    """The reward model (``alignment/grpo.py``: a GPT-2 body and a scalar
    head): the fp32 check (2 layers, 2 pairs of ``pref_reward_collate``,
    right-padded: the BT loss and every gradient through the kernels
    against the plain versions; the head's bias and the final LayerNorm's
    shift, which the loss's reward differences cancel, against the head's
    scale), then 12 layers in bf16 on ``dpo_train``'s 8 pairs, one step of
    ``make_rm_train_step`` for each readout (the RLHF script's RM_LR) and
    ``rm_evaluate``: K4 with the padding key mask 24 forwards and 24
    backwards a step, 24 forwards in the evaluation."""
    import torch

    from llm_quest_tpu_torch.alignment import grpo
    from llm_quest_tpu_torch.data.datasets import pref_reward_collate
    from llm_quest_tpu_torch.training import engine

    batch = pref_reward_collate(pref_pairs(8), ALIGN_PAD, allowed_max_length=ALIGN_CONTEXT)
    small = on_card(batch, 2)
    grads_check("rm_fp32", rm_module(), align_cfg(2, torch.float32), 2, small["chosen"].shape[1], batch=small,
                loss_fn=rm_loss, invariant=lambda n: "head.w" if n in ("head.b", "body.final_ln.shift") else None)
    tb = on_card(batch)
    k4 = [phase_k4(tb[f"{key}_attn_mask"]) for key in ("chosen", "rejected")]
    cfg = align_cfg(12, torch.bfloat16)
    rm = init_model(rm_module(), cfg)
    optimizer = engine.adamw(RM_LR)
    state = optimizer.init(rm)
    steps = [grpo.make_rm_train_step(cfg, optimizer, readout=r) for r in RM_READOUTS]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, ms = [], []
    for step in steps:
        o, t = timed_steps(lambda step=step: step(rm, state, tb)[2:], 1)
        out += o
        ms += t
    val_loss, val_acc = grpo.rm_evaluate(rm, cfg, [tb])
    launches = align_launches(RM_TRAIN, records, {"flash_attention_fwd_gpt2": 24 * 4,
                                                  "flash_attention_fwd_bwd_gpt2": 24 * 3})
    align_emit(RM_TRAIN, card, launches, ms, tb["chosen"].numel() + tb["rejected"].numel(), b=8,
               s=tb["chosen"].shape[1], lr=RM_LR, readouts=list(RM_READOUTS),
               losses=finite(RM_TRAIN, [o[0] for o in out]), accuracies=[float(o[1]) for o in out],
               val_loss=finite(RM_TRAIN, [val_loss])[0], val_accuracy=val_acc, k4_check=k4)
    del rm, state
    torch.cuda.empty_cache()


def experience_checks(phase, exp, num_samples, prompt_masks):
    """What can be checked of a sampled experience: the key masks keep each
    prompt's own mask (holes where it was padded) and one first-EoS-cut
    response after it, the log-probabilities are finite, and each group's
    advantages average to zero. Returns readings."""
    import torch

    masks, reward = exp["attn_masks"], exp["reward_masks"]
    p = prompt_masks.shape[1]
    prompt = torch.as_tensor(prompt_masks, device=DEVICE).repeat_interleave(num_samples, 0)
    if not torch.equal(masks[:, :p], prompt) or reward[:, :p].any() or not torch.equal(reward[:, p:], masks[:, p:]):
        raise AssertionError(f"{phase}: the key masks do not keep the prompts' masks before the responses")
    kept = masks[:, p:].long()
    if not bool((kept[:, 1:] <= kept[:, :-1]).all()) or not bool(kept[:, 0].all()):
        raise AssertionError(f"{phase}: a response's mask is not one run from its first token")
    holes = int((~prompt).sum())
    for key in ("old_logprobs", "ref_logprobs", "advantages", "rewards"):
        if not bool(torch.isfinite(exp[key]).all()):
            raise AssertionError(f"{phase}: {key} not finite")
    group_mean = float(exp["advantages"].view(-1, num_samples).mean(1).abs().max())
    if not group_mean <= 1e-5:
        raise AssertionError(f"{phase}: advantages' group means {group_mean} away from zero")
    return {"holes": holes, "response_tokens": int(kept.sum()), "advantage_group_mean_max": group_mean,
            "reward_mean": float(exp["rewards"].float().mean())}


def grpo_fp32(phase, exp, num_samples, **kw):
    """``grads_check`` of the GRPO update's loss on an experience sampled
    from the 2-layer fp32 policy (``init_model``'s weights), its old and
    reference log-probabilities moved by seeded noise (σ 0.3) and its
    advantages the z-scores of seeded rewards: as sampled, the ratio is 1,
    the KL 0 and (RLVR's unanswered responses) the rewards equal, and the
    loss nearly vanishes."""
    import torch

    from llm_quest_tpu_torch.alignment import grpo
    from llm_quest_tpu_torch.models import gpt2

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    old = exp["old_logprobs"] + randn(gen, *exp["old_logprobs"].shape, scale=0.3)
    exp = dict(exp, old_logprobs=old, ref_logprobs=old + randn(gen, *old.shape, scale=0.3),
               advantages=grpo.z_scores(randn(gen, old.shape[0]), num_samples))
    grads_check(phase, gpt2, align_cfg(2, torch.float32), *exp["responses"].shape, batch=exp,
                loss_fn=lambda cfg, model, b: grpo.grpo_loss(gpt2, cfg, model, b, num_samples=num_samples, **kw)[0])


def grpo_rlhf(records, card):
    """RLHF-GRPO (``alignment/grpo.py``) over GPT-2 124M, on GRPO_PROMPTS
    prompts of U[128, 256] ids × GRPO_SAMPLES samples, 128 generated tokens
    at temperature 1.0 from a generator on the card, the reward model of
    the same widths: the fp32 check (2 layers: the update's loss and every
    gradient on a sampled experience with holed key masks, through the
    kernels against the plain versions), then 12 layers in bf16: one batch
    of ``rlhf_grpo_training_loop`` (sampling through the cache, scoring,
    2 updates; timed as one GRPO iteration: K4 60 forwards and 24 backwards
    on the holed key masks), then ``grpo_experience`` again (its masks,
    finite log-probabilities, advantages' group means zero) and one update
    of each other loss (dapo, dr_grpo, sapo, gspo, OPSM at 0.5, the
    unbiased KL) on it: 36 + 72 forwards, 72 backwards."""
    import copy

    import torch

    from llm_quest_tpu_torch.alignment import grpo
    from llm_quest_tpu_torch.models import gpt2
    from llm_quest_tpu_torch.training import engine

    prompts = grpo_prompt_batch()
    kw = dict(num_samples=GRPO_SAMPLES, max_gen=GRPO_GEN, temp=1.0, eos_id=ALIGN_PAD, pad_id=ALIGN_PAD)
    cfg32 = align_cfg(2, torch.float32)
    policy = init_model(gpt2, cfg32)
    rm = rm_module().init(cfg32, generator=torch.Generator(device=DEVICE).manual_seed(SEED + 2), device=DEVICE)
    exp = grpo.grpo_experience(gpt2, cfg32, policy, copy.deepcopy(policy), prompts, rm_reward(rm, cfg32),
                               generator=torch.Generator(device=DEVICE).manual_seed(SEED), **kw)
    experience_checks("grpo_fp32", exp, GRPO_SAMPLES, prompts["prompt_masks"])
    grpo_fp32("grpo_fp32", exp, GRPO_SAMPLES, max_gen=GRPO_GEN)
    k4 = phase_k4(exp["attn_masks"])  # the sampled experience's holed key mask
    del policy, rm, exp

    cfg = align_cfg(12, torch.bfloat16)
    policy = init_model(gpt2, cfg)
    reference = copy.deepcopy(policy)
    rm = rm_module().init(cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED + 2), device=DEVICE)
    generator = torch.Generator(device=DEVICE).manual_seed(SEED)
    logs = []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy, metrics = grpo.rlhf_grpo_training_loop(
        gpt2, cfg, policy, reference, rm, cfg, [prompts], num_grad_updates=2, lr=POLICY_LR, generator=generator,
        log=logs.append, **kw)
    torch.cuda.synchronize()
    iteration_s = time.perf_counter() - t0
    iteration_peak = torch.cuda.max_memory_allocated() / 1e9
    loop_launches = align_launches(GRPO_RLHF, records, {"flash_attention_fwd_gpt2": 60,
                                                        "flash_attention_fwd_bwd_grpo": 24})
    finite(GRPO_RLHF, [metrics[0][k] for k in ("loss", "kl", "reward")])

    reset_launches()
    t0 = time.perf_counter()
    exp = grpo.grpo_experience(gpt2, cfg, policy, reference, prompts, rm_reward(rm, cfg), generator=generator, **kw)
    torch.cuda.synchronize()
    experience_s = time.perf_counter() - t0
    readings = experience_checks(GRPO_RLHF, exp, GRPO_SAMPLES, prompts["prompt_masks"])
    optimizer = engine.adamw(POLICY_LR)
    state = optimizer.init(policy)
    updates = [grpo.make_grpo_update_step(gpt2, cfg, optimizer, num_samples=GRPO_SAMPLES, max_gen=GRPO_GEN, **o)
               for o in GRPO_OTHER_LOSSES]
    out, ms = [], []
    for update in updates:
        o, t = timed_steps(lambda update=update: update(policy, state, exp)[2], 1)
        out += o
        ms += t
    launches = align_launches(GRPO_RLHF, records, {"flash_attention_fwd_gpt2": 36 + 72,
                                                   "flash_attention_fwd_bwd_grpo": 72})
    align_emit(GRPO_RLHF, card, launches, ms, exp["responses"].numel(), b=GRPO_K4["b"],
               s=exp["responses"].shape[1], lr=POLICY_LR, iteration_s=iteration_s, iteration_metrics=metrics[0],
               iteration_launches=loop_launches, iteration_peak_mem_gb=iteration_peak, experience_s=experience_s,
               losses={json.dumps(o): finite(GRPO_RLHF, [m["loss"], m["kl"]]) for o, m in zip(GRPO_OTHER_LOSSES, out)},
               k4_check=k4, **readings)
    del policy, reference, rm, exp, state
    torch.cuda.empty_cache()


def rlvr_batches(tok):
    """One RLVR batch (RLVR_ENTRIES' questions in the DeepSeek format, their
    gold answers) and one RPT batch (two of ``rpt_structured_dataset``'s
    pairs over the same entries, contexts up to 448 tokens with the
    default instruction, 8-token labels), ``rlvr_prompt_collator``'s."""
    from llm_quest_tpu_torch.alignment import rlvr
    from llm_quest_tpu_torch.data.datasets import rpt_structured_dataset
    from llm_quest_tpu_torch.utils import alpaca_deepseek_format

    items = [{"prompt": tok.encode(alpaca_deepseek_format(e, include_response=False)),
              "answer": e["answer"].rpartition("####")[2].strip()} for e in RLVR_ENTRIES]
    _, allowed, getter = rpt_structured_dataset(RLVR_ENTRIES, tok, ALIGN_CONTEXT - RLVR_GEN, labels_length=8)
    pairs = [getter(len(allowed) // 3), getter(2 * len(allowed) // 3)]
    return rlvr.rlvr_prompt_collator(items, ALIGN_PAD), rlvr.rlvr_prompt_collator(pairs, ALIGN_PAD)


def rlvr_rpt(records, card):
    """RLVR and RPT (``alignment/rlvr.py``, ``alignment/rpt.py``) over GPT-2
    124M with a byte tokenizer: the fp32 check (2 layers: the update's loss
    and every gradient on an RLVR experience, through the kernels against
    the plain versions), then 12 layers in bf16: one batch of
    ``rlvr_grpo_training_loop`` with the verifier (RLVR_PROMPTS prompts × 4
    samples, 64 generated tokens at temperature 1.0, 2 updates) and one with
    the prefix-matching reward over RPT pairs: K4 48 forwards and 24
    backwards a loop."""
    import copy

    import torch

    from llm_quest_tpu_torch.alignment import grpo, rlvr, rpt
    from llm_quest_tpu_torch.models import gpt2

    tok = ByteTokenizer()
    rlvr_batch, rpt_batch = rlvr_batches(tok)
    kw = dict(num_samples=GRPO_SAMPLES, max_gen=RLVR_GEN, temp=1.0, eos_id=ALIGN_PAD, pad_id=ALIGN_PAD)
    verifier = rlvr.VerifiableRewardCalculator(tok, pad_token_id=ALIGN_PAD)
    rewards = {"rlvr": verifier, "rpt": rpt.PrefixMatchingReward(tok, pad_token_id=ALIGN_PAD)}
    cfg32 = align_cfg(2, torch.float32)
    policy = init_model(gpt2, cfg32)
    k4 = {}
    for (name, reward), batch in zip(rewards.items(), (rlvr_batch, rpt_batch)):
        answers = [a for a in batch["answers"] for _ in range(GRPO_SAMPLES)]
        exp = grpo.grpo_experience(
            gpt2, cfg32, policy, copy.deepcopy(policy), batch,
            lambda r, m, a, reward=reward, answers=answers: reward(torch.where(m, r, ALIGN_PAD), answers),
            generator=torch.Generator(device=DEVICE).manual_seed(SEED), **kw)
        experience_checks(f"{name}_fp32", exp, GRPO_SAMPLES, batch["prompt_masks"])
        if name == "rlvr":
            grpo_fp32("rlvr_fp32", exp, GRPO_SAMPLES, max_gen=RLVR_GEN, opsm_delta=0.5)
        k4[name] = phase_k4(exp["attn_masks"])  # the sampled experience's holed key mask
    del policy, exp

    cfg = align_cfg(12, torch.bfloat16)
    policy = init_model(gpt2, cfg)
    reference = copy.deepcopy(policy)
    generator = torch.Generator(device=DEVICE).manual_seed(SEED)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, ms = [], []
    for batch, reward in zip((rlvr_batch, rpt_batch), rewards.values()):
        o, t = timed_steps(lambda batch=batch, reward=reward: rlvr.rlvr_grpo_training_loop(
            gpt2, cfg, policy, reference, [batch], reward, num_grad_updates=2, peak_lr=POLICY_LR,
            generator=generator, log=lambda _: None, **kw)[1][0], 1)
        out += o
        ms += t
    launches = align_launches(RLVR_RPT, records, {"flash_attention_fwd_gpt2": 2 * 48,
                                                  "flash_attention_fwd_bwd_grpo": 2 * 24})
    for m in out:
        finite(RLVR_RPT, [m[k] for k in ("loss", "kl", "reward")])
    emit({"phase": RLVR_RPT, "card": card, "dtype": "bfloat16", "layers": 12, "lr": POLICY_LR,
          "loop_ms": dict(zip(("rlvr", "rpt"), ms)), "rows": GRPO_SAMPLES * RLVR_PROMPTS, "max_gen": RLVR_GEN,
          "prompt_columns": [b["padded_prompts"].shape[1] for b in (rlvr_batch, rpt_batch)],
          "metrics": dict(zip(("rlvr", "rpt"), out)), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "k4_check": k4, **launches})
    del policy, reference
    torch.cuda.empty_cache()



# ------------------------------------------------------------ serving paths


# ------------------------------------------------------------ the ViT→GPT-2 VLM, the uint8 encoder, the HF
# loaders, the training ops

VLM_STEPS = 3  # timed steps after the warm-up
VLM_LR = 1e-4  # scripts/vlm_training.py's optax.adamw(1e-4)
VLM_GEN = 30  # caption tokens
UINT8_B, UINT8_SIDE = 128, 256  # the encoder's batch and its raw images' side, resized to 224
DIGIT_IDS = range(15, 25)  # GPT-2's "0".."9"


def vlm_models(n_layers, dtype):
    """The VLM at ``n_layers`` (ViT and GPT-2 alike), seeded: ViT-B/16 at 224
    px without dropout (``vit_cfg``), an "ffn" adapter (768 → 3,072 → 768)
    and GPT-2 124M's widths. Returns (vit cfg, ViT, adapter, GPT-2 cfg, GPT-2)."""
    import torch

    from llm_quest_tpu_torch.config import GPT_CONFIG_124M
    from llm_quest_tpu_torch.models import gpt2, vit
    from llm_quest_tpu_torch.multimodal import vlm

    vcfg, gcfg = vit_cfg(n_layers, dtype), gpt2_cfg(GPT_CONFIG_124M, n_layers, dtype)
    adapter = vlm.init_adapter(vcfg["emb_dim"], gcfg["emb_dim"], adapter_type="ffn", dtype=dtype, device=DEVICE,
                               generator=torch.Generator(device=DEVICE).manual_seed(SEED + 2))
    return vcfg, init_model(vit, vcfg), adapter, gcfg, init_model(gpt2, gcfg)


def vlm_batch(b, dtype, seed=SEED):
    """``b`` N(0, 1) images at 224 px and captions of ``vlm_caption_lens``
    random ids right-padded with GPT-2's EoS to VLM_TEXT, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    ids = np.full((b, VLM_TEXT), ALIGN_PAD, np.int64)
    mask = np.zeros((b, VLM_TEXT), bool)
    for i, n in enumerate(vlm_caption_lens(b)):
        ids[i, :n] = rng.integers(0, ALIGN_PAD, n)
        mask[i, :n] = True
    return {"image": images(b, dtype), "input_ids": torch.as_tensor(ids, device=DEVICE),
            "attention_mask": torch.as_tensor(mask, device=DEVICE)}


def vlm_parts():
    """A ``grads_check`` model module over the VLM: its ``init(cfg)`` gives
    one ModuleDict {"vit", "adapter", "gpt2"} at cfg's depth and dtype."""
    import types

    import torch

    def init(cfg, **_):
        _, vit_m, adapter, _, gpt = vlm_models(cfg["n_layers"], cfg["dtype"])
        return torch.nn.ModuleDict({"vit": vit_m, "adapter": adapter, "gpt2": gpt})

    return types.SimpleNamespace(init=init)


def vlm_loss_fn(vcfg):
    """``grads_check``'s loss over ``vlm_parts``: the captioning loss, the ViT
    and GPT-2 through the kernels or both through the plain versions."""
    from llm_quest_tpu_torch.models import vit
    from llm_quest_tpu_torch.multimodal import vlm

    def loss_fn(cfg, model, batch):
        run_vcfg = dict(vcfg, use_kernels=cfg.get("use_kernels", True))
        return vlm.vlm_forward_loss(vit, model["vit"], run_vcfg, model["adapter"], model["gpt2"], cfg, batch)

    return loss_fn


def phase_k7(shape):
    """K7's bf16 forward at a phase's own shape against the plain version in
    fp32 on the same values (``short_check``: within TOL, per 64-row tile
    within TILE_TOL), beside the tile readings of the plain version with the
    64 keys [s - 128, s - 64) dropped, which must exceed TILE_TOL. Run before
    the phase's counted window. Returns the readings."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn
    from llm_quest_tpu_torch.ops.attention import merge_heads, sdpa, split_heads

    b, s, h, d = shape
    q, k, v = packed_inputs(torch.Generator(device=DEVICE).manual_seed(SEED + 5), shape, torch.bfloat16)
    got = attn.packed_mha(q, k, v, h)
    ref = attn.packed_mha(q.float(), k.float(), v.float(), h, plain=True)
    err, tiles = short_check(f"K7 {shape} (phase)", (got,), (ref,), ("o",), torch.bfloat16, s)
    dropped = torch.zeros(1, 1, 1, s, dtype=torch.bool, device=DEVICE)
    dropped[..., s - 128 : s - 64] = True  # True = masked
    control = merge_heads(sdpa(*(split_heads(t.float(), h) for t in (q, k, v)), mask=dropped))
    control_tiles = tile_readings([control.unflatten(-1, (-1, d)).transpose(1, 2)],
                                  [ref.unflatten(-1, (-1, d)).transpose(1, 2)], ("o",))
    if not control_tiles["o"] > TILE_TOL:
        raise AssertionError(f"K7 {shape} (phase): a dropped key tile reads {control_tiles}, within {TILE_TOL}")
    return {"shape": list(shape), "max_abs_err": err, "tile_err": tiles, "tile_err_dropped_tile": control_tiles}


def vlm_train(records, card):
    """The ViT→GPT-2 VLM trained (``multimodal/vlm.py``, the step of
    ``scripts/vlm_training.py``): the fp32 check (2 layers, b 4, the fused s
    261: the loss and the adapter's and GPT-2's gradients through the
    kernels against the plain versions; GPT-2's key biases, zero in exact
    arithmetic, against their weights' scale; the frozen ViT gets none),
    then K4 forward + backward and K7 in bf16 at the step's own shapes (b
    32; the batch's fused key mask) against their plain versions
    (``phase_k4``, ``phase_k7``), then 12 layers in bf16: ViT-B/16 frozen,
    the "ffn" adapter and GPT-2 124M trained by ``adamw(1e-4)``, b 32,
    captions right-padded to 64, 1 + VLM_STEPS steps: K4 forward and
    backward 12 times a step, K7 12 times (the encode), all on the tensor
    cores; the loss finite and falling; step ms, fused tokens, caption
    tokens and images a second, peak GB."""
    import torch

    from llm_quest_tpu_torch.config import GPT_CONFIG_124M
    from llm_quest_tpu_torch.kernels import attention as attn
    from llm_quest_tpu_torch.scripts import vlm_training
    from llm_quest_tpu_torch.training import engine

    s = VLM_VISION + VLM_TEXT
    grads_check("vlm_fp32", vlm_parts(), gpt2_cfg(GPT_CONFIG_124M, 2, torch.float32), 4, s,
                loss_fn=vlm_loss_fn(vit_cfg(2, torch.float32)), batch=vlm_batch(4, torch.float32),
                invariant=lambda n: n[:-2] + ".w" if n.startswith("gpt2.") and n.endswith("att.wk.b") else None)
    batch = vlm_batch(VLM_B, torch.bfloat16)
    fused_mask = torch.cat([torch.ones(VLM_B, VLM_VISION, dtype=torch.bool, device=DEVICE), batch["attention_mask"]],
                           dim=1)
    if not torch.equal(fused_mask, vlm_key_mask(VLM_B, s)):
        raise AssertionError(f"{VLM_TRAIN}: the batch's fused mask is not the K4 records' key mask")
    k4, k7 = phase_k4(fused_mask), phase_k7(VLM_K7)

    vcfg, vit_m, adapter, gcfg, gpt = vlm_models(12, torch.bfloat16)
    optimizer = engine.adamw(VLM_LR)
    state = optimizer.init([*adapter.parameters(), *gpt.parameters()])
    step = vlm_training.make_train_step(vit_m, vcfg, gcfg, optimizer)
    n = 1 + VLM_STEPS
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(lambda: step(adapter, gpt, state, batch)[3], n)
    launches = align_launches(VLM_TRAIN, records, {"flash_attention_fwd_vlm": 12 * n,
                                                   "flash_attention_fwd_bwd_vlm": 12 * n, "packed_mha_vlm": 12 * n})
    launches.update(k7=attn.packed_mha.launches, k7_tc=attn.packed_mha.tc_launches)
    losses = finite(VLM_TRAIN, losses)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{VLM_TRAIN}: the loss did not fall: {losses}")
    step_ms = statistics.mean(ms[1:])
    captions = int(batch["attention_mask"].sum())
    align_emit(VLM_TRAIN, card, launches, ms, VLM_B * s, b=VLM_B, s=s, lr=VLM_LR, losses=losses,
               caption_tokens_per_step=captions, caption_tok_s=captions / step_ms * 1e3, img_s=VLM_B / step_ms * 1e3,
               k4_check=k4, k7_check=k7)
    del vit_m, adapter, gpt, state
    torch.cuda.empty_cache()


def vlm_rerun(parts, images_, max_gen, eos=None):
    """The reference's captioning form (JAX ``vlm.py``'s docstring): each
    step re-runs the whole fused sequence uncached, with ``vlm_generate``'s
    pad and mask rules (BOS and pad GPT-2's EoS). Returns the (b, max_gen)
    tokens and each step's fp32 logits."""
    import torch

    from llm_quest_tpu_torch.models import gpt2, vit
    from llm_quest_tpu_torch.multimodal import vlm

    vcfg, vit_m, adapter, gcfg, gpt = parts
    b = images_.shape[0]
    table = gpt.tok_emb["w"]
    with torch.inference_mode():
        vision = vlm.adapter_apply(adapter, vit.apply(vit_m, vcfg, images_, output_hidden_states=True))
        seq = torch.cat([vision.to(table.dtype), table[torch.full((b, 1), ALIGN_PAD, device=DEVICE)]], dim=1)
        mask = torch.ones(b, seq.shape[1], dtype=torch.bool, device=DEVICE)
        finished = torch.zeros(b, dtype=torch.bool, device=DEVICE)
        tokens, logits_at = [], []
        for _ in range(max_gen):
            # a copy: a view of the last column would keep the whole (b, s, vocab) logits alive
            logits = gpt2.apply(gpt, gcfg, seq, attn_mask=mask, input_embedded=True)[0][:, -1].to(torch.float32,
                                                                                               copy=True)
            tok = torch.where(finished, ALIGN_PAD, logits.argmax(-1))
            finished = finished | (tok == (-1 if eos is None else eos))
            tokens.append(tok)
            logits_at.append(logits)
            seq = torch.cat([seq, table[tok][:, None]], dim=1)
            mask = torch.cat([mask, ~finished[:, None]], dim=1)
    return torch.stack(tokens, dim=1), logits_at


def caption_ties(label, got, ref, logits_at, bar, top2):
    """Rows whose cached tokens ``got`` leave the re-run's ``ref``: at the
    first step where they differ the two tokens must be a near-tie of the
    re-run's logits there (with ``top2`` its two largest, within ``bar`` ×
    max |logits| of each other; without, both within that of the largest).
    The tokens after it follow other prefixes. Returns the near-ties."""
    ties = []
    for row, (g, r) in enumerate(zip(got.tolist(), ref.tolist())):
        if g == r:
            continue
        j = next(i for i, (a, c) in enumerate(zip(g, r)) if a != c)
        logits = logits_at[j][row]
        top = logits.topk(2)
        limit = bar * float(logits.abs().max())
        gap = (float(top.values[0] - top.values[1]) if top2 else
               max(float(top.values[0] - logits[t]) for t in (g[j], r[j])))
        tied = set(top.indices.tolist()) == {g[j], r[j]} if top2 else True
        reading = {"row": row, "step": j, "tokens": [g[j], r[j]], "gap": gap, "bar": limit}
        if not (tied and gap <= limit):
            raise AssertionError(f"{label}: row {row} leaves the re-run at step {j} where the logits are no "
                                 f"near-tie: {reading}")
        ties.append(reading)
    return ties


def vlm_generate(records, card):
    """Greedy captions (``multimodal/vlm.py::vlm_generate``: one encode, the
    [vision ‖ BOS] prefill into ``gpt2.init_cache``, one-token steps in
    embedding space) at b 32, VLM_GEN tokens, BOS and pad GPT-2's EoS. In
    fp32 at 2 layers the tokens equal the reference's re-run of the whole
    fused sequence at each step (``vlm_rerun``; a near-tie within
    SPEC_TIE_BAR of the re-run's two largest logits excepted), also with an
    EOS that row 0 emits mid-caption; in bf16 at 12 layers a row leaves the
    re-run only at a near-tie within BF16_LOGIT_BAR (``near_tie``'s rule
    without ``top2``). Launches: K7 once a layer (the encode), no K4 (the
    cached prefill of 198 and the steps take ``sdpa``, as in JAX); in bf16
    all on the tensor cores. Then ms a call (32 captions) and a caption,
    caption tokens a second."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn
    from llm_quest_tpu_torch.models import vit
    from llm_quest_tpu_torch.multimodal import vlm

    readings = {}
    for n_layers, dtype in ((2, torch.float32), (12, torch.bfloat16)):
        parts = vlm_models(n_layers, dtype)
        vcfg, vit_m, adapter, gcfg, gpt = parts
        x = images(VLM_B, dtype)

        def caption(eos=None):
            return vlm.vlm_generate(vit, vit_m, vcfg, adapter, gpt, gcfg, x, ALIGN_PAD, max_gen=VLM_GEN, eos_id=eos,
                                    pad_id=ALIGN_PAD)

        reset_launches()
        got = caption()
        torch.cuda.synchronize()
        if attn.packed_mha.launches != vcfg["n_layers"] or attn.flash_attention.launches:
            raise AssertionError(f"{VLM_GENERATE}: K7 {attn.packed_mha.launches} launches (expected {vcfg['n_layers']}), "
                                 f"K4 {attn.flash_attention.launches} (expected 0: the cache path)")
        if dtype == torch.bfloat16:
            read_launches(VLM_GENERATE, records)
        ref, logits_at = vlm_rerun(parts, x, VLM_GEN)
        name = "fp32" if dtype == torch.float32 else "bf16"
        bar, top2 = (SPEC_TIE_BAR, True) if dtype == torch.float32 else (BF16_LOGIT_BAR, False)
        rec = {"layers": n_layers, "near_ties": caption_ties(f"{VLM_GENERATE} {name}", got, ref, logits_at, bar, top2),
               "tokens_equal": float((got == ref).float().mean()), "k7_launches": vcfg["n_layers"]}
        del logits_at
        if dtype == torch.float32:
            eos = int(ref[0, 3])  # row 0's fourth token, as an EOS
            got_eos = caption(eos)
            ref_eos, logits_eos = vlm_rerun(parts, x, VLM_GEN, eos=eos)
            first = int((got_eos[0] == eos).nonzero()[0])
            if not bool((got_eos[0, first + 1:] == ALIGN_PAD).all()):
                raise AssertionError(f"{VLM_GENERATE}: row 0 did not pad after its EOS: {got_eos[0].tolist()}")
            rec["eos"] = {"id": eos, "row0_eos_step": first, "rows_finished": int((got_eos == eos).any(1).sum()),
                          "near_ties": caption_ties(f"{VLM_GENERATE} fp32 eos", got_eos, ref_eos, logits_eos, bar,
                                                    top2)}
        else:
            caption()  # warm
            _, runs = timed(caption, 3)
            call_ms = 1e3 * statistics.median(runs)
            rec.update(call_ms=call_ms, call_ms_each=[1e3 * r for r in runs], ms_per_caption=call_ms / VLM_B,
                       caption_tok_s=VLM_B * VLM_GEN / call_ms * 1e3)
        readings[name] = rec
        del parts, vit_m, adapter, gpt
        torch.cuda.empty_cache()
    emit({"phase": VLM_GENERATE, "card": card, "b": VLM_B, "max_gen": VLM_GEN, **readings})


def uint8_encode(records, card, b=UINT8_B):
    """The folded uint8 ViT-B/16 encoder (``multimodal/preprocessing.py::
    make_uint8_encoder``, ImageNet's statistics, ``resize_to`` (224, 224))
    on UINT8_SIDE-pixel uint8 images, against resize, then normalize, then
    ``vit.apply``: in fp32 at 2 layers (8 images) within 10·NEW_TOL of max
    |ref|, in bf16 at 12 layers (b 128) within BF16_LOGIT_BAR of it; the
    model's own conv weights untouched. Then in bf16 at b 128: K7 12
    launches an encode on the tensor cores, img/s beside ``vit.apply`` on
    the same images already resized and normalized (``vit_encode``'s
    ViT-B/224 encode, timed in the same call)."""
    import torch

    from llm_quest_tpu_torch.data.datasets import IMAGENET_MEAN, IMAGENET_STD
    from llm_quest_tpu_torch.models import vit
    from llm_quest_tpu_torch.multimodal import preprocessing

    mean = torch.as_tensor(IMAGENET_MEAN, device=DEVICE)[None, :, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=DEVICE)[None, :, None, None]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    raw = torch.randint(0, 256, (b, 3, UINT8_SIDE, UINT8_SIDE), generator=gen, device=DEVICE, dtype=torch.uint8)
    rec = {}
    for n_layers, dtype, bar in ((2, torch.float32, 10 * NEW_TOL), (12, torch.bfloat16, BF16_LOGIT_BAR)):
        cfg = vit_cfg(n_layers, dtype)
        model = init_model(vit, cfg)
        conv_w = model.patch_emb["conv_w"].detach().clone()
        side = (cfg["img_height"], cfg["img_width"])
        encode = preprocessing.make_uint8_encoder(vit, model, cfg, IMAGENET_MEAN, IMAGENET_STD, resize_to=side)
        rows = raw if dtype == torch.bfloat16 else raw[:8]
        with torch.inference_mode():
            normalized = ((preprocessing.resize_bilinear(rows, *side) / 255.0 - mean) / std).to(dtype)
            ref = vit.apply(model, cfg, normalized, output_hidden_states=True).float()
        reset_launches()
        got = encode(rows).float()
        torch.cuda.synchronize()
        launches = read_launches(UINT8_ENCODE, records) if dtype == torch.bfloat16 else None
        err, scale = max_err(got, ref)
        if not err <= bar * scale or not torch.equal(model.patch_emb["conv_w"], conv_w):
            raise AssertionError(f"{UINT8_ENCODE} {dtype}: {err} > {bar} × {scale}, or the model's weights moved")
        name = "fp32" if dtype == torch.float32 else "bf16"
        rec[name] = {"layers": n_layers, "b": rows.shape[0], "max_abs_err": err, "max_abs_ref": scale,
                     "bar": bar * scale}
        if launches is not None:
            if launches["packed_mha"] != 12:
                raise AssertionError(f"{UINT8_ENCODE}: {launches['packed_mha']} K7 launches an encode, expected 12")

            def encodes():
                for _ in range(VIT_ENCODES):
                    encode(raw)

            def plain_encodes():
                with torch.inference_mode():
                    for _ in range(VIT_ENCODES):
                        vit.apply(model, cfg, normalized, output_hidden_states=True)

            for fn in (encodes, plain_encodes):
                fn()  # warm
            run_s, runs = timed(encodes, 3)
            vit_s, vit_runs = timed(plain_encodes, 3)
            rec[name].update(img_s=b * VIT_ENCODES / run_s, run_s=runs, vit_apply_img_s=b * VIT_ENCODES / vit_s,
                             vit_apply_run_s=vit_runs, k7_launches=launches["packed_mha"],
                             uint8_input_mb=raw.numel() / 2**20, bf16_input_mb=normalized.numel() * 2 / 2**20)
        del model, encode
        torch.cuda.empty_cache()
    emit({"phase": UINT8_ENCODE, "card": card, "raw_side": UINT8_SIDE, "encodes_per_run": VIT_ENCODES, **rec})


def hf_state_dict(model, rules, *, skip=lambda path, rule: False):
    """A synthetic HF state dict of ``model``'s leaves, torch tensors on the
    card: each JAX path (``weights/interop.py::flatten_params``, JAX's
    layout) renamed by the loader's ``rules`` walked backwards (each
    replacement back into its pattern; ``skip(path, rule)`` passes a rule
    over) and, where the rule transposes, transposed back into torch's (out,
    in); a depthwise conv (``_squeeze1``'s rule) gets its (c, 1, k) axis
    back. A leaf no rule names keeps its JAX path."""
    from llm_quest_tpu_torch.weights import interop

    state = {}
    for path, t in interop.flatten_params(model).items():
        name, transform = path, None
        for rule in reversed(rules):
            if rule[1] in name and not skip(path, rule):
                name = name.replace(rule[1], rule[0])
                transform = rule[2] if len(rule) > 2 else transform
        if transform is True:
            t = t.T
        elif callable(transform):
            t = t[:, None, :]
        state[name] = t.detach().clone()
    return state


def gpt2_hf_state(model):
    """HF GPT-2's state dict of a port GPT-2: ``GPT2_HF_RULES`` walked back,
    q/k/v fused into ``c_attn`` (in, 3d), no ``out`` head (HF's is ``wte``)."""
    import torch

    from llm_quest_tpu_torch.weights import interop

    state = {name: t for name, t in hf_state_dict(model, interop.GPT2_HF_RULES).items()
             if "/att/w" not in name and name != "out/w"}
    for i, block in enumerate(model.blocks):
        att = block.att
        state[f"h.{i}.attn.c_attn.weight"] = torch.cat([att.wq.w.T, att.wk.w.T, att.wv.w.T], dim=1).detach().clone()
        state[f"h.{i}.attn.c_attn.bias"] = torch.cat([att.wq.b, att.wk.b, att.wv.b]).detach().clone()
    return state


def loaded_check(label, source, target, logs):
    """Every leaf of ``target`` bit-equal to ``source``'s, and the loader's
    report all loaded, nothing missing. Returns the number of leaves."""
    import torch

    want = source.state_dict()
    for name, t in target.state_dict().items():
        if t.dtype != want[name].dtype or not torch.equal(t, want[name]):
            raise AssertionError(f"{label}: {name} differs from the source after the load")
    if logs != [f"Loaded {len(want)}/{len(want)} weights successfully"]:
        raise AssertionError(f"{label}: the loader reported {logs}")
    return len(want)


def hf_load(label, load, source, target, state):
    """``load(target, state, logs)`` timed, then ``loaded_check``."""
    import torch

    logs = []
    t0 = time.perf_counter()
    load(target, state, logs.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"hf_tensors": len(state), "leaves": loaded_check(label, source, target, logs), "load_s": seconds,
            "log": logs}


def hf_loaders(records, card):
    """HF checkpoints into the port (``weights/interop.py``): synthetic state
    dicts in HF's names and layouts, torch bf16 on the card, written by this
    script from seeded port models (GPT-2 124M with its head tied to
    ``wte``, as HF's is, and the Qwen3.5-0.8B VLM, text and vision), loaded
    into models of another seed: every leaf bit-equal to the source's, all
    loaded and nothing missing (as JAX's loaders report for such complete
    dicts), and the greedy tokens of the source and the loaded model
    identical (GPT-2: 16 tokens from b 4 prompts of 64; Qwen3.5: the main
    path's multimodal and text prompts, 8 tokens). Seconds of each load."""
    import torch

    from llm_quest_tpu_torch.config import GPT_CONFIG_124M, QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.models import gpt2, qwen3_5
    from llm_quest_tpu_torch.weights import interop

    def other_seed(mod, cfg):
        return mod.init(cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED + 7), device=DEVICE)

    out = {}
    cfg = gpt2_cfg(GPT_CONFIG_124M, 12, torch.bfloat16)
    source = init_model(gpt2, cfg)
    with torch.no_grad():
        source.out.w.copy_(source.tok_emb["w"])
    target = other_seed(gpt2, cfg)
    out["gpt2"] = hf_load("hf_loaders gpt2", lambda m, s, log: interop.load_hf_gpt2(m, s, log=log), source, target,
                          gpt2_hf_state(source))
    ids = ids_on_card(4, 64)
    if not torch.equal(generate(gpt2, source, cfg, ids, 16), generate(gpt2, target, cfg, ids, 16)):
        raise AssertionError("hf_loaders gpt2: the loaded model's greedy tokens differ from the source's")
    del source, target

    cfg = dict(QWEN3_5_08B_CONFIG)
    source = build_model(cfg)
    attention = {path.split("/att/")[0] for path in interop.flatten_params(source.text) if "/att/wqg/" in path}

    def skip(path, rule):  # an attention layer's names are self_attn's, a GDN layer's linear_attn's
        layer = path.split("/att/")[0]
        return ("linear_attn" in rule[0] and layer in attention) or ("self_attn" in rule[0] and layer not in attention)

    state = {**hf_state_dict(source.text, interop.qwen3_5_text_rules(), skip=skip),
             **hf_state_dict(source.vision, interop.qwen3_5_vision_rules())}
    target = other_seed(qwen3_5, cfg)
    out["qwen3_5_vlm"] = hf_load("hf_loaders qwen3_5",
                                 lambda m, s, log: interop.load_hf_qwen3_5_vlm(m, cfg, s, log=log), source, target,
                                 state)
    out["qwen3_5_vlm"]["hf_names_sample"] = sorted(state)[:3]
    inputs = make_inputs(cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    for got, want in zip(run_main_path(target, cfg, *inputs, 8), run_main_path(source, cfg, *inputs, 8)):
        if not torch.equal(got, want):
            raise AssertionError("hf_loaders qwen3_5: the loaded model's greedy tokens differ from the source's")
    del source, target, state
    torch.cuda.empty_cache()
    emit({"phase": "hf_loaders", "card": card, "dtype": "bfloat16", **out})


class DigitTokenizer:
    """GPT-2's single-digit tokens ("0".."9" are ids 15..24) and nothing else."""

    def get_vocab(self):
        return {str(d): i for d, i in enumerate(DIGIT_IDS)}


def qk_clip_llama(out):
    """``training_ops``' QK-Clip reading on Llama-3.2-1B (16 layers, fp32, b
    2, s 512: in bf16 the maxima and the rescaled weights round by up to
    2⁻⁹ each, which the 1 % margin does not hold), the workflow of JAX's
    end-to-end test (``tests/test_common_techniques.py``): a forward with
    ``collect_max_logits``, then ``apply_qk_clip`` at τ = half the largest
    collected logit. The clip rescales each layer's q/k by the maxima of the
    inputs that forward fed it, so its cap holds on those: every layer's
    per-head maxima recomputed with the clipped weights on those inputs
    (hooked) must be ≤ τ·1.01, and so must the next forward's in layer 0,
    whose input the clip leaves as it was. The next forward's later layers
    see inputs the clipped layers before them changed: their maxima are
    read (``max_after``), not held to the cap."""
    import torch

    from llm_quest_tpu_torch.models import llama3
    from llm_quest_tpu_torch.ops import qk_clip, rope
    from llm_quest_tpu_torch.ops.attention import split_heads

    cfg = llama_cfg(16, torch.float32)
    model = init_model(llama3, cfg)
    batch = train_batch(2, 512)
    inputs = []
    hooks = [block.att.wq.register_forward_hook(lambda m, args, _: inputs.append(args[0]))
             for block in model.blocks]
    with torch.inference_mode():
        aux = llama3.apply(model, cfg, batch["input_ids"], collect_max_logits=True)[2]
    for hook in hooks:
        hook.remove()
    before = torch.stack(aux["max_attn_logits"]).float()
    tau = float(before.max()) / 2
    qk_clip.apply_qk_clip(model, list(before), tau, num_heads=cfg["n_heads"], num_kv_heads=cfg["num_kv_groups"])
    with torch.inference_mode():
        same_inputs = torch.stack([
            llama3._max_logits(rope.apply(split_heads(block.att.wq(x), cfg["n_heads"]), model.rope_cos, model.rope_sin),
                               rope.apply(split_heads(block.att.wk(x), cfg["num_kv_groups"]), model.rope_cos,
                                          model.rope_sin), cfg)
            for block, x in zip(model.blocks, inputs)]).float()
        after = torch.stack(llama3.apply(model, cfg, batch["input_ids"], collect_max_logits=True)[2][
            "max_attn_logits"]).float()
    if not (float(same_inputs.max()) <= tau * 1.01 and float(after[0].max()) <= tau * 1.01):
        raise AssertionError(f"training_ops qk_clip: maxima after the clip {float(same_inputs.max())} on the "
                             f"collecting forward's inputs, {float(after[0].max())} in layer 0's next forward, "
                             f"> {tau} · 1.01")
    out["qk_clip"] = {"layers": 16, "b": 2, "s": 512, "tau": tau, "max_before": float(before.max()),
                      "max_same_inputs": float(same_inputs.max()), "max_after_layer0": float(after[0].max()),
                      "max_after": float(after.max()), "max_after_by_layer": after.amax(1).tolist(),
                      "heads_clipped": int((before > tau).sum()), "heads": before.numel()}


def ntl_ral_gpt2(out):
    """``training_ops``' Number-Token Loss and RAL readings on GPT-2 124M (bf16, b 8, s 1024)."""
    import torch

    from llm_quest_tpu_torch.config import GPT_CONFIG_124M
    from llm_quest_tpu_torch.models import gpt2
    from llm_quest_tpu_torch.ops import num_token_loss, reinforced_attention
    from llm_quest_tpu_torch.ops.attention import split_heads
    from llm_quest_tpu_torch.ops.losses import cross_entropy
    from llm_quest_tpu_torch.ops.masks import causal_mask
    from llm_quest_tpu_torch.ops.norms import layer_norm

    cfg = gpt2_cfg(GPT_CONFIG_124M, 12, torch.bfloat16)
    model = init_model(gpt2, cfg)
    batch = train_batch(8, 1024)
    targets = batch["targets"].clone()
    pick = torch.arange(targets.numel(), device=DEVICE).reshape(targets.shape) % 10 == 0
    targets[pick] = torch.tensor(list(DIGIT_IDS), device=DEVICE)[torch.arange(int(pick.sum()), device=DEVICE) % 10]
    vocab = num_token_loss.build_num_vocab(DigitTokenizer(), cfg["vocab_size"], device=DEVICE)
    logits, _, _ = gpt2.apply(model, cfg, batch["input_ids"])
    total = (cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
             + num_token_loss.num_token_loss(logits, targets, vocab))
    grads = torch.autograd.grad(total, list(model.parameters()), allow_unused=True, materialize_grads=True)
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("training_ops ntl: a gradient of CE + NTL is not finite")
    del grads
    leaf = logits.detach().requires_grad_()
    del logits
    got = num_token_loss.num_token_loss(leaf, targets, vocab)
    (g_got,) = torch.autograd.grad(got, leaf)
    is_num = ~torch.isnan(vocab)
    label = vocab[targets]
    valid = ~torch.isnan(label)
    # JAX's form: the whole row softmaxed with the non-number columns at -inf
    probs = torch.softmax(torch.where(is_num, leaf.float(), float("-inf")), dim=-1)
    dist = (torch.where(valid, label, 0.0)[..., None] - torch.where(is_num, vocab, 0.0)).abs()
    ref = torch.where(valid, torch.where(is_num, dist * probs, 0.0).sum(-1), 0.0).sum() / valid.sum()
    (g_ref,) = torch.autograd.grad(ref, leaf)
    del probs, dist, leaf
    got, ref = float(got.detach()), float(ref.detach())
    value_err = abs(got - ref)
    grad_err, grad_scale = max_err(g_got, g_ref)
    if not (value_err <= NEW_TOL * max(1.0, abs(ref)) and grad_err <= NEW_TOL * max(1.0, grad_scale)):
        raise AssertionError(f"training_ops ntl: {got} against JAX's form {ref}, gradient {grad_err}")
    out["ntl"] = {"b": 8, "s": 1024, "number_labels": int(pick.sum()), "loss": got, "jax_form": ref,
                  "value_err": value_err, "grad_max_abs_err": grad_err}
    del g_got, g_ref

    att, ln = model.blocks[0].att, model.blocks[0].ln_1
    ids = batch["input_ids"]
    s = ids.shape[1]
    hn = layer_norm(model.tok_emb["w"][ids] + model.pos_emb["w"][:s], ln["scale"], ln["shift"])
    mask = causal_mask(s, s, device=DEVICE)

    def maps(q_scale=1.0):
        q = split_heads(att.wq(hn), cfg["n_heads"]).float() * q_scale
        k = split_heads(att.wk(hn), cfg["n_heads"]).float()
        return torch.softmax((q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5).masked_fill(mask, float("-inf")), -1)

    policy = maps()
    with torch.no_grad():
        old = maps(0.9)
    adv = torch.linspace(0.5, 1.5, ids.shape[0], device=DEVICE)  # one sign: no cancellation in the mean
    loss_mask = (torch.arange(s, device=DEVICE) % 7 != 0)[None].expand(ids.shape[0], -1)
    ral = reinforced_attention.attention_divergence_loss(policy, old, adv, loss_mask)
    gq, gk = torch.autograd.grad(ral, [att.wq.w, att.wk.w])
    ral = ral.detach()
    policy = policy.detach()
    ral64 = reinforced_attention.attention_divergence_loss(policy.double(), old.double(), adv.double(), loss_mask)
    same = reinforced_attention.attention_divergence_loss(old, old, adv, loss_mask)
    ral_err = abs(float(ral) - float(ral64))
    if not (ral_err <= NEW_TOL * abs(float(ral64)) and abs(float(same)) < 1e-6
            and all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0 for g in (gq, gk))):
        raise AssertionError(f"training_ops ral: {float(ral)} against fp64 {float(ral64)}, equal maps {float(same)}")
    out["ral"] = {"b": 8, "heads": cfg["n_heads"], "s": s, "loss": float(ral), "fp64": float(ral64),
                  "rel_err": ral_err / abs(float(ral64)), "equal_maps": float(same)}


def training_ops(records, card):
    """The model-agnostic training ops on the card, at full width.
    QK-Clip on Llama-3.2-1B (16 layers, fp32, b 2, s 512): a forward with
    ``collect_max_logits``, then ``apply_qk_clip`` (per head, the min over
    each kv group) at τ = half the largest collected logit; every layer's
    maxima on that forward's inputs, and layer 0's in the next forward, ≤
    τ·1.01 (``qk_clip_llama``). The Number-Token Loss and RAL on GPT-2 124M
    (bf16, b 8, s 1024): NTL over GPT-2's digit tokens (every tenth label a digit), its
    value and logits gradient against JAX's form (the softmax over all
    columns, the others at −inf) within NEW_TOL of max(1, |ref|), and the
    gradients of CE + NTL finite; RAL between block 0's attention maps (12
    heads, fp32) and those with its q scaled by 0.9, the value within
    NEW_TOL of fp64's, 0 for equal maps, the gradients of wq and wk finite
    and nonzero. ``l2_norm`` in bf16 on an (8, 1024, 768) card tensor
    within 2⁻⁸ of fp64, DyT's gradients in fp32 within NEW_TOL of fp64's."""
    import torch

    from llm_quest_tpu_torch.ops import norms

    out = {}
    qk_clip_llama(out)
    torch.cuda.empty_cache()
    ntl_ral_gpt2(out)
    torch.cuda.empty_cache()
    x = randn(torch.Generator(device=DEVICE).manual_seed(SEED + 6), 8, 1024, 768)
    w = randn(torch.Generator(device=DEVICE).manual_seed(SEED + 7), 8, 1024, 768)
    l2_err = float((norms.l2_norm(x.to(torch.bfloat16)).double() - norms.l2_norm(x.double())).abs().max())
    dyt = norms.init_dynamic_tanh(768, alpha0=0.7, device=DEVICE)
    xg = x.clone().requires_grad_()
    grads = torch.autograd.grad((dyt(xg) * w).sum(), [xg, dyt.alpha, dyt.gamma, dyt.beta])
    dyt64 = {k: p.detach().double().requires_grad_() for k, p in dyt.named_parameters()}
    x64 = x.double().requires_grad_()
    grads64 = torch.autograd.grad((norms.dynamic_tanh(dyt64, x64) * w.double()).sum(),
                                  [x64, dyt64["alpha"], dyt64["gamma"], dyt64["beta"]])
    dyt_err = max(float((a.double() - r).abs().max()) / max(1.0, float(r.abs().max())) for a, r in zip(grads, grads64))
    if not (l2_err <= 2**-8 and dyt_err <= NEW_TOL):
        raise AssertionError(f"training_ops norms: l2_norm bf16 err {l2_err}, DyT gradient rel err {dyt_err}")
    out["norms"] = {"l2_norm_bf16_max_abs_err": l2_err, "dyt_grad_rel_err": dyt_err}
    torch.cuda.empty_cache()
    emit({"phase": "training_ops", "card": card, **out})


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
    from llm_quest_tpu_torch.models import deepseek_v3, gemma3, gpt2, llama3, mimo_v2_flash, qwen3, qwen3_next

    for mod, cls in ((qwen3, qwen3.Qwen3), (qwen3_next, qwen3_next.Qwen3Next), (gemma3, gemma3.Gemma3),
                     (deepseek_v3, deepseek_v3.DeepSeekV3), (mimo_v2_flash, mimo_v2_flash.MiMoV2Flash),
                     (gpt2, gpt2.GPT2), (llama3, llama3.Llama3)):
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
    select_rows(model, [knobs for _, _, knobs in wave])
    with torch.inference_mode():
        cache = entry.init_cache(cfg, len(wave), engine.max_len, device=DEVICE)
        logits, _, _ = entry.apply(model, cfg, prompt, attn_mask=mask, cache=cache)
    return logits[torch.arange(len(wave), device=DEVICE), torch.tensor(last, device=DEVICE)].float()


def select_rows(model, knobs):
    """With stacked adapters in ``model``, select the adapter each row's
    request names (``knobs["adapter"]``; none: the null adapter) for the
    next direct calls of the model."""
    import torch

    from llm_quest_tpu_torch.ops.lora import num_adapters, select_adapter

    n = num_adapters(model)
    if n:
        select_adapter(model, torch.tensor([n - 1 if k.get("adapter") is None else k["adapter"] for k in knobs],
                                           device=DEVICE))


def b1_logits(model, cfg, traffic):
    """Last-token logits of a b = 1 prefill of each of the first
    ENGINE_CHECK_ROWS prompts, alone and unpadded."""
    import torch

    rows = []
    for ids, _, knobs in traffic[:ENGINE_CHECK_ROWS]:
        select_rows(model, [knobs])
        rows.append(last_prefill_logits(entry_of(model), model, cfg, torch.tensor([ids], device=DEVICE))[0])
    return torch.stack(rows)


def held_to_bar(name, got, ref, control, rel_bar=ENGINE_PLAIN_BAR):
    """``got`` within ``rel_bar`` (default ENGINE_PLAIN_BAR) × max |ref| of the
    plain ``ref``, and the ``control`` beyond it (else the bar could not see
    a fault of its size): the readings."""
    import torch

    err, scale = max_err(got, ref)
    bar = rel_bar * scale
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


def engine_vs_plain(model, cfg, kind, traffic, rows, step_control="mask", rel_bar=ENGINE_PLAIN_BAR, **engine_kw):
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
                                    wave_logits(engine, model, plain_cfg, wave, drop=True), rel_bar)
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
    step = held_to_bar(f"{kind} decode step", *(logits[run][:rows] for run in ("kernels", "plain", "control")),
                       rel_bar)
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
    state: device ms a step (all the card's work), kernels a step, the
    card's busy share of the chunk's wall, and K11's device ms a step and
    share of the device time. Nones where the profiler gives no trace of the
    card."""
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
            return {"device_ms_per_step": None, "kernels_per_step": None, "busy_share": None, "chunk_wall_ms": None,
                    "k11_ms_per_step": None, "k11_share": None}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:  # union of the device intervals
        if a > hi:
            busy_us, lo = busy_us + hi - lo, a
        hi = max(hi, b)
    busy_us += hi - lo
    kernels = sum(not e.name.startswith(("Memcpy", "Memset")) for e in events)
    device = sum(e.time_range.elapsed_us() for e in events) / 1e3 / steps
    k11 = sum(e.time_range.elapsed_us() for e in events if QGMM_KEY in e.name) / 1e3 / steps
    return {"device_ms_per_step": device, "kernels_per_step": kernels / steps, "busy_share": busy_us / 1e3 / wall_ms,
            "chunk_wall_ms": wall_ms, "steps": steps, "k11_ms_per_step": k11, "k11_share": k11 / device}


def engine_record(path, model, cfg, kind, records, card, check_rows, depths=(), *, requests=ENGINE_REQUESTS,
                  serves=3, layer_calls=None, sync_check=False, step_control="mask", warm=True, agree=True,
                  profile_steps=ENGINE_PROFILE_STEPS, traffic=None, vs_plain=True, plain_bar=ENGINE_PLAIN_BAR,
                  **engine_kw):
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
    ``engine_vs_plain``'s; ``traffic``: the requests in place of
    ``engine_traffic(kind)``'s (their knobs go to ``submit``); without
    ``vs_plain`` no plain check; ``plain_bar``: the plain check's relative
    bar (``held_to_bar``); ``engine_kw``: the engine's shape over
    ``engine_for``'s. Returns the emitted record and the first serve's
    tokens."""
    import torch

    from llm_quest_tpu_torch.ops.int4 import is_int4

    t_start = time.perf_counter()
    traffic = (engine_traffic(kind) if traffic is None else traffic)[:requests]
    plain = (engine_vs_plain(model, cfg, kind, traffic, check_rows, step_control, plain_bar, **engine_kw)
             if vs_plain else None)
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
    rec = {"phase": path, "card": card, "dtype": "bfloat16", "model": mod.__name__.rsplit(".", 1)[-1],
          "layers": cfg["n_layers"], "kv_quant": cfg.get("kv_quant"),
          "int8_weights": any(t.dtype == torch.int8 for t in model.state_dict().values()),
          "int4_weights": any(is_int4(t) for t in model.state_dict().values()),
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
          "decode_step_host_syncs": syncs, "peak_memory_gb": peak_gb, "weight_gb": weight_gb(model),
          "seconds": time.perf_counter() - t_start}
    emit(rec)
    SERVED[path] = rec
    return rec, toks


SERVED = {}  # each serving record emitted, by path (the int4 records stand beside the int8 ones)


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


def engine_check_fp32(bits=None):
    """engine_serve_fp32: Qwen3.5-0.8B text cut to 4 layers, fp32, 4 slots,
    buckets (32, 64), chunk 8: eight requests (three submitted after the
    first scheduler step), an EOS taken from request 0's free run; every
    request's greedy tokens equal ``generate_kv_cache``'s for its prompt
    alone (EOS included, what follows it trimmed), through the kernels and
    through the plain versions (``use_kernels`` False; run outside
    ``phase``), and no tensor-core launch. With ``bits`` 4
    (engine_serve_int4_fp32) its linears are quantized to int4 first, with
    block scales of INT4_BLOCK (the table stays fp32: a quantized table
    gathers bf16 rows), and the reference is ``generate_kv_cache`` of the
    same int4 model."""
    import numpy as np
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.inference import generate as gen_module
    from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine
    from llm_quest_tpu_torch.models import qwen3_5
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    t0 = time.perf_counter()
    name = "engine_serve_fp32" if bits is None else f"engine_serve_int{bits}_fp32"
    cfg = dict(QWEN3_5_08B_CONFIG, n_layers=4, dtype=torch.float32)
    model = text_model(cfg)
    if bits is not None:
        quantize_params_int8(model, bits=bits, block_size=INT4_BLOCK)
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
            raise AssertionError(f"{name} (use_kernels {run_cfg.get('use_kernels', True)}): engine tokens "
                                 f"differ from generate_kv_cache's:\n{got}\n{refs}")
    check_routes(name, bf16=False)
    emit({"phase": name, "int4_weights": bits == 4, "layers": cfg["n_layers"], "requests": len(traffic), "eos": eos,
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


MOE_LAYERS = 12  # of Qwen3-30B-A3B's 48, for the script's time (every layer is alike)
MOE_BF16_SLOTS = 16  # the bf16 30B serve: 16 slots and 16 requests (its per-expert loop is the host's)
# its decode chunk: a step takes ~0.77 s of host wall (~28,700 kernels; H100 80GB HBM3, 700 W), so the
# warm-up's chunk and the chunks of the serve are 16 steps, not 64
MOE_BF16_CHUNK = 16
FAMILY_SLOTS, FAMILY_REQUESTS = 8, 16


def moe_cfg():
    """Qwen3-30B-A3B as the repo's config gives it (``qwen3_config_creator``;
    Qwen/Qwen3-30B-A3B's ``config.json``: 48 layers, d 2048, 32/4 heads of
    128, 128 experts top-8 of hidden 768, untied head, bf16), cut to
    MOE_LAYERS layers."""
    from llm_quest_tpu_torch.config import qwen3_config_creator

    return dict(qwen3_config_creator("30B-A3B"), n_layers=MOE_LAYERS)


def weight_gb(model):
    return sum(t.numel() * t.element_size() for t in model.state_dict().values()) / 1e9


def engine_moe_paths(records, card):
    """Qwen3-30B-A3B at full width, MOE_LAYERS of its 48 layers, through the
    engine (the hetero traffic): bf16 (``engine_serve_moe_bf16``: 16 slots, 16 requests, one
    serve; K4), then the same weights quantized in place, linears and expert
    stacks, with the int8 KV cache (``engine_serve_moe_int8``: 32 slots, 48
    requests, one serve (the script's time), one decode step under the sync
    check; K4,
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
                  MOE_SLOTS - ENGINE_EMPTY_SLOTS, serves=1, sync_check=True, warm=False, profile_steps=2,
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


# ------------------------------------------------- int4 serving and the classic and latent MoE


INT4_BLOCK = 128  # the int4 linears' block scales (JAX pairs int4 with block_size <= 128)
INT4_BESIDE = ("useful_tok_s", "ttft_p50_ms", "device_ms_per_step", "kernels_per_step", "busy_share", "weight_gb",
               "k11_ms_per_step", "k11_share", "peak_memory_gb")


def int4_beside_int8(path, int8_path):
    """The int4 serving record's readings beside the int8 record's of the
    same model and traffic, and their ratios; raises where the two served
    different traffic."""
    a, b = SERVED[path], SERVED.get(int8_path, {})  # the int8 record where the run made one
    if b and (a["buckets"], a["requests"], a["max_len"]) != (b["buckets"], b["requests"], b["max_len"]):
        raise AssertionError(f"{path} and {int8_path} served different traffic")
    ratio = {k: a[k] / b[k] for k in INT4_BESIDE if a.get(k) is not None and b.get(k)}
    emit({"phase": f"{path}_beside_int8", "int8_path": int8_path, **{k: [a.get(k), b.get(k)] for k in INT4_BESIDE},
          "int4_over_int8": ratio, "buckets": [a["buckets"], b.get("buckets")]})


def engine_int4_paths(records, card):
    """int4 serving with the int8 KV cache, each record beside an int8 one
    of the same model and traffic: Qwen3.5-0.8B text at ENGINE_LAYERS
    layers, bf16, a copy quantized as ``engine_serve_int8``
    (``engine_serve_int8_hetero``) and the model in place with ``bits=4``,
    block scales of INT4_BLOCK and the int4 table (``engine_serve_int4``),
    both on bench_serving_hetero's traffic (K1, K2, K4, K10; their plain
    checks leave ENGINE_EMPTY_SLOTS slots empty), then
    Qwen3-30B-A3B at MOE_LAYERS, bf16 quantized in place, linears at 4 bits
    with block scales of INT4_BLOCK and the expert stacks at 4 bits
    (``engine_serve_moe_int4``: 32 slots, one serve and one decode step
    under the sync check, as ``engine_serve_moe_int8``; K4, K10 and K11 over
    the packed stacks, every K11 launch an int4 one on the tensor cores),
    with K11's device ms a step and share."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.models import qwen3
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    t0 = time.perf_counter()
    cfg = dict(QWEN3_5_08B_CONFIG, n_layers=ENGINE_LAYERS, dtype=torch.bfloat16)
    model = text_model(cfg)
    int8_model = quantize_params_int8(copy.deepcopy(model), quantize_embeddings=True)
    engine_record(ENGINE_INT8_HETERO, int8_model, dict(cfg, kv_quant="int8"), "hetero", records, card,
                  32 - ENGINE_EMPTY_SLOTS)
    del int8_model
    quantize_params_int8(model, bits=4, block_size=INT4_BLOCK, quantize_embeddings=True)
    torch.cuda.empty_cache()
    engine_record(ENGINE_INT4, model, dict(cfg, kv_quant="int8"), "hetero", records, card, 32 - ENGINE_EMPTY_SLOTS)
    int4_beside_int8(ENGINE_INT4, ENGINE_INT8_HETERO)
    del model
    torch.cuda.empty_cache()
    cfg = moe_cfg()
    model = init_model(qwen3, cfg)
    t1 = time.perf_counter()
    quantize_params_int8(model, bits=4, block_size=INT4_BLOCK)
    torch.cuda.synchronize()
    emit({"phase": "engine_moe_int4_weights", "card": card, "quantize_s": time.perf_counter() - t1,
          "int4_gb": weight_gb(model)})
    torch.cuda.empty_cache()
    n = cfg["n_layers"]
    engine_record(ENGINE_MOE_INT4, model, dict(cfg, kv_quant="int8"), "hetero", records, card,
                  MOE_SLOTS - ENGINE_EMPTY_SLOTS, serves=1, sync_check=True, warm=False, profile_steps=2,
                  layer_calls={"flash_attention_fwd_gqa8": n, "flash_decode_gqa8": n, "k11_int4": 3 * n})
    int4_beside_int8(ENGINE_MOE_INT4, ENGINE_MOE_INT8)
    del model
    torch.cuda.empty_cache()
    emit({"phase": "engine_int4_paths", "seconds": time.perf_counter() - t0})


# the classic MoE at GPT-2 124M's widths (8 experts top-2 of int(4 · 1/2 · 768) = 1,536) and the latent MoE at
# Qwen3-30B-A3B's (d 2048, 128 experts top-8 of 768 in the latent width 512); x (b, s, d) each
CLASSIC_MOE, CLASSIC_E, CLASSIC_K, CLASSIC_X = {"emb_dim": 768}, 8, 2, (8, 1024, 768)
LATENT_MOE, LATENT_X = {"emb_dim": 2048, "moe_hidden_dim": 768, "num_experts": 128, "top_k": 8}, (4, 2048, 2048)
MOE_VARIANT_BAR = 5e-2  # bf16 against fp32: ||bf16 - fp32|| / ||fp32||, output and each gradient
MOE_ROUTE_AGREE = 0.9  # the share of tokens whose expert set bf16 and fp32 routing agree on, at least
REPLAY_CONTROL = 1e-2  # another batch's probabilities move the replayed logits by more than this (max abs)


def variant_routes(name, layer, x2d):
    """The (T, k) expert ids a layer picks for rows ``x2d``, sorted (sets compare)."""
    import torch

    from llm_quest_tpu_torch.ops.moe import latent_top_k

    if name == "classic":
        probas = torch.softmax((x2d @ layer.gate_w + layer.gate_b).float(), -1)
        return torch.topk(probas, CLASSIC_K).indices.sort(-1)[0]
    scores = torch.sigmoid((x2d @ layer.gate_w).float()) + layer.biases
    return torch.topk(scores, latent_top_k(LATENT_MOE), -1).indices.sort(-1)[0]


def rel_err(got, ref):
    return float((got.float() - ref.float()).norm() / ref.float().norm())


def variant_bf16_vs_fp32(name, fn, layer32, x32, cot):
    """The layer forward and backward in bf16 against fp32 on the same
    inputs, the loss taken over the tokens both precisions route alike (a
    near-tie routes otherwise in bf16): the output on those tokens and every
    gradient within MOE_VARIANT_BAR, beside a control (the fp32 output of
    another input) that must read above it."""
    import copy

    import torch

    layer16 = copy.deepcopy(layer32)
    for p in layer16.parameters():  # the parameters in bf16; a latent layer's biases stay an fp32 buffer
        p.data = p.data.to(torch.bfloat16)
    x16 = x32.to(torch.bfloat16)
    d = x32.shape[-1]
    with torch.no_grad():
        agree = (variant_routes(name, layer32, x32.reshape(-1, d)) ==
                 variant_routes(name, layer16, x16.reshape(-1, d))).all(-1).reshape(x32.shape[:-1])
    share = float(agree.float().mean())
    if share < MOE_ROUTE_AGREE:
        raise AssertionError(f"moe_variants {name}: bf16 and fp32 routing agree on {share} of the tokens")
    outs, grads = {}, {}
    for key, layer, x in (("fp32", layer32, x32), ("bf16", layer16, x16)):
        layer.zero_grad(set_to_none=True)
        out, aux = fn(layer, x)
        loss = (out.float() * cot)[agree].sum() + aux.get("moe_loss", 0.0)
        loss.backward()
        outs[key] = out.detach()[agree]
        grads[key] = {n: p.grad.float() for n, p in layer.named_parameters()}
    readings = {"out": rel_err(outs["bf16"], outs["fp32"]),
                **{f"grad_{n}": rel_err(grads["bf16"][n], g) for n, g in grads["fp32"].items()}}
    worst = max(readings, key=readings.get)
    if not readings[worst] <= MOE_VARIANT_BAR:  # also catches NaN
        raise AssertionError(f"moe_variants {name}: bf16 {worst} reads {readings[worst]} of fp32, > {MOE_VARIANT_BAR}")
    with torch.no_grad():
        control = rel_err(fn(layer32, torch.roll(x32, 1, dims=0))[0][agree], outs["fp32"])
    if not control > MOE_VARIANT_BAR:
        raise AssertionError(f"moe_variants {name}: the control reads {control}, within {MOE_VARIANT_BAR}")
    del layer16
    return {"routes_agree": share, "bf16_vs_fp32": readings, "control": control}


def replay_30b():
    """Qwen3-30B-A3B at MOE_LAYERS, bf16, b 2, s 64: a forward fed its own
    ``aux["gate_probas"]`` (the RL routing replay) gives the same logits bit
    for bit; fed another batch's probabilities (the control), logits that
    move by more than REPLAY_CONTROL."""
    import torch

    from llm_quest_tpu_torch.models import qwen3

    cfg = moe_cfg()
    model = init_model(qwen3, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 27)
    ids = torch.randint(1, 32_000, (2, 64), generator=gen, device=DEVICE)
    other = torch.randint(1, 32_000, (2, 64), generator=gen, device=DEVICE)
    with torch.inference_mode():
        logits, _, aux = qwen3.apply(model, cfg, ids)
        replayed, _, _ = qwen3.apply(model, cfg, ids, gate_probas=aux["gate_probas"])
        _, _, aux_other = qwen3.apply(model, cfg, other)
        control, _, _ = qwen3.apply(model, cfg, ids, gate_probas=aux_other["gate_probas"])
        broadcast, _, _ = qwen3.apply(model, cfg, ids, gate_probas=aux["gate_probas"][0])
    moved = float((control.float() - logits.float()).abs().max())
    if not (torch.isfinite(logits).all() and torch.equal(replayed, logits)):
        raise AssertionError("moe_variants: the 30B forward fed its own gate_probas gives other logits")
    if not moved > REPLAY_CONTROL:
        raise AssertionError(f"moe_variants: another batch's gate_probas move the logits by {moved} only")
    del model
    torch.cuda.empty_cache()
    return {"layers": cfg["n_layers"], "tokens": ids.numel(), "replay_equal": True, "control_max_abs": moved,
            "broadcast_layer0_max_abs": float((broadcast.float() - logits.float()).abs().max())}


def moe_variants(records, card):
    """The classic MoE at GPT-2 124M's widths (x (8, 1024, 768)) and the
    latent MoE at Qwen3-30B-A3B's (x (4, 2048, 2048)), random weights from
    the seed: bf16 forward + backward against fp32 (``variant_bf16_vs_fp32``);
    then each quantized in place from its bf16 copy, int8 and int4, its
    forward through K11 against the same forward through K11's plain
    version (run uncounted) within the bf16 tolerance, the int4 forwards with
    the counts reset first (every K11 launch an int4 one on the tensor
    cores); then the 30B routing replay (``replay_30b``)."""
    import copy
    from functools import partial as bind

    import torch

    from llm_quest_tpu_torch.ops import moe
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    layers = {
        "classic": (moe.init_classic_moe(CLASSIC_MOE, num_experts=CLASSIC_E, top_k=CLASSIC_K, generator=gen,
                                         device=DEVICE), bind(moe.classic_moe, top_k=CLASSIC_K), CLASSIC_X),
        "latent": (moe.init_latent_moe(LATENT_MOE, generator=gen, device=DEVICE),
                   bind(moe.latent_moe, top_k=moe.latent_top_k(LATENT_MOE)), LATENT_X),
    }
    rec = {"phase": MOE_VARIANTS, "card": card}
    inputs = {}
    for name, (layer, fn, shape) in layers.items():
        x, cot = randn(gen, *shape), randn(gen, *shape)
        inputs[name] = x.to(torch.bfloat16)
        rec[name] = {"x": list(shape), **variant_bf16_vs_fp32(name, fn, layer, x, cot)}
        torch.cuda.empty_cache()
    quantized = {}
    for bits in (8, 4):
        if bits == 4:
            reset_launches()
        for name, (layer, fn, _) in layers.items():
            q = copy.deepcopy(layer)
            for p in q.parameters():
                p.data = p.data.to(torch.bfloat16)
            quantize_params_int8(q, bits=bits)
            with torch.no_grad():
                out = fn(q, inputs[name])[0]
            quantized[name, bits] = (q, out)
        if bits == 4:
            rec["launches"] = read_launches(MOE_VARIANTS, records)
    for (name, bits), (q, out) in quantized.items():
        with torch.no_grad(), unwatched():
            ref = layers[name][1](q, inputs[name], plain=True)[0]
        rec[name][f"int{bits}_vs_plain_max_abs_err"] = check(f"moe_variants {name} int{bits}", out, ref,
                                                             torch.bfloat16)
    del quantized
    torch.cuda.empty_cache()
    rec["replay"] = replay_30b()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)


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
    """GPT-2 124M (12 layers), Gemma-3 at Gemma-3-270M's widths (18 layers),
    DeepSeek-V3 small and MiMo-V2-Flash small (12 layers each), bf16, through
    the engine: 8 slots, the hetero traffic's first 16 prompts, greedy,
    buckets 32/64/256. No kernel launches (``sdpa`` on the cache, as in
    JAX). Per model: useful tok/s of one serve after ``warmup``, every
    request its budget long in vocabulary ids, the first wave's admission
    logits finite, and the greedy tokens of ENGINE_AGREE_ROWS requests
    (ENGINE_AGREE_TOKENS each) against ``generate_kv_cache``'s, gated: a
    request's tokens may leave the reference's only at a bf16 near-tie
    (``near_tie`` without ``top2``: at the first token that differs, both
    tokens' logits in the model's uncached forward lie within
    BF16_LOGIT_BAR × max |logits| of the largest; the tokens after it follow
    other prefixes); MiMo's last prefill logits through its cache beside its
    uncached forward (within ENGINE_PLAIN_BAR × max |uncached|), and
    ``mimo_cached_check``."""
    import torch

    from llm_quest_tpu_torch.config import GPT_CONFIG_124M
    from llm_quest_tpu_torch.models import deepseek_v3, gemma3, gpt2, mimo_v2_flash

    t0 = time.perf_counter()
    traffic = [(ids, gen, {}) for ids, gen, _ in engine_traffic("hetero")[:FAMILY_REQUESTS]]
    out = {}
    for name, mod, cfg in (("gpt2", gpt2, gpt2_cfg(GPT_CONFIG_124M, 12, torch.bfloat16)),
                           ("gemma3", gemma3, gemma_cfg(18, torch.bfloat16)),
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
        ties = []
        for (ids, gen, _), got in zip(traffic[:ENGINE_AGREE_ROWS], toks):
            n = min(gen, ENGINE_AGREE_TOKENS)
            ref = generate(mod, model, cfg, torch.tensor([ids], device=DEVICE), n)[0, len(ids):].tolist()
            equal += sum(a == b for a, b in zip(got[:n], ref))
            total += n
            tie = near_tie(model, cfg, ids, got[:n], ref, f"{ENGINE_FAMILIES} {name}", mod=mod, bar=BF16_LOGIT_BAR,
                           top2=False, phase_name="engine_families_near_tie")
            if tie is not None:
                ties.append(tie)
        rec = {"layers": cfg["n_layers"], "useful_tok_s": sum(map(len, toks)) / seconds, "serve_s": seconds,
               "stats": engine.stats(), "greedy_agreement": equal / total, "greedy_compared": total,
               "requests_equal": ENGINE_AGREE_ROWS - len(ties), "near_ties": ties}
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

def engine_llama(records, card):
    """Llama-3.2-1B at full width and depth (``LLAMA32_SMALL_CONFIG_1B``, 16
    layers), seeded random weights, through the engine on
    ``bench_serving_hetero``'s traffic (48 requests, prompts U[8, 200], the
    four samplers, 32 slots, chunk 64, buckets 32/64/256): bf16
    (``engine_serve_llama``), then quantized in place, linears and tied
    table, with the int8 KV cache (``engine_serve_llama_int8``; its plain
    check leaves ENGINE_EMPTY_SLOTS slots empty), one serve each (the
    script's time). Each is
    ``engine_record``: first held to the plain versions (``engine_vs_plain``
    at BF16_LOGIT_BAR: no kernel runs on this path, as in JAX: the cached
    calls take ``sdpa``, and K10 takes head dims that are multiples of 128,
    not Llama's 64), then
    useful tok/s, TTFT p50, device ms, kernels, busy share and wall a
    decode step (a profiled chunk), peak memory and the greedy agreement
    with ``generate_kv_cache``."""
    import torch

    from llm_quest_tpu_torch.models import llama3
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    t0 = time.perf_counter()
    cfg = llama_cfg(16, torch.bfloat16)
    model = init_model(llama3, cfg)
    # no kernel runs here, so the engine and the plain calls compute the same: the plain check's bar is the
    # tests' bf16 bar, not ENGINE_PLAIN_BAR (set for kernel rounding through 24 layers). The N(0, 1) tied
    # table makes each row's largest logit its own token's (~|e|² ≈ 2048): 16 dropped tokens move the
    # logits by ~20 % of that (H100 80GB HBM3, 700 W), which ENGINE_PLAIN_BAR could not see
    engine_record(ENGINE_LLAMA, model, cfg, "hetero", records, card, 32, serves=1, plain_bar=BF16_LOGIT_BAR)
    quantize_params_int8(model, quantize_embeddings=True)
    torch.cuda.empty_cache()
    engine_record(ENGINE_LLAMA_INT8, model, dict(cfg, kv_quant="int8"), "hetero", records, card,
                  32 - ENGINE_EMPTY_SLOTS, serves=1, plain_bar=BF16_LOGIT_BAR)
    emit({"phase": "engine_llama", "seconds": time.perf_counter() - t0})
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ multi-LoRA serving


LORA_ADAPTERS, LORA_RANK, LORA_ALPHA, LORA_B_STD = 8, 16, 32, 0.02
# Each first-wave row's admission logits, and its first decode step's, held to a prefill of the same
# prompt (and the engine's first token) through ``merge_adapter`` of the row's adapter: dense over the
# dequantized base, fp32 (JAX's oracle, tests/test_serving.py:1214), within LORA_BAR × max |oracle row|
# of every row; the control holds every row to the NEXT adapter's merge and must read beyond the bar on
# every row. Set from readings on an H100: the bf16 engine (int8 weights and KV, 24 random layers) sat
# 25.1-27.1 % from the fp32 oracle; the control 108.9-166.5 %. The bar sits 1.8 times above the largest
# reading and 2.2 times below the smallest control.
LORA_BAR = 0.5


def lora_filter(path):
    """JAX test_serving_multi_lora's filter: every attention and MLP linear."""
    return "att" in path or "ffn" in path


def stacked_adapters(model):
    """LORA_ADAPTERS classic adapters (rank LORA_RANK, α LORA_ALPHA) over
    ``model``'s ``lora_filter`` linears, each B drawn N(0, LORA_B_STD²) from
    a generator seeded by its index, stacked with the null adapter: a model
    that shares ``model``'s base tensors (``model`` keeps no adapter)."""
    import copy
    import itertools

    import torch

    from llm_quest_tpu_torch.ops import lora

    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    adapters = []
    for a in range(LORA_ADAPTERS):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1 + a)
        one = lora.replace_with_lora(gen, copy.deepcopy(model, dict(shared)), LORA_RANK, LORA_ALPHA,
                                     path_filter=lora_filter)
        with torch.no_grad():
            for _, ad in lora.lora_modules(one):
                ad["B"].normal_(0.0, LORA_B_STD, generator=gen)
        adapters.append(one)
    return lora.stack_adapters(adapters)


def lora_traffic():
    """``engine_traffic("uniform")``, request i on adapter i mod 9 (8: none)."""
    n = LORA_ADAPTERS + 1
    return [(ids, gen, {"adapter": None if i % n == LORA_ADAPTERS else i % n})
            for i, (ids, gen, _) in enumerate(engine_traffic("uniform"))]


def lora_vs_merged(model, cfg, traffic, served):
    """The first wave's admission logits and first decode step (greedy)
    through the stacked adapters, each row held to an fp32 prefill of its
    prompt and the step's token through ``merge_adapter`` of its adapter
    (``LORA_BAR``), beside the control (the next adapter's merge, beyond
    the bar on every row); and the greedy agreement of the first
    ENGINE_AGREE_ROWS requests' ``served`` tokens with ``generate_kv_cache``
    on their merged weights (reported, not gated)."""
    import torch

    from llm_quest_tpu_torch.models import qwen3_5
    from llm_quest_tpu_torch.ops.lora import merge_adapter, num_adapters

    n = num_adapters(model)
    engine = engine_for(model, cfg, "uniform", decode_chunk=1)
    wave = traffic[: engine.n_slots]
    for ids, gen, knobs in wave:
        engine.submit(ids, gen, **knobs)
    k = len(wave)
    with torch.inference_mode():
        engine._admit_pending()
        admission = engine.state["last_logits"][:k].clone()
        toks = torch.full((1, engine.n_slots), engine.pad_id, dtype=torch.long, device=DEVICE)
        engine._decode_step(0, engine.eos_arr, toks, None)
        step = engine.state["last_logits"][:k].clone()
    got = torch.stack([admission, step], dim=1)  # (k, 2, vocab)
    adapter = [n - 1 if knobs.get("adapter") is None else knobs["adapter"] for _, _, knobs in wave]
    seq = torch.cat([torch.tensor([ids for ids, _, _ in wave], device=DEVICE), toks[0, :k, None]], dim=1)
    ocfg = {key: v for key, v in cfg.items() if key != "kv_quant"} | {"dtype": torch.float32}
    right, wrong = torch.empty_like(got), torch.empty_like(got)
    agree_rows = list(range(min(ENGINE_AGREE_ROWS, len(served))))
    equal = total = 0
    for j in range(n):
        merged = merge_adapter(model, j).float()
        mine = [i for i in range(k) if adapter[i] == j]
        theirs = [i for i in range(k) if (adapter[i] + 1) % n == j]
        rows = mine + theirs
        with torch.inference_mode():
            cache = qwen3_5.init_cache(ocfg, len(rows), seq.shape[1], device=DEVICE)
            logits, _, _ = qwen3_5.apply_text(merged, ocfg, seq[rows], cache=cache)
        out = logits[:, -2:].float()
        right[mine], wrong[theirs] = out[: len(mine)], out[len(mine):]
        for i in agree_rows:
            if adapter[i] == j:
                ids = traffic[i][0]
                m = min(traffic[i][1], ENGINE_AGREE_TOKENS)
                ref = generate(qwen3_5.TextOnly, merged, ocfg, torch.tensor([ids], device=DEVICE), m)[0, len(ids):]
                equal += sum(a == b for a, b in zip(served[i][:m], ref.tolist()))
                total += m
        del merged, logits
        torch.cuda.empty_cache()
    err = (got - right).abs().amax(-1) / right.abs().amax(-1)  # (k, 2): each row's, of its max |oracle|
    control = (got - wrong).abs().amax(-1) / wrong.abs().amax(-1)
    null = torch.tensor([a == n - 1 for a in adapter], device=DEVICE)

    def worst(t):
        return float(t.max()) if t.numel() else None

    readings = {name: {"max_rel_err": float(err[:, c].max()), "max_rel_err_null_rows": worst(err[null, c]),
                       "max_rel_err_adapter_rows": worst(err[~null, c]),
                       "control_min_rel": float(control[:, c].min()), "control_max_rel": float(control[:, c].max()),
                       "bar": LORA_BAR}
                for c, name in enumerate(("admission", "decode_step"))}
    if not (torch.isfinite(got).all() and float(err.max()) <= LORA_BAR < float(control.min())):
        raise AssertionError(f"engine_multi_lora: rows against their merged adapters (within {LORA_BAR} of "
                             f"max |oracle|) and the wrong-adapter control (beyond it on every row): {readings}")
    return {"rows": k, "adapters": n, **readings, "greedy_agreement_vs_merged": equal / total if total else None,
            "greedy_compared": total}


def engine_multi_lora(records, card):
    """Multi-LoRA serving: Qwen3.5-0.8B text at full width and
    ENGINE_LAYERS of its 24 layers (the engine records' depth), bf16, int8 weights (``quantize_params_int8`` at its defaults)
    and the int8 KV cache, ``engine_serve_uniform``'s engine shape and
    traffic: first without adapters (``engine_multi_lora_base``: K1, K2,
    K10; no plain check, ``engine_serve_int8`` holds this setting to the
    plain versions), then with LORA_ADAPTERS stacked classic adapters over
    its attention and MLP linears and request i on adapter i mod 9
    (``engine_multi_lora``: held to the plain versions, one decode step
    under the sync check), one warmed serve each (for the script's time);
    then every first-wave row held to its merged adapter
    (``lora_vs_merged``). Useful tok/s, kernels and device ms a step of the
    two records as ratios."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.ops.lora import lora_modules, num_adapters
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    t0 = time.perf_counter()
    cfg = dict(QWEN3_5_08B_CONFIG, n_layers=ENGINE_LAYERS, dtype=torch.bfloat16)
    model = text_model(cfg)
    quantize_params_int8(model)
    cfg = dict(cfg, kv_quant="int8")
    torch.cuda.empty_cache()
    rows = 32 - ENGINE_EMPTY_SLOTS
    base, _ = engine_record(ENGINE_LORA_BASE, model, cfg, "uniform", records, card, rows, serves=1, vs_plain=False)
    t_stack = time.perf_counter()
    stacked = stacked_adapters(model)
    stack_s = time.perf_counter() - t_stack
    traffic = lora_traffic()
    rec, served = engine_record(ENGINE_LORA, stacked, cfg, "uniform", records, card, rows, serves=1, sync_check=True,
                                agree=False, traffic=traffic)
    checks = lora_vs_merged(stacked, cfg, traffic, served)

    def ratio(key):
        return None if base[key] is None or rec[key] is None else rec[key] / base[key]

    emit({"phase": "engine_multi_lora_checks", "card": card, "layers": cfg["n_layers"],
          "wrapped_linears": len(lora_modules(stacked)), "adapters": num_adapters(stacked),
          "rank": LORA_RANK, "alpha": LORA_ALPHA, "stack_s": stack_s, "vs_merged": checks,
          "useful_tok_s_ratio": ratio("useful_tok_s"), "kernels_per_step_ratio": ratio("kernels_per_step"),
          "device_ms_per_step_ratio": ratio("device_ms_per_step"),
          "kernels_per_step_added": None if rec["kernels_per_step"] is None or base["kernels_per_step"] is None
          else rec["kernels_per_step"] - base["kernels_per_step"], "seconds": time.perf_counter() - t0})
    del model, stacked
    torch.cuda.empty_cache()


# ------------------------------------------------------------- speculative serving


SPEC_REQUESTS, SPEC_CHUNK = 32, 8  # scripts/bench_spec_serving_flagship.py's requests and chunk
SPEC_BUCKETS = (32, 64, 256)
SPEC_FP32_LAYERS = (4, 2)  # the fp32 check's target and draft depth
SPEC_LAYERS = (18, 14)  # the bf16 and int8 records' depth, half of each model's (the script's time)
SPEC_PROFILE_WINDOWS = 1  # a traced window holds 16,000-23,000 kernels (the trace's reading is the costly part)
SPEC_CHECK_BATCH = 8  # requests a batched uncached forward in ``committed_vs_uncached``
SPEC_ALPHAS = (0.56, 0.8, 1.0)  # the acceptance rates JAX's script projects the window's cost at
# the fp32 check's near-tie bar: a speculative token may differ from the plain engine's only where the
# target's two largest logits there (one uncached fp32 forward) lie within SPEC_TIE_BAR × max |logits|: the
# verify forward's (γ + 1)-query GEMMs and the decode step's 1-query ones sum in other orders (fp32 rounding
# of ~1e-6 of max |logits| a layer at these widths)
SPEC_TIE_BAR = 1e-4


def spec_traffic():
    """``bench_spec_serving_flagship``'s 32 greedy requests with budgets
    U[16, 64], their prompts of ``bench_serving_hetero``'s lengths U[8, 200]
    (the waves reach the 256 bucket, where K4 runs), seed 0:
    [(ids, max_gen, {})]."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens, gens = rng.integers(8, 201, SPEC_REQUESTS), rng.integers(16, 65, SPEC_REQUESTS)
    return [(list(map(int, rng.integers(1, 32_000, n))), int(g), {}) for n, g in zip(lens, gens)]


def spec_models(dtype, layers=(None, None)):
    """Qwen3-4B (target) and Qwen3-0.6B (draft) as the repo's config gives
    them (``qwen3_config_creator``: Qwen/Qwen3-4B's and Qwen/Qwen3-0.6B's
    config.json; full width, ``layers`` cuts the depth), seeded random
    weights (the draft's from the next seed): (target, cfg, draft, cfg)."""
    import torch

    from llm_quest_tpu_torch.config import qwen3_config_creator
    from llm_quest_tpu_torch.models import qwen3

    cfgs = []
    for size, n in zip(("4B", "0.6B"), layers):
        cfg = dict(qwen3_config_creator(size), dtype=dtype)
        cfgs.append(cfg if n is None else dict(cfg, n_layers=n))
    target = init_model(qwen3, cfgs[0])
    draft = qwen3.init(cfgs[1], generator=torch.Generator(device=DEVICE).manual_seed(SEED + 1), device=DEVICE)
    return target, cfgs[0], draft, cfgs[1]


def spec_engine(target, cfg, draft=None, draft_cfg=None, **kw):
    """The speculative engine (the plain one without ``draft``) at the
    record's shape: 16 slots, chunk 8, buckets 32/64/256, max_len 384, γ 4."""
    from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine
    from llm_quest_tpu_torch.models import qwen3

    spec = {} if draft is None else dict(draft_model=qwen3, draft_params=draft, draft_cfg=draft_cfg, gamma=SPEC_GAMMA)
    shape = dict(n_slots=SPEC_SLOTS, max_len=SPEC_MAX_LEN, decode_chunk=SPEC_CHUNK, prefill_buckets=SPEC_BUCKETS)
    return ContinuousBatchingEngine(qwen3, target, cfg, eos_ids=-1, pad_id=0, **{**shape, **spec, **kw})


def uncached_logits(model, cfg, ids, mod=None):
    """(len(ids), vocab) fp32 logits of one uncached forward over ``ids``."""
    return batch_logits(model, cfg, [ids], mod)[0]


def batch_logits(model, cfg, seqs, mod=None):
    """Each sequence's (len, vocab) fp32 logits from one uncached forward of
    the right-padded batch (pads masked out of every key set) through
    ``mod`` (default ``models.qwen3``)."""
    import torch

    from llm_quest_tpu_torch.models import qwen3

    mod = mod or qwen3
    width = max(map(len, seqs))
    ids = torch.zeros(len(seqs), width, dtype=torch.long, device=DEVICE)
    mask = torch.zeros(len(seqs), width, dtype=torch.bool, device=DEVICE)
    for j, seq in enumerate(seqs):
        ids[j, : len(seq)] = torch.tensor(seq, device=DEVICE)
        mask[j, : len(seq)] = True
    with torch.inference_mode():
        logits, _, _ = mod.apply(model, cfg, ids, attn_mask=mask if len(seqs) > 1 else None)
    return [logits[j, : len(seq)].float() for j, seq in enumerate(seqs)]


def near_tie(model, cfg, ids, got, ref, label, *, mod=None, bar=SPEC_TIE_BAR, top2=True,
             phase_name="engine_spec_near_tie"):
    """The first position where the token lists ``got`` and ``ref`` of the
    prompt ``ids`` differ must be a near-tie of the model's (``mod``, default
    ``models.qwen3``): its two largest logits there (one uncached forward)
    are the two tokens and lie within ``bar`` × max |logits| (default
    SPEC_TIE_BAR). Without ``top2`` (bf16, where the uncached forward's own
    argmax may be a third token) both tokens' logits lie within that bar of
    the largest. Returns the reading (None where equal)."""
    if got == ref:
        return None
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} tokens against {len(ref)}")
    j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
    logits = uncached_logits(model, cfg, ids + ref[:j], mod)[-1]
    top = logits.topk(2)
    limit = bar * float(logits.abs().max())
    gaps = [float(top.values[0] - logits[t]) for t in (got[j], ref[j])]
    reading = {"position": j, "tokens": [got[j], ref[j]], "top2": top.indices.tolist(),
               "gap": float(top.values[0] - top.values[1]) if top2 else max(gaps), "bar": limit}
    tied = (set(top.indices.tolist()) == {got[j], ref[j]}) if top2 else True
    if not (tied and reading["gap"] <= limit):
        raise AssertionError(f"{label}: tokens differ at {j} where the logits are no near-tie: {reading}")
    emit({"phase": phase_name, "label": label, **reading})
    return reading


def spec_check_fp32(traffic):
    """engine_spec_fp32: Qwen3-4B (4 of 36 layers) with Qwen3-0.6B (2 of
    28), full width, fp32 (TF32 off): every request's speculative tokens
    equal the plain engine's (a near-tie excepted: ``near_tie``); with the
    target as its own draft every window commits γ + 1 (the first 16
    requests: their row-windows are Σ ⌈budget / (γ + 1)⌉); and
    ``speculative_generate`` on one prompt equals ``generate_kv_cache``.
    Every K4 launch on the SIMT kernel (fp32)."""
    import torch

    from llm_quest_tpu_torch.inference.spec_decoding import speculative_generate
    from llm_quest_tpu_torch.models import qwen3

    t0 = time.perf_counter()
    target, tcfg, draft, dcfg = spec_models(torch.float32, SPEC_FP32_LAYERS)
    reset_launches()
    plain, plain_s, _ = drive(spec_engine(target, tcfg), traffic)
    eng = spec_engine(target, tcfg, draft, dcfg)
    spec, spec_s, _ = drive(eng, traffic)
    ties = [t for (ids, gen, _), a, b in zip(traffic, spec, plain)
            if (t := near_tie(target, tcfg, ids, a, b, "engine_spec_fp32")) is not None]
    if sum(map(len, spec)) != sum(gen for _, gen, _ in traffic):
        raise AssertionError("engine_spec_fp32: a request did not get its budget")
    selfd = spec_engine(target, tcfg, target, tcfg)
    drive(selfd, traffic[:SPEC_SLOTS])
    windows = sum(-(-gen // (SPEC_GAMMA + 1)) for _, gen, _ in traffic[:SPEC_SLOTS])
    self_stats = selfd.stats()
    if self_stats["row_windows"] != windows:
        raise AssertionError(f"engine_spec_fp32: the self-draft took {self_stats['row_windows']} row-windows, "
                             f"not {windows} (γ + 1 committed a window)")
    ids, gen = traffic[0][0], 32
    ref = generate(qwen3, target, tcfg, torch.tensor([ids], device=DEVICE), gen)[0, len(ids):].tolist()
    out = speculative_generate(qwen3, target, tcfg, qwen3, draft, dcfg, [ids], max_gen=gen, draft_max_gen=SPEC_GAMMA)
    single = out["sequences"][0, len(ids):].tolist()
    tie = near_tie(target, tcfg, ids, single, ref, "speculative_generate_fp32")
    check_routes("engine_spec_fp32", bf16=False)
    stats = eng.stats()
    emit({"phase": "engine_spec_fp32", "layers": list(SPEC_FP32_LAYERS), "requests": len(traffic),
          "tokens": sum(map(len, spec)), "requests_equal": len(traffic) - len(ties), "near_ties": ties,
          "windows": stats["windows"], "tokens_per_row_window": stats["tokens_per_row_window"],
          "self_draft_row_windows": self_stats["row_windows"], "self_draft_tokens_per_row_window":
          self_stats["tokens_per_row_window"], "speculative_generate_equal": tie is None,
          "speculative_generate_windows": int(out["num_steps"]), "plain_s": plain_s, "spec_s": spec_s,
          "seconds": time.perf_counter() - t0})
    del target, draft
    torch.cuda.empty_cache()


def committed_vs_uncached(model, cfg, traffic, served):
    """Each committed token's logit, from one uncached forward over its
    prompt and committed tokens (SPEC_CHECK_BATCH requests a right-padded
    batch), within ENGINE_PLAIN_BAR × max |row| of its row's maximum (the
    engine records' bar); the control, a seeded random token at each
    position, must read beyond the bar at most positions (else the bar could
    not see a wrong token). The readings."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    gaps, ctrl, argmax = [], [], 0
    pairs = [(ids, toks) for (ids, _, _), toks in zip(traffic, served)]
    for i in range(0, len(pairs), SPEC_CHECK_BATCH):
        chunk = pairs[i : i + SPEC_CHECK_BATCH]
        for (ids, toks), logits in zip(chunk, batch_logits(model, cfg, [ids + toks for ids, toks in chunk])):
            rows = logits[len(ids) - 1 : len(ids) - 1 + len(toks)]
            top, bar = rows.amax(-1), ENGINE_PLAIN_BAR * rows.abs().amax(-1)
            tok = torch.tensor(toks, device=DEVICE)
            gaps.append((top - rows.gather(1, tok[:, None])[:, 0]) / bar)
            rand = torch.randint(0, rows.shape[1], tok.shape, generator=gen, device=DEVICE)
            ctrl.append((top - rows.gather(1, rand[:, None])[:, 0]) / bar)
            argmax += int((rows.argmax(-1) == tok).sum())
    gaps, ctrl = torch.cat(gaps), torch.cat(ctrl)
    reading = {"max_gap_over_bar": float(gaps.max()), "tokens": int(gaps.numel()), "argmax_share":
               argmax / gaps.numel(), "control_beyond_bar_share": float((ctrl > 1).float().mean()),
               "bar": ENGINE_PLAIN_BAR}
    if not (bool(torch.isfinite(gaps).all()) and reading["max_gap_over_bar"] <= 1.0):
        raise AssertionError(f"engine_spec: a committed token's logit lies beyond the bar of its row's max: {reading}")
    if not reading["control_beyond_bar_share"] > 0.5:
        raise AssertionError(f"engine_spec: random tokens read within the bar: {reading}")
    return reading


def spec_record(path, target, tcfg, draft, dcfg, traffic, records, card):
    """One speculative record: the first wave's admission and one window
    with every K4/K10 call held to its plain version (``HeldToPlain``), the
    next window under ``torch.cuda.set_sync_debug_mode`` "error" (no host
    sync inside a chunk), then the serve with the counts reset (each
    request its budget, every token in the vocabulary, the committed
    tokens against an uncached forward: ``committed_vs_uncached``), a
    profiled chunk of SPEC_PROFILE_WINDOWS windows and the plain engine on
    the same traffic. One serve each (the script's
    time); neither warmed by ``warmup``: the checks ran the first wave and
    a window at the serve's shapes."""
    import torch

    t0 = time.perf_counter()
    eng = spec_engine(target, tcfg, draft, dcfg, decode_chunk=1)
    for ids, gen, _ in traffic[:SPEC_SLOTS]:
        eng.submit(ids, gen)
    toks = torch.zeros(2, SPEC_SLOTS, SPEC_GAMMA + 1, dtype=torch.long, device=DEVICE)
    counts = torch.zeros(2, SPEC_SLOTS, dtype=torch.long, device=DEVICE)
    with torch.inference_mode():
        with HeldToPlain() as held:
            eng._admit_pending()
            eng._window(0, eng.eos_arr, toks, counts)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._window(1, eng.eos_arr, toks, counts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    del eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = spec_engine(target, tcfg, draft, dcfg)
    reset_launches()
    served, seconds, _ = drive(engine, traffic)
    launches = read_launches(path, records)
    tc = {name: getattr(wrapper((module, name)), counter) for module, name, total, counter in TC_COUNTERS
          if total == "launches"}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = engine.stats()
    vocab = tcfg["vocab_size"]
    for (_, gen, _), got in zip(traffic, served):
        if len(got) != gen or not all(0 <= t < vocab for t in got):
            raise AssertionError(f"{path}: a request got {len(got)} tokens for a budget of {gen}, or a token "
                                 f"outside the vocabulary")
    uncached = committed_vs_uncached(target, tcfg, traffic, served)
    profile = engine_chunk_profile(
        target, tcfg, "uniform", traffic, SPEC_PROFILE_WINDOWS, n_slots=SPEC_SLOTS, max_len=SPEC_MAX_LEN,
        prefill_buckets=SPEC_BUCKETS, draft_model=entry_of(target), draft_params=draft, draft_cfg=dcfg,
        gamma=SPEC_GAMMA)
    useful = sum(map(len, served)) / seconds
    ptoks, pseconds, _ = drive(spec_engine(target, tcfg), traffic)
    plain = sum(map(len, ptoks)) / pseconds
    tpw = stats["tokens_per_row_window"]
    floor = useful / tpw  # the rate at one committed token a row-window
    rec = {"phase": path, "card": card, "target": "Qwen3-4B", "draft": "Qwen3-0.6B", "dtype": "bfloat16",
           "layers": [tcfg["n_layers"], dcfg["n_layers"]], "kv_quant": tcfg.get("kv_quant"),
           "int8_weights": any(t.dtype == torch.int8 for t in target.state_dict().values()),
           "requests": len(traffic), "n_slots": SPEC_SLOTS, "max_len": SPEC_MAX_LEN, "decode_chunk": SPEC_CHUNK,
           "gamma": SPEC_GAMMA, "buckets": list(SPEC_BUCKETS), "useful_tok_s": useful, "serve_s": seconds,
           "plain_useful_tok_s": plain, "plain_serve_s": pseconds, "spec_over_plain": useful / plain,
           "windows": stats["windows"], "row_windows": stats["row_windows"], "decode_chunks": stats["decode_chunks"],
           "tokens_per_row_window": tpw, "mean_accepted": tpw - 1, "window_wall_ms": seconds / stats["windows"] * 1e3,
           "projected_tok_s_not_claimed": {f"alpha_{a}": floor * (1 + a * SPEC_GAMMA) for a in SPEC_ALPHAS},
           "breakeven_alpha": (plain / floor - 1) / SPEC_GAMMA,
           "ttft_p50_ms": None if stats.get("ttft_p50_s") is None else stats["ttft_p50_s"] * 1e3,
           "stats": stats, "device_ms_per_window": profile["device_ms_per_step"],
           "kernels_per_window": profile["kernels_per_step"], "busy_share": profile["busy_share"],
           "profiled_chunk_wall_ms": profile["chunk_wall_ms"], "profiled_windows": SPEC_PROFILE_WINDOWS,
           "launches": launches, "tc_launches": tc, "kernel_calls_vs_plain": held.readings,
           "window_host_syncs": 0, "committed_vs_uncached": uncached, "peak_memory_gb": peak_gb,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def engine_spec(records, card):
    """Speculative serving: the fp32 check (``spec_check_fp32``); then
    Qwen3-4B (SPEC_LAYERS: 18 of 36 layers, d 2560, 32/8 heads of 128, FFN
    9728, vocab 151,936) with a Qwen3-0.6B draft (14 of 28 layers, d 1024,
    16/8 heads) at full width, bf16
    (``engine_spec``: K4 at the 256 bucket in both models' admissions),
    then both quantized in place (``quantize_params_int8``) with the int8
    KV cache (``engine_spec_int8``: K4, and K10 in the draft's steps):
    ``spec_record`` each, beside the plain engine, on ``spec_traffic``,
    greedy."""
    import torch

    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    t0 = time.perf_counter()
    traffic = spec_traffic()
    spec_check_fp32(traffic)
    t_init = time.perf_counter()
    target, tcfg, draft, dcfg = spec_models(torch.bfloat16, SPEC_LAYERS)
    init_s = time.perf_counter() - t_init
    bf16 = spec_record(ENGINE_SPEC, target, tcfg, draft, dcfg, traffic, records, card)
    quantize_params_int8(target)
    quantize_params_int8(draft)
    torch.cuda.empty_cache()
    int8 = spec_record(ENGINE_SPEC_INT8, target, dict(tcfg, kv_quant="int8"), draft, dict(dcfg, kv_quant="int8"),
                       traffic, records, card)
    emit({"phase": "engine_spec_summary", "card": card, "layers": list(SPEC_LAYERS), "init_s": init_s,
          "weights_gb": [weight_gb(target), weight_gb(draft)],
          "useful_tok_s": {"bf16": bf16["useful_tok_s"], "bf16_plain": bf16["plain_useful_tok_s"],
                           "int8": int8["useful_tok_s"], "int8_plain": int8["plain_useful_tok_s"]},
          "mean_accepted": {"bf16": bf16["mean_accepted"], "int8": int8["mean_accepted"]},
          "seconds": time.perf_counter() - t0})
    del target, draft
    torch.cuda.empty_cache()


# ----------------------------------------------- speculative serving over hybrid caches


# scripts/bench_spec_serving_flagship.py's workload: 32 greedy requests, 32-token prompts of ids in [1, 1000),
# budgets U[16, 64], seed 0; 16 slots, chunk 8, γ 4 (SPEC_GAMMA), 160 columns, the 32-token bucket
HSPEC_REQUESTS, HSPEC_PROMPT, HSPEC_SLOTS, HSPEC_CHUNK, HSPEC_MAX_LEN = 32, 32, 16, 8, 160
HSPEC_BUCKETS = (32,)
HSPEC_FP32_REQUESTS = 8
HSPEC_FP32_LAYERS = {"qwen3_5": 4, "qwen3_next": 2}  # Qwen3.5: 3 GDN + 1 attention; Qwen3-Next: 2 GDN
HSPEC_NEXT_LAYERS, HSPEC_NEXT_REQUESTS = 8, 16
HSPEC_GENERATE = 64  # speculative_generate's max_gen (b 1)
# the flagship's small draft (bench_spec_serving_flagship.py:70-73): 4 layers (3 GDN), d 512, 4/2 heads of
# 128, GDN 8/8 heads of 64
HSPEC_SMALL_DRAFT = dict(n_layers=4, emb_dim=512, hidden_dim=1536, n_heads=4, num_kv_groups=2, head_dim=128,
                         linear_num_qk_heads=8, linear_num_value_heads=8, linear_qk_head_dim=64,
                         linear_value_head_dim=64)
# after a fp32 serve each row's GDN states and conv taps against a fp32 prefill of its committed tokens but
# the last: max |Δ| within HSPEC_STATE_TOL × max(1, max |prefill|) (K1's scan over the whole sequence against
# its re-advances window by window: fp32 sums in another order); the control that keeps every window token
# must read beyond it
HSPEC_STATE_TOL = 1e-4
HSPEC_TIE_CONTROL = 256  # ``bf16_tie``'s random control tokens


def hspec_traffic(n=HSPEC_REQUESTS):
    """``bench_spec_serving_flagship``'s requests, drawn as it draws them:
    [(ids, max_gen, {})]."""
    import numpy as np

    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 1000, size=HSPEC_PROMPT).tolist(), int(rng.integers(16, 65)))
            for _ in range(HSPEC_REQUESTS)]
    return [(list(map(int, ids)), gen, {}) for ids, gen in reqs[:n]]


def hspec_engine(target, cfg, draft=None, draft_cfg=None, **kw):
    """The flagship's engine over ``target`` (speculative with ``draft``)."""
    from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine

    spec = {} if draft is None else dict(draft_model=entry_of(draft), draft_params=draft, draft_cfg=draft_cfg,
                                         gamma=SPEC_GAMMA)
    shape = dict(n_slots=HSPEC_SLOTS, max_len=HSPEC_MAX_LEN, decode_chunk=HSPEC_CHUNK, prefill_buckets=HSPEC_BUCKETS)
    return ContinuousBatchingEngine(entry_of(target), target, cfg, eos_ids=-1, pad_id=0, **{**shape, **spec, **kw})


def hybrid_model(family, n_layers, dtype, **widths):
    """Qwen3.5-0.8B's text model or Qwen3-Next-small at ``n_layers``, seeded random weights: (model, cfg)."""
    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.models import qwen3_next

    if family == "qwen3_5":
        cfg = dict(QWEN3_5_08B_CONFIG, n_layers=n_layers, dtype=dtype, **widths)
        return text_model(cfg), cfg
    cfg = dict(next_serve_cfg(n_layers, dtype), **widths)
    return init_model(qwen3_next, cfg), cfg


@contextlib.contextmanager
def windows_keep_all():
    """The control: every window keeps all γ + 1 tokens it fed in the GDN
    states and taps (JAX's windows), whatever the counts."""
    import torch

    from llm_quest_tpu_torch.ops import gdn as gdn_ops

    real = gdn_ops.roll_window

    def keep_all(cfg, cache, counts, before=None):
        return real(cfg, cache, torch.full_like(counts, SPEC_GAMMA + 1), before)

    gdn_ops.roll_window = keep_all
    try:
        yield
    finally:
        gdn_ops.roll_window = real


def states_vs_prefill(pool, model, cfg, seqs):
    """max |Δ| over the GDN state and tap leaves of ``pool``'s first
    len(seqs) rows against one right-padded fp32 prefill of ``seqs``
    through ``model``, over max(1, max |prefill|) (the reading against
    HSPEC_STATE_TOL)."""
    import torch

    from llm_quest_tpu_torch.ops import gdn as gdn_ops

    entry = entry_of(model)
    width = max(map(len, seqs))
    ids = torch.zeros(len(seqs), width, dtype=torch.long, device=DEVICE)
    mask = torch.zeros(len(seqs), width, dtype=torch.bool, device=DEVICE)
    for j, seq in enumerate(seqs):
        ids[j, : len(seq)] = torch.tensor(seq, device=DEVICE)
        mask[j, : len(seq)] = True
    with torch.inference_mode():
        cache = entry.init_cache(cfg, len(seqs), width, device=DEVICE)
        _, cache, _ = entry.apply(model, cfg, ids, attn_mask=mask, cache=cache)
    reading = 0.0
    for name in gdn_ops.state_leaves(cache):
        err, scale = max_err(pool[name][:, : len(seqs)], cache[name])
        reading = max(reading, err / max(1.0, scale))
    return reading


def hspec_check_fp32(family):
    """``engine_spec_hybrid_fp32``: the family's full widths at
    HSPEC_FP32_LAYERS, fp32, the model as its own draft on the flagship's
    first 8 requests: tokens equal to the plain engine's (a near-tie within
    SPEC_TIE_BAR excepted), every window γ + 1 where no budget cuts it (row
    windows Σ ⌈budget / (γ + 1)⌉), both pools' states and taps a prefill
    of each row's committed tokens but the last (HSPEC_STATE_TOL), and the
    control that keeps every window token beyond that bar."""
    import torch

    t0 = time.perf_counter()
    model, cfg = hybrid_model(family, HSPEC_FP32_LAYERS[family], torch.float32)
    traffic = hspec_traffic(HSPEC_FP32_REQUESTS)
    reset_launches()
    plain, _, _ = drive(hspec_engine(model, cfg), traffic)
    eng = hspec_engine(model, cfg, model, cfg)
    spec, spec_s, _ = drive(eng, traffic)
    ties = [t for (ids, _, _), a, b in zip(traffic, spec, plain)
            if (t := near_tie(model, cfg, ids, a, b, f"engine_spec_hybrid_fp32_{family}", mod=entry_of(model),
                              phase_name="engine_spec_hybrid_near_tie")) is not None]
    windows = sum(-(-gen // (SPEC_GAMMA + 1)) for _, gen, _ in traffic)
    stats = eng.stats()
    if stats["row_windows"] != windows:
        raise AssertionError(f"engine_spec_hybrid_fp32 {family}: the self-draft took {stats['row_windows']} "
                             f"row-windows, not {windows} (γ + 1 committed a window)")
    seqs = [ids + toks[:-1] for (ids, _, _), toks in zip(traffic, spec)]
    state = {pool: states_vs_prefill(eng.state[pool], model, cfg, seqs) for pool in ("cache", "d_cache")}
    if not max(state.values()) <= HSPEC_STATE_TOL:
        raise AssertionError(f"engine_spec_hybrid_fp32 {family}: states against the prefill {state}")
    with windows_keep_all():
        ctrl_eng = hspec_engine(model, cfg, model, cfg)
        ctrl, _, _ = drive(ctrl_eng, traffic)
    ctrl_seqs = [ids + toks[:-1] for (ids, _, _), toks in zip(traffic, ctrl)]
    control = {pool: states_vs_prefill(ctrl_eng.state[pool], model, cfg, ctrl_seqs) for pool in ("cache", "d_cache")}
    if not min(control.values()) > HSPEC_STATE_TOL:
        raise AssertionError(f"engine_spec_hybrid_fp32 {family}: the keep-all control reads {control}")
    check_routes(f"engine_spec_hybrid_fp32_{family}", bf16=False)
    emit({"phase": "engine_spec_hybrid_fp32", "family": family, "layers": cfg["n_layers"],
          "requests": len(traffic), "requests_equal": len(traffic) - len(ties), "near_ties": ties,
          "row_windows": stats["row_windows"], "expected_row_windows": windows,
          "tokens_per_row_window": stats["tokens_per_row_window"], "state_vs_prefill": state,
          "keep_all_control": control, "bar": HSPEC_STATE_TOL, "spec_s": spec_s,
          "seconds": time.perf_counter() - t0})
    del model, eng, ctrl_eng
    torch.cuda.empty_cache()


def bf16_tie(model, cfg, twin, ids, got, ref, label):
    """The bf16 near-tie rule of the flagship serves: where the token lists
    ``got`` and ``ref`` of the prompt ``ids`` first differ, both tokens'
    logits lie within twice the bf16 forward's own error of the fp32
    forward's largest (any bf16 argmax lies that close to the fp32 one). The
    error is max |bf16 − fp32| over that row's logits, one uncached forward
    each through ``model`` and its fp32 ``twin``; most of HSPEC_TIE_CONTROL
    seeded random tokens there must lie beyond the bar (random weights give
    flat logits, so the bar is wide). Returns the reading (None where equal)."""
    import torch

    if got == ref:
        return None
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} tokens against {len(ref)}")
    j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
    mod = entry_of(model)
    seq = ids + ref[:j]
    l16 = uncached_logits(model, cfg, seq, mod)[-1]
    l32 = uncached_logits(twin, dict(cfg, dtype=torch.float32), seq, mod)[-1]
    noise, top = float((l16 - l32).abs().max()), float(l32.max())
    rand = torch.randint(0, l32.numel(), (HSPEC_TIE_CONTROL,), generator=torch.Generator().manual_seed(SEED + j))
    reading = {"position": j, "tokens": [got[j], ref[j]], "gap": max(top - float(l32[t]) for t in (got[j], ref[j])),
               "bar": 2 * noise, "bf16_error": noise,
               "control_beyond_bar_share": float((top - l32[rand.to(l32.device)] > 2 * noise).float().mean())}
    if not reading["gap"] <= reading["bar"]:
        raise AssertionError(f"{label}: tokens differ at {j} where the logits are no near-tie: {reading}")
    if not reading["control_beyond_bar_share"] > 0.5:
        raise AssertionError(f"{label}: random tokens read within the near-tie bar: {reading}")
    emit({"phase": "engine_spec_hybrid_near_tie", "label": label, **reading})
    return reading


def fp32_twin(model):
    """An fp32 copy of ``model`` (``bf16_tie``'s reference), on the card."""
    import copy

    return copy.deepcopy(model).float()


def prefix_agreement(a_lists, b_lists):
    """The flagship script's agreement: tokens before each pair's first
    difference over the longer list's length, summed over the requests."""
    matched = total = 0
    for a, b in zip(a_lists, b_lists):
        total += max(len(a), len(b))
        for x, y in zip(a, b):
            if x != y:
                break
            matched += 1
    return matched / max(total, 1)


def rollback_cost(target, tcfg, draft, dcfg, traffic):
    """One window's rollback at the serve's shapes: a window over the first
    wave with ``roll_window``'s calls captured, then those calls (both
    pools) and the draft's state copy replayed: their CUDA-event ms and
    device ms (profiler), and the K1 launches a window they make."""
    import torch

    from llm_quest_tpu_torch.kernels import gdn
    from llm_quest_tpu_torch.ops import gdn as gdn_ops

    eng = hspec_engine(target, tcfg, draft, dcfg, decode_chunk=1)
    for ids, gen, _ in traffic[:HSPEC_SLOTS]:
        eng.submit(ids, gen)
    grabbed, real = [], gdn_ops.roll_window

    def grab(cfg, cache, counts, before=None):
        leaves = {n: cache[n] for n in gdn_ops.state_leaves(cache)}
        grabbed.append((cfg, leaves, dict(cache[gdn_ops.WINDOW]), counts.clone(), before))
        return real(cfg, cache, counts, before)

    toks = torch.zeros(1, HSPEC_SLOTS, SPEC_GAMMA + 1, dtype=torch.long, device=DEVICE)
    counts = torch.zeros(1, HSPEC_SLOTS, dtype=torch.long, device=DEVICE)
    with torch.inference_mode():
        eng._admit_pending()
        gdn_ops.roll_window = grab
        try:
            eng._window(0, eng.eos_arr, toks, counts)
        finally:
            gdn_ops.roll_window = real
        d_cache = eng.state["d_cache"]

        def rollback():
            if gdn_ops.has_gdn_state(d_cache):  # the draft's state kept before the window
                _ = [d_cache[n].clone() for n in gdn_ops.state_leaves(d_cache)]
            for cfg, leaves, window, n, before in grabbed:
                real(cfg, {**leaves, gdn_ops.WINDOW: dict(window)}, n, before)

        k1 = gdn.gated_delta_rule_fwd.launches
        rollback()
        torch_sync()
        out = {"k1_launches": gdn.gated_delta_rule_fwd.launches - k1, "ms": cuda_ms(rollback, iters=10),
               "device_ms": device_ms(rollback, "", iters=5)}
    del eng
    torch.cuda.empty_cache()
    return out


def hspec_record(path, target, tcfg, draft, dcfg, traffic, records, card, plain, twin=None):
    """One flagship serve: the rollback's cost first (``rollback_cost``),
    then the serve with the counts reset (each request its budget, every
    token in the vocabulary, greedy tokens against ``plain``'s by
    ``bf16_tie`` with the target's fp32 ``twin``: the verify runs K1's
    chunked bf16 form, the plain engine K2's steps), a profiled window.
    Without ``draft`` the plain engine itself (a profiled step). Returns the
    record, the tokens and the useful tok/s."""
    import torch

    t0 = time.perf_counter()
    rollback = None if draft is None else rollback_cost(target, tcfg, draft, dcfg, traffic)
    torch.cuda.reset_peak_memory_stats()
    engine = hspec_engine(target, tcfg, draft, dcfg)
    reset_launches()
    served, seconds, _ = drive(engine, traffic)
    launches = read_launches(path, records) if path else None
    k1_tc = wrapper(("gdn", "gated_delta_rule_fwd")).tc_launches  # the serve's (read_launches checked all are)
    vocab = tcfg["vocab_size"]
    for (_, gen, _), got in zip(traffic, served):
        if len(got) != gen or not all(0 <= t < vocab for t in got):
            raise AssertionError(f"{path}: a request got {len(got)} tokens for a budget of {gen}, or a token "
                                 f"outside the vocabulary")
    ties = []
    if plain is not None:
        ties = [t for (ids, _, _), a, b in zip(traffic, served, plain[0])
                if (t := bf16_tie(target, tcfg, twin, ids, a, b, path)) is not None]
    spec = {} if draft is None else dict(draft_model=entry_of(draft), draft_params=draft, draft_cfg=dcfg,
                                         gamma=SPEC_GAMMA)
    profile = engine_chunk_profile(target, tcfg, "uniform", traffic, 1, n_slots=HSPEC_SLOTS, max_len=HSPEC_MAX_LEN,
                                   prefill_buckets=HSPEC_BUCKETS, **spec)
    stats = engine.stats()
    useful = sum(map(len, served)) / seconds
    rec = {"phase": path or "engine_spec_hybrid_plain", "card": card, "dtype": str(tcfg["dtype"]),
           "layers": tcfg["n_layers"], "requests": len(traffic), "n_slots": HSPEC_SLOTS, "gamma": SPEC_GAMMA,
           "useful_tok_s": useful, "serve_s": seconds, "stats": stats, "launches": launches,
           "k1_tc_launches": k1_tc, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "device_ms_per_window" if draft is not None else "device_ms_per_step": profile["device_ms_per_step"],
           "kernels_per_window" if draft is not None else "kernels_per_step": profile["kernels_per_step"],
           "busy_share": profile["busy_share"], "profiled_wall_ms": profile["chunk_wall_ms"]}
    if draft is not None:
        dev = profile["device_ms_per_step"]
        rec.update(tokens_per_row_window=stats["tokens_per_row_window"], windows=stats["windows"],
                   row_windows=stats["row_windows"], window_wall_ms=seconds / stats["windows"] * 1e3,
                   useful_over_plain=useful / plain[1], prefix_agreement_with_plain=prefix_agreement(served, plain[0]),
                   requests_equal_to_plain=sum(a == b for a, b in zip(served, plain[0])), near_ties=ties,
                   rollback=rollback, rollback_share_of_window_device_ms=(
                       None if dev is None or rollback["device_ms"] is None else rollback["device_ms"] / dev))
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec, served, useful


def engine_spec_hybrid(records, card):
    """Speculative serving over hybrid caches: the fp32 checks (Qwen3.5 and
    Qwen3-Next, ``hspec_check_fp32``); the flagship workload
    (``bench_spec_serving_flagship.py``) on Qwen3.5-0.8B text at full width
    and depth, bf16: the plain engine, the model as its own draft
    (``engine_spec_hybrid``) and the flagship's small draft
    (``engine_spec_hybrid_small``), each ``hspec_record``; Qwen3-Next-small
    (8 layers, bf16) as its own draft on 16 of the requests
    (``engine_spec_next``); ``speculative_generate`` of Qwen3.5-0.8B with
    itself as the draft, b 1, HSPEC_GENERATE tokens, against ``generate``'s
    (``speculative_generate_hybrid``, near-tie gate); and the standalone
    script ``scripts/spec_decoding_generate.py`` at γ 4 and max_gen 50."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.inference.spec_decoding import speculative_generate
    from llm_quest_tpu_torch.scripts import spec_decoding_generate

    t0 = time.perf_counter()
    for family in HSPEC_FP32_LAYERS:
        hspec_check_fp32(family)
    traffic = hspec_traffic()
    target, tcfg = hybrid_model("qwen3_5", QWEN3_5_08B_CONFIG["n_layers"], torch.bfloat16)
    small = qwen3_5_small_draft()
    twin = fp32_twin(target)
    plain_rec, plain_toks, plain_rate = hspec_record(None, target, tcfg, None, None, traffic, records, card, None)
    plain = (plain_toks, plain_rate)
    selfd = hspec_record(ENGINE_SPEC_HYBRID, target, tcfg, target, tcfg, traffic, records, card, plain, twin)[0]
    smalld = hspec_record(ENGINE_SPEC_HYBRID_SMALL, target, tcfg, *small, traffic, records, card, plain, twin)[0]
    # speculative_generate, b 1, the model as its own draft
    ids = traffic[0][0]
    ref = generate(entry_of(target), target, tcfg, torch.tensor([ids], device=DEVICE), HSPEC_GENERATE)
    ref = ref[0, len(ids):].tolist()
    reset_launches()
    t1 = time.perf_counter()
    out = speculative_generate(entry_of(target), target, tcfg, entry_of(target), target, tcfg, [ids],
                               max_gen=HSPEC_GENERATE, draft_max_gen=SPEC_GAMMA)
    single = out["sequences"][0, len(ids):].tolist()
    single_s = time.perf_counter() - t1
    gen_launches = read_launches(SPEC_GENERATE_HYBRID, records)
    tie = bf16_tie(target, tcfg, twin, ids, single, ref, SPEC_GENERATE_HYBRID)
    del target, small, twin
    torch.cuda.empty_cache()
    # Qwen3-Next-small as its own draft
    nxt, ncfg = hybrid_model("qwen3_next", HSPEC_NEXT_LAYERS, torch.bfloat16)
    ntraffic = traffic[:HSPEC_NEXT_REQUESTS]
    nplain, nplain_s, _ = drive(hspec_engine(nxt, ncfg), ntraffic)
    next_rec = hspec_record(ENGINE_SPEC_NEXT, nxt, ncfg, nxt, ncfg, ntraffic, records, card,
                            (nplain, sum(map(len, nplain)) / nplain_s), fp32_twin(nxt))[0]
    del nxt
    torch.cuda.empty_cache()
    # the standalone script (GPT-2 355M target, 124M draft; KV caches, no hand kernel on its path)
    t2 = time.perf_counter()
    script = spec_decoding_generate.main(gammas=(SPEC_GAMMA,), max_gens=(50,))[50]
    script_s = time.perf_counter() - t2
    row = script["gammas"][SPEC_GAMMA]
    emit({"phase": "engine_spec_hybrid", "card": card,
          "useful_tok_s": {"plain": plain_rate, "self_draft": selfd["useful_tok_s"],
                           "small_draft": smalld["useful_tok_s"], "next_self_draft": next_rec["useful_tok_s"]},
          "tokens_per_row_window": {"self_draft": selfd["tokens_per_row_window"],
                                    "small_draft": smalld["tokens_per_row_window"],
                                    "next_self_draft": next_rec["tokens_per_row_window"]},
          "rollback_ms": {"self_draft": selfd["rollback"], "small_draft": smalld["rollback"]},
          "self_draft_prefix_agreement": selfd["prefix_agreement_with_plain"],
          "speculative_generate": {"tokens": len(single), "windows": int(out["num_steps"]), "seconds": single_s,
                                   "tok_s": len(single) / single_s, "equal_to_generate": tie is None,
                                   "near_tie": tie, "launches": gen_launches},
          "spec_decoding_generate": {"plain_tok_s": script["plain_tok_s"], "tok_s": row["tok_s"],
                                     "speedup": row["speedup"], "steps": row["steps"],
                                     "equal_to_plain": row["equal_to_plain"], "seconds": script_s},
          "plain_device_ms_per_step": plain_rec["device_ms_per_step"], "seconds": time.perf_counter() - t0})


def qwen3_5_small_draft():
    """The flagship's small draft: Qwen3.5-0.8B's config at HSPEC_SMALL_DRAFT's
    widths, bf16, seeded from the next seed: (model, cfg)."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.models import qwen3_5

    cfg = dict(QWEN3_5_08B_CONFIG, dtype=torch.bfloat16, **HSPEC_SMALL_DRAFT)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    return qwen3_5.init_text(cfg, generator=gen, device=DEVICE), cfg


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
    phase(gpt2_train, records, smi)
    phase(llama_train, records, smi)
    phase(hyper_qwen3_train, records, smi)
    phase(classifier_train, records, smi)
    phase(dpo_train, records, smi)
    phase(rm_train, records, smi)
    phase(grpo_rlhf, records, smi)
    phase(rlvr_rpt, records, smi)
    phase(vlm_train, records, smi)
    phase(vlm_generate, records, smi)
    phase(uint8_encode, records, smi)
    phase(hf_loaders, records, smi)
    phase(training_ops, records, smi)
    t_checks = time.perf_counter()
    serving_checks_fp32()
    PHASE_SECONDS["serving_checks_fp32"] = time.perf_counter() - t_checks
    phase(serving_paths, records, smi)
    t_checks = time.perf_counter()
    engine_check_fp32()
    PHASE_SECONDS["engine_check_fp32"] = time.perf_counter() - t_checks
    phase(engine_admission_bf16)
    phase(engine_serving, records, smi)
    t_checks = time.perf_counter()
    engine_check_fp32(bits=4)
    PHASE_SECONDS["engine_check_int4_fp32"] = time.perf_counter() - t_checks
    phase(engine_admission_paths, records, smi)
    phase(engine_moe_paths, records, smi)
    phase(engine_int4_paths, records, smi)
    phase(moe_variants, records, smi)
    phase(engine_multi_lora, records, smi)
    phase(engine_spec, records, smi)
    phase(engine_spec_hybrid, records, smi)
    phase(engine_llama, records, smi)

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
