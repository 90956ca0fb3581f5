#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout.  Phases, in order; any failure exits
nonzero and prints no result:

  1. environment — card name and power limit, torch / CUDA versions; TF32
     off for matmuls and cuDNN;
  2. build — nvcc builds every kernel of `src/repro_torch/csrc/` (one nvcc
     per source, in parallel);
  3. kernel parity — each dense kernel (K1-K4) against its plain PyTorch
     version on the card at phi4-mini-3.8b's shapes, bf16 and fp32, every
     schedule and epilogue on the path, K2 bitwise equal to one K1 call
     per batch slice, a_resident at the tuner's decode rows (m 1 / 4 / 8
     against 4096^2), a_resident and b_resident at the LM head's E^T
     (m 1 / 4 / 8), K3's slab planes bitwise equal to K1 k_inner on each
     slice pair (m 1 / 4 / 8 / 16 / 64, E^T and row-major B, a ragged
     last slice, one split), plus split-K bitwise stability across split
     counts for integer-valued inputs, and K4 bitwise equal to the plain
     `tree_sum` reduce on random fp32 slabs of depth 7 to 14600;
  4. serve at full width (the first main path) — phi4-mini-3.8b, bf16,
     seeded weights, batch 4 x prompt 128 + 16 generated tokens through
     `repro_torch.launch.serve.serve`; then, because the gpu_h100 planner
     picks neither split-K nor the batched grid at these shapes, a batch-1
     serve and explicit-plan calls through `ops` at the LM-head shape for
     each kernel still without a launch.  Launch counts are zeroed just
     before this phase and read just after it.  `serve` decodes through a
     CUDA graph (`serve.graphs.DecodeGraph`: one warm-up step on a scratch
     cache, one capture, a replay a token); after the counts are read,
     every serve run of this and the later serve phases is decoded once
     more by an eager loop over `engine.decode_step` (`graph_vs_eager`):
     tokens and first and last decode logits must be bitwise equal, the
     graph's launches per step equal to an eager step's, and both decode
     ms per token are printed;
  5. whole-path parity — prefill and first-decode logits of the "cuda"
     backend against the "torch" backend on the same weights;
  6. timings — each kernel, its plain version and one PyTorch call
     computing the same function (the yardstick; never on the port's path),
     with CUDA events, at the main path's shapes: K1 k_inner at the LM
     head, the prefill and the decode gate/up, down and o projections, K1
     k_inner and a_resident (at its two candidate plans) at the tuner's
     decode class 4 x 4096 x 4096, K1 k_inner and b_resident at 4096^3
     (64, 64, 128), K2 at the LM head and the o projection (4 x 1 rows);
     K3 also at the decode gate/up and down projections (gk 24, 64); K4
     also at slab depths 84 (dbrx's k 10752 at bk 128) and 101;
  6g. the guard ladder and the obs spans (the tenth main path), phi4's
     weights still loaded: (1) the JAX guard suite's chaos scenarios
     (`guard.chaos`) on CUDA tensors through `ops` — all_faults,
     transient_recovers and amp_overflow at 256 x 192 x 320 fp32 and
     phi4's decode gate/up 4 x 3072 x 16384 bf16, amp_overflow at the
     sparse site (K9, the tuner's (32, 128) layout at d 0.1) and the
     grouped site (K5, dbrx's decode expert GEMM), cache_quarantine and
     decode_scrub (mamba2-2.7b reduced) — each under a bare trace, its
     ledger equal to the CPU's (`GPU_H100_LEDGERS`), balanced, its rung
     and last kernel blocks the expected ones (K1, K5 and K9 at the
     conservative rung), the output at phase 3's tolerance; an all-NaN
     lhs under an armed scope (no fault injected) raises NumericFault
     at the dense ladder, the dense explicit envelope and the grouped
     ladder, no rung moving; (2)
     `guarded_decode_step` at full width (b4 p128) under NaN/Inf
     injection: one scrubbed batch, finite logits, the "torch" re-run
     within phase 5's bounds of an unarmed eager step; (3) host us a
     disarmed `ops.skew_matmul(plan=)` beside the wrapper alone (2000
     calls), of a disarmed `ops.grouped_matmul` with no plan (the
     ladder, as dbrx's experts run) beside its wrapper, phi4's eager
     prefill and decode; (4) a `DecodeGraph`
     captured under `trace_scope(clock=WallClock())`: spans from the
     warm-up and capture only, replays bitwise equal to an unarmed
     graph's; (5) `python -m repro_torch.launch.trace --clock wall
     --size 4096 --skew 8 --check` in a subprocess, and the 21 fig5
     shapes (bf16) through `skewmm.matmul` under the sim clock (drift
     exactly 0: a gate) and the wall clock (the drift table: a finding);
  6h. the continuous-batching scheduler (the eleventh main path), phi4's
     weights still loaded: the bucket table for 8 live requests, prompts
     to 128 and 16 new tokens (batch buckets 1 / 2 / 4 / 8, prompt buckets
     16 / 32 / 64 / 128, max_len 144); `capture_gemm_specs` and
     `decode_gemm_specs` at full width on the meta device (no launch, no
     device memory); `build_tuned_cache` with the wall-clock measurer
     (phase 4e's iters / repeats) and `assert_covered`; a scripted stream
     of 24 requests (arrival i // 3, prompt 3 + 37 i % 126, max_new 1 +
     7 i % 16) served under plan_mode="tuned" through one decode graph
     per batch bucket (every request completes its budget, tuned_misses
     0, no ladder floor moves, one capture a bucket the slab reaches);
     the stream again, graphed and decoded eagerly (`decode_graphs=False`),
     each keeping its logits: equal results, telemetry and tuned ledger,
     every logit row bitwise equal;
     each request against a teacher-forced solo run (batch 1, fed the
     scheduler's tokens): bitwise where every planned site of the two
     calls has the same plan, within phase 5's bounds elsewhere; decode
     ms a tick per batch bucket beside `modeled_step_seconds` on
     gpu_h100; `launch.serve_bench --tiny` and `launch.trace --mode serve
     --check` in processes of their own.  Counts are zeroed just before
     and read just after the capture, the tuning and the three runs of the
     stream;
then dbrx-132b's MoE layers, after phi4's weights are freed:
  3b. K5 parity — the grouped expert GEMM against its plain version at the
     dbrx decode shapes (16 experts x 8 capacity rows, gate/up and down),
     the prefill shape (160 rows) and a shape ragged in m, k and n, with
     strided operands too; in bf16 each group bitwise equal to K1 k_inner
     on its operands;
  4b. serve dbrx-132b (the second main path) — every published width, depth
     cut to 8 of 40 layers (the whole model is ~263 GB of bf16 weights),
     seeded bf16 weights, batch 4 x prompt 128 + 16 generated tokens
     through `serve(cfg=...)`; K5 must launch 3 times per MoE layer per
     step (the prefill, the graph's warm-up step and every replay).
     Counts are zeroed just before and read just after.  Graphed against
     eager decode as in phase 4, but the last logits are held to phase
     5's bounds, not bitwise: the MoE combine is an fp32 `index_add_`
     whose order on CUDA is not fixed;
  5b. whole-path parity at full width and 2 layers — "cuda", "torch" and an
     fp32 run of the same weights, plus the share of top-k routing choices
     on which "cuda" and "torch" agree (information, not a gate);
  6b. timings — K5, its plain version and `torch.bmm` at the decode and
     prefill shapes;
then recurrentgemma-9b, after dbrx's weights are freed:
  3c. K6 / K7 parity — the RG-LRU scan (with its fp32 carry) and flash
     attention against their plain versions at the prefill shapes of the
     three served models (batch 4 x prompt 128), recurrentgemma's long
     prefill (batch 1 x 3072, window 2048), gemma2-27b's local layer
     (32 / 16 heads, S 8192, window 4096, softcap 50), a ragged length
     (257, window 40), a single row and the fp32 route; K6 also at an odd
     width (single-channel loads) and in fp32;
  4c. serve recurrentgemma-9b (the third main path) — every published
     width and all 38 layers, seeded bf16 weights, batch 4 x prompt 128 +
     16 generated tokens, then batch 1 x prompt 3072 + 4 (the window
     masks bite in K7 and the 2048-slot ring caches wrap at decode).  K6
     must launch once per recurrent layer and K7 once per attention layer
     of every prefill.  Counts are zeroed just before and read just after;
     then one prefill and one decode step are counted apart (K6 26 and 0);
     graphed against eager decode bitwise, as in phase 4;
  5c. whole-path parity at full width and 6 layers (two whole (rec, rec,
     attn) units), as in phase 5;
  6c. timings — K6 and K7, their plain versions and, for K7 where there is
     no softcap, `scaled_dot_product_attention` (a boolean band mask, built
     before timing, where the window is shorter than the sequence); K6's
     inputs are rotated over copies that together pass twice the 50 MB L2,
     so each call reads them from device memory as the bound assumes;
then mamba2-2.7b, after recurrentgemma's weights are freed:
  3d. K8 parity — the SSD chunked scan (with its fp32 state) against its
     plain version in bf16 and fp32 at mamba2's batch-4 prefill (4 x 128,
     one chunk: the readout alone), its long prompt (1 x 3000: 23 whole
     chunks and a 56-row tail, through all three kernels), a grouped
     ragged shape (16 heads, 4 groups, L 200), a strong decay whose y and
     state must stay finite, exactly two chunks, the long prompt under the
     strong decay, and batch 1 at odd sizes (P 40, S 72, chunk 48; P 3, S
     5, chunk 2); under the strong decay (fp32 inputs) K8's y is also held
     against the sequential recurrence in fp64 and must come no further
     from it than the chunked form with an fp32 torch.cumsum.  Wherever
     there is more than one chunk the chunk-state kernel and the state
     pass are each held against their plain pieces too;
  4d. serve mamba2-2.7b (the fourth main path) — every published width and
     all 64 layers, seeded bf16 weights, batch 4 x prompt 128 + 16
     generated tokens, then batch 1 x prompt 3000 + 4.  K8's readout must
     launch once per layer of every prefill, its chunk-state kernel and
     state pass once per layer of the 1 x 3000 prefill only, and none of
     them at decode.  Counts are zeroed just before and read just after;
     then one batch-4 prefill and one decode step are counted apart
     (64 / 0 / 0 and 0 / 0 / 0); graphed against eager decode bitwise, as
     in phase 4;
  5d. whole-path parity at full width and 8 layers, as in phase 5;
  6d. timings — K8, its plain version and its bound at the 3d shapes (the
     whole call: the readout alone at one chunk, all three kernels at 1 x
     3000), and the chunk-state kernel and the state pass alone at 1 x
     3000 (no single PyTorch call computes the SSD scan or its pieces);
     K8's bf16 route runs every product on the tensor cores, its fp32
     operands as two bf16 terms, so its operations bound is taken at the
     bf16 rate over the MMA terms it needs (`ssd_split_ops`);
then the measured autotuner and the block-sparse matmul:
  3e. K9 parity — the block-sparse matmul against its plain version, every
     schedule, bf16 and fp32, the bias_silu and residual epilogues,
     densities 0.05 / 0.25 / 0.5 / 1.0, blocks (32, 128), (64, 64) and
     (128, 128), a shape ragged in m, k and n and a layout with empty row
     blocks; at density 1.0 K9 must be bitwise equal to K1 at the same
     plan; then 4096^2 at every plan the tuner times;
  4e. the tune path (the fifth main path) — `repro_torch.launch.tune`'s
     `main` in process for the sparse, fig5 and decode suites at --total
     4096 (--iters 3 --repeats 5, a cache under build/), then `tune_sparse`
     with the wall-clock measurer on the JAX tuned suite's (128, 128)
     summaries at d 0.1 / 0.4 (the fail-over plan), b_resident by an
     explicit plan, and two `plan_mode="tuned"` lookups through `ops` that
     must hit the reloaded cache (2 hits, 0 misses) and match the plain
     versions.  K9 must launch for every sparse candidate timed.  Counts
     are zeroed just before and read just after; the entries (measured and
     modeled us, agreement, speedup) and the calibration fit are printed;
  6e. timings — K9 at the tuner's 4096^2 (32, 128) layouts, d 0.25 / 0.5
     and 1.0, n 4096, each schedule the planner offers and b_resident, its
     plain version, its bound and `torch.matmul` of the pre-masked dense
     A; k_inner at the (128, 128, 64) fail-over plan on a (128, 128) d 0.4
     layout; K1 at the dense planner's 4096^3 plan beside it;
  6f. the paper's Figure 5 on the H100 (the ninth main path) — the 21
     shapes of the JAX fig5 baseline (A of 4096^2 elements, its aspect
     2^-8..2^8 against n 4096; the output's aspect the same at k 4096;
     decode rows m 1 / 4 / 8 against 4096 x 32768), bf16 in and out: the
     naive, K-inner-only and skew-aware plans of the port's
     `sweep_aspect_ratios` on gpu_h100, and at the decode rows the
     model's best split-K plan (K3 + K4), each through
     `ops.skew_matmul(plan=...)` with the counts zeroed just before and
     read just after, held against the plain version at phase 3's
     tolerance and timed beside `torch.matmul` on operands rotated past
     the L2; the rows (modeled and measured us, shares of 989 TFLOP/s,
     plans) go through `bench.suite.Recorder`, pass `validate_records`,
     are written under build/fig5_h100/ by `bench.io.write_run` and read
     back equal; the spread of each curve and the modeled gpu_h100 vertex
     table are printed;
then the dense archs, each after the last one's weights are freed:
  4f. serve gemma2-27b (the sixth main path) — every published width and
     all 46 layers (54.5 GB of bf16, checked against the card's memory on
     the meta device first), batch 4 x prompt 128 + 16 generated tokens,
     then batch 1 x prompt 4608 + 4 (the 4096 window bites in K7 at
     prefill and the local layers' 4096-slot rings wrap at decode): the
     first served post-norms, softcaps 50 / 30, sqrt(d) embedding scale
     and (local, global) alternation.  K7 must launch once per layer of
     every prefill and never at decode; graphed against eager decode
     bitwise as in phase 4;
  5f. whole-path parity at full width and 4 layers (two (local, global)
     units), as in phase 5;
  4g. / 5g. granite-34b (the seventh) — every width, depth cut to 8 of 88
     layers (MQA with one kv head, the non-gated GELU MLP), batch 4 x 128
     + 16, as in phase 4f; parity at 2 layers;
  4h. / 5h. command-r-35b (the eighth) — every width and all 40 layers
     where they fit beside 12 GB (else cut, and the cut printed), batch 4
     x 128 + 16, as in phase 4f; parity at 2 layers;
then deepseek-v3-671b, after command-r's weights are freed:
  4i. serve deepseek-v3-671b (the twelfth main path) — every published
     width (MLA: q_lora 1536, kv_lora 512, qk 128 + 64, v 128, 128 heads;
     256 routed experts top-8 and one shared; ff 18432 / 2048; the MTP
     head), depth cut to 5 of 61 layers (the 3 dense and 2 MoE layers,
     54.6 GB of bf16; the whole model is ~1.3 TB), checked against the
     card's memory on the meta device first; batch 4 x prompt 128 + 16
     generated tokens through `serve(cfg=...)`.  Counts are zeroed just
     before and read just after: K5 3 launches per MoE layer per step
     (prefill, warm-up, replays), K7 one per layer of the prefill (at q / k
     width 192, v width 128) and none at decode (the absorbed form's fp32
     contractions over the latent cache).  Graphed against eager decode
     within phase 5's bounds, as in phase 4b;
  5i. whole-path parity at full width on one dense and one MoE layer, as
     in phase 5b; the fp32 run's weights are made from the bf16 ones in
     place (the two copies, ~82 GB, do not fit side by side);
  6i. K7 at MLA's prefill shape (4 x 128 heads x 128, q / k 192, v 128 as
     the model reads it, causal, scale 192^-0.5) and K5 at 256 groups
     (decode rows 8, prefill rows 24; gate / up and down) held against
     their plain versions at phase 3's tolerance, then timed beside their
     bounds and `scaled_dot_product_attention` / `torch.bmm`;
then internvl2-1b and seamless-m4t-large-v2, after deepseek's weights
are freed (both front ends stubs: seeded patch / frame embeddings):
  4j. serve internvl2-1b (the thirteenth main path) — every width and all
     24 layers (0.99 GB of bf16; a GQA group of 7 at head dim 64, the q /
     k / v bias, the tied LM head at n 151655): batch 4 x prompt 128 + 16
     through `serve(cfg=...)` with no prefix, then 256 seeded patch
     embeddings ahead of the prompt through
     `engine.prefill(prefix_embeds=)`, decoded through a DecodeGraph at
     positions offset by 256.  Counts are zeroed before both runs and
     read after both: K7 24 a prefill, none at decode; each run's graphed
     decode bitwise equal to eager; the prefill and decode bounds;
  5j. whole-path parity at full width and all 24 layers, with the prefix;
  4k. serve seamless-m4t-large-v2 (the fourteenth) — every width and all
     24 + 24 layers (2.74 GB), batch 4 with 4096 seeded frames, prompt 128
     + 16 through `serve(cfg=...)` (`serve.encdec_engine`): K7 72 a
     prefill (24 encoder self, 24 decoder self, 24 cross-attention at 128
     rows over 4096 columns), none at decode; graphed decode bitwise
     equal to eager; the encoder's share of a warm prefill's device time;
  5k. whole-path parity at full width, 2 + 2 layers and all 4096 frames;
  6j. K7 at the four attention shapes of 4j / 4k (Sq != Skv among them)
     and K1 at the odd LM heads (4 x 896 x 151655, 4 x 1024 x 256206, E^T,
     fp32 out; every dense schedule and the split-K plan checked) and
     their 1-row decode, against their plain versions at phase 3's
     tolerance, then timed beside their bounds and SDPA / torch.matmul;
then training, after seamless-m4t's weights are freed:
  4l. train phi4-mini-3.8b (the fifteenth main path) — every width, depth
     cut to 16 of 32 layers (2.225 B params; the whole model's training
     state passes 80 GB), bf16, seeded weights from the port's init: the
     `Trainer` and `DataLoader` of `launch.train.main` at the cut config,
     `SyntheticLM` batches of 2 x 512, AdamW at warmup_cosine(3e-4, 2,
     6), `loss_chunk` 128, six steps, `ckpt_every` 6 into build/ (removed
     after).  Counts are zeroed just before and read just after: the
     training path runs the "torch" rung, so no kernel may launch.  It
     prints each step's loss, grad_norm and host ms (a synchronise on each
     side), tokens/s, `train_mfu` (model_flops over the step and 989
     TFLOP/s), `max_memory_allocated` beside the state's bytes, each
     save's ms and the final save's bytes, and `train_bounds` (the
     forward and backward's operations at the bf16 rate plus the update's
     22 bytes a param).  It holds (a) every loss and grad_norm finite;
     (b) step 1's loss within 1% of the mean NLL of the same batch under
     the "cuda" backend and no grad (K1 at every projection and the LM
     head, K7 at 2 x 24 / 8 heads x 512 x 128, once a layer; counted
     apart); (c) six steps on one repeated batch at a constant lr 1e-5
     end lower than they begin (printed beside the same run at 3e-4,
     where Adam's first steps at this width raise the loss); (d) a step under the "cuda" backend
     raises the kernels' forward-only refusal; (e) `launch.train.main
     --reduced` runs on the card through its defaults (over the host
     mesh, a one-rank NCCL world it forms and takes down);
  5l. the train step's parity — phi4-mini reduced, fp32, TF32 off: one
     init on the CPU copied to the card, two steps of 2 microbatches with
     int8 error feedback on each: loss, grad_norm and lr within 1e-4, the
     plan logs equal, params, moments and residual within 1e-4 of each
     leaf's largest magnitude as tests/test_torch_train.py holds them
     against JAX (int8 ties and ill-conditioned Adam elements apart),
     step and key equal; then a `Trainer` resumed from its step-3
     checkpoint runs steps 4-6 bitwise equal to an unbroken run (losses
     and every state leaf), both under deterministic algorithms;
  4o. phi4-mini at 4l's width and depth trained at the train_4k cell's
     microbatch a device, 2 x 4096 tokens (the eighteenth main path):
     three steps of `make_train_step` on the "torch" rung, loss_chunk
     128, each unit's activations recomputed in the backward
     (`models.remat`); the bytes the backward keeps a unit, read through
     `saved_tensors_hooks`, within 10% of one hidden state (2 x 4096 x
     3072 bf16), step ms, tokens/s, peak memory and `train_bounds`; (b)
     step 1's loss within 1% of the "cuda" no-grad forward (K1, K7 once a
     layer, counted apart); counts zeroed before the steps and read after
     (no kernel may launch);
then the mesh, after the training state is freed:
  4m. (the sixteenth main path) (a) `launch.mesh.make_host_mesh()` on the
     card: a one-rank NCCL process group and its (1, 1) ("data", "model")
     DeviceMesh (no gloo, no skip); (b) dbrx-132b at full width and 8 of
     40 layers (phase 4b's weights, made again from its seed after 5l:
     4b's were cut to 2 layers for 5b), batch 4 x prompt 128: three
     prefills with the mesh as the annotation mesh, every MoE layer
     through `moe.moe_mlp_shardmap` (8 of 8 counted, K5 inside, one
     all_reduce of the fp32 output over "model" and one of aux over
     "data" a layer, counted at the call), beside three meshless ones,
     host ms each; counts zeroed before and read after the mesh prefill;
  5m. (b)'s logits bitwise equal to the meshless prefill's (both under
     deterministic algorithms: index_add_'s atomics otherwise order the
     combine's sums at random) and K5's launches equal; (c) phi4-mini at
     full width and 8 of 32 layers through `Trainer(mesh=make_host_mesh())`
     against the meshless `Trainer` from the same seed, all under
     deterministic algorithms: a world of one places nothing
     (`sharding.distributes`), so every state leaf and batch stays a
     plain tensor, step 1's metrics are equal and its params and moments
     bitwise equal; and the DTensor leg, the meshless trainer's state
     placed explicitly by `state_specs` / `shard_like` (every leaf's
     placements checked), its batches by `batch_spec`, stepped by
     `mesh_step` (DTensor dispatch, redistributes, NCCL): step 1's
     metrics within 1e-4, params and moments bitwise or within 1e-4 of
     each leaf's largest magnitude; step ms of the three; then one step
     of each at a one-row batch (1 x 512; on the DTensor leg split over
     the "data" axis of one rank, so `Replicate()`), losses equal on the
     plain legs and within 1e-4 on the DTensor leg; (d) a reduced phi4
     checkpoint of the
     meshless trainer restored
     through `restore(specs=, mesh=)` as DTensors on the card, byte for
     byte equal to the saved state;
then the launch tools, after the mesh's process group is destroyed:
  4n. (the seventeenth main path) (a) `launch.dryrun` in subprocesses on
     fake "cuda" tensors over a fake process group: phi4-mini-3.8b at
     train_4k, prefill_32k and decode_32k on "pod" (256 ranks) and
     deepseek-v3-671b at train_4k on "multipod" (512 ranks, FSDP: over
     the 60B threshold), each at 1 layer of its published widths (the
     Python loops trace every layer; `--layers 1`), and phi4's train_4k
     at 2 layers too (the bytes a device the second layer adds: a unit's
     input and its share of the state, the activations recomputed),
     trace seconds, bytes per device at that depth (the full-depth CPU
     traces are in PERF.md), the dominant term and its fraction on
     gpu_h100 and the collective counts; every cell must trace and every
     train cell count a collective; (b) `launch.costprobe` in
     subprocesses: phi4-mini at train_4k and decode_32k and mamba2-2.7b
     at long_500k on "pod", the three terms in ms and useful_ratio; (c)
     one phi4-mini block's train probe at b 2 x s 4096 on a one-rank NCCL
     mesh through the "torch" rung, traced on fake tensors and run for
     real on the card: the FLOPs of `FlopCounterMode` and of
     `roofline.measure` must be equal in both, the real run's device ms
     (CUDA events) beside the probe's compute / memory terms; the same
     block's prefill probe run through "cuda" (K1, K7; counts zeroed
     before and read after) on plain tensors, timed beside its serve
     terms; its block output and filled cache entry against the "torch"
     rung's on the same inputs (phase 5's bounds), then K7 at the probe's
     2 x 24/8 x 4096 x 128 and K1 at each plan of that run (M 8192)
     against their plain versions (phase 3's tolerance);
then the port's examples, each run by the interpreter from its own file:
  4p. (the nineteenth main path) `examples/skewmm_planner_demo_torch.py`
     as written (K1 at 96 x 1024 x 4096 fp32 and with the fused
     gelu / scale / bias / residual epilogue, each within phase 3's fp32
     tolerance of the plain oracle, its CUDA-event time beside its
     gpu_h100 modeled time), `examples/serve_decode_torch.py` for
     gemma2-27b and mamba2-2.7b (reduced, b4 p64 g48: every sampled id in
     the vocabulary, every logit finite, K1 and K7 / K8 launched, decode
     tokens a second), `examples/quickstart_torch.py` (20 steps of reduced
     gemma2 over the host mesh, a one-rank NCCL world: finite losses) and
     `examples/train_tiny_lm_torch.py --steps 40` (12 x 768, 100.7M
     params, fp32, over the host mesh as the example trains by default:
     finite losses, the last logged below the first, ms a step and tokens
     a second); one process each, the demo, the serves and
     the tiny LM alone in turn, then the quickstart (it reports no time);
     each exit code checked; each zeroes the launch counts at its start
     and prints them in the JSON summary on its last line, and their sum
     joins the kernels line; each example's wall seconds printed; while
     the quickstart runs, the serves' kernels held at the shapes they ran:
     each served model (reduced, seed 0, the example's prompts) prefilled
     and stepped once more in this process through "cuda", the first call
     of each signature to K1, K7 and K8 recorded, its prefill and decode
     logits against the "torch" rung's (phase 5's bounds), then each
     recorded call against its plain version (phase 3's tolerance; K8's
     chunk-state kernel and state pass too), after the examples' counts
     were read;
  7. the served decode ms per token, graphed and eager, of every run; the
     `kernels` JSON line (K1-K9, K8's three kernels apart, launches summed
     over the nineteen main paths; then phase 6i's five deepseek rows and
     phase 6j's rows, each with its "shape" and its paths' launches), then
     the device line.
Every phase from 3 on runs between two `guard_disarmed` checks: no ladder
floor above 0, no fault scope or trace armed, and no fallbacks /
plans_rejected / scrubbed_batches / faults_* / obs_* counter (a trip
latches for the process, and the bottom rung is the plain oracle).
Phi4's and dbrx's prefills reach K7 too (phases 4, 4b).  With --profile,
each served model also profiles one batch-4 prefill, one eager decode
step and one replay of a decode graph.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16 = 989e12          # H100 SXM data sheet, dense
PEAK_FP32 = 67e12           # the same, fp32 outside the tensor cores
HBM_BW = 3.35e12
L2_BYTES = 50e6
# fp32 operations per element of the RG-LRU scan, counting exp, log1p,
# sqrt and a division as one each: two sigmoids (3 each), log a (2), a and
# exp(2 log a) (2), the clamped sqrt (3), the gated input and h (4).
RGLRU_OPS = 17

# Kernel tolerances, against the plain version on the same inputs:
#  - bf16 output: two bf16 ulps at the largest magnitude of the plain
#    result; both versions sum in fp32 in a different order and round once,
#    so a value near a rounding boundary may land one ulp apart;
#  - fp32 output: 1e-4 of the largest magnitude; fp32 sums over k <= 8192
#    in another order (~sqrt(k) * 2**-24 of the sum of |terms|).
FP32_TOL = 1e-4


def tolerance(out_dtype: str, scale: float) -> float:
    if out_dtype == "bfloat16":
        return 2.0 * 2.0 ** (math.floor(math.log2(scale)) - 7)
    return FP32_TOL * scale
# Whole path, bf16, 32 layers: each backend rounds every activation to
# bf16 (2**-9 relative) after fp32 sums taken in its own order, and the
# two roundings part at about one element in a few hundred per op; with
# ~10 rounded ops a layer the logits drift apart like a random walk,
# ~sqrt(32 * 10) * 2**-9 ~ 3.5% of their magnitude.  So "cuda" and
# "torch" logits must agree to 10% of the largest and 5% of the mean
# magnitude, and the sharp check: the "cuda" path may be no further (in
# mean) from an fp32 run of the same weights than 1.25x the "torch" path.
PATH_TOL_MAX, PATH_TOL_MEAN, PATH_TOL_RATIO = 0.10, 0.05, 1.25

KERNELS = {
    # name: (source, replaces)
    "skew_matmul_k_inner": (
        "src/repro_torch/csrc/skew_matmul.cu",
        "src/repro/kernels/skew_matmul.py:186"),
    "skew_matmul_a_resident": (
        "src/repro_torch/csrc/skew_matmul.cu",
        "src/repro/kernels/skew_matmul.py:230"),
    "skew_matmul_b_resident": (
        "src/repro_torch/csrc/skew_matmul.cu",
        "src/repro/kernels/skew_matmul.py:230"),
    "skew_matmul_batched": (
        "src/repro_torch/csrc/skew_matmul.cu",
        "src/repro/kernels/skew_matmul.py:279"),
    "gemv_splitk_partial": (
        "src/repro_torch/csrc/gemv_splitk.cu",
        "src/repro/kernels/gemv_splitk.py:104"),
    "gemv_splitk_reduce": (
        "src/repro_torch/csrc/gemv_splitk.cu",
        "src/repro/kernels/gemv_splitk.py:132"),
    "grouped_matmul": (
        "src/repro_torch/csrc/grouped_matmul.cu",
        "src/repro/sparse/kernels.py:330"),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:112"),
    "rglru_scan": (
        "src/repro_torch/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan.py:80"),
    "ssd_scan": (
        "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:96"),
    "ssd_chunk_state": (
        "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:96"),
    "ssd_state_pass": (
        "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:96"),
    "block_sparse_matmul_k_inner": (
        "src/repro_torch/csrc/block_sparse_k_inner.cu",
        "src/repro/sparse/kernels.py:223"),
    "block_sparse_matmul_a_resident": (
        "src/repro_torch/csrc/block_sparse_matmul.cu",
        "src/repro/sparse/kernels.py:271"),
    "block_sparse_matmul_b_resident": (
        "src/repro_torch/csrc/block_sparse_b_resident.cu",
        "src/repro/sparse/kernels.py:271"),
}
# The dense kernels and K7 run on phi4's main path, K5 on dbrx's, K6 (and
# K7) on recurrentgemma's, K8's three kernels on mamba2's, K9 on the
# tuner's.
BSR_KERNELS = tuple(n for n in KERNELS if n.startswith("block_sparse"))
SSD_KERNELS = ("ssd_scan", "ssd_chunk_state", "ssd_state_pass")
PHI4_KERNELS = tuple(n for n in KERNELS if n not in (
    "grouped_matmul", "rglru_scan") + SSD_KERNELS + BSR_KERNELS)
# dbrx-132b: 40 layers of 6.52 GB (bf16) do not fit one 80 GB card; the
# serve keeps every width and cuts depth to 8 layers (54.6 GB), the
# whole-path parity to 2 (an fp32 copy fits beside the bf16 one).
DBRX_LAYERS, DBRX_PARITY_LAYERS = 8, 2
# recurrentgemma-9b: all 38 layers (~17 GB of bf16) fit; the whole-path
# parity keeps 2 of its 12 whole (rec, rec, attn_local) units.
HYBRID_PARITY_UNITS = 2
# mamba2-2.7b: all 64 layers (5.40 GB of bf16) fit; the whole-path parity
# keeps 8 of them.
SSM_PARITY_LAYERS = 8
# The dense archs after the tuner.  gemma2-27b: all 46 layers (54.5 GB of
# bf16) fit; its parity keeps two (local, global) units.  granite-34b:
# every width, depth cut to 8 of 88 layers (the whole model is ~68 GB);
# MQA and the non-gated GELU MLP at 6144 x 24576 do not change with depth.
# command-r-35b: all 40 layers (60.6 GB) where they fit beside
# DENSE_RESERVE bytes for caches, activations and the decode graph, else
# cut (and the cut printed).  Their parity keeps 2 layers.
GEMMA2_PARITY_UNITS = 2
GRANITE_LAYERS = 8
DENSE_PARITY_LAYERS = 2
DENSE_RESERVE = 12e9
# deepseek-v3-671b: 61 layers (3 dense, then 58 MoE of 256 experts) are
# ~1.3 TB of bf16 weights.  The serve keeps every width and cuts depth to
# 5 layers (the 3 dense ones and 2 MoE ones, 54.6 GB); the whole-path
# parity to one dense and one MoE layer, its fp32 run's weights made from
# the bf16 ones in place (both copies, ~82 GB, do not fit side by side).
DEEPSEEK_LAYERS, DEEPSEEK_PARITY = 5, (2, 1)   # (n_layers, first_k_dense)
# internvl2-1b: all 24 layers (0.99 GB of bf16) fit; its parity runs whole,
# with the 256-row prefix (drawn from its own seed).  seamless-m4t-large-v2:
# all 24 + 24 layers (2.74 GB) fit; its parity keeps 2 + 2 of them and all
# 4096 frames, so K7's Sq != Skv route is on its path.
VLM_PREFIX_SEED = 12
ENCDEC_PARITY_LAYERS = 2
# Training: phi4-mini at every width and 16 of its 32 layers (2.225 B
# params: bf16 params 4.45 GB, grads 4.45, fp32 moments 17.8, the torch
# rung's fp32 weight copies ~6.4 and the update's second copy ~22, ~55 GB
# at the peak; the whole model's state would pass 80 GB), batch 2 x 512,
# loss chunks of 128 (511 positions pad to four), six steps.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 16, 2, 512
TRAIN_CHUNK, TRAIN_STEPS = 128, 6
# Phase 4o: the same model trained at the train_4k cell's microbatch a
# device (128k tokens over 16 data ranks: 2 x 4096), three steps, with
# the activations recomputed a unit in the backward (`models.remat`);
# without the recompute 16 layers of 4096^2 fp32 scores would not fit.
TRAIN_LONG_SEQ, TRAIN_LONG_STEPS = 4096, 3
# What the backward may keep in all, parameters aside, in hidden states
# beyond one a unit: outside the units it keeps the final norm's input
# and its fp32 working copies and the loss's normed input (five hidden
# states on the card), where one loss chunk's fp32 logits kept (2 x 128 x
# 200064) would add four, and a unit run without its checkpoint keeps
# its blocks' activations, scores included, many times more.
TRAIN_LONG_OUTSIDE = 8
# Phase 4l (c)'s constant lr on one repeated batch.  At this width the
# loss rises at 3e-4 before it falls (Adam's first steps are sign-like, so
# a 3072 x 3072 matrix moves by lr * 3072 in its top direction); the fall
# is held at 1e-5, and the 3e-4 run printed beside it.
TRAIN_DESCENT_LR = 1e-5
# Phase 4m (c): phi4-mini's trainer on the mesh and without it, at every
# width and 8 of 32 layers (1.4 B params, ~14 GB of state each; the two
# trainers are made one after the other), three steps each.
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 8, 3
# serve()'s sampling in every run here; the eager decode that phases 4-4h
# hold the graphed one against draws from the same seeded sampler.
SERVE_SEED, SERVE_TEMPERATURE = 0, 0.8


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ----------------------------------------------------------------- phase 1
def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------- phase 2
def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    say(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        log = build.build_log(name).splitlines()
        regs = [ln.strip() for ln in log if "registers" in ln]
        say(f"build {name}: {len(regs)} kernels, e.g. {regs[:1]}")
        if name == "flash_attention":
            # K7's kernels one by one: the bf16 route keeps S, P and O in
            # registers, so its count (and no spill) is the design's
            for ln in log:
                if "Compiling entry" in ln or "registers" in ln \
                        or "spill" in ln:
                    say(f"build {name}:   {ln.strip()}")


# ----------------------------------------------------------------- helpers
def depth(cfg) -> str:
    """"L layers", or "E + L layers" for an encoder-decoder."""
    enc = f"{cfg.enc_layers} + " if cfg.enc_layers else ""
    return f"{enc}{cfg.n_layers} layers"


def rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, that divided by max |want|)."""
    diff = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-30)
    return diff, diff / scale


# Cycles of `torch.cuda._sleep` queued before a timed run (~5 ms at the
# H100's clocks): the host enqueues the timed calls while the card sleeps,
# so a kernel shorter than its wrapper's host time is timed on the device,
# not at the rate the host launches it.
SLEEP_CYCLES = 10_000_000


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernel(torch, errs: dict, name, got, want, out_dtype, tag) -> None:
    """A kernel's output against its plain version's, within `tolerance`;
    records the largest error per kernel in `errs`."""
    diff, rel = rel_err(torch, got, want)
    scale = want.float().abs().max().item()
    tol = tolerance(str(out_dtype).split(".")[-1], scale)
    ok = diff <= tol
    say(f"parity {name:24s} {tag:44s} max_abs_err={diff:.3e} "
        f"rel={rel:.2e} tol={tol:.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version at {tag}")
    errs[name] = max(errs.get(name, 0.0), diff)


def timing_row(torch, counts, errs, name, kernel, plain, library, nbytes,
               flops, shape, peak: float = PEAK_BF16) -> dict:
    """Time a kernel, its plain version and the PyTorch yardstick (CUDA
    events) beside the bound from `nbytes` and `flops` (at `peak`)."""
    ms = time_ms(torch, kernel)
    plain_ms = time_ms(torch, plain, iters=5, warmup=1)
    lib_ms = time_ms(torch, library) if library else None
    bms, by = bound_ms(nbytes, flops, peak)
    src, rep = KERNELS[name]
    say(f"time {name:24s} {shape:28s} {ms:.4f} ms  plain {plain_ms:.4f}"
        f"  torch {lib_ms if lib_ms is None else round(lib_ms, 4)}  "
        f"bound {bms:.4f} ({by})")
    return {"name": name, "route": "cuda", "source": src,
            "replaces": rep, "launches": int(counts.get(name, 0)),
            "max_abs_err": errs.get(name), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "shape": shape}


# ----------------------------------------------------------------- phase 3
def phase_parity(torch, cfg) -> dict:
    """Every kernel against its plain version at phi4-mini shapes."""
    from repro_torch.core import epilogue as ep_mod
    from repro_torch.kernels import gemv_splitk as gk
    from repro_torch.kernels import skew_matmul as mm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kvd = cfg.n_kv_heads * cfg.head_dim
    errs: dict = {}

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    check = functools.partial(check_kernel, torch, errs)

    blocks = (64, 64, 128)
    silu = ep_mod.normalize_spec("silu")
    resid = ep_mod.normalize_spec("residual")
    bias_gelu = ep_mod.normalize_spec("bias_gelu")
    scale_spec = (("scale", 0.5),)
    for dtype in (torch.bfloat16, torch.float32):
        emb = rnd((v, d), dtype, 0.02)
        dn = str(dtype).split(".")[-1]
        cases = [  # (m, k, n, B view, epilogue, out dtype)
            (512, d, d, None, (), dtype),
            (512, d, kvd, None, (), dtype),
            (512, d, f, None, silu, dtype),
            (512, f, d, None, resid, dtype),
            (512, d, f, None, bias_gelu, dtype),
            (4, d, d, None, scale_spec, dtype),
            (4, d, f, None, silu, dtype),
            (4, f, d, None, resid, dtype),
            (4, d, v, "embT", (), torch.float32),
        ]
        for m, k, n, bview, spec, odt in cases:
            a = rnd((m, k), dtype)
            b = emb.T if bview == "embT" else rnd((k, n), dtype, k ** -0.5)
            bias = rnd((n,), dtype) if "bias" in dict(spec) else None
            res = rnd((m, n), dtype) if "residual" in dict(spec) else None
            want = mm.skew_matmul_plain(a, b, bias, res, bk=blocks[1],
                                        epilogue=spec, out_dtype=odt)
            scheds = ["k_inner"]
            if m == 4 and n == v:
                scheds += ["a_resident", "b_resident"]
            if m == 512 and n == kvd:
                scheds += ["a_resident", "b_resident"]
            for sched in scheds:
                got = mm.skew_matmul_cuda(a, b, bias, res, bm=blocks[0],
                                          bk=blocks[1], bn=blocks[2],
                                          schedule=sched, epilogue=spec,
                                          out_dtype=odt)
                torch.cuda.synchronize()
                check(f"skew_matmul_{sched}", got, want, odt,
                      f"{dn} {m}x{k}x{n} {[t for t, _ in spec]}")
            if m == 4 and n != v:
                # the batched grid: batch 4 x m = 1 (decode rows) and
                # batch 4 x m = 128 (prefill rows)
                for nb, mm_ in ((4, 1), (4, 128)):
                    a3 = rnd((nb, mm_, k), dtype)
                    r3 = rnd((nb, mm_, n), dtype) if res is not None else None
                    got = mm.skew_matmul_batched_cuda(
                        a3, b, None, r3, bm=64, bk=64, bn=128, epilogue=spec,
                        out_dtype=odt)
                    want3 = mm.skew_matmul_batched_plain(
                        a3, b, None, r3, bk=64, epilogue=spec, out_dtype=odt)
                    check("skew_matmul_batched", got, want3, odt,
                          f"{dn} {nb}x{mm_}x{k}x{n} {[t for t, _ in spec]}")
                    # K2 stacks the slices' rows: each equals K1 on its own
                    for i in range(nb):
                        k1 = mm.skew_matmul_cuda(
                            a3[i], b, None, None if r3 is None else r3[i],
                            bm=64, bk=64, bn=128, epilogue=spec,
                            out_dtype=odt)
                        torch.cuda.synchronize()
                        if not torch.equal(got[i], k1):
                            fail(f"K2 slice {i} is not bitwise equal to K1 "
                                 f"({dn} {nb}x{mm_}x{k}x{n})")
            if m == 4:
                # split-K at the planner's best split-K blocks for the shape
                sk = splitk_plan(m, k, n, a.element_size())
                slab = gk.gemv_splitk_partial_cuda(a, b, bm=sk.bm, bk=sk.bk,
                                                   bn=sk.bn)
                slab_want = gk.gemv_splitk_partial_plain(a, b, bk=sk.bk)
                torch.cuda.synchronize()
                check("gemv_splitk_partial", slab, slab_want, torch.float32,
                      f"{dn} {m}x{k}x{n} blocks {(sk.bm, sk.bk, sk.bn)}")
                if dtype == torch.bfloat16:
                    k3_planes_equal_k1(torch, mm, slab, a, b, sk.bk,
                                       f"{m}x{k}x{n}")
                got = gk.gemv_splitk_reduce_cuda(slab_want, bias, res,
                                                 epilogue=spec, out_dtype=odt)
                want = gk.gemv_splitk_reduce_plain(slab_want, bias, res,
                                                   epilogue=spec,
                                                   out_dtype=odt)
                check("gemv_splitk_reduce", got, want, odt,
                      f"{dn} gk={slab.shape[0]} {m}x{n} "
                      f"{[t for t, _ in spec]}")
        del emb
        torch.cuda.empty_cache()

    # a_resident at the tuner's decode classes (m 1 / 4 / 8 against
    # 4096^2, its two candidate plans; 8-row tiles, up to 8 column tiles a
    # CTA) and at the LM head's E^T for m 1 / 8 (phase 3's cases hold m 4)
    t = TUNE_TOTAL
    w = rnd((t, t), torch.bfloat16, t ** -0.5)
    emb = rnd((v, d), torch.bfloat16, 0.02)
    for m in (1, 4, 8):
        a = rnd((m, t), torch.bfloat16)
        for blocks in ((64, 128, 64), (64, 64, 64)):
            got = mm.skew_matmul_cuda(a, w, bm=blocks[0], bk=blocks[1],
                                      bn=blocks[2], schedule="a_resident",
                                      out_dtype=torch.bfloat16)
            want = mm.skew_matmul_plain(a, w, bk=blocks[1],
                                        out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            check("skew_matmul_a_resident", got, want, torch.bfloat16,
                  f"bf16 decode {m}x{t}x{t} blocks {blocks}")
        if m != 4:
            a = rnd((m, d), torch.bfloat16)
            want = mm.skew_matmul_plain(a, emb.T, bk=64,
                                        out_dtype=torch.float32)
            for sched in ("a_resident", "b_resident"):
                got = mm.skew_matmul_cuda(a, emb.T, bm=64, bk=64, bn=128,
                                          schedule=sched,
                                          out_dtype=torch.float32)
                torch.cuda.synchronize()
                check(f"skew_matmul_{sched}", got, want, torch.float32,
                      f"bf16 {m}x{d}x{v} E^T")
    del w, emb
    torch.cuda.empty_cache()

    # K3 is K1's k_inner with the split walk: each plane equals K1 on its
    # slice pair bit for bit (decode rows 1 - 64, E^T and row-major B, a
    # ragged last slice), and one split is K1's whole product
    emb = rnd((v, d), torch.bfloat16, 0.02)
    for m in (1, 4, 8, 16, 64):
        for k, n, bk, bview in ((d, v, 128, "embT"), (1000, 2050, 192, None),
                                (f, d, 128, None)):
            a = rnd((m, k), torch.bfloat16)
            b = emb.T if bview else rnd((k, n), torch.bfloat16, k ** -0.5)
            slab = gk.gemv_splitk_partial_cuda(a, b, bm=64, bk=bk, bn=128)
            k3_planes_equal_k1(torch, mm, slab, a, b, bk,
                               f"{m}x{k}x{n} bk {bk}{' E^T' if bview else ''}")
    a = rnd((4, 256), torch.bfloat16)
    slab = gk.gemv_splitk_partial_cuda(a, emb.T[:256], bm=64, bk=256, bn=128)
    k3_planes_equal_k1(torch, mm, slab, a, emb.T[:256], 256, "gk 1 E^T")
    del emb, slab
    torch.cuda.empty_cache()

    # split-K bitwise stability across split counts (integer inputs)
    a = torch.randint(-8, 8, (4, d), generator=gen, device=dev).float()
    b = torch.randint(-8, 8, (d, 2048), generator=gen, device=dev).float()
    want = (a.double() @ b.double()).float()
    for bk in (64, 128, 192, 256, 384):
        got = gk.gemv_splitk(a, b, bm=64, bk=bk, bn=64)
        if not torch.equal(got, want):
            fail(f"split-K not bitwise stable at bk={bk}")
    say("parity split-K bitwise equal to the exact product across bk "
        "64..384 (gk 48..8)")

    # K4 folds in `tree_sum`'s order: with no epilogue it equals the plain
    # reduce bit for bit on any fp32 slab, at every depth (gk 2000 stages
    # a 28-wide strip; 14600 folds two levels through a scratch first)
    for gkn, m, n in K4_BITWISE_SLABS:
        slab = torch.randn((gkn, m, n), generator=gen, device=dev)
        for odt in (torch.float32, torch.bfloat16):
            got = gk.gemv_splitk_reduce_cuda(slab, out_dtype=odt)
            want = gk.gemv_splitk_reduce_plain(slab, out_dtype=odt)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K4 is not bitwise equal to the plain tree_sum reduce "
                     f"at slab {(gkn, m, n)} -> {odt}")
        del slab
    say(f"parity K4 bitwise equal to the plain reduce at slabs "
        f"{[s[0] for s in K4_BITWISE_SLABS]} (fp32 and bf16 out)")
    return errs


def k3_planes_equal_k1(torch, mm, slab, a, b, bk: int, tag: str) -> None:
    """K3's plane s against K1 k_inner on the slice pair A[:, s bk:(s + 1)
    bk] @ B[s bk:(s + 1) bk], bit for bit (the same chain over the slice)."""
    for s in range(slab.shape[0]):
        k1 = mm.skew_matmul_cuda(a[:, s * bk:(s + 1) * bk],
                                 b[s * bk:(s + 1) * bk], bm=64, bk=bk,
                                 bn=128, out_dtype=torch.float32)
        torch.cuda.synchronize()
        if not torch.equal(slab[s], k1):
            fail(f"K3 plane {s} is not bitwise equal to K1 on its slice "
                 f"({tag})")
    say(f"parity K3 bitwise equal to K1 k_inner on each of {slab.shape[0]} "
        f"slices ({tag})")


# K4's bitwise check (phase 3): the phi4 LM-head slab, dbrx's down
# projection (k 10752 at bk 128: gk 84), an odd depth above 100, a depth
# past the 1816 that keeps a 32-wide strip, one past the 14528 at which
# not even 4 columns fit, and m * n not a multiple of 4 (scalar staging).
K4_BITWISE_SLABS = ((24, 4, 200064), (84, 4, 6144), (101, 4, 200064),
                    (2000, 4, 8192), (14600, 1, 24), (7, 3, 333))


# ----------------------------------------------------------------- phase 4
def serve_bounds(cfg, params_bytes: int, batch: int, prompt: int,
                 kv_bytes: int) -> tuple[float, float]:
    """(prefill bound ms, decode bound ms per token) from bytes and FLOPs."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    layer_w = d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * f
    toks = batch * prompt
    attn = 2 * 2 * batch * h * hd * prompt * prompt / 2     # causal QK + PV
    pre_flops = 2 * toks * layer_w * cfg.n_layers \
        + attn * cfg.n_layers + 2 * batch * d * v
    pre = max(pre_flops / PEAK_BF16, params_bytes / HBM_BW)
    dec_flops = 2 * batch * (layer_w * cfg.n_layers + d * v)
    dec = max(dec_flops / PEAK_BF16, (params_bytes + kv_bytes) / HBM_BW)
    return pre * 1e3, dec * 1e3


def phase_serve(torch, cfg):
    from repro_torch.core import skewmm
    from repro_torch.core.costmodel import BlockPlan
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model, param_bytes
    from repro_torch.serve import kvcache

    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init(0)
    torch.cuda.synchronize()
    pbytes = param_bytes(params)
    say(f"init: {pbytes / 1e9:.3f} GB of bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")

    batch, prompt, gen = 4, 128, 16
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # ---- the main path: counts zeroed above, read after the last drive.
    with skewmm.plan_capture() as log:
        res = serve_mod.serve(cfg=cfg, params=params, batch=batch,
                              prompt_len=prompt, gen=gen, seed=SERVE_SEED,
                              temperature=SERVE_TEMPERATURE)
    peak = torch.cuda.max_memory_allocated()
    if not res["logits_finite"]:
        fail("serve produced non-finite logits")
    kv = kvcache.cache_bytes(kvcache.init_cache(cfg, batch, prompt + gen,
                                                "meta"))
    pre_b, dec_b = serve_bounds(cfg, pbytes, batch, prompt, kv)
    say(f"serve b{batch} p{prompt} g{gen}: prefill "
        f"{res['prefill_s'] * 1e3:.1f} ms (bound {pre_b:.2f} ms), decode "
        f"{res['decode_s_per_token'] * 1e3:.2f} ms/token (bound "
        f"{dec_b:.2f} ms), peak memory {peak / 2**30:.2f} GiB, KV cache "
        f"{kv / 1e6:.1f} MB")
    seen = {}
    for c in log:
        dd = c.dims
        seen.setdefault((dd.m, dd.k, dd.n, dd.batch), c)
    for key, c in seen.items():
        say(f"plan {key}: {c.explain()}")
    scheds = {(c.plan.schedule, c.plan.batch_grid) for c in log}
    out = {"serve": res, "peak": peak, "bounds": (pre_b, dec_b),
           "params": params, "params_bytes": pbytes, "kv_bytes": kv}
    if not any(s == "splitk" or bg for s, bg in scheds):
        say("the gpu_h100 planner picked no split-K and no batched-grid "
            "plan at batch 4: serving once more at batch 1")
        res1 = serve_mod.serve(cfg=cfg, params=params, batch=1,
                               prompt_len=prompt, gen=4, seed=SERVE_SEED,
                               temperature=SERVE_TEMPERATURE)
        if not res1["logits_finite"]:
            fail("batch-1 serve produced non-finite logits")
        out["serve_b1"] = res1
        say(f"serve b1 p{prompt} g4: prefill {res1['prefill_s'] * 1e3:.1f} "
            f"ms, decode {res1['decode_s_per_token'] * 1e3:.2f} ms/token")

    # Kernels the planner still did not pick: explicit plans through ops at
    # the LM-head shape (the last hidden rows against the tied embedding).
    gen_ = torch.Generator(device="cuda")
    gen_.manual_seed(7)
    emb_t = params["embed"].T
    h = torch.randn((batch, cfg.d_model), generator=gen_,
                    device="cuda").to(torch.bfloat16)
    explicit = {
        "skew_matmul_a_resident": lambda: ops.skew_matmul(
            h, emb_t, plan=BlockPlan(64, 64, 128, "a_resident"),
            out_dtype=torch.float32),
        "skew_matmul_b_resident": lambda: ops.skew_matmul(
            h, emb_t, plan=BlockPlan(64, 64, 128, "b_resident"),
            out_dtype=torch.float32),
        "skew_matmul_batched": lambda: ops.skew_matmul_batched(
            h[:, None, :], emb_t,
            plan=BlockPlan(64, 64, 128, batch_grid=True),
            out_dtype=torch.float32),
        "gemv_splitk_partial": lambda: ops.skew_matmul(
            h, emb_t, plan=lm_head_splitk_plan(cfg),
            out_dtype=torch.float32),
    }
    explicit["gemv_splitk_reduce"] = explicit["gemv_splitk_partial"]
    for name, fn in explicit.items():
        if ops.launch_counts()[name] == 0:
            logits = fn()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(logits).all()):
                fail(f"{name}: non-finite LM-head logits")
            say(f"drove {name} through ops with an explicit plan at the "
                f"LM-head shape {batch}x{cfg.d_model}x{cfg.vocab_size}")
    counts = ops.launch_counts()
    # ---- end of the main path.
    say(f"launch counts on the main path: {counts}")
    for name in PHI4_KERNELS:
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")
    out["counts"] = counts
    out["graph"] = [graph_vs_eager(torch, cfg, params, res, batch, prompt,
                                   gen, bitwise=True)]
    if "serve_b1" in out:
        out["graph"].append(graph_vs_eager(torch, cfg, params, res1, 1,
                                           prompt, 4, bitwise=True))
    return out


def splitk_plan(m: int, k: int, n: int, dtype_bytes: int):
    """The planner's best split-K plan for the shape (gpu_h100 counts the
    strip K4 stages for pass 2, so one fits at phi4's decode shapes), or
    (64, 128, 128) when none fits the budget."""
    from repro_torch.core import hw, planner
    from repro_torch.core.costmodel import BlockPlan, MatmulDims
    chip = hw.get_chip("gpu_h100")
    dims = MatmulDims(m=m, k=k, n=n, dtype_bytes=dtype_bytes)
    best = planner._search_gemv(dims, chip, int(0.45 * chip.vmem_bytes))
    return best.plan if best is not None else BlockPlan(64, 128, 128,
                                                        "splitk")


def lm_head_splitk_plan(cfg):
    return splitk_plan(4, cfg.d_model, cfg.vocab_size, 2)


def graph_vs_eager(torch, cfg, params, res, batch: int, prompt: int,
                   gen: int, bitwise: bool, prefix=None) -> dict:
    """`serve()` decoded through its CUDA graph; decode the same prompt once
    more with an eager loop over `engine.decode_step`: the same prefill,
    the served tokens fed back step by step, and the same seeded sampler
    choosing a token from each step's logits.  An encoder-decoder takes
    serve()'s seeded frames and `encdec_engine`; a VLM run served with a
    `prefix` (`serve_prefix`) is prefilled with it, its positions offset
    by its length.

    bitwise: the eager choices and the first and last decode logits must
    equal the graphed run's bit for bit (the same kernels in the same
    order).  Otherwise (dbrx, whose MoE combine is an fp32 `index_add_`
    in no fixed order on CUDA) the last logits are held to phase 5's
    bounds.  Either way the graph's launches per step must equal those of
    one eager step.  Prints and returns both decode ms per token (host
    clock, each loop ending in a synchronise)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve import encdec_engine, engine

    rng = np.random.default_rng(SERVE_SEED)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, prompt)),
                        dtype=torch.long, device="cuda")
    sampler = torch.Generator(device="cuda")
    sampler.manual_seed(SERVE_SEED + 1)
    off = 0 if prefix is None else prefix.shape[1]
    step_fn = engine.decode_step
    if cfg.family == "encdec":
        frames = torch.tensor(
            rng.normal(size=(batch, cfg.frontend_len, cfg.d_model)),
            dtype=torch.float32, device="cuda")
        cache, logits = encdec_engine.prefill(params, cfg, frames, toks,
                                              max_len=prompt + gen)
        step_fn = encdec_engine.decode_step
    else:
        cache, logits = engine.prefill(params, cfg, toks,
                                       max_len=off + prompt + gen,
                                       prefix_embeds=prefix)
    served = res["tokens"].to("cuda")
    chosen = [torch.argmax(logits, -1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(gen):
        if i == 0:
            ops.reset_launch_counts()
        logits, _ = step_fn(params, cfg, cache, served[:, i],
                            off + prompt + i)
        if i == 0:
            step_counts = {k: v for k, v in ops.launch_counts().items() if v}
            first = logits
        probs = torch.softmax(logits / SERVE_TEMPERATURE, dim=-1)
        chosen.append(torch.multinomial(probs, 1, generator=sampler)[:, 0])
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / gen * 1e3
    graph_ms = res["decode_s_per_token"] * 1e3
    same_tokens = torch.equal(torch.stack(chosen[:gen], 1).cpu(),
                              res["tokens"])
    last = res["last_decode_logits"]
    diff = (logits - last).abs()
    rel_max = diff.max().item() / last.abs().max().item()
    rel_mean = diff.mean().item() / last.abs().mean().item()
    tag = f"{cfg.name} ({depth(cfg)}) b{batch} p{prompt} g{gen}"
    if off:
        tag += f" prefix {off}"
    say(f"graph~eager {tag}: decode {graph_ms:.2f} ms/token graphed, "
        f"{eager_ms:.2f} eager (warm-up and capture "
        f"{res['decode_setup_s'] * 1e3:.1f} ms); tokens equal "
        f"{same_tokens}, last logits max|diff| {diff.max().item():.3e} "
        f"(rel max {rel_max:.3e}, mean {rel_mean:.3e}); launches a step "
        f"{res['decode_launches_per_step']}")
    if res["decode_launches_per_step"] != step_counts:
        fail(f"{tag}: the graph replays {res['decode_launches_per_step']} "
             f"launches a step, an eager step {step_counts}")
    if bitwise:
        if not (same_tokens and torch.equal(first, res["first_decode_logits"])
                and torch.equal(logits, last)):
            fail(f"{tag}: graphed decode is not bitwise equal to eager")
    elif rel_max > PATH_TOL_MAX or rel_mean > PATH_TOL_MEAN:
        fail(f"{tag}: graphed and eager decode logits disagree past phase "
             f"5's bounds")
    return {"tag": tag, "graph_ms": graph_ms, "eager_ms": eager_ms,
            "tokens_equal": same_tokens, "max_diff": diff.max().item()}


# ----------------------------------------------------------------- phase 5
def _float_tree(tree):
    if isinstance(tree, dict):
        return {k: _float_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float_tree(v) for v in tree]
    return tree.float()


def _float_in_place(tree):
    """Every tensor of a parameter tree turned to fp32 in place: each bf16
    tensor is freed as its copy is made, where nothing else holds it."""
    # walk the keys, not a snapshot of the values: a snapshot would hold
    # every bf16 tensor of the dict until the walk ends
    for key in list(tree.keys() if isinstance(tree, dict)
                    else range(len(tree))):
        if isinstance(tree[key], (dict, list)):
            _float_in_place(tree[key])
        else:
            tree[key] = tree[key].float()
    return tree


def phase_path_parity(torch, cfg, params, consume: bool = False,
                      routed_rows: bool = False, prefix=None,
                      frames=None) -> dict:
    """Prefill and first-decode logits: the "cuda" backend against the
    "torch" backend on the same bf16 weights, and both against an fp32 run
    of the same weights (the "torch" backend on fp32 copies; with
    `consume`, `params` itself turned to fp32 in place after the bf16
    runs, for a model whose two copies do not fit the card side by side).
    For an MoE model, also the share of top-k routing choices (every
    layer, every token, prefill and decode) on which "cuda" and "torch"
    agree.

    `routed_rows` (a model whose one MoE layer is its last): the fp32
    ratio is taken over the rows whose own token chose the same experts
    and kept the same copies in all three runs (`routed_alike`), and at
    least one row must be left; the cuda~torch bounds hold over every
    row.  A row's logits then depend on no other token's routing, and a
    row where one run flips a near-tied choice compares two different
    expert sets: with 256 experts top-8 that happens to a few of 512
    tokens, and on 4 rows it swings the ratio either way (0.51-2.02 over
    six weight / prompt draws on an H100 80GB HBM3 at 700 W, the torch
    path as often the worse; 0.99-1.03 on the dense layers alone).

    A VLM takes `prefix` (B, F, D) ahead of the prompt (decode at 128 +
    F); an encoder-decoder `frames` (B, F, D) through `encdec_engine`."""
    import numpy as np
    from repro_torch.core.config import mm_config
    from repro_torch.models import moe
    from repro_torch.serve import encdec_engine, engine

    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)),
                        dtype=torch.long, device="cuda")
    runs = (("cuda", cfg, params), ("torch", cfg, params),
            ("fp32", dataclasses.replace(cfg, dtype="float32"), None))
    off = 0 if prefix is None else prefix.shape[1]
    out, routes = {}, {}
    for name, c, p in runs:
        if p is None and consume:
            gc.collect()
            torch.cuda.empty_cache()
            say(f"path parity: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
                f"allocated before the fp32 copy is made in place")
            p = _float_in_place(params)
        elif p is None:
            p = _float_tree(params)
        with mm_config(backend="cuda" if name == "cuda" else "torch"), \
                moe.routing_capture() as log:
            if frames is not None:
                cache, pre = encdec_engine.prefill(p, c, frames, toks,
                                                   max_len=144)
                step_fn = encdec_engine.decode_step
            else:
                cache, pre = engine.prefill(p, c, toks, max_len=144 + off,
                                            prefix_embeds=prefix)
                step_fn = engine.decode_step
            if name == "cuda":
                nxt = torch.argmax(pre, -1)
            dec, _ = step_fn(p, c, cache, nxt, 128 + off)
        out[name] = (pre, dec)
        routes[name] = [r["experts"] for r in log]
        del cache, p
        torch.cuda.empty_cache()
    res = {}
    b, s = toks.shape
    for i, what in enumerate(("prefill", "decode")):
        got, want, exact = (out[n][i] for n in ("cuda", "torch", "fp32"))
        rows = torch.ones(b, dtype=torch.bool, device=got.device)
        if routed_rows:
            if any(len(r) != 2 for r in routes.values()):
                fail("routed_rows takes a model with one MoE layer")
            own = [r * s + s - 1 for r in range(b)] if i == 0 else range(b)
            rows = routed_alike(torch, [routes[n][i] for n in routes],
                                own, cfg).to(got.device)
            say(f"path parity {what}: {int(rows.sum())} of {b} rows routed "
                f"alike in all three runs (the fp32 ratio's rows)")
            if not bool(rows.any()):
                fail(f"no {what} row routed alike in all three runs")
        rel = {}
        for tag, x, y in (("cuda~torch", got, want), ("cuda~fp32", got, exact),
                          ("torch~fp32", want, exact)):
            diff = (x - y).abs()
            rel[tag] = (diff.max().item() / y.abs().max().item(),
                        diff.mean().item() / y.abs().mean().item())
        for tag, x, y in (("cuda~fp32 alike", got, exact),
                          ("torch~fp32 alike", want, exact)):
            diff = (x[rows] - y[rows]).abs()
            rel[tag] = (diff.max().item() / y[rows].abs().max().item(),
                        diff.mean().item() / y[rows].abs().mean().item())
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        shown = [t for t in rel if routed_rows or "alike" not in t]
        say(f"path parity {what}: " + " ".join(
            f"{t} max={rel[t][0]:.3e} mean={rel[t][1]:.3e}" for t in shown)
            + f" argmax(cuda)==argmax(torch) {agree:.2f}")
        ok = (rel["cuda~torch"][0] <= PATH_TOL_MAX
              and rel["cuda~torch"][1] <= PATH_TOL_MEAN
              and rel["cuda~fp32 alike"][1] <= PATH_TOL_RATIO
              * rel["torch~fp32 alike"][1])
        if not ok:
            fail(f"cuda and torch backends disagree on {what} logits")
        res[what] = rel
    if routes["cuda"]:
        res["routing_agreement"] = routing_agreement(torch, routes, cfg)
        say(f"path parity routing: cuda and torch agree on "
            f"{res['routing_agreement']:.5f} of the top-"
            f"{cfg.n_experts_per_tok} expert choices "
            f"({len(routes['cuda'])} MoE calls; fp32 run agrees with cuda "
            f"on {routing_agreement(torch, routes, cfg, 'fp32'):.5f})")
    return res


def routed_alike(torch, calls, tokens, cfg):
    """(len(tokens),) bool: whether each token chose the same top-k experts
    and kept the same of its copies in every run of one MoE call (`calls`:
    each run's (T, K) experts).  A copy is kept when fewer than the
    capacity of earlier copies (token-major order) chose its expert, as
    `moe._dispatch_compute_combine` packs them."""
    from repro_torch.models import moe
    cap = moe._capacity(calls[0].shape[0], cfg)

    def own(experts, t):
        return sorted((int(e), int((experts[:t] == e).sum()) < cap)
                      for e in experts[t])

    return torch.tensor([all(own(c, t) == own(calls[0], t) for c in calls)
                         for t in tokens])


def routing_agreement(torch, routes, cfg, other: str = "torch") -> float:
    """Mean over tokens and MoE calls of |S_cuda & S_other| / k, where S is
    a token's set of top-k experts."""
    import torch.nn.functional as F
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    same = total = 0
    for a, b in zip(routes["cuda"], routes[other]):
        sa = F.one_hot(a, e).sum(1)
        sb = F.one_hot(b, e).sum(1)
        same += int((sa * sb).sum())
        total += a.shape[0] * k
    return same / total


# ----------------------------------------------------------------- phase 6
def phase_timings(torch, cfg, params, counts, errs) -> list[dict]:
    from repro_torch.kernels import gemv_splitk as gk
    from repro_torch.kernels import skew_matmul as mm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    bf = torch.bfloat16
    emb_t = params["embed"].T
    h4 = torch.randn((4, d), generator=gen, device="cuda").to(bf)
    rows = []
    row = functools.partial(timing_row, torch, counts, errs)

    lm_bytes = 4 * d * 2 + d * v * 2 + 4 * v * 4
    lm_flops = 2 * 4 * d * v
    for sched in ("k_inner", "a_resident", "b_resident"):
        rows.append(row(
            f"skew_matmul_{sched}",
            lambda s=sched: mm.skew_matmul_cuda(h4, emb_t, bm=64, bk=64,
                                                bn=128, schedule=s,
                                                out_dtype=torch.float32),
            lambda: mm.skew_matmul_plain(h4, emb_t, bk=64,
                                         out_dtype=torch.float32),
            lambda: torch.matmul(h4, emb_t),
            lm_bytes, lm_flops, f"LM head 4x{d}x{v} bf16->fp32"))
    # k_inner at the other serving shapes: prefill gate/up and down, decode
    # gate/up, down and the o projection
    for m, k, n, spec in ((512, d, f, (("silu", None),)), (512, f, d, ()),
                          (4, d, f, (("silu", None),)), (4, f, d, ()),
                          (4, d, d, ())):
        a = torch.randn((m, k), generator=gen, device="cuda").to(bf)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             * k ** -0.5).to(bf)
        rows.append(row(
            "skew_matmul_k_inner",
            lambda a=a, w=w, s=spec: mm.skew_matmul_cuda(
                a, w, bm=64, bk=64, bn=128, epilogue=s, out_dtype=bf),
            lambda a=a, w=w, s=spec: mm.skew_matmul_plain(
                a, w, bk=64, epilogue=s, out_dtype=bf),
            lambda a=a, w=w: torch.matmul(a, w),
            (m * k + k * n + m * n) * 2, 2 * m * k * n,
            f"{m}x{k}x{n} bf16 {[t for t, _ in spec]}"))
    # the tuner's decode class 4 x 4096 x 4096: a_resident at its two
    # candidate plans beside k_inner at the planned blocks
    t = TUNE_TOTAL
    a = torch.randn((4, t), generator=gen, device="cuda").to(bf)
    w = (torch.randn((t, t), generator=gen, device="cuda") * t ** -0.5).to(bf)
    for sched, (bm, bk, bn) in (("k_inner", (64, 64, 128)),
                                ("a_resident", (64, 128, 64)),
                                ("a_resident", (64, 64, 64))):
        rows.append(row(
            f"skew_matmul_{sched}",
            lambda s=sched, bm=bm, bk=bk, bn=bn: mm.skew_matmul_cuda(
                a, w, bm=bm, bk=bk, bn=bn, schedule=s, out_dtype=bf),
            lambda bk=bk: mm.skew_matmul_plain(a, w, bk=bk, out_dtype=bf),
            lambda: torch.matmul(a, w),
            (4 * t + t * t + 4 * t) * 2, 2 * 4 * t * t,
            f"decode 4x{t}x{t} {(bm, bk, bn)}"))
    # 4096^3 at (64, 64, 128): b_resident holds each B slice while a chunk
    # of its 64 row blocks passes, beside k_inner at the same plan
    a = torch.randn((t, t), generator=gen, device="cuda").to(bf)
    for sched in ("k_inner", "b_resident"):
        rows.append(row(
            f"skew_matmul_{sched}",
            lambda s=sched: mm.skew_matmul_cuda(a, w, bm=64, bk=64, bn=128,
                                                schedule=s, out_dtype=bf),
            lambda: mm.skew_matmul_plain(a, w, bk=64, out_dtype=bf),
            lambda: torch.matmul(a, w),
            3 * t * t * 2, 2 * t ** 3, f"{t}^3 (64, 64, 128)"))
    del a, w
    rows.append(row(
        "skew_matmul_batched",
        lambda: mm.skew_matmul_batched_cuda(h4[:, None, :], emb_t, bm=64,
                                            bk=64, bn=128,
                                            out_dtype=torch.float32),
        lambda: mm.skew_matmul_batched_plain(h4[:, None, :], emb_t, bk=64,
                                             out_dtype=torch.float32),
        lambda: torch.matmul(h4[:, None, :], emb_t),
        lm_bytes, lm_flops, f"LM head 4x1x{d}x{v} bf16->fp32"))
    # K2 beside K1 at the decode o projection (4 x 1 stacked rows)
    w = (torch.randn((d, d), generator=gen, device="cuda") * d ** -0.5).to(bf)
    rows.append(row(
        "skew_matmul_batched",
        lambda: mm.skew_matmul_batched_cuda(h4[:, None, :], w, bm=64, bk=64,
                                            bn=128, out_dtype=bf),
        lambda: mm.skew_matmul_batched_plain(h4[:, None, :], w, bk=64,
                                             out_dtype=bf),
        lambda: torch.matmul(h4[:, None, :], w),
        (4 * d + d * d + 4 * d) * 2, 2 * 4 * d * d,
        f"4x1x{d}x{d} bf16"))
    sk = lm_head_splitk_plan(cfg)
    gk_n = -(-d // sk.bk)
    slab = gk.gemv_splitk_partial_cuda(h4, emb_t, bm=sk.bm, bk=sk.bk,
                                       bn=sk.bn)
    # the yardstick for pass 1: one batched product over the k splits,
    # on views (no copy of the embedding)
    a_split = h4.view(4, gk_n, sk.bk).transpose(0, 1) \
        if d % sk.bk == 0 else None
    b_split = params["embed"].view(v, gk_n, sk.bk).permute(1, 2, 0) \
        if d % sk.bk == 0 else None
    rows.append(row(
        "gemv_splitk_partial",
        lambda: gk.gemv_splitk_partial_cuda(h4, emb_t, bm=sk.bm, bk=sk.bk,
                                            bn=sk.bn),
        lambda: gk.gemv_splitk_partial_plain(h4, emb_t, bk=sk.bk),
        (lambda: torch.matmul(a_split, b_split)) if a_split is not None
        else None,
        4 * d * 2 + d * v * 2 + gk_n * 4 * v * 4, lm_flops,
        f"LM head 4x{d}x{v} gk={gk_n} blocks {(sk.bm, sk.bk, sk.bn)}"))
    # K3 at the decode gate/up and down projections at bk 128 (gk 24 and
    # 64): narrow grids, whose splits are cut into groups over grid z
    for k, n in ((d, f), (f, d)):
        a = torch.randn((4, k), generator=gen, device="cuda").to(bf)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             * k ** -0.5).to(bf)
        gkk = k // 128
        rows.append(row(
            "gemv_splitk_partial",
            lambda a=a, w=w: gk.gemv_splitk_partial_cuda(a, w, bm=64,
                                                         bk=128, bn=128),
            lambda a=a, w=w: gk.gemv_splitk_partial_plain(a, w, bk=128),
            lambda a=a, w=w, g=gkk: torch.matmul(
                a.view(4, g, 128).transpose(0, 1), w.view(g, 128, n)),
            (4 * k + k * n) * 2 + gkk * 4 * n * 4, 2 * 4 * k * n,
            f"decode 4x{k}x{n} gk={gkk} (64, 128, 128)"))
    del a, w
    rows.append(row(
        "gemv_splitk_reduce",
        lambda: gk.gemv_splitk_reduce_cuda(slab, out_dtype=torch.float32),
        lambda: gk.gemv_splitk_reduce_plain(slab, out_dtype=torch.float32),
        lambda: torch.sum(slab, dim=0),
        gk_n * 4 * v * 4 + 4 * v * 4, (gk_n - 1) * 4 * v,
        f"LM head slab {gk_n}x4x{v} fp32"))
    del slab
    # K4 at two more depths: dbrx's down projection at bk 128 (k 10752,
    # gk 84, n = d_model 6144) and an odd gk above 100 at the LM head
    for gkn, n in ((84, 6144), (101, v)):
        slab = torch.randn((gkn, 4, n), generator=gen, device="cuda")
        rows.append(row(
            "gemv_splitk_reduce",
            lambda slab=slab: gk.gemv_splitk_reduce_cuda(
                slab, out_dtype=torch.float32),
            lambda slab=slab: gk.gemv_splitk_reduce_plain(
                slab, out_dtype=torch.float32),
            lambda slab=slab: torch.sum(slab, dim=0),
            gkn * 4 * n * 4 + 4 * n * 4, (gkn - 1) * 4 * n,
            f"slab {gkn}x4x{n} fp32"))
        del slab
    return rows


# ----------------------------------------------------------------- dbrx
def grouped_blocks(g: int, m: int, k: int, n: int, dtype_bytes: int):
    """K5's blocks as `ops.grouped_matmul` takes them: the gpu_h100 plan,
    clipped to the granule-rounded dims."""
    from repro_torch.core import hw
    from repro_torch.kernels.ops import clip_blocks
    from repro_torch.sparse.planner import plan_grouped_matmul
    chip = hw.get_chip("gpu_h100")
    plan = plan_grouped_matmul(g, m, k, n, dtype_bytes=dtype_bytes,
                               chip=chip).plan
    return clip_blocks(plan, m, k, n, chip)


def phase_parity_grouped(torch, cfg) -> dict:
    """K5 against its plain version: the dbrx decode shapes (gate/up and
    down), the prefill shape, and a ragged shape in bf16 and fp32 with the
    epilogues none / gelu / scale / residual."""
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import skew_matmul as mm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    errs: dict = {}
    check = functools.partial(check_kernel, torch, errs)
    bf, fp = torch.bfloat16, torch.float32

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    cases = [  # (g, m, k, n, in dtype, out dtype, epilogue, strided)
        (e, 8, d, f, bf, fp, (), False), (e, 8, f, d, bf, fp, (), False),
        (e, 160, d, f, bf, fp, (), False), (e, 8, d, 1000, bf, bf, (), True)]
    for dtype in (bf, fp):
        for spec in ((), (("gelu", None),), (("scale", 0.5),),
                     (("residual", None),)):
            cases.append((4, 40, 1000, 700, dtype, dtype, spec, False))
    cases += [(4, 40, 1000, 700, bf, bf, (("residual", None),), True),
              (4, 160, 1000, 700, bf, fp, (), True)]
    for g, m, k, n, dtype, odt, spec, strided in cases:
        if strided:   # A a slice of a wider buffer, B a transposed view
            a = rnd((g, m, k + 64), dtype)[:, :, 64:]
            b = rnd((g, n, k), dtype, k ** -0.5).transpose(1, 2)
        else:
            a = rnd((g, m, k), dtype)
            b = rnd((g, k, n), dtype, k ** -0.5)
        res = rnd((g, m, n), dtype) if "residual" in dict(spec) else None
        bm, bk, bn = grouped_blocks(g, m, k, n, a.element_size())
        got = gmm.grouped_matmul_cuda(a, b, res, bm=bm, bk=bk, bn=bn,
                                      epilogue=spec, out_dtype=odt)
        want = gmm.grouped_matmul_plain(a, b, res, bk=bk, epilogue=spec,
                                        out_dtype=odt)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[-1]
        tag = (f"{dn} {g}x{m}x{k}x{n} {(bm, bk, bn)} {[t for t, _ in spec]}"
               f"{' strided' if strided else ''}")
        check("grouped_matmul", got, want, odt, tag)
        if dtype == bf:
            # K5 is K1's k_inner with the grouped walk (or, m > 16, the
            # prefill tile): group i equals K1 on A[i] @ B[i] bit for bit
            for i in range(g):
                k1 = mm.skew_matmul_cuda(
                    a[i], b[i], residual=None if res is None else res[i],
                    bm=bm, bk=bk, bn=bn, epilogue=spec, out_dtype=odt)
                torch.cuda.synchronize()
                if not torch.equal(got[i], k1):
                    fail(f"K5 group {i} is not bitwise equal to K1 ({tag})")
            say(f"parity K5 bitwise equal to K1 k_inner in each of {g} "
                f"groups ({tag})")
        del a, b, res, got, want
    torch.cuda.empty_cache()
    return errs


def moe_serve_bounds(cfg, params, batch: int, prompt: int,
                     kv_bytes: int) -> tuple[float, float]:
    """(prefill bound ms, decode bound ms per token) of the MoE serve.

    Bytes: every weight but the input embedding, which is read only at the
    rows of the step's tokens (every capacity slot goes through its
    expert, so every expert's weights are read each step), plus the KV
    cache at decode.  FLOPs: projections, causal attention, router, the
    expert GEMMs over all E x capacity slots, and the LM head on the last
    positions."""
    from repro_torch.models import moe
    from repro_torch.models.model import param_bytes
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    e, f = cfg.n_experts, cfg.moe_d_ff
    attn_w = d * h * hd + 2 * d * kvh * hd + h * hd * d
    emb = params["embed"]
    weights = param_bytes(params) - emb.numel() * emb.element_size()
    row = d * emb.element_size()
    toks = batch * prompt

    def layer_flops(t, cap, attn):
        return (2 * t * attn_w + attn + 2 * t * d * e
                + 3 * 2 * e * cap * d * f)

    attn_pre = 2 * 2 * batch * h * hd * prompt * prompt / 2
    pre_flops = (L * layer_flops(toks, moe._capacity(toks, cfg), attn_pre)
                 + 2 * batch * d * v)
    pre = max(pre_flops / PEAK_BF16, (weights + toks * row) / HBM_BW)
    attn_dec = 2 * 2 * batch * h * hd * (prompt + 1)
    dec_flops = (L * layer_flops(batch, moe._capacity(batch, cfg), attn_dec)
                 + 2 * batch * d * v)
    dec = max(dec_flops / PEAK_BF16,
              (weights + kv_bytes + batch * row) / HBM_BW)
    return pre * 1e3, dec * 1e3


def plan_key(cost) -> tuple:
    """A capture entry's GEMM: ("grouped", g, m, k, n) or (m, k, n, batch)."""
    if hasattr(cost, "layout"):
        s = cost.layout
        return ("grouped", s.groups, s.m // s.groups, s.k // s.groups,
                cost.n)
    dd = cost.dims
    return (dd.m, dd.k, dd.n, dd.batch)


def planned_kernels(log) -> set[str]:
    """The K1-K4 kernels the dense plans of a capture run (grouped plans,
    K5's, left out)."""
    used = set()
    for c in log:
        if hasattr(c, "layout"):
            continue
        if c.plan.schedule == "splitk":
            used |= {"gemv_splitk_partial", "gemv_splitk_reduce"}
        elif c.plan.batch_grid and c.dims.batch > 1:
            used.add("skew_matmul_batched")
        else:
            used.add(f"skew_matmul_{c.plan.schedule}")
    return used


def phase_serve_moe(torch, cfg):
    """The second main path: dbrx-132b at every published width, depth cut
    to `cfg.n_layers`, served through `serve(cfg=...)`."""
    from repro_torch.core import skewmm
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model, param_bytes
    from repro_torch.serve import kvcache

    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init(0)
    torch.cuda.synchronize()
    pbytes = param_bytes(params)
    say(f"init dbrx-132b at {cfg.n_layers} of 40 layers (depth cut; every "
        f"width published): {pbytes / 1e9:.3f} GB of bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")

    batch, prompt, gen = 4, 128, 16
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # ---- the main path: counts zeroed above, read right after it.
    with skewmm.plan_capture() as log:
        res = serve_mod.serve(cfg=cfg, params=params, batch=batch,
                              prompt_len=prompt, gen=gen, seed=SERVE_SEED,
                              temperature=SERVE_TEMPERATURE)
    counts = ops.launch_counts()
    # ---- end of the main path.
    peak = torch.cuda.max_memory_allocated()
    if not res["logits_finite"]:
        fail("dbrx serve produced non-finite logits")
    kv = kvcache.cache_bytes(kvcache.init_cache(cfg, batch, prompt + gen,
                                                "meta"))
    pre_b, dec_b = moe_serve_bounds(cfg, params, batch, prompt, kv)
    say(f"serve dbrx-132b ({cfg.n_layers} of 40 layers) b{batch} p{prompt} "
        f"g{gen}: prefill {res['prefill_s'] * 1e3:.1f} ms (bound "
        f"{pre_b:.2f} ms), decode {res['decode_s_per_token'] * 1e3:.2f} "
        f"ms/token (bound {dec_b:.2f} ms), peak memory "
        f"{peak / 2**30:.2f} GiB of {pbytes / 2**30:.2f} GiB weights, KV "
        f"cache {kv / 1e6:.1f} MB")
    seen = {}
    for c in log:
        seen.setdefault(plan_key(c), c)
    for key, c in seen.items():
        say(f"plan {key}: {c.explain()}")
    say(f"launch counts on the dbrx main path: {counts}")
    # the prefill, the decode graph's warm-up steps and its replays
    steps = 1 + res["decode_warmup_steps"] + gen
    want_k5 = 3 * cfg.n_layers * steps
    if counts["grouped_matmul"] != want_k5:
        fail(f"K5 launched {counts['grouped_matmul']} times, expected "
             f"{want_k5} (3 per MoE layer per step, {steps} steps: the "
             f"prefill, {res['decode_warmup_steps']} warm-up, {gen} "
             f"replays)")
    if res["decode_launches_per_step"]["grouped_matmul"] != 3 * cfg.n_layers:
        fail(f"the decode graph replays "
             f"{res['decode_launches_per_step']['grouped_matmul']} K5 "
             f"launches a step, expected {3 * cfg.n_layers}")
    say(f"K5 launches: {counts['grouped_matmul'] // steps} per step "
        f"({cfg.n_layers} MoE layers x 3 expert GEMMs)")
    for name in sorted(planned_kernels(log) | {"grouped_matmul",
                                               "flash_attention"}):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the dbrx main path")
    graph = [graph_vs_eager(torch, cfg, params, res, batch, prompt, gen,
                            bitwise=False)]
    return {"serve": res, "peak": peak, "bounds": (pre_b, dec_b),
            "params": params, "params_bytes": pbytes, "kv_bytes": kv,
            "counts": counts, "graph": graph}


def first_layers(params, n: int) -> dict:
    """The model's first `n` units of its first stage (a unit is one layer
    for dbrx, three for recurrentgemma), sharing the tensors."""
    out = {k: v for k, v in params.items() if not k.startswith("stage")}
    out["stage0"] = params["stage0"][:n]
    return out


def phase_timings_grouped(torch, cfg, params, counts, errs) -> list[dict]:
    """K5, its plain version and `torch.bmm` at the dbrx decode and prefill
    shapes, on the first layer's expert weights."""
    from repro_torch.kernels import grouped_matmul as gmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(98)
    p = params["stage0"][0]["b0"]["moe"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    bf, fp = torch.bfloat16, torch.float32
    row = functools.partial(timing_row, torch, counts, errs)
    rows = []
    for m, w, what in ((8, p["w_gate"], "decode gate/up"),
                       (8, p["w_down"], "decode down"),
                       (160, p["w_gate"], "prefill gate/up")):
        k, n = w.shape[1], w.shape[2]
        a = torch.randn((e, m, k), generator=gen, device="cuda").to(bf)
        bm, bk, bn = grouped_blocks(e, m, k, n, 2)
        rows.append(row(
            "grouped_matmul",
            lambda a=a, w=w, bm=bm, bk=bk, bn=bn: gmm.grouped_matmul_cuda(
                a, w, bm=bm, bk=bk, bn=bn, out_dtype=fp),
            lambda a=a, w=w, bk=bk: gmm.grouped_matmul_plain(
                a, w, bk=bk, out_dtype=fp),
            lambda a=a, w=w: torch.bmm(a, w),
            (e * m * k + e * k * n) * 2 + e * m * n * 4, 2 * e * m * k * n,
            f"{what} {e}x{m}x{k}x{n} bf16->fp32 {(bm, bk, bn)}"))
    return rows


# ----------------------------------------------------------------- hybrid
def seq_shapes(phi4, dbrx, rg) -> tuple[list, list]:
    """K7's shapes (label, B, Hq, Hkv, S, D, window, softcap) and K6's
    (label, B, L, D): every served model's prefill at batch 4 x 128,
    recurrentgemma's long prefill, and gemma2-27b's local attention layer
    (src/repro/configs/gemma2_27b.py: 32 / 16 heads of 128, window 4096,
    softcap 50; the port does not serve gemma2 yet)."""
    fa = [(f"{c.name} prefill", 4, c.n_heads, c.n_kv_heads, 128, c.head_dim,
           c.local_window, c.attn_softcap) for c in (rg, phi4, dbrx)]
    fa += [(f"{rg.name} long prefill", 1, rg.n_heads, rg.n_kv_heads, 3072,
            rg.head_dim, rg.local_window, 0.0),
           ("gemma2-27b local layer", 1, 32, 16, 8192, 128, 4096, 50.0)]
    scan = [(f"{rg.name} prefill", 4, 128, rg.lru_width),
            (f"{rg.name} long prefill", 1, 3072, rg.lru_width)]
    return fa, scan


def _qkv(torch, gen, b, hq, hkv, s, d, dtype):
    """q, k, v as the model hands them to K7: (B, H, S, D) views of
    (B, S, H, D) projections."""
    def one(h):
        return torch.randn((b, s, h, d), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
    return one(hq), one(hkv), one(hkv)


def _scan_inputs(torch, gen, b, length, d, dtype=None):
    dtype = dtype or torch.bfloat16
    x, r, i = (torch.randn((b, length, d), generator=gen,
                           device="cuda").to(dtype) for _ in range(3))
    lam = torch.rand((d,), generator=gen, device="cuda") * 4.0 - 2.0
    return x, r, i, lam


def phase_parity_seq(torch, fa_shapes, scan_shapes) -> dict:
    """K7 and K6 against their plain versions on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    errs: dict = {}
    check = functools.partial(check_kernel, torch, errs)
    bf = torch.bfloat16
    cases = [(*shape, bf) for shape in fa_shapes]
    # ragged against the 128-row q tile, MQA 16:1, a window of 40 that
    # cuts a 64-column kv tile in its middle; one row; the fp32 route
    cases += [("ragged", 2, 16, 1, 257, 256, 40, 0.0, bf),
              ("one row", 2, 16, 1, 1, 256, None, 50.0, bf),
              ("fp32 tile at head dim 256", 1, 16, 1, 300, 256, 100, 0.0,
               torch.float32)]
    for label, b, hq, hkv, s, d, window, cap, dtype in cases:
        q, k, v = _qkv(torch, gen, b, hq, hkv, s, d, dtype)
        got = fa.flash_attention_cuda(q, k, v, window=window, softcap=cap)
        want = fa.flash_attention_plain(q, k, v, window=window, softcap=cap)
        torch.cuda.synchronize()
        check("flash_attention", got, want, dtype,
              f"{label} {b}x{hq}/{hkv}x{s}x{d} w={window} cap={cap}")
        del q, k, v, got, want
    # ragged; an odd width (one channel a thread); the fp32 route
    for label, b, length, d, dtype in [(*sh, bf) for sh in scan_shapes] + [
            ("ragged", 3, 37, 200, bf), ("odd width", 2, 300, 201, bf),
            ("fp32", 2, 300, 200, torch.float32)]:
        x, r, i, lam = _scan_inputs(torch, gen, b, length, d, dtype)
        y, h = rg.rglru_scan_cuda(x, r, i, lam, return_state=True)
        want, hw = rg.rglru_scan_plain(x, r, i, lam, return_state=True)
        torch.cuda.synchronize()
        check("rglru_scan", y, want, dtype, f"{label} y {b}x{length}x{d}")
        check("rglru_scan", h, hw, torch.float32,
              f"{label} fp32 carry {b}x{d}")
    torch.cuda.empty_cache()
    return errs


def visible_pairs(s: int, window: int | None) -> int:
    """(row, col) pairs a causal (windowed) self-attention over s
    positions computes: sum over rows of min(row + 1, window)."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def layer_serve_bounds(cfg, params, batch: int, prompt: int,
                       kv_bytes: int) -> tuple[float, float]:
    """(prefill bound ms, decode bound ms per token) of the hybrid and the
    dense serves, counted layer by layer.

    Bytes: every weight once (a tied embedding is the LM head; of an
    untied input embedding only the token rows are read), plus the decode
    caches at decode.  Operations: 2 per token and weight of every layer
    tensor of two or more dims (projections, MLP, the block-diagonal gates
    and the conv taps), attention's 4 * D per visible (row, col) pair and
    q head (a local layer's window cuts the pairs), and the LM head on the
    last positions; the elementwise scan is left out (tiny beside
    them)."""
    from repro_torch.models import transformer
    from repro_torch.models.model import param_bytes
    d, v, hd, h = cfg.d_model, cfg.vocab_size, cfg.head_dim, cfg.n_heads
    layer_w = pre_pairs = dec_pairs = 0
    for kind, p, *_ in transformer.layer_iter(params, cfg):
        layer_w += sum(t.numel() for t in _leaves(p) if t.dim() >= 2)
        if kind != "rec":
            win = cfg.local_window if kind == "attn_local" else None
            pre_pairs += visible_pairs(prompt, win)
            dec_pairs += min(prompt + 1, win or prompt + 1)
    pbytes = pre_bytes = dec_bytes = param_bytes(params)
    if not cfg.tie_embeddings:
        emb = params["embed"]
        row = emb.shape[1] * emb.element_size()
        pre_bytes = pbytes - emb.shape[0] * row + batch * prompt * row
        dec_bytes = pbytes - emb.shape[0] * row + batch * row
    pre_ops = (2 * batch * prompt * layer_w + 2 * batch * d * v
               + 4 * hd * h * batch * pre_pairs)
    pre = max(pre_ops / PEAK_BF16, pre_bytes / HBM_BW)
    dec_ops = 2 * batch * (layer_w + d * v) + 4 * hd * h * batch * dec_pairs
    dec = max(dec_ops / PEAK_BF16, (dec_bytes + kv_bytes) / HBM_BW)
    return pre * 1e3, dec * 1e3


def served_cache_bytes(cfg, batch: int, max_len: int) -> int:
    """Bytes of the decode caches a serve of `cfg` holds (the self and
    cross caches of an encoder-decoder), sized on the meta device."""
    from repro_torch.serve import encdec_engine, kvcache
    if cfg.family == "encdec":
        return sum(t.numel() * t.element_size()
                   for t in encdec_engine.init_cache(
                       cfg, batch, max_len, cfg.frontend_len,
                       "meta").values())
    return kvcache.cache_bytes(kvcache.init_cache(cfg, batch, max_len,
                                                  "meta"))


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def serve_runs(torch, cfg, runs, bounds_fn) -> dict:
    """Seeded weights for `cfg`, then one `serve(cfg=...)` per (batch,
    prompt, gen) run: launch counts are zeroed just before the runs and
    read just after them.  Prints each run's times beside its bounds
    (`bounds_fn(cfg, params, batch, prompt, cache_bytes)`), the peak
    memory and the plans, and fails if a run's logits are not finite or a
    planned K1-K4 kernel never launched.  Then holds each run's graphed
    decode bitwise equal to an eager one (`graph_vs_eager`)."""
    from repro_torch.core import skewmm
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model, param_bytes

    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init(0)
    torch.cuda.synchronize()
    pbytes = param_bytes(params)
    leaves = list(_leaves(params))
    f32 = sum(t.numel() * 4 for t in leaves if t.dtype == torch.float32)
    say(f"init {cfg.name}: {sum(t.numel() for t in leaves)} parameters, "
        f"{pbytes / 1e9:.3f} GB of weights ({f32 / 1e6:.2f} MB of them "
        f"fp32) in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # ---- the main path: counts zeroed above, read right after it.
    with skewmm.plan_capture() as log:
        results = [serve_mod.serve(cfg=cfg, params=params, batch=b,
                                   prompt_len=p, gen=g, seed=SERVE_SEED,
                                   temperature=SERVE_TEMPERATURE)
                   for b, p, g in runs]
    counts = ops.launch_counts()
    # ---- end of the main path.
    peak = torch.cuda.max_memory_allocated()
    bounds = []
    for (b, p, g), res in zip(runs, results):
        if not res["logits_finite"]:
            fail(f"{cfg.name} serve b{b} p{p} produced non-finite logits")
        cb = served_cache_bytes(cfg, b, p + g)
        pre_b, dec_b = bounds_fn(cfg, params, b, p, cb)
        bounds.append((pre_b, dec_b))
        say(f"serve {cfg.name} ({depth(cfg)}) b{b} p{p} g{g}: "
            f"prefill {res['prefill_s'] * 1e3:.1f} ms (bound {pre_b:.2f} "
            f"ms), decode {res['decode_s_per_token'] * 1e3:.2f} ms/token "
            f"(bound {dec_b:.2f} ms), caches {cb / 1e6:.1f} MB")
    say(f"serve {cfg.name}: peak memory {peak / 2**30:.2f} GiB of "
        f"{pbytes / 2**30:.2f} GiB weights")
    seen = {}
    for c in log:
        seen.setdefault(plan_key(c), c)
    for key, c in seen.items():
        say(f"plan {key}: {c.explain()}")
    say(f"launch counts on the {cfg.name} main path: {counts}")
    for name in sorted(planned_kernels(log)):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the {cfg.name} path")
    graph = [graph_vs_eager(torch, cfg, params, res, b, p, g, bitwise=True)
             for (b, p, g), res in zip(runs, results)]
    return {"serve": results, "peak": peak, "bounds": bounds,
            "params": params, "params_bytes": pbytes, "counts": counts,
            "graph": graph}


def phase_serve_hybrid(torch, cfg):
    """The third main path: recurrentgemma-9b at every published width and
    all 38 layers, served at batch 4 x 128 and at batch 1 x 3072."""
    runs = ((4, 128, 16), (1, 3072, 4))
    out = serve_runs(torch, cfg, runs, layer_serve_bounds)
    counts = out["counts"]
    kinds = [u for unit, n in cfg.stage_list() for _ in range(n) for u in unit]
    n_rec, n_attn = kinds.count("rec"), len(kinds) - kinds.count("rec")
    want = {"rglru_scan": n_rec * len(runs),
            "flash_attention": n_attn * len(runs)}
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{name} launched {counts[name]} times, expected {n} (one "
                 f"per {'recurrent' if name == 'rglru_scan' else 'attention'}"
                 f" layer of each of {len(runs)} prefills)")
    per_prefill, per_decode = prefill_decode_counts(torch, cfg, out["params"])
    if per_prefill["rglru_scan"] != n_rec or per_decode["rglru_scan"] != 0:
        fail(f"K6 launched {per_prefill['rglru_scan']} times in a prefill "
             f"and {per_decode['rglru_scan']} in a decode step, expected "
             f"{n_rec} and 0")
    say(f"K6 launches: {n_rec} per prefill, 0 per decode step; K7: "
        f"{n_attn} per prefill ({n_rec} rec + {n_attn} attn_local layers)")
    return out


def prefill_decode_counts(torch, cfg, params) -> tuple[dict, dict]:
    """Launch counts of one batch-4 x 128 prefill and of the decode step
    after it, each counted apart (zeroed just before, read just after)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve import engine

    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 128)), dtype=torch.long, device="cuda")
    ops.reset_launch_counts()
    cache, logits = engine.prefill(params, cfg, toks, max_len=129)
    torch.cuda.synchronize()
    per_prefill = ops.launch_counts()
    ops.reset_launch_counts()
    engine.decode_step(params, cfg, cache, torch.argmax(logits, -1), 128)
    torch.cuda.synchronize()
    return per_prefill, ops.launch_counts()


def sdpa_call(torch, F, q, k, v, window=None, causal: bool = True):
    """One `scaled_dot_product_attention` call computing causal GQA
    attention on q, k, v (with `causal` False, unmasked, where q's length
    may differ from k's); with a window shorter than the sequence, through
    a boolean band mask (col <= row, col > row - window) built here, before
    any timing.  Kv heads are expanded beforehand where this PyTorch takes
    no `enable_gqa` (or not with a mask)."""
    s = q.shape[2]
    kw = dict(is_causal=causal)
    if window is not None and window < s:
        i = torch.arange(s, device=q.device)
        kw = dict(attn_mask=(i[None, :] <= i[:, None])
                  & (i[None, :] > i[:, None] - window))
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        torch.cuda.synchronize()
    except (TypeError, RuntimeError):
        g = q.shape[1] // k.shape[1]
        ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve, **kw)
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)


def phase_timings_seq(torch, fa_shapes, scan_shapes, counts,
                      errs) -> list[dict]:
    """K7 and K6, their plain versions and (K7, every row without a
    softcap) `scaled_dot_product_attention`, at the main paths' shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg

    gen = torch.Generator(device="cuda")
    gen.manual_seed(97)
    row = functools.partial(timing_row, torch, counts, errs)
    bf = torch.bfloat16
    rows = []
    for label, b, hq, hkv, s, d, window, cap in fa_shapes:
        q, k, v = _qkv(torch, gen, b, hq, hkv, s, d, bf)
        lib = sdpa_call(torch, F, q, k, v, window) if cap == 0.0 else None
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
        ops_ = 4 * d * hq * b * visible_pairs(s, window)
        rows.append(row(
            "flash_attention",
            lambda q=q, k=k, v=v, w=window, c=cap: fa.flash_attention_cuda(
                q, k, v, window=w, softcap=c),
            lambda q=q, k=k, v=v, w=window, c=cap: fa.flash_attention_plain(
                q, k, v, window=w, softcap=c),
            lib, nbytes, ops_,
            f"{label} {b}x{hq}/{hkv}x{s}x{d} w={window} cap={cap}"))
        del q, k, v
    for label, b, length, d in scan_shapes:
        n = b * length * d
        # copies of the inputs that together pass twice the L2, called in
        # turn: every call reads its inputs from device memory
        copies = max(2, math.ceil(2 * L2_BYTES / (3 * n * 2)))
        sets = [_scan_inputs(torch, gen, b, length, d)
                for _ in range(copies)]
        turn = iter(range(1 << 62))

        def kernel(sets=sets, turn=turn):
            x, r, i, lam = sets[next(turn) % len(sets)]
            return rg.rglru_scan_cuda(x, r, i, lam, return_state=True)
        say(f"time rglru_scan {label}: inputs rotated over {copies} copies "
            f"({copies * 3 * n * 2 / 1e6:.1f} MB) past the "
            f"{L2_BYTES / 1e6:.0f} MB L2")
        rows.append(row(
            "rglru_scan", kernel,
            lambda x=sets[0]: rg.rglru_scan_plain(*x, return_state=True),
            None, 4 * n * 2 + d * 4 + b * d * 4, RGLRU_OPS * n,
            f"{label} {b}x{length}x{d} bf16 + fp32 carry", peak=PEAK_FP32))
        del sets
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- ssm
def ssd_shapes(cfg) -> list:
    """K8's shapes (label, B, L, H, P, G, S, strong decay): mamba2-2.7b's
    batch-4 prefill (one chunk), its long prompt (23 whole chunks and a
    56-row tail), a grouped ragged shape, and the same under a strong
    decay."""
    h, p, g, s = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state
    return [(f"{cfg.name} prefill", 4, 128, h, p, g, s, False),
            (f"{cfg.name} long prefill", 1, 3000, h, p, g, s, False),
            ("grouped ragged", 2, 200, 16, p, 4, 64, False),
            ("strong decay", 2, 200, 16, p, 4, 64, True)]


def _ssd_inputs(torch, gen, b, length, h, p, g, s, strong, dtype):
    """x, dt, a_log, B, C as the mixer hands them to K8 (dt fp32 and
    positive; B, C shared per group)."""
    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    x = rnd((b, length, h, p))
    dt = torch.rand((b, length, h), generator=gen, device="cuda") * 0.2 \
        + 0.001
    a_log = torch.rand((h,), generator=gen, device="cuda") * 1.5 - 0.5
    if strong:      # A = -e^3, dt up to 5: a step decays by up to e^-100
        dt, a_log = dt * 25.0, torch.full_like(a_log, 3.0)
    return x, dt, a_log, rnd((b, length, g, s), 0.5), \
        rnd((b, length, g, s), 0.5)


def ssd_ops(b: int, length: int, h: int, p: int, s: int,
            chunk: int) -> tuple[int, int, int, int]:
    """Operations the SSD scan needs over (b, length) and h heads, as (C B^T,
    the scores times x dt, the carried state's readout, the state update):
    per chunk of n rows, 2 S per causal (row, col) pair for C B^T, whose
    operands are the inputs; 2 P per pair for the scores times x dt; 2 n S
    P for the readout of the carried state (none in the first chunk, whose
    state is zero) and 2 n S P for the state update, those three with an
    fp32 operand."""
    cb = yi = ys = ds = 0
    for c0 in range(0, length, chunk):
        n = min(chunk, length - c0)
        pairs = n * (n + 1) // 2
        cb += pairs * 2 * s
        yi += pairs * 2 * p
        ys += 2 * n * s * p if c0 else 0
        ds += 2 * n * s * p
    return b * h * cb, b * h * yi, b * h * ys, b * h * ds


def ssd_split_ops(cb: int, yi: int, ys: int, ds: int) -> int:
    """The SSD scan's tensor-core operations with bf16 inputs, all at the
    bf16 rate: K8 keeps fp32 operands as two bf16 terms (hi, lo), so C B^T
    takes one MMA term (bf16 inputs, exact), the scores times x dt three
    (two fp32 operands: hi hi, hi lo, lo hi), and the state's readout and
    update two each (one fp32 operand)."""
    return cb + 3 * yi + 2 * (ys + ds)


def ssd_exact_check(torch, args, y, chunk: int, label: str) -> None:
    """K8's y against the sequential recurrence in fp64 (`ref.ssd_ref`),
    beside the chunked form with an fp32 torch.cumsum on the same inputs;
    K8 (fp64 prefix sum) must come no further from the exact answer."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    exact = ref.ssd_ref(*(t.double() for t in args))
    y32 = ssd.ssd_scan_plain(*args, chunk=chunk, cum_dtype=torch.float32)
    scale = exact.abs().max()
    err = ((y.double() - exact).abs().max() / scale).item()
    err32 = ((y32.double() - exact).abs().max() / scale).item()
    ok = err <= err32
    say(f"exact  ssd_scan {label} chunk {chunk} vs fp64 recurrence: K8 "
        f"rel_err={err:.3e}, fp32-cumsum chunked form rel_err={err32:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"ssd_scan: K8 is further from the fp64 recurrence than an "
             f"fp32 cumsum at {label}")


def phase_parity_ssd(torch, shapes, chunk: int) -> dict:
    """K8 against its plain version on the card, y and the fp32 state; with
    more than one chunk also its chunk-state kernel and its state pass
    against their plain pieces."""
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    errs: dict = {}
    check = functools.partial(check_kernel, torch, errs)
    mamba = shapes[1][1:-1]                 # (B, L, H, P, G, S), 1 x 3000
    cases = [(*sh, chunk) for sh in shapes] + [
        ("two chunks", 2, 256, 8, 64, 2, 128, False, 128),
        ("long prefill, strong decay", *mamba, True, chunk),
        ("odd sizes, batch 1", 1, 77, 6, 40, 3, 72, False, 48),
        ("P 3, S 5, chunk 2", 1, 5, 2, 3, 1, 5, False, 2)]
    for label, b, length, h, p, g, s, strong, ch in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args = _ssd_inputs(torch, gen, b, length, h, p, g, s, strong,
                               dtype)
            y, st = ssd.ssd_scan_cuda(*args, chunk=ch, return_state=True)
            want, st_want = ssd.ssd_scan_plain(*args, chunk=ch,
                                               return_state=True)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(y).all())
                    and bool(torch.isfinite(st).all())):
                fail(f"ssd_scan: non-finite output at {label}")
            dn = str(dtype).split(".")[-1]
            shape = f"{b}x{length}x{h}x{p} G{g} S{s} chunk {ch}"
            check("ssd_scan", y, want, dtype, f"{label} {dn} y {shape}")
            check("ssd_scan", st, st_want, torch.float32,
                  f"{label} {dn} fp32 state")
            if length > ch:
                ssd_pieces_check(torch, check, args, ch, f"{label} {dn}")
            if strong and dtype == torch.float32:
                ssd_exact_check(torch, args, y, ch, label)
            del args, y, st, want, st_want
    torch.cuda.empty_cache()
    return errs


def ssd_pieces_check(torch, check, args, chunk: int, tag: str) -> None:
    """K8's chunk-state kernel (every chunk's dS and decay) and its state
    pass (each chunk's incoming state and the final state) against their
    plain pieces on the same inputs."""
    from repro_torch.kernels import ssd_scan as ssd

    x, dt, a_log, b_mat, _ = args
    p = x.shape[-1]
    ws, decay = ssd.ssd_chunk_state_cuda(x, dt, a_log, b_mat, chunk=chunk)
    ds, dec = ssd.ssd_chunk_state_plain(x, dt, a_log, b_mat, chunk=chunk)
    torch.cuda.synchronize()
    check("ssd_chunk_state", ws[..., :p], ds, torch.float32,
          f"{tag} chunk states")
    check("ssd_chunk_state", decay, dec, torch.float32, f"{tag} decays")
    inc, st_want = ssd.ssd_state_pass_plain(ws[..., :p].clone(), decay,
                                            ws.shape[2])
    st = ssd.ssd_state_pass_cuda(ws, decay, p)
    torch.cuda.synchronize()
    check("ssd_state_pass", ws[:, :, 1:, :, :p], inc[:, :, 1:],
          torch.float32, f"{tag} incoming states")
    check("ssd_state_pass", st, st_want, torch.float32, f"{tag} last state")


def ssm_serve_bounds(cfg, params, batch: int, prompt: int,
                     cache_bytes: int) -> tuple[float, float]:
    """(prefill bound ms, decode bound ms per token) of the mamba2 serve.

    Bytes: every weight once (the tied embedding is the LM head); at decode
    also the caches (fp32 SSD states and conv tails), read and written
    again.  Operations: 2 per token and weight of every layer tensor of two
    or more dims (the five input projections, the conv taps, the output
    projection), the SSD scan's (`ssd_ops`) at prefill and its 4 S P per
    head and token at decode, and the LM head on the last positions; all
    at the bf16 rate, the least the card could take."""
    from repro_torch.models import transformer
    from repro_torch.models.model import param_bytes
    d, v = cfg.d_model, cfg.vocab_size
    h, p, s = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    layer_w = sum(t.numel() for _, lp, *_ in transformer.layer_iter(
        params, cfg) for t in _leaves(lp) if t.dim() >= 2)
    pbytes = param_bytes(params)
    pre_ops = (2 * batch * prompt * layer_w + 2 * batch * d * v
               + cfg.n_layers * sum(ssd_ops(batch, prompt, h, p, s,
                                            cfg.ssm_chunk)))
    pre = max(pre_ops / PEAK_BF16, pbytes / HBM_BW)
    dec_ops = (2 * batch * (layer_w + d * v)
               + cfg.n_layers * batch * h * 4 * s * p)
    dec = max(dec_ops / PEAK_BF16, (pbytes + 2 * cache_bytes) / HBM_BW)
    return pre * 1e3, dec * 1e3


def phase_serve_ssm(torch, cfg):
    """The fourth main path: mamba2-2.7b at every published width and all
    64 layers, served at batch 4 x 128 and at batch 1 x 3000; then one
    prefill and one decode step with K8's launches counted apart."""
    runs = ((4, 128, 16), (1, 3000, 4))
    out = serve_runs(torch, cfg, runs, ssm_serve_bounds)
    counts, n = out["counts"], cfg.n_layers
    # the readout once per layer of each prefill; the chunk states and the
    # state pass once per layer of the prefill longer than one chunk
    multi = sum(p > cfg.ssm_chunk for _, p, _ in runs)
    want = {"ssd_scan": n * len(runs), "ssd_chunk_state": n * multi,
            "ssd_state_pass": n * multi}
    for name, k in want.items():
        if counts[name] != k:
            fail(f"{name} launched {counts[name]} times over the serve runs, "
                 f"expected {k} (per prefill: b4 p128 "
                 f"{n if name == 'ssd_scan' else 0}, b1 p3000 {n}; none at "
                 f"decode)")
    per_prefill, per_decode = prefill_decode_counts(torch, cfg, out["params"])
    want_prefill = {"ssd_scan": n, "ssd_chunk_state": 0, "ssd_state_pass": 0}
    for name, k in want_prefill.items():
        if per_prefill[name] != k or per_decode[name] != 0:
            fail(f"{name} launched {per_prefill[name]} times in a batch-4 "
                 f"prefill and {per_decode[name]} in a decode step, "
                 f"expected {k} and 0")
    say(f"K8 launches per prefill (readout / chunk states / state pass): "
        f"b4 p128 {n} / 0 / 0, b1 p3000 {n} / {n} / {n} ({n} ssm layers); "
        f"0 / 0 / 0 per decode step")
    return out


def phase_timings_ssd(torch, shapes, chunk: int, counts,
                      errs) -> list[dict]:
    """K8 and its plain version at the 3d shapes, bf16 in, with the fp32
    state; no single PyTorch call computes the SSD scan."""
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(96)
    row = functools.partial(timing_row, torch, counts, errs)
    rows = []
    for label, b, length, h, p, g, s, strong in shapes:
        args = _ssd_inputs(torch, gen, b, length, h, p, g, s, strong,
                           torch.bfloat16)
        nbytes = (2 * b * length * h * p * 2 + b * length * h * 4
                  + 2 * b * length * g * s * 2 + h * 4 + b * h * s * p * 4)
        shape = f"{label} {b}x{length}x{h}x{p} G{g} S{s}"
        rows.append(row(
            "ssd_scan",
            lambda args=args: ssd.ssd_scan_cuda(*args, chunk=chunk,
                                                return_state=True),
            lambda args=args: ssd.ssd_scan_plain(*args, chunk=chunk,
                                                 return_state=True),
            None, nbytes, ssd_split_ops(*ssd_ops(b, length, h, p, s, chunk)),
            f"{shape} bf16 + fp32 state"))
        if label.endswith("long prefill"):
            rows += ssd_piece_rows(torch, row, args, chunk, shape)
        del args
    torch.cuda.empty_cache()
    return rows


def ssd_piece_rows(torch, row, args, chunk: int, shape: str) -> list[dict]:
    """K8's chunk-state kernel and its state pass alone, beside their plain
    pieces and bounds: the chunk states read x, dt and B once and write the
    fp32 workspace, 2 S P operations per chunk row and head in two MMA
    terms at the bf16 rate (`ssd_split_ops`); the state pass reads and
    writes the workspace once (two fp32 operations an element and
    chunk)."""
    from repro_torch.kernels import ssd_scan as ssd

    x, dt, a_log, b_mat, _ = args
    b, length, h, p = x.shape
    g, s = b_mat.shape[2], b_mat.shape[3]
    ws, decay = ssd.ssd_chunk_state_cuda(x, dt, a_log, b_mat, chunk=chunk)
    ds, dec = ssd.ssd_chunk_state_plain(x, dt, a_log, b_mat, chunk=chunk)
    nc, ldp = ws.shape[2], ws.shape[4]
    ws_bytes = b * h * nc * s * ldp * 4
    in_bytes = (b * length * h * p * 2 + b * length * h * 4
                + b * length * g * s * 2 + h * 4)
    return [
        row("ssd_chunk_state",
            lambda: ssd.ssd_chunk_state_cuda(x, dt, a_log, b_mat,
                                             chunk=chunk),
            lambda: ssd.ssd_chunk_state_plain(x, dt, a_log, b_mat,
                                              chunk=chunk),
            None, in_bytes + ws_bytes + b * h * nc * 4,
            2 * (2 * b * h * length * s * p),
            f"{shape} bf16 -> fp32 workspace"),
        row("ssd_state_pass",
            lambda: ssd.ssd_state_pass_cuda(ws, decay, p),
            lambda: ssd.ssd_state_pass_plain(ds, dec, nc),
            None, 2 * ws_bytes + b * h * nc * 4 + b * h * s * p * 4,
            2 * b * h * nc * s * p, f"{shape} fp32 workspace, {nc} chunks",
            peak=PEAK_FP32)]


# ----------------------------------------------------------------- tune
# The tuner's shapes: the paper's 4096^2 problem scale, n = 4096.  The
# `sparse` suite's layouts (block (32, 128), densities 0.25 / 0.5, seed 0)
# and the JAX package's tuned suite's (128, 128) summaries at 0.1 / 0.4,
# which no gpu_h100 plan fits, so the planner fails over to k_inner
# (128, 128, 64).
TUNE_TOTAL, TUNE_ITERS, TUNE_REPEATS = 4096, 3, 5
TUNED_SUITE_DENSITIES = (0.1, 0.4)
BSR_BN = 64


def _bsr_operands(torch, gen, m, k, n, dtype):
    a = (torch.randn((m, k), generator=gen, device="cuda")).to(dtype)
    b = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).to(dtype)
    bias = torch.randn((n,), generator=gen, device="cuda").to(dtype)
    res = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
    return a, b, bias, res


def phase_parity_bsr(torch) -> dict:
    """K9 against its plain version: every schedule, bf16 and fp32, the
    bias_silu and residual epilogues, densities 0.05 / 0.25 / 0.5 / 1.0,
    blocks (32, 128), (64, 64), (128, 128), on a shape ragged in m, k and
    n and on a layout with empty row blocks; at density 1.0 K9 must equal
    K1 bit for bit at the same plan.  Then the main path's shapes: 4096^2
    at every candidate plan the tuner times."""
    from repro_torch.core import epilogue as ep_mod
    from repro_torch.kernels import block_sparse_matmul as bsr
    from repro_torch.kernels import skew_matmul as mm
    from repro_torch.sparse import planner
    from repro_torch.sparse.layout import BlockSparseLayout

    gen = torch.Generator(device="cuda")
    gen.manual_seed(95)
    errs: dict = {}
    check = functools.partial(check_kernel, torch, errs)
    m, k, n = 1000, 1500, 700              # ragged against every block
    specs = (("bias_silu", True, False), ("residual", False, True))
    bitwise = 0
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        a, b, bias, res = _bsr_operands(torch, gen, m, k, n, dtype)
        for block in ((32, 128), (64, 64), (128, 128)):
            for d in (0.05, 0.25, 0.5, 1.0):
                lay = (BlockSparseLayout.dense(m, k, block) if d == 1.0
                       else BlockSparseLayout.random(m, k, block, d, seed=5))
                for spec, use_bias, use_res in specs:
                    tokens = ep_mod.normalize_spec(spec)
                    bi = bias if use_bias else None
                    rs = res if use_res else None
                    want = bsr.block_sparse_matmul_plain(
                        a, b, lay, bi, rs, epilogue=tokens, out_dtype=dtype)
                    for sched in bsr.SCHEDULE_IDS:
                        got = bsr.block_sparse_matmul_cuda(
                            a, b, lay, bi, rs, bn=BSR_BN, schedule=sched,
                            epilogue=tokens, out_dtype=dtype)
                        torch.cuda.synchronize()
                        check(f"block_sparse_matmul_{sched}", got, want,
                              dtype, f"{dn} {m}x{k}x{n} {block} d={d} {spec}")
                        if d == 1.0:
                            k1 = mm.skew_matmul_cuda(
                                a, b, bi, rs, bm=block[0], bk=block[1],
                                bn=BSR_BN, schedule=sched, epilogue=tokens,
                                out_dtype=dtype)
                            torch.cuda.synchronize()
                            if not torch.equal(got, k1):
                                fail(f"K9 {sched} at density 1.0 is not "
                                     f"bitwise equal to K1 ({dn} {block} "
                                     f"{spec})")
                            bitwise += 1
        # empty row blocks: every third row block holds nothing
        mask = BlockSparseLayout.random(m, k, (32, 128), 0.5,
                                        seed=6).block_mask()
        mask[::3] = False
        lay = BlockSparseLayout.from_block_mask(mask, (32, 128),
                                                shape=(m, k))
        for spec, use_bias, use_res in specs:
            tokens = ep_mod.normalize_spec(spec)
            bi = bias if use_bias else None
            rs = res if use_res else None
            want = bsr.block_sparse_matmul_plain(a, b, lay, bi, rs,
                                                 epilogue=tokens,
                                                 out_dtype=dtype)
            for sched in bsr.SCHEDULE_IDS:
                got = bsr.block_sparse_matmul_cuda(
                    a, b, lay, bi, rs, bn=BSR_BN, schedule=sched,
                    epilogue=tokens, out_dtype=dtype)
                torch.cuda.synchronize()
                check(f"block_sparse_matmul_{sched}", got, want, dtype,
                      f"{dn} {m}x{k}x{n} empty row blocks {spec}")
        del a, b, bias, res
    say(f"parity K9 bitwise equal to K1 at density 1.0 in {bitwise} cases")

    # the main path's shapes, bf16 in and out, at each candidate plan
    t = TUNE_TOTAL
    a, b, _, _ = _bsr_operands(torch, gen, t, t, t, torch.bfloat16)
    layouts = [BlockSparseLayout.random(t, t, (32, 128), d)
               for d in (0.25, 0.5)]
    layouts += [BlockSparseLayout.random(t, t, (128, 128), d)
                for d in TUNED_SUITE_DENSITIES]
    for lay in layouts:
        plans = {c.plan for c in planner.enumerate_sparse_plans(
            lay.summary(), t, chip="gpu_h100")}
        want = bsr.block_sparse_matmul_plain(a, b, lay,
                                             out_dtype=torch.bfloat16)
        for p in sorted(plans, key=lambda p: p.schedule):
            got = bsr.block_sparse_matmul_cuda(a, b, lay, bn=p.bn,
                                               schedule=p.schedule,
                                               out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            check(f"block_sparse_matmul_{p.schedule}", got, want,
                  torch.bfloat16, f"bf16 {t}^3 {lay.block_shape} "
                  f"d={lay.density:.3f} bn={p.bn}")
    del a, b
    torch.cuda.empty_cache()
    return errs


def phase_tune(torch) -> dict:
    """The tuner's main path: `repro_torch.launch.tune` (in process) for the
    sparse, fig5 and decode suites at --total 4096, then `tune_sparse` with
    the wall-clock measurer on the JAX tuned suite's (128, 128) summaries
    (the fail-over plan), then the explicit b_resident plan the planner
    never picks, and two `plan_mode="tuned"` lookups through `ops` that
    must hit the cache.  Counts are zeroed just before and read just
    after."""
    from repro_torch.core.config import mm_config
    from repro_torch.core.costmodel import BlockPlan
    from repro_torch.guard import health
    from repro_torch.kernels import block_sparse_matmul as bsr
    from repro_torch.kernels import ops
    from repro_torch.kernels import skew_matmul as mm
    from repro_torch.launch import tune as tune_cli
    from repro_torch.sparse import planner
    from repro_torch.sparse.layout import BlockSparseLayout, LayoutSummary
    from repro_torch.tune import calibrate, runtime, tuner
    from repro_torch.tune.cache import TuneCache

    t = TUNE_TOTAL
    path = ROOT / "build" / "tune" / "smoke_tune_cache.json"
    if path.exists():
        path.unlink()
    argv = ["--total", str(t), "--iters", str(TUNE_ITERS), "--repeats",
            str(TUNE_REPEATS), "--update-cache", "--cache", str(path),
            "--budget-s", "600"]
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    # ---- the main path: counts zeroed above, read after the last drive.
    for suite in ("sparse", "fig5", "decode"):
        if tune_cli.main(["--suite", suite] + argv) != 0:
            fail(f"launch.tune --suite {suite} failed")
    cache = TuneCache.load(str(path))
    tuned_suite = []
    for d in TUNED_SUITE_DENSITIES:
        summary = LayoutSummary.balanced(t, t, (128, 128), d)
        e = tuner.tune_sparse(summary, t, iters=TUNE_ITERS,
                              repeats=TUNE_REPEATS)
        cache.put(e)
        tuned_suite.append(e)
    cache.save(str(path))
    t_tune = time.perf_counter() - t0
    sparse_counts = ops.launch_counts()
    # every sparse candidate timed ran K9 once per call (one warm-up call
    # and iters x repeats timed ones)
    per = 1 + TUNE_ITERS * TUNE_REPEATS
    expect = dict.fromkeys(BSR_KERNELS, 0)
    sparse_entries = [e for e in cache.entries.values() if e.kind == "sparse"]
    for d in (0.25, 0.5):
        s = BlockSparseLayout.random(t, t, (32, 128), d).summary()
        for c in planner.enumerate_sparse_plans(s, t, top=4):
            expect[f"block_sparse_matmul_{c.plan.schedule}"] += per
    for d in TUNED_SUITE_DENSITIES:
        s = LayoutSummary.balanced(t, t, (128, 128), d)
        for c in planner.enumerate_sparse_plans(s, t):
            expect[f"block_sparse_matmul_{c.plan.schedule}"] += per
    got = {n: sparse_counts[n] for n in BSR_KERNELS}
    if got != expect:
        fail(f"K9 launches in the tuner {got}, expected {expect}")
    if len(sparse_entries) != 4 or len(cache.entries) != 4 + 5 + 3:
        fail(f"the cache holds {len(cache.entries)} entries "
             f"({len(sparse_entries)} sparse), expected 12 (4 sparse)")

    # b_resident: ported for parity, never planned; an explicit plan
    lay = BlockSparseLayout.random(t, t, (32, 128), 0.25)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(94)
    a, b, _, _ = _bsr_operands(torch, gen, t, t, t, torch.bfloat16)
    y = ops.sparse_matmul(a, b, lay, plan=BlockPlan(32, 128, BSR_BN,
                                                    "b_resident"))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(y).all()):
        fail("b_resident: non-finite output")

    # tuned lookups: one tuned layout, one fig5 shape
    runtime.set_active_cache(TuneCache.load(str(path)))
    m5, k5, n5 = tune_cli.fig5_shapes(t)[0]
    a5 = torch.randn((m5, k5), generator=gen, device="cuda").to(
        torch.bfloat16)
    b5 = (torch.randn((k5, n5), generator=gen, device="cuda")
          * k5 ** -0.5).to(torch.bfloat16)
    reset_health("before phase 4e's tuned lookups")
    with mm_config(plan_mode="tuned"):
        ys = ops.sparse_matmul(a, b, lay)
        yd = ops.skew_matmul(a5, b5)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # ---- end of the main path.
    hits, misses = health.get("tuned_hits"), health.get("tuned_misses")
    runtime.set_active_cache(None)
    if (hits, misses) != (2, 0):
        fail(f"tuned lookups: {hits} hits, {misses} misses (want 2, 0)")
    sp_entry = cache.get(next(k for k in cache.entries
                              if k.startswith("sparse")
                              and f"nnz{lay.nnz_total}s" in k))
    dn_entry = cache.get(next(k for k in cache.entries
                              if k.endswith(f"m{m5}k{k5}n{n5}b1")))
    errs: dict = {}
    check_kernel(torch, errs, f"block_sparse_matmul_{sp_entry.schedule}",
                 ys, bsr.block_sparse_matmul_plain(
                     a, b, lay, out_dtype=torch.bfloat16),
                 torch.bfloat16, f"tuned hit {sp_entry.key}")
    check_kernel(torch, errs, f"skew_matmul_{dn_entry.schedule}", yd,
                 mm.skew_matmul_plain(a5, b5, bk=dn_entry.blocks[1],
                                      out_dtype=torch.bfloat16),
                 torch.bfloat16, f"tuned hit {dn_entry.key}")
    say(f"tuned lookups: {hits} hits, {misses} misses; the sparse hit ran "
        f"{sp_entry.schedule} {sp_entry.blocks}, the fig5 hit "
        f"{dn_entry.schedule} {dn_entry.blocks}")

    entries = sorted(cache.entries.values(), key=lambda e: e.key)
    for e in entries:
        say(f"tune {e.key}: measured {e.measured_us:.1f} us, modeled "
            f"{e.modeled_us:.1f} us ({e.measured_us / e.modeled_us:.2f}x), "
            f"{e.schedule} {e.blocks}, agree={e.agreement} "
            f"speedup={e.speedup:.3f}")
    agree = sum(e.agreement for e in entries)
    corr = calibrate.fit_corrections(entries, "gpu_h100")
    say(f"tune: {len(entries)} entries in {t_tune:.1f} s, agreement "
        f"{agree}/{len(entries)}; calibration gpu_h100 time_frac="
        f"{corr.time_frac:.6g} sparse_gather_frac={corr.sparse_gather_frac} "
        f"log_spread={corr.log_spread:.3f} "
        f"{'accepted' if corr.accepted else 'rejected'} "
        f"(n_dense={corr.n_dense} n_sparse={corr.n_sparse})")
    say(f"K9 launches on the tune path: "
        f"{ {n: counts[n] for n in BSR_KERNELS} }")
    for name in BSR_KERNELS:
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the tune path")
    del a, b, a5, b5
    torch.cuda.empty_cache()
    return {"counts": counts, "errs": errs, "entries": entries,
            "corrections": corr}


def phase_timings_bsr(torch, counts, errs) -> list[dict]:
    """K9 at the tuner's sparse shapes (4096^2, (32, 128), d 0.25 / 0.5,
    n 4096) and at density 1.0: each schedule the planner offers (and
    b_resident by an explicit plan), the plain version, the
    bound, and `torch.matmul` of the pre-masked dense A (the dense work K9
    avoids; never on the port's path); then k_inner at the fail-over plan
    (128, 128, 64) on a (128, 128) d 0.4 layout.  At density 1.0 K1 at the
    dense planner's plan shows where the card's crossover lies."""
    from repro_torch.core.planner import plan_matmul
    from repro_torch.kernels import block_sparse_matmul as bsr
    from repro_torch.kernels import skew_matmul as mm
    from repro_torch.sparse import planner
    from repro_torch.sparse.layout import BlockSparseLayout

    t = TUNE_TOTAL
    gen = torch.Generator(device="cuda")
    gen.manual_seed(93)
    a, b, _, _ = _bsr_operands(torch, gen, t, t, t, torch.bfloat16)
    row = functools.partial(timing_row, torch, counts, errs)
    rows = []
    dense = plan_matmul(t, t, t, chip="gpu_h100").plan
    k1_ms = time_ms(torch, lambda: mm.skew_matmul_cuda(
        a, b, bm=dense.bm, bk=dense.bk, bn=dense.bn, schedule=dense.schedule,
        out_dtype=torch.bfloat16))
    say(f"time K1 {dense.schedule} {(dense.bm, dense.bk, dense.bn)} "
        f"{t}^3 bf16 (the dense planner's plan): {k1_ms:.4f} ms")
    for d in (0.25, 0.5, 1.0):
        lay = (BlockSparseLayout.random(t, t, (32, 128), d) if d < 1.0
               else BlockSparseLayout.dense(t, t, (32, 128)))
        s = lay.summary()
        masked = a * torch.as_tensor(lay.element_mask(), device="cuda").to(
            a.dtype)
        nbytes = 2 * (s.nnz_elems + t * t + t * t)
        flops = 2 * s.nnz_elems * t
        scheds = {c.plan.schedule: c.plan.bn for c in
                  planner.enumerate_sparse_plans(s, t, chip="gpu_h100")}
        scheds["b_resident"] = BSR_BN
        for sched, bn in scheds.items():
            rows.append(row(
                f"block_sparse_matmul_{sched}",
                lambda lay=lay, sched=sched, bn=bn:
                    bsr.block_sparse_matmul_cuda(a, b, lay, bn=bn,
                                                 schedule=sched,
                                                 out_dtype=torch.bfloat16),
                lambda lay=lay: bsr.block_sparse_matmul_plain(
                    a, b, lay, out_dtype=torch.bfloat16),
                lambda masked=masked: torch.matmul(masked, b),
                nbytes, flops,
                f"{t}^3 (32,128) d={lay.density:.3f} bn={bn}"))
        del masked
    # k_inner at the sparse planner's fail-over plan (128, 128, 64), the
    # one it takes at (128, 128) layouts: d 0.4 of the JAX tuned suite
    lay = BlockSparseLayout.random(t, t, (128, 128),
                                   TUNED_SUITE_DENSITIES[1])
    s = lay.summary()
    plan = planner.enumerate_sparse_plans(s, t, chip="gpu_h100")[0].plan
    masked = a * torch.as_tensor(lay.element_mask(), device="cuda").to(
        a.dtype)
    rows.append(row(
        f"block_sparse_matmul_{plan.schedule}",
        lambda: bsr.block_sparse_matmul_cuda(a, b, lay, bn=plan.bn,
                                             schedule=plan.schedule,
                                             out_dtype=torch.bfloat16),
        lambda: bsr.block_sparse_matmul_plain(a, b, lay,
                                              out_dtype=torch.bfloat16),
        lambda: torch.matmul(masked, b),
        2 * (s.nnz_elems + t * t + t * t), 2 * s.nnz_elems * t,
        f"{t}^3 (128,128) d={lay.density:.3f} bn={plan.bn}"))
    del a, b, masked
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- fig5
# Phase 6f: the paper's Figure 5 on the H100.  The 21 shapes of the JAX
# fig5 baseline: A of 4096^2 elements with its aspect (m / k) varied
# 2^-8..2^8 against n 4096; the output's aspect (m / n) varied the same
# at k 4096; decode rows m 1 / 4 / 8 against a 4096 x 32768 weight.
FIG5_TOTAL = 4096 * 4096
FIG5_RATIOS = tuple(2.0 ** i for i in range(-8, 9, 2))
FIG5_DECODE = ((1, 4096, 32768), (4, 4096, 32768), (8, 4096, 32768))
FIG5_PLANS = ("naive", "k_inner", "skew_aware")
# metric / info prefix of each timed plan (the JAX suite's names) and of
# the yardstick
FIG5_NAMES = {"naive": "naive", "k_inner": "single", "skew_aware": "planned",
              "splitk": "splitk", "torch": "torch"}


def fig5_shapes() -> list[tuple]:
    """(tag, vary, ratio, m, k, n) of the 21 rows, through the port's
    `sweep_aspect_ratios` on gpu_h100."""
    from repro_torch.core import planner
    out = []
    for vary, tag in (("a_aspect", "skew"), ("output", "oskew")):
        for r in planner.sweep_aspect_ratios(FIG5_TOTAL, FIG5_RATIOS,
                                             vary=vary, chip="gpu_h100"):
            out.append((f"{tag}_{r['ratio']:g}", vary, r["ratio"], r["m"],
                        r["k"], r["n"]))
    out += [(f"decode_m{m}", "decode", None, m, k, n)
            for m, k, n in FIG5_DECODE]
    return out


def fig5_operands(torch, gen, m: int, k: int, n: int, decode: bool):
    """Operand sets rotated so that the rotated operands pass twice the 50
    MB L2: at the decode rows copies of A alone (B, 256 MB, is read from
    device memory whatever is done), elsewhere whole (A, B) sets (A + B
    is 34-544 MB: one set, or up to three where it is under 100 MB).
    Returns (sets, next_set): next_set() steps the rotation."""
    a_bytes, b_bytes = 2 * m * k, 2 * k * n
    b = (torch.randn((k, n), generator=gen, device="cuda")
         * k ** -0.5).to(torch.bfloat16)
    if decode:
        copies = math.ceil(2 * L2_BYTES / a_bytes)
        a_all = torch.randn((copies, m, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
        sets = [(a_all[i], b) for i in range(copies)]
    else:
        copies = math.ceil(2 * L2_BYTES / (a_bytes + b_bytes))
        sets = [(torch.randn((m, k), generator=gen, device="cuda")
                 .to(torch.bfloat16),
                 b if i == 0 else b.clone()) for i in range(copies)]
    turn = itertools.count()
    return sets, lambda: sets[next(turn) % len(sets)]


def plan_label(cost) -> str:
    p = cost.plan
    return f"{p.bm}x{p.bk}x{p.bn}/{p.schedule}"


def phase_fig5(torch, errs) -> dict:
    """Phase 6f: for each of the 21 shapes, the naive, K-inner-only and
    skew-aware plans of the port's sweep on gpu_h100 (and at the decode
    rows the model's best split-K plan, which it does not choose: K3 +
    K4) through `ops.skew_matmul(plan=...)`, each held against the plain
    version at phase 3's tolerance, timed with CUDA events beside
    `torch.matmul` of the same product on the same rotation; modeled us,
    measured us and shares of 989 TFLOP/s recorded through
    `bench.suite.Recorder`, validated, written under build/ and read back
    equal.  The drives run with the launch counts zeroed just before each
    and read just after; checks and timings come after the read."""
    from repro_torch.bench import io as bench_io
    from repro_torch.bench.record import validate_records
    from repro_torch.bench.suite import Recorder
    from repro_torch.core import hw, planner, vertexstats
    from repro_torch.core.config import mm_config
    from repro_torch.core.costmodel import MatmulDims
    from repro_torch.kernels import ops
    from repro_torch.kernels import skew_matmul as mm

    chip = hw.get_chip("gpu_h100")
    budget = int(0.45 * chip.vmem_bytes)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    records: list = []
    rec = Recorder("fig5", records)
    counts: collections.Counter = collections.Counter()
    shares: dict = {}
    t0 = time.perf_counter()
    with mm_config(chip=chip):
        for tag, vary, ratio, m, k, n in fig5_shapes():
            flops = 2 * m * k * n
            plans = {mode: planner.plan_matmul(m, k, n, mode=mode)
                     for mode in FIG5_PLANS}
            if vary == "decode":
                sk = planner._search_gemv(MatmulDims(m, k, n), chip, budget)
                if sk is None:
                    fail(f"fig5 {tag}: no split-K plan fits the budget")
                plans["splitk"] = sk
            sets, next_set = fig5_operands(torch, gen, m, k, n,
                                           vary == "decode")
            a, b = sets[0]
            # ---- the drive: counts zeroed just before, read just after
            ops.reset_launch_counts()
            outs = {mode: ops.skew_matmul(a, b, plan=c.plan,
                                          out_dtype=torch.bfloat16)
                    for mode, c in plans.items()}
            torch.cuda.synchronize()
            counts.update(ops.launch_counts())
            # ---- end of the drive
            want = mm.skew_matmul_plain(
                a, b, bk=plans["skew_aware"].plan.bk,
                out_dtype=torch.bfloat16)
            for mode, got in outs.items():
                kname = ("gemv_splitk_reduce" if mode == "splitk" else
                         f"skew_matmul_{plans[mode].plan.schedule}")
                check_kernel(torch, errs, kname, got, want, torch.bfloat16,
                             f"fig5 {tag} {m}x{k}x{n} {mode} "
                             f"{plan_label(plans[mode])}")
            del outs, want
            us = {}
            for mode, c in plans.items():
                us[mode] = 1e3 * time_ms(torch, lambda p=c.plan: (
                    ops.skew_matmul(*next_set(), plan=p,
                                    out_dtype=torch.bfloat16)))
            us["torch"] = 1e3 * time_ms(torch, lambda: torch.matmul(
                *next_set()))
            del sets, a, b
            torch.cuda.empty_cache()
            share = {mode: flops / (t * 1e-6) / PEAK_BF16
                     for mode, t in us.items()}
            shares[tag] = share
            metrics = {"planned_frac": plans["skew_aware"].roofline_fraction(
                chip)}
            names = FIG5_NAMES
            for mode, c in plans.items():
                metrics[f"{names[mode]}_modeled_us"] = c.total_s * 1e6
            for mode, t in us.items():
                metrics[f"{names[mode]}_us"] = t
                metrics[f"{names[mode]}_share"] = share[mode]
            info = {f"{names[mode]}_plan": plan_label(c)
                    for mode, c in plans.items()}
            axes = {"chip": chip.name, "vary": vary, "m": m, "k": k, "n": n}
            if ratio is not None:
                axes["ratio"] = ratio
            rec(f"fig5_{chip.name}_{tag}", axes=axes, metrics=metrics,
                info=info, plan=plans["skew_aware"])
            say(f"fig5 {tag:12s} {m:>5}x{k:>5}x{n:>5}  modeled "
                + " / ".join(f"{plans[p].total_s * 1e6:.1f}"
                             for p in plans) + " us  measured "
                + " / ".join(f"{names[p]} {us[p]:.1f}" for p in us)
                + " us  share " + " / ".join(f"{share[p]:.3f}"
                                              for p in us)
                + "  plans " + " ".join(f"{names[p]}={plan_label(c)}"
                                        for p, c in plans.items()))
        for tag in ("skew", "oskew"):
            rows = [s for t, s in shares.items() if t.startswith(tag + "_")]
            metrics = {}
            for mode, name in (("skew_aware", "planned"), ("naive", "naive"),
                               ("torch", "torch")):
                vals = [s[mode] for s in rows]
                metrics[f"{name}_share_min"] = min(vals)
                metrics[f"{name}_share_max"] = max(vals)
                metrics[f"{name}_spread"] = max(vals) - min(vals)
                metrics[f"{name}_ratio_spread"] = max(vals) / min(vals)
            rec(f"fig5_{chip.name}_{tag}_spread", axes={"chip": chip.name},
                metrics=metrics)
            say(f"fig5 {tag} spread (max - min share; max / min): planned "
                f"{metrics['planned_spread']:.4f} "
                f"({metrics['planned_ratio_spread']:.3f}x), naive "
                f"{metrics['naive_spread']:.4f} "
                f"({metrics['naive_ratio_spread']:.3f}x), torch.matmul "
                f"{metrics['torch_spread']:.4f} "
                f"({metrics['torch_ratio_spread']:.3f}x)")
        for mode in ("naive", "skew_aware"):
            for v in vertexstats.paper_vertex_table(mode=mode):
                say(f"vertex gpu_h100 {mode:10s} (modeled) {v.row()} "
                    f"{v.schedule} {v.blocks}")
    validate_records(records)
    path = ROOT / "build" / "fig5_h100" / "BENCH_fig5_h100.json"
    written = bench_io.write_run(str(path), records, "full")
    _, back = bench_io.read_run(written[0])
    if [r.to_json() for r in back] != [r.to_json() for r in records]:
        fail("fig5 records did not read back equal")
    say(f"fig5: {len(records)} records validated, written to "
        f"{', '.join(written)} and read back equal; launches "
        f"{dict((n, c) for n, c in counts.items() if c)}; "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("skew_matmul_k_inner", "gemv_splitk_partial",
                 "gemv_splitk_reduce"):
        if counts[name] <= 0:
            fail(f"fig5: {name} was not launched")
    return {"counts": dict(counts), "records": records}


# ----------------------------------------------------------------- guard
# Phase 6g: the guard ladder and the obs spans on the card.  A ladder trip
# latches for the life of the process and its bottom rung is the plain
# PyTorch oracle, so every phase is bracketed by `guard_disarmed`: no
# floor above 0 and none of these counters, or the smoke fails.
GUARD_KEYS = ("fallbacks", "plans_rejected", "scrubbed_batches")
GUARD_PREFIXES = ("faults_", "obs_")
# The chaos ledgers of phase 6g: health.snapshot() and the ladder floor of
# each scenario on gpu_h100 with the "cuda" backend, as the CPU gives them
# (tests/test_torch_guard.py, GPU_H100_LEDGERS).  At 256 x 192 x 320 fp32
# the modeled plan is the minimum-granule (64, 64, 64) itself, which the
# squeezed validator admits; at 4 x 3072 x 16384 bf16 it is (64, 64, 128).
_ALL_FAULTS_FLOOR_PLAN = {
    "fallback_level": 3, "fallbacks": 3, "faults_caught": 8,
    "faults_injected": 8, "injected_cache_corrupt": 1,
    "injected_inf_output": 3, "injected_nan_output": 3,
    "injected_transient_raise": 1, "retries": 1, "tuned_misses": 1}
_ALL_FAULTS_TRIPPED = {
    "fallback_level": 3, "fallbacks": 3, "faults_caught": 6,
    "faults_injected": 6, "injected_amp_overflow": 2,
    "injected_cache_corrupt": 1, "injected_inf_output": 1,
    "injected_nan_output": 1, "injected_transient_raise": 1,
    "plans_rejected": 2, "retries": 1, "tuned_misses": 1}
_TRANSIENT = {"faults_caught": 2, "faults_injected": 2,
              "injected_transient_raise": 2, "retries": 2}
_AMP_TRIPPED = {"fallback_level": 2, "fallbacks": 1, "faults_caught": 1,
                "faults_injected": 1, "injected_amp_overflow": 1,
                "plans_rejected": 1}
_DECODE_MAMBA = {"faults_caught": 28, "faults_injected": 28,
                 "injected_inf_output": 14, "injected_nan_output": 14,
                 "scrubbed_batches": 1}
GPU_H100_LEDGERS = {
    ("all_faults", "256x192x320"): (_ALL_FAULTS_FLOOR_PLAN, 3),
    ("transient_recovers", "256x192x320"): (_TRANSIENT, 0),
    ("amp_overflow", "256x192x320"): ({}, 0),
    ("cache_quarantine", ""): ({}, 0),
    ("decode_scrub", "mamba2-2.7b reduced"): (_DECODE_MAMBA, 0),
    ("all_faults", "4x3072x16384"): (_ALL_FAULTS_TRIPPED, 3),
    ("transient_recovers", "4x3072x16384"): (_TRANSIENT, 0),
    ("amp_overflow", "4x3072x16384"): (_AMP_TRIPPED, 2),
    ("amp_overflow", "sparse"): (_AMP_TRIPPED, 2),
    ("amp_overflow", "grouped"): (_AMP_TRIPPED, 2),
}
# the drift workload of `launch.trace` on the card (fp32, skewmm.matmul)
TRACE_SIZE, TRACE_SKEW = 4096, 8
# host-clock dispatch overhead: calls timed a side at 8 x 256 x 512 bf16
OVERHEAD_CALLS = 2000


def guard_disarmed(tag: str) -> None:
    """Fail unless the guard is disarmed: no ladder floor above 0, and no
    fallbacks / plans_rejected / scrubbed_batches / faults_* / obs_*
    counter in the health snapshot."""
    from repro_torch.guard import fallback, faults, health
    from repro_torch.obs import spans
    snap = health.snapshot()
    bad = [k for k in snap if k in GUARD_KEYS or k.startswith(GUARD_PREFIXES)]
    if fallback.max_floor() or bad or faults.active() is not None \
            or spans.tracing():
        fail(f"guard engaged {tag}: max_floor {fallback.max_floor()}, "
             f"snapshot {snap}")


def guarded(tag: str, fn, *args, **kw):
    """Run one phase between two `guard_disarmed` checks."""
    guard_disarmed(f"before {tag}")
    out = fn(*args, **kw)
    guard_disarmed(f"after {tag}")
    return out


def reset_health(tag: str) -> None:
    """Zero the health ledger for the next run, failing first if it holds
    a guard counter (`guard_disarmed`): a reset never erases a fallback."""
    from repro_torch.guard import health
    guard_disarmed(tag)
    health.reset()


def chaos_case(torch, scenario: str, shape: str, call, want, expect_rung,
               expect_blocks, kernel: str, counts) -> None:
    """One chaos scenario at one site on the card: run under a bare trace
    (no clock: the dispatch span names the rung that delivered and the
    blocks of the last kernel run), its guard ledger (obs counters set
    apart) equal to the CPU's, the kernel launched, the output within
    phase 3's tolerance of the plain version."""
    from repro_torch.guard import chaos
    from repro_torch.kernels import ops
    from repro_torch.obs import trace_scope

    ops.reset_launch_counts()
    with trace_scope() as tr:
        r = chaos.run(lambda: (getattr(chaos, scenario)(call), {}))
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    counts.update(launched)
    ledger = {k: v for k, v in r.snapshot.items() if not k.startswith("obs_")}
    (disp,) = [sp for sp in tr.spans() if sp.kind == "dispatch"]
    rungs = [(sp.name, sp.attrs.get("error")) for sp in tr.spans()
             if sp.kind == "rung"]
    diff = (r.out.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = tolerance(str(want.dtype).split(".")[-1], scale)
    say(f"6g chaos {scenario:18s} {shape:14s} ledger {r.counters} floor "
        f"{r.floor}; rung {disp.attrs.get('rung')} blocks "
        f"{disp.attrs.get('blocks')}; rungs {rungs}; {kernel} launches "
        f"{launched.get(kernel, 0)}; max_abs_err {diff:.3e} tol {tol:.2e}")
    want_ledger, want_floor = GPU_H100_LEDGERS[(scenario, shape)]
    if (ledger, r.floor) != (want_ledger, want_floor):
        fail(f"6g {scenario} {shape}: ledger {ledger} floor {r.floor}, the "
             f"CPU's {want_ledger} floor {want_floor}")
    if not r.balanced or diff > tol:
        fail(f"6g {scenario} {shape}: unbalanced ledger or output off")
    if disp.attrs.get("rung") != expect_rung or launched.get(kernel, 0) < 1:
        fail(f"6g {scenario} {shape}: rung {disp.attrs.get('rung')} (want "
             f"{expect_rung}), {kernel} launches {launched.get(kernel, 0)}")
    if expect_blocks is not None and \
            tuple(disp.attrs.get("blocks", ())) != expect_blocks:
        fail(f"6g {scenario} {shape}: last kernel blocks "
             f"{disp.attrs.get('blocks')}, want {expect_blocks}")


def phase_guard_obs(torch, cfg, params) -> dict:
    """Phase 6g (the tenth main path): the guard ladder and the obs spans
    on the card, phi4-mini's weights still loaded."""
    import numpy as np

    from repro_torch import guard
    from repro_torch.configs.base import get_config
    from repro_torch.core import skewmm
    from repro_torch.core.config import mm_config
    from repro_torch.core.costmodel import BlockPlan
    from repro_torch.guard import chaos, fallback, faults, health
    from repro_torch.core import hw
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import skew_matmul as mm
    from repro_torch.models.model import build_model
    from repro_torch.obs import SimClock, WallClock, drift_report, \
        trace_scope
    from repro_torch.sparse.planner import plan_grouped_matmul
    from repro_torch.serve import engine, graphs
    from repro_torch.sparse.layout import BlockSparseLayout
    from repro_torch.tune.shapeclass import ShapeClass

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    counts: collections.Counter = collections.Counter()

    # ---- 1. chaos scenarios at the site level, CUDA tensors
    a = torch.linspace(-1.0, 1.0, 256 * 192, device=dev).reshape(256, 192)
    b = torch.linspace(1.0, -1.0, 192 * 320, device=dev).reshape(192, 320)
    g4 = torch.randn((4, cfg.d_model), generator=gen, device=dev).to(bf)
    w4 = (torch.randn((cfg.d_model, 16384), generator=gen, device=dev)
          * cfg.d_model ** -0.5).to(bf)
    floor = (64, 64, 64)
    for (x, y), shape in (((a, b), "256x192x320"), ((g4, w4), "4x3072x16384")):
        want = ref.matmul_epilogue_ref(x, y)
        call = (lambda x=x, y=y: ops.skew_matmul(x, y))
        chaos_case(torch, "all_faults", shape, call, want, "reference", floor,
                   "skew_matmul_k_inner", counts)
        chaos_case(torch, "transient_recovers", shape, call, want, "modeled",
                   None, "skew_matmul_k_inner", counts)
        chaos_case(torch, "amp_overflow", shape, call, want,
                   "modeled" if shape == "256x192x320" else "conservative",
                   floor, "skew_matmul_k_inner", counts)
    del w4
    # K9 at the tuner's (32, 128) layouts, d 0.1 (at d 0.25 / 0.5 the
    # modeled plan is already bn 64, the floor the validator admits)
    t = TUNE_TOTAL
    lay = BlockSparseLayout.random(t, t, (32, 128), 0.1, seed=0)
    sa = torch.randn((t, t), generator=gen, device=dev).to(bf)
    sb = (torch.randn((t, t), generator=gen, device=dev) * t ** -0.5).to(bf)
    chaos_case(torch, "amp_overflow", "sparse",
               lambda: ops.sparse_matmul(sa, sb, lay),
               ref.block_sparse_matmul_ref(sa, sb, lay), "conservative",
               (32, 128, 64), "block_sparse_matmul_k_inner", counts)
    del sa, sb
    # K5 at dbrx's decode gate/up expert GEMM
    dcfg = get_config("dbrx-132b")
    ga = torch.randn((dcfg.n_experts, 8, dcfg.d_model), generator=gen,
                     device=dev).to(bf)
    gb = (torch.randn((dcfg.n_experts, dcfg.d_model, dcfg.moe_d_ff),
                      generator=gen, device=dev)
          * dcfg.d_model ** -0.5).to(bf)
    chaos_case(torch, "amp_overflow", "grouped",
               lambda: ops.grouped_matmul(ga, gb),
               ref.grouped_matmul_ref(ga, gb), "conservative", floor,
               "grouped_matmul", counts)
    del ga, gb
    torch.cuda.empty_cache()
    rq = chaos.run(lambda: (None, chaos.cache_quarantine()))
    if (rq.snapshot, rq.floor) != GPU_H100_LEDGERS[("cache_quarantine", "")] \
            or rq.metrics["quarantined"] != 1:
        fail(f"6g cache_quarantine: {rq.metrics}")
    mcfg = get_config("mamba2-2.7b").reduced()
    mparams = build_model(mcfg, dev).init(0)
    mcache, _ = engine.prefill(mparams, mcfg,
                               torch.zeros((2, 8), dtype=torch.long,
                                           device=dev), max_len=16)
    ops.reset_launch_counts()
    rd = chaos.run(lambda: (chaos.decode_scrub(
        mparams, mcfg, mcache, torch.zeros((2,), dtype=torch.long,
                                           device=dev), 8), {}))
    counts.update(ops.launch_counts())
    say(f"6g chaos cache_quarantine ledger {rq.counters or '{}'} "
        f"{rq.metrics}; decode_scrub (mamba2-2.7b reduced) ledger "
        f"{rd.counters} floor {rd.floor}")
    if (rd.snapshot, rd.floor) != GPU_H100_LEDGERS[
            ("decode_scrub", "mamba2-2.7b reduced")] \
            or not bool(torch.isfinite(rd.out).all()):
        fail("6g decode_scrub (mamba2 reduced) off its CPU ledger")
    del mparams, mcache
    # a real fault stays loud: a scope is armed (the scrub engaged) with no
    # kind that fires at a kernel, and the kernels are fed an all-NaN lhs;
    # on the card that raises, moves no rung and never runs the oracle
    na = torch.full((64, 128), float("nan"), device=dev, dtype=bf)
    nb = torch.ones((128, 128), device=dev, dtype=bf)
    nga = torch.full((4, 16, 128), float("nan"), device=dev, dtype=bf)
    ngb = torch.ones((4, 128, 128), device=dev, dtype=bf)
    loud = {
        "dense ladder": lambda: ops.skew_matmul(na, nb),
        "dense explicit": lambda: ops.skew_matmul(
            na, nb, plan=BlockPlan(64, 64, 64)),
        "grouped ladder": lambda: ops.grouped_matmul(nga, ngb),
    }
    for site, call in loud.items():
        ops.reset_launch_counts()
        with faults.fault_scope(kinds=("tuner_outlier",)):
            try:
                call()
                raised = None
            except guard.NumericFault as e:
                raised = e
        torch.cuda.synchronize()
        launched = sum(ops.launch_counts().values())
        counts.update(ops.launch_counts())
        if raised is None or raised.injected or launched < 1 \
                or fallback.max_floor():
            fail(f"6g: a real NaN at the {site} did not raise "
                 f"NumericFault from a launched kernel ({launched} "
                 f"launches, floor {fallback.max_floor()})")
    say(f"6g real faults stay loud: an all-NaN lhs raises NumericFault at "
        f"{', '.join(loud)}; no rung moved")
    del na, nb, nga, ngb
    guard_disarmed("after 6g part 1")

    # ---- 2. the decode scrub at full width: phi4, batch 4 x prompt 128
    rng = np.random.default_rng(SERVE_SEED)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)),
                        dtype=torch.long, device=dev)
    cache, logits = engine.prefill(params, cfg, toks, max_len=144)
    nxt = torch.argmax(logits, -1)
    clean_cache = graphs.clone_cache(cache)
    want, _ = engine.decode_step(params, cfg, clean_cache, nxt, 128)
    ops.reset_launch_counts()
    guard.reset()
    with faults.fault_scope(kinds=("nan_output", "inf_output"), seed=5):
        got, _ = engine.guarded_decode_step(params, cfg, cache, nxt, 128)
    torch.cuda.synchronize()
    counts.update(ops.launch_counts())
    snap = health.snapshot()
    guard.reset()
    diff = (got - want).abs()
    rel_max = diff.max().item() / want.abs().max().item()
    rel_mean = diff.mean().item() / want.abs().mean().item()
    say(f"6g decode scrub phi4 b4 p128: ledger "
        + "/".join(f"{k}:{v}" for k, v in snap.items())
        + f"; re-run ('torch') ~ unarmed eager ('cuda') rel max "
          f"{rel_max:.3e} mean {rel_mean:.3e}")
    if snap.get("scrubbed_batches") != 1 or not bool(
            torch.isfinite(got).all()) or snap.get("faults_injected") != \
            snap.get("faults_caught"):
        fail(f"6g decode scrub: {snap}")
    if rel_max > PATH_TOL_MAX or rel_mean > PATH_TOL_MEAN:
        fail("6g decode scrub: the re-run is off phase 5's bounds")
    del cache, clean_cache
    guard_disarmed("after 6g part 2")

    # ---- 3. the disarmed path's cost (timing only: no counts kept)
    ha = torch.randn((8, 256), generator=gen, device=dev).to(bf)
    hb = torch.randn((256, 512), generator=gen, device=dev).to(bf)
    plan = BlockPlan(64, 64, 128)

    def host_us(fn) -> float:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OVERHEAD_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / OVERHEAD_CALLS * 1e6

    us_ops = host_us(lambda: ops.skew_matmul(ha, hb, plan=plan))
    us_mm = host_us(lambda: mm.skew_matmul(ha, hb, bm=64, bk=64, bn=128,
                                           out_dtype=bf))
    us_ops2 = host_us(lambda: ops.skew_matmul(ha, hb, plan=plan))
    # the ladder's disarmed cost at a site served with no plan (dbrx's
    # experts): plan lookup + validation + the kernel, beside the kernel
    gha = torch.randn((16, 8, 256), generator=gen, device=dev).to(bf)
    ghb = torch.randn((16, 256, 512), generator=gen, device=dev).to(bf)
    gblocks = ops.clip_blocks(plan_grouped_matmul(16, 8, 256, 512).plan,
                              8, 256, 512, hw.get_chip("gpu_h100"))
    us_gops = host_us(lambda: ops.grouped_matmul(gha, ghb))
    us_gmm = host_us(lambda: gmm.grouped_matmul(
        gha, ghb, bm=gblocks[0], bk=gblocks[1], bn=gblocks[2],
        out_dtype=bf))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = engine.prefill(params, cfg, toks, max_len=144)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    tok = torch.argmax(logits, -1)
    t0 = time.perf_counter()
    for i in range(16):
        lg, _ = engine.decode_step(params, cfg, cache, tok, 128 + i)
        tok = torch.argmax(lg, -1)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) / 16 * 1e3
    ops.reset_launch_counts()
    say(f"6g disarmed cost: ops.skew_matmul(plan=) {us_ops:.2f} / "
        f"{us_ops2:.2f} us a call, the wrapper _mm.skew_matmul {us_mm:.2f} "
        f"us (host clock, {OVERHEAD_CALLS} calls at 8x256x512 bf16); "
        f"ops.grouped_matmul (no plan: the ladder) {us_gops:.2f} us, the "
        f"wrapper _gmm.grouped_matmul {us_gmm:.2f} us (16x8x256x512 bf16, "
        f"blocks {gblocks}); phi4 eager prefill b4 p128 {pre_ms:.2f} ms, "
        f"eager decode {dec_ms:.2f} ms/token")
    del gha, ghb
    del cache
    guard_disarmed("after 6g part 3")

    # ---- 4. a traced graph capture replays bitwise as an unarmed one
    cache, logits = engine.prefill(params, cfg, toks, max_len=144)
    nxt = torch.argmax(logits, -1)
    other = graphs.clone_cache(cache)
    ops.reset_launch_counts()
    with trace_scope(clock=WallClock()) as tr:
        traced = graphs.DecodeGraph(params, cfg, cache, 4)
        built = tr.digest()
        steps_traced = [traced.step(nxt, 128 + i).clone() for i in range(4)]
        replayed = tr.digest()
    plain = graphs.DecodeGraph(params, cfg, other, 4)
    steps_plain = [plain.step(nxt, 128 + i).clone() for i in range(4)]
    torch.cuda.synchronize()
    counts.update(ops.launch_counts())
    same = all(torch.equal(x, y) for x, y in zip(steps_traced, steps_plain))
    say(f"6g traced capture: digest {built} after the warm-up and capture, "
        f"{replayed} after 4 replays; replays bitwise equal to an unarmed "
        f"graph's: {same}; launches a step {traced.launches_per_step}")
    if not same or built != replayed or not built.get("dispatch"):
        fail("6g: the traced capture's replays differ from the unarmed "
             "graph's, or replays emitted spans")
    if traced.launches_per_step != plain.launches_per_step:
        fail("6g: traced and unarmed graphs launch differently a step")
    del traced, plain, cache, other
    guard.reset()
    torch.cuda.empty_cache()
    guard_disarmed("after 6g part 4")

    # ---- 5. the cost model's drift on the H100
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.trace", "--mode",
         "matmul", "--clock", "wall", "--size", str(TRACE_SIZE), "--skew",
         str(TRACE_SKEW), "--check", "--quiet"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(SRC)})
    for line in proc.stdout.splitlines():
        say(f"6g {line}")
    if proc.returncode != 0:
        fail(f"launch.trace --clock wall --check failed "
             f"({proc.returncode}): {proc.stderr[-2000:]}")
    say(f"6g launch.trace subprocess: {time.perf_counter() - t0:.1f} s")
    shapes = fig5_shapes()
    operands = {}
    for tag, _, _, m, k, n in shapes:
        operands[tag] = (
            torch.randn((m, k), generator=gen, device=dev).to(bf),
            (torch.randn((k, n), generator=gen, device=dev)
             * k ** -0.5).to(bf))
        skewmm.matmul(*operands[tag])          # warm-up, untraced
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with trace_scope(clock=SimClock()):
        for tag, _, _, m, k, n in shapes:
            skewmm.matmul(*operands[tag])
    sim = drift_report()
    classes = {ShapeClass.of(m, k, n).token for _, _, _, m, k, n in shapes}
    if not sim["accepted"] or sim["max_abs_log"] != 0.0 \
            or set(sim["classes"]) != classes:
        fail(f"6g: the sim-clock drift report is not identically 0: {sim}")
    guard.reset()
    with trace_scope(clock=WallClock()) as tr:
        for _ in range(3):
            for tag, *_ in shapes:
                skewmm.matmul(*operands[tag])
    counts.update(ops.launch_counts())
    drift = drift_report()
    guard.reset()
    rows = {}
    for sp in tr.spans():
        if sp.kind == "dispatch":
            rows.setdefault(sp.attrs["shape_class"], []).append(
                (sp.modeled_us, sp.measured_us))
    for tag, _, _, m, k, n in shapes:
        cls = ShapeClass.of(m, k, n).token
        c = drift["classes"][cls]
        say(f"6g drift fig5 {tag:12s} {m:>5}x{k:>5}x{n:>5} class {cls}: "
            f"count {c['count']} modeled {rows[cls][0][0]:.1f} us measured "
            + "/".join(f"{x[1]:.1f}" for x in rows[cls])
            + f" us geomean_ratio {c['geomean_ratio']:.4f} max_abs_log "
              f"{c['max_abs_log']:.4f} accepted {c['accepted']}")
    say(f"6g drift: sim clock {sim['classes_total']} classes, max_abs_log "
        f"{sim['max_abs_log']}; wall clock {drift['classes_total']} classes, "
        f"{drift['classes_accepted']} accepted, max_abs_log "
        f"{drift['max_abs_log']:.4f} (MAX_LOG_SPREAD ln 4)")
    del operands
    torch.cuda.empty_cache()
    guard.reset()
    for name in ("skew_matmul_k_inner", "grouped_matmul",
                 "block_sparse_matmul_k_inner"):
        if counts[name] <= 0:
            fail(f"6g: {name} was not launched")
    say(f"6g: launches {dict((n, c) for n, c in counts.items() if c)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": dict(counts)}


# ----------------------------------------------------------------- sched
# Phase 6h: the continuous-batching scheduler on the card (phi4-mini's
# weights still loaded).  The bucket table of a workload of up to 8 live
# requests, prompts of up to 128 tokens and 16 new tokens each; a scripted
# stream of 24 requests arriving in bursts of three that hits every prompt
# bucket and grows the slab 1 -> 8.
SCHED_TABLE = dict(max_batch=8, max_prompt=128, max_new=16, min_prompt=16)
SCHED_REQUESTS, SCHED_SEED = 24, 0


def sched_entries() -> list[tuple[int, int, int]]:
    """(arrival tick, prompt length, max_new) of the phase 6h stream."""
    return [(i // 3, 3 + (37 * i) % 126, 1 + (7 * i) % 16)
            for i in range(SCHED_REQUESTS)]


def plan_sig(log) -> list[tuple]:
    """Each planned site's (schedule, blocks, batch grid), in call order:
    equal signatures run the same kernels at the same blocks (a split-K
    plan's splits follow from its bk and the site's k)."""
    return [(c.plan.schedule, c.plan.bm, c.plan.bk, c.plan.bn,
             c.plan.batch_grid) for c in log]


def sched_run(torch, params, cfg, table, reqs, *, graphs_on: bool,
              trace: bool, timed: bool) -> dict:
    """One scheduler run over `reqs` under the active tuned cache: the
    scheduler, the health ledger it left (reset just before, once
    `reset_health` found no guard counter in it), the ladder's floor, and
    with `timed` each tick's host ms (a synchronise on each side), whether
    it prefilled and the slab's batch at that tick."""
    from repro_torch.guard import fallback, health
    from repro_torch.serve.sched import Scheduler

    reset_health("before a 6h scheduler run")
    sched = Scheduler(params, cfg, table, trace_logits=trace,
                      decode_graphs=graphs_on)
    for r in reqs:
        sched.submit(r)
    ticks = []
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    for _ in range(200):
        if not sched.queue and not sched.live:
            break
        pre, caps = sched.telemetry.prefill_batches, len(sched.captures)
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.step()
        if timed:
            torch.cuda.synchronize()
            ticks.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "prefill": sched.telemetry.prefill_batches > pre,
                          "captured": len(sched.captures) > caps,
                          "batch": sched.slab_batch})
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    sched.telemetry.record_health()
    return {"sched": sched, "ledger": health.snapshot(), "ticks": ticks,
            "floor": fallback.max_floor(), "s": run_s}


# The kernel wrappers of the served path, by module: the dispatchers that
# `kernels.ops` calls (K1's three schedules, K2, K3 + K4, K7).
TAPPED = (("skew_matmul", "skew_matmul"), ("skew_matmul", "skew_matmul_batched"),
          ("gemv_splitk", "gemv_splitk"), ("flash_attention", "flash_attention"))


def _arg_key(x):
    if hasattr(x, "shape"):
        return (tuple(x.shape), tuple(x.stride()), str(x.dtype))
    return repr(x)


def tap_kernels(seen: dict):
    """A context in which each distinct call of the served path's kernel
    wrappers (`TAPPED`) leaves its arguments in `seen`, keyed by the
    wrapper, the operands' shapes, strides and dtypes and the keyword
    arguments (blocks, schedule, epilogue, out dtype).  The operands are
    kept by reference, not copied; the wrappers run as ever."""
    import contextlib
    import importlib

    @contextlib.contextmanager
    def scope():
        saved = []
        for mod_name, fn_name in TAPPED:
            mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
            fn = getattr(mod, fn_name)
            saved.append((mod, fn_name, fn))

            def call(*args, _fn=fn, _name=fn_name, **kw):
                key = (_name, tuple(_arg_key(x) for x in args),
                       tuple(sorted((k, _arg_key(v)) for k, v in kw.items())))
                seen.setdefault(key, (args, kw))
                return _fn(*args, **kw)

            setattr(mod, fn_name, call)
        try:
            yield seen
        finally:
            for mod, fn_name, fn in saved:
                setattr(mod, fn_name, fn)

    return scope()


def served_parity(torch, errs: dict, seen: dict) -> collections.Counter:
    """Each call in `seen` (`tap_kernels`) again through its kernel on the
    card and its plain version, held within phase 3's tolerance; returns
    the calls held, by kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemv_splitk as gk
    from repro_torch.kernels import skew_matmul as mm

    held = collections.Counter()
    check = functools.partial(check_kernel, torch, errs)
    for (name, shapes, _), (args, kw) in seen.items():
        tag = f"6h served {'x'.join(str(d) for d in shapes[0][0])}"
        if name == "flash_attention":
            q = args[0]
            got = fa.flash_attention_cuda(*args, **kw)
            want = fa.flash_attention_plain(*args, **kw)
            check("flash_attention", got, want, q.dtype,
                  f"{tag} kv {tuple(args[1].shape)}")
            held["flash_attention"] += 1
            continue
        a, b, bias, res = (list(args) + [None, None])[:4]
        bias, res = kw.pop("bias", bias), kw.pop("residual", res)
        ep, odt = kw.get("epilogue"), kw.get("out_dtype", torch.float32)
        tag += (f" @ {tuple(b.shape)} {[t for t, _ in ep or ()]} blocks "
                f"{(kw['bm'], kw['bk'], kw['bn'])}")
        if name == "gemv_splitk":
            slab = gk.gemv_splitk_partial_cuda(a, b, bm=kw["bm"], bk=kw["bk"],
                                               bn=kw["bn"])
            slab_want = gk.gemv_splitk_partial_plain(a, b, bk=kw["bk"])
            check("gemv_splitk_partial", slab, slab_want, torch.float32, tag)
            got = gk.gemv_splitk_reduce_cuda(slab_want, bias, res,
                                             epilogue=ep, out_dtype=odt)
            want = gk.gemv_splitk_reduce_plain(slab_want, bias, res,
                                               epilogue=ep, out_dtype=odt)
            check("gemv_splitk_reduce", got, want, odt, tag)
            held.update(("gemv_splitk_partial", "gemv_splitk_reduce"))
        elif name == "skew_matmul_batched":
            got = mm.skew_matmul_batched_cuda(a, b, bias, res, **kw)
            want = mm.skew_matmul_batched_plain(a, b, bias, res, bk=kw["bk"],
                                                epilogue=ep, out_dtype=odt)
            check("skew_matmul_batched", got, want, odt, tag)
            held["skew_matmul_batched"] += 1
        else:
            kname = f"skew_matmul_{kw.get('schedule', 'k_inner')}"
            got = mm.skew_matmul_cuda(a, b, bias, res, **kw)
            want = mm.skew_matmul_plain(a, b, bias, res, bk=kw["bk"],
                                        epilogue=ep, out_dtype=odt)
            check(kname, got, want, odt, tag)
            held[kname] += 1
        torch.cuda.synchronize()
    return held


def tick_ms(ticks, *, prefill: bool, batch: int | None = None) -> list:
    """Host ms of the ticks that prefilled (or only decoded, at `batch`),
    leaving out ticks that captured a decode graph."""
    return [t["ms"] for t in ticks if t["prefill"] == prefill
            and not t["captured"] and (batch is None or t["batch"] == batch)]


def copy_tree(dst, src) -> None:
    """Copy a cache tree (dicts of tensors) into one of the same shape."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            copy_tree(v, src[k])
    else:
        dst.copy_(src)


def _median(xs) -> float:
    xs = sorted(xs)
    if not xs:
        return float("nan")
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2


def phase_sched(torch, cfg, params, errs: dict) -> dict:
    """Phase 6h (the eleventh main path): phi4-mini served at full width
    from a scripted request stream by the continuous-batching scheduler,
    under a tune cache measured on the card.  Counts are zeroed just
    before and read just after; every kernel is then held against its
    plain version at each call the stream served (largest error into
    `errs`)."""
    import numpy as np

    from repro_torch.core import skewmm
    from repro_torch.core.config import mm_config
    from repro_torch.kernels import ops
    from repro_torch.serve import engine, graphs
    from repro_torch.serve.sched import (BucketTable, assert_covered,
                                         build_tuned_cache,
                                         capture_gemm_specs,
                                         modeled_step_seconds,
                                         scripted_trace)
    from repro_torch.serve.sched.buckets import (decode_gemm_specs,
                                                 gemv_decode_coverage,
                                                 step_plans)
    from repro_torch.tune import runtime, tuner
    from repro_torch.tune.cache import dense_key
    from repro_torch.tune.shapeclass import ShapeClass

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    # ---- the main path: counts zeroed above, read after the last drive.
    # 1. the table
    table = BucketTable.for_workload(**SCHED_TABLE)
    if (table.batch_buckets, table.prompt_buckets, table.max_len) != (
            (1, 2, 4, 8), (16, 32, 64, 128), 144):
        fail(f"6h: bucket table {table}")
    # 2. the capture: meta tensors, no launch, no device memory.  Earlier
    # phases' garbage is collected first and the collector held off during
    # the capture, so that freeing it cannot move the reading.
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    launched0 = sum(ops.launch_counts().values())
    t0 = time.perf_counter()
    gc.disable()
    try:
        specs = capture_gemm_specs(params, cfg, table)
        dspecs = decode_gemm_specs(params, cfg, table)
    finally:
        gc.enable()
    capture_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = sum(ops.launch_counts().values()) - launched0
    mem1 = torch.cuda.memory_allocated()
    if launched or mem1 != mem0:
        fail(f"6h: the GEMM-spec capture launched {launched} kernels and "
             f"moved the allocated device memory {mem0} -> {mem1} bytes")
    say(f"6h capture: {len(specs)} GEMM specs ({len(dspecs)} of the decode "
        f"steps) in {capture_s:.2f} s; no launch, device memory unchanged "
        f"({mem0} bytes)")

    # 3. the tune cache, measured on the card (phase 4e's iters / repeats)
    def measurer(candidate, make_bench, *, iters, repeats):
        del iters, repeats
        return tuner.wallclock_measurer(candidate, make_bench,
                                        iters=TUNE_ITERS,
                                        repeats=TUNE_REPEATS)

    t0 = time.perf_counter()
    cache = build_tuned_cache(params, cfg, table, measurer=measurer)
    tune_s = time.perf_counter() - t0
    assert_covered(cache, specs)
    entries = list(cache.entries.values())
    n_split = sum(e.schedule == "splitk" for e in entries)
    agree = sum(e.agreement for e in entries) / len(entries)
    cov = gemv_decode_coverage(cache, dspecs)
    say(f"6h tune: {len(entries)} entries measured on the card "
        f"({n_split} split-K), agreement with the model "
        f"{agree:.3f}, {tune_s:.1f} s; decode coverage {cov}")
    for spec in dspecs:
        _, m, k, n, batch, db = spec
        e = cache.get(dense_key("gpu_h100", db, 0.45,
                                ShapeClass.of(m, k, n, batch)))
        say(f"6h tuned decode {m}x{k}x{n} b{batch}: {e.schedule} "
            f"{e.blocks}{' batch-grid' if e.batch_grid else ''} measured "
            f"{e.measured_us:.1f} us (modeled best {e.modeled_best_schedule} "
            f"{e.modeled_best_blocks} {e.modeled_best_measured_us:.1f} us, "
            f"speedup {e.speedup:.3f})")

    # 4.-5. serve the stream through the decode graphs (timed), then
    # graphed and eager again with every logit row kept (timed too; each
    # tick then also copies its logits to the host)
    reqs = scripted_trace(sched_entries(), vocab_size=cfg.vocab_size,
                          seed=SCHED_SEED)
    with runtime.use_cache(cache), mm_config(plan_mode="tuned"):
        before = ops.launch_counts()
        with skewmm.plan_capture() as served_log:
            g_run = sched_run(torch, params, cfg, table, reqs,
                              graphs_on=True, trace=False, timed=True)
        served = {k: v - before[k] for k, v in ops.launch_counts().items()}
        g_tr = sched_run(torch, params, cfg, table, reqs, graphs_on=True,
                         trace=True, timed=True)
        e_tr = sched_run(torch, params, cfg, table, reqs, graphs_on=False,
                         trace=True, timed=True)
    counts = ops.launch_counts()
    # ---- end of the main path.
    gs = g_run["sched"]
    summary = gs.telemetry.summary()
    ledger = {k: v for k, v in g_run["ledger"].items()
              if k.startswith("tuned_")}
    say("6h serve: " + ", ".join(f"{k}={v:g}" for k, v in
                                 sorted(summary.items())))
    say(f"6h serve: tuned ledger {ledger}; slab buckets {gs.slab_history}; "
        f"captures " + ", ".join(f"b{c['batch']} {c['ms']:.1f} ms"
                                 for c in gs.captures))
    if len(gs.results) != len(reqs) or any(
            len(gs.results[r.rid]["tokens"]) != r.max_new for r in reqs):
        fail("6h: not every request completed with its full budget")
    if ledger.get("tuned_misses", 0) or not ledger.get("tuned_hits"):
        fail(f"6h: tuned ledger {ledger} (misses must be 0)")
    if any(run["floor"] for run in (g_run, g_tr, e_tr)):
        fail("6h: a ladder floor moved")
    hist = gs.slab_history
    if hist[-1] != table.batch_buckets[-1] or hist != sorted(set(hist)):
        fail(f"6h: the slab grew {hist}, expected a rising run to "
             f"{table.batch_buckets[-1]}")
    if [c["batch"] for c in gs.captures] != hist:
        fail(f"6h: decode graphs captured at {gs.captures}, the slab at "
             f"{hist}: one capture a bucket the slab reached")
    used = {"flash_attention"}
    for c in served_log:
        if not hasattr(c, "plan"):
            continue
        if c.plan.schedule == "splitk":
            used |= {"gemv_splitk_partial", "gemv_splitk_reduce"}
        elif c.plan.batch_grid and c.dims.batch > 1:
            used.add("skew_matmul_batched")
        else:
            used.add(f"skew_matmul_{c.plan.schedule}")
    for name in sorted(used):
        if served.get(name, 0) <= 0:
            fail(f"6h: kernel {name} was not launched by the served stream")
    say(f"6h served stream launches: "
        f"{dict((k, v) for k, v in served.items() if v)}")
    gt = g_run["ticks"]
    pre_ms = tick_ms(gt, prefill=True)
    dec_ms = tick_ms(gt, prefill=False)
    toks_s = summary["tokens_out"] / g_run["s"]
    say(f"6h host ms a tick (synchronised; capture ticks left out): "
        f"prefill ticks median {_median(pre_ms):.2f} "
        f"({len(pre_ms)} ticks, {min(pre_ms, default=0):.2f}-"
        f"{max(pre_ms, default=0):.2f}), decode-only ticks median "
        f"{_median(dec_ms):.2f} ({len(dec_ms)} ticks, "
        f"{min(dec_ms, default=0):.2f}-{max(dec_ms, default=0):.2f}); "
        f"{summary['tokens_out']:g} tokens in {g_run['s'] * 1e3:.1f} ms "
        f"= {toks_s:.1f} tokens/s (captures included)")
    for run, what in ((g_tr, "graphed"), (e_tr, "eager")):
        d, p = (tick_ms(run["ticks"], prefill=False),
                tick_ms(run["ticks"], prefill=True))
        say(f"6h {what} run keeping its logits: decode-only ticks median "
            f"{_median(d):.2f} ms ({len(d)} ticks), prefill ticks median "
            f"{_median(p):.2f} ms; {run['s'] * 1e3:.1f} ms = "
            f"{summary['tokens_out'] / run['s']:.1f} tokens/s")

    # 5. graphed against eager: results, telemetry, ledger, logits
    for a, b, what in ((g_tr, e_tr, "graphed and eager"),
                       (g_run, g_tr, "graphed")):
        sa, sb = a["sched"], b["sched"]
        la = {k: v for k, v in a["ledger"].items() if k.startswith("tuned_")}
        lb = {k: v for k, v in b["ledger"].items() if k.startswith("tuned_")}
        if sa.results != sb.results or la != lb or \
                sa.telemetry.summary() != sb.telemetry.summary():
            fail(f"6h: {what} runs differ in results, telemetry or ledger "
                 f"({la} vs {lb})")
    rows = 0
    for rid, got in g_tr["sched"].logit_trace.items():
        want = e_tr["sched"].logit_trace[rid]
        if len(got) != len(want) or not all(
                np.array_equal(x, y) for x, y in zip(got, want)):
            fail(f"6h: request {rid}: graphed logits not bitwise equal to "
                 f"eager")
        rows += len(got)
    say(f"6h graphed = eager: results, telemetry, tuned ledger equal; "
        f"{rows} logit rows bitwise equal")

    # 5b. every kernel at each (shape, blocks, schedule, epilogue) the
    # stream served, against its plain version on the operands it was
    # served: an eager run of the same trace leaves each distinct call's
    # arguments (graphed = eager above, so these are the replays' calls
    # too).  After the counts were read: these launches are not counted.
    seen: dict = {}
    with runtime.use_cache(cache), mm_config(plan_mode="tuned"), \
            tap_kernels(seen):
        sched_run(torch, params, cfg, table, reqs, graphs_on=False,
                  trace=False, timed=False)
    held = served_parity(torch, errs, seen)
    missing = sorted(k for k, v in served.items() if v and not held[k])
    if missing:
        fail(f"6h: kernels the stream launched that no served call held "
             f"against its plain version: {missing}")
    say(f"6h served calls against their plain versions: {len(seen)} "
        f"distinct calls, by kernel {dict(sorted(held.items()))}")
    del seen

    # 6. join and leave: each request against a teacher-forced solo run
    st = g_tr["sched"]
    n_same = n_tol = 0
    worst = (0.0, 0.0)
    with runtime.use_cache(cache), mm_config(plan_mode="tuned"):
        sig = {}

        def sig_of(batch, prompt=None):
            key = (batch, prompt)
            if key not in sig:
                sig[key] = plan_sig(step_plans(params, cfg, batch,
                                               table.max_len, prompt=prompt))
            return sig[key]

        solo_cache = None
        solo_graph = None
        for r in reqs:
            pb = table.prompt_bucket(r.prompt_len)
            toks = torch.zeros((1, pb), dtype=torch.long, device="cuda")
            toks[0, :r.prompt_len] = torch.tensor(r.tokens, device="cuda")
            cache_1, lg = engine.prefill(
                params, cfg, toks, max_len=table.max_len,
                last_index=torch.tensor([r.prompt_len - 1], device="cuda"))
            want = [lg[0].float().cpu().numpy()]
            if solo_graph is None:
                solo_cache = cache_1
                solo_graph = graphs.DecodeGraph(params, cfg, solo_cache, 1,
                                                per_row_pos=True)
            else:
                copy_tree(solo_cache, cache_1)
            del cache_1
            tokens = st.results[r.rid]["tokens"]
            for j in range(r.max_new - 1):
                out = solo_graph.step(
                    torch.tensor([tokens[j]], device="cuda"),
                    torch.tensor([r.prompt_len + j], dtype=torch.int32,
                                 device="cuda"))
                want.append(out[0].to("cpu", torch.float32,
                                      copy=True).numpy())
            got = st.logit_trace[r.rid]
            batches = st.logit_batches[r.rid]
            for j, (x, y) in enumerate(zip(got, want)):
                prompt = pb if j == 0 else None
                same_plans = sig_of(batches[j], prompt) == sig_of(1, prompt)
                if same_plans:
                    n_same += 1
                    if not np.array_equal(x, y):
                        d = np.abs(x - y)
                        fail(f"6h: request {r.rid} row {j} (batch "
                             f"{batches[j]}, plans equal to the solo run's) "
                             f"not bitwise equal: max|diff| {d.max():.3e}")
                else:
                    n_tol += 1
                    d = np.abs(x - y)
                    rel_max = d.max() / np.abs(y).max()
                    rel_mean = d.mean() / np.abs(y).mean()
                    worst = (max(worst[0], rel_max), max(worst[1], rel_mean))
                    if rel_max > PATH_TOL_MAX or rel_mean > PATH_TOL_MEAN:
                        fail(f"6h: request {r.rid} row {j} (batch "
                             f"{batches[j]}) past phase 5's bounds: rel max "
                             f"{rel_max:.3e}, mean {rel_mean:.3e}")
        del solo_graph, solo_cache
    say(f"6h join/leave: {n_same} rows whose batched and solo calls plan "
        f"every site alike, bitwise equal; {n_tol} rows where a plan "
        f"differs, within phase 5's bounds (worst rel max {worst[0]:.3e}, "
        f"mean {worst[1]:.3e}); plan signatures differ at "
        + ", ".join(f"b{b}{'' if p is None else f' p{p}'}"
                    for (b, p) in sorted(sig, key=str) if b != 1
                    and sig[(b, p)] != sig_of(1, p)))

    # 7. the serving-level cost model against the card: at each batch
    # bucket B, B requests arriving together (prompt 16, 16 tokens each)
    # decode 15 ticks at batch B
    # `modeled_step_seconds` sums the plans an abstract step records: one
    # repeat of each stage (as the JAX package's, whose lax.scan traces
    # its body once).  phi4 is one stage of identical layers and the LM
    # head, so the whole depth is the layer sites times the repeats.
    ((_, reps),) = cfg.stage_list()
    for b in table.batch_buckets:
        modeled = modeled_step_seconds(params, cfg, b, table.max_len,
                                       chip="gpu_h100") * 1e3
        with mm_config(chip="gpu_h100"):
            costs = [c.total_s for c in step_plans(params, cfg, b,
                                                   table.max_len)]
        whole = (sum(costs[:-1]) * reps + costs[-1]) * 1e3
        solo = scripted_trace([(0, 16, table.max_new)] * b,
                              vocab_size=cfg.vocab_size, seed=SCHED_SEED)
        with runtime.use_cache(cache), mm_config(plan_mode="tuned"):
            run = sched_run(torch, params, cfg, table, solo, graphs_on=True,
                            trace=False, timed=True)
        meas = tick_ms(run["ticks"], prefill=False, batch=b)
        say(f"6h decode b{b}: measured {_median(meas):.2f} ms a decode-only "
            f"tick (graphed, median of {len(meas)}, "
            f"{min(meas):.2f}-{max(meas):.2f}); modeled gpu_h100 "
            f"modeled_step_seconds {modeled:.4g} ms (one layer a stage), "
            f"all {cfg.n_layers} layers {whole:.4g} ms (measured / modeled "
            f"{_median(meas) / whole:.2f})")
    bmax = table.batch_buckets[-1]
    rate = {chip: bmax / modeled_step_seconds(params, cfg, bmax,
                                              table.max_len, chip=chip)
            for chip in ("ipu_gc200", "gpu_rtx2080ti", "gpu_h100")}
    say(f"6h modeled decode tokens/s at batch {bmax}: "
        + ", ".join(f"{c}={v:.0f}" for c, v in rate.items())
        + f" (gc200/rtx2080ti = "
          f"{rate['ipu_gc200'] / rate['gpu_rtx2080ti']:.2f}x)")

    # 8. the scheduler's launchers, each in a process of its own (both
    # started together)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = [(argv, subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for argv in (["repro_torch.launch.serve_bench", "--tiny"],
                     ["repro_torch.launch.trace", "--mode", "serve",
                      "--check", "--quiet"])]
    for argv, proc in procs:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
            fail(f"6h: python -m {' '.join(argv)} did not end in 300 s")
        tail = out.strip().splitlines()[-3:]
        say(f"6h python -m {' '.join(argv)}: exit {proc.returncode} "
            f"({time.perf_counter() - t0:.1f} s after the start); "
            + " | ".join(tail))
        if proc.returncode != 0:
            print(err[-4000:], flush=True)
            for _, p in procs:
                p.kill()
            fail(f"6h: python -m {' '.join(argv)} exited "
                 f"{proc.returncode}")
    reset_health("at the end of 6h")
    torch.cuda.empty_cache()
    say(f"6h: launches {dict((n, c) for n, c in counts.items() if c)}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts}


# ----------------------------------------------------------------- MLA
def mla_layer_ops(cfg, kind: str, p, tokens: int) -> tuple[float, int]:
    """(bf16 operations, weight elements) of one layer's planned matmuls
    for `tokens` tokens: 2 a token and weight element of every tensor of
    two or more dims (MLA's five projections, the dense MLP or the router
    and shared expert), and, for an MoE layer, its three expert GEMMs
    over all E x capacity slots."""
    from repro_torch.models import moe
    w = 0
    for name, t in p.items():
        if name == "moe":   # the expert stacks run per capacity slot
            t = {k: x for k, x in t.items() if not k.startswith("w_")}
        w += sum(x.numel() for x in _leaves(t) if x.dim() >= 2)
    ops_ = 2 * tokens * w
    if kind.endswith("_moe"):
        ops_ += 3 * 2 * cfg.n_experts * moe._capacity(tokens, cfg) \
            * cfg.d_model * cfg.moe_d_ff
    return ops_, w


def mla_serve_bounds(cfg, params, batch: int, prompt: int,
                     kv_bytes: int) -> tuple[float, float]:
    """(prefill bound ms, decode bound ms per token) of the MLA serve.

    Bytes: every weight the step reads (all but the input embedding, of
    which only the token rows are read, and the MTP head, which serving
    never runs), plus the latent cache at decode.  Operations
    (`mla_layer_ops`) at the bf16 rate, plus attention: at prefill
    2 * (nope + rope + v) per visible (row, col) pair and head; at decode
    the absorbed form's fp32 scores and latent context, 2 * (2 kvr + rope)
    per valid position and head, at the fp32 rate; and the LM head on the
    last positions."""
    from repro_torch.models import transformer
    from repro_torch.models.model import param_bytes
    d, v, h = cfg.d_model, cfg.vocab_size, cfg.n_heads
    qk, vd = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    kvr, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
    pre_ops = dec_ops = 2 * batch * d * v
    for kind, p, *_ in transformer.layer_iter(params, cfg):
        pre_ops += mla_layer_ops(cfg, kind, p, batch * prompt)[0]
        dec_ops += mla_layer_ops(cfg, kind, p, batch)[0]
    pre_ops += cfg.n_layers * 2 * (qk + vd) * h * batch * visible_pairs(
        prompt, None)
    dec_f32 = cfg.n_layers * 2 * (2 * kvr + rd) * h * batch * (prompt + 1)
    emb = params["embed"]
    row = emb.shape[1] * emb.element_size()
    read = param_bytes(params) - emb.shape[0] * row - param_bytes(
        params.get("mtp", {}))
    pre = max(pre_ops / PEAK_BF16, (read + batch * prompt * row) / HBM_BW)
    dec = max(dec_ops / PEAK_BF16 + dec_f32 / PEAK_FP32,
              (read + batch * row + kv_bytes) / HBM_BW)
    return pre * 1e3, dec * 1e3


def phase_serve_mla(torch, cfg, of_layers: int):
    """deepseek-v3-671b at every published width, depth cut to
    `cfg.n_layers` of `of_layers` (its size checked against the card on
    the meta device first), served b4 p128 g16 through `serve(cfg=...)`:
    K5 3 launches an MoE layer a step (prefill, warm-up, replays), K7 one
    per layer of the prefill and none at decode, every planned kernel
    launched; graphed decode against eager within phase 5's bounds (the
    MoE combine's `index_add_` has no fixed order)."""
    from repro_torch.core import skewmm
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model, param_bytes
    from repro_torch.serve import kvcache

    whole = param_bytes(transformer.init_lm(
        dataclasses.replace(cfg, n_layers=of_layers), None, "meta"))
    cut = param_bytes(transformer.init_lm(cfg, None, "meta"))
    room = torch.cuda.get_device_properties(0).total_memory - DENSE_RESERVE
    say(f"{cfg.name}: {whole / 1e9:.1f} GB of bf16 weights at all "
        f"{of_layers} layers; cut to {cfg.n_layers} layers "
        f"({cfg.first_k_dense} dense + {cfg.n_layers - cfg.first_k_dense} "
        f"MoE, the MTP head kept): {cut / 1e9:.3f} GB, the card holds "
        f"{room / 1e9:.1f} GB beside {DENSE_RESERVE / 1e9:.0f} GB for "
        f"caches and activations")
    if cut > room:
        fail(f"{cfg.name} at {cfg.n_layers} layers does not fit the card")
    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init(0)
    torch.cuda.synchronize()
    pbytes = param_bytes(params)
    say(f"init {cfg.name} at {cfg.n_layers} of {of_layers} layers: "
        f"{pbytes / 1e9:.3f} GB of bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")

    batch, prompt, gen = 4, 128, 16
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # ---- the main path: counts zeroed above, read right after it.
    with skewmm.plan_capture() as log:
        res = serve_mod.serve(cfg=cfg, params=params, batch=batch,
                              prompt_len=prompt, gen=gen, seed=SERVE_SEED,
                              temperature=SERVE_TEMPERATURE)
    counts = ops.launch_counts()
    # ---- end of the main path.
    peak = torch.cuda.max_memory_allocated()
    if not res["logits_finite"]:
        fail(f"{cfg.name} serve produced non-finite logits")
    kv = kvcache.cache_bytes(kvcache.init_cache(cfg, batch, prompt + gen,
                                                "meta"))
    pre_b, dec_b = mla_serve_bounds(cfg, params, batch, prompt, kv)
    say(f"serve {cfg.name} ({cfg.n_layers} of {of_layers} layers) "
        f"b{batch} p{prompt} g{gen}: prefill {res['prefill_s'] * 1e3:.1f} "
        f"ms (bound {pre_b:.2f} ms), decode "
        f"{res['decode_s_per_token'] * 1e3:.2f} ms/token (bound "
        f"{dec_b:.2f} ms), peak memory {peak / 2**30:.2f} GiB of "
        f"{pbytes / 2**30:.2f} GiB weights, latent cache {kv / 1e6:.2f} MB")
    seen = {}
    for c in log:
        seen.setdefault(plan_key(c), c)
    for key, c in seen.items():
        say(f"plan {key}: {c.explain()}")
    say(f"launch counts on the {cfg.name} main path: {counts}")
    n_moe = cfg.n_layers - cfg.first_k_dense
    steps = 1 + res["decode_warmup_steps"] + gen
    if counts["grouped_matmul"] != 3 * n_moe * steps:
        fail(f"K5 launched {counts['grouped_matmul']} times, expected "
             f"{3 * n_moe * steps} (3 per MoE layer per step, {steps} "
             f"steps: the prefill, {res['decode_warmup_steps']} warm-up, "
             f"{gen} replays)")
    per_step = res["decode_launches_per_step"]
    if per_step.get("grouped_matmul", 0) != 3 * n_moe:
        fail(f"the decode graph replays {per_step.get('grouped_matmul')} "
             f"K5 launches a step, expected {3 * n_moe}")
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"K7 launched {counts['flash_attention']} times, expected "
             f"{cfg.n_layers} (one per layer of the prefill)")
    if per_step.get("flash_attention", 0):
        fail(f"{cfg.name}: the decode graph launches K7")
    say(f"K5 launches: {3 * n_moe} per step ({n_moe} MoE layers x 3 expert "
        f"GEMMs); K7: {cfg.n_layers} per prefill, 0 per decode step")
    for name in sorted(planned_kernels(log) | {"grouped_matmul",
                                               "flash_attention"}):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the {cfg.name} path")
    graph = [graph_vs_eager(torch, cfg, params, res, batch, prompt, gen,
                            bitwise=False)]
    warm = warm_prefill_ms(torch, cfg, params, batch, prompt)
    say(f"{cfg.name}: prefill b{batch} p{prompt} again, its shapes planned "
        f"and its kernels loaded: {warm:.1f} ms (the served first prefill "
        f"{res['prefill_s'] * 1e3:.1f} ms)")
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, cfg, params)
    return {"serve": res, "peak": peak, "bounds": (pre_b, dec_b),
            "params": params, "params_bytes": pbytes, "kv_bytes": kv,
            "counts": counts, "graph": graph, "warm_prefill_ms": warm}


def warm_prefill_ms(torch, cfg, params, batch: int, prompt: int) -> float:
    """Host ms of one more prefill of the served prompt (a synchronise on
    each side), after the main path: every shape already planned."""
    import numpy as np

    from repro_torch.serve import engine
    toks = torch.tensor(np.random.default_rng(SERVE_SEED).integers(
        0, cfg.vocab_size, (batch, prompt)), dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(params, cfg, toks, max_len=prompt + 1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def mla_parity_params(params, n_dense: int, n_moe: int) -> dict:
    """The first `n_dense` dense and `n_moe` MoE layers of a deepseek
    parameter tree, sharing its tensors; the MTP head left out (serving
    never runs it)."""
    out = {k: v for k, v in params.items()
           if not k.startswith("stage") and k != "mtp"}
    out["stage0"] = params["stage0"][:n_dense]
    out["stage1"] = params["stage1"][:n_moe]
    return out


def phase_timings_mla(torch, cfg, counts, errs) -> list[dict]:
    """K7 at MLA's prefill shape (4 x 128 heads x 128 tokens, q / k 192, v
    128 read as the model reads it, causal, scale 192^-0.5) and K5 at 256
    groups (decode rows 8 and prefill rows 24, gate / up and down, bf16
    in, fp32 out as the MoE layer calls it), each held against its plain
    version at phase 3's tolerance, then timed beside its plain version,
    its bound and `scaled_dot_product_attention` / `torch.bmm` on the
    same inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(96)
    check = functools.partial(check_kernel, torch, errs)
    row = functools.partial(timing_row, torch, counts, errs)
    bf, fp = torch.bfloat16, torch.float32
    rows = []

    b, h, s = 4, cfg.n_heads, 128
    qk, vd = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    scale = qk ** -0.5

    def rnd(shape, dtype=bf, sc=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * sc
                ).to(dtype)

    q = rnd((b, s, h, qk)).transpose(1, 2)
    k = rnd((b, s, h, qk)).transpose(1, 2)
    v = rnd((b, s, h, cfg.qk_nope_dim + vd))[..., cfg.qk_nope_dim:] \
        .transpose(1, 2)
    shape = f"MLA prefill {b}x{h}x{s}x{qk}/{vd} causal"
    check("flash_attention", fa.flash_attention_cuda(q, k, v, scale=scale),
          fa.flash_attention_plain(q, k, v, scale=scale), bf, shape)
    rows.append(row(
        "flash_attention",
        lambda: fa.flash_attention_cuda(q, k, v, scale=scale),
        lambda: fa.flash_attention_plain(q, k, v, scale=scale),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               scale=scale),
        2 * (q.numel() + k.numel() + v.numel() + b * h * s * vd),
        2 * (qk + vd) * h * b * visible_pairs(s, None), shape))
    del q, k, v

    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    for kk, n, what in ((d, f, "gate/up"), (f, d, "down")):
        w = rnd((e, kk, n), sc=kk ** -0.5)
        for m, when in ((8, "decode"), (24, "prefill")):
            a = rnd((e, m, kk))
            bm, bk, bn = grouped_blocks(e, m, kk, n, 2)
            tag = f"{when} {what} {e}x{m}x{kk}x{n} bf16->fp32"
            check("grouped_matmul",
                  gmm.grouped_matmul_cuda(a, w, bm=bm, bk=bk, bn=bn,
                                          out_dtype=fp),
                  gmm.grouped_matmul_plain(a, w, bk=bk, out_dtype=fp), fp,
                  tag)
            rows.append(row(
                "grouped_matmul",
                lambda a=a, w=w, bm=bm, bk=bk, bn=bn:
                    gmm.grouped_matmul_cuda(a, w, bm=bm, bk=bk, bn=bn,
                                            out_dtype=fp),
                lambda a=a, w=w, bk=bk: gmm.grouped_matmul_plain(
                    a, w, bk=bk, out_dtype=fp),
                lambda a=a, w=w: torch.bmm(a, w),
                (e * m * kk + e * kk * n) * 2 + e * m * n * 4,
                2 * e * m * kk * n, f"{tag} {(bm, bk, bn)}"))
            del a
        del w
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- dense
def dense_depth(torch, cfg) -> int:
    """The layers of `cfg` to serve: all of them where their bf16 weights
    fit the card beside DENSE_RESERVE bytes, else as many whole units as
    fit.  Counted on the meta device, before any weight is made."""
    from repro_torch.models import transformer
    from repro_torch.models.model import param_bytes
    p = transformer.init_lm(cfg, None, "meta")
    full = param_bytes(p)
    unit = param_bytes(p["stage0"][0])
    outside = full - sum(param_bytes(u) for k, v in p.items()
                         if k.startswith("stage") for u in v)
    room = torch.cuda.get_device_properties(0).total_memory - DENSE_RESERVE
    n_units = cfg.n_layers // len(cfg.layer_pattern)
    units = min(n_units, int((room - outside) // unit))
    say(f"{cfg.name}: {full / 1e9:.3f} GB of bf16 weights at all "
        f"{cfg.n_layers} layers; the card holds {room / 1e9:.1f} GB beside "
        f"{DENSE_RESERVE / 1e9:.0f} GB for caches and activations: serving "
        f"{units * len(cfg.layer_pattern)} layers")
    return units * len(cfg.layer_pattern)


def phase_serve_dense(torch, cfg, runs, of_layers: int,
                      parity_layers: int) -> dict:
    """A dense arch at every published width and `cfg.n_layers` of its
    `of_layers` layers, served through `serve(cfg=...)` (`serve_runs`):
    K7 must launch once per layer of every prefill and never at decode.
    Then whole-path parity (phase 5) at `parity_layers` layers of the same
    weights."""
    say(f"config: {cfg.name} L={cfg.n_layers} (of {of_layers}) "
        f"{cfg.layer_pattern} d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim} "
        f"mlp={cfg.mlp_type} ff={cfg.d_ff} V={cfg.vocab_size} "
        f"window={cfg.local_window} softcap={cfg.attn_softcap}/"
        f"{cfg.final_softcap} post_norm={cfg.use_post_norm} "
        f"tied={cfg.tie_embeddings}")
    out = serve_runs(torch, cfg, runs, layer_serve_bounds)
    want = cfg.n_layers * len(runs)
    if out["counts"]["flash_attention"] != want:
        fail(f"K7 launched {out['counts']['flash_attention']} times on the "
             f"{cfg.name} path, expected {want} (one per layer of each of "
             f"{len(runs)} prefills)")
    for res in out["serve"]:
        if res["decode_launches_per_step"].get("flash_attention", 0):
            fail(f"{cfg.name}: the decode graph launches K7")
    say(f"K7 launches: {cfg.n_layers} per prefill ({len(runs)} prefills), "
        f"0 per decode step")
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, cfg, out["params"])
    params = first_layers(out.pop("params"),
                          parity_layers // len(cfg.layer_pattern))
    torch.cuda.empty_cache()
    phase_path_parity(torch, dataclasses.replace(cfg, n_layers=parity_layers),
                      params)
    del params
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------- VLM
def seeded_prefix(torch, cfg, batch: int):
    """The stub frontend's output: (B, frontend_len, D) fp32 patch
    embeddings drawn from VLM_PREFIX_SEED."""
    import numpy as np
    rng = np.random.default_rng(VLM_PREFIX_SEED)
    return torch.tensor(
        rng.normal(size=(batch, cfg.frontend_len, cfg.d_model)),
        dtype=torch.float32, device="cuda")


def serve_prefix(torch, cfg, params, prefix, batch: int, prompt: int,
                 gen: int) -> dict:
    """`serve()`'s loop with a VLM prefix: serve()'s seeded prompt after
    `prefix` through `engine.prefill(prefix_embeds=)`, then `gen` tokens
    decoded through one DecodeGraph at positions offset by the prefix and
    drawn by serve()'s seeded sampler.  Returns serve()'s keys."""
    import numpy as np

    from repro_torch.serve import engine, graphs

    off = prefix.shape[1]
    rng = np.random.default_rng(SERVE_SEED)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, prompt)),
                        dtype=torch.long, device="cuda")
    sampler = torch.Generator(device="cuda")
    sampler.manual_seed(SERVE_SEED + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = engine.prefill(params, cfg, toks,
                                   max_len=off + prompt + gen,
                                   prefix_embeds=prefix)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits, -1)
    t0 = time.perf_counter()
    step = graphs.DecodeGraph(params, cfg, cache, batch)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    out, first = [], None
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok)
        logits = step.step(tok, off + prompt + i)
        if first is None:
            first = logits.clone()
        finite = finite & torch.isfinite(logits).all()
        probs = torch.softmax(logits / SERVE_TEMPERATURE, dim=-1)
        tok = torch.multinomial(probs, 1, generator=sampler)[:, 0]
    last = logits.clone()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return dict(tokens=torch.stack(out, 1).cpu(), first_decode_logits=first,
                last_decode_logits=last, logits_finite=bool(finite),
                prefill_s=prefill_s, decode_setup_s=setup_s,
                decode_warmup_steps=graphs.WARMUP_STEPS,
                decode_launches_per_step=step.launches_per_step,
                decode_s_per_token=decode_s / gen)


def model_line(cfg, of_layers=None) -> str:
    layers = f"L={cfg.n_layers}" + (f" (of {of_layers})" if of_layers
                                    else "")
    if cfg.enc_layers:
        layers += f" + {cfg.enc_layers} encoder"
    return (f"config: {cfg.name} [{cfg.family}] {layers} d={cfg.d_model} "
            f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.head_dim} "
            f"mlp={cfg.mlp_type} ff={cfg.d_ff} V={cfg.vocab_size} "
            f"pos={cfg.pos_embedding} frontend={cfg.frontend} x "
            f"{cfg.frontend_len} tied={cfg.tie_embeddings}")


def phase_serve_vlm(torch, cfg):
    """internvl2-1b (the thirteenth main path) at every published width and
    all 24 layers: b4 p128 g16 through `serve(cfg=...)` with no prefix, as
    the launcher serves it; then b4 with 256 seeded patch embeddings ahead
    of p128 through `engine.prefill(prefix_embeds=)` and g16 through a
    DecodeGraph at positions offset by 256 (`serve_prefix`).  Counts are
    zeroed before both runs and read after both: K7 24 launches a prefill
    (a GQA group of 7 at head dim 64) and none at decode, every planned
    kernel launched (the LM head at n 151655); each run's graphed decode
    bitwise equal to an eager one."""
    from repro_torch.core import skewmm
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import build_model, param_bytes

    say(model_line(cfg))
    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init(0)
    torch.cuda.synchronize()
    pbytes = param_bytes(params)
    say(f"init {cfg.name}: {pbytes / 1e9:.3f} GB of bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")
    batch, prompt, gen = 4, 128, 16
    off = cfg.frontend_len
    prefix = seeded_prefix(torch, cfg, batch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # ---- the main path: counts zeroed above, read right after it.
    with skewmm.plan_capture() as log:
        res = serve_mod.serve(cfg=cfg, params=params, batch=batch,
                              prompt_len=prompt, gen=gen, seed=SERVE_SEED,
                              temperature=SERVE_TEMPERATURE)
        res_p = serve_prefix(torch, cfg, params, prefix, batch, prompt, gen)
    counts = ops.launch_counts()
    # ---- end of the main path.
    peak = torch.cuda.max_memory_allocated()
    bounds = []
    for tag, r, t in (("no prefix", res, prompt),
                      (f"prefix {off}", res_p, off + prompt)):
        if not r["logits_finite"]:
            fail(f"{cfg.name} serve ({tag}) produced non-finite logits")
        cb = served_cache_bytes(cfg, batch, t + gen)
        pre_b, dec_b = layer_serve_bounds(cfg, params, batch, t, cb)
        bounds.append((pre_b, dec_b))
        say(f"serve {cfg.name} ({depth(cfg)}) b{batch} p{prompt} "
            f"g{gen} {tag}: prefill {r['prefill_s'] * 1e3:.1f} ms (bound "
            f"{pre_b:.3f} ms), decode {r['decode_s_per_token'] * 1e3:.2f} "
            f"ms/token (bound {dec_b:.3f} ms), KV cache {cb / 1e6:.1f} MB")
    say(f"serve {cfg.name}: peak memory {peak / 2**30:.2f} GiB of "
        f"{pbytes / 2**30:.2f} GiB weights")
    seen = {}
    for c in log:
        seen.setdefault(plan_key(c), c)
    for key, c in seen.items():
        say(f"plan {key}: {c.explain()}")
    say(f"launch counts on the {cfg.name} main path: {counts}")
    if counts["flash_attention"] != 2 * cfg.n_layers:
        fail(f"K7 launched {counts['flash_attention']} times on the "
             f"{cfg.name} path, expected {2 * cfg.n_layers} (one per layer "
             f"of each of 2 prefills)")
    for r in (res, res_p):
        if r["decode_launches_per_step"].get("flash_attention", 0):
            fail(f"{cfg.name}: the decode graph launches K7")
    for name in sorted(planned_kernels(log) | {"flash_attention"}):
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the {cfg.name} path")
    say(f"K7 launches: {cfg.n_layers} per prefill (2 prefills, one with "
        f"the {off}-row prefix), 0 per decode step")
    graph = [graph_vs_eager(torch, cfg, params, res, batch, prompt, gen,
                            bitwise=True),
             graph_vs_eager(torch, cfg, params, res_p, batch, prompt, gen,
                            bitwise=True, prefix=prefix)]
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, cfg, params)
    return {"serve": [res, res_p], "peak": peak, "bounds": bounds,
            "params": params, "params_bytes": pbytes, "counts": counts,
            "graph": graph, "prefix": prefix}


# ----------------------------------------------------------------- enc-dec
def seeded_frames(torch, cfg, batch: int, prompt: int):
    """serve()'s seeded prompt and the frames it draws after it."""
    import numpy as np
    rng = np.random.default_rng(SERVE_SEED)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, prompt)),
                        dtype=torch.long, device="cuda")
    frames = torch.tensor(
        rng.normal(size=(batch, cfg.frontend_len, cfg.d_model)),
        dtype=torch.float32, device="cuda")
    return toks, frames


def encdec_serve_bounds(cfg, params, batch: int, prompt: int,
                        kv_bytes: int) -> tuple[float, float]:
    """(prefill bound ms, decode bound ms per token) of the encoder-decoder
    serve.

    Bytes: at prefill every weight once (the tied embedding is the LM
    head); at decode the decoder's weights but its cross-attention wk / wv
    (their k / v are cached), the embedding as the LM head, and the self
    and cross caches.  Operations: 2 per token and weight of every matrix
    (the encoder's and the cross wk / wv over the B x F frames, the rest
    of the decoder over the prompt), attention's 4 * hd per (row, col)
    pair and head (every pair of the encoder and of the cross-attention,
    the decoder's causal pairs), and the LM head on the last positions."""
    from repro_torch.models.model import param_bytes
    d, v, hd, h = cfg.d_model, cfg.vocab_size, cfg.head_dim, cfg.n_heads
    f = cfg.frontend_len

    def mats(tree):
        return sum(t.numel() for t in _leaves(tree) if t.dim() >= 2)

    enc_w = sum(mats(p) for p in params["enc"])
    xkv_w = sum(p["xattn"]["wk"].numel() + p["xattn"]["wv"].numel()
                for p in params["dec"])
    dec_w = sum(mats(p) for p in params["dec"]) - xkv_w
    att = 4 * hd * h * batch
    pre_ops = (2 * batch * f * (enc_w + xkv_w) + 2 * batch * prompt * dec_w
               + 2 * batch * d * v
               + att * (cfg.enc_layers * f * f + cfg.n_layers * (
                   visible_pairs(prompt, None) + prompt * f)))
    dec_ops = (2 * batch * (dec_w + d * v)
               + att * cfg.n_layers * (prompt + 1 + f))
    esize = params["embed"].element_size()
    dec_bytes = (param_bytes(params["dec"]) - xkv_w * esize
                 + param_bytes(params["embed"]) + kv_bytes)
    pre = max(pre_ops / PEAK_BF16, param_bytes(params) / HBM_BW)
    dec = max(dec_ops / PEAK_BF16, dec_bytes / HBM_BW)
    return pre * 1e3, dec * 1e3


def phase_serve_encdec(torch, cfg):
    """seamless-m4t-large-v2 (the fourteenth main path) at every published
    width and all 24 + 24 layers: b4 with 4096 seeded frames, p128 g16
    through `serve(cfg=...)` (`serve_runs`).  K7 launches 72 times a
    prefill (24 encoder self, 24 decoder self, 24 cross-attention at 128
    rows over 4096 frames) and never at decode; graphed decode bitwise
    equal to eager.  Then the encoder's share of a warm prefill's device
    time (CUDA events)."""
    from repro_torch.models import encdec
    from repro_torch.serve import encdec_engine

    say(model_line(cfg))
    batch, prompt, gen = 4, 128, 16
    out = serve_runs(torch, cfg, ((batch, prompt, gen),),
                     encdec_serve_bounds)
    counts = out["counts"]
    want = cfg.enc_layers + 2 * cfg.n_layers
    if counts["flash_attention"] != want:
        fail(f"K7 launched {counts['flash_attention']} times on the "
             f"{cfg.name} path, expected {want} ({cfg.enc_layers} encoder "
             f"self, {cfg.n_layers} decoder self and {cfg.n_layers} cross "
             f"per prefill)")
    if out["serve"][0]["decode_launches_per_step"].get("flash_attention", 0):
        fail(f"{cfg.name}: the decode graph launches K7")
    say(f"K7 launches: {want} per prefill ({cfg.enc_layers} encoder self at "
        f"{cfg.frontend_len}^2, {cfg.n_layers} decoder self at {prompt}^2, "
        f"{cfg.n_layers} cross at {prompt} x {cfg.frontend_len}), 0 per "
        f"decode step")
    params = out["params"]
    toks, frames = seeded_frames(torch, cfg, batch, prompt)
    enc_ms = time_ms(torch, lambda: encdec.encode(params, cfg, frames),
                     iters=3, warmup=1)
    pre_ms = time_ms(torch, lambda: encdec_engine.prefill(
        params, cfg, frames, toks, max_len=prompt + gen), iters=3, warmup=1)
    out["encoder_ms"], out["prefill_ms"] = enc_ms, pre_ms
    say(f"{cfg.name}: warm prefill b{batch} F{cfg.frontend_len} p{prompt} "
        f"{pre_ms:.2f} ms of device time (CUDA events), the encoder "
        f"{enc_ms:.2f} ms of it: {100 * enc_ms / pre_ms:.1f}%")
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, cfg, params)
    return out


def encdec_parity_params(params, n: int) -> dict:
    """The first `n` encoder and `n` decoder layers of an encoder-decoder
    parameter tree, sharing its tensors."""
    return dict(params, enc=params["enc"][:n], dec=params["dec"][:n])


def phase_timings_vlm_encdec(torch, vcfg, vparams, ecfg, eparams, counts,
                             errs) -> list[dict]:
    """K7 at the four attention shapes of the two paths (internvl2-1b's
    prefill, 4 x 14 / 2 heads x 384 x 64 causal; seamless-m4t's encoder,
    4 x 16 x 4096 x 64, and decoder self, 4 x 16 x 128 x 64 causal; its
    cross-attention, 128 rows over 4096 columns, not causal) and K1 at
    the two odd LM heads (4 x 896 x 151655 and 4 x 1024 x 256206 against
    the served E^T, bf16 in, fp32 out) and their 1-row decode: each held
    against its plain version at phase 3's tolerance (at the heads every
    dense schedule and the planner's split-K plan, K3 + K4), then timed
    beside its plain version, its bound and `scaled_dot_product_attention`
    / `torch.matmul` on the same inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import skew_matmul as mm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(95)
    check = functools.partial(check_kernel, torch, errs)
    row = functools.partial(timing_row, torch, counts, errs)
    bf, fp = torch.bfloat16, torch.float32
    rows = []

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    d = vcfg.head_dim
    fa_shapes = [
        (f"{vcfg.name} prefill", 4, vcfg.n_heads, vcfg.n_kv_heads,
         vcfg.frontend_len + 128, vcfg.frontend_len + 128, True),
        (f"{ecfg.name} encoder", 4, ecfg.n_heads, ecfg.n_kv_heads,
         ecfg.frontend_len, ecfg.frontend_len, False),
        (f"{ecfg.name} decoder self", 4, ecfg.n_heads, ecfg.n_kv_heads, 128,
         128, True),
        (f"{ecfg.name} cross", 4, ecfg.n_heads, ecfg.n_heads, 128,
         ecfg.frontend_len, False)]
    for label, b, hq, hkv, sq, skv, causal in fa_shapes:
        q = rnd(b, sq, hq, d).transpose(1, 2)
        k = rnd(b, skv, hkv, d).transpose(1, 2)
        v = rnd(b, skv, hkv, d).transpose(1, 2)
        shape = (f"{label} {b}x{hq}/{hkv}x{sq}x{skv}x{d} "
                 f"{'causal' if causal else 'full'}")
        check("flash_attention", fa.flash_attention_cuda(q, k, v,
                                                         causal=causal),
              fa.flash_attention_plain(q, k, v, causal=causal), bf, shape)
        pairs = visible_pairs(sq, None) if causal else sq * skv
        rows.append(row(
            "flash_attention",
            lambda q=q, k=k, v=v, c=causal: fa.flash_attention_cuda(
                q, k, v, causal=c),
            lambda q=q, k=k, v=v, c=causal: fa.flash_attention_plain(
                q, k, v, causal=c),
            sdpa_call(torch, F, q, k, v, causal=causal),
            2 * (2 * q.numel() + k.numel() + v.numel()),
            4 * d * hq * b * pairs, shape))
        del q, k, v
    torch.cuda.empty_cache()

    for cfg, params in ((vcfg, vparams), (ecfg, eparams)):
        dm, n = cfg.d_model, cfg.vocab_size
        emb_t = params["embed"].T
        for m in (4, 1):
            h = rnd(m, dm)
            tag = f"{cfg.name} LM head {m}x{dm}x{n} E^T bf16->fp32"
            want = mm.skew_matmul_plain(h, emb_t, bk=64, out_dtype=fp)
            for sched in ("k_inner", "a_resident", "b_resident"):
                check(f"skew_matmul_{sched}", mm.skew_matmul_cuda(
                    h, emb_t, bm=64, bk=64, bn=128, schedule=sched,
                    out_dtype=fp), want, fp, f"{tag} {sched}")
            sk = splitk_plan(m, dm, n, 2)
            check("gemv_splitk_reduce", ops.skew_matmul(
                h, emb_t, plan=sk, out_dtype=fp), want, fp,
                f"{tag} split-K {(sk.bm, sk.bk, sk.bn)}")
            rows.append(row(
                "skew_matmul_k_inner",
                lambda h=h, e=emb_t: mm.skew_matmul_cuda(
                    h, e, bm=64, bk=64, bn=128, out_dtype=fp),
                lambda h=h, e=emb_t: mm.skew_matmul_plain(h, e, bk=64,
                                                          out_dtype=fp),
                lambda h=h, e=emb_t: torch.matmul(h, e),
                m * dm * 2 + dm * n * 2 + m * n * 4, 2 * m * dm * n,
                f"{tag} (64, 64, 128)"))
            del want
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- train
def train_bounds(cfg, n_params: int, batch: int, seq: int,
                 shapes=None) -> tuple[float, float, float]:
    """(bound ms, operations ms, update ms) of one train step: the forward
    and backward's operations at the bf16 rate (`model_flops` in train mode,
    6 per token and weight, plus causal attention's QK and PV, three times
    for the forward and backward), then the AdamW update's bytes (22 a
    param: read the bf16 param and grad and both fp32 moments, write the
    param and both moments) over the memory rate.  The update cannot start
    before the backward ends, so the two add."""
    from repro_torch.models.model import model_flops
    hd, h = cfg.head_dim, cfg.n_heads
    attn = 3 * 2 * 2 * batch * h * hd * seq * seq / 2 * cfg.n_layers
    flops = model_flops(cfg, tokens=batch * seq, mode="train",
                        shapes=shapes) + attn
    ops_ms = flops / PEAK_BF16 * 1e3
    upd_ms = 22 * n_params / HBM_BW * 1e3
    return ops_ms + upd_ms, ops_ms, upd_ms


def _finite_metrics(seen: list, tag: str) -> None:
    for i, m in enumerate(seen):
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"{tag}: step {i + 1} metrics not finite: {m}")


def step_split_ms(torch, bundle, opt, ts_cfg, state, batch):
    """(forward + backward ms, update ms) of a train step, each between two
    synchronises: the second of two runs (the first refills the caching
    allocator, emptied after the last phase); the updates are dropped."""
    from repro_torch.core import config as mmcfg
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    grad_fn = value_and_grad(make_loss_fn(bundle, ts_cfg))
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mmcfg.mm_config(backend="torch"):
            _, grads = grad_fn(state.params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = opt.update(grads, state.opt, state.params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del out, grads
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def served_loss(torch, bundle, ts_cfg, params, batch, cfg,
                label: str) -> tuple:
    """(b)'s reference: (the mean NLL of `batch` under the "cuda" backend,
    no grad (K1 at the LM head and every projection, K7 a layer), the
    launch counts of that forward), counted apart from the main path;
    fails unless K1 and K7 ran, K7 once a layer."""
    from repro_torch.core import config as mmcfg
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import make_loss_fn
    ops.reset_launch_counts()
    with mmcfg.mm_config(backend="cuda"), torch.no_grad():
        loss = float(make_loss_fn(bundle, ts_cfg)(params, batch))
    counts = ops.launch_counts()
    if counts["flash_attention"] != cfg.n_layers \
            or not counts["skew_matmul_k_inner"]:
        fail(f"{label} (b): the 'cuda' forward did not run K1 and K7 once "
             "a layer")
    return loss, counts


def check_served(label: str, card: str, trained: float, served: float,
                 counts: dict) -> None:
    """(b): step 1's trained loss against the served kernels' forward of
    the same batch, within rel 1e-2."""
    rel = abs(trained - served) / abs(served)
    say(f"{label} (b) ({card}): step 1 loss {trained:.6f} vs 'cuda' forward "
        f"{served:.6f} (launches K1 k_inner {counts['skew_matmul_k_inner']}, "
        f"K7 {counts['flash_attention']}): rel {rel:.2e} (limit 1e-2)")
    if rel > 1e-2:
        fail(f"{label} (b): the trained forward's loss disagrees with the "
             "served kernels'")


def timed_steps(torch, step_fn, times: list, seen: list):
    """`step_fn` (state, batch) -> (state, metrics), each call timed on the
    host clock with a synchronise on each side; its time and its metrics
    (as floats) appended to `times` and `seen`."""
    def run(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        seen.append({k: float(v) for k, v in out[1].items()})
        return out
    return run


def say_steps(label: str, card: str, times: list, seen: list) -> None:
    _finite_metrics(seen, f"{label} (a)")
    for i, (dt, m) in enumerate(zip(times, seen)):
        say(f"{label} step {i + 1} ({card}): {dt * 1e3:.2f} ms loss "
            f"{m['loss']:.6f} grad_norm {m['grad_norm']:.4f} "
            f"lr {m['lr']:.3e}")


def phase_train(torch, cfg, card: str) -> dict:
    """phi4-mini at full width and TRAIN_LAYERS of 32, bf16: the trainer of
    `launch.train.main` at the cut config (the seventeenth main path),
    then checks (b)-(e)."""
    import shutil
    import statistics
    from repro_torch.core import config as mmcfg
    from repro_torch.data.pipeline import DataLoader, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import build_model, count_params, \
        model_flops, param_bytes, param_shapes
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    say(model_line(cfg, 32) + f" batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"loss_chunk {TRAIN_CHUNK}, {TRAIN_STEPS} steps")
    ckpt_dir = ROOT / "build" / "train_smoke"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    bundle = build_model(cfg, "cuda")
    opt = AdamW(lr=warmup_cosine(3e-4, 2, TRAIN_STEPS))
    ts_cfg = TrainStepConfig(loss_chunk=TRAIN_CHUNK)
    t0 = time.perf_counter()
    trainer = Trainer(bundle, opt, ts_cfg,
                      TrainerConfig(total_steps=TRAIN_STEPS,
                                    ckpt_every=TRAIN_STEPS,
                                    ckpt_dir=str(ckpt_dir)), log_fn=say)
    torch.cuda.synchronize()
    n_params = count_params(trainer.state.params)
    pbytes = param_bytes(trainer.state.params)
    state_bytes = pbytes + 8 * n_params
    say(f"train init ({card}): {n_params / 1e9:.3f} B params, "
        f"{pbytes / 1e9:.3f} GB of bf16 weights, {state_bytes / 1e9:.2f} GB "
        f"of state with the fp32 moments, in "
        f"{time.perf_counter() - t0:.1f} s")
    shapes = param_shapes(cfg)

    # (b) the trained forward against the served kernels
    source = SyntheticLM(cfg.vocab_size)
    first = {"tokens": torch.from_numpy(source.batch(
        0, TRAIN_BATCH, TRAIN_SEQ)).cuda()}
    served, fwd_counts = served_loss(torch, bundle, ts_cfg,
                                     trainer.state.params, first, cfg,
                                     "train")

    times, seen, saves = [], [], []
    save = trainer.ckpt.save

    def timed_save(step, tree, *, blocking=False):
        t = time.perf_counter()
        save(step, tree, blocking=blocking)
        saves.append((step, blocking, time.perf_counter() - t))

    trainer.step_fn = timed_steps(torch, trainer.step_fn, times, seen)
    trainer.ckpt.save = timed_save
    loader = DataLoader(source, TRAIN_BATCH, TRAIN_SEQ, device=bundle.device,
                        start_step=trainer.ckpt.latest_step() or 0)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # ---- the main path: counts zeroed above, read right after it.
    try:
        with mmcfg.mm_config(backend="torch"):
            out = trainer.run(loader)
    finally:
        loader.close()
    counts = ops.launch_counts()
    # ---- end of the main path.
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        fail(f"train: the torch rung launched kernels {counts}")
    say_steps("train", card, times, seen)
    ckpt = ckpt_dir / f"step-{TRAIN_STEPS:09d}" / "state.npz"
    save_bytes = ckpt.stat().st_size
    final_ms = saves[-1][2] * 1e3
    steady = times[1:]
    step_ms = statistics.median(steady) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bound, ops_ms, upd_ms = train_bounds(cfg, n_params, TRAIN_BATCH,
                                         TRAIN_SEQ, shapes)
    mfu = model_flops(cfg, tokens=tokens, mode="train", shapes=shapes) / (
        step_ms / 1e3) / PEAK_BF16
    say(f"train ({card}): step {step_ms:.2f} ms (median of steps 2-"
        f"{TRAIN_STEPS}, host clock, a synchronise on each side), "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s, train_mfu "
        f"{mfu * 100:.3f}% of 989 TFLOP/s, bound {bound:.2f} ms "
        f"(operations {ops_ms:.2f} + update bytes {upd_ms:.2f}; "
        f"{step_ms / bound:.1f}x)")
    say(f"train ({card}): peak {peak / 1e9:.2f} GB allocated "
        f"(max_memory_allocated) beside {state_bytes / 1e9:.2f} GB of "
        f"params and moments, {(state_bytes + pbytes) / 1e9:.2f} GB with "
        f"the grads, {2 * state_bytes / 1e9 + pbytes / 1e9:.2f} GB with "
        f"the update's new copy; saves "
        + ", ".join(f"step {s} {'blocking' if b else 'async'} "
                    f"{dt * 1e3:.0f} ms" for s, b, dt in saves)
        + f"; the final save {save_bytes / 1e9:.2f} GB in {final_ms:.0f} ms")
    check_served("train", card, seen[0]["loss"], served, fwd_counts)
    if out["final_loss"] is None or not math.isfinite(out["final_loss"]):
        fail(f"train: final loss {out['final_loss']}")
    del trainer, out
    gc.collect()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) one repeated batch at a constant lr must lower the loss (held at
    # TRAIN_DESCENT_LR; the run at 3e-4 is printed beside it)
    losses = {}
    for lr in (3e-4, TRAIN_DESCENT_LR):
        opt = AdamW(lr=lr)
        state = init_train_state(bundle, opt, 1, ts_cfg)
        step = make_train_step(bundle, opt, ts_cfg)
        if lr != TRAIN_DESCENT_LR:
            fb_ms, upd_ms = step_split_ms(torch, bundle, opt, ts_cfg, state,
                                          first)
            say(f"train ({card}): a step apart: forward + backward "
                f"{fb_ms:.2f} ms, AdamW update {upd_ms:.2f} ms (host "
                f"clock, a synchronise on each side of each)")
        losses[lr] = []
        with mmcfg.mm_config(backend="torch"):
            for _ in range(TRAIN_STEPS):
                state, m = step(state, first)
                losses[lr].append(float(m["loss"]))
        say(f"train (c) ({card}): one batch, constant lr {lr:g}: losses "
            + " ".join(f"{x:.4f}" for x in losses[lr]))
        if lr != TRAIN_DESCENT_LR:
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
    held = losses[TRAIN_DESCENT_LR]
    if not all(math.isfinite(x) for x in held) or held[-1] >= held[0]:
        fail("train (c): the loss did not fall on a repeated batch")

    # (d) the kernels refuse a backward
    try:
        with mmcfg.mm_config(backend="cuda"):
            step(state, first)
    except RuntimeError as e:
        if "K1-K9 are forward-only" not in str(e):
            raise
        say(f"train (d): a step under the 'cuda' backend raises: {e}")
    else:
        fail("train (d): a step under the 'cuda' backend did not raise")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the launcher through its defaults (the card, the "torch" rung)
    cli_dir = ROOT / "build" / "train_smoke_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    res = train_cli.main(["--arch", "phi4-mini-3.8b", "--reduced", "--steps",
                          "4", "--batch", "2", "--seq", "64",
                          "--ckpt-every", "2", "--ckpt-dir", str(cli_dir)])
    shutil.rmtree(cli_dir, ignore_errors=True)
    if not math.isfinite(res["final_loss"]):
        fail(f"train (e): launch.train final loss {res['final_loss']}")
    import torch.distributed as dist
    if dist.is_initialized():
        fail("train (e): launch.train left its one-rank group formed")
    say(f"train (e) ({card}): launch.train --reduced over the host mesh "
        f"(a one-rank NCCL world, taken down after): final loss "
        f"{res['final_loss']:.4f}")
    torch.cuda.empty_cache()
    return {"counts": counts, "step_ms": step_ms, "mfu": mfu,
            "bound_ms": bound, "peak": peak}


def unit_saved_bytes(torch, bundle, ts_cfg, params, batch) -> tuple:
    """(bytes the backward keeps a repeating unit, bytes it keeps in all,
    parameters aside) of one grad-enabled forward of the loss, read
    through `torch.autograd.graph.saved_tensors_hooks`: a unit's are those
    packed while its checkpoint saves its inputs (the ops inside a
    checkpoint pack through the checkpoint's own hooks, not these)."""
    from repro_torch.core import config as mmcfg
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.models import remat, transformer
    from repro_torch.train.train_step import make_loss_fn
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    skip = {p.untyped_storage().data_ptr() for p in live}
    kept, in_unit, units = {}, [False], []
    checkpointed = remat.checkpointed

    def watched(fn, *args, **kw):
        unit = getattr(fn, "func", None) is transformer._unit_fwd
        in_unit[0] = unit
        units.append(unit)
        try:
            return checkpointed(fn, *args, **kw)
        finally:
            in_unit[0] = False

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            kept[st.data_ptr()] = (st.nbytes(), in_unit[0])
        return t

    remat.checkpointed = watched
    try:
        with mmcfg.mm_config(backend="torch"), torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = make_loss_fn(bundle, ts_cfg)(unflatten(params, live),
                                                batch)
    finally:
        remat.checkpointed = checkpointed
    del loss, live
    n_units = sum(units)
    unit_bytes = sum(n for n, u in kept.values() if u)
    return unit_bytes / max(n_units, 1), sum(n for n, _ in kept.values()), \
        n_units


def phase_train_long(torch, cfg, card: str) -> dict:
    """Phase 4o: phi4-mini at full width and TRAIN_LAYERS of 32, bf16, on
    the "torch" rung at 2 x TRAIN_LONG_SEQ tokens (the train_4k cell's
    microbatch a device), TRAIN_LONG_STEPS steps of `make_train_step`:
    step ms, tokens/s, peak memory, the bytes the backward keeps a unit
    against one hidden state; (b) step 1's loss against the "cuda" no-grad
    forward (K1, K7) at the same shape."""
    import statistics

    from repro_torch.core import config as mmcfg
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model, count_params, \
        param_bytes, param_shapes
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)

    b, s = TRAIN_BATCH, TRAIN_LONG_SEQ
    say(model_line(cfg, 32) + f" batch {b} x {s}, loss_chunk {TRAIN_CHUNK}, "
        f"{TRAIN_LONG_STEPS} steps, a unit recomputed in the backward")
    bundle = build_model(cfg, "cuda")
    opt = AdamW(lr=warmup_cosine(3e-4, 2, TRAIN_LONG_STEPS))
    ts_cfg = TrainStepConfig(loss_chunk=TRAIN_CHUNK)
    state = init_train_state(bundle, opt, 0, ts_cfg)
    step = make_train_step(bundle, opt, ts_cfg)
    n_params = count_params(state.params)
    pbytes = param_bytes(state.params)
    source = SyntheticLM(cfg.vocab_size)
    batches = [{"tokens": torch.from_numpy(source.batch(i, b, s)).cuda()}
               for i in range(TRAIN_LONG_STEPS)]

    # (b) the served kernels' forward of step 1's batch, counted apart
    served, fwd_counts = served_loss(torch, bundle, ts_cfg, state.params,
                                     batches[0], cfg, "train 4k")
    hidden = b * s * cfg.d_model * 2
    per_unit, kept, n_units = unit_saved_bytes(torch, bundle, ts_cfg,
                                               state.params, batches[0])
    torch.cuda.empty_cache()
    say(f"train 4k ({card}): the backward keeps {per_unit / 1e6:.2f} MB a "
        f"unit ({n_units} units) against one hidden state {b} x {s} x "
        f"{cfg.d_model} bf16 = {hidden / 1e6:.2f} MB "
        f"({per_unit / hidden:.4f}x); {kept / 1e9:.3f} GB kept in all, "
        f"parameters aside (saved_tensors_hooks)")
    if n_units != cfg.n_layers or not 0.9 <= per_unit / hidden <= 1.1:
        fail(f"train 4k: {per_unit:.0f} bytes kept a unit over {n_units} "
             f"units, not one hidden state ({hidden})")
    limit = (n_units + TRAIN_LONG_OUTSIDE) * hidden
    say(f"train 4k ({card}): kept in all {kept / hidden:.2f} hidden states,"
        f" limit {n_units} units + {TRAIN_LONG_OUTSIDE} = "
        f"{limit / 1e9:.3f} GB")
    if kept > limit:
        fail(f"train 4k: the backward keeps {kept:.0f} bytes, over "
             f"{limit} (a hidden state a unit + {TRAIN_LONG_OUTSIDE})")

    times, seen = [], []
    timed = timed_steps(torch, step, times, seen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    # ---- the main path: counts zeroed above, read right after it.
    with mmcfg.mm_config(backend="torch"):
        for batch in batches:
            state, _ = timed(state, batch)
    counts = ops.launch_counts()
    # ---- end of the main path.
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        fail(f"train 4k: the torch rung launched kernels {counts}")
    say_steps("train 4k", card, times, seen)
    step_ms = statistics.median(times[1:]) * 1e3
    bound, ops_ms, upd_ms = train_bounds(cfg, n_params, b, s,
                                         param_shapes(cfg))
    say(f"train 4k ({card}): step {step_ms:.2f} ms (median of steps 2-"
        f"{TRAIN_LONG_STEPS}, host clock, a synchronise on each side), "
        f"{b * s / (step_ms / 1e3):.1f} tokens/s, bound {bound:.2f} ms "
        f"(operations {ops_ms:.2f} + update bytes {upd_ms:.2f}; "
        f"{step_ms / bound:.1f}x); peak {peak / 1e9:.2f} GB allocated "
        f"(max_memory_allocated) beside {(pbytes + 8 * n_params) / 1e9:.2f}"
        f" GB of params and moments")
    check_served("train 4k", card, seen[0]["loss"], served, fwd_counts)
    del state, step, bundle, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "step_ms": step_ms, "peak": peak}


def _to_device(tree, device):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _state_to(state, device):
    """A TrainState's tensors copied to `device` (step and key stay on the
    host)."""
    return type(state)(
        params=_to_device(state.params, device),
        opt=type(state.opt)(step=state.opt.step.clone(),
                            mu=_to_device(state.opt.mu, device),
                            nu=_to_device(state.opt.nu, device)),
        ef=None if state.ef is None else type(state.ef)(
            residual=_to_device(state.ef.residual, device)),
        rng=state.rng.copy())


def train_states_close(flat, ref, quanta: dict, ties: dict, opt,
                       tag: str) -> int:
    """One state against another, as tests/test_torch_train.py holds the
    port against JAX: moments at 1e-4 of the leaf's largest magnitude;
    the residual at 1e-4 of its quantizer's input range (127 quanta),
    every element beyond that exactly one quantum off (an int8 code
    rounded the other way: a tie, which `ties` keeps across steps, and
    whose moments and params are not compared); params at 1e-4 but where
    Adam's denominator sqrt(v_hat) is under 100 eps in either state (the
    update's sensitivity to its gradient nears 1 / eps there), which must
    move by at most a bounded step, 2 lr (1 + weight decay).  Step and key
    equal.  Returns the number of ties."""
    import numpy as np
    for k in (".opt//.step", ".rng"):
        if not np.array_equal(flat[k], ref[k]):
            fail(f"{tag}: {k} {flat[k]} != {ref[k]}")
    step = int(ref[".opt//.step"])
    n_all = 0
    for suffix, q in quanta.items():
        key = ".ef//.residual//" + suffix
        diff = np.abs(flat[key].astype(np.float64) - ref[key])
        tol = 1e-4 * 127 * q
        prev = ties.get(suffix, np.zeros(diff.shape, bool))
        tie = (diff > tol) & ~prev
        if not np.all(np.abs(diff[tie] - q) <= tol):
            fail(f"{tag}: {key} off by {diff[tie].max():.3e}, not one "
                 f"quantum {q:.3e}")
        ties[suffix] = prev | tie
        n_all += diff.size
    n_ties = sum(int(np.sum(t)) for t in ties.values())
    if n_ties > 1e-4 * n_all:
        fail(f"{tag}: {n_ties} int8 ties of {n_all} elements")
    lr = opt.lr                                   # a constant rate here
    worst = 0.0
    for k, want in ref.items():
        if k in (".opt//.step", ".rng") or k.startswith(".ef//"):
            continue
        suffix = k.split("//", 2)[-1] if k.startswith(".opt") else \
            k.split("//", 1)[-1]
        got, want = flat[k].astype(np.float64), want.astype(np.float64)
        skip = ties.get(suffix, np.zeros(want.shape, bool))
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(got - want)
        if k.startswith(".params"):
            nu = np.minimum(flat[".opt//.nu//" + suffix],
                            ref[".opt//.nu//" + suffix]).astype(np.float64)
            ill = (np.sqrt(nu / (1 - opt.b2 ** step)) < 100 * opt.eps) \
                & ~skip
            bound = 2 * lr * (1 + opt.weight_decay) + 1e-4 * scale
            if np.any(err[ill] > bound):
                fail(f"{tag}: {k} moved {err[ill].max():.3e} at an "
                     f"ill-conditioned element (bound {bound:.3e})")
            skip = skip | ill
        rel = err[~skip].max() / scale if np.any(~skip) else 0.0
        worst = max(worst, rel)
        if rel > 1e-4:
            fail(f"{tag}: {k} off by {rel:.3e} of its largest magnitude")
    say(f"{tag}: params / moments / residual within {worst:.2e} of each "
        f"leaf's largest magnitude, {n_ties} int8 ties")
    return n_ties


def phase_train_parity(torch, card: str) -> None:
    """phi4-mini reduced, fp32, TF32 off: two steps (2 microbatches, int8
    error feedback) on the card against the CPU from the same weights,
    then a resume at step 3 of 6 bitwise equal to an unbroken run."""
    import shutil
    import warnings
    import numpy as np
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.configs.base import get_config
    from repro_torch.core import config as mmcfg
    from repro_torch.core import skewmm
    from repro_torch.data.pipeline import DataLoader, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim import compression
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("phi4-mini-3.8b").reduced()
    say(model_line(cfg) + " (reduced, fp32): two steps, 2 microbatches, "
        "int8 error feedback, the card against the CPU")
    ts_cfg = TrainStepConfig(n_microbatches=2, loss_chunk=16,
                             compress_grads=True)
    opt = AdamW()
    cpu = build_model(cfg, "cpu")
    gpu = build_model(cfg, "cuda")
    # the CPU and CUDA generators draw different numbers: one init, copied
    states = {"cpu": init_train_state(cpu, opt, 0, ts_cfg)}
    states["cuda"] = _state_to(states["cpu"], "cuda")
    steps = {"cpu": make_train_step(cpu, opt, ts_cfg),
             "cuda": make_train_step(gpu, opt, ts_cfg)}
    source = SyntheticLM(cfg.vocab_size)
    scale_of = compression._scale
    ties: dict = {}
    for i in range(2):
        host = torch.from_numpy(source.batch(i, 4, 32))
        logs, metrics, scales = {}, {}, {}
        for dev in ("cuda", "cpu"):
            rec = []
            compression._scale = lambda gs: rec.append(scale_of(gs)) \
                or rec[-1]
            try:
                with mmcfg.mm_config(backend="torch"), \
                        skewmm.plan_capture() as log:
                    states[dev], m = steps[dev](states[dev],
                                                {"tokens": host.to(dev)})
            finally:
                compression._scale = scale_of
            logs[dev] = [(plan_key(c), c.plan, c.total_s) for c in log]
            metrics[dev] = {k: float(v) for k, v in m.items()}
            scales[dev] = rec
        if logs["cuda"] != logs["cpu"] or not logs["cpu"]:
            fail(f"train parity step {i + 1}: plan logs differ "
                 f"({len(logs['cuda'])} vs {len(logs['cpu'])} entries)")
        for k in ("loss", "grad_norm", "lr"):
            a, b = metrics["cuda"][k], metrics["cpu"][k]
            if abs(a - b) > 1e-4 * abs(b):
                fail(f"train parity step {i + 1}: {k} {a} vs cpu {b}")
        flat, ref = flatten(states["cuda"]), flatten(states["cpu"])
        keys = list(flatten(states["cpu"].ef.residual))
        quanta = dict(zip(keys, (float(s) for s in scales["cpu"])))
        say(f"train parity step {i + 1} ({card}): loss "
            f"{metrics['cuda']['loss']:.7f}"
            f" / cpu {metrics['cpu']['loss']:.7f}, grad_norm "
            f"{metrics['cuda']['grad_norm']:.6f} / "
            f"{metrics['cpu']['grad_norm']:.6f}, plan log "
            f"{len(logs['cpu'])} entries equal")
        train_states_close(flat, ref, quanta, ties, opt,
                           f"train parity step {i + 1} ({card})")
    del states, steps
    torch.cuda.empty_cache()

    # resume: steps 4-6 from the step-3 checkpoint against an unbroken run
    # (deterministic algorithms for both: the embedding's index backward
    # accumulates with atomics on the card otherwise)
    root = ROOT / "build" / "train_resume"
    shutil.rmtree(root, ignore_errors=True)

    def run(total: int, name: str):
        trainer = Trainer(gpu, AdamW(lr=1e-3), ts_cfg, TrainerConfig(
            total_steps=total, ckpt_every=3, log_every=1,
            ckpt_dir=str(root / name)), log_fn=lambda _m: None)
        loader = DataLoader(source, 4, 32, device=gpu.device,
                            start_step=trainer.ckpt.latest_step() or 0)
        try:
            with mmcfg.mm_config(backend="torch"):
                out = trainer.run(loader)
        finally:
            loader.close()
        return trainer, out

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            whole, out = run(6, "whole")
            run(3, "cut")
            resumed, out2 = run(6, "cut")
        finally:
            torch.use_deterministic_algorithms(False)
    for w in {str(w.message).splitlines()[0] for w in caught}:
        say(f"train resume: warning: {w}")
    shutil.rmtree(root, ignore_errors=True)
    if [s for s, _ in out2["history"]] != [4, 5, 6] \
            or out2["history"] != out["history"][3:]:
        fail(f"train resume: losses {out2['history']} vs "
             f"{out['history'][3:]}")
    want = flatten(whole.state)
    for k, v in flatten(resumed.state).items():
        if not np.array_equal(v, want[k]):
            fail(f"train resume: {k} differs from the unbroken run")
    say(f"train resume ({card}): steps 4-6 from the step-3 checkpoint, "
        "losses " + " ".join(f"{x:.7f}" for _, x in out2["history"])
        + f", {len(want)} state leaves: bitwise equal to the unbroken run")


# ----------------------------------------------------------------- mesh
def phase_mesh(torch, dcfg, pcfg, card: str, train_ms: float) -> dict:
    """Phases 4m / 5m (the sixteenth main path): (a) a one-rank NCCL
    process group and its (1, 1) ("data", "model") DeviceMesh; (b)
    dbrx-132b at full width and DBRX_LAYERS layers (phase 4b's weights,
    made again from its seed), one batch-4 x 128 prefill with the mesh as
    the annotation mesh, every MoE layer through `moe_mlp_shardmap` (K5
    inside), its logits bitwise equal to the meshless prefill's and its K5
    launches equal; (c) phi4-mini at full width, MESH_TRAIN_LAYERS layers,
    through `Trainer(mesh=)`: on a world of one the state stays plain
    tensors and step 1 is the meshless step bit for bit; beside them the
    DTensor leg, the state placed explicitly and stepped by `mesh_step`,
    within 1e-4; step ms of each beside 4l's (`train_ms`, at TRAIN_LAYERS
    layers), and a one-row step of each (`mesh_trainer`); (d) a reduced
    phi4 checkpoint of the meshless trainer restored onto the mesh
    through `restore(specs=, mesh=)`, bytes equal."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh

    # (a) the mesh: NCCL, one rank; no gloo on the card
    t_phase = t0 = time.perf_counter()
    mesh = make_host_mesh(device="cuda")
    backend = dist.get_backend()
    say(f"mesh (a) ({card}): backend {backend}, world "
        f"{dist.get_world_size()}, {mesh} in "
        f"{time.perf_counter() - t0:.1f} s")
    if backend != "nccl" or tuple(mesh.shape) != (1, 1) \
            or mesh.device_type != "cuda":
        fail(f"mesh (a): {backend} {mesh}, expected a (1, 1) NCCL mesh")
    prefill = mesh_prefill(torch, mesh, dcfg, card)
    train = mesh_trainer(torch, mesh, pcfg, card)
    say(f"mesh (c) ({card}): beside phase 4l's step of this run, "
        f"{train_ms:.2f} ms at {TRAIN_LAYERS} layers without the mesh")
    mesh_restore(torch, mesh, card)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    say(f"mesh ({card}): phases 4m / 5m took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": prefill["counts"], "prefill_ms": prefill["ms"],
            **train}


def mesh_prefill(torch, mesh, dcfg, card: str) -> dict:
    """Phase 4m (b) / 5m (b): dbrx's prefill with the mesh as the
    annotation mesh against the meshless prefill."""
    import warnings
    import numpy as np
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.model import build_model, param_bytes
    from repro_torch.serve import engine

    params = build_model(dcfg, "cuda").init(0)
    torch.cuda.synchronize()
    say(model_line(dcfg, 40) + f": {param_bytes(params) / 1e9:.3f} GB of "
        "bf16 weights (phase 4b's, from its seed)")
    batch, prompt = 4, 128
    toks = torch.tensor(np.random.default_rng(SERVE_SEED).integers(
        0, dcfg.vocab_size, (batch, prompt)), dtype=torch.long,
        device="cuda")
    times = {"meshless": [], "mesh": []}
    logits, counts = {}, {}
    # index_add_'s CUDA atomics would order the combine's sums at random:
    # both prefills run the deterministic one
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for it in range(3):
                for name in ("meshless", "mesh"):
                    moe.reset_ep_counts()
                    ops.reset_launch_counts()
                    if name == "mesh":
                        shd.set_annotation_mesh(mesh)
                    # ---- the main path (the mesh prefill): counts zeroed
                    # above, read right after it.
                    try:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        _, out = engine.prefill(params, dcfg, toks,
                                                max_len=prompt + 1)
                        torch.cuda.synchronize()
                    finally:
                        shd.set_annotation_mesh(None)
                    ms = (time.perf_counter() - t0) * 1e3
                    c = ops.launch_counts()
                    # ---- end of the main path.
                    ep = moe.ep_counts()
                    times[name].append(ms)
                    if it == 0:
                        logits[name], counts[name] = out, (c, ep)
        finally:
            torch.use_deterministic_algorithms(False)
    (c_plain, ep_plain), (c_mesh, ep_mesh) = counts["meshless"], \
        counts["mesh"]
    n_moe = dcfg.n_layers
    say(f"mesh (b) ({card}): dbrx prefill b{batch} p{prompt}, host ms "
        f"(a synchronise on each side) meshless "
        + " ".join(f"{t:.1f}" for t in times["meshless"]) + ", mesh "
        + " ".join(f"{t:.1f}" for t in times["mesh"])
        + f"; moe_mlp_shardmap {ep_mesh['shardmap_calls']} of {n_moe} "
        f"layers, all_reduce calls {ep_mesh['all_reduce']} (one over "
        f"'model' of the {batch * prompt} x {dcfg.d_model} fp32 output and "
        f"one of aux over 'data' a layer); K5 launches "
        f"{c_mesh['grouped_matmul']} (meshless {c_plain['grouped_matmul']})")
    if ep_mesh["shardmap_calls"] != n_moe or ep_plain["shardmap_calls"]:
        fail(f"mesh (b): {ep_mesh['shardmap_calls']} of {n_moe} MoE layers "
             f"took moe_mlp_shardmap (meshless: "
             f"{ep_plain['shardmap_calls']})")
    if ep_mesh["all_reduce"] != 2 * n_moe:
        fail(f"mesh (b): {ep_mesh['all_reduce']} all_reduce calls, "
             f"expected {2 * n_moe}")
    if c_mesh != c_plain or c_mesh["grouped_matmul"] != 3 * n_moe:
        fail(f"mesh (b): launches {c_mesh} vs meshless {c_plain}")
    if not torch.equal(logits["mesh"], logits["meshless"]):
        err = (logits["mesh"] - logits["meshless"]).abs().max().item()
        fail(f"mesh (b): the mesh prefill's logits differ from the "
             f"meshless prefill's by up to {err:.3e}")
    if not bool(torch.isfinite(logits["mesh"]).all()):
        fail("mesh (b): non-finite logits")
    say(f"mesh (b) ({card}): logits {tuple(logits['mesh'].shape)} "
        "bitwise equal to the meshless prefill's; launches of the mesh "
        f"prefill (the main path) "
        f"{ {k: v for k, v in c_mesh.items() if v} }")
    del params, logits, toks
    gc.collect()
    torch.cuda.empty_cache()

    return {"counts": c_mesh, "ms": times}


def mesh_trainer(torch, mesh, pcfg, card: str) -> dict:
    """Phase 4m (c) / 5m (c): phi4-mini's trainer three ways from one seed,
    each under deterministic algorithms: meshless; `Trainer(mesh=)` on the
    one-rank mesh, where a world of one places nothing, so the state stays
    plain tensors and step 1 is the meshless step bit for bit; and the
    DTensor leg, the meshless trainer's state placed explicitly by
    `state_specs` / `shard_like`, its batches by `batch_spec`, stepped by
    `mesh_step` (DTensor dispatch, the redistributes to the specs, NCCL),
    every leaf's placements checked and step 1 within 1e-4 of the meshless
    step (phase 5l's limit).  Each leg's steps timed, then one step at a
    one-row batch (1 x TRAIN_SEQ) on each: equal losses on the plain legs,
    within 1e-4 on the DTensor leg, whose one-row batch is split over the
    "data" axis of one rank by its spec and so `Replicate()`."""
    import shutil
    import statistics
    import warnings
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.core import config as mmcfg
    from repro_torch.data.pipeline import DataLoader, SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           mesh_step, state_specs)

    cfg = dataclasses.replace(pcfg, n_layers=MESH_TRAIN_LAYERS)
    say(model_line(cfg, 32) + f" batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"loss_chunk {TRAIN_CHUNK}, {MESH_TRAIN_STEPS} steps a trainer, "
        f"then one at 1 x {TRAIN_SEQ}")
    if shd.distributes(mesh):
        fail(f"mesh (c): a mesh of {mesh.size()} rank(s) would place")
    bundle = build_model(cfg, "cuda")
    ts_cfg = TrainStepConfig(loss_chunk=TRAIN_CHUNK)
    source = SyntheticLM(cfg.vocab_size)
    root = ROOT / "build" / "mesh_smoke"
    shutil.rmtree(root, ignore_errors=True)

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def put(batch):
        return {k: shd.place(v, shd.batch_spec(tuple(v.shape), mesh), mesh)
                for k, v in batch.items()}

    results, p_first = {}, None
    for name, m in (("meshless", None), ("mesh", mesh), ("dtensor", None)):
        trainer = Trainer(bundle, AdamW(lr=3e-4), ts_cfg,
                          TrainerConfig(total_steps=MESH_TRAIN_STEPS,
                                        ckpt_dir=str(root / name)),
                          log_fn=say, mesh=m)
        loader = DataLoader(source, TRAIN_BATCH, TRAIN_SEQ,
                            device=bundle.device, mesh=m)
        one_row = DataLoader(source, 1, TRAIN_SEQ, device=bundle.device,
                             mesh=m)
        state, trainer.state = trainer.state, None   # held once, here
        step_fn, specs, feed = trainer.step_fn, None, dict
        if name == "dtensor":
            specs = state_specs(state, mesh)
            state = shd.shard_like(state, specs, mesh)
            step_fn, feed = mesh_step(step_fn, specs, mesh), put
        ms, seen, kinds = [], [], set()
        # the embedding's and the loss's scatter-adds order their sums at
        # random otherwise: every trainer runs the deterministic kernels
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with mmcfg.mm_config(backend="torch"):
                    for i in range(MESH_TRAIN_STEPS + 1):
                        batch = feed(next(loader if i < MESH_TRAIN_STEPS
                                          else one_row))
                        kinds.add(type(batch["tokens"]))
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        state, metrics = step_fn(state, batch)
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t) * 1e3)
                        seen.append({k: float(v) for k, v in
                                     metrics.items()})
                        if i == 0:
                            first = state
            finally:
                torch.use_deterministic_algorithms(False)
                loader.close()
                one_row.close()
        _finite_metrics(seen, f"mesh (c) {name}")
        if name == "mesh":
            placed = [k for k, v in _flat_tensors(first).items()
                      if isinstance(v, DTensor)]
            if placed or trainer.state_specs is not None \
                    or kinds != {torch.Tensor}:
                fail(f"mesh (c): a world of one placed {len(placed)} state "
                     f"leaves, batches {kinds}")
            say(f"mesh (c) ({card}): Trainer on the mesh: every state leaf "
                "and batch a plain tensor (no DTensor, no annotation mesh)")
        if name == "dtensor":
            placed, named = [0], [0]

            def check(x, spec):
                if spec is not None:
                    want = shd.to_placements(spec, mesh)
                    if not isinstance(x, DTensor) \
                            or tuple(x.placements) != want:
                        fail(f"mesh (c): a leaf is not placed by {spec}")
                    placed[0] += 1
                    named[0] += any(a is not None for a in tuple(spec))
                return x
            shd.map_specs(check, first, specs)
            row_spec = shd.batch_spec((1, TRAIN_SEQ), mesh)
            row_at = shd.to_placements(row_spec, mesh)
            if kinds != {DTensor} or tuple(row_spec)[0] is None \
                    or row_at != (Replicate(),) * mesh.ndim:
                fail(f"mesh (c): DTensor leg batches {kinds}, one-row "
                     f"spec {row_spec} -> {row_at}")
            say(f"mesh (c) ({card}): DTensor leg: {placed[0]} state leaves "
                f"placed by tree_param_specs / tree_optstate_specs ("
                f"{named[0]} of their specs name a mesh axis, each of size "
                f"1 here, so Replicate()), every batch a DTensor by "
                f"batch_spec; the one-row batch's spec {row_spec} -> "
                f"{row_at}")
        del trainer, state
        first = {k: whole(v) for k, v in _flat_tensors(first).items()}
        if name == "meshless":
            p_first = first
        else:
            compare_step1(torch, name, first, p_first, seen[0],
                          results["meshless"][1][0],
                          0.0 if name == "mesh" else 1e-4)
        results[name] = (ms, seen)
        del first
        gc.collect()
        torch.cuda.empty_cache()
    say(f"mesh (c) ({card}): step 1 loss "
        + " / ".join(f"{results[n][1][0]['loss']:.7f}" for n in results)
        + " (" + " / ".join(results) + ")")
    row = {n: results[n][1][-1]["loss"] for n in results}
    ref = row["meshless"]
    if row["mesh"] != ref or abs(row["dtensor"] - ref) > 1e-4 * abs(ref):
        fail(f"mesh (c): the one-row step's losses {row}")
    say(f"mesh (c) ({card}): one-row step (1 x {TRAIN_SEQ}, step "
        f"{MESH_TRAIN_STEPS + 1}) loss meshless {row['meshless']:.7f}, "
        f"Trainer on the mesh {row['mesh']:.7f} (equal), DTensor leg "
        f"{row['dtensor']:.7f} (limit 1e-4 relative)")
    step = {n: statistics.median(results[n][0][1:MESH_TRAIN_STEPS])
            for n in results}
    one = {n: results[n][0][-1] for n in results}
    say(f"mesh (c) ({card}): train step at {cfg.n_layers} layers, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: Trainer on the mesh "
        f"{step['mesh']:.2f} ms, meshless {step['meshless']:.2f} ms, ratio "
        f"{step['mesh'] / step['meshless']:.4f}; the one-rank DTensor leg "
        f"{step['dtensor']:.2f} ms, {step['dtensor'] / step['meshless']:.4f}"
        f"x meshless (median of steps 2-{MESH_TRAIN_STEPS}, host clock, a "
        f"synchronise on each side, deterministic algorithms; steps "
        + "; ".join(n + " " + " / ".join(f"{a:.1f}" for a in results[n][0])
                    for n in results)
        + f", the last at 1 x {TRAIN_SEQ}); the one-row step meshless "
        f"{one['meshless']:.2f}, on the mesh {one['mesh']:.2f}, DTensor "
        f"{one['dtensor']:.2f} ms")
    del results, p_first, bundle
    gc.collect()
    torch.cuda.empty_cache()

    shutil.rmtree(root, ignore_errors=True)
    return {"step_ms": step["mesh"], "plain_step_ms": step["meshless"],
            "dtensor_step_ms": step["dtensor"]}


def compare_step1(torch, name: str, got: dict, want: dict, m_got: dict,
                  m_want: dict, limit: float) -> None:
    """Phase 4m (c): a leg's step-1 metrics and state leaves against the
    meshless step's, bitwise (`limit` 0) or within `limit` (the metrics
    relative, each leaf of its largest magnitude)."""
    for k in (m_want if limit == 0 else ("loss", "grad_norm", "lr")):
        a, b = m_got[k], m_want[k]
        if abs(a - b) > limit * abs(b):
            fail(f"mesh (c) {name}: step 1 {k} {a} vs meshless {b}")
    worst, bitwise = 0.0, 0
    for k, w in want.items():
        if torch.equal(got[k], w):
            bitwise += 1
            continue
        scale = max(w.float().abs().max().item(), 1e-30)
        rel = (got[k].float() - w.float()).abs().max().item() / scale
        worst = max(worst, rel)
        if rel > limit:
            fail(f"mesh (c) {name}: step 1 {k} off by {rel:.3e} of its "
                 f"largest magnitude (limit {limit})")
    say(f"mesh (c) {name}: step 1 grad_norm {m_got['grad_norm']:.6f} / "
        f"meshless {m_want['grad_norm']:.6f}; {bitwise} of {len(want)} "
        f"state leaves bitwise equal, the rest within {worst:.2e} of each "
        f"leaf's largest magnitude (limit {limit})")


def mesh_restore(torch, mesh, card: str) -> None:
    """Phase 5m (d): a reduced checkpoint of the meshless trainer restored
    onto the mesh, placed by its specs, bytes equal."""
    import shutil
    import numpy as np
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.ckpt import CheckpointManager, flatten
    from repro_torch.configs.base import get_config
    from repro_torch.core import config as mmcfg
    from repro_torch.data.pipeline import DataLoader, SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import TrainStepConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig, \
        state_specs

    root = ROOT / "build" / "mesh_smoke"
    rcfg = get_config("phi4-mini-3.8b").reduced()
    source = SyntheticLM(rcfg.vocab_size)
    rb = build_model(rcfg, "cuda")
    trainer = Trainer(rb, AdamW(lr=1e-3), TrainStepConfig(loss_chunk=16),
                      TrainerConfig(total_steps=2, ckpt_every=2,
                                    ckpt_dir=str(root / "reduced")),
                      log_fn=lambda _m: None)
    loader = DataLoader(source, 4, 32, device=rb.device)
    try:
        with mmcfg.mm_config(backend="torch"):
            trainer.run(loader)
    finally:
        loader.close()
    saved = flatten(trainer.state)
    specs = state_specs(trainer.state, mesh)
    restored = CheckpointManager(str(root / "reduced")).restore(
        trainer.state, step=2, specs=specs, mesh=mesh)
    n_dt = [0]

    def on_card(x, spec):
        if spec is not None:
            if not isinstance(x, DTensor) or x.device.type != "cuda":
                fail("mesh (d): a restored leaf is not a DTensor on the card")
            n_dt[0] += 1
        return x
    shd.map_specs(on_card, restored, specs)
    got = flatten(restored)
    with np.load(root / "reduced" / "step-000000002" / "state.npz") as disk:
        for k, v in saved.items():
            if not (np.array_equal(got[k], v) and np.array_equal(
                    disk[k], v)):
                fail(f"mesh (d): restored {k} differs from the saved state")
    say(f"mesh (d) ({card}): step 2 of the meshless reduced trainer "
        f"restored onto the mesh: {n_dt[0]} DTensor leaves on the card, "
        f"{len(saved)} leaves byte for byte equal to the saved state")
    shutil.rmtree(root, ignore_errors=True)


# Phase 4n: the launch tools' cells (arch, shape, mesh, layers traced).
DRYRUN_CELLS = (("phi4-mini-3.8b", "train_4k", "pod", 1),
                ("phi4-mini-3.8b", "train_4k", "pod", 2),
                ("phi4-mini-3.8b", "prefill_32k", "pod", 1),
                ("phi4-mini-3.8b", "decode_32k", "pod", 1),
                ("deepseek-v3-671b", "train_4k", "multipod", 1))
PROBE_CELLS = (("phi4-mini-3.8b", "train_4k", "pod"),
               ("phi4-mini-3.8b", "decode_32k", "pod"),
               ("mamba2-2.7b", "long_500k", "pod"))
PROBE_BLOCK = ("phi4-mini-3.8b", "attn_global", 2, 4096)
TOOLS_TIMEOUT = 420


def launch_tools_procs(out: Path) -> list:
    """Phase 4n (a) / (b): one subprocess a cell, all started together."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for arch, shape, mesh, layers in DRYRUN_CELLS:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", arch, "--shape", shape, "--mesh", mesh,
                "--layers", str(layers), "--out",
                str(out / "dryrun" / f"L{layers}")]
        key = ("dryrun", arch, shape, mesh, layers)
        procs.append((key, subprocess.Popen(
            argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    for arch, shape, mesh in PROBE_CELLS:
        argv = [sys.executable, "-m", "repro_torch.launch.costprobe",
                "--arch", arch, "--shape", shape, "--mesh", mesh,
                "--out", str(out / "roofline")]
        key = ("costprobe", arch, shape, mesh, None)
        procs.append((key, subprocess.Popen(
            argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    return procs


def collect_launch_tools(procs, out: Path, card: str) -> None:
    """Wait for phase 4n's subprocesses; print and gate their records."""
    from repro_torch.configs.base import get_config
    bad, per_device = [], {}
    for (tool, arch, shape, mesh, layers), proc in procs:
        try:
            _, err = proc.communicate(timeout=TOOLS_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            bad.append(f"{tool} {arch} {shape} {mesh}: timed out")
            continue
        path = (out / "dryrun" / f"L{layers}" if tool == "dryrun"
                else out / "roofline") / f"{arch}__{shape}__{mesh}.json"
        if proc.returncode != 0 or not path.exists():
            bad.append(f"{tool} {arch} {shape} {mesh}: rc "
                       f"{proc.returncode}: {err.strip()[-600:]}")
            continue
        rec = json.loads(path.read_text())
        terms = (f"compute {rec['compute_s'] * 1e3:.3f} ms memory "
                 f"{rec['memory_s'] * 1e3:.3f} ms collective "
                 f"{rec['collective_s'] * 1e3:.3f} ms")
        if tool == "dryrun":
            per_device[arch, shape, mesh, layers] = rec["bytes_per_device"]
            say(f"tools (a) ({card}): dryrun {arch} {shape} {mesh} "
                f"({rec['chips']} ranks, {layers} of "
                f"{get_config(arch).n_layers} layers traced): traced in "
                f"{rec['compile_s']:.1f} s, "
                f"{rec['bytes_per_device'] / 1e9:.2f} GB a device at that "
                f"depth (PERF.md holds the full-depth CPU traces), "
                f"{terms}, dominant {rec['dominant']} at fraction "
                f"{rec['roofline_fraction']:.4f} on gpu_h100, collectives "
                f"{rec['collective_counts']}")
            if shape.startswith("train") and \
                    sum(rec["collective_counts"].values()) < 1:
                bad.append(f"dryrun {arch} {shape}: no collective counted")
        else:
            say(f"tools (b) ({card}): costprobe {arch} {shape} {mesh}: "
                f"{terms}, useful_ratio {rec['useful_ratio']:.4f}, dominant "
                f"{rec['dominant']}, probed in {rec['probe_s']:.1f} s")
    cell = ("phi4-mini-3.8b", "train_4k", "pod")
    if (*cell, 1) in per_device and (*cell, 2) in per_device:
        grow = per_device[(*cell, 2)] - per_device[(*cell, 1)]
        say(f"tools (a) ({card}): the second layer of the dryrun's phi4-mini "
            f"train_4k adds {grow / 1e9:.3f} GB a device (a unit's input "
            f"and that layer's share of the state kept; the activations "
            f"recomputed a unit in the backward)")
    if bad:
        fail("phase 4n: " + "; ".join(bad))


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """Median device ms of `fn()` by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def check_probe_prefill(torch, got, want, log, cfg, b: int, s: int,
                        card: str) -> None:
    """Phase 4n (c): the "cuda" prefill probe's block output and the cache
    entry it filled, against the "torch" rung's on the same inputs (phase
    5's bounds); then K7 at the probe's (B, H, S, D) and K1 at each plan
    of the run (its M x K x N, schedule and tiles, no epilogue) against
    their plain versions (the kernel tolerance)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import skew_matmul as mm
    for (name, g), w in zip([("out", got[0])] + sorted(got[1].items()),
                            [want[0]] + [want[1][k] for k in sorted(got[1])]):
        diff = (g.float() - w.float()).abs()
        rel_max = diff.max().item() / w.float().abs().max().item()
        rel_mean = diff.mean().item() / w.float().abs().mean().item()
        say(f"tools (c) ({card}): prefill probe {name} {tuple(g.shape)} "
            f"\"cuda\" against \"torch\": rel max {rel_max:.3e}, mean "
            f"{rel_mean:.3e} (bounds {PATH_TOL_MAX} / {PATH_TOL_MEAN})")
        if not (rel_max <= PATH_TOL_MAX and rel_mean <= PATH_TOL_MEAN):
            fail(f"phase 4n (c): the cuda prefill probe's {name} disagrees "
                 f"with the torch rung's")
    errs: dict = {}
    check = functools.partial(check_kernel, torch, errs)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4096)
    bf = torch.bfloat16
    q, k, v = _qkv(torch, gen, b, cfg.n_heads, cfg.n_kv_heads, s,
                   cfg.head_dim, bf)
    check("flash_attention", fa.flash_attention_cuda(q, k, v),
          fa.flash_attention_plain(q, k, v), bf,
          f"probe {b}x{cfg.n_heads}/{cfg.n_kv_heads}x{s}x{cfg.head_dim}")
    del q, k, v
    plans = {}
    for c in log:
        if hasattr(c, "plan") and not hasattr(c, "layout"):
            d, pl = c.dims, c.plan
            rows = d.m if pl.batch_grid else d.m * d.batch
            plans[(rows, d.k, d.n, pl.schedule, pl.bm, pl.bk, pl.bn)] = c
    for (m, kk, n, sched, bm, bk, bn) in sorted(plans):
        tag = f"probe {m}x{kk}x{n} ({bm}, {bk}, {bn})"
        if sched not in ("k_inner", "a_resident", "b_resident"):
            say(f"tools (c) ({card}): plan {sched} {tag} held by the block "
                f"check only")
            continue
        a = torch.randn((m, kk), generator=gen, device="cuda").to(bf)
        w = (torch.randn((kk, n), generator=gen, device="cuda")
             * kk ** -0.5).to(bf)
        got_mm = mm.skew_matmul_cuda(a, w, bm=bm, bk=bk, bn=bn,
                                     schedule=sched, out_dtype=bf)
        torch.cuda.synchronize()
        check(f"skew_matmul_{sched}", got_mm,
              mm.skew_matmul_plain(a, w, bk=bk, out_dtype=bf), bf, tag)
        del a, w, got_mm
    if not any(n.startswith("skew_matmul") for n in errs):
        fail("phase 4n (c): no K1 plan of the prefill probe was checked")


def phase_launch_tools(torch, card: str) -> dict:
    """Phase 4n (the seventeenth main path): the dryrun and costprobe
    cells in subprocesses, and the train probe's count checked on the
    card (see the module docstring)."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import config as mmcfg
    from repro_torch.core import roofline, skewmm
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch import costprobe
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers

    t_phase = time.perf_counter()
    out = ROOT / "build" / "smoke_tools"
    procs = launch_tools_procs(out)

    # (c) the train probe of one block, fake and real, on a one-rank mesh
    arch, kind, b, s = PROBE_BLOCK
    mesh = make_host_mesh(device="cuda")
    counts = {}
    try:
        probes = {"fake": costprobe.CellProber(arch, "train_4k", "pod",
                                               mesh=mesh),
                  "real": costprobe.CellProber(arch, "train_4k", "pod",
                                               mesh=mesh, seed=0)}
        for tag, prober in probes.items():
            with prober._scope(), mmcfg.mm_config(backend="torch"), \
                    layers.chunk_override(*costprobe.SINGLE_TRIP):
                f, args, _ = prober.block_train_step(kind, b, s)
                run = shd.on_mesh(f, mesh)
                fc = FlopCounterMode(display=False)
                with fc:
                    run(*args)
                _, cost = roofline.measure(run, *args)
                counts[tag] = (fc.get_total_flops(), cost.flops, cost.bytes)
                if tag == "real":
                    real_ms = cuda_ms(torch, lambda: run(*args))
                del f, args, run
        with probes["fake"]._scope(), mmcfg.mm_config(backend="torch"):
            block = probes["fake"]._probe_block_train(kind, b, s)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    (fc_fake, pc_fake, by_fake), (fc_real, pc_real, by_real) = \
        counts["fake"], counts["real"]
    h100 = "gpu_h100"
    rep = roofline.analyze(
        roofline.ProgramCost(block.flops, block.bytes, block.coll_bytes,
                             block.coll_counts, 0),
        arch=arch, shape=f"b{b} s{s}", mesh="1 rank", chips=1,
        model_flops=0.0, chip=h100)
    eager = roofline.analyze(
        roofline.ProgramCost(pc_fake, by_fake, 0.0, {}, 0), arch=arch,
        shape="", mesh="", chips=1, model_flops=0.0, chip=h100)
    say(f"tools (c) ({card}): {arch} {kind} block train probe at b {b} x s "
        f"{s} on a one-rank NCCL mesh (\"torch\" rung, single-trip "
        f"attention): FlopCounterMode fake {fc_fake} real {fc_real}, "
        f"roofline.measure fake {pc_fake:.0f} real {pc_real:.0f}; bytes "
        f"fake {by_fake:.0f} real {by_real:.0f}; device {real_ms:.3f} ms "
        f"(CUDA events, median of 3) beside the probe's compute "
        f"{rep.compute_s * 1e3:.3f} ms, memory {rep.memory_s * 1e3:.3f} ms "
        f"with K7's flash traffic, {eager.memory_s * 1e3:.3f} ms at the "
        f"eager bytes, on gpu_h100")
    if fc_fake != fc_real or pc_fake != pc_real or fc_real <= 0:
        fail(f"phase 4n (c): the fake trace counts {fc_fake} / {pc_fake} "
             f"FLOPs, the card's run {fc_real} / {pc_real}")

    # the same block's prefill probe through "cuda": K1 and K7 on the card
    fake = costprobe.CellProber(arch, "prefill_32k", "pod", mesh=None)
    with fake._scope(), mmcfg.mm_config(backend="torch"):
        serve = fake._probe_block_serve(kind, b, s, mode="prefill")
    terms = roofline.analyze(
        roofline.ProgramCost(serve.flops, serve.bytes, 0.0, {}, 0),
        arch=arch, shape="", mesh="", chips=1, model_flops=0.0, chip=h100)
    real = costprobe.CellProber(arch, "prefill_32k", "pod", mesh=None,
                                seed=0)
    with mmcfg.mm_config(backend="cuda"):
        f, args, _ = real.block_serve_step(kind, b, s, mode="prefill")
        ops.reset_launch_counts()
        # ---- the main path: counts zeroed above, read right after it.
        with skewmm.plan_capture() as log:
            got = f(*args)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        # ---- end of the main path.
        prefill_ms = cuda_ms(torch, lambda: f(*args))
    with mmcfg.mm_config(backend="torch"):
        want = f(*args)
    check_probe_prefill(torch, got, want, log, real.cfg, b, s, card)
    del f, args, got, want
    torch.cuda.empty_cache()
    say(f"tools (c) ({card}): the block's prefill probe through \"cuda\" "
        f"(launches {counts}): {prefill_ms:.3f} ms device beside its serve "
        f"terms compute {terms.compute_s * 1e3:.3f} ms memory "
        f"{terms.memory_s * 1e3:.3f} ms on gpu_h100")
    for name in ("skew_matmul", "flash_attention"):
        if not any(n.startswith(name) for n in counts):
            fail(f"phase 4n (c): the cuda prefill probe launched no {name}")

    collect_launch_tools(procs, out, card)
    say(f"tools ({card}): phase 4n took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts}


# Phase 4p: the port's examples, each run by the interpreter from its own
# file as a user runs it (the planner demo as written, two serves at their
# defaults, the tiny LM at 40 steps, the quickstart), in waves run one after
# another: the demo, the serves and the tiny LM alone, so their times are
# the card's own; the quickstart, which reports no time, beside the
# in-process check of the serves' kernels (`check_served_kernels`), which
# reports none either.  Checkpoints and each process's output go under
# build/examples/ (removed after).
EXAMPLE_WAVES = (
    (("skewmm_planner_demo_torch", ()),),
    (("serve_decode_torch", ("--arch", "gemma2-27b")),),
    (("serve_decode_torch", ("--arch", "mamba2-2.7b")),),
    (("train_tiny_lm_torch", ("--steps", "40", "--ckpt-dir",
                              "{dir}/tiny-lm")),),
    (("quickstart_torch", ("--ckpt-dir", "{dir}/quickstart")),),
)
EXAMPLES_TIMEOUT = 300
# what each example must have launched on the card
EXAMPLE_KERNELS = {
    "skewmm_planner_demo_torch": ("skew_matmul_k_inner",),
    "gemma2-27b": ("skew_matmul_k_inner", "flash_attention"),
    "mamba2-2.7b": ("skew_matmul_k_inner", "ssd_scan"),
}
# serve_decode_torch's defaults: batch, prompt length, decode steps
SERVED = (4, 64, 48)
# what `check_served_kernels` records: module, dispatch function, count prefix
SERVED_HELD = {"skew_matmul": ("skew_matmul", "skew_matmul_"),
               "flash_attention": ("flash_attention", "flash_attention"),
               "ssd_scan": ("ssd_scan", "ssd_")}


def _kept(torch, t):
    """A copy of `t` with its storage, offset and strides (a view keeps
    the gaps the kernel reads past)."""
    if not isinstance(t, torch.Tensor):
        return t
    out = torch.empty(0, dtype=t.dtype, device=t.device)
    return out.set_(t.untyped_storage().clone(), t.storage_offset(),
                    t.size(), t.stride())


def _call_key(args, kw) -> tuple:
    return tuple((tuple(a.shape), tuple(a.stride()), str(a.dtype))
                 if hasattr(a, "shape") else repr(a) for a in args) + \
        tuple(sorted((k, repr(v)) for k, v in kw.items()))


@contextlib.contextmanager
def recorded_calls(torch):
    """Within the block, the first call of each signature to K1's dense
    dispatch, K7's and K8's, their inputs kept: {module: {signature:
    (args, kw)}}."""
    import importlib
    calls = {name: {} for name in SERVED_HELD}
    saved = []
    for name, (fn, _) in SERVED_HELD.items():
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        orig = getattr(mod, fn)

        def rec(*args, _orig=orig, _seen=calls[name], **kw):
            _seen.setdefault(_call_key(args, kw), (
                [_kept(torch, a) for a in args], dict(kw)))
            return _orig(*args, **kw)
        saved.append((mod, fn, orig))
        setattr(mod, fn, rec)
    try:
        yield calls
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


def served_run(torch, params, cfg, backend: str, toks, nxt=None):
    """The served example's prefill and one eager decode step (the step its
    graph replays) under `backend`: (prefill logits, decode logits, the
    token fed)."""
    from repro_torch.core import config as mmcfg
    from repro_torch.serve import engine
    _, prompt, gen = SERVED
    with mmcfg.mm_config(backend=backend):
        cache, logits = engine.prefill(params, cfg, toks,
                                       max_len=prompt + gen)
        if nxt is None:
            nxt = torch.argmax(logits, -1)
        step, _ = engine.decode_step(params, cfg, cache, nxt, prompt)
    torch.cuda.synchronize()
    return logits, step, nxt


def hold_served_calls(torch, check, calls, arch: str) -> int:
    """Each recorded call against its plain version on the same inputs (the
    kernel tolerance); the number held."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import skew_matmul as mm
    from repro_torch.kernels import ssd_scan as ssd
    held = 0
    for args, kw in calls["skew_matmul"].values():
        a, b = args[:2]
        sched, odt = kw.get("schedule", "k_inner"), kw["out_dtype"]
        ep = "+".join(t for t, _ in kw.get("epilogue") or ()) or "none"
        got = mm.skew_matmul_cuda(*args, **kw)
        want = mm.skew_matmul_plain(*args, bk=kw["bk"],
                                    epilogue=kw.get("epilogue"),
                                    out_dtype=odt)
        torch.cuda.synchronize()
        check(f"skew_matmul_{sched}", got, want, odt,
              f"{arch} {a.shape[0]}x{a.shape[1]}x{b.shape[1]} "
              f"({kw['bm']}, {kw['bk']}, {kw['bn']}) {ep}")
        held += 1
    for (q, k, v), kw in calls["flash_attention"].values():
        got = fa.flash_attention_cuda(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check("flash_attention", got, want, q.dtype,
              f"{arch} {tuple(q.shape)} kv {k.shape[1]} "
              f"window {kw.get('window')} softcap {kw.get('softcap')}")
        held += 1
    for args, kw in calls["ssd_scan"].values():
        chunk = kw.get("chunk", 128)
        y, st = ssd.ssd_scan_cuda(*args, chunk=chunk, return_state=True)
        y_w, st_w = ssd.ssd_scan_plain(*args, chunk=chunk,
                                       return_state=True)
        torch.cuda.synchronize()
        tag = f"{arch} {tuple(args[0].shape)} chunk {chunk}"
        check("ssd_scan", y, y_w, args[0].dtype, f"{tag} y")
        check("ssd_scan", st, st_w, torch.float32, f"{tag} fp32 state")
        if args[0].shape[1] > chunk:
            ssd_pieces_check(torch, check, args, chunk, tag)
        held += 1
    return held


def check_served_kernels(torch, card: str) -> None:
    """Phase 4p: the served examples' kernels at the shapes they ran.  For
    gemma2-27b and mamba2-2.7b, the example's model (reduced, weights from
    seed 0) and prompts (numpy seed 0) once more in this process: the
    prefill and one eager decode step through "cuda", with the first call
    of each signature to K1, K7 and K8 recorded, against the "torch" rung
    on the same inputs (phase 5's bounds); then each recorded call against
    its plain version (the kernel tolerance).  A kernel the run launched
    that no recorded call holds fails the phase, as does a "torch" run
    that launched any.  These launches come after the examples' counts
    were read and join no count."""
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    batch, prompt, _ = SERVED
    t0 = time.perf_counter()
    for arch in ("gemma2-27b", "mamba2-2.7b"):
        cfg = get_config(arch).reduced()
        params = build_model(cfg, "cuda").init(0)
        toks = torch.tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (batch, prompt)), dtype=torch.long,
            device="cuda")
        ops.reset_launch_counts()
        with recorded_calls(torch) as calls:
            got = served_run(torch, params, cfg, "cuda", toks)
        ran = {k for k, v in ops.launch_counts().items() if v}
        prefixes = tuple(pre for _, pre in SERVED_HELD.values())
        unheld = sorted(k for k in ran if not k.startswith(prefixes))
        if unheld:
            fail(f"phase 4p: the {arch} serve launched {unheld}, which no "
                 f"recorded call holds")
        ops.reset_launch_counts()
        want = served_run(torch, params, cfg, "torch", toks, nxt=got[2])
        if any(ops.launch_counts().values()):
            fail(f"phase 4p: the {arch} \"torch\" rung launched "
                 f"{ops.launch_counts()}")
        for what, g, w in (("prefill", got[0], want[0]),
                           ("decode", got[1], want[1])):
            diff = (g.float() - w.float()).abs()
            rel_max = diff.max().item() / w.float().abs().max().item()
            rel_mean = diff.mean().item() / w.float().abs().mean().item()
            say(f"examples ({card}): {arch} {what} logits {tuple(g.shape)} "
                f"\"cuda\" against \"torch\": rel max {rel_max:.3e}, mean "
                f"{rel_mean:.3e} (bounds {PATH_TOL_MAX} / {PATH_TOL_MEAN})")
            if not (rel_max <= PATH_TOL_MAX and rel_mean <= PATH_TOL_MEAN):
                fail(f"phase 4p: the {arch} serve's {what} logits through "
                     f"\"cuda\" disagree with the torch rung's")
        errs: dict = {}
        held = hold_served_calls(
            torch, functools.partial(check_kernel, torch, errs), calls, arch)
        for name in EXAMPLE_KERNELS[arch]:
            if name not in errs:
                fail(f"phase 4p: no {name} call of the {arch} serve was "
                     f"held against its plain version")
        say(f"examples ({card}): {arch} serve: {held} kernel calls of "
            f"distinct signature held against their plain versions; "
            f"largest errors {errs}")
        del params, calls, got, want
        torch.cuda.empty_cache()
    say(f"examples ({card}): the serves' kernels held in "
        f"{time.perf_counter() - t0:.1f} s")


def run_wave(wave, env, out_dir: Path, beside=None) -> list[tuple]:
    """Start a wave's examples together, call `beside()` (if given) while
    they run, and wait for all of them: for each, (name, its JSON summary,
    wall s, stdout).  A failure kills the rest."""
    procs = []
    try:
        for i, (name, argv) in enumerate(wave):
            argv = [a.format(dir=out_dir) for a in argv]
            log = out_dir / f"{name}-{i}"
            cmd = [sys.executable, str(ROOT / "examples" / f"{name}.py"),
                   *argv]
            with open(f"{log}.out", "w") as out, \
                    open(f"{log}.err", "w") as err:
                procs.append((name, argv, log, time.perf_counter(),
                              subprocess.Popen(cmd, env=env, cwd=ROOT,
                                               stdout=out, stderr=err)))
        if beside is not None:
            beside()
        done = []
        for name, argv, log, t0, proc in procs:
            try:
                rc = proc.wait(timeout=EXAMPLES_TIMEOUT)
            except subprocess.TimeoutExpired:
                fail(f"phase 4p: {name} {' '.join(argv)}: timed out")
            wall = time.perf_counter() - t0
            stdout = Path(f"{log}.out").read_text()
            if rc != 0:
                err = Path(f"{log}.err").read_text()
                fail(f"phase 4p: {name} {' '.join(argv)}: rc {rc}: "
                     f"{err.strip()[-1500:]}")
            try:
                summary = json.loads(stdout.strip().splitlines()[-1])
            except (IndexError, json.JSONDecodeError):
                fail(f"phase 4p: {name}: no JSON summary on its last line")
            done.append((name, summary, wall, stdout))
        return done
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def finite_losses(tag: str, history) -> list[float]:
    losses = [loss for _, loss in history]
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"phase 4p: {tag}: losses {losses}")
    return losses


def check_example(card: str, name: str, res: dict, stdout: str) -> str:
    """Gate one example's summary and print what it measured; its tag."""
    tag = res["arch"] if name == "serve_decode_torch" else name
    missing = [k for k in EXAMPLE_KERNELS.get(tag, ())
               if not res["launches"].get(k)]
    if missing:
        fail(f"phase 4p: {tag} launched no {missing}: {res['launches']}")
    if name == "skewmm_planner_demo_torch":
        for key in ("k1_err", "k1_epilogue_err"):
            if not res[key] <= FP32_TOL:
                fail(f"phase 4p: demo {key} {res[key]:.3e} over "
                     f"{FP32_TOL:.0e} of the largest magnitude")
        say(f"examples ({card}): demo K1 {res['plan']} at 96 x 1024 x 4096 "
            f"fp32: {res['k1_us']:.2f} us (CUDA events) beside "
            f"{res['modeled_us']:.2f} us modeled on gpu_h100; max|err| / "
            f"max|oracle| {res['k1_err']:.2e}, with the fused epilogue "
            f"{res['k1_epilogue_err']:.2e}")
    elif name == "serve_decode_torch":
        ids = [t for row in res["tokens"] for t in row]
        if not res["logits_finite"] or not all(
                0 <= t < res["vocab"] for t in ids):
            fail(f"phase 4p: {tag}: finite={res['logits_finite']}, ids in "
                 f"[{min(ids)}, {max(ids)}] of {res['vocab']}")
        say(f"examples ({card}): serve {tag} reduced b4 p64 g48: prefill "
            f"{res['prefill_s'] * 1e3:.1f} ms, decode {res['tok_per_s']:.1f} "
            f"tok/s (graphed), cache {res['cache_bytes'] / 2**20:.2f} MiB, "
            f"launches {res['launches']}")
    else:
        losses = finite_losses(tag, res["history"])
        steps = [ln for ln in stdout.splitlines()
                 if ln.startswith("[trainer]")]
        say(f"examples ({card}): {tag}: " + "; ".join(steps))
        if name == "train_tiny_lm_torch":
            if not losses[-1] < losses[0]:
                fail(f"phase 4p: tiny LM loss did not fall: {losses}")
            say(f"examples ({card}): tiny LM {res['params'] / 1e6:.1f}M "
                f"params fp32, b4 x 256, 2 microbatches, over the host "
                f"mesh: "
                f"{res['step_ms']:.1f} ms a step, "
                f"{res['tokens_per_s']:.0f} tokens/s")
    return tag


def phase_examples(torch, card: str) -> dict:
    """Phase 4p (the nineteenth main path): every example of the port on
    the card in its own process (see the module docstring).  Each example
    zeroes the launch counts at its start and prints them at its end; their
    sum joins the kernels line."""
    import shutil
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + (os.pathsep + env["PYTHONPATH"]
                                    if env.get("PYTHONPATH") else "")
    out_dir = ROOT / "build" / "examples"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    counts = collections.Counter()
    walls = []
    t0 = time.perf_counter()
    try:
        for i, wave in enumerate(EXAMPLE_WAVES, 1):
            beside = functools.partial(check_served_kernels, torch, card) \
                if i == len(EXAMPLE_WAVES) else None
            for name, res, wall, stdout in run_wave(wave, env, out_dir,
                                                    beside):
                tag = check_example(card, name, res, stdout)
                walls.append(f"{tag} {wall:.1f} s")
                counts.update(res["launches"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    say(f"examples ({card}): wall s each: " + ", ".join(walls) +
        f"; the phase {time.perf_counter() - t0:.1f} s")
    return {"counts": counts}


def _flat_tensors(state) -> dict:
    """{path key: tensor} of a TrainState's params and moments (the
    checkpoint's keys, per layer), left on their device."""
    from repro_torch.checkpoint.ckpt import _walk
    out = {}
    for key, leaf in _walk(state._replace(rng=None, opt=state.opt._replace(
            step=None)), ()):
        if isinstance(leaf, list):
            for r, t in enumerate(leaf):
                out[f"{key}[{r}]"] = t
        elif leaf is not None:
            out[key] = leaf
    return out


# ----------------------------------------------------------------- --profile
def profile_steps(torch, cfg, params) -> None:
    """torch.profiler over one prefill and one decode step (batch 4): device
    time by kernel and the device's busy share of the host-clock step.
    Run only with --profile; not part of the smoke's contract."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import encdec_engine, engine, graphs
    toks = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda")
    if cfg.family == "encdec":
        frames = torch.randn((4, cfg.frontend_len, cfg.d_model),
                             device="cuda")
        step_fn = encdec_engine.decode_step

        def prefill():
            return encdec_engine.prefill(params, cfg, frames, toks,
                                         max_len=144)
    else:
        step_fn = engine.decode_step

        def prefill():
            return engine.prefill(params, cfg, toks, max_len=144)
    cache, logits = prefill()
    nxt = torch.argmax(logits, -1)
    step_fn(params, cfg, cache, nxt, 128)
    graph = graphs.DecodeGraph(params, cfg, cache, 4)
    graph.step(nxt, 129)
    torch.cuda.synchronize()
    for what in ("prefill", "decode", "decode-graph"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                prefill()
            elif what == "decode":
                step_fn(params, cfg, cache, nxt, 130)
            else:
                graph.step(nxt, 131)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        # kernel rows only: an operator row carries its kernels' time too
        dev_us = sum(e.self_device_time_total for e in ka
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False))
        n_kernels = sum(e.count for e in ka
                        if e.device_type == DeviceType.CUDA)
        say(f"profile {what}: host-clock {wall * 1e3:.2f} ms, device busy "
            f"{dev_us / 1e3:.2f} ms ({dev_us / 1e4 / wall:.1f}% of the "
            f"step), {n_kernels} device events")
        print(ka.table(sort_by="self_device_time_total", row_limit=12),
              flush=True)


# ----------------------------------------------------------------- main
def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    if not (SRC / "repro_torch" / "csrc" / "skew_matmul.cu").exists():
        fail(f"no port sources under {SRC}: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    card = phase_env(torch)
    phase_build()
    if "--tools-only" in sys.argv[1:]:       # phase 4n alone, no contract
        guarded("phase 4n", phase_launch_tools, torch, card)
        return
    if "--examples-only" in sys.argv[1:]:    # phase 4p alone, no contract
        guarded("phase 4p", phase_examples, torch, card)
        return

    from repro_torch.configs.base import get_config
    cfg = get_config("phi4-mini-3.8b")
    say(f"config: {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads}/{cfg.n_kv_heads} ff={cfg.d_ff} V={cfg.vocab_size}")
    errs = guarded("phase 3", phase_parity, torch, cfg)
    main_path = guarded("phase 4", phase_serve, torch, cfg)
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, cfg, main_path["params"])
    guarded("phase 5", phase_path_parity, torch, cfg, main_path["params"])
    rows = guarded("phase 6", phase_timings, torch, cfg, main_path["params"],
                   main_path["counts"], errs)
    say("guard: the ladder, the scrub and the obs spans on the card (phase "
        "6g), phi4-mini's weights still loaded")
    guard_path = guarded("phase 6g", phase_guard_obs, torch, cfg,
                         main_path["params"])
    say("sched: the continuous-batching scheduler serving phi4-mini from a "
        "request stream under a tune cache measured on the card (phase 6h)")
    sched_path = guarded("phase 6h", phase_sched, torch, cfg,
                         main_path["params"], errs)
    phi4_counts, phi4_graph = main_path["counts"], main_path["graph"]
    del main_path                   # free phi4's weights
    torch.cuda.empty_cache()

    dcfg = dataclasses.replace(get_config("dbrx-132b"),
                               n_layers=DBRX_LAYERS)
    say(f"config: {dcfg.name} L={dcfg.n_layers} (of 40) d={dcfg.d_model} "
        f"H={dcfg.n_heads}/{dcfg.n_kv_heads} E={dcfg.n_experts} "
        f"top-{dcfg.n_experts_per_tok} ff={dcfg.moe_d_ff} "
        f"V={dcfg.vocab_size}")
    errs.update(guarded("phase 3b", phase_parity_grouped, torch, dcfg))
    moe_path = guarded("phase 4b", phase_serve_moe, torch, dcfg)
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, dcfg, moe_path["params"])
    params2 = first_layers(moe_path.pop("params"), DBRX_PARITY_LAYERS)
    torch.cuda.empty_cache()
    guarded("phase 5b", phase_path_parity, torch, dataclasses.replace(
        dcfg, n_layers=DBRX_PARITY_LAYERS), params2)
    rows += guarded("phase 6b", phase_timings_grouped, torch, dcfg, params2,
                    moe_path["counts"], errs)
    del params2
    torch.cuda.empty_cache()

    hcfg = get_config("recurrentgemma-9b")
    say(f"config: {hcfg.name} L={hcfg.n_layers} {hcfg.layer_pattern} "
        f"d={hcfg.d_model} H={hcfg.n_heads}/{hcfg.n_kv_heads} "
        f"hd={hcfg.head_dim} W={hcfg.lru_width} window={hcfg.local_window} "
        f"ff={hcfg.d_ff} V={hcfg.vocab_size}")
    fa_shapes, scan_shapes = seq_shapes(cfg, dcfg, hcfg)
    errs.update(guarded("phase 3c", phase_parity_seq, torch, fa_shapes,
                        scan_shapes))
    hyb_path = guarded("phase 4c", phase_serve_hybrid, torch, hcfg)
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, hcfg, hyb_path["params"])
    params3 = first_layers(hyb_path.pop("params"), HYBRID_PARITY_UNITS)
    torch.cuda.empty_cache()
    n3 = HYBRID_PARITY_UNITS * len(hcfg.layer_pattern)
    guarded("phase 5c", phase_path_parity, torch,
            dataclasses.replace(hcfg, n_layers=n3), params3)
    del params3
    torch.cuda.empty_cache()
    rows += guarded("phase 6c", phase_timings_seq, torch, fa_shapes,
                    scan_shapes, hyb_path["counts"], errs)
    torch.cuda.empty_cache()

    scfg = get_config("mamba2-2.7b")
    say(f"config: {scfg.name} L={scfg.n_layers} d={scfg.d_model} "
        f"d_inner={scfg.d_inner} H={scfg.ssm_heads} P={scfg.ssm_head_dim} "
        f"G={scfg.ssm_groups} S={scfg.ssm_state} chunk={scfg.ssm_chunk} "
        f"V={scfg.vocab_size}")
    shapes = ssd_shapes(scfg)
    errs.update(guarded("phase 3d", phase_parity_ssd, torch, shapes,
                        scfg.ssm_chunk))
    ssm_path = guarded("phase 4d", phase_serve_ssm, torch, scfg)
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, scfg, ssm_path["params"])
    params4 = first_layers(ssm_path.pop("params"), SSM_PARITY_LAYERS)
    torch.cuda.empty_cache()
    guarded("phase 5d", phase_path_parity, torch, dataclasses.replace(
        scfg, n_layers=SSM_PARITY_LAYERS), params4)
    del params4
    torch.cuda.empty_cache()
    rows += guarded("phase 6d", phase_timings_ssd, torch, shapes,
                    scfg.ssm_chunk, ssm_path["counts"], errs)
    torch.cuda.empty_cache()

    say(f"tune: block-sparse matmul (K9) and the measured autotuner at "
        f"{TUNE_TOTAL}^2, n {TUNE_TOTAL}")
    errs.update(guarded("phase 3e", phase_parity_bsr, torch))
    tune_path = guarded("phase 4e", phase_tune, torch)
    for name, err in tune_path["errs"].items():
        errs[name] = max(errs.get(name, 0.0), err)
    rows += guarded("phase 6e", phase_timings_bsr, torch, tune_path["counts"],
                    errs)
    torch.cuda.empty_cache()

    say("fig5: the paper's Figure 5 on the H100 (naive, K-inner-only and "
        "skew-aware plans of the gpu_h100 sweep, bf16)")
    fig5_path = guarded("phase 6f", phase_fig5, torch, errs)

    # The dense archs: gemma2-27b whole, granite-34b cut, command-r-35b
    # whole where it fits.
    gcfg = get_config("gemma2-27b")
    if dense_depth(torch, gcfg) != gcfg.n_layers:
        fail("gemma2-27b's 46 layers do not fit the card")
    gemma_path = guarded(
        "phases 4f / 5f", phase_serve_dense, torch, gcfg,
        ((4, 128, 16), (1, 4608, 4)), gcfg.n_layers,
        GEMMA2_PARITY_UNITS * len(gcfg.layer_pattern))
    granite = get_config("granite-34b")
    granite_path = guarded(
        "phases 4g / 5g", phase_serve_dense, torch,
        dataclasses.replace(granite, n_layers=GRANITE_LAYERS),
        ((4, 128, 16),), granite.n_layers, DENSE_PARITY_LAYERS)
    ccfg = get_config("command-r-35b")
    cr_path = guarded(
        "phases 4h / 5h", phase_serve_dense, torch,
        dataclasses.replace(ccfg, n_layers=dense_depth(torch, ccfg)),
        ((4, 128, 16),), ccfg.n_layers, DENSE_PARITY_LAYERS)

    # deepseek-v3-671b: MLA and 256 experts, cut to 5 of 61 layers.
    ds = get_config("deepseek-v3-671b")
    mcfg = dataclasses.replace(ds, n_layers=DEEPSEEK_LAYERS)
    say(f"config: {mcfg.name} L={mcfg.n_layers} (of {ds.n_layers}; "
        f"{mcfg.first_k_dense} dense) d={mcfg.d_model} H={mcfg.n_heads} "
        f"MLA q_lora={mcfg.q_lora_rank} kv_lora={mcfg.kv_lora_rank} "
        f"qk={mcfg.qk_nope_dim}+{mcfg.qk_rope_dim} v={mcfg.v_head_dim} "
        f"E={mcfg.n_experts} top-{mcfg.n_experts_per_tok} "
        f"shared={mcfg.n_shared_experts} ff={mcfg.d_ff}/{mcfg.moe_d_ff} "
        f"V={mcfg.vocab_size} mtp={mcfg.mtp_heads}")
    mla_path = guarded("phase 4i", phase_serve_mla, torch, mcfg,
                       ds.n_layers)
    n_parity, k_parity = DEEPSEEK_PARITY
    params6 = mla_parity_params(mla_path.pop("params"), k_parity,
                                n_parity - k_parity)
    gc.collect()          # the served layers left out of params6 go now
    torch.cuda.empty_cache()
    guarded("phase 5i", phase_path_parity, torch, dataclasses.replace(
        mcfg, n_layers=n_parity, first_k_dense=k_parity), params6,
        consume=True, routed_rows=True)
    del params6
    torch.cuda.empty_cache()
    mla_rows = guarded("phase 6i", phase_timings_mla, torch, mcfg,
                       mla_path["counts"], errs)
    torch.cuda.empty_cache()

    # internvl2-1b whole, without and with its patch prefix; then
    # seamless-m4t-large-v2 whole, its parity at 2 + 2 layers.
    vcfg = get_config("internvl2-1b")
    vlm_path = guarded("phase 4j", phase_serve_vlm, torch, vcfg)
    guarded("phase 5j", phase_path_parity, torch, vcfg, vlm_path["params"],
            prefix=vlm_path.pop("prefix"))
    torch.cuda.empty_cache()
    ecfg = get_config("seamless-m4t-large-v2")
    ed_path = guarded("phase 4k", phase_serve_encdec, torch, ecfg)
    n_ed = ENCDEC_PARITY_LAYERS
    _, frames = seeded_frames(torch, ecfg, 4, 128)
    guarded("phase 5k", phase_path_parity, torch, dataclasses.replace(
        ecfg, n_layers=n_ed, enc_layers=n_ed),
        encdec_parity_params(ed_path["params"], n_ed), frames=frames)
    del frames
    torch.cuda.empty_cache()
    jk_counts = {n: vlm_path["counts"].get(n, 0) + ed_path["counts"].get(n, 0)
                 for n in KERNELS}
    jk_rows = guarded("phase 6j", phase_timings_vlm_encdec, torch, vcfg,
                      vlm_path.pop("params"), ecfg, ed_path.pop("params"),
                      jk_counts, errs)
    torch.cuda.empty_cache()

    # phi4-mini trained at full width and 16 of 32 layers, then the step's
    # parity with the CPU and the resume at the reduced config.
    train_path = guarded("phase 4l", phase_train, torch, dataclasses.replace(
        cfg, n_layers=TRAIN_LAYERS), card)
    torch.cuda.empty_cache()
    long_path = guarded("phase 4o", phase_train_long, torch,
                        dataclasses.replace(cfg, n_layers=TRAIN_LAYERS), card)
    torch.cuda.empty_cache()
    guarded("phase 5l", phase_train_parity, torch, card)
    torch.cuda.empty_cache()

    # the mesh: a one-rank NCCL DeviceMesh, dbrx's MoE layers through the
    # expert-parallel path, phi4's trainer on the mesh, the elastic restore
    mesh_path = guarded("phases 4m / 5m", phase_mesh, torch, dcfg, cfg, card,
                        train_path["step_ms"])
    torch.cuda.empty_cache()

    # the launch tools: dryrun and costprobe on fake process groups, the
    # probe's count checked on the card
    tools_path = guarded("phase 4n", phase_launch_tools, torch, card)
    torch.cuda.empty_cache()

    # the port's examples, each in its own process
    examples_path = guarded("phase 4p", phase_examples, torch, card)

    say("served decode, ms per token (host clock): " + "; ".join(
        f"{g['tag']} graphed {g['graph_ms']:.2f} eager {g['eager_ms']:.2f}"
        for path in (phi4_graph, moe_path, hyb_path, ssm_path, gemma_path,
                     granite_path, cr_path, mla_path, vlm_path, ed_path)
        for g in (path if isinstance(path, list) else path["graph"])))

    # One entry per kernel for the contract line (the LM-head shape for
    # K1-K4, the dbrx decode gate/up shape for K5, recurrentgemma's batch-4
    # prefill for K6 and K7, mamba2's for K8, the tuner's 4096^2 (32, 128)
    # d 0.25 layout for K9), then deepseek's rows of phase 6i (K7 at MLA's
    # 192 / 128 widths, K5 at 256 groups) and phase 6j's rows (K7 at the
    # VLM and encoder-decoder shapes, Sq != Skv among them, and K1 at the
    # odd LM heads) with their "shape"; the other shapes are in the log
    # above.  Launches: summed over the nineteen main paths (training runs
    # none; phase 4n's prefill probe runs K1 and K7); a deepseek
    # row's are those of the deepseek path, a phase 6j row's those of the
    # internvl2-1b and seamless-m4t paths.
    launches = {n: sum(c.get(n, 0) for c in (
        phi4_counts, moe_path["counts"], hyb_path["counts"],
        ssm_path["counts"], tune_path["counts"], fig5_path["counts"],
        gemma_path["counts"], granite_path["counts"], cr_path["counts"],
        guard_path["counts"], sched_path["counts"], mla_path["counts"],
        vlm_path["counts"], ed_path["counts"], train_path["counts"],
        long_path["counts"], mesh_path["counts"], tools_path["counts"],
        examples_path["counts"]))
        for n in KERNELS}
    first = {}
    for r in rows:
        first.setdefault(r["name"], r)
    kernels = [{k: val for k, val in r.items() if k != "shape"}
               for r in first.values()]
    for r in kernels:
        r["launches"] = int(launches[r["name"]])
    kernels += mla_rows + jk_rows
    for r in kernels:
        for key in ("ms", "plain_ms", "bound_ms"):
            if not (isinstance(r[key], float) and math.isfinite(r[key])):
                fail(f"{r['name']}: {key} not measured")
    if sorted(set(r["name"] for r in kernels)) != sorted(KERNELS):
        fail("the kernels line does not list every kernel")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
