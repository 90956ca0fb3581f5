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
  7. the served decode ms per token, graphed and eager, of every run; the
     `kernels` JSON line (K1-K9, K8's three kernels apart; launches summed
     over the ten main paths), then the device line.
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
import dataclasses
import functools
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
                   gen: int, bitwise: bool) -> dict:
    """`serve()` decoded through its CUDA graph; decode the same prompt once
    more with an eager loop over `engine.decode_step`: the same prefill,
    the served tokens fed back step by step, and the same seeded sampler
    choosing a token from each step's logits.

    bitwise: the eager choices and the first and last decode logits must
    equal the graphed run's bit for bit (the same kernels in the same
    order).  Otherwise (dbrx, whose MoE combine is an fp32 `index_add_`
    in no fixed order on CUDA) the last logits are held to phase 5's
    bounds.  Either way the graph's launches per step must equal those of
    one eager step.  Prints and returns both decode ms per token (host
    clock, each loop ending in a synchronise)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve import engine

    rng = np.random.default_rng(SERVE_SEED)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, prompt)),
                        dtype=torch.long, device="cuda")
    sampler = torch.Generator(device="cuda")
    sampler.manual_seed(SERVE_SEED + 1)
    cache, logits = engine.prefill(params, cfg, toks, max_len=prompt + gen)
    served = res["tokens"].to("cuda")
    chosen = [torch.argmax(logits, -1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(gen):
        if i == 0:
            ops.reset_launch_counts()
        logits, _ = engine.decode_step(params, cfg, cache, served[:, i],
                                       prompt + i)
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
    tag = f"{cfg.name} ({cfg.n_layers} layers) b{batch} p{prompt} g{gen}"
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


def phase_path_parity(torch, cfg, params) -> dict:
    """Prefill and first-decode logits: the "cuda" backend against the
    "torch" backend on the same bf16 weights, and both against an fp32 run
    of the same weights (the "torch" backend on fp32 copies).  For an MoE
    model, also the share of top-k routing choices (every layer, every
    token, prefill and decode) on which "cuda" and "torch" agree."""
    import numpy as np
    from repro_torch.core.config import mm_config
    from repro_torch.models import moe
    from repro_torch.serve import engine

    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)),
                        dtype=torch.long, device="cuda")
    runs = (("cuda", cfg, params), ("torch", cfg, params),
            ("fp32", dataclasses.replace(cfg, dtype="float32"), None))
    out, routes = {}, {}
    for name, c, p in runs:
        if p is None:
            p = _float_tree(params)
        with mm_config(backend="cuda" if name == "cuda" else "torch"), \
                moe.routing_capture() as log:
            cache, pre = engine.prefill(p, c, toks, max_len=144)
            if name == "cuda":
                nxt = torch.argmax(pre, -1)
            dec, _ = engine.decode_step(p, c, cache, nxt, 128)
        out[name] = (pre, dec)
        routes[name] = [r["experts"] for r in log]
        del cache, p
        torch.cuda.empty_cache()
    res = {}
    for i, what in enumerate(("prefill", "decode")):
        got, want, exact = (out[n][i] for n in ("cuda", "torch", "fp32"))
        rel = {}
        for tag, x, y in (("cuda~torch", got, want), ("cuda~fp32", got, exact),
                          ("torch~fp32", want, exact)):
            diff = (x - y).abs()
            rel[tag] = (diff.max().item() / y.abs().max().item(),
                        diff.mean().item() / y.abs().mean().item())
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        say(f"path parity {what}: " + " ".join(
            f"{t} max={a:.3e} mean={b:.3e}" for t, (a, b) in rel.items())
            + f" argmax(cuda)==argmax(torch) {agree:.2f}")
        ok = (rel["cuda~torch"][0] <= PATH_TOL_MAX
              and rel["cuda~torch"][1] <= PATH_TOL_MEAN
              and rel["cuda~fp32"][1] <= PATH_TOL_RATIO
              * rel["torch~fp32"][1])
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
    used = {"grouped_matmul", "flash_attention"}
    for c in log:
        if hasattr(c, "layout"):
            continue
        if c.plan.schedule == "splitk":
            used |= {"gemv_splitk_partial", "gemv_splitk_reduce"}
        elif c.plan.batch_grid and c.dims.batch > 1:
            used.add("skew_matmul_batched")
        else:
            used.add(f"skew_matmul_{c.plan.schedule}")
    for name in sorted(used):
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
    from repro_torch.serve import kvcache

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
        cb = kvcache.cache_bytes(kvcache.init_cache(cfg, b, p + g, "meta"))
        pre_b, dec_b = bounds_fn(cfg, params, b, p, cb)
        bounds.append((pre_b, dec_b))
        say(f"serve {cfg.name} ({cfg.n_layers} layers) b{b} p{p} g{g}: "
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
    for c in log:
        if c.plan.schedule == "splitk":
            name = "gemv_splitk_partial"
        elif c.plan.batch_grid and c.dims.batch > 1:
            name = "skew_matmul_batched"
        else:
            name = f"skew_matmul_{c.plan.schedule}"
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


def sdpa_call(torch, F, q, k, v, window=None):
    """One `scaled_dot_product_attention` call computing causal GQA
    attention on q, k, v; with a window shorter than the sequence, through
    a boolean band mask (col <= row, col > row - window) built here, before
    any timing.  Kv heads are expanded beforehand where this PyTorch takes
    no `enable_gqa` (or not with a mask)."""
    s = q.shape[2]
    kw = dict(is_causal=True)
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
    health.reset()
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


# ----------------------------------------------------------------- --profile
def profile_steps(torch, cfg, params) -> None:
    """torch.profiler over one prefill and one decode step (batch 4): device
    time by kernel and the device's busy share of the host-clock step.
    Run only with --profile; not part of the smoke's contract."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import engine, graphs
    toks = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda")
    cache, logits = engine.prefill(params, cfg, toks, max_len=144)
    nxt = torch.argmax(logits, -1)
    engine.decode_step(params, cfg, cache, nxt, 128)
    graph = graphs.DecodeGraph(params, cfg, cache, 4)
    graph.step(nxt, 129)
    torch.cuda.synchronize()
    for what in ("prefill", "decode", "decode-graph"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                engine.prefill(params, cfg, toks, max_len=144)
            elif what == "decode":
                engine.decode_step(params, cfg, cache, nxt, 130)
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

    say("served decode, ms per token (host clock): " + "; ".join(
        f"{g['tag']} graphed {g['graph_ms']:.2f} eager {g['eager_ms']:.2f}"
        for path in (phi4_graph, moe_path, hyb_path, ssm_path, gemma_path,
                     granite_path, cr_path)
        for g in (path if isinstance(path, list) else path["graph"])))

    # One entry per kernel for the contract line (the LM-head shape for
    # K1-K4, the dbrx decode gate/up shape for K5, recurrentgemma's batch-4
    # prefill for K6 and K7, mamba2's for K8, the tuner's 4096^2 (32, 128)
    # d 0.25 layout for K9); the other shapes are in the log above.
    # Launches: summed over the ten main paths.
    launches = {n: sum(c.get(n, 0) for c in (
        phi4_counts, moe_path["counts"], hyb_path["counts"],
        ssm_path["counts"], tune_path["counts"], fig5_path["counts"],
        gemma_path["counts"], granite_path["counts"], cr_path["counts"],
        guard_path["counts"]))
        for n in KERNELS}
    first = {}
    for r in rows:
        first.setdefault(r["name"], r)
    kernels = [{k: val for k, val in r.items() if k != "shape"}
               for r in first.values()]
    for r in kernels:
        r["launches"] = int(launches[r["name"]])
        for key in ("ms", "plain_ms", "bound_ms"):
            if not (isinstance(r[key], float) and math.isfinite(r[key])):
                fail(f"{r['name']}: {key} not measured")
    if sorted(r["name"] for r in kernels) != sorted(KERNELS):
        fail("the kernels line does not list every kernel")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
