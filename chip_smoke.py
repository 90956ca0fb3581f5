#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout.  Phases, in order; any failure exits
nonzero and prints no result:

  1. environment — card name and power limit, torch / CUDA versions; TF32
     off for matmuls and cuDNN;
  2. build — nvcc builds every kernel of `src/repro_torch/csrc/` (one nvcc
     per source, in parallel);
  3. kernel parity — each kernel against its plain PyTorch version on the
     card at phi4-mini-3.8b's shapes, bf16 and fp32, every schedule and
     epilogue on the path, plus split-K bitwise stability across split
     counts for integer-valued inputs;
  4. serve at full width (the main path) — phi4-mini-3.8b, bf16, seeded
     weights, batch 4 x prompt 128 + 16 generated tokens through
     `repro_torch.launch.serve.serve`; then, because the gpu_h100 planner
     picks neither split-K nor the batched grid at these shapes, a batch-1
     serve and explicit-plan calls through `ops` at the LM-head shape for
     each kernel still without a launch.  Launch counts are zeroed just
     before this phase and read just after it;
  5. whole-path parity — prefill and first-decode logits of the "cuda"
     backend against the "torch" backend on the same weights;
  6. timings — each kernel, its plain version and one PyTorch call
     computing the same function (the yardstick; never on the port's path),
     with CUDA events, at the main path's shapes;
  7. the `kernels` JSON line, then the device line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_BF16 = 989e12          # H100 SXM data sheet, dense
HBM_BW = 3.35e12

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
}


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
        regs = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln]
        say(f"build {name}: {len(regs)} kernels, e.g. {regs[:1]}")


# ----------------------------------------------------------------- helpers
def rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, that divided by max |want|)."""
    diff = (got.float() - want.float()).abs().max().item()
    scale = max(want.float().abs().max().item(), 1e-30)
    return diff, diff / scale


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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

    def check(name, got, want, out_dtype, tag):
        diff, rel = rel_err(torch, got, want)
        scale = want.float().abs().max().item()
        tol = tolerance(str(out_dtype).split(".")[-1], scale)
        ok = diff <= tol
        say(f"parity {name:24s} {tag:44s} max_abs_err={diff:.3e} "
            f"rel={rel:.2e} tol={tol:.2e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name} disagrees with its plain version at {tag}")
        errs[name] = max(errs.get(name, 0.0), diff)

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
            if m == 4:
                # split-K at the planner's best split-K blocks for the shape
                sk = splitk_plan(m, k, n, a.element_size())
                slab = gk.gemv_splitk_partial_cuda(a, b, bm=sk.bm, bk=sk.bk,
                                                   bn=sk.bn)
                slab_want = gk.gemv_splitk_partial_plain(a, b, bk=sk.bk)
                torch.cuda.synchronize()
                check("gemv_splitk_partial", slab, slab_want, torch.float32,
                      f"{dn} {m}x{k}x{n} blocks {(sk.bm, sk.bk, sk.bn)}")
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
    return errs


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
                              prompt_len=prompt, gen=gen, seed=0)
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
                               prompt_len=prompt, gen=4, seed=0)
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
    for name in KERNELS:
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the main path")
    out["counts"] = counts
    return out


def splitk_plan(m: int, k: int, n: int, dtype_bytes: int):
    """The planner's best split-K plan for the shape, or (64, 128, 128)
    when none fits the budget.  The reference's split-K working set counts
    the whole (gk, bm, bn) partial slab in shared memory for pass 2, so at
    k = 3072 no split-K plan fits the H100's ~104 KB budget; the port's
    reduce streams the slab, so the explicit plan runs within 86 KB."""
    from repro_torch.core import hw, planner
    from repro_torch.core.costmodel import BlockPlan, MatmulDims
    chip = hw.get_chip("gpu_h100")
    dims = MatmulDims(m=m, k=k, n=n, dtype_bytes=dtype_bytes)
    best = planner._search_gemv(dims, chip, int(0.45 * chip.vmem_bytes))
    return best.plan if best is not None else BlockPlan(64, 128, 128,
                                                        "splitk")


def lm_head_splitk_plan(cfg):
    return splitk_plan(4, cfg.d_model, cfg.vocab_size, 2)


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
    of the same weights (the "torch" backend on fp32 copies)."""
    import dataclasses

    import numpy as np
    from repro_torch.core.config import mm_config
    from repro_torch.serve import engine

    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 128)),
                        dtype=torch.long, device="cuda")
    runs = (("cuda", cfg, params), ("torch", cfg, params),
            ("fp32", dataclasses.replace(cfg, dtype="float32"), None))
    out = {}
    for name, c, p in runs:
        if p is None:
            p = _float_tree(params)
        with mm_config(backend="cuda" if name == "cuda" else "torch"):
            cache, pre = engine.prefill(p, c, toks, max_len=144)
            if name == "cuda":
                nxt = torch.argmax(pre, -1)
            dec, _ = engine.decode_step(p, c, cache, nxt, 128)
        out[name] = (pre, dec)
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
    return res


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

    def row(name, kernel, plain, library, nbytes, flops, shape):
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain, iters=5, warmup=1)
        lib_ms = time_ms(torch, library) if library else None
        bms, by = bound_ms(nbytes, flops, PEAK_BF16)
        src, rep = KERNELS[name]
        say(f"time {name:24s} {shape:28s} {ms:.4f} ms  plain {plain_ms:.4f}"
            f"  torch {lib_ms if lib_ms is None else round(lib_ms, 4)}  "
            f"bound {bms:.4f} ({by})")
        return {"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": int(counts.get(name, 0)),
                "max_abs_err": errs.get(name), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                "shape": shape}

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
    # k_inner at the other serving shapes, for the record
    for m, k, n, spec in ((512, d, f, (("silu", None),)), (512, f, d, ()),
                          (4, d, f, (("silu", None),)), (4, f, d, ())):
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
    rows.append(row(
        "skew_matmul_batched",
        lambda: mm.skew_matmul_batched_cuda(h4[:, None, :], emb_t, bm=64,
                                            bk=64, bn=128,
                                            out_dtype=torch.float32),
        lambda: mm.skew_matmul_batched_plain(h4[:, None, :], emb_t, bk=64,
                                             out_dtype=torch.float32),
        lambda: torch.matmul(h4[:, None, :], emb_t),
        lm_bytes, lm_flops, f"LM head 4x1x{d}x{v} bf16->fp32"))
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
    rows.append(row(
        "gemv_splitk_reduce",
        lambda: gk.gemv_splitk_reduce_cuda(slab, out_dtype=torch.float32),
        lambda: gk.gemv_splitk_reduce_plain(slab, out_dtype=torch.float32),
        lambda: torch.sum(slab, dim=0),
        gk_n * 4 * v * 4 + 4 * v * 4, (gk_n - 1) * 4 * v,
        f"LM head slab {gk_n}x4x{v} fp32"))
    return rows


# ----------------------------------------------------------------- --profile
def profile_steps(torch, cfg, params) -> None:
    """torch.profiler over one prefill and one decode step (batch 4): device
    time by kernel and the device's busy share of the host-clock step.
    Run only with --profile; not part of the smoke's contract."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import engine
    toks = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda")
    cache, logits = engine.prefill(params, cfg, toks, max_len=144)
    nxt = torch.argmax(logits, -1)
    engine.decode_step(params, cfg, cache, nxt, 128)
    torch.cuda.synchronize()
    for what in ("prefill", "decode"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                engine.prefill(params, cfg, toks, max_len=144)
            else:
                engine.decode_step(params, cfg, cache, nxt, 129)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in ka)
        say(f"profile {what}: host-clock {wall * 1e3:.2f} ms, device busy "
            f"{dev_us / 1e3:.2f} ms ({dev_us / 1e4 / wall:.1f}% of the step)")
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
    errs = phase_parity(torch, cfg)
    main_path = phase_serve(torch, cfg)
    if "--profile" in sys.argv[1:]:
        profile_steps(torch, cfg, main_path["params"])
    phase_path_parity(torch, cfg, main_path["params"])
    rows = phase_timings(torch, cfg, main_path["params"],
                         main_path["counts"], errs)

    # One entry per kernel for the contract line (the LM-head shape, the
    # paper's right-skew case); the other shapes are in the log above.
    first = {}
    for r in rows:
        first.setdefault(r["name"], r)
    kernels = [{k: val for k, val in r.items() if k != "shape"}
               for r in first.values()]
    for r in kernels:
        for key in ("ms", "plain_ms", "bound_ms"):
            if not (isinstance(r[key], float) and math.isfinite(r[key])):
                fail(f"{r['name']}: {key} not measured")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
