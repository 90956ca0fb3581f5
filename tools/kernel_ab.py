#!/usr/bin/env python3
"""Time the port's matmul kernels at `chip_smoke.py`'s shapes for one
source tree, to compare two trees on one card.

    python3 tools/kernel_ab.py SRC_DIR

SRC_DIR holds a `repro_torch` package (`src` of a checkout, or of an
unpacked `git archive <commit> src`).  Cards differ by a few percent from
call to call, so compare two trees inside one call, in turns:

    mkdir -p build/ab/parent && git archive <parent> src | tar -x -C build/ab/parent
    for t in build/ab/parent/src src src build/ab/parent/src; do
        python3 tools/kernel_ab.py $t; done

Each run builds the tree's kernels into build/ab/<tree> and prints one
JSON line of CUDA-event times in ms (50 calls after 5 warm-ups, queued
behind a `torch.cuda._sleep` so the card, not the host, sets the pace):
K1 k_inner at the LM head (E^T in place), the prefill and decode
projections, 4096^3 and the tuner's decode class; K2 at 4 x 1 rows;
K1 a_resident at the LM head and the decode class; K1 b_resident at the
LM head and 4096^3; K9 k_inner, a_resident and b_resident at the tuner's
layouts (b_resident at d 0.25, 0.5 and 1.0); K7 at `chip_smoke.py`'s five
phase-6c shapes; K6 at recurrentgemma-9b's 4 x 128 x 4096 and 1 x 3072 x
4096 (bf16, fp32 carry; inputs rotated over copies that pass twice the
50 MB L2, as in phase 6c) and K8 at mamba2-2.7b's 4 x 128 and 1 x 3000 x
80 x 64, G 1, S 128 (bf16, fp32 state; phase 6d); last, K3 at the LM
head (gk 24, (64, 128, 128)) and K5
at dbrx-132b's decode gate/up and down (16 x 8 rows) and prefill gate/up
(16 x 160 rows).  The tree's kernels are built first, in parallel.  Needs
one CUDA card.
"""

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    src = Path(sys.argv[1]).resolve()
    tag = "_".join(src.relative_to(ROOT).parts) if src.is_relative_to(
        ROOT) else src.name
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "ab" / tag)
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_ab.py needs a CUDA card")
    from repro_torch.kernels import block_sparse_matmul as bsr
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemv_splitk as gk
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import skew_matmul as mm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.sparse.layout import BlockSparseLayout
    build.build_all()

    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    bf = torch.bfloat16

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    res = {}
    emb = rnd((200064, 3072), 0.02)
    h4 = rnd((4, 3072))
    res["lm_head"] = time_ms(torch, lambda: mm.skew_matmul_cuda(
        h4, emb.T, bm=64, bk=64, bn=128, out_dtype=torch.float32))
    res["k2_lm_head"] = time_ms(torch, lambda: mm.skew_matmul_batched_cuda(
        h4[:, None, :], emb.T, bm=64, bk=64, bn=128, out_dtype=torch.float32))
    for m, k, n in ((512, 3072, 8192), (512, 8192, 3072), (4, 3072, 8192),
                    (4, 8192, 3072), (4, 3072, 3072), (4, 4096, 4096),
                    (4096, 4096, 4096)):
        a, w = rnd((m, k)), rnd((k, n), k ** -0.5)
        res[f"{m}x{k}x{n}"] = time_ms(torch, lambda: mm.skew_matmul_cuda(
            a, w, bm=64, bk=64, bn=128, out_dtype=bf))
    w = rnd((3072, 3072), 3072 ** -0.5)
    res["k2_4x1x3072"] = time_ms(torch, lambda: mm.skew_matmul_batched_cuda(
        h4[:, None, :], w, bm=64, bk=64, bn=128, out_dtype=bf))
    for sched in ("a_resident", "b_resident"):
        res[f"{sched[:2]}_lm_head"] = time_ms(
            torch, lambda: mm.skew_matmul_cuda(
                h4, emb.T, bm=64, bk=64, bn=128, schedule=sched,
                out_dtype=torch.float32))
    del emb
    a, w = rnd((4096, 4096)), rnd((4096, 4096), 4096 ** -0.5)
    res["br_4096x4096x4096"] = time_ms(torch, lambda: mm.skew_matmul_cuda(
        a, w, bm=64, bk=64, bn=128, schedule="b_resident", out_dtype=bf))
    a, w = rnd((4, 4096)), rnd((4096, 4096), 4096 ** -0.5)
    for bm, bk, bn in ((64, 128, 64), (64, 64, 64)):
        res[f"ar_decode_{bk}"] = time_ms(torch, lambda: mm.skew_matmul_cuda(
            a, w, bm=bm, bk=bk, bn=bn, schedule="a_resident", out_dtype=bf))
    big = rnd((4096, 4096))
    for block, d in (((32, 128), 0.25), ((32, 128), 0.5), ((128, 128), 0.4),
                     ((32, 128), 1.0)):
        lay = (BlockSparseLayout.random(4096, 4096, block, d) if d < 1.0
               else BlockSparseLayout.dense(4096, 4096, block))
        scheds = (("k_inner", "a_resident", "b_resident") if block[0] == 32
                  else ("k_inner", "a_resident"))
        for sched in scheds:
            res[f"bsr_{sched}_{block[0]}_{d}"] = time_ms(
                torch, lambda: bsr.block_sparse_matmul_cuda(
                    big, w, lay, bn=64, schedule=sched, out_dtype=bf))
    del big, a, w
    for label, b, hq, hkv, s, d, window, cap in (
            ("rg", 4, 16, 1, 128, 256, 2048, 0.0),
            ("phi4", 4, 24, 8, 128, 128, None, 0.0),
            ("dbrx", 4, 48, 8, 128, 128, None, 0.0),
            ("rg_long", 1, 16, 1, 3072, 256, 2048, 0.0),
            ("gemma2_local", 1, 32, 16, 8192, 128, 4096, 50.0)):
        q, k, v = (rnd((b, s, h, d)).transpose(1, 2) for h in (hq, hkv, hkv))
        res[f"fa_{label}"] = time_ms(torch, lambda: fa.flash_attention_cuda(
            q, k, v, window=window, softcap=cap))
    del q, k, v
    for label, b, length in (("rg", 4, 128), ("rg_long", 1, 3072)):
        n = b * length * 4096
        sets = [(rnd((b, length, 4096)), rnd((b, length, 4096)),
                 rnd((b, length, 4096)),
                 torch.rand((4096,), generator=g, device="cuda") * 4 - 2)
                for _ in range(max(2, -(-100_000_000 // (6 * n))))]
        turn = iter(range(1 << 62))
        res[f"k6_{label}"] = time_ms(torch, lambda: rg.rglru_scan_cuda(
            *sets[next(turn) % len(sets)], return_state=True))
        del sets
    for label, b, length in (("mamba2", 4, 128), ("mamba2_long", 1, 3000)):
        x = rnd((b, length, 80, 64))
        dt = torch.rand((b, length, 80), generator=g,
                        device="cuda") * 0.2 + 0.001
        a_log = torch.rand((80,), generator=g, device="cuda") - 0.5
        bm, cm = rnd((b, length, 1, 128), 0.5), rnd((b, length, 1, 128), 0.5)
        res[f"k8_{label}"] = time_ms(torch, lambda: ssd.ssd_scan_cuda(
            x, dt, a_log, bm, cm, chunk=128, return_state=True))
    # K3 and K5 last: the rows above then run after the same work in any
    # tree (a tree whose K5 keeps the tensor cores busier warms the card
    # for the rows that follow it)
    emb = rnd((200064, 3072), 0.02)
    res["k3_lm_head"] = time_ms(torch, lambda: gk.gemv_splitk_partial_cuda(
        h4, emb.T, bm=64, bk=128, bn=128))
    del emb
    w_up = rnd((16, 6144, 10752), 6144 ** -0.5)
    w_down = rnd((16, 10752, 6144), 10752 ** -0.5)
    for label, m, w in (("decode_gate_up", 8, w_up),
                        ("decode_down", 8, w_down),
                        ("prefill_gate_up", 160, w_up)):
        a = rnd((16, m, w.shape[1]))
        res[f"k5_{label}"] = time_ms(torch, lambda: gmm.grouped_matmul_cuda(
            a, w, bm=64, bk=64, bn=128, out_dtype=torch.float32))
    print(json.dumps({"src": str(sys.argv[1]),
                      **{k: round(v, 5) for k, v in res.items()}}))


if __name__ == "__main__":
    main()
