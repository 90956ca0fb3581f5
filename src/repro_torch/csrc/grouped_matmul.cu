// Grouped expert GEMM (K5), hand-written for Hopper.
//
// Replaces: src/repro/sparse/kernels.py::grouped_matmul_padded
//   (body _grouped_k_inner_kernel): the MoE expert GEMMs,
//
//   C[g] = act(scale * (A[g] @ B[g])) + residual[g]
//
//   one rhs per group, fp32 accumulation, the epilogue at fp32, one cast
//   to the output type.  No bias (the JAX wrapper rejects a per-group bias
//   too).
//
// Bound on the H100: every capacity slot goes through its expert, so each
// call reads every group's B once.  At the dbrx-132b decode shape (16
// groups, m = 8 capacity rows, 6144 x 10752 per expert, bf16) B alone is
// 2.11 GB: 0.633 ms at 3.35 TB/s, against 2.8 GFLOP (~3 us of tensor-core
// time).  At prefill (m = 160) it is still bytes first on paper: 0.67 ms
// against 338 GFLOP / 989 TFLOP/s = 0.34 ms; but `mma.sync` from shared
// memory reaches about half that peak, and each CTA re-reads its group's A
// from L2, so there the tile is shaped to feed the tensor cores and to
// read A fewer times.
//
// The kernel is K1's k_inner (csrc/k_inner.cuh) with the grouped walk
// (KiWalk::kGrouped, a template flag): blockIdx = (row tile, column tile,
// group); A, B, the output and the residual are offset by their group
// strides, so each expert's B is read through its strides in place (never
// padded or copied), ragged m, k and n are masked in the kernel, the fp32
// sums stay in registers (`mma.sync` m16n8k16 from `ldmatrix`), and A and
// B stream through a >= 3-stage `cp.async` ring of XOR-swizzled tiles.
// Two tiles (`grouped_config`):
//   decode  (bf16 m <= 16; every fp32 call): k_inner's 8-row granule (the
//           MMA's other 8 rows read a zero row) or 16 rows, one 16-column
//           strip a warp over up to 128 columns, the ring within two CTAs
//           an SM.  At dbrx's shape: 84 column tiles x 16 groups = 1344
//           CTAs, each B tile read once.  fp32 operands run the plain FMA
//           chain, true IEEE fp32, never TF32;
//   prefill (bf16 m > 16): two rows of four warps over a 32 mr x 64 ns
//           tile, each warp 16 mr rows x ns 16-column strips in registers.
//           At mr 5, ns 4 (160 x 256, one CTA an SM, 80 x 64 a warp: 40
//           MMAs a 16-deep step from 9 ldmatrix, against k_inner's 2 from
//           2), 160 rows hold dbrx's 160 capacity rows with no padding, so
//           each expert's B tile is read once, and A is read from L2 once
//           per 256 columns.  mr 2, ns 2 (64 x 128, two CTAs an SM) where
//           that pads fewer rows.
// Each output is one fp32 chain over k in ascending 16-deep MMA steps in
// both tiles, so group g equals K1 k_inner on A[g] @ B[g] bit for bit.
// What sets the prefill tile's pace (PERF.md §7): with all 8 warps both
// copying (at the L2 read rate) and multiplying, the two overlap poorly;
// TMA with a producer warp, and wgmma, are later work.
#include "k_inner.cuh"

namespace rt {

// K5's shape on the card (mirrored by `grouped_config` in
// kernels/grouped_matmul.py):
//   wide   — the prefill tile: bf16 with m > 16 rows a group;
//   rows, mr — decode: bf16 8 when m fits in 8, else 16; fp32 16 (mr 1);
//            prefill: 32 mr rows, mr 5 (160) or 2 (64), whichever pads fewer
//            rows of m (ties to 160, fewer row tiles);
//   tw     — decode: the widest power-of-two multiple of 16 within bn and
//            128, narrowed as k_inner's (`ki_narrow`, the groups counted as
//            row tiles) where the grid would leave SMs idle, and for a
//            transposed B until a slice is 128 bytes deep; prefill: 256 at
//            mr 5 (ns 4), 128 at mr 2 (ns 2);
//   ks     — the deepest power of two up to 256 that divides round_up(k,
//            bk) and leaves room for >= 3 stages (at most 8): within two
//            CTAs an SM (`kGmBudget`), or one at mr 5 (160 sums a lane).
constexpr long long kGmBudget = (kSmemMax - 1024) / 2;

struct GCfg {
  KICfg c;
  int wide;
};

template <typename T>
inline GCfg grouped_config(int g, int m, int k, int n, int bk, int bn, int bt, int sms) {
  GCfg r{};
  KICfg& c = r.c;
  c.bt = bt;
  c.smem = -1;
  const int kp = (k + bk - 1) / bk * bk;
  int tw = 128;
  long long budget = kGmBudget;
  if (kKiSwz<T> && m > 16) {
    r.wide = 1;
    const int pad2 = (m + 63) / 64 * 64 - m, pad5 = (m + 159) / 160 * 160 - m;
    c.mr = pad5 <= pad2 ? 5 : 2;
    c.rows = 32 * c.mr;
    c.gm = (m + c.rows - 1) / c.rows;
    if (c.mr == 5) {  // one CTA an SM: 80 x 64 a warp
      tw = 256;
      budget = kSmemMax;
    }
    if (!ki_ring<T>(c, tw, kp, budget)) return r;
  } else {
    c.rows = kKiSwz<T> && m <= 8 ? 8 : 16;
    c.mr = 1;
    c.gm = (m + c.rows - 1) / c.rows;
    tw = 16;
    while (2 * tw <= bn && 2 * tw <= 128) tw *= 2;
    const long long gmg = (long long)g * c.gm;
    if (gmg * ((n + tw - 1) / tw) < sms) tw = ki_narrow((int)gmg, n, tw, sms);
    if (!ki_ring<T>(c, tw, kp, budget)) return r;
    while (bt && tw > 16 && c.ks * (int)sizeof(T) < 128) {
      tw /= 2;
      if (!ki_ring<T>(c, tw, kp, budget)) return r;
    }
  }
  c.tw = tw;
  c.gn = (n + tw - 1) / tw;
  return r;
}

template <typename T, typename O, int MR, int NS, int WR>
int launch_mr(const GCfg& r, const T* a, long long sa_g, long long sa_m, long long sa_k,
              const T* b, long long sb_g, long long sb_k, long long sb_n, O* o, int groups,
              int m, int k, int n, int bk, const Epi& e, cudaStream_t stream) {
  const KIWalkArgs w{sa_g, sb_g, 0};
  return launch_k_inner<T, O, MR, NS, KiWalk::kGrouped, WR>(r.c, a, 0, sa_m, sa_k, b, sb_k, sb_n,
                                                            o, 1, m, k, n, bk, e, nullptr,
                                                            nullptr, 0, 0, stream, groups, w);
}

template <typename T, typename O>
int launch_grouped(const void* A, long long sa_g, long long sa_m, long long sa_k,
                   const void* B, long long sb_g, long long sb_k, long long sb_n, void* out,
                   long long so_g, long long so_m, int groups, int m, int k, int n, int bm,
                   int bk, int bn, int sms, const Epi& e, cudaStream_t stream) {
  // the output rows of group g are rows g * m .. g * m + m of one
  // contiguous (groups * m, n) matrix
  if (tile_smem_bytes<T>(bm, bk, bn) > kSmemMax || groups > 65535 || so_m != n ||
      so_g != (long long)m * n)
    return (int)cudaErrorInvalidValue;
  const int bt = sb_k == 1 && sb_n != 1;
  const GCfg r = grouped_config<T>(groups, m, k, n, bk, bn, bt, sms);
  if (r.c.smem < 0 || r.c.smem > kSmemMax || r.c.gn > 65535) return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  O* o = static_cast<O*>(out);
  if constexpr (kKiSwz<T>) {
    if (r.wide && r.c.mr == 5)
      return launch_mr<T, O, 5, 4, 2>(r, a, sa_g, sa_m, sa_k, b, sb_g, sb_k, sb_n, o, groups, m,
                                      k, n, bk, e, stream);
    if (r.wide)
      return launch_mr<T, O, 2, 2, 2>(r, a, sa_g, sa_m, sa_k, b, sb_g, sb_k, sb_n, o, groups, m,
                                      k, n, bk, e, stream);
  }
  return launch_mr<T, O, 1, 1, 1>(r, a, sa_g, sa_m, sa_k, b, sb_g, sb_k, sb_n, o, groups, m, k,
                                  n, bk, e, stream);
}

}  // namespace rt

// A (groups, m, k) and B (groups, k, n) are read through their strides (in
// elements); `out` is a contiguous (groups, m, n) tensor (so_g = m n, so_m
// = n).  act: 0 none, 1 gelu (tanh approximation), 2 silu.  The residual,
// when given, is read as res[g * rs_g + r * rs_m + c * rs_n].  `sms` is
// the card's SM count (the wrapper's `grouped_config`).  Returns the
// cudaError_t of the launch.
extern "C" int rt_grouped_matmul(int in_bf16, int out_bf16, const void* A, long long sa_g,
                                 long long sa_m, long long sa_k, const void* B, long long sb_g,
                                 long long sb_k, long long sb_n, void* out, long long so_g,
                                 long long so_m, int groups, int m, int k, int n, int bm, int bk,
                                 int bn, int sms, float scale, int has_scale, int act,
                                 const void* res, int res_bf16, long long rs_g, long long rs_m,
                                 long long rs_n, void* stream) {
  rt::Epi e{scale, has_scale, nullptr, 0, act, res, res_bf16, rs_g, rs_m, rs_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return rt::launch_grouped<rt::bf16, rt::bf16>(A, sa_g, sa_m, sa_k, B, sb_g, sb_k, sb_n, out,
                                                  so_g, so_m, groups, m, k, n, bm, bk, bn, sms,
                                                  e, s);
  if (in_bf16)
    return rt::launch_grouped<rt::bf16, float>(A, sa_g, sa_m, sa_k, B, sb_g, sb_k, sb_n, out,
                                               so_g, so_m, groups, m, k, n, bm, bk, bn, sms, e,
                                               s);
  if (out_bf16)
    return rt::launch_grouped<float, rt::bf16>(A, sa_g, sa_m, sa_k, B, sb_g, sb_k, sb_n, out,
                                               so_g, so_m, groups, m, k, n, bm, bk, bn, sms, e,
                                               s);
  return rt::launch_grouped<float, float>(A, sa_g, sa_m, sa_k, B, sb_g, sb_k, sb_n, out, so_g,
                                          so_m, groups, m, k, n, bm, bk, bn, sms, e, s);
}
