// The k_inner device code shared by K1 / K2 (csrc/skew_matmul.cu), K3
// (csrc/gemv_splitk.cu), K5 (csrc/grouped_matmul.cu) and K9's k_inner
// (csrc/block_sparse_k_inner.cu), and the swizzled-tile MMA that K1's
// a_resident uses too.
//
// One kernel template, `k_inner_kernel`, whose walk over k (a template
// flag, `KiWalk`) is its only difference between them:
//   kDense   (K1, K2) steps through round_up(k, bk) in ks-deep slices;
//   kSparse  (K9) steps through the nonzero blocks of the CTA's row block,
//            slice `sl` of block s at k = cols[i, s] * bk + sl * ks, s
//            ascending (ks divides bk, so no slice straddles two blocks);
//   kSplit   (K3) steps through the k range of the CTA's splits (blockIdx.z
//            a group of `sp` bk-deep splits, ks divides bk) and, at each
//            split's end, stores the raw fp32 sums to that split's plane of
//            the (gk, m, n) slab and starts again from zero, the ring
//            running on across the boundary;
//   kGrouped (K5) is the dense walk over group blockIdx.z's operands: A, B,
//            the output and the residual offset by their group strides.
// Every output is one fp32 chain over k in 16-deep MMA steps in ascending
// order in all four (a split's from its first slice), so K9 at density
// 1.0, K3's plane s and K5's group g equal K1 on the same operands bit for
// bit by construction.  A second warp layout (WR = 2: two rows of four
// warps, each holding 16 MR rows x NS strips) is K5's prefill tile.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rt {

// A k_inner CTA's shape (chosen by `ki_config` in csrc/skew_matmul.cu for
// K1 / K2, `sk_config` in csrc/gemv_splitk.cu for K3, `grouped_config` in
// csrc/grouped_matmul.cu for K5 and `bki_config` in
// csrc/block_sparse_k_inner.cu for K9; all mirrored in Python):
//   rows   — the CTA's rows; a warp holds mr fragments of 16 rows (an
//            8-row bf16 tile reads a zero row for the MMA's other 8 rows),
//            every row of the tile (rows = 16 mr), or, in K5's prefill
//            tile, half of them (rows = 32 mr);
//   tw     — the tile's columns: 16-column strips, strip s owned by warp
//            s % 8, so a warp owns one strip at tw <= 128 and two at 256
//            (K5's prefill tile: warp w owns strips w % 4 + 4 j, j < NS,
//            in the rows of half w / 4);
//   ks     — the k slice of one stage, stages — the ring's depth (>= 3);
//   bt     — B is a transposed view (unit stride along k), copied n-major.
// bf16 tiles have no row pad: their 16-byte chunks are XOR-swizzled
// (`ki_swz`) so ldmatrix reads them without bank conflicts; fp32 tiles keep
// the 16-byte pad.
struct KICfg {
  int rows, mr, tw, ks, stages, bt, gm, gn;
  long long smem;  // dynamic shared memory in bytes
};
enum class KiWalk { kDense, kSparse, kSplit, kGrouped };
// What the split and grouped walks add to the kernel's arguments (unused by
// the other two): A's and B's group strides (kGrouped), and the splits a
// CTA walks (kSplit).
struct KIWalkArgs {
  long long sa_g, sb_g;
  int sp;
};
template <typename T> constexpr bool kKiSwz = sizeof(T) == 2;
template <typename T> constexpr int kKiPad = kKiSwz<T> ? 0 : pad<T>();

// The chunk a tile row r (of 2^lgc 16-byte chunks) XORs its chunk index
// with: rows that share a 128-byte bank window take different chunks, so
// the 8 rows of an ldmatrix 8 x 8 read hit 8 distinct bank groups.  It
// depends on r % 8 only.
__host__ __device__ inline int ki_swz(int r, int lgc) {
  return lgc >= 3 ? (r & 7) : ((r >> (3 - lgc)) & ((1 << lgc) - 1));
}

template <typename T>
__host__ __device__ inline long long ki_stage_bytes(int rows, int tw, int ks, int bt) {
  const long long a = align128((long long)rows * (ks + kKiPad<T>) * sizeof(T));
  const long long b = bt ? align128((long long)tw * (ks + kKiPad<T>) * sizeof(T))
                         : align128((long long)ks * (tw + kKiPad<T>) * sizeof(T));
  return a + b;
}
// Shared memory besides the stages: the row offset table, and the zero row
// an 8-row tile's MMA reads for its other 8 rows.
template <typename T>
__host__ __device__ inline long long ki_fixed_bytes(int rows, int ks) {
  return align128((long long)rows * 8) + (rows < 16 ? align128((long long)ks * sizeof(T)) : 0);
}

// The deepest ring for a tile width: a power-of-two slice up to 256 deep
// that divides kp and leaves room for >= 3 stages (at most 8) in the budget
// (`plan`, or three 16-deep stages where that cannot hold them).
template <typename T>
inline bool ki_ring(KICfg& c, int tw, int kp, long long plan) {
  const long long budget = max(
      plan, ki_fixed_bytes<T>(c.rows, 16) + 3 * ki_stage_bytes<T>(c.rows, tw, 16, c.bt));
  for (int ks = 256; ks >= 16; ks /= 2) {
    if (kp % ks) continue;
    const long long st = ki_stage_bytes<T>(c.rows, tw, ks, c.bt);
    const long long s = (budget - ki_fixed_bytes<T>(c.rows, ks)) / st;
    if (s >= 3) {
      c.ks = ks;
      c.stages = (int)min(s, 8LL);
      c.smem = ki_fixed_bytes<T>(c.rows, ks) + c.stages * st;
      return true;
    }
  }
  return false;  // not reached: ks = 16 always fits the budget
}

// K5's prefill tile (WR = 2): a warp owns NS strips, `strip` + 4 j, of
// its MR row fragments.  Each 16-deep step reads the NS B fragments and
// the MR A fragments once and issues the 2 MR NS MMAs (MR 5, NS 4: 40 MMAs
// from 9 ldmatrix), in the same k order as ki_mma.
template <int MR, int NS, bool BT>
__device__ __forceinline__ void ki_mma_wide(AccMma (&acc)[NS][MR], const bf16* sA, int lda,
                                            int lga, const bf16* sB, int ldb, int lgb,
                                            int strip, int K, int nrf) {
  const int lane = threadIdx.x % 32, l8 = lane & 7, h = lane >> 4;
  const int ar = lane & 15;
  const bf16* pa = sA + ar * lda;
  const int fa = ki_swz(l8, lga);
  const int fb = ki_swz(l8, lgb), hb = (lane >> 3) & 1;
  const bf16* pb[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int s = strip + 4 * j;
    pb[j] = BT ? sB + (16 * s + l8 + 8 * h) * ldb : sB + ar * ldb + (((2 * s + h) ^ fb) << 3);
  }
  for (int kk = 0; kk < K; kk += 16) {
    unsigned b[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (BT)
        ldsm_x4(b[j], pb[j] + ((((kk >> 3) | hb) ^ fb) << 3));
      else
        ldsm_x4_trans(b[j], pb[j] + kk * ldb);
    }
    const int ca = (((kk >> 3) | h) ^ fa) << 3;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nrf) break;
      unsigned a[4];
      ldsm_x4(a, pa + 16 * r * lda + ca);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mma_16816(acc[j][r].x, a, b[j][0], b[j][1]);
        mma_16816(acc[j][r].x + 4, a, b[j][2], b[j][3]);
      }
    }
  }
}

// Below a grid of `tw`-wide tiles that leaves SMs idle (K1, K5): the widest
// narrower power of two whose grid fills the card with its CTAs spread
// evenly (the busiest SM at most 1 / 0.85 of the mean), else the most even
// of those that fill it (16 columns, the MMA strip, at the least).
inline int ki_narrow(int gm, int n, int tw, int sms) {
  int best = 16;
  double best_bal = -1.0;
  for (int w = tw / 2; w >= 16; w /= 2) {
    const long long ctas = (long long)gm * ((n + w - 1) / w);
    if (ctas < sms && w > 16) continue;
    const double bal = (double)ctas / ((double)sms * ((ctas + sms - 1) / sms));
    if (bal >= 0.85) return w;
    if (bal > best_bal) {
      best = w;
      best_bal = bal;
    }
  }
  return best;
}

// One warp's 16-column strip of the bf16 product over one stage: acc[r] +=
// A[16 r .. 16 r + 16, slice] @ B[slice, strip] in 16-deep steps in k
// order, through ldmatrix and two m16n8k16 HMMAs a step (strip_mma's
// instructions, on the swizzled tiles).  `zrow`: an 8-row A tile, whose
// MMA rows 8-15 read this zero row.
template <int MR, bool BT>
__device__ __forceinline__ void ki_mma(AccMma (&acc)[MR], const bf16* sA, int lda, int lga,
                                       const bf16* zrow, const bf16* sB, int ldb, int lgb,
                                       int strip, int K, int nrf) {
  const int lane = threadIdx.x % 32, l8 = lane & 7, h = lane >> 4;
  const int ar = lane & 15;
  const bool zero = zrow != nullptr && ar >= 8;
  const bf16* pa = zero ? zrow : sA + ar * lda;
  const int fa = zero ? 0 : ki_swz(l8, lga);
  // ldmatrix's four 8 x 8 matrices are (k 0-7, n 0-7), (k 8-15, n 0-7),
  // (k 0-7, n 8-15), (k 8-15, n 8-15): b[0], b[1] feed columns 0-7 and
  // b[2], b[3] columns 8-15.  Row-major B is read transposed, lane l at row
  // kk + (l & 15), chunk 2 strip + h; n-major B is already mma.sync's
  // column-major B, lane l at row 16 strip + (l & 7) + 8 h, chunk kk / 8 +
  // (l >> 3 & 1)
  const bf16* pb = BT ? sB + (16 * strip + l8 + 8 * h) * ldb
                      : sB + ar * ldb + (((2 * strip + h) ^ ki_swz(l8, lgb)) << 3);
  const int fb = ki_swz(l8, lgb), hb = (lane >> 3) & 1;
  for (int kk = 0; kk < K; kk += 16) {
    unsigned b[4];
    if (BT)
      ldsm_x4(b, pb + ((((kk >> 3) | hb) ^ fb) << 3));
    else
      ldsm_x4_trans(b, pb + kk * ldb);
    const int ca = (((kk >> 3) | h) ^ fa) << 3;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nrf) break;
      unsigned a[4];
      ldsm_x4(a, pa + 16 * r * lda + ca);
      mma_16816(acc[r].x, a, b[0], b[1]);
      mma_16816(acc[r].x + 4, a, b[2], b[3]);
    }
  }
}

// ki_mma for a 256-column tile, where warp w owns strips w and w + 8 (K9's
// k_inner): B fragments of both strips, each A fragment read once for
// both.  The same MMAs in the same k order.  K1's k_inner keeps the
// one-strip form above: a build of it through a strip loop of one ran
// slower at decode rows on the H100, with the same hot loop up to
// register names.
template <int MR, bool BT>
__device__ __forceinline__ void ki_mma2(AccMma (&acc)[2][MR], const bf16* sA, int lda, int lga,
                                        const bf16* sB, int ldb, int lgb, int strip, int K,
                                        int nrf) {
  const int lane = threadIdx.x % 32, l8 = lane & 7, h = lane >> 4;
  const int ar = lane & 15;
  const bf16* pa = sA + ar * lda;
  const int fa = ki_swz(l8, lga);
  const int fb = ki_swz(l8, lgb), hb = (lane >> 3) & 1;
  const bf16* pb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int s = strip + 8 * j;
    pb[j] = BT ? sB + (16 * s + l8 + 8 * h) * ldb : sB + ar * ldb + (((2 * s + h) ^ fb) << 3);
  }
  for (int kk = 0; kk < K; kk += 16) {
    unsigned b[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (BT)
        ldsm_x4(b[j], pb[j] + ((((kk >> 3) | hb) ^ fb) << 3));
      else
        ldsm_x4_trans(b[j], pb[j] + kk * ldb);
    }
    const int ca = (((kk >> 3) | h) ^ fa) << 3;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nrf) break;
      unsigned a[4];
      ldsm_x4(a, pa + 16 * r * lda + ca);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma_16816(acc[j][r].x, a, b[j][0], b[j][1]);
        mma_16816(acc[j][r].x + 4, a, b[j][2], b[j][3]);
      }
    }
  }
}

// K3's split planes: one warp's raw fp32 sums at (gr0, gc0) of a contiguous
// (m, n) fp32 plane, masked at the edges, no epilogue.  Inlined, unlike
// store_acc: it runs inside the k loop, once a split.  bf16 operands store
// neighbouring columns in pairs (8 bytes) where n is even.
__device__ __forceinline__ void store_raw(const AccMma& a, float* out, int gr0, int gc0, int m,
                                          int n) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = gr0 + g + 8 * rr, col = gc0 + 8 * h + 2 * t;
      if (row >= m || col >= n) continue;
      float* p = out + (long long)row * n + col;
      const float v0 = a.x[4 * h + 2 * rr], v1 = a.x[4 * h + 2 * rr + 1];
      if ((n & 1) == 0) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (col + 1 < n) p[1] = v1;
      }
    }
}
__device__ __forceinline__ void store_raw(const AccF32& a, float* out, int gr0, int gc0, int m,
                                          int n) {
  const int lane = threadIdx.x % 32, col = gc0 + lane % 16;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int row = gr0 + lane / 16 + 2 * x;
    if (row < m && col < n) out[(long long)row * n + col] = a.x[x];
  }
}

// blockIdx = (row tile, column tile, z): the row tiles that share a column
// tile run next to each other, so B streams from device memory once.
// Rows are the nb * m rows of every batch slice in order (row r is row
// r % m of slice r / m, read through sa_b and sa_m from a per-row offset
// table); at decode (nb * m <= 16) one CTA takes every slice's rows, so
// K2 reads B once per launch, not once per slice.  SPARSE: nb == 1, the
// tile lies in row block i = r0 / bm (rows divides bm) and walks only its
// nnz[i] blocks; a row block with none writes epilogue(0).  SPLIT: nb == 1,
// z is a group of w.sp splits, `out` the fp32 slab.  GROUPED: nb == 1, z is
// the group; A, B, the output (rows z * m .. z * m + m of a contiguous
// (g * m, n) matrix) and the residual (e.rs_b the group stride) are offset
// to group z's.  The copies of the next stages - 1 slices are in flight
// (cp.async, one commit group a step) while step q multiplies; the
// zero-filled tail of a ragged last k block is part of the walk, as the
// plan's blocks had it.  WR = 1: warp w owns the tile's strip w (warps
// past tw / 16 only copy), and w + 8 too at tw 256, and every row of them.
// WR = 2 (K5's prefill tile, tw = 64 NS): warp w owns strips w % 4 + 4 j
// (j < NS) of rows 16 MR (w / 4) .. 16 MR (w / 4 + 1).  Each keeps its
// fp32 sums in registers from the first slice to the epilogue (SPLIT: to
// its split's end): each output's sum is one chain over k in ascending
// order in 16-deep MMA steps in every walk and warp layout, so the walks
// agree bit for bit on the same operands.  What only the split and
// grouped walks or WR = 2 need lies under `if constexpr` (or is a dead
// variable), so the dense and sparse instantiations do not depend on it:
// an edit to a line they share moves their register allocation and their
// time.
template <typename T, typename O, int MR, int NS, KiWalk W, int WR = 1>
__global__ void __launch_bounds__(kThreads, MR * NS <= 4 ? 2 : 1)
k_inner_kernel(const T* __restrict__ A, long long sa_b, long long sa_m, long long sa_k,
               const T* __restrict__ B, long long sb_k, long long sb_n,
               O* __restrict__ out, int nb, int m, int k, int n, int bk, KICfg cfg, Epi e,
               const int* __restrict__ cols, const int* __restrict__ nnz, int s_max, int bm,
               KIWalkArgs w) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr bool SW = kKiSwz<T>;
  constexpr bool SPARSE = W == KiWalk::kSparse;
  constexpr bool SPLIT = W == KiWalk::kSplit;
  constexpr bool GROUPED = W == KiWalk::kGrouped;
  static_assert(NS == 1 || (SW && NS == 2) || (SW && NS == 4 && WR == 2),
                "fp32 tiles: one strip a warp");
  static_assert(WR == 1 || (WR == 2 && NS >= 2 && GROUPED), "two warp rows: K5's prefill tile");
  static_assert(!SPLIT || (std::is_same<O, float>::value && NS == 1),
                "split planes: fp32, one strip a warp");
  using Acc = typename AccFrag<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = cfg.rows, tw = cfg.tw, ks = cfg.ks, S = cfg.stages;
  const int lda = ks + kKiPad<T>;
  const int ldb = cfg.bt ? ks + kKiPad<T> : tw + kKiPad<T>;
  const long long a_bytes = align128((long long)rows * lda * sizeof(T));
  const long long st_bytes = ki_stage_bytes<T>(rows, tw, ks, cfg.bt);
  long long* rowoff = reinterpret_cast<long long*>(smem + S * st_bytes);
  T* zrow = rows < 16 ? reinterpret_cast<T*>(smem + S * st_bytes + align128(rows * 8LL))
                      : nullptr;
  const int warp = threadIdx.x / 32;
  if constexpr (GROUPED) {
    // group z: its operands, its rows of the contiguous (g * m, n) output
    // and its residual (e.rs_b the group stride)
    A += blockIdx.z * w.sa_g;
    B += blockIdx.z * w.sb_g;
    out += (long long)blockIdx.z * m * n;
    if (e.res)
      e.res = static_cast<const char*>(e.res) + blockIdx.z * e.rs_b * (e.res_bf16 ? 2 : 4);
  }

  const int M = nb * m;
  const int r0 = blockIdx.x * rows, c0 = blockIdx.y * tw;
  const int vrows = min(rows, M - r0);
  const int nrf = min(MR, (vrows + 15) / 16);
  for (int r = threadIdx.x; r < vrows; r += kThreads) {
    const int b = (r0 + r) / m;
    rowoff[r] = b * sa_b + (long long)(r0 + r - b * m) * sa_m;
  }
  // rows past the last valid one stay zero in every stage: never copied
  for (int s = 0; s < S; ++s) {
    T* sa = reinterpret_cast<T*>(smem + s * st_bytes);
    for (int idx = threadIdx.x; idx < (rows - vrows) * lda; idx += kThreads)
      sa[vrows * lda + idx] = from_f<T>(0.0f);
  }
  if (zrow)
    for (int idx = threadIdx.x; idx < ks; idx += kThreads) zrow[idx] = from_f<T>(0.0f);
  __syncthreads();

  int steps, nks = 1;
  const int* crow = nullptr;
  if constexpr (SPARSE) {
    const int i = r0 / bm;
    crow = cols + (long long)i * s_max;
    nks = bk / ks;
    steps = nnz[i] * nks;
  } else {
    steps = (k + bk - 1) / bk * bk / ks;
  }
  // SPLIT: this CTA's splits (w.sp of the gk, from split z * w.sp); the k
  // offset of its first slice; the split its sums belong to
  int kbase = 0, split = 0;
  if constexpr (SPLIT) {
    const int gk = (k + bk - 1) / bk;
    split = blockIdx.z * w.sp;
    nks = bk / ks;
    kbase = split * bk;
    steps = (min(gk, split + w.sp) - split) * nks;
  }
  const int lgk = log2_exact(ks / V), lgn = log2_exact(tw / V);
  const int lgb = cfg.bt ? lgk : lgn;
  const bool a_vec = sa_k == 1 && sa_m % V == 0 && (nb == 1 || sa_b % V == 0) &&
                     (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool b_vec = (cfg.bt ? sb_n % V == 0 : sb_n == 1 && sb_k % V == 0) &&
                     (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  // element (r, c) of a tile whose rows hold 2^lg chunks of V elements
  auto at = [](int r, int c, int ld, int lg) {
    return r * ld + (SW ? (((c / V) ^ ki_swz(r, lg)) * V + c % V) : c);
  };

  // The copy cursor: the stage of the next copy and, SPARSE, its block's
  // index s in the row's list and its slice of the block.  Copies are
  // issued for q = 0, 1, 2, ... in order, so the cursor only counts.
  int islot = 0, is = 0, isl = 0;
  auto issue = [&](int q) {
    unsigned char* st = smem + islot * st_bytes;
    T* sa = reinterpret_cast<T*>(st);
    T* sb = reinterpret_cast<T*>(st + a_bytes);
    int k0;
    if constexpr (SPARSE) {
      k0 = crow[is] * bk + isl * ks;
      if (++isl == nks) {
        isl = 0;
        ++is;
      }
    } else {
      k0 = q * ks;
    }
    if constexpr (SPLIT) k0 += kbase;
    if (a_vec) {
      for (int idx = threadIdx.x; idx < (vrows << lgk); idx += kThreads) {
        const int r = idx >> lgk, c = (idx & ((1 << lgk) - 1)) * V;
        const int valid = max(0, min(V, k - (k0 + c)));
        cp_async16(sa + at(r, c, lda, lgk), valid ? A + rowoff[r] + k0 + c : A,
                   valid * (int)sizeof(T));
      }
    } else {
      for (int idx = threadIdx.x; idx < vrows * ks; idx += kThreads) {
        const int r = idx / ks, c = idx - r * ks;
        sa[at(r, c, lda, lgk)] =
            k0 + c < k ? A[rowoff[r] + (long long)(k0 + c) * sa_k] : from_f<T>(0.0f);
      }
    }
    // B: row j of an n-major tile is column c0 + j of B (a transposed
    // view); a row-major tile holds rows k0 .. k0 + ks of B
    const int br = cfg.bt ? tw : ks, bc = cfg.bt ? ks : tw;
    const int nr = cfg.bt ? n - c0 : k - k0, nc = cfg.bt ? k - k0 : n - c0;
    const T* g = cfg.bt ? B + c0 * sb_n + k0 * sb_k : B + k0 * sb_k + c0 * sb_n;
    const long long s_r = cfg.bt ? sb_n : sb_k, s_c = cfg.bt ? sb_k : sb_n;
    if (b_vec) {
      for (int idx = threadIdx.x; idx < (br << lgb); idx += kThreads) {
        const int r = idx >> lgb, c = (idx & ((1 << lgb) - 1)) * V;
        const int valid = r < nr ? max(0, min(V, nc - c)) : 0;
        cp_async16(sb + at(r, c, ldb, lgb), valid ? g + r * s_r + c : B,
                   valid * (int)sizeof(T));
      }
    } else {
      for (int idx = threadIdx.x; idx < br * bc; idx += kThreads) {
        const int r = idx / bc, c = idx - r * bc;
        sb[at(r, c, ldb, lgb)] = r < nr && c < nc ? g[r * s_r + c * s_c] : from_f<T>(0.0f);
      }
    }
    if (++islot == S) islot = 0;
  };

  Acc run[NS][MR];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int r = 0; r < MR; ++r) acc_zero(run[j][r]);
  // this warp's strips: warp (warps past tw / 16 only copy), and warp + 8
  // in a 256-column tile (NS = 2)
  const bool mma_warp = 16 * warp < tw;
  // WR = 2: warp w holds strips w % 4 + 4 j of the rows of half w / 4
  // (`wnrf` of its fragments hold valid rows)
  const int wrow = WR == 2 ? warp / 4 * 16 * MR : 0;
  const int wnrf = WR == 2 ? max(0, min(MR, (vrows - wrow + 15) / 16)) : nrf;
  for (int q = 0; q < S - 1; ++q) {
    if (q < steps) issue(q);
    cp_async_commit();
  }
  int cslot = 0;
  for (int q = 0; q < steps; ++q) {
    cp_async_wait_n(S - 2);
    __syncthreads();  // step q landed for every thread; step q - 1's slot is free
    if (q + S - 1 < steps) issue(q + S - 1);
    cp_async_commit();
    const unsigned char* st = smem + cslot * st_bytes;
    const T* sa = reinterpret_cast<const T*>(st);
    const T* sb = reinterpret_cast<const T*>(st + a_bytes);
    if constexpr (WR == 2) {
      if (wnrf > 0) {
        if (cfg.bt)
          ki_mma_wide<MR, NS, true>(run, sa + wrow * lda, lda, lgk, sb, ldb, lgb, warp % 4, ks,
                                    wnrf);
        else
          ki_mma_wide<MR, NS, false>(run, sa + wrow * lda, lda, lgk, sb, ldb, lgb, warp % 4, ks,
                                     wnrf);
      }
    } else if (mma_warp) {
      if constexpr (SW && NS == 1) {
        if (cfg.bt)
          ki_mma<MR, true>(run[0], sa, lda, lgk, zrow, sb, ldb, lgb, warp, ks, nrf);
        else
          ki_mma<MR, false>(run[0], sa, lda, lgk, zrow, sb, ldb, lgb, warp, ks, nrf);
      } else if constexpr (SW) {
        if (cfg.bt)
          ki_mma2<MR, true>(run, sa, lda, lgk, sb, ldb, lgb, warp, ks, nrf);
        else
          ki_mma2<MR, false>(run, sa, lda, lgk, sb, ldb, lgb, warp, ks, nrf);
      } else if (cfg.bt) {
        strip_mma<MR, true>(run[0], sa, lda, sb + 16 * warp * ldb, ldb, ks, nrf);
      } else {
        strip_mma<MR>(run[0], sa, lda, sb + 16 * warp, ldb, ks, nrf);
      }
    }
    if (++cslot == S) cslot = 0;
    if constexpr (SPLIT) {
      // the split's last slice: its raw sums to plane `split`, then zero
      if (q % nks == nks - 1) {
        if (mma_warp) {
          float* plane = out + (long long)split * M * n;
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            if (r >= nrf) break;
            store_raw(run[0][r], plane, r0 + 16 * r, c0 + 16 * warp, M, n);
            acc_zero(run[0][r]);
          }
        }
        ++split;
      }
    }
  }
  if constexpr (SPLIT) return;  // every split's sums are stored
  if constexpr (WR == 2) {
    if (wnrf == 0) return;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        if (r >= wnrf) break;
        store_acc(run[j][r], out, r0 + wrow + 16 * r, c0 + 16 * (warp % 4 + 4 * j), M, n, e);
      }
    }
    return;
  }
  // (the early return, not a test in the loop: it keeps NS = 1 at the
  // register count of the dense kernel this template replaced)
  if (!mma_warp) return;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nrf) break;
      store_acc(run[j][r], out, r0 + 16 * r, c0 + 16 * (warp + 8 * j), M, n, e, m);
    }
  }
}

// Launch k_inner_kernel on a (c.gm, c.gn, gz) grid; `w` carries the split
// and grouped walks' arguments.
template <typename T, typename O, int MR, int NS, KiWalk W, int WR = 1>
int launch_k_inner(const KICfg& c, const T* a, long long sa_b, long long sa_m,
                   long long sa_k, const T* b, long long sb_k, long long sb_n, O* o, int nb,
                   int m, int k, int n, int bk, const Epi& e, const int* cols, const int* nnz,
                   int s_max, int bm, cudaStream_t stream, int gz = 1,
                   const KIWalkArgs& w = KIWalkArgs{}) {
  const cudaError_t err =
      cudaFuncSetAttribute(k_inner_kernel<T, O, MR, NS, W, WR>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(c.gm, c.gn, gz);
  k_inner_kernel<T, O, MR, NS, W, WR><<<grid, kThreads, c.smem, stream>>>(
      a, sa_b, sa_m, sa_k, b, sb_k, sb_n, o, nb, m, k, n, bk, c, e, cols, nnz, s_max, bm, w);
  return (int)cudaGetLastError();
}

}  // namespace rt
