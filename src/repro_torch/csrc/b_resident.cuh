// The b_resident device code shared by K1's dense b_resident
// (csrc/skew_matmul.cu) and K9's (csrc/block_sparse_b_resident.cu).
//
// One kernel template, `b_resident_kernel`, whose walk is its only
// difference between the two.  The CTA holds a chunk of `per` row blocks
// and one column tile; it walks the chunk's column blocks kb in ascending
// order, fetches the B slice (bk x tw) of each once, and for each row
// block that holds kb (in row order) fetches its A block, forms the
// block's partial from zero over bk in 16-deep MMA steps and adds it to
// that row block's register sums with one fp32 add (the first partial is
// the sum): the JAX kernel's fold, with no workspace.  Dense (K1): every
// row block holds every column block, so the steps are (kb, row block) in
// that order, computed from the step's index.  SPARSE (K9): thread 0
// merges the chunk's sorted column lists (one cursor per row block) and
// writes one descriptor a step.  At density 1.0 the two walks are the same
// steps in the same order, so K9 equals K1 bit for bit by construction.
#pragma once

#include <climits>

#include "common.cuh"

namespace rt {

// b_resident's shape on the card (`br_config` for K9, mirrored by
// `b_resident_config` in kernels/block_sparse_matmul.py; `brd_config` in
// csrc/skew_matmul.cu for K1, mirrored by `b_resident_config` in
// kernels/skew_matmul.py).  The CTA covers tw columns (bf16: the widest
// power-of-two multiple of 16 within bn and 128, K1 narrower where the
// grid would leave SMs idle; fp32: 16) of a chunk of row blocks.  The 8
// warps form a wr x wc grid over one row block's bm x tw tile: a warp owns
// 16 * mr rows (mr a power of two, at most 4 for bf16 and 2 for fp32, so
// that only those kernels are built; tw is halved until mr fits) and one
// 16-column strip, and keeps that fragment's fp32 sums for each of the
// chunk's 8 / mr row blocks in registers.  A blocks and B slices stream
// through `stages` shared-memory stages (2 to 4: as many as leave room for
// two CTAs an SM, else as many as fit one).  bt (K1): B is a transposed
// view (unit stride along k, a tied embedding read as E^T), copied
// n-major; K9 copies row-major slices (a transposed B through load_tile's
// gather).
template <typename T> constexpr int kBrMrMax = sizeof(T) == 2 ? 4 : 2;
struct BRCfg {
  int wr, wc, tw, mr, stages, bt;
  int ra;          // rows of an A block a stage holds: bm, or (K1, m < bm) the
                   // 16-row granules of the one row block
  long long smem;  // dynamic shared memory in bytes; -1: no shape fits
};

// K9's control block: thread 0 merges the chunk's sorted column lists
// (one cursor per row block) and writes one descriptor a step.
constexpr int kBrDesc = 16;  // descriptor ring: steps q .. q + stages live
struct BrCtl {
  int head[8];  // the column block at each row block's cursor (INT_MAX: done)
  int cur[8];   // each row block's cursor into its sorted cols
  int kb, rr, group;
  int desc[kBrDesc][4];  // row block, column block, B stage, flags
};
constexpr int kBrFresh = 1, kBrFirst = 2;  // a new column block; a row's first block

template <typename T>
__host__ __device__ inline long long br_stage_bytes(int bm, int bk, int tw, int bt) {
  return align128((long long)bm * (bk + pad<T>()) * sizeof(T)) +
         (bt ? align128((long long)tw * (bk + pad<T>()) * sizeof(T))
             : align128((long long)bk * (tw + pad<T>()) * sizeof(T)));
}

// The widest tile a plan's bn gives: bf16 a power-of-two multiple of 16
// within bn and 128, fp32 16.
template <typename T>
inline int br_width(int bn) {
  int tw = 16;
  while (2 * tw <= bn && 2 * tw <= 128 && sizeof(T) == 2) tw *= 2;
  return tw;
}

// The warp grid over the ra x tw tile of a row block, tw halved until mr
// fits.
template <typename T>
inline void br_layout(BRCfg& c, int ra, int tw) {
  c.ra = ra;
  const int bm16 = (ra + 15) / 16;
  for (;;) {
    c.wc = tw / 16;
    c.wr = 8 / c.wc;
    const int need = (bm16 + c.wr - 1) / c.wr;
    c.mr = 1;
    while (c.mr < need) c.mr *= 2;
    if (c.mr <= kBrMrMax<T> || tw == 16) break;
    tw /= 2;
  }
  c.tw = tw;
}

// The ring: smax (K9 4, K1 8) to 2 stages within two CTAs an SM, else
// within one; `fixed` bytes (K9's control block) sit after the stages.
template <typename T>
inline void br_ring(BRCfg& c, int bk, long long fixed, int smax) {
  c.stages = 0;
  c.smem = -1;
  if (c.mr > kBrMrMax<T>) return;
  const long long st = br_stage_bytes<T>(c.ra, bk, c.tw, c.bt);
  const long long caps[2] = {(kSmemMax - 1024) / 2, kSmemMax};
  for (const long long cap : caps)
    for (int s = smax; s >= 2; --s)
      if (s * st + fixed <= cap) {
        c.stages = s;
        c.smem = s * st + fixed;
        return;
      }
}

// blockIdx = (chunk of `per` row blocks, column tile).  Steps q are (kb,
// row block) pairs in kb order; the copies of step q + stages - 1 are in
// flight while step q multiplies (one commit group and one barrier a
// step).  A step's A block takes stage q % stages and a column block's B
// slice stage (its index in the walk) % stages: a B stage is overwritten
// only after every step that read it (a step opens at most one column
// block).  Only the 16-row granules of an A block that hold rows are
// copied and multiplied, and (K1) stages and warps are sized to them
// (decode: 4 rows of a 64-row block cost one granule, 16 x 16 sums a
// warp).  `cols` / `nnz` / `s_max`: K9's sorted column lists (SPARSE).
// BT == cfg.bt, a template flag so a kernel holds one MMA loop.
template <typename T, typename O, int MR, bool SPARSE, bool BT>
__global__ void __launch_bounds__(kThreads, MR <= 2 ? 2 : 1)
b_resident_kernel(const int* __restrict__ cols, const int* __restrict__ nnz, int s_max,
                  const T* __restrict__ A, long long sa_m, long long sa_k,
                  const T* __restrict__ B, long long sb_k, long long sb_n,
                  O* __restrict__ out, int m, int k, int n, int bm, int bk, int per,
                  BRCfg cfg, Epi e) {
  constexpr int RB = 8 / MR;  // row blocks a CTA may hold (64 sums a lane)
  constexpr int V = 16 / (int)sizeof(T);
  using Acc = typename AccFrag<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tw = cfg.tw, S = cfg.stages;
  const int lda = bk + pad<T>(), ldb = BT ? bk + pad<T>() : tw + pad<T>();
  const long long a_bytes = align128((long long)cfg.ra * lda * sizeof(T));
  const long long st_bytes = br_stage_bytes<T>(cfg.ra, bk, tw, BT);
  BrCtl& ctl = *reinterpret_cast<BrCtl*>(smem + S * st_bytes);  // SPARSE only
  const int warp = threadIdx.x / 32;
  const int gm = (m + bm - 1) / bm, gk = (k + bk - 1) / bk;
  const int ib = blockIdx.x * per, rbn = min(per, gm - ib);
  const int c0 = blockIdx.y * tw;

  int total = 0;
  for (int r = 0; r < rbn; ++r) {
    const int cnt = SPARSE ? nnz[ib + r] : gk;
    if (cnt == 0) write_empty(out, (ib + r) * bm, c0, bm, tw, m, n, e);
    total += cnt;
  }
  if (total == 0) return;

  // thread 0's merge (SPARSE): the next (row block, column block) in (kb,
  // row) order
  auto gen = [&](int j) {
    int r = -1;
    for (int rr = ctl.rr + 1; rr < rbn; ++rr)
      if (ctl.head[rr] == ctl.kb) {
        r = rr;
        break;
      }
    int flags = 0;
    if (r < 0) {
      int kb = INT_MAX;
      for (int rr = 0; rr < rbn; ++rr) kb = min(kb, ctl.head[rr]);
      for (int rr = rbn - 1; rr >= 0; --rr)
        if (ctl.head[rr] == kb) r = rr;
      ctl.kb = kb;
      ++ctl.group;
      flags |= kBrFresh;
    }
    ctl.rr = r;
    if (ctl.cur[r] == 0) flags |= kBrFirst;
    int* d = ctl.desc[j % kBrDesc];
    d[0] = r;
    d[1] = ctl.kb;
    d[2] = ctl.group % S;
    d[3] = flags;
    const int c = ++ctl.cur[r];
    ctl.head[r] = c < nnz[ib + r] ? cols[(long long)(ib + r) * s_max + c] : INT_MAX;
  };
  if constexpr (SPARSE) {
    if (threadIdx.x == 0) {
      for (int r = 0; r < 8; ++r) {
        ctl.cur[r] = 0;
        ctl.head[r] = r < rbn && nnz[ib + r] > 0 ? cols[(long long)(ib + r) * s_max] : INT_MAX;
      }
      ctl.kb = -1;
      ctl.rr = 8;
      ctl.group = -1;
      for (int j = 0; j < S && j < total; ++j) gen(j);
    }
    __syncthreads();
  }
  // step j's row block, column block, B stage and flags
  auto step = [&](int j, int& r, int& kb, int& bs, int& fl) {
    if constexpr (SPARSE) {
      const int* d = ctl.desc[j % kBrDesc];
      r = d[0];
      kb = d[1];
      bs = d[2];
      fl = d[3];
    } else {
      kb = j / rbn;
      r = j - kb * rbn;
      bs = kb % S;
      fl = (r == 0 ? kBrFresh : 0) | (kb == 0 ? kBrFirst : 0);
    }
  };

  const int lga = log2_exact(bk / V);
  const bool a_vec = lga >= 0 && sa_k == 1 && sa_m % V == 0 &&
                     (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const int lgb = log2_exact(tw / V);
  const bool b_vec =
      (reinterpret_cast<uintptr_t>(B) & 15) == 0 &&
      (BT ? lga >= 0 && sb_k == 1 && sb_n % V == 0 : sb_n == 1 && sb_k % V == 0);
  int aslot = 0;
  auto issue = [&](int j) {
    int r, kb, bs, fl;
    step(j, r, kb, bs, fl);
    const int i0 = (ib + r) * bm, k0 = kb * bk;
    // the granules that hold rows
    const int R = min(bm, (min(bm, m - i0) + 15) / 16 * 16);
    T* sa = reinterpret_cast<T*>(smem + aslot * st_bytes);
    if (a_vec)
      copy_tile_async(sa, lda, A, sa_m, i0, k0, R, lga, m, k);
    else
      load_tile_async(sa, lda, A, sa_m, sa_k, i0, k0, R, bk, m, k);
    if (fl & kBrFresh) {
      T* sb = reinterpret_cast<T*>(smem + bs * st_bytes + a_bytes);
      // n-major: row j of the slice is column c0 + j of B, bk deep
      if (BT && b_vec)
        copy_tile_async(sb, ldb, B, sb_n, c0, k0, tw, lga, n, k);
      else if (BT)
        load_tile(sb, ldb, B, sb_n, sb_k, c0, k0, tw, bk, n, k);
      else if (b_vec)
        copy_tile_async(sb, ldb, B, sb_k, k0, c0, bk, lgb, k, n);
      else
        load_tile(sb, ldb, B, sb_k, sb_n, k0, c0, bk, tw, k, n);
    }
    if (++aslot == S) aslot = 0;
  };

  const int wr = warp / cfg.wc, wc = warp % cfg.wc;
  const int rb = wr * MR * 16;
  Acc run[RB][MR];
  Acc part[MR];
  for (int q = 0; q < S - 1; ++q) {
    if (q < total) issue(q);
    cp_async_commit();
  }
  int cslot = 0;
  for (int q = 0; q < total; ++q) {
    cp_async_wait_n(S - 2);
    __syncthreads();  // step q landed; step q - 1's stages and descriptor are free
    if (q + S - 1 < total) issue(q + S - 1);
    cp_async_commit();
    if constexpr (SPARSE)
      if (threadIdx.x == 0 && q + S < total) gen(q + S);
    int r, kb, bs, fl;
    step(q, r, kb, bs, fl);
    const int rlim = min(bm, m - (ib + r) * bm);
    const int nrf = max(0, min(MR, (rlim - rb + 15) / 16));
#pragma unroll
    for (int f = 0; f < MR; ++f) acc_zero(part[f]);
    if (nrf > 0) {
      const T* sa = reinterpret_cast<const T*>(smem + cslot * st_bytes) + rb * lda;
      const T* sb = reinterpret_cast<const T*>(smem + bs * st_bytes + a_bytes);
      if constexpr (BT)
        strip_mma<MR, true>(part, sa, lda, sb + wc * 16 * ldb, ldb, bk, nrf);
      else
        strip_mma<MR>(part, sa, lda, sb + wc * 16, ldb, bk, nrf);
    }
    const bool first = fl & kBrFirst;
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      if (rr != r) continue;
#pragma unroll
      for (int f = 0; f < MR; ++f)
#pragma unroll
        for (int x = 0; x < 8; ++x)
          run[rr][f].x[x] = first ? part[f].x[x] : run[rr][f].x[x] + part[f].x[x];
    }
    if (++cslot == S) cslot = 0;
  }
#pragma unroll
  for (int rr = 0; rr < RB; ++rr) {
    if (rr >= rbn) break;
    if (SPARSE && nnz[ib + rr] == 0) continue;
    const int rlim = min(bm, m - (ib + rr) * bm);
    const int nrf = max(0, min(MR, (rlim - rb + 15) / 16));
#pragma unroll
    for (int f = 0; f < MR; ++f) {
      if (f >= nrf) break;
      store_acc(run[rr][f], out, (ib + rr) * bm + rb + 16 * f, c0 + wc * 16, m, n, e);
    }
  }
}

template <typename T, typename O, int MR, bool SPARSE, bool BT>
int launch_br_mr(const BRCfg& c, dim3 grid, const int* cols, const int* nnz, int s_max,
                 const T* a, long long sa_m, long long sa_k, const T* b, long long sb_k,
                 long long sb_n, O* o, int m, int k, int n, int bm, int bk, int per,
                 const Epi& e, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(b_resident_kernel<T, O, MR, SPARSE, BT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  b_resident_kernel<T, O, MR, SPARSE, BT><<<grid, kThreads, c.smem, stream>>>(
      cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k, n, bm, bk, per, c, e);
  return (int)cudaGetLastError();
}

template <typename T, typename O, bool SPARSE, bool BT>
int launch_br_bt(const BRCfg& c, dim3 grid, const int* cols, const int* nnz, int s_max,
                 const T* a, long long sa_m, long long sa_k, const T* b, long long sb_k,
                 long long sb_n, O* o, int m, int k, int n, int bm, int bk, int per,
                 const Epi& e, cudaStream_t stream) {
  if (c.mr == 1)
    return launch_br_mr<T, O, 1, SPARSE, BT>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k,
                                             sb_n, o, m, k, n, bm, bk, per, e, stream);
  if (c.mr == 2)
    return launch_br_mr<T, O, 2, SPARSE, BT>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k,
                                             sb_n, o, m, k, n, bm, bk, per, e, stream);
  if constexpr (kBrMrMax<T> >= 4)
    if (c.mr == 4)
      return launch_br_mr<T, O, 4, SPARSE, BT>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b,
                                               sb_k, sb_n, o, m, k, n, bm, bk, per, e, stream);
  return (int)cudaErrorInvalidValue;
}

// Launch the kernel built for c.mr and c.bt on a grid of (row chunks,
// column tiles), `per` row blocks a CTA (at most 8 / mr).  BT_TOO: the
// n-major copy is built (K1); K9 builds row-major slices only.
template <typename T, typename O, bool SPARSE, bool BT_TOO>
int launch_b_resident(const BRCfg& c, dim3 grid, const int* cols, const int* nnz, int s_max,
                      const void* A, long long sa_m, long long sa_k, const void* B,
                      long long sb_k, long long sb_n, void* out, int m, int k, int n, int bm,
                      int bk, int per, const Epi& e, cudaStream_t stream) {
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  O* o = static_cast<O*>(out);
  if (c.bt) {
    if constexpr (BT_TOO)
      return launch_br_bt<T, O, SPARSE, true>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k,
                                              sb_n, o, m, k, n, bm, bk, per, e, stream);
    return (int)cudaErrorInvalidValue;
  }
  return launch_br_bt<T, O, SPARSE, false>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k,
                                           sb_n, o, m, k, n, bm, bk, per, e, stream);
}

}  // namespace rt
