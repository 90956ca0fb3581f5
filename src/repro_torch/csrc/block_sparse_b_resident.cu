// Block-sparse (BSR) matmul, the b_resident schedule, hand-written for
// Hopper.  Its own source (and library) so that nvcc builds it beside
// csrc/block_sparse_matmul.cu (k_inner, a_resident), which holds the
// family's notes.
//
// Replaces: src/repro/sparse/kernels.py::block_sparse_matmul_padded
//   (body _bsr_resident_kernel, the B-resident loop order).
//
//   C = act(scale * (sparse(A) @ B) + bias) + residual
//
// Bound on the H100: 2 * nnz_elems * n operations against the nonzero A
// blocks, B and C once; at the tuner's 4096^2 (32, 128) layouts with
// n = 4096 that is the tensor-core rate.  The design: the fp32 sums of a
// chunk of row blocks in registers (no workspace), all 8 warps on each row
// block's tile, the chunk's column blocks walked in ascending order so a B
// slice is fetched once per chunk, and A blocks and B slices streamed
// through a cp.async ring.  What is left: each step (one A block) costs a
// barrier, and B is re-read from L2 once per chunk and column block.
#include <climits>

#include "common.cuh"

namespace rt {

// b_resident's shape on the card (mirrored by `b_resident_config` in
// kernels/block_sparse_matmul.py).  The CTA covers tw columns (bf16: the
// widest power-of-two multiple of 16 within bn and 128; fp32: 16) of a
// chunk of row blocks.  The 8 warps form a wr x wc grid over one row
// block's bm x tw tile: a warp owns 16 * mr rows (mr a power of two, at
// most 4 for bf16 and 2 for fp32, so that only those kernels are built;
// tw is halved until mr fits) and one 16-column strip, and keeps that
// fragment's fp32 sums for each of the chunk's 8 / mr row blocks in
// registers.  A blocks and B slices
// stream through `stages` shared-memory stages (2 to 4: as many as leave
// room for two CTAs an SM, else as many as fit one).
template <typename T> constexpr int kBrMrMax = sizeof(T) == 2 ? 4 : 2;
struct BRCfg {
  int wr, wc, tw, mr, stages;
  long long smem;  // dynamic shared memory in bytes; -1: no shape fits
};

// The walk's control block: thread 0 merges the chunk's sorted column
// lists (one cursor per row block) and writes one descriptor a step.
constexpr int kBrDesc = 16;  // descriptor ring: steps q .. q + stages live
struct BrCtl {
  int head[8];  // the column block at each row block's cursor (INT_MAX: done)
  int cur[8];   // each row block's cursor into its sorted cols
  int kb, rr, group;
  int desc[kBrDesc][4];  // row block, column block, B stage, flags
};
constexpr int kBrFresh = 1, kBrFirst = 2;  // a new column block; a row's first block

template <typename T>
__host__ __device__ inline long long br_stage_bytes(int bm, int bk, int tw) {
  return align128((long long)bm * (bk + pad<T>()) * sizeof(T)) +
         align128((long long)bk * (tw + pad<T>()) * sizeof(T));
}

template <typename T>
inline BRCfg br_config(int bm, int bk, int bn) {
  BRCfg c{};
  const int bm16 = (bm + 15) / 16;
  const int mr_max = kBrMrMax<T>;
  int tw = 16;
  while (2 * tw <= bn && 2 * tw <= 128 && sizeof(T) == 2) tw *= 2;
  for (;;) {
    c.wc = tw / 16;
    c.wr = 8 / c.wc;
    const int need = (bm16 + c.wr - 1) / c.wr;
    c.mr = 1;
    while (c.mr < need) c.mr *= 2;
    if (c.mr <= mr_max || tw == 16) break;
    tw /= 2;
  }
  c.tw = tw;
  c.smem = -1;
  if (c.mr > mr_max) return c;
  const long long st = br_stage_bytes<T>(bm, bk, tw);
  const long long ctl = align128(sizeof(BrCtl));
  const long long caps[2] = {(kSmemMax - 1024) / 2, kSmemMax};
  for (const long long cap : caps)
    for (int s = 4; s >= 2; --s)
      if (s * st + ctl <= cap) {
        c.stages = s;
        c.smem = s * st + ctl;
        return c;
      }
  return c;
}

// blockIdx = (chunk of `per` row blocks, column tile).  The CTA walks the
// chunk's column blocks kb in ascending order, merging the row blocks'
// sorted cols lists: the B slice (bk x tw) of each kb that any of its row
// blocks holds is fetched once, and for each row block whose cursor
// points at kb (in row order) its A block is fetched, its partial formed
// from zero with strip_mma over bk in 16-deep steps, and added to that row
// block's register sums with one fp32 add (the first partial is the sum).
// A row's blocks arrive in its s order, so this is the fold `combine`
// performs through K1 b_resident's workspace: at density 1.0 the output
// equals K1's bit for bit.  Steps q = (kb, row block) pairs; the copies of
// step q + stages - 1 are in flight while step q multiplies.  A step's A
// block takes stage q % stages and a column block's B slice stage
// (its index in the walk) % stages: a B stage is overwritten only after
// every step that read it (a step opens at most one column block).
template <typename T, typename O, int MR>
__global__ void __launch_bounds__(kThreads, MR <= 2 ? 2 : 1)
bsr_b_resident_kernel(const int* __restrict__ cols, const int* __restrict__ nnz, int s_max,
                      const T* __restrict__ A, long long sa_m, long long sa_k,
                      const T* __restrict__ B, long long sb_k, long long sb_n,
                      O* __restrict__ out, int m, int k, int n, int bm, int bk, int per,
                      BRCfg cfg, Epi e) {
  constexpr int RB = 8 / MR;  // row blocks a CTA may hold (64 sums a lane)
  constexpr int V = 16 / (int)sizeof(T);
  using Acc = typename AccFrag<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tw = cfg.tw, S = cfg.stages;
  const int lda = bk + pad<T>(), ldb = tw + pad<T>();
  const long long a_bytes = align128((long long)bm * lda * sizeof(T));
  const long long st_bytes = br_stage_bytes<T>(bm, bk, tw);
  BrCtl& ctl = *reinterpret_cast<BrCtl*>(smem + S * st_bytes);
  const int warp = threadIdx.x / 32;
  const int gm = (m + bm - 1) / bm;
  const int ib = blockIdx.x * per, rbn = min(per, gm - ib);
  const int c0 = blockIdx.y * tw;

  int total = 0;
  for (int r = 0; r < rbn; ++r) {
    const int cnt = nnz[ib + r];
    if (cnt == 0) write_empty(out, (ib + r) * bm, c0, bm, tw, m, n, e);
    total += cnt;
  }
  if (total == 0) return;

  // thread 0's merge: the next (row block, column block) in (kb, row) order
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

  const int lga = log2_exact(bk / V);
  const bool a_vec = lga >= 0 && sa_k == 1 && sa_m % V == 0 &&
                     (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool b_vec = sb_n == 1 && sb_k % V == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  const int lgb = log2_exact(tw / V);
  int aslot = 0;
  auto issue = [&](int j) {
    const int* d = ctl.desc[j % kBrDesc];
    const int i0 = (ib + d[0]) * bm, k0 = d[1] * bk;
    T* sa = reinterpret_cast<T*>(smem + aslot * st_bytes);
    if (a_vec)
      copy_tile_async(sa, lda, A, sa_m, i0, k0, bm, lga, m, k);
    else
      load_tile_async(sa, lda, A, sa_m, sa_k, i0, k0, bm, bk, m, k);
    if (d[3] & kBrFresh) {
      T* sb = reinterpret_cast<T*>(smem + d[2] * st_bytes + a_bytes);
      if (b_vec)
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
    if (threadIdx.x == 0 && q + S < total) gen(q + S);
    const int* d = ctl.desc[q % kBrDesc];
    const int r = d[0];
    const int rlim = min(bm, m - (ib + r) * bm);
    const int nrf = max(0, min(MR, (rlim - rb + 15) / 16));
#pragma unroll
    for (int f = 0; f < MR; ++f) acc_zero(part[f]);
    if (nrf > 0)
      strip_mma<MR>(part, reinterpret_cast<const T*>(smem + cslot * st_bytes) + rb * lda, lda,
                    reinterpret_cast<const T*>(smem + d[2] * st_bytes + a_bytes) + wc * 16, ldb,
                    bk, nrf);
    const bool first = d[3] & kBrFirst;
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
    if (nnz[ib + rr] == 0) continue;
    const int rlim = min(bm, m - (ib + rr) * bm);
    const int nrf = max(0, min(MR, (rlim - rb + 15) / 16));
#pragma unroll
    for (int f = 0; f < MR; ++f) {
      if (f >= nrf) break;
      store_acc(run[rr][f], out, (ib + rr) * bm + rb + 16 * f, c0 + wc * 16, m, n, e);
    }
  }
}

template <typename T, typename O, int MR>
int launch_mr(const BRCfg& c, dim3 grid, const int* cols, const int* nnz, int s_max, const T* a,
              long long sa_m, long long sa_k, const T* b, long long sb_k, long long sb_n, O* o,
              int m, int k, int n, int bm, int bk, int per, const Epi& e, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_b_resident_kernel<T, O, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  bsr_b_resident_kernel<T, O, MR><<<grid, kThreads, c.smem, stream>>>(
      cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k, n, bm, bk, per, c, e);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_b_resident(const int* cols, const int* nnz, int s_max, const void* A, long long sa_m,
                      long long sa_k, const void* B, long long sb_k, long long sb_n, void* out,
                      int m, int k, int n, int bm, int bk, int bn, int per, const Epi& e,
                      cudaStream_t stream) {
  if (tile_smem_bytes<T>(bm, bk, bn) > kSmemMax) return (int)cudaErrorInvalidValue;
  const BRCfg c = br_config<T>(bm, bk, bn);
  if (c.smem < 0) return (int)cudaErrorInvalidValue;
  const int gm = (m + bm - 1) / bm, ntiles = (n + c.tw - 1) / c.tw;
  per = max(1, min(per, 8 / c.mr));
  if (ntiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((gm + per - 1) / per, ntiles, 1);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  O* o = static_cast<O*>(out);
  if (c.mr == 1)
    return launch_mr<T, O, 1>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k,
                              n, bm, bk, per, e, stream);
  if (c.mr == 2)
    return launch_mr<T, O, 2>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k,
                              n, bm, bk, per, e, stream);
  if constexpr (kBrMrMax<T> >= 4)
    return launch_mr<T, O, 4>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k,
                              n, bm, bk, per, e, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt

// cols is a contiguous int32 (gm, s_max) table and nnz int32 (gm,), both on
// the device.  Strides are in elements; `out` is a contiguous (m, n)
// tensor; `per` is the number of row blocks a CTA holds (the wrapper's
// `b_resident_chunk`).  Returns the cudaError_t of the launch.
extern "C" int rt_block_sparse_b_resident(int in_bf16, int out_bf16, const void* cols,
                                          const void* nnz, int s_max, const void* A,
                                          long long sa_m, long long sa_k, const void* B,
                                          long long sb_k, long long sb_n, void* out, int m,
                                          int k, int n, int bm, int bk, int bn, int per,
                                          float scale, int has_scale, const void* bias,
                                          int bias_bf16, int act, const void* res,
                                          int res_bf16, long long rs_m, long long rs_n,
                                          void* stream) {
  rt::Epi e{scale, has_scale, bias, bias_bf16, act, res, res_bf16, 0, rs_m, rs_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const int* z = static_cast<const int*>(nnz);
  if (in_bf16 && out_bf16)
    return rt::launch_b_resident<rt::bf16, rt::bf16>(c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n,
                                                     out, m, k, n, bm, bk, bn, per, e, s);
  if (in_bf16)
    return rt::launch_b_resident<rt::bf16, float>(c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n,
                                                  out, m, k, n, bm, bk, bn, per, e, s);
  if (out_bf16)
    return rt::launch_b_resident<float, rt::bf16>(c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n,
                                                  out, m, k, n, bm, bk, bn, per, e, s);
  return rt::launch_b_resident<float, float>(c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n, out, m,
                                             k, n, bm, bk, bn, per, e, s);
}
