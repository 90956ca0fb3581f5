// Block-sparse (BSR) matmul, hand-written for Hopper.
//
// Replaces: src/repro/sparse/kernels.py::block_sparse_matmul_padded
//   (bodies _bsr_k_inner_kernel and _bsr_resident_kernel).
//
//   C = act(scale * (sparse(A) @ B) + bias) + residual
//
// over the nonzero (bm x bk) blocks of A that the layout names: row block
// i owns column blocks cols[i, :nnz[i]] (sorted); blocks absent from the
// layout are never read.  fp32 accumulation, the epilogue at fp32, one
// cast to the output type.
//
// Loop structure (the Pallas grid's sequential s dimension becomes a loop
// inside the CTA, its parallel dims become blockIdx).  Each CTA reads
// nnz[i] and cols[i, s] from global memory itself, in place of Pallas's
// scalar prefetch, and runs only the valid steps s < nnz[i]: the masked
// tail steps of the TPU kernel are never executed, which gives exactly
// what they give (nothing).  A row block with nnz[i] == 0 still writes its
// output rows, as epilogue(0) (bias and residual).  One library a
// schedule, so that nvcc builds the three side by side:
//   k_inner    — csrc/block_sparse_k_inner.cu: K1's k_inner device code
//                (csrc/k_inner.cuh) walking the slices of the CTA's row
//                block's nonzero blocks; register sums, a cp.async ring,
//                up to 256 columns a CTA.
//   a_resident — here: blockIdx = (row block, column chunk).  For each
//                nonzero block the A block stays in shared memory while
//                the CTA walks the column tiles of its chunk.  Redesigned
//                for Hopper (see bsr_a_resident_kernel): the fp32 sums of
//                the whole chunk stay in registers across s (no
//                workspace), all 8 warps split the columns, and B streams
//                through a cp.async ring; one CTA owns its outputs, so no
//                atomics.
//   b_resident — csrc/block_sparse_b_resident.cu: the CTA walks a chunk of
//                row blocks' column blocks in ascending order, fetching
//                each B slice once for every row block that holds it, with
//                the sums in registers and a cp.async ring.
//
// Density-1.0 parity: k_inner runs K1's k_inner template, whose walk is
// then K1's; a_resident and b_resident form each block's partial with the
// same MMAs in the same k order (strip_mma) and fold it as K1's a_resident
// and b_resident do.  At density 1.0 cols[i, s] == s and nnz[i] == gk, so
// every element sees the same products summed in the same order: the
// output is bitwise equal to K1's at the same blocks and schedule.
//
// Bound on the H100: the work is 2 * nnz_elems * n operations and the
// bytes are the nonzero A blocks once, B once and C once.  At the tuner's
// 4096^2 (32, 128) layouts with n = 4096 the products run at a few hundred
// operations per byte, above the card's ~295 FLOP/byte ridge, so the bound
// is the tensor-core rate.  All three schedules keep every warp busy and
// overlap their copies with the MMAs; what is left is B's re-read from L2
// (k_inner: once per row block and nonzero block across all of n;
// a_resident: once per row block and nonzero block; b_resident: once per
// chunk of row blocks and column block) and the per-step barrier.  Blocks
// come from the layout, not the planner, so the wrappers take any (bm, bk)
// that K1's shared-memory rule allows, (128, 128, 64) included (the
// planner's fail-over plan at (128, 128) layouts).  TMA and wgmma (64-row
// warpgroup tiles, so only for bm >= 64 layouts) are later work.
#include "common.cuh"

namespace rt {

// a_resident's shape on the card (mirrored by `a_resident_config` in
// kernels/block_sparse_matmul.py).  The 8 warps form a wr x wc grid: a
// warp owns 16 * mr rows of the block (mr a power of two, at most 8) and a
// 16-column strip of every tw = 16 * wc wide column tile, so at bm <= 128
// (wr = 1) all 8 warps split the columns.  B streams through two
// shared-memory slots of ks x tw (ks the deepest slice of bk that fits,
// up to 128), so the copy of step q + 1 overlaps step q's MMAs; the A
// block is double-buffered the same way.
struct ARCfg {
  int wr, wc, tw, mr, ks;
  long long smem;  // dynamic shared memory in bytes; -1: no shape fits
};

template <typename T>
inline ARCfg ar_config(int bm, int bk) {
  ARCfg c{};
  const int bm16 = (bm + 15) / 16;
  c.wr = 1;
  while (c.wr < 8 && (bm16 + c.wr - 1) / c.wr > 8) c.wr *= 2;
  const int need = (bm16 + c.wr - 1) / c.wr;
  c.mr = 1;
  while (c.mr < need) c.mr *= 2;
  c.wc = 8 / c.wr;
  c.tw = 16 * c.wc;
  c.smem = -1;
  if (c.mr > 8) return c;
  const long long a = align128((long long)bm * (bk + pad<T>()) * sizeof(T));
  // The deepest slice that divides bk and fits: each step costs a barrier
  // and a wait, so on the H100 few large steps beat many small ones, and
  // a third slot of 128 rows would cost the second CTA per SM at bm 32.
  for (int ks = 128; ks >= 16; ks /= 2) {
    if (bk % ks) continue;
    const long long b = align128((long long)ks * (c.tw + pad<T>()) * sizeof(T));
    const long long total = 2 * a + 2 * b;
    if (total <= kSmemMax) {
      c.ks = ks;
      c.smem = total;
      return c;
    }
  }
  return c;
}

// blockIdx = (row block i, column chunk): the CTAs in flight together
// share a chunk, so the B columns they stream (k x `per` tiles) stay in L2
// while every row block that needs them passes.  The CTA owns the chunk's
// `per` column tiles (the last chunk may hold fewer) and keeps their fp32
// sums in registers for the whole s loop: no workspace.  Steps q = (s, tile,
// k slice) run in that order; the B slice of step q + 1 (and, at a
// block's first step, its A block) is fetched with cp.async into the other
// of two slots while step q runs its MMAs.  For each (s, tile) a
// warp forms the block's partial product from zero over its bk in 16-deep
// steps, then adds it to the running sum with one fp32 add (the first
// block's partial is the sum): the fold of K1's a_resident (and of the
// JAX kernel), so at density 1.0 the output equals K1's bit for bit.  The epilogue is applied once, after the last s.
template <typename T, typename O, int MR>
__global__ void __launch_bounds__(kThreads, MR <= 2 ? 2 : 1)
bsr_a_resident_kernel(const int* __restrict__ cols, const int* __restrict__ nnz, int s_max,
                      const T* __restrict__ A, long long sa_m, long long sa_k,
                      const T* __restrict__ B, long long sb_k, long long sb_n,
                      O* __restrict__ out, int m, int k, int n, int bm, int bk, int per,
                      ARCfg cfg, Epi e) {
  constexpr int TN = 8 / MR;  // column tiles a CTA may hold (64 sums a lane)
  using Acc = typename AccFrag<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tw = cfg.tw, ks = cfg.ks;
  const int lda = bk + pad<T>(), ldb = tw + pad<T>();
  const long long a_bytes = align128((long long)bm * lda * sizeof(T));
  const long long b_bytes = align128((long long)ks * ldb * sizeof(T));
  T* const sa0 = reinterpret_cast<T*>(smem);
  T* const sa1 = reinterpret_cast<T*>(smem + a_bytes);
  unsigned char* sb = smem + 2 * a_bytes;
  const int warp = threadIdx.x / 32;

  const int ntiles = (n + tw - 1) / tw;
  const int i = blockIdx.x, i0 = i * bm;
  const int t0 = blockIdx.y * per;
  const int tnc = min(per, ntiles - t0);
  const int cnt = nnz[i];
  const int* row = cols + (long long)i * s_max;
  if (cnt == 0) {
    write_empty(out, i0, t0 * tw, bm, tnc * tw, m, n, e);
    return;
  }
  const int wr = warp / cfg.wc, wc = warp % cfg.wc;
  const int rb = wr * MR * 16;
  const int rlim = min(bm, m - i0);
  const int nrf = max(0, min(MR, (rlim - rb + 15) / 16));
  const int nks = bk / ks, steps = cnt * tnc * nks;

  // B slices: with a unit column stride and 16-byte aligned rows each
  // thread issues cp.async copies at offsets fixed for the whole run (a
  // slice row holds 2^lg 16-byte vectors); otherwise load_tile's loads.
  constexpr int V = 16 / (int)sizeof(T);
  const bool b_vec =
      sb_n == 1 && sb_k % V == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  const int lg = 31 - __clz(tw / V);
  // Steps are walked by two cursors, (block, tile, k slice, slot): one
  // for the copies, a step ahead, and one for the MMAs.  They advance by
  // counting, so a step costs no integer division.
  int is = 0, it = 0, ik = 0, islot = 0, ik0 = row[0] * bk;
  auto issue_next = [&]() {
    if (it == 0 && ik == 0)
      load_tile_async((is & 1) ? sa1 : sa0, lda, A, sa_m, sa_k, i0, ik0, bm, bk, m, k);
    T* dst = reinterpret_cast<T*>(sb + islot * b_bytes);
    const int kr = ik0 + ik * ks, c0 = (t0 + it) * tw;
    if (b_vec) {
      for (int idx = threadIdx.x; idx < (ks << lg); idx += kThreads) {
        const int r = idx >> lg, c = (idx & ((1 << lg) - 1)) * V;
        const int gr = kr + r, gc = c0 + c;
        const int valid = gr < k ? max(0, min(V, n - gc)) : 0;
        cp_async16(dst + r * ldb + c, valid ? B + (long long)gr * sb_k + gc : B,
                   valid * (int)sizeof(T));
      }
    } else {
      load_tile(dst, ldb, B, sb_k, sb_n, kr, c0, ks, tw, k, n);
    }
    islot ^= 1;
    if (++ik == nks) {
      ik = 0;
      if (++it == tnc) {
        it = 0;
        if (++is < cnt) ik0 = row[is] * bk;
      }
    }
  };

  Acc run[TN][MR];
  Acc part[MR];
  int cs = 0, ct = 0, ck = 0, cslot = 0;
  // q = -1 is the prologue: it issues step 0.  From q = 0 on, step q + 1
  // is issued after the barrier that retires step q - 1, whose slot (and,
  // at a block's first step, A buffer: blocks have at least one step) it
  // reuses.
  for (int q = -1; q < steps; ++q) {
    if (q >= 0) {
      cp_async_wait_all();
      __syncthreads();
    }
    if (q + 1 < steps) issue_next();
    if (q < 0) continue;
    if (ck == 0) {
#pragma unroll
      for (int r = 0; r < MR; ++r) acc_zero(part[r]);
    }
    if (nrf > 0)
      strip_mma<MR>(part, ((cs & 1) ? sa1 : sa0) + rb * lda + ck * ks, lda,
                    reinterpret_cast<const T*>(sb + cslot * b_bytes) + wc * 16, ldb, ks, nrf);
    if (ck == nks - 1) {
#pragma unroll
      for (int tt = 0; tt < TN; ++tt) {
        if (tt != ct) continue;
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            run[tt][r].x[x] = cs == 0 ? part[r].x[x] : run[tt][r].x[x] + part[r].x[x];
      }
    }
    cslot ^= 1;
    if (++ck == nks) {
      ck = 0;
      if (++ct == tnc) {
        ct = 0;
        ++cs;
      }
    }
  }
#pragma unroll
  for (int tt = 0; tt < TN; ++tt) {
    if (tt >= tnc) break;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nrf) break;
      store_acc(run[tt][r], out, i0 + rb + 16 * r, (t0 + tt) * tw + wc * 16, m, n, e);
    }
  }
}

template <typename T, typename O, int MR>
int launch_a_resident(const ARCfg& c, dim3 grid, const int* cols, const int* nnz, int s_max,
                      const T* a, long long sa_m, long long sa_k, const T* b, long long sb_k,
                      long long sb_n, O* o, int m, int k, int n, int bm, int bk, int per,
                      const Epi& e, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_a_resident_kernel<T, O, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  bsr_a_resident_kernel<T, O, MR><<<grid, kThreads, c.smem, stream>>>(
      cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k, n, bm, bk, per, c, e);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch(int schedule, const int* cols, const int* nnz, int s_max, const void* A,
           long long sa_m, long long sa_k, const void* B, long long sb_k, long long sb_n,
           void* out, int m, int k, int n, int bm, int bk, int bn, int chunks,
           const Epi& e, cudaStream_t stream) {
  const long long smem = tile_smem_bytes<T>(bm, bk, bn);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int gm = (m + bm - 1) / bm;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  O* o = static_cast<O*>(out);
  if (schedule == 1) {
    // `chunks` is the number of column tiles a CTA holds (the wrapper's
    // `a_resident_chunk`).
    const ARCfg c = ar_config<T>(bm, bk);
    if (c.smem < 0) return (int)cudaErrorInvalidValue;
    const int ntiles = (n + c.tw - 1) / c.tw;
    const int per = max(1, min(chunks, 8 / c.mr));
    dim3 grid(gm, (ntiles + per - 1) / per, 1);
    switch (c.mr) {
      case 1:
        return launch_a_resident<T, O, 1>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k,
                                          sb_n, o, m, k, n, bm, bk, per, e, stream);
      case 2:
        return launch_a_resident<T, O, 2>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k,
                                          sb_n, o, m, k, n, bm, bk, per, e, stream);
      case 4:
        return launch_a_resident<T, O, 4>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k,
                                          sb_n, o, m, k, n, bm, bk, per, e, stream);
      default:
        return launch_a_resident<T, O, 8>(c, grid, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k,
                                          sb_n, o, m, k, n, bm, bk, per, e, stream);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace rt

// schedule: 1 a_resident (0, k_inner, is rt_block_sparse_k_inner and 2,
// b_resident, rt_block_sparse_b_resident, each in its own library).  cols is a contiguous
// int32 (gm, s_max) table and nnz int32 (gm,), both on the device.  Strides
// are in elements; `out` is a contiguous (m, n) tensor; a_resident keeps
// its sums in registers and reads `chunks` as column tiles per CTA.
// Returns the cudaError_t of the launch.
extern "C" int rt_block_sparse_matmul(int schedule, int in_bf16, int out_bf16,
                                      const void* cols, const void* nnz, int s_max,
                                      const void* A, long long sa_m, long long sa_k,
                                      const void* B, long long sb_k, long long sb_n,
                                      void* out, int m, int k, int n, int bm, int bk,
                                      int bn, int chunks, float scale, int has_scale,
                                      const void* bias, int bias_bf16, int act, const void* res,
                                      int res_bf16, long long rs_m, long long rs_n,
                                      void* stream) {
  rt::Epi e{scale, has_scale, bias, bias_bf16, act, res, res_bf16, 0, rs_m, rs_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const int* z = static_cast<const int*>(nnz);
  if (in_bf16 && out_bf16)
    return rt::launch<rt::bf16, rt::bf16>(schedule, c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n,
                                          out, m, k, n, bm, bk, bn, chunks, e, s);
  if (in_bf16)
    return rt::launch<rt::bf16, float>(schedule, c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n, out,
                                       m, k, n, bm, bk, bn, chunks, e, s);
  if (out_bf16)
    return rt::launch<float, rt::bf16>(schedule, c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n, out,
                                       m, k, n, bm, bk, bn, chunks, e, s);
  return rt::launch<float, float>(schedule, c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n, out, m,
                                  k, n, bm, bk, bn, chunks, e, s);
}
