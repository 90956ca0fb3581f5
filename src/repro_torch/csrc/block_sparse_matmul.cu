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
// output rows, as epilogue(0) (bias and residual).
//   k_inner    — blockIdx = (n-tile, row block); the fp32 accumulator tile,
//                zeroed explicitly, stays in shared memory across the s loop
//                and the epilogue is applied once.
//   a_resident — blockIdx = (n-chunk, row block).  For each nonzero block
//                the A tile stays in shared memory while the CTA walks the
//                n-tiles of its chunk; partial sums go through an fp32
//                workspace (the `combine` fold shared with K1), one CTA
//                owning its output tiles for every s, so no atomics.
//   b_resident — blockIdx = (m-chunk, n-tile), for parity with the JAX
//                schedule family (its planner never picks it).  The CTA
//                walks s, and for each s its rows; the B tile is reloaded
//                only when the column block changes, so it stays resident
//                exactly when the rows share their structure.
//
// Density-1.0 parity: the device code is K1's (load_tile, mma_block,
// combine, apply_epi from common.cuh) and at density 1.0 cols[i, s] == s
// and nnz[i] == gk, so every element sees the same products summed in the
// same order: the output is bitwise equal to K1's at the same blocks and
// schedule.
//
// Bound on the H100: the work is 2 * nnz_elems * n operations and the
// bytes are the nonzero A blocks once, B once and C once.  At the tuner's
// 4096^2 (32, 128) layouts with n = 4096 the products run at a few hundred
// operations per byte, above the card's ~295 FLOP/byte ridge, so the bound
// is the tensor-core rate; in practice this first kernel is bound by what
// K1 is bound by (single-buffered tiles, WMMA from shared memory, one CTA
// walking its blocks one after another) plus the gather: each CTA re-reads
// its B tiles, which L2 (50 MB) absorbs for a 32 MB bf16 B.  Blocks come
// from the layout, not the planner, so the wrapper takes any (bm, bk) that
// K1's shared-memory rule allows; (128, 128, 64), the planner's fail-over
// plan at (128, 128) layouts, needs 86 KB (bf16) / 134 KB (fp32) of
// dynamic shared memory, above the 104 KB AMP budget but under the 227 KB
// a block may use.  TMA, wgmma and a multi-stage pipeline are later work.
#include "common.cuh"

namespace rt {

// Write epilogue(0) over the output tile at (i0, j0): a row block that
// holds no nonzero block.
template <typename O>
__device__ void write_empty(O* out, int i0, int j0, int bm, int bn, int m, int n,
                            const Epi& e) {
  for (int idx = threadIdx.x; idx < bm * bn; idx += blockDim.x) {
    const int r = idx / bn, c = idx - r * bn;
    const int gr = i0 + r, gc = j0 + c;
    if (gr < m && gc < n) out[(long long)gr * n + gc] = from_f<O>(apply_epi(0.0f, e, 0, gr, gc));
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
bsr_k_inner_kernel(const int* __restrict__ cols, const int* __restrict__ nnz, int s_max,
                   const T* __restrict__ A, long long sa_m, long long sa_k,
                   const T* __restrict__ B, long long sb_k, long long sb_n,
                   O* __restrict__ out, int m, int k, int n, int bm, int bk, int bn, Epi e) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const int i = blockIdx.y;
  const int i0 = i * bm, j0 = blockIdx.x * bn;
  const int cnt = nnz[i];
  const int* row = cols + (long long)i * s_max;
  for (int idx = threadIdx.x; idx < bm * t.ldc; idx += blockDim.x) t.c[idx] = 0.0f;
  for (int s = 0; s < cnt; ++s) {
    const int k0 = row[s] * bk;
    __syncthreads();
    load_tile(t.a, t.lda, A, sa_m, sa_k, i0, k0, bm, bk, m, k);
    load_tile(t.b, t.ldb, B, sb_k, sb_n, k0, j0, bk, bn, k, n);
    __syncthreads();
    mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, m - i0, false);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < bm * bn; idx += blockDim.x) {
    const int r = idx / bn, c = idx - r * bn;
    const int gr = i0 + r, gc = j0 + c;
    if (gr < m && gc < n)
      out[(long long)gr * n + gc] = from_f<O>(apply_epi(t.c[r * t.ldc + c], e, 0, gr, gc));
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
bsr_a_resident_kernel(const int* __restrict__ cols, const int* __restrict__ nnz, int s_max,
                      const T* __restrict__ A, long long sa_m, long long sa_k,
                      const T* __restrict__ B, long long sb_k, long long sb_n,
                      O* __restrict__ out, float* __restrict__ ws, int m, int k, int n,
                      int bm, int bk, int bn, int per_chunk, Epi e) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const int gn = (n + bn - 1) / bn;
  const int i = blockIdx.y;
  const int i0 = i * bm;
  const int jb = blockIdx.x * per_chunk;
  const int je = min(gn, jb + per_chunk);
  const int cnt = nnz[i];
  const int* row = cols + (long long)i * s_max;
  if (cnt == 0) {
    for (int jt = jb; jt < je; ++jt) write_empty(out, i0, jt * bn, bm, bn, m, n, e);
    return;
  }
  for (int s = 0; s < cnt; ++s) {
    const int k0 = row[s] * bk;
    __syncthreads();
    load_tile(t.a, t.lda, A, sa_m, sa_k, i0, k0, bm, bk, m, k);
    for (int jt = jb; jt < je; ++jt) {
      __syncthreads();
      load_tile(t.b, t.ldb, B, sb_k, sb_n, k0, jt * bn, bk, bn, k, n);
      __syncthreads();
      mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, m - i0, true);
      __syncthreads();
      combine(t.c, t.ldc, ws, out, s, cnt, i0, jt * bn, bm, bn, m, n, e);
    }
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
bsr_b_resident_kernel(const int* __restrict__ cols, const int* __restrict__ nnz, int s_max,
                      const T* __restrict__ A, long long sa_m, long long sa_k,
                      const T* __restrict__ B, long long sb_k, long long sb_n,
                      O* __restrict__ out, float* __restrict__ ws, int m, int k, int n,
                      int bm, int bk, int bn, int per_chunk, Epi e) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const int gm = (m + bm - 1) / bm;
  const int j0 = blockIdx.y * bn;
  const int ib = blockIdx.x * per_chunk;
  const int ie = min(gm, ib + per_chunk);
  int steps = 0;
  for (int it = ib; it < ie; ++it) {
    const int cnt = nnz[it];
    if (cnt == 0) write_empty(out, it * bm, j0, bm, bn, m, n, e);
    steps = max(steps, cnt);
  }
  int loaded = -1;  // the column block whose B tile sits in shared memory
  for (int s = 0; s < steps; ++s) {
    for (int it = ib; it < ie; ++it) {
      const int cnt = nnz[it];
      if (s >= cnt) continue;
      const int cb = cols[(long long)it * s_max + s];
      __syncthreads();
      if (cb != loaded) {
        load_tile(t.b, t.ldb, B, sb_k, sb_n, cb * bk, j0, bk, bn, k, n);
        loaded = cb;
      }
      load_tile(t.a, t.lda, A, sa_m, sa_k, it * bm, cb * bk, bm, bk, m, k);
      __syncthreads();
      mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, m - it * bm, true);
      __syncthreads();
      combine(t.c, t.ldc, ws, out, s, cnt, it * bm, j0, bm, bn, m, n, e);
    }
  }
}

template <typename T, typename O>
int launch(int schedule, const int* cols, const int* nnz, int s_max, const void* A,
           long long sa_m, long long sa_k, const void* B, long long sb_k, long long sb_n,
           void* out, void* ws, int m, int k, int n, int bm, int bk, int bn, int chunks,
           const Epi& e, cudaStream_t stream) {
  const long long smem = tile_smem_bytes<T>(bm, bk, bn);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int gm = (m + bm - 1) / bm, gn = (n + bn - 1) / bn;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  O* o = static_cast<O*>(out);
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  if (schedule == 0) {
    err = cudaFuncSetAttribute(bsr_k_inner_kernel<T, O>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(gn, gm, 1);
    bsr_k_inner_kernel<T, O><<<grid, kThreads, smem, stream>>>(
        cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k, n, bm, bk, bn, e);
  } else if (schedule == 1) {
    err = cudaFuncSetAttribute(bsr_a_resident_kernel<T, O>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per = (gn + chunks - 1) / chunks;
    dim3 grid((gn + per - 1) / per, gm, 1);
    bsr_a_resident_kernel<T, O><<<grid, kThreads, smem, stream>>>(
        cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, w, m, k, n, bm, bk, bn, per, e);
  } else if (schedule == 2) {
    err = cudaFuncSetAttribute(bsr_b_resident_kernel<T, O>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per = (gm + chunks - 1) / chunks;
    dim3 grid((gm + per - 1) / per, gn, 1);
    bsr_b_resident_kernel<T, O><<<grid, kThreads, smem, stream>>>(
        cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, w, m, k, n, bm, bk, bn, per, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace rt

// schedule: 0 k_inner, 1 a_resident, 2 b_resident.  cols is a contiguous
// int32 (gm, s_max) table and nnz int32 (gm,), both on the device.  Strides
// are in elements; `out` is a contiguous (m, n) tensor; `ws` an fp32 (m, n)
// workspace for the resident schedules when s_max > 1 (else null).
// Returns the cudaError_t of the launch.
extern "C" int rt_block_sparse_matmul(int schedule, int in_bf16, int out_bf16,
                                      const void* cols, const void* nnz, int s_max,
                                      const void* A, long long sa_m, long long sa_k,
                                      const void* B, long long sb_k, long long sb_n,
                                      void* out, void* ws, int m, int k, int n, int bm, int bk,
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
                                          out, ws, m, k, n, bm, bk, bn, chunks, e, s);
  if (in_bf16)
    return rt::launch<rt::bf16, float>(schedule, c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n, out,
                                       ws, m, k, n, bm, bk, bn, chunks, e, s);
  if (out_bf16)
    return rt::launch<float, rt::bf16>(schedule, c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n, out,
                                       ws, m, k, n, bm, bk, bn, chunks, e, s);
  return rt::launch<float, float>(schedule, c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n, out, ws,
                                  m, k, n, bm, bk, bn, chunks, e, s);
}
