// Dense schedule family of the planned matmul, hand-written for Hopper.
//
// Replaces: src/repro/kernels/skew_matmul.py::skew_matmul_padded
//   (bodies _k_inner_kernel, _resident_kernel) and
//   ::skew_matmul_batched_padded (the k_inner body with a batch grid dim).
//
//   C = act(scale * (A @ B) + bias) + residual, fp32 accumulation, the
//   epilogue at fp32, one cast to the output type.
//
// Bound on the H100: at the serving shapes every product is bound by
// device-memory bytes (decode: m of a few rows against the whole weight;
// prefill at m = 512 sits below the card's ~295 FLOP/byte ridge once the
// planner's 104 KB blocks re-stream A and B).  So the design spends its
// effort on bytes: 16-byte vector loads on the unit-stride axis, ragged
// edges masked in the kernel instead of padding the operands on every call
// (a 200064-wide weight is never copied), B read through its strides so a
// tied embedding is used as E^T in place, and rows past m skipped in the
// MMA so decode does not pay for a 64-row block it does not fill.  Tiles
// are single-buffered and the products use WMMA (tensor cores) for bf16;
// TMA, wgmma and a multi-stage pipeline are later work.
//
// Loop orders (the Pallas grid's sequential dims become loops in the CTA,
// its parallel dims become blockIdx):
//   k_inner    — blockIdx = (n-tile, m-tile, batch); k loop with the fp32
//                accumulator tile resident in shared memory.
//   a_resident — blockIdx = (n-chunk, m-tile).  For each k block the A tile
//                stays in shared memory while the CTA walks its run of
//                n-tiles.  The n sweep is split into chunks so the card has
//                enough CTAs when there is one m-tile (the LM head).  With
//                gk > 1 the partial sums accumulate through an fp32
//                workspace; one CTA owns its output tiles for every k, so
//                that accumulation is sequential in the CTA (no atomics).
//   b_resident — the mirror image: B tile resident, the CTA walks m-tiles.
#include "common.cuh"

namespace rt {

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
k_inner_kernel(const T* __restrict__ A, long long sa_b, long long sa_m, long long sa_k,
               const T* __restrict__ B, long long sb_k, long long sb_n,
               O* __restrict__ out, int m, int k, int n, int bm, int bk, int bn, Epi e) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const long long bz = blockIdx.z;
  const int i0 = blockIdx.y * bm, j0 = blockIdx.x * bn;
  const T* Ab = A + bz * sa_b;
  const int mrows = m - i0;
  for (int k0 = 0; k0 < k; k0 += bk) {
    __syncthreads();
    load_tile(t.a, t.lda, Ab, sa_m, sa_k, i0, k0, bm, bk, m, k);
    load_tile(t.b, t.ldb, B, sb_k, sb_n, k0, j0, bk, bn, k, n);
    __syncthreads();
    mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, mrows, k0 == 0);
  }
  __syncthreads();
  O* ob = out + bz * (long long)m * n;
  for (int idx = threadIdx.x; idx < bm * bn; idx += blockDim.x) {
    const int r = idx / bn, c = idx - r * bn;
    const int gr = i0 + r, gc = j0 + c;
    if (gr < m && gc < n)
      ob[(long long)gr * n + gc] = from_f<O>(apply_epi(t.c[r * t.ldc + c], e, bz, gr, gc));
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
a_resident_kernel(const T* __restrict__ A, long long sa_m, long long sa_k,
                  const T* __restrict__ B, long long sb_k, long long sb_n,
                  O* __restrict__ out, float* __restrict__ ws, int m, int k, int n,
                  int bm, int bk, int bn, int per_chunk, Epi e) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const int gn = (n + bn - 1) / bn, gk = (k + bk - 1) / bk;
  const int i0 = blockIdx.y * bm;
  const int jb = blockIdx.x * per_chunk;
  const int je = min(gn, jb + per_chunk);
  for (int kk = 0; kk < gk; ++kk) {
    __syncthreads();
    load_tile(t.a, t.lda, A, sa_m, sa_k, i0, kk * bk, bm, bk, m, k);
    for (int jt = jb; jt < je; ++jt) {
      __syncthreads();
      load_tile(t.b, t.ldb, B, sb_k, sb_n, kk * bk, jt * bn, bk, bn, k, n);
      __syncthreads();
      mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, m - i0, true);
      __syncthreads();
      combine(t.c, t.ldc, ws, out, kk, gk, i0, jt * bn, bm, bn, m, n, e);
    }
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
b_resident_kernel(const T* __restrict__ A, long long sa_m, long long sa_k,
                  const T* __restrict__ B, long long sb_k, long long sb_n,
                  O* __restrict__ out, float* __restrict__ ws, int m, int k, int n,
                  int bm, int bk, int bn, int per_chunk, Epi e) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const int gm = (m + bm - 1) / bm, gk = (k + bk - 1) / bk;
  const int j0 = blockIdx.y * bn;
  const int ib = blockIdx.x * per_chunk;
  const int ie = min(gm, ib + per_chunk);
  for (int kk = 0; kk < gk; ++kk) {
    __syncthreads();
    load_tile(t.b, t.ldb, B, sb_k, sb_n, kk * bk, j0, bk, bn, k, n);
    for (int it = ib; it < ie; ++it) {
      __syncthreads();
      load_tile(t.a, t.lda, A, sa_m, sa_k, it * bm, kk * bk, bm, bk, m, k);
      __syncthreads();
      mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, m - it * bm, true);
      __syncthreads();
      combine(t.c, t.ldc, ws, out, kk, gk, it * bm, j0, bm, bn, m, n, e);
    }
  }
}

template <typename T, typename O>
int launch(int schedule, const void* A, long long sa_b, long long sa_m, long long sa_k,
           const void* B, long long sb_k, long long sb_n, void* out, void* ws, int nb,
           int m, int k, int n, int bm, int bk, int bn, int chunks, const Epi& e,
           cudaStream_t stream) {
  const long long smem = tile_smem_bytes<T>(bm, bk, bn);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int gm = (m + bm - 1) / bm, gn = (n + bn - 1) / bn;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  O* o = static_cast<O*>(out);
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  if (schedule == 0) {
    err = cudaFuncSetAttribute(k_inner_kernel<T, O>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(gn, gm, nb);
    k_inner_kernel<T, O><<<grid, kThreads, smem, stream>>>(
        a, sa_b, sa_m, sa_k, b, sb_k, sb_n, o, m, k, n, bm, bk, bn, e);
  } else if (schedule == 1) {
    err = cudaFuncSetAttribute(a_resident_kernel<T, O>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per = (gn + chunks - 1) / chunks;
    dim3 grid((gn + per - 1) / per, gm, 1);
    a_resident_kernel<T, O><<<grid, kThreads, smem, stream>>>(
        a, sa_m, sa_k, b, sb_k, sb_n, o, w, m, k, n, bm, bk, bn, per, e);
  } else if (schedule == 2) {
    err = cudaFuncSetAttribute(b_resident_kernel<T, O>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per = (gm + chunks - 1) / chunks;
    dim3 grid((gm + per - 1) / per, gn, 1);
    b_resident_kernel<T, O><<<grid, kThreads, smem, stream>>>(
        a, sa_m, sa_k, b, sb_k, sb_n, o, w, m, k, n, bm, bk, bn, per, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace rt

// schedule: 0 k_inner (nb >= 1 runs the batched grid), 1 a_resident,
// 2 b_resident.  Strides are in elements; `out` is a contiguous (nb, m, n)
// tensor; `ws` an fp32 (m, n) workspace for the resident schedules with
// more than one k block (else null).  Returns the cudaError_t of the launch.
extern "C" int rt_skew_matmul(int schedule, int in_bf16, int out_bf16, const void* A,
                              long long sa_b, long long sa_m, long long sa_k,
                              const void* B, long long sb_k, long long sb_n, void* out,
                              void* ws, int nb, int m, int k, int n, int bm, int bk, int bn,
                              int chunks, float scale, int has_scale, const void* bias,
                              int bias_bf16, int act, const void* res, int res_bf16,
                              long long rs_b, long long rs_m, long long rs_n, void* stream) {
  rt::Epi e{scale, has_scale, bias, bias_bf16, act, res, res_bf16, rs_b, rs_m, rs_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return rt::launch<rt::bf16, rt::bf16>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out,
                                          ws, nb, m, k, n, bm, bk, bn, chunks, e, s);
  if (in_bf16)
    return rt::launch<rt::bf16, float>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, ws,
                                       nb, m, k, n, bm, bk, bn, chunks, e, s);
  if (out_bf16)
    return rt::launch<float, rt::bf16>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, ws,
                                       nb, m, k, n, bm, bk, bn, chunks, e, s);
  return rt::launch<float, float>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, ws, nb,
                                  m, k, n, bm, bk, bn, chunks, e, s);
}
