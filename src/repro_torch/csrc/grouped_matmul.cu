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
// call reads every group's B.  At the dbrx-132b decode shape (16 groups,
// m = 8 capacity rows, 6144 x 10752 per expert, bf16) B alone is 2.11 GB:
// 2.11 GB / 3.35 TB/s ~ 0.63 ms, against 2.8 GFLOP (~3 us of tensor-core
// time).  At prefill (m = 160) it is still bytes first: 0.63 ms of bytes
// against 338 GFLOP / 989 TFLOP/s = 0.34 ms.  So the design spends its
// effort on bytes, as K1 does:
//   - each expert's B is read through its strides, never padded or copied
//     (the JAX wrapper pads k and n to 128 on every call: 2.1 GB copied
//     per GEMM on the card);
//   - ragged m, k and n are masked in the kernel (zero-filled tiles, the
//     store guarded), so `ops` never pads;
//   - rows past m are skipped in the MMA, so m = 8 capacity rows in a
//     64-row block pay for 16 rows of tensor-core work, not 64;
//   - 16-byte vector loads on the unit-stride axis; grid = (n-tile,
//     m-tile, group), 1344 CTAs at the decode shape, so every SM has
//     several CTAs in flight.
// Tiles are single-buffered and bf16 products use WMMA (tensor cores); fp32
// operands run the plain FMA loop, true IEEE fp32, never TF32.  TMA, wgmma
// and a multi-stage pipeline are later work.
//
// Grid: blockIdx = (n-tile, m-tile, group).  The Pallas grid's sequential
// k dim is the loop inside the CTA, with the fp32 accumulator tile resident
// in shared memory; the epilogue runs once after the last k block.
#include "common.cuh"

namespace rt {

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const T* __restrict__ A, long long sa_g, long long sa_m, long long sa_k,
               const T* __restrict__ B, long long sb_g, long long sb_k, long long sb_n,
               O* __restrict__ out, long long so_g, long long so_m, int m, int k, int n,
               int bm, int bk, int bn, Epi e) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const long long g = blockIdx.z;
  const int i0 = blockIdx.y * bm, j0 = blockIdx.x * bn;
  const T* Ag = A + g * sa_g;
  const T* Bg = B + g * sb_g;
  const int mrows = m - i0;
  for (int k0 = 0; k0 < k; k0 += bk) {
    __syncthreads();
    load_tile(t.a, t.lda, Ag, sa_m, sa_k, i0, k0, bm, bk, m, k);
    load_tile(t.b, t.ldb, Bg, sb_k, sb_n, k0, j0, bk, bn, k, n);
    __syncthreads();
    mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, mrows, k0 == 0);
  }
  __syncthreads();
  O* og = out + g * so_g;
  for (int idx = threadIdx.x; idx < bm * bn; idx += blockDim.x) {
    const int r = idx / bn, c = idx - r * bn;
    const int gr = i0 + r, gc = j0 + c;
    if (gr < m && gc < n)
      og[(long long)gr * so_m + gc] = from_f<O>(apply_epi(t.c[r * t.ldc + c], e, g, gr, gc));
  }
}

template <typename T, typename O>
int launch_grouped(const void* A, long long sa_g, long long sa_m, long long sa_k,
                   const void* B, long long sb_g, long long sb_k, long long sb_n, void* out,
                   long long so_g, long long so_m, int groups, int m, int k, int n, int bm,
                   int bk, int bn, const Epi& e, cudaStream_t stream) {
  const long long smem = tile_smem_bytes<T>(bm, bk, bn);
  if (smem > kSmemMax || groups > 65535) return (int)cudaErrorInvalidValue;
  const int gm = (m + bm - 1) / bm, gn = (n + bn - 1) / bn;
  if (gm > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(gn, gm, groups);
  grouped_kernel<T, O><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(A), sa_g, sa_m, sa_k, static_cast<const T*>(B), sb_g, sb_k, sb_n,
      static_cast<O*>(out), so_g, so_m, m, k, n, bm, bk, bn, e);
  return (int)cudaGetLastError();
}

}  // namespace rt

// A (groups, m, k) and B (groups, k, n) are read through their strides (in
// elements); `out` has group stride so_g, row stride so_m and unit column
// stride.  act: 0 none, 1 gelu (tanh approximation), 2 silu.  The residual,
// when given, is read as res[g * rs_g + r * rs_m + c * rs_n].  Returns the
// cudaError_t of the launch.
extern "C" int rt_grouped_matmul(int in_bf16, int out_bf16, const void* A, long long sa_g,
                                 long long sa_m, long long sa_k, const void* B, long long sb_g,
                                 long long sb_k, long long sb_n, void* out, long long so_g,
                                 long long so_m, int groups, int m, int k, int n, int bm, int bk,
                                 int bn, float scale, int has_scale, int act, const void* res,
                                 int res_bf16, long long rs_g, long long rs_m, long long rs_n,
                                 void* stream) {
  rt::Epi e{scale, has_scale, nullptr, 0, act, res, res_bf16, rs_g, rs_m, rs_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return rt::launch_grouped<rt::bf16, rt::bf16>(A, sa_g, sa_m, sa_k, B, sb_g, sb_k, sb_n, out,
                                                  so_g, so_m, groups, m, k, n, bm, bk, bn, e, s);
  if (in_bf16)
    return rt::launch_grouped<rt::bf16, float>(A, sa_g, sa_m, sa_k, B, sb_g, sb_k, sb_n, out,
                                               so_g, so_m, groups, m, k, n, bm, bk, bn, e, s);
  if (out_bf16)
    return rt::launch_grouped<float, rt::bf16>(A, sa_g, sa_m, sa_k, B, sb_g, sb_k, sb_n, out,
                                               so_g, so_m, groups, m, k, n, bm, bk, bn, e, s);
  return rt::launch_grouped<float, float>(A, sa_g, sa_m, sa_k, B, sb_g, sb_k, sb_n, out, so_g,
                                          so_m, groups, m, k, n, bm, bk, bn, e, s);
}
