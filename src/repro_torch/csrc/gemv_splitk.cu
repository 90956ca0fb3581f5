// Split-K GEMV family for the decode regime, hand-written for Hopper.
//
// Replaces: src/repro/kernels/gemv_splitk.py::gemv_splitk_padded
//   pass 1 — _partial_kernel: fp32 partial products into a (gk, m, n) slab
//            over a (k_splits, n-tiles) grid; the whole m rides in every
//            block (m is never blocked);
//   pass 2 — _reduce_kernel + tree_sum: the static pairwise fold of the gk
//            partials, then the epilogue once and one cast.
//
// Bound on the H100: bytes.  At decode m is a handful of rows, so pass 1
// streams B once (k x n weights) for 2*m*k*n operations — far below the
// card's ~295 FLOP/byte ridge — plus one fp32 write and one read of the
// slab.  The design keeps B's read coalesced (16-byte loads on its
// unit-stride axis, strided views read in place), spreads K over the grid
// so a narrow n still fills the card, skips the MMA for padded rows, and
// the reduce streams the slab from device memory (one coalesced read per
// split per output element) rather than staging it in shared memory.
//
// Determinism: pass 2 folds the partials in exactly the order of the JAX
// package's `tree_sum` — halves added pairwise, an odd tail carried
// unchanged to the next level — so for integer-valued inputs the output is
// bitwise identical across split counts.
#include "common.cuh"

namespace rt {

template <typename T>
__global__ void __launch_bounds__(kThreads)
splitk_partial_kernel(const T* __restrict__ A, long long sa_m, long long sa_k,
                      const T* __restrict__ B, long long sb_k, long long sb_n,
                      float* __restrict__ slab, int m, int k, int n, int bm, int bk, int bn) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const int j0 = blockIdx.x * bn, k0 = blockIdx.y * bk;
  load_tile(t.a, t.lda, A, sa_m, sa_k, 0, k0, bm, bk, m, k);
  load_tile(t.b, t.ldb, B, sb_k, sb_n, k0, j0, bk, bn, k, n);
  __syncthreads();
  mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, m, true);
  __syncthreads();
  float* dst = slab + (long long)blockIdx.y * m * n;
  for (int idx = threadIdx.x; idx < bm * bn; idx += blockDim.x) {
    const int r = idx / bn, c = idx - r * bn;
    const int gc = j0 + c;
    if (r < m && gc < n) dst[(long long)r * n + gc] = t.c[r * t.ldc + c];
  }
}

// Value at index i of fold level `level` of the tree (level 0 = the raw
// partials, stride `st` apart).  lens[l] is the length at level l.
__device__ float tree_at(const float* p, long long st, const int* lens, int level, int i) {
  if (level == 0) return p[i * st];
  const int h = lens[level - 1] / 2;
  if (i < h)
    return tree_at(p, st, lens, level - 1, i) + tree_at(p, st, lens, level - 1, i + h);
  return tree_at(p, st, lens, level - 1, 2 * h);
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
splitk_reduce_kernel(const float* __restrict__ slab, O* __restrict__ out, int gk, int m,
                     int n, Epi e) {
  const long long mn = (long long)m * n;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  int lens[32];
  int depth = 0;
  lens[0] = gk;
  while (lens[depth] > 1) {
    lens[depth + 1] = lens[depth] / 2 + lens[depth] % 2;
    ++depth;
  }
  const float z = tree_at(slab + idx, mn, lens, depth, 0);
  const long long r = idx / n, c = idx - r * n;
  out[idx] = from_f<O>(apply_epi(z, e, 0, r, c));
}

}  // namespace rt

// Pass 1.  `slab` is a contiguous fp32 (gk, m, n) tensor with
// gk = ceil(k / bk); bm = m rounded up to a multiple of 16.
extern "C" int rt_splitk_partial(int in_bf16, const void* A, long long sa_m, long long sa_k,
                                 const void* B, long long sb_k, long long sb_n, void* slab,
                                 int m, int k, int n, int bm, int bk, int bn, void* stream) {
  const long long smem = in_bf16 ? rt::tile_smem_bytes<rt::bf16>(bm, bk, bn)
                                 : rt::tile_smem_bytes<float>(bm, bk, bn);
  if (smem > rt::kSmemMax) return (int)cudaErrorInvalidValue;
  dim3 grid((n + bn - 1) / bn, (k + bk - 1) / bk, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    err = cudaFuncSetAttribute(rt::splitk_partial_kernel<rt::bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rt::splitk_partial_kernel<rt::bf16><<<grid, rt::kThreads, smem, s>>>(
        static_cast<const rt::bf16*>(A), sa_m, sa_k, static_cast<const rt::bf16*>(B), sb_k,
        sb_n, static_cast<float*>(slab), m, k, n, bm, bk, bn);
  } else {
    err = cudaFuncSetAttribute(rt::splitk_partial_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rt::splitk_partial_kernel<float><<<grid, rt::kThreads, smem, s>>>(
        static_cast<const float*>(A), sa_m, sa_k, static_cast<const float*>(B), sb_k, sb_n,
        static_cast<float*>(slab), m, k, n, bm, bk, bn);
  }
  return (int)cudaGetLastError();
}

// Pass 2.  `out` is a contiguous (m, n) tensor.
extern "C" int rt_splitk_reduce(int out_bf16, const void* slab, void* out, int gk, int m,
                                int n, float scale, int has_scale, const void* bias,
                                int bias_bf16, int act, const void* res, int res_bf16,
                                long long rs_m, long long rs_n, void* stream) {
  rt::Epi e{scale, has_scale, bias, bias_bf16, act, res, res_bf16, 0, rs_m, rs_n};
  const long long mn = (long long)m * n;
  const unsigned blocks = (unsigned)((mn + rt::kThreads - 1) / rt::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(slab);
  if (out_bf16)
    rt::splitk_reduce_kernel<rt::bf16><<<blocks, rt::kThreads, 0, s>>>(
        p, static_cast<rt::bf16*>(out), gk, m, n, e);
  else
    rt::splitk_reduce_kernel<float><<<blocks, rt::kThreads, 0, s>>>(
        p, static_cast<float*>(out), gk, m, n, e);
  return (int)cudaGetLastError();
}
