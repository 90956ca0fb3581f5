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
// slab.  Pass 1 keeps B's read coalesced (16-byte loads on its unit-stride
// axis, strided views read in place), spreads K over the grid so a narrow
// n still fills the card, and skips the MMA for padded rows.
//
// Pass 2 (splitk_reduce_kernel) is a pure stream: gk*m*n fp32 in, m*n
// out.  Each CTA stages a strip of W flat output elements of every split
// (gk x W fp32) in shared memory with 16-byte cp.async copies (all in
// flight at once), so the slab is read from device memory exactly once
// and coalesced; then thread c folds column c of the strip level by level
// in place — v[i] += v[i + h] for i < h, an odd tail carried — with no
// barrier (a thread touches only its own column), no recursion and no
// local-memory array, applies the epilogue once and writes once.  W is
// the largest multiple of 4 up to 256 with gk * W * 4 bytes within the
// 227 KB a block may use (`reduce_strip`): W >= 32 up to gk = 1816, W >= 4
// up to gk = 14528.  Above that the host first folds whole levels of the
// slab through an fp32 scratch in device memory (splitk_fold_level_kernel,
// the same pairwise order) until one strip of 4 fits.
//
// Determinism: pass 2 folds the partials in exactly the order of the JAX
// package's `tree_sum` — halves added pairwise, an odd tail carried
// unchanged to the next level — so with no epilogue its output equals the
// plain `tree_sum` bit for bit for any fp32 slab, and for integer-valued
// inputs the output is bitwise identical across split counts.
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

// Strip width of the staged reduce: the largest multiple of 4 up to 256
// with gk * W * 4 bytes of shared memory within kSmemMax; 0 above gk =
// 14528 (mirrored by `reduce_strip` in kernels/gemv_splitk.py).
constexpr int kReduceMaxW = 256;
__host__ __device__ inline int reduce_strip(int gk) {
  long long w = (long long)kSmemMax / (4LL * gk);
  if (w > kReduceMaxW) w = kReduceMaxW;
  return (int)(w / 4 * 4);
}

// One level of tree_sum over whole (len, mn) fp32 planes: dst[i] = src[i]
// + src[i + h] for i < h = len / 2, dst[h] = src[2h] when len is odd.  One
// thread owns one element across the planes and walks i upwards, so dst
// may alias src (row i is written only after rows i and i + h were read,
// and no later read touches a row below h).
__global__ void __launch_bounds__(kThreads)
splitk_fold_level_kernel(const float* src, float* dst, int len, long long mn) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  const int h = len / 2;
  for (int i = 0; i < h; ++i)
    dst[i * mn + idx] = src[i * mn + idx] + src[(i + h) * mn + idx];
  if (len & 1) dst[h * mn + idx] = src[2LL * h * mn + idx];
}

template <typename O>
__global__ void __launch_bounds__(kThreads)
splitk_reduce_kernel(const float* __restrict__ slab, O* __restrict__ out, int gk,
                     long long mn, int n, int W, int vec, Epi e) {
  extern __shared__ __align__(16) float sv[];  // gk x W
  const long long e0 = (long long)blockIdx.x * W;
  const int w = (int)min((long long)W, mn - e0);
  if (vec) {
    const int wv = W / 4;
    for (int q = threadIdx.x; q < gk * wv; q += blockDim.x) {
      const int g = q / wv, c = (q - g * wv) * 4;
      const int valid = max(0, min(4, w - c));
      const float* src = valid ? slab + g * mn + e0 + c : slab;
      cp_async16(sv + g * W + c, src, valid * 4);
    }
    cp_async_wait_all();
  } else {
    for (int q = threadIdx.x; q < gk * W; q += blockDim.x) {
      const int g = q / W, c = q - g * W;
      if (c < w) sv[q] = slab[g * mn + e0 + c];
    }
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= w) return;
  float* v = sv + c;
  for (int len = gk; len > 1;) {
    const int h = len >> 1;
    for (int i = 0; i < h; ++i) v[i * W] = v[i * W] + v[(i + h) * W];
    if (len & 1) v[h * W] = v[2 * h * W];
    len = h + (len & 1);
  }
  const long long idx = e0 + c;
  const long long r = idx / n, col = idx - r * n;
  out[idx] = from_f<O>(apply_epi(v[0], e, 0, r, col));
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

// Pass 2.  `out` is a contiguous (m, n) tensor.  `scratch` is an fp32
// ((gk + 1) / 2, m, n) tensor when reduce_strip(gk) == 0, else null.
extern "C" int rt_splitk_reduce(int out_bf16, const void* slab, void* out, void* scratch,
                                int gk, int m, int n, float scale, int has_scale,
                                const void* bias, int bias_bf16, int act, const void* res,
                                int res_bf16, long long rs_m, long long rs_n, void* stream) {
  rt::Epi e{scale, has_scale, bias, bias_bf16, act, res, res_bf16, 0, rs_m, rs_n};
  const long long mn = (long long)m * n;
  if (mn == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(slab);
  int len = gk;
  if (rt::reduce_strip(len) == 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    float* w = static_cast<float*>(scratch);
    const unsigned blocks = (unsigned)((mn + rt::kThreads - 1) / rt::kThreads);
    while (rt::reduce_strip(len) == 0) {
      rt::splitk_fold_level_kernel<<<blocks, rt::kThreads, 0, s>>>(p, w, len, mn);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      p = w;
      len = len / 2 + len % 2;
    }
  }
  const int W = rt::reduce_strip(len);
  const long long smem = (long long)len * W * 4;
  const int vec = mn % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  const unsigned blocks = (unsigned)((mn + W - 1) / W);
  cudaError_t err;
  if (out_bf16) {
    err = cudaFuncSetAttribute(rt::splitk_reduce_kernel<rt::bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rt::splitk_reduce_kernel<rt::bf16><<<blocks, rt::kThreads, smem, s>>>(
        p, static_cast<rt::bf16*>(out), len, mn, n, W, vec, e);
  } else {
    err = cudaFuncSetAttribute(rt::splitk_reduce_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rt::splitk_reduce_kernel<float><<<blocks, rt::kThreads, smem, s>>>(
        p, static_cast<float*>(out), len, mn, n, W, vec, e);
  }
  return (int)cudaGetLastError();
}
