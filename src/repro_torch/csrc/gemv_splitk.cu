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
// card's ~295 FLOP/byte ridge — plus one fp32 write of the (gk, m, n) slab
// (pass 2 reads it once).  At the phi4 LM head (4 x 3072 x 200064, E^T in
// place, gk 24) that is 1.229 GB + 76.8 MB: 0.390 ms at 3.35 TB/s.
//
// Pass 1 is K1's k_inner kernel (csrc/k_inner.cuh) with the split walk
// (KiWalk::kSplit, a template flag): blockIdx = (row tile, column tile,
// split group).  A CTA walks the k range of its group's `sp` splits in
// ks-deep slices (ks divides bk) through k_inner's >= 3-stage cp.async ring
// of XOR-swizzled tiles, straight across split boundaries, so copies stay
// in flight; at each split's end each warp stores its register sums raw
// (fp32, no epilogue) to that split's plane of the slab and starts again
// from zero.  Rows follow k_inner's rule (8 at m <= 8: the MMA's other 8
// rows read a zero row, so only real rows are copied; m is never blocked),
// a transposed B (E^T in place) is copied n-major with the tile narrowed
// until a slice is 128 bytes deep, and the ring fits two CTAs an SM.  The
// (row, column) tiles fill the grid; where they leave part of a wave of two
// CTAs an SM idle (a narrow n), the splits are cut into groups over grid z
// until it fills (`sk_config`).  Each partial is one fp32 chain over its bk
// slice in 16-deep MMA steps, so plane s equals K1 k_inner on the slice
// pair A[:, s bk:(s + 1) bk] @ B[s bk:(s + 1) bk] bit for bit.
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
#include "k_inner.cuh"

namespace rt {

// K3's shape on the card (mirrored by `splitk_config` in
// kernels/gemv_splitk.py):
//   rows, mr — k_inner's rule: bf16 8 when m fits in 8, else the plan's bm,
//            at most 64, within the 16-row granules m fills (mr 4); fp32 16
//            (mr 1).  Split-K's bm >= m, so up to 64 rows one row tile
//            covers m;
//   tw     — the widest power-of-two multiple of 16 within bn and 128; a
//            transposed B narrows it until a slice is 128 bytes deep;
//   ks     — the deepest power of two up to 256 that divides bk (no slice
//            straddles two splits) and leaves room for >= 3 stages (at most
//            8) within two CTAs an SM (`kSkBudget`);
//   sp, gz — splits a CTA walks, and the split groups over grid z: the
//            most splits a group (so the fewest groups) with which the
//            grid still fills a wave of two CTAs an SM, one split a group
//            where none does.  At the LM head the 1563 column tiles alone
//            fill it: one group walks all 24 splits.
constexpr long long kSkBudget = (kSmemMax - 1024) / 2;

struct SKCfg {
  KICfg c;
  int sp, gz;
};

template <typename T>
inline SKCfg sk_config(int m, int k, int n, int bm, int bk, int bn, int bt, int sms) {
  SKCfg s{};
  KICfg& c = s.c;
  if (!kKiSwz<T>)
    c.rows = 16;
  else if (m <= 8)
    c.rows = 8;
  else
    c.rows = min(min(bm, 64), (m + 15) / 16 * 16);
  c.mr = c.rows <= 16 ? 1 : 4;
  c.bt = bt;
  int tw = 16;
  while (2 * tw <= bn && 2 * tw <= 128) tw *= 2;
  c.gm = (m + c.rows - 1) / c.rows;
  c.smem = -1;
  if (!ki_ring<T>(c, tw, bk, kSkBudget)) return s;
  while (bt && tw > 16 && c.ks * (int)sizeof(T) < 128) {
    tw /= 2;
    if (!ki_ring<T>(c, tw, bk, kSkBudget)) return s;
  }
  c.tw = tw;
  c.gn = (n + tw - 1) / tw;
  const int gk = (k + bk - 1) / bk;
  const long long tiles = (long long)c.gm * c.gn;
  s.sp = gk;
  while (s.sp > 1 && tiles * ((gk + s.sp - 1) / s.sp) < 2LL * sms) --s.sp;
  s.gz = (gk + s.sp - 1) / s.sp;
  return s;
}

template <typename T>
int launch_partial(const T* a, long long sa_m, long long sa_k, const T* b, long long sb_k,
                   long long sb_n, float* slab, int m, int k, int n, int bm, int bk, int bn,
                   int sms, cudaStream_t stream) {
  if (bm < m || tile_smem_bytes<T>(bm, bk, bn) > kSmemMax) return (int)cudaErrorInvalidValue;
  const int bt = sb_k == 1 && sb_n != 1;
  const SKCfg s = sk_config<T>(m, k, n, bm, bk, bn, bt, sms);
  if (s.c.smem < 0 || s.c.smem > kSmemMax || s.c.gn > 65535 || s.gz > 65535)
    return (int)cudaErrorInvalidValue;
  const KIWalkArgs w{0, 0, s.sp};
  if (s.c.mr == 1)
    return launch_k_inner<T, float, 1, 1, KiWalk::kSplit>(s.c, a, 0, sa_m, sa_k, b, sb_k, sb_n,
                                                          slab, 1, m, k, n, bk, Epi{}, nullptr,
                                                          nullptr, 0, 0, stream, s.gz, w);
  if constexpr (kKiSwz<T>)
    return launch_k_inner<T, float, 4, 1, KiWalk::kSplit>(s.c, a, 0, sa_m, sa_k, b, sb_k, sb_n,
                                                          slab, 1, m, k, n, bk, Epi{}, nullptr,
                                                          nullptr, 0, 0, stream, s.gz, w);
  return (int)cudaErrorInvalidValue;
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
// gk = ceil(k / bk); bm >= m; `sms` is the card's SM count (the wrapper's
// `splitk_config`).  Returns the cudaError_t of the launch.
extern "C" int rt_splitk_partial(int in_bf16, const void* A, long long sa_m, long long sa_k,
                                 const void* B, long long sb_k, long long sb_n, void* slab,
                                 int m, int k, int n, int bm, int bk, int bn, int sms,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(slab);
  if (in_bf16)
    return rt::launch_partial(static_cast<const rt::bf16*>(A), sa_m, sa_k,
                              static_cast<const rt::bf16*>(B), sb_k, sb_n, o, m, k, n, bm, bk,
                              bn, sms, s);
  return rt::launch_partial(static_cast<const float*>(A), sa_m, sa_k,
                            static_cast<const float*>(B), sb_k, sb_n, o, m, k, n, bm, bk, bn,
                            sms, s);
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
