// Shared device code for the port's Hopper kernels (sm_90a).
//
// Products: bf16 operands go through tensor-core MMA (`strip_mma` and the
// k_inner / b_resident / flash-attention kernels issue m16n8k16 HMMAs
// through ldmatrix + mma.sync with register-resident sums); fp32 operands
// run a plain fp32 FMA chain — true IEEE fp32, never TF32.  The matmul
// kernels (K1-K3, K5, K9; k_inner's device code is shared in k_inner.cuh,
// b_resident's in b_resident.cuh) and K7's bf16 route stream their
// operands through `cp.async` rings; K7's fp32 route keeps its fp32 tiles
// in shared memory (`mma_block`, `load_tile`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;   // per-block shared memory on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row pad in elements: 16 bytes, keeps padded rows 16-byte aligned for
// vector copies.
template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / (int)sizeof(T);
}

__host__ __device__ inline long long align128(long long b) {
  return (b + 127) / 128 * 128;
}

// Shared-memory bytes of one plan block's (bm, bk, bn) tile set, A, B and
// an fp32 C (the cost model's working set): the limit on the blocks the
// matmul kernels take, and K1 k_inner's ring budget.
template <typename T>
__host__ __device__ inline long long tile_smem_bytes(int bm, int bk, int bn) {
  return align128((long long)bm * (bk + pad<T>()) * sizeof(T)) +
         align128((long long)bk * (bn + pad<T>()) * sizeof(T)) +
         align128((long long)bm * (bn + 4) * sizeof(float));
}

// The fused epilogue, in the order of the Python op table:
//   out = act(scale * z + bias) + residual      (fp32, one cast after)
struct Epi {
  float scale;
  int has_scale;
  const void* bias;       // (n,) or null
  int bias_bf16;
  int act;                // 0 none, 1 gelu (tanh approximation), 2 silu
  const void* res;        // strided residual or null
  int res_bf16;
  long long rs_b, rs_m, rs_n;
};

__device__ __forceinline__ float ld_any(const void* p, long long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float apply_epi(float z, const Epi& e, long long b,
                                           long long r, long long c) {
  if (e.has_scale) z = z * e.scale;
  if (e.bias) z = z + ld_any(e.bias, c, e.bias_bf16);
  if (e.act == 1) {
    const float u = 0.7978845608028654f * (z + 0.044715f * (z * z * z));
    z = 0.5f * z * (1.0f + tanhf(u));
  } else if (e.act == 2) {
    z = z / (1.0f + expf(-z));
  }
  if (e.res) z = z + ld_any(e.res, b * e.rs_b + r * e.rs_m + c * e.rs_n, e.res_bf16);
  return z;
}

// Copy the (R x C) tile at (r0, c0) of a strided (nr x nc) matrix into
// shared memory (row-major, leading dim ld), zero-filling past the edge.
// The unit-stride axis is walked by neighbouring threads with 16-byte
// loads, so a transposed view (e.g. a tied embedding read as B = E^T) is
// read as coalesced as a row-major one.
template <typename T>
__device__ void load_tile(T* s, int ld, const T* g, long long s_r, long long s_c,
                          int r0, int c0, int R, int C, int nr, int nc) {
  constexpr int V = 16 / (int)sizeof(T);
  const T zero = from_f<T>(0.0f);
  if (s_c == 1) {
    const int cv = C / V;
    for (int idx = threadIdx.x; idx < R * cv; idx += blockDim.x) {
      const int r = idx / cv, c = (idx - r * cv) * V;
      const int gr = r0 + r, gc = c0 + c;
      T* d = s + r * ld + c;
      const T* src = g + (long long)gr * s_r + gc;
      if (gr < nr && gc + V <= nc && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) d[v] = (gr < nr && gc + v < nc) ? src[v] : zero;
      }
    }
  } else if (s_r == 1) {
    const int rv = R / V;
    for (int idx = threadIdx.x; idx < C * rv; idx += blockDim.x) {
      const int c = idx / rv, r = (idx - c * rv) * V;
      const int gr = r0 + r, gc = c0 + c;
      const T* src = g + (long long)gc * s_c + gr;
      if (gc < nc && gr + V <= nr && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        uint4 raw = *reinterpret_cast<const uint4*>(src);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int v = 0; v < V; ++v) s[(r + v) * ld + c] = e[v];
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          s[(r + v) * ld + c] = (gc < nc && gr + v < nr) ? src[v] : zero;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < R * C; idx += blockDim.x) {
      const int r = idx / C, c = idx - r * C;
      const int gr = r0 + r, gc = c0 + c;
      s[r * ld + c] = (gr < nr && gc < nc) ? g[(long long)gr * s_r + (long long)gc * s_c]
                                           : zero;
    }
  }
}

// sC[BM x BN] (+)= sA[BM x BK] @ sB[BK x BN] for fp32 operands: lane l of
// a warp owns column c0 + l of a 32x32 region and keeps its 32 row sums in
// registers; A values are warp-wide broadcasts.  Rows at or past `mrows`
// are skipped; zero_init starts the sum at 0 instead of reading sC.
__device__ inline void mma_block(const float* sA, int lda, const float* sB, int ldb,
                                 float* sC, int ldc, int BM, int BK, int BN,
                                 int mrows, bool zero_init) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int rm = (BM + 31) / 32, rn = (BN + 31) / 32;
  const int mlim = mrows < BM ? mrows : BM;
  for (int reg = warp; reg < rm * rn; reg += nwarps) {
    const int r0 = (reg / rn) * 32, c0 = (reg % rn) * 32;
    if (r0 >= mlim) continue;
    const int rows = (mlim - r0) < 32 ? (mlim - r0) : 32;
    const int c = c0 + lane;
    const bool cv = c < BN;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = (!zero_init && cv && i < rows) ? sC[(r0 + i) * ldc + c] : 0.0f;
    for (int k = 0; k < BK; ++k) {
      const float bv = cv ? sB[k * ldb + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (i < rows) acc[i] = fmaf(sA[(r0 + i) * lda + k], bv, acc[i]);
    }
    if (cv) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (i < rows) sC[(r0 + i) * ldc + c] = acc[i];
    }
  }
}

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

// ---- register-resident accumulators (K9 a_resident) -------------------
// One warp's 16 x 16 fp32 accumulator, 8 floats a lane.  For bf16
// operands (AccMma) it is two m16n8 halves of `mma.sync.m16n8k16`:
// x[4h .. 4h + 3] hold columns 8h .. 8h + 7, with x[4h], x[4h + 1] at row
// lane / 4, columns 8h + 2 (lane % 4) + {0, 1}, and x[4h + 2], x[4h + 3]
// eight rows below.  For fp32 operands (AccF32) lane l holds column l % 16
// of rows l / 16 + 2 e (e < 8).  Two of the same kind add element by
// element, since element e of both is the same (row, column).
struct AccMma {
  float x[8];
};
struct AccF32 {
  float x[8];
};
template <typename T> struct AccFrag;
template <> struct AccFrag<bf16> {
  using type = AccMma;
};
template <> struct AccFrag<float> {
  using type = AccF32;
};

template <typename A>
__device__ __forceinline__ void acc_zero(A& a) {
#pragma unroll
  for (int e = 0; e < 8; ++e) a.x[e] = 0.0f;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d (4 floats at x[o]) += A (16 x 16, row-major) @ B (16 x 8, col-major).
__device__ __forceinline__ void mma_16816(float* d, const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[r] += sA[16 r .. 16 r + 16, 0 .. K) @ sB[0 .. K, 0 .. 16) for r < nrf,
// in 16-deep steps in k order.  bf16: ldmatrix fragments and two
// m16n8k16 HMMAs a step (the instruction WMMA 16x16x16 lowers to on
// sm_90); fp32: an fmaf chain.  sA and sB rows are 16-byte aligned.  BT: sB is
// held n-major (sB[c * ldb + k], a transposed B copied as its own rows),
// which is mma.sync's column-major B, read by ldmatrix untransposed (the
// four 8 x 8 matrices: columns 0-7 at k 0-7 and 8-15, then columns 8-15);
// the sums are the same.
template <int MR, bool BT = false>
__device__ __forceinline__ void strip_mma(AccMma (&acc)[MR], const bf16* sA, int lda,
                                          const bf16* sB, int ldb, int K, int nrf) {
  const int lane = threadIdx.x % 32;
  const bf16* pa = sA + (lane % 16) * lda + (lane / 16) * 8;
  const bf16* pb = BT ? sB + ((lane & 7) + 8 * (lane >> 4)) * ldb + ((lane >> 3) & 1) * 8
                      : sB + (lane % 16) * ldb + (lane / 16) * 8;
  for (int kk = 0; kk < K; kk += 16) {
    unsigned b[4];
    if (BT)
      ldsm_x4(b, pb + kk);
    else
      ldsm_x4_trans(b, pb + kk * ldb);
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nrf) break;
      unsigned a[4];
      ldsm_x4(a, pa + 16 * r * lda + kk);
      mma_16816(acc[r].x, a, b[0], b[1]);
      mma_16816(acc[r].x + 4, a, b[2], b[3]);
    }
  }
}
template <int MR, bool BT = false>
__device__ __forceinline__ void strip_mma(AccF32 (&acc)[MR], const float* sA, int lda,
                                          const float* sB, int ldb, int K, int nrf) {
  const int lane = threadIdx.x % 32, c = lane % 16, h = lane / 16;
  for (int k = 0; k < K; ++k) {
    const float bv = BT ? sB[c * ldb + k] : sB[k * ldb + c];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nrf) break;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r].x[e] = fmaf(sA[(16 * r + h + 2 * e) * lda + k], bv, acc[r].x[e]);
    }
  }
}

// Write one warp's 16 x 16 accumulator at (gr0, gc0) of the (m, n) output
// through the epilogue, masked at the edges.  Not inlined: a kernel holds
// up to 8 accumulators a lane, and 8 inlined epilogues each would
// multiply its code (and its build time) for work done once per output.
// With `mb` set, row gr of a contiguous (nb, mb, n) output is row gr % mb
// of batch gr / mb for the residual (K1's batched rows); by default every
// row is in batch 0.
template <typename O>
__device__ __forceinline__ void store_one(O* out, int gr, int gc, int m, int n, float v,
                                          const Epi& e, int mb) {
  if (gr < m && gc < n) {
    const int b = gr / mb;
    out[(long long)gr * n + gc] = from_f<O>(apply_epi(v, e, b, gr - b * mb, gc));
  }
}
template <typename O>
__device__ __noinline__ void store_acc(const AccMma a, O* out, int gr0, int gc0, int m,
                                       int n, const Epi e, int mb = 0x7fffffff) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int x = 0; x < 8; ++x)
    store_one(out, gr0 + g + 8 * ((x >> 1) & 1), gc0 + 8 * (x >> 2) + 2 * t + (x & 1), m, n,
              a.x[x], e, mb);
}
template <typename O>
__device__ __noinline__ void store_acc(const AccF32 a, O* out, int gr0, int gc0, int m,
                                       int n, const Epi e, int mb = 0x7fffffff) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int x = 0; x < 8; ++x)
    store_one(out, gr0 + lane / 16 + 2 * x, gc0 + lane % 16, m, n, a.x[x], e, mb);
}

// cp.async (sm_80+): a 16-byte global -> shared copy that bypasses the
// registers; `src_bytes` < 16 reads that many bytes and zero-fills the
// rest (0 reads nothing: `src` need only be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
// Wait until every cp.async this thread issued has landed (commit and
// wait in one).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}
// Close this thread's current group of cp.async copies (an empty group is
// allowed), and wait until at most `n` of its groups are still in flight
// (n < 8; the instruction takes n as an immediate, hence the switch).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// Copy the (R x C) tile at (r0, c0) of a matrix with unit column stride,
// row stride s_r and 16-byte aligned rows (nr x nc) into shared memory
// (leading dim ld) with cp.async, zero-filling past the edge.  C / V is
// 2^lgc vectors of 16 bytes, so a thread's (row, vector) needs no
// division; c0 is a multiple of V.
template <typename T>
__device__ __forceinline__ void copy_tile_async(T* s, int ld, const T* g, long long s_r,
                                                int r0, int c0, int R, int lgc, int nr,
                                                int nc) {
  constexpr int V = 16 / (int)sizeof(T);
  for (int idx = threadIdx.x; idx < (R << lgc); idx += kThreads) {
    const int r = idx >> lgc, c = (idx & ((1 << lgc) - 1)) * V;
    const int gr = r0 + r, gc = c0 + c;
    const int valid = gr < nr ? max(0, min(V, nc - gc)) : 0;
    cp_async16(s + r * ld + c, valid ? g + (long long)gr * s_r + gc : g,
               valid * (int)sizeof(T));
  }
}

// log2 of x when x is a power of two, else -1.
__host__ __device__ inline int log2_exact(int x) {
  if (x <= 0 || (x & (x - 1))) return -1;
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// Start copying the (R x C) tile at (r0, c0) of a strided (nr x nc) matrix
// into shared memory (row-major, leading dim ld), zero-filling past the
// edge.  With a unit-stride row whose starts are 16-byte aligned the copy
// is asynchronous (cp.async, part of the caller's next commit group);
// otherwise it falls back to `load_tile`'s synchronous loads.  Either way
// the data is visible after the caller's cp_async_wait_all + __syncthreads.
// C and c0 are multiples of 16 bytes' worth of T.
template <typename T>
__device__ void load_tile_async(T* s, int ld, const T* g, long long s_r, long long s_c,
                                int r0, int c0, int R, int C, int nr, int nc) {
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec = s_c == 1 && s_r % V == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (!vec) {
    load_tile(s, ld, g, s_r, s_c, r0, c0, R, C, nr, nc);
    return;
  }
  const int cv = C / V;
  for (int idx = threadIdx.x; idx < R * cv; idx += blockDim.x) {
    const int r = idx / cv, c = (idx - r * cv) * V;
    const int gr = r0 + r, gc = c0 + c;
    const int valid = gr < nr ? max(0, min(V, nc - gc)) : 0;
    const T* src = valid ? g + (long long)gr * s_r + gc : g;
    cp_async16(s + r * ld + c, src, valid * (int)sizeof(T));
  }
}

}  // namespace rt
