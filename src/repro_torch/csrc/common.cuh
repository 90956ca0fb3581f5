// Shared device code for the port's Hopper kernels (sm_90a).
//
// Tiles: a plan block is one CTA tile.  A and B blocks are staged in shared
// memory in their input type with a 16-byte row pad; the fp32 accumulator
// block lives in shared memory too (the cost model's fp32 "scratch
// accumulator"), so the shared-memory footprint never exceeds the plan's
// modeled working set (which counts double buffers this kernel does not use).
//
// Products: bf16 operands go through warp-level tensor-core MMA (WMMA
// 16x16x16, fp32 accumulate); fp32 operands run a plain fp32 FMA loop —
// true IEEE fp32, never TF32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
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

// Row pad in elements: 16 bytes, keeps rows 16-byte aligned for vector
// stores and WMMA's ldm rule (multiple of 8 bf16 / 4 fp32).
template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / (int)sizeof(T);
}

__host__ __device__ inline long long align128(long long b) {
  return (b + 127) / 128 * 128;
}

// Shared-memory bytes of one (bm, bk, bn) tile set: A, B, fp32 C.
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

// sC[BM x BN] (+)= sA[BM x BK] @ sB[BK x BN].  Each warp owns 32x32
// regions (2x2 WMMA fragments); rows at or past `mrows` (the block's valid
// row count) are skipped, which is what keeps decode (m of a few rows
// inside a 64-row block) from paying for the padding.  zero_init starts
// the sum at 0 instead of reading sC.  BM, BK, BN are multiples of 16.
__device__ inline void mma_block(const bf16* sA, int lda, const bf16* sB, int ldb,
                                 float* sC, int ldc, int BM, int BK, int BN,
                                 int mrows, bool zero_init) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const int rm = (BM + 31) / 32, rn = (BN + 31) / 32;
  const int mlim = mrows < BM ? mrows : BM;
  for (int reg = warp; reg < rm * rn; reg += nwarps) {
    const int r0 = (reg / rn) * 32, c0 = (reg % rn) * 32;
    if (r0 >= mlim) continue;
    const bool r2 = r0 + 16 < mlim;
    const bool c2 = c0 + 16 < BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if ((i && !r2) || (j && !c2)) continue;
        if (zero_init)
          wmma::fill_fragment(acc[i][j], 0.0f);
        else
          wmma::load_matrix_sync(acc[i][j], sC + (r0 + 16 * i) * ldc + c0 + 16 * j, ldc,
                                 wmma::mem_row_major);
      }
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::load_matrix_sync(fa[0], sA + r0 * lda + kk, lda);
      if (r2) wmma::load_matrix_sync(fa[1], sA + (r0 + 16) * lda + kk, lda);
      wmma::load_matrix_sync(fb[0], sB + kk * ldb + c0, ldb);
      if (c2) wmma::load_matrix_sync(fb[1], sB + kk * ldb + c0 + 16, ldb);
      wmma::mma_sync(acc[0][0], fa[0], fb[0], acc[0][0]);
      if (c2) wmma::mma_sync(acc[0][1], fa[0], fb[1], acc[0][1]);
      if (r2) wmma::mma_sync(acc[1][0], fa[1], fb[0], acc[1][0]);
      if (r2 && c2) wmma::mma_sync(acc[1][1], fa[1], fb[1], acc[1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if ((i && !r2) || (j && !c2)) continue;
        wmma::store_matrix_sync(sC + (r0 + 16 * i) * ldc + c0 + 16 * j, acc[i][j], ldc,
                                wmma::mem_row_major);
      }
  }
}

// fp32 operands: lane l of a warp owns column c0 + l of a 32x32 region and
// keeps its 32 row sums in registers; A values are warp-wide broadcasts.
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

// Fold one partial tile into the output: gk == 1 writes the epilogue
// directly; otherwise the first k block writes the fp32 workspace, middle
// blocks add to it, and the last adds, applies the epilogue and casts.
// Each element is always handled by the same thread, so the workspace
// read-modify-write needs no synchronisation.
template <typename O>
__device__ void combine(const float* sc, int ldc, float* ws, O* out, int kk, int gk,
                        int i0, int j0, int bm, int bn, int m, int n, const Epi& e) {
  for (int idx = threadIdx.x; idx < bm * bn; idx += blockDim.x) {
    const int r = idx / bn, c = idx - r * bn;
    const int gr = i0 + r, gc = j0 + c;
    if (gr >= m || gc >= n) continue;
    const long long g = (long long)gr * n + gc;
    const float p = sc[r * ldc + c];
    if (gk == 1) {
      out[g] = from_f<O>(apply_epi(p, e, 0, gr, gc));
    } else if (kk == 0) {
      ws[g] = p;
    } else if (kk < gk - 1) {
      ws[g] = ws[g] + p;
    } else {
      out[g] = from_f<O>(apply_epi(ws[g] + p, e, 0, gr, gc));
    }
  }
}

// Carve the dynamic shared memory into the A, B and fp32 C tiles.
template <typename T>
struct Tiles {
  T* a;
  T* b;
  float* c;
  int lda, ldb, ldc;
  __device__ Tiles(unsigned char* smem, int bm, int bk, int bn) {
    lda = bk + pad<T>();
    ldb = bn + pad<T>();
    ldc = bn + 4;
    a = reinterpret_cast<T*>(smem);
    b = reinterpret_cast<T*>(smem + align128((long long)bm * lda * sizeof(T)));
    c = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(b) +
                                 align128((long long)bk * ldb * sizeof(T)));
  }
};

}  // namespace rt
