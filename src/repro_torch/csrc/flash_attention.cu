// Flash attention (K7), hand-written for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
//   _fa_kernel): online-softmax attention with a causal mask, a sliding
//   window (col > row - window), a tanh soft-cap applied after the scale
//   (softcap * tanh(s / softcap)), and GQA / MQA through kv head =
//   q head / (Hq / Hkv).  Masked scores are -1e30 and their p is zeroed;
//   the output is acc / max(l, 1e-30), cast once to q's type.
//
// Grid: one CTA per (q tile, q head, batch row), blockIdx = (q tile, head,
// batch).  The Pallas grid's sequential kv dim is the loop inside the CTA;
// the running max m, sum l and the fp32 accumulator O stay in shared
// memory across it.  kv tiles beyond the causal frontier of the tile's last
// row, or wholly older than the window of its first row, are skipped (the
// `reachable` test of the TPU kernel).  K and V are read at the kv head's
// rows through their strides: nothing is materialised per q head.  Ragged
// Sq and Skv are masked (rows past Sq are neither computed nor stored,
// columns past Skv are zero-filled and masked), so no length has to divide
// a tile.
//
// Bound on the H100: at prefill lengths it is operations (QK^T and PV are
// 4 * D flops per unmasked (row, col) pair against 2 bytes per element of
// q, k, v and out); at the serving prefill of 4 x 128 tokens it is bytes
// and launch latency.  This first kernel is simple: tiles are
// single-buffered, the products use WMMA 16x16x16 tensor-core fragments
// from shared memory for bf16 (fp32 accumulation) and a plain FMA loop for
// fp32 (IEEE fp32, never TF32).  wgmma, TMA and warp specialisation are
// later work.
//
// P keeps fp32 precision, as in the TPU kernel: for bf16, P is split into
// two bf16 terms, hi = bf16(P) and lo = bf16(P - hi) (~16 significant
// bits together), and P@V runs as hi@V + lo@V.  With P rounded once to
// bf16 (8 bits), dbrx-132b's 2-layer decode logits moved 7.4% (mean) away
// from the plain path's, past chip_smoke.py's whole-path tolerance (NVIDIA
// H100 80GB HBM3, 700 W power limit).
//
// Tiles (bq x bkv, chosen by the Python wrapper; the kernel takes any
// multiple of 16 that fits): shared memory holds Q (bq x D), K^T (D x bkv),
// V (bkv x D), the fp32 scores S (bq x bkv), P (bq x bkv) and the fp32 O
// (bq x D), plus P's lo term for bf16.  bf16 uses 64 x 64 at every D:
// ~123 KB at D = 128 (one CTA per SM), ~207 KB at D = 256.  A 128-row q
// tile at D = 256 would need ~370 KB, over the 227 KB a CTA may hold.
// fp32 takes 64 x 64 up to D = 128 and 64 x 32 at D = 256 (~222 KB).
#include "common.cuh"

namespace rt {

constexpr float kMasked = -1e30f;

// Shared-memory bytes of one tile set; mirrored by smem_bytes() in
// kernels/flash_attention.py.
template <typename T>
__host__ __device__ inline long long fa_smem_bytes(int bq, int bkv, int d) {
  return align128((long long)bq * (d + pad<T>()) * sizeof(T)) +      // Q
         align128((long long)d * (bkv + pad<T>()) * sizeof(T)) +     // K^T
         align128((long long)bkv * (d + pad<T>()) * sizeof(T)) +     // V
         align128((long long)bq * (bkv + 4) * sizeof(float)) +       // S
         (sizeof(T) == 2 ? 2 : 1) *                                  // P (hi, lo)
             align128((long long)bq * (bkv + pad<T>()) * sizeof(T)) +
         align128((long long)bq * (d + 4) * sizeof(float)) +         // O
         2 * align128((long long)bq * sizeof(float));                 // m, l
}

template <typename T>
struct FaTiles {
  T *q, *kt, *v, *p, *plo;   // plo: P's lo term, bf16 only
  float *s, *o, *m, *l;
  int ldq, ldk, ldv, lds, ldp, ldo;
  __device__ FaTiles(unsigned char* base, int bq, int bkv, int d) {
    ldq = d + pad<T>();
    ldk = bkv + pad<T>();
    ldv = d + pad<T>();
    lds = bkv + 4;
    ldp = bkv + pad<T>();
    ldo = d + 4;
    unsigned char* c = base;
    q = reinterpret_cast<T*>(c);
    c += align128((long long)bq * ldq * sizeof(T));
    kt = reinterpret_cast<T*>(c);
    c += align128((long long)d * ldk * sizeof(T));
    v = reinterpret_cast<T*>(c);
    c += align128((long long)bkv * ldv * sizeof(T));
    s = reinterpret_cast<float*>(c);
    c += align128((long long)bq * lds * sizeof(float));
    p = reinterpret_cast<T*>(c);
    c += align128((long long)bq * ldp * sizeof(T));
    plo = nullptr;
    if (sizeof(T) == 2) {
      plo = reinterpret_cast<T*>(c);
      c += align128((long long)bq * ldp * sizeof(T));
    }
    o = reinterpret_cast<float*>(c);
    c += align128((long long)bq * ldo * sizeof(float));
    m = reinterpret_cast<float*>(c);
    c += align128((long long)bq * sizeof(float));
    l = reinterpret_cast<float*>(c);
  }
};

struct FaArgs {
  const void* q;
  long long q_b, q_h, q_s;     // strides in elements; D has unit stride
  const void* k;
  long long k_b, k_h, k_s;
  const void* v;
  long long v_b, v_h, v_s;
  void* o;
  long long o_b, o_h, o_s;
  int group;                   // Hq / Hkv
  int sq, skv, d, bq, bkv;
  float scale, softcap;        // softcap <= 0: none
  int causal, window;          // window <= 0: none
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool fa_visible(const FaArgs& a, int row, int col) {
  bool ok = col < a.skv;
  if (a.causal) ok = ok && col <= row;
  if (a.window > 0) ok = ok && col > row - a.window;
  return ok;
}

// One online-softmax step on the scores of kv tile k0: a warp per row.
// S is turned into P (masked entries 0; for bf16 its hi and lo terms), O's
// row is rescaled by alpha, and m, l are updated, in the order of the TPU
// kernel.  Rows past `rows` get P = 0 so the P@V fragments that cover them
// read finite values.
template <typename T>
__device__ void fa_softmax(const FaArgs& a, FaTiles<T>& t, int q0, int k0, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < a.bq; r += nwarps) {
    T* prow = t.p + r * t.ldp;
    T* lrow = t.plo ? t.plo + r * t.ldp : nullptr;
    if (r >= rows) {
      for (int c = lane; c < a.bkv; c += 32) {
        prow[c] = from_f<T>(0.0f);
        if constexpr (sizeof(T) == 2) lrow[c] = from_f<T>(0.0f);
      }
      continue;
    }
    const int row = q0 + r;
    float* srow = t.s + r * t.lds;
    float mx = kMasked;
    for (int c = lane; c < a.bkv; c += 32) {
      float s = srow[c] * a.scale;
      if (a.softcap > 0.0f) s = a.softcap * tanhf(s / a.softcap);
      s = fa_visible(a, row, k0 + c) ? s : kMasked;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    const float m_prev = t.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.0f;
    for (int c = lane; c < a.bkv; c += 32) {
      const float p = fa_visible(a, row, k0 + c) ? expf(srow[c] - m_new) : 0.0f;
      sum += p;
      const T hi = from_f<T>(p);
      prow[c] = hi;
      if constexpr (sizeof(T) == 2) lrow[c] = from_f<T>(p - to_f(hi));
    }
    sum = warp_sum(sum);
    const float alpha = expf(m_prev - m_new);
    float* orow = t.o + r * t.ldo;
    for (int c = lane; c < a.d; c += 32) orow[c] *= alpha;
    if (lane == 0) {
      t.l[r] = t.l[r] * alpha + sum;
      t.m[r] = m_new;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fa_kernel(FaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  FaTiles<T> t(smem, a.bq, a.bkv, a.d);
  const int q0 = blockIdx.x * a.bq;
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long hk = h / a.group;
  const int rows = min(a.bq, a.sq - q0);
  const T* Q = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
  const T* K = static_cast<const T*>(a.k) + b * a.k_b + hk * a.k_h;
  const T* V = static_cast<const T*>(a.v) + b * a.v_b + hk * a.v_h;

  load_tile(t.q, t.ldq, Q, a.q_s, 1, q0, 0, a.bq, a.d, a.sq, a.d);
  for (int i = threadIdx.x; i < a.bq * t.ldo; i += blockDim.x) t.o[i] = 0.0f;
  for (int i = threadIdx.x; i < a.bq; i += blockDim.x) {
    t.m[i] = kMasked;
    t.l[i] = 0.0f;
  }
  const int last_row = q0 + rows - 1;
  for (int k0 = 0; k0 < a.skv; k0 += a.bkv) {
    if (a.causal && k0 > last_row) break;                        // past the frontier
    if (a.window > 0 && k0 + a.bkv - 1 <= q0 - a.window) continue;  // older than the window
    __syncthreads();
    // K^T tile: element (dd, j) = K[k0 + j][dd], i.e. unit row stride.
    load_tile(t.kt, t.ldk, K, 1, a.k_s, 0, k0, a.d, a.bkv, a.d, a.skv);
    load_tile(t.v, t.ldv, V, a.v_s, 1, k0, 0, a.bkv, a.d, a.skv, a.d);
    __syncthreads();
    mma_block(t.q, t.ldq, t.kt, t.ldk, t.s, t.lds, a.bq, a.d, a.bkv, rows, true);
    __syncthreads();
    fa_softmax(a, t, q0, k0, rows);
    __syncthreads();
    mma_block(t.p, t.ldp, t.v, t.ldv, t.o, t.ldo, a.bq, a.bkv, a.d, rows, false);
    if constexpr (sizeof(T) == 2) {
      __syncthreads();
      mma_block(t.plo, t.ldp, t.v, t.ldv, t.o, t.ldo, a.bq, a.bkv, a.d, rows, false);
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.o) + b * a.o_b + h * a.o_h;
  for (int idx = threadIdx.x; idx < rows * a.d; idx += blockDim.x) {
    const int r = idx / a.d, c = idx - r * a.d;
    out[(long long)(q0 + r) * a.o_s + c] =
        from_f<T>(t.o[r * t.ldo + c] / fmaxf(t.l[r], 1e-30f));
  }
}

template <typename T>
int launch_fa(const FaArgs& a, int batch, int hq, cudaStream_t stream) {
  if (a.bq % 16 || a.bkv % 16 || a.d % 16 || a.d > 256 || a.group < 1 || hq % a.group)
    return (int)cudaErrorInvalidValue;
  const long long smem = fa_smem_bytes<T>(a.bq, a.bkv, a.d);
  if (smem > kSmemMax || hq > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fa_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + a.bq - 1) / a.bq, hq, batch);
  fa_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rt

// q (batch, hq, sq, d), k / v (batch, hq / group, skv, d), out like q, all
// read or written through their (batch, head, sequence) strides in elements
// with a unit stride along d; q, k, v and out share one type (bf16 if
// is_bf16, else fp32).  window <= 0 means no window, softcap <= 0 no cap.
// Returns the cudaError_t of the launch.
extern "C" int rt_flash_attention(int is_bf16, const void* q, long long q_b, long long q_h,
                                  long long q_s, const void* k, long long k_b, long long k_h,
                                  long long k_s, const void* v, long long v_b, long long v_h,
                                  long long v_s, void* out, long long o_b, long long o_h,
                                  long long o_s, int batch, int hq, int group, int sq, int skv,
                                  int d, int bq, int bkv, float scale, float softcap, int causal,
                                  int window, void* stream) {
  rt::FaArgs a{q,   q_b, q_h, q_s, k,     k_b, k_h, k_s, v,  v_b,   v_h,     v_s,    out,
               o_b, o_h, o_s, group, sq,  skv, d,   bq,  bkv, scale, softcap, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return rt::launch_fa<rt::bf16>(a, batch, hq, s);
  return rt::launch_fa<float>(a, batch, hq, s);
}
