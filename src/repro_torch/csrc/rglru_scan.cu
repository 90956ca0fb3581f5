// RG-LRU scan (K6), hand-written for Hopper.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan (body
//   _rglru_kernel), Griffin / RecurrentGemma's recurrence over pre-sigmoid
//   gate logits r, i and the per-channel parameter Lambda:
//
//   log a_t = -c * sigmoid(r_t) * softplus(Lambda)
//   h_t     = a_t h_{t-1} + sqrt(max(1 - exp(2 log a_t), 1e-12)) * (sigmoid(i_t) * x_t)
//
//   in fp32, y_t = h_t cast to x's type.  The clamp keeps the strong-decay
//   regime (a_t ~ e^-32) finite, as in the TPU kernel; products of a in
//   [0, 1] can only underflow to 0.
//
// Design: a chunked two-level scan, as the TPU kernel runs it (a scan of
// (a, b) pairs inside a chunk, h carried across chunks), with the steps of
// a chunk spread over the threads of a CTA instead of one core's lanes.
// The grid is (D / ch channel tiles, B).  A CTA owns ch channels (16 or 32)
// of one batch row, neighbouring threads on neighbouring channels, vec (2
// where the rows are aligned: bf16x2 / float2 loads) channels a thread, so
// ch / vec threads cover a step and the CTA's 256 threads form nseg
// segments.  In a block of nseg * T steps segment k owns steps [k T, k T +
// T): each thread
//   1. loads its T steps of x, r, i (every input is read once, all 3 T
//      loads in flight together) and composes them, in registers, into
//      (prod a, h from zero) under (a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2);
//   2. after a barrier, folds the composites of the segments before its
//      own onto the CTA's carry h (in shared memory), giving its incoming h;
//   3. re-walks its T steps from that h with the a, b it holds and stores y;
//      the last segment's h is the carry into the next block.
// The config (`rglru_config` in kernels/rglru_scan.py) takes the widest
// tile whose grid still fills the card (32 channels: 512 CTAs at
// recurrentgemma-9b's batch-4 prefill; 16 at batch 1: 256 CTAs, where the
// thread-per-channel walk left 100 SMs idle) and T up to 8 (ceil(L /
// nseg) for short sequences, so the batch-4 prefill is one block).
//
// Bound on the H100: bytes.  Per element the kernel reads x, r, i and writes
// y (8 bytes in bf16) for ~17 flops of fp32 math, far below the ~295 flops
// per byte at which the card stops being memory bound.
//
// Beside y it writes, when asked, the fp32 carry after the last position
// (B, D): the serving prefill's decode state.  The TPU kernel holds the same
// carry in scratch and drops it; reading it back from the rounded y would
// round the state to bf16.
#include "common.cuh"

namespace rt {

constexpr int kScanThreads = 256;
constexpr int kTMax = 8;      // steps a thread owns in a block
constexpr int kChMax = 32;    // channels a CTA

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// VEC channels of one step: raw loads (issued first, converted later).
template <typename T, int VEC> struct Raw;
template <> struct Raw<bf16, 1> {
  bf16 v;
  __device__ __forceinline__ void load(const bf16* p) { v = *p; }
  __device__ __forceinline__ void get(float (&o)[1]) const { o[0] = __bfloat162float(v); }
};
template <> struct Raw<bf16, 2> {
  __nv_bfloat162 v;
  __device__ __forceinline__ void load(const bf16* p) {
    v = *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ __forceinline__ void get(float (&o)[2]) const {
    const float2 f = __bfloat1622float2(v);
    o[0] = f.x;
    o[1] = f.y;
  }
};
template <> struct Raw<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = *p; }
  __device__ __forceinline__ void get(float (&o)[1]) const { o[0] = v; }
};
template <> struct Raw<float, 2> {
  float2 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float2*>(p);
  }
  __device__ __forceinline__ void get(float (&o)[2]) const {
    o[0] = v.x;
    o[1] = v.y;
  }
};

template <typename T, int VEC>
__device__ __forceinline__ void store_y(T* p, const float (&h)[VEC]) {
  if constexpr (VEC == 2) {
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(h[0], h[1]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(h[0], h[1]);
  } else {
    *p = from_f<T>(h[0]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kScanThreads)
rglru_kernel(const T* __restrict__ x, long long x_b, long long x_l, const T* __restrict__ r,
             long long r_b, long long r_l, const T* __restrict__ gi, long long i_b,
             long long i_l, const float* __restrict__ lam, T* __restrict__ y,
             float* __restrict__ h_last, int L, int D, float c, int ch, int tsteps) {
  __shared__ float comp_a[kScanThreads * VEC], comp_b[kScanThreads * VEC];
  __shared__ float carry[kChMax];
  const int tpr = ch / VEC, nseg = kScanThreads / tpr;
  const int seg = threadIdx.x / tpr, cl = threadIdx.x - seg * tpr;
  const int d0 = blockIdx.x * ch + cl * VEC;
  const long long b = blockIdx.y;
  const bool ok = d0 < D;   // VEC == 2 only with D even: both channels or none
  float lam_sp[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) lam_sp[v] = ok ? softplus_f(lam[d0 + v]) : 0.0f;
  const T* xp = x + b * x_b + d0;
  const T* rp = r + b * r_b + d0;
  const T* ip = gi + b * i_b + d0;
  T* yp = y + b * (long long)L * D + d0;
  if (threadIdx.x < kChMax) carry[threadIdx.x] = 0.0f;
  __syncthreads();

  for (long long t0 = 0; t0 < L; t0 += (long long)nseg * tsteps) {
    const long long ts = t0 + (long long)seg * tsteps;
    Raw<T, VEC> rx[kTMax], rr[kTMax], ri[kTMax];
#pragma unroll
    for (int u = 0; u < kTMax; ++u) {
      const long long t = ts + u;
      if (ok && u < tsteps && t < L) {
        rx[u].load(xp + t * x_l);
        rr[u].load(rp + t * r_l);
        ri[u].load(ip + t * i_l);
      }
    }
    // (a_t, b_t) of each step (past L: the identity (1, 0)), composed
    float av[kTMax][VEC], bv[kTMax][VEC], ca[VEC], cb[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) ca[v] = 1.0f, cb[v] = 0.0f;
#pragma unroll
    for (int u = 0; u < kTMax; ++u) {
      const long long t = ts + u;
      const bool live = ok && u < tsteps && t < L;
      float xv[VEC], rv[VEC], iv[VEC];
      if (live) {
        rx[u].get(xv);
        rr[u].get(rv);
        ri[u].get(iv);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (live) {
          const float log_a = -c * sigmoid_f(rv[v]) * lam_sp[v];
          const float mult = sqrtf(fmaxf(1.0f - expf(2.0f * log_a), 1e-12f));
          av[u][v] = expf(log_a);
          bv[u][v] = mult * (sigmoid_f(iv[v]) * xv[v]);
        } else {
          av[u][v] = 1.0f;
          bv[u][v] = 0.0f;
        }
        cb[v] = av[u][v] * cb[v] + bv[u][v];
        ca[v] = av[u][v] * ca[v];
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      comp_a[threadIdx.x * VEC + v] = ca[v];
      comp_b[threadIdx.x * VEC + v] = cb[v];
    }
    __syncthreads();
    // incoming h: the carry, then the segments before this one in order
    float hv[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) hv[v] = carry[cl * VEC + v];
    for (int k = 0; k < seg; ++k) {
      const int o = (k * tpr + cl) * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v) hv[v] = comp_a[o + v] * hv[v] + comp_b[o + v];
    }
#pragma unroll
    for (int u = 0; u < kTMax; ++u) {
      const long long t = ts + u;
      if (u < tsteps) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) hv[v] = av[u][v] * hv[v] + bv[u][v];
        if (ok && t < L) store_y<T, VEC>(yp + t * D, hv);
      }
    }
    __syncthreads();   // every thread has read the carry and the composites
    if (seg == nseg - 1) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) carry[cl * VEC + v] = hv[v];
    }
    __syncthreads();
  }
  if (h_last && ok && seg == 0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) h_last[b * D + d0 + v] = carry[cl * VEC + v];
  }
}

template <typename T, int VEC>
int launch_rglru(const void* x, long long x_b, long long x_l, const void* r, long long r_b,
                 long long r_l, const void* gi, long long i_b, long long i_l, const float* lam,
                 void* y, float* h_last, int batch, int L, int D, float c, int ch, int tsteps,
                 cudaStream_t stream) {
  dim3 grid((D + ch - 1) / ch, batch);
  rglru_kernel<T, VEC><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const T*>(x), x_b, x_l, static_cast<const T*>(r), r_b, r_l,
      static_cast<const T*>(gi), i_b, i_l, lam, static_cast<T*>(y), h_last, L, D, c, ch, tsteps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rglru_vec(int vec, const void* x, long long x_b, long long x_l, const void* r,
                     long long r_b, long long r_l, const void* gi, long long i_b, long long i_l,
                     const float* lam, void* y, float* h_last, int batch, int L, int D, float c,
                     int ch, int tsteps, cudaStream_t stream) {
  if (vec == 2) {
    // both channels of a pair in range and every pair 2-element aligned
    const uintptr_t mis = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                          reinterpret_cast<uintptr_t>(gi) | reinterpret_cast<uintptr_t>(y);
    if (D % 2 || (mis & (2 * sizeof(T) - 1)) || x_b % 2 || x_l % 2 || r_b % 2 || r_l % 2 ||
        i_b % 2 || i_l % 2)
      return (int)cudaErrorInvalidValue;
    return launch_rglru<T, 2>(x, x_b, x_l, r, r_b, r_l, gi, i_b, i_l, lam, y, h_last, batch, L,
                              D, c, ch, tsteps, stream);
  }
  return launch_rglru<T, 1>(x, x_b, x_l, r, r_b, r_l, gi, i_b, i_l, lam, y, h_last, batch, L, D,
                            c, ch, tsteps, stream);
}

}  // namespace rt

// x, r, i (batch, L, D) read through their (batch, step) strides in
// elements with a unit stride along D, one type (bf16 if is_bf16, else
// fp32); lam (D,) fp32; y (batch, L, D) contiguous, x's type; h_last
// (batch, D) fp32 or null.  The walk (`rglru_config`): ch channels a CTA
// (16 or 32), vec channels a thread (1, or 2 with D even and every row
// 2-element aligned), tsteps (1..8) steps a thread in a block.  Returns
// the cudaError_t of the launch.
extern "C" int rt_rglru_scan(int is_bf16, const void* x, long long x_b, long long x_l,
                             const void* r, long long r_b, long long r_l, const void* gi,
                             long long i_b, long long i_l, const void* lam, void* y,
                             void* h_last, int batch, int L, int D, float c, int ch, int vec,
                             int tsteps, void* stream) {
  if (batch < 1 || batch > 65535 || L < 0 || D < 1 || (vec != 1 && vec != 2) ||
      (ch != 16 && ch != 32) || tsteps < 1 || tsteps > rt::kTMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lam);
  float* hp = static_cast<float*>(h_last);
  if (is_bf16)
    return rt::launch_rglru_vec<rt::bf16>(vec, x, x_b, x_l, r, r_b, r_l, gi, i_b, i_l, lp, y, hp,
                                          batch, L, D, c, ch, tsteps, s);
  return rt::launch_rglru_vec<float>(vec, x, x_b, x_l, r, r_b, r_l, gi, i_b, i_l, lp, y, hp,
                                     batch, L, D, c, ch, tsteps, s);
}
