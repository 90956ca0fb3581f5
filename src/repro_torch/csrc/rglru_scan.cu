// RG-LRU scan (K6), hand-written for Hopper.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan (body
//   _rglru_kernel), Griffin / RecurrentGemma's recurrence over pre-sigmoid
//   gate logits r, i and the per-channel parameter Lambda:
//
//   log a_t = -c * sigmoid(r_t) * softplus(Lambda)
//   h_t     = a_t h_{t-1} + sqrt(max(1 - exp(2 log a_t), 1e-12)) * sigmoid(i_t) * x_t
//
//   in fp32, y_t = h_t cast to x's type.  The clamp keeps the strong-decay
//   regime (a_t ~ e^-32) finite, as in the TPU kernel.
//
// Design.  The TPU kernel runs a Hillis-Steele scan of (a, b) pairs inside a
// chunk and carries h across chunks in VMEM.  On Hopper the channels are the
// parallelism: each thread owns one (batch row, channel) and walks the
// sequence in fp32, so there is no log-depth scan and no chunk, and any L
// works.  recurrentgemma-9b's prefill gives B * 4096 channels (16,384 at
// batch 4).  Neighbouring threads take neighbouring channels, so every load
// and store of a time step is coalesced along D; a thread issues the loads
// of kUnroll steps before it runs their recurrence, so that many loads are
// in flight while h waits on the previous step.
//
// Bound on the H100: bytes.  Per element the kernel reads x, r, i and writes
// y (8 bytes in bf16) for ~30 flops of fp32 math, far below the ~295 flops
// per byte at which the card stops being memory bound.
//
// Beside y it writes, when asked, the fp32 carry after the last position
// (B, D): the serving prefill's decode state.  The TPU kernel holds the same
// carry in scratch and drops it; reading it back from the rounded y would
// round the state to bf16.
#include "common.cuh"

namespace rt {

constexpr int kScanThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// log(1 + exp(x)) without overflow: max(x, 0) + log1p(exp(-|x|)).
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
rglru_kernel(const T* __restrict__ x, long long x_b, long long x_l, const T* __restrict__ r,
             long long r_b, long long r_l, const T* __restrict__ gi, long long i_b,
             long long i_l, const float* __restrict__ lam, T* __restrict__ y,
             float* __restrict__ h_last, int L, int D, float c) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  if (d >= D) return;
  const float lam_sp = softplus_f(lam[d]);
  const T* xp = x + b * x_b + d;
  const T* rp = r + b * r_b + d;
  const T* ip = gi + b * i_b + d;
  T* yp = y + b * (long long)L * D + d;
  float h = 0.0f;
  for (int t0 = 0; t0 < L; t0 += kUnroll) {
    float xv[kUnroll], rv[kUnroll], iv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = t0 + u;
      if (t < L) {
        xv[u] = to_f(xp[t * x_l]);
        rv[u] = to_f(rp[t * r_l]);
        iv[u] = to_f(ip[t * i_l]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = t0 + u;
      if (t < L) {
        const float log_a = -c * sigmoid_f(rv[u]) * lam_sp;
        const float a = expf(log_a);
        const float mult = sqrtf(fmaxf(1.0f - expf(2.0f * log_a), 1e-12f));
        h = a * h + mult * sigmoid_f(iv[u]) * xv[u];
        yp[t * D] = from_f<T>(h);
      }
    }
  }
  if (h_last) h_last[b * D + d] = h;
}

template <typename T>
int launch_rglru(const void* x, long long x_b, long long x_l, const void* r, long long r_b,
                 long long r_l, const void* gi, long long i_b, long long i_l, const float* lam,
                 void* y, float* h_last, int batch, int L, int D, float c,
                 cudaStream_t stream) {
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((D + kScanThreads - 1) / kScanThreads, batch);
  rglru_kernel<T><<<grid, kScanThreads, 0, stream>>>(
      static_cast<const T*>(x), x_b, x_l, static_cast<const T*>(r), r_b, r_l,
      static_cast<const T*>(gi), i_b, i_l, lam, static_cast<T*>(y), h_last, L, D, c);
  return (int)cudaGetLastError();
}

}  // namespace rt

// x, r, i (batch, L, D) read through their (batch, step) strides in
// elements with a unit stride along D, one type (bf16 if is_bf16, else
// fp32); lam (D,) fp32; y (batch, L, D) contiguous, x's type; h_last
// (batch, D) fp32 or null.  Returns the cudaError_t of the launch.
extern "C" int rt_rglru_scan(int is_bf16, const void* x, long long x_b, long long x_l,
                             const void* r, long long r_b, long long r_l, const void* gi,
                             long long i_b, long long i_l, const void* lam, void* y,
                             void* h_last, int batch, int L, int D, float c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lam);
  float* hp = static_cast<float*>(h_last);
  if (is_bf16)
    return rt::launch_rglru<rt::bf16>(x, x_b, x_l, r, r_b, r_l, gi, i_b, i_l, lp, y, hp, batch,
                                      L, D, c, s);
  return rt::launch_rglru<float>(x, x_b, x_l, r, r_b, r_l, gi, i_b, i_l, lp, y, hp, batch, L, D,
                                 c, s);
}
