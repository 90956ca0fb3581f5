// Mamba-2 SSD chunked scan (K8), hand-written for Hopper.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel), the
//   state-space-duality form of Mamba-2's selective scan.  Per head h (A =
//   -exp(a_log[h]), B and C of group h / (H / G)) and per chunk of Q rows:
//
//     cum_i   = sum_{k <= i} dt_k A                 (running log-decay)
//     y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i state                   (intra + inter chunk)
//     state  <- exp(cum_last) state + sum_j exp(cum_last - cum_j) B_j^T dt_j x_j
//
//   all in fp32, as in the TPU kernel; y is cast once to x's type.
//
// Grid: one CTA per (head, batch row).  The TPU grid's sequential chunk dim
// is the loop inside the CTA, and the (S, P) fp32 state stays in shared
// memory across it; nothing carries between CTAs.  x (B, L, H, P), dt (B,
// L, H) and B / C (B, L, G, S) are read in place through their strides (the
// TPU wrapper copies them head-major first), y is written in (B, L, H, P).
// Any L: rows past L in the last chunk act as dt = 0, x = B = C = 0 and are
// never stored (the TPU kernel asserts L % chunk == 0).  With a state
// pointer the kernel also writes the fp32 state after the last position,
// (B, H, S, P), which the serving prefill hands to decode; the TPU kernel
// keeps it in scratch and drops it.
//
// exp(cum_i - cum_j) overflows for j > i under a strong decay, so those
// score entries are selected away (never multiplied by a 0/1 mask: inf * 0
// is NaN); every exponent the kernel does evaluate is <= 0.
//
// The prefix sum cum is taken by one thread, in order, in fp64, and every
// difference cum_i - cum_j is taken in fp64 before it is rounded to fp32
// for exp.  Under a strong decay |cum| reaches thousands within a chunk;
// an fp32 prefix sum holds cum_i - cum_j only to a few ulps of |cum|, which
// moves exp(cum_i - cum_j) by ~1e-4 relative and y by as much, whatever the
// association.  The serial sum is ~128 dependent adds a chunk, overlapped
// with the other threads' loads of x and B; the plain version takes the
// same fp64 sum, so the two agree without copying an association.
//
// Shared memory (fp32, odd leading dims so that row and column walks are
// both free of bank conflicts), at the limits Q <= 128, S <= 128, P <= 64:
// B (Q x S) 66,048 B, one 64-row strip of C 33,024 B, the 64-row strip of
// scores (64 x Q) 33,024 B, x * dt (Q x P) 33,280 B, the state (S x P)
// 33,280 B, dt 512 B and the fp64 cum 1,024 B: 200,192 B, one CTA (8 warps)
// per SM.
// Holding all of C and the whole Q x Q score tile in fp32 would take 256 KB,
// more than the 227 KB a CTA may have, so C and the scores walk the chunk in
// 64-row strips; a strip's scores stop at its last row (causal), so the
// first strip of a 128-row chunk computes half the columns.
//
// Products: fp32 FMAs from shared memory (IEEE fp32, never TF32), each
// thread of a 16 x 16 grid holding a strided register tile (rows ty + 16 i,
// columns tx + 16 j): C B^T per strip, scores @ (x dt) and C @ state per
// strip, then B^T @ (w x dt) for the state update.
//
// Bound on the H100: operations.  Per (head, chunk) the causal pairs need
// 2 (S + P) flops each and the two state products 4 Q S P, ~7.3 Mflop at
// Q = S = 128, P = 64, against ~70 KB of bf16 x, B, C, y: ~100 flops per
// byte, so the arithmetic bounds it, not HBM.  C B^T (2 S per pair, ~29%
// of the flops) has bf16 operands when x, B, C are bf16 and could run
// exactly on the tensor cores (989 TFLOP/s); the rest has an fp32 operand
// (x dt, the scores, the state) and runs at the fp32 rate (67 TFLOP/s),
// which therefore sets the bound.  The design keeps every intermediate on
// chip and reads each input once.  Its weak spot is
// parallelism: B x H CTAs (320 at mamba2-2.7b's batch 4, 80 at batch 1,
// which leaves 52 of 132 SMs idle on a long prompt); a chunk-parallel
// two-pass scan and tensor-core products are later work.
#include "common.cuh"

namespace rt {

constexpr int kSsdThreads = 256;   // a 16 x 16 thread grid
constexpr int kQMax = 128;         // chunk rows
constexpr int kSMax = 128;         // state size S
constexpr int kPMax = 64;          // head dim P
constexpr int kStrip = 64;         // rows of C / scores held at once
constexpr int kLdS = kSMax + 1;
constexpr int kLdQ = kQMax + 1;
constexpr int kLdP = kPMax + 1;
constexpr int kSsdSmemBytes =
    8 * kQMax + 4 * (kStrip * kLdS + kQMax * kLdS + kStrip * kLdQ + kQMax * kLdP + kSMax * kLdP + kQMax);

struct SsdArgs {
  const void* x;
  long long x_b, x_l, x_h;
  const float* dt;
  long long dt_b, dt_l, dt_h;
  const float* a_log;
  const void* bm;
  long long b_b, b_l, b_g;
  const void* cm;
  long long c_b, c_l, c_g;
  void* y;        // (B, L, H, P) contiguous, x's type
  float* state;   // (B, H, S, P) fp32, or null
  int L, H, G, P, S, Q;
};

// acc[i][j] += sum_{k < k1} A(ty + 16 i, k) * B(k, tx + 16 j), where A(m, k)
// = a[m * am + k * ak] and B(k, n) = b[k * bk + n * bn] lie in shared
// memory.  Tile rows or columns past the valid ones read whatever the
// buffer holds there; they reach only accumulators the caller never stores.
template <int TM, int TN>
__device__ __forceinline__ void tile_fma(float (&acc)[TM][TN], const float* a, int am, int ak,
                                         const float* b, int bk, int bn, int k1, int ty,
                                         int tx) {
  for (int k = 0; k < k1; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[(ty + 16 * i) * am + k * ak];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[k * bk + (tx + 16 * j) * bn];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The strip's scores: sc[r][j] = (C_{i0+r} . B_j) exp(cum_{i0+r} - cum_j) for
// j <= i0 + r, else 0, for the columns j < jmax.  TN * 16 >= jmax.
template <int TN>
__device__ __forceinline__ void score_strip(float* sc, const float* cs, const float* bs,
                                            const double* cum, int i0, int jmax, int S, int ty,
                                            int tx) {
  float acc[4][TN] = {};
  tile_fma<4, TN>(acc, cs, kLdS, 1, bs, 1, kLdS, S, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const double ci = cum[i0 + r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = tx + 16 * j;
      if (col < jmax) sc[r * kLdQ + col] = col <= i0 + r ? acc[i][j] * expf((float)(ci - cum[col])) : 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_kernel(SsdArgs a) {
  extern __shared__ __align__(16) double smd[];
  double* cum = smd;                  // log-decay prefix sums [kQMax]
  float* cs = reinterpret_cast<float*>(cum + kQMax);   // C strip [kStrip][kLdS]
  float* bs = cs + kStrip * kLdS;     // B        [kQMax][kLdS]
  float* sc = bs + kQMax * kLdS;      // scores   [kStrip][kLdQ]
  float* xd = sc + kStrip * kLdQ;     // x * dt   [kQMax][kLdP]
  float* st = xd + kQMax * kLdP;      // state    [kSMax][kLdP]
  float* dts = st + kSMax * kLdP;     // dt       [kQMax]

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int P = a.P, S = a.S, Q = a.Q;
  const float neg_a = -expf(a.a_log[h]);
  const T* xp = static_cast<const T*>(a.x) + b * a.x_b + h * a.x_h;
  const float* dtp = a.dt + b * a.dt_b + h * a.dt_h;
  const T* bp = static_cast<const T*>(a.bm) + b * a.b_b + g * a.b_g;
  const T* cp = static_cast<const T*>(a.cm) + b * a.c_b + g * a.c_g;
  const long long y_l = (long long)a.H * P;
  T* yp = static_cast<T*>(a.y) + b * a.L * y_l + (long long)h * P;

  for (int idx = tid; idx < kSMax * kLdP; idx += kSsdThreads) st[idx] = 0.0f;

  for (int c0 = 0; c0 < a.L; c0 += Q) {
    const int nv = min(Q, a.L - c0);   // valid rows of this chunk
    for (int r = tid; r < kQMax; r += kSsdThreads) dts[r] = r < nv ? dtp[(c0 + r) * a.dt_l] : 0.0f;
    __syncthreads();
    if (tid == 0) {   // the log-decays' running sum, in order, in fp64
      double run = 0.0;
#pragma unroll 8
      for (int r = 0; r < nv; ++r) cum[r] = run += (double)(dts[r] * neg_a);
    }
    for (int idx = tid; idx < Q * P; idx += kSsdThreads) {
      const int r = idx / P, p = idx - r * P;
      xd[r * kLdP + p] = r < nv ? to_f(xp[(c0 + r) * a.x_l + p]) * dts[r] : 0.0f;
    }
    for (int idx = tid; idx < Q * S; idx += kSsdThreads) {
      const int r = idx / S, s = idx - r * S;
      bs[r * kLdS + s] = r < nv ? to_f(bp[(c0 + r) * a.b_l + s]) : 0.0f;
    }
    __syncthreads();

    for (int i0 = 0; i0 < nv; i0 += kStrip) {
      const int rows = min(kStrip, nv - i0);
      const int jmax = i0 + rows;   // the columns the strip's rows can see
      for (int idx = tid; idx < kStrip * S; idx += kSsdThreads) {
        const int r = idx / S, s = idx - r * S;
        cs[r * kLdS + s] = r < rows ? to_f(cp[(c0 + i0 + r) * a.c_l + s]) : 0.0f;
      }
      __syncthreads();
      if (jmax <= 64)
        score_strip<4>(sc, cs, bs, cum, i0, jmax, S, ty, tx);
      else
        score_strip<8>(sc, cs, bs, cum, i0, jmax, S, ty, tx);
      __syncthreads();
      float yi[4][4] = {}, ys[4][4] = {};
      tile_fma<4, 4>(yi, sc, kLdQ, 1, xd, kLdP, 1, jmax, ty, tx);
      if (c0 > 0) tile_fma<4, 4>(ys, cs, kLdS, 1, st, kLdP, 1, S, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        const float e = expf((float)cum[i0 + r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yp[(c0 + i0 + r) * y_l + p] = from_f<T>(yi[i][j] + e * ys[i][j]);
        }
      }
      __syncthreads();
    }

    // state <- exp(last) state + B^T (w x dt), w_j = exp(last - cum_j)
    const double last = cum[nv - 1];
    for (int idx = tid; idx < nv * P; idx += kSsdThreads) {
      const int r = idx / P, p = idx - r * P;
      xd[r * kLdP + p] *= expf((float)(last - cum[r]));
    }
    __syncthreads();
    float acc[8][4] = {};
    tile_fma<8, 4>(acc, bs, 1, kLdS, xd, kLdP, 1, nv, ty, tx);
    const float e_last = expf((float)last);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (s < S && p < P) st[s * kLdP + p] = st[s * kLdP + p] * e_last + acc[i][j];
      }
    }
    __syncthreads();
  }

  if (a.state) {
    float* out = a.state + (b * a.H + h) * (long long)S * P;
    for (int idx = tid; idx < S * P; idx += kSsdThreads) {
      const int s = idx / P, p = idx - s * P;
      out[idx] = st[s * kLdP + p];
    }
  }
}

template <typename T>
int launch_ssd(const SsdArgs& a, int batch, cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || a.H < 1 || a.G < 1 || a.H % a.G || a.P < 1 ||
      a.P > kPMax || a.S < 1 || a.S > kSMax || a.Q < 1 || a.Q > kQMax || a.L < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSsdSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, batch);
  ssd_kernel<T><<<grid, kSsdThreads, kSsdSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rt

// x (batch, L, H, P) and b, c (batch, L, G, S) in one type (bf16 if
// is_bf16, else fp32), read through their (batch, step, head / group)
// strides in elements with a unit stride along P / S; dt (batch, L, H) fp32
// through its strides; a_log (H,) fp32; y (batch, L, H, P) contiguous, x's
// type; state (batch, H, S, P) fp32 or null.  Limits: P <= 64, S <= 128,
// 1 <= chunk <= 128, H % G == 0.  Returns the cudaError_t of the launch.
extern "C" int rt_ssd_scan(int is_bf16, const void* x, long long x_b, long long x_l,
                           long long x_h, const void* dt, long long dt_b, long long dt_l,
                           long long dt_h, const void* a_log, const void* bm, long long b_b,
                           long long b_l, long long b_g, const void* cm, long long c_b,
                           long long c_l, long long c_g, void* y, void* state, int batch, int L,
                           int H, int G, int P, int S, int chunk, void* stream) {
  rt::SsdArgs a{x,    x_b, x_l, x_h, static_cast<const float*>(dt), dt_b, dt_l, dt_h,
                static_cast<const float*>(a_log), bm, b_b, b_l, b_g, cm, c_b, c_l, c_g, y,
                static_cast<float*>(state), L, H, G, P, S, chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return rt::launch_ssd<rt::bf16>(a, batch, s);
  return rt::launch_ssd<float>(a, batch, s);
}
