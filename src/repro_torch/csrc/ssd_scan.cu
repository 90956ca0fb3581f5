// Mamba-2 SSD chunked scan (K8), hand-written for Hopper.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel), the
//   state-space-duality form of Mamba-2's selective scan.  Per head h (A =
//   -exp(a_log[h]), B and C of group h / (H / G)) and per chunk c of Q rows:
//
//     cum_i   = sum_{k <= i} dt_k A                 (running log-decay)
//     y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i state_{c-1}             (intra + inter chunk)
//     state_c = exp(cum_last) state_{c-1} + dS_c,
//     dS_c    = sum_j exp(cum_last - cum_j) B_j^T dt_j x_j
//
//   all in fp32, as in the TPU kernel; y is cast once to x's type.
//
// Design: chunk-parallel.  cum restarts in every chunk, so chunks depend on
// one another only through the carried state, and the scan runs as three
// kernels (the TPU grid walks the chunks in order on one core):
//   1. ssd_chunk_state_kernel: per (batch row, head, chunk, 64 rows of S),
//      independently, the chunk's own contribution dS_c into an fp32
//      workspace (B, H, chunks, S, P rounded up to 4) and its decay
//      exp(cum_last) into (B, H, chunks);
//   2. ssd_state_pass_kernel: sequential over chunks only, parallel over
//      B x H x S x P (four elements a thread): state_c = state_{c-1} *
//      exp(cum_last) + dS_c, writing each chunk's incoming state over its
//      dS_c in place, and the state after the last chunk to the output;
//   3. ssd_scan_kernel (the readout): per (batch row, head, chunk, strip of
//      64 rows), independently, y = (C B^T o decay) (x dt) + exp(cum) o (C
//      state_{c-1}).
// With one chunk (L <= chunk: the batch-4 prefill) 1 and 2 are skipped: the
// readout runs alone with a zero incoming state, and each of its strips
// also writes the returned state over its share of S's 64-row blocks.  The
// last chunk's dS is computed only when the state is returned.  At mamba2's
// 1 x 3000 prompt that is 3,840 independent CTAs per kernel instead of 80
// serial walks, and at its batch-4 prefill 640 readout CTAs.  Nothing
// carries between CTAs of one kernel; the workspace is 32 KB per (head,
// chunk) at S 128, P 64 (63 MB at 1 x 3000), allocated by the wrapper.
//
// x (B, L, H, P), dt (B, L, H) and B / C (B, L, G, S) are read in place
// through their strides (the TPU wrapper copies them head-major first), y
// is written in (B, L, H, P).  Any L: rows past L in the last chunk act as
// dt = 0, x = B = C = 0 and are never stored (the TPU kernel asserts L %
// chunk == 0).  The state (B, H, S, P) after the last position is what the
// serving prefill hands to decode; the TPU kernel keeps it in scratch and
// drops it.
//
// exp(cum_i - cum_j) overflows for j > i under a strong decay, so those
// score entries are selected away (never multiplied by a 0/1 mask: inf * 0
// is NaN); every exponent the kernels evaluate is <= 0.
//
// The prefix sum cum is taken in fp64 by one warp (each lane four rows in
// order, then a shuffle scan over the lanes), and every difference cum_i -
// cum_j is taken in fp64 before it is rounded to fp32 for exp.  Under a
// strong decay |cum| reaches thousands within a chunk; an fp32 prefix sum
// holds cum_i - cum_j only to a few ulps of |cum|, which moves exp(cum_i -
// cum_j) by ~1e-4 relative and y by as much, whatever the association; in
// fp64 the association moves it by ~1e-13.  The plain version takes the
// same fp64 sum.
//
// Products, bf16 inputs (the served route): all on the tensor cores
// (ldmatrix + mma.sync m16n8k16, fp32 sums).  C B^T has bf16 operands and
// is exact in one MMA term.  The products with an fp32 operand (the scores
// @ (x dt), C @ state_{c-1}, B^T @ (w x dt)) keep it as two bf16 terms,
// hi = bf16(v) and lo = bf16(v - hi), |v - hi - lo| <= 2^-18 |v|, as K7
// keeps P: two MMA terms with one fp32 operand, three (hi hi, hi lo, lo hi)
// with two.  Each product then carries a relative error of at most ~2^-17
// beside fp32's 2^-24: chip_smoke.py's phase 3d finds the fp32 state
// within 5e-6 of its largest magnitude of the plain version's (it is held
// to 1e-4), and y moves far less than its bf16 rounding.  fp32 FMAs for
// those products, fed from shared memory on a 4 x 4 register tile a
// thread, ran at half the fp32 rate (a 16-byte shared-memory read costs
// four wavefronts whatever the broadcast): chip_smoke.py's phase 6d timed
// them at 0.0769 ms at mamba2's batch-4 prefill and 0.584 ms at its 1 x
// 3000 prompt, the split at 0.0488 and 0.338 (NVIDIA H100 80GB HBM3, 700
// W).
// fp32 inputs keep IEEE fp32 FMAs (never TF32) for every product but none
// of the split: `fma_tile`, a 64 x 64 tile over 256 threads, 4 x 4 sums a
// thread.
//
// Loads.  B and C rows go to shared memory with cp.async when their rows
// are 16-byte aligned (else plain loads), zero-filled past L and past S.
// x is read into registers with 16-byte loads at the start of a CTA and
// split into shared memory as x dt (and, for the state, (x dt) w) once the
// prefix sum is known; the incoming state is read from the workspace into
// registers the same way (fp32 route: x dt and the state straight into
// shared memory).
//
// Shared memory.  fp64 cum, dt and the state weights (2,048 B), then for
// the readout three regions: X (the C strip, then x dt), Y (B), Z (the
// incoming state, then the 64 x Q scores).  bf16: X and Z 36,864 B (a
// split operand: two bf16 planes), Y 34,816 B, 110,592 B in all, two CTAs
// (16 warps) an SM; fp32: 139,264 B, one CTA an SM.  Chunk state: 57,344
// B (bf16, four CTAs an SM) / 71,680 B (fp32).
//
// Bound on the H100.  Per (head, chunk) the causal pairs need 2 (S + P)
// flops each and the two state products 4 Q S P, ~7.3 Mflop at Q = S =
// 128, P = 64, against ~70 KB of bf16 x, B, C, y.  Counted as the MMA
// terms the bf16 route runs (C B^T once, the scores @ (x dt) three times,
// the state products twice) at the bf16 tensor-core rate (989 TFLOP/s),
// that is ~13.7 Mflop, ~14 us per 1,000 (head, chunk)s, and the bytes (x,
// y, B, C, dt and the fp32 state, each once) bound the batch-4 prefill;
// the operations bound the 1 x 3000 prompt.  The workspace (written,
// passed over once and read, 4 x 63 MB at 1 x 3000) is the price of the
// chunk parallelism; it is not counted in the bound.
#include "common.cuh"

namespace rt {

constexpr int kSsdThreads = 256;
constexpr int kQMax = 128;         // chunk rows
constexpr int kSMax = 128;         // state size S
constexpr int kPMax = 64;          // head dim P
constexpr int kStrip = 64;         // y rows of a readout CTA
constexpr int kSBlk = 64;          // state rows (of S) of a chunk-state CTA
constexpr int kLdX = kPMax + 4;    // fp32 rows of x dt and of a state (272 B)
constexpr int kLdSc = kQMax + 4;   // fp32 rows of the scores (528 B)
constexpr int kLdH = kPMax + 8;    // bf16 rows of a split (k, p) operand (144 B)
constexpr int kLdSh = kQMax + 8;   // bf16 rows of the split scores (272 B)
// C / B rows in the readout: bf16 272 B (ldmatrix rows 16 B apart in the
// banks), fp32 528 B; B's 64-column block in the chunk-state kernel.
template <typename T> __host__ __device__ constexpr int ld_cb() {
  return sizeof(T) == 2 ? kSMax + 8 : kSMax + 4;
}
template <typename T> __host__ __device__ constexpr int ld_sb() {
  return sizeof(T) == 2 ? kSBlk + 8 : kSBlk + 4;
}
constexpr int kHead = kQMax * (8 + 4 + 4);       // cum (fp64), dt and w (fp32)
constexpr int kSplit = 2 * kQMax * kLdH * 2;     // a split (k, p) operand: 36,864 B
// Regions X (the C strip, then x dt), Y (B) and Z (the incoming state, then
// the scores) of the readout, by input type.
template <typename T> __host__ __device__ constexpr int region_xz() {
  return sizeof(T) == 2 ? kSplit : kQMax * kLdX * 4;
}
static_assert(2 * kStrip * kLdSh * 2 <= kSplit, "split scores fit region Z");
static_assert(kStrip * kLdSc * 4 <= kQMax * kLdX * 4, "fp32 scores fit region Z");
static_assert(kStrip * ld_cb<float>() * 4 <= kQMax * kLdX * 4, "a C strip fits region X");
template <typename T> constexpr int readout_smem() {
  return kHead + 2 * region_xz<T>() + kQMax * ld_cb<T>() * (int)sizeof(T);
}
template <typename T> constexpr int chunk_state_smem() {
  return kHead + kQMax * ld_sb<T>() * (int)sizeof(T) + region_xz<T>();
}

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
  float* ws;      // (B, H, nc, S, ldp) fp32 chunk states, or null (one chunk)
  float* decay;   // (B, H, nc) fp32 exp(cum_last), or null
  int L, H, G, P, S, Q, nc, ncs;   // ncs: chunks whose dS is computed
  int ldp;        // P rounded up to 4
  int vec;        // x, B and C rows 16-byte aligned
};

__device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The smallest power of two >= v (v <= kSMax).
__device__ __forceinline__ int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Rows [0, R) x columns [0, C) of a matrix with row stride s_r (elements)
// and unit column stride into shared memory (leading dim ld), zero past nr
// rows and nc columns; C is a power of two of 16-byte vectors.  With
// 16-byte aligned rows (vec) through cp.async, part of the caller's next
// commit group; else plain loads, visible after the caller's barrier.
template <typename T>
__device__ void load_rows(T* s, int ld, const T* g, long long s_r, int R, int C, int nr, int nc,
                          bool vec) {
  constexpr int V = 16 / (int)sizeof(T);
  int lg = 0;
  while ((V << lg) < C) ++lg;
  for (int idx = threadIdx.x; idx < (R << lg); idx += kSsdThreads) {
    const int r = idx >> lg, col = (idx & ((1 << lg) - 1)) * V;
    T* d = s + r * ld + col;
    const T* src = g + r * s_r + col;
    if (vec) {
      const int valid = r < nr ? max(0, min(V, nc - col)) : 0;
      cp_async16(d, valid ? src : g, valid * (int)sizeof(T));
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) d[v] = (r < nr && col + v < nc) ? src[v] : from_f<T>(0.0f);
    }
  }
}

// dt of the chunk's kQMax rows (0 past its nv valid rows) into dts.
__device__ __forceinline__ void load_dt(float* dts, const float* dtp, long long dt_l, int nv) {
  for (int r = threadIdx.x; r < kQMax; r += kSsdThreads)
    dts[r] = r < nv ? dtp[r * dt_l] : 0.0f;
}

// cum[r] = sum_{k <= r} (double)(dts[k] * neg_a) for every r < kQMax, by
// warp 0: lane l sums rows 4l .. 4l + 3 in order, a shuffle scan adds the
// lanes before it.  Past the valid rows dt is 0, so cum stays at the last
// valid row's value.  Needs dts visible; the caller syncs after.
__device__ __forceinline__ void chunk_cum(const float* dts, float neg_a, double* cum) {
  if (threadIdx.x >= 32) return;
  const int l = threadIdx.x;
  double v[4], run = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = run += (double)(dts[4 * l + i] * neg_a);
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (l >= o) incl += u;
  }
  double ex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (l == 0) ex = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) cum[4 * l + i] = ex + v[i];
}

// xd[r][p] = x[r][p] * dts[r] in fp32 for r < R, p < kPMax (0 past nv rows
// and P columns); x rows at stride x_l, read 16 bytes a thread when
// aligned.
template <typename T>
__device__ void load_xd(float* xd, const T* xp, long long x_l, const float* dts, int R, int nv,
                        int P, bool vec) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int CV = kPMax / V;
  for (int idx = threadIdx.x; idx < R * CV; idx += kSsdThreads) {
    const int r = idx / CV, p = (idx % CV) * V;
    float v[V];
    const T* src = xp + r * x_l + p;
    if (vec && r < nv && p + V <= P) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = to_f(e[u]);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = (r < nv && p + u < P) ? to_f(src[u]) : 0.0f;
    }
    const float d = dts[r];
#pragma unroll
    for (int u = 0; u < V; u += 4)
      *reinterpret_cast<float4*>(xd + r * kLdX + p + u) =
          make_float4(v[u] * d, v[u + 1] * d, v[u + 2] * d, v[u + 3] * d);
  }
}

// Four consecutive floats of shared memory (16 bytes).
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// The thread's rows and columns of `fma_tile`'s 64 x 64 tile: warp w
// covers rows 16 (w >> 1) .. + 16 and columns 32 (w & 1) .. + 32, lane
// (ty, tx) = (lane / 8, lane % 8).  With a k-major operand the thread's
// four rows (columns) are consecutive; with a row-major one they are 4
// (8) apart, so a warp's four (eight) concurrent 16-byte reads fall in
// different banks.
template <bool AK> __device__ __forceinline__ int tile_row(int r) {
  const int w = threadIdx.x >> 5, ty = (threadIdx.x & 31) >> 3;
  return 16 * (w >> 1) + (AK ? 4 * ty + r : ty + 4 * r);
}
template <bool BK> __device__ __forceinline__ int tile_col(int c) {
  const int w = threadIdx.x >> 5, tx = threadIdx.x & 7;
  return 32 * (w & 1) + (BK ? 4 * tx + c : tx + 8 * c);
}

// acc[r][c] += sum_{k < K} A(tile_row(r), k) * B(k, tile_col(c)), k in
// ascending order, in fp32 FMAs; K a multiple of 4.
//   A k-major (AK): A(m, k) = a[k * lda + m]; else row-major: a[m * lda + k]
//   B k-major (BK): B(k, n) = b[k * ldb + n]; else n-major:   b[n * ldb + k]
// Every operand row is 16-byte aligned.
template <bool AK, bool BK>
__device__ __forceinline__ void fma_tile(float (&acc)[4][4], const float* a, int lda,
                                         const float* b, int ldb, int K) {
  const float* pa = AK ? a + tile_row<true>(0) : a + tile_row<false>(0) * lda;
  const float* pb = BK ? b + tile_col<true>(0) : b + tile_col<false>(0) * ldb;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float av[4][4], bv[4][4];   // av[r][kk], bv[kk][c]
    if (AK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float t[4];
        ld4(pa + (k + kk) * lda, t);
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r][kk] = t[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) ld4(pa + 4 * r * lda + k, av[r]);
    }
    if (BK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ld4(pb + (k + kk) * ldb, bv[kk]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float t[4];
        ld4(pb + 8 * c * ldb + k, t);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) bv[kk][c] = t[kk];
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r][kk], bv[kk][c], acc[r][c]);
  }
}

// One score: (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0 (selected,
// never multiplied: exp overflows there under a strong decay).
__device__ __forceinline__ float decayed(float v, int i, int j, const double* cum) {
  return j <= i ? v * expf((float)(cum[i] - cum[j])) : 0.0f;
}

// The bf16 route keeps an fp32 operand v as two bf16 terms, hi = bf16(v)
// and lo = bf16(v - hi), with |v - hi - lo| <= 2^-18 |v| (K7 splits P the
// same way); a product with one fp32 operand takes two MMAs (hi, lo), one
// with two fp32 operands three (hi hi, hi lo, lo hi; lo lo is below the
// split's residual).  Sums stay fp32 in the MMAs' accumulators.
// split2: hi and lo of two neighbouring values, one bf16x2 register each.
__device__ __forceinline__ void split2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Four consecutive values split: hi at h, lo at h + off (8 bytes each).
__device__ __forceinline__ void put_split4(bf16* h, int off, float a, float b, float c, float d) {
  uint2 hi, lo;
  split2(a, b, hi.x, lo.x);
  split2(c, d, hi.y, lo.y);
  *reinterpret_cast<uint2*>(h) = hi;
  *reinterpret_cast<uint2*>(h + off) = lo;
}

// The strip's scores for r < kStrip, j < jn (a multiple of 16): C rows of
// the strip (cs, from row i0 of the chunk) against B rows (bs).  bf16:
// m16n8k16 MMAs, warp w on rows 16 (w & 3) .. + 16 and columns 64 (w >> 2)
// .. + 64 below jn, B read as mma's column-major operand from its rows
// (strip_mma's BT addressing); the decayed scores go to shared memory
// split in two bf16 terms (`split2`), hi at sh, lo at sh + kStrip * kLdSh.
// fp32: `fma_tile`, 64 columns a pass, into sc.
__device__ void strip_scores(bf16* sh, const bf16* cs, const bf16* bs, const double* cum, int i0,
                             int jn, int Sk) {
  constexpr int ld = ld_cb<bf16>();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mr = 16 * (w & 3), nb = 64 * (w >> 2);
  const int nt = min(8, max(0, (jn - nb) / 8));   // n8 tiles, even
  if (nt == 0) return;
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
  const bf16* pa = cs + (mr + (lane & 15)) * ld + (lane >> 4) * 8;
  const bf16* pb = bs + (nb + (lane & 7) + 8 * (lane >> 4)) * ld + ((lane >> 3) & 1) * 8;
  for (int kk = 0; kk < Sk; kk += 16) {
    unsigned af[4];
    ldsm_x4(af, pa + kk);
#pragma unroll
    for (int t = 0; t < 8; t += 2) {
      if (t >= nt) break;
      unsigned bfr[4];
      ldsm_x4(bfr, pb + 8 * t * ld + kk);
      mma_16816(acc[t], af, bfr[0], bfr[1]);
      mma_16816(acc[t + 1], af, bfr[2], bfr[3]);
    }
  }
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t >= nt) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = mr + g + 8 * half, j = nb + 8 * t + 2 * q;
      unsigned hi, lo;
      split2(decayed(acc[t][2 * half], i0 + r, j, cum),
             decayed(acc[t][2 * half + 1], i0 + r, j + 1, cum), hi, lo);
      *reinterpret_cast<unsigned*>(sh + r * kLdSh + j) = hi;
      *reinterpret_cast<unsigned*>(sh + kStrip * kLdSh + r * kLdSh + j) = lo;
    }
  }
}
__device__ void strip_scores(float* sc, const float* cs, const float* bs, const double* cum,
                             int i0, int jn, int Sk) {
  constexpr int ld = ld_cb<float>();
  for (int nb = 0; nb < jn; nb += 64) {
    float acc[4][4] = {};
    fma_tile<false, false>(acc, cs, ld, bs + nb * ld, ld, Sk);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = tile_row<false>(r);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = nb + tile_col<false>(c);
        sc[m * kLdSc + j] = decayed(acc[r][c], i0 + m, j, cum);
      }
    }
  }
}

// w[r] = exp(cum_last - cum_r) for r < kQMax: the weights of x dt in the
// chunk's state (1 past the chunk's rows, where x is 0).  Threads < kQMax;
// the caller syncs before reading.
__device__ __forceinline__ void state_weights(float* wv, const double* cum, int nv) {
  if (threadIdx.x < kQMax) wv[threadIdx.x] = expf((float)(cum[nv - 1] - cum[threadIdx.x]));
}

// fp32 route: xd[r][:] *= w[r] for r < nv (the columns past P stay 0).
__device__ __forceinline__ void weight_xd(float* xd, const float* wv, int nv) {
  for (int idx = threadIdx.x; idx < nv * kPMax; idx += kSsdThreads) {
    const int r = idx / kPMax, p = idx % kPMax;
    xd[r * kLdX + p] *= wv[r];
  }
}

// fp32 route: B^T @ (w x dt) for the 64 state rows at s0: bs holds B's rows
// (leading dim ldb) with column s0 at bs, xd the weighted x dt; K = nv
// rounded up to 4 (rows past nv are 0 in both).
__device__ __forceinline__ void chunk_state_tile(float (&acc)[4][4], const float* bs, int ldb,
                                                 const float* xd, int nv) {
  fma_tile<true, true>(acc, bs, ldb, xd, kLdX, round_up(nv, 4));
}

// ---- the bf16 route: every product on the tensor cores ------------------
// A warp's 16 x 32 tile, acc[t] holding columns 8t .. 8t + 7 in m16n8
// layout (x[0], x[1] at row lane / 4, columns 2 (lane % 4) + {0, 1}; x[2],
// x[3] eight rows below), += sum over the term pairs of A_i @ B_j, k in
// 16-deep steps up to K: A (16 x K) from a, row-major (lda), or k-major
// (AT: a[k * lda + m], read with ldmatrix.trans); its lo term (NA == 2) at
// a + aoff.  B (K x 32) row-major [k][n] from b (ldb), its lo term (NB ==
// 2) at b + boff.  Pairs: (hi, hi), (hi, lo), (lo, hi).
template <int NA, int NB, bool AT>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const bf16* a, int lda, int aoff,
                                         const bf16* b, int ldb, int boff, int K) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = AT ? a + ((lane & 7) + 8 * (lane >> 4)) * lda + 8 * ((lane >> 3) & 1)
                      : a + (lane & 15) * lda + (lane >> 4) * 8;
  const bf16* pb = b + (lane & 15) * ldb + (lane >> 4) * 8;
  for (int kk = 0; kk < K; kk += 16) {
    unsigned af[NA][4], bfr[NB][2][4];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (AT)
        ldsm_x4_trans(af[i], pa + i * aoff + kk * lda);
      else
        ldsm_x4(af[i], pa + i * aoff + kk);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) ldsm_x4_trans(bfr[j][h], pb + j * boff + kk * ldb + 16 * h);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (i == 1 && j == 1) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma_16816(acc[2 * h], af[i], bfr[j][h][0], bfr[j][h][1]);
          mma_16816(acc[2 * h + 1], af[i], bfr[j][h][2], bfr[j][h][3]);
        }
      }
  }
}

// The row and column of element e of acc[t] in `mma_tile`'s 64 x 64
// layout: warp w on rows 16 (w & 3) .. + 16, columns 32 (w >> 2) .. + 32.
__device__ __forceinline__ int mma_row(int e) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int mma_col(int t, int e) {
  return 32 * (threadIdx.x >> 7) + 8 * t + 2 * (threadIdx.x & 3) + (e & 1);
}

// x rows of a chunk held in registers as 16-byte vectors: vector k of
// thread t is row (t + 256 k) / 8, columns 8 ((t + 256 k) % 8) .. + 8, for
// all kQMax rows (0 past R and nv rows and past P columns).  Loaded early,
// so the loads overlap the rest of the CTA's set-up, and split into shared
// memory once as x dt and, for the chunk's state, once as (x dt) w.
struct XRegs {
  static constexpr int N = kQMax * kPMax / 8 / kSsdThreads;
  uint4 v[N];
  __device__ __forceinline__ void load(const bf16* xp, long long x_l, int R, int nv, int P,
                                       bool vec) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * kSsdThreads, r = idx >> 3, p = (idx & 7) * 8;
      const bf16* src = xp + r * x_l + p;
      if (r < R && r < nv && vec && p + 8 <= P) {
        v[k] = *reinterpret_cast<const uint4*>(src);
      } else {
        unsigned q[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool in0 = r < R && r < nv && p + 2 * u < P;
          const bool in1 = r < R && r < nv && p + 2 * u + 1 < P;
          q[u] = (in0 ? (unsigned)__bfloat16_as_ushort(src[2 * u]) : 0u) |
                 (in1 ? (unsigned)__bfloat16_as_ushort(src[2 * u + 1]) << 16 : 0u);
        }
        v[k] = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
  }
  // hi / lo rows of kLdH at h and h + kQMax * kLdH: x dt, times w if given.
  __device__ __forceinline__ void put(bf16* h, const float* dts, const float* wv) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * kSsdThreads, r = idx >> 3, p = (idx & 7) * 8;
      const unsigned* q = reinterpret_cast<const unsigned*>(&v[k]);
      float f[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        f[2 * u] = __uint_as_float(q[u] << 16) * dts[r];
        f[2 * u + 1] = __uint_as_float(q[u] & 0xffff0000u) * dts[r];
      }
      if (wv) {
#pragma unroll
        for (int u = 0; u < 8; ++u) f[u] *= wv[r];
      }
      bf16* d = h + r * kLdH + p;
      put_split4(d, kQMax * kLdH, f[0], f[1], f[2], f[3]);
      put_split4(d + 4, kQMax * kLdH, f[4], f[5], f[6], f[7]);
    }
  }
};

// The incoming state (S rows of ldp fp32 from the workspace) in
// registers, then split into hi / lo rows of kLdH (all kSMax rows and kPMax
// columns, 0 past S and ldp).
struct StateRegs {
  static constexpr int N = kSMax * kPMax / 4 / kSsdThreads;
  float4 v[N];
  __device__ __forceinline__ void load(const float* src, int S, int ldp) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * kSsdThreads, r = idx >> 4, p = (idx & 15) * 4;
      v[k] = (r < S && p < ldp) ? *reinterpret_cast<const float4*>(src + r * ldp + p)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __device__ __forceinline__ void put(bf16* h) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * kSsdThreads, r = idx >> 4, p = (idx & 15) * 4;
      put_split4(h + r * kLdH + p, kQMax * kLdH, v[k].x, v[k].y, v[k].z, v[k].w);
    }
  }
};

// B^T @ (w x dt) for the 64 state rows at column s0 of bs (B's rows, leading
// dim ldb, k-major for this product) against the split weighted x dt at
// xh; K = nv rounded up to 16.
__device__ __forceinline__ void chunk_state_mma(float (&acc)[4][4], const bf16* bs, int ldb,
                                                const bf16* xh, int nv) {
  const int w = threadIdx.x >> 5;
  mma_tile<1, 2, true>(acc, bs + 16 * (w & 3), ldb, 0, xh + 32 * (w >> 2), kLdH, kQMax * kLdH,
                       round_up(nv, 16));
}

// Store the bf16 route's 64 x 64 state tile: rows s0 + row of an (S, ld)
// fp32 plane, the columns below nc (pairs at once with vec: ld even and
// nc == ld).
__device__ __forceinline__ void store_state(float* out, const float (&acc)[4][4], int s0, int S,
                                            int ld, int nc, bool vec) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = s0 + mma_row(2 * half), p = mma_col(t, 0);
      if (s >= S || p >= nc) continue;
      if (vec) {
        *reinterpret_cast<float2*>(out + s * ld + p) =
            make_float2(acc[t][2 * half], acc[t][2 * half + 1]);
      } else {
        out[s * ld + p] = acc[t][2 * half];
        if (p + 1 < nc) out[s * ld + p + 1] = acc[t][2 * half + 1];
      }
    }
}

// 1. dS_c and exp(cum_last) per (batch row, head, chunk, 64 rows of S).
template <typename T>
__global__ void __launch_bounds__(kSsdThreads) ssd_chunk_state_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + kQMax);
  float* wv = dts + kQMax;
  T* bs = reinterpret_cast<T*>(smem + kHead);                         // [kQMax][ld_sb]
  unsigned char* rx = smem + kHead + kQMax * ld_sb<T>() * sizeof(T);
  float* xd = reinterpret_cast<float*>(rx);                          // fp32: [kQMax][kLdX]
  bf16* xh = reinterpret_cast<bf16*>(rx);                            // bf16: split [kQMax][kLdH]

  const int nsb = (a.S + kSBlk - 1) / kSBlk;
  int t = blockIdx.x;
  const int sb = t % nsb;
  t /= nsb;
  const int h = t % a.H, c = t / a.H;
  const long long b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int c0 = c * a.Q, nv = min(a.Q, a.L - c0), s0 = sb * kSBlk;
  const float neg_a = -expf(a.a_log[h]);
  const T* xp = static_cast<const T*>(a.x) + b * a.x_b + h * a.x_h + c0 * a.x_l;
  const float* dtp = a.dt + b * a.dt_b + h * a.dt_h + c0 * a.dt_l;
  const T* bp = static_cast<const T*>(a.bm) + b * a.b_b + g * a.b_g + c0 * a.b_l + s0;
  const int kr = round_up(nv, 16);
  float* out = a.ws + ((b * a.H + h) * a.nc + c) * (long long)a.S * a.ldp;

  load_rows(bs, ld_sb<T>(), bp, a.b_l, kr, kSBlk, nv, a.S - s0, a.vec);
  cp_async_commit();
  if constexpr (sizeof(T) == 2) {
    XRegs xr;
    xr.load(xp, a.x_l, kr, nv, a.P, a.vec);
    load_dt(dts, dtp, a.dt_l, nv);
    __syncthreads();
    chunk_cum(dts, neg_a, cum);
    __syncthreads();
    state_weights(wv, cum, nv);
    if (sb == 0 && threadIdx.x == 0)
      a.decay[(b * a.H + h) * a.nc + c] = expf((float)cum[nv - 1]);
    __syncthreads();
    xr.put(xh, dts, wv);
    cp_async_wait_all();
    __syncthreads();
    float acc[4][4] = {};
    chunk_state_mma(acc, bs, ld_sb<T>(), xh, nv);
    store_state(out, acc, s0, a.S, a.ldp, a.ldp, true);
  } else {
    load_dt(dts, dtp, a.dt_l, nv);
    __syncthreads();
    chunk_cum(dts, neg_a, cum);
    load_xd(xd, xp, a.x_l, dts, kr, nv, a.P, a.vec);
    __syncthreads();
    state_weights(wv, cum, nv);
    if (sb == 0 && threadIdx.x == 0)
      a.decay[(b * a.H + h) * a.nc + c] = expf((float)cum[nv - 1]);
    __syncthreads();
    weight_xd(xd, wv, nv);
    cp_async_wait_all();
    __syncthreads();
    float acc[4][4] = {};
    chunk_state_tile(acc, bs, ld_sb<T>(), xd, nv);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = s0 + tile_row<true>(r);
      const int p = tile_col<true>(0);
      if (s < a.S && p < a.ldp)
        *reinterpret_cast<float4*>(out + s * a.ldp + p) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// 2. The state pass: per (batch row, head) and four elements of the (S,
// ldp) plane, state_c = state_{c-1} * exp(cum_last_c) + dS_c over the
// chunks in order (state_{-1} = 0); chunk c > 0's slot gets its incoming
// state.  Eight chunks' dS are read ahead of their updates.
constexpr int kPassThreads = 256;
constexpr int kPassAhead = 8;
__global__ void __launch_bounds__(kPassThreads) ssd_state_pass_kernel(
    float* ws, const float* decay, float* state, int H, int nc, int ncs, int S, int P, int ldp) {
  const int plane4 = S * ldp / 4;
  const int e4 = blockIdx.x * kPassThreads + threadIdx.x;
  if (e4 >= plane4) return;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float4* w = reinterpret_cast<float4*>(ws + bh * nc * (long long)S * ldp) + e4;
  const float* dk = decay + bh * nc;
  float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < nc; c0 += kPassAhead) {
    float4 d[kPassAhead];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u)
      if (c0 + u < ncs) d[u] = w[(long long)(c0 + u) * plane4];
#pragma unroll
    for (int u = 0; u < kPassAhead; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      if (c > 0) w[(long long)c * plane4] = st;
      if (c < ncs) {
        const float e = dk[c];
        st = make_float4(st.x * e + d[u].x, st.y * e + d[u].y, st.z * e + d[u].z,
                         st.w * e + d[u].w);
      }
    }
  }
  if (state) {
    const int e = 4 * e4, s = e / ldp, p = e - s * ldp;
    const float v[4] = {st.x, st.y, st.z, st.w};
    float* out = state + (bh * S + s) * P;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (p + u < P) out[p + u] = v[u];
  }
}

// fp32 route: store the thread's n <= 4 columns of a y row; all four in
// one aligned vector when n == 4 and P % 4 == 0.
__device__ __forceinline__ void store4(float* y, const float (&v)[4], int n, bool vec) {
  if (n == 4 && vec) {
    *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int u = 0; u < n; ++u) y[u] = v[u];
  }
}

// 3. The readout per (batch row, head, chunk, strip of 64 rows).  Shared
// regions: X holds the C strip, then x dt; Y holds B; Z holds the incoming
// state, then the scores (bf16 route: x dt, the state and the scores as
// split pairs).  Without a workspace (one chunk) the incoming state is 0
// and the CTA also writes the state for the S blocks strip, strip +
// strips, ...
template <typename T>
__global__ void __launch_bounds__(kSsdThreads, sizeof(T) == 2 ? 2 : 1) ssd_scan_kernel(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ldc = ld_cb<T>();
  double* cum = reinterpret_cast<double*>(smem);
  float* dts = reinterpret_cast<float*>(cum + kQMax);
  float* wv = dts + kQMax;
  unsigned char* rx = smem + kHead;
  T* cs = reinterpret_cast<T*>(rx);                                  // [kStrip][ldc]
  T* bs = reinterpret_cast<T*>(rx + region_xz<T>());                 // [kQMax][ldc]
  unsigned char* rz = rx + region_xz<T>() + kQMax * ldc * sizeof(T);

  const int nstrip = (a.Q + kStrip - 1) / kStrip;
  int t = blockIdx.x;
  const int strip = t % nstrip;
  t /= nstrip;
  const int h = t % a.H, c = t / a.H;
  const long long b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int c0 = c * a.Q, nv = min(a.Q, a.L - c0), i0 = strip * kStrip;
  const int rows = min(kStrip, nv - i0);
  const bool fused = a.ws == nullptr;
  if (rows <= 0) return;   // a strip past a short last chunk (never with one chunk)
  const bool inter = !fused && c > 0;
  const int jmax = i0 + rows, jn = round_up(jmax, 16);
  const int kr = fused ? max(jn, round_up(nv, 16)) : jn;   // B and x dt rows needed
  const int sk = round_up(a.S, sizeof(T) == 2 ? 16 : 4);
  const int cload = pow2_ceil(sk);
  const float neg_a = -expf(a.a_log[h]);
  const T* xp = static_cast<const T*>(a.x) + b * a.x_b + h * a.x_h + c0 * a.x_l;
  const float* dtp = a.dt + b * a.dt_b + h * a.dt_h + c0 * a.dt_l;
  const T* bp = static_cast<const T*>(a.bm) + b * a.b_b + g * a.b_g + c0 * a.b_l;
  const T* cp = static_cast<const T*>(a.cm) + b * a.c_b + g * a.c_g + (c0 + i0) * a.c_l;
  const float* sp =
      inter ? a.ws + ((b * a.H + h) * a.nc + c) * (long long)a.S * a.ldp : nullptr;
  T* yp = static_cast<T*>(a.y) + ((b * a.L + c0 + i0) * a.H + h) * (long long)a.P;
  const long long y_l = (long long)a.H * a.P;
  const int nsb = (a.S + kSBlk - 1) / kSBlk;
  float* st_out = a.state ? a.state + (b * a.H + h) * (long long)a.S * a.P : nullptr;

  if constexpr (sizeof(T) == 2) {
    bf16* xh = reinterpret_cast<bf16*>(rx);     // split x dt [kQMax][kLdH]
    bf16* zh = reinterpret_cast<bf16*>(rz);     // split state [kSMax][kLdH], then scores
    const int w = threadIdx.x >> 5;
    load_rows(cs, ldc, cp, a.c_l, kStrip, cload, rows, a.S, a.vec);
    cp_async_commit();
    load_rows(bs, ldc, bp, a.b_l, kr, cload, nv, a.S, a.vec);
    cp_async_commit();
    StateRegs sr;
    if (inter) sr.load(sp, a.S, a.ldp);
    XRegs xr;
    xr.load(xp, a.x_l, kr, nv, a.P, a.vec);
    load_dt(dts, dtp, a.dt_l, nv);
    __syncthreads();
    chunk_cum(dts, neg_a, cum);
    if (inter) sr.put(zh);
    __syncthreads();   // cum and the split state visible
    if (fused) state_weights(wv, cum, nv);

    float ys[4][4] = {};
    if (inter) {   // C @ state_{c-1}
      cp_async_wait_n(1);
      __syncthreads();
      mma_tile<1, 2, false>(ys, cs + 16 * (w & 3) * ldc, ldc, 0, zh + 32 * (w >> 2), kLdH,
                            kQMax * kLdH, round_up(a.S, 16));
    }
    cp_async_wait_n(0);
    __syncthreads();   // B, C visible; the state no longer read
    strip_scores(zh, cs, bs, cum, i0, jn, sk);
    __syncthreads();   // scores visible; C no longer read
    xr.put(xh, dts, nullptr);
    __syncthreads();

    float yi[4][4] = {};
    mma_tile<2, 2, false>(yi, zh + 16 * (w & 3) * kLdSh, kLdSh, kStrip * kLdSh,
                          xh + 32 * (w >> 2), kLdH, kQMax * kLdH, jn);
    const bool pairs = (a.P & 1) == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mma_row(2 * half);
      if (m >= rows) continue;
      const float e = expf((float)cum[i0 + m]);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const int p = mma_col(tt, 0);
        if (p >= a.P) continue;
        const float v0 = yi[tt][2 * half] + e * ys[tt][2 * half];
        const float v1 = yi[tt][2 * half + 1] + e * ys[tt][2 * half + 1];
        bf16* dst = yp + m * y_l + p;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = from_f<bf16>(v0);
          if (p + 1 < a.P) dst[1] = from_f<bf16>(v1);
        }
      }
    }

    if (fused && st_out) {   // one chunk: the state is its dS
      __syncthreads();
      xr.put(xh, dts, wv);
      __syncthreads();
      for (int sb = strip; sb < nsb; sb += nstrip) {
        float acc[4][4] = {};
        chunk_state_mma(acc, bs + sb * kSBlk, ldc, xh, nv);
        store_state(st_out, acc, sb * kSBlk, a.S, a.P, a.P, false);
      }
    }
  } else {
    float* xd = reinterpret_cast<float*>(rx);   // [kQMax][kLdX]
    float* sin_ = reinterpret_cast<float*>(rz);  // [kSMax][kLdX], then the scores
    float* sc = sin_;                            // [kStrip][kLdSc]
    load_rows(cs, ldc, cp, a.c_l, kStrip, cload, rows, a.S, a.vec);
    if (inter) load_rows(sin_, kLdX, sp, a.ldp, round_up(a.S, 4), kPMax, a.S, a.ldp, true);
    cp_async_commit();
    load_rows(bs, ldc, bp, a.b_l, kr, cload, nv, a.S, a.vec);
    cp_async_commit();
    load_dt(dts, dtp, a.dt_l, nv);
    __syncthreads();
    chunk_cum(dts, neg_a, cum);

    float ys[4][4] = {};
    if (inter) {   // C @ state_{c-1}
      cp_async_wait_n(1);
      __syncthreads();
      fma_tile<false, true>(ys, cs, ldc, sin_, kLdX, round_up(a.S, 4));
    }
    cp_async_wait_n(0);
    __syncthreads();   // B, C and cum visible; the state no longer read
    if (fused) state_weights(wv, cum, nv);
    strip_scores(sc, cs, bs, cum, i0, jn, sk);
    __syncthreads();   // scores visible; C no longer read
    load_xd(xd, xp, a.x_l, dts, kr, nv, a.P, a.vec);
    __syncthreads();

    float yi[4][4] = {};
    fma_tile<false, true>(yi, sc, kLdSc, xd, kLdX, jn);
    const int p = tile_col<true>(0), np = min(4, a.P - p);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = tile_row<false>(r);
      if (m >= rows || p >= a.P) continue;
      const float e = expf((float)cum[i0 + m]);
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = yi[r][u] + e * ys[r][u];
      store4(yp + m * y_l + p, v, np, (a.P & 3) == 0);
    }

    if (fused && st_out) {   // one chunk: the state is its dS
      __syncthreads();
      weight_xd(xd, wv, nv);
      __syncthreads();
      for (int sb = strip; sb < nsb; sb += nstrip) {
        float acc[4][4] = {};
        chunk_state_tile(acc, bs + sb * kSBlk, ldc, xd, nv);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int s = sb * kSBlk + tile_row<true>(r);
          if (s >= a.S) continue;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (p + u < a.P) st_out[s * a.P + p + u] = acc[r][u];
        }
      }
    }
  }
}

inline bool aligned16(const void* p, long long s0, long long s1, long long s2, int V) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && s0 % V == 0 && s1 % V == 0 &&
         s2 % V == 0;
}

template <typename T>
int ssd_check(const SsdArgs& a, int batch) {
  if (batch < 1 || batch > 65535 || a.H < 1 || a.G < 1 || a.H % a.G || a.P < 1 ||
      a.P > kPMax || a.S < 1 || a.S > kSMax || a.Q < 1 || a.Q > kQMax || a.L < 1 ||
      a.nc != (a.L + a.Q - 1) / a.Q || a.ldp != (a.P + 3) / 4 * 4)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch_chunk_state(SsdArgs a, int batch, cudaStream_t stream) {
  if (int err = ssd_check<T>(a, batch)) return err;
  if (!a.ws || !a.decay || a.ncs < 1 || a.ncs > a.nc) return (int)cudaErrorInvalidValue;
  constexpr int smem = chunk_state_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long gx = (long long)a.ncs * a.H * ((a.S + kSBlk - 1) / kSBlk);
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_chunk_state_kernel<T><<<dim3((unsigned)gx, batch), kSsdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_readout(SsdArgs a, int batch, cudaStream_t stream) {
  if (int err = ssd_check<T>(a, batch)) return err;
  if (!a.ws && a.nc != 1) return (int)cudaErrorInvalidValue;
  constexpr int smem = readout_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long gx = (long long)a.nc * a.H * ((a.Q + kStrip - 1) / kStrip);
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_scan_kernel<T><<<dim3((unsigned)gx, batch), kSsdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

SsdArgs make_args(int is_bf16, const void* x, long long x_b, long long x_l, long long x_h,
                  const void* dt, long long dt_b, long long dt_l, long long dt_h,
                  const void* a_log, const void* bm, long long b_b, long long b_l,
                  long long b_g, const void* cm, long long c_b, long long c_l, long long c_g,
                  void* y, void* state, void* ws, void* decay, int L, int H, int G, int P,
                  int S, int chunk, int ncs) {
  const int V = is_bf16 ? 8 : 4;
  const int q = chunk < L ? chunk : L;   // one chunk of L rows when L <= chunk
  const bool vec = aligned16(x, x_b, x_l, x_h, V) && aligned16(bm, b_b, b_l, b_g, V) &&
                   aligned16(cm ? cm : bm, c_b, c_l, c_g, V);
  return SsdArgs{x, x_b, x_l, x_h, static_cast<const float*>(dt), dt_b, dt_l, dt_h,
                 static_cast<const float*>(a_log), bm, b_b, b_l, b_g, cm, c_b, c_l, c_g, y,
                 static_cast<float*>(state), static_cast<float*>(ws),
                 static_cast<float*>(decay), L, H, G, P, S, q, (L + q - 1) / q, ncs,
                 (P + 3) / 4 * 4, vec ? 1 : 0};
}

}  // namespace rt

// The three launches of one scan, each returning the cudaError_t of its
// launch.  x (batch, L, H, P) and b, c (batch, L, G, S) in one type (bf16
// if is_bf16, else fp32), read through their (batch, step, head / group)
// strides in elements with a unit stride along P / S; dt (batch, L, H) fp32
// through its strides; a_log (H,) fp32; y (batch, L, H, P) contiguous,
// x's type; state (batch, H, S, P) fp32 or null; ws (batch, H, nc, S, P
// rounded up to 4) and decay (batch, H, nc) fp32, nc = ceil(L / min(chunk,
// L)).  Limits: P <= 64, S <= 128, 1 <= chunk <= 128, H % G == 0.
//
// rt_ssd_chunk_state: dS and exp(cum_last) of the first ncs chunks.
extern "C" int rt_ssd_chunk_state(int is_bf16, const void* x, long long x_b, long long x_l,
                                  long long x_h, const void* dt, long long dt_b, long long dt_l,
                                  long long dt_h, const void* a_log, const void* bm,
                                  long long b_b, long long b_l, long long b_g, void* ws,
                                  void* decay, int batch, int L, int H, int G, int P, int S,
                                  int chunk, int ncs, void* stream) {
  const rt::SsdArgs a = rt::make_args(is_bf16, x, x_b, x_l, x_h, dt, dt_b, dt_l, dt_h, a_log, bm,
                                      b_b, b_l, b_g, nullptr, 0, 0, 0, nullptr, nullptr, ws,
                                      decay, L, H, G, P, S, chunk, ncs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return rt::launch_chunk_state<rt::bf16>(a, batch, s);
  return rt::launch_chunk_state<float>(a, batch, s);
}

// rt_ssd_state_pass: incoming states over ws in place; with a state
// pointer (ncs == nc) also the state after the last chunk.
extern "C" int rt_ssd_state_pass(void* ws, const void* decay, void* state, int batch, int H,
                                 int nc, int ncs, int S, int P, void* stream) {
  const int ldp = (P + 3) / 4 * 4;
  if (!ws || !decay || batch < 1 || batch > 65535 || H < 1 || H > 65535 || nc < 2 ||
      ncs < nc - 1 || ncs > nc || (state && ncs != nc) || S < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const int plane4 = S * ldp / 4;
  dim3 grid((plane4 + rt::kPassThreads - 1) / rt::kPassThreads, H, batch);
  rt::ssd_state_pass_kernel<<<grid, rt::kPassThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(ws), static_cast<const float*>(decay), static_cast<float*>(state), H,
      nc, ncs, S, P, ldp);
  return (int)cudaGetLastError();
}

// rt_ssd_scan: y from the incoming states in ws; with ws null (one chunk)
// from a zero state, also writing the state when asked.
extern "C" int rt_ssd_scan(int is_bf16, const void* x, long long x_b, long long x_l,
                           long long x_h, const void* dt, long long dt_b, long long dt_l,
                           long long dt_h, const void* a_log, const void* bm, long long b_b,
                           long long b_l, long long b_g, const void* cm, long long c_b,
                           long long c_l, long long c_g, void* y, void* state, void* ws,
                           int batch, int L, int H, int G, int P, int S, int chunk,
                           void* stream) {
  const rt::SsdArgs a = rt::make_args(is_bf16, x, x_b, x_l, x_h, dt, dt_b, dt_l, dt_h, a_log, bm,
                                      b_b, b_l, b_g, cm, c_b, c_l, c_g, y,
                                      ws ? nullptr : state, ws, nullptr, L, H, G, P, S, chunk,
                                      0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return rt::launch_readout<rt::bf16>(a, batch, s);
  return rt::launch_readout<float>(a, batch, s);
}
