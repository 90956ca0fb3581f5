// Flash attention (K7), hand-written for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (body
//   _fa_kernel): online-softmax attention with a causal mask, a sliding
//   window (col > row - window), a tanh soft-cap applied after the scale
//   (softcap * tanh(s / softcap)), and GQA / MQA through kv head =
//   q head / (Hq / Hkv).  Masked scores are -1e30 and their p is zeroed;
//   the output is acc / max(l, 1e-30), cast once to q's type.
//
// Grid: one CTA per (q head, batch row, q tile), the q tiles launched
// last-first so the longest causal rows start earliest.  The Pallas grid's
// sequential kv dim is the loop inside the CTA.  Only the kv tiles some
// row of the q tile can see are walked (the TPU kernel's `reachable`: none
// past the causal frontier of the tile's last row, none wholly older than
// the window of its first row).  K and V are read at the kv head's rows
// through their strides: nothing is materialised per q head.  Ragged Sq
// and Skv are masked (rows past Sq are neither stored nor read back,
// columns past Skv are zero-filled and masked), so no length has to divide
// a tile.
//
// Head widths: q and k share D, v (and the output) have DV <= D, both
// multiples of 16 (MLA's prefill runs D 192, DV 128; every other caller
// DV = D).  V's rows sit in shared memory at K's pitch, so one walk copies
// both; only O's registers and the P@V loop shrink to DV.
//
// Bound on the H100: at prefill lengths, operations — QK^T and PV are
// 2 * (D + DV) flops per visible (row, col) pair and q head (2 * D + 4 *
// DV as the kernel runs them, P@V twice for P's two terms, below); at the
// serving prefill of 4 x 128 tokens, bytes and launch latency.
//
// bf16 (the served route, `fa_mma_kernel`): S, P and O live in registers.
// Each warp owns 16 rows of the q tile (128 rows and 8 warps by default; any
// multiple of 16 up to 128) and runs QK^T and P@V as mma.sync m16n8k16
// (fp32 accumulate) from ldmatrix-read tiles: Q is copied once per CTA, K
// as its own rows (16 bytes a thread) and read untransposed, which is
// mma.sync's column-major B for K^T, V read with ldmatrix.trans.  The
// online softmax runs on the accumulator fragments: a lane holds two rows'
// values, the row max and sum are reduced over the 4 lanes of a row with
// __shfl_xor_sync, O is rescaled in registers, and P's terms are packed
// straight from the C fragments into A fragments (the m16n8k16 C and A
// layouts hold the same rows and columns).  K and V tiles of 64 columns
// stream through a cp.async ring of 2 to 4 stages, so the
// next tile lands while this one multiplies, with one barrier a kv tile.
// Warps whose rows see nothing of a kv tile skip it.  Shared memory holds
// only Q and the ring (rows padded by 16 bytes, so ldmatrix's 8 rows hit
// distinct banks): 128 x 64 tiles take 104 KB at D = 128 (two CTAs an SM)
// and 203 KB at D = 256 (one).  Registers: O is 16 x DV fp32 a warp, DV /
// 2 a lane; with 128 x 64 tiles ptxas gives 128 a thread at D = 128 (held
// there, see fa_mma_kernel), 229 at D = 256 (238 with a softcap) and 165
// at MLA's D 192 / DV 128 (O at 128: 168 with a softcap), with no spills;
// each build's count lands in build/*.log and chip_smoke.py prints it.
// The 128-row tile halves the K / V bytes each q row pulls from L2
// against a 64-row one, and the loop
// body is kept short (see fa_mma_kernel).  wgmma and TMA are later work.
//
// P keeps fp32 precision, as in the TPU kernel: for bf16, P is split into
// two bf16 terms, hi = bf16(P) and lo = bf16(P - hi) (~16 significant
// bits together), and P@V runs as hi@V + lo@V.  With P rounded once to
// bf16 (8 bits), dbrx-132b's 2-layer decode logits moved 7.4% (mean) away
// from the plain path's, past chip_smoke.py's whole-path tolerance (NVIDIA
// H100 80GB HBM3, 700 W power limit).
//
// fp32 (tests and the smoke's parity case only; `fa_kernel`): the first
// design, kept as it was.  Every intermediate in shared memory — Q, K^T,
// V, the fp32 scores S, P and the fp32 O — a warp per row for the online
// softmax, and a plain FMA loop for the products (IEEE fp32, never TF32).
// It takes 64 x 64 tiles up to D = 128 and 64 x 32 at D = 256 (~222 KB).
#include <climits>

#include "common.cuh"

namespace rt {

constexpr float kMasked = -1e30f;
constexpr int kFaBkv = 64;  // kv columns a tile of the bf16 route

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
  int sq, skv, d, dv, bq, bkv;  // d: q / k width, dv <= d: v / out width
  float scale, softcap;        // softcap <= 0: none
  int causal, window;          // window <= 0: none
};

__device__ __forceinline__ bool fa_visible(const FaArgs& a, int row, int col) {
  bool ok = col < a.skv;
  if (a.causal) ok = ok && col <= row;
  if (a.window > 0) ok = ok && col > row - a.window;
  return ok;
}

// The kv tiles [t0, t1) of width bkv that some row of [q0, q0 + rows) sees.
__device__ __forceinline__ void fa_tile_range(const FaArgs& a, int q0, int rows, int bkv,
                                              int& t0, int& t1) {
  t1 = (a.skv + bkv - 1) / bkv;
  if (a.causal) t1 = min(t1, (q0 + rows - 1) / bkv + 1);
  // the first tile whose last column lies inside the first row's window
  t0 = a.window > 0 ? max(0, (q0 - a.window + 1) / bkv) : 0;
}

// ---------------------------------------------------------------- bf16
// Shared memory of the bf16 route (mirrored by `smem_bytes` / `stages` in
// kernels/flash_attention.py): Q (bq rows) and `stages` pairs of K and V
// tiles (bkv rows), every row d + 8 elements.
__host__ __device__ inline long long fa_rows_bytes(int rows, int d) {
  return align128((long long)rows * (d + 8) * (long long)sizeof(bf16));
}
inline long long fa_mma_smem(int bq, int bkv, int d, int stages) {
  return fa_rows_bytes(bq, d) + 2LL * stages * fa_rows_bytes(bkv, d);
}
// The ring's depth: 4 to 2 stages within two CTAs an SM, else within one;
// 0 when not even 2 fit.
inline int fa_mma_stages(int bq, int bkv, int d) {
  const long long caps[2] = {(kSmemMax - 1024) / 2, kSmemMax};
  for (const long long cap : caps)
    for (int s = 4; s >= 2; --s)
      if (fa_mma_smem(bq, bkv, d, s) <= cap) return s;
  return 0;
}

// tanh through one exp: 1 - 2 / (exp(2x) + 1), |x| clamped at 15 (where
// tanh is 1 in fp32); within ~1e-6 of tanhf, in a few instructions where
// tanhf inlines a few dozen (the softcap runs once per score).
__device__ __forceinline__ float fa_tanh(float x) {
  x = fminf(fmaxf(x, -15.0f), 15.0f);
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

// 2^x on the special-function unit (what __expf issues after scaling by
// log2 e): p = 2^(s log2 e - m log2 e) is one FFMA and this.
__device__ __forceinline__ float fa_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Copy R rows of d elements at row r0 of a strided (nr x d) matrix into
// shared memory (leading dim ld), zero-filled past nr, with load_tile's
// synchronous loads: the path for rows that are not 16-byte aligned, kept
// out of line so the kernel's loop stays short.
__device__ __noinline__ void fa_load_rows(bf16* dst, int ld, const bf16* src, long long s_r,
                                          int r0, int R, int d, int nr) {
  load_tile(dst, ld, src, s_r, 1, r0, 0, R, d, nr, d);
}

// P's two bf16 terms for two neighbouring columns, as one 32-bit A-fragment
// register each: hi = bf16(p), lo = bf16(p - hi).
__device__ __forceinline__ void fa_split(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// blockIdx = (q head, batch row, q tile from the last); 2 * bq threads, a
// warp for each 16 rows; kFaBkv kv columns a tile.  DM: the widest q / k
// width the QK^T loop walks, d <= DM; DV: the register width of O, dv <=
// DV (d and dv multiples of 16; columns past them are never touched);
// CAP: a softcap.  A lane holds, for each 8-column block j of S (and of
// O), the values at row g = lane / 4 (x[0], x[1]) and g + 8 (x[2], x[3]),
// columns 8 j + 2 (lane % 4) + {0, 1}.  The loop body is kept short (no
// tanhf, a mask of two compares a score, no division, the unaligned copy
// out of line): every instruction of it is fetched again each kv tile,
// and a body that outgrows the instruction cache costs more than its
// arithmetic.  Up to D = 128 the kernel is held to 128 registers, so two
// CTAs of 8 warps share an SM (as their 104 KB of shared memory allow).
template <int DM, int DV, bool CAP>
__global__ void __launch_bounds__(256, DM <= 128 ? 2 : 1) fa_mma_kernel(FaArgs a, int stages) {
  constexpr int BKV = kFaBkv, NT = BKV / 8, DT = DV / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = a.d, dv = a.dv, ld = d + 8, nch = d / 8, nchv = dv / 8, S = stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long h = blockIdx.x, b = blockIdx.y, hk = h / a.group;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * a.bq;
  const int rows = min(a.bq, a.sq - q0);
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.k_b + hk * a.k_h;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.v_b + hk * a.v_h;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  unsigned char* const ring = smem + fa_rows_bytes(a.bq, d);
  const long long kvb = fa_rows_bytes(BKV, d);
  int t0, t1;
  fa_tile_range(a, q0, rows, BKV, t0, t1);
  const int steps = max(0, t1 - t0);

  // Rows of d elements at row r0 of strided (nr x d) matrices, zero-filled
  // past nr: cp.async 16 bytes a thread where rows are 16-byte aligned,
  // else fa_load_rows (visible after the next barrier).  A thread walks
  // the (row, 16-byte chunk) pairs from its own with a fixed stride, so
  // the loop divides nothing; K and V tiles share one walk (their second
  // rows `dst + gap`, `src2`: its first nchv chunks of a row).
  const bool vec = a.q_s % 8 == 0 && a.k_s % 8 == 0 && a.v_s % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(Q) | reinterpret_cast<uintptr_t>(K) |
                     reinterpret_cast<uintptr_t>(V)) & 15) == 0;
  const int cr0 = threadIdx.x / nch, cc0 = threadIdx.x - cr0 * nch;
  const int dr = blockDim.x / nch, dc = blockDim.x - dr * nch;
  auto copy = [&](bf16* dst, const bf16* src, long long s_r, const bf16* src2, long long s_r2,
                  long long gap, int r0, int R, int nr) {
    if (!vec) {
      fa_load_rows(dst, ld, src, s_r, r0, R, d, nr);
      if (src2) fa_load_rows(dst + gap, ld, src2, s_r2, r0, R, dv, nr);
      return;
    }
    int r = cr0, c = cc0;
    while (r < R) {
      const bool ok = r0 + r < nr;
      const long long go = (long long)(r0 + r);
      cp_async16(dst + r * ld + 8 * c, ok ? src + go * s_r + 8 * c : src, ok ? 16 : 0);
      if (src2 && c < nchv)
        cp_async16(dst + gap + r * ld + 8 * c, ok ? src2 + go * s_r2 + 8 * c : src2,
                   ok ? 16 : 0);
      r += dr;
      c += dc;
      if (c >= nch) {
        c -= nch;
        ++r;
      }
    }
  };
  auto issue = [&](int j) {  // kv tile t0 + j into stage j % S: K, then V kvb bytes on
    copy(reinterpret_cast<bf16*>(ring + 2LL * (j % S) * kvb), K, a.k_s, V, a.v_s,
         kvb / (long long)sizeof(bf16), (t0 + j) * BKV, BKV, a.skv);
  };
  copy(sq, Q, a.q_s, nullptr, 0, 0, q0, a.bq, a.sq);  // part of the first commit group
  for (int j = 0; j < S - 1; ++j) {
    if (j < steps) issue(j);
    cp_async_commit();
  }

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float mrow[2] = {kMasked, kMasked}, lrow[2] = {0.0f, 0.0f};  // rows g, g + 8
  const int wq = warp * 16, wr0 = q0 + wq;  // the warp's first row (in the tile, in q)
  const bool live = wq < rows;
  // ldmatrix addresses: Q's A fragment (rows wq + lane % 16, column half
  // lane / 16); K's B fragments (rows (lane & 7) + 8 (lane >> 4), column
  // half (lane >> 3) & 1); V's, read transposed (rows lane % 16, column
  // half lane / 16)
  const bf16* pq = sq + (wq + (lane & 15)) * ld + (lane >> 4) * 8;
  const int koff = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  const int voff = (lane & 15) * ld + (lane >> 4) * 8;
  const float cap_inv = CAP ? 1.0f / a.softcap : 0.0f;

  for (int j = 0; j < steps; ++j) {
    cp_async_wait_n(S - 2);
    __syncthreads();  // tile j landed for every thread; tile j - 1's stage is free
    if (j + S - 1 < steps) issue(j + S - 1);
    cp_async_commit();
    const int k0 = (t0 + j) * BKV;
    if (!live) continue;
    if (a.causal && k0 > wr0 + 15) continue;                     // past every row's frontier
    if (a.window > 0 && k0 + BKV - 1 <= wr0 - a.window) continue;  // older than every window
    const bf16* sk = reinterpret_cast<const bf16*>(ring + 2LL * (j % S) * kvb) + koff;
    const bf16* sv = reinterpret_cast<const bf16*>(ring + (2LL * (j % S) + 1) * kvb) + voff;

    // S = Q K^T, fp32
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DM; kk += 16) {
      if (kk >= d) break;
      unsigned af[4];
      ldsm_x4(af, pq + kk);
#pragma unroll
      for (int jn = 0; jn < NT / 2; ++jn) {
        unsigned bfr[4];
        ldsm_x4(bfr, sk + jn * 16 * ld + kk);
        mma_16816(s[2 * jn], af, bfr[0], bfr[1]);
        mma_16816(s[2 * jn + 1], af, bfr[2], bfr[3]);
      }
    }

    // the online softmax step, in the TPU kernel's order: scale, cap,
    // mask; m_new = max(m, row max); p = exp(s - m_new) where visible;
    // alpha = exp(m - m_new); l = l alpha + sum p; O = O alpha + P V.  The
    // mask is two compares a score, applied to every tile (a branch around
    // it made the body longer, not faster)
    unsigned vis = 0xffffffffu;  // bit 4 jn + e: element (jn, e) is visible
    float mx[2] = {kMasked, kMasked};
    // the columns rows g and g + 8 see, relative to this lane's first
    // column k0 + 2 t4: [lo, hi]
    int lo[2], hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wr0 + g + 8 * i, c0 = k0 + 2 * t4;
      hi[i] = (a.causal ? min(row, a.skv - 1) : a.skv - 1) - c0;
      lo[i] = (a.window > 0 ? row - a.window + 1 : INT_MIN / 2) - c0;
    }
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[jn][e] * a.scale;
        if (CAP) x = a.softcap * fa_tanh(x * cap_inv);
        const int c = 8 * jn + (e & 1);
        if (c < lo[e >> 1] || c > hi[e >> 1]) {
          x = kMasked;
          vis &= ~(1u << (4 * jn + e));
        }
        s[jn][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(mrow[i], mx[i]);
      alpha[i] = __expf(mrow[i] - mn);
      mrow[i] = mn;
    }
    constexpr float kLog2e = 1.4426950408889634f;
    const float ml[2] = {-mrow[0] * kLog2e, -mrow[1] * kLog2e};
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (vis >> (4 * jn + e)) & 1u ? fa_ex2(fmaf(s[jn][e], kLog2e, ml[e >> 1])) : 0.0f;
        s[jn][e] = p;
        sum[e >> 1] += p;
      }
    // l: this lane's share of the row sum (the 4 lanes' shares are added
    // once, after the last tile)
    lrow[0] = lrow[0] * alpha[0] + sum[0];
    lrow[1] = lrow[1] * alpha[1] + sum[1];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      if (8 * i >= dv) break;
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += hi @ V + lo @ V: S's blocks 2 kc and 2 kc + 1 are the A fragment
    // of kv columns 16 kc .. 16 kc + 15
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      unsigned hi[4], lo[4];
      fa_split(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
      fa_split(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
      fa_split(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
      fa_split(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
      const bf16* pv = sv + kc * 16 * ld;
#pragma unroll
      for (int nb = 0; nb < DV / 16; ++nb) {
        if (16 * nb >= dv) break;
        unsigned bv[4];
        ldsm_x4_trans(bv, pv + nb * 16);
        mma_16816(o[2 * nb], hi, bv[0], bv[1]);
        mma_16816(o[2 * nb + 1], hi, bv[2], bv[3]);
        mma_16816(o[2 * nb], lo, bv[0], bv[1]);
        mma_16816(o[2 * nb + 1], lo, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();  // with no tile walked, Q's copy is still in flight
  __syncthreads();
  if (!live) return;

  // out = O / max(l, 1e-30), staged as bf16 in the warp's own Q rows (no
  // other warp reads them), then written 16 bytes a lane
  float rl[2];  // 1 / max(l, 1e-30): one division a row, then products
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
    rl[i] = 1.0f / fmaxf(lrow[i], 1e-30f);
  }
  bf16* so = sq + wq * ld;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    if (8 * i >= dv) break;
    const int c = 8 * i + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(so + g * ld + c) =
        __floats2bfloat162_rn(o[i][0] * rl[0], o[i][1] * rl[0]);
    *reinterpret_cast<__nv_bfloat162*>(so + (g + 8) * ld + c) =
        __floats2bfloat162_rn(o[i][2] * rl[1], o[i][3] * rl[1]);
  }
  __syncwarp();
  bf16* out = static_cast<bf16*>(a.o) + b * a.o_b + h * a.o_h;
  const bool ovec = a.o_s % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int wrows = min(16, rows - wq);
  for (int idx = lane; idx < wrows * nchv; idx += 32) {
    const int r = idx / nchv, c = (idx - r * nchv) * 8;
    const bf16* src = so + r * ld + c;
    bf16* dst = out + (long long)(wr0 + r) * a.o_s + c;
    if (ovec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) dst[v] = src[v];
    }
  }
}

template <int DM, int DV, bool CAP>
int launch_fa_mma(const FaArgs& a, int batch, int hq, int stages, long long smem,
                  cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fa_mma_kernel<DM, DV, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, batch, (a.sq + a.bq - 1) / a.bq);
  fa_mma_kernel<DM, DV, CAP><<<grid, 2 * a.bq, smem, stream>>>(a, stages);
  return (int)cudaGetLastError();
}

template <int DM, int DV>
int launch_fa_cap(const FaArgs& a, int batch, int hq, int stages, long long smem,
                  cudaStream_t stream) {
  if (a.softcap > 0.0f) return launch_fa_mma<DM, DV, true>(a, batch, hq, stages, smem, stream);
  return launch_fa_mma<DM, DV, false>(a, batch, hq, stages, smem, stream);
}

// bf16 tiles: bq a multiple of 16 up to 128 (a warp each 16 rows), 64 kv
// columns; the wrapper's default is 128 x 64.
int launch_fa_bf16(const FaArgs& a, int batch, int hq, cudaStream_t stream) {
  if (a.bq % 16 || a.bq < 16 || a.bq > 128 || a.bkv != kFaBkv || batch > 65535 ||
      (a.sq + a.bq - 1) / a.bq > 65535)
    return (int)cudaErrorInvalidValue;
  const int stages = fa_mma_stages(a.bq, a.bkv, a.d);
  if (stages == 0) return (int)cudaErrorInvalidValue;
  const long long smem = fa_mma_smem(a.bq, a.bkv, a.d, stages);
  if (a.d <= 64) return launch_fa_cap<64, 64>(a, batch, hq, stages, smem, stream);
  if (a.d <= 128) return launch_fa_cap<128, 128>(a, batch, hq, stages, smem, stream);
  // past 128, O's registers follow v's width: MLA's 192 / 128 holds O at 128
  if (a.dv <= 128) return launch_fa_cap<256, 128>(a, batch, hq, stages, smem, stream);
  return launch_fa_cap<256, 256>(a, batch, hq, stages, smem, stream);
}

// ---------------------------------------------------------------- fp32
// Shared-memory bytes of one fp32 tile set; mirrored by smem_bytes() in
// kernels/flash_attention.py.
inline long long fa_smem_bytes(int bq, int bkv, int d, int dv) {
  constexpr int P = pad<float>();
  return align128((long long)bq * (d + P) * 4) +       // Q
         align128((long long)d * (bkv + P) * 4) +      // K^T
         align128((long long)bkv * (dv + P) * 4) +     // V
         align128((long long)bq * (bkv + 4) * 4) +     // S
         align128((long long)bq * (bkv + P) * 4) +     // P
         align128((long long)bq * (dv + 4) * 4) +      // O
         2 * align128((long long)bq * 4);              // m, l
}

struct FaTiles {
  float *q, *kt, *v, *p, *s, *o, *m, *l;
  int ldq, ldk, ldv, lds, ldp, ldo;
  __device__ FaTiles(unsigned char* base, int bq, int bkv, int d, int dv) {
    constexpr int P = pad<float>();
    ldq = d + P;
    ldk = bkv + P;
    ldv = dv + P;
    lds = bkv + 4;
    ldp = bkv + P;
    ldo = dv + 4;
    unsigned char* c = base;
    auto take = [&](long long n) {
      float* p = reinterpret_cast<float*>(c);
      c += align128(n * 4);
      return p;
    };
    q = take((long long)bq * ldq);
    kt = take((long long)d * ldk);
    v = take((long long)bkv * ldv);
    s = take((long long)bq * lds);
    p = take((long long)bq * ldp);
    o = take((long long)bq * ldo);
    m = take(bq);
    l = take(bq);
  }
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

// One online-softmax step on the scores of kv tile k0: a warp per row.
// S is turned into P (masked entries 0), O's row is rescaled by alpha, and
// m, l are updated, in the order of the TPU kernel.  Rows past `rows` get
// P = 0 so the P@V products that cover them read finite values.
__device__ void fa_softmax(const FaArgs& a, FaTiles& t, int q0, int k0, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < a.bq; r += nwarps) {
    float* prow = t.p + r * t.ldp;
    if (r >= rows) {
      for (int c = lane; c < a.bkv; c += 32) prow[c] = 0.0f;
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
      prow[c] = p;
    }
    sum = warp_sum(sum);
    const float alpha = expf(m_prev - m_new);
    float* orow = t.o + r * t.ldo;
    for (int c = lane; c < a.dv; c += 32) orow[c] *= alpha;
    if (lane == 0) {
      t.l[r] = t.l[r] * alpha + sum;
      t.m[r] = m_new;
    }
  }
}

// blockIdx = (q tile, head, batch); m, l and O stay in shared memory
// across the kv loop.
__global__ void __launch_bounds__(kThreads) fa_kernel(FaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  FaTiles t(smem, a.bq, a.bkv, a.d, a.dv);
  const int q0 = blockIdx.x * a.bq;
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long hk = h / a.group;
  const int rows = min(a.bq, a.sq - q0);
  const float* Q = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* K = static_cast<const float*>(a.k) + b * a.k_b + hk * a.k_h;
  const float* V = static_cast<const float*>(a.v) + b * a.v_b + hk * a.v_h;

  load_tile(t.q, t.ldq, Q, a.q_s, 1, q0, 0, a.bq, a.d, a.sq, a.d);
  for (int i = threadIdx.x; i < a.bq * t.ldo; i += blockDim.x) t.o[i] = 0.0f;
  for (int i = threadIdx.x; i < a.bq; i += blockDim.x) {
    t.m[i] = kMasked;
    t.l[i] = 0.0f;
  }
  int t0, t1;
  fa_tile_range(a, q0, rows, a.bkv, t0, t1);
  for (int k0 = t0 * a.bkv; k0 < t1 * a.bkv; k0 += a.bkv) {
    __syncthreads();
    // K^T tile: element (dd, j) = K[k0 + j][dd], i.e. unit row stride.
    load_tile(t.kt, t.ldk, K, 1, a.k_s, 0, k0, a.d, a.bkv, a.d, a.skv);
    load_tile(t.v, t.ldv, V, a.v_s, 1, k0, 0, a.bkv, a.dv, a.skv, a.dv);
    __syncthreads();
    mma_block(t.q, t.ldq, t.kt, t.ldk, t.s, t.lds, a.bq, a.d, a.bkv, rows, true);
    __syncthreads();
    fa_softmax(a, t, q0, k0, rows);
    __syncthreads();
    mma_block(t.p, t.ldp, t.v, t.ldv, t.o, t.ldo, a.bq, a.bkv, a.dv, rows, false);
  }
  __syncthreads();
  float* out = static_cast<float*>(a.o) + b * a.o_b + h * a.o_h;
  for (int idx = threadIdx.x; idx < rows * a.dv; idx += blockDim.x) {
    const int r = idx / a.dv, c = idx - r * a.dv;
    out[(long long)(q0 + r) * a.o_s + c] = t.o[r * t.ldo + c] / fmaxf(t.l[r], 1e-30f);
  }
}

int launch_fa_f32(const FaArgs& a, int batch, int hq, cudaStream_t stream) {
  if (a.bq % 16 || a.bkv % 16) return (int)cudaErrorInvalidValue;
  const long long smem = fa_smem_bytes(a.bq, a.bkv, a.d, a.dv);
  if (smem > kSmemMax || hq > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + a.bq - 1) / a.bq, hq, batch);
  fa_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rt

// q / k (batch, hq or hq / group, sq or skv, d), v (batch, hq / group, skv,
// dv), out (batch, hq, sq, dv), all read or written through their (batch,
// head, sequence) strides in elements with a unit stride along the width;
// dv <= d, both multiples of 16; q, k, v and out share one type (bf16 if
// is_bf16, else fp32).  window <= 0 means no window, softcap <= 0 no cap.
// Returns the cudaError_t of the launch.
extern "C" int rt_flash_attention(int is_bf16, const void* q, long long q_b, long long q_h,
                                  long long q_s, const void* k, long long k_b, long long k_h,
                                  long long k_s, const void* v, long long v_b, long long v_h,
                                  long long v_s, void* out, long long o_b, long long o_h,
                                  long long o_s, int batch, int hq, int group, int sq, int skv,
                                  int d, int dv, int bq, int bkv, float scale, float softcap,
                                  int causal, int window, void* stream) {
  if (d % 16 || d < 16 || d > 256 || dv % 16 || dv < 16 || dv > d || group < 1 || hq % group)
    return (int)cudaErrorInvalidValue;
  rt::FaArgs a{q,   q_b,   q_h, q_s, k,   k_b, k_h, k_s,   v,       v_b,    v_h,   v_s,
               out, o_b,   o_h, o_s, group, sq, skv, d,  dv, bq, bkv, scale, softcap, causal,
               window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return rt::launch_fa_bf16(a, batch, hq, s);
  return rt::launch_fa_f32(a, batch, hq, s);
}
