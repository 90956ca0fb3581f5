// Dense schedule family of the planned matmul, hand-written for Hopper.
//
// Replaces: src/repro/kernels/skew_matmul.py::skew_matmul_padded
//   (bodies _k_inner_kernel, _resident_kernel) and
//   ::skew_matmul_batched_padded (the k_inner body with a batch grid dim).
//
//   C = act(scale * (A @ B) + bias) + residual, fp32 accumulation, the
//   epilogue at fp32, one cast to the output type.
//
// Bound on the H100: at the serving shapes every product is bound by
// device-memory bytes (decode: m of a few rows against the whole weight;
// prefill at m = 512 sits below the card's ~295 FLOP/byte ridge once the
// planner's 104 KB blocks re-stream A and B).  So the design spends its
// effort on bytes: 16-byte vector copies on the unit-stride axis, ragged
// edges masked in the kernel instead of padding the operands on every call
// (a 200064-wide weight is never copied), B read through its strides so a
// tied embedding is used as E^T in place, and rows past m neither fetched
// nor multiplied beyond the 16-row MMA granule.
//
// Loop orders (the Pallas grid's sequential dims become loops in the CTA,
// its parallel dims become blockIdx):
//   k_inner    — redesigned for Hopper (see k_inner_kernel): blockIdx =
//                (row tile, column tile) with the batch slices' rows
//                stacked (K2), CTA tiles narrowed until the grid fills the
//                SMs, the fp32 sums in registers with every warp on its
//                own columns, and A and B streamed through a cp.async ring
//                of >= 3 stages, a transposed B copied as its own rows.
//   a_resident — blockIdx = (n-chunk, m-tile).  For each k block the A tile
//                stays in shared memory while the CTA walks its run of
//                n-tiles.  The n sweep is split into chunks so the card has
//                enough CTAs when there is one m-tile (the LM head).  With
//                gk > 1 the partial sums accumulate through an fp32
//                workspace; one CTA owns its output tiles for every k, so
//                that accumulation is sequential in the CTA (no atomics).
//   b_resident — the mirror image: B tile resident, the CTA walks m-tiles.
// a_resident and b_resident keep single-buffered tiles and WMMA from the
// shared-memory fp32 tile; TMA and wgmma are later work for all three.
#include "common.cuh"

namespace rt {

// k_inner's shape on the card (mirrored by `k_inner_config` in
// kernels/skew_matmul.py).  The plan's (bm, bk, bn) is the modeled block;
// the CTA covers `rows` x `tw` of it:
//   rows   — bf16: 8 when every row fits in 8 (decode: the MMA's other 8
//            rows read a zero row, so only the real half is copied), else
//            the plan's bm, at most 64, and no more than the 16-row
//            granules the (batched) rows fill; fp32: 16.  A warp holds
//            mr = 1 or 4 fragments of 16 rows, the only kernels built;
//   tw     — the widest power-of-two multiple of 16 within bn and 128 (a
//            strip of 16 columns for each of the 8 warps); where that grid
//            would leave SMs idle (fewer than `sms` CTAs), a narrower
//            power of two whose grid fills the card and spreads evenly
//            over the SMs: at m = 4, n = 3072 that is 16 columns (192
//            CTAs), at n = 5120 16 (320 CTAs, not 160 of 32);
//   ks     — the k slice of one stage, the deepest power of two up to 256
//            that divides round_up(k, bk) and leaves room for 3 stages;
//            a transposed B narrows tw further until ks spans 128 bytes
//            (a run of 64 bf16 along each row of E);
//   stages — as many as the budget holds, at most 8.
// The budget is the plan's own tile set (`tile_smem_bytes`: A, B and the
// fp32 C tile this kernel no longer keeps), or, for blocks too small to
// hold three 16-deep stages, those three stages.  `bt`: B is a transposed
// view (unit stride along k) and is copied n-major.  bf16 tiles have no
// row pad: their 16-byte chunks are XOR-swizzled (`ki_swz`) so ldmatrix
// reads them without bank conflicts; fp32 tiles keep the 16-byte pad.
struct KICfg {
  int rows, mr, tw, ks, stages, bt, gm, gn;
  long long smem;  // dynamic shared memory in bytes
};
template <typename T> constexpr bool kKiSwz = sizeof(T) == 2;
template <typename T> constexpr int kKiPad = kKiSwz<T> ? 0 : pad<T>();

// The chunk a tile row r (of 2^lgc 16-byte chunks) XORs its chunk index
// with: rows that share a 128-byte bank window take different chunks, so
// the 8 rows of an ldmatrix 8 x 8 read hit 8 distinct bank groups.  It
// depends on r % 8 only.
__host__ __device__ inline int ki_swz(int r, int lgc) {
  return lgc >= 3 ? (r & 7) : ((r >> (3 - lgc)) & ((1 << lgc) - 1));
}

template <typename T>
__host__ __device__ inline long long ki_stage_bytes(int rows, int tw, int ks, int bt) {
  const long long a = align128((long long)rows * (ks + kKiPad<T>) * sizeof(T));
  const long long b = bt ? align128((long long)tw * (ks + kKiPad<T>) * sizeof(T))
                         : align128((long long)ks * (tw + kKiPad<T>) * sizeof(T));
  return a + b;
}
// Shared memory besides the stages: the row offset table, and the zero row
// an 8-row tile's MMA reads for its other 8 rows.
template <typename T>
__host__ __device__ inline long long ki_fixed_bytes(int rows, int ks) {
  return align128((long long)rows * 8) + (rows < 16 ? align128((long long)ks * sizeof(T)) : 0);
}

// The deepest ring for a tile width: a power-of-two slice up to 256 deep
// that divides kp and leaves room for >= 3 stages (at most 8) in the budget.
template <typename T>
inline bool ki_ring(KICfg& c, int tw, int kp, long long plan) {
  const long long budget = max(
      plan, ki_fixed_bytes<T>(c.rows, 16) + 3 * ki_stage_bytes<T>(c.rows, tw, 16, c.bt));
  for (int ks = 256; ks >= 16; ks /= 2) {
    if (kp % ks) continue;
    const long long st = ki_stage_bytes<T>(c.rows, tw, ks, c.bt);
    const long long s = (budget - ki_fixed_bytes<T>(c.rows, ks)) / st;
    if (s >= 3) {
      c.ks = ks;
      c.stages = (int)min(s, 8LL);
      c.smem = ki_fixed_bytes<T>(c.rows, ks) + c.stages * st;
      return true;
    }
  }
  return false;  // not reached: ks = 16 always fits the budget
}

template <typename T>
inline KICfg ki_config(int M, int k, int n, int bm, int bk, int bn, int bt, int sms) {
  KICfg c{};
  if (!kKiSwz<T>)
    c.rows = 16;
  else if (M <= 8)
    c.rows = 8;
  else
    c.rows = min(min(bm, 64), (M + 15) / 16 * 16);
  c.mr = c.rows <= 16 ? 1 : 4;
  c.bt = bt;
  int tw = 16;
  while (2 * tw <= bn && 2 * tw <= 128) tw *= 2;
  c.gm = (M + c.rows - 1) / c.rows;
  if ((long long)c.gm * ((n + tw - 1) / tw) < sms) {
    // narrower tiles: the widest that fills the card with its CTAs spread
    // evenly (the busiest SM at most 1 / 0.85 of the mean), else the most
    // even of those that fill it (16 columns, the MMA strip, at the least)
    int best = 16;
    double best_bal = -1.0;
    for (int w = tw / 2; w >= 16; w /= 2) {
      const long long ctas = (long long)c.gm * ((n + w - 1) / w);
      if (ctas < sms && w > 16) continue;
      const double bal = (double)ctas / ((double)sms * ((ctas + sms - 1) / sms));
      if (bal >= 0.85) {
        best = w;
        break;
      }
      if (bal > best_bal) {
        best = w;
        best_bal = bal;
      }
    }
    tw = best;
  }
  const long long plan = tile_smem_bytes<T>(bm, bk, bn);
  const int kp = (k + bk - 1) / bk * bk;
  c.smem = -1;
  if (!ki_ring<T>(c, tw, kp, plan)) return c;
  // a transposed B is read in runs of ks elements along k: narrow the tile
  // until they are 128 bytes long (the LM head's E^T: 64 columns x 64 deep)
  while (bt && tw > 16 && c.ks * (int)sizeof(T) < 128) {
    tw /= 2;
    if (!ki_ring<T>(c, tw, kp, plan)) return c;
  }
  c.tw = tw;
  c.gn = (n + tw - 1) / tw;
  return c;
}

// One warp's 16-column strip of the bf16 product over one stage: acc[r] +=
// A[16 r .. 16 r + 16, slice] @ B[slice, strip] in 16-deep steps in k
// order, through ldmatrix and two m16n8k16 HMMAs a step (strip_mma's
// instructions, on the swizzled tiles).  `zrow`: an 8-row A tile, whose
// MMA rows 8-15 read this zero row.
template <int MR, bool BT>
__device__ __forceinline__ void ki_mma(AccMma (&acc)[MR], const bf16* sA, int lda, int lga,
                                       const bf16* zrow, const bf16* sB, int ldb, int lgb,
                                       int strip, int K, int nrf) {
  const int lane = threadIdx.x % 32, l8 = lane & 7, h = lane >> 4;
  const int ar = lane & 15;
  const bool zero = zrow != nullptr && ar >= 8;
  const bf16* pa = zero ? zrow : sA + ar * lda;
  const int fa = zero ? 0 : ki_swz(l8, lga);
  // ldmatrix's four 8 x 8 matrices are (k 0-7, n 0-7), (k 8-15, n 0-7),
  // (k 0-7, n 8-15), (k 8-15, n 8-15): b[0], b[1] feed columns 0-7 and
  // b[2], b[3] columns 8-15.  Row-major B is read transposed, lane l at row
  // kk + (l & 15), chunk 2 strip + h; n-major B is already mma.sync's
  // column-major B, lane l at row 16 strip + (l & 7) + 8 h, chunk kk / 8 +
  // (l >> 3 & 1)
  const bf16* pb = BT ? sB + (16 * strip + l8 + 8 * h) * ldb
                      : sB + ar * ldb + (((2 * strip + h) ^ ki_swz(l8, lgb)) << 3);
  const int fb = ki_swz(l8, lgb), hb = (lane >> 3) & 1;
  for (int kk = 0; kk < K; kk += 16) {
    unsigned b[4];
    if (BT)
      ldsm_x4(b, pb + ((((kk >> 3) | hb) ^ fb) << 3));
    else
      ldsm_x4_trans(b, pb + kk * ldb);
    const int ca = (((kk >> 3) | h) ^ fa) << 3;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nrf) break;
      unsigned a[4];
      ldsm_x4(a, pa + 16 * r * lda + ca);
      mma_16816(acc[r].x, a, b[0], b[1]);
      mma_16816(acc[r].x + 4, a, b[2], b[3]);
    }
  }
}

// blockIdx = (row tile, column tile): the row tiles that share a column
// tile run next to each other, so B streams from device memory once.
// Rows are the nb * m rows of every batch slice in order (row r is row
// r % m of slice r / m, read through sa_b and sa_m from a per-row offset
// table); at decode (nb * m <= 16) one CTA takes every slice's rows, so
// K2 reads B once per launch, not once per slice.  The steps q walk k in
// `ks`-deep slices over round_up(k, bk) (the zero-filled tail of the last
// k block included, as the plan's blocks had it); the copies of the next
// stages - 1 slices are in flight (cp.async, one commit group a step)
// while step q multiplies.  Warp w owns the 16-column strip w of the tile
// (warps past tw / 16 only copy) and every row of it, and keeps its fp32
// sums in registers from the first slice to the epilogue: each output's
// sum is one chain over k in ascending order in 16-deep MMA steps, the
// chain the shared-memory WMMA kernel formed, so the output is the same
// bit for bit.
template <typename T, typename O, int MR>
__global__ void __launch_bounds__(kThreads, 2)
k_inner_kernel(const T* __restrict__ A, long long sa_b, long long sa_m, long long sa_k,
               const T* __restrict__ B, long long sb_k, long long sb_n,
               O* __restrict__ out, int nb, int m, int k, int n, int bk, KICfg cfg, Epi e) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr bool SW = kKiSwz<T>;
  using Acc = typename AccFrag<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = cfg.rows, tw = cfg.tw, ks = cfg.ks, S = cfg.stages;
  const int lda = ks + kKiPad<T>;
  const int ldb = cfg.bt ? ks + kKiPad<T> : tw + kKiPad<T>;
  const long long a_bytes = align128((long long)rows * lda * sizeof(T));
  const long long st_bytes = ki_stage_bytes<T>(rows, tw, ks, cfg.bt);
  long long* rowoff = reinterpret_cast<long long*>(smem + S * st_bytes);
  T* zrow = rows < 16 ? reinterpret_cast<T*>(smem + S * st_bytes + align128(rows * 8LL))
                      : nullptr;
  const int warp = threadIdx.x / 32;

  const int M = nb * m;
  const int r0 = blockIdx.x * rows, c0 = blockIdx.y * tw;
  const int vrows = min(rows, M - r0);
  const int nrf = min(MR, (vrows + 15) / 16);
  for (int r = threadIdx.x; r < vrows; r += kThreads) {
    const int b = (r0 + r) / m;
    rowoff[r] = b * sa_b + (long long)(r0 + r - b * m) * sa_m;
  }
  // rows past the last valid one stay zero in every stage: never copied
  for (int s = 0; s < S; ++s) {
    T* sa = reinterpret_cast<T*>(smem + s * st_bytes);
    for (int idx = threadIdx.x; idx < (rows - vrows) * lda; idx += kThreads)
      sa[vrows * lda + idx] = from_f<T>(0.0f);
  }
  if (zrow)
    for (int idx = threadIdx.x; idx < ks; idx += kThreads) zrow[idx] = from_f<T>(0.0f);
  __syncthreads();

  const int kp = (k + bk - 1) / bk * bk, steps = kp / ks;
  const int lgk = log2_exact(ks / V), lgn = log2_exact(tw / V);
  const int lgb = cfg.bt ? lgk : lgn;
  const bool a_vec = sa_k == 1 && sa_m % V == 0 && (nb == 1 || sa_b % V == 0) &&
                     (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool b_vec = (cfg.bt ? sb_n % V == 0 : sb_n == 1 && sb_k % V == 0) &&
                     (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  // element (r, c) of a tile whose rows hold 2^lg chunks of V elements
  auto at = [](int r, int c, int ld, int lg) {
    return r * ld + (SW ? (((c / V) ^ ki_swz(r, lg)) * V + c % V) : c);
  };

  int islot = 0;  // stage of the next copy
  auto issue = [&](int q) {
    unsigned char* st = smem + islot * st_bytes;
    T* sa = reinterpret_cast<T*>(st);
    T* sb = reinterpret_cast<T*>(st + a_bytes);
    const int k0 = q * ks;
    if (a_vec) {
      for (int idx = threadIdx.x; idx < (vrows << lgk); idx += kThreads) {
        const int r = idx >> lgk, c = (idx & ((1 << lgk) - 1)) * V;
        const int valid = max(0, min(V, k - (k0 + c)));
        cp_async16(sa + at(r, c, lda, lgk), valid ? A + rowoff[r] + k0 + c : A,
                   valid * (int)sizeof(T));
      }
    } else {
      for (int idx = threadIdx.x; idx < vrows * ks; idx += kThreads) {
        const int r = idx / ks, c = idx - r * ks;
        sa[at(r, c, lda, lgk)] =
            k0 + c < k ? A[rowoff[r] + (long long)(k0 + c) * sa_k] : from_f<T>(0.0f);
      }
    }
    // B: row j of an n-major tile is column c0 + j of B (a transposed
    // view); a row-major tile holds rows k0 .. k0 + ks of B
    const int br = cfg.bt ? tw : ks, bc = cfg.bt ? ks : tw;
    const int nr = cfg.bt ? n - c0 : k - k0, nc = cfg.bt ? k - k0 : n - c0;
    const T* g = cfg.bt ? B + c0 * sb_n + k0 * sb_k : B + k0 * sb_k + c0 * sb_n;
    const long long s_r = cfg.bt ? sb_n : sb_k, s_c = cfg.bt ? sb_k : sb_n;
    if (b_vec) {
      for (int idx = threadIdx.x; idx < (br << lgb); idx += kThreads) {
        const int r = idx >> lgb, c = (idx & ((1 << lgb) - 1)) * V;
        const int valid = r < nr ? max(0, min(V, nc - c)) : 0;
        cp_async16(sb + at(r, c, ldb, lgb), valid ? g + r * s_r + c : B,
                   valid * (int)sizeof(T));
      }
    } else {
      for (int idx = threadIdx.x; idx < br * bc; idx += kThreads) {
        const int r = idx / bc, c = idx - r * bc;
        sb[at(r, c, ldb, lgb)] = r < nr && c < nc ? g[r * s_r + c * s_c] : from_f<T>(0.0f);
      }
    }
    if (++islot == S) islot = 0;
  };

  Acc run[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) acc_zero(run[r]);
  const bool mma_warp = 16 * warp < tw;
  for (int q = 0; q < S - 1; ++q) {
    if (q < steps) issue(q);
    cp_async_commit();
  }
  int cslot = 0;
  for (int q = 0; q < steps; ++q) {
    cp_async_wait_n(S - 2);
    __syncthreads();  // step q landed for every thread; step q - 1's slot is free
    if (q + S - 1 < steps) issue(q + S - 1);
    cp_async_commit();
    const unsigned char* st = smem + cslot * st_bytes;
    const T* sa = reinterpret_cast<const T*>(st);
    const T* sb = reinterpret_cast<const T*>(st + a_bytes);
    if (mma_warp) {
      if constexpr (SW) {
        if (cfg.bt)
          ki_mma<MR, true>(run, sa, lda, lgk, zrow, sb, ldb, lgb, warp, ks, nrf);
        else
          ki_mma<MR, false>(run, sa, lda, lgk, zrow, sb, ldb, lgb, warp, ks, nrf);
      } else if (cfg.bt) {
        strip_mma<MR, true>(run, sa, lda, sb + 16 * warp * ldb, ldb, ks, nrf);
      } else {
        strip_mma<MR>(run, sa, lda, sb + 16 * warp, ldb, ks, nrf);
      }
    }
    if (++cslot == S) cslot = 0;
  }
  if (!mma_warp) return;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r >= nrf) break;
    store_acc(run[r], out, r0 + 16 * r, c0 + 16 * warp, M, n, e, m);
  }
}

template <typename T, typename O, int MR>
int launch_k_inner(const KICfg& c, const T* a, long long sa_b, long long sa_m,
                   long long sa_k, const T* b, long long sb_k, long long sb_n, O* o, int nb,
                   int m, int k, int n, int bk, const Epi& e, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      k_inner_kernel<T, O, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(c.gm, c.gn, 1);
  k_inner_kernel<T, O, MR><<<grid, kThreads, c.smem, stream>>>(
      a, sa_b, sa_m, sa_k, b, sb_k, sb_n, o, nb, m, k, n, bk, c, e);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
a_resident_kernel(const T* __restrict__ A, long long sa_m, long long sa_k,
                  const T* __restrict__ B, long long sb_k, long long sb_n,
                  O* __restrict__ out, float* __restrict__ ws, int m, int k, int n,
                  int bm, int bk, int bn, int per_chunk, Epi e) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const int gn = (n + bn - 1) / bn, gk = (k + bk - 1) / bk;
  const int i0 = blockIdx.y * bm;
  const int jb = blockIdx.x * per_chunk;
  const int je = min(gn, jb + per_chunk);
  for (int kk = 0; kk < gk; ++kk) {
    __syncthreads();
    load_tile(t.a, t.lda, A, sa_m, sa_k, i0, kk * bk, bm, bk, m, k);
    for (int jt = jb; jt < je; ++jt) {
      __syncthreads();
      load_tile(t.b, t.ldb, B, sb_k, sb_n, kk * bk, jt * bn, bk, bn, k, n);
      __syncthreads();
      mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, m - i0, true);
      __syncthreads();
      combine(t.c, t.ldc, ws, out, kk, gk, i0, jt * bn, bm, bn, m, n, e);
    }
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
b_resident_kernel(const T* __restrict__ A, long long sa_m, long long sa_k,
                  const T* __restrict__ B, long long sb_k, long long sb_n,
                  O* __restrict__ out, float* __restrict__ ws, int m, int k, int n,
                  int bm, int bk, int bn, int per_chunk, Epi e) {
  extern __shared__ __align__(128) unsigned char smem[];
  Tiles<T> t(smem, bm, bk, bn);
  const int gm = (m + bm - 1) / bm, gk = (k + bk - 1) / bk;
  const int j0 = blockIdx.y * bn;
  const int ib = blockIdx.x * per_chunk;
  const int ie = min(gm, ib + per_chunk);
  for (int kk = 0; kk < gk; ++kk) {
    __syncthreads();
    load_tile(t.b, t.ldb, B, sb_k, sb_n, kk * bk, j0, bk, bn, k, n);
    for (int it = ib; it < ie; ++it) {
      __syncthreads();
      load_tile(t.a, t.lda, A, sa_m, sa_k, it * bm, kk * bk, bm, bk, m, k);
      __syncthreads();
      mma_block(t.a, t.lda, t.b, t.ldb, t.c, t.ldc, bm, bk, bn, m - it * bm, true);
      __syncthreads();
      combine(t.c, t.ldc, ws, out, kk, gk, it * bm, j0, bm, bn, m, n, e);
    }
  }
}

template <typename T, typename O>
int launch(int schedule, const void* A, long long sa_b, long long sa_m, long long sa_k,
           const void* B, long long sb_k, long long sb_n, void* out, void* ws, int nb,
           int m, int k, int n, int bm, int bk, int bn, int chunks, const Epi& e,
           cudaStream_t stream) {
  const long long smem = tile_smem_bytes<T>(bm, bk, bn);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const int gm = (m + bm - 1) / bm, gn = (n + bn - 1) / bn;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  O* o = static_cast<O*>(out);
  float* w = static_cast<float*>(ws);
  cudaError_t err;
  if (schedule == 0) {
    // `chunks` is the card's SM count (the wrapper's `k_inner_config`)
    const int bt = sb_k == 1 && sb_n != 1;
    const KICfg c = ki_config<T>(nb * m, k, n, bm, bk, bn, bt, chunks);
    if (c.smem < 0 || c.smem > kSmemMax || c.gn > 65535) return (int)cudaErrorInvalidValue;
    if (c.mr == 1)
      return launch_k_inner<T, O, 1>(c, a, sa_b, sa_m, sa_k, b, sb_k, sb_n, o, nb, m, k, n, bk,
                                     e, stream);
    if constexpr (kKiSwz<T>)
      return launch_k_inner<T, O, 4>(c, a, sa_b, sa_m, sa_k, b, sb_k, sb_n, o, nb, m, k, n, bk,
                                     e, stream);
    return (int)cudaErrorInvalidValue;
  } else if (schedule == 1) {
    err = cudaFuncSetAttribute(a_resident_kernel<T, O>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per = (gn + chunks - 1) / chunks;
    dim3 grid((gn + per - 1) / per, gm, 1);
    a_resident_kernel<T, O><<<grid, kThreads, smem, stream>>>(
        a, sa_m, sa_k, b, sb_k, sb_n, o, w, m, k, n, bm, bk, bn, per, e);
  } else if (schedule == 2) {
    err = cudaFuncSetAttribute(b_resident_kernel<T, O>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per = (gm + chunks - 1) / chunks;
    dim3 grid((gm + per - 1) / per, gn, 1);
    b_resident_kernel<T, O><<<grid, kThreads, smem, stream>>>(
        a, sa_m, sa_k, b, sb_k, sb_n, o, w, m, k, n, bm, bk, bn, per, e);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace rt

// schedule: 0 k_inner (nb >= 1 stacks the batch slices' rows), 1
// a_resident, 2 b_resident.  Strides are in elements; `out` is a
// contiguous (nb, m, n) tensor; `ws` an fp32 (m, n) workspace for the
// resident schedules with more than one k block (else null).  `chunks` is
// the number of chunks for the resident schedules and the card's SM count
// for k_inner.  Returns the cudaError_t of the launch.
extern "C" int rt_skew_matmul(int schedule, int in_bf16, int out_bf16, const void* A,
                              long long sa_b, long long sa_m, long long sa_k,
                              const void* B, long long sb_k, long long sb_n, void* out,
                              void* ws, int nb, int m, int k, int n, int bm, int bk, int bn,
                              int chunks, float scale, int has_scale, const void* bias,
                              int bias_bf16, int act, const void* res, int res_bf16,
                              long long rs_b, long long rs_m, long long rs_n, void* stream) {
  rt::Epi e{scale, has_scale, bias, bias_bf16, act, res, res_bf16, rs_b, rs_m, rs_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return rt::launch<rt::bf16, rt::bf16>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out,
                                          ws, nb, m, k, n, bm, bk, bn, chunks, e, s);
  if (in_bf16)
    return rt::launch<rt::bf16, float>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, ws,
                                       nb, m, k, n, bm, bk, bn, chunks, e, s);
  if (out_bf16)
    return rt::launch<float, rt::bf16>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, ws,
                                       nb, m, k, n, bm, bk, bn, chunks, e, s);
  return rt::launch<float, float>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, ws, nb,
                                  m, k, n, bm, bk, bn, chunks, e, s);
}
