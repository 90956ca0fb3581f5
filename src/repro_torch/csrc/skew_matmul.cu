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
//   k_inner    — redesigned for Hopper (k_inner_kernel in k_inner.cuh, the
//                template K3, K5 and K9's k_inner share): blockIdx = (row tile,
//                column tile) with the batch slices' rows stacked (K2),
//                CTA tiles narrowed until the grid fills the SMs, the fp32
//                sums in registers with every warp on its own columns, and
//                A and B streamed through a cp.async ring of >= 3 stages,
//                a transposed B copied as its own rows.
//   a_resident — redesigned for Hopper (see a_resident_kernel): blockIdx =
//                (column chunk, row tile).  For each k block the A tile
//                stays in shared memory while the CTA walks the chunk's
//                column tiles; each block's partial is formed from zero and
//                added to the chunk's fp32 sums, which stay in registers
//                (no workspace), with A and B on k_inner's cp.async ring and
//                swizzled tiles.
//   b_resident — the mirror image, redesigned for Hopper
//                (b_resident_kernel in b_resident.cuh, K9's b_resident
//                template walking every block): blockIdx = (chunk of row
//                blocks, column tile).  For each k block the B slice stays
//                in shared memory while the CTA walks the chunk's row
//                blocks; each block's partial is formed from zero and added
//                to that row block's fp32 sums, which stay in registers (no
//                workspace), with A blocks and B slices on a cp.async ring
//                (E^T copied n-major).  At decode only the 16-row granules
//                that hold rows are copied and multiplied, and the column
//                tile narrows until the grid fills the SMs.  Bound: bytes
//                at the LM head (B once, 0.368 ms on the H100); at 4096^3
//                the tensor-core rate, with B read once per chunk of row
//                blocks.
// TMA and wgmma are later work for all three.
#include "b_resident.cuh"
#include "k_inner.cuh"

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
//            over the SMs (`ki_narrow`): at m = 4, n = 3072 that is 16
//            columns (192 CTAs), at n = 5120 16 (320 CTAs, not 160 of 32);
//   ks     — the k slice of one stage, the deepest power of two up to 256
//            that divides round_up(k, bk) and leaves room for 3 stages;
//            a transposed B narrows tw further until ks spans 128 bytes
//            (a run of 64 bf16 along each row of E);
//   stages — as many as the budget holds, at most 8.
// The budget is the plan's own tile set (`tile_smem_bytes`: A, B and the
// fp32 C tile this kernel no longer keeps), or, for blocks too small to
// hold three 16-deep stages, those three stages.

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
  if ((long long)c.gm * ((n + tw - 1) / tw) < sms) tw = ki_narrow(c.gm, n, tw, sms);
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

// a_resident's shape on the card (mirrored by `a_resident_config` in
// kernels/skew_matmul.py):
//   rows, mr — k_inner's rule: bf16 8 rows when every row fits (the MMA's
//            other 8 rows read a zero row), else the plan's bm, at most 64,
//            within the 16-row granules m fills (mr 4); fp32 16 (mr 1);
//   tw     — 128, a 16-column strip for each of the 8 warps, narrowed as
//            k_inner's (`ki_narrow`) where one tile a CTA would leave SMs
//            idle, and for a transposed B until a slice is 128 bytes deep;
//   ks, g  — a stage holds one B slice (ks x tw) and one A buffer of a
//            group of g = max(bk, ks) columns of k (g / ks sub-tiles of
//            rows x ks, swizzled as k_inner's A); ks is the deepest power
//            of two up to 256 that divides round_up(k, bk), divides bk or
//            (at a bk that is a multiple of 64) is a multiple of it, and
//            leaves room for >= 3 stages (at most 8) within two CTAs an SM
//            (`kArdBudget`);
//   per    — column tiles a CTA holds: the fewest that fit the grid in
//            one wave of two CTAs an SM (the kernel's launch bound), at
//            most 8 / mr (64 sums a lane: 1024 columns at decode).  At the
//            LM head that is 6 tiles and 261 CTAs; K9's rule (>= 2 x SMs
//            CTAs) would give 5 and 313, a wave and a fifth.
struct ARDCfg {
  int rows, mr, tw, ks, g, stages, bt, per, gm, gc;
  long long smem;  // dynamic shared memory in bytes
};

template <typename T>
__host__ __device__ inline long long ard_a_bytes(int rows, int g, int ks) {
  return align128((long long)(g / ks) * rows * (ks + kKiPad<T>) * sizeof(T));
}
template <typename T>
__host__ __device__ inline long long ard_b_bytes(int tw, int ks, int bt) {
  return bt ? align128((long long)tw * (ks + kKiPad<T>) * sizeof(T))
            : align128((long long)ks * (tw + kKiPad<T>) * sizeof(T));
}
// the zero row an 8-row tile's MMA reads for its other 8 rows
template <typename T>
__host__ __device__ inline long long ard_fixed_bytes(int rows, int ks) {
  return rows < 16 ? align128((long long)ks * sizeof(T)) : 0;
}

// The ring's budget: two CTAs an SM, the kernel's launch bound (its 64
// register sums a lane hold it there), so the plan's tile set would leave
// shared memory idle.
constexpr long long kArdBudget = (kSmemMax - 1024) / 2;

template <typename T>
inline bool ard_ring(ARDCfg& c, int tw, int kp, int bk) {
  auto stage = [&](int ks) {
    return ard_a_bytes<T>(c.rows, max(bk, ks), ks) + ard_b_bytes<T>(tw, ks, c.bt);
  };
  const long long budget = max(kArdBudget, ard_fixed_bytes<T>(c.rows, 16) + 3 * stage(16));
  for (int ks = 256; ks >= 16; ks /= 2) {
    // a step holds whole blocks or part of one; several blocks only at a
    // bk that is a multiple of 64, so that each block's MMAs can read the
    // swizzled tiles at an offset
    if (kp % ks || (bk % ks && (ks % bk || bk % 64))) continue;
    const long long s = (budget - ard_fixed_bytes<T>(c.rows, ks)) / stage(ks);
    if (s >= 3) {
      c.ks = ks;
      c.g = max(bk, ks);
      c.stages = (int)min(s, 8LL);
      c.smem = ard_fixed_bytes<T>(c.rows, ks) + c.stages * stage(ks);
      return true;
    }
  }
  return false;  // not reached: ks = 16 divides bk and always fits the budget
}

template <typename T>
inline ARDCfg ard_config(int m, int k, int n, int bm, int bk, int bt, int sms) {
  ARDCfg c{};
  if (!kKiSwz<T>)
    c.rows = 16;
  else if (m <= 8)
    c.rows = 8;
  else
    c.rows = min(min(bm, 64), (m + 15) / 16 * 16);
  c.mr = c.rows <= 16 ? 1 : 4;
  c.bt = bt;
  c.gm = (m + c.rows - 1) / c.rows;
  int tw = 128;
  if ((long long)c.gm * ((n + tw - 1) / tw) < sms) tw = ki_narrow(c.gm, n, tw, sms);
  const int kp = (k + bk - 1) / bk * bk;
  c.smem = -1;
  if (!ard_ring<T>(c, tw, kp, bk)) return c;
  while (bt && tw > 16 && c.ks * (int)sizeof(T) < 128) {
    tw /= 2;
    if (!ard_ring<T>(c, tw, kp, bk)) return c;
  }
  c.tw = tw;
  const int tiles = (n + tw - 1) / tw;
  const int rows_per_wave = max(1, 2 * sms / c.gm);
  c.per = min(8 / c.mr, (tiles + rows_per_wave - 1) / rows_per_wave);
  c.gc = (tiles + c.per - 1) / c.per;
  return c;
}

// blockIdx = (column chunk, row tile): the CTA owns rows r0 .. r0 + rows of
// the chunk's `per` column tiles (the last chunk may hold fewer) and keeps
// their fp32 sums in registers for the whole k loop: no workspace.  Steps
// q = (group, tile, slice) run in that order over round_up(k, bk) (the
// zero-filled tail of a ragged last k block included); at a group's first
// step its A (rows x g) is fetched into A buffer (group % stages), where it
// stays while the CTA walks the chunk's tiles, and each step fetches its B
// slice into B slot q % stages; the copies of the next stages - 1 steps are
// in flight (cp.async, one commit group a step) while step q multiplies.
// A buffer (group % stages) is overwritten only stages - 1 steps before
// the group's first step, after every step of group - stages (each group
// has at least one step).  Warp w owns the 16-column strip w of every tile
// (warps past tw / 16 only copy).  For each (k block, tile) it forms the
// block's partial from zero over bk in 16-deep steps (a step of ks > bk
// covers ks / bk blocks), then adds it to the tile's running sum with one
// fp32 add (the first block's partial is the sum): the JAX kernel's fold,
// and K9 a_resident's, so at density 1.0 K9 equals this kernel bit for bit.
// The epilogue is applied once, after the last k block.
template <typename T, typename O, int MR>
__global__ void __launch_bounds__(kThreads, MR == 1 ? 2 : 1)
a_resident_kernel(const T* __restrict__ A, long long sa_m, long long sa_k,
                  const T* __restrict__ B, long long sb_k, long long sb_n,
                  O* __restrict__ out, int m, int k, int n, int bk, ARDCfg cfg, Epi e) {
  constexpr int TN = 8 / MR;  // column tiles a CTA may hold (64 sums a lane)
  constexpr int V = 16 / (int)sizeof(T);
  constexpr bool SW = kKiSwz<T>;
  using Acc = typename AccFrag<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = cfg.rows, tw = cfg.tw, ks = cfg.ks, G = cfg.g, S = cfg.stages;
  const int nks = G / ks;
  const int lda = ks + kKiPad<T>;
  const int ldb = cfg.bt ? ks + kKiPad<T> : tw + kKiPad<T>;
  const int sub = rows * lda;  // elements of one A sub-tile
  const long long a_bytes = ard_a_bytes<T>(rows, G, ks);
  const long long b_bytes = ard_b_bytes<T>(tw, ks, cfg.bt);
  unsigned char* const sbase = smem + S * a_bytes;
  T* zrow = rows < 16 ? reinterpret_cast<T*>(sbase + S * b_bytes) : nullptr;
  const int warp = threadIdx.x / 32;

  const int tiles = (n + tw - 1) / tw;
  const int t0 = blockIdx.x * cfg.per, tnc = min(cfg.per, tiles - t0);
  const int r0 = blockIdx.y * rows;
  const int vrows = min(rows, m - r0);
  const int nrf = min(MR, (vrows + 15) / 16);
  // rows past the last valid one stay zero in every A buffer: never copied
  for (int s = 0; s < S * nks; ++s) {
    T* sa = reinterpret_cast<T*>(smem + (s / nks) * a_bytes) + (s % nks) * sub;
    for (int idx = threadIdx.x; idx < (rows - vrows) * lda; idx += kThreads)
      sa[vrows * lda + idx] = from_f<T>(0.0f);
  }
  if (zrow)
    for (int idx = threadIdx.x; idx < ks; idx += kThreads) zrow[idx] = from_f<T>(0.0f);
  __syncthreads();

  const int groups = (k + bk - 1) / bk * bk / G, steps = groups * tnc * nks;
  const int lgk = log2_exact(ks / V), lgn = log2_exact(tw / V);
  const int lgb = cfg.bt ? lgk : lgn;
  const bool a_vec = sa_k == 1 && sa_m % V == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool b_vec = (cfg.bt ? sb_n % V == 0 : sb_n == 1 && sb_k % V == 0) &&
                     (reinterpret_cast<uintptr_t>(B) & 15) == 0;
  auto at = [](int r, int c, int ld, int lg) {
    return r * ld + (SW ? (((c / V) ^ ki_swz(r, lg)) * V + c % V) : c);
  };

  // The copy cursor (group, tile, slice; B slot, A buffer) runs a step
  // ahead of the compute cursor below; both only count.
  int ig = 0, it = 0, isl = 0, islot = 0, iga = 0;
  auto issue = [&]() {
    const int kg = ig * G;
    if (it == 0 && isl == 0) {
      T* sa = reinterpret_cast<T*>(smem + iga * a_bytes);
      if (a_vec) {
        const int cpr = G / V;
        for (int idx = threadIdx.x; idx < vrows * cpr; idx += kThreads) {
          const int r = idx / cpr, c = (idx - r * cpr) * V;
          const int j = c / ks, cc = c - j * ks;
          const int valid = max(0, min(V, k - (kg + c)));
          cp_async16(sa + j * sub + at(r, cc, lda, lgk),
                     valid ? A + (long long)(r0 + r) * sa_m + kg + c : A,
                     valid * (int)sizeof(T));
        }
      } else {
        for (int idx = threadIdx.x; idx < vrows * G; idx += kThreads) {
          const int r = idx / G, c = idx - r * G;
          const int j = c / ks, cc = c - j * ks;
          sa[j * sub + at(r, cc, lda, lgk)] =
              kg + c < k ? A[(long long)(r0 + r) * sa_m + (long long)(kg + c) * sa_k]
                         : from_f<T>(0.0f);
        }
      }
    }
    T* sb = reinterpret_cast<T*>(sbase + islot * b_bytes);
    const int k0 = kg + isl * ks, c0 = (t0 + it) * tw;
    // B, as k_inner copies it: row j of an n-major slice is column c0 + j
    const int br = cfg.bt ? tw : ks, bc = cfg.bt ? ks : tw;
    const int nr = cfg.bt ? n - c0 : k - k0, nc = cfg.bt ? k - k0 : n - c0;
    const T* g = cfg.bt ? B + (long long)c0 * sb_n + (long long)k0 * sb_k
                        : B + (long long)k0 * sb_k + (long long)c0 * sb_n;
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
    if (++isl == nks) {
      isl = 0;
      if (++it == tnc) {
        it = 0;
        ++ig;
        if (++iga == S) iga = 0;
      }
    }
  };

  Acc run[TN][MR];
  Acc part[MR];
  const bool mma_warp = 16 * warp < tw;
  const int kstep = min(ks, bk);
  for (int q = 0; q < S - 1; ++q) {
    if (q < steps) issue();
    cp_async_commit();
  }
  int cg = 0, ct = 0, csl = 0, cslot = 0, cga = 0;
  for (int q = 0; q < steps; ++q) {
    cp_async_wait_n(S - 2);
    __syncthreads();  // step q landed for every thread; step q - 1's slots are free
    if (q + S - 1 < steps) issue();
    cp_async_commit();
    if (mma_warp) {
      const T* sa = reinterpret_cast<const T*>(smem + cga * a_bytes) + csl * sub;
      const T* sb = reinterpret_cast<const T*>(sbase + cslot * b_bytes);
      for (int kb = 0; kb < ks; kb += kstep) {
        if (csl == 0) {
#pragma unroll
          for (int r = 0; r < MR; ++r) acc_zero(part[r]);
        }
        if constexpr (SW) {
          // kb is 0 or a multiple of 64 (`ard_ring`), where the swizzle
          // commutes with the offset (it XORs a chunk index below 8), so
          // the block's MMAs read shifted tiles
          if (cfg.bt)
            ki_mma<MR, true>(part, sa + kb, lda, lgk, zrow, sb + kb, ldb, lgb, warp, kstep, nrf);
          else
            ki_mma<MR, false>(part, sa + kb, lda, lgk, zrow, sb + kb * ldb, ldb, lgb, warp,
                              kstep, nrf);
        } else if (cfg.bt) {
          strip_mma<MR, true>(part, sa + kb, lda, sb + 16 * warp * ldb + kb, ldb, kstep, nrf);
        } else {
          strip_mma<MR>(part, sa + kb, lda, sb + kb * ldb + 16 * warp, ldb, kstep, nrf);
        }
        if (csl == nks - 1) {
          const bool first = cg == 0 && kb == 0;
#pragma unroll
          for (int tt = 0; tt < TN; ++tt) {
            if (tt >= tnc) break;
            if (tt != ct) continue;
#pragma unroll
            for (int r = 0; r < MR; ++r)
#pragma unroll
              for (int x = 0; x < 8; ++x)
                run[tt][r].x[x] = first ? part[r].x[x] : run[tt][r].x[x] + part[r].x[x];
          }
        }
      }
    }
    if (++cslot == S) cslot = 0;
    if (++csl == nks) {
      csl = 0;
      if (++ct == tnc) {
        ct = 0;
        ++cg;
        if (++cga == S) cga = 0;
      }
    }
  }
  if (!mma_warp) return;
#pragma unroll
  for (int tt = 0; tt < TN; ++tt) {
    if (tt >= tnc) break;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= nrf) break;
      store_acc(run[tt][r], out, r0 + 16 * r, (t0 + tt) * tw + 16 * warp, m, n, e);
    }
  }
}

template <typename T, typename O, int MR>
int launch_a_resident(const ARDCfg& c, const T* a, long long sa_m, long long sa_k, const T* b,
                      long long sb_k, long long sb_n, O* o, int m, int k, int n, int bk,
                      const Epi& e, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      a_resident_kernel<T, O, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(c.gc, c.gm, 1);
  a_resident_kernel<T, O, MR><<<grid, kThreads, c.smem, stream>>>(a, sa_m, sa_k, b, sb_k, sb_n,
                                                                   o, m, k, n, bk, c, e);
  return (int)cudaGetLastError();
}

// b_resident's shape (mirrored by `b_resident_config` in
// kernels/skew_matmul.py): the plan's widest tile (`br_width`), narrowed as
// k_inner's (`ki_narrow`) where one row block a CTA would leave SMs idle;
// the warp grid over the rows a row block holds (bm, or at m < bm the
// 16-row granules of m: at decode one granule, so mr 1 and two CTAs an
// SM) (`br_layout`); 8 to 2 stages of those rows, two CTAs an SM where
// they fit.  `per` row blocks a CTA: as many as the registers allow (8 /
// mr), fewer where that leaves under 2 x sms CTAs and more chunks can be
// had (K9's `b_resident_chunk` rule).
struct BRDCfg {
  BRCfg c;
  int per, gc, gn;
};

template <typename T>
inline BRDCfg brd_config(int m, int n, int bm, int bk, int bn, int bt, int sms) {
  BRDCfg d{};
  d.c.bt = bt;
  const int gm = (m + bm - 1) / bm;
  int tw = br_width<T>(bn);
  if ((long long)gm * ((n + tw - 1) / tw) < sms) tw = ki_narrow(gm, n, tw, sms);
  br_layout<T>(d.c, min(bm, (m + 15) / 16 * 16), tw);
  br_ring<T>(d.c, bk, 0, 8);
  d.gn = (n + d.c.tw - 1) / d.c.tw;
  d.per = max(1, min(8 / d.c.mr, gm));
  while (d.per > 1 && (long long)((gm + d.per - 1) / d.per) * d.gn < 2LL * sms) --d.per;
  d.gc = (gm + d.per - 1) / d.per;
  return d;
}

template <typename T, typename O>
int launch(int schedule, const void* A, long long sa_b, long long sa_m, long long sa_k,
           const void* B, long long sb_k, long long sb_n, void* out, int nb, int m, int k,
           int n, int bm, int bk, int bn, int sms, const Epi& e, cudaStream_t stream) {
  if (tile_smem_bytes<T>(bm, bk, bn) > kSmemMax) return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  O* o = static_cast<O*>(out);
  const int bt = sb_k == 1 && sb_n != 1;
  if (schedule == 0) {
    const KICfg c = ki_config<T>(nb * m, k, n, bm, bk, bn, bt, sms);
    if (c.smem < 0 || c.smem > kSmemMax || c.gn > 65535) return (int)cudaErrorInvalidValue;
    if (c.mr == 1)
      return launch_k_inner<T, O, 1, 1, KiWalk::kDense>(c, a, sa_b, sa_m, sa_k, b, sb_k, sb_n, o,
                                                        nb, m, k, n, bk, e, nullptr, nullptr, 0,
                                                        bm, stream);
    if constexpr (kKiSwz<T>)
      return launch_k_inner<T, O, 4, 1, KiWalk::kDense>(c, a, sa_b, sa_m, sa_k, b, sb_k, sb_n, o,
                                                        nb, m, k, n, bk, e, nullptr, nullptr, 0,
                                                        bm, stream);
    return (int)cudaErrorInvalidValue;
  } else if (schedule == 1) {
    const ARDCfg c = ard_config<T>(m, k, n, bm, bk, bt, sms);
    if (nb != 1 || c.smem < 0 || c.smem > kSmemMax || c.gm > 65535)
      return (int)cudaErrorInvalidValue;
    if (c.mr == 1)
      return launch_a_resident<T, O, 1>(c, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k, n, bk, e,
                                        stream);
    if constexpr (kKiSwz<T>)
      return launch_a_resident<T, O, 4>(c, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k, n, bk, e,
                                        stream);
    return (int)cudaErrorInvalidValue;
  } else if (schedule == 2) {
    const BRDCfg d = brd_config<T>(m, n, bm, bk, bn, bt, sms);
    if (nb != 1 || d.c.smem < 0 || d.gn > 65535) return (int)cudaErrorInvalidValue;
    return launch_b_resident<T, O, false, true>(d.c, dim3(d.gc, d.gn, 1), nullptr, nullptr, 0,
                                                A, sa_m, sa_k, B, sb_k, sb_n, out, m, k, n, bm,
                                                bk, d.per, e, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt

// schedule: 0 k_inner (nb >= 1 stacks the batch slices' rows), 1
// a_resident, 2 b_resident.  Strides are in elements; `out` is a
// contiguous (nb, m, n) tensor; `sms` is the card's SM count, which each
// schedule's shape is chosen for (the wrapper's `k_inner_config`,
// `a_resident_config`, `b_resident_config`).  Returns the cudaError_t of
// the launch.
extern "C" int rt_skew_matmul(int schedule, int in_bf16, int out_bf16, const void* A,
                              long long sa_b, long long sa_m, long long sa_k,
                              const void* B, long long sb_k, long long sb_n, void* out, int nb,
                              int m, int k, int n, int bm, int bk, int bn, int sms,
                              float scale, int has_scale, const void* bias, int bias_bf16,
                              int act, const void* res, int res_bf16, long long rs_b,
                              long long rs_m, long long rs_n, void* stream) {
  rt::Epi e{scale, has_scale, bias, bias_bf16, act, res, res_bf16, rs_b, rs_m, rs_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return rt::launch<rt::bf16, rt::bf16>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, nb,
                                          m, k, n, bm, bk, bn, sms, e, s);
  if (in_bf16)
    return rt::launch<rt::bf16, float>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, nb, m,
                                       k, n, bm, bk, bn, sms, e, s);
  if (out_bf16)
    return rt::launch<float, rt::bf16>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, nb, m,
                                       k, n, bm, bk, bn, sms, e, s);
  return rt::launch<float, float>(schedule, A, sa_b, sa_m, sa_k, B, sb_k, sb_n, out, nb, m, k, n,
                                  bm, bk, bn, sms, e, s);
}
