// Block-sparse (BSR) matmul, the k_inner schedule, hand-written for Hopper.
// Its own source (and library) so that nvcc builds it beside
// csrc/block_sparse_matmul.cu (a_resident), which holds the family's notes.
//
// Replaces: src/repro/sparse/kernels.py::block_sparse_matmul_padded
//   (body _bsr_k_inner_kernel, grid (gm, gn, s)).
//
//   C = act(scale * (sparse(A) @ B) + bias) + residual
//
// The device code is K1's k_inner (csrc/k_inner.cuh) with the sparse walk:
// a CTA's rows lie in one row block i, and its steps are the ks-deep slices
// of that row block's nonzero blocks cols[i, :nnz[i]] in ascending order
// (ks divides bk), read from the index table by the CTA itself in place of
// Pallas's scalar prefetch.  fp32 sums in registers, A and B slices on a
// cp.async ring of >= 3 stages, XOR-swizzled bf16 tiles read by ldmatrix,
// a transposed B copied n-major.  At density 1.0 the slices are K1's, in
// K1's order, so the output equals K1 k_inner's bit for bit.
//
// Bound on the H100: 2 * nnz_elems * n operations against the nonzero A
// blocks, B and C once; at the tuner's 4096^2 (32, 128) layouts with
// n = 4096 that is the tensor-core rate.  What k_inner cannot avoid is B's
// re-read: every row block reads the B rows of each of its nonzero blocks
// across the whole of n, gm * nnz_row * bk * n * 2 bytes (1.07 GB from L2
// at d 0.25, 32 times B itself).  The design keeps the re-reads of A down
// instead: a CTA covers up to 256 columns (each warp two 16-column strips),
// so each nonzero A block is read n / 256 times, not n / bn.
#include "k_inner.cuh"

namespace rt {

// K9 k_inner's shape on the card (mirrored by `k_inner_config` in
// kernels/block_sparse_matmul.py):
//   rows   — bf16: the largest of 64, 32 and 16 that divides bm, so that no
//            CTA's rows cross a row block (their column lists differ): bm
//            32 gives 32 rows (mr 2), (128, 128) two CTAs of 64 rows a row
//            block; fp32: 16 (mr 1);
//   tw     — the widest power of two up to 256 (bf16; fp32 128) whose grid
//            still has `sms` CTAs, at least 16;
//   ks     — the deepest power of two up to 256 that divides bk and leaves
//            room for >= 3 stages (at most 8) within two CTAs an SM; a
//            transposed B narrows tw until ks spans 128 bytes.
constexpr long long kBkiBudget = (kSmemMax - 1024) / 2;

template <typename T>
inline KICfg bki_config(int m, int n, int bm, int bk, int bt, int sms) {
  KICfg c{};
  if (!kKiSwz<T>)
    c.rows = 16;
  else
    c.rows = bm % 64 == 0 ? 64 : bm % 32 == 0 ? 32 : 16;
  c.mr = c.rows / 16;
  c.bt = bt;
  c.gm = (m + c.rows - 1) / c.rows;
  int tw = kKiSwz<T> ? 256 : 128;
  while (tw > 16 && (long long)c.gm * ((n + tw - 1) / tw) < sms) tw /= 2;
  c.smem = -1;
  if (!ki_ring<T>(c, tw, bk, kBkiBudget)) return c;
  while (bt && tw > 16 && c.ks * (int)sizeof(T) < 128) {
    tw /= 2;
    if (!ki_ring<T>(c, tw, bk, kBkiBudget)) return c;
  }
  c.tw = tw;
  c.gn = (n + tw - 1) / tw;
  return c;
}

template <typename T, typename O, int MR, int NS>
int launch_mr(const KICfg& c, const int* cols, const int* nnz, int s_max, const T* a,
              long long sa_m, long long sa_k, const T* b, long long sb_k, long long sb_n, O* o,
              int m, int k, int n, int bm, int bk, const Epi& e, cudaStream_t stream) {
  return launch_k_inner<T, O, MR, NS, KiWalk::kSparse>(c, a, 0, sa_m, sa_k, b, sb_k, sb_n, o, 1, m,
                                                      k, n, bk, e, cols, nnz, s_max, bm, stream);
}

template <typename T, typename O>
int launch_bsr_k_inner(const int* cols, const int* nnz, int s_max, const void* A, long long sa_m,
                       long long sa_k, const void* B, long long sb_k, long long sb_n, void* out,
                       int m, int k, int n, int bm, int bk, int bn, int sms, const Epi& e,
                       cudaStream_t stream) {
  if (tile_smem_bytes<T>(bm, bk, bn) > kSmemMax) return (int)cudaErrorInvalidValue;
  const int bt = sb_k == 1 && sb_n != 1;
  const KICfg c = bki_config<T>(m, n, bm, bk, bt, sms);
  if (c.smem < 0 || c.smem > kSmemMax || c.gn > 65535) return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  O* o = static_cast<O*>(out);
  if constexpr (kKiSwz<T>) {
    const bool two = c.tw > 128;
    switch (c.mr * 2 + two) {
      case 2:
        return launch_mr<T, O, 1, 1>(c, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m,
                                     k, n, bm, bk, e, stream);
      case 3:
        return launch_mr<T, O, 1, 2>(c, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m,
                                     k, n, bm, bk, e, stream);
      case 4:
        return launch_mr<T, O, 2, 1>(c, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m,
                                     k, n, bm, bk, e, stream);
      case 5:
        return launch_mr<T, O, 2, 2>(c, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m,
                                     k, n, bm, bk, e, stream);
      case 8:
        return launch_mr<T, O, 4, 1>(c, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m,
                                     k, n, bm, bk, e, stream);
      case 9:
        return launch_mr<T, O, 4, 2>(c, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m,
                                     k, n, bm, bk, e, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    if (c.mr != 1 || c.tw > 128) return (int)cudaErrorInvalidValue;
    return launch_mr<T, O, 1, 1>(c, cols, nnz, s_max, a, sa_m, sa_k, b, sb_k, sb_n, o, m, k, n,
                                 bm, bk, e, stream);
  }
}

}  // namespace rt

// cols is a contiguous int32 (gm, s_max) table and nnz int32 (gm,), both on
// the device.  Strides are in elements; `out` is a contiguous (m, n)
// tensor; `sms` is the card's SM count (the wrapper's `k_inner_config`).
// Returns the cudaError_t of the launch.
extern "C" int rt_block_sparse_k_inner(int in_bf16, int out_bf16, const void* cols,
                                       const void* nnz, int s_max, const void* A, long long sa_m,
                                       long long sa_k, const void* B, long long sb_k,
                                       long long sb_n, void* out, int m, int k, int n, int bm,
                                       int bk, int bn, int sms, float scale, int has_scale,
                                       const void* bias, int bias_bf16, int act, const void* res,
                                       int res_bf16, long long rs_m, long long rs_n,
                                       void* stream) {
  rt::Epi e{scale, has_scale, bias, bias_bf16, act, res, res_bf16, 0, rs_m, rs_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const int* z = static_cast<const int*>(nnz);
  if (in_bf16 && out_bf16)
    return rt::launch_bsr_k_inner<rt::bf16, rt::bf16>(c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n,
                                                      out, m, k, n, bm, bk, bn, sms, e, s);
  if (in_bf16)
    return rt::launch_bsr_k_inner<rt::bf16, float>(c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n,
                                                   out, m, k, n, bm, bk, bn, sms, e, s);
  if (out_bf16)
    return rt::launch_bsr_k_inner<float, rt::bf16>(c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n,
                                                   out, m, k, n, bm, bk, bn, sms, e, s);
  return rt::launch_bsr_k_inner<float, float>(c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n, out, m,
                                              k, n, bm, bk, bn, sms, e, s);
}
