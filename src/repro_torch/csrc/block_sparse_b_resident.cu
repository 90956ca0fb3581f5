// Block-sparse (BSR) matmul, the b_resident schedule, hand-written for
// Hopper.  Its own source (and library) so that nvcc builds it beside
// csrc/block_sparse_matmul.cu (k_inner, a_resident), which holds the
// family's notes.
//
// Replaces: src/repro/sparse/kernels.py::block_sparse_matmul_padded
//   (body _bsr_resident_kernel, the B-resident loop order).
//
//   C = act(scale * (sparse(A) @ B) + bias) + residual
//
// Bound on the H100: 2 * nnz_elems * n operations against the nonzero A
// blocks, B and C once; at the tuner's 4096^2 (32, 128) layouts with
// n = 4096 that is the tensor-core rate.  The design: the fp32 sums of a
// chunk of row blocks in registers (no workspace), all 8 warps on each row
// block's tile, the chunk's column blocks walked in ascending order so a B
// slice is fetched once per chunk, and A blocks and B slices streamed
// through a cp.async ring.  The device
// code is `b_resident_kernel` of csrc/b_resident.cuh with the sparse walk;
// K1's dense b_resident is the same template.  What is left: each step
// (one A block) costs a barrier, and B is re-read from L2 once per chunk
// and column block.
#include "b_resident.cuh"

namespace rt {

// K9's shape (mirrored by `b_resident_config` in
// kernels/block_sparse_matmul.py): the plan's widest tile (`br_width`), the
// warp grid over it and a ring of row-major slices beside the walk's
// control block.
template <typename T>
inline BRCfg br_config(int bm, int bk, int bn) {
  BRCfg c{};
  br_layout<T>(c, bm, br_width<T>(bn));
  br_ring<T>(c, bk, align128(sizeof(BrCtl)), 4);
  return c;
}

template <typename T, typename O>
int launch_bsr_b_resident(const int* cols, const int* nnz, int s_max, const void* A,
                          long long sa_m, long long sa_k, const void* B, long long sb_k,
                          long long sb_n, void* out, int m, int k, int n, int bm, int bk, int bn,
                          int per, const Epi& e, cudaStream_t stream) {
  if (tile_smem_bytes<T>(bm, bk, bn) > kSmemMax) return (int)cudaErrorInvalidValue;
  const BRCfg c = br_config<T>(bm, bk, bn);
  if (c.smem < 0) return (int)cudaErrorInvalidValue;
  const int gm = (m + bm - 1) / bm, ntiles = (n + c.tw - 1) / c.tw;
  per = max(1, min(per, 8 / c.mr));
  if (ntiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((gm + per - 1) / per, ntiles, 1);
  return launch_b_resident<T, O, true, false>(c, grid, cols, nnz, s_max, A, sa_m, sa_k, B, sb_k,
                                              sb_n, out, m, k, n, bm, bk, per, e, stream);
}

}  // namespace rt

// cols is a contiguous int32 (gm, s_max) table and nnz int32 (gm,), both on
// the device.  Strides are in elements; `out` is a contiguous (m, n)
// tensor; `per` is the number of row blocks a CTA holds (the wrapper's
// `b_resident_chunk`).  Returns the cudaError_t of the launch.
extern "C" int rt_block_sparse_b_resident(int in_bf16, int out_bf16, const void* cols,
                                          const void* nnz, int s_max, const void* A,
                                          long long sa_m, long long sa_k, const void* B,
                                          long long sb_k, long long sb_n, void* out, int m,
                                          int k, int n, int bm, int bk, int bn, int per,
                                          float scale, int has_scale, const void* bias,
                                          int bias_bf16, int act, const void* res,
                                          int res_bf16, long long rs_m, long long rs_n,
                                          void* stream) {
  rt::Epi e{scale, has_scale, bias, bias_bf16, act, res, res_bf16, 0, rs_m, rs_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const int* z = static_cast<const int*>(nnz);
  if (in_bf16 && out_bf16)
    return rt::launch_bsr_b_resident<rt::bf16, rt::bf16>(c, z, s_max, A, sa_m, sa_k, B, sb_k,
                                                         sb_n, out, m, k, n, bm, bk, bn, per,
                                                         e, s);
  if (in_bf16)
    return rt::launch_bsr_b_resident<rt::bf16, float>(c, z, s_max, A, sa_m, sa_k, B, sb_k,
                                                      sb_n, out, m, k, n, bm, bk, bn, per, e,
                                                      s);
  if (out_bf16)
    return rt::launch_bsr_b_resident<float, rt::bf16>(c, z, s_max, A, sa_m, sa_k, B, sb_k,
                                                      sb_n, out, m, k, n, bm, bk, bn, per, e,
                                                      s);
  return rt::launch_bsr_b_resident<float, float>(c, z, s_max, A, sa_m, sa_k, B, sb_k, sb_n,
                                                 out, m, k, n, bm, bk, bn, per, e, s);
}
