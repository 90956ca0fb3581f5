"""Split-K / tree-reduction GEMV for the decode regime: Hopper kernels +
plain versions.

Kernels (CUDA C++, `csrc/gemv_splitk.cu`), replacing
`repro/kernels/gemv_splitk.py::gemv_splitk_padded`:
  K3 — pass 1, grid (n-tiles, k-splits): fp32 partial products into a
       (gk, m, n) slab; m is never blocked;
  K4 — pass 2: folds the gk partials per output element in the static
       pairwise order of `tree_sum`, applies the epilogue once, casts.

`gemv_splitk` dispatches on the input's device: a CUDA tensor launches
both kernels (or raises); a CPU tensor runs the plain versions.  For
integer-valued inputs the result is bitwise identical across split counts
on either path.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core import epilogue as epilogue_mod
from repro_torch.kernels import build
from repro_torch.kernels.skew_matmul import (_dtype_flag, check_blocks,
                                             epilogue_args)

LAUNCHES: collections.Counter = collections.Counter()


def tree_sum(parts: torch.Tensor) -> torch.Tensor:
    """Static pairwise fold over the leading axis: halves are added, an odd
    tail carries to the next level unchanged (the JAX `tree_sum` order)."""
    while parts.shape[0] > 1:
        half = parts.shape[0] // 2
        folded = parts[:half] + parts[half:2 * half]
        if parts.shape[0] % 2:
            folded = torch.cat([folded, parts[2 * half:]], dim=0)
        parts = folded
    return parts[0]


# ------------------------------------------------------------ plain versions
def gemv_splitk_partial_plain(a: torch.Tensor, b: torch.Tensor, *,
                              bk: int) -> torch.Tensor:
    """Pass 1: the (gk, m, n) fp32 slab of per-split partial products."""
    k = a.shape[1]
    return torch.stack([a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
                        for k0 in range(0, k, bk)])


def gemv_splitk_reduce_plain(slab: torch.Tensor, bias=None, residual=None,
                             *, epilogue=None,
                             out_dtype=torch.float32) -> torch.Tensor:
    """Pass 2: tree-reduce the slab, epilogue once, one cast."""
    z = tree_sum(slab)
    z = epilogue_mod.apply_spec(z, epilogue,
                                {"bias": bias, "residual": residual})
    return z.to(out_dtype)


# ------------------------------------------------------------ CUDA launches
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("gemv_splitk")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_splitk_partial.argtypes = [i, p, ll, ll, p, ll, ll, p, i, i, i,
                                      i, i, i, p]
    lib.rt_splitk_partial.restype = i
    lib.rt_splitk_reduce.argtypes = [i, p, p, i, i, i, f, i, p, i, i, p, i,
                                     ll, ll, p]
    lib.rt_splitk_reduce.restype = i
    return lib


def gemv_splitk_partial_cuda(a: torch.Tensor, b: torch.Tensor, *, bm: int,
                             bk: int, bn: int) -> torch.Tensor:
    """K3 on the card: returns the contiguous fp32 (gk, m, n) slab."""
    m, k = a.shape
    k2, n = b.shape
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if k != k2 or a.dtype != b.dtype or b.device != a.device:
        raise ValueError(f"bad operands {tuple(a.shape)} {a.dtype} @ "
                         f"{tuple(b.shape)} {b.dtype}")
    if bm < m:
        raise ValueError(f"split-K never blocks m: bm={bm} < m={m}")
    in_bf16 = _dtype_flag(a, "A")
    check_blocks(a.dtype, bm, bk, bn)
    gk = -(-k // bk)
    if gk > 65535:
        raise ValueError(f"too many k splits: {gk}")
    slab = torch.empty((gk, m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().rt_splitk_partial(
        in_bf16, a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
        b.stride(0), b.stride(1), slab.data_ptr(), m, k, n, bm, bk, bn,
        stream)
    build.check(err, "gemv_splitk_partial")
    LAUNCHES["gemv_splitk_partial"] += 1
    return slab


def gemv_splitk_reduce_cuda(slab: torch.Tensor, bias=None, residual=None, *,
                            epilogue=None,
                            out_dtype=torch.float32) -> torch.Tensor:
    """K4 on the card: tree-reduce the slab, epilogue once, one cast."""
    gk, m, n = slab.shape
    if not slab.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if slab.dtype != torch.float32 or not slab.is_contiguous():
        raise ValueError("the partial slab must be contiguous fp32")
    out_bf16 = {torch.bfloat16: 1, torch.float32: 0}.get(out_dtype)
    if out_bf16 is None:
        raise TypeError(f"out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"the output {(m, n)}")
    (scale, has_scale, bias_ptr, bias_bf16, act, res_ptr, res_bf16,
     rst, keep) = epilogue_args(epilogue, bias, residual, slab.device, n)
    out = torch.empty((m, n), dtype=out_dtype, device=slab.device)
    stream = torch.cuda.current_stream(slab.device).cuda_stream
    err = _lib().rt_splitk_reduce(
        out_bf16, slab.data_ptr(), out.data_ptr(), gk, m, n, scale,
        has_scale, bias_ptr, bias_bf16, act, res_ptr, res_bf16, rst[1],
        rst[2], stream)
    build.check(err, "gemv_splitk_reduce")
    LAUNCHES["gemv_splitk_reduce"] += 1
    # `keep` (a contiguous bias copy) may be freed once the launch is
    # enqueued: the caching allocator reuses it only for later work on
    # this stream.
    del keep
    return out


# ------------------------------------------------------------ dispatch
def gemv_splitk(a, b, bias=None, residual=None, *, bm: int, bk: int,
                bn: int, epilogue=None, out_dtype=torch.float32):
    """C = epilogue(A @ B) via split-K partials + one tree-reduce pass:
    the two kernels for a CUDA tensor, the plain versions for a CPU one."""
    if a.is_cuda:
        slab = gemv_splitk_partial_cuda(a, b, bm=bm, bk=bk, bn=bn)
        return gemv_splitk_reduce_cuda(slab, bias, residual,
                                       epilogue=epilogue, out_dtype=out_dtype)
    slab = gemv_splitk_partial_plain(a, b, bk=bk)
    return gemv_splitk_reduce_plain(slab, bias, residual, epilogue=epilogue,
                                    out_dtype=out_dtype)
