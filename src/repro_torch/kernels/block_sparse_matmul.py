"""Block-sparse (BSR) matmul: the Hopper kernel K9 + its plain version.

Kernel (CUDA C++, `csrc/block_sparse_matmul.cu`): K9, one kernel per loop
order of the dense family (k_inner, a_resident, b_resident), replacing
`repro/sparse/kernels.py::block_sparse_matmul_padded`:

    C = act(scale * (sparse(A) @ B) + bias) + residual

over the nonzero (bm, bk) blocks of A named by a `BlockSparseLayout`
(blocks absent from it are never read), fp32 accumulation, the epilogue at
fp32 and one cast.  The kernel tiles on the layout's block shape; only bn
comes from the plan.  Operands need no padding: ragged last row and column
blocks are masked in the kernel.  At density 1.0 the output is bitwise
equal to K1's at the same blocks and schedule.

`block_sparse_matmul` dispatches on the device of its input: a CUDA tensor
always launches the kernel (or raises); a CPU tensor runs the plain
version, which loops over (row block, nonzero block) with fp32 products
in the layout's order and applies the epilogue once.

`LAUNCHES` counts kernel launches per schedule, on the CUDA path only.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core import epilogue as epilogue_mod
from repro_torch.kernels import build
from repro_torch.kernels import skew_matmul as _mm

SCHEDULE_IDS = {"k_inner": 0, "a_resident": 1, "b_resident": 2}
LAUNCHES: collections.Counter = collections.Counter()


# ------------------------------------------------------------ plain version
def block_sparse_matmul_plain(a: torch.Tensor, b: torch.Tensor, layout,
                              bias=None, residual=None, *, epilogue=None,
                              out_dtype=torch.float32) -> torch.Tensor:
    """C = epilogue(sparse(A) @ B): for each row block, the fp32 products
    of its nonzero blocks summed in the layout's order, then the epilogue
    once over the whole output."""
    m, k = a.shape
    n = b.shape[1]
    if tuple(layout.shape) != (m, k):
        raise ValueError(f"layout shape {layout.shape} != lhs shape {(m, k)}")
    bm, bk = layout.block_shape
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for i, (row, cnt) in enumerate(zip(layout.cols.tolist(),
                                       layout.nnz.tolist())):
        rows = slice(i * bm, min(m, (i + 1) * bm))
        for c in row[:cnt]:
            ks = slice(c * bk, min(k, (c + 1) * bk))
            acc[rows] += torch.matmul(a[rows, ks].float(), b[ks].float())
    ops = {"bias": bias, "residual": residual}
    z = epilogue_mod.apply_spec(acc, epilogue, ops)
    return z.to(out_dtype)


# ------------------------------------------------------------ CUDA launch
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("block_sparse_matmul")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_block_sparse_matmul.argtypes = [
        i, i, i, p, p, i, p, ll, ll, p, ll, ll, p, p, i, i, i, i, i, i, i,
        f, i, p, i, i, p, i, ll, ll, p]
    lib.rt_block_sparse_matmul.restype = i
    return lib


def block_sparse_matmul_cuda(a, b, layout, bias=None, residual=None, *,
                             bn: int, schedule: str = "k_inner",
                             epilogue=None,
                             out_dtype=torch.float32) -> torch.Tensor:
    """K9 on the card: sparse(a (m, k)) @ b (k, n) -> (m, n), one launch.
    The index tables go to the card once per layout and device."""
    sid = SCHEDULE_IDS.get(schedule)
    if sid is None:
        raise ValueError(f"unknown schedule {schedule!r}")
    m, k = a.shape
    k2, n = b.shape
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if b.device != a.device:
        raise ValueError("A and B must be on the same CUDA device")
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if tuple(layout.shape) != (m, k):
        raise ValueError(f"layout shape {layout.shape} != lhs shape {(m, k)}")
    if a.dtype != b.dtype:
        raise TypeError(f"A and B dtypes differ: {a.dtype} vs {b.dtype}")
    in_bf16 = _mm._dtype_flag(a, "A")
    out_bf16 = {torch.bfloat16: 1, torch.float32: 0}.get(out_dtype)
    if out_bf16 is None:
        raise TypeError(f"out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    bm, bk = layout.block_shape
    _mm.check_blocks(a.dtype, bm, bk, bn)
    gm, gn = layout.gm, -(-n // bn)
    if gm > 65535:
        raise ValueError(f"grid too large: gm={gm}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"the output {(m, n)}")
    (scale, has_scale, bias_ptr, bias_bf16, act, res_ptr, res_bf16,
     rst, keep) = _mm.epilogue_args(epilogue, bias, residual, a.device, n)
    cols, nnz = layout.device_tensors(a.device)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    ws = None
    chunks = 1
    if sid:
        sms = _mm._sm_count(a.device.index or 0)
        if sid == 1:
            chunks = max(1, min(gn, -(-2 * sms // gm)))
        else:
            chunks = max(1, min(gm, -(-2 * sms // gn)))
        if layout.s_max > 1:
            ws = torch.empty((m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().rt_block_sparse_matmul(
        sid, in_bf16, out_bf16, cols.data_ptr(), nnz.data_ptr(),
        layout.s_max, a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(),
        b.stride(0), b.stride(1), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, k, n, bm, bk, bn, chunks,
        scale, has_scale, bias_ptr, bias_bf16, act, res_ptr, res_bf16,
        rst[1], rst[2], stream)
    build.check(err, f"block_sparse_matmul[{schedule}]")
    del keep
    LAUNCHES[f"block_sparse_matmul_{schedule}"] += 1
    return out


# ------------------------------------------------------------ dispatch
def block_sparse_matmul(a, b, layout, bias=None, residual=None, *, bn: int,
                        schedule: str = "k_inner", epilogue=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """K9 for a CUDA tensor, the plain version for a CPU tensor."""
    if a.is_cuda:
        return block_sparse_matmul_cuda(a, b, layout, bias, residual, bn=bn,
                                        schedule=schedule, epilogue=epilogue,
                                        out_dtype=out_dtype)
    if schedule not in SCHEDULE_IDS:
        raise ValueError(f"unknown schedule {schedule!r}")
    return block_sparse_matmul_plain(a, b, layout, bias, residual,
                                     epilogue=epilogue, out_dtype=out_dtype)
