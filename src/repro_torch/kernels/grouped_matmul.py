"""Grouped expert GEMM for the MoE layers: Hopper kernel + plain version.

Kernel (CUDA C++, `csrc/grouped_matmul.cu`):
  K5 — C[g] = act(scale * (A[g] @ B[g])) + residual[g], one rhs per group,
       blockIdx = (n-tile, m-tile, group), a k loop with an fp32
       accumulator, the epilogue once, one cast (replaces
       `repro/sparse/kernels.py::grouped_matmul_padded`).

A (g, m, k) and B (g, k, n) need no padding: the kernel masks ragged m, k
and n and reads both operands through their strides.  The epilogue takes
scale / act / residual; a bias raises, as in the JAX package.

`grouped_matmul` dispatches on the device of its input: a CUDA tensor
always launches the kernel (or raises); a CPU tensor runs the plain
version, which repeats the kernel's arithmetic — fp32 sums over k blocks
of width bk, in order, per group, then the epilogue.

The wrapper counts its launches in `LAUNCHES["grouped_matmul"]` (one per
kernel launch, on the CUDA path only).
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


def _check_spec(epilogue) -> tuple:
    spec = epilogue_mod.normalize_spec(epilogue)
    if any(t == "bias" for t, _ in spec):
        raise ValueError("grouped_matmul epilogue supports scale / act / "
                         "residual; bias is not plumbed per-group")
    return spec


# ------------------------------------------------------------ plain version
def grouped_matmul_plain(a: torch.Tensor, b: torch.Tensor, residual=None, *,
                         bk: int, epilogue=None,
                         out_dtype=torch.float32) -> torch.Tensor:
    """C[g] = epilogue(A[g] @ B[g]) with fp32 sums over k blocks of width
    `bk`, in order; `residual` is (g, m, n)."""
    spec = _check_spec(epilogue)
    k = a.shape[-1]
    acc = None
    for k0 in range(0, k, bk):
        part = torch.bmm(a[..., k0:k0 + bk].float(),
                         b[:, k0:k0 + bk].float())
        acc = part if acc is None else acc + part
    z = epilogue_mod.apply_spec(acc, spec, {"residual": residual})
    return z.to(out_dtype)


# ------------------------------------------------------------ CUDA launch
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("grouped_matmul")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_grouped_matmul.argtypes = [
        i, i, p, ll, ll, ll, p, ll, ll, ll, p, ll, ll, i, i, i, i, i, i, i,
        f, i, i, p, i, ll, ll, ll, p]
    lib.rt_grouped_matmul.restype = i
    return lib


def grouped_matmul_cuda(a: torch.Tensor, b: torch.Tensor, residual=None, *,
                        bm: int, bk: int, bn: int, epilogue=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """K5 on the card: a (g, m, k) @ b (g, k, n) -> (g, m, n), one launch."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"grouped operands must be 3-D, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    g, m, k = a.shape
    g2, k2, n = b.shape
    if g != g2 or k != k2:
        raise ValueError(f"group/contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError("A and B must be on the same CUDA device")
    if a.dtype != b.dtype:
        raise TypeError(f"A and B dtypes differ: {a.dtype} vs {b.dtype}")
    in_bf16 = _dtype_flag(a, "A")
    out_bf16 = {torch.bfloat16: 1, torch.float32: 0}.get(out_dtype)
    if out_bf16 is None:
        raise TypeError(f"out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    spec = _check_spec(epilogue)
    check_blocks(a.dtype, bm, bk, bn)
    if residual is not None and tuple(residual.shape) != (g, m, n):
        raise ValueError(f"residual {tuple(residual.shape)} does not match "
                         f"the output {(g, m, n)}")
    (scale, has_scale, _, _, act, res_ptr, res_bf16, rst,
     _) = epilogue_args(spec, None, residual, a.device, n)
    out = torch.empty((g, m, n), dtype=out_dtype, device=a.device)
    sa, sb, so = a.stride(), b.stride(), out.stride()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _lib().rt_grouped_matmul(
        in_bf16, out_bf16, a.data_ptr(), sa[0], sa[1], sa[2], b.data_ptr(),
        sb[0], sb[1], sb[2], out.data_ptr(), so[0], so[1], g, m, k, n, bm,
        bk, bn, scale, has_scale, act, res_ptr, res_bf16, rst[0], rst[1],
        rst[2], stream)
    build.check(err, "grouped_matmul")
    LAUNCHES["grouped_matmul"] += 1
    return out


# ------------------------------------------------------------ dispatch
def grouped_matmul(a, b, residual=None, *, bm: int, bk: int, bn: int,
                   epilogue=None, out_dtype=torch.float32) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if a.is_cuda:
        return grouped_matmul_cuda(a, b, residual, bm=bm, bk=bk, bn=bn,
                                   epilogue=epilogue, out_dtype=out_dtype)
    return grouped_matmul_plain(a, b, residual, bk=bk, epilogue=epilogue,
                                out_dtype=out_dtype)
