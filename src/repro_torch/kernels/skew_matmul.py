"""Dense schedule family of the planned matmul: Hopper kernels + plain
versions.

Kernels (CUDA C++, `csrc/skew_matmul.cu`):
  K1 — the dense family, one kernel per loop order: k_inner, a_resident,
       b_resident (replaces `repro/kernels/skew_matmul.py::
       skew_matmul_padded`);
  K2 — the batched grid: k_inner with the batch as a grid dim (replaces
       `skew_matmul_batched_padded`).

    C = act(scale * (A @ B) + bias) + residual

with fp32 accumulation, the epilogue at fp32 and one cast.  Operands need
no padding: the kernels mask ragged edges and read A and B through their
strides, so a transposed view (a tied embedding used as E^T) costs no copy.

`skew_matmul` / `skew_matmul_batched` dispatch on the device of their
input: a CUDA tensor always launches the kernel (or raises); a CPU tensor
runs the plain version, which repeats the kernels' arithmetic — fp32 sums
over k blocks of width bk, in order, then the epilogue.

Each wrapper counts its launches in `LAUNCHES` (one per kernel launch, on
the CUDA path only).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core import epilogue as epilogue_mod
from repro_torch.kernels import build

SCHEDULE_IDS = {"k_inner": 0, "a_resident": 1, "b_resident": 2}
SMEM_MAX = 232_448
LAUNCHES: collections.Counter = collections.Counter()

_ACTS = {None: 0, "gelu": 1, "silu": 2}


# ------------------------------------------------------------ plain versions
def skew_matmul_plain(a: torch.Tensor, b: torch.Tensor, bias=None,
                      residual=None, *, bk: int, epilogue=None,
                      out_dtype=torch.float32) -> torch.Tensor:
    """C = epilogue(A @ B) with fp32 sums over k blocks of width `bk`.

    `a` may carry leading batch dims (the batched variant); `residual`
    broadcast-matches the output.
    """
    k = a.shape[-1]
    acc = None
    for k0 in range(0, k, bk):
        part = torch.matmul(a[..., k0:k0 + bk].float(), b[k0:k0 + bk].float())
        acc = part if acc is None else acc + part
    ops = {"bias": bias, "residual": residual}
    z = epilogue_mod.apply_spec(acc, epilogue, ops)
    return z.to(out_dtype)


# The batched grid's plain version is the same function: a (nb, m, k).
skew_matmul_batched_plain = skew_matmul_plain


# ------------------------------------------------------------ CUDA launches
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("skew_matmul")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_skew_matmul.argtypes = [
        i, i, i, p, ll, ll, ll, p, ll, ll, p, p, i, i, i, i, i, i, i, i,
        f, i, p, i, i, p, i, ll, ll, ll, p]
    lib.rt_skew_matmul.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def smem_bytes(dtype: torch.dtype, bm: int, bk: int, bn: int) -> int:
    """Shared memory one CTA of the dense kernels uses (mirrors
    `tile_smem_bytes` in csrc/common.cuh)."""
    size = 2 if dtype == torch.bfloat16 else 4
    pad = 16 // size
    return (_round_up(bm * (bk + pad) * size, 128)
            + _round_up(bk * (bn + pad) * size, 128)
            + _round_up(bm * (bn + 4) * 4, 128))


def _dtype_flag(t: torch.Tensor, what: str) -> int:
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"{what} must be bfloat16 or float32, got {t.dtype}")


def check_blocks(dtype: torch.dtype, bm: int, bk: int, bn: int) -> None:
    """Raise ValueError for blocks the CUDA kernels cannot take."""
    if min(bm, bk, bn) <= 0 or bm % 16 or bk % 16 or bn % 16:
        raise ValueError(f"CUDA kernels need positive blocks that are "
                         f"multiples of 16, got {(bm, bk, bn)}")
    need = smem_bytes(dtype, bm, bk, bn)
    if need > SMEM_MAX:
        raise ValueError(f"blocks {(bm, bk, bn)} need {need} bytes of shared "
                         f"memory, above the {SMEM_MAX} a CTA may use")


def epilogue_args(spec, bias, residual, device, n: int):
    """(scale, has_scale, bias_ptr, bias_bf16, act, res, res_bf16, res
    strides, keepalive) for a normalized epilogue spec."""
    spec = epilogue_mod.normalize_spec(spec)
    tokens = dict(spec)
    scale = float(tokens["scale"]) if "scale" in tokens else 1.0
    act = next((t for t in tokens if t in _ACTS and t is not None), None)
    keep = []
    bias_ptr, bias_bf16 = None, 0
    if "bias" in tokens:
        if bias is None or tuple(bias.shape) != (n,):
            raise ValueError("epilogue names 'bias': pass a (n,) vector")
        bias = bias.to(device).contiguous()
        keep.append(bias)
        bias_ptr, bias_bf16 = bias.data_ptr(), _dtype_flag(bias, "bias")
    res_ptr, res_bf16, rstrides = None, 0, (0, 0, 0)
    if "residual" in tokens:
        if residual is None:
            raise ValueError("epilogue names 'residual' but none was passed")
        if residual.device != device:
            raise ValueError("residual must be on the kernel's device")
        res_ptr, res_bf16 = residual.data_ptr(), _dtype_flag(residual,
                                                             "residual")
        st = residual.stride()
        rstrides = (0,) * (3 - len(st)) + tuple(st)
    return (scale, int("scale" in tokens), bias_ptr, bias_bf16, _ACTS[act],
            res_ptr, res_bf16, rstrides, keep)


def _launch(schedule: str, a3: torch.Tensor, b: torch.Tensor, bias,
            residual, *, bm: int, bk: int, bn: int, epilogue,
            out_dtype) -> torch.Tensor:
    """Launch the dense kernel on a (nb, m, k) view; returns (nb, m, n)."""
    nb, m, k = a3.shape
    k2, n = b.shape
    if not (a3.is_cuda and b.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a3.shape)} @ "
                         f"{tuple(b.shape)}")
    if b.device != a3.device:
        raise ValueError("A and B must be on the same CUDA device")
    if a3.dtype != b.dtype:
        raise TypeError(f"A and B dtypes differ: {a3.dtype} vs {b.dtype}")
    in_bf16 = _dtype_flag(a3, "A")
    out_bf16 = {torch.bfloat16: 1, torch.float32: 0}.get(out_dtype)
    if out_bf16 is None:
        raise TypeError(f"out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    check_blocks(a3.dtype, bm, bk, bn)
    gm, gn, gk = -(-m // bm), -(-n // bn), -(-k // bk)
    if gm > 65535 or nb > 65535:
        raise ValueError(f"grid too large: gm={gm}, nb={nb}")
    if residual is not None:
        if tuple(residual.shape[-2:]) != (m, n) or (
                residual.dim() == 3 and residual.shape[0] != nb):
            raise ValueError(f"residual {tuple(residual.shape)} does not "
                             f"match the output {(nb, m, n)}")
        if residual.dim() == 3 and nb == 1:
            residual = residual[0]
    (scale, has_scale, bias_ptr, bias_bf16, act, res_ptr, res_bf16,
     rst, keep) = epilogue_args(epilogue, bias, residual, a3.device, n)
    out = torch.empty((nb, m, n), dtype=out_dtype, device=a3.device)
    sid = SCHEDULE_IDS[schedule]
    ws = None
    chunks = 1
    if sid:
        sms = _sm_count(a3.device.index or 0)
        if sid == 1:
            chunks = max(1, min(gn, -(-2 * sms // gm)))
        else:
            chunks = max(1, min(gm, -(-2 * sms // gn)))
        if gk > 1:
            ws = torch.empty((m, n), dtype=torch.float32, device=a3.device)
    sa = a3.stride()
    stream = torch.cuda.current_stream(a3.device).cuda_stream
    err = _lib().rt_skew_matmul(
        sid, in_bf16, out_bf16, a3.data_ptr(), sa[0], sa[1], sa[2],
        b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(),
        None if ws is None else ws.data_ptr(), nb, m, k, n, bm, bk, bn,
        chunks, scale, has_scale, bias_ptr, bias_bf16, act, res_ptr,
        res_bf16, rst[0], rst[1], rst[2], stream)
    build.check(err, f"skew_matmul[{schedule}]")
    # `keep` (a contiguous bias copy) may be freed once the launch is
    # enqueued: the caching allocator reuses it only for later work on
    # this stream.
    del keep
    return out


def skew_matmul_cuda(a, b, bias=None, residual=None, *, bm: int, bk: int,
                     bn: int, schedule: str = "k_inner", epilogue=None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """K1 on the card: a (m, k) @ b (k, n) -> (m, n) in one launch."""
    if schedule not in SCHEDULE_IDS:
        raise ValueError(f"unknown schedule {schedule!r}")
    out = _launch(schedule, a.unsqueeze(0), b, bias, residual, bm=bm, bk=bk,
                  bn=bn, epilogue=epilogue, out_dtype=out_dtype)
    LAUNCHES[f"skew_matmul_{schedule}"] += 1
    return out[0]


def skew_matmul_batched_cuda(a, b, bias=None, residual=None, *, bm: int,
                             bk: int, bn: int, epilogue=None,
                             out_dtype=torch.float32) -> torch.Tensor:
    """K2 on the card: a (nb, m, k) @ b (k, n) -> (nb, m, n), one launch."""
    out = _launch("k_inner", a, b, bias, residual, bm=bm, bk=bk, bn=bn,
                  epilogue=epilogue, out_dtype=out_dtype)
    LAUNCHES["skew_matmul_batched"] += 1
    return out


# ------------------------------------------------------------ dispatch
def skew_matmul(a, b, bias=None, residual=None, *, bm: int, bk: int,
                bn: int, schedule: str = "k_inner", epilogue=None,
                out_dtype=torch.float32) -> torch.Tensor:
    """Dense family: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if a.is_cuda:
        return skew_matmul_cuda(a, b, bias, residual, bm=bm, bk=bk, bn=bn,
                                schedule=schedule, epilogue=epilogue,
                                out_dtype=out_dtype)
    if schedule not in SCHEDULE_IDS:
        raise ValueError(f"unknown schedule {schedule!r}")
    return skew_matmul_plain(a, b, bias, residual, bk=bk, epilogue=epilogue,
                             out_dtype=out_dtype)


def skew_matmul_batched(a, b, bias=None, residual=None, *, bm: int, bk: int,
                        bn: int, epilogue=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Batched grid: the kernel for a CUDA tensor, else the plain version."""
    if a.is_cuda:
        return skew_matmul_batched_cuda(a, b, bias, residual, bm=bm, bk=bk,
                                        bn=bn, epilogue=epilogue,
                                        out_dtype=out_dtype)
    return skew_matmul_batched_plain(a, b, bias, residual, bk=bk,
                                     epilogue=epilogue, out_dtype=out_dtype)
