"""RG-LRU scan for the recurrent prefill: Hopper kernel + plain version.

Kernel (CUDA C++, `csrc/rglru_scan.cu`):
  K6 — log a_t = -c * sigmoid(r_t) * softplus(Lambda),
       h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * sigmoid(i_t) * x_t,
       one thread per (batch row, channel) walking the sequence in fp32
       (replaces `repro/kernels/rglru_scan.py::rglru_scan`).

x, r_gate, i_gate (B, L, D) are read through their (batch, step) strides
with a unit stride along D, in one type (bf16 or fp32); a_param (D,) is
Lambda.  Any L works (the TPU kernel needs L % chunk == 0).  y comes back
in x's type and, with ``return_state=True``, so does the fp32 state after
the last position (B, D), which the serving prefill hands to decode.

`rglru_scan` dispatches on the device of its input: a CUDA tensor always
launches the kernel (or raises); a CPU tensor runs the plain version, the
same sequential fp32 walk (`kernels.ref.rglru_ref`).

The wrapper counts its launches in `LAUNCHES["rglru_scan"]` (one per
kernel launch, on the CUDA path only).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

LAUNCHES: collections.Counter = collections.Counter()


# ------------------------------------------------------------ plain version
def rglru_scan_plain(x: torch.Tensor, r_gate: torch.Tensor,
                     i_gate: torch.Tensor, a_param: torch.Tensor, *,
                     c: float = 8.0, return_state: bool = False):
    """The kernel's sequential fp32 walk in PyTorch."""
    return ref.rglru_ref(x, r_gate, i_gate, a_param, c=c,
                         return_state=return_state)


# ------------------------------------------------------------ CUDA launch
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_rglru_scan.argtypes = [i, p, ll, ll, p, ll, ll, p, ll, ll, p, p,
                                  p, i, i, i, f, p]
    lib.rt_rglru_scan.restype = i
    return lib


def rglru_scan_cuda(x: torch.Tensor, r_gate: torch.Tensor,
                    i_gate: torch.Tensor, a_param: torch.Tensor, *,
                    c: float = 8.0, return_state: bool = False):
    """K6 on the card, one launch; raises on what the kernel does not
    take."""
    ts = (x, r_gate, i_gate, a_param)
    if not all(t.is_cuda for t in ts):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("x, gates and a_param must be on one CUDA device")
    if x.dim() != 3 or r_gate.shape != x.shape or i_gate.shape != x.shape:
        raise ValueError(f"x, r_gate, i_gate must share one (B, L, D) shape, "
                         f"got {tuple(x.shape)}, {tuple(r_gate.shape)}, "
                         f"{tuple(i_gate.shape)}")
    b, length, d = x.shape
    if tuple(a_param.shape) != (d,):
        raise ValueError(f"a_param must be ({d},), got "
                         f"{tuple(a_param.shape)}")
    if not (x.dtype == r_gate.dtype == i_gate.dtype) or x.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"x and the gates must share dtype bfloat16 or "
                        f"float32, got {x.dtype}, {r_gate.dtype}, "
                        f"{i_gate.dtype}")
    if any(t.stride(2) != 1 for t in ts[:3]):
        raise ValueError("x and the gates need a unit stride along D")
    lam = a_param.float().contiguous()
    y = torch.empty((b, length, d), dtype=x.dtype, device=x.device)
    h_last = (torch.empty((b, d), dtype=torch.float32, device=x.device)
              if return_state else None)
    if b * d:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().rt_rglru_scan(
            int(x.dtype == torch.bfloat16), x.data_ptr(), x.stride(0),
            x.stride(1), r_gate.data_ptr(), r_gate.stride(0),
            r_gate.stride(1), i_gate.data_ptr(), i_gate.stride(0),
            i_gate.stride(1), lam.data_ptr(), y.data_ptr(),
            None if h_last is None else h_last.data_ptr(), b, length, d,
            float(c), stream)
        build.check(err, "rglru_scan")
        LAUNCHES["rglru_scan"] += 1
    if return_state:
        return y, h_last
    return y


# ------------------------------------------------------------ dispatch
def rglru_scan(x, r_gate, i_gate, a_param, *, c: float = 8.0,
               return_state: bool = False):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    fn = rglru_scan_cuda if x.is_cuda else rglru_scan_plain
    return fn(x, r_gate, i_gate, a_param, c=c, return_state=return_state)
