"""RG-LRU scan for the recurrent prefill: Hopper kernel + plain version.

Kernel (CUDA C++, `csrc/rglru_scan.cu`):
  K6 — log a_t = -c * sigmoid(r_t) * softplus(Lambda),
       h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * sigmoid(i_t) * x_t,
       in fp32, as a chunked two-level scan: a CTA owns a tile of channels
       of one batch row and walks the sequence in blocks of nseg * T
       steps; each of its nseg segments composes its T steps into (prod a,
       h from zero) in registers, folds the earlier segments' composites
       onto the carried h and re-walks its steps to store y
       (`rglru_config` sizes the walk; replaces
       `repro/kernels/rglru_scan.py::rglru_scan`).

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
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.kernels import skew_matmul as _mm

LAUNCHES: collections.Counter = collections.Counter()
# The kernel's fixed shapes (csrc/rglru_scan.cu): threads a CTA, the most
# steps a thread owns in a block, the channel tiles it takes.
THREADS, T_MAX, CHANNEL_TILES = 256, 8, (32, 16)


@dataclasses.dataclass(frozen=True)
class RglruConfig:
    """K6's walk: `ch` channels a CTA, `vec` a thread, so `tpr` threads a
    step and `nseg` segments of `t` steps in a block of nseg * t steps;
    the grid is `grid` (ceil(D / ch), B); `smem` bytes of static shared
    memory a CTA (the segments' composites and the carry)."""
    ch: int
    vec: int
    tpr: int
    nseg: int
    t: int
    grid: tuple
    smem: int


def rglru_config(b: int, length: int, d: int, vec: int,
                 sms: int) -> RglruConfig:
    """The widest channel tile whose grid fills `sms` SMs (else the
    narrowest), and T = ceil(L / nseg) up to `T_MAX`, so a short sequence
    is one block; `vec` is 2 where the rows take paired loads, else 1."""
    ch = next((w for w in CHANNEL_TILES if b * -(-d // w) >= sms),
              CHANNEL_TILES[-1])
    tpr = ch // vec
    nseg = THREADS // tpr
    t = max(1, min(T_MAX, -(-length // nseg)))
    return RglruConfig(ch, vec, tpr, nseg, t, (-(-d // ch), b),
                       (2 * THREADS * vec + CHANNEL_TILES[0]) * 4)


def pair_aligned(d: int, *ts: torch.Tensor) -> bool:
    """Whether every (step, channel pair) of these (B, L, D) views starts on
    two elements: D even, even batch and step strides, aligned bases."""
    return d % 2 == 0 and all(
        t.data_ptr() % (2 * t.element_size()) == 0
        and t.stride(0) % 2 == 0 and t.stride(1) % 2 == 0 for t in ts)


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
                                  p, i, i, i, f, i, i, i, p]
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
        cfg = rglru_config(b, length, d,
                           2 if pair_aligned(d, x, r_gate, i_gate) else 1,
                           _mm._sm_count(x.device.index or 0))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().rt_rglru_scan(
            int(x.dtype == torch.bfloat16), x.data_ptr(), x.stride(0),
            x.stride(1), r_gate.data_ptr(), r_gate.stride(0),
            r_gate.stride(1), i_gate.data_ptr(), i_gate.stride(0),
            i_gate.stride(1), lam.data_ptr(), y.data_ptr(),
            None if h_last is None else h_last.data_ptr(), b, length, d,
            float(c), cfg.ch, cfg.vec, cfg.t, stream)
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
