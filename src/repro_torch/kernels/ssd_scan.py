"""Mamba-2 SSD chunked scan for the SSM prefill: Hopper kernel + plain version.

Kernel (CUDA C++, `csrc/ssd_scan.cu`):
  K8 — per head and chunk of Q rows, with cum the running sum of dt * A
       (A = -exp(a_log)):
         y     = (C B^T o exp(cum_i - cum_j)[i >= j]) @ (x dt)
                 + exp(cum) o (C @ state)
         state = exp(cum_last) state + B^T @ (exp(cum_last - cum) x dt)
       in fp32 (cum and its differences in fp64), one CTA per (head,
       batch row) walking the chunks with the (S, P) state in shared
       memory (replaces
       `repro/kernels/ssd_scan.py::ssd_scan`).

x (B, L, H, P) and B / C (B, L, G, S) are read in place through their
(batch, step, head / group) strides with a unit stride along P / S, in one
type (bf16 or fp32); dt (B, L, H) is fp32, a_log (H,) fp32.  The heads of a
group share its B and C (group h // (H / G)), with no repeat.  Any L works:
the tail of the last chunk is masked (the TPU kernel needs L % chunk == 0).
y comes back in x's type, (B, L, H, P), and with ``return_state=True`` so
does the fp32 state after the last position, (B, H, S, P) — the layout of
`models.ssm.ssd_chunked` and of the decode cache, which the serving prefill
fills from it.  The kernel takes P <= 64, S <= 128 and a chunk of at most
128 rows; `ssd_scan_cuda` raises on anything else.

`ssd_scan` dispatches on the device of its input: a CUDA tensor always
launches the kernel (or raises); a CPU tensor runs the plain version, the
same chunk math in PyTorch (fp32 products, the log-decay prefix sum in
fp64).  The plain version also serves, with the JAX package's rounding
points, as the "torch" rung of `models.ssm`.

The wrapper counts its launches in `LAUNCHES["ssd_scan"]` (one per kernel
launch, on the CUDA path only).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES: collections.Counter = collections.Counter()
P_MAX, S_MAX, CHUNK_MAX = 64, 128, 128


# ------------------------------------------------------------ plain version
def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                   chunk: int = 128, init_state: torch.Tensor | None = None,
                   return_state: bool = False, round_dtype=None,
                   cum_dtype: torch.dtype = torch.float64):
    """The chunked SSD in PyTorch, one chunk at a time, for any L (the last
    chunk is simply shorter), from `init_state` (B, H, S, P) or zeros.

    With the defaults it is K8's math: fp32 products, the log-decay prefix
    sum and its pairwise differences in fp64, rounded to fp32 for exp.
    `round_dtype` rounds x * dt, the scores and the decayed B to that type
    where the JAX package's model path does (fp32 sums all the same), and
    `cum_dtype=torch.float32` takes its fp32 prefix sum: `models.ssm`'s
    "torch" rung passes both.  Masked decay entries (j > i) are
    exp(-inf) = 0, never an overflowed exp times a 0/1 mask."""
    bsz, length, h, p = x.shape
    g, s = b_mat.shape[2], b_mat.shape[3]
    rep = h // g

    def rnd(t):
        return t if round_dtype is None else t.to(round_dtype).float()

    neg_a = -torch.exp(a_log.float())                           # (H,)
    state = (torch.zeros((bsz, h, s, p), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    y = torch.empty((bsz, length, h, p), dtype=x.dtype, device=x.device)
    for c0 in range(0, length, chunk):
        c1 = min(c0 + chunk, length)
        dtq = dt[:, c0:c1].float()                              # (B,n,H)
        xdt = rnd(x[:, c0:c1].float() * rnd(dtq)[..., None])    # (B,n,H,P)
        bq = b_mat[:, c0:c1].float().repeat_interleave(rep, dim=2)
        cq = c_mat[:, c0:c1].float().repeat_interleave(rep, dim=2)
        cum = torch.cumsum((dtq * neg_a).to(cum_dtype), dim=1)  # (B,n,H)
        n = c1 - c0
        causal = torch.ones((n, n), dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).float()  # (B,i,j,H)
        decay = torch.exp(torch.where(causal, diff, float("-inf")))
        scores = rnd(torch.einsum("bihs,bjhs->bijh", cq, bq) * decay)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        y_inter = torch.einsum("bihs,bhsp->bihp", cq, state)
        y[:, c0:c1] = (y_intra + torch.exp(cum.float())[..., None] * y_inter
                       ).to(x.dtype)
        last = cum[:, -1]                                       # (B,H)
        w = torch.exp((last[:, None] - cum).float())[..., None]  # (B,n,H,1)
        state = state * torch.exp(last.float())[..., None, None] + \
            torch.einsum("bjhs,bjhp->bhsp", rnd(bq * w), xdt)
    if return_state:
        return y, state
    return y


# ------------------------------------------------------------ CUDA launch
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rt_ssd_scan.argtypes = [i, p, ll, ll, ll, p, ll, ll, ll, p,
                                p, ll, ll, ll, p, ll, ll, ll, p, p,
                                i, i, i, i, i, i, i, p]
    lib.rt_ssd_scan.restype = i
    return lib


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                  chunk: int = 128, return_state: bool = False):
    """K8 on the card, one launch; raises on what the kernel does not
    take."""
    ts = (x, dt, a_log, b_mat, c_mat)
    if not all(t.is_cuda for t in ts):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("x, dt, a_log, B and C must be on one CUDA device")
    if x.dim() != 4 or b_mat.dim() != 4 or c_mat.shape != b_mat.shape:
        raise ValueError(f"x must be (B, L, H, P) and B, C one (B, L, G, S) "
                         f"shape, got {tuple(x.shape)}, "
                         f"{tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    bsz, length, h, p = x.shape
    g, s = b_mat.shape[2], b_mat.shape[3]
    if tuple(b_mat.shape[:2]) != (bsz, length) or g < 1 or h % g:
        raise ValueError(f"B / C {tuple(b_mat.shape)} do not match x "
                         f"{tuple(x.shape)} (H % G == 0)")
    if tuple(dt.shape) != (bsz, length, h) or tuple(a_log.shape) != (h,):
        raise ValueError(f"dt must be {(bsz, length, h)} and a_log {(h,)}, "
                         f"got {tuple(dt.shape)}, {tuple(a_log.shape)}")
    if not 1 <= p <= P_MAX or not 1 <= s <= S_MAX:
        raise ValueError(f"K8 takes head dim P <= {P_MAX} and state "
                         f"S <= {S_MAX}, got P {p}, S {s}")
    if not 1 <= chunk <= CHUNK_MAX:
        raise ValueError(f"K8 takes a chunk of 1..{CHUNK_MAX} rows, got "
                         f"{chunk}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the grid's 65535 rows")
    if not (x.dtype == b_mat.dtype == c_mat.dtype) or x.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"x, B and C must share dtype bfloat16 or float32, "
                        f"got {x.dtype}, {b_mat.dtype}, {c_mat.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"dt and a_log must be float32, got {dt.dtype}, "
                        f"{a_log.dtype}")
    if x.stride(3) != 1 or b_mat.stride(3) != 1 or c_mat.stride(3) != 1:
        raise ValueError("x, B and C need a unit stride along P / S")
    a_log = a_log.contiguous()
    y = torch.empty((bsz, length, h, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((bsz, h, s, p), dtype=torch.float32,
                         device=x.device) if return_state else None)
    if bsz * length * h:
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().rt_ssd_scan(
            int(x.dtype == torch.bfloat16), x.data_ptr(), x.stride(0),
            x.stride(1), x.stride(2), dt.data_ptr(), dt.stride(0),
            dt.stride(1), dt.stride(2), a_log.data_ptr(), b_mat.data_ptr(),
            b_mat.stride(0), b_mat.stride(1), b_mat.stride(2),
            c_mat.data_ptr(), c_mat.stride(0), c_mat.stride(1),
            c_mat.stride(2), y.data_ptr(),
            None if state is None else state.data_ptr(), bsz, length, h, g,
            p, s, chunk, stream)
        build.check(err, "ssd_scan")
        LAUNCHES["ssd_scan"] += 1
    if return_state:
        return y, state
    return y


# ------------------------------------------------------------ dispatch
def ssd_scan(x, dt, a_log, b_mat, c_mat, *, chunk: int = 128,
             return_state: bool = False):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    fn = ssd_scan_cuda if x.is_cuda else ssd_scan_plain
    return fn(x, dt, a_log, b_mat, c_mat, chunk=chunk,
              return_state=return_state)
