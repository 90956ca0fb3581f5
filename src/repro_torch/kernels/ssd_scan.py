"""Mamba-2 SSD chunked scan for the SSM prefill: Hopper kernel + plain version.

Kernels (CUDA C++, `csrc/ssd_scan.cu`):
  K8 — per head and chunk of Q rows, with cum the running sum of dt * A
       (A = -exp(a_log)):
         y     = (C B^T o exp(cum_i - cum_j)[i >= j]) @ (x dt)
                 + exp(cum) o (C @ state)
         state = exp(cum_last) state + B^T @ (exp(cum_last - cum) x dt)
       with fp32 sums (cum and its differences in fp64); for bf16 inputs
       every product on the tensor cores, an fp32 operand as two bf16
       terms (hi, lo), for fp32 inputs fp32 FMAs; chunk-parallel:
       `ssd_chunk_state` computes every chunk's own state term dS
       independently, `ssd_state_pass` carries the state over the chunks
       (parallel over B x H x S x P) and `ssd_scan` reads y out per
       (chunk, strip of 64 rows); with one chunk only `ssd_scan` runs,
       from a zero state (replaces `repro/kernels/ssd_scan.py::ssd_scan`).

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

The wrapper counts each kernel's launches under its name in `LAUNCHES`
(on the CUDA path only): `ssd_scan` once per call, `ssd_chunk_state` and
`ssd_state_pass` once each per call with more than one chunk.
`ssd_config` sizes the three grids and the workspace;
`ssd_chunk_state_plain` and `ssd_state_pass_plain` are the first two
kernels' plain pieces, which the card's checks hold them against.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

LAUNCHES: collections.Counter = collections.Counter()
P_MAX, S_MAX, CHUNK_MAX = 64, 128, 128
# The kernels' fixed shapes (csrc/ssd_scan.cu): 256 threads a CTA, y rows a
# readout CTA owns, state rows (of S) a chunk-state CTA owns, state-pass
# threads; shared memory (bytes) of the readout and the chunk-state CTA by
# input type, mirroring `readout_smem` / `chunk_state_smem`.
THREADS, STRIP, S_BLOCK, PASS_THREADS = 256, 64, 64, 256
# cum (fp64), dt and the state weights (fp32) a chunk row; regions X and Z
# (bf16: a split (k, p) operand, two bf16 planes of rows of P + 8; fp32:
# rows of P + 4) and the rows of B (S + 8 bf16, S + 4 fp32).
_HEAD = CHUNK_MAX * 16
_REGION = {torch.bfloat16: 2 * CHUNK_MAX * (P_MAX + 8) * 2,
           torch.float32: CHUNK_MAX * (P_MAX + 4) * 4}
_B_ROW = {torch.bfloat16: (S_MAX + 8) * 2, torch.float32: (S_MAX + 4) * 4}
_B_BLOCK_ROW = {torch.bfloat16: (S_BLOCK + 8) * 2,
                torch.float32: (S_BLOCK + 4) * 4}
READOUT_SMEM = {t: _HEAD + 2 * _REGION[t] + CHUNK_MAX * _B_ROW[t]
                for t in _REGION}
CHUNK_STATE_SMEM = {t: _HEAD + CHUNK_MAX * _B_BLOCK_ROW[t] + _REGION[t]
                    for t in _REGION}
SM_SMEM, CTA_RESERVED, SM_THREADS = 233472, 1024, 2048   # per SM on sm_90


@dataclasses.dataclass(frozen=True)
class SsdConfig:
    """K8's decomposition of one call: `q` rows a chunk (the whole
    sequence when L <= chunk), `nc` chunks; the readout grid `readout`
    (nc * H * strips, B) of `strips` 64-row strips a chunk; with nc > 1 the
    chunk-state grid `chunk_state` (ncs * H * s_blocks, B) over the first
    `ncs` chunks (all with the state returned, else all but the last), the
    state-pass grid `state_pass` (ceil(S * ldp / 4 / 256), H, B) and the fp32
    workspace `ws_shape` (B, H, nc, S, ldp); with one chunk those are None
    and the readout's strip k also writes the state's S blocks k, k +
    strips, ...  `*_smem` are bytes of shared memory a CTA, `*_per_sm` the
    CTAs an SM holds by shared memory and threads."""
    q: int
    nc: int
    ncs: int
    strips: int
    s_blocks: int
    ldp: int
    readout: tuple
    chunk_state: tuple | None
    state_pass: tuple | None
    ws_shape: tuple | None
    readout_smem: int
    chunk_state_smem: int
    readout_per_sm: int
    chunk_state_per_sm: int


def _per_sm(smem: int) -> int:
    return min(SM_SMEM // (smem + CTA_RESERVED), SM_THREADS // THREADS)


def ssd_config(b: int, length: int, h: int, p: int, s: int, chunk: int,
               dtype: torch.dtype, return_state: bool = True) -> SsdConfig:
    """K8's grids, workspace and shared memory for x (b, length, h, p),
    B / C (.., s) at `chunk` (mirrors csrc/ssd_scan.cu)."""
    q = min(chunk, length)
    nc = -(-length // q)
    strips, s_blocks, ldp = -(-q // STRIP), -(-s // S_BLOCK), -(-p // 4) * 4
    multi = nc > 1
    ncs = nc if return_state else nc - 1
    return SsdConfig(
        q, nc, ncs if multi else 0, strips, s_blocks, ldp,
        (nc * h * strips, b),
        (ncs * h * s_blocks, b) if multi else None,
        (-(-(s * ldp // 4) // PASS_THREADS), h, b) if multi else None,
        (b, h, nc, s, ldp) if multi else None,
        READOUT_SMEM[dtype], CHUNK_STATE_SMEM[dtype],
        _per_sm(READOUT_SMEM[dtype]), _per_sm(CHUNK_STATE_SMEM[dtype]))


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


def ssd_chunk_state_plain(x: torch.Tensor, dt: torch.Tensor,
                          a_log: torch.Tensor, b_mat: torch.Tensor, *,
                          chunk: int = 128, ncs: int | None = None):
    """`ssd_chunk_state`'s function in PyTorch: for each of the first `ncs`
    chunks (default all) of min(chunk, L) rows, on its own, dS_c = B_c^T
    (exp(cum_last - cum) x dt) (B, H, ncs, S, P) fp32 and exp(cum_last)
    (B, H, ncs), the log-decay prefix sum in fp64 as in `ssd_scan_plain`."""
    bsz, length, h, p = x.shape
    g, s = b_mat.shape[2], b_mat.shape[3]
    q = min(chunk, length)
    ncs = -(-length // q) if ncs is None else ncs
    neg_a = -torch.exp(a_log.float())
    ds = torch.empty((bsz, h, ncs, s, p), dtype=torch.float32,
                     device=x.device)
    decay = torch.empty((bsz, h, ncs), dtype=torch.float32, device=x.device)
    for c in range(ncs):
        c0, c1 = c * q, min(c * q + q, length)
        dtq = dt[:, c0:c1].float()
        xdt = x[:, c0:c1].float() * dtq[..., None]
        bq = b_mat[:, c0:c1].float().repeat_interleave(h // g, dim=2)
        cum = torch.cumsum((dtq * neg_a).double(), dim=1)
        last = cum[:, -1]
        w = torch.exp((last[:, None] - cum).float())[..., None]
        ds[:, :, c] = torch.einsum("bjhs,bjhp->bhsp", bq, xdt * w)
        decay[:, :, c] = torch.exp(last.float())
    return ds, decay


def ssd_state_pass_plain(ds: torch.Tensor, decay: torch.Tensor, nc: int):
    """`ssd_state_pass`'s function in PyTorch: the state carried over nc
    chunks from the first ncs = ds.shape[2] chunk terms, state_c =
    state_{c-1} * decay_c + dS_c from zero.  Returns each chunk's incoming
    state (B, H, nc, S, P) (chunk 0's is zero) and the state after chunk
    ncs - 1."""
    st = torch.zeros_like(ds[:, :, 0])
    incoming = torch.empty(ds.shape[:2] + (nc,) + ds.shape[3:],
                           dtype=torch.float32, device=ds.device)
    for c in range(nc):
        incoming[:, :, c] = st
        if c < ds.shape[2]:
            st = st * decay[:, :, c, None, None] + ds[:, :, c]
    return incoming, st


# ------------------------------------------------------------ CUDA launch
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rt_ssd_chunk_state.argtypes = [i, p, ll, ll, ll, p, ll, ll, ll, p,
                                       p, ll, ll, ll, p, p,
                                       i, i, i, i, i, i, i, i, p]
    lib.rt_ssd_state_pass.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.rt_ssd_scan.argtypes = [i, p, ll, ll, ll, p, ll, ll, ll, p,
                                p, ll, ll, ll, p, ll, ll, ll, p, p, p,
                                i, i, i, i, i, i, i, p]
    for fn in (lib.rt_ssd_chunk_state, lib.rt_ssd_state_pass,
               lib.rt_ssd_scan):
        fn.restype = i
    return lib


def _check(x, dt, a_log, b_mat, c_mat, chunk: int) -> None:
    """Raise on what the kernels do not take."""
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


def _xs(x, dt, a_log, b_mat) -> tuple:
    """The launches' leading arguments: x, dt, a_log and B with strides."""
    return (int(x.dtype == torch.bfloat16), x.data_ptr(), x.stride(0),
            x.stride(1), x.stride(2), dt.data_ptr(), dt.stride(0),
            dt.stride(1), dt.stride(2), a_log.data_ptr(), b_mat.data_ptr(),
            b_mat.stride(0), b_mat.stride(1), b_mat.stride(2))


def _dims(x, b_mat, chunk: int) -> tuple:
    bsz, length, h, p = x.shape
    return (bsz, length, h, b_mat.shape[2], p, b_mat.shape[3], chunk)


def ssd_chunk_state_cuda(x: torch.Tensor, dt: torch.Tensor,
                         a_log: torch.Tensor, b_mat: torch.Tensor, *,
                         chunk: int = 128, return_state: bool = True):
    """`ssd_chunk_state` on the card, one launch, for a sequence of more
    than one chunk: the fp32 workspace (B, H, nc, S, ldp) holding dS_c of
    the first ncs chunks (all with `return_state`, else all but the last;
    the columns past P are 0) and exp(cum_last) (B, H, nc)."""
    _check(x, dt, a_log, b_mat, b_mat, chunk)
    a_log = a_log.contiguous()
    bsz, length, h, p = x.shape
    cfg = ssd_config(bsz, length, h, p, b_mat.shape[3], chunk, x.dtype,
                     return_state)
    if cfg.ws_shape is None:
        raise ValueError(f"L {length} is one chunk of {chunk}: the readout "
                         f"alone computes it")
    ws = torch.empty(cfg.ws_shape, dtype=torch.float32, device=x.device)
    decay = torch.empty(cfg.ws_shape[:3], dtype=torch.float32,
                        device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(_lib().rt_ssd_chunk_state(
        *_xs(x, dt, a_log, b_mat), ws.data_ptr(), decay.data_ptr(),
        *_dims(x, b_mat, chunk), cfg.ncs, stream), "ssd_chunk_state")
    LAUNCHES["ssd_chunk_state"] += 1
    return ws, decay


def ssd_state_pass_cuda(ws: torch.Tensor, decay: torch.Tensor, p: int, *,
                        return_state: bool = True):
    """`ssd_state_pass` on the card, one launch, over `ssd_chunk_state_cuda`'s
    workspace of head dim p: chunk c > 0's slot gets its incoming state in
    place; with `return_state` (every chunk's dS computed) returns the fp32
    state after the last chunk (B, H, S, P), else None."""
    bsz, h, nc, s, ldp = ws.shape
    if not (ws.is_cuda and ws.dtype == decay.dtype == torch.float32
            and ws.is_contiguous() and decay.is_contiguous()
            and tuple(decay.shape) == (bsz, h, nc) and nc > 1
            and ldp == -(-p // 4) * 4):
        raise ValueError(f"ws {tuple(ws.shape)} / decay "
                         f"{tuple(decay.shape)} are not a K8 workspace of "
                         f"head dim {p}")
    state = (torch.empty((bsz, h, s, p), dtype=torch.float32,
                         device=ws.device) if return_state else None)
    stream = torch.cuda.current_stream(ws.device).cuda_stream
    build.check(_lib().rt_ssd_state_pass(
        ws.data_ptr(), decay.data_ptr(),
        None if state is None else state.data_ptr(), bsz, h, nc,
        nc if return_state else nc - 1, s, p, stream), "ssd_state_pass")
    LAUNCHES["ssd_state_pass"] += 1
    return state


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                  chunk: int = 128, return_state: bool = False):
    """K8 on the card: the readout alone for one chunk, else the chunk
    states, the state pass and the readout; raises on what the kernels do
    not take."""
    _check(x, dt, a_log, b_mat, c_mat, chunk)
    a_log = a_log.contiguous()
    bsz, length, h, p = x.shape
    y = torch.empty((bsz, length, h, p), dtype=x.dtype, device=x.device)
    state = ws = None
    if bsz * length * h:
        if length > min(chunk, length):
            ws, decay = ssd_chunk_state_cuda(x, dt, a_log, b_mat,
                                             chunk=chunk,
                                             return_state=return_state)
            state = ssd_state_pass_cuda(ws, decay, p,
                                        return_state=return_state)
        elif return_state:
            state = torch.empty((bsz, h, b_mat.shape[3], p),
                                dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(_lib().rt_ssd_scan(
            *_xs(x, dt, a_log, b_mat), c_mat.data_ptr(), c_mat.stride(0),
            c_mat.stride(1), c_mat.stride(2), y.data_ptr(),
            None if state is None else state.data_ptr(),
            None if ws is None else ws.data_ptr(), *_dims(x, b_mat, chunk),
            stream), "ssd_scan")
        LAUNCHES["ssd_scan"] += 1
    elif return_state:
        state = torch.empty((bsz, h, b_mat.shape[3], p), dtype=torch.float32,
                            device=x.device)
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
