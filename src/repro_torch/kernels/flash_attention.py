"""Flash attention for prefill: Hopper kernel + plain version.

Kernel (CUDA C++, `csrc/flash_attention.cu`):
  K7 — online-softmax attention with a causal mask, a sliding window
       (col > row - window), a tanh soft-cap after the scale, and GQA / MQA
       through kv head = q head // (Hq / Hkv); one CTA per (q head, batch
       row, q tile) looping over the kv tiles that some row of the tile
       can see (replaces `repro/kernels/flash_attention.py::
       flash_attention`).

q (B, Hq, Sq, D), k (B, Hkv, Skv, D) and v (B, Hkv, Skv, Dv) are read
through their strides (the model's transposed views cost no copy); D must
be a multiple of 16 up to 256 and Dv one no larger than D (MLA's prefill:
D 192, Dv 128), each with a unit stride.  Rows and columns are indexed
from 0, as in the TPU kernel: the prefill's positions.  Ragged Sq and Skv are masked, so no
length has to divide a tile.  The kernel writes its output in (B, Sq, Hq,
Dv) memory and returns the (B, Hq, Sq, Dv) view, so the model's transpose
back to tokens is free.  The bf16 route keeps O's registers at Dv's width
(128 at MLA's 192 / 128, not 256); V's rows sit at K's pitch in shared
memory, so the tiles and stages below depend on D alone.

Tiles (q rows x kv columns): `tiles(dtype, d)`.  bf16 (the served
route: S, P and O in registers, K and V on a `cp.async` ring): 128 x 64 at
every head dim (8 warps); the kernel takes q rows a multiple of 16 up to
128 (a warp each 16 rows) and 64 kv columns, with `stages(bq, bkv, d)`
ring stages.  fp32 (every intermediate in shared memory): the
largest of 64 x 64, 64 x 32, 32 x 32, 16 x 16 whose shared memory fits a
CTA.  The plain version walks the same tiles, since the online softmax's
rounding depends on the kv tiling.

`flash_attention` dispatches on the device of its input: a CUDA tensor
always launches the kernel (or raises); a CPU tensor runs the plain
version, which repeats the kernel's arithmetic — fp32 scores from the
input-type operands, the online softmax per kv tile in the kernel's order,
and P as the sum of its two input-type terms hi + lo, the kernel's
tensor-core operands (P itself in fp32).

The wrapper counts its launches in `LAUNCHES["flash_attention"]` (one per
kernel launch, on the CUDA path only).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES: collections.Counter = collections.Counter()
SMEM_MAX = 232_448
NEG_INF = -1e30
TILE_CHOICES = ((64, 64), (64, 32), (32, 32), (16, 16))   # fp32
BF16_BKV = 64


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _bf16_rows_bytes(rows: int, d: int) -> int:
    return _align128(rows * (d + 8) * 2)


def _bf16_smem(bq: int, bkv: int, d: int, stages: int) -> int:
    return _bf16_rows_bytes(bq, d) + 2 * stages * _bf16_rows_bytes(bkv, d)


def stages(bq: int, bkv: int, d: int) -> int:
    """The bf16 kernel's K / V ring depth (mirrors `fa_mma_stages` in the
    source): 4 to 2 stages within two CTAs an SM, else within one; 0 when
    not even two fit."""
    for cap in ((SMEM_MAX - 1024) // 2, SMEM_MAX):
        for s in (4, 3, 2):
            if _bf16_smem(bq, bkv, d, s) <= cap:
                return s
    return 0


def smem_bytes(dtype: torch.dtype, bq: int, bkv: int, d: int,
               dv: int | None = None) -> int:
    """Shared memory of one CTA at q / k width d and v width dv (default
    d).  bf16 (mirrors `fa_mma_smem`): Q and the K / V ring, rows padded by
    16 bytes (two stages' worth where none fits), V at K's pitch.  fp32
    (mirrors `fa_smem_bytes`): Q, K^T, V, the scores S, P, O and the
    running max and sum."""
    if dtype == torch.bfloat16:
        return _bf16_smem(bq, bkv, d, stages(bq, bkv, d) or 2)
    dv = dv or d
    pad = 4
    return (_align128(bq * (d + pad) * 4) + _align128(d * (bkv + pad) * 4)
            + _align128(bkv * (dv + pad) * 4) + _align128(bq * (bkv + 4) * 4)
            + _align128(bq * (bkv + pad) * 4)
            + _align128(bq * (dv + 4) * 4) + 2 * _align128(bq * 4))


def tiles(dtype: torch.dtype, d: int,
          dv: int | None = None) -> tuple[int, int]:
    """The kernel's (q rows, kv columns) per tile at q / k width `d` and v
    width `dv` (default d)."""
    if dtype == torch.bfloat16:
        return 128, BF16_BKV
    for bq, bkv in TILE_CHOICES:
        if smem_bytes(dtype, bq, bkv, d, dv) <= SMEM_MAX:
            return bq, bkv
    raise ValueError(f"no flash-attention tile fits head dim {d}")


def takes_tiles(dtype: torch.dtype, bq: int, bkv: int, d: int,
                dv: int | None = None) -> bool:
    """Whether the kernel takes (bq, bkv) at widths d / dv: bf16 q rows a
    multiple of 16 up to 128 and 64 kv columns, fp32 multiples of 16;
    either within shared memory."""
    if dtype == torch.bfloat16:
        ok = bq % 16 == 0 and 16 <= bq <= 128 and bkv == BF16_BKV
    else:
        ok = bq % 16 == 0 and bkv % 16 == 0 and bq > 0 and bkv > 0
    return ok and smem_bytes(dtype, bq, bkv, d, dv) <= SMEM_MAX


def _check_widths(d: int, dv: int) -> None:
    """v's width may be narrower than q / k's (MLA), never wider."""
    if dv > d:
        raise ValueError(f"v width {dv} exceeds the q / k width {d}")


def _reachable(q0: int, rows: int, k0: int, bkv: int, causal: bool,
               window: int | None) -> bool:
    """Whether any row of the q tile [q0, q0 + rows) sees a column of the kv
    tile [k0, k0 + bkv) (the TPU kernel's `reachable`)."""
    if causal and k0 > q0 + rows - 1:
        return False
    return window is None or k0 + bkv - 1 > q0 - window


# ------------------------------------------------------------ plain version
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          softcap: float = 0.0, scale: float | None = None,
                          bq: int | None = None,
                          bkv: int | None = None) -> torch.Tensor:
    """The blockwise online softmax over (bq, bkv) tiles in PyTorch: q
    (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), Dv <= D ->
    (B, Hq, Sq, Dv) in q's dtype.  Kv heads are broadcast over their
    q-head group, never repeated."""
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    _check_widths(d, dv)
    g = hq // hkv
    dq, dkv = tiles(q.dtype, d, dv)
    bq, bkv = bq or dq, bkv or dkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d)
    out = torch.empty((b, hkv, g, sq, dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, bq):
        rows = min(bq, sq - q0)
        qi = qg[:, :, :, q0:q0 + rows].float()
        row = torch.arange(q0, q0 + rows, device=q.device)[:, None]
        m = torch.full((b, hkv, g, rows, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, g, rows, 1), device=q.device)
        acc = torch.zeros((b, hkv, g, rows, dv), device=q.device)
        for k0 in range(0, skv, bkv):
            if not _reachable(q0, rows, k0, bkv, causal, window):
                continue
            kj = k[:, :, k0:k0 + bkv].float()
            vj = v[:, :, k0:k0 + bkv]
            ncols = kj.shape[2]
            col = torch.arange(k0, k0 + ncols, device=q.device)[None, :]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            mask = torch.ones((rows, ncols), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (col <= row)
            if window is not None:
                mask = mask & (col > row - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = p.to(q.dtype).float()
            p2 = hi + (p - hi).to(q.dtype).float()
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p2, vj.float())
            acc = acc * alpha + pv
            m = m_new
        out[:, :, :, q0:q0 + rows] = (acc / torch.clamp(l, min=1e-30)
                                      ).to(q.dtype)
    return out.reshape(b, hq, sq, dv)


# ------------------------------------------------------------ CUDA launch
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.rt_flash_attention.argtypes = [
        i, p, ll, ll, ll, p, ll, ll, ll, p, ll, ll, ll, p, ll, ll, ll,
        i, i, i, i, i, i, i, i, i, f, f, i, i, p]
    lib.rt_flash_attention.restype = i
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softcap: float = 0.0, scale: float | None = None,
                         bq: int | None = None,
                         bkv: int | None = None) -> torch.Tensor:
    """K7 on the card, one launch; raises on what the kernel does not
    take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S, D)")
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (tuple(v.shape[:3]) != tuple(k.shape[:3]) or k.shape[0] != b
            or k.shape[3] != d):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    _check_widths(d, dv)
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on the same CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"q, k, v must share dtype bfloat16 or float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d % 16 or d > 256 or dv % 16:
        raise ValueError(f"head dim {d} must be a multiple of 16 up to 256, "
                         f"v width {dv} a multiple of 16")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a unit stride along the head dim")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    dq, dkv = tiles(q.dtype, d, dv)
    bq, bkv = bq or dq, bkv or dkv
    if not takes_tiles(q.dtype, bq, bkv, d, dv):
        raise ValueError(f"tiles ({bq}, {bkv}) at head dim {d} are not ones "
                         f"the {q.dtype} kernel takes (bf16: q rows a "
                         f"multiple of 16 up to 128, 64 kv columns; fp32: "
                         f"multiples of 16) or exceed shared memory")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    sq_, sk_, sv_, so_ = q.stride(), k.stride(), v.stride(), out.stride()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().rt_flash_attention(
        int(q.dtype == torch.bfloat16), q.data_ptr(), sq_[0], sq_[1], sq_[2],
        k.data_ptr(), sk_[0], sk_[1], sk_[2], v.data_ptr(), sv_[0], sv_[1],
        sv_[2], out.data_ptr(), so_[0], so_[1], so_[2], b, hq, hq // hkv, sq,
        skv, d, dv, bq, bkv, float(scale), float(softcap), int(causal),
        int(window or 0), stream)
    build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


# ------------------------------------------------------------ dispatch
def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, softcap: float = 0.0,
                    scale: float | None = None, bq: int | None = None,
                    bkv: int | None = None) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    fn = flash_attention_cuda if q.is_cuda else flash_attention_plain
    return fn(q, k, v, causal=causal, window=window, softcap=softcap,
              scale=scale, bq=bq, bkv=bkv)
