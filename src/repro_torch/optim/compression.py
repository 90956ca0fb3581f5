"""Int8 gradient compression with error feedback.

Each gradient leaf plus its residual is quantized to int8 with one
symmetric per-tensor scale; what the quantization loses is kept as the
residual and fed into the next step's gradient (error feedback), which
keeps SGD-style convergence.  Across steps, the dequantized gradients plus
the residual sum to the true gradients.

`int8_ring_allreduce` sums a tensor over a process group with int8 on the
wire: a ring reduce-scatter then a ring all-gather, every hop shipping an
int8 chunk and its fp32 scale to the next rank.  `wire_capture` records
the dtype and bytes of every send.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, NamedTuple

import torch

from repro_torch.core.tree import leaves, stacked_groups, tree_map, unflatten
from repro_torch.optim.adamw import f32_zeros


class EFState(NamedTuple):
    residual: Any          # fp32 tree like grads


def init_error_feedback(params) -> EFState:
    return EFState(residual=tree_map(f32_zeros, params))


def _scale(gs: list[torch.Tensor]) -> torch.Tensor:
    amax = torch.max(torch.stack([torch.max(torch.abs(g)) for g in gs]))
    return torch.clamp(amax, min=1e-12) / 127.0


def _codes(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (int8, scale).  Symmetric per-tensor scaling; `torch.round`
    rounds halves to even, as `jnp.round` does."""
    scale = _scale([g])
    return _codes(g, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


_WIRE_LOGS: list[list] = []


@contextlib.contextmanager
def wire_capture() -> Iterator[list]:
    """Collect ``(dtype, bytes)`` of every tensor the ring sends in the
    block."""
    log: list = []
    _WIRE_LOGS.append(log)
    try:
        yield log
    finally:
        _WIRE_LOGS.remove(log)


def _ring_hop(q: torch.Tensor, s: torch.Tensor, group, idx: int, n: int):
    """Send (q, s) to rank idx + 1 of `group` and receive the pair from
    rank idx - 1."""
    import torch.distributed as dist
    peer = (lambda r: r) if group is None else \
        (lambda r: dist.get_global_rank(group, r))
    rq, rs = torch.empty_like(q), torch.empty_like(s)
    for log in _WIRE_LOGS:
        log += [(q.dtype, q.numel() * q.element_size()),
                (s.dtype, s.numel() * s.element_size())]
    ops = [dist.P2POp(dist.isend, q, peer((idx + 1) % n), group),
           dist.P2POp(dist.isend, s, peer((idx + 1) % n), group),
           dist.P2POp(dist.irecv, rq, peer((idx - 1) % n), group),
           dist.P2POp(dist.irecv, rs, peer((idx - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return rq, rs


def int8_ring_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over `group` (default: the world), int8 on the wire.

    n - 1 reduce-scatter hops: at hop c a rank adds its chunk (idx - c - 1)
    mod n to the partial sum it received, requantizes it and ships it on;
    then it holds the sum of chunk idx without its own part, which it adds
    locally.  n - 1 all-gather hops then pass the owned chunks round, each
    quantized once.  Accumulation is fp32; the error is O(n) quantization
    steps (pair with error feedback).  The tensor is padded to a multiple
    of n; the identity when n == 1."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(n, -1).to(torch.float32)

    def quant(t):
        q, s = quantize(t)
        return q, s.reshape(1)

    q, s = quant(torch.zeros_like(chunks[0]))
    for c in range(n - 1):
        q, s = quant(dequantize(q, s) + chunks[(idx - c - 1) % n])
        q, s = _ring_hop(q, s, group, idx, n)
    owned = dequantize(q, s) + chunks[idx % n]

    q, s = quant(owned)
    out = torch.zeros((n,) + owned.shape, dtype=torch.float32,
                      device=x.device)
    out[idx % n] = dequantize(q, s)
    for c in range(n - 1):
        q, s = _ring_hop(q, s, group, idx, n)
        out[(idx - c - 1) % n] = dequantize(q, s)
    flat_out = out.reshape(-1)
    if pad:
        flat_out = flat_out[:-pad]
    return flat_out.reshape(x.shape).to(x.dtype)


def compress_grads(grads, ef: EFState) -> tuple[Any, EFState]:
    """Quantize (grad + residual); return the dequantized grads and the new
    residual.  A None gradient leaf counts as zeros.  The scale is per
    tensor of the JAX package's tree: a stage's per-layer leaves at one key
    path share one scale, as the stacked ``(R, ...)`` leaf does there."""
    rs = list(leaves(ef.residual))
    gs = list(leaves(grads))
    deq, res = [None] * len(rs), [None] * len(rs)
    for group in stacked_groups(ef.residual):
        gfs = {i: (gs[i].float() if gs[i] is not None
                   else torch.zeros_like(rs[i])) + rs[i] for i in group}
        scale = _scale(list(gfs.values()))
        for i, gf in gfs.items():
            deq[i] = dequantize(_codes(gf, scale), scale)
            res[i] = gf - deq[i]
    return (unflatten(ef.residual, deq),
            EFState(residual=unflatten(ef.residual, res)))
