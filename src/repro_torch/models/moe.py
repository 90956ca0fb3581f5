"""Mixture-of-Experts layer: sort-based dispatch + grouped expert GEMMs.

The JAX package's single-device MoE, op for op: tokens are routed by an
fp32 router (softmax, top-k, renormalised), stably sorted by expert id,
packed into (E, capacity) slots (capacity-dropped like Switch), run
through the planned grouped expert GEMMs (`kernels.ops.grouped_matmul`:
K5 on the card under the "cuda" backend), and combined back with the
router weights by an fp32 index-add.

Where PyTorch differs from JAX, the port reproduces JAX's semantics:
  * `jnp.argsort` is stable; `torch.argsort` only with ``stable=True``
    (ties decide which tokens fall past capacity);
  * `.at[slot].set(..., mode="drop")` writes nothing for the sentinel
    slot E*cap: the slot buffer carries one extra row that takes the
    dropped copies and is sliced off;
  * `.at[st].add` is `index_add_` into an fp32 tensor — on CUDA its order
    of additions is not deterministic.

Capacity-slot accounting (`track_capacity_slots`) is opt-in, as in the
JAX package, and recorded once per stage site and call
(`core.stage_trace`).

Under an annotation mesh (`distributed.sharding.set_annotation_mesh`, a
`DeviceMesh` with a "model" axis) `moe_mlp` takes the expert-parallel path
`moe_mlp_shardmap`, the counterpart of the JAX package's shard_map: each
rank routes its batch slice to its own slice of the experts, and one sum
over "model" combines them.  `ep_counts()` counts its calls and the
all-reduces it issues.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F

from repro_torch.core import stage_trace
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.layers import linear_init

_ROUTING_LOGS: list[list] = []
_EP_COUNTS = {"shardmap_calls": 0, "all_reduce": 0}
# Capacity-slot accounting.  Slot counts are static — (E, capacity) comes
# from shapes, and the best-case fill is min(T*k, E*cap) — so recording
# them reads no device value and costs nothing at runtime.  Opt-in: plain
# forward passes leave the guard.health ledger untouched.
_TRACK_SLOTS = False


@contextlib.contextmanager
def track_capacity_slots():
    """Record moe_slots_total / moe_slots_filled / moe_slots_underfilled
    into guard.health for every MoE dispatch in scope."""
    global _TRACK_SLOTS
    prev = _TRACK_SLOTS
    _TRACK_SLOTS = True
    try:
        yield
    finally:
        _TRACK_SLOTS = prev


@contextlib.contextmanager
def routing_capture() -> Iterator[list]:
    """Collect, for every MoE dispatch inside the block, a dict with its
    top-k expert ids ``experts`` (T, K) and the number of token copies
    ``dropped`` past capacity (a 0-d tensor; read it after the block)."""
    log: list = []
    _ROUTING_LOGS.append(log)
    try:
        yield log
    finally:
        _ROUTING_LOGS.remove(log)


def init_moe(gen: torch.Generator, cfg, device) -> dict:
    """Router (fp32, kept fp32 in a bf16 model) and (E, D, F) / (E, F, D)
    expert stacks drawn from `gen`; a shared expert when configured."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = layers.dtype_of(cfg)

    def stack_init(d_in, d_out):
        w = torch.empty((e, d_in, d_out), dtype=dt, device=device)
        if w.is_meta:           # shapes only: no draws to order
            return w
        for i in range(e):
            w[i] = linear_init(gen, d_in, d_out, dt, device)
        return w

    p = {
        "router": torch.randn((d, e), generator=gen, device=device,
                              dtype=torch.float32) * d ** -0.5,
        "w_gate": stack_init(d, f),
        "w_up": stack_init(d, f),
        "w_down": stack_init(f, d),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(
            gen, cfg, device, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return p


def _capacity(n_tokens: int, cfg) -> int:
    c = int(n_tokens * cfg.n_experts_per_tok * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def _dispatch_compute_combine(xf: torch.Tensor, p: dict, cfg, *,
                              n_local_experts: int, expert_offset: int):
    """Route xf (T, D) to the experts [offset, offset + n_local) and return
    their weighted contribution (T, D) fp32 and the router aux loss."""
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    dev = xf.device
    logits = torch.matmul(xf.float(), p["router"])            # (T, E) fp32
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, k, dim=-1)              # (T, K)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    frac_tokens = F.one_hot(gate_i, e).float().sum(1).mean(0)
    frac_probs = probs.mean(0)
    aux = cfg.router_aux_coef * e * torch.sum(frac_tokens * frac_probs)

    cap = _capacity(t, cfg)
    n_slots = n_local_experts * cap
    if _TRACK_SLOTS and stage_trace.recording():
        from repro_torch.guard import health as _health
        filled = min(t * k, n_slots)
        _health.record("moe_slots_total", n_slots)
        _health.record("moe_slots_filled", filled)
        _health.record("moe_slots_underfilled", n_slots - filled)
    flat_e = gate_i.reshape(-1)                                # (T*K,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_w = gate_w.reshape(-1)
    # retarget to the local expert slice; out-of-slice -> dropped
    local_e = flat_e - expert_offset
    in_slice = (local_e >= 0) & (local_e < n_local_experts)
    local_e = torch.where(in_slice, local_e, n_local_experts)
    order = torch.argsort(local_e, stable=True)
    se, st, sw = local_e[order], flat_t[order], flat_w[order]
    keep_slice = se < n_local_experts
    start = torch.searchsorted(
        se, torch.arange(n_local_experts, device=dev), side="left")
    rank = torch.arange(t * k, device=dev) - start[
        torch.clamp(se, max=n_local_experts - 1)]
    keep = keep_slice & (rank < cap)
    slot = torch.where(keep, se * cap + rank, n_slots)
    for log in _ROUTING_LOGS:
        log.append({"experts": gate_i,
                    "dropped": (keep_slice & ~keep).sum()})

    gathered = xf[st] * keep[:, None].to(xf.dtype)             # (T*K, D)
    # row n_slots is the sentinel that takes the dropped copies
    slots = torch.zeros((n_slots + 1, d), dtype=xf.dtype, device=dev)
    slots.index_copy_(0, slot, gathered)
    slots = slots[:n_slots].view(n_local_experts, cap, d)

    if cfg.mlp_type == "swiglu":
        g = ops.grouped_matmul(slots, p["w_gate"], out_dtype=torch.float32)
        u = ops.grouped_matmul(slots, p["w_up"], out_dtype=torch.float32)
        h = (F.silu(g) * u).to(xf.dtype)
    else:
        # act fused into the expert GEMM's epilogue (fp32, one cast).
        h = ops.grouped_matmul(slots, p["w_up"], epilogue="gelu",
                               out_dtype=xf.dtype)
    y_slots = ops.grouped_matmul(h, p["w_down"], out_dtype=torch.float32)
    y_slots = y_slots.reshape(n_slots, d)

    contrib = y_slots[torch.clamp(slot, max=n_slots - 1)]
    contrib = contrib * (sw * keep)[:, None]
    y = torch.zeros((t, d), dtype=torch.float32, device=dev)
    y.index_add_(0, st, contrib)
    return y, aux


def ep_counts() -> dict:
    """{"shardmap_calls", "all_reduce"}: expert-parallel layer calls and
    the all-reduces they issued, since `reset_ep_counts`."""
    return dict(_EP_COUNTS)


def reset_ep_counts() -> None:
    for k in _EP_COUNTS:
        _EP_COUNTS[k] = 0


class _GroupSum(torch.autograd.Function):
    """The sum over a process group of each rank's term, a value every
    rank then holds (JAX's psum): its gradient is the output's, as is, on
    every rank."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    _EP_COUNTS["all_reduce"] += 1
    return _GroupSum.apply(t, group)


def moe_mlp_shardmap(x: torch.Tensor, p: dict, cfg, mesh):
    """Expert-parallel MoE over the mesh's "model" axis.

    The inputs are global views: `DTensor`s, or plain tensors holding the
    whole value on every rank (read as replicated; the output is then a
    plain tensor too).  Token activations are replicated over "model" and
    split over the data axes, so each (data, model) rank routes its token
    copy to its own `max(E // model, 1)` experts with no dispatch
    communication; capacity comes from the local token count.  The only
    collective is one sum of the fp32 (T_local, D) output over "model" a
    layer; aux is averaged over the data axes.  A shared expert is added
    after the sum, with a plain `layers.mlp`."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed import sharding as shd
    b, s, d = x.shape
    e = cfg.n_experts
    msz = mesh.size(shd.axis_names(mesh).index("model"))
    n_local = max(e // msz, 1)
    dp = shd.dp_axes(mesh)
    plain = not isinstance(x, DTensor)
    rep = [Replicate()] * mesh.ndim

    def local(t, spec, grad_over):
        """t's local block by `spec`; its gradient there is a pending sum
        over the mesh dims in `grad_over` (where the ranks' uses differ)
        and keeps the block's placement elsewhere."""
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        place = shd.to_placements(spec, mesh)
        grad = [Partial() if name in grad_over else pl for name, pl in
                zip(shd.axis_names(mesh), place)]
        return t.redistribute(mesh, place).to_local(grad_placements=grad)

    _EP_COUNTS["shardmap_calls"] += 1
    # tokens: each model rank routes the copy to its own experts; weights:
    # each data rank routes its own tokens
    xl = local(x, shd.P(dp, None, None), ("model",))
    expert = shd.P("model", None, None)
    pl = {"router": local(p["router"], shd.P(None, None),
                          dp + ("model",)),
          "w_gate": local(p["w_gate"], expert, dp),
          "w_up": local(p["w_up"], expert, dp),
          "w_down": local(p["w_down"], expert, dp)}
    tl = xl.shape[0] * xl.shape[1]
    m_idx = mesh.get_local_rank("model") if n_local < e else 0
    y, aux = _dispatch_compute_combine(
        xl.reshape(tl, d), pl, cfg, n_local_experts=n_local,
        expert_offset=m_idx * n_local)
    if m_idx:       # every model rank has aux; its gradient counts once
        aux = aux.detach()
    y = _all_reduce_sum(y, mesh.get_group("model"))
    # aux is identical on every model rank (computed from the replicated
    # token copy): average over the data ranks only.
    n_dp = 1
    for a in dp:
        if a in shd.axis_names(mesh):
            aux = _all_reduce_sum(aux, mesh.get_group(a))
            n_dp *= mesh.size(shd.axis_names(mesh).index(a))
    aux = aux / n_dp
    y = y.reshape(xl.shape).to(x.dtype)
    y = DTensor.from_local(y, mesh, shd.to_placements(
        shd.P(dp, None, None), mesh), run_check=False)
    aux = DTensor.from_local(aux, mesh, rep, run_check=False)
    if plain:
        y, aux = y.full_tensor(), aux.to_local()
    if cfg.n_shared_experts:
        y = y + layers.mlp(x.reshape(b * s, d), p["shared"], cfg).reshape(
            b, s, d)
    return y, aux


def _ep_mesh(x, cfg):
    """The annotation mesh when the expert-parallel path applies to `x`:
    a `DeviceMesh` with a "model" axis that divides the experts, whose
    data axes divide the batch."""
    from repro_torch.distributed import sharding as shd
    mesh = shd.annotation_mesh()
    if mesh is None or isinstance(mesh, shd.MeshShape) or \
            "model" not in shd.axis_names(mesh):
        return None
    sizes = shd.axis_sizes(mesh)
    dp_sz = 1
    for a in shd.dp_axes(mesh):
        dp_sz *= sizes.get(a, 1)
    if cfg.n_experts % sizes["model"] == 0 and x.shape[0] % dp_sz == 0:
        return mesh
    return None


def moe_mlp(x: torch.Tensor, p: dict, cfg):
    """x (B, S, D) -> (y (B, S, D), aux_loss fp32 scalar).

    Takes `moe_mlp_shardmap` under an annotation mesh it fits, else the
    single-device path over the full expert range (the same math), where a
    shared expert's output lands on the routed sum through its down
    projection's fused residual epilogue."""
    mesh = _ep_mesh(x, cfg)
    if mesh is not None:
        return moe_mlp_shardmap(x, p, cfg, mesh)
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    y, aux = _dispatch_compute_combine(
        xf, p, cfg, n_local_experts=cfg.n_experts, expert_offset=0)
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = layers.mlp(xf, p["shared"], cfg, residual=y)
    return y.reshape(b, s, d), aux
