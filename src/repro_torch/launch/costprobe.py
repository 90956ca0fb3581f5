"""Roofline-term extraction via composed probe traces.

WHY: the JAX package's dry-run compiles a `lax.scan` whose body XLA's
`cost_analysis()` counts once, so its roofline terms come from probes
that hold no loop.  The port's dry-run (`launch.dryrun`) traces every
layer of every microbatch in Python loops, which counts them all but
takes minutes a cell at full depth; these probes give the same terms in
seconds, composed as the JAX package composes them:

  For each (arch x shape x mesh) we trace small PROBE programs on the
  fake production mesh (`FakeTensorMode`, a fake process group):
    * fixed — embed + final-norm + chunkless loss (+ MTP) fwd+bwd
    * one probe per distinct block kind — fwd+bwd of one block, with
      single-trip attention chunks (`layers.chunk_override`, entered by
      the probes only); grads land in ZeRO-1 sharding so the gradient
      reduce-scatter collective is captured per microbatch
    * opt — the optimizer update + ZeRO-1 param all-gather
  and compose:  total = n_micro * (fixed + sum_k n_k * block_k) + opt.
  SSM blocks are probed at one SSD chunk and scaled linearly in S (the SSD
  algorithm is exactly linear in chunk count, projections linear in S).

  Every number is what `core.roofline.measure` counts of rank 0's ops on
  the production mesh, so per-device sharding effects (including every
  collective DTensor inserts) are traced, not modeled.  The attention
  chain's bytes are replaced by the flash kernel's traffic (K7's q tile on
  the card; the JAX package's 2048-row tile gives its numbers).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, all_arch_ids, get_config
from repro_torch.core import config as mmcfg
from repro_torch.core import roofline
from repro_torch.core.tree import leaves, unflatten
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shapes_mod
from repro_torch.models import blocks, encdec, layers, transformer
from repro_torch.models.attention import per_head
from repro_torch.models.layers import rmsnorm
from repro_torch.serve import engine, kvcache

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "roofline")

SINGLE_TRIP = (1 << 30, 1 << 30)
JAX_FLASH_BQ = 2048       # the JAX package's flash q tile (costprobe.py:139)


@dataclasses.dataclass
class ProbeCost:
    flops: float
    bytes: float
    coll_bytes: float
    coll_counts: dict

    def __mul__(self, k: float):
        return ProbeCost(self.flops * k, self.bytes * k,
                         self.coll_bytes * k,
                         {n: c * k for n, c in self.coll_counts.items()})

    __rmul__ = __mul__

    def __add__(self, o: "ProbeCost"):
        counts = dict(self.coll_counts)
        for n, c in o.coll_counts.items():
            counts[n] = counts.get(n, 0) + c
        return ProbeCost(self.flops + o.flops, self.bytes + o.bytes,
                         self.coll_bytes + o.coll_bytes, counts)


ZERO = ProbeCost(0.0, 0.0, 0.0, {})


def _grads(loss_fn, params):
    """(loss, grads) of `loss_fn(params)`, as `jax.value_and_grad`."""
    live = [t.detach().requires_grad_(True) for t in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, live))
    return loss, list(torch.autograd.grad(loss, live, allow_unused=True))


def _to_specs(grads, specs, mesh):
    """Gradients redistributed to their ZeRO-1 specs (JAX's
    `out_shardings`); as they are without a mesh."""
    if mesh is None:
        return grads
    return [g if g is None else g.redistribute(mesh, shd.to_placements(sp, mesh))
            for g, sp in zip(grads, shd._spec_leaves(specs))]


class CellProber:
    """Probes one (arch x shape x mesh) cell.

    `mesh`: "production" (default) forms the fake production mesh of
    `mesh_kind`; a `DeviceMesh` is used as it is (a one-rank NCCL mesh on
    the card); a `sharding.MeshShape` prices without tracing
    (`_flash_traffic_bytes`); None runs one device on plain tensors.
    `seed` None traces fake stand-ins under `FakeTensorMode`; an int draws
    real inputs from it and runs the probes for real.  `cfg` replaces the
    published config (its FSDP choice and microbatch count stay the
    published arch's)."""

    def __init__(self, arch: str, shape_name: str, mesh_kind: str, *,
                 mesh="production", cfg: ModelConfig | None = None,
                 device=None, seed: int | None = None):
        self.arch = arch
        published = get_config(arch)
        self.cfg = cfg or published
        self.cell = shapes_mod.SHAPES[shape_name]
        self.device = resolve_device(device)
        if isinstance(mesh, str) and mesh == "production":
            mesh = dryrun.cell_mesh(mesh_kind, self.device)
        self.mesh = mesh
        self.spec_mesh = (mesh if mesh is not None
                          else shd.MeshShape((1, 1), ("data", "model")))
        self.sizes = shd.axis_sizes(self.spec_mesh)
        self.chips = 1
        for n in self.sizes.values():
            self.chips *= n
        self.mesh_kind = mesh_kind
        self.n_micro = shapes_mod.microbatches_for(published, self.cell)
        self.dtype = layers.dtype_of(self.cfg)
        self.dp = shd.dp_axes(self.spec_mesh)
        self.fsdp = dryrun._use_fsdp(published)
        placed_on = mesh if not isinstance(mesh, shd.MeshShape) else None
        self.place = dryrun.Placer(placed_on, self.device, seed=seed,
                                   vocab=self.cfg.vocab_size)
        self._fake = dryrun.fake_mode() if seed is None else None
        self._depth = 0

    # -------------------------------------------------------------- utils
    @contextlib.contextmanager
    def _scope(self):
        """Fake mode (when tracing) around a probe, entered once however
        the probes nest."""
        self._depth += 1
        try:
            if self._depth == 1 and self._fake is not None:
                with self._fake:
                    yield
            else:
                yield
        finally:
            self._depth -= 1

    def _measure(self, fn, *args) -> ProbeCost:
        def whole(*a):
            # an output's pending sum is summed: a jitted program's outputs
            # carry a definite layout, and XLA counts that all-reduce
            from torch.distributed.tensor import Replicate
            for t in roofline.tensors(fn(*a)):
                place = getattr(t, "placements", ())
                if any(p.is_partial() for p in place):
                    t.redistribute(t.device_mesh, [
                        Replicate() if p.is_partial() else p for p in place])
        run = fn if self.mesh is None else shd.on_mesh(whole, self.mesh)
        with layers.chunk_override(*SINGLE_TRIP):
            _, cost = roofline.measure(run, *args)
        return ProbeCost(cost.flops, cost.bytes, cost.collective_bytes,
                         cost.collective_counts)

    def _x(self, b, s):
        shape = (b, s, self.cfg.d_model)
        return self.place(shape, self.dtype,
                          shd.batch_spec(shape, self.spec_mesh))

    def _placed(self, shapes, *, fsdp: bool):
        specs = shd.tree_param_specs(shapes, self.spec_mesh, fsdp=fsdp)
        return self.place.tree(shapes, specs), specs

    def _positions(self, s):
        return torch.arange(s, dtype=torch.int32, device=self.device)

    # ---------------------------------------------- attention traffic fix
    # The torch blockwise-attention path materializes the (B,H,S,S) score
    # chain, which the op-level byte count charges to HBM; the production
    # path is the flash kernel, whose HBM traffic is fully determined by
    # its tiling: per (b, h, q-tile): q read once, k/v streamed once per
    # q-tile, o written once (scores never leave on-chip memory).  We
    # therefore probe the attention chain in isolation (same
    # shapes/shardings) and replace its bytes with the kernel's traffic.
    # FLOPs are identical and stay measured.  The q tile is K7's own (128
    # rows at bf16, `kernels.flash_attention.tiles`): k/v are revisited
    # S/bq times.  The JAX package's bq=2048 gives its numbers.
    def _attn_dims(self, kind: str):
        cfg = self.cfg
        if cfg.use_mla:
            return (cfg.n_heads, cfg.n_heads, cfg.qk_nope_dim +
                    cfg.qk_rope_dim, cfg.v_head_dim)
        return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim

    def flash_bq(self, kind: str) -> int:
        """K7's q tile at this arch's attention widths."""
        from repro_torch.kernels import flash_attention
        _, _, dq, dv = self._attn_dims(kind)
        return flash_attention.tiles(self.dtype, dq, dv)[0]

    def _flash_traffic_bytes(self, kind: str, b: int, s: int,
                             bq: int) -> float:
        """Per-DEVICE flash-kernel HBM bytes for one layer, fwd pass, at a
        q tile of `bq` rows."""
        cfg = self.cfg
        hq, hkv, dq, dv = self._attn_dims(kind)
        window = cfg.local_window if kind == "attn_local" else None
        msz = self.sizes["model"]
        dsz = 1
        for a in self.dp:
            dsz *= self.sizes[a]
        b_l = max(b // dsz, 1)
        hq_l = max(hq // msz, 1)
        # kv heads replicate when < msz (grouped via the kernel's index map)
        hkv_l = max(hkv // msz, 1)
        gq = max(s // bq, 1)
        kv_span = min(s, (window or s) + bq)
        q_bytes = b_l * hq_l * s * dq * 2
        o_bytes = b_l * hq_l * s * dv * 2
        kv_bytes = b_l * hkv_l * gq * kv_span * (dq + dv) * 2
        return float(q_bytes + o_bytes + kv_bytes)

    def _attn_correction(self, kind: str, b: int, s: int, *,
                         train: bool) -> ProbeCost:
        """(torch-attention bytes -> flash-kernel bytes) delta for one
        layer.

        Backward factor 3.5x fwd traffic (flash bwd: re-stream k/v, read
        o/do, write dq/dk/dv — standard flash-attention-2 accounting)."""
        if s <= 1:
            return ZERO
        cfg = self.cfg
        hq, hkv, dq, dv = self._attn_dims(kind)
        window = cfg.local_window if kind == "attn_local" else None
        msz = self.sizes["model"]
        dp_spec = shd.batch_spec((b,), self.spec_mesh)[0] if b > 1 else None
        hspec = "model" if hq % msz == 0 else None
        kvspec = "model" if hkv % msz == 0 else None
        with self._scope():
            q = self.place((b, s, hq, dq), self.dtype,
                           shd.P(dp_spec, None, hspec, None))
            k = self.place((b, s, hkv, dq), self.dtype,
                           shd.P(dp_spec, None, kvspec, None))
            v = self.place((b, s, hkv, dv), self.dtype,
                           shd.P(dp_spec, None, kvspec, None))

            def attend(q, k, v):
                return layers.blockwise_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=True, window=window,
                    softcap=cfg.attn_softcap).transpose(1, 2)

            def fwd(q, k, v):
                return per_head(attend, q, k, v)

            bq = self.flash_bq(kind)
            if train:
                def f(q, k, v):
                    return _grads(lambda t: torch.sum(
                        fwd(*t).to(torch.float32)), [q, k, v])
                jnp_cost = self._measure(f, q, k, v)
                flash = 3.5 * self._flash_traffic_bytes(kind, b, s, bq)
            else:
                with torch.no_grad():
                    jnp_cost = self._measure(fwd, q, k, v)
                flash = self._flash_traffic_bytes(kind, b, s, bq)
        return ProbeCost(0.0, flash - jnp_cost.bytes, 0.0, {})

    def _block_params(self, kind: str):
        shapes = blocks.init_block(None, self.cfg, kind, "meta")
        params, specs = self._placed(shapes, fsdp=self.fsdp)
        return params, specs, shapes

    def _kind_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for unit, n in self.cfg.stage_list():
            for kind in unit:
                counts[kind] = counts.get(kind, 0) + n
        return counts

    # ------------------------------------------------------------- train
    def probe_train(self) -> ProbeCost:
        cell = self.cell
        b_micro = cell.global_batch // self.n_micro
        s = cell.seq_len
        total = ZERO
        with self._scope():
            # --- per-kind block probes (fwd+bwd, grads in ZeRO-1 sharding)
            for kind, count in self._kind_counts().items():
                cost = self._probe_block_train(kind, b_micro, s)
                total = total + (count * self.n_micro) * cost

            # --- fixed: embed + final norm + loss (+ MTP) fwd+bwd
            fixed = self._probe_fixed_train(b_micro, s)
            total = total + self.n_micro * fixed

            # --- optimizer update + ZeRO-1 all-gather
            total = total + self._probe_opt()
        return total

    def block_train_step(self, kind: str, b: int, s: int):
        """(fn, args, scale) of the train block probe: ``fn(*args)`` is one
        block's forward + backward, its grads in ZeRO-1 sharding; `scale`
        the SSM chunk scaling.  Call under the prober's scope."""
        cfg = self.cfg
        # SSM blocks: probe one SSD chunk and scale linearly.
        scale = 1.0
        if kind == "ssm" and s > cfg.ssm_chunk:
            scale = s / cfg.ssm_chunk
            s = cfg.ssm_chunk
        p, p_specs, p_shapes = self._block_params(kind)
        x = self._x(b, s)
        positions = self._positions(s)
        grad_specs = shd.tree_optstate_specs(p_specs, p_shapes,
                                             self.spec_mesh)

        def f(p, x):
            def loss_fn(pp):
                out, aux = blocks.block_fwd(x, pp, cfg, kind, positions)
                return torch.sum(out.to(torch.float32)) + aux
            loss, grads = _grads(loss_fn, p)
            return loss, _to_specs(grads, grad_specs, self.mesh)

        return f, (p, x), scale

    def _probe_block_train(self, kind: str, b, s) -> ProbeCost:
        with self._scope():
            f, args, scale = self.block_train_step(kind, b, s)
            cost = self._measure(f, *args)
            if kind.startswith("attn"):
                cost = cost + self._attn_correction(kind, b, s, train=True)
        return cost * scale

    def _probe_fixed_train(self, b, s) -> ProbeCost:
        from repro_torch.train.loss import chunked_softmax_xent
        cfg = self.cfg
        with self._scope():
            tok = self.place((b, s), torch.int32,
                             shd.batch_spec((b, s), self.spec_mesh))
            shapes = self._fixed_param_shapes()
            fixed, specs = self._placed(shapes, fsdp=self.fsdp)
            grad_specs = shd.tree_optstate_specs(specs, shapes,
                                                 self.spec_mesh)

            def f(p, tokens):
                def loss_fn(pp):
                    def logits(hh):
                        return transformer.unembed(pp, cfg, hh)
                    x = transformer.embed_tokens(pp, cfg, tokens)
                    h = rmsnorm(x, pp["final_norm"], cfg.norm_eps)
                    loss = chunked_softmax_xent(       # single trip
                        h[:, :-1], tokens[:, 1:], logits, chunk=s)
                    if cfg.mtp_heads:
                        mtp_h = transformer.mtp_hidden(pp, cfg, h, tokens)
                        loss = loss + 0.3 * chunked_softmax_xent(
                            mtp_h[:, :-1], tokens[:, 2:], logits, chunk=s)
                    return loss
                loss, grads = _grads(loss_fn, p)
                return loss, _to_specs(grads, grad_specs, self.mesh)

            return self._measure(f, fixed, tok)

    def _fixed_param_shapes(self):
        cfg = self.cfg

        def z(*shape):
            return torch.empty(shape, dtype=self.dtype, device="meta")

        p = {"embed": z(cfg.vocab_size, cfg.d_model),
             "final_norm": z(cfg.d_model)}
        if not cfg.tie_embeddings:
            p["unembed"] = z(cfg.d_model, cfg.vocab_size)
        if cfg.mtp_heads:
            p["mtp"] = {
                "proj": z(2 * cfg.d_model, cfg.d_model),
                "norm": z(cfg.d_model),
                "block": blocks.init_block(None, cfg, "attn_dense", "meta"),
            }
        return p

    def _probe_opt(self) -> ProbeCost:
        from repro_torch.models.model import param_shapes
        from repro_torch.optim.adamw import AdamW, AdamWState
        with self._scope():
            shapes = param_shapes(self.cfg)
            params, p_specs = self._placed(shapes, fsdp=self.fsdp)
            mu_specs = shd.tree_optstate_specs(p_specs, shapes,
                                               self.spec_mesh)
            opt = AdamW(lr=3e-4)
            state = AdamWState(
                step=dryrun.host_scalar(0),
                mu=self.place.tree(shapes, mu_specs, torch.float32),
                nu=self.place.tree(shapes, mu_specs, torch.float32))
            grads = self.place.tree(shapes, p_specs, torch.float32)

            def f(g, st, p):
                new_p, new_st, _ = opt.update(g, st, p)
                return (_to_specs(leaves(new_p), p_specs, self.mesh),
                        _to_specs(leaves(new_st.mu), mu_specs, self.mesh),
                        _to_specs(leaves(new_st.nu), mu_specs, self.mesh))

            return self._measure(f, grads, state, params)

    # ----------------------------------------------------------- prefill
    def probe_prefill(self) -> ProbeCost:
        cfg = self.cfg
        b, s = self.cell.global_batch, self.cell.seq_len
        total = ZERO
        with self._scope():
            for kind, count in self._kind_counts().items():
                total = total + count * self._probe_block_serve(
                    kind, b, s, mode="prefill")
            total = total + self._probe_fixed_serve(b, s, decode=False)
            if cfg.family == "encdec":
                # encoder blocks over the frame sequence + decoder
                # cross-attn
                f = min(cfg.frontend_len, s)
                total = total + cfg.enc_layers * self._probe_block_serve(
                    "attn_global", b, f, mode="prefill")
                total = total + cfg.n_layers * self._probe_cross_attn(b, s, f)
        if cfg.family == "vlm":
            # prefix patch embeddings add frontend_len/s extra positions
            # through every block: scale linearly (<1% for prefill_32k).
            total = total * (1.0 + cfg.frontend_len / s)
        return total

    def _probe_cross_attn(self, b, s_q, s_kv) -> ProbeCost:
        cfg = self.cfg
        with self._scope():
            shapes = encdec.init_cross_attn(None, cfg, "meta")
            p, _ = self._placed(shapes, fsdp=False)
            x = self._x(b, s_q)
            e = self._x(b, s_kv)

            @torch.no_grad()
            def f(p, x, enc_out):
                kv = encdec.cross_kv(enc_out, p, cfg)
                return encdec.cross_attn(x, kv, p, cfg)
            return self._measure(f, p, x, e)

    # ------------------------------------------------------------ decode
    def probe_decode(self) -> ProbeCost:
        cfg = self.cfg
        b, s = self.cell.global_batch, self.cell.seq_len
        total = ZERO
        with self._scope():
            for kind, count in self._kind_counts().items():
                total = total + count * self._probe_block_serve(
                    kind, b, s, mode="decode")
            total = total + self._probe_fixed_serve(b, s, decode=True)
            if cfg.family == "encdec":
                f = min(cfg.frontend_len, s)
                total = total + cfg.n_layers * self._probe_cross_attn(b, 1, f)
        return total

    def _block_entry(self, kind, b, s):
        """A one-repeat cache entry of the block kind, placed by the cache
        specs (R = 1 leads, as the engine's stage entries)."""
        if self.mesh is None:
            return kvcache.init_block_cache(self.cfg, kind, b, s, 1,
                                            self.device)
        shapes = kvcache.init_block_cache(self.cfg, kind, b, s, 1, "meta")
        return kvcache.zeros_on(shapes, self.mesh)

    def block_serve_step(self, kind, b, s, *, mode):
        """(fn, args, scale) of the serve block probe (`mode` "prefill":
        one block over s positions, filling its cache entry; "decode": one
        token against an s-long entry).  Call under the prober's scope."""
        cfg = self.cfg
        p, _, _ = self._block_params(kind)
        if mode == "prefill":
            scale = 1.0
            if kind == "ssm" and s > cfg.ssm_chunk:
                scale = s / cfg.ssm_chunk
                s = cfg.ssm_chunk
            positions = self._positions(s)
            x = self._x(b, s)

            @torch.no_grad()
            def f(p, x):
                entry = self._block_entry(kind, b, s)
                out = engine._block_prefill(x, p, cfg, kind, positions,
                                            entry, 0)
                return out, entry
            return f, (p, x), scale

        # decode: one token against the cell-sized cache
        entry = self._block_entry(kind, b, s)
        x = self._x(b, 1)
        pos = torch.tensor(s - 1, dtype=torch.int32, device=self.device)

        @torch.no_grad()
        def f(p, x, entry, pos):
            return engine._block_decode(x, p, cfg, kind, entry, 0, pos)
        return f, (p, x, entry, pos), 1.0

    def _probe_block_serve(self, kind, b, s, *, mode) -> ProbeCost:
        with self._scope():
            f, args, scale = self.block_serve_step(kind, b, s, mode=mode)
            cost = self._measure(f, *args)
            if mode == "prefill" and kind.startswith("attn"):
                cost = cost + self._attn_correction(kind, b, s, train=False)
        return scale * cost

    def _probe_fixed_serve(self, b, s, *, decode: bool) -> ProbeCost:
        cfg = self.cfg
        with self._scope():
            fixed, _ = self._placed(self._fixed_param_shapes(),
                                    fsdp=self.fsdp)
            n_tok = 1 if decode else s
            tok = self.place((b, n_tok), torch.int32,
                             shd.batch_spec((b, n_tok), self.spec_mesh))

            @torch.no_grad()
            def f(p, tokens):
                x = transformer.embed_tokens(p, cfg, tokens)
                h = rmsnorm(x, p["final_norm"], cfg.norm_eps)
                return transformer.unembed(p, cfg, h[:, -1])
            return self._measure(f, fixed, tok)

    # ------------------------------------------------------------- entry
    def run(self) -> dict:
        from repro_torch.models.model import model_flops
        mode = self.cell.mode
        t0 = time.time()
        with mmcfg.mm_config(backend="torch"):
            if mode == "train":
                cost = self.probe_train()
                tokens = self.cell.global_batch * self.cell.seq_len
                mflops = model_flops(self.cfg, tokens=tokens, mode="train")
            elif mode == "prefill":
                cost = self.probe_prefill()
                tokens = self.cell.global_batch * self.cell.seq_len
                mflops = model_flops(self.cfg, tokens=tokens, mode="serve")
            else:
                cost = self.probe_decode()
                mflops = model_flops(self.cfg, tokens=self.cell.global_batch,
                                     mode="serve")
        # Roofline terms against the context-resolved chip (mm_config /
        # --chip; gpu_h100 by default), so cross-device probes report
        # per-chip fractions.
        rep = roofline.analyze(
            roofline.ProgramCost(cost.flops, cost.bytes, cost.coll_bytes,
                                 cost.coll_counts, 0),
            arch=self.arch, shape=self.cell.name, mesh=self.mesh_kind,
            chips=self.chips, model_flops=mflops)
        rec = rep.to_json()
        rec["probe_s"] = time.time() - t0
        return rec


def _bench_record(rec: dict):
    """One probe cell as a structured BenchResult (repro_torch.bench).

    The roofline probe emits through the same record path as the
    benchmark harness so costprobe runs join the tracked perf series:
    the deterministic roofline terms land in `metrics`, the wall time of
    the probe itself rides along informationally (it is trace time, not
    device time).
    """
    from repro_torch.bench.record import BenchResult, Provenance

    name = f"roofline_{rec['arch']}_{rec['shape']}_{rec['mesh']}"
    # hlo_/collective_-prefixed names (and useful_ratio) are informational
    # by policy in repro_torch.bench.compare: they come from the traced op
    # counts, which move with torch versions, unlike the cost-model metrics.
    metrics = {
        "hlo_roofline_frac": rec["roofline_fraction"],
        "useful_ratio": rec["useful_ratio"],
        "hlo_tflops": rec["hlo_flops"] / 1e12,
        "hlo_gib": rec["hlo_bytes"] / 2**30,
        "collective_gib": rec["collective_bytes"] / 2**30,
    }
    return BenchResult(
        name=name, suite="roofline",
        axes={"arch": rec["arch"], "shape": rec["shape"],
              "mesh": rec["mesh"], "chips": rec["chips"]},
        metrics=metrics,
        info={"dominant": rec["dominant"]},
        provenance=Provenance.capture(),
        us_per_call=rec["probe_s"] * 1e6, us_iqr=None, repeats=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--bench-json", default=None,
                    help="also write the probed cells as structured "
                         "BenchResult records (repro_torch.bench schema)")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors and the mesh "
                         "(default: the card; cpu for the tests)")
    mmcfg.add_cli_args(ap)
    args = ap.parse_args(argv)
    dryrun.refuse_cuda_backend(ap, args)

    if args.all:
        cells = shapes_mod.cells(all_arch_ids(), get_config)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    bench_records = []
    with mmcfg.scope_from_args(args):
        for arch, shape in cells:
            path = os.path.join(args.out,
                                f"{arch}__{shape}__{args.mesh}.json")
            if args.skip_existing and os.path.exists(path):
                continue
            try:
                rec = CellProber(arch, shape, args.mesh,
                                 device=args.device).run()
                with open(path, "w") as fh:
                    json.dump(rec, fh, indent=2, default=float)
                if args.bench_json:
                    bench_records.append(_bench_record(rec))
                print(f"[probe] {arch} {shape} {args.mesh}: "
                      f"dom={rec['dominant']} "
                      f"frac={rec['roofline_fraction']:.3f} "
                      f"useful={rec['useful_ratio']:.2f} "
                      f"({rec['probe_s']:.0f}s)", flush=True)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                failures.append((arch, shape, repr(e)))
    if args.bench_json:
        # Written even when empty (all cells skipped/failed) so the
        # requested output always exists and says what happened.
        from repro_torch.bench import io as bench_io
        for p in bench_io.write_run(args.bench_json, bench_records, "full"):
            print(f"[probe] wrote {p} ({len(bench_records)} records)")
    if failures:
        print(f"[probe] {len(failures)} failures: {failures}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
