"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake mesh.

For each cell this builds the real step (`train_step.make_train_step`,
`engine.prefill` / `decode_step`, or the encoder-decoder's), gives every
input a fake stand-in (`FakeTensorMode`: shapes and dtypes, nothing
allocated) placed as a `DTensor` by its production sharding on a
`DeviceMesh` over a fake process group of 256 ranks (pod, 16x16) or 512
(multipod, 2x16x16), runs the step once under `core.roofline`'s counter,
and records:

  * bytes per device: the peak of rank 0's live local bytes (proves it fits)
  * per-device FLOPs / bytes of the ops rank 0 runs, and apart from them
    the FLOPs of its GEMMs and attention (`gemm_flops`, a key JAX's
    record lacks: XLA's cost analysis gives no such split)
  * collective bytes and counts, the collectives DTensor inserts

into one roofline JSON a cell under build/dryrun/.  A cell that fails to
trace is a sharding bug (or a DTensor rule the port lacks), as a compile
failure is in the JAX package.  The process group is formed when a cell
runs, never at import.

The matmuls run on the "torch" rung, the counterpart of the JAX package's
"xla" (fake tensors cannot reach the hand-written kernels' launches):
``--mm-backend cuda`` is refused.  The JAX package compiles a `lax.scan`
over layers and microbatches once; the port's Python loops trace every
layer of every microbatch, so a full-depth cell takes minutes: ``--layers``
traces a cut depth (widths, FSDP choice and microbatches as published).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, all_arch_ids, get_config
from repro_torch.core import config as mmcfg
from repro_torch.core import roofline
from repro_torch.distributed import sharding as shd
from repro_torch.launch import shapes as shapes_mod

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")

FSDP_PARAM_THRESHOLD = 60e9   # >60B params: TP alone can't fit v5e HBM


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A stand-in's shape, dtype and partition spec (JAX's
    `ShapeDtypeStruct` with a `NamedSharding`)."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: shd.P


def input_specs(arch: str, shape_name: str, mesh,
                cfg: ModelConfig | None = None) -> dict[str, TensorSpec]:
    """Stand-in specs of every model input of the cell (`mesh` may be a
    `MeshShape`: only names and sizes are read)."""
    cfg = cfg or get_config(arch)
    cell = shapes_mod.SHAPES[shape_name]
    b, s = cell.global_batch, cell.seq_len
    batch = {"tokens": TensorSpec((b, s), torch.int32,
                                  shd.batch_spec((b, s), mesh))}
    if cfg.family == "vlm" and cell.mode != "decode":
        fshape = (b, cfg.frontend_len, cfg.d_model)
        batch["prefix_embeds"] = TensorSpec(fshape, torch.bfloat16,
                                            shd.batch_spec(fshape, mesh))
    if cfg.family == "encdec" and cell.mode != "decode":
        fshape = (b, min(cfg.frontend_len, s), cfg.d_model)
        batch["frames"] = TensorSpec(fshape, torch.bfloat16,
                                     shd.batch_spec(fshape, mesh))
    return batch


def _use_fsdp(cfg) -> bool:
    from repro_torch.models.model import count_params_active
    total, _ = count_params_active(cfg)
    return total > FSDP_PARAM_THRESHOLD


class Placer:
    """Makes the stand-ins: a tensor of a shape and dtype on `device`,
    placed on `mesh` as a `DTensor` by a spec (each rank builds only its
    shard), or whole when `mesh` is None.  Under `FakeTensorMode` they are
    fake; otherwise `seed` draws their values (bf16 / fp32 normals scaled
    by 0.02, int tokens below `vocab`)."""

    def __init__(self, mesh, device, *, seed: int | None = None,
                 vocab: int = 2):
        self.mesh, self.device, self.vocab = mesh, device, vocab
        self.gen = None
        if seed is not None:
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(seed)

    def _value(self, shape, dtype) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        if not dtype.is_floating_point:
            return torch.randint(0, self.vocab, shape, generator=self.gen,
                                 device=self.device, dtype=dtype)
        return (torch.randn(shape, generator=self.gen, device=self.device)
                * 0.02).to(dtype)

    def __call__(self, shape, dtype, spec) -> torch.Tensor:
        t = self._value(tuple(shape), dtype)
        if self.mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, shd.to_placements(spec, self.mesh),
                                 src_data_rank=None)

    def tree(self, shapes, specs, dtype=None):
        """A tree of stand-ins shaped as `shapes` (meta tensors)."""
        return shd.map_specs(
            lambda s, sp: self(s.shape, dtype or s.dtype, sp), shapes, specs)


def _param_sds(cfg, mesh, place: Placer, fsdp: bool):
    from repro_torch.models.model import param_shapes
    shapes = param_shapes(cfg)
    specs = shd.tree_param_specs(shapes, mesh, fsdp=fsdp)
    return place.tree(shapes, specs), specs, shapes


def host_scalar(value: int, dtype=torch.int32) -> torch.Tensor:
    """A real 0-d host tensor, made outside any `FakeTensorMode`: a fake
    one would leave the step counter's `int()` data-dependent."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return torch.tensor(value, dtype=dtype)


@dataclasses.dataclass
class Lowered:
    """A cell's step, ready to trace: ``fn(*args)``."""
    fn: Callable
    args: tuple
    chips: int
    model_flops: float


def cell_mesh(mesh_kind: str, device=None, dims: tuple | None = None):
    """The fake `DeviceMesh` of a cell: the production mesh of
    `mesh_kind`, or `dims` (axis names as the production mesh of that
    rank count: ("data", "model") or ("pod", "data", "model"))."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    from repro_torch.launch.mesh import make_fake_mesh, production_dims
    pdims, names = production_dims(mesh_kind == "multipod")
    if dims is not None:
        names = names[-len(dims):]
        pdims = tuple(dims)
    with unset_fake_temporarily():
        return make_fake_mesh(pdims, names, device)


def lower_cell(arch: str, shape_name: str, mesh_kind: str, *, mesh=None,
               cfg: ModelConfig | None = None, device=None) -> Lowered:
    """The cell's step and stand-ins on `mesh` (default: the fake
    production mesh of `mesh_kind`).  Call under `FakeTensorMode`.  `cfg`
    replaces the published config (a cut depth, `reduced()`); the FSDP
    choice and the microbatch count stay the published arch's."""
    from repro_torch.models.model import build_model, model_flops
    from repro_torch.serve import encdec_engine, engine, kvcache

    dev = resolve_device(device)
    if mesh is None:
        mesh = cell_mesh(mesh_kind, dev)
    chips = mesh.size()
    published = get_config(arch)
    cfg = cfg or published
    cell = shapes_mod.SHAPES[shape_name]
    place = Placer(mesh, dev)
    batch = {k: place(t.shape, t.dtype, t.spec)
             for k, t in input_specs(arch, shape_name, mesh, cfg).items()}
    params, p_specs, p_shapes = _param_sds(cfg, mesh, place,
                                           _use_fsdp(published))

    if cell.mode == "train":
        from repro_torch.optim.adamw import AdamW, AdamWState
        from repro_torch.train.prng import prng_key
        from repro_torch.train.train_step import (TrainState, TrainStepConfig,
                                                  make_train_step)
        from repro_torch.train.trainer import mesh_step
        opt = AdamW(lr=3e-4)
        ts_cfg = TrainStepConfig(
            n_microbatches=shapes_mod.microbatches_for(published, cell),
            loss_chunk=512)
        step_fn = make_train_step(build_model(cfg, device=dev), opt, ts_cfg)
        mu_specs = shd.tree_optstate_specs(p_specs, p_shapes, mesh)
        opt_state = AdamWState(
            step=host_scalar(0),
            mu=place.tree(p_shapes, mu_specs, torch.float32),
            nu=place.tree(p_shapes, mu_specs, torch.float32))
        state = TrainState(params=params, opt=opt_state, ef=None,
                           rng=prng_key(0))
        specs = TrainState(params=p_specs,
                           opt=AdamWState(step=None, mu=mu_specs,
                                          nu=mu_specs),
                           ef=None, rng=None)
        fn, args = mesh_step(step_fn, specs, mesh), (state, batch)
        n_tokens = cell.global_batch * cell.seq_len
        mflops = model_flops(cfg, tokens=n_tokens, mode="train")

    elif cell.mode == "prefill":
        max_len = cell.seq_len
        if cfg.family == "encdec":
            def step(params, batch):
                return encdec_engine.prefill(params, cfg, batch["frames"],
                                             batch["tokens"],
                                             max_len=max_len)
        else:
            def step(params, batch):
                return engine.prefill(params, cfg, batch["tokens"],
                                      max_len=max_len,
                                      prefix_embeds=batch.get(
                                          "prefix_embeds"))
        fn, args = shd.on_mesh(step, mesh), (params, batch)
        n_tokens = cell.global_batch * cell.seq_len
        mflops = model_flops(cfg, tokens=n_tokens, mode="serve")

    else:  # decode
        b = cell.global_batch
        tok = place((b,), torch.int32, shd.batch_spec((b,), mesh))
        pos = cell.seq_len - 1
        if cfg.family == "encdec":
            cache = encdec_engine.init_cache(
                cfg, b, cell.seq_len, min(cfg.frontend_len, cell.seq_len),
                dev, mesh=mesh)

            def step(params, cache, tok):
                return encdec_engine.decode_step(params, cfg, cache, tok,
                                                 pos)
        else:
            cache = kvcache.init_cache(cfg, b, cell.seq_len, dev, mesh=mesh)

            def step(params, cache, tok):
                return engine.decode_step(params, cfg, cache, tok, pos)
        fn, args = shd.on_mesh(step, mesh), (params, cache, tok)
        mflops = model_flops(cfg, tokens=cell.global_batch, mode="serve")

    return Lowered(fn=fn, args=args, chips=chips, model_flops=mflops)


def _local_bytes(tree) -> int:
    """Rank 0's bytes of a tree's tensors, each storage once."""
    from torch.utils._pytree import tree_flatten
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if not isinstance(t, torch.Tensor):
            continue
        st = (t.to_local() if hasattr(t, "placements") else t
              ).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, *,
             cfg: ModelConfig | None = None, mesh_dims: tuple | None = None,
             device=None) -> dict:
    """Trace one cell under `FakeTensorMode` on the "torch" rung and write
    its record (`mesh_dims` replaces the production mesh's sizes)."""
    dev = resolve_device(device)
    t0 = time.time()
    with fake_mode(), mmcfg.mm_config(backend="torch"):
        mesh = cell_mesh(mesh_kind, dev, mesh_dims)
        low = lower_cell(arch, shape_name, mesh_kind, mesh=mesh, cfg=cfg,
                         device=dev)
        t_lower = time.time() - t0
        arg_bytes = _local_bytes(low.args)
        out, cost = roofline.measure(low.fn, *low.args)
        out_bytes = _local_bytes(out)
        t_trace = time.time() - t0 - t_lower
    rep = roofline.analyze(
        cost, arch=arch, shape=shape_name, mesh=mesh_kind, chips=low.chips,
        model_flops=low.model_flops)
    rec = rep.to_json()
    rec.update(
        lower_s=t_lower, compile_s=t_trace,
        temp_bytes_per_device=max(cost.bytes_per_device - arg_bytes
                                  - out_bytes, 0),
        arg_bytes_per_device=arg_bytes,
        out_bytes_per_device=out_bytes,
        alias_bytes_per_device=0,
        code_bytes=0,
        gemm_flops=cost.gemm_flops,
    )
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=float)
    mem_gib = rec["bytes_per_device"] / 2**30
    print(f"[dryrun] {arch} {shape_name} {mesh_kind}: "
          f"trace={t_trace:.1f}s "
          f"mem/dev={mem_gib:.2f}GiB "
          f"dominant={rec['dominant']} frac={rec['roofline_fraction']:.3f}",
          flush=True)
    return rec


def cut_layers(cfg: ModelConfig, layers: int | None) -> ModelConfig:
    """`cfg` at its first `layers` layers (every width kept); as it is
    for None."""
    if layers is None or layers >= cfg.n_layers:
        return cfg
    kw: dict[str, Any] = {"n_layers": layers}
    if cfg.first_k_dense:
        kw["first_k_dense"] = min(cfg.first_k_dense, max(layers - 1, 0))
    if cfg.family == "encdec":
        kw["enc_layers"] = min(cfg.enc_layers, layers)
    return dataclasses.replace(cfg, **kw)


def refuse_cuda_backend(ap, args) -> None:
    if args.mm_backend == "cuda":
        ap.error("--mm-backend cuda: the launch tools trace fake tensors, "
                 "which the hand-written kernels cannot take; they run the "
                 "\"torch\" rung (the JAX package's \"xla\")")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors and the mesh "
                         "(default: the card; cpu for the tests)")
    ap.add_argument("--layers", type=int, default=None,
                    help="trace the first N layers of each config")
    mmcfg.add_cli_args(ap)
    args = ap.parse_args(argv)
    refuse_cuda_backend(ap, args)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cell_list = shapes_mod.cells(all_arch_ids(), get_config)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cell_list = [(args.arch, args.shape)]

    failures = []
    # Run-scoped matmul config: every cell traces under one mm_config
    # layer (an AMP/chip sweep over the whole dry-run matrix is a flag,
    # not a code edit).
    with mmcfg.scope_from_args(args):
        for arch, shape in cell_list:
            for mk in meshes:
                path = os.path.join(args.out, f"{arch}__{shape}__{mk}.json")
                if args.skip_existing and os.path.exists(path):
                    continue
                try:
                    run_cell(arch, shape, mk, args.out,
                             cfg=cut_layers(get_config(arch), args.layers),
                             device=args.device)
                except Exception as e:  # noqa: BLE001 — report and continue
                    failures.append((arch, shape, mk, repr(e)))
                    traceback.print_exc()
                    print(f"[dryrun] FAIL {arch} {shape} {mk}: {e}",
                          file=sys.stderr, flush=True)
    if failures:
        print(f"[dryrun] {len(failures)} failures", file=sys.stderr)
        sys.exit(1)
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
