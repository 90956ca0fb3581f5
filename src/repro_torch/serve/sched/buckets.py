"""Bucket table: the bridge from request shapes to tuned shape classes.

`tune.shapeclass` buckets a dimension to the largest power of two *below*
it (flooring partition); the scheduler instead pads every batch and
prompt *up* to the next power of two, so the padded dimension IS its own
bucket representative — prefill and decode GEMMs land exactly on the
shapes the tuner measured, and `plan_mode="tuned"` resolves every plan
in-cache (gated: `tuned_misses == 0`).

Coverage is established by *tracing*, not by enumeration-by-hand:
`capture_gemm_specs` runs `engine.prefill` / `engine.decode_step` for
every (batch bucket, prompt bucket) combination on the ``meta`` device
(parameters mapped to meta tensors of the same shapes, the cache made
there too) under the "torch" backend, with `skewmm.plan_capture()`
armed.  A matmul plans before it dispatches, and the grouped expert GEMM
records its plan the same way, so the full planned workload — attention
projections, MLPs, MoE expert GEMMs, the unembed — is recorded while no
float is computed, no kernel is launched and no device memory is taken:
the port's counterpart of the JAX package's `jax.eval_shape`.
`build_tuned_cache` then tunes exactly those specs.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import config as mmcfg
from repro_torch.core import skewmm
from repro_torch.core.costmodel import MatmulCost
from repro_torch.serve import kvcache
from repro_torch.sparse.costmodel import SparseMatmulCost
from repro_torch.tune import cache as tune_cache
from repro_torch.tune import tuner
from repro_torch.tune.shapeclass import ShapeClass

# ("dense", m, k, n, batch, dtype_bytes) | ("grouped", g, m, k, n, dtype_bytes)
GemmSpec = tuple


def bucket_up(d: int) -> int:
    """Smallest power of two >= d — the pad target whose flooring bucket
    representative (`tune.shapeclass.bucket_dim`) is itself."""
    if d < 1:
        raise ValueError(f"dimension must be >= 1, got {d}")
    return 1 << (int(d) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class BucketTable:
    """The scheduler's shape policy.

    `batch_buckets` are the live-batch sizes the decode slab may take;
    `prompt_buckets` the padded prompt lengths prefill may issue; both
    are powers of two so every padded GEMM sits on a shape-class
    representative.  `max_new` bounds decode length per request and
    `max_len` sizes the KV cache (largest prompt bucket + max_new must
    fit).
    """

    batch_buckets: tuple[int, ...]
    prompt_buckets: tuple[int, ...]
    max_new: int
    max_len: int

    def __post_init__(self):
        for name in ("batch_buckets", "prompt_buckets"):
            vals = getattr(self, name)
            if not vals:
                raise ValueError(f"{name} must be non-empty")
            if tuple(sorted(vals)) != tuple(vals):
                raise ValueError(f"{name} must be sorted ascending: {vals}")
            for v in vals:
                if v < 1 or bucket_up(v) != v:
                    raise ValueError(
                        f"{name} entries must be powers of two, got {v}"
                    )
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if max(self.prompt_buckets) + self.max_new > self.max_len:
            raise ValueError(
                f"max_len {self.max_len} cannot hold prompt bucket "
                f"{max(self.prompt_buckets)} + max_new {self.max_new}"
            )

    @classmethod
    def for_workload(
        cls,
        *,
        max_batch: int,
        max_prompt: int,
        max_new: int,
        min_batch: int = 1,
        min_prompt: int = 1,
    ) -> "BucketTable":
        """Power-of-two ladders from the workload envelope."""

        def ladder(lo: int, hi: int) -> tuple[int, ...]:
            out, b = [], bucket_up(lo)
            while b <= bucket_up(hi):
                out.append(b)
                b *= 2
            return tuple(out)

        return cls(
            batch_buckets=ladder(min_batch, max_batch),
            prompt_buckets=ladder(min_prompt, max_prompt),
            max_new=max_new,
            max_len=bucket_up(max_prompt) + max_new,
        )

    def batch_bucket(self, n: int) -> int:
        """Smallest batch bucket >= n."""
        for b in self.batch_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch {n} exceeds largest bucket {self.batch_buckets[-1]}"
        )

    def prompt_bucket(self, s: int) -> int:
        """Smallest prompt bucket >= s."""
        for b in self.prompt_buckets:
            if b >= s:
                return b
        raise ValueError(
            f"prompt length {s} exceeds largest bucket "
            f"{self.prompt_buckets[-1]}"
        )

    def validate_for(self, cfg: ModelConfig) -> None:
        """Reject configs whose caches break right-padded-prompt
        exactness.

        Right-padding is exact for attention caches because pad slots
        stay invalid (per `kv_slot_positions`) until decode overwrites
        them.  SSM/recurrent state accumulates pad tokens and VLM
        frontends shift positions, so both are out of scope; ring (local
        window) caches are exact only while the prompt bucket fits the
        ring (no wrap during prefill).
        """
        if cfg.family == "vlm":
            raise ValueError("scheduler does not support VLM frontends")
        kinds = {k for unit, _ in cfg.stage_list() for k in unit}
        bad = {k for k in kinds if not k.startswith("attn")}
        if bad:
            raise ValueError(
                f"scheduler requires attention-only caches, got {sorted(bad)}"
            )
        if "attn_local" in kinds:
            ring = kvcache.attn_cache_len(cfg, "attn_local", self.max_len)
            if max(self.prompt_buckets) > ring:
                raise ValueError(
                    f"prompt bucket {max(self.prompt_buckets)} would wrap "
                    f"the ring cache ({ring}) during prefill"
                )


# ------------------------------------------------------------- capture
def _spec_of(cost) -> GemmSpec | None:
    if isinstance(cost, MatmulCost):
        d = cost.dims
        return ("dense", d.m, d.k, d.n, d.batch, d.dtype_bytes)
    if isinstance(cost, SparseMatmulCost):
        lay = cost.layout
        if lay.kind == "block_diag":
            g = lay.groups
            return ("grouped", g, lay.m // g, lay.k // g, cost.n, cost.dtype_bytes)
        return ("sparse", lay, cost.n, cost.dtype_bytes)
    return None  # UnplannedContraction: no tuned lookup happens for it


def _to_meta(tree):
    """The parameter tree with every tensor as a meta tensor of the same
    shape, dtype and strides (no storage)."""
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_meta(v) for v in tree]
    return tree.to("meta")


class _FirstRepeats:
    """`cfg` with every stage cut to its first repeat.  The repeats of a
    stage plan alike and only the first records its plans
    (`core.stage_trace`), so an abstract step of this config records what
    the whole model's would, at a fraction of the meta ops."""

    def __init__(self, cfg: ModelConfig):
        self._cfg = cfg

    def __getattr__(self, name):
        return getattr(self._cfg, name)

    def stage_list(self) -> list[tuple[tuple[str, ...], int]]:
        return [(unit, 1) for unit, _ in self._cfg.stage_list()]


@contextlib.contextmanager
def _abstract():
    """The scope an abstract step runs in: the "torch" backend, which plans
    and records every GEMM like the "cuda" one and then computes on meta
    tensors with plain PyTorch ops."""
    with mmcfg.mm_config(backend="torch"), torch.no_grad():
        yield


def _abstract_prefill(params, cfg: ModelConfig, batch: int, prompt: int,
                      max_len: int) -> None:
    from repro_torch.serve import engine

    tok = torch.empty((batch, prompt), dtype=torch.long, device="meta")
    with _abstract():
        engine.prefill(params, _FirstRepeats(cfg), tok, max_len=max_len)


def _abstract_decode(params, cfg: ModelConfig, batch: int,
                     max_len: int) -> None:
    from repro_torch.serve import engine

    cfg = _FirstRepeats(cfg)
    cache = kvcache.init_cache(cfg, batch, max_len, "meta")
    tok = torch.empty((batch,), dtype=torch.long, device="meta")
    pos = torch.empty((batch,), dtype=torch.int32, device="meta")
    with _abstract():
        engine.decode_step(params, cfg, cache, tok, pos)


def capture_gemm_specs(
    params, cfg: ModelConfig, table: BucketTable
) -> list[GemmSpec]:
    """Every planned GEMM the scheduler can issue, by abstract tracing.

    For each batch bucket B: for each prompt bucket P one prefill of (B, P)
    tokens, then one decode step at batch B (per-row positions).  The
    steps run on meta tensors: the planner runs and `plan_capture` records
    its costs, but nothing is computed, so this is cheap enough to run at
    scheduler construction.
    """
    meta = _to_meta(params)
    specs: dict[GemmSpec, None] = {}  # insertion-ordered set
    for bb in table.batch_buckets:
        with skewmm.plan_capture() as log:
            for pb in table.prompt_buckets:
                _abstract_prefill(meta, cfg, bb, pb, table.max_len)
            _abstract_decode(meta, cfg, bb, table.max_len)
        for cost in log:
            spec = _spec_of(cost)
            if spec is not None:
                specs[spec] = None
    return list(specs)


def decode_gemm_specs(
    params, cfg: ModelConfig, table: BucketTable
) -> list[GemmSpec]:
    """The planned GEMMs of the *decode step only*, per batch bucket.

    The decode m-tail of `capture_gemm_specs`: every dense spec here has
    m = a batch bucket (a handful of rows) — the shapes whose tuned
    entries should be measured split-K plans on chips where the GEMV
    family's modeled cost wins.  Used by the decode-smoke gate and the
    `--expect-gemv` serving CLI assertion.
    """
    meta = _to_meta(params)
    specs: dict[GemmSpec, None] = {}
    for bb in table.batch_buckets:
        with skewmm.plan_capture() as log:
            _abstract_decode(meta, cfg, bb, table.max_len)
        for cost in log:
            spec = _spec_of(cost)
            if spec is not None:
                specs[spec] = None
    return list(specs)


def step_plans(params, cfg: ModelConfig, batch: int, max_len: int, *,
               prompt: int | None = None) -> list:
    """The plans of one prefill of (batch, prompt) tokens or, with `prompt`
    None, of one decode step at `batch`, in call order, as `plan_capture`
    records them under the active matmul configuration (a tuned lookup
    counts as usual).  Run on the meta device: nothing is computed.  Two
    calls that plan every site alike run the same kernels at the same
    blocks, which is when a row of one can equal a row of the other."""
    meta = _to_meta(params)
    with skewmm.plan_capture() as log:
        if prompt is None:
            _abstract_decode(meta, cfg, batch, max_len)
        else:
            _abstract_prefill(meta, cfg, batch, prompt, max_len)
    return list(log)


def gemv_decode_coverage(
    cache: tune_cache.TuneCache,
    specs: list[GemmSpec],
    *,
    chip=None,
    amp: float | None = None,
) -> dict:
    """How the decode-step GEMMs resolve in a tuned cache, by family.

    Returns integer counters (all deterministic, benchable exact):
      decode_classes — distinct dense shape classes in the GEMV decode
                       regime (`ShapeClass.is_decode`) among `specs`;
      gemv_classes   — how many of those resolve to a split-K entry;
      dense_classes  — how many resolve to a dense-schedule entry.
    On chips where the split-K family's modeled cost wins at tiny m (the
    IPU), gemv_classes == decode_classes; HBM chips stay dense.
    """
    resolved = mmcfg.resolve(amp=amp, chip=chip)
    chip_name, amp_val = resolved.chip_spec.name, resolved.amp
    classes: dict[str, tune_cache.TuneEntry | None] = {}
    for spec in specs:
        if spec[0] != "dense":
            continue
        _, m, k, n, batch, db = spec
        cls = ShapeClass.of(m, k, n, batch)
        if not cls.is_decode:
            continue
        key = tune_cache.dense_key(chip_name, db, amp_val, cls)
        classes[key] = cache.get(key)
    gemv = sum(
        1 for e in classes.values() if e is not None and e.schedule == "splitk"
    )
    dense = sum(
        1 for e in classes.values() if e is not None and e.schedule != "splitk"
    )
    return {
        "decode_classes": len(classes),
        "gemv_classes": gemv,
        "dense_classes": dense,
    }


def modeled_step_seconds(
    params,
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    *,
    chip=None,
    amp: float | None = None,
) -> float:
    """Modeled wall time of one batched decode step on `chip`.

    Sum of the planned GEMM costs captured from an abstract (meta-device)
    run of `decode_step` at the given batch — the serving-level translation of
    the paper's per-matmul roofline comparison.  tokens/sec = batch over
    this number; the gc200-vs-rtx2080ti ratio is the skew verdict at the
    serving level."""
    with mmcfg.mm_config(chip=chip, amp=amp), skewmm.plan_capture() as log:
        _abstract_decode(_to_meta(params), cfg, batch, max_len)
    return sum(c.total_s for c in log if hasattr(c, "total_s"))


def build_tuned_cache(
    params,
    cfg: ModelConfig,
    table: BucketTable,
    *,
    chip=None,
    amp: float | None = None,
    measurer=None,
) -> tune_cache.TuneCache:
    """Tune every captured spec into a fresh `TuneCache`.

    The default measurer is `modeled_measurer(None)` — deterministic,
    zero wall-clock — so building serve coverage is cheap; pass
    `wallclock_measurer` for real measured tuning.
    """
    if measurer is None:
        measurer = tuner.modeled_measurer(None)
    cache = tune_cache.TuneCache()
    for spec in capture_gemm_specs(params, cfg, table):
        kind = spec[0]
        if kind == "dense":
            _, m, k, n, batch, db = spec
            entry = tuner.tune_dense(
                m,
                k,
                n,
                batch=batch,
                dtype_bytes=db,
                amp=amp,
                chip=chip,
                measurer=measurer,
            )
        elif kind == "grouped":
            _, g, m, k, n, db = spec
            entry = tuner.tune_grouped(
                g,
                m,
                k,
                n,
                dtype_bytes=db,
                amp=amp,
                chip=chip,
                measurer=measurer,
            )
        else:
            raise ValueError(f"unsupported serving GEMM kind: {spec!r}")
        cache.put(entry)
    return cache


def assert_covered(
    cache: tune_cache.TuneCache,
    specs: list[GemmSpec],
    *,
    chip=None,
    amp: float | None = None,
) -> None:
    """Raise unless every spec's shape class resolves in `cache`.

    This is the bucket table's contract with `plan_mode="tuned"`: run it
    at scheduler startup and the serving loop can gate on
    `tuned_misses == 0` instead of silently falling back to modeled
    plans.
    """
    resolved = mmcfg.resolve(amp=amp, chip=chip)
    chip_name, amp_val = resolved.chip_spec.name, resolved.amp
    missing = []
    for spec in specs:
        kind = spec[0]
        if kind == "dense":
            _, m, k, n, batch, db = spec
            key = tune_cache.dense_key(
                chip_name, db, amp_val, ShapeClass.of(m, k, n, batch)
            )
        elif kind == "grouped":
            _, g, m, k, n, db = spec
            key = tune_cache.grouped_key(
                chip_name, db, amp_val, g, ShapeClass.of(m, k, n)
            )
        else:
            raise ValueError(f"unsupported serving GEMM kind: {spec!r}")
        if cache.get(key) is None:
            missing.append(key)
    if missing:
        raise AssertionError(
            f"tuned cache does not cover {len(missing)} serving shape "
            f"classes: {sorted(set(missing))}"
        )
