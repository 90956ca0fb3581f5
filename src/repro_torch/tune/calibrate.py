"""Regress measured-vs-modeled ratios into per-chip correction factors.

The cost model's constants are datasheet-derived; Jia et al.
(arXiv:1912.03413) showed how far measured characterization can diverge
from them.  Calibration closes the loop: every `TuneEntry` carries both
a measured and a modeled time for its winner, and the ratio field is a
per-chip *efficiency* — the fraction of the modeled speed the host
actually achieved.  Fitting over a cache's entries yields:

* ``time_frac`` — geometric-mean ``modeled / measured`` over dense (and
  grouped — regular index maps, no gather) entries, clamped to (0, 1]:
  a uniform achieved-fraction of the modeled peaks.
* ``sparse_gather_frac`` — the measured gather efficiency: what
  `ChipSpec.sparse_gather_frac` *should* be so the sparse model's
  residual (beyond the dense miscalibration) matches the measurements.

`apply_corrections` folds both into a new `ChipSpec` (peaks and
bandwidth scaled by ``time_frac``, the fitted gather fraction swapped
in) which `hw.register_chip` can absorb — re-registering under the same
name shadows the datasheet spec, so *modeled* sweeps improve even on
hosts that never ran the tuner.  A copy of the JAX package's fit.

Every factor is clamped into (0, 1] (`unit_clamp`): a host can be
arbitrarily slower than the model but never credited as faster than the
roofline — tested over seeded ratio sweeps (tests/test_torch_tune.py).

Quality gate: a single scalar `time_frac` is only meaningful when the
per-entry ratios it averages agree with each other.  `fit_corrections`
records the cross-shape residual spread (`log_spread` — the worst
entry's log-distance from the geomean) and marks the fit rejected when
it exceeds `MAX_LOG_SPREAD`; `apply_corrections` *refuses* a rejected
fit, so noisy hosts can never auto-register a corrected `ChipSpec`.
Rejections are counted in `repro_torch.guard.health`
("calibration_rejected") and warned about at fit time.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Iterable, Mapping

from repro_torch.bench.record import SchemaError
from repro_torch.core import hw
from repro_torch.guard import health as _health
from repro_torch.tune.cache import TuneEntry

# Floor of the (0, 1] clamp: keeps fitted factors strictly positive so a
# corrected ChipSpec never has a zero peak (division by achieved rate).
UNIT_FLOOR = 1e-6

# Reject a fit when any dense/grouped entry's modeled/measured ratio sits
# more than 4x (in either direction) off the fitted geomean: a scalar
# efficiency cannot describe a host whose shapes disagree that much —
# applying it would miscalibrate every shape but the average one.
MAX_LOG_SPREAD = math.log(4.0)


def unit_clamp(x: float) -> float:
    """Clamp a ratio into (0, 1] — the correction-factor codomain."""
    if not math.isfinite(x) or x <= 0.0:
        return UNIT_FLOOR
    return min(1.0, max(UNIT_FLOOR, x))


def correction_factor(measured_us: float, modeled_us: float) -> float:
    """One entry's efficiency: modeled / measured, clamped to (0, 1]."""
    if measured_us <= 0 or modeled_us <= 0:
        raise ValueError(
            f"timings must be positive, got measured={measured_us} "
            f"modeled={modeled_us}",
        )
    return unit_clamp(modeled_us / measured_us)


def _geomean(values: list[float]) -> float:
    return math.exp(sum(math.log(v) for v in values) / len(values))


@dataclasses.dataclass(frozen=True)
class Corrections:
    """Fitted per-chip correction factors (all in (0, 1]).

    `log_spread` is the fit's quality metric (worst dense/grouped
    entry's |log(ratio) - log(geomean)|); `accepted` records whether it
    passed `MAX_LOG_SPREAD` — a rejected fit is carried in the cache for
    inspection but `apply_corrections` refuses to absorb it.
    """

    chip: str
    time_frac: float
    sparse_gather_frac: float | None
    n_dense: int
    n_sparse: int
    log_spread: float = 0.0
    accepted: bool = True

    def __post_init__(self):
        if not 0.0 < self.time_frac <= 1.0:
            raise ValueError(f"time_frac outside (0, 1]: {self.time_frac}")
        g = self.sparse_gather_frac
        if g is not None and not 0.0 < g <= 1.0:
            raise ValueError(f"sparse_gather_frac outside (0, 1]: {g}")
        if not (math.isfinite(self.log_spread) and self.log_spread >= 0.0):
            raise ValueError(f"log_spread must be >= 0: {self.log_spread}")

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "Corrections":
        known = {f.name for f in dataclasses.fields(cls)}
        if set(d) != known:
            raise SchemaError(
                f"corrections fields {sorted(d)} != expected {sorted(known)}",
            )
        return cls(**dict(d))


def fit_gather_frac(base_gather_frac: float, ratios: Iterable[float]) -> float:
    """Fitted sparse gather efficiency from residual sparse ratios.

    `ratios` are per-entry ``(modeled / measured) / time_frac`` residuals
    — how much slower gathered execution ran beyond the chip's general
    miscalibration.  The fit rescales the datasheet `sparse_gather_frac`
    by their geometric mean; the result stays in (0, 1] for any positive
    inputs (tested over a seeded sweep).
    """
    ratios = [r for r in ratios if math.isfinite(r) and r > 0]
    if not ratios:
        return unit_clamp(base_gather_frac)
    return unit_clamp(unit_clamp(base_gather_frac) * _geomean(ratios))


def fit_corrections(
    entries: Iterable[TuneEntry],
    chip: hw.ChipSpec | str,
) -> Corrections:
    """Fit `Corrections` for one chip from a cache's measured entries.

    Dense and grouped entries (regular index maps) calibrate
    ``time_frac``; sparse (gathered) entries calibrate the gather
    fraction on top of it.  With no sparse entries the fitted gather
    fraction is None (the datasheet value stands); with no entries at
    all the corrections are the identity.
    """
    spec = hw.get_chip(chip)
    dense_r: list[float] = []
    sparse_r: list[float] = []
    for e in entries:
        if e.chip != spec.name:
            continue
        r = e.modeled_us / e.measured_us
        if not math.isfinite(r) or r <= 0:
            continue
        (sparse_r if e.kind == "sparse" else dense_r).append(r)
    time_frac = unit_clamp(_geomean(dense_r)) if dense_r else 1.0
    gather = None
    if sparse_r:
        gather = fit_gather_frac(
            spec.sparse_gather_frac, [r / time_frac for r in sparse_r]
        )
    # Fit residual / cross-shape spread: the worst entry's log-distance
    # from the geomean.  A scalar time_frac only describes the host when
    # the shapes agree; beyond MAX_LOG_SPREAD the fit is marked rejected.
    log_spread = 0.0
    if len(dense_r) > 1:
        center = math.log(_geomean(dense_r))
        log_spread = max(abs(math.log(r) - center) for r in dense_r)
    accepted = log_spread <= MAX_LOG_SPREAD
    if not accepted:
        _health.record("calibration_rejected")
        warnings.warn(
            f"calibration fit for {spec.name} rejected: cross-shape "
            f"spread {math.exp(log_spread):.2f}x exceeds "
            f"{math.exp(MAX_LOG_SPREAD):.0f}x "
            f"(n_dense={len(dense_r)}); corrections will not be absorbed",
            stacklevel=2,
        )
    return Corrections(
        chip=spec.name,
        time_frac=time_frac,
        sparse_gather_frac=gather,
        n_dense=len(dense_r),
        n_sparse=len(sparse_r),
        log_spread=log_spread,
        accepted=accepted,
    )


def apply_corrections(spec: hw.ChipSpec, corr: Corrections) -> hw.ChipSpec:
    """A `ChipSpec` with the fitted factors folded in (same name, so
    ``hw.register_chip(apply_corrections(...))`` shadows the datasheet
    spec and modeled sweeps pick the calibrated constants up)."""
    if corr.chip != spec.name:
        raise ValueError(
            f"corrections fitted for {corr.chip!r}, spec is {spec.name!r}",
        )
    if not corr.accepted:
        raise ValueError(
            f"corrections for {corr.chip!r} were rejected at fit time "
            f"(cross-shape spread {math.exp(corr.log_spread):.2f}x > "
            f"{math.exp(MAX_LOG_SPREAD):.0f}x); refusing to absorb them",
        )
    kw: dict[str, Any] = {
        "peak_bf16_flops": spec.peak_bf16_flops * corr.time_frac,
        "peak_fp32_flops": spec.peak_fp32_flops * corr.time_frac,
        "hbm_bw": spec.hbm_bw * corr.time_frac,
    }
    if corr.sparse_gather_frac is not None:
        kw["sparse_gather_frac"] = corr.sparse_gather_frac
    return dataclasses.replace(spec, **kw)
