"""Structured benchmark records: the port's machine-readable perf surface.

Every number a benchmark reports becomes a `BenchResult`: the measured
time (median / IQR over repeats), the deterministic *modeled* quantities
(roofline fractions, vertex counts, skew spreads) and its provenance:
the chip the planner targeted, the resolved `MatmulConfig`, the chosen
plan (schedule + blocks), the torch / python versions and the git sha.

The schema is the JAX package's.  `Provenance` records `torch_version`
where the reference records `jax_version`; the reader takes either, so
the JAX-written baselines under ``benchmarks/baselines/`` read as they
are.  `trace_digest` holds the armed trace's span-kind counts
(`repro_torch.obs`) when a record is captured inside a `trace_scope`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import platform
import subprocess
from typing import Any, Mapping

SCHEMA_VERSION = 1


class SchemaError(ValueError):
    """A results or cache document does not match the expected schema."""


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """Short sha of the checkout this code lives in ("unknown" off-git),
    resolved against this file's directory, not the process cwd."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10,
                             check=False,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else "unknown"


def _plan_fields(plan: Any) -> dict[str, Any]:
    """Provenance's plan fields from a `MatmulCost` (anything with
    `plan_provenance()`), a dict of the fields, or None."""
    if plan is None:
        return {}
    if hasattr(plan, "plan_provenance"):
        plan = plan.plan_provenance()
    if not isinstance(plan, Mapping):
        raise TypeError(f"plan must be a MatmulCost, a provenance dict, or "
                        f"None; got {type(plan).__name__}")
    allowed = {"schedule", "blocks", "batch_grid", "grid_steps", "sharding"}
    fields = {k: plan[k] for k in allowed if k in plan}
    if fields.get("blocks") is not None:
        fields["blocks"] = tuple(int(b) for b in fields["blocks"])
    return fields


# Fields left out of the JSON when None, so that ordinary records stay
# unchanged: a clean process (guard), no trace, unsharded runs, and the
# version field of the other package.
_OPTIONAL_JSON = ("torch_version", "jax_version", "guard", "trace_digest",
                  "mesh", "sharding")
_VERSION_FIELDS = ("torch_version", "jax_version")


@dataclasses.dataclass(frozen=True)
class Provenance:
    """Where a record's numbers came from: resolved config + chosen plan."""

    chip: str
    amp: float
    backend: str
    plan_mode: str
    python_version: str
    git_sha: str
    torch_version: str | None = None
    jax_version: str | None = None    # records written by the JAX package
    schedule: str | None = None
    blocks: tuple[int, int, int] | None = None
    batch_grid: bool | None = None
    grid_steps: int | None = None
    guard: dict | None = None
    trace_digest: dict | None = None
    mesh: str | None = None           # the configured mesh, e.g. "4x2"
    sharding: str | None = None       # the chosen ShardSpec, described

    @classmethod
    def capture(cls, config: Any = None, plan: Any = None) -> "Provenance":
        """Snapshot the active `mm_config` resolution plus a chosen plan.

        `config` defaults to the context-resolved `MatmulConfig`; `plan`
        is the `MatmulCost` (or provenance dict) of the record's headline
        matmul.  `guard` holds the health counters (and histogram
        percentiles) when any is non-zero, so a record produced on a
        degraded process says so.  `trace_digest` holds the armed trace's
        span-kind counts, present only when a `trace_scope` is active and
        has collected spans.
        """
        import torch

        from repro_torch.core import config as mmcfg
        from repro_torch.guard import health as guard_health
        from repro_torch.obs import spans as obs_spans

        trace = obs_spans.current_trace()
        digest = trace.digest() if trace is not None else None
        if digest is not None and not digest.get("total"):
            digest = None  # an armed-but-empty trace leaves records clean
        cfg = config if config is not None else mmcfg.current()
        return cls(
            **cfg.provenance(),
            torch_version=torch.__version__,
            python_version=platform.python_version(),
            git_sha=git_sha(),
            guard=guard_health.provenance_fields(),
            trace_digest=digest,
            **_plan_fields(plan),
        )

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["blocks"] is not None:
            d["blocks"] = list(d["blocks"])
        for key in _OPTIONAL_JSON:
            if d[key] is None:
                del d[key]
        return d

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "Provenance":
        if not isinstance(d, Mapping):
            raise SchemaError(f"provenance must be an object, got {type(d)}")
        for key in ("guard", "trace_digest"):
            if d.get(key) is not None and not isinstance(d[key], Mapping):
                raise SchemaError(f"provenance {key} must be an object")
        required = {"chip", "amp", "backend", "plan_mode", "python_version",
                    "git_sha"}
        missing = required - set(d)
        if missing:
            raise SchemaError(f"provenance missing fields {sorted(missing)}")
        if not any(d.get(v) is not None for v in _VERSION_FIELDS):
            raise SchemaError("provenance names neither torch_version nor "
                              "jax_version")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise SchemaError(f"provenance has unknown fields {sorted(unknown)}")
        kw = dict(d)
        if kw.get("blocks") is not None:
            kw["blocks"] = tuple(int(b) for b in kw["blocks"])
        for key in ("guard", "trace_digest"):
            if kw.get(key) is not None:
                kw[key] = dict(kw[key])
        return cls(**kw)


def _fmt(v: Any) -> str:
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            return str(v)
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return f"{v:.3f}" if 1e-3 <= abs(v) < 1e4 else f"{v:g}"
    return str(v)


@dataclasses.dataclass(frozen=True)
class BenchResult:
    """One benchmark row: a name, its axes, measurement, and modeled metrics.

    `metrics` holds numbers (the compared surface); `info` short strings
    (schedule, plan spelling) compared for exact equality; `axes` the
    point in the sweep.  `us_per_call` is the median measured time over
    `repeats` repetitions (None for a modeled-only row), `us_iqr` its
    interquartile range.
    """

    name: str
    suite: str
    axes: dict[str, Any]
    metrics: dict[str, float]
    info: dict[str, str]
    provenance: Provenance
    us_per_call: float | None = None
    us_iqr: float | None = None
    repeats: int = 0
    outliers: int = 0

    def to_json(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "suite": self.suite,
            "axes": dict(self.axes),
            "metrics": dict(self.metrics),
            "info": dict(self.info),
            "provenance": self.provenance.to_json(),
            "us_per_call": self.us_per_call,
            "us_iqr": self.us_iqr,
            "repeats": self.repeats,
            "outliers": self.outliers,
        }

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "BenchResult":
        if not isinstance(d, Mapping):
            raise SchemaError(f"record must be an object, got {type(d)}")
        required = {"name", "suite", "axes", "metrics", "info", "provenance"}
        missing = required - set(d)
        if missing:
            raise SchemaError(f"record {d.get('name', '?')!r} missing fields "
                              f"{sorted(missing)}")
        for field in ("name", "suite"):
            if not isinstance(d[field], str) or not d[field]:
                raise SchemaError(f"record {field} must be a non-empty string")
        for field in ("axes", "metrics", "info"):
            if not isinstance(d[field], Mapping):
                raise SchemaError(f"record {d['name']!r}: {field} must be an "
                                  f"object")
        for k, v in d["metrics"].items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise SchemaError(f"record {d['name']!r}: metric {k!r} must "
                                  f"be numeric, got {v!r}")
        for k, v in d["info"].items():
            if not isinstance(v, str):
                raise SchemaError(f"record {d['name']!r}: info {k!r} must be "
                                  f"a string, got {v!r}")
        us = d.get("us_per_call")
        if us is not None and not isinstance(us, (int, float)):
            raise SchemaError(f"record {d['name']!r}: bad us_per_call {us!r}")
        return cls(
            name=d["name"],
            suite=d["suite"],
            axes=dict(d["axes"]),
            metrics={k: float(v) for k, v in d["metrics"].items()},
            info=dict(d["info"]),
            provenance=Provenance.from_json(d["provenance"]),
            us_per_call=None if us is None else float(us),
            us_iqr=None if d.get("us_iqr") is None else float(d["us_iqr"]),
            repeats=int(d.get("repeats", 0)),
            outliers=int(d.get("outliers", 0)),
        )

    def csv_row(self) -> str:
        """The ``name,us_per_call,derived`` stdout row."""
        us = float("nan") if self.us_per_call is None else self.us_per_call
        parts = [f"{k}={_fmt(v)}" for k, v in self.metrics.items()]
        parts += [f"{k}={v}" for k, v in self.info.items()]
        return f"{self.name},{us:.1f},{';'.join(parts)}"


def validate_records(records: list[BenchResult]) -> None:
    """Cross-record invariants: unique names, finite metrics."""
    seen: set[str] = set()
    for r in records:
        if r.name in seen:
            raise SchemaError(f"duplicate record name {r.name!r}")
        seen.add(r.name)
        for k, v in r.metrics.items():
            if not math.isfinite(v):
                raise SchemaError(f"record {r.name!r}: metric {k!r} is not "
                                  f"finite ({v!r})")
