"""Versioned JSON cache of measured plan winners.

One `TuneEntry` per (chip, dtype, AMP, shape class) — or, for sparse
entries, per exact `LayoutSummary` plus the bucketed rhs width — records
the measured winner among the modeled top-K candidate plans, the modeled
argmin it was compared against, and full provenance (git sha, torch and
CUDA versions, the card, iteration counts).  The cache is what
``plan_mode="tuned"`` consults at plan time (see
`repro_torch.tune.runtime`); `repro_torch.launch.tune` is the CLI that
fills it.  Schema, keys and entry fields are the JAX package's;
`provenance` is a free-form object, so a cache file loads in both
packages.

Schema::

    {
      "schema_version": 1,
      "created_utc": "...",
      "git_sha": "...",
      "entries": {"<key>": <TuneEntry.to_json()>, ...},
      "corrections": {"<chip>": <calibrate.Corrections.to_json()>, ...}
    }

Keys are flat strings so the file diffs readably::

    dense/tpu_v5e/dt2/amp0.45/m64k4096n4096b1
    sparse/ipu_gc200/dt2/amp0.45/bsr32x32blk128x128nnz410s13/n4096
    grouped/tpu_v5e/dt2/amp0.45/g8/m32k1024n4096b1

A `schema_version` mismatch on load raises `SchemaError`: stale caches
are rejected, never silently reinterpreted.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Mapping

from repro_torch.bench.record import SchemaError, git_sha
from repro_torch.core.costmodel import BlockPlan
from repro_torch.sparse.layout import LayoutSummary
from repro_torch.tune.shapeclass import ShapeClass, bucket_dim

TUNE_SCHEMA_VERSION = 1

KINDS = ("dense", "sparse", "grouped")


# ------------------------------------------------------------------- keys
def dense_key(chip: str, dtype_bytes: int, amp: float, cls: ShapeClass) -> str:
    return f"dense/{chip}/dt{dtype_bytes}/amp{amp:g}/{cls.token}"


def layout_token(summary: LayoutSummary) -> str:
    """Stable key fragment for a sparse structure (the exact summary —
    block-sparse winners are layout-specific, not bucketable)."""
    groups = f"g{summary.groups}" if summary.kind == "block_diag" else ""
    return (
        f"{summary.kind}{groups}{summary.gm}x{summary.gk}"
        f"blk{summary.bm}x{summary.bk}nnz{summary.nnz_blocks}s{summary.s_max}"
    )


def sparse_key(
    chip: str,
    dtype_bytes: int,
    amp: float,
    summary: LayoutSummary,
    n: int,
) -> str:
    return (
        f"sparse/{chip}/dt{dtype_bytes}/amp{amp:g}/"
        f"{layout_token(summary)}/n{bucket_dim(n)}"
    )


def grouped_key(
    chip: str,
    dtype_bytes: int,
    amp: float,
    groups: int,
    cls: ShapeClass,
) -> str:
    return f"grouped/{chip}/dt{dtype_bytes}/amp{amp:g}/g{groups}/{cls.token}"


# ---------------------------------------------------------------- entries
@dataclasses.dataclass(frozen=True)
class TuneEntry:
    """One measured tuning outcome: the winner plan plus its context.

    `measured_us` / `modeled_us` describe the winner; `modeled_best_*`
    the cost model's own argmin (always among the timed candidates, so
    `speedup` = measured time of the modeled plan over measured time of
    the winner is >= 1 by construction and `agreement` means the two
    plans coincide).  `provenance` carries the git sha, the software
    versions, the card and the timing iteration counts the measurement
    used.
    """

    key: str
    kind: str
    chip: str
    dtype_bytes: int
    amp: float
    schedule: str
    blocks: tuple[int, int, int]
    batch_grid: bool
    measured_us: float
    modeled_us: float
    modeled_best_schedule: str
    modeled_best_blocks: tuple[int, int, int]
    modeled_best_measured_us: float
    agreement: bool
    speedup: float
    provenance: dict[str, Any]

    def __post_init__(self):
        if self.kind not in KINDS:
            raise SchemaError(f"unknown tune entry kind {self.kind!r}")
        if self.measured_us <= 0 or self.modeled_us <= 0:
            raise SchemaError(
                f"entry {self.key!r}: timings must be positive "
                f"(measured={self.measured_us}, modeled={self.modeled_us})",
            )

    @property
    def plan(self) -> BlockPlan:
        bm, bk, bn = self.blocks
        return BlockPlan(bm, bk, bn, schedule=self.schedule, batch_grid=self.batch_grid)

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["blocks"] = list(self.blocks)
        d["modeled_best_blocks"] = list(self.modeled_best_blocks)
        return d

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "TuneEntry":
        if not isinstance(d, Mapping):
            raise SchemaError(f"tune entry must be an object, got {type(d)}")
        known = {f.name for f in dataclasses.fields(cls)}
        missing = known - set(d)
        if missing:
            raise SchemaError(
                f"tune entry {d.get('key', '?')!r} missing fields "
                f"{sorted(missing)}",
            )
        unknown = set(d) - known
        if unknown:
            raise SchemaError(
                f"tune entry {d.get('key', '?')!r} has unknown fields "
                f"{sorted(unknown)}",
            )
        kw = dict(d)
        for field in ("blocks", "modeled_best_blocks"):
            kw[field] = tuple(int(b) for b in kw[field])
        if not isinstance(kw["provenance"], Mapping):
            raise SchemaError(
                f"tune entry {d['key']!r}: provenance must be an object",
            )
        kw["provenance"] = dict(kw["provenance"])
        return cls(**kw)


def entry_provenance(iters: int, repeats: int) -> dict[str, Any]:
    """The per-entry provenance dict every tuning measurement records: git
    sha, torch and CUDA versions, the card's name (None off the card) and
    the timing iteration counts."""
    import torch

    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else None)
    return {
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": card,
        "iters": int(iters),
        "repeats": int(repeats),
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }


# ------------------------------------------------------------------ cache
@dataclasses.dataclass
class TuneCache:
    """In-memory view of one cache document (entries + fitted corrections).

    `corrections` holds `repro_torch.tune.calibrate.Corrections.to_json()`
    dicts per chip name — persisted alongside the entries so an off-host
    consumer can re-register corrected `ChipSpec`s without re-measuring.
    """

    entries: dict[str, TuneEntry] = dataclasses.field(default_factory=dict)
    corrections: dict[str, dict] = dataclasses.field(default_factory=dict)

    def get(self, key: str) -> TuneEntry | None:
        return self.entries.get(key)

    def put(self, entry: TuneEntry) -> None:
        if entry.key in self.entries:
            # Latest measurement wins — re-tuning refreshes the entry.
            del self.entries[entry.key]
        self.entries[entry.key] = entry

    def to_json(self) -> dict[str, Any]:
        return {
            "schema_version": TUNE_SCHEMA_VERSION,
            "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "git_sha": git_sha(),
            "entries": {k: e.to_json() for k, e in sorted(self.entries.items())},
            "corrections": {k: dict(v) for k, v in sorted(self.corrections.items())},
        }

    @classmethod
    def from_json(cls, doc: Mapping[str, Any], source: str = "<doc>") -> "TuneCache":
        if not isinstance(doc, Mapping):
            raise SchemaError(f"{source}: cache document must be a JSON object")
        if doc.get("schema_version") != TUNE_SCHEMA_VERSION:
            raise SchemaError(
                f"{source}: schema_version {doc.get('schema_version')!r} "
                f"(expected {TUNE_SCHEMA_VERSION})",
            )
        raw = doc.get("entries", {})
        if not isinstance(raw, Mapping):
            raise SchemaError(f"{source}: entries must be an object")
        entries = {}
        for key, e in raw.items():
            entry = TuneEntry.from_json(e)
            if entry.key != key:
                raise SchemaError(
                    f"{source}: entry stored under {key!r} names itself "
                    f"{entry.key!r}",
                )
            entries[key] = entry
        corrections = doc.get("corrections", {})
        if not isinstance(corrections, Mapping):
            raise SchemaError(f"{source}: corrections must be an object")
        return cls(
            entries=entries,
            corrections={k: dict(v) for k, v in corrections.items()},
        )

    def save(self, path: str) -> str:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, default=float)
            fh.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "TuneCache":
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except json.JSONDecodeError as e:
            raise SchemaError(f"{path}: not valid JSON ({e})") from None
        return cls.from_json(doc, source=path)


def load_or_quarantine(path: str) -> tuple["TuneCache", str | None]:
    """Load a cache file, quarantining it on schema/parse failure.

    The graceful-degradation loader the *ambient* default cache uses
    (`runtime.get_active_cache`): a truncated, non-JSON or stale-schema
    file is moved aside to ``<path>.corrupt`` (best-effort — a rename
    failure still degrades, it just leaves the bad file in place so the
    next process re-reports it) and an empty cache is returned, so every
    tuned lookup misses and planning falls back to the modeled modes.

    Returns ``(cache, problem)`` — `problem` is None on a clean load,
    else a human-readable description for the caller's single warning.
    Explicit loads (`TuneCache.load` / `set_active_cache`) stay loud.
    """
    try:
        return TuneCache.load(path), None
    except SchemaError as e:
        quarantine = f"{path}.corrupt"
        try:
            os.replace(path, quarantine)
            problem = f"{e} (quarantined to {quarantine})"
        except OSError:
            problem = f"{e} (quarantine to {quarantine} failed)"
        return TuneCache(), problem
