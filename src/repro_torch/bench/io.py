"""Read/write benchmark-results documents (the JAX package's format).

A *run document* is a JSON object::

    {
      "schema_version": 1,
      "fidelity": "tiny" | "full",
      "created_utc": "...",
      "git_sha": "...",
      "records": [<BenchResult.to_json()>, ...]
    }

`write_run` emits one combined document (``BENCH_<timestamp>.json`` by
convention, see `default_run_path`) plus one per-suite sibling (``<stem>.<suite>.json``) so downstream
tooling can diff a single figure's records without parsing the whole
run.  `write_baselines` / `read_baselines` manage the committed
regression surface under ``benchmarks/baselines/``: one document per
suite, named ``<suite>.json``.

Fidelity matters: a ``--tiny`` run measures reduced problem sizes, so
its records are only comparable against baselines captured at the same
fidelity.  Readers surface the fidelity so `compare` callers can refuse
cross-fidelity diffs instead of failing confusingly.
"""

from __future__ import annotations

import json
import os
import time

from repro_torch.bench.record import (
    SCHEMA_VERSION,
    BenchResult,
    SchemaError,
    git_sha,
    validate_records,
)

FIDELITIES = ("tiny", "full")


def default_run_path(root: str = ".") -> str:
    """``BENCH_<UTC timestamp>.json`` at `root` — the perf-trajectory file."""
    stamp = time.strftime("%Y%m%d_%H%M%S", time.gmtime())
    return os.path.join(root, f"BENCH_{stamp}.json")


def _document(records: list[BenchResult], fidelity: str) -> dict:
    if fidelity not in FIDELITIES:
        raise ValueError(f"fidelity must be one of {FIDELITIES}, got {fidelity!r}")
    validate_records(records)
    return {
        "schema_version": SCHEMA_VERSION,
        "fidelity": fidelity,
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": git_sha(),
        "records": [r.to_json() for r in records],
    }


def _write_document(path: str, records: list[BenchResult], fidelity: str) -> None:
    doc = _document(records, fidelity)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, default=float)
        fh.write("\n")


def write_run(
    path: str,
    records: list[BenchResult],
    fidelity: str,
    per_suite: bool = True,
) -> list[str]:
    """Write the combined run document plus per-suite siblings.

    Returns the list of paths written (combined document first).  The
    per-suite files are named ``<stem>.<suite>.json`` next to `path`.
    """
    _write_document(path, records, fidelity)
    written = [path]
    if per_suite:
        stem, ext = os.path.splitext(path)
        suites = sorted({r.suite for r in records})
        for suite in suites:
            suite_path = f"{stem}.{suite}{ext or '.json'}"
            subset = [r for r in records if r.suite == suite]
            _write_document(suite_path, subset, fidelity)
            written.append(suite_path)
    return written


def _read_document(path: str) -> tuple[dict, list[BenchResult]]:
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except json.JSONDecodeError as e:
        raise SchemaError(f"{path}: not valid JSON ({e})") from None
    if not isinstance(doc, dict):
        raise SchemaError(f"{path}: document must be a JSON object")
    if doc.get("schema_version") != SCHEMA_VERSION:
        raise SchemaError(
            f"{path}: schema_version {doc.get('schema_version')!r} "
            f"(expected {SCHEMA_VERSION})",
        )
    if doc.get("fidelity") not in FIDELITIES:
        raise SchemaError(f"{path}: bad fidelity {doc.get('fidelity')!r}")
    raw = doc.get("records")
    if not isinstance(raw, list):
        raise SchemaError(f"{path}: records must be a list")
    records = [BenchResult.from_json(r) for r in raw]
    validate_records(records)
    return doc, records


def read_run(path: str) -> tuple[dict, list[BenchResult]]:
    """Read and schema-validate one run document -> (meta, records)."""
    doc, records = _read_document(path)
    meta = {k: v for k, v in doc.items() if k != "records"}
    return meta, records


def write_baselines(
    directory: str,
    records: list[BenchResult],
    fidelity: str,
) -> list[str]:
    """Write one ``<suite>.json`` baseline document per suite present."""
    os.makedirs(directory, exist_ok=True)
    written = []
    for suite in sorted({r.suite for r in records}):
        path = os.path.join(directory, f"{suite}.json")
        subset = [r for r in records if r.suite == suite]
        _write_document(path, subset, fidelity)
        written.append(path)
    return written


def read_baselines(directory: str) -> tuple[str, list[BenchResult]]:
    """Read every ``*.json`` baseline in `directory` -> (fidelity, records).

    All baseline files must agree on fidelity (they are written together
    by ``--update-baseline``); a mismatch raises `SchemaError`.
    """
    if not os.path.isdir(directory):
        raise SchemaError(f"baseline directory {directory!r} does not exist")
    names = sorted(n for n in os.listdir(directory) if n.endswith(".json"))
    if not names:
        raise SchemaError(f"no baseline .json files under {directory!r}")
    fidelity = None
    records: list[BenchResult] = []
    for name in names:
        doc, recs = _read_document(os.path.join(directory, name))
        if fidelity is None:
            fidelity = doc["fidelity"]
        elif doc["fidelity"] != fidelity:
            raise SchemaError(
                f"{name}: fidelity {doc['fidelity']!r} disagrees with "
                f"sibling baselines ({fidelity!r})",
            )
        records.extend(recs)
    validate_records(records)
    return fidelity, records
