"""The live side of the autotuner: which cache ``plan_mode="tuned"`` reads.

The planners must not pay file IO per plan, and — unlike the modeled
modes — a tuned plan depends on *mutable* state (the active cache), so
tuned lookups deliberately bypass the planners' lru caches.  This module
owns that state:

* `use_cache(cache)` / `set_active_cache(cache)` — install a `TuneCache`
  (or a path to one) for the process; `use_cache` is the scoped form
  tests and suites use.
* With nothing installed, the default on-disk cache is loaded lazily,
  once: ``$REPRO_TORCH_TUNE_CACHE`` if set, else
  ``build/tune/tune_cache.json`` at the repo root (``build/`` is where
  the port's kernels are built too, and git ignores it).  A missing — or
  stale / schema-rejected — default file is an empty cache (every lookup
  misses -> modeled fallback, with a warning for the rejected case),
  never an error; explicitly installed caches still fail loudly.
* `lookup_dense` / `lookup_sparse` / `lookup_grouped` — the planner-facing
  queries: build the cache key for a problem (bucketing dense shapes via
  `ShapeClass`), return the cached winner `BlockPlan` or None.  Each
  lookup is a `cache_corrupt` injection site (`guard.faults`) and, with
  a `trace_scope` armed, emits a "tune" event and stamps its key on the
  enclosing dispatch span.
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings
from typing import Iterator

from repro_torch.core import hw
from repro_torch.core.costmodel import BlockPlan
from repro_torch.guard import faults as _faults
from repro_torch.guard import health as _health
from repro_torch.obs import spans as _obs
from repro_torch.sparse.layout import LayoutSummary
from repro_torch.tune.cache import (
    TuneCache,
    dense_key,
    grouped_key,
    load_or_quarantine,
    sparse_key,
)
from repro_torch.tune.shapeclass import ShapeClass

ENV_CACHE = "REPRO_TORCH_TUNE_CACHE"

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def default_cache_path() -> str:
    """``$REPRO_TORCH_TUNE_CACHE`` or ``build/tune/tune_cache.json`` at
    the repo root."""
    return os.environ.get(ENV_CACHE) or os.path.join(
        _REPO_ROOT, "build", "tune", "tune_cache.json"
    )


_LOCK = threading.Lock()
_ACTIVE: TuneCache | None = None
_DEFAULT: TuneCache | None = None
_DEFAULT_LOADED = False


def set_active_cache(cache: TuneCache | str | None) -> None:
    """Install the process-wide tuned-plan cache (a path loads it).

    None reverts to the lazily-loaded default cache.
    """
    global _ACTIVE
    if isinstance(cache, str):
        cache = TuneCache.load(cache)
    with _LOCK:
        _ACTIVE = cache


def get_active_cache() -> TuneCache:
    """The cache tuned lookups consult right now (may be empty)."""
    global _DEFAULT, _DEFAULT_LOADED
    with _LOCK:
        if _ACTIVE is not None:
            return _ACTIVE
        if not _DEFAULT_LOADED:
            path = default_cache_path()
            if os.path.exists(path):
                # The *ambient* default degrades gracefully: a stale or
                # truncated on-disk cache must not crash every tuned
                # plan — the bad file is quarantined to <path>.corrupt
                # and lookups just stop answering.  Explicit loads
                # (set_active_cache / TuneCache.load) stay loud.
                _DEFAULT, problem = load_or_quarantine(path)
                if problem is not None:
                    _health.record("cache_quarantined")
                    warnings.warn(
                        f"ignoring unusable tune cache: {problem}",
                        stacklevel=2,
                    )
            else:
                _DEFAULT = TuneCache()
            _DEFAULT_LOADED = True
        return _DEFAULT


def reset_default_cache() -> None:
    """Forget the lazily-loaded default (re-reads disk on next lookup)."""
    global _DEFAULT, _DEFAULT_LOADED
    with _LOCK:
        _DEFAULT = None
        _DEFAULT_LOADED = False


@contextlib.contextmanager
def use_cache(cache: TuneCache | str | None) -> Iterator[TuneCache | None]:
    """Scoped `set_active_cache` — the test/suite-facing surface."""
    global _ACTIVE
    if isinstance(cache, str):
        cache = TuneCache.load(cache)
    with _LOCK:
        prev = _ACTIVE
        _ACTIVE = cache
    try:
        yield cache
    finally:
        with _LOCK:
            _ACTIVE = prev


# ---------------------------------------------------------------- lookups
def _count(entry, key: str) -> None:
    # Hit / miss ledger: a run that promises every GEMM resolves in-cache
    # checks tuned_misses == 0.  Split-K hits are counted apart, so a
    # decode run can show its GEMV classes are active, not just covered.
    hit = entry is not None
    gemv = hit and entry.schedule == "splitk"
    _health.record("tuned_hits" if hit else "tuned_misses")
    if gemv:
        _health.record("tuned_hits_gemv")
    if _obs.tracing():
        _obs.event("tune", key, hit=hit, gemv=gemv,
                   schedule=None if entry is None else entry.schedule)
        _obs.annotate("dispatch", tune_key=key, tune_hit=hit)


def lookup_dense(
    m: int,
    k: int,
    n: int,
    *,
    batch: int = 1,
    dtype_bytes: int,
    amp: float,
    chip: hw.ChipSpec,
) -> BlockPlan | None:
    cls = ShapeClass.of(m, k, n, batch)
    key = dense_key(chip.name, dtype_bytes, amp, cls)
    entry = get_active_cache().get(key)
    _count(entry, key)
    # cache_corrupt injection point: an armed fault scope can replace the
    # result (hit or miss — a corrupt cache fabricates entries too) with
    # the sentinel plan the planners reject.
    return _faults.maybe_corrupt_lookup(
        None if entry is None else entry.plan, "lookup_dense")


def lookup_sparse(
    summary: LayoutSummary,
    n: int,
    *,
    dtype_bytes: int,
    amp: float,
    chip: hw.ChipSpec,
) -> BlockPlan | None:
    key = sparse_key(chip.name, dtype_bytes, amp, summary, n)
    entry = get_active_cache().get(key)
    _count(entry, key)
    return _faults.maybe_corrupt_lookup(
        None if entry is None else entry.plan, "lookup_sparse")


def lookup_grouped(
    groups: int,
    m: int,
    k: int,
    n: int,
    *,
    dtype_bytes: int,
    amp: float,
    chip: hw.ChipSpec,
) -> BlockPlan | None:
    cls = ShapeClass.of(m, k, n)
    key = grouped_key(chip.name, dtype_bytes, amp, groups, cls)
    entry = get_active_cache().get(key)
    _count(entry, key)
    return _faults.maybe_corrupt_lookup(
        None if entry is None else entry.plan, "lookup_grouped")
