"""repro_torch.tune — measured autotuning on top of the modeled planners.

Which (schedule, blocks) plan wins depends on the real card, and the cost
model's constants are educated guesses.  This subsystem closes the loop,
as the JAX package's does:

* `repro_torch.tune.shapeclass` — the problem-space partition
  (power-of-two bucketing); one measured representative answers a class.
* `repro_torch.tune.tuner`     — times the modeled top-K candidates of the
  dense / block-sparse / grouped planners through an injectable
  `Measurer` (CUDA-event timing on the card, or the deterministic modeled
  measurer).
* `repro_torch.tune.cache`     — the versioned JSON cache of winners
  (`TuneCache` / `TuneEntry`), the JAX package's schema and keys.
* `repro_torch.tune.runtime`   — the active cache ``plan_mode="tuned"``
  reads (`use_cache` / `set_active_cache`, the default location
  ``build/tune/tune_cache.json`` or ``$REPRO_TORCH_TUNE_CACHE``).
* `repro_torch.tune.calibrate` — per-chip correction factors fitted from
  the measured / modeled ratios.

Entry points: ``with mm_config(plan_mode="tuned"): ...`` makes every
planned matmul consult the cache (modeled fallback on a miss), and
``python -m repro_torch.launch.tune`` fills it.
"""

from repro_torch.tune.cache import (TUNE_SCHEMA_VERSION, TuneCache,
                                    TuneEntry, dense_key, grouped_key,
                                    sparse_key)
from repro_torch.tune.calibrate import (Corrections, apply_corrections,
                                        correction_factor, fit_corrections,
                                        fit_gather_frac, unit_clamp)
from repro_torch.tune.runtime import (default_cache_path, get_active_cache,
                                      set_active_cache, use_cache)
from repro_torch.tune.shapeclass import ShapeClass, bucket_dim
from repro_torch.tune.tuner import (modeled_measurer, remodel, tune_decode,
                                    tune_dense, tune_grouped, tune_sparse,
                                    wallclock_measurer)

__all__ = [
    "TUNE_SCHEMA_VERSION", "TuneCache", "TuneEntry", "dense_key",
    "grouped_key", "sparse_key", "Corrections", "apply_corrections",
    "correction_factor", "fit_corrections", "fit_gather_frac", "unit_clamp",
    "default_cache_path", "get_active_cache", "set_active_cache",
    "use_cache", "ShapeClass", "bucket_dim", "modeled_measurer", "remodel",
    "tune_decode", "tune_dense", "tune_grouped", "tune_sparse",
    "wallclock_measurer",
]
