"""Shape-class bucketing: the autotuner's problem-space partition.

Measured tuning cannot time every (m, k, n) the zoo issues, so shapes
are bucketed into *classes* and one representative per class is timed.
The bucketing must be a partition — every shape maps to exactly one
class, and a class representative maps back to its own class — or the
cache would answer lookups for shapes it never measured (or miss shapes
it did).  Both properties are tested over seeded sweeps in
``tests/test_torch_tune.py``.

The bucket rule is power-of-two flooring per dimension: a dimension `d`
belongs to the bucket ``[2^i, 2^(i+1))`` and its representative is
``2^i``.  That keeps every shape within 2x of its representative on each
axis — close enough that the (schedule, blocks) winner is stable across
the bucket (the planner's candidates are themselves power-of-two
aligned) — while collapsing the paper's continuous skew sweep onto ~30
classes per chip.
"""

from __future__ import annotations

import dataclasses


def bucket_dim(d: int) -> int:
    """Largest power of two <= d (d >= 1) — the bucket representative.

    Idempotent (``bucket_dim(bucket_dim(d)) == bucket_dim(d)``) and a
    partition of the positive integers: d belongs to exactly the bucket
    ``[bucket_dim(d), 2 * bucket_dim(d))``.
    """
    if d < 1:
        raise ValueError(f"dimension must be >= 1, got {d}")
    return 1 << (int(d).bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """The bucket a (batch, m, k, n) matmul problem belongs to.

    Fields are the representative dims (each a power of two), so a
    `ShapeClass` doubles as the shape the tuner actually measures.
    """

    m: int
    k: int
    n: int
    batch: int = 1

    @classmethod
    def of(cls, m: int, k: int, n: int, batch: int = 1) -> "ShapeClass":
        return cls(
            m=bucket_dim(m),
            k=bucket_dim(k),
            n=bucket_dim(n),
            batch=bucket_dim(batch),
        )

    def __post_init__(self):
        for name in ("m", "k", "n", "batch"):
            v = getattr(self, name)
            if v < 1 or bucket_dim(v) != v:
                raise ValueError(
                    f"ShapeClass.{name} must be a positive power of two "
                    f"(a bucket representative), got {v}; use ShapeClass.of()",
                )

    @property
    def dims(self) -> tuple[int, int, int]:
        return (self.m, self.k, self.n)

    @property
    def token(self) -> str:
        """Stable key fragment: ``m<M>k<K>n<N>b<B>``."""
        return f"m{self.m}k{self.k}n{self.n}b{self.batch}"

    @property
    def is_decode(self) -> bool:
        """Whether this class sits in the GEMV decode regime: a plain 2-D
        contraction with at most `GEMV_M_MAX` representative rows — the
        shapes where the planner lets the split-K family join the search."""
        return self.batch == 1 and self.m <= GEMV_M_MAX


# The decode m-tail: batch buckets a continuous-batching decode step
# actually issues (m = rows in flight).  These are *exact* classes —
# each is a power of two, so `bucket_dim` maps it to itself and the
# tuned-cache key for a decode step is the key tuned here (the partition
# property is unchanged).  m = 8 is the row-granule
# boundary: one fp32 sublane, the last class before dense row fill
# starts climbing.
GEMV_M_CLASSES = (1, 4, 8)
GEMV_M_MAX = 8


def decode_classes(k: int, n: int, *, ms: tuple[int, ...] = GEMV_M_CLASSES,
                   ) -> list[ShapeClass]:
    """The decode-shape GEMV classes for one (K, N) weight: m in `ms`
    (exact), K / N bucketed power-of-two.  This is the class list
    `tune_decode` measures and a continuous-batching scheduler resolves
    decode steps against."""
    return [ShapeClass.of(m, k, n) for m in ms]
