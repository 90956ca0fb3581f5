"""BenchSuite — registry + runner that turns bench functions into records.

A suite function has the signature ``fn(rec, ctx)``: it calls ``rec(...)``
once per benchmark row instead of printing.  The `Recorder` builds a
`BenchResult` with provenance captured from the *active* `mm_config`
resolution (so a suite sweeping chips under ``with mm_config(chip=...)``
records per-chip provenance for free), appends it to the run's record
list, and echoes the legacy CSV row so the print-as-you-go surface
survives unchanged.

`RunContext` carries the run-wide knobs: ``tiny`` (reduced measured
sizes; modeled sweeps stay at full size, since planning is pure
arithmetic), the chip axis (default: the port's `gpu_h100`), and the
timing iteration counts derived from fidelity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable

from repro_torch.bench.record import BenchResult, Provenance
from repro_torch.bench.timing import Timing


@dataclasses.dataclass(frozen=True)
class RunContext:
    """Run-wide benchmark settings."""

    tiny: bool = False
    chips: tuple[str, ...] = ("gpu_h100",)

    @property
    def fidelity(self) -> str:
        return "tiny" if self.tiny else "full"

    @property
    def iters(self) -> int:
        return 1 if self.tiny else 3

    @property
    def repeats(self) -> int:
        return 3 if self.tiny else 5


class Recorder:
    """Per-suite record factory handed to suite functions as ``rec``."""

    def __init__(
        self,
        suite: str,
        sink: list[BenchResult],
        echo: Callable[[str], None] | None = None,
    ):
        self.suite = suite
        self._sink = sink
        self._echo = echo

    def __call__(
        self,
        name: str,
        *,
        axes: dict[str, Any] | None = None,
        metrics: dict[str, float] | None = None,
        info: dict[str, str] | None = None,
        timing: Timing | None = None,
        plan: Any = None,
        config: Any = None,
    ) -> BenchResult:
        record = BenchResult(
            name=name,
            suite=self.suite,
            axes=dict(axes or {}),
            metrics={k: float(v) for k, v in (metrics or {}).items()},
            info=dict(info or {}),
            provenance=Provenance.capture(config=config, plan=plan),
            us_per_call=None if timing is None else timing.median_us,
            us_iqr=None if timing is None else timing.iqr_us,
            repeats=0 if timing is None else timing.repeats,
            outliers=0 if timing is None else timing.outliers,
        )
        self._sink.append(record)
        if self._echo is not None:
            self._echo(record.csv_row())
        return record


@dataclasses.dataclass(frozen=True)
class SuiteSpec:
    name: str
    fn: Callable[[Recorder, RunContext], None]
    doc: str = ""


class BenchSuite:
    """Named registry of suite functions with a single `run` entry point."""

    def __init__(self):
        self._suites: dict[str, SuiteSpec] = {}

    def register(self, name: str) -> Callable:
        def deco(fn: Callable[[Recorder, RunContext], None]) -> Callable:
            if name in self._suites:
                raise ValueError(f"suite {name!r} already registered")
            doc_lines = (fn.__doc__ or "").strip().splitlines()
            doc = doc_lines[0] if doc_lines else ""
            self._suites[name] = SuiteSpec(name=name, fn=fn, doc=doc)
            return fn

        return deco

    def names(self) -> list[str]:
        return list(self._suites)

    def select(self, only: str | None = None) -> list[SuiteSpec]:
        specs = list(self._suites.values())
        if only:
            # An exact suite name selects just that suite ("decode" must
            # not also run "decode_gemv"); anything else is a substring.
            if only in self._suites:
                return [self._suites[only]]
            specs = [s for s in specs if only in s.name]
        return specs

    def run(
        self,
        only: str | None = None,
        ctx: RunContext = RunContext(),
        echo: Callable[[str], None] | None = None,
    ) -> list[BenchResult]:
        """Run the selected suites, returning every record produced."""
        records: list[BenchResult] = []
        for spec in self.select(only):
            rec = Recorder(spec.name, records, echo=echo)
            spec.fn(rec, ctx)
        return records


def suites_of(records: Iterable[BenchResult]) -> set[str]:
    return {r.suite for r in records}
