"""Request queue + admission policy on a deterministic simulated clock.

Nothing here touches wall-clock time: ticks are integers advanced by the
scheduler, arrivals are scripted, and FIFO order breaks ties by request
id — so a trace replays *exactly*, which is what lets the tests assert
bit-identical logits and the bench suites commit integer baselines.
"""

from __future__ import annotations

import dataclasses
from collections import deque


class Clock:
    """Simulated monotonic tick counter (one tick = one scheduler step)."""

    def __init__(self, start: int = 0):
        self._now = int(start)

    @property
    def now(self) -> int:
        return self._now

    def advance(self, ticks: int = 1) -> int:
        if ticks < 0:
            raise ValueError("clock cannot run backwards")
        self._now += ticks
        return self._now


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.

    `tokens` is the prompt (host-side ints, immutable); `max_new` the
    decode budget; `arrival` the tick the request becomes visible to the
    scheduler.  Requests are value objects — all mutable progress lives
    in the scheduler's per-slot state.
    """

    rid: int
    tokens: tuple[int, ...]
    max_new: int
    arrival: int = 0

    def __post_init__(self):
        if not self.tokens:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new < 1:
            raise ValueError(f"request {self.rid}: max_new must be >= 1")
        if self.arrival < 0:
            raise ValueError(f"request {self.rid}: negative arrival tick")

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Admission bounds (the saxml `max_live_batches` shape of control).

    `max_live` caps concurrently-live requests (KV slab rows);
    `max_admit_per_tick` caps how many prefills one tick may launch, so a
    burst cannot starve decode of the live batch.
    """

    max_live: int = 16
    max_admit_per_tick: int = 16

    def __post_init__(self):
        if self.max_live < 1 or self.max_admit_per_tick < 1:
            raise ValueError("admission bounds must be >= 1")

    def admit_budget(self, n_live: int) -> int:
        """How many new requests may join given `n_live` already live."""
        return max(0, min(self.max_live - n_live, self.max_admit_per_tick))


class RequestQueue:
    """FIFO of pending requests, gated on arrival tick.

    `pop_ready(now, limit)` returns at most `limit` requests whose
    arrival tick has passed, in (arrival, rid) order; everything else
    stays queued.  Deterministic by construction.
    """

    def __init__(self):
        self._pending: deque[Request] = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, req: Request) -> None:
        self._pending.append(req)
        # keep (arrival, rid) order even if callers submit out of order
        self._pending = deque(
            sorted(self._pending, key=lambda r: (r.arrival, r.rid))
        )

    def ready(self, now: int) -> int:
        return sum(1 for r in self._pending if r.arrival <= now)

    def pop_ready(self, now: int, limit: int) -> list[Request]:
        out: list[Request] = []
        keep: deque[Request] = deque()
        for req in self._pending:
            if req.arrival <= now and len(out) < limit:
                out.append(req)
            else:
                keep.append(req)
        self._pending = keep
        return out
