"""Host records once per stage unit, as under the JAX package's `lax.scan`.

The JAX LM runs each stage's repeated units as one `jax.lax.scan` whose
body is traced once per call: the planner's log (`plan_capture`), the
tune-cache ledger (`tuned_*` counters), the `obs` spans and events and the
MoE capacity-slot counts (`moe_slots_*`) are recorded once per stage site
and call, and the repeats run the plans traced for the first.  The port
runs a Python loop over the layers; the engine wraps each repeat in
``repeat(r)``, and inside a repeat r > 0 those host records are not made
again.  Planning still runs (it is deterministic, so every repeat gets the
plan of the first), and kernel launches, their counts and fault injection
stay per layer: they are the work itself.  So a port run leaves the plan
log, the health ledger and the span tree of the same JAX run.  `quiet()`
turns the same records off for a whole call (a decode graph's warm-up).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

_TLS = threading.local()


def recording() -> bool:
    """False inside a repeat r > 0 of a stage: host records are skipped."""
    return not getattr(_TLS, "quiet", False)


@contextlib.contextmanager
def quiet() -> Iterator[None]:
    """No host records inside the block (planning and launches run)."""
    if not recording():
        yield
        return
    from repro_torch.obs import spans

    _TLS.quiet = True
    try:
        with spans.suspended():
            yield
    finally:
        _TLS.quiet = False


@contextlib.contextmanager
def repeat(r: int) -> Iterator[None]:
    """The extent of repeat `r` of a stage's unit."""
    if r == 0:
        yield
        return
    with quiet():
        yield
