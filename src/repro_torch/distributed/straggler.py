"""Straggler detection: training-step timing and engine stripe skew.

A copy of ``repro.distributed.straggler`` (stdlib only).

On a real pod a straggling host shows up as a slow step for *everyone*
(collectives are synchronous).  :class:`StragglerMonitor` keeps a robust
running estimate (median + MAD over a sliding window) of step wall time
and flags anomalies; the train loop's hook decides what to do with a
flag — log-and-continue, checkpoint-now (before a suspected failing host
dies), or trigger an elastic re-mesh.

:func:`stripe_skew_report` is the triangle engine's counterpart for the
§III-E striped edge partition: because the distributed kernels are
synchronous collectives, a stripe with an outsized wedge load *is* the
straggler — wall time per launch is the max over stripes — so load skew
measured host-side from the plan equals the timing skew a profiler would
see.  The report surfaces in ``EngineStats`` after every distributed
call.  Both pieces are host-side and fully unit-testable without
hardware.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Callable, Sequence

__all__ = [
    "StragglerMonitor",
    "StripeSkewReport",
    "skew_disagreement_note",
    "stripe_skew_report",
]


class StragglerMonitor:
    def __init__(
        self,
        window: int = 50,
        threshold: float = 3.0,
        min_samples: int = 10,
        on_straggle: Callable[[int, float, float], None] | None = None,
    ):
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self.on_straggle = on_straggle
        self.times: collections.deque[float] = collections.deque(maxlen=window)
        self.flags: list[tuple[int, float]] = []
        self._t0: float | None = None
        self._step = 0

    def start_step(self) -> None:
        self._t0 = time.monotonic()

    def end_step(self) -> bool:
        """Record a step duration; returns True if the step straggled."""
        assert self._t0 is not None, "start_step() not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        """Pure observation API (used by tests with synthetic timings)."""
        self._step += 1
        straggled = False
        if len(self.times) >= self.min_samples:
            med = statistics.median(self.times)
            mad = statistics.median(abs(t - med) for t in self.times) or (0.05 * med)
            if dt > med + self.threshold * 1.4826 * mad and dt > 1.2 * med:
                straggled = True
                self.flags.append((self._step, dt))
                if self.on_straggle is not None:
                    self.on_straggle(self._step, dt, med)
        # straggler steps do not poison the baseline window
        if not straggled:
            self.times.append(dt)
        return straggled

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else float("nan")


@dataclasses.dataclass(frozen=True)
class StripeSkewReport:
    """Wedge-load imbalance across the §III-E edge stripes of one workload.

    ``skew`` is ``max_load / mean_load`` (1.0 = perfectly balanced; the
    launch wall time tracks the max, so skew is the slowdown factor vs a
    perfect partition).  ``straggler_stripe`` is the index of the stripe
    flagged by the same median+MAD rule :class:`StragglerMonitor` applies
    to step timings — ``None`` when no stripe is anomalous (round-robin
    striping keeps skew near 1 on most graphs).
    """

    n_stripes: int
    loads: tuple[int, ...]        # wedge slots per stripe
    mean_load: float
    max_load: int
    skew: float
    straggler_stripe: int | None


def stripe_skew_report(
    loads: Sequence[int], threshold: float = 3.0
) -> StripeSkewReport:
    """Build a :class:`StripeSkewReport` from per-stripe wedge loads."""
    loads = tuple(int(x) for x in loads)
    n = len(loads)
    if n == 0 or max(loads) == 0:
        return StripeSkewReport(n, loads, 0.0, 0, 1.0, None)
    mean = sum(loads) / n
    mx = max(loads)
    skew = mx / mean if mean > 0 else 1.0
    straggler = None
    if n >= 2:
        med = statistics.median(loads)
        mad = statistics.median(abs(x - med) for x in loads) or (0.05 * med)
        if mx > med + threshold * 1.4826 * mad and mx > 1.2 * med:
            straggler = loads.index(mx)
    return StripeSkewReport(n, loads, mean, mx, skew, straggler)


def skew_disagreement_note(
    load_report: StripeSkewReport, measured_report: StripeSkewReport
) -> "str | None":
    """Loud note when load-inferred and measured stragglers disagree.

    The engine's ``stripe_skew`` assumes wedge load is a faithful proxy
    for stripe time ("the collectives are synchronous, so load skew *is*
    timing skew").  Under tracing the per-stripe probe measures actual
    times, and this is the tripwire for the proxy breaking — e.g. one
    stripe's edges hitting a pathological search depth, or a device-side
    imbalance invisible to the planner.  Returns ``None`` when both
    reports agree (including both finding no straggler).
    """
    if load_report.straggler_stripe == measured_report.straggler_stripe:
        return None
    return (
        "stripe skew disagreement: wedge-load inference flags stripe "
        f"{load_report.straggler_stripe} (skew {load_report.skew:.2f}) but "
        f"measured stripe times flag stripe {measured_report.straggler_stripe} "
        f"(skew {measured_report.skew:.2f}); load is a proxy — trust the "
        "measured times"
    )
