"""The program's phase ranges in a traced window, as shares of the window.

``repro_torch``'s ``obs.span`` opens a ``record_function`` range of its
name while ``torch.profiler`` records, so each phase of an engine call is
a host range of the trace (``Reading.trace.host``), on the clock of the
device's work.  A program that opens no such range reads nothing here,
not 0.
"""
from __future__ import annotations

from tcbench.trace import JOB_RANGE, union_seconds

__all__ = ["PHASES", "clipped", "phase_share", "unnamed_share"]

# every phase of an engine call that the program names
PHASES = ("engine.preprocess", "engine.resolve", "engine.workload", "engine.plan",
          "engine.launch", "engine.fold", "engine.degrees", "engine.lcc_finish")


def clipped(trace, keep) -> list[tuple[float, float]]:
    """``(start, end)`` of the host ranges whose names ``keep`` accepts, clipped
    to the window."""
    return [(max(r.start, 0.0), min(r.end, trace.window_s)) for r in trace.host
            if keep(r.name) and r.end > 0 and r.start < trace.window_s]


def phase_share(reading, *names: str) -> float | None:
    """The union of the ranges named ``names``, in % of the window; ``None``
    where the trace holds none of them."""
    t = reading.trace
    if t is None or t.window_s <= 0:
        return None
    ranges = clipped(t, lambda n: n in names)
    if not ranges:
        return None
    return 100.0 * union_seconds(ranges) / t.window_s


def unnamed_share(reading) -> float | None:
    """The time inside the jobs' ranges that no phase range covers, in % of
    the window; ``None`` where the trace holds no job or no phase range."""
    t = reading.trace
    if t is None or t.window_s <= 0:
        return None
    jobs = clipped(t, lambda n: n.startswith(JOB_RANGE))
    phases = clipped(t, lambda n: n in PHASES)
    if not jobs or not phases:
        return None
    # |jobs \ phases| = |jobs ∪ phases| - |phases|
    return 100.0 * (union_seconds(jobs + phases) - union_seconds(phases)) / t.window_s
