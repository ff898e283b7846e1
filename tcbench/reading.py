"""What a run hands each metric's reader."""
from __future__ import annotations

import dataclasses

from .trace import Trace

__all__ = ["Job", "Reading"]


@dataclasses.dataclass
class Job:
    """One job of the window, as the loop recorded it."""

    start: float          # seconds from the window's start
    end: float
    answer: object        # what the job returned on the host
    timings: dict         # the engine's last_stats.timings


@dataclasses.dataclass
class Reading:
    """A finished run: its set-up, its window, its jobs and its trace."""

    setup_s: float
    window_s: float              # host clock, first job's start to last job's end
    jobs: list                   # Job, completed in the window
    n_vertices: int              # |V| of the graph each job processed
    n_edges: int                 # |E|
    trace: Trace | None = None   # with --trace 1
    intersect_bytes: int | None = None  # the bytes model, per job
