"""A closed loop: one client starts its next job when the last has ended.

The window starts when the first job starts, and ends when the last job
that started before ``seconds`` had elapsed has finished, so only whole
jobs count.  A job that raises ends the window: its answer never comes.
"""
from __future__ import annotations

import time
import traceback

from tcbench.reading import Job


def drive(call, seconds: float):
    """``(jobs, failed, window_s)``; ``call()`` returns one job's ``(answer,
    timings)``."""
    jobs, failed = [], 0
    t0 = time.perf_counter()
    end = t0
    while time.perf_counter() - t0 < seconds:
        start = time.perf_counter()
        try:
            answer, timings = call()
        except Exception:  # the job's answer never comes: record it and stop
            traceback.print_exc()
            failed += 1
            end = time.perf_counter()
            break
        end = time.perf_counter()
        jobs.append(Job(start - t0, end - t0, answer, timings))
    return jobs, failed, end - t0
