"""Readings of the host around a run and each of its jobs.

The jobs are paced by the host (the program's plan is host numpy), so the
run's earlier line carries what could make their times swing: the CPUs
the process may use and the threads its libraries start; for each job the
process's CPU seconds, all threads together, beside its wall time; and
after the window the host's pace on a fixed task, so that runs and
machines can be compared.  Nothing here imports the program.
"""
from __future__ import annotations

import os
import statistics
import time

import numpy as np

__all__ = ["host_state", "host_pace_s", "JobClock"]

_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def host_state() -> dict:
    """The CPUs and threads a run finds."""
    import torch

    return {"cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(),
            "env": {k: os.environ.get(k) for k in _ENV}}


def host_pace_s(reps: int = 5) -> float:
    """Median seconds to sort 2**21 fixed int64 keys in numpy, one core:
    the host's pace on host numpy work like the program's plan."""
    keys = np.random.default_rng(0).integers(0, 1 << 40, 1 << 21)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.sort(keys)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


class JobClock:
    """The process's CPU seconds over each job: ``start()`` before the job,
    ``stop()`` after it, which appends them to ``cpu_s``."""

    def __init__(self):
        self.cpu_s: list[float] = []
        self._t0 = 0.0

    def start(self) -> None:
        self._t0 = time.process_time()

    def stop(self) -> None:
        self.cpu_s.append(time.process_time() - self._t0)
