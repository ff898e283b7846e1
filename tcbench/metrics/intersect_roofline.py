"""``intersect_roofline``: the CSR intersection kernels' share of their
bytes roofline.

The least time for the bytes that the window's jobs' intersections need
(:mod:`tcbench.roofline`'s model, per job, times the jobs) at the card's
published 3.35 TB/s, over the device time of the kernels whose names
hold ``PATTERN``.  Nothing to read where no such kernel ran.
"""
from tcbench.roofline import least_seconds
from tcbench.trace import union_seconds

PATTERN = "intersect"


def read(r):
    t = r.trace
    if t is None or not r.jobs or not r.intersect_bytes:
        return None
    kernels = [op for op in t.device if op.kind == "kernel" and PATTERN in op.name]
    busy = union_seconds(kernels)
    if busy <= 0:
        return None
    return 100.0 * least_seconds(r.intersect_bytes * len(r.jobs)) / busy
