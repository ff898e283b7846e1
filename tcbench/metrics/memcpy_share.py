"""``memcpy_share``: host-device copies as a share of the window.

The union of the device intervals of every HtoD and DtoH copy in the
traced window (torch.profiler, CUDA activity), over the window's length.
"""
from tcbench.trace import union_seconds

DIRECTIONS = ("HtoD", "DtoH")


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    copies = [op for op in t.device
              if op.kind == "memcpy" and any(d in op.name for d in DIRECTIONS)]
    if not copies:
        return None
    return 100.0 * union_seconds(copies) / t.window_s
