"""``device_idle_share``: the share of the traced window in which no
kernel, copy or memset ran on the card (1 - their union / the window)."""
from tcbench.trace import union_seconds


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - union_seconds(t.device) / t.window_s)
