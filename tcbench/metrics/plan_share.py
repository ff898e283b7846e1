"""``plan_share``: the engine's host plan as a share of the window.

The sum of ``last_stats.timings["plan"]`` (a host clock around
``PanelBackend.plan``, host numpy) over the window's jobs, over the
window's seconds on the host clock.
"""


def read(r):
    if not r.jobs or r.window_s <= 0:
        return None
    plans = [j.timings.get("plan") for j in r.jobs if j.timings]
    if len(plans) != len(r.jobs) or any(p is None for p in plans):
        return None
    return 100.0 * sum(plans) / r.window_s
