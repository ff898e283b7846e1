"""The device trace of a measured window, reduced to intervals and a breakdown.

:func:`from_events` takes plain event tuples ``(name, activity, on_device,
start_ns, end_ns, thread)``; :func:`kineto_events` makes them from a
``torch.profiler`` run.  Times become seconds from the start of the
benchmark's window range, and device intervals are clipped to the window.
The trace stays in memory; nothing is written.
"""
from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

__all__ = ["WINDOW_RANGE", "JOB_RANGE", "DeviceOp", "HostRange", "Trace", "kineto_events",
           "from_events", "union_seconds", "idle_gaps", "host_segments",
           "idle_by_host", "breakdown"]

WINDOW_RANGE = "tcbench.window"
JOB_RANGE = "tcbench.job."  # followed by the job kind

_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


class DeviceOp(NamedTuple):
    kind: str     # kernel, memcpy or memset
    name: str
    start: float  # seconds from the window's start, clipped to the window
    end: float


class HostRange(NamedTuple):
    name: str
    start: float
    end: float


class Trace(NamedTuple):
    window_s: float
    device: list  # DeviceOp, sorted by start
    host: list    # HostRange on the window's thread, sorted by start


def kineto_events(prof) -> list[tuple]:
    """Event tuples of a finished ``torch.profiler.profile``.  Where this
    torch's events carry no activity type, a device event named like one
    of the host's annotations is its mirror on the device, and is marked so."""
    events = prof.profiler.kineto_results.events()
    out = []
    for ev in events:
        on_device = "CPU" not in str(ev.device_type())
        if hasattr(ev, "activity_type"):
            activity = str(ev.activity_type())
        elif hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
            activity = "gpu_user_annotation" if on_device else "user_annotation"
        else:
            activity = ""
        out.append([ev.name(), activity, on_device, int(ev.start_ns()),
                    int(ev.start_ns()) + int(ev.duration_ns()), int(ev.start_thread_id())])
    annotations = {e[0] for e in out if not e[2] and e[1] == "user_annotation"}
    for e in out:
        if e[2] and not e[1] and e[0] in annotations:
            e[1] = "gpu_user_annotation"
    return [tuple(e) for e in out]


def _device_kind(name: str, activity: str) -> str | None:
    """kernel, memcpy or memset; ``None`` for a device event that is no work
    (an annotation's mirror).  Without an activity type, by the name."""
    if activity:
        return _DEVICE_KINDS.get(activity)
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def from_events(events) -> Trace | None:
    """The window's trace, or ``None`` when no window range was recorded."""
    windows = [e for e in events if e[0] == WINDOW_RANGE and not e[2]]
    if not windows:
        return None
    _, _, _, w0, w1, thread = windows[0]
    window_s = (w1 - w0) / 1e9
    device, host = [], []
    for name, activity, on_device, t0, t1, tid in events:
        s, e = (t0 - w0) / 1e9, (t1 - w0) / 1e9
        if on_device:
            kind = _device_kind(name, activity)
            if kind is None or e <= 0 or s >= window_s:
                continue
            device.append(DeviceOp(kind, name, max(s, 0.0), min(e, window_s)))
        elif tid == thread and name != WINDOW_RANGE and e > 0 and s < window_s:
            host.append(HostRange(name, s, e))
    device.sort(key=lambda op: op.start)
    host.sort(key=lambda r: (r.start, -r.end))
    return Trace(window_s, device, host)


def union_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((iv[-2], iv[-1]) for iv in intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """The stretches of the window in which no device operation ran."""
    gaps, t = [], 0.0
    for op in trace.device:
        if op.start > t:
            gaps.append((t, op.start))
        t = max(t, op.end)
    if t < trace.window_s:
        gaps.append((t, trace.window_s))
    return gaps


def _label(stack: list) -> str:
    """What the host was doing: the innermost open range, where a range of
    the benchmark's own (a job) with no torch operation open inside it
    means host Python or numpy."""
    if not stack:
        return "outside any job"
    name = stack[-1].name
    if name.startswith(JOB_RANGE):
        return f"{name}: host Python or numpy"
    return name


def host_segments(trace: Trace) -> list[tuple[float, float, str]]:
    """The window cut into ``(start, end, label)`` pieces, each labelled by
    the innermost host range open through it.  Ranges on one thread nest,
    so one sweep with a stack of open ranges finds it."""
    segs, stack, t = [], [], 0.0

    def close_until(limit):
        nonlocal t
        while stack and stack[-1].end <= limit:
            top = stack.pop()
            if top.end > t:
                segs.append((t, top.end, _label(stack + [top])))
                t = top.end

    for r in trace.host:
        close_until(r.start)
        if r.start > t:
            segs.append((t, r.start, _label(stack)))
            t = r.start
        stack.append(r)
    close_until(trace.window_s)
    if stack and trace.window_s > t:
        segs.append((t, trace.window_s, _label(stack)))
        t = trace.window_s
    if trace.window_s > t:
        segs.append((t, trace.window_s, _label([])))
    return segs


def idle_by_host(trace: Trace) -> dict:
    """Idle seconds of the device by what the host was doing meanwhile."""
    idle: dict = defaultdict(float)
    segs = host_segments(trace)
    j = 0
    for g0, g1 in idle_gaps(trace):
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, label = segs[k]
            overlap = min(s1, g1) - max(s0, g0)
            if overlap > 0:
                idle[label] += overlap
            k += 1
    return idle


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each as ``[name, seconds]``, longest first."""
    ops: dict = defaultdict(float)
    for op in trace.device:
        ops[op.name] += op.end - op.start
    idle = idle_by_host(trace)
    def ranked(d):
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
