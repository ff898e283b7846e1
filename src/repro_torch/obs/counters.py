"""Process-wide counters and gauges for the triangle engine.

Counters are monotonic event tallies (chunks launched, wedges planned,
`.tricsr` cache hits, capability fallbacks); gauges hold last-written
values (peak wedge buffer, stripe count).  Both are plain attribute
writes on ``__slots__`` objects — cheap enough to leave permanently on
in ``run_workload``'s hot path, unlike spans which gate on an active
tracer.

The registry is module-global and append-only within a process; tests
and the CLI exporters take :func:`snapshot` (a plain dict, ready for
JSON) and may :func:`reset` between measurements.  Stdlib-only.
"""
from __future__ import annotations

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "counter",
    "gauge",
    "registry",
    "reset",
    "snapshot",
]


class Counter:
    """Monotonic int tally."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, n: int = 1) -> None:
        self.value += int(n)


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, value) -> None:
        self.value = value


class MetricsRegistry:
    """Name → instrument map; instruments are created on first touch."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def snapshot(self) -> dict:
        """JSON-ready ``{"counters": {...}, "gauges": {...}}``."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()
