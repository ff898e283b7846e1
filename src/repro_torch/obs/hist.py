"""Pow2-bucket latency histograms with rolling-window aggregation.

``serve_graph`` previously kept every latency sample in a list and
computed p50/p99 once at exit — unbounded memory on long streams and no
visibility until shutdown.  These histograms fix both: a
:class:`Pow2Histogram` is 64 integer buckets (bucket ``b`` holds
durations in ``[2^b, 2^(b+1))`` nanoseconds — the same pow2 bucketing
discipline the engine applies to wedge-buffer shapes), so memory is O(1)
per instrument, merging is element-wise addition, and percentiles come
from bucket interpolation with bounded relative error (a bucket spans a
factor of 2, so a percentile estimate is within 2× and in practice much
closer via linear interpolation inside the bucket).

:class:`RollingHistogram` composes intervals: observations land in the
current interval's histogram, :meth:`RollingHistogram.rotate` seals it
into a bounded deque, and window percentiles merge the last ``window``
intervals — "p99 over the last N reporting intervals", not "p99 since
process start".  Stdlib-only.
"""
from __future__ import annotations

import collections
import threading

__all__ = ["N_BUCKETS", "Pow2Histogram", "ConcurrentHistogram", "RollingHistogram"]

N_BUCKETS = 64  # 2^63 ns ≈ 292 years: every representable latency fits


def _bucket_of(ns: int) -> int:
    if ns <= 0:
        return 0
    return min(int(ns).bit_length() - 1, N_BUCKETS - 1)


class Pow2Histogram:
    """Fixed-size power-of-two latency histogram (nanosecond buckets)."""

    __slots__ = ("counts", "n", "total_ns")

    def __init__(self):
        self.counts = [0] * N_BUCKETS
        self.n = 0
        self.total_ns = 0

    def observe_ns(self, ns: int) -> None:
        self.counts[_bucket_of(ns)] += 1
        self.n += 1
        self.total_ns += int(ns)

    def observe(self, seconds: float) -> None:
        self.observe_ns(int(seconds * 1e9))

    def merge(self, other: "Pow2Histogram") -> "Pow2Histogram":
        for b in range(N_BUCKETS):
            self.counts[b] += other.counts[b]
        self.n += other.n
        self.total_ns += other.total_ns
        return self

    def mean_s(self) -> float:
        return (self.total_ns / self.n) / 1e9 if self.n else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile in **seconds** (bucket-interpolated)."""
        if self.n == 0:
            return 0.0
        if not 0.0 < q <= 100.0:
            raise ValueError(f"percentile must be in (0, 100], got {q}")
        # rank of the target sample (1-based), then linear interpolation
        # between the bucket's lower and upper bound
        target = max(1, -(-self.n * q // 100))  # ceil(n*q/100)
        cum = 0
        for b, c in enumerate(self.counts):
            if cum + c >= target:
                lo = float(1 << b) if b else 0.0
                hi = float(1 << (b + 1))
                frac = (target - cum) / c
                return (lo + (hi - lo) * frac) / 1e9
            cum += c
        return float(1 << N_BUCKETS) / 1e9  # unreachable with consistent n

    def percentiles(self, qs=(50.0, 90.0, 99.0)) -> dict:
        return {f"p{int(q)}": self.percentile(q) for q in qs}

    def snapshot_ms(self) -> dict:
        """JSON-ready summary in milliseconds."""
        pct = self.percentiles()
        return {
            "n": self.n,
            "mean_ms": self.mean_s() * 1e3,
            "p50_ms": pct["p50"] * 1e3,
            "p90_ms": pct["p90"] * 1e3,
            "p99_ms": pct["p99"] * 1e3,
        }


class ConcurrentHistogram(Pow2Histogram):
    """A :class:`Pow2Histogram` safe for concurrent observers.

    ``counts[b] += 1`` is a read-modify-write — many client threads
    observing into one shared histogram (the serve load generator's
    per-traffic-class instruments) would drop samples without the lock.
    Reads (:meth:`percentile`, :meth:`snapshot_ms`) stay lock-free: they
    run after the observers join, or tolerate a torn-in-flight view for
    progress reporting.
    """

    __slots__ = ("_lock",)

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()

    def observe_ns(self, ns: int) -> None:
        with self._lock:
            super().observe_ns(ns)

    def merge(self, other: "Pow2Histogram") -> "Pow2Histogram":
        with self._lock:
            return super().merge(other)


class RollingHistogram:
    """A bounded window of per-interval :class:`Pow2Histogram` instances."""

    __slots__ = ("window", "intervals", "lifetime")

    def __init__(self, window: int = 8):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self.intervals: collections.deque = collections.deque(
            [Pow2Histogram()], maxlen=window
        )
        self.lifetime = Pow2Histogram()

    @property
    def current(self) -> Pow2Histogram:
        return self.intervals[-1]

    def observe(self, seconds: float) -> None:
        ns = int(seconds * 1e9)
        self.intervals[-1].observe_ns(ns)
        self.lifetime.observe_ns(ns)

    def rotate(self) -> Pow2Histogram:
        """Seal the current interval and start a fresh one; returns sealed."""
        sealed = self.intervals[-1]
        self.intervals.append(Pow2Histogram())
        return sealed

    def windowed(self) -> Pow2Histogram:
        """Merged histogram over the retained window (incl. current)."""
        merged = Pow2Histogram()
        for h in self.intervals:
            merged.merge(h)
        return merged
