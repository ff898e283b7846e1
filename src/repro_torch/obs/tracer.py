"""Hierarchical span tracer for the triangle engine.

The paper's claims are *timings* (§V: 8–15× over CPU, 3.8B triangles in
under 10 s), so the repo needs a way to attribute a run's wall clock to
its phases.  This module is the core of that layer: a context-manager
span API producing nested, exportable timing events.

Three design constraints shape everything here:

* **Near-zero cost when disabled.**  Tracing is off by default; the hot
  path (``obs.span(...)`` in ``run_workload``'s chunk loop) must then
  cost one module-global read and allocate nothing.  ``span()`` returns
  the shared :data:`NOOP_SPAN` singleton when no tracer is active — the
  disabled path never constructs an object.
* **Spans measure device time, not async dispatch.**  CUDA launches
  return before the card finishes: wrapping a ``backend.count_chunk``
  call in a naive timer measures enqueue latency while the actual compute
  lands in whichever later operation blocks (usually the host fold).  A
  span wrapping device work must therefore call :meth:`Span.sync` (which
  is ``torch.cuda.synchronize()`` under an active tracer when the value
  holds a CUDA tensor, and the identity otherwise) before it closes.
* **Import-time stdlib-only.**  ``torch`` is imported lazily inside
  ``sync`` so the exporters and validators run in torch-free contexts.

Events are recorded as plain dicts (``name``/``cat``/``ts_ns``/
``dur_ns``/``depth``/``args``) relative to the tracer's origin, ready
for the Chrome trace-event / JSONL exporters in :mod:`repro_torch.obs.export`.
PyTorch runs eagerly and mints no jit traces, so ``Tracer.jit_traces``
stays empty; the slot is kept so exported traces keep the reference's
schema.
"""
from __future__ import annotations

import contextlib
import time

__all__ = [
    "NOOP_SPAN",
    "Span",
    "Tracer",
    "active",
    "enabled",
    "span",
    "start_tracing",
    "stop_tracing",
    "sync",
    "tracing",
]


class Span:
    """One live span of an active :class:`Tracer` (context manager).

    Records an event on ``__exit__`` even when the body raises (the
    event then carries an ``error`` key) — a crash mid-phase still
    leaves a closed, exportable span.  Call :meth:`sync` on any value
    backed by device computation before the span closes, so the span
    measures compute rather than async dispatch.
    """

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = dict(args) if args else None
        self._t0 = 0
        self._depth = 0

    def __enter__(self) -> "Span":
        t = self._tracer
        self._depth = t._depth
        t._depth += 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        t = self._tracer
        t._depth = self._depth
        event = {
            "name": self.name,
            "cat": self.cat,
            "ts_ns": self._t0 - t._origin_ns,
            "dur_ns": t1 - self._t0,
            "depth": self._depth,
        }
        if self.args:
            event["args"] = self.args
        if exc_type is not None:
            event["error"] = exc_type.__name__
        t.events.append(event)
        return False

    def sync(self, value):
        """Wait for the card when ``value`` holds a CUDA tensor.

        Ensures the span's close time covers the device work that
        produced ``value`` instead of just its dispatch.
        """
        return _block_until_ready(value)

    def set(self, **kwargs) -> "Span":
        """Attach/overwrite args on the span (shows up in exports)."""
        if self.args is None:
            self.args = {}
        self.args.update(kwargs)
        return self


class _NoopSpan:
    """The disabled-mode span: every operation is free and allocation-less.

    A single module-level instance (:data:`NOOP_SPAN`) is shared by all
    disabled ``span()`` calls — tests assert the identity to pin the
    no-allocation guarantee.
    """

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def sync(self, value):
        return value

    def set(self, **kwargs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


def _holds_cuda(value) -> bool:
    """Does ``value`` (a tensor or a tuple/list/dict of them) live on CUDA?"""
    if isinstance(value, (tuple, list)):
        return any(_holds_cuda(v) for v in value)
    if isinstance(value, dict):
        return any(_holds_cuda(v) for v in value.values())
    return getattr(value, "is_cuda", False) is True


def _block_until_ready(value):
    """``torch.cuda.synchronize()`` iff ``value`` holds a CUDA tensor."""
    if _holds_cuda(value):
        import torch

        torch.cuda.synchronize()
    return value


class Tracer:
    """Collects span events for one traced region.

    Not thread-safe — the engine is single-threaded host-side, and a
    tracer's span stack is per-process state exactly like the engine's
    ``last_stats``.
    """

    def __init__(self):
        self.events: list[dict] = []
        self.meta: dict = {}
        self.jit_traces: dict[str, int] = {}
        self._origin_ns = time.perf_counter_ns()
        self._depth = 0

    def span(self, name: str, cat: str = "", args=None) -> Span:
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", args=None) -> None:
        """Record a zero-duration marker event."""
        event = {
            "name": name,
            "cat": cat,
            "ts_ns": time.perf_counter_ns() - self._origin_ns,
            "dur_ns": 0,
            "depth": self._depth,
        }
        if args:
            event["args"] = dict(args)
        self.events.append(event)

    def wall_s(self) -> float:
        """Seconds from the tracer's origin to now (or to the last event)."""
        return (time.perf_counter_ns() - self._origin_ns) / 1e9

    # -- lifecycle (driven by start_tracing/stop_tracing) -------------------

    def _start(self) -> None:
        self._origin_ns = time.perf_counter_ns()


# -- module-level switchboard ------------------------------------------------
#
# One active tracer per process, mirroring how the engine's stats and
# fallback warnings are process-global.  The disabled fast path is a
# single global read.

_ACTIVE: Tracer | None = None


def active() -> Tracer | None:
    """The active tracer, or None when tracing is disabled."""
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def span(name: str, cat: str = "", args=None):
    """A span on the active tracer, or :data:`NOOP_SPAN` when disabled."""
    t = _ACTIVE
    if t is None:
        return NOOP_SPAN
    return t.span(name, cat, args)


def sync(value):
    """Block on ``value`` iff tracing is active (free otherwise)."""
    if _ACTIVE is None:
        return value
    return _block_until_ready(value)


def start_tracing(tracer: Tracer | None = None) -> Tracer:
    """Install (and start) the process-wide tracer.

    Nested tracing is rejected loudly: two tracers would silently split
    the event stream, and every caller here owns a whole CLI run.
    """
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("tracing is already active; stop_tracing() first")
    t = tracer if tracer is not None else Tracer()
    t._start()
    _ACTIVE = t
    return t


def stop_tracing() -> Tracer | None:
    """Uninstall the active tracer."""
    global _ACTIVE
    t, _ACTIVE = _ACTIVE, None
    return t


@contextlib.contextmanager
def tracing(tracer: Tracer | None = None):
    """``with obs.tracing() as t:`` — scoped start/stop."""
    t = start_tracing(tracer)
    try:
        yield t
    finally:
        stop_tracing()
