"""Hierarchical span tracer for the triangle engine.

The paper's claims are *timings* (§V: 8–15× over CPU, 3.8B triangles in
under 10 s), so the repo needs a way to attribute a run's wall clock to
its phases.  This module is the core of that layer: a context-manager
span API producing nested, exportable timing events.

Four design constraints shape everything here:

* **Near-zero cost when disabled.**  Tracing is off by default; the hot
  path (``obs.span(...)`` around each engine phase) must then cost one
  module-global read and one check that ``torch.profiler`` is not
  recording, and allocate nothing.  ``span()`` returns the shared
  :data:`NOOP_SPAN` singleton then — the disabled path never constructs
  an object.
* **Spans reach the profiler's clock.**  While ``torch.profiler`` records,
  every span also opens a ``record_function`` range of its name and closes
  it with the span, with or without an active :class:`Tracer`.  Kineto
  records those ranges on the clock and thread of the CUDA activities, so
  a profiled run names each phase beside the device's work.  A range
  never waits for the device: the profiler alone does not change the
  schedule.
* **Spans measure device time, not async dispatch.**  CUDA launches
  return before the card finishes: a naive timer around a launch measures
  enqueue latency while the compute lands in whichever later operation
  blocks (usually the host fold).  Under an active tracer a span over
  device work either waits before it closes (:meth:`Span.sync`:
  ``torch.cuda.synchronize()`` when the value holds a CUDA tensor, the
  identity otherwise), or brackets the work in a CUDA event pair
  (:meth:`Span.device_time`) whose elapsed ``device_ms`` the tracer writes
  into the span's args (:meth:`Tracer.settle`) once the caller has waited
  for the device anyway.  The engine's chunk spans take the event route,
  so chunks stay unserialised.
* **Import-time stdlib-only.**  ``torch`` is looked up in ``sys.modules``
  (the profiler check and its ranges: a process that never imported torch
  has no profiler running) or imported lazily (``sync``, the event pairs,
  the launch auditor inside ``start_tracing``), so the exporters and
  validators run in torch-free contexts.

Events are recorded as plain dicts (``name``/``cat``/``ts_ns``/
``dur_ns``/``depth``/``args``) relative to the tracer's origin, ready
for the Chrome trace-event / JSONL exporters in :mod:`repro_torch.obs.export`.

``Tracer.jit_traces`` keeps the reference's name and schema.  PyTorch runs
eagerly and mints no jit traces; in the port the field counts, per kernel
entry point, the *launch signatures* (input shapes and dtypes plus static
configuration) first seen while the tracer was active, as
:class:`repro_torch.check.runtime.CompileAuditor` reads them — the number
of distinct shapes the reference would have traced.  Kernels with none
are left out.  A tracer started with ``audit_compiles=False`` leaves it
empty.  Unlike the reference, a failure of the auditor is not swallowed.
"""
from __future__ import annotations

import contextlib
import sys
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
    "tracing",
]


def _profiling() -> bool:
    """Is ``torch.profiler`` recording on this thread?"""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def _open_range(name: str):
    """An entered ``record_function(name)`` while the profiler records, else None."""
    if not _profiling():
        return None
    rf = sys.modules["torch"].autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class Span:
    """One live span of an active :class:`Tracer` (context manager).

    Records an event on ``__exit__`` even when the body raises (the
    event then carries an ``error`` key) — a crash mid-phase still
    leaves a closed, exportable span.  Call :meth:`sync` on any value
    backed by device computation before the span closes, or bracket the
    work in :meth:`device_time`, so the span measures compute rather than
    async dispatch.
    """

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_depth", "_range", "_marks")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = dict(args) if args else None
        self._t0 = 0
        self._depth = 0
        self._range = None
        self._marks = None

    def __enter__(self) -> "Span":
        t = self._tracer
        self._depth = t._depth
        t._depth += 1
        self._range = _open_range(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
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
        if self._marks is not None:
            t._pending.append((event, *self._marks))
        return False

    def sync(self, value):
        """Wait for the card when ``value`` holds a CUDA tensor.

        Ensures the span's close time covers the device work that
        produced ``value`` instead of just its dispatch.
        """
        return _block_until_ready(value)

    @contextlib.contextmanager
    def device_time(self, device):
        """Bracket the body's device work in a CUDA event pair, without a wait.

        The pair is recorded on ``device``'s current stream before and
        after the body; :meth:`Tracer.settle`, called once the caller has
        waited for that stream, writes the milliseconds between them into
        the span's args as ``device_ms``.  That is stream time between the
        two markers: the body's device work plus any time the stream sat
        idle between them (waiting on the host's next enqueue), so an
        upper bound of the body's device time.  On a device that is not
        CUDA nothing is recorded and the span has no ``device_ms``.
        """
        if getattr(device, "type", None) != "cuda":
            yield
            return
        import torch

        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        self._marks = (start, end)

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


class _RangeSpan(_NoopSpan):
    """A span with no tracer while ``torch.profiler`` records: one
    ``record_function`` range of its name, nothing else (no event, no
    wait)."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = sys.modules["torch"].autograd.profiler.record_function(name)

    def __enter__(self) -> "_RangeSpan":
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._range.__exit__(exc_type, exc, tb)
        return False


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

    def __init__(self, *, audit_compiles: bool = True):
        self.events: list[dict] = []
        self.meta: dict = {}
        self.jit_traces: dict[str, int] = {}
        self._origin_ns = time.perf_counter_ns()
        self._depth = 0
        self._pending: list[tuple] = []  # (event, start, end) of Span.device_time
        self._audit_compiles = audit_compiles
        self._auditor = None

    def span(self, name: str, cat: str = "", args=None) -> Span:
        return Span(self, name, cat, args)

    def settle(self) -> None:
        """Write ``device_ms`` into every span whose event pair is pending.

        Call after a wait on the streams the pairs lie on (the engine
        calls it after its fold): each end event is then complete, and
        waiting on it returns at once.
        """
        pending, self._pending = self._pending, []
        for event, start, end in pending:
            end.synchronize()
            event.setdefault("args", {})["device_ms"] = start.elapsed_time(end)

    # -- lifecycle (driven by start_tracing/stop_tracing) -------------------

    def _start(self) -> None:
        if self._audit_compiles:
            from repro_torch.check.runtime import CompileAuditor

            self._auditor = CompileAuditor().__enter__()
        # re-anchor after the auditor's (possibly first) import, so the
        # first span doesn't inherit the import cost as leading dead time
        self._origin_ns = time.perf_counter_ns()

    def _finish(self) -> None:
        self.settle()
        if self._auditor is None:
            return
        auditor, self._auditor = self._auditor, None
        auditor.__exit__(None, None, None)
        self.jit_traces = {k: v for k, v in auditor.new_traces.items() if v}


# -- module-level switchboard ------------------------------------------------
#
# One active tracer per process, mirroring how the engine's stats and
# fallback warnings are process-global.  The disabled fast path is a
# single global read and the profiler check.

_ACTIVE: Tracer | None = None


def active() -> Tracer | None:
    """The active tracer, or None when tracing is disabled."""
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def span(name: str, cat: str = "", args=None):
    """A span on the active tracer; with none, a profiler range while
    ``torch.profiler`` records, else :data:`NOOP_SPAN`."""
    t = _ACTIVE
    if t is not None:
        return t.span(name, cat, args)
    if _profiling():
        return _RangeSpan(name)
    return NOOP_SPAN


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
    """Uninstall the active tracer (settling its event pairs and folding
    in the launch-signature counts)."""
    global _ACTIVE
    t, _ACTIVE = _ACTIVE, None
    if t is not None:
        t._finish()
    return t


@contextlib.contextmanager
def tracing(tracer: Tracer | None = None):
    """``with obs.tracing() as t:`` — scoped start/stop."""
    t = start_tracing(tracer)
    try:
        yield t
    finally:
        stop_tracing()
