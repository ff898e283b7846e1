"""repro_torch.obs — spans, counters, and trace export for the triangle engine.

The observability layer the timing claims rest on (§V of the paper is
*all* timings).  Three pieces:

* :mod:`repro_torch.obs.tracer` — hierarchical spans that measure device
  time, not async dispatch (an explicit ``torch.cuda.synchronize``, or a
  CUDA event pair read after a later wait), near-zero cost when disabled;
  while ``torch.profiler`` records, each span is also a ``record_function``
  range on the profiler's clock.
* :mod:`repro_torch.obs.counters` — process-wide counters/gauges (chunks
  launched, wedges planned, cache hits, capability fallbacks).
* :mod:`repro_torch.obs.export` — Chrome trace-event JSON (Perfetto-viewable)
  and structured JSONL exporters, plus stdlib-only validators.

Typical CLI wiring::

    with obs.trace_to_file(args.trace, meta={"cli": "count"}):
        with obs.span("ingest", cat="io"):
            graph = ...
        tc.count(graph)          # engine emits nested spans itself

and in engine code wrapping device work::

    with trc.span("count.chunk", cat="engine") as sp, sp.device_time(device):
        part = backend.count_chunk(adj, chunk)
    ...                  # the fold waits for the device
    trc.settle()         # each chunk span's args gain "device_ms"

Importing this package never imports torch (the validators stay
stdlib-only); the tracer finds torch in ``sys.modules`` or imports it
lazily.
"""
from .counters import (
    Counter,
    Gauge,
    MetricsRegistry,
    counter,
    gauge,
    registry,
)
from .counters import reset as reset_metrics
from .counters import snapshot as metrics_snapshot
from .export import (
    SCHEMA,
    env_fingerprint,
    to_chrome_trace,
    to_jsonl_records,
    trace_to_file,
    validate_chrome_trace,
    validate_jsonl_records,
    write_trace,
)
from .hist import N_BUCKETS, ConcurrentHistogram, Pow2Histogram, RollingHistogram
from .tracer import (
    NOOP_SPAN,
    Span,
    Tracer,
    active,
    enabled,
    span,
    start_tracing,
    stop_tracing,
    tracing,
)

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "N_BUCKETS",
    "NOOP_SPAN",
    "Pow2Histogram",
    "ConcurrentHistogram",
    "RollingHistogram",
    "SCHEMA",
    "Span",
    "Tracer",
    "active",
    "counter",
    "enabled",
    "env_fingerprint",
    "gauge",
    "metrics_snapshot",
    "registry",
    "reset_metrics",
    "span",
    "start_tracing",
    "stop_tracing",
    "to_chrome_trace",
    "to_jsonl_records",
    "trace_to_file",
    "tracing",
    "validate_chrome_trace",
    "validate_jsonl_records",
    "write_trace",
]
