"""Trace exporters: Chrome trace-event JSON and structured JSONL.

Two formats, one event stream:

* **Chrome trace-event JSON** — the ``{"traceEvents": [...]}`` object
  format with complete (``"ph": "X"``) events, loadable directly in
  Perfetto / ``chrome://tracing``.  Nesting is rendered from timestamp
  containment, which the tracer's strictly-ordered ``ts_ns``/``dur_ns``
  pairs guarantee.  Timestamps are microseconds (floats keep the ns
  resolution).
* **JSONL** — one JSON object per line: a ``meta`` header (schema tag +
  environment fingerprint), one ``span`` record per event with raw ns
  fields, and a trailing ``metrics`` record (counters, gauges and
  ``jit_traces``: in the port, the new launch signatures per kernel entry
  point, see :mod:`repro_torch.obs.tracer`).  This is the
  diff/ingest-friendly form for scripts.

Both validators are stdlib-only (no torch, no jsonschema) so CI's lint-tier
jobs can check artifacts without the accelerator stack installed.
"""
from __future__ import annotations

import json
import os
import platform
import sys
import time

from . import counters as _counters
from .tracer import Tracer

__all__ = [
    "SCHEMA",
    "env_fingerprint",
    "to_chrome_trace",
    "to_jsonl_records",
    "trace_to_file",
    "validate_chrome_trace",
    "validate_jsonl_records",
    "write_trace",
]

SCHEMA = "repro-trace-v1"


def env_fingerprint() -> dict:
    """Where a measurement ran — stamped into every exported artifact.

    torch fields degrade to None when torch is absent (stdlib-only
    callers), never fail; ``device`` names the first CUDA card when one
    is visible.
    """
    fp = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "machine": platform.machine(),
        "argv0": os.path.basename(sys.argv[0]) if sys.argv else None,
        "unix_time": time.time(),
        "torch": None,
        "cuda": None,
        "device": None,
        "device_count": None,
    }
    try:
        import torch

        fp["torch"] = torch.__version__
        fp["cuda"] = torch.version.cuda
        fp["device_count"] = torch.cuda.device_count()
        if fp["device_count"]:
            fp["device"] = torch.cuda.get_device_name(0)
    except Exception:
        pass
    return fp


def to_chrome_trace(tracer: Tracer, *, metrics: dict | None = None,
                    meta: dict | None = None) -> dict:
    """The tracer's events as a Chrome trace-event JSON object."""
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {"name": "repro_torch"},
        }
    ]
    for ev in tracer.events:
        args = dict(ev.get("args") or {})
        args["depth"] = ev["depth"]
        if "error" in ev:
            args["error"] = ev["error"]
        events.append(
            {
                "name": ev["name"],
                "cat": ev["cat"] or "default",
                "ph": "X",
                "ts": ev["ts_ns"] / 1e3,
                "dur": ev["dur_ns"] / 1e3,
                "pid": 0,
                "tid": 0,
                "args": args,
            }
        )
    other = {
        "schema": SCHEMA,
        "env": env_fingerprint(),
        "jit_traces": tracer.jit_traces,
    }
    if metrics is not None:
        other["metrics"] = metrics
    if meta or tracer.meta:
        other["meta"] = {**tracer.meta, **(meta or {})}
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def to_jsonl_records(tracer: Tracer, *, metrics: dict | None = None,
                     meta: dict | None = None) -> "list[dict]":
    """The tracer's events as JSONL records (header, spans, metrics)."""
    records = [
        {
            "kind": "meta",
            "schema": SCHEMA,
            "env": env_fingerprint(),
            "meta": {**tracer.meta, **(meta or {})},
        }
    ]
    for ev in tracer.events:
        rec = {
            "kind": "span",
            "name": ev["name"],
            "cat": ev["cat"],
            "ts_ns": ev["ts_ns"],
            "dur_ns": ev["dur_ns"],
            "depth": ev["depth"],
        }
        if "args" in ev:
            rec["args"] = ev["args"]
        if "error" in ev:
            rec["error"] = ev["error"]
        records.append(rec)
    records.append(
        {
            "kind": "metrics",
            "metrics": metrics if metrics is not None else _counters.snapshot(),
            "jit_traces": tracer.jit_traces,
        }
    )
    return records


def write_trace(path: str, tracer: Tracer, *, metrics: dict | None = None,
                meta: dict | None = None) -> str:
    """Write the trace to ``path``; extension picks the format.

    ``.jsonl`` → JSONL event log, anything else → Chrome trace JSON.
    """
    if str(path).endswith(".jsonl"):
        body = "\n".join(
            json.dumps(rec, sort_keys=True)
            for rec in to_jsonl_records(tracer, metrics=metrics, meta=meta)
        ) + "\n"
    else:
        body = json.dumps(
            to_chrome_trace(tracer, metrics=metrics, meta=meta), indent=1
        )
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(body)
    os.replace(tmp, path)
    return str(path)


def trace_to_file(path: str | None, *, meta: dict | None = None):
    """CLI-facing scope: trace everything inside, export on exit.

    ``path=None`` yields a no-op scope so callers can write
    ``with trace_to_file(args.trace):`` unconditionally.  Metrics are
    snapshot at exit, so counters incremented inside the scope land in
    the artifact.
    """
    import contextlib

    from . import tracer as _tracer

    @contextlib.contextmanager
    def _scope():
        if not path:
            yield None
            return
        t = _tracer.start_tracing()
        try:
            yield t
        finally:
            _tracer.stop_tracing()
            write_trace(path, t, metrics=_counters.snapshot(), meta=meta)

    return _scope()


# -- stdlib validators (used by tests and the CI obs-smoke step) -------------


def validate_chrome_trace(obj) -> int:
    """Schema-check a Chrome trace object; returns the span-event count.

    Raises ``ValueError`` on any violation.  Checks exactly the
    properties Perfetto relies on: event list shape, complete-event
    fields, numeric non-negative ts/dur, and proper nesting state (a
    child span must close before its parent).
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Chrome trace: missing 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    spans = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph != "X":
            raise ValueError(f"event {i}: unexpected phase {ph!r}")
        for key in ("name", "ts", "dur", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i}: missing {key!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            raise ValueError(f"event {i}: bad name")
        ts, dur = ev["ts"], ev["dur"]
        if not isinstance(ts, (int, float)) or not isinstance(dur, (int, float)):
            raise ValueError(f"event {i}: non-numeric ts/dur")
        if ts < 0 or dur < 0:
            raise ValueError(f"event {i}: negative ts/dur")
        depth = ev.get("args", {}).get("depth")
        if not isinstance(depth, int) or depth < 0:
            raise ValueError(f"event {i}: missing/invalid args.depth")
        spans.append((ts, ts + dur, depth, ev["name"]))
    # spans are recorded in close order (a child's __exit__ runs before its
    # parent's), so a span's parent is the FIRST subsequent span one level
    # shallower; it must strictly contain the child.
    for i, (ts, end, depth, name) in enumerate(spans):
        if depth == 0:
            continue
        parent = next((s for s in spans[i + 1:] if s[2] == depth - 1), None)
        if parent is None:
            raise ValueError(f"span {name!r} at depth {depth} has no parent span")
        if ts < parent[0] - 1e-6 or end > parent[1] + 1e-6:
            raise ValueError(
                f"span {name!r} is not contained in its parent {parent[3]!r}"
            )
    return len(spans)


def validate_jsonl_records(records) -> int:
    """Schema-check parsed JSONL records; returns the span-record count."""
    records = list(records)
    if not records:
        raise ValueError("empty JSONL trace")
    head, tail = records[0], records[-1]
    if head.get("kind") != "meta" or head.get("schema") != SCHEMA:
        raise ValueError("first record must be a meta header with the schema tag")
    if not isinstance(head.get("env"), dict):
        raise ValueError("meta header missing env fingerprint")
    if tail.get("kind") != "metrics" or not isinstance(tail.get("metrics"), dict):
        raise ValueError("last record must be a metrics snapshot")
    n_spans = 0
    for i, rec in enumerate(records[1:-1], start=1):
        if rec.get("kind") != "span":
            raise ValueError(f"record {i}: expected a span record")
        for key in ("name", "ts_ns", "dur_ns", "depth"):
            if key not in rec:
                raise ValueError(f"record {i}: missing {key!r}")
        if rec["ts_ns"] < 0 or rec["dur_ns"] < 0 or rec["depth"] < 0:
            raise ValueError(f"record {i}: negative field")
        n_spans += 1
    return n_spans
