"""Streaming tenant sessions: incremental state + stream cursor + drive loop.

The PyTorch counterpart of ``repro.serve.session``: the same names,
report keys and resume-by-cursor semantics, plus ``device=`` where a
counter is built (``None``: the card, raising without one).

A :class:`StreamSession` owns one tenant's
:class:`repro_torch.core.IncrementalTriangleCounter` plus the **stream
cursor** — how many update batches the session has consumed.  The
streams (:mod:`repro_torch.graphs.streams`) are deterministic given their
seed, so the cursor is the whole resume story: snapshot the maintained
state and the cursor, and a restarted process rebuilds the exact
mid-stream session by restoring the arrays and skipping ``cursor``
batches of the regenerated stream.  No replay of applied updates, no
divergence — the restored per-node incidences are the bytes that were
checkpointed, and every batch after the cursor is bit-identical to what
the uninterrupted session would have seen.

All mutation and state reads go through ``session.lock``, so update and
read threads interleave safely with a well-defined order.

:func:`drive_stream` is the single-tenant drive loop the
``serve_graph`` CLI fronts — batches interleaved with queries, pow2
latency histograms per traffic class, rolling-window interval reports,
and periodic snapshots through a :class:`~repro_torch.serve.snapshot.
SnapshotStore` so a killed process resumes mid-stream.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.core import IncrementalTriangleCounter
from repro_torch.obs import RollingHistogram

__all__ = ["StreamSession", "drive_stream", "QUERY_KINDS"]

QUERY_KINDS = ("count", "per_node", "clustering", "transitivity")


class StreamSession:
    """One streaming tenant: maintained counter state + stream cursor."""

    def __init__(
        self,
        name: str,
        *,
        n_nodes: int | None = None,
        max_wedge_chunk: int | None = None,
        method: str = "auto",
        mesh=None,
        counter: IncrementalTriangleCounter | None = None,
        cursor: int = 0,
        device=None,
    ):
        if cursor < 0:
            raise ValueError("cursor must be >= 0")
        self.name = name
        self.lock = threading.RLock()
        self.counter = counter if counter is not None else IncrementalTriangleCounter(
            n_nodes=n_nodes, max_wedge_chunk=max_wedge_chunk, method=method, mesh=mesh,
            device=device,
        )
        self.cursor = cursor        # update batches consumed so far
        self.n_applied = 0          # batches applied by THIS process

    # -- mutation ------------------------------------------------------------

    def apply(self, insert=None, delete=None) -> dict:
        """Apply one update batch; returns a JSON-ready result summary."""
        with self.lock:
            delta = self.counter.apply(insert=insert, delete=delete)
            self.cursor += 1
            self.n_applied += 1
            return {
                "count": int(self.counter.count),
                "n_edges": int(self.counter.n_edges),
                "delta": int(delta),
                "cursor": self.cursor,
            }

    # -- reads (cheap: maintained state) -------------------------------------

    def read(self, kind: str):
        """Serve one maintained-state query under the session lock."""
        with self.lock:
            if kind == "count":
                return int(self.counter.count)
            if kind == "per_node":
                return self.counter.per_node()
            if kind == "clustering":
                return self.counter.clustering()
            if kind == "transitivity":
                return self.counter.transitivity()
            raise ValueError(f"unknown session query kind {kind!r}")

    def edges_snapshot(self) -> tuple[np.ndarray, int]:
        """(live undirected edges, n_nodes) — for heavy engine passes."""
        with self.lock:
            return self.counter.current_edges(), self.counter.n_nodes

    # -- snapshot / restore ---------------------------------------------------

    def state_tree(self) -> dict[str, np.ndarray]:
        """The checkpointable pytree: counter state + stream cursor."""
        with self.lock:
            tree = self.counter.state_dict()
            tree["cursor"] = np.asarray(self.cursor, np.int64)
            return tree

    @classmethod
    def from_state(
        cls,
        name: str,
        tree: dict,
        *,
        max_wedge_chunk: int | None = None,
        method: str = "auto",
        mesh=None,
        device=None,
    ) -> "StreamSession":
        """Rebuild a session from a restored :meth:`state_tree` pytree."""
        counter = IncrementalTriangleCounter.from_state(
            {k: v for k, v in tree.items() if k != "cursor"},
            max_wedge_chunk=max_wedge_chunk,
            method=method,
            mesh=mesh,
            device=device,
        )
        return cls(name, counter=counter, cursor=int(np.asarray(tree["cursor"])))


def _interval_snapshot(kind, interval, n_batches, elapsed_s, update_hist, query_hists):
    """One JSON-ready latency snapshot (``kind`` = "interval" | "final")."""
    return {
        "kind": kind,
        "interval": interval,
        "batches": n_batches,
        "elapsed_s": elapsed_s,
        "update": update_hist.snapshot_ms(),
        "queries": {k: h.snapshot_ms() for k, h in query_hists.items()},
    }


def drive_stream(
    stream,
    *,
    n_nodes: int,
    max_batches: int | None = None,
    queries_per_batch: int = 4,
    max_wedge_chunk: int | None = None,
    method: str = "auto",
    mesh=None,
    report_every: int | None = None,
    window_intervals: int = 8,
    metrics_sink=None,
    log=None,
    session: StreamSession | None = None,
    snapshot_store=None,
    snapshot_every: int | None = None,
    device=None,
):
    """Apply ``stream`` batches interleaved with queries; return a report.

    The single-tenant serving loop: latencies land in per-traffic-class
    pow2 histograms; every ``report_every`` batches the current interval
    is sealed (snapshot to ``metrics_sink``, rolling-window percentiles
    to ``log``).  The returned report keeps the historical flat keys
    (``update_p50_ms`` … ``updates_per_s``) plus per-kind and
    rolling-window detail under ``"latency"``.

    Resume semantics: pass a restored ``session`` — its ``cursor``
    batches are *skipped* (consumed without applying; the deterministic
    generators re-derive them identically) before applying resumes.
    ``max_batches`` bounds the **absolute** stream position, so an
    uninterrupted ``max_batches=N`` run and a kill-at-k/resume run end
    on exactly the same state.  With ``snapshot_store`` set, the session
    is checkpointed every ``snapshot_every`` applied batches and once
    more at exit.

    ``device`` places a new session's counter (``None``: the card); a
    given ``session`` keeps its own.

    Returns ``(counter, report)`` — the counter for oracle verification.
    """
    if session is None:
        session = StreamSession(
            "stream", n_nodes=n_nodes, max_wedge_chunk=max_wedge_chunk,
            method=method, mesh=mesh, device=device,
        )
    skip = session.cursor
    if skip and log is not None:
        log(f"resume: skipping {skip} already-applied batches (cursor)")
    update_hist = RollingHistogram(window_intervals)
    query_hists = {k: RollingHistogram(window_intervals) for k in QUERY_KINDS}
    n_batches = n_inserted = n_deleted = n_queries = 0
    qi = 0
    interval = 0
    position = 0  # absolute stream position (batches generated)
    t_start = time.perf_counter()

    def seal_interval():
        nonlocal interval
        interval += 1
        sealed_update = update_hist.rotate()
        sealed_queries = {k: h.rotate() for k, h in query_hists.items()}
        if metrics_sink is not None:
            metrics_sink(_interval_snapshot(
                "interval", interval, n_batches,
                time.perf_counter() - t_start, sealed_update, sealed_queries,
            ))
        if log is not None:
            win = update_hist.windowed()
            qwin = {k: h.windowed() for k, h in query_hists.items()}
            qp99 = max((h.percentile(99) for h in qwin.values() if h.n), default=0.0)
            log(f"[interval {interval}] {n_batches} batches; rolling "
                f"update p50 {win.percentile(50)*1e3:.2f} ms / "
                f"p99 {win.percentile(99)*1e3:.2f} ms; "
                f"worst query-kind p99 {qp99*1e3:.3f} ms")

    n_snapshots = 0
    for batch in stream:
        position += 1
        if position <= skip:
            continue  # already applied before the snapshot we resumed from
        if max_batches is not None and position > max_batches:
            break
        t0 = time.perf_counter()
        with obs.span("serve.update", cat="serve",
                      args={"batch": position - 1,
                            "insert": int(batch.insert.shape[0]),
                            "delete": int(batch.delete.shape[0])}):
            session.apply(insert=batch.insert, delete=batch.delete)
        update_hist.observe(time.perf_counter() - t0)
        n_batches += 1
        n_inserted += batch.insert.shape[0]
        n_deleted += batch.delete.shape[0]
        for _ in range(queries_per_batch):
            kind = QUERY_KINDS[qi % len(QUERY_KINDS)]
            qi += 1
            t0 = time.perf_counter()
            with obs.span("serve.query", cat="serve", args={"kind": kind}):
                _ = session.read(kind)
            query_hists[kind].observe(time.perf_counter() - t0)
            n_queries += 1
        if (snapshot_store is not None and snapshot_every is not None
                and n_batches % snapshot_every == 0):
            snapshot_store.save(session)
            n_snapshots += 1
        if report_every is not None and n_batches % report_every == 0:
            seal_interval()

    if snapshot_store is not None and session.n_applied:
        snapshot_store.save(session)
        snapshot_store.wait()
        n_snapshots += 1

    if metrics_sink is not None:
        metrics_sink(_interval_snapshot(
            "final", interval, n_batches, time.perf_counter() - t_start,
            update_hist.lifetime,
            {k: h.lifetime for k, h in query_hists.items()},
        ))

    # whole-run percentiles: merge the per-kind lifetime histograms for
    # the aggregate query figures the historical report shape exposes
    query_all = update_hist.lifetime.__class__()
    for h in query_hists.values():
        query_all.merge(h.lifetime)
    up = update_hist.lifetime
    report = dict(
        n_batches=n_batches,
        n_inserted=n_inserted,
        n_deleted=n_deleted,
        n_queries=n_queries,
        update_p50_ms=up.percentile(50) * 1e3 if up.n else 0.0,
        update_p99_ms=up.percentile(99) * 1e3 if up.n else 0.0,
        query_p50_ms=query_all.percentile(50) * 1e3 if query_all.n else 0.0,
        query_p99_ms=query_all.percentile(99) * 1e3 if query_all.n else 0.0,
        updates_per_s=(n_inserted + n_deleted) / max(up.total_ns / 1e9, 1e-12),
        latency=dict(
            intervals=interval,
            update=up.snapshot_ms(),
            queries={k: h.lifetime.snapshot_ms() for k, h in query_hists.items()},
            window=dict(
                intervals=min(interval + 1, window_intervals),
                update=update_hist.windowed().snapshot_ms(),
                queries={k: h.windowed().snapshot_ms()
                         for k, h in query_hists.items()},
            ),
        ),
    )
    if skip or snapshot_store is not None:
        report["resume"] = dict(
            skipped_batches=skip,
            cursor=session.cursor,
            snapshots_written=n_snapshots,
        )
    return session.counter, report
