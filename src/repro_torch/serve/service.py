"""GraphService: admission, lane dispatchers, and fused query execution.

The PyTorch counterpart of ``repro.serve.service``: the same names,
classes, lanes and fusion rules (``mesh=`` included), plus ``device=``
(``None``: the card, raising without one), which every lane's engine,
truss peel and stream session runs on.  The three lanes are threads
that launch on the same card; the kernels' launch counts are kept under
a lock, so a run's launches add up across lanes.

The multi-tenant front door.  Clients :meth:`~GraphService.submit`
requests against attached graphs (static ``.tricsr``-backed tenants) or
open stream sessions (incremental tenants); every request is classified
into a traffic class, admitted through the per-class bounded queues of
:class:`~repro_torch.serve.admission.AdmissionQueue`, and executed by one of
three lane dispatcher threads:

``read``  (classes ``point`` + ``node``)
    count / transitivity / per_node / clustering.  Concurrent queries on
    the same graph **fuse into one engine pass**: a window holding 12
    ``count`` and 3 ``clustering`` requests for graph G runs a single
    per-node pass, derives the count as ``per_node.sum() // 3`` (exact —
    every triangle contributes exactly one incidence to each of its
    three corners) and the clustering/transitivity values through the
    *same* host-side helpers the engine's own methods call, so fused
    answers are bit-identical to sequential ones.
``heavy`` (class ``heavy``)
    edge support / k-truss.  A separate lane with its own (small) queue
    bound and timeout, so a minutes-long truss decomposition queues and
    expires on its own budget while point lookups keep draining — the
    starvation-protection half of the admission design.
``update`` (class ``update``)
    mutations and snapshots for stream sessions, serialized per session
    under the session lock (reads interleave at batch granularity).

Batching is *continuous* by default (``batch_window_s = 0``): a lone
request dispatches immediately; batches form from whatever queued while
the previous pass executed — exactly the offline-inference batching
shape, applied to graph queries.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.engine import TriangleCounter, degree_histogram
from repro_torch.distributed.mesh import mesh_device

from .admission import (
    AdmissionQueue,
    ClassPolicy,
    QueryTimeout,
    Request,
    Ticket,
)
from .manager import GraphManager
from .session import StreamSession
from .snapshot import SnapshotStore

__all__ = [
    "KIND_TO_CLASS",
    "READ_LANE",
    "HEAVY_LANE",
    "UPDATE_LANE",
    "DEFAULT_POLICIES",
    "GraphService",
]

KIND_TO_CLASS = {
    "count": "point",
    "transitivity": "point",
    "per_node": "node",
    "clustering": "node",
    "support": "heavy",
    "truss": "heavy",
    "update": "update",
    "snapshot": "update",
}

READ_LANE = ("point", "node")
HEAVY_LANE = ("heavy",)
UPDATE_LANE = ("update",)

DEFAULT_POLICIES = {
    # point lookups: deep queue, generous fusion — they're O(1)-ish reads
    # or share one engine pass with the node class
    "point": ClassPolicy(max_queue=4096, timeout_s=None, max_batch=256),
    "node": ClassPolicy(max_queue=1024, timeout_s=None, max_batch=64),
    # heavies: shallow queue + timeout so they shed load instead of
    # building an unbounded backlog behind a slow truss
    "heavy": ClassPolicy(max_queue=16, timeout_s=120.0, max_batch=4),
    "update": ClassPolicy(max_queue=1024, timeout_s=None, max_batch=32),
}

_LANES = {"read": READ_LANE, "heavy": HEAVY_LANE, "update": UPDATE_LANE}


class GraphService:
    """Multi-tenant graph-query service over one :class:`GraphManager`.

    Parameters
    ----------
    manager:
        Graph residency layer (owns the shared autotuner).  A plain
        ``cache_dir`` string is accepted and wrapped.
    policies:
        Per-traffic-class overrides merged over :data:`DEFAULT_POLICIES`.
    method / max_wedge_chunk:
        Engine configuration; every lane gets its own
        :class:`TriangleCounter` (engine stats are per-instance mutable
        state) but all of them share the manager's tuner/tile cache.
    mesh:
        A :class:`repro_torch.distributed.Mesh` handed to every lane's
        engine, truss peel and session counter, so ``method="distributed"``
        (or ``"auto"`` over a mesh of more than one stripe) serves every
        query on the §III-E stripes.
    device:
        Where every lane's engine, truss peel and session counter run
        (``None``: the card; with a mesh, its lead device).  A ``cache_dir`` string builds a manager on
        the same device; a given manager's tuner must measure there.
    start:
        ``False`` defers dispatcher threads — requests queue but nothing
        executes until :meth:`start`.  The tests use this to build a
        known multi-request window deterministically.
    """

    def __init__(
        self,
        manager: GraphManager | str,
        *,
        policies: dict[str, ClassPolicy] | None = None,
        method: str = "auto",
        max_wedge_chunk: int | None = None,
        mesh=None,
        start: bool = True,
        device=None,
    ):
        self.device = mesh_device(mesh, device)
        if not isinstance(manager, GraphManager):
            manager = GraphManager(manager, device=self.device)
        if manager.tuner.device != self.device:
            raise ValueError(f"the manager's tuner measures on {manager.tuner.device}, "
                             f"the service runs on {self.device}")
        self.manager = manager
        merged = dict(DEFAULT_POLICIES)
        if policies:
            unknown = set(policies) - set(merged)
            if unknown:
                raise ValueError(f"unknown traffic classes: {sorted(unknown)}")
            merged.update(policies)
        self.queue = AdmissionQueue(merged)
        self.method = method
        self.max_wedge_chunk = max_wedge_chunk
        self.mesh = mesh
        self._sessions: dict[str, StreamSession] = {}
        self._sessions_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._started = False
        self._closed = False
        if start:
            self.start()

    def _new_engine(self) -> TriangleCounter:
        return TriangleCounter(
            method=self.method,
            max_wedge_chunk=self.max_wedge_chunk,
            tuner=self.manager.tuner,
            mesh=self.mesh,
            device=self.device,
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        if self._closed:
            raise RuntimeError("service already closed")
        self._started = True
        for lane_name, lane in _LANES.items():
            t = threading.Thread(
                target=self._lane_loop,
                args=(lane, self._new_engine()),
                name=f"serve-{lane_name}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def close(self, timeout: float | None = 30.0) -> None:
        """Drain queued work, stop dispatchers, reject anything left."""
        if self._closed:
            return
        self._closed = True
        self.queue.close()
        for t in self._threads:
            t.join(timeout)
        self._threads.clear()
        self.queue.reject_pending(RuntimeError("service closed"))

    def __enter__(self) -> "GraphService":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- tenants -------------------------------------------------------------

    def attach(self, name: str, source, **kwargs):
        """Attach a static graph tenant (see :meth:`GraphManager.attach`)."""
        return self.manager.attach(name, source, **kwargs)

    def open_session(
        self,
        name: str,
        *,
        n_nodes: int | None = None,
        snapshot_dir: str | None = None,
        resume: bool = False,
    ) -> StreamSession:
        """Open (or resume) a streaming tenant named ``name``.

        With ``resume=True`` and a ``snapshot_dir`` holding a valid
        snapshot, the session restores mid-stream (count, per-node state
        and cursor all recovered); otherwise it starts empty.
        """
        with self._sessions_lock:
            if name in self._sessions:
                raise ValueError(f"session {name!r} already open")
            session = None
            if resume and snapshot_dir is not None:
                store = SnapshotStore(snapshot_dir)
                hit = store.restore_session(
                    name,
                    max_wedge_chunk=self.max_wedge_chunk,
                    method=self.method,
                    mesh=self.mesh,
                    device=self.device,
                )
                if hit is not None:
                    session = hit[0]
            if session is None:
                session = StreamSession(
                    name,
                    n_nodes=n_nodes,
                    max_wedge_chunk=self.max_wedge_chunk,
                    method=self.method,
                    mesh=self.mesh,
                    device=self.device,
                )
            self._sessions[name] = session
            return session

    def session(self, name: str) -> StreamSession | None:
        with self._sessions_lock:
            return self._sessions.get(name)

    def close_session(self, name: str) -> None:
        with self._sessions_lock:
            self._sessions.pop(name, None)

    # -- request surface -----------------------------------------------------

    def submit(self, graph: str, kind: str, **params) -> Ticket:
        """Admit one request; returns its :class:`Ticket` immediately.

        Raises :class:`QueueOverflow` when the kind's class queue is
        full — admission control is synchronous so callers can shed load
        (retry, degrade, or error out) instead of queueing blindly.
        """
        try:
            cls = KIND_TO_CLASS[kind]
        except KeyError:
            raise ValueError(
                f"unknown query kind {kind!r}; expected one of "
                f"{sorted(KIND_TO_CLASS)}"
            ) from None
        ticket = Ticket(kind, cls)
        obs.counter("serve.requests").add()
        self.queue.submit(Request(graph, kind, params, cls, ticket))
        return ticket

    def query(self, graph: str, kind: str, *, timeout: float | None = None, **params):
        """Submit and block for the answer (convenience wrapper)."""
        return self.submit(graph, kind, **params).result(timeout)

    def update(self, graph: str, insert=None, delete=None) -> Ticket:
        """Enqueue a mutation batch for ``graph``'s stream session."""
        return self.submit(graph, "update", insert=insert, delete=delete)

    def snapshot(self, graph: str, store: SnapshotStore) -> Ticket:
        """Enqueue a snapshot of ``graph``'s session, ordered with updates."""
        return self.submit(graph, "snapshot", store=store)

    def stats(self) -> dict:
        """JSON-ready service state: queue depths + residency + counters."""
        return {
            "queues": {c: self.queue.depth(c) for c in self.queue.classes},
            "sessions": sorted(self._sessions),
            "manager": self.manager.stats(),
            "counters": {
                k: v
                for k, v in obs.metrics_snapshot()["counters"].items()
                if k.startswith("serve.")
            },
        }

    # -- dispatch ------------------------------------------------------------

    def _lane_loop(self, lane: tuple[str, ...], engine: TriangleCounter) -> None:
        while True:
            batch = self.queue.collect(lane)
            if not batch:
                return
            self._dispatch(batch, engine)

    def _dispatch(self, batch: list[Request], engine: TriangleCounter) -> None:
        now = time.monotonic()
        live: list[Request] = []
        for req in batch:
            pol = self.queue.policy(req.traffic_class)
            if pol.timeout_s is not None and now - req.t_submit > pol.timeout_s:
                obs.counter("serve.timeouts").add()
                req.ticket.reject(QueryTimeout(
                    f"{req.kind} on {req.graph!r} waited "
                    f"{now - req.t_submit:.3f}s > "
                    f"timeout_s={pol.timeout_s} for class {req.traffic_class!r}"
                ))
            else:
                live.append(req)
        groups: dict[str, list[Request]] = {}
        for req in live:
            groups.setdefault(req.graph, []).append(req)
        for graph, reqs in groups.items():
            if len(reqs) > 1:
                obs.counter("serve.fused_batches").add()
                obs.counter("serve.fused_queries").add(len(reqs))
            try:
                with obs.span("serve.dispatch", cat="serve",
                              args={"graph": graph, "n": len(reqs),
                                    "kinds": sorted({r.kind for r in reqs})}):
                    self._execute(graph, reqs, engine)
            except BaseException as e:
                for req in reqs:
                    if not req.ticket.done():
                        req.ticket.reject(e)

    def _execute(self, graph: str, reqs: list[Request], engine: TriangleCounter):
        session = self.session(graph)
        if session is not None:
            self._execute_session(session, reqs, engine)
        else:
            if any(r.kind in ("update", "snapshot") for r in reqs):
                raise KeyError(f"graph {graph!r} has no open stream session")
            self._execute_static(graph, reqs, engine)

    # one engine pass per fused window, at the maximal artifact level the
    # window needs; cheaper answers derive from it exactly
    def _execute_static(self, graph: str, reqs: list[Request],
                        engine: TriangleCounter) -> None:
        kinds = {r.kind for r in reqs}
        with self.manager.lease(graph) as ent:
            csr = ent.csr
            per_node = support = None
            count: int | None = None
            if kinds & {"per_node", "clustering"}:
                per_node = engine.per_node(csr)
                if hasattr(csr, "map_per_node"):
                    # compressed graphs count in relabeled ids; answer in
                    # the tenant's original ids
                    per_node = csr.map_per_node(per_node)
                obs.counter("serve.engine_passes").add()
            if "support" in kinds:
                support = engine.edge_support(csr)
                obs.counter("serve.engine_passes").add()
            if kinds & {"count", "transitivity"}:
                if per_node is not None:
                    count = int(per_node.sum(dtype=np.int64)) // 3
                elif support is not None:
                    count = int(support.sum(dtype=np.int64)) // 3
                else:
                    count = engine.count(csr)
                    obs.counter("serve.engine_passes").add()
            deg = None
            if kinds & {"clustering", "transitivity"}:
                deg, _ = degree_histogram(csr)
                if hasattr(csr, "map_per_node"):
                    deg = csr.map_per_node(deg)
            truss = None
            if "truss" in kinds:
                from repro_torch.analytics import k_truss_decomposition

                truss = k_truss_decomposition(
                    csr,
                    max_wedge_chunk=self.max_wedge_chunk,
                    method=self.method,
                    mesh=self.mesh,
                    device=self.device,
                )
                obs.counter("serve.engine_passes").add()
        from repro_torch.analytics.metrics import (
            clustering_from_counts,
            transitivity_from_counts,
        )

        for req in reqs:
            if req.kind == "count":
                req.ticket.resolve(count)
            elif req.kind == "per_node":
                req.ticket.resolve(per_node)
            elif req.kind == "clustering":
                req.ticket.resolve(clustering_from_counts(per_node, deg))
            elif req.kind == "transitivity":
                req.ticket.resolve(transitivity_from_counts(count, deg))
            elif req.kind == "support":
                req.ticket.resolve(support)
            elif req.kind == "truss":
                req.ticket.resolve(truss)
            else:
                req.ticket.reject(ValueError(f"unknown kind {req.kind!r}"))

    def _execute_session(self, session: StreamSession, reqs: list[Request],
                         engine: TriangleCounter) -> None:
        # updates/snapshots run in submit order; reads serve the
        # maintained state under the same lock (one acquisition per window)
        heavies = [r for r in reqs if r.kind in ("support", "truss")]
        rest = [r for r in reqs if r.kind not in ("support", "truss")]
        if rest:
            with session.lock:
                for req in rest:
                    if req.kind == "update":
                        req.ticket.resolve(session.apply(
                            insert=req.params.get("insert"),
                            delete=req.params.get("delete"),
                        ))
                    elif req.kind == "snapshot":
                        cursor = req.params["store"].save(session)
                        req.ticket.resolve({"cursor": cursor,
                                            "directory": req.params["store"].directory})
                    else:
                        req.ticket.resolve(session.read(req.kind))
        if heavies:
            edges, n_nodes = session.edges_snapshot()
            kinds = {r.kind for r in heavies}
            support = truss = None
            if "support" in kinds:
                support = engine.edge_support(edges, n_nodes)
                obs.counter("serve.engine_passes").add()
            if "truss" in kinds:
                from repro_torch.analytics import k_truss_decomposition

                truss = k_truss_decomposition(
                    edges, n_nodes,
                    max_wedge_chunk=self.max_wedge_chunk,
                    method=self.method,
                    mesh=self.mesh,
                    device=self.device,
                )
                obs.counter("serve.engine_passes").add()
            for req in heavies:
                req.ticket.resolve(support if req.kind == "support" else truss)
