"""Clustering / transitivity / density metrics routed through the engine.

The PyTorch counterpart of ``repro.analytics.metrics``: the paper's
motivating applications (§I) over
:class:`repro_torch.core.engine.TriangleCounter`, so every metric honors
``max_wedge_chunk``, accepts raw canonical edge arrays, ``OrientedCSR``
objects and cached CSR files alike, and takes ``method="auto"``.  The
thin :mod:`repro_torch.core.clustering` wrappers re-export from here.

Every function takes either a ``counter=`` (a configured
:class:`~repro_torch.core.engine.TriangleCounter` to reuse — its
``last_stats`` reflect the call) or ``method=`` / ``max_wedge_chunk=`` /
``device=`` to build one (``device=None``: the card).  To amortize
preprocessing across several metrics, call
:func:`repro_torch.core.engine.prepare_oriented` once and pass the CSR —
that is what :func:`graph_report` does.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import obs
from repro_torch.distributed.mesh import mesh_device
from repro_torch.core.engine import TriangleCounter, degree_histogram, prepare_oriented

from .support import edge_support
from .truss import k_truss_decomposition

__all__ = [
    "clustering_from_counts",
    "transitivity_from_counts",
    "per_node_triangle_counts",
    "profile_from_counts",
    "local_clustering",
    "average_clustering",
    "transitivity",
    "node_triangle_features",
    "clustering_profile",
    "top_triangle_nodes",
    "top_support_edges",
    "graph_report",
]


# ---------------------------------------------------------------------------
# host formulas (shared with repro_torch.core.clustering and the engine)
# ---------------------------------------------------------------------------


def clustering_from_counts(tri: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """c(v) = 2·T(v) / (deg(v)·(deg(v)−1)) from host count/degree arrays."""
    pairs = deg * (deg - 1)
    return np.where(pairs > 0, 2.0 * tri / np.maximum(pairs, 1), 0.0)


def transitivity_from_counts(n_triangles: int, deg: np.ndarray) -> float:
    """3·#triangles / #wedges from a host count and degree array."""
    wedges = int((deg.astype(np.int64) * (deg.astype(np.int64) - 1) // 2).sum())
    return 3.0 * n_triangles / wedges if wedges else 0.0


# ---------------------------------------------------------------------------
# engine-routed metrics
# ---------------------------------------------------------------------------


def _counter(counter, method, max_wedge_chunk, device) -> TriangleCounter:
    if counter is not None:
        return counter
    return TriangleCounter(method=method, max_wedge_chunk=max_wedge_chunk, device=device)


def per_node_triangle_counts(
    edges,
    n_nodes: int | None = None,
    *,
    counter: TriangleCounter | None = None,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    device=None,
) -> np.ndarray:
    """Per-vertex triangle incidences T(v), int64 host array."""
    return _counter(counter, method, max_wedge_chunk, device).per_node(edges, n_nodes)


def local_clustering(
    edges,
    n_nodes: int | None = None,
    *,
    counter: TriangleCounter | None = None,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    device=None,
) -> np.ndarray:
    """Local clustering coefficients c(v); 0 where degree < 2."""
    deg, n_nodes = degree_histogram(edges, n_nodes)
    if deg.size == 0:
        return np.zeros((n_nodes,), np.float64)
    tri = per_node_triangle_counts(
        edges, n_nodes, counter=counter, method=method, max_wedge_chunk=max_wedge_chunk,
        device=device,
    )
    return clustering_from_counts(tri, deg)


def average_clustering(
    edges,
    n_nodes: int | None = None,
    *,
    counter: TriangleCounter | None = None,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    device=None,
) -> float:
    """Mean of the local clustering coefficients (Watts–Strogatz C̄)."""
    cc = local_clustering(
        edges, n_nodes, counter=counter, method=method, max_wedge_chunk=max_wedge_chunk,
        device=device,
    )
    return float(cc.mean()) if cc.size else 0.0


def transitivity(
    edges,
    n_nodes: int | None = None,
    *,
    counter: TriangleCounter | None = None,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    device=None,
) -> float:
    """Global transitivity ratio 3·#triangles / #wedges."""
    deg, n_nodes = degree_histogram(edges, n_nodes)
    if deg.size == 0:
        return 0.0
    t = _counter(counter, method, max_wedge_chunk, device).count(edges, n_nodes)
    return transitivity_from_counts(t, deg)


def node_triangle_features(
    edges,
    n_nodes: int | None = None,
    *,
    counter: TriangleCounter | None = None,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    device=None,
) -> np.ndarray:
    """(n, 3) float32 per-node feature block [degree, triangles, clustering].

    The hook by which the paper's technique feeds the GNN stack: any
    graph arch config may prepend these features to its node inputs.
    """
    deg, n_nodes = degree_histogram(edges, n_nodes)
    tri = (
        per_node_triangle_counts(
            edges, n_nodes, counter=counter, method=method,
            max_wedge_chunk=max_wedge_chunk, device=device,
        )
        if deg.size
        else np.zeros((n_nodes,), np.int64)
    )
    cc = clustering_from_counts(tri, deg) if deg.size else np.zeros((n_nodes,))
    return np.stack(
        [deg.astype(np.float32), tri.astype(np.float32), cc.astype(np.float32)], axis=1
    )


def clustering_profile(
    edges,
    n_nodes: int | None = None,
    *,
    counter: TriangleCounter | None = None,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    device=None,
) -> dict:
    """Degree-binned clustering profile (pow2 degree bins).

    Returns ``{"bins": [lo, ...], "n_nodes": [...], "mean_clustering":
    [...], "mean_triangles": [...]}`` where bin ``i`` covers degrees in
    ``[bins[i], bins[i+1])`` (last bin open-ended).  The c(d) profile is
    the standard skew diagnostic: heavy-tailed graphs show the falling
    c(d) ~ d^-1 the paper's Kronecker family is built to exhibit.
    """
    deg, n_nodes = degree_histogram(edges, n_nodes)
    if deg.size == 0 or int(deg.max()) < 1:
        return _EMPTY_PROFILE.copy()
    tri = per_node_triangle_counts(
        edges, n_nodes, counter=counter, method=method, max_wedge_chunk=max_wedge_chunk,
        device=device,
    )
    return profile_from_counts(tri, deg)


_EMPTY_PROFILE = {"bins": [], "n_nodes": [], "mean_clustering": [], "mean_triangles": []}


def profile_from_counts(tri: np.ndarray, deg: np.ndarray) -> dict:
    """Pow2-degree-bin the per-node counts already in hand."""
    if deg.size == 0 or int(deg.max()) < 1:
        return _EMPTY_PROFILE.copy()
    cc = clustering_from_counts(tri, deg)
    n_bins = max(int(deg.max()).bit_length(), 1)
    lo = 2 ** np.arange(n_bins)          # bins [1,2), [2,4), [4,8), ...
    which = np.digitize(deg, lo) - 1     # degree-0 nodes land in bin -1: drop
    keep = which >= 0
    out = {"bins": lo.tolist(), "n_nodes": [], "mean_clustering": [], "mean_triangles": []}
    for b in range(n_bins):
        m = keep & (which == b)
        cnt = int(m.sum(dtype=np.int64))
        out["n_nodes"].append(cnt)
        out["mean_clustering"].append(float(cc[m].mean()) if cnt else 0.0)
        out["mean_triangles"].append(float(tri[m].mean()) if cnt else 0.0)
    return out


def top_triangle_nodes(
    edges,
    k: int = 10,
    n_nodes: int | None = None,
    *,
    counter: TriangleCounter | None = None,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """The ``k`` most triangle-dense vertices as ``(nodes, counts)``."""
    tri = per_node_triangle_counts(
        edges, n_nodes, counter=counter, method=method, max_wedge_chunk=max_wedge_chunk,
        device=device,
    )
    k = min(int(k), tri.shape[0])
    if k <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(-tri, kind="stable")[:k]
    return order, tri[order]


def top_support_edges(
    edges,
    k: int = 10,
    n_nodes: int | None = None,
    *,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The ``k`` most triangle-dense edges as ``(u, v, support)``."""
    return edge_support(
        edges, n_nodes, method=method, max_wedge_chunk=max_wedge_chunk,
        device=device,
    ).top_k(k)


# ---------------------------------------------------------------------------
# one-stop report (the CLI's --json payload)
# ---------------------------------------------------------------------------


def graph_report(
    graph,
    n_nodes: int | None = None,
    *,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    include_truss: bool = True,
    top_k: int = 5,
    mesh=None,
    device=None,
) -> dict:
    """Full analytics report, preprocessing the graph exactly once.

    The input is normalized to an ``OrientedCSR`` on ``device`` (``None``:
    the card) up front (:func:`repro_torch.core.engine.prepare_oriented`)
    and every stage —
    count, per-node scatter, per-edge support, truss peel — consumes
    that CSR, so ingestion/preprocessing is never repeated.  ``method``
    selects the kernel backend for *every* stage (support and truss
    included — ``pallas`` runs the CUDA kernels in every stage).  ``mesh``
    (a :class:`repro_torch.distributed.Mesh`; the reference's report takes
    none) goes to every stage, so ``method="distributed"`` stripes them
    all over it.  Returns a JSON-ready dict (plain ints/floats/lists) with
    per-stage timings.
    """
    dev = mesh_device(mesh, device)
    t0 = time.perf_counter()
    with obs.span("report.preprocess", cat="analytics"):
        deg, n_from_input = degree_histogram(graph, n_nodes)
        csr = prepare_oriented(graph, n_nodes, device=dev)
    prep_s = time.perf_counter() - t0
    tc = TriangleCounter(method=method, max_wedge_chunk=max_wedge_chunk, mesh=mesh, device=dev)
    report: dict = {
        "n_nodes": int(csr.n_nodes) if csr is not None else n_from_input,
        "n_edges": int(csr.n_directed_edges) if csr is not None else 0,
        "max_degree": int(deg.max()) if deg.size else 0,
    }
    timings = {"preprocess": prep_s}

    t0 = time.perf_counter()
    with obs.span("report.count", cat="analytics"):
        triangles = tc.count(csr if csr is not None else np.zeros((0, 2), np.int32))
    timings["count"] = time.perf_counter() - t0
    es = tc.last_stats
    report["triangles"] = triangles
    report["transitivity"] = transitivity_from_counts(triangles, deg)
    report["engine"] = {
        "method": es.method,
        "resolved_method": es.resolved_method,
        "n_chunks": es.n_chunks,
        "peak_wedge_buffer": es.peak_wedge_buffer,
        "wedge_budget": es.wedge_budget,
        "total_wedges": es.total_wedges,
        "fallback_reason": es.fallback_reason,
        "timings": es.timings,
    }

    t0 = time.perf_counter()
    with obs.span("report.clustering", cat="analytics"):
        tri = (
            tc.per_node(csr)
            if csr is not None
            else np.zeros((report["n_nodes"],), np.int64)
        )
        cc = clustering_from_counts(tri, deg) if deg.size else np.zeros((0,))
    timings["clustering"] = time.perf_counter() - t0
    # one per-node pass feeds average, profile and top-k alike
    order = np.argsort(-tri, kind="stable")[: min(top_k, tri.shape[0])]
    report["clustering"] = {
        "average": float(cc.mean()) if cc.size else 0.0,
        "profile": profile_from_counts(tri, deg),
        "top_nodes": [
            {"node": int(nd), "triangles": int(tri[nd])} for nd in order
        ],
    }

    t0 = time.perf_counter()
    with obs.span("report.support", cat="analytics"):
        sup = edge_support(
            csr if csr is not None else np.zeros((0, 2), np.int32),
            method=method,
            max_wedge_chunk=max_wedge_chunk,
            mesh=mesh,
            device=dev,
        )
    timings["support"] = time.perf_counter() - t0
    su, sv, ss = sup.top_k(top_k)
    report["support"] = {
        "sum": int(sup.support.sum(dtype=np.int64)),
        "max": int(sup.support.max()) if sup.n_edges else 0,
        "n_chunks": sup.n_chunks,
        "method": sup.method,
        "top_edges": [
            {"u": int(a), "v": int(b), "support": int(s)}
            for a, b, s in zip(su, sv, ss)
        ],
    }

    if include_truss:
        t0 = time.perf_counter()
        with obs.span("report.truss", cat="analytics"):
            dec = k_truss_decomposition(
                csr if csr is not None else np.zeros((0, 2), np.int32),
                max_wedge_chunk=max_wedge_chunk,
                method=method,
                mesh=mesh,
                device=dev,
            )
        timings["truss"] = time.perf_counter() - t0
        report["truss"] = {
            "max_k": dec.max_k,
            "spectrum": {str(k): c for k, c in dec.spectrum().items()},
            "truss_sizes": {str(k): c for k, c in dec.truss_sizes().items()},
            "rounds": dec.rounds,
            "method": dec.method,
        }

    # Compressed inputs count in relabeled (locality-ordered) ids; map every
    # node id in the report back through the stored inverse permutation so
    # callers always see the original graph's ids.
    new_to_old = getattr(graph, "new_to_old", None)
    if new_to_old is not None:
        for d in report["clustering"]["top_nodes"]:
            d["node"] = int(new_to_old[d["node"]])
        for d in report["support"]["top_edges"]:
            d["u"] = int(new_to_old[d["u"]])
            d["v"] = int(new_to_old[d["v"]])

    report["timings_s"] = timings
    return report
