"""Clustering coefficient and transitivity ratio (the paper's motivating
applications, §I), routed through :class:`repro_torch.core.TriangleCounter`.

Each function accepts raw canonical edge arrays, ``OrientedCSR`` objects
and cached CSR files alike, and takes the engine's ``method`` /
``max_wedge_chunk`` / ``device`` knobs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analytics.metrics import clustering_from_counts, transitivity_from_counts

from .engine import TriangleCounter, degree_histogram

__all__ = [
    "clustering_from_counts",
    "transitivity_from_counts",
    "local_clustering_coefficient",
    "average_clustering_coefficient",
    "transitivity",
    "node_triangle_features",
]


def local_clustering_coefficient(
    edges, n_nodes: int | None = None, *, method: str = "auto",
    max_wedge_chunk: int | None = None, device=None,
) -> np.ndarray:
    """c(v) = 2·T(v) / (deg(v)·(deg(v)−1)); 0 where degree < 2."""
    tc = TriangleCounter(method=method, max_wedge_chunk=max_wedge_chunk, device=device)
    return tc.clustering(edges, n_nodes)


def average_clustering_coefficient(
    edges, n_nodes: int | None = None, *, method: str = "auto",
    max_wedge_chunk: int | None = None, device=None,
) -> float:
    """Mean of the local clustering coefficients (Watts–Strogatz C̄)."""
    cc = local_clustering_coefficient(
        edges, n_nodes, method=method, max_wedge_chunk=max_wedge_chunk, device=device
    )
    return float(cc.mean()) if cc.size else 0.0


def transitivity(
    edges, n_nodes: int | None = None, *, method: str = "auto",
    max_wedge_chunk: int | None = None, device=None,
) -> float:
    """3·#triangles / #wedges (the transitivity ratio)."""
    tc = TriangleCounter(method=method, max_wedge_chunk=max_wedge_chunk, device=device)
    return tc.transitivity(edges, n_nodes)


def node_triangle_features(
    edges, n_nodes: int | None = None, *, method: str = "auto",
    max_wedge_chunk: int | None = None, device=None,
) -> np.ndarray:
    """(n, 3) float32 per-node feature block [degree, triangles, clustering]."""
    deg, n_nodes = degree_histogram(edges, n_nodes)
    if deg.size:
        tc = TriangleCounter(method=method, max_wedge_chunk=max_wedge_chunk, device=device)
        tri = tc.per_node(edges, n_nodes)
        cc = clustering_from_counts(tri, deg)
    else:
        tri = np.zeros((n_nodes,), np.int64)
        cc = np.zeros((n_nodes,))
    return np.stack(
        [deg.astype(np.float32), tri.astype(np.float32), cc.astype(np.float32)], axis=1
    )
