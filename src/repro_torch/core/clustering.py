"""Clustering coefficient and transitivity ratio (the paper's motivating
applications, §I) — thin wrappers over :mod:`repro_torch.analytics.metrics`.

Every function routes through :class:`repro_torch.core.TriangleCounter`,
accepts raw canonical edge arrays, ``OrientedCSR`` objects and cached CSR
files alike, and takes the engine's ``method`` / ``max_wedge_chunk`` /
``device`` knobs (``device=None``: the card).
"""
from __future__ import annotations

import numpy as np

from repro_torch.analytics.metrics import (
    average_clustering,
    clustering_from_counts,
    local_clustering,
    node_triangle_features as _node_triangle_features,
    transitivity as _transitivity,
    transitivity_from_counts,
)

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
    return local_clustering(
        edges, n_nodes, method=method, max_wedge_chunk=max_wedge_chunk, device=device
    )


def average_clustering_coefficient(
    edges, n_nodes: int | None = None, *, method: str = "auto",
    max_wedge_chunk: int | None = None, device=None,
) -> float:
    """Mean of the local clustering coefficients (Watts–Strogatz C̄)."""
    return average_clustering(
        edges, n_nodes, method=method, max_wedge_chunk=max_wedge_chunk, device=device
    )


def transitivity(
    edges, n_nodes: int | None = None, *, method: str = "auto",
    max_wedge_chunk: int | None = None, device=None,
) -> float:
    """3·#triangles / #wedges (the transitivity ratio)."""
    return _transitivity(
        edges, n_nodes, method=method, max_wedge_chunk=max_wedge_chunk, device=device
    )


def node_triangle_features(
    edges, n_nodes: int | None = None, *, method: str = "auto",
    max_wedge_chunk: int | None = None, device=None,
) -> np.ndarray:
    """(n, 3) float32 per-node feature block [degree, triangles, clustering]."""
    return _node_triangle_features(
        edges, n_nodes, method=method, max_wedge_chunk=max_wedge_chunk, device=device
    )
