"""Host formulas turning triangle counts into clustering metrics.

The numpy helpers of the reference's ``analytics/metrics.py`` that
:mod:`repro_torch.core.clustering` and the CLI use.  The engine-routed
metrics, support and truss analytics arrive with a later slice.
"""
from __future__ import annotations

import numpy as np

__all__ = ["clustering_from_counts", "transitivity_from_counts", "profile_from_counts"]


def clustering_from_counts(tri: np.ndarray, deg: np.ndarray) -> np.ndarray:
    """c(v) = 2·T(v) / (deg(v)·(deg(v)−1)) from host count/degree arrays."""
    pairs = deg * (deg - 1)
    return np.where(pairs > 0, 2.0 * tri / np.maximum(pairs, 1), 0.0)


def transitivity_from_counts(n_triangles: int, deg: np.ndarray) -> float:
    """3·#triangles / #wedges from a host count and degree array."""
    wedges = int((deg.astype(np.int64) * (deg.astype(np.int64) - 1) // 2).sum())
    return 3.0 * n_triangles / wedges if wedges else 0.0


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
