"""Reference baselines the paper compares against.

* :func:`count_triangles_sequential` — the paper's own baseline: a faithful
  single-threaded *forward* algorithm with a two-pointer merge.  Pure
  Python; use only on small graphs (tests / small benchmark rows).
* :func:`count_triangles_numpy` — an "optimized CPU implementation" in
  vectorized NumPy, the realistic CPU contender for the speedup tables.
* :func:`count_triangles_bruteforce` — O(n³) dense oracle for tests.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "count_triangles_sequential",
    "count_triangles_numpy",
    "count_triangles_bruteforce",
]


def _orient_numpy(edges: np.ndarray):
    edges = np.asarray(edges)
    n = int(edges.max()) + 1 if edges.size else 0
    deg = np.bincount(edges[:, 0], minlength=n)
    u, v = edges[:, 0], edges[:, 1]
    keep = (deg[u] < deg[v]) | ((deg[u] == deg[v]) & (u < v))
    d = edges[keep]
    order = np.lexsort((d[:, 1], d[:, 0]))
    d = d[order]
    offsets = np.searchsorted(d[:, 0], np.arange(n + 1))
    return offsets, d[:, 0].copy(), d[:, 1].copy()


def count_triangles_sequential(edges: np.ndarray) -> int:
    """Single-threaded forward algorithm, two-pointer merge (paper §II-B)."""
    offsets, src, col = _orient_numpy(edges)
    count = 0
    for p in range(src.shape[0]):
        u, v = int(src[p]), int(col[p])
        i, i_end = int(offsets[u]), int(offsets[u + 1])
        j, j_end = int(offsets[v]), int(offsets[v + 1])
        while i < i_end and j < j_end:
            d = int(col[i]) - int(col[j])
            if d <= 0:
                i += 1
            if d >= 0:
                j += 1
            if d == 0:
                count += 1
    return count


def count_triangles_numpy(edges: np.ndarray) -> int:
    """Vectorized NumPy forward count (wedge expansion + searchsorted)."""
    offsets, src, col = _orient_numpy(edges)
    out_deg = np.diff(offsets)
    reps = out_deg[src]
    edge_id = np.repeat(np.arange(src.shape[0]), reps)
    starts = np.cumsum(reps) - reps
    pos = np.arange(edge_id.shape[0]) - starts[edge_id]
    u = src[edge_id]
    v = col[edge_id]
    w = col[offsets[u] + pos]
    count = 0
    # chunk to bound peak memory on large graphs
    chunk = 1 << 24
    for s in range(0, w.shape[0], chunk):
        vv, ww = v[s : s + chunk], w[s : s + chunk]
        # col is sorted within each CSR segment; binary-search per segment.
        lo = offsets[vv]
        hi = offsets[vv + 1]
        # vectorized binary search
        while True:
            active = lo < hi
            if not active.any():
                break
            mid = (lo + hi) >> 1
            below = col[np.minimum(mid, col.shape[0] - 1)] < ww
            go = active & below
            stay = active & ~below
            lo = np.where(go, mid + 1, lo)
            hi = np.where(stay, mid, hi)
        found = (lo < offsets[vv + 1]) & (col[np.minimum(lo, col.shape[0] - 1)] == ww)
        count += int(found.sum(dtype=np.int64))
    return count


def count_triangles_bruteforce(edges: np.ndarray, n_nodes: int | None = None) -> int:
    """Dense O(n³) oracle: trace(A³)/6.  Tests only."""
    edges = np.asarray(edges)
    if edges.size == 0:
        return 0
    n = n_nodes or int(edges.max()) + 1
    a = np.zeros((n, n), dtype=np.int64)
    a[edges[:, 0], edges[:, 1]] = 1
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0)
    return int(np.trace(a @ a @ a)) // 6
