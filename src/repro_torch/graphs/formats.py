"""Edge-array graph format utilities (host side, NumPy).

The paper (§III-A) argues for the *edge array* as the canonical input
format: an ``(m, 2)`` array of vertex-id pairs, no self loops, no
multi-edges, every undirected edge present exactly twice (once per
direction).  All generators and loaders in :mod:`repro_torch.graphs` normalize to
this representation via :func:`canonicalize_edges`.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "canonicalize_edges",
    "validate_node_ids",
    "sorted_unique",
    "pack_unique_keys",
    "unpack_keys_canonical",
    "edge_array_to_csr",
    "csr_from_forward_pairs",
    "csr_to_edge_array",
    "undirected_edge_count",
    "validate_edge_array",
    "graph_stats",
    "stats_from_degrees",
]


def validate_node_ids(edges: np.ndarray, *, context: str = "edge list") -> None:
    """Raise ``ValueError`` unless every id is in ``[0, 2**31)``.

    The single guard for every ``lo << 32 | hi`` packed-key site
    (:func:`pack_unique_keys`, the DOULION sparsifier, the incremental
    counter's adjacency, the streaming parsers): outside this range the
    packed key wraps — ``lo << 32`` wraps negative or ≥ 2³¹ ids and ``|``
    with a negative ``hi`` sets the sign bits — silently merging distinct
    edges.  ``context`` lets callers localize the error (e.g. a parser's
    line hint).
    """
    edges = np.asarray(edges)
    if edges.size == 0:
        return
    lo_id, hi_id = int(edges.min()), int(edges.max())
    if lo_id < 0:
        raise ValueError(
            f"negative node id {lo_id} in {context}; node ids must be "
            "non-negative integers"
        )
    if hi_id > 2**31 - 1:
        raise ValueError(
            f"node id {hi_id} exceeds 2**31-1 in {context}; the 64-bit "
            "packed-key sort (§III-D2) requires ids < 2**31"
        )


def sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` of a 1-D key array, by a sort and a compare of
    neighbours.  numpy 2.3's ``np.unique`` finds the values with a hash
    table first, which takes minutes on tens of millions of distinct
    64-bit keys where the sort takes about a second."""
    keys = np.sort(np.asarray(keys).reshape(-1))
    keep = np.empty(keys.shape, bool)
    keep[:1] = True
    np.not_equal(keys[1:], keys[:-1], out=keep[1:])
    return keys[keep]


def pack_unique_keys(edges: np.ndarray) -> np.ndarray:
    """Validate ids, drop self loops, and pack pairs into sorted-unique
    64-bit keys (``lo << 32 | hi`` — the paper's thrust::sort trick,
    §III-D2: a single-key sort instead of a lexicographic pair sort).

    Shared by :func:`canonicalize_edges` and the out-of-core per-chunk
    path (:mod:`repro_torch.graphs.io.external`), so the two stay bit-identical
    by construction.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    validate_node_ids(edges)
    edges = edges[edges[:, 0] != edges[:, 1]]  # drop self loops
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    return sorted_unique(lo << np.int64(32) | hi)


def unpack_keys_canonical(key: np.ndarray, dtype=np.int32) -> np.ndarray:
    """Sorted-unique packed keys → canonical edge array (fwd block, then
    bwd block — the inverse of :func:`pack_unique_keys`)."""
    lo = (key >> np.int64(32)).astype(dtype)
    hi = (key & np.int64(0xFFFFFFFF)).astype(dtype)
    fwd = np.stack([lo, hi], axis=1)
    bwd = np.stack([hi, lo], axis=1)
    return np.concatenate([fwd, bwd], axis=0)


def canonicalize_edges(edges: np.ndarray, *, dtype=np.int32) -> np.ndarray:
    """Normalize raw edge pairs to the paper's canonical edge array.

    Removes self loops, deduplicates multi-edges, and emits every
    undirected edge exactly twice (both directions).  Input may contain an
    arbitrary mix of directions and duplicates.  Raises ``ValueError`` on
    negative or ≥ 2³¹ node ids, which the key packing cannot represent.
    """
    return unpack_keys_canonical(pack_unique_keys(edges), dtype)


def validate_edge_array(edges: np.ndarray) -> None:
    """Raise ``ValueError`` unless ``edges`` is a canonical edge array."""
    edges = np.asarray(edges)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edge array must be (m, 2); got {edges.shape}")
    if edges.shape[0] % 2 != 0:
        raise ValueError("canonical edge array must have an even number of rows")
    if (edges[:, 0] == edges[:, 1]).any():
        raise ValueError("edge array contains self loops")
    key = edges[:, 0].astype(np.int64) << 32 | edges[:, 1].astype(np.int64)
    if np.unique(key).size != key.size:
        raise ValueError("edge array contains duplicate edges")
    rev = edges[:, 1].astype(np.int64) << 32 | edges[:, 0].astype(np.int64)
    if not np.array_equal(np.sort(key), np.sort(rev)):
        raise ValueError("edge array is not symmetric (each edge must appear twice)")


def undirected_edge_count(edges: np.ndarray) -> int:
    return int(np.asarray(edges).shape[0]) // 2


def edge_array_to_csr(edges: np.ndarray, n_nodes: int | None = None):
    """Convert a canonical edge array to CSR ``(row_offsets, col)``.

    The paper notes (§III-A) this direction requires a sort and is the
    expensive conversion; we provide it for interop and for the GNN stack.
    """
    edges = np.asarray(edges)
    if n_nodes is None:
        n_nodes = int(edges.max()) + 1 if edges.size else 0
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    sorted_edges = edges[order]
    row_offsets = np.searchsorted(sorted_edges[:, 0], np.arange(n_nodes + 1))
    return row_offsets.astype(np.int64), sorted_edges[:, 1].copy()


def csr_from_forward_pairs(lo: np.ndarray, hi: np.ndarray, n_nodes: int):
    """Sort-free undirected CSR from sorted-unique forward pairs.

    ``(lo, hi)`` are the ``lo < hi`` halves of a canonical edge array in
    packed-key order (sorted by ``(lo, hi)``) — exactly what the
    canonicalization pipelines produce.  Output is bit-identical to
    ``edge_array_to_csr(canonical_edges, n_nodes)`` but needs no
    ``lexsort`` over the ``2m`` rows: row ``u`` is [partners < u] ++
    [partners > u], where the first block comes from keys with
    ``hi == u`` (their ``lo`` ascend in scan order) and the second from
    keys with ``lo == u`` (their ``hi`` ascend) — only a stable single-key
    argsort of ``hi`` is needed to group the first block.  This is the
    ingestion fast path: at SNAP scale the pair lexsort's index+copy
    would dwarf the CSR being built.
    """
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    m = lo.shape[0]
    deg_gt = np.bincount(lo, minlength=n_nodes)  # partners greater than u
    deg_lt = np.bincount(hi, minlength=n_nodes)  # partners less than u
    row_offsets = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg_lt + deg_gt, out=row_offsets[1:])
    col = np.empty(2 * m, np.int32)
    # greater-than block: keys are grouped by lo with hi ascending, so the
    # in-group rank is position minus the group's start in key order
    lo_group_start = np.concatenate([[0], np.cumsum(deg_gt)])
    rank = np.arange(m, dtype=np.int64) - lo_group_start[lo]
    col[row_offsets[lo] + deg_lt[lo] + rank] = hi
    # less-than block: group by hi (stable keeps lo ascending in-group)
    order = np.argsort(hi, kind="stable")
    hi_group_start = np.concatenate([[0], np.cumsum(deg_lt)])
    hi_sorted = hi[order]
    rank = np.arange(m, dtype=np.int64) - hi_group_start[hi_sorted]
    col[row_offsets[hi_sorted] + rank] = lo[order]
    return row_offsets, col


def csr_to_edge_array(row_offsets: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Single-pass CSR → edge array conversion (the cheap direction)."""
    n = row_offsets.shape[0] - 1
    src = np.repeat(np.arange(n, dtype=col.dtype), np.diff(row_offsets))
    return np.stack([src, col], axis=1)


def stats_from_degrees(deg: np.ndarray, n_nodes: int) -> dict:
    """The :func:`graph_stats` dict computed from an undirected degree
    histogram (shared with ``repro_torch.graphs.io.CSRGraph.stats``, which has
    degrees but no edge array)."""
    deg = np.asarray(deg, dtype=np.int64)
    if deg.size == 0:
        return dict(n_nodes=0, n_edges=0, max_degree=0, mean_degree=0.0,
                    skew=0.0, total_wedges=0)
    mean = float(deg.mean())
    return dict(
        n_nodes=n_nodes,
        n_edges=int(deg.sum()) // 2,
        max_degree=int(deg.max()),
        mean_degree=mean,
        skew=float(deg.max() / max(mean, 1e-9)),
        total_wedges=int((deg * (deg - 1) // 2).sum()),
    )


def graph_stats(edges: np.ndarray) -> dict:
    """Host-side summary statistics of the *undirected* graph.

    Returns ``n_nodes``, ``n_edges`` (undirected), ``max_degree``,
    ``mean_degree``, ``skew`` (max/mean degree — the §III-C load-imbalance
    proxy) and ``total_wedges`` (Σ deg·(deg−1)/2 — the transitivity
    denominator).  Note these are undirected quantities; the engine's
    budgeted workload is the smaller *oriented* Σ deg⁺, reported after a
    run as ``TriangleCounter.last_stats.total_wedges``.
    """
    edges = np.asarray(edges)
    if edges.size == 0:
        return stats_from_degrees(np.empty((0,), np.int64), 0)
    n = int(edges.max()) + 1
    deg = np.bincount(edges[:, 0], minlength=n).astype(np.int64)
    return stats_from_degrees(deg, n)
