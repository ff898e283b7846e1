"""DOULION-style approximate triangle counting (paper §V comparison).

The PyTorch counterpart of ``repro.core.approx``: keep every undirected
edge with probability ``p`` and rescale the sparsified count by ``1/p³``
(Tsourakakis et al., KDD'09).  The sparsified graph is counted by the
exact engine, so the estimator takes every engine schedule
(``method="auto"`` included), honors ``max_wedge_chunk`` and runs on the
counter's device.  The sampler is the reference's numpy generator over
the same keys, so one ``(p, seed)`` keeps the same edge set in both
packages and the estimates are equal bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import validate_node_ids

from .engine import TriangleCounter, _host

__all__ = ["count_triangles_doulion"]


def count_triangles_doulion(
    edges,
    p: float = 0.25,
    seed: int = 0,
    method: str = "auto",
    max_wedge_chunk: int | None = None,
    *,
    device=None,
) -> float | int:
    """DOULION estimate of the triangle count.

    ``edges`` is a canonical edge array (numpy or a tensor).  ``method``
    and ``max_wedge_chunk`` configure the :class:`TriangleCounter` that
    counts the kept edges on ``device`` (``None``: the card).  ``p ==
    1.0`` keeps every edge: the result is the exact count, as an ``int``.
    """
    if not 0.0 < p <= 1.0:
        raise ValueError("p must be in (0, 1]")
    edges = _host(edges)
    if edges.size == 0:
        return 0 if p == 1.0 else 0.0
    validate_node_ids(edges)  # wrapped packed keys / int32 casts corrupt silently
    tc = TriangleCounter(method=method, max_wedge_chunk=max_wedge_chunk, device=device)
    n_nodes = int(edges.max()) + 1
    if p == 1.0:  # no sparsification — exact count, exact type
        return tc.count(edges, n_nodes=n_nodes)
    rng = np.random.default_rng(seed)
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    key = lo.astype(np.int64) << 32 | hi.astype(np.int64)
    uniq, inverse = np.unique(key, return_inverse=True)
    keep_undirected = rng.random(uniq.shape[0]) < p
    kept = edges[keep_undirected[inverse]]
    if kept.size == 0:
        return 0.0
    t = tc.count(kept, n_nodes=n_nodes)
    return float(t) / p**3
