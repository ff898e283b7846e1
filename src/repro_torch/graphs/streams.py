"""Edge streams: reproducible insert/delete batches for dynamic counting.

The serving workload (ROADMAP north star) sees graphs that *change*:
edges arrive with timestamps, old edges expire.  These generators turn
any static canonical edge array into a deterministic stream of
:class:`StreamBatch` updates for
:class:`repro_torch.core.incremental.IncrementalTriangleCounter`:

``temporal_edge_stream``
    Replay the graph as an arrival process — undirected edges shuffled
    into a seeded "timestamp" order, yielded as insert-only batches.
``sliding_window_stream``
    The same arrival order, but only the most recent ``window`` edges
    stay live: each batch pairs the arrivals with the evictions that
    fall out of the window, exercising insert *and* delete paths.

Everything is deterministic given ``seed`` — a stream can be replayed
bit-for-bit for the from-scratch oracle comparison in the tests.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from .formats import sorted_unique

__all__ = [
    "StreamBatch",
    "undirected_pairs",
    "temporal_edge_stream",
    "sliding_window_stream",
    "STREAM_GENERATORS",
]

_EMPTY = np.empty((0, 2), np.int64)


class StreamBatch(NamedTuple):
    """One update batch: arrivals then evictions (applied in that order)."""

    insert: np.ndarray  # (b_i, 2) undirected pairs
    delete: np.ndarray  # (b_d, 2) undirected pairs

    @property
    def size(self) -> int:
        return self.insert.shape[0] + self.delete.shape[0]


def undirected_pairs(edges: np.ndarray) -> np.ndarray:
    """Unique undirected (lo, hi) pairs of an edge array (any direction mix)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    edges = edges[edges[:, 0] != edges[:, 1]]
    if edges.shape[0] == 0:
        return _EMPTY.copy()
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    keys = sorted_unique(lo << np.int64(32) | hi)
    return np.stack([keys >> np.int64(32), keys & np.int64(0xFFFFFFFF)], axis=1)


def temporal_edge_stream(
    edges: np.ndarray, batch_size: int = 256, seed: int = 0
) -> Iterator[StreamBatch]:
    """Replay a static graph as a timestamped arrival stream.

    Shuffles the undirected edges with a seeded permutation (the
    synthetic timestamp order) and yields insert-only batches until the
    whole graph has arrived.
    """
    if batch_size < 1:
        raise ValueError("batch_size must be positive")
    und = undirected_pairs(edges)
    order = np.random.default_rng(seed).permutation(und.shape[0])
    for i in range(0, und.shape[0], batch_size):
        yield StreamBatch(insert=und[order[i : i + batch_size]], delete=_EMPTY)


def sliding_window_stream(
    edges: np.ndarray, window: int, batch_size: int = 256, seed: int = 0
) -> Iterator[StreamBatch]:
    """Arrival stream where only the ``window`` most recent edges stay live.

    Same seeded timestamp order as :func:`temporal_edge_stream`; each
    batch inserts the next arrivals and deletes the oldest live edges
    that the window no longer covers, so after batch ``k`` exactly
    ``min(k·batch_size, window)``-ish edges are live.
    """
    if batch_size < 1:
        raise ValueError("batch_size must be positive")
    if window < 1:
        raise ValueError("window must be positive")
    und = undirected_pairs(edges)
    order = np.random.default_rng(seed).permutation(und.shape[0])
    oldest = 0
    for i in range(0, und.shape[0], batch_size):
        ins = und[order[i : i + batch_size]]
        live_hi = i + ins.shape[0]
        new_oldest = max(0, live_hi - window)
        dele = und[order[oldest:new_oldest]] if new_oldest > oldest else _EMPTY
        oldest = new_oldest
        yield StreamBatch(insert=ins, delete=dele)


STREAM_GENERATORS = {
    "temporal": temporal_edge_stream,
    "sliding_window": sliding_window_stream,
}
