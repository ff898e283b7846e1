"""Batched small-graph collation (the GNN ``molecule`` shape).

A copy of ``repro.graphs.batching`` (numpy only), so the port imports
nothing of the reference; outputs are bit-equal to its.

Graphs are padded to a fixed ``(max_nodes, max_edges)`` and stacked; a
``graph_id`` segment vector drives per-graph readout via ``segment_sum``.
Edges of padded slots point at a sink node with zero features.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

__all__ = ["GraphBatch", "collate_graphs", "random_molecule_batch"]


class GraphBatch(NamedTuple):
    """A batch of B graphs padded to fixed size.

    node_feat:  (B, max_nodes, d)   float32
    positions:  (B, max_nodes, 3)   float32 (for geometric models)
    edge_src:   (B, max_edges)      int32, −1 padded
    edge_dst:   (B, max_edges)      int32, −1 padded
    node_mask:  (B, max_nodes)      bool
    edge_mask:  (B, max_edges)      bool
    """

    node_feat: np.ndarray
    positions: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    node_mask: np.ndarray
    edge_mask: np.ndarray


def collate_graphs(
    graphs: Sequence[dict], max_nodes: int, max_edges: int, d_feat: int
) -> GraphBatch:
    b = len(graphs)
    node_feat = np.zeros((b, max_nodes, d_feat), np.float32)
    positions = np.zeros((b, max_nodes, 3), np.float32)
    edge_src = np.full((b, max_edges), -1, np.int32)
    edge_dst = np.full((b, max_edges), -1, np.int32)
    node_mask = np.zeros((b, max_nodes), bool)
    edge_mask = np.zeros((b, max_edges), bool)
    for i, g in enumerate(graphs):
        n = g["node_feat"].shape[0]
        e = g["edges"].shape[0]
        if n > max_nodes or e > max_edges:
            raise ValueError(f"graph {i} exceeds padding budget ({n},{e})")
        node_feat[i, :n] = g["node_feat"]
        if "positions" in g:
            positions[i, :n] = g["positions"]
        edge_src[i, :e] = g["edges"][:, 0]
        edge_dst[i, :e] = g["edges"][:, 1]
        node_mask[i, :n] = True
        edge_mask[i, :e] = True
    return GraphBatch(node_feat, positions, edge_src, edge_dst, node_mask, edge_mask)


def random_molecule_batch(
    batch: int, n_nodes: int, n_edges: int, d_feat: int, seed: int = 0
) -> GraphBatch:
    """Deterministic synthetic molecule-like batch (radius-graph style)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(batch):
        pos = rng.normal(size=(n_nodes, 3)).astype(np.float32)
        # connect nearest neighbors until n_edges directed edges exist
        d2 = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        k = max(1, n_edges // n_nodes)
        nbrs = np.argsort(d2, axis=1)[:, :k]
        src = np.repeat(np.arange(n_nodes), k)
        dst = nbrs.reshape(-1)
        edges = np.stack([src, dst], 1)[:n_edges]
        feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
        graphs.append({"node_feat": feat, "positions": pos, "edges": edges})
    return collate_graphs(graphs, n_nodes, n_edges, d_feat)
