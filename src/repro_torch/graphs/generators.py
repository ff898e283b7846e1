"""Synthetic graph generators (the paper's evaluation suite, §IV).

All generators return a canonical edge array (see
:mod:`repro_torch.graphs.formats`): ``(m, 2)`` int32, symmetric, deduplicated, no
self loops.  Everything is deterministic given ``seed``.

The paper evaluates on Kronecker (R-MAT) graphs of scale 16–21,
a Barabási–Albert network and a Watts–Strogatz network; we reproduce all
three families plus Erdős–Rényi as a low-skew control.
"""
from __future__ import annotations

import numpy as np

from .formats import canonicalize_edges

__all__ = [
    "kronecker_rmat",
    "barabasi_albert",
    "watts_strogatz",
    "erdos_renyi",
    "GRAPH_GENERATORS",
]


def kronecker_rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> np.ndarray:
    """R-MAT / stochastic Kronecker generator (Graph500 parameters).

    ``n = 2**scale`` vertices, ``edge_factor * n`` sampled edge slots before
    dedup.  Matches the DIMACS-10 Kronecker family used in the paper.
    """
    rng = np.random.default_rng(seed)
    n_edges = edge_factor << scale
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for bit in range(scale):
        r1 = rng.random(n_edges)
        r2 = rng.random(n_edges)
        src_bit = r1 > ab
        dst_bit = r2 > np.where(src_bit, c_norm, a_norm)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # Permute vertex labels so degree does not correlate with id.
    perm = rng.permutation(1 << scale)
    return canonicalize_edges(np.stack([perm[src], perm[dst]], axis=1))


def barabasi_albert(n: int, m_attach: int = 8, seed: int = 0) -> np.ndarray:
    """Barabási–Albert preferential attachment.

    Uses the repeated-endpoint-list trick: sampling uniformly from the
    flat list of all edge endpoints is sampling proportional to degree.
    """
    rng = np.random.default_rng(seed)
    if n <= m_attach:
        raise ValueError("need n > m_attach")
    # Seed clique over the first m_attach+1 vertices.
    seed_nodes = np.arange(m_attach + 1)
    src0, dst0 = np.meshgrid(seed_nodes, seed_nodes)
    mask = src0 < dst0
    edges = [np.stack([src0[mask], dst0[mask]], axis=1)]
    endpoints = list(np.concatenate([src0[mask], dst0[mask]]))
    targets_flat = np.array(endpoints, dtype=np.int64)
    # Grow in chunks: amortize the endpoint-list rebuild.
    buf = [targets_flat]
    flat = targets_flat
    for v in range(m_attach + 1, n):
        # sample m_attach distinct targets preferentially
        picks = flat[rng.integers(0, flat.shape[0], size=4 * m_attach)]
        picks = np.unique(picks)[:m_attach]
        while picks.shape[0] < m_attach:  # pragma: no cover - rare fallback
            extra = flat[rng.integers(0, flat.shape[0], size=4 * m_attach)]
            picks = np.unique(np.concatenate([picks, extra]))[:m_attach]
        e = np.stack([np.full(m_attach, v, dtype=np.int64), picks], axis=1)
        edges.append(e)
        buf.append(np.concatenate([e[:, 0], e[:, 1]]))
        if len(buf) >= 64:
            flat = np.concatenate(buf)
            buf = [flat]
        else:
            flat = np.concatenate([flat, buf[-1]])
    return canonicalize_edges(np.concatenate(edges, axis=0))


def watts_strogatz(n: int, k: int = 50, beta: float = 0.1, seed: int = 0) -> np.ndarray:
    """Watts–Strogatz small-world graph: ring lattice + random rewiring."""
    rng = np.random.default_rng(seed)
    if k % 2 != 0:
        raise ValueError("k must be even")
    base = np.arange(n, dtype=np.int64)
    src = np.repeat(base, k // 2)
    offs = np.tile(np.arange(1, k // 2 + 1, dtype=np.int64), n)
    dst = (src + offs) % n
    rewire = rng.random(src.shape[0]) < beta
    dst = np.where(rewire, rng.integers(0, n, size=src.shape[0]), dst)
    return canonicalize_edges(np.stack([src, dst], axis=1))


def erdos_renyi(n: int, m: int, seed: int = 0) -> np.ndarray:
    """G(n, m)-style random graph (sampled with replacement then deduped)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=int(1.1 * m) + 16)
    dst = rng.integers(0, n, size=src.shape[0])
    return canonicalize_edges(np.stack([src, dst], axis=1))


GRAPH_GENERATORS = {
    "kronecker": kronecker_rmat,
    "barabasi_albert": barabasi_albert,
    "watts_strogatz": watts_strogatz,
    "erdos_renyi": erdos_renyi,
}
