"""The plain reference against karate, dense matrix algebra and the
Graphalytics definition of the LCC."""
import numpy as np
import pytest
import torch

from tcbench.gen.kronecker import make_graph
from tcbench.reference import lcc, orient, triangles

# Zachary's karate club, 78 undirected edges, 45 triangles
KARATE = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10), (0, 11),
    (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2), (1, 3), (1, 7),
    (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3), (2, 7), (2, 8), (2, 9),
    (2, 13), (2, 27), (2, 28), (2, 32), (3, 7), (3, 12), (3, 13), (4, 6), (4, 10),
    (5, 6), (5, 10), (5, 16), (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33),
    (14, 32), (14, 33), (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32),
    (20, 33), (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33), (28, 31),
    (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32), (31, 33), (32, 33),
]


def canonical(pairs) -> torch.Tensor:
    fwd = torch.tensor(sorted(pairs), dtype=torch.int32)
    return torch.cat([fwd, fwd.flip(1)])


def random_graph(n: int, p: float, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < p, 1)
    lo, hi = np.nonzero(upper)
    return canonical(list(zip(lo.tolist(), hi.tolist())))


def dense(edges: torch.Tensor, n: int) -> np.ndarray:
    a = np.zeros((n, n), np.int64)
    e = edges.numpy()
    a[e[:, 0], e[:, 1]] = 1
    return a


def test_karate_45():
    edges = canonical(KARATE)
    total, counts = triangles(orient(edges, 34))
    assert int(total) == 45
    assert int(counts.sum()) == 3 * 45
    assert int(counts[0]) == 18 and int(counts[33]) == 15


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("budget", [1, 7, 1 << 27])
def test_matches_trace_of_a_cubed(seed, budget):
    n = 40 + 7 * seed
    edges = random_graph(n, 0.15 + 0.05 * (seed % 3), seed)
    a = dense(edges, n)
    a3 = a @ a @ a
    total, counts = triangles(orient(edges, n), budget=budget)
    assert int(total) == np.trace(a3) // 6
    np.testing.assert_array_equal(counts.numpy(), np.diag(a3) // 2)


def test_orientation_keeps_half_by_degree_then_id():
    edges = canonical(KARATE)
    g = orient(edges, 34)
    assert g.key.numel() == len(KARATE)
    deg = g.degree
    rank = lambda x: (int(deg[x]), int(x))  # noqa: E731
    assert all(rank(u) < rank(v) for u, v in zip(g.src.tolist(), g.col.tolist()))
    assert int(g.row_offsets[-1]) == len(KARATE)
    np.testing.assert_array_equal(g.degree.numpy(), np.bincount(edges[:, 0].numpy(), minlength=34))


def graphalytics_lcc(edges: torch.Tensor, n: int) -> np.ndarray:
    """LDBC Graphalytics LCC, undirected: the ordered pairs of neighbours of
    v joined by an edge, over |N(v)| (|N(v)| - 1); 0 where |N(v)| <= 1."""
    nbrs = [set() for _ in range(n)]
    for u, v in edges.tolist():
        nbrs[u].add(v)
    out = np.zeros(n)
    for v in range(n):
        k = len(nbrs[v])
        if k > 1:
            linked = sum(1 for a in nbrs[v] for b in nbrs[v] if a != b and b in nbrs[a])
            out[v] = linked / (k * (k - 1))
    return out


@pytest.mark.parametrize("source", ["karate", "kron"])
def test_lcc_follows_graphalytics(source):
    if source == "karate":
        edges, n = canonical(KARATE), 34
    else:
        cfg = {"generator": "graph500_kronecker", "scale": 8, "edge_factor": 8,
               "initiator": [0.57, 0.19, 0.19, 0.05], "compact_ids": False}
        g = make_graph(cfg, 21, "cpu")
        edges, n = torch.from_numpy(g.edges), g.n_nodes
    o = orient(edges, n)
    _, counts = triangles(o)
    got = lcc(counts, o.degree).numpy()
    want = graphalytics_lcc(edges, n)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float64


def test_float_dtype_accumulates_in_that_type():
    edges = random_graph(30, 0.3, 1)
    total, counts = triangles(orient(edges, 30), dtype=torch.float32)
    assert total.dtype == counts.dtype == torch.float32
    assert lcc(counts, orient(edges, 30).degree).dtype == torch.float32


def test_empty_and_triangle_free():
    path = canonical([(0, 1), (1, 2), (2, 3)])
    total, counts = triangles(orient(path, 4))
    assert int(total) == 0 and counts.tolist() == [0, 0, 0, 0]
    assert lcc(counts, orient(path, 4).degree).tolist() == [0.0, 0.0, 0.0, 0.0]
