"""The benchmark's Kronecker generator: repeatable per seed, canonical output."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tcbench.gen.kronecker import canonical, kronecker_slots, make_graph, make_graphs, seeded

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def small(name: str, scale: int = 10) -> dict:
    return dict(json.loads((CONFIGS / f"{name}.json").read_text()), scale=scale)


def assert_canonical(g):
    e = g.edges
    assert e.dtype == np.int32 and e.ndim == 2 and e.shape[1] == 2
    m = e.shape[0] // 2
    assert e.shape[0] == 2 * m == 2 * g.n_edges
    fwd, bwd = e[:m], e[m:]
    assert (fwd[:, 0] < fwd[:, 1]).all(), "loop-free, lo < hi in the forward block"
    np.testing.assert_array_equal(bwd, fwd[:, ::-1])
    key = fwd[:, 0].astype(np.int64) << 32 | fwd[:, 1].astype(np.int64)
    assert (np.diff(key) > 0).all(), "sorted and duplicate-free"
    deg = np.bincount(e[:, 0], minlength=g.n_nodes)
    assert deg.shape[0] == g.n_nodes
    assert int((deg > 0).sum()) == g.n_vertices


@pytest.mark.parametrize("name", ["graph500-22", "kron-g500-logn21"])
def test_repeats_per_seed(name):
    cfg = small(name)
    a = make_graph(cfg, 2**31 + 7, "cpu")
    b = make_graph(cfg, 2**31 + 7, "cpu")
    c = make_graph(cfg, 2**31 + 8, "cpu")
    np.testing.assert_array_equal(a.edges, b.edges)
    assert a[1:] == b[1:]
    assert not np.array_equal(a.edges, c.edges)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 3, 2**63 + 11, -5])
def test_canonical_loop_free_duplicate_free(seed):
    assert_canonical(make_graph(small("kron-g500-logn21", 9), seed, "cpu"))


def test_compact_ids_drop_isolated_vertices():
    g = make_graph(small("graph500-22", 10), 3, "cpu")
    assert_canonical(g)
    assert g.n_nodes == g.n_vertices < 2**10
    assert np.bincount(g.edges[:, 0], minlength=g.n_nodes).min() >= 1


def test_all_ids_kept_without_compaction():
    g = make_graph(small("kron-g500-logn21", 10), 3, "cpu")
    assert g.n_nodes == 2**10 and g.n_vertices < g.n_nodes


@pytest.mark.parametrize("name", ["graph500-22", "kron-g500-logn21"])
def test_relabelled_copies_are_the_same_graph_under_other_ids(name):
    graphs = make_graphs(small(name), 2**31 + 21, "cpu", 3)
    first = graphs[0]
    assert first.perm is None
    np.testing.assert_array_equal(first.edges, make_graph(small(name), 2**31 + 21, "cpu").edges)
    for g in graphs[1:]:
        assert_canonical(g)
        assert g[1:4] == first[1:4]
        assert sorted(g.perm.tolist()) == list(range(g.n_nodes))
        assert not np.array_equal(g.edges, first.edges)
        renamed = {tuple(e) for e in g.perm[first.edges.astype(np.int64)].tolist()}
        assert renamed == {tuple(e) for e in g.edges.tolist()}
    assert not np.array_equal(graphs[1].perm, graphs[2].perm)


def test_slots_follow_the_initiator():
    # one bit: the quadrants (src bit, dst bit) = 00, 01, 10, 11 come with
    # probabilities A, B, C, D; the relabelling may swap the two ids
    src, dst = kronecker_slots(1, 1 << 15, [0.57, 0.19, 0.19, 0.05], seeded(5, "cpu"), "cpu")
    assert src.numel() == dst.numel() == 1 << 16
    one = 1 if (src == 1).double().mean() < 0.5 else 0
    s, d = src == one, dst == one
    shares = [float((a & b).double().mean()) for a, b in
              ((~s, ~d), (~s, d), (s, ~d), (s, d))]
    np.testing.assert_allclose(shares, [0.57, 0.19, 0.19, 0.05], atol=0.01)


def test_canonical_on_hand_made_slots():
    src = torch.tensor([0, 1, 2, 2, 3, 5, 5], dtype=torch.int64)
    dst = torch.tensor([1, 0, 2, 3, 2, 6, 0], dtype=torch.int64)
    edges, n, n_v, n_e = canonical(src, dst, 8, compact_ids=False)
    assert (n, n_v, n_e) == (8, 6, 4)
    assert edges[:n_e].tolist() == [[0, 1], [0, 5], [2, 3], [5, 6]]
    edges, n, n_v, n_e = canonical(src, dst, 8, compact_ids=True)
    assert (n, n_v, n_e) == (6, 6, 4)
    assert edges[:n_e].tolist() == [[0, 1], [0, 4], [2, 3], [4, 5]]


def test_rejects_an_initiator_that_does_not_sum_to_one():
    with pytest.raises(ValueError):
        kronecker_slots(2, 1, [0.5, 0.2, 0.2, 0.2], seeded(0, "cpu"), "cpu")


@pytest.mark.cuda
def test_repeats_per_seed_on_the_card(card):
    cfg = small("kron-g500-logn21", 16)
    a = make_graph(cfg, 11, card)
    b = make_graph(cfg, 11, card)
    np.testing.assert_array_equal(a.edges, b.edges)
    assert_canonical(a)
