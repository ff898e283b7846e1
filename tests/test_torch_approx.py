"""Port parity: repro_torch's DOULION estimator equals the reference's.

The sampler is the reference's numpy generator over the same packed
undirected keys, so one ``(p, seed)`` keeps the same edge set in both
packages and the estimates are equal floats (tolerance 0).  Every port
method (``wedge_bsearch``, ``panel``, ``pallas``, ``auto``) at an
unbounded and a small budget, on ``small_graphs`` and karate, is held
against the reference's estimate; the reference's own tests pin its
methods and budgets equal, so its estimate comes from its unchunked wedge
schedule (and, once per graph, from its Pallas kernel in interpret mode).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import count_triangles_doulion as ref_doulion  # noqa: E402
from repro.graphs.io import ingest  # noqa: E402
from repro_torch.core import count_triangles_doulion  # noqa: E402

KARATE = os.path.join(os.path.dirname(__file__), "data", "karate.txt")
METHODS = ("wedge_bsearch", "panel", "pallas", "auto")
PS = (1.0, 0.5, 0.25)
SEEDS = (0, 1, 2)
NAMES = ("er", "kron", "ws", "triangle", "karate")


@pytest.fixture(scope="module")
def graphs(small_graphs):
    return {**small_graphs, "karate": ingest(KARATE)[0].edge_array()}


@pytest.fixture(scope="module")
def reference(graphs):
    """The reference's estimate per (graph, p, seed), computed once."""
    cache = {}

    def get(name, p, seed):
        key = (name, p, seed if p < 1.0 else 0)  # p = 1.0 is the exact count
        if key not in cache:
            cache[key] = ref_doulion(graphs[name], p=p, seed=seed, method="wedge_bsearch")
        return cache[key]

    return get


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", NAMES)
def test_estimate_equals_reference(graphs, reference, name, p, method):
    edges = graphs[name]
    for seed in SEEDS:
        want = reference(name, p, seed)
        for budget in (None, 512):
            got = count_triangles_doulion(edges, p=p, seed=seed, method=method,
                                          max_wedge_chunk=budget, device="cpu")
            assert type(got) is type(want), (seed, budget)
            assert got == want, (seed, budget)


@pytest.mark.parametrize("name", NAMES)
def test_reference_pallas_agrees(graphs, reference, name):
    """The reference's own Pallas path (interpret mode) gives the same
    estimate the port is held to."""
    want = ref_doulion(graphs[name], p=0.5, seed=1, method="pallas", max_wedge_chunk=512)
    assert want == reference(name, 0.5, 1)
    assert count_triangles_doulion(graphs[name], p=0.5, seed=1, method="pallas",
                                   max_wedge_chunk=512, device="cpu") == want


def test_p_one_is_the_exact_int(graphs):
    got = count_triangles_doulion(graphs["karate"], p=1.0, method="pallas", device="cpu")
    assert type(got) is int and got == 45


def test_tensor_input_equals_numpy_input(graphs):
    edges = graphs["kron"]
    want = count_triangles_doulion(edges, p=0.5, seed=2, device="cpu")
    assert count_triangles_doulion(torch.from_numpy(edges), p=0.5, seed=2, device="cpu") == want


def test_empty_graph():
    empty = np.zeros((0, 2), np.int32)
    one = count_triangles_doulion(empty, p=1.0, device="cpu")
    assert type(one) is int and one == 0
    half = count_triangles_doulion(empty, p=0.5, device="cpu")
    assert type(half) is float and half == 0.0
    assert ref_doulion(empty, p=0.5) == half


@pytest.mark.parametrize("p", [0.0, -0.1, 1.5])
def test_p_outside_the_unit_interval_raises(graphs, p):
    with pytest.raises(ValueError, match="p must be in"):
        count_triangles_doulion(graphs["triangle"], p=p, device="cpu")


def test_negative_ids_raise():
    with pytest.raises(ValueError, match="negative node id"):
        count_triangles_doulion(np.array([[-1, 2], [2, -1]], np.int32), p=0.5, device="cpu")


def test_default_device_is_the_card(graphs, reference):
    """``device=None`` means the card: without one it raises and says how
    to ask for the CPU; with one it gives the reference's estimate."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            count_triangles_doulion(graphs["triangle"], p=0.5)
        return
    assert count_triangles_doulion(graphs["kron"], p=0.5, seed=0) == reference("kron", 0.5, 0)
