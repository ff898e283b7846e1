"""Port parity: repro_torch's edge streams yield the reference's batches.

``temporal_edge_stream``, ``sliding_window_stream`` and
``undirected_pairs`` are numpy only in both packages; the same seeds and
sizes must give the same batches byte for byte (values, dtypes and
shapes), and bad arguments the same errors.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import graphs as ref_graphs  # noqa: E402
from repro_torch import graphs  # noqa: E402

GRAPHS = {
    "kron8": lambda g: g.kronecker_rmat(8, seed=0),
    "barabasi_albert": lambda g: g.barabasi_albert(300, 5, seed=0),
    "watts_strogatz": lambda g: g.watts_strogatz(400, 8, 0.1, seed=0),
}


@pytest.fixture(scope="module")
def edges():
    return {name: make(ref_graphs) for name, make in GRAPHS.items()}


def assert_same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def assert_same_stream(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__ == "StreamBatch"
        assert_same_bytes(g.insert, w.insert)
        assert_same_bytes(g.delete, w.delete)
        assert g.size == w.size


@pytest.mark.parametrize("seed", [0, 9])
@pytest.mark.parametrize("batch_size", [1, 128, 700, 100_000])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_temporal_stream_equals_reference(edges, graph, batch_size, seed):
    e = edges[graph]
    assert_same_stream(graphs.temporal_edge_stream(e, batch_size=batch_size, seed=seed),
                       ref_graphs.temporal_edge_stream(e, batch_size=batch_size, seed=seed))


@pytest.mark.parametrize("seed", [2, 5])
@pytest.mark.parametrize("window,batch_size", [(300, 100), (900, 300), (1, 7), (10**6, 512)])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_sliding_window_stream_equals_reference(edges, graph, window, batch_size, seed):
    e = edges[graph]
    assert_same_stream(
        graphs.sliding_window_stream(e, window=window, batch_size=batch_size, seed=seed),
        ref_graphs.sliding_window_stream(e, window=window, batch_size=batch_size, seed=seed))


def _pair_inputs():
    rng = np.random.default_rng(3)
    return {
        "random_dups_and_loops": rng.integers(0, 20, size=(300, 2)),
        "self_loops_only": np.array([[3, 3], [5, 5]]),
        "empty": np.empty((0, 2), np.int32),
        "flat_int32": np.array([0, 1, 1, 0, 2, 1], np.int32),
        "both_directions": np.array([[0, 1], [1, 0], [2, 1], [1, 2]], np.int64),
    }


@pytest.mark.parametrize("name", sorted(_pair_inputs()) + sorted(GRAPHS))
def test_undirected_pairs_equals_reference(edges, name):
    e = edges[name] if name in GRAPHS else _pair_inputs()[name]
    assert_same_bytes(graphs.undirected_pairs(e), ref_graphs.undirected_pairs(e))


@pytest.mark.parametrize("make", [
    lambda m, e: m.temporal_edge_stream(e, batch_size=0),
    lambda m, e: m.temporal_edge_stream(e, batch_size=-3),
    lambda m, e: m.sliding_window_stream(e, window=0, batch_size=10),
    lambda m, e: m.sliding_window_stream(e, window=10, batch_size=0),
], ids=["temporal_batch_0", "temporal_batch_negative", "window_0", "window_batch_0"])
def test_bad_arguments_raise_like_the_reference(edges, make):
    e = edges["kron8"]
    with pytest.raises(ValueError) as port_err:
        next(make(graphs, e))
    with pytest.raises(ValueError) as ref_err:
        next(make(ref_graphs, e))
    assert str(port_err.value) == str(ref_err.value)


def test_generators_registry_and_exports():
    assert sorted(graphs.STREAM_GENERATORS) == sorted(ref_graphs.STREAM_GENERATORS)
    for name in ("StreamBatch", "undirected_pairs", "temporal_edge_stream",
                 "sliding_window_stream", "STREAM_GENERATORS"):
        assert name in graphs.__all__
    assert graphs.StreamBatch._fields == ref_graphs.StreamBatch._fields


def test_streams_are_reproducible_and_cover(edges):
    e = edges["kron8"]
    und = graphs.undirected_pairs(e)
    a = list(graphs.temporal_edge_stream(e, batch_size=128, seed=9))
    b = list(graphs.temporal_edge_stream(e, batch_size=128, seed=9))
    assert len(a) == len(b) == -(-und.shape[0] // 128)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.insert, y.insert)
        assert x.delete.shape[0] == 0
    assert np.concatenate([x.insert for x in a]).shape[0] == und.shape[0]
    live = 0
    sizes = []
    for batch in graphs.sliding_window_stream(e, window=300, batch_size=100, seed=9):
        live += batch.insert.shape[0] - batch.delete.shape[0]
        sizes.append(live)
    assert max(sizes) == 300 and sizes[-1] == 300


@pytest.mark.parametrize("keys", [
    np.array([], np.int64), np.array([7], np.int64), np.array([3, 1, 3, 2, 1], np.int32),
    np.random.default_rng(1).integers(0, 40, size=500),
    np.random.default_rng(2).integers(-2**62, 2**62, size=5000),
], ids=["empty", "one", "int32_dups", "many_dups", "wide_int64"])
def test_sorted_unique_equals_np_unique(keys):
    """The sort-based unique behind undirected_pairs, canonicalization and
    the incremental counter's batches gives np.unique's values and dtype."""
    from repro_torch.graphs.formats import sorted_unique

    assert_same_bytes(sorted_unique(keys), np.unique(keys))
