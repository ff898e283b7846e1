"""Port parity: repro_torch's incremental counter equals the reference's.

Every port probe method (``wedge_bsearch``, ``panel``, ``pallas``,
``auto``) at budgets ``None`` and 2048 replays the reference's streams and
is held, batch by batch and with tolerance 0, to the reference's delta,
count, per-node incidences, degrees and public probe stats
(``n_probe_launches``, ``peak_wedge_buffer``).  The reference side runs
its own wedge probes, whose tests pin its backends equal
(``tests/test_incremental.py``); the stats of the port's panel-planned
probes (``panel``, ``pallas``) are held to the reference's panel probes,
which plan the same way, and once to its Pallas kernel in interpret mode.
``state_dict`` trees move between the packages in both directions.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the image may lack hypothesis; use the local stub
    from _hypothesis_stub import given, settings, st

from repro.core import IncrementalTriangleCounter as RefCounter  # noqa: E402
from repro.graphs import (  # noqa: E402
    barabasi_albert,
    kronecker_rmat,
    sliding_window_stream,
    temporal_edge_stream,
    watts_strogatz,
)
from repro.graphs.io import ingest as ref_ingest  # noqa: E402
from repro_torch.core import (  # noqa: E402
    IncrementalTriangleCounter,
    TriangleCounter,
    UpdateStats,
    transitivity,
)
from repro_torch.graphs.formats import canonicalize_edges  # noqa: E402
from repro_torch.graphs.io import ingest  # noqa: E402

KARATE = os.path.join(os.path.dirname(__file__), "data", "karate.txt")
METHODS = ("wedge_bsearch", "panel", "pallas", "auto")
BUDGETS = (None, 2048)
GRAPHS = ("kron8", "barabasi_albert", "watts_strogatz")
# the reference probe whose stats each port method is held to
REF_STATS_METHOD = {"wedge_bsearch": "wedge_bsearch", "auto": "wedge_bsearch",
                    "panel": "panel", "pallas": "panel"}
STREAMS = {
    "temporal": lambda e: temporal_edge_stream(e, batch_size=700, seed=1),
    "sliding_window": lambda e: sliding_window_stream(e, window=900, batch_size=300, seed=2),
}
FANOUT_STREAM = {"temporal_400": lambda e: temporal_edge_stream(e, batch_size=400, seed=4)}


@pytest.fixture(scope="module")
def stream_graphs():
    return {
        "kron8": kronecker_rmat(8, seed=0),
        "barabasi_albert": barabasi_albert(300, 5, seed=0),
        "watts_strogatz": watts_strogatz(400, 8, 0.1, seed=0),
    }


def replay(counter, batches):
    """Per-batch (delta, count, per_node, degrees, launches, peak)."""
    out = []
    for b in batches:
        delta = counter.apply(insert=b.insert, delete=b.delete)
        s = counter.last_update_stats
        out.append((delta, counter.count, counter.per_node(), counter.degrees(),
                    s.n_probe_launches if s else None, s.peak_wedge_buffer if s else None))
    return out


@pytest.fixture(scope="module")
def reference(stream_graphs):
    """The reference's per-batch trace per (probe method, budget, graph,
    stream), computed once."""
    cache = {}

    def get(method, budget, graph, stream):
        key = (method, budget, graph, stream)
        if key not in cache:
            e = stream_graphs[graph]
            cache[key] = replay(RefCounter(max_wedge_chunk=budget, method=method),
                                {**STREAMS, **FANOUT_STREAM}[stream](e))
        return cache[key]

    return get


def assert_trace_equal(got, values, stats):
    assert len(got) == len(values) == len(stats)
    for i, (g, v, s) in enumerate(zip(got, values, stats)):
        assert g[0] == v[0] and g[1] == v[1], (i, g[:2], v[:2])
        np.testing.assert_array_equal(g[2], v[2])
        np.testing.assert_array_equal(g[3], v[3])
        assert (g[4], g[5]) == (s[4], s[5]), (i, g[4:], s[4:])


def recount(counter, method="auto"):
    tc = TriangleCounter(method=method, device="cpu")
    edges = counter.current_edges()
    return (tc.count(edges, n_nodes=counter.n_nodes),
            tc.per_node(edges, n_nodes=counter.n_nodes))


# ---------------------------------------------------------------------------
# stream replay vs the reference, batch by batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("method", METHODS)
def test_stream_equals_reference_batch_by_batch(stream_graphs, reference, method, budget,
                                                graph, stream):
    e = stream_graphs[graph]
    ctr = IncrementalTriangleCounter(max_wedge_chunk=budget, method=method, device="cpu")
    got = replay(ctr, STREAMS[stream](e))
    assert_trace_equal(got, reference("wedge_bsearch", budget, graph, stream),
                       reference(REF_STATS_METHOD[method], budget, graph, stream))
    st_ = ctr.last_update_stats
    assert isinstance(st_, UpdateStats)
    assert st_.probe_method == ("wedge_bsearch" if method == "auto" else method)
    assert st_.wedge_budget == budget
    # the maintained state equals the port's from-scratch recount
    count, per_node = recount(ctr)
    assert ctr.count == count
    np.testing.assert_array_equal(ctr.per_node(), per_node)


def test_reference_pallas_probes_agree(stream_graphs, reference):
    """The reference's Pallas probes (interpret mode) give the deltas and
    stats the port's pallas probes are held to."""
    e = stream_graphs["watts_strogatz"]
    ref = replay(RefCounter(max_wedge_chunk=2048, method="pallas"),
                 STREAMS["sliding_window"](e))
    port = replay(IncrementalTriangleCounter(max_wedge_chunk=2048, method="pallas",
                                             device="cpu"), STREAMS["sliding_window"](e))
    assert_trace_equal(port, ref, ref)
    assert_trace_equal(ref, reference("wedge_bsearch", 2048, "watts_strogatz", "sliding_window"),
                       reference("panel", 2048, "watts_strogatz", "sliding_window"))


@pytest.mark.parametrize("method", METHODS)
def test_budget_below_single_delta_fanout(stream_graphs, reference, method):
    """max_wedge_chunk=1 cannot split one edge's adjacency: the buffer is
    bumped as the reference bumps it, and the count stays exact."""
    e = stream_graphs["kron8"]
    got = replay(IncrementalTriangleCounter(max_wedge_chunk=1, method=method, device="cpu"),
                 FANOUT_STREAM["temporal_400"](e))
    assert_trace_equal(got, reference("wedge_bsearch", 1, "kron8", "temporal_400"),
                       reference(REF_STATS_METHOD[method], 1, "kron8", "temporal_400"))
    assert all(g[4] >= 3 for g in got)
    assert got[-1][1] == TriangleCounter(device="cpu").count(e)


# ---------------------------------------------------------------------------
# bootstrap
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_bootstraps(stream_graphs):
    return {name: RefCounter(e) for name, e in stream_graphs.items()}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_bootstrap_equals_reference(stream_graphs, ref_bootstraps, method, graph):
    e = stream_graphs[graph]
    ref = ref_bootstraps[graph]
    ctr = IncrementalTriangleCounter(e, method=method, max_wedge_chunk=2048, device="cpu")
    assert ctr.count == ref.count and ctr.n_nodes == ref.n_nodes
    np.testing.assert_array_equal(ctr.per_node(), ref.per_node())
    np.testing.assert_array_equal(ctr.degrees(), ref.degrees())
    np.testing.assert_array_equal(ctr.current_edges(), ref.current_edges())


@pytest.mark.parametrize("storage", ["flat", "compressed"])
def test_bootstrap_from_csr_graph(tmp_path, storage):
    """A cached flat or compressed CSR bootstraps like the reference's, in
    the caller's node ids, and takes the same next batch."""
    kwargs = {} if storage == "flat" else {"storage": "compressed", "order": "degree"}
    port_csr, _ = ingest(KARATE, cache_dir=tmp_path / "p", **kwargs)
    ref_csr, _ = ref_ingest(KARATE, cache_dir=tmp_path / "r", **kwargs)
    ctr = IncrementalTriangleCounter(port_csr, method="pallas", device="cpu")
    ref = RefCounter(ref_csr)
    assert ctr.count == ref.count == 45
    np.testing.assert_array_equal(ctr.per_node(), ref.per_node())
    np.testing.assert_array_equal(ctr.current_edges(), ref.current_edges())
    batch = np.array([[0, 9], [9, 33], [0, 33], [4, 5]])
    assert ctr.delete(batch) == ref.delete(batch)
    np.testing.assert_array_equal(ctr.per_node(), ref.per_node())


# ---------------------------------------------------------------------------
# property: arbitrary interleavings against the port's recount
# ---------------------------------------------------------------------------


@st.composite
def op_sequences(draw):
    n = draw(st.integers(4, 12))
    n_ops = draw(st.integers(1, 4))
    ops = []
    for _ in range(n_ops):
        kind = draw(st.sampled_from(["insert", "delete"]))
        k = draw(st.integers(0, 10))
        pairs = draw(
            st.lists(
                st.tuples(st.integers(0, n - 1), st.integers(0, n - 1)),
                min_size=k,
                max_size=k,
            )
        )
        ops.append((kind, np.array(pairs, np.int64).reshape(-1, 2)))
    return ops


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("method", METHODS)
def test_property_interleavings_match_recount(method, budget):
    @settings(max_examples=8, deadline=None)
    @given(op_sequences())
    def run(ops):
        ctr = IncrementalTriangleCounter(max_wedge_chunk=budget, method=method, device="cpu")
        live = set()
        for kind, batch in ops:
            if kind == "insert":
                ctr.insert(batch)
                live |= {(min(a, b), max(a, b)) for a, b in batch if a != b}
            else:
                ctr.delete(batch)
                live -= {(min(a, b), max(a, b)) for a, b in batch if a != b}
        assert ctr.n_edges == len(live)
        if not live:
            assert ctr.count == 0
            return
        edges = canonicalize_edges(np.array(sorted(live)))
        tc = TriangleCounter(method="auto", device="cpu")
        assert ctr.count == tc.count(edges, n_nodes=ctr.n_nodes)
        np.testing.assert_array_equal(ctr.per_node(), tc.per_node(edges, n_nodes=ctr.n_nodes))

    run()


# ---------------------------------------------------------------------------
# edge cases, each beside the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_empty_batch_is_noop(method):
    tri = [[0, 1], [1, 2], [0, 2]]
    ctr = IncrementalTriangleCounter(tri, method=method, device="cpu")
    assert ctr.count == 1
    assert ctr.insert(np.empty((0, 2))) == 0
    assert ctr.delete(np.empty((0, 2))) == 0
    assert ctr.apply() == 0
    assert ctr.count == 1
    assert ctr.last_update_stats.op == "noop"
    assert ctr.last_update_stats.n_probe_launches == 0


@pytest.mark.parametrize("method", METHODS)
def test_duplicates_and_self_loops_in_batch(method):
    batch = [[0, 0], [0, 1], [1, 0], [1, 2], [1, 2], [2, 0], [5, 5]]
    ctr = IncrementalTriangleCounter(method=method, device="cpu")
    ref = RefCounter()
    assert ctr.insert(batch) == ref.insert(batch) == 1
    assert ctr.n_edges == ref.n_edges == 3
    assert ctr.n_nodes == ref.n_nodes
    assert ctr.last_update_stats.n_batch_edges == 3
    assert ctr.insert([[0, 1], [2, 1]]) == 0
    assert ctr.count == 1


@pytest.mark.parametrize("method", METHODS)
def test_delete_absent_edges(method):
    tri = [[0, 1], [1, 2], [0, 2]]
    ctr = IncrementalTriangleCounter(tri, method=method, device="cpu")
    assert ctr.delete([[3, 7]]) == 0
    assert ctr.delete([[0, 3]]) == 0
    assert ctr.count == 1 and ctr.n_edges == 3
    assert ctr.delete([[1, 2], [8, 9]]) == -1
    assert ctr.count == 0 and ctr.n_edges == 2
    assert ctr.last_update_stats.op == "delete" and ctr.last_update_stats.delta == -1


@pytest.mark.parametrize("method", METHODS)
def test_node_growth_and_queries(method):
    tri = [[0, 1], [1, 2], [0, 2]]
    grow = [[2, 50], [0, 50], [7, 50]]
    ctr = IncrementalTriangleCounter(tri, method=method, device="cpu")
    ref = RefCounter(tri)
    assert ctr.insert(grow) == ref.insert(grow)
    assert ctr.n_nodes == ref.n_nodes == 51
    assert ctr.count == ref.count == 2
    np.testing.assert_array_equal(ctr.per_node(), ref.per_node())
    np.testing.assert_array_equal(ctr.degrees(), ref.degrees())
    np.testing.assert_allclose(ctr.clustering(), ref.clustering(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(ctr.transitivity(), ref.transitivity(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(ctr.transitivity(),
                               transitivity(ctr.current_edges(), device="cpu"), rtol=1e-12)
    assert ctr.degrees().sum() == ctr.current_edges().shape[0]


def test_rejects_bad_args():
    with pytest.raises(ValueError):
        IncrementalTriangleCounter(max_wedge_chunk=0, device="cpu")
    ctr = IncrementalTriangleCounter(device="cpu")
    with pytest.raises(ValueError):
        ctr.insert([[-1, 2]])
    with pytest.raises(ValueError):
        ctr.insert([[0, 2**31]])


@pytest.mark.parametrize("kwargs", [{"method": "distributed"},
                                    {"method": "pallas", "mesh": object()}])
def test_distributed_is_not_ported(kwargs):
    """The distributed probes are ported: without a mesh, or with a mesh of
    the wrong type, the counter raises the reference's errors."""
    err = (ValueError, "needs a mesh") if "mesh" not in kwargs else (TypeError, "Mesh")
    with pytest.raises(err[0], match=err[1]):
        IncrementalTriangleCounter(device="cpu", **kwargs)
    with pytest.raises(err[0], match=err[1]):
        IncrementalTriangleCounter.from_state(
            IncrementalTriangleCounter(device="cpu").state_dict(), device="cpu", **kwargs)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IncrementalTriangleCounter()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IncrementalTriangleCounter.from_state(
            IncrementalTriangleCounter(device="cpu").state_dict())


def test_probe_failure_clears_last_stats(monkeypatch):
    ctr = IncrementalTriangleCounter([[0, 1], [1, 2]], device="cpu")
    ctr.insert([[0, 2]])
    assert ctr.last_update_stats.op == "insert"

    def boom(*a, **k):
        raise RuntimeError("probe failed")

    monkeypatch.setattr(ctr, "_probe", boom)
    with pytest.raises(RuntimeError, match="probe failed"):
        ctr.insert([[2, 3]])
    assert ctr.last_update_stats is None
    assert ctr.count == 1 and ctr.n_edges == 3  # the failed batch left no trace


# ---------------------------------------------------------------------------
# state_dict across the packages
# ---------------------------------------------------------------------------


def _split(stream_graphs, n_first=3):
    batches = list(STREAMS["sliding_window"](stream_graphs["kron8"]))
    return batches[:n_first], batches[n_first:]


@pytest.mark.parametrize("method", ["wedge_bsearch", "pallas"])
def test_reference_state_continues_in_the_port(stream_graphs, method):
    head, tail = _split(stream_graphs)
    ref = RefCounter(max_wedge_chunk=2048)
    replay(ref, head)
    state = ref.state_dict()
    ctr = IncrementalTriangleCounter.from_state(state, max_wedge_chunk=2048, method=method,
                                                device="cpu")
    for k, v in ctr.state_dict().items():
        assert v.dtype == np.asarray(state[k]).dtype
        np.testing.assert_array_equal(v, state[k])
    ref_stats = RefCounter.from_state(state, max_wedge_chunk=2048,
                                      method=REF_STATS_METHOD[method])
    assert_trace_equal(replay(ctr, tail), replay(ref, tail), replay(ref_stats, tail))


def test_port_state_continues_in_the_reference(stream_graphs):
    head, tail = _split(stream_graphs)
    ctr = IncrementalTriangleCounter(max_wedge_chunk=2048, method="pallas", device="cpu")
    replay(ctr, head)
    ref = RefCounter.from_state(ctr.state_dict(), max_wedge_chunk=2048)
    ref_state = ref.state_dict()
    for k, v in ctr.state_dict().items():
        np.testing.assert_array_equal(ref_state[k], v)
    want = replay(ref, tail)
    port_wedge = IncrementalTriangleCounter.from_state(ctr.state_dict(), max_wedge_chunk=2048,
                                                       device="cpu")
    assert_trace_equal(replay(port_wedge, tail), want, want)


def _tampered(state):
    out = []
    bad = dict(state)
    bad["deg"] = state["deg"].copy()
    bad["deg"][0] += 1
    out.append(("degree histogram", bad))
    bad = dict(state)
    bad["adj"] = state["adj"][::-1].copy()
    out.append(("increasing", bad))
    bad = dict(state)
    bad["adj"] = state["adj"][:-1].copy()
    out.append(("even", bad))
    bad = dict(state)
    bad["per_node"] = state["per_node"][:-1].copy()
    out.append(("n_nodes", bad))
    bad = dict(state)
    bad["count"] = np.asarray(-1, np.int64)
    out.append(("negative", bad))
    bad = dict(state)
    bad["n_nodes"] = np.asarray(2, np.int64)
    bad["per_node"] = state["per_node"][:2].copy()
    bad["deg"] = state["deg"][:2].copy()
    out.append(("outside", bad))
    return out


@pytest.mark.parametrize("case", range(6))
def test_tampered_state_is_rejected_like_the_reference(case):
    ref = RefCounter(n_nodes=8)
    ref.apply(insert=np.array([[0, 1], [1, 2], [0, 2], [2, 3]], np.int64))
    what, bad = _tampered(ref.state_dict())[case]
    with pytest.raises(ValueError, match=what) as port_err:
        IncrementalTriangleCounter.from_state(bad, device="cpu")
    with pytest.raises(ValueError) as ref_err:
        RefCounter.from_state(bad)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pallas", "wedge_bsearch"])
def test_cuda_stream_equals_cpu_on_card(stream_graphs, method):
    """On the card the probes (the per-node CSR kernel for pallas) give the
    CPU run's trace batch by batch, and launch the kernel once per chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py drives the stream on one)")
    from repro_torch.kernels.triangle_count import launches, reset_launches

    e = stream_graphs["kron8"]
    want = replay(IncrementalTriangleCounter(max_wedge_chunk=2048, method=method, device="cpu"),
                  STREAMS["sliding_window"](e))
    reset_launches()
    got = replay(IncrementalTriangleCounter(max_wedge_chunk=2048, method=method),
                 STREAMS["sliding_window"](e))
    assert_trace_equal(got, want, want)
    expect = sum(g[4] for g in got) if method == "pallas" else 0
    assert launches["intersect_per_node_csr"] == expect
