"""Port parity: repro_torch's TriangleCounter equals the reference's.

Every method (``wedge_bsearch``, ``panel``, ``pallas``, ``auto``) at an
unbounded and a small budget, on ``small_graphs`` and karate: count,
per-node incidences and per-edge support are equal integers (tolerance 0);
clustering and transitivity are numpy formulas of those integers and are
therefore equal too.  kron-13 (T = 1,180,718) runs through wedge_bsearch
and pallas.  Planning invariants, the uint64 fold and ``last_stats`` are
mirrored from tests/test_engine.py.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import TriangleCounter as RefCounter  # noqa: E402
from repro.graphs import kronecker_rmat  # noqa: E402
from repro.graphs.io import ingest  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import TriangleCounter, count_triangles  # noqa: E402
from repro_torch.core.engine import accumulate_partials, plan_edge_chunks  # noqa: E402

KARATE = os.path.join(os.path.dirname(__file__), "data", "karate.txt")
T13 = 1_180_718
METHODS = ("wedge_bsearch", "panel", "pallas", "auto")
SHARED_STATS = ("method", "resolved_method", "n_chunks", "peak_wedge_buffer",
                "wedge_budget", "total_wedges", "n_directed_edges", "fallback_reason")


@pytest.fixture(scope="module")
def graphs(small_graphs):
    return {**small_graphs, "karate": ingest(KARATE)[0].edge_array()}


def assert_stats_equal(ref, port):
    for f in SHARED_STATS:
        assert getattr(port, f) == getattr(ref, f), f
    assert set(port.timings) == set(ref.timings)


@pytest.fixture(scope="module")
def reference_results(graphs):
    """The reference's five results per graph, computed once.

    Its own tests pin every backend and every budget bit-identical, so
    they come from its unchunked wedge schedule; each port method and
    budget is held against them.
    """
    cache = {}

    def get(name):
        if name not in cache:
            e = graphs[name]
            ref = RefCounter(method="wedge_bsearch")
            cache[name] = (ref.count(e), ref.per_node(e), ref.edge_support(e),
                           ref.clustering(e), ref.transitivity(e))
        return cache[name]

    return get


@pytest.mark.parametrize("budget", [None, 48])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", ["er", "kron", "ws", "triangle", "karate"])
def test_every_workload_matches_reference(graphs, reference_results, name, method, budget):
    edges = graphs[name]
    count, per_node, support, clustering, trans = reference_results(name)
    port = TriangleCounter(method=method, max_wedge_chunk=budget, device="cpu")

    assert port.count(edges) == count
    if method != "pallas":  # the reference's pallas stats: test below
        ref = RefCounter(method=method, max_wedge_chunk=budget)
        ref.count(edges)
        assert_stats_equal(ref.last_stats, port.last_stats)
    assert port.last_stats.method == port.last_stats.resolved_method != "auto"
    np.testing.assert_array_equal(port.per_node(edges), per_node)
    got_support = port.edge_support(edges)
    np.testing.assert_array_equal(got_support, support)
    assert got_support.sum() == 3 * count
    np.testing.assert_array_equal(port.clustering(edges), clustering)
    assert port.transitivity(edges) == trans


def test_pallas_stats_match_reference_pallas(graphs):
    """The kernel backend's plan is the reference's pallas plan."""
    for budget in (None, 48):
        ref = RefCounter(method="pallas", max_wedge_chunk=budget)
        port = TriangleCounter(method="pallas", max_wedge_chunk=budget, device="cpu")
        assert port.count(graphs["kron"]) == ref.count(graphs["kron"])
        assert_stats_equal(ref.last_stats, port.last_stats)


@pytest.fixture(scope="module")
def kron13():
    edges = kronecker_rmat(13, seed=0)
    return edges, RefCounter(method="wedge_bsearch", max_wedge_chunk=1 << 16).count(edges)


@pytest.mark.parametrize("method,budget", [("wedge_bsearch", None),
                                           ("wedge_bsearch", 1 << 16),
                                           ("pallas", 1 << 16)])
def test_kron13(kron13, method, budget):
    edges, ref_count = kron13
    assert ref_count == T13
    port = TriangleCounter(method=method, max_wedge_chunk=budget, device="cpu")
    assert port.count(edges) == T13
    assert port.last_stats.method == method


@pytest.mark.parametrize("budget", [None, 48])
@pytest.mark.parametrize("name", ["kron", "karate"])
def test_pallas_count_reads_the_csr_without_gathering(graphs, reference_results, monkeypatch,
                                                      name, budget):
    """The kernel backend's count goes through ``ops.intersect_count_csr``
    once per chunk and never through the panel gather; the count equals
    the reference's."""
    from repro_torch.kernels.triangle_count import ops as tc_ops

    def no_gather(*_):
        raise AssertionError("the pallas count gathered panels")

    calls = []
    real = tc_ops.intersect_count_csr
    monkeypatch.setattr(port_engine.PanelBackend, "_gather", no_gather)
    monkeypatch.setattr(tc_ops, "intersect_count_csr",
                        lambda *a: calls.append(a[4]) or real(*a))
    port = TriangleCounter(method="pallas", max_wedge_chunk=budget, device="cpu")
    assert port.count(graphs[name]) == reference_results(name)[0]
    assert len(calls) == port.last_stats.n_chunks > 0
    ref = RefCounter(method="pallas", max_wedge_chunk=budget)
    ref.count(graphs[name])
    assert_stats_equal(ref.last_stats, port.last_stats)


@pytest.mark.parametrize("budget", [None, 48])
@pytest.mark.parametrize("name", ["kron", "karate"])
def test_pallas_per_node_and_support_read_the_csr_without_gathering(graphs, monkeypatch,
                                                                    name, budget):
    """The kernel backend's per-node and support go through
    ``ops.intersect_per_node_csr`` / ``ops.intersect_support_csr`` once per
    chunk and never through the panel gather; per-node, support,
    clustering and transitivity equal the reference's pallas results."""
    from repro_torch.kernels.triangle_count import ops as tc_ops

    def no_gather(*_):
        raise AssertionError("the pallas backend gathered panels")

    calls = {"intersect_per_node_csr": 0, "intersect_support_csr": 0}
    monkeypatch.setattr(port_engine.PanelBackend, "_gather", no_gather)
    for op in calls:
        real = getattr(tc_ops, op)

        def counted(*a, _real=real, _op=op):
            calls[_op] += 1
            return _real(*a)

        monkeypatch.setattr(tc_ops, op, counted)
    edges = graphs[name]
    ref = RefCounter(method="pallas", max_wedge_chunk=budget)
    port = TriangleCounter(method="pallas", max_wedge_chunk=budget, device="cpu")

    np.testing.assert_array_equal(port.per_node(edges), ref.per_node(edges))
    assert calls["intersect_per_node_csr"] == port.last_stats.n_chunks > 0
    assert_stats_equal(ref.last_stats, port.last_stats)
    np.testing.assert_array_equal(port.edge_support(edges), ref.edge_support(edges))
    assert calls["intersect_support_csr"] == port.last_stats.n_chunks
    assert_stats_equal(ref.last_stats, port.last_stats)
    np.testing.assert_array_equal(port.clustering(edges), ref.clustering(edges))
    assert port.transitivity(edges) == ref.transitivity(edges)


def test_plan_edge_chunks_invariants():
    rng = np.random.default_rng(0)
    reps = rng.integers(0, 50, size=500)
    for budget in [None, 10_000, 1_000, 120, 49, 1]:
        bounds, eff = plan_edge_chunks(reps, budget)
        assert bounds[0][0] == 0 and bounds[-1][1] == len(reps)
        for (a0, a1), (b0, b1) in zip(bounds, bounds[1:]):
            assert a1 == b0
        for s, t in bounds:
            assert reps[s:t].sum() <= eff
        if budget is not None:
            assert eff >= min(budget, int(reps.max()))


def test_uint64_accumulation_regression():
    near_max = np.int32(2**31 - 1)
    assert accumulate_partials([near_max] * 4) == 4 * (2**31 - 1)
    parts = [np.array([near_max, near_max], np.int32), np.int32(7), np.array([], np.int32)]
    assert accumulate_partials(parts) == 2 * (2**31 - 1) + 7
    tensors = [torch.full((3,), 2**31 - 1, dtype=torch.int32), torch.zeros(0, dtype=torch.int32)]
    assert accumulate_partials(tensors) == 3 * (2**31 - 1)


def test_last_stats_cleared_per_call(graphs):
    tc = TriangleCounter(method="wedge_bsearch", max_wedge_chunk=48, device="cpu")
    tc.count(graphs["kron"])
    first = tc.last_stats
    assert first.n_chunks > 1 and set(first.timings) == {"preprocess", "plan", "execute", "fold"}
    assert tc.count(np.zeros((0, 2), np.int32)) == 0
    assert tc.last_stats.n_chunks == 0 and tc.last_stats.total_wedges == 0
    assert dataclasses.replace(first) == first


def test_auto_dispatch_by_device():
    kw = dict(max_out_degree=845, mean_out_degree=15.2)
    assert port_engine.choose_method(**kw, backend="cuda") == "pallas"
    assert port_engine.choose_method(**kw, backend="cpu") == "wedge_bsearch"
    assert port_engine.choose_method(max_out_degree=5000, mean_out_degree=15.0,
                                     backend="cuda") == "wedge_bsearch"
    assert port_engine.choose_method(max_out_degree=30, mean_out_degree=10.0) == "panel"


def test_not_ported_paths_raise():
    # the distributed schedule is ported (ROADMAP A6); without a mesh it
    # raises the reference's errors
    with pytest.raises(ValueError, match="requires a mesh"):
        TriangleCounter(method="distributed", device="cpu")
    backend = port_engine.make_backend("distributed")
    work = port_engine.make_workload(*(np.array(a, np.int32) for a in (
        [0, 1, 1], [1], [1, 0], [0], [1])), device="cpu")
    with pytest.raises(ValueError, match="needs a repro_torch.distributed.Mesh"):
        port_engine.run_workload(backend, "count", work)
    with pytest.raises(ValueError):
        TriangleCounter(method="bogus", device="cpu")
    with pytest.raises(ValueError):
        TriangleCounter(max_wedge_chunk=0, device="cpu")


def test_facade_routes_chunking(graphs):
    edges = graphs["ws"]
    want = RefCounter().count(edges)
    assert count_triangles(edges, max_wedge_chunk=33, device="cpu") == want


def test_oriented_csr_input_is_reused(graphs):
    from repro_torch.core import prepare_oriented

    csr = prepare_oriented(graphs["kron"], device="cpu")
    tc = TriangleCounter(method="pallas", max_wedge_chunk=200, device="cpu")
    assert tc.count(csr) == RefCounter().count(graphs["kron"])


def test_capability_fallback_is_loud_and_not_sticky(graphs, monkeypatch):
    """A registered count-only backend: per-node falls back to the wedge
    schedule with a reason and a warning; the next count clears it."""

    class CountOnly(port_engine.PallasBackend):
        name = "count_only"
        capabilities = frozenset({"count"})

    monkeypatch.setitem(port_engine._BACKEND_FACTORIES, "count_only",
                        lambda widths=port_engine.DEFAULT_WIDTHS, **_: CountOnly(widths))
    monkeypatch.setattr(port_engine, "_warned_fallbacks", set())
    edges = graphs["kron"]
    want = RefCounter().per_node(edges)
    tc = TriangleCounter(method="count_only", device="cpu")
    with pytest.warns(RuntimeWarning, match="no 'per_node' kernel"):
        np.testing.assert_array_equal(tc.per_node(edges), want)
    assert tc.last_stats.method == "wedge_bsearch"
    assert tc.last_stats.resolved_method == "count_only"
    assert "fell back" in tc.last_stats.fallback_reason
    assert tc.count(edges) == int(want.sum()) // 3
    assert tc.last_stats.fallback_reason is None
    assert tc.last_stats.method == "count_only"


@pytest.mark.parametrize("method,kind", [("pallas", "count"), ("pallas", "per_node"),
                                         ("pallas", "edge_support"),
                                         ("wedge_bsearch", "count")])
def test_chunk_uploads_counter(graphs, method, kind):
    """The panel plan's chunks are device tensors already, so the pallas
    route copies none; the sliced wedge route uploads src and dst a chunk."""
    from repro_torch import obs

    tc = TriangleCounter(method=method, max_wedge_chunk=48, device="cpu")
    obs.reset_metrics()
    with obs.tracing():
        getattr(tc, kind)(graphs["kron"])
    uploads = obs.metrics_snapshot()["counters"].get("engine.chunk_uploads", 0)
    n_chunks = tc.last_stats.n_chunks
    assert n_chunks > 1
    assert uploads == (0 if method == "pallas" else 2 * n_chunks)


@pytest.mark.cuda
def test_oriented_csr_on_the_card_is_reused(graphs):
    """A CSR built with the default device lies on ``cuda:0``; a counter
    made with the default device takes it as it is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py counts a CSR on one)")
    from repro_torch.core import prepare_oriented

    csr = prepare_oriented(graphs["kron"])
    assert TriangleCounter(method="pallas").count(csr) == RefCounter().count(graphs["kron"])
