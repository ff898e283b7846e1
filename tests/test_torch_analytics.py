"""Port parity: repro_torch.analytics (support, k-truss, metrics, report)
and the engine's pow2 planners equal the reference's.

The same numpy inputs go through both packages on ``small_graphs`` and
karate; the reference runs its Pallas kernels in interpret mode, as its
own tests do.  Integers (support, trussness, rounds, launches, plan
stats) are equal (tolerance 0); the report's floats are numpy formulas of
those integers and are held to 1e-12.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # no hypothesis installed: use the local stub
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")

from repro import analytics as ref_an  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import prepare_oriented as ref_prepare  # noqa: E402
from repro.graphs import canonicalize_edges  # noqa: E402
from repro.graphs.io import ingest as ref_ingest  # noqa: E402
from repro.graphs.io import load_tricsrz as ref_load_z  # noqa: E402
from repro.graphs.io import save_tricsrz as ref_save_z  # noqa: E402
from repro_torch import analytics as an  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import clustering as port_clustering  # noqa: E402
from repro_torch.core import prepare_oriented  # noqa: E402
from repro_torch.graphs.io import ingest as port_ingest  # noqa: E402
from repro_torch.graphs.io import load_tricsrz as port_load_z  # noqa: E402
from repro_torch.graphs.io import save_tricsrz as port_save_z  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KARATE = os.path.join(REPO, "tests", "data", "karate.txt")
METHODS = ("wedge_bsearch", "panel", "pallas", "auto")
NAMES = ("er", "kron", "ws", "triangle", "karate")
SUPPORT_FIELDS = ("n_nodes", "n_chunks", "peak_wedge_buffer", "wedge_budget",
                  "total_wedges", "method", "fallback_reason")
TRUSS_FIELDS = ("max_k", "n_nodes", "rounds", "n_support_launches", "method")


@pytest.fixture(scope="module")
def graphs(small_graphs):
    return {**small_graphs, "karate": ref_ingest(KARATE)[0].edge_array()}


def _cached(fn):
    """A module-scope memo of a reference computation, keyed by its args."""
    cache = {}

    def get(*key):
        if key not in cache:
            cache[key] = fn(*key)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def ref_support(graphs):
    return _cached(lambda name, method, budget: ref_an.edge_support(
        graphs[name], method=method, max_wedge_chunk=budget))


@pytest.fixture(scope="module")
def ref_truss(graphs):
    return _cached(lambda name, method, budget: ref_an.k_truss_decomposition(
        graphs[name], method=method, max_wedge_chunk=budget))


def ref_resolved(edges, method):
    """The schedule the reference's ``auto`` picks for ``edges`` on this CPU."""
    return ref_engine.resolve_method(method, ref_prepare(edges).out_degree)


def assert_support_equal(got, want):
    np.testing.assert_array_equal(got.u, want.u)
    np.testing.assert_array_equal(got.v, want.v)
    np.testing.assert_array_equal(got.support, want.support)
    assert got.support.dtype == np.int64
    for f in SUPPORT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def assert_truss_equal(got, want):
    np.testing.assert_array_equal(got.u, want.u)
    np.testing.assert_array_equal(got.v, want.v)
    np.testing.assert_array_equal(got.trussness, want.trussness)
    for f in TRUSS_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.spectrum() == want.spectrum()
    assert got.truss_sizes() == want.truss_sizes()


def assert_json_close(got, want, path="report"):
    """Equal JSON trees; floats within 1e-12, everything else exact."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_json_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= 1e-12, (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def without_timings(report):
    out = {k: v for k, v in report.items() if k != "timings_s"}
    out["engine"] = {k: v for k, v in report["engine"].items() if k != "timings"}
    return out


# ---------------------------------------------------------------------------
# per-edge support
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [None, 48])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_edge_support_equals_reference(graphs, ref_support, name, method, budget):
    got = an.edge_support(graphs[name], method=method, max_wedge_chunk=budget, device="cpu")
    want = ref_support(name, method, budget)
    assert_support_equal(got, want)
    assert got.total_triangles() == want.total_triangles()
    for k in (0, 3, 10_000):
        for g, w in zip(got.top_k(k), want.top_k(k)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("method", ["wedge_bsearch", "pallas"])
@pytest.mark.parametrize("kind", ["oriented", "cached", "tensor"])
def test_edge_support_input_kinds(graphs, ref_support, tmp_path, kind, method):
    """An ``OrientedCSR``, a cached ``.tricsr`` CSR and an edge tensor give
    the edge array's result."""
    if kind == "oriented":
        graph = prepare_oriented(graphs["karate"], device="cpu")
    elif kind == "cached":
        graph = port_ingest(KARATE, cache_dir=tmp_path)[0]
    else:
        graph = torch.from_numpy(graphs["karate"])
    got = an.edge_support(graph, method=method, max_wedge_chunk=48, device="cpu")
    assert_support_equal(got, ref_support("karate", method, 48))


def _padded_sub_csr(edges, keep_every, tail):
    """A filtered sub-CSR of the oriented graph (as a truss round builds it),
    with ``tail`` −1 slots after the real edges."""
    csr = ref_prepare(edges)
    src = np.asarray(csr.src)[::keep_every]
    col = np.asarray(csr.col)[::keep_every]
    n = csr.n_nodes
    out = np.bincount(src, minlength=n).astype(np.int32)
    row = np.zeros(n + 1, np.int32)
    np.cumsum(out, out=row[1:])
    fill = np.full(tail, -1, np.int32)
    return row, np.concatenate([src, fill]), np.concatenate([col, fill]), out


@pytest.mark.parametrize("bucket_pow2", [False, True])
@pytest.mark.parametrize("budget", [None, 40])
@pytest.mark.parametrize("method", ["wedge_bsearch", "panel", "pallas"])
def test_support_on_arrays_with_padded_tail(graphs, method, budget, bucket_pow2):
    arrays = _padded_sub_csr(graphs["kron"], keep_every=2, tail=37)
    want = ref_an.support_on_arrays(*arrays, max_wedge_chunk=budget, n_steps=6,
                                    bucket_pow2=bucket_pow2, method=method)
    got = an.support_on_arrays(*arrays, max_wedge_chunk=budget, n_steps=6,
                               bucket_pow2=bucket_pow2, method=method, device="cpu")
    np.testing.assert_array_equal(got.support, want.support)
    assert (got.support[-37:] == 0).all()
    assert got[1:] == want[1:]  # n_chunks, peak, total_wedges, method, fallback
    tensors = [torch.from_numpy(a) for a in arrays]
    again = an.support_on_arrays(*tensors, max_wedge_chunk=budget, n_steps=6,
                                 bucket_pow2=bucket_pow2, method=method, device="cpu")
    np.testing.assert_array_equal(again.support, want.support)


def test_support_on_arrays_empty_and_not_ported():
    empty = np.zeros(0, np.int32)
    run = an.support_on_arrays(np.zeros(1, np.int32), empty, empty, empty, device="cpu")
    assert run.support.shape == (0,) and run.n_chunks == 0
    arrays = (np.array([0, 1, 1], np.int32), np.array([0], np.int32),
              np.array([1], np.int32), np.array([1, 0], np.int32))
    # mesh= and shorter_side= are ported: a mesh of the wrong type raises,
    # shorter_side on the wedge backend is ignored as in the reference
    with pytest.raises(TypeError, match="Mesh"):
        an.support_on_arrays(*arrays, device="cpu", mesh=object())
    run = an.support_on_arrays(*arrays, device="cpu", shorter_side=True)
    assert run.support.tolist() == [0] and run.method == "wedge_bsearch"
    # the tuner is ported (core/tuning.py): a wedge run never asks it
    run = an.support_on_arrays(*arrays, device="cpu", tuner=object())
    assert run.support.tolist() == [0] and run.method == "wedge_bsearch"


def test_edge_support_counter_reuse_and_conflicts(graphs, ref_support):
    tc = engine.TriangleCounter(method="pallas", max_wedge_chunk=48, device="cpu")
    got = an.edge_support(graphs["kron"], counter=tc)
    assert_support_equal(got, ref_support("kron", "pallas", 48))
    assert tc.last_stats.n_chunks == got.n_chunks
    for kw in (dict(method="panel"), dict(max_wedge_chunk=8), dict(device="cpu")):
        with pytest.raises(ValueError, match="not both"):
            an.edge_support(graphs["kron"], counter=tc, **kw)
    with pytest.raises(ValueError, match="not both"):
        an.edge_support(graphs["kron"], counter=tc, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        an.edge_support(graphs["kron"], mesh=object(), device="cpu")


def test_edge_support_empty_graph():
    got = an.edge_support(np.zeros((0, 2), np.int32), device="cpu")
    want = ref_an.edge_support(np.zeros((0, 2), np.int32))
    assert_support_equal(got, want)


# ---------------------------------------------------------------------------
# k-truss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [None, 64])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_truss_equals_reference(graphs, ref_truss, name, method, budget):
    got = an.k_truss_decomposition(graphs[name], method=method, max_wedge_chunk=budget,
                                   device="cpu")
    # the reference's own tests pin auto to the run of the schedule it picks
    assert_truss_equal(got, ref_truss(name, ref_resolved(graphs[name], method), budget))


def test_truss_karate_gate(graphs):
    """ROADMAP A2's gate: max_k 5, spectrum {2: 11, 3: 42, 4: 11, 5: 14}."""
    dec = an.k_truss_decomposition(graphs["karate"], method="pallas", device="cpu")
    assert dec.max_k == 5
    assert dec.spectrum() == {2: 11, 3: 42, 4: 11, 5: 14}


@pytest.mark.parametrize("kind", ["oriented", "cached"])
def test_truss_input_kinds(graphs, ref_truss, tmp_path, kind):
    graph = (prepare_oriented(graphs["karate"], device="cpu") if kind == "oriented"
             else port_ingest(KARATE, cache_dir=tmp_path)[0])
    got = an.k_truss_decomposition(graph, method="pallas", max_wedge_chunk=64, device="cpu")
    assert_truss_equal(got, ref_truss("karate", "pallas", 64))


@pytest.mark.parametrize("k", [None, 3, 4])
@pytest.mark.parametrize("name", ["kron", "karate"])
def test_truss_subgraph_equals_reference(graphs, ref_truss, name, k):
    got, got_k = an.k_truss_subgraph(graphs[name], k=k, method="pallas", device="cpu")
    want, want_k = ref_an.k_truss_subgraph(ref_truss(name, "pallas", None), k=k)
    assert got_k == want_k
    np.testing.assert_array_equal(got, want)
    dec = an.k_truss_decomposition(graphs[name], method="pallas", device="cpu")
    again, _ = an.k_truss_subgraph(dec, k=k)
    np.testing.assert_array_equal(again, want)


def _complete_graph(n):
    return canonicalize_edges(np.array([(i, j) for i in range(n) for j in range(i + 1, n)]))


@pytest.mark.parametrize("method", ["wedge_bsearch", "pallas"])
def test_truss_complete_graph(method):
    """K_n is its own n-truss: every edge has support n-2."""
    dec = an.k_truss_decomposition(_complete_graph(6), method=method, device="cpu")
    assert dec.max_k == 6
    assert (dec.trussness == 6).all()
    assert_truss_equal(dec, ref_an.k_truss_decomposition(_complete_graph(6), method=method))


@pytest.mark.parametrize("method", ["wedge_bsearch", "pallas"])
def test_truss_triangle_free(method):
    star = canonicalize_edges(np.array([(0, i) for i in range(1, 7)]))
    dec = an.k_truss_decomposition(star, method=method, device="cpu")
    assert dec.max_k == 2 and (dec.trussness == 2).all()
    sub, k = an.k_truss_subgraph(star, method=method, device="cpu")
    assert k == 2 and sub.shape[0] == 12  # the whole (canonical) graph
    assert_truss_equal(dec, ref_an.k_truss_decomposition(star, method=method))


def test_truss_empty_graph_and_not_ported():
    dec = an.k_truss_decomposition(np.zeros((0, 2), np.int32), device="cpu")
    assert dec.max_k == 0 and dec.n_edges == 0 and dec.spectrum() == {}
    sub, k = an.k_truss_subgraph(np.zeros((0, 2), np.int32), device="cpu")
    assert sub.shape == (0, 2) and k == 0
    with pytest.raises(TypeError, match="Mesh"):  # mesh= is ported (ROADMAP A6)
        an.k_truss_decomposition(np.zeros((0, 2), np.int32), mesh=object(), device="cpu")


def test_truss_pallas_launches_the_support_kernel_once_per_chunk(graphs, monkeypatch):
    """Every peel round runs the CSR support wrapper once per chunk: the
    calls add up to ``n_support_launches``, and no panel is gathered."""
    from repro_torch.kernels.triangle_count import ops as tc_ops

    calls = {"support": 0}
    real = tc_ops.intersect_support_csr

    def counted(*args):
        calls["support"] += 1
        return real(*args)

    monkeypatch.setattr(tc_ops, "intersect_support_csr", counted)
    monkeypatch.setattr(engine, "gather_panels_arrays",
                        lambda *a, **k: pytest.fail("the pallas peel gathered panels"))
    dec = an.k_truss_decomposition(graphs["kron"], method="pallas", max_wedge_chunk=256,
                                   device="cpu")
    assert calls["support"] == dec.n_support_launches > dec.rounds > 1


# ---------------------------------------------------------------------------
# metrics and the report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["kron", "karate"])
def test_metrics_equal_reference(graphs, name):
    e = graphs[name]
    kw = dict(method="pallas", max_wedge_chunk=64)
    np.testing.assert_array_equal(an.per_node_triangle_counts(e, **kw, device="cpu"),
                                  ref_an.per_node_triangle_counts(e, **kw))
    np.testing.assert_array_equal(an.local_clustering(e, **kw, device="cpu"),
                                  ref_an.local_clustering(e, **kw))
    assert an.average_clustering(e, **kw, device="cpu") == ref_an.average_clustering(e, **kw)
    assert an.transitivity(e, **kw, device="cpu") == ref_an.transitivity(e, **kw)
    np.testing.assert_array_equal(an.node_triangle_features(e, **kw, device="cpu"),
                                  ref_an.node_triangle_features(e, **kw))
    assert an.clustering_profile(e, **kw, device="cpu") == ref_an.clustering_profile(e, **kw)
    for g, w in zip(an.top_triangle_nodes(e, 4, **kw, device="cpu"),
                    ref_an.top_triangle_nodes(e, 4, **kw)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(an.top_support_edges(e, 4, **kw, device="cpu"),
                    ref_an.top_support_edges(e, 4, **kw)):
        np.testing.assert_array_equal(g, w)
    # the core wrappers are the same functions of the same counts
    np.testing.assert_array_equal(
        port_clustering.local_clustering_coefficient(e, **kw, device="cpu"),
        an.local_clustering(e, **kw, device="cpu"))
    assert port_clustering.transitivity(e, device="cpu") == an.transitivity(e, device="cpu")


def test_metrics_counter_reuse(graphs):
    tc = engine.TriangleCounter(method="panel", max_wedge_chunk=64, device="cpu")
    want = ref_an.per_node_triangle_counts(graphs["kron"], method="panel", max_wedge_chunk=64)
    np.testing.assert_array_equal(an.per_node_triangle_counts(graphs["kron"], counter=tc), want)
    assert tc.last_stats.method == "panel" and tc.last_stats.n_chunks > 1


@pytest.mark.parametrize("include_truss", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_graph_report_equals_reference(graphs, name, include_truss):
    got = an.graph_report(graphs[name], include_truss=include_truss, top_k=3, device="cpu")
    want = ref_an.graph_report(graphs[name], include_truss=include_truss, top_k=3)
    assert_json_close(without_timings(got), without_timings(want))
    assert set(got["timings_s"]) == set(want["timings_s"])
    assert set(got["engine"]["timings"]) == set(want["engine"]["timings"])
    assert ("truss" in got) == include_truss


def test_graph_report_pallas_at_a_budget(graphs):
    kw = dict(method="pallas", max_wedge_chunk=64, top_k=3)
    got = an.graph_report(graphs["karate"], **kw, device="cpu")
    want = ref_an.graph_report(graphs["karate"], **kw)
    assert_json_close(without_timings(got), without_timings(want))
    assert got["triangles"] == 45 and got["transitivity"] == 135 / 528
    assert got["truss"]["spectrum"] == {"2": 11, "3": 42, "4": 11, "5": 14}


def test_graph_report_empty_graph():
    empty = np.zeros((0, 2), np.int32)
    got = an.graph_report(empty, n_nodes=4, device="cpu")
    want = ref_an.graph_report(empty, n_nodes=4)
    assert_json_close(without_timings(got), without_timings(want))


@pytest.mark.parametrize("order", ["degree", "bfs"])
def test_graph_report_on_tricsrz_maps_ids_back(tmp_path, order):
    """A ``.tricsrz`` written and loaded by each package: the report's node
    ids go back through ``new_to_old`` and equal the reference's."""
    ref_csr = ref_ingest(KARATE, cache_dir=tmp_path / "r")[0]
    port_csr = port_ingest(KARATE, cache_dir=tmp_path / "p")[0]
    ref_save_z(tmp_path / "r.tricsrz", ref_csr, order=order, nodes_per_block=8)
    port_save_z(tmp_path / "p.tricsrz", port_csr, order=order, nodes_per_block=8)
    want = ref_an.graph_report(ref_load_z(tmp_path / "r.tricsrz"), top_k=3)
    got = an.graph_report(port_load_z(tmp_path / "p.tricsrz"), top_k=3, device="cpu")
    assert_json_close(without_timings(got), without_timings(want))
    flat = ref_an.graph_report(ref_csr, top_k=3)
    assert got["clustering"]["top_nodes"] == flat["clustering"]["top_nodes"]


# ---------------------------------------------------------------------------
# the engine's pow2 planners
# ---------------------------------------------------------------------------


def _workloads(edges, tail):
    """The same workload for both packages' planners."""
    arrays = _padded_sub_csr(edges, keep_every=1, tail=tail)
    row, src, col, out = arrays
    ref_w = ref_engine.make_workload(row, col, out, src, col)
    port_w = engine.make_workload(row, col, out, src, col, device="cpu")
    return ref_w, port_w


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("tail", [0, 29])
@pytest.mark.parametrize("budget", [48, 300])
@pytest.mark.parametrize("bucket_pow2", [False, True])
@pytest.mark.parametrize("planner", ["wedge", "panel"])
def test_pow2_plans_equal_reference(graphs, planner, bucket_pow2, budget, tail):
    ref_w, port_w = _workloads(graphs["kron"], tail)
    if planner == "wedge":
        ref_b, port_b = ref_engine.WedgeBackend(), engine.WedgeBackend()
        fields = ("src", "dst", "start", "buffer")
    else:
        ref_b, port_b = ref_engine.PanelBackend(), engine.PanelBackend()
        fields = ("edge_idx", "u", "v", "width")
    want = ref_b.plan(ref_w, budget, bucket_pow2=bucket_pow2)
    got = port_b.plan(port_w, budget, bucket_pow2=bucket_pow2)
    assert (got.n_chunks, got.peak_buffer, got.total_wedges) == (
        want.n_chunks, want.peak_buffer, want.total_wedges)
    got_chunks, want_chunks = list(got.chunks), list(want.chunks)
    assert len(got_chunks) == len(want_chunks) == want.n_chunks > 1
    for g, w in zip(got_chunks, want_chunks):
        for f in fields:
            np.testing.assert_array_equal(_host(getattr(g, f)), np.asarray(getattr(w, f)), f)
    if bucket_pow2:
        rows = {len(_host(c[0])) for c in got_chunks}
        assert all(r & (r - 1) == 0 for r in rows)
        assert got.peak_buffer & (got.peak_buffer - 1) == 0 or planner == "panel"


class _Unread:
    """Stands in for a workload's host copy that must not be read."""

    def _refuse(self, *_, **__):
        raise AssertionError("the panel plan read a host copy")

    __getattr__ = __getitem__ = __array__ = __len__ = __iter__ = _refuse
    __lt__ = __le__ = __gt__ = __ge__ = __eq__ = __ne__ = _refuse


@pytest.mark.parametrize("tail", [0, 29])
@pytest.mark.parametrize("budget", [None, 48, 300])
@pytest.mark.parametrize("bucket_pow2", [False, True])
@pytest.mark.parametrize("backend", ["PanelBackend", "PallasBackend"])
def test_panel_plan_reads_no_host_copy(graphs, backend, bucket_pow2, budget, tail):
    """The panel plan runs on the workload's tensors alone and still
    equals the reference's host plan, field by field."""
    ref_w, port_w = _workloads(graphs["kron"], tail)
    port_w = port_w._replace(src_host=_Unread(), dst_host=_Unread(), deg_host=_Unread())
    want = ref_engine.PanelBackend().plan(ref_w, budget, bucket_pow2=bucket_pow2)
    got = getattr(engine, backend)().plan(port_w, budget, bucket_pow2=bucket_pow2)
    assert (got.n_chunks, got.peak_buffer, got.total_wedges) == (
        want.n_chunks, want.peak_buffer, want.total_wedges)
    got_chunks, want_chunks = list(got.chunks), list(want.chunks)
    assert len(got_chunks) == len(want_chunks) == want.n_chunks > 0
    for g, w in zip(got_chunks, want_chunks):
        assert g.width == w.width
        for f in ("edge_idx", "u", "v"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(w, f)), f)


@pytest.mark.parametrize("budget", [None, 48])
@pytest.mark.parametrize("bucket_pow2", [False, True])
def test_panel_chunks_are_int32_device_tensors(graphs, bucket_pow2, budget):
    """Every chunk field is an int32, contiguous, 1-D tensor on the
    workload's device, so the launch loop passes it on uncopied."""
    _, work = _workloads(graphs["kron"], 29)
    plan = engine.PallasBackend().plan(work, budget, bucket_pow2=bucket_pow2)
    chunks = list(plan.chunks)
    assert len(chunks) == plan.n_chunks > 0
    adj = engine._DeviceAdj(work.row_offsets, work.col, work.out_degree, work.n_steps)
    for c in chunks:
        for f in ("edge_idx", "u", "v"):
            t = getattr(c, f)
            assert isinstance(t, torch.Tensor) and t.dtype == torch.int32, f
            assert t.dim() == 1 and t.is_contiguous() and t.device == work.src_e.device, f
            assert adj.put(t) is t, f


@pytest.mark.parametrize("budget", [None, 48, 300])
@pytest.mark.parametrize("bucket_pow2", [False, True])
def test_iter_wedge_chunks_equals_reference(graphs, bucket_pow2, budget):
    edges = graphs["kron"]
    want_gen, *want_stats = ref_engine.iter_wedge_chunks(ref_prepare(edges), budget,
                                                         bucket_pow2=bucket_pow2)
    got_gen, *got_stats = engine.iter_wedge_chunks(prepare_oriented(edges, device="cpu"),
                                                   budget, bucket_pow2=bucket_pow2)
    assert got_stats == want_stats
    got, want = list(got_gen), list(want_gen)
    assert len(got) == len(want) == want_stats[0]
    for (gs, gd, gst), (ws, wd, wst) in zip(got, want):
        np.testing.assert_array_equal(_host(gs), np.asarray(ws))
        np.testing.assert_array_equal(_host(gd), np.asarray(wd))
        assert gst == wst


def test_next_pow2_equals_reference():
    for x in [-3, 0, 1, 2, 3, 4, 5, 63, 64, 65, 1 << 20, (1 << 20) + 1]:
        assert engine.next_pow2(x) == ref_engine.next_pow2(x)


# ---------------------------------------------------------------------------
# property test and import order
# ---------------------------------------------------------------------------


def _random_graph(rnd, n_max=24, m_max=60):
    n = rnd.randint(3, n_max)
    m = rnd.randint(0, m_max)
    pairs = [(rnd.randint(0, n - 1), rnd.randint(0, n - 1)) for _ in range(m)]
    pairs = [(u, v) for u, v in pairs if u != v]
    if not pairs:
        return np.zeros((0, 2), np.int32)
    return canonicalize_edges(np.array(pairs, np.int32))


@settings(max_examples=10, deadline=None)
@given(st.randoms())
def test_property_support_and_truss_equal_reference(rnd):
    """Random small graphs through wedge_bsearch: the port's support and
    trussness equal the reference's."""
    e = _random_graph(rnd)
    kw = dict(method="wedge_bsearch", max_wedge_chunk=16)
    assert_support_equal(an.edge_support(e, **kw, device="cpu"), ref_an.edge_support(e, **kw))
    assert_truss_equal(an.k_truss_decomposition(e, **kw, device="cpu"),
                       ref_an.k_truss_decomposition(e, **kw))


@pytest.mark.parametrize("first", ["repro_torch.analytics", "repro_torch.core"])
def test_both_import_orders_work(first):
    code = (f"import {first}\n"
            "import repro_torch.analytics as a, repro_torch.core as c\n"
            "assert c.local_clustering_coefficient.__module__ == 'repro_torch.core.clustering'\n"
            "assert a.graph_report and c.count_triangles_doulion and c.iter_wedge_chunks\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr
