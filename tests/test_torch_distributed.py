"""Port parity: the §III-E distributed path of repro_torch equals the reference's.

The port drives every stripe from one process over a
``repro_torch.distributed.Mesh``; here the mesh repeats the CPU K times,
the stand-in for the reference's simulated devices.  Held with tolerance 0:

* the numpy planners (``stripe_edges``, ``plan_striped_chunks``),
  ``oriented_csr_from_slabs``, the zigzag wire, ``stripe_skew_report``
  and ``StragglerMonitor`` against the reference's functions on the same
  inputs, and ``compressed_all_gather_int32`` against the reference's run
  under ``jax.vmap(..., axis_name="s")``;
* count, per-node, support (both wires), the truss peel and the
  incremental insert/delete at K ∈ {1, 2, 4, 8} and budgets None and 2048
  against the reference's single-device ``wedge_bsearch``; the plan stats
  (``n_chunks``, ``peak_wedge_buffer``, ``total_wedges``, ``n_stripes``,
  ``stripe_skew``, ``straggler_stripe``) against the reference's planners
  at every K, and against the reference's own distributed engine at K = 4,
  run once in a subprocess with 4 simulated devices
  (``conftest.run_multidevice``), with the truss's ``rounds`` and
  ``n_support_launches`` and the probes' ``n_probe_launches`` and
  ``peak_wedge_buffer``;
* a hypothesis property over random graphs × K ∈ 1–8 × budgets
  {None, 1, 64}, with the degenerate stripes pinned (empty, one edge,
  K > m);
* the reference's ``mode="drop"`` scatters (padded tails, sentinel ids),
  and the three CLIs' distributed flags on ``--device cpu``.
"""
import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # no hypothesis installed: use the local stub
    from _hypothesis_stub import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from conftest import run_multidevice  # noqa: E402
from repro.analytics import k_truss_decomposition as ref_truss  # noqa: E402
from repro.core import IncrementalTriangleCounter as RefIncremental  # noqa: E402
from repro.core import TriangleCounter as RefCounter  # noqa: E402
from repro.core import distributed as ref_dist  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.distributed import straggler as ref_straggler  # noqa: E402
from repro.graphs import canonicalize_edges, kronecker_rmat  # noqa: E402
from repro.graphs.formats import edge_array_to_csr  # noqa: E402
from repro.graphs.io import CSRGraph as RefCSRGraph  # noqa: E402
from repro.graphs.io import ingest as ref_ingest  # noqa: E402
from repro.graphs.io import load_tricsr_stripes as ref_load_stripes  # noqa: E402
from repro.graphs.io import save_tricsr_stripes as ref_save_stripes  # noqa: E402
from repro_torch import distributed as port_distributed  # noqa: E402
from repro_torch.analytics import k_truss_decomposition, support_on_arrays  # noqa: E402
from repro_torch.core import IncrementalTriangleCounter, TriangleCounter  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.distributed import Mesh, compression, straggler  # noqa: E402
from repro_torch.graphs.io import load_tricsr_stripes, save_tricsr_stripes  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KARATE = os.path.join(REPO, "tests", "data", "karate.txt")
KS = (1, 2, 4, 8)
BUDGETS = (None, 2048)
TRUSS_BUDGETS = (None, 64, 2048)  # karate holds 216 wedges: 64 cuts it into chunks
KINDS = ("count", "per_node", "support")
STAT_FIELDS = ("n_chunks", "peak_wedge_buffer", "total_wedges", "n_stripes",
               "stripe_skew", "straggler_stripe")

# the reference's distributed engine on 4 simulated devices, run once
_REF_MESH4 = """
import json
import numpy as np
import jax
from jax.sharding import Mesh
from repro.analytics.truss import k_truss_decomposition
from repro.core import IncrementalTriangleCounter, TriangleCounter
from repro.graphs.generators import kronecker_rmat
from repro.graphs.io import ingest

mesh = Mesh(np.array(jax.devices()[:4]), ("edges",))
out = {}
graphs = {"karate": ingest(KARATE)[0].edge_array(), "kron10": kronecker_rmat(10, seed=0)}
for name, e in graphs.items():
    for budget in (None, 2048):
        tc = TriangleCounter(method="distributed", mesh=mesh, max_wedge_chunk=budget)
        for kind, fn in (("count", tc.count), ("per_node", tc.per_node),
                         ("support", tc.edge_support)):
            fn(e)
            st = tc.last_stats
            out[f"{name}/{budget}/{kind}"] = dict(
                n_chunks=st.n_chunks, peak_wedge_buffer=st.peak_wedge_buffer,
                total_wedges=st.total_wedges, n_stripes=st.n_stripes,
                stripe_skew=st.stripe_skew, straggler_stripe=st.straggler_stripe,
                method=st.method)
e = graphs["karate"]
canon = np.asarray(e, np.int64).reshape(-1, 2)
half, rest = canon[: canon.shape[0] // 2], canon[canon.shape[0] // 2:]
for budget in (None, 64, 2048):
    td = k_truss_decomposition(e, max_wedge_chunk=budget, method="distributed", mesh=mesh)
    out[f"truss/{budget}"] = dict(rounds=td.rounds, n_support_launches=td.n_support_launches,
                                  method=td.method)
    inc = IncrementalTriangleCounter(half, max_wedge_chunk=budget, method="distributed",
                                     mesh=mesh)
    ups = []
    for op, batch in (("insert", rest), ("delete", rest[:40])):
        d = getattr(inc, op)(batch)
        s = inc.last_update_stats
        ups.append([d, s.n_probe_launches, s.peak_wedge_buffer, s.probe_method])
    out[f"inc/{budget}"] = ups
print("REF4", json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_mesh4():
    out = run_multidevice(f"KARATE = {KARATE!r}\n" + _REF_MESH4, n_devices=4)
    line = next(ln for ln in out.splitlines() if ln.startswith("REF4 "))
    return json.loads(line[5:])


@pytest.fixture(scope="module")
def graphs(small_graphs):
    return {**small_graphs, "karate": ref_ingest(KARATE)[0].edge_array(),
            "kron10": kronecker_rmat(10, seed=0)}


@pytest.fixture(scope="module")
def ref_wedge(graphs):
    """The reference's single-device wedge_bsearch results (budget-free)."""
    cache = {}

    def get(name, kind):
        if (name, kind) not in cache:
            tc = RefCounter(method="wedge_bsearch")
            fn = {"count": tc.count, "per_node": tc.per_node, "support": tc.edge_support}[kind]
            cache[name, kind] = fn(graphs[name])
        return cache[name, kind]

    return get


def cpu_mesh(k: int) -> Mesh:
    return Mesh(["cpu"] * k)


def host_csr(edges):
    """The oriented CSR's arrays as numpy, the input both packages' numpy
    planners read (the port's orientation is held to the reference's in
    tests/test_torch_preprocess.py)."""
    csr = engine.prepare_oriented(edges, device="cpu")
    return SimpleNamespace(src=csr.src.numpy(), col=csr.col.numpy(),
                           out_degree=csr.out_degree.numpy())


def ref_plan_stats(edges, k: int, budget, *, shorter_side=False) -> dict:
    """The plan stats the reference's distributed engine reports, from its
    own numpy planners (``stripe_edges``, ``plan_striped_chunks``,
    ``stripe_skew_report``) over the oriented CSR."""
    csr = host_csr(edges)
    deg = csr.out_degree
    src_sh, dst_sh, _ = ref_dist.stripe_edges(csr, k, shorter_side=shorter_side)
    reps = np.where(src_sh >= 0, deg[np.maximum(src_sh, 0)], 0).astype(np.int64)
    if shorter_side:
        reps = np.minimum(reps, np.where(dst_sh >= 0, deg[np.maximum(dst_sh, 0)], 0))
    bounds, eff = ref_dist.plan_striped_chunks(
        src_sh, deg, budget, dst_sh=dst_sh if shorter_side else None)
    rep = ref_straggler.stripe_skew_report(reps.sum(axis=1))
    return dict(n_chunks=len(bounds), peak_wedge_buffer=eff,
                total_wedges=int(reps.sum()), n_stripes=k, stripe_skew=rep.skew,
                straggler_stripe=rep.straggler_stripe)


def port_stats(tc) -> dict:
    st = tc.last_stats
    return {f: getattr(st, f) for f in STAT_FIELDS}


# ---------------------------------------------------------------------------
# names, mesh
# ---------------------------------------------------------------------------


def test_exports_match_reference():
    from repro.launch import mesh as ref_launch_mesh

    assert set(ref_dist.__all__) <= set(dist.__all__)
    assert set(ref_comp.__all__) <= set(compression.__all__)
    assert set(ref_straggler.__all__) == set(straggler.__all__)
    assert set(ref_launch_mesh.__all__) <= set(launch_mesh.__all__)
    import repro.distributed as ref_distributed

    assert set(ref_distributed.__all__) <= set(port_distributed.__all__)
    held = {"compressed_psum": (None, "s"), "compress_grads": (None, None, "s"),
            "make_error_feedback_state": (None,)}
    for name, args in held.items():
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            getattr(compression, name)(*args)
    for name in ("ShardingRules", "make_param_shardings", "spec_for"):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            getattr(port_distributed, name)()
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        port_distributed.LM_RULES.spec("layers/wq", 3)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        launch_mesh.make_production_mesh()
    import repro_torch.core as port_core
    import repro.core as ref_core

    ref_names = {n for n in ref_core.__all__ if "distributed" in n or "stripe" in n
                 or n == "DistributedBackend"}
    assert ref_names <= set(port_core.__all__)


def test_mesh_repeats_devices_and_resolves(monkeypatch):
    mesh = Mesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.lead == torch.device("cpu")
    assert int(np.prod(mesh.devices.shape)) == 3 and mesh.shape == {"edges": 3}
    assert mesh.distinct == (torch.device("cpu"),)
    grid = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "model"))
    assert grid.size == 4 and grid.shape == {"data": 2, "model": 2}
    x = torch.arange(5)
    assert mesh.replicate(x)[torch.device("cpu")] is x
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    with pytest.raises(ValueError, match="axis name"):
        Mesh(["cpu", "cpu"], ("a", "b"))
    with pytest.raises(ValueError, match="repeat"):
        Mesh([["cpu"]], ("a", "a"))
    with pytest.raises(TypeError, match="Mesh"):
        port_distributed.mesh_device(["cpu"])
    assert port_distributed.mesh_device(mesh, "cpu") == port_distributed.mesh_device(mesh)
    # a bare "cuda" is the current card; one mesh never mixes device types,
    # and an entry point's device= must be the mesh's lead
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert Mesh(["cuda", "cuda:0"]).distinct == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="one type"):
        Mesh(["cpu", "cuda"])
    with pytest.raises(ValueError, match="leads on cpu"):
        port_distributed.mesh_device(mesh, "cuda")


def test_launch_meshes_on_the_cpu():
    local = launch_mesh.make_local_mesh(device="cpu")
    assert local.axis_names == ("data", "model") and local.devices.shape == (1, 1)
    with pytest.raises(ValueError, match="requested 2×1 mesh on 1 devices"):
        launch_mesh.make_local_mesh(data=2, device="cpu")
    assert launch_mesh.make_local_mesh(data=1, device="cpu").size == 1
    with pytest.raises(ValueError, match="requested 1×2 mesh on 1 devices"):
        launch_mesh.make_local_mesh(data=1, model=2, device="cpu")


# ---------------------------------------------------------------------------
# host planners, the wire, skew: bit for bit against the reference
# ---------------------------------------------------------------------------


def test_stripe_edges_and_plans_match_reference(graphs):
    for name in ("karate", "kron", "triangle", "kron10"):
        csr = host_csr(graphs[name])
        deg = csr.out_degree
        for k in (1, 3, 8, 64):
            for shorter in (False, True):
                want = ref_dist.stripe_edges(csr, k, shorter_side=shorter)
                got = dist.stripe_edges(csr, k, shorter_side=shorter)
                for a, b in zip(got[:2], want[:2]):
                    np.testing.assert_array_equal(a, b)
                assert got[2] == want[2]
                for budget in (None, 1, 64, 2048):
                    dst = want[1] if shorter else None
                    assert dist.plan_striped_chunks(got[0], deg, budget, dst_sh=dst) == \
                        ref_dist.plan_striped_chunks(want[0], deg, budget, dst_sh=dst)


def test_zigzag_matches_reference():
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.integers(-2**31, 2**31, 5000, dtype=np.int64),
                        [0, -1, 1, -2, 2**31 - 1, -2**31, 2**30, -2**30 - 1]]).astype(np.int32)
    enc = compression.zigzag_encode(torch.from_numpy(d))
    want = np.asarray(ref_comp.zigzag_encode(jnp.asarray(d)))
    assert enc.dtype == torch.int32
    np.testing.assert_array_equal(enc.numpy(), want)
    np.testing.assert_array_equal(compression.zigzag_decode(enc).numpy(),
                                  np.asarray(ref_comp.zigzag_decode(jnp.asarray(want))))
    small = d[(d >= -2**30) & (d < 2**30)]  # where int32 zigzag is invertible
    np.testing.assert_array_equal(
        compression.zigzag_decode(compression.zigzag_encode(torch.from_numpy(small))).numpy(),
        small)
    for bound in (0, 1, 32767, 32768, 2**20):
        assert compression.can_narrow_int32(bound) == ref_comp.can_narrow_int32(bound)


@pytest.mark.parametrize("narrow", [True, False])
def test_compressed_all_gather_matches_reference(narrow):
    rng = np.random.default_rng(1)
    mesh = cpu_mesh(4)
    cases = [rng.integers(0, 16000, (4, 50)),          # lossless on both wires
             rng.integers(0, 2**20, (4, 33)),          # wraps on the narrow wire
             np.zeros((4, 0)),                         # empty vectors
             rng.integers(-2**31, 2**31, (4, 7))]      # any int32 (wide wire)
    for x in cases:
        x = x.astype(np.int32)
        want = jax.vmap(lambda v: ref_comp.compressed_all_gather_int32(v, "s", narrow=narrow),
                        axis_name="s")(jnp.asarray(x))
        want = np.asarray(want)[0]
        got = compression.compressed_all_gather_int32(
            [torch.from_numpy(r) for r in x], mesh, narrow=narrow)
        assert got.dtype == torch.int32 and got.device == mesh.lead
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.diff(x, axis=1).min(initial=0) < 0 or x.shape[1] < 2  # negative deltas
    np.testing.assert_array_equal(  # where the bound holds, the wire is lossless
        compression.compressed_all_gather_int32(
            [torch.from_numpy(r) for r in cases[0].astype(np.int32)], mesh).numpy(),
        cases[0])


def test_stripe_skew_and_straggler_monitor_match_reference():
    for loads in ([10, 10, 10, 100], [50, 51, 49, 50], [], [0, 0], [7], [3, 900, 4, 5, 6]):
        got = straggler.stripe_skew_report(loads)
        want = ref_straggler.stripe_skew_report(loads)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    a = straggler.stripe_skew_report([10, 10, 10, 100])
    b = straggler.stripe_skew_report([100, 10, 10, 10])
    ra = ref_straggler.stripe_skew_report([10, 10, 10, 100])
    rb = ref_straggler.stripe_skew_report([100, 10, 10, 10])
    assert straggler.skew_disagreement_note(a, b) == ref_straggler.skew_disagreement_note(ra, rb)
    assert straggler.skew_disagreement_note(a, a) is None
    times = [1.0] * 12 + [1.01, 5.0, 0.99, 1.02, 9.0]
    ours, theirs = straggler.StragglerMonitor(), ref_straggler.StragglerMonitor()
    assert [ours.observe(t) for t in times] == [theirs.observe(t) for t in times]
    assert ours.flags == theirs.flags and ours.median == theirs.median


def test_oriented_csr_from_slabs_matches_reference(tmp_path, graphs):
    canon = canonicalize_edges(graphs["kron10"])
    row, col = edge_array_to_csr(canon)
    base = str(tmp_path / "g.tricsr")
    ref_save_stripes(base, RefCSRGraph(row, col, row.shape[0] - 1), 5)
    slabs = ref_load_stripes(base, 5, verify=True)
    want = ref_dist.oriented_csr_from_slabs(slabs)
    got = dist.oriented_csr_from_slabs(slabs, device="cpu")
    for field in ("row_offsets", "src", "col", "out_degree", "degree"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    # the port's own slab files count on a mesh, empty slabs give 0
    port_base = str(tmp_path / "p.tricsr")
    from repro_torch.graphs.io import CSRGraph

    save_tricsr_stripes(port_base, CSRGraph(row, col, row.shape[0] - 1), 3)
    stats = {}
    got = dist.count_triangles_distributed_slabs(
        load_tricsr_stripes(port_base, 3, verify=True), cpu_mesh(4), max_wedge_chunk=2048,
        stats_out=stats)
    assert got == RefCounter(method="wedge_bsearch").count(graphs["kron10"])
    assert stats["n_chunks"] == ref_plan_stats(graphs["kron10"], 4, 2048)["n_chunks"]
    with pytest.raises(ValueError, match="no slabs"):
        dist.oriented_csr_from_slabs([], device="cpu")


# ---------------------------------------------------------------------------
# every workload at K ∈ {1, 2, 4, 8}
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", KS)
def test_striped_workloads_equal_wedge_and_reference_stats(k, graphs, ref_wedge, ref_mesh4):
    mesh = cpu_mesh(k)
    for name in ("karate", "er", "kron", "ws", "triangle", "kron10"):
        e = graphs[name]
        for budget in BUDGETS:
            tc = TriangleCounter(method="distributed", mesh=mesh, max_wedge_chunk=budget)
            plan = ref_plan_stats(e, k, budget)
            for kind in KINDS:
                fn = {"count": tc.count, "per_node": tc.per_node,
                      "support": tc.edge_support}[kind]
                got = fn(e)
                want = ref_wedge(name, kind)
                if kind == "count":
                    assert got == want, (name, k, budget)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=f"{name} {k} {budget} {kind}")
                st = tc.last_stats
                assert st.method == st.resolved_method == "distributed"
                assert st.fallback_reason is None
                assert port_stats(tc) == plan, (name, k, budget, kind)
                if k == 4 and f"{name}/{budget}/{kind}" in ref_mesh4:
                    ref = dict(ref_mesh4[f"{name}/{budget}/{kind}"])
                    assert ref.pop("method") == "distributed"
                    assert port_stats(tc) == ref, (name, budget, kind)


@pytest.mark.parametrize("k", KS)
def test_support_wires_and_shorter_side(k, graphs, ref_wedge):
    e = graphs["kron10"]
    mesh = cpu_mesh(k)
    csr = engine.prepare_oriented(e, device="cpu")
    work = engine.workload_from_csr(csr)
    want = ref_wedge("kron10", "support")
    assert compression.can_narrow_int32(int(csr.out_degree.max()))
    for budget in BUDGETS:
        for compress in (True, False):
            backend = engine.DistributedBackend(mesh, compress=compress)
            sup, plan = engine.run_workload(backend, "support", work, budget=budget)
            np.testing.assert_array_equal(sup, want, err_msg=f"{budget} {compress}")
            assert plan.n_stripes == k
        tc = TriangleCounter(method="distributed", mesh=mesh, shorter_side=True,
                             max_wedge_chunk=budget)
        assert tc.count(e) == ref_wedge("kron10", "count")
        assert port_stats(tc) == ref_plan_stats(e, k, budget, shorter_side=True)
        np.testing.assert_array_equal(tc.per_node(e), ref_wedge("kron10", "per_node"))
        np.testing.assert_array_equal(tc.edge_support(e), want)


def _halves(e):
    canon = np.asarray(e, np.int64).reshape(-1, 2)
    return canon[: canon.shape[0] // 2], canon[canon.shape[0] // 2:]


@pytest.fixture(scope="module")
def ref_truss_inc(graphs):
    """The reference's wedge_bsearch truss peels and incremental updates
    (karate, budgets None, 64 and 2048; kron at 256), computed once."""
    out = {"kron": ref_truss(graphs["kron"], max_wedge_chunk=256, method="wedge_bsearch")}
    half, rest = _halves(graphs["karate"])
    for budget in TRUSS_BUDGETS:
        ref = RefIncremental(half, max_wedge_chunk=budget, method="wedge_bsearch")
        ups = [(ref.count, ref.per_node())]
        for op, batch in (("insert", rest), ("delete", rest[:40])):
            ups.append((getattr(ref, op)(batch), ref.count, ref.per_node()))
        out[budget] = (ref_truss(graphs["karate"], max_wedge_chunk=budget,
                                 method="wedge_bsearch"), ups)
    return out


@pytest.mark.parametrize("k", KS)
def test_truss_and_incremental_equal_wedge(k, graphs, ref_mesh4, ref_truss_inc):
    mesh = cpu_mesh(k)
    e = graphs["karate"]
    half, rest = _halves(e)
    for budget in TRUSS_BUDGETS:
        want, ref_ups = ref_truss_inc[budget]
        got = k_truss_decomposition(e, max_wedge_chunk=budget, method="distributed", mesh=mesh)
        assert got.method == "distributed"
        np.testing.assert_array_equal(got.trussness, want.trussness)
        assert got.spectrum() == want.spectrum() and got.max_k == want.max_k
        assert got.rounds == want.rounds
        inc = IncrementalTriangleCounter(half, max_wedge_chunk=budget, method="distributed",
                                         mesh=mesh)
        assert inc.probe_method == "distributed" and inc.count == ref_ups[0][0]
        np.testing.assert_array_equal(inc.per_node(), ref_ups[0][1])
        ups = []
        for (op, batch), (delta, count, per_node) in zip(
                (("insert", rest), ("delete", rest[:40])), ref_ups[1:]):
            d = getattr(inc, op)(batch)
            assert (d, inc.count) == (delta, count), (op, budget)
            np.testing.assert_array_equal(inc.per_node(), per_node)
            s = inc.last_update_stats
            ups.append([d, s.n_probe_launches, s.peak_wedge_buffer, s.probe_method])
        if k == 4:
            r = ref_mesh4[f"truss/{budget}"]
            assert (got.rounds, got.n_support_launches) == (r["rounds"], r["n_support_launches"])
            assert ups == ref_mesh4[f"inc/{budget}"]
    kron = graphs["kron"]
    got = k_truss_decomposition(kron, max_wedge_chunk=256, method="auto", mesh=mesh)
    single = engine.resolve_method("auto", engine.prepare_oriented(kron, device="cpu").out_degree)
    assert got.method == ("distributed" if k > 1 else single)
    np.testing.assert_array_equal(got.trussness, ref_truss_inc["kron"].trussness)


def test_auto_resolves_to_distributed_on_a_multi_stripe_mesh(graphs):
    e = graphs["kron"]
    one = TriangleCounter(mesh=cpu_mesh(1))
    one.count(e)
    assert one.last_stats.method == "panel" and one.last_stats.n_stripes == 1  # by degree
    four = TriangleCounter(mesh=cpu_mesh(4))
    four.count(e)
    assert four.last_stats.method == "distributed" and four.last_stats.n_stripes == 4
    assert engine.choose_method(max_out_degree=3, mean_out_degree=1.0,
                                mesh=cpu_mesh(2)) == "distributed"
    # the reference's substitution when the mesh is missing
    backend, executed, reason = engine.resolve_backend("distributed", "count")
    assert executed == "wedge_bsearch" and "needs a mesh" in reason
    assert isinstance(backend, engine.WedgeBackend)


def test_stripe_times_under_a_tracer(graphs):
    from repro_torch import obs

    tc = TriangleCounter(method="distributed", mesh=cpu_mesh(3), max_wedge_chunk=2048)
    with obs.tracing() as trc:
        t = tc.count(graphs["kron10"])
    st = tc.last_stats
    assert t == RefCounter(method="wedge_bsearch").count(graphs["kron10"])
    assert len(st.stripe_times) == 3 and all(x > 0 for x in st.stripe_times)
    assert st.measured_stripe_skew >= 1.0
    assert (st.skew_note is None) == (st.measured_straggler_stripe == st.straggler_stripe)
    names = [ev["name"] for ev in trc.events]
    assert names.count("stripe.probe") == 3 * st.n_chunks
    tc.count(graphs["kron10"])  # untraced: no measured times
    assert tc.last_stats.stripe_times is None


# ---------------------------------------------------------------------------
# the reference's mode="drop" scatters, and the functions beside the engine
# ---------------------------------------------------------------------------


def test_out_of_range_ids_are_dropped(graphs, ref_wedge):
    out = torch.zeros(5, dtype=torch.int32)
    dist._add_in_range(out, torch.tensor([0, 4, 5, -1, 2**31 - 1, 2], dtype=torch.int32),
                       torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.int32))
    assert out.tolist() == [1, 0, 6, 0, 2]
    # a −1-padded src/col tail, pow2 buckets and more stripes than edges in a
    # chunk: every padded id runs past the output and is dropped
    from repro_torch.core import prepare_oriented

    csr = prepare_oriented(graphs["kron"], device="cpu")
    src, col = csr.src.numpy(), csr.col.numpy()
    m = src.shape[0]
    fill = np.full(m, -1, np.int32)
    for k, budget in ((3, None), (5, 64), (16, 1)):
        run = support_on_arrays(
            csr.row_offsets.numpy(), np.concatenate([src, fill]), np.concatenate([col, fill]),
            csr.out_degree.numpy(), max_wedge_chunk=budget, bucket_pow2=True,
            method="distributed", mesh=cpu_mesh(k))
        np.testing.assert_array_equal(run.support[:m], ref_wedge("kron", "support"))
        assert not run.support[m:].any() and run.method == "distributed"
    # the incremental probe's sentinel col tail (2**31 − 1) on lanes that miss
    row = csr.row_offsets
    col_pad = torch.cat([csr.col, torch.full((7,), 2**31 - 1, dtype=torch.int32)])
    src_sh, dst_sh, wedges = dist.stripe_edges(csr, 3)
    f = dist.striped_workload_fn(cpu_mesh(3), "per_node", wedges + 64, 12, n_out=csr.n_nodes)
    got = f(src_sh, dst_sh, 0, row, col_pad, csr.out_degree)
    np.testing.assert_array_equal(got.numpy(), ref_wedge("kron", "per_node"))


def test_count_functions_beside_the_engine(graphs, ref_wedge):
    e = graphs["kron10"]
    want = ref_wedge("kron10", "count")
    assert dist.count_triangles_distributed_panel(e, cpu_mesh(3)) == want
    for k in (1, 3):
        mesh = cpu_mesh(k)
        assert dist.count_triangles_distributed(e, mesh) == want
        assert dist.count_triangles_distributed(e, mesh, shorter_side=True,
                                                max_wedge_chunk=2048) == want
        stats = {}
        from repro_torch.core import prepare_oriented

        csr = prepare_oriented(e, device="cpu")
        assert dist.count_triangles_distributed_csr(csr, mesh, max_wedge_chunk=2048,
                                                    stats_out=stats) == want
        plan = ref_plan_stats(e, k, 2048)
        assert (stats["n_chunks"], stats["peak_wedge_buffer"]) == \
            (plan["n_chunks"], plan["peak_wedge_buffer"])
    assert dist.count_triangles_distributed(np.zeros((0, 2), np.int32), cpu_mesh(2)) == 0
    with pytest.raises(ValueError, match="unknown striped workload"):
        dist.striped_workload_fn(cpu_mesh(2), "bogus", 8, 1)


# ---------------------------------------------------------------------------
# the property: random graphs × K × budgets
# ---------------------------------------------------------------------------


def _random_edges(rnd, n, m):
    if m == 0:
        return np.zeros((0, 2), np.int32)
    u = np.array([rnd.randrange(n) for _ in range(m)], np.int32)
    v = np.array([rnd.randrange(n) for _ in range(m)], np.int32)
    return canonicalize_edges(np.stack([u, v], axis=1))


def _check_striped(e, k, budget):
    ref = RefCounter(method="wedge_bsearch", max_wedge_chunk=budget)
    tc = TriangleCounter(method="distributed", mesh=cpu_mesh(k), max_wedge_chunk=budget)
    assert tc.count(e) == ref.count(e)
    if e.shape[0]:
        assert tc.last_stats.method == "distributed"
        assert port_stats(tc) == ref_plan_stats(e, k, budget)
    np.testing.assert_array_equal(tc.per_node(e), np.asarray(ref.per_node(e)))
    np.testing.assert_array_equal(tc.edge_support(e), np.asarray(ref.edge_support(e)))


@settings(max_examples=20, deadline=None)
@given(st.randoms(), st.integers(2, 40), st.integers(0, 120),
       st.integers(1, 8), st.sampled_from([None, 1, 64]))
def test_property_striped_equals_wedge_random_graphs(rnd, n, m, k, budget):
    _check_striped(_random_edges(rnd, n, m), k, budget)


@pytest.mark.parametrize("edges", [
    np.zeros((0, 2), np.int32),                                          # empty
    np.array([[0, 1], [1, 0]], np.int32),                                # one edge
    np.array([[0, 1], [1, 2], [0, 2], [1, 0], [2, 1], [2, 0]], np.int32),  # K > m
], ids=["empty", "one_edge", "k_over_m"])
def test_degenerate_stripes(edges):
    for budget in (None, 1):
        _check_striped(edges, 8, budget)


# ---------------------------------------------------------------------------
# the CLIs on --device cpu
# ---------------------------------------------------------------------------


def test_count_cli_distributed_on_the_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import count as cli

    for extra in ([], ["--max-wedge-chunk", "64"]):
        monkeypatch.setattr(sys, "argv", ["count", "--input", KARATE, "--device", "cpu",
                                          "--cache-dir", str(tmp_path), "--json",
                                          "--distributed", *extra])
        cli.main()
        cap = capsys.readouterr()
        out = json.loads(cap.out.strip().splitlines()[-1])
        assert out["triangles"] == 45 and out["method"] == "distributed"
        assert "mesh: 1 stripe(s) on 1 device(s)" in cap.err
        assert "stripes: 1," in cap.err


def test_serve_graph_cli_distributed_on_the_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve_graph as cli

    monkeypatch.setattr(sys, "argv", [
        "serve_graph", "--input", KARATE, "--batch-size", "16", "--queries-per-batch", "1",
        "--method", "distributed", "--device", "cpu",
        "--cache-dir", str(tmp_path)])
    cli.main()
    out = capsys.readouterr().out
    assert "mesh: 1 device(s) striped on axis 'edges'" in out
    assert "probe backend: distributed" in out
    assert "verify: from-scratch recount agrees (T = 45)" in out


def test_panel_stripe_totals_are_int64():
    """A stripe's panel total sums every row of its stripe, which no chunk
    bounds, so it is int64 (each row's count stays an int32 partial); the
    reference keeps that total in int32, which would wrap at 2^31 triangles
    a stripe."""
    mesh = cpu_mesh(2)
    # the triangle (0, 1, 2) oriented: 0→1, 0→2, 1→2; one query edge a stripe
    row = torch.tensor([0, 2, 3, 3], dtype=torch.int32)
    col = torch.tensor([1, 2, 2], dtype=torch.int32)
    deg = torch.tensor([2, 1, 0], dtype=torch.int32)
    fn, widths = dist.make_distributed_panel_count_fn(mesh, {16: 2})
    src = np.array([[0, 1], [0, -1]], np.int32)
    dst = np.array([[1, 2], [2, -1]], np.int32)
    got = fn(src, dst, row, col, deg)
    assert widths == [16] and got.dtype == torch.int64
    assert got.tolist() == [1, 0]
