"""Port parity: repro_torch's multi-tenant graph service.

* the multi-tenant cases of tests/test_serve.py on the port, on the CPU:
  a fused window answers bit-identically to sequential execution on every
  backend, queued updates and a snapshot keep their order, eviction and
  re-admission round-trip under a tight budget, compressed residency is
  charged its compressed bytes, and the admission policies fire;
* the port's fused answers (count, per-node, clustering, transitivity,
  support, truss) equal the reference ``GraphService``'s on the same
  graphs, and ``run_load`` reports the reference's keys;
* ``python -m repro_torch.serve.loadgen --device cpu`` on karate equals
  the reference CLI's triangles and fusion proof.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import TriangleCounter as RefCounter  # noqa: E402
from repro.serve import GraphManager as RefManager  # noqa: E402
from repro.serve import GraphService as RefService  # noqa: E402
from repro.serve import run_load as ref_run_load  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import IncrementalTriangleCounter, TriangleCounter  # noqa: E402
from repro_torch.graphs import STREAM_GENERATORS  # noqa: E402
from repro_torch.graphs.generators import kronecker_rmat  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    DEFAULT_MIX,
    AdmissionQueue,
    ClassPolicy,
    GraphManager,
    GraphService,
    QueryTimeout,
    QueueOverflow,
    SnapshotStore,
    attest_fusion,
    run_load,
)
from repro_torch.serve.admission import Request, Ticket  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KARATE = "karate"
CPU = "cpu"


@pytest.fixture
def manager(tmp_path):
    return GraphManager(str(tmp_path / "cache"), device=CPU)


def _service(manager, **kw):
    kw.setdefault("method", "wedge_bsearch")
    return GraphService(manager, device=CPU, **kw)


def _engine_passes() -> int:
    return int(obs.metrics_snapshot()["counters"].get("serve.engine_passes", 0))


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["wedge_bsearch", "panel", "pallas"])
def test_fused_batch_bit_identical_to_sequential(manager, method):
    kinds = ["count", "per_node", "clustering", "transitivity", "count", "clustering"]
    engine = TriangleCounter(method=method, device=CPU)
    manager.attach(KARATE, KARATE)
    with manager.lease(KARATE) as ent:
        csr = ent.csr
        seq = {
            "count": engine.count(csr),
            "per_node": engine.per_node(csr),
            "clustering": engine.clustering(csr),
            "transitivity": engine.transitivity(csr),
        }
    with GraphService(manager, method=method, start=False, device=CPU) as svc:
        tickets = [svc.submit(KARATE, k) for k in kinds]
        before = _engine_passes()
        svc.start()
        answers = [t.result(120.0) for t in tickets]
        assert _engine_passes() - before == 1

    for kind, got in zip(kinds, answers):
        want = seq[kind]
        if kind == "per_node":
            assert got.dtype == want.dtype and np.array_equal(got, want)
        elif kind == "clustering":
            assert np.array_equal(got, want)
        else:
            assert got == want


def test_support_matches_engine(manager):
    manager.attach(KARATE, KARATE)
    with _service(manager) as svc:
        got = svc.query(KARATE, "support", timeout=120.0)
    with manager.lease(KARATE) as ent:
        want = TriangleCounter(method="wedge_bsearch", device=CPU).edge_support(ent.csr)
    assert np.array_equal(got, want)
    assert int(got.sum(dtype=np.int64)) == 3 * 45


def test_attest_fusion_helper(manager):
    manager.attach(KARATE, KARATE)
    with _service(manager, start=False) as svc:
        rep = attest_fusion(svc, KARATE, n=12)
    assert rep["fused"] and rep["consistent"] and rep["count"] == 45
    assert rep["engine_passes"] == 1 and rep["fused_queries"] == 12


def _stream(edges, **kw):
    kw.setdefault("window", 300)
    kw.setdefault("batch_size", 64)
    kw.setdefault("seed", 5)
    return STREAM_GENERATORS["sliding_window"](edges, **kw)


@pytest.mark.parametrize("method", ["wedge_bsearch", "pallas"])
def test_snapshot_restore_preserves_pending_batches(tmp_path, method):
    edges = kronecker_rmat(6, edge_factor=8, seed=11)
    n_nodes = int(edges.max()) + 1
    batches = list(_stream(edges, window=200, batch_size=32, seed=2))
    assert len(batches) >= 6
    store = SnapshotStore(str(tmp_path / "snap"))

    mgr = GraphManager(str(tmp_path / "cache"), device=CPU)
    with _service(mgr, start=False, method=method) as svc:
        svc.open_session("g", n_nodes=n_nodes)
        pre = [svc.update("g", insert=b.insert, delete=b.delete) for b in batches[:4]]
        snap_ticket = svc.snapshot("g", store)
        post = [svc.update("g", insert=b.insert, delete=b.delete) for b in batches[4:6]]
        svc.start()
        for t in pre + [snap_ticket] + post:
            t.result(120.0)
        final_live = svc.session("g").counter

    oracle = IncrementalTriangleCounter(n_nodes=n_nodes, device=CPU)
    for b in batches[:6]:
        oracle.apply(insert=b.insert, delete=b.delete)
    assert final_live.count == oracle.count

    sess, _ = SnapshotStore(str(tmp_path / "snap")).restore_session("g2", device=CPU)
    assert sess.cursor == 4
    for b in batches[4:6]:
        sess.apply(insert=b.insert, delete=b.delete)
    assert sess.counter.count == oracle.count
    assert np.array_equal(sess.counter.per_node(), oracle.per_node())


def test_eviction_readmission_roundtrip(tmp_path):
    mgr = GraphManager(str(tmp_path / "cache"), memory_budget_bytes=1, device=CPU)
    mgr.attach("a", KARATE)
    mgr.attach("b", KARATE, fallback_scale=None)
    with _service(mgr) as svc:
        first = svc.query("a", "count", timeout=120.0)
        assert mgr.resident_names() == ["a"]
        svc.query("b", "count", timeout=120.0)
        assert "a" not in mgr.resident_names()
        again = svc.query("a", "count", timeout=120.0)
    assert first == again == 45
    assert mgr.stats()["graphs"]["a"]["loads"] == 2
    assert obs.metrics_snapshot()["counters"].get("serve.graph_evictions", 0) >= 1


def test_pinned_graphs_never_evicted(tmp_path):
    mgr = GraphManager(str(tmp_path / "cache"), memory_budget_bytes=1, device=CPU)
    mgr.attach("a", KARATE)
    mgr.attach("b", KARATE)
    with mgr.lease("a") as ent:
        assert ent.resident
        with mgr.lease("b"):
            pass
        assert "a" in mgr.resident_names()
    assert mgr.evict("a")


def test_budget_charges_resident_not_decompressed_bytes(tmp_path):
    rng = np.random.default_rng(7)
    e = rng.integers(0, 400, size=(6000, 2))
    e = e[e[:, 0] != e[:, 1]]
    src = tmp_path / "g.txt"
    np.savetxt(src, e, fmt="%d")

    sizer = GraphManager(str(tmp_path / "cache"), device=CPU)
    sizer.attach("flat", str(src))
    sizer.attach("z", str(src), storage="compressed", order="degree")
    with sizer.lease("flat") as ent:
        flat_bytes = ent.nbytes
        flat_count = TriangleCounter(method="wedge_bsearch", device=CPU).count(ent.csr)
        flat_pn = TriangleCounter(method="wedge_bsearch", device=CPU).per_node(ent.csr)
    with sizer.lease("z") as ent:
        z_bytes = ent.nbytes
    assert z_bytes < flat_bytes / 2

    budget = z_bytes + (flat_bytes - z_bytes) // 4
    mgr = GraphManager(str(tmp_path / "cache"), memory_budget_bytes=budget, device=CPU)
    mgr.attach("z", str(src), storage="compressed", order="degree")
    with _service(mgr) as svc:
        assert svc.query("z", "count", timeout=120.0) == flat_count
        pn = svc.query("z", "per_node", timeout=120.0)
    assert np.array_equal(pn, flat_pn)
    assert mgr.resident_bytes() <= budget
    mgr.attach("flat", str(src))
    with mgr.lease("flat"):
        pass
    assert "flat" in mgr.resident_names()


def test_unattached_graph_rejects(manager):
    with _service(manager) as svc:
        with pytest.raises(KeyError):
            svc.query("nope", "count", timeout=30.0)


def test_timeout_policy_expires_stale_requests(manager):
    manager.attach(KARATE, KARATE)
    policies = {"point": ClassPolicy(max_queue=64, timeout_s=0.0, max_batch=8)}
    with _service(manager, policies=policies, start=False) as svc:
        tickets = [svc.submit(KARATE, "count") for _ in range(3)]
        time.sleep(0.01)
        svc.start()
        for t in tickets:
            with pytest.raises(QueryTimeout):
                t.result(60.0)
    assert obs.metrics_snapshot()["counters"]["serve.timeouts"] >= 3


def test_queue_overflow_rejects_at_admission(manager):
    manager.attach(KARATE, KARATE)
    policies = {"point": ClassPolicy(max_queue=2, timeout_s=None, max_batch=8)}
    with _service(manager, policies=policies, start=False) as svc:
        svc.submit(KARATE, "count")
        svc.submit(KARATE, "count")
        with pytest.raises(QueueOverflow):
            svc.submit(KARATE, "count")
        svc.start()


def test_heavy_lane_does_not_block_point_lane(manager):
    manager.attach(KARATE, KARATE)
    with _service(manager) as svc:
        heavy = svc.submit(KARATE, "truss")
        t0 = time.perf_counter()
        got = svc.query(KARATE, "count", timeout=60.0)
        point_latency = time.perf_counter() - t0
        assert got == 45
        heavy.result(300.0)
    assert point_latency < 30.0


def test_close_rejects_pending(manager):
    manager.attach(KARATE, KARATE)
    svc = _service(manager, start=False)
    t = svc.submit(KARATE, "count")
    svc.close()
    with pytest.raises(RuntimeError):
        t.result(10.0)
    with pytest.raises(RuntimeError):
        svc.submit(KARATE, "count")


def test_collect_respects_max_batch_and_order():
    q = AdmissionQueue({"point": ClassPolicy(max_queue=16, max_batch=3)})
    for i in range(5):
        q.submit(Request("g", "count", {"i": i}, "point", Ticket("count", "point")))
    assert [r.params["i"] for r in q.collect(("point",))] == [0, 1, 2]
    assert [r.params["i"] for r in q.collect(("point",))] == [3, 4]


def test_collect_blocks_until_submit_or_close():
    q = AdmissionQueue({"point": ClassPolicy()})
    got = []
    t = threading.Thread(target=lambda: got.append(q.collect(("point",))))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()
    q.close()
    t.join(10.0)
    assert got == [[]]


def test_concurrent_load_fuses_and_stays_correct(manager):
    manager.attach(KARATE, KARATE)
    results = []
    lock = threading.Lock()
    with _service(manager) as svc:
        def client():
            for _ in range(5):
                c = svc.query(KARATE, "count", timeout=120.0)
                with lock:
                    results.append(c)

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert len(results) == 30 and all(c == 45 for c in results)


# ---------------------------------------------------------------------------
# against the reference service
# ---------------------------------------------------------------------------


def _edge_file(tmp_path):
    e = kronecker_rmat(7, edge_factor=8, seed=3)
    path = tmp_path / "kron7.txt"
    np.savetxt(path, e[e[:, 0] < e[:, 1]], fmt="%d")
    return str(path)


@pytest.mark.parametrize("method", ["wedge_bsearch", "pallas"])
@pytest.mark.parametrize("graph", ["karate", "kron7"])
def test_fused_answers_equal_the_reference_service(tmp_path, graph, method):
    source = KARATE if graph == "karate" else _edge_file(tmp_path)
    kinds = ["count", "per_node", "clustering", "transitivity", "support", "truss", "count"]

    def answers(svc):
        svc.attach(graph, source)
        tickets = [svc.submit(graph, k) for k in kinds]
        svc.start()
        return [t.result(300.0) for t in tickets]

    port_mgr = GraphManager(str(tmp_path / "p"), device=CPU)
    with GraphService(port_mgr, method=method, start=False, device=CPU) as svc:
        got = answers(svc)
    with RefService(RefManager(str(tmp_path / "r")), method="wedge_bsearch",
                    start=False) as svc:
        want = answers(svc)
    for kind, g, w in zip(kinds, got, want):
        if kind == "truss":
            for f in ("u", "v", "trussness", "max_k", "n_nodes"):
                np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                              np.asarray(getattr(w, f)), err_msg=f)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), kind
        else:
            assert g == w, kind


def test_run_load_reports_the_reference_keys(tmp_path):
    mgr = GraphManager(str(tmp_path / "p"), device=CPU)
    with GraphService(mgr, method="pallas", device=CPU) as svc:
        svc.attach(KARATE, KARATE)
        port = run_load(svc, KARATE, clients=3, requests_per_client=4, mix=DEFAULT_MIX)
    with RefService(RefManager(str(tmp_path / "r")), method="wedge_bsearch") as svc:
        svc.attach(KARATE, KARATE)
        ref = ref_run_load(svc, KARATE, clients=3, requests_per_client=4)
    assert set(port) == set(ref)
    assert set(port["counters"]) == set(ref["counters"])
    assert port["n_ok"] == 12 and port["errors"] == {"timeouts": 0, "overflows": 0, "other": 0}
    for snap in port["latency"].values():
        assert set(snap) == set(next(iter(ref["latency"].values())))


def test_run_load_with_a_session_under_read_load(tmp_path):
    """The update lane applies a stream to a session while clients read it;
    the session's count ends equal to a recount of its live edges."""
    edges = kronecker_rmat(7, edge_factor=8, seed=5)
    n_nodes = int(edges.max()) + 1
    mgr = GraphManager(str(tmp_path / "p"), device=CPU)
    with GraphService(mgr, method="pallas", device=CPU) as svc:
        svc.open_session("s", n_nodes=n_nodes)
        rep = run_load(svc, "s", clients=2, requests_per_client=6,
                       update_stream=iter(_stream(edges, window=400, batch_size=96)),
                       max_updates=5)
        live, n = svc.session("s").edges_snapshot()
        count = svc.session("s").counter.count
    assert rep["n_updates"] == 5 and rep["errors"]["other"] == 0
    assert count == RefCounter().count(live, n) > 0


def test_loadgen_cli_equals_reference(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"

    def run(module, *extra):
        r = subprocess.run([sys.executable, "-m", module, "--dataset", KARATE, "--attest-fusion",
                            "--json", "--requests", "5", "--cache-dir",
                            str(tmp_path / module), *extra],
                           capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
        assert r.returncode == 0, r.stderr
        return json.loads(r.stdout.strip().splitlines()[-1])

    port = run("repro_torch.serve.loadgen", "--device", CPU, "--method", "pallas")
    ref = run("repro.serve.loadgen", "--method", "wedge_bsearch")
    assert port["triangles"] == ref["triangles"] == 45
    assert port["fusion"] == ref["fusion"]
    assert port["fusion"]["fused"] is True
    assert set(port["load"]) == set(ref["load"])
    assert port["load"]["n_ok"] == ref["load"]["n_ok"] == 20


def test_loadgen_cli_default_device_is_the_card(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    from repro_torch.serve import loadgen

    monkeypatch.setattr(sys, "argv", ["loadgen", "--cache-dir", str(tmp_path / "c")])
    with pytest.raises(SystemExit) as exc:
        loadgen.main()
    assert "--device cuda" in str(exc.value) and "device='cpu'" in str(exc.value)
    assert not (tmp_path / "c").exists()


def test_manager_and_service_devices_must_agree(tmp_path):
    mgr = GraphManager(str(tmp_path), device=CPU)
    mgr.tuner.device = torch.device("cuda", 0)  # a manager made for the card
    with pytest.raises(ValueError, match="tuner measures on cuda:0"):
        GraphService(mgr, device=CPU, start=False)


@pytest.mark.cuda
def test_service_on_the_card_runs_the_csr_kernels(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 8h serves kron-21 there)")
    from repro_torch.kernels.triangle_count import launches, reset_launches

    mgr = GraphManager(str(tmp_path / "c"))
    with GraphService(mgr, method="pallas", start=False) as svc:
        svc.attach(KARATE, KARATE)
        reset_launches()
        rep = attest_fusion(svc, KARATE, n=8)
    assert rep["fused"] and rep["count"] == 45
    assert launches["intersect_per_node_csr"] > 0 and launches["intersect_per_node"] == 0


def test_launch_counters_add_up_across_threads():
    """The service's lanes launch from several threads: no launch count is
    lost (the counters are read-modify-writes under a lock)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.triangle_count import launches, reset_launches
    from repro_torch.kernels.triangle_count import triangle_count as tc

    n_threads, per = 16, 2000
    before = fa.launches["flash_attention"]

    def hammer():
        for _ in range(per):
            tc._count_launch("intersect_per_node_csr")
            with fa._launches_lock:
                fa.launches["flash_attention"] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reset_launches()
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert launches["intersect_per_node_csr"] == n_threads * per
    assert fa.launches["flash_attention"] - before == n_threads * per
    reset_launches()


def test_shared_tuner_tunes_a_shape_once_across_threads(tmp_path):
    """Lanes missing the same shape at once: one sweep, the rest hits."""
    from repro_torch.core import AutoTuner

    tuner = AutoTuner(tmp_path / "tiles.json", tune_on_miss=True, iters=1, device=CPU)
    picks = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: picks.append(tuner.tiles(40, 16, 16)))
                   for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert tuner.n_tuned == 1 and tuner.n_hits == 11
    assert len(set(picks)) == 1 and picks[0] is not None
