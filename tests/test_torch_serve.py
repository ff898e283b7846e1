"""Port parity: repro_torch's checkpoint, stream sessions and snapshots.

* the reference's checkpoint durability cases (versioning, crc32, atomic
  publish, async GC) on :mod:`repro_torch.checkpoint`;
* leaf keys and manifests equal the reference's for the same tree, so a
  checkpoint or a session snapshot written by either package restores in
  the other;
* ``drive_stream`` reports the reference's keys and counts;
* kill → restore → resume equals the uninterrupted session.
"""
import json
import os
import threading
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import restore_latest as ref_restore_latest  # noqa: E402
from repro.checkpoint import save_checkpoint as ref_save_checkpoint  # noqa: E402
from repro.graphs import STREAM_GENERATORS as REF_STREAMS  # noqa: E402
from repro.serve import SnapshotStore as RefSnapshotStore  # noqa: E402
from repro.serve import drive_stream as ref_drive_stream  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    FORMAT_VERSION,
    CheckpointManager,
    list_checkpoints,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
)
from repro_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.core import IncrementalTriangleCounter  # noqa: E402
from repro_torch.graphs import STREAM_GENERATORS  # noqa: E402
from repro_torch.graphs.generators import kronecker_rmat  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    QUERY_KINDS,
    SnapshotStore,
    StreamSession,
    drive_stream,
    load_latest_state,
    session_template,
)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "b": rng.standard_normal(3).astype(np.float32),
        "step": np.asarray(seed, np.int64),
    }


def _template():
    return {
        "w": np.zeros((4, 3), np.float32),
        "b": np.zeros(3, np.float32),
        "step": np.asarray(0, np.int64),
    }


# ---------------------------------------------------------------------------
# the reference's checkpoint cases, on the port's checkpoint
# ---------------------------------------------------------------------------


def test_roundtrip_with_extra(tmp_path):
    d = str(tmp_path)
    tree = _tree(1)
    save_checkpoint(d, 7, tree, extra={"note": "x"})
    got, step, extra = restore_latest(d, _template())
    assert step == 7 and extra == {"note": "x"}
    for k in tree:
        assert np.array_equal(np.asarray(got[k]), tree[k])
        assert got[k].dtype == tree[k].dtype


def test_manifest_carries_format_version(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, _tree())
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert m["format_version"] == FORMAT_VERSION == 2
    assert set(m["leaves"]) == {"w", "b", "step"}
    for meta in m["leaves"].values():
        assert {"shape", "dtype", "crc32"} <= set(meta)


def _rewrite_manifest(path, fn):
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    fn(m)
    with open(mpath, "w") as f:
        json.dump(m, f)


def test_version_mismatch_is_skipped(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1))
    path2 = save_checkpoint(d, 2, _tree(2))
    _rewrite_manifest(path2, lambda m: m.update(format_version=FORMAT_VERSION + 1))
    _, step, _ = restore_latest(d, _template())
    assert step == 1
    with pytest.raises(ValueError):
        restore_checkpoint(path2, _template())


def test_unversioned_seed_manifest_is_skipped(tmp_path):
    d = str(tmp_path)
    path = save_checkpoint(d, 1, _tree())
    _rewrite_manifest(path, lambda m: m.pop("format_version"))
    assert restore_latest(d, _template()) is None


def test_truncated_arrays_are_skipped(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1))
    path2 = save_checkpoint(d, 2, _tree(2))
    npz = os.path.join(path2, "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    _, step, _ = restore_latest(d, _template())
    assert step == 1


def test_bitflip_corruption_detected_by_crc(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1))
    path2 = save_checkpoint(d, 2, _tree(2))
    npz = os.path.join(path2, "arrays.npz")
    with zipfile.ZipFile(npz) as z:
        payload = z.read("w.npy")  # stored uncompressed: bytes appear verbatim
    blob = bytearray(open(npz, "rb").read())
    idx = blob.find(payload)
    assert idx >= 0
    blob[idx + len(payload) - 4] ^= 0xFF
    with open(npz, "wb") as f:
        f.write(bytes(blob))
    got = restore_latest(d, _template())
    assert got is not None and got[1] == 1


def test_missing_commit_marker_is_torn(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1))
    path2 = save_checkpoint(d, 2, _tree(2))
    os.unlink(os.path.join(path2, "COMMIT"))
    _, step, _ = restore_latest(d, _template())
    assert step == 1


def test_missing_leaf_raises(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, _tree())
    with pytest.raises(KeyError, match="extra_leaf"):
        restore_checkpoint(path, {**_template(), "extra_leaf": np.zeros(2)})


def test_overwrite_same_step_is_atomic(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree(1))
    save_checkpoint(d, 3, _tree(2))
    got, step, _ = restore_latest(d, _template())
    assert step == 3 and np.array_equal(np.asarray(got["w"]), _tree(2)["w"])
    assert not os.path.exists(os.path.join(d, "step_000000003.old"))


def test_tmp_and_old_dirs_invisible_to_listing(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_000000002.tmp"))
    os.makedirs(os.path.join(d, "step_000000009.old"))
    os.makedirs(os.path.join(d, "step_garbage"))
    assert [s for s, _ in list_checkpoints(d)] == [1]
    assert list_checkpoints(os.path.join(d, "absent")) == []


def test_manager_retention_keeps_newest(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2, async_save=False)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert [s for s, _ in list_checkpoints(d)] == [3, 4]
    with pytest.raises(ValueError):
        CheckpointManager(d, keep=0)


def test_manager_gc_never_deletes_torn_dirs(tmp_path):
    d = str(tmp_path)
    torn = os.path.join(d, "step_000000000")
    os.makedirs(torn)  # no COMMIT
    mgr = CheckpointManager(d, keep=1, async_save=False)
    for s in range(1, 4):
        mgr.save(s, _tree(s))
    assert os.path.isdir(torn)
    _, step, _ = restore_latest(d, _template())
    assert step == 3


def test_async_save_is_safe_against_gc_race(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2, async_save=True)
    for s in range(8):
        mgr.save(s, _tree(s))
    mgr.wait()
    assert [s for s, _ in list_checkpoints(d)] == [6, 7]
    got, step, _ = mgr.restore_latest(_template())
    assert step == 7 and np.array_equal(np.asarray(got["w"]), _tree(7)["w"])


def test_async_save_copies_before_returning(tmp_path):
    """The tree is copied to the host at save(): mutating it (array or
    tensor) while the background write runs changes nothing on disk."""
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=2, async_save=True)
    tree = {"a": np.arange(4, dtype=np.int64), "t": torch.arange(3, dtype=torch.int32)}
    mgr.save(1, tree)
    tree["a"][:] = -1
    tree["t"][:] = -1
    mgr.wait()
    got, _, _ = restore_latest(d, {"a": np.zeros(0, np.int64), "t": np.zeros(0, np.int32)})
    np.testing.assert_array_equal(got["a"], np.arange(4))
    np.testing.assert_array_equal(got["t"], np.arange(3))


def test_async_save_surfaces_background_errors(tmp_path, monkeypatch):
    """A failed background write raises on the next wait(), once."""
    import repro_torch.checkpoint.checkpoint as ck

    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(1, _tree(1))
    mgr.wait()

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "save_checkpoint", fail)
    mgr.save(2, _tree(2))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # the error surfaced once
    monkeypatch.undo()
    mgr.save(3, _tree(3))
    mgr.wait()
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [1, 3]


def test_sync_save_raises_its_error(tmp_path, monkeypatch):
    import repro_torch.checkpoint.checkpoint as ck

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "save_checkpoint", fail)
    with pytest.raises(OSError, match="disk full"):
        CheckpointManager(str(tmp_path), async_save=False).save(1, _tree(1))


def test_concurrent_saves_serialize(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep=4, async_save=True)
    errs = []

    def writer(base):
        try:
            for s in range(base, base + 4):
                mgr.save(s, _tree(s))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(b,)) for b in (0, 10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    mgr.wait()
    assert not errs
    assert restore_latest(d, _template()) is not None
    assert len(list_checkpoints(d)) <= 4 + 1


def test_tensor_leaves_round_trip(tmp_path):
    tree = {"t": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "f": torch.linspace(0, 1, 5, dtype=torch.float64)}
    save_checkpoint(str(tmp_path), 4, tree)
    got, step, _ = restore_latest(str(tmp_path), {"t": torch.zeros(0, dtype=torch.int32),
                                                  "f": np.zeros(0, np.float64)})
    assert step == 4
    assert isinstance(got["t"], torch.Tensor) and got["t"].dtype == torch.int32
    assert torch.equal(got["t"], tree["t"])
    assert isinstance(got["f"], np.ndarray)
    np.testing.assert_array_equal(got["f"], tree["f"].numpy())


def test_shardings_are_not_ported(tmp_path):
    """``shardings=`` is ported: each restored leaf is placed by its
    NamedSharding, from a checkpoint of either package."""
    from repro_torch.distributed import Mesh, NamedSharding, P

    mesh = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4), ("data", "model"))
    sh = NamedSharding(mesh, P("data", "model"))
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    path = save_checkpoint(str(tmp_path / "port"), 1, tree)
    ref_save_checkpoint(str(tmp_path / "ref"), 1, tree)
    got, step, _ = restore_checkpoint(path, {"w": np.zeros(0, np.float32)}, shardings={"w": sh})
    got_ref, step_ref, _ = restore_latest(str(tmp_path / "ref"), {"w": np.zeros(0, np.float32)},
                                          shardings={"w": sh})
    assert step == step_ref == 1
    for g in (got["w"], got_ref["w"]):
        assert g.sharding is sh and g.blocks[1, 3].shape == (4, 2)
        np.testing.assert_array_equal(np.asarray(g), tree["w"])


# ---------------------------------------------------------------------------
# the same keys and manifests as the reference; checkpoints move both ways
# ---------------------------------------------------------------------------

def _nested(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "z": np.asarray(seed, np.int64),
        "params": [rng.standard_normal((2, 2)).astype(np.float32),
                   (np.arange(3, dtype=np.int32), None,
                    {"k": rng.integers(0, 9, size=4), "a": np.float64(0.5)})],
        "pair": (np.zeros(2, np.int16), np.ones(1, np.uint8)),
        "inner": {"y": np.int32(3), "b": np.arange(2.0)},
        "scalar": 7,
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_leaf_keys_and_manifest_equal_the_reference(tmp_path, seed):
    tree = _nested(seed)
    port = save_checkpoint(str(tmp_path / "p"), 5, tree, extra={"who": "port"})
    ref = ref_save_checkpoint(str(tmp_path / "r"), 5, tree, extra={"who": "port"})
    assert list(_flatten(tree)) == [
        "inner/b", "inner/y", "pair/0", "pair/1", "params/0", "params/1/0",
        "params/1/2/a", "params/1/2/k", "scalar", "z"]
    with open(os.path.join(port, "manifest.json")) as f:
        pm = json.load(f)
    with open(os.path.join(ref, "manifest.json")) as f:
        rm = json.load(f)
    assert pm == rm
    assert list(pm["leaves"]) == list(_flatten(tree))
    for name in ("arrays.npz", "COMMIT"):
        assert os.path.exists(os.path.join(port, name))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_in_the_other_package(tmp_path, writer):
    tree = _nested(3)
    save = save_checkpoint if writer == "port" else ref_save_checkpoint
    save(str(tmp_path), 9, tree, extra={"n": 1})
    template = _nested(4)
    for restore in (restore_latest, ref_restore_latest):
        got, step, extra = restore(str(tmp_path), template)
        assert step == 9 and extra == {"n": 1}
        want, back = _flatten(tree), _flatten(got)
        assert list(back) == list(want)
        for k in want:
            np.testing.assert_array_equal(back[k], want[k])
            assert back[k].dtype == np.asarray(_flatten(template)[k]).dtype


# ---------------------------------------------------------------------------
# sessions and snapshots
# ---------------------------------------------------------------------------


def _stream(streams, edges, **kw):
    kw.setdefault("window", 300)
    kw.setdefault("batch_size", 64)
    kw.setdefault("seed", 5)
    return streams["sliding_window"](edges, **kw)


@pytest.fixture(scope="module")
def kron7():
    return kronecker_rmat(7, edge_factor=8, seed=3)


@pytest.mark.parametrize("method", ["wedge_bsearch", "pallas"])
def test_drive_stream_report_equals_reference(kron7, method):
    n_nodes = int(kron7.max()) + 1
    counter, rep = drive_stream(_stream(STREAM_GENERATORS, kron7), n_nodes=n_nodes,
                                max_batches=9, queries_per_batch=3, method=method,
                                report_every=4, device="cpu")
    ref_counter, ref_rep = ref_drive_stream(_stream(REF_STREAMS, kron7), n_nodes=n_nodes,
                                            max_batches=9, queries_per_batch=3,
                                            method="wedge_bsearch", report_every=4)
    assert rep.keys() == ref_rep.keys()
    assert rep["latency"].keys() == ref_rep["latency"].keys()
    assert rep["latency"]["window"].keys() == ref_rep["latency"]["window"].keys()
    assert rep["latency"]["queries"].keys() == ref_rep["latency"]["queries"].keys()
    for k in ("n_batches", "n_inserted", "n_deleted", "n_queries"):
        assert rep[k] == ref_rep[k], k
    assert rep["latency"]["intervals"] == ref_rep["latency"]["intervals"] == 2
    assert counter.count == ref_counter.count
    np.testing.assert_array_equal(counter.per_node(), ref_counter.per_node())
    np.testing.assert_array_equal(counter.current_edges(), ref_counter.current_edges())
    assert counter.last_update_stats.probe_method == method
    assert QUERY_KINDS == ("count", "per_node", "clustering", "transitivity")


def test_run_service_is_the_drive_stream_alias(kron7):
    from repro.launch.serve_graph import run_service as ref_run_service
    from repro_torch.launch.serve_graph import run_service

    n_nodes = int(kron7.max()) + 1
    counter, rep = run_service(_stream(STREAM_GENERATORS, kron7), n_nodes=n_nodes,
                               max_batches=4, queries_per_batch=1, device="cpu")
    ref_counter, ref_rep = ref_run_service(_stream(REF_STREAMS, kron7), n_nodes=n_nodes,
                                           max_batches=4, queries_per_batch=1)
    assert rep.keys() == ref_rep.keys() and rep["n_batches"] == ref_rep["n_batches"] == 4
    assert counter.count == ref_counter.count
    np.testing.assert_array_equal(counter.per_node(), ref_counter.per_node())


def test_drive_stream_metrics_sink_and_log(kron7):
    snaps, lines = [], []
    _, rep = drive_stream(_stream(STREAM_GENERATORS, kron7), n_nodes=int(kron7.max()) + 1,
                          max_batches=6, queries_per_batch=2, report_every=2,
                          metrics_sink=snaps.append, log=lines.append, device="cpu")
    assert [s["kind"] for s in snaps] == ["interval"] * 3 + ["final"]
    assert snaps[-1]["batches"] == rep["n_batches"] == 6
    assert sum(1 for ln in lines if ln.startswith("[interval")) == 3
    assert "resume" not in rep


def test_snapshot_restore_resume_equals_uninterrupted(tmp_path, kron7):
    n_nodes = int(kron7.max()) + 1
    oracle, _ = drive_stream(_stream(STREAM_GENERATORS, kron7), n_nodes=n_nodes,
                             max_batches=9, queries_per_batch=1, device="cpu")
    store = SnapshotStore(str(tmp_path / "snap"), keep=2)
    killed, rep1 = drive_stream(_stream(STREAM_GENERATORS, kron7), n_nodes=n_nodes,
                                max_batches=5, queries_per_batch=1, snapshot_store=store,
                                snapshot_every=2, device="cpu")
    assert rep1["resume"]["snapshots_written"] >= 2
    # "restart": a brand-new store and session restored from disk
    sess, extra = SnapshotStore(str(tmp_path / "snap")).restore_session(
        "s", method="pallas", device="cpu")
    assert sess.cursor == 5 and extra["count"] == killed.count
    assert extra["session"] == "stream" and extra["n_edges"] == killed.n_edges
    resumed, rep2 = drive_stream(_stream(STREAM_GENERATORS, kron7), n_nodes=n_nodes,
                                 max_batches=9, queries_per_batch=1, session=sess)
    assert rep2["resume"]["skipped_batches"] == 5
    assert rep2["n_batches"] == 4
    assert resumed.count == oracle.count
    assert np.array_equal(resumed.per_node(), oracle.per_node())
    assert np.array_equal(resumed.current_edges(), oracle.current_edges())


def test_snapshot_then_tail_equals_uninterrupted(tmp_path):
    """A snapshot taken at cursor 4 plus the batches after it equals the
    session that applied all six."""
    edges = kronecker_rmat(6, edge_factor=8, seed=11)
    batches = list(_stream(STREAM_GENERATORS, edges, window=200, batch_size=32, seed=2))
    assert len(batches) >= 6
    live = StreamSession("g", n_nodes=int(edges.max()) + 1, device="cpu")
    store = SnapshotStore(str(tmp_path / "snap"), async_save=True)
    for b in batches[:4]:
        live.apply(insert=b.insert, delete=b.delete)
    assert store.save(live) == 4
    for b in batches[4:6]:
        live.apply(insert=b.insert, delete=b.delete)
    store.wait()
    sess, _ = SnapshotStore(str(tmp_path / "snap")).restore_session("g2", device="cpu")
    assert sess.cursor == 4
    for b in batches[4:6]:
        sess.apply(insert=b.insert, delete=b.delete)
    assert sess.counter.count == live.counter.count
    assert np.array_equal(sess.counter.per_node(), live.counter.per_node())


def test_empty_store_restores_nothing(tmp_path):
    store = SnapshotStore(str(tmp_path / "none"))
    assert store.load_latest() is None
    assert store.restore_session("s", device="cpu") is None
    assert load_latest_state(tmp_path / "none") is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshots_restore_in_the_other_package(tmp_path, kron7, writer):
    """A snapshot directory written by either package's SnapshotStore
    resumes in the other, and both resumed runs end where the
    uninterrupted one does."""
    n_nodes = int(kron7.max()) + 1
    d = str(tmp_path / "snap")
    if writer == "port":
        drive_stream(_stream(STREAM_GENERATORS, kron7), n_nodes=n_nodes, max_batches=5,
                     queries_per_batch=0, snapshot_store=SnapshotStore(d),
                     snapshot_every=2, device="cpu")
    else:
        ref_drive_stream(_stream(REF_STREAMS, kron7), n_nodes=n_nodes, max_batches=5,
                         queries_per_batch=0, snapshot_store=RefSnapshotStore(d),
                         snapshot_every=2)
    tree, cursor, extra = load_latest_state(d)
    assert cursor == 5 and sorted(tree) == sorted(session_template())
    port_sess, _ = SnapshotStore(d).restore_session("p", method="pallas", device="cpu")
    ref_sess, _ = RefSnapshotStore(d).restore_session("r")
    assert port_sess.cursor == ref_sess.cursor == 5
    port_tree, ref_tree = port_sess.state_tree(), ref_sess.state_tree()
    for k in ref_tree:
        np.testing.assert_array_equal(port_tree[k], ref_tree[k])
    oracle, _ = drive_stream(_stream(STREAM_GENERATORS, kron7), n_nodes=n_nodes,
                             max_batches=9, queries_per_batch=0, device="cpu")
    port_done, rep = drive_stream(_stream(STREAM_GENERATORS, kron7), n_nodes=n_nodes,
                                  max_batches=9, queries_per_batch=0, session=port_sess)
    ref_done, ref_rep = ref_drive_stream(_stream(REF_STREAMS, kron7), n_nodes=n_nodes,
                                         max_batches=9, queries_per_batch=0, session=ref_sess)
    assert rep["resume"] == ref_rep["resume"]
    assert port_done.count == ref_done.count == oracle.count
    np.testing.assert_array_equal(port_done.per_node(), oracle.per_node())
    np.testing.assert_array_equal(ref_done.per_node(), oracle.per_node())


def test_session_state_roundtrip_rejects_tampering():
    sess = StreamSession("s", n_nodes=8, device="cpu")
    out = sess.apply(insert=np.array([[0, 1], [1, 2], [0, 2], [2, 3]], np.int64))
    assert out == {"count": 1, "n_edges": 4, "delta": 1, "cursor": 1}
    tree = sess.state_tree()
    back = StreamSession.from_state("s", tree, device="cpu")
    assert back.counter.count == sess.counter.count == 1 and back.cursor == 1
    bad = dict(tree)
    bad["deg"] = tree["deg"].copy()
    bad["deg"][0] += 1
    with pytest.raises(ValueError):
        StreamSession.from_state("s", bad, device="cpu")


def test_session_reads_and_bad_arguments():
    sess = StreamSession("s", device="cpu")
    sess.apply(insert=np.array([[0, 1], [1, 2], [0, 2]]))
    assert sess.read("count") == 1
    np.testing.assert_array_equal(sess.read("per_node"), [1, 1, 1])
    np.testing.assert_array_equal(sess.read("clustering"), [1.0, 1.0, 1.0])
    assert sess.read("transitivity") == 1.0
    edges, n = sess.edges_snapshot()
    assert n == 3 and edges.shape == (6, 2)
    with pytest.raises(ValueError, match="unknown session query kind"):
        sess.read("support")
    with pytest.raises(ValueError, match="cursor"):
        StreamSession("s", cursor=-1, device="cpu")


def test_session_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamSession("s")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drive_stream(iter(()), n_nodes=4)


def test_given_counter_is_used_as_is():
    ctr = IncrementalTriangleCounter([[0, 1], [1, 2], [0, 2]], device="cpu")
    sess = StreamSession("s", counter=ctr, cursor=3)
    assert sess.counter is ctr and sess.cursor == 3 and sess.n_applied == 0
