"""Port parity: repro_torch's tile autotuner (``core/tuning.py``).

* the cases of tests/test_tuning.py against the port: the candidate grid
  under its shared-memory budget, pow2 shape keys, cold tune → warm load
  of the identical pick, the cache's version / backend / corruption
  handling, and the locked read-merge-write save under contention;
* ``shape_key`` equals the reference's, and each package discards the
  other's cache file (their backend tags differ);
* a tuned ``pallas`` counter (the plain versions, on the CPU) equals the
  reference's count, per-node and support on ``small_graphs`` at two
  budgets, and ``support_on_arrays(tuner=)`` equals the untuned run;
* the CSR kernel's knob: picks the kernel cannot launch raise, and the
  plain versions ignore admissible ones (on the card every pick is held
  bit-equal to the plain version, by the ``cuda`` case and by
  ``chip_smoke.py``);
* ``--tile-cache`` / ``--autotune`` on karate report 45, cold then warm.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import TriangleCounter as RefCounter  # noqa: E402
from repro.core.tuning import TileCache as RefTileCache  # noqa: E402
from repro.core.tuning import TileConfig as RefTileConfig  # noqa: E402
from repro.core.tuning import shape_key as ref_shape_key  # noqa: E402
from repro_torch.analytics import support_on_arrays  # noqa: E402
from repro_torch.core import AutoTuner, TileCache, TriangleCounter  # noqa: E402
from repro_torch.core import tuning  # noqa: E402
from repro_torch.core.tuning import (  # noqa: E402
    CACHE_VERSION,
    TileConfig,
    autotune_tiles,
    candidate_tiles,
    shape_key,
)
from repro_torch.kernels.triangle_count import ops, triangle_count  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KARATE = os.path.join(REPO, "tests", "data", "karate.txt")
CPU = "cpu"


def admissible(c: TileConfig, width: int) -> bool:
    threads = c.block_edges * c.tlv
    return (c.tlv in (8, 16, 32) and threads % 32 == 0 and threads <= 1024
            and 4 * c.block_edges * min(width, 1024) <= tuning._SMEM_BUDGET)


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------


def test_candidate_grid_respects_smem_budget():
    for (n, lu, lv) in [(32, 16, 16), (512, 256, 1024), (8, 4096, 4096), (1 << 16, 1024, 1024)]:
        cands = candidate_tiles(n, lu, lv)
        assert cands, (n, lu, lv)
        for c in cands:
            assert admissible(c, max(lu, lv)), (c, n, lu, lv)
            assert 1 <= c.block_edges <= max(n, 256)
        assert TileConfig(*triangle_count.csr_default_tiles(max(lu, lv))) in cands


def test_shape_key_pow2_buckets():
    assert shape_key(33, 64, 64) == shape_key(64, 64, 64)
    assert shape_key(64, 64, 64) != shape_key(65, 64, 64)
    assert shape_key(1, 16, 32) == "B1xLu16xLv32"


def test_cold_tune_then_warm_load_identical_tiles(tmp_path):
    path = tmp_path / "tiles.json"
    tuner = AutoTuner(path, tune_on_miss=True, iters=1, device=CPU)
    tiles_cold = tuner.tiles(24, 16, 16)
    assert tiles_cold is not None
    assert tuner.n_tuned == 1 and tuner.n_hits == 0
    assert path.exists()
    payload = json.loads(path.read_text())
    assert payload["version"] == CACHE_VERSION
    assert payload["backend"] == "repro_torch:cpu"
    assert shape_key(24, 16, 16) in payload["entries"]
    warm = AutoTuner(path, tune_on_miss=False, device=CPU)
    assert warm.cache.loaded_from_disk
    tiles_warm = warm.tiles(24, 16, 16)
    assert tiles_warm == tiles_cold
    assert warm.n_hits == 1 and warm.n_tuned == 0
    again = AutoTuner(path, tune_on_miss=True, iters=1, device=CPU)
    assert again.tiles(17, 16, 16) == tiles_cold
    assert again.n_tuned == 0


def test_cache_discards_version_mismatch(tmp_path):
    path = tmp_path / "tiles.json"
    cache = TileCache(path, device=CPU)
    cache.put(shape_key(8, 16, 16), TileConfig(4, 8, 1.0))
    cache.save()
    payload = json.loads(path.read_text())
    payload["version"] = CACHE_VERSION + 1
    path.write_text(json.dumps(payload))
    stale = TileCache(path, device=CPU)
    assert not stale.loaded_from_disk and not stale.entries


def test_cache_discards_backend_mismatch(tmp_path):
    path = tmp_path / "tiles.json"
    cache = TileCache(path, device=CPU)
    cache.put(shape_key(8, 16, 16), TileConfig(4, 8, 1.0))
    cache.save()
    payload = json.loads(path.read_text())
    payload["backend"] = "not-a-backend"
    path.write_text(json.dumps(payload))
    stale = TileCache(path, device=CPU)
    assert not stale.loaded_from_disk and not stale.entries


def test_cache_survives_corrupt_file(tmp_path):
    path = tmp_path / "tiles.json"
    path.write_text("{ this is not json")
    cache = TileCache(path, device=CPU)  # must not raise
    assert not cache.entries
    cache.put("k", TileConfig(8, 32))
    cache.save()
    assert TileCache(path, device=CPU).get("k") == TileConfig(8, 32, 0.0)


def test_autotune_result_is_admissible():
    cfg = autotune_tiles(8, 16, 16, iters=1, warmup=0, device=CPU)
    assert admissible(cfg, 16)
    assert cfg in [TileConfig(c.block_edges, c.tlv, cfg.us) for c in candidate_tiles(8, 16, 16)]
    assert cfg.us > 0.0


def test_tuned_engine_matches_untuned(tmp_path, small_graphs):
    e = small_graphs["kron"]
    base = TriangleCounter(method="pallas", device=CPU)
    expect = base.count(e)
    pn0 = base.per_node(e)
    tuner = AutoTuner(tmp_path / "tiles.json", tune_on_miss=True, iters=1, device=CPU)
    tc = TriangleCounter(method="pallas", tuner=tuner, device=CPU)
    assert tc.count(e) == expect
    np.testing.assert_array_equal(tc.per_node(e), pn0)
    assert tuner.n_tuned + tuner.n_hits > 0
    warm_tuner = AutoTuner(tmp_path / "tiles.json", tune_on_miss=False, device=CPU)
    tc2 = TriangleCounter(method="pallas", tuner=warm_tuner, device=CPU)
    assert tc2.count(e) == expect
    assert warm_tuner.n_hits > 0 and warm_tuner.n_tuned == 0


def test_concurrent_caches_merge_instead_of_clobber(tmp_path):
    path = tmp_path / "tiles.json"
    a = TileCache(path, device=CPU)
    b = TileCache(path, device=CPU)
    ka, kb = shape_key(8, 16, 16), shape_key(64, 32, 32)
    a.put(ka, TileConfig(4, 8, 1.0))
    a.save()
    b.put(kb, TileConfig(16, 16, 2.0))
    b.save()
    merged = TileCache(path, device=CPU)
    assert merged.get(ka) == TileConfig(4, 8, 1.0)
    assert merged.get(kb) == TileConfig(16, 16, 2.0)
    a.put(ka, TileConfig(8, 32, 0.5))
    a.save()
    assert TileCache(path, device=CPU).get(ka) == TileConfig(8, 32, 0.5)
    assert TileCache(path, device=CPU).get(kb) == TileConfig(16, 16, 2.0)


def test_contended_saves_union_survives(tmp_path):
    path = tmp_path / "tiles.json"
    n_threads, keys_per = 6, 5
    errs = []

    def writer(tid):
        try:
            cache = TileCache(path, device=CPU)
            for i in range(keys_per):
                cache.put(f"t{tid}k{i}", TileConfig(8, 32, float(tid)))
                cache.save()
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    final = TileCache(path, device=CPU)
    expect = {f"t{t}k{i}" for t in range(n_threads) for i in range(keys_per)}
    assert expect <= set(final.entries)


# ---------------------------------------------------------------------------
# against the reference package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,lu,lv", [(1, 16, 16), (24, 16, 16), (33, 64, 64), (65, 64, 64),
                                     (65536, 1024, 1024), (3_000_000, 16, 16)])
def test_shape_key_equals_reference(n, lu, lv):
    assert shape_key(n, lu, lv) == ref_shape_key(n, lu, lv)


def test_each_package_discards_the_others_cache(tmp_path):
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    port = TileCache(port_path, device=CPU)
    port.put(shape_key(8, 16, 16), TileConfig(4, 8, 1.0))
    port.save()
    ref = RefTileCache(ref_path)
    ref.put(ref_shape_key(8, 16, 16), RefTileConfig(8, 128, 1.0))
    ref.save()
    # the same JSON layout, another backend tag
    p, r = json.loads(port_path.read_text()), json.loads(ref_path.read_text())
    assert set(p) == set(r) == {"version", "backend", "entries"}
    assert p["version"] == r["version"] and p["backend"] != r["backend"]
    assert set(p["entries"][shape_key(8, 16, 16)]) == set(r["entries"][ref_shape_key(8, 16, 16)])
    from_port = RefTileCache(port_path)
    from_ref = TileCache(ref_path, device=CPU)
    assert not from_port.loaded_from_disk and not from_port.entries
    assert not from_ref.loaded_from_disk and not from_ref.entries


@pytest.mark.parametrize("budget", [None, 64])
@pytest.mark.parametrize("name", ["er", "kron", "ws", "triangle"])
def test_tuned_pallas_equals_reference(tmp_path, small_graphs, name, budget):
    e = small_graphs[name]
    ref = RefCounter(method="wedge_bsearch", max_wedge_chunk=budget)
    tuner = AutoTuner(tmp_path / "tiles.json", tune_on_miss=True, iters=1, device=CPU)
    tc = TriangleCounter(method="pallas", max_wedge_chunk=budget, tuner=tuner, device=CPU)
    assert tc.count(e) == ref.count(e)
    n_keys = tuner.n_tuned
    assert n_keys == len(json.loads((tmp_path / "tiles.json").read_text())["entries"]) > 0
    np.testing.assert_array_equal(tc.per_node(e), ref.per_node(e))
    np.testing.assert_array_equal(tc.edge_support(e), ref.edge_support(e))
    # per-node and support chunk like the count: every later lookup hits
    assert tuner.n_tuned == n_keys and tuner.n_hits > 0


def test_support_on_arrays_takes_a_tuner(tmp_path, small_graphs):
    from repro_torch.core import prepare_oriented

    csr = prepare_oriented(small_graphs["kron"], device=CPU)
    arrays = (csr.row_offsets, csr.src, csr.col, csr.out_degree)
    want = support_on_arrays(*arrays, method="pallas", max_wedge_chunk=64, device=CPU)
    tuner = AutoTuner(tmp_path / "tiles.json", tune_on_miss=True, iters=1, device=CPU)
    got = support_on_arrays(*arrays, method="pallas", max_wedge_chunk=64, tuner=tuner,
                            device=CPU)
    np.testing.assert_array_equal(got.support, want.support)
    assert got.n_chunks == want.n_chunks and tuner.n_tuned > 0


def test_wedge_counter_never_asks_the_tuner(tmp_path, small_graphs):
    tuner = AutoTuner(tmp_path / "tiles.json", tune_on_miss=True, iters=1, device=CPU)
    tc = TriangleCounter(method="wedge_bsearch", tuner=tuner, device=CPU)
    assert tc.count(small_graphs["kron"]) == RefCounter().count(small_graphs["kron"])
    assert tuner.n_hits == tuner.n_tuned == 0 and not (tmp_path / "tiles.json").exists()


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    for make in (lambda: AutoTuner(tmp_path / "t.json"), lambda: TileCache(tmp_path / "t.json")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---------------------------------------------------------------------------
# the kernel's knob
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiles,width", [((8, 4), 16), ((1, 8), 16), ((3, 16), 64),
                                         ((64, 32), 64), ((0, 32), 64), ((64, 8), 1024)])
def test_inadmissible_tiles_raise(tiles, width):
    with pytest.raises(ValueError, match="tiles="):
        triangle_count.check_csr_tiles(tiles, width)


def _tiny_csr():
    rng = np.random.default_rng(4)
    ro, col, u, v = tuning._synthetic_csr(rng, 40, 64)
    u[::7] = -1
    return [torch.from_numpy(x) for x in (ro, col, u, v)]


def test_plain_versions_ignore_the_knob():
    ro, col, u, v = _tiny_csr()
    e = torch.arange(u.shape[0], dtype=torch.int32)
    base = (ops.intersect_count_csr(ro, col, u, v, 64),
            ops.intersect_per_node_csr(ro, col, u, v, 64, 512),
            ops.intersect_support_csr(ro, col, u, v, e, 64, int(col.shape[0])))
    for cfg in candidate_tiles(40, 64, 64):
        got = (ops.intersect_count_csr(ro, col, u, v, 64, tiles=cfg.tiles),
               ops.intersect_per_node_csr(ro, col, u, v, 64, 512, tiles=cfg.tiles),
               ops.intersect_support_csr(ro, col, u, v, e, 64, int(col.shape[0]),
                                         tiles=cfg.tiles))
        for g, b in zip(got, base):
            assert torch.equal(g, b)


def test_synthetic_csr_is_sorted_and_half_full():
    rng = np.random.default_rng(0)
    ro, col, u, v = tuning._synthetic_csr(rng, 1000, 64)
    deg = np.diff(ro)
    assert deg.min() >= 32 and deg.max() <= 64 and u.max() < deg.size and v.max() < deg.size
    for i in range(deg.size):
        row = col[ro[i]:ro[i + 1]]
        assert np.all(np.diff(row) > 0)


@pytest.mark.cuda
def test_every_candidate_pick_equals_the_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 3 runs this at widths 16-4096)")
    ro, col, u, v = (t.cuda() for t in _tiny_csr())
    e = torch.arange(u.shape[0], dtype=torch.int32, device="cuda")
    m = int(col.shape[0])
    want = (ops.intersect_count_csr(ro.cpu(), col.cpu(), u.cpu(), v.cpu(), 64),
            ops.intersect_per_node_csr(ro.cpu(), col.cpu(), u.cpu(), v.cpu(), 64, 512),
            ops.intersect_support_csr(ro.cpu(), col.cpu(), u.cpu(), v.cpu(), e.cpu(), 64, m))
    for cfg in candidate_tiles(40, 64, 64):
        got = (ops.intersect_count_csr(ro, col, u, v, 64, tiles=cfg.tiles),
               ops.intersect_per_node_csr(ro, col, u, v, 64, 512, tiles=cfg.tiles),
               ops.intersect_support_csr(ro, col, u, v, e, 64, m, tiles=cfg.tiles))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), cfg


# ---------------------------------------------------------------------------
# the count CLI
# ---------------------------------------------------------------------------


def _count_main(monkeypatch, capsys, tmp_path, *flags):
    from repro_torch.launch import count as cli

    monkeypatch.setattr(sys, "argv", ["count", "--input", KARATE, "--device", CPU, "--json",
                                      "--cache-dir", str(tmp_path / "cache"), *flags])
    cli.main()
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_cli_autotune_then_warm_tile_cache(tmp_path, monkeypatch, capsys):
    cache = str(tmp_path / "tiles.json")
    cold, log = _count_main(monkeypatch, capsys, tmp_path, "--method", "pallas",
                            "--tile-cache", cache, "--autotune")
    assert cold["triangles"] == 45
    assert "tile cache: 0 hit(s), 1 shape(s) tuned" in log
    warm, log = _count_main(monkeypatch, capsys, tmp_path, "--method", "pallas",
                            "--tile-cache", cache)
    assert warm["triangles"] == 45
    assert f"tile cache: {warm['stats']['n_chunks']} hit(s), 0 shape(s) tuned" in log


def test_cli_tile_cache_beside_the_reference(tmp_path):
    """Both CLIs count karate with a tile cache; each discards the other's."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"

    def run(module, cache, *extra):
        r = subprocess.run([sys.executable, "-m", module, "--input", KARATE, "--json",
                            "--method", "pallas", "--tile-cache", cache,
                            "--cache-dir", str(tmp_path / module), *extra],
                           capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
        assert r.returncode == 0, r.stderr
        return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr

    port_cache, ref_cache = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    port, _ = run("repro_torch.launch.count", port_cache, "--autotune", "--device", CPU)
    ref, _ = run("repro.launch.count", ref_cache, "--autotune")
    assert port["triangles"] == ref["triangles"] == 45
    # the other package's file is discarded: no hits
    _, log = run("repro_torch.launch.count", ref_cache, "--device", CPU)
    assert "tile cache: 0 hit(s), 0 shape(s) tuned" in log
    _, log = run("repro.launch.count", port_cache)
    assert "tile cache: 0 hit(s), 0 shape(s) tuned" in log
