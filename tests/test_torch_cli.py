"""Port parity: ``python -m repro_torch.launch.count``,
``python -m repro_torch.launch.analyze`` and
``python -m repro_torch.launch.serve_graph`` against the reference CLIs.

Karate gives 45 with the same JSON key set as ``python -m
repro.launch.count``; the analyze report equals the reference's apart
from timings and source paths; a ``.tricsr`` cache written by either
package loads in the other; ``serve_graph`` serves karate to the
reference's counts with the same JSON keys, resumes from its own
snapshots and from the reference's, and exits before any ingest on a bad
flag or without a card.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs.io import ingest as ref_ingest  # noqa: E402
from repro.graphs.io import load_tricsr as ref_load  # noqa: E402
from repro_torch.core import TriangleCounter  # noqa: E402
from repro_torch.graphs.io import ingest as port_ingest  # noqa: E402
from repro_torch.graphs.io import load_tricsr as port_load  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KARATE = os.path.join(REPO, "tests", "data", "karate.txt")


def run_cli(module, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600)


def keys(obj, prefix=""):
    """Every key path of a JSON object whose values are fixed by the schema."""
    out = set()
    for k, v in obj.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("counters",):
            out |= keys(v, prefix + k + ".")
    return out


def test_karate_cli_matches_reference_keys(tmp_path):
    common = ["--input", KARATE, "--json", "--transitivity", "--clustering-summary"]
    port = run_cli("repro_torch.launch.count", *common, "--cache-dir", str(tmp_path / "p"),
                   "--device", "cpu")
    ref = run_cli("repro.launch.count", *common, "--cache-dir", str(tmp_path / "r"))
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    p = json.loads(port.stdout.strip().splitlines()[-1])
    r = json.loads(ref.stdout.strip().splitlines()[-1])
    assert p["triangles"] == r["triangles"] == 45
    assert keys(p) == keys(r)
    assert p["transitivity"] == r["transitivity"]
    assert p["clustering"] == r["clustering"]
    assert p["graph"] == r["graph"]


def test_spilling_ingest_equals_reference(tmp_path):
    """The out-of-core canonicaliser (its dedups by ``sorted_unique``) gives
    the reference's CSR arrays on a generated edge list with duplicates,
    both directions and self loops, spilling several sorted runs."""
    from repro.graphs import kronecker_rmat

    rng = np.random.default_rng(3)
    e = kronecker_rmat(9, edge_factor=8, seed=4)
    e = np.concatenate([e, e[rng.integers(0, len(e), 500)], [[5, 5], [7, 7]]])
    e = e[rng.permutation(len(e))]
    path = tmp_path / "g.txt"
    np.savetxt(path, e, fmt="%d")
    ref_csr, ref_stats = ref_ingest(path, cache_dir=tmp_path / "r", max_chunk_edges=700)
    port_csr, port_stats = port_ingest(path, cache_dir=tmp_path / "p", max_chunk_edges=700)
    assert port_stats.spill_runs == ref_stats.spill_runs > 3
    assert port_stats.unique_edges == ref_stats.unique_edges
    np.testing.assert_array_equal(np.asarray(port_csr.row_offsets),
                                  np.asarray(ref_csr.row_offsets))
    np.testing.assert_array_equal(np.asarray(port_csr.col), np.asarray(ref_csr.col))


def test_tricsr_written_by_either_package_loads_in_the_other(tmp_path):
    ref_csr, ref_stats = ref_ingest(KARATE, cache_dir=tmp_path / "r")
    port_csr, port_stats = port_ingest(KARATE, cache_dir=tmp_path / "p")
    r_bytes = open(ref_stats.cache_path, "rb").read()
    p_bytes = open(port_stats.cache_path, "rb").read()
    assert r_bytes == p_bytes
    from_ref = port_load(ref_stats.cache_path)
    from_port = ref_load(port_stats.cache_path)
    np.testing.assert_array_equal(from_ref.row_offsets, ref_csr.row_offsets)
    np.testing.assert_array_equal(from_ref.col, ref_csr.col)
    np.testing.assert_array_equal(from_port.col, port_csr.col)
    assert TriangleCounter(device="cpu").count(from_ref) == 45


@pytest.mark.parametrize("flag", [["--distributed", "--method", "pallas"],
                                  ["--distributed", "--method", "wedge_bsearch"]])
def test_cli_not_ported_flags_fail_cleanly(tmp_path, monkeypatch, capsys, flag):
    """--distributed is ported; what it conflicts with stops before ingest."""
    from repro_torch.launch import count as cli

    monkeypatch.setattr(sys, "argv", ["count", "--input", KARATE, "--device", "cpu",
                                      "--cache-dir", str(tmp_path), *flag])
    with pytest.raises(SystemExit) as exc:
        cli.main()
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert f"conflicts with --method {flag[-1]}" in err
    assert not any(tmp_path.iterdir())  # stopped before any ingest


def test_cli_trace_export_validates(tmp_path, monkeypatch, capsys):
    """``--trace`` writes a Chrome trace with one span per chunk launch."""
    from repro_torch import obs
    from repro_torch.launch import count as cli

    out = tmp_path / "trace.json"
    monkeypatch.setattr(sys, "argv", ["count", "--input", KARATE, "--device", "cpu",
                                      "--cache-dir", str(tmp_path), "--method", "pallas",
                                      "--max-wedge-chunk", "64", "--json",
                                      "--trace", str(out)])
    cli.main()
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["triangles"] == 45
    trace = json.loads(out.read_text())
    assert obs.validate_chrome_trace(trace) > 0
    chunk_spans = [e for e in trace["traceEvents"] if e.get("name") == "count.chunk"]
    assert len(chunk_spans) == result["stats"]["n_chunks"] > 1
    for e in chunk_spans:  # panel chunks carry their shape; no CUDA event pair on the CPU
        assert e["args"]["width"] > 0 and e["args"]["rows"] > 0, e
        assert "device_ms" not in e["args"], e
    assert trace["otherData"]["env"]["torch"] == torch.__version__
    assert not obs.enabled()


def _analyze_json(proc):
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out.pop("timings_s")
    out["engine"].pop("timings")
    ingest = out["source"]["ingest"]
    for k in [k for k in ingest if k == "cache_path" or k.endswith("_s") or k == "seconds"]:
        ingest.pop(k)  # paths and timings differ between two runs
    return out


def test_analyze_cli_matches_reference(tmp_path):
    common = ["--input", KARATE, "--json", "--top-k", "3"]
    port = run_cli("repro_torch.launch.analyze", *common, "--cache-dir", str(tmp_path / "p"),
                   "--device", "cpu")
    ref = run_cli("repro.launch.analyze", *common, "--cache-dir", str(tmp_path / "r"))
    p, r = _analyze_json(port), _analyze_json(ref)
    assert p == r
    assert p["triangles"] == 45 and p["transitivity"] == 135 / 528
    assert p["truss"]["max_k"] == 5
    assert p["truss"]["spectrum"] == {"2": 11, "3": 42, "4": 11, "5": 14}


def _analyze_main(monkeypatch, tmp_path, *flags):
    from repro_torch.launch import analyze as cli

    monkeypatch.setattr(sys, "argv", ["analyze", "--input", KARATE,
                                      "--cache-dir", str(tmp_path), *flags])
    cli.main()


def test_analyze_cli_no_truss(tmp_path, monkeypatch, capsys):
    _analyze_main(monkeypatch, tmp_path, "--device", "cpu", "--json", "--no-truss",
                  "--method", "pallas", "--max-wedge-chunk", "64")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "truss" not in out and "truss" not in out["timings_s"]
    assert out["triangles"] == 45 and out["support"]["sum"] == 135
    assert out["engine"]["method"] == out["support"]["method"] == "pallas"
    assert out["engine"]["n_chunks"] > 1


def test_analyze_cli_method_distributed_is_not_ported(tmp_path, monkeypatch, capsys):
    """--method distributed is ported: every stage runs on the CPU's mesh
    and the report is karate's (ROADMAP A2's gate)."""
    _analyze_main(monkeypatch, tmp_path, "--device", "cpu", "--json",
                  "--method", "distributed", "--max-wedge-chunk", "64")
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert "mesh: 1 stripe(s) on 1 device(s)" in captured.err
    assert out["triangles"] == 45 and out["support"]["sum"] == 135
    assert out["engine"]["method"] == out["support"]["method"] == "distributed"
    assert out["truss"]["method"] == "distributed"
    assert out["truss"]["max_k"] == 5
    assert out["truss"]["spectrum"] == {"2": 11, "3": 42, "4": 11, "5": 14}


def test_analyze_cli_default_device_is_the_card(tmp_path, monkeypatch, capsys):
    """``--device cuda`` (the default) without a card exits non-zero with the
    device error before any ingest; with a card it reports karate's 45."""
    if torch.cuda.is_available():
        _analyze_main(monkeypatch, tmp_path, "--json")
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["triangles"] == 45 and out["engine"]["method"] == "pallas"
        return
    with pytest.raises(SystemExit) as exc:
        _analyze_main(monkeypatch, tmp_path, "--device", "cuda")
    assert "--device cuda" in str(exc.value) and "device='cpu'" in str(exc.value)
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# serve_graph: the streaming service CLI
# ---------------------------------------------------------------------------


def _serve_main(module, monkeypatch, capsys, tmp_path, *flags):
    """Run ``module.main()`` in process; returns its --json object."""
    monkeypatch.setattr(sys, "argv", ["serve_graph", "--cache-dir", str(tmp_path / "cache"),
                                      "--json", *flags])
    module.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_serve_graph_cli_matches_reference(tmp_path):
    common = ["--dataset", "karate", "--batch-size", "16", "--json"]
    port = run_cli("repro_torch.launch.serve_graph", *common,
                   "--cache-dir", str(tmp_path / "p"), "--device", "cpu")
    ref = run_cli("repro.launch.serve_graph", *common, "--cache-dir", str(tmp_path / "r"))
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    p = json.loads(port.stdout.strip().splitlines()[-1])
    r = json.loads(ref.stdout.strip().splitlines()[-1])
    for k in ("triangles", "n_edges", "n_batches", "n_inserted", "n_deleted", "n_queries",
              "verified", "probe_method"):
        assert p[k] == r[k], k
    assert p["triangles"] == 45 and p["n_edges"] == 78 and p["verified"] is True
    assert keys(p) == keys(r)


@pytest.mark.parametrize("method", ["pallas", "wedge_bsearch"])
def test_serve_graph_cli_resume_equals_uninterrupted(tmp_path, monkeypatch, capsys, method):
    from repro_torch.launch import serve_graph as cli

    common = ["--generator", "kronecker", "--scale", "7", "--stream", "sliding_window",
              "--batch-size", "64", "--window", "300", "--method", method,
              "--max-wedge-chunk", "512", "--device", "cpu"]
    whole = _serve_main(cli, monkeypatch, capsys, tmp_path, *common, "--max-batches", "9")
    snap = str(tmp_path / "snap")
    first = _serve_main(cli, monkeypatch, capsys, tmp_path, *common, "--max-batches", "5",
                        "--snapshot-dir", snap, "--snapshot-every", "2")
    assert first["resume"] == {"skipped_batches": 0, "cursor": 5, "snapshots_written": 3}
    rest = _serve_main(cli, monkeypatch, capsys, tmp_path, *common, "--max-batches", "9",
                       "--snapshot-dir", snap, "--resume")
    assert rest["resume"]["skipped_batches"] == 5 and rest["n_batches"] == 4
    assert whole["verified"] is rest["verified"] is True
    assert (rest["triangles"], rest["n_edges"]) == (whole["triangles"], whole["n_edges"])
    assert rest["probe_method"] == whole["probe_method"] == method


def test_serve_graph_cli_resumes_reference_snapshots(tmp_path, monkeypatch, capsys):
    """Snapshots written by ``repro.launch.serve_graph`` resume in the port's
    CLI, which ends where the reference's uninterrupted run does."""
    from repro.launch import serve_graph as ref_cli
    from repro_torch.launch import serve_graph as cli

    common = ["--generator", "kronecker", "--scale", "6", "--stream", "sliding_window",
              "--batch-size", "32", "--window", "150", "--max-wedge-chunk", "512"]
    snap = str(tmp_path / "snap")
    whole = _serve_main(ref_cli, monkeypatch, capsys, tmp_path, *common, "--max-batches", "8")
    _serve_main(ref_cli, monkeypatch, capsys, tmp_path, *common, "--max-batches", "3",
                "--snapshot-dir", snap)
    rest = _serve_main(cli, monkeypatch, capsys, tmp_path, *common, "--max-batches", "8",
                       "--snapshot-dir", snap, "--resume", "--device", "cpu",
                       "--method", "pallas")
    assert rest["resume"]["skipped_batches"] == 3 and rest["verified"] is True
    assert (rest["triangles"], rest["n_edges"]) == (whole["triangles"], whole["n_edges"])


def test_serve_graph_cli_trace_and_metrics(tmp_path, monkeypatch, capsys):
    """``--trace`` holds the three probe spans of every update batch, and
    ``--metrics-out`` one interval record per ``--report-every`` batches."""
    from repro_torch import obs
    from repro_torch.launch import serve_graph as cli

    trace_path, metrics = tmp_path / "trace.json", tmp_path / "m.jsonl"
    out = _serve_main(cli, monkeypatch, capsys, tmp_path, "--dataset", "karate",
                      "--batch-size", "16", "--device", "cpu", "--method", "pallas",
                      "--report-every", "2", "--trace", str(trace_path),
                      "--metrics-out", str(metrics))
    trace = json.loads(trace_path.read_text())
    assert obs.validate_chrome_trace(trace) > 0
    names = [e.get("name") for e in trace["traceEvents"]]
    for probe in ("probe.without", "probe.with", "probe.delta"):
        assert names.count(probe) == out["n_batches"] == 5
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["kind"] for r in records] == ["interval", "interval", "final"]
    assert not obs.enabled()


@pytest.mark.parametrize("flags", [["--resume"], ["--batch-size", "0"], ["--window", "0"],
                                   ["--snapshot-every", "0"], ["--report-every", "0"],
                                   ["--keep-snapshots", "0"]])
def test_serve_graph_cli_bad_flags_fail_before_ingest(tmp_path, monkeypatch, capsys, flags):
    from repro_torch.launch import serve_graph as cli

    monkeypatch.setattr(sys, "argv", ["serve_graph", "--input", KARATE, "--device", "cpu",
                                      "--cache-dir", str(tmp_path), *flags])
    with pytest.raises(SystemExit) as exc:
        cli.main()
    assert exc.value.code != 0
    assert not any(tmp_path.iterdir())  # stopped before any ingest


def test_serve_graph_cli_default_device_is_the_card(tmp_path, monkeypatch, capsys):
    """``--device cuda`` (the default) without a card exits non-zero before
    any ingest; with a card karate serves and verifies 45."""
    from repro_torch.launch import serve_graph as cli

    if torch.cuda.is_available():
        out = _serve_main(cli, monkeypatch, capsys, tmp_path, "--dataset", "karate",
                          "--batch-size", "16")
        assert out["triangles"] == 45 and out["verified"] is True
        return
    monkeypatch.setattr(sys, "argv", ["serve_graph", "--dataset", "karate",
                                      "--cache-dir", str(tmp_path)])
    with pytest.raises(SystemExit) as exc:
        cli.main()
    assert "--device cuda" in str(exc.value) and "device='cpu'" in str(exc.value)
    assert not any(tmp_path.iterdir())
