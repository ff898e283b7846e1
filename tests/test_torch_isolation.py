"""The port stands alone: no jax, no repro, no silent CPU fallback.

* no module under ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro`` (an AST scan of every import statement);
* without a card, ``TriangleCounter()`` and the CLI without
  ``--device cpu`` raise instead of running on the CPU;
* the kernel path on CPU tensors never touches the kernel build.
"""
import ast
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_no_jax_and_no_reference():
    files = port_files()
    assert len(files) > 20
    bad = [f"{os.path.relpath(p, REPO)}:{line} imports {root}"
           for p in files for root, line in imported_roots(p) if root in FORBIDDEN]
    assert not bad, bad


def test_no_card_means_no_silent_cpu_run():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    from repro_torch.core import TriangleCounter

    with pytest.raises(RuntimeError, match="device='cpu'"):
        TriangleCounter()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TriangleCounter(method="pallas", device="cuda")


def test_cli_without_a_card_stops_before_ingest(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    from repro_torch.launch import count as cli

    monkeypatch.setattr(sys, "argv", ["count", "--input", os.path.join(REPO, "tests", "data",
                                      "karate.txt"), "--json", "--cache-dir", str(tmp_path)])
    with pytest.raises(SystemExit) as exc:
        cli.main()
    assert "--device cpu" in str(exc.value.code)
    assert capsys.readouterr().out == ""
    assert not any(tmp_path.iterdir())


def test_cpu_kernel_path_never_builds(small_graphs, monkeypatch):
    from repro_torch.core import TriangleCounter
    from repro_torch.kernels.triangle_count import _build, launches, reset_launches

    def refuse():
        raise AssertionError("the CPU path tried to build or load the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    reset_launches()
    tc = TriangleCounter(method="pallas", max_wedge_chunk=64, device="cpu")
    edges = small_graphs["kron"]
    assert tc.count(edges) > 0
    assert int(tc.per_node(edges).sum()) == int(tc.edge_support(edges).sum())
    assert launches == {k: 0 for k in launches}
    assert _build.build_info() is None


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8").read())
    r = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main() != 0


def test_oriented_csr_from_numpy_counts(small_graphs):
    from repro_torch.core import OrientedCSR, TriangleCounter

    edges = np.asarray(small_graphs["triangle"])
    csr = OrientedCSR.from_numpy([0, 2, 3, 3], [0, 0, 1], [1, 2, 2], [2, 1, 0], [2, 2, 2],
                                 device="cpu")
    assert TriangleCounter(method="wedge_bsearch", device="cpu").count(csr) == 1
    assert TriangleCounter(method="wedge_bsearch", device="cpu").count(edges) == 1


def test_cpu_attention_path_never_builds(monkeypatch):
    from repro_torch.kernels.flash_attention import _build, launches, ops, reset_launches

    def refuse():
        raise AssertionError("the CPU path tried to build or load the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    reset_launches()
    q = torch.zeros((1, 4, 16, 32))
    k = torch.zeros((1, 2, 16, 32))
    assert ops.attention(q, k, k).shape == q.shape
    assert launches == {"flash_attention": 0}
    assert _build.build_info() is None


def test_lm_modules_import_without_cuda_or_nvcc():
    """The serving modules import with no nvcc and no card, and build nothing."""
    code = (
        "import sys\n"
        "import repro_torch.launch.serve, repro_torch.models, repro_torch.configs\n"
        "from repro_torch.kernels.flash_attention import _build\n"
        "assert _build.build_info() is None\n"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                              "PYTHONPATH": ":".join(sys.path)}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
