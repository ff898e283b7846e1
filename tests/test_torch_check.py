"""Port parity: repro_torch's ``REPRO_CHECK=1`` runtime sanitizer.

* the ``check_partial`` cases of tests/test_check.py on torch tensors,
  each rejection with the reference's message for the same values;
* the sanitizer inside ``run_workload``: a healthy run gives the same
  result with it on, and a backend that breaks the int32 contract (a
  64-bit, negative or over-headroom partial) raises only with it on;
* ``repro_torch.check`` exports the static passes' names beside the
  runtime ones, and nothing in the port is left "not yet ported" for
  ROADMAP A5b (the auditor itself: tests/test_torch_compile_audit.py);
* a ``mesh=`` that is no ``repro_torch.distributed.Mesh`` is refused by
  ``TriangleCounter`` and ``GraphService``, and a real one reaches every
  lane's engine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.check.runtime import RuntimeCheckError as RefCheckError  # noqa: E402
from repro.check.runtime import check_partial as ref_check_partial  # noqa: E402
from repro.core import TriangleCounter as RefCounter  # noqa: E402
from repro_torch import check  # noqa: E402
from repro_torch.check.runtime import (  # noqa: E402
    PARTIAL_HEADROOM,
    RuntimeCheckError,
    check_partial,
    check_partials,
    enabled,
)
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    PallasBackend,
    TriangleCounter,
    WedgeBackend,
    prepare_oriented,
    run_workload,
    workload_from_csr,
)


def test_enabled_reads_env(monkeypatch):
    monkeypatch.delenv("REPRO_CHECK", raising=False)
    assert not enabled()
    monkeypatch.setenv("REPRO_CHECK", "1")
    assert enabled()
    monkeypatch.setenv("REPRO_CHECK", "0")
    assert not enabled()


def test_check_partial_accepts_contract():
    check_partial(torch.zeros(4, dtype=torch.int32), kind="count")
    check_partial(torch.ones(3, dtype=torch.int16), kind="per_node")
    check_partial(torch.full((2,), PARTIAL_HEADROOM - 1, dtype=torch.int32), kind="support")
    check_partial(torch.zeros(0, dtype=torch.int64), kind="count")  # empty: vacuous
    check_partial(torch.ones(2, dtype=torch.bool), kind="count")
    check_partial(np.zeros(4, np.int32), kind="count")  # arrays as the reference takes them
    check_partials([torch.zeros(2, dtype=torch.int32)] * 3, kind="count")


def test_check_partial_rejects_wide_dtype():
    with pytest.raises(RuntimeCheckError, match="int32"):
        check_partial(torch.ones(3, dtype=torch.int64), kind="count")
    with pytest.raises(RuntimeCheckError, match="non-integer"):
        check_partial(torch.ones(3, dtype=torch.float32), kind="count")


def test_check_partial_rejects_negative_and_headroom():
    with pytest.raises(RuntimeCheckError, match="negative"):
        check_partial(torch.tensor([-1], dtype=torch.int32), kind="count")
    with pytest.raises(RuntimeCheckError, match="2\\^30"):
        check_partial(torch.tensor([PARTIAL_HEADROOM], dtype=torch.int32), kind="support")


@pytest.mark.parametrize("values,dtype", [([-1, 3], "int32"), ([0, PARTIAL_HEADROOM], "int32"),
                                          ([1, 2], "int64"), ([0.5], "float32"),
                                          ([-7], "int16")])
def test_messages_equal_the_reference(values, dtype):
    with pytest.raises(RefCheckError) as want:
        ref_check_partial(np.array(values, dtype), kind="per_node", context="chunk 3")
    with pytest.raises(RuntimeCheckError) as got:
        check_partial(torch.tensor(values, dtype=getattr(torch, dtype)), kind="per_node",
                      context="chunk 3")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def kron(small_graphs):
    from repro_torch.graphs import canonicalize_edges

    return canonicalize_edges(small_graphs["kron"])


@pytest.mark.parametrize("method", ["wedge_bsearch", "pallas"])
def test_sanitizer_keeps_healthy_results(monkeypatch, kron, method):
    monkeypatch.setenv("REPRO_CHECK", "1")
    tc = TriangleCounter(method=method, max_wedge_chunk=64, device="cpu")
    got = (tc.count(kron), tc.per_node(kron), tc.edge_support(kron))
    ref = RefCounter(method="wedge_bsearch", max_wedge_chunk=64)
    assert got[0] == ref.count(kron)
    np.testing.assert_array_equal(got[1], ref.per_node(kron))
    np.testing.assert_array_equal(got[2], ref.edge_support(kron))


def test_run_workload_sanitizer_integration(monkeypatch, kron):
    class WideBackend(WedgeBackend):
        """Violates the device contract: emits int64 partials."""

        def count_chunk(self, adj, chunk):
            return super().count_chunk(adj, chunk).to(torch.int64)

    work = workload_from_csr(prepare_oriented(kron, device="cpu"))
    monkeypatch.delenv("REPRO_CHECK", raising=False)
    want = run_workload(WedgeBackend(), "count", work)[0]
    assert run_workload(WideBackend(), "count", work)[0] == want  # folds silently
    monkeypatch.setenv("REPRO_CHECK", "1")
    assert run_workload(WedgeBackend(), "count", work)[0] == want
    with pytest.raises(RuntimeCheckError, match="int32"):
        run_workload(WideBackend(), "count", work)


@pytest.mark.parametrize("kind", ["per_node", "support"])
def test_sanitizer_checks_each_scatter_partial(monkeypatch, kron, kind):
    """A per-node or support partial that wrapped (a negative slot) or lost
    its headroom raises before it reaches the int64 accumulator."""
    class Broken(PallasBackend):
        def __init__(self, value):
            super().__init__()
            self.value = value

        def per_node_chunk(self, adj, chunk, n_out):
            out = super().per_node_chunk(adj, chunk, n_out)
            out[0] = self.value
            return out

        def support_chunk(self, adj, chunk, m_out):
            out = super().support_chunk(adj, chunk, m_out)
            out[-1] = self.value
            return out

    work = workload_from_csr(prepare_oriented(kron, device="cpu"))
    monkeypatch.setenv("REPRO_CHECK", "1")
    with pytest.raises(RuntimeCheckError, match=f"{kind} partial \\(chunk 0\\).*negative"):
        run_workload(Broken(-5), kind, work, budget=64)
    with pytest.raises(RuntimeCheckError, match="2\\^30"):
        run_workload(Broken(PARTIAL_HEADROOM), kind, work, budget=64)
    monkeypatch.delenv("REPRO_CHECK")
    run_workload(Broken(-5), kind, work, budget=64)  # off: no check


def test_check_exports_static_and_runtime_names():
    from pathlib import Path

    from repro_torch.check import runtime

    assert set(check.__all__) == {"Finding", "ModuleInfo", "PASSES", "load_passes", "run_checks",
                                  "PARTIAL_HEADROOM", "REPRO_CHECK_ENV", "RuntimeCheckError",
                                  "enabled", "check_partial", "check_partials", "CompileAuditor"}
    for name in check.__all__:
        assert getattr(check, name) is not None
    assert check.CompileAuditor is runtime.CompileAuditor
    with check.CompileAuditor() as aud:
        pass
    assert aud.total_new_traces == 0
    with pytest.raises(AttributeError):
        check.not_a_name  # noqa: B018
    port = Path(check.__file__).resolve().parents[1]
    held = [str(p.relative_to(port)) for p in port.rglob("*.py") if "A5b" in p.read_text()]
    assert not held, held


def test_mesh_of_the_wrong_type_is_refused():
    # the mesh is ported (ROADMAP A6): only a mesh of the wrong type is refused
    with pytest.raises(TypeError, match="Mesh"):
        TriangleCounter(mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        engine.TriangleCounter(method="pallas", mesh=object(), device="cpu")


def test_service_mesh_is_not_ported(tmp_path):
    from repro_torch.distributed import Mesh
    from repro_torch.serve import GraphService

    with pytest.raises(TypeError, match="Mesh"):
        GraphService(str(tmp_path), mesh=object(), device="cpu", start=False)
    mesh = Mesh(["cpu"] * 3)
    svc = GraphService(str(tmp_path), mesh=mesh, method="distributed", start=False)
    try:
        assert svc.device == torch.device("cpu") and svc.mesh is mesh
        tc = svc._new_engine()
        assert tc.mesh is mesh and tc.method == "distributed"
        assert tc.count(np.array([[0, 1], [1, 0], [1, 2], [2, 1], [0, 2], [2, 0]])) == 1
        assert tc.last_stats.method == "distributed" and tc.last_stats.n_stripes == 3
    finally:
        svc.close()


@pytest.mark.cuda
def test_check_partial_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 8g plants the fault there)")
    check_partial(torch.zeros(8, dtype=torch.int32, device="cuda"), kind="count")
    with pytest.raises(RuntimeCheckError, match="2\\^30"):
        check_partial(torch.tensor([0, PARTIAL_HEADROOM], dtype=torch.int32, device="cuda"),
                      kind="count")
