"""Launch-signature audit: the O(log m) bucketing guarantee in the port.

The mirror of tests/test_compile_audit.py on ``device="cpu"``.  The port
makes no jit traces; each kernel entry point records its launch signature
(input shapes and dtypes plus its static configuration) and
``repro_torch.check.runtime.CompileAuditor`` counts the signatures first
seen inside a block.  A planner change that leaks raw shapes to a kernel
fails here instead of as a silent blow-up of distinct shapes on the card.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.check.runtime import (  # noqa: E402
    KERNEL_ENTRY_POINTS,
    CompileAuditor,
    RuntimeCheckError,
    record_build,
    records_launches,
)


@pytest.mark.parametrize("method,kernel", [("auto", "gather_panels_arrays"),
                                           ("pallas", "intersect_support_csr"),
                                           ("wedge_bsearch", "chunk_support_kernel")])
def test_truss_kron10_traces_o_log_m(method, kernel):
    from repro_torch.analytics import k_truss_decomposition
    from repro_torch.graphs import kronecker_rmat

    e = kronecker_rmat(10, edge_factor=8, seed=5)
    with CompileAuditor() as aud:
        dec = k_truss_decomposition(e, max_wedge_chunk=1 << 14, method=method, device="cpu")
    # every peel round shrinks the live subgraph; bucketing must cap the
    # distinct shapes each kernel sees at ~log2(m) (16 for the panel
    # gather at m=6081, as the reference reads from its jit caches, vs one
    # signature per round without bucketing: 94 rounds here)
    bound = aud.assert_log_bound(dec.n_edges, factor=2.0, slack=4)
    assert aud.total_new_traces > 0, "auditor observed no launch at all"
    assert 0 < aud.new_traces[kernel] <= bound < dec.rounds
    assert set(KERNEL_ENTRY_POINTS) <= set(aud.new_traces)
    assert not any(aud.new_builds.values())  # the CPU path builds nothing


@pytest.mark.slow
def test_incremental_session_traces_o_log_m():
    from repro_torch.core.incremental import IncrementalTriangleCounter
    from repro_torch.graphs import kronecker_rmat

    e = kronecker_rmat(10, edge_factor=8, seed=5)
    half = len(e) // 2
    tc = IncrementalTriangleCounter(e[:half], max_wedge_chunk=4096, device="cpu")
    with CompileAuditor() as aud:
        for i in range(6):
            lo = half + i * 200
            tc.insert(e[lo : lo + 200])
            tc.delete(e[lo : lo + 60])
    m = tc.current_edges().shape[0]
    aud.assert_log_bound(m, factor=2.0, slack=4)


def test_auditor_flags_unbucketed_shapes():
    """A kernel fed raw (unbucketed) shapes must blow the log bound."""

    @records_launches("toy_kernel")
    def toy_kernel(x):
        return x.sum(dtype=torch.int32)

    with CompileAuditor(extra_jitted={"toy_kernel": toy_kernel}) as aud:
        for n in range(1, 40):  # 39 distinct shapes, m=64 -> bound 16
            toy_kernel(torch.zeros((n,), dtype=torch.int32))
    assert aud.new_traces["toy_kernel"] == 39
    with pytest.raises(RuntimeCheckError, match="compile-count bound"):
        aud.assert_log_bound(64, factor=2.0, slack=4)


def test_auditor_counts_are_deltas():
    @records_launches("toy", static=("k",))
    def toy(x, k=1):
        return x + k

    toy(torch.zeros(3))  # seen before the block: must not be counted
    with CompileAuditor(extra_jitted={"toy": toy}) as aud:
        toy(torch.zeros(3))  # a signature already seen
        toy(torch.zeros(4))  # one new signature
        toy(torch.zeros(4), k=1)  # a static argument by value: new once
        toy(torch.zeros(4), k=1)
    assert aud.new_traces["toy"] == 2
    assert aud.total_new_traces >= 2
    shape = ((4,), torch.float32)
    assert set(aud.new_signatures["toy"]) == {((shape,), ()), ((shape,), (("k", 1),))}
    with pytest.raises(TypeError, match="records_launches"):
        CompileAuditor(extra_jitted={"plain": lambda x: x})
    with pytest.raises(RuntimeCheckError, match="outside a with block"):
        _ = CompileAuditor().new_traces


def test_cpu_entry_records_its_kernels_signature():
    """On CPU tensors a CSR entry records the signature its CUDA kernel
    would: once per distinct (shapes, width, n_out, tiles), never per call."""
    from repro_torch.kernels.triangle_count import ops

    row = torch.tensor([0, 2, 3, 3], dtype=torch.int32)
    col = torch.tensor([1, 2, 2], dtype=torch.int32)
    u = torch.tensor([0, -1, 0, 1, 0, 2, 1], dtype=torch.int32)
    with CompileAuditor() as aud:
        for _ in range(3):
            assert int(ops.intersect_count_csr(row, col, u[:1], u[3:4] * 1, 16).sum()) == 1
        ops.intersect_count_csr(row, col, u[:2], u[2:4], 16)  # new rows
        ops.intersect_count_csr(row, col, u[:2], u[2:4], 64)  # new width
        ops.intersect_per_node_csr(row, col, u[:2], u[2:4], 16, 3)
    assert aud.new_traces["intersect_count_csr"] == 3
    assert aud.new_traces["intersect_per_node_csr"] == 1
    assert aud.new_traces["intersect_support_csr"] == 0


def test_new_builds_count_library_loads(tmp_path, monkeypatch):
    """A library's first load in the process is a build or a load; later
    launches reuse it and record nothing."""
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    lib = _build.KernelLibrary("audit_probe", [csrc / "k.cu"], lambda so: so)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    (tmp_path / f"libaudit_probe_{lib.digest()}.so").write_text("")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    with CompileAuditor() as aud:
        lib.load()
        lib.load()
        record_build("other_probe")
    assert aud.new_builds == {**{k: 0 for k in aud.new_builds},
                              "audit_probe": 1, "other_probe": 1}


def test_tracer_fills_jit_traces():
    from repro_torch import obs
    from repro_torch.core import TriangleCounter
    from repro_torch.graphs import erdos_renyi

    # sizes no other test uses, so the chunk kernel's signature is new here
    edges = erdos_renyi(347, 1291, seed=11)
    with obs.tracing() as t:
        TriangleCounter(method="wedge_bsearch", device="cpu").count(edges)
    assert t.jit_traces.get("chunk_count_kernel") == 1
    assert all(v > 0 for v in t.jit_traces.values())
    metrics = obs.export.to_jsonl_records(t)[-1]
    assert metrics["kind"] == "metrics" and metrics["jit_traces"] == t.jit_traces
    with obs.tracing(obs.Tracer(audit_compiles=False)) as t:
        TriangleCounter(method="wedge_bsearch", device="cpu").count(erdos_renyi(349, 1291,
                                                                                seed=11))
    assert t.jit_traces == {}


def test_concurrent_records_are_all_counted():
    """The service's lanes launch from several threads: every signature and
    every build recorded concurrently is counted, none lost."""
    import os
    import sys
    import threading

    from repro_torch.check.runtime import record_launch

    n_threads, per_thread = 2 * (os.cpu_count() or 4), 200
    shapes = [[torch.empty((t * per_thread + i,)) for i in range(per_thread)]
              for t in range(n_threads)]

    def work(t):
        for x in shapes[t]:
            record_launch("stress_probe", (x,), width=16)
            record_build("stress_probe_lib")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with CompileAuditor() as aud:
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert aud.new_traces["stress_probe"] == n_threads * per_thread
    assert aud.new_builds["stress_probe_lib"] == n_threads * per_thread
