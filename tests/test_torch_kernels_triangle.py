"""Port parity: the intersection kernel family's wrappers on CPU tensors.

``repro_torch.kernels.triangle_count.ops`` sends CPU tensors to the plain
PyTorch versions; they must equal the reference's Pallas kernels run in
interpret mode, bit for bit, on the reference test's shapes and dtypes,
all-padding rows and ``tiles=`` overrides.  ``ops.intersect_count_csr``,
``ops.intersect_per_node_csr`` and ``ops.intersect_support_csr`` (the
family read from the CSR) must equal the reference's panel gather followed
by its Pallas kernel and, for per-node and support, its engine's scatter.
The CUDA kernels themselves run only on a card (``chip_smoke.py``, and the
``cuda``-marked tests here).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.count import gather_panels_arrays as ref_gather_panels_arrays  # noqa: E402
from repro.core.engine import _panel_scatter_per_node as ref_scatter_per_node  # noqa: E402
from repro.core.engine import _panel_scatter_support as ref_scatter_support  # noqa: E402
from repro.graphs.io import ingest  # noqa: E402
from repro.kernels.triangle_count import (  # noqa: E402
    intersect_count_pallas,
    intersect_per_node_pallas,
    intersect_support_pallas,
)
from repro_torch.core import prepare_oriented  # noqa: E402
from repro_torch.kernels.triangle_count import ops, ref, triangle_count  # noqa: E402

KARATE = os.path.join(os.path.dirname(__file__), "data", "karate.txt")

SHAPES = [(1, 8, 8), (5, 16, 64), (32, 128, 128), (9, 256, 1024), (2, 2048, 128),
          (64, 64, 32)]


def random_panels(rng, b, l, dtype):
    """Sorted, −1-padded rows of random length (tests/test_kernels_triangle.py)."""
    rows = []
    for _ in range(b):
        n = int(rng.integers(0, l + 1))
        vals = np.sort(rng.choice(4 * l + 8, size=n, replace=False))
        rows.append(np.concatenate([vals, -np.ones(l - n)]).astype(dtype))
    return np.stack(rows)


def assert_family_equal(a, b, tiles=None):
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    got = ops.intersect_count(ta, tb, tiles=tiles)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(intersect_count_pallas(ja, jb, interpret=True, tiles=tiles)))
    for g, w in zip(ops.intersect_per_node(ta, tb, tiles=tiles),
                    intersect_per_node_pallas(ja, jb, interpret=True, tiles=tiles)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(ops.intersect_support(ta, tb, tiles=tiles),
                    intersect_support_pallas(ja, jb, interpret=True, tiles=tiles)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
@pytest.mark.parametrize("b,lu,lv", SHAPES)
def test_count_matches_pallas_interpret(b, lu, lv, dtype, rng):
    """As tests/test_kernels_triangle.py::test_kernel_matches_ref."""
    a, c = random_panels(rng, b, lu, dtype), random_panels(rng, b, lv, dtype)
    got = ops.intersect_count(torch.from_numpy(a), torch.from_numpy(c))
    want = intersect_count_pallas(jnp.asarray(a), jnp.asarray(c), interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,lu,lv", SHAPES)
def test_family_matches_pallas_interpret(b, lu, lv, rng):
    """As tests/test_kernels_triangle.py::test_attribution_kernels_match_ref."""
    assert_family_equal(random_panels(rng, b, lu, np.int32), random_panels(rng, b, lv, np.int32))


def test_all_padding_rows(rng):
    a = random_panels(rng, 6, 64, np.int32)
    a[::2] = -1
    b = np.full((6, 32), -1, np.int32)
    b[1] = random_panels(rng, 1, 32, np.int32)[0]
    assert_family_equal(a, b)
    assert ops.intersect_count(torch.from_numpy(a), torch.from_numpy(b)).tolist() == [0] * 6


@pytest.mark.parametrize("tiles", [(1, 128), (8, 256), (64, 512), (256, 4096)])
def test_tile_overrides_never_change_results(tiles, rng):
    assert_family_equal(random_panels(rng, 23, 64, np.int32),
                        random_panels(rng, 23, 640, np.int32), tiles=tiles)


def test_empty_batch():
    a = torch.empty((0, 16), dtype=torch.int32)
    cnt, arm, clo = ops.intersect_support(a, a)
    assert cnt.shape == (0,) and arm.shape == (0, 16) and clo.shape == (0, 16)


def test_ref_blocks_rows_without_changing_results(rng, monkeypatch):
    a = torch.from_numpy(random_panels(rng, 37, 48, np.int32))
    b = torch.from_numpy(random_panels(rng, 37, 80, np.int32))
    whole = ref.intersect_support_ref(a, b)
    monkeypatch.setattr(ref, "_CUBE_ELEMS", 48 * 80 * 3)  # 3 rows per block
    for w, g in zip(whole, ref.intersect_support_ref(a, b)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_cuda_wrappers_reject_cpu_tensors():
    a = torch.zeros((2, 8), dtype=torch.int32)
    for fn in (triangle_count.intersect_count_cuda, triangle_count.intersect_per_node_cuda,
               triangle_count.intersect_support_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(a, a)


def csr_queries(edges, rng):
    """The CSR of ``edges`` (CPU tensors) and query pairs: every directed
    edge, random node pairs (either side longer), chunk padding (−1, −1)
    and half-padded rows."""
    csr = prepare_oriented(edges, device="cpu")
    n = csr.row_offsets.shape[0] - 1
    pairs = rng.integers(0, n, size=(40, 2))
    u = np.concatenate([csr.src.numpy(), pairs[:, 0], [-1] * 5, [0, -1]]).astype(np.int32)
    v = np.concatenate([csr.col.numpy(), pairs[:, 1], [-1] * 5, [-1, 0]]).astype(np.int32)
    return csr, u, v


@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("name", ["er", "kron", "ws", "triangle", "karate"])
def test_count_csr_matches_reference_gather_and_pallas(name, width, small_graphs, rng):
    edges = ingest(KARATE)[0].edge_array() if name == "karate" else small_graphs[name]
    csr, u, v = csr_queries(edges, rng)
    got = ops.intersect_count_csr(csr.row_offsets, csr.col, torch.from_numpy(u),
                                  torch.from_numpy(v), width)
    a, b, _, _ = ref_gather_panels_arrays(
        *(jnp.asarray(t.numpy()) for t in (csr.row_offsets, csr.col, csr.out_degree)),
        jnp.asarray(u), jnp.asarray(v), width)
    want = intersect_count_pallas(a, b, interpret=True)
    assert got.dtype == torch.int32 and got.shape == (u.shape[0],)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[-7:].tolist() == [0] * 7  # padding rows count nothing


def test_count_csr_cuts_lists_to_the_width(rng):
    """A list longer than the bucket width is cut to its first ``width``
    entries, as the panel gather cuts it."""
    ro = torch.tensor([0, 40, 80], dtype=torch.int32)
    col = torch.from_numpy(np.concatenate([np.arange(40), np.arange(20, 60)]).astype(np.int32))
    u, v = torch.tensor([0, 1], dtype=torch.int32), torch.tensor([1, 0], dtype=torch.int32)
    # lists [0, 40) and [20, 60): 20 common; cut to 32 entries: [0, 32) and [20, 52)
    assert ops.intersect_count_csr(ro, col, u, v, 64).tolist() == [20, 20]
    assert ops.intersect_count_csr(ro, col, u, v, 32).tolist() == [12, 12]


def test_count_csr_rejects_mixed_devices_and_cpu_tensors_on_the_kernel():
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        triangle_count.intersect_count_csr_cuda(z, z, z, z, 16)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.intersect_count_csr(z, z, z.to("meta"), z, 16)


def reference_panels(csr, u, v, width):
    """The reference's JAX panel gather of the rows ``(u, v)``."""
    a, b, _, _ = ref_gather_panels_arrays(
        *(jnp.asarray(t.numpy()) for t in (csr.row_offsets, csr.col, csr.out_degree)),
        jnp.asarray(u), jnp.asarray(v), width)
    return a, b


def query_edge_ids(u, v, m):
    """Global query ids for the rows: a valid id where both ends are, −1
    (chunk padding) elsewhere."""
    return np.where((u >= 0) & (v >= 0), np.arange(u.shape[0]) % m, -1).astype(np.int32)


@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("name", ["er", "kron", "ws", "triangle", "karate"])
def test_per_node_csr_matches_reference_gather_and_pallas(name, width, small_graphs, rng):
    edges = ingest(KARATE)[0].edge_array() if name == "karate" else small_graphs[name]
    csr, u, v = csr_queries(edges, rng)
    n_out = csr.n_nodes
    got = ops.intersect_per_node_csr(csr.row_offsets, csr.col, torch.from_numpy(u),
                                     torch.from_numpy(v), width, n_out)
    a, b = reference_panels(csr, u, v, width)
    count, arm = intersect_per_node_pallas(a, b, interpret=True)
    want = ref_scatter_per_node(jnp.asarray(u), jnp.asarray(v), a, count, arm, n_out=n_out)
    assert got.dtype == torch.int32 and got.shape == (n_out,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == 3 * int(np.asarray(count).sum())


@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("name", ["er", "kron", "ws", "triangle", "karate"])
def test_support_csr_matches_reference_gather_and_pallas(name, width, small_graphs, rng):
    edges = ingest(KARATE)[0].edge_array() if name == "karate" else small_graphs[name]
    csr, u, v = csr_queries(edges, rng)
    m_out = csr.n_directed_edges
    e = query_edge_ids(u, v, m_out)
    got = ops.intersect_support_csr(csr.row_offsets, csr.col, torch.from_numpy(u),
                                    torch.from_numpy(v), torch.from_numpy(e), width, m_out)
    a, b = reference_panels(csr, u, v, width)
    count, arm, closure = intersect_support_pallas(a, b, interpret=True)
    want = ref_scatter_support(jnp.asarray(e), jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(csr.row_offsets.numpy()), count, arm, closure,
                               m_out=m_out)
    assert got.dtype == torch.int32 and got.shape == (m_out,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == 3 * int(np.asarray(count).sum())


def two_lists():
    """Two nodes with lists [0, 40) and [20, 60), queried both ways."""
    ro = torch.tensor([0, 40, 80], dtype=torch.int32)
    col = torch.from_numpy(np.concatenate([np.arange(40), np.arange(20, 60)]).astype(np.int32))
    u, v = torch.tensor([0, 1], dtype=torch.int32), torch.tensor([1, 0], dtype=torch.int32)
    return ro, col, u, v


@pytest.mark.parametrize("width,common", [(64, range(20, 40)), (32, range(20, 32))])
def test_per_node_csr_cuts_lists_to_the_width(width, common):
    """Cut to 32 entries the lists are [0, 32) and [20, 52): 12 common."""
    ro, col, u, v = two_lists()
    want = np.zeros(64, np.int32)
    want[list(common)] = 2           # each row bills each common entry once
    want[[0, 1]] = 2 * len(common)   # each row's count goes to u and to v
    got = ops.intersect_per_node_csr(ro, col, u, v, width, 64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width,common", [(64, range(20, 40)), (32, range(20, 32))])
def test_support_csr_cuts_lists_to_the_width(width, common):
    """Each common x is slot x of node 0's list (edge x) and slot x − 20 of
    node 1's (edge 40 + x − 20); each row's count goes to its edge id."""
    ro, col, u, v = two_lists()
    want = np.zeros(80, np.int32)
    for x in common:
        want[x] += 2
        want[40 + x - 20] += 2
    want[[0, 1]] += len(common)
    got = ops.intersect_support_csr(ro, col, u, v, torch.tensor([0, 1], dtype=torch.int32),
                                    width, 80)
    np.testing.assert_array_equal(got.numpy(), want)


def test_per_node_and_support_csr_reject_mixed_devices_and_cpu_tensors_on_the_kernel():
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        triangle_count.intersect_per_node_csr_cuda(z, z, z, z, 16, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        triangle_count.intersect_support_csr_cuda(z, z, z, z, z, 16, 4)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.intersect_per_node_csr(z, z, z.to("meta"), z, 16, 4)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.intersect_support_csr(z, z, z, z, z.to("meta"), 16, 4)


def test_import_without_cuda_or_nvcc():
    """Importing the kernel package needs no nvcc, no card and builds nothing."""
    code = (
        "import sys, torch\n"
        "import repro_torch.kernels.triangle_count as tc\n"
        "from repro_torch.kernels.triangle_count import _build\n"
        "assert _build.build_info() is None\n"
        "assert 'triton' not in sys.modules\n"
        "print(sorted(tc.launches))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                              "PYTHONPATH": ":".join(sys.path)}, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "intersect_count" in out.stdout


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on one)")
    for b, lu, lv in SHAPES + [(16, 4096, 4096)]:
        a = torch.from_numpy(random_panels(rng, b, lu, np.int32)).cuda()
        c = torch.from_numpy(random_panels(rng, b, lv, np.int32)).cuda()
        for g, w in zip(ops.intersect_support(a, c), ref.intersect_support_ref(a, c)):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_count_csr_matches_plain_on_card(small_graphs, rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on one)")
    for name in small_graphs:
        csr, u, v = csr_queries(small_graphs[name], rng)
        dev = [t.cuda() for t in (csr.row_offsets, csr.col, torch.from_numpy(u), torch.from_numpy(v))]
        for width in (16, 64, 256, 4096):
            got = ops.intersect_count_csr(*dev, width)
            assert torch.equal(got.cpu(), ops.intersect_count_csr(
                csr.row_offsets, csr.col, torch.from_numpy(u), torch.from_numpy(v), width))


@pytest.mark.cuda
def test_cuda_per_node_and_support_csr_match_plain_on_card(small_graphs, rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on one)")
    for name in small_graphs:
        csr, u, v = csr_queries(small_graphs[name], rng)
        e = query_edge_ids(u, v, csr.n_directed_edges)
        cpu = [csr.row_offsets, csr.col, torch.from_numpy(u), torch.from_numpy(v)]
        dev = [t.cuda() for t in cpu]
        e_cpu = torch.from_numpy(e)
        for width in (16, 64, 256, 4096):
            got = ops.intersect_per_node_csr(*dev, width, csr.n_nodes)
            assert torch.equal(got.cpu(), ops.intersect_per_node_csr(*cpu, width, csr.n_nodes))
            got = ops.intersect_support_csr(*dev, e_cpu.cuda(), width, csr.n_directed_edges)
            assert torch.equal(got.cpu(), ops.intersect_support_csr(
                *cpu, e_cpu, width, csr.n_directed_edges))
