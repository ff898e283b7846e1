"""Port parity: repro_torch's forward orientation equals the reference's.

The same numpy inputs go through ``repro.core.preprocess`` (JAX, CPU) and
``repro_torch.core.preprocess`` (PyTorch, ``device="cpu"``); every field
of the two ``OrientedCSR``s must be equal (tolerance 0).
"""
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs import io as ref_io  # noqa: E402
from repro_torch.graphs import io as port_io  # noqa: E402

# the packages' ``core`` re-exports the function ``preprocess`` over the module
ref_pre = importlib.import_module("repro.core.preprocess")
port_pre = importlib.import_module("repro_torch.core.preprocess")

KARATE = os.path.join(os.path.dirname(__file__), "data", "karate.txt")
FIELDS = ("row_offsets", "src", "col", "out_degree", "degree")


def assert_csr_equal(ref, port):
    assert port.n_nodes == ref.n_nodes
    assert port.n_directed_edges == ref.n_directed_edges
    for name in FIELDS:
        r, p = np.asarray(getattr(ref, name)), getattr(port, name)
        assert p.dtype == torch.int32, name
        assert p.device.type == "cpu", name
        np.testing.assert_array_equal(p.numpy(), r, err_msg=name)


def karate_edges():
    from repro_torch.graphs.io import ingest

    csr, _ = ingest(KARATE)
    return csr.edge_array()


@pytest.mark.parametrize("name", ["er", "kron", "ws", "triangle"])
def test_preprocess_matches_reference(small_graphs, name):
    edges = small_graphs[name]
    n = int(edges.max()) + 1
    assert_csr_equal(ref_pre.preprocess(edges, n_nodes=n),
                     port_pre.preprocess(edges, n_nodes=n, device="cpu"))


def test_preprocess_karate():
    edges = karate_edges()
    n = int(edges.max()) + 1
    assert_csr_equal(ref_pre.preprocess(edges, n_nodes=n),
                     port_pre.preprocess(edges, n_nodes=n, device="cpu"))


@pytest.mark.parametrize("name", ["er", "kron", "ws"])
def test_host_offload_matches_reference(small_graphs, name):
    edges = small_graphs[name]
    assert_csr_equal(ref_pre.preprocess_host_offload(edges),
                     port_pre.preprocess_host_offload(edges, device="cpu"))


def test_undirected_csr_path(tmp_path):
    ref_csr, _ = ref_io.ingest(KARATE, cache_dir=tmp_path / "ref")
    port_csr, _ = port_io.ingest(KARATE, cache_dir=tmp_path / "port")
    np.testing.assert_array_equal(port_csr.row_offsets, ref_csr.row_offsets)
    np.testing.assert_array_equal(port_csr.col, ref_csr.col)
    want = ref_pre.oriented_from_undirected_csr(ref_csr.row_offsets, ref_csr.col)
    assert_csr_equal(want, port_pre.oriented_from_undirected_csr(
        port_csr.row_offsets, port_csr.col, device="cpu"))
    assert_csr_equal(want, port_pre.preprocess_host_offload(port_csr, device="cpu"))


@pytest.mark.parametrize("order", ["natural", "degree"])
def test_compressed_path(tmp_path, order):
    kw = dict(storage="compressed", order=order)
    ref_z, _ = ref_io.ingest(KARATE, cache_dir=tmp_path / "ref", **kw)
    port_z, _ = port_io.ingest(KARATE, cache_dir=tmp_path / "port", **kw)
    want = ref_pre.oriented_from_compressed(ref_z)
    assert_csr_equal(want, port_pre.oriented_from_compressed(port_z, device="cpu"))
    assert_csr_equal(want, port_pre.preprocess_host_offload(port_z, device="cpu"))


def test_from_numpy_roundtrip(small_graphs):
    edges = small_graphs["kron"]
    ref = ref_pre.preprocess(edges, n_nodes=int(edges.max()) + 1)
    port = port_pre.OrientedCSR.from_numpy(*(np.asarray(x) for x in ref), device="cpu")
    assert_csr_equal(ref, port)


def test_non_canonical_input_raises():
    one_way = np.array([[0, 1], [0, 2], [1, 2], [2, 1]], np.int32)
    with pytest.raises(ValueError, match="not canonical"):
        port_pre.preprocess(one_way, n_nodes=3, device="cpu")
