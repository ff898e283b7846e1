"""Port parity: the wedge and panel primitives of repro_torch.core.count.

The same oriented CSR (the reference's, handed to the port through
``OrientedCSR.from_numpy``) and the same −1-padded edge chunks go through
both packages; hit masks, every per-slot index (padding slots included),
segment partials and panel gathers must be equal (tolerance 0).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import count as ref_count  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core.preprocess import preprocess as ref_preprocess  # noqa: E402
from repro_torch.core import count as port_count  # noqa: E402
from repro_torch.core.preprocess import OrientedCSR  # noqa: E402


# one compile per (buffer, steps) pair instead of an eager op-by-op run per chunk
ref_expand_close = jax.jit(ref_count._expand_close_body, static_argnums=(5, 6))


def both_csrs(edges):
    ref = ref_preprocess(edges, n_nodes=int(edges.max()) + 1)
    return ref, OrientedCSR.from_numpy(*(np.asarray(x) for x in ref), device="cpu")


def padded_chunks(csr, budget):
    """The reference's own −1-padded wedge chunks (host arrays)."""
    gen, n_chunks, peak, _ = ref_engine.iter_wedge_chunks(csr, budget)
    chunks = [(np.array(s), np.array(d), start) for s, d, start in gen]
    assert len(chunks) == n_chunks
    return chunks, peak


@pytest.mark.parametrize("budget", [None, 97, 2048])
@pytest.mark.parametrize("name", ["kron", "ws"])
def test_wedge_slots_match_reference(small_graphs, name, budget):
    ref, port = both_csrs(small_graphs[name])
    chunks, peak = padded_chunks(ref, budget)
    plan = ref_count.make_wedge_plan(ref)
    assert port_count.make_wedge_plan(port) == plan
    for s, d, _ in chunks:
        want = ref_expand_close(
            jnp.asarray(s), jnp.asarray(d), ref.row_offsets, ref.col, ref.out_degree,
            peak, plan.n_search_steps,
        )
        got = port_count._expand_close_body(
            torch.from_numpy(s), torch.from_numpy(d), port.row_offsets, port.col,
            port.out_degree, peak, plan.n_search_steps,
        )
        for label, w, g in zip(("hit", "edge_id", "u", "v", "w", "w_idx", "vw_idx"),
                               want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=label)
            assert g.shape == (peak,)
        np.testing.assert_array_equal(
            port_count.segmented_int32_sum(got[0], seg=64).numpy(),
            np.asarray(ref_count.segmented_int32_sum(want[0], seg=64)),
        )


@pytest.mark.parametrize("seg", [1, 7, 64, 1 << 20])
def test_segmented_int32_sum(rng, seg):
    hits = rng.random(1000) < 0.3
    got = port_count.segmented_int32_sum(torch.from_numpy(hits), seg=seg)
    want = np.asarray(ref_count.segmented_int32_sum(jnp.asarray(hits), seg=seg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_indexed_expansion_matches_reference(small_graphs):
    ref, port = both_csrs(small_graphs["er"])
    plan = ref_count.make_wedge_plan(ref)
    buffer = plan.total_wedges + 77  # trailing padding slots
    want = jax.jit(ref_count.expand_and_close_wedges_indexed, static_argnums=(5, 6))(
        ref.src, ref.col, ref.row_offsets, ref.col, ref.out_degree,
        buffer, plan.n_search_steps,
    )
    got = port_count.expand_and_close_wedges_indexed(
        port.src, port.col, port.row_offsets, port.col, port.out_degree,
        buffer, plan.n_search_steps,
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bucketize_and_gather_match_reference(small_graphs):
    ref, port = both_csrs(small_graphs["kron"])
    want = ref_count.bucketize_edges(ref)
    got = port_count.bucketize_edges(port)
    assert sorted(got) == sorted(want)
    for width, idx in want.items():
        np.testing.assert_array_equal(got[width], idx)
        padded = np.concatenate([idx, np.full(5, -1, np.int32)])
        w_out = ref_count.gather_panels(ref, jnp.asarray(padded), width)
        g_out = port_count.gather_panels(port, torch.from_numpy(padded), width)
        for w, g in zip(w_out, g_out):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for w, g in zip(ref_count.panel_intersect_support(w_out[0], w_out[1]),
                        port_count.panel_intersect_support(g_out[0], g_out[1])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bucketize_rejects_narrow_ladder(small_graphs):
    _, port = both_csrs(small_graphs["kron"])
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        port_count.bucketize_edges(port, widths=(2,))


# ---------------------------------------------------------------------------
# the unchunked public functions (count_triangles_csr, per_node_triangles)
# ---------------------------------------------------------------------------

KARATE = os.path.join(os.path.dirname(__file__), "data", "karate.txt")


@pytest.mark.parametrize("name", ["er", "kron", "ws", "triangle", "karate"])
def test_unchunked_count_and_per_node_match_reference(small_graphs, name):
    from repro.graphs.io import ingest
    from repro_torch.core import TriangleCounter, count_triangles_csr, count_wedges_found
    from repro_torch.core import per_node_triangles

    edges = ingest(KARATE)[0].edge_array() if name == "karate" else small_graphs[name]
    ref, port = both_csrs(edges)
    plan = ref_count.make_wedge_plan(ref)
    found, uvw = count_wedges_found(port, port_count.make_wedge_plan(port))
    want_found, want_uvw = ref_count.count_wedges_found(ref, plan)
    np.testing.assert_array_equal(found.numpy(), np.asarray(want_found))
    for g, w in zip(uvw, want_uvw):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    count = count_triangles_csr(port)
    assert count == ref_count.count_triangles_csr(ref)
    assert count == TriangleCounter(method="wedge_bsearch", device="cpu").count(edges)
    if name == "karate":
        assert count == 45
    per_node = per_node_triangles(port)
    assert per_node.dtype == torch.int32
    np.testing.assert_array_equal(per_node.numpy(), np.asarray(ref_count.per_node_triangles(ref)))
    np.testing.assert_array_equal(
        per_node.numpy(), TriangleCounter(method="wedge_bsearch", device="cpu").per_node(edges))
