"""Exact k-truss decomposition by iterative support-peeling.

The PyTorch counterpart of ``repro.analytics.truss``.  The *k-truss* of a
graph is the maximal subgraph in which every edge is supported by at
least ``k − 2`` triangles; the *trussness* of an edge is the largest
``k`` whose truss contains it.  Every peeling round recomputes per-edge
support with the chunked support kernel
(:func:`repro_torch.analytics.support.support_on_arrays`) on the
surviving edges and removes the under-supported ones, until the k-truss
is stable; then ``k`` advances.

* **Orientation is computed once.**  A subgraph of an acyclic
  orientation stays acyclic and the oriented CSR is sorted by
  ``(src, dst)``, so each round's sub-CSR is a boolean filter of the
  original arrays (on the host, as in the reference), and edge ids stay
  stable.
* **pow2 shape bucketing.**  The edge axis, the chunk width and the
  wedge budget round up to powers of two as in the reference.  Nothing
  is compiled per shape here; the bucketing keeps ``n_support_launches``
  and every plan equal to the reference's.
* **backend-routed support.**  Every round runs through the engine's
  backends, so ``method="pallas"`` drives the CUDA support kernel once
  per chunk of every round, and ``method="distributed"`` (with ``mesh=``)
  stripes every round's support over the mesh.  The spectrum is
  backend-independent.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.core.engine import (
    _host,
    next_pow2,
    prepare_oriented,
    resolve_method,
    search_steps,
)
from repro_torch.distributed.compression import ensure_fits_int32
from repro_torch.distributed.mesh import mesh_device

from .support import support_on_arrays

__all__ = ["TrussDecomposition", "k_truss_decomposition", "k_truss_subgraph"]


@dataclasses.dataclass(frozen=True)
class TrussDecomposition:
    """Per-edge trussness over the forward-oriented edge list.

    ``(u[i], v[i])`` is directed edge ``i`` of the oriented CSR;
    ``trussness[i] ≥ 2`` always (every edge is trivially in the
    2-truss), and ``max_k`` is the largest non-empty truss.
    """

    u: np.ndarray           # (m,) int32 forward-edge sources
    v: np.ndarray           # (m,) int32 forward-edge targets
    trussness: np.ndarray   # (m,) int32
    max_k: int              # largest k with a non-empty k-truss (0 if no edges)
    n_nodes: int
    rounds: int             # support-recompute rounds the peel ran
    n_support_launches: int  # chunk-kernel launches across all rounds
    method: str = "wedge_bsearch"  # backend the support recomputes executed

    @property
    def n_edges(self) -> int:
        return self.trussness.shape[0]

    def spectrum(self) -> dict[int, int]:
        """``{k: number of edges with trussness exactly k}`` (sorted)."""
        ks, counts = np.unique(self.trussness, return_counts=True)
        return {int(k): int(c) for k, c in zip(ks, counts)}

    def truss_sizes(self) -> dict[int, int]:
        """``{k: number of edges in the k-truss}`` for k = 2..max_k."""
        if self.n_edges == 0:
            return {}
        return {
            k: int((self.trussness >= k).sum(dtype=np.int64))
            for k in range(2, self.max_k + 1)
        }

    def edges_at_least(self, k: int) -> np.ndarray:
        """Canonical edge array (both directions) of the k-truss."""
        mask = self.trussness >= k
        u, v = self.u[mask], self.v[mask]
        both = np.stack(
            [np.concatenate([u, v]), np.concatenate([v, u])], axis=1
        ).astype(np.int32)
        order = np.lexsort((both[:, 1], both[:, 0]))
        return both[order]


def _empty_result(n_nodes: int) -> TrussDecomposition:
    empty32 = np.zeros((0,), np.int32)
    return TrussDecomposition(
        u=empty32, v=empty32, trussness=empty32.copy(), max_k=0,
        n_nodes=n_nodes, rounds=0, n_support_launches=0,
    )


def k_truss_decomposition(
    edges,
    n_nodes: int | None = None,
    *,
    max_wedge_chunk: int | None = None,
    method: str = "auto",
    mesh=None,
    device=None,
) -> TrussDecomposition:
    """Full truss decomposition (per-edge trussness) of a graph.

    Accepts the engine's input kinds (edge array / ``OrientedCSR`` /
    cached CSR).  ``max_wedge_chunk`` bounds every support recomputation's
    wedge buffer, and ``method`` picks the backend every peel round runs
    on (``"auto"`` resolves once, against the *full* graph's degrees, for
    ``device``; ``None`` means the card).  With a ``mesh`` the peel runs on
    its lead device, and a mesh of more than one stripe makes ``"auto"``
    the striped backend: every round's support recompute then runs the
    §III-E stripes, pow2-bucketed as every backend's rounds are.
    """
    dev = mesh_device(mesh, device)
    csr = prepare_oriented(edges, n_nodes, device=dev)
    if csr is None:
        n = n_nodes if n_nodes is not None else getattr(edges, "n_nodes", 0) or 0
        return _empty_result(n)
    n = csr.n_nodes
    src0 = _host(csr.src).astype(np.int32)
    col0 = _host(csr.col).astype(np.int32)
    m = src0.shape[0]
    # binary-search depth fixed from the full graph: degrees only shrink
    # under peeling and extra steps are harmless, so every round shares
    # one n_steps, as in the reference
    steps = search_steps(csr)
    method = resolve_method(method, csr.out_degree, mesh=mesh, backend=dev.type)
    trussness = np.full(m, 2, np.int32)
    idx = np.arange(m)
    with obs.span("truss.round", cat="analytics",
                  args={"round": 1, "k": 3, "alive": int(idx.size)}):
        sup, launches, executed = _alive_support(
            src0, col0, idx, n, steps, max_wedge_chunk, method, dev, mesh
        )
    rounds = 1
    k = 3
    while idx.size:
        peel = sup < (k - 2)
        if peel.any():
            # edges that survived the (k-1)-peel but not this one are in
            # the (k-1)-truss and no denser one
            trussness[idx[peel]] = k - 1
            idx = idx[~peel]
            if idx.size == 0:
                break
            # removal may cascade: recompute support on the shrunk graph
            with obs.span("truss.round", cat="analytics",
                          args={"round": rounds + 1, "k": k,
                                "alive": int(idx.size)}):
                sup, n_chunks, executed = _alive_support(
                    src0, col0, idx, n, steps, max_wedge_chunk, method, dev, mesh
                )
            rounds += 1
            launches += n_chunks
        else:
            k += 1  # k-truss stable — the same support serves the next k
    return TrussDecomposition(
        u=src0, v=col0, trussness=trussness,
        max_k=int(trussness.max()) if m else 0,
        n_nodes=n, rounds=rounds, n_support_launches=launches,
        method=executed,
    )


def _alive_support(src0, col0, idx, n, steps, max_wedge_chunk, method, device, mesh=None):
    """Support of the surviving edges, on the filtered (pow2-padded) CSR."""
    # the sub-CSR's degrees and offsets are int32: at most the alive edges
    ensure_fits_int32(idx.shape[0], "alive edge count (sub-CSR row offsets)")
    sub_src = src0[idx]
    sub_col = col0[idx]
    sub_out = np.bincount(sub_src, minlength=n).astype(np.int32)
    sub_row = np.zeros((n + 1,), np.int32)
    np.cumsum(sub_out, out=sub_row[1:])
    m_pad = next_pow2(idx.shape[0])
    if m_pad > idx.shape[0]:
        fill = np.full(m_pad - idx.shape[0], -1, np.int32)
        sub_src = np.concatenate([sub_src, fill])
        sub_col = np.concatenate([sub_col, fill])
    run = support_on_arrays(
        sub_row, sub_src, sub_col, sub_out,
        max_wedge_chunk=max_wedge_chunk, n_steps=steps, bucket_pow2=True,
        method=method, mesh=mesh, device=device,
    )
    return run.support[: idx.shape[0]], run.n_chunks, run.method


def k_truss_subgraph(
    edges,
    k: int | None = None,
    n_nodes: int | None = None,
    *,
    max_wedge_chunk: int | None = None,
    method: str = "auto",
    mesh=None,
    device=None,
) -> tuple[np.ndarray, int]:
    """Extract the k-truss as a canonical edge array.

    ``k=None`` extracts the densest non-empty truss (``max_k``).
    Returns ``(canonical_edges, k)`` — the edge array is in the
    both-directions canonical form the engine consumes.  ``edges`` may
    also be a finished :class:`TrussDecomposition`.
    """
    dec = (
        edges
        if isinstance(edges, TrussDecomposition)
        else k_truss_decomposition(
            edges, n_nodes, max_wedge_chunk=max_wedge_chunk, method=method,
            mesh=mesh, device=device,
        )
    )
    if dec.n_edges == 0:
        return np.zeros((0, 2), np.int32), 0
    kk = dec.max_k if k is None else int(k)
    return dec.edges_at_least(kk), kk
