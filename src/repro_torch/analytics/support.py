"""Per-edge triangle support (chunked, memory-bounded, backend-routed).

The PyTorch counterpart of ``repro.analytics.support``.  The *support* of
an undirected edge ``{u, v}`` is the number of triangles that contain it.
Under the forward orientation every triangle is one closed wedge whose
three directed edges — the base ``(u, v)``, the arm ``(u, w)`` and the
closing edge ``(v, w)`` — each get one hit, so ``support.sum() == 3 ×
triangle_count`` for every backend and budget.

Everything routes through the engine's backends
(:func:`repro_torch.core.engine.resolve_backend` / ``run_workload``):
``method`` selects ``wedge_bsearch`` (torch ops), ``panel``, ``pallas``
(the CUDA support kernel that reads the CSR) or ``distributed`` (the
§III-E stripes over a ``mesh=``), chunks honor
``max_wedge_chunk``, device partials are int32 and the per-edge totals
accumulate in int64.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core.engine import (
    TriangleCounter,
    _host,
    chunk_support_kernel,
    make_workload,
    prepare_oriented,
    resolve_backend,
    resolve_method,
    run_workload,
)
from repro_torch.distributed.mesh import mesh_device

__all__ = [
    "EdgeSupport",
    "SupportRun",
    "chunk_support_kernel",  # re-export: the kernel lives in the engine
    "edge_support",
    "support_on_arrays",
]


class SupportRun(NamedTuple):
    """Result + launch stats of one raw-arrays support computation."""

    support: np.ndarray        # (m,) int64, aligned with the src/col arrays
    n_chunks: int
    peak_wedge_buffer: int
    total_wedges: int
    method: str                # backend that actually executed
    fallback_reason: str | None


def support_on_arrays(
    row_offsets,
    src,
    col,
    out_degree,
    *,
    max_wedge_chunk: int | None = None,
    n_steps: int | None = None,
    bucket_pow2: bool = False,
    method: str = "wedge_bsearch",
    tuner=None,
    mesh=None,
    shorter_side: bool = False,
    device=None,
) -> SupportRun:
    """Per-directed-edge support over raw oriented-CSR arrays.

    The low-level entry the truss peel drives round after round:
    ``src``/``col`` may carry a −1-padded tail (padded slots get zero
    support).  The arrays may be numpy arrays or tensors; each goes to the
    run's ``device`` (``None``: the card; with a ``mesh``, its lead
    device) once.  ``method="auto"`` resolves against ``out_degree`` for
    that device, and to the §III-E striped backend when a mesh of more
    than one stripe is given; ``shorter_side`` goes to that backend.
    ``tuner`` (an :class:`repro_torch.core.tuning.AutoTuner`) steers the
    support CSR kernel's knobs.
    """
    dev = mesh_device(mesh, device)
    if _host(src).shape[0] == 0:
        return SupportRun(np.zeros((0,), np.int64), 0, 0, 0, "wedge_bsearch", None)
    resolved = resolve_method(method, out_degree, mesh=mesh, backend=dev.type)
    backend, executed, reason = resolve_backend(
        resolved, "support", tuner=tuner, mesh=mesh, shorter_side=shorter_side
    )
    work = make_workload(row_offsets, col, out_degree, src, col, n_steps=n_steps, device=dev)
    sup, plan = run_workload(
        backend, "support", work, budget=max_wedge_chunk, bucket_pow2=bucket_pow2
    )
    return SupportRun(
        sup, plan.n_chunks, plan.peak_buffer, plan.total_wedges, executed, reason
    )


@dataclasses.dataclass(frozen=True)
class EdgeSupport:
    """Per-edge triangle support over the forward-oriented edge list.

    ``(u[i], v[i])`` is directed edge ``i`` of the oriented CSR (one
    entry per undirected edge); ``support[i]`` is the number of triangles
    containing it.  The trailing fields mirror
    :class:`repro_torch.core.engine.EngineStats`; ``method`` is the
    backend that executed (never "auto").
    """

    u: np.ndarray              # (m,) int32 forward-edge sources
    v: np.ndarray              # (m,) int32 forward-edge targets
    support: np.ndarray        # (m,) int64 triangles through each edge
    n_nodes: int
    n_chunks: int
    peak_wedge_buffer: int
    wedge_budget: int | None
    total_wedges: int
    method: str = "wedge_bsearch"
    fallback_reason: str | None = None

    @property
    def n_edges(self) -> int:
        return self.support.shape[0]

    def total_triangles(self) -> int:
        """Global triangle count implied by the support (Σ support / 3)."""
        return int(self.support.sum(dtype=np.int64)) // 3

    def top_k(self, k: int = 10):
        """The ``k`` most triangle-dense edges as ``(u, v, support)``."""
        k = min(int(k), self.n_edges)
        if k <= 0:
            return (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.int64),)
        order = np.argsort(-self.support, kind="stable")[:k]
        return self.u[order], self.v[order], self.support[order]


def edge_support(
    edges,
    n_nodes: int | None = None,
    *,
    max_wedge_chunk: int | None = None,
    method: str = "auto",
    counter: TriangleCounter | None = None,
    mesh=None,
    device=None,
) -> EdgeSupport:
    """Per-edge triangle support for any engine-accepted graph input.

    ``edges`` may be a canonical edge array, an ``OrientedCSR``, or a
    cached undirected or compressed CSR — the front door of
    :meth:`repro_torch.core.engine.TriangleCounter.count`.  Pass
    ``counter=`` to reuse a configured counter (its ``last_stats`` reflect
    the call); it carries its own method, budget, mesh and device, so
    combining it with ``method=`` / ``max_wedge_chunk=`` / ``mesh=`` /
    ``device=`` is rejected.
    """
    if counter is not None and (
        method != "auto" or max_wedge_chunk is not None or mesh is not None
        or device is not None
    ):
        raise ValueError(
            "pass either counter= (which carries its own method/budget/mesh/device) "
            "or method=/max_wedge_chunk=/mesh=/device=, not both"
        )
    tc = counter if counter is not None else TriangleCounter(
        method=method, max_wedge_chunk=max_wedge_chunk, mesh=mesh, device=device
    )
    csr = prepare_oriented(edges, n_nodes, device=tc.device)
    if csr is None:
        n = n_nodes if n_nodes is not None else getattr(edges, "n_nodes", 0) or 0
        empty32 = np.zeros((0,), np.int32)
        return EdgeSupport(
            u=empty32, v=empty32, support=np.zeros((0,), np.int64), n_nodes=n,
            n_chunks=0, peak_wedge_buffer=0, wedge_budget=tc.max_wedge_chunk,
            total_wedges=0,
        )
    sup = tc.edge_support(csr)
    st = tc.last_stats
    return EdgeSupport(
        u=_host(csr.src).astype(np.int32),
        v=_host(csr.col).astype(np.int32),
        support=sup,
        n_nodes=csr.n_nodes,
        n_chunks=st.n_chunks,
        peak_wedge_buffer=st.peak_wedge_buffer,
        wedge_budget=st.wedge_budget,
        total_wedges=st.total_wedges,
        method=st.method,
        fallback_reason=st.fallback_reason,
    )
