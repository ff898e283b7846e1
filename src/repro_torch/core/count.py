"""Counting phase of the parallel forward algorithm (paper §II-C, §III-C).

The primitives of the reference's two exact schedules, in torch ops:

``wedge_bsearch``
    Expand each directed edge ``(u, v)`` into its wedge candidates
    ``w ∈ N⁺(u)`` and test ``w ∈ N⁺(v)`` with a batched branch-free binary
    search (``⌈log₂ L_max⌉`` steps of one gather and compare each).

``panel``
    Bucket edges by intersection width, gather fixed-width neighbor panels
    ``A ∈ (B, L_u)``, ``B ∈ (B, L_v)`` and intersect them row by row.  The
    ``panel_intersect_*`` functions here are the plain versions
    (:mod:`repro_torch.kernels.triangle_count.ref`); the ``"pallas"``
    backend of the engine runs the hand-written CUDA kernels instead.

Both count each triangle exactly once (forward orientation guarantees a
unique apex with two out-edges).  Orchestration — schedule selection,
memory-bounded edge chunking, uint64 host accumulation — lives in
:mod:`repro_torch.core.engine`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.distributed.compression import ensure_fits_int32
from repro_torch.kernels.triangle_count.ref import (
    gather_panels_arrays,
    intersect_count_ref,
    intersect_per_node_ref,
    intersect_support_ref,
)

from .preprocess import OrientedCSR

__all__ = [
    "WedgePlan",
    "make_wedge_plan",
    "expand_and_close_wedges",
    "expand_and_close_wedges_indexed",
    "segmented_int32_sum",
    "count_triangles",
    "bucketize_edges",
    "gather_panels",
    "gather_panels_arrays",
    "panel_intersect_count",
    "panel_intersect_per_node",
    "panel_intersect_support",
]


# ---------------------------------------------------------------------------
# wedge_bsearch schedule
# ---------------------------------------------------------------------------


class WedgePlan(NamedTuple):
    """Static sizing for the wedge expansion (host-computed)."""

    total_wedges: int       # padded wedge-buffer length
    n_search_steps: int     # ⌈log2(max out-degree + 1)⌉


def make_wedge_plan(csr: OrientedCSR) -> WedgePlan:
    """Compute wedge-buffer sizing from a CSR (read back to the host)."""
    out_deg = csr.out_degree.cpu().numpy()
    src = csr.src.cpu().numpy()
    total = int(out_deg[src].sum(dtype=np.int64)) if src.size else 0
    max_deg = int(out_deg.max()) if out_deg.size else 0
    steps = max(1, math.ceil(math.log2(max_deg + 1))) if max_deg else 1
    return WedgePlan(total_wedges=max(total, 1), n_search_steps=steps)


def _batched_search(col, lo, hi, target, n_steps: int):
    """Branch-free batched binary search over ``col[lo:hi]``.

    ``lo``/``hi``/``target`` are rank-1 and processed in lockstep, one
    gather and compare per step.  Returns ``(found, pos)`` where ``pos`` is
    the insertion index — the global ``col`` index of the match whenever
    ``found`` is true.
    """
    end = hi
    last = col.shape[0] - 1
    for _ in range(n_steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        below = col[mid.clamp(0, last)] < target
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    safe = lo.clamp(0, last)
    return (lo < end) & (col[safe] == target), safe


def _expand_close_body(
    src_e, dst_e, row_offsets, col, out_deg, wedge_budget, n_steps, shorter_side=False
):
    """Shared wedge expansion + closure; returns every per-slot artifact.

    ``(hit, edge_id, u, v, w, w_idx, vw_idx)`` as in the reference:
    ``edge_id`` is the slot's originating edge (local to this chunk),
    ``w_idx`` the global index of the arm ``(u, w)`` inside ``col``,
    ``vw_idx`` the global index of the closing edge ``(v, w)``.  Padding
    slots repeat the last edge id, as ``jnp.repeat(...,
    total_repeat_length=...)`` does; their index values are clipped-safe
    garbage and ``hit`` is false there.

    ``shorter_side`` (the distributed schedule's §Perf variant) enumerates
    each edge's candidates from the smaller of N⁺(u), N⁺(v) and searches
    the larger; ``u`` is then the enumerated endpoint and ``v`` the
    searched one.
    """
    dev = col.device
    m_local = src_e.shape[0]
    # edge_id < m_local and a valid slot's pos < its degree <= |col| are
    # narrowed to int32 below
    ensure_fits_int32(max(m_local, col.shape[0]), "chunk edges / CSR size (wedge slot ids)")
    valid_e = src_e >= 0
    safe_src = src_e.clamp(min=0)
    safe_dst = dst_e.clamp(min=0)
    if shorter_side:
        du = out_deg[safe_src]
        dv = out_deg[safe_dst]
        swap = dv < du
        safe_src, safe_dst = (
            torch.where(swap, safe_dst, safe_src),
            torch.where(swap, safe_src, safe_dst),
        )
        reps = torch.where(valid_e, torch.minimum(du, dv), 0)
    else:
        reps = torch.where(valid_e, out_deg[safe_src], 0)
    cum = torch.cumsum(reps, 0, dtype=torch.int64)
    starts = cum - reps
    slots = torch.arange(wedge_budget, dtype=torch.int64, device=dev)
    edge_id = torch.searchsorted(cum, slots, right=True).clamp_(max=max(m_local - 1, 0))
    pos = (slots - starts[edge_id]).to(torch.int32)
    valid = (pos >= 0) & (pos < reps[edge_id])
    u = safe_src[edge_id]
    v = safe_dst[edge_id]
    w_idx = (row_offsets[u] + pos).clamp_(0, col.shape[0] - 1)
    w = col[w_idx]
    found, vw_idx = _batched_search(col, row_offsets[v], row_offsets[v + 1], w, n_steps)
    return found & valid, edge_id.to(torch.int32), u, v, w, w_idx, vw_idx


def expand_and_close_wedges(src_e, dst_e, row_offsets, col, out_deg, wedge_budget, n_steps):
    """Expand a (possibly −1-padded) directed-edge tensor into wedges and
    close them with the batched binary search.

    Returns ``(hit, u, v, w)`` where ``hit[i]`` marks wedge slot ``i`` as a
    closed, non-padding triangle.
    """
    hit, _, u, v, w, _, _ = _expand_close_body(
        src_e, dst_e, row_offsets, col, out_deg, wedge_budget, n_steps
    )
    return hit, u, v, w


def expand_and_close_wedges_indexed(
    src_e, dst_e, row_offsets, col, out_deg, wedge_budget, n_steps
):
    """Wedge closure with *edge-index* attribution (per-edge support).

    Returns ``(hit, edge_id, uw_idx, vw_idx)``: the originating edge local
    to this chunk, and the global ``col`` indices of the arm ``(u, w)``
    and of the closing edge ``(v, w)``.
    """
    hit, edge_id, _, _, _, w_idx, vw_idx = _expand_close_body(
        src_e, dst_e, row_offsets, col, out_deg, wedge_budget, n_steps
    )
    return hit, edge_id, w_idx, vw_idx


def segmented_int32_sum(hits: torch.Tensor, seg: int = 1 << 20) -> torch.Tensor:
    """Reduce a boolean hit buffer to per-``seg``-slot int32 partials.

    A segment sum never exceeds ``seg`` (default 2²⁰), so int32 stays safe
    even when the whole buffer holds ≥ 2³¹ hits; the final reduction runs
    on the host in uint64 (:func:`repro_torch.core.engine.accumulate_partials`).
    """
    n = hits.shape[0]
    pad = (-n) % seg
    if pad:
        hits = torch.cat([hits, hits.new_zeros((pad,))])
    # trilint: ok[overflow] — a chunk partial: each segment sum is at most seg
    return hits.reshape(-1, seg).sum(dim=1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# panel schedule (bucketed fixed-width intersection)
# ---------------------------------------------------------------------------


def bucketize_edges(
    csr: OrientedCSR, widths: tuple[int, ...] = (16, 64, 256, 1024, 4096)
) -> dict[int, np.ndarray]:
    """Group directed edges by the padded width of the *longer* endpoint list.

    Host-side: returns ``{width: edge_indices}`` (int32 numpy arrays).
    """
    out_deg = csr.out_degree.cpu().numpy()
    src = csr.src.cpu().numpy()
    col = csr.col.cpu().numpy()
    # bucket indices are stored int32: fail loudly at m >= 2^31
    ensure_fits_int32(src.shape[0], "directed edge count (panel bucket indices)")
    need = np.maximum(out_deg[src], out_deg[col])
    buckets: dict[int, np.ndarray] = {}
    lo = 0
    for w in widths:
        mask = (need > lo) & (need <= w)
        idx = np.nonzero(mask)[0]
        if idx.size:
            buckets[w] = idx.astype(np.int32)
        lo = w
    if (need > widths[-1]).any():
        raise ValueError(
            f"max out-degree {int(need.max())} exceeds largest bucket {widths[-1]}; "
            "widen `widths` (forward orientation bounds it by sqrt(2m))"
        )
    return buckets


def gather_panels(csr: OrientedCSR, edge_idx: torch.Tensor, width: int):
    """Gather fixed-width neighbor panels for a bucket of the CSR's own edges.

    ``edge_idx`` slots holding −1 (budget-chunk padding) yield all-(−1)
    panel rows with zero lengths.
    """
    valid = edge_idx >= 0
    safe = edge_idx.clamp(min=0)
    u = torch.where(valid, csr.src[safe], -1)
    v = torch.where(valid, csr.col[safe], -1)
    return gather_panels_arrays(csr.row_offsets, csr.col, csr.out_degree, u, v, width)


def panel_intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sorted-set intersection sizes via masked all-pairs equality (plain)."""
    return intersect_count_ref(a, b)


def panel_intersect_per_node(a: torch.Tensor, b: torch.Tensor):
    """(count, arm) — the per-node reduction of the equality cube (plain)."""
    return intersect_per_node_ref(a, b)


def panel_intersect_support(a: torch.Tensor, b: torch.Tensor):
    """(count, arm, closure) — the full support attribution (plain)."""
    return intersect_support_ref(a, b)


# ---------------------------------------------------------------------------
# public entry point (thin facade over the unified engine)
# ---------------------------------------------------------------------------


def count_triangles(
    edges,
    n_nodes: int | None = None,
    method: str = "wedge_bsearch",
    max_wedge_chunk: int | None = None,
    *,
    device=None,
) -> int:
    """Count triangles in a canonical edge array through the engine."""
    from .engine import TriangleCounter  # late import: engine uses this module

    return TriangleCounter(
        method=method, max_wedge_chunk=max_wedge_chunk, device=device
    ).count(edges, n_nodes=n_nodes)
