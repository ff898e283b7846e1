"""Plain PyTorch versions of the intersection kernel family.

The masked equality reduction of the reference's ``ref.py``, on tensors:
``eq[i, j, k] = (a[i, j] == b[i, k]) & (a[i, j] >= 0) & (b[i, k] >= 0)``,
reduced over the axes each kernel returns.  The CPU tests and the engine
on CPU tensors use these; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Rows are processed in blocks so the
``(rows, Lu, Lv)`` cube stays under ``_CUBE_ELEMS`` booleans — they are
still no yardstick of speed.
"""
from __future__ import annotations

import torch

__all__ = ["intersect_count_ref", "intersect_per_node_ref", "intersect_support_ref",
           "gather_panels_arrays", "panel_scatter_per_node", "panel_scatter_support",
           "intersect_count_csr_ref", "intersect_per_node_csr_ref", "intersect_support_csr_ref"]

_CUBE_ELEMS = 1 << 26


def _blocks(a: torch.Tensor, b: torch.Tensor):
    """Yield ``(row slice, masked equality cube)`` for bounded row blocks."""
    n, lu = a.shape
    lv = b.shape[1]
    step = max(1, _CUBE_ELEMS // max(lu * lv, 1))
    for s in range(0, n, step):
        aa, bb = a[s : s + step], b[s : s + step]
        eq = aa[:, :, None] == bb[:, None, :]
        eq &= (aa[:, :, None] >= 0) & (bb[:, None, :] >= 0)
        yield slice(s, s + step), eq


def intersect_count_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Count matching entries between −1-padded rows. (B,Lu),(B,Lv) → (B,) int32."""
    out = torch.zeros((a.shape[0],), dtype=torch.int32, device=a.device)
    for sl, eq in _blocks(a, b):
        out[sl] = eq.sum(dim=(1, 2), dtype=torch.int32)
    return out


def intersect_per_node_ref(a: torch.Tensor, b: torch.Tensor):
    """(count (B,), arm (B, Lu)) — the per-node kernel's axis reductions."""
    arm = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    for sl, eq in _blocks(a, b):
        arm[sl] = eq.sum(dim=2, dtype=torch.int32)
    return arm.sum(dim=1, dtype=torch.int32), arm


def intersect_support_ref(a: torch.Tensor, b: torch.Tensor):
    """(count (B,), arm (B, Lu), closure (B, Lv)) — the support reductions."""
    arm = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    closure = torch.zeros(b.shape, dtype=torch.int32, device=a.device)
    for sl, eq in _blocks(a, b):
        arm[sl] = eq.sum(dim=2, dtype=torch.int32)
        closure[sl] = eq.sum(dim=1, dtype=torch.int32)
    return arm.sum(dim=1, dtype=torch.int32), arm, closure


def gather_panels_arrays(row_offsets, col, out_degree, u, v, width: int):
    """Gather fixed-width neighbor panels for arbitrary ``(u, v)`` pairs.

    Returns ``(a, b, a_len, b_len)``: ``a: (B, width)`` the out-neighbors
    of each ``u`` (−1 padded), ``b`` likewise for ``v``.  ``u``/``v`` slots
    holding −1 (chunk padding) yield all-(−1) rows with zero lengths.
    """
    valid = (u >= 0) & (v >= 0)
    safe_u = u.clamp(min=0)
    safe_v = v.clamp(min=0)
    lane = torch.arange(width, dtype=torch.int32, device=col.device)
    last = max(col.shape[0] - 1, 0)

    def panel(base, length):
        idx = (base[:, None] + lane[None, :]).clamp_(0, last)
        vals = col[idx] if col.shape[0] else torch.full_like(idx, -1)
        return torch.where(lane[None, :] < length[:, None], vals, -1)

    a_len = torch.where(valid, out_degree[safe_u], 0)
    b_len = torch.where(valid, out_degree[safe_v], 0)
    a = panel(row_offsets[safe_u], a_len)
    b = panel(row_offsets[safe_v], b_len)
    return a, b, a_len, b_len


def panel_scatter_per_node(u, v, a, count, arm, *, n_out):
    """Scatter a panel chunk's (count, arm) to per-vertex int32 slots.

    ``count`` bills each hit to the endpoints ``u``/``v``; ``arm`` bills
    it to the third vertex, the value in the ``a`` panel.  Indices are
    clipped to ``[0, n_out)`` as the reference clips them; padding carries
    zero counts, so its clipped indices never corrupt real slots.  Only
    the nonzero arms are scattered: the rest are mostly −1 padding, whose
    clipped index 0 would serialize every add of a chunk on one slot.
    """
    out = torch.zeros((n_out,), dtype=torch.int32, device=count.device)
    out.index_add_(0, u.clamp(0, n_out - 1), torch.where(u >= 0, count, 0))
    out.index_add_(0, v.clamp(0, n_out - 1), torch.where(v >= 0, count, 0))
    hit = arm > 0
    out.index_add_(0, a[hit].clamp(0, n_out - 1), arm[hit])
    return out


def panel_scatter_support(edge_idx, u, v, row_offsets, count, arm, closure, *, m_out):
    """Scatter (count, arm, closure) to the three directed-edge int32 slots.

    Base ``(u, v)`` is the chunk's global query id; arm slot ``j`` is edge
    ``row_offsets[u] + j``; closure slot ``k`` is ``row_offsets[v] + k``.
    Lanes past a row's length carry zero counts.
    """
    out = torch.zeros((m_out,), dtype=torch.int32, device=count.device)
    out.index_add_(
        0, edge_idx.clamp(0, m_out - 1), torch.where(edge_idx >= 0, count, 0)
    )
    for side, vals in ((u, arm), (v, closure)):
        lane = torch.arange(vals.shape[1], dtype=torch.int32, device=vals.device)
        base = row_offsets[side.clamp(min=0)][:, None]
        idx = (base + lane[None, :]).clamp_(0, m_out - 1)
        out.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return out


def _csr_panels(row_offsets, col, u, v, width: int):
    out_degree = row_offsets[1:] - row_offsets[:-1]
    a, b, _, _ = gather_panels_arrays(row_offsets, col, out_degree, u, v, width)
    return a, b


def intersect_count_csr_ref(row_offsets, col, u, v, width: int) -> torch.Tensor:
    """The CSR count kernel's function: the panel gather, then the count."""
    return intersect_count_ref(*_csr_panels(row_offsets, col, u, v, width))


def intersect_per_node_csr_ref(row_offsets, col, u, v, width: int, n_out: int) -> torch.Tensor:
    """The CSR per-node kernel's function: gather, per-node reduction, scatter."""
    a, b = _csr_panels(row_offsets, col, u, v, width)
    count, arm = intersect_per_node_ref(a, b)
    return panel_scatter_per_node(u, v, a, count, arm, n_out=n_out)


def intersect_support_csr_ref(row_offsets, col, u, v, edge_idx, width: int,
                              m_out: int) -> torch.Tensor:
    """The CSR support kernel's function: gather, support reduction, scatter."""
    a, b = _csr_panels(row_offsets, col, u, v, width)
    count, arm, closure = intersect_support_ref(a, b)
    return panel_scatter_support(edge_idx, u, v, row_offsets, count, arm, closure, m_out=m_out)
