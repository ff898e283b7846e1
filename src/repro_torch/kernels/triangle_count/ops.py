"""Public wrappers for the triangle-intersection kernel family.

Same signatures as the reference's ``ops.py``.  A CUDA tensor goes to the
hand-written CUDA kernel (:mod:`.triangle_count`) or raises; a CPU tensor
goes to the plain version (:mod:`.ref`), and only a CPU tensor does.
``tiles=(rows_per_block, _)`` sets the panel kernel's rows (warps) per
block, and ``tiles=(rows_per_block, lanes)`` the CSR kernel's rows per
block and lanes per row — the hook :mod:`repro_torch.core.tuning` plugs
into.  Results never depend on it, and the plain versions ignore it.  On
CPU tensors each entry records the launch signature its kernel would (the
CUDA wrappers record their own), so
:class:`repro_torch.check.runtime.CompileAuditor` reads one registry on
either device.
"""
from __future__ import annotations

import torch

from . import ref
from .triangle_count import (
    intersect_count_csr_cuda,
    intersect_count_cuda,
    intersect_per_node_csr_cuda,
    intersect_per_node_cuda,
    intersect_support_csr_cuda,
    intersect_support_cuda,
    record_csr_launch,
    record_panel_launch,
)

__all__ = ["intersect_count", "intersect_count_csr", "intersect_per_node", "intersect_per_node_csr",
           "intersect_support", "intersect_support_csr"]


def _on_cpu(name: str, *tensors) -> bool:
    """True for all-CPU inputs; False for all-CUDA inputs; raises for anything else."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if all(t.is_cuda for t in tensors):
        return False
    raise ValueError(f"{name} takes all CUDA or all CPU tensors, got "
                     + ", ".join(str(t.device) for t in tensors))


def intersect_count(a, b, a_len=None, b_len=None, tiles=None) -> torch.Tensor:
    """Per-row sorted-intersection sizes; lengths are implied by −1 padding."""
    del a_len, b_len  # panels are −1 padded; masks are implicit
    if _on_cpu("intersect_count", a, b):
        record_panel_launch("intersect_count", a, b, tiles)
        return ref.intersect_count_ref(a, b)
    return intersect_count_cuda(a, b, tiles=tiles)


def intersect_per_node(a, b, tiles=None):
    """(count, arm) per-row intersection with u-side match attribution."""
    if _on_cpu("intersect_per_node", a, b):
        record_panel_launch("intersect_per_node", a, b, tiles)
        return ref.intersect_per_node_ref(a, b)
    return intersect_per_node_cuda(a, b, tiles=tiles)


def intersect_support(a, b, tiles=None):
    """(count, arm, closure) — the full per-edge support attribution."""
    if _on_cpu("intersect_support", a, b):
        record_panel_launch("intersect_support", a, b, tiles)
        return ref.intersect_support_ref(a, b)
    return intersect_support_cuda(a, b, tiles=tiles)


def intersect_count_csr(row_offsets, col, u, v, width: int, tiles=None) -> torch.Tensor:
    """Per-row sizes of N⁺(u) ∩ N⁺(v) read from the CSR, each list cut to
    ``width`` entries (the panel gather and the count in one kernel)."""
    if _on_cpu("intersect_count_csr", row_offsets, col, u, v):
        record_csr_launch("intersect_count_csr", row_offsets, col, u, v, None, width,
                          u.shape[0], tiles)
        return ref.intersect_count_csr_ref(row_offsets, col, u, v, width)
    return intersect_count_csr_cuda(row_offsets, col, u, v, width, tiles=tiles)


def intersect_per_node_csr(row_offsets, col, u, v, width: int, n_out: int,
                           tiles=None) -> torch.Tensor:
    """(n_out,) int32 per-vertex triangle incidences of the rows, read from
    the CSR (the gather, the per-node kernel and its scatter in one)."""
    if _on_cpu("intersect_per_node_csr", row_offsets, col, u, v):
        record_csr_launch("intersect_per_node_csr", row_offsets, col, u, v, None, width,
                          n_out, tiles)
        return ref.intersect_per_node_csr_ref(row_offsets, col, u, v, width, n_out)
    return intersect_per_node_csr_cuda(row_offsets, col, u, v, width, n_out, tiles=tiles)


def intersect_support_csr(row_offsets, col, u, v, edge_idx, width: int,
                          m_out: int, tiles=None) -> torch.Tensor:
    """(m_out,) int32 per-directed-edge support of the rows, read from the
    CSR (the gather, the support kernel and its scatter in one)."""
    if _on_cpu("intersect_support_csr", row_offsets, col, u, v, edge_idx):
        record_csr_launch("intersect_support_csr", row_offsets, col, u, v, edge_idx, width,
                          m_out, tiles)
        return ref.intersect_support_csr_ref(row_offsets, col, u, v, edge_idx, width, m_out)
    return intersect_support_csr_cuda(row_offsets, col, u, v, edge_idx, width, m_out,
                                      tiles=tiles)
