"""Public wrappers for the triangle-intersection kernel family.

Same signatures as the reference's ``ops.py``.  A CUDA tensor goes to the
hand-written CUDA kernel (:mod:`.triangle_count`) or raises; a CPU tensor
goes to the plain version (:mod:`.ref`), and only a CPU tensor does.
``tiles=(rows_per_block, _)`` sets the CUDA kernel's rows (warps) per
block — the hook a tuner plugs into; results never depend on it.
"""
from __future__ import annotations

import torch

from . import ref
from .triangle_count import (
    intersect_count_csr_cuda,
    intersect_count_cuda,
    intersect_per_node_cuda,
    intersect_support_cuda,
)

__all__ = ["intersect_count", "intersect_count_csr", "intersect_per_node", "intersect_support"]


def _on_cpu(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True for CPU inputs; False for CUDA inputs; raises for anything else."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return True
    if a.is_cuda and b.is_cuda:
        return False
    raise ValueError(
        f"intersection kernels take two CUDA or two CPU tensors, got {a.device} and {b.device}"
    )


def intersect_count(a, b, a_len=None, b_len=None, tiles=None) -> torch.Tensor:
    """Per-row sorted-intersection sizes; lengths are implied by −1 padding."""
    del a_len, b_len  # panels are −1 padded; masks are implicit
    if _on_cpu(a, b):
        return ref.intersect_count_ref(a, b)
    return intersect_count_cuda(a, b, tiles=tiles)


def intersect_per_node(a, b, tiles=None):
    """(count, arm) per-row intersection with u-side match attribution."""
    if _on_cpu(a, b):
        return ref.intersect_per_node_ref(a, b)
    return intersect_per_node_cuda(a, b, tiles=tiles)


def intersect_support(a, b, tiles=None):
    """(count, arm, closure) — the full per-edge support attribution."""
    if _on_cpu(a, b):
        return ref.intersect_support_ref(a, b)
    return intersect_support_cuda(a, b, tiles=tiles)


def intersect_count_csr(row_offsets, col, u, v, width: int) -> torch.Tensor:
    """Per-row sizes of N⁺(u) ∩ N⁺(v) read from the CSR, each list cut to
    ``width`` entries (the panel gather and the count in one kernel)."""
    tensors = (row_offsets, col, u, v)
    if all(t.device.type == "cpu" for t in tensors):
        return ref.intersect_count_csr_ref(row_offsets, col, u, v, width)
    if all(t.is_cuda for t in tensors):
        return intersect_count_csr_cuda(row_offsets, col, u, v, width)
    raise ValueError("intersect_count_csr takes all CUDA or all CPU tensors, got "
                     + ", ".join(str(t.device) for t in tensors))
