"""Plain PyTorch versions of the panel intersection kernel family.

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

__all__ = ["intersect_count_ref", "intersect_per_node_ref", "intersect_support_ref"]

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
