"""The card's published peaks and the bytes model of the intersections.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB of HBM3 at 3.35 TB/s),
at its full power limit of 700 W.  A card set below that limit runs
slower; the benchmark prints the card's limit beside every share.

Bytes model.  What one job's intersections need, whatever code carries
them out, each byte read or written once however often a kernel touches
it again: every out-neighbour list that an oriented edge intersects
(4 bytes an entry), both endpoints of every oriented edge (8 bytes), the
row offsets that bound those lists (4 bytes each distinct offset), and the
job's result (8 bytes a value).  It is worked out from the benchmark's own
orientation of the graph (:mod:`tcbench.reference`), never from the
program's plan.  Nothing here imports the program.
"""
from __future__ import annotations

import torch

__all__ = ["HBM_BYTES_PER_S", "HBM_BYTES", "intersect_bytes", "least_seconds"]

HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def intersect_bytes(row_offsets: torch.Tensor, src: torch.Tensor, col: torch.Tensor,
                    result_values: int) -> int:
    """Bytes one job's intersections need on the oriented CSR
    ``(row_offsets, src, col)``, with ``result_values`` values written."""
    out_deg = row_offsets[1:] - row_offsets[:-1]
    ends = torch.unique(torch.cat([src, col]))
    lists = 4 * int(out_deg[ends].sum())
    endpoints = 8 * int(src.numel())
    offsets = 4 * int(torch.unique(torch.cat([ends, ends + 1])).numel())
    return lists + endpoints + offsets + 8 * int(result_values)


def least_seconds(n_bytes: float) -> float:
    """Least time for ``n_bytes`` at the card's memory bandwidth."""
    return n_bytes / HBM_BYTES_PER_S
