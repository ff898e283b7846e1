"""EmbeddingBag and sparse-table utilities for the recsys stack.

The counterpart of ``repro.models.recsys.embedding``: the bag reduce is a
row gather (``index_select``) and a segment reduce (``index_add`` for sum
and mean, ``scatter_reduce(amax)`` for max), with the reference's rules for
−1 ids (zero rows, left out of the mean's count) and for empty bags (0).
The gather's backward is an ``index_add`` into the table: atomic on the
card, so a skewed id stream's row sums reorder from run to run there.
"""
from __future__ import annotations

import torch

from repro_torch.models.gnn.common import segment_max, segment_sum

__all__ = ["embedding_lookup", "embedding_bag", "hash_bucket"]

_U32 = 0xFFFFFFFF


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain row gather; −1 ids return zero rows (padding)."""
    rows = table.index_select(0, ids.clamp_min(0).reshape(-1)).reshape(*ids.shape, table.shape[1])
    return torch.where((ids >= 0)[..., None], rows, torch.zeros_like(rows))


def embedding_bag(
    table: torch.Tensor,      # (V, d)
    ids: torch.Tensor,        # (n_indices,) flat multi-hot indices, −1 padded
    segments: torch.Tensor,   # (n_indices,) bag id per index
    n_bags: int,
    mode: str = "sum",
) -> torch.Tensor:
    """torch.nn.EmbeddingBag equivalent: ragged gather + segment reduce."""
    rows = embedding_lookup(table, ids)
    if mode == "sum":
        return segment_sum(rows, segments, n_bags)
    if mode == "mean":
        s = segment_sum(rows, segments, n_bags)
        cnt = segment_sum((ids >= 0).to(table.dtype), segments, n_bags)
        return s / torch.clamp_min(cnt, 1.0)[:, None]
    if mode == "max":
        neg = torch.where((ids >= 0)[..., None], rows, torch.full_like(rows, -1e30))
        out = segment_max(neg, segments, n_bags)
        return torch.where(out > -1e29, out, torch.zeros_like(out))
    raise ValueError(f"unknown mode {mode!r}")


def u32_mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x · c) mod 2³²`` for int64 ``x`` in [0, 2³²): the reference's
    uint32 product, in halves of ``c`` so no int64 product overflows."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((x * hi) & 0xFFFF) << 16) + x * lo) & _U32


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(uint32)`` as int64 in [0, 2³²): negative ids wrap."""
    return x.to(torch.int64) & _U32


def hash_bucket(raw_ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Multiplicative hashing for open-vocabulary ids (QR-trick companion):
    the reference's uint32 arithmetic, bit for bit."""
    return (u32_mul(as_u32(raw_ids), 2654435761) % n_buckets).to(torch.int32)
