"""Layer-wise uniform neighbor sampling (GraphSAGE ``minibatch_lg`` shape).

The counterpart of ``repro.graphs.sampling``.  Sampling is *with
replacement* so every shape is static: a seed batch of ``B`` nodes with
fanouts ``(f₁, f₂, …)`` produces frontiers of ``B``, ``B·f₁``,
``B·f₁·f₂``, … nodes.  Zero-degree nodes fall back to a self-loop so
aggregation stays well-defined.

The sampler consumes the same CSR arrays the triangle-counting core builds
— one graph representation feeds both the analytics and the training stack.
The uniforms come from a ``torch.Generator`` (the reference takes a key);
:func:`_blocks_from_uniforms` is the sampler given its uniforms, which
gives the reference's frontiers bit for bit from the reference's uniforms.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

__all__ = ["SampledBlocks", "sample_blocks"]


class SampledBlocks(NamedTuple):
    """Frontier node ids per layer, innermost (deepest) last.

    ``frontiers[0]`` is the seed batch ``(B,)``; ``frontiers[l]`` has shape
    ``(B · Πᵢ<ₗ fᵢ,)``.  Layer ``l`` aggregation reduces ``frontiers[l+1]``
    (reshaped ``(-1, f_l)``) into ``frontiers[l]``.
    """

    frontiers: tuple[torch.Tensor, ...]


def sample_blocks(
    generator: torch.Generator,
    row_offsets: torch.Tensor,
    col: torch.Tensor,
    seeds: torch.Tensor,
    fanouts: Sequence[int],
) -> SampledBlocks:
    """Sample a layered block subgraph rooted at ``seeds``: one f32 uniform
    per sampled child, drawn layer by layer from ``generator`` on the
    CSR's device."""
    uniforms, rows = [], seeds.shape[0]
    for fanout in fanouts:
        uniforms.append(torch.rand((rows, fanout), generator=generator,
                                   dtype=torch.float32, device=row_offsets.device))
        rows *= fanout
    return _blocks_from_uniforms(row_offsets, col, seeds, fanouts, uniforms)


def _blocks_from_uniforms(row_offsets, col, seeds, fanouts, uniforms) -> SampledBlocks:
    """The frontiers given layer ``l``'s uniforms ``(|frontier l|, f_l)``.
    The pick is ``(u · max(deg, 1))`` in f32 truncated to int32 (JAX
    promotes int32 × f32 to f32), the index clipped to the last column."""
    frontiers = [seeds.to(torch.int32)]
    cur = frontiers[0]
    last = col.shape[0] - 1
    for u, fanout in zip(uniforms, fanouts):
        start = row_offsets.index_select(0, cur).to(torch.int32)
        deg = row_offsets.index_select(0, cur + 1).to(torch.int32) - start
        pick = (u * deg.clamp_min(1).to(torch.float32)[:, None]).to(torch.int32)
        idx = torch.clamp(start[:, None] + pick, 0, last)
        nbrs = col.index_select(0, idx.reshape(-1)).reshape(idx.shape).to(torch.int32)
        # zero-degree fallback: self-loop
        nbrs = torch.where(deg[:, None] > 0, nbrs, cur[:, None])
        cur = nbrs.reshape(-1)
        frontiers.append(cur)
    return SampledBlocks(frontiers=tuple(frontiers))
