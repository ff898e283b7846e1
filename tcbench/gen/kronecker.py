"""The Graph500 Kronecker (R-MAT) generator, rewritten in torch for one device.

The recipe is the Graph500 reference code's ``kronecker_generator``: ``M =
edge_factor * 2**scale`` edge slots; for each of the ``scale`` bits, a
uniform draw against ``A + B`` picks the source's bit, and a second draw
against ``C / (C + D)`` (source bit 1) or ``A / (A + B)`` (source bit 0)
picks the destination's; then one random permutation relabels the
vertices.  The reference also shuffles the edge list, which canonical
order undoes, so that draw is left out.

The benchmark's graphs are undirected and simple, as LDBC Graphalytics and
DIMACS10 ship them: self-loops and duplicates are removed, and with
``compact_ids`` the isolated vertices are dropped and the remaining ids
renumbered in order.  The result is the port's canonical edge array: each
undirected edge ``lo < hi`` once in ascending ``(lo, hi)`` order, then the
same block mirrored, as ``int32``.

A run hands the program the generated graph and further copies of it
under random relabellings of its ids (:func:`make_graphs`), so that no
job gets an input that an earlier job handed in: a relabelled copy has
the same triangles, and its per-vertex answers map back through the
relabelling.

The same seed on the same kind of device gives the same graphs; the CPU
and the card draw different streams.  Nothing here imports the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Graph", "seeded", "kronecker_slots", "canonical", "relabelled", "make_graph",
           "make_graphs"]


class Graph(NamedTuple):
    """One generated graph, as the benchmark hands it to the program."""

    edges: np.ndarray  # (2 |E|, 2) int32 canonical edge array on the host
    n_nodes: int       # ids run over 0 .. n_nodes - 1
    n_vertices: int    # vertices of degree >= 1: the |V| of EVPS
    n_edges: int       # undirected edges: the |E| of EVPS
    perm: np.ndarray | None = None  # a relabelled copy: generated vertex v is perm[v]


def seeded(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from any whole number."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def kronecker_slots(scale: int, edge_factor: int, initiator, gen: torch.Generator,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """The raw ``(src, dst)`` int64 edge slots of the Graph500 recipe."""
    a, b, c, d = (float(x) for x in initiator)
    if abs(a + b + c + d - 1.0) > 1e-9:
        raise ValueError(f"initiator {initiator} does not sum to 1")
    m = int(edge_factor) << int(scale)
    ab, c_norm, a_norm = a + b, c / (c + d), a / (a + b)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(int(scale)):
        src_bit = torch.rand(m, generator=gen, device=device, dtype=torch.float64) > ab
        threshold = torch.where(src_bit, c_norm, a_norm)
        dst_bit = torch.rand(m, generator=gen, device=device, dtype=torch.float64) > threshold
        src |= src_bit.to(torch.int64) << bit
        dst |= dst_bit.to(torch.int64) << bit
        del src_bit, dst_bit, threshold
    perm = torch.randperm(1 << int(scale), generator=gen, device=device)
    return perm[src], perm[dst]


def canonical(src: torch.Tensor, dst: torch.Tensor, n_nodes: int,
              compact_ids: bool) -> tuple[torch.Tensor, int, int, int]:
    """``(edges, n_nodes, n_vertices, n_edges)``: the simple undirected graph
    of the slots as a canonical int32 edge tensor on their device."""
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    key = torch.unique((lo << 32) | hi)  # sorted
    del lo, hi, keep
    lo, hi = key >> 32, key & 0xFFFFFFFF
    del key
    ids = torch.unique(torch.cat([lo, hi]))  # sorted endpoint ids
    n_vertices = int(ids.numel())
    if compact_ids:
        lo = torch.searchsorted(ids, lo)
        hi = torch.searchsorted(ids, hi)
        n_nodes = n_vertices
    n_edges = int(lo.numel())
    fwd = torch.stack([lo, hi], dim=1).to(torch.int32)
    return torch.cat([fwd, fwd.flip(1)]), int(n_nodes), n_vertices, n_edges


def relabelled(edges: torch.Tensor, n_nodes: int,
               gen: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """``(edges', perm)``: the canonical edge tensor ``edges`` with every id
    ``v`` renamed ``perm[v]`` by a random permutation, canonical again."""
    perm = torch.randperm(n_nodes, generator=gen, device=edges.device)
    m = edges.shape[0] // 2
    a, b = perm[edges[:m, 0].long()], perm[edges[:m, 1].long()]
    key = torch.sort((torch.minimum(a, b) << 32) | torch.maximum(a, b)).values
    del a, b
    fwd = torch.stack([key >> 32, key & 0xFFFFFFFF], dim=1).to(torch.int32)
    return torch.cat([fwd, fwd.flip(1)]), perm


def make_graphs(config: dict, seed: int, device, copies: int) -> list[Graph]:
    """The configuration's graph for ``seed``, made on ``device``, then
    ``copies - 1`` relabellings of it drawn from the same stream; each
    canonical edge array copied to the host once."""
    if config["generator"] != "graph500_kronecker":
        raise ValueError(f"unknown generator {config['generator']!r}")
    gen = seeded(seed, device)
    src, dst = kronecker_slots(config["scale"], config["edge_factor"], config["initiator"],
                               gen, device)
    edges, n_nodes, n_vertices, n_edges = canonical(
        src, dst, 1 << int(config["scale"]), bool(config["compact_ids"]))
    del src, dst
    graphs = [Graph(edges.cpu().numpy(), n_nodes, n_vertices, n_edges)]
    for _ in range(int(copies) - 1):
        other, perm = relabelled(edges, n_nodes, gen)
        graphs.append(Graph(other.cpu().numpy(), n_nodes, n_vertices, n_edges,
                            perm.cpu().numpy()))
        del other
    return graphs


def make_graph(config: dict, seed: int, device) -> Graph:
    """The configuration's graph for ``seed`` alone."""
    return make_graphs(config, seed, device, 1)[0]
