"""Plain PyTorch reference: degrees, orientation, triangle counts and LCC.

Works out everything from the canonical edge array alone, on any device,
with torch operations only; it imports nothing of the program under test.

* Orientation: edge ``u -> v`` is kept when ``(deg u, u) < (deg v, v)``, so
  each triangle ``a < b < c`` (in that order) has the oriented edges
  ``a -> b``, ``a -> c`` and ``b -> c``.
* Counting: for each oriented edge ``(u, v)``, every entry ``w`` of the
  shorter of the two out-lists is looked up, as the pair ``(other, w)``,
  among the sorted oriented edge keys.  A hit is a triangle, and each
  triangle is hit exactly once, at its edge ``a -> b`` with ``w = c``.
  The hit adds one to ``u``, ``v`` and ``w``.
* LCC (LDBC Graphalytics, undirected): the number of ordered pairs of
  neighbours of ``v`` that are adjacent, ``2 T(v)``, over ``d(v) (d(v) - 1)``;
  0 where ``d(v) < 2``.

``dtype`` sets the type the counts accumulate in and the LCC is computed
in: ``int64`` (then float64 for the LCC) is exact.  A floating ``dtype``
gives the precision control that the benchmark's comparison must reject.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Oriented", "orient", "triangles", "lcc", "DEFAULT_BUDGET"]

# lookups per block: about 6 GB of int64 temporaries at 2**27
DEFAULT_BUDGET = 1 << 27


class Oriented(NamedTuple):
    """The forward-oriented graph; every field int64 on one device."""

    degree: torch.Tensor       # (n,) undirected degrees
    row_offsets: torch.Tensor  # (n + 1,)
    src: torch.Tensor          # (m/2,) sorted by (src, col)
    col: torch.Tensor          # (m/2,)
    key: torch.Tensor          # (m/2,) src << 32 | col, sorted

    @property
    def out_degree(self) -> torch.Tensor:
        return self.row_offsets[1:] - self.row_offsets[:-1]


def orient(edges: torch.Tensor, n_nodes: int) -> Oriented:
    """Degrees and the oriented CSR of a canonical ``(m, 2)`` edge tensor."""
    u = edges[:, 0].to(torch.int64)
    v = edges[:, 1].to(torch.int64)
    degree = torch.bincount(u, minlength=n_nodes)
    du, dv = degree[u], degree[v]
    keep = (du < dv) | ((du == dv) & (u < v))
    key = torch.sort((u[keep] << 32) | v[keep]).values
    del u, v, du, dv, keep
    src, col = key >> 32, key & 0xFFFFFFFF
    ids = torch.arange(n_nodes + 1, dtype=torch.int64, device=edges.device)
    row_offsets = torch.searchsorted(src, ids)
    return Oriented(degree, row_offsets, src, col, key)


def _blocks(work: torch.Tensor, budget: int):
    """``[start, end)`` runs of edges whose work sums to about ``budget``."""
    cum = torch.cumsum(work, 0)
    m = int(work.numel())
    start = 0
    while start < m:
        base = int(cum[start - 1]) if start else 0
        end = int(torch.searchsorted(cum, torch.tensor(base + budget, device=cum.device),
                                     right=True))
        end = max(end, start + 1)
        yield start, end
        start = end


def triangles(g: Oriented, *, per_node: bool = True, dtype=torch.int64,
              budget: int = DEFAULT_BUDGET):
    """``(total, counts)``: the global count, and each vertex's triangles
    (``None`` unless ``per_node``), accumulated in ``dtype``."""
    n = int(g.degree.numel())
    m = int(g.key.numel())
    dev = g.key.device
    out_deg = g.out_degree
    du, dv = out_deg[g.src], out_deg[g.col]
    u_short = du <= dv
    short = torch.where(u_short, g.src, g.col)
    other = torch.where(u_short, g.col, g.src)
    work = torch.minimum(du, dv)
    del du, dv, u_short
    total = torch.zeros((), dtype=dtype, device=dev)
    counts = torch.zeros(n, dtype=dtype, device=dev) if per_node else None
    for start, end in _blocks(work, budget):
        w_blk = work[start:end]
        size = int(w_blk.sum())
        if size == 0:
            continue
        local = torch.repeat_interleave(torch.arange(end - start, device=dev), w_blk,
                                        output_size=size)
        first = torch.cumsum(w_blk, 0) - w_blk
        slot = torch.arange(size, device=dev) - first[local]
        edge = local + start
        w = g.col[g.row_offsets[short[edge]] + slot]
        query = (other[edge] << 32) | w
        pos = torch.searchsorted(g.key, query).clamp_(max=m - 1)
        hit = g.key[pos] == query
        total = total + hit.sum().to(dtype)
        if per_node:
            e_hit = edge[hit]
            for ends in (g.src[e_hit], g.col[e_hit], w[hit]):
                counts += torch.bincount(ends, minlength=n).to(dtype)
    return total, counts


def lcc(counts: torch.Tensor, degree: torch.Tensor) -> torch.Tensor:
    """Graphalytics LCC from per-vertex triangles and degrees: float64 for
    integer counts, the counts' own type for floating ones."""
    ftype = counts.dtype if counts.dtype.is_floating_point else torch.float64
    d = degree.to(ftype)
    pairs = d * (d - 1)
    linked = 2 * counts.to(ftype)
    return torch.where(degree > 1, linked / torch.where(degree > 1, pairs, 1), 0)
