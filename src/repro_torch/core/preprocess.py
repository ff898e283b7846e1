"""Forward-algorithm preprocessing (paper §II-B, §III-B) in PyTorch.

The same steps as the reference, on tensors of one device:

1.  degree histogram    — ``bincount`` over the source column,
2.  forward orientation — keep edge ``(u, v)`` iff ``(deg u, u) ≺ (deg v, v)``
                          lexicographically; exactly ``m/2`` edges survive,
3.  edge sort           — one sort of the packed 64-bit key
                          ``src << 32 | dst``, the paper's §III-D2 trick;
                          keys are unique, so the order is the reference's
                          lexsort order,
4.  node array          — ``searchsorted`` of row ids against the sorted
                          sources,
5.  unzip               — SoA layout (separate ``src``/``col``) throughout.

The host-side paths (cached undirected CSR, compressed CSR, host offload)
filter on the host exactly as the reference does and move the result to
the requested device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.compression import ensure_fits_int32

__all__ = [
    "OrientedCSR",
    "preprocess",
    "preprocess_host_offload",
    "oriented_from_undirected_csr",
    "oriented_from_compressed",
    "degrees",
]


class OrientedCSR(NamedTuple):
    """Forward-oriented graph in CSR (SoA) layout, every field on one device.

    ``row_offsets[u] : row_offsets[u+1]`` indexes the sorted out-neighbors
    of ``u`` inside ``col``; ``src`` is the repeated row index (the paper's
    "unzipped" edge array: ``(src[p], col[p])`` is directed edge ``p``).
    """

    row_offsets: torch.Tensor  # (n+1,) int32
    src: torch.Tensor          # (m_dir,) int32
    col: torch.Tensor          # (m_dir,) int32
    out_degree: torch.Tensor   # (n,)   int32
    degree: torch.Tensor       # (n,)   int32, undirected degrees

    @property
    def n_nodes(self) -> int:
        return self.row_offsets.shape[0] - 1

    @property
    def n_directed_edges(self) -> int:
        return self.col.shape[0]

    @property
    def device(self) -> torch.device:
        return self.col.device

    @classmethod
    def from_numpy(cls, row_offsets, src, col, out_degree, degree, *, device=None):
        """Build from host arrays (e.g. the reference's ``OrientedCSR`` fields)."""
        dev = resolve_device(device)
        return cls(*(
            torch.from_numpy(np.array(x, dtype=np.int32)).to(dev)
            for x in (row_offsets, src, col, out_degree, degree)
        ))


def degrees(edges: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Undirected degree histogram from a canonical edge tensor."""
    ensure_fits_int32(edges.shape[0], "canonical edge count (int32 degrees)")
    return torch.bincount(edges[:, 0], minlength=n_nodes).to(torch.int32)


def _sorted_csr(su: torch.Tensor, sv: torch.Tensor, deg: torch.Tensor, n_nodes: int):
    """Sort directed pairs by ``(src, dst)`` and build the CSR around them."""
    key = (su.to(torch.int64) << 32) | sv.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    src = su[order].contiguous()
    col = sv[order].contiguous()
    ids = torch.arange(n_nodes + 1, dtype=torch.int32, device=src.device)
    ensure_fits_int32(src.shape[0], "directed edge count (int32 row offsets)")
    row_offsets = torch.searchsorted(src, ids, out_int32=True)
    out_degree = row_offsets[1:] - row_offsets[:-1]
    return OrientedCSR(row_offsets, src, col, out_degree, deg)


def preprocess(edges, n_nodes: int, *, device=None) -> OrientedCSR:
    """Run the full preprocessing phase on ``device``.

    ``edges`` must be a canonical edge array (each undirected edge twice),
    so exactly ``m // 2`` edges survive orientation.
    """
    dev = resolve_device(device)
    edges = torch.as_tensor(np.asarray(edges) if not torch.is_tensor(edges) else edges)
    edges = edges.to(device=dev, dtype=torch.int32)
    m = edges.shape[0]
    if m % 2 != 0:
        raise ValueError("canonical edge array must have even length")
    ensure_fits_int32(m, "canonical edge count (CSR offsets)")
    u, v = edges[:, 0], edges[:, 1]
    deg = degrees(edges, n_nodes)
    du, dv = deg[u], deg[v]
    keep = (du < dv) | ((du == dv) & (u < v))
    idx = torch.nonzero(keep).squeeze(1)
    if idx.shape[0] != m // 2:
        raise ValueError(
            f"forward orientation kept {idx.shape[0]} of {m} rows, expected "
            f"{m // 2}: the edge array is not canonical (each undirected edge "
            "exactly twice, no self-loops)"
        )
    return _sorted_csr(u[idx], v[idx], deg, n_nodes)


def _host_oriented(row, src, col, deg, device) -> OrientedCSR:
    out_degree = row[1:] - row[:-1]
    return OrientedCSR.from_numpy(row, src, col, out_degree, deg, device=device)


def oriented_from_undirected_csr(row_offsets, col, n_nodes: int | None = None,
                                 *, device=None) -> OrientedCSR:
    """Forward-orient a canonical *undirected* CSR without re-sorting.

    The ingestion fast path: a cached ``.tricsr`` CSR is already sorted by
    (src, dst), and forward orientation is order-preserving, so the
    oriented CSR is one boolean filter on the host.  Output is
    bit-identical to ``preprocess(csr_to_edge_array(row_offsets, col))``.
    """
    row_offsets = np.asarray(row_offsets)
    col = np.asarray(col)
    ensure_fits_int32(col.shape[0], "undirected CSR edge slots (oriented offsets)")
    if n_nodes is None:
        n_nodes = row_offsets.shape[0] - 1
    deg = np.diff(row_offsets).astype(np.int32)
    u = np.repeat(np.arange(n_nodes, dtype=np.int32), deg)
    v = col.astype(np.int32, copy=False)
    du, dv = deg[u], deg[v]
    keep = (du < dv) | ((du == dv) & (u < v))
    src = u[keep]
    out_row = np.searchsorted(src, np.arange(n_nodes + 1, dtype=np.int32)).astype(
        np.int32
    )
    return _host_oriented(out_row, src, v[keep], deg, device)


def oriented_from_compressed(z, *, device=None) -> OrientedCSR:
    """Forward-orient a compressed CSR block-by-block, never decoding it all.

    ``z`` is duck-typed (``row_offsets`` / ``n_nodes`` / ``n_blocks`` /
    ``block_node_range`` / ``decode_block``, i.e. a
    :class:`repro_torch.graphs.io.CompressedCSR`).  Each neighbor block is
    decoded, filtered by the forward rule and the kept slices concatenated,
    bit-identical to ``oriented_from_undirected_csr`` of the full decode.
    """
    row = np.asarray(z.row_offsets, dtype=np.int64)
    n_nodes = int(z.n_nodes)
    ensure_fits_int32(int(row[-1]), "compressed CSR edge slots (oriented offsets)")
    deg = np.diff(row).astype(np.int32)
    src_parts, col_parts = [], []
    for k in range(z.n_blocks):
        lo, hi = z.block_node_range(k)
        v = np.asarray(z.decode_block(k), dtype=np.int32)
        u = np.repeat(np.arange(lo, hi, dtype=np.int32), np.diff(row[lo : hi + 1]))
        du, dv = deg[u], deg[v]
        keep = (du < dv) | ((du == dv) & (u < v))
        src_parts.append(u[keep])
        col_parts.append(v[keep])
    src = np.concatenate(src_parts) if src_parts else np.zeros(0, np.int32)
    out_col = np.concatenate(col_parts) if col_parts else np.zeros(0, np.int32)
    out_row = np.searchsorted(src, np.arange(n_nodes + 1, dtype=np.int32)).astype(
        np.int32
    )
    return _host_oriented(out_row, src, out_col, deg, device)


def preprocess_host_offload(edges, n_nodes: int | None = None, *, device=None) -> OrientedCSR:
    """Host-side degree + orientation, device-side sort (paper §III-D6).

    For graphs whose full (both-direction) edge array does not fit on the
    device, degrees and the backward-edge filter run on the CPU, halving
    what crosses to the card; the sort and node-array build run there.
    Identical output to :func:`preprocess`.  Accepts a canonical edge
    array, an undirected CSR or a compressed CSR, as the reference does.
    """
    if isinstance(edges, OrientedCSR):
        return edges  # already oriented — re-filtering would drop edges
    if hasattr(edges, "decode_block"):
        return oriented_from_compressed(edges, device=device)
    if hasattr(edges, "row_offsets") and hasattr(edges, "col"):
        return oriented_from_undirected_csr(
            edges.row_offsets, edges.col, getattr(edges, "n_nodes", None), device=device
        )
    dev = resolve_device(device)
    edges = np.asarray(edges)
    if n_nodes is None:
        n_nodes = int(edges.max()) + 1 if edges.size else 0
    deg = np.bincount(edges[:, 0], minlength=n_nodes).astype(np.int32)
    u, v = edges[:, 0], edges[:, 1]
    du, dv = deg[u], deg[v]
    keep = (du < dv) | ((du == dv) & (u < v))
    ensure_fits_int32(edges.shape[0], "canonical edge count (host-offload offsets)")
    directed = torch.from_numpy(edges[keep].astype(np.int32)).to(dev)
    return _sorted_csr(directed[:, 0], directed[:, 1], torch.from_numpy(deg).to(dev), n_nodes)
