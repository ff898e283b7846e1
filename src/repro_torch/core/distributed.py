"""Distributed triangle counting (paper §III-E), single-controller.

The PyTorch counterpart of ``repro.core.distributed``.  The paper's
multi-GPU scheme: preprocess once, replicate the CSR arrays to every
device, partition the *edge list*, reduce partial counts.  The reference
runs it under ``shard_map`` from one process; the port keeps that model
with a :class:`repro_torch.distributed.Mesh` of torch devices:

* the oriented CSR (``row_offsets``, ``col``, ``out_degree``) is
  replicated once to every distinct device of the mesh,
* the directed edge list is **striped round-robin** over the mesh's
  stripes (edge ``i`` on stripe ``i mod S``, the paper's §III-C
  thread-striping lifted to devices),
* each stripe expands its edges into wedge candidates and closes them
  with the batched binary search of :mod:`repro_torch.core.count`, in
  torch ops on the stripe's device (the reference's ``shard_body``),
* the partials meet on the mesh's lead device: the reference's ``psum``
  is a sum of the stripes' vectors there, its ``all_gather`` a stack of
  them (delta-compressed for the support merge).

A mesh may name one device several times; the stripes on it then run one
after another, each stripe's temporaries released before the next one's
launch.  The reference's stripe kernels are XLA, not Pallas, so these are
torch ops as the wedge schedule is.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.check.runtime import records_launches
from repro_torch.distributed.compression import (
    compressed_all_gather_int32,
    ensure_fits_int32,
)
from repro_torch.distributed.mesh import Mesh

from .count import _expand_close_body, segmented_int32_sum
from .preprocess import OrientedCSR, preprocess

__all__ = [
    "stripe_edges",
    "plan_striped_chunks",
    "make_distributed_count_fn",
    "make_distributed_panel_count_fn",
    "striped_workload_fn",
    "count_triangles_distributed",
    "count_triangles_distributed_csr",
    "count_triangles_distributed_slabs",
    "count_triangles_distributed_panel",
    "oriented_csr_from_slabs",
]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stripe_arrays(src, dst, out_deg, n_shards: int, shorter_side: bool = False,
                  min_cols: int = 0):
    """The round-robin striping rule, on host arrays.

    Edge ``i`` goes to stripe ``i mod S`` (−1 padded to at least
    ``min_cols`` columns).  Returns ``(src_sh, dst_sh, loads)``: the
    ``(S, e_per)`` int32 stripes and each stripe's wedge load (int64,
    ``min(deg⁺(u), deg⁺(v))`` per edge with ``shorter_side``).
    """
    src = _np(src).astype(np.int32, copy=False)
    dst = _np(dst).astype(np.int32, copy=False)
    out_deg = _np(out_deg)
    m = src.shape[0]
    e_per = max(min_cols, -(-m // n_shards))
    pad = e_per * n_shards - m
    src_p = np.concatenate([src, np.full(pad, -1, np.int32)])
    dst_p = np.concatenate([dst, np.full(pad, -1, np.int32)])
    # reshape(e_per, S).T puts edge i on shard i % S — round-robin striping
    src_sh = np.ascontiguousarray(src_p.reshape(e_per, n_shards).T)
    dst_sh = np.ascontiguousarray(dst_p.reshape(e_per, n_shards).T)
    reps = np.where(src_p >= 0, out_deg[np.maximum(src_p, 0)], 0).astype(np.int64)
    if shorter_side:
        reps_v = np.where(dst_p >= 0, out_deg[np.maximum(dst_p, 0)], 0).astype(np.int64)
        reps = np.minimum(reps, reps_v)
    return src_sh, dst_sh, reps.reshape(e_per, n_shards).sum(axis=0)


def stripe_edges(csr: OrientedCSR, n_shards: int, shorter_side: bool = False):
    """Round-robin stripe directed edges into ``(n_shards, e_per_shard)``.

    Shard ``s`` receives directed edges ``s, s + S, s + 2S, …`` (−1 padded),
    mirroring the paper's thread-striping.  Returns host arrays
    ``(src_sh, dst_sh, wedges_per_shard_max)``.

    ``shorter_side`` sizes the wedge buffer for the §Perf variant that
    enumerates candidates from the *smaller* endpoint list.
    """
    src_sh, dst_sh, loads = stripe_arrays(
        csr.src, csr.col, csr.out_degree, n_shards, shorter_side=shorter_side
    )
    return src_sh, dst_sh, int(loads.max()) if src_sh.shape[1] else 1


def plan_striped_chunks(
    src_sh: np.ndarray,
    out_deg: np.ndarray,
    budget: int | None,
    dst_sh: np.ndarray | None = None,
):
    """Partition the striped per-shard edge axis under a wedge budget.

    ``src_sh`` is the ``(n_shards, e_per)`` striped source array from
    :func:`stripe_edges` (−1 padded).  Returns ``(bounds, eff)`` where
    each column slice ``[start, end)`` in ``bounds`` keeps *every*
    shard's wedge-buffer requirement ≤ ``eff``, and
    ``eff = max(budget, max single-edge fan-out)`` (a chunk must hold at
    least one whole edge per shard).  With ``budget=None`` the whole axis
    is one chunk sized to the worst shard — the unchunked behavior.

    Pass ``dst_sh`` for the shorter-side variant: fan-outs are then
    ``min(deg⁺(u), deg⁺(v))``, matching what the kernel enumerates, so
    the budget is not over-reserved from the src side alone.
    """
    out_deg = _np(out_deg)
    reps = np.where(src_sh >= 0, out_deg[np.maximum(src_sh, 0)], 0).astype(np.int64)
    if dst_sh is not None:
        reps_v = np.where(dst_sh >= 0, out_deg[np.maximum(dst_sh, 0)], 0).astype(np.int64)
        reps = np.minimum(reps, reps_v)
    e_per = src_sh.shape[1]
    per_shard_total = reps.sum(axis=1)
    if e_per == 0:
        return [(0, 0)], 1
    if budget is None or budget >= int(per_shard_total.max()):
        return [(0, e_per)], max(int(per_shard_total.max()), 1)
    eff = max(int(budget), int(reps.max()), 1)
    cum = np.cumsum(reps, axis=1)  # (S, e_per) per-shard running wedge load
    bounds = []
    start = 0
    while start < e_per:
        base = cum[:, start - 1] if start else np.zeros(cum.shape[0], np.int64)
        # furthest end each shard tolerates; the chunk ends at the minimum
        ends = np.array(
            [np.searchsorted(cum[s], base[s] + eff, side="right") for s in range(cum.shape[0])]
        )
        end = max(int(ends.min()), start + 1)
        bounds.append((start, end))
        start = end
    return bounds, eff


def iter_striped_chunks(src_sh: np.ndarray, dst_sh: np.ndarray, bounds, cols_per_chunk: int):
    """Yield ``(start, src, dst)`` for each column slice of ``bounds``,
    −1 padded to ``cols_per_chunk`` columns so every chunk has one shape."""
    n_shards = src_sh.shape[0]
    for start, end in bounds:
        pad = cols_per_chunk - (end - start)
        s = src_sh[:, start:end]
        d = dst_sh[:, start:end]
        if pad:
            fill = np.full((n_shards, pad), -1, np.int32)
            s = np.concatenate([s, fill], axis=1)
            d = np.concatenate([d, fill], axis=1)
        yield start, np.ascontiguousarray(s), np.ascontiguousarray(d)


# ---------------------------------------------------------------------------
# the stripe body and the merges
# ---------------------------------------------------------------------------


def _on(x, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``: a ``{device: tensor}`` replica map is looked up,
    a tensor is moved (a no-op where it lies), a host array uploaded."""
    if isinstance(x, dict):
        return x[dev]
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)


def _add_in_range(out: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """``out[idx] += val`` where ``0 <= idx < len(out)``; other ids are dropped.

    The reference's ``.at[idx].add(val, mode="drop")``: ``index_add_``
    refuses (CPU) or corrupts memory (card) at ids out of range, so each
    such id is sent to slot 0 with a value of 0.
    """
    keep = (idx >= 0) & (idx < out.shape[0])
    out.index_add_(0, torch.where(keep, idx, 0), torch.where(keep, val, 0))


@records_launches(static=("kind", "wedge_budget", "n_steps", "n_out", "shorter_side"))
def _stripe_body(kind, src_e, dst_e, row, col, deg, wedge_budget, n_steps, n_out,
                 shorter_side):
    """One stripe's share of a chunk, on the device its tensors lie on.

    ``count``: the segmented int32 partials; ``per_node``: the stripe's
    ``(n_out,)`` int32 incidences; ``support``: ``(ac, base)``, the arm and
    closure hits on global ``col`` ids and the base hits per local column.
    """
    hit, edge_id, u, v, w, w_idx, vw_idx = _expand_close_body(
        src_e, dst_e, row, col, deg, wedge_budget, n_steps, shorter_side=shorter_side
    )
    if kind == "count":
        return segmented_int32_sum(hit)
    inc = hit.to(torch.int32)
    if kind == "per_node":
        # w may read a padded or sentinel col slot on lanes that are no hit
        out = torch.zeros((n_out,), dtype=torch.int32, device=col.device)
        for idx in (u, v, w):
            _add_in_range(out, idx, inc)  # trilint: ok[overflow] stripe chunk partial
        return out
    ac = torch.zeros((n_out,), dtype=torch.int32, device=col.device)
    _add_in_range(ac, w_idx, inc)  # trilint: ok[overflow] stripe chunk partial
    _add_in_range(ac, vw_idx, inc)  # trilint: ok[overflow] stripe chunk partial
    base = torch.zeros((src_e.shape[0],), dtype=torch.int32, device=col.device)
    _add_in_range(base, edge_id.to(torch.int64), inc)  # trilint: ok[overflow] stripe chunk partial
    return ac, base


def striped_workload_fn(
    mesh: Mesh,
    kind: str,
    wedge_budget: int,
    n_search_steps: int,
    n_out: int = 0,
    shorter_side: bool = False,
    narrow_wire: bool = False,
):
    """The striped chunk function for one workload kind.

    The §III-E scheme generalized beyond the scalar count: every stripe
    expands and closes wedges for its round-robin edge stripe on its own
    device, then the partials merge on ``mesh.lead`` by what each workload
    needs —

    ``"count"``
        per-stripe segmented int32 partials, stacked ``(S, n_seg)``, no
        collective (the host reduces in uint64);
    ``"per_node"``
        each stripe scatters its hits to the triangle's three vertices in
        a local ``(n_out,)`` array, and the stripes' arrays are summed;
    ``"support"``
        two merges.  Arm ``(u, w)`` and closure ``(v, w)`` hits land on
        *global* directed-edge (``col``) ids, so they sum like per-node.
        The base ``(u, v)`` hit belongs to the stripe's own edges: each
        stripe reduces it per local column, the ``(cols,)`` vectors ride
        :func:`repro_torch.distributed.compression.compressed_all_gather_int32`
        (a uint16 wire when ``narrow_wire``), and the ``(S, cols)`` block
        scatters onto the global edge ids ``(chunk_start + c)·S + s`` — the
        inverse of the round-robin striping.

    Returns ``f(src_sh, dst_sh, chunk_start, row_offsets, col, out_degree)``
    with ``src_sh``/``dst_sh`` the −1-padded ``(S, cols)`` striped chunk
    (host arrays or tensors), ``chunk_start`` its first column, and each
    CSR array a tensor or a :meth:`Mesh.replicate` map.  Results are
    bit-identical to the single-device wedge kernels: the same wedge
    enumeration and closure, and integer sums are order-free.  Nothing is
    compiled, so unlike the reference's this function is not cached.
    """
    if kind not in ("count", "per_node", "support"):
        raise ValueError(f"unknown striped workload kind {kind!r}")
    n_shards = int(np.prod(mesh.devices.shape))
    lead = mesh.lead

    def f(src_sh, dst_sh, chunk_start, row_offsets, col, out_degree):
        if src_sh.shape[0] != n_shards:
            raise ValueError(f"{src_sh.shape[0]} stripe rows for a mesh of {n_shards}")
        cols = src_sh.shape[1]
        partials, bases = [], []
        acc = None
        for s, dev in enumerate(mesh.devices.flat):
            part = _stripe_body(
                kind, _on(src_sh[s], dev), _on(dst_sh[s], dev),
                _on(row_offsets, dev), _on(col, dev), _on(out_degree, dev),
                wedge_budget, n_search_steps, n_out, shorter_side,
            )
            if kind == "count":
                partials.append(part.to(lead))
                continue
            if kind == "support":
                part, base = part
                bases.append(base)
            part = part.to(lead)
            acc = part if acc is None else acc.add_(part)
        if kind == "count":
            return torch.stack(partials)
        if kind == "per_node":
            return acc
        base_all = compressed_all_gather_int32(bases, mesh, narrow=narrow_wire)
        c = torch.arange(cols, dtype=torch.int64, device=lead)
        s = torch.arange(n_shards, dtype=torch.int64, device=lead)
        gid = (int(chunk_start) + c)[None, :] * n_shards + s[:, None]
        # the padded tail's ids run past n_out with a zero base: dropped
        _add_in_range(acc, gid.reshape(-1), base_all.reshape(-1))
        return acc

    return f


def make_distributed_count_fn(
    mesh: Mesh,
    wedge_budget: int,
    n_search_steps: int,
    axis_names: Sequence[str] | None = None,
    shorter_side: bool = False,
):
    """The striped counting step.

    ``wedge_budget`` is the per-stripe wedge-buffer length, computed by
    :func:`stripe_edges`; ``n_search_steps`` bounds the binary search.
    Returns ``f(src_sh, dst_sh, row_offsets, col, out_degree) -> (n_shards,
    n_segments)`` int32 partials on ``mesh.lead``, each covering one
    2²⁰-slot segment of a stripe's wedge buffer, so int32 stays safe;
    callers reduce in uint64 on the host.  ``axis_names`` is accepted for
    the reference's signature: the stripes are always every device of the
    mesh.

    ``shorter_side`` (§Perf): enumerate wedge candidates from the *smaller*
    of N⁺(u), N⁺(v) and binary-search the larger — the count is identical
    while the probe count drops from Σ deg⁺(u) to Σ min(deg⁺(u), deg⁺(v)).
    """
    f = striped_workload_fn(mesh, "count", wedge_budget, n_search_steps,
                            shorter_side=shorter_side)

    def count_fn(src_sh, dst_sh, row_offsets, col, out_degree):
        return f(src_sh, dst_sh, 0, row_offsets, col, out_degree)

    return count_fn


def make_distributed_panel_count_fn(
    mesh: Mesh,
    edges_per_shard_by_width: dict[int, int],
    axis_names: Sequence[str] | None = None,
):
    """§Perf: the distributed *panel* schedule, in torch ops.

    Each edge gathers both endpoint neighbor panels once and closes the
    intersection with an equality-tile reduction.  Edges are bucketed by
    panel width.  Returns ``(fn, widths)``: ``fn`` takes the per-width
    striped ``(n_shards, e_w)`` src arrays, then the dst arrays, then the
    CSR (tensors or :meth:`Mesh.replicate` maps), and returns the
    ``(n_shards,)`` int64 per-stripe counts on ``mesh.lead``: each row's
    count is an int32 partial (at most its width), and a stripe's total,
    which no chunking bounds, is summed in int64.
    """
    widths = sorted(edges_per_shard_by_width)
    lead = mesh.lead

    def stripe(dev, srcs, dsts, row, col, deg):
        total = torch.zeros((), dtype=torch.int64, device=dev)
        last = col.shape[0] - 1
        for width, src_e, dst_e in zip(widths, srcs, dsts):
            valid_e = src_e >= 0
            u = src_e.clamp(min=0)
            v = dst_e.clamp(min=0)
            lane = torch.arange(width, dtype=torch.int32, device=dev)

            def panel(base, length):
                vals = col[(base[:, None] + lane[None, :]).clamp(0, last)]
                return torch.where(lane[None, :] < length[:, None], vals, -1)

            a = panel(row[u], deg[u])
            b = panel(row[v], deg[v])
            eq = (a[:, :, None] == b[:, None, :]) & (a[:, :, None] >= 0)
            # trilint: ok[overflow] a row's partial: at most its width
            counts = eq.sum(dim=(1, 2), dtype=torch.int32)
            total = total + torch.where(valid_e, counts, 0).sum(dtype=torch.int64)
        return total

    def fn(*args):
        n_w = len(widths)
        srcs, dsts = args[:n_w], args[n_w: 2 * n_w]
        row, col, deg = args[2 * n_w:]
        out = []
        for s, dev in enumerate(mesh.devices.flat):
            out.append(stripe(
                dev, [_on(a[s], dev) for a in srcs], [_on(a[s], dev) for a in dsts],
                _on(row, dev), _on(col, dev), _on(deg, dev),
            ).to(lead))
        return torch.stack(out)

    return fn, widths


def count_triangles_distributed_csr(
    csr: OrientedCSR,
    mesh: Mesh,
    shorter_side: bool = False,
    max_wedge_chunk: int | None = None,
    stats_out: dict | None = None,
) -> int:
    """Striped count from a prebuilt CSR (stripe → chunk → striped count).

    ``max_wedge_chunk`` bounds every stripe's wedge buffer: the striped
    edge axis is sliced into column chunks (:func:`plan_striped_chunks`),
    each padded to one width.  Partial counts accumulate on the host in
    uint64.
    """
    n_shards = int(np.prod(mesh.devices.shape))
    src_sh, dst_sh, _ = stripe_edges(csr, n_shards, shorter_side=shorter_side)
    out_deg = _np(csr.out_degree)
    max_deg = int(out_deg.max()) if csr.n_nodes else 0
    steps = max(1, int(np.ceil(np.log2(max_deg + 1)))) if max_deg else 1
    bounds, eff = plan_striped_chunks(
        src_sh, out_deg, max_wedge_chunk, dst_sh=dst_sh if shorter_side else None,
    )
    cols_per_chunk = max(end - start for start, end in bounds)
    count_fn = make_distributed_count_fn(mesh, eff, steps, shorter_side=shorter_side)
    csr_dev = tuple(mesh.replicate(a) for a in (csr.row_offsets, csr.col, csr.out_degree))
    total = np.uint64(0)
    for _, s, d in iter_striped_chunks(src_sh, dst_sh, bounds, cols_per_chunk):
        partials = count_fn(s, d, *csr_dev)
        total += np.uint64(_np(partials).astype(np.uint64).sum())
    if stats_out is not None:
        stats_out["n_chunks"] = len(bounds)
        stats_out["peak_wedge_buffer"] = eff
        stats_out["cols_per_chunk"] = cols_per_chunk
    return int(total)


def count_triangles_distributed(
    edges,
    mesh: Mesh,
    n_nodes: int | None = None,
    shorter_side: bool = False,
    max_wedge_chunk: int | None = None,
) -> int:
    """End-to-end striped count (preprocess on ``mesh.lead`` → stripe → count)."""
    edges = _np(edges)
    if edges.size == 0:
        return 0
    if n_nodes is None:
        n_nodes = int(edges.max()) + 1
    csr = preprocess(edges, n_nodes=n_nodes, device=mesh.lead)
    return count_triangles_distributed_csr(
        csr, mesh, shorter_side=shorter_side, max_wedge_chunk=max_wedge_chunk
    )


def count_triangles_distributed_panel(
    edges,
    mesh: Mesh,
    n_nodes: int | None = None,
    widths: tuple[int, ...] = (16, 64, 256, 1024, 4096, 16384),
) -> int:
    """End-to-end striped count through the panel schedule."""
    edges = _np(edges)
    if edges.size == 0:
        return 0
    if n_nodes is None:
        n_nodes = int(edges.max()) + 1
    csr = preprocess(edges, n_nodes=n_nodes, device=mesh.lead)
    n_shards = int(np.prod(mesh.devices.shape))
    src = _np(csr.src)
    dst = _np(csr.col)
    out_deg = _np(csr.out_degree)
    need = np.maximum(out_deg[src], out_deg[dst])
    if int(need.max() if need.size else 0) > widths[-1]:
        raise ValueError("widths too small for max out-degree")
    per_width_arrays = {}
    lo = 0
    for w in widths:
        idx = np.nonzero((need > lo) & (need <= w))[0]
        lo = w
        e_per = max(1, -(-idx.size // n_shards))
        pad = e_per * n_shards - idx.size
        s = np.concatenate([src[idx], np.full(pad, -1, np.int32)])
        d = np.concatenate([dst[idx], np.full(pad, -1, np.int32)])
        per_width_arrays[w] = (
            np.ascontiguousarray(s.reshape(e_per, n_shards).T.astype(np.int32)),
            np.ascontiguousarray(d.reshape(e_per, n_shards).T.astype(np.int32)),
        )
    fn, ws = make_distributed_panel_count_fn(
        mesh, {w: per_width_arrays[w][0].shape[1] for w in widths}
    )
    args = [per_width_arrays[w][0] for w in ws] + [per_width_arrays[w][1] for w in ws]
    args += [mesh.replicate(a) for a in (csr.row_offsets, csr.col, csr.out_degree)]
    return int(_np(fn(*args)).astype(np.uint64).sum())


def oriented_csr_from_slabs(slabs, *, device=None) -> OrientedCSR:
    """Orient a sharded ``.tricsr`` cache (per-stripe slab views) on the host.

    ``slabs`` are :class:`repro_torch.graphs.io.CSRStripe` views
    (duck-typed: anything with ``row_offsets``/``col``/``node_lo``/
    ``node_hi``/``stripe_index``), each memory-mapping only its node-range
    slab of the undirected CSR.  Degrees come from the concatenated row
    offsets; each slab is then oriented independently with the engine's
    forward rule ``(du < dv) | ((du == dv) & (u < v))`` and the kept edges
    concatenated.  Because slabs cover contiguous node ranges and each
    slab's CSR is (src, dst)-sorted, the concat *is* the globally sorted
    oriented edge list — bit-identical to ``oriented_from_undirected_csr``
    of the assembled CSR.  The result lies on ``device`` (``None``: the
    card).
    """
    slabs = sorted(slabs, key=lambda s: int(s.stripe_index))
    if not slabs:
        raise ValueError("no slabs given")
    lo = 0
    for s in slabs:
        if int(s.node_lo) != lo:
            raise ValueError(
                f"slab {s.stripe_index} starts at node {s.node_lo}, expected {lo}"
            )
        lo = int(s.node_hi)
    n = lo
    row_full = np.concatenate(
        [np.asarray(s.row_offsets[:-1]) for s in slabs]
        + [np.asarray(slabs[-1].row_offsets[-1:])]
    ).astype(np.int64)
    deg = np.diff(row_full).astype(np.int32)
    src_parts, col_parts = [], []
    for s in slabs:
        lens = np.diff(np.asarray(s.row_offsets)).astype(np.int64)
        u = np.repeat(
            np.arange(int(s.node_lo), int(s.node_hi), dtype=np.int32), lens
        )
        v = np.asarray(s.col, dtype=np.int32)
        du, dv = deg[u], deg[v]
        keep = (du < dv) | ((du == dv) & (u < v))
        src_parts.append(u[keep])
        col_parts.append(v[keep])
    src = np.concatenate(src_parts) if src_parts else np.zeros(0, np.int32)
    col = np.concatenate(col_parts) if col_parts else np.zeros(0, np.int32)
    ensure_fits_int32(src.shape[0], "directed edge count (slab assembly offsets)")
    row = np.searchsorted(src, np.arange(n + 1, dtype=np.int64)).astype(np.int32)
    out_degree = (row[1:] - row[:-1]).astype(np.int32)
    return OrientedCSR.from_numpy(row, src, col, out_degree, deg, device=device)


def count_triangles_distributed_slabs(
    slabs,
    mesh: Mesh,
    *,
    shorter_side: bool = False,
    max_wedge_chunk: int | None = None,
    stats_out: dict | None = None,
) -> int:
    """§III-E count straight from sharded ``.tricsr`` slab views.

    Each slab is memory-mapped on its own during orientation
    (:func:`oriented_csr_from_slabs`, on ``mesh.lead``); the oriented CSR
    is then replicated — the paper's scheme — and counted with the striped
    functions under the usual wedge budget.
    """
    csr = oriented_csr_from_slabs(slabs, device=mesh.lead)
    if csr.n_directed_edges == 0:
        if stats_out is not None:
            stats_out.update(n_chunks=0, peak_wedge_buffer=0, cols_per_chunk=0)
        return 0
    return count_triangles_distributed_csr(
        csr, mesh,
        shorter_side=shorter_side,
        max_wedge_chunk=max_wedge_chunk,
        stats_out=stats_out,
    )
