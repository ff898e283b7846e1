"""Unified triangle-counting engine with memory-bounded edge partitioning.

The PyTorch counterpart of ``repro.core.engine``::

    from repro_torch.core import TriangleCounter

    tc = TriangleCounter(method="auto", max_wedge_chunk=1 << 22)  # on the card
    t  = tc.count(edges)          # exact global count (host int, uint64-safe)
    pn = tc.per_node(edges)       # per-vertex triangle incidences
    es = tc.edge_support(edges)   # per-directed-edge triangle support
    cc = tc.clustering(edges)     # local clustering coefficients

Every workload runs through a :class:`KernelBackend` registered per
schedule name.  A backend owns its planning (how the query edges are cut
into chunks that obey the budget) and its three chunk kernels:
:class:`WedgeBackend` (``"wedge_bsearch"``) expands wedges and closes them
with a batched binary search in torch ops; :class:`PanelBackend`
(``"panel"``) buckets edges by panel width and reduces the plain equality
cube; :class:`PallasBackend` (``"pallas"``) is the same plan driving the
hand-written CUDA kernels of :mod:`repro_torch.kernels.triangle_count`
(the method string is the reference's, so one ``method=`` drives the same
schedule in both packages), each chunk's kernel knobs steered by an
optional :class:`repro_torch.core.tuning.AutoTuner` (``tuner=``);
:class:`DistributedBackend` (``"distributed"``, with ``mesh=``) plans
§III-E round-robin edge stripes over every device of a
:class:`repro_torch.distributed.Mesh`, runs each stripe's wedge schedule on
its device and merges the partials on the mesh's lead device
(:mod:`repro_torch.core.distributed`).  A multi-device mesh makes
``"auto"`` resolve to it, as in the reference.

With ``REPRO_CHECK=1`` in the environment, :func:`run_workload` holds every
chunk's int32 partial to the device-accumulator contract
(:func:`repro_torch.check.runtime.check_partial`) before it is folded.

Device: the counter runs on ``cuda`` unless it is given ``device="cpu"``,
and raises when no card is visible.  All chunk partials stay on the
device until one fold at the end of the workload: count partials are
int32 segment sums folded on the host in uint64; per-node and support
partials are int32 scatters summed on the device in int64.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.check import runtime as check_runtime
from repro_torch.distributed.compression import can_narrow_int32, ensure_fits_int32
from repro_torch.distributed.mesh import mesh_device
from repro_torch.distributed.straggler import skew_disagreement_note, stripe_skew_report
from repro_torch.kernels.triangle_count import ops as tc_ops
from repro_torch.kernels.triangle_count.ref import panel_scatter_per_node, panel_scatter_support

from .count import (
    expand_and_close_wedges,
    expand_and_close_wedges_indexed,
    gather_panels_arrays,
    panel_intersect_count,
    panel_intersect_per_node,
    panel_intersect_support,
    segmented_int32_sum,
)
from .preprocess import (
    OrientedCSR,
    oriented_from_compressed,
    oriented_from_undirected_csr,
    preprocess,
)

__all__ = [
    "TriangleCounter",
    "EngineStats",
    "choose_method",
    "resolve_method",
    "plan_edge_chunks",
    "accumulate_partials",
    "prepare_oriented",
    "degree_histogram",
    "search_steps",
    "next_pow2",
    "iter_wedge_chunks",
    "chunk_count_kernel",
    "chunk_per_node_kernel",
    "chunk_support_kernel",
    "KernelBackend",
    "WedgeBackend",
    "PanelBackend",
    "PallasBackend",
    "DistributedBackend",
    "register_backend",
    "make_backend",
    "resolve_backend",
    "Workload",
    "make_workload",
    "workload_from_csr",
    "WorkPlan",
    "StripedChunk",
    "run_workload",
    "METHODS",
    "CAPABILITIES",
]

METHODS = ("auto", "wedge_bsearch", "panel", "pallas", "distributed")

CAPABILITIES = ("count", "per_node", "support")

DEFAULT_WIDTHS = (16, 64, 256, 1024, 4096)


def _host(x) -> np.ndarray:
    """A host numpy view of a tensor or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# host-side planning + accumulation
# ---------------------------------------------------------------------------


def accumulate_partials(partials) -> int:
    """uint64 host accumulation of device partial counts.

    Partials are int32 scalars or vectors (tensors on any device, or
    arrays), each element bounded by its reduction segment; their *sum*
    can exceed 2³¹, so the running total lives in uint64 on the host.
    """
    total = np.uint64(0)
    for p in partials:
        arr = _host(p)
        if arr.size == 0:
            continue
        total += np.uint64(arr.astype(np.uint64).sum())
    return int(total)


def plan_edge_chunks(reps: np.ndarray, budget: int | None):
    """Greedy contiguous partition of the directed edge list.

    ``reps[i]`` is the wedge fan-out of directed edge ``i``.  Returns
    ``(bounds, effective_budget)`` where every ``[start, end)`` chunk in
    ``bounds`` satisfies ``reps[start:end].sum() <= effective_budget``.
    The effective budget is ``max(budget, reps.max())`` — a chunk must
    hold at least one whole edge's fan-out.
    """
    reps = np.asarray(reps, dtype=np.int64)
    m = reps.shape[0]
    if m == 0:
        return [(0, 0)], 1
    total = int(reps.sum(dtype=np.int64))
    max_fan = int(reps.max())
    if budget is None or budget >= total:
        return [(0, m)], max(total, 1)
    eff = max(int(budget), max_fan, 1)
    cum = np.cumsum(reps)
    bounds = []
    start = 0
    while start < m:
        base = int(cum[start - 1]) if start else 0
        end = int(np.searchsorted(cum, base + eff, side="right"))
        end = max(end, start + 1)
        bounds.append((start, end))
        start = end
    return bounds, eff


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """What the last engine call actually did (for tests and tuning).

    ``resolved_method`` is what configuration + ``"auto"`` dispatch chose;
    ``method`` is what executed (they differ only on a capability
    fallback, with ``fallback_reason`` saying why).  Stats are cleared at
    the start of every public engine call.  ``peak_wedge_buffer`` is the
    largest buffer a launch materialized; ``wedge_budget`` the requested
    budget.  ``timings`` splits the call's wall clock into
    ``preprocess`` / ``plan`` / ``execute`` / ``fold`` seconds of host
    clock; launches are asynchronous, so ``preprocess``, ``plan`` (at its
    last read of a bucket size) and ``execute`` end before their device
    work does, and device time bills to whatever waits next (``fold``, or
    the next phase).  The host/device split is
    the phase spans (``engine.preprocess``, ``.resolve``, ``.workload``,
    ``.plan``, ``.launch``, ``.fold``) read beside a ``torch.profiler``
    trace of the device.

    The stripe fields describe a distributed run (``n_stripes`` is 1
    otherwise): the wedge-load skew of its stripes and the stripe the
    median+MAD rule flags (:func:`repro_torch.distributed.straggler.stripe_skew_report`);
    under an active tracer also the measured seconds per stripe, their
    skew and straggler, and ``skew_note`` (with a ``RuntimeWarning``) when
    load and measurement disagree on the straggler.
    """

    method: str
    resolved_method: str
    n_chunks: int
    peak_wedge_buffer: int
    wedge_budget: int | None
    total_wedges: int
    n_directed_edges: int
    fallback_reason: str | None = None
    n_stripes: int = 1                   # §III-E stripes (1 = single device)
    stripe_skew: float | None = None     # max/mean stripe wedge load
    straggler_stripe: int | None = None  # stripe flagged by the MAD rule
    timings: dict | None = None
    stripe_times: tuple[float, ...] | None = None  # measured s/stripe (traced)
    measured_stripe_skew: float | None = None      # max/mean measured time
    measured_straggler_stripe: int | None = None   # MAD rule on measured times
    skew_note: str | None = None         # load-vs-measured disagreement


def _stripe_stats(stripe_loads, stripe_times) -> dict:
    """The :class:`EngineStats` stripe fields from a plan's loads and times.

    ``stripe_loads`` (wedge slots per stripe) gives the skew and the
    straggler; ``stripe_times`` (seconds, traced runs) the measured ones,
    and a note when the two flag different stripes.
    """
    out: dict = {}
    load_rep = None
    if stripe_loads is not None:
        load_rep = stripe_skew_report(stripe_loads)
        out.update(stripe_skew=load_rep.skew, straggler_stripe=load_rep.straggler_stripe)
    if stripe_times:
        # the MAD rule works on integer loads; nanoseconds keep the
        # measured resolution through the int coercion
        time_rep = stripe_skew_report([int(t * 1e9) for t in stripe_times])
        out.update(stripe_times=tuple(stripe_times),
                   measured_stripe_skew=time_rep.skew,
                   measured_straggler_stripe=time_rep.straggler_stripe)
        if load_rep is not None:
            note = skew_disagreement_note(load_rep, time_rep)
            if note is not None:
                obs.counter("engine.skew_disagreements").add()
                warnings.warn(note, RuntimeWarning, stacklevel=3)
                out["skew_note"] = note
    return out


# ---------------------------------------------------------------------------
# chunk kernels (torch ops; one call per chunk).  Each records its launch
# signature (the tensors' shapes and dtypes, wedge_budget, n_steps) for
# repro_torch.check.runtime.CompileAuditor; ``edge_offset`` counts by type,
# as the reference's traced scalar does.
# ---------------------------------------------------------------------------


@check_runtime.records_launches(static=("wedge_budget", "n_steps"))
def chunk_count_kernel(src_e, dst_e, row_offsets, col, out_deg, *, wedge_budget, n_steps):
    """int32 partials (one per 2²⁰-slot segment) for one −1-padded edge chunk."""
    hit, _, _, _ = expand_and_close_wedges(
        src_e, dst_e, row_offsets, col, out_deg, wedge_budget, n_steps
    )
    return segmented_int32_sum(hit)


@check_runtime.records_launches(static=("wedge_budget", "n_steps"))
def chunk_per_node_kernel(src_e, dst_e, row_offsets, col, out_deg, *, wedge_budget, n_steps):
    """Per-vertex int32 triangle incidences contributed by one edge chunk."""
    hit, u, v, w = expand_and_close_wedges(
        src_e, dst_e, row_offsets, col, out_deg, wedge_budget, n_steps
    )
    inc = hit.to(torch.int32)
    n_out = row_offsets.shape[0] - 1
    out = torch.zeros((n_out,), dtype=torch.int32, device=col.device)
    # a slot that is no hit adds 0; its w may be a sentinel past the rows
    # (the incremental probe's padded col tail), which the reference's
    # scatter drops and index_add_ would refuse, so it is clipped
    for idx in (u, v, w.clamp(0, n_out - 1)):
        # trilint: ok[overflow] — a chunk partial: at most the chunk's wedge slots
        out.index_add_(0, idx, inc)
    return out


@check_runtime.records_launches(static=("wedge_budget", "n_steps"))
def chunk_support_kernel(
    src_e, dst_e, edge_offset, row_offsets, col, out_deg, *, wedge_budget, n_steps
):
    """Per-directed-edge int32 support contributed by one −1-padded edge chunk.

    ``edge_offset`` is the chunk's start in the global directed edge list;
    the base edge's local id shifts by it, while the arm and closure
    indices from the wedge expansion are global already.
    """
    hit, edge_id, uw_idx, vw_idx = expand_and_close_wedges_indexed(
        src_e, dst_e, row_offsets, col, out_deg, wedge_budget, n_steps
    )
    inc = hit.to(torch.int32)
    m_dir = col.shape[0]
    uv_idx = (edge_id + int(edge_offset)).clamp_(0, m_dir - 1)
    out = torch.zeros((m_dir,), dtype=torch.int32, device=col.device)
    for idx in (uv_idx, uw_idx, vw_idx):
        # trilint: ok[overflow] — a chunk partial: at most the chunk's wedge slots
        out.index_add_(0, idx, inc)
    return out


def search_steps(csr: OrientedCSR) -> int:
    """⌈log₂(max out-degree + 1)⌉ — the binary-search depth for this CSR."""
    max_deg = int(csr.out_degree.max()) if csr.n_nodes else 0
    return max(1, math.ceil(math.log2(max_deg + 1))) if max_deg else 1


def prepare_oriented(edges, n_nodes: int | None = None, *, device=None) -> OrientedCSR | None:
    """Normalize any accepted graph input to an :class:`OrientedCSR`.

    Accepts a pre-built :class:`OrientedCSR` (returned as-is), a
    compressed CSR (anything with ``decode_block``; per-node and support
    results are then in its relabeled ids), a cached undirected CSR
    (anything with ``row_offsets``/``col``), or a canonical edge array.
    Returns ``None`` for an empty graph.
    """
    if isinstance(edges, OrientedCSR):
        csr = edges
    elif hasattr(edges, "decode_block"):
        csr = oriented_from_compressed(edges, device=device)
    elif hasattr(edges, "row_offsets") and hasattr(edges, "col"):
        csr = oriented_from_undirected_csr(
            edges.row_offsets, edges.col, getattr(edges, "n_nodes", None), device=device
        )
    else:
        edges = _host(edges)
        if edges.size == 0:
            return None
        if n_nodes is None:
            n_nodes = int(edges.max()) + 1
        csr = preprocess(edges, n_nodes=n_nodes, device=device)
    if csr.n_directed_edges > 0:
        return csr
    return None


def degree_histogram(edges, n_nodes: int | None = None) -> tuple[np.ndarray, int]:
    """Undirected degrees (int64, host) + node count for any accepted input."""
    if isinstance(edges, OrientedCSR):
        return _host(edges.degree).astype(np.int64), edges.n_nodes
    if hasattr(edges, "decode_block"):
        return np.diff(np.asarray(edges.row_offsets)).astype(np.int64), int(edges.n_nodes)
    if hasattr(edges, "row_offsets") and hasattr(edges, "col"):
        return np.diff(np.asarray(edges.row_offsets)).astype(np.int64), int(
            getattr(edges, "n_nodes", np.asarray(edges.row_offsets).shape[0] - 1)
        )
    edges = _host(edges)
    if edges.size == 0:
        return np.zeros((n_nodes or 0,), np.int64), n_nodes or 0
    if n_nodes is None:
        n_nodes = int(edges.max()) + 1
    return np.bincount(edges[:, 0], minlength=n_nodes).astype(np.int64), n_nodes


def next_pow2(x: int) -> int:
    """Smallest power of two ≥ x (pow2 shape bucketing helper)."""
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


# ---------------------------------------------------------------------------
# workloads: the uniform "query edges vs adjacency" view every backend plans
# ---------------------------------------------------------------------------


class Workload(NamedTuple):
    """One edge-query workload: query pairs closed against an adjacency.

    ``(src_e[i], dst_e[i])`` is query edge ``i``; −1 slots are padding.
    ``row_offsets``/``col``/``out_degree`` (tensors on the run's device)
    describe the adjacency rows the queries intersect.  The ``*_host``
    fields are numpy copies that the wedge and §III-E planners read; the
    panel planner reads the tensors.
    """

    row_offsets: torch.Tensor
    col: torch.Tensor
    out_degree: torch.Tensor
    src_e: torch.Tensor
    dst_e: torch.Tensor
    src_host: np.ndarray
    dst_host: np.ndarray
    deg_host: np.ndarray
    n_steps: int


def _int32_on(x, dev: torch.device) -> torch.Tensor:
    """``x`` (a tensor or a host array) as an int32 tensor on ``dev``; a
    tensor already there is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.int32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)


def make_workload(
    row_offsets, col, out_degree, src_e, dst_e, n_steps: int | None = None, *, device=None
) -> Workload:
    """Build a :class:`Workload` (its numpy host copies are taken here).

    Without ``device`` the five arrays are the run's device tensors.  With
    it they may be numpy arrays or tensors, and each goes to ``device``
    once (``dst_e`` is ``col`` → one upload).
    """
    deg_host, src_host, dst_host = _host(out_degree), _host(src_e), _host(dst_e)
    if n_steps is None:
        max_deg = int(deg_host.max()) if deg_host.size else 0
        n_steps = max(1, math.ceil(math.log2(max_deg + 1))) if max_deg else 1
    if device is not None:
        dev = resolve_device(device)
        dst_e = None if dst_e is col else _int32_on(dst_e, dev)
        row_offsets, col, out_degree, src_e = (
            _int32_on(x, dev) for x in (row_offsets, col, out_degree, src_e)
        )
        dst_e = col if dst_e is None else dst_e
    return Workload(
        row_offsets, col, out_degree, src_e, dst_e,
        src_host, dst_host, deg_host, n_steps,
    )


def workload_from_csr(csr: OrientedCSR) -> Workload:
    """The engine's standard workload: every directed edge queries its CSR."""
    return make_workload(
        csr.row_offsets, csr.col, csr.out_degree, csr.src, csr.col,
        n_steps=search_steps(csr),
    )


class _DeviceAdj(NamedTuple):
    """Device-resident adjacency tensors shared by every chunk launch."""

    row_offsets: torch.Tensor
    col: torch.Tensor
    out_degree: torch.Tensor
    n_steps: int

    @property
    def device(self) -> torch.device:
        return self.col.device

    def put(self, arr) -> torch.Tensor:
        """A chunk array as an int32 tensor on the adjacency's device.

        An int32 tensor already there is returned as it is; anything else
        is copied or converted, and counted in ``engine.chunk_uploads``.
        """
        if not (isinstance(arr, torch.Tensor) and arr.dtype == torch.int32
                and arr.device == self.device):
            obs.counter("engine.chunk_uploads").add()
        return _int32_on(arr, self.device)


class WedgeChunk(NamedTuple):
    """One −1-padded contiguous slice of the query edge list."""

    src: object
    dst: object
    start: int    # offset into the global query list (support scatter)
    buffer: int   # wedge-buffer length for this launch


class PanelChunk(NamedTuple):
    """One width-bucket slice of the query edge list (−1 padded): int32
    1-D tensors on the workload's device."""

    edge_idx: torch.Tensor  # global query ids
    u: torch.Tensor
    v: torch.Tensor
    width: int


class StripedChunk(NamedTuple):
    """One −1-padded column slice of the §III-E striped edge axis."""

    src: np.ndarray   # (n_stripes, cols) round-robin striped sources
    dst: np.ndarray
    start: int        # starting column in the striped axis
    buffer: int       # per-stripe wedge-buffer length


class WorkPlan(NamedTuple):
    """A backend's chunking decision for one workload.

    ``timings`` and ``stripe_times`` are filled in by :func:`run_workload`
    on the plan it returns: phase → seconds, and (traced distributed runs
    only) the measured seconds per stripe.
    """

    chunks: Iterator
    n_chunks: int
    peak_buffer: int   # largest per-launch buffer (slots/elements)
    total_wedges: int  # Σ fan-out over the query edges
    n_stripes: int = 1                           # §III-E stripes (distributed)
    stripe_loads: tuple[int, ...] | None = None  # wedge slots per stripe
    timings: dict | None = None                  # filled by run_workload
    stripe_times: tuple[float, ...] | None = None  # filled when traced


# ---------------------------------------------------------------------------
# the backends
# ---------------------------------------------------------------------------


class KernelBackend:
    """Protocol each registered schedule implements.

    A backend owns chunk planning (:meth:`plan`) and the three chunk
    kernels.  ``capabilities`` declares which workloads it can execute;
    :func:`resolve_backend` substitutes the wedge backend (recording an
    explicit fallback reason) for anything outside that set.
    """

    name: str = "abstract"
    capabilities: frozenset = frozenset()

    def plan(self, work: Workload, budget: int | None, *, bucket_pow2: bool = False) -> WorkPlan:
        raise NotImplementedError

    def count_chunk(self, adj: _DeviceAdj, chunk):
        raise NotImplementedError

    def per_node_chunk(self, adj: _DeviceAdj, chunk, n_out: int):
        raise NotImplementedError

    def support_chunk(self, adj: _DeviceAdj, chunk, m_out: int):
        raise NotImplementedError


class WedgeBackend(KernelBackend):
    """The batched-binary-search wedge schedule (§II-C forward algorithm).

    Plans greedy contiguous edge chunks whose wedge fan-out totals obey
    the budget (:func:`plan_edge_chunks`); every chunk is padded to one
    buffer length.  ``bucket_pow2`` rounds that length and the chunk width
    up to powers of two, as the reference does for its compile cache; here
    it only keeps the plan's stats and padding equal to the reference's.
    """

    name = "wedge_bsearch"
    capabilities = frozenset(CAPABILITIES)

    def plan(self, work: Workload, budget: int | None, *, bucket_pow2: bool = False) -> WorkPlan:
        src, dst = work.src_host, work.dst_host
        reps = np.where(
            src >= 0, work.deg_host[np.maximum(src, 0)], 0
        ).astype(np.int64)
        bounds, _ = plan_edge_chunks(reps, budget)
        cum = np.concatenate([[0], np.cumsum(reps)])
        peak = max(int(cum[end] - cum[start]) for start, end in bounds)
        peak = max(peak, 1)
        edges_per_chunk = max(end - start for start, end in bounds)
        if bucket_pow2:
            peak = next_pow2(peak)
            edges_per_chunk = next_pow2(edges_per_chunk)

        def gen():
            if len(bounds) == 1 and edges_per_chunk == src.shape[0]:
                # single full chunk: feed the device tensors as they are
                yield WedgeChunk(work.src_e, work.dst_e, 0, peak)
                return
            for start, end in bounds:
                pad = edges_per_chunk - (end - start)
                s, d = src[start:end], dst[start:end]
                if pad:
                    fill = np.full(pad, -1, np.int32)
                    s = np.concatenate([s, fill])
                    d = np.concatenate([d, fill])
                yield WedgeChunk(
                    s.astype(np.int32, copy=False),
                    d.astype(np.int32, copy=False),
                    start, peak,
                )

        return WorkPlan(gen(), len(bounds), peak, int(reps.sum(dtype=np.int64)))

    def count_chunk(self, adj, chunk):
        return chunk_count_kernel(
            adj.put(chunk.src), adj.put(chunk.dst),
            adj.row_offsets, adj.col, adj.out_degree,
            wedge_budget=chunk.buffer, n_steps=adj.n_steps,
        )

    def per_node_chunk(self, adj, chunk, n_out):
        return chunk_per_node_kernel(
            adj.put(chunk.src), adj.put(chunk.dst),
            adj.row_offsets, adj.col, adj.out_degree,
            wedge_budget=chunk.buffer, n_steps=adj.n_steps,
        )

    def support_chunk(self, adj, chunk, m_out):
        return chunk_support_kernel(
            adj.put(chunk.src), adj.put(chunk.dst), chunk.start,
            adj.row_offsets, adj.col, adj.out_degree,
            wedge_budget=chunk.buffer, n_steps=adj.n_steps,
        )


class PanelBackend(KernelBackend):
    """The bucketed fixed-width panel schedule (plain equality cube).

    Plans width buckets sliced under ``budget // width`` rows each; chunk
    kernels gather neighbor panels with torch ops and reduce them.
    Degrees beyond the configured ladder extend it by ×4 rungs.
    ``bucket_pow2`` rounds each slice's rows up to a power of two (the
    extra rows −1).
    """

    name = "panel"
    capabilities = frozenset(CAPABILITIES)

    def __init__(self, widths=DEFAULT_WIDTHS, tuner=None):
        self.widths = tuple(widths)
        self.tuner = tuner

    # intersect flavors — PallasBackend overrides with the kernel family
    def intersect_count(self, a, b):
        return panel_intersect_count(a, b)

    def intersect_per_node(self, a, b):
        return panel_intersect_per_node(a, b)

    def intersect_support(self, a, b):
        return panel_intersect_support(a, b)

    def _ladder(self, max_need: int):
        ws = list(self.widths)
        while ws and ws[-1] < max_need:
            ws.append(ws[-1] * 4)
        return tuple(ws)

    def plan(self, work: Workload, budget: int | None, *, bucket_pow2: bool = False) -> WorkPlan:
        """Bucket the query edges by ``max(deg u, deg v)`` and slice each bucket.

        Torch ops on the workload's tensors: on the card only ``need.max()``,
        the wedge total and each bucket's size are read back.  A bucket is one
        −1-filled ``(n_slices, rows)`` tensor of query ids (ascending within
        the bucket) with its ``u`` and ``v`` taken once; its chunks are the
        rows, int32 views that :meth:`_DeviceAdj.put` passes through.
        """
        src, dst, deg = work.src_e, work.dst_e, work.out_degree
        ensure_fits_int32(src.shape[0], "panel query edge count")
        valid = (src >= 0) & (dst >= 0)
        du = torch.where(valid, deg.index_select(0, src.clamp(min=0)), 0)
        dv = torch.where(valid, deg.index_select(0, dst.clamp(min=0)), 0)
        need = torch.maximum(du, dv)
        total_wedges = int(du.sum(dtype=torch.int64))

        def take(arr, ids):
            got = arr.index_select(0, ids.clamp(min=0).view(-1)).view(ids.shape)
            return torch.where(ids >= 0, got, -1).to(torch.int32)

        chunks: list[PanelChunk] = []
        peak = 0
        lo = 0
        for w in self._ladder(int(need.max()) if need.numel() else 0):
            idx = torch.nonzero((need > lo) & (need <= w)).squeeze(1).to(torch.int32)
            lo = w
            n = idx.shape[0]
            if not n:
                continue
            per = n if budget is None else max(1, int(budget) // w)
            n_slices = -(-n // per)
            cols = min(per, n)
            rows = per if n_slices > 1 else n
            if bucket_pow2:
                rows = next_pow2(rows)
            flat = idx.new_full((n_slices * cols,), -1)
            flat[:n] = idx
            ids = idx.new_full((n_slices, rows), -1)
            ids[:, :cols] = flat.view(n_slices, cols)
            chunks += (
                PanelChunk(e, u, v, w)
                for e, u, v in zip(ids.unbind(), take(src, ids).unbind(), take(dst, ids).unbind())
            )
            peak = max(peak, rows * w)

        return WorkPlan(iter(chunks), len(chunks), peak, total_wedges)

    def _gather(self, adj, chunk):
        u, v = adj.put(chunk.u), adj.put(chunk.v)
        a, b, _, _ = gather_panels_arrays(
            adj.row_offsets, adj.col, adj.out_degree, u, v, chunk.width
        )
        return u, v, a, b

    def count_chunk(self, adj, chunk):
        _, _, a, b = self._gather(adj, chunk)
        return self.intersect_count(a, b)

    def per_node_chunk(self, adj, chunk, n_out):
        u, v, a, b = self._gather(adj, chunk)
        count, arm = self.intersect_per_node(a, b)
        return panel_scatter_per_node(u, v, a, count, arm, n_out=n_out)

    def support_chunk(self, adj, chunk, m_out):
        u, v, a, b = self._gather(adj, chunk)
        count, arm, closure = self.intersect_support(a, b)
        return panel_scatter_support(
            adj.put(chunk.edge_idx), u, v, adj.row_offsets, count, arm, closure,
            m_out=m_out,
        )


class PallasBackend(PanelBackend):
    """The panel plan driving the hand-written CUDA kernel family.

    Registered as ``"pallas"``, the reference's name for its kernel
    backend.  Identical planning to :class:`PanelBackend`; each chunk is
    one call into :mod:`repro_torch.kernels.triangle_count` (the CUDA
    kernels on the card, their plain versions on CPU tensors) that reads
    both lists of every row from the CSR: no panels are gathered, and the
    per-node and support kernels add their hits into the chunk's int32
    partial themselves, with no scatter after them.  The ``intersect_*``
    panel methods (``ops.intersect_*``) serve :class:`PanelBackend`'s
    gather route when a subclass takes its chunk methods.  With a
    ``tuner`` each chunk's rows per block and lanes per row come from its
    cache (``tuner.tiles(rows, width, width)``); without one, or on a
    miss it does not tune, the kernel's default pick runs.
    """

    name = "pallas"

    def _tiles(self, chunk):
        if self.tuner is None:
            return None
        return self.tuner.tiles(len(chunk.u), chunk.width, chunk.width)

    def count_chunk(self, adj, chunk):
        return tc_ops.intersect_count_csr(
            adj.row_offsets, adj.col, adj.put(chunk.u), adj.put(chunk.v), chunk.width,
            self._tiles(chunk),
        )

    def per_node_chunk(self, adj, chunk, n_out):
        return tc_ops.intersect_per_node_csr(
            adj.row_offsets, adj.col, adj.put(chunk.u), adj.put(chunk.v), chunk.width, n_out,
            self._tiles(chunk),
        )

    def support_chunk(self, adj, chunk, m_out):
        return tc_ops.intersect_support_csr(
            adj.row_offsets, adj.col, adj.put(chunk.u), adj.put(chunk.v),
            adj.put(chunk.edge_idx), chunk.width, m_out, self._tiles(chunk),
        )

    def intersect_count(self, a, b):
        return tc_ops.intersect_count(a, b)

    def intersect_per_node(self, a, b):
        return tc_ops.intersect_per_node(a, b)

    def intersect_support(self, a, b):
        return tc_ops.intersect_support(a, b)


class DistributedBackend(KernelBackend):
    """The §III-E striped schedule over a device mesh — every workload.

    :meth:`plan` stripes the query edge list round-robin over every mesh
    device (edge ``i`` on stripe ``i mod S``) and cuts the striped axis
    into column chunks whose *worst stripe* obeys the wedge budget
    (:func:`repro_torch.core.distributed.plan_striped_chunks`,
    shorter-side-aware).  The chunk functions come from
    :func:`repro_torch.core.distributed.striped_workload_fn`: each stripe
    runs the wedge schedule in torch ops on its device; count returns
    per-stripe segmented partials (host uint64 reduce), per-node sums the
    stripes' vectors, support sums arm/closure and gathers the
    stripe-local base over a delta-compressed uint16 wire when the graph's
    degree bound allows (``compress=True``, the default).  Every result
    lands on ``mesh.lead``.

    All three are bit-identical to the wedge backend at any budget and any
    stripe count.
    """

    name = "distributed"
    capabilities = frozenset(CAPABILITIES)

    def __init__(self, mesh=None, *, shorter_side: bool = False, compress: bool = True):
        if mesh is not None:
            mesh_device(mesh)  # type check
        self.mesh = mesh
        self.shorter_side = shorter_side
        self.compress = compress
        self.n_shards = int(np.prod(mesh.devices.shape)) if mesh is not None else 0
        self._adj_src = None
        self._adj_dev = None
        self._adj_bound = 0

    def _require_mesh(self):
        if self.mesh is None:
            raise ValueError(
                "the distributed backend needs a repro_torch.distributed.Mesh; "
                "construct it via make_backend('distributed', mesh=...) or "
                "TriangleCounter(method='distributed', mesh=...)"
            )

    def plan(self, work: Workload, budget: int | None, *, bucket_pow2: bool = False) -> WorkPlan:
        from .distributed import iter_striped_chunks, plan_striped_chunks, stripe_arrays

        self._require_mesh()
        src_sh, dst_sh, loads = stripe_arrays(
            work.src_host, work.dst_host, work.deg_host, self.n_shards,
            shorter_side=self.shorter_side, min_cols=1,
        )
        bounds, eff = plan_striped_chunks(
            src_sh, work.deg_host, budget, dst_sh=dst_sh if self.shorter_side else None
        )
        cols_per_chunk = max(end - start for start, end in bounds)
        if bucket_pow2:
            eff = next_pow2(eff)
            cols_per_chunk = next_pow2(cols_per_chunk)
        chunks = (
            StripedChunk(s, d, start, eff)
            for start, s, d in iter_striped_chunks(src_sh, dst_sh, bounds, cols_per_chunk)
        )
        return WorkPlan(
            chunks, len(bounds), eff, int(loads.sum(dtype=np.int64)),
            n_stripes=self.n_shards, stripe_loads=tuple(int(x) for x in loads),
        )

    # -- chunk launch plumbing ---------------------------------------------

    def _device_adj(self, adj: _DeviceAdj):
        """Replicate the adjacency to each distinct device once per workload.

        The cache holds the source tensors themselves (compared by
        identity), so a later workload's new tensors never match it.
        """
        src = (adj.row_offsets, adj.col, adj.out_degree)
        if self._adj_src is None or any(a is not b for a, b in zip(self._adj_src, src)):
            self._adj_dev = tuple(self.mesh.replicate(a) for a in src)
            deg = adj.out_degree
            self._adj_bound = int(deg.max()) if deg.numel() else 0
            self._adj_src = src
        return self._adj_dev

    def _launch(self, kind: str, adj: _DeviceAdj, chunk: StripedChunk, n_out: int):
        from .distributed import striped_workload_fn

        self._require_mesh()
        row, col, deg = self._device_adj(adj)
        narrow = kind == "support" and self.compress and can_narrow_int32(self._adj_bound)
        fn = striped_workload_fn(
            self.mesh, kind, chunk.buffer, adj.n_steps,
            n_out=n_out, shorter_side=self.shorter_side, narrow_wire=narrow,
        )
        return fn(chunk.src, chunk.dst, chunk.start, row, col, deg)

    def count_chunk(self, adj, chunk):
        return self._launch("count", adj, chunk, 0)

    def per_node_chunk(self, adj, chunk, n_out):
        return self._launch("per_node", adj, chunk, n_out)

    def support_chunk(self, adj, chunk, m_out):
        if m_out != int(adj.col.shape[0]):
            raise ValueError(
                f"distributed support needs the query list aligned with the "
                f"adjacency edge list (m_out={m_out} != |col|={int(adj.col.shape[0])})"
            )
        return self._launch("support", adj, chunk, m_out)


_BACKEND_FACTORIES: dict[str, object] = {}


def register_backend(name: str, factory) -> None:
    """Register a backend factory under ``name``.

    The factory is called with keyword arguments
    ``factory(widths=..., tuner=..., mesh=..., shorter_side=...)`` and must
    return a :class:`KernelBackend`; accept ``**_`` for the knobs the
    backend does not use.  A registered name is directly usable as
    ``TriangleCounter(method=name)``.
    """
    _BACKEND_FACTORIES[name] = factory


register_backend("wedge_bsearch", lambda **_: WedgeBackend())
register_backend("panel", lambda widths=DEFAULT_WIDTHS, tuner=None, **_: PanelBackend(
    widths=widths, tuner=tuner))
register_backend("pallas", lambda widths=DEFAULT_WIDTHS, tuner=None, **_: PallasBackend(
    widths=widths, tuner=tuner))
register_backend("distributed", lambda mesh=None, shorter_side=False, **_: DistributedBackend(
    mesh, shorter_side=shorter_side))


def make_backend(
    name: str, *, widths=DEFAULT_WIDTHS, tuner=None, mesh=None, shorter_side: bool = False
) -> KernelBackend:
    """Instantiate the backend registered under ``name``."""
    try:
        factory = _BACKEND_FACTORIES[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel backend {name!r}; registered: "
            f"{sorted(_BACKEND_FACTORIES)}"
        ) from None
    return factory(widths=widths, tuner=tuner, mesh=mesh, shorter_side=shorter_side)


_warned_fallbacks: set = set()


def resolve_backend(
    method: str,
    kind: str,
    *,
    widths=DEFAULT_WIDTHS,
    tuner=None,
    mesh=None,
    shorter_side: bool = False,
):
    """Pick the backend for (schedule, workload) by capability.

    Returns ``(backend, executed_name, fallback_reason)``.  When the
    requested backend lacks ``kind`` — or the distributed schedule is
    requested without a mesh — the wedge backend substitutes and the
    reason is returned (plus a one-time ``RuntimeWarning`` per
    (method, kind) pair per process).
    """
    if kind not in CAPABILITIES:
        raise ValueError(f"unknown workload kind {kind!r}; expected one of {CAPABILITIES}")
    if method == "distributed" and mesh is None:
        reason = (
            "backend 'distributed' needs a mesh and none was configured; "
            "fell back to 'wedge_bsearch'"
        )
    else:
        backend = make_backend(
            method, widths=widths, tuner=tuner, mesh=mesh, shorter_side=shorter_side
        )
        if kind in backend.capabilities:
            return backend, method, None
        reason = f"backend {method!r} has no {kind!r} kernel; fell back to 'wedge_bsearch'"
    obs.counter("engine.capability_fallbacks").add()
    key = (method, kind)
    if key not in _warned_fallbacks:
        _warned_fallbacks.add(key)
        warnings.warn(reason, RuntimeWarning, stacklevel=3)
    return make_backend("wedge_bsearch", widths=widths, tuner=tuner), "wedge_bsearch", reason


def run_workload(
    backend: KernelBackend,
    kind: str,
    work: Workload,
    *,
    budget: int | None = None,
    n_out: int | None = None,
    bucket_pow2: bool = False,
):
    """Plan → launch → accumulate one workload through a backend.

    The one loop every caller shares (engine methods, analytics
    support, truss peel rounds); ``bucket_pow2`` goes to the planner.

    Returns ``(value, plan)``: ``int`` for ``"count"``, int64 ``(n_out,)``
    for ``"per_node"``, int64 per-query-edge for ``"support"``, and the
    plan with its launch stats and phase ``timings``.  Partials stay on
    the device until one fold after the last launch, so launches are not
    serialized by host reads; a distributed backend's partials and the
    fold lie on its mesh's lead device.  The three phases are
    :mod:`repro_torch.obs` spans (``engine.plan``, ``engine.launch``,
    ``engine.fold``), ranges on the profiler's clock while
    ``torch.profiler`` records; ``engine.plan`` and ``engine.fold`` have
    the boundaries of ``timings["plan"]`` and ``["fold"]``.  Under an
    active tracer each chunk launch also gets a span with the chunk's
    ``buffer`` (and a panel chunk's ``width`` and ``rows``); on CUDA it
    brackets the launch in a CUDA event pair instead of waiting, and gets
    ``device_ms`` once the fold has waited (:meth:`Span.device_time`:
    stream time, an upper bound of the chunk's device time).  §III-E
    striped chunks get a per-stripe timing probe
    (:func:`_probe_stripe_times`) whose sums fill the returned plan's
    ``stripe_times``.  With ``REPRO_CHECK=1`` each chunk's partial goes
    through :func:`repro_torch.check.runtime.check_partial` before the
    fold (one read of its min and max per chunk).
    """
    if kind not in CAPABILITIES:
        raise ValueError(f"unknown workload kind {kind!r}")
    trc = obs.active()
    with obs.span("engine.plan", cat="engine"):
        t0 = time.perf_counter()
        plan = backend.plan(work, budget, bucket_pow2=bucket_pow2)
        timings = {"plan": time.perf_counter() - t0, "execute": 0.0, "fold": 0.0}
    adj = _DeviceAdj(work.row_offsets, work.col, work.out_degree, work.n_steps)
    san = check_runtime if check_runtime.enabled() else None  # read per call: tests toggle it
    obs.counter("engine.workloads").add()
    obs.counter("engine.wedges_planned").add(plan.total_wedges)
    obs.counter("engine.chunks_launched").add(plan.n_chunks)
    obs.gauge("engine.peak_wedge_buffer").set(plan.peak_buffer)

    stripe_acc: list | None = None

    def launch(fn, chunk, i, *extra):
        """One chunk launch, span-wrapped (CUDA-event-timed) when tracing."""
        nonlocal stripe_acc
        if trc is None:
            return fn(adj, chunk, *extra)
        args = {"chunk": i, "buffer": int(getattr(chunk, "buffer", 0))}
        if isinstance(chunk, PanelChunk):
            args.update(width=int(chunk.width), rows=len(chunk.u))
        with trc.span(f"{kind}.chunk", cat="engine", args=args) as sp, \
                sp.device_time(adj.device):
            part = fn(adj, chunk, *extra)
        if isinstance(chunk, StripedChunk):
            times = _probe_stripe_times(trc, backend, adj, chunk)
            stripe_acc = [0.0] * len(times) if stripe_acc is None else stripe_acc
            for s, dt in enumerate(times):
                stripe_acc[s] += dt
        return part

    t0 = time.perf_counter()
    with obs.span("engine.launch", cat="engine"):
        if kind == "count":
            partials = [
                launch(backend.count_chunk, chunk, i) for i, chunk in enumerate(plan.chunks)
            ]
            if san is not None:
                san.check_partials(partials, kind="count")
        else:
            if kind == "per_node":
                n = adj.row_offsets.shape[0] - 1 if n_out is None else n_out
                fn = backend.per_node_chunk
            else:
                n = int(work.src_host.shape[0])
                fn = backend.support_chunk
            lead = backend.mesh.lead if isinstance(backend, DistributedBackend) else adj.device
            acc = torch.zeros((n,), dtype=torch.int64, device=lead)
            for i, chunk in enumerate(plan.chunks):
                part = launch(fn, chunk, i, n)
                if san is not None:
                    san.check_partial(part, kind=kind, context=f"chunk {i}")
                acc += part
    timings["execute"] = time.perf_counter() - t0
    with obs.span("engine.fold", cat="engine"):
        t0 = time.perf_counter()
        value = accumulate_partials(partials) if kind == "count" else acc.cpu().numpy()
        timings["fold"] = time.perf_counter() - t0
    if trc is not None:
        trc.settle()  # the fold has waited: every chunk's event pair is complete
    return value, plan._replace(
        timings=timings, stripe_times=tuple(stripe_acc) if stripe_acc else None
    )


def _probe_stripe_times(trc, backend, adj: _DeviceAdj, chunk: StripedChunk) -> list[float]:
    """Measured seconds per stripe for one §III-E striped chunk.

    The stripes of a chunk are launched back to back and only their merge
    is synced, so one stripe is not observable from the host.  Under
    tracing the wedge-count kernel is therefore run again over each
    stripe's −1-padded edge slice on the stripe's device, synced, and
    those wall times are reported beside the load-inferred skew.  One
    warm-up launch keeps first-use costs out of the timed region.  Costs
    roughly one extra pass over the chunk, paid only while a tracer is
    active.
    """
    row, col, deg = backend._device_adj(adj)
    devices = list(backend.mesh.devices.flat)

    def run(s):
        dev = devices[s]
        out = chunk_count_kernel(
            torch.from_numpy(chunk.src[s]).to(dev), torch.from_numpy(chunk.dst[s]).to(dev),
            row[dev], col[dev], deg[dev], wedge_budget=chunk.buffer, n_steps=adj.n_steps,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    run(0)
    times = []
    for s in range(len(devices)):
        t0 = time.perf_counter()
        with trc.span("stripe.probe", cat="engine.stripes", args={"stripe": s}):
            run(s)
        times.append(time.perf_counter() - t0)
    return times


def iter_wedge_chunks(csr: OrientedCSR, max_wedge_chunk: int | None, *, bucket_pow2: bool = False):
    """Lazily yield −1-padded fixed-shape ``(src, dst, start)`` chunks.

    A view over :meth:`WedgeBackend.plan`.  ``start`` is each chunk's
    offset into the directed edge list.  A single full chunk is the CSR's
    own tensors; sliced chunks are host int32 arrays.  Returns
    ``(generator, n_chunks, peak, total_wedges)`` where ``peak`` is the
    per-launch buffer (pow2-rounded when bucketing).
    """
    plan = WedgeBackend().plan(
        workload_from_csr(csr), max_wedge_chunk, bucket_pow2=bucket_pow2
    )
    gen = ((c.src, c.dst, c.start) for c in plan.chunks)
    return gen, plan.n_chunks, plan.peak_buffer, plan.total_wedges


# ---------------------------------------------------------------------------
# auto dispatch
# ---------------------------------------------------------------------------


def choose_method(
    *,
    max_out_degree: int,
    mean_out_degree: float,
    mesh=None,
    widths: tuple[int, ...] = DEFAULT_WIDTHS,
    backend: str = "cpu",
) -> str:
    """Pick a counting schedule from graph statistics (§III-C skew logic).

    * a mesh of more than one stripe always wins — the §III-E striping is
      exact regardless of skew (a mesh that repeats a device counts its
      stripes, as the reference's simulated mesh does);
    * on a CUDA device, panels that fit the largest bucket go to the
      hand-written kernel (``"pallas"``) — the counterpart of the
      reference's TPU test;
    * low degree + low skew favors the plain panel schedule;
    * heavy tails favor ``wedge_bsearch``, immune to padding waste.
    """
    if mesh is not None and int(np.prod(mesh.devices.shape)) > 1:
        return "distributed"
    skew = max_out_degree / max(mean_out_degree, 1e-9)
    if backend == "cuda" and max_out_degree <= widths[-1]:
        return "pallas"
    if max_out_degree <= 64 and skew <= 16.0:
        return "panel"
    return "wedge_bsearch"


def resolve_method(
    method: str, out_degree, *, mesh=None, widths=DEFAULT_WIDTHS, backend: str = "cpu"
) -> str:
    """Resolve ``"auto"`` against an out-degree histogram (never "auto").

    ``backend`` is the device type the counter runs on (``"cuda"`` or
    ``"cpu"``).
    """
    if method != "auto":
        return method
    out_deg = _host(out_degree)
    max_deg = int(out_deg.max()) if out_deg.size else 0
    mean_deg = float(out_deg.mean()) if out_deg.size else 0.0
    return choose_method(
        max_out_degree=max_deg, mean_out_degree=mean_deg, mesh=mesh, widths=widths,
        backend=backend,
    )


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class TriangleCounter:
    """Unified, memory-bounded triangle counting over every ported schedule.

    Parameters
    ----------
    method:
        One of ``"auto"``, ``"wedge_bsearch"``, ``"panel"``, ``"pallas"``,
        ``"distributed"``.
    max_wedge_chunk:
        Wedge-buffer budget per launch (slots).  ``None`` runs a single
        full-size launch.
    widths:
        Panel bucket boundaries for the panel/pallas schedules.
    tuner:
        Optional :class:`repro_torch.core.tuning.AutoTuner` steering the
        CSR kernels' rows per block and lanes per row from its per-shape
        grid-search cache.
    mesh:
        A :class:`repro_torch.distributed.Mesh` for the distributed
        schedule (required when ``method="distributed"``; a mesh of more
        than one stripe makes ``"auto"`` resolve to it).  The counter then
        runs on the mesh's lead device.
    shorter_side:
        Distributed only — enumerate wedge candidates from the smaller
        endpoint list (the §Perf variant).
    device:
        ``None`` or ``"cuda"`` (the default: raises without a card) or
        ``"cpu"``; with a mesh, ``None`` or its lead device.

    After any call, :attr:`last_stats` holds an :class:`EngineStats`.
    """

    def __init__(
        self,
        method: str = "auto",
        max_wedge_chunk: int | None = None,
        widths: tuple[int, ...] = DEFAULT_WIDTHS,
        *,
        tuner=None,
        mesh=None,
        shorter_side: bool = False,
        device=None,
    ):
        if method not in METHODS and method not in _BACKEND_FACTORIES:
            raise ValueError(
                f"unknown method {method!r}; expected one of {METHODS} "
                f"or a registered backend ({sorted(_BACKEND_FACTORIES)})"
            )
        if method == "distributed" and mesh is None:
            raise ValueError("method='distributed' requires a mesh")
        if max_wedge_chunk is not None and max_wedge_chunk < 1:
            raise ValueError("max_wedge_chunk must be positive")
        self.device = mesh_device(mesh, device)
        self.method = method
        self.max_wedge_chunk = max_wedge_chunk
        self.widths = tuple(widths)
        self.mesh = mesh
        self.shorter_side = shorter_side
        self.tuner = tuner
        self.last_stats: EngineStats | None = None

    # -- public API ---------------------------------------------------------

    def count(self, edges, n_nodes: int | None = None) -> int:
        """Exact global triangle count.

        ``edges`` may be a canonical edge array, a pre-built
        :class:`OrientedCSR`, or a cached undirected/compressed CSR.
        """
        self.last_stats = None
        with obs.span("engine.count", cat="engine"):
            csr, prep_s = self._prepare_timed(edges, n_nodes)
            if csr is None:
                return 0
            return self._run(csr, "count", prep_s)

    def per_node(self, edges, n_nodes: int | None = None) -> np.ndarray:
        """Per-vertex triangle incidences, int64 host array."""
        self.last_stats = None
        with obs.span("engine.per_node", cat="engine"):
            csr, prep_s = self._prepare_timed(edges, n_nodes)
            if csr is None:
                n = n_nodes if n_nodes is not None else getattr(edges, "n_nodes", 0) or 0
                return np.zeros((n,), np.int64)
            return self._run(csr, "per_node", prep_s)

    def edge_support(self, edges, n_nodes: int | None = None) -> np.ndarray:
        """Per-directed-edge triangle support, int64 host array.

        Aligned with the oriented CSR's ``(src, col)`` edge list; the sum
        is exactly ``3 × count``.
        """
        self.last_stats = None
        with obs.span("engine.support", cat="engine"):
            csr, prep_s = self._prepare_timed(edges, n_nodes)
            if csr is None:
                return np.zeros((0,), np.int64)
            return self._run(csr, "support", prep_s)

    def clustering(self, edges, n_nodes: int | None = None) -> np.ndarray:
        """Local clustering coefficients c(v) = 2·T(v) / (deg(v)·(deg(v)−1))."""
        from repro_torch.analytics.metrics import clustering_from_counts

        with obs.span("engine.clustering", cat="engine"):
            with obs.span("engine.degrees", cat="engine"):
                deg, n_nodes = degree_histogram(edges, n_nodes)
            if deg.size == 0:
                return np.zeros((n_nodes,), np.float64)
            tri = self.per_node(edges, n_nodes)
            with obs.span("engine.lcc_finish", cat="engine"):
                return clustering_from_counts(tri, deg)

    def transitivity(self, edges, n_nodes: int | None = None) -> float:
        """Global transitivity ratio 3·#triangles / #wedges."""
        from repro_torch.analytics.metrics import transitivity_from_counts

        deg, n_nodes = degree_histogram(edges, n_nodes)
        if deg.size == 0:
            return 0.0
        t = self.count(edges, n_nodes)
        return transitivity_from_counts(t, deg)

    # -- shared plumbing ----------------------------------------------------

    def _prepare_timed(self, edges, n_nodes: int | None):
        """``(_prepare result, preprocess seconds)`` under a span."""
        t0 = time.perf_counter()
        with obs.span("engine.preprocess", cat="engine"):
            csr = self._prepare(edges, n_nodes)
        return csr, time.perf_counter() - t0

    def _prepare(self, edges, n_nodes: int | None) -> OrientedCSR | None:
        if isinstance(edges, OrientedCSR) and edges.device != self.device:
            raise ValueError(
                f"OrientedCSR lies on {edges.device} but the counter runs on {self.device}"
            )
        csr = prepare_oriented(edges, n_nodes, device=self.device)
        if csr is not None:
            return csr
        # empty graph: nothing to resolve "auto" against
        resolved = self.method if self.method != "auto" else "wedge_bsearch"
        self.last_stats = EngineStats(
            method=resolved, resolved_method=resolved, n_chunks=0,
            peak_wedge_buffer=0, wedge_budget=self.max_wedge_chunk,
            total_wedges=0, n_directed_edges=0,
        )
        return None

    def _resolve(self, csr: OrientedCSR) -> str:
        return resolve_method(
            self.method, csr.out_degree, mesh=self.mesh, widths=self.widths,
            backend=self.device.type,
        )

    def _run(self, csr: OrientedCSR, kind: str, prep_s: float = 0.0):
        """Resolve the method, build the workload and run it, each phase a span."""
        with obs.span("engine.resolve", cat="engine"):
            resolved = self._resolve(csr)
            backend, executed, reason = resolve_backend(
                resolved, kind, widths=self.widths, tuner=self.tuner,
                mesh=self.mesh, shorter_side=self.shorter_side,
            )
        with obs.span("engine.workload", cat="engine"):
            work = workload_from_csr(csr)
        value, plan = run_workload(
            backend, kind, work,
            budget=self.max_wedge_chunk,
            n_out=csr.n_nodes if kind == "per_node" else None,
        )
        self.last_stats = EngineStats(
            method=executed,
            resolved_method=resolved,
            n_chunks=plan.n_chunks,
            peak_wedge_buffer=plan.peak_buffer,
            wedge_budget=self.max_wedge_chunk,
            total_wedges=plan.total_wedges,
            n_directed_edges=csr.n_directed_edges,
            fallback_reason=reason,
            n_stripes=plan.n_stripes,
            timings={"preprocess": prep_s, **(plan.timings or {})},
            **_stripe_stats(plan.stripe_loads, plan.stripe_times),
        )
        return value
