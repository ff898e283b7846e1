"""Incremental triangle counting over edge streams (batched delta updates).

The PyTorch counterpart of ``repro.core.incremental``: the same public
names, arguments, :class:`UpdateStats` and ``state_dict()`` layout, so a
snapshot written by either package restores in the other.

The engine in :mod:`repro_torch.core.engine` is one-shot: canonicalize,
orient, count.  A serving workload over a *changing* graph cannot afford
to recount every edge per update, so :class:`IncrementalTriangleCounter`
maintains the global triangle count and the per-node incidences under
batched ``insert(edges)`` / ``delete(edges)``, touching only the
triangles incident to the updated edges — the batched delta-counting
discipline surveyed by Wang et al. (*A Comparative Study on Exact
Triangle Counting Algorithms on the GPU*, 2018).

How a batch is counted
======================

Let Δ be the batch's undirected edges (deduplicated, self loops dropped,
already-present inserts / never-present deletes filtered out), and let
``G⁻`` / ``G⁺`` be the graph without / with Δ.  A triangle *touched* by
the batch contains ``k ∈ {1, 2, 3}`` Δ-edges, and probing each Δ-edge
``(u, v)`` for common neighbors ``|N(u) ∩ N(v)|`` counts it once per
Δ-edge it contains.  Three probe passes over the same Δ edge list —
against the adjacency of ``G⁺`` (``S⁺``, counts each triangle ``k``
times), of ``G⁻`` (``S⁻``, counts only the ``k = 1`` triangles), and of
Δ alone (``S^Δ``, counts the all-new ``k = 3`` triangles three times) —
pin down the touched-triangle total exactly:

    ΔT  =  S⁻  +  (S⁺ − S⁻ − S^Δ) / 2  +  S^Δ / 3

(the middle term is the ``k = 2`` count; both divisions are exact).  The
identical combination applied to the per-node scatter outputs yields the
per-node incidence delta.  Insertions add ΔT; deletions subtract the same
quantity computed with the roles of ``G⁻``/``G⁺`` swapped.

Every probe pass closes the **delta wedge workload** — ``Σ_{(u,v) ∈ Δ}
min(deg u, deg v)`` candidate slots (shorter-side enumeration) — with the
configured backend's per-node chunk kernel under ``max_wedge_chunk``.
Each hit scatters +1 to exactly three vertices, so the hit total is
``Σ per_node / 3`` from the same launch.  ``"pallas"`` probes run the
per-node CSR kernel of :mod:`repro_torch.kernels.triangle_count` once per
chunk; ``"wedge_bsearch"`` probes run the torch-ops wedge expansion;
``"distributed"`` probes stripe the delta workload over a ``mesh=``
(§III-E) and sum the stripes' per-node partials on its lead device.

Where the state lives
=====================

The maintained state — the sorted packed-key adjacency, the per-node
incidences, the degrees and the count — stays in host numpy, as in the
reference, so ``insert``/``delete``/``state_dict`` are bit-identical to
it.  Each probe builds the adjacency's ``row``/``col`` on the host and
uploads them to the counter's device.

Shape bucketing
===============

The reference pads every probe's shapes to powers of two (the ``col``
tail with ``2**31 − 1``, the node axis, the chunk width and, with no
budget, the wedge buffer) so its jitted kernels reuse a handful of
compiled shapes.  Nothing compiles per shape here, but
``n_probe_launches`` and ``peak_wedge_buffer`` are public, so the same
rules are kept and the stats equal the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.distributed.compression import ensure_fits_int32
from repro_torch.distributed.mesh import mesh_device
from repro_torch.graphs.formats import sorted_unique, validate_node_ids

from .engine import (
    TriangleCounter,
    WedgeChunk,
    _DeviceAdj,
    make_backend,
    make_workload,
    next_pow2 as _next_pow2,
    plan_edge_chunks,
    run_workload,
)

__all__ = ["IncrementalTriangleCounter", "UpdateStats"]

# schedules the probe passes can execute; anything else ("auto") keeps
# the wedge chunk kernels, as in the reference
_PROBE_METHODS = ("wedge_bsearch", "panel", "pallas", "distributed")

_MASK32 = np.int64(0xFFFFFFFF)
_COL_PAD = np.int32(2**31 - 1)  # sorted-tail sentinel; never inside a row


def _pack(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Directed edge key u<<32|v (the §III-D2 packed-key representation)."""
    return u.astype(np.int64) << np.int64(32) | v.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class UpdateStats:
    """What the last ``insert``/``delete`` actually did."""

    op: str                  # "insert" | "delete" | "noop"
    n_batch_edges: int       # undirected edges actually applied (post-filter)
    n_probe_launches: int    # chunk-kernel launches across the three probes
    peak_wedge_buffer: int   # largest wedge buffer materialized per launch
    wedge_budget: int | None  # the configured max_wedge_chunk
    delta: int               # signed change in the global triangle count
    probe_method: str = "wedge_bsearch"  # kernel backend the probes ran


class IncrementalTriangleCounter:
    """Exact triangle counts over a dynamic graph, updated in batches.

    Parameters
    ----------
    edges:
        Optional initial edges (any mix of directions/duplicates; self
        loops dropped), or a cached flat / compressed CSR.  The bootstrap
        count runs through :class:`repro_torch.core.TriangleCounter`, so
        it is memory-bounded exactly like a standalone full count.
    n_nodes:
        Optional node-count floor; the id space also grows automatically
        when a batch introduces larger vertex ids.
    max_wedge_chunk:
        Per-launch wedge-buffer budget (slots) applied to the bootstrap
        *and* to every update batch's probe workload.
    method:
        Engine schedule for the bootstrap count and — when it names one
        of the probe-capable backends (``"wedge_bsearch"``, ``"panel"``,
        ``"pallas"``, ``"distributed"``) — for the three probe passes of
        every update batch as well.  ``"auto"`` keeps the probes on the
        wedge schedule.
    mesh:
        A :class:`repro_torch.distributed.Mesh` for ``method="distributed"``
        (required then; otherwise it reaches only the bootstrap count, as
        in the reference): each probe pass stripes the delta workload
        §III-E-style over it and sums the per-node partials — bit-identical
        to the single-device probes.
    device:
        ``None`` or ``"cuda"`` (the default: raises without a card) or
        ``"cpu"``: where the bootstrap and the probes run; with a mesh,
        ``None`` or its lead device.

    After any update, :attr:`last_update_stats` describes what ran.

    Invariant (the oracle property the tests enforce): after any
    interleaving of ``insert``/``delete`` batches, :attr:`count` equals
    ``TriangleCounter(method="auto").count(self.current_edges())``.
    """

    def __init__(
        self,
        edges=None,
        n_nodes: int | None = None,
        max_wedge_chunk: int | None = None,
        method: str = "auto",
        mesh=None,
        *,
        device=None,
    ):
        if max_wedge_chunk is not None and max_wedge_chunk < 1:
            raise ValueError("max_wedge_chunk must be positive")
        if method == "distributed" and mesh is None:
            raise ValueError(
                "method='distributed' needs a mesh= over the participating "
                "devices"
            )
        self.device = mesh_device(mesh, device)
        self.max_wedge_chunk = max_wedge_chunk
        self.mesh = mesh
        self.probe_method = method if method in _PROBE_METHODS else "wedge_bsearch"
        self._backend = make_backend(self.probe_method, mesh=mesh)
        self._n = int(n_nodes) if n_nodes else 0
        self._adj = np.empty(0, np.int64)  # sorted directed keys, both dirs
        self._count = 0
        self._per_node = np.zeros(self._n, np.int64)
        self._deg = np.zeros(self._n, np.int64)
        self.last_update_stats: UpdateStats | None = None
        if hasattr(edges, "decode_block"):
            # compressed CSR bootstrap: decode once, mapped back to
            # *original* ids, so the caller's insert/delete stream keeps
            # speaking its own node names regardless of the on-disk order
            edges = edges.edge_array(original_ids=True)
        elif hasattr(edges, "edge_array"):
            edges = edges.edge_array()  # cached flat CSRGraph
        if edges is not None and np.asarray(edges).size:
            und = self._normalize_batch(edges)
            if und.shape[0]:
                self._grow(int(und.max()) + 1)
                self._adj = np.sort(
                    np.concatenate([_pack(und[:, 0], und[:, 1]),
                                    _pack(und[:, 1], und[:, 0])])
                )
                np.add.at(self._deg, und[:, 0], 1)
                np.add.at(self._deg, und[:, 1], 1)
                tc = TriangleCounter(
                    method=method, max_wedge_chunk=max_wedge_chunk, mesh=mesh,
                    device=self.device,
                )
                canon = self.current_edges()
                self._count = tc.count(canon, n_nodes=self._n)
                self._per_node = tc.per_node(canon, n_nodes=self._n).astype(np.int64)

    # -- read API (the serving queries) -------------------------------------

    @property
    def count(self) -> int:
        """Current global triangle count (maintained, O(1) to read)."""
        return self._count

    @property
    def n_nodes(self) -> int:
        return self._n

    @property
    def n_edges(self) -> int:
        """Current undirected edge count."""
        return self._adj.shape[0] // 2

    def per_node(self) -> np.ndarray:
        """Per-vertex triangle incidences (maintained, copied out)."""
        return self._per_node.copy()

    def degrees(self) -> np.ndarray:
        """Current undirected degree histogram (maintained, copied out)."""
        return self._deg.copy()

    def clustering(self) -> np.ndarray:
        """Local clustering coefficients from the maintained state."""
        from .clustering import clustering_from_counts

        return clustering_from_counts(self._per_node, self._deg)

    def transitivity(self) -> float:
        """Global transitivity ratio from the maintained state."""
        from .clustering import transitivity_from_counts

        return transitivity_from_counts(self._count, self._deg)

    def current_edges(self) -> np.ndarray:
        """The live graph as a canonical edge array (both directions)."""
        src = (self._adj >> np.int64(32)).astype(np.int32)
        dst = (self._adj & _MASK32).astype(np.int32)
        return np.stack([src, dst], axis=1)

    # -- snapshot/restore (the serving layer's durability hook) -------------

    def state_dict(self) -> dict[str, np.ndarray]:
        """The complete maintained state as a flat array tree.

        Everything an exact resume needs: the canonical directed-key
        adjacency, the global count, the per-node incidences and the
        degree histogram.  The arrays are copies —
        :class:`repro_torch.checkpoint.CheckpointManager` can write them
        from a background thread while updates keep mutating ``self``.
        """
        return {
            "adj": self._adj.copy(),
            "per_node": self._per_node.copy(),
            "deg": self._deg.copy(),
            "count": np.asarray(self._count, np.int64),
            "n_nodes": np.asarray(self._n, np.int64),
        }

    @classmethod
    def from_state(
        cls,
        state: dict,
        *,
        max_wedge_chunk: int | None = None,
        method: str = "auto",
        mesh=None,
        device=None,
    ):
        """Rebuild a counter from :meth:`state_dict` output, validated.

        The kernel-facing knobs (``max_wedge_chunk``, ``method``,
        ``device``) are *not* part of the state — a snapshot taken by a
        wedge-probe service restores cleanly into a pallas-probe one, and
        one written by the reference restores here.  Cross-field
        consistency is checked (sorted unique adjacency, matching array
        lengths, degrees that re-derive from the adjacency) so a logically
        inconsistent snapshot fails loudly here instead of corrupting
        every later delta.
        """
        n = int(np.asarray(state["n_nodes"]))
        self = cls(
            n_nodes=n or None, max_wedge_chunk=max_wedge_chunk,
            method=method, mesh=mesh, device=device,
        )
        adj = np.array(state["adj"], np.int64, copy=True).reshape(-1)
        per_node = np.array(state["per_node"], np.int64, copy=True).reshape(-1)
        deg = np.array(state["deg"], np.int64, copy=True).reshape(-1)
        count = int(np.asarray(state["count"]))
        if adj.shape[0] % 2:
            raise ValueError("adjacency holds both directions: length must be even")
        if adj.shape[0] and np.any(np.diff(adj) <= 0):
            raise ValueError("adjacency keys must be strictly increasing")
        if per_node.shape[0] != n or deg.shape[0] != n:
            raise ValueError(
                f"per_node/deg length ({per_node.shape[0]}/{deg.shape[0]}) "
                f"!= n_nodes ({n})"
            )
        if count < 0:
            raise ValueError(f"negative triangle count {count}")
        src = (adj >> np.int64(32)).astype(np.int64)
        if adj.shape[0] and (src.min() < 0 or src.max() >= n):
            raise ValueError("adjacency source ids outside [0, n_nodes)")
        rederived = np.bincount(src, minlength=n).astype(np.int64)
        if not np.array_equal(rederived, deg):
            raise ValueError("degree histogram does not match the adjacency")
        self._adj = adj
        self._per_node = per_node
        self._deg = deg
        self._count = count
        return self

    # -- update API ---------------------------------------------------------

    def insert(self, edges) -> int:
        """Insert a batch of undirected edges; returns the count delta (≥ 0).

        Self loops, in-batch duplicates and already-present edges are
        ignored, so inserts are idempotent.
        """
        # never let a failed update leave the previous batch's stats observable
        self.last_update_stats = None
        und = self._normalize_batch(edges)
        und = und[~self._member(und)]
        if und.shape[0] == 0:
            self._record("noop", 0, 0, 0, 0)
            return 0
        self._grow(int(und.max()) + 1)
        delta_dir = np.sort(
            np.concatenate([_pack(und[:, 0], und[:, 1]), _pack(und[:, 1], und[:, 0])])
        )
        adj_new = np.insert(self._adj, np.searchsorted(self._adj, delta_dir), delta_dir)
        d_count, d_pn, launches, peak = self._delta_triangles(
            und, adj_without=self._adj, adj_with=adj_new, adj_delta=delta_dir
        )
        self._adj = adj_new
        self._count += d_count
        self._per_node += d_pn
        np.add.at(self._deg, und[:, 0], 1)
        np.add.at(self._deg, und[:, 1], 1)
        self._record("insert", und.shape[0], launches, peak, d_count)
        return d_count

    def delete(self, edges) -> int:
        """Delete a batch of undirected edges; returns the count delta (≤ 0).

        Edges not currently present (including never-inserted ones) are
        ignored, so deletes are idempotent.
        """
        self.last_update_stats = None
        und = self._normalize_batch(edges)
        und = und[self._member(und)]
        if und.shape[0] == 0:
            self._record("noop", 0, 0, 0, 0)
            return 0
        delta_dir = np.sort(
            np.concatenate([_pack(und[:, 0], und[:, 1]), _pack(und[:, 1], und[:, 0])])
        )
        keep = np.ones(self._adj.shape[0], bool)
        keep[np.searchsorted(self._adj, delta_dir)] = False
        adj_rem = self._adj[keep]
        d_count, d_pn, launches, peak = self._delta_triangles(
            und, adj_without=adj_rem, adj_with=self._adj, adj_delta=delta_dir
        )
        self._adj = adj_rem
        self._count -= d_count
        self._per_node -= d_pn
        np.subtract.at(self._deg, und[:, 0], 1)
        np.subtract.at(self._deg, und[:, 1], 1)
        self._record("delete", und.shape[0], launches, peak, -d_count)
        return -d_count

    def apply(self, insert=None, delete=None) -> int:
        """Apply one stream batch (arrivals first, then evictions)."""
        delta = 0
        if insert is not None and np.asarray(insert).size:
            delta += self.insert(insert)
        if delete is not None and np.asarray(delete).size:
            delta += self.delete(delete)
        return delta

    # -- internals ----------------------------------------------------------

    def _record(self, op, n_batch, launches, peak, delta):
        self.last_update_stats = UpdateStats(
            op=op, n_batch_edges=n_batch, n_probe_launches=launches,
            peak_wedge_buffer=peak, wedge_budget=self.max_wedge_chunk,
            delta=delta, probe_method=self.probe_method,
        )

    def _grow(self, n: int) -> None:
        if n > self._n:
            pad = np.zeros(n - self._n, np.int64)
            self._per_node = np.concatenate([self._per_node, pad])
            self._deg = np.concatenate([self._deg, pad])
            self._n = n

    @staticmethod
    def _normalize_batch(edges) -> np.ndarray:
        """Unique undirected (lo, hi) pairs; self loops and dups dropped."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        validate_node_ids(edges)  # packed-key adjacency wraps outside [0, 2**31)
        edges = edges[edges[:, 0] != edges[:, 1]]
        if edges.shape[0] == 0:
            return np.empty((0, 2), np.int64)
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        keys = sorted_unique(_pack(lo, hi))
        return np.stack([keys >> np.int64(32), keys & _MASK32], axis=1)

    def _member(self, und: np.ndarray) -> np.ndarray:
        """Membership mask of undirected (lo, hi) pairs in the live graph."""
        if und.shape[0] == 0 or self._adj.shape[0] == 0:
            return np.zeros(und.shape[0], bool)
        keys = _pack(und[:, 0], und[:, 1])
        idx = np.searchsorted(self._adj, keys)
        present = np.zeros(und.shape[0], bool)
        inb = idx < self._adj.shape[0]
        present[inb] = self._adj[idx[inb]] == keys[inb]
        return present

    def _delta_triangles(self, und, *, adj_without, adj_with, adj_delta):
        """Touched-triangle total + per-node deltas via the three probes."""
        pu = und[:, 0].astype(np.int32)
        pv = und[:, 1].astype(np.int32)
        probes = int(pu.shape[0])
        with obs.span("probe.without", cat="incremental", args={"edges": probes}):
            s_wo, p_wo, l1, k1 = self._probe(pu, pv, adj_without)
        with obs.span("probe.with", cat="incremental", args={"edges": probes}):
            s_wi, p_wi, l2, k2 = self._probe(pu, pv, adj_with)
        with obs.span("probe.delta", cat="incremental", args={"edges": probes}):
            s_dl, p_dl, l3, k3 = self._probe(pu, pv, adj_delta)
        two_new = s_wi - s_wo - s_dl
        if two_new < 0 or two_new % 2 or s_dl % 3:
            raise RuntimeError(
                f"inconsistent probe totals: S+ {s_wi}, S- {s_wo}, S^delta {s_dl}"
            )
        d_count = s_wo + two_new // 2 + s_dl // 3
        d_pn = p_wo + (p_wi - p_wo - p_dl) // 2 + p_dl // 3
        return d_count, d_pn, l1 + l2 + l3, max(k1, k2, k3)

    def _probe(self, pu, pv, adj):
        """Σ |N(u) ∩ N(v)| over probe edges + its per-node scatter.

        ``adj`` is a sorted directed-key array (the adjacency to close
        wedges against).  Enumerates candidates from the shorter endpoint
        list and closes with the configured kernel backend under the
        ``max_wedge_chunk`` budget.  Returns
        ``(hits, per_node, n_launches, peak_buffer)``.
        """
        n = self._n
        if pu.shape[0] == 0 or adj.shape[0] == 0:
            return 0, np.zeros(n, np.int64), 0, 0
        ensure_fits_int32(adj.shape[0], "probe adjacency size (row offsets)")
        src_k = (adj >> np.int64(32)).astype(np.int64)
        col = (adj & _MASK32).astype(np.int32)
        # node axis pads to a power of two (extra rows are empty), as the
        # reference pads it, so the stats and n_out match its
        n_pad = _next_pow2(n)
        row = np.searchsorted(src_k, np.arange(n_pad + 1, dtype=np.int64)).astype(
            np.int32
        )
        deg = row[1:] - row[:-1]
        # shorter-side enumeration: |N(u) ∩ N(v)| is symmetric, so expand
        # the smaller list and search the larger (§Perf "opt")
        swap = deg[pv] < deg[pu]
        eu = np.where(swap, pv, pu).astype(np.int32)
        ev = np.where(swap, pu, pv).astype(np.int32)
        m_valid = col.shape[0]
        col_pad = _next_pow2(m_valid)
        if col_pad > m_valid:
            col = np.concatenate([col, np.full(col_pad - m_valid, _COL_PAD)])
        if self.probe_method != "wedge_bsearch":
            # panel/pallas/distributed probe: the backend buckets (or
            # stripes) the probe pairs itself and pow2-pads its launch
            # shapes; a pallas chunk is one kernel launch
            work = make_workload(row, col, deg, eu, ev, device=self.device)
            per_node, plan = run_workload(
                self._backend, "per_node", work,
                budget=self.max_wedge_chunk, n_out=n_pad, bucket_pow2=True,
            )
            return self._hits(per_node), per_node[:n], plan.n_chunks, plan.peak_buffer
        reps = deg[eu].astype(np.int64)
        bounds, eff = plan_edge_chunks(reps, self.max_wedge_chunk)
        if self.max_wedge_chunk is None:
            # no budget: the reference rounds the one-shot buffer up
            eff = _next_pow2(eff)
        elif len(bounds) == 1 and eff < self.max_wedge_chunk:
            # the same rounding, capped so the budget stays honored
            eff = min(self.max_wedge_chunk, _next_pow2(eff))
        edges_per_chunk = _next_pow2(max(end - start for start, end in bounds))
        # the padded length bounds every row; overshooting the true
        # ⌈log₂ deg_max⌉ is harmless
        n_steps = max(1, math.ceil(math.log2(col_pad + 1)))
        dev_adj = _DeviceAdj(
            *(torch.from_numpy(a).to(self.device) for a in (row, col, deg)), n_steps
        )
        acc = torch.zeros((n_pad,), dtype=torch.int64, device=self.device)
        for start, end in bounds:
            pad = edges_per_chunk - (end - start)
            s, d = eu[start:end], ev[start:end]
            if pad:
                fill = np.full(pad, -1, np.int32)
                s = np.concatenate([s, fill])
                d = np.concatenate([d, fill])
            acc += self._backend.per_node_chunk(dev_adj, WedgeChunk(s, d, start, eff), n_pad)
        per_node = acc.cpu().numpy()
        return self._hits(per_node), per_node[:n], len(bounds), eff

    @staticmethod
    def _hits(per_node: np.ndarray) -> int:
        """Every hit scatters +1 to exactly u, v and w, so the per-node
        output carries the hit total: one kernel per chunk does both jobs."""
        total = int(per_node.sum(dtype=np.int64))
        if total % 3:
            raise RuntimeError(f"per-node probe total {total} is not a multiple of 3")
        return total // 3
