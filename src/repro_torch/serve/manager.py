"""Multi-graph residency: LRU-evicted ``.tricsr``/``.tricsrz`` graphs under a byte budget.

The PyTorch counterpart of ``repro.serve.manager``: the same names and
residency rules over the port's graph loader.  The resident graphs are
host memory maps; each engine pass uploads what it needs to its device.
``device=`` (``None``: the card) is where the shared tuner measures and
what its cache's tag names.

A service instance hosts many tenants' graphs but the machine hosts one
address space.  The manager keeps each attached graph's memory-mapped
CSR resident only while it earns its keep: graphs load lazily on first
lease (through :func:`repro_torch.graphs.io.resolve_to_csr`, so the `.tricsr`
binary cache absorbs the parse cost), every lease bumps recency, and
admitting a graph that would push the resident set past
``memory_budget_bytes`` evicts least-recently-used *unpinned* graphs
first.  Eviction drops only the mmap — the `.tricsr` file stays on
disk, so re-admission is an ``mmap()`` away, and a lease pins its graph
for exactly the duration of the dispatch executing against it.

The manager also owns the service's single shared
:class:`repro_torch.core.tuning.AutoTuner`: every engine the dispatchers
build consults (and feeds) one tile cache, so a shape tuned while
serving tenant A is a cache hit when tenant B's graph launches the same
pow2 bucket.  The cache file itself is concurrency-safe (read-merge-
write in :meth:`TileCache.save`), so multiple service processes can
share it too.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Mapping

import numpy as np

from repro_torch import obs
from repro_torch.core.tuning import AutoTuner
from repro_torch.graphs.io import resolve_to_csr

__all__ = ["GraphEntry", "GraphManager"]


class GraphEntry:
    """One attached graph: its source spec plus residency bookkeeping."""

    __slots__ = ("name", "source", "options", "csr", "meta", "nbytes",
                 "pins", "last_used", "n_loads")

    def __init__(self, name: str, source, options: dict):
        self.name = name
        self.source = source
        self.options = options
        self.csr = None          # CSRGraph while resident, else None
        self.meta: dict | None = None  # provenance from resolve_to_csr
        self.nbytes = 0
        self.pins = 0
        self.last_used = 0
        self.n_loads = 0

    @property
    def resident(self) -> bool:
        return self.csr is not None


def _resident_nbytes(csr) -> int:
    """Bytes this graph actually holds resident, not its logical CSR size.

    A :class:`~repro_torch.graphs.io.CompressedCSR` reports materialized
    metadata plus the compressed payload (``resident_nbytes()``) —
    charging its *decompressed* size would evict neighbors to make room
    for memory that is never allocated (and ``.col`` does not even exist
    on the compressed form).  Flat CSRs are charged by their array
    buffers, which for the mmap path is the mapped region the page cache
    can fault in.
    """
    fn = getattr(csr, "resident_nbytes", None)
    if callable(fn):
        return int(fn())
    return int(np.asarray(csr.row_offsets).nbytes + np.asarray(csr.col).nbytes)


class _Lease:
    """Context manager pinning one entry for the duration of a dispatch."""

    __slots__ = ("_mgr", "entry")

    def __init__(self, mgr: "GraphManager", entry: GraphEntry):
        self._mgr = mgr
        self.entry = entry

    def __enter__(self) -> GraphEntry:
        return self.entry

    def __exit__(self, *exc):
        self._mgr._unpin(self.entry)
        return False


class GraphManager:
    """Attached-graph table with LRU residency under a memory budget.

    ``memory_budget_bytes=None`` disables eviction (everything stays
    resident); ``max_resident`` optionally bounds the *count* of
    resident graphs regardless of bytes.  Pinned graphs (an active
    lease) are never evicted — if every resident graph is pinned the
    budget overshoots rather than failing the query, and the
    ``serve.budget_overcommit`` counter records that the budget was too
    tight for the offered concurrency.
    """

    def __init__(
        self,
        cache_dir: str | os.PathLike = ".tricsr-cache",
        *,
        memory_budget_bytes: int | None = None,
        max_resident: int | None = None,
        allow_download: bool | None = None,
        tile_cache_path: str | os.PathLike | None = None,
        tune_on_miss: bool = False,
        device=None,
    ):
        if memory_budget_bytes is not None and memory_budget_bytes < 1:
            raise ValueError("memory_budget_bytes must be >= 1 (or None)")
        if max_resident is not None and max_resident < 1:
            raise ValueError("max_resident must be >= 1 (or None)")
        self.cache_dir = os.fspath(cache_dir)
        self.memory_budget_bytes = memory_budget_bytes
        self.max_resident = max_resident
        self.allow_download = allow_download
        self.tuner = AutoTuner(tile_cache_path, tune_on_miss=tune_on_miss, device=device)
        self._entries: dict[str, GraphEntry] = {}
        self._lock = threading.RLock()
        self._clock = itertools.count(1)

    # -- attachment ----------------------------------------------------------

    def attach(
        self,
        name: str,
        source,
        *,
        fallback_scale: int | None = None,
        max_chunk_edges: int | None = None,
        storage: str | None = None,
        order: str | None = None,
    ) -> GraphEntry:
        """Register a graph under ``name``; loading is deferred to first lease.

        ``source`` is anything :func:`resolve_to_csr` accepts — a dataset
        registry name or an edge-list path.  ``storage="compressed"``
        (optionally with ``order`` natural/degree/bfs) loads the graph
        as a block-decoding ``.tricsrz`` :class:`CompressedCSR`, whose
        residency cost is its compressed payload — the budget charges
        what is actually held, so tenants on compressed graphs pack
        several-fold denser than their flat footprint would allow.
        Re-attaching an existing name with the same source is a no-op;
        with a different source it is an error (evict/detach first).
        """
        with self._lock:
            ent = self._entries.get(name)
            if ent is not None:
                if ent.source != source:
                    raise ValueError(
                        f"graph {name!r} already attached to {ent.source!r}"
                    )
                return ent
            opts = {}
            if fallback_scale is not None:
                opts["fallback_scale"] = fallback_scale
            if max_chunk_edges is not None:
                opts["max_chunk_edges"] = max_chunk_edges
            if storage is not None:
                opts["storage"] = storage
            if order is not None:
                opts["order"] = order
            ent = GraphEntry(name, source, opts)
            self._entries[name] = ent
            return ent

    def detach(self, name: str) -> None:
        with self._lock:
            ent = self._entries.pop(name, None)
            if ent is not None and ent.pins:
                self._entries[name] = ent
                raise RuntimeError(f"graph {name!r} has {ent.pins} active lease(s)")

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def resident_names(self) -> list[str]:
        with self._lock:
            return sorted(n for n, e in self._entries.items() if e.resident)

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if e.resident)

    # -- residency -----------------------------------------------------------

    def lease(self, name: str) -> _Lease:
        """Pin ``name`` resident and return a context-manager lease.

        Loads the CSR if evicted/never-loaded (evicting LRU victims
        first to make room), bumps recency, and increments the pin
        count; exiting the lease unpins.
        """
        with self._lock:
            ent = self._entries.get(name)
            if ent is None:
                raise KeyError(f"graph {name!r} is not attached")
            if not ent.resident:
                self._load(ent)
            else:
                obs.counter("serve.graph_hits").add()
            ent.last_used = next(self._clock)
            ent.pins += 1
            return _Lease(self, ent)

    def _unpin(self, ent: GraphEntry) -> None:
        with self._lock:
            ent.pins = max(ent.pins - 1, 0)

    def _load(self, ent: GraphEntry) -> None:
        # resolve outside any budget math first: we need nbytes to budget
        with obs.span("serve.graph_load", cat="serve", args={"graph": ent.name}):
            csr, meta = resolve_to_csr(
                ent.source,
                self.cache_dir,
                allow_download=self.allow_download,
                **ent.options,
            )
        nbytes = _resident_nbytes(csr)
        self._make_room(nbytes)
        ent.csr, ent.meta, ent.nbytes = csr, meta, nbytes
        ent.n_loads += 1
        obs.counter("serve.graph_loads").add()

    def _make_room(self, incoming_nbytes: int) -> None:
        """Evict LRU unpinned residents until ``incoming_nbytes`` fits."""
        def over_budget() -> bool:
            resident = [e for e in self._entries.values() if e.resident]
            if self.max_resident is not None and len(resident) + 1 > self.max_resident:
                return True
            if self.memory_budget_bytes is None:
                return False
            return sum(e.nbytes for e in resident) + incoming_nbytes > self.memory_budget_bytes

        while over_budget():
            victims = sorted(
                (e for e in self._entries.values() if e.resident and not e.pins),
                key=lambda e: e.last_used,
            )
            if not victims:
                obs.counter("serve.budget_overcommit").add()
                return
            self._evict(victims[0])

    def _evict(self, ent: GraphEntry) -> None:
        ent.csr = None
        ent.nbytes = 0
        obs.counter("serve.graph_evictions").add()

    def evict(self, name: str) -> bool:
        """Explicitly drop ``name``'s mmap (False if pinned/not resident)."""
        with self._lock:
            ent = self._entries.get(name)
            if ent is None or not ent.resident or ent.pins:
                return False
            self._evict(ent)
            return True

    # -- introspection -------------------------------------------------------

    def stats(self) -> Mapping[str, object]:
        with self._lock:
            return {
                "attached": len(self._entries),
                "resident": sum(e.resident for e in self._entries.values()),
                "resident_bytes": sum(
                    e.nbytes for e in self._entries.values() if e.resident
                ),
                "memory_budget_bytes": self.memory_budget_bytes,
                "graphs": {
                    n: {
                        "resident": e.resident,
                        "nbytes": e.nbytes,
                        "pins": e.pins,
                        "loads": e.n_loads,
                    }
                    for n, e in sorted(self._entries.items())
                },
            }
