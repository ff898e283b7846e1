"""Ingest orchestrator: file → (cached) canonical CSR, bounded memory.

``ingest(path)`` is the one call the launchers use: it checks the
``.tricsr`` cache (keyed on source identity + format version), and on a
miss streams the file through the chunked parser and external
canonicalization, builds the undirected CSR, writes the cache, and
returns the loaded (memory-mapped) :class:`CSRGraph` plus an
:class:`IngestStats` record saying which of that actually happened.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch import obs

from ..formats import csr_from_forward_pairs, edge_array_to_csr
from .cache import CSRGraph, CacheError, TRICSR_VERSION, load_tricsr, save_tricsr
from .codec import ORDERINGS, load_tricsrz, save_tricsrz
from .external import ExternalSortStats, canonicalize_edges_external
from .parsers import DEFAULT_CHUNK_EDGES, iter_edge_chunks

__all__ = [
    "ingest",
    "cache_path_for",
    "IngestStats",
    "csr_from_edge_array",
    "STORAGES",
]

STORAGES = ("flat", "compressed")


def _check_storage_order(storage: str, order: str) -> None:
    if storage not in STORAGES:
        raise ValueError(f"unknown storage {storage!r}; known: {STORAGES}")
    if order not in ORDERINGS:
        raise ValueError(f"unknown ordering {order!r}; known: {ORDERINGS}")
    if storage == "flat" and order != "natural":
        raise ValueError(
            "order != 'natural' requires storage='compressed' — the flat "
            ".tricsr has nowhere to record the inverse permutation, so "
            "per-node results could not be mapped back to original ids"
        )


@dataclasses.dataclass
class IngestStats:
    """Provenance of one :func:`ingest` call.

    ``cache_hit`` means the ``.tricsr`` was loaded and **no parsing
    happened at all** (``raw_edges == 0``); the CI smoke and the
    out-of-core oracle test key off this.
    """

    source: str
    cache_path: str | None
    cache_hit: bool
    source_kind: str = "file"   # "file" | "download" | "fallback" (set by registry)
    storage: str = "flat"       # "flat" (.tricsr) | "compressed" (.tricsrz)
    order: str = "natural"      # node ordering baked into the cache
    cache_bytes: int = 0        # on-disk size of the cache file (0 if uncached)
    raw_edges: int = 0
    unique_edges: int = 0
    spill_runs: int = 0
    parse_s: float = 0.0        # parse + canonicalize (0 on hit)
    csr_build_s: float = 0.0
    cache_write_s: float = 0.0
    load_s: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def cache_path_for(
    path: str | os.PathLike,
    cache_dir: str | os.PathLike,
    *,
    storage: str = "flat",
    order: str = "natural",
) -> str:
    """Cache file path for ``path``: name + source-identity digest.

    The digest covers absolute path, size, and mtime_ns (ccache-style
    sloppy identity — content hashing a multi-GB edge list would cost the
    parse we are trying to skip) plus the ``.tricsr`` format version
    **and the storage format / node ordering**: a degree-relabeled
    ``.tricsrz`` and a flat natural-order ``.tricsr`` of the same source
    are different artifacts and must never collide on one cache path, or
    a stale load would hand back the wrong ids.  Touching or replacing
    the source, or upgrading the format, misses cleanly instead of
    serving a stale CSR.
    """
    _check_storage_order(storage, order)
    src = os.path.abspath(os.fspath(path))
    st = os.stat(src)
    ident = (
        f"{src}\x00{st.st_size}\x00{st.st_mtime_ns}\x00v{TRICSR_VERSION}"
        f"\x00{storage}\x00{order}"
    )
    digest = hashlib.sha256(ident.encode()).hexdigest()[:16]
    stem = os.path.basename(src)
    for ext in (".gz", ".txt", ".mtx", ".el", ".edges", ".edgelist", ".tsv", ".csv", ".snap"):
        if stem.endswith(ext):
            stem = stem[: -len(ext)]
    suffix = ".tricsrz" if storage == "compressed" else ".tricsr"
    return os.path.join(os.fspath(cache_dir), f"{stem}-{digest}{suffix}")


def csr_from_edge_array(edges: np.ndarray) -> CSRGraph:
    """Undirected canonical CSR of a canonical edge array.

    Canonical arrays are a forward block (sorted by packed key) followed
    by its mirror, so the sort-free ``csr_from_forward_pairs`` build
    applies — no 2m-row lexsort, which matters at the SNAP scales this
    pipeline ingests.
    """
    edges = np.asarray(edges)
    n_nodes = int(edges.max()) + 1 if edges.size else 0
    m = edges.shape[0] // 2
    lo = edges[:m, 0].astype(np.int64)
    hi = edges[:m, 1].astype(np.int64)
    key = lo << np.int64(32) | hi
    if m == 0 or ((lo < hi).all() and (np.diff(key) > 0).all()):
        # forward half is sorted-unique (lo, hi) pairs — the layout both
        # canonicalization pipelines emit — which fully determines the
        # edge set; a canonical array in any other row order (still valid
        # per validate_edge_array) takes the general lexsort path below
        row, col = csr_from_forward_pairs(lo, hi, n_nodes)
    else:
        row, col = edge_array_to_csr(edges, n_nodes)
    return CSRGraph(np.asarray(row, np.int64), np.asarray(col, np.int32), n_nodes)


def ingest(
    path: str | os.PathLike,
    *,
    cache_dir: str | os.PathLike | None = None,
    max_chunk_edges: int = DEFAULT_CHUNK_EDGES,
    fmt: str | None = None,
    spill_dir: str | os.PathLike | None = None,
    mmap: bool = True,
    storage: str = "flat",
    order: str = "natural",
):
    """Load ``path`` as a canonical CSR, through the cache when possible.

    With ``cache_dir`` set, a valid cache for the current source identity
    short-circuits everything (``stats.cache_hit``); otherwise the file
    is parsed in ``max_chunk_edges`` blocks, canonicalized out-of-core
    (spilling sorted runs next to the cache, or ``spill_dir``), converted
    to CSR, and written back to the cache atomically.

    ``storage="flat"`` (default) returns a memory-mapped
    :class:`CSRGraph` off a ``.tricsr``; ``storage="compressed"`` writes
    a delta/varint ``.tricsrz`` relabeled by ``order``
    (natural/degree/bfs) and returns a
    :class:`~repro_torch.graphs.io.CompressedCSR` whose neighbor blocks decode
    on demand — the engine accepts either directly.
    """
    _check_storage_order(storage, order)
    src = os.path.expanduser(os.fspath(path))
    if not os.path.isfile(src):
        raise FileNotFoundError(
            f"edge list not found: {src!r} (pass a SNAP-style text or "
            "MatrixMarket file, optionally .gz-compressed)"
        )
    compressed = storage == "compressed"
    if compressed and cache_dir is None:
        raise ValueError(
            "storage='compressed' requires a cache_dir: the .tricsrz file "
            "is the artifact the block-decoding CompressedCSR reads from"
        )
    load_cache = (
        (lambda p, verify=False: load_tricsrz(p, mmap=mmap, verify=verify))
        if compressed
        else (lambda p, verify=False: load_tricsr(p, mmap=mmap, verify=verify))
    )
    cache_path = None
    if cache_dir is not None:
        cache_dir = os.path.expanduser(os.fspath(cache_dir))
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = cache_path_for(src, cache_dir, storage=storage, order=order)
        if os.path.exists(cache_path):
            t0 = time.perf_counter()
            try:
                with obs.span("ingest.cache_load", cat="io",
                              args={"path": os.path.basename(cache_path)}):
                    csr = load_cache(cache_path)
            except CacheError:
                pass  # stale/corrupt cache: fall through and rebuild
            else:
                obs.counter("io.tricsr_cache_hits").add()
                stats = IngestStats(source=src, cache_path=cache_path,
                                    cache_hit=True, storage=storage, order=order,
                                    cache_bytes=os.path.getsize(cache_path),
                                    load_s=time.perf_counter() - t0)
                stats.unique_edges = csr.n_edges
                return csr, stats
        obs.counter("io.tricsr_cache_misses").add()

    # Spill sorted runs onto real disk — next to the cache, else next to
    # the source file: the system temp dir is often RAM-backed tmpfs,
    # which would turn "out-of-core" runs back into host memory — the
    # failure this subsystem exists to avoid.  An explicit spill_dir
    # always wins; an unwritable location falls back to the system temp.
    own_spill = None
    if spill_dir is None:
        for parent in (cache_dir, os.path.dirname(src) or "."):
            if parent is None:
                continue
            try:
                own_spill = tempfile.mkdtemp(prefix="spill-", dir=parent)
            except OSError:
                continue
            spill_dir = own_spill
            break

    ext_stats = ExternalSortStats()
    t0 = time.perf_counter()
    try:
        with obs.span("ingest.parse", cat="io",
                      args={"path": os.path.basename(src)}):
            edges = canonicalize_edges_external(
                iter_edge_chunks(src, max_chunk_edges, fmt=fmt),
                max_chunk_edges=max_chunk_edges,
                spill_dir=spill_dir,
                stats_out=ext_stats,
            )
    finally:
        if own_spill is not None:
            shutil.rmtree(own_spill, ignore_errors=True)
    parse_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    with obs.span("ingest.csr_build", cat="io",
                  args={"edges": int(edges.shape[0])}):
        csr = csr_from_edge_array(edges)
    csr_build_s = time.perf_counter() - t0

    cache_write_s = 0.0
    cache_bytes = 0
    if cache_path is not None:
        t0 = time.perf_counter()
        with obs.span("ingest.cache_write", cat="io",
                      args={"storage": storage, "order": order}):
            if compressed:
                save_tricsrz(cache_path, csr, order=order)
            else:
                save_tricsr(cache_path, csr)
        cache_write_s = time.perf_counter() - t0
        cache_bytes = os.path.getsize(cache_path)
        # reload through the cache so callers hold the mmap, not the heap copy
        csr = load_cache(cache_path, verify=True)

    return csr, IngestStats(
        source=src,
        cache_path=cache_path,
        cache_hit=False,
        storage=storage,
        order=order,
        cache_bytes=cache_bytes,
        raw_edges=ext_stats.raw_edges,
        unique_edges=ext_stats.unique_edges,
        spill_runs=ext_stats.spill_runs,
        parse_s=parse_s,
        csr_build_s=csr_build_s,
        cache_write_s=cache_write_s,
    )
