"""Out-of-core graph ingestion: parsers, external canonicalization, CSR cache.

The paper's evaluation graphs (Table I) are on-disk SNAP edge lists far
larger than the raw-edge working set :func:`repro_torch.graphs.canonicalize_edges`
assumes fits in RAM.  This package provides the bounded-memory path from a
file to the engine:

``parsers``
    Chunked streaming parsers for SNAP-style text edge lists (comments,
    whitespace/tab separators, optional gzip) and MatrixMarket coordinate
    files.  Peak host memory is bounded by ``max_chunk_edges``.
``external``
    External-memory canonicalization: per-chunk packed-key dedup (the
    §III-D2 64-bit sort trick), sorted runs spilled to disk, k-way merge
    back into the canonical edge array.
``cache``
    The versioned ``.tricsr`` binary CSR cache — parse/canonicalize once,
    memory-map on every later load — plus per-stripe slab views
    (``.tricsr.stripe{k}of{N}``) so each device of a §III-E mesh memmaps
    only its node-range slab.
``codec``
    The compressed ``.tricsrz`` variant: delta + varint neighbor blocks
    behind a block index (decode individual node ranges on demand), with
    degree-descending / BFS locality relabeling recorded in the header so
    per-node results map back through the inverse permutation.
``registry``
    Named datasets (the paper's Table I graphs) with URLs, checksums and
    deterministic Kronecker/R-MAT fallbacks of matching scale for offline
    CI.
``ingest``
    The orchestrator tying the above together behind one call.
"""
from .parsers import (
    iter_edge_chunks,
    parse_edge_file,
    sniff_format,
    DEFAULT_CHUNK_EDGES,
)
from .external import canonicalize_edges_external, ExternalSortStats
from .cache import (
    CSRGraph,
    CSRStripe,
    save_tricsr,
    load_tricsr,
    plan_csr_stripes,
    stripe_path,
    save_tricsr_stripes,
    load_tricsr_stripe,
    load_tricsr_stripes,
    assemble_stripes,
    TRICSR_MAGIC,
    TRICSR_VERSION,
    TRISLB_MAGIC,
    CacheError,
)
from .codec import (
    CompressedCSR,
    ORDERINGS,
    TRICSRZ_MAGIC,
    TRICSRZ_VERSION,
    csr_stripes_from_compressed,
    load_tricsrz,
    load_tricsrz_stripe,
    order_permutation,
    relabel_csr,
    save_tricsrz,
)
from .ingest import ingest, cache_path_for, IngestStats, STORAGES
from .registry import (
    Dataset,
    DATASETS,
    get_dataset,
    materialize_dataset,
    resolve_to_csr,
)

__all__ = [
    "iter_edge_chunks",
    "parse_edge_file",
    "sniff_format",
    "DEFAULT_CHUNK_EDGES",
    "canonicalize_edges_external",
    "ExternalSortStats",
    "CSRGraph",
    "CSRStripe",
    "save_tricsr",
    "load_tricsr",
    "plan_csr_stripes",
    "stripe_path",
    "save_tricsr_stripes",
    "load_tricsr_stripe",
    "load_tricsr_stripes",
    "assemble_stripes",
    "TRICSR_MAGIC",
    "TRICSR_VERSION",
    "TRISLB_MAGIC",
    "CacheError",
    "CompressedCSR",
    "ORDERINGS",
    "TRICSRZ_MAGIC",
    "TRICSRZ_VERSION",
    "csr_stripes_from_compressed",
    "load_tricsrz",
    "load_tricsrz_stripe",
    "order_permutation",
    "relabel_csr",
    "save_tricsrz",
    "ingest",
    "cache_path_for",
    "IngestStats",
    "STORAGES",
    "Dataset",
    "DATASETS",
    "get_dataset",
    "materialize_dataset",
    "resolve_to_csr",
]
