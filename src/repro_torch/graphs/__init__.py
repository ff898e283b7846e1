"""Graph data pipeline of the port: generators, formats, edge streams,
on-disk ingestion.

Sampling and batching wait for ROADMAP A8.
"""
from .formats import (
    canonicalize_edges,
    pack_unique_keys,
    unpack_keys_canonical,
    validate_node_ids,
    edge_array_to_csr,
    csr_from_forward_pairs,
    csr_to_edge_array,
    undirected_edge_count,
    validate_edge_array,
    graph_stats,
    stats_from_degrees,
)
from .generators import (
    kronecker_rmat,
    barabasi_albert,
    watts_strogatz,
    erdos_renyi,
    GRAPH_GENERATORS,
)
from .streams import (
    StreamBatch,
    undirected_pairs,
    temporal_edge_stream,
    sliding_window_stream,
    STREAM_GENERATORS,
)
from .io import (
    CSRGraph,
    DATASETS,
    IngestStats,
    canonicalize_edges_external,
    ingest,
    iter_edge_chunks,
    load_tricsr,
    materialize_dataset,
    save_tricsr,
)

__all__ = [
    "canonicalize_edges",
    "pack_unique_keys",
    "unpack_keys_canonical",
    "validate_node_ids",
    "edge_array_to_csr",
    "csr_from_forward_pairs",
    "csr_to_edge_array",
    "undirected_edge_count",
    "validate_edge_array",
    "graph_stats",
    "stats_from_degrees",
    "kronecker_rmat",
    "barabasi_albert",
    "watts_strogatz",
    "erdos_renyi",
    "GRAPH_GENERATORS",
    "StreamBatch",
    "undirected_pairs",
    "temporal_edge_stream",
    "sliding_window_stream",
    "STREAM_GENERATORS",
    "CSRGraph",
    "DATASETS",
    "IngestStats",
    "canonicalize_edges_external",
    "ingest",
    "iter_edge_chunks",
    "load_tricsr",
    "materialize_dataset",
    "save_tricsr",
]
