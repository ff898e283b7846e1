"""Graph-structure analytics on top of the port's triangle-counting engine.

The PyTorch counterpart of ``repro.analytics``: clustering coefficients
and the transitivity ratio (the paper's motivation, §I), per-edge
triangle *support* and *k-truss* decomposition.

``support``
    Chunked per-edge triangle support through the engine's backends
    (``pallas``: the CUDA support kernel that reads the CSR), int32
    device partials and int64 accumulation.
``truss``
    Exact k-truss decomposition by iterative support-peeling on the
    oriented CSR, per-edge trussness and max-k subgraph extraction.
``metrics``
    Local/average clustering, transitivity, degree-binned clustering
    profiles, top-k triangle-dense nodes/edges and the one-stop
    :func:`graph_report`, all routed through
    :class:`repro_torch.core.engine.TriangleCounter`.

NOTE on import order: modules here import ``repro_torch.core.engine``
directly (never the ``repro_torch.core`` package root), so
``repro_torch.core.clustering`` can re-export :mod:`.metrics` without a
cycle.  The ``repro_torch.core`` import below must stay FIRST: when this
package is imported before ``repro_torch.core``, it drives the core
package (and its ``clustering`` → ``analytics.metrics`` hop) to
completion before any submodule here starts loading, so both import
orders work.
"""
import repro_torch.core  # noqa: F401  (see note above — load order matters)

from .support import (
    EdgeSupport,
    SupportRun,
    chunk_support_kernel,
    edge_support,
    support_on_arrays,
)
from .truss import TrussDecomposition, k_truss_decomposition, k_truss_subgraph
from .metrics import (
    average_clustering,
    clustering_from_counts,
    clustering_profile,
    graph_report,
    local_clustering,
    node_triangle_features,
    per_node_triangle_counts,
    profile_from_counts,
    top_support_edges,
    top_triangle_nodes,
    transitivity,
    transitivity_from_counts,
)

__all__ = [
    "EdgeSupport",
    "SupportRun",
    "chunk_support_kernel",
    "edge_support",
    "support_on_arrays",
    "TrussDecomposition",
    "k_truss_decomposition",
    "k_truss_subgraph",
    "average_clustering",
    "clustering_from_counts",
    "clustering_profile",
    "graph_report",
    "local_clustering",
    "node_triangle_features",
    "per_node_triangle_counts",
    "profile_from_counts",
    "top_support_edges",
    "top_triangle_nodes",
    "transitivity",
    "transitivity_from_counts",
]
