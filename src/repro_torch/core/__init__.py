"""Core library of the port: the paper's parallel *forward* algorithm.

Public API::

    from repro_torch.core import TriangleCounter, count_triangles

    tc = TriangleCounter(method="auto", max_wedge_chunk=1 << 22)  # on the card
    t = tc.count(edge_array)                                     # exact
    t = count_triangles(edge_array, method="pallas", device="cpu")
    est = count_triangles_doulion(edge_array, p=0.25, seed=0)      # DOULION
    inc = IncrementalTriangleCounter(edge_array, method="pallas")  # streaming
    inc.insert(new_edges); inc.delete(old_edges)                  # exact deltas
    tuner = AutoTuner("tiles.json", tune_on_miss=True)             # §III-D5 sweep
    TriangleCounter(method="pallas", tuner=tuner).count(edge_array)
    mesh = Mesh(["cuda"] * 4)                                      # §III-E stripes
    t = TriangleCounter(method="distributed", mesh=mesh).count(edge_array)
    t = count_triangles_distributed(edge_array, mesh)

``Mesh`` is :class:`repro_torch.distributed.Mesh`; a mesh may repeat a
device.  Only the ported names are exported.
"""
from .preprocess import (
    OrientedCSR,
    preprocess,
    preprocess_host_offload,
    oriented_from_undirected_csr,
    oriented_from_compressed,
    degrees,
)
from .engine import (
    TriangleCounter,
    EngineStats,
    choose_method,
    resolve_method,
    plan_edge_chunks,
    accumulate_partials,
    prepare_oriented,
    degree_histogram,
    search_steps,
    next_pow2,
    iter_wedge_chunks,
    chunk_count_kernel,
    chunk_per_node_kernel,
    chunk_support_kernel,
    KernelBackend,
    WedgeBackend,
    PanelBackend,
    PallasBackend,
    DistributedBackend,
    register_backend,
    make_backend,
    resolve_backend,
    make_workload,
    workload_from_csr,
    run_workload,
)
from .approx import count_triangles_doulion
from .distributed import (
    stripe_edges,
    plan_striped_chunks,
    make_distributed_count_fn,
    count_triangles_distributed,
    count_triangles_distributed_csr,
)
from .tuning import AutoTuner, TileCache
from .incremental import IncrementalTriangleCounter, UpdateStats
from .count import (
    WedgePlan,
    make_wedge_plan,
    count_wedges_found,
    count_triangles_csr,
    count_triangles,
    per_node_triangles,
    bucketize_edges,
    gather_panels,
    panel_intersect_count,
)
from .clustering import (
    local_clustering_coefficient,
    average_clustering_coefficient,
    transitivity,
    node_triangle_features,
)
from .baseline import (
    count_triangles_sequential,
    count_triangles_numpy,
    count_triangles_bruteforce,
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
    "make_workload",
    "workload_from_csr",
    "run_workload",
    "count_triangles_doulion",
    "stripe_edges",
    "plan_striped_chunks",
    "make_distributed_count_fn",
    "count_triangles_distributed",
    "count_triangles_distributed_csr",
    "AutoTuner",
    "TileCache",
    "IncrementalTriangleCounter",
    "UpdateStats",
    "OrientedCSR",
    "preprocess",
    "preprocess_host_offload",
    "oriented_from_undirected_csr",
    "oriented_from_compressed",
    "degrees",
    "WedgePlan",
    "make_wedge_plan",
    "count_wedges_found",
    "count_triangles_csr",
    "count_triangles",
    "per_node_triangles",
    "bucketize_edges",
    "gather_panels",
    "panel_intersect_count",
    "local_clustering_coefficient",
    "average_clustering_coefficient",
    "transitivity",
    "node_triangle_features",
    "count_triangles_sequential",
    "count_triangles_numpy",
    "count_triangles_bruteforce",
]
