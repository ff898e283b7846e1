"""CUDA kernel family for the triangle-counting intersection hot spot.

Importing this package needs neither ``nvcc`` nor a card: the kernel
library is built and loaded inside the first launch.
"""
from . import ops, ref
from .triangle_count import (
    intersect_count_csr_cuda,
    intersect_count_cuda,
    intersect_per_node_csr_cuda,
    intersect_per_node_cuda,
    intersect_support_csr_cuda,
    intersect_support_cuda,
    launches,
    reset_launches,
)

__all__ = [
    "ops",
    "ref",
    "intersect_count_cuda",
    "intersect_count_csr_cuda",
    "intersect_per_node_cuda",
    "intersect_per_node_csr_cuda",
    "intersect_support_cuda",
    "intersect_support_csr_cuda",
    "launches",
    "reset_launches",
]
