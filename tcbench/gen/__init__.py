"""Graph generators of the benchmark, independent of the program under test."""
from .kronecker import Graph, make_graph, make_graphs

__all__ = ["Graph", "make_graph", "make_graphs"]
