"""Graph analytics of the port: for now the clustering formulas."""
from .metrics import clustering_from_counts, profile_from_counts, transitivity_from_counts

__all__ = ["clustering_from_counts", "profile_from_counts", "transitivity_from_counts"]
