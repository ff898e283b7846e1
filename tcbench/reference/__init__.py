"""The plain reference the benchmark holds the program's answers to."""
from .triangles import Oriented, lcc, orient, triangles

__all__ = ["Oriented", "orient", "triangles", "lcc"]
