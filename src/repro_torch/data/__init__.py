"""Deterministic synthetic data pipelines with resumable iterator state
(numpy only: a copy of ``repro.data``)."""
from .synthetic import (
    TokenPipeline,
    din_batch,
    graph_node_features,
    lm_batch,
)

__all__ = ["TokenPipeline", "lm_batch", "din_batch", "graph_node_features"]
