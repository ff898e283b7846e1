"""``lcc`` jobs: LDBC Graphalytics' local clustering coefficient of every
vertex (undirected), which needs every vertex's triangle count.

Compared exactly: the largest gap between a job's coefficient and the
reference's, over every vertex and every job, limit 0.  Both sides divide
exact integers in float64, so a sound run reads 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tcbench.reference import lcc, triangles

LIMITS = {"lcc_max_abs_diff": 0.0}


def run(counter, graph):
    return counter.clustering(graph.edges, graph.n_nodes)


def reference(oriented, dtype=torch.int64):
    _, counts = triangles(oriented, per_node=True, dtype=dtype)
    return lcc(counts, oriented.degree).cpu().numpy()


def in_generated_ids(answer, perm):
    """Vertex ``v``'s coefficient is the answer's at ``perm[v]``; an answer
    of another shape is left for :func:`compare` to refuse."""
    if perm is None:
        return answer
    answer = np.asarray(answer)
    return answer[perm] if answer.shape == perm.shape else answer


def result_values(graph) -> int:
    return graph.n_nodes


def _gap(answer, ref: np.ndarray) -> float:
    answer = np.asarray(answer)
    if answer.shape != ref.shape or not np.issubdtype(answer.dtype, np.floating):
        return math.inf
    if not ref.size:
        return 0.0
    gap = float(np.max(np.abs(answer.astype(np.float64) - ref.astype(np.float64))))
    return gap if math.isfinite(gap) else math.inf


def compare(answers, ref) -> dict:
    return {"lcc_max_abs_diff": max((_gap(a, ref) for a in answers), default=math.inf)}
