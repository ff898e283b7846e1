"""``count`` jobs: the exact global triangle count of the graph.

Compared exactly: the largest gap between a job's count and the
reference's over the jobs, limit 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tcbench.reference import triangles

LIMITS = {"count_max_abs_diff": 0}


def run(counter, graph):
    return counter.count(graph.edges, graph.n_nodes)


def reference(oriented, dtype=torch.int64):
    total, _ = triangles(oriented, per_node=False, dtype=dtype)
    return total.item()


def in_generated_ids(answer, perm):
    return answer  # a count does not depend on the ids


def result_values(graph) -> int:
    return 1


def _gap(answer, ref) -> float:
    if isinstance(answer, (bool, np.bool_)):
        return math.inf
    if isinstance(answer, (int, np.integer)):
        return float(abs(int(answer) - int(ref)))
    if isinstance(answer, (float, np.floating)) and math.isfinite(answer):
        return abs(float(answer) - float(ref))
    return math.inf


def compare(answers, ref) -> dict:
    return {"count_max_abs_diff": max((_gap(a, ref) for a in answers), default=math.inf)}
