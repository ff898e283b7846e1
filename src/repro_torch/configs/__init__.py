"""Architecture registry of the port: ``--arch <id>`` for every launcher."""
from __future__ import annotations

from . import (
    deepseek_coder_33b,
    din,
    egnn,
    gcn_cora,
    granite_moe_3b_a800m,
    graphsage_reddit,
    llama3_2_3b,
    olmoe_1b_7b,
    qwen2_1_5b,
    schnet,
    triangles,
)

ARCH_MODULES = [
    olmoe_1b_7b,
    granite_moe_3b_a800m,
    deepseek_coder_33b,
    llama3_2_3b,
    qwen2_1_5b,
    schnet,
    gcn_cora,
    graphsage_reddit,
    egnn,
    din,
    triangles,
]

REGISTRY = {m.ARCH_ID: m for m in ARCH_MODULES}

# the 40 assigned (arch × shape) cells; the paper's own `triangles` cells
# are additional
ASSIGNED_CELLS = [
    (m.ARCH_ID, s) for m in ARCH_MODULES if m.ARCH_ID != "triangles" for s in m.SHAPES
]
ALL_CELLS = ASSIGNED_CELLS + [("triangles", s) for s in triangles.SHAPES]


def get_arch(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


__all__ = ["REGISTRY", "ARCH_MODULES", "ASSIGNED_CELLS", "ALL_CELLS", "get_arch"]
