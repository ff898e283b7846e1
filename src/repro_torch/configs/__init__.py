"""Architecture registry of the port: ``--arch <id>`` for the launchers.

The five LM architectures, the four GNNs and DIN are ported.  The
``triangles`` id of the JAX package (its dry-run cells) raises "not yet
ported".
"""
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
]

REGISTRY = {m.ARCH_ID: m for m in ARCH_MODULES}

# the JAX package's other arch id, whose config waits for ROADMAP queue A:
# the triangle-counting dry-run cells for A9
NOT_PORTED_ARCHS = ("triangles",)


def get_arch(arch_id: str):
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id == "triangles":
        raise NotImplementedError(
            "arch 'triangles' (the dry-run cells) is not yet ported (ROADMAP A9: the "
            "analysis tools); use the JAX package repro for it"
        )
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")


__all__ = ["REGISTRY", "ARCH_MODULES", "NOT_PORTED_ARCHS", "get_arch"]
