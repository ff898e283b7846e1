"""Architecture registry of the port: ``--arch <id>`` for the LM launchers.

Only the five LM architectures are ported.  The GNN, recsys and
``triangles`` ids of the JAX package raise "not yet ported".
"""
from __future__ import annotations

from . import deepseek_coder_33b, granite_moe_3b_a800m, llama3_2_3b, olmoe_1b_7b, qwen2_1_5b

ARCH_MODULES = [
    olmoe_1b_7b,
    granite_moe_3b_a800m,
    deepseek_coder_33b,
    llama3_2_3b,
    qwen2_1_5b,
]

REGISTRY = {m.ARCH_ID: m for m in ARCH_MODULES}

# the JAX package's other arch ids, whose configs wait for ROADMAP queue A:
# the GNN and recsys archs for A8, the triangle-counting dry-run cells for A9
NOT_PORTED_ARCHS = ("schnet", "gcn-cora", "graphsage-reddit", "egnn", "din", "triangles")


def get_arch(arch_id: str):
    if arch_id in REGISTRY:
        return REGISTRY[arch_id]
    if arch_id == "triangles":
        raise NotImplementedError(
            "arch 'triangles' (the dry-run cells) is not yet ported (ROADMAP A9: the "
            "analysis tools); use the JAX package repro for it"
        )
    if arch_id in NOT_PORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported (ROADMAP A8: GNN and recsys); "
            "use the JAX package repro for it"
        )
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")


__all__ = ["REGISTRY", "ARCH_MODULES", "NOT_PORTED_ARCHS", "get_arch"]
