"""LM parameter sharding rules: held for ROADMAP A7b.

The counterpart of ``repro.distributed.sharding`` (the regex-path →
``PartitionSpec`` rules of the LM train step) arrives with the training
half of the port.  Until then each of its public names raises when it is
called or read.
"""
from __future__ import annotations

__all__ = ["ShardingRules", "make_param_shardings", "spec_for", "LM_RULES"]

_HELD_FOR_A7 = (
    "is not yet ported to repro_torch (ROADMAP A7b: the LM parameter "
    "sharding of the train step); use the JAX package repro for it"
)


class _HeldForA7:
    """A name of the reference's sharding module that raises on use."""

    def __init__(self, name: str):
        self._name = name

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(f"{self._name} {_HELD_FOR_A7}")

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        raise NotImplementedError(f"{self._name}.{attr} {_HELD_FOR_A7}")

    def __repr__(self) -> str:
        return f"<{self._name}: not yet ported (ROADMAP A7b)>"


ShardingRules = _HeldForA7("ShardingRules")
make_param_shardings = _HeldForA7("make_param_shardings")
spec_for = _HeldForA7("spec_for")
LM_RULES = _HeldForA7("LM_RULES")
