"""Shared plumbing of the architecture configs: the mesh helpers.

The counterpart of ``repro.configs.base`` over the port's
:class:`~repro_torch.distributed.Mesh`.  The dry-run pieces (``DryRunSpec``,
``sds``) wait for ROADMAP A9 and raise.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import NamedSharding, PartitionSpec as P

__all__ = ["DryRunSpec", "sds", "dp_axes", "named", "rep", "pad_to"]

_A9 = "is not yet ported (ROADMAP A9: the analysis tools); use the JAX package repro for it"


class DryRunSpec:
    """The reference's dry-run cell; raises until ROADMAP A9."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("DryRunSpec " + _A9)


def sds(shape, dtype=None):
    """The reference's ``jax.ShapeDtypeStruct`` helper; raises until ROADMAP A9."""
    raise NotImplementedError("sds " + _A9)


def pad_to(n: int, multiple: int = 512) -> int:
    """Round a sharded dimension up to the mesh-divisible size."""
    return -(-n // multiple) * multiple


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    """Batch-parallel axes = every mesh axis except 'model'."""
    return tuple(a for a in mesh.axis_names if a != "model")


def named(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def rep(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
