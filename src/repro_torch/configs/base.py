"""Shared plumbing of the architecture configs: the mesh helpers and
:func:`value_and_grad` / :func:`optimizer_step`.

The counterpart of ``repro.configs.base`` over the port's
:class:`~repro_torch.distributed.Mesh`.  The dry-run pieces (``DryRunSpec``,
``sds``) wait for ROADMAP A9 and raise.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import NamedSharding, PartitionSpec as P
from repro_torch.optim.optimizers import apply_updates, tree_leaves, tree_map

__all__ = ["DryRunSpec", "sds", "dp_axes", "named", "rep", "pad_to", "value_and_grad",
           "optimizer_step"]

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


def value_and_grad(loss_fn, params):
    """``jax.value_and_grad(loss_fn)(params)`` over a tree of tensors:
    ``(loss detached, gradients in params' tree)``.  A leaf the loss does
    not reach gets a zero gradient, as in JAX."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def optimizer_step(loss, opt_update):
    """``step(params, opt_state, *inputs)``: one optimizer step on
    ``loss(params, *inputs)`` through :func:`value_and_grad`, the parameters
    updated in place; returns ``(params, opt_state, {"loss": loss})``."""
    def step(params, opt_state, *inputs):
        value, grads = value_and_grad(lambda p: loss(p, *inputs), params)
        updates, opt_state, _ = opt_update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, {"loss": value}

    return step
