"""Shared plumbing of the architecture configs: the dry-run cell
(:class:`DryRunSpec`, :func:`sds`), the mesh helpers and
:func:`value_and_grad` / :func:`optimizer_step`.

The counterpart of ``repro.configs.base`` over the port's
:class:`~repro_torch.distributed.Mesh`.  The reference lowers and compiles
a cell; the port compiles nothing: :meth:`DryRunSpec.lower` runs the step
on ``meta`` tensors (shapes without memory) under the cost walker.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import NamedSharding, PartitionSpec as P, ShardedTensor
from repro_torch.optim.optimizers import apply_updates, tree_leaves, tree_map

__all__ = ["DryRunSpec", "Lowered", "sds", "dp_axes", "named", "rep", "pad_to",
           "value_and_grad", "optimizer_step", "per_device_bytes"]


def sds(shape, dtype=torch.float32) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``: the port's
    ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _pairs(tree, shardings):
    """``(leaf, sharding or None)`` over ``tree``; a :class:`NamedSharding`
    in ``shardings`` covers the whole subtree below it."""
    if isinstance(tree, ShardedTensor):
        yield tree, tree.sharding
    elif isinstance(tree, torch.Tensor):
        yield tree, shardings if isinstance(shardings, NamedSharding) else None
    elif isinstance(tree, (dict, list, tuple)):
        items = sorted(tree.items()) if isinstance(tree, dict) else list(enumerate(tree))
        for k, v in items:
            if shardings is None or isinstance(shardings, NamedSharding):
                sub = shardings
            elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
                sub = getattr(shardings, tree._fields[k])
            else:
                sub = shardings[k]
            yield from _pairs(v, sub)


def per_device_bytes(tree, shardings=None) -> int:
    """The bytes one device holds of ``tree``: a sharded leaf its block, a
    leaf under a :class:`NamedSharding` of ``shardings`` the block that
    sharding cuts (a dimension that does not divide, as prefill's batch of
    32 over the two-pod mesh's 64 data devices, padded up), any other leaf
    the whole."""
    total = 0
    for leaf, sh in _pairs(tree, shardings):
        shape = leaf.shape
        if sh is not None:
            shape = [-(-n // int(np.prod([sh.mesh.shape[a] for a in axes], dtype=np.int64)))
                     for n, axes in zip(shape, sh._parts(len(shape)))]
        total += int(np.prod(shape, dtype=np.int64)) * leaf.dtype.itemsize
    return total


@dataclasses.dataclass
class Lowered:
    """What :meth:`DryRunSpec.lower` returns: the walker's cost (global),
    the collectives (per device; None for a single-device trace), the
    per-device argument and output bytes of the cell's shardings, the peak
    bytes of live intermediates in the trace, the compute dtype and the
    cell's warnings."""

    cost: dict
    collectives: list | None
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    compute_dtype: torch.dtype
    warnings: list


@dataclasses.dataclass
class DryRunSpec:
    """Everything needed to trace one cell.  The reference's fields, and:
    ``compute_dtype`` (which peak the roofline's compute term uses),
    ``sharded`` (the step runs over the mesh and records its collectives;
    otherwise it is a single-device trace) and ``warnings``."""

    step_fn: Callable
    args: tuple                      # trees of meta tensors / ShardedTensors
    in_shardings: Any                # tree (prefix) of NamedSharding
    out_shardings: Any = None
    donate_argnums: tuple = ()
    description: str = ""
    model_flops: float = 0.0         # "useful" FLOPs for the roofline
    n_params: int = 0
    tokens_per_step: int = 0
    compute_dtype: torch.dtype = torch.float32
    sharded: bool = False
    warnings: tuple = ()

    def lower(self) -> Lowered:
        """Run ``step_fn(*args)`` under the cost walker (nothing is
        allocated or computed on ``meta``)."""
        from repro_torch.launch.flops import CostWalker

        with CostWalker(track_memory=True) as walker:
            out = self.step_fn(*self.args)
            out_bytes = per_device_bytes(out, self.out_shardings)
            del out
        cost = walker.report()
        return Lowered(
            cost=cost,
            collectives=cost["collectives"] if self.sharded else None,
            argument_bytes=per_device_bytes(self.args, self.in_shardings),
            output_bytes=out_bytes,
            temp_bytes=cost["temp_peak_bytes"],
            compute_dtype=self.compute_dtype,
            warnings=list(self.warnings),
        )


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
