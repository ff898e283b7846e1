"""Optimizers in the (init, update) functional style, over trees of tensors.

The counterparts of ``repro.optim.optimizers``: the same names, arguments
and arithmetic (AdamW clips, then counts the step, then applies the bias
corrections and ``u = -lr·(m̂/(√v̂ + eps) + wd·p)``), with f32 moments.  A
tree is a nest of ``dict`` (walked in sorted key order, as
``jax.tree_util``), ``list`` and ``tuple`` whose leaves are tensors.

Three differences from the reference, all for memory at full width (a
full-width model's f32 gradients, masters and two moments are 16 bytes a
parameter: 54 GB for granite-moe-3b-a800m):

* ``update`` writes the new moments into the moment tensors of the state
  it is given (JAX builds new arrays); the returned :class:`OptState`
  holds the same tensors, so the old state is not to be used again.
* ``update`` writes each update into its f32 gradient tensor and returns
  those tensors: the gradients are consumed.  AdamW clips leaf by leaf
  (the global norm first), so no clipped copy of the whole tree exists.
* :func:`apply_updates` adds the updates into the parameters in place,
  under ``torch.no_grad()``, and returns the same tree.

No ``torch.optim``: the arithmetic is written out here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["OptState", "adamw", "sgd_momentum", "clip_by_global_norm", "apply_updates",
           "tree_leaves", "tree_map"]


class OptState(NamedTuple):
    step: torch.Tensor
    mu: dict | None
    nu: dict | None


def tree_leaves(tree) -> list:
    """Leaves in the reference's order: dict keys sorted, sequences in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``tree`` with each leaf ``x`` replaced by ``fn(x, *matching leaves of rest)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in tree_leaves(grads)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(torch.float32) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm)."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gnorm


def _per_device(**scalars):
    """``on(device)``: the 0-d tensors ``scalars`` (or None) on ``device``,
    each copied there once."""
    cache: dict = {}

    def on(dev):
        if dev not in cache:
            cache[dev] = {k: None if x is None else x.to(dev) for k, x in scalars.items()}
        return cache[dev]

    return on


def _into_grad(g: torch.Tensor, lr_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``-lr_t · x``, written into ``g`` when it is f32 (see the module note)."""
    return torch.mul(-lr_t, x, out=g if g.dtype == torch.float32 else None)


@torch.no_grad()
def apply_updates(params, updates):
    """``p ← (p in f32 + u) in p's dtype``, in place; returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        if p.dtype == torch.float32:
            p.add_(u)
        else:
            p.copy_((p.to(torch.float32) + u).to(p.dtype))
    return params


def adamw(
    lr: Callable[[torch.Tensor], torch.Tensor] | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float | None = 1.0,
):
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=torch.float32))

    def init(params) -> OptState:
        return OptState(step=_step0(params), mu=tree_map(_zeros_f32, params),
                        nu=tree_map(_zeros_f32, params))

    @torch.no_grad()
    def update(grads, state: OptState, params, gnorm=None):
        """``gnorm``: the gradients' global norm when the caller has it — a
        sharded tree holds a replicated block once per device, and its norm
        counts each element once.  The leaves may lie on several devices."""
        scale = None
        if max_grad_norm is not None:
            if gnorm is None:
                gnorm = _global_norm(grads)
            scale = _clip_scale(gnorm, max_grad_norm)
        step = state.step + 1
        t = step.to(torch.float32)
        on = _per_device(scale=scale, bc1=1.0 - b1 ** t, bc2=1.0 - b2 ** t,
                         lr_t=lr_fn(step).to(t.device))

        def upd(g, m, v, p):
            c = on(g.device)
            gf = (g if c["scale"] is None else _clipped(g, c["scale"])).to(torch.float32)
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            mhat = m / c["bc1"]
            vhat = v / c["bc2"]
            del gf
            return _into_grad(g, c["lr_t"], mhat / (torch.sqrt(vhat) + eps)
                              + weight_decay * p.to(torch.float32))

        updates = tree_map(upd, grads, state.mu, state.nu, params)
        return updates, OptState(step=step, mu=state.mu, nu=state.nu), gnorm

    return init, update


def sgd_momentum(lr, momentum: float = 0.9, nesterov: bool = False):
    lr_fn = lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=torch.float32))

    def init(params) -> OptState:
        return OptState(step=_step0(params), mu=tree_map(_zeros_f32, params), nu=None)

    @torch.no_grad()
    def update(grads, state: OptState, params):
        del params
        step = state.step + 1
        lr_t = lr_fn(step).to(step.device)

        def upd(g, m):
            m.mul_(momentum).add_(g.to(torch.float32))
            return _into_grad(g, lr_t, g.to(torch.float32) + momentum * m if nesterov else m)

        updates = tree_map(upd, grads, state.mu)
        return updates, OptState(step=step, mu=state.mu, nu=None), None

    return init, update
