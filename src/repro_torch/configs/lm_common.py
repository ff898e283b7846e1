"""Shared pieces of the five LM architecture configs.

The shape table, the reduced smoke config, the LM sharding rules of a mesh
(:func:`_rules_for`, :func:`_param_specs`, :func:`_opt_state_specs`) and
the train step (:func:`make_lm_train_step`), on one device or sharded over
a :class:`~repro_torch.distributed.Mesh`.  The dry-run builder
(``build_lm_dryrun``) waits for ROADMAP A9.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    device_put,
    lm_rules,
    make_param_shardings,
    moe_rules_patch,
    sharded_zeros_like,
)
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import OptState, adamw, apply_updates, cosine_with_warmup
from repro_torch.optim.optimizers import tree_leaves, tree_map

from .base import dp_axes

__all__ = ["LM_SHAPES", "lm_smoke_config", "make_lm_train_step"]

TP_AXIS = "model"  # the tensor-parallel mesh axis; every other axis is data

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode_long", seq=524288, batch=1),
}


def _rules_for(cfg: TransformerConfig, mesh, tp_only: bool = False):
    fsdp = dp_axes(mesh)
    rules = lm_rules(fsdp, tp_only=tp_only)
    if cfg.is_moe:
        rules = moe_rules_patch(rules, fsdp, tp_only=tp_only)
    return rules


def _use_tp_only(cfg: TransformerConfig, mesh) -> bool:
    """fp32 master + 2 fp32 moments must fit one TP shard (under 8 GB,
    leaving room for activations) to drop FSDP."""
    tp = mesh.shape[TP_AXIS]
    bytes_per_dev = cfg.n_params() * 12 / tp
    return bytes_per_dev < 8e9


def _param_specs(cfg: TransformerConfig, mesh, tp_only: bool = False):
    """(the parameter tree on the ``meta`` device — shapes without memory,
    the port's ``eval_shape`` — its shardings, the rules)."""
    params_meta = tfm.param_tree(tfm.TransformerParams(cfg, torch.device("meta")))
    rules = _rules_for(cfg, mesh, tp_only=tp_only)
    return params_meta, make_param_shardings(mesh, rules, params_meta), rules


def _opt_state_specs(param_shardings):
    """The AdamW state's shardings: the step replicated, each moment laid
    out as its parameter (ZeRO optimizer-state sharding), so AdamW runs
    block by block.

    The reference takes ``spec_for`` over the state instead, where the
    moments' paths (``.mu/embed``) miss the anchored ``^embed$`` and
    ``^lm_head$`` rules and the two tables' moments come out replicated.
    """
    mesh = tree_leaves(param_shardings)[0].mesh
    return OptState(step=NamedSharding(mesh, P()), mu=param_shardings, nu=param_shardings)


def lm_smoke_config(cfg: TransformerConfig) -> TransformerConfig:
    """Same family, tiny dims, fp32 — runs on the CPU in seconds."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=96 if not cfg.is_moe else 32,
        vocab_size=250,   # pads to 256: the vocab-padding path stays covered
        vocab_pad=64,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        dtype=torch.float32,
        remat=False,
    )


def _replicas(mesh) -> list[tuple[int, ...]]:
    """The mesh coordinate each data replica computes on: every index
    along the data axes (row-major, as a ``P(None, data axes, None)`` batch
    is cut), at position 0 of ``model``."""
    dp = dp_axes(mesh)
    out = []
    for idx in np.ndindex(*(mesh.shape[a] for a in dp)):
        where = dict(zip(dp, idx))
        out.append(tuple(where.get(a, 0) for a in mesh.axis_names))
    return out


def _replica_rows(x, r: int, n_rep: int, coord, dev) -> torch.Tensor:
    """Replica ``r``'s rows (axis 1) of a batch leaf, on ``dev``: its own
    block where the batch is sharded ``P(None, data axes, None)``, else
    cut from the whole leaf."""
    if isinstance(x, ShardedTensor):
        if x.spec == P(None, _dp_entry(x.mesh), None):
            return x.blocks[coord].to(dev)
        x = x.gather()
    x = torch.as_tensor(x)
    rows = x.shape[1] // n_rep
    if rows * n_rep != x.shape[1]:
        raise ValueError(f"a batch of {x.shape[1]} rows does not split over {n_rep} replicas")
    return x[:, r * rows:(r + 1) * rows].to(dev)


def _dp_entry(mesh):
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def make_lm_train_step(cfg: TransformerConfig, accum: int, grad_specs=None, lr=None):
    """Grad-accumulation train step: ``(train_step, opt_init)``.

    ``train_step(params, opt_state, batch)`` takes a batch whose leaves
    have a leading accum axis: one microbatch when ``accum == 1``, else a
    loop over ``accum`` microbatches summing f32 gradients, the loss and
    the gradients then divided by ``accum``; then AdamW (by default the
    reference's ``cosine_with_warmup(3e-4, 2000, 100_000)``) and
    :func:`~repro_torch.optim.apply_updates`.  Returns ``(params,
    opt_state, {"loss", "gnorm"})``, the metrics 0-d f32 tensors.

    **One device.**  ``params`` is a
    :class:`~repro_torch.models.transformer.TransformerParams`, updated in
    place.

    **Sharded.**  ``params`` is a :func:`~repro_torch.models.transformer.param_tree`
    of :class:`~repro_torch.distributed.ShardedTensor` (``device_put`` by
    :func:`_param_specs`' shardings) and ``opt_state`` an ``OptState`` laid
    out by :func:`_opt_state_specs`; the batch may be sharded
    ``P(None, data axes, None)``.  The reference gets this step from
    ``jit(in_shardings=...)``; here, on the port's single-controller mesh,
    each data replica (the mesh's coordinates at ``model`` position 0)
    gathers the weights whole onto its device, runs its rows of every
    microbatch, and its f32 gradients, weighted by its share of the loss's
    tokens, are summed into the blocks of ``grad_specs`` (the parameters'
    own specs when None) — ZeRO-3 with the gather per step.  AdamW then
    runs block by block, the global norm counting each element once; the
    loss is the replicas' weighted mean, on the mesh's lead device.
    ``grad_specs`` changes nothing on one device, where every spec is the
    whole tensor.

    ``opt_init`` takes either form of ``params``.
    """
    opt_init, opt_update = adamw(lr or cosine_with_warmup(3e-4, 2000, 100_000))

    def micro_grads(params, mb):
        tree = tfm.param_tree(params)
        loss = tfm.loss_fn(params, mb, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), tree)

    def train_step(params, opt_state, batch):
        if not isinstance(params, tfm.TransformerParams):
            return sharded_step(params, opt_state, batch)
        if accum == 1:
            loss, grads = micro_grads(params, {k: v[0] for k, v in batch.items()})
        else:
            loss, grads = None, None
            for i in range(accum):
                mb_loss, mb_grads = micro_grads(params, {k: v[i] for k, v in batch.items()})
                if grads is None:
                    loss, grads = mb_loss, tree_map(lambda g: g.to(torch.float32), mb_grads)
                else:
                    loss = loss + mb_loss
                    tree_map(lambda a, g: a.add_(g), grads, mb_grads)
                del mb_grads
            loss = loss / accum
            tree_map(lambda g: g.div_(accum), grads)
        tree = tfm.param_tree(params)
        updates, opt_state, gnorm = opt_update(grads, opt_state, tree)
        del grads
        apply_updates(tree, updates)
        return params, opt_state, {"loss": loss, "gnorm": gnorm}

    def sharded_step(params, opt_state, batch):
        mesh = tree_leaves(params)[0].mesh
        lead, coords = mesh.lead, _replicas(mesh)
        n_rep = len(coords)
        specs = grad_specs if grad_specs is not None else tree_map(lambda p: p.spec, params)
        grads = tree_map(lambda p, s: sharded_zeros_like(p, sharding=NamedSharding(mesh, s)),
                         params, specs)
        rows = {k: [_replica_rows(v, r, n_rep, c, mesh.devices[c]) for r, c in enumerate(coords)]
                for k, v in batch.items()}
        weights = _token_weights(rows, accum)
        loss = torch.zeros((), dtype=torch.float32, device=lead)
        for r, c in enumerate(coords):
            dev = mesh.devices[c]
            local = tfm.params_from_tree(tree_map(lambda p: p.gather(dev), params), cfg)
            acc = None
            for i in range(accum):
                mb_loss, g = micro_grads(local, {k: v[r][i] for k, v in rows.items()})
                w = weights[r][i]
                loss += (mb_loss * w).to(lead)
                if acc is None:
                    acc = tree_map(lambda x: x.to(torch.float32) * w, g)
                else:
                    tree_map(lambda a, x: a.add_(x, alpha=w), acc, g)
                del g
            tree_map(lambda gs, a: gs.add_slices_(a), grads, acc)
            del local, acc
        loss /= accum
        grads = tree_map(lambda g, p: _relaid(g, p.sharding, accum), grads, params)
        gnorm = torch.sqrt(sum(torch.sum(blk.to(torch.float32) ** 2).to(lead)
                               for g in tree_leaves(grads) for _, blk in g.unique_blocks()))
        blocks = lambda tree: tree_map(lambda x: list(x.blocks.flat), tree)  # noqa: E731
        step = opt_state.step
        updates, new_state, gnorm = opt_update(
            blocks(grads), OptState(step.gather(), blocks(opt_state.mu), blocks(opt_state.nu)),
            blocks(params), gnorm=gnorm)
        del grads
        apply_updates(blocks(params), updates)
        return params, OptState(device_put(new_state.step, step.sharding), opt_state.mu,
                                opt_state.nu), {"loss": loss, "gnorm": gnorm}

    def init(params):
        if isinstance(params, tfm.TransformerParams):
            return opt_init(tfm.param_tree(params))
        mesh = tree_leaves(params)[0].mesh
        return OptState(step=device_put(torch.zeros((), dtype=torch.int32), NamedSharding(mesh, P())),
                        mu=tree_map(sharded_zeros_like, params),
                        nu=tree_map(sharded_zeros_like, params))

    return train_step, init


def _relaid(g: ShardedTensor, sharding: NamedSharding, accum: int) -> ShardedTensor:
    """The summed gradient divided by ``accum``, in its parameter's layout."""
    for c in g.coords():
        g.blocks[c].div_(accum)
    return g if g.spec == sharding.spec else device_put(g, sharding)


def _token_weights(rows: dict, accum: int) -> list[list[float]]:
    """``weights[r][i]``: replica ``r``'s share of microbatch ``i``'s loss —
    its label tokens (or mask sum) over the microbatch's, so that the
    weighted sum of the replicas' mean losses is the microbatch's mean."""
    if "mask" in rows:
        counts = [[float(m[i].sum()) for i in range(accum)] for m in rows["mask"]]
    else:
        counts = [[float(x[i].numel()) for i in range(accum)] for x in rows["labels"]]
    totals = [max(sum(c[i] for c in counts), 1.0) for i in range(accum)]
    return [[c[i] / totals[i] for i in range(accum)] for c in counts]
