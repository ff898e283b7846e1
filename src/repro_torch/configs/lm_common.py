"""Shared pieces of the five LM architecture configs.

The shape table, the reduced smoke config, the LM sharding rules of a mesh
(:func:`_rules_for`, :func:`_param_specs`, :func:`_opt_state_specs`) and
the train step (:func:`make_lm_train_step`), on one device or sharded over
a :class:`~repro_torch.distributed.Mesh`, and the dry-run cells
(:func:`build_lm_dryrun`).
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
    spec_for,
)
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import OptState, adamw, apply_updates, cosine_with_warmup
from repro_torch.optim.optimizers import tree_leaves, tree_map

from repro_torch.obs.cost import record_collective, repeated, stand_in

from .base import DryRunSpec, dp_axes, named, sds

__all__ = ["LM_SHAPES", "build_lm_dryrun", "lm_smoke_config", "make_lm_train_step"]

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
        # on a mesh of meta devices (the dry run) every replica's rows and
        # every block of a tensor have one shape: one stands for the rest
        one = lead.type == "meta"
        specs = grad_specs if grad_specs is not None else tree_map(lambda p: p.spec, params)
        grads = tree_map(lambda p, s: sharded_zeros_like(p, sharding=NamedSharding(mesh, s)),
                         params, specs)
        rows = {k: [_replica_rows(v, r, n_rep, c, mesh.devices[c]) for r, c in enumerate(coords)]
                for k, v in batch.items()}
        weights = _token_weights(rows, accum)
        loss = torch.zeros((), dtype=torch.float32, device=lead)
        for r, c in stand_in(enumerate(coords), one):
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
        # each replica's f32 gradients went to the blocks' owners: a
        # reduce-scatter (an all-reduce where a tensor is not sharded)
        for g in tree_leaves(grads):
            record_collective("reduce-scatter" if g.sharded_axes else "all-reduce",
                              g.shape.numel() * 4, mesh.axis_names)
        grads = tree_map(lambda g, p: _relaid(g, p.sharding, accum), grads, params)
        squares = []
        for g in tree_leaves(grads):
            for _, blk in stand_in(g.unique_blocks(), one):
                squares.append(torch.sum(blk.to(torch.float32) ** 2).to(lead))
        gnorm = torch.sqrt(sum(squares))
        # AdamW block by block: every block of every tensor, or on meta the
        # first of each, standing for the mesh's blocks
        cut = (lambda x: [x.blocks.flat[0]]) if one else (lambda x: list(x.blocks.flat))
        blocks = lambda tree: tree_map(cut, tree)  # noqa: E731
        step = opt_state.step
        with repeated(mesh.size if one else 1):
            updates, new_state, gnorm = opt_update(
                blocks(grads), OptState(step.gather(), blocks(opt_state.mu),
                                        blocks(opt_state.nu)),
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
    for c in stand_in(g.coords(), g.on_meta):
        g.blocks[c].div_(accum)
    return g if g.spec == sharding.spec else device_put(g, sharding)


def _token_weights(rows: dict, accum: int) -> list[list[float]]:
    """``weights[r][i]``: replica ``r``'s share of microbatch ``i``'s loss —
    its label tokens (or mask sum) over the microbatch's, so that the
    weighted sum of the replicas' mean losses is the microbatch's mean.  A
    mask on ``meta`` (the dry run) holds no values: its rows are weighted
    by their size."""
    if "mask" in rows and rows["mask"][0].device.type != "meta":
        counts = [[float(m[i].sum()) for i in range(accum)] for m in rows["mask"]]
    else:
        counts = [[float(x[i].numel()) for i in range(accum)] for x in rows["labels"]]
    totals = [max(sum(c[i] for c in counts), 1.0) for i in range(accum)]
    return [[c[i] / totals[i] for i in range(accum)] for c in counts]


def _accum_for(cfg, mesh, shape, micro_target: int):
    dp = 1
    for a in dp_axes(mesh):
        dp *= mesh.shape[a]
    per_dev = shape["batch"] // dp
    if per_dev == 0:
        raise ValueError(f"batch {shape['batch']} smaller than dp={dp}")
    accum = max(1, per_dev // micro_target)
    while shape["batch"] % (dp * accum):
        accum -= 1
    return accum, shape["batch"] // accum


_SINGLE = ("the port has no sharded {what} path: the single-device step is traced at the "
           "global batch, per-device terms are its cost over the chips, and no collective "
           "is recorded")


def build_lm_dryrun(cfg: TransformerConfig, shape_name: str, mesh, micro_target: int = 2,
                    variant: str = "baseline") -> DryRunSpec:
    """One (LM × shape × mesh) dry-run cell on a mesh of ``meta`` devices.

    ``train_4k`` runs the sharded train step (:func:`make_lm_train_step`
    with ``grad_specs``) over the mesh: one data replica and one block of
    each tensor are traced for all of them (one shape each), and every
    gather and gradient sum records its collective.  ``prefill_32k``,
    ``decode_32k`` and ``long_500k`` trace the single-device step at the
    global batch (``collectives`` null, a warning says so); a decode step
    writes the cache's last slot.

    Variants (the reference's): ``"opt"`` — one-hot CE, TP-only weights
    when master and moments fit one TP shard, and the int8 KV cache in
    decode; ``"opt2"`` — opt with ``dots`` remat.
    """
    shape = LM_SHAPES[shape_name]
    tp_only = variant in ("opt", "opt2") and _use_tp_only(cfg, mesh)
    if variant in ("opt", "opt2"):
        cfg = dataclasses.replace(cfg, onehot_ce=True)
    if variant == "opt2":
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    dp = dp_axes(mesh)
    dpP = dp if len(dp) > 1 else dp[0]
    params_meta, param_sh, rules = _param_specs(cfg, mesh, tp_only=tp_only)
    b, s = shape["batch"], shape["seq"]
    common = dict(n_params=cfg.n_params(), compute_dtype=cfg.dtype)

    if shape["kind"] == "train":
        accum, micro_total = _accum_for(cfg, mesh, shape, micro_target)
        step, opt_init = make_lm_train_step(cfg, accum, grad_specs=spec_for(rules, params_meta))
        params = device_put(params_meta, param_sh)
        batch = {k: sds((accum, micro_total, s), torch.int32) for k in ("tokens", "labels")}
        n_rep = len(_replicas(mesh))
        tokens = b * s
        return DryRunSpec(
            step_fn=step,
            args=(params, opt_init(params), batch),
            in_shardings=(param_sh, _opt_state_specs(param_sh),
                          {k: named(mesh, None, dpP, None) for k in batch}),
            donate_argnums=(0, 1),
            description=f"{cfg.name} train accum={accum}",
            model_flops=6.0 * cfg.n_active_params() * tokens,
            tokens_per_step=tokens,
            sharded=True,
            warnings=(f"one data replica of {n_rep} traced and counted {n_rep} times, and one "
                      f"block of each tensor for the mesh's {mesh.size}",),
            **common,
        )

    if shape["kind"] == "prefill":
        def prefill_step(params, tokens):
            return tfm.prefill(tfm.params_from_tree(params, cfg), tokens, cfg)

        cache_sh = NamedSharding(mesh, P(None, dpP, None, "model", None))
        tokens = b * s
        return DryRunSpec(
            step_fn=prefill_step,
            args=(params_meta, sds((b, s), torch.int32)),
            in_shardings=(param_sh, named(mesh, dpP, None)),
            out_shardings=(named(mesh, dpP, "model"), (cache_sh, cache_sh)),
            description=f"{cfg.name} prefill",
            model_flops=2.0 * cfg.n_active_params() * tokens
            + 4.0 * b * cfg.n_heads * cfg.head_dim * s * s / 2,
            tokens_per_step=tokens,
            warnings=(_SINGLE.format(what="prefill"),),
            **common,
        )

    # decode kinds
    long = shape["kind"] == "decode_long"
    kv_quant = variant in ("opt", "opt2")
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    seq_spec = (*dp, "model") if long else "model"
    batch_axis = None if long else dpP
    cache_sh = NamedSharding(mesh, P(None, batch_axis, None, seq_spec, None))
    scale_sh = NamedSharding(mesh, P(None, batch_axis, None, seq_spec))
    kv_shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
    if kv_quant:
        cache = (sds(kv_shape, torch.int8), sds(kv_shape[:-1], torch.float32),
                 sds(kv_shape, torch.int8), sds(kv_shape[:-1], torch.float32))
        cache_shardings = (cache_sh, scale_sh, cache_sh, scale_sh)
    else:
        cache = (sds(kv_shape, cfg.dtype), sds(kv_shape, cfg.dtype))
        cache_shardings = (cache_sh, cache_sh)

    def decode(params, token, cache):
        return tfm.decode_step(tfm.params_from_tree(params, cfg), token, s - 1, cache, cfg)

    return DryRunSpec(
        step_fn=decode,
        args=(params_meta, sds((b,), torch.int32), cache),
        in_shardings=(param_sh, named(mesh, batch_axis), cache_shardings),
        out_shardings=(None, cache_shardings),
        donate_argnums=(2,),
        description=f"{cfg.name} decode S={s} B={b} kv_quant={kv_quant}",
        model_flops=2.0 * cfg.n_active_params() * b + 4.0 * b * cfg.n_heads * cfg.head_dim * s,
        tokens_per_step=b,
        warnings=(_SINGLE.format(what="decode"),),
        **common,
    )
