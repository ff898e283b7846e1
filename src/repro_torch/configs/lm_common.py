"""Shared pieces of the five LM architecture configs.

The shape table, the reduced smoke config and the train step
(:func:`make_lm_train_step`).  The dry-run builder (``build_lm_dryrun``)
waits for ROADMAP A9; the train step's ``grad_specs=`` (the LM parameter
sharding) for ROADMAP A7b.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import TransformerConfig
from repro_torch.optim import adamw, apply_updates, cosine_with_warmup
from repro_torch.optim.optimizers import tree_leaves, tree_map

__all__ = ["LM_SHAPES", "lm_smoke_config", "make_lm_train_step"]

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode_long", seq=524288, batch=1),
}


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


def make_lm_train_step(cfg: TransformerConfig, accum: int, grad_specs=None, lr=None):
    """Grad-accumulation train step: ``(train_step, opt_init)``.

    ``train_step(params, opt_state, batch)`` takes a batch whose leaves
    have a leading accum axis: one microbatch when ``accum == 1``, else a
    loop over ``accum`` microbatches summing f32 gradients, the loss and
    the gradients then divided by ``accum``; then AdamW (by default the
    reference's ``cosine_with_warmup(3e-4, 2000, 100_000)``) and
    :func:`~repro_torch.optim.apply_updates`.  The parameters
    (:class:`~repro_torch.models.transformer.TransformerParams`) are
    updated in place; returns ``(params, opt_state, {"loss", "gnorm"})``,
    both 0-d f32 tensors on the parameters' device.  ``opt_init(params)``
    makes the optimizer state over :func:`~repro_torch.models.transformer.param_tree`.
    """
    if grad_specs is not None:
        raise NotImplementedError(
            "grad_specs= is not yet ported (ROADMAP A7: the LM parameter sharding); "
            "use the JAX package repro for it")
    opt_init, opt_update = adamw(lr or cosine_with_warmup(3e-4, 2000, 100_000))

    def micro_grads(params, mb):
        tree = tfm.param_tree(params)
        loss = tfm.loss_fn(params, mb, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), tree)

    def train_step(params, opt_state, batch):
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

    return train_step, lambda params: opt_init(tfm.param_tree(params))
