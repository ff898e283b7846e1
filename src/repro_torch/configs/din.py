"""din [arXiv:1706.06978]: embed_dim=18, seq 100, attn MLP 80-40, MLP 200-80.

Shapes: ``train_batch`` (65 536), ``serve_p99`` (512), ``serve_bulk``
(262 144), ``retrieval_cand`` (1 user × 10⁶ candidates as one batched
evaluation — no loop).  The reference row-shards the embedding tables
over "model" in its dry run; that dry run (``build_dryrun``,
``_param_shardings``, ``_flops``) waits for ROADMAP A9.  The train step of
its ``train_batch`` cell is :func:`_train_step`.
"""
from __future__ import annotations

from repro_torch.models.recsys import din as din_model
from repro_torch.optim import adamw, constant

from .base import _A9, optimizer_step

ARCH_ID = "din"
FAMILY = "recsys"

DIN_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}
SHAPES = tuple(DIN_SHAPES)


def full_config() -> din_model.DINConfig:
    return din_model.DINConfig(
        name=ARCH_ID, n_items=1_000_000, n_cates=10_000, embed_dim=18, seq_len=100,
        attn_mlp=(80, 40), mlp=(200, 80),
    )


def smoke_config() -> din_model.DINConfig:
    return din_model.DINConfig(
        name=ARCH_ID, n_items=1000, n_cates=50, embed_dim=8, seq_len=10,
        attn_mlp=(16, 8), mlp=(24, 12),
    )


def _train_step(cfg: din_model.DINConfig):
    """``(step, opt_init)``: ``step(params, opt_state, batch)`` is one AdamW
    step (``constant(1e-3)``, no weight decay) on ``loss_fn``, the
    parameters updated in place; returns ``(params, opt_state, {"loss"})``."""
    opt_init, opt_update = adamw(constant(1e-3), weight_decay=0.0)
    return optimizer_step(lambda p, batch: din_model.loss_fn(p, cfg, batch), opt_update), opt_init


def _param_shardings(mesh, params_sds):
    """The reference's dry-run table shardings; raises until ROADMAP A9."""
    raise NotImplementedError("_param_shardings " + _A9)


def _flops(cfg, batch: int, seq: int, train: bool) -> float:
    """The reference's dry-run FLOP model; raises until ROADMAP A9."""
    raise NotImplementedError("_flops " + _A9)


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    """The reference's dry-run cell; raises until ROADMAP A9."""
    raise NotImplementedError("build_dryrun " + _A9)
