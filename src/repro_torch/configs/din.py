"""din [arXiv:1706.06978]: embed_dim=18, seq 100, attn MLP 80-40, MLP 200-80.

Shapes: ``train_batch`` (65 536), ``serve_p99`` (512), ``serve_bulk``
(262 144), ``retrieval_cand`` (1 user × 10⁶ candidates as one batched
evaluation — no loop).  The reference row-shards the embedding tables
over "model" and shards batches over the data axes in its dry run; the
port's :func:`build_dryrun` keeps those shardings for the per-device bytes
and traces the single-device step at the global size.  The train step of
the ``train_batch`` cell is :func:`_train_step`.
"""
from __future__ import annotations

import torch

from repro_torch.models.gnn.common import meta_from_layout
from repro_torch.models.recsys import din as din_model
from repro_torch.optim import OptState, adamw, constant

from .base import DryRunSpec, dp_axes, named, optimizer_step, pad_to, rep, sds

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
    """The tables row-sharded over "model", every other leaf replicated."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, f"{name}/{k}" if name else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{name}/{i}") for i, v in enumerate(tree))
        if "item_table" in name or "cate_table" in name:
            return named(mesh, "model", None)
        return rep(mesh)

    return walk(params_sds, "")


def _flops(cfg: din_model.DINConfig, batch: int, seq: int, train: bool) -> float:
    d2 = 2 * cfg.embed_dim
    attn = 2.0 * (4 * d2 * cfg.attn_mlp[0] + cfg.attn_mlp[0] * cfg.attn_mlp[1] + cfg.attn_mlp[1])
    mlp = 2.0 * (3 * d2 * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1] + cfg.mlp[1])
    f = batch * (seq * attn + mlp)
    return f * (3.0 if train else 1.0)


_SINGLE = ("the port has no sharded DIN path: the single-device step is traced at the global "
           "size (tables whole, the batch whole), per-device terms are its cost over the "
           "chips, and no collective is recorded")


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    """One DIN dry-run cell on a mesh of ``meta`` devices.

    ``variant="opt"`` (serve and retrieval shapes): the tables replicated
    in the cell's shardings, as the reference's.  ``retrieval_cand`` runs
    at its full 10⁶ candidates (padded to the mesh): ``meta`` holds no
    values."""
    cfg = full_config()
    spec = DIN_SHAPES[shape]
    dp = dp_axes(mesh)
    dpP = dp if len(dp) > 1 else dp[0]
    params = meta_from_layout(din_model._layout(cfg))
    replicate_tables = variant == "opt" and spec["kind"] != "train"
    param_sh = rep(mesh) if replicate_tables else _param_shardings(mesh, params)
    b = spec["batch"]
    s = cfg.seq_len

    def batch_sds(bsz):
        return {
            "hist_items": sds((bsz, s), torch.int32),
            "hist_cates": sds((bsz, s), torch.int32),
            "target_item": sds((bsz,), torch.int32),
            "target_cate": sds((bsz,), torch.int32),
            "label": sds((bsz,)),
        }

    def batch_sh(axis):
        return {
            "hist_items": named(mesh, axis, None),
            "hist_cates": named(mesh, axis, None),
            "target_item": named(mesh, axis),
            "target_cate": named(mesh, axis),
            "label": named(mesh, axis),
        }

    if spec["kind"] == "train":
        step, opt_init = _train_step(cfg)
        # moments of the tables shard like the tables; step replicates
        opt_sh = OptState(step=rep(mesh), mu=param_sh, nu=param_sh)
        return DryRunSpec(
            step_fn=step,
            args=(params, opt_init(params), batch_sds(b)),
            in_shardings=(param_sh, opt_sh, batch_sh(dpP)),
            donate_argnums=(0, 1),
            description=f"{ARCH_ID} train B={b}",
            model_flops=_flops(cfg, b, s, True),
            tokens_per_step=b,
            warnings=(_SINGLE,),
        )

    if spec["kind"] == "serve":
        def step(params, batch):
            with torch.no_grad():
                return din_model.apply(params, cfg, batch)

        bs = batch_sds(b)
        bs.pop("label")
        bh = batch_sh(dpP)
        bh.pop("label")
        return DryRunSpec(
            step_fn=step,
            args=(params, bs),
            in_shardings=(param_sh, bh),
            description=f"{ARCH_ID} serve B={b}",
            model_flops=_flops(cfg, b, s, False),
            tokens_per_step=b,
            warnings=(_SINGLE,),
        )

    # retrieval: 1 user, 1M candidates sharded over the whole mesh
    c = pad_to(spec["n_candidates"])  # −1-padded tail, masked by embedding_lookup
    all_axes = tuple(mesh.axis_names)

    def step(params, batch):
        with torch.no_grad():
            return din_model.score_candidates(params, cfg, batch)

    args = (
        params,
        {
            "hist_items": sds((1, s), torch.int32),
            "hist_cates": sds((1, s), torch.int32),
            "cand_items": sds((c,), torch.int32),
            "cand_cates": sds((c,), torch.int32),
        },
    )
    in_sh = (
        param_sh,
        {
            "hist_items": rep(mesh),
            "hist_cates": rep(mesh),
            "cand_items": named(mesh, all_axes),
            "cand_cates": named(mesh, all_axes),
        },
    )
    return DryRunSpec(
        step_fn=step,
        args=args,
        in_shardings=in_sh,
        out_shardings=named(mesh, all_axes),
        description=f"{ARCH_ID} retrieval C={c}",
        model_flops=_flops(cfg, c, s, False),
        tokens_per_step=c,
        warnings=(_SINGLE,),
    )
