"""Deep Interest Network (Zhou et al., arXiv:1706.06978).

The counterpart of ``repro.models.recsys.din``.  Target attention over the
user behaviour sequence: each history item is scored by an MLP over
``[h, t, h−t, h·t]`` against the candidate item, the weighted history sum
concatenates with the target/profile embeddings into the prediction MLP.
The million-row item table is the hot path.

``score_candidates`` broadcasts one user's attended history against a
large candidate set as a single batched evaluation — the
``retrieval_cand`` shape — with no Python loop.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device

from ..gnn.common import (
    init_from_layout,
    mlp_apply,
    mlp_layout,
    params_from_layout,
    params_to_numpy,
    seeded_generator,
)
from .embedding import embedding_lookup

__all__ = ["DINConfig", "init_params", "apply", "score_candidates", "loss_fn",
           "params_from_numpy", "params_to_numpy"]


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 1_000_000
    n_cates: int = 10_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple[int, ...] = (80, 40)
    mlp: tuple[int, ...] = (200, 80)
    dtype: object = torch.float32


def _layout(cfg: DINConfig) -> dict:
    d = cfg.embed_dim
    item_cate = 2 * d  # item ⊕ category embedding
    return {
        "item_table": ("normal", (cfg.n_items, d), 0.01),
        "cate_table": ("normal", (cfg.n_cates, d), 0.01),
        # attention MLP over [h, t, h−t, h·t]
        "attn": mlp_layout([4 * item_cate, *cfg.attn_mlp, 1]),
        # prediction MLP over [hist_sum, target, hist_sum·target]
        "mlp": mlp_layout([3 * item_cate, *cfg.mlp, 1]),
    }


def init_params(cfg: DINConfig, seed: int = 0, device=None) -> dict:
    return init_from_layout(_layout(cfg), seeded_generator(seed, device))


def params_from_numpy(tree: dict, cfg: DINConfig, device=None) -> dict:
    """The reference's parameter tree (numpy leaves) on ``device``."""
    return params_from_layout(tree, _layout(cfg), resolve_device(device))


def _embed_items(params, cfg, item_ids, cate_ids):
    it = embedding_lookup(params["item_table"], item_ids)
    ct = embedding_lookup(params["cate_table"], cate_ids)
    return torch.cat([it, ct], dim=-1).to(cfg.dtype)  # (..., 2d)


def _attend(params, hist, target, hist_mask):
    """hist: (B, S, D); target: (B, D) → attended history (B, D)."""
    t = target[:, None, :].expand(hist.shape)
    feats = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    scores = mlp_apply(params["attn"], feats)[..., 0]  # (B, S)
    scores = torch.where(hist_mask, scores, torch.full_like(scores, -1e30))
    # DIN uses un-normalized sigmoid weights rather than softmax
    w = torch.sigmoid(scores) * hist_mask.to(hist.dtype)
    return torch.einsum("bs,bsd->bd", w, hist)


def apply(params: dict, cfg: DINConfig, batch: dict) -> torch.Tensor:
    """batch: hist_items/hist_cates (B,S), target_item/target_cate (B,).

    Returns CTR logits (B,).
    """
    hist = _embed_items(params, cfg, batch["hist_items"], batch["hist_cates"])
    target = _embed_items(params, cfg, batch["target_item"], batch["target_cate"])
    mask = batch["hist_items"] >= 0
    user = _attend(params, hist, target, mask)
    feats = torch.cat([user, target, user * target], dim=-1)
    return mlp_apply(params["mlp"], feats)[..., 0]


def score_candidates(params: dict, cfg: DINConfig, batch: dict) -> torch.Tensor:
    """One user vs ``C`` candidates: hist (1,S), cand_items/cand_cates (C,).

    Returns (C,) logits as one batched attention+MLP evaluation.
    """
    hist = _embed_items(params, cfg, batch["hist_items"], batch["hist_cates"])  # (1,S,D)
    cands = _embed_items(params, cfg, batch["cand_items"], batch["cand_cates"])  # (C,D)
    mask = batch["hist_items"] >= 0  # (1,S)
    c = cands.shape[0]
    hist_b = hist.expand(c, *hist.shape[1:])
    mask_b = mask.expand(c, mask.shape[1])
    user = _attend(params, hist_b, cands, mask_b)  # (C,D)
    feats = torch.cat([user, cands, user * cands], dim=-1)
    return mlp_apply(params["mlp"], feats)[..., 0]


def loss_fn(params: dict, cfg: DINConfig, batch: dict) -> torch.Tensor:
    logits = apply(params, cfg, batch).to(torch.float32)
    labels = batch["label"].to(torch.float32)
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    )
