"""Shared pieces of the five LM architecture configs.

Only the serving half is ported: the shape table and the reduced smoke
config.  The dry-run and train-step builders (``build_lm_dryrun``,
``make_lm_train_step``) wait for ROADMAP queue A items 7 and 9.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import TransformerConfig

__all__ = ["LM_SHAPES", "lm_smoke_config"]

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
