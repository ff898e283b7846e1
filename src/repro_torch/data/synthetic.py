"""Deterministic synthetic batch generators.

Every batch is a pure function of ``(seed, step)`` so the pipeline is
(a) resumable from a checkpointed step counter with zero drift, and
(b) identical across hosts — each data-parallel shard slices the same
logical batch, which is how a real multi-host input pipeline behaves.

The LM stream is not uniform noise: it is a Zipf-ish unigram mix with a
copy structure (spans repeated within the sequence) so the cross-entropy
actually decreases during the smoke-train runs and optimizer bugs surface.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["TokenPipeline", "lm_batch", "din_batch", "graph_node_features"]


def lm_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # Zipf unigram distribution over a capped alphabet
    alpha = 1.2
    support = min(vocab, 4096)
    ranks = np.arange(1, support + 1)
    probs = ranks ** -alpha
    probs /= probs.sum()
    toks = rng.choice(support, size=(batch, seq_len + 1), p=probs).astype(np.int32)
    # copy structure: repeat a random span once per row
    span = max(4, seq_len // 16)
    starts = rng.integers(0, seq_len - 2 * span, size=batch)
    for i in range(batch):
        s = starts[i]
        toks[i, s + span : s + 2 * span] = toks[i, s : s + span]
    return {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:].astype(np.int32),
    }


class TokenPipeline:
    """Stateful wrapper: iteration order is a pure function of (seed, step)."""

    def __init__(self, batch: int, seq_len: int, vocab: int, seed: int = 0, step: int = 0):
        self.batch, self.seq_len, self.vocab = batch, seq_len, vocab
        self.seed, self.step = seed, step

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_state(cls, batch, seq_len, vocab, state: dict) -> "TokenPipeline":
        return cls(batch, seq_len, vocab, seed=state["seed"], step=state["step"])

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = lm_batch(self.seed, self.step, self.batch, self.seq_len, self.vocab)
        self.step += 1
        return b


def din_batch(seed: int, step: int, batch: int, seq_len: int, n_items: int, n_cates: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
    hist = rng.zipf(1.3, size=(batch, seq_len)) % n_items
    lengths = rng.integers(1, seq_len + 1, size=batch)
    mask = np.arange(seq_len)[None, :] < lengths[:, None]
    hist = np.where(mask, hist, -1).astype(np.int32)
    target = (rng.zipf(1.3, size=batch) % n_items).astype(np.int32)
    # label correlates with target appearing in history → learnable signal
    label = ((hist == target[:, None]).any(axis=1) | (rng.random(batch) < 0.1)).astype(
        np.float32
    )
    return {
        "hist_items": hist,
        "hist_cates": np.where(hist >= 0, hist % n_cates, -1).astype(np.int32),
        "target_item": target,
        "target_cate": (target % n_cates).astype(np.int32),
        "label": label,
    }


def graph_node_features(seed: int, n_nodes: int, d_feat: int, n_classes: int):
    """Deterministic node features + labels with community structure."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feat = centers[labels] + 0.5 * rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    return feat.astype(np.float32), labels.astype(np.int32)
