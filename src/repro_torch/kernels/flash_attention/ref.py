"""Dense oracle for flash attention (GQA-aware), plain PyTorch."""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Materialises the (Sq, Skv) scores.  A causal query row with no valid
    key gets the mean of v here (softmax of an all −1e30 row), where the
    blockwise versions output 0."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * sm_scale
    if causal:
        mask = torch.tril(torch.ones((sq, skv), dtype=torch.bool, device=q.device),
                          diagonal=skv - sq)
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)
