"""Attention primitives shared by the LM architectures (plain PyTorch).

* :func:`flash_attention_torch` — blockwise softmax attention with a
  running (max, sum, accumulator) state over KV blocks, the counterpart of
  the JAX package's ``flash_attention_jnp`` (a ``lax.scan`` there, a
  Python loop here), with the same casts and the same ``block_k``.  It is
  the plain version of the CUDA kernel in
  :mod:`repro_torch.kernels.flash_attention`, and what
  :func:`repro_torch.kernels.flash_attention.ops.attention` runs on CPU
  tensors.
* :func:`decode_attention` — single-token decode against a dense KV cache.
* :func:`rope` / :func:`apply_rope` — rotary position embeddings, in f32.
"""
from __future__ import annotations

import torch

__all__ = [
    "flash_attention_torch",
    "decode_attention",
    "decode_attention_int8",
    "quantize_kv_token",
    "rope",
    "apply_rope",
]

_NEG_INF = -1e30
_NOT_PORTED = "is not yet ported (ROADMAP A7b: the int8 KV cache); use the JAX package repro for it"


def rope(positions: torch.Tensor, d_head: int, theta: float = 10000.0):
    """(sin, cos) tables for rotary embeddings; positions: (..., S)."""
    half = d_head // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = theta ** (-idx / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate pairs. x: (B, H, S, D); sin/cos: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:
        sin = sin[None, None]
        cos = cos[None, None]
    else:
        sin = sin[:, None]
        cos = cos[:, None]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def flash_attention_torch(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: float | None = None,
    block_k: int = 512,
) -> torch.Tensor:
    """GQA softmax attention, one KV block at a time; output in q's dtype.

    The causal mask is bottom-right aligned (query i sees key j when
    ``i + Skv - Sq >= j``); a query row with no valid key outputs 0.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    bk = min(block_k, skv)
    nk = -(-skv // bk)
    qg = q.reshape(b, hkv, g, sq, d)
    q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    for jk in range(nk):
        k_blk = k[:, :, jk * bk:(jk + 1) * bk]
        v_blk = v[:, :, jk * bk:(jk + 1) * bk]
        n = k_blk.shape[2]
        if n < bk:  # zero padding, as the reference pads the last block
            pad = (0, 0, 0, bk - n)
            k_blk = torch.nn.functional.pad(k_blk, pad)
            v_blk = torch.nn.functional.pad(v_blk, pad)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_blk).to(torch.float32) * sm_scale
        k_pos = jk * bk + torch.arange(bk, device=q.device)
        valid = k_pos < skv
        if causal:
            valid = valid[None, :] & (q_pos[:, None] + (skv - sq) >= k_pos[None, :])
        s = s.masked_fill(~valid, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        # masked (not bare exp) so a fully-masked block contributes 0, not e⁰
        p = torch.exp(s - m_new[..., None]).masked_fill(s <= _NEG_INF / 2, 0.0)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(v_blk.dtype), v_blk
        ).to(torch.float32)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, hq, sq, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # (B, Hq, 1, D) — one new token
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    cache_len,              # valid prefix length: int, 0-d or (B,) tensor
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Single-step decode over the valid prefix of a dense cache."""
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    qg = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache).to(torch.float32) * sm_scale
    pos = torch.arange(s, device=q.device)
    # no host scalar is copied to the card here: such a copy waits for the card
    if isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1:
        valid = (pos[None, :] < cache_len.to(q.device)[:, None])[:, None, None, :]
    else:
        valid = (pos < cache_len)[None, None, None, :]
    scores = scores.masked_fill(~valid, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", (p / torch.clamp_min(l, 1e-30)).to(q.dtype), v_cache)
    return out.reshape(b, hq, 1, d)


def quantize_kv_token(k, v):
    """int8 KV quantisation of the JAX package; raises until ported."""
    raise NotImplementedError("quantize_kv_token " + _NOT_PORTED)


def decode_attention_int8(q, k_cache, k_scale, v_cache, v_scale, cache_len, sm_scale=None):
    """Decode against an int8 KV cache; raises until ported."""
    raise NotImplementedError("decode_attention_int8 " + _NOT_PORTED)
