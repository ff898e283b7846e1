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
* :func:`quantize_kv_token` / :func:`decode_attention_int8` — the int8 KV
  cache: per-token int8 payloads with f32 scales, and decode with both dots
  on the int8 values, exact in int32 as the reference's
  ``preferred_element_type=int32`` dots.
* :func:`rope` / :func:`apply_rope` — rotary position embeddings, in f32.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.compression import INT32_MAX, ieee_div
from repro_torch.obs.cost import region

__all__ = [
    "flash_attention_torch",
    "decode_attention",
    "decode_attention_int8",
    "quantize_kv_token",
    "rope",
    "apply_rope",
]

_NEG_INF = -1e30


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


@region("attention")
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


def _quantize(x: torch.Tensor, scale: torch.Tensor, lo: int) -> torch.Tensor:
    """``clip(round(x / scale), lo, 127)`` as int8: one f32 division, rounded
    half to even as ``jnp.round``, so equal inputs give the reference's bits
    (the scales divide by 127 through ``ieee_div`` for the same reason)."""
    return torch.clamp(torch.round(x / scale), lo, 127).to(torch.int8)


def _int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 operands, exact in int32 (batched over leading dims).

    torch has no batched int8 or int32 matmul on CUDA (``torch._int_mm`` is
    2-d and needs more than 16 rows), so the dot runs in a float type in
    which every partial sum is an exact integer: float32 while
    ``127² · n < 2²⁴`` (the score dot, n = head dim ≤ 1,040), float64
    otherwise (the value dot, n = cache length: 2,080 at qwen2's serving
    shape), exact below 2⁵³.  The order of the sums then cannot change the
    result.  Past int32's bound (a cache longer than 133,143 tokens, as
    ``long_500k``'s) the sums come back in int64, where the reference's
    int32 accumulation could wrap.
    """
    n = a.shape[-1]
    bound = 127 * 127 * n
    if bound >= 1 << 53:
        raise OverflowError(f"an int8 dot over {n} terms is not exact in float64")
    ft = torch.float32 if bound < 1 << 24 else torch.float64
    return torch.matmul(a.to(ft), b.to(ft)).to(
        torch.int32 if bound <= INT32_MAX else torch.int64)


def _valid_keys(cache_len, s: int, device) -> torch.Tensor:
    """The (B or 1, 1, 1, S) mask of positions below ``cache_len`` (a scalar
    or a (B,) vector).  No host scalar is copied to the card here: such a
    copy waits for the card."""
    pos = torch.arange(s, device=device)
    if isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1:
        return (pos[None, :] < cache_len.to(device)[:, None])[:, None, None, :]
    return (pos < cache_len)[None, None, None, :]


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
    scores = scores.masked_fill(~_valid_keys(cache_len, s, q.device), _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", (p / torch.clamp_min(l, 1e-30)).to(q.dtype), v_cache)
    return out.reshape(b, hq, 1, d)


def quantize_kv_token(k: torch.Tensor, v: torch.Tensor):
    """Quantize K and V per (…, token) over the head dim: ``(…, D)`` → int8
    payloads and f32 scales ``(…)``, as ``(kq, k_scale, vq, v_scale)``.

    The scale is ``max(max|x| / 127, 1e-12)``; K's factors out of q·k after
    the dot along D, V's is folded into the probabilities at read time
    (:func:`decode_attention_int8`).
    """
    def one(x):
        xf = x.to(torch.float32)
        s = torch.clamp_min(ieee_div(torch.amax(torch.abs(xf), dim=-1, keepdim=True), 127.0),
                            1e-12)
        return _quantize(xf, s, -127), s[..., 0]

    kq, ks = one(k)
    vq, vs = one(v)
    return kq, ks, vq, vs


def decode_attention_int8(
    q: torch.Tensor,         # (B, Hq, 1, D) activations (bf16/f32)
    k_cache: torch.Tensor,   # (B, Hkv, S, D) int8
    k_scale: torch.Tensor,   # (B, Hkv, S) f32 per-token scales
    v_cache: torch.Tensor,   # (B, Hkv, S, D) int8
    v_scale: torch.Tensor,   # (B, Hkv, S) f32 per-token scales
    cache_len,               # valid prefix length: int, 0-d or (B,) tensor
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Decode against an int8 KV cache with int8 × int8 → int32 dots.

    q is quantized per (batch, head) on the fly; the score dequant is
    ``q_scale · k_scale[s]``.  For the value dot the per-token v scale is
    folded into the probabilities (p'ₛ = pₛ · v_scaleₛ) before they are
    quantized to [0, 127], so the second dot is int8 too and dequants by
    one scalar per (b, h, g).
    """
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    g = hq // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    qf = q.reshape(b, hkv, g, d).to(torch.float32)
    q_s = ieee_div(torch.clamp_min(torch.amax(torch.abs(qf), dim=-1, keepdim=True), 1e-12), 127.0)
    q_i8 = _quantize(qf, q_s, -127)
    scores_i32 = _int8_dot(q_i8, k_cache.transpose(-1, -2))       # (B, Hkv, G, S)
    scores = scores_i32.to(torch.float32) * q_s * k_scale[:, :, None, :] * sm_scale
    scores = scores.masked_fill(~_valid_keys(cache_len, s, q.device), _NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    # fold per-token v scales into p, then quantize p for the second dot
    p_eff = p * v_scale[:, :, None, :]
    p_s = ieee_div(torch.clamp_min(torch.amax(p_eff, dim=-1, keepdim=True), 1e-12), 127.0)
    p_i8 = _quantize(p_eff, p_s, 0)
    out_i32 = _int8_dot(p_i8, v_cache)                              # (B, Hkv, G, D)
    out = out_i32.to(torch.float32) * p_s
    return out.reshape(b, hq, 1, d).to(q.dtype)
