"""Decoder-only GQA transformer: the serving half, in PyTorch.

The counterpart of the JAX package's ``models/transformer.py`` for the
dense architectures, with the same parameter names, layouts and casts:

* **layers** — JAX stacks layer parameters and scans over them; here the
  parameters live in an ``nn.Module`` (a ``ModuleList`` of layers, each
  with ``nn.Parameter``\\ s named after the JAX keys, ``wq`` … ``w_down``,
  ``bq/bk/bv``) and the depth loop is a Python loop.  Matrices keep the
  JAX ``(in, out)`` layout (``x @ w``), so carrying weights across
  (:func:`params_from_numpy`) is a copy, not a transpose.
* **attention** — prefill goes through
  :func:`repro_torch.kernels.flash_attention.ops.attention`: the
  hand-written CUDA kernel for CUDA tensors, the plain blockwise version
  for CPU tensors.  Decode attention is plain torch ops, as in JAX.
* **serving weights** — JAX casts each f32 master to the compute dtype at
  every use (``p["wq"].astype(dt)``).  Serving here casts each once and
  keeps the copy (:meth:`TransformerParams.serving_weights`); a
  round-to-nearest cast of the same f32 values gives the same bits.
* **KV cache** — :func:`decode_step` writes the new token's K/V into the
  cache in place, where JAX donates the cache buffers and returns new ones.

Not yet ported (ROADMAP A7, the training half): the MoE layer (``_moe``),
the int8 KV cache (``cfg.kv_quant``) and :func:`loss_fn`; each raises.
Parameters are made with ``requires_grad=False``: nothing here trains.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.kernels.flash_attention import ops as attn_ops

from .attention import apply_rope, decode_attention, rope

__all__ = [
    "TransformerConfig",
    "TransformerParams",
    "init_params",
    "params_from_numpy",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_kv_cache",
    "init_kv_cache_int8",
]

_NOT_PORTED = "is not yet ported (ROADMAP A7: the training half); use the JAX package repro for it"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    n_experts: int = 0       # 0 → dense FFN
    top_k: int = 0
    norm_eps: float = 1e-5
    vocab_pad: int = 512     # vocab-parallel tables round up to this
    onehot_ce: bool = False  # CE via one-hot contraction (training half)
    kv_quant: bool = False   # int8 KV cache (not yet ported)
    dtype: Any = torch.bfloat16        # activation/compute dtype
    param_dtype: Any = torch.float32   # master parameter dtype
    remat: bool = True                 # training half; no effect on serving
    remat_policy: str = "full"
    # the JAX scan's kv block; the port ignores it (its kernel and plain
    # version keep their own blocks, which move results by f32 rounding only)
    attn_block_k: int = 512

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Tables round up to a multiple of ``vocab_pad``; padded logit
        columns are masked to −1e30."""
        return -(-self.vocab_size // self.vocab_pad) * self.vocab_pad

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.is_moe:
            mlp = self.n_experts * (3 * d * ff) + d * self.n_experts
        else:
            mlp = 3 * d * ff
        per_layer = attn + mlp + 2 * d
        return self.n_layers * per_layer + 2 * v * d + d


def _check_ported(cfg: TransformerConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: the MoE layer (_moe) " + _NOT_PORTED)
    if cfg.kv_quant:
        raise NotImplementedError(f"{cfg.name}: the int8 KV cache (kv_quant=True) " + _NOT_PORTED)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _layer_shapes(cfg: TransformerConfig) -> dict:
    d, hd, h, kv, ff = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    shapes = {
        "rms_attn": (d,), "rms_mlp": (d,),
        "wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d),
    }
    if cfg.qkv_bias:
        shapes.update(bq=(h * hd,), bk=(kv * hd,), bv=(kv * hd,))
    shapes.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
    return shapes


def _top_shapes(cfg: TransformerConfig) -> dict:
    return {"embed": (cfg.padded_vocab, cfg.d_model), "lm_head": (cfg.d_model, cfg.padded_vocab),
            "final_norm": (cfg.d_model,)}


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class LayerParams(nn.Module):
    """One layer's parameters, named as the JAX package's layer dict."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            setattr(self, name, _param(shape, cfg.param_dtype, device))


class TransformerParams(nn.Module):
    """``embed``, ``lm_head``, ``final_norm`` and ``layers`` (a ``ModuleList``)."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        for name, shape in _top_shapes(cfg).items():
            setattr(self, name, _param(shape, cfg.param_dtype, device))
        self.layers = nn.ModuleList(LayerParams(cfg, device) for _ in range(cfg.n_layers))
        self._serving: dict = {}

    def serving_weights(self, dtype: torch.dtype) -> dict:
        """The parameters as the compute dtype uses them, cast once and kept.

        Matrices, biases and the tables are cast to ``dtype`` (JAX casts
        them at every use, to the same values); the RMS-norm weights stay
        in their master dtype, as ``rms_norm`` reads them in f32.  Built
        at first use for each dtype; the parameters are not to change
        afterwards.
        """
        if dtype not in self._serving:
            def cast(name, t):
                return t if name.startswith("rms") or name == "final_norm" else t.to(dtype)

            top = {n: cast(n, p) for n, p in self.named_parameters(recurse=False)}
            top["layers"] = [{n: cast(n, p) for n, p in layer.named_parameters()}
                             for layer in self.layers]
            self._serving[dtype] = top
        return self._serving[dtype]


def _dense_init(shape, gen, device, scale=None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale


def init_params(cfg: TransformerConfig, seed: int = 0, device=None) -> TransformerParams:
    """Random parameters from ``seed`` (a ``torch.Generator`` on ``device``).

    The same distributions as the JAX package's ``init_params`` (normal
    · fan_in^−½, embedding scale 1, zero biases, unit norms), but not its
    numbers: ``torch`` and ``jax.random`` differ.  Tests carry JAX
    parameters across with :func:`params_from_numpy` instead.
    """
    _check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = TransformerParams(cfg, dev)
    with torch.no_grad():
        params.embed.copy_(_dense_init(params.embed.shape, gen, dev, 1.0))
        params.lm_head.copy_(_dense_init(params.lm_head.shape, gen, dev))
        params.final_norm.fill_(1.0)
        for layer in params.layers:
            for name, p in layer.named_parameters():
                if name.startswith("rms"):
                    p.fill_(1.0)
                elif name in ("bq", "bk", "bv"):
                    p.zero_()
                else:
                    p.copy_(_dense_init(p.shape, gen, dev))
    return params


def params_from_numpy(tree: dict, cfg: TransformerConfig, device=None) -> TransformerParams:
    """The JAX parameter pytree, leaves as numpy arrays, as port parameters.

    ``tree["layers"]`` holds each layer key stacked on a leading axis of
    length ``n_layers``, as the JAX package's ``init_params`` makes it.
    """
    _check_ported(cfg)
    dev = resolve_device(device)
    params = TransformerParams(cfg, dev)

    def put(p: nn.Parameter, value, what: str):
        value = np.asarray(value)
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{what}: shape {value.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(value, dtype=p.dtype))

    layers = tree["layers"]
    missing = set(_layer_shapes(cfg)) ^ set(layers)
    if missing:
        raise ValueError(f"layer keys differ from the config's: {sorted(missing)}")
    with torch.no_grad():
        for name in _top_shapes(cfg):
            put(getattr(params, name), tree[name], name)
        for i, layer in enumerate(params.layers):
            for name, p in layer.named_parameters():
                put(p, np.asarray(layers[name])[i], f"layers.{name}[{i}]")
    return params


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (nrm * w.to(torch.float32)).to(x.dtype)


def _swiglu(h: torch.Tensor, p: dict, dtype) -> torch.Tensor:
    g = h @ p["w_gate"]
    u = h @ p["w_up"]
    return (nn.functional.silu(g.to(torch.float32)).to(dtype) * u) @ p["w_down"]


def _qkv(x, p, cfg: TransformerConfig):
    """Projected q (B, H, S, hd), k and v (B, KV, S, hd), before RoPE."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, kv, hd).transpose(1, 2)
    v = v.reshape(b, s, kv, hd).transpose(1, 2)
    return q, k, v


def _attention_block(x, p, cfg: TransformerConfig, sin, cos):
    b, s, _ = x.shape
    q, k, v = _qkv(x, p, cfg)
    q = apply_rope(q, sin, cos).contiguous()
    k = apply_rope(k, sin, cos).contiguous()
    v = v.contiguous()
    o = attn_ops.attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    return o @ p["wo"], k, v


def _layer(x, p, cfg: TransformerConfig, sin, cos):
    attn_out, k, v = _attention_block(rms_norm(x, p["rms_attn"], cfg.norm_eps), p, cfg, sin, cos)
    x = x + attn_out
    hmid = rms_norm(x, p["rms_mlp"], cfg.norm_eps)
    return x + _swiglu(hmid, p, x.dtype), (k, v)


# ---------------------------------------------------------------------------
# forward / serving
# ---------------------------------------------------------------------------


def _mask_pad_vocab(logits: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Padded vocab columns set to −1e30, in place on a fresh logits tensor."""
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


@torch.no_grad()
def forward(params: TransformerParams, tokens: torch.Tensor, cfg: TransformerConfig,
            return_kv: bool = False):
    """tokens: (B, S) int → logits (B, S, V) [+ stacked KV caches (L, B, KV, S, hd)]."""
    _check_ported(cfg)
    w = params.serving_weights(cfg.dtype)
    dev = w["embed"].device
    tokens = tokens.to(dev)
    b, s = tokens.shape
    x = w["embed"][tokens]
    sin, cos = rope(torch.arange(s, device=dev), cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for layer_p in w["layers"]:
        x, (k, v) = _layer(x, layer_p, cfg, sin, cos)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, w["final_norm"], cfg.norm_eps)
    logits = _mask_pad_vocab(x @ w["lm_head"], cfg)
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def loss_fn(params, batch, cfg: TransformerConfig):
    """Next-token cross entropy of the JAX package; raises until ported."""
    raise NotImplementedError("loss_fn " + _NOT_PORTED)


def prefill(params: TransformerParams, tokens: torch.Tensor, cfg: TransformerConfig):
    """Serving prefill: returns (last-position logits, KV caches)."""
    logits, kv = forward(params, tokens, cfg, return_kv=True)
    return logits[:, -1], kv


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None):
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def init_kv_cache_int8(cfg: TransformerConfig, batch: int, max_len: int):
    """The int8 KV cache of the JAX package; raises until ported."""
    raise NotImplementedError("init_kv_cache_int8 " + _NOT_PORTED)


@torch.no_grad()
def decode_step(params: TransformerParams, token: torch.Tensor, pos: int, kv_cache,
                cfg: TransformerConfig):
    """One greedy decode step at position ``pos`` (= cache length).

    ``kv_cache`` is ``(k, v)`` of shape (L, B, KV, S_max, hd); the new
    token's K/V are written into it in place.  Returns (logits (B, V) f32,
    the same cache).
    """
    _check_ported(cfg)
    w = params.serving_weights(cfg.dtype)
    dev = w["embed"].device
    pos = int(pos)
    k_cache, v_cache = kv_cache
    if not 0 <= pos < k_cache.shape[3]:
        raise IndexError(f"position {pos} is outside the cache of length {k_cache.shape[3]}")
    token = token.to(dev)
    b = token.shape[0]
    nh, hd = cfg.n_heads, cfg.head_dim
    x = w["embed"][token[:, None]]  # (B, 1, d)
    sin, cos = rope(torch.arange(pos, pos + 1, device=dev), hd, cfg.rope_theta)
    for i, layer_p in enumerate(w["layers"]):
        h = rms_norm(x, layer_p["rms_attn"], cfg.norm_eps)
        q, k, v = _qkv(h, layer_p, cfg)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        k_cache[i, :, :, pos:pos + 1] = k.to(k_cache.dtype)
        v_cache[i, :, :, pos:pos + 1] = v.to(v_cache.dtype)
        o = decode_attention(q, k_cache[i], v_cache[i], cache_len=pos + 1)
        o = o.transpose(1, 2).reshape(b, 1, nh * hd)
        x = x + o @ layer_p["wo"]
        hmid = rms_norm(x, layer_p["rms_mlp"], cfg.norm_eps)
        x = x + _swiglu(hmid, layer_p, x.dtype)
    x = rms_norm(x, w["final_norm"], cfg.norm_eps)
    logits = _mask_pad_vocab((x @ w["lm_head"])[:, 0], cfg)
    return logits.to(torch.float32), (k_cache, v_cache)
