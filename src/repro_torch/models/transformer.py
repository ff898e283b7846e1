"""Decoder-only GQA transformer of the five LM architectures, in PyTorch.

The counterpart of the JAX package's ``models/transformer.py``, with the
same parameter names, layouts and casts:

* **layers** — JAX stacks layer parameters and scans over them; here the
  parameters live in an ``nn.Module`` (a ``ModuleList`` of layers, each
  with ``nn.Parameter``\\ s named after the JAX keys, ``wq`` … ``w_down``,
  ``bq/bk/bv``, ``router``) and the depth loop is a Python loop.  Matrices
  keep the JAX ``(in, out)`` layout (``x @ w``; experts ``(E, in, out)``),
  so carrying weights across (:func:`params_from_numpy`,
  :func:`params_to_numpy`) is a copy, not a transpose.
* **attention** — prefill and training go through
  :func:`repro_torch.kernels.flash_attention.ops.attention`: the
  hand-written CUDA kernel for CUDA tensors (under autograd its backward
  recomputes the plain version), the plain blockwise version for CPU
  tensors.  Decode attention is plain torch ops, as in JAX.
* **MoE** — :func:`_moe` routes as the reference (top-k of the f32 router
  softmax, renormalised, a stable sort of the expert ids) and runs one
  matmul per expert over its contiguous rows where JAX runs one
  ``ragged_dot`` (XLA, not Pallas); rows are combined with ``index_add``.
* **training** — the f32 masters are trainable ``nn.Parameter``\\ s.
  :func:`loss_fn` runs a grad-enabled forward that casts each master to
  the compute dtype at every use, as JAX's ``p["wq"].astype(dt)``, so the
  gradients reach the masters in f32; ``cfg.remat`` wraps each layer in
  ``torch.utils.checkpoint`` (``remat_policy="dots"`` keeps the matmul
  outputs, as ``dots_saveable``).
* **serving weights** — the no-grad serving path casts each master once
  and keeps the copy (:meth:`TransformerParams.serving_weights`); a
  round-to-nearest cast of the same f32 values gives the same bits.  The
  copy is rebuilt when a parameter changes (an optimizer step).
* **KV cache** — :func:`decode_step` writes the new token's K/V into the
  cache in place, where JAX donates the cache buffers and returns new ones.
  With ``cfg.kv_quant`` the cache is the int8 4-tuple of
  :func:`init_kv_cache_int8` and decode attention is
  :func:`~repro_torch.models.attention.decode_attention_int8`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch._device import resolve_device
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.obs.cost import region

from .attention import (
    apply_rope,
    decode_attention,
    decode_attention_int8,
    quantize_kv_token,
    rope,
)

__all__ = [
    "TransformerConfig",
    "TransformerParams",
    "init_params",
    "params_from_numpy",
    "params_to_numpy",
    "param_tree",
    "params_from_tree",
    "load_numpy_",
    "tensors_from_numpy",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_kv_cache",
    "init_kv_cache_int8",
]

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
    onehot_ce: bool = False  # CE via one-hot contraction
    kv_quant: bool = False   # int8 KV cache + int8×int8 decode dots
    dtype: Any = torch.bfloat16        # activation/compute dtype
    param_dtype: Any = torch.float32   # master parameter dtype
    remat: bool = True                 # training only; no effect on serving
    remat_policy: str = "full"         # "full" | "dots" (keep matmul outputs)
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

    def bytes_per_param(self) -> int:
        return self.param_dtype.itemsize

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

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params()
        d, ff = self.d_model, self.d_ff
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        mlp = self.top_k * (3 * d * ff) + d * self.n_experts
        per_layer = attn + mlp + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab_size * d + d


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
    if cfg.is_moe:
        e = cfg.n_experts
        shapes.update(router=(d, e), w_gate=(e, d, ff), w_up=(e, d, ff), w_down=(e, ff, d))
    else:
        shapes.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
    return shapes


def _top_shapes(cfg: TransformerConfig) -> dict:
    return {"embed": (cfg.padded_vocab, cfg.d_model), "lm_head": (cfg.d_model, cfg.padded_vocab),
            "final_norm": (cfg.d_model,)}


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def _cast(name: str, t: torch.Tensor, dtype) -> torch.Tensor:
    """A master as the compute dtype uses it: the RMS-norm weights stay in
    their master dtype (``rms_norm`` reads them in f32), the rest is cast."""
    return t if name.startswith("rms") or name == "final_norm" else t.to(dtype)


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

    def _versions(self) -> tuple:
        return tuple(p._version for p in self.parameters())

    @torch.no_grad()
    def serving_weights(self, dtype: torch.dtype) -> dict:
        """The parameters as the compute dtype uses them, cast once and kept.

        Matrices, biases and the tables are cast to ``dtype`` (JAX casts
        them at every use, to the same values); the RMS-norm weights stay
        in their master dtype.  Built at first use for each dtype, and
        built again when any parameter has changed since (each in-place
        update raises the tensor's ``_version``), so serving after an
        optimizer step reads the new weights.
        """
        versions = self._versions()
        kept = self._serving.get(dtype)
        if kept is None or kept[0] != versions:
            top = {n: _cast(n, p, dtype) for n, p in self.named_parameters(recurse=False)}
            top["layers"] = [{n: _cast(n, p, dtype) for n, p in layer.named_parameters()}
                             for layer in self.layers]
            self._serving[dtype] = kept = (versions, top)
        return kept[1]


def param_tree(params: TransformerParams) -> dict:
    """The parameters as a tree in the reference's nesting, leaves the
    ``nn.Parameter``\\ s themselves: ``{"embed", "final_norm", "lm_head",
    "layers": [one dict per layer]}``.  The optimizer's trees (gradients,
    moments) have this shape; :func:`params_to_numpy` stacks ``layers``."""
    tree = {n: p for n, p in params.named_parameters(recurse=False)}
    tree["layers"] = [dict(layer.named_parameters()) for layer in params.layers]
    return tree


def params_from_tree(tree: dict, cfg: TransformerConfig) -> TransformerParams:
    """Port parameters whose ``nn.Parameter``\\ s are the tensors of a
    :func:`param_tree`-shaped tree, taken as they are (no copy): a sharded
    train step's weights gathered onto one device."""
    params = TransformerParams(cfg, torch.device("meta"))

    def put(module: nn.Module, name: str, t: torch.Tensor, what: str):
        if tuple(t.shape) != tuple(getattr(module, name).shape):
            raise ValueError(f"{what}: shape {tuple(t.shape)} != "
                             f"{tuple(getattr(module, name).shape)}")
        setattr(module, name, nn.Parameter(t))

    for name in _top_shapes(cfg):
        put(params, name, tree[name], name)
    for i, (layer, leaves) in enumerate(zip(params.layers, tree["layers"], strict=True)):
        for name in _layer_shapes(cfg):
            put(layer, name, leaves[name], f"layers.{name}[{i}]")
    return params


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
    dev = resolve_device(device)
    params = TransformerParams(cfg, dev)
    missing = set(_layer_shapes(cfg)) ^ set(tree["layers"])
    if missing:
        raise ValueError(f"layer keys differ from the config's: {sorted(missing)}")
    load_numpy_(param_tree(params), tree)
    return params


@torch.no_grad()
def load_numpy_(dst: dict, tree: dict) -> None:
    """Copy a reference-layout numpy tree (``layers`` stacked) into the
    tensors of a :func:`param_tree`-shaped tree, in place."""
    def put(t: torch.Tensor, value, what: str):
        value = np.asarray(value)
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{what}: shape {value.shape} != {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(t.dtype))

    for name, t in dst.items():
        if name != "layers":
            put(t, tree[name], name)
    for i, layer in enumerate(dst["layers"]):
        for name, t in layer.items():
            put(t, np.asarray(tree["layers"][name])[i], f"layers.{name}[{i}]")


def params_to_numpy(params) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's pytree of
    numpy arrays, each layer key stacked on a leading axis of length
    ``n_layers``.  Takes :class:`TransformerParams` or any tree of the
    :func:`param_tree` shape (gradients, optimizer moments)."""
    tree = param_tree(params) if isinstance(params, TransformerParams) else params
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    out = {n: host(t) for n, t in tree.items() if n != "layers"}
    out["layers"] = {n: np.stack([host(layer[n]) for layer in tree["layers"]])
                     for n in tree["layers"][0]}
    return out


def tensors_from_numpy(tree: dict, device=None, dtype=torch.float32) -> dict:
    """A reference-layout numpy tree as new tensors in the
    :func:`param_tree` shape (``layers`` unstacked): gradients or optimizer
    moments carried from the JAX package or a checkpoint."""
    dev = resolve_device(device)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=dev)  # noqa: E731
    out = {n: as_t(a) for n, a in tree.items() if n != "layers"}
    layers = tree["layers"]
    n_layers = len(next(iter(layers.values())))
    out["layers"] = [{n: as_t(np.asarray(a)[i]) for n, a in layers.items()}
                     for i in range(n_layers)]
    return out


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


def _moe(h: torch.Tensor, p: dict, cfg: TransformerConfig) -> torch.Tensor:
    """Sort-based top-k MoE: h (T, d) flattened tokens → (T, d).

    The reference's routing in plain torch ops: the router softmax in
    f32, its top k renormalised, the T·k (token, expert) rows sorted by a
    stable sort of the expert ids, then one matmul per expert over its
    contiguous rows (the reference's ``ragged_dot``), the rows weighted and
    added back to their tokens.  The group sizes come to the host (one
    synchronise a layer) to cut the rows.  ``p`` holds the weights in the
    compute dtype, the router included.
    """
    t, d = h.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = (h @ p["router"].to(h.dtype)).to(torch.float32)          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower expert first among equal
    # probabilities, as jax.lax.top_k does (torch.topk leaves ties unordered)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]                          # (T, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)            # renormalise
    flat_e = top_e.reshape(-1)                                         # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    token_of = order // k                                              # source token per row
    xs = h[token_of]                                                   # (T·k, d) by expert
    if h.device.type == "meta":
        # the dry run: no ids to count, so the T·k rows split evenly over
        # the experts (the FLOPs of any split: 2·T·k·d·f a product)
        sizes = [t * k // e + (i < t * k % e) for i in range(e)]
    else:
        sizes = torch.bincount(flat_e, minlength=e).tolist()
    out = _experts(xs, sizes, p, h.dtype)
    w_sorted = top_w.reshape(-1)[order].to(out.dtype)
    out = out * w_sorted[:, None]
    return torch.zeros((t, d), dtype=out.dtype, device=h.device).index_add(0, token_of, out)


@region("ragged_dot")
def _experts(xs: torch.Tensor, sizes: list, p: dict, dtype) -> torch.Tensor:
    """Each expert's SwiGLU over its contiguous rows of ``xs``: the
    reference's three ``ragged_dot`` products (the cost walker counts them
    under that name)."""
    outs, start = [], 0
    for i, n in enumerate(sizes):
        if n:
            rows = xs[start:start + n]
            g = rows @ p["w_gate"][i]
            u = rows @ p["w_up"][i]
            act = nn.functional.silu(g.to(torch.float32)).to(dtype) * u
            outs.append(act @ p["w_down"][i])
        start += n
    return torch.cat(outs) if outs else xs.new_zeros((0, xs.shape[1]))


def _mlp(hmid: torch.Tensor, p: dict, cfg: TransformerConfig) -> torch.Tensor:
    if not cfg.is_moe:
        return _swiglu(hmid, p, hmid.dtype)
    b, s, d = hmid.shape
    return _moe(hmid.reshape(b * s, d), p, cfg).reshape(b, s, d)


def _layer(x, p, cfg: TransformerConfig, sin, cos):
    attn_out, k, v = _attention_block(rms_norm(x, p["rms_attn"], cfg.norm_eps), p, cfg, sin, cos)
    x = x + attn_out
    hmid = rms_norm(x, p["rms_mlp"], cfg.norm_eps)
    return x + _mlp(hmid, p, cfg), (k, v)


# ---------------------------------------------------------------------------
# forward / serving
# ---------------------------------------------------------------------------


def _mask_pad_vocab(logits: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Padded vocab columns set to −1e30, in place on a fresh logits tensor
    (the no-grad serving path)."""
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _masked_pad_vocab(logits: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Out of place, for autograd: the padded columns' gradients are 0, as
    under JAX's ``where``."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad_col = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad_col, -1e30)


# the matmul outputs "dots" remat keeps (jax.checkpoint_policies.dots_saveable)
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _train_layer(x, layer: LayerParams, cfg: TransformerConfig, sin, cos):
    """One layer with grad enabled, each master cast at this use."""
    p = {n: _cast(n, t, cfg.dtype) for n, t in layer.named_parameters()}
    return _layer(x, p, cfg, sin, cos)[0]


def _train_logits(params: TransformerParams, tokens, cfg: TransformerConfig) -> torch.Tensor:
    """The grad-enabled forward: tokens (B, S) → logits (B, S, V) in
    ``cfg.dtype``, padded columns at −1e30.  ``cfg.remat`` recomputes each
    layer in the backward (``checkpoint``, non-reentrant): ``"full"``
    keeps only the layer's input, ``"dots"`` also its matmul outputs."""
    dev = params.embed.device
    tokens = torch.as_tensor(tokens).to(dev).long()
    s = tokens.shape[1]
    x = params.embed[tokens].to(cfg.dtype)
    sin, cos = rope(torch.arange(s, device=dev), cfg.head_dim, cfg.rope_theta)
    body = _train_layer
    if cfg.remat:
        kw = {}
        if cfg.remat_policy == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        body = functools.partial(checkpoint, _train_layer, use_reentrant=False,
                                 preserve_rng_state=False, **kw)
    for layer in params.layers:
        x = body(x, layer, cfg, sin, cos)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _masked_pad_vocab(x @ params.lm_head.to(cfg.dtype), cfg)


@torch.no_grad()
def forward(params: TransformerParams, tokens: torch.Tensor, cfg: TransformerConfig,
            return_kv: bool = False):
    """tokens: (B, S) int → logits (B, S, V) [+ stacked KV caches (L, B, KV, S, hd)]."""
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


def loss_fn(params: TransformerParams, batch: dict, cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross entropy; batch = {tokens, labels, mask?} (tensors
    or numpy arrays), differentiable in the f32 masters.

    With ``cfg.onehot_ce`` the label log-prob is a one-hot contraction of
    the max-shifted logits (the max detached, as JAX's ``stop_gradient``);
    otherwise ``log_softmax`` and a gather.  Logits are f32.
    """
    dev = params.embed.device
    logits = _train_logits(params, batch["tokens"], cfg).to(torch.float32)
    labels = torch.as_tensor(batch["labels"]).to(dev).long()
    if cfg.onehot_ce:
        m = torch.amax(logits, dim=-1, keepdim=True)
        shifted = logits - m.detach()
        lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
        onehot = nn.functional.one_hot(labels, cfg.padded_vocab).to(logits.dtype)
        picked = torch.einsum("bsv,bsv->bs", shifted, onehot)
        ll = picked - lse
    else:
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        return -torch.mean(ll)
    mask = torch.as_tensor(mask).to(device=dev, dtype=ll.dtype)
    return -torch.sum(ll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def prefill(params: TransformerParams, tokens: torch.Tensor, cfg: TransformerConfig):
    """Serving prefill: returns (last-position logits, KV caches)."""
    logits, kv = forward(params, tokens, cfg, return_kv=True)
    return logits[:, -1], kv


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None):
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def init_kv_cache_int8(cfg: TransformerConfig, batch: int, max_len: int, device=None):
    """(k int8, k_scale f32, v int8, v_scale f32): payloads (L, B, KV, S, hd),
    scales (L, B, KV, S) — about 2.2× smaller than a bf16 cache."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev))


@torch.no_grad()
def decode_step(params: TransformerParams, token: torch.Tensor, pos: int, kv_cache,
                cfg: TransformerConfig):
    """One greedy decode step at position ``pos`` (= cache length).

    ``kv_cache`` is ``(k, v)`` of shape (L, B, KV, S_max, hd), or with
    ``cfg.kv_quant`` the 4-tuple ``(k_i8, k_scale, v_i8, v_scale)`` of
    :func:`init_kv_cache_int8`; the new token's K/V are written into it in
    place.  Returns (logits (B, V) f32, the same cache).
    """
    w = params.serving_weights(cfg.dtype)
    dev = w["embed"].device
    pos = int(pos)
    s_max = kv_cache[0].shape[3]
    if not 0 <= pos < s_max:
        raise IndexError(f"position {pos} is outside the cache of length {s_max}")
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
        if cfg.kv_quant:
            k_cache, k_s, v_cache, v_s = kv_cache
            kq, ks_tok, vq, vs_tok = quantize_kv_token(k, v)
            k_cache[i, :, :, pos:pos + 1] = kq
            v_cache[i, :, :, pos:pos + 1] = vq
            k_s[i, :, :, pos:pos + 1] = ks_tok
            v_s[i, :, :, pos:pos + 1] = vs_tok
            o = decode_attention_int8(q, k_cache[i], k_s[i], v_cache[i], v_s[i],
                                      cache_len=pos + 1)
        else:
            k_cache, v_cache = kv_cache
            k_cache[i, :, :, pos:pos + 1] = k.to(k_cache.dtype)
            v_cache[i, :, :, pos:pos + 1] = v.to(v_cache.dtype)
            o = decode_attention(q, k_cache[i], v_cache[i], cache_len=pos + 1)
        o = o.transpose(1, 2).reshape(b, 1, nh * hd)
        x = x + o @ layer_p["wo"]
        hmid = rms_norm(x, layer_p["rms_mlp"], cfg.norm_eps)
        x = x + _mlp(hmid, layer_p, cfg)
    x = rms_norm(x, w["final_norm"], cfg.norm_eps)
    logits = _mask_pad_vocab((x @ w["lm_head"])[:, 0], cfg)
    return logits.to(torch.float32), kv_cache
