"""Shared message-passing primitives for all GNN architectures.

The counterpart of ``repro.models.gnn.common``.  Message passing is gather
→ elementwise → scatter over an edge-index list, the same SoA edge array
the triangle-counting core uses: ``index_select`` for the gathers,
``index_add`` for the reference's ``segment_sum`` (atomic on the card, so
float sums there reorder from run to run) and ``scatter_reduce(amax)`` for
its ``segment_max``.  Indices stay int32.  Padded edges carry ``src == -1``
and are masked out of every reduction; a −1 ``dst`` is clamped to node 0
and its masked message still lands there, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device

__all__ = [
    "edge_mask",
    "gather_src",
    "scatter_sum",
    "scatter_mean",
    "scatter_max",
    "degrees_from_edges",
    "mlp_init",
    "mlp_apply",
]


def edge_mask(edge_src: torch.Tensor, edge_dst: torch.Tensor) -> torch.Tensor:
    return (edge_src >= 0) & (edge_dst >= 0)


def gather_src(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows with −1-safe indices (clamped; caller masks)."""
    return x.index_select(0, idx.clamp_min(0))


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` over ``seg.clamp_min(0)`` by ``index_add``."""
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add(0, seg.clamp_min(0), values)


def segment_max(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: ``-inf`` where a segment is empty."""
    idx = seg.clamp_min(0).to(torch.int64).reshape(-1, *([1] * (values.dim() - 1)))
    out = torch.full((n, *values.shape[1:]), float("-inf"), dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, idx.expand_as(values), values, "amax", include_self=False)


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                mask=None) -> torch.Tensor:
    if mask is not None:
        messages = messages * mask[..., None].to(messages.dtype)
    return segment_sum(messages, dst, n_nodes)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                 mask=None) -> torch.Tensor:
    s = scatter_sum(messages, dst, n_nodes, mask)
    ones = torch.ones(messages.shape[:1], dtype=messages.dtype, device=messages.device)
    if mask is not None:
        ones = ones * mask.to(messages.dtype)
    cnt = segment_sum(ones, dst, n_nodes)
    return s / torch.clamp_min(cnt, 1.0)[:, None]


def scatter_max(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                mask=None) -> torch.Tensor:
    """Masked messages read −1e30, and only a non-finite result becomes 0:
    a node whose incoming edges are all padded reads −1e30, not 0."""
    if mask is not None:
        messages = torch.where(mask[..., None], messages,
                               torch.full_like(messages, -1e30))
    out = segment_max(messages, dst, n_nodes)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def degrees_from_edges(dst: torch.Tensor, n_nodes: int, mask=None) -> torch.Tensor:
    ones = torch.ones(dst.shape[0], dtype=torch.float32, device=dst.device)
    if mask is not None:
        ones = ones * mask.to(torch.float32)
    return segment_sum(ones, dst, n_nodes)


def mlp_layout(sizes) -> list:
    """The layout of :func:`mlp_init`'s tree (see :func:`init_from_layout`)."""
    return [{"w": ("normal", (a, b), a ** -0.5), "b": ("zeros", (b,))}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_init(generator: torch.Generator, sizes, param_dtype=torch.float32) -> list:
    """``[{"w": (a, b), "b": (b,)}, ...]``, ``w`` normal over √a, on the
    generator's device (the reference takes a key)."""
    return init_from_layout(mlp_layout(sizes), generator, param_dtype)


def mlp_apply(params, x: torch.Tensor, act=F.silu, final_act=None) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"].to(x.dtype) + layer["b"].to(x.dtype)
        if i < len(params) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


# ---------------------------------------------------------------------------
# parameter trees: a model's layout is its tree (dicts and lists, the
# reference's keys) with leaves ("normal", shape, scale) or ("zeros", shape)
# ---------------------------------------------------------------------------


def _map_layout(fn, layout, tree=None, path=""):
    if isinstance(layout, dict):
        if tree is not None and set(tree) != set(layout):
            raise ValueError(f"{path or 'the tree'}: keys {sorted(tree)}, "
                             f"expected {sorted(layout)}")
        return {k: _map_layout(fn, layout[k], None if tree is None else tree[k],
                               f"{path}/{k}" if path else k) for k in sorted(layout)}
    if isinstance(layout, list):
        if tree is not None and len(tree) != len(layout):
            raise ValueError(f"{path}: {len(tree)} entries, expected {len(layout)}")
        return [_map_layout(fn, s, None if tree is None else tree[i], f"{path}[{i}]")
                for i, s in enumerate(layout)]
    return fn(layout, tree, path)


def seeded_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the card by default) seeded with
    ``seed``: the port's ``jax.random.PRNGKey(seed)``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return gen


def init_from_layout(layout, generator: torch.Generator, param_dtype=torch.float32):
    """A fresh tree: each ``normal`` leaf ``randn · scale`` drawn in f32 from
    ``generator`` (leaves in sorted-key order), each ``zeros`` leaf zeros,
    cast to ``param_dtype``, on the generator's device."""
    dev = generator.device

    def make(spec, _, __):
        if spec[0] == "zeros":
            return torch.zeros(spec[1], dtype=param_dtype, device=dev)
        x = torch.randn(spec[1], generator=generator, device=dev, dtype=torch.float32)
        return (x * spec[2]).to(param_dtype)

    return _map_layout(make, layout)


def meta_from_layout(layout, param_dtype=torch.float32) -> dict:
    """The tree of a layout as ``meta`` tensors (shapes without memory): the
    port's ``jax.eval_shape`` of an ``init_params``, for the dry run."""
    return _map_layout(lambda spec, _, __: torch.empty(spec[1], dtype=param_dtype,
                                                       device="meta"), layout)


def params_from_layout(tree, layout, device) -> dict:
    """The reference's tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) as f32 tensors on ``device``; a missing key, a list of
    another length or a leaf of another shape raises."""
    def put(spec, value, path):
        value = np.asarray(value)
        if tuple(value.shape) != tuple(spec[1]):
            raise ValueError(f"{path}: shape {value.shape} != {tuple(spec[1])}")
        return torch.tensor(value, dtype=torch.float32, device=device)

    return _map_layout(put, layout, tree)


def params_to_numpy(params):
    """The inverse of :func:`params_from_layout`: the same tree of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()
