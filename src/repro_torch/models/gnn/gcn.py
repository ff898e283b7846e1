"""GCN (Kipf & Welling, arXiv:1609.02907) with symmetric normalization.

The counterpart of ``repro.models.gnn.gcn``, with the edge-partitioned
scheme of the reference's ``psum_axes`` (the paper's multi-GPU scheme
transplanted onto message passing: node features replicated, edge lists
partitioned across the mesh, partial aggregates reduced).  The reference
runs it inside ``shard_map``; here ``apply(..., mesh=mesh)`` takes the
edge lists as :class:`~repro_torch.distributed.ShardedTensor` blocks along
``cfg.psum_axes`` and, on the port's single-controller mesh, computes each
block's degree histogram and partial aggregate on the block's device, then
sums them onto the features' device (the mesh's lead) in the compute dtype
— bf16 on the wire when ``dtype`` is bf16, as the reference's explicit
``psum``.  Features and weights stay on the lead device: one copy is the
replicated copy of a single controller.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.sharding import ShardedTensor

from .common import (
    degrees_from_edges,
    edge_mask,
    gather_src,
    init_from_layout,
    mlp_layout,
    params_from_layout,
    params_to_numpy,
    scatter_sum,
    seeded_generator,
)

__all__ = ["GCNConfig", "init_params", "apply", "params_from_numpy", "params_to_numpy"]


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 1433
    d_out: int = 7
    dtype: object = torch.float32
    # §Perf: Ã(XW) ≡ (ÃX)W — aggregate in whichever width is narrower.
    # Under the edge-partitioned scheme the summed tensor is the aggregated
    # one, so ordering by min(d_in, d_out) directly shrinks the collective.
    smart_order: bool = False
    # the edge-partitioned scheme: per-layer partial aggregates are summed
    # over these mesh axes in the compute dtype; needs apply(..., mesh=)
    psum_axes: tuple | None = None


def _layout(cfg: GCNConfig) -> dict:
    sizes = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
    return {"layers": mlp_layout(sizes)}


def init_params(cfg: GCNConfig, seed: int = 0, device=None) -> dict:
    return init_from_layout(_layout(cfg), seeded_generator(seed, device))


def params_from_numpy(tree: dict, cfg: GCNConfig, device=None) -> dict:
    """The reference's parameter tree (numpy leaves) on ``device``."""
    return params_from_layout(tree, _layout(cfg), resolve_device(device))


def _spec_axes(x: ShardedTensor) -> tuple:
    e = x.spec[0] if len(x.spec) else None
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def _edge_blocks(cfg: GCNConfig, edge_src, edge_dst, mesh, lead: torch.device) -> list:
    """``[(src, dst, mask)]``: the whole edge list, or one entry per block of
    the edge-partitioned lists, each on its own device."""
    if not cfg.psum_axes:
        if mesh is not None:
            raise ValueError("mesh= runs the edge-partitioned GCN; set cfg.psum_axes to the "
                             "mesh axes the edge lists are split along")
        return [(edge_src, edge_dst, edge_mask(edge_src, edge_dst))]
    if mesh is None:
        raise ValueError(f"psum_axes={cfg.psum_axes} needs mesh= (the reference's psum "
                         "runs only inside shard_map)")
    if lead != mesh.lead:
        raise ValueError(f"node features on {lead}, but the mesh leads on {mesh.lead}")
    parts = []
    for name, x in (("edge_src", edge_src), ("edge_dst", edge_dst)):
        if not isinstance(x, ShardedTensor) or x.mesh is not mesh or x.ndim != 1 \
                or _spec_axes(x) != tuple(cfg.psum_axes):
            raise ValueError(f"{name}: expected a 1-d ShardedTensor on this mesh split along "
                             f"{tuple(cfg.psum_axes)}, got {x!r}")
        parts.append([blk for _, blk in x.unique_blocks()])
    return [(s, d, edge_mask(s, d)) for s, d in zip(*parts)]


def apply(
    params: dict,
    cfg: GCNConfig,
    node_feat: torch.Tensor,   # (N, d_in)
    positions=None,            # unused
    edge_src=None,
    edge_dst=None,
    mesh=None,
) -> torch.Tensor:
    n = node_feat.shape[0]
    lead = node_feat.device
    blocks = _edge_blocks(cfg, edge_src, edge_dst, mesh, lead)
    # Ã = D^{-1/2}(A + I)D^{-1/2}; degrees include the self loop.  Each
    # block's local histogram, summed (f32) into the global degrees.
    deg = None
    for _, dst, mask in blocks:
        part = degrees_from_edges(dst, n, mask).to(lead)
        deg = part if deg is None else deg + part
    deg = deg + 1.0
    inv_sqrt = torch.rsqrt(deg)
    coefs = []
    for src, dst, _ in blocks:
        inv = inv_sqrt.to(src.device)
        coefs.append((gather_src(inv, src) * gather_src(inv, dst))[:, None])
    x = node_feat.to(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        w = layer["w"].to(x.dtype)
        b = layer["b"].to(x.dtype)
        transform_first = (not cfg.smart_order) or w.shape[1] <= w.shape[0]
        h = x @ w if transform_first else x
        scat = None
        for (src, dst, mask), coef in zip(blocks, coefs):
            msg = gather_src(h.to(src.device), src) * coef.to(x.dtype)
            part = scatter_sum(msg, dst, n, mask).to(lead)   # compute dtype on the wire
            scat = part if scat is None else scat + part
        agg = scat + h * (inv_sqrt ** 2)[:, None].to(x.dtype)
        if not transform_first:
            agg = agg @ w
        agg = agg + b
        x = agg if i == len(params["layers"]) - 1 else torch.relu(agg)
    return x
