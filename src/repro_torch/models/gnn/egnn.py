"""EGNN (Satorras et al., arXiv:2102.09844): E(n)-equivariant GNN.

The counterpart of ``repro.models.gnn.egnn``.  Scalar messages from
invariant distances; coordinates updated along relative-position vectors —
equivariance without spherical harmonics.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device

from .common import (
    edge_mask,
    gather_src,
    init_from_layout,
    mlp_apply,
    mlp_layout,
    params_from_layout,
    params_to_numpy,
    scatter_mean,
    scatter_sum,
    seeded_generator,
)

__all__ = ["EGNNConfig", "init_params", "apply", "params_from_numpy", "params_to_numpy"]


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    d_out: int = 1
    update_coords: bool = True
    dtype: object = torch.float32


def _layout(cfg: EGNNConfig) -> dict:
    d = cfg.d_hidden
    return {
        "embed": ("normal", (cfg.d_in, d), cfg.d_in ** -0.5),
        "layers": [{"phi_e": mlp_layout([2 * d + 1, d, d]),
                    "phi_x": mlp_layout([d, d, 1]),
                    "phi_h": mlp_layout([2 * d, d, d])} for _ in range(cfg.n_layers)],
        "readout": mlp_layout([d, d, cfg.d_out]),
    }


def init_params(cfg: EGNNConfig, seed: int = 0, device=None) -> dict:
    return init_from_layout(_layout(cfg), seeded_generator(seed, device))


def params_from_numpy(tree: dict, cfg: EGNNConfig, device=None) -> dict:
    """The reference's parameter tree (numpy leaves) on ``device``."""
    return params_from_layout(tree, _layout(cfg), resolve_device(device))


def apply(
    params: dict,
    cfg: EGNNConfig,
    node_feat: torch.Tensor,   # (N, d_in)
    positions: torch.Tensor,   # (N, 3)
    edge_src: torch.Tensor = None,
    edge_dst: torch.Tensor = None,
) -> torch.Tensor:
    n = node_feat.shape[0]
    mask = edge_mask(edge_src, edge_dst)
    h = (node_feat @ params["embed"]).to(cfg.dtype)
    x = positions.to(cfg.dtype)
    for layer in params["layers"]:
        hi = gather_src(h, edge_dst)   # receiving node i
        hj = gather_src(h, edge_src)   # sending node j
        xi = gather_src(x, edge_dst)
        xj = gather_src(x, edge_src)
        diff = xi - xj                 # (E, 3)
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = mlp_apply(layer["phi_e"], torch.cat([hi, hj, d2], dim=-1))  # (E, d)
        if cfg.update_coords:
            coef = torch.tanh(mlp_apply(layer["phi_x"], m))  # bounded for stability
            x = x + scatter_mean(diff * coef, edge_dst, n, mask)
        agg = scatter_sum(m, edge_dst, n, mask)
        h = h + mlp_apply(layer["phi_h"], torch.cat([h, agg], dim=-1))
    return mlp_apply(params["readout"], h)
