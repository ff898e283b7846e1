"""SchNet (Schütt et al., arXiv:1706.08566): continuous-filter convolutions.

The counterpart of ``repro.models.gnn.schnet``.  Messages are
``h_j ⊙ W(r_ij)`` where the filter ``W`` is an MLP over a radial-basis
expansion of the interatomic distance.  Non-molecular shapes synthesize
positions; the geometry path is identical.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device

from .common import (
    edge_mask,
    gather_src,
    init_from_layout,
    mlp_apply,
    mlp_layout,
    params_from_layout,
    params_to_numpy,
    scatter_sum,
    seeded_generator,
)

__all__ = ["SchNetConfig", "init_params", "apply", "params_from_numpy", "params_to_numpy"]

_LOG2 = math.log(2.0)


def _ssp(x):  # shifted softplus, SchNet's activation
    return F.softplus(x) - _LOG2


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_in: int = 16
    d_out: int = 1
    dtype: object = torch.float32


def _layout(cfg: SchNetConfig) -> dict:
    d = cfg.d_hidden
    return {
        "embed": ("normal", (cfg.d_in, d), cfg.d_in ** -0.5),
        "interactions": [{"filter": mlp_layout([cfg.n_rbf, d, d]),
                          "in_proj": mlp_layout([d, d]),
                          "out_mlp": mlp_layout([d, d, d])}
                         for _ in range(cfg.n_interactions)],
        "readout": mlp_layout([d, d // 2, cfg.d_out]),
    }


def init_params(cfg: SchNetConfig, seed: int = 0, device=None) -> dict:
    return init_from_layout(_layout(cfg), seeded_generator(seed, device))


def params_from_numpy(tree: dict, cfg: SchNetConfig, device=None) -> dict:
    """The reference's parameter tree (numpy leaves) on ``device``."""
    return params_from_layout(tree, _layout(cfg), resolve_device(device))


def _rbf_centres(cfg: SchNetConfig, device) -> torch.Tensor:
    """``jnp.linspace(0, cutoff, n_rbf)`` bit for bit: ``arange · step`` in
    f32 with the last centre set to ``cutoff`` (``torch.linspace`` rounds
    otherwise)."""
    n = cfg.n_rbf
    step = np.float32(cfg.cutoff / (n - 1))
    mu = torch.arange(n, dtype=torch.float32, device=device) * float(step)
    mu[-1] = cfg.cutoff
    return mu


def apply(
    params: dict,
    cfg: SchNetConfig,
    node_feat: torch.Tensor,     # (N, d_in)
    positions: torch.Tensor,     # (N, 3)
    edge_src: torch.Tensor = None,
    edge_dst: torch.Tensor = None,
) -> torch.Tensor:
    n = node_feat.shape[0]
    mask = edge_mask(edge_src, edge_dst)
    x = (node_feat @ params["embed"]).to(cfg.dtype)
    ri = gather_src(positions, edge_src)
    rj = gather_src(positions, edge_dst)
    dist = torch.sqrt(torch.sum((ri - rj) ** 2, dim=-1) + 1e-12)  # (E,)
    mu = _rbf_centres(cfg, dist.device)
    gamma = 10.0 / cfg.cutoff
    rbf = torch.exp(-gamma * (dist[:, None] - mu[None, :]) ** 2).to(cfg.dtype)
    # cosine cutoff envelope
    fc = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1)) + 1.0)
    for inter in params["interactions"]:
        w = mlp_apply(inter["filter"], rbf, act=_ssp) * fc[:, None].to(cfg.dtype)
        h = mlp_apply(inter["in_proj"], x)
        msg = gather_src(h, edge_src) * w
        agg = scatter_sum(msg, edge_dst, n, mask)
        x = x + mlp_apply(inter["out_mlp"], agg, act=_ssp)
    return mlp_apply(params["readout"], x, act=_ssp)
