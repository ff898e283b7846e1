"""GraphSAGE (Hamilton et al., arXiv:1706.02216), mean aggregator.

The counterpart of ``repro.models.gnn.graphsage``.  Two entry points:

* :func:`apply` — full-graph layout (edge-index message passing),
* :func:`apply_blocks` — layered minibatch layout fed by the fanout
  sampler in :mod:`repro_torch.graphs.sampling` (the ``minibatch_lg`` shape).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import resolve_device

from .common import (
    edge_mask,
    gather_src,
    init_from_layout,
    params_from_layout,
    params_to_numpy,
    scatter_mean,
    seeded_generator,
)

__all__ = ["SAGEConfig", "init_params", "apply", "apply_blocks", "params_from_numpy",
           "params_to_numpy"]


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    d_out: int = 41
    sample_sizes: tuple[int, ...] = (25, 10)
    dtype: object = torch.float32


def _layout(cfg: SAGEConfig) -> dict:
    sizes = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
    return {"layers": [{"w_self": ("normal", (a, b), a ** -0.5),
                        "w_neigh": ("normal", (a, b), a ** -0.5),
                        "b": ("zeros", (b,))} for a, b in zip(sizes[:-1], sizes[1:])]}


def init_params(cfg: SAGEConfig, seed: int = 0, device=None) -> dict:
    return init_from_layout(_layout(cfg), seeded_generator(seed, device))


def params_from_numpy(tree: dict, cfg: SAGEConfig, device=None) -> dict:
    """The reference's parameter tree (numpy leaves) on ``device``."""
    return params_from_layout(tree, _layout(cfg), resolve_device(device))


def _combine(layer, h_self, h_neigh, final: bool):
    out = (
        h_self @ layer["w_self"].to(h_self.dtype)
        + h_neigh @ layer["w_neigh"].to(h_self.dtype)
        + layer["b"].to(h_self.dtype)
    )
    return out if final else torch.relu(out)


def apply(
    params: dict,
    cfg: SAGEConfig,
    node_feat: torch.Tensor,
    positions=None,
    edge_src: torch.Tensor = None,
    edge_dst: torch.Tensor = None,
) -> torch.Tensor:
    n = node_feat.shape[0]
    mask = edge_mask(edge_src, edge_dst)
    x = node_feat.to(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        h_neigh = scatter_mean(gather_src(x, edge_src), edge_dst, n, mask)
        x = _combine(layer, x, h_neigh, i == len(params["layers"]) - 1)
    return x


def apply_blocks(params: dict, cfg: SAGEConfig, frontier_feats: list, fanouts) -> torch.Tensor:
    """Layered minibatch forward.

    ``frontier_feats[l]`` holds features of sampler frontier ``l``
    (seeds first); len == n_layers + 1.  Aggregation runs deepest-first.
    """
    n_layers = len(params["layers"])
    # h[l] starts as raw features of frontier l; each GNN layer collapses
    # the deepest remaining frontier into its parent.
    h = [f.to(cfg.dtype) for f in frontier_feats]
    for li, layer in enumerate(params["layers"]):
        new_h = []
        for depth in range(len(h) - 1):
            parent = h[depth]
            child = h[depth + 1].reshape(parent.shape[0], fanouts[depth], -1)
            new_h.append(_combine(layer, parent, child.mean(dim=1), li == n_layers - 1))
        h = new_h
    return h[0]
