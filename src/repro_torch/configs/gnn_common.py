"""Shared pieces of the four GNN architectures × four graph shapes.

The counterpart of ``repro.configs.gnn_common`` without its dry run.
Shapes (assigned):

* ``full_graph_sm``  — Cora-size full-batch training (2 708 / 10 556 / 1433),
* ``minibatch_lg``   — Reddit-size sampled training (232 965 nodes,
  114.6M directed edges, 1 024 seed nodes, fanout 15-10) with the *real*
  fanout sampler from :mod:`repro_torch.graphs.sampling` running inside the step,
* ``ogb_products``   — 2.45M-node / 61.9M-edge full-batch,
* ``molecule``       — 128 × (30-node, 64-edge) batched small graphs,
  regression readout.

Non-SAGE archs have no native layered-block formulation, so the sampled
frontiers are linearized into an explicit block *graph* (child→parent
edges) and run through the arch's ordinary edge-list ``apply`` — one code
path serves all four archs on ``minibatch_lg``.  GraphSAGE uses its
faithful ``apply_blocks``.

The train steps of the reference's ``build_gnn_dryrun`` are here as
:func:`_full_step`, :func:`_minibatch_step` and :func:`_molecule_step`;
the dry run itself (``build_gnn_dryrun``) waits for ROADMAP A9.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.graphs.sampling import sample_blocks
from repro_torch.models.gnn.common import segment_sum
from repro_torch.models.recsys.embedding import as_u32, u32_mul
from repro_torch.optim import adamw, constant

from .base import _A9, optimizer_step

__all__ = ["GNN_SHAPES", "build_gnn_dryrun", "block_graph_from_frontiers"]

GNN_SHAPES = {
    "full_graph_sm": dict(
        kind="full", n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7
    ),
    "minibatch_lg": dict(
        kind="minibatch",
        n_nodes=232965,
        n_edges=114615892,
        batch_nodes=1024,
        fanout=(15, 10),
        d_feat=602,
        n_classes=41,
    ),
    "ogb_products": dict(
        kind="full", n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47
    ),
    "molecule": dict(kind="batched", n_nodes=30, n_edges=64, batch=128, d_feat=16),
}


def block_graph_from_frontiers(frontiers, fanouts):
    """Linearize sampled frontiers into one block graph.

    Returns (block_node_ids, edge_src, edge_dst): positions index into the
    concatenated frontier list; edges run child→parent and parent→child.
    """
    offsets = [0]
    for f in frontiers:
        offsets.append(offsets[-1] + f.shape[0])
    nodes = torch.cat(list(frontiers))
    dev = nodes.device
    srcs, dsts = [], []
    for lvl, fanout in enumerate(fanouts):
        n_parent = frontiers[lvl].shape[0]
        parent_pos = offsets[lvl] + torch.arange(n_parent, dtype=torch.int32, device=dev)
        child_pos = offsets[lvl + 1] + torch.arange(n_parent * fanout, dtype=torch.int32,
                                                    device=dev)
        parent_rep = parent_pos.repeat_interleave(fanout)
        srcs += [child_pos, parent_rep]
        dsts += [parent_rep, child_pos]
    return nodes, torch.cat(srcs), torch.cat(dsts)


def _synth_positions(node_ids: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-positions for geometric models on non-molecular
    graphs: a cheap integer hash → 3 floats in [−1, 1], the reference's
    uint32 arithmetic bit for bit."""
    x = as_u32(node_ids)
    out = []
    for c in (2654435761, 2246822519, 3266489917):
        h = u32_mul(x, c) ^ (x >> 13)
        out.append((h % 65536).to(torch.float32) / 32768.0 - 1.0)
    return torch.stack(out, dim=1)


def _ce_loss(logits, labels):
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = logp.gather(-1, labels.clamp_min(0).to(torch.int64)[:, None])[:, 0]
    valid = (labels >= 0).to(torch.float32)  # −1 = padded node
    return -torch.sum(ll * valid) / torch.clamp_min(torch.sum(valid), 1.0)


def _full_step(model_mod, make_cfg: Callable, shape_name: str):
    """The full-graph step ``step(params, opt_state, feat, pos, edge_src,
    edge_dst, labels)``: cross-entropy over the labelled nodes.  Returns
    ``(step, opt_init, cfg)``."""
    shape = GNN_SHAPES[shape_name]
    cfg = make_cfg(shape["d_feat"], shape["n_classes"])
    opt_init, opt_update = adamw(constant(1e-3), weight_decay=0.0)

    def loss(p, feat, pos, edge_src, edge_dst, labels):
        return _ce_loss(model_mod.apply(p, cfg, feat, pos, edge_src, edge_dst), labels)

    return optimizer_step(loss, opt_update), opt_init, cfg


def _minibatch_step(model_mod, make_cfg: Callable, shape_name: str):
    """The sampled step ``step(params, opt_state, generator, row_offsets, col,
    feat, seeds, labels)``: the fanout sampler runs inside the step.
    Returns ``(step, opt_init, cfg)``."""
    shape = GNN_SHAPES[shape_name]
    fanout = shape["fanout"]
    cfg = make_cfg(shape["d_feat"], shape["n_classes"])
    opt_init, opt_update = adamw(constant(1e-3), weight_decay=0.0)
    use_blocks = hasattr(model_mod, "apply_blocks")

    def loss(p, labels, *inputs):
        if use_blocks:
            out = model_mod.apply_blocks(p, cfg, inputs[0], fanout)
        else:
            out = model_mod.apply(p, cfg, *inputs)[: labels.shape[0]]
        return _ce_loss(out, labels)

    train = optimizer_step(loss, opt_update)

    def step(params, opt_state, generator, row_offsets, col, feat, seeds, labels):
        blocks = sample_blocks(generator, row_offsets, col, seeds, fanout)
        if use_blocks:
            inputs = ([feat.index_select(0, fr) for fr in blocks.frontiers],)
        else:
            nodes, esrc, edst = block_graph_from_frontiers(blocks.frontiers, fanout)
            inputs = (feat.index_select(0, nodes), _synth_positions(nodes), esrc, edst)
        return train(params, opt_state, labels, *inputs)

    return step, opt_init, cfg


def _molecule_step(model_mod, make_cfg: Callable, shape_name: str):
    """The batched small-graph step ``step(params, opt_state, node_feat,
    positions, edge_src, edge_dst, labels)``: graphs flattened into one
    edge list, a per-graph sum readout, squared error.  Returns
    ``(step, opt_init, cfg)``."""
    shape = GNN_SHAPES[shape_name]
    nb = shape["n_nodes"]
    cfg = make_cfg(shape["d_feat"], 1)
    opt_init, opt_update = adamw(constant(1e-3), weight_decay=0.0)

    def loss(p, node_feat, positions, edge_src, edge_dst, labels):
        bsz = node_feat.shape[0]
        dev = node_feat.device
        flat_feat = node_feat.reshape(bsz * nb, -1)
        flat_pos = positions.reshape(bsz * nb, 3)
        off = (torch.arange(bsz, dtype=torch.int32, device=dev) * nb)[:, None]
        fsrc = torch.where(edge_src >= 0, edge_src + off, -1).reshape(-1)
        fdst = torch.where(edge_dst >= 0, edge_dst + off, -1).reshape(-1)
        out = model_mod.apply(p, cfg, flat_feat, flat_pos, fsrc, fdst)  # (B*nb, 1)
        graph_ids = torch.arange(bsz, dtype=torch.int32, device=dev).repeat_interleave(nb)
        pred = segment_sum(out[:, 0], graph_ids, bsz)
        return torch.mean((pred - labels) ** 2)

    return optimizer_step(loss, opt_update), opt_init, cfg


def build_gnn_dryrun(*args, **kwargs):
    """The reference's dry-run cell builder; raises until ROADMAP A9."""
    raise NotImplementedError("build_gnn_dryrun " + _A9)
