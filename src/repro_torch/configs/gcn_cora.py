"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden=16, mean/sym aggregation."""
from repro_torch.models.gnn import gcn

from .gnn_common import GNN_SHAPES, build_gnn_dryrun

ARCH_ID = "gcn-cora"
FAMILY = "gnn"
SHAPES = tuple(GNN_SHAPES)


def make_cfg(d_in: int, d_out: int) -> gcn.GCNConfig:
    return gcn.GCNConfig(name=ARCH_ID, n_layers=2, d_hidden=16, d_in=d_in, d_out=d_out)


def smoke_config() -> gcn.GCNConfig:
    return gcn.GCNConfig(name=ARCH_ID, n_layers=2, d_hidden=8, d_in=12, d_out=3)


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    # per-layer ≈ 2·d_in·d_out FLOPs/node (matmul) + 2·d_out FLOPs/edge (agg)
    return build_gnn_dryrun(
        ARCH_ID, gcn, make_cfg, shape, mesh, variant=variant,
        flops_per_edge=2.0 * 16,
        flops_per_node=2.0 * GNN_SHAPES.get(shape, {}).get("d_feat", 64) * 16,
    )


MODEL = gcn
