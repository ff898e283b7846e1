"""graphsage-reddit [arXiv:1706.02216]: 2 layers, d=128, mean agg, samples 25-10."""
from repro_torch.models.gnn import graphsage

from .gnn_common import GNN_SHAPES, build_gnn_dryrun

ARCH_ID = "graphsage-reddit"
FAMILY = "gnn"
SHAPES = tuple(GNN_SHAPES)


def make_cfg(d_in: int, d_out: int) -> graphsage.SAGEConfig:
    return graphsage.SAGEConfig(
        name=ARCH_ID, n_layers=2, d_hidden=128, d_in=d_in, d_out=d_out,
        sample_sizes=(25, 10),
    )


def smoke_config() -> graphsage.SAGEConfig:
    return graphsage.SAGEConfig(name=ARCH_ID, n_layers=2, d_hidden=16, d_in=12, d_out=3)


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    return build_gnn_dryrun(
        ARCH_ID, graphsage, make_cfg, shape, mesh, variant=variant,
        flops_per_edge=2.0 * 128,
        flops_per_node=4.0 * GNN_SHAPES.get(shape, {}).get("d_feat", 64) * 128,
    )


MODEL = graphsage
