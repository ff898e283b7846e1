"""schnet [arXiv:1706.08566]: 3 interactions, d=64, 300 RBF, cutoff 10."""
from repro_torch.models.gnn import schnet

from .gnn_common import GNN_SHAPES, build_gnn_dryrun

ARCH_ID = "schnet"
FAMILY = "gnn"
SHAPES = tuple(GNN_SHAPES)


def make_cfg(d_in: int, d_out: int) -> schnet.SchNetConfig:
    return schnet.SchNetConfig(
        name=ARCH_ID, n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0,
        d_in=d_in, d_out=d_out,
    )


def smoke_config() -> schnet.SchNetConfig:
    return schnet.SchNetConfig(
        name=ARCH_ID, n_interactions=2, d_hidden=16, n_rbf=24, d_in=12, d_out=3
    )


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    # filter MLP dominates: ≈ 2·(300·64 + 64·64) FLOPs per edge per interaction
    return build_gnn_dryrun(
        ARCH_ID, schnet, make_cfg, shape, mesh, variant=variant,
        flops_per_edge=3 * 2.0 * (300 * 64 + 64 * 64),
        flops_per_node=3 * 4.0 * 64 * 64,
    )


MODEL = schnet
