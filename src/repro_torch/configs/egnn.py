"""egnn [arXiv:2102.09844]: 4 layers, d=64, E(n)-equivariant."""
from repro_torch.models.gnn import egnn

from .gnn_common import GNN_SHAPES, build_gnn_dryrun

ARCH_ID = "egnn"
FAMILY = "gnn"
SHAPES = tuple(GNN_SHAPES)


def make_cfg(d_in: int, d_out: int) -> egnn.EGNNConfig:
    return egnn.EGNNConfig(name=ARCH_ID, n_layers=4, d_hidden=64, d_in=d_in, d_out=d_out)


def smoke_config() -> egnn.EGNNConfig:
    return egnn.EGNNConfig(name=ARCH_ID, n_layers=2, d_hidden=16, d_in=12, d_out=3)


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    # φ_e + φ_x per edge: ≈ 2·(129·64 + 64·64 + 64·64 + 64) FLOPs × 4 layers
    return build_gnn_dryrun(
        ARCH_ID, egnn, make_cfg, shape, mesh, variant=variant,
        flops_per_edge=4 * 2.0 * (129 * 64 + 2 * 64 * 64),
        flops_per_node=4 * 2.0 * (128 * 64 + 64 * 64),
    )


MODEL = egnn
