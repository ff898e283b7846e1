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
    """The reference's dry-run cell; raises until ROADMAP A9."""
    return build_gnn_dryrun(ARCH_ID, shape, mesh, variant=variant)


MODEL = egnn
