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
    """The reference's dry-run cell; raises until ROADMAP A9."""
    return build_gnn_dryrun(ARCH_ID, shape, mesh, variant=variant)


MODEL = gcn
