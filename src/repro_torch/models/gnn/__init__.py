"""GNN model zoo of the port: GCN, GraphSAGE, SchNet, EGNN on
``index_add`` message passing."""
from . import common, egnn, gcn, graphsage, schnet
from .egnn import EGNNConfig
from .gcn import GCNConfig
from .graphsage import SAGEConfig
from .schnet import SchNetConfig

__all__ = [
    "common",
    "gcn",
    "graphsage",
    "schnet",
    "egnn",
    "GCNConfig",
    "SAGEConfig",
    "SchNetConfig",
    "EGNNConfig",
]
