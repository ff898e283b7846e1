"""Model zoo of the port: the LM transformer (the five LM archs, MoE
included), the four GNNs and DIN."""
from . import attention, gnn, recsys, transformer
from .transformer import TransformerConfig

__all__ = ["attention", "transformer", "gnn", "recsys", "TransformerConfig"]
