"""Model zoo of the port: the LM transformer (the five LM archs, MoE included)."""
from . import attention, transformer
from .transformer import TransformerConfig

__all__ = ["attention", "transformer", "TransformerConfig"]
