"""Model zoo of the port: the LM transformer's serving half (dense archs)."""
from . import attention, transformer
from .transformer import TransformerConfig

__all__ = ["attention", "transformer", "TransformerConfig"]
