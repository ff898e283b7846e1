"""RecSys stack of the port: DIN + EmbeddingBag built on index_select/index_add."""
from . import din, embedding
from .din import DINConfig
from .embedding import embedding_bag, embedding_lookup, hash_bucket

__all__ = [
    "din",
    "embedding",
    "DINConfig",
    "embedding_bag",
    "embedding_lookup",
    "hash_bucket",
]
