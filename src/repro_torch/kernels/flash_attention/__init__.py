"""CUDA flash-attention kernel (LM prefill hot spot).

Importing this package needs neither ``nvcc`` nor a card: the kernel
library is built and loaded inside the first launch.
"""
from . import ops, ref
from .flash_attention import flash_attention_cuda, launches, reset_launches

__all__ = ["ops", "ref", "flash_attention_cuda", "launches", "reset_launches"]
