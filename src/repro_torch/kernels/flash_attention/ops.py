"""Attention entry point with backend dispatch.

``attention(..., backend="auto")`` sends CUDA tensors to the hand-written
CUDA kernel (:func:`.flash_attention.flash_attention_cuda`) and CPU
tensors to the plain blockwise version
(:func:`repro_torch.models.attention.flash_attention_torch`).  Nothing
falls back: ``"cuda"`` on CPU tensors raises, and so does a failed launch.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_cuda

__all__ = ["attention"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              sm_scale: float | None = None, backend: str = "auto"):
    if backend == "auto":
        backend = "cuda" if q.is_cuda else "torch"
    if backend == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale)
    if backend == "torch":
        if q.is_cuda or k.is_cuda or v.is_cuda:
            raise ValueError("backend='torch' is the CPU path; CUDA tensors go to the kernel")
        from repro_torch.models.attention import flash_attention_torch

        return flash_attention_torch(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"unknown backend {backend!r}; expected 'auto', 'cuda' or 'torch'")
