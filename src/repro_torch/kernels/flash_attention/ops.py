"""Attention entry point with backend dispatch.

``attention(..., backend="auto")`` sends CUDA tensors to the hand-written
CUDA kernel (:func:`.flash_attention.flash_attention_cuda`) and CPU
tensors to the plain blockwise version
(:func:`repro_torch.models.attention.flash_attention_torch`).  Nothing
falls back: ``"cuda"`` on CPU tensors raises, and so does a failed launch.

Under autograd (a CUDA input that needs a gradient, as in training) the
kernel runs inside :class:`KernelAttention`: its forward is the kernel,
its backward recomputes the plain version under autograd and takes dq, dk,
dv from it.  The reference differentiates its XLA blockwise attention and
has no backward kernel, so none is written here.  CPU tensors are
differentiated through the plain version directly.
"""
from __future__ import annotations

import torch

from repro_torch.obs.cost import region

from .flash_attention import flash_attention_cuda

__all__ = ["attention", "KernelAttention"]


class KernelAttention(torch.autograd.Function):
    """``forward_fn(q, k, v, causal=, sm_scale=)`` forward, plain backward.

    ``forward_fn`` is the CUDA kernel on the training path; the tests put
    the plain version in its place on the CPU.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, forward_fn):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return forward_fn(q, k, v, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, grad_out):
        from repro_torch.models.attention import flash_attention_torch

        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_torch(*inputs, causal=ctx.causal, sm_scale=ctx.sm_scale)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad_out)
        return dq, dk, dv, None, None, None


@region("attention")
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              sm_scale: float | None = None, backend: str = "auto"):
    if backend == "auto":
        backend = "cuda" if q.is_cuda else "torch"
    if backend == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return KernelAttention.apply(q, k, v, causal, sm_scale, flash_attention_cuda)
        return flash_attention_cuda(q, k, v, causal=causal, sm_scale=sm_scale)
    if backend == "torch":
        if q.is_cuda or k.is_cuda or v.is_cuda:
            raise ValueError("backend='torch' is the CPU path; CUDA tensors go to the kernel")
        from repro_torch.models.attention import flash_attention_torch

        return flash_attention_torch(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"unknown backend {backend!r}; expected 'auto', 'cuda' or 'torch'")
