"""CUDA flash attention (forward, GQA): the wrapper of ``csrc/flash_attention.cu``.

The Hopper counterpart of the JAX package's Pallas kernel
``flash_attention_pallas``: one block per (batch·head, q tile), the kv
sweep a loop inside the block, the softmax state in f32.  bf16 runs a
warp-specialised kernel (a TMA producer warp feeding a ring of K/V
tiles to one or two ``wgmma`` consumer warpgroups); f32 runs scalar FMAs.

:func:`flash_attention_cuda` checks its inputs, allocates the output,
launches on the current stream, raises on a nonzero ``cudaError_t``,
counts its launches in :data:`launches` and records its launch signature
(q, k, v shapes and dtype, ``causal``, the scale and the block pair) for
:class:`repro_torch.check.runtime.CompileAuditor`.  It takes CUDA tensors
only; the CPU path is :mod:`.ops`, which sends CPU tensors to the plain
version (:func:`repro_torch.models.attention.flash_attention_torch`).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.check.runtime import record_launch

__all__ = [
    "flash_attention_cuda",
    "launches",
    "reset_launches",
    "DEFAULT_BLOCKS",
    "HEAD_DIMS",
]

# raised by one at each launch of the kernel, under _launches_lock (callers
# on several threads launch concurrently)
launches = {"flash_attention": 0}
_launches_lock = threading.Lock()

# (block_q, block_k) when the caller gives none.  bf16: block_q is 64 query
# rows per consumer warpgroup (64 or 128), block_k the keys of one K/V tile
# (64 or 128).  f32: block_q a multiple of 16 in [16, 128], block_k a
# positive multiple of 64.
DEFAULT_BLOCKS = {torch.bfloat16: (128, 128), torch.float32: (64, 64)}
BF16_BLOCK_Q = (64, 128)
BF16_BLOCK_K = (64, 128)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448     # bytes of shared memory one block may use on Hopper
_MAX_GRID_Y = 65535


def reset_launches() -> None:
    """Set the kernel's launch count to 0."""
    with _launches_lock:
        for k in launches:
            launches[k] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_cuda:
            raise ValueError(f"{name} lies on {t.device}; the CUDA kernel takes CUDA tensors")
        if t.dim() != 4:
            raise ValueError(f"{name} must be rank 4 (B, H, S, D), got shape {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; expected float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v differ in dtype ({q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on different devices ({q.device}, {k.device}, {v.device})")
    b, hq, _, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k and v differ in shape ({tuple(k.shape)} vs {tuple(v.shape)})")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not supported; expected one of {HEAD_DIMS}")
    hkv = k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of kv heads {hkv}")
    if b * hq > _MAX_GRID_Y:
        raise ValueError(f"B·Hq = {b * hq} exceeds the grid limit {_MAX_GRID_Y}")


def _blocks(block_q: int | None, block_k: int | None, sq: int, skv: int,
            dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """Checked block sizes for ``dtype`` (``None`` takes its default), cut to
    the sequence lengths (the results do not depend on them beyond f32
    rounding)."""
    dq, dk = DEFAULT_BLOCKS[dtype]
    block_q = dq if block_q is None else block_q
    block_k = dk if block_k is None else block_k
    if dtype == torch.bfloat16:
        if block_q not in BF16_BLOCK_Q:
            raise ValueError(f"block_q={block_q}: the bf16 kernel takes {BF16_BLOCK_Q}")
        if block_k not in BF16_BLOCK_K:
            raise ValueError(f"block_k={block_k}: the bf16 kernel takes {BF16_BLOCK_K}")
        return (64 if sq <= 64 else block_q), (64 if skv <= 64 else block_k)
    if block_q % 16 or not 16 <= block_q <= 128:
        raise ValueError(f"block_q={block_q}: must be a multiple of 16 in [16, 128]")
    if block_k % 64 or block_k < 64:
        raise ValueError(f"block_k={block_k}: must be a positive multiple of 64")
    return min(block_q, -(-sq // 16) * 16), min(block_k, max(64, -(-skv // 64) * 64))


def flash_attention_cuda(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: float | None = None,
    block_q: int | None = None,
    block_k: int | None = None,
) -> torch.Tensor:
    """Softmax attention on the card; output (B, Hq, Sq, D) in q's dtype.

    The causal mask is bottom-right aligned (query i sees key j when
    ``i + Skv - Sq >= j``); a query row with no valid key outputs 0.
    ``block_q``/``block_k`` default to :data:`DEFAULT_BLOCKS` of q's dtype.
    """
    from ._build import load_library

    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    bq, bk = _blocks(block_q, block_k, sq, skv, q.dtype)
    record_launch("flash_attention", (q, k, v), causal=bool(causal), sm_scale=float(sm_scale),
                  block_q=bq, block_k=bk)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load_library()
    dtype = _DTYPES[q.dtype]
    smem = lib.fa_smem_bytes(dtype, d, bq, bk)
    if smem > _MAX_SMEM:
        raise ValueError(f"block_q={bq}, block_k={bk} need {smem} bytes of shared memory "
                         f"at D={d} {q.dtype}; at most {_MAX_SMEM} fit")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_forward_launch(
            dtype, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, bq, bk, float(sm_scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError_t {err}")
    with _launches_lock:
        launches["flash_attention"] += 1
    return out
