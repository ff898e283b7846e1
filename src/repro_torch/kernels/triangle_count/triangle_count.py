"""CUDA kernel family: sorted-set intersection of neighbor panels.

The Hopper counterpart of the reference's Pallas family
(``repro/kernels/triangle_count/triangle_count.py``).  One CUDA C++
kernel (``csrc/intersect.cu``), one warp per panel row, templated on the
element type and on which outputs it writes, serves all three members:

``intersect_count_cuda``
    the per-row match count (replaces ``intersect_count_pallas``);
``intersect_per_node_cuda``
    adds the arm attribution, one slot per u-neighbor (replaces
    ``intersect_per_node_pallas``);
``intersect_support_cuda``
    adds the closure attribution, one slot per v-neighbor (replaces
    ``intersect_support_pallas``).

``intersect_count_csr_cuda``, ``intersect_per_node_csr_cuda`` and
``intersect_support_csr_cuda`` (``csrc/intersect_csr.cu``, one kernel
templated on the mode) take the chunk's ``u, v`` and the CSR and read each
row's two lists straight from it: the panel gather is fused in, and the
per-node and support kernels add each hit into the chunk's per-vertex or
per-edge output with atomics, so the engine's ``pallas`` paths materialise
no panels and no attribution arrays.  Their ``tiles=(rows_per_block,
lanes)`` sets the kernel's rows (query edges) per block and lanes per row
(8, 16 or 32) at run time — the knob :mod:`repro_torch.core.tuning`
searches; ``None`` is :func:`csr_default_tiles` of the width.  A pick the
card cannot launch raises.  The result never depends on it.

The TPU kernel reduces an ``Lu × Lv`` equality cube per row to keep its
vector unit full.  The rows are sorted, so here each lane binary-searches
its ``a`` entries in ``b``'s valid prefix: ``Lu·log₂Lv`` compares per row,
and the kernel is bound by reading the two panels.

Each wrapper checks its inputs, allocates its outputs, launches on the
current stream and raises on a launch error; it counts its launches in
:data:`launches`, under a lock, so launches from several threads (the
service's lanes) are all counted.  Each also records its launch signature
(:func:`record_panel_launch`, :func:`record_csr_launch`) for
:class:`repro_torch.check.runtime.CompileAuditor`.  The wrappers take CUDA
tensors only — the CPU path is :mod:`.ops`, which sends CPU tensors to the
plain versions in :mod:`.ref` and records the same signatures.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.check.runtime import record_launch

__all__ = [
    "intersect_count_cuda",
    "intersect_per_node_cuda",
    "intersect_support_cuda",
    "intersect_count_csr_cuda",
    "intersect_per_node_csr_cuda",
    "intersect_support_csr_cuda",
    "launches",
    "reset_launches",
    "DEFAULT_WARPS_PER_BLOCK",
    "CSR_LANES",
    "CSR_MAX_THREADS",
    "CSR_SHARE",
    "CSR_MAX_SMEM",
    "csr_default_tiles",
    "csr_smem_bytes",
    "check_csr_tiles",
]

# one count per kernel, raised by one at each launch (never for B == 0),
# under _launches_lock
launches = {"intersect_count": 0, "intersect_per_node": 0, "intersect_support": 0,
            "intersect_count_csr": 0, "intersect_per_node_csr": 0, "intersect_support_csr": 0}
_launches_lock = threading.Lock()

# the CSR kernel's limits (csrc/intersect_csr.cu): lanes per row, threads
# per block, ints of shared memory per row and bytes of it per block
CSR_LANES = (8, 16, 32)
CSR_MAX_THREADS = 1024
CSR_SHARE = 1024
CSR_MAX_SMEM = 232448

DEFAULT_WARPS_PER_BLOCK = 8
_MODES = {"intersect_count": 0, "intersect_per_node": 1, "intersect_support": 2}
_CSR_MODES = {"intersect_count_csr": 0, "intersect_per_node_csr": 1, "intersect_support_csr": 2}
_ELEM_BYTES = {torch.int32: 4, torch.int16: 2}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    with _launches_lock:
        for k in launches:
            launches[k] = 0


def _count_launch(kind: str) -> None:
    with _launches_lock:
        launches[kind] += 1


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_cuda:
            raise ValueError(f"{name} lies on {t.device}; the CUDA kernels take CUDA tensors")
        if t.dim() != 2:
            raise ValueError(f"{name} must be rank 2 (B, L), got shape {tuple(t.shape)}")
        if t.dtype not in _ELEM_BYTES:
            raise TypeError(f"{name} has dtype {t.dtype}; expected int32 or int16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype != b.dtype:
        raise TypeError(f"a and b differ in dtype ({a.dtype} vs {b.dtype})")
    if a.device != b.device:
        raise ValueError(f"a and b lie on different devices ({a.device} vs {b.device})")
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"a and b differ in rows ({a.shape[0]} vs {b.shape[0]})")


def _warps(tiles) -> int:
    """Rows (warps) per block: ``tiles[0]`` clamped to 1..32, else the default."""
    if tiles is None:
        return DEFAULT_WARPS_PER_BLOCK
    return max(1, min(int(tiles[0]), 32))


def record_panel_launch(kind: str, a, b, tiles) -> None:
    """A panel kernel's launch signature: the two panels and ``tiles``."""
    record_launch(kind, (a, b), tiles=tiles)


def record_csr_launch(kind: str, row_offsets, col, u, v, edge_idx, width, n_out, tiles) -> None:
    """A CSR kernel's launch signature: its tensors, ``width``, the output
    length and ``tiles``."""
    record_launch(kind, (row_offsets, col, u, v, edge_idx), width=int(width),
                  n_out=int(n_out), tiles=tiles)


def _launch(kind: str, a, b, count, arm, closure, tiles) -> None:
    from ._build import load_library

    record_panel_launch(kind, a, b, tiles)
    n, lu = a.shape
    lv = b.shape[1]
    if n == 0:
        return
    lib = load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.tc_intersect_launch(
            _ELEM_BYTES[a.dtype], _MODES[kind], a.data_ptr(), b.data_ptr(),
            n, lu, lv,
            count.data_ptr(),
            arm.data_ptr() if arm is not None else None,
            closure.data_ptr() if closure is not None else None,
            _warps(tiles), stream,
        )
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: cudaError_t {err}")
    _count_launch(kind)


def intersect_count_cuda(a: torch.Tensor, b: torch.Tensor, tiles=None) -> torch.Tensor:
    """(B,) int32 match counts between −1-padded sorted rows of a and b."""
    _check(a, b)
    count = torch.empty((a.shape[0],), dtype=torch.int32, device=a.device)
    _launch("intersect_count", a, b, count, None, None, tiles)
    return count


def intersect_per_node_cuda(a: torch.Tensor, b: torch.Tensor, tiles=None):
    """``(count (B,), arm (B, Lu))``; ``arm`` is 0 on padding."""
    _check(a, b)
    count = torch.empty((a.shape[0],), dtype=torch.int32, device=a.device)
    arm = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    _launch("intersect_per_node", a, b, count, arm, None, tiles)
    return count, arm


def intersect_support_cuda(a: torch.Tensor, b: torch.Tensor, tiles=None):
    """``(count (B,), arm (B, Lu), closure (B, Lv))`` — the support outputs."""
    _check(a, b)
    count = torch.empty((a.shape[0],), dtype=torch.int32, device=a.device)
    arm = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    closure = torch.empty(b.shape, dtype=torch.int32, device=a.device)
    _launch("intersect_support", a, b, count, arm, closure, tiles)
    return count, arm, closure


def _check_csr(row_offsets, col, u, v, width, edge_idx=None) -> None:
    named = [("row_offsets", row_offsets), ("col", col), ("u", u), ("v", v)]
    if edge_idx is not None:
        named.append(("edge_idx", edge_idx))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_cuda:
            raise ValueError(f"{name} lies on {t.device}; the CUDA kernels take CUDA tensors")
        if t.dim() != 1:
            raise ValueError(f"{name} must be rank 1, got shape {tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {t.dtype}; expected int32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != u.device:
            raise ValueError(f"{name} lies on {t.device}, u on {u.device}")
    if u.shape != v.shape:
        raise ValueError(f"u and v differ in shape ({tuple(u.shape)} vs {tuple(v.shape)})")
    if edge_idx is not None and edge_idx.shape != u.shape:
        raise ValueError(f"edge_idx and u differ in shape "
                         f"({tuple(edge_idx.shape)} vs {tuple(u.shape)})")
    if row_offsets.shape[0] < 1:
        raise ValueError("row_offsets must hold n + 1 >= 1 entries")
    if int(width) < 1:
        raise ValueError(f"width={width}: must be >= 1")


def _check_n_out(n_out) -> int:
    if int(n_out) < 1:
        raise ValueError(f"n_out={n_out}: must be >= 1")
    return int(n_out)


def csr_default_tiles(width: int) -> tuple[int, int]:
    """The CSR kernel's pick when no tiles are given: lanes per row by the
    bucket width (8 to 16, 16 to 64, 32 above) and a 256-thread block."""
    lanes = 8 if width <= 16 else (16 if width <= 64 else 32)
    return 256 // lanes, lanes


def csr_smem_bytes(rows_per_block: int, width: int) -> int:
    """Shared memory one block of the CSR kernel takes: the longer list of
    each row, up to ``CSR_SHARE`` ints."""
    return 4 * int(rows_per_block) * min(int(width), CSR_SHARE)


def check_csr_tiles(tiles, width: int) -> tuple[int, int]:
    """``(rows_per_block, lanes)`` as ints; raises ``ValueError`` for a pick
    the kernel cannot launch at ``width``: lanes outside ``CSR_LANES``, a
    block that is not whole warps or exceeds ``CSR_MAX_THREADS``, or more
    shared memory than ``CSR_MAX_SMEM``."""
    rows, lanes = (int(t) for t in tiles)
    threads = rows * lanes
    if lanes not in CSR_LANES:
        raise ValueError(f"tiles={tuple(tiles)}: lanes per row must be one of {CSR_LANES}")
    if rows < 1 or threads % 32 or threads > CSR_MAX_THREADS:
        raise ValueError(f"tiles={tuple(tiles)}: rows x lanes = {threads} threads; a block "
                         f"takes whole warps, at most {CSR_MAX_THREADS} threads")
    if csr_smem_bytes(rows, width) > CSR_MAX_SMEM:
        raise ValueError(f"tiles={tuple(tiles)} at width {width}: "
                         f"{csr_smem_bytes(rows, width)} bytes of shared memory; at most "
                         f"{CSR_MAX_SMEM} fit")
    return rows, lanes


def _launch_csr(kind: str, row_offsets, col, u, v, edge_idx, width, out, n_out, tiles) -> None:
    rows, lanes = (0, 0) if tiles is None else check_csr_tiles(tiles, width)
    record_csr_launch(kind, row_offsets, col, u, v, edge_idx, width, n_out, tiles)
    n = u.shape[0]
    if n == 0:
        return
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.tc_intersect_csr_launch(
            _CSR_MODES[kind], row_offsets.data_ptr(), col.data_ptr(), u.data_ptr(),
            v.data_ptr(), edge_idx.data_ptr() if edge_idx is not None else None,
            n, int(width), rows, lanes, out.data_ptr(), int(n_out), stream)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: cudaError_t {err}")
    _count_launch(kind)


def intersect_count_csr_cuda(row_offsets: torch.Tensor, col: torch.Tensor, u: torch.Tensor,
                             v: torch.Tensor, width: int, tiles=None) -> torch.Tensor:
    """(B,) int32 sizes of N⁺(u[i]) ∩ N⁺(v[i]), each list cut to ``width``
    entries; 0 where u or v is −1.  The lists are read from the CSR."""
    _check_csr(row_offsets, col, u, v, width)
    count = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    _launch_csr("intersect_count_csr", row_offsets, col, u, v, None, width, count, u.shape[0],
                tiles)
    return count


def intersect_per_node_csr_cuda(row_offsets: torch.Tensor, col: torch.Tensor, u: torch.Tensor,
                                v: torch.Tensor, width: int, n_out: int,
                                tiles=None) -> torch.Tensor:
    """(n_out,) int32 triangle incidences of the chunk's rows: each common
    entry x of the two lists (cut to ``width``) adds 1 to x, and each row's
    count adds to u and to v.  Indices are clipped to [0, n_out)."""
    _check_csr(row_offsets, col, u, v, width)
    out = torch.zeros((_check_n_out(n_out),), dtype=torch.int32, device=u.device)
    _launch_csr("intersect_per_node_csr", row_offsets, col, u, v, None, width, out, n_out, tiles)
    return out


def intersect_support_csr_cuda(row_offsets: torch.Tensor, col: torch.Tensor, u: torch.Tensor,
                               v: torch.Tensor, edge_idx: torch.Tensor, width: int,
                               m_out: int, tiles=None) -> torch.Tensor:
    """(m_out,) int32 per-directed-edge support of the chunk's rows: each
    common entry adds 1 to the two CSR edges that hold it (slot j of u's
    list, slot k of v's), and each row's count adds to ``edge_idx``.
    Indices are clipped to [0, m_out); ``edge_idx`` −1 adds nothing."""
    _check_csr(row_offsets, col, u, v, width, edge_idx)
    out = torch.zeros((_check_n_out(m_out),), dtype=torch.int32, device=u.device)
    _launch_csr("intersect_support_csr", row_offsets, col, u, v, edge_idx, width, out, m_out,
                tiles)
    return out
