"""The ``.tricsr`` binary CSR cache format.

A graph is parsed and canonicalized once; every later run memory-maps the
cached CSR and is counting within milliseconds.  Layout (little-endian)::

    offset  size  field
    0       8     magic  b"TRICSR\\x01\\n"   (version byte inside the magic)
    8       8     n_nodes               (u64)
    16      8     n_rows = len(col)     (u64; 2 × undirected edge count)
    24      1     row_offsets dtype code (np.dtype(...).num, u8)
    25      1     col dtype code         (u8)
    26      6     reserved (zeros)
    32      8     crc32 of the two payloads (u64, low 32 bits used)
    40      24    reserved (zeros)  — header is a fixed 64 bytes
    64      …     row_offsets payload ((n_nodes+1) × itemsize)
    …       …     col payload          (n_rows × itemsize)

The stored CSR is the **undirected canonical** adjacency (every edge in
both directions, rows sorted): exactly ``edge_array_to_csr`` of the
canonical edge array, so tests can compare bit-for-bit.  Loads default to
``mmap_mode="r"`` and skip the checksum (header + size validation only);
pass ``verify=True`` to pay one full read for the crc — ingest does this
once, right after writing.

Sharded views (``.tricsr.stripe{k}of{N}``)
==========================================

For the §III-E distributed engine each host only needs to *ingest* its
own slab: :func:`save_tricsr_stripes` splits the cache into ``N``
contiguous node-range slabs balanced by neighbor count, each a
self-describing 64-byte-header file (magic ``b"TRISLB\\x01\\n"``) whose
payload is the **absolute** ``row_offsets[lo : hi+1]`` slice plus the
matching ``col`` slice, with a per-slab crc32.  A device memory-maps
only its slab (:func:`load_tricsr_stripe`);
:func:`repro_torch.core.distributed.oriented_csr_from_slabs` orients the slab
set without ever materializing the full ``col`` on one host, and
:func:`assemble_stripes` proves losslessness — the reassembled CSR is
bit-identical to the unsharded cache.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple

import numpy as np

__all__ = [
    "TRICSR_MAGIC",
    "TRICSR_VERSION",
    "TRISLB_MAGIC",
    "CacheError",
    "CSRGraph",
    "CSRStripe",
    "save_tricsr",
    "load_tricsr",
    "plan_csr_stripes",
    "stripe_path",
    "save_tricsr_stripes",
    "load_tricsr_stripe",
    "load_tricsr_stripes",
    "assemble_stripes",
]

TRICSR_VERSION = 1
TRICSR_MAGIC = b"TRICSR" + bytes([TRICSR_VERSION]) + b"\n"
_HEADER = struct.Struct("<8sQQBB6xQ24x")
assert _HEADER.size == 64

TRISLB_MAGIC = b"TRISLB" + bytes([TRICSR_VERSION]) + b"\n"
# magic, n_nodes, node_lo, node_hi (exclusive), col_len, stripe_index,
# n_stripes, row dtype code, col dtype code, pad, crc — 64 bytes like the
# unsharded header
_SLAB_HEADER = struct.Struct("<8sQQQQIIBB6xQ")
assert _SLAB_HEADER.size == 64


class CacheError(ValueError):
    """A ``.tricsr`` file is missing, truncated, corrupt, or wrong-version."""


_DTYPE_BY_CODE = {
    np.dtype(t).num: np.dtype(t)
    for t in (np.int32, np.int64, np.uint32, np.uint64)
}


class CSRGraph(NamedTuple):
    """Undirected canonical CSR as loaded from (or destined for) the cache.

    ``row_offsets[u] : row_offsets[u+1]`` indexes ``col`` — the sorted
    neighbors of ``u`` with every undirected edge present in both rows,
    i.e. ``edge_array_to_csr(canonicalize_edges(raw))``.  Arrays may be
    read-only memory maps.
    """

    row_offsets: np.ndarray  # (n_nodes+1,) int64
    col: np.ndarray          # (2m,) int32
    n_nodes: int

    @property
    def n_edges(self) -> int:
        """Undirected edge count."""
        return int(self.col.shape[0]) // 2

    def degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets).astype(np.int64)

    def edge_array(self) -> np.ndarray:
        """Materialize the canonical edge array in CSR (src-major) order."""
        from ..formats import csr_to_edge_array

        return csr_to_edge_array(np.asarray(self.row_offsets), np.asarray(self.col))

    def stats(self) -> dict:
        """Degree statistics without materializing the edge array
        (same dict as :func:`repro_torch.graphs.graph_stats`)."""
        from ..formats import stats_from_degrees

        return stats_from_degrees(self.degrees(), self.n_nodes)


def save_tricsr(path: str | os.PathLike, csr: CSRGraph) -> None:
    """Atomically write ``csr`` to ``path`` (tmp file + rename)."""
    row = np.ascontiguousarray(csr.row_offsets, dtype=np.int64)
    col = np.ascontiguousarray(csr.col, dtype=np.int32)
    if row.shape[0] != csr.n_nodes + 1:
        raise ValueError(
            f"row_offsets has {row.shape[0]} entries for n_nodes={csr.n_nodes}"
        )
    crc = zlib.crc32(col.tobytes(), zlib.crc32(row.tobytes()))
    header = _HEADER.pack(
        TRICSR_MAGIC, csr.n_nodes, col.shape[0],
        row.dtype.num, col.dtype.num, crc,
    )
    tmp = os.fspath(path) + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(header)
        fh.write(row.tobytes())
        fh.write(col.tobytes())
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_tricsr(
    path: str | os.PathLike, *, mmap: bool = True, verify: bool = False
) -> CSRGraph:
    """Load a ``.tricsr`` file, memory-mapped unless ``mmap=False``."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read(_HEADER.size)
    except OSError as e:
        raise CacheError(f"cannot read {path}: {e}") from e
    if len(raw) < _HEADER.size:
        raise CacheError(f"{path}: truncated header ({len(raw)} bytes)")
    magic, n_nodes, n_rows, row_code, col_code, crc = _HEADER.unpack(raw)
    if magic[:6] != TRICSR_MAGIC[:6]:
        raise CacheError(f"{path}: not a .tricsr file (bad magic {magic!r})")
    if magic != TRICSR_MAGIC:
        raise CacheError(
            f"{path}: version {magic[6]} != supported {TRICSR_VERSION}; "
            "re-ingest to refresh the cache"
        )
    try:
        row_dtype = _DTYPE_BY_CODE[row_code]
        col_dtype = _DTYPE_BY_CODE[col_code]
    except KeyError as e:
        raise CacheError(f"{path}: unsupported dtype code {e.args[0]}") from None
    row_bytes = (n_nodes + 1) * row_dtype.itemsize
    col_bytes = n_rows * col_dtype.itemsize
    expect = _HEADER.size + row_bytes + col_bytes
    actual = os.path.getsize(path)
    if actual != expect:
        raise CacheError(f"{path}: size {actual} != header-implied {expect}")
    if mmap:
        row = np.memmap(path, dtype=row_dtype, mode="r",
                        offset=_HEADER.size, shape=(n_nodes + 1,))
        col = np.memmap(path, dtype=col_dtype, mode="r",
                        offset=_HEADER.size + row_bytes, shape=(n_rows,))
    else:
        with open(path, "rb") as fh:
            fh.seek(_HEADER.size)
            row = np.frombuffer(fh.read(row_bytes), dtype=row_dtype)
            col = np.frombuffer(fh.read(col_bytes), dtype=col_dtype)
    if verify:
        got = zlib.crc32(np.asarray(col).tobytes(),
                         zlib.crc32(np.asarray(row).tobytes()))
        if got != crc:
            raise CacheError(f"{path}: checksum mismatch (stored {crc:#x}, "
                             f"computed {got:#x}) — cache is corrupt, delete it")
    return CSRGraph(row, col, int(n_nodes))


# ---------------------------------------------------------------------------
# sharded slab views (.tricsr.stripe{k}of{N})
# ---------------------------------------------------------------------------


class CSRStripe(NamedTuple):
    """One contiguous node-range slab of an undirected canonical CSR.

    Covers the half-open node range ``[node_lo, node_hi)``:
    ``row_offsets`` is the **absolute** ``row_offsets[node_lo : node_hi+1]``
    slice of the full CSR (so ``row_offsets[0]`` is this slab's global
    ``col`` start, not zero) and ``col`` the matching neighbor slice.
    Arrays may be read-only memory maps over the slab file.
    """

    row_offsets: np.ndarray  # (node_hi - node_lo + 1,) absolute offsets
    col: np.ndarray          # (row_offsets[-1] - row_offsets[0],)
    n_nodes: int             # global node count (all slabs agree)
    node_lo: int
    node_hi: int             # exclusive
    stripe_index: int
    n_stripes: int

    @property
    def n_local_nodes(self) -> int:
        return self.node_hi - self.node_lo

    @property
    def n_cols(self) -> int:
        return int(self.col.shape[0])


def plan_csr_stripes(row_offsets, n_stripes: int) -> list[tuple[int, int]]:
    """Split ``[0, n)`` into ``n_stripes`` contiguous node ranges balanced
    by neighbor (``col``) count.

    Returns half-open ``(node_lo, node_hi)`` pairs covering every node
    exactly once; ranges may be empty on tiny graphs (more stripes than
    rows' worth of work) — empty slabs are valid and round-trip fine.
    """
    if n_stripes < 1:
        raise ValueError("n_stripes must be >= 1")
    row = np.asarray(row_offsets, dtype=np.int64)
    n = row.shape[0] - 1
    total = int(row[-1]) if n >= 0 else 0
    targets = (total * np.arange(1, n_stripes, dtype=np.int64)) // n_stripes
    cuts = np.searchsorted(row, targets, side="left")
    cuts = np.maximum.accumulate(np.clip(cuts, 0, n))
    bounds = np.concatenate([[0], cuts, [n]])
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_stripes)]


def stripe_path(path: str | os.PathLike, k: int, n_stripes: int) -> str:
    """The on-disk name of slab ``k`` of ``n_stripes`` for cache ``path``."""
    return f"{os.fspath(path)}.stripe{k}of{n_stripes}"


def save_tricsr_stripes(
    path: str | os.PathLike, csr: CSRGraph, n_stripes: int
) -> list[str]:
    """Write ``csr`` as ``n_stripes`` slab files next to ``path``.

    Each slab is written atomically (tmp + rename) with its own crc32;
    returns the slab paths in stripe order.  ``path`` itself is not
    touched — the sharded views coexist with the unsharded cache.
    """
    row = np.ascontiguousarray(csr.row_offsets, dtype=np.int64)
    col = np.ascontiguousarray(csr.col, dtype=np.int32)
    if row.shape[0] != csr.n_nodes + 1:
        raise ValueError(
            f"row_offsets has {row.shape[0]} entries for n_nodes={csr.n_nodes}"
        )
    paths = []
    for k, (lo, hi) in enumerate(plan_csr_stripes(row, n_stripes)):
        row_slab = row[lo: hi + 1]
        col_slab = col[int(row[lo]): int(row[hi])]
        crc = zlib.crc32(col_slab.tobytes(), zlib.crc32(row_slab.tobytes()))
        header = _SLAB_HEADER.pack(
            TRISLB_MAGIC, csr.n_nodes, lo, hi, col_slab.shape[0],
            k, n_stripes, row.dtype.num, col.dtype.num, crc,
        )
        target = stripe_path(path, k, n_stripes)
        tmp = target + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(header)
            fh.write(row_slab.tobytes())
            fh.write(col_slab.tobytes())
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, target)
        paths.append(target)
    return paths


def load_tricsr_stripe(
    path: str | os.PathLike, *, mmap: bool = True, verify: bool = False
) -> CSRStripe:
    """Load one slab file, memory-mapped unless ``mmap=False``."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read(_SLAB_HEADER.size)
    except OSError as e:
        raise CacheError(f"cannot read {path}: {e}") from e
    if len(raw) < _SLAB_HEADER.size:
        raise CacheError(f"{path}: truncated header ({len(raw)} bytes)")
    (magic, n_nodes, lo, hi, col_len, k, n_stripes,
     row_code, col_code, crc) = _SLAB_HEADER.unpack(raw)
    if magic[:6] != TRISLB_MAGIC[:6]:
        raise CacheError(f"{path}: not a .tricsr slab (bad magic {magic!r})")
    if magic != TRISLB_MAGIC:
        raise CacheError(
            f"{path}: version {magic[6]} != supported {TRICSR_VERSION}; "
            "re-shard to refresh the slabs"
        )
    if not (0 <= lo <= hi <= n_nodes) or not (0 <= k < n_stripes):
        raise CacheError(
            f"{path}: inconsistent slab header (nodes [{lo}, {hi}) of "
            f"{n_nodes}, stripe {k} of {n_stripes})"
        )
    try:
        row_dtype = _DTYPE_BY_CODE[row_code]
        col_dtype = _DTYPE_BY_CODE[col_code]
    except KeyError as e:
        raise CacheError(f"{path}: unsupported dtype code {e.args[0]}") from None
    row_bytes = (hi - lo + 1) * row_dtype.itemsize
    col_bytes = col_len * col_dtype.itemsize
    expect = _SLAB_HEADER.size + row_bytes + col_bytes
    actual = os.path.getsize(path)
    if actual != expect:
        raise CacheError(f"{path}: size {actual} != header-implied {expect}")
    if mmap:
        row = np.memmap(path, dtype=row_dtype, mode="r",
                        offset=_SLAB_HEADER.size, shape=(hi - lo + 1,))
        col = np.memmap(path, dtype=col_dtype, mode="r",
                        offset=_SLAB_HEADER.size + row_bytes, shape=(col_len,))
    else:
        with open(path, "rb") as fh:
            fh.seek(_SLAB_HEADER.size)
            row = np.frombuffer(fh.read(row_bytes), dtype=row_dtype)
            col = np.frombuffer(fh.read(col_bytes), dtype=col_dtype)
    if int(row[-1]) - int(row[0]) != col_len:
        raise CacheError(
            f"{path}: row-offset span {int(row[-1]) - int(row[0])} != "
            f"col payload {col_len}"
        )
    if verify:
        got = zlib.crc32(np.asarray(col).tobytes(),
                         zlib.crc32(np.asarray(row).tobytes()))
        if got != crc:
            raise CacheError(f"{path}: checksum mismatch (stored {crc:#x}, "
                             f"computed {got:#x}) — slab is corrupt, delete it")
    return CSRStripe(row, col, int(n_nodes), int(lo), int(hi),
                     int(k), int(n_stripes))


def load_tricsr_stripes(
    path: str | os.PathLike, n_stripes: int, *,
    mmap: bool = True, verify: bool = False,
) -> list[CSRStripe]:
    """Load all ``n_stripes`` slab views of cache ``path``, in order."""
    return [
        load_tricsr_stripe(stripe_path(path, k, n_stripes),
                           mmap=mmap, verify=verify)
        for k in range(n_stripes)
    ]


def assemble_stripes(stripes) -> CSRGraph:
    """Reassemble slab views into the full CSR (the losslessness oracle).

    Validates that the slabs tile ``[0, n)`` contiguously and agree on
    the global shape; the result is bit-identical to the unsharded cache
    the slabs were split from.
    """
    stripes = sorted(stripes, key=lambda s: int(s.stripe_index))
    if not stripes:
        raise ValueError("no stripes given")
    n = int(stripes[0].n_nodes)
    n_stripes = int(stripes[0].n_stripes)
    if len(stripes) != n_stripes:
        raise CacheError(
            f"have {len(stripes)} slabs of a {n_stripes}-stripe set"
        )
    lo = 0
    for s in stripes:
        if int(s.n_nodes) != n or int(s.n_stripes) != n_stripes:
            raise CacheError("slabs disagree on the global CSR shape")
        if int(s.node_lo) != lo:
            raise CacheError(
                f"slab {s.stripe_index} starts at node {s.node_lo}, "
                f"expected {lo} — slab set is not contiguous"
            )
        lo = int(s.node_hi)
    if lo != n:
        raise CacheError(f"slabs cover [0, {lo}) of {n} nodes")
    row = np.concatenate(
        [np.asarray(s.row_offsets[:-1]) for s in stripes]
        + [np.asarray(stripes[-1].row_offsets[-1:])]
    ).astype(np.int64)
    col = np.concatenate(
        [np.asarray(s.col) for s in stripes]
    ).astype(np.int32) if any(s.n_cols for s in stripes) else np.zeros(0, np.int32)
    if col.shape[0] != int(row[-1]):
        raise CacheError(
            f"assembled col has {col.shape[0]} entries, row offsets imply "
            f"{int(row[-1])}"
        )
    return CSRGraph(row, col, n)
