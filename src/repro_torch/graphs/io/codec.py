"""The ``.tricsrz`` compressed, locality-ordered CSR cache format.

WebGraph's observation (Boldi & Vigna) applied to the ``.tricsr`` cache:
a canonical undirected CSR stores each row as a *sorted, strictly
increasing* neighbor list, so the list is fully determined by its gaps —
and after relabeling nodes for reference locality the gaps are small.
This module stores the ``col`` payload as per-node-range **neighbor
blocks** of delta + varint codes behind a block index, so consumers
decode individual node ranges on demand instead of memory-mapping a flat
4-byte-per-entry array.  The paper's §III-D argument that layout (not
FLOPs) dominates GPU triangle counting is the same argument in RAM: the
flat cache tops out where host memory does, the compressed cache does
not.

Per-row encoding (all values LEB128 varints, 7 payload bits per byte,
high bit = continuation):

* first neighbor — zigzag of ``col[0] - u`` (signed: a node's first
  neighbor may precede it),
* every later neighbor — ``gap - 1`` where ``gap = col[i] - col[i-1]``
  (gaps are >= 1 in a strictly increasing row, so the codes start at 0).

Rows of one block are concatenated into a single varint stream; the row
lengths needed to split the stream come from ``row_offsets``, which the
file stores as a varint *degree* stream (cumsummed at load — the flat
8-byte-per-node offsets would otherwise dominate the compressed size on
sparse graphs).

Orderings (recorded in the header, with the permutation in the file):

* ``natural`` — ingest order, no permutation stored,
* ``degree``  — degree-descending (stable): hubs get the small ids every
  row references, shrinking first-gaps on skewed graphs,
* ``bfs``     — breadth-first from the highest-degree node (unreached
  components seeded in degree order): neighbors land near each other,
  shrinking within-row gaps on meshes/roads.

The stored ``new_to_old`` permutation (``new_to_old[new_id] = old_id``)
is what maps per-node/support results computed on the relabeled graph
back to original ids — :meth:`CompressedCSR.map_per_node`.

File layout (little-endian)::

    offset  size  field
    0       8     magic  b"TRICSZ\\x01\\n"  (version byte inside the magic)
    8       8     n_nodes                     (u64)
    16      8     n_cols = total neighbors    (u64; 2 x undirected edges)
    24      1     ordering code (0 natural / 1 degree / 2 bfs)
    25      1     flags (bit 0: permutation present)
    26      2     reserved (zeros)
    28      4     nodes_per_block             (u32)
    32      8     n_blocks                    (u64)
    40      8     degree-stream bytes         (u64)
    48      8     payload bytes               (u64)
    56      4     crc32 of the meta region    (u32)
    60      4     crc32 of the payload        (u32)
    64      ...   meta region: degree varint stream, then new_to_old
                  (n x int32, iff flags bit 0), then the block index —
                  (n_blocks+1) x u64 payload byte offsets followed by
                  n_blocks x u32 per-block crc32s
    ...     ...   payload: concatenated per-block varint streams

The meta crc is checked on **every** load (it covers the block index, so
a bit flip there is caught before any offset is trusted); each block's
crc is checked on every :meth:`CompressedCSR.decode_block`.  Truncation
is caught by the exact file-size check.  ``verify=True`` additionally
pays one full payload read for the payload crc.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from repro_torch.distributed.compression import ensure_fits_int32

from .cache import CSRGraph, CSRStripe, CacheError, plan_csr_stripes

__all__ = [
    "TRICSRZ_MAGIC",
    "TRICSRZ_VERSION",
    "ORDERINGS",
    "DEFAULT_NODES_PER_BLOCK",
    "encode_varints",
    "decode_varints",
    "order_permutation",
    "relabel_csr",
    "CompressedCSR",
    "save_tricsrz",
    "load_tricsrz",
    "csr_stripes_from_compressed",
    "load_tricsrz_stripe",
]

TRICSRZ_VERSION = 1
TRICSRZ_MAGIC = b"TRICSZ" + bytes([TRICSRZ_VERSION]) + b"\n"
# magic, n_nodes, n_cols, order code, flags, pad, nodes_per_block,
# n_blocks, degree-stream bytes, payload bytes, meta crc32, payload crc32
_HEADER = struct.Struct("<8sQQBB2xIQQQLL")
assert _HEADER.size == 64

ORDERINGS = ("natural", "degree", "bfs")
_ORDER_CODE = {name: i for i, name in enumerate(ORDERINGS)}
_FLAG_PERM = 1

DEFAULT_NODES_PER_BLOCK = 4096

# LEB128 on 64-bit values: at most ceil(64/7) = 10 bytes per code.  A
# longer run cannot come from this encoder — treat it as corruption.
_MAX_VARINT_BYTES = 10


# ---------------------------------------------------------------------------
# varint + zigzag primitives (vectorized; no per-value Python loop)
# ---------------------------------------------------------------------------


def _zigzag(x: np.ndarray) -> np.ndarray:
    """Map signed int64 to unsigned so small magnitudes get short varints."""
    x = np.asarray(x, dtype=np.int64)
    return ((x << 1) ^ (x >> 63)).astype(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    z = np.asarray(z, dtype=np.uint64)
    return ((z >> np.uint64(1)).astype(np.int64)) ^ -(z & np.uint64(1)).astype(np.int64)


def encode_varints(values: np.ndarray) -> np.ndarray:
    """LEB128-encode a uint64 array into a flat uint8 stream.

    Vectorized: byte counts via repeated 7-bit shifts (<= 10 rounds),
    then one gather/shift/mask pass builds every output byte at once.
    """
    v = np.ascontiguousarray(values, dtype=np.uint64)
    if v.size == 0:
        return np.zeros(0, np.uint8)
    nbytes = np.ones(v.size, np.int64)
    t = v >> np.uint64(7)
    while t.any():
        nbytes += (t != 0)
        t >>= np.uint64(7)
    ends = np.cumsum(nbytes)
    starts = ends - nbytes
    total = int(ends[-1])
    pos = np.arange(total, dtype=np.int64) - np.repeat(starts, nbytes)
    chunks = (np.repeat(v, nbytes) >> (np.uint64(7) * pos.astype(np.uint64))) & np.uint64(0x7F)
    cont = pos < np.repeat(nbytes - 1, nbytes)
    return (chunks | (cont.astype(np.uint64) << np.uint64(7))).astype(np.uint8)


def decode_varints(buf: np.ndarray, count: int) -> np.ndarray:
    """Decode exactly ``count`` LEB128 codes consuming the whole buffer.

    Strictness is the corruption gate: a truncated stream (too few
    terminator bytes), trailing garbage, or an over-long code all raise
    :class:`~repro_torch.graphs.io.CacheError` instead of decoding quietly.
    """
    b = np.ascontiguousarray(buf, dtype=np.uint8)
    count = int(count)
    if count == 0:
        if b.size:
            raise CacheError(f"varint stream has {b.size} trailing bytes after 0 codes")
        return np.zeros(0, np.uint64)
    is_last = (b & np.uint8(0x80)) == 0
    ends = np.flatnonzero(is_last)
    if ends.size != count or int(ends[-1]) != b.size - 1:
        raise CacheError(
            f"varint stream is corrupt: {ends.size} codes in {b.size} bytes, "
            f"expected exactly {count} consuming the whole stream"
        )
    starts = np.empty(count, np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    nbytes = ends - starts + 1
    if int(nbytes.max()) > _MAX_VARINT_BYTES:
        raise CacheError(
            f"varint stream is corrupt: {int(nbytes.max())}-byte code exceeds "
            f"the {_MAX_VARINT_BYTES}-byte 64-bit limit"
        )
    pos = np.arange(b.size, dtype=np.int64) - np.repeat(starts, nbytes)
    contrib = (b & np.uint8(0x7F)).astype(np.uint64) << (np.uint64(7) * pos.astype(np.uint64))
    return np.add.reduceat(contrib, starts)


# ---------------------------------------------------------------------------
# per-block row codec
# ---------------------------------------------------------------------------


def _encode_rows(node_lo: int, lens: np.ndarray, col: np.ndarray) -> np.ndarray:
    """Delta-encode the concatenated neighbor lists of rows starting at
    ``node_lo`` (``lens[i]`` neighbors for node ``node_lo + i``) into one
    varint stream."""
    c = np.asarray(col, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    if c.size == 0:
        return np.zeros(0, np.uint8)
    nonempty = lens > 0
    starts = (np.cumsum(lens) - lens)[nonempty]
    d = np.empty(c.size, np.int64)
    d[0] = 1  # position 0 is always a row start; overwritten below
    d[1:] = c[1:] - c[:-1]
    vals = d - 1
    start_mask = np.zeros(c.size, bool)
    start_mask[starts] = True
    if vals[~start_mask].size and int(vals[~start_mask].min()) < 0:
        raise CacheError(
            "cannot compress: neighbor lists are not strictly increasing "
            "(the cache stores canonical sorted-unique rows)"
        )
    u = (node_lo + np.flatnonzero(nonempty)).astype(np.int64)
    first = _zigzag(c[starts] - u)
    vals = vals.astype(np.uint64)
    vals[starts] = first
    return encode_varints(vals)


def _decode_rows(node_lo: int, lens: np.ndarray, buf: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_encode_rows`; returns int64 neighbors."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    vals = decode_varints(buf, total)
    if total == 0:
        return np.zeros(0, np.int64)
    nonempty = lens > 0
    starts = (np.cumsum(lens) - lens)[nonempty]
    u = (node_lo + np.flatnonzero(nonempty)).astype(np.int64)
    a = vals.astype(np.int64) + 1  # gap-1 codes back to gaps
    a[starts] = u + _unzigzag(vals[starts])  # absolute first neighbors
    c = np.cumsum(a)
    prev = np.zeros(starts.size, np.int64)
    prev[1:] = c[starts[1:] - 1]
    return c - np.repeat(prev, lens[nonempty])


# ---------------------------------------------------------------------------
# locality relabeling
# ---------------------------------------------------------------------------


def order_permutation(csr: CSRGraph, order: str) -> np.ndarray:
    """``new_to_old`` permutation for ``order`` (int64, len ``n_nodes``).

    ``degree`` is a stable degree-descending argsort; ``bfs`` runs a
    level-synchronous BFS from the highest-degree node, expanding each
    frontier in one vectorized gather and seeding unreached components
    in degree order — both deterministic.
    """
    if order not in ORDERINGS:
        raise ValueError(f"unknown ordering {order!r}; known: {ORDERINGS}")
    row = np.asarray(csr.row_offsets, dtype=np.int64)
    n = csr.n_nodes
    deg = np.diff(row)
    if order == "natural" or n == 0:
        return np.arange(n, dtype=np.int64)
    seeds = np.argsort(-deg, kind="stable").astype(np.int64)
    if order == "degree":
        return seeds
    col = np.asarray(csr.col, dtype=np.int64)
    visited = np.zeros(n, bool)
    out = np.empty(n, np.int64)
    written = 0
    for s in seeds:
        if visited[s]:
            continue
        visited[s] = True
        frontier = np.asarray([s], dtype=np.int64)
        while frontier.size:
            out[written : written + frontier.size] = frontier
            written += frontier.size
            lens = deg[frontier]
            total = int(lens.sum())
            if total == 0:
                break
            base = np.repeat(row[frontier], lens)
            local = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(lens) - lens, lens
            )
            nbrs = col[base + local]
            nbrs = nbrs[~visited[nbrs]]
            # order-preserving unique: keep each node's first encounter
            _, first_idx = np.unique(nbrs, return_index=True)
            frontier = nbrs[np.sort(first_idx)]
            visited[frontier] = True
    assert written == n, "BFS order did not cover every node"
    return out


def relabel_csr(csr: CSRGraph, new_to_old: np.ndarray) -> CSRGraph:
    """Apply a node permutation to an undirected canonical CSR.

    Rows are gathered in new-id order, neighbor ids mapped through the
    inverse permutation, and each row re-sorted — the result is again a
    canonical CSR (sorted strictly increasing rows), of the *same* graph
    up to node names, so triangle counts and truss spectra are invariant.
    """
    row = np.asarray(csr.row_offsets, dtype=np.int64)
    col = np.asarray(csr.col, dtype=np.int64)
    n = csr.n_nodes
    new_to_old = np.asarray(new_to_old, dtype=np.int64)
    if new_to_old.shape != (n,):
        raise ValueError(f"permutation has shape {new_to_old.shape}, graph has {n} nodes")
    old_to_new = np.empty(n, np.int64)
    old_to_new[new_to_old] = np.arange(n, dtype=np.int64)
    deg = np.diff(row)
    new_deg = deg[new_to_old]
    new_row = np.zeros(n + 1, np.int64)
    np.cumsum(new_deg, out=new_row[1:])
    total = col.size
    src_base = np.repeat(row[new_to_old], new_deg)
    local = np.arange(total, dtype=np.int64) - np.repeat(new_row[:-1], new_deg)
    new_col = old_to_new[col[src_base + local]]
    rid = np.repeat(np.arange(n, dtype=np.int64), new_deg)
    sorter = np.argsort(rid * np.int64(max(n, 1)) + new_col, kind="stable")
    ensure_fits_int32(max(n - 1, 0), "relabeled node ids (CSR col dtype)")
    return CSRGraph(new_row, new_col[sorter].astype(np.int32), n)


# ---------------------------------------------------------------------------
# the CompressedCSR handle
# ---------------------------------------------------------------------------


class CompressedCSR:
    """A loaded ``.tricsrz``: flat row offsets, block-decoded neighbors.

    Quacks enough like :class:`~repro_torch.graphs.io.CSRGraph` for callers
    that only need shape/degree information (``n_nodes``, ``n_edges``,
    ``row_offsets``, ``degrees``, ``stats``), but deliberately has **no**
    ``col`` attribute — consumers that need neighbors must go through
    :meth:`decode_block` / :meth:`decode_node_range` (the engine's
    ``prepare_oriented`` does exactly that, one block at a time), or pay
    for the full decode explicitly with :meth:`to_csr`.
    """

    def __init__(
        self,
        path: str | None,
        n_nodes: int,
        row_offsets: np.ndarray,
        order: str,
        new_to_old: np.ndarray | None,
        block_offsets: np.ndarray,
        block_crcs: np.ndarray,
        payload: np.ndarray,
        nodes_per_block: int,
    ):
        self.path = path
        self.n_nodes = int(n_nodes)
        self.row_offsets = row_offsets
        self.order = order
        self.nodes_per_block = int(nodes_per_block)
        self._new_to_old = new_to_old
        self._old_to_new = None
        self._block_offsets = block_offsets
        self._block_crcs = block_crcs
        self._payload = payload

    # -- shape / bookkeeping -------------------------------------------------

    @property
    def n_cols(self) -> int:
        return int(self.row_offsets[-1])

    @property
    def n_edges(self) -> int:
        return self.n_cols // 2

    @property
    def n_blocks(self) -> int:
        return len(self._block_offsets) - 1

    def degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets).astype(np.int64)

    def stats(self) -> dict:
        from ..formats import stats_from_degrees

        return stats_from_degrees(self.degrees(), self.n_nodes)

    def compressed_nbytes(self) -> int:
        """Bytes of the compressed neighbor payload alone."""
        return int(self._payload.shape[0])

    def resident_nbytes(self) -> int:
        """Actual host bytes this handle keeps resident: the materialized
        row offsets, permutation, and block index, plus the (possibly
        memory-mapped) compressed payload — **not** the decoded 4-byte-
        per-neighbor ``col`` this format exists to avoid."""
        total = int(self.row_offsets.nbytes) + int(self._payload.shape[0])
        total += int(self._block_offsets.nbytes) + int(self._block_crcs.nbytes)
        if self._new_to_old is not None:
            total += int(self._new_to_old.nbytes)
        if self._old_to_new is not None:
            total += int(self._old_to_new.nbytes)
        return total

    # -- id mapping ----------------------------------------------------------

    @property
    def new_to_old(self) -> np.ndarray:
        """``new_to_old[new_id] = old_id`` (identity for natural order)."""
        if self._new_to_old is None:
            self._new_to_old = np.arange(self.n_nodes, dtype=np.int64)
        return self._new_to_old

    @property
    def old_to_new(self) -> np.ndarray:
        if self._old_to_new is None:
            inv = np.empty(self.n_nodes, np.int64)
            inv[self.new_to_old] = np.arange(self.n_nodes, dtype=np.int64)
            self._old_to_new = inv
        return self._old_to_new

    def map_per_node(self, values: np.ndarray) -> np.ndarray:
        """Reindex a per-node result from relabeled ids to original ids:
        ``out[original_id] = values[relabeled_id]``."""
        values = np.asarray(values)
        if values.shape[0] != self.n_nodes:
            raise ValueError(
                f"per-node result has {values.shape[0]} entries, graph has "
                f"{self.n_nodes} nodes"
            )
        out = np.empty_like(values)
        out[self.new_to_old] = values
        return out

    # -- block decoding ------------------------------------------------------

    def block_node_range(self, k: int) -> tuple[int, int]:
        """Half-open node range ``[lo, hi)`` covered by block ``k``."""
        if not 0 <= k < self.n_blocks:
            raise IndexError(f"block {k} of {self.n_blocks}")
        lo = k * self.nodes_per_block
        return lo, min(self.n_nodes, lo + self.nodes_per_block)

    def decode_block(self, k: int) -> np.ndarray:
        """Decode block ``k``'s neighbors (int32), crc-checking the slice."""
        lo, hi = self.block_node_range(k)
        o0, o1 = int(self._block_offsets[k]), int(self._block_offsets[k + 1])
        seg = np.asarray(self._payload[o0:o1])
        if zlib.crc32(seg.tobytes()) != int(self._block_crcs[k]):
            raise CacheError(
                f"{self.path or '<tricsrz>'}: block {k} crc mismatch — "
                "payload is corrupt, delete the cache file"
            )
        lens = np.diff(self.row_offsets[lo : hi + 1])
        col = _decode_rows(lo, lens, seg)
        if col.size and not (0 <= int(col.min()) and int(col.max()) < self.n_nodes):
            raise CacheError(
                f"{self.path or '<tricsrz>'}: block {k} decoded neighbor ids "
                f"outside [0, {self.n_nodes}) — payload is corrupt"
            )
        ensure_fits_int32(max(self.n_nodes - 1, 0), "decoded neighbor ids (col dtype)")
        return col.astype(np.int32)

    def decode_node_range(self, lo: int, hi: int) -> np.ndarray:
        """Neighbors of rows ``[lo, hi)``, decoding only touched blocks."""
        if not 0 <= lo <= hi <= self.n_nodes:
            raise ValueError(f"node range [{lo}, {hi}) outside [0, {self.n_nodes})")
        if lo == hi:
            return np.zeros(0, np.int32)
        npb = self.nodes_per_block
        parts = []
        for k in range(lo // npb, (hi + npb - 1) // npb):
            blo, bhi = self.block_node_range(k)
            colb = self.decode_block(k)
            row = self.row_offsets
            s = int(row[max(lo, blo)] - row[blo])
            e = int(row[min(hi, bhi)] - row[blo])
            parts.append(colb[s:e])
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    # -- full-decode oracles -------------------------------------------------

    def to_csr(self) -> CSRGraph:
        """Decode everything into a flat :class:`CSRGraph` (relabeled ids).

        This is the losslessness oracle — bit-identical to the CSR that
        was compressed — not the serving path; it materializes the full
        4-byte-per-neighbor ``col`` the compressed format avoids.
        """
        cols = [self.decode_block(k) for k in range(self.n_blocks)]
        col = np.concatenate(cols) if cols else np.zeros(0, np.int32)
        return CSRGraph(np.asarray(self.row_offsets, np.int64), col, self.n_nodes)

    def edge_array(self, original_ids: bool = True) -> np.ndarray:
        """Canonical edge array; by default mapped back to original ids
        (the incremental counter bootstraps from this, so its stream of
        inserts/deletes keeps speaking the caller's node names)."""
        edges = self.to_csr().edge_array()
        if original_ids and self.order != "natural" and edges.size:
            edges = self.new_to_old[edges]
        return edges


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def save_tricsrz(
    path: str | os.PathLike,
    csr: CSRGraph,
    *,
    order: str = "degree",
    nodes_per_block: int = DEFAULT_NODES_PER_BLOCK,
) -> None:
    """Relabel ``csr`` by ``order``, compress, and atomically write ``path``."""
    if order not in ORDERINGS:
        raise ValueError(f"unknown ordering {order!r}; known: {ORDERINGS}")
    if nodes_per_block < 1 or nodes_per_block > 0xFFFFFFFF:
        raise ValueError(f"nodes_per_block {nodes_per_block} outside [1, 2^32)")
    n = csr.n_nodes
    if order != "natural":
        perm = order_permutation(csr, order)
        rl = relabel_csr(csr, perm)
    else:
        perm, rl = None, csr
    row = np.ascontiguousarray(rl.row_offsets, dtype=np.int64)
    col = np.ascontiguousarray(rl.col)
    if row.shape[0] != n + 1:
        raise ValueError(f"row_offsets has {row.shape[0]} entries for n_nodes={n}")
    deg_stream = encode_varints(np.diff(row).astype(np.uint64))
    n_blocks = (n + nodes_per_block - 1) // nodes_per_block
    chunks, offsets, crcs = [], [0], []
    for k in range(n_blocks):
        lo = k * nodes_per_block
        hi = min(n, lo + nodes_per_block)
        lens = np.diff(row[lo : hi + 1])
        chunk = _encode_rows(lo, lens, col[int(row[lo]) : int(row[hi])])
        chunks.append(chunk)
        offsets.append(offsets[-1] + chunk.shape[0])
        crcs.append(zlib.crc32(chunk.tobytes()))
    payload = b"".join(c.tobytes() for c in chunks)
    meta = deg_stream.tobytes()
    flags = 0
    if perm is not None:
        ensure_fits_int32(max(n - 1, 0), "permutation entries (int32 storage)")
        meta += perm.astype(np.int32).tobytes()
        flags |= _FLAG_PERM
    meta += np.asarray(offsets, np.uint64).tobytes()
    meta += np.asarray(crcs, np.uint32).tobytes()
    header = _HEADER.pack(
        TRICSRZ_MAGIC, n, col.shape[0], _ORDER_CODE[order], flags,
        nodes_per_block, n_blocks, len(deg_stream.tobytes()), len(payload),
        zlib.crc32(meta), zlib.crc32(payload),
    )
    tmp = os.fspath(path) + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(header)
        fh.write(meta)
        fh.write(payload)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_tricsrz(
    path: str | os.PathLike, *, mmap: bool = True, verify: bool = False
) -> CompressedCSR:
    """Load a ``.tricsrz``; the payload stays memory-mapped unless
    ``mmap=False``.  The meta region (degrees, permutation, block index)
    is always read and crc-checked — corruption there would misdirect
    every later block decode."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read(_HEADER.size)
    except OSError as e:
        raise CacheError(f"cannot read {path}: {e}") from e
    if len(raw) < _HEADER.size:
        raise CacheError(f"{path}: truncated header ({len(raw)} bytes)")
    (magic, n_nodes, n_cols, order_code, flags, nodes_per_block, n_blocks,
     deg_bytes, payload_bytes, crc_meta, crc_payload) = _HEADER.unpack(raw)
    if magic[:6] != TRICSRZ_MAGIC[:6]:
        raise CacheError(f"{path}: not a .tricsrz file (bad magic {magic!r})")
    if magic != TRICSRZ_MAGIC:
        raise CacheError(
            f"{path}: version {magic[6]} != supported {TRICSRZ_VERSION}; "
            "re-ingest to refresh the cache"
        )
    if order_code >= len(ORDERINGS):
        raise CacheError(f"{path}: unknown ordering code {order_code}")
    order = ORDERINGS[order_code]
    has_perm = bool(flags & _FLAG_PERM)
    if nodes_per_block < 1:
        raise CacheError(f"{path}: nodes_per_block must be positive")
    expect_blocks = (n_nodes + nodes_per_block - 1) // nodes_per_block
    if n_blocks != expect_blocks:
        raise CacheError(
            f"{path}: {n_blocks} blocks inconsistent with {n_nodes} nodes "
            f"at {nodes_per_block} nodes/block (expected {expect_blocks})"
        )
    perm_bytes = n_nodes * 4 if has_perm else 0
    index_bytes = (n_blocks + 1) * 8 + n_blocks * 4
    meta_len = deg_bytes + perm_bytes + index_bytes
    expect = _HEADER.size + meta_len + payload_bytes
    actual = os.path.getsize(path)
    if actual != expect:
        raise CacheError(f"{path}: size {actual} != header-implied {expect}")
    with open(path, "rb") as fh:
        fh.seek(_HEADER.size)
        meta = fh.read(meta_len)
    if zlib.crc32(meta) != crc_meta:
        raise CacheError(
            f"{path}: meta-region checksum mismatch (degrees/permutation/"
            "block index) — cache is corrupt, delete it"
        )
    degrees = decode_varints(np.frombuffer(meta, np.uint8, count=deg_bytes), n_nodes)
    row = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(degrees.astype(np.int64), out=row[1:])
    if int(row[-1]) != n_cols:
        raise CacheError(
            f"{path}: degree stream sums to {int(row[-1])}, header says {n_cols}"
        )
    off = deg_bytes
    perm = None
    if has_perm:
        perm = np.frombuffer(meta, np.int32, count=n_nodes, offset=off).astype(np.int64)
        off += perm_bytes
        if not np.array_equal(np.sort(perm), np.arange(n_nodes)):
            raise CacheError(f"{path}: stored permutation is not a permutation")
    block_offsets = np.frombuffer(meta, np.uint64, count=n_blocks + 1, offset=off)
    off += (n_blocks + 1) * 8
    block_crcs = np.frombuffer(meta, np.uint32, count=n_blocks, offset=off)
    if int(block_offsets[0]) != 0 or int(block_offsets[-1]) != payload_bytes or (
        np.diff(block_offsets.astype(np.int64)) < 0
    ).any():
        raise CacheError(f"{path}: block index offsets are inconsistent")
    if mmap and payload_bytes:
        payload = np.memmap(path, dtype=np.uint8, mode="r",
                            offset=_HEADER.size + meta_len, shape=(payload_bytes,))
    else:
        with open(path, "rb") as fh:
            fh.seek(_HEADER.size + meta_len)
            payload = np.frombuffer(fh.read(payload_bytes), np.uint8)
    z = CompressedCSR(os.fspath(path), n_nodes, row, order, perm,
                      block_offsets, block_crcs, payload, nodes_per_block)
    if verify:
        if zlib.crc32(np.asarray(payload).tobytes()) != crc_payload:
            raise CacheError(
                f"{path}: payload checksum mismatch — cache is corrupt, delete it"
            )
        z.to_csr()  # every block decodes cleanly and in-bounds
    return z


# ---------------------------------------------------------------------------
# slab views: the block index doubles as the stripe mechanism
# ---------------------------------------------------------------------------


def csr_stripes_from_compressed(z: CompressedCSR, n_stripes: int) -> list[CSRStripe]:
    """Split a compressed graph into §III-E slab views (decoded per range).

    Same col-count-balanced planning as the flat ``.tricsr.stripe{k}of{N}``
    files, but no sharded files are needed: each stripe decodes only the
    blocks overlapping its node range, so peak host memory per device is
    its own slab plus at most one straddling block — the compressed
    analogue of "each device memmaps only its slab".  The returned
    :class:`CSRStripe` views feed ``oriented_csr_from_slabs`` /
    ``count_triangles_distributed_slabs`` unchanged.
    """
    row = np.asarray(z.row_offsets, dtype=np.int64)
    return [
        CSRStripe(row[lo : hi + 1], z.decode_node_range(lo, hi),
                  z.n_nodes, lo, hi, k, n_stripes)
        for k, (lo, hi) in enumerate(plan_csr_stripes(row, n_stripes))
    ]


def load_tricsrz_stripe(
    path: str | os.PathLike, k: int, n_stripes: int, *, mmap: bool = True
) -> CSRStripe:
    """Load stripe ``k`` of ``n_stripes`` straight from one ``.tricsrz``.

    The flat slab path writes N sharded files; here the block index *is*
    the shard mechanism — every device opens the same compressed file
    (mmap'd, so only touched pages fault in) and decodes its own node
    range.
    """
    z = load_tricsrz(path, mmap=mmap)
    bounds = plan_csr_stripes(z.row_offsets, n_stripes)
    if not 0 <= k < n_stripes:
        raise ValueError(f"stripe {k} of {n_stripes}")
    lo, hi = bounds[k]
    row = np.asarray(z.row_offsets, dtype=np.int64)
    return CSRStripe(row[lo : hi + 1], z.decode_node_range(lo, hi),
                     z.n_nodes, lo, hi, k, n_stripes)
