"""Chunked streaming parsers for on-disk edge lists.

Both parsers yield ``(chunk, 2)`` int64 NumPy blocks of at most
``max_chunk_edges`` rows, so peak host memory is bounded regardless of
file size.  Supported formats:

* **SNAP text** (``.txt``, ``.el``, ``.edges``, ``.tsv``, ``.csv`` …):
  one edge per line, two integer ids separated by whitespace, tab or
  comma; ``#`` and ``%`` comment lines and blank lines skipped.  This is
  the format of every snap.stanford.edu download in the paper's Table I.
* **MatrixMarket coordinate** (``.mtx``): ``%%MatrixMarket`` banner,
  ``%`` comments, a ``rows cols nnz`` size line, then 1-based ``i j
  [value]`` entries (converted to 0-based ids; values ignored).
* Either of the above behind **gzip** (``.gz`` suffix), streamed without
  decompressing to disk.

Node ids must be non-negative and < 2³¹ (the canonical pipeline packs
pairs into 64-bit keys and emits int32 arrays); violations raise
``ValueError`` with the offending line number.
"""
from __future__ import annotations

import gzip
import io
import os
from typing import Iterator

import numpy as np

from ..formats import validate_node_ids

__all__ = [
    "DEFAULT_CHUNK_EDGES",
    "sniff_format",
    "iter_edge_chunks",
    "parse_edge_file",
]

DEFAULT_CHUNK_EDGES = 1 << 22  # 4M edges/chunk ≈ 64 MB of int64 pairs

# Read text in fixed-size byte blocks; a chunk of edges is assembled from
# however many blocks it takes.  64 KB keeps the Python-level loop cheap
# while never holding more than one block + one chunk of parsed pairs.
_TEXT_BLOCK_BYTES = 1 << 16

_TEXT_SUFFIXES = {".txt", ".el", ".edges", ".edgelist", ".tsv", ".csv", ".snap"}


def sniff_format(path: str | os.PathLike) -> str:
    """Return ``"mtx"`` or ``"text"`` for ``path`` (``.gz`` stripped)."""
    name = os.fspath(path)
    if name.endswith(".gz"):
        name = name[:-3]
    ext = os.path.splitext(name)[1].lower()
    if ext == ".mtx":
        return "mtx"
    if ext in _TEXT_SUFFIXES or ext == "":
        return "text"
    raise ValueError(
        f"cannot infer edge-list format from {path!r}: expected one of "
        f"{sorted(_TEXT_SUFFIXES | {'.mtx'})} (optionally .gz-compressed)"
    )


def _open_text(path: str | os.PathLike) -> io.TextIOBase:
    # latin-1 never fails to decode, so non-ASCII bytes in comment lines
    # (common in MatrixMarket headers) pass through harmlessly; integer
    # fields are pure ASCII either way and error cleanly in the parser
    if os.fspath(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="latin-1")
    return open(path, "r", encoding="latin-1", buffering=_TEXT_BLOCK_BYTES)




def _parse_pairs(lines: list[str], *, base: int, first_line_no: int) -> np.ndarray:
    """Vectorized two-column integer parse of non-comment text lines."""
    if not lines:
        return np.empty((0, 2), np.int64)
    # One split per line, then a single bulk str→int64 conversion.  A
    # ragged row (1 or 3+ columns) makes np.array raise rather than
    # re-pair tokens across rows; ids beyond int64 raise OverflowError.
    toks = [ln.replace(",", " ").split() for ln in lines]
    try:
        pairs = np.array(toks, dtype=np.int64)
    except (ValueError, OverflowError):
        pairs = None
    if pairs is None or pairs.ndim != 2 or pairs.shape[1] != 2:
        # Slow path only to locate the malformed line for the error message.
        for off, parts in enumerate(toks):
            ok = len(parts) == 2
            if ok:
                try:
                    np.array(parts, dtype=np.int64)  # parses or raises
                except (ValueError, OverflowError):
                    ok = False
            if not ok:
                raise ValueError(
                    f"line {first_line_no + off}: expected two integer node "
                    f"ids, got {' '.join(parts)!r}"
                )
        raise ValueError(
            f"malformed edge list near line {first_line_no}: columns are "
            "not consistently two integers per row"
        )
    if base:
        pairs = pairs - base
    validate_node_ids(pairs, context=f"edge list near line {first_line_no}")
    return pairs


def _iter_text_chunks(
    fh: io.TextIOBase, max_chunk_edges: int, *, base: int = 0, line_no: int = 0,
) -> Iterator[np.ndarray]:
    """Yield parsed ``(≤max_chunk_edges, 2)`` blocks from an open stream."""
    batch_lines = min(max_chunk_edges, _TEXT_BLOCK_BYTES // 4)
    pending: list[np.ndarray] = []
    pending_rows = 0
    lines: list[str] = []
    first_line_no = line_no + 1

    def drain(final: bool) -> Iterator[np.ndarray]:
        nonlocal pending, pending_rows
        while pending_rows >= max_chunk_edges or (final and pending_rows > 0):
            block = np.concatenate(pending, axis=0) if len(pending) > 1 else pending[0]
            yield block[:max_chunk_edges]
            rest = block[max_chunk_edges:]
            pending = [rest] if rest.size else []
            pending_rows = rest.shape[0]

    for raw in fh:
        line_no += 1
        s = raw.strip()
        if not s or s[0] in "#%":
            continue
        if not lines:
            first_line_no = line_no
        lines.append(s)
        if len(lines) >= batch_lines:
            pairs = _parse_pairs(lines, base=base, first_line_no=first_line_no)
            lines = []
            pending.append(pairs)
            pending_rows += pairs.shape[0]
            yield from drain(final=False)
    if lines:
        pairs = _parse_pairs(lines, base=base, first_line_no=first_line_no)
        pending.append(pairs)
        pending_rows += pairs.shape[0]
    yield from drain(final=True)


def _iter_mtx_chunks(fh: io.TextIOBase, max_chunk_edges: int) -> Iterator[np.ndarray]:
    """MatrixMarket coordinate parser: banner + size line, 1-based entries."""
    banner = fh.readline()
    line_no = 1
    if not banner.startswith("%%MatrixMarket"):
        raise ValueError("not a MatrixMarket file: missing %%MatrixMarket banner")
    fields = banner.split()
    if len(fields) < 4 or fields[1] != "matrix" or fields[2] != "coordinate":
        raise ValueError(f"unsupported MatrixMarket header {banner.strip()!r}: "
                         "only 'matrix coordinate' files hold edge lists")
    value_type = fields[3]
    has_values = value_type != "pattern"
    # size line: first non-comment line after the banner
    for raw in fh:
        line_no += 1
        s = raw.strip()
        if s and s[0] != "%":
            break
    else:
        raise ValueError("MatrixMarket file has no size line")
    parts = s.split()
    if len(parts) != 3 or not all(p.isdigit() for p in parts):
        raise ValueError(f"line {line_no}: malformed MatrixMarket size line {s!r}")
    if not has_values:
        yield from _iter_text_chunks(fh, max_chunk_edges, base=1, line_no=line_no)
        return
    # valued entries: strip the third column per block before the bulk parse
    lines: list[str] = []
    first_line_no = line_no + 1
    for raw in fh:
        line_no += 1
        s = raw.strip()
        if not s or s[0] == "%":
            continue
        if not lines:
            first_line_no = line_no
        cols = s.split()
        if len(cols) < 2:
            raise ValueError(f"line {line_no}: expected 'i j [value]', got {s!r}")
        lines.append(f"{cols[0]} {cols[1]}")
        if len(lines) >= max_chunk_edges:
            yield _parse_pairs(lines, base=1, first_line_no=first_line_no)
            lines = []
    if lines:
        yield _parse_pairs(lines, base=1, first_line_no=first_line_no)


def iter_edge_chunks(
    path: str | os.PathLike,
    max_chunk_edges: int = DEFAULT_CHUNK_EDGES,
    *,
    fmt: str | None = None,
) -> Iterator[np.ndarray]:
    """Stream ``(≤max_chunk_edges, 2)`` int64 edge blocks from ``path``.

    ``fmt`` overrides extension sniffing (``"text"`` or ``"mtx"``).  Raw
    blocks are exactly what the file says — self loops, duplicates and
    both-direction entries are *not* removed here; that is
    :func:`repro_torch.graphs.io.external.canonicalize_edges_external`'s job.
    """
    if max_chunk_edges < 1:
        raise ValueError("max_chunk_edges must be positive")
    fmt = fmt or sniff_format(path)
    with _open_text(path) as fh:
        if fmt == "mtx":
            yield from _iter_mtx_chunks(fh, max_chunk_edges)
        elif fmt == "text":
            yield from _iter_text_chunks(fh, max_chunk_edges)
        else:
            raise ValueError(f"unknown format {fmt!r}; expected 'text' or 'mtx'")


def parse_edge_file(
    path: str | os.PathLike,
    max_chunk_edges: int = DEFAULT_CHUNK_EDGES,
    *,
    fmt: str | None = None,
) -> np.ndarray:
    """Materialize the whole raw edge list (tests / small files only)."""
    chunks = list(iter_edge_chunks(path, max_chunk_edges, fmt=fmt))
    if not chunks:
        return np.empty((0, 2), np.int64)
    return np.concatenate(chunks, axis=0)
