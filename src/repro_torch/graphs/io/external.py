"""External-memory canonicalization of streamed edge chunks.

:func:`repro_torch.graphs.canonicalize_edges` packs each undirected pair into a
64-bit key (``lo << 32 | hi`` — the paper's §III-D2 single-key sort
trick) and uniquifies; that requires the whole raw edge set in RAM.  This
module runs the *same* key pipeline chunk-by-chunk:

1. each raw ``(chunk, 2)`` block is cleaned (self loops dropped, ids
   validated) and reduced to a sorted array of unique keys;
2. when the in-memory key buffer exceeds the chunk budget, it is spilled
   to a temporary file as one sorted *run*;
3. the runs are k-way merged (block-buffered, vectorized) back into the
   globally sorted, globally deduplicated key array, which unpacks into a
   canonical edge array **bit-identical** to the in-memory path.

Every dedup is :func:`repro_torch.graphs.formats.sorted_unique` (a sort and
a neighbour compare), not ``np.unique``, which numpy 2.3 runs through a
hash table that takes minutes at kron-21's tens of millions of keys.

Peak memory is O(``max_chunk_edges``) during the run phase and
O(output + merge buffers) during the merge — the raw edge multiset never
has to fit, which is the property that matters for SNAP-scale inputs
where duplicates and both-direction entries inflate the raw file ~2×+
over the canonical edge set.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Iterable, Iterator

import numpy as np

from ..formats import pack_unique_keys, sorted_unique, unpack_keys_canonical

__all__ = ["canonicalize_edges_external", "ExternalSortStats", "merge_sorted_runs"]


@dataclasses.dataclass
class ExternalSortStats:
    """What the external canonicalization actually did (for tests/benchmarks)."""

    raw_edges: int = 0          # rows read from the parser, pre-clean
    kept_edges: int = 0         # Σ per-chunk unique keys (self loops dropped,
                                # deduped within each chunk, not globally)
    spill_runs: int = 0         # sorted runs written to disk (0 = in-memory)
    spilled_keys: int = 0       # total keys across spilled runs
    unique_edges: int = 0       # undirected edges after global dedup
    merge_passes: int = 0       # 1 when runs were merged, else 0


class _RunReader:
    """Block-buffered reader over one sorted int64 run file."""

    def __init__(self, path: str, block_keys: int):
        self._fh = open(path, "rb")
        self._block_bytes = block_keys * 8
        self.block = np.empty((0,), np.int64)
        self.exhausted = False
        self.refill()

    def refill(self) -> None:
        data = self._fh.read(self._block_bytes)
        if not data:
            self.block = np.empty((0,), np.int64)
            self.exhausted = True
            self._fh.close()
        else:
            self.block = np.frombuffer(data, dtype=np.int64)

    def take_upto(self, cut: np.int64) -> np.ndarray:
        """Consume and return the prefix of the current block ≤ ``cut``."""
        n = int(np.searchsorted(self.block, cut, side="right"))
        out = self.block[:n]
        self.block = self.block[n:]
        if self.block.size == 0 and not self.exhausted:
            out = out.copy()  # detach from the buffer we are about to drop
            self.refill()
        return out


def merge_sorted_runs(
    paths: list[str], *, block_keys: int = 1 << 20
) -> Iterator[np.ndarray]:
    """K-way merge of sorted-unique int64 run files, yielding sorted
    globally-unique blocks.

    Each yielded block holds every key ≤ the round's *cut* (the minimum
    over the runs' current block maxima): every run is sorted, so keys
    beyond a run's current block are ≥ its block maximum ≥ cut — nothing
    ≤ cut can appear later, making per-round dedup globally correct.
    """
    readers = [_RunReader(p, block_keys) for p in paths]
    readers = [r for r in readers if r.block.size]
    while readers:
        cut = min(np.int64(r.block[-1]) for r in readers)
        parts = [r.take_upto(cut) for r in readers]
        merged = sorted_unique(np.concatenate(parts))
        if merged.size:
            yield merged
        readers = [r for r in readers if r.block.size]


def canonicalize_edges_external(
    chunks: Iterable[np.ndarray],
    *,
    max_chunk_edges: int,
    spill_dir: str | os.PathLike | None = None,
    dtype=np.int32,
    stats_out: ExternalSortStats | None = None,
) -> np.ndarray:
    """Canonicalize a stream of raw edge blocks under a bounded key buffer.

    ``chunks`` yields raw ``(r, 2)`` integer blocks (any mix of
    directions, duplicates, self loops).  In-memory key buffers are
    spilled as sorted runs whenever they exceed ``max_chunk_edges`` keys;
    the runs are merged back into the canonical edge array — the same
    rows, in the same order, as ``canonicalize_edges`` on the
    concatenated input.  ``spill_dir`` (a private temp dir by default)
    holds the runs and is cleaned up afterwards.
    """
    if max_chunk_edges < 1:
        raise ValueError("max_chunk_edges must be positive")
    stats = stats_out if stats_out is not None else ExternalSortStats()

    own_tmp = None
    if spill_dir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="tricsr-runs-")
        spill_dir = own_tmp.name
    os.makedirs(spill_dir, exist_ok=True)

    run_paths: list[str] = []
    buffer: list[np.ndarray] = []
    buffered = 0

    def spill() -> None:
        nonlocal buffer, buffered
        if not buffered:
            return
        keys = sorted_unique(np.concatenate(buffer)) if len(buffer) > 1 else buffer[0]
        path = os.path.join(spill_dir, f"run-{len(run_paths):05d}.u64")
        keys.tofile(path)
        run_paths.append(path)
        stats.spill_runs += 1
        stats.spilled_keys += keys.size
        buffer, buffered = [], 0

    try:
        for chunk in chunks:
            chunk = np.asarray(chunk)
            stats.raw_edges += chunk.reshape(-1, 2).shape[0]
            keys = pack_unique_keys(chunk)
            stats.kept_edges += keys.size
            if keys.size == 0:
                continue
            buffer.append(keys)
            buffered += keys.size
            if buffered > max_chunk_edges:
                spill()

        if not run_paths:
            # everything fit: pure in-memory finish, no disk round-trip
            if not buffer:
                key = np.empty((0,), np.int64)
            else:
                key = sorted_unique(np.concatenate(buffer)) if len(buffer) > 1 else buffer[0]
            stats.unique_edges = key.size
            return unpack_keys_canonical(key, dtype)

        spill()  # flush the tail so the merge sees every key
        stats.merge_passes = 1
        block_keys = max(1024, max_chunk_edges // max(len(run_paths), 1))
        merged = list(merge_sorted_runs(run_paths, block_keys=block_keys))
        key = np.concatenate(merged) if merged else np.empty((0,), np.int64)
        stats.unique_edges = key.size
        return unpack_keys_canonical(key, dtype)
    finally:
        for p in run_paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        if own_tmp is not None:
            own_tmp.cleanup()
