"""Kernel tile autotuner — the paper's §III-D5 grid search, persisted.

The paper tunes its CUDA kernel by sweeping threads-per-edge warp sizes
per graph and keeping the fastest.  In the port that knob is the CSR
kernel's own (``kernels/triangle_count/csrc/intersect_csr.cu``, which
every ``pallas`` workload runs): lanes per row G ∈ {8, 16, 32} — the
paper's threads per edge — and rows (query edges) per block.
:func:`autotune_tiles` times every admissible pair on a synthetic CSR of
the *shape* being tuned (shapes, not data, determine kernel runtime) and
keeps the argmin, and :class:`TileCache` persists the winners in a
versioned on-disk JSON so the sweep is paid once per shape per machine.

:class:`TileConfig` keeps the reference's names and JSON format
(``{"version", "backend", "entries": {key: {"block_edges", "tlv",
"us"}}}``).  In the port ``block_edges`` is the CSR kernel's rows per
block and ``tlv`` its lanes per row; ``TileConfig.tiles`` is the
``tiles=(rows_per_block, lanes)`` the CSR wrappers take.

Shapes are keyed as the reference keys them: the chunk's rows rounded up
to a power of two and its bucket width twice
(``shape_key(len(chunk.u), width, width)``), so a handful of entries
covers every chunk the engine launches.

::

    tuner = AutoTuner(cache_path="tiles.json", tune_on_miss=True)  # on the card
    tc = TriangleCounter(method="pallas", tuner=tuner)
    tc.count(edges)        # cold: sweeps + writes cache; warm: cache hits

The cache file carries a format version and a backend tag that names the
package and the device it was measured on (``"repro_torch:cuda:<card
name>"``, ``"repro_torch:cpu"``); a mismatch on either discards it, so a
cache written by the JAX package (whose tag is ``jax.default_backend()``)
or on another card never steers this one.  Writes are atomic
read-merge-writes under a file lock.

On a CPU device the CSR wrappers run their plain versions, which ignore
the knob: the sweep still runs (and times the plain version), so the
cache logic is the same on both devices.  On the card the timings are CUDA
events on the current stream; kernels that other threads put on the card
meanwhile (a service's other lanes) are inside them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.distributed.compression import ensure_fits_int32
from repro_torch.kernels.triangle_count.triangle_count import (
    CSR_LANES,
    CSR_MAX_SMEM,
    CSR_MAX_THREADS,
    csr_default_tiles,
    csr_smem_bytes,
)

from .engine import next_pow2

__all__ = [
    "TileConfig",
    "TileCache",
    "AutoTuner",
    "candidate_tiles",
    "autotune_tiles",
    "measure_tiles",
    "shape_key",
    "backend_tag",
    "CACHE_VERSION",
]

CACHE_VERSION = 1

# shared memory one block of a candidate may take (bytes): the CSR
# kernel's own ceiling, 227 KB on Hopper — a pick above it cannot launch
_SMEM_BUDGET = CSR_MAX_SMEM

_ROWS_LADDER = (1, 2, 4, 8, 16, 32, 64, 128)

# nodes whose lists the synthetic rows draw from, at most
_POOL = 4096


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One (rows per block, lanes per row) pick, plus the time that earned it."""

    block_edges: int
    tlv: int
    us: float = 0.0  # measured µs per call (0 when untimed/heuristic)

    @property
    def tiles(self) -> tuple[int, int]:
        """The kwarg form the kernels accept (``tiles=cfg.tiles``)."""
        return (self.block_edges, self.tlv)


def shape_key(n_edges: int, lu: int, lv: int) -> str:
    """Cache key: pow2-bucketed edge count × the exact list widths."""
    return f"B{next_pow2(max(int(n_edges), 1))}xLu{int(lu)}xLv{int(lv)}"


def backend_tag(device) -> str:
    """The cache's backend tag for ``device``: the package and the card's
    name, so no other package's or card's cache is read as this one's."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"repro_torch:cuda:{torch.cuda.get_device_name(dev)}"
    return "repro_torch:cpu"


def candidate_tiles(n_edges: int, lu: int, lv: int) -> list[TileConfig]:
    """The §III-D5 sweep grid for one bucket shape.

    Every (rows per block, lanes per row) with lanes in ``CSR_LANES``, a
    block of whole warps up to ``CSR_MAX_THREADS`` threads and at most
    one warp's worth of rows past the pow2 bucket, whose shared memory
    fits ``_SMEM_BUDGET``; the kernel's default pick is always included so
    tuning can never do worse than not tuning.
    """
    cap = next_pow2(max(int(n_edges), 1))
    width = max(int(lu), int(lv), 1)
    seen: dict[tuple[int, int], None] = {}
    for lanes in CSR_LANES:
        for rows in _ROWS_LADDER:
            threads = rows * lanes
            if threads % 32 or threads > CSR_MAX_THREADS:
                continue
            if rows > cap and threads > 32:
                continue
            if csr_smem_bytes(rows, width) <= _SMEM_BUDGET:
                seen[(rows, lanes)] = None
    seen[csr_default_tiles(width)] = None
    return [TileConfig(rows, lanes) for rows, lanes in seen]


def _synthetic_csr(rng: np.random.Generator, b: int, width: int):
    """``(row_offsets, col, u, v)`` host int32 arrays: ``b`` query rows over
    a pool of at most ``_POOL`` nodes whose sorted lists are about half
    full of the width (``width // 2`` to ``width`` entries, the typical
    bucket), built without a per-row loop."""
    n = max(2, min(_POOL, b, (1 << 24) // width))
    if width > 1:
        deg = rng.integers(width // 2, width + 1, size=n)
    else:
        deg = np.ones(n, np.int64)
    # gaps of 1..7 between neighbours: sorted, distinct, density ~1/4
    vals = np.cumsum(rng.integers(1, 8, size=(n, width)), axis=1)
    ensure_fits_int32(max(int(vals[:, -1].max()), int(deg.sum(dtype=np.int64))),
                      "synthetic CSR ids and offsets")
    col = vals[np.arange(width)[None, :] < deg[:, None]].astype(np.int32)
    row_offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    u = rng.integers(0, n, size=b).astype(np.int32)
    v = rng.integers(0, n, size=b).astype(np.int32)
    return row_offsets, col, u, v


def _median_us(call, iters: int, warmup: int, dev: torch.device) -> float:
    """Median µs of one ``call()``: CUDA events on the card, the host clock
    on the CPU."""
    for _ in range(warmup):
        call()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(max(iters, 1)):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) * 1e3)
    else:
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def measure_tiles(
    n_edges: int,
    lu: int,
    lv: int,
    tiles,
    *,
    iters: int = 2,
    warmup: int = 1,
    seed: int = 0,
    device=None,
) -> list[TileConfig]:
    """Time the count CSR kernel under each pick of ``tiles`` (pairs or
    :class:`TileConfig`) on one synthetic CSR of the bucket shape (rows
    rounded up to a power of two, lists cut to the width); returns the
    picks with their median µs, in order.  Each call launches the kernel
    ``warmup + iters`` times per pick."""
    from repro_torch.kernels.triangle_count import ops

    dev = resolve_device(device)
    b = next_pow2(max(int(n_edges), 1))
    width = max(int(lu), int(lv), 1)
    ro, col, u, v = (torch.from_numpy(x).to(dev)
                     for x in _synthetic_csr(np.random.default_rng(seed), b, width))
    out = []
    for pick in tiles:
        cfg = pick if isinstance(pick, TileConfig) else TileConfig(*pick)
        us = _median_us(lambda: ops.intersect_count_csr(ro, col, u, v, width, tiles=cfg.tiles),
                        iters, warmup, dev)
        out.append(dataclasses.replace(cfg, us=us))
    return out


def autotune_tiles(
    n_edges: int,
    lu: int,
    lv: int,
    *,
    iters: int = 2,
    warmup: int = 1,
    seed: int = 0,
    device=None,
) -> TileConfig:
    """Grid-search the CSR kernel's tiles for one pow2 bucket shape.

    Times the count CSR kernel (the cheapest mode — the knob is shared by
    all three) under every :func:`candidate_tiles` pick on a synthetic
    CSR and returns the fastest.  The measured shape uses the
    pow2-bucketed edge count, so the result is valid for every chunk that
    maps to the same cache key.
    """
    cands = candidate_tiles(next_pow2(max(int(n_edges), 1)), lu, lv)
    timed = measure_tiles(n_edges, lu, lv, cands, iters=iters, warmup=warmup, seed=seed,
                          device=device)
    return min(timed, key=lambda c: c.us)


@contextlib.contextmanager
def _cache_write_lock(path: str):
    """Advisory exclusive lock serializing read-merge-write cycles.

    ``fcntl.flock`` on a ``.lock`` sidecar where available (POSIX); on
    platforms without it the merge still runs — the window shrinks to
    the read→replace gap instead of disappearing, and the write itself
    stays atomic either way.
    """
    try:
        import fcntl
    except ImportError:  # non-POSIX: atomic replace only
        yield
        return
    fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


class TileCache:
    """Versioned on-disk store of per-shape tile picks.

    The JSON payload is ``{"version", "backend", "entries": {key: {...}}}``;
    loading discards the file on a version or backend-tag mismatch
    (:func:`backend_tag` of ``device``, ``None``: the card), so a cache
    tuned by the JAX package, on another card or on the CPU never steers
    this run.

    Safe for **concurrent use**: two engines tuning different shapes into
    the same cache file cannot lose each other's entries — :meth:`save` is
    an atomic read-merge-write (under an advisory file lock where the
    platform has one) with last-writer-wins per *key*, not per file.
    """

    def __init__(self, path: str | os.PathLike | None = None, *, device=None):
        self.path = os.fspath(path) if path is not None else None
        self.backend = backend_tag(device)
        self.entries: dict[str, TileConfig] = {}
        self.loaded_from_disk = False
        if self.path is not None and os.path.exists(self.path):
            self.entries = self._read_disk_entries()
            self.loaded_from_disk = bool(self.entries)

    def _read_disk_entries(self) -> dict[str, TileConfig]:
        """Current on-disk entries; {} on missing/corrupt/mismatched file."""
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}
        if (
            not isinstance(payload, dict)
            or payload.get("version") != CACHE_VERSION
            or payload.get("backend") != self.backend
        ):
            return {}
        out: dict[str, TileConfig] = {}
        for key, ent in payload.get("entries", {}).items():
            try:
                out[key] = TileConfig(
                    int(ent["block_edges"]), int(ent["tlv"]), float(ent.get("us", 0.0))
                )
            except (KeyError, TypeError, ValueError):
                continue
        return out

    def get(self, key: str) -> TileConfig | None:
        return self.entries.get(key)

    def put(self, key: str, cfg: TileConfig) -> None:
        self.entries[key] = cfg

    def save(self) -> None:
        """Atomic read-merge-write: disk entries ∪ ours, ours win per key."""
        if self.path is None:
            return
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with _cache_write_lock(self.path):
            merged = {**self._read_disk_entries(), **self.entries}
            payload = {
                "version": CACHE_VERSION,
                "backend": self.backend,
                "entries": {
                    k: {"block_edges": c.block_edges, "tlv": c.tlv, "us": c.us}
                    for k, c in sorted(merged.items())
                },
            }
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.entries = merged


class AutoTuner:
    """Policy layer the engine's pallas backend consults per chunk shape.

    ``tune_on_miss=True`` runs the grid search (and persists it) the
    first time a shape is seen; ``False`` only serves already-cached
    picks and leaves unknown shapes to the kernel's default pick — the
    safe default for latency-sensitive callers.  ``device`` (``None``: the
    card) is where the search runs and what the cache's tag names.

    One tuner may serve several threads (a service's lanes): lookups and
    tuning run under a lock, so a shape missed by two lanes at once is
    tuned once and the hit and tuning counts add up.
    """

    def __init__(
        self,
        cache_path: str | os.PathLike | None = None,
        *,
        tune_on_miss: bool = False,
        iters: int = 2,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cache = TileCache(cache_path, device=self.device)
        self.tune_on_miss = tune_on_miss
        self.iters = iters
        self.seed = seed
        self.n_hits = 0
        self.n_tuned = 0
        self._lock = threading.Lock()

    def tiles(self, n_edges: int, lu: int, lv: int) -> tuple[int, int] | None:
        """The (rows per block, lanes per row) pick for a shape, or None →
        the kernel's default."""
        key = shape_key(n_edges, lu, lv)
        with self._lock:
            cfg = self.cache.get(key)
            if cfg is not None:
                self.n_hits += 1
                obs.counter("tiles.cache_hits").add()
                return cfg.tiles
            obs.counter("tiles.cache_misses").add()
            if not self.tune_on_miss:
                return None
            cfg = autotune_tiles(n_edges, lu, lv, iters=self.iters, seed=self.seed,
                                 device=self.device)
            self.cache.put(key, cfg)
            self.cache.save()
            self.n_tuned += 1
            obs.counter("tiles.tuned").add()
            return cfg.tiles
