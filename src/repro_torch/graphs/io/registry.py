"""Named datasets: the paper's Table I graphs, with offline fallbacks.

Each :class:`Dataset` names an on-disk edge list by URL (SNAP / DIMACS10
mirrors), its published size and — where the literature has it — the
exact triangle count, which the launchers use as an oracle when counting
the real download.  Because CI runs offline, every entry also carries a
**deterministic fallback**: a seeded generator from
:mod:`repro_torch.graphs.generators` of matching scale (Kronecker/R-MAT for the
power-law graphs) whose edge list is *written to disk and ingested
through the real parser/cache pipeline*, so the out-of-core path is
exercised even when no network exists.

Downloads never happen implicitly: ``materialize_dataset`` only fetches
when ``allow_download=True`` (the CLI flag ``--download``) or the
``REPRO_ALLOW_DOWNLOAD=1`` environment variable is set.  Checksums are
verified when pinned; unpinned downloads record a trust-on-first-use
``.sha256`` sidecar next to the source file and verify against it on any
re-download.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable

import numpy as np

from ..generators import GRAPH_GENERATORS
from .cache import CSRGraph
from .ingest import IngestStats, ingest
from .parsers import DEFAULT_CHUNK_EDGES

__all__ = [
    "Dataset",
    "DATASETS",
    "get_dataset",
    "materialize_dataset",
    "resolve_to_csr",
    "karate_edges",
]


# Zachary's karate club (the classic 34-node, 78-edge, 45-triangle
# benchmark): bundled inline so ``--dataset karate`` works anywhere,
# and mirrored as the CI fixture tests/data/karate.txt.
_KARATE_EDGES = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8),
    (0, 10), (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31),
    (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30),
    (2, 3), (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32),
    (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16),
    (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32),
    (14, 33), (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32),
    (20, 33), (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32),
    (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33),
    (27, 33), (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33),
    (31, 32), (31, 33), (32, 33),
)


def karate_edges(**_ignored) -> np.ndarray:
    """The exact karate-club edge list (one direction per edge)."""
    return np.asarray(_KARATE_EDGES, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class Dataset:
    """One named graph: where to get it, what it should look like."""

    name: str
    description: str
    url: str | None                  # None = fallback-only (format we don't parse)
    sha256: str | None               # pinned checksum; None = trust-on-first-use
    fmt: str = "text"                # parser format of the downloaded file
    n_nodes: int | None = None       # published size, for post-ingest sanity
    n_edges: int | None = None       # published undirected edge count
    triangles: int | None = None     # published exact count (oracle), if known
    fallback: tuple[str, dict] | None = None  # (generator, kwargs) for offline


def _kron(scale: int, edge_factor: int = 16) -> tuple[str, dict]:
    return ("kronecker", dict(scale=scale, edge_factor=edge_factor, seed=1503))


_SNAP = "https://snap.stanford.edu/data"

DATASETS: dict[str, Dataset] = {
    d.name: d
    for d in [
        Dataset(
            name="karate",
            description="Zachary's karate club — 34 nodes, 78 edges, 45 triangles",
            url=None, sha256=None,
            n_nodes=34, n_edges=78, triangles=45,
            fallback=("karate", {}),
        ),
        Dataset(
            name="com-amazon",
            description="SNAP com-Amazon co-purchase network",
            url=f"{_SNAP}/bigdata/communities/com-amazon.ungraph.txt.gz",
            sha256=None, n_nodes=334_863, n_edges=925_872, triangles=667_129,
            fallback=_kron(16, 4),
        ),
        Dataset(
            name="com-dblp",
            description="SNAP com-DBLP collaboration network",
            url=f"{_SNAP}/bigdata/communities/com-dblp.ungraph.txt.gz",
            sha256=None, n_nodes=317_080, n_edges=1_049_866, triangles=2_224_385,
            fallback=_kron(16, 4),
        ),
        Dataset(
            name="com-youtube",
            description="SNAP com-Youtube social network",
            url=f"{_SNAP}/bigdata/communities/com-youtube.ungraph.txt.gz",
            sha256=None, n_nodes=1_134_890, n_edges=2_987_624, triangles=3_056_386,
            fallback=_kron(17, 4),
        ),
        Dataset(
            name="roadnet-ca",
            description="SNAP roadNet-CA — California road network (low skew)",
            url=f"{_SNAP}/roadNet-CA.txt.gz",
            sha256=None, n_nodes=1_965_206, n_edges=2_766_607, triangles=120_676,
            fallback=("watts_strogatz", dict(n=1 << 17, k=4, beta=0.05, seed=1503)),
        ),
        Dataset(
            name="soc-livejournal",
            description="SNAP soc-LiveJournal1 — the paper-scale 69M-edge graph",
            url=f"{_SNAP}/soc-LiveJournal1.txt.gz",
            sha256=None, n_nodes=4_847_571, n_edges=68_993_773,
            triangles=285_730_264,
            fallback=_kron(21, 16),
        ),
        Dataset(
            name="com-orkut",
            description="SNAP com-Orkut — 117M edges, 627M triangles",
            url=f"{_SNAP}/bigdata/communities/com-orkut.ungraph.txt.gz",
            sha256=None, n_nodes=3_072_441, n_edges=117_185_083,
            triangles=627_584_181,
            fallback=_kron(21, 28),
        ),
        Dataset(
            name="kron-logn21",
            description="DIMACS10 kron_g500-simple-logn21 — the paper's "
                        "89M-edge, 3.8B-triangle headline graph (Table I); "
                        "METIS source format, so offline Kronecker fallback only",
            url=None, sha256=None,
            n_nodes=1 << 21, n_edges=91_040_932, triangles=3_815_224_577,
            fallback=_kron(21, 43),
        ),
    ]
}


def get_dataset(name: str) -> Dataset:
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(
            f"unknown dataset {name!r}; known: {sorted(DATASETS)}"
        ) from None


def _fallback_generator(spec: tuple[str, dict]) -> Callable[[], np.ndarray]:
    gen_name, kwargs = spec
    if gen_name == "karate":
        return karate_edges
    gen = GRAPH_GENERATORS[gen_name]
    return lambda: gen(**kwargs)


def _apply_scale(spec: tuple[str, dict], scale: int | None) -> tuple[str, dict]:
    """Shrink a fallback spec to ``2**scale`` nodes (CI sizing).

    Kronecker takes the scale directly; size-parameterized generators
    (watts_strogatz, barabasi_albert, erdos_renyi) get ``n`` capped at
    ``2**scale``.  The exact built-in graphs (karate) are already tiny
    and ignore it.
    """
    if scale is None:
        return spec
    name, kwargs = spec
    if name == "kronecker":
        return (name, {**kwargs, "scale": scale})
    if "n" in kwargs:
        shrunk = {**kwargs, "n": min(kwargs["n"], 1 << scale)}
        if "m" in kwargs:
            shrunk["m"] = min(kwargs["m"], 8 << scale)
        return (name, shrunk)
    return spec


def _write_fallback_edge_list(ds: Dataset, path: str, scale_override: int | None) -> None:
    """Generate the fallback graph and write it as a SNAP-style text file.

    The write is chunked (~64k lines per ''.join) so formatting a
    paper-scale fallback doesn't go through a per-row Python loop.
    """
    spec = ds.fallback
    if spec is None:
        raise RuntimeError(f"dataset {ds.name!r} has no offline fallback")
    spec = _apply_scale(spec, scale_override)
    edges = np.asarray(_fallback_generator(spec)())
    # one direction per undirected edge, the way SNAP ships its files
    one_dir = edges[edges[:, 0] < edges[:, 1]] if _is_canonical(edges) else edges
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="ascii") as fh:
        fh.write(f"# {ds.name}: deterministic offline fallback "
                 f"({spec[0]} {spec[1]})\n")
        fh.write("# FromNodeId\tToNodeId\n")
        for s in range(0, one_dir.shape[0], 1 << 16):
            block = one_dir[s : s + (1 << 16)]
            fh.write("\n".join(f"{u}\t{v}" for u, v in block.tolist()))
            fh.write("\n")
    os.replace(tmp, path)


def _is_canonical(edges: np.ndarray) -> bool:
    """Heuristic: generators emit both directions; raw lists emit one."""
    if edges.shape[0] % 2 != 0 or edges.shape[0] == 0:
        return False
    return bool((edges[:, 0] < edges[:, 1]).sum() * 2 == edges.shape[0])


def _download(ds: Dataset, dest: str) -> None:
    import urllib.request

    tmp = dest + ".part"
    with urllib.request.urlopen(ds.url, timeout=120) as resp, open(tmp, "wb") as out:
        h = hashlib.sha256()
        while True:
            block = resp.read(1 << 20)
            if not block:
                break
            h.update(block)
            out.write(block)
    digest = h.hexdigest()
    sidecar = dest + ".sha256"
    pinned = ds.sha256
    if pinned is None and os.path.exists(sidecar):
        with open(sidecar) as fh:
            pinned = fh.read().strip() or None
    if pinned is not None and digest != pinned:
        os.unlink(tmp)
        raise RuntimeError(
            f"checksum mismatch for {ds.name}: got {digest}, expected {pinned}"
        )
    with open(sidecar, "w") as fh:
        fh.write(digest + "\n")
    os.replace(tmp, dest)


def resolve_to_csr(
    source: str,
    cache_dir: str | os.PathLike,
    *,
    max_chunk_edges: int = DEFAULT_CHUNK_EDGES,
    fallback_scale: int | None = None,
    allow_download: bool | None = None,
    mmap: bool = True,
    storage: str = "flat",
    order: str = "natural",
) -> tuple[CSRGraph, dict]:
    """Resolve a *source spec* — dataset name or file path — to a CSR.

    The serving layer's graph manager admits graphs by a single string:
    a registry dataset name goes through :func:`materialize_dataset`
    (download / offline fallback / ``.tricsr`` cache hit), anything else
    is treated as an on-disk edge list and goes through
    :func:`~repro_torch.graphs.io.ingest.ingest`.  Returns ``(csr, info)``
    where ``info`` is a JSON-ready provenance dict (the shape the CLIs'
    ``--json`` reports already use: ``source``, ``ingest`` stats, and
    ``expected_triangles`` when the registry pins an oracle).
    """
    if source in DATASETS:
        csr, stats, ds = materialize_dataset(
            source, cache_dir, allow_download=allow_download,
            max_chunk_edges=max_chunk_edges, fallback_scale=fallback_scale,
            mmap=mmap, storage=storage, order=order,
        )
        real = stats.source_kind == "download" or ds.name == "karate"
        info = dict(
            source="dataset", dataset=ds.name, ingest=stats.as_dict(),
            expected_triangles=ds.triangles if real else None,
        )
        return csr, info
    csr, stats = ingest(
        source, cache_dir=cache_dir, max_chunk_edges=max_chunk_edges, mmap=mmap,
        storage=storage, order=order,
    )
    return csr, dict(
        source="input", path=os.fspath(source), ingest=stats.as_dict(),
        expected_triangles=None,
    )


def materialize_dataset(
    name: str,
    cache_dir: str | os.PathLike,
    *,
    allow_download: bool | None = None,
    max_chunk_edges: int = DEFAULT_CHUNK_EDGES,
    fallback_scale: int | None = None,
    mmap: bool = True,
    storage: str = "flat",
    order: str = "natural",
) -> tuple[CSRGraph, IngestStats, Dataset]:
    """Resolve ``name`` to a ready-to-count CSR through the cache.

    Resolution order: existing ``.tricsr`` cache → previously fetched (or
    generated) source file under ``cache_dir/sources/`` → network download
    (only when allowed) → deterministic offline fallback generator.
    ``fallback_scale`` shrinks a Kronecker fallback for CI
    (e.g. ``fallback_scale=10`` turns the 2²¹-node stand-in into 2¹⁰).
    """
    ds = get_dataset(name)
    cache_dir = os.path.expanduser(os.fspath(cache_dir))
    if allow_download and fallback_scale is not None:
        # contradictory request: a shrunk fallback is synthetic by
        # definition — never let it masquerade as the real download.
        # (The ambient REPRO_ALLOW_DOWNLOAD=1 env var is deliberately
        # weaker: with fallback_scale set it defers to the fallback, so a
        # CI matrix can export it once and still size stand-ins.)
        raise ValueError(
            "allow_download and fallback_scale are mutually exclusive: "
            "fallback_scale sizes the synthetic stand-in, downloads fetch "
            "the real graph"
        )
    if allow_download and ds.url is None:
        raise ValueError(
            f"dataset {ds.name!r} has no downloadable source "
            f"({ds.description.split(';')[0]}); drop the download request "
            "to use its deterministic fallback"
        )
    if allow_download is None:
        allow_download = os.environ.get("REPRO_ALLOW_DOWNLOAD", "") == "1"
    src_dir = os.path.join(cache_dir, "sources")
    os.makedirs(src_dir, exist_ok=True)

    real_src = (os.path.join(src_dir, os.path.basename(ds.url))
                if ds.url is not None else None)
    suffix = f"-s{fallback_scale}" if fallback_scale is not None else ""
    fb_src = os.path.join(src_dir, f"{ds.name}-fallback{suffix}.txt")

    if real_src is not None and os.path.exists(real_src) and fallback_scale is None:
        src, kind = real_src, "download"
    elif real_src is not None and allow_download and fallback_scale is None:
        # an explicit download request beats any stale offline fallback —
        # otherwise one offline run would pin the synthetic graph forever
        _download(ds, real_src)
        src, kind = real_src, "download"
    elif os.path.exists(fb_src):
        src, kind = fb_src, "fallback"
    else:
        _write_fallback_edge_list(ds, fb_src, fallback_scale)
        src, kind = fb_src, "fallback"

    csr, stats = ingest(
        src, cache_dir=cache_dir, max_chunk_edges=max_chunk_edges,
        fmt=ds.fmt, mmap=mmap, storage=storage, order=order,
    )
    stats.source_kind = kind
    if kind == "fallback" and ds.fallback is not None and ds.fallback[0] == "karate":
        # the only fallback with a known exact graph — enforce it
        assert csr.n_edges == 78, f"karate fallback produced {csr.n_edges} edges"
    return csr, stats, ds
