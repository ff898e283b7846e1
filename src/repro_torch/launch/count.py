"""Triangle-counting launcher of the port — the paper's Table I as a CLI.

::

    python -m repro_torch.launch.count --generator kronecker --scale 21 \\
        --seed 1503 --max-wedge-chunk 67108864 --json          # on the card
    python -m repro_torch.launch.count --scale 14 --method panel
    python -m repro_torch.launch.count --input tests/data/karate.txt --json
    python -m repro_torch.launch.count --input tests/data/karate.txt --device cpu
    python -m repro_torch.launch.count --scale 12 --distributed             # §III-E stripes

All counting routes through :class:`repro_torch.core.TriangleCounter` on
``--device`` (default ``cuda``; without a card the CLI raises unless it
is given ``--device cpu``), with ``auto`` dispatch as the front door
(override with ``--method``);
``--max-wedge-chunk`` bounds the device wedge buffer (memory-bounded edge
partitioning) and ``--max-chunk-edges`` bounds host memory during
parsing/canonicalization.  ``--json`` prints one machine-readable object
on stdout (count, schedule, engine stats, ingest provenance, timings) and
moves the human-readable progress lines to stderr — benchmarks and CI
smokes should consume that instead of scraping text.  ``--distributed``
runs the §III-E striped schedule over a mesh of the visible devices of
``--device`` (one stripe a card; the CPU is one device).
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core import TriangleCounter, count_triangles_numpy
from repro_torch.core.engine import METHODS
from repro_torch.graphs import GRAPH_GENERATORS, graph_stats
from repro_torch.graphs.io import DATASETS, ingest, materialize_dataset


def mesh_from_args(args, log):
    """The CLI's mesh for ``--method distributed`` (None otherwise), logged."""
    if args.method != "distributed":
        return None
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(device=args.device)
    log(f"mesh: {mesh.size} stripe(s) on {len(mesh.distinct)} device(s), "
        f"axes {mesh.shape}")
    return mesh


def add_trace_argument(ap: argparse.ArgumentParser) -> None:
    """The shared ``--trace`` flag (count / analyze / serve_graph)."""
    ap.add_argument("--trace", default=None, metavar="OUT",
                    help="export a repro_torch.obs trace of the whole run: "
                         "Chrome trace-event JSON (open in Perfetto / "
                         "chrome://tracing), or a structured JSONL event "
                         "log if OUT ends in .jsonl")


def build_graph(args) -> np.ndarray:
    gen = GRAPH_GENERATORS[args.generator]
    if args.generator == "kronecker":
        return gen(args.scale, edge_factor=args.edge_factor, seed=args.seed)
    if args.generator == "barabasi_albert":
        return gen(args.n, args.m_attach, seed=args.seed)
    if args.generator == "watts_strogatz":
        return gen(args.n, args.k, args.beta, seed=args.seed)
    return gen(args.n, args.m, seed=args.seed)


def add_source_arguments(ap: argparse.ArgumentParser) -> None:
    """Graph-source flags shared by count.py and serve_graph.py."""
    ap.add_argument("--input", default=None, metavar="FILE",
                    help="on-disk edge list (SNAP text / MatrixMarket, "
                         "optionally .gz) ingested via the out-of-core path")
    ap.add_argument("--dataset", default=None, choices=sorted(DATASETS),
                    help="named dataset from the registry (paper Table I "
                         "graphs); offline falls back to a deterministic "
                         "generator of matching scale")
    ap.add_argument("--cache-dir", default=".tricsr-cache",
                    help="directory for .tricsr binary CSR caches and "
                         "downloaded/generated dataset sources "
                         "(default: %(default)s)")
    ap.add_argument("--max-chunk-edges", type=int, default=None,
                    help="host-memory bound for parsing/canonicalization, "
                         "in raw edges per chunk (default: 4M)")
    ap.add_argument("--storage", default="flat", choices=("flat", "compressed"),
                    help="cache format: flat .tricsr mmap, or compressed "
                         ".tricsrz delta/varint neighbor blocks decoded "
                         "chunk-wise into the engine (default: %(default)s)")
    ap.add_argument("--order", default=None, choices=("natural", "degree", "bfs"),
                    help="node relabeling baked into a compressed cache for "
                         "reference locality (default: degree when "
                         "--storage compressed; requires --storage compressed)")
    ap.add_argument("--download", action="store_true",
                    help="allow fetching --dataset sources from the network "
                         "(also enabled by REPRO_ALLOW_DOWNLOAD=1)")
    ap.add_argument("--fallback-scale", type=int, default=None,
                    help="shrink a dataset's Kronecker fallback to this "
                         "scale (offline CI sizing)")
    ap.add_argument("--generator", choices=sorted(GRAPH_GENERATORS), default="kronecker")
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=1_000_000)
    ap.add_argument("--m-attach", type=int, default=8)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--beta", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)


def resolve_graph(args, log=print):
    """Resolve the CLI's graph source to ``(graph, source_info)``.

    ``graph`` is a canonical edge array (generators) or a cached/ingested
    ``CSRGraph`` (``--input`` / ``--dataset``) — both are accepted
    directly by :class:`repro_torch.core.TriangleCounter`.  ``source_info`` is a
    JSON-ready provenance dict (ingest stats, cache hit, expected count).
    """
    if args.input is not None and args.dataset is not None:
        raise SystemExit("--input and --dataset are mutually exclusive")
    storage = getattr(args, "storage", "flat")
    order = getattr(args, "order", None)
    if order is not None and storage != "compressed":
        raise SystemExit("--order requires --storage compressed (the flat "
                         ".tricsr cannot record the inverse permutation)")
    if order is None:
        order = "degree" if storage == "compressed" else "natural"
    if storage != "flat" and args.input is None and args.dataset is None:
        raise SystemExit("--storage/--order shape the on-disk cache and "
                         "need an --input or --dataset source (generators "
                         "never touch the cache)")
    kwargs = {}
    if storage != "flat":
        kwargs["storage"] = storage
        kwargs["order"] = order
    if args.max_chunk_edges is not None:
        if args.max_chunk_edges < 1:
            raise SystemExit("--max-chunk-edges must be positive")
        kwargs["max_chunk_edges"] = args.max_chunk_edges
    t0 = time.time()
    if args.input is not None:
        try:
            csr, stats = ingest(args.input, cache_dir=args.cache_dir, **kwargs)
        except (FileNotFoundError, ValueError) as e:
            # missing file, unknown format, malformed line, corrupt cache —
            # all user-input problems, all exit cleanly
            raise SystemExit(f"--input: {e}") from None
        info = dict(source="input", ingest=stats.as_dict(), expected_triangles=None)
    elif args.dataset is not None:
        try:
            csr, stats, ds = materialize_dataset(
                args.dataset, args.cache_dir,
                allow_download=True if args.download else None,
                fallback_scale=args.fallback_scale, **kwargs,
            )
        except (ValueError, RuntimeError, OSError) as e:
            # registry misuse, checksum mismatch, network failure — all
            # actionable user-facing conditions, all exit cleanly
            raise SystemExit(f"--dataset: {e}") from None
        # fallback graphs have their own counts; only the real download
        # (or the exact built-in karate graph) honors the published oracle
        real = stats.source_kind == "download" or ds.name == "karate"
        info = dict(
            source="dataset", dataset=ds.name, ingest=stats.as_dict(),
            expected_triangles=ds.triangles if real else None,
        )
    else:
        edges = build_graph(args)
        info = dict(source="generator", generator=args.generator,
                    ingest=None, expected_triangles=None)
        st = graph_stats(edges)
        log(f"graph: {st['n_nodes']} nodes, {st['n_edges']} edges, "
            f"max deg {st['max_degree']}, skew {st['skew']:.1f} "
            f"(built in {time.time()-t0:.2f}s)")
        info["graph"] = st
        return edges, info
    st = csr.stats()
    hit = "cache hit" if stats.cache_hit else (
        f"parsed {stats.raw_edges} raw edges, {stats.spill_runs} spill run(s)")
    log(f"graph: {st['n_nodes']} nodes, {st['n_edges']} edges, "
        f"max deg {st['max_degree']}, skew {st['skew']:.1f} "
        f"({hit}, ready in {time.time()-t0:.2f}s)")
    info["graph"] = st
    return csr, info


def main() -> None:
    ap = argparse.ArgumentParser()
    add_source_arguments(ap)
    ap.add_argument("--method", default=None, choices=list(METHODS),
                    help="counting schedule (default: auto dispatch)")
    ap.add_argument("--max-wedge-chunk", type=int, default=None,
                    help="wedge-buffer budget per launch (slots); enables "
                         "memory-bounded edge partitioning")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs (default: %(default)s; "
                         "raises when no card is visible)")
    ap.add_argument("--tile-cache", default=None, metavar="FILE",
                    help="versioned tile-autotune cache (JSON) steering the "
                         "pallas CSR kernels' rows per block and lanes per row")
    ap.add_argument("--autotune", action="store_true",
                    help="grid-search tiles for shapes missing from "
                         "--tile-cache (paper §III-D5 sweep) and persist "
                         "the winners")
    ap.add_argument("--baseline", action="store_true", help="also run NumPy CPU baseline")
    ap.add_argument("--distributed", action="store_true", help="shard over local devices")
    ap.add_argument("--clustering", action="store_true",
                    help="deprecated spelling of --transitivity")
    ap.add_argument("--transitivity", action="store_true",
                    help="also report the transitivity ratio (derived from "
                         "the count and wedge total already in hand — free)")
    ap.add_argument("--clustering-summary", action="store_true",
                    help="also report average clustering + the degree-binned "
                         "clustering profile (one extra per-node pass over "
                         "the same CSR; no second ingest/preprocess)")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable JSON object on stdout "
                         "(progress lines go to stderr)")
    add_trace_argument(ap)
    args = ap.parse_args()
    if args.max_wedge_chunk is not None and args.max_wedge_chunk < 1:
        ap.error("--max-wedge-chunk must be a positive number of wedge slots")
    if args.distributed:
        if args.method not in (None, "auto", "distributed"):
            ap.error(f"--distributed conflicts with --method {args.method}; "
                     "drop one of the two (--distributed runs the §III-E "
                     "striped schedule over all local devices)")
        args.method = "distributed"
    elif args.method is None:
        args.method = "auto"
    try:
        resolve_device(args.device)  # before any ingest: no card, no run
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None

    log = functools.partial(print, file=sys.stderr) if args.json else print
    with obs.trace_to_file(args.trace, meta={"cli": "count"}):
        _run_count(args, log)
    if args.trace:
        log(f"trace written to {args.trace}")


def _run_count(args, log) -> None:
    t_build0 = time.time()
    with obs.span("ingest", cat="io"):
        graph, info = resolve_graph(args, log=log)
    build_s = time.time() - t_build0

    mesh = mesh_from_args(args, log)
    tuner = None
    if args.tile_cache is not None or args.autotune:
        from repro_torch.core.tuning import AutoTuner

        tuner = AutoTuner(args.tile_cache, tune_on_miss=args.autotune, device=args.device)
    tc = TriangleCounter(method=args.method, max_wedge_chunk=args.max_wedge_chunk,
                         tuner=tuner, mesh=mesh, device=args.device)
    count_input = graph
    if args.clustering_summary:
        # normalize to an OrientedCSR once up front so the count and the
        # extra per-node pass share it — no second ingest/preprocess
        # (`graph` itself stays untouched: the --baseline path needs the
        # raw edge array / CSRGraph, not the oriented NamedTuple)
        from repro_torch.core import prepare_oriented

        csr = prepare_oriented(graph, device=tc.device)
        if csr is not None:
            count_input = csr
    t0 = time.time()
    t = tc.count(count_input)
    dt = time.time() - t0
    es = tc.last_stats
    log(f"triangles[{es.method}] = {t}  ({dt*1e3:.1f} ms; "
        f"{es.n_chunks} chunk(s), peak wedge buffer {es.peak_wedge_buffer})")
    if es.fallback_reason:
        log(f"note: {es.fallback_reason}")
    if mesh is not None:
        log(f"stripes: {es.n_stripes}, wedge-load skew {es.stripe_skew}, "
            f"straggler stripe {es.straggler_stripe}")
    if tuner is not None:
        log(f"tile cache: {tuner.n_hits} hit(s), {tuner.n_tuned} shape(s) tuned")

    expected = info.get("expected_triangles")
    if expected is not None and t != expected:
        raise SystemExit(
            f"ORACLE FAILED: counted {t} but {info.get('dataset')} has "
            f"{expected} published triangles"
        )

    baseline_s = None
    if args.baseline:
        edges = graph.edge_array() if hasattr(graph, "edge_array") else graph
        t0 = time.time()
        tb = count_triangles_numpy(edges)
        baseline_s = time.time() - t0
        log(f"triangles[numpy-cpu] = {tb}  ({baseline_s*1e3:.1f} ms, "
            f"speedup {baseline_s/max(dt,1e-9):.2f}×)")
        if tb != t:
            raise SystemExit(f"BASELINE MISMATCH: engine counted {t}, numpy {tb}")

    trans = None
    if args.clustering or args.transitivity or args.clustering_summary:
        # derive from the count and wedge total already in hand — no recount
        wedges = info["graph"]["total_wedges"]
        trans = 3.0 * t / wedges if wedges else 0.0
        log(f"transitivity = {trans:.4f}")

    clustering_summary = None
    if args.clustering_summary:
        from repro_torch.analytics.metrics import (
            clustering_from_counts,
            profile_from_counts,
        )
        from repro_torch.core import degree_histogram

        t0 = time.time()
        deg, _ = degree_histogram(count_input)
        tri = tc.per_node(count_input)  # same CSR as the count — one extra pass
        cc = clustering_from_counts(tri, deg)
        cluster_s = time.time() - t0
        clustering_summary = dict(
            average=float(cc.mean()) if cc.size else 0.0,
            profile=profile_from_counts(tri, deg),
        )
        log(f"avg clustering = {clustering_summary['average']:.4f} "
            f"({cluster_s*1e3:.1f} ms)")

    if args.json:
        out = dict(
            triangles=t,
            method=es.method,
            resolved_method=es.resolved_method,
            stats=dict(
                n_chunks=es.n_chunks,
                peak_wedge_buffer=es.peak_wedge_buffer,
                wedge_budget=es.wedge_budget,
                total_wedges=es.total_wedges,
                n_directed_edges=es.n_directed_edges,
                fallback_reason=es.fallback_reason,
                timings=es.timings,
            ),
            counters=obs.metrics_snapshot()["counters"],
            graph=info.get("graph"),
            source={k: v for k, v in info.items() if k != "graph"},
            timings_s=dict(build=build_s, count=dt, baseline=baseline_s),
            transitivity=trans,
            clustering=clustering_summary,
        )
        print(json.dumps(out, indent=None, sort_keys=True))


if __name__ == "__main__":
    main()
