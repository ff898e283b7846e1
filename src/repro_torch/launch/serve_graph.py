"""Graph-query serving CLI of the port — thin front-end over
:mod:`repro_torch.serve`.

The PyTorch counterpart of ``repro.launch.serve_graph``.  The drive loop
itself lives in :func:`repro_torch.serve.session.drive_stream`
(single-tenant: update batches from :mod:`repro_torch.graphs.streams`
interleaved with count / per-node / clustering / transitivity queries,
pow2 latency histograms per traffic class, rolling-window interval
reports).  Every flag and every ``--json`` report key is the
reference's; ``--device`` (default ``cuda``) says where the counter runs,
and without a card the CLI exits before any ingest unless it is given
``--device cpu``::

    python -m repro_torch.launch.serve_graph --generator kronecker --scale 10
    python -m repro_torch.launch.serve_graph --scale 10 --stream sliding_window \\
        --window 20000 --batch-size 512 --queries-per-batch 8 --method pallas
    python -m repro_torch.launch.serve_graph --dataset karate --batch-size 16 \\
        --json --device cpu

    # kill-safe serving: snapshot every 64 batches; a rerun with
    # --resume restores the newest valid snapshot and picks the stream
    # up mid-flight (identical final state to an uninterrupted run)
    python -m repro_torch.launch.serve_graph --scale 10 --max-batches 512 \\
        --snapshot-dir serve_snap --snapshot-every 64
    python -m repro_torch.launch.serve_graph --scale 10 --max-batches 1024 \\
        --snapshot-dir serve_snap --resume

Snapshots use the reference's format, so either package resumes the
other's.  Unless ``--no-verify`` is given, the final maintained count is
checked against a from-scratch ``TriangleCounter`` recount of the live
edge set on the same device, and the process exits non-zero on any
mismatch.  ``--method distributed`` stripes the bootstrap and every
probe §III-E-style over a mesh of the visible devices of ``--device``.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core import TriangleCounter
from repro_torch.graphs import STREAM_GENERATORS
from repro_torch.launch.count import (
    add_source_arguments,
    add_trace_argument,
    resolve_graph,
)
from repro_torch.serve import SnapshotStore, drive_stream


def run_service(stream, **kwargs):
    """Back-compat alias for :func:`repro_torch.serve.session.drive_stream`."""
    return drive_stream(stream, **kwargs)


def main() -> None:
    ap = argparse.ArgumentParser()
    add_source_arguments(ap)
    ap.set_defaults(scale=10)  # serving default: smaller than count.py's
    ap.add_argument("--stream", choices=sorted(STREAM_GENERATORS), default="temporal")
    ap.add_argument("--window", type=int, default=None,
                    help="live-edge window for sliding_window (default: half "
                         "the graph's undirected edges)")
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--max-batches", type=int, default=None,
                    help="stop after this many update batches, counted from "
                         "the stream's start even when resuming (default: "
                         "drain)")
    ap.add_argument("--queries-per-batch", type=int, default=4)
    ap.add_argument("--max-wedge-chunk", type=int, default=None,
                    help="wedge-buffer budget per launch, applied to every "
                         "update batch's probe workload")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "wedge_bsearch", "panel", "pallas",
                             "distributed"],
                    help="kernel backend for the bootstrap count and the "
                         "update probes (auto keeps probes on the wedge "
                         "schedule; panel routes them through the panel "
                         "backend, pallas through the CUDA kernels; "
                         "distributed stripes them §III-E-style over a mesh "
                         "of all local devices)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the counter runs (default: %(default)s; "
                         "raises when no card is visible)")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the final from-scratch oracle recount")
    ap.add_argument("--report-every", type=int, default=32, metavar="N",
                    help="seal a latency interval every N update batches: "
                         "print rolling-window percentiles and append a "
                         "snapshot to --metrics-out (default: %(default)s)")
    ap.add_argument("--latency-window", type=int, default=8, metavar="K",
                    help="intervals in the rolling percentile window "
                         "(default: %(default)s)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE.jsonl",
                    help="append one JSON latency snapshot per interval "
                         "(plus a final lifetime record)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="checkpoint the session state (count, per-node "
                         "incidences, adjacency, stream cursor) into DIR")
    ap.add_argument("--snapshot-every", type=int, default=64, metavar="N",
                    help="snapshot every N applied batches when "
                         "--snapshot-dir is set (default: %(default)s; a "
                         "final snapshot is always written at exit)")
    ap.add_argument("--keep-snapshots", type=int, default=3, metavar="K",
                    help="rolling snapshot retention (default: %(default)s)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid snapshot from "
                         "--snapshot-dir and resume the stream mid-flight "
                         "(fresh start if none is restorable)")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable JSON report on stdout "
                         "(progress lines go to stderr)")
    add_trace_argument(ap)
    args = ap.parse_args()
    if args.window is not None and args.window < 1:
        ap.error("--window must be a positive number of live edges")
    if args.batch_size < 1:
        ap.error("--batch-size must be positive")
    if args.report_every < 1:
        ap.error("--report-every must be positive")
    if args.latency_window < 1:
        ap.error("--latency-window must be positive")
    if args.snapshot_every < 1:
        ap.error("--snapshot-every must be positive")
    if args.keep_snapshots < 1:
        ap.error("--keep-snapshots must be positive")
    if args.resume and args.snapshot_dir is None:
        ap.error("--resume requires --snapshot-dir")
    try:
        resolve_device(args.device)  # before any ingest: no card, no run
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None

    log = functools.partial(print, file=sys.stderr) if args.json else print
    with obs.trace_to_file(args.trace, meta={"cli": "serve_graph"}):
        _run_serve(args, log)
    if args.trace:
        log(f"trace written to {args.trace}")


def _run_serve(args, log) -> None:
    mesh = None
    if args.method == "distributed":
        from repro_torch.distributed import Mesh
        from repro_torch.launch.mesh import make_local_mesh

        devs = list(make_local_mesh(device=args.device).devices.flat)
        mesh = Mesh(devs, ("edges",))
        log(f"mesh: {len(devs)} device(s) striped on axis 'edges'")

    with obs.span("ingest", cat="io"):
        graph, info = resolve_graph(args, log=log)
    # streams consume edge arrays; a cached CSR seed materializes one
    # (the cheap direction — one np.repeat over the memory-mapped CSR)
    edges = graph.edge_array() if hasattr(graph, "edge_array") else graph
    stats = info["graph"]

    if args.stream == "sliding_window":
        window = (args.window if args.window is not None
                  else max(stats["n_edges"] // 2, 1))
        stream = STREAM_GENERATORS[args.stream](
            edges, window=window, batch_size=args.batch_size, seed=args.seed
        )
        log(f"stream: sliding_window(window={window}, batch={args.batch_size})")
    else:
        stream = STREAM_GENERATORS[args.stream](
            edges, batch_size=args.batch_size, seed=args.seed
        )
        log(f"stream: temporal(batch={args.batch_size})")

    store = session = None
    if args.snapshot_dir is not None:
        store = SnapshotStore(args.snapshot_dir, keep=args.keep_snapshots)
        if args.resume:
            hit = store.restore_session(
                "serve_graph",
                max_wedge_chunk=args.max_wedge_chunk,
                method=args.method,
                mesh=mesh,
                device=args.device,
            )
            if hit is not None:
                session = hit[0]
                log(f"resume: restored snapshot at cursor {session.cursor} "
                    f"({session.counter.n_edges} edges, "
                    f"T = {session.counter.count})")
            else:
                log("resume: no restorable snapshot; starting fresh")

    sink = None
    metrics_file = None
    if args.metrics_out:
        metrics_file = open(args.metrics_out, "a")

        def sink(snap):
            metrics_file.write(json.dumps(snap, sort_keys=True) + "\n")
            metrics_file.flush()

    try:
        counter, rep = drive_stream(
            stream,
            n_nodes=stats["n_nodes"],
            max_batches=args.max_batches,
            queries_per_batch=args.queries_per_batch,
            max_wedge_chunk=args.max_wedge_chunk,
            method=args.method,
            mesh=mesh,
            report_every=args.report_every,
            window_intervals=args.latency_window,
            metrics_sink=sink,
            log=log,
            session=session,
            snapshot_store=store,
            snapshot_every=args.snapshot_every if store is not None else None,
            device=args.device,
        )
    finally:
        if metrics_file is not None:
            metrics_file.close()
    if counter.last_update_stats is not None:
        log(f"probe backend: {counter.last_update_stats.probe_method}")
    log(f"served {rep['n_batches']} update batches "
        f"(+{rep['n_inserted']}/-{rep['n_deleted']} edges, "
        f"{rep['updates_per_s']:.0f} edge-updates/s) "
        f"and {rep['n_queries']} queries")
    log(f"update latency: p50 {rep['update_p50_ms']:.2f} ms, "
        f"p99 {rep['update_p99_ms']:.2f} ms")
    log(f"query  latency: p50 {rep['query_p50_ms']:.3f} ms, "
        f"p99 {rep['query_p99_ms']:.3f} ms")
    for kind, snap in rep["latency"]["queries"].items():
        log(f"  {kind:13s} n={snap['n']:<6d} p50 {snap['p50_ms']:.3f} ms, "
            f"p90 {snap['p90_ms']:.3f} ms, p99 {snap['p99_ms']:.3f} ms")
    log(f"live graph: {counter.n_edges} edges, T = {counter.count}")
    if store is not None and "resume" in rep:
        log(f"snapshots: {rep['resume']['snapshots_written']} written to "
            f"{args.snapshot_dir} (cursor {rep['resume']['cursor']})")

    verified = None
    if not args.no_verify:
        tc = TriangleCounter(
            method=args.method, max_wedge_chunk=args.max_wedge_chunk, mesh=mesh,
            device=args.device,
        )
        expect = tc.count(counter.current_edges(), n_nodes=counter.n_nodes)
        if counter.count != expect:
            raise SystemExit(
                f"VERIFY FAILED: incremental T={counter.count} != oracle {expect}"
            )
        log(f"verify: from-scratch recount agrees (T = {expect})")
        verified = True

    if args.json:
        out = dict(
            rep,
            triangles=int(counter.count),
            n_edges=int(counter.n_edges),
            probe_method=(counter.last_update_stats.probe_method
                          if counter.last_update_stats is not None else None),
            verified=verified,
            source={k: v for k, v in info.items() if k != "graph"},
            counters=obs.metrics_snapshot()["counters"],
        )
        print(json.dumps(out, indent=None, sort_keys=True))


if __name__ == "__main__":
    main()
