"""Graph analytics launcher of the port — clustering, transitivity, support, k-truss.

::

    python -m repro_torch.launch.analyze --input tests/data/karate.txt --json   # on the card
    python -m repro_torch.launch.analyze --input tests/data/karate.txt --json --device cpu
    python -m repro_torch.launch.analyze --dataset karate --json --top-k 3
    python -m repro_torch.launch.analyze --scale 12 --max-wedge-chunk 1048576 --no-truss

Shares the graph-source flags (``--input`` / ``--dataset`` /
``--generator`` / ``--cache-dir`` …) with ``count.py`` via
:func:`repro_torch.launch.count.add_source_arguments`.  The whole report
preprocesses the graph once
(:func:`repro_torch.analytics.metrics.graph_report`): count, per-node
clustering, per-edge support and the truss peel all consume one
``OrientedCSR`` on ``--device`` (default ``cuda``; without a card the CLI
exits unless it is given ``--device cpu``).  ``--method distributed``
(which the reference's analyze CLI does not offer) runs every stage on
the §III-E stripes of a mesh of the visible devices of ``--device``.

``--json`` prints one machine-readable object on stdout (triangles,
transitivity, clustering profile, support top-k, truss spectrum, engine
stats, per-stage timings); human-readable lines go to stderr.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.analytics import graph_report
from repro_torch.core.engine import METHODS
from repro_torch.launch.count import (
    add_source_arguments,
    add_trace_argument,
    mesh_from_args,
    resolve_graph,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    add_source_arguments(ap)
    ap.add_argument("--method", default="auto", choices=list(METHODS),
                    help="kernel backend for EVERY stage — count, clustering, "
                         "per-edge support, k-truss peel "
                         "(default: auto dispatch)")
    ap.add_argument("--max-wedge-chunk", type=int, default=None,
                    help="wedge-buffer budget per launch (slots); bounds "
                         "every pass — count, clustering, support, truss")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs (default: %(default)s; "
                         "raises when no card is visible)")
    ap.add_argument("--no-truss", action="store_true",
                    help="skip the k-truss decomposition (the iterative "
                         "peel is the most expensive stage)")
    ap.add_argument("--top-k", type=int, default=5,
                    help="how many top triangle-dense nodes/edges to report "
                         "(default: %(default)s)")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable JSON object on stdout "
                         "(progress lines go to stderr)")
    add_trace_argument(ap)
    args = ap.parse_args()
    if args.max_wedge_chunk is not None and args.max_wedge_chunk < 1:
        ap.error("--max-wedge-chunk must be a positive number of wedge slots")
    if args.top_k < 0:
        ap.error("--top-k must be non-negative")
    try:
        resolve_device(args.device)  # before any ingest: no card, no run
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None

    log = functools.partial(print, file=sys.stderr) if args.json else print
    with obs.trace_to_file(args.trace, meta={"cli": "analyze"}):
        _run_analyze(args, log)
    if args.trace:
        log(f"trace written to {args.trace}")


def _run_analyze(args, log) -> None:
    t0 = time.time()
    with obs.span("ingest", cat="io"):
        graph, info = resolve_graph(args, log=log)
    build_s = time.time() - t0

    mesh = mesh_from_args(args, log)
    report = graph_report(
        graph,
        method=args.method,
        max_wedge_chunk=args.max_wedge_chunk,
        include_truss=not args.no_truss,
        top_k=args.top_k,
        mesh=mesh,
        device=args.device,
    )
    report["source"] = {k: v for k, v in info.items() if k != "graph"}
    report["timings_s"]["build"] = build_s

    expected = info.get("expected_triangles")
    if expected is not None and report["triangles"] != expected:
        raise SystemExit(
            f"ORACLE FAILED: counted {report['triangles']} but "
            f"{info.get('dataset')} has {expected} published triangles"
        )

    es = report["engine"]
    log(f"triangles[{es['method']}] = {report['triangles']}  "
        f"({report['timings_s']['count']*1e3:.1f} ms; {es['n_chunks']} chunk(s), "
        f"peak wedge buffer {es['peak_wedge_buffer']})")
    if es.get("fallback_reason"):
        log(f"note: {es['fallback_reason']}")
    log(f"transitivity = {report['transitivity']:.4f}   "
        f"avg clustering = {report['clustering']['average']:.4f}")
    if report["clustering"]["top_nodes"]:
        tops = ", ".join(f"{d['node']}:{d['triangles']}"
                         for d in report["clustering"]["top_nodes"])
        log(f"top triangle nodes (node:T) = {tops}")
    sup = report["support"]
    log(f"edge support[{sup['method']}]: sum = {sup['sum']} (= 3·T), "
        f"max = {sup['max']}  "
        f"({report['timings_s']['support']*1e3:.1f} ms)")
    if "truss" in report:
        tr = report["truss"]
        spectrum = ", ".join(f"k={k}:{c}" for k, c in sorted(
            tr["spectrum"].items(), key=lambda kv: int(kv[0])))
        log(f"k-truss[{tr['method']}]: max_k = {tr['max_k']} in "
            f"{tr['rounds']} peel round(s); "
            f"trussness spectrum {{{spectrum}}} "
            f"({report['timings_s']['truss']*1e3:.1f} ms)")

    if args.json:
        print(json.dumps(report, indent=None, sort_keys=True))


if __name__ == "__main__":
    main()
