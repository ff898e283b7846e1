"""Load generator: concurrent clients against a :class:`GraphService`.

The PyTorch counterpart of ``repro.serve.loadgen``: the same library API,
report keys and CLI flags, plus ``--device {cuda,cpu}`` (the card by
default; no card, no run).

Drives mixed query (and optionally update) traffic from N client
threads, records per-traffic-class latency in lock-protected pow2
histograms (:class:`repro_torch.obs.ConcurrentHistogram` — many observers,
one instrument), and reports p50/p99 per class plus throughput and the
service's fusion counters, so "did batching actually happen" is a field
in the report rather than a belief.

Two entry points:

:func:`run_load`
    Library API the serving benchmark suite sweeps over client counts
    and admission policies (batched vs sequential arms).
``python -m repro_torch.serve.loadgen``
    CLI for CI smoke: stand up a service on one graph, run a quick
    mixed workload, print a machine-readable ``--json`` report.  With
    ``--attest-fusion`` it first runs a *deterministic* fusion proof —
    queue K point/node queries against a stopped service, start it, and
    require that they all resolve from a single engine pass.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.obs import ConcurrentHistogram

from .admission import QueryTimeout, QueueOverflow
from .manager import GraphManager
from .service import GraphService

__all__ = ["DEFAULT_MIX", "run_load", "main"]

# weights roughly matching a lookup-heavy tenant population
DEFAULT_MIX = {"count": 0.5, "transitivity": 0.1, "per_node": 0.25, "clustering": 0.15}

_FUSION_COUNTERS = (
    "serve.requests",
    "serve.fused_batches",
    "serve.fused_queries",
    "serve.engine_passes",
    "serve.timeouts",
    "serve.overflows",
)


def _counters() -> dict[str, int]:
    snap = obs.metrics_snapshot()["counters"]
    return {k: int(snap.get(k, 0)) for k in _FUSION_COUNTERS}


def run_load(
    service: GraphService,
    graph: str,
    *,
    clients: int = 4,
    requests_per_client: int = 50,
    mix: dict[str, float] | None = None,
    seed: int = 0,
    update_stream=None,
    max_updates: int | None = None,
    result_timeout: float = 300.0,
) -> dict:
    """Run a closed-loop mixed workload; returns a JSON-ready report.

    ``clients`` threads each issue ``requests_per_client`` queries drawn
    from ``mix`` (a kind→weight map, deterministic per client seed) and
    block for each answer before issuing the next (closed loop — the
    offered concurrency *is* the client count).  With ``update_stream``
    (an iterator of :class:`repro_torch.graphs.streams.StreamBatch`), one
    extra updater thread applies batches to ``graph``'s stream session
    concurrently, exercising the update lane under read load.
    """
    if clients < 1:
        raise ValueError("clients must be >= 1")
    mix = dict(mix or DEFAULT_MIX)
    kinds = sorted(mix)
    weights = np.asarray([mix[k] for k in kinds], np.float64)
    weights = weights / weights.sum()

    hists: dict[str, ConcurrentHistogram] = {}
    hists_lock = threading.Lock()

    def hist(traffic_class: str) -> ConcurrentHistogram:
        with hists_lock:
            h = hists.get(traffic_class)
            if h is None:
                h = hists[traffic_class] = ConcurrentHistogram()
            return h

    errors = {"timeouts": 0, "overflows": 0, "other": 0}
    errors_lock = threading.Lock()
    n_ok = [0]

    def client(idx: int) -> None:
        rng = np.random.default_rng(seed * 1_000_003 + idx)
        for _ in range(requests_per_client):
            kind = kinds[int(rng.choice(len(kinds), p=weights))]
            t0 = time.perf_counter()
            try:
                ticket = service.submit(graph, kind)
                ticket.result(result_timeout)
            except QueueOverflow:
                with errors_lock:
                    errors["overflows"] += 1
                continue
            except QueryTimeout:
                with errors_lock:
                    errors["timeouts"] += 1
                continue
            except Exception:
                with errors_lock:
                    errors["other"] += 1
                continue
            hist(ticket.traffic_class).observe(time.perf_counter() - t0)
            with errors_lock:
                n_ok[0] += 1

    n_updates = [0]

    def updater() -> None:
        for i, batch in enumerate(update_stream):
            if max_updates is not None and i >= max_updates:
                break
            t0 = time.perf_counter()
            try:
                service.update(graph, insert=batch.insert,
                               delete=batch.delete).result(result_timeout)
            except Exception:
                with errors_lock:
                    errors["other"] += 1
                continue
            hist("update").observe(time.perf_counter() - t0)
            n_updates[0] += 1

    before = _counters()
    threads = [
        threading.Thread(target=client, args=(i,), name=f"loadgen-{i}")
        for i in range(clients)
    ]
    if update_stream is not None:
        threads.append(threading.Thread(target=updater, name="loadgen-updater"))
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_start
    delta = {k: v - before[k] for k, v in _counters().items()}

    total_ok = n_ok[0] + n_updates[0]
    return {
        "graph": graph,
        "clients": clients,
        "requests_per_client": requests_per_client,
        "n_ok": n_ok[0],
        "n_updates": n_updates[0],
        "elapsed_s": elapsed,
        "qps": total_ok / elapsed if elapsed > 0 else 0.0,
        "latency": {c: h.snapshot_ms() for c, h in sorted(hists.items())},
        "errors": errors,
        "counters": delta,
    }


def attest_fusion(service: GraphService, graph: str, n: int = 16) -> dict:
    """Deterministic fusion proof on a *stopped* service.

    Queues ``n`` point/node queries while no dispatcher runs, then
    starts the service: the whole backlog lands in one collect window,
    so a correctly-fusing read lane answers all of them from **one**
    engine pass (count and transitivity derive from the per-node
    artifact).  Returns the pass/query accounting plus the answers'
    internal consistency check.
    """
    if service._started:
        raise RuntimeError("attest_fusion needs a service built with start=False")
    before = _counters()
    kinds = ["count", "per_node", "clustering", "transitivity"]
    tickets = [service.submit(graph, kinds[i % len(kinds)]) for i in range(n)]
    service.start()
    answers = [t.result(300.0) for t in tickets]
    delta = {k: v - before[k] for k, v in _counters().items()}
    count = next(a for t, a in zip(tickets, answers) if t.kind == "count")
    per_node = next(a for t, a in zip(tickets, answers) if t.kind == "per_node")
    return {
        "n_queries": n,
        "engine_passes": delta["serve.engine_passes"],
        "fused_queries": delta["serve.fused_queries"],
        "fused_batches": delta["serve.fused_batches"],
        "count": int(count),
        "consistent": int(per_node.sum(dtype=np.int64)) // 3 == int(count),
        "fused": delta["serve.engine_passes"] == 1 and delta["serve.fused_queries"] == n,
    }


def main() -> None:
    from repro_torch.graphs.io import DATASETS

    ap = argparse.ArgumentParser(
        description="mixed-traffic load generator for repro_torch.serve")
    ap.add_argument("--dataset", default="karate", choices=sorted(DATASETS))
    ap.add_argument("--cache-dir", default=".tricsr-cache")
    ap.add_argument("--fallback-scale", type=int, default=None)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=50,
                    help="requests per client (default: %(default)s)")
    ap.add_argument("--method", default="auto",
                    choices=["auto", "wedge_bsearch", "panel", "pallas"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--memory-budget", type=int, default=None, metavar="BYTES",
                    help="graph residency budget (default: unbounded)")
    ap.add_argument("--attest-fusion", action="store_true",
                    help="run the deterministic fusion proof first")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the service's engines run (default: %(default)s; "
                         "raises when no card is visible)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    try:
        resolve_device(args.device)  # before any ingest: no card, no run
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None
    log = (lambda *a: print(*a, file=sys.stderr)) if args.json else print

    manager = GraphManager(args.cache_dir, memory_budget_bytes=args.memory_budget,
                           device=args.device)
    out: dict = {"dataset": args.dataset}

    if args.attest_fusion:
        with GraphService(manager, method=args.method, start=False,
                          device=args.device) as svc:
            svc.attach(args.dataset, args.dataset,
                       fallback_scale=args.fallback_scale)
            out["fusion"] = attest_fusion(svc, args.dataset)
        log(f"fusion: {out['fusion']['n_queries']} queries -> "
            f"{out['fusion']['engine_passes']} engine pass(es), "
            f"consistent={out['fusion']['consistent']}")

    with GraphService(manager, method=args.method, device=args.device) as svc:
        svc.attach(args.dataset, args.dataset, fallback_scale=args.fallback_scale)
        out["triangles"] = svc.query(args.dataset, "count", timeout=300.0)
        report = run_load(
            svc, args.dataset,
            clients=args.clients,
            requests_per_client=args.requests,
            seed=args.seed,
        )
    out["load"] = report
    log(f"{report['n_ok']} queries ok in {report['elapsed_s']:.2f}s "
        f"({report['qps']:.0f} q/s); fused {report['counters']['serve.fused_queries']} "
        f"into {report['counters']['serve.fused_batches']} batches; "
        f"T = {out['triangles']}")
    for cls, snap in report["latency"].items():
        log(f"  {cls:7s} n={snap['n']:<6d} p50 {snap['p50_ms']:.3f} ms, "
            f"p99 {snap['p99_ms']:.3f} ms")
    if args.json:
        print(json.dumps(out, sort_keys=True))


if __name__ == "__main__":
    main()
