"""Run one cell of the benchmark of ``repro_torch``, the PyTorch and CUDA port.

From the root of a checkout, on a machine with the card::

    python3 tcbench/run.py --workload logn21.count --seed 7 --seconds 51 --trace 0

One run: the cell's files are found by name from ``BENCHMARK.json``; the
graph is made on the card from ``--seed``, then relabelled copies of it
up to the traffic's ``graphs``, each copied to the host once; the kernels
are loaded from ``build/kernels/`` in the checkout (built there by the
first run); one warm-up job runs; then jobs run back to back in the
traffic's loop for ``--seconds``, each on the next graph in turn, so that
no job hands in the input of any of the ``graphs - 1`` jobs before it.
Set-up is everything before the window.  After the window the program's
state is freed and the plain reference
(:mod:`tcbench.reference`) works out the answer that every job's output is
held to.  With ``--trace 1`` the window runs under ``torch.profiler`` and
the per-layer metrics are read from the trace; with ``--trace 0`` the
end-to-end ones.  The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the last key of that object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "tcbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def part(kind: str, name: str):
    """The module ``tcbench/<kind>/<name>.py``: a job, a loop or a metric,
    found by its name."""
    return importlib.import_module(f"tcbench.{kind}.{name}")


def cell_spec(workload: str) -> dict:
    """The cell's entry, configuration, traffic and metrics, by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / config_entry["file"]).read_text())
    traffic = json.loads((BENCH / "workloads" / f"{cell['traffic']}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": bench["end_to_end"], "per_layer": per_layer}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def use_checkout_caches() -> None:
    """Every build and kernel cache the program could use, at fixed paths
    inside the checkout (the port's own library cache is ``build/kernels``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def program_path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, chips: int = 1) -> dict:
    """Drive one run of a cell on ``device``; returns the result line and the
    earlier line's details.  Nothing here checks for a card: ``main`` does."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tcbench.gen import make_graphs
    from tcbench.host import JobClock, host_pace_s, host_state
    from tcbench.reading import Reading
    from tcbench.reference import orient
    from tcbench.roofline import intersect_bytes
    from tcbench.trace import JOB_RANGE, WINDOW_RANGE, breakdown, from_events, kineto_events
    from tcbench.trace import union_seconds

    config, traffic = spec["config"], spec["traffic"]
    job, loop = part("jobs", traffic["job"]), part("loops", traffic["loop"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    t0 = time.perf_counter()
    graphs = make_graphs(config, seed, dev, traffic["graphs"])
    graph = graphs[0]
    if on_card:
        torch.cuda.synchronize(dev)
    generate_s = time.perf_counter() - t0

    program_path()
    from repro_torch.core.engine import TriangleCounter

    build = None
    if on_card:
        from repro_torch.kernels.triangle_count import _build as tc_build

        t0 = time.perf_counter()
        tc_build.load_library()
        info = tc_build.build_info() or {}
        build = {"built": info.get("built"), "build_s": info.get("seconds"),
                 "load_s": time.perf_counter() - t0}
    counter = TriangleCounter(method=traffic["method"], max_wedge_chunk=traffic["max_wedge_chunk"],
                              device=device)
    job_range = JOB_RANGE + traffic["job"]
    handed = []  # the relabelling of the graph each job was handed, warm-up first
    clock = JobClock()

    def call():
        g = graphs[len(handed) % len(graphs)]
        handed.append(g.perm)
        clock.start()
        with record_function(job_range):
            answer = job.run(counter, g)
        clock.stop()
        return answer, dict(counter.last_stats.timings or {})

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    warm_answer, warm_timings = call()
    warmup_s = time.perf_counter() - t0
    host = host_state()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
        prof.start()
    with record_function(WINDOW_RANGE):
        jobs, failed, window_s = loop.drive(call, seconds)
    traced = None
    if prof is not None:
        prof.stop()
        t0 = time.perf_counter()
        traced = from_events(kineto_events(prof))
        trace_read_s = time.perf_counter() - t0
        del prof
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    host["pace_s"] = host_pace_s()

    # the program's state goes before the reference runs
    method, n_chunks = counter.last_stats.method, counter.last_stats.n_chunks
    del counter, graphs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    edges = torch.from_numpy(graph.edges).to(dev)
    oriented = orient(edges, graph.n_nodes)
    del edges
    ref = job.reference(oriented)
    answers = [job.in_generated_ids(a, perm)
               for a, perm in zip([warm_answer] + [j.answer for j in jobs], handed)]
    numbers = job.compare(answers, ref)
    n_bytes = None
    if trace:
        n_bytes = intersect_bytes(oriented.row_offsets, oriented.src, oriented.col,
                                  job.result_values(graph))
    del oriented
    if on_card:
        torch.cuda.synchronize(dev)
    reference_s = time.perf_counter() - t0

    checks = {name: {"value": value, "limit": job.LIMITS[name]} for name, value in numbers.items()}
    correct = bool(failed == 0 and jobs and all(c["value"] <= c["limit"] for c in checks.values()))

    reading = Reading(setup_s=setup_s, window_s=window_s, jobs=jobs,
                      n_vertices=graph.n_vertices, n_edges=graph.n_edges,
                      trace=traced, intersect_bytes=n_bytes)
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = part("metrics", m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(jobs) + failed, "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info["busy_s"] = union_seconds(traced.device)
        device_info["window_s"] = traced.window_s
        result["breakdown"] = breakdown(traced)
    result["checks"] = checks

    job_s = [j.end - j.start for j in jobs]
    details = {
        "workload": spec["cell"]["name"], "seed": seed, "seconds": seconds, "trace": int(trace),
        "config": config["name"], "n_nodes": graph.n_nodes,
        "generated": {"vertices": graph.n_vertices, "edges": graph.n_edges},
        "published": config.get("published"),
        "method": method, "n_chunks": n_chunks, "jobs": len(jobs),
        "job_s": job_s, "job_s_median": statistics.median(job_s) if job_s else None,
        "plan_s": [j.timings.get("plan") for j in jobs],
        "graphs": traffic["graphs"], "cpu_s": clock.cpu_s[1:len(jobs) + 1],
        "warmup_cpu_s": clock.cpu_s[0], "host": host,
        "timings_s": [j.timings for j in jobs[:1]], "window_s": window_s,
        "setup_s": setup_s, "generate_s": generate_s, "warmup_s": warmup_s,
        "warmup_timings_s": warm_timings, "kernels": build, "reference_s": reference_s,
        "intersect_bytes_per_job": n_bytes,
    }
    if traced is not None:
        details["trace_read_s"] = trace_read_s
        kinds: dict = {}
        for op in traced.device:
            kinds.setdefault(op.kind, [0, op.name[:80]])[0] += 1
        details["trace_events"] = {"device": kinds, "host": len(traced.host)}
    return {"result": result, "details": details}


def _finite(obj):
    """``obj`` with every non-finite float as the string ``"inf"`` or ``"nan"``,
    so the line stays strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return "nan" if math.isnan(obj) else "inf"
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    spec = cell_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    use_checkout_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    card = card_line()
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START, chips)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone", file=sys.stderr)
        return 4
    out["details"]["card"] = card
    print(json.dumps(_finite(out["details"])), flush=True)
    for name, check in out["result"]["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(out["result"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
