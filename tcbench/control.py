"""Readings that a cell's limits are set from, on the card at the cell's size.

From the root of a checkout::

    python3 tcbench/control.py --workload logn21.count --seeds 11,12,13 [--program]

For each seed: the cell's graph, the plain reference's exact answer, and
the control (the reference computed in float32, the precision below the
exact one the configuration states) compared with it, as the run compares
a job's answer.  With ``--program`` also one job of the program, through
the cell's own entry, compared the same way.  One JSON line a seed.  The
benchmark's runs never call this.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tcbench import run  # noqa: E402


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--program", action="store_true")
    args = parser.parse_args(argv)

    spec = run.cell_spec(args.workload)
    run.use_checkout_caches()
    import torch

    from tcbench.gen import make_graph
    from tcbench.reference import orient

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    job = run.part("jobs", spec["traffic"]["job"])
    counter = None
    if args.program:
        run.program_path()
        from repro_torch.core.engine import TriangleCounter

        counter = TriangleCounter(method=spec["traffic"]["method"],
                                  max_wedge_chunk=spec["traffic"]["max_wedge_chunk"])
    print(json.dumps({"card": run.card_line(), "workload": args.workload}), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        graph = make_graph(spec["config"], seed, dev)
        rec = {"seed": seed, "vertices": graph.n_vertices, "edges": graph.n_edges}
        if counter is not None:
            t0 = time.perf_counter()
            answer = job.run(counter, graph)
            rec["program_s"] = time.perf_counter() - t0
            rec["method"] = counter.last_stats.method
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        oriented = orient(torch.from_numpy(graph.edges).to(dev), graph.n_nodes)
        exact = job.reference(oriented)
        rec["reference_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        control = job.reference(oriented, dtype=torch.float32)
        rec["control_s"] = time.perf_counter() - t0
        rec["control"] = job.compare([control], exact)
        if counter is not None:
            rec["program"] = job.compare([answer], exact)
        if isinstance(exact, int):
            rec["answer"] = exact
        rec["limits"] = job.LIMITS
        del oriented
        torch.cuda.empty_cache()
        print(json.dumps(run._finite(rec)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
