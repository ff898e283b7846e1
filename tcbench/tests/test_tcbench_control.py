"""The comparison that decides ``correct`` fails its control and every fault
a cell can have, and passes a sound run.

The control is the reference computed in float32 in place of the exact
int64 counts and float64 LCC.  The faults are planted in the program's
timed path: an answer altered where it is produced, and half of the work
(every other chunk of the plan) left out.  The runs drive the harness on
the CPU at a small size, past its look for a card.
"""
import hashlib
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tcbench import run
from tcbench.gen.kronecker import make_graph, make_graphs
from tcbench.reference import orient

BENCH = Path(__file__).resolve().parents[1]
count_job = run.part("jobs", "count")
lcc_job = run.part("jobs", "lcc")


def complete_graph(n: int) -> torch.Tensor:
    lo, hi = np.triu_indices(n, 1)
    fwd = torch.from_numpy(np.stack([lo, hi], 1).astype(np.int32))
    return torch.cat([fwd, fwd.flip(1)])


def test_control_fails_the_count_past_float32():
    # K_467 has C(467, 3) = 16,865,705 triangles: odd and past 2**24, so
    # float32 cannot hold it
    g = orient(complete_graph(467), 467)
    exact = count_job.reference(g)
    assert exact == 16_865_705
    control = count_job.reference(g, dtype=torch.float32)
    assert count_job.compare([exact], exact) == {"count_max_abs_diff": 0.0}
    gap = count_job.compare([control], exact)["count_max_abs_diff"]
    assert gap > count_job.LIMITS["count_max_abs_diff"]


def test_control_fails_the_lcc():
    cfg = {"generator": "graph500_kronecker", "scale": 10, "edge_factor": 16,
           "initiator": [0.57, 0.19, 0.19, 0.05], "compact_ids": True}
    graph = make_graph(cfg, 2**31 + 99, "cpu")
    g = orient(torch.from_numpy(graph.edges), graph.n_nodes)
    exact = lcc_job.reference(g)
    control = lcc_job.reference(g, dtype=torch.float32)
    assert lcc_job.compare([exact, exact], exact) == {"lcc_max_abs_diff": 0.0}
    gap = lcc_job.compare([exact, control], exact)["lcc_max_abs_diff"]
    assert gap > lcc_job.LIMITS["lcc_max_abs_diff"]


@pytest.mark.parametrize("name", ["graph500-22", "kron-g500-logn21"])
def test_answers_of_a_relabelled_copy_map_back(name):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    first, other = make_graphs(dict(config, scale=10), 2**31 + 41, "cpu", 2)
    ref = [orient(torch.from_numpy(g.edges), g.n_nodes) for g in (first, other)]
    assert count_job.reference(ref[1]) == count_job.reference(ref[0])
    exact, renamed = lcc_job.reference(ref[0]), lcc_job.reference(ref[1])
    assert lcc_job.compare([renamed], exact)["lcc_max_abs_diff"] > 0
    mapped = lcc_job.in_generated_ids(renamed, other.perm)
    assert lcc_job.compare([mapped], exact) == {"lcc_max_abs_diff": 0.0}
    assert lcc_job.in_generated_ids(renamed[:-1], other.perm).shape == renamed[:-1].shape


def test_compare_refuses_what_is_not_an_answer():
    assert count_job.compare([None], 5)["count_max_abs_diff"] == math.inf
    assert count_job.compare([True], 1)["count_max_abs_diff"] == math.inf
    assert count_job.compare([], 5)["count_max_abs_diff"] == math.inf
    ref = np.array([0.0, 0.5])
    assert lcc_job.compare([np.zeros(3)], ref)["lcc_max_abs_diff"] == math.inf
    assert lcc_job.compare([np.array([0.0, np.nan])], ref)["lcc_max_abs_diff"] == math.inf
    assert lcc_job.compare([np.array([0, 1])], ref)["lcc_max_abs_diff"] == math.inf


def tiny_spec(job: str) -> dict:
    config = json.loads((BENCH / "configs" / "graph500-22.json").read_text())
    traffic = json.loads((BENCH / "workloads" / f"{job}.json").read_text())
    return {"cell": {"name": f"tiny.{job}", "chips": 1},
            "config": dict(config, scale=10),
            "traffic": dict(traffic, max_wedge_chunk=4096),
            "end_to_end": [{"name": "evps", "unit": "ev/s"}, {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": n, "unit": "%"} for n in
                          ("plan_share", "memcpy_share", "intersect_roofline",
                           "device_idle_share")]}


def drive(job: str, trace: bool = False, seconds: float = 0.3) -> dict:
    return run.run_cell(tiny_spec(job), 2**31 + 5, seconds, trace, "cpu", time.perf_counter())


@pytest.fixture
def engine():
    run.program_path()
    from repro_torch.core import engine

    return engine


def alter_answer(engine, monkeypatch):
    real_fold, real_run = engine.accumulate_partials, engine.run_workload

    def fold(partials):
        return real_fold(partials) + 1

    def run_workload(backend, kind, work, **kw):
        value, plan = real_run(backend, kind, work, **kw)
        if kind == "per_node":
            value = value.copy()
            value[int(np.argmax(value))] += 1
        return value, plan

    monkeypatch.setattr(engine, "accumulate_partials", fold)
    monkeypatch.setattr(engine, "run_workload", run_workload)


def drop_half(engine, monkeypatch):
    real_run = engine.run_workload

    def run_workload(backend, kind, work, **kw):
        plan_all = backend.plan

        def plan(*a, **k):
            p = plan_all(*a, **k)
            kept = list(p.chunks)[::2]
            return p._replace(chunks=iter(kept), n_chunks=len(kept))

        backend.plan = plan
        return real_run(backend, kind, work, **kw)

    monkeypatch.setattr(engine, "run_workload", run_workload)


@pytest.mark.parametrize("job", ["count", "lcc"])
def test_sound_run_is_correct(job):
    out = drive(job)
    result = out["result"]
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"evps", "setup_s"}
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert out["details"]["n_chunks"] > 2
    details = out["details"]
    assert len(details["cpu_s"]) == details["jobs"] == len(details["job_s"])
    assert all(c >= 0 for c in details["cpu_s"]) and details["host"]["pace_s"] > 0


def test_no_job_hands_in_the_input_of_the_job_before(engine, monkeypatch):
    seen = []
    real_count = engine.TriangleCounter.count

    def count(self, edges, n_nodes, **kw):
        seen.append(hashlib.sha256(np.ascontiguousarray(edges).tobytes()).hexdigest())
        return real_count(self, edges, n_nodes, **kw)

    monkeypatch.setattr(engine.TriangleCounter, "count", count)
    out = drive("count", seconds=2.0)  # some tens of jobs
    graphs = out["details"]["graphs"]
    assert out["result"]["correct"] is True and graphs >= 2
    assert len(seen) > graphs, "the window turns through every graph"
    assert len(set(seen[:graphs])) == graphs
    assert all(a != b for a, b in zip(seen, seen[1:]))


@pytest.mark.parametrize("fault", [alter_answer, drop_half], ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("job", ["count", "lcc"])
def test_fault_makes_the_run_incorrect(job, fault, engine, monkeypatch):
    fault(engine, monkeypatch)
    result = drive(job)["result"]
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_traced_run_reports_the_per_layer_metrics_it_can_read():
    result = drive("count", trace=True)["result"]
    assert result["correct"] is True
    # on the CPU there is no device trace: only the plan share can be read
    assert set(result["metrics"]) == {"plan_share"}
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go ahead")
    assert run.main(["--workload", "logn21.count", "--seed", "1", "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "CUDA card" in out.err
