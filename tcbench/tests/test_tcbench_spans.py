"""The readers of the program's phase ranges (``tcbench/spans.py`` and the
six ``*_share`` metrics), on synthetic traces."""
import pytest

from tcbench.reading import Reading
from tcbench.run import part
from tcbench.trace import HostRange, Trace, breakdown, from_events

SHARES = ("preprocess_share", "workload_share", "launch_share", "fold_share",
          "lcc_finish_share", "unnamed_share")


def read(name, trace):
    r = Reading(setup_s=1.0, window_s=trace.window_s if trace else 10.0, jobs=[], n_vertices=1,
                n_edges=1, trace=trace)
    return part("metrics", name).read(r)


def trace(*ranges, window_s=10.0):
    host = sorted((HostRange(*r) for r in ranges), key=lambda r: (r.start, -r.end))
    return Trace(window_s, [], host)


def lcc_job():
    """One LCC job over the whole window, every phase named but 9.5-10."""
    return trace(("tcbench.job.lcc", 0.0, 10.0),
                 ("engine.clustering", 0.0, 9.5),
                 ("engine.degrees", 0.0, 0.5),
                 ("engine.per_node", 0.5, 9.0),
                 ("engine.preprocess", 0.5, 1.5),
                 ("aten::to", 0.6, 1.2),             # a torch op inside a phase
                 ("engine.resolve", 1.5, 2.0),
                 ("engine.workload", 2.0, 2.5),
                 ("engine.plan", 2.5, 6.5),
                 ("engine.launch", 6.5, 7.5),
                 ("engine.fold", 7.5, 9.0),
                 ("engine.lcc_finish", 9.0, 9.5))


def test_each_reader_reads_its_ranges():
    t = lcc_job()
    got = {name: read(name, t) for name in SHARES}
    assert got == {"preprocess_share": pytest.approx(10.0), "workload_share": pytest.approx(5.0),
                   "launch_share": pytest.approx(10.0), "fold_share": pytest.approx(15.0),
                   "lcc_finish_share": pytest.approx(10.0),
                   "unnamed_share": pytest.approx(5.0)}
    # the phases, plan and resolve included, and the unnamed rest make up the job
    named = (sum(got[n] for n in SHARES if n != "unnamed_share")
             + 100 * (4.0 + 0.5) / 10.0)
    assert named + got["unnamed_share"] == pytest.approx(100.0)


@pytest.mark.parametrize("name", SHARES)
def test_none_where_the_range_is_absent(name):
    # a parent program opens only the benchmark's own job range
    assert read(name, trace(("tcbench.job.count", 0.0, 10.0), ("aten::copy_", 1.0, 2.0))) is None
    assert read(name, None) is None


def test_a_count_job_has_no_lcc_finish():
    t = trace(("tcbench.job.count", 0.0, 10.0), ("engine.count", 0.0, 10.0),
              ("engine.plan", 1.0, 9.0))
    assert read("lcc_finish_share", t) is None
    assert read("unnamed_share", t) == pytest.approx(20.0)


def test_ranges_are_clipped_to_the_window():
    t = trace(("tcbench.job.count", -2.0, 3.0), ("engine.preprocess", -1.0, 0.5),
              ("tcbench.job.count", 3.0, 12.0), ("engine.launch", 9.0, 12.0),
              ("engine.preprocess", 9.5, 11.0))
    assert read("preprocess_share", t) == pytest.approx(100 * (0.5 + 0.5) / 10.0)
    assert read("launch_share", t) == pytest.approx(10.0)
    # jobs 0-10, named 0-0.5 and 9-10
    assert read("unnamed_share", t) == pytest.approx(85.0)


def test_overlapping_and_nested_ranges_count_once():
    t = trace(("tcbench.job.lcc", 0.0, 10.0),
              ("engine.fold", 1.0, 3.0), ("engine.fold", 2.0, 4.0), ("engine.fold", 2.5, 3.0),
              ("engine.degrees", 5.0, 7.0), ("engine.lcc_finish", 6.0, 8.0))
    assert read("fold_share", t) == pytest.approx(30.0)
    assert read("lcc_finish_share", t) == pytest.approx(30.0)
    assert read("unnamed_share", t) == pytest.approx(40.0)


def test_unnamed_is_the_rest_of_a_fully_covered_job():
    phases = [("engine.preprocess", 0.0, 1.0), ("engine.resolve", 1.0, 1.25),
              ("engine.plan", 2.0, 6.0), ("engine.fold", 7.0, 7.5)]
    t = trace(("tcbench.job.count", 0.0, 5.0), ("tcbench.job.count", 5.0, 10.0), *phases)
    named = 100 * sum(e - s for _, s, e in phases) / 10.0
    assert read("unnamed_share", t) == pytest.approx(100.0 - named)


def test_profiler_events_give_host_ranges_and_no_device_work():
    w0 = 1_000_000_000

    def ev(name, activity, on_device, s, e, thread=1):
        return (name, activity, on_device, w0 + int(s * 1e9), w0 + int(e * 1e9), thread)

    t = from_events([
        ev("tcbench.window", "user_annotation", False, 0.0, 10.0),
        ev("tcbench.job.count", "user_annotation", False, 0.0, 10.0),
        ev("engine.plan", "user_annotation", False, 1.0, 6.0),
        ev("engine.launch", "user_annotation", False, 6.0, 8.0),
        ev("engine.launch", "gpu_user_annotation", True, 6.1, 8.5),  # its mirror on the device
        ev("engine.fold", "user_annotation", False, 8.0, 9.0, thread=2),  # another thread
        ev("void intersect_csr_kernel<32, 0>", "kernel", True, 6.5, 8.5),
    ])
    assert read("launch_share", t) == pytest.approx(20.0)
    assert read("fold_share", t) is None
    assert read("unnamed_share", t) == pytest.approx(30.0)
    names = [name for name, _ in breakdown(t)["device_ops"]]
    assert names == ["void intersect_csr_kernel<32, 0>"]
    assert breakdown(t)["idle_gaps"][0] == ["engine.plan", pytest.approx(5.0)]
