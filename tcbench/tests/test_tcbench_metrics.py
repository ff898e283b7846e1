"""The bytes model and each metric's reader, on hand-made graphs and
synthetic profiler events."""
import pytest
import torch

from tcbench.reading import Job, Reading
from tcbench.reference import orient
from tcbench.roofline import HBM_BYTES_PER_S, intersect_bytes, least_seconds
from tcbench.run import part
from tcbench.trace import (breakdown, from_events, host_segments, idle_by_host, idle_gaps,
                           union_seconds)


def reader(name: str):
    return part("metrics", name).read


def canonical(pairs):
    fwd = torch.tensor(pairs, dtype=torch.int32)
    return torch.cat([fwd, fwd.flip(1)])


def test_bytes_on_a_hand_counted_graph():
    # a triangle 0-1-2 and a pendant edge 2-3; degrees 2, 2, 3, 1.  Oriented
    # by (degree, id): 0->1, 0->2, 1->2, 3->2; out-lists 0: [1, 2], 1: [2],
    # 2: [], 3: [2] -- 4 entries, 16 bytes.  Endpoints: 4 edges x 8 = 32.
    # Every vertex is an endpoint, so offsets 0..4 are read: 5 x 4 = 20.
    g = orient(canonical([(0, 1), (0, 2), (1, 2), (2, 3)]), 4)
    assert list(zip(g.src.tolist(), g.col.tolist())) == [(0, 1), (0, 2), (1, 2), (3, 2)]
    assert intersect_bytes(g.row_offsets, g.src, g.col, 1) == 16 + 32 + 20 + 8
    assert intersect_bytes(g.row_offsets, g.src, g.col, 4) == 16 + 32 + 20 + 32


def test_bytes_skip_offsets_no_edge_names():
    # vertices 5..9 are isolated: only the offsets of 0..4 (and 5) are read
    g = orient(canonical([(0, 1), (0, 2), (1, 2), (2, 3)]), 10)
    assert intersect_bytes(g.row_offsets, g.src, g.col, 1) == 16 + 32 + 20 + 8


def test_least_seconds_at_the_datasheet_rate():
    assert HBM_BYTES_PER_S == 3.35e12
    assert least_seconds(3.35e12) == pytest.approx(1.0)


W0 = 1_000_000_000  # window start, ns


def ev(name, activity, on_device, start_s, end_s, thread=1):
    return (name, activity, on_device, W0 + int(start_s * 1e9), W0 + int(end_s * 1e9), thread)


def synthetic_events():
    return [
        ev("tcbench.window", "user_annotation", False, 0.0, 10.0),
        ev("tcbench.job.count", "user_annotation", False, 0.0, 5.0),
        ev("tcbench.job.count", "user_annotation", False, 5.0, 10.0),
        ev("aten::copy_", "cpu_op", False, 0.9, 2.1),
        ev("cudaStreamSynchronize", "cuda_runtime", False, 6.0, 7.5),
        ev("aten::other_thread", "cpu_op", False, 3.0, 4.0, thread=2),
        # a copy that starts before the window: clipped at 0
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", True, -1.0, 1.0),
        # two overlapping kernels: their union is 2.0 - 3.5
        ev("void intersect_csr_kernel<0>(int const*)", "kernel", True, 2.0, 3.0),
        ev("void intersect_csr_kernel<0>(int const*)", "kernel", True, 2.5, 3.5),
        ev("void at::native::vectorized_elementwise_kernel", "kernel", True, 7.0, 8.0),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", True, 9.0, 9.5),
        ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", True, 9.5, 9.75),
        ev("Memset (Device)", "gpu_memset", True, 9.75, 9.8),
        # ends after the window: clipped at 10
        ev("void intersect_csr_kernel<1>(int const*)", "kernel", True, 9.9, 11.0),
        # device annotations are no work
        ev("tcbench.job.count", "gpu_user_annotation", True, 0.0, 10.0),
    ]


def jobs(plans):
    return [Job(i, i + 1, 0, {"plan": p}) for i, p in enumerate(plans)]


def reading(**kw):
    base = dict(setup_s=12.5, window_s=10.0, jobs=jobs([2.0, 3.0]), n_vertices=6,
                n_edges=14, trace=from_events(synthetic_events()), intersect_bytes=None)
    base.update(kw)
    return Reading(**base)


def test_trace_clips_to_the_window_and_drops_annotations():
    t = from_events(synthetic_events())
    assert t.window_s == pytest.approx(10.0)
    assert [op.kind for op in t.device].count("kernel") == 4
    first, last = t.device[0], t.device[-1]
    assert (first.start, first.end) == (0.0, pytest.approx(1.0))
    assert last.end == pytest.approx(10.0)
    assert all(r.name != "aten::other_thread" for r in t.host)


def test_union_of_overlapping_intervals():
    assert union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert union_seconds([]) == 0.0


def test_idle_gaps_and_what_the_host_did_meanwhile():
    t = from_events(synthetic_events())
    gaps = idle_gaps(t)
    assert [(round(a, 3), round(b, 3)) for a, b in gaps] == [
        (1.0, 2.0), (3.5, 7.0), (8.0, 9.0), (9.8, 9.9)]
    job = "tcbench.job.count: host Python or numpy"
    assert [(round(a, 3), round(b, 3), label) for a, b, label in host_segments(t)] == [
        (0.0, 0.9, job), (0.9, 2.1, "aten::copy_"), (2.1, 5.0, job), (5.0, 6.0, job),
        (6.0, 7.5, "cudaStreamSynchronize"), (7.5, 10.0, job)]
    idle = idle_by_host(t)
    # 1.0-2.0 in the copy; 3.5-6.0 and 7.5 on in the job's host code; 6.0-7.0 in the sync
    assert idle["aten::copy_"] == pytest.approx(1.0)
    assert idle["cudaStreamSynchronize"] == pytest.approx(1.0)
    assert idle[job] == pytest.approx(2.5 + 1.0 + 0.1)
    assert sum(idle.values()) == pytest.approx(10.0 - 4.4)
    b = breakdown(t)
    assert b["device_ops"][0][0].startswith("void intersect_csr_kernel<0>")
    assert b["device_ops"][0][1] == pytest.approx(2.0)
    assert b["idle_gaps"][0] == [job, pytest.approx(3.6)]


def test_idle_before_the_first_range_is_outside_any_job():
    events = [ev("tcbench.window", "user_annotation", False, 0.0, 4.0),
              ev("tcbench.job.lcc", "user_annotation", False, 1.0, 3.0),
              ev("void k", "kernel", True, 1.5, 2.0)]
    idle = idle_by_host(from_events(events))
    assert idle == {"outside any job": pytest.approx(2.0),
                    "tcbench.job.lcc: host Python or numpy": pytest.approx(1.5)}


def test_device_idle_share():
    # busy: 0-1, 2-3.5, 7-8, 9-9.8, 9.9-10 = 1 + 1.5 + 1 + 0.8 + 0.1 = 4.4
    assert reader("device_idle_share")(reading()) == pytest.approx(56.0)
    assert reader("device_idle_share")(reading(trace=None)) is None


def test_memcpy_share_counts_host_device_copies_only():
    # HtoD 0-1 and DtoH 9-9.5; the DtoD copy and the memset are left out
    assert reader("memcpy_share")(reading()) == pytest.approx(15.0)


def test_intersect_roofline_reads_the_matching_kernels():
    n_bytes = 3.35e9  # 1 ms at the datasheet rate, per job
    # two jobs: 2 ms of least time over 1.5 + 0.1 s of intersect kernels
    got = reader("intersect_roofline")(reading(intersect_bytes=n_bytes))
    assert got == pytest.approx(100 * 2e-3 / 1.6)
    assert reader("intersect_roofline")(reading()) is None


def test_intersect_roofline_reads_nothing_without_matching_kernels():
    events = [e for e in synthetic_events() if "intersect" not in e[0]]
    got = reader("intersect_roofline")(reading(trace=from_events(events), intersect_bytes=100))
    assert got is None


def test_plan_share_and_evps():
    r = reading()
    assert reader("plan_share")(r) == pytest.approx(50.0)
    assert reader("evps")(r) == pytest.approx((6 + 14) * 2 / 10.0)
    assert reader("setup_s")(r) == 12.5
    assert reader("evps")(reading(jobs=[])) is None
    assert reader("plan_share")(reading(jobs=[Job(0, 1, 0, {})])) is None


def test_no_window_range_no_trace():
    assert from_events([e for e in synthetic_events() if e[0] != "tcbench.window"]) is None


class FakeEvent:
    """A profiler event of a torch whose events carry no activity type."""

    def __init__(self, name, on_device, start_s, end_s, annotation=False):
        self._v = (name, on_device, int(start_s * 1e9), int(end_s * 1e9), annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return W0 + self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def start_thread_id(self):
        return 1

    def is_user_annotation(self):
        return self._v[4]


def test_kineto_events_without_activity_types():
    from types import SimpleNamespace

    from tcbench.trace import kineto_events

    events = [
        FakeEvent("tcbench.window", False, 0.0, 4.0, annotation=True),
        FakeEvent("tcbench.job.lcc", False, 0.0, 4.0, annotation=True),
        FakeEvent("tcbench.job.lcc", True, 0.0, 4.0),  # its mirror on the device
        FakeEvent("void intersect_csr_kernel<1>(int)", True, 1.0, 2.0),
        FakeEvent("Memcpy HtoD (Pageable -> Device)", True, 2.0, 2.5),
        FakeEvent("Memset (Device)", True, 2.5, 2.6),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t = from_events(kineto_events(prof))
    assert [op.kind for op in t.device] == ["kernel", "memcpy", "memset"]
    assert union_seconds(t.device) == pytest.approx(1.6)
