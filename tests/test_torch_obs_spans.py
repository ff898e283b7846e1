"""The engine's phase spans: ranges on the profiler's clock, events of the
obs tracer, nothing at all with neither.

CPU only, small graphs; structure only (names, order, nesting), no timing
comparisons.
"""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core import TriangleCounter  # noqa: E402
from repro_torch.graphs import kronecker_rmat  # noqa: E402

RUN_PHASES = ["engine.preprocess", "engine.resolve", "engine.workload", "engine.plan",
              "engine.launch", "engine.fold"]


@pytest.fixture(autouse=True)
def _no_tracer():
    yield
    if obs.enabled():
        obs.stop_tracing()


@pytest.fixture(scope="module")
def graph():
    return kronecker_rmat(7, seed=3)


def counter():
    return TriangleCounter(method="pallas", max_wedge_chunk=256, device="cpu")


def engine_ranges(prof):
    """``(name, start_ns, end_ns)`` of every ``engine.*`` host range, in order."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("engine.") and "CPU" in str(e.device_type())]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_count_phases_are_profiler_ranges_in_order(graph):
    tc = counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tc.count(graph)
    assert not obs.enabled()
    ranges = engine_ranges(prof)
    assert [r[0] for r in ranges] == ["engine.count", *RUN_PHASES]
    call = ranges[0]
    assert all(inside(r, call) for r in ranges[1:])
    for a, b in zip(ranges[1:], ranges[2:]):  # one after the other, none overlapping
        assert a[2] <= b[1], (a, b)
    assert tc.last_stats.n_chunks > 1


def test_clustering_phases_are_profiler_ranges_in_order(graph):
    tc = counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tc.clustering(graph)
    ranges = engine_ranges(prof)
    names = [r[0] for r in ranges]
    assert names == ["engine.clustering", "engine.degrees", "engine.per_node", *RUN_PHASES,
                     "engine.lcc_finish"]
    call, per_node = ranges[0], ranges[2]
    assert all(inside(r, call) for r in ranges[1:])
    assert all(inside(r, per_node) for r in ranges[3:-1])
    assert ranges[1][2] <= per_node[1] and per_node[2] <= ranges[-1][1]


def test_profiler_alone_never_waits(graph, monkeypatch):
    """Under the profiler with no tracer a span is a range only: its ``sync``
    is the identity and nothing synchronises."""
    def refuse(*a, **k):
        raise AssertionError("synchronised under the profiler alone")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        sp = obs.span("engine.x")
        assert sp is not obs.NOOP_SPAN
        value = object()
        with sp:
            assert sp.sync(value) is value
        counter().count(graph)


def test_no_tracer_no_profiler_records_nothing(graph, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def spy(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    assert obs.span("engine.count", cat="engine") is obs.NOOP_SPAN
    assert obs.span("anything") is obs.NOOP_SPAN
    tc = counter()
    tc.count(graph)
    tc.clustering(graph)
    assert opened == [] and obs.active() is None


def test_tracer_records_the_same_phases(graph):
    tc = counter()
    with obs.tracing(obs.Tracer(audit_compiles=False)) as t:
        tc.count(graph)
        tc.clustering(graph)
    names = [e["name"] for e in t.events if e["name"].startswith("engine.")]
    # events close inner-first
    assert names == [*RUN_PHASES, "engine.count",
                     "engine.degrees", *RUN_PHASES, "engine.per_node", "engine.lcc_finish",
                     "engine.clustering"]
    chunks = [e for e in t.events if e["name"] in ("count.chunk", "per_node.chunk")]
    assert len(chunks) == 2 * tc.last_stats.n_chunks
    for e in chunks:
        assert e["args"]["width"] > 0 and e["args"]["rows"] > 0
        assert "device_ms" not in e["args"]  # no CUDA event pair on the CPU
    assert not t._pending


def test_event_pairs_fill_device_ms_when_settled(monkeypatch):
    """The event route's plumbing, with stand-ins for the CUDA stream and
    events: no wait while the span runs, ``device_ms`` once settled."""
    log = []

    class FakeEvent:
        def __init__(self, enable_timing):
            assert enable_timing
            self.at = None

        def record(self, stream):
            self.at = len(log)
            log.append(("record", stream))

        def synchronize(self):
            log.append(("wait", self.at))

        def elapsed_time(self, end):
            return float(end.at - self.at)

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: f"stream of {device}")
    card = torch.device("cuda", 0)
    with obs.tracing(obs.Tracer(audit_compiles=False)) as t:
        for i in range(2):
            with t.span("count.chunk", args={"chunk": i}) as sp, sp.device_time(card):
                log.append(("launch", i))
        assert all(kind != "wait" for kind, _ in log)  # nothing waited while launching
        assert all("device_ms" not in e["args"] for e in t.events)
        t.settle()
        assert [e["args"]["device_ms"] for e in t.events] == [2.0, 2.0]
        with t.span("count.chunk") as sp, sp.device_time(card):
            pass
    # stop_tracing settles what is left
    assert t.events[-1]["args"]["device_ms"] == 1.0 and not t._pending
    assert log[0] == ("record", "stream of cuda:0")
