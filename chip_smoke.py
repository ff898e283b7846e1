"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails loudly (non-zero exit, no final line):

1. device  — a CUDA card is required; prints its nvidia-smi name and power limit;
2. build   — builds the intersection kernels from ``csrc/`` with nvcc;
3. kernels — each CUDA kernel bit-equal to its plain PyTorch version on
             random panels (int32 and int16), all-padding rows, B = 0,
             widths 4096 and 16384, and real kron-21 panel chunks;
4. karate  — the CLI (``python -m repro_torch.launch.count``) counts 45;
5. kron-13 — 1,180,718 triangles through wedge_bsearch, panel and pallas at
             two budgets; Σ per_node and Σ edge_support = 3T through pallas;
6. kron-21 — the full-size graph (R-MAT scale 21, edge factor 16, seed 1503):
             count through auto (resolving to pallas), pallas at 2^26 and 2^24,
             wedge_bsearch at 2^26; per_node and edge_support through pallas.
             Every kernel's launch count on its run equals the run's chunks;
7. timing  — each kernel on the two largest real chunk shapes: its time
             (CUDA events, median), its bound, the plain version's time;
8. profile — the kron-21 pallas count under torch.profiler: device busy
             time by kernel against the run's wall time.

The last two lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

T13 = 1_180_718          # kronecker_rmat(13, seed=0)
T21 = 948_977_383        # kronecker_rmat(21, edge_factor=16, seed=1503)
BUDGETS_21 = (1 << 26, 1 << 24)
KERNELS = ("intersect_count", "intersect_per_node", "intersect_support")
REPLACES = {
    "intersect_count": "src/repro/kernels/triangle_count/triangle_count.py:223",
    "intersect_per_node": "src/repro/kernels/triangle_count/triangle_count.py:231",
    "intersect_support": "src/repro/kernels/triangle_count/triangle_count.py:244",
}
SOURCE = "src/repro_torch/kernels/triangle_count/csrc/intersect.cu"
# float32 outside the tensor cores, the closest published rate to the
# kernels' int32 compares (H100 SXM data sheet)
SCALAR_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj, sort_keys=True), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0].strip()
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": line, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return name, line


def memory_bytes_per_s(name: str) -> float:
    """Data-sheet memory rate of the card nvidia-smi names."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    if "H100" in name:
        return 3.35e12  # H100 SXM (80GB HBM3)
    raise SmokeFailure(f"no data-sheet memory rate known for {name!r}")


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels.triangle_count import _build

    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "ptxas" in ln and
             ("Used" in ln or "spill" in ln)]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "built": info["built"],
          "library": os.path.relpath(info["path"], HERE), "ptxas": ptxas})


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


class Compare:
    """Holds every kernel-vs-plain comparison of the run."""

    def __init__(self):
        self.max_abs_err = {k: 0 for k in KERNELS}
        self.cases = {k: 0 for k in KERNELS}

    def run(self, a, b, label: str, rows=None):
        """All three kernels on (a, b) vs their plain versions, bit for bit.

        ``rows`` restricts the plain side to those row indices (rows are
        independent), so a large real chunk is checked on a sample.
        """
        from repro_torch.kernels.triangle_count import ref
        from repro_torch.kernels.triangle_count.triangle_count import (
            intersect_count_cuda,
            intersect_per_node_cuda,
            intersect_support_cuda,
        )

        got = {
            "intersect_count": (intersect_count_cuda(a, b),),
            "intersect_per_node": intersect_per_node_cuda(a, b),
            "intersect_support": intersect_support_cuda(a, b),
        }
        torch.cuda.synchronize()
        pa, pb = (a, b) if rows is None else (a[rows], b[rows])
        want = {
            "intersect_count": (ref.intersect_count_ref(pa, pb),),
            "intersect_per_node": ref.intersect_per_node_ref(pa, pb),
            "intersect_support": ref.intersect_support_ref(pa, pb),
        }
        for k in KERNELS:
            for g, w in zip(got[k], want[k]):
                if rows is not None:
                    g = g[rows]
                check(g.dtype == torch.int32 and g.shape == w.shape,
                      f"{k} on {label}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
                err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
                self.max_abs_err[k] = max(self.max_abs_err[k], err)
                check(err == 0, f"{k} disagrees with its plain version on {label} "
                                f"(max abs err {err})")
            self.cases[k] += 1


def random_panels(rng, b, l, dtype):
    """Sorted, −1-padded rows of random length (as tests/test_kernels_triangle.py)."""
    out = np.full((b, l), -1, dtype=np.int64)
    for i in range(b):
        n = int(rng.integers(0, l + 1))
        out[i, :n] = np.sort(rng.choice(4 * l + 8, size=n, replace=False))
    return out.astype(dtype)


def phase_kernels_synthetic(cmp: Compare):
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    shapes = [(1, 8, 8), (5, 16, 64), (32, 128, 128), (9, 256, 1024), (2, 2048, 128),
              (64, 64, 32)]
    for dtype in (np.int32, np.int16):
        for b, lu, lv in shapes:
            a = torch.from_numpy(random_panels(rng, b, lu, dtype)).to(dev)
            c = torch.from_numpy(random_panels(rng, b, lv, dtype)).to(dev)
            cmp.run(a, c, f"random {b}x{lu}x{lv} {np.dtype(dtype).name}")
    pad_a = torch.full((7, 64), -1, dtype=torch.int32, device=dev)
    pad_b = torch.full((7, 32), -1, dtype=torch.int32, device=dev)
    cmp.run(pad_a, pad_b, "all-padding rows")
    mixed = torch.from_numpy(random_panels(rng, 6, 64, np.int32)).to(dev)
    mixed[::2] = -1
    cmp.run(mixed, torch.from_numpy(random_panels(rng, 6, 64, np.int32)).to(dev),
            "alternate all-padding rows")
    empty = torch.empty((0, 16), dtype=torch.int32, device=dev)
    cmp.run(empty, empty, "B = 0")
    for b, w in ((64, 4096), (8, 16384)):
        a = torch.from_numpy(random_panels(rng, b, w, np.int32)).to(dev)
        c = torch.from_numpy(random_panels(rng, b, w, np.int32)).to(dev)
        cmp.run(a, c, f"random {b}x{w}x{w} int32")
    emit({"phase": "kernels_synthetic", "cases": dict(cmp.cases), "max_abs_err": cmp.max_abs_err})


def real_chunks(csr, budget):
    """``{width: [PanelChunk, ...]}`` of the engine's panel plan at ``budget``."""
    from repro_torch.core.engine import PallasBackend, workload_from_csr

    plan = PallasBackend().plan(workload_from_csr(csr), budget)
    by_width: dict = {}
    for ch in plan.chunks:
        by_width.setdefault(ch.width, []).append(ch)
    return by_width


def gather(csr, chunk):
    from repro_torch.core.count import gather_panels_arrays

    u = torch.from_numpy(chunk.u).to(csr.device)
    v = torch.from_numpy(chunk.v).to(csr.device)
    a, b, _, _ = gather_panels_arrays(csr.row_offsets, csr.col, csr.out_degree, u, v,
                                      chunk.width)
    return a.contiguous(), b.contiguous()


def phase_kernels_real(cmp: Compare, csr, chunks):
    """Kernels vs plain on real kron-21 chunks: first and last of each bucket."""
    rng = np.random.default_rng(21)
    done = []
    for width in sorted(chunks):
        picks = chunks[width][:1] + chunks[width][-1:] if len(chunks[width]) > 1 else chunks[width]
        for ch in picks:
            a, b = gather(csr, ch)
            n = a.shape[0]
            cap = max(1, (1 << 30) // (width * width))  # plain cube ≲ 2^30 compares
            rows = None
            if n > cap:
                rows = torch.from_numpy(np.sort(rng.choice(n, size=cap, replace=False))).to(a.device)
            cmp.run(a, b, f"kron-21 chunk width {width} rows {n}", rows=rows)
            done.append({"width": width, "rows": n, "plain_rows": n if rows is None else int(rows.numel())})
    emit({"phase": "kernels_real", "chunks": done, "cases": dict(cmp.cases),
          "max_abs_err": cmp.max_abs_err})


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------


def phase_karate():
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.count",
             "--input", os.path.join(HERE, "tests", "data", "karate.txt"),
             "--json", "--cache-dir", tmp],
            capture_output=True, text=True, env=env, cwd=HERE, timeout=600,
        )
        seconds = time.perf_counter() - t0
    check(r.returncode == 0, f"karate CLI failed ({r.returncode}):\n{r.stderr[-4000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    check(out["triangles"] == 45, f"karate: CLI counted {out['triangles']}, expected 45")
    emit({"phase": "karate_cli", "triangles": out["triangles"], "method": out["method"],
          "seconds": seconds})


def run_engine(kind, edges, method, budget, reset=True):
    """One engine call on the card; returns (value, stats, seconds, launches)."""
    from repro_torch.core import TriangleCounter
    from repro_torch.kernels.triangle_count import launches, reset_launches

    tc = TriangleCounter(method=method, max_wedge_chunk=budget)
    if reset:
        reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = getattr(tc, kind)(edges)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return value, tc.last_stats, seconds, dict(launches)


def phase_kron13():
    from repro_torch.graphs import kronecker_rmat

    edges = kronecker_rmat(13, seed=0)
    runs = []
    for method in ("wedge_bsearch", "panel", "pallas"):
        for budget in (None, 1 << 16):
            t, st, sec, ln = run_engine("count", edges, method, budget)
            check(t == T13, f"kron-13 {method} budget {budget}: {t} != {T13}")
            check(st.method == method, f"kron-13: executed {st.method}, asked {method}")
            if method == "pallas":
                check(ln["intersect_count"] == st.n_chunks,
                      f"kron-13 pallas: {ln['intersect_count']} launches != {st.n_chunks} chunks")
            runs.append({"method": method, "budget": budget, "triangles": t,
                         "n_chunks": st.n_chunks, "seconds": sec})
    pn, st, _, ln = run_engine("per_node", edges, "pallas", 1 << 16)
    check(int(pn.sum()) == 3 * T13, f"kron-13 Σ per_node {int(pn.sum())} != 3T")
    check(ln["intersect_per_node"] == st.n_chunks, "kron-13 per_node launches != chunks")
    es, st, _, ln = run_engine("edge_support", edges, "pallas", 1 << 16)
    check(int(es.sum()) == 3 * T13, f"kron-13 Σ edge_support {int(es.sum())} != 3T")
    check(ln["intersect_support"] == st.n_chunks, "kron-13 support launches != chunks")
    emit({"phase": "kron13", "runs": runs, "per_node_sum": int(pn.sum()),
          "edge_support_sum": int(es.sum())})


def phase_kron21(edges):
    """The full-size main path; returns each kernel's launches on its run."""
    main_launches = {}
    runs = []

    def one(kind, method, budget, expect, kernel=None):
        torch.cuda.reset_peak_memory_stats()
        value, st, sec, ln = run_engine(kind, edges, method, budget)
        got = value if kind == "count" else int(value.sum())
        check(got == expect, f"kron-21 {kind} {method} {budget}: {got} != {expect}")
        rec = {"kind": kind, "method": method, "resolved_method": st.resolved_method,
               "executed": st.method, "budget": budget, "value": got,
               "n_chunks": st.n_chunks, "peak_wedge_buffer": st.peak_wedge_buffer,
               "seconds": sec, "timings": st.timings, "launches": ln,
               "peak_device_bytes": torch.cuda.max_memory_allocated()}
        if kernel is not None:
            check(st.method == "pallas", f"kron-21 {kind} {method}: executed {st.method}")
            check(ln[kernel] == st.n_chunks,
                  f"kron-21 {kind} {method} {budget}: {ln[kernel]} {kernel} launches "
                  f"!= {st.n_chunks} chunks")
            check(ln[kernel] > 0, f"kron-21 {kind}: {kernel} never launched")
        emit({"phase": "kron21_run", **rec})
        runs.append(rec)
        return ln

    # warm run: first-use costs (allocator, library load) stay out of the timed runs
    t0 = time.perf_counter()
    run_engine("count", edges, "pallas", BUDGETS_21[0])
    emit({"phase": "kron21_warm", "seconds": time.perf_counter() - t0})

    one("count", "auto", BUDGETS_21[0], T21, "intersect_count")
    main_launches["intersect_count"] = one(
        "count", "pallas", BUDGETS_21[0], T21, "intersect_count")["intersect_count"]
    one("count", "pallas", BUDGETS_21[1], T21, "intersect_count")
    one("count", "wedge_bsearch", BUDGETS_21[0], T21)
    main_launches["intersect_per_node"] = one(
        "per_node", "pallas", BUDGETS_21[0], 3 * T21, "intersect_per_node")["intersect_per_node"]
    main_launches["intersect_support"] = one(
        "edge_support", "pallas", BUDGETS_21[0], 3 * T21, "intersect_support")["intersect_support"]
    check(runs[0]["resolved_method"] == "pallas", "kron-21: auto did not resolve to pallas")
    return main_launches


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def bound(a, b, kind, rate):
    """Least time for the work these panels need: max(bytes, compares) bound.

    Bytes: each valid entry of a and b read once, each output written once.
    Compares: one binary search of b's valid prefix per valid a entry.
    """
    nu = (a >= 0).sum(dim=1, dtype=torch.int64)
    nv = (b >= 0).sum(dim=1, dtype=torch.int64)
    el = a.element_size()
    rows, lu = a.shape
    lv = b.shape[1]
    out = 4 * rows + (4 * rows * lu if kind != "intersect_count" else 0) + \
        (4 * rows * lv if kind == "intersect_support" else 0)
    n_bytes = el * int(nu.sum() + nv.sum()) + out
    steps = torch.ceil(torch.log2(nv.to(torch.float64) + 1))
    n_ops = int((nu.to(torch.float64) * steps).sum())
    t_bytes = n_bytes / rate
    t_ops = n_ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, n_ops


def phase_timing(csr, chunks, rate):
    from repro_torch.kernels.triangle_count import ref
    from repro_torch.kernels.triangle_count.triangle_count import (
        intersect_count_cuda,
        intersect_per_node_cuda,
        intersect_support_cuda,
    )

    cuda = {"intersect_count": intersect_count_cuda,
            "intersect_per_node": intersect_per_node_cuda,
            "intersect_support": intersect_support_cuda}
    plain = {"intersect_count": ref.intersect_count_ref,
             "intersect_per_node": ref.intersect_per_node_ref,
             "intersect_support": ref.intersect_support_ref}
    widths = sorted(chunks)[-2:]
    results = {}
    for width in widths:
        a, b = gather(csr, chunks[width][0])
        rows = a.shape[0]
        for k in KERNELS:
            ms = time_ms(lambda: cuda[k](a, b), reps=15)
            p_ms = time_ms(lambda: plain[k](a, b), reps=3, warm=1)
            b_ms, b_by, n_bytes, n_ops = bound(a, b, k, rate)
            rec = {"kernel": k, "width": width, "rows": rows, "ms": ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": n_bytes, "compares": n_ops,
                   "plain_ms": p_ms, "library_ms": None}
            emit({"phase": "timing", **rec})
            results[(k, width)] = rec
    return results, widths[-1]


# ---------------------------------------------------------------------------
# phase 8: where the device time goes
# ---------------------------------------------------------------------------


def phase_profile(edges):
    """One kron-21 pallas count under torch.profiler: device busy vs wall.

    Busy time is the sum of the device activities' self time (one stream,
    so they do not overlap); the wall clock includes the profiler's own
    host overhead, so the idle share it gives is an upper bound.
    """
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TriangleCounter

    tc = TriangleCounter(method="pallas", max_wedge_chunk=BUDGETS_21[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        t = tc.count(edges)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(t == T21, f"kron-21 profiled count {t} != {T21}")

    # the device's own activities (kernels, copies), not the host ops that
    # launched them, whose device time would count the same work twice
    rows = sorted(((ev.key, ev.self_device_time_total, ev.count)
                   for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    emit({"phase": "profile", "wall_s": wall, "timings": tc.last_stats.timings,
          "device_busy_s": busy if rows else None,
          "device_idle_share": (1.0 - busy / wall) if rows else None,
          "top_device": [{"name": k[:80], "s": us / 1e6, "calls": n} for k, us, n in rows[:8]]})


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    t_start = time.perf_counter()
    name, smi_line = phase_device()
    rate = memory_bytes_per_s(name)
    phase_build()
    cmp = Compare()
    phase_kernels_synthetic(cmp)
    phase_karate()
    phase_kron13()

    from repro_torch.core import prepare_oriented
    from repro_torch.graphs import kronecker_rmat

    t0 = time.perf_counter()
    edges = kronecker_rmat(21, edge_factor=16, seed=1503)
    emit({"phase": "kron21_generate", "seconds": time.perf_counter() - t0,
          "canonical_rows": int(edges.shape[0])})
    main_launches = phase_kron21(edges)
    phase_profile(edges)

    csr = prepare_oriented(edges, device="cuda")
    del edges
    chunks = real_chunks(csr, BUDGETS_21[0])
    phase_kernels_real(cmp, csr, chunks)
    timing, top = phase_timing(csr, chunks, rate)

    kernels = []
    for k in KERNELS:
        t = timing[(k, top)]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
            "launches": main_launches[k], "max_abs_err": cmp.max_abs_err[k],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "checked_cases": cmp.cases[k], "shape": [t["rows"], top, top],
        })
        check(main_launches[k] > 0, f"{k} was not launched on the main path")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "nvidia_smi": smi_line})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        code = 1
    sys.exit(code)
