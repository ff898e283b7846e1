"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --cards``, on a machine with several cards, runs
only phase 8i's kron-21 checks over all of them: ``main_cards``.)

Phases, each of which fails loudly (non-zero exit, no final line):

1. device  — a CUDA card is required; prints its nvidia-smi name and power limit;
2. build   — builds the two kernel libraries (intersection: the panel
             kernels and the family that reads the CSR; flash attention)
             from their ``csrc/``, one nvcc per source, all started together;
3. kernels — each panel kernel bit-equal to its plain PyTorch version on
             random panels (int32 and int16), all-padding rows, B = 0,
             widths 4096 and 16384, and real kron-21 panel chunks; the three
             CSR kernels (count, per-node, support) bit-equal to their plain
             versions (gather, panel reduction and, for per-node and
             support, the scatter) on whole output vectors, on synthetic
             CSRs (du > dv and du < dv, empty lists, chunk padding, lists
             longer than the shared-memory share, outputs cut short so the
             index clipping runs) and on the whole of the first and last
             chunk of every kron-21 width bucket, where each also equals the
             panel kernel route (panel kernel, then the scatter); under every
             tuner pick (``candidate_tiles``: rows per block x lanes per row)
             at widths 16, 64, 1,024 and 4,096, the opt-in above 48 KB of
             shared memory included; picks the kernel cannot launch raise in
             the wrapper and are refused by the C entry;
4. karate  — the CLI (``python -m repro_torch.launch.count``) counts 45;
5. kron-13 — 1,180,718 triangles through wedge_bsearch, panel and pallas at
             two budgets; Σ per_node and Σ edge_support = 3T through pallas;
6. kron-21 — the full-size graph (R-MAT scale 21, edge factor 16, seed 1503):
             count through auto (resolving to pallas), pallas at 2^26 and 2^24,
             wedge_bsearch at 2^26; per_node and edge_support through pallas
             at 2^26 on the resident oriented CSR.  The pallas runs launch
             their CSR kernel once per chunk and no panel kernel.  At 2^26
             the gather route the CSR kernels replaced (panel gather, panel
             kernel, scatter) also runs on the resident CSR; each run's peak
             device memory above it is recorded, and the per-node and support
             vectors of the two routes must be equal element by element;
7. timing  — each kernel on the two largest real chunk shapes: its time
             (CUDA events, median), its bound, the plain version's time; for
             the CSR kernels also the gather route they replace; on the
             widest chunk the per-chunk zero + fold of the int32 partial;
8. profile — the kron-21 pallas count, per_node and edge_support on the
             edge list under torch.profiler: device busy time by kernel
             against wall time.  The per_node and edge_support runs are the
             main path's: each launches its CSR kernel once per chunk and no
             other kernel, and its vector equals phase 6's CSR run's;
8a. doulion — ``count_triangles_doulion`` on kron-21 through pallas at 2^26:
             p = 1.0 returns the int T21; p = 0.5 and 0.1 (seed 0) record the
             estimate, its error against T21 and its wall against phase 6's
             exact count, split into sampling and counting; at p = 0.1
             wedge_bsearch gives the same estimate.  Each pallas run launches
             the count kernel once per chunk and no other kernel;
8b. report — ``graph_report`` on the resident kron-21 CSR (auto → pallas,
             2^26, no truss): T21, Σ support = 3·T21, the transitivity from
             the edge list's degrees, the top-5 nodes and edges of phase 6's
             vectors; each CSR kernel once per chunk; the stage timings;
8c. truss  — ``k_truss_decomposition`` of kron-16 (seed 1503, 2^22) through
             pallas equals the wedge_bsearch peel (trussness, rounds, max_k);
             the support kernel launches once per chunk of every round; the
             per-round split of the wall (host plan, execute, fold, the
             sub-CSR filter and upload, the rest).  The CSR with a −1 tail as
             long as itself, pow2 buckets: the real edges' support and a zero
             tail.  On kron-12 the pallas
             trussness equals an independent scipy peel ((A·A) ∘ A);
8d. analyze_cli — ``python -m repro_torch.launch.analyze`` on karate on the
             card: 45 triangles, transitivity 135/528, max_k 5 and the
             spectrum {2: 11, 3: 42, 4: 11, 5: 14}, every stage pallas;
8e. stream — ``IncrementalTriangleCounter`` on kron-21 through pallas at
             2^26: bootstrapped on the graph without the first 8 batches of
             65,536 edges of its temporal stream (seed 0), which are then
             inserted (T21, and per_node equal to phase 6's vector) and
             deleted (back to the bootstrap's count and per_node); the first
             insert and delete equal a wedge_bsearch counter restored from
             the same state; the per-node CSR kernel launches Σ
             n_probe_launches times over the 16 updates and nothing else
             runs; probe rows with a list over kShare (1,024) are hit.  Per
             batch: wall, host merge, each probe's plan / execute / fold,
             its rows over kShare and widest width;
8f. serve_graph_cli — ``python -m repro_torch.launch.serve_graph`` on
             kron-16 on the card: 64 sliding-window batches of 4,096 through
             pallas verify against the recount; 32 batches with snapshots
             then ``--resume`` to 64 end on the same triangles and edges;
             ``--method auto`` probes on wedge_bsearch;
8g. tuning — ``AutoTuner`` on kron-21 at 2^26 with a fresh cache file: the
             cold tuner (tune_on_miss) counts T21 and gives phase 6's per-node
             and support vectors, tuning each distinct chunk shape once (count
             launches = chunks + the sweep's, exactly), the file tagged for
             this card; a warm tuner serves hits only; the count CLI with
             ``--tile-cache`` reports T21 and hits only; ``REPRO_CHECK=1``
             counts T21 (its cost recorded) and a planted 2^30 partial raises;
             per key the pick's µs against the default pick's, the count's
             execute tuned against untuned (median of 3), the tuning wall;
8h. graph_service — ``GraphService`` over a ``GraphManager`` with two
             tenants (soc-livejournal: its offline fallback kron-21, phase 6's
             graph; com-amazon: kron-16, edge factor 4) under a budget that
             holds one at a time, and 8g's tile cache: the cold attach of
             kron-21 (fallback, parse, ingest); the fusion proof (16 queries,
             one pass, T21); ``run_load`` (4 clients, DEFAULT_MIX) beside a
             support query, every count T21 and every per-node vector (and
             the clustering and transitivity from it) and the support vector
             phase 6's; a truss query on com-amazon equal to a direct peel; a
             session fed from com-amazon's edges under read load ending on a
             recount; kron-21 readmitted from its .tricsr; each CSR kernel
             launching Σ n_chunks of the passes and no panel kernel; then
             ``python -m repro_torch.serve.loadgen --dataset karate
             --attest-fusion`` (45, fused);
8i. distributed — §III-E on the card: kron-21 at 2^26 counted through
             ``make_local_mesh()`` (one stripe) and a mesh naming cuda:0 four
             times, both T21; per_node and edge_support at 4 stripes on the
             resident CSR equal phase 6's vectors, support over the uint16
             wire and the int32 one; ``n_stripes``, ``stripe_skew``,
             ``peak_wedge_buffer`` ≤ the budget, the wall and the peak above
             the resident CSR of each run; no CSR kernel launches (the
             stripes are torch ops, as the reference's are XLA).  kron-16
             counted from 4 ``.tricsr`` stripe slabs; the kron-12 truss on 4
             stripes equal to the scipy peel; 4 kron-16 batches of 4,096
             through distributed probes equal a wedge_bsearch counter; the
             count CLI (``--distributed``) and serve_graph (``--method
             distributed``, verified) on the card's local mesh;
8j. audit  — no graph pass of its own: 8c's kron-16 pallas peel and 8e's
             16 kron-21 updates each ran inside a ``CompileAuditor``; per
             kernel, the launch signatures (shapes, dtypes, width, tiles,
             wedge budget, ...) first seen in the run stay within
             factor·log2(m) + slack: the stream the reference's test bound
             (2, 4; m its live edges in both directions), the peel the
             reference's default one (4, 6; m its edges), both bounds
             printed; the run's own kernel recorded some, and no kernel
             library was built or loaded (phase 2 loaded both); ``python -m
             repro_torch.check --json`` on the checkout reports no
             unsuppressed trilint finding;
9. attention_kernel — the flash-attention kernel against its plain version
             (``flash_attention_torch``) and the dense oracle on the card: the
             reference test's five cases, a causal Sq > Skv case (its rows
             with no valid key exactly 0) and the full serving shape, in f32
             (2e-5, TF32 off, three block pairs) and bf16 (3e-2, the four
             block pairs the wgmma kernel takes); bf16 also against the exact
             result of its inputs, per query row, with a planted fault (a
             dropped kv tile) that must fail there; and at the scales 0.3, 0
             and −0.2 (f32 against the plain version, bf16 against the exact
             result);
10. lm_serve — qwen2-1.5b at full width through ``repro_torch.launch.serve``:
             batch 4, prompt 2048, 32 new tokens; the kernel's launches per
             prefill equal the layer count; finite logits, no padded vocab
             column wins; decode step 1 equals forward(prompt + token) in f32;
             every layer's kernel call of a prefill against the exact result
             of its inputs; the prefill through the kernel against the same
             prefill through the plain attention, and two planted faults
             (attention zeroed, a dropped kv tile) that must fail there;
             torch.profiler readings of the prefill and of the decode steps;
11. attention timing — the kernel at the serving shape against its bound,
             its plain version and ``scaled_dot_product_attention``.

The ``kernels`` line gives rows 1-3 an ``analytics_launches`` field: their
launches in phases 8a-8c; the count and per-node CSR kernels also a
``stream_launches`` field: the count's in 8e's bootstrap, the per-node's
over 8e's 16 updates (8f runs in its own processes); and rows 1-3
``tuning_launches`` (8g's tuned counts, per-node and support, the sweep's
launches included) and ``service_launches`` (8h, the CLI's excepted);
rows 1-3 ``audit_traces``: their new launch signatures in 8j's two runs.
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
CSR_SOURCE = "src/repro_torch/kernels/triangle_count/csrc/intersect_csr.cu"
CSR_KERNELS = ("intersect_count_csr", "intersect_per_node_csr", "intersect_support_csr")
# each CSR kernel replaces a Pallas kernel with the panel gather before it
# and, for per-node and support, the engine's scatter after it
_GATHER = "gather_panels_arrays, src/repro/core/count.py:315"
CSR_REPLACES = {
    "intersect_count_csr": f"{REPLACES['intersect_count']} (with {_GATHER})",
    "intersect_per_node_csr": f"{REPLACES['intersect_per_node']} (with {_GATHER}, and "
                              "_panel_scatter_per_node, src/repro/core/engine.py:357)",
    "intersect_support_csr": f"{REPLACES['intersect_support']} (with {_GATHER}, and "
                             "_panel_scatter_support, src/repro/core/engine.py:373)",
}
# float32 outside the tensor cores, the closest published rate to the
# kernels' int32 compares (H100 SXM data sheet)
SCALAR_OPS_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores (H100 SXM data sheet)

FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:85"
# tests/test_kernels_attention.py::CASES: (B, Hq, Hkv, Sq, Skv, D, causal)
ATTN_CASES = [
    (2, 4, 4, 128, 128, 64, True),
    (1, 8, 2, 256, 256, 128, True),
    (2, 4, 1, 64, 192, 32, False),
    (1, 2, 2, 100, 100, 64, True),
    (1, 4, 4, 96, 320, 64, True),
]
ATTN_EMPTY_ROWS = (2, 4, 2, 96, 64, 32, True)  # Sq > Skv: 32 query rows see no key
# (block_q, block_k) per dtype; the first is the default.  bf16: every pair
# the wgmma kernel takes (64 query rows per consumer warpgroup, 64- or
# 128-key tiles)
ATTN_BLOCKS = {torch.float32: ((64, 64), (16, 128), (128, 64)),
               torch.bfloat16: ((128, 128), (64, 64), (128, 64), (64, 128))}
# (rtol, atol) against the plain version: f32 as the reference's kernel test,
# bf16 as its bf16 test (the plain bf16 version rounds the scores to bf16)
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (3e-2, 3e-2)}
# softmax scales beside the default D^-0.5: zero (uniform attention over the
# valid keys) and negative (reversed), which the reference takes as well
ATTN_SCALES = (0.3, 0.0, -0.2)
# The bf16 kernel against the exact function of its inputs (the plain version
# in f32 on the same bf16 values), as the largest relative L2 error of one
# query row.  The kernel rounds P to bf16 for P·V and O to bf16, each at most
# 2^-8 relative: its worst row reads 0.0034 over every case and layer, a
# dropped 64-key tile 0.69, and the plain bf16 version (scores rounded to
# bf16) 0.011 (PERF.md).
BF16_ROW_REL_L2 = 1e-2
# the planted fault: one kv tile left out of the last q tile's softmax
FAULT_KEYS = slice(1024, 1088)

LM_ARCH = "qwen2-1.5b"
LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = 4, 2048, 32, 0
# the serving shape the kernel sees: q (4, 12, 2048, 128), k/v (4, 2, 2048, 128)
ATTN_FULL = (LM_BATCH, 12, 2, LM_PROMPT, LM_PROMPT, 128, True)
# decode step 1 against forward(prompt + token)[:, -1], f32 on both sides
# (rtol, atol as the reference's smoke-size test)
DECODE_TOL = 3e-4
# prefill logits through the kernel against the plain attention, bf16: the
# plain version rounds scores to bf16 and the kernel does not, and 28 layers
# carry the difference; bounded as a relative L2 error of the last logits,
# between the sound reading (0.0226) and the controls: one kv tile dropped
# from the last q tile in every layer (0.040), attention zeroed (0.81)
PREFILL_REL_L2 = 3e-2


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
    """The two kernel libraries, built together (one nvcc per source)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention import _build as fa_build
    from repro_torch.kernels.triangle_count import _build as tc_build

    libs = {"intersect": tc_build.LIBRARY, "flash_attention": fa_build.LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(lib.load) for lib in libs.values()]:
            fut.result()
    out = {}
    for name, lib in libs.items():
        info = lib.info()
        out[name] = {
            "nvcc_seconds": info["seconds"], "built": info["built"],
            "library": os.path.relpath(info["path"], HERE),
            "ptxas": [ln.strip() for ln in info["log"].splitlines()
                      if "ptxas" in ln and ("Used" in ln or "spill" in ln or "Compiling" in ln)],
        }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libraries": out})


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


class CsrCompare:
    """Holds every comparison of the CSR kernels with their plain versions."""

    def __init__(self):
        self.max_abs_err = {k: 0 for k in CSR_KERNELS}
        self.cases = {k: 0 for k in CSR_KERNELS}

    def _held(self, kernel, got, want, label):
        check(got.dtype == torch.int32 and got.shape == want.shape,
              f"{kernel} on {label}: {got.dtype}{tuple(got.shape)} vs {tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        check(err == 0, f"{kernel} disagrees on {label} (max abs err {err})")

    def run(self, row_offsets, col, u, v, width: int, label: str, *, edge_idx, n_out: int,
            m_out: int, panels=None):
        """The three CSR kernels on the rows (u, v) vs their plain versions,
        bit for bit, on whole output vectors.  ``panels = (a, b)`` are the
        chunk's gathered panels: each kernel must then also equal the panel
        kernel route on the same rows (the panel count; the panel per-node
        and support kernels followed by the scatter).
        """
        from repro_torch.kernels.triangle_count import ref
        from repro_torch.kernels.triangle_count import triangle_count as tc

        got = tc.intersect_count_csr_cuda(row_offsets, col, u, v, width)
        got_pn = tc.intersect_per_node_csr_cuda(row_offsets, col, u, v, width, n_out)
        got_sp = tc.intersect_support_csr_cuda(row_offsets, col, u, v, edge_idx, width, m_out)
        torch.cuda.synchronize()
        self._held("intersect_count_csr", got,
                   ref.intersect_count_csr_ref(row_offsets, col, u, v, width), label)
        self._held("intersect_per_node_csr", got_pn,
                   ref.intersect_per_node_csr_ref(row_offsets, col, u, v, width, n_out), label)
        self._held("intersect_support_csr", got_sp,
                   ref.intersect_support_csr_ref(row_offsets, col, u, v, edge_idx, width, m_out),
                   label)
        if panels is not None:
            a, b = panels
            self._held("intersect_count_csr", got, tc.intersect_count_cuda(a, b),
                       f"{label} (panel count kernel)")
            cnt, arm = tc.intersect_per_node_cuda(a, b)
            self._held("intersect_per_node_csr", got_pn,
                       ref.panel_scatter_per_node(u, v, a, cnt, arm, n_out=n_out),
                       f"{label} (panel per-node kernel + scatter)")
            cnt, arm, clo = tc.intersect_support_cuda(a, b)
            self._held("intersect_support_csr", got_sp,
                       ref.panel_scatter_support(edge_idx, u, v, row_offsets, cnt, arm, clo,
                                                 m_out=m_out),
                       f"{label} (panel support kernel + scatter)")
        for k in CSR_KERNELS:
            self.cases[k] += 1


def synthetic_csr(rng, n, max_deg, rows, long_rows=0):
    """A CSR of ``n`` nodes with sorted random out-lists of 0..max_deg entries
    (node 0 empty, node 1 at max_deg), and ``rows`` query pairs: every 7th u
    and every 11th v is −1 (chunk padding), and pairs with du > dv, du < dv
    and empty lists are present by construction.  Returns the CSR, u, v,
    query edge ids (−1 on padding rows) and the vertex count the lists name."""
    deg = rng.integers(0, max_deg + 1, size=n)
    deg[0], deg[1], deg[2] = 0, max_deg, max(1, max_deg // 3)
    deg[3:3 + long_rows] = max_deg
    ro = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col = np.concatenate([np.sort(rng.choice(3 * max_deg + 16, size=int(d), replace=False))
                          for d in deg]).astype(np.int32)
    u = rng.integers(0, n, size=rows).astype(np.int32)
    v = rng.integers(0, n, size=rows).astype(np.int32)
    u[:4], v[:4] = (1, 2, 0, 1), (2, 1, 1, 0)  # du > dv, du < dv, empty u, empty v
    u[4::7] = -1
    v[5::11] = -1
    e = np.where((u >= 0) & (v >= 0), np.arange(rows) % max(col.shape[0], 1), -1).astype(np.int32)
    n_vertices = max(n, int(col.max()) + 1 if col.size else 0)
    return [torch.from_numpy(x).to("cuda") for x in (ro, col, u, v, e)] + [n_vertices]


def phase_csr_synthetic(ccmp: CsrCompare):
    """The CSR kernels on synthetic CSRs, one per lane-group size and with
    lists past the 1024-entry shared-memory share (searched in global
    memory), including lists longer than the bucket width (cut to it); one
    case again with n_out and m_out cut to half, so the kernels clip their
    scatter indices as the plain scatter does."""
    rng = np.random.default_rng(31)
    done = []
    for n, max_deg, rows, width in ((64, 16, 1000, 16), (200, 64, 3000, 64),
                                    (300, 256, 2000, 256), (120, 1024, 700, 1024),
                                    (60, 3000, 400, 4096), (60, 3000, 400, 2048),
                                    (60, 3000, 400, 1024), (9, 40, 5, 16)):
        ro, col, u, v, e, n_vert = synthetic_csr(rng, n, max_deg, rows, long_rows=min(8, n - 3))
        label = f"synthetic n={n} max_deg={max_deg} width={width}"
        ccmp.run(ro, col, u, v, width, label, edge_idx=e, n_out=n_vert, m_out=col.shape[0])
        if width == 64:
            ccmp.run(ro, col, u, v, width, f"{label}, outputs cut to half", edge_idx=e,
                     n_out=n_vert // 2, m_out=col.shape[0] // 2)
        done.append({"n": n, "max_deg": max_deg, "rows": rows, "width": width})
    empty = torch.empty((0,), dtype=torch.int32, device="cuda")
    ro, col, _, _, _, n_vert = synthetic_csr(rng, 8, 8, 8)
    ccmp.run(ro, col, empty, empty, 16, "B = 0", edge_idx=empty, n_out=n_vert,
             m_out=col.shape[0])
    emit({"phase": "csr_synthetic", "cases": done, "checked": dict(ccmp.cases),
          "max_abs_err": dict(ccmp.max_abs_err)})


def phase_csr_tiles(ccmp: CsrCompare):
    """Every tuner pick (``candidate_tiles``) of the CSR kernels' rows per
    block and lanes per row at widths 16, 64, 1,024 and 4,096: each mode
    bit-equal to its plain version on a synthetic CSR with lists past the
    width and, at 4,096, past the shared-memory share.  Picks above 48 KB of
    shared memory run through the opt-in.  Picks the kernel cannot launch
    raise in the wrapper, and the C entry refuses them too."""
    from repro_torch.core.tuning import candidate_tiles
    from repro_torch.kernels.triangle_count import ref
    from repro_torch.kernels.triangle_count import triangle_count as tc
    from repro_torch.kernels.triangle_count._build import load_library

    rng = np.random.default_rng(37)
    done = []
    for n, max_deg, rows, width in ((64, 16, 1000, 16), (200, 64, 3000, 64),
                                    (120, 1500, 700, 1024), (60, 5000, 400, 4096)):
        ro, col, u, v, e, n_vert = synthetic_csr(rng, n, max_deg, rows, long_rows=min(8, n - 3))
        m = col.shape[0]
        want = (ref.intersect_count_csr_ref(ro, col, u, v, width),
                ref.intersect_per_node_csr_ref(ro, col, u, v, width, n_vert),
                ref.intersect_support_csr_ref(ro, col, u, v, e, width, m))
        picks = candidate_tiles(rows, width, width)
        for cfg in picks:
            got = (tc.intersect_count_csr_cuda(ro, col, u, v, width, tiles=cfg.tiles),
                   tc.intersect_per_node_csr_cuda(ro, col, u, v, width, n_vert, tiles=cfg.tiles),
                   tc.intersect_support_csr_cuda(ro, col, u, v, e, width, m, tiles=cfg.tiles))
            torch.cuda.synchronize()
            for k, g, w in zip(CSR_KERNELS, got, want):
                ccmp._held(k, g, w, f"tiles {cfg.tiles}, synthetic width {width}")
                ccmp.cases[k] += 1
        done.append({"width": width, "rows": rows, "max_deg": max_deg,
                     "picks": [list(c.tiles) for c in picks],
                     "smem_opt_in": [list(c.tiles) for c in picks
                                     if tc.csr_smem_bytes(c.block_edges, width) > 49152]})
    # (48 threads, 2,048 threads, 4 lanes, 256 KB of shared memory at 4,096)
    bad = ((3, 16), (64, 32), (8, 4), (64, 8))
    for tiles in bad:
        try:
            tc.intersect_count_csr_cuda(ro, col, u, v, width, tiles=tiles)
            raised = False
        except ValueError:
            raised = True
        check(raised, f"the CSR wrapper launched the inadmissible pick {tiles}")
    lib = load_library()
    out = torch.empty(u.shape, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    refused = {}
    for rows_pb, lanes in bad + ((0, 32), (8, 0)):
        err = lib.tc_intersect_csr_launch(0, ro.data_ptr(), col.data_ptr(), u.data_ptr(),
                                          v.data_ptr(), None, u.shape[0], width, rows_pb,
                                          lanes, out.data_ptr(), u.shape[0], stream)
        refused[f"{rows_pb}x{lanes}"] = err
        check(err != 0, f"the CSR kernel's C entry launched the inadmissible pick "
                        f"({rows_pb}, {lanes})")
    torch.cuda.synchronize()
    emit({"phase": "csr_tiles", "cases": done, "checked": dict(ccmp.cases),
          "max_abs_err": dict(ccmp.max_abs_err), "refused_cuda_errors": refused})


def real_chunks(csr, budget):
    """``{width: [PanelChunk, ...]}`` of the engine's panel plan at ``budget``."""
    from repro_torch.core.engine import PallasBackend, workload_from_csr

    plan = PallasBackend().plan(workload_from_csr(csr), budget)
    by_width: dict = {}
    for ch in plan.chunks:
        by_width.setdefault(ch.width, []).append(ch)
    return by_width


def chunk_tensors(csr, chunk):
    """The chunk's u, v and query edge ids on the card."""
    return [torch.from_numpy(x).to(csr.device) for x in (chunk.u, chunk.v, chunk.edge_idx)]


def gather(csr, chunk):
    from repro_torch.core.count import gather_panels_arrays

    u, v, _ = chunk_tensors(csr, chunk)
    a, b, _, _ = gather_panels_arrays(csr.row_offsets, csr.col, csr.out_degree, u, v,
                                      chunk.width)
    return a.contiguous(), b.contiguous()


def phase_kernels_real(cmp: Compare, ccmp: CsrCompare, csr, chunks):
    """Kernels vs plain on real kron-21 chunks: first and last of each bucket.
    The CSR kernels run on the whole chunk on both sides, at the shapes the
    main path gives them, and are also held against the panel kernel route
    (the panel kernels themselves checked here) on the same rows.  The panel
    kernels' plain side is capped to a row sample on the widest buckets."""
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
            label = f"kron-21 chunk width {width} rows {n}"
            cmp.run(a, b, label, rows=rows)
            u, v, e = chunk_tensors(csr, ch)
            t0 = time.perf_counter()
            ccmp.run(csr.row_offsets, csr.col, u, v, width, label, edge_idx=e,
                     n_out=csr.n_nodes, m_out=csr.n_directed_edges, panels=(a, b))
            done.append({"width": width, "rows": n, "csr_plain_rows": n,
                         "panel_plain_rows": n if rows is None else int(rows.numel()),
                         "csr_check_s": time.perf_counter() - t0})
    emit({"phase": "kernels_real", "chunks": done, "cases": dict(cmp.cases),
          "max_abs_err": cmp.max_abs_err, "csr_cases": dict(ccmp.cases),
          "csr_max_abs_err": dict(ccmp.max_abs_err)})


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
    """One engine call on the card (``edges``: an edge list or an oriented
    CSR); returns (value, stats, seconds, launches)."""
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
                check(ln["intersect_count_csr"] == st.n_chunks and ln["intersect_count"] == 0,
                      f"kron-13 pallas: {ln['intersect_count_csr']} CSR count launches, "
                      f"{ln['intersect_count']} panel count launches, {st.n_chunks} chunks")
            runs.append({"method": method, "budget": budget, "triangles": t,
                         "n_chunks": st.n_chunks, "seconds": sec})
    pn, st, _, ln = run_engine("per_node", edges, "pallas", 1 << 16)
    check(int(pn.sum()) == 3 * T13, f"kron-13 Σ per_node {int(pn.sum())} != 3T")
    check(ln["intersect_per_node_csr"] == st.n_chunks and ln["intersect_per_node"] == 0,
          f"kron-13 per_node: {ln['intersect_per_node_csr']} CSR launches, "
          f"{ln['intersect_per_node']} panel launches, {st.n_chunks} chunks")
    es, st, _, ln = run_engine("edge_support", edges, "pallas", 1 << 16)
    check(int(es.sum()) == 3 * T13, f"kron-13 Σ edge_support {int(es.sum())} != 3T")
    check(ln["intersect_support_csr"] == st.n_chunks and ln["intersect_support"] == 0,
          f"kron-13 support: {ln['intersect_support_csr']} CSR launches, "
          f"{ln['intersect_support']} panel launches, {st.n_chunks} chunks")
    emit({"phase": "kron13", "runs": runs, "per_node_sum": int(pn.sum()),
          "edge_support_sum": int(es.sum())})


def register_gather_route():
    """``method="pallas_gather"``: the route before the CSR kernels (panel
    gather with torch ops, the panel kernel, and for per-node and support the
    torch-ops scatter), run beside the main path for comparison only."""
    from repro_torch.core import engine

    class GatherRoute(engine.PallasBackend):
        name = "pallas_gather"
        count_chunk = engine.PanelBackend.count_chunk
        per_node_chunk = engine.PanelBackend.per_node_chunk
        support_chunk = engine.PanelBackend.support_chunk

    engine.register_backend("pallas_gather",
                            lambda widths=engine.DEFAULT_WIDTHS, **_: GatherRoute(widths))


def check_launches(ln, kernel, n_chunks, label):
    """``kernel`` launched once per chunk of the run, and no other kernel."""
    check(ln[kernel] == n_chunks,
          f"{label}: {ln[kernel]} {kernel} launches != {n_chunks} chunks")
    check(ln[kernel] > 0, f"{label}: {kernel} never launched")
    others = {k: n for k, n in ln.items() if k != kernel and n}
    check(not others, f"{label}: other kernels launched {others}")


def phase_kron21(edges, csr):
    """The full-size count on the main path, and the per-node and support
    runs on the resident CSR beside the gather route.

    ``csr`` is the graph's oriented CSR, resident on the card: the 2^26
    pallas runs and the gather route also run on it (preprocess skipped),
    so their peaks above it are the workload's own.  Returns the count's
    launches on the user's edge-list call, and the per-node and support
    vectors of the CSR runs (phase 8 holds the edge-list runs to them), and
    the seconds of the count on the edge list (DOULION's yardstick)."""
    main_launches = {}
    vectors = {}
    runs = []

    def one(kind, method, budget, expect, kernel=None, graph=edges):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        value, st, sec, ln = run_engine(kind, graph, method, budget)
        got = value if kind == "count" else int(value.sum())
        check(got == expect, f"kron-21 {kind} {method} {budget}: {got} != {expect}")
        rec = {"kind": kind, "method": method, "resolved_method": st.resolved_method,
               "executed": st.method, "budget": budget, "value": got,
               "input": "edges" if graph is edges else "oriented CSR",
               "n_chunks": st.n_chunks, "peak_wedge_buffer": st.peak_wedge_buffer,
               "seconds": sec, "timings": st.timings, "launches": ln,
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "peak_above_resident_bytes": torch.cuda.max_memory_allocated() - base,
               "resident_bytes": base}
        if kernel is not None:
            check(st.method in ("pallas", "pallas_gather"),
                  f"kron-21 {kind} {method}: executed {st.method}")
            check_launches(ln, kernel, st.n_chunks, f"kron-21 {kind} {method} {budget}")
        emit({"phase": "kron21_run", **rec})
        runs.append(rec)
        return ln, value

    # warm run: first-use costs (allocator, library load) stay out of the timed runs
    t0 = time.perf_counter()
    run_engine("count", edges, "pallas", BUDGETS_21[0])
    emit({"phase": "kron21_warm", "seconds": time.perf_counter() - t0})

    ln, _ = one("count", "auto", BUDGETS_21[0], T21, "intersect_count_csr")
    main_launches["intersect_count_csr"] = ln["intersect_count_csr"]
    main_launches["intersect_count"] = ln["intersect_count"]  # 0: the count reads the CSR
    one("count", "pallas", BUDGETS_21[0], T21, "intersect_count_csr", graph=csr)
    one("count", "pallas", BUDGETS_21[1], T21, "intersect_count_csr")
    register_gather_route()  # the old routes, for their execute time and peak memory
    one("count", "pallas_gather", BUDGETS_21[0], T21, "intersect_count", graph=csr)
    one("count", "wedge_bsearch", BUDGETS_21[0], T21)
    for kind, kernel, panel in (("per_node", "intersect_per_node_csr", "intersect_per_node"),
                                ("edge_support", "intersect_support_csr", "intersect_support")):
        _, fused = one(kind, "pallas", BUDGETS_21[0], 3 * T21, kernel, graph=csr)
        _, gathered = one(kind, "pallas_gather", BUDGETS_21[0], 3 * T21, panel, graph=csr)
        check(fused.shape == gathered.shape and np.array_equal(fused, gathered),
              f"kron-21 {kind}: the pallas vector differs from the gather route's in "
              f"{int((fused != gathered).sum())} of {fused.size} elements")
        emit({"phase": "kron21_vectors", "kind": kind, "elements": int(fused.size),
              "equal_to_gather_route": True, "sum": int(fused.sum())})
        vectors[kind] = fused
    check(runs[0]["resolved_method"] == "pallas", "kron-21: auto did not resolve to pallas")
    return main_launches, vectors, runs[0]["seconds"]


# ---------------------------------------------------------------------------
# phase 7: timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int, warm: int = 2, batch: int = 1) -> float:
    """Median milliseconds of one ``fn()`` over ``reps`` CUDA-event readings,
    each the mean of ``batch`` back-to-back calls.  With ``batch`` > 1 the
    host enqueues while the card runs, so a reading is the card's time; with
    ``batch`` = 1 it also holds the host's time to launch one call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(batch):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / batch)
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


def csr_bound(csr, u, v, width, rate, row_bytes, out=None):
    """Least time for a CSR kernel's work on this chunk.

    Bytes: each distinct list the chunk's valid rows name (cut to
    ``width``) read once, however many rows share it; ``row_bytes`` a row
    (u, v and two row_offsets pairs, 24 B; plus the count the count kernel
    writes, or the ``edge_idx`` support reads); and, given the chunk's
    per-vertex or per-edge ``out``, each slot its hits touch (the nonzero
    slots) read and written once.  Compares: one binary
    search of the longer list per entry of the shorter.
    """
    valid = (u >= 0) & (v >= 0)
    deg = (csr.row_offsets[1:] - csr.row_offsets[:-1]).to(torch.int64)
    du = torch.where(valid, deg[u.clamp(min=0).long()].clamp(max=width), 0)
    dv = torch.where(valid, deg[v.clamp(min=0).long()].clamp(max=width), 0)
    nodes = torch.unique(torch.cat([u[valid], v[valid]])).long()
    n_bytes = 4 * int(deg[nodes].clamp(max=width).sum()) + u.shape[0] * row_bytes
    if out is not None:
        n_bytes += 8 * int(torch.count_nonzero(out))
    lo, hi = torch.minimum(du, dv).to(torch.float64), torch.maximum(du, dv).to(torch.float64)
    n_ops = int((lo * torch.ceil(torch.log2(hi + 1))).sum())
    t_bytes, t_ops = n_bytes / rate, n_ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, n_ops


def phase_timing(csr, chunks, rate):
    from repro_torch.kernels.triangle_count import ref
    from repro_torch.kernels.triangle_count import triangle_count as tc

    cuda = {"intersect_count": tc.intersect_count_cuda,
            "intersect_per_node": tc.intersect_per_node_cuda,
            "intersect_support": tc.intersect_support_cuda}
    plain = {"intersect_count": ref.intersect_count_ref,
             "intersect_per_node": ref.intersect_per_node_ref,
             "intersect_support": ref.intersect_support_ref}
    n_out, m_out = csr.n_nodes, csr.n_directed_edges
    ro, col = csr.row_offsets, csr.col
    widths = sorted(chunks)[-2:]
    results = {}
    for width in widths:
        a, b = gather(csr, chunks[width][0])
        rows = a.shape[0]
        for k in KERNELS:
            ms = time_ms(lambda: cuda[k](a, b), reps=15, batch=10)
            p_ms = time_ms(lambda: plain[k](a, b), reps=3, warm=1)
            b_ms, b_by, n_bytes, n_ops = bound(a, b, k, rate)
            rec = {"kernel": k, "width": width, "rows": rows, "ms": ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": n_bytes, "compares": n_ops,
                   "plain_ms": p_ms, "library_ms": None}
            emit({"phase": "timing", **rec})
            results[(k, width)] = rec
        del a, b
        # each CSR kernel against the gather route it replaces: gather, panel
        # kernel and, for per-node and support, the torch-ops scatter
        u, v, e = chunk_tensors(csr, chunks[width][0])

        def gathered():
            pa, pb, _, _ = ref.gather_panels_arrays(ro, col, csr.out_degree, u, v, width)
            return pa, pb

        def route_count():
            return tc.intersect_count_cuda(*gathered())

        def route_per_node():
            pa, pb = gathered()
            return ref.panel_scatter_per_node(u, v, pa, *tc.intersect_per_node_cuda(pa, pb),
                                              n_out=n_out)

        def route_support():
            pa, pb = gathered()
            return ref.panel_scatter_support(e, u, v, ro, *tc.intersect_support_cuda(pa, pb),
                                             m_out=m_out)

        csr_runs = {
            "intersect_count_csr": (lambda: tc.intersect_count_csr_cuda(ro, col, u, v, width),
                                    lambda: ref.intersect_count_csr_ref(ro, col, u, v, width),
                                    route_count, 28),
            "intersect_per_node_csr": (
                lambda: tc.intersect_per_node_csr_cuda(ro, col, u, v, width, n_out),
                lambda: ref.intersect_per_node_csr_ref(ro, col, u, v, width, n_out),
                route_per_node, 24),
            "intersect_support_csr": (
                lambda: tc.intersect_support_csr_cuda(ro, col, u, v, e, width, m_out),
                lambda: ref.intersect_support_csr_ref(ro, col, u, v, e, width, m_out),
                route_support, 28),
        }
        for k, (fused, plain_fn, route, row_bytes) in csr_runs.items():
            out = fused()
            b_ms, b_by, n_bytes, n_ops = csr_bound(
                csr, u, v, width, rate, row_bytes, None if k == "intersect_count_csr" else out)
            rec = {"kernel": k, "width": width, "rows": rows,
                   "ms": time_ms(fused, reps=15, batch=10),
                   "gather_panel_ms": time_ms(route, reps=15, batch=10),
                   "ms_single_launch": time_ms(fused, reps=15),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "compares": n_ops,
                   "plain_ms": time_ms(plain_fn, reps=3, warm=1), "library_ms": None}
            if k != "intersect_count_csr":
                # the atomics: slots the hits touch, and the most hits on one slot
                rec["touched_slots"] = int(torch.count_nonzero(out))
                rec["max_slot_adds"] = int(out.max())
            emit({"phase": "timing", **rec})
            results[(k, width)] = rec
            del out
    # the engine's per-chunk zero of the int32 partial and its fold into the
    # int64 accumulator (run_workload), for per-node and for support
    for kind, n in (("per_node", n_out), ("support", m_out)):
        acc = torch.zeros((n,), dtype=torch.int64, device=csr.device)

        def zero_fold():
            acc.add_(torch.zeros((n,), dtype=torch.int32, device=csr.device))

        rec = {"phase": "zero_fold", "kind": kind, "slots": n,
               "zero_ms": time_ms(lambda: torch.zeros((n,), dtype=torch.int32,
                                                      device=csr.device), reps=15, batch=10),
               "zero_fold_ms": time_ms(zero_fold, reps=15, batch=10),
               "bytes": n * (4 + 4 + 8 + 8), "bound_ms": n * (4 + 4 + 8 + 8) / rate * 1e3}
        emit(rec)
        results[("zero_fold", kind)] = rec
        del acc
    return results, widths[-1]


# ---------------------------------------------------------------------------
# phase 8: where the device time goes
# ---------------------------------------------------------------------------


def profiled(fn):
    """``fn()`` under torch.profiler: wall time, device busy time and share idle,
    and the largest device entries.  Busy time sums the device entries' self
    time (one stream: they do not overlap); the wall clock includes the
    profiler's host overhead, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own activities (kernels, copies), not the host ops that
    # launched them, whose device time would count the same work twice
    rows = sorted(((ev.key, ev.self_device_time_total, ev.count)
                   for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    return {"wall_s": wall, "device_busy_s": busy if rows else None,
            "device_idle_share": (1.0 - busy / wall) if rows else None,
            "top_device": [{"name": k[:80], "s": us / 1e6, "calls": n} for k, us, n in rows[:10]]}


def phase_profile(edges, vectors):
    """One kron-21 pallas count, per_node and edge_support on the edge list,
    each under torch.profiler: device busy vs wall.  The per_node and
    edge_support runs are the main path's: each launches its CSR kernel once
    per chunk and no other kernel, and returns the vector of the CSR run in
    phase 6 (``vectors``).  Returns their launches."""
    from repro_torch.core import TriangleCounter
    from repro_torch.kernels.triangle_count import launches, reset_launches

    tc = TriangleCounter(method="pallas", max_wedge_chunk=BUDGETS_21[0])
    main_launches = {}
    for kind, kernel, panel in (("count", None, None),
                                ("per_node", "intersect_per_node_csr", "intersect_per_node"),
                                ("edge_support", "intersect_support_csr", "intersect_support")):
        got = {}
        reset_launches()
        rec = profiled(lambda: got.update(r=getattr(tc, kind)(edges)))
        ln = dict(launches)
        value = got["r"] if kind == "count" else int(got["r"].sum())
        expect = T21 if kind == "count" else 3 * T21
        check(value == expect, f"kron-21 profiled {kind} {value} != {expect}")
        if kernel is not None:
            check_launches(ln, kernel, tc.last_stats.n_chunks, f"kron-21 {kind} on the edge list")
            check(np.array_equal(got["r"], vectors[kind]),
                  f"kron-21 {kind}: the edge-list run and the CSR run differ")
            main_launches[kernel] = ln[kernel]
            main_launches[panel] = ln[panel]  # 0: the CSR kernel adds its hits itself
        emit({"phase": "profile", "kind": kind, "timings": tc.last_stats.timings,
              "n_chunks": tc.last_stats.n_chunks, "launches": ln, **rec})
    return main_launches


# ---------------------------------------------------------------------------
# phases 8a-8d: DOULION and the analytics path
# ---------------------------------------------------------------------------

TRUSS_SCALE, TRUSS_SEED, TRUSS_BUDGET = 16, 1503, 1 << 22
ORACLE_SCALE = 12
KARATE_SPECTRUM = {"2": 11, "3": 42, "4": 11, "5": 14}  # ROADMAP A2's gate


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class calls_recorded:
    """Records each call of the named ``TriangleCounter`` methods (``count``
    alone by default) made inside the block: its seconds (ending in a
    synchronize) and its ``last_stats``, in call order."""

    def __init__(self, *names):
        self.names = names or ("count",)

    def __enter__(self):
        from repro_torch.core.engine import TriangleCounter

        self.cls, self.calls = TriangleCounter, []
        self.real = {name: getattr(TriangleCounter, name) for name in self.names}

        def timed(real):
            def call(tc, *args, **kwargs):
                sync()
                t0 = time.perf_counter()
                value = real(tc, *args, **kwargs)
                sync()
                self.calls.append((time.perf_counter() - t0, tc.last_stats))
                return value
            return call

        for name, real in self.real.items():
            setattr(TriangleCounter, name, timed(real))
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.cls, name, real)


class rounds_recorded:
    """Times every peel round of ``k_truss_decomposition`` (its
    ``_alive_support``) and the plan / execute / fold of the support run
    inside it, by wrapping both module functions for the block."""

    def __enter__(self):
        from repro_torch.analytics import support, truss

        self.mods = (truss, support)
        self.real_round, self.real_run = truss._alive_support, support.run_workload
        self.rounds = []  # (round seconds, plan, execute, fold, alive edges)

        def run(*args, **kwargs):
            value, plan = self.real_run(*args, **kwargs)
            self._timings = plan.timings
            return value, plan

        def one_round(src0, col0, idx, *args):
            self._timings = {"plan": 0.0, "execute": 0.0, "fold": 0.0}
            t0 = time.perf_counter()
            out = self.real_round(src0, col0, idx, *args)
            sync()
            t = self._timings
            self.rounds.append((time.perf_counter() - t0, t["plan"], t["execute"], t["fold"],
                                idx.shape[0]))
            return out

        truss._alive_support, support.run_workload = one_round, run
        return self

    def __exit__(self, *exc):
        truss, support = self.mods
        truss._alive_support, support.run_workload = self.real_round, self.real_run

    def split(self, wall: float) -> dict:
        r = np.array(self.rounds, dtype=np.float64).reshape(-1, 5)
        in_rounds = float(r[:, 0].sum())
        plan, execute, fold = (float(r[:, i].sum()) for i in (1, 2, 3))
        return {"rounds_s": in_rounds, "plan_s": plan, "execute_s": execute, "fold_s": fold,
                "filter_upload_s": in_rounds - plan - execute - fold,
                "outside_rounds_s": wall - in_rounds, "edge_rounds": int(r[:, 4].sum()),
                "round_ms_median": float(np.median(r[:, 0])) * 1e3 if len(r) else None,
                "round_ms_max": float(r[:, 0].max()) * 1e3 if len(r) else None}


def phase_doulion(edges, exact_s: float, device="cuda"):
    """DOULION on kron-21 through pallas: p = 1.0 is the exact int T21; p =
    0.5 and 0.1 (seed 0) are recorded against T21 and the exact count's wall
    (phase 6); at p = 0.1 the kept edges counted by wedge_bsearch give the
    same estimate.  Each pallas run launches the count kernel once per chunk
    and nothing else.  Returns the count kernel's launches."""
    from repro_torch.core import count_triangles_doulion
    from repro_torch.kernels.triangle_count import launches, reset_launches

    total = 0
    estimates = {}
    for p, method in ((1.0, "pallas"), (0.5, "pallas"), (0.1, "pallas"), (0.1, "wedge_bsearch")):
        reset_launches()
        with calls_recorded() as rec:
            sync()
            t0 = time.perf_counter()
            est = count_triangles_doulion(edges, p=p, seed=0, method=method,
                                          max_wedge_chunk=BUDGETS_21[0], device=device)
            sync()
            wall = time.perf_counter() - t0
        ln = dict(launches)
        check(len(rec.calls) == 1, f"doulion p={p}: {len(rec.calls)} counts, expected 1")
        count_s, st = rec.calls[0]
        if method == "pallas":
            check_launches(ln, "intersect_count_csr", st.n_chunks, f"doulion p={p}")
            total += ln["intersect_count_csr"]
        else:
            check(not any(ln.values()), f"doulion p={p} wedge_bsearch launched kernels {ln}")
        if p == 1.0:
            check(type(est) is int and est == T21, f"doulion p=1.0: {est!r} != {T21}")
        estimates[(p, method)] = est
        emit({"phase": "doulion", "p": p, "seed": 0, "method": method, "estimate": est,
              "rel_err": abs(est - T21) / T21, "wall_s": wall, "sample_s": wall - count_s,
              "count_s": count_s, "count_timings": st.timings, "n_chunks": st.n_chunks,
              "kept_directed_edges": st.n_directed_edges, "exact_count_s": exact_s,
              "vs_exact": wall / exact_s, "launches": ln})
    check(estimates[(0.1, "pallas")] == estimates[(0.1, "wedge_bsearch")],
          f"doulion p=0.1: pallas {estimates[(0.1, 'pallas')]!r} != wedge_bsearch "
          f"{estimates[(0.1, 'wedge_bsearch')]!r}")
    return total


def top_k_of(per_node, support, u, v, k=5):
    """The report's top-k, read independently from whole vectors."""
    nodes = np.argsort(-per_node, kind="stable")[:k]
    edges = np.argsort(-support, kind="stable")[:k]
    return ([{"node": int(n), "triangles": int(per_node[n])} for n in nodes],
            [{"u": int(u[e]), "v": int(v[e]), "support": int(support[e])} for e in edges])


def phase_report(edges, csr, top_nodes, top_edges, device="cuda"):
    """``graph_report`` on the resident kron-21 CSR without the truss: the
    count is T21, Σ support 3·T21, the transitivity 3·T21 / Σ C(deg, 2) from
    the edge list's degrees, and the top-5 nodes and edges those of phase 6's
    vectors; each CSR kernel launches once per chunk (per-node shares the
    count's plan).  Returns the launches."""
    from repro_torch.analytics import graph_report
    from repro_torch.kernels.triangle_count import launches, reset_launches

    reset_launches()
    sync()
    t0 = time.perf_counter()
    rep = graph_report(csr, method="auto", max_wedge_chunk=BUDGETS_21[0],
                       include_truss=False, top_k=5, device=device)
    sync()
    wall = time.perf_counter() - t0
    ln = dict(launches)
    deg = np.bincount(edges[:, 0]).astype(np.int64)
    wedges = int((deg * (deg - 1) // 2).sum())
    expect = T21
    check(rep["triangles"] == expect, f"report: {rep['triangles']} triangles != {expect}")
    check(rep["support"]["sum"] == 3 * expect, f"report: Σ support {rep['support']['sum']}")
    check(rep["transitivity"] == 3.0 * expect / wedges,
          f"report: transitivity {rep['transitivity']!r} != {3.0 * expect / wedges!r}")
    check(rep["clustering"]["top_nodes"] == top_nodes,
          f"report: top nodes {rep['clustering']['top_nodes']} != {top_nodes}")
    check(rep["support"]["top_edges"] == top_edges,
          f"report: top edges {rep['support']['top_edges']} != {top_edges}")
    check(rep["engine"]["method"] == rep["support"]["method"] == "pallas",
          f"report: methods {rep['engine']['method']}, {rep['support']['method']}")
    n_chunks = rep["engine"]["n_chunks"]
    for kernel, n in (("intersect_count_csr", n_chunks), ("intersect_per_node_csr", n_chunks),
                      ("intersect_support_csr", rep["support"]["n_chunks"])):
        check(ln[kernel] == n > 0, f"report: {ln[kernel]} {kernel} launches != {n} chunks")
    check(not any(ln[k] for k in KERNELS), f"report: panel kernels launched {ln}")
    emit({"phase": "report", "wall_s": wall, "timings_s": rep["timings_s"],
          "engine_timings": rep["engine"]["timings"], "n_chunks": n_chunks,
          "support_n_chunks": rep["support"]["n_chunks"], "transitivity": rep["transitivity"],
          "average_clustering": rep["clustering"]["average"], "launches": ln})
    return {k: ln[k] for k in CSR_KERNELS}


def truss_oracle(edges):
    """Trussness per undirected edge ``(lo, hi)`` by the reference's peel
    rule, with support as ``(A·A) ∘ A`` on the alive adjacency (scipy):
    every edge below k − 2 goes in one round, and k grows when none does."""
    import scipy.sparse as sp

    und = edges[edges[:, 0] < edges[:, 1]].astype(np.int64)
    n = int(edges.max()) + 1
    key = und[:, 0] * n + und[:, 1]
    truss = np.full(len(und), 2, np.int64)
    alive = np.arange(len(und))
    k, rounds = 3, 0
    sup = None
    while alive.size:
        if sup is None:
            u, v = und[alive, 0], und[alive, 1]
            a = sp.coo_matrix((np.ones(alive.size), (u, v)), shape=(n, n)).tocsr()
            a = a + a.T
            s = (a @ a).multiply(a).tocoo()
            skey = s.row.astype(np.int64) * n + s.col
            order = np.argsort(skey)
            skey, sval = skey[order], np.asarray(s.data)[order]
            pos = np.minimum(np.searchsorted(skey, key[alive]), max(len(skey) - 1, 0))
            hit = (skey[pos] == key[alive]) if len(skey) else np.zeros(alive.size, bool)
            sup = np.where(hit, sval[pos] if len(skey) else 0, 0).astype(np.int64)
            rounds += 1
        peel = sup < k - 2
        if peel.any():
            truss[alive[peel]] = k - 1
            alive = alive[~peel]
            sup = None
        else:
            k += 1
    return dict(zip(key.tolist(), truss.tolist())), rounds


def padded_support_check(edges, device):
    """The peel's padding on the card: the whole oriented CSR with a −1 tail
    as long as itself and pow2 row buckets (so every chunk holds rows with
    u = v = edge_idx = −1) gives the engine's support on the real edges and
    0 on the tail; the support kernel launches once per chunk.  Returns its
    launches."""
    from repro_torch.analytics import support_on_arrays
    from repro_torch.core import TriangleCounter, prepare_oriented
    from repro_torch.kernels.triangle_count import launches, reset_launches

    csr = prepare_oriented(edges, device=device)
    want = TriangleCounter(method="pallas", max_wedge_chunk=TRUSS_BUDGET,
                           device=device).edge_support(csr)
    m = csr.n_directed_edges
    tail = torch.full((m,), -1, dtype=torch.int32, device=csr.device)
    reset_launches()
    run = support_on_arrays(csr.row_offsets, torch.cat([csr.src, tail]),
                            torch.cat([csr.col, tail]), csr.out_degree,
                            max_wedge_chunk=TRUSS_BUDGET, bucket_pow2=True, method="pallas",
                            device=device)
    ln = dict(launches)
    check_launches(ln, "intersect_support_csr", run.n_chunks, "padded support")
    check(np.array_equal(run.support[:m], want), "padded support differs on the real edges")
    check(not run.support[m:].any(), "padded support wrote into the −1 tail")
    emit({"phase": "truss_padding", "edges": m, "tail": m, "n_chunks": run.n_chunks,
          "peak_wedge_buffer": run.peak_wedge_buffer, "launches": ln})
    return ln["intersect_support_csr"]


def phase_truss(device="cuda"):
    """k-truss through pallas on kron-16 equals the wedge_bsearch peel
    (trussness, rounds, max_k); the support kernel launches once per chunk of
    every round and nothing else does.  On kron-12 the pallas trussness
    equals :func:`truss_oracle`.  Returns the support kernel's launches and
    the launch-signature audit of the kron-16 pallas peel (phase 8j)."""
    from repro_torch.analytics import k_truss_decomposition
    from repro_torch.check.runtime import CompileAuditor
    from repro_torch.graphs import kronecker_rmat
    from repro_torch.kernels.triangle_count import launches, reset_launches

    total = 0
    decs = {}
    scale, oracle_scale = TRUSS_SCALE, ORACLE_SCALE
    edges = kronecker_rmat(scale, edge_factor=16, seed=TRUSS_SEED)
    for method in ("pallas", "wedge_bsearch"):
        reset_launches()
        with CompileAuditor() as aud, rounds_recorded() as rec:
            sync()
            t0 = time.perf_counter()
            dec = k_truss_decomposition(edges, method=method, max_wedge_chunk=TRUSS_BUDGET,
                                        device=device)
            sync()
            wall = time.perf_counter() - t0
        if method == "pallas":
            audit = {"run": f"truss kron-{scale} pallas", "auditor": aud, "m": int(dec.n_edges),
                     "rounds": dec.rounds, "wall_s": wall}
        ln = dict(launches)
        check(dec.method == method, f"truss: executed {dec.method}, asked {method}")
        check(len(rec.rounds) == dec.rounds, f"truss: {len(rec.rounds)} rounds timed, "
                                             f"{dec.rounds} run")
        if method == "pallas":
            check_launches(ln, "intersect_support_csr", dec.n_support_launches,
                           f"truss kron-{scale}")
            total += ln["intersect_support_csr"]
        else:
            check(not any(ln.values()), f"truss wedge_bsearch launched kernels {ln}")
        decs[method] = dec
        emit({"phase": "truss", "graph": f"kron-{scale}", "method": method,
              "edges": int(dec.n_edges), "max_k": dec.max_k, "rounds": dec.rounds,
              "n_support_launches": dec.n_support_launches,
              "spectrum_size": len(dec.spectrum()), "wall_s": wall, "split": rec.split(wall),
              "launches": ln})
    total += padded_support_check(edges, device)
    a, b = decs["pallas"], decs["wedge_bsearch"]
    check(np.array_equal(a.trussness, b.trussness),
          f"truss kron-{scale}: pallas and wedge_bsearch differ on "
          f"{int((a.trussness != b.trussness).sum())} edges")
    check((a.rounds, a.max_k) == (b.rounds, b.max_k),
          f"truss kron-{scale}: rounds/max_k {(a.rounds, a.max_k)} vs {(b.rounds, b.max_k)}")

    small = kronecker_rmat(oracle_scale, edge_factor=16, seed=TRUSS_SEED)
    reset_launches()
    t0 = time.perf_counter()
    dec = k_truss_decomposition(small, method="pallas", max_wedge_chunk=TRUSS_BUDGET,
                                device=device)
    wall = time.perf_counter() - t0
    ln = dict(launches)
    check_launches(ln, "intersect_support_csr", dec.n_support_launches,
                   f"truss kron-{oracle_scale}")
    total += ln["intersect_support_csr"]
    t0 = time.perf_counter()
    want, oracle_rounds = truss_oracle(small)
    oracle_s = time.perf_counter() - t0
    n = int(small.max()) + 1
    lo = np.minimum(dec.u, dec.v).astype(np.int64)
    hi = np.maximum(dec.u, dec.v).astype(np.int64)
    got = dict(zip((lo * n + hi).tolist(), dec.trussness.tolist()))
    check(got == want, f"truss kron-{oracle_scale}: pallas differs from the scipy oracle on "
                       f"{sum(got.get(k) != t for k, t in want.items())} of {len(want)} edges")
    emit({"phase": "truss_oracle", "graph": f"kron-{oracle_scale}", "edges": len(want),
          "max_k": dec.max_k, "rounds": dec.rounds, "oracle_rounds": oracle_rounds,
          "wall_s": wall, "oracle_s": oracle_s, "launches": ln})
    return total, audit


def phase_analyze_cli():
    """``python -m repro_torch.launch.analyze`` on karate, on the card: 45
    triangles, transitivity 135/528, max_k 5 and the A2 spectrum, pallas."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.analyze",
             "--input", os.path.join(HERE, "tests", "data", "karate.txt"),
             "--json", "--cache-dir", tmp],
            capture_output=True, text=True, env=env, cwd=HERE, timeout=600,
        )
        seconds = time.perf_counter() - t0
    check(r.returncode == 0, f"analyze CLI failed ({r.returncode}):\n{r.stderr[-4000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    check(out["triangles"] == 45, f"analyze: {out['triangles']} triangles, expected 45")
    check(out["transitivity"] == 135 / 528, f"analyze: transitivity {out['transitivity']!r}")
    check(out["truss"]["max_k"] == 5, f"analyze: max_k {out['truss']['max_k']}")
    check(out["truss"]["spectrum"] == KARATE_SPECTRUM, f"analyze: {out['truss']['spectrum']}")
    check(out["engine"]["method"] == out["support"]["method"] == out["truss"]["method"]
          == "pallas", f"analyze: methods {out['engine']['method']}, {out['truss']['method']}")
    emit({"phase": "analyze_cli", "triangles": out["triangles"], "truss": out["truss"],
          "timings_s": out["timings_s"], "seconds": seconds})


# ---------------------------------------------------------------------------
# phases 8e-8f: incremental counting and the streaming service CLI
# ---------------------------------------------------------------------------

STREAM_BATCH, STREAM_BATCHES, STREAM_SEED = 65_536, 8, 0
K_SHARE = 1024  # intersect_csr.cu's kShare: longer lists are searched in global memory
SERVE_FLAGS = ["--generator", "kronecker", "--scale", "16", "--seed", "1503",
               "--stream", "sliding_window", "--batch-size", "4096",
               "--max-wedge-chunk", "4194304", "--json"]


class probes_recorded:
    """Records each probe of ``counter`` inside the block (the three of every
    update): its wall (ending in a synchronize), the engine's plan / execute /
    fold of a pallas probe, its rows, the rows whose longer list exceeds
    ``K_SHARE`` and the widest chunk width launched.  Probes of other
    counters are not recorded."""

    def __init__(self, counter):
        self.counter = counter
        self.probes = []

    def __enter__(self):
        from repro_torch.core import engine, incremental

        cls = incremental.IncrementalTriangleCounter
        self.mods = (cls, incremental, engine.PallasBackend)
        self.real = (cls._probe, incremental.run_workload, engine.PallasBackend.per_node_chunk)
        real_probe, real_run, real_chunk = self.real
        rec = self
        rec.cur = None

        def probe(ctr, pu, pv, adj):
            if ctr is not rec.counter:
                return real_probe(ctr, pu, pv, adj)
            rec.cur = {"rows": int(pu.shape[0]), "adjacency_keys": int(adj.shape[0]),
                       "plan_s": 0.0, "execute_s": 0.0, "fold_s": 0.0, "n_chunks": 0,
                       "rows_over_share": 0, "max_list": 0, "widest_width": 0}
            sync()
            t0 = time.perf_counter()
            out = real_probe(ctr, pu, pv, adj)
            sync()
            rec.cur["wall_s"] = time.perf_counter() - t0
            rec.probes.append(rec.cur)
            rec.cur = None
            return out

        def run(backend, kind, work, **kwargs):
            value, plan = real_run(backend, kind, work, **kwargs)
            if rec.cur is not None:
                deg = work.deg_host
                longer = np.maximum(deg[work.src_host], deg[work.dst_host])
                t = plan.timings
                rec.cur.update(plan_s=t["plan"], execute_s=t["execute"], fold_s=t["fold"],
                               n_chunks=plan.n_chunks,
                               rows_over_share=int((longer > K_SHARE).sum()),
                               max_list=int(longer.max()) if longer.size else 0)
            return value, plan

        def chunk(backend, adj, c, n_out):
            if rec.cur is not None:
                rec.cur["widest_width"] = max(rec.cur["widest_width"], int(c.width))
            return real_chunk(backend, adj, c, n_out)

        cls._probe, incremental.run_workload, engine.PallasBackend.per_node_chunk = (
            probe, run, chunk)
        return self

    def __exit__(self, *exc):
        cls, incremental, pallas = self.mods
        cls._probe, incremental.run_workload, pallas.per_node_chunk = self.real

    def take(self):
        out, self.probes = self.probes, []
        return out


def held_out_split(edges):
    """(the undirected edges without the held-out set, the held-out batches,
    the seconds of each step): the first ``STREAM_BATCHES`` batches of the
    port's temporal stream (over the undirected pairs, which it keeps as they
    are, so the batches are those of the edge list's stream)."""
    from repro_torch.graphs import temporal_edge_stream, undirected_pairs

    t = [time.perf_counter()]
    und = undirected_pairs(edges)
    t.append(time.perf_counter())
    held = []
    for batch in temporal_edge_stream(und, batch_size=STREAM_BATCH, seed=STREAM_SEED):
        held.append(batch.insert)
        if len(held) == STREAM_BATCHES:
            break
    t.append(time.perf_counter())
    keys = und[:, 0] << np.int64(32) | und[:, 1]  # sorted: np.unique's order
    h = np.concatenate(held)
    keep = np.ones(und.shape[0], bool)
    keep[np.searchsorted(keys, h[:, 0] << np.int64(32) | h[:, 1])] = False
    rest = und[keep]
    t.append(time.perf_counter())
    steps = dict(zip(("undirected_pairs_s", "stream_s", "mask_s"), np.diff(t).tolist()))
    return rest, held, steps


def phase_stream(edges, exact_s: float, per_node21):
    """The incremental counter on kron-21 through pallas at 2^26, on the card:
    bootstrap on the graph without the held-out batches, insert them (count
    T21, per-node equal to phase 6's vector), delete them again (back to the
    bootstrap's state).  The first insert and the first delete equal a
    wedge_bsearch counter restored from the same state.  Over the 16 updates
    the per-node CSR kernel launches Σ n_probe_launches times and no other
    kernel runs.  Returns the stream's launches of the count and per-node
    CSR kernels, and the launch-signature audit of the 16 updates (phase
    8j)."""
    from repro_torch.check.runtime import CompileAuditor
    from repro_torch.core import IncrementalTriangleCounter
    from repro_torch.kernels.triangle_count import launches, reset_launches

    import resource

    t0 = time.perf_counter()
    rest, held, split_steps = held_out_split(edges)
    split_s = time.perf_counter() - t0
    check(len(held) == STREAM_BATCHES and all(h.shape[0] == STREAM_BATCH for h in held),
          f"stream: {len(held)} held-out batches of {[h.shape[0] for h in held]}")

    reset_launches()
    with calls_recorded("count", "per_node") as calls:
        sync()
        t0 = time.perf_counter()
        ctr = IncrementalTriangleCounter(rest, method="pallas", max_wedge_chunk=BUDGETS_21[0])
        sync()
        boot_s = time.perf_counter() - t0
    boot_ln = dict(launches)
    check(len(calls.calls) == 2, f"stream bootstrap: {len(calls.calls)} engine calls")
    (count_s, count_st), (per_node_s, _) = calls.calls
    del rest
    for kernel in ("intersect_count_csr", "intersect_per_node_csr"):
        check(boot_ln[kernel] > 0, f"stream bootstrap: {kernel} never launched")
    check(not any(n for k, n in boot_ln.items()
                  if k not in ("intersect_count_csr", "intersect_per_node_csr")),
          f"stream bootstrap: other kernels launched {boot_ln}")
    count0, per_node0 = ctr.count, ctr.per_node()
    emit({"phase": "stream_bootstrap", "edges": int(ctr.n_edges), "nodes": int(ctr.n_nodes),
          "triangles": int(count0), "split_s": split_s, "split_steps": split_steps,
          "wall_s": boot_s, "count_s": count_s, "count_timings": count_st.timings,
          "per_node_s": per_node_s, "host_s": boot_s - count_s - per_node_s,
          "numpy": np.__version__, "launches": boot_ln,
          "max_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20})

    batches = []
    reset_launches()
    t_updates = time.perf_counter()
    with CompileAuditor() as aud, probes_recorded(ctr) as rec:
        for op in ("insert", "delete"):
            for i, batch in enumerate(held):
                wedge = None
                if i == 0:  # the cross-check counter: same state, no recount
                    wedge = IncrementalTriangleCounter.from_state(
                        ctr.state_dict(), method="wedge_bsearch",
                        max_wedge_chunk=BUDGETS_21[0])
                sync()
                t0 = time.perf_counter()
                delta = getattr(ctr, op)(batch)
                sync()
                wall = time.perf_counter() - t0
                st = ctr.last_update_stats
                probes = rec.take()
                check(st.op == op and st.n_batch_edges == STREAM_BATCH,
                      f"stream {op} {i}: {st.op} of {st.n_batch_edges} edges")
                check(st.probe_method == "pallas", f"stream {op} {i}: probes {st.probe_method}")
                check(len(probes) == 3, f"stream {op} {i}: {len(probes)} probes recorded")
                check(sum(p["n_chunks"] for p in probes) == st.n_probe_launches,
                      f"stream {op} {i}: chunks {[p['n_chunks'] for p in probes]} != "
                      f"{st.n_probe_launches} launches")
                cross = None
                if wedge is not None:
                    sync()
                    t1 = time.perf_counter()
                    w_delta = getattr(wedge, op)(batch)
                    sync()
                    cross = {"wedge_s": time.perf_counter() - t1, "delta": int(w_delta)}
                    check(w_delta == delta, f"stream {op} {i}: wedge_bsearch delta "
                                            f"{w_delta} != pallas {delta}")
                    check(np.array_equal(wedge.per_node(), ctr.per_node()),
                          f"stream {op} {i}: wedge_bsearch per_node differs from pallas")
                    del wedge
                rec_b = {"op": op, "batch": i, "wall_s": wall, "delta": int(delta),
                         "count": int(ctr.count), "n_probe_launches": st.n_probe_launches,
                         "peak_wedge_buffer": st.peak_wedge_buffer,
                         "host_merge_s": wall - sum(p["wall_s"] for p in probes),
                         "probes": probes, "wedge_cross_check": cross}
                emit({"phase": "stream_batch", **rec_b})
                batches.append(rec_b)
            if op == "insert":
                check(ctr.count == T21, f"stream: {ctr.count} triangles after the inserts "
                                        f"!= {T21}")
                check(np.array_equal(ctr.per_node(), per_node21),
                      "stream: per_node after the inserts differs from phase 6's vector")
    # m as the reference's incremental test counts it: the live edges in
    # both directions (current_edges())
    audit = {"run": "stream kron-21 pallas", "auditor": aud, "m": 2 * int(ctr.n_edges),
             "updates": 2 * len(held), "wall_s": time.perf_counter() - t_updates}
    ln = dict(launches)
    check(ctr.count == count0, f"stream: {ctr.count} after the deletes != bootstrap {count0}")
    check(np.array_equal(ctr.per_node(), per_node0),
          "stream: per_node after the deletes differs from the bootstrap's")
    n_launches = sum(b["n_probe_launches"] for b in batches)
    check_launches(ln, "intersect_per_node_csr", n_launches, "stream updates")
    probes = [p for b in batches for p in b["probes"]]
    over = sum(p["rows_over_share"] for p in probes)
    widest = max(p["widest_width"] for p in probes)
    check(over > 0 and widest > K_SHARE,
          f"stream: no probe row over the {K_SHARE}-entry share ({over} rows, widest {widest})")
    walls = np.array([b["wall_s"] for b in batches])
    emit({"phase": "stream", "graph": "kron-21", "batches": len(batches),
          "batch_edges": STREAM_BATCH, "update_p50_ms": float(np.percentile(walls, 50)) * 1e3,
          "update_p99_ms": float(np.percentile(walls, 99)) * 1e3,
          "edge_updates_per_s": len(batches) * STREAM_BATCH / float(walls.sum()),
          "batch_vs_exact_recount": float(np.median(walls)) / exact_s,
          "exact_count_s": exact_s, "rows_over_share": over, "probe_rows": sum(
              p["rows"] for p in probes), "widest_width": widest,
          "max_list": max(p["max_list"] for p in probes),
          "host_merge_s": sum(b["host_merge_s"] for b in batches),
          "probe_wall_s": sum(p["wall_s"] for p in probes),
          "probe_plan_s": sum(p["plan_s"] for p in probes),
          "probe_execute_s": sum(p["execute_s"] for p in probes),
          "probe_fold_s": sum(p["fold_s"] for p in probes),
          "launches": ln, "bootstrap_s": boot_s})
    return {"intersect_count_csr": boot_ln["intersect_count_csr"],
            "intersect_per_node_csr": ln["intersect_per_node_csr"]}, audit


def run_serve_cli(*flags):
    """``python -m repro_torch.launch.serve_graph`` on the card; its JSON."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_graph", *flags],
                       capture_output=True, text=True, env=env, cwd=HERE, timeout=600)
    seconds = time.perf_counter() - t0
    check(r.returncode == 0, f"serve_graph {flags} failed ({r.returncode}):\n"
                             f"{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1]), seconds


def phase_serve_graph_cli():
    """``python -m repro_torch.launch.serve_graph`` on kron-16 on the card:
    64 sliding-window batches through pallas verify against the recount;
    32 batches with snapshots, then a resume to 64, end on the uninterrupted
    run's triangles and edges; ``--method auto`` probes on wedge_bsearch."""
    def summary(out, seconds):
        return {k: out[k] for k in ("triangles", "n_edges", "n_batches", "n_inserted",
                                    "n_deleted", "verified", "probe_method", "update_p50_ms",
                                    "update_p99_ms", "updates_per_s")} | {
            "resume": out.get("resume"), "seconds": seconds}

    whole, s_whole = run_serve_cli(*SERVE_FLAGS, "--method", "pallas", "--max-batches", "64")
    check(whole["verified"] is True and whole["probe_method"] == "pallas",
          f"serve_graph: verified {whole['verified']}, probes {whole['probe_method']}")
    check(whole["n_batches"] == 64, f"serve_graph: {whole['n_batches']} batches != 64")
    with tempfile.TemporaryDirectory() as snap:
        first, s_first = run_serve_cli(*SERVE_FLAGS, "--method", "pallas", "--max-batches", "32",
                                       "--snapshot-dir", snap, "--snapshot-every", "16")
        rest, s_rest = run_serve_cli(*SERVE_FLAGS, "--method", "pallas", "--max-batches", "64",
                                     "--snapshot-dir", snap, "--resume")
    check(first["verified"] is True and rest["verified"] is True,
          f"serve_graph resume: verified {first['verified']}, {rest['verified']}")
    check(rest["resume"]["skipped_batches"] == 32,
          f"serve_graph resume: skipped {rest['resume']['skipped_batches']} != 32")
    check((rest["triangles"], rest["n_edges"]) == (whole["triangles"], whole["n_edges"]),
          f"serve_graph resume: {(rest['triangles'], rest['n_edges'])} != uninterrupted "
          f"{(whole['triangles'], whole['n_edges'])}")
    auto, s_auto = run_serve_cli(*SERVE_FLAGS, "--method", "auto", "--max-batches", "16")
    check(auto["verified"] is True and auto["probe_method"] == "wedge_bsearch",
          f"serve_graph auto: verified {auto['verified']}, probes {auto['probe_method']}")
    emit({"phase": "serve_graph_cli", "graph": "kron-16", "uninterrupted": summary(whole, s_whole),
          "first_half": summary(first, s_first), "resumed": summary(rest, s_rest),
          "auto": summary(auto, s_auto)})


# ---------------------------------------------------------------------------
# phases 8g-8h: the tuner and the multi-tenant graph service
# ---------------------------------------------------------------------------

TUNE_ITERS = 5           # timed launches per candidate (after one warm-up)
SERVICE_CLIENTS, SERVICE_REQUESTS = 4, 6
SMALL_TENANT = "com-amazon"        # offline fallback: kronecker_rmat(16, 4, seed 1503)
BIG_TENANT = "soc-livejournal"     # offline fallback: kron-21, phase 6's graph
SESSION_BATCHES, SESSION_BATCH = 4, 4096


def run_module(module, *flags):
    """``python -m module flags`` on the card; (its last JSON line, stderr, seconds)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *flags], capture_output=True, text=True,
                       env=env, cwd=HERE, timeout=600)
    seconds = time.perf_counter() - t0
    check(r.returncode == 0, f"{module} {flags} failed ({r.returncode}):\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr, seconds


def phase_tuning(csr, name, per_node21, support21):
    """The autotuner on kron-21 at 2^26 with a fresh cache file: a cold
    ``AutoTuner(tune_on_miss=True)`` counts T21 and gives phase 6's per-node
    and support vectors, tuning each distinct chunk shape once (the count
    kernel's launches are the chunks' plus the sweep's, exactly); the file
    carries the port's tag for this card; a warm tuner serves hits only; the
    count CLI with ``--tile-cache`` reports T21 and hits only; under
    ``REPRO_CHECK=1`` the count is T21 and a planted 2^30 partial raises.
    Per key: the pick's and the default pick's µs, in turns; the count's
    execute tuned against untuned (median of 3); the tuning wall.  Returns
    (the cache file, the CSR kernels' launches on the tuned path)."""
    from repro_torch.check.runtime import PARTIAL_HEADROOM, RuntimeCheckError, check_partial
    from repro_torch.core import AutoTuner, TriangleCounter
    from repro_torch.core import engine, tuning
    from repro_torch.kernels.triangle_count import launches, reset_launches
    from repro_torch.kernels.triangle_count.triangle_count import csr_default_tiles

    tmp = tempfile.mkdtemp(prefix="tiles-")
    path = os.path.join(tmp, "tiles.json")
    path_launches = {k: 0 for k in CSR_KERNELS}

    def take_launches():
        ln = dict(launches)
        for k in CSR_KERNELS:
            path_launches[k] += ln[k]
        return ln

    # 1. cold: the sweep runs inside the count; time it by wrapping autotune_tiles
    sweeps = []
    real_autotune = tuning.autotune_tiles

    def timed_autotune(*args, **kwargs):
        t0 = time.perf_counter()
        cfg = real_autotune(*args, **kwargs)
        sweeps.append((args[:3], time.perf_counter() - t0))
        return cfg

    cold = AutoTuner(path, tune_on_miss=True, iters=TUNE_ITERS)
    # every shape the engine asks the tuner for: {key: (rows, width)}
    keys, asked = {}, []
    real_tiles = cold.tiles

    def recorded_tiles(n_edges, lu, lv):
        keys[tuning.shape_key(n_edges, lu, lv)] = (n_edges, lu)
        asked.append(n_edges)
        return real_tiles(n_edges, lu, lv)

    cold.tiles = recorded_tiles
    tc = TriangleCounter(method="pallas", max_wedge_chunk=BUDGETS_21[0], tuner=cold)
    tuning.autotune_tiles = timed_autotune
    try:
        reset_launches()
        sync()
        t0 = time.perf_counter()
        got = tc.count(csr)
        sync()
        cold_s = time.perf_counter() - t0
    finally:
        tuning.autotune_tiles = real_autotune
    st = tc.last_stats
    ln = take_launches()
    check(got == T21, f"tuning: the cold tuned count {got} != {T21}")
    check(len(asked) == st.n_chunks, f"tuning: {len(asked)} lookups for {st.n_chunks} chunks")
    check(cold.n_tuned == len(keys) and len(sweeps) == len(keys),
          f"tuning: {cold.n_tuned} shapes tuned, {len(keys)} distinct keys in the plan")
    # each sweep times every candidate once to warm up and TUNE_ITERS times
    sweep_launches = sum(len(tuning.candidate_tiles(r, w, w))
                         for r, w in keys.values()) * (1 + TUNE_ITERS)
    check(ln["intersect_count_csr"] == st.n_chunks + sweep_launches,
          f"tuning: {ln['intersect_count_csr']} count launches != {st.n_chunks} chunks + "
          f"{sweep_launches} sweep launches")
    check(not any(n for k, n in ln.items() if k != "intersect_count_csr"),
          f"tuning: other kernels launched {ln}")
    payload = json.load(open(path))
    check(payload["backend"] == f"repro_torch:cuda:{name}",
          f"tuning: the cache's tag is {payload['backend']!r}")
    check(set(payload["entries"]) == set(keys), "tuning: the cache's keys are not the plan's")
    for kind, kernel, want in (("per_node", "intersect_per_node_csr", per_node21),
                               ("edge_support", "intersect_support_csr", support21)):
        reset_launches()
        value = getattr(tc, kind)(csr)
        check_launches(take_launches(), kernel, tc.last_stats.n_chunks, f"tuned {kind}")
        check(value.shape == want.shape and np.array_equal(value, want),
              f"tuning: the tuned {kind} differs from phase 6's vector")
    check(cold.n_tuned == len(keys), f"tuning: per-node/support tuned again ({cold.n_tuned})")

    # 2. warm: hits only
    warm = AutoTuner(path, tune_on_miss=False)
    reset_launches()
    got = TriangleCounter(method="pallas", max_wedge_chunk=BUDGETS_21[0], tuner=warm).count(csr)
    ln = take_launches()
    warm_hits = warm.n_hits
    check(got == T21 and warm.n_tuned == 0 and warm_hits == st.n_chunks,
          f"tuning warm: count {got}, {warm_hits} hits, {warm.n_tuned} tuned")
    check_launches(ln, "intersect_count_csr", st.n_chunks, "tuning warm count")

    # 3. the count CLI on the same cache file
    out, log, cli_s = run_module("repro_torch.launch.count", "--scale", "21", "--seed", "1503",
                                 "--max-wedge-chunk", str(BUDGETS_21[0]), "--tile-cache", path,
                                 "--json")
    counters = out["counters"]
    check(out["triangles"] == T21, f"tuning CLI: {out['triangles']} != {T21}")
    check(counters.get("tiles.cache_hits", 0) == out["stats"]["n_chunks"]
          and not counters.get("tiles.cache_misses", 0) and not counters.get("tiles.tuned", 0),
          f"tuning CLI: tile counters {dict((k, v) for k, v in counters.items() if 'tiles' in k)}")

    # 4. the count untuned, tuned and tuned under REPRO_CHECK=1, in turns:
    # the tuner's and the sanitizer's effect on execute and wall
    runs = {"untuned": [], "tuned": [], "checked": []}
    for label in ("untuned", "tuned", "checked", "tuned", "untuned", "checked", "untuned",
                  "tuned"):
        t = TriangleCounter(method="pallas", max_wedge_chunk=BUDGETS_21[0],
                            tuner=None if label == "untuned" else warm)
        if label == "checked":
            os.environ["REPRO_CHECK"] = "1"
        try:
            sync()
            t0 = time.perf_counter()
            value = t.count(csr)
            sync()
            wall = time.perf_counter() - t0
        finally:
            os.environ.pop("REPRO_CHECK", None)
        check(value == T21, f"tuning {label}: {value} != {T21}")
        runs[label].append((wall, t.last_stats.timings["execute"]))

    class Planted(engine.PallasBackend):
        def count_chunk(self, adj, chunk):
            part = super().count_chunk(adj, chunk)
            if part.numel():
                part[0] = PARTIAL_HEADROOM
            return part

    os.environ["REPRO_CHECK"] = "1"
    try:
        engine.run_workload(Planted(), "count", engine.workload_from_csr(csr),
                            budget=BUDGETS_21[0])
        planted = "not raised"
    except RuntimeCheckError as e:
        planted = str(e)
    finally:
        os.environ.pop("REPRO_CHECK", None)
    check(planted.startswith("REPRO_CHECK: count partial"), f"planted 2^30 partial: {planted}")
    try:
        check_partial(torch.tensor([0, PARTIAL_HEADROOM], dtype=torch.int32, device="cuda"),
                      kind="count")
        direct = "not raised"
    except RuntimeCheckError as e:
        direct = str(e)
    check("2^30" in direct, f"check_partial on the card: {direct}")

    # 5. per key: the pick against the default pick, in turns, on the sweep's CSR
    per_key = []
    for key, (rows, width) in sorted(keys.items()):
        pick = tuning.TileConfig(payload["entries"][key]["block_edges"],
                                 payload["entries"][key]["tlv"])
        default = tuning.TileConfig(*csr_default_tiles(width))
        timed = tuning.measure_tiles(rows, width, width, [default, pick, pick, default],
                                     iters=15, warmup=3)
        per_key.append({"key": key, "width": width, "pick": list(pick.tiles),
                        "default": list(default.tiles),
                        "pick_us": [timed[1].us, timed[2].us],
                        "default_us": [timed[0].us, timed[3].us],
                        "sweep_us": payload["entries"][key]["us"],
                        "sweep_s": next(t for a, t in sweeps
                                        if tuning.shape_key(*a) == key)})
    emit({"phase": "tuning", "graph": "kron-21", "budget": BUDGETS_21[0], "keys": len(keys),
          "n_chunks": st.n_chunks, "cold_count_s": cold_s, "cold_timings": st.timings,
          "tuning_wall_s": sum(t for _, t in sweeps), "sweep_launches": sweep_launches,
          "warm_hits": warm_hits, "cache_backend": payload["backend"],
          "cli": {"triangles": out["triangles"], "seconds": cli_s,
                  "tile_counters": {k: v for k, v in counters.items() if k.startswith("tiles.")},
                  "log": [ln_ for ln_ in log.splitlines() if "tile cache" in ln_]},
          "repro_check": {"planted": planted, "direct": direct},
          "per_key": per_key,
          **{f"{label}_wall_s": [w for w, _ in r] for label, r in runs.items()},
          **{f"{label}_execute_s": [e for _, e in r] for label, r in runs.items()},
          **{f"{label}_execute_median_s": float(np.median([e for _, e in r]))
             for label, r in runs.items()},
          "launches": path_launches})
    return path, path_launches


class workloads_recorded:
    """Sums ``n_chunks`` of every pallas workload run inside the block, by
    kind, from any thread: the engine's own, the support runs of the truss
    peel and the incremental counter's probes (each module's
    ``run_workload``)."""

    def __enter__(self):
        import threading

        from repro_torch.analytics import support
        from repro_torch.core import engine, incremental

        self.mods = (engine, support, incremental)
        self.reals = tuple(m.run_workload for m in self.mods)
        self.chunks = {"count": 0, "per_node": 0, "support": 0}
        self.passes = {"count": 0, "per_node": 0, "support": 0}
        lock = threading.Lock()
        real = self.reals[0]

        def run(backend, kind, work, **kwargs):
            value, plan = real(backend, kind, work, **kwargs)
            if backend.name == "pallas":
                with lock:
                    self.chunks[kind] += plan.n_chunks
                    self.passes[kind] += 1
            return value, plan

        for m in self.mods:
            m.run_workload = run
        return self

    def __exit__(self, *exc):
        for m, real in zip(self.mods, self.reals):
            m.run_workload = real


def phase_graph_service(csr, per_node21, support21, tile_cache):
    """The multi-tenant service on the card: a ``GraphManager`` over a
    fresh cache directory with two tenants, soc-livejournal (its offline
    fallback is kron-21, phase 6's graph) and com-amazon (kron-16, edge
    factor 4), under a memory budget that holds one of them at a time, and
    phase 8g's tile cache (no tuning).  Cold attach of kron-21 (fallback
    written, parsed and ingested); the fusion proof (16 queries, one engine
    pass, T21); ``run_load`` (4 clients, DEFAULT_MIX) beside one support
    query on kron-21, every count T21 and every per-node vector (and the
    clustering and transitivity derived from it) phase 6's; a truss query on
    com-amazon (evicting kron-21) equal to a direct peel; a session fed from
    com-amazon's edges taking update batches under read load, ending on a
    recount; kron-21 readmitted from its ``.tricsr``.  Each CSR kernel
    launches Σ n_chunks of the passes, and no panel kernel runs.  Then the
    loadgen CLI on karate.  Returns the CSR kernels' launches."""
    import threading

    from repro_torch.analytics import k_truss_decomposition
    from repro_torch.analytics.metrics import clustering_from_counts, transitivity_from_counts
    from repro_torch.core import TriangleCounter
    from repro_torch.core.engine import degree_histogram
    from repro_torch.graphs import STREAM_GENERATORS
    from repro_torch.kernels.triangle_count import launches, reset_launches
    from repro_torch.serve import DEFAULT_MIX, GraphManager, GraphService, attest_fusion, run_load

    tmp = tempfile.mkdtemp(prefix="graph-service-")
    n, m2 = csr.n_nodes, 2 * (csr.n_directed_edges)
    big_bytes = (n + 1) * 8 + m2 * 4  # the .tricsr's int64 row_offsets and int32 col
    mgr = GraphManager(os.path.join(tmp, "cache"), memory_budget_bytes=big_bytes,
                       tile_cache_path=tile_cache, tune_on_miss=False)
    svc = GraphService(mgr, method="pallas", max_wedge_chunk=BUDGETS_21[0], start=False)
    svc.attach(BIG_TENANT, BIG_TENANT)
    svc.attach(SMALL_TENANT, SMALL_TENANT)
    rec = {}
    reset_launches()
    try:
        with workloads_recorded() as work:
            t0 = time.perf_counter()
            with mgr.lease(BIG_TENANT) as ent:
                rec["cold_attach_s"] = time.perf_counter() - t0
                rec["big_nbytes"] = ent.nbytes
                ing = ent.meta["ingest"]
                # the cold attach: the fallback's generation and text write,
                # then the ingest's parse + canonicalisation, CSR build, cache write
                rec["big_ingest"] = {k: ing[k] for k in (
                    "source_kind", "raw_edges", "unique_edges", "spill_runs", "parse_s",
                    "csr_build_s", "cache_write_s")}
                rec["big_ingest"]["generate_and_write_s"] = rec["cold_attach_s"] - (
                    ing["parse_s"] + ing["csr_build_s"] + ing["cache_write_s"])
                deg, _ = degree_histogram(ent.csr)
            check(rec["big_nbytes"] == big_bytes,
                  f"service: kron-21 holds {rec['big_nbytes']} bytes, expected {big_bytes}")
            check(deg.shape == per_node21.shape, f"service: kron-21 has {deg.shape} nodes")
            want_cc = clustering_from_counts(per_node21, deg)
            want_tr = transitivity_from_counts(T21, deg)

            # every static answer is checked as it resolves, in the lane threads
            bad, seen = [], {}
            lock = threading.Lock()
            real_exec = svc._execute_static

            def execute_checked(graph, reqs, engine):
                real_exec(graph, reqs, engine)
                for r in reqs:
                    if not r.ticket.done() or r.ticket.exception(0) is not None:
                        continue
                    v = r.ticket.result(0)
                    ok = True
                    if graph == BIG_TENANT:
                        ok = {"count": lambda: v == T21,
                              "per_node": lambda: np.array_equal(v, per_node21),
                              "clustering": lambda: np.array_equal(v, want_cc),
                              "transitivity": lambda: v == want_tr,
                              "support": lambda: np.array_equal(v, support21)}.get(
                                  r.kind, lambda: True)()
                    with lock:
                        seen[(graph, r.kind)] = seen.get((graph, r.kind), 0) + 1
                        if not ok:
                            bad.append((graph, r.kind))

            svc._execute_static = execute_checked
            fusion = attest_fusion(svc, BIG_TENANT, n=16)
            check(fusion["fused"] and fusion["consistent"] and fusion["count"] == T21
                  and fusion["engine_passes"] == 1,
                  f"service: the fusion proof on kron-21 gave {fusion}")

            support_ticket = svc.submit(BIG_TENANT, "support")
            load = run_load(svc, BIG_TENANT, clients=SERVICE_CLIENTS,
                            requests_per_client=SERVICE_REQUESTS, mix=DEFAULT_MIX)
            support_ticket.result(600.0)
            rec["support_s"] = support_ticket.wait_s
            check(load["n_ok"] == SERVICE_CLIENTS * SERVICE_REQUESTS
                  and not any(load["errors"].values()), f"service: run_load {load['errors']}")

            # the small tenant: truss through the heavy lane (kron-21 evicted)
            t0 = time.perf_counter()
            truss = svc.query(SMALL_TENANT, "truss", timeout=600.0)
            rec["truss_s"] = time.perf_counter() - t0
            check(BIG_TENANT not in mgr.resident_names(),
                  f"service: kron-21 still resident beside {SMALL_TENANT}")
            with mgr.lease(SMALL_TENANT) as ent:
                small_edges = ent.csr.edge_array()
                small_n = int(ent.csr.n_nodes)
                direct = k_truss_decomposition(ent.csr, max_wedge_chunk=BUDGETS_21[0],
                                               method="pallas")
            check(np.array_equal(truss.trussness, direct.trussness) and truss.max_k ==
                  direct.max_k and truss.rounds == direct.rounds,
                  f"service: truss max_k {truss.max_k} rounds {truss.rounds} != direct "
                  f"{direct.max_k} {direct.rounds}")

            # a session fed from the small tenant's edges, under read load
            sess_name = SMALL_TENANT + "-stream"
            svc.open_session(sess_name, n_nodes=small_n)
            stream = STREAM_GENERATORS["sliding_window"](
                small_edges, window=4 * SESSION_BATCH, batch_size=SESSION_BATCH, seed=0)
            sess_load = run_load(svc, sess_name, clients=2, requests_per_client=8,
                                 update_stream=stream, max_updates=SESSION_BATCHES)
            live, live_n = svc.session(sess_name).edges_snapshot()
            sess_count = svc.session(sess_name).counter.count
            recount = TriangleCounter(method="pallas", max_wedge_chunk=BUDGETS_21[0]).count(
                live, live_n)
            check(sess_load["n_updates"] == SESSION_BATCHES and sess_count == recount,
                  f"service session: {sess_load['n_updates']} updates, count {sess_count} "
                  f"!= recount {recount}")

            # kron-21 readmitted from its .tricsr
            t0 = time.perf_counter()
            with mgr.lease(BIG_TENANT):
                rec["warm_attach_s"] = time.perf_counter() - t0
            again = svc.query(BIG_TENANT, "count", timeout=600.0)
            check(again == T21, f"service: {again} after readmission")
            stats = mgr.stats()
            check(stats["graphs"][BIG_TENANT]["loads"] == 2,
                  f"service: kron-21 loaded {stats['graphs'][BIG_TENANT]['loads']} times")
    finally:
        svc.close()
    ln = dict(launches)
    check(not bad, f"service: answers differ from phase 6's: {bad[:8]}")
    for kind, kernel in (("count", "intersect_count_csr"), ("per_node", "intersect_per_node_csr"),
                         ("support", "intersect_support_csr")):
        check(ln[kernel] == work.chunks[kind] and ln[kernel] > 0,
              f"service: {ln[kernel]} {kernel} launches != Σ n_chunks {work.chunks[kind]}")
    check(not any(ln[k] for k in KERNELS), f"service: panel kernels launched {ln}")
    counters = load["counters"]
    emit({"phase": "graph_service", "tenants": {BIG_TENANT: "kron-21", SMALL_TENANT: "kron-16 ef 4"},
          "memory_budget_bytes": big_bytes, **rec, "fusion": fusion,
          "load": {k: load[k] for k in ("clients", "requests_per_client", "n_ok", "elapsed_s",
                                        "qps", "latency", "errors", "counters")},
          "session_load": {k: sess_load[k] for k in ("n_ok", "n_updates", "elapsed_s", "qps",
                                                     "latency")},
          "session_count": int(sess_count), "truss": {"max_k": int(truss.max_k),
                                                      "rounds": int(truss.rounds)},
          "answers_checked": {f"{g}:{k}": n for (g, k), n in sorted(seen.items())},
          "fused_queries": counters["serve.fused_queries"],
          "fused_batches": counters["serve.fused_batches"],
          "engine_passes": counters["serve.engine_passes"], "pallas_passes": work.passes,
          "tuner": {"hits": mgr.tuner.n_hits, "tuned": mgr.tuner.n_tuned},
          "residency": stats, "launches": ln})

    out, _, cli_s = run_module("repro_torch.serve.loadgen", "--dataset", "karate",
                               "--attest-fusion", "--json", "--cache-dir",
                               os.path.join(tmp, "cli-cache"))
    check(out["triangles"] == 45 and out["fusion"]["fused"] is True,
          f"loadgen CLI: {out['triangles']} triangles, fusion {out['fusion']}")
    emit({"phase": "loadgen_cli", "triangles": out["triangles"], "fusion": out["fusion"],
          "qps": out["load"]["qps"], "seconds": cli_s})
    return {k: ln[k] for k in CSR_KERNELS}


# ---------------------------------------------------------------------------
# phase 8i: §III-E distributed counting
# ---------------------------------------------------------------------------

DIST_STRIPES = 4          # a mesh that names the one card four times
DIST_SCALE, DIST_SEED, DIST_BUDGET = 16, 1503, 1 << 22   # slabs, stream, CLIs
DIST_STREAM_BATCHES, DIST_STREAM_BATCH = 4, 4096


def dist_run(label, kind, graph, mesh, budget, expect=None, **kw):
    """One ``TriangleCounter(method="distributed", mesh=mesh)`` call on the
    card, with the CSR kernels' launch counts set to 0 just before it: none
    may move (the stripes are torch ops, as the reference's are XLA).
    Returns (value, record); the record is emitted."""
    from repro_torch.core import TriangleCounter
    from repro_torch.kernels.triangle_count import launches, reset_launches

    tc = TriangleCounter(method="distributed", mesh=mesh, max_wedge_chunk=budget, **kw)
    on_card = mesh.lead.type == "cuda"
    sync()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    reset_launches()
    t0 = time.perf_counter()
    value = getattr(tc, kind)(graph)
    sync()
    sec = time.perf_counter() - t0
    ln = dict(launches)
    st = tc.last_stats
    check(not any(ln.values()), f"distributed {label}: kernels launched {ln}")
    check(st.method == "distributed" and st.fallback_reason is None,
          f"distributed {label}: executed {st.method} ({st.fallback_reason})")
    check(st.n_stripes == mesh.size, f"distributed {label}: {st.n_stripes} stripes")
    check(budget is None or st.peak_wedge_buffer <= budget,
          f"distributed {label}: peak wedge buffer {st.peak_wedge_buffer} > {budget}")
    if expect is not None:
        got = value if kind == "count" else int(value.sum())
        check(got == expect, f"distributed {label}: {got} != {expect}")
    rec = {"label": label, "kind": kind, "stripes": st.n_stripes, "budget": budget,
           "n_chunks": st.n_chunks, "peak_wedge_buffer": st.peak_wedge_buffer,
           "stripe_skew": st.stripe_skew, "straggler_stripe": st.straggler_stripe,
           "seconds": sec, "timings": st.timings, "launches": ln,
           "peak_above_resident_bytes":
               torch.cuda.max_memory_allocated() - base if on_card else None}
    emit({"phase": "distributed_run", **rec})
    return value, rec


def phase_distributed(edges, csr, per_node21, support21, device="cuda"):
    """§III-E on the card (ROADMAP A6).  kron-21 at 2^26: the count through
    ``make_local_mesh()`` (one stripe) and a 4-stripe mesh on cuda:0, both
    T21; per-node and support at 4 stripes on the resident CSR equal phase
    6's vectors, support with the compressed (uint16) wire and without it;
    no CSR kernel launches in any of them.  kron-16: the count from 4
    ``.tricsr`` stripe slabs.  kron-12: the truss through the 4-stripe mesh
    equals the scipy peel.  The incremental counter: 4 kron-16 batches
    through distributed probes equal a wedge_bsearch counter.  The count
    and serve_graph CLIs on the local mesh, as a user runs them."""
    from repro_torch.analytics import k_truss_decomposition
    from repro_torch.core import (
        DistributedBackend,
        IncrementalTriangleCounter,
        TriangleCounter,
        run_workload,
        workload_from_csr,
    )
    from repro_torch.core.distributed import count_triangles_distributed_slabs
    from repro_torch.distributed import Mesh
    from repro_torch.graphs import kronecker_rmat, temporal_edge_stream, undirected_pairs
    from repro_torch.graphs.formats import canonicalize_edges, edge_array_to_csr
    from repro_torch.graphs.io import CSRGraph, load_tricsr_stripes, save_tricsr_stripes
    from repro_torch.kernels.triangle_count import launches, reset_launches
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    budget = BUDGETS_21[0]
    one = make_local_mesh(device=device)
    n_dev = torch.cuda.device_count() if device == "cuda" else 1
    check(one.size == n_dev, f"make_local_mesh: {one.size} stripes on {n_dev} device(s)")
    mesh = Mesh([device] * DIST_STRIPES)
    check(mesh.lead == csr.device, f"mesh leads on {mesh.lead}, the CSR lies on {csr.device}")
    dist_run("kron21 count, make_local_mesh", "count", edges, one, budget, T21)
    dist_run(f"kron21 count, {DIST_STRIPES} stripes", "count", edges, mesh, budget, T21)
    pn, _ = dist_run("kron21 per_node", "per_node", csr, mesh, budget, 3 * T21)
    check(np.array_equal(pn, per_node21), "distributed per_node differs from phase 6's in "
                                          f"{int((pn != per_node21).sum())} elements")
    sup, _ = dist_run("kron21 support, uint16 wire", "edge_support", csr, mesh, budget,
                      3 * T21)
    check(np.array_equal(sup, support21), "distributed support differs from phase 6's in "
                                          f"{int((sup != support21).sum())} elements")
    del pn, sup
    # the int32 wire through the backend itself (the counter always compresses)
    backend = DistributedBackend(mesh, compress=False)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    wide, plan = run_workload(backend, "support", workload_from_csr(csr), budget=budget)
    sync()
    wide_s = time.perf_counter() - t0
    check(not any(launches.values()), f"distributed wide support: kernels {dict(launches)}")
    check(np.array_equal(wide, support21), "distributed support (int32 wire) differs from "
                                           f"phase 6's in {int((wide != support21).sum())}")
    emit({"phase": "distributed_run", "label": "kron21 support, int32 wire",
          "kind": "edge_support", "stripes": plan.n_stripes, "n_chunks": plan.n_chunks,
          "peak_wedge_buffer": plan.peak_buffer, "seconds": wide_s, "timings": plan.timings})
    del wide

    # kron-16: the count from 4 stripe slabs of its .tricsr cache
    e16 = kronecker_rmat(DIST_SCALE, edge_factor=16, seed=DIST_SEED)
    t16 = TriangleCounter(method="pallas", max_wedge_chunk=DIST_BUDGET,
                          device=device).count(e16)
    row, col = edge_array_to_csr(canonicalize_edges(e16))
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "kron16.tricsr")
        save_tricsr_stripes(base, CSRGraph(row, col, row.shape[0] - 1), DIST_STRIPES)
        slabs = load_tricsr_stripes(base, DIST_STRIPES, verify=True)
        stats = {}
        reset_launches()
        t0 = time.perf_counter()
        got = count_triangles_distributed_slabs(slabs, mesh, max_wedge_chunk=DIST_BUDGET,
                                                stats_out=stats)
        sync()
        slab_s = time.perf_counter() - t0
    check(got == t16, f"kron-16 slab count {got} != {t16}")
    check(not any(launches.values()), f"kron-16 slab count: kernels {dict(launches)}")
    emit({"phase": "distributed_slabs", "graph": f"kron-{DIST_SCALE}", "slabs": DIST_STRIPES,
          "triangles": got, "seconds": slab_s, **stats})

    # kron-12: the truss on 4 stripes against the scipy peel
    small = kronecker_rmat(ORACLE_SCALE, edge_factor=16, seed=TRUSS_SEED)
    reset_launches()
    t0 = time.perf_counter()
    dec = k_truss_decomposition(small, method="distributed", mesh=mesh,
                                max_wedge_chunk=TRUSS_BUDGET)
    sync()
    truss_s = time.perf_counter() - t0
    check(dec.method == "distributed", f"distributed truss executed {dec.method}")
    check(not any(launches.values()), f"distributed truss: kernels {dict(launches)}")
    want, _ = truss_oracle(small)
    n = int(small.max()) + 1
    lo = np.minimum(dec.u, dec.v).astype(np.int64)
    hi = np.maximum(dec.u, dec.v).astype(np.int64)
    got = dict(zip((lo * n + hi).tolist(), dec.trussness.tolist()))
    check(got == want, f"distributed truss kron-{ORACLE_SCALE} differs from the scipy peel "
                       f"on {sum(got.get(k) != t for k, t in want.items())} edges")
    emit({"phase": "distributed_truss", "graph": f"kron-{ORACLE_SCALE}", "edges": len(want),
          "max_k": dec.max_k, "rounds": dec.rounds,
          "n_support_launches": dec.n_support_launches, "seconds": truss_s})

    # the incremental counter: distributed probes against wedge_bsearch probes
    und = undirected_pairs(e16)
    held = []
    for batch in temporal_edge_stream(und, batch_size=DIST_STREAM_BATCH, seed=0):
        held.append(batch.insert)
        if len(held) == DIST_STREAM_BATCHES:
            break
    keys = und[:, 0] << np.int64(32) | und[:, 1]
    h = np.concatenate(held)
    keep = np.ones(und.shape[0], bool)
    keep[np.searchsorted(keys, h[:, 0] << np.int64(32) | h[:, 1])] = False
    t0 = time.perf_counter()
    inc = IncrementalTriangleCounter(und[keep], max_wedge_chunk=DIST_BUDGET,
                                     method="distributed", mesh=mesh)
    ref = IncrementalTriangleCounter(und[keep], max_wedge_chunk=DIST_BUDGET,
                                     method="wedge_bsearch", device=device)
    boot_s = time.perf_counter() - t0
    check(inc.count == ref.count, f"distributed bootstrap {inc.count} != {ref.count}")
    updates = []
    reset_launches()
    for i, batch in enumerate(held):
        sync()
        t0 = time.perf_counter()
        d = inc.insert(batch)
        sync()
        sec = time.perf_counter() - t0
        check(d == ref.insert(batch) and inc.count == ref.count,
              f"distributed insert {i}: {d}, count {inc.count} != {ref.count}")
        check(np.array_equal(inc.per_node(), ref.per_node()),
              f"distributed insert {i}: per_node differs")
        st = inc.last_update_stats
        check(st.probe_method == "distributed", f"insert {i} probed on {st.probe_method}")
        updates.append({"delta": d, "seconds": sec, "n_probe_launches": st.n_probe_launches,
                        "peak_wedge_buffer": st.peak_wedge_buffer})
    check(inc.count == t16, f"after the inserts {inc.count} != kron-16's {t16}")
    check(not any(launches.values()), f"distributed probes: kernels {dict(launches)}")
    emit({"phase": "distributed_stream", "graph": f"kron-{DIST_SCALE}",
          "batch": DIST_STREAM_BATCH, "bootstrap_s": boot_s, "updates": updates})

    # the CLIs, at small scale
    flags = ["--generator", "kronecker", "--scale", str(DIST_SCALE), "--seed", str(DIST_SEED),
             "--max-wedge-chunk", str(DIST_BUDGET), "--device", device, "--json"]
    out, err, cli_s = run_module("repro_torch.launch.count", *flags, "--distributed")
    check(out["triangles"] == t16 and out["method"] == "distributed",
          f"count --distributed: {out['triangles']} via {out['method']}")
    check(f"mesh: {n_dev} stripe(s) on {n_dev} device(s)" in err, "count CLI: no mesh line")
    serve, serve_s = run_serve_cli(
        "--generator", "kronecker", "--scale", "12", "--seed", str(DIST_SEED),
        "--stream", "sliding_window", "--batch-size", "1024", "--max-batches", "8",
        "--max-wedge-chunk", str(DIST_BUDGET), "--method", "distributed",
        "--device", device, "--json")
    check(serve["verified"] is True and serve["probe_method"] == "distributed",
          f"serve_graph distributed: verified {serve['verified']}, "
          f"probes {serve['probe_method']}")
    emit({"phase": "distributed_cli", "count_s": cli_s, "count_triangles": out["triangles"],
          "serve_s": serve_s, "serve_triangles": serve["triangles"],
          "serve_update_p50_ms": serve["update_p50_ms"],
          "phase_s": time.perf_counter() - t_phase})


def phase_distributed_cards(edges, csr, per_node21, support21):
    """§III-E over every visible card (``--cards``, on a machine with more
    than one): kron-21 at 2^26 counted on one stripe of the lead card, on 4
    stripes of it and over ``make_local_mesh()`` (one stripe a card), T21
    each; per-node and support (both wires) over the cards equal the
    pallas vectors; no CSR kernel launches.  Returns the runs' records."""
    from repro_torch.core import DistributedBackend, run_workload, workload_from_csr
    from repro_torch.distributed import Mesh
    from repro_torch.launch.mesh import make_local_mesh

    budget = BUDGETS_21[0]
    cards = make_local_mesh()
    check(cards.size == torch.cuda.device_count() > 1,
          f"--cards needs several cards, make_local_mesh() has {cards.size}")
    lead = csr.device
    recs = []
    for label, mesh in (("1 stripe, lead card", Mesh([lead])),
                        (f"{DIST_STRIPES} stripes, lead card", Mesh([lead] * DIST_STRIPES)),
                        (f"{cards.size} cards", cards)):
        recs.append(dist_run(f"kron21 count, {label}", "count", edges, mesh, budget, T21)[1])
    pn, rec = dist_run(f"kron21 per_node, {cards.size} cards", "per_node", csr, cards, budget,
                       3 * T21)
    check(np.array_equal(pn, per_node21), "per_node over the cards differs from pallas")
    sup, rec2 = dist_run(f"kron21 support, {cards.size} cards", "edge_support", csr, cards,
                         budget, 3 * T21)
    check(np.array_equal(sup, support21), "support over the cards differs from pallas")
    sync()
    t0 = time.perf_counter()
    wide, _ = run_workload(DistributedBackend(cards, compress=False), "support",
                           workload_from_csr(csr), budget=budget)
    sync()
    check(np.array_equal(wide, support21), "int32-wire support over the cards differs")
    emit({"phase": "distributed_run", "label": f"kron21 support, int32 wire, {cards.size} cards",
          "seconds": time.perf_counter() - t0})
    return recs + [rec, rec2]


# ---------------------------------------------------------------------------
# phase 8j: the launch-signature audit and trilint
# ---------------------------------------------------------------------------

# each kernel may see at most factor·log2(m) + slack distinct launch
# signatures in a run (CompileAuditor.assert_log_bound).  The stream is held
# to the reference's test factors (tests/test_compile_audit.py); the kron-16
# peel to the reference's default ones (assert_log_bound's), because its
# support-kernel signatures multiply three pow2 axes (the live edges'
# padded length, the width bucket, the rows), which grows as log²m: on an
# NVIDIA H100 80GB HBM3 (700 W) the peel launched 46 distinct ones, over
# the test bound of 43 (PERF.md §6).  Both bounds are printed for both runs.
AUDIT_TEST_FACTORS = (2.0, 4)
AUDIT_DEFAULT_FACTORS = (4.0, 6)
AUDIT_FACTORS = {"truss": AUDIT_DEFAULT_FACTORS, "stream": AUDIT_TEST_FACTORS}
# the kernel each audited run must have launched
AUDIT_KERNEL = {"truss": "intersect_support_csr", "stream": "intersect_per_node_csr"}


def audit_bound(m: int, factors) -> int:
    factor, slack = factors
    return int(factor * np.log2(max(int(m), 2)) + slack)


def signature_axes(sigs) -> dict:
    """How many distinct values each part of a kernel's new signatures takes:
    ``arg<i>`` the i-th tensor's shape and dtype, and each static argument."""
    axes = {}
    for traced, static in sigs:
        for i, t in enumerate(traced):
            axes.setdefault(f"arg{i}", set()).add(repr(t))
        for k, v in static:
            axes.setdefault(k, set()).add(repr(v))
    return {k: len(v) for k, v in axes.items()}


def record_cost_us(reps: int = 20_000) -> dict:
    """Host µs one launch spends recording its signature, on the card's
    tensors: a CSR kernel's record (``record_csr_launch``) and a torch-ops
    chunk kernel's (``records_launches`` around a function that returns at
    once), each under a probe name no kernel uses."""
    from repro_torch.check.runtime import records_launches
    from repro_torch.kernels.triangle_count.triangle_count import record_csr_launch

    row, col, u, v = (torch.zeros(n, dtype=torch.int32, device="cuda")
                      for n in (2, 1, 65_536, 65_536))

    @records_launches("audit_cost_probe_chunk", static=("wedge_budget", "n_steps"))
    def chunk_probe(src_e, dst_e, row_offsets, col, out_deg, *, wedge_budget, n_steps):
        return None

    out = {}
    for name, call in (
        ("csr_kernel", lambda: record_csr_launch("audit_cost_probe_csr", row, col, u, v, None,
                                                 1024, 65_536, None)),
        ("chunk_kernel", lambda: chunk_probe(u, v, row, col, row, wedge_budget=1 << 26,
                                             n_steps=10)),
    ):
        call()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def phase_audit(audits):
    """8c's kron-16 pallas peel and 8e's 16 kron-21 updates, each run inside a
    ``CompileAuditor``: per kernel, the launch signatures first seen in the
    run against ``factor·log2(m) + slack`` (``AUDIT_FACTORS``), how many
    values each part of them took, and no kernel library built or loaded
    there (phase 2 loaded both); the host µs a launch spends recording
    (:func:`record_cost_us`).  Then ``python -m repro_torch.check --json``
    on the checkout reports no unsuppressed finding.  Returns ``{run:
    {kernel: new signatures}}``."""
    from repro_torch.check.runtime import RuntimeCheckError

    out = {}
    for key, a in audits.items():
        aud = a["auditor"]
        traces = {k: v for k, v in aud.new_traces.items() if v}
        builds = {k: v for k, v in aud.new_builds.items() if v}
        factor, slack = AUDIT_FACTORS[key]
        bound = audit_bound(a["m"], AUDIT_FACTORS[key])
        emit({"phase": "audit", "run": a["run"], "m": a["m"], "factor": factor, "slack": slack,
              "bound": bound, "test_bound": audit_bound(a["m"], AUDIT_TEST_FACTORS),
              "default_bound": audit_bound(a["m"], AUDIT_DEFAULT_FACTORS),
              "new_traces": traces, "new_builds": builds,
              "axes": {k: signature_axes(sigs) for k, sigs in aud.new_signatures.items() if sigs},
              **{k: v for k, v in a.items() if k not in ("run", "auditor", "m")}})
        try:
            check(aud.assert_log_bound(a["m"], factor=factor, slack=slack) == bound,
                  f"audit {a['run']}: bound differs from {bound}")
        except RuntimeCheckError as e:
            raise SmokeFailure(f"audit {a['run']}: {e}") from e
        check(traces.get(AUDIT_KERNEL[key], 0) > 0,
              f"audit {a['run']}: {AUDIT_KERNEL[key]} recorded no launch signature")
        check(not builds, f"audit {a['run']}: kernel libraries built or loaded {builds}")
        out[key] = traces
    emit({"phase": "audit_cost", "record_us": record_cost_us()})

    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.check", "--json"],
                       capture_output=True, text=True, env=env, cwd=HERE, timeout=300)
    seconds = time.perf_counter() - t0
    check(r.returncode == 0, f"trilint failed ({r.returncode}):\n{r.stdout[-4000:]}"
                             f"{r.stderr[-4000:]}")
    report = json.loads(r.stdout)
    check(report["counts"]["unsuppressed"] == 0, f"trilint: {report['counts']}")
    emit({"phase": "trilint", "counts": report["counts"], "passes": report["passes"],
          "allowlist": os.path.relpath(report["allowlist"], HERE) if report["allowlist"]
          else None, "seconds": seconds})
    return out


# ---------------------------------------------------------------------------
# phase 9: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------


def attn_inputs(rng, case, dtype):
    b, hq, hkv, sq, skv, d, _ = case
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(size=shape, dtype=np.float32)).to("cuda", dtype)
    return mk(b, hq, sq, d), mk(b, hkv, skv, d), mk(b, hkv, skv, d)


def compare(got, want, dtype):
    """(max abs error, within tolerance) as numpy's assert_allclose reads it."""
    rtol, atol = ATTN_TOL[dtype]
    g, w = got.to(torch.float32), want.to(torch.float32)
    err = (g - w).abs()
    return float(err.max()), bool((err <= atol + rtol * w.abs()).all())


def row_rel_l2(got, want):
    """Largest relative L2 error of one query row (the last axis).  A row with
    no valid key is 0 in ``want`` and must be 0 in ``got``."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-6)).max())


def bf16_readings(got, exact):
    """The bf16 gate's reading, with the elementwise error beside it: the max
    abs error and the atol that rtol 1e-2 would need."""
    g, w = got.to(torch.float32), exact.to(torch.float32)
    err = (g - w).abs()
    return {"row_rel_l2": row_rel_l2(g, w), "max_abs": float(err.max()),
            "atol_at_rtol_1e-2": float((err - 1e-2 * w.abs()).max())}


def drop_kv_tile(q, k, v, out, rows: slice, keys: slice):
    """A planted fault: ``out`` with the keys ``keys`` left out of the causal
    softmax of the query rows ``rows``, those rows recomputed densely in f32."""
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    kx, vx = (t.to(torch.float32).repeat_interleave(g, dim=1) for t in (k, v))
    s = q[:, :, rows].to(torch.float32) @ kx.transpose(-1, -2) * d ** -0.5
    i = torch.arange(sq, device=q.device)[rows, None]
    j = torch.arange(skv, device=q.device)[None, :]
    keep = (i + skv - sq >= j) & ~((j >= keys.start) & (j < keys.stop))
    bad = out.clone()
    bad[:, :, rows] = (torch.softmax(s.masked_fill(~keep, float("-inf")), -1) @ vx).to(out.dtype)
    return bad


def phase_attention_kernel():
    """Returns (max abs error against the plain version, cases checked)."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.attention import flash_attention_torch

    # the plain versions' f32 products in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(12)
    max_err, n_cases, records, scaled, worst, controls = 0.0, 0, [], [], {}, None
    for case in ATTN_CASES + [ATTN_EMPTY_ROWS, ATTN_FULL]:
        causal = case[6]
        empty = case is ATTN_EMPTY_ROWS
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(rng, case, dtype)
            plain = flash_attention_torch(q, k, v, causal=causal)
            # the dense oracle gives the mean of v on rows with no valid key
            dense = None if empty else attention_ref(q, k, v, causal=causal)
            exact = None
            if dtype == torch.bfloat16:
                exact = flash_attention_torch(*(t.to(torch.float32) for t in (q, k, v)),
                                              causal=causal)
            first = None
            for bq, bk in ATTN_BLOCKS[dtype]:
                got = flash_attention_cuda(q, k, v, causal=causal, block_q=bq, block_k=bk)
                torch.cuda.synchronize()
                label = f"flash_attention {case} {dtype} blocks ({bq}, {bk})"
                check(got.dtype == dtype and got.shape == q.shape, f"{label}: {got.dtype}{tuple(got.shape)}")
                err, ok = compare(got, plain, dtype)
                check(ok, f"{label} disagrees with flash_attention_torch (max abs err {err})")
                rec = {"case": list(case), "dtype": str(dtype), "blocks": [bq, bk],
                       "err_plain": err}
                if dense is not None:
                    err_d, ok_d = compare(got, dense, dtype)
                    check(ok_d, f"{label} disagrees with attention_ref (max abs err {err_d})")
                    rec["err_dense"] = err_d
                if exact is not None:
                    rec["exact"] = bf16_readings(got, exact)
                    worst = {key: max(x, worst.get(key, x)) for key, x in rec["exact"].items()}
                    check(rec["exact"]["row_rel_l2"] <= BF16_ROW_REL_L2,
                          f"{label}: a row is {rec['exact']['row_rel_l2']} from the exact "
                          f"result in relative L2 (limit {BF16_ROW_REL_L2})")
                if empty:
                    n_empty = case[3] - case[4]
                    check(bool((got[:, :, :n_empty] == 0).all()),
                          f"{label}: rows with no valid key are not exactly 0")
                    check(bool((plain[:, :, :n_empty] == 0).all()), "plain: empty rows not 0")
                if first is None:
                    first = got
                else:
                    err_b, ok_b = compare(got, first, dtype)
                    check(ok_b, f"{label}: result depends on the block sizes ({err_b})")
                    rec["err_blocks"] = err_b
                max_err = max(max_err, err)
                n_cases += 1
                records.append(rec)
            for scale in ATTN_SCALES if case is not ATTN_FULL else ():
                rec = attention_at_scale(q, k, v, case, scale, worst)
                max_err = max(max_err, rec.get("err_plain", 0.0))
                n_cases += 1
                scaled.append(rec)
            if case is ATTN_FULL and dtype == torch.bfloat16:
                controls = attention_controls(q, k, v, first, plain, exact)
            del q, k, v, plain, dense, exact, first, got
    torch.cuda.empty_cache()
    emit({"phase": "attention_kernel", "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cases": n_cases, "max_abs_err": max_err, "bf16_vs_exact_worst": worst,
          "bf16_row_rel_l2_limit": BF16_ROW_REL_L2, "controls": controls,
          "worst": sorted(records, key=lambda r: -r["err_plain"])[:4], "scaled": scaled})
    return max_err, n_cases


def attention_at_scale(q, k, v, case, scale, worst):
    """The kernel (default blocks) at softmax scale ``scale``: in f32 against
    the plain version at that scale (2e-5); in bf16 against the exact result
    of its inputs per query row (the plain bf16 version rounds the scores to
    bf16, which at a scale above the default errs past 3e-2 itself: its
    reading stands beside the kernel's).  Rows with no valid key exactly 0.
    Folds the bf16 readings into ``worst``."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.models.attention import flash_attention_torch

    causal, dtype = case[6], q.dtype
    label = f"flash_attention {case} {dtype} sm_scale {scale}"
    got = flash_attention_cuda(q, k, v, causal=causal, sm_scale=scale)
    plain = flash_attention_torch(q, k, v, causal=causal, sm_scale=scale)
    rec = {"case": list(case), "dtype": str(dtype), "sm_scale": scale}
    if dtype == torch.float32:
        rec["err_plain"], ok = compare(got, plain, dtype)
        check(ok, f"{label} disagrees with flash_attention_torch (max abs err {rec['err_plain']})")
    else:
        exact = flash_attention_torch(*(t.to(torch.float32) for t in (q, k, v)), causal=causal,
                                      sm_scale=scale)
        rec["exact"] = bf16_readings(got, exact)
        rec["plain_bf16_vs_exact"] = bf16_readings(plain, exact)
        worst.update({key: max(x, worst.get(key, x)) for key, x in rec["exact"].items()})
        check(rec["exact"]["row_rel_l2"] <= BF16_ROW_REL_L2,
              f"{label}: a row is {rec['exact']['row_rel_l2']} from the exact result "
              f"(limit {BF16_ROW_REL_L2})")
    if case is ATTN_EMPTY_ROWS:
        check(bool((got[:, :, :case[3] - case[4]] == 0).all()),
              f"{label}: rows with no valid key are not exactly 0")
    return rec


def attention_controls(q, k, v, got, plain, exact):
    """At the serving shape in bf16: the kernel's output with one kv tile
    dropped from the last q tile must fail the bf16 gate; the plain bf16
    version's reading stands beside it."""
    fault = drop_kv_tile(q, k, v, got, slice(q.shape[2] - 64, q.shape[2]), FAULT_KEYS)
    out = {"dropped_tile": bf16_readings(fault, exact),
           "dropped_tile_passes_3e-2_vs_plain": compare(fault, plain, torch.bfloat16)[1],
           "plain_bf16": bf16_readings(plain, exact)}
    emit({"phase": "attention_controls", **out})
    check(out["dropped_tile"]["row_rel_l2"] > BF16_ROW_REL_L2,
          "control: the bf16 gate passes the kernel's output with a kv tile dropped")
    return out


# ---------------------------------------------------------------------------
# phase 10: LM serving, qwen2-1.5b at full width
# ---------------------------------------------------------------------------


class routed_attention:
    """Routes the model's prefill attention through ``fn(q, k, v, causal)``."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        self.ops, self.saved = ops, ops.attention
        ops.attention = lambda q, k, v, causal=True: self.fn(q, k, v, causal)
        return self

    def __exit__(self, *exc):
        self.ops.attention = self.saved


def routed_last_logits(params, prompts, cfg, fn):
    """The prefill's last logits (f32) with its attention routed through ``fn``."""
    from repro_torch.models import transformer as tfm

    with routed_attention(fn):
        last, kv = tfm.prefill(params, prompts, cfg)
    del kv
    return last.to(torch.float32)


def causal_pairs(sq, skv):
    """Valid (query, key) pairs under the bottom-right aligned causal mask."""
    i = np.arange(sq, dtype=np.int64)
    return int(np.clip(i + (skv - sq) + 1, 0, skv).sum())


def lm_bounds(cfg, params, rate):
    """Least prefill and decode-step times on this card (ms), from the shapes.

    Prefill: 2 FLOP per weight per token for every matrix (lm_head
    included) plus 4·D FLOP per valid causal pair per query head and
    layer, at the bf16 tensor-core rate.  Decode: each bf16 weight matrix
    read once plus the valid KV cache, at the memory rate.
    """
    w = params.serving_weights(cfg.dtype)
    mats = [t for layer in w["layers"] for n, t in layer.items()
            if t.dim() == 2] + [w["lm_head"]]
    mat_elems = sum(t.numel() for t in mats)
    tokens = LM_BATCH * LM_PROMPT
    attn = 4 * cfg.head_dim * cfg.n_heads * LM_BATCH * causal_pairs(LM_PROMPT, LM_PROMPT)
    prefill_flop = 2 * mat_elems * tokens + cfg.n_layers * attn
    kv_bytes = 2 * cfg.n_layers * LM_BATCH * cfg.n_kv_heads * (LM_PROMPT + LM_GEN // 2) * \
        cfg.head_dim * 2
    decode_bytes = sum(t.numel() * t.element_size() for t in mats) + kv_bytes
    return {"prefill_flop": prefill_flop, "prefill_bound_ms": prefill_flop / BF16_TENSOR_FLOP_PER_S * 1e3,
            "decode_bytes_per_step": decode_bytes, "decode_bound_ms": decode_bytes / rate * 1e3}


def phase_lm_serve(rate):
    """Returns the flash-attention kernel's launches on the timed serve run."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import launches, reset_launches
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import flash_attention_torch

    cfg = get_arch(LM_ARCH).full_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, LM_SEED, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(2407).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT), dtype=np.int64))

    # warm run: first-use costs (cuBLAS, the bf16 serving copy) stay out of the timed run
    t0 = time.perf_counter()
    serve(cfg, params, prompts, LM_GEN)
    t_warm = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    toks, t = serve(cfg, params, prompts, LM_GEN)
    n_launch = launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    check(n_launch == cfg.n_layers,
          f"lm_serve: {n_launch} flash_attention launches per prefill, expected {cfg.n_layers}")
    check(tuple(toks.shape) == (LM_BATCH, LM_GEN), f"lm_serve: tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "lm_serve: token outside the vocab")
    steps = t["decode_steps"]
    serve_rec = {
        "arch": LM_ARCH, "n_params": cfg.n_params(), "batch": LM_BATCH, "prompt": LM_PROMPT,
        "gen": LM_GEN, "init_s": t_init, "warm_serve_s": t_warm,
        "prefill_ms": t["prefill_s"] * 1e3, "decode_ms_per_step": t["decode_s"] * 1e3 / steps,
        "decode_tokens_per_s": steps * LM_BATCH / t["decode_s"],
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / t["prefill_s"],
        "peak_device_bytes": peak, "flash_attention_launches": n_launch,
        **lm_bounds(cfg, params, rate),
    }
    emit({"phase": "lm_serve", **serve_rec, "sample": toks[0, :16].tolist()})

    # logits through the kernel: finite, and no padded vocab column wins
    logits = tfm.forward(params, prompts, cfg)
    check(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()), "lm_serve: non-finite logits")
    check(bool((logits.argmax(-1) < cfg.vocab_size).all()), "lm_serve: a padded vocab column won")
    first_token_agrees = bool((logits[:, -1].argmax(-1).cpu() == toks[:, 0].cpu()).all())
    del logits

    # every layer's kernel call of one prefill against the exact result of
    # its real inputs, with the bf16 gate of phase 9
    layer_rows = []

    def checked(q, k, v, causal):
        got = flash_attention_cuda(q, k, v, causal=causal)
        exact = flash_attention_torch(*(t.to(torch.float32) for t in (q, k, v)), causal=causal)
        layer_rows.append(row_rel_l2(got, exact))
        return got

    last_kernel = routed_last_logits(params, prompts, cfg, checked)
    check(len(layer_rows) == cfg.n_layers, f"lm_serve: {len(layer_rows)} attention calls")
    # the same prefill through the plain attention, and two planted faults
    n0 = launches["flash_attention"]
    last_plain = routed_last_logits(params, prompts, cfg, flash_attention_torch)
    check(launches["flash_attention"] == n0, "plain prefill launched the kernel")
    last_zeroed = routed_last_logits(params, prompts, cfg,
                                     lambda q, k, v, causal: torch.zeros_like(q))
    last_dropped = routed_last_logits(
        params, prompts, cfg, lambda q, k, v, causal: drop_kv_tile(
            q, k, v, flash_attention_cuda(q, k, v, causal=causal),
            slice(LM_PROMPT - 64, LM_PROMPT), FAULT_KEYS))
    real = slice(0, cfg.vocab_size)
    rel_l2 = lambda a: float((a[:, real] - last_plain[:, real]).norm()  # noqa: E731
                             / last_plain[:, real].norm())
    rel, rel_zeroed, rel_dropped = rel_l2(last_kernel), rel_l2(last_zeroed), rel_l2(last_dropped)
    max_abs = float((last_kernel[:, real] - last_plain[:, real]).abs().max())
    agree = float((last_kernel.argmax(-1) == last_plain.argmax(-1)).float().mean())
    del last_zeroed, last_dropped
    emit({"phase": "lm_attention_checks", "layer_row_rel_l2": layer_rows,
          "row_rel_l2_limit": BF16_ROW_REL_L2, "prefill_kernel_vs_plain_rel_l2": rel,
          "control_attention_zeroed_rel_l2": rel_zeroed,
          "control_dropped_tile_rel_l2": rel_dropped, "prefill_rel_l2_limit": PREFILL_REL_L2})
    check(max(layer_rows) <= BF16_ROW_REL_L2,
          f"lm_serve: a layer's attention row is {max(layer_rows)} from the exact result")
    check(rel <= PREFILL_REL_L2,
          f"lm_serve: prefill through the kernel vs plain: relative L2 {rel} > {PREFILL_REL_L2}")
    check(min(rel_zeroed, rel_dropped) > PREFILL_REL_L2,
          f"control: a planted fault passes the prefill gate (zeroed {rel_zeroed}, "
          f"dropped tile {rel_dropped})")

    # decode step 1 against the full forward, f32 compute on the same weights
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    last32, kv32 = tfm.prefill(params, prompts, cfg32)
    k0, v0 = tfm.init_kv_cache(cfg32, LM_BATCH, LM_PROMPT + 1, device="cuda")
    k0[:, :, :, :LM_PROMPT] = kv32[0]
    v0[:, :, :, :LM_PROMPT] = kv32[1]
    del kv32
    nxt = last32.argmax(-1).to(torch.int32)
    dl, _ = tfm.decode_step(params, nxt, LM_PROMPT, (k0, v0), cfg32)
    del k0, v0
    full = tfm.forward(params, torch.cat([prompts.cuda(), nxt[:, None].long()], 1), cfg32)[:, -1]
    err = (dl - full).abs()
    ok = bool((err <= DECODE_TOL + DECODE_TOL * full.abs()).all())
    dec_err = float(err.max())
    del full, dl, last32
    check(ok, f"lm_serve: f32 decode step vs forward: max abs err {dec_err} (tol {DECODE_TOL})")
    torch.cuda.empty_cache()
    emit({"phase": "lm_checks", "prefill_kernel_vs_plain_rel_l2": rel,
          "prefill_kernel_vs_plain_max_abs": max_abs,
          "argmax_agreement": agree, "first_token_agrees": first_token_agrees,
          "decode_vs_forward_f32_max_abs": dec_err,
          "decode_tol": DECODE_TOL, "prefill_rel_l2_limit": PREFILL_REL_L2})
    phase_lm_profile(cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    return n_launch, serve_rec


def phase_lm_profile(cfg, params, prompts):
    """The prefill, then the decode steps of one serve, each under the profiler."""
    from repro_torch.models import transformer as tfm

    emit({"phase": "lm_profile", "window": "prefill",
          **profiled(lambda: tfm.prefill(params, prompts, cfg))})
    last, kv = tfm.prefill(params, prompts, cfg)
    cache = tfm.init_kv_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device="cuda")
    cache[0][:, :, :, :LM_PROMPT] = kv[0]
    cache[1][:, :, :, :LM_PROMPT] = kv[1]
    del kv
    tok = last.argmax(-1).to(torch.int32)

    def decode():
        t = tok
        for i in range(LM_GEN - 1):
            logits, _ = tfm.decode_step(params, t, LM_PROMPT + i, cache, cfg)
            t = logits.argmax(-1).to(torch.int32)

    emit({"phase": "lm_profile", "window": f"decode, {LM_GEN - 1} steps", **profiled(decode)})


# ---------------------------------------------------------------------------
# phase 11: attention timing at the serving shape
# ---------------------------------------------------------------------------


def sdpa(q, k, v):
    """The yardstick: PyTorch's fused attention (Sq = Skv here, so its
    top-left causal mask is the kernel's bottom-right one).  The port
    never calls it."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            enable_gqa=True)


def phase_attention_timing(rate):
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.models.attention import flash_attention_torch

    b, hq, _, sq, skv, d, causal = ATTN_FULL
    rng = np.random.default_rng(13)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attn_inputs(rng, ATTN_FULL, dtype)
        el = q.element_size()
        n_bytes = el * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read; o written
        flop = 4 * b * hq * d * causal_pairs(sq, skv)
        peak = BF16_TENSOR_FLOP_PER_S if dtype == torch.bfloat16 else SCALAR_OPS_PER_S
        t_bytes, t_ops = n_bytes / rate, flop / peak
        kernel = lambda: flash_attention_cuda(q, k, v, causal=causal)  # noqa: E731
        # each a median of 20 readings of 10 back-to-back calls
        rec = {
            "dtype": str(dtype), "shape": [list(q.shape), list(k.shape)],
            "ms": time_ms(kernel, reps=20, warm=10, batch=10),
            "ms_single_launch": time_ms(kernel, reps=20),
            "plain_ms": time_ms(lambda: flash_attention_torch(q, k, v, causal=causal), reps=5,
                                warm=1),
            "library_ms": time_ms(lambda: sdpa(q, k, v), reps=20, warm=10, batch=10),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flop": flop, "bytes": n_bytes,
        }
        rec["tflop_per_s"] = flop / rec["ms"] / 1e9
        emit({"phase": "attention_timing", **rec})
        out[dtype] = rec
        del q, k, v
    torch.cuda.empty_cache()
    return out[torch.bfloat16]


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main_cards() -> int:
    """``python3 chip_smoke.py --cards``: phase 8i's scheme over every
    visible card (a multi-card machine), against the pallas vectors."""
    from repro_torch.core import TriangleCounter, prepare_oriented
    from repro_torch.graphs import kronecker_rmat

    name, _ = phase_device()
    phase_build()
    edges = kronecker_rmat(21, edge_factor=16, seed=1503)
    csr = prepare_oriented(edges, device="cuda")
    tc = TriangleCounter(method="pallas", max_wedge_chunk=BUDGETS_21[0])
    vectors = tc.per_node(csr), tc.edge_support(csr)
    phase_distributed_cards(edges, csr, *vectors)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
    if sys.argv[1:] == ["--cards"]:
        return main_cards()
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]} (only --cards)")

    t_start = time.perf_counter()
    name, smi_line = phase_device()
    rate = memory_bytes_per_s(name)
    phase_build()
    cmp, ccmp = Compare(), CsrCompare()
    phase_kernels_synthetic(cmp)
    phase_csr_synthetic(ccmp)
    phase_csr_tiles(ccmp)
    phase_karate()
    phase_kron13()

    from repro_torch.core import prepare_oriented
    from repro_torch.graphs import kronecker_rmat

    t0 = time.perf_counter()
    edges = kronecker_rmat(21, edge_factor=16, seed=1503)
    emit({"phase": "kron21_generate", "seconds": time.perf_counter() - t0,
          "canonical_rows": int(edges.shape[0])})
    csr = prepare_oriented(edges, device="cuda")
    main_launches, vectors, exact_s = phase_kron21(edges, csr)
    main_launches.update(phase_profile(edges, vectors))
    top_nodes, top_edges = top_k_of(vectors["per_node"], vectors["edge_support"],
                                    csr.src.cpu().numpy(), csr.col.cpu().numpy())
    per_node21, support21 = vectors["per_node"], vectors["edge_support"]
    del vectors
    analytics_launches = {k: 0 for k in CSR_KERNELS}
    analytics_launches["intersect_count_csr"] += phase_doulion(edges, exact_s)
    for k, n in phase_report(edges, csr, top_nodes, top_edges).items():
        analytics_launches[k] += n
    truss_launches, truss_audit = phase_truss()
    analytics_launches["intersect_support_csr"] += truss_launches
    phase_analyze_cli()
    stream_launches, stream_audit = phase_stream(edges, exact_s, per_node21)
    phase_serve_graph_cli()
    tile_cache, tuning_launches = phase_tuning(csr, name, per_node21, support21)
    service_launches = phase_graph_service(csr, per_node21, support21, tile_cache)
    phase_distributed(edges, csr, per_node21, support21)
    audit = phase_audit({"truss": truss_audit, "stream": stream_audit})
    del edges, per_node21, support21, truss_audit, stream_audit
    chunks = real_chunks(csr, BUDGETS_21[0])
    phase_kernels_real(cmp, ccmp, csr, chunks)
    timing, top = phase_timing(csr, chunks, rate)

    del csr, chunks
    torch.cuda.empty_cache()
    fa_err, fa_cases = phase_attention_kernel()
    fa_launches, _ = phase_lm_serve(rate)
    fa_time = phase_attention_timing(rate)

    kernels = []
    for k in CSR_KERNELS:
        t = timing[(k, top)]
        kernels.append({
            "name": k, "route": "cuda", "source": CSR_SOURCE, "replaces": CSR_REPLACES[k],
            "launches": main_launches[k], "max_abs_err": ccmp.max_abs_err[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "gather_panel_ms": t["gather_panel_ms"],
            "analytics_launches": analytics_launches[k],
            "checked_cases": ccmp.cases[k], "shape": [t["rows"], top], "on_main_path": True,
            "audit_traces": {run: traces.get(k, 0) for run, traces in audit.items()},
        })
        check(main_launches[k] > 0, f"{k} was not launched on the main path")
        check(analytics_launches[k] > 0, f"{k} was not launched on the analytics path")
        if k in stream_launches:
            kernels[-1]["stream_launches"] = stream_launches[k]
            check(stream_launches[k] > 0, f"{k} was not launched on the stream path")
        kernels[-1]["tuning_launches"] = tuning_launches[k]
        kernels[-1]["service_launches"] = service_launches[k]
        check(tuning_launches[k] > 0, f"{k} was not launched on the tuned path")
        check(service_launches[k] > 0, f"{k} was not launched by the graph service")
    for k in KERNELS:
        t = timing[(k, top)]
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
            "launches": main_launches[k], "max_abs_err": cmp.max_abs_err[k],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "checked_cases": cmp.cases[k], "shape": [t["rows"], top, top],
            # the panel kernels are ops.intersect_*'s route; the engine's
            # pallas paths read the CSR, so their main-path launches are 0
            "on_main_path": False,
        })
        check(main_launches[k] == 0, f"the panel kernel {k} ran on the main path")
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
        "launches": fa_launches, "max_abs_err": fa_err, "ms": fa_time["ms"],
        "plain_ms": fa_time["plain_ms"], "bound_ms": fa_time["bound_ms"],
        "bound_by": fa_time["bound_by"], "library_ms": fa_time["library_ms"],
        "checked_cases": fa_cases, "shape": fa_time["shape"], "on_main_path": True,
    })
    check(fa_launches > 0, "flash_attention was not launched on the serving path")
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
