"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py --cards``, on a machine with four or more cards,
runs only phase 8i's kron-21 checks over all of them and phase 16's
sharded step at full depth over four: ``main_cards``.)

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
             its plain version and ``scaled_dot_product_attention``;
12. train_attention — the kernel under autograd (``KernelAttention``: the
             kernel forward, the plain backward) against autograd through the
             plain version at qwen2-1.5b's training shape;
13. lm_train — qwen2-1.5b at full width trained 6 steps (accum 2 × 2 ×
             4096), and a reduced qwen2 held against the CPU;
14. train_cli — the train CLI's resume, granite's smoke train, the serve
             CLI; ``_moe`` at granite's width against the CPU with a random
             router and tied ones (columns repeated in pairs, zeros); granite
             ``full_config()`` (depth cut to 8 layers) trained and served;
15. kv_int8 — qwen2-1.5b at the phase-10 shape served with the int8 KV
             cache (``kv_quant``) beside the bf16 cache: the cache stays
             int8, its bytes, the first decode step's logits within 0.08 of
             the bf16 cache's (relative to their max), greedy agreement,
             decode ms/step and peaks; ``quantize_kv_token`` card vs CPU
             bit-equal and ``decode_attention_int8`` within 1e-6 at the
             serving decode shape;
16. lm_sharded — ``make_lm_train_step`` sharded by the reference's rules on
             a (2, 4) mesh of eight repeats of the card, qwen2-1.5b at full
             width cut to 2 layers (f32, TF32 off), accum 2 × 4 × 1024, 2
             steps, against the step on the card: parameters within 2e-3,
             loss within 1e-4, the kernel launched once per replica for
             each launch of the single-card step; ``compress_grads`` on the
             card bit-equal to the CPU; elastic restore (2, 4) → (4, 2);
17. gnn    — the four GNN archs (f32) at their configs' widths: each against
             the CPU on a Cora-size graph (``full_graph_sm``: forward 1e-4 of
             its max, loss 1e-5, every gradient leaf 1e-3 of its max, TF32
             off); ``gcn-cora`` trained 30 steps there (the loss falls);
             ``minibatch_lg`` at full size (a CSR of Reddit's 232,965 nodes
             and 114,615,892 edges, endpoints uniform, made on the card):
             ``graphsage-reddit`` 10 steps of batch 1,024 with fanout
             (15, 10), the sampler inside the step, and ``gcn-cora``,
             ``schnet``, ``egnn`` 2 steps each on the block graph; the
             sampler's children on 64 seeds all CSR neighbours (or the
             self-loop); ``molecule`` at full size (128 × 30 nodes × 64
             edges): ``schnet`` and ``egnn`` 10 steps, EGNN equivariant on
             the card within 2e-3; ``ogb_products`` at full size (uniform
             edges, made on the card): ``gcn-cora`` 3 full-batch steps, then
             the edge-partitioned GCN over ``Mesh(["cuda"] * 4, ("data",))``
             against the single card (f32 2e-4, bf16 with ``smart_order``
             3e-2, rtol and atol); the train CLI ``--arch gcn-cora --steps 30``;
18. recsys — DIN ``full_config()`` (10^6 items, embed 18, seq 100): card vs
             CPU at 1,024 rows (logits and loss 1e-5, gradients 1e-4 of each
             leaf's max); ``train_batch`` (65,536) 5 AdamW steps;
             ``serve_p99`` (512) and ``serve_bulk`` (262,144: the train
             batch repeated, halved while the peak passes 70 GB) served;
             ``retrieval_cand`` cut to 131,072 candidates, 64 of them equal to
             ``apply`` within 1e-4; the train CLI ``--arch din --steps 10``;
19. dryrun — the analysis tools: one more step each of phase 13's
             qwen2-1.5b training, phase 17's full-batch ``ogb_products`` GCN
             and phase 18's DIN ``train_batch`` runs on the card under the
             cost walker (``repro_torch.launch.flops``), and the same step
             is traced on ``meta`` copies of its arguments through
             ``DryRunSpec.lower()``: matmul FLOPs card = meta exactly (qwen2
             outside attention); the attention kernel charged as its
             launches (112) × 4·B·Hq·D·(causal pairs), printed beside the
             plain version's dots on ``meta``; each step's roofline on one
             card (H100 datasheet model) over its measured median; and the
             dry-run CLI on ``triangles kron21`` and ``qwen2-1.5b
             decode_32k`` over the 256-GPU mesh (exit 0, finite terms).

The ``kernels`` line gives rows 1-3 an ``analytics_launches`` field: their
launches in phases 8a-8c; the count and per-node CSR kernels also a
``stream_launches`` field: the count's in 8e's bootstrap, the per-node's
over 8e's 16 updates (8f runs in its own processes); and rows 1-3
``tuning_launches`` (8g's tuned counts, per-node and support, the sweep's
launches included) and ``service_launches`` (8h, the CLI's excepted);
rows 1-3 ``audit_traces``: their new launch signatures in 8j's two runs;
row 4 (flash attention) ``train_launches`` (13), ``moe_train_launches``
and ``moe_serve_launches`` (14), ``kv_int8_launches`` (15's two timed
serves) and ``sharded_train_launches`` (16).  Every row has ``gnn_launches`` (17)
and ``recsys_launches`` (18), both 0: the GNN and DIN code is torch ops.
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
# head dim 16 runs in f32 only (the smoke configs': d_model 64 over 4 heads);
# bf16 at D = 16 is refused by the wrapper and the C entry
ATTN_D16 = [(2, 4, 2, 24, 24, 16, True), (1, 4, 1, 100, 160, 16, False),
            (2, 4, 2, 200, 200, 16, True)]
# phase 12: the attention kernel under autograd (forward the kernel,
# backward the plain version recomputed) against autograd through the plain
# version: qwen2-1.5b's training shape in bf16, a reduced S in f32 (TF32
# off); output and dq, dk, dv within TRAIN_ATTN_TOL of each tensor's max
TRAIN_ATTN = (2, 12, 2, 4096, 4096, 128, True)
TRAIN_ATTN_F32 = (2, 12, 2, 512, 512, 128, True)
TRAIN_ATTN_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
# phase 13: qwen2-1.5b trained at full width, accum 2 × microbatch 2 × 4096.
# At constant(3e-4) with no warmup the loss rose (12.37, 10.86, 14.49, 12.12,
# 13.16, 11.56 over 6 steps on the card, PERF.md): AdamW's first steps move
# every weight by about lr, and the second overshot.  3e-5 stays in the
# regime where each step lowers the loss.
TRAIN_ACCUM, TRAIN_MICRO, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2, 4096, 6, 3e-5
# the reduced qwen2 held against the CPU: 3 steps, loss and gnorm relative
TRAIN_HOLD_TOL = 1e-4
# phase 14: granite's MoE layer at full width (T tokens), card vs CPU in f32
MOE_TOKENS, MOE_TOL = 4096, 1e-4
# the tied routers (ties on every token) run on the first 1,024 tokens: the
# CPU side of each check costs seconds per thousand tokens
MOE_TIED_TOKENS = 1024
MOE_ARCH = "granite-moe-3b-a800m"
# granite's depth in phase 14, cut from 32 layers to keep the script inside
# its time limit; every layer is at full width (40 experts, d_model 1536)
MOE_LAYERS = 8
MOE_BATCH, MOE_PROMPT, MOE_GEN, MOE_TRAIN_SEQ = 2, 2048, 16, 2048
# the train CLI's resumed run against an uninterrupted one (index_add's
# atomics in the embedding and MoE backward reorder sums on the card)
RESUME_TOL = 1e-4
# decode step 1 against forward(prompt + token)[:, -1], f32 on both sides
# (rtol, atol as the reference's smoke-size test)
DECODE_TOL = 3e-4
# phase 15: the int8 KV cache at the phase-10 shape.  The first decode
# step's logits against the bf16 cache's, relative to their max (the
# reference's gate, tests/test_models_lm.py::test_int8_kv_decode_matches_fp);
# quantize_kv_token card vs CPU bit-equal, decode_attention_int8 within
# KV_DECODE_REL of the CPU's output's max
KV_LOGITS_REL, KV_DECODE_REL = 0.08, 1e-6
# phase 16: the sharded train step on a (2, 4) mesh of eight repeats of the
# card, qwen2-1.5b at full width cut to 2 layers, f32 compute with TF32 off
# (the gates compare the step's arithmetic, which bf16 rounding would blur;
# phase 13 trains in bf16): accum 2 × microbatch 4 × 1024, 2 steps, against
# make_lm_train_step on the card.  Parameters within the reference test's
# 2e-3 (rtol and atol), the loss within 1e-4, gnorm 1e-4 relative.
SHARD_MESH, SHARD_LAYERS, SHARD_ACCUM, SHARD_MICRO, SHARD_SEQ, SHARD_STEPS = \
    (2, 4), 2, 2, 4, 1024, 2
SHARD_PARAM_TOL, SHARD_LOSS_TOL, SHARD_GNORM_REL = 2e-3, 1e-4, 1e-4
# --cards: the full 28-layer qwen2-1.5b sharded step on a (2, 2) mesh of 4 cards
CARDS_MESH = (2, 2)
# prefill logits through the kernel against the plain attention, bf16: the
# plain version rounds scores to bf16 and the kernel does not, and 28 layers
# carry the difference; bounded as a relative L2 error of the last logits,
# between the sound reading (0.0226) and the controls: one kv tile dropped
# from the last q tile in every layer (0.040), attention zeroed (0.81)
PREFILL_REL_L2 = 3e-2

# phase 17: the four GNN archs (GNN_SHAPES, f32, TF32 off for the CPU
# comparisons).  Card vs CPU at full_graph_sm: forward within GNN_HOLD_FWD of
# the output's max, the loss GNN_HOLD_LOSS relative, each gradient leaf
# GNN_HOLD_GRAD of its max (index_add's atomics reorder the card's sums)
GNN_ARCHS = ("gcn-cora", "graphsage-reddit", "schnet", "egnn")
GNN_SEED = 17
GNN_HOLD_FWD, GNN_HOLD_LOSS, GNN_HOLD_GRAD = 1e-4, 1e-5, 1e-3
GNN_CORA_STEPS, GNN_SAGE_STEPS, GNN_BLOCK_STEPS, GNN_MOL_STEPS, GNN_PRODUCTS_STEPS = \
    30, 10, 2, 10, 3
GNN_MEMBERSHIP_SEEDS = 64
EGNN_EQUIV_TOL = 2e-3
# the edge-partitioned GCN against the single card, rtol and atol: f32 as the
# reference's shard_map test; bf16 looser, its partial aggregates summed in
# bf16 in another order (and the single card's atomics in any order)
GNN_MESH_BLOCKS = 4
GNN_MESH_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
# phase 18: DIN full_config().  Card vs CPU at DIN_HOLD_ROWS rows: logits
# within DIN_HOLD_FWD of their max, the loss DIN_HOLD_LOSS relative, each
# gradient leaf DIN_HOLD_GRAD of its max.  retrieval_cand is cut from 10^6
# candidates: its (C, 100, 144) f32 attention features alone take 57.6 GB
# there, with h - t and h * t beside them more than one card holds
DIN_SEED = 18
DIN_HOLD_ROWS = 1024
DIN_HOLD_FWD, DIN_HOLD_LOSS, DIN_HOLD_GRAD = 1e-5, 1e-5, 1e-4
DIN_TRAIN_STEPS, DIN_CLI_STEPS = 5, 10
DIN_P99_REPS, DIN_BULK_REPS, DIN_RETRIEVAL_REPS = 20, 3, 3
DIN_BULK_PEAK = 70e9
DIN_RETRIEVAL, DIN_RETRIEVAL_CHECK, DIN_RETRIEVAL_TOL = 131_072, 64, 1e-4
# phase 19: the attention kernel's launches in one qwen2-1.5b train step
# (28 layers × accum 2, each forward run twice under full remat)
TRAIN_LAYERS_LAUNCHES = 28 * TRAIN_ACCUM * 2
# two production cells through the dry-run CLI, on the 256-GPU mesh
DRYRUN_CELLS = (("triangles", "kron21"), ("qwen2-1.5b", "decode_32k"))


class SmokeFailure(RuntimeError):
    pass


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, stamped with the script's seconds so far (``t_s``)."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T_START, 3)}, sort_keys=True),
          flush=True)


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
    """The chunk's u, v and query edge ids: the plan's int32 tensors on the card."""
    check(all(x.device == csr.device for x in (chunk.u, chunk.v, chunk.edge_idx)),
          f"a width-{chunk.width} chunk is not on {csr.device}")
    return [chunk.u, chunk.v, chunk.edge_idx]


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


def chunk_uploads() -> int:
    """The engine's ``engine.chunk_uploads`` counter: chunk arrays that
    ``_DeviceAdj.put`` had to copy or convert (0 on the panel plan's routes)."""
    from repro_torch import obs

    return int(obs.metrics_snapshot()["counters"].get("engine.chunk_uploads", 0))


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
        uploads = chunk_uploads()
        value, st, sec, ln = run_engine(kind, graph, method, budget)
        uploads = chunk_uploads() - uploads
        got = value if kind == "count" else int(value.sum())
        check(got == expect, f"kron-21 {kind} {method} {budget}: {got} != {expect}")
        want_uploads = 2 * st.n_chunks if st.method == "wedge_bsearch" and st.n_chunks > 1 else 0
        check(uploads == want_uploads, f"kron-21 {kind} {method} {budget}: {uploads} chunk "
                                       f"uploads, expected {want_uploads}")
        rec = {"kind": kind, "method": method, "resolved_method": st.resolved_method,
               "executed": st.method, "budget": budget, "value": got,
               "input": "edges" if graph is edges else "oriented CSR",
               "n_chunks": st.n_chunks, "peak_wedge_buffer": st.peak_wedge_buffer,
               "seconds": sec, "timings": st.timings, "launches": ln, "chunk_uploads": uploads,
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


def profiled(fn, all_device=False):
    """``fn()`` under torch.profiler: wall time, device busy time and share idle,
    and the largest device entries (``all_device``: every one).  Busy time
    sums the device entries' self time (one stream: they do not overlap);
    the wall clock includes the profiler's overhead, so the idle share is an
    upper bound.  Device activity only: host op events would add nothing
    here and cost ~40 s to parse over a train step's 10^5 of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.key, ev.self_device_time_total, ev.count)
                   for ev in prof.key_averages()
                   if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    out = {"wall_s": wall, "device_busy_s": busy if rows else None,
           "device_idle_share": (1.0 - busy / wall) if rows else None,
           "top_device": [{"name": k[:80], "s": us / 1e6, "calls": n} for k, us, n in rows[:10]]}
    if all_device:
        out["all_device"] = [{"name": k, "s": us / 1e6, "calls": n} for k, us, n in rows]
    return out


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
    d16_err, d16_cases = attention_d16(rng)
    max_err, n_cases = max(max_err, d16_err), n_cases + d16_cases
    torch.cuda.empty_cache()
    emit({"phase": "attention_kernel", "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cases": n_cases, "max_abs_err": max_err, "bf16_vs_exact_worst": worst,
          "bf16_row_rel_l2_limit": BF16_ROW_REL_L2, "controls": controls,
          "worst": sorted(records, key=lambda r: -r["err_plain"])[:4], "scaled": scaled})
    return max_err, n_cases


def attention_d16(rng):
    """Head dim 16 in f32 (the smoke configs'), every f32 block pair, against
    the plain version and the dense oracle; bf16 at D = 16 refused by the
    wrapper and by the C entry.  Returns (max abs error, cases)."""
    from repro_torch.kernels.flash_attention import _build
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.attention import flash_attention_torch

    max_err, n = 0.0, 0
    for case in ATTN_D16:
        causal = case[6]
        q, k, v = attn_inputs(rng, case, torch.float32)
        plain = flash_attention_torch(q, k, v, causal=causal)
        dense = attention_ref(q, k, v, causal=causal)
        for bq, bk in ATTN_BLOCKS[torch.float32]:
            got = flash_attention_cuda(q, k, v, causal=causal, block_q=bq, block_k=bk)
            torch.cuda.synchronize()
            label = f"flash_attention {case} float32 blocks ({bq}, {bk})"
            err, ok = compare(got, plain, torch.float32)
            check(ok, f"{label} disagrees with flash_attention_torch (max abs err {err})")
            err_d, ok_d = compare(got, dense, torch.float32)
            check(ok_d, f"{label} disagrees with attention_ref (max abs err {err_d})")
            max_err, n = max(max_err, err), n + 1
    qb, kb, vb = attn_inputs(rng, ATTN_D16[0], torch.bfloat16)
    try:
        flash_attention_cuda(qb, kb, vb)
        refused = False
    except ValueError as e:
        refused = "bfloat16" in str(e)
    check(refused, "flash_attention: bf16 at head dim 16 was not refused by the wrapper")
    out = torch.empty_like(qb)
    b, hq, sq, d = qb.shape
    code = _build.load_library().fa_forward_launch(
        1, 16, qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(), b, hq, kb.shape[1],
        sq, kb.shape[2], 64, 64, d ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
    check(code != 0, "flash_attention: the C entry took bf16 at head dim 16")
    emit({"phase": "attention_d16", "cases": n, "max_abs_err": max_err,
          "bf16_refused": {"wrapper": refused, "c_entry_code": code}})
    return max_err, n


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

    from repro_torch.launch.flops import attention_cost

    b, hq, hkv, sq, skv, d, causal = ATTN_FULL
    rng = np.random.default_rng(13)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = attn_inputs(rng, ATTN_FULL, dtype)
        # q, k, v read and o written once; 4·D FLOP per valid pair and head
        flop, n_bytes = attention_cost(b, hq, hkv, sq, skv, d, causal, q.element_size())
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
# phase 12: the attention kernel under autograd
# ---------------------------------------------------------------------------


def rel_to_max(got, want) -> float:
    """max |got − want| over max |want|."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def attention_fwd_bwd(fn, q, k, v, grad_out):
    """(output, dq, dk, dv) of ``fn(q, k, v)`` under autograd."""
    inputs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*inputs)
    return (out.detach(), *torch.autograd.grad(out, inputs, grad_out))


def phase_train_attention(rate):
    """``ops.attention`` on CUDA tensors that need a gradient (the
    ``KernelAttention`` Function: the kernel forward, the plain version's
    backward) against autograd through the plain version on the same card.
    Times, at the training shape in bf16: the kernel forward, the plain
    forward + backward, the Function's forward + backward and PyTorch's
    fused attention forward + backward (the yardstick; the port never calls
    it).  Returns the bf16 record."""
    from repro_torch.kernels.flash_attention import launches, ops
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.models.attention import flash_attention_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(21)
    out = {}
    for case, dtype in ((TRAIN_ATTN, torch.bfloat16), (TRAIN_ATTN_F32, torch.float32)):
        q, k, v = attn_inputs(rng, case, dtype)
        grad_out = torch.from_numpy(rng.standard_normal(size=tuple(q.shape),
                                                        dtype=np.float32)).to("cuda", dtype)
        n0 = launches["flash_attention"]
        got = attention_fwd_bwd(lambda *t: ops.attention(*t, causal=True), q, k, v, grad_out)
        torch.cuda.synchronize()
        fn_launches = launches["flash_attention"] - n0
        want = attention_fwd_bwd(lambda *t: flash_attention_torch(*t, causal=True), q, k, v,
                                 grad_out)
        check(launches["flash_attention"] - n0 == fn_launches, "plain autograd launched the kernel")
        check(fn_launches == 1, f"train_attention: the Function launched the kernel "
                                f"{fn_launches} times, expected 1")
        errs = {name: rel_to_max(a, b) for name, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
        rec = {"dtype": str(dtype), "shape": [list(q.shape), list(k.shape)], "rel_to_max": errs,
               "tol": TRAIN_ATTN_TOL[dtype], "kernel_launches": fn_launches}
        check(all(e <= TRAIN_ATTN_TOL[dtype] for e in errs.values()),
              f"train_attention {case} {dtype}: {errs} over {TRAIN_ATTN_TOL[dtype]}")
        del got, want
        if dtype == torch.bfloat16:
            b, hq, _, sq, skv, d, _ = case
            flop = 4 * b * hq * d * causal_pairs(sq, skv)
            fwd_bwd = lambda fn: lambda: attention_fwd_bwd(fn, q, k, v, grad_out)  # noqa: E731
            rec.update({
                "kernel_forward_ms": time_ms(lambda: flash_attention_cuda(q, k, v, causal=True),
                                             reps=10, warm=3, batch=5),
                "forward_bound_ms": max(flop / BF16_TENSOR_FLOP_PER_S,
                                        2 * (2 * q.numel() + k.numel() + v.numel()) / rate) * 1e3,
                "plain_forward_ms": time_ms(lambda: flash_attention_torch(q, k, v, causal=True),
                                            reps=5, warm=1),
                "plain_fwd_bwd_ms": time_ms(fwd_bwd(
                    lambda *t: flash_attention_torch(*t, causal=True)), reps=5, warm=1),
                "function_fwd_bwd_ms": time_ms(fwd_bwd(
                    lambda *t: ops.attention(*t, causal=True)), reps=5, warm=1),
                "library_fwd_bwd_ms": time_ms(fwd_bwd(sdpa), reps=10, warm=3),
                "library_forward_ms": time_ms(lambda: sdpa(q, k, v), reps=10, warm=3, batch=5),
                # the least time of the backward: 2.5× the forward's FLOP
                # (dq, dk, dv and the recomputed scores), on the tensor cores
                "backward_bound_ms": 2.5 * flop / BF16_TENSOR_FLOP_PER_S * 1e3,
            })
            rec["plain_backward_ms"] = rec["function_fwd_bwd_ms"] - rec["kernel_forward_ms"]
        emit({"phase": "train_attention", **rec})
        out[dtype] = rec
        del q, k, v, grad_out
        torch.cuda.empty_cache()
    return out[torch.bfloat16]


# ---------------------------------------------------------------------------
# phase 13: LM training, qwen2-1.5b at full width
# ---------------------------------------------------------------------------


class timed_attention_backward:
    """CUDA events around each call of ``ops.KernelAttention.backward`` (the
    plain recompute): its device time inside a train step."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        self.cls, self.saved, self.events = ops.KernelAttention, ops.KernelAttention.backward, []
        saved, events = self.saved, self.events

        def backward(ctx, grad_out):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = saved(ctx, grad_out)
            e1.record()
            events.append((e0, e1))
            return out

        self.cls.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.saved)

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in self.events) / 1e3


def finite(x) -> bool:
    return bool(np.isfinite(float(x)))


def phase_lm_train():
    """``make_lm_train_step(cfg, accum=2, lr=constant(3e-4))`` on
    qwen2-1.5b's ``full_config()`` (bf16 compute, f32 masters, remat full),
    6 steps on one repeated batch of 2 × 2 × 4096 tokens.  Returns the
    kernel's launches over the 6 steps and the step record."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import make_lm_train_step
    from repro_torch.data import lm_batch
    from repro_torch.kernels.flash_attention import launches, reset_launches
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import constant

    cfg = get_arch(LM_ARCH).full_config()
    check(cfg.remat and cfg.remat_policy == "full" and cfg.dtype == torch.bfloat16,
          f"lm_train: unexpected config {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_params(cfg, LM_SEED, device="cuda")
    step_fn, opt_init = make_lm_train_step(cfg, accum=TRAIN_ACCUM, lr=constant(TRAIN_LR))
    opt_state = opt_init(params)
    b = lm_batch(0, 0, TRAIN_ACCUM * TRAIN_MICRO, TRAIN_SEQ, cfg.vocab_size)
    batch = {k: torch.from_numpy(v).reshape(TRAIN_ACCUM, TRAIN_MICRO, TRAIN_SEQ).to("cuda")
             for k, v in b.items()}
    tokens = TRAIN_ACCUM * TRAIN_MICRO * TRAIN_SEQ
    per_step = cfg.n_layers * TRAIN_ACCUM * (2 if cfg.remat else 1)
    losses, gnorms, walls, step_launches = [], [], [], []
    torch.cuda.synchronize()
    reset_launches()
    for _ in range(TRAIN_STEPS):
        n0 = launches["flash_attention"]
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        step_launches.append(launches["flash_attention"] - n0)
    n_launch = launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(walls[1:]))
    rec = {"arch": LM_ARCH, "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
           "accum": TRAIN_ACCUM, "micro_batch": TRAIN_MICRO, "seq": TRAIN_SEQ,
           "tokens_per_step": tokens, "lr": TRAIN_LR, "losses": losses, "gnorms": gnorms,
           "step_walls_s": walls, "step_s_median_2_6": step_s, "tokens_per_s": tokens / step_s,
           "model_flop_per_step": 6 * cfg.n_active_params() * tokens,
           "mfu_vs_989_tflops": 6 * cfg.n_active_params() * tokens / step_s / BF16_TENSOR_FLOP_PER_S,
           "peak_device_bytes": peak, "launches_per_step": step_launches,
           "expected_launches_per_step": per_step, "flash_attention_launches": n_launch}
    emit({"phase": "lm_train", **rec})
    check(all(finite(x) for x in losses + gnorms), f"lm_train: non-finite loss or gnorm {rec}")
    check(np.mean(losses[-2:]) < np.mean(losses[:2]) - 0.1,
          f"lm_train: the loss did not fall by 0.1: {losses}")
    check(step_launches == [per_step] * TRAIN_STEPS,
          f"lm_train: kernel launches per step {step_launches}, expected {per_step}")

    # one more step under the profiler: busy and idle share, time by kernel,
    # the attention kernel's forward against the plain recompute's backward
    with timed_attention_backward() as bwd:
        prof = profiled(lambda: step_fn(params, opt_state, batch), all_device=True)
    prof["attention_kernel_forward_s"] = sum(r["s"] for r in prof.pop("all_device")
                                             if "fa_fwd" in r["name"])
    prof["attention_plain_backward_s"] = bwd.seconds()
    prof["attention_backward_calls"] = len(bwd.events)
    emit({"phase": "lm_train_profile", "window": "one train step", **prof})
    rec["profile"] = prof
    rec["dryrun"] = walked_step(step_fn, (params, opt_state, batch), cfg.dtype,
                                rec["model_flop_per_step"], step_s, cfg=cfg)
    del params, opt_state, batch, m
    torch.cuda.empty_cache()
    rec["hold"] = train_hold_against_cpu()
    return n_launch, rec


def train_hold_against_cpu():
    """A reduced qwen2 (2 layers, d_model 256, 2/1 heads of 128, QKV bias,
    vocab 250 padded to 256, f32) on the same weights on the card (the
    kernel under autograd) and on the CPU (the plain version): 3 steps of
    ``make_lm_train_step``, loss and gnorm of each step within 1e-4
    relative.  TF32 off."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import make_lm_train_step
    from repro_torch.data import lm_batch
    from repro_torch.kernels.flash_attention import launches
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import constant

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(LM_ARCH).full_config(), n_layers=2, d_model=256,
                              n_heads=2, n_kv_heads=1, d_ff=512, vocab_size=250, vocab_pad=64,
                              dtype=torch.float32)
    tree = tfm.params_to_numpy(tfm.init_params(cfg, 1, device="cpu"))
    runs = {}
    for dev in ("cuda", "cpu"):
        params = tfm.params_from_numpy(tree, cfg, device=dev)
        step_fn, opt_init = make_lm_train_step(cfg, accum=2, lr=constant(1e-3))
        opt_state = opt_init(params)
        n0, out = launches["flash_attention"], []
        for i in range(3):
            b = lm_batch(1, i, 2, 512, cfg.vocab_size)
            batch = {k: torch.from_numpy(v).reshape(2, 1, 512).to(dev) for k, v in b.items()}
            params, opt_state, m = step_fn(params, opt_state, batch)
            out.append((float(m["loss"]), float(m["gnorm"])))
        runs[dev] = {"steps": out, "launches": launches["flash_attention"] - n0}
    rel = max(abs(a - b) / abs(b) for s_gpu, s_cpu in zip(runs["cuda"]["steps"], runs["cpu"]["steps"])
              for a, b in zip(s_gpu, s_cpu))
    rec = {"cuda": runs["cuda"], "cpu": runs["cpu"], "max_rel": rel, "tol": TRAIN_HOLD_TOL}
    emit({"phase": "lm_train_hold", **rec})
    check(runs["cuda"]["launches"] == 3 * 2 * cfg.n_layers * 2,
          f"lm_train_hold: {runs['cuda']['launches']} kernel launches on the card")
    check(runs["cpu"]["launches"] == 0, "lm_train_hold: the CPU run launched the kernel")
    check(rel <= TRAIN_HOLD_TOL, f"lm_train_hold: card vs CPU relative {rel} > {TRAIN_HOLD_TOL}")
    return rec


# ---------------------------------------------------------------------------
# phase 14: the train and serve CLIs, and the MoE layer at full width
# ---------------------------------------------------------------------------


def run_cli(module, *flags):
    """``python -m repro_torch.launch.<module> flags`` in a subprocess: its
    stdout lines and seconds; fails on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{module}", *flags],
                       capture_output=True, text=True, env=env, cwd=HERE, timeout=600)
    check(r.returncode == 0, f"{module} {' '.join(flags)}: exit {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    return r.stdout.strip().splitlines(), time.perf_counter() - t0


def final_loss(lines) -> float:
    check(lines[-1].startswith("done: final loss "), f"train CLI: last line {lines[-1]!r}")
    return float(lines[-1].split()[3])


def phase_train_cli():
    """The smoke-config train CLI on the card (head dim 16 in f32 through the
    kernel under autograd): 10 steps with a checkpoint, resumed to 20, against
    an uninterrupted 20; granite's MoE smoke config; the smoke-config serve
    CLI."""
    smoke = ("--arch", LM_ARCH, "--smoke", "--log-every", "5")
    with tempfile.TemporaryDirectory() as tmp:
        first, t1 = run_cli("train", *smoke, "--steps", "10", "--ckpt", f"{tmp}/d",
                            "--ckpt-every", "10")
        resumed, t2 = run_cli("train", *smoke, "--steps", "20", "--ckpt", f"{tmp}/d")
        whole, t3 = run_cli("train", *smoke, "--steps", "20", "--ckpt", f"{tmp}/w")
        ends = [np.load(f"{tmp}/{d}/step_000000020/arrays.npz") for d in ("d", "w")]
        param_err = max(float(np.abs(ends[0][k] - ends[1][k]).max()) for k in ends[1].files
                        if k.startswith("params/"))
    check(resumed[0] == "resumed from step 10", f"train CLI: first line {resumed[0]!r}")
    loss_r, loss_w = final_loss(resumed), final_loss(whole)
    moe, t4 = run_cli("train", "--arch", MOE_ARCH, "--smoke", "--steps", "10")
    serve_lines, t5 = run_cli("serve", "--arch", LM_ARCH)
    rec = {"first": first[-1], "resumed": resumed, "uninterrupted_final": whole[-2:],
           "final_loss_resumed": loss_r, "final_loss_uninterrupted": loss_w,
           "final_params_max_abs_diff": param_err, "tol": RESUME_TOL,
           "moe_smoke": moe[-2:], "serve_smoke": serve_lines,
           "seconds": [t1, t2, t3, t4, t5]}
    emit({"phase": "train_cli", **rec})
    # the printed losses carry 4 decimals: one unit of the last is allowed
    check(abs(loss_r - loss_w) <= RESUME_TOL + 1e-9,
          f"train CLI: resumed final loss {loss_r} vs uninterrupted {loss_w}")
    check(finite(final_loss(moe)), f"train CLI (MoE): final loss {moe[-1]!r}")
    check(len(serve_lines) == 3 and serve_lines[2].startswith("sample continuation ids"),
          f"serve CLI: {serve_lines}")
    return rec


def moe_layer_hold():
    """``_moe`` at granite's full layer width (T 4,096, d 1536, 40 experts,
    top-8, d_ff 512) on the card and on the CPU in f32, TF32 off: output and
    the gradients of the input and of each weight within 1e-4 of each
    tensor's max; with a random router, and with tied ones (columns
    repeated in pairs; zeros), where the stable sort must put the lower
    expert first on the card as on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(MOE_ARCH).full_config(), dtype=torch.float32)
    rng = np.random.default_rng(14)
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    arrays = {"h": rng.standard_normal((MOE_TOKENS, d), dtype=np.float32),
              "router": rng.standard_normal((d, e), dtype=np.float32) * d ** -0.5,
              "w_gate": rng.standard_normal((e, d, ff), dtype=np.float32) * d ** -0.5,
              "w_up": rng.standard_normal((e, d, ff), dtype=np.float32) * d ** -0.5,
              "w_down": rng.standard_normal((e, ff, d), dtype=np.float32) * ff ** -0.5}
    grad_out = torch.from_numpy(rng.standard_normal((MOE_TOKENS, d), dtype=np.float32))
    routers = {"random": arrays["router"],
               "pairs": np.repeat(arrays["router"][:, :e // 2], 2, axis=1),
               "zeros": np.zeros_like(arrays["router"])}
    names = ["out"] + [f"d_{k}" for k in arrays]
    errs = {}
    for label, router in routers.items():
        n = MOE_TOKENS if label == "random" else MOE_TIED_TOKENS
        res = {}
        for dev in ("cuda", "cpu"):
            t = {k: torch.from_numpy(router if k == "router" else a[:n] if k == "h" else a)
                 .to(dev).requires_grad_() for k, a in arrays.items()}
            out = tfm._moe(t["h"], {k: v for k, v in t.items() if k != "h"}, cfg)
            grads = torch.autograd.grad(out, list(t.values()), grad_out[:n].to(dev))
            res[dev] = [out.detach().cpu()] + [g.cpu() for g in grads]
        errs[label] = {n: rel_to_max(a, b) for n, a, b in zip(names, res["cuda"], res["cpu"])}
    rec = {"tokens": MOE_TOKENS, "tied_tokens": MOE_TIED_TOKENS, "d_model": d, "experts": e,
           "top_k": cfg.top_k, "d_ff": ff,
           "rel_to_max": errs, "tol": MOE_TOL}
    emit({"phase": "moe_layer", **rec})
    check(all(x <= MOE_TOL for r in errs.values() for x in r.values()),
          f"moe_layer: card vs CPU {errs}")
    return rec


def phase_moe_full():
    """granite-moe-3b-a800m's ``full_config()`` at full width, its depth cut
    to ``MOE_LAYERS``: two train steps at 1 × 2048
    (finite losses, the peak recorded), then ``serve()`` at batch 2, prompt
    2048, 16 tokens on the trained weights (finite logits, no padded column
    wins).  Returns the kernel's launches (train, serve)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import make_lm_train_step
    from repro_torch.data import lm_batch
    from repro_torch.kernels.flash_attention import launches, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import constant

    import dataclasses

    cfg = dataclasses.replace(get_arch(MOE_ARCH).full_config(), n_layers=MOE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_params(cfg, LM_SEED, device="cuda")
    step_fn, opt_init = make_lm_train_step(cfg, accum=1, lr=constant(TRAIN_LR))
    opt_state = opt_init(params)
    reset_launches()
    losses, walls = [], []
    for i in range(2):
        b = lm_batch(0, i, 1, MOE_TRAIN_SEQ, cfg.vocab_size)
        batch = {k: torch.from_numpy(v)[None].to("cuda") for k, v in b.items()}
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    train_launches = launches["flash_attention"]
    train_peak = torch.cuda.max_memory_allocated()
    del opt_state, m
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(MOE_BATCH, MOE_PROMPT), dtype=np.int64))
    reset_launches()
    toks, t = serve(cfg, params, prompts, MOE_GEN)
    serve_launches = launches["flash_attention"]
    last, kv = tfm.prefill(params, prompts, cfg)
    del kv
    rec = {"arch": MOE_ARCH, "layers": cfg.n_layers, "n_params": cfg.n_params(),
           "n_active_params": cfg.n_active_params(),
           "train_seq": MOE_TRAIN_SEQ, "losses": losses, "step_walls_s": walls,
           "train_peak_device_bytes": train_peak, "train_launches": train_launches,
           "serve_batch": MOE_BATCH, "prompt": MOE_PROMPT, "gen": MOE_GEN,
           "prefill_ms": t["prefill_s"] * 1e3, "decode_ms_per_step": t["decode_s"] * 1e3 /
           t["decode_steps"], "serve_peak_device_bytes": torch.cuda.max_memory_allocated(),
           "serve_launches": serve_launches, "sample": toks[0, :8].tolist()}
    emit({"phase": "moe_full", **rec})
    check(all(finite(x) for x in losses), f"moe_full: losses {losses}")
    check(train_launches == 2 * cfg.n_layers * 2,
          f"moe_full: {train_launches} kernel launches in 2 train steps")
    check(serve_launches == cfg.n_layers, f"moe_full: {serve_launches} launches per prefill")
    check(bool(torch.isfinite(last[:, :cfg.vocab_size]).all()), "moe_full: non-finite logits")
    check(bool((last.argmax(-1) < cfg.vocab_size).all()), "moe_full: a padded vocab column won")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "moe_full: token outside the vocab")
    del params, last
    torch.cuda.empty_cache()
    return train_launches, serve_launches, rec


# ---------------------------------------------------------------------------
# phase 15: the int8 KV cache
# ---------------------------------------------------------------------------


def kv_int8_functions_hold():
    """``quantize_kv_token`` and ``decode_attention_int8`` on the card
    against the CPU on the same CPU-made inputs at the serving decode shape
    (q (4, 12, 1, 128), K/V (4, 2, 2080, 128)), with a scalar and a (B,)
    ``cache_len``: payloads and scales bit-equal, the output within
    ``KV_DECODE_REL`` of the CPU output's max."""
    from repro_torch.models.attention import decode_attention_int8, quantize_kv_token

    rng = np.random.default_rng(15)
    s = LM_PROMPT + LM_GEN
    q = torch.from_numpy(rng.standard_normal((LM_BATCH, 12, 1, 128), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((LM_BATCH, 2, s, 128), dtype=np.float32))
            for _ in range(2))
    lens = torch.tensor([s, 1, 1000, 2049], dtype=torch.int32)
    res = {}
    for dev in ("cuda", "cpu"):
        cache = quantize_kv_token(k.to(dev), v.to(dev))
        outs = [decode_attention_int8(q.to(dev), *cache, cache_len=cl)
                for cl in (s, lens.to(dev))]
        res[dev] = [t.cpu() for t in (*cache, *outs)]
    payload_equal = all(torch.equal(a, b) for a, b in zip(res["cuda"][:4], res["cpu"][:4]))
    errs = [rel_to_max(a, b) for a, b in zip(res["cuda"][4:], res["cpu"][4:])]
    rec = {"payloads_scales_bit_equal": payload_equal, "decode_rel_to_max": errs,
           "tol": KV_DECODE_REL, "shape_q": list(q.shape), "shape_kv": list(k.shape)}
    emit({"phase": "kv_int8_functions", **rec})
    check(payload_equal, "kv_int8: quantize_kv_token card vs CPU not bit-equal")
    check(max(errs) <= KV_DECODE_REL,
          f"kv_int8: decode_attention_int8 card vs CPU {errs} > {KV_DECODE_REL}")
    return rec


def phase_kv_int8():
    """qwen2-1.5b's ``full_config()`` at the phase-10 shape served with the
    int8 KV cache (``kv_quant=True``: the prefill's K/V quantized per token,
    decode through the int8 dots) beside the bf16 cache: the cache's dtype
    and bytes, the first step's logits against the bf16 cache's, the greedy
    agreement, decode ms/step and the peak of each.  Returns the kernel's
    launches in the two timed serves."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import launches, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.attention import quantize_kv_token

    cfg = get_arch(LM_ARCH).full_config()
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    torch.cuda.empty_cache()
    params = tfm.init_params(cfg, LM_SEED, device="cuda")
    prompts = torch.from_numpy(np.random.default_rng(2407).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT), dtype=np.int64))
    max_len = LM_PROMPT + LM_GEN
    cache_q = tfm.init_kv_cache_int8(cfgq, LM_BATCH, max_len, device="cuda")
    cache_b = tfm.init_kv_cache(cfg, LM_BATCH, max_len, device="cuda")
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    bytes_q, bytes_b = nbytes(cache_q), nbytes(cache_b)
    dtypes = [str(t.dtype) for t in cache_q]

    # the first decode step from the same prefill, through each cache
    last, kv = tfm.prefill(params, prompts.cuda(), cfg)
    nxt = last.argmax(-1).to(torch.int32)
    for dst, src in zip(cache_b, kv):
        dst[:, :, :, :LM_PROMPT] = src
    for dst, src in zip(cache_q, quantize_kv_token(kv[0], kv[1])):
        dst[:, :, :, :LM_PROMPT] = src
    del kv, last
    lf, _ = tfm.decode_step(params, nxt, LM_PROMPT, cache_b, cfg)
    lq, cache_q = tfm.decode_step(params, nxt, LM_PROMPT, cache_q, cfgq)
    real = slice(0, cfg.vocab_size)
    rel = float((lf[:, real] - lq[:, real]).abs().max() / lf[:, real].abs().max())
    first_agree = bool((lf.argmax(-1) == lq.argmax(-1)).all())
    stays_int8 = cache_q[0].dtype == torch.int8 and cache_q[2].dtype == torch.int8
    del cache_b, cache_q, lf, lq

    runs, n_launch = {}, 0
    for label, c in (("bf16", cfg), ("int8", cfgq)):
        serve(c, params, prompts, LM_GEN)                         # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        toks, t = serve(c, params, prompts, LM_GEN)
        n_launch += launches["flash_attention"]
        runs[label] = {"tokens": toks.cpu(), "prefill_ms": t["prefill_s"] * 1e3,
                       "decode_ms_per_step": t["decode_s"] * 1e3 / t["decode_steps"],
                       "peak_device_bytes": torch.cuda.max_memory_allocated(),
                       "launches": launches["flash_attention"]}
    agree = float((runs["bf16"]["tokens"] == runs["int8"]["tokens"]).float().mean())
    rec = {"arch": LM_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
           "cache_dtypes": dtypes, "cache_bytes_int8": bytes_q, "cache_bytes_bf16": bytes_b,
           "first_step_logits_rel_to_max": rel, "first_step_tol": KV_LOGITS_REL,
           "first_step_argmax_agrees": first_agree, "greedy_agreement": agree,
           **{f"{k}_{label}": v for label, r in runs.items() for k, v in r.items()
              if k != "tokens"}}
    emit({"phase": "kv_int8", **rec})
    check(stays_int8, f"kv_int8: the cache left int8 ({dtypes})")
    check(rel < KV_LOGITS_REL, f"kv_int8: first-step logits {rel} from the bf16 cache's")
    check(runs["int8"]["launches"] == runs["bf16"]["launches"] == cfg.n_layers,
          f"kv_int8: kernel launches per serve {runs['bf16']['launches']}, "
          f"{runs['int8']['launches']}")
    del params
    torch.cuda.empty_cache()
    rec["functions"] = kv_int8_functions_hold()
    return n_launch, rec


# ---------------------------------------------------------------------------
# phase 16: the sharded train step, compress_grads, elastic restore
# ---------------------------------------------------------------------------


def grid_mesh(devices, shape, names=("data", "model")):
    from repro_torch.distributed import Mesh

    return Mesh(np.array(devices, dtype=object).reshape(shape), names)


def train_two_ways(cfg, mesh, accum, micro, seq, steps):
    """``make_lm_train_step`` on one card (the mesh's lead) and sharded over
    ``mesh`` by the reference's rules, from the same weights and batch:
    the two runs' metrics, launches, walls and differences."""
    from repro_torch.configs.lm_common import _opt_state_specs, _param_specs, \
        make_lm_train_step
    from repro_torch.data import lm_batch
    from repro_torch.distributed import NamedSharding, P, device_put
    from repro_torch.kernels.flash_attention import launches
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import constant
    from repro_torch.optim.optimizers import tree_leaves

    lead = mesh.lead
    raw = lm_batch(0, 0, accum * micro, seq, cfg.vocab_size)
    batch = {k: torch.from_numpy(v).reshape(accum, micro, seq) for k, v in raw.items()}
    step_fn, opt_init = make_lm_train_step(cfg, accum=accum, lr=constant(TRAIN_LR))
    runs = {}
    for label in ("single", "sharded"):
        torch.cuda.empty_cache()
        for d in mesh.distinct:
            torch.cuda.reset_peak_memory_stats(d)
        params = tfm.init_params(cfg, LM_SEED, device=lead)
        if label == "single":
            state, b = params, {k: v.to(lead) for k, v in batch.items()}
        else:
            _, psh, _ = _param_specs(cfg, mesh)
            state = device_put(tfm.param_tree(params), psh)
            del params
            b = device_put(batch, {k: NamedSharding(mesh, P(None, "data", None)) for k in batch})
        opt = opt_init(state)
        if label == "sharded":
            check(all(m.spec == p.spec for m, p in zip(tree_leaves(opt.mu), tree_leaves(state))),
                  "lm_sharded: moments not laid out as their parameters")
            check(_opt_state_specs(psh).mu is psh, "lm_sharded: _opt_state_specs")
        metrics, walls, n0 = [], [], launches["flash_attention"]
        for _ in range(steps):
            t0 = time.perf_counter()
            state, opt, m = step_fn(state, opt, b)
            for d in mesh.distinct:
                torch.cuda.synchronize(d)
            walls.append(time.perf_counter() - t0)
            metrics.append((float(m["loss"]), float(m["gnorm"])))
        leaves = tfm.param_tree(state) if label == "single" else state
        runs[label] = {
            "metrics": metrics, "walls_s": walls, "launches": launches["flash_attention"] - n0,
            "peak_device_bytes": {str(d): torch.cuda.max_memory_allocated(d)
                                  for d in mesh.distinct},
            "params": [(x if label == "single" else x.gather(lead)).detach().cpu()
                       for x in tree_leaves(leaves)],
            "mu": [(x if label == "single" else x.gather(lead)).cpu()
                   for x in tree_leaves(opt.mu)],
        }
        del state, opt, b, leaves
    one, sh = runs["single"], runs["sharded"]
    param_err = max(float(((a - b).abs() - SHARD_PARAM_TOL * b.abs()).max())
                    for a, b in zip(sh["params"], one["params"]))
    rec = {
        "mesh": dict(mesh.shape), "layers": cfg.n_layers, "d_model": cfg.d_model,
        "accum": accum, "micro_batch": micro, "seq": seq, "steps": steps,
        "dtype": str(cfg.dtype), "lr": TRAIN_LR,
        "single": {k: v for k, v in one.items() if k not in ("params", "mu")},
        "sharded": {k: v for k, v in sh.items() if k not in ("params", "mu")},
        "param_max_abs_diff": max(float((a - b).abs().max())
                                  for a, b in zip(sh["params"], one["params"])),
        "param_excess_over_rtol": param_err,
        "mu_rel_to_max": max(rel_to_max(a, b) for a, b in zip(sh["mu"], one["mu"])),
        "loss_abs_diff": max(abs(a[0] - b[0]) for a, b in zip(sh["metrics"], one["metrics"])),
        "gnorm_rel_diff": max(abs(a[1] - b[1]) / b[1]
                              for a, b in zip(sh["metrics"], one["metrics"])),
    }
    return rec


def compress_grads_hold(devices, shape, names, axis):
    """``compress_grads`` over ``devices`` against the same shards on a CPU
    mesh of that shape: 3 steps with error feedback, synchronised
    gradients and the new state bit-equal."""
    from repro_torch.distributed import compress_grads, make_error_feedback_state

    rng = np.random.default_rng(16)
    n = int(np.prod(shape))
    host = [{"w": torch.from_numpy(rng.standard_normal((4096,), dtype=np.float32)),
             "b": torch.from_numpy(rng.standard_normal((7, 33), dtype=np.float32) * 1e-3)}
            for _ in range(n)]
    out = {}
    for label, devs in (("card", devices), ("cpu", ["cpu"] * n)):
        mesh = grid_mesh(devs, shape, names)
        shards = [{k: t.to(d) for k, t in g.items()} for g, d in zip(host, mesh.devices.flat)]
        ef, hist = make_error_feedback_state(shards), []
        for _ in range(3):
            sync, ef = compress_grads(shards, ef, mesh, axis)
            hist.append([t.cpu() for tree in sync + ef for t in (tree["b"], tree["w"])])
        out[label] = hist
    equal = all(torch.equal(a, b) for sa, sb in zip(out["card"], out["cpu"])
                for a, b in zip(sa, sb))
    return {"devices": [str(d) for d in devices], "shape": list(shape), "axis": axis,
            "bit_equal": equal}


def elastic_restore_hold(leaf, devices):
    """A checkpoint of ``{"w": arange(64) (8, 8), "wq": a sharded leaf}``
    restored onto (2, 4) and then (4, 2) meshes of ``devices``: equal
    values, the mesh shape as asked."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import NamedSharding, P

    tree = {"w": torch.arange(64.0).reshape(8, 8), "wq": leaf}
    want = {k: np.asarray(v) for k, v in tree.items()}
    rec = {}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_save=False)
        mgr.save(5, tree)
        for shape in [(2, 4), (4, 2)]:
            mesh = grid_mesh(devices, shape)
            sh = {k: NamedSharding(mesh, P("data", "model")) for k in tree}
            got, step, _ = mgr.restore_latest(tree, shardings=sh)
            rec[str(shape)] = ok = (
                step == 5 and all(np.array_equal(np.asarray(got[k]), want[k]) for k in tree)
                and all(got[k].sharding.mesh.devices.shape == shape for k in tree)
                and got["wq"].blocks[1, 1].device == mesh.devices[1, 1])
            check(ok, f"elastic restore onto {shape} differs")
    return rec


def check_sharded(rec, what):
    check(rec["param_excess_over_rtol"] <= SHARD_PARAM_TOL,
          f"{what}: parameters beyond {SHARD_PARAM_TOL} of the single-card step's")
    check(rec["loss_abs_diff"] <= SHARD_LOSS_TOL,
          f"{what}: loss {rec['loss_abs_diff']} from the single-card step's")
    check(rec["gnorm_rel_diff"] <= SHARD_GNORM_REL,
          f"{what}: gnorm {rec['gnorm_rel_diff']} from the single-card step's")
    check(all(finite(x) for m in rec["sharded"]["metrics"] for x in m),
          f"{what}: non-finite metrics")


def phase_lm_sharded():
    """qwen2-1.5b at full width cut to ``SHARD_LAYERS`` layers (f32, TF32
    off): the sharded step on a (2, 4) mesh of eight repeats of the card
    against the step on the card; the attention kernel launched once per
    replica for each launch of the single-card step; ``compress_grads`` on
    the card bit-equal to the CPU; elastic restore (2, 4) → (4, 2).
    Returns the kernel's launches in the sharded run."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.distributed import NamedSharding, P, device_put

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(LM_ARCH).full_config(), n_layers=SHARD_LAYERS,
                              dtype=torch.float32)
    mesh = grid_mesh(["cuda"] * 8, SHARD_MESH)
    rec = train_two_ways(cfg, mesh, SHARD_ACCUM, SHARD_MICRO, SHARD_SEQ, SHARD_STEPS)
    n_rep = SHARD_MESH[0]
    per_step = cfg.n_layers * SHARD_ACCUM * (2 if cfg.remat else 1)
    rec["expected_launches"] = {"single": SHARD_STEPS * per_step,
                                "sharded": n_rep * SHARD_STEPS * per_step}
    rec["compress_grads"] = [compress_grads_hold(["cuda"] * 8, (8,), ("data",), "data"),
                             compress_grads_hold(["cuda"] * 8, (2, 4), ("data", "model"), "data")]
    wq = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (cfg.d_model, cfg.d_model), dtype=np.float32))
    leaf = device_put(wq, NamedSharding(mesh, P("data", "model")))
    rec["elastic_restore"] = elastic_restore_hold(leaf, ["cuda"] * 8)
    emit({"phase": "lm_sharded", **rec})
    check_sharded(rec, "lm_sharded")
    check(rec["single"]["launches"] == rec["expected_launches"]["single"],
          f"lm_sharded: {rec['single']['launches']} launches in the single-card steps")
    check(rec["sharded"]["launches"] == n_rep * rec["single"]["launches"],
          f"lm_sharded: {rec['sharded']['launches']} launches, expected {n_rep} × "
          f"{rec['single']['launches']} (one per replica per launch of the single-card step)")
    check(all(c["bit_equal"] for c in rec["compress_grads"]),
          f"lm_sharded: compress_grads on the card differs from the CPU {rec['compress_grads']}")
    torch.cuda.empty_cache()
    return rec["sharded"]["launches"], rec


def phase_lm_sharded_cards():
    """``--cards``: the full 28-layer qwen2-1.5b (f32, TF32 off) sharded
    over a (2, 2) mesh of four cards, 2 steps, against the step on the lead
    card, each card's peak; ``compress_grads`` over the four cards
    bit-equal to the CPU."""
    import dataclasses

    from repro_torch.configs import get_arch

    check(torch.cuda.device_count() >= 4, "--cards: the sharded step needs 4 cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch(LM_ARCH).full_config(), dtype=torch.float32)
    cards = [f"cuda:{i}" for i in range(4)]
    mesh = grid_mesh(cards, CARDS_MESH)
    rec = train_two_ways(cfg, mesh, SHARD_ACCUM, SHARD_MICRO, SHARD_SEQ, SHARD_STEPS)
    rec["compress_grads"] = compress_grads_hold(cards, (4,), ("data",), "data")
    emit({"phase": "lm_sharded_cards", **rec})
    check_sharded(rec, "lm_sharded_cards")
    check(rec["compress_grads"]["bit_equal"], "--cards: compress_grads differs from the CPU")
    return rec


# ---------------------------------------------------------------------------
# phases 17-18: GNN and recsys (no kernel of the port on their path: the
# reference's GNN and DIN code is XLA, so the port's is torch ops)
# ---------------------------------------------------------------------------


def kernel_launches() -> dict:
    """Every kernel's launch count: the triangle-count family and flash attention."""
    from repro_torch.kernels.flash_attention import launches as fa
    from repro_torch.kernels.triangle_count import launches as tc

    return {**tc, **fa}


def reset_kernel_launches() -> None:
    from repro_torch.kernels.flash_attention import reset_launches as reset_fa
    from repro_torch.kernels.triangle_count import reset_launches as reset_tc

    reset_tc()
    reset_fa()


def timed(fn):
    """(fn()'s result, its seconds), the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_steps(step, params, opt, n, inputs_of):
    """``n`` steps of ``step(params, opt, *inputs_of(i))``: the final params
    and opt state, the losses and each step's seconds."""
    losses, walls = [], []
    for i in range(n):
        inputs = inputs_of(i)
        (params, opt, m), s = timed(lambda: step(params, opt, *inputs))
        losses.append(float(m["loss"]))
        walls.append(s)
    return params, opt, losses, walls


def all_finite(params) -> bool:
    from repro_torch.optim.optimizers import tree_leaves

    return all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))


def gnn_hold_against_cpu():
    """The four archs at their full-shape widths (``make_cfg(1433, 7)``) on a
    Cora-size graph (``full_graph_sm``: 10,556 uniform random directed
    edges) on the card and on the CPU: the same numpy weights, features,
    labels and ``_synth_positions``, f32 with TF32 off.  Forward within
    ``GNN_HOLD_FWD`` of the output's max, the loss (``_ce_loss``) within
    ``GNN_HOLD_LOSS`` relative, each gradient leaf within ``GNN_HOLD_GRAD``
    of its max.  Returns the numpy inputs."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import value_and_grad
    from repro_torch.configs.gnn_common import GNN_SHAPES, _ce_loss, _synth_positions
    from repro_torch.data import graph_node_features
    from repro_torch.optim.optimizers import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    shape = GNN_SHAPES["full_graph_sm"]
    n, e = shape["n_nodes"], shape["n_edges"]
    edges = np.random.default_rng(GNN_SEED).integers(0, n, size=(e, 2)).astype(np.int32)
    feat, labels = graph_node_features(GNN_SEED, n, shape["d_feat"], shape["n_classes"])
    pos = _synth_positions(torch.arange(n, dtype=torch.int32)).numpy()
    arrays = (feat, pos, edges[:, 0].copy(), edges[:, 1].copy(), labels)
    recs = []
    for arch in GNN_ARCHS:
        mod = get_arch(arch)
        cfg = mod.make_cfg(shape["d_feat"], shape["n_classes"])
        tree = mod.MODEL.params_to_numpy(mod.MODEL.init_params(cfg, GNN_SEED, device="cpu"))
        runs = {}
        for dev in ("cuda", "cpu"):
            params = mod.MODEL.params_from_numpy(tree, cfg, device=dev)
            x = [torch.from_numpy(a).to(dev) for a in arrays]
            with torch.no_grad():
                out = mod.MODEL.apply(params, cfg, *x[:4])
            loss, grads = value_and_grad(
                lambda p: _ce_loss(mod.MODEL.apply(p, cfg, *x[:4]), x[4]), params)
            runs[dev] = (out, float(loss), tree_leaves(grads))
        (out_g, loss_g, grads_g), (out_c, loss_c, grads_c) = runs["cuda"], runs["cpu"]
        rec = {"arch": arch, "forward_rel": rel_to_max(out_g.cpu(), out_c), "loss_cuda": loss_g,
               "loss_cpu": loss_c, "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
               "grad_rel": max(rel_to_max(a.cpu(), b) for a, b in zip(grads_g, grads_c)),
               "grad_leaves": len(grads_c)}
        recs.append(rec)
        emit({"phase": "gnn_hold", **rec,
              "tol": {"forward": GNN_HOLD_FWD, "loss": GNN_HOLD_LOSS, "grad": GNN_HOLD_GRAD}})
        check(rec["forward_rel"] <= GNN_HOLD_FWD, f"gnn_hold {arch}: forward {rec}")
        check(rec["loss_rel"] <= GNN_HOLD_LOSS, f"gnn_hold {arch}: loss {rec}")
        check(rec["grad_rel"] <= GNN_HOLD_GRAD, f"gnn_hold {arch}: gradients {rec}")
    return arrays, recs


def gcn_cora_train(arrays):
    """``gcn-cora`` at ``full_graph_sm``: ``GNN_CORA_STEPS`` steps of the
    full-shape step (AdamW constant(1e-3)) on ``graph_node_features``'
    community-structured labels; the loss falls."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import _full_step

    mod = get_arch("gcn-cora")
    step, opt_init, cfg = _full_step(mod.MODEL, mod.make_cfg, "full_graph_sm")
    params = mod.MODEL.init_params(cfg, GNN_SEED, device="cuda")
    x = [torch.from_numpy(a).to("cuda") for a in arrays]
    _, _, losses, walls = train_steps(step, params, opt_init(params), GNN_CORA_STEPS,
                                      lambda i: x)
    rec = {"arch": "gcn-cora", "shape": "full_graph_sm", "steps": GNN_CORA_STEPS,
           "first_loss": losses[0], "last_loss": losses[-1],
           "step_ms_median": 1e3 * float(np.median(walls[1:]))}
    emit({"phase": "gnn_cora_train", **rec})
    check(all(finite(v) for v in losses) and losses[-1] < losses[0],
          f"gnn_cora_train: the loss did not fall {losses}")
    return rec


def graph_on_card(shape, gen):
    """A graph of ``shape``'s nodes and directed edges, endpoints uniform,
    made on the card: (src, dst, features, labels), the features as
    ``graph_node_features`` makes them (class centres + 0.5 · noise)."""
    n, e, d, c = shape["n_nodes"], shape["n_edges"], shape["d_feat"], shape["n_classes"]
    src = torch.randint(0, n, (e,), generator=gen, device="cuda", dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=gen, device="cuda", dtype=torch.int32)
    labels = torch.randint(0, c, (n,), generator=gen, device="cuda", dtype=torch.int32)
    centres = torch.randn((c, d), generator=gen, device="cuda")
    feat = centres.index_select(0, labels) + 0.5 * torch.randn((n, d), generator=gen,
                                                                device="cuda")
    return src, dst, feat, labels


def csr_on_card(src, dst, n):
    """(row_offsets, col) int32 with the edges' sources as rows.  The
    endpoints are independent and uniform, so the destinations need no
    reordering: the CSR's column array is ``dst`` as drawn."""
    from repro_torch.distributed import ensure_fits_int32

    row = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    torch.cumsum(torch.bincount(src.to(torch.int64), minlength=n), 0, out=row[1:])
    ensure_fits_int32(int(row[-1]), "row_offsets")
    return row.to(torch.int32), dst


def sampled_children_are_neighbours(blocks, row, col, fanouts) -> dict:
    """Every child of every parent in ``blocks`` is one of the parent's CSR
    neighbours, or the parent itself where it has none."""
    bad, pairs = 0, 0
    for parents, children, f in zip(blocks.frontiers, blocks.frontiers[1:], fanouts):
        p = parents.repeat_interleave(f)
        start = row.index_select(0, p).to(torch.int64)
        deg = row.index_select(0, p + 1).to(torch.int64) - start
        lanes = torch.arange(int(deg.max()), device="cuda")
        listed = col[(start[:, None] + lanes[None, :]).clamp_max(col.numel() - 1)]
        hit = ((listed == children[:, None]) & (lanes[None, :] < deg[:, None])).any(1)
        hit |= (deg == 0) & (children == p)
        bad += int((~hit).sum())
        pairs += children.numel()
    return {"pairs": pairs, "not_neighbours": bad}


def gnn_minibatch(gen):
    """``minibatch_lg`` at its full size: a CSR of Reddit's node and edge
    counts (uniform endpoints) with 602 features and 41 classes, made on
    the card; ``graphsage-reddit`` trained ``GNN_SAGE_STEPS`` steps of batch
    1,024 with fanout (15, 10), ``sample_blocks`` inside each step; the
    sampler's children on ``GNN_MEMBERSHIP_SEEDS`` seeds checked against the
    CSR; ``gcn-cora``, ``schnet`` and ``egnn`` ``GNN_BLOCK_STEPS`` steps each
    through ``block_graph_from_frontiers``."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import GNN_SHAPES, _minibatch_step
    from repro_torch.graphs import sample_blocks

    shape = GNN_SHAPES["minibatch_lg"]
    n, b, fanout = shape["n_nodes"], shape["batch_nodes"], shape["fanout"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (src, dst, feat, labels), build_s = timed(lambda: graph_on_card(shape, gen))
    (row, col), csr_s = timed(lambda: csr_on_card(src, dst, n))
    del src
    base = torch.cuda.memory_allocated()  # the graph: CSR, features, labels

    def batch(i):
        seeds = torch.randint(0, n, (b,), generator=gen, device="cuda", dtype=torch.int32)
        return gen, row, col, feat, seeds, labels.index_select(0, seeds)

    recs = []
    for arch, n_steps in (("graphsage-reddit", GNN_SAGE_STEPS), ("gcn-cora", GNN_BLOCK_STEPS),
                          ("schnet", GNN_BLOCK_STEPS), ("egnn", GNN_BLOCK_STEPS)):
        mod = get_arch(arch)
        step, opt_init, cfg = _minibatch_step(mod.MODEL, mod.make_cfg, "minibatch_lg")
        params = mod.MODEL.init_params(cfg, GNN_SEED, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        params, opt, losses, walls = train_steps(step, params, opt_init(params), n_steps, batch)
        step_s = float(np.median(walls[1:]))
        rec = {"arch": arch, "shape": "minibatch_lg", "steps": n_steps, "losses": losses,
               "step_ms_median": 1e3 * step_s, "seeds_per_s": b / step_s,
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "peak_above_graph_bytes": torch.cuda.max_memory_allocated() - base}
        if arch == "graphsage-reddit":
            rec["split"] = minibatch_split(step, params, opt, batch(0), fanout)
        recs.append(rec)
        emit({"phase": "gnn_minibatch", **rec})
        check(all(finite(v) for v in losses) and all_finite(params),
              f"gnn_minibatch {arch}: non-finite loss or parameters {rec}")
    seeds = torch.randint(0, n, (GNN_MEMBERSHIP_SEEDS,), generator=gen, device="cuda",
                          dtype=torch.int32)
    members = sampled_children_are_neighbours(sample_blocks(gen, row, col, seeds, fanout),
                                              row, col, fanout)
    graph = {"nodes": n, "edges": int(col.numel()), "d_feat": shape["d_feat"],
             "classes": shape["n_classes"], "endpoints": "uniform", "build_s": build_s,
             "csr_s": csr_s, "graph_bytes": base, "membership": members}
    emit({"phase": "gnn_minibatch_graph", **graph})
    check(members["not_neighbours"] == 0, f"gnn_minibatch: sampled non-neighbours {members}")
    del row, col, feat, labels, dst
    torch.cuda.empty_cache()
    return {"graph": graph, "runs": recs}


def minibatch_split(step, params, opt, inputs, fanout) -> dict:
    """Where a ``minibatch_lg`` step's time goes: the sampler alone, the
    frontiers' feature gathers alone (each timed on its own, synchronised),
    and one whole step under the profiler."""
    from repro_torch.graphs import sample_blocks

    gen, row, col, feat, seeds, _ = inputs
    blocks, sampler_s = timed(lambda: sample_blocks(gen, row, col, seeds, fanout))
    _, gathers_s = timed(lambda: [feat.index_select(0, fr) for fr in blocks.frontiers])
    return {"sampler_s": sampler_s, "gathers_s": gathers_s,
            "gathered_bytes": sum(fr.numel() for fr in blocks.frontiers) * feat.shape[1] * 4,
            "profile": profiled(lambda: step(params, opt, *inputs))}


def gnn_molecule():
    """``molecule`` at its full size (128 graphs × 30 nodes × 64 edges, 16
    features): ``schnet`` and ``egnn`` ``GNN_MOL_STEPS`` steps each; EGNN's
    output unchanged within ``EGNN_EQUIV_TOL`` under a rotation and a
    translation of the positions, on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import GNN_SHAPES, _molecule_step
    from repro_torch.graphs import random_molecule_batch

    shape = GNN_SHAPES["molecule"]
    gb = random_molecule_batch(shape["batch"], shape["n_nodes"], shape["n_edges"],
                               shape["d_feat"], seed=GNN_SEED)
    targets = np.random.default_rng(GNN_SEED).normal(size=shape["batch"]).astype(np.float32)
    x = [torch.from_numpy(np.array(a)).to("cuda")
         for a in (gb.node_feat, gb.positions, gb.edge_src, gb.edge_dst, targets)]
    recs = []
    for arch in ("schnet", "egnn"):
        mod = get_arch(arch)
        step, opt_init, cfg = _molecule_step(mod.MODEL, mod.make_cfg, "molecule")
        params = mod.MODEL.init_params(cfg, GNN_SEED, device="cuda")
        params, _, losses, walls = train_steps(step, params, opt_init(params), GNN_MOL_STEPS,
                                               lambda i: x)
        rec = {"arch": arch, "shape": "molecule", "steps": GNN_MOL_STEPS, "first_loss": losses[0],
               "last_loss": losses[-1], "step_ms_median": 1e3 * float(np.median(walls[1:])),
               "graphs_per_s": shape["batch"] / float(np.median(walls[1:]))}
        check(all(finite(v) for v in losses) and all_finite(params),
              f"gnn_molecule {arch}: non-finite loss or parameters {losses}")
        if arch == "egnn":
            rec["equivariance_max_abs"] = egnn_equivariance(mod.MODEL, params, cfg, gb)
            check(rec["equivariance_max_abs"] <= EGNN_EQUIV_TOL,
                  f"gnn_molecule: EGNN not equivariant on the card {rec}")
        recs.append(rec)
        emit({"phase": "gnn_molecule", **rec})
    return recs


def egnn_equivariance(model, params, cfg, gb) -> float:
    """max |out(R·x + t) − out(x)| over the flattened molecule batch."""
    b, nb = gb.node_feat.shape[:2]
    off = (np.arange(b, dtype=np.int32) * nb)[:, None]
    src = np.where(gb.edge_src >= 0, gb.edge_src + off, -1).reshape(-1)
    dst = np.where(gb.edge_dst >= 0, gb.edge_dst + off, -1).reshape(-1)
    th = 1.1
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]],
                   np.float32)
    pos = gb.positions.reshape(b * nb, 3)
    moved = pos @ rot.T + np.array([3.0, -1.0, 2.0], np.float32)
    feat, s, d = (torch.from_numpy(np.array(a)).to("cuda")
                  for a in (gb.node_feat.reshape(b * nb, -1), src, dst))
    with torch.no_grad():
        outs = [model.apply(params, cfg, feat, torch.from_numpy(p).to("cuda"), s, d)
                for p in (pos, moved)]
    return float((outs[0] - outs[1]).abs().max())


def gnn_products(gen):
    """``ogb_products`` at its full size (uniform random edges, made on the
    card): ``gcn-cora`` ``GNN_PRODUCTS_STEPS`` full-batch steps; then the
    edge-partitioned GCN (``psum_axes=("data",)``, the edge lists split
    over ``Mesh(["cuda"] * 4, ("data",))``) against the single-card forward
    in f32 and in bf16 with ``smart_order``, each within ``GNN_MESH_TOL``
    (rtol and atol); the bf16 difference relative to the output's max is
    recorded beside it."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_common import GNN_SHAPES, _full_step
    from repro_torch.distributed import Mesh, NamedSharding, P, device_put

    shape = GNN_SHAPES["ogb_products"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (src, dst, feat, labels), build_s = timed(lambda: graph_on_card(shape, gen))
    base = torch.cuda.memory_allocated()  # the graph: edges, features, labels
    mod = get_arch("gcn-cora")
    step, opt_init, cfg = _full_step(mod.MODEL, mod.make_cfg, "ogb_products")
    params = mod.MODEL.init_params(cfg, GNN_SEED, device="cuda")
    inputs = (feat, None, src, dst, labels)
    params, opt, losses, walls = train_steps(step, params, opt_init(params), GNN_PRODUCTS_STEPS,
                                             lambda i: inputs)
    rec = {"arch": "gcn-cora", "shape": "ogb_products", "nodes": shape["n_nodes"],
           "edges": shape["n_edges"], "endpoints": "uniform", "build_s": build_s,
           "steps": GNN_PRODUCTS_STEPS, "losses": losses, "step_walls_s": walls,
           "step_ms_median": 1e3 * float(np.median(walls[1:])),
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "peak_above_graph_bytes": torch.cuda.max_memory_allocated() - base,
           "graph_bytes": base, "profile": profiled(lambda: step(params, opt, *inputs))}
    emit({"phase": "gnn_products", **rec})
    check(all(finite(v) for v in losses) and all_finite(params),
          f"gnn_products: non-finite loss or parameters {rec}")
    walked = walked_step(step, (params, opt, *inputs), cfg.dtype, _gnn_model_flops(mod, shape),
                         float(np.median(walls[1:])))

    mesh = Mesh(["cuda"] * GNN_MESH_BLOCKS, ("data",))
    check(shape["n_edges"] % GNN_MESH_BLOCKS == 0, "ogb_products: edges do not split")
    sharding = NamedSharding(mesh, P("data"))
    s_src, s_dst = device_put(src, sharding), device_put(dst, sharding)
    parts = []
    for dtype, smart in ((torch.float32, False), (torch.bfloat16, True)):
        one = dataclasses.replace(cfg, dtype=dtype, smart_order=smart)
        runs = {"single": lambda: mod.MODEL.apply(params, one, feat, None, src, dst),
                "partitioned": lambda: mod.MODEL.apply(
                    params, dataclasses.replace(one, psum_axes=("data",)), feat, None, s_src,
                    s_dst, mesh=mesh)}
        with torch.no_grad():  # a warm call each, then one timed
            (single, parted), _ = zip(*(timed(f) for f in runs.values()))
            secs = {k: timed(f)[1] for k, f in runs.items()}
        tol = GNN_MESH_TOL[dtype]
        a, w = parted.double(), single.double()
        part = {"dtype": str(dtype), "smart_order": smart, "blocks": GNN_MESH_BLOCKS,
                "out_dtype": str(parted.dtype), "max_abs": float((a - w).abs().max()),
                "max_rel_to_max": rel_to_max(parted, single), "single_s": secs["single"],
                "partitioned_s": secs["partitioned"], "tol": tol,
                "within_tol": bool(((a - w).abs() <= tol + tol * w.abs()).all())}
        parts.append(part)
        emit({"phase": "gnn_partitioned", **part})
        check(part["within_tol"] and parted.dtype == dtype,
              f"gnn_partitioned: the edge-partitioned GCN differs from the single card {part}")
    del src, dst, feat, labels, s_src, s_dst, params, single, parted
    torch.cuda.empty_cache()
    return {"train": rec, "partitioned": parts, "dryrun": walked}


def phase_gnn():
    """Phase 17: the four GNN archs on their four shapes on the card, the
    edge-partitioned GCN, and the train CLI on ``gcn-cora``.  Returns every
    kernel's launches over the phase (none is on its path)."""
    t0 = time.perf_counter()
    reset_kernel_launches()
    gen = torch.Generator(device="cuda").manual_seed(GNN_SEED)
    arrays, hold = gnn_hold_against_cpu()
    cora = gcn_cora_train(arrays)
    minibatch = gnn_minibatch(gen)
    molecule = gnn_molecule()
    products = gnn_products(gen)
    lines, cli_s = run_cli("train", "--arch", "gcn-cora", "--steps", str(GNN_CORA_STEPS))
    first, last = float(lines[0].split()[3]), final_loss(lines)
    launches = kernel_launches()
    emit({"phase": "gnn", "train_cli": {"first_loss": first, "final_loss": last,
                                        "seconds": cli_s, "last_lines": lines[-2:]},
          "launches": launches, "phase_s": time.perf_counter() - t0})
    check(last < first, f"train CLI gcn-cora: the loss did not fall {lines}")
    check(not any(launches.values()), f"gnn: a kernel launched on the GNN path {launches}")
    return launches, {"hold": hold, "cora": cora, "minibatch": minibatch, "molecule": molecule,
                      "products": products, "dryrun": products["dryrun"]}


def din_serve(params, cfg, batch, reps) -> dict:
    """``din.apply`` on ``batch`` under no_grad: the median of ``reps``
    timed calls after one warm call, and the peak above the weights."""
    from repro_torch.models.recsys import din

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = din.apply(params, cfg, batch)
        walls = [timed(lambda: din.apply(params, cfg, batch))[1] for _ in range(reps)]
    rows = int(batch["target_item"].shape[0])
    return {"rows": rows, "reps": reps, "ms_median": 1e3 * float(np.median(walls)),
            "rows_per_s": rows / float(np.median(walls)),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "peak_above_weights_bytes": torch.cuda.max_memory_allocated() - base,
            "finite": bool(torch.isfinite(out).all())}


def phase_recsys():
    """Phase 18: DIN ``full_config()`` on the card: held against the CPU at
    ``DIN_HOLD_ROWS`` rows, ``train_batch`` trained ``DIN_TRAIN_STEPS``
    steps, ``serve_p99`` and ``serve_bulk`` served, ``retrieval_cand`` scored
    at ``DIN_RETRIEVAL`` candidates, and the train CLI on ``din``.  Returns
    every kernel's launches over the phase (none is on its path)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import value_and_grad
    from repro_torch.data import din_batch
    from repro_torch.models.recsys import din
    from repro_torch.optim.optimizers import tree_leaves

    t0 = time.perf_counter()
    reset_kernel_launches()
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = get_arch("din")
    cfg = mod.full_config()
    shapes = mod.DIN_SHAPES
    train_rows = shapes["train_batch"]["batch"]
    arrays = din_batch(DIN_SEED, 0, train_rows, cfg.seq_len, cfg.n_items, cfg.n_cates)
    tree = din.params_to_numpy(din.init_params(cfg, DIN_SEED, device="cpu"))

    # card vs CPU on the first DIN_HOLD_ROWS rows
    runs = {}
    for dev in ("cuda", "cpu"):
        params = din.params_from_numpy(tree, cfg, device=dev)
        batch = {k: torch.from_numpy(v[:DIN_HOLD_ROWS]).to(dev) for k, v in arrays.items()}
        with torch.no_grad():
            logits = din.apply(params, cfg, batch)
        loss, grads = value_and_grad(lambda p: din.loss_fn(p, cfg, batch), params)
        runs[dev] = (logits, float(loss), tree_leaves(grads))
    (lg, sg, gg), (lc, sc, gc) = runs["cuda"], runs["cpu"]
    hold = {"rows": DIN_HOLD_ROWS, "logits_rel": rel_to_max(lg.cpu(), lc), "loss_cuda": sg,
            "loss_cpu": sc, "loss_rel": abs(sg - sc) / abs(sc),
            "grad_rel": max(rel_to_max(a.cpu(), b) for a, b in zip(gg, gc)), "grad_leaves": len(gc),
            "tol": {"logits": DIN_HOLD_FWD, "loss": DIN_HOLD_LOSS, "grad": DIN_HOLD_GRAD}}
    emit({"phase": "din_hold", **hold})
    check(hold["logits_rel"] <= DIN_HOLD_FWD and hold["loss_rel"] <= DIN_HOLD_LOSS
          and hold["grad_rel"] <= DIN_HOLD_GRAD, f"din_hold: card vs CPU {hold}")
    del runs, lg, lc, gg, gc

    # train_batch at its full size
    params = din.params_from_numpy(tree, cfg, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in arrays.items()}
    step, opt_init = mod._train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, walls = train_steps(step, params, opt_init(params), DIN_TRAIN_STEPS,
                                             lambda i: (batch,))
    step_s = float(np.median(walls[1:]))
    train = {"shape": "train_batch", "rows": train_rows, "steps": DIN_TRAIN_STEPS,
             "losses": losses, "step_walls_s": walls, "step_ms_median": 1e3 * step_s,
             "samples_per_s": train_rows / step_s,
             "peak_device_bytes": torch.cuda.max_memory_allocated(),
             "profile": profiled(lambda: step(params, opt, batch))}
    emit({"phase": "din_train", **train})
    check(all(finite(v) for v in losses) and all_finite(params),
          f"din_train: non-finite loss or parameters {train}")
    walked = walked_step(step, (params, opt, batch), cfg.dtype,
                         mod._flops(cfg, train_rows, cfg.seq_len, True), step_s)

    # serving: serve_p99 (the first rows of the batch) and serve_bulk (the
    # train batch repeated), halved while the peak passes DIN_BULK_PEAK
    params = din.params_from_numpy(tree, cfg, device="cuda")
    serve_batch = {k: v for k, v in batch.items() if k != "label"}
    p99 = din_serve(params, cfg, {k: v[:shapes["serve_p99"]["batch"]]
                                  for k, v in serve_batch.items()}, DIN_P99_REPS)
    emit({"phase": "din_serve", "shape": "serve_p99", **p99})
    bulk_rows, cuts = shapes["serve_bulk"]["batch"], []
    while True:
        reps = -(-bulk_rows // train_rows)
        bulk_batch = {k: v.repeat(reps, *([1] * (v.dim() - 1)))[:bulk_rows]
                      for k, v in serve_batch.items()}
        bulk = din_serve(params, cfg, bulk_batch, DIN_BULK_REPS)
        del bulk_batch
        if bulk["peak_device_bytes"] <= DIN_BULK_PEAK or bulk_rows <= train_rows:
            break
        cuts.append({"rows": bulk_rows, "peak_device_bytes": bulk["peak_device_bytes"]})
        bulk_rows //= 2
    bulk["cuts"] = cuts
    emit({"phase": "din_serve", "shape": "serve_bulk", **bulk})
    check(p99["finite"] and bulk["finite"], f"din_serve: non-finite logits {p99} {bulk}")

    # retrieval_cand, cut to DIN_RETRIEVAL candidates
    gen = torch.Generator(device="cuda").manual_seed(DIN_SEED)
    cand = torch.randint(0, cfg.n_items, (DIN_RETRIEVAL,), generator=gen, device="cuda",
                         dtype=torch.int32)
    query = {"hist_items": batch["hist_items"][:1], "hist_cates": batch["hist_cates"][:1],
             "cand_items": cand, "cand_cates": cand % cfg.n_cates}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        scores = din.score_candidates(params, cfg, query)
        walls = [timed(lambda: din.score_candidates(params, cfg, query))[1]
                 for _ in range(DIN_RETRIEVAL_REPS)]
        k = DIN_RETRIEVAL_CHECK
        want = din.apply(params, cfg, {"hist_items": query["hist_items"].repeat(k, 1),
                                       "hist_cates": query["hist_cates"].repeat(k, 1),
                                       "target_item": cand[:k],
                                       "target_cate": query["cand_cates"][:k]})
    err = float((scores[:k] - want).abs().max())
    retrieval = {"shape": "retrieval_cand", "candidates": DIN_RETRIEVAL,
                 "reference_candidates": shapes["retrieval_cand"]["n_candidates"],
                 "ms_median": 1e3 * float(np.median(walls)),
                 "candidates_per_s": DIN_RETRIEVAL / float(np.median(walls)),
                 "peak_device_bytes": torch.cuda.max_memory_allocated(),
                 "checked": k, "max_abs_vs_apply": err, "tol": DIN_RETRIEVAL_TOL}
    emit({"phase": "din_retrieval", **retrieval})
    check(bool(torch.isfinite(scores).all()) and err <= DIN_RETRIEVAL_TOL,
          f"din_retrieval: {retrieval}")
    del params, batch, serve_batch, scores, query
    torch.cuda.empty_cache()

    lines, cli_s = run_cli("train", "--arch", "din", "--steps", str(DIN_CLI_STEPS))
    launches = kernel_launches()
    emit({"phase": "recsys", "train_cli": {"final_loss": final_loss(lines), "seconds": cli_s,
                                           "last_lines": lines[-2:]},
          "launches": launches, "phase_s": time.perf_counter() - t0})
    check(finite(final_loss(lines)), f"train CLI din: {lines}")
    check(not any(launches.values()), f"recsys: a kernel launched on the DIN path {launches}")
    return launches, {"hold": hold, "train": train, "serve_p99": p99, "serve_bulk": bulk,
                      "retrieval": retrieval, "dryrun": walked}


# ---------------------------------------------------------------------------
# phase 19: the dry-run tools on the card
# ---------------------------------------------------------------------------


def to_meta(x, cfg=None):
    """``x`` with every tensor as a ``meta`` tensor of its shape and dtype
    (a transformer's parameters stay a ``TransformerParams`` of ``cfg``)."""
    from repro_torch.models import transformer as tfm

    if isinstance(x, tfm.TransformerParams):
        return tfm.params_from_tree(to_meta(tfm.param_tree(x)), cfg)
    if isinstance(x, torch.Tensor):
        return x.detach().to("meta").requires_grad_(x.requires_grad)
    if isinstance(x, dict):
        return {k: to_meta(v, cfg) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_meta(v, cfg) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_meta(v, cfg) for v in x)
    return x


def walked_step(step, args, dtype, model_flops, measured_s, cfg=None) -> dict:
    """One more ``step(*args)`` on the card under the cost walker, and
    ``meta`` copies of the arguments (taken first: the step updates them
    in place) for phase 19 to trace the same step on."""
    from repro_torch.launch.flops import CostWalker

    meta_args = to_meta(args, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with CostWalker() as walker:
        step(*args)
        torch.cuda.synchronize()
    return {"step": step, "meta_args": meta_args, "dtype": dtype, "model_flops": model_flops,
            "measured_s": measured_s, "walker": walker.report(),
            "walked_s": time.perf_counter() - t0}


def _gnn_model_flops(mod, shape) -> float:
    """The reference's FLOP model of a full-graph GCN step on ``shape``."""
    from repro_torch.configs.gnn_common import _estimate_flops

    return _estimate_flops(2.0 * 16, 2.0 * shape["d_feat"] * 16, shape["n_nodes"],
                           shape["n_edges"])


def dot_flops(cost, region=None) -> float:
    """A cost's matmul FLOPs, or those inside ``region``."""
    if region is None:
        return cost["by_prim"].get("dot_general", 0.0)
    return cost["by_region"].get(region, {}).get("dot_flops", 0.0)


def dryrun_cli(shape_args, out_dir):
    """Start ``python -m repro_torch.launch.dryrun`` on one production cell."""
    arch, shape = shape_args
    out = os.path.join(out_dir, f"{arch}_{shape}.jsonl")
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                             "--shape", shape, "--json", out], env=env, cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def phase_dryrun(smi_line, steps):
    """Phase 19: the three steps walked on the card in phases 13, 17 and 18
    traced again on ``meta`` copies of their arguments through
    ``DryRunSpec.lower()``; matmul FLOPs card = meta (qwen2: outside
    attention; the kernel's launches × its formula against the plain
    version's dots on meta); each step's roofline on one card against its
    measured median; two production cells through the dry-run CLI."""
    from repro_torch.configs.base import DryRunSpec
    from repro_torch.launch.flops import attention_cost
    from repro_torch.launch.roofline import roofline_terms

    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    clis = [dryrun_cli(cell, out_dir) for cell in DRYRUN_CELLS]
    recs = {}
    for name, d in steps.items():
        spec = DryRunSpec(step_fn=d["step"], args=d["meta_args"], in_shardings=None,
                          compute_dtype=d["dtype"], model_flops=d["model_flops"])
        t1 = time.perf_counter()
        lowered = spec.lower()
        trace_s = time.perf_counter() - t1
        card, meta = d["walker"], lowered.cost
        roof = roofline_terms(lowered, 1, d["model_flops"], walker_cost=card)
        rec = {"step": name, "nvidia_smi": smi_line, "card_dot_flops": dot_flops(card),
               "meta_dot_flops": dot_flops(meta), "card_flops": card["flops"],
               "meta_flops": meta["flops"], "card_bytes": card["bytes"],
               "meta_bytes": meta["bytes"], "meta_trace_s": trace_s,
               "walked_step_s": d["walked_s"], "kernels": card["kernels"],
               "roofline": {k: roof.to_dict()[k] for k in (
                   "compute_s", "memory_s", "bottleneck", "step_time_s", "peak_flops",
                   "compute_dtype", "roofline_fraction")},
               "measured_step_s": d["measured_s"],
               "measured_roofline_fraction": roof.step_time_s / d["measured_s"],
               "meta_temp_bytes": lowered.temp_bytes}
        card_out = rec["card_dot_flops"] - dot_flops(card, "attention")
        meta_out = rec["meta_dot_flops"] - dot_flops(meta, "attention")
        rec["card_dot_flops_outside_attention"] = card_out
        rec["meta_dot_flops_outside_attention"] = meta_out
        fa = card["kernels"].get("flash_attention")
        if fa is not None:
            per_launch, _ = attention_cost(TRAIN_MICRO, 12, 2, TRAIN_SEQ, TRAIN_SEQ, 128, True, 2)
            rec["attention"] = {
                "kernel_launches": fa["launches"], "kernel_flops_charged": fa["flops"],
                "kernel_flops_per_launch": per_launch,
                "card_plain_backward_dot_flops": dot_flops(card, "attention"),
                "meta_plain_dot_flops": dot_flops(meta, "attention"),
                "meta_over_charged": dot_flops(meta, "attention") / fa["flops"]}
        emit({"phase": "dryrun_step", **rec})
        recs[name] = rec
        check(card_out == meta_out and card_out > 0,
              f"dryrun: {name}: matmul FLOPs outside attention card {card_out} != meta "
              f"{meta_out}")
        if fa is None:
            check(rec["card_dot_flops"] == rec["meta_dot_flops"],
                  f"dryrun: {name}: matmul FLOPs card != meta {rec}")
        else:
            expect = TRAIN_LAYERS_LAUNCHES
            check(fa["launches"] == expect and fa["flops"] == fa["launches"] * per_launch,
                  f"dryrun: {name}: attention charged {fa}, expected {expect} launches of "
                  f"{per_launch}")
        check(all(np.isfinite(v) and v > 0 for v in (roof.compute_s, roof.memory_s,
                                                      roof.step_time_s)),
              f"dryrun: {name}: roofline {rec['roofline']}")
    cells = []
    for (proc, out), (arch, shape) in zip(clis, DRYRUN_CELLS):
        text, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"dryrun CLI {arch} {shape} exited {proc.returncode}: "
                                    f"{text[-2000:]}")
        with open(out) as f:
            cell = json.loads(f.readline())
        terms = [cell[k] for k in ("compute_s", "memory_s", "collective_s", "step_time_s",
                                   "roofline_fraction")]
        keep = {k: cell[k] for k in ("arch", "shape", "mesh", "chips", "compute_s", "memory_s",
                                     "collective_s", "bottleneck", "roofline_fraction",
                                     "trace_s", "warnings")}
        emit({"phase": "dryrun_cli", "nvidia_smi": smi_line, **keep})
        cells.append(keep)
        check(cell["chips"] == 256 and all(np.isfinite(terms)),
              f"dryrun CLI {arch} {shape}: {keep}")
    emit({"phase": "dryrun", "nvidia_smi": smi_line, "phase_s": time.perf_counter() - t0})
    return recs, cells


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main_cards() -> int:
    """``python3 chip_smoke.py --cards``: phase 8i's scheme over every
    visible card (a multi-card machine), against the pallas vectors; then
    the full-depth sharded train step over four cards."""
    from repro_torch.core import TriangleCounter, prepare_oriented
    from repro_torch.graphs import kronecker_rmat

    name, _ = phase_device()
    phase_build()
    edges = kronecker_rmat(21, edge_factor=16, seed=1503)
    csr = prepare_oriented(edges, device="cuda")
    tc = TriangleCounter(method="pallas", max_wedge_chunk=BUDGETS_21[0])
    vectors = tc.per_node(csr), tc.edge_support(csr)
    phase_distributed_cards(edges, csr, *vectors)
    del edges, csr, vectors
    torch.cuda.empty_cache()
    phase_lm_sharded_cards()
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
    phase_train_attention(rate)
    train_launches, lm_train = phase_lm_train()
    phase_train_cli()
    moe_layer_hold()
    moe_train_launches, moe_serve_launches, _ = phase_moe_full()
    kv_int8_launches, _ = phase_kv_int8()
    sharded_launches, _ = phase_lm_sharded()
    gnn_launches, gnn = phase_gnn()
    recsys_launches, recsys = phase_recsys()
    phase_dryrun(smi_line, {"qwen2-1.5b train": lm_train["dryrun"],
                            "gcn-cora ogb_products": gnn["dryrun"],
                            "din train_batch": recsys["dryrun"]})

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
        # phase 13's 6 qwen2-1.5b train steps (112 a step); phase 14's granite
        # MoE: 2 train steps and one serve; phase 15's two timed serves (bf16
        # and int8 cache); phase 16's sharded steps (2 replicas)
        "train_launches": train_launches, "moe_train_launches": moe_train_launches,
        "moe_serve_launches": moe_serve_launches, "kv_int8_launches": kv_int8_launches,
        "sharded_train_launches": sharded_launches,
    })
    check(fa_launches > 0, "flash_attention was not launched on the serving path")
    check(train_launches > 0, "flash_attention was not launched on the training path")
    check(kv_int8_launches > 0, "flash_attention was not launched on the int8-cache serve")
    check(sharded_launches > 0, "flash_attention was not launched by the sharded step")
    for row in kernels:  # phases 17-18: no kernel of the port is on their path
        row["gnn_launches"] = gnn_launches[row["name"]]
        row["recsys_launches"] = recsys_launches[row["name"]]
        check(row["gnn_launches"] == 0 and row["recsys_launches"] == 0,
              f"{row['name']} launched on the GNN or recsys path")
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
