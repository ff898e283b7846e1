"""The paper's own workload: distributed triangle counting.

Shapes mirror the paper's Table I graphs (§IV).  A dry-run cell traces
the striped counting step of :mod:`repro_torch.core.distributed` at
production graph sizes on a mesh of ``meta`` devices: the CSR arrays
(``row_offsets``, ``col``, ``out_degree``) replicate (the paper replicates
them to every GPU), the striped directed edge list shards over every mesh
axis, and per-stripe wedge buffers are sized from the paper-reported
wedge workload.  Every stripe is traced; the partials' merge on the mesh's
lead records its collective.

``wedge_factor`` ≈ Σ deg⁺(u)² / m_dir, estimated per graph family from
local measurements at smaller scales (Kronecker wedge load grows with
scale; BA/WS stay near-constant — the same skew effect §III-C discusses).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.distributed import (
    make_distributed_count_fn,
    make_distributed_panel_count_fn,
)

from .base import DryRunSpec, named, rep, sds

ARCH_ID = "triangles"
FAMILY = "graph-analytics"

# n_nodes, undirected edge count (paper Table I), wedge factor, description
TRIANGLE_SHAPES = {
    "kron16": dict(n=1 << 16, m=5_000_000, wedge_factor=40.0),
    "kron18": dict(n=1 << 18, m=21_000_000, wedge_factor=48.0),
    "kron20": dict(n=1 << 20, m=89_000_000, wedge_factor=56.0),
    "kron21": dict(n=1 << 21, m=182_000_000, wedge_factor=60.0),
    "livejournal": dict(n=4_000_000, m=69_000_000, wedge_factor=18.0),
    "orkut": dict(n=3_100_000, m=234_000_000, wedge_factor=24.0),
}
SHAPES = tuple(TRIANGLE_SHAPES)


def full_config() -> dict:
    return dict(TRIANGLE_SHAPES)


def smoke_config() -> dict:
    return dict(n=1 << 10, m=20_000, wedge_factor=20.0)


# The reference's measurements on kron12/kron14, extrapolated up the
# family: the fraction of directed edges whose wider endpoint list fits the
# given panel width.  The >256 tail stays on the binary-search schedule —
# the paper's own §VI suggestion (a different algorithm for the
# largest-degree vertices): panels for the bulk, search for the tail.
_PANEL_MIX = {16: 0.04, 64: 0.26, 256: 0.55}
_TAIL_FRACTION = 0.15


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    """The reference's variants:

    * ``"opt"``  — enumerate wedge candidates from the *shorter* endpoint
      list (Σ min(d⁺u, d⁺v) probes),
    * ``"opt2"`` — hybrid schedule: ≤256-wide edges through the panel
      schedule (each endpoint's neighbor panel gathered once, an
      equality-tile reduction); the heavy tail keeps the shorter-side
      search.  The port's panel function returns int64 per-stripe totals,
      so the sum of the two is int64.
    """
    spec = TRIANGLE_SHAPES[shape]
    n, m = spec["n"], spec["m"]
    m_dir = m  # the paper's edge array holds 2m rows; orientation keeps m
    n_shards = mesh.size
    all_axes = tuple(mesh.axis_names)
    max_deg = int(math.isqrt(2 * m)) + 1  # forward bound: deg⁺ ≤ √(2m)
    steps = max(1, math.ceil(math.log2(max_deg + 1)))
    csr_args = (
        sds((n + 1,), torch.int32),            # row_offsets (replicated)
        sds((m_dir,), torch.int32),            # col (replicated)
        sds((n,), torch.int32),                # out_degree (replicated)
    )
    csr_sh = (rep(mesh), rep(mesh), rep(mesh))

    if variant == "opt2":
        per_width = {
            w: max(1, -(-int(frac * m_dir) // n_shards))
            for w, frac in _PANEL_MIX.items()
        }
        panel_fn, widths = make_distributed_panel_count_fn(mesh, per_width)
        tail_e_per = max(1, -(-int(_TAIL_FRACTION * m_dir) // n_shards))
        wf_tail = spec["wedge_factor"] * 0.70 * 0.6  # tail carries the fat wedges
        tail_budget = int(wf_tail * tail_e_per / _TAIL_FRACTION * 1.25)
        search_fn = make_distributed_count_fn(mesh, tail_budget, steps, shorter_side=True)

        def step_fn(*args):
            k = len(widths)
            panel_args = args[: 2 * k]
            tail_src, tail_dst = args[2 * k: 2 * k + 2]
            csr = args[2 * k + 2:]
            # int64 per-stripe totals plus the tail's partials summed per stripe
            return panel_fn(*panel_args, *csr) + search_fn(tail_src, tail_dst, *csr).sum(dim=-1)

        edge_args = tuple(sds((n_shards, per_width[w]), torch.int32) for w in widths)
        args = (
            *edge_args, *edge_args,  # src panels then dst panels
            sds((n_shards, tail_e_per), torch.int32),
            sds((n_shards, tail_e_per), torch.int32),
            *csr_args,
        )
        in_sh = (*([named(mesh, all_axes)] * (2 * len(widths) + 2)), *csr_sh)
        total_wedges = spec["wedge_factor"] * 0.70 * m_dir
        return DryRunSpec(
            step_fn=step_fn,
            args=args,
            in_shardings=in_sh,
            description=f"{ARCH_ID} {shape} hybrid panel+search (opt2)",
            model_flops=total_wedges * steps * 8.0,
            tokens_per_step=m_dir,
            sharded=True,
        )

    e_per = -(-m_dir // n_shards)
    shorter = variant == "opt"
    wf = spec["wedge_factor"] * (0.70 if shorter else 1.0)
    wedge_budget = int(wf * e_per * 1.25)
    count_fn = make_distributed_count_fn(mesh, wedge_budget, steps, shorter_side=shorter)
    args = (
        sds((n_shards, e_per), torch.int32),   # striped edge src
        sds((n_shards, e_per), torch.int32),   # striped edge dst
        *csr_args,
    )
    in_sh = (named(mesh, all_axes), named(mesh, all_axes), *csr_sh)
    # useful work: one binary-search probe per wedge ≈ steps · 8 flop-equiv
    total_wedges = wf * m_dir
    return DryRunSpec(
        step_fn=count_fn,
        args=args,
        in_shardings=in_sh,
        description=f"{ARCH_ID} {shape} n={n} m={m} wedges≈{total_wedges:.2e}",
        model_flops=total_wedges * steps * 8.0,
        tokens_per_step=m_dir,
        sharded=True,
    )
