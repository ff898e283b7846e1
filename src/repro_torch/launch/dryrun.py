"""Dry run of every (arch × shape × mesh) cell on a model of H100s.

The port's counterpart of ``repro.launch.dryrun``.  The reference lowers
and compiles each cell for a fake 512-device topology and reads the
compiler's analyses.  The port compiles nothing: it builds the cell on
:func:`~repro_torch.launch.mesh.make_production_mesh` (``meta`` devices),
runs the step on ``meta`` tensors under the cost walker
(:meth:`~repro_torch.configs.base.DryRunSpec.lower`) and turns the count
into roofline terms on NVIDIA's published H100 figures
(:mod:`repro_torch.launch.roofline`).  Nothing is allocated or computed,
so it runs on any host, no card needed.  The figures are a model, not a
measurement.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json out.jsonl

The record has the reference's keys, with two differences: ``compile_s``
is ``trace_s`` (the walk's seconds), and ``memory_analysis`` is per device
— ``argument_bytes`` and ``output_bytes`` from the cell's shardings,
``temp_bytes`` the peak bytes of live intermediates in the trace (one
stripe's or replica's where the step runs over the mesh, the whole step's
where it is traced on one device), ``generated_code_bytes`` null.  It adds
``warnings``: where the port has no sharded path for the cell, and where
one replica was traced for all.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def run_cell(arch: str, shape: str, multi_pod: bool, variant: str = "baseline") -> dict:
    """Trace one (arch × shape × mesh) cell; return the record."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.roofline import roofline_terms

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    spec = get_arch(arch).build_dryrun(shape, mesh, variant=variant)
    t0 = time.time()
    lowered = spec.lower()
    trace_s = time.time() - t0
    mem = {
        "argument_bytes": lowered.argument_bytes,
        "output_bytes": lowered.output_bytes,
        "temp_bytes": lowered.temp_bytes,
        "generated_code_bytes": None,
    }
    report = roofline_terms(lowered, chips, spec.model_flops)
    return {
        "arch": arch,
        "shape": shape,
        "variant": variant,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "multi_pod": multi_pod,
        "chips": chips,
        "description": spec.description,
        "trace_s": round(trace_s, 1),
        "memory_analysis": mem,
        "n_params": spec.n_params,
        "tokens_per_step": spec.tokens_per_step,
        **report.to_dict(),
        "warnings": lowered.warnings,
    }


def _fmt(rec: dict) -> str:
    return (
        f"{rec['arch']:22s} {rec['shape']:14s} mesh={rec['mesh']:8s} "
        f"compute={rec['compute_s']:.3e}s memory={rec['memory_s']:.3e}s "
        f"collective={rec['collective_s']:.3e}s bottleneck={rec['bottleneck']:10s} "
        f"roofline_frac={rec['roofline_fraction']:.3f} trace={rec['trace_s']}s"
    )


def main() -> None:
    ap = argparse.ArgumentParser(description="dry run of the production cells (H100 model)")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt", "opt2", "nodeshard"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every cell (subprocess-isolated)")
    ap.add_argument("--both-meshes", action="store_true", help="with --all: single+multi pod")
    ap.add_argument("--json", help="append JSONL records here")
    args = ap.parse_args()

    if args.all:
        from repro_torch.configs import ALL_CELLS

        meshes = [False, True] if args.both_meshes else [False]
        failures = []
        for arch, shape in ALL_CELLS:
            for mp in meshes:
                cmd = [
                    sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape,
                ]
                if mp:
                    cmd.append("--multi-pod")
                if args.json:
                    cmd += ["--json", args.json]
                r = subprocess.run(cmd)
                if r.returncode != 0:
                    failures.append((arch, shape, mp))
        if failures:
            print("FAILED CELLS:", failures)
            sys.exit(1)
        print("ALL CELLS PASSED")
        return

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    rec = run_cell(args.arch, args.shape, args.multi_pod, variant=args.variant)
    print(_fmt(rec))
    print("memory_analysis:", rec["memory_analysis"])
    for w in rec["warnings"]:
        print("warning:", w)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
