"""trilint pass: recompile hazards — registered, and empty in the port.

The reference's ``R1-unbucketed-shape`` flags a shape-derived argument
reaching a jit or ``pallas_call`` entry point in a function that never
rounds it to a pow2 bucket: there each distinct data size mints a new
trace and a new compile.  The port runs eagerly.  Its CUDA kernels are
compiled once per library (``kernels/_build.py``), never per shape, and
its torch ops make no traces, so the static pattern has nothing to break
and this pass returns no findings.  It stays registered so
``--select recompile`` works as it does in the reference.

The promise behind R1 — a truss peel or an incremental session hands
each kernel O(log m) distinct shapes — is still held in the port, at run
time: every kernel entry point records its launch signature (input
shapes and dtypes plus its static configuration), and
:class:`repro_torch.check.runtime.CompileAuditor` counts the signatures
first seen inside a block and bounds them by ``factor·log2(m) + slack``.
"""

from __future__ import annotations

from .base import Finding, ModuleInfo, register_pass


@register_pass("recompile")
def check_recompile(mod: ModuleInfo) -> "list[Finding]":
    del mod  # an eager port makes no traces: nothing to check statically
    return []
