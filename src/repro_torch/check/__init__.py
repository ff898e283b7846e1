"""repro_torch.check — trilint's static passes and the runtime audit layer.

Static analysis (stdlib-only, runs without torch/numpy):

    python -m repro_torch.check [--json] [--select overflow,collectives,...]

Passes: ``overflow`` (O1-O3), ``recompile`` (R1, empty in an eager port),
``collectives`` (C1-C3), ``backend_protocol`` (B1-B4), ``stats_lifecycle``
(S1), ``codec`` (Z1), ``obs_discipline`` (D1) — each documented in its
module and in the README "Invariants" section.  Suppress inline with
``# trilint: ok[rule]`` or via the port's ``check/trilint.allow`` file.

Runtime audit (needs numpy/torch): ``repro_torch.check.runtime`` provides
the ``REPRO_CHECK=1`` partial-headroom sanitizer hooked into
``engine.run_workload`` and the ``CompileAuditor``, which counts the
launch signatures each kernel entry point records.  Its names are
exported here too, imported at first use so the lint CLI needs no torch.
"""

from .base import (  # noqa: F401
    Finding,
    ModuleInfo,
    PASSES,
    load_passes,
    run_checks,
)

_RUNTIME_NAMES = (
    "PARTIAL_HEADROOM",
    "REPRO_CHECK_ENV",
    "RuntimeCheckError",
    "enabled",
    "check_partial",
    "check_partials",
    "CompileAuditor",
)

__all__ = ["Finding", "ModuleInfo", "PASSES", "load_passes", "run_checks", *_RUNTIME_NAMES]


def __getattr__(name):
    if name in _RUNTIME_NAMES:
        from . import runtime

        return getattr(runtime, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
