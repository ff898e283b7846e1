"""repro_torch.check — the runtime audit layer of the port.

``repro_torch.check.runtime`` provides the ``REPRO_CHECK=1``
partial-headroom sanitizer hooked into ``engine.run_workload``.  The
reference's static passes (``python -m repro.check``, trilint) and its
``CompileAuditor`` are not ported yet (ROADMAP A5b): this package exports
only the runtime names until then.
"""

from .runtime import (  # noqa: F401
    PARTIAL_HEADROOM,
    REPRO_CHECK_ENV,
    RuntimeCheckError,
    check_partial,
    check_partials,
    enabled,
)

__all__ = [
    "PARTIAL_HEADROOM",
    "REPRO_CHECK_ENV",
    "RuntimeCheckError",
    "enabled",
    "check_partial",
    "check_partials",
]
