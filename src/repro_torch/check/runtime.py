"""Runtime audit layer: the ``REPRO_CHECK=1`` sanitizer.

The counterpart of ``repro.check.runtime``.  With ``REPRO_CHECK=1`` in the
environment, ``run_workload`` routes every chunk's partial through
:func:`check_partial` before the fold, asserting it is a narrow integer
(int32-or-smaller, the device accumulator contract) whose values retain
headroom below 2^30.  A partial at 2^30 means one more doubling overflows
int32 *on the device*, before any fold can widen it.

A partial on the card is read as its min and max, computed there and
brought back together: one synchronisation per chunk, which is the
sanitizer's whole cost.

The reference's ``CompileAuditor`` counts jit traces; the eager port has
none, and its stand-in (a kernel-launch counter) is not ported yet
(ROADMAP A5b), so :class:`CompileAuditor` raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = [
    "REPRO_CHECK_ENV",
    "PARTIAL_HEADROOM",
    "RuntimeCheckError",
    "enabled",
    "check_partial",
    "check_partials",
    "CompileAuditor",
]

REPRO_CHECK_ENV = "REPRO_CHECK"

# Values at/above this lack doubling headroom inside int32.
PARTIAL_HEADROOM = 1 << 30


class RuntimeCheckError(AssertionError):
    """An engine correctness invariant failed at runtime."""


def enabled() -> bool:
    """True when the ``REPRO_CHECK`` env var is set to a truthy value."""
    return os.environ.get(REPRO_CHECK_ENV, "").strip().lower() not in (
        "", "0", "false", "off", "no",
    )


def _kind_and_range(part):
    """``(dtype kind, itemsize, size, dtype name, min-max thunk)`` of a
    tensor or array."""
    if isinstance(part, torch.Tensor):
        dt = part.dtype
        kind = "b" if dt == torch.bool else ("f" if dt.is_floating_point or dt.is_complex
                                            else "i")
        itemsize = part.element_size()

        def lo_hi():
            both = torch.stack([part.min(), part.max()]).to(torch.int64).cpu()
            return int(both[0]), int(both[1])

        return kind, itemsize, part.numel(), str(dt).replace("torch.", ""), lo_hi
    a = np.asarray(part)
    return a.dtype.kind, a.dtype.itemsize, a.size, str(a.dtype), lambda: (int(a.min()),
                                                                          int(a.max()))


def check_partial(part, *, kind: str, context: str = "") -> None:
    """Assert one partial honors the int32-accumulator contract.

    ``part`` is whatever a backend's ``count_chunk`` / ``per_node_chunk``
    / ``support_chunk`` returned (a tensor on any device, or an array),
    *before* the fold widens it.
    """
    dkind, itemsize, size, name, lo_hi = _kind_and_range(part)
    where = f" ({context})" if context else ""
    if size == 0:
        return
    if dkind == "b":
        return
    if dkind not in "iu":
        raise RuntimeCheckError(
            f"REPRO_CHECK: {kind} partial{where} has non-integer dtype {name}; "
            "device kernels must emit integer counts"
        )
    if itemsize > 4:
        raise RuntimeCheckError(
            f"REPRO_CHECK: {kind} partial{where} arrived as {name}; the device "
            "accumulator contract is int32 — a 64-bit device dtype hides exactly "
            "the overflow the host fold exists to absorb"
        )
    lo, hi = lo_hi()
    if lo < 0:
        raise RuntimeCheckError(
            f"REPRO_CHECK: {kind} partial{where} contains negative count {lo}; "
            "likely an int32 wraparound on device"
        )
    if hi >= PARTIAL_HEADROOM:
        raise RuntimeCheckError(
            f"REPRO_CHECK: {kind} partial{where} peaks at {hi} >= 2^30; no "
            "doubling headroom left in the int32 device accumulator — shrink "
            "the chunk budget"
        )


def check_partials(partials, *, kind: str, context: str = "") -> None:
    for i, p in enumerate(partials):
        check_partial(p, kind=kind, context=context or f"chunk {i}")


class CompileAuditor:
    """Not ported yet: the reference counts jit traces, which the eager
    port does not make; a launch-count stand-in is ROADMAP A5b."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CompileAuditor is not yet ported to repro_torch (ROADMAP A5b: a "
            "launch-count stand-in for the jit trace counter); use the JAX "
            "package repro for it"
        )
