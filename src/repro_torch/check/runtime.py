"""Runtime audit layer: the ``REPRO_CHECK=1`` sanitizer and CompileAuditor.

The counterpart of ``repro.check.runtime``.  Static passes
(``python -m repro_torch.check``) catch patterns; this module checks the
two invariants that only hold *dynamically*:

* **int32 partial headroom** — with ``REPRO_CHECK=1`` in the environment,
  ``run_workload`` routes every chunk's partial through
  :func:`check_partial` before the fold, asserting it is a narrow integer
  (int32-or-smaller, the device accumulator contract) whose values retain
  headroom below 2^30.  A partial at 2^30 means one more doubling
  overflows int32 *on the device*, before any fold can widen it.  A
  partial on the card is read as its min and max, computed there and
  brought back together: one synchronisation per chunk, which is the
  sanitizer's whole cost.
* **O(log m) distinct shapes** — the reference's :class:`CompileAuditor`
  counts the jit traces its kernel entry points mint.  The port runs
  eagerly and makes no traces, so each kernel entry point records its
  *launch signature* instead (the input shapes and dtypes plus the static
  arguments that pick its configuration: ``width``, ``tiles``,
  ``wedge_budget``, ``n_steps``, ...) into one process-wide registry,
  always, as jax's caches are always on: a set insert per launch.
  :class:`CompileAuditor` reads the registry's sizes around a block, so
  ``new_traces`` is the number of signatures first seen inside it — the
  delta the reference reads from jax's trace caches — and
  ``assert_log_bound(m)`` holds the pow2 bucketing promise behind truss
  peeling and incremental sessions.  ``new_builds`` counts the kernel
  libraries built or loaded inside the block
  (:class:`repro_torch.kernels._build.KernelLibrary`): the port's literal
  compiles.
"""

from __future__ import annotations

import functools
import math
import os
import threading

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
    "KERNEL_ENTRY_POINTS",
    "record_launch",
    "record_build",
    "records_launches",
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


# ---------------------------------------------------------------------------
# launch signatures


#: the kernel entry points that record launch signatures: the CUDA kernels
#: under their launch-counter names (their plain versions record the same
#: signature on CPU tensors), the torch-ops chunk kernels, the panel gather
#: and the §III-E stripe body
KERNEL_ENTRY_POINTS = (
    "chunk_count_kernel",
    "chunk_per_node_kernel",
    "chunk_support_kernel",
    "gather_panels_arrays",
    "_stripe_body",
    "intersect_count",
    "intersect_per_node",
    "intersect_support",
    "intersect_count_csr",
    "intersect_per_node_csr",
    "intersect_support_csr",
    "flash_attention",
)

_registry_lock = threading.Lock()
_signatures: dict[str, set] = {name: set() for name in KERNEL_ENTRY_POINTS}
_builds: dict[str, int] = {}


def _traced(x):
    """What a traced argument contributes: a tensor's or array's shape and
    dtype, a scalar's type (never its value), a sequence element-wise."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, np.ndarray):
        return (x.shape, x.dtype.str)
    if isinstance(x, (tuple, list)):
        return tuple(_traced(v) for v in x)
    if x is None:
        return None
    return type(x).__name__


def _static(x):
    """What a static argument contributes: its value (hashable)."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return _traced(x)
    if isinstance(x, (tuple, list)):
        return tuple(_static(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _static(v)) for k, v in x.items()))
    try:
        hash(x)
    except TypeError:
        return repr(x)
    return x


def _signature(args, static: dict) -> tuple:
    """The signature of one launch: ``args`` are traced (shape and dtype),
    ``static`` holds the arguments that pick the kernel's configuration."""
    return (tuple(_traced(a) for a in args),
            tuple(sorted((k, _static(v)) for k, v in static.items())))


def record_launch(name: str, args, **static) -> None:
    """Record one launch of kernel entry point ``name`` in the registry."""
    sig = _signature(args, static)
    with _registry_lock:
        _signatures.setdefault(name, set()).add(sig)


def record_build(library: str) -> None:
    """Record one build or load of the kernel library ``library``."""
    with _registry_lock:
        _builds[library] = _builds.get(library, 0) + 1


def records_launches(name: str | None = None, static=()):
    """Decorator: every call of the function records its launch signature
    under ``name`` (default: the function's name); the parameters named in
    ``static`` count by value, every other by shape and dtype.

    The port's counterpart of the trace cache ``jax.jit`` keeps: a function
    so decorated can be handed to ``CompileAuditor(extra_jitted=...)``.
    """
    static = frozenset(static)

    def deco(fn):
        key = name or fn.__name__
        params = list(fn.__code__.co_varnames[: fn.__code__.co_argcount])

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            traced, fixed = [], {}
            for i, a in enumerate(args):
                pname = params[i] if i < len(params) else None
                if pname in static:
                    fixed[pname] = a
                else:
                    traced.append(a)
            for k, v in kwargs.items():
                if k in static:
                    fixed[k] = v
                else:
                    traced.append(v)
            record_launch(key, traced, **fixed)
            return fn(*args, **kwargs)

        wrapper.launch_name = key
        return wrapper

    return deco


# ---------------------------------------------------------------------------
# CompileAuditor


class CompileAuditor:
    """Counts the new launch signatures per kernel across a ``with`` block.

    The port's counterpart of the reference's trace counter, with its API:
    ``new_traces`` per kernel (every entry point of
    :data:`KERNEL_ENTRY_POINTS` and every one that recorded since, each a
    delta over the block), ``total_new_traces`` and
    ``assert_log_bound(m)``, which enforces the engine's O(log m) promise:
    with pow2 bucketing, a full truss decomposition or incremental session
    over an m-edge graph may launch each kernel with at most
    ``factor * log2(m) + slack`` distinct signatures.  ``new_signatures``
    lists them.  ``new_builds`` counts the kernel libraries built or loaded
    inside the block, per library.

    ``extra_jitted`` maps report names to further callables; each must be
    decorated with :func:`records_launches` (the port's stand-in for a
    jitted function's cache), and is reported under the given name.
    """

    def __init__(self, extra_jitted=None):
        self._extra: dict[str, str] = {}
        for report, fn in (extra_jitted or {}).items():
            key = getattr(fn, "launch_name", None)
            if key is None:
                raise TypeError(
                    f"extra_jitted[{report!r}] records no launch signatures; decorate it "
                    "with repro_torch.check.runtime.records_launches"
                )
            self._extra[report] = key
        self._start = None
        self._end = None

    def _snapshot(self):
        with _registry_lock:
            return {name: frozenset(s) for name, s in _signatures.items()}, dict(_builds)

    def __enter__(self) -> "CompileAuditor":
        self._start, self._end = self._snapshot(), None
        return self

    def __exit__(self, *exc) -> bool:
        self._end = self._snapshot()
        return False

    def _ends(self):
        if self._start is None:
            raise RuntimeCheckError("CompileAuditor used outside a with block")
        return self._start, (self._end if self._end is not None else self._snapshot())

    @property
    def new_signatures(self) -> "dict[str, list[tuple]]":
        """Per-kernel launch signatures first seen inside the block:
        ``((traced args' shape and dtype, ...), ((static name, value), ...))``."""
        (start, _), (end, _) = self._ends()
        out = {name: sorted(sigs - start.get(name, frozenset()), key=repr)
               for name, sigs in end.items()}
        for report, key in self._extra.items():
            out[report] = out.get(key, [])
        return out

    @property
    def new_traces(self) -> "dict[str, int]":
        """Per-kernel count of launch signatures first seen inside the block."""
        return {name: len(sigs) for name, sigs in self.new_signatures.items()}

    @property
    def total_new_traces(self) -> int:
        return sum(self.new_traces.values())

    @property
    def new_builds(self) -> "dict[str, int]":
        """Per-library count of kernel-library builds or loads inside the block."""
        (_, start), (_, end) = self._ends()
        return {name: n - start.get(name, 0) for name, n in end.items()}

    def assert_log_bound(self, m: int, *, factor: float = 4.0, slack: int = 6) -> int:
        """Assert every kernel launched <= ``factor*log2(m) + slack`` signatures.

        Returns the bound so callers can log it.  ``factor`` covers the
        independent static axes that legitimately multiply the shape
        buckets (wedge budget x bisection depth), ``slack`` the one-off
        warmup shapes.
        """
        bound = int(factor * math.log2(max(int(m), 2)) + slack)
        offenders = {k: v for k, v in self.new_traces.items() if v > bound}
        if offenders:
            raise RuntimeCheckError(
                f"REPRO_CHECK: compile-count bound exceeded for m={m} "
                f"(bound {bound}): {offenders}; pow2 bucketing is not reaching "
                "these kernels (see repro_torch/check/recompile.py)"
            )
        return bound
