"""trilint pass: observability spans over device work must sync.

The port's counterpart of ``repro.check.obs_discipline``.  CUDA launches
are asynchronous, so a span that wraps a kernel launch but closes without
a synchronization point records the *enqueue* time (microseconds) instead
of the device compute time — the trace looks implausibly fast and every
derived number (stripe skew, overhead tables) is garbage.  The invariant:
any ``with ...span(...)`` block whose body launches device work must call
a sync point before the span closes.

* ``D1-unsynced-span`` — a span context manager whose body calls a
  device-work entry point but contains no sync call.

"Device work" is recognized by call-name convention, matching the port's
launch vocabulary: a last name that starts with ``chunk_`` or
``intersect_`` (the panel and ``*_csr`` kernel wrappers and their ``ops``
entries), ends with ``_chunk`` (a backend's chunk methods), or is one of
the launch wrappers (``_stripe_body``, ``striped_workload_fn``,
``flash_attention_cuda``, ``run_workload``).  A bare ``_csr`` suffix is no
mark of device work: ``to_csr``, ``resolve_to_csr`` and
``workload_from_csr`` build a CSR on the host.  Sync points are
``Span.sync`` / ``obs.sync`` (``sync``), ``torch.cuda.synchronize``, and
the host reads ``.item()`` and ``.cpu()``, which wait for the device.  The
reference's ``pallas_call``/``shard_map`` are not listed: the port never
calls them.  Spans around pure-host work (parsing, CSR assembly, numpy
folds) are exempt — host calls return only when done, so the span is
honest without a sync.  A span whose body reaches device work only
through a helper of another name (``_probe`` in ``core/incremental.py``,
``run`` in ``core/engine.py``'s stripe probe) is not seen; those helpers
end in a host read or a ``torch.cuda.synchronize`` of their own.
"""

from __future__ import annotations

import ast

from .base import Finding, ModuleInfo, call_name, register_pass, walk_calls

# Launch wrappers that dispatch device work without the kernel naming
# convention (kept in sync with repro_torch.kernels / repro_torch.core).
LAUNCH_WRAPPERS = frozenset(
    {"_stripe_body", "striped_workload_fn", "flash_attention_cuda", "run_workload"}
)

# Call names that prove the span waited for the device.
SYNC_NAMES = frozenset({"sync", "synchronize", "item", "cpu"})


def _is_span_call(node: ast.expr) -> bool:
    """True for ``obs.span(...)`` / ``trc.span(...)`` / ``tracer.span(...)``."""
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    return name == "span" or name.endswith(".span")


def _last_name(call: ast.Call) -> str:
    """The called name's last segment, also for ``f(x).cpu()``-style chains."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else ""


def _is_device_work(last: str) -> bool:
    return (
        last.startswith("chunk_")
        or last.startswith("intersect_")
        or last.endswith("_chunk")
        or last in LAUNCH_WRAPPERS
    )


@register_pass("obs_discipline")
def check_obs_discipline(mod: ModuleInfo) -> "list[Finding]":
    findings: "list[Finding]" = []

    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(_is_span_call(item.context_expr) for item in node.items):
            continue

        device_calls: "list[str]" = []
        synced = False
        for call in walk_calls(ast.Module(body=node.body, type_ignores=[])):
            last = _last_name(call)
            if not last:
                continue
            if last in SYNC_NAMES:
                synced = True
            elif _is_device_work(last):
                device_calls.append(call_name(call) or last)

        if device_calls and not synced:
            launches = ", ".join(sorted(set(device_calls)))
            findings.append(
                mod.finding(
                    "obs_discipline",
                    "D1-unsynced-span",
                    node,
                    f"span wraps device work ({launches}) but closes without "
                    "a sync point; CUDA launches are async, so the span records "
                    "enqueue latency, not device time — call `sp.sync(...)` "
                    "or `torch.cuda.synchronize()` before the span exits",
                )
            )
    return findings
