"""trilint fixture: deliberate obs-discipline violations (D1), the port's vocabulary.

Parsed, never imported.  The first two spans wrap device work (a CSR kernel
wrapper, the stripe body) but close without a sync point — CUDA launches
are asynchronous, so such a span measures enqueue latency, not device time.
The others sync (``sp.sync``, ``torch.cuda.synchronize``, a ``.cpu()`` host
read), time the work with a CUDA event pair (``sp.device_time``), or wrap
host work only, and are compliant.
"""

import torch


def unsynced_csr(obs, ops, row, col, u, v, width):
    # D1: a CSR kernel launch inside the span, no sync before it closes.
    with obs.span("count.chunk", cat="engine"):
        part = ops.intersect_count_csr(row, col, u, v, width)
    return part


def unsynced_stripe(obs, body, *args):
    # D1: the stripe body launches torch ops on the stripe's device.
    with obs.span("stripe.run", cat="engine.stripes"):
        part = _stripe_body("count", *args)
    return part


def _stripe_body(kind, *args):  # stand-in (naming convention)
    return args


def synced_span(obs, ops, row, col, u, v, width):
    with obs.span("count.chunk", cat="engine") as sp:
        part = sp.sync(ops.intersect_count_csr(row, col, u, v, width))
    return part


def event_pair(obs, ops, row, col, u, v, width):
    with obs.span("count.chunk", cat="engine") as sp, sp.device_time(row.device):
        part = ops.intersect_count_csr(row, col, u, v, width)
    return part


def synchronized(obs, backend, adj, chunk):
    with obs.span("count.chunk", cat="engine"):
        part = backend.count_chunk(adj, chunk)
        torch.cuda.synchronize()
    return part


def host_read(obs, backend, adj, chunk, n):
    with obs.span("per_node.chunk", cat="engine"):
        part = backend.per_node_chunk(adj, chunk, n).cpu()
    return part


def host_only(obs, edges):
    with obs.span("ingest.to_csr", cat="io"):
        csr = to_csr(edges)
    return csr


def to_csr(edges):  # host work: returns only when done
    return edges
