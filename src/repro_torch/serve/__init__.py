"""Multi-tenant graph serving of the port: admission, batching, residency, snapshots.

The PyTorch counterpart of ``repro.serve``, with the same export list.
Every engine runs on the service's ``device`` (``None``: the card).
Layering::

    loadgen  ──►  GraphService  ──►  TriangleCounter / IncrementalTriangleCounter
                   │    │    │
        AdmissionQueue  │   StreamSession ──► SnapshotStore ──► repro_torch.checkpoint
                 GraphManager ──► repro_torch.graphs.io (.tricsr mmaps)

* :mod:`~repro_torch.serve.admission` — per-traffic-class bounded queues,
  timeout/overflow policies, window batching.
* :mod:`~repro_torch.serve.manager` — multi-graph LRU residency under a byte
  budget; one shared autotuner tile cache for every engine.
* :mod:`~repro_torch.serve.service` — lane dispatchers fusing concurrent
  queries on a graph into one engine pass (answers bit-identical to
  sequential execution).
* :mod:`~repro_torch.serve.session` — streaming tenants: incremental counter
  state + stream cursor; the single-tenant ``drive_stream`` loop behind
  ``python -m repro_torch.launch.serve_graph``.
* :mod:`~repro_torch.serve.snapshot` — kill-safe snapshot/restore of session
  state through the checkpoint subsystem.
* :mod:`~repro_torch.serve.loadgen` — concurrent-client load generator and CI
  fusion attestation.
"""
from .admission import (
    AdmissionQueue,
    ClassPolicy,
    QueryTimeout,
    QueueOverflow,
    Request,
    Ticket,
)
from .manager import GraphEntry, GraphManager
from .service import (
    DEFAULT_POLICIES,
    HEAVY_LANE,
    KIND_TO_CLASS,
    READ_LANE,
    UPDATE_LANE,
    GraphService,
)
from .session import QUERY_KINDS, StreamSession, drive_stream
from .snapshot import SnapshotStore, load_latest_state, session_template
from .loadgen import DEFAULT_MIX, attest_fusion, run_load

__all__ = [
    "AdmissionQueue",
    "ClassPolicy",
    "QueryTimeout",
    "QueueOverflow",
    "Request",
    "Ticket",
    "GraphEntry",
    "GraphManager",
    "DEFAULT_POLICIES",
    "KIND_TO_CLASS",
    "READ_LANE",
    "HEAVY_LANE",
    "UPDATE_LANE",
    "GraphService",
    "QUERY_KINDS",
    "StreamSession",
    "drive_stream",
    "SnapshotStore",
    "load_latest_state",
    "session_template",
    "DEFAULT_MIX",
    "attest_fusion",
    "run_load",
]
