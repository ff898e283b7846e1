"""Graph serving of the port: streaming sessions and their snapshots.

::

    drive_stream  ──►  StreamSession  ──►  IncrementalTriangleCounter
                            │
                       SnapshotStore  ──►  repro_torch.checkpoint

* :mod:`~repro_torch.serve.session` — streaming tenants: incremental
  counter state + stream cursor; the single-tenant ``drive_stream`` loop
  behind ``python -m repro_torch.launch.serve_graph``.
* :mod:`~repro_torch.serve.snapshot` — kill-safe snapshot/restore of
  session state through the checkpoint subsystem (the reference's
  format: snapshots move between the two packages).

The multi-tenant service of the reference (admission queues, graph
residency, query fusion, the load generator) waits for ROADMAP A5.
"""
from .session import QUERY_KINDS, StreamSession, drive_stream
from .snapshot import SnapshotStore, load_latest_state, session_template

__all__ = [
    "QUERY_KINDS",
    "StreamSession",
    "drive_stream",
    "SnapshotStore",
    "load_latest_state",
    "session_template",
]
