"""Session snapshot/restore through the checkpoint subsystem.

The PyTorch counterpart of ``repro.serve.snapshot``, over
:mod:`repro_torch.checkpoint`, whose on-disk format is the reference's:
a snapshot directory written by either package restores in the other.

A :class:`SnapshotStore` is a thin typed wrapper over
:class:`repro_torch.checkpoint.CheckpointManager` for serving state: the
checkpointed pytree is a :meth:`StreamSession.state_tree` (canonical
directed adjacency, global count, per-node incidences, degrees, node
count, stream cursor) and the checkpoint *step* is the stream cursor —
so ``step_000000128/`` literally reads "state after 128 batches".

All of the checkpoint layer's durability guarantees apply: versioned
manifests with per-array crc32, COMMIT markers, atomic publish, and a
``restore_latest`` that silently skips torn/truncated/corrupted
candidates — killing a serving process mid-snapshot can cost at most
the batches since the last *committed* snapshot, never the store.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager, restore_latest

__all__ = ["SnapshotStore", "session_template", "load_latest_state"]


def session_template() -> dict[str, np.ndarray]:
    """Dtype/structure template for restoring a session state tree.

    ``restore_checkpoint`` takes shapes from the file and dtypes/keys
    from the target, so zero-length arrays of the right dtype suffice.
    """
    z = np.zeros(0, np.int64)
    return {
        "adj": z,
        "per_node": z,
        "deg": z,
        "count": np.asarray(0, np.int64),
        "n_nodes": np.asarray(0, np.int64),
        "cursor": np.asarray(0, np.int64),
    }


def load_latest_state(directory: str | os.PathLike):
    """``(state_tree, cursor, extra)`` of the newest valid snapshot, or None."""
    hit = restore_latest(os.fspath(directory), session_template())
    if hit is None:
        return None
    tree, step, extra = hit
    return tree, int(step), extra


class SnapshotStore:
    """Rolling session snapshots in one directory (cursor = step)."""

    def __init__(
        self,
        directory: str | os.PathLike,
        *,
        keep: int = 3,
        async_save: bool = False,
    ):
        self.directory = os.fspath(directory)
        self._mgr = CheckpointManager(self.directory, keep=keep, async_save=async_save)

    def save(self, session, extra: dict | None = None) -> int:
        """Checkpoint ``session`` at its current cursor; returns the cursor."""
        tree = session.state_tree()
        cursor = int(np.asarray(tree["cursor"]))
        meta = {"session": session.name,
                "n_edges": int(session.counter.n_edges),
                "count": int(session.counter.count)}
        if extra:
            meta.update(extra)
        with obs.span("serve.snapshot", cat="serve",
                      args={"session": session.name, "cursor": cursor}):
            self._mgr.save(cursor, tree, extra=meta)
        obs.counter("serve.snapshots").add()
        return cursor

    def wait(self) -> None:
        """Join any in-flight async save (surfacing its error here)."""
        self._mgr.wait()

    def load_latest(self):
        """``(state_tree, cursor, extra)`` of the newest valid snapshot, or None."""
        self._mgr.wait()
        return load_latest_state(self.directory)

    def restore_session(
        self,
        name: str,
        *,
        max_wedge_chunk: int | None = None,
        method: str = "auto",
        mesh=None,
        device=None,
    ):
        """Rebuild a :class:`StreamSession` from the newest valid snapshot.

        The restored counter runs on ``device`` (``None``: the card).
        Returns ``(session, extra)`` or ``None`` when the directory holds
        no restorable snapshot (fresh start).
        """
        from .session import StreamSession

        hit = self.load_latest()
        if hit is None:
            return None
        tree, cursor, extra = hit
        session = StreamSession.from_state(
            name, tree, max_wedge_chunk=max_wedge_chunk, method=method, mesh=mesh,
            device=device,
        )
        obs.counter("serve.restores").add()
        return session, extra
