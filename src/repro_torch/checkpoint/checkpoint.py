"""Npz checkpoints with manifests, async save and resume.

The port's counterpart of ``repro.checkpoint.checkpoint``, with the same
on-disk format, so a checkpoint written by either package restores in
the other.  Layout::

    <dir>/step_000123/
        manifest.json     # format_version, step, tree paths, shapes, dtypes,
                          # crc32 per leaf
        arrays.npz        # one entry per leaf, key = flattened tree path
        COMMIT            # written last; a checkpoint without it is torn

A tree is a nest of ``dict`` / ``list`` / ``tuple`` / ``NamedTuple``
whose leaves are numpy arrays, scalars or torch tensors; ``None`` holds
no leaf.  Leaf keys are the reference's (``jax.tree_util`` paths): dict
keys in sorted order, sequence positions and NamedTuple fields as
``.name``, joined with ``/`` — so ``{"opt": OptState(...)}`` has the keys
``opt/.step``, ``opt/.mu/...``, and a train state moves between the
packages.

Fault-tolerance contract (the serving layer's snapshot/restore path
depends on it):

* The manifest carries ``format_version``; a version mismatch (or a
  manifest written before versioning existed) is treated exactly like
  corruption — skipped, never half-read.
* Every leaf is integrity-checked on restore: shape, dtype **and**
  crc32 of the raw bytes must match the manifest.
* ``save`` stages into ``step_X.tmp`` and publishes by rename.
  Overwriting an existing step moves the old directory aside *before*
  the rename and removes it only after the new one is in place — there
  is never a window in which a crash leaves neither.
* ``restore_latest`` walks checkpoints newest-first, validating the
  COMMIT marker and the full manifest, and falls back to the previous
  one on any torn/truncated/corrupted/mis-versioned candidate.
* Torch tensors are copied to host numpy at save, and a
  :class:`~repro_torch.distributed.ShardedTensor` is gathered (arrays are
  stored unsharded); a tensor leaf of the restore target comes back as a
  tensor of its dtype on its device (a sharded one as a host tensor).
  ``restore`` takes an optional
  ``shardings`` tree of :class:`~repro_torch.distributed.NamedSharding`
  and places each leaf by it (``device_put``) — restoring onto a
  *different* mesh shape (elastic restart) is therefore free.
* ``CheckpointManager(async_save=True)`` snapshots to host memory
  synchronously and writes in a background thread (one in-flight save).
  ``save``/``wait`` are thread-safe, background errors surface on the
  next ``save()`` *or* ``wait()``, and the retention GC only ever prunes
  **committed** checkpoints other than the one currently in flight — a
  torn directory from a crashed writer (or another process mid-publish)
  is never counted toward ``keep`` and never deleted out from under an
  in-flight rename.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardedTensor, device_put

__all__ = [
    "FORMAT_VERSION",
    "save_checkpoint",
    "restore_checkpoint",
    "restore_latest",
    "list_checkpoints",
    "CheckpointManager",
]

# manifests declare their layout, so a future change invalidates old
# checkpoints loudly instead of misreading them
FORMAT_VERSION = 2

def _map_leaves(tree, fn, prefix=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(tree[k], fn, prefix + (k,)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        # a NamedTuple (the optimizer's OptState): jax keys its fields by
        # GetAttrKey, which renders as ".name"
        return type(tree)(*(_map_leaves(getattr(tree, f), fn, prefix + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _leaves_with_path(tree) -> list:
    """``(path, leaf)`` pairs in the reference's order."""
    out = []
    _map_leaves(tree, lambda path, leaf: out.append((path, leaf)))
    return out


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, ShardedTensor):
        return leaf.numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(path): _host_array(leaf) for path, leaf in _leaves_with_path(tree)}


def save_checkpoint(directory: str, step: int, tree: Any, extra: dict | None = None) -> str:
    """Write checkpoint synchronously; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    manifest = {
        "format_version": FORMAT_VERSION,
        "step": step,
        "extra": extra or {},
        "leaves": {
            k: {
                "shape": list(v.shape),
                "dtype": str(v.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(v).tobytes()),
            }
            for k, v in flat.items()
        },
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    # publish: the old step (if any) moves aside before the rename and is
    # removed only after the new directory holds the name, so at every
    # instant at least one committed copy of this step exists on disk
    old = None
    if os.path.exists(final):
        old = final + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)
    os.rename(tmp, final)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return final


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith((".tmp", ".old")):
            try:
                out.append((int(name[5:]), os.path.join(directory, name)))
            except ValueError:
                continue
    return sorted(out)


def _validate(path: str) -> dict | None:
    """The manifest if ``path`` is a complete, uncorrupted checkpoint."""
    if not os.path.exists(os.path.join(path, "COMMIT")):
        return None
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != FORMAT_VERSION:
            return None
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for key, meta in manifest["leaves"].items():
                arr = z[key]
                if list(arr.shape) != meta["shape"]:
                    return None
                if str(arr.dtype) != meta["dtype"]:
                    return None
                if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != meta["crc32"]:
                    return None
        return manifest
    except Exception:
        # truncated npz, unreadable json, missing leaf — all torn
        return None


def _like(arr: np.ndarray, leaf):
    """A restored array in the type, dtype (and device) of the target leaf."""
    if isinstance(leaf, ShardedTensor):  # on the host until shardings= places it
        return torch.from_numpy(np.ascontiguousarray(arr)).to(leaf.dtype)
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def restore_checkpoint(path: str, target: Any, shardings: Any | None = None):
    """Restore into the structure of ``target`` (shapes come from the file);
    with ``shardings``, each leaf placed by its ``NamedSharding``."""
    manifest = _validate(path)
    if manifest is None:
        raise ValueError(f"checkpoint at {path} is torn or corrupted")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        restored = {}
        for key_path, _ in _leaves_with_path(target):
            key = _key(key_path)
            if key not in z:
                raise KeyError(f"leaf {key} missing from checkpoint")
            restored[key] = z[key]
    tree = _map_leaves(target, lambda p, leaf: _like(restored[_key(p)], leaf))
    if shardings is not None:
        tree = device_put(tree, shardings)
    return tree, manifest["step"], manifest["extra"]


def restore_latest(directory: str, target: Any, shardings: Any | None = None):
    """Newest valid checkpoint, falling back past torn/corrupted ones."""
    for step, path in reversed(list_checkpoints(directory)):
        if _validate(path) is not None:
            return restore_checkpoint(path, target, shardings)
    return None


class CheckpointManager:
    """Rolling checkpoints with optional async (background-thread) save.

    Thread-safe: concurrent ``save``/``wait`` calls serialize on an
    internal lock (at most one in-flight background write), and the
    retention GC prunes only *committed* checkpoints, never the one the
    in-flight thread is still publishing.
    """

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._lock = threading.RLock()
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._inflight_step: int | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        with self._lock:
            self.wait()  # one in-flight save max; raises a pending error
            # copy to host synchronously: tensors and arrays may mutate
            # while the background thread writes
            host_tree = _map_leaves(tree, lambda _, x: np.array(_host_array(x)))
            self._inflight_step = step

            def _do():
                try:
                    save_checkpoint(self.directory, step, host_tree, extra)
                    self._gc(protect=step)
                except Exception as e:  # surfaced on next save()/wait()
                    self._error = e

            if self.async_save:
                self._thread = threading.Thread(target=_do, daemon=True)
                self._thread.start()
            else:
                _do()
                self._inflight_step = None
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err

    def wait(self) -> None:
        """Join any in-flight save; raises its error here if it failed."""
        with self._lock:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
                self._inflight_step = None
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def _gc(self, protect: int | None = None) -> None:
        # only COMMITted checkpoints count toward (or are pruned by) the
        # retention budget: a torn dir from a crashed writer — or another
        # process mid-publish — is neither trusted nor deleted
        committed = [
            (step, path)
            for step, path in list_checkpoints(self.directory)
            if step != protect and step != self._inflight_step
            and os.path.exists(os.path.join(path, "COMMIT"))
        ]
        survivors = self.keep - (1 if protect is not None else 0)
        doomed = committed[:-survivors] if survivors > 0 else committed
        for _, path in doomed:
            shutil.rmtree(path, ignore_errors=True)

    def restore_latest(self, target: Any, shardings: Any | None = None):
        self.wait()
        return restore_latest(self.directory, target, shardings)
