"""Hooks the cost walker (:mod:`repro_torch.launch.flops`) reads.

The walker sees every torch op of a step through a ``TorchDispatchMode``.
Three things it cannot see that way are told to it here, each a no-op
unless a walker is active:

* :func:`record_collective` — what a merge site of the single-controller
  mesh would move between devices.  On a mesh of ``meta`` devices every
  device is one device and a ``.to(lead)`` moves nothing, so each merge
  says what it stands for: its kind (the reference's names:
  ``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), the operand bytes one device holds, and the
  mesh axes it runs over.
* :func:`repeated` — the work inside stands for ``n`` copies of itself:
  on a ``meta`` mesh one replica, one stripe or one block is traced for
  all of them when they have one shape, as the reference's walker
  multiplies a ``shard_map`` body by the mesh size.
* :func:`region` — the ops of a function, forward and backward, are
  also summed under a name (``attention``), or counted as another
  primitive (``ragged_dot``: the reference's grouped matmul).
"""
from __future__ import annotations

import contextlib
import functools

__all__ = ["COLLECTIVE_KINDS", "active_walker", "record_collective", "repeated", "stand_in",
           "region"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

# the active walkers, innermost last (the walker pushes and pops itself)
_WALKERS: list = []


def active_walker():
    """The innermost active cost walker, or None."""
    return _WALKERS[-1] if _WALKERS else None


def record_collective(kind: str, bytes_per_device, axes) -> None:
    """Tell the active walker that a collective of ``kind`` over mesh
    ``axes`` moves ``bytes_per_device`` operand bytes on each device."""
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; expected one of {COLLECTIVE_KINDS}")
    w = active_walker()
    if w is not None:
        w.collective(kind, float(bytes_per_device), tuple(axes))


@contextlib.contextmanager
def repeated(n: int):
    """Inside, every op and every collective counts ``n`` times."""
    w = active_walker()
    if w is None or n == 1:
        yield
        return
    w.push_repeat(n)
    try:
        yield
    finally:
        w.pop_repeat()


def stand_in(items, one: bool):
    """Iterate ``items``; with ``one``, only the first, its work counted
    ``len(items)`` times (:func:`repeated`).  For a loop over replicas,
    stripes or blocks of one shape on a ``meta`` mesh."""
    items = list(items)
    if not one or len(items) <= 1:
        yield from items
        return
    with repeated(len(items)):
        yield items[0]


def region(name: str):
    """Decorator: while a walker is active, the function's ops and the
    backward of what it computes are summed under ``name`` as well."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            w = active_walker()
            if w is None:
                return fn(*args, **kwargs)
            with w.in_region(name):
                out = fn(*args, **kwargs)
            w.tag_backward(name, out, args)
            return out

        return wrapper

    return deco
