"""Admission control: bounded per-class queues, tickets, window batching.

A copy of ``repro.serve.admission`` (standard library and
:mod:`repro_torch.obs` only), so the port imports nothing of ``repro``.

The service classifies every request into a **traffic class** (point
lookups, per-node scans, heavy per-edge workloads, mutations) and each
class gets its own bounded FIFO with its own :class:`ClassPolicy` —
queue-depth bound (admission rejects with :class:`QueueOverflow` when
full), maximum queue wait (requests that sat longer complete with
:class:`QueryTimeout` instead of executing), and a per-dispatch batch
cap.  A slow truss/support request therefore cannot starve point
lookups: heavies queue, time out, and overflow on their own budget
while the point class keeps draining.

Batching follows the offline-inference shape (collect a window,
dispatch once, scatter answers back to waiters): a dispatcher blocks in
:meth:`AdmissionQueue.collect` until its lane has work, then drains
everything admissible right now — up to each class's ``max_batch``,
lingering at most ``batch_window_s`` for stragglers.  The default
window is **zero**: batches form naturally from whatever queued while
the previous dispatch was executing (continuous batching), so an idle
service adds no artificial latency to a lone request.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Mapping

from repro_torch import obs

__all__ = [
    "ClassPolicy",
    "QueueOverflow",
    "QueryTimeout",
    "Ticket",
    "Request",
    "AdmissionQueue",
]


class QueueOverflow(RuntimeError):
    """Admission rejected: the request's class queue is at max_queue."""


class QueryTimeout(TimeoutError):
    """The request waited in the queue longer than its class allows."""


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    """Per-traffic-class admission and batching knobs."""

    max_queue: int = 1024          # pending requests before admission rejects
    timeout_s: float | None = None  # max queue wait; None = wait forever
    max_batch: int = 64            # requests fused per dispatch window
    batch_window_s: float = 0.0    # linger after the first request arrives

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.batch_window_s < 0:
            raise ValueError("batch_window_s must be >= 0")
        if self.timeout_s is not None and self.timeout_s < 0:
            raise ValueError("timeout_s must be >= 0 (or None)")


class Ticket:
    """A waiter's handle on one submitted request.

    ``result()`` blocks until the dispatcher resolves or rejects the
    request; rejection re-raises the stored exception in the waiter's
    thread (the dispatcher never dies on a request error).
    """

    __slots__ = ("kind", "traffic_class", "t_submit", "t_done",
                 "_event", "_value", "_error")

    def __init__(self, kind: str, traffic_class: str):
        self.kind = kind
        self.traffic_class = traffic_class
        self.t_submit = time.monotonic()
        self.t_done: float | None = None
        self._event = threading.Event()
        self._value: Any = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def wait_s(self) -> float:
        """Queue+execute latency (submit → resolution), once done."""
        return (self.t_done or time.monotonic()) - self.t_submit

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"{self.kind} ticket not resolved within {timeout}s "
                "(service stopped, or dispatch is wedged)"
            )
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: float | None = None) -> BaseException | None:
        """The stored rejection, without raising (None once resolved OK)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.kind} ticket not resolved within {timeout}s")
        return self._error

    # dispatcher side --------------------------------------------------------

    def resolve(self, value) -> None:
        self._value = value
        self.t_done = time.monotonic()
        self._event.set()

    def reject(self, error: BaseException) -> None:
        self._error = error
        self.t_done = time.monotonic()
        self._event.set()


@dataclasses.dataclass
class Request:
    """One admitted request, queued until a dispatch window collects it."""

    graph: str
    kind: str
    params: dict
    traffic_class: str
    ticket: Ticket

    @property
    def t_submit(self) -> float:
        return self.ticket.t_submit


class AdmissionQueue:
    """Per-class bounded FIFOs with window collection for dispatchers.

    One condition variable covers every class: dispatchers collect over
    a *lane* (a tuple of class names) and are woken by any submit into
    one of their classes.  ``close()`` wakes everything; a closing
    queue still drains — ``collect`` keeps returning batches until its
    lane is empty, then returns ``[]`` forever.
    """

    def __init__(self, policies: Mapping[str, ClassPolicy]):
        if not policies:
            raise ValueError("at least one traffic class is required")
        self._policies = dict(policies)
        self._queues: dict[str, collections.deque[Request]] = {
            c: collections.deque() for c in self._policies
        }
        self._cond = threading.Condition()
        self._closed = False

    @property
    def classes(self) -> tuple[str, ...]:
        return tuple(self._policies)

    def policy(self, traffic_class: str) -> ClassPolicy:
        return self._policies[traffic_class]

    def depth(self, traffic_class: str) -> int:
        return len(self._queues[traffic_class])

    def submit(self, req: Request) -> None:
        """Admit ``req`` or raise :class:`QueueOverflow` / RuntimeError."""
        with self._cond:
            if self._closed:
                raise RuntimeError("service is shut down; request rejected")
            pol = self._policies[req.traffic_class]
            q = self._queues[req.traffic_class]
            if len(q) >= pol.max_queue:
                obs.counter("serve.overflows").add()
                raise QueueOverflow(
                    f"class {req.traffic_class!r}: {len(q)} pending >= "
                    f"max_queue={pol.max_queue}"
                )
            q.append(req)
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def reject_pending(self, error: BaseException) -> int:
        """Fail every queued request (shutdown path); returns how many."""
        with self._cond:
            n = 0
            for q in self._queues.values():
                while q:
                    q.popleft().ticket.reject(error)
                    n += 1
            return n

    def _drain(self, lane: tuple[str, ...], taken: dict[str, int]) -> list[Request]:
        out = []
        for c in lane:
            pol, q = self._policies[c], self._queues[c]
            while q and taken[c] < pol.max_batch:
                out.append(q.popleft())
                taken[c] += 1
        return out

    def collect(self, lane: tuple[str, ...]) -> list[Request]:
        """Block for the lane's next dispatch window; ``[]`` = shut down.

        Returns as soon as the window closes: immediately when every
        lane class has ``batch_window_s == 0`` (continuous batching),
        otherwise after lingering up to the lane's largest window for
        stragglers, and always as soon as every class hits its
        ``max_batch``.
        """
        window = max(self._policies[c].batch_window_s for c in lane)
        taken = {c: 0 for c in lane}
        with self._cond:
            while True:
                if any(self._queues[c] for c in lane):
                    break
                if self._closed:
                    return []
                self._cond.wait()
            batch = self._drain(lane, taken)
            deadline = time.monotonic() + window
            while not all(taken[c] >= self._policies[c].max_batch for c in lane):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                if not any(self._queues[c] for c in lane):
                    self._cond.wait(remaining)
                batch.extend(self._drain(lane, taken))
            return batch
