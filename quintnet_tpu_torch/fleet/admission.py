"""Bounded fleet-wide admission queue + typed load shedding.

A serving front-end that queues without bound converts overload into
unbounded latency: every request eventually "succeeds" seconds or
minutes late, which for an interactive workload is indistinguishable
from failure — except the client got no signal to back off or retry
elsewhere. The fleet therefore sheds: :class:`Overloaded` is a TYPED
rejection carrying a machine-readable ``reason``, raised

- at submit time when the pending queue is at ``max_pending``
  (``reason='queue_full'`` — the >capacity-burst signal), or when the
  fleet is draining/closed (``reason='shutdown'``);
- at dispatch time when a queued request's deadline has already
  passed (``reason='deadline'`` — serving it late would waste replica
  work the client will discard; shedding it is strictly better for
  everyone behind it in the queue).

Migration re-queues (:meth:`AdmissionQueue.push_front`) bypass the
bound: that work was already admitted once and its tokens are already
partially delivered — shedding it on re-entry would turn one replica
death into client-visible failures, which is exactly what migration
exists to prevent.

The queue is NOT internally locked: the fleet serialises all access
under its own condition lock; this class owns only the policy.

Port of ``quintnet_tpu/fleet/admission.py`` (standard library only).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

SHED_REASONS = ("queue_full", "deadline", "shutdown", "pool_down")


class Overloaded(RuntimeError):
    """Typed rejection: the fleet refused (or abandoned) a request
    instead of queueing it forever. ``reason`` is one of
    ``queue_full`` / ``deadline`` / ``shutdown`` / ``pool_down``
    (disaggregated fleets only: the decode pool has no live member
    and every breaker is tripped — queueing would hide an outage the
    client should route around; fleet/proc.py)."""

    def __init__(self, reason: str, message: str):
        assert reason in SHED_REASONS, reason
        super().__init__(message)
        self.reason = reason


class AdmissionQueue:
    """Bounded FIFO of pending fleet requests with deadline shedding.

    Items must expose a ``deadline`` attribute (absolute fleet-clock
    time, or ``None``)."""

    def __init__(self, max_pending: int,
                 clock: Callable[[], float] = time.monotonic):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = int(max_pending)
        self.clock = clock
        self._items: List = []

    def __len__(self) -> int:
        return len(self._items)

    @property
    def full(self) -> bool:
        return len(self._items) >= self.max_pending

    def push(self, item) -> None:
        """Append, or raise ``Overloaded('queue_full')`` at the bound."""
        if self.full:
            raise Overloaded(
                "queue_full",
                f"admission queue full ({self.max_pending} pending); "
                f"shedding instead of queueing unboundedly — retry with "
                f"backoff or raise max_pending/replicas")
        self._items.append(item)

    def push_front(self, items: List) -> None:
        """Re-queue migrated work at the head of the line (it keeps its
        place — it was admitted before anything currently pending).
        Deliberately bypasses ``max_pending``; see module docstring."""
        self._items[:0] = items

    def shed_expired(self, now: Optional[float] = None) -> List:
        """Remove and return every queued item whose deadline has
        passed (the caller rejects them with ``Overloaded('deadline')``)."""
        now = self.clock() if now is None else now
        expired = [i for i in self._items
                   if i.deadline is not None and now >= i.deadline]
        if expired:
            self._items = [i for i in self._items if i not in expired]
        return expired

    def oldest_wait_s(self, now: Optional[float] = None) -> float:
        """Wait age of the OLDEST queued item (0.0 when empty). Not
        necessarily the head: migration re-queues push_front younger
        work past older arrivals, so this scans ``submit_time`` across
        the queue. The overload signal the pressure plane samples and
        the front door's 429 Retry-After hints with — queue DEPTH says
        how much is waiting, wait AGE says how badly."""
        items = list(self._items)
        if not items:
            return 0.0
        now = self.clock() if now is None else now
        oldest = min(getattr(i, "submit_time", now) for i in items)
        return max(now - oldest, 0.0)

    def peek_adapter_id(self) -> Optional[str]:
        """The queue head's LoRA binding (or None) — the dispatcher
        reads it before :meth:`pop` so the router can apply adapter
        affinity to the request it is about to place."""
        if not self._items:
            return None
        return getattr(self._items[0], "adapter_id", None)

    def pop(self):
        """Head of the line, or None."""
        return self._items.pop(0) if self._items else None

    def items(self) -> List:
        """Queue contents in order (a read-only view for the
        disaggregated dispatcher, which must skip past a head it has
        no pool for — a decode-phase request waiting on its pool must
        not block a prefill-phase request behind it)."""
        return list(self._items)

    def remove(self, item) -> None:
        """Take one specific item out of line (the disaggregated
        dispatcher claims the first DISPATCHABLE item, not
        necessarily the head)."""
        self._items.remove(item)

    def drain_all(self) -> List:
        """Empty the queue (shutdown path); returns what was pending."""
        items, self._items = self._items, []
        return items
