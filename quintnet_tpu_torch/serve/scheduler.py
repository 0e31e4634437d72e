"""Iteration-level request scheduler (Orca-style continuous batching).

Port of ``quintnet_tpu/serve/scheduler.py``. Decisions are made every
engine step: arrivals are admitted mid-flight whenever a slot and
enough KV blocks are free, finished rows retire individually, and when
the pool runs dry the YOUNGEST running request is evicted and goes back
to the head of the waiting queue (recompute-style preemption).

Policies: ``fcfs`` (arrival order) or ``priority`` (lower value first,
arrival breaks ties). Preempted requests keep their arrival stamp, so
they resume ahead of anything that arrived after them. The scheduler
owns request lifecycle state only; block tables and token buffers live
in the engine.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from quintnet_tpu_torch.serve.kv_pool import KVPool

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"


@dataclass
class RequestProgress:
    """Portable host-side resume payload for one unfinished request:
    the original prompt and the tokens generated so far. Any engine
    built from the same (family, params) that re-prefills ``prompt +
    generated`` continues a greedy stream exactly where it stopped.
    (The JAX payload also carries the evolved sampling key; the port
    serves greedy decoding only.)"""

    rid: int
    prompt: np.ndarray
    generated: List[int]
    max_new_tokens: int
    priority: int = 0
    preemptions: int = 0


@dataclass
class Request:
    """One generation request and its host-side progress. ``prompt`` is
    never mutated; ``generated`` accumulates across preemptions, so the
    resume prefill runs over ``prompt + generated``."""

    rid: int
    prompt: np.ndarray                      # [T0] int32, immutable
    max_new_tokens: int
    priority: int = 0                       # lower = more urgent
    arrival: int = 0                        # monotone submit stamp
    on_token: Optional[Callable] = None     # streaming callback

    # --- runtime (engine-managed) ---
    state: str = WAITING
    generated: List[int] = field(default_factory=list)
    # the plan the scheduler's budget check approved, consumed by the
    # engine's admission in the same step
    admit_plan: Optional[object] = None
    admit_seq: int = -1                     # last admission stamp
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    last_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    preemptions: int = 0

    @property
    def total_len(self) -> int:
        """Tokens whose KV the request holds when running."""
        return len(self.prompt) + len(self.generated)

    @property
    def remaining_new_tokens(self) -> int:
        return self.max_new_tokens - len(self.generated)

    def output_ids(self) -> np.ndarray:
        """prompt + generated."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    def progress(self) -> RequestProgress:
        return RequestProgress(
            rid=self.rid, prompt=np.array(self.prompt, copy=True),
            generated=list(self.generated),
            max_new_tokens=self.max_new_tokens, priority=self.priority,
            preemptions=self.preemptions)


class Scheduler:
    """Waiting queue + admission control + preemption victim selection."""

    def __init__(self, pool: KVPool, *, policy: str = "fcfs"):
        if policy not in ("fcfs", "priority"):
            raise ValueError(f"unknown policy {policy!r}; "
                             "expected 'fcfs' or 'priority'")
        self.pool = pool
        self.policy = policy
        self.waiting: List[Request] = []
        self._admit_counter = itertools.count()

    # ---- queue ------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.state = WAITING
        self.waiting.append(req)
        self._sort()

    def push_front(self, req: Request) -> None:
        """Re-queue a preempted request; its original arrival stamp puts
        it ahead of younger work."""
        self.submit(req)

    def _key(self, r: Request):
        if self.policy == "priority":
            return (r.priority, r.arrival)
        return (r.arrival,)

    def _sort(self) -> None:
        self.waiting.sort(key=self._key)

    # ---- admission --------------------------------------------------
    def admission_plan(self, req: Request):
        """The pool's AdmitPlan for this request: its whole prefill
        (prompt + generated) plus the first decode write slot; only
        blocks not already in the prefix cache count against the
        allocator."""
        return self.pool.plan_admission(req.output_ids(),
                                        req.total_len + 1)

    def next_admission(self, free_slots: int) -> Optional[Request]:
        """Pop the head waiting request if it is admissible, else None.
        Head-of-line blocking is intentional (strict FCFS/priority)."""
        if free_slots <= 0 or not self.waiting:
            return None
        if self.pool.num_available == 0:
            return None
        head = self.waiting[0]
        plan = self.admission_plan(head)
        if not self.pool.can_admit(plan):
            return None
        self.waiting.pop(0)
        head.state = RUNNING
        head.admit_seq = next(self._admit_counter)
        head.admit_plan = plan
        return head

    # ---- preemption -------------------------------------------------
    @staticmethod
    def preempt_victim(running: List[Request]) -> Optional[Request]:
        """Youngest admission goes first: least sunk prefill work."""
        if not running:
            return None
        return max(running, key=lambda r: r.admit_seq)
