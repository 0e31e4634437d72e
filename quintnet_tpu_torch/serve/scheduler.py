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
# host-to-device KV promotion in flight (serve/kv_tier.py): the request
# stays at the head of the waiting queue, and next_admission holds it
# (and so everything behind it) until the engine's per-step feed has
# brought its host-tier chain back and set it WAITING again
PROMOTING = "promoting"
RUNNING = "running"
FINISHED = "finished"


class DeadlineExceeded(RuntimeError):
    """Typed mid-generation retirement: the request's deadline passed
    while it was admitted, so the engine stopped spending pool capacity
    on it — its blocks are published back to the prefix cache and
    ``result()`` raises this instead of returning a late answer
    (``generated`` counts the tokens it got). Distinct from the fleet's
    ``Overloaded('deadline')``, which sheds a request still QUEUED in
    the fleet at its deadline."""

    def __init__(self, message: str, *, rid: Optional[int] = None,
                 generated: int = 0):
        super().__init__(message)
        self.rid = rid
        self.generated = int(generated)


@dataclass
class RequestProgress:
    """Portable host-side resume payload for one unfinished request:
    the original prompt, the tokens generated so far and the request's
    sampling seed. Any engine built from the same (family, params and
    sampling settings) that re-prefills ``prompt + generated`` and keeps
    drawing at chain counter ``len(generated)`` of ``seed``
    (``models/gpt2_generate.sample_logits``) continues the stream
    exactly where it stopped, greedy or sampled — the fleet's migration
    contract (``fleet/``). The JAX payload carries the evolved key
    (``key_data``) instead: the port's chain has no evolving state, so
    ``(seed, len(generated))`` is the whole of it.

    ``generated`` holds COMMITTED tokens only: speculative drafts are
    verified or discarded inside one engine step, so a request exported
    mid-speculation resumes as if it had never speculated.
    ``adapter_id``: the request's LoRA adapter (``serve/adapters.py``),
    None for the base model. ``deadline_s``: the REMAINING deadline
    budget at export (None: none), re-anchored on the restoring
    engine's clock. ``prefilled``: the chunked-prefill high-water mark
    (positions whose K/V had landed), informational: the restoring
    engine re-prefills from its own pool. ``trace_id``: the request's
    observability identity (``obs/``), carried across preemption,
    export and migration; never read by scheduling or sampling.
    ``rid`` is the exporting engine's id."""

    rid: int
    prompt: np.ndarray
    generated: List[int]
    max_new_tokens: int
    priority: int = 0
    preemptions: int = 0
    seed: int = 0
    adapter_id: Optional[str] = None
    deadline_s: Optional[float] = None
    prefilled: int = 0
    trace_id: Optional[str] = None


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
    seed: int = 0                           # sampling chain (resume state
                                            # with len(generated))
    adapter_id: Optional[str] = None        # LoRA adapter (None: base)
    deadline: Optional[float] = None        # absolute ENGINE-clock time
    trace_id: Optional[str] = None          # obs identity (inert)

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
    # chunked-prefill high-water mark (serve/longctx.py): positions of
    # prompt + generated whose K/V is in the pool
    prefilled: int = 0
    # terminal error (DeadlineExceeded): the request is FINISHED but
    # result() raises this instead of returning output_ids()
    error: Optional[BaseException] = None

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

    def progress(self, *, now: Optional[float] = None) -> RequestProgress:
        """The resume payload. ``now`` (the exporting engine's clock)
        turns an absolute deadline into the remaining budget; without it
        a deadline is dropped (clock readings do not transfer)."""
        deadline_s = None
        if self.deadline is not None and now is not None:
            deadline_s = max(self.deadline - now, 0.0)
        return RequestProgress(
            rid=self.rid, prompt=np.array(self.prompt, copy=True),
            generated=list(self.generated),
            max_new_tokens=self.max_new_tokens, priority=self.priority,
            preemptions=self.preemptions, seed=self.seed,
            adapter_id=self.adapter_id, deadline_s=deadline_s,
            prefilled=self.prefilled, trace_id=self.trace_id)


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
        allocator. The request's adapter namespaces the lookup: the same
        tokens hold other K/V under another adapter."""
        return self.pool.plan_admission(req.output_ids(),
                                        req.total_len + 1,
                                        namespace=req.adapter_id)

    def next_admission(self, free_slots: int) -> Optional[Request]:
        """Pop the head waiting request if it is admissible, else None.
        Head-of-line blocking is intentional (strict FCFS/priority)."""
        if free_slots <= 0 or not self.waiting:
            return None
        if self.pool.num_available == 0:
            return None
        head = self.waiting[0]
        if head.state == PROMOTING:
            # its host-tier chain is on the way back: admitting it now
            # would re-prefill what the promotion is about to bring, and
            # admitting anything else would jump the queue
            return None
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
