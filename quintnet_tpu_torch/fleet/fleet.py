"""ServeFleet: N ServeEngine replicas behind one submit/stream API.

One continuous-batching engine (serve/engine.py) saturates at
``max_slots`` concurrent requests; the fleet multiplexes a request
stream over N replica engines on worker threads — the AlpaServe
observation that replicated capacity with statistical multiplexing,
not one bigger replica, is what holds tail latency under bursty
traffic. The pieces:

- **routing** (fleet/router.py): least-outstanding-work by token count
  (or round_robin), over replicas that are healthy, unpaused, and
  below their dispatch window — with a cheap adapter-affinity
  pre-filter for LoRA-bound requests (prefer replicas whose registry
  already holds the adapter resident, serve/adapters.py);
- **admission** (fleet/admission.py): a bounded fleet-wide queue;
  overload and expired deadlines shed with a typed
  :class:`~quintnet_tpu_torch.fleet.admission.Overloaded` instead of
  queueing forever;
- **health** (fleet/health.py): per-replica circuit breaker —
  consecutive-failure trip, timed half-open probe — deciding whether
  a dead replica is restarted (fresh engine from the factory);
- **migration** (fleet/replica.py + serve/engine.py): a replica that
  dies mid-flight exports every unfinished request's host-side
  progress (prompt, generated, sampling seed — the engine's own
  preemption-resume contract: ``(seed, len(generated))`` is the whole
  sampling state); the fleet re-queues it AT THE FRONT and a healthy
  replica resumes it via ``engine.restore_progress``, re-prefilling
  ``prompt + generated`` on its own pool, token-identical to an
  undisturbed run;
- **drain**: graceful shutdown — refuse new work, finish everything
  accepted, then stop the threads.

All replicas must be built from the SAME (family, params) — the
factory is called once per replica (and per restart); migration
correctness rests on that equivalence. On the card the factory closes
over one parameter tree: the replicas share the weights, each owns its
KV pool, and a dead replica's engine (its pool) is dropped before its
restart builds the next one.

Port of ``quintnet_tpu/fleet/fleet.py``. ``submit(key=)`` is
``submit(seed=)`` (default: the fid, the counterpart of
``fold_in(key(0), fid)``). ``lock_audit=True`` also folds the
engines' adapter registry lock into the audit's order graph, and
:meth:`ServeFleet.assert_compile_count` aggregates the engines'
recompile sentinels (``analysis/recompile.py``: in eager torch a
program is one signature of a program's per-step arguments, one
CUDA-graph capture).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from quintnet_tpu_torch.fleet.admission import AdmissionQueue, Overloaded
from quintnet_tpu_torch.fleet.health import (CLOSED, DEAD, HEALTHY,
                                       CircuitBreaker)
from quintnet_tpu_torch.fleet.replica import Replica
from quintnet_tpu_torch.fleet.router import Router
from quintnet_tpu_torch.fleet.router import eligible as router_eligible
from quintnet_tpu_torch.serve import metrics as serve_metrics
from quintnet_tpu_torch.analysis.lockrt import InstrumentedLock, LockAudit
from quintnet_tpu_torch.analysis.recompile import (RecompileError,
                                                   assert_compile_count)
from quintnet_tpu_torch.serve.engine import check_admissible
from quintnet_tpu_torch.serve.scheduler import DeadlineExceeded


class FleetRequest:
    """One request's fleet-side life: payload, result slot, marks."""

    def __init__(self, fid: int, prompt, max_new_tokens: int, *, seed,
                 priority: int, deadline: Optional[float], on_token,
                 submit_time: float, clock, adapter_id=None,
                 trace_id=None):
        self.fid = fid
        # observability identity (quintnet_tpu/obs/): one id per
        # request across the whole fleet — every engine that serves
        # (or resumes) it records spans under this id. Inert metadata.
        self.trace_id = trace_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.seed = seed                  # sampling chain (default fid)
        self.priority = priority
        self.deadline = deadline          # absolute fleet-clock time
        self.on_token = on_token
        self.submit_time = submit_time
        self.adapter_id = adapter_id      # LoRA binding (None = base)
        self._clock = clock

        self.progress = None              # RequestProgress after a death
        self.migrations = 0
        self.cost = 0                     # outstanding-token estimate
        self.replica_name: Optional[str] = None
        # disaggregated-fleet state (fleet/proc.py): what KIND of
        # dispatch this request last got ("prefill" = prefill-pool
        # prefill-only; "full" = run to completion), and — after a
        # successful KV handoff — which decode replica holds the
        # imported chain (a routing PREFERENCE: landing elsewhere
        # re-prefills locally, slower but identical)
        self.dispatched_phase: Optional[str] = None
        self.warm_replica: Optional[str] = None
        self.first_token_time: Optional[float] = None
        # dispatcher-clock timestamp of the LATEST token — the SLO
        # engine's inter-token-latency anchor (fleet/proc.py). Reset
        # to None across a handoff or migration: the cross-replica
        # gap is a TTFT-class cost charged to the handoff signals,
        # not a decode-cadence violation
        self.last_token_time: Optional[float] = None
        # the thread fleet's SLO feed (obs/slo.py): ServeFleet binds
        # its engine here at submit so :meth:`deliver` — which runs on
        # the replica worker, the thread fleet's client-visible
        # delivery point — observes TTFT/ITL. The process fleet leaves
        # it None and observes at ITS delivery point, the dispatcher
        # (fleet/proc.py _deliver_token): one observation per token
        # either way, taken where the client actually sees it
        self.slo = None
        self.finish_time: Optional[float] = None
        self.output: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        # the dispatcher-side WRITE-AHEAD token journal: every token a
        # replica streams is recorded here BEFORE the user callback
        # sees it. prompt + journal + seed reconstructs the request's
        # RequestProgress exactly (the process fleet's migration
        # source); the thread fleet's migration uses the engine's own
        # export.
        self.committed: List[int] = []
        self.last_seen = False            # a token arrived with is_last

    def deliver(self, token: int, last: bool) -> None:
        """Worker-thread token delivery (streaming surface). Journals
        first (write-ahead), then forwards. Tokens survive migration
        without duplication: a resumed request only emits tokens
        generated AFTER its checkpoint."""
        self.committed.append(int(token))
        if last:
            self.last_seen = True
        first = self.first_token_time is None
        if first:
            self.first_token_time = self._clock()
        if self.slo is not None:
            now = self._clock()
            if first:
                self.slo.observe("ttft", now - self.submit_time)
            elif self.last_token_time is not None:
                self.slo.observe("itl", now - self.last_token_time)
            self.last_token_time = now
        if self.on_token is not None:
            try:
                self.on_token(self.fid, token, last)
            except Exception:  # noqa: BLE001
                # a client callback failing (an SSE writer whose event
                # loop closed, a buggy consumer) must never propagate
                # into the replica worker and read as a replica death
                pass

    def remaining_deadline(self) -> Optional[float]:
        """Seconds of deadline budget left on the fleet clock (None =
        no deadline). The dispatcher re-anchors this on a replica
        engine's own clock at ingest — absolute readings do not
        transfer between clocks (or processes)."""
        if self.deadline is None:
            return None
        return self.deadline - self._clock()

    def outstanding_cost(self) -> int:
        """Tokens of work still owed: the (re-)prefill plus remaining
        decode steps — what least_work routing charges the replica.
        Identical for fresh and migrated requests: a migration
        re-prefills prompt+generated, so the generated tokens move
        from the decode column to the prefill column and the total is
        unchanged."""
        return len(self.prompt) + self.max_new_tokens


@dataclass
class FleetMetrics:
    """Fleet-front-door counters + latency marks (fleet clock: queue
    wait INCLUDED, unlike the per-engine ServeMetrics TTFT)."""

    submitted: int = 0                  # all attempts, incl. rejected
    accepted: int = 0
    finished: int = 0
    shed_queue_full: int = 0
    shed_deadline: int = 0
    shed_shutdown: int = 0
    # disaggregated fleets only: decode pool hard-down (no live
    # member, every breaker tripped) — new work shed typed instead of
    # queueing behind a breaker that cannot act (fleet/proc.py)
    shed_pool_down: int = 0
    # admitted requests retired MID-GENERATION at their deadline
    # (typed serve.DeadlineExceeded) — disjoint from shed_deadline,
    # which counts requests still QUEUED at expiry
    deadline_exceeded: int = 0
    migrations: int = 0
    replica_deaths: int = 0
    stalls: int = 0                     # missed-heartbeat detections
    restarts: int = 0
    # disaggregated prefill→decode handoffs (fleet/proc.py):
    # ``handoffs`` counts prefill-phase completions that moved to the
    # decode pool; ``handoff_transfers`` the KV chains that actually
    # landed (wire frame imported, checksum good); ``handoff_retries``
    # every retried transfer attempt; ``handoff_fallbacks`` transfers
    # that exhausted retries and fell back to local re-prefill on the
    # decode side (slower, token-identical — the chain is just cache)
    handoffs: int = 0
    handoff_transfers: int = 0
    handoff_retries: int = 0
    handoff_fallbacks: int = 0
    # tiered-KV peer lookup (serve/kv_tier.py, fleet/proc.py):
    # ``tier_probes`` counts dispatches that ran the kv_peek fan-out;
    # ``tier_peer_transfers`` chains actually shipped peer->target
    # before dispatch; ``tier_peer_fallbacks`` probes where a better
    # peer existed but the transfer degraded (export/import failed) —
    # dispatch proceeded without warm peer KV, token-identical
    tier_probes: int = 0
    tier_peer_transfers: int = 0
    tier_peer_fallbacks: int = 0
    # admission-queue pressure gauges, refreshed through the probe the
    # owning fleet attaches (the metrics object cannot see the queue):
    # depth says how much is waiting, oldest-wait age how badly —
    # summary() carries both so /metrics and the signal bus read one
    # ledger, not two
    queue_depth: int = 0
    queue_oldest_wait_s: float = 0.0
    _queue_probe: Optional[Callable] = None
    # percentile sources, reservoir-bounded like the engine's
    # (serve/metrics.Reservoir): exact below the cap, uniform sampling
    # above — a long-lived front door stops leaking one float per
    # request; summary() surfaces the true count as "n"
    ttfts: "serve_metrics.Reservoir" = field(
        default_factory=serve_metrics.Reservoir)
    latencies: "serve_metrics.Reservoir" = field(
        default_factory=serve_metrics.Reservoir)

    @property
    def shed(self) -> int:
        return (self.shed_queue_full + self.shed_deadline
                + self.shed_shutdown + self.shed_pool_down)

    @property
    def shed_rate(self) -> float:
        return self.shed / max(self.submitted, 1)

    def summary(self) -> Dict:
        if self._queue_probe is not None:
            depth, age = self._queue_probe()
            self.queue_depth = int(depth)
            self.queue_oldest_wait_s = float(age)
        return {
            "submitted": self.submitted,
            "accepted": self.accepted,
            "finished": self.finished,
            "queue_depth": self.queue_depth,
            "queue_oldest_wait_s": round(self.queue_oldest_wait_s, 4),
            "shed": self.shed,
            "shed_queue_full": self.shed_queue_full,
            "shed_deadline": self.shed_deadline,
            "shed_shutdown": self.shed_shutdown,
            "shed_pool_down": self.shed_pool_down,
            "shed_rate": round(self.shed_rate, 4),
            "deadline_exceeded": self.deadline_exceeded,
            "migrations": self.migrations,
            "replica_deaths": self.replica_deaths,
            "stalls": self.stalls,
            "restarts": self.restarts,
            "handoffs": self.handoffs,
            "handoff_transfers": self.handoff_transfers,
            "handoff_retries": self.handoff_retries,
            "handoff_fallbacks": self.handoff_fallbacks,
            "tier_probes": self.tier_probes,
            "tier_peer_transfers": self.tier_peer_transfers,
            "tier_peer_fallbacks": self.tier_peer_fallbacks,
            "ttft_s": serve_metrics._pcts(self.ttfts),
            "latency_s": serve_metrics._pcts(self.latencies),
        }


class ServeFleet:
    """Multi-replica serving front-end (see module docstring).

    ``engine_factory``: zero-arg callable returning a fresh
    :class:`~quintnet_tpu_torch.serve.engine.ServeEngine`; called once per
    replica and once per breaker-approved restart. ``chaos``: one
    ``ft.ChaosMonkey`` (mode='raise') or a sequence; each is armed
    against the replica named by its ``target`` (default: replica 0).
    ``lock_audit=True``: every lock the fleet mints is an instrumented
    one sharing one order graph (``analysis/lockrt.py``,
    :attr:`lock_audit`).
    """

    def __init__(self, engine_factory: Callable, *, n_replicas: int = 2,
                 policy: str = "least_work", max_pending: int = 64,
                 max_dispatch: Optional[int] = None,
                 trip_after: int = 3, breaker_reset_s: float = 30.0,
                 chaos=None, clock: Callable[[], float] = time.monotonic,
                 name_prefix: str = "r", poll_s: float = 0.02,
                 obs: bool = False, crash_dir: Optional[str] = None,
                 ring_capacity: int = 512, slo=None,
                 lock_audit: bool = False):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self._factory = engine_factory
        self.clock = clock
        self.metrics = FleetMetrics()
        # lock-discipline runtime (analysis/lockrt.py): lock_audit=True
        # swaps every lock this fleet mints for an InstrumentedLock
        # sharing ONE order graph + ledger registry, so an A->B/B->A
        # inversion anywhere in the fleet raises a typed LockOrderError
        # instead of deadlocking, and GET /metrics grows the
        # quintnet_lock_* families. Off (the default) the locks are the
        # stock threading primitives.
        self.lock_audit = None
        if lock_audit:
            self.lock_audit = LockAudit(
                clock=clock,
                on_violation=lambda info: self._emit(
                    "lock_order_violation", **info))
        # observability (quintnet_tpu/obs/): ``obs=True`` arms ONE
        # fleet-wide Tracer (engines share the address space, so every
        # replica engine records into it directly — one merged
        # timeline per trace id), a per-engine StepRecorder ring, and
        # the typed EventLog. On a replica death the affected ring +
        # spans become an in-memory post-mortem (``last_crash``) and,
        # with ``crash_dir`` set, a crash-dump file. All of it is
        # inert: tracing on is token-bit-identical to tracing off.
        # The SLO engine + signal bus (obs/slo.py, obs/signals.py)
        # read the engine step rings, so ``slo=`` implies ``obs=True``.
        self._obs = bool(obs) or slo is not None
        self.crash_dir = crash_dir
        self._ring_capacity = int(ring_capacity)
        self.tracer = None
        self.events = None
        self.slo = None            # obs.SLOEngine once armed
        self.signals = None        # obs.SignalBus once armed
        self.planner = None        # always None here: rebalancing
        #   moves replicas BETWEEN pools and the thread fleet has none
        #   (ProcessFleet(pools=...) is the planner's home)
        self._signal_next_t = 0.0
        if self._obs:
            from quintnet_tpu_torch.obs import EventLog, Tracer

            self.tracer = Tracer(clock=clock,
                                 lock=self._audit_lock("obs.tracer"))
            self.events = EventLog(clock=clock,
                                   lock=self._audit_lock("obs.events"))
        self.crash_dumps: List[str] = []     # paths written (crash_dir)
        self.last_crash: Optional[Dict] = None
        self._pending_dumps: List[Dict] = []  # snapshotted under the
        #   lock at death; WRITTEN by the dispatcher outside it — a
        #   disk write must never stall token delivery
        self._breaker_seen: Dict[str, str] = {}
        self._router = Router(policy)
        # threading.Condition()'s default lock IS an RLock: the audited
        # swap keeps reentrancy (audit.condition)
        self._cv = (self.lock_audit.condition("fleet._cv")
                    if self.lock_audit is not None
                    else threading.Condition())
        self._queue = AdmissionQueue(max_pending, clock=clock)
        self.metrics._queue_probe = self._queue_gauges
        if slo is not None:
            self.arm_slo(slo)
        self._requests: Dict[int, FleetRequest] = {}
        self._fid_counter = 0
        self._open = 0                 # accepted, not yet finished/shed
        self._draining = False
        self._closed = False
        self._max_dispatch = max_dispatch
        self._poll_s = poll_s
        self._retired_metrics: List = []   # ServeMetrics of dead engines

        monkeys = [] if chaos is None else (
            list(chaos) if isinstance(chaos, (list, tuple)) else [chaos])
        names = [f"{name_prefix}{i}" for i in range(n_replicas)]
        by_target = {}
        for m in monkeys:
            by_target[m.target if m.target is not None else names[0]] = m
        unknown = set(by_target) - set(names)
        if unknown:
            raise ValueError(
                f"chaos target(s) {sorted(unknown)} name no replica "
                f"(have {names})")

        self._breakers = {
            name: CircuitBreaker(trip_after=trip_after,
                                 reset_s=breaker_reset_s, clock=clock)
            for name in names}
        self._replicas = [self._spawn(name, by_target.get(name))
                          for name in names]
        # the submit-time checks read replica 0's limits and registry
        # (all engines share one config), kept here: a dead replica's
        # engine is dropped at its restart
        self._limits = self._replicas[0].engine.limits()
        self._adapters0 = getattr(self._replicas[0].engine, "adapters",
                                  None)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="fleet-dispatch", daemon=True)
        self._dispatcher.start()

    def _audit_lock(self, name: str):
        """An instrumented Lock under ``lock_audit=True``, else None
        (the primitive constructors fall back to a stock Lock — the off
        path constructs exactly what it always did)."""
        return (self.lock_audit.lock(name)
                if self.lock_audit is not None else None)

    def _spawn(self, name: str, chaos) -> Replica:
        rep = Replica(name, self._factory, chaos=chaos,
                      max_dispatch=self._max_dispatch,
                      on_finish=self._on_finish, on_death=self._on_death,
                      on_reject=self._on_reject, poll_s=self._poll_s)
        reg = getattr(rep.engine, "adapters", None)
        if (self.lock_audit is not None and reg is not None
                and not isinstance(reg._lock, InstrumentedLock)):
            # the engines' adapter registry joins the order graph before
            # any request can reach it (a registry the factory shares
            # across replicas is swapped once, at the first spawn)
            reg._lock = self.lock_audit.rlock("serve.adapters")
        if self._obs:
            from quintnet_tpu_torch.obs import StepRecorder

            # shared tracer (one address space, one merged timeline);
            # per-engine flight-recorder ring (the replica's black box)
            rep.engine.tracer = self.tracer
            rep.engine.recorder = StepRecorder(
                capacity=self._ring_capacity, clock=rep.engine.clock,
                lock=self._audit_lock(f"recorder.{name}"))
        return rep

    def _emit(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(kind, **fields)

    def _note_breaker(self, name: str) -> None:
        """Emit a typed event when a breaker's state CHANGED since the
        fleet last looked — transitions are driven from several sites
        (failure, success, restart gating), so the edge detection
        lives here instead of inside the breaker."""
        if self.events is None:
            return
        st = self._breakers[name].state
        if self._breaker_seen.get(name, "closed") != st:
            self._breaker_seen[name] = st
            self.events.emit("breaker", replica=name, state=st)

    # ------------------------------------------------------------------
    # submission / results
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, seed=None,
               priority: int = 0, deadline_s: Optional[float] = None,
               on_token=None, adapter_id: Optional[str] = None) -> int:
        """Queue one request fleet-wide; returns its fleet id. Raises
        :class:`Overloaded` instead of queueing when the fleet is over
        capacity (``queue_full``), the deadline is unmeetable
        (``deadline``), or the fleet is draining (``shutdown``).

        ``seed`` (the request's sampling chain) defaults to the fid —
        fleet-level, so a request's sampled output does not depend on
        which replica serves it: it is the port's ``gpt2_generate`` of
        the prompt at that seed. ``deadline_s`` is a whole-request
        budget from now, enforced end to end: a request still queued when
        it expires is shed (``Overloaded('deadline')``), and one already
        DECODING at expiry is retired by its engine with a typed
        ``serve.DeadlineExceeded`` (blocks published) instead of
        finishing a stream the client stopped waiting for.
        ``on_token(fid, token, is_last)`` fires from a replica worker
        thread as tokens are produced, across migrations, each token
        exactly once. ``adapter_id``: serve through the named LoRA
        adapter (serve/adapters.py) — the router prefers replicas
        where the adapter is already resident; the binding survives
        migration (a cold replica loads it on demand)."""
        # requests the fleet could NEVER run fail fast here, like
        # engine.submit would — dispatched, they would bounce off every
        # replica's validation instead (all engines share one config,
        # so replica 0's limits speak for the fleet)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        check_admissible(prompt.size, int(max_new_tokens), **self._limits)
        if adapter_id is not None:
            # registration check only — deliberately NOT
            # validate_adapter, which would LOAD the weights into
            # replica 0's registry as a side effect (skewing the
            # router's affinity toward r0 and churning its LRU for
            # requests that route elsewhere). Shape problems surface
            # at the serving replica's ingest, which errors that
            # request alone (_on_reject), never the replica.
            reg = self._adapters0
            if reg is None:
                raise ValueError(
                    "this fleet's engines were built without adapters; "
                    "cannot serve adapter_id requests")
            reg.entry(adapter_id)      # KeyError for unknown ids
        with self._cv:
            self.metrics.submitted += 1
            if self._draining or self._closed:
                self.metrics.shed_shutdown += 1
                self._slo_observe("shed", 1.0)
                raise Overloaded(
                    "shutdown", "fleet is draining; not accepting work")
            now = self.clock()
            if deadline_s is not None and deadline_s <= 0:
                self.metrics.shed_deadline += 1
                self._slo_observe("shed", 1.0)
                raise Overloaded(
                    "deadline", f"deadline_s={deadline_s} already expired "
                    f"at submit")
            fid = self._fid_counter
            self._fid_counter += 1
            freq = FleetRequest(
                fid, prompt, int(max_new_tokens),
                seed=fid if seed is None else int(seed),
                priority=int(priority),
                deadline=(None if deadline_s is None
                          else now + float(deadline_s)),
                on_token=on_token, submit_time=now, clock=self.clock,
                adapter_id=adapter_id, trace_id=f"f{fid}")
            freq.slo = self.slo    # TTFT/ITL observed at delivery
            #   (FleetRequest.deliver — the thread fleet's client-
            #   visible point; None when the engine is not armed)
            if self.tracer is not None:
                self.tracer.event(freq.trace_id, "fleet_submit",
                                  fid=fid, prompt_len=int(prompt.size),
                                  max_new_tokens=int(max_new_tokens),
                                  adapter_id=adapter_id)
            try:
                self._queue.push(freq)
            except Overloaded:
                self.metrics.shed_queue_full += 1
                self._slo_observe("shed", 1.0)
                raise
            self._requests[fid] = freq
            self._open += 1
            self.metrics.accepted += 1
            self._slo_observe("shed", 0.0)
            self._cv.notify_all()
            return fid

    def result(self, fid: int, *, timeout: Optional[float] = None
               ) -> np.ndarray:
        """Block until the request finishes; returns prompt+generated.
        Raises the request's typed error if it was shed."""
        freq = self._requests[fid]
        if not freq.event.wait(timeout):
            raise TimeoutError(
                f"fleet request {fid} unfinished after {timeout}s "
                f"(replica={freq.replica_name}, "
                f"migrations={freq.migrations})")
        if freq.error is not None:
            raise freq.error
        return freq.output

    def request(self, fid: int) -> FleetRequest:
        return self._requests[fid]

    def generate(self, prompts: Sequence, *, max_new_tokens, seeds=None,
                 priorities=None, timeout: Optional[float] = None
                 ) -> List[np.ndarray]:
        """Blocking batch surface over the whole fleet (the analogue of
        serve.api.generate). Sheds propagate as Overloaded."""
        n = len(prompts)
        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * n
        seeds = [None] * n if seeds is None else seeds
        priorities = [0] * n if priorities is None else priorities
        if not (len(max_new_tokens) == len(seeds) == len(priorities) == n):
            raise ValueError(
                "per-prompt argument lengths must match prompts")
        fids = [self.submit(p, m, seed=sd, priority=pr)
                for p, m, sd, pr in zip(prompts, max_new_tokens, seeds,
                                        priorities)]
        return [self.result(f, timeout=timeout) for f in fids]

    # ------------------------------------------------------------------
    # worker callbacks (replica threads)
    # ------------------------------------------------------------------
    def _on_finish(self, rep: Replica, freq: FleetRequest,
                   output: np.ndarray) -> None:
        with self._cv:
            rep.in_flight -= 1
            rep.outstanding_tokens -= freq.cost
            self._breakers[rep.name].record_success()
            self._note_breaker(rep.name)
            freq.output = output
            freq.finish_time = self.clock()
            self.metrics.finished += 1
            self._slo_observe("error", 0.0)
            if freq.first_token_time is not None:
                self.metrics.ttfts.append(
                    freq.first_token_time - freq.submit_time)
            self.metrics.latencies.append(
                freq.finish_time - freq.submit_time)
            self._open -= 1
            freq.event.set()
            self._cv.notify_all()

    def _on_reject(self, rep: Replica, freq: FleetRequest,
                   error: BaseException) -> None:
        """A request the engine refused at ingest (ValueError from its
        submit/restore validation) or retired with a typed terminal
        error (DeadlineExceeded mid-decode, Overloaded('deadline') at
        ingest): error that request's waiter; the replica stays
        healthy."""
        with self._cv:
            rep.in_flight -= 1
            rep.outstanding_tokens -= freq.cost
            if isinstance(error, DeadlineExceeded):
                self.metrics.deadline_exceeded += 1
                self._emit("deadline_exceeded", fid=freq.fid,
                           trace_id=freq.trace_id, replica=rep.name,
                           generated=error.generated)
            elif (isinstance(error, Overloaded)
                    and error.reason == "deadline"):
                self.metrics.shed_deadline += 1
            freq.error = error
            self._slo_observe("error", 1.0)
            self._open -= 1
            freq.event.set()
            self._cv.notify_all()

    def _on_death(self, rep: Replica, error: BaseException,
                  exports: List) -> None:
        with self._cv:
            self.metrics.replica_deaths += 1
            self._breakers[rep.name].record_failure()
            self._note_breaker(rep.name)
            self._retired_metrics.append(rep.engine.metrics)
            rep.in_flight = 0
            rep.outstanding_tokens = 0
            # the worker exported without the fleet lock; a dispatch
            # racing the death can have landed one more inbox item
            # since — re-drain under the lock enqueues are made under
            exports = list(exports) + rep.drain_inbox()
            self._emit("replica_death", replica=rep.name,
                       error=f"{type(error).__name__}: {error}",
                       in_flight=len(exports))
            self._record_crash(rep, reason="death", error=error,
                               affected=[f for f, _p in exports])
            migrated = []
            for freq, prog in sorted(exports, key=lambda e: e[0].fid):
                if prog is not None:
                    freq.progress = prog
                if self._closed:
                    # the dispatcher is gone; nothing can resume this
                    self._shed_locked(freq, "shutdown",
                                      "replica died during close")
                    continue
                freq.migrations += 1
                freq.last_token_time = None   # ITL re-anchors on the
                #   survivor: the migration gap is a fault cost, not a
                #   decode-cadence reading (see fleet/proc.py)
                self.metrics.migrations += 1
                self._emit("migration", fid=freq.fid,
                           trace_id=freq.trace_id,
                           from_replica=rep.name,
                           committed=len(freq.committed))
                if self.tracer is not None:
                    self.tracer.event(freq.trace_id, "migration",
                                      from_replica=rep.name,
                                      committed=len(freq.committed))
                migrated.append(freq)
            self._queue.push_front(migrated)
            self._cv.notify_all()

    def _record_crash(self, rep, *, reason: str, error, affected) -> None:
        """The black box, thread-fleet flavor: the dead engine's ring
        and the affected requests' spans survive in THIS address
        space — freeze them into ``last_crash`` before migration
        rewrites anything. With ``crash_dir`` set the payload is
        QUEUED here (lock held) and written by the dispatcher OUTSIDE
        the lock (:meth:`_write_dumps`): file IO must never stall
        token delivery."""
        if not self._obs:
            return
        recorder = getattr(rep.engine, "recorder", None)
        ring = recorder.snapshot() if recorder is not None else []
        tids = [f.trace_id for f in affected if f.trace_id]
        traces = (self.tracer.snapshot(tids)
                  if self.tracer is not None else {})
        requests = [{"fid": f.fid, "trace_id": f.trace_id,
                     "committed": len(f.committed),
                     "migrations": f.migrations,
                     "adapter_id": f.adapter_id} for f in affected]
        self.last_crash = {
            "replica": rep.name, "reason": reason,
            "error": f"{type(error).__name__}: {error}",
            "ring": ring, "traces": traces, "requests": requests,
            # last pool-pressure snapshot (obs/signals.py), when the
            # signal plane is armed — same black-box field the process
            # fleet freezes (fleet/proc.py)
            "signals": (self.signals.snapshot()
                        if self.signals is not None else {}),
            # the lock-audit ledgers ride the black box under
            # lock_audit=True: "who held what, for how long" at death
            "locks": (self.lock_audit.summary()
                      if self.lock_audit is not None else {}),
        }
        if self.crash_dir is not None:
            self._pending_dumps.append(dict(
                self.last_crash,
                events=(self.events.snapshot(last=64)
                        if self.events is not None else [])))

    def _write_dumps(self, pending: List[Dict]) -> None:
        """Write queued crash dumps (called WITHOUT the fleet lock)."""
        from quintnet_tpu_torch.obs import write_crash_dump

        for spec in pending:
            path = write_crash_dump(self.crash_dir, **spec)
            self.crash_dumps.append(path)
            # the writer keeps only the newest N files — drop ledger
            # entries whose file was pruned so every path here loads
            self.crash_dumps = [p for p in self.crash_dumps
                                if os.path.exists(p)]
            self._emit("crash_dump", replica=spec["replica"],
                       path=path)

    # ------------------------------------------------------------------
    # dispatcher
    # ------------------------------------------------------------------
    def _shed_locked(self, freq: FleetRequest, reason: str,
                     message: str) -> None:
        if reason == "deadline":
            self.metrics.shed_deadline += 1
        else:
            self.metrics.shed_shutdown += 1
        self._slo_observe("shed", 1.0)
        self._emit("shed", fid=freq.fid, trace_id=freq.trace_id,
                   reason=reason)
        freq.error = Overloaded(reason, message)
        self._open -= 1
        freq.event.set()
        self._cv.notify_all()

    def _tend_replicas_locked(self) -> None:
        for i, rep in enumerate(self._replicas):
            if rep.state != DEAD:
                continue
            allowed = self._breakers[rep.name].allow_restart()
            self._note_breaker(rep.name)
            if not allowed:
                continue
            chaos = rep.chaos
            if chaos is not None and getattr(chaos, "rearm", False):
                chaos.rearm_now()
            # the dead engine (its KV pool) goes before the factory
            # builds the next one: its metrics were kept at death
            rep.engine = None
            self._replicas[i] = self._spawn(rep.name, chaos)
            self.metrics.restarts += 1
            self._emit("replica_restart", replica=rep.name)

    def _dispatch_locked(self) -> None:
        for freq in self._queue.shed_expired():
            self._shed_locked(
                freq, "deadline",
                f"request {freq.fid} still queued at its deadline; shed "
                f"instead of serving a result the client stopped "
                f"waiting for")
        while len(self._queue):
            cands = router_eligible(self._replicas)
            if not cands:
                return
            # adapter affinity: peek the queue head's binding so the
            # router can prefer adapter-warm replicas (fleet/router.py)
            rep = self._router.pick(
                cands, adapter_id=self._queue.peek_adapter_id())
            freq = self._queue.pop()
            freq.cost = freq.outstanding_cost()
            freq.replica_name = rep.name
            rep.in_flight += 1
            rep.outstanding_tokens += freq.cost
            if self.tracer is not None:
                self.tracer.add(freq.trace_id, "fleet_queue",
                                t0=freq.submit_time, t1=self.clock(),
                                migrations=freq.migrations)
                self.tracer.event(freq.trace_id, "dispatch",
                                  replica=rep.name)
            rep.enqueue(freq, freq.progress)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                self._tend_replicas_locked()
                self._tend_signals_locked(self.clock())
                self._dispatch_locked()
                pending, self._pending_dumps = self._pending_dumps, []
                if not pending:
                    self._cv.wait(self._poll_s)
            if pending:
                self._write_dumps(pending)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def pause_all(self) -> None:
        for rep in self._replicas:
            rep.pause()

    def resume_all(self) -> None:
        for rep in self._replicas:
            rep.resume()
        with self._cv:
            self._cv.notify_all()

    def arm_chaos(self, monkey) -> None:
        """Attach a (mode='raise') ChaosMonkey to the replica named by
        its ``target`` (default: replica 0) on a RUNNING fleet — the
        bench arms faults after warmup so kill_at_step counts replay
        steps only."""
        name = monkey.target
        with self._cv:
            reps = {r.name: r for r in self._replicas}
            if name is not None and name not in reps:
                raise ValueError(f"no replica named {name!r}")
            rep = self._replicas[0] if name is None else reps[name]
            rep.chaos = monkey

    def drain(self, *, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: refuse new submissions, let everything
        already accepted run to completion (migrations included), then
        stop the worker threads. Raises TimeoutError (fleet left
        draining but alive) if the backlog does not clear in time."""
        deadline = None if timeout is None else self.clock() + timeout
        with self._cv:
            self._draining = True
            self._emit("drain", open_requests=self._open)
            self._cv.notify_all()
            while self._open > 0:
                if deadline is not None and self.clock() >= deadline:
                    raise TimeoutError(
                        f"drain: {self._open} request(s) still open "
                        f"after {timeout}s")
                self._cv.wait(self._poll_s)
        self.close()

    def close(self) -> None:
        """Hard stop: shed everything pending, stop all threads, error
        any request still in flight (``Overloaded('shutdown')``). Use
        :meth:`drain` for the graceful path."""
        with self._cv:
            if self._closed:
                return
            self._draining = True
            self._closed = True
            self._emit("close", open_requests=self._open)
            for freq in self._queue.drain_all():
                self._shed_locked(freq, "shutdown",
                                  "fleet closed before dispatch")
            self._cv.notify_all()
        self._dispatcher.join(timeout=10.0)
        for rep in self._replicas:
            rep.stop()
        with self._cv:
            for rep in self._replicas:
                for freq in rep.unfinished():
                    if not freq.event.is_set():
                        self._shed_locked(
                            freq, "shutdown",
                            "fleet closed with the request in flight")
            pending, self._pending_dumps = self._pending_dumps, []
        self._write_dumps(pending)   # dumps a closing race queued
        if self.lock_audit is not None:
            self.lock_audit.close()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def replicas(self) -> List[Replica]:
        return list(self._replicas)

    def breaker(self, name: str) -> CircuitBreaker:
        return self._breakers[name]

    def health(self) -> Dict:
        """Cheap liveness snapshot (no engine access beyond counters) —
        what the HTTP front door's /healthz serves
        (fleet/frontdoor.py); shape-compatible with
        :meth:`ProcessFleet.health`."""
        with self._cv:
            return {
                "replicas": {r.name: {"state": r.state,
                                      "steps": r.steps,
                                      "in_flight": r.in_flight,
                                      "breaker": self._breakers[r.name].state}
                             for r in self._replicas},
                "queue_depth": len(self._queue),
                "queue_oldest_wait_s": round(
                    self._queue.oldest_wait_s(), 4),
                "open_requests": self._open,
                "draining": self._draining,
            }

    def _queue_gauges(self):
        """(depth, oldest wait age) for FleetMetrics' probe — and the
        front door's Retry-After hint. Reads snapshot copies, so it is
        safe from any thread without the fleet lock."""
        return len(self._queue), self._queue.oldest_wait_s()

    # ------------------------------------------------------------------
    # SLO engine + signal plane (obs/slo.py, obs/signals.py)
    # ------------------------------------------------------------------
    def arm_slo(self, config) -> None:
        """Arm the SLO engine + signal bus against this fleet's
        dispatcher (``config``: :class:`~quintnet_tpu_torch.obs.slo.
        SLOConfig`). TTFT/ITL observe at token delivery, shed/error
        rates at submit/finish, and the dispatcher samples queue/
        occupancy/KV pressure each ``eval_interval_s``. No rebalance
        planner here — the thread fleet has no pools to move replicas
        between (see :meth:`ProcessFleet.arm_slo`). Requires the
        flight recorder (``slo=`` at the constructor implies it) for
        the step rings the occupancy signals read."""
        from quintnet_tpu_torch.obs import EventLog
        from quintnet_tpu_torch.obs.signals import SignalBus
        from quintnet_tpu_torch.obs.slo import SLOEngine
        if not self._obs:
            # silently arming would sample permanently-zero occupancy
            # and KV pressure (the rings are only recorded when the
            # flight recorder is on) — judgment over dead gauges
            raise ValueError(
                "arm_slo requires a fleet built with obs=True (or "
                "slo= at the constructor): the occupancy/KV signals "
                "read the per-replica step rings")
        with self._cv:
            if self.events is None:
                self.events = EventLog(
                    clock=self.clock,
                    lock=self._audit_lock("obs.events"))
            self.slo = SLOEngine(config, clock=self.clock,
                                 events=self.events)
            self.signals = SignalBus(
                clock=self.clock,
                lock=self._audit_lock("obs.signals"))
            self._signal_next_t = 0.0

    def _slo_observe(self, stream: str, value: float) -> None:
        if self.slo is not None:
            self.slo.observe(stream, value)

    def _tend_signals_locked(self, now: float) -> None:
        """One signal-plane tick on the dispatcher thread: sample
        pressure gauges from state already in this address space (the
        admission queue, each engine's step ring, the breakers), then
        re-evaluate the SLO engine. Host-side floats only; no device
        sync, no mutation — inert by construction."""
        if self.slo is None:
            return
        if now < self._signal_next_t:
            return
        self._signal_next_t = now + self.slo.config.eval_interval_s
        bus = self.signals
        bus.sample("queue_depth", float(len(self._queue)))
        bus.sample("queue_oldest_wait_s", self._queue.oldest_wait_s())
        running = slots = kv_used = kv_total = 0
        open_breakers = 0
        for rep in self._replicas:
            if self._breakers[rep.name].state != CLOSED:
                open_breakers += 1
            if rep.state != HEALTHY:
                # a dead worker's recorder still holds its last step
                # record — stale occupancy/KV, not live pressure
                continue
            eng = rep.engine
            slots += int(getattr(eng, "max_slots", 0) or 0)
            recorder = getattr(eng, "recorder", None)
            last = recorder.last() if recorder is not None else None
            if last is None:
                continue
            running += int(last.get("running", 0))
            kv_used += int(last.get("kv_blocks_used", 0))
            kv_total += int(last.get("kv_blocks_total", 0))
        bus.sample("occupancy", running / slots if slots else 0.0)
        bus.sample("kv_pressure",
                   kv_used / kv_total if kv_total else 0.0)
        bus.sample("breakers_open", float(open_breakers))
        self.slo.evaluate(now)

    def queue_oldest_wait_s(self) -> float:
        """Wait age of the oldest queued request (0.0 when empty)."""
        return self._queue.oldest_wait_s()

    def reset_metrics(self) -> None:
        """Fresh ledgers fleet-wide (bench warmup boundary): fleet
        counters, every live engine's ServeMetrics, retired-engine
        stash, and each replica's step counter — so a ChaosMonkey armed
        after warmup (:meth:`arm_chaos`) counts REPLAY steps only."""
        with self._cv:
            self.metrics = FleetMetrics()
            self.metrics._queue_probe = self._queue_gauges
            self._retired_metrics = []
            for rep in self._replicas:
                rep.steps = 0
                rep.engine.metrics = type(rep.engine.metrics)(
                    clock=rep.engine.clock)

    def engine_summaries(self) -> Dict[str, Dict]:
        """Per-replica ``ServeMetrics.summary()`` dicts (the front
        door's /metrics and /v1/metrics surface — shape-compatible
        with :meth:`ProcessFleet.engine_summaries`)."""
        with self._cv:
            return {rep.name: rep.engine.metrics.summary()
                    for rep in self._replicas}

    def engine_summary(self) -> Dict:
        """serve.metrics.aggregate over every engine that served this
        fleet — live replicas plus engines retired by a death."""
        with self._cv:
            ms = ([rep.engine.metrics for rep in self._replicas]
                  + list(self._retired_metrics))
        return serve_metrics.aggregate(ms)

    def summary(self) -> Dict:
        """One JSON-able dict: fleet front-door metrics + aggregated
        engine metrics + per-replica state."""
        with self._cv:
            per_replica = {
                rep.name: {
                    "state": rep.state,
                    "steps": rep.steps,
                    "in_flight": rep.in_flight,
                    "outstanding_tokens": rep.outstanding_tokens,
                    "breaker": self._breakers[rep.name].state,
                    "compile_stats": rep.engine.compile_stats(),
                } for rep in self._replicas}
        out = self.metrics.summary()
        out["policy"] = self._router.policy
        out["replicas"] = per_replica
        out["engine"] = self.engine_summary()
        if self.slo is not None:
            out["slo"] = self.slo.status()
        return out

    def assert_compile_count(self, prefill: Optional[int] = None,
                             decode: int = 1, *,
                             include_idle: bool = False) -> None:
        """The fleet-wide bounded-program promise: every replica engine
        that served at least one request must have run EXACTLY
        ``decode`` decode programs, at least one prefill program, no
        more than one per bucket, and no more than ``prefill`` in total
        (default: that replica's own bucket count). An UPPER bound, not
        an exact total: the router sends different tail-length mixes to
        different replicas, so replicas run different bucket subsets.
        The decode sentinels go through ``analysis.recompile.
        assert_compile_count`` for its signature-diffing error. Engines
        that never admitted work are skipped unless ``include_idle``.
        Spec-enabled engines also carry ``verify[<k>]`` sentinels (at
        most one program per draft-length bucket), adapter-enabled ones
        ``decode[r<rank>]`` sentinels instead of one ``decode`` (at most
        one per rank bucket)."""
        expected: Dict[str, int] = {}
        sentinels: Dict = {}
        for rep in self._replicas:
            if not include_idle and rep.engine.metrics.admitted == 0:
                continue
            rep_sentinels = rep.engine.compile_sentinels()
            has_verify = any(k.startswith("verify[")
                             for k in rep_sentinels)
            if "decode" not in rep_sentinels:
                # adapter-enabled engine: rank-bucketed decode — at most
                # one program per bucket, any total up to the bucket
                # count (which buckets fire is traffic-shaped)
                per_decode = {kind: s.compile_count
                              for kind, s in rep_sentinels.items()
                              if kind.startswith("decode[")}
                if any(n > 1 for n in per_decode.values()):
                    raise RecompileError(
                        f"replica {rep.name}: expected at most one "
                        f"compiled decode program per LoRA rank "
                        f"bucket, observed {per_decode}")
            else:
                key = f"{rep.name}_decode"
                # a spec-enabled replica whose every step speculated may
                # never run the plain decode program: 0 or `decode`
                # programs both keep the bound
                if not (has_verify
                        and rep_sentinels["decode"].compile_count == 0):
                    expected[key] = decode
                    sentinels[key] = rep_sentinels["decode"]
            per_bucket = {kind: s.compile_count
                          for kind, s in rep_sentinels.items()
                          if kind.startswith("prefill[")}
            total = sum(per_bucket.values())
            cap = prefill if prefill is not None else len(per_bucket)
            if not 1 <= total <= cap or any(n > 1
                                            for n in per_bucket.values()):
                raise RecompileError(
                    f"replica {rep.name}: expected 1..{cap} compiled "
                    f"prefill bucket program(s) (at most one per "
                    f"bucket), observed {total} ({per_bucket})")
            per_verify = {kind: s.compile_count
                          for kind, s in rep_sentinels.items()
                          if kind.startswith("verify[")}
            if any(n > 1 for n in per_verify.values()):
                raise RecompileError(
                    f"replica {rep.name}: expected at most one compiled "
                    f"verify program per draft-length bucket, observed "
                    f"{per_verify}")
        assert_compile_count(expected, **sentinels)
