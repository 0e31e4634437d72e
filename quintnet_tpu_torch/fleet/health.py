"""Per-replica health state + circuit breaker + heartbeat/backoff
policy.

A replica is either serving (``HEALTHY``), dead with its worker thread
exited on an error (``DEAD``), or cleanly shut down (``STOPPED``).
Process replicas (fleet/proc.py) add two states a thread can't be in:
``STARTING`` (spawned, engine still building — not a dispatch
candidate until its hello lands) and ``STALLED`` (the process is alive
and its socket open, but heartbeats stopped — a wedge, detected by
:class:`HeartbeatMonitor`, handled like a death EXCEPT the supervisor
must also kill the zombie before restarting).
Whether a DEAD replica gets restarted is the :class:`CircuitBreaker`'s
call — the classic three-state breaker (Nygard, *Release It!*):

- **closed**: failures below the trip threshold; every death is
  followed by an immediate restart (transient faults are expected —
  a preempted core, an injected chaos kill);
- **open**: ``trip_after`` CONSECUTIVE failures tripped the breaker;
  no restarts until ``reset_s`` has elapsed, so a hard-broken replica
  (bad device, poisoned params) cannot crash-loop and drag the fleet's
  dispatcher into endless migration churn;
- **half-open**: the cool-down elapsed; exactly ONE probe restart is
  allowed. The probe replica completing a request closes the breaker
  (fleet calls :meth:`record_success` on every finish); dying again
  re-opens it for another full ``reset_s``.

The breaker never touches threads itself — it is pure policy, driven
by the fleet's dispatcher under the fleet lock, with an injectable
clock so tests advance time without sleeping.

Port of ``quintnet_tpu/fleet/health.py`` (standard library only).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from quintnet_tpu_torch.fleet.retry import RetryPolicy

# replica lifecycle states (Replica.state / ProcReplica.state)
HEALTHY = "healthy"
DEAD = "dead"
STOPPED = "stopped"
STARTING = "starting"   # process spawned, hello not yet received
STALLED = "stalled"     # alive but not heartbeating (wedged process)

# breaker states (CircuitBreaker.state)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure trip with a timed half-open probe."""

    def __init__(self, *, trip_after: int = 3, reset_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if trip_after < 1:
            raise ValueError(f"trip_after must be >= 1, got {trip_after}")
        self.trip_after = int(trip_after)
        self.reset_s = float(reset_s)
        self.clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self._opened_at: Optional[float] = None

    def record_failure(self) -> None:
        """One replica death. A half-open probe dying re-opens
        immediately; otherwise the trip threshold decides."""
        self.consecutive_failures += 1
        if (self.state == HALF_OPEN
                or self.consecutive_failures >= self.trip_after):
            self.state = OPEN
            self._opened_at = self.clock()

    def record_success(self) -> None:
        """The replica completed a request: whatever tripped it is
        gone; full reset."""
        self.consecutive_failures = 0
        self.state = CLOSED
        self._opened_at = None

    def allow_restart(self) -> bool:
        """May the fleet restart the dead replica NOW? closed → always;
        open → only once ``reset_s`` has elapsed (transitions to
        half-open and grants the single probe); half-open → no (the
        probe is already out)."""
        if self.state == CLOSED:
            return True
        if self.state == HALF_OPEN:
            return False
        if self.clock() - self._opened_at >= self.reset_s:
            self.state = HALF_OPEN
            return True
        return False

    @property
    def restart_conceivable(self) -> bool:
        """Read-only: could a restart be granted now or soon WITHOUT
        driving the state machine (``allow_restart`` transitions to
        half-open as a side effect — unusable as a pure query)?
        False exactly when the breaker is OPEN inside its cool-down or
        a half-open probe is already out — the window the
        disaggregated fleet's degradation ladder (fleet/proc.py)
        treats a pool as hard-down and sheds typed instead of
        queueing behind a breaker that cannot act."""
        if self.state == CLOSED:
            return True
        if self.state == HALF_OPEN:
            return False
        return self.clock() - self._opened_at >= self.reset_s


class HeartbeatMonitor:
    """Liveness by heartbeat age, the ONLY wedge detector that needs no
    cooperation from the wedged side: a process that SIGKILLs shows an
    EOF on its socket, but a process that merely stops making progress
    (deadlocked GIL, runaway compile, swapped-out host) keeps its
    socket open and looks healthy to everything except the absence of
    heartbeats. ``budget_s`` is the detection SLA: a replica whose last
    beat is older than the budget is declared stalled and routed
    around (fleet/proc.py). The clock is injectable so tests advance
    time without sleeping."""

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if budget_s <= 0:
            raise ValueError(f"budget_s must be > 0, got {budget_s}")
        self.budget_s = float(budget_s)
        self.clock = clock
        self.last_beat = clock()   # spawn counts as the first beat

    def beat(self) -> None:
        self.last_beat = self.clock()

    @property
    def age_s(self) -> float:
        return self.clock() - self.last_beat

    @property
    def expired(self) -> bool:
        return self.age_s > self.budget_s


class Backoff(RetryPolicy):
    """Jittered exponential restart backoff (the ft_run supervisor's
    relaunch discipline, made policy): attempt ``n`` (1-based) waits
    ``base * 2^(n-1)`` capped at ``cap``, times a jitter factor in
    ``[1, 1+jitter]`` so N replicas felled by one cause do not
    restart — and re-fail — in lockstep. ``rand`` is injectable for
    deterministic tests.

    The math now lives in the shared
    :class:`~quintnet_tpu_torch.fleet.retry.RetryPolicy` (the KV-handoff
    retry loop of the disaggregated fleet uses the same envelope);
    this subclass keeps the restart-flavored name and its original
    delay-only constructor."""

    def __init__(self, *, base_s: float = 0.05, cap_s: float = 5.0,
                 jitter: float = 0.25,
                 rand: Optional[Callable[[], float]] = None):
        super().__init__(base_s=base_s, cap_s=cap_s, jitter=jitter,
                         rand=rand)
