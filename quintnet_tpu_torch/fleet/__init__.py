"""Multi-replica serving: load balancing, load shedding, kill-safe
request migration.

One :class:`~quintnet_tpu_torch.serve.engine.ServeEngine` is a single
continuous-batching process; this package runs N of them on worker
threads behind one submit/stream API and makes the resulting fleet
operable under the two things production traffic guarantees — bursts
and failures:

- :mod:`router`    — least-outstanding-work routing (token-count load
  proxy) or deterministic round_robin, with an adapter-affinity
  pre-filter for LoRA-bound requests (serve/adapters.py);
- :mod:`admission` — bounded fleet-wide queue; overload and expired
  deadlines shed with a typed :class:`Overloaded` instead of queueing
  forever;
- :mod:`health`    — per-replica circuit breaker (consecutive-failure
  trip, timed half-open probe) gating restarts of dead replicas;
- :mod:`replica`   — the ServeEngine worker thread: inbox, chaos
  polling (``ft.ChaosMonkey`` mode='raise'), and the death export of
  every unfinished request's host-side progress;
- :mod:`fleet`     — :class:`ServeFleet`: submit/result/generate,
  dispatcher, **exact migration** (a killed replica's in-flight
  requests resume on healthy replicas token-identically, via the same
  prompt+generated+seed resume contract the engine's preemption path
  already guarantees), graceful drain, fleet metrics.

Port of the thread fleet of ``quintnet_tpu/fleet/``. The process
fleet, its wire protocol, the HTTP front door and disaggregated pools
(``proc.py``, ``wire.py``, ``frontdoor.py``) are not ported yet
(ROADMAP.md, §1, item 8b); neither are ``ServeFleet(lock_audit=True)``
and ``ServeFleet.assert_compile_count``, which rest on the static
checks (ROADMAP.md, §1, item 9).
"""

from quintnet_tpu_torch.fleet.admission import AdmissionQueue, Overloaded
from quintnet_tpu_torch.fleet.fleet import (FleetMetrics, FleetRequest,
                                            ServeFleet)
from quintnet_tpu_torch.fleet.health import (CLOSED, DEAD, HALF_OPEN,
                                             HEALTHY, OPEN, STALLED,
                                             STARTING, STOPPED, Backoff,
                                             CircuitBreaker,
                                             HeartbeatMonitor)
from quintnet_tpu_torch.fleet.replica import Replica
from quintnet_tpu_torch.fleet.retry import RetryPolicy
from quintnet_tpu_torch.fleet.router import (ANY_POOL, POLICIES, Router,
                                             eligible)

__all__ = [
    "AdmissionQueue",
    "Backoff",
    "CircuitBreaker",
    "FleetMetrics",
    "FleetRequest",
    "HeartbeatMonitor",
    "Overloaded",
    "ANY_POOL",
    "POLICIES",
    "Replica",
    "RetryPolicy",
    "Router",
    "ServeFleet",
    "eligible",
    "HEALTHY",
    "DEAD",
    "STOPPED",
    "STARTING",
    "STALLED",
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
]
