"""Multi-replica serving: load balancing, load shedding, kill-safe
request migration.

One :class:`~quintnet_tpu_torch.serve.engine.ServeEngine` is a single
continuous-batching process; this package runs N of them behind one
submit/stream API — on worker threads (:class:`ServeFleet`) or as
replica processes (:class:`ProcessFleet`) — and makes the resulting
fleet operable under the two things production traffic guarantees —
bursts and failures:

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
  already guarantees), graceful drain, fleet metrics;
- :mod:`wire`      — versioned, length-prefixed JSON frames, the typed
  errors, and the checksummed KV-chain frames (byte-equal to JAX's);
- :mod:`proc`      — :class:`ProcessFleet`: spawned replica processes
  (:func:`replica_main`, :class:`ProcReplica`) with heartbeats, the
  write-ahead token journal and crash-safe migration, breaker-gated
  backoff restarts, and disaggregated prefill/decode pools
  (``pools=``, :data:`POOLS`) with the KV handoff;
- :mod:`frontdoor` — :class:`FrontDoor`, the HTTP/SSE server in front
  of either fleet (429/503 + Retry-After, 504, 400; ``/healthz``,
  ``/metrics``).

Port of ``quintnet_tpu/fleet/``. ``lock_audit=True`` instruments
either fleet's locks (``analysis/lockrt.py``), and both fleets'
``assert_compile_count`` hold the replicas' engines to their recompile
sentinels (``analysis/recompile.py``).
"""

from quintnet_tpu_torch.fleet.admission import AdmissionQueue, Overloaded
from quintnet_tpu_torch.fleet.fleet import (FleetMetrics, FleetRequest,
                                            ServeFleet)
from quintnet_tpu_torch.fleet.frontdoor import FrontDoor
from quintnet_tpu_torch.fleet.health import (CLOSED, DEAD, HALF_OPEN,
                                             HEALTHY, OPEN, STALLED,
                                             STARTING, STOPPED, Backoff,
                                             CircuitBreaker,
                                             HeartbeatMonitor)
from quintnet_tpu_torch.fleet.proc import (POOLS, ProcessFleet,
                                           ProcReplica, replica_main)
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
    "FrontDoor",
    "HeartbeatMonitor",
    "Overloaded",
    "ANY_POOL",
    "POLICIES",
    "POOLS",
    "ProcReplica",
    "ProcessFleet",
    "Replica",
    "RetryPolicy",
    "Router",
    "ServeFleet",
    "eligible",
    "replica_main",
    "HEALTHY",
    "DEAD",
    "STOPPED",
    "STARTING",
    "STALLED",
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
]
