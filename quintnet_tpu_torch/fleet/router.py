"""Replica selection policies.

``least_work`` is the fleet default: route to the replica with the
fewest OUTSTANDING TOKENS — the sum over its dispatched-but-unfinished
requests of the tokens still to be prefilled plus the tokens still to
be decoded. Token count, not request count, is the right load proxy
for continuous batching: one 500-token prompt occupies a slot for as
long as ten 50-token ones, and AlpaServe's result is precisely that
statistical multiplexing on actual work keeps tail latency down under
bursty traffic. ``round_robin`` is the deterministic baseline the
bench compares against (and what tests use when they need to know
exactly which replica got which request).

Adapter affinity (multi-tenant LoRA, serve/adapters.py): a request
bound to an adapter PREFERS replicas whose registry holds the adapter
resident — serving it there skips a safetensors (re)load and keeps
each tenant's working set warm on few replicas instead of thrashing
every LRU. The affinity is a cheap candidate PRE-FILTER ahead of the
load policy, never a hard constraint: when no candidate is warm (a
brand-new tenant, or its replicas are busy/dead) the full candidate
list stands and the chosen replica loads the adapter on demand — the
same path fleet migration relies on.

The router is pure policy: the fleet hands it the CANDIDATE list
(healthy, unpaused, below their dispatch window) under the fleet lock
and it picks one. Ties break on replica name so the choice is
reproducible.

Port of ``quintnet_tpu/fleet/router.py`` (standard library only).
"""

from __future__ import annotations

from typing import List, Optional

from quintnet_tpu_torch.fleet.health import HEALTHY

POLICIES = ("least_work", "round_robin")

# a replica without a pool assignment serves every phase (colocated
# fleets, and the thread fleet's Replica which predates pools)
ANY_POOL = "any"


def eligible(replicas: List, *, pool: Optional[str] = None) -> List:
    """The dispatch-candidate predicate both fleets share (threads:
    fleet/fleet.py; processes: fleet/proc.py): serving state, not
    paused, below its dispatch window. STARTING (process still
    building its engine) and STALLED (missed heartbeats) replicas fail
    the state test exactly like DEAD ones — a stalled replica is
    routed AROUND, never at.

    ``pool`` narrows to one pool of a disaggregated fleet
    (fleet/proc.py): a candidate matches when it belongs to that pool
    or carries no pool assignment (``"any"`` — colocated replicas
    serve every phase). ``pool=None`` keeps the colocated behavior
    byte-identical."""
    return [r for r in replicas
            if r.state == HEALTHY and not r.paused
            and r.in_flight < r.max_dispatch
            and (pool is None
                 or getattr(r, "pool", ANY_POOL) in (pool, ANY_POOL))]


class Router:
    def __init__(self, policy: str = "least_work"):
        if policy not in POLICIES:
            raise ValueError(f"unknown routing policy {policy!r}; "
                             f"expected one of {POLICIES}")
        self.policy = policy
        self._rr = 0

    def pick(self, candidates: List, *,
             adapter_id: Optional[str] = None) -> "object":
        """Choose one replica from a non-empty candidate list. Each
        candidate exposes ``outstanding_tokens``, ``name`` and
        ``adapter_resident(adapter_id)``. ``adapter_id``: narrow to
        the adapter-warm candidates first when any exist (see module
        docstring), then apply the policy unchanged."""
        if not candidates:
            raise ValueError("pick() needs at least one candidate")
        if adapter_id is not None:
            warm = [r for r in candidates
                    if r.adapter_resident(adapter_id)]
            if warm:
                candidates = warm
        if self.policy == "round_robin":
            choice = candidates[self._rr % len(candidates)]
            self._rr += 1
            return choice
        return min(candidates,
                   key=lambda r: (r.outstanding_tokens, r.name))
