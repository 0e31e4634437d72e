"""Typed structured fleet lifecycle events: an in-memory ring plus an
optional JSONL sink.

Everything operationally interesting that happens to a fleet — a
replica dying or stalling, a breaker opening, a request migrating, a
restart, a shed, a drain — was previously a counter increment and, at
best, a log line. This module makes each one a TYPED record
(``{"ts", "seq", "kind", ...fields}``) appended to a bounded in-memory
ring and, when a path is given, written as one JSON line per event —
the grep-able, replay-able account of what the fleet did and when,
and the context section of every crash dump.

``kind`` is validated against :data:`EVENT_KINDS`: an unknown kind is
a programming error at the EMIT site (a typo would silently create an
event family nobody queries), not something to discover at read time.

Port of ``quintnet_tpu/obs/events.py`` (standard library only).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# The fleet lifecycle vocabulary. Adding a kind here is part of adding
# the emit site — the docs table (docs/observability.md) lists both.
EVENT_KINDS = frozenset({
    "replica_death",        # worker raised / process EOF'd
    "replica_stall",        # heartbeats silent past the budget
    "replica_restart",      # breaker-approved respawn
    "breaker",              # breaker state CHANGED (attrs: state)
    "migration",            # one request re-queued off a corpse
    "shed",                 # typed Overloaded rejection
    "deadline_exceeded",    # admitted request retired mid-decode
    "drain",                # graceful shutdown began
    "close",                # hard stop
    "crash_dump",           # post-mortem file written (attrs: path)
    # disaggregated prefill/decode pools (fleet/proc.py)
    "handoff",              # prefill done -> request moves to decode
    #                         (attrs: transferred tokens or fallback)
    "handoff_retry",        # one KV-transfer attempt failed, retrying
    #                         (attrs: attempt, error)
    "handoff_fallback",     # transfer exhausted retries; decode-side
    #                         local re-prefill serves instead
    "pool_degraded",        # a pool lost its last live replica
    "pool_recovered",       # a down pool is serving again
    # SLO engine + rebalance planner (obs/slo.py, obs/signals.py)
    "slo_breach",           # fast+slow burn windows both tripped
    #                         (attrs: objective, pool, burn_fast/slow)
    "slo_recovered",        # the fast window dropped back under the
    #                         threshold for a breaching objective
    "rebalance_recommended",  # observe-only planner output (attrs:
    #                           direction, reason, burn — NO actuation)
    # tiered KV peer lookup (serve/kv_tier.py, fleet/proc.py): the
    # dispatcher probed peer replicas' host tiers before dispatch
    "tier_peer_hit",        # a peer's chain beat the target's — KV
    #                         shipped peer->target before dispatch
    #                         (attrs: from/to_replica, tokens)
    "tier_peer_miss",       # no peer beat the target (or the
    #                         transfer degraded) — dispatch proceeds
    #                         without warm peer KV (attrs: reason)
    # lock-discipline runtime (analysis/lockrt.py, fleets built with
    # lock_audit=True): the instrumented locks observed both orders of
    # a lock pair — the would-be deadlock, reported the moment the
    # second direction appeared (attrs: first, second, thread,
    # forward_stack, reverse_stack)
    "lock_order_violation",
})


class EventLog:
    """Bounded typed event ring + optional JSONL file sink.

    Thread-safe (fleet callbacks emit from replica worker / reader
    threads). The file handle is opened lazily on first emit and
    line-buffered so a crash loses at most the in-flight line — the
    JSONL file is the durable half of the story, the ring the cheap
    queryable half."""

    def __init__(self, *, clock=time.monotonic, capacity: int = 4096,
                 path: Optional[str] = None, lock=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock
        self.path = path
        # ``lock=`` lets a fleet built with lock_audit=True hand in an
        # analysis.lockrt.InstrumentedLock so the ring's mutex joins
        # the fleet-wide order graph; default is a plain Lock.
        self._lock = lock if lock is not None else threading.Lock()
        self._ring: "deque[Dict]" = deque(maxlen=int(capacity))
        self._seq = 0
        self._fh = None

    def emit(self, kind: str, **fields) -> Dict:
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown event kind {kind!r}; known: "
                f"{sorted(EVENT_KINDS)} (add new kinds to "
                f"obs/events.py EVENT_KINDS beside their emit site)")
        with self._lock:
            self._seq += 1
            rec = {"ts": self.clock(), "seq": self._seq, "kind": kind,
                   **fields}
            self._ring.append(rec)
            if self.path is not None:
                if self._fh is None:
                    self._fh = open(self.path, "a", buffering=1)
                self._fh.write(json.dumps(rec) + "\n")
        return rec

    def snapshot(self, *, kind: Optional[str] = None,
                 last: Optional[int] = None) -> List[Dict]:
        """Events oldest-first, optionally filtered by kind and/or
        truncated to the last N."""
        with self._lock:
            out = [dict(r) for r in self._ring
                   if kind is None or r["kind"] == kind]
        return out if last is None else out[-last:]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
