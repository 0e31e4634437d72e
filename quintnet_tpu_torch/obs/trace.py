"""Per-request spans under one trace id, from front door to finish.

A :class:`Span` is one named interval (or instant) in a request's
life, attributed with whatever host-side facts the recording site
already had in hand — the admission's ``AdmitPlan`` outcome, a chunk's
offset and width, a verify step's draft acceptance. A request's
``trace_id`` is assigned ONCE (at the outermost submit surface that
serves it: the HTTP front door, the fleet, or the engine) and rides
the request everywhere after that — across preemption (the engine's
own resume), across the process-fleet wire (``fleet/wire.py`` carries
it on ``RequestProgress``), and onto whichever replica restores it —
so the spans of one request, recorded by several tracers in several
processes, merge into one timeline by id.

The tracer is an append-only host-side log with hard bounds: at most
``max_traces`` request timelines (oldest evicted whole) and at most
``max_spans_per_trace`` spans each (the per-decode-step events of a
very long generation degrade by DROPPING the middle, keeping the
first/last spans and counting the drops — a trace never grows without
limit on a long-running replica). Everything is plain Python floats /
ints / strings: ``snapshot()`` is JSON-able as-is, which is what the
crash dump and the stats/trace wire frames ship.

Inertness: nothing here imports torch or touches device state. All
timing uses the injectable clock the engine already carries, so the
synthetic-trace replayer drives deterministic "wall time" without
sleeping.

Port of ``quintnet_tpu/obs/trace.py`` (standard library only).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Well-known span/event names recorded across the serving stack — a
# registry for dashboards and the trace_view exporter. Tracers accept
# any name at runtime (a site-specific span is better recorded under a
# fresh name than forced into an old one), but tests/test_obs.py pins
# engine-emitted names to this set so it cannot silently drift: add
# the name here when you add a recording site.
# Engine (serve/engine.py): submit, queue, admit, prefill,
#   prefill_chunk, decode, verify, preempt, deadline_exceeded, export,
#   restore, finish (attrs.handed_off marks a disaggregated prefill
#   retirement), kv_export, kv_import, kv_promote (host-tier chain
#   re-import, serve/kv_tier.py — attrs.phase: start/feed/done).
# Fleet (fleet/fleet.py, fleet/proc.py): fleet_submit, fleet_queue,
#   dispatch, first_token, migration, handoff (attrs: to_replica /
#   fallback — the prefill→decode KV transfer outcome).
SPAN_NAMES = frozenset({
    "submit", "queue", "admit", "prefill", "prefill_chunk", "decode",
    "verify", "preempt", "deadline_exceeded", "export", "restore",
    "finish", "kv_export", "kv_import", "kv_promote",
    "fleet_submit", "fleet_queue", "dispatch", "first_token",
    "migration", "handoff",
})


@dataclass
class Span:
    """One named interval in a request's life. ``t1 == t0`` marks an
    instant event (a decode-step commit, a preemption). ``attrs`` hold
    site-specific facts and must stay JSON-able scalars."""

    trace_id: str
    name: str
    t0: float
    t1: float
    attrs: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"trace_id": self.trace_id, "name": self.name,
                "t0": self.t0, "t1": self.t1, "attrs": dict(self.attrs)}


class Tracer:
    """Bounded per-request span log (see module docstring).

    Thread-safe: the thread fleet records from replica worker threads
    while the dispatcher snapshots under its own lock, and the process
    fleet's parent records from reader threads. A lost-race span is a
    forensic gap; a corrupted structure would be a crash — so the lock
    is non-negotiable, and cheap (append + dict ops only)."""

    def __init__(self, *, clock=time.monotonic,
                 max_traces: int = 1024,
                 max_spans_per_trace: int = 512, lock=None):
        if max_traces < 1 or max_spans_per_trace < 4:
            raise ValueError(
                f"need max_traces >= 1 and max_spans_per_trace >= 4, "
                f"got {max_traces}, {max_spans_per_trace}")
        self.clock = clock
        self.max_traces = int(max_traces)
        self.max_spans_per_trace = int(max_spans_per_trace)
        # ``lock=`` accepts an analysis.lockrt.InstrumentedLock so a
        # lock_audit=True fleet folds this mutex into its order graph
        self._lock = lock if lock is not None else threading.Lock()
        # trace_id -> {"spans": [Span], "dropped": int}; OrderedDict
        # gives LRU-by-first-touch eviction of whole timelines
        self._traces: "OrderedDict[str, Dict]" = OrderedDict()

    # ---- recording --------------------------------------------------
    def add(self, trace_id: Optional[str], name: str, *,
            t0: Optional[float] = None, t1: Optional[float] = None,
            **attrs) -> None:
        """Record one span. ``t0`` defaults to now; ``t1`` defaults to
        ``t0`` (an instant). A None ``trace_id`` is a no-op so call
        sites never need their own guard for untraced requests."""
        if trace_id is None:
            return
        if t0 is None:
            t0 = self.clock()
        if t1 is None:
            t1 = t0
        span = Span(trace_id, name, float(t0), float(t1), attrs)
        with self._lock:
            rec = self._traces.get(trace_id)
            if rec is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                rec = {"spans": [], "dropped": 0}
                self._traces[trace_id] = rec
            spans = rec["spans"]
            if len(spans) < self.max_spans_per_trace:
                spans.append(span)
            else:
                # keep the first and last spans of an over-long trace
                # (admission and the terminal events are the forensic
                # anchors); drop from the middle and count it
                keep_tail = self.max_spans_per_trace // 4
                del spans[-keep_tail - 1]
                spans.append(span)
                rec["dropped"] += 1

    def event(self, trace_id: Optional[str], name: str,
              **attrs) -> None:
        """An instantaneous span at now."""
        self.add(trace_id, name, **attrs)

    # ---- reading ----------------------------------------------------
    def spans(self, trace_id: str) -> List[Span]:
        with self._lock:
            rec = self._traces.get(trace_id)
            return list(rec["spans"]) if rec else []

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def dropped(self, trace_id: str) -> int:
        with self._lock:
            rec = self._traces.get(trace_id)
            return rec["dropped"] if rec else 0

    def snapshot(self, trace_ids=None) -> Dict[str, List[Dict]]:
        """JSON-able ``{trace_id: [span dict, ...]}``, optionally
        restricted to ``trace_ids`` — what crash dumps embed and the
        process fleet's ``trace`` RPC ships over the wire."""
        with self._lock:
            ids = list(self._traces) if trace_ids is None else [
                t for t in trace_ids if t in self._traces]
            return {t: [s.to_dict() for s in self._traces[t]["spans"]]
                    for t in ids}

    def merge(self, other_snapshot: Dict[str, List[Dict]]) -> None:
        """Fold another tracer's ``snapshot()`` into this one (the
        dispatcher merging a replica's wire-shipped spans into the
        fleet view). Spans keep their original timestamps; same-id
        timelines concatenate."""
        for trace_id, spans in other_snapshot.items():
            for s in spans:
                self.add(trace_id, s["name"], t0=s["t0"], t1=s["t1"],
                         **s.get("attrs", {}))
