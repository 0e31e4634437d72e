"""The engine-step flight recorder: a bounded ring of per-step records.

``ServeMetrics`` keeps monotone counters — totals that answer "how
much, overall". The :class:`StepRecorder` keeps the TIMELINE: one
:class:`StepRecord` per engine step with the phase mix (how many slots
decoded vs prefilled), batch occupancy, KV-pool pressure, the chunk
budget actually spent, speculation acceptance, and the step's wall
time via the engine's injectable clock. That is exactly the signal the
Sarathi/Orca literature argues scheduling decisions need: per-step
prefill/decode interference, not end-of-run aggregates.

The ring is bounded (``capacity`` steps; a long-running replica keeps
the freshest window and counts what scrolled off) and the records are
plain dict-able scalars, so:

- ``snapshot()`` feeds ``tools/trace_view.py``'s Chrome trace-event
  export (steps as thread slices in Perfetto);
- ``drain_new()`` ships increments over the process-fleet wire —
  replica children piggyback fresh records on their heartbeat frames,
  making the dispatcher's mirror the corpse's "last known" ring when a
  SIGKILL lands (fleet/proc.py; the crash-dump path);
- a crash dump embeds the ring as-is (obs/crashdump.py).

Inertness: ``record()`` is appended AFTER the step's device work was
dispatched, reads only host-side ints the engine already computed, and
never forces a sync — the step's ``t1 - t0`` therefore measures
dispatch + any blocking the step itself did, which is the honest
number for a recorder that must never add blocking of its own (the
bench's timed A/B keeps its own explicit drains).

Port of ``quintnet_tpu/obs/recorder.py`` (standard library only).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional


@dataclass
class StepRecord:
    """One engine step, host-side facts only (all JSON-able)."""

    step: int                   # engine-lifetime step index (1-based)
    t0: float                   # clock() at step entry
    t1: float                   # clock() after host bookkeeping
    running: int = 0            # occupied slots after the step
    waiting: int = 0            # scheduler queue depth
    decoding: int = 0           # slots that rode the decode/verify step
    prefilling: int = 0         # slots mid-chunked-prefill
    admitted: int = 0           # admissions this step
    finished: int = 0           # retirements this step
    preempted: int = 0          # evictions this step
    kv_blocks_used: int = 0
    kv_blocks_total: int = 0
    prefill_tokens: int = 0     # prompt tokens pushed through prefill
    decode_tokens: int = 0      # tokens committed by decode/verify
    prefix_hit_tokens: int = 0
    prefill_chunks: int = 0     # chunk program invocations (budget use)
    spec_step: bool = False
    draft_tokens: int = 0
    accepted_draft_tokens: int = 0
    attrs: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return asdict(self)

    @property
    def wall_s(self) -> float:
        return max(self.t1 - self.t0, 0.0)


class StepRecorder:
    """Bounded ring of :class:`StepRecord` (see module docstring).

    Thread-safe: the engine records from its worker thread while the
    heartbeat thread drains increments for the wire and stats RPCs
    snapshot the whole ring."""

    def __init__(self, *, capacity: int = 512, clock=time.monotonic,
                 lock=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        # ``lock=`` accepts an analysis.lockrt.InstrumentedLock so a
        # lock_audit=True fleet folds this mutex into its order graph
        self._lock = lock if lock is not None else threading.Lock()
        self._ring: "deque[StepRecord]" = deque(maxlen=self.capacity)
        self._total = 0          # records ever appended
        self._drained = 0        # records shipped via drain_new()

    def record(self, rec: StepRecord) -> None:
        with self._lock:
            self._ring.append(rec)
            self._total += 1

    # ---- reading ----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total(self) -> int:
        """Steps ever recorded (>= len(); the excess scrolled off)."""
        with self._lock:
            return self._total

    def snapshot(self) -> List[Dict]:
        """The ring as JSON-able dicts, oldest first."""
        with self._lock:
            return [r.to_dict() for r in self._ring]

    def last(self) -> Optional[Dict]:
        """The freshest step record (or None before the first step) —
        what the signal plane samples occupancy/KV pressure from
        without copying the whole ring (obs/signals.py)."""
        with self._lock:
            return self._ring[-1].to_dict() if self._ring else None

    def drain_new(self, *, max_records: int = 64) -> List[Dict]:
        """Records appended since the last drain (at most
        ``max_records`` per call — heartbeat frames stay small; the
        rest comes on the next beat). Records that scrolled off the
        ring before being drained are simply gone — the mirror is
        "last known", not lossless, exactly like the black box it
        models."""
        with self._lock:
            undrained = self._total - self._drained
            # records that scrolled off the ring before being drained
            # are lost to the mirror; the cursor must skip them or a
            # later drain would re-ship records it already sent
            lost = max(undrained - len(self._ring), 0)
            self._drained += lost
            undrained -= lost
            take = min(undrained, max_records)
            if take <= 0:
                return []
            window = list(self._ring)[-undrained:]
            self._drained += take
            return [r.to_dict() for r in window[:take]]
