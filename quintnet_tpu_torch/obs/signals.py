"""The pool-pressure signal plane: EWMA-smoothed per-pool gauges plus
the observe-only rebalance planner the autoscaler will run on.

The SLO engine (obs/slo.py) says WHETHER the fleet is meeting its
contract; this module says WHERE the pressure is and WHAT a resize
should do about it — without doing it. Splitwise and DistServe size
prefill/decode pools from exactly these signals (queue depth and wait
age per phase, pool occupancy, KV pressure, transfer health), so the
plane exists to make the ROADMAP's elastic-pool-sizing item a pure
wiring exercise: when that item lands, it connects
``rebalance_recommended`` events to the existing pool-map mutation
(``ProcReplica.pool`` is just routing state) and inherits a contract
that is ALREADY tested and already proven inert.

- :class:`SignalBus` — named gauges sampled on the dispatcher thread
  (fleet/proc.py ``_tend_signals_locked``), each a raw last value plus
  a time-decayed EWMA (half-life smoothing: a gauge sampled at an
  uneven cadence still decays on the clock, not the sample count) and
  a bounded history ring. Everything is host-side floats keyed by
  ``(signal, pool)``; ``snapshot()`` is JSON-able as-is — it rides
  crash dumps and renders as ``quintnet_pool_pressure_*`` Prometheus
  families.
- :class:`PoolRebalancePlanner` — consumes the SLO status + the bus
  and emits typed ``rebalance_recommended`` events ("convert one
  decode replica to prefill for ~8s: prefill pool burning ttft_p99
  budget 4.2x, decode occupancy 21%") with hysteresis (one outstanding
  direction at a time — a sustained breach does not re-spam) and a
  cooldown between recommendations. RECOMMENDATIONS ONLY, no
  actuation: the planner holds no fleet references and mutates
  nothing, which is what makes the inertness contract provable now.

Inert by construction: nothing here imports torch or blocks; sampling
is appends + float math on state the dispatcher already holds.

Port of ``quintnet_tpu/obs/signals.py`` (standard library only).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

# The signal vocabulary the fleet dispatcher samples (fleet/proc.py).
# Like obs/events.EVENT_KINDS this is a registry, not a gate: the bus
# accepts any name (a site-specific gauge beats a forced fit), but the
# docs table and the Prometheus family list key off these.
SIGNALS = (
    "queue_depth",              # admission-queue depth (per phase/pool)
    "queue_oldest_wait_s",      # oldest queued item's wait age
    "occupancy",                # running slots / total slots, per pool
    "kv_pressure",              # KV blocks used / total, per pool
    "chunk_budget_saturation",  # chunk tokens spent / budget, per pool
    "handoff_latency_s",        # one prefill->decode transfer's wall
    "handoff_fallback_rate",    # fallbacks / handoffs (running)
    "heartbeat_age_s",          # max live-member heartbeat age, per pool
    "breakers_open",            # members with a not-closed breaker
)

FLEET = "fleet"                 # the pool label for fleet-wide signals


class Ewma:
    """Time-decayed exponential moving average: the retained value's
    weight halves every ``halflife_s`` of CLOCK time, so an unevenly
    sampled gauge (the dispatcher samples when it ticks, not on a
    timer) still smooths on the wall, not the sample count."""

    __slots__ = ("halflife_s", "_v", "_t")

    def __init__(self, halflife_s: float):
        if halflife_s <= 0:
            raise ValueError(f"halflife_s must be > 0, got {halflife_s}")
        self.halflife_s = float(halflife_s)
        self._v: Optional[float] = None
        self._t: Optional[float] = None

    def update(self, t: float, x: float) -> float:
        x = float(x)
        if self._v is None:
            self._v = x
        else:
            dt = max(t - self._t, 0.0)
            keep = 0.5 ** (dt / self.halflife_s)
            self._v = keep * self._v + (1.0 - keep) * x
        self._t = float(t)
        return self._v

    @property
    def value(self) -> Optional[float]:
        return self._v


class SignalBus:
    """Bounded, EWMA-smoothed gauge store keyed by (signal, pool).

    Thread-safe: the dispatcher samples under the fleet lock while the
    front door renders ``gauges()`` and a crash handler snapshots."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 halflife_s: float = 2.0, history: int = 256,
                 lock=None):
        if history < 1:
            raise ValueError(f"history must be >= 1, got {history}")
        self.clock = clock
        self.halflife_s = float(halflife_s)
        self.history_cap = int(history)
        # ``lock=`` accepts an analysis.lockrt.InstrumentedLock so a
        # lock_audit=True fleet folds this mutex into its order graph
        self._lock = lock if lock is not None else threading.Lock()
        # (name, pool) -> {"ewma": Ewma, "hist": deque[(t, v)],
        #                  "last": float, "t": float, "n": int}
        self._gauges: Dict[Tuple[str, str], Dict] = {}

    def sample(self, name: str, value: float, *,
               pool: str = FLEET) -> None:
        t = self.clock()
        v = float(value)
        with self._lock:
            g = self._gauges.get((name, pool))
            if g is None:
                g = {"ewma": Ewma(self.halflife_s),
                     "hist": deque(maxlen=self.history_cap),
                     "last": v, "t": t, "n": 0}
                self._gauges[(name, pool)] = g
            g["ewma"].update(t, v)
            g["hist"].append((t, v))
            g["last"] = v
            g["t"] = t
            g["n"] += 1

    # ---- reading ----------------------------------------------------
    def value(self, name: str, pool: str = FLEET, *,
              smoothed: bool = True) -> Optional[float]:
        """The gauge's EWMA (or raw last sample); None if never
        sampled — callers choose their own default, the bus never
        invents a reading."""
        with self._lock:
            g = self._gauges.get((name, pool))
            if g is None:
                return None
            return g["ewma"].value if smoothed else g["last"]

    def history(self, name: str, pool: str = FLEET
                ) -> List[Tuple[float, float]]:
        with self._lock:
            g = self._gauges.get((name, pool))
            return list(g["hist"]) if g else []

    def gauges(self) -> Dict[str, Dict[str, Dict]]:
        """JSON-able ``{signal: {pool: {"last", "ewma", "t", "n"}}}``
        — what /metrics renders as ``quintnet_pool_pressure_*`` and
        crash dumps embed."""
        with self._lock:
            out: Dict[str, Dict[str, Dict]] = {}
            for (name, pool), g in self._gauges.items():
                out.setdefault(name, {})[pool] = {
                    "last": g["last"],
                    "ewma": round(float(g["ewma"].value), 6),
                    "t": g["t"], "n": g["n"]}
            return out

    def snapshot(self) -> Dict:
        """The crash-dump payload: sample time + every gauge."""
        return {"sampled_at": self.clock(), "gauges": self.gauges()}


def _reverse(direction: str) -> str:
    a, _, b = direction.partition("_to_")
    return f"{b}_to_{a}"


class PoolRebalancePlanner:
    """Observe-only rebalance recommendations (module docstring).

    One ``plan()`` call per dispatcher signal tick. A recommendation
    fires when an objective attributed to one pool is breaching, the
    OTHER pool has occupancy headroom (EWMA below
    ``donor_occupancy_below`` — moving a busy replica would trade one
    breach for another), the planner is past its ``cooldown_s``, and
    the direction is not already outstanding (hysteresis: a sustained
    breach is one recommendation, not a stream). When the breach
    recovers, the planner recommends REVERTING the outstanding
    conversion — the explicit "put it back" the autoscaler needs to
    avoid ratcheting. A non-revert recommendation in the OPPOSITE
    direction of the one in force (the other pool started breaching
    before the first recovered) nets the ledger to baseline the same
    way — no separate revert follows, so replaying the stream always
    lands back at the static split."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 events=None, cooldown_s: float = 10.0,
                 donor_occupancy_below: float = 0.75,
                 max_recommendations: int = 256):
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        if not 0 < donor_occupancy_below <= 1.0:
            raise ValueError(
                f"donor_occupancy_below must be in (0, 1], got "
                f"{donor_occupancy_below}")
        self.clock = clock
        self.events = events
        self.cooldown_s = float(cooldown_s)
        self.donor_occupancy_below = float(donor_occupancy_below)
        self.outstanding: Optional[str] = None   # direction in force
        self.recommendations: "deque[Dict]" = deque(
            maxlen=int(max_recommendations))
        self._last_t: Optional[float] = None

    @staticmethod
    def _worst_breach(status: Dict, pool: str) -> Optional[Tuple[str,
                                                                 Dict]]:
        worst = None
        for name, st in status.get("objectives", {}).items():
            if st.get("pool") == pool and st.get("breaching"):
                if worst is None or st["burn_fast"] > worst[1]["burn_fast"]:
                    worst = (name, st)
        return worst

    def plan(self, slo_status: Dict, bus: SignalBus) -> Optional[Dict]:
        """Judge one tick; returns the recommendation emitted (also
        appended to ``recommendations`` and, with an event log, an
        ``rebalance_recommended`` event), or None."""
        now = self.clock()
        pre = self._worst_breach(slo_status, "prefill")
        dec = self._worst_breach(slo_status, "decode")
        direction = donor = driver = None
        revert = False
        if pre is not None and dec is None:
            donor, direction, driver = "decode", "decode_to_prefill", pre
        elif dec is not None and pre is None:
            donor, direction, driver = "prefill", "prefill_to_decode", dec
        elif pre is None and dec is None and self.outstanding is not None:
            direction, revert = _reverse(self.outstanding), True
        if direction is None:
            return None
        if not revert:
            occ = bus.value("occupancy", donor)
            if occ is None or occ >= self.donor_occupancy_below:
                return None     # donor has no headroom to give
        if direction == self.outstanding:
            return None         # hysteresis: already recommended
        if (self._last_t is not None
                and now - self._last_t < self.cooldown_s):
            return None
        from_pool, _, to_pool = direction.partition("_to_")
        dur = float(slo_status.get("fast_window_s", 0.0)) or None
        if revert:
            reason = (f"{_reverse(direction)} breach recovered; revert "
                      f"the earlier conversion — move one {from_pool} "
                      f"replica back to {to_pool}")
            rec = {"t": now, "direction": direction,
                   "from_pool": from_pool, "to_pool": to_pool,
                   "revert": True, "objective": None,
                   "reason": reason}
        else:
            name, st = driver
            occ = bus.value("occupancy", donor)
            horizon = f" for ~{dur:.0f}s" if dur is not None else ""
            reason = (f"convert one {from_pool} replica to "
                      f"{to_pool}{horizon}: {to_pool} pool burning "
                      f"{name} budget {st['burn_fast']:.1f}x fast / "
                      f"{st['burn_slow']:.1f}x slow, {from_pool} pool "
                      f"occupancy {occ:.0%}")
            rec = {"t": now, "direction": direction,
                   "from_pool": from_pool, "to_pool": to_pool,
                   "revert": False, "objective": name,
                   "burn_fast": st["burn_fast"],
                   "burn_slow": st["burn_slow"],
                   "donor_occupancy": round(occ, 4),
                   "duration_hint_s": dur,
                   "reason": reason}
        if revert or direction == _reverse(self.outstanding or ""):
            # a revert — or a fresh recommendation that is the exact
            # reverse of the conversion still in force — NETS the
            # ledger back to baseline: no second revert must follow,
            # or an autoscaler replaying the stream ends lopsided
            self.outstanding = None
        else:
            self.outstanding = direction
        self._last_t = now
        self.recommendations.append(rec)
        if self.events is not None:
            self.events.emit("rebalance_recommended",
                             **{k: v for k, v in rec.items()
                                if k != "t"})
        return rec
