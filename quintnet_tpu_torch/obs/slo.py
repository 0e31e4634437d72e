"""The SLO engine: declarative serving objectives evaluated as
multi-window burn rates over rolling observation windows.

The flight recorder (obs/recorder.py, obs/trace.py) COLLECTS everything
but judges nothing: the fleet has per-step rings, spans, and Prometheus
gauges, yet no notion of an objective — "is the disaggregated fleet
meeting its latency contract, and which pool is the bottleneck?" would
be a human reading a bench record after the fact. DistServe and
Splitwise (PAPERS.md) both define *goodput* as throughput under
TTFT/TPOT SLO attainment and size prefill/decode pools from exactly
these signals — so before the
ROADMAP's elastic-pool-sizing item can act, the judgment layer has to
exist, be tested, and be provably inert.

The model is the SRE multi-window burn-rate alert, adapted to serving
latency quantiles:

- an :class:`Objective` promises either a **latency quantile** ("TTFT
  p99 <= 300 ms": at most ``1 - quantile`` of observations may exceed
  ``target``) or a **rate** ("error rate <= 1%": the mean of a 0/1
  stream stays under ``target``);
- the **burn rate** over a window is how fast the objective's error
  budget is being spent: for a latency objective,
  ``frac(observations > target) / (1 - quantile)``; for a rate
  objective, ``mean(stream) / target``. Burn 1.0 = exactly on budget;
  4.2 = burning budget 4.2x faster than the objective allows;
- a **breach** requires BOTH the fast and the slow window to burn at
  or above the threshold (fast alone = noise spike; slow alone = old
  news) — the classic fast+slow gate that keeps alerts responsive
  without flapping. Recovery is when the FAST window drops back below
  the threshold: the freshest evidence says the budget stopped
  burning;
- breach/recovery edges are TYPED lifecycle events (``slo_breach`` /
  ``slo_recovered``, obs/events.py) carrying **per-pool attribution**:
  a TTFT objective names the prefill pool, an ITL objective the decode
  pool — which is exactly the signal the rebalance planner
  (obs/signals.py) and the future autoscaler consume.

Observations are host-side floats fed by the fleet dispatcher
(fleet/proc.py) from ledgers it already keeps — first-token and
inter-token timestamps, request outcomes, typed sheds. Nothing here
imports torch, touches device state, or blocks: the engine is inert by
construction, NaN-free at zero traffic (empty windows burn 0.0), and
uses the injectable clock, so tests drive deterministic time without
sleeping.

Port of ``quintnet_tpu/obs/slo.py`` (standard library only).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from quintnet_tpu_torch.utils.logger import log_once

_log = logging.getLogger("quintnet_tpu_torch.obs.slo")

# objective kinds
LATENCY = "latency"     # stream of seconds; quantile <= target
RATE = "rate"           # stream of 0/1 outcomes; mean <= target


@dataclass(frozen=True)
class Objective:
    """One declarative promise about a serving signal.

    ``stream`` names the observation feed (``"ttft"``, ``"itl"``,
    ``"error"``, ``"shed"`` — any string the dispatcher observes
    into). ``pool`` is the attribution: which replica pool a breach of
    this objective points at (``"prefill"`` for TTFT — admission +
    prefill latency live there in a disaggregated fleet — ``"decode"``
    for ITL, ``"any"`` for fleet-wide rates). ``burn_threshold``
    overrides the config-wide threshold for this objective only."""

    name: str
    stream: str
    kind: str
    target: float
    quantile: float = 0.99          # LATENCY only: the promised tail
    pool: str = "any"
    burn_threshold: Optional[float] = None
    description: str = ""

    def __post_init__(self):
        if self.kind not in (LATENCY, RATE):
            raise ValueError(
                f"objective {self.name!r}: kind must be {LATENCY!r} or "
                f"{RATE!r}, got {self.kind!r}")
        if self.target <= 0:
            raise ValueError(
                f"objective {self.name!r}: target must be > 0, got "
                f"{self.target}")
        if self.kind == RATE and not self.target < 1:
            raise ValueError(
                f"objective {self.name!r}: a rate target is a "
                f"fraction in (0, 1), got {self.target}")
        if self.kind == LATENCY and not 0 < self.quantile < 1:
            raise ValueError(
                f"objective {self.name!r}: quantile must be in (0, 1), "
                f"got {self.quantile}")
        if self.burn_threshold is not None and self.burn_threshold <= 0:
            raise ValueError(
                f"objective {self.name!r}: burn_threshold must be > 0, "
                f"got {self.burn_threshold}")


@dataclass(frozen=True)
class SLOConfig:
    """A set of objectives plus the shared burn-window geometry.

    ``fast_window_s``/``slow_window_s`` are the two burn horizons (the
    fast one decides responsiveness AND recovery; the slow one guards
    against alerting on a blip). ``burn_threshold`` is the default
    both windows must reach for a breach. ``eval_interval_s`` paces
    how often the dispatcher samples the signal bus and re-evaluates
    (it is a ceiling on detection latency, not a timer — evaluation
    rides the dispatch loop). ``max_samples`` bounds each stream's
    memory."""

    objectives: Tuple[Objective, ...]
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 2.0
    eval_interval_s: float = 1.0
    max_samples: int = 4096

    def __post_init__(self):
        object.__setattr__(self, "objectives", tuple(self.objectives))
        if not self.objectives:
            raise ValueError("SLOConfig needs at least one objective")
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        if not 0 < self.fast_window_s < self.slow_window_s:
            raise ValueError(
                f"need 0 < fast_window_s < slow_window_s, got "
                f"{self.fast_window_s} / {self.slow_window_s}")
        if self.burn_threshold <= 0 or self.eval_interval_s <= 0:
            raise ValueError(
                f"burn_threshold and eval_interval_s must be > 0, got "
                f"{self.burn_threshold} / {self.eval_interval_s}")
        if self.max_samples < 8:
            raise ValueError(
                f"max_samples must be >= 8, got {self.max_samples}")

    @staticmethod
    def serving(*, ttft_p99_s: Optional[float] = None,
                itl_p99_s: Optional[float] = None,
                error_rate: Optional[float] = None,
                shed_rate: Optional[float] = None,
                itl_burn_threshold: Optional[float] = None,
                **kwargs) -> "SLOConfig":
        """The standard serving objective set with disaggregated-pool
        attribution baked in (DistServe's goodput axes): TTFT p99 is a
        PREFILL-pool promise (queue + admission + prefill), ITL p99 a
        DECODE-pool one (steady token cadence), error/shed rates
        fleet-wide. Pass only the objectives you promise; extra
        ``kwargs`` go to :class:`SLOConfig` (windows, threshold...)."""
        objectives: List[Objective] = []
        if ttft_p99_s is not None:
            objectives.append(Objective(
                "ttft_p99", stream="ttft", kind=LATENCY,
                target=float(ttft_p99_s), quantile=0.99, pool="prefill",
                description="time to first token, p99"))
        if itl_p99_s is not None:
            objectives.append(Objective(
                "itl_p99", stream="itl", kind=LATENCY,
                target=float(itl_p99_s), quantile=0.99, pool="decode",
                burn_threshold=itl_burn_threshold,
                description="inter-token latency, p99"))
        if error_rate is not None:
            objectives.append(Objective(
                "error_rate", stream="error", kind=RATE,
                target=float(error_rate), pool="any",
                description="fraction of requests finishing in error"))
        if shed_rate is not None:
            objectives.append(Objective(
                "shed_rate", stream="shed", kind=RATE,
                target=float(shed_rate), pool="any",
                description="fraction of submits shed typed"))
        return SLOConfig(objectives=tuple(objectives), **kwargs)


class _Stream:
    """One bounded rolling observation buffer: (t, value) pairs kept
    for at most the slow window (time) and ``max_samples`` (count)."""

    __slots__ = ("horizon_s", "_buf")

    def __init__(self, horizon_s: float, max_samples: int):
        self.horizon_s = float(horizon_s)
        self._buf: "deque[Tuple[float, float]]" = deque(
            maxlen=int(max_samples))

    def add(self, t: float, v: float) -> None:
        self._buf.append((float(t), float(v)))

    def trim(self, now: float) -> None:
        edge = now - self.horizon_s
        while self._buf and self._buf[0][0] < edge:
            self._buf.popleft()

    def since(self, edge: float) -> List[float]:
        return [v for t, v in self._buf if t >= edge]

    def truncated(self, edge: float) -> bool:
        """Count-bound truncation: the buffer is full and its oldest
        retained sample is newer than ``edge`` — the configured slow
        window is no longer fully covered at the current observation
        rate, so burn_slow degrades toward burn_fast."""
        return (len(self._buf) == self._buf.maxlen
                and self._buf[0][0] > edge)


def burn_rate(objective: Objective, values: List[float]) -> float:
    """Budget-spend speed over one window's observations (module
    docstring). Empty windows burn 0.0 — zero traffic is compliant,
    never NaN."""
    if not values:
        return 0.0
    if objective.kind == LATENCY:
        frac_bad = (sum(1 for v in values if v > objective.target)
                    / len(values))
        return frac_bad / (1.0 - objective.quantile)
    return (sum(values) / len(values)) / objective.target


class SLOEngine:
    """Continuous multi-window burn-rate evaluation over observation
    streams (module docstring). Thread-safe: the dispatcher observes
    from reader threads and evaluates from its dispatch loop while
    the front door snapshots ``status()``."""

    def __init__(self, config: SLOConfig, *,
                 clock: Callable[[], float] = time.monotonic,
                 events=None):
        self.config = config
        self.clock = clock
        self.events = events
        self._lock = threading.Lock()
        self._streams: Dict[str, _Stream] = {
            o.stream: _Stream(config.slow_window_s, config.max_samples)
            for o in config.objectives}
        self._breaching: Dict[str, bool] = {
            o.name: False for o in config.objectives}
        self._breaches_total: Dict[str, int] = {
            o.name: 0 for o in config.objectives}
        self._burn_fast_peak: Dict[str, float] = {
            o.name: 0.0 for o in config.objectives}

    # ---- observing --------------------------------------------------
    def observe(self, stream: str, value: float) -> None:
        """One observation into ``stream`` (seconds for latency
        streams, 0/1 for rate streams). Streams no objective binds are
        ignored — call sites never need to know the active config."""
        s = self._streams.get(stream)
        if s is None:
            return
        with self._lock:
            s.add(self.clock(), value)

    # ---- evaluating -------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> Dict:
        """Re-derive every objective's fast/slow burn and drive the
        breach state machine; emits ``slo_breach``/``slo_recovered``
        lifecycle events on edges. Returns (and caches) the status
        dict ``status()`` serves."""
        cfg = self.config
        edges: List[Tuple[str, Dict]] = []
        truncated: List[str] = []
        with self._lock:
            if now is None:
                now = self.clock()
            for name, s in self._streams.items():
                s.trim(now)
                if s.truncated(now - cfg.slow_window_s):
                    truncated.append(name)
            objectives: Dict[str, Dict] = {}
            for o in cfg.objectives:
                stream = self._streams[o.stream]
                slow = stream.since(now - cfg.slow_window_s)
                fast = stream.since(now - cfg.fast_window_s)
                bf = burn_rate(o, fast)
                bs = burn_rate(o, slow)
                self._burn_fast_peak[o.name] = max(
                    self._burn_fast_peak[o.name], bf)
                thr = (o.burn_threshold if o.burn_threshold is not None
                       else cfg.burn_threshold)
                was = self._breaching[o.name]
                # enter: BOTH windows burning (fast alone = spike,
                # slow alone = stale); leave: the fast window — the
                # freshest evidence — dropped back under the threshold
                breaching = (bf >= thr if was
                             else (bf >= thr and bs >= thr))
                if breaching and not was:
                    self._breaches_total[o.name] += 1
                self._breaching[o.name] = breaching
                st = {"breaching": breaching,
                      "burn_fast": round(bf, 4),
                      "burn_slow": round(bs, 4),
                      "burn_fast_peak": round(
                          self._burn_fast_peak[o.name], 4),
                      "burn_threshold": thr,
                      "target": o.target, "kind": o.kind,
                      "quantile": o.quantile if o.kind == LATENCY
                      else None,
                      "pool": o.pool,
                      "n_fast": len(fast), "n_slow": len(slow),
                      "breaches_total": self._breaches_total[o.name]}
                objectives[o.name] = st
                if breaching != was:
                    edges.append((
                        "slo_breach" if breaching else "slo_recovered",
                        {"objective": o.name, "pool": o.pool,
                         "objective_kind": o.kind, "target": o.target,
                         "burn_fast": round(bf, 4),
                         "burn_slow": round(bs, 4),
                         "burn_threshold": thr}))
            status = {
                "objectives": objectives,
                "breaching": sorted(n for n, st in objectives.items()
                                    if st["breaching"]),
                "fast_window_s": cfg.fast_window_s,
                "slow_window_s": cfg.slow_window_s,
                "burn_threshold": cfg.burn_threshold,
                "evaluated_at": now,
            }
        # warnings/events OUTSIDE the engine lock (each has its own)
        for name in truncated:
            # silent truncation would quietly collapse the anti-flap
            # gate: with less than slow_window_s of history the slow
            # burn reads the same recent samples as the fast one
            log_once(_log, f"slo stream {name!r}: max_samples="
                     f"{cfg.max_samples} holds less than slow_window_s"
                     f"={cfg.slow_window_s}s of history at the current "
                     f"observation rate — the slow burn window is "
                     f"effectively shorter (size max_samples >= "
                     f"expected samples/s x slow_window_s)")
        if self.events is not None:
            for kind, attrs in edges:
                self.events.emit(kind, **attrs)
        return status

    def status(self) -> Dict:
        """The freshest judgment (evaluates on demand — always
        current, always NaN-free)."""
        return self.evaluate()

    def breaching(self) -> List[str]:
        return self.status()["breaching"]
