"""Prometheus text exposition over the serving ledgers.

The fleet already keeps every number an operator wants —
``FleetMetrics.summary()`` at the front door, ``ServeMetrics.summary()``
per replica engine (shipped over the process fleet's stats frame) —
as nested JSON-able dicts. This module renders those dicts in the
Prometheus text exposition format (version 0.0.4: ``# HELP`` /
``# TYPE`` comments, ``name{label="v"} value`` samples) so
``GET /metrics`` on the front door turns every existing ledger into a
scrapeable time series without inventing a second accounting path.

Flattening rules (mechanical, so new ledger fields become metrics with
zero code changes here):

- numeric scalars at the top level -> one sample,
  ``quintnet_fleet_<key>`` (front door) or
  ``quintnet_engine_<key>{replica="<name>"}`` (per-replica engines);
- percentile dicts (``{"p50": .., "p95": .., "p99": .., "n": ..}``) ->
  one sample per quantile with a ``quantile`` label, plus a
  ``<key>_count`` sample from ``n`` when present;
- the per-adapter ledger -> per-adapter-labeled samples of its numeric
  fields;
- non-numeric leaves (state strings, nested config) are skipped —
  exposition carries numbers; states ride /healthz and /v1/metrics.

Counters vs gauges follow the source ledger's own semantics: monotone
totals (``finished``, ``*_tokens``, ``steps``…) are counters,
instantaneous readings (queue depth, utilization, percentiles) gauges.
Unknown fields default to gauge — wrong-but-scrapeable beats dropped.

:func:`parse_exposition` is the round-trip validator: a small strict
parser of the same format, used by the tests (and usable against any
exposition text) so "parses as Prometheus text exposition" is checked
by actual parsing, not a regex squint.

Port of ``quintnet_tpu/obs/prom.py`` (standard library only).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Tuple

# source-ledger fields that are monotone totals (everything else is
# exposed as a gauge)
_COUNTER_KEYS = frozenset({
    "steps", "gen_tokens", "admitted", "finished", "preempted",
    "deadline_exceeded", "prefill_tokens", "decode_tokens",
    "prefix_hit_tokens", "prefill_tokens_saved", "decode_steps",
    "spec_steps", "draft_tokens", "accepted_draft_tokens",
    "prefill_chunks", "chunk_steps", "chunk_tokens", "submitted",
    "accepted", "shed", "shed_queue_full", "shed_deadline",
    "shed_shutdown", "migrations", "replica_deaths", "stalls",
    "restarts", "requests", "tokens_delivered",
    # tiered KV (serve/kv_tier.py): host_tier_bytes stays a gauge
    "kv_cache_evictions", "kv_demotions", "kv_promotions",
    "kv_host_evictions", "host_hit_tokens", "decode_blocked_demotions",
    "tier_probes", "tier_peer_transfers", "tier_peer_fallbacks",
    # MoE routing ledger (serve/metrics.py): drop_rate/skew/entropy
    # stay gauges
    "moe_routed_tokens", "moe_dropped_tokens",
})

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(prefix: str, key: str) -> str:
    return _NAME_RE.sub("_", f"{prefix}_{key}")


def _esc(v) -> str:
    """Label-value escaping per the text format: backslash first (or
    it would re-escape the others), then quote and newline — a label
    value with any of the three still renders as ONE well-formed
    line."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _is_pct_dict(v) -> bool:
    return (isinstance(v, dict) and v
            and all(k in ("p50", "p95", "p99", "n") for k in v))


class _Builder:
    """Accumulates samples grouped by metric name so each name gets
    exactly one HELP/TYPE header no matter how many label sets sample
    it (one header per name is what the format requires)."""

    def __init__(self):
        self._order: List[str] = []
        self._meta: Dict[str, Tuple[str, str]] = {}   # name -> (type, help)
        self._samples: Dict[str, List[str]] = {}

    def add(self, name: str, value, *, labels=None,
            mtype: str = "gauge", help_: str = "") -> None:
        if not math.isfinite(float(value)):
            # never serve NaN/Inf: Prometheus stores NaN as a real
            # sample and it poisons every rate()/avg() downstream —
            # an absent sample is honest, a non-finite one is a trap
            return
        if name not in self._meta:
            self._order.append(name)
            self._meta[name] = (mtype, help_)
            self._samples[name] = []
        self._samples[name].append(
            f"{name}{_fmt_labels(labels)} {float(value):g}")

    def render(self) -> str:
        lines: List[str] = []
        for name in self._order:
            mtype, help_ = self._meta[name]
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {mtype}")
            lines.extend(self._samples[name])
        return "\n".join(lines) + "\n"


def _add_summary(b: _Builder, prefix: str, summary: Dict,
                 labels: Optional[Dict[str, str]] = None) -> None:
    for key, v in summary.items():
        if key == "adapters" and isinstance(v, dict):
            for aid, d in sorted(v.items()):
                al = dict(labels or {}, adapter=aid)
                _add_summary(b, f"{prefix}_adapter", d, labels=al)
            continue
        if key == "moe_expert_tokens" and isinstance(v, dict):
            # per-expert cumulative routed demand ({expert id ->
            # count}, serve/metrics.py) -> one counter family labeled
            # by expert — the per-expert utilization series a
            # hot-expert dashboard plots
            name = _metric_name(prefix, key)
            for eid, count in sorted(v.items(),
                                     key=lambda kv: int(kv[0])):
                b.add(name, count,
                      labels=dict(labels or {}, expert=str(eid)),
                      mtype="counter",
                      help_="token-expert assignments routed to this "
                            "expert (pre-capacity-cut demand)")
            continue
        if _is_pct_dict(v):
            name = _metric_name(prefix, key)
            for q in ("p50", "p95", "p99"):
                if q in v:
                    b.add(name, v[q],
                          labels=dict(labels or {}, quantile=q))
            if "n" in v:
                b.add(name + "_count", v["n"], labels=labels,
                      mtype="counter",
                      help_="observations behind the quantiles "
                            "(reservoir-capped source)")
            continue
        if isinstance(v, bool):
            b.add(_metric_name(prefix, key), int(v), labels=labels)
            continue
        if isinstance(v, (int, float)):
            mtype = "counter" if key in _COUNTER_KEYS else "gauge"
            b.add(_metric_name(prefix, key), v, labels=labels,
                  mtype=mtype)
        # strings / nested non-percentile dicts: not exposition material


def _add_slo(b: _Builder, status: Dict) -> None:
    """The SLO engine's judgment (obs/slo.py ``status()``) as the
    ``quintnet_slo_*`` families: per-objective burn rates (fast/slow
    window label), the breach bit, target, and breach counter — all
    labeled with the objective's pool attribution so a dashboard can
    say WHICH pool is burning budget."""
    for name, st in sorted(status.get("objectives", {}).items()):
        labels = {"objective": name, "pool": st.get("pool", "any")}
        for window in ("fast", "slow"):
            b.add("quintnet_slo_burn_rate", st[f"burn_{window}"],
                  labels=dict(labels, window=window),
                  help_="error-budget spend speed over the window "
                        "(1.0 = exactly on budget)")
        b.add("quintnet_slo_breaching", 1 if st["breaching"] else 0,
              labels=labels,
              help_="1 while fast+slow burn windows are both tripped")
        b.add("quintnet_slo_target", st["target"], labels=labels)
        b.add("quintnet_slo_burn_threshold", st["burn_threshold"],
              labels=labels)
        b.add("quintnet_slo_breaches_total", st["breaches_total"],
              labels=labels, mtype="counter",
              help_="breach lifecycle events since start")


def _add_pressure(b: _Builder, gauges: Dict[str, Dict[str, Dict]]
                  ) -> None:
    """The signal bus (obs/signals.py ``gauges()``) as
    ``quintnet_pool_pressure_*`` families: one family per signal,
    labeled by pool, EWMA-smoothed value (the raw last sample rides a
    ``stat="last"`` twin)."""
    for name, pools in sorted(gauges.items()):
        metric = _metric_name("quintnet_pool_pressure", name)
        for pool, g in sorted(pools.items()):
            b.add(metric, g["ewma"],
                  labels={"pool": pool, "stat": "ewma"},
                  help_="dispatcher-sampled pool pressure signal "
                        "(obs/signals.py)")
            b.add(metric, g["last"], labels={"pool": pool,
                                             "stat": "last"})


def _add_locks(b: _Builder, summary: Dict) -> None:
    """The lock-audit ledgers (analysis/lockrt.py ``LockAudit.
    summary()``) as the ``quintnet_lock_*`` families: per-lock
    acquisition/contention/wait/hold counters labeled by lock name,
    plus the order graph's edge count and the violations-observed
    counter — the scrapeable face of ``lock_audit=True``."""
    b.add("quintnet_lock_order_edges", summary.get("order_edges", 0),
          help_="distinct acquired-A-then-B orderings observed")
    b.add("quintnet_lock_order_violations_total",
          summary.get("order_violations", 0), mtype="counter",
          help_="lock-order inversions caught (each also raised a "
                "LockOrderError and emitted a lock_order_violation "
                "event)")
    for name, led in sorted(summary.get("locks", {}).items()):
        labels = {"lock": name}
        b.add("quintnet_lock_acquisitions_total",
              led.get("acquisitions", 0), labels=labels,
              mtype="counter",
              help_="times this lock was acquired")
        b.add("quintnet_lock_contended_total",
              led.get("contended", 0), labels=labels, mtype="counter",
              help_="acquisitions that had to block (first try failed)")
        b.add("quintnet_lock_wait_seconds_total",
              led.get("wait_s", 0.0), labels=labels, mtype="counter",
              help_="cumulative time spent blocked acquiring")
        b.add("quintnet_lock_hold_seconds_total",
              led.get("hold_s", 0.0), labels=labels, mtype="counter",
              help_="cumulative time held")
        b.add("quintnet_lock_max_hold_seconds",
              led.get("max_hold_s", 0.0), labels=labels,
              help_="longest single hold observed")
        b.add("quintnet_lock_held_too_long_total",
              led.get("held_too_long", 0), labels=labels,
              mtype="counter",
              help_="holds that exceeded the audit's hold budget")


def render_exposition(frontdoor_summary: Dict,
                      engine_summaries: Optional[Dict[str, Dict]] = None,
                      *, health: Optional[Dict] = None,
                      slo: Optional[Dict] = None,
                      pressure: Optional[Dict] = None,
                      locks: Optional[Dict] = None) -> str:
    """The front door's ``GET /metrics`` body: fleet counters as
    ``quintnet_fleet_*``, each replica engine's summary as
    ``quintnet_engine_*{replica="<name>"}``, (when ``health`` is
    given) per-replica liveness/heartbeat/breaker gauges plus queue
    depth, (when ``slo`` is given) the ``quintnet_slo_*`` burn-rate
    families, (when ``pressure`` is given) the
    ``quintnet_pool_pressure_*`` signal-bus gauges, and (when
    ``locks`` is given — a ``LockAudit.summary()`` from a
    ``lock_audit=True`` fleet) the ``quintnet_lock_*`` families."""
    b = _Builder()
    _add_summary(b, "quintnet_fleet", frontdoor_summary)
    for name, summary in sorted((engine_summaries or {}).items()):
        _add_summary(b, "quintnet_engine", summary,
                     labels={"replica": name})
    if health:
        for name, r in sorted(health.get("replicas", {}).items()):
            b.add("quintnet_replica_up",
                  1 if r.get("state") == "healthy" else 0,
                  labels={"replica": name},
                  help_="1 while the replica is a dispatch candidate")
            # heartbeat staleness + breaker state were in health()
            # but invisible to a scraper until now: the staleness
            # gauge is the stall-detector's own input, the breaker a
            # one-hot state family (the Prometheus enum idiom)
            if "heartbeat_age_s" in r:
                b.add("quintnet_replica_heartbeat_age_s",
                      r["heartbeat_age_s"], labels={"replica": name},
                      help_="seconds since the replica's last "
                            "heartbeat (stall budget input)")
            if r.get("breaker"):
                for state in ("closed", "open", "half_open"):
                    b.add("quintnet_replica_breaker_state",
                          1 if r["breaker"] == state else 0,
                          labels={"replica": name, "state": state},
                          help_="circuit-breaker state, one-hot")
        for key in ("queue_depth", "open_requests",
                    "queue_oldest_wait_s"):
            # summary() carries the queue gauges since the signal
            # plane landed — only fall back to health() for fleets
            # whose summary lacks them, never emit the same series
            # twice (a duplicate name+labels line is off the format
            # and a real scraper rejects the whole body)
            if key in health and key not in (frontdoor_summary or {}):
                b.add(_metric_name("quintnet_fleet", key), health[key])
    if slo:
        _add_slo(b, slo)
    if pressure:
        _add_pressure(b, pressure)
    if locks:
        _add_locks(b, locks)
    return b.render()


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|\d*\.\d+"
    r"(?:[eE][-+]?\d+)?|[Nn]a[Nn]|[-+]?[Ii]nf))\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESC_RE = re.compile(r"\\(.)")


def _unesc(raw: str, lineno: int) -> str:
    """Undo label-value escaping (the exact inverse of :func:`_esc`).
    An escape sequence outside the format's vocabulary (``\\\\``,
    ``\\"``, ``\\n``) is rejected — a renderer that emits one is off
    the format, and this parser is the CI gate that says so."""
    def sub(m):
        c = m.group(1)
        if c == "n":
            return "\n"
        if c in ('"', "\\"):
            return c
        raise ValueError(
            f"line {lineno}: invalid escape \\{c} in label value")
    return _UNESC_RE.sub(sub, raw)


def parse_exposition(text: str) -> Dict[Tuple[str, Tuple], float]:
    """Strict parser of the text exposition format. Returns
    ``{(name, ((label, value), ...)): float}`` with label values
    UNescaped; raises ValueError on any line that is neither a
    comment, blank, nor a well-formed sample — and on non-finite
    sample values and malformed escapes, which the renderer never
    emits — the test-side proof that what /metrics serves IS the
    format, not something shaped like it."""
    out: Dict[Tuple[str, Tuple], float] = {}
    typed: set = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                if parts[2] in typed:
                    raise ValueError(
                        f"line {lineno}: duplicate TYPE for "
                        f"{parts[2]!r}")
                typed.add(parts[2])
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(
                f"line {lineno} is not a valid exposition sample: "
                f"{line!r}")
        value = float(m.group("value"))
        if not math.isfinite(value):
            # the format itself allows NaN/Inf tokens, but OUR
            # renderer never emits them (non-finite readings are
            # dropped at the builder) — an exposition carrying one
            # means a second, unguarded accounting path leaked in
            raise ValueError(
                f"line {lineno}: non-finite sample value "
                f"{m.group('value')!r} (the renderer drops these; "
                f"see _Builder.add)")
        labels: Tuple = ()
        if m.group("labels"):
            labels = tuple(sorted(
                (k, _unesc(v, lineno))
                for k, v in _LABEL_RE.findall(m.group("labels"))))
        key = (m.group("name"), labels)
        if key in out:
            # one line per unique name+labels is a format requirement;
            # a duplicate means two accounting paths rendered the same
            # series and Prometheus would reject the whole scrape
            raise ValueError(
                f"line {lineno}: duplicate sample for {key}")
        out[key] = value
    return out


def sample(parsed: Dict, name: str, **labels) -> float:
    """Test helper: look up one sample by name + exact label set."""
    key = (name, tuple(sorted(labels.items())))
    if key not in parsed:
        have = sorted(k for k in parsed if k[0] == name)
        raise KeyError(f"no sample {key}; have {have}")
    return parsed[key]


def iter_samples(parsed: Dict, name: str) -> Iterable[Tuple[Tuple, float]]:
    for (n, labels), v in parsed.items():
        if n == name:
            yield labels, v
