"""Flight recorder: per-request tracing, step timelines, Prometheus
export, and crash-dump forensics for the serving stack.

The serving tier (serve/engine.py, fleet/) composes seven interacting
mechanisms — prefix cache, speculation, chunked prefill, LoRA
batching, quantized KV, deadlines, cross-process migration — but until
this package could only report END-OF-RUN aggregates
(``ServeMetrics.summary()``): they say a tail regressed, never which
step stalled or why one request's tokens were slow. Iteration-level
scheduling (Orca) makes the ENGINE STEP the natural unit of
observation, and Sarathi-Serve's whole argument is about per-step
interference between prefill and decode — so that is what gets
recorded:

- :mod:`trace`    — per-request spans under one trace id from front
  door to finish: queue wait, admission (with the AdmitPlan outcome),
  every prefill chunk, every decode/verify step the request rode,
  preemption, deadline retirement, and — across the fleet wire —
  export/migration/restore, so one trace shows a request's life across
  processes;
- :mod:`recorder` — a bounded ring buffer of per-step engine records
  (phase mix, occupancy, KV pressure, chunk budget spent, speculation
  acceptance, per-step wall time via the injectable clock) — the
  flight recorder proper; ``tools/trace_view.py`` renders it as
  Chrome trace-event JSON loadable in Perfetto;
- :mod:`events`   — typed structured fleet lifecycle events (death,
  stall, breaker transitions, migration, restart, shed, drain) as an
  in-memory ring + optional JSONL sink;
- :mod:`prom`     — Prometheus text exposition over the EXISTING
  ledgers (FleetMetrics + per-replica ServeMetrics summaries), served
  by the front door's ``GET /metrics``;
- :mod:`crashdump` — the black box: on replica death/stall the
  dispatcher dumps the corpse's last-known step ring plus the affected
  requests' spans (and the last pool-pressure snapshot) to a bounded
  post-mortem JSON file;
- :mod:`slo`      — the judgment layer: declarative objectives (TTFT
  p99, ITL p99, error/shed rate) evaluated as SRE-style multi-window
  burn rates with per-pool attribution, typed
  ``slo_breach``/``slo_recovered`` lifecycle events;
- :mod:`signals`  — the pool-pressure signal plane: EWMA-smoothed
  per-pool gauges sampled on the dispatcher thread, plus the
  OBSERVE-ONLY ``PoolRebalancePlanner`` emitting typed
  ``rebalance_recommended`` events — the contract the elastic-sizing
  autoscaler will actuate.

The hard guarantee, engine-wide: **observation is inert**. Tracing on
is token-BIT-identical to tracing off (greedy and sampled, all
features composed), adds no device work (nothing in this package
imports torch), and never blocks the step loop — every hook reads
host-side state the engine already holds: no ``.item()``, ``.cpu()``
or ``.tolist()`` of a device tensor and no ``synchronize()`` for a span
or a step record, so the device operations and device-to-host copies of
a step are the same with it on and off (tests/test_torch_obs.py; on
the card ``chip_smoke.py``'s serve_fleet phase counts them).

Port of ``quintnet_tpu/obs/`` (standard library only; the modules,
names and formats are the JAX package's, so an exposition, a crash
dump or a trace export reads the same from either).
"""

from quintnet_tpu_torch.obs.crashdump import load_crash_dump, write_crash_dump
from quintnet_tpu_torch.obs.events import EVENT_KINDS, EventLog
from quintnet_tpu_torch.obs.prom import parse_exposition, render_exposition
from quintnet_tpu_torch.obs.recorder import StepRecord, StepRecorder
from quintnet_tpu_torch.obs.signals import (SIGNALS, Ewma,
                                      PoolRebalancePlanner, SignalBus)
from quintnet_tpu_torch.obs.slo import Objective, SLOConfig, SLOEngine
from quintnet_tpu_torch.obs.trace import SPAN_NAMES, Span, Tracer

__all__ = [
    "EVENT_KINDS",
    "EventLog",
    "Ewma",
    "Objective",
    "PoolRebalancePlanner",
    "SIGNALS",
    "SLOConfig",
    "SLOEngine",
    "SPAN_NAMES",
    "SignalBus",
    "Span",
    "StepRecord",
    "StepRecorder",
    "Tracer",
    "load_crash_dump",
    "parse_exposition",
    "render_exposition",
    "write_crash_dump",
]
