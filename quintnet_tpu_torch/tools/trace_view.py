"""Render flight-recorder output as Chrome trace-event JSON (loadable
in Perfetto / chrome://tracing).

Input is any JSON file carrying a step ring and/or request spans in
the obs formats (quintnet_tpu/obs/):

- a crash dump (``obs/crashdump.py``: ``{"kind": "crash_dump",
  "ring": [...], "traces": {...}}``) — the post-mortem, visualized;
- a raw obs dump (``{"ring": [...], "traces": {...}}``) — what
  ``tools/serve_bench.py --trace-out`` writes from a timed replay.

Mapping (the Chrome trace-event format, JSON Array/Object flavor):

- each engine STEP becomes a complete ("ph": "X") slice on the
  "engine steps" thread — duration = the step's clock window, args =
  the step's phase mix / occupancy / KV pressure / chunk + spec
  ledgers, so the Perfetto timeline shows exactly the prefill/decode
  interference Sarathi argues about;
- each request SPAN becomes an async begin/end pair ("ph": "b"/"e",
  id = trace id) on the "requests" track, instants (t1 == t0) become
  instant events ("ph": "i") — one row per request from queue to
  finish, migrations included (the id stitches cross-process spans);
- each fleet LIFECYCLE EVENT (obs/events.py — crash dumps embed the
  recent ring) becomes an instant marker ("ph": "i") on the "fleet
  events" track. SLO-judgment events (``slo_breach`` /
  ``slo_recovered`` / ``rebalance_recommended``, obs/slo.py +
  obs/signals.py) are scoped GLOBAL ("s": "g") so Perfetto draws a
  full-height line: "the fast+slow burn windows tripped HERE" and
  "the planner recommended decode→prefill HERE" line up visually
  against the step slices that caused them.

Timestamps are microseconds (the format's unit), re-based to the
earliest event so Perfetto opens at t=0 instead of hours into a
monotonic clock.

Usage:
  python -m quintnet_tpu_torch.tools.trace_view DUMP.json -o trace.json
  python -m quintnet_tpu_torch.tools.trace_view DUMP.json       # stdout

Library surface: :func:`chrome_trace` (dict in, dict out — the bench
and tests call this), :func:`validate_chrome_trace` (structural check
used by CI so the export can never drift off-format).

Port of ``tools/trace_view.py`` at the repository's root (standard
library only).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

_US = 1e6

# pid/tid are display coordinates in the trace-event format; one
# process row with named threads reads best in Perfetto
PID = 1
TID_STEPS = 1
TID_REQUESTS = 2
TID_EVENTS = 3

# fleet events drawn as FULL-HEIGHT markers ("s": "g"): the SLO
# judgment layer's output, which the reader wants to line up against
# every track at once. Everything else stays a thread-local tick.
_GLOBAL_EVENT_KINDS = frozenset({
    "slo_breach", "slo_recovered", "rebalance_recommended",
})


def _base_ts(ring: List[Dict], traces: Dict[str, List[Dict]],
             fleet_events: Optional[List[Dict]] = None) -> float:
    ts = [r["t0"] for r in ring]
    ts += [s["t0"] for spans in traces.values() for s in spans]
    ts += [e["ts"] for e in (fleet_events or []) if "ts" in e]
    return min(ts) if ts else 0.0


def chrome_trace(ring: Optional[List[Dict]] = None,
                 traces: Optional[Dict[str, List[Dict]]] = None,
                 fleet_events: Optional[List[Dict]] = None,
                 *, label: str = "quintnet-serve") -> Dict:
    """Build the Chrome trace-event JSON object (see module
    docstring). ``ring``: StepRecorder.snapshot(); ``traces``:
    Tracer.snapshot(); ``fleet_events``: EventLog.snapshot() (what a
    crash dump's ``events`` field carries)."""
    ring = ring or []
    traces = traces or {}
    fleet_events = fleet_events or []
    t_base = _base_ts(ring, traces, fleet_events)
    events: List[Dict] = [
        {"ph": "M", "pid": PID, "name": "process_name",
         "args": {"name": label}},
        {"ph": "M", "pid": PID, "tid": TID_STEPS, "name": "thread_name",
         "args": {"name": "engine steps"}},
        {"ph": "M", "pid": PID, "tid": TID_REQUESTS,
         "name": "thread_name", "args": {"name": "requests"}},
        {"ph": "M", "pid": PID, "tid": TID_EVENTS,
         "name": "thread_name", "args": {"name": "fleet events"}},
    ]
    for rec in ring:
        args = {k: v for k, v in rec.items()
                if k not in ("t0", "t1", "attrs")}
        args.update(rec.get("attrs") or {})
        events.append({
            "name": f"step {rec.get('step', '?')}",
            "cat": "engine", "ph": "X",
            "ts": (rec["t0"] - t_base) * _US,
            "dur": max(rec["t1"] - rec["t0"], 0.0) * _US,
            "pid": PID, "tid": TID_STEPS, "args": args,
        })
    for trace_id, spans in sorted(traces.items()):
        for s in spans:
            common = {"cat": "request", "id": trace_id, "pid": PID,
                      "tid": TID_REQUESTS,
                      "args": dict(s.get("attrs") or {})}
            t0 = (s["t0"] - t_base) * _US
            if s["t1"] > s["t0"]:
                events.append({"name": s["name"], "ph": "b",
                               "ts": t0, **common})
                events.append({"name": s["name"], "ph": "e",
                               "ts": (s["t1"] - t_base) * _US,
                               **common})
            else:
                # instant: scope "t" (thread) keeps it a tick mark
                events.append({"name": s["name"], "ph": "i", "s": "t",
                               "ts": t0, **common})
    for e in fleet_events:
        if "ts" not in e or "kind" not in e:
            continue        # not an EventLog record; skip, don't guess
        kind = e["kind"]
        name = kind
        args = {k: v for k, v in e.items()
                if k not in ("ts", "seq", "kind")}
        if kind == "slo_breach":
            # the marker label carries the judgment: which objective,
            # which pool, how hard it is burning
            name = (f"slo_breach {args.get('objective', '?')} "
                    f"[{args.get('pool', '?')}] "
                    f"{args.get('burn_fast', 0):.1f}x")
        elif kind == "rebalance_recommended":
            name = (f"rebalance {args.get('direction', '?')}"
                    + (" (revert)" if args.get("revert") else ""))
        events.append({
            "name": name, "cat": "fleet", "ph": "i",
            "s": "g" if kind in _GLOBAL_EVENT_KINDS else "t",
            "ts": (e["ts"] - t_base) * _US,
            "pid": PID, "tid": TID_EVENTS, "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"source": label}}


def validate_chrome_trace(obj: Dict) -> int:
    """Structural validation of a trace-event JSON object; returns the
    event count. Raises ValueError on anything Perfetto would choke
    on — the CI gate behind 'the export validates as Chrome
    trace-event JSON'."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a trace-event object: no 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    open_async: Dict = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not an object")
        ph = e.get("ph")
        if ph is None or "pid" not in e or "name" not in e:
            raise ValueError(
                f"event {i} is missing ph/pid/name: {e}")
        if ph == "M":
            continue
        if "ts" not in e or not isinstance(e["ts"], (int, float)):
            raise ValueError(f"event {i} has no numeric ts: {e}")
        if ph == "X":
            if "dur" not in e or e["dur"] < 0:
                raise ValueError(
                    f"complete event {i} needs a dur >= 0: {e}")
        elif ph in ("b", "e"):
            if "id" not in e or "cat" not in e:
                raise ValueError(
                    f"async event {i} needs id + cat: {e}")
            key = (e["cat"], e["id"], e["name"])
            if ph == "b":
                open_async[key] = open_async.get(key, 0) + 1
            else:
                if open_async.get(key, 0) < 1:
                    raise ValueError(
                        f"async end without begin at event {i}: {e}")
                open_async[key] -= 1
        elif ph == "i":
            if e.get("s") not in (None, "t", "p", "g"):
                raise ValueError(
                    f"instant event {i} has invalid scope: {e}")
        else:
            raise ValueError(f"event {i} has unknown ph {ph!r}")
    dangling = {k: v for k, v in open_async.items() if v}
    if dangling:
        raise ValueError(f"unbalanced async begin/end: {dangling}")
    return len(events)


def _load_dump(path: str) -> Dict:
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict):
        raise SystemExit(f"{path}: expected a JSON object")
    if ("ring" not in payload and "traces" not in payload
            and "events" not in payload):
        raise SystemExit(
            f"{path}: no 'ring', 'traces' or 'events' — not a crash "
            f"dump or obs dump (tools/serve_bench.py --trace-out "
            f"writes one)")
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace_view",
        description="crash dump / obs dump -> Chrome trace-event JSON "
                    "(Perfetto)")
    ap.add_argument("dump", help="crash-dump or obs-dump JSON file")
    ap.add_argument("-o", "--out", default=None,
                    help="output file (default: stdout)")
    args = ap.parse_args(argv)

    payload = _load_dump(args.dump)
    label = payload.get("replica") or "quintnet-serve"
    trace = chrome_trace(payload.get("ring"), payload.get("traces"),
                         payload.get("events"), label=label)
    validate_chrome_trace(trace)
    text = json.dumps(trace, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {len(trace['traceEvents'])} events to "
              f"{args.out}", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
