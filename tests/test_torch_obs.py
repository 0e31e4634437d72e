"""The port's observability (``quintnet_tpu_torch/obs/``, the engine's
``tracer`` and ``recorder`` hooks, ``tools/trace_view.py``) against the
JAX package.

THE contract is inertness, JAX's (``tests/test_obs.py``): arming the
tracer and the step recorder changes nothing the engine computes —
tracing on is token-bit-identical to tracing off, greedy and sampled,
with the prefix cache, speculation, chunked prefill, LoRA and int8 KV
composed. The pure modules are copies of JAX's: driven through the same
call sequences under fake clocks they give JAX's spans, rings, events,
burn rates, signal gauges, crash dumps, Chrome traces and Prometheus text
(byte for byte). The port engine's ``StepRecord`` stream and spans on a
greedy script equal the JAX engine's field by field (the clock fields
aside).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import quintnet_tpu.obs as jobs
import tools.trace_view as jtrace_view
from quintnet_tpu.fleet.fleet import FleetMetrics as JaxFleetMetrics
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.obs.recorder import StepRecord as JaxStepRecord
from quintnet_tpu.obs.signals import PoolRebalancePlanner as JaxPlanner
from quintnet_tpu.obs.signals import SignalBus as JaxSignalBus
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu_torch import obs
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.fleet.fleet import FleetMetrics
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.models.lora import LoRAConfig, lora_init
from quintnet_tpu_torch.obs.prom import sample
from quintnet_tpu_torch.obs.recorder import StepRecord
from quintnet_tpu_torch.obs.signals import PoolRebalancePlanner, SignalBus
from quintnet_tpu_torch.serve import (AdapterRegistry, ServeEngine,
                                      gpt2_family)
from quintnet_tpu_torch.tools import trace_view

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2)
JCFG = JaxGPT2Config.tiny(n_layer=2)


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


class _Clock:
    """A fake clock: ``t`` until moved."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class _Ticking:
    """A fake clock advancing ``dt`` per read (one each side)."""

    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _engine(tp, *, observed=False, **kw):
    base = dict(max_slots=2, block_size=4, num_blocks=32, max_seq_len=48)
    base.update(kw)
    eng = ServeEngine(gpt2_family(CFG), tp, device="cpu", **base)
    if observed:
        eng.tracer = obs.Tracer(clock=eng.clock)
        eng.recorder = obs.StepRecorder(capacity=64, clock=eng.clock)
    return eng


def _spans(snapshot):
    """A tracer snapshot without its clock fields."""
    return {tid: [(s["name"], s["attrs"]) for s in spans]
            for tid, spans in snapshot.items()}


# ---------------------------------------------------------------------
# the pure modules, call for call against JAX's
# ---------------------------------------------------------------------

def _drive_tracer(mod):
    clk = _Clock()
    tr = mod.Tracer(clock=clk, max_traces=2, max_spans_per_trace=8)
    for i in range(20):
        clk.t = float(i)
        tr.add("a", f"s{i}", step=i)
    dropped = tr.dropped("a")
    tr.add("b", "x")
    tr.event("b", "decode", token=7)
    tr.add("c", "y", t0=1.0, t1=2.5)                 # evicts "a"
    other = mod.Tracer()
    other.add("b", "remote", t0=1.0, t1=2.0, replica="p1")
    tr.merge(other.snapshot())
    tr.add(None, "ignored")
    return dropped, tr.trace_ids(), tr.snapshot()


def test_tracer_bounds_and_merge_match_jax():
    dropped, ids, snap = _drive_tracer(obs)
    assert (dropped, ids, snap) == _drive_tracer(jobs)
    assert dropped == 12 and "a" not in ids
    assert [s["name"] for s in snap["b"]] == ["x", "decode", "remote"]


def _drive_recorder(mod, record_cls):
    rec = mod.StepRecorder(capacity=4, clock=_Clock())
    out = []
    for i in range(3):
        rec.record(record_cls(step=i + 1, t0=float(i), t1=i + 0.5,
                              decode_tokens=i))
    out.append(rec.drain_new())
    out.append(rec.drain_new())
    for i in range(3, 10):
        rec.record(record_cls(step=i + 1, t0=float(i), t1=i + 0.5,
                              attrs={"k": i}))
    out += [len(rec), rec.total, rec.drain_new(), rec.last()]
    for i in range(10, 14):
        rec.record(record_cls(step=i + 1, t0=float(i), t1=i + 0.5))
    out += [rec.drain_new(max_records=3), rec.drain_new(), rec.snapshot()]
    return out


def test_recorder_ring_and_drain_match_jax():
    got = _drive_recorder(obs, StepRecord)
    assert got == _drive_recorder(jobs, JaxStepRecord)
    assert [r["step"] for r in got[4]] == [7, 8, 9, 10]
    assert [r["step"] for r in got[7]] == [14]


def _drive_events(mod, path):
    clk = _Clock(3.0)
    log = mod.EventLog(path=str(path), capacity=4, clock=clk)
    log.emit("replica_death", replica="p0", error="boom")
    clk.t = 4.0
    log.emit("migration", fid=3)
    with pytest.raises(ValueError, match="unknown event kind") as ei:
        log.emit("oops")
    for i in range(4):
        log.emit("shed", fid=i, reason="queue_full")
    snap = (log.snapshot(), log.snapshot(kind="shed"), log.snapshot(last=2),
            str(ei.value))
    log.close()
    return snap, path.read_text()


def test_event_log_typed_and_jsonl_match_jax(tmp_path):
    got = _drive_events(obs, tmp_path / "port.jsonl")
    assert got == _drive_events(jobs, tmp_path / "jax.jsonl")
    lines = [json.loads(ln) for ln in got[1].strip().splitlines()]
    assert [ln["seq"] for ln in lines] == list(range(1, 7))
    assert obs.EVENT_KINDS == jobs.EVENT_KINDS


def _summaries(tp, rng):
    """Real ledgers: an engine's summary after a short greedy script, a
    fleet front door's with a queue probe and a few latencies."""
    eng = _engine(tp)
    for n in (5, 9):
        eng.submit(rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32),
                   6)
    eng.run()
    fm = FleetMetrics()
    fm.submitted, fm.accepted, fm.finished, fm.shed_queue_full = 5, 4, 3, 1
    fm._queue_probe = lambda: (2, 0.25)
    for x in (0.1, 0.2, 0.4):
        fm.ttfts.append(x)
        fm.latencies.append(3 * x)
    return fm.summary(), eng.metrics.summary()


def test_exposition_byte_equal_to_jax(params, rng):
    """``render_exposition`` over the same ledgers (fleet, two engines,
    health, SLO status, pool pressure) is JAX's text byte for byte, and
    the strict parser reads both alike."""
    _jp, tp = params
    fleet, eng = _summaries(tp, rng)
    clk = _Clock()
    slo = {}
    for mod in (obs, jobs):
        e = mod.SLOEngine(mod.SLOConfig.serving(
            ttft_p99_s=0.05, error_rate=0.1, fast_window_s=5.0,
            slow_window_s=20.0), clock=clk)
        for v in (0.01, 0.2, 0.3):
            e.observe("ttft", v)
        e.observe("error", 1.0)
        e.evaluate(1.0)
        slo[mod] = e.status()
    assert slo[obs] == slo[jobs]
    bus = {}
    for mod in (obs, jobs):
        b = mod.SignalBus(clock=clk)
        b.sample("occupancy", 0.5, pool="decode")
        b.sample("queue_depth", 3.0)
        bus[mod] = b.gauges()
    health = {"replicas": {"r0": {"state": "healthy", "steps": 4,
                                  "in_flight": 1, "breaker": "closed"},
                          "r1": {"state": "dead", "steps": 2,
                                 "in_flight": 0, "breaker": "open"}},
              "queue_depth": 4, "queue_oldest_wait_s": 9.9,
              "open_requests": 2, "draining": False}
    kw = dict(health=health, slo=slo[obs], pressure=bus[obs])
    text = obs.render_exposition(fleet, {"r0": eng, "r1": eng}, **kw)
    jtext = jobs.render_exposition(fleet, {"r0": eng, "r1": eng}, **kw)
    assert text == jtext
    parsed = obs.parse_exposition(text)
    assert parsed == jobs.parse_exposition(jtext)
    assert sample(parsed, "quintnet_fleet_finished") == 3.0
    assert sample(parsed, "quintnet_engine_finished", replica="r0") == 2.0
    assert sample(parsed, "quintnet_replica_up", replica="r1") == 0.0
    assert sample(parsed, "quintnet_fleet_queue_depth") == 2.0


def test_exposition_escaping_and_non_finite_match_jax():
    """JAX's escaping (backslash, quote, newline round trip), the
    parser's refusals (an invalid escape, a non-finite sample, a
    duplicate series) and the renderer's dropping of non-finite values,
    with JAX's results and messages."""
    nasty = ['say "hi"', "back\\slash", "two\nlines", 'a\\b"c\nd']
    fm = FleetMetrics()
    fm.finished = 1
    engines = {n: {"finished": 1, "bad_nan": float("nan"),
                   "bad_inf": float("inf")} for n in nasty}
    text = obs.render_exposition(fm.summary(), engines)
    assert text == jobs.render_exposition(JaxFleetMetrics(finished=1)
                                          .summary(), engines)
    parsed = obs.parse_exposition(text)
    for raw in nasty:
        assert sample(parsed, "quintnet_engine_finished", replica=raw) == 1
    assert not any("bad_" in name for name, _ in parsed)
    for bad in ('m{l="bad\\t"} 1\n', "m 1\nm 2\n", "leaked NaN\n",
                "leaked -Inf\n", "this is not { exposition\n"):
        with pytest.raises(ValueError) as want:
            jobs.parse_exposition(bad)
        with pytest.raises(ValueError) as got:
            obs.parse_exposition(bad)
        assert str(got.value) == str(want.value)


def test_crash_dump_round_trip_and_bounded_dir(tmp_path):
    """A dump written by either package loads in the other; two in one
    second do not collide; only the newest ``keep`` survive; a bad
    version and a bad ``keep`` are refused as JAX refuses them."""
    spec = dict(replica="rX", reason="stall", error="wedged",
                ring=[{"step": 1, "t0": 0.0, "t1": 0.1}],
                traces={"f0": [{"trace_id": "f0", "name": "queue",
                                "t0": 0.0, "t1": 0.2, "attrs": {}}]},
                events=[{"ts": 0.0, "seq": 1, "kind": "replica_stall"}],
                requests=[{"fid": 0, "trace_id": "f0", "committed": 3}])
    a = obs.write_crash_dump(str(tmp_path / "a"), **spec)
    b = jobs.write_crash_dump(str(tmp_path / "b"), **spec)
    for path in (a, b):
        mine, theirs = obs.load_crash_dump(path), jobs.load_crash_dump(path)
        assert mine == theirs and mine["replica"] == "rX"
    assert {k: v for k, v in obs.load_crash_dump(a).items()
            if k != "written_at"} \
        == {k: v for k, v in obs.load_crash_dump(b).items()
            if k != "written_at"}
    assert obs.write_crash_dump(str(tmp_path / "a"), replica="rX",
                                reason="death") != a
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "crash_dump", "v": 999}))
    with pytest.raises(ValueError, match="version"):
        obs.load_crash_dump(str(bad))
    d = tmp_path / "bounded"
    paths = []
    for i in range(7):
        paths.append(obs.write_crash_dump(str(d), replica=f"p{i}",
                                          reason="death", keep=4))
        os.utime(paths[-1], (i + 1.0, i + 1.0))
    assert sorted(os.listdir(d)) == sorted(os.path.basename(p)
                                           for p in paths[-4:])
    for mod in (obs, jobs):
        with pytest.raises(ValueError, match="keep"):
            mod.write_crash_dump(str(d), replica="x", reason="stall",
                                 keep=0)
    assert len(os.listdir(d)) == 4


def _drive_slo(mod):
    """Observations at fake times: a TTFT breach, then recovery; an
    error-rate stream; evaluations along the way."""
    clk = _Clock()
    events = mod.EventLog(clock=clk)
    eng = mod.SLOEngine(mod.SLOConfig.serving(
        ttft_p99_s=0.1, itl_p99_s=0.05, error_rate=0.2, shed_rate=0.5,
        fast_window_s=2.0, slow_window_s=10.0, burn_threshold=2.0),
        clock=clk, events=events)
    out = []
    for t in range(12):
        clk.t = float(t)
        slow = t < 5
        eng.observe("ttft", 0.5 if slow else 0.01)
        eng.observe("itl", 0.01)
        eng.observe("error", 1.0 if t in (2, 3) else 0.0)
        eng.observe("shed", 0.0)
        out.append(eng.evaluate(float(t)))
        out.append(eng.breaching())
    out.append(eng.status())
    out.append(mod.slo.burn_rate(mod.Objective(
        "x", stream="ttft", kind="latency", target=0.1), [0.5, 0.01]))
    return out, events.snapshot()


def test_slo_burn_rates_and_breach_events_match_jax():
    got, events = _drive_slo(obs)
    want, jevents = _drive_slo(jobs)
    assert got == want and events == jevents
    kinds = [e["kind"] for e in events]
    assert "slo_breach" in kinds and "slo_recovered" in kinds
    for mod in (obs, jobs):
        with pytest.raises(ValueError, match="fast_window_s"):
            mod.SLOConfig.serving(ttft_p99_s=1.0, fast_window_s=5.0,
                                  slow_window_s=1.0)


def _drive_signals(bus_cls, planner_cls, event_mod):
    clk = _Clock()
    events = event_mod.EventLog(clock=clk)
    bus = bus_cls(clock=clk, halflife_s=1.0, history=8)
    planner = planner_cls(clock=clk, events=events, cooldown_s=1.0)
    out = []

    def status(pool, breaching):
        return {"objectives": {f"{pool}_obj": {
            "pool": pool, "breaching": breaching, "burn_fast": 3.0,
            "burn_slow": 2.5}}}

    for t in range(10):
        clk.t = float(t)
        bus.sample("occupancy", 0.2 + 0.05 * t, pool="decode")
        bus.sample("occupancy", 0.9, pool="prefill")
        bus.sample("queue_depth", float(t))
        st = status("prefill", 2 <= t < 6)
        out.append(planner.plan(st, bus))
        out.append(bus.value("occupancy", "decode"))
        out.append(bus.value("queue_depth", smoothed=False))
    out += [bus.history("queue_depth"), bus.gauges(), bus.snapshot(),
            list(planner.recommendations), planner.outstanding]
    return out, events.snapshot()


def test_signal_ewmas_and_planner_events_match_jax():
    got, events = _drive_signals(SignalBus, PoolRebalancePlanner, obs)
    want, jevents = _drive_signals(JaxSignalBus, JaxPlanner, jobs)
    assert got == want and events == jevents
    directions = [e.get("direction") for e in events
                  if e["kind"] == "rebalance_recommended"]
    assert directions == ["decode_to_prefill", "prefill_to_decode"]
    e = obs.Ewma(1.0)
    assert e.value is None and e.update(0.0, 4.0) == 4.0


def test_trace_view_output_equals_jax(params, rng, tmp_path):
    """``chrome_trace`` over a chunked engine's ring and spans, plus
    fleet events, equals JAX's exporter's output; it validates; the CLI
    round-trips a crash-dump-shaped file as JAX's does."""
    _jp, tp = params
    eng = _engine(tp, observed=True, chunked_prefill=True, prefill_len=16,
                  clock=_Ticking())
    eng.submit(rng.integers(0, CFG.vocab_size, (30,)).astype(np.int32), 6)
    eng.run()
    ring, traces = eng.recorder.snapshot(), eng.tracer.snapshot()
    events = [{"ts": 10.0, "seq": 1, "kind": "slo_breach",
               "objective": "ttft_p99", "pool": "prefill",
               "burn_fast": 4.2, "burn_slow": 3.0},
              {"ts": 11.0, "seq": 2, "kind": "replica_death",
               "replica": "p1"}, {"not_an_event": True}]
    trace = trace_view.chrome_trace(ring, traces, fleet_events=events)
    assert trace == jtrace_view.chrome_trace(ring, traces,
                                             fleet_events=events)
    n = trace_view.validate_chrome_trace(trace)
    assert n == jtrace_view.validate_chrome_trace(trace) > 0
    phases = {e["ph"] for e in trace["traceEvents"]}
    assert {"M", "X", "i", "b", "e"} <= phases
    assert any(e["args"].get("prefill_chunks", 0) > 0
               for e in trace["traceEvents"] if e["ph"] == "X")
    bad = {"traceEvents": [{"name": "q", "ph": "e", "ts": 0, "pid": 1,
                            "cat": "r", "id": "f0"}]}
    with pytest.raises(ValueError, match="without begin"):
        trace_view.validate_chrome_trace(bad)
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps({"ring": ring, "traces": traces,
                                "events": events}))
    outs = []
    for mod in (trace_view, jtrace_view):
        out = tmp_path / f"{mod.__name__}.json"
        assert mod.main([str(dump), "-o", str(out)]) == 0
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------
# the engine: observed == unobserved, bit for bit
# ---------------------------------------------------------------------

def _lora_registry(tp):
    lcfg = LoRAConfig(rank=4, alpha=8.0)
    tree = lora_init(torch.Generator().manual_seed(77), tp["blocks"], lcfg)
    gen = torch.Generator().manual_seed(78)

    def move_b(node):                   # off zero: the adapter counts
        if "b" in node and "a" in node:
            node["b"] = torch.randn(node["b"].shape, generator=gen) * 0.05
            return
        for child in node.values():
            move_b(child)

    move_b(tree)
    reg = AdapterRegistry()
    reg.register("tenantA", tree=tree, cfg=lcfg)
    return reg


@pytest.mark.parametrize("combo", [
    dict(),
    dict(spec=True, kv_dtype="int8", temperature=0.8, top_k=5),
    dict(chunked_prefill=True, prefill_len=16, temperature=0.8, top_k=5),
    dict(lora=True, kv_dtype="int8", temperature=0.8, top_k=5),
], ids=["greedy", "spec+int8+sampled", "chunked+sampled",
        "lora+int8+sampled"])
def test_tracing_is_token_bit_identical(params, rng, combo):
    """One engine with the tracer and the recorder armed, one without, on
    the same weights, traffic and seeds: every output bit-identical, the
    prefix cache on and the combo's features composed (JAX's combos,
    ``tests/test_obs.py:84-165``, and the greedy default). The observer
    observed, and only names of ``SPAN_NAMES``."""
    _jp, tp = params
    combo = dict(combo)
    lora = combo.pop("lora", False)
    lens = (5, 9, 3, 7, 30 if combo.get("chunked_prefill") else 12)
    prompts = [rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)
               for t in lens]
    aids = [("tenantA" if lora and i % 2 == 0 else None)
            for i in range(len(prompts))]
    outs, seen = {}, None
    for observed in (False, True):
        kw = dict(combo)
        if lora:
            kw["adapters"] = _lora_registry(tp)
        eng = _engine(tp, observed=observed, prefix_cache=True, **kw)
        rids = [eng.submit(p, 8, seed=100 + i, adapter_id=a)
                for i, (p, a) in enumerate(zip(prompts, aids))]
        eng.run()
        outs[observed] = [eng.result(r) for r in rids]
        if observed:
            seen = eng
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
    assert len(seen.recorder) > 0
    tids = seen.tracer.trace_ids()
    assert len(tids) == len(prompts)
    names = {s.name for t in tids for s in seen.tracer.spans(t)}
    assert {"submit", "queue", "admit", "finish"} <= names
    if combo.get("chunked_prefill"):
        assert "prefill_chunk" in names
    if combo.get("spec"):
        assert "verify" in names or "decode" in names
    assert names <= obs.SPAN_NAMES, names - obs.SPAN_NAMES
    assert obs.SPAN_NAMES == jobs.SPAN_NAMES


def test_tracing_inert_across_preemption(params, rng):
    """A pool too small for the working set (it preempts), sampled, with
    tracing on and off: the same outputs, and the preempt arc traced."""
    _jp, tp = params
    prompts = [rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)
               for t in (6, 7, 6)]
    outs, traced = {}, None
    for observed in (False, True):
        eng = _engine(tp, observed=observed, num_blocks=8, max_seq_len=20,
                      temperature=0.7, top_k=4)
        rids = [eng.submit(p, 10, seed=7 + i) for i, p in enumerate(prompts)]
        eng.run()
        outs[observed] = [eng.result(r) for r in rids]
        traced = eng
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
    assert traced.metrics.preempted > 0
    names = [s.name for t in traced.tracer.trace_ids()
             for s in traced.tracer.spans(t)]
    assert "preempt" in names


def test_step_records_and_spans_equal_jax(params, rng):
    """One greedy script (staggered, under preemption) through
    the port engine and the JAX engine, each with its own tracer and
    recorder on a fake clock: the ``StepRecord`` streams are equal field
    by field but the clock fields, and so are the spans' names and
    attributes under every trace id."""
    jp, tp = params
    prompts = [rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)
               for t in (6, 7, 6)]
    prompts.append(np.concatenate([prompts[0], prompts[1][:3]]))
    kw = dict(max_slots=2, block_size=4, num_blocks=8, max_seq_len=20)
    runs = {}
    for side in ("port", "jax"):
        if side == "port":
            eng = ServeEngine(gpt2_family(CFG), tp, device="cpu",
                              clock=_Ticking(), **kw)
            eng.tracer = obs.Tracer(clock=eng.clock)
            eng.recorder = obs.StepRecorder(capacity=256, clock=eng.clock)
        else:
            eng = JaxServeEngine(jax_gpt2_family(JCFG), jp,
                                 clock=_Ticking(), **kw)
            eng.tracer = jobs.Tracer(clock=eng.clock)
            eng.recorder = jobs.StepRecorder(capacity=256, clock=eng.clock)
        rids = [eng.submit(p, 10) for p in prompts[:3]]
        eng.step()
        eng.step()
        rids += [eng.submit(p, 10) for p in prompts[3:]]
        eng.run()
        runs[side] = ([eng.result(r) for r in rids],
                      [{k: v for k, v in r.items() if k not in ("t0", "t1")}
                       for r in eng.recorder.snapshot()],
                      _spans(eng.tracer.snapshot()), eng.metrics.preempted)
    for a, b in zip(runs["port"][0], runs["jax"][0]):
        np.testing.assert_array_equal(a, b)
    assert runs["port"][1] == runs["jax"][1]
    assert runs["port"][2] == runs["jax"][2]
    assert runs["port"][3] == runs["jax"][3] > 0
    assert any(r["preempted"] > 0 for r in runs["port"][1])
