"""The port's in-process serving fleet (``quintnet_tpu_torch/fleet/``:
``ServeFleet`` over ``ServeEngine`` replicas on worker threads) against
the JAX package.

THE contract, JAX's (``tests/test_fleet.py``): every request is served
token for token as an independent generation of its prompt would serve
it — also one whose replica is killed mid-flight and whose progress
migrates to another replica. Greedy streams are held to JAX's
``gpt2_generate``, sampled ones to the port's ``gpt2_generate`` at the
request's seed (``fid`` by default, as JAX's fleet folds the fid into
its key). Beside it: the policy units against JAX's call for call,
typed shedding under a burst and at deadlines, the breaker's trip and
half-open probe, graceful drain, a kill mid-speculation, the thread
fleet's crash dump and tracing, and a dead replica's engine freed at its
restart. Waits poll with timeouts (``_wait_until``), never sleep.
"""

import gc
import threading
import time
import weakref

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.fleet import AdmissionQueue as JaxAdmissionQueue
from quintnet_tpu.fleet import CircuitBreaker as JaxCircuitBreaker
from quintnet_tpu.fleet import Overloaded as JaxOverloaded
from quintnet_tpu.fleet import RetryPolicy as JaxRetryPolicy
from quintnet_tpu.fleet import Router as JaxRouter
from quintnet_tpu.fleet import ServeFleet as JaxServeFleet
from quintnet_tpu.fleet.fleet import FleetMetrics as JaxFleetMetrics
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2_generate import \
    gpt2_generate as jax_gpt2_generate
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu.serve.metrics import ServeMetrics as JaxServeMetrics
from quintnet_tpu.serve.metrics import aggregate as jax_aggregate
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.fleet import (DEAD, HALF_OPEN, HEALTHY, OPEN,
                                      AdmissionQueue, CircuitBreaker,
                                      Overloaded, RetryPolicy, Router,
                                      ServeFleet)
from quintnet_tpu_torch.fleet.fleet import FleetMetrics
from quintnet_tpu_torch.ft import ChaosKilled, ChaosMonkey
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
from quintnet_tpu_torch.obs import load_crash_dump
from quintnet_tpu_torch.serve import ServeEngine, SpecConfig, gpt2_family
from quintnet_tpu_torch.serve.metrics import ServeMetrics, aggregate

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2)
JCFG = JaxGPT2Config.tiny(n_layer=2)
TEMP, TOPK = 0.8, 5


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _factory(tp, *, sampled=True, **kw):
    base = dict(max_slots=2, block_size=4, num_blocks=24, max_seq_len=24)
    base.update(kw)
    if sampled:
        base.update(temperature=TEMP, top_k=TOPK)

    def make():
        return ServeEngine(gpt2_family(CFG), tp, device="cpu", **base)

    return make


def _sampled(tp, prompt, max_new, seed):
    """The port's oracle at ``seed``."""
    return gpt2_generate(tp, prompt[None], CFG, max_new_tokens=max_new,
                         temperature=TEMP, top_k=TOPK, seed=seed)[0]


def _greedy(jp, prompt, max_new, jcfg=JCFG):
    """JAX's greedy oracle."""
    return np.asarray(jax_gpt2_generate(jp, prompt[None], jcfg,
                                        max_new_tokens=max_new,
                                        temperature=0.0,
                                        key=jax.random.key(0))[0])


def _prompts(rng, lengths, vocab=CFG.vocab_size):
    return [rng.integers(0, vocab, (t,)).astype(np.int32) for t in lengths]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _wait_until(pred, *, timeout=30.0, msg=""):
    done = threading.Event()
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for: {msg}")
        done.wait(0.01)


# ---------------------------------------------------------------------
# policy units, call for call against JAX's
# ---------------------------------------------------------------------

def _breaker_script(cls):
    clk = FakeClock()
    out = []
    br = cls(trip_after=3, reset_s=10.0, clock=clk)
    for op in ("f", "f", "a", "s", "f", "f", "f", "a"):
        if op == "a":
            out.append(br.allow_restart())
        else:
            (br.record_failure if op == "f" else br.record_success)()
        out.append((br.state, br.consecutive_failures))
    br = cls(trip_after=1, reset_s=10.0, clock=clk)
    br.record_failure()
    out.append((br.state, br.allow_restart()))
    clk.advance(10.0)
    out += [br.allow_restart(), br.state, br.allow_restart()]
    br.record_failure()                      # the probe died
    clk.advance(9.0)
    out += [br.state, br.allow_restart()]
    clk.advance(1.0)
    out += [br.allow_restart(), br.state]
    br.record_success()
    out += [br.state, br.consecutive_failures]
    with pytest.raises(ValueError) as ei:
        cls(trip_after=0)
    return out + [str(ei.value)]


def test_circuit_breaker_matches_jax():
    """The trip on consecutive failures only, one half-open probe after
    ``reset_s``, a dead probe re-opening for a full ``reset_s``."""
    got = _breaker_script(CircuitBreaker)
    assert got == _breaker_script(JaxCircuitBreaker)
    assert ("open", 3) in got and HALF_OPEN in got


class _Item:
    def __init__(self, deadline=None, adapter_id=None):
        self.deadline = deadline
        self.adapter_id = adapter_id


def _queue_script(cls, overloaded):
    clk = FakeClock()
    out = []
    q = cls(2, clock=clk)
    q.push(_Item())
    q.push(_Item())
    with pytest.raises(overloaded) as ei:
        q.push(_Item())
    out += [ei.value.reason, str(ei.value), len(q)]
    q = cls(8, clock=clk)
    live, dead = _Item(adapter_id="t"), _Item(deadline=5.0)
    q.push(live)
    q.push(dead)
    out += [q.shed_expired() == [], q.peek_adapter_id(), q.oldest_wait_s()]
    clk.advance(6.0)
    out += [q.shed_expired() == [dead], q.oldest_wait_s(), q.pop() is live,
            q.pop()]
    q = cls(1, clock=clk)
    q.push(_Item())
    migrated = _Item()
    q.push_front([migrated])
    out += [len(q), q.pop() is migrated, len(q.drain_all()), len(q)]
    return out


def test_admission_queue_matches_jax():
    """The bound sheds typed without growing; deadline shedding; a
    migration requeue bypasses the bound and goes first."""
    got = _queue_script(AdmissionQueue, Overloaded)
    assert got == _queue_script(JaxAdmissionQueue, JaxOverloaded)
    assert got[0] == "queue_full" and got[2] == 2


class _Rep:
    def __init__(self, name, load, warm=()):
        self.name, self.outstanding_tokens = name, load
        self.warm = set(warm)

    def adapter_resident(self, adapter_id):
        return adapter_id in self.warm


def _router_script(cls):
    out = []
    r = cls("least_work")
    reps = [_Rep("r0", 30), _Rep("r1", 10), _Rep("r2", 20, warm={"t"})]
    out += [r.pick(reps).name, r.pick(reps, adapter_id="t").name,
            r.pick(reps, adapter_id="cold").name]
    reps[0].outstanding_tokens = 10
    out.append(r.pick(reps).name)            # the tie breaks on name
    rr = cls("round_robin")
    out += [rr.pick(reps).name for _ in range(4)]
    for bad in (lambda: cls("fastest"), lambda: r.pick([])):
        with pytest.raises(ValueError) as ei:
            bad()
        out.append(str(ei.value))
    return out


def test_router_matches_jax():
    got = _router_script(Router)
    assert got == _router_script(JaxRouter)
    assert got[:4] == ["r1", "r2", "r1", "r0"]
    assert got[4:8] == ["r0", "r1", "r2", "r0"]


def _retry_script(cls):
    clk = FakeClock()
    slept, retried = [], []
    rand = iter([0.0, 0.5, 1.0, 0.25] * 4).__next__
    pol = cls(base_s=0.1, cap_s=0.3, jitter=0.5, max_attempts=3,
              rand=rand, clock=clk, sleep=slept.append)
    out = [pol.delay_s(1), pol.delay_s(2), pol.delay_s(3), pol.delay_s(9)]

    def flaky(attempt):
        if attempt < 3:
            raise OSError(f"try {attempt}")
        return attempt

    out.append(pol.run(flaky, on_retry=lambda a, e: retried.append(
        (a, str(e)))))
    with pytest.raises(OSError, match="try 3"):
        pol.run(lambda a: (_ for _ in ()).throw(OSError(f"try {a}")))
    with pytest.raises(KeyError):
        pol.run(lambda a: {}["x"], retry_on=(OSError,))
    tight = pol.bounded(0.05)
    clk.advance(1.0)
    out += [tight.timeout_s, tight.max_attempts]
    for kw in ({"base_s": -1}, {"jitter": -1}, {"max_attempts": 0}):
        with pytest.raises(ValueError) as ei:
            cls(**kw)
        out.append(str(ei.value))
    return out, slept, retried


def test_retry_policy_matches_jax():
    """Jittered exponential delays capped at ``cap_s``, retries only of
    ``retry_on``, exhaustion re-raising the last error, ``bounded``."""
    got = _retry_script(RetryPolicy)
    assert got == _retry_script(JaxRetryPolicy)
    assert got[2] == [(1, "try 1"), (2, "try 2")]


def _metrics_script(metrics_cls, agg, fleet_cls):
    clk = FakeClock()
    a, b = metrics_cls(clock=clk), metrics_cls(clock=clk)
    a.record_step(running=1, waiting=0, kv_blocks_used=2,
                  kv_blocks_total=4, prefill_tokens=5, decode_tokens=1)
    clk.advance(2.0)
    b.record_step(running=2, waiting=1, kv_blocks_used=4,
                  kv_blocks_total=4, prefill_tokens=7, decode_tokens=2)
    a.record_admit()
    a.record_first_token(0.1)
    b.record_first_token(0.9)
    b.record_finish(1.5)
    b.record_deadline_exceeded()
    fm = fleet_cls()
    fm.submitted, fm.accepted, fm.shed_deadline = 4, 3, 1
    fm.ttfts.append(0.2)
    return agg([a, b]), agg([]), fm.summary(), fm.shed_rate


def test_fleet_metrics_and_aggregate_match_jax():
    got = _metrics_script(ServeMetrics, aggregate, FleetMetrics)
    assert got == _metrics_script(JaxServeMetrics, jax_aggregate,
                                  JaxFleetMetrics)
    agg = got[0]
    assert agg["replicas"] == 2 and agg["gen_tokens"] == 4
    assert agg["ttft_s"]["p50"] == pytest.approx(0.5)
    assert got[3] == pytest.approx(0.25)


# ---------------------------------------------------------------------
# the fleet on real engines
# ---------------------------------------------------------------------

def test_fleet_parity_and_graceful_drain(params, rng):
    """No faults, 2 replicas: every output the oracle's at its seed
    (sampled) — the fleet's default seed is the fid; drain refuses new
    work typed. JAX's fleet summary keys, but ``compile_stats``."""
    jp, tp = params
    prompts = _prompts(rng, (5, 7, 3, 6, 4, 8))
    seeds = [100 + i for i in range(6)]
    fleet = ServeFleet(_factory(tp), n_replicas=2, policy="least_work")
    try:
        outs = fleet.generate(prompts, max_new_tokens=8, seeds=seeds,
                              timeout=300)
        for p, sd, o in zip(prompts, seeds, outs):
            np.testing.assert_array_equal(o, _sampled(tp, p, 8, sd))
        fid = fleet.submit(prompts[0], 6)
        np.testing.assert_array_equal(fleet.result(fid, timeout=300),
                                      _sampled(tp, prompts[0], 6, fid))
        s = fleet.summary()
        assert s["finished"] == 7 and s["engine"]["finished"] == 7
        assert s["shed"] == 0 and s["migrations"] == 0
        jfleet = JaxServeFleet(lambda: JaxServeEngine(
            jax_gpt2_family(JCFG), jp, max_slots=2, block_size=4,
            num_blocks=24, max_seq_len=24), n_replicas=2)
        try:
            js = jfleet.summary()
        finally:
            jfleet.close()
        assert set(s) == set(js)
        assert set(s["replicas"]["r0"]) == set(js["replicas"]["r0"])
    finally:
        fleet.drain(timeout=60)
    with pytest.raises(Overloaded) as ei:
        fleet.submit(prompts[0], 4)
    assert ei.value.reason == "shutdown"
    assert all(r.state == "stopped" for r in fleet.replicas)


def test_never_admissible_request_rejected_at_submit(params, rng):
    """A request no engine of the fleet could run fails at submit, with
    JAX's error, before any dispatch; the fleet serves on."""
    jp, tp = params
    fleet = ServeFleet(_factory(tp, sampled=False), n_replicas=1)
    jfleet = JaxServeFleet(lambda: JaxServeEngine(
        jax_gpt2_family(JCFG), jp, max_slots=2, block_size=4,
        num_blocks=24, max_seq_len=24), n_replicas=1)
    try:
        for prompt, n, match in ((np.zeros(23, np.int32), 8,
                                  "exceeds max_seq_len"),
                                 (np.zeros(0, np.int32), 4, "empty prompt")):
            with pytest.raises(ValueError, match=match) as got:
                fleet.submit(prompt, n)
            with pytest.raises(ValueError, match=match) as want:
                jfleet.submit(prompt, n)
            assert str(got.value) == str(want.value)
        assert fleet.metrics.accepted == 0
        p = _prompts(rng, (5,))[0]
        np.testing.assert_array_equal(
            fleet.generate([p], max_new_tokens=4, timeout=300)[0],
            _greedy(jp, p, 4))
        assert all(r.state == HEALTHY for r in fleet.replicas)
    finally:
        jfleet.close()
        fleet.drain(timeout=60)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_kill_one_of_three_migrates_token_identically(params, rng, mode):
    """Replica r1 of 3 killed (``ChaosMonkey``, mode='raise') after its
    3rd step with requests mid-flight: every request completes equal to
    its oracle (greedy: JAX's ``gpt2_generate``; sampled: the port's at
    the fid), a streaming request on r1 sees its tokens in order, once,
    one last flag; the death is the armed one; the breaker restarts r1."""
    jp, tp = params
    sampled = mode == "sampled"
    prompts = _prompts(rng, (5, 7, 3, 6, 4, 8, 5, 6, 4))
    monkey = ChaosMonkey(kill_at_step=3, mode="raise", target="r1")
    fleet = ServeFleet(_factory(tp, sampled=sampled), n_replicas=3,
                       policy="round_robin", chaos=monkey, obs=True)
    try:
        streamed, fids = [], []
        for i, p in enumerate(prompts):
            on_token = ((lambda fid, tok, last: streamed.append((tok, last)))
                        if i == 1 else None)   # round_robin: i = 1 -> r1
            fids.append(fleet.submit(p, 8, on_token=on_token))
        outs = [fleet.result(f, timeout=300) for f in fids]
        for fid, p, o in zip(fids, prompts, outs):
            want = (_sampled(tp, p, 8, fid) if sampled
                    else _greedy(jp, p, 8))
            np.testing.assert_array_equal(o, want)
        m = fleet.metrics
        assert m.replica_deaths == 1 and m.migrations >= 1
        assert m.finished == 9 and m.shed == 0
        _wait_until(lambda: fleet.metrics.restarts == 1, msg="restart")
        toks = [t for t, _ in streamed]
        np.testing.assert_array_equal(np.asarray(toks, np.int32),
                                      outs[1][len(prompts[1]):])
        assert [last for _, last in streamed].count(True) == 1
        assert streamed[-1][1] is True
        deaths = fleet.events.snapshot(kind="replica_death")
        assert [(d["replica"], d["error"]) for d in deaths] == [
            ("r1", "ChaosKilled: chaos kill after global step 3")]
    finally:
        fleet.drain(timeout=120)


def test_dead_replica_engine_is_freed_at_restart(params, rng):
    """After the breaker restarts a killed replica, nothing holds the
    dead engine (its KV pool): not the worker thread, not the death's
    traceback (kept as text), not the crash snapshot, not the fleet."""
    _jp, tp = params
    monkey = ChaosMonkey(kill_at_step=2, mode="raise", target="r0")
    fleet = ServeFleet(_factory(tp), n_replicas=2, policy="round_robin",
                       chaos=monkey, obs=True)
    try:
        dead = weakref.ref(fleet.replicas[0].engine)
        pool = weakref.ref(fleet.replicas[0].engine.pool.k)
        fids = [fleet.submit(p, 8) for p in _prompts(rng, (5, 6, 4, 7))]
        [fleet.result(f, timeout=300) for f in fids]
        _wait_until(lambda: fleet.metrics.restarts == 1, msg="restart")
        gc.collect()
        assert dead() is None and pool() is None
        assert fleet.replicas[0].state == HEALTHY
        assert fleet.last_crash["replica"] == "r0"
    finally:
        fleet.drain(timeout=120)


def test_worker_error_that_was_not_armed_is_a_death_with_its_text(params,
                                                                  rng):
    """A replica whose engine raises on its own (here a step that fails
    on its first call) dies like a killed one — its requests migrate —
    and the death carries the error's own type and traceback text, so a
    caller can tell it from an armed chaos kill."""
    _jp, tp = params
    make = _factory(tp)
    calls = {"n": 0}

    def faulty():
        eng = make()
        if calls["n"] == 0:
            def boom():
                raise RuntimeError("kernel launch failed (injected)")
            eng.step = boom
        calls["n"] += 1
        return eng

    fleet = ServeFleet(faulty, n_replicas=2, policy="round_robin",
                       obs=True)
    try:
        fids = [fleet.submit(p, 6) for p in _prompts(rng, (5, 6))]
        outs = [fleet.result(f, timeout=300) for f in fids]
        assert all(len(o) for o in outs)
        (death,) = fleet.events.snapshot(kind="replica_death")
        assert death["error"] == \
            "RuntimeError: kernel launch failed (injected)"
        assert not isinstance(RuntimeError(), ChaosKilled)
    finally:
        fleet.drain(timeout=120)


def test_burst_sheds_typed_and_deadline_expiry(params, rng):
    """Over capacity the bounded queue refuses typed instead of growing;
    a queued request past its deadline is shed typed; the accepted rest
    complete equal to the oracle."""
    _jp, tp = params
    clk = FakeClock()
    prompts = _prompts(rng, (5, 6, 4, 7, 5, 6))
    seeds = [700 + i for i in range(6)]
    fleet = ServeFleet(_factory(tp), n_replicas=1, max_pending=4,
                       clock=clk)
    try:
        fleet.pause_all()
        ok = [fleet.submit(prompts[0], 6, seed=seeds[0])]
        fid_dead = fleet.submit(prompts[1], 6, seed=seeds[1], deadline_s=5)
        ok += [fleet.submit(prompts[2], 6, seed=seeds[2]),
               fleet.submit(prompts[3], 6, seed=seeds[3])]
        with pytest.raises(Overloaded) as ei:
            fleet.submit(prompts[4], 6, seed=seeds[4])
        assert ei.value.reason == "queue_full"
        with pytest.raises(Overloaded) as ei:
            fleet.submit(prompts[5], 6, seed=seeds[5], deadline_s=0)
        assert ei.value.reason == "deadline"
        assert len(fleet._queue) <= 4
        clk.advance(10.0)
        _wait_until(lambda: fleet.request(fid_dead).event.is_set(),
                    msg="deadline shed")
        with pytest.raises(Overloaded) as ei:
            fleet.result(fid_dead)
        assert ei.value.reason == "deadline"
        fleet.resume_all()
        for fid, i in zip(ok, (0, 2, 3)):
            np.testing.assert_array_equal(
                fleet.result(fid, timeout=300),
                _sampled(tp, prompts[i], 6, seeds[i]))
        m = fleet.metrics
        assert m.shed_queue_full == 1 and m.shed_deadline == 2
        assert m.submitted == 6 and m.accepted == 4 and m.finished == 3
        assert m.shed_rate == pytest.approx(0.5)
    finally:
        fleet.drain(timeout=120)


def test_deadline_mid_decode_through_the_fleet(params, rng):
    """A dispatched request whose deadline lapses while it decodes is
    retired by its engine with ``DeadlineExceeded``: the fleet counts it
    apart from the queue's sheds and logs it; the replica lives."""
    _jp, tp = params
    clk = FakeClock()
    fleet = ServeFleet(_factory(tp, max_seq_len=40, num_blocks=32),
                       n_replicas=1, clock=clk, obs=True)
    try:
        eng = fleet.replicas[0].engine
        eng.clock = clk                    # one clock for fleet and engine
        p = _prompts(rng, (6,))[0]
        seen = []
        fid = fleet.submit(p, 30, deadline_s=5.0,
                           on_token=lambda f, t, last: seen.append(t))
        _wait_until(lambda: len(seen) >= 2, msg="decoding")
        clk.advance(10.0)
        _wait_until(lambda: fleet.request(fid).event.is_set(),
                    msg="retired")
        with pytest.raises(Exception) as ei:
            fleet.result(fid)
        assert type(ei.value).__name__ == "DeadlineExceeded"
        assert 2 <= ei.value.generated < 30
        assert fleet.metrics.deadline_exceeded == 1
        assert fleet.events.snapshot(kind="deadline_exceeded")
        assert fleet.replicas[0].state == HEALTHY
    finally:
        fleet.drain(timeout=120)


def test_breaker_trips_then_half_open_probe_recovers(params, rng):
    """Repeated kills of r0 (re-armed chaos) trip its breaker after 2:
    no more restarts, the work migrates to r1 and completes. After
    ``reset_s`` one probe restart; its first finish closes the breaker."""
    _jp, tp = params
    clk = FakeClock()
    prompts = _prompts(rng, (5, 6, 4, 7))
    seeds = [900 + i for i in range(4)]
    monkey = ChaosMonkey(kill_at_step=1, mode="raise", target="r0",
                         rearm=True)
    fleet = ServeFleet(_factory(tp), n_replicas=2, policy="round_robin",
                       trip_after=2, breaker_reset_s=30.0, chaos=monkey,
                       clock=clk)
    try:
        fids = [fleet.submit(p, 6, seed=s) for p, s in zip(prompts, seeds)]
        for fid, p, s in zip(fids, prompts, seeds):
            np.testing.assert_array_equal(fleet.result(fid, timeout=300),
                                          _sampled(tp, p, 6, s))
        _wait_until(lambda: fleet.breaker("r0").state == OPEN,
                    msg="breaker open after repeated kills")
        assert fleet.metrics.replica_deaths == 2
        assert fleet.metrics.restarts == 1
        assert fleet.metrics.migrations >= 2
        assert fleet.replicas[0].state == DEAD
        monkey.kill_at_step = None
        clk.advance(31.0)
        _wait_until(lambda: fleet.metrics.restarts == 2,
                    msg="half-open probe restart")
        assert fleet.breaker("r0").state == HALF_OPEN
        probe = _prompts(rng, (5, 6))
        outs = fleet.generate(probe, max_new_tokens=4, seeds=[950, 951],
                              timeout=300)
        for p, s, o in zip(probe, (950, 951), outs):
            np.testing.assert_array_equal(o, _sampled(tp, p, 4, s))
        _wait_until(lambda: fleet.breaker("r0").state == "closed",
                    msg="probe success closes the breaker")
        assert all(r.state == HEALTHY for r in fleet.replicas)
    finally:
        fleet.drain(timeout=120)


def test_kill_mid_speculation_migrates_token_identically(rng):
    """r1 of 2 killed while its requests' drafts are being accepted: the
    migrated progress carries committed tokens only, so every request
    ends equal to JAX's greedy; no tentative block outlives its step."""
    cfg = GPT2Config.tiny(n_layer=2, n_positions=256)
    jcfg = JaxGPT2Config.tiny(n_layer=2, n_positions=256)
    jp = jax_gpt2_init(jax.random.key(1), jcfg)
    tp = gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def spec_factory():
        return ServeEngine(gpt2_family(cfg), tp, device="cpu", max_slots=2,
                           block_size=8, num_blocks=32, max_seq_len=100,
                           spec=SpecConfig())

    prompts = _prompts(rng, (12, 9, 11, 8), cfg.vocab_size)
    monkey = ChaosMonkey(kill_at_step=6, mode="raise", target="r1")
    fleet = ServeFleet(spec_factory, n_replicas=2, policy="round_robin",
                       chaos=monkey)
    try:
        fids = [fleet.submit(p, 60) for p in prompts]
        outs = [fleet.result(f, timeout=300) for f in fids]
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, _greedy(jp, p, 60, jcfg))
        m = fleet.metrics
        assert m.replica_deaths == 1 and m.migrations >= 1
        assert m.finished == 4 and m.shed == 0
        eng = fleet.summary()["engine"]
        assert eng["accepted_draft_tokens"] > 0 and eng["spec_steps"] > 0
        _wait_until(lambda: fleet.metrics.restarts == 1, msg="restart")
        assert all(r.engine.pool.num_tentative == 0 for r in fleet.replicas)
    finally:
        fleet.drain(timeout=120)


def test_kill_mid_prefill_migrates_token_identically(params, rng):
    """A replica killed while a long prompt is MID chunked prefill: the
    fleet resumes it elsewhere and every stream equals the oracle at its
    seed (JAX's ``tests/test_longctx.py:347``)."""
    cfg = GPT2Config.tiny(n_layer=2, n_positions=256)
    jp = jax_gpt2_init(jax.random.key(0), JaxGPT2Config.tiny(
        n_layer=2, n_positions=256))
    tp = gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def factory():
        return ServeEngine(gpt2_family(cfg), tp, device="cpu", max_slots=2,
                           block_size=8, num_blocks=40, max_seq_len=200,
                           prefill_len=32, chunked_prefill=True,
                           prefill_chunk_budget=8, temperature=TEMP,
                           top_k=TOPK)

    prompts = _prompts(rng, (100, 5, 7), cfg.vocab_size)
    seeds = [800, 801, 802]
    monkey = ChaosMonkey(kill_at_step=4, mode="raise", target="r0")
    fleet = ServeFleet(factory, n_replicas=2, policy="round_robin",
                       chaos=monkey)
    try:
        fids = [fleet.submit(p, 6, seed=s) for p, s in zip(prompts, seeds)]
        outs = [fleet.result(f, timeout=300) for f in fids]
        assert fleet.metrics.replica_deaths == 1
        assert fleet.metrics.migrations >= 1
        for p, s, o in zip(prompts, seeds, outs):
            np.testing.assert_array_equal(o, gpt2_generate(
                tp, p[None], cfg, max_new_tokens=6, temperature=TEMP,
                top_k=TOPK, seed=s)[0])
    finally:
        fleet.drain(timeout=120)


# ---------------------------------------------------------------------
# the fleet's black box and tracing
# ---------------------------------------------------------------------

def test_thread_fleet_crash_dump_and_continued_spans(params, rng,
                                                     tmp_path):
    """A chaos-killed replica leaves a crash dump with its step ring and
    the migrated requests' spans, readable by the loader; each migrated
    request's timeline continues (migration -> restore -> finish) under
    its trace id; the exposition of the fleet parses."""
    from quintnet_tpu_torch.obs import parse_exposition, render_exposition

    _jp, tp = params
    fleet = ServeFleet(_factory(tp, sampled=False, max_seq_len=40),
                       n_replicas=2, obs=True, crash_dir=str(tmp_path),
                       chaos=ChaosMonkey(kill_at_step=3, mode="raise",
                                         target="r0"))
    try:
        fids = [fleet.submit(p, 12) for p in _prompts(rng, (5, 5, 5, 5))]
        [fleet.result(f, timeout=300) for f in fids]
        assert fleet.metrics.replica_deaths == 1
        _wait_until(lambda: len(fleet.crash_dumps) == 1,
                    msg="crash dump flushed")
        dump = load_crash_dump(fleet.crash_dumps[0])
        assert dump["replica"] == "r0" and dump["reason"] == "death"
        assert len(dump["ring"]) >= 1 and dump["requests"]
        for r in dump["requests"]:
            assert dump["traces"][r["trace_id"]]
            names = [s.name for s in fleet.tracer.spans(r["trace_id"])]
            assert names.index("restore") > names.index("migration")
            assert "finish" in names
        kinds = [e["kind"] for e in fleet.events.snapshot()]
        for kind in ("replica_death", "migration", "crash_dump"):
            assert kind in kinds
        text = render_exposition(fleet.metrics.summary(),
                                 fleet.engine_summaries(),
                                 health=fleet.health())
        parsed = parse_exposition(text)
        assert parsed[("quintnet_fleet_finished", ())] == 4.0
    finally:
        fleet.close()


def test_fleet_tracing_inert(params, rng):
    """The fleet with obs on and off, a chaos kill in both: the same
    outputs (the migration path is observation-inert too)."""
    _jp, tp = params
    prompts = _prompts(rng, (5, 5, 5, 5))
    outs = {}
    for observed in (False, True):
        fleet = ServeFleet(_factory(tp, max_seq_len=40), n_replicas=2,
                           obs=observed,
                           chaos=ChaosMonkey(kill_at_step=3, mode="raise",
                                             target="r0"))
        try:
            fids = [fleet.submit(p, 12, seed=40 + i)
                    for i, p in enumerate(prompts)]
            outs[observed] = [fleet.result(f, timeout=300) for f in fids]
            assert fleet.metrics.replica_deaths == 1
        finally:
            fleet.close()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
