"""The port's process fleet and front door
(``quintnet_tpu_torch/fleet/{proc,frontdoor}.py``) against the JAX
package.

THE contract, JAX's (``tests/test_fleet_proc.py``), with a real
``SIGKILL``: a replica PROCESS killed mid-stream takes nothing with it.
Every in-flight request finishes on a survivor, token for token what an
undisturbed run serves, rebuilt from the dispatcher's write-ahead token
journal and the request's seed with no cooperation from the corpse; it
streams in order with ``is_last`` once; the supervisor restarts the dead
replica behind the breaker with jittered backoff. Beside it: the wedge
path (a stalled replica keeps its socket open and stops beating:
detected within the heartbeat budget, distinct from a death), and the
HTTP front door's typed 429/503 + Retry-After, 504 and 400 mapping,
held to JAX's ``FrontDoor`` response for response.

Children build their engines from ``tests/_torch_proc_factories.py`` on
the CPU (``device="cpu"``), serving the JAX package's weights bridged
through a safetensors file, so greedy streams are held to JAX's own
in-process ``ServeEngine`` and sampled ones to the port's
``gpt2_generate`` at each request's seed (the fid by default). The fast
tier holds the two-process smoke, quantized weights, the stall and the
front door; the SIGKILL 1-of-3 and breaker cases are slow, as JAX's are.
Every fleet is closed in ``finally`` and every wait has a timeout.
"""

import http.client
import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.fleet import FrontDoor as JaxFrontDoor
from quintnet_tpu.fleet import Overloaded as JaxOverloaded
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.serve import DeadlineExceeded as JaxDeadlineExceeded
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.fleet import (HEALTHY, Backoff, FrontDoor,
                                      Overloaded, ProcessFleet,
                                      ServeFleet)
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
from quintnet_tpu_torch.serve import ServeEngine, gpt2_family
from quintnet_tpu_torch.serve.scheduler import DeadlineExceeded

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2)
JCFG = JaxGPT2Config.tiny(n_layer=2)
TEMP, TOPK = 0.8, 5
FACTORY_FILE = os.path.join(os.path.dirname(__file__),
                            "_torch_proc_factories.py")
SPAWN_TIMEOUT_S = 240.0     # generous: spawns share the box with xdist


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's tiny GPT-2, bridged: (JAX params, port params, the file the
    children load)."""
    from _torch_proc_factories import write_weights

    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    npt = jax.tree.map(np.asarray, jp)
    path = write_weights(npt, str(tmp_path_factory.mktemp("w")
                                  / "tiny.safetensors"))
    return jp, gpt2_params_from_numpy(npt, "cpu"), path


def _spec(weights, **kw):
    kwargs = {"temperature": TEMP, "top_k": TOPK, "max_seq_len": 40,
              "weights_path": weights[2]}
    kwargs.update(kw)
    return {"file": FACTORY_FILE, "func": "build_tiny_gpt2",
            "kwargs": kwargs}


def _fleet(weights, spec_kw=None, **kw):
    return ProcessFleet(_spec(weights, **(spec_kw or {})), device="cpu",
                        spawn_timeout_s=SPAWN_TIMEOUT_S, **kw)


def _sampled(tp, prompt, max_new, seed, temperature=TEMP, top_k=TOPK):
    """The port's oracle at ``seed``."""
    return np.asarray(gpt2_generate(
        tp, prompt[None], CFG, max_new_tokens=max_new,
        temperature=temperature, top_k=top_k, seed=seed)[0])


def _jax_greedy_engine(jp, prompts, max_new):
    """JAX's in-process engine, greedy, on the same weights."""
    eng = JaxServeEngine(jax_gpt2_family(JCFG), jp, max_slots=2,
                         block_size=4, num_blocks=24, max_seq_len=40)
    rids = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    return [np.asarray(eng.result(r)) for r in rids]


def _prompts(rng, lengths):
    return [rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)
            for t in lengths]


def _wait_until(pred, *, timeout=60.0, msg=""):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for: {msg}")
        time.sleep(0.01)


# ---------------------------------------------------------------------
# fast tier: the 2-process spawn smoke
# ---------------------------------------------------------------------

def test_two_process_spawn_smoke(weights, rng):
    """Spawn 2 replica processes, serve greedy requests through real
    sockets equal to JAX's in-process engine on the same weights, answer
    HTTP at the front door, report each child's K4 launches (none on the
    CPU: the plain version runs), reject never-admissible work at the
    parent, and drain cleanly."""
    jp, _tp, _path = weights
    t0 = time.monotonic()
    fleet = _fleet(weights, dict(temperature=0.0, top_k=0),
                   n_replicas=2, policy="least_work")
    try:
        with pytest.raises(ValueError, match="exceeds max_seq_len"):
            fleet.submit(np.zeros(39, np.int32), 8)
        with pytest.raises(ValueError, match="empty prompt"):
            fleet.submit(np.zeros(0, np.int32), 4)
        assert fleet.metrics.accepted == 0

        prompts = _prompts(rng, (5, 7, 3, 6))
        outs = fleet.generate(prompts, max_new_tokens=8, timeout=300)
        for o, want in zip(outs, _jax_greedy_engine(jp, prompts, 8)):
            np.testing.assert_array_equal(o, want)

        stats = fleet.replica_stats()
        assert sum(s["admitted"] for s in stats.values()) == 4
        for name, s in stats.items():
            assert s["k4"] == {"launches": 0, "by_path": {},
                               "by_variant": {}}, name
            assert s["decode_steps"] == s["metrics"]["decode_steps"]
        # the children's recompile sentinels, over the wire: one decode
        # program, at most one program per prefill bucket
        fleet.assert_compile_count()
        for name, s in stats.items():
            if s["admitted"]:
                assert s["compile"]["decode"] == 1, (name, s["compile"])
                assert 1 <= sum(n for k, n in s["compile"].items()
                                if k.startswith("prefill[")) <= 3
        h = fleet.health()
        assert all(r["state"] == HEALTHY for r in h["replicas"].values())
        assert fleet.summary()["tokens_delivered"] == 32

        with FrontDoor(fleet) as fd:
            conn = http.client.HTTPConnection(fd.host, fd.port,
                                              timeout=300)
            conn.request("POST", "/v1/generate", json.dumps(
                {"prompt": [int(t) for t in prompts[0]],
                 "max_new_tokens": 6, "seed": 77}), {})
            r = conn.getresponse()
            body = json.loads(r.read())
            assert r.status == 200
            np.testing.assert_array_equal(
                np.asarray(body["output"], np.int32),
                _jax_greedy_engine(jp, prompts[:1], 6)[0])
            conn2 = http.client.HTTPConnection(fd.host, fd.port,
                                               timeout=30)
            conn2.request("GET", "/healthz")
            r2 = conn2.getresponse()
            assert r2.status == 200
            assert json.loads(r2.read())["status"] == "ok"
    finally:
        fleet.drain(timeout=120)
    with pytest.raises(Overloaded) as ei:
        fleet.submit(np.ones(4, np.int32), 4)
    assert ei.value.reason == "shutdown"
    for rep in fleet.replicas:
        assert not rep.proc.is_alive() and rep.proc.exitcode == 0
    print(f"two-process smoke wall {time.monotonic() - t0:.1f} s")


def test_lock_audit_process_fleet_serves_audited(weights, rng):
    """``lock_audit=True``: the parent's condition and the replica's
    ring and send locks are instrumented locks of one order graph; the
    greedy streams equal JAX's engine, no inversion is seen, and the
    ledgers count the parent's acquisitions."""
    jp, _tp, _path = weights
    fleet = _fleet(weights, dict(temperature=0.0, top_k=0), n_replicas=1,
                   lock_audit=True)
    try:
        prompts = _prompts(rng, (5, 3))
        outs = fleet.generate(prompts, max_new_tokens=6, timeout=300)
        for o, want in zip(outs, _jax_greedy_engine(jp, prompts, 6)):
            np.testing.assert_array_equal(o, want)
        fleet.assert_compile_count()
        s = fleet.lock_audit.summary()
        assert s["order_violations"] == 0
        assert s["locks"]["fleet._cv"]["acquisitions"] > 0
        assert s["locks"]["proc.p0._send_lock"]["acquisitions"] > 0
        assert "proc.p0._ring_lock" in s["locks"]
        # the front door's /metrics renders the audit's ledgers
        from quintnet_tpu_torch.obs import parse_exposition

        with FrontDoor(fleet) as fd:
            conn = http.client.HTTPConnection(fd.host, fd.port, timeout=60)
            conn.request("GET", "/metrics")
            r = conn.getresponse()
            assert r.status == 200
            parsed = parse_exposition(r.read().decode())
        assert parsed[("quintnet_lock_acquisitions_total",
                       (("lock", "fleet._cv"),))] > 0
        assert parsed[("quintnet_lock_order_violations_total", ())] == 0
    finally:
        fleet.drain(timeout=120)


def test_cuda_asked_for_without_a_card_fails_at_spawn(weights):
    """A child asked for CUDA where there is none raises before its
    hello: the fleet fails to start, it never serves from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises(RuntimeError, match="failed to start"):
        ProcessFleet(_spec(weights), n_replicas=1,
                     spawn_timeout_s=SPAWN_TIMEOUT_S)


def test_process_replica_serves_quantized_weights(weights, rng):
    """A replica built with ``weights_dtype="fake_quant"`` rides the same
    spawn path bit for bit with the dense oracle, and each child's
    stats frame carries the weight-bytes accounting."""
    _jp, tp, _path = weights
    fleet = _fleet(weights, dict(weights_dtype="fake_quant"),
                   n_replicas=2, policy="round_robin")
    try:
        prompts = _prompts(rng, (5, 4))
        seeds = [500, 501]
        outs = fleet.generate(prompts, max_new_tokens=6, seeds=seeds,
                              timeout=300)
        for p, sd, o in zip(prompts, seeds, outs):
            np.testing.assert_array_equal(o, _sampled(tp, p, 6, sd))
        engines = fleet.summary()["engines"]
        assert engines
        for name, s in engines.items():
            assert s["weights_dtype"] == "fake_quant", name
            assert s["weight_bytes"] > 0, name
    finally:
        fleet.drain(timeout=120)


def test_stalled_replica_detected_and_routed_around(weights, rng):
    """chaos mode='stall' makes p1 stop beating (and stepping) with its
    socket open: the dispatcher detects the silence within the budget,
    migrates p1's work from the journal, finishes everything token for
    token on p0, SIGKILLs the zombie and restarts it; ``stalls`` counts
    apart from ``replica_deaths``."""
    _jp, tp, _path = weights
    fleet = _fleet(weights, n_replicas=2, policy="round_robin",
                   heartbeat_s=0.05, heartbeat_budget_s=2.0,
                   backoff=Backoff(base_s=0.01, cap_s=0.1))
    try:
        fleet.arm_chaos("p1", {"kill_at_step": 2, "mode": "stall"})
        prompts = _prompts(rng, (5, 7, 3, 6))
        seeds = [900 + i for i in range(4)]
        fids = [fleet.submit(p, 16, seed=sd)
                for p, sd in zip(prompts, seeds)]
        outs = [fleet.result(f, timeout=300) for f in fids]
        for p, sd, o in zip(prompts, seeds, outs):
            np.testing.assert_array_equal(o, _sampled(tp, p, 16, sd))
        m = fleet.metrics
        assert m.stalls == 1 and m.replica_deaths == 0
        assert m.migrations >= 1
        assert m.finished == 4 and m.shed == 0
        _wait_until(lambda: fleet.metrics.restarts >= 1,
                    msg="breaker-gated restart of the stalled replica")
        _wait_until(lambda: fleet.replica("p1").state == HEALTHY,
                    timeout=SPAWN_TIMEOUT_S,
                    msg="restarted replica back to healthy")
    finally:
        fleet.drain(timeout=120)


# ---------------------------------------------------------------------
# fast tier: the front door over the thread fleet (the HTTP contract is
# the same over either fleet)
# ---------------------------------------------------------------------

@pytest.fixture
def thread_fleet(weights):
    tp = weights[1]

    def factory():
        return ServeEngine(gpt2_family(CFG), tp, device="cpu", max_slots=2,
                           block_size=4, num_blocks=24, max_seq_len=24,
                           temperature=TEMP, top_k=TOPK)

    fleet = ServeFleet(factory, n_replicas=1, max_pending=2)
    yield fleet
    fleet.close()


def _post(fd, payload, timeout=300):
    conn = http.client.HTTPConnection(fd.host, fd.port, timeout=timeout)
    conn.request("POST", "/v1/generate", json.dumps(payload), {})
    r = conn.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def test_frontdoor_overload_maps_to_typed_429_503(thread_fleet):
    """queue_full -> 429 + Retry-After, an expired deadline at submit
    and a draining fleet -> 503 + Retry-After, a never-admissible
    request -> 400; the bounded queue never grows past max_pending."""
    fleet = thread_fleet
    with FrontDoor(fleet, retry_after_s=2.0) as fd:
        fleet.pause_all()
        body = {"prompt": [1, 2, 3], "max_new_tokens": 4}
        fleet.submit([1, 2, 3], 4)
        fleet.submit([1, 2, 3], 4)
        for _ in range(2):
            status, headers, raw = _post(fd, body, timeout=30)
            assert status == 429 and headers.get("Retry-After") == "2"
            payload = json.loads(raw)
            assert payload["error"] == "overloaded"
            assert payload["reason"] == "queue_full"
        assert len(fleet._queue) <= 2

        status, headers, raw = _post(fd, dict(body, deadline_s=0),
                                     timeout=30)
        assert status == 503 and headers.get("Retry-After") == "2"
        assert json.loads(raw)["reason"] == "deadline"

        status, _h, raw = _post(
            fd, {"prompt": [1] * 23, "max_new_tokens": 8}, timeout=30)
        assert status == 400
        assert "max_seq_len" in json.loads(raw)["message"]

        fleet.resume_all()
        _wait_until(lambda: fleet.metrics.finished
                    >= fleet.metrics.accepted, timeout=300,
                    msg="queued work finishes after resume")
        fleet.drain(timeout=120)
        status, headers, raw = _post(fd, body, timeout=30)
        assert status == 503 and headers.get("Retry-After") == "2"
        assert json.loads(raw)["reason"] == "shutdown"


def test_frontdoor_stream_and_error_mapping_units(thread_fleet, weights):
    """SSE delivers every token once, then one done event whose output
    is the port's oracle at the body's seed; the typed-error table is
    pinned as a unit."""
    fleet = thread_fleet
    fd = FrontDoor(fleet, retry_after_s=1.0)
    status, payload, headers = fd._error_response(
        Overloaded("queue_full", "full"))
    assert (status, headers["Retry-After"]) == (429, "1")
    status, payload, _ = fd._error_response(
        DeadlineExceeded("late", rid=1, generated=3))
    assert status == 504 and payload["generated"] == 3
    status, _p, headers = fd._error_response(Overloaded("shutdown", "bye"))
    assert status == 503 and headers["Retry-After"] == "1"
    assert fd._error_response(TimeoutError("slow"))[0] == 504
    assert fd._error_response(ValueError("bad"))[0] == 400

    with FrontDoor(fleet) as live:
        conn = http.client.HTTPConnection(live.host, live.port,
                                          timeout=300)
        conn.request("POST", "/v1/generate", json.dumps(
            {"prompt": [4, 5, 6], "max_new_tokens": 5, "seed": 9,
             "stream": True}), {})
        r = conn.getresponse()
        assert r.status == 200
        assert r.getheader("Content-Type") == "text/event-stream"
        events = [e for e in r.read().decode().split("\n\n") if e.strip()]
        toks = [json.loads(e.split("data: ", 1)[1])
                for e in events if e.startswith("data: ")]
        done = [e for e in events if e.startswith("event: done")]
        assert len(done) == 1
        final = json.loads(done[0].split("data: ", 1)[1])
        assert [t["token"] for t in toks] == final["output"][3:]
        assert [t["last"] for t in toks].count(True) == 1
        assert toks[-1]["last"] is True
        np.testing.assert_array_equal(
            final["output"],
            _sampled(weights[1], np.asarray([4, 5, 6], np.int32), 5, 9))


class _StubFleet:
    """Just enough fleet for a front door: ``submit`` raises the typed
    error under test (the port's or JAX's kind), ``result`` times out."""

    def __init__(self, error):
        self.error = error
        self.metrics = None

    def submit(self, *a, **kw):
        raise self.error

    def queue_oldest_wait_s(self):
        return 3.2


def _errors(overloaded, deadline_exceeded):
    return [overloaded("queue_full", "full"),
            overloaded("shutdown", "bye"),
            overloaded("deadline", "late"),
            overloaded("pool_down", "gone"),
            deadline_exceeded("late", rid=1, generated=3),
            TimeoutError("slow"), ValueError("bad prompt"),
            KeyError("tenant-z"), TypeError("null field"),
            RuntimeError("boom")]


@pytest.mark.parametrize("i", range(10))
def test_frontdoor_typed_errors_equal_jax_over_http(i):
    """For each typed error a fleet can raise at submit, the port's front
    door answers what JAX's answers over the same stub fleet: status,
    Retry-After (raised to the queue's oldest wait) and body."""
    got = []
    for door, err in (
            (FrontDoor, _errors(Overloaded, DeadlineExceeded)[i]),
            (JaxFrontDoor, _errors(JaxOverloaded, JaxDeadlineExceeded)[i])):
        with door(_StubFleet(err), retry_after_s=1.0) as fd:
            status, headers, raw = _post(
                fd, {"prompt": [1, 2], "max_new_tokens": 3}, timeout=30)
        got.append((status, headers.get("Retry-After"),
                    headers.get("Content-Type"), json.loads(raw)))
    assert got[0] == got[1]
    assert got[0][0] in (400, 429, 500, 503, 504)


# ---------------------------------------------------------------------
# slow tier: the process-kill goldens (real SIGKILL, 3 replicas)
# ---------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (TEMP, TOPK)],
                         ids=["greedy", "sampled"])
def test_sigkill_one_of_three_migrates_token_identically(
        weights, rng, temperature, top_k):
    """``os.kill(pid, SIGKILL)`` on p1 of 3 mid-stream: no export, no exit
    handler; the dispatcher rebuilds every in-flight request from its
    journal and seed and the survivors finish them token for token the
    oracle (greedy: JAX's engine; sampled: the port's ``gpt2_generate``
    at the seed). The streamed request delivers in order with is_last
    once; the supervisor restarts the corpse."""
    jp, tp, _path = weights
    fleet = _fleet(weights, dict(temperature=temperature, top_k=top_k),
                   n_replicas=3, policy="round_robin", heartbeat_s=0.05,
                   backoff=Backoff(base_s=0.01, cap_s=0.1))
    try:
        prompts = _prompts(rng, (5, 7, 3, 6, 4, 8, 5, 6, 4))
        seeds = [500 + i for i in range(9)]
        streamed, fids = [], []
        for i, (p, sd) in enumerate(zip(prompts, seeds)):
            cb = ((lambda fid, tok, last: streamed.append((tok, last)))
                  if i == 1 else None)        # round_robin: i=1 -> p1
            fids.append(fleet.submit(p, 24, seed=sd, on_token=cb))
        victim = fleet.replica("p1")
        _wait_until(lambda: len(streamed) >= 3, timeout=120,
                    msg="victim replica streaming")
        assert len(streamed) < 24
        os.kill(victim.pid, signal.SIGKILL)
        outs = [fleet.result(f, timeout=300) for f in fids]
        if temperature == 0.0:
            eng = JaxServeEngine(jax_gpt2_family(JCFG), jp, max_slots=2,
                                 block_size=4, num_blocks=32,
                                 max_seq_len=40)
            rids = [eng.submit(p, 24) for p in prompts]
            eng.run()
            wants = [np.asarray(eng.result(r)) for r in rids]
        else:
            wants = [_sampled(tp, p, 24, sd) for p, sd in zip(prompts,
                                                                seeds)]
        for o, w in zip(outs, wants):
            np.testing.assert_array_equal(o, w)
        m = fleet.metrics
        assert m.replica_deaths == 1 and m.migrations >= 1
        assert m.finished == 9 and m.shed == 0
        toks = [t for t, _ in streamed]
        np.testing.assert_array_equal(np.asarray(toks, np.int32),
                                      outs[1][len(prompts[1]):])
        assert [last for _, last in streamed].count(True) == 1
        assert streamed[-1][1] is True
        _wait_until(lambda: fleet.metrics.restarts >= 1,
                    timeout=SPAWN_TIMEOUT_S,
                    msg="supervisor restart of the killed replica")
    finally:
        fleet.drain(timeout=180)


@pytest.mark.slow
def test_repeated_kills_trip_breaker_and_backoff_spaces_restarts(weights,
                                                                 rng):
    """Chaos armed with rearm: every restarted p0 dies again at its 2nd
    step (mode='hard'). After trip_after consecutive deaths the breaker
    opens, restarts stop, p1 keeps serving, and every accepted request
    still finishes equal to the oracle."""
    _jp, tp, _path = weights
    fleet = _fleet(weights, n_replicas=2, policy="round_robin",
                   heartbeat_s=0.05, trip_after=2, breaker_reset_s=3600.0,
                   backoff=Backoff(base_s=0.01, cap_s=0.05),
                   chaos={"target": "p0", "kill_at_step": 2,
                          "mode": "hard", "rearm": True})
    try:
        served = 0
        deadline = time.monotonic() + 240.0
        while (fleet.breaker("p0").state != "open"
               and time.monotonic() < deadline):
            p = _prompts(rng, (5,))[0]
            fid = fleet.submit(p, 8, seed=700 + served)
            np.testing.assert_array_equal(fleet.result(fid, timeout=300),
                                          _sampled(tp, p, 8, 700 + served))
            served += 1
            threading.Event().wait(0.05)
        assert fleet.breaker("p0").state == "open", \
            f"breaker never tripped after {served} requests"
        assert fleet.metrics.replica_deaths >= 2
        assert fleet.metrics.restarts >= 1
        assert fleet.metrics.finished == served
        assert fleet.replica("p1").state == HEALTHY
        p = _prompts(rng, (6,))[0]
        np.testing.assert_array_equal(
            fleet.generate([p], max_new_tokens=6, seeds=[999],
                           timeout=300)[0], _sampled(tp, p, 6, 999))
    finally:
        fleet.drain(timeout=180)
