"""The port's disaggregated prefill/decode serving
(``quintnet_tpu_torch/fleet/proc.py`` ``pools=``, the pool's chain export
and import, ``fleet/wire.py`` KV frames, the engine's ``prefill_only``)
against the JAX package.

THE contract, JAX's (``tests/test_disagg.py``), in layers:

- **pool**: an exported chain imports byte for byte (blocks and scales)
  and becomes a warm prefix hit; a full pool or a cache-off pool imports
  0 (the caller re-prefills: the chain is cache, not state);
- **engine**: a ``prefill_only`` request commits and streams its first
  token with the REAL last flag (as JAX's engine does, held side by
  side), retires with its blocks published, and the decode side's
  continuation — warm through the imported chain or cold through a local
  re-prefill — equals one colocated engine serving the whole request
  bit for bit (greedy and sampled, f32 and int8). The oracle is the
  port's own colocated engine: JAX's int8 + sampled golden fails on
  jax 0.9.0 (ROADMAP.md, §3); greedy f32 is also held to JAX's engine;
- **fleet**: a real two-pool ``ProcessFleet`` serves what a colocated
  process fleet serves, with the handoffs in its metrics; under handoff
  faults (slow tier) every request still finishes equal, through retry
  or the local re-prefill fallback;
- **degradation ladder**: prefill pool down -> the decode pool absorbs
  prefill work (``/healthz`` says ``degraded``); decode pool hard down
  -> new work sheds typed ``Overloaded('pool_down')``.

The multi-process chaos and ladder cases are slow, as JAX's are.
"""

import http.client
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.fleet import FrontDoor as JaxFrontDoor
from quintnet_tpu.fleet import eligible as jax_eligible
from quintnet_tpu.fleet.admission import SHED_REASONS as JAX_SHED_REASONS
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.obs.events import EVENT_KINDS as JAX_EVENT_KINDS
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.fleet import (ANY_POOL, FrontDoor, Overloaded,
                                      ProcessFleet, RetryPolicy, eligible)
from quintnet_tpu_torch.fleet.admission import SHED_REASONS
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.obs.events import EVENT_KINDS
from quintnet_tpu_torch.serve import ServeEngine, gpt2_family
from quintnet_tpu_torch.serve.kv_pool import KVPool
from quintnet_tpu_torch.serve.scheduler import RequestProgress

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2)
JCFG = JaxGPT2Config.tiny(n_layer=2)
FACTORY_FILE = os.path.join(os.path.dirname(__file__),
                            "_torch_proc_factories.py")
SPAWN_TIMEOUT_S = 240.0


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from _torch_proc_factories import write_weights

    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    npt = jax.tree.map(np.asarray, jp)
    path = write_weights(npt, str(tmp_path_factory.mktemp("w")
                                  / "tiny.safetensors"))
    return jp, gpt2_params_from_numpy(npt, "cpu"), path


def _spec(weights, **kw):
    kwargs = {"temperature": 0.8, "top_k": 5, "max_seq_len": 40,
              "num_blocks": 32, "block_size": 4,
              "weights_path": weights[2]}
    kwargs.update(kw)
    return {"file": FACTORY_FILE, "func": "build_tiny_gpt2",
            "kwargs": kwargs}


def _engine(tp, **kw):
    kwargs = dict(max_slots=2, block_size=4, num_blocks=32,
                  max_seq_len=40, temperature=0.8, top_k=5)
    kwargs.update(kw)
    return ServeEngine(gpt2_family(CFG), tp, device="cpu", **kwargs)


def _jax_engine(jp, **kw):
    kwargs = dict(max_slots=2, block_size=4, num_blocks=32,
                  max_seq_len=40, temperature=0.8, top_k=5)
    kwargs.update(kw)
    return JaxServeEngine(jax_gpt2_family(JCFG), jp, **kwargs)


def _colocated_outputs(tp, prompts, seeds, max_new=8, **kw):
    """The oracle: ONE port engine (same spec) serving each request
    whole."""
    eng = _engine(tp, **kw)
    outs = []
    for p, sd in zip(prompts, seeds):
        rid = eng.submit(p, max_new, seed=sd)
        eng.run(max_steps=400)
        outs.append(np.asarray(eng.result(rid)))
    return outs


def _prompts(rng, lengths):
    return [rng.integers(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in lengths]


def _wait_until(pred, *, timeout=60.0, msg=""):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for: {msg}")
        time.sleep(0.02)


# ---------------------------------------------------------------------
# pool layer
# ---------------------------------------------------------------------

def _pool(**kw):
    geo = dict(n_layers=1, n_kv_heads=2, head_dim=4, block_size=4,
               num_blocks=8)
    geo.update(kw)
    return KVPool(**geo, device="cpu")


def _publish_chain(pool, toks):
    blocks = pool.acquire(pool.blocks_for(len(toks)))
    bs = pool.block_size
    for i, b in enumerate(blocks):
        pool.k[:, b * bs:(b + 1) * bs] = i + 1
    pool.publish(toks, blocks, len(toks))
    pool.release(blocks)
    return blocks


def test_missing_chain_exports_none():
    assert _pool().export_chain(np.arange(6, dtype=np.int32)) is None


def test_round_trip_is_byte_exact_and_hits():
    toks = np.arange(10, dtype=np.int32)
    src = _pool(n_layers=2)
    _publish_chain(src, toks)
    chain = src.export_chain(toks)
    dst = _pool(n_layers=2)
    assert dst.import_chain(chain) == 10
    back = dst.export_chain(toks)
    assert back["n_tokens"] == 10
    for a, b in zip(chain["blocks"], back["blocks"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_full_pool_import_returns_zero_not_raises():
    toks = np.arange(10, dtype=np.int32)
    src = _pool()
    _publish_chain(src, toks)
    dst = _pool(num_blocks=4)
    assert dst.acquire(3) is not None        # the pool fully referenced
    assert dst.import_chain(src.export_chain(toks)) == 0


def test_cache_off_import_returns_zero():
    toks = np.arange(8, dtype=np.int32)
    src = _pool()
    _publish_chain(src, toks)
    dst = _pool(prefix_cache=False)
    assert dst.import_chain(src.export_chain(toks)) == 0


def test_incumbent_chain_survives_duplicate_import():
    """A racing local prefill published first: the import keeps the
    incumbent blocks and returns the duplicate's to the free list."""
    toks = np.arange(8, dtype=np.int32)
    src = _pool()
    _publish_chain(src, toks)
    chain = src.export_chain(toks)
    dst = _pool()
    incumbent = _publish_chain(dst, toks)
    free0 = dst.num_free
    dst.import_chain(chain)
    plan = dst.lookup(toks, max_tokens=8)
    assert plan.shared_blocks == incumbent[:len(plan.shared_blocks)]
    assert dst.num_free == free0


# ---------------------------------------------------------------------
# engine layer: prefill_only, held beside JAX's engine
# ---------------------------------------------------------------------

def test_hands_off_with_real_last_flag(weights, rng):
    jp, tp, _ = weights
    prompt = _prompts(rng, (6,))[0]
    got = []
    for eng, kw in ((_engine(tp, temperature=0.0, top_k=0), {}),
                    (_jax_engine(jp, temperature=0.0, top_k=0), {})):
        seen = []
        rid = eng.submit(prompt, 8, prefill_only=True,
                         on_token=lambda r, t, l: seen.append((t, l)))
        eng.run(max_steps=20)
        req = eng.request(rid)
        assert req.handed_off is True and len(req.generated) == 1
        assert seen == [(req.generated[0], False)]   # not last: 7 left
        chain = eng.export_kv_chain(prompt)
        assert chain["n_tokens"] == len(prompt)
        got.append(seen)
    assert got[0] == got[1]


def test_one_token_budget_finishes_normally(weights, rng):
    _jp, tp, _ = weights
    eng = _engine(tp)
    seen = []
    rid = eng.submit(_prompts(rng, (5,))[0], 1, seed=2, prefill_only=True,
                     on_token=lambda r, t, l: seen.append((t, l)))
    eng.run(max_steps=20)
    assert eng.request(rid).handed_off is False    # complete
    assert seen[0][1] is True


def test_eos_on_first_token_finishes_normally(weights, rng):
    _jp, tp, _ = weights
    prompt = _prompts(rng, (5,))[0]
    greedy = _engine(tp, temperature=0.0, top_k=0)
    rid = greedy.submit(prompt, 8, prefill_only=True)
    greedy.run(max_steps=20)
    t0 = greedy.request(rid).generated[0]
    eng = _engine(tp, temperature=0.0, top_k=0, eos_token_id=int(t0))
    seen = []
    rid = eng.submit(prompt, 8, prefill_only=True,
                     on_token=lambda r, t, l: seen.append((t, l)))
    eng.run(max_steps=20)
    req = eng.request(rid)
    assert req.handed_off is False and seen == [(int(t0), True)]
    # the trace's finish event carries the real flag
    assert req.state == "finished"


@pytest.mark.parametrize("kv,sample", [
    ("f32", False), ("f32", True), ("int8", True), ("int8", False),
])
def test_warm_and_cold_match_colocated(weights, rng, kv, sample):
    """prefill engine -> exported chain -> decode engine, warm (chain
    imported) and cold (local re-prefill): both equal one colocated
    engine bit for bit; greedy f32 equals JAX's colocated engine too."""
    jp, tp, _ = weights
    kw = (dict(kv_dtype=kv) if sample
          else dict(kv_dtype=kv, temperature=0.0, top_k=0))
    prompts = _prompts(rng, (5, 7))
    seeds = [40, 41]
    colocated = _colocated_outputs(tp, prompts, seeds, **kw)
    if kv == "f32" and not sample:
        jeng = _jax_engine(jp, **kw)
        for p, want in zip(prompts, colocated):
            r = jeng.submit(p, 8)
            jeng.run(max_steps=400)
            np.testing.assert_array_equal(np.asarray(jeng.result(r)), want)

    for prompt, seed, want in zip(prompts, seeds, colocated):
        a = _engine(tp, **kw)                    # prefill replica
        ra = a.submit(prompt, 8, seed=seed, prefill_only=True)
        a.run(max_steps=50)
        gen = list(a.request(ra).generated)
        chain = a.export_kv_chain(prompt)
        assert chain is not None

        def progress():
            return RequestProgress(rid=0, prompt=prompt, generated=gen,
                                   seed=seed, max_new_tokens=8)

        b = _engine(tp, **kw)                    # decode replica, warm
        assert b.import_kv_chain(chain) == len(prompt)
        rb = b.restore_progress(progress())
        b.run(max_steps=200)
        np.testing.assert_array_equal(b.result(rb), want)
        assert b.metrics.summary()["prefill_tokens_saved"] > 0

        c = _engine(tp, **kw)                    # decode replica, cold
        rc = c.restore_progress(progress())
        c.run(max_steps=200)
        np.testing.assert_array_equal(c.result(rc), want)


# ---------------------------------------------------------------------
# routing / shedding / health units (no processes)
# ---------------------------------------------------------------------

class _StubReplica:
    def __init__(self, name, pool=ANY_POOL, state="healthy", in_flight=0):
        self.name = name
        self.pool = pool
        self.state = state
        self.paused = False
        self.in_flight = in_flight
        self.max_dispatch = 4
        self.outstanding_tokens = 0

    def adapter_resident(self, adapter_id):
        return False


def test_pool_filter_matches_pool_and_any():
    reps = [_StubReplica("prefill0", "prefill"),
            _StubReplica("decode0", "decode"), _StubReplica("c0")]
    for pool in ("prefill", "decode", None):
        assert [r.name for r in eligible(reps, pool=pool)] == \
            [r.name for r in jax_eligible(reps, pool=pool)]
    assert [r.name for r in eligible(reps, pool="prefill")] == \
        ["prefill0", "c0"]
    assert [r.name for r in eligible(reps)] == ["prefill0", "decode0", "c0"]


def test_state_and_window_still_apply():
    reps = [_StubReplica("prefill0", "prefill", state="dead"),
            _StubReplica("prefill1", "prefill", in_flight=4)]
    assert eligible(reps, pool="prefill") == []


def test_thread_replicas_without_pool_attr_match_any_pool():
    class Bare:
        name = "t0"
        state = "healthy"
        paused = False
        in_flight = 0
        max_dispatch = 2

    bare = Bare()
    assert eligible([bare], pool="decode") == [bare]


def test_pool_down_is_a_known_shed_reason():
    assert SHED_REASONS == JAX_SHED_REASONS and "pool_down" in SHED_REASONS
    assert Overloaded("pool_down", "gone").reason == "pool_down"


def test_frontdoor_maps_pool_down_to_503_with_retry_after():
    status, body, headers = FrontDoor(fleet=None)._error_response(
        Overloaded("pool_down", "nope"))
    assert status == 503 and body["reason"] == "pool_down"
    assert "Retry-After" in headers


def test_handoff_event_kinds_registered():
    assert EVENT_KINDS == JAX_EVENT_KINDS
    assert {"handoff", "handoff_retry", "handoff_fallback",
            "pool_degraded", "pool_recovered"} <= EVENT_KINDS


def test_pools_spec_validated():
    with pytest.raises(ValueError, match="exactly"):
        ProcessFleet({"file": "x", "func": "f"}, pools={"prefill": 1},
                     device="cpu")
    with pytest.raises(ValueError, match=">= 1 replica"):
        ProcessFleet({"file": "x", "func": "f"},
                     pools={"prefill": 1, "decode": 0}, device="cpu")


class _StubHealthFleet:
    """Just enough fleet for a front door's /healthz."""

    def __init__(self, pools, draining=False):
        self._pools = pools
        self._draining = draining

    def health(self):
        replicas = {}
        for pool, states in self._pools.items():
            for i, st in enumerate(states):
                replicas[f"{pool}{i}"] = {"state": st, "pool": pool}
        return {
            "replicas": replicas,
            "pools": {
                pool: {"replicas": [f"{pool}{i}"
                                    for i in range(len(states))],
                       "healthy": sum(s == "healthy" for s in states),
                       "starting": 0,
                       "state": ("up" if any(s == "healthy"
                                             for s in states) else "down")}
                for pool, states in self._pools.items()},
            "disaggregated": len(self._pools) > 1,
            "queue_depth": 0, "open_requests": 0,
            "draining": self._draining,
        }


def _get_healthz(fleet, door=FrontDoor):
    with door(fleet) as fd:
        conn = http.client.HTTPConnection(fd.host, fd.port, timeout=10)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        headers = dict(resp.getheaders())
        conn.close()
    return resp.status, body, headers


def _healthz_equal_to_jax(pools, draining=False):
    got = _get_healthz(_StubHealthFleet(pools, draining))
    assert got == _get_healthz(_StubHealthFleet(pools, draining),
                               JaxFrontDoor)
    return got


def test_all_pools_up_is_200_ok():
    status, body, _h = _healthz_equal_to_jax(
        {"prefill": ["healthy"], "decode": ["healthy", "healthy"]})
    assert status == 200 and body["status"] == "ok"


@pytest.mark.parametrize("down_pool", ["prefill", "decode"])
def test_one_pool_down_is_200_degraded(down_pool):
    pools = {"prefill": ["healthy"], "decode": ["healthy"]}
    pools[down_pool] = ["dead"]
    status, body, _h = _healthz_equal_to_jax(pools)
    assert status == 200 and body["status"] == "degraded"
    assert body["pools"][down_pool]["state"] == "down"


def test_both_pools_down_is_503_with_retry_after():
    status, body, headers = _healthz_equal_to_jax(
        {"prefill": ["dead"], "decode": ["dead", "stalled"]})
    assert status == 503 and body["status"] == "unavailable"
    assert "Retry-After" in headers


def test_draining_is_503_even_with_pools_up():
    status, body, _h = _healthz_equal_to_jax(
        {"prefill": ["healthy"], "decode": ["healthy"]}, draining=True)
    assert status == 503 and body["status"] == "unavailable"


def test_colocated_single_pool_keeps_binary_mapping():
    status, body, _h = _healthz_equal_to_jax({"any": ["healthy", "dead"]})
    assert status == 200 and body["status"] == "ok"
    status, body, _h = _healthz_equal_to_jax({"any": ["dead", "dead"]})
    assert status == 503 and body["status"] == "unavailable"


# ---------------------------------------------------------------------
# the real two-pool process fleet
# ---------------------------------------------------------------------

def test_disagg_process_fleet_token_identical_smoke(weights, rng):
    """1 prefill + 1 decode replica process, int8 KV, sampled: every
    output equal to a colocated two-replica process fleet's and to one
    colocated engine's, every request handed off with its chain
    transferred, the decode replica serving warm hits, both pools up."""
    _jp, tp, _ = weights
    prompts = _prompts(rng, (5, 7, 6))
    seeds = [200, 201, 202]
    want = _colocated_outputs(tp, prompts, seeds, kv_dtype="int8")
    colo = ProcessFleet(_spec(weights, kv_dtype="int8"), n_replicas=2,
                        device="cpu", spawn_timeout_s=SPAWN_TIMEOUT_S)
    try:
        colocated = colo.generate(prompts, max_new_tokens=8, seeds=seeds,
                                  timeout=300)
    finally:
        colo.close()
    fleet = ProcessFleet(_spec(weights, kv_dtype="int8"),
                         pools={"prefill": 1, "decode": 1}, device="cpu",
                         heartbeat_s=0.05, spawn_timeout_s=SPAWN_TIMEOUT_S)
    try:
        outs = fleet.generate(prompts, max_new_tokens=8, seeds=seeds,
                              timeout=300)
        for o, c, w in zip(outs, colocated, want):
            np.testing.assert_array_equal(o, c)
            np.testing.assert_array_equal(o, w)
        s = fleet.summary()
        assert s["handoffs"] == s["handoff_transfers"] == 3
        assert s["handoff_fallbacks"] == 0
        assert s["finished"] == s["accepted"] == 3
        assert s["engines"]["decode0"]["prefill_tokens_saved"] > 0
        assert s["replicas"]["prefill0"]["pool"] == "prefill"
        h = fleet.health()
        assert h["disaggregated"] is True
        assert h["pools"]["prefill"]["state"] == "up"
        assert h["pools"]["decode"]["state"] == "up"
        status, body, _h = _get_healthz(fleet)
        assert status == 200 and body["status"] == "ok"
    finally:
        fleet.close()


# ---------------------------------------------------------------------
# chaos + degradation ladder (slow tier: multi-process, multi-fleet)
# ---------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("fault,target", [
    ("kill", "prefill0"),      # exporter SIGKILLed mid-transfer
    ("corrupt", "prefill0"),   # frame damaged after its checksum
    ("stall", "decode0"),      # receiver sits on the frame
])
def test_handoff_chaos_token_identical(weights, rng, fault, target):
    _jp, tp, _ = weights
    prompts = _prompts(rng, (5, 7))
    seeds = [300, 301]
    want = _colocated_outputs(tp, prompts, seeds)
    chaos = {"target": target, "handoff": fault, "rearm": True,
             "handoff_stall_s": 3.0}
    fleet = ProcessFleet(
        _spec(weights), pools={"prefill": 1, "decode": 2}, device="cpu",
        heartbeat_s=0.05, chaos=[chaos], obs=True,
        handoff_retry=RetryPolicy(base_s=0.02, cap_s=0.1, max_attempts=2),
        handoff_timeout_s=1.0, spawn_timeout_s=SPAWN_TIMEOUT_S)
    try:
        outs = fleet.generate(prompts, max_new_tokens=8, seeds=seeds,
                              timeout=300)
        for o, w in zip(outs, want):
            np.testing.assert_array_equal(o, w)
        s = fleet.summary()
        assert s["finished"] == s["accepted"] == 2
        assert s["handoffs"] == 2 and s["handoff_fallbacks"] >= 1
        kinds = {e["kind"] for e in fleet.events.snapshot()}
        assert "handoff_fallback" in kinds
        if fault == "kill":
            assert s["replica_deaths"] >= 1
            assert {"replica_death", "pool_degraded"} <= kinds
    finally:
        fleet.close()


@pytest.mark.slow
def test_prefill_pool_down_decode_absorbs(weights, rng):
    _jp, tp, _ = weights
    prompts = _prompts(rng, (5, 6))
    seeds = [400, 401]
    want = _colocated_outputs(tp, prompts, seeds)
    fleet = ProcessFleet(
        _spec(weights), pools={"prefill": 1, "decode": 1}, device="cpu",
        heartbeat_s=0.05, trip_after=1, breaker_reset_s=300.0, obs=True,
        chaos=[{"target": "prefill0", "kill_at_step": 1, "mode": "hard",
                "rearm": True}], spawn_timeout_s=SPAWN_TIMEOUT_S)
    try:
        outs = fleet.generate(prompts, max_new_tokens=8, seeds=seeds,
                              timeout=300)
        for o, w in zip(outs, want):
            np.testing.assert_array_equal(o, w)
        s = fleet.summary()
        assert s["finished"] == s["accepted"] == 2
        assert s["replica_deaths"] >= 1
        _wait_until(lambda: fleet.health()["pools"]["prefill"]["state"]
                    == "down", timeout=30, msg="prefill pool marked down")
        assert "pool_degraded" in {e["kind"]
                                   for e in fleet.events.snapshot()}
        status, body, _h = _get_healthz(fleet)
        assert status == 200 and body["status"] == "degraded"
    finally:
        fleet.close()


@pytest.mark.slow
def test_cache_off_engines_rejected_at_fleet_startup(weights):
    with pytest.raises(ValueError, match="prefix_cache=True"):
        ProcessFleet(_spec(weights, prefix_cache=False),
                     pools={"prefill": 1, "decode": 1}, device="cpu",
                     heartbeat_s=0.05, spawn_timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.slow
def test_decode_pool_hard_down_sheds_typed(weights, rng):
    prompt = _prompts(rng, (5,))[0]
    fleet = ProcessFleet(
        _spec(weights), pools={"prefill": 1, "decode": 1}, device="cpu",
        heartbeat_s=0.05, trip_after=1, breaker_reset_s=300.0,
        handoff_retry=RetryPolicy(base_s=0.02, cap_s=0.1, max_attempts=2),
        handoff_timeout_s=1.0, spawn_timeout_s=SPAWN_TIMEOUT_S,
        chaos=[{"target": "decode0", "kill_at_step": 1, "mode": "hard",
                "rearm": True}])
    try:
        fid = fleet.submit(prompt, 8, seed=9)
        _wait_until(lambda: fleet.metrics.replica_deaths >= 1
                    and fleet.breaker("decode0").state == "open",
                    timeout=120, msg="decode breaker tripped")
        freq = fleet.request(fid)
        assert not freq.event.is_set() or freq.error is None
        with pytest.raises(Overloaded) as ei:
            fleet.submit(prompt, 8)
        assert ei.value.reason == "pool_down"
        assert fleet.metrics.shed_pool_down == 1
    finally:
        fleet.close()
