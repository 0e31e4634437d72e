"""The SLO engine and the pool-pressure signal plane armed on the port's
thread fleet (``ServeFleet(slo=)``, ``arm_slo``) and read through the
front door: the counterparts of JAX's ``TestArmedFleet`` and
``TestInertness`` (``tests/test_slo.py``).

THE contract, JAX's: TTFT and ITL are observed at token delivery (one
TTFT per request, one ITL per later token, a migration's cross-replica
gap never read as an ITL), sheds and errors at the edges, the bus is
sampled on the dispatcher thread, ``/healthz`` degrades to 200
"degraded" naming the breaching objective and ``/metrics`` serves the
``quintnet_slo_*`` and ``quintnet_pool_pressure_*`` families; and the
judgment is INERT: an armed fleet serves bit for bit what an unarmed one
serves (sampled, int8 KV, with speculation or chunked prefill, under a
chaos kill). JAX's census half (compile counts unchanged) has no eager
PyTorch meaning; the engines' served-token ledgers are held equal
instead. A crash dump carries the bus's last snapshot.
"""

import http.client
import json
import time

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.fleet import FrontDoor, ServeFleet
from quintnet_tpu_torch.ft import ChaosMonkey
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.obs import SLOConfig, load_crash_dump, \
    parse_exposition
from quintnet_tpu_torch.obs.prom import sample
from quintnet_tpu_torch.serve import ServeEngine, SpecConfig, gpt2_family

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2)
JCFG = JaxGPT2Config.tiny(n_layer=2)


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _factory(params, **kw):
    kwargs = dict(max_slots=2, block_size=4, num_blocks=24, max_seq_len=40)
    kwargs.update(kw)

    def factory():
        return ServeEngine(gpt2_family(CFG), params, device="cpu", **kwargs)

    return factory


def _prompts(rng, lengths):
    return [rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)
            for t in lengths]


def _wait_until(pred, *, timeout=60.0, msg=""):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for: {msg}")
        time.sleep(0.01)


def _kill_r0():
    return ChaosMonkey(kill_at_step=3, mode="raise", target="r0")


def test_fleet_observes_and_samples(params, rng):
    cfg = SLOConfig.serving(ttft_p99_s=60.0, itl_p99_s=60.0,
                            error_rate=0.5, shed_rate=0.5,
                            eval_interval_s=0.01)
    fleet = ServeFleet(_factory(params), n_replicas=2, slo=cfg)
    try:
        assert fleet.slo is not None and fleet.signals is not None
        assert fleet.planner is None             # no pools to move
        fids = [fleet.submit(p, 8) for p in _prompts(rng, (5, 5, 5))]
        [fleet.result(f, timeout=300) for f in fids]
        st = fleet.slo.status()
        obj = st["objectives"]
        assert obj["ttft_p99"]["n_slow"] == 3
        assert obj["itl_p99"]["n_slow"] == 3 * (8 - 1)
        assert obj["error_rate"]["n_slow"] == 3
        assert obj["shed_rate"]["n_slow"] == 3
        assert st["breaching"] == []
        _wait_until(lambda: fleet.signals.value("queue_depth") is not None,
                    msg="bus sampled")
        assert fleet.signals.value("occupancy") is not None
        assert fleet.signals.value("kv_pressure") is not None
        assert fleet.signals.value("breakers_open") == 0.0
        assert fleet.summary()["slo"]["breaching"] == []
    finally:
        fleet.close()


def test_itl_not_polluted_by_migration(params, rng):
    cfg = SLOConfig.serving(itl_p99_s=60.0, eval_interval_s=0.01)
    fleet = ServeFleet(_factory(params), n_replicas=2, slo=cfg,
                       chaos=_kill_r0())
    try:
        fids = [fleet.submit(p, 12) for p in _prompts(rng, (5,) * 4)]
        [fleet.result(f, timeout=300) for f in fids]
        assert fleet.metrics.replica_deaths == 1
        m = fleet.metrics.migrations
        assert m >= 1
        st = fleet.slo.status()["objectives"]["itl_p99"]
        assert 4 * 12 - 4 - m <= st["n_slow"] <= 4 * 12 - 4
        assert st["breaching"] is False
    finally:
        fleet.close()


def test_healthz_degraded_names_breaching_objectives(params, rng):
    cfg = SLOConfig.serving(ttft_p99_s=0.001, eval_interval_s=0.01)
    fleet = ServeFleet(_factory(params), n_replicas=1, slo=cfg)
    try:
        fleet.generate(_prompts(rng, (5,)), max_new_tokens=4, timeout=300)
        with FrontDoor(fleet) as fd:
            def get(path):
                conn = http.client.HTTPConnection(fd.host, fd.port,
                                                  timeout=60)
                conn.request("GET", path)
                r = conn.getresponse()
                body = r.read()
                conn.close()
                return r, body

            _wait_until(lambda: fleet.slo.breaching(), msg="ttft breach")
            r, body = get("/healthz")
            h = json.loads(body)
            assert r.status == 200 and h["status"] == "degraded"
            assert h["slo"]["breaching"] == ["ttft_p99"]
            assert h["slo"]["objectives"]["ttft_p99"]["pool"] == "prefill"
            r, body = get("/metrics")
            parsed = parse_exposition(body.decode())
            assert sample(parsed, "quintnet_slo_breaching",
                          objective="ttft_p99", pool="prefill") == 1.0
            assert any(n.startswith("quintnet_pool_pressure_")
                       for n, _l in parsed)
    finally:
        fleet.close()


def _served(fleet):
    e = fleet.engine_summary()
    return e["gen_tokens"], e["finished"]


@pytest.mark.parametrize("combo", [
    dict(spec=SpecConfig(), kv_dtype="int8", temperature=0.8, top_k=5),
    dict(chunked_prefill=True, prefill_len=16, kv_dtype="int8",
         temperature=0.8, top_k=5),
], ids=["spec+int8+sampled", "chunked+int8+sampled"])
def test_slo_armed_fleet_is_bit_identical(params, rng, combo):
    prompts = _prompts(rng, (5, 7, 30, 6))
    seeds = [60 + i for i in range(4)]
    outs, served = {}, {}
    for armed in (False, True):
        slo = (SLOConfig.serving(ttft_p99_s=0.001, itl_p99_s=0.001,
                                 shed_rate=0.01, eval_interval_s=0.005)
               if armed else None)               # breach-hot on purpose
        fleet = ServeFleet(_factory(params, **combo), n_replicas=2,
                           policy="round_robin", slo=slo)
        try:
            fids = [fleet.submit(p, 10, seed=sd)
                    for p, sd in zip(prompts, seeds)]
            outs[armed] = [fleet.result(f, timeout=300) for f in fids]
            served[armed] = _served(fleet)
            if armed:
                assert fleet.slo.breaching()
        finally:
            fleet.close()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
    assert served[False] == served[True] == (40, 4)


def test_slo_armed_fleet_inert_under_chaos_kill(params, rng):
    prompts = _prompts(rng, (5,) * 4)
    seeds = [80 + i for i in range(4)]
    outs = {}
    for armed in (False, True):
        slo = (SLOConfig.serving(ttft_p99_s=0.001, itl_p99_s=0.001,
                                 eval_interval_s=0.005) if armed else None)
        fleet = ServeFleet(_factory(params, kv_dtype="int8", temperature=0.8,
                                    top_k=5),
                           n_replicas=2, slo=slo, chaos=_kill_r0())
        try:
            fids = [fleet.submit(p, 12, seed=sd)
                    for p, sd in zip(prompts, seeds)]
            outs[armed] = [fleet.result(f, timeout=300) for f in fids]
            assert fleet.metrics.replica_deaths == 1
            if armed:
                assert fleet.slo.breaching()
                assert fleet.signals.value("occupancy") is not None
        finally:
            fleet.close()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


def test_crash_dump_carries_signal_snapshot(params, rng, tmp_path):
    cfg = SLOConfig.serving(ttft_p99_s=60.0, eval_interval_s=0.005)
    fleet = ServeFleet(_factory(params), n_replicas=2, slo=cfg,
                       crash_dir=str(tmp_path), chaos=_kill_r0())
    try:
        fids = [fleet.submit(p, 12) for p in _prompts(rng, (5,) * 4)]
        [fleet.result(f, timeout=300) for f in fids]
        _wait_until(lambda: len(fleet.crash_dumps) == 1,
                    msg="crash dump flushed")
        sig = load_crash_dump(fleet.crash_dumps[0])["signals"]
        assert sig, "signal snapshot missing from the dump"
        assert "gauges" in sig and "sampled_at" in sig
        assert "queue_depth" in sig["gauges"]
    finally:
        fleet.close()
