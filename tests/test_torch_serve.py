"""The port's serving engine (quintnet_tpu_torch/serve/) against the JAX
engine.

THE contract: on the same weights (JAX ``gpt2_init``, bridged) and the
same prompts, ``ServeEngine(device="cpu")`` produces greedy token
streams IDENTICAL to the JAX ``ServeEngine(attn_kernel="xla")`` —
through staggered arrivals, prefix-cache hits with copy-on-write, and
preemption under a small pool. Plus the port's own surfaces
(``generate`` / ``generate_stream``), the pool/scheduler bookkeeping
against the JAX twins, and every option that is not ported raising.
"""

import time

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.analysis.specs import prefill_buckets as jax_buckets
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.serve import KVPool as JaxKVPool
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu_torch.analysis.specs import prefill_buckets
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.serve import (KVPool, ServeEngine, generate,
                                      generate_stream, gpt2_family)

torch.set_num_threads(1)

N_LAYER = 2
JCFG = JaxGPT2Config.tiny(n_layer=N_LAYER)
CFG = GPT2Config.tiny(n_layer=N_LAYER)


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _engines(params, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("max_seq_len", 40)
    jp, tp = params
    return (JaxServeEngine(jax_gpt2_family(JCFG), jp, attn_kernel="xla",
                           **kw),
            ServeEngine(gpt2_family(CFG), tp, device="cpu", **kw))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in lengths]


def _drive(eng, script):
    """Run a request script: entries ``(arrival_step, prompt, max_new)``
    or ``("after", i, tail, max_new)`` — submitted once request ``i``
    has finished, with request i's published chain (its output minus
    the last token, whose KV was never written) plus ``tail`` as the
    prompt. Returns outputs in script order."""
    rids, outs = {}, {}
    step = 0
    while len(rids) < len(script) or eng.has_work:
        for i, entry in enumerate(script):
            if i in rids:
                continue
            if entry[0] == "after":
                _, j, tail, max_new = entry
                if j in rids and eng.request(rids[j]).state == "finished":
                    prompt = np.concatenate([eng.result(rids[j])[:-1],
                                             tail])
                    rids[i] = eng.submit(prompt, max_new)
            elif entry[0] <= step:
                rids[i] = eng.submit(entry[1], entry[2])
        eng.step()
        step += 1
        assert step < 500, "engine failed to drain"
    for i, r in rids.items():
        outs[i] = eng.result(r)
    return [outs[i] for i in range(len(script))]


@pytest.mark.parametrize("kw", [{}, {"eos_token_id": 95},
                                {"prefix_cache": False},
                                {"kv_dtype": "bf16"}],
                         ids=["default", "eos", "cache_off", "bf16_pool"])
def test_greedy_streams_identical_to_jax(params, kw):
    prompts = _prompts(0, (5, 9, 3, 12, 7))
    je, te = _engines(params, **kw)
    script = [(0, p, 8) for p in prompts]
    want, got = _drive(je, script), _drive(te, script)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert te.metrics.decode_tokens == je.metrics.decode_tokens
    if "eos_token_id" in kw:
        assert any(len(g) < len(p) + 8 for g, p in zip(got, prompts))


def test_priority_policy_admits_like_jax(params):
    """One slot, priority policy: the urgent requests submitted last
    are admitted first in both engines (ties in arrival order), and the
    streams stay identical."""
    prompts = _prompts(7, (6, 5, 4, 7))
    prios = [5, 5, 0, 1]
    je, te = _engines(params, max_slots=1, policy="priority")
    orders = []
    for eng in (je, te):
        rids = [eng.submit(p, 4, priority=pr)
                for p, pr in zip(prompts, prios)]
        eng.run()
        orders.append([eng.request(r).admit_seq for r in rids])
        outs = [eng.result(r) for r in rids]
        if eng is je:
            want = outs
    for w, g in zip(want, outs):
        np.testing.assert_array_equal(g, w)
    assert orders[0] == orders[1] == [2, 3, 0, 1]


def test_staggered_prefix_cow_preemption_identical_to_jax(params):
    """Seven requests, staggered; request 3 shares request 0's prompt
    prefix (two full blocks -> a prefix hit), request 5 continues
    request 1's conversation (its chain ends inside a block -> copy on
    write), request 6 continues request 5's; a 16-block pool under
    three slots forces preemption."""
    p = _prompts(1, (8, 9, 6, 3, 10))
    shared = np.concatenate([p[0][:8], p[3]])
    tail = _prompts(2, (3, 2))
    script = [(0, p[0], 10), (0, p[1], 10), (1, p[2], 10), (2, shared, 8),
              (3, p[4], 9), ("after", 1, tail[0], 8),
              ("after", 5, tail[1], 6)]
    je, te = _engines(params, max_slots=3, num_blocks=16)
    cows = []
    prefill = te._prefill

    def spy(ids, start, t0, table_row, cow_src, cow_len):
        cows.append(cow_len)
        return prefill(ids, start, t0, table_row, cow_src, cow_len)

    te._prefill = spy
    want, got = _drive(je, script), _drive(te, script)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    m = te.metrics
    assert m.preempted >= 1
    assert m.prefix_hit_tokens >= 8
    assert any(c > 0 for c in cows), "no copy-on-write admission"
    assert m.finished == len(script)
    assert te.pool.num_used == 0
    assert (m.preempted, m.prefix_hit_tokens) == (je.metrics.preempted,
                                                  je.metrics.prefix_hit_tokens)


def test_generate_and_stream_agree_with_engine(params):
    prompts = _prompts(3, (6, 11, 4))
    _, te = _engines(params)
    outs = generate(te, prompts, max_new_tokens=[5, 7, 3])
    script = [(0, q, n) for q, n in zip(prompts, (5, 7, 3))]
    _, fresh = _engines(params)
    for a, b in zip(outs, _drive(fresh, script)):
        np.testing.assert_array_equal(a, b)
    seen = []
    full = generate_stream(te, prompts[1], max_new_tokens=7,
                           on_token=lambda rid, t, last: seen.append(
                               (t, last)))
    np.testing.assert_array_equal(full, outs[1])
    assert [t for t, _ in seen] == list(full[len(prompts[1]):])
    assert [last for _, last in seen] == [False] * 6 + [True]


def test_warmup_touches_no_request_state(params):
    _, te = _engines(params)
    te.warmup()
    assert te.metrics.steps == 0 and te.pool.num_used == 0
    out = generate(te, _prompts(4, (5,)), max_new_tokens=4)[0]
    _, fresh = _engines(params)
    np.testing.assert_array_equal(
        out, generate(fresh, _prompts(4, (5,)), max_new_tokens=4)[0])


def test_submit_rejects_what_can_never_run(params):
    _, te = _engines(params, num_blocks=3, max_seq_len=16)
    with pytest.raises(ValueError, match="KV pool too small"):
        te.submit(_prompts(5, (3,))[0], 8)
    with pytest.raises(ValueError, match="max_seq_len"):
        te.submit(_prompts(5, (10,))[0], 8)
    assert not te.has_work


@pytest.mark.parametrize("option,value", [
    ("adapters", object()), ("kv_tier_bytes", 1 << 20),
    ("weights_dtype", "int8")])
def test_unported_options_raise(params, option, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(gpt2_family(CFG), params[1], device="cpu",
                    **{option: value})


def test_custom_prefill_ladder_streams_identical_to_jax(params):
    """``prefill_len`` and ``prefill_bucket_sizes`` as the JAX engine
    takes them (``quintnet_tpu/serve/engine.py:470-483``): the same
    ladder, the same greedy streams."""
    kw = dict(prefill_len=24, prefill_bucket_sizes=(24, 6, 12, 6))
    je, te = _engines(params, **kw)
    assert te.prefill_buckets == je.prefill_buckets == (6, 12, 24)
    assert te.limits()["prefill_len"] == 24
    script = [(0, p, 6) for p in _prompts(3, (5, 9, 3, 13, 7))]
    for w, g in zip(_drive(je, script), _drive(te, script)):
        np.testing.assert_array_equal(g, w)
    for eng in (je, te):     # prompt + new - 1 past prefill_len: never
        with pytest.raises(ValueError, match="prefill_len"):
            eng.submit(_prompts(4, (20,))[0], 8)


@pytest.mark.parametrize("kw", [
    dict(prefill_len=24, prefill_bucket_sizes=(4, 8, 16)),
    dict(prefill_bucket_sizes=(8, 16)),
    dict(prefill_bucket_sizes=(0, 8, 40))],
    ids=["short_of_prefill_len", "short_of_max_seq_len", "zero_bucket"])
def test_bad_prefill_ladder_raises_in_both(params, kw):
    jp, tp = params
    base = dict(max_slots=4, block_size=4, num_blocks=48, max_seq_len=40)
    with pytest.raises(ValueError, match="bucket"):
        JaxServeEngine(jax_gpt2_family(JCFG), jp, **base, **kw)
    with pytest.raises(ValueError, match="bucket"):
        ServeEngine(gpt2_family(CFG), tp, device="cpu", **base, **kw)


# each JAX option the port does not serve yet: a value that asks for it,
# the JAX default ("off"), and the ROADMAP.md item its message names
JAX_ONLY_OPTIONS = {
    "lora_targets": (("qkv",), None, "item 7"),
    "lora_max_rank": (16, 8, "item 7"),
    "lora_rank_bucket_sizes": ((4, 8), None, "item 7"),
    "kv_tier_promote_budget_bytes": (1 << 20, None, "item 7"),
    "logger": (print, None, "item 8"), "log_every": (10, 0, "item 8"),
    "clock": (lambda: 0.0, time.monotonic, "item 8"),
    "tracer": (object(), None, "item 8"),
    "recorder": (object(), None, "item 8"),
}


@pytest.mark.parametrize("option", sorted(JAX_ONLY_OPTIONS))
def test_jax_only_options_raise_naming_their_item(params, option):
    on, off, item = JAX_ONLY_OPTIONS[option]
    with pytest.raises(NotImplementedError, match=item):
        ServeEngine(gpt2_family(CFG), params[1], device="cpu",
                    **{option: on})
    eng = ServeEngine(gpt2_family(CFG), params[1], device="cpu",
                      max_seq_len=40, **{option: off})
    assert eng.prefill_buckets == prefill_buckets(40)


@pytest.mark.parametrize("option,on,off", [
    ("temperature", 0.7, 0.0), ("top_k", 40, 0), ("top_p", 0.9, 1.0)])
def test_sampling_options_are_served(params, option, on, off):
    """The sampling options, once refused naming item 5, are served: the
    engine takes a value that asks for them and their JAX default."""
    eng = ServeEngine(gpt2_family(CFG), params[1], device="cpu",
                      **{option: on})
    assert getattr(eng, option) == on
    eng = ServeEngine(gpt2_family(CFG), params[1], device="cpu",
                      max_seq_len=40, **{option: off})
    assert getattr(eng, option) == off
    assert eng.prefill_buckets == prefill_buckets(40)


def test_attn_kernel_takes_xla_only(params):
    ServeEngine(gpt2_family(CFG), params[1], device="cpu", attn_kernel="xla")
    with pytest.raises(ValueError, match="'xla' only"):
        ServeEngine(gpt2_family(CFG), params[1], device="cpu",
                    attn_kernel="pallas")


@pytest.mark.parametrize("n", [1, 16, 40, 100, 1024])
def test_prefill_buckets_match_jax(n):
    assert prefill_buckets(n) == jax_buckets(n)


def test_pool_bookkeeping_matches_jax():
    """The same acquire / publish / release / lookup sequence on both
    pools gives the same blocks, plans and counters."""
    kw = dict(n_layers=1, n_kv_heads=1, head_dim=4, block_size=4,
              num_blocks=9)
    jpool, tpool = JaxKVPool(**kw), KVPool(**kw, device="cpu")
    rng = np.random.default_rng(6)
    toks = [rng.integers(0, 50, 14).astype(np.int32) for _ in range(3)]
    toks[1][:8] = toks[0][:8]
    for pool in (jpool, tpool):
        held = [pool.acquire(4), pool.acquire(4)]
        pool.publish(toks[0], held[0], 14)
        pool.publish(toks[1], held[1], 10)
        for h in held:
            pool.release(h)
    for t in toks:
        a, b = jpool.plan_admission(t, 15), tpool.plan_admission(t, 15)
        assert vars(a) == vars(b)
    assert jpool.acquire(7) == tpool.acquire(7)
    assert (jpool.cache_evictions, jpool.num_cached, jpool.num_free) == (
        tpool.cache_evictions, tpool.num_cached, tpool.num_free)
