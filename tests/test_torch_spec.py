"""The port's speculative decoding (``serve/spec.py``, the tentative blocks
of ``serve/kv_pool.py``, ``ServeEngine(spec=...)``) against the JAX
package.

THE contract, JAX's (``tests/test_spec.py``): spec-on output is the
spec-off output for every request, greedy and sampled, under preemption
and with the prefix cache; tentative blocks are resolved within their
step and never published. Here on the CPU, on the same weights (JAX's
``gpt2_init``, bridged):

- the drafter, ``SpecConfig`` and ``verify_buckets`` against JAX's on
  random and repetitive contexts;
- the tentative pool against JAX's rules;
- greedy: the port's spec-on streams == its spec-off streams == JAX's
  spec-on engine, in f32 and in the int8 pool (whose requantized blocks
  also hold rejected drafts: held to what JAX's engine does);
- sampled (the port's counter chain): spec-on == spec-off ==
  ``gpt2_generate`` at each request's seed;
- preemption, the prefix cache, EOS inside an accepted draft, and fewer
  engine steps on repetitive traffic;
- fake_quant with spec == f32 with spec, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.analysis.specs import verify_buckets as jax_verify_buckets
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu.serve.spec import NgramDrafter as JaxNgramDrafter
from quintnet_tpu.serve.spec import SpecConfig as JaxSpecConfig
from quintnet_tpu_torch.analysis.specs import verify_buckets
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
from quintnet_tpu_torch.serve import KVPool, ServeEngine, gpt2_family
from quintnet_tpu_torch.serve.spec import NgramDrafter, SpecConfig

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2)
JCFG = JaxGPT2Config.tiny(n_layer=2)
# weights whose greedy dynamics settle into long repetitive runs (JAX's
# tests/test_spec.py: init key 1 at 256 positions)
CFG_REP = GPT2Config.tiny(n_layer=2, n_positions=256)
JCFG_REP = JaxGPT2Config.tiny(n_layer=2, n_positions=256)


def _both(key, jcfg):
    jp = jax_gpt2_init(jax.random.key(key), jcfg)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def params():
    return _both(0, JCFG)


@pytest.fixture(scope="module")
def rep_params():
    return _both(1, JCFG_REP)


def _engine(tparams, cfg=CFG, spec=None, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("max_seq_len", 40)
    return ServeEngine(gpt2_family(cfg), tparams, device="cpu", spec=spec,
                       **kw)


def _jax_engine(jparams, jcfg=JCFG, spec=None, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("max_seq_len", 40)
    return JaxServeEngine(jax_gpt2_family(jcfg), jparams, attn_kernel="xla",
                          spec=spec, **kw)


def _run_staggered(eng, prompts, max_new, arrivals, seeds=None):
    order = np.argsort(np.asarray(arrivals), kind="stable")
    rids = {}
    submitted, step = 0, 0
    while submitted < len(prompts) or eng.has_work:
        while (submitted < len(prompts)
               and arrivals[order[submitted]] <= step):
            i = order[submitted]
            kw = {} if seeds is None else {"seed": seeds[i]}
            rids[i] = eng.submit(prompts[i], max_new[i], **kw)
            submitted += 1
        eng.step()
        step += 1
        assert step < 2000, "engine failed to drain"
    return [eng.result(rids[i]) for i in range(len(prompts))]


def _traffic(seed):
    """JAX's mixed traffic: prompts tiling a 5-token pattern, and random
    ones, staggered."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, CFG.vocab_size, (5,)).astype(np.int32)
    prompts = [np.tile(pat, 3),
               rng.integers(0, CFG.vocab_size, (7,)).astype(np.int32),
               np.tile(pat, 2),
               rng.integers(0, CFG.vocab_size, (4,)).astype(np.int32)]
    return prompts, [18, 14, 16, 12], [0, 1, 3, 6]


# ---------------------------------------------------------------------
# drafter, config, ladder
# ---------------------------------------------------------------------

def _contexts():
    rng = np.random.default_rng(0)
    out = [np.array([3, 1, 7, 7, 7, 7, 7, 7]), np.tile([5, 9, 2], 4),
           np.full(10, 4), np.arange(10), np.array([8, 1, 2, 3, 9, 4, 5, 9]),
           np.array([1]), np.array([], np.int32)]
    for n in (3, 12, 40, 90):
        out.append(rng.integers(0, 6, n))            # small alphabet
        out.append(np.tile(rng.integers(0, 50, rng.integers(2, 9)),
                           rng.integers(2, 6)))
    return [np.asarray(c, np.int32) for c in out]


@pytest.mark.parametrize("kw", [{}, {"ngram_min": 2}, {"max_draft": 4},
                                {"ngram_max": 1}, {"max_draft": 3,
                                                   "ngram_max": 5}])
def test_drafter_matches_jax(kw):
    mine, theirs = NgramDrafter(SpecConfig(**kw)), \
        JaxNgramDrafter(JaxSpecConfig(**kw))
    for ctx in _contexts():
        for cap in (0, 1, 3, 8, 99):
            np.testing.assert_array_equal(mine.draft(ctx, cap),
                                          theirs.draft(ctx, cap))


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 16, 33])
def test_verify_buckets_and_spec_config_match_jax(n):
    assert verify_buckets(n) == jax_verify_buckets(n)
    mine, theirs = SpecConfig(max_draft=n), JaxSpecConfig(max_draft=n)
    assert (mine.buckets, mine.min_draft) == (theirs.buckets,
                                              theirs.min_draft)
    for k in range(n + 1):
        assert mine.bucket_for(k) == theirs.bucket_for(k)


def test_spec_config_validation():
    assert SpecConfig().buckets == (2, 4, 8)
    for kw, match in (({"max_draft": 0}, "max_draft"),
                      ({"min_draft": 0}, "min_draft"),
                      ({"ngram_min": 3, "ngram_max": 2}, "ngram_min"),
                      ({"max_draft": 8, "buckets": (2, 4)}, "end at")):
        with pytest.raises(ValueError, match=match):
            SpecConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JaxSpecConfig(**kw)
    assert SpecConfig(max_draft=1).min_draft == 1
    assert SpecConfig(min_draft=9).min_draft == 8


# ---------------------------------------------------------------------
# tentative blocks
# ---------------------------------------------------------------------

def _pool(num_blocks=8):
    return KVPool(n_layers=2, n_kv_heads=2, head_dim=4, block_size=4,
                  num_blocks=num_blocks, device="cpu")


def test_tentative_commit_and_rollback():
    p = _pool()
    t = p.tentative_acquire(2)
    assert all(p.is_tentative(b) and p.refcount(b) == 1 for b in t)
    p.commit_tentative(t)
    assert not any(p.is_tentative(b) for b in t)
    p.release(t)
    assert p.num_free == p.usable_blocks
    t = p.tentative_acquire(3)
    assert p.num_used == 3 and p.num_tentative == 3
    p.rollback_tentative(t)
    assert p.num_used == 0 and p.num_tentative == 0
    assert p.num_free == p.usable_blocks


def test_publish_refuses_tentative_and_unknown_blocks_raise():
    p = _pool()
    t = p.tentative_acquire(1)
    tokens = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="tentative"):
        p.publish(tokens, t, 4)
    p.commit_tentative(t)
    p.publish(tokens, t, 4)
    assert p.is_cached(t[0])
    a = p.acquire(1)
    for fn in (p.commit_tentative, p.rollback_tentative):
        with pytest.raises(ValueError, match="not tentative"):
            fn(a)
    small = _pool(num_blocks=4)
    assert small.tentative_acquire(5) is None and small.num_tentative == 0
    assert 0 not in small.tentative_acquire(3)


# ---------------------------------------------------------------------
# the golden contract
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_greedy_spec_on_equals_off_and_jax(params, kv_dtype):
    prompts, max_new, arrivals = _traffic(3)
    jp, tp = params
    outs = {}
    for name, spec in (("off", None), ("on", SpecConfig())):
        eng = _engine(tp, spec=spec, kv_dtype=kv_dtype)
        outs[name] = _run_staggered(eng, prompts, max_new, arrivals)
        if spec is not None:
            assert eng.metrics.spec_steps > 0
            assert eng.pool.num_tentative == 0
    want = _run_staggered(_jax_engine(jp, spec=JaxSpecConfig(),
                                      kv_dtype=kv_dtype),
                          prompts, max_new, arrivals)
    for on, w in zip(outs["on"], want):
        np.testing.assert_array_equal(on, w)
    if kv_dtype == "f32":
        for a, b in zip(outs["off"], outs["on"]):
            np.testing.assert_array_equal(a, b)


def test_sampled_spec_on_equals_off_and_gpt2_generate(params):
    prompts, max_new, arrivals = _traffic(3)
    seeds = [100 + i for i in range(len(prompts))]
    kw = dict(temperature=0.8, top_k=5)
    outs = {}
    for name, spec in (("off", None), ("on", SpecConfig())):
        outs[name] = _run_staggered(_engine(params[1], spec=spec, **kw),
                                    prompts, max_new, arrivals, seeds)
    for a, b in zip(outs["off"], outs["on"]):
        np.testing.assert_array_equal(a, b)
    for p, n, s, o in zip(prompts, max_new, seeds, outs["on"]):
        np.testing.assert_array_equal(
            o, gpt2_generate(params[1], p[None], CFG, max_new_tokens=n,
                             seed=s, **kw)[0])


def test_spec_parity_under_preemption(params):
    """A pool too small for the working set preempts mid-speculation;
    sampled streams resume where they stopped."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, CFG.vocab_size, (8,)).astype(np.int32)
    prompts = [np.concatenate([
        shared, rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)])
        for t in (3, 4, 5, 6)]
    outs, preempted = {}, {}
    for name, spec in (("off", None), ("on", SpecConfig())):
        eng = _engine(params[1], spec=spec, num_blocks=13,
                      temperature=0.7, top_k=6)
        outs[name] = _run_staggered(eng, prompts, [14] * 4, [0, 0, 1, 2],
                                    [40 + i for i in range(4)])
        preempted[name] = eng.metrics.preempted
        assert eng.pool.num_tentative == 0
    assert preempted["on"] > 0
    for a, b in zip(outs["off"], outs["on"]):
        np.testing.assert_array_equal(a, b)


def test_spec_parity_with_prefix_cache_and_hits(params):
    rng = np.random.default_rng(21)
    shared = rng.integers(0, CFG.vocab_size, (12,)).astype(np.int32)
    prompts = [np.concatenate([
        shared, rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)])
        for t in (2, 3, 4)]
    outs = {}
    for name, spec in (("off", None), ("on", SpecConfig())):
        eng = _engine(params[1], spec=spec)
        outs[name] = _run_staggered(eng, prompts, [12] * 3, [0, 6, 12])
        assert eng.metrics.prefix_hit_tokens > 0
        assert eng.pool.num_tentative == 0
    for a, b in zip(outs["off"], outs["on"]):
        np.testing.assert_array_equal(a, b)


def _rep_engine(tparams, **kw):
    kw = {"max_slots": 2, "block_size": 8, "num_blocks": 32,
          "max_seq_len": 100, **kw}
    return ServeEngine(gpt2_family(CFG_REP), tparams, device="cpu", **kw)


def test_accepts_drafts_and_fewer_steps(rep_params):
    """Repetitive traffic: multi-token commits (acceptance > 0.5, > 1.5
    tokens a decode step), fewer than half the engine steps, the same
    stream as spec-off and as JAX's spec-on engine."""
    jp, tp = rep_params
    prompt = np.random.default_rng(5).integers(
        0, CFG_REP.vocab_size, (12,)).astype(np.int32)
    outs, steps = {}, {}
    for name, spec in (("off", None), ("on", SpecConfig())):
        eng = _rep_engine(tp, spec=spec)
        rid = eng.submit(prompt, 60)
        eng.run(max_steps=500)
        outs[name], steps[name] = eng.result(rid), eng.metrics.steps
        if spec is not None:
            s = eng.metrics.summary()
            assert s["accepted_draft_tokens"] > 10
            assert s["tokens_per_decode_step"] > 1.5
            assert s["spec_steps"] > 0
            assert s["draft_acceptance_rate"] > 0.5
    np.testing.assert_array_equal(outs["off"], outs["on"])
    assert steps["on"] < steps["off"] / 2
    je = JaxServeEngine(jax_gpt2_family(JCFG_REP), jp, attn_kernel="xla",
                        max_slots=2, block_size=8, num_blocks=32,
                        max_seq_len=100, spec=JaxSpecConfig())
    rid = je.submit(prompt, 60)
    je.run(max_steps=500)
    np.testing.assert_array_equal(outs["on"], je.result(rid))


def test_eos_mid_draft_truncates_commit(rep_params):
    tp = rep_params[1]
    prompt = np.random.default_rng(5).integers(
        0, CFG_REP.vocab_size, (12,)).astype(np.int32)
    eng0 = _rep_engine(tp, max_slots=1)
    rid0 = eng0.submit(prompt, 40)
    eng0.run(max_steps=300)
    gen = eng0.result(rid0)[len(prompt):]
    eos = int(np.bincount(gen).argmax())   # appears in a long run
    outs = {}
    for name, spec in (("off", None), ("on", SpecConfig())):
        eng = _rep_engine(tp, max_slots=1, eos_token_id=eos, spec=spec)
        rid = eng.submit(prompt, 40)
        eng.run(max_steps=300)
        outs[name] = eng.result(rid)
    np.testing.assert_array_equal(outs["off"], outs["on"])
    gen_on = outs["on"][len(prompt):]
    assert eos in gen_on and int(gen_on[-1]) == eos


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy",
                                                        "sampled"])
def test_fake_quant_with_spec_equals_f32_with_spec(rep_params, sampled):
    """JAX's gate (``tests/test_kv_quant.py:226-235``) with speculation:
    the scaled path with the identity quantization IS the f32 path, bit
    for bit, drafts written into blocks that hold committed positions
    included."""
    tp = rep_params[1]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, CFG_REP.vocab_size, (n,)).astype(np.int32)
               for n in (12, 7, 20)]
    kw = dict(temperature=0.8, top_k=5) if sampled else {}
    outs = {}
    for kv in ("f32", "fake_quant"):
        eng = _rep_engine(tp, max_slots=3, spec=SpecConfig(), kv_dtype=kv,
                          **kw)
        outs[kv] = _run_staggered(eng, prompts, [30, 24, 28], [0, 1, 2],
                                  [7, 8, 9])
        assert eng.metrics.accepted_draft_tokens > 0
    for a, b in zip(outs["f32"], outs["fake_quant"]):
        np.testing.assert_array_equal(a, b)


def test_spec_off_engine_takes_no_verify(params):
    eng = _engine(params[1])
    _run_staggered(eng, *_traffic(3))
    assert eng.spec is None and eng.metrics.spec_steps == 0
    assert ServeEngine(gpt2_family(CFG), params[1], device="cpu",
                       spec=True).spec == SpecConfig()
