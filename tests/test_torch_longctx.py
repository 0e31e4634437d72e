"""The port's chunked prefill (``serve/longctx.py``,
``ServeEngine(chunked_prefill=True, prefill_chunk_budget=...)``) against
the JAX package.

THE contract, JAX's (``tests/test_longctx.py``): a prompt of any length
the pool holds is admitted whole and fed through the bucket-width prefill
calls under a per-step token budget, and its output is the output of an
engine whose single window was widened to hold it, greedy and sampled,
with the prefix cache and through a preemption mid-prefill; meanwhile
every generating slot gets a token every step. Here on the CPU, on the
same weights (JAX's ``gpt2_init``, bridged): ``plan_chunks`` against
JAX's; the chunked streams against the port's widened engine and JAX's
chunked engine, token for token; the budget, the decode-every-step
property, preemption mid-prefill, the admissibility rule, and fake_quant
with chunking equal to f32 bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import check_admissible as jax_check_admissible
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu.serve import plan_chunks as jax_plan_chunks
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.serve import (ServeEngine, check_admissible,
                                      generate, gpt2_family)
from quintnet_tpu_torch.serve.longctx import plan_chunks

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2, n_positions=256)
JCFG = JaxGPT2Config.tiny(n_layer=2, n_positions=256)
SAMPLED = dict(temperature=0.8, top_k=5)


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _engine(tparams, **kw):
    kw = {"max_slots": 2, "block_size": 8, "num_blocks": 40,
          "max_seq_len": 200, **kw}
    return ServeEngine(gpt2_family(CFG), tparams, device="cpu", **kw)


def _prompt(rng, n):
    return np.asarray(rng.integers(0, CFG.vocab_size, (n,)), np.int32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------
# planning and admission
# ---------------------------------------------------------------------

@pytest.mark.parametrize("tail,buckets,budget", [
    (100, (16, 32), 24), (100, (16, 32), 64), (0, (16,), 4), (7, (8,), 1),
    (1000, (16, 32, 64, 128, 256), 256), (33, (16, 32), 32)])
def test_plan_chunks_matches_jax(tail, buckets, budget):
    assert plan_chunks(tail, buckets=buckets, budget=budget) == \
        jax_plan_chunks(tail, buckets=buckets, budget=budget)


def test_plan_chunks_validation():
    for kw in ({"tail_len": -1, "budget": 4}, {"tail_len": 4, "budget": 0}):
        with pytest.raises(ValueError):
            plan_chunks(buckets=(8,), **kw)


def test_chunked_lifts_only_the_prefill_window():
    lim = dict(max_seq_len=200, prefill_len=32, usable_blocks=40,
               block_size=8)
    for fn in (check_admissible, jax_check_admissible):
        with pytest.raises(ValueError, match="chunked_prefill"):
            fn(100, 4, **lim)
        fn(100, 4, chunked_prefill=True, **lim)
        with pytest.raises(ValueError, match="max_seq_len"):
            fn(199, 4, chunked_prefill=True, **lim)
        with pytest.raises(ValueError, match="KV pool too small"):
            fn(100, 4, chunked_prefill=True,
               **dict(lim, usable_blocks=10))


def test_engine_limits_carry_the_flag(params):
    assert _engine(params[1], chunked_prefill=True).limits()[
        "chunked_prefill"] is True
    assert _engine(params[1]).limits()["chunked_prefill"] is False
    with pytest.raises(ValueError, match="prefill_chunk_budget"):
        _engine(params[1], chunked_prefill=True, prefill_chunk_budget=0)


# ---------------------------------------------------------------------
# chunked == single shot
# ---------------------------------------------------------------------

@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_short_prompt_forced_into_chunks(params, rng, sampling):
    kw = SAMPLED if sampling == "sampled" else {}
    prompt = _prompt(rng, 40)
    want = generate(_engine(params[1], **kw), [prompt], max_new_tokens=6,
                    seeds=[11])[0]
    chunked = _engine(params[1], chunked_prefill=True,
                      prefill_chunk_budget=12, **kw)
    got = generate(chunked, [prompt], max_new_tokens=6, seeds=[11],
                   max_steps=100)[0]
    np.testing.assert_array_equal(want, got)
    assert chunked.metrics.prefill_chunks >= 4


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_long_prompt_vs_widened_engine_and_jax(params, rng, sampling):
    """A prompt longer than the chunked engine's top bucket: the widened
    engine's tokens; greedy, also JAX's chunked engine's."""
    kw = SAMPLED if sampling == "sampled" else {}
    prompt = _prompt(rng, 150)
    want = generate(_engine(params[1], prefill_len=200, **kw), [prompt],
                    max_new_tokens=8, seeds=[7])[0]
    chunked = _engine(params[1], prefill_len=32, chunked_prefill=True,
                      prefill_chunk_budget=32, **kw)
    assert len(prompt) > chunked.prefill_buckets[-1]
    got = generate(chunked, [prompt], max_new_tokens=8, seeds=[7],
                   max_steps=100)[0]
    np.testing.assert_array_equal(want, got)
    assert chunked.metrics.prefill_chunks == -(-150 // 32)
    if sampling == "greedy":
        je = JaxServeEngine(jax_gpt2_family(JCFG), params[0],
                            attn_kernel="xla", max_slots=2, block_size=8,
                            num_blocks=40, max_seq_len=200, prefill_len=32,
                            chunked_prefill=True, prefill_chunk_budget=32)
        rid = je.submit(prompt, 8)
        je.run(max_steps=100)
        np.testing.assert_array_equal(got, je.result(rid))


def test_prefix_cache_composes_with_chunks(params, rng):
    prompt = _prompt(rng, 120)
    eng = _engine(params[1], prefill_len=32, chunked_prefill=True,
                  prefill_chunk_budget=32, **SAMPLED)
    want = [generate(_engine(params[1], prefill_len=200, **SAMPLED),
                     [prompt], max_new_tokens=4, seeds=[s])[0]
            for s in (21, 22)]
    got1 = generate(eng, [prompt], max_new_tokens=4, seeds=[21],
                    max_steps=100)[0]
    before = eng.metrics.prefill_tokens
    got2 = generate(eng, [prompt], max_new_tokens=4, seeds=[22],
                    max_steps=100)[0]
    np.testing.assert_array_equal(want[0], got1)
    np.testing.assert_array_equal(want[1], got2)
    assert eng.metrics.prefix_hit_tokens > 100
    assert eng.metrics.prefill_tokens - before < len(prompt) // 2


def test_cache_on_equals_cache_off(params, rng):
    prompt = _prompt(rng, 100)
    outs = [generate(_engine(params[1], prefill_len=32, chunked_prefill=True,
                             prefix_cache=pc, **SAMPLED), [prompt],
                     max_new_tokens=6, seeds=[33], max_steps=100)[0]
            for pc in (True, False)]
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------
# decode never starves behind a long prefill
# ---------------------------------------------------------------------

def test_concurrent_decodes_emit_every_step(params, rng):
    eng = _engine(params[1], max_slots=3, prefill_len=32,
                  chunked_prefill=True, prefill_chunk_budget=16)
    r1 = eng.submit(_prompt(rng, 6), 40)
    eng.step()
    r2 = eng.submit(_prompt(rng, 150), 4)
    per_step = []
    while eng.request(r2).state != "finished":
        d0 = eng.metrics.decode_tokens
        eng.step()
        per_step.append(eng.metrics.decode_tokens - d0)
        assert len(per_step) < 200
    assert min(per_step) >= 1
    m = eng.metrics
    assert m.prefill_chunks >= 150 // 16
    assert 0 < m.chunk_tokens_per_step <= 16
    s = m.summary()
    for k in ("prefill_chunks", "chunk_steps", "chunk_tokens",
              "chunk_tokens_per_step", "itl_s"):
        assert k in s, k
    eng.run()
    assert eng.request(r1).state == "finished"


def test_budget_caps_chunk_tokens_per_step(params, rng):
    eng = _engine(params[1], prefill_len=32, chunked_prefill=True,
                  prefill_chunk_budget=8)
    eng.submit(_prompt(rng, 90), 2)
    while eng.has_work:
        before = eng.metrics.chunk_tokens
        eng.step()
        assert eng.metrics.chunk_tokens - before <= 8
        assert eng.metrics.steps < 200


def test_preempt_mid_prefill_resumes_bit_identically(params, rng):
    """The older request's growth preempts the long one MID-PREFILL: its
    landed chunks are published, and both streams equal undisturbed
    single-shot runs (sampled)."""
    p_old, p_long = _prompt(rng, 10), _prompt(rng, 80)
    eng = _engine(params[1], num_blocks=14, max_seq_len=96, prefill_len=32,
                  chunked_prefill=True, prefill_chunk_budget=4, **SAMPLED)
    ra = eng.submit(p_old, 60, seed=5)
    rb = eng.submit(p_long, 4, seed=6)
    mid_prefill_preempt = False
    steps = 0
    while eng.has_work and steps < 500:
        pre = eng.metrics.preempted
        mid = any(st is not None for st in eng._slot_chunk)
        eng.step()
        mid_prefill_preempt |= eng.metrics.preempted > pre and mid
        steps += 1
    assert not eng.has_work and mid_prefill_preempt
    for rid, p, n, seed in ((ra, p_old, 60, 5), (rb, p_long, 4, 6)):
        wide = _engine(params[1], num_blocks=40, max_seq_len=96,
                       prefill_len=96, **SAMPLED)
        np.testing.assert_array_equal(
            eng.result(rid),
            generate(wide, [p], max_new_tokens=n, seeds=[seed])[0])
    assert eng.metrics.prefix_hit_tokens > 0


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy",
                                                        "sampled"])
def test_fake_quant_with_chunks_equals_f32(params, rng, sampled):
    """JAX's gate (``tests/test_kv_quant.py:226-235``) under chunking:
    chunks at growing offsets through the scaled path with the identity
    quantization are the f32 path, bit for bit."""
    kw = SAMPLED if sampled else {}
    prompts = [_prompt(rng, 150), _prompt(rng, 9)]
    outs = {}
    for kv in ("f32", "fake_quant"):
        eng = _engine(params[1], max_slots=2, prefill_len=32,
                      chunked_prefill=True, prefill_chunk_budget=24,
                      kv_dtype=kv, **kw)
        outs[kv] = generate(eng, prompts, max_new_tokens=[8, 20],
                            seeds=[1, 2], max_steps=200)
    for a, b in zip(outs["f32"], outs["fake_quant"]):
        np.testing.assert_array_equal(a, b)
