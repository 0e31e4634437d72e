"""The port's KV-cache decoders (models/gpt2_generate.py,
models/llama_generate.py) against the JAX package.

On the same weights (JAX init, bridged): ``gpt2_prefill`` and
``gpt2_decode_step`` logits and caches within ``atol=1e-5`` of JAX's
(and of the port's own full forward, as ``tests/test_generate.py:53-88``
holds JAX's), the same for ``llama_prefill`` / ``llama_decode_step``
(``tests/test_llama.py:173-192``); greedy ``gpt2_generate`` (dense and
MoE) and ``llama_generate`` token streams equal JAX's exactly, EOS
padding included; the ``n_positions`` guard.

tp decoding on one 2-rank gloo world: ``gpt2_generate_tp`` and
``llama_generate_tp`` (greedy with EOS, and sampled) equal the
single-device port on every rank (greedy also JAX), the sampled tokens
agree across ranks, and ``evaluate_generation`` on the tp mesh gives
JAX's single-device scores; beams under tp > 1 are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_world
from _torch_gen_cases import _Tokenizer, gen_world_case
from quintnet_tpu.models import gpt2_generate as jgen
from quintnet_tpu.models import llama_generate as jlgen
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_apply as jax_gpt2_apply
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quintnet_tpu.models.llama import llama_init as jax_llama_init
from quintnet_tpu.train.metrics import \
    evaluate_generation as jax_evaluate_generation
from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                       llama_params_from_numpy)
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_apply
from quintnet_tpu_torch.models.gpt2_generate import (gpt2_decode_step,
                                                     gpt2_generate,
                                                     gpt2_prefill)
from quintnet_tpu_torch.models.llama import LlamaConfig, llama_apply
from quintnet_tpu_torch.models.llama_generate import (llama_decode_step,
                                                      llama_generate,
                                                      llama_prefill)

torch.set_num_threads(1)

GPT2_KW = dict(n_layer=2)
MOE_KW = dict(n_layer=2, n_experts=4, expert_top_k=2, expert_capacity=4096)
LLAMA_KW = {}
SAMPLE = dict(temperature=0.8, top_k=20, top_p=0.9)


def _gpt2(kw=GPT2_KW):
    jp = jax_gpt2_init(jax.random.key(0), JaxGPT2Config.tiny(**kw))
    return (jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            JaxGPT2Config.tiny(**kw), GPT2Config.tiny(**kw))


def _llama():
    jcfg = JaxLlamaConfig.tiny(**LLAMA_KW)
    jp = jax_llama_init(jax.random.key(1), jcfg)
    return (jp, llama_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            jcfg, LlamaConfig.tiny(**LLAMA_KW))


@pytest.fixture(scope="module")
def gpt2():
    return _gpt2()


@pytest.fixture(scope="module")
def llama():
    return _llama()


def _ids(seed, b=2, t=8, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def test_gpt2_prefill_and_decode_match_jax(gpt2):
    jp, tp, jcfg, cfg = gpt2
    ids = _ids(0)
    nxt = np.array([3, 99], np.int32)
    jl, jc = jgen.gpt2_prefill(jp, jnp.asarray(ids), jcfg, cache_len=16)
    tl, tc = gpt2_prefill(tp, torch.tensor(ids).long(), cfg, cache_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for a, b in zip(tc, jc):
        assert tuple(a.shape) == (2, 2, 4, 16, 8)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    jd, jc = jgen.gpt2_decode_step(jp, jnp.asarray(nxt), jnp.int32(8), jc,
                                   jcfg)
    td, tc = gpt2_decode_step(tp, torch.tensor(nxt).long(), 8, tc, cfg)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # the cached step is the full forward's last position
    full = gpt2_apply(tp, torch.tensor(np.concatenate(
        [ids, nxt[:, None]], axis=1)).long(), cfg)[:, -1]
    np.testing.assert_allclose(td.numpy(), full.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_llama_prefill_and_decode_match_jax(llama):
    jp, tp, jcfg, cfg = llama
    ids = _ids(1)
    nxt = np.array([5, 17], np.int32)
    jl, jc = jlgen.llama_prefill(jp, jnp.asarray(ids), jcfg, cache_len=12)
    tl, tc = llama_prefill(tp, torch.tensor(ids).long(), cfg, cache_len=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for a, b in zip(tc, jc):
        assert a.shape[2] == cfg.n_kv_heads          # unrepeated
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    jd, jc = jlgen.llama_decode_step(jp, jnp.asarray(nxt), jnp.int32(8), jc,
                                     jcfg)
    td, tc = llama_decode_step(tp, torch.tensor(nxt).long(), 8, tc, cfg)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    full = llama_apply(tp, torch.tensor(np.concatenate(
        [ids, nxt[:, None]], axis=1)).long(), cfg)[:, -1]
    np.testing.assert_allclose(td.numpy(), full.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("eos", [None, 7], ids=["no_eos", "eos"])
def test_gpt2_greedy_streams_equal_jax(gpt2, eos):
    jp, tp, jcfg, cfg = gpt2
    ids = _ids(2)
    want = jgen.gpt2_generate(jp, ids, jcfg, max_new_tokens=16,
                              eos_token_id=eos)
    got = gpt2_generate(tp, ids, cfg, max_new_tokens=16, eos_token_id=eos)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_gpt2_eos_pads_like_jax(gpt2):
    """EOS chosen as a token greedy decoding emits mid-stream: both pad
    after it with EOS."""
    jp, tp, jcfg, cfg = gpt2
    ids = _ids(2)
    eos = int(jgen.gpt2_generate(jp, ids, jcfg, max_new_tokens=16)[0, 11])
    want = jgen.gpt2_generate(jp, ids, jcfg, max_new_tokens=16,
                              eos_token_id=eos)
    got = gpt2_generate(tp, ids, cfg, max_new_tokens=16, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 11:] == eos).all()


def test_gpt2_moe_greedy_streams_equal_jax():
    """MoE GPT-2 with ample capacity, against JAX's full-forward greedy
    oracle (``tests/test_generate.py::test_generate_moe_smoke``'s: JAX's
    own cached decoder unpacks the MoE block's routing stats as a cache
    and raises for a MoE config)."""
    jp, tp, jcfg, cfg = _gpt2(MOE_KW)
    cur = _ids(3)
    for _ in range(6):
        logits = jax_gpt2_apply(jp, jnp.asarray(cur), jcfg)[:, -1]
        nxt = np.asarray(jnp.argmax(logits, axis=-1), np.int32)
        cur = np.concatenate([cur, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(
        gpt2_generate(tp, _ids(3), cfg, max_new_tokens=6), cur)


@pytest.mark.parametrize("eos", [None, 7], ids=["no_eos", "eos"])
def test_llama_greedy_streams_equal_jax(llama, eos):
    jp, tp, jcfg, cfg = llama
    ids = _ids(4)
    want = jlgen.llama_generate(jp, ids, jcfg, max_new_tokens=16,
                                eos_token_id=eos)
    np.testing.assert_array_equal(
        llama_generate(tp, ids, cfg, max_new_tokens=16, eos_token_id=eos),
        want)


def test_length_guard_and_zero_new_tokens(gpt2, llama):
    _, tp, _, cfg = gpt2
    ids = _ids(5)
    with pytest.raises(ValueError, match="n_positions"):
        gpt2_generate(tp, ids, cfg, max_new_tokens=cfg.n_positions)
    np.testing.assert_array_equal(
        gpt2_generate(tp, ids, cfg, max_new_tokens=0), ids)
    _, lp, _, lcfg = llama
    with pytest.raises(ValueError, match="n_positions"):
        llama_generate(lp, ids, lcfg, max_new_tokens=lcfg.n_positions)


# ---------------------------------------------------------------------
# tp = 2: one gloo world for every case
# ---------------------------------------------------------------------

def _eval_prompts():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 128, n).tolist(), f"w{i} w{i + 1} w2")
            for i, n in enumerate((8, 8, 8, 5, 5))]


@pytest.fixture(scope="module")
def tp_world(gpt2, llama, tmp_path_factory):
    jp, _, _, _ = gpt2
    ljp, _, _, _ = llama
    ranks = run_world(gen_world_case, 2, tmp_path_factory.mktemp("gen"),
                      jax.tree.map(np.asarray, jp), GPT2_KW, _ids(8),
                      jax.tree.map(np.asarray, ljp), LLAMA_KW, _ids(9),
                      _eval_prompts(), SAMPLE)
    assert len(ranks) == 2
    return ranks


@pytest.mark.parametrize("family,kind", [
    ("gpt2", "greedy"), ("gpt2", "sampled"), ("llama", "greedy"),
    ("llama", "sampled")])
def test_tp2_decoding_equals_single_device(tp_world, gpt2, llama, family,
                                           kind):
    if family == "gpt2":
        jp, tp, jcfg, cfg = gpt2
        ids, seed, fn, jfn = _ids(8), 9, gpt2_generate, jgen.gpt2_generate
    else:
        jp, tp, jcfg, cfg = llama
        ids, seed, fn, jfn = (_ids(9), 3, llama_generate,
                              jlgen.llama_generate)
    if kind == "greedy":
        want = fn(tp, ids, cfg, max_new_tokens=8, eos_token_id=7)
        np.testing.assert_array_equal(
            want, jfn(jp, ids, jcfg, max_new_tokens=8, eos_token_id=7))
    else:
        want = fn(tp, ids, cfg, max_new_tokens=8, seed=seed, **SAMPLE)
    for r in tp_world:
        np.testing.assert_array_equal(r[f"{family}_{kind}"], want)


def test_tp2_generation_eval_equals_jax(tp_world, gpt2):
    jp, _, jcfg, _ = gpt2
    want = jax_evaluate_generation(jp, jcfg, _eval_prompts(), _Tokenizer(),
                                   max_new_tokens=6, eos_token_id=7,
                                   batch_size=2)
    for r in tp_world:
        assert r["eval_tp"] == pytest.approx(want, abs=1e-12)
        assert "beams > 1 under a tp>1 mesh" in r["beams_refused"]
