"""Beam search in the port (``beam_autoregress``, ``gpt2_beam_search``,
``llama_beam_search``) against the JAX package.

On the same weights: the beam streams of GPT-2 and Llama equal JAX's
exactly, with and without EOS (and its padding); the contracts of
``tests/test_beam.py`` (beams = 1 is greedy, beam K never scores below
greedy by teacher-forced log-probability); and ties between equal
continuations resolve to the lower flat index, as ``lax.top_k`` does,
even where every logit ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quintnet_tpu.models import gpt2_generate as jgen
from quintnet_tpu.models import llama_generate as jlgen
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quintnet_tpu.models.llama import llama_init as jax_llama_init
from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                       llama_params_from_numpy)
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_apply
from quintnet_tpu_torch.models.gpt2_generate import (beam_autoregress,
                                                     gpt2_beam_search,
                                                     gpt2_generate)
from quintnet_tpu_torch.models.llama import LlamaConfig
from quintnet_tpu_torch.models.llama_generate import llama_beam_search

torch.set_num_threads(1)

JCFG = JaxGPT2Config.tiny(n_layer=2)
CFG = GPT2Config.tiny(n_layer=2)


@pytest.fixture(scope="module")
def setup():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    tp = gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ids = np.random.default_rng(0).integers(0, CFG.vocab_size,
                                            (2, 6)).astype(np.int32)
    return jp, tp, ids


@pytest.mark.parametrize("beams,eos", [(1, None), (2, 7), (4, None),
                                       (4, 7)])
def test_gpt2_beam_streams_equal_jax(setup, beams, eos):
    jp, tp, ids = setup
    want = jgen.gpt2_beam_search(jp, ids, JCFG, beams=beams,
                                 max_new_tokens=8, eos_token_id=eos)
    got = gpt2_beam_search(tp, ids, CFG, beams=beams, max_new_tokens=8,
                           eos_token_id=eos)
    np.testing.assert_array_equal(got, want)


def test_gpt2_beam_eos_mid_stream_equals_jax(setup):
    """EOS picked from the best beam's own stream, so it is reached:
    both pad after it."""
    jp, tp, ids = setup
    plain = jgen.gpt2_beam_search(jp, ids, JCFG, beams=3, max_new_tokens=8)
    eos = int(plain[0, 6 + 3])
    want = jgen.gpt2_beam_search(jp, ids, JCFG, beams=3, max_new_tokens=8,
                                 eos_token_id=eos)
    got = gpt2_beam_search(tp, ids, CFG, beams=3, max_new_tokens=8,
                           eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    for row in got[:, 6:]:
        hits = np.where(row == eos)[0]
        if hits.size:
            assert (row[hits[0]:] == eos).all()


@pytest.mark.parametrize("beams", [1, 3])
def test_llama_beam_streams_equal_jax(beams):
    jcfg = JaxLlamaConfig.tiny()
    jp = jax_llama_init(jax.random.key(1), jcfg)
    tp = llama_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ids = np.random.default_rng(1).integers(0, 128, (2, 6)).astype(np.int32)
    want = jlgen.llama_beam_search(jp, ids, jcfg, beams=beams,
                                   max_new_tokens=8, eos_token_id=7)
    np.testing.assert_array_equal(
        llama_beam_search(tp, ids, LlamaConfig.tiny(), beams=beams,
                          max_new_tokens=8, eos_token_id=7), want)


def test_beam1_equals_greedy(setup):
    _, tp, ids = setup
    np.testing.assert_array_equal(
        gpt2_beam_search(tp, ids, CFG, beams=1, max_new_tokens=6),
        gpt2_generate(tp, ids, CFG, max_new_tokens=6))


def _seq_logprob(params, full, t0):
    logits = gpt2_apply(params, torch.tensor(full).long(), CFG)
    logp = torch.log_softmax(logits.float(), dim=-1)[:, :-1]
    tok = torch.tensor(full[:, 1:]).long()[:, :, None]
    return logp.gather(2, tok)[:, t0 - 1:, 0].sum(dim=1).detach().numpy()


def test_beam_scores_at_least_greedy(setup):
    _, tp, ids = setup
    greedy = gpt2_generate(tp, ids, CFG, max_new_tokens=6)
    beam = gpt2_beam_search(tp, ids, CFG, beams=4, max_new_tokens=6)
    lp_g = _seq_logprob(tp, greedy, ids.shape[1])
    lp_b = _seq_logprob(tp, beam, ids.shape[1])
    assert (lp_b >= lp_g - 1e-4).all(), (lp_b, lp_g)


@pytest.mark.parametrize("eos", [None, 1], ids=["no_eos", "eos"])
def test_ties_take_the_lower_index_as_lax_top_k(eos):
    """Every logit equal (a uniform model): the beams are the lowest
    token ids, step after step, in both packages' beam loops."""
    V, K, T = 6, 3, 4
    ids_np = np.zeros((2, 3), np.int32)

    def jprefill(ids):
        cache = jnp.zeros((1, ids.shape[0], 1, 8, 1))
        return jnp.zeros((ids.shape[0], V)), (cache, cache)

    def jdecode(tok, pos, caches):
        return jnp.zeros((tok.shape[0], V)), caches

    want = np.asarray(jgen.beam_autoregress(
        jprefill, jdecode, jnp.asarray(ids_np), beams=K, vocab=V,
        max_new_tokens=T, eos_token_id=eos, length_penalty=1.0))

    def tprefill(ids):
        cache = torch.zeros((1, ids.shape[0], 1, 8, 1))
        return torch.zeros((ids.shape[0], V)), (cache, cache)

    def tdecode(tok, pos, caches):
        return torch.zeros((tok.shape[0], V)), caches

    got = beam_autoregress(tprefill, tdecode, torch.tensor(ids_np).long(),
                           beams=K, vocab=V, max_new_tokens=T,
                           eos_token_id=eos, length_penalty=1.0)
    np.testing.assert_array_equal(got.numpy(), want)
