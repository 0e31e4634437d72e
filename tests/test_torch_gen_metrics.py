"""ROUGE, BLEU and the generation eval in the port (train/metrics.py,
``SummarizationDataset.eval_prompts``) against the JAX package.

``rouge_scores``, ``bleu_score`` and ``compute_rouge_bleu`` equal JAX's
numbers on the same strings (edge cases included: empty, shorter than
an n-gram, repeats, case); ``eval_prompts`` equals JAX's on the same
rows; ``evaluate_generation`` on a tiny GPT-2 (and, through
``generate_fn``, a tiny Llama) on byte-tokenized prompts gives JAX's
scores greedy and with beams (continuations decoded to the synthetic
set's words, so the scores are not all 0).
"""

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.data.datasets import ByteTokenizer as JaxByteTokenizer
from quintnet_tpu.data.datasets import \
    SummarizationDataset as JaxSummarizationDataset
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quintnet_tpu.models.llama import llama_init as jax_llama_init
from quintnet_tpu.models.llama_generate import \
    llama_beam_search as jax_llama_beam_search
from quintnet_tpu.models.llama_generate import \
    llama_generate as jax_llama_generate
from quintnet_tpu.train import metrics as jm
from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                       llama_params_from_numpy)
from quintnet_tpu_torch.data import ByteTokenizer, SummarizationDataset
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.models.llama import LlamaConfig
from quintnet_tpu_torch.models.llama_generate import (llama_beam_search,
                                                      llama_generate)
from quintnet_tpu_torch.train import metrics as tm

torch.set_num_threads(1)

PAIRS = [
    ("the cat sat on the mat", "the cat is on the mat"),
    ("The Cat SAT", "the cat sat"),
    ("", "a reference"),
    ("a prediction", ""),
    ("one", "one two three four five"),
    ("a a a a b b", "a b a b a b a"),
    ("alpha beta gamma delta epsilon zeta", "alpha beta gamma delta"),
    ("x y", "z w"),
]


@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_rouge_and_bleu_equal_jax(i):
    pred, ref = PAIRS[i]
    assert tm.rouge_scores(pred, ref) == jm.rouge_scores(pred, ref)
    assert tm.bleu_score(pred, [ref]) == jm.bleu_score(pred, [ref])
    refs = [ref, "the mat cat sat", "alpha beta"]
    assert tm.bleu_score(pred, refs) == jm.bleu_score(pred, refs)


def test_compute_rouge_bleu_equals_jax():
    preds, refs = zip(*PAIRS)
    assert tm.compute_rouge_bleu(preds, refs) == jm.compute_rouge_bleu(
        preds, refs)
    assert tm.compute_rouge_bleu([], []) == jm.compute_rouge_bleu([], [])


def _datasets(n=6):
    tds = SummarizationDataset.synthetic(n, ByteTokenizer(), max_length=64,
                                         seed=3)
    jds = JaxSummarizationDataset.synthetic(n, JaxByteTokenizer(),
                                            max_length=64, seed=3)
    assert tds.rows == jds.rows
    return tds, jds


@pytest.mark.parametrize("max_prompt_len,limit", [(32, None), (12, 4),
                                                  (5, 2)])
def test_eval_prompts_equal_jax(max_prompt_len, limit):
    tds, jds = _datasets()
    assert tds.eval_prompts(max_prompt_len=max_prompt_len, limit=limit) == \
        jds.eval_prompts(max_prompt_len=max_prompt_len, limit=limit)


KW = dict(vocab_size=264, n_layer=2)


class _Words:
    """Decodes each id to one of the synthetic set's words, so the
    random model's continuations overlap the references and the scores
    are not all 0."""

    WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
             "theta"]

    def decode(self, ids):
        return " ".join(self.WORDS[i % 8] for i in ids)


@pytest.fixture(scope="module")
def gpt2():
    jcfg = JaxGPT2Config.tiny(**KW)
    jp = jax_gpt2_init(jax.random.key(0), jcfg)
    return (jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            jcfg, GPT2Config.tiny(**KW))


@pytest.mark.parametrize("beams", [1, 3])
def test_evaluate_generation_equals_jax(gpt2, beams):
    jp, tp, jcfg, cfg = gpt2
    tds, _ = _datasets()
    prompts = tds.eval_prompts(max_prompt_len=24, limit=5)
    kw = dict(max_new_tokens=8, eos_token_id=256, batch_size=2, beams=beams)
    want = jm.evaluate_generation(jp, jcfg, prompts, _Words(), **kw)
    got = tm.evaluate_generation(tp, cfg, prompts, _Words(), **kw)
    assert want["rouge1"] > 0 and want["bleu"] > 0
    assert got == pytest.approx(want, abs=1e-12)


def test_evaluate_generation_sampled_runs(gpt2):
    """Sampling cannot match JAX's key stream: the port's eval with the
    chain is reproducible from its seed."""
    _, tp, _, cfg = gpt2
    tds, _ = _datasets()
    prompts = tds.eval_prompts(max_prompt_len=24, limit=4)
    kw = dict(max_new_tokens=8, temperature=1.0, top_k=50)
    a = tm.evaluate_generation(tp, cfg, prompts, _Words(), seed=3, **kw)
    assert a == tm.evaluate_generation(tp, cfg, prompts, _Words(), seed=3,
                                       **kw)
    assert set(a) == {"rouge1", "rouge2", "rougeL", "bleu"}


@pytest.mark.parametrize("beams", [1, 2])
def test_evaluate_generation_llama_generate_fn_equals_jax(beams):
    jcfg = JaxLlamaConfig.tiny(vocab_size=264)
    jp = jax_llama_init(jax.random.key(1), jcfg)
    tp = llama_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tds, _ = _datasets()
    prompts = tds.eval_prompts(max_prompt_len=16, limit=4)
    kw = dict(max_new_tokens=6, eos_token_id=256, beams=beams)
    want = jm.evaluate_generation(
        jp, jcfg, prompts, _Words(),
        generate_fn=jax_llama_beam_search if beams > 1
        else jax_llama_generate, **kw)
    got = tm.evaluate_generation(
        tp, LlamaConfig.tiny(vocab_size=264), prompts, _Words(),
        generate_fn=llama_beam_search if beams > 1 else llama_generate,
        **kw)
    assert want["rouge1"] > 0
    assert got == pytest.approx(want, abs=1e-12)
