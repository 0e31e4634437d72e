"""The port's sampling chain and sampled serving.

torch cannot reproduce JAX's key stream, so the port samples from its
own counter-based chain (``models/gpt2_generate.py``): the Gumbel noise
of a request's committed position i at column c is a pure function of
(seed, i, c). What is held to JAX here is everything the chain does not
decide: the filtered support and the filtered logits (top-k with JAX's
k-th-largest threshold, top-p keeping the first crossing token within
JAX's 16 eps slack, the per-row unsort) for the cases of
``tests/test_sampling.py``, read from JAX's ``sample_logits`` by
capturing the logits it hands to ``jax.random.categorical``. The
draws are held to the filtered softmax by chi-square tests (scipy).

Sampled serving (the counterparts of ``tests/test_serve.py:188-219,
269-274, 404-419``): a sampled ``ServeEngine`` stream equals the port's
``gpt2_generate`` of the same prompt at the same seed, token for token,
through staggered arrivals and through preemption under a small pool;
the resume state is ``(seed, len(generated))``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from quintnet_tpu.models import gpt2_generate as jgen
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
from quintnet_tpu_torch.models.gpt2_generate import (_M32, _mix32, _mul32,
                                                     chain_bits,
                                                     chain_gumbel,
                                                     filter_logits,
                                                     gpt2_generate,
                                                     row_seeds,
                                                     sample_logits)
from quintnet_tpu_torch.serve import ServeEngine, generate, gpt2_family

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2)


def _py_mix32(x: int) -> int:
    """The chain's mixing function in Python integers."""
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def test_mul32_and_mix32_are_exact_32_bit_arithmetic():
    """The int64 ops compute the 32-bit function exactly (every product
    below 2^49), so any device that does int64 arithmetic computes the
    same integers."""
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.integers(0, 1 << 32, 500, dtype=np.int64),
                         np.array([0, 1, (1 << 32) - 1, 1 << 31])])
    t = torch.from_numpy(xs)
    for c in (0x7FEB352D, 0x846CA68B, 0xFFFFFFFF, 1):
        want = [(int(x) * c) & _M32 for x in xs]
        assert _mul32(t, c).tolist() == want
    assert _mix32(t).tolist() == [_py_mix32(int(x)) for x in xs]


def test_chain_is_a_pure_function_of_seed_counter_column():
    seeds = [3, 3, 4, (1 << 63) + 5]
    bits = chain_bits(seeds, [0, 1, 0, 7], 50, "cpu")
    assert bits.dtype == torch.int64 and bits.shape == (4, 50)
    assert int(bits.min()) >= 0 and int(bits.max()) <= _M32
    # each row alone gives the same integers as in the batch
    for r, (s, c) in enumerate(zip(seeds, [0, 1, 0, 7])):
        assert torch.equal(chain_bits([s], [c], 50, "cpu")[0], bits[r])
    # a wider vocab extends a row without changing its first columns
    assert torch.equal(chain_bits(seeds, [0, 1, 0, 7], 80, "cpu")[:, :50],
                       bits)
    # other counters, seeds (either 32-bit half) give other noise
    assert (bits[0] != bits[1]).float().mean() > 0.99
    assert (bits[0] != bits[2]).float().mean() > 0.99
    hi = chain_bits([5], [7], 50, "cpu")[0]
    assert (hi != bits[3]).float().mean() > 0.99
    g = chain_gumbel(seeds, [0, 1, 0, 7], 50, "cpu")
    assert torch.isfinite(g).all() and g.dtype == torch.float32


def test_row_seeds():
    assert row_seeds(5, 3) == [5, 6, 7]
    assert row_seeds([9, 2], 2) == [9, 2]
    assert row_seeds(-1, 1) == [(1 << 64) - 1]
    with pytest.raises(ValueError, match="seeds"):
        row_seeds([1, 2], 3)


# ---------------------------------------------------------------------
# the filters against JAX's sample_logits
# ---------------------------------------------------------------------

ORDERED = [[8.0, 6.0, 5.0, 2.0, 1.0, 0.5, 0.2, 0.1]]
FILTER_CASES = {
    # tests/test_sampling.py's cases
    "top_k3": (ORDERED, 5.0, 3, 1.0),
    "top_k1": (ORDERED, 1.0, 1, 1.0),
    "top_p_first_crossing": (ORDERED, 1.0, 0, 1e-6),
    "top_p_0.8": (np.log([[0.5, 0.3, 0.15, 0.05]]).tolist(), 1.0, 0, 0.8),
    "unsort_top_k1": ([[1.0, 9.0, 2.0, 0.0], [0.0, 2.0, 9.0, 1.0]], 1.0,
                      1, 1.0),
    "unsort_top_p": ([[1.0, 9.0, 2.0, 0.0], [0.0, 2.0, 9.0, 1.0]], 1.0,
                     0, 0.9),
    # ties at the threshold and in the sort (lower index first)
    "ties": ([[2.0, 1.0, 2.0, 1.0, 0.0, 2.0]], 1.0, 2, 0.5),
    "random_k_and_p": (np.random.default_rng(1).normal(
        size=(3, 50)).tolist(), 0.7, 20, 0.9),
}


def _jax_filtered(logits, temperature, top_k, top_p, monkeypatch):
    """The logits JAX's sample_logits hands to jax.random.categorical."""
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen.sample_logits(jnp.asarray(logits, jnp.float32), jax.random.key(0),
                       temperature=temperature, top_k=top_k, top_p=top_p)
    return seen["logits"]


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_filtered_support_and_logits_equal_jax(case, monkeypatch):
    logits, temperature, top_k, top_p = FILTER_CASES[case]
    want = _jax_filtered(logits, temperature, top_k, top_p, monkeypatch)
    got = filter_logits(torch.tensor(logits), temperature=temperature,
                        top_k=top_k, top_p=top_p).numpy()
    neg = np.finfo(np.float32).min
    np.testing.assert_array_equal(got > neg, want > neg)
    keep = want > neg
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)
    # every draw lies in the support
    n = 64
    rows = torch.tensor(logits).repeat(n, 1)
    toks = sample_logits(rows, 11, torch.arange(rows.shape[0]),
                         temperature=temperature, top_k=top_k,
                         top_p=top_p).numpy()
    r = np.arange(rows.shape[0]) % len(logits)
    empty = ~keep.any(axis=1)
    # a row whose support is empty (top_p below the 16 eps slack drops
    # even the first token, in JAX as here) draws column 0: the noise
    # vanishes next to finfo.min and the argmax takes the first index
    assert (toks[empty[r]] == 0).all()
    assert keep[r, toks][~empty[r]].all()


def test_greedy_ignores_filters_and_takes_the_first_tie():
    logits = torch.tensor([ORDERED[0], [1.0, 3.0, 3.0, 0.0, 0, 0, 0, 0]])
    out = sample_logits(logits, 0, 0, temperature=0.0, top_k=3, top_p=0.5)
    assert out.tolist() == [0, 1]


def _chi2(logits, temperature, top_k, top_p, toks):
    probs = torch.softmax(filter_logits(torch.tensor([logits]),
                                        temperature=temperature, top_k=top_k,
                                        top_p=top_p), dim=-1)[0].numpy()
    keep = probs > 0
    assert keep[toks].all()
    counts = np.bincount(toks, minlength=len(logits))[keep]
    p = probs[keep].astype(np.float64)
    expected = p / p.sum() * len(toks)
    return scipy.stats.chisquare(counts, expected).pvalue


@pytest.mark.parametrize("vary", ["counter", "seed"])
def test_draws_follow_the_filtered_softmax(vary):
    """Chi-square of 20,000 draws of one row against softmax(filtered
    logits / T): over the counters of one seed (one request's stream),
    and over seeds at one counter (many requests' first tokens)."""
    logits = np.random.default_rng(2).normal(size=16).astype(
        np.float32).tolist()
    n = 20000
    rows = torch.tensor([logits]).repeat(n, 1)
    kw = dict(temperature=0.8, top_k=10, top_p=0.9)
    if vary == "counter":
        toks = sample_logits(rows, [7] * n, torch.arange(n), **kw)
    else:
        toks = sample_logits(rows, 1000, 0, **kw)
    assert _chi2(logits, toks=toks.numpy(), **kw) > 1e-3


def test_draws_at_temperature_one_unfiltered():
    logits = [2.0, 1.0, 0.5, 0.0, -1.0]
    n = 20000
    toks = sample_logits(torch.tensor([logits]).repeat(n, 1), 5, 0,
                         temperature=1.0)
    assert _chi2(logits, 1.0, 0, 1.0, toks.numpy()) > 1e-3


# ---------------------------------------------------------------------
# sampled serving
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    return gpt2_init(torch.Generator().manual_seed(0), CFG)


SAMPLE = dict(temperature=0.9, top_k=20, top_p=0.95)
LENGTHS = (5, 11, 3, 8, 6, 14, 4, 9)
MAX_NEW = (10, 6, 12, 8, 5, 7, 11, 9)
ARRIVALS = (0, 0, 1, 2, 4, 5, 7, 9)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in lengths]


def _engine(params, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("max_seq_len", 40)
    return ServeEngine(gpt2_family(CFG), params, device="cpu", **kw)


def _oracle(params, prompt, max_new, seed, eos=None, **kw):
    return gpt2_generate(params, prompt[None], CFG, max_new_tokens=max_new,
                         eos_token_id=eos, seed=seed, **kw)[0]


def test_sampled_staggered_streams_equal_gpt2_generate(params):
    """8 staggered requests of mixed lengths, sampled with temperature,
    top-k and top-p: each engine stream == gpt2_generate of its prompt
    at its seed."""
    prompts = _prompts(0, LENGTHS)
    seeds = [70 + i for i in range(len(prompts))]
    eng = _engine(params, **SAMPLE)
    rids, step = {}, 0
    while len(rids) < len(prompts) or eng.has_work:
        for i, (p, m, a) in enumerate(zip(prompts, MAX_NEW, ARRIVALS)):
            if i not in rids and a <= step:
                rids[i] = eng.submit(p, m, seed=seeds[i])
        eng.step()
        step += 1
    assert eng.metrics.peak_running >= 2
    for i, (p, m) in enumerate(zip(prompts, MAX_NEW)):
        np.testing.assert_array_equal(eng.result(rids[i]),
                                      _oracle(params, p, m, seeds[i],
                                              **SAMPLE))


def test_preempted_sampled_run_equals_uninterrupted(params):
    """A pool too small for the working set preempts; the evicted
    request re-prefills prompt + generated and keeps drawing at counter
    len(generated): the streams equal the uninterrupted run's and the
    dense decoder's."""
    prompts = _prompts(1, (6, 6, 6))
    seeds = [90, 91, 92]
    small = _engine(params, max_slots=3, block_size=2, num_blocks=9,
                    max_seq_len=16, temperature=0.8, top_k=5)
    outs = generate(small, prompts, max_new_tokens=8, seeds=seeds)
    assert small.metrics.preempted >= 1
    big = _engine(params, max_slots=3, temperature=0.8, top_k=5)
    for a, b, p, s in zip(outs, generate(big, prompts, max_new_tokens=8,
                                         seeds=seeds), prompts, seeds):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, _oracle(params, p, 8, s, temperature=0.8, top_k=5))
    assert small.pool.num_used == 0


def test_seeds_reproduce_and_default_to_the_rid(params):
    prompts = _prompts(2, (5, 7, 4))
    a = generate(_engine(params, **SAMPLE), prompts, max_new_tokens=8,
                 seeds=[1, 2, 3])
    b = generate(_engine(params, **SAMPLE), prompts, max_new_tokens=8,
                 seeds=[1, 2, 3])
    c = generate(_engine(params, **SAMPLE), prompts, max_new_tokens=8,
                 seeds=[4, 5, 6])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any((x != z).any() for x, z in zip(a, c))
    # default: request rid r draws at seed r
    d = generate(_engine(params, **SAMPLE), prompts, max_new_tokens=8)
    for r, (p, out) in enumerate(zip(prompts, d)):
        np.testing.assert_array_equal(out, _oracle(params, p, 8, r,
                                                   **SAMPLE))


def test_eos_stops_a_sampled_request_as_gpt2_generate_pads(params):
    prompts = _prompts(3, (6,))
    want = _oracle(params, prompts[0], 12, 5, **SAMPLE)
    eos = int(want[6 + 3])                    # the 4th sampled token
    first = 6 + int(np.argmax(want[6:] == eos))
    eng = _engine(params, eos_token_id=eos, **SAMPLE)
    out = generate(eng, prompts, max_new_tokens=12, seeds=[5])[0]
    np.testing.assert_array_equal(out, want[:first + 1])
    dense = _oracle(params, prompts[0], 12, 5, eos=eos, **SAMPLE)
    assert (dense[first:] == eos).all()
    np.testing.assert_array_equal(dense[:first + 1], out)


def test_progress_carries_the_resume_state(params):
    """The resume payload mid-flight: (seed, len(generated)) is all the
    chain needs."""
    eng = _engine(params, max_slots=1, **SAMPLE)
    rids = [eng.submit(p, 8, seed=40 + i)
            for i, p in enumerate(_prompts(4, (5, 6)))]
    for _ in range(3):
        eng.step()
    prog = [eng.request(r).progress() for r in rids]
    assert [p.seed for p in prog] == [40, 41]
    assert len(prog[0].generated) >= 1 and prog[1].generated == []


def test_generate_with_filters_runs(params):
    ids = np.zeros((2, 4), np.int32)
    out = gpt2_generate(params, ids, CFG, max_new_tokens=3, temperature=0.8,
                        top_k=10, top_p=0.9, seed=7)
    assert out.shape == (2, 7) and (out[:, :4] == ids).all()
    # an int seed gives row b the stream of seed + b
    one = gpt2_generate(params, ids[1:], CFG, max_new_tokens=3,
                        temperature=0.8, top_k=10, top_p=0.9, seed=8)
    np.testing.assert_array_equal(out[1:], one)
