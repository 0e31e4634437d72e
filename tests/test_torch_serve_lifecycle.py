"""The port engine's lifecycle surface (the serving fleet's) against the
JAX package: deadlines (``submit(deadline_s=)``, the per-step sweep,
``DeadlineExceeded``), ``pause_admissions`` / ``resume_admissions`` /
``drain``, ``export_progress`` / ``restore_progress`` (plain,
mid-prefill, mid-speculation onto a spec-off engine), the engine's KV
chain export / import / peek, and ``log_every``.

The cases are JAX's (``tests/test_serve.py:397-560``,
``tests/test_longctx.py:304-345``, ``tests/test_spec.py:362-400``) on
the same weights (JAX's ``gpt2_init``, bridged): greedy streams are held
to JAX's engine or ``gpt2_generate``; sampled ones to the port's
``gpt2_generate`` at the request's seed (the port's counter chain is its
own, so ``(seed, len(generated))`` is the whole resume state).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2_generate import \
    gpt2_generate as jax_gpt2_generate
from quintnet_tpu.serve import RequestProgress as JaxRequestProgress
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
from quintnet_tpu_torch.serve import (RequestProgress, ServeEngine,
                                      SpecConfig, generate, gpt2_family)
from quintnet_tpu_torch.serve.scheduler import DeadlineExceeded

torch.set_num_threads(1)

CFG = GPT2Config.tiny(n_layer=2)
JCFG = JaxGPT2Config.tiny(n_layer=2)
CFG_REP = GPT2Config.tiny(n_layer=2, n_positions=256)
JCFG_REP = JaxGPT2Config.tiny(n_layer=2, n_positions=256)
SAMPLED = dict(temperature=0.9, top_k=7)


def _both(key, jcfg):
    jp = jax_gpt2_init(jax.random.key(key), jcfg)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def params():
    return _both(0, JCFG)


@pytest.fixture(scope="module")
def rep_params():
    return _both(1, JCFG_REP)


@pytest.fixture(scope="module")
def long_params():
    return _both(0, JCFG_REP)


def _engine(tp, cfg=CFG, **kw):
    base = dict(max_slots=2, block_size=4, num_blocks=32, max_seq_len=40)
    base.update(kw)
    return ServeEngine(gpt2_family(cfg), tp, device="cpu", **base)


def _jax_engine(jp, jcfg=JCFG, **kw):
    base = dict(max_slots=2, block_size=4, num_blocks=32, max_seq_len=40)
    base.update(kw)
    return JaxServeEngine(jax_gpt2_family(jcfg), jp, **base)


def _prompts(rng, lengths, vocab=CFG.vocab_size):
    return [rng.integers(0, vocab, (t,)).astype(np.int32) for t in lengths]


def _greedy(jp, prompt, max_new, jcfg=JCFG):
    """JAX's greedy oracle."""
    return np.asarray(jax_gpt2_generate(jp, prompt[None], jcfg,
                                        max_new_tokens=max_new,
                                        temperature=0.0,
                                        key=jax.random.key(0))[0])


def _sampled(tp, prompt, max_new, seed, cfg=CFG, **kw):
    """The port's sampled oracle at ``seed``."""
    return gpt2_generate(tp, prompt[None], cfg, max_new_tokens=max_new,
                         seed=seed, **(kw or SAMPLED))[0]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------
# export / restore
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_export_restore_progress_cross_engine_exact(params, rng, mode):
    """Progress exported mid-flight from engine A (a running slot and a
    waiting row) and restored on a fresh engine B continues the stream:
    greedy equal to JAX's greedy, sampled to the port's oracle at the
    request's seed (the rid, the engine's default)."""
    jp, tp = params
    kw = SAMPLED if mode == "sampled" else {}
    prompts = _prompts(rng, (5, 6))
    a = _engine(tp, max_slots=1, **kw)
    rids = [a.submit(p, 8) for p in prompts]
    for _ in range(3):
        a.step()
    progs = a.export_progress()
    assert [p.rid for p in progs] == rids
    assert len(progs[0].generated) >= 1        # running, mid-flight
    assert progs[1].generated == []            # still waiting
    assert [p.seed for p in progs] == rids
    assert all(p.trace_id == f"req-{r}" for p, r in zip(progs, rids))

    b = _engine(tp, **kw)
    new = [b.restore_progress(p) for p in progs]
    b.run()
    for rid, p, nr in zip(rids, prompts, new):
        want = (_sampled(tp, p, 8, rid) if mode == "sampled"
                else _greedy(jp, p, 8))
        np.testing.assert_array_equal(b.result(nr), want)
    if mode == "greedy":
        # and JAX's own export/restore of the same greedy script
        ja = _jax_engine(jp, max_slots=1)
        jr = [ja.submit(p, 8) for p in prompts]
        for _ in range(3):
            ja.step()
        jprogs = ja.export_progress()
        assert [list(j.generated) for j in jprogs] == \
            [list(p.generated) for p in progs]
        assert [j.trace_id for j in jprogs] == [p.trace_id for p in progs]
        assert jr == rids


def test_restore_progress_validation(params, rng):
    """JAX's refusals, with JAX's messages (the port's payload carries a
    seed, never a missing key)."""
    jp, tp = params
    eng, jeng = _engine(tp), _jax_engine(jp)
    prompt = _prompts(rng, (4,))[0]
    kd = np.asarray(jax.random.key_data(jax.random.key(0)))
    for gen, new, pr, match in (([1, 2], 2, prompt, "nothing left"),
                                ([], 4, np.zeros(39, np.int32),
                                 "exceeds max_seq_len")):
        with pytest.raises(ValueError, match=match) as want:
            jeng.restore_progress(JaxRequestProgress(
                rid=0, prompt=pr, generated=gen, key_data=kd,
                max_new_tokens=new))
        with pytest.raises(ValueError, match=match) as got:
            eng.restore_progress(RequestProgress(
                rid=0, prompt=pr, generated=gen, max_new_tokens=new))
        assert str(got.value) == str(want.value)


def test_pause_admissions_and_drain(params, rng):
    """``drain()`` finishes the active slots and leaves the waiting queue
    with admissions paused; ``resume_admissions`` takes it up again."""
    jp, tp = params
    eng = _engine(tp, max_slots=1)
    p1, p2 = _prompts(rng, (4, 4))
    r1 = eng.submit(p1, 4)
    eng.step()                                  # r1 active
    r2 = eng.submit(p2, 4)
    finished = eng.drain()
    assert r1 in finished
    assert eng.admissions_paused
    assert eng.request(r2).state == "waiting"   # queued, not dropped
    assert eng.pool.num_used == 0
    eng.step()                                  # paused: admits nothing
    assert eng.request(r2).state == "waiting"
    eng.resume_admissions()
    assert not eng.admissions_paused
    eng.run()
    np.testing.assert_array_equal(eng.result(r1), _greedy(jp, p1, 4))
    np.testing.assert_array_equal(eng.result(r2), _greedy(jp, p2, 4))
    with pytest.raises(RuntimeError, match="still active"):
        busy = _engine(tp, max_slots=1)
        busy.submit(p1, 8)
        busy.step()
        busy.drain(max_steps=1)


def test_submit_validation(params):
    """A deadline already past at submit is refused as JAX refuses it."""
    jp, tp = params
    for eng in (_engine(tp), _jax_engine(jp)):
        with pytest.raises(ValueError, match="deadline_s=0 already"):
            eng.submit(np.zeros(4, np.int32), 2, deadline_s=0)


# ---------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------

def test_deadline_mid_decode_retires_typed_and_publishes(params, rng):
    """A request whose deadline passes mid-generation is retired with a
    typed ``DeadlineExceeded`` and its blocks published (nothing held
    afterwards, a resubmission hits the cache); the other request of the
    batch finishes as JAX's engine finishes it."""
    jp, tp = params
    p1, p2 = _prompts(rng, (6, 5))
    got = {}
    for side, eng in (("port", _engine(tp, clock=_FakeClock())),
                      ("jax", _jax_engine(jp, clock=_FakeClock()))):
        clk = eng.clock
        r1 = eng.submit(p1, 16, deadline_s=5.0)
        r2 = eng.submit(p2, 8)
        for _ in range(3):
            eng.step()
        before = len(eng.request(r1).generated)
        assert 0 < before < 16
        clk.t = 10.0
        assert r1 in eng.step()
        with pytest.raises(Exception) as ei:
            eng.result(r1)
        assert type(ei.value).__name__ == "DeadlineExceeded"
        assert ei.value.generated == before and ei.value.rid == r1
        assert eng.metrics.deadline_exceeded == 1
        eng.run()
        assert eng.pool.num_used == 0
        hits0 = eng.metrics.prefix_hit_tokens
        eng.submit(p1, 4)
        eng.run()
        assert eng.metrics.prefix_hit_tokens > hits0
        got[side] = (eng.result(r2), before, str(ei.value))
    assert isinstance(DeadlineExceeded("x"), RuntimeError)
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1:] == got["jax"][1:]


def test_deadline_expired_while_waiting_is_typed_too(params, rng):
    """A queued request whose deadline passes fails with
    ``DeadlineExceeded(generated=0)``; the requests behind it run."""
    jp, tp = params
    clk = _FakeClock()
    eng = _engine(tp, max_slots=1, clock=clk)
    p1, p2, p3 = _prompts(rng, (4, 4, 5))
    r1 = eng.submit(p1, 8)
    r2 = eng.submit(p2, 8, deadline_s=5.0)
    r3 = eng.submit(p3, 6)
    eng.step()
    assert eng.request(r2).state == "waiting"
    # the waiting request's export carries its remaining budget
    (prog,) = [p for p in eng.export_progress() if p.rid == r2]
    assert prog.deadline_s == 5.0
    clk.t = 6.0
    assert r2 in eng.step()
    with pytest.raises(DeadlineExceeded, match="never admitted") as ei:
        eng.result(r2)
    assert ei.value.generated == 0
    eng.run()
    np.testing.assert_array_equal(eng.result(r1), _greedy(jp, p1, 8))
    np.testing.assert_array_equal(eng.result(r3), _greedy(jp, p3, 6))


# ---------------------------------------------------------------------
# mid-prefill and mid-speculation exports
# ---------------------------------------------------------------------

def test_export_mid_prefill_carries_prefilled_and_restores(long_params,
                                                           rng):
    """Exported MID-PREFILL (chunked engine): no token generated yet, the
    chunk high-water mark carried, and the restoring engine re-chunks to
    the stream a widened engine gives (sampled: the strictest form)."""
    _jp, tp = long_params
    kw = dict(block_size=8, num_blocks=40, max_seq_len=200,
              temperature=0.8, top_k=5)
    prompt = _prompts(rng, (80,))[0]
    src = _engine(tp, CFG_REP, prefill_len=32, chunked_prefill=True,
                  prefill_chunk_budget=8, **kw)
    src.submit(prompt, 4, seed=9)
    src.step()
    src.step()
    (p,) = src.export_progress()
    assert p.generated == [] and 0 < p.prefilled < len(prompt)
    assert p.seed == 9
    dst = _engine(tp, CFG_REP, prefill_len=32, chunked_prefill=True,
                  prefill_chunk_budget=8, **kw)
    rid = dst.restore_progress(p)
    dst.run(max_steps=100)
    wide = _engine(tp, CFG_REP, prefill_len=200, **kw)
    want = generate(wide, [prompt], max_new_tokens=4, seeds=[9])[0]
    np.testing.assert_array_equal(dst.result(rid), want)
    np.testing.assert_array_equal(
        want, _sampled(tp, prompt, 4, 9, cfg=CFG_REP, temperature=0.8,
                       top_k=5))


def test_export_mid_speculation_carries_committed_only(rep_params):
    """Exported while drafts are being accepted: the payload's tokens are
    a prefix of the greedy oracle (no draft leaks), and a SPEC-OFF
    engine finishes the request equal to JAX's greedy."""
    jp, tp = rep_params
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG_REP.vocab_size, (12,)).astype(np.int32)
    oracle = _greedy(jp, prompt, 60, JCFG_REP)
    kw = dict(max_slots=1, block_size=8, num_blocks=32, max_seq_len=100)
    eng = _engine(tp, CFG_REP, spec=SpecConfig(), **kw)
    eng.submit(prompt, 60)
    for _ in range(60):
        eng.step()
        if eng.metrics.accepted_draft_tokens > 0:
            break
    assert eng.metrics.accepted_draft_tokens > 0 and eng.has_work
    (p,) = eng.export_progress()
    got = np.asarray(p.generated, np.int32)
    assert 0 < len(got) < 60
    np.testing.assert_array_equal(
        got, oracle[len(prompt):len(prompt) + len(got)])
    dest = _engine(tp, CFG_REP, **kw)
    rid = dest.restore_progress(p)
    dest.run(max_steps=300)
    np.testing.assert_array_equal(dest.result(rid), oracle)


# ---------------------------------------------------------------------
# the engine's KV chain surface
# ---------------------------------------------------------------------

def test_kv_chain_export_import_peek(params, rng):
    """Engine A's published chain, exported as host data and imported by
    engine B, is a warm prefix there (``peek_kv_chain`` sees it, the next
    admission hits it) and B's stream is unchanged; the chain's extent
    is JAX's for the same script."""
    jp, tp = params
    prompt = _prompts(rng, (17,))[0]
    a, ja = _engine(tp), _jax_engine(jp)
    for eng in (a, ja):
        eng.submit(prompt, 4)
        eng.run()
    chain = a.export_kv_chain(prompt)
    jchain = ja.export_kv_chain(prompt)
    assert chain is not None and chain["n_tokens"] == jchain["n_tokens"]
    assert a.peek_kv_chain(prompt) == ja.peek_kv_chain(prompt) > 0
    assert a.export_kv_chain(_prompts(rng, (9,))[0]) is None

    b = _engine(tp)
    assert b.peek_kv_chain(prompt) == 0
    n = b.import_kv_chain(chain)
    assert n == chain["n_tokens"] == b.peek_kv_chain(prompt)
    rid = b.submit(prompt, 6)
    b.run()
    assert b.metrics.prefix_hit_tokens > 0
    np.testing.assert_array_equal(b.result(rid), _greedy(jp, prompt, 6))
    with pytest.raises(ValueError):
        _engine(tp, block_size=8).import_kv_chain(chain)


# ---------------------------------------------------------------------
# logger
# ---------------------------------------------------------------------

class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_log_every_lines_equal_jax(params, rng):
    """``logger`` + ``log_every``: one ``serve step=...`` line every N
    steps, the same lines as JAX's engine logs for the same script."""
    jp, tp = params
    prompts = _prompts(rng, (5, 9, 3))
    lines = {}
    for side, make in (("port", lambda **k: _engine(tp, **k)),
                       ("jax", lambda **k: _jax_engine(jp, **k))):
        log = logging.getLogger(f"lifecycle-{side}")
        log.setLevel(logging.INFO)
        log.propagate = False
        h = _Lines()
        log.addHandler(h)
        eng = make(logger=log, log_every=2)
        for p in prompts:
            eng.submit(p, 6)
        eng.run()
        log.removeHandler(h)
        lines[side] = h.lines
        assert len(h.lines) == eng.metrics.steps // 2
    assert lines["port"] == lines["jax"] and lines["port"]
    assert lines["port"][0].startswith("serve step=2 ")
