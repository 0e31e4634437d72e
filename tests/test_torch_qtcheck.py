"""qtcheck of the port (``quintnet_tpu_torch/analysis/``) against JAX's.

The functions of JAX's ``tests/test_qtcheck.py`` that have a torch
meaning, on one device; the collective censuses of the mesh programs
run in gloo worlds in ``tests/test_torch_census.py``.

- Recompile sentinels: the serve engine runs exactly ONE prefill and
  ONE decode program across JAX's mixed trace, with ``compile_counts()``
  equal to JAX's engine on the same trace; a Python int scalar is weak
  (a position never makes a new program); the trainer's step is wrapped.
- The single-device serving programs are collective-free, clean of f64
  upcasts and 16-bit accumulation under every KV and weight layout, and
  keep their pool (and scales) in place; the plain path reads
  n_layer x {k, v} gathered views of the pool.
- ``dtype_report`` flags an f32 -> f64 upcast (JAX's check fails on jax
  0.9.0; the port's passes) and 16-bit accumulation; ``donation_report``
  flags a functional update and clears an in-place one.
- The lint rules on torch snippets, the committed baseline gate and the
  CLI (new, stale, ``--write-baseline``).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu_torch.analysis import specs as census_specs
from quintnet_tpu_torch.analysis.lint import (UNPORTED_RULES,
                                              compare_baseline, lint_paths,
                                              lint_source, load_baseline,
                                              violations_to_baseline)
from quintnet_tpu_torch.analysis.recompile import (RecompileError,
                                                   RecompileSentinel)
from quintnet_tpu_torch.analysis.step_audit import (collective_census,
                                                    donation_report,
                                                    dtype_report,
                                                    gathered_view_gathers)
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.serve import ServeEngine, SpecConfig, gpt2_family

REPO = os.path.join(os.path.dirname(__file__), "..")
BASELINE = os.path.join(REPO, "quintnet_tpu_torch", "tools",
                        "qtcheck_baseline.json")
LINT_PATHS = ["quintnet_tpu_torch", "chip_smoke.py"]

CFG = GPT2Config.tiny(n_layer=2)
JCFG = JaxGPT2Config.tiny(n_layer=2)
I32 = dict(dtype=torch.int32)


@pytest.fixture(scope="module")
def gpt2():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _engine(params, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("max_seq_len", 32)
    return ServeEngine(gpt2_family(CFG), params, device="cpu", **kw)


def _programs(eng):
    """(program, args, kwargs) for one bucket of each program family:
    the sentinel-wrapped call with its per-step arguments (all-zero
    tables: every write lands in the null block)."""
    k, v, *scales = eng.pool.caches()
    kv = eng._kv_kw(scales)
    S, M, bs = eng.max_slots, eng.table_width, eng.pool.block_size
    b = eng.prefill_buckets[0]
    out = [(eng._prefills[b],
            (k, v, torch.zeros((1, b), **I32), 0, 1,
             torch.zeros((M,), **I32), bs), kv),
           (eng._decodes[None],
            (k, v, torch.zeros((S,), **I32), torch.zeros((S,), **I32),
             torch.zeros((S, M), **I32), bs), kv)]
    if eng.spec is not None:
        w = eng.spec.buckets[0]
        out.append((eng._verifies[w],
                    (k, v, torch.zeros((S, w + 1), **I32),
                     torch.zeros((S,), **I32), torch.ones((S,), **I32),
                     torch.zeros((S, M), **I32), bs), kv))
    return out


# ---------------------------------------------------------------------
# serve programs: census, the one-program invariant, in-place pools
# ---------------------------------------------------------------------

class TestServe:
    def test_single_device_census_is_collective_free(self, gpt2):
        _, params = gpt2
        eng = _engine(params, spec=SpecConfig())
        for program, args, kw in _programs(eng):
            census = collective_census(program, *args, **kw)
            assert census.diff(census_specs.expected_serve_prefill(
                CFG.n_layer)) == [], census.as_dict()
            assert census.total() == 0

    def test_one_prefill_one_decode_across_mixed_trace(self, gpt2):
        """The serving promise as a sentinel-enforced invariant, on
        JAX's mixed trace (staggered arrivals, varying prompt lengths,
        retirements, block growth in a tight pool): ONE prefill
        program and ONE decode program, the same counts JAX's engine
        reports on the same trace, and the same greedy streams."""
        jp, params = gpt2
        kw = dict(max_slots=3, block_size=2, num_blocks=12, max_seq_len=16)
        eng = _engine(params, **kw)
        jeng = JaxServeEngine(jax_gpt2_family(JCFG), jp, **kw)
        rng = np.random.default_rng(0)
        prompts = [np.asarray(rng.integers(0, CFG.vocab_size, (n,)),
                              np.int32) for n in (3, 5, 4, 6, 3)]
        arrivals = [0, 1, 2, 5, 8]
        outs = []
        for e in (eng, jeng):
            rids, submitted, step = [], 0, 0
            while submitted < len(prompts) or e.has_work:
                while (submitted < len(prompts)
                       and arrivals[submitted] <= step):
                    rids.append(e.submit(prompts[submitted], 5))
                    submitted += 1
                e.step()
                step += 1
                assert step < 500
            assert e.metrics.finished == len(prompts)
            outs.append([np.asarray(e.result(r)) for r in rids])
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        assert eng.compile_stats() == jeng.compile_stats() == {
            "prefill": 1, "decode": 1}
        assert eng.compile_counts() == jeng.compile_counts()
        eng.assert_compile_count()   # raises with a diff on violation

    def test_donation_no_aliasable_misses(self, gpt2):
        """Every program updates the pool in place (its torch meaning of
        donation) and leaves nothing aliasable in new storage."""
        _, params = gpt2
        for program, args, kw in _programs(_engine(params)):
            rep = donation_report(program, *args, **kw)
            assert rep.undonated_aliasable == [], rep.summary()
            by = rep.by_path()
            assert by["args[0]"].donated and by["args[1]"].donated

    def test_verify_census_matches_decode_every_bucket(self, gpt2):
        """The verify programs are collective-free on one device, every
        draft-length bucket (their tp census: test_torch_census.py)."""
        _, params = gpt2
        eng = _engine(params)
        assert eng.compile_stats() == {"prefill": 0, "decode": 0}
        seng = _engine(params, spec=SpecConfig())
        assert tuple(seng._verifies) == seng.spec.buckets
        k, v = seng.pool.caches()
        S, M = seng.max_slots, seng.table_width
        for w in seng.spec.buckets:
            census = collective_census(
                seng._verifies[w], k, v, torch.zeros((S, w + 1), **I32),
                torch.zeros((S,), **I32), torch.ones((S,), **I32),
                torch.zeros((S, M), **I32), seng.pool.block_size)
            assert census.diff(census_specs.expected_serve_verify(
                CFG.n_layer)) == []
            assert census.total() == 0

    def test_verify_donation_no_aliasable_misses(self, gpt2):
        _, params = gpt2
        program, args, kw = _programs(_engine(params,
                                              spec=SpecConfig()))[2]
        rep = donation_report(program, *args, **kw)
        assert rep.undonated_aliasable == [], rep.summary()
        assert rep.donated_bytes > 0

    def test_ep1_census_is_collective_free(self):
        """An MoE family with no ep axis is the dense-replicated
        program: zero collectives (``expected_serve_moe`` with
        ``ep_axis=None``)."""
        cfg = GPT2Config.tiny(n_layer=2, n_experts=4, expert_top_k=2)
        jp = jax_gpt2_init(jax.random.key(0),
                           JaxGPT2Config.tiny(n_layer=2, n_experts=4,
                                              expert_top_k=2))
        tp = gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        eng = ServeEngine(gpt2_family(cfg), tp, device="cpu", max_slots=3,
                          block_size=4, num_blocks=24, max_seq_len=32)
        assert eng.ep_axis is None
        assert census_specs.expected_serve_moe(cfg.n_layer) == {}
        for program, args, kw in _programs(eng):
            assert collective_census(program, *args, **kw).total() == 0

    def test_recompile_raises_on_a_drifting_signature(self, gpt2):
        """The decode program's sentinel refuses a second signature
        before dispatch, naming the drifting leaf."""
        _, params = gpt2
        eng = _engine(params)
        program, args, kw = _programs(eng)[1]
        program(*args, **kw)
        bad = list(args)
        bad[2] = bad[2].long()                 # tok row as int64
        with pytest.raises(RecompileError, match=r"int32\[3\]@cpu -> "
                                                 r"int64\[3\]@cpu"):
            program(*bad, **kw)
        assert eng.compile_counts()["decode"] == 1

    def test_gathered_view_gathers_on_the_plain_path(self, gpt2):
        """On the CPU the K4 wrapper runs its plain version, which reads
        each layer's k and v gathered views (and both scales under a
        scaled policy); K4's path reads none (chip_smoke.py holds that
        on the card)."""
        _, params = gpt2
        for kv_dtype, per_layer in (("f32", 2), ("int8", 4)):
            eng = _engine(params, kv_dtype=kv_dtype)
            program, args, kw = _programs(eng)[1]
            n = gathered_view_gathers(program, *args, num_blocks=24,
                                      table_width=eng.table_width, **kw)
            assert n == per_layer * CFG.n_layer, (kv_dtype, n)


# ---------------------------------------------------------------------
# dtype census per KV and weight layout policy
# ---------------------------------------------------------------------

class TestServeDtypeCensus:
    @pytest.mark.parametrize("kv_dtype",
                             ["f32", "bf16", "int8", "fake_quant"])
    def test_dtype_census_clean_every_policy(self, gpt2, kv_dtype):
        _, params = gpt2
        eng = _engine(params, kv_dtype=kv_dtype, spec=SpecConfig())
        assert eng.kv_policy.name == kv_dtype
        for program, args, kw in _programs(eng):
            issues = dtype_report(program, *args, **kw)
            assert issues == [], (kv_dtype, [i.detail for i in issues])

    def test_int8_single_device_collective_free(self, gpt2):
        _, params = gpt2
        for program, args, kw in _programs(
                _engine(params, kv_dtype="int8", spec=SpecConfig())):
            assert collective_census(program, *args, **kw).total() == 0

    def test_scaled_programs_donate_scales(self, gpt2):
        """The scale tensors update in place every step, like the
        pools."""
        _, params = gpt2
        for program, args, kw in _programs(
                _engine(params, kv_dtype="int8", spec=SpecConfig())):
            rep = donation_report(program, *args, **kw)
            assert rep.undonated_aliasable == [], rep.summary()
            by = rep.by_path()
            assert by["kv_scales[0]"].donated and by["kv_scales[1]"].donated


class TestWeightDtypeCensus:
    @pytest.mark.parametrize("weights_dtype",
                             ["f32", "bf16", "int8", "fp8", "fake_quant"])
    def test_dtype_census_clean_every_policy(self, gpt2, weights_dtype):
        """The packed-weight programs upcast inside the matmuls: no
        policy adds a 16-bit accumulation or an f64 upcast."""
        _, params = gpt2
        eng = _engine(params, weights_dtype=weights_dtype,
                      spec=SpecConfig())
        assert eng.weight_policy.name == weights_dtype
        for program, args, kw in _programs(eng):
            issues = dtype_report(program, *args, **kw)
            assert issues == [], (weights_dtype, [i.detail for i in issues])

    def test_int8_single_device_collective_free(self, gpt2):
        _, params = gpt2
        for program, args, kw in _programs(
                _engine(params, weights_dtype="int8", spec=SpecConfig())):
            assert collective_census(program, *args, **kw).total() == 0

    def test_packed_programs_keep_pool_donation(self, gpt2):
        _, params = gpt2
        for program, args, kw in _programs(
                _engine(params, weights_dtype="int8", spec=SpecConfig())):
            rep = donation_report(program, *args, **kw)
            assert rep.undonated_aliasable == [], rep.summary()
            assert rep.by_path()["args[0]"].donated


# ---------------------------------------------------------------------
# recompile sentinel unit behaviour
# ---------------------------------------------------------------------

class TestRecompileSentinel:
    def test_counts_distinct_abstract_signatures(self):
        s = RecompileSentinel("t", lambda x: x + 1)
        s(torch.zeros((2,)))
        s(torch.ones((2,)))                 # same signature
        assert s.compile_count == 1
        s(torch.zeros((3,)))                # new shape
        assert s.compile_count == 2
        s(torch.zeros((2,), dtype=torch.int32))  # new dtype
        assert s.compile_count == 3

    def test_max_compiles_raises_before_dispatch_with_diff(self):
        calls = []
        s = RecompileSentinel("t", lambda x: calls.append(1),
                              max_compiles=1)
        s(torch.zeros((2,)))
        with pytest.raises(RecompileError, match=r"float32\[2\]"):
            s(torch.zeros((4,)))
        assert len(calls) == 1   # the violating call never dispatched

    def test_assert_compile_count(self):
        s = RecompileSentinel("t", lambda x: x)
        s(torch.zeros((2,)))
        s.assert_compile_count(1)
        with pytest.raises(RecompileError, match="expected 2"):
            s.assert_compile_count(2)

    def test_python_scalars_are_weak_like_jax(self):
        """A Python int is a weak scalar of its type, not its value, as
        ``jax.core.get_aval(5)`` is a weak ``int32[]``: the engine's
        positions never make a new program. A type change does."""
        from quintnet_tpu.analysis.recompile import \
            abstract_signature as jax_signature

        from quintnet_tpu_torch.analysis.recompile import abstract_signature

        s = RecompileSentinel("t", lambda *a: None, max_compiles=1)
        for start in range(5):
            s(torch.zeros((1, 16)), start, start + 1)
        assert s.compile_count == 1
        with pytest.raises(RecompileError, match="weak:int"):
            s(torch.zeros((1, 16)), 0.5, 1)
        assert (jax_signature((3,), {}) == jax_signature((4,), {}))
        assert (abstract_signature((3,), {})
                == abstract_signature((4,), {}))
        assert (abstract_signature((3,), {})
                != abstract_signature((3.0,), {}))

    def test_sentinels_keep_no_reference_to_their_owner(self, gpt2):
        """The engine's and the trainer's sentinels wrap callables that
        do not reach back to their owner: an engine (its KV pool) and a
        trainer are freed by refcount when dropped, not at some later gc
        pass (a cycle there pinned whole models on the card)."""
        import gc
        import weakref

        from quintnet_tpu_torch.core.config import Config
        from quintnet_tpu_torch.models.gpt2 import gpt2_model_spec
        from quintnet_tpu_torch.train.trainer import Trainer

        _, params = gpt2
        was = gc.isenabled()
        gc.disable()
        try:
            eng = _engine(params, spec=SpecConfig())
            eng.warmup()
            pool = weakref.ref(eng.pool.k)
            del eng
            assert pool() is None
            tr = Trainer(Config.from_dict({"training": {"batch_size": 2}}),
                         gpt2_model_spec(CFG), task_type="clm",
                         device="cpu", log_fn=lambda m: None)
            ref = weakref.ref(tr)
            del tr
            assert ref() is None
        finally:
            if was:
                gc.enable()

    def test_trainer_step_is_wrapped(self):
        """The trainer wires its step through the sentinel: one program
        for a constant-shape loop, as JAX's trainer on the same run."""
        from quintnet_tpu_torch.core.config import Config
        from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec
        from quintnet_tpu_torch.train.trainer import Trainer

        cfg = Config.from_dict({"training": {"batch_size": 8, "epochs": 1,
                                             "log_every": 0}})
        vit = ViTConfig(image_size=14, patch_size=7, in_channels=1,
                        hidden_dim=16, depth=2, num_heads=2, num_classes=10)
        trainer = Trainer(cfg, vit_model_spec(vit), device="cpu",
                          log_fn=lambda m: None)
        x = torch.zeros((8, 14, 14, 1))
        y = torch.zeros((8,), dtype=torch.int64)
        hist = trainer.fit(lambda ep: [(x, y)] * 2,
                           val_batches_fn=lambda ep: [(x, y)])
        assert len(hist.train_loss) == 1
        trainer.assert_compile_count(steps=1, evals=1)
        with pytest.raises(RecompileError, match="expected 2"):
            trainer.assert_compile_count(steps=2)


# ---------------------------------------------------------------------
# dtype report
# ---------------------------------------------------------------------

class TestDtypeReport:
    def test_flags_f64_upcast(self):
        """JAX's counterpart fails on jax 0.9.0 (its x64 context no
        longer widens the convert); the port's walk sees the ATen copy
        that widens f32 to f64."""
        issues = dtype_report(lambda x: x.to(torch.float64).sum(),
                              torch.zeros((4,)))
        assert any(i.kind == "f64-upcast" for i in issues), issues

    def test_flags_half_precision_accumulation(self):
        issues = dtype_report(lambda a, b: a @ b,
                              torch.zeros((4, 4), dtype=torch.bfloat16),
                              torch.zeros((4, 4), dtype=torch.bfloat16))
        assert any(i.kind == "half-accum" and i.primitive == "mm"
                   for i in issues), issues

    def test_clean_with_f32_accumulation(self):
        """The mixed-precision recipe — bf16 storage, f32 sums — passes
        (torch's sum keeps bf16 unless asked for f32)."""
        def f(a, b):
            return (a.float() @ b.float(),
                    torch.sum(a, dim=0, dtype=torch.float32))

        assert dtype_report(f, torch.zeros((4, 4), dtype=torch.bfloat16),
                            torch.zeros((4, 4), dtype=torch.bfloat16)) == []

    def test_train_step_is_clean(self):
        """The shipped f32 train step neither upcasts to f64 nor
        accumulates in 16-bit."""
        step, params, state, batch = _train_step()
        assert dtype_report(step, params, state, batch) == []


def _train_step(optimizer="adamw"):
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.pytree import tree_map
    from quintnet_tpu_torch.models.vit import (ViTConfig, vit_init,
                                               vit_model_spec)
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.train.trainer import make_optimizer

    config = Config.from_dict({"training": {"batch_size": 8,
                                            "optimizer": optimizer}})
    vit = ViTConfig(image_size=14, patch_size=7, in_channels=1,
                    hidden_dim=16, depth=2, num_heads=2, num_classes=10)
    model = vit_model_spec(vit)
    strat = get_strategy(None, config)
    opt = make_optimizer(config)
    params = tree_map(lambda t: t.requires_grad_(True), strat.shard_params(
        model, vit_init(torch.Generator().manual_seed(0), vit)))
    state = strat.init_opt_state(model, opt, params)
    g = torch.Generator().manual_seed(1)
    batch = strat.shard_batch((torch.randn((8, 14, 14, 1), generator=g),
                               torch.randint(0, 10, (8,), generator=g)),
                              model)
    return strat.make_train_step(model, opt), params, state, batch


# ---------------------------------------------------------------------
# in-place state report (donation)
# ---------------------------------------------------------------------

class TestDonationReport:
    def test_flags_undonated_train_state(self):
        """A functional update (new tensors for params and state) is the
        missed donation; the in-place update clears it."""
        def functional(p, s, g):
            s = s * 0.9 + g
            return p - 0.1 * s, s

        def in_place(p, s, g):
            s.mul_(0.9).add_(g)
            p.sub_(0.1 * s)
            return p, s

        p, s, g = (torch.zeros((32, 32)) for _ in range(3))
        rep = donation_report(functional, p, s, g)
        assert {a.path for a in rep.undonated_aliasable} == {
            "args[0]", "args[1]"}, rep.summary()
        rep2 = donation_report(in_place, p, s, g)
        assert rep2.undonated_aliasable == [], rep2.summary()
        assert [a.donated for a in rep2.args] == [True, True, False]

    def test_parallel_train_step_donates_params_and_opt(self):
        """The train step updates every parameter and every optimizer
        state tensor in place; nothing aliasable is left in new
        storage."""
        step, params, state, batch = _train_step()
        rep = donation_report(step, params, state, batch)
        assert rep.undonated_aliasable == [], rep.summary()
        for a in rep.args:
            if a.path.startswith(("args[0]", "args[1]")):
                assert a.donated, a


# ---------------------------------------------------------------------
# linter rules (synthetic torch snippets)
# ---------------------------------------------------------------------

SNIPPET_RNG = """
import numpy as np
import random
import torch

def f(x, g):
    a = torch.randn(3)
    b = np.random.normal(size=3)
    c = random.random()
    d = torch.randn(3, generator=g)
    e = np.random.default_rng(0).normal(size=3)
    m = torch.bernoulli(x)
    return a, b, c, d, e, m
"""

SNIPPET_HOST_SYNC = """
def run(step_fn, params, batches):
    losses = []
    for b in batches:
        params, loss = step_fn(params, b)
        losses.append(float(loss))
    return losses
"""

SNIPPET_HOST_READS = """
import torch

def serve(engine):
    while engine.has_work:
        out = engine.step()
        a = out.item()
        b = out.cpu()
        c = out.tolist()
        d = out.numpy()
        torch.cuda.synchronize()
"""

SNIPPET_MUTABLE_DEFAULT = """
import numpy as np
import torch

def f(x, acc=[], table=np.zeros(4), t=torch.zeros(4)):
    acc.append(x)
    return table, t
"""

SNIPPET_TIMING = """
import time

def bench(step, params, b):
    t0 = time.perf_counter()
    for _ in range(10):
        out = step(params, b)
    return time.perf_counter() - t0
"""

SNIPPET_TIMING_OK = """
import time, torch

def bench(step, params, b):
    t0 = time.perf_counter()
    for _ in range(10):
        out = step(params, b)
    torch.cuda.synchronize()
    return time.perf_counter() - t0
"""


class TestLintRules:
    def _rules(self, src):
        return {v.rule for v in lint_source(src, "x.py")}

    def test_global_rng_draws_flagged(self):
        """QT102's torch meaning: a draw with no explicit generator
        (torch, numpy or stdlib), anywhere — not only in traced code,
        since the port traces nothing."""
        vs = [v for v in lint_source(SNIPPET_RNG, "x.py")
              if v.rule == "QT102"]
        assert len(vs) == 4, [v.render() for v in vs]
        text = " ".join(v.message for v in vs)
        for name in ("torch.randn", "np.random.normal", "random.random",
                     "torch.bernoulli"):
            assert name in text

    def test_jax_only_rules_never_fire(self):
        """QT101 and QT103 have no torch meaning: JAX's own snippets
        (host numpy and a tracer branch in a jitted function) give
        neither."""
        src = ("import jax, numpy as np\n@jax.jit\ndef f(x):\n"
               "    if np.any(x > 0):\n        return np.asarray(x)\n"
               "    return -x\n")
        assert self._rules(src) == set()
        assert set(UNPORTED_RULES) == {"QT101", "QT103"}

    def test_host_sync_in_step_loop(self):
        assert "QT104" in self._rules(SNIPPET_HOST_SYNC)

    def test_torch_host_reads_in_step_loop(self):
        vs = [v for v in lint_source(SNIPPET_HOST_READS, "x.py")
              if v.rule == "QT104"]
        assert len(vs) == 5, [v.render() for v in vs]

    def test_float_outside_step_loop_not_flagged(self):
        src = "def f(x):\n    return float(x)\n"
        assert self._rules(src) == set()

    def test_mutable_and_tensor_defaults(self):
        vs = [v for v in lint_source(SNIPPET_MUTABLE_DEFAULT, "x.py")
              if v.rule == "QT105"]
        assert len(vs) == 3   # the list, np.zeros and torch.zeros

    def test_timing_without_sync_flagged_with_sync_clean(self):
        assert "QT106" in self._rules(SNIPPET_TIMING)
        assert "QT106" not in self._rules(SNIPPET_TIMING_OK)
        helper = SNIPPET_TIMING.replace(
            "    return time.perf_counter()",
            "    _sync()\n    return time.perf_counter()")
        assert "QT106" not in self._rules(helper)

    def test_pragma_suppresses_specific_rule(self):
        src = SNIPPET_HOST_SYNC.replace(
            "losses.append(float(loss))",
            "losses.append(float(loss))  # qtcheck: ok[QT104]")
        assert "QT104" not in self._rules(src)
        src2 = SNIPPET_HOST_SYNC.replace(
            "losses.append(float(loss))",
            "losses.append(float(loss))  # qtcheck: ok[QT106]")
        assert "QT104" in self._rules(src2)

    def test_host_math_float_not_flagged(self):
        src = ("import numpy as np\n"
               "def run(step_fn, xs):\n"
               "    for x in xs:\n"
               "        step_fn(x)\n"
               "        y = float(np.exp(1.0))\n")
        assert self._rules(src) == set()


# ---------------------------------------------------------------------
# baseline gate: committed baseline == tree, exactly
# ---------------------------------------------------------------------

class TestBaselineGate:
    def test_lint_baseline_gate(self):
        violations = lint_paths(LINT_PATHS, root=REPO)
        new, stale = compare_baseline(violations, load_baseline(BASELINE))
        assert new == [], "\n".join(new)
        assert stale == [], "\n".join(stale)

    def test_baseline_entries_all_carry_notes(self):
        missing = [e for e in load_baseline(BASELINE)["violations"]
                   if not e.get("note")]
        assert missing == [], missing

    def test_cli_gate_passes(self):
        from quintnet_tpu_torch.tools.qtcheck import main

        assert main(["--baseline", BASELINE, "--root", REPO]) == 0

    def test_cli_detects_new_violation(self, tmp_path, capsys):
        from quintnet_tpu_torch.tools.qtcheck import main

        bad = tmp_path / "pkg"
        bad.mkdir()
        (bad / "mod.py").write_text(SNIPPET_RNG)
        rc = main([str(bad), "--root", str(tmp_path),
                   "--baseline", BASELINE])
        assert rc == 1
        assert "NEW" in capsys.readouterr().out

    def test_stale_baseline_fails(self, tmp_path):
        from quintnet_tpu_torch.tools.qtcheck import main

        stale_base = violations_to_baseline([])
        stale_base["violations"] = [{
            "rule": "QT106", "path": "nonexistent.py",
            "symbol": "gone", "count": 1, "line": 1}]
        p = tmp_path / "base.json"
        p.write_text(json.dumps(stale_base))
        clean = tmp_path / "pkg"
        clean.mkdir()
        (clean / "ok.py").write_text("x = 1\n")
        assert main([str(clean), "--root", str(tmp_path),
                     "--baseline", str(p)]) == 1

    def test_write_baseline_round_trip_keeps_notes(self, tmp_path, capsys):
        """``--write-baseline`` regenerates the file from the tree and
        keeps the notes of surviving entries; the gate then passes."""
        from quintnet_tpu_torch.tools.qtcheck import main

        pkg = tmp_path / "pkg"
        pkg.mkdir()
        (pkg / "mod.py").write_text(SNIPPET_TIMING)
        p = tmp_path / "base.json"
        base = violations_to_baseline(
            lint_paths(["pkg"], root=str(tmp_path)),
            {("QT106", "pkg/mod.py", "bench"): "host wall clock"})
        p.write_text(json.dumps(base))
        (pkg / "mod.py").write_text(SNIPPET_TIMING + SNIPPET_HOST_SYNC)
        assert main(["pkg", "--root", str(tmp_path),
                     "--baseline", str(p)]) == 1
        assert main(["pkg", "--root", str(tmp_path), "--baseline", str(p),
                     "--write-baseline"]) == 0
        entries = {e["symbol"]: e for e in load_baseline(p)["violations"]}
        assert entries["bench"]["note"] == "host wall clock"
        assert "run" in entries and entries["run"]["rule"] == "QT104"
        assert main(["pkg", "--root", str(tmp_path),
                     "--baseline", str(p)]) == 0
        assert main(["pkg", "--root", str(tmp_path),
                     "--write-baseline"]) == 2
        capsys.readouterr()

    def test_cli_loads_standard_library_only(self):
        """Run as a file, the CLI imports no torch and no jax."""
        import subprocess
        import sys

        code = ("import runpy, sys; sys.argv = ['qtcheck', '--list-rules'];"
                "\ntry:\n    runpy.run_path('quintnet_tpu_torch/tools/"
                "qtcheck.py', run_name='__main__')\nexcept SystemExit:\n"
                "    pass\nassert 'torch' not in sys.modules\n"
                "assert 'jax' not in sys.modules\nprint('ok')")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and "ok" in out.stdout, out.stderr
        assert "QT104" in out.stdout and "QT201" in out.stdout
