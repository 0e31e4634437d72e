"""The port's Llama serving (``serve/families.llama_family`` over
``models/llama``'s paged blocks) against the JAX package.

THE contract, JAX's (``tests/test_serve.py:221``): the Llama family
(GQA pool of UNrepeated kv heads, rope at each served position) through
the same engine serves ``llama_generate``'s greedy streams. Here on the
CPU, on JAX's weights (bridged): the engine's greedy streams on JAX's
staggered trace equal JAX's Llama engine (f32 and int8 pools) and JAX's
``llama_generate``; sampled streams equal the port's ``llama_generate``
at each request's seed; fake_quant equals f32, speculation and chunked
prefill equal plain serving; each paged block (decode, prefill, verify;
f32 and int8) within 1e-5 of JAX's block on the same inputs, pools
too; ``ops.paged_attention`` gets the query heads over the UNrepeated kv
heads; rope tables are built at the served positions only; Llama-MoE
serves JAX's streams with JAX's routing summary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quintnet_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quintnet_tpu.models.llama import llama_init as jax_llama_init
from quintnet_tpu.models.llama_generate import \
    llama_generate as jax_llama_generate
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import llama_family as jax_llama_family
from quintnet_tpu_torch.bridge import llama_params_from_numpy
from quintnet_tpu_torch.models import llama as pl
from quintnet_tpu_torch.models.llama import LlamaConfig
from quintnet_tpu_torch.models.llama_generate import llama_generate
from quintnet_tpu_torch.nn import attention
from quintnet_tpu_torch.serve import ServeEngine, SpecConfig, llama_family

torch.set_num_threads(1)

KW = {"n_layers": 2}
MOE_KW = {"n_layers": 2, "n_experts": 4, "expert_top_k": 2}
ENGINE = {"max_slots": 3, "block_size": 4, "num_blocks": 32,
          "max_seq_len": 32}
# JAX's trace (tests/test_serve.py:221): prompts, budgets, arrivals
LENGTHS, MAX_NEW, ARRIVALS = (5, 9, 3, 12), (8, 6, 10, 5), (0, 1, 1, 3)
SAMPLED = {"temperature": 0.8, "top_k": 20, "top_p": 0.9}


def _init(kw):
    jcfg = JaxLlamaConfig.tiny(**kw)
    jp = jax_llama_init(jax.random.key(1), jcfg)
    return (jp, llama_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            jcfg, LlamaConfig.tiny(**kw))


@pytest.fixture(scope="module")
def llama():
    return _init(KW)


def _prompts(seed=0, lengths=LENGTHS, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _staggered(eng, prompts, *, jax_keys=False, seeds=None):
    """Submit request i once the engine has taken ``ARRIVALS[i]`` steps;
    drain; the streams in submission order."""
    order = np.argsort(np.asarray(ARRIVALS), kind="stable")
    rids, submitted, step = {}, 0, 0
    while submitted < len(prompts) or eng.has_work:
        while submitted < len(prompts) and \
                ARRIVALS[order[submitted]] <= step:
            i = order[submitted]
            kw = ({"key": jax.random.key(7)} if jax_keys
                  else {"seed": None if seeds is None else seeds[i]})
            rids[i] = eng.submit(prompts[i], MAX_NEW[i], **kw)
            submitted += 1
        eng.step()
        step += 1
        assert step < 500, "engine failed to drain"
    return [eng.result(rids[i]) for i in range(len(prompts))]


def _port(llama, **kw):
    _, tp, _, cfg = llama
    return ServeEngine(llama_family(cfg), tp, device="cpu",
                       **{**ENGINE, **kw})


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_greedy_streams_equal_jax_engine(llama, kv):
    jp, _, jcfg, _ = llama
    prompts = _prompts()
    want = _staggered(JaxServeEngine(jax_llama_family(jcfg), jp,
                                     kv_dtype=kv, **ENGINE), prompts,
                      jax_keys=True)
    got = _staggered(_port(llama, kv_dtype=kv), prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if kv == "f32":
        for p, m, g in zip(prompts, MAX_NEW, got):
            np.testing.assert_array_equal(g, np.asarray(jax_llama_generate(
                jp, p[None], jcfg, max_new_tokens=m))[0])


def test_fake_quant_equals_f32(llama):
    prompts = _prompts()
    f32 = _staggered(_port(llama), prompts)
    fq = _staggered(_port(llama, kv_dtype="fake_quant"), prompts)
    for a, b in zip(f32, fq):
        np.testing.assert_array_equal(a, b)


def test_sampled_streams_equal_llama_generate(llama):
    """Each request draws from the port's counter chain at its seed, as
    ``llama_generate`` at that seed does."""
    _, tp, _, cfg = llama
    prompts, seeds = _prompts(), [11, 12, 13, 14]
    got = _staggered(_port(llama, **SAMPLED), prompts, seeds=seeds)
    for p, m, sd, g in zip(prompts, MAX_NEW, seeds, got):
        np.testing.assert_array_equal(g, llama_generate(
            tp, p[None], cfg, max_new_tokens=m, seed=sd, **SAMPLED)[0])


@pytest.mark.parametrize("kw", [
    {"spec": SpecConfig()},
    {"chunked_prefill": True, "prefill_len": 8, "prefill_chunk_budget": 4},
], ids=["spec", "chunked"])
def test_spec_and_chunked_equal_plain(llama, kw):
    """Speculation (verify through the paged verify block) and chunked
    prefill serve the plain engine's streams; the repetitive prompts
    give the drafter something to propose."""
    prompts = [np.tile(p[:3], 3) for p in _prompts(5)]
    plain = _staggered(_port(llama), prompts)
    eng = _port(llama, **kw)
    got = _staggered(eng, prompts)
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(a, b)
    if "spec" in kw:
        assert eng.metrics.spec_steps > 0
    else:
        assert eng.metrics.prefill_chunks > len(prompts)


def test_pool_holds_unrepeated_kv_heads_and_the_kernel_takes_gqa(
        llama, monkeypatch):
    """The pool is [L, slots, Hkv, Dh] and every paged attention call
    gets the query heads over the pool's UNrepeated kv heads: nothing
    repeats K/V on the pool or on the kernel's inputs."""
    _, _, _, cfg = llama
    calls = []
    real = attention.paged_attention

    def spy(q, k_pool, v_pool, *a, **k):
        calls.append((q.shape[1], k_pool.shape[1], v_pool.shape[1]))
        return real(q, k_pool, v_pool, *a, **k)

    monkeypatch.setattr(attention, "paged_attention", spy)
    eng = _port(llama)
    assert eng.pool.caches()[0].shape[2] == cfg.n_kv_heads
    _staggered(eng, _prompts())
    assert calls and set(calls) == {(cfg.n_heads, cfg.n_kv_heads,
                                     cfg.n_kv_heads)}


def test_rope_tables_at_served_positions_only(llama, monkeypatch):
    """No table of ``n_positions`` rows: each call builds cos/sin at the
    positions it serves (a bucket's, or one a decoding row)."""
    sizes = []
    real = pl.llama_rope_tables

    def spy(positions, cfg):
        sizes.append(positions.numel())
        return real(positions, cfg)

    monkeypatch.setattr(pl, "llama_rope_tables", spy)
    eng = _port(llama)
    _staggered(eng, _prompts())
    assert sizes and max(sizes) <= max(max(eng.prefill_buckets),
                                       eng.max_slots)


# ---------------------------------------------------------------------
# the paged blocks against JAX's (XLA path) on the same inputs
# ---------------------------------------------------------------------

def _block_inputs(cfg, kind, layout, seed=3):
    """Layer 0's input x, a pool with history in random blocks, a
    disjoint table per row and the rows' positions (decode: 3 rows; prefill: 1 row of
    P = 6 at start 5, 4 true; verify: 3 rows of P = 3)."""
    rng = np.random.default_rng(seed)
    bs, nb, M = 4, 20, 6
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    S, P = {"decode": (3, 1), "prefill": (1, 6), "verify": (3, 3)}[kind]
    starts = {"decode": [9, 4, 0], "prefill": [5],
              "verify": [7, 2, 12]}[kind]
    # disjoint tables: no two rows write one slot
    tables = rng.permutation(np.arange(1, nb))[:S * M].reshape(
        S, M).astype(np.int32)
    shape = (nb * bs, hkv, hd)
    if layout == "int8":
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.random((nb, hkv)) * 0.02 + 0.01).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.normal(size=shape).astype(np.float32)
                 for _ in range(2)]
        scales = None
    x = rng.normal(size=(S, P, cfg.dim)).astype(np.float32)
    positions = np.asarray(starts, np.int32)[:, None] + np.arange(
        P, dtype=np.int32)[None]
    lens = {"decode": [1, 1, 1], "prefill": [4], "verify": [3, 2, 1]}[kind]
    return x, pools, scales, tables, positions, np.asarray(lens, np.int32)


def _jax_block(jp, jcfg, kind, layout, inputs):
    from quintnet_tpu.models import llama as jl
    from quintnet_tpu.serve.kv_quant import make_policy

    x, pools, scales, tables, positions, lens = inputs
    blk = jax.tree.map(lambda a: a[0], jp["blocks"])
    kw = dict(block_size=4, policy=make_policy(layout),
              kv_scales=(None if scales is None
                         else tuple(map(jnp.asarray, scales))))
    kc, vc = map(jnp.asarray, pools)
    cos, sin = jl.llama_rope_tables(jnp.asarray(positions), jcfg)
    if kind == "decode":
        out = jl.llama_block_decode(
            blk, jnp.asarray(x), kc, vc, jnp.asarray(positions[:, 0]), jcfg,
            cos[:, :, None], sin[:, :, None],
            block_tables=jnp.asarray(tables), **kw)
    elif kind == "prefill":
        out = jl.llama_block_prefill_paged(
            blk, jnp.asarray(x), kc, vc, jnp.asarray(positions[0]),
            jnp.int32(lens[0]), jcfg, cos[0], sin[0],
            block_tables=jnp.asarray(tables[0]), **kw)
    else:
        out = jl.llama_block_verify_paged(
            blk, jnp.asarray(x), kc, vc, jnp.asarray(positions),
            jnp.asarray(lens), jcfg, cos[:, None], sin[:, None],
            block_tables=jnp.asarray(tables), **kw)
    return np.asarray(out[0]), [np.asarray(t) for t in out[1]]


def _port_block(tp, cfg, kind, layout, inputs):
    from quintnet_tpu_torch.nn.transformer import layer_params
    from quintnet_tpu_torch.serve.kv_quant import make_policy

    x, pools, scales, tables, positions, lens = map(
        lambda a: None if a is None else (
            [torch.tensor(t) for t in a] if isinstance(a, list)
            else torch.tensor(a)), inputs)
    blk = layer_params(tp["blocks"], 0)
    kw = dict(block_size=4, policy=make_policy(layout),
              kv_scales=None if scales is None else tuple(scales))
    kc, vc = pools
    cos, sin = pl.llama_rope_tables(positions, cfg)
    if kind == "decode":
        out = pl.llama_block_decode(
            blk, x, kc, vc, positions[:, 0], cfg, cos[:, None, None, 0],
            sin[:, None, None, 0], block_tables=tables, **kw)
    elif kind == "prefill":
        out = pl.llama_block_prefill_paged(
            blk, x, kc, vc, positions[0], int(lens[0]), cfg, cos[0], sin[0],
            block_tables=tables[0], **kw)
    else:
        out = pl.llama_block_verify_paged(
            blk, x, kc, vc, positions, lens, cfg, cos[:, None],
            sin[:, None], block_tables=tables, **kw)
    return out[0].numpy(), [t.numpy() for t in out[1]]


@pytest.mark.parametrize("layout", ["f32", "int8"])
@pytest.mark.parametrize("kind", ["decode", "prefill", "verify"])
def test_paged_block_equals_jax(llama, kind, layout):
    """x within 1e-5; the pools' real blocks (1..) within 1e-5 (int8:
    one quantization step; scales 1e-6)."""
    jp, tp, jcfg, cfg = llama
    inputs = _block_inputs(cfg, kind, layout)
    wx, wpools = _jax_block(jp, jcfg, kind, layout, inputs)
    gx, gpools = _port_block(tp, cfg, kind, layout, inputs)
    np.testing.assert_allclose(gx, wx, atol=1e-5, rtol=0)
    assert len(gpools) == len(wpools) == (4 if layout == "int8" else 2)
    for g, w in zip(gpools, wpools):
        rows = 4 if g.ndim == 3 else 1
        g, w = g[rows:], w[rows:]
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(g, w, atol=1e-6 if rows == 1
                                       else 1e-5, rtol=0)


def test_family_prefill_logits_equal_jax(llama):
    """The family's prefill contract: logits at ``t0 - 1`` of a tail at
    an offset, within 1e-5 of JAX's ``llama_family``'s."""
    jp, tp, jcfg, cfg = llama
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 128, (1, 8)).astype(np.int32)
    table = np.array([2, 5, 1, 7, 0, 0], np.int32)
    shape = (1, 8 * 4, cfg.n_kv_heads, cfg.head_dim)
    hist = [rng.normal(size=(cfg.n_layers,) + shape[1:]).astype(np.float32)
            for _ in range(2)]
    wl, *_ = jax_llama_family(jcfg).prefill_from(
        jp, *map(jnp.asarray, hist), jnp.asarray(ids), jnp.int32(4),
        jnp.int32(10), jnp.asarray(table), 4)
    gl, *_ = llama_family(cfg).prefill_from(
        tp, *(torch.tensor(h) for h in hist), torch.tensor(ids), 4, 10,
        torch.tensor(table), 4)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-5,
                               rtol=0)


def test_llama_moe_serves_jax_streams_and_routing():
    jp, tp, jcfg, cfg = _init(MOE_KW)
    prompts = _prompts(2)
    jeng = JaxServeEngine(jax_llama_family(jcfg), jp, **ENGINE)
    want = _staggered(jeng, prompts, jax_keys=True)
    eng = ServeEngine(llama_family(cfg), tp, device="cpu", **ENGINE)
    got = _staggered(eng, prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    sj, sp = jeng.metrics.summary(), eng.metrics.summary()
    assert sp["moe_routed_tokens"] > 0
    for k in ("moe_routed_tokens", "moe_dropped_tokens",
              "moe_expert_tokens"):
        assert sp[k] == sj[k], k
