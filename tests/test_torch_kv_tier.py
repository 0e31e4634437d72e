"""The port's host KV tier (quintnet_tpu_torch/serve/kv_tier.py and its
hooks in kv_pool.py, scheduler.py, engine.py) against the JAX package:
the cases of ``tests/test_kv_tier.py``.

- ``HostTier``: the byte-budgeted LRU, ``contains`` without a touch, an
  oversized record refused, an overwrite, plain-scalar summaries;
- the pool: demote -> promote byte-exact (f32 and int8 pools, the scale
  rows too), and the records byte-equal to JAX's pool's records for the
  same payloads (``export_chain``'s format); ``plan_promotion``'s three
  outcomes; the promote budget; a vanished record cutting the chain;
  namespaces apart across both tiers; ``peek_chain_tokens``; the
  partial ``import_chain``; the eviction heap against the ``min``
  oracle;
- engines: tier-on streams equal tier-off streams and the dense oracle
  (the port's ``gpt2_generate``), greedy and sampled, f32 and int8
  pools, and the greedy streams equal JAX's tier-on engine's; a
  promotion runs while another slot keeps decoding; a record evicted
  mid-promotion degrades to a re-prefill; the constructor's checks with
  JAX's messages;
- the process fleet's peer lookup: a request dispatched to a cold
  replica is warmed from a peer's chain (``kv_peek`` -> ``kv_export`` ->
  ``kv_import`` over the wire) instead of re-prefilled, token for token.

Every comparison here is exact (bytes or tokens).
"""

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.serve import KVPool as JaxKVPool
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu.serve.kv_tier import HostTier as JaxHostTier
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
from quintnet_tpu_torch.serve import KVPool, ServeEngine, gpt2_family
from quintnet_tpu_torch.serve.kv_tier import HostTier, record_nbytes

torch.set_num_threads(1)

JCFG = JaxGPT2Config.tiny(n_layer=2)
CFG = GPT2Config.tiny(n_layer=2)


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _engine(tp, **kw):
    kw = {"max_slots": 2, "block_size": 4, "num_blocks": 10,
          "max_seq_len": 40, **kw}
    return ServeEngine(gpt2_family(CFG), tp, device="cpu", **kw)


def _oracle(tp, prompt, max_new, seed=0, temperature=0.0, top_k=0):
    return gpt2_generate(tp, torch.from_numpy(prompt[None].astype(np.int64)),
                         CFG, max_new_tokens=max_new,
                         temperature=temperature, top_k=top_k,
                         seed=seed)[0]


def _run_one(eng, prompt, max_new, seed=None):
    rid = eng.submit(prompt, max_new, seed=seed)
    while eng.has_work:
        eng.step()
    return eng.result(rid)


def _bytes(t):
    if torch.is_tensor(t):
        return t.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8)


# ---------------------------------------------------------------------
# HostTier: the byte-budgeted LRU store
# ---------------------------------------------------------------------

def _rec(nbytes, fill=4, seed=0):
    """A record whose k + v payload is exactly ``nbytes``."""
    g = torch.Generator().manual_seed(seed)
    half = nbytes // 2
    return {"fill": fill,
            "k": torch.randint(0, 100, (half,), generator=g,
                               dtype=torch.uint8),
            "v": torch.randint(0, 100, (nbytes - half,), generator=g,
                               dtype=torch.uint8)}


def test_budget_must_be_positive_with_jax_message():
    for bad in (0, -1):
        with pytest.raises(ValueError) as t:
            HostTier(byte_budget=bad)
        with pytest.raises(ValueError) as j:
            JaxHostTier(byte_budget=bad)
        assert str(t.value) == str(j.value)


def test_put_get_and_lru_eviction_under_pressure():
    t = HostTier(byte_budget=300)
    for i, key in enumerate((b"a", b"b", b"c")):
        assert t.put(key, _rec(100, seed=i))
    assert t.bytes_used == 300 and len(t) == 3
    assert t.get(b"a") is not None        # "b" is now the LRU victim
    assert t.put(b"d", _rec(100, seed=4))
    assert t.contains(b"a") and not t.contains(b"b")
    assert t.evictions == 1 and t.demotions == 4


def test_contains_does_not_touch_lru():
    t = HostTier(byte_budget=200)
    t.put(b"a", _rec(100, seed=1))
    t.put(b"b", _rec(100, seed=2))
    assert t.contains(b"a")               # a probe, not a use
    t.put(b"c", _rec(100, seed=3))
    assert not t.contains(b"a")


def test_oversized_refused_overwrite_replaces_and_summary():
    t = HostTier(byte_budget=100)
    assert not t.put(b"big", _rec(200))
    assert len(t) == 0 and t.bytes_used == 0
    t = HostTier(byte_budget=300)
    t.put(b"a", _rec(100, seed=1))
    t.put(b"a", _rec(200, seed=2))
    assert len(t) == 1 and t.bytes_used == 200 and t.evictions == 0
    s = t.summary()
    assert s["records"] == 1 and s["demotions"] == 2
    assert all(isinstance(v, int) for v in s.values())


def test_shards_count_whole_blocks():
    """A tp rank's record holds its head shard: ``shards`` counts it as
    the whole block an unsharded tier holds, so every rank evicts where
    the unsharded tier does."""
    t = HostTier(byte_budget=400, shards=2)
    assert t.put(b"a", _rec(100)) and t.bytes_used == 200
    assert t.put(b"b", _rec(100)) and t.put(b"c", _rec(100))
    assert t.evictions == 1 and not t.contains(b"a")


# ---------------------------------------------------------------------
# the pool: demotion on eviction, byte-exact promotion, JAX's records
# ---------------------------------------------------------------------

GEO = {"n_layers": 2, "n_kv_heads": 2, "head_dim": 4, "block_size": 4}


def _pools(num_blocks=4, policy=None, tier=True):
    """The port's pool and JAX's, same geometry, both with a tier."""
    t = KVPool(**GEO, num_blocks=num_blocks, policy=policy, device="cpu",
               host_tier=HostTier(byte_budget=1 << 20) if tier else None)
    j = JaxKVPool(**GEO, num_blocks=num_blocks, policy=policy,
                  host_tier=JaxHostTier(byte_budget=1 << 20)
                  if tier else None)
    return t, j


def _publish_chain(tpool, jpool, toks, seed=0, namespace=None):
    """The same chain published in both pools, with distinct payloads a
    block (and distinct scales under a scaled policy)."""
    rng = np.random.default_rng(seed)
    blocks = tpool.acquire(tpool.blocks_for(len(toks)))
    assert jpool is None or jpool.acquire(len(blocks)) == blocks
    bs = tpool.block_size
    shape = (GEO["n_layers"], bs, GEO["n_kv_heads"], GEO["head_dim"])
    jk = jv = jks = jvs = None
    if jpool is not None:
        jk, jv, jks, jvs = jpool.k, jpool.v, jpool.k_scale, jpool.v_scale
    for b in blocks:
        sl = slice(b * bs, (b + 1) * bs)
        k = rng.integers(-50, 50, shape)
        v = rng.integers(-50, 50, shape)
        tpool.k[:, sl] = torch.tensor(k).to(tpool.k.dtype)
        tpool.v[:, sl] = torch.tensor(v).to(tpool.v.dtype)
        if jpool is not None:
            jk = jk.at[:, sl].set(k.astype(jk.dtype))
            jv = jv.at[:, sl].set(v.astype(jv.dtype))
        if tpool.policy.scaled:
            s = rng.uniform(0.5, 2.0, (2, GEO["n_layers"], GEO["n_kv_heads"])
                            ).astype(np.float32)
            tpool.k_scale[:, b] = torch.tensor(s[0])
            tpool.v_scale[:, b] = torch.tensor(s[1])
            if jpool is not None:
                jks, jvs = jks.at[:, b].set(s[0]), jvs.at[:, b].set(s[1])
    tpool.publish(toks, blocks, len(toks), namespace=namespace)
    tpool.release(blocks)
    if jpool is not None:
        jpool.update(jk, jv, *((jks, jvs) if jpool.policy.scaled else ()))
        jpool.publish(toks, blocks, len(toks), namespace=namespace)
        jpool.release(blocks)
    return blocks


def _evict_all_cached(pool):
    """Drain the free list, then evict (demote) every cached block."""
    held = pool.acquire(pool.num_free + pool.num_cached)
    assert held is not None
    pool.release(held)


def _same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert sorted(ra) == sorted(rb) and ra["fill"] == rb["fill"]
        for f in ra:
            if f != "fill":
                np.testing.assert_array_equal(_bytes(ra[f]), _bytes(rb[f]))


@pytest.mark.parametrize("policy", [None, "int8"])
def test_demote_promote_round_trip_byte_exact_and_equal_to_jax(policy):
    toks = np.arange(8, dtype=np.int32)
    tp, jp = _pools(policy=policy)
    _publish_chain(tp, jp, toks, seed=3)
    before = tp.export_chain(toks)
    assert before["n_tokens"] == 8
    _same_records(before["blocks"], jp.export_chain(toks)["blocks"])
    for pool in (tp, jp):
        _evict_all_cached(pool)
    tier = tp.host_tier
    assert tier.demotions == 2 and len(tier) == 2
    assert tp.lookup(toks, max_tokens=8).shared_blocks == []
    # the demoted records: the same keys and bytes as JAX's
    assert list(tier._records) == list(jp.host_tier._records)
    _same_records(list(tier._records.values()),
                  list(jp.host_tier._records.values()))
    first = {k: {f: a.clone() for f, a in r.items() if f != "fill"}
             for k, r in tier._records.items()}
    covered, keys = tp.plan_promotion(toks)
    assert (covered, len(keys)) == (8, 2)
    assert tp.promote_chain(keys) == (2, 2)
    assert tier.promotions == 2 and tier.promoted_tokens == 8
    assert tp.lookup(toks, max_tokens=8).shared_blocks != []
    _same_records(before["blocks"], tp.export_chain(toks)["blocks"])
    # demote -> promote -> demote is a fixed point
    _evict_all_cached(tp)
    for key, snap in first.items():
        for f, arr in snap.items():
            assert torch.equal(tier._records[key][f], arr)


def test_plan_promotion_three_outcomes():
    toks = np.arange(8, dtype=np.int32)
    tp, _ = _pools(num_blocks=8)
    assert tp.plan_promotion(toks) == (0, [])                 # miss
    _publish_chain(tp, None, toks)
    assert tp.plan_promotion(toks) == (8, [])                 # device hit
    _evict_all_cached(tp)
    covered, keys = tp.plan_promotion(toks)
    assert covered == 8 and len(keys) == 2                    # host hit
    off, _ = _pools(num_blocks=8, tier=False)
    assert off.plan_promotion(toks) == (0, [])


def test_promote_respects_block_budget():
    toks = np.arange(16, dtype=np.int32)
    tp, _ = _pools(num_blocks=6)
    _publish_chain(tp, None, toks)
    _evict_all_cached(tp)
    _, keys = tp.plan_promotion(toks)
    assert len(keys) == 4
    assert tp.promote_chain(keys, max_blocks=1) == (1, 1)
    # a promoted key is on the device: consumed for free next time
    assert tp.promote_chain(keys, max_blocks=2) == (3, 2)
    assert tp.promote_chain(keys[3:], max_blocks=4) == (1, 1)
    assert tp.plan_promotion(toks)[1] == []


def test_vanished_host_record_truncates_chain():
    toks = np.arange(12, dtype=np.int32)
    tp, _ = _pools(num_blocks=6)
    _publish_chain(tp, None, toks)
    _evict_all_cached(tp)
    _, keys = tp.plan_promotion(toks)
    assert len(keys) == 3
    del tp.host_tier._records[keys[1]]
    tp.host_tier.bytes_used = sum(record_nbytes(r) for r in
                                  tp.host_tier._records.values())
    assert tp.promote_chain(keys) == (3, 1)   # only keys[0] landed
    assert tp.plan_promotion(toks) == (4, [])


def test_namespaced_chains_isolated_across_tiers():
    toks = np.arange(8, dtype=np.int32)
    tp, jp = _pools(num_blocks=4)
    for pool in (tp, jp):
        blocks = pool.acquire(2)
        pool.publish(toks, blocks, 8, namespace="tenant-a")
        pool.release(blocks)
        _evict_all_cached(pool)
    assert list(tp.host_tier._records) == list(jp.host_tier._records)
    assert len(tp.host_tier) == 2
    assert tp.plan_promotion(toks, namespace="tenant-b") == (0, [])
    assert tp.plan_promotion(toks) == (0, [])
    covered, keys = tp.plan_promotion(toks, namespace="tenant-a")
    assert covered == 8 and len(keys) == 2
    tp.promote_chain(keys)
    assert tp.lookup(toks, max_tokens=8,
                     namespace="tenant-b").shared_blocks == []
    assert tp.lookup(toks, max_tokens=8,
                     namespace="tenant-a").shared_blocks != []


def test_peek_counts_device_plus_host_extension():
    toks = np.arange(16, dtype=np.int32)
    tp, _ = _pools(num_blocks=6)
    _publish_chain(tp, None, toks)
    assert tp.peek_chain_tokens(toks) == 16
    _evict_all_cached(tp)
    assert tp.peek_chain_tokens(toks) == 16
    _, keys = tp.plan_promotion(toks)
    tp.promote_chain(keys, max_blocks=2)
    assert tp.peek_chain_tokens(toks) == 16         # 2 dev + 2 host
    assert tp.peek_chain_tokens(toks[:8]) == 8
    assert tp.peek_chain_tokens(np.arange(100, 108, dtype=np.int32)) == 0


# ---------------------------------------------------------------------
# the partial import
# ---------------------------------------------------------------------

def _chain(n_tokens):
    src = KVPool(n_layers=1, n_kv_heads=2, head_dim=4, block_size=4,
                 num_blocks=8, device="cpu")
    toks = np.arange(n_tokens, dtype=np.int32)
    blocks = src.acquire(src.blocks_for(n_tokens))
    for i, b in enumerate(blocks):
        src.k[:, b * 4:(b + 1) * 4] = i + 1
    src.publish(toks, blocks, n_tokens)
    src.release(blocks)
    return toks, src.export_chain(toks)


def _dst(num_blocks):
    return KVPool(n_layers=1, n_kv_heads=2, head_dim=4, block_size=4,
                  num_blocks=num_blocks, device="cpu")


@pytest.mark.parametrize("n,blocks,held,want", [
    (12, 4, 1, 8), (8, 4, 3, 0), (12, 8, 0, 12)],
    ids=["longest_prefix_that_fits", "zero_fit", "full_fit"])
def test_partial_import(n, blocks, held, want):
    toks, chain = _chain(n)
    dst = _dst(blocks)
    hold = dst.acquire(held) if held else []
    assert dst.import_chain(chain) == want
    if want:
        plan = dst.lookup(toks, max_tokens=n)
        assert len(plan.shared_blocks) * 4 == want
        back = dst.export_chain(toks[:want])
        for i, rec in enumerate(back["blocks"]):
            assert bool((rec["k"] == i + 1).all())
    if hold:
        dst.release(hold)


def test_import_refuses_another_geometry():
    _, chain = _chain(8)
    dst = KVPool(n_layers=1, n_kv_heads=2, head_dim=4, block_size=4,
                 num_blocks=8, policy="int8", device="cpu")
    with pytest.raises(ValueError, match="KV chain layout does not match"):
        dst.import_chain(chain)


# ---------------------------------------------------------------------
# the eviction heap against the exhaustive min() oracle
# ---------------------------------------------------------------------

@pytest.mark.parametrize("tiered", [False, True])
def test_eviction_order_matches_min_oracle(tiered):
    p = KVPool(n_layers=1, n_kv_heads=1, head_dim=2, block_size=2,
               num_blocks=10, device="cpu",
               host_tier=HostTier(byte_budget=1 << 20) if tiered else None)
    rng = np.random.default_rng(7)
    nxt = [0]

    def publish_one():
        blocks = p.acquire(1)
        toks = np.arange(nxt[0], nxt[0] + 2, dtype=np.int32)
        nxt[0] += 2
        p.publish(toks, blocks, 2)
        p.release(blocks)

    for _ in range(4):
        while p.num_free:
            publish_one()
        for _ in range(200):        # enough to force a heap compaction
            cached = sorted(p._cached_free)
            b = cached[rng.integers(len(cached))]
            p.acquire_cached([b])
            p.release([b])
        held = []
        while p._cached_free:
            expect = min(p._cached_free, key=p._lru.__getitem__)
            got = p.acquire(1)
            assert got == [expect]
            held.extend(got)
        p.release(held)
    if tiered:
        assert p.host_tier.demotions > 0


# ---------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------

def _workload(seed, n=4, prefix_len=12, total_len=20):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, CFG.vocab_size, prefix_len).astype(np.int32)
    return [np.concatenate([base, rng.integers(
        0, CFG.vocab_size, total_len - prefix_len).astype(np.int32)])
        for _ in range(n)]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("temp,topk", [(0.0, 0), (0.8, 5)],
                         ids=["greedy", "sampled"])
def test_tier_on_equals_off_equals_oracle(params, kv_dtype, temp, topk):
    """A pool small enough that every admission evicts (and demotes) the
    last chain; resubmitted prompts host-hit and promote. Every stream:
    tier-on == tier-off, == the dense oracle for the f32 pool, and
    (greedy) == JAX's tier-on engine's."""
    jp, tp = params
    kw = dict(num_blocks=10, kv_dtype=kv_dtype, temperature=temp,
              top_k=topk)
    on = _engine(tp, kv_tier_bytes=1 << 20, **kw)
    off = _engine(tp, **kw)
    prompts = _workload(30)
    seq = prompts + [prompts[0], prompts[2], prompts[0]]
    outs = []
    for i, prompt in enumerate(seq):
        got = _run_one(on, prompt, 6, seed=100 + i)
        np.testing.assert_array_equal(got, _run_one(off, prompt, 6,
                                                    seed=100 + i))
        if kv_dtype is None:
            np.testing.assert_array_equal(got, _oracle(
                tp, prompt, 6, seed=100 + i, temperature=temp, top_k=topk))
        outs.append(got)
    tier = on.kv_tier
    assert tier.demotions > 0 and tier.promotions > 0
    assert on._decode_blocked_demotions == 0
    assert on.metrics.summary()["host_hit_tokens"] > 0
    if temp == 0.0:
        jeng = JaxServeEngine(jax_gpt2_family(JCFG), jp, max_slots=2,
                              block_size=4, num_blocks=10, max_seq_len=40,
                              kv_dtype=kv_dtype, kv_tier_bytes=1 << 20)
        for prompt, got in zip(seq, outs):
            rid = jeng.submit(prompt, 6)
            while jeng.has_work:
                jeng.step()
            np.testing.assert_array_equal(got, np.asarray(
                jeng.result(rid)))
        assert jeng.kv_tier.promotions == tier.promotions
        assert jeng.kv_tier.demotions == tier.demotions


def _warm_three(eng, seed):
    """Three distinct 16-token prompts, each run alone: the first's chain
    ends up in the host tier."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, CFG.vocab_size, 16).astype(np.int32)
               for _ in range(3)]
    for prompt in prompts:
        _run_one(eng, prompt, 4)
    assert eng.kv_tier.demotions > 0
    return prompts, rng


def test_promotion_is_async_other_slots_keep_decoding(params):
    """A one-block promote budget parks the queue head PROMOTING for
    several steps, and the running slot emits a token on each of them."""
    tp = params[1]
    eng = _engine(tp, num_blocks=14, kv_tier_bytes=1 << 20,
                  kv_tier_promote_budget_bytes=1)
    prompts, rng = _warm_three(eng, 31)
    assert len(eng.pool.plan_promotion(prompts[0], max_tokens=15)[1]) >= 2
    long_tokens = []
    long_prompt = rng.integers(0, CFG.vocab_size, 6).astype(np.int32)
    rid_long = eng.submit(long_prompt, 16,
                          on_token=lambda r, t, last: long_tokens.append(t))
    eng.step()
    rid_a = eng.submit(prompts[0], 4)
    overlap = 0
    while eng.has_work:
        promoting = bool(eng._promoting)
        n0 = len(long_tokens)
        eng.step()
        overlap += promoting and len(long_tokens) > n0
    assert overlap >= 2
    assert eng.metrics.summary()["kv_promotions"] >= 2
    np.testing.assert_array_equal(eng.result(rid_a),
                                  _oracle(tp, prompts[0], 4))
    np.testing.assert_array_equal(eng.result(rid_long)[6:],
                                  np.asarray(long_tokens, np.int32))
    assert eng._decode_blocked_demotions == 0


def test_host_eviction_racing_promotion_degrades_to_prefill(params):
    tp = params[1]
    eng = _engine(tp, num_blocks=14, kv_tier_bytes=1 << 20,
                  kv_tier_promote_budget_bytes=1)
    prompts, rng = _warm_three(eng, 32)
    bg = rng.integers(0, CFG.vocab_size, 6).astype(np.int32)
    rid_bg = eng.submit(bg, 12)
    eng.step()
    rid_a = eng.submit(prompts[0], 4)
    for _ in range(50):
        if eng._promoting:
            break
        eng.step()
    assert eng._promoting
    eng.kv_tier._records.clear()          # the tier's budget races it
    eng.kv_tier.bytes_used = 0
    while eng.has_work:
        eng.step()
    assert not eng._promoting             # cut short, not wedged
    np.testing.assert_array_equal(eng.result(rid_a),
                                  _oracle(tp, prompts[0], 4))
    np.testing.assert_array_equal(eng.result(rid_bg), _oracle(tp, bg, 12))


@pytest.mark.parametrize("kw", [
    {"kv_tier_bytes": 1 << 20, "prefix_cache": False},
    {"kv_tier_bytes": -1}, {"kv_tier_promote_budget_bytes": 0,
                            "kv_tier_bytes": 1 << 20}],
    ids=["without_prefix_cache", "negative", "zero_budget"])
def test_constructor_checks_match_jax(params, kw):
    jp, tp = params
    with pytest.raises(ValueError) as t:
        _engine(tp, **kw)
    with pytest.raises(ValueError) as j:
        JaxServeEngine(jax_gpt2_family(JCFG), jp, max_slots=2,
                       block_size=4, num_blocks=10, max_seq_len=40, **kw)
    assert str(t.value) == str(j.value)


def test_limits_report_tier(params):
    assert _engine(params[1], kv_tier_bytes=1 << 20).limits()["kv_tier"]
    assert _engine(params[1]).limits()["kv_tier"] is False


# ---------------------------------------------------------------------
# the process fleet: peer lookup ships a warm chain instead of a
# re-prefill
# ---------------------------------------------------------------------

def test_fleet_peer_lookup_beats_reprefill(rng):
    """2 process replicas, round robin: the first request warms p0; the
    same prompt then dispatches to p1, whose peer lookup probes the fleet
    (``kv_peek``), finds p0's chain and ships it over ``kv_export`` /
    ``kv_import`` before the submit lands — token for token the oracle
    at each seed (the children's weights: the builder's seeded init)."""
    import os

    from _torch_proc_factories import tiny_params

    from quintnet_tpu_torch.fleet import ProcessFleet

    factory = os.path.join(os.path.dirname(__file__),
                           "_torch_proc_factories.py")
    spec = {"file": factory, "func": "build_tiny_gpt2",
            "kwargs": {"temperature": 0.8, "top_k": 5, "max_seq_len": 40,
                       "num_blocks": 24, "kv_tier_bytes": 1 << 20}}
    tp = tiny_params(CFG)
    fleet = ProcessFleet(spec, n_replicas=2, policy="round_robin",
                         device="cpu", spawn_timeout_s=240.0)
    try:
        prompt = rng.integers(0, CFG.vocab_size, (12,)).astype(np.int32)
        out1 = fleet.generate([prompt], max_new_tokens=6, seeds=[11],
                              timeout=300)[0]
        probes0 = fleet.metrics.tier_probes
        out2 = fleet.generate([prompt], max_new_tokens=6, seeds=[22],
                              timeout=300)[0]
        assert fleet.metrics.tier_probes > probes0
        assert fleet.metrics.tier_peer_transfers >= 1
        for out, seed in ((out1, 11), (out2, 22)):
            np.testing.assert_array_equal(out, _oracle(
                tp, prompt, 6, seed=seed, temperature=0.8, top_k=5))
        s = fleet.summary()
        assert s["tier_peer_transfers"] >= 1
        assert s["tier_peer_fallbacks"] == 0
        assert s["engines"]["p1"]["prefix_hit_tokens"] > 0
    finally:
        fleet.close()
