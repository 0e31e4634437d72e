"""The port's multi-tenant LoRA serving (quintnet_tpu_torch/serve/
adapters.py and the engine's per-slot packed factors) against the JAX
package: the cases of ``tests/test_adapters.py``.

The tenants are JAX's ``lora_init`` adapters (moved off their zero ``b``)
saved by JAX's ``save_lora``: the port's registry loads JAX's files.

- the registry: load, evict, reload, pins, the byte-budget LRU,
  in-memory entries, its validations with JAX's messages;
- the engine's validations at submit, with JAX's messages (and the pin
  rolled back);
- a heterogeneous batch (two tenants of rank 4 and 8 and base-model
  slots, staggered): greedy streams equal JAX's engine's token for
  token and each equals a dedicated engine serving that tenant's
  ``lora_merge_tree`` weights; sampled streams equal the dedicated
  engines' at the same seeds; with the prefix cache (namespaced),
  under preemption, with speculation and for Llama;
- the decode rank bucket follows the bound adapters, every decode call
  runs at one bucket, and every pin is released at retire.

On the CPU every comparison is exact. JAX's compile-count cases
(``test_zero_recompiles_as_adapters_join_and_leave``, ``test_adapter_
blind_engine_surface_unchanged``) have no eager-PyTorch meaning; the
trace of the first (a tenant registered and another evicted mid-session)
runs here with each decode call's bucket checked instead. The tp2 case
runs in ``tests/test_torch_serve_mesh.py``'s world; the fleet cases wait
for the fleet.
"""

import jax
import numpy as np
import pytest
import torch

from quintnet_tpu.models import lora as jlora
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quintnet_tpu.models.llama import llama_init as jax_llama_init
from quintnet_tpu.serve import AdapterRegistry as JaxAdapterRegistry
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu.serve import llama_family as jax_llama_family
from quintnet_tpu_torch.analysis.specs import lora_rank_buckets
from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                       llama_params_from_numpy,
                                       lora_params_from_numpy)
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.models.llama import LlamaConfig
from quintnet_tpu_torch.models.lora import (LLAMA_TARGETS, LoRAConfig,
                                            lora_merge_tree)
from quintnet_tpu_torch.serve import (AdapterRegistry, KVPool, ServeEngine,
                                      SpecConfig, generate, gpt2_family,
                                      llama_family)

torch.set_num_threads(1)

JCFG = JaxGPT2Config.tiny(n_layer=2, n_positions=128)
CFG = GPT2Config.tiny(n_layer=2, n_positions=128)
ENGINE = {"max_slots": 4, "block_size": 8, "num_blocks": 32,
          "max_seq_len": 64}


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _jax_adapter(blocks, seed, rank, targets=None):
    """JAX's adapter, its b moved off zero, and its config."""
    kw = {"targets": tuple(targets)} if targets else {}
    cfg = jlora.LoRAConfig(rank=rank, alpha=2.0 * rank, **kw)
    lo = jlora.lora_init(jax.random.key(seed), blocks, cfg)
    lo = jax.tree.map(lambda leaf: leaf + 0.02 * jax.random.normal(
        jax.random.key(seed + 100), leaf.shape), lo)
    return lo, cfg


def _port_cfg(jcfg):
    return LoRAConfig(rank=jcfg.rank, alpha=jcfg.alpha,
                      targets=tuple(jcfg.targets))


@pytest.fixture(scope="module")
def tenants(params, tmp_path_factory):
    """Two tenants of ranks 4 and 8, saved by JAX's ``save_lora``:
    id -> (port tree, port cfg, path)."""
    root = tmp_path_factory.mktemp("adapters")
    out = {}
    for aid, seed, rank in (("tenant-a", 1, 4), ("tenant-b", 2, 8)):
        lo, cfg = _jax_adapter(params[0]["blocks"], seed, rank)
        path = str(root / f"{aid}.safetensors")
        jlora.save_lora(lo, cfg, path)
        out[aid] = (lora_params_from_numpy(jax.tree.map(np.asarray, lo),
                                           "cpu"), _port_cfg(cfg), path)
    return out


def _registry(tenants, cls=AdapterRegistry):
    reg = cls()
    for aid, (_t, _c, path) in tenants.items():
        reg.register(aid, path)
    return reg


def _engine(tp, adapters=None, family=None, **kw):
    return ServeEngine(family or gpt2_family(CFG), tp, device="cpu",
                       adapters=adapters, **{**ENGINE, **kw})


def _dedicated(tp, tenants, aid, prompt, max_new, seed, **kw):
    """A dedicated engine serving the tenant's merged weights (the base
    for None): the reference of every stream."""
    merged = (tp if aid is None else
              lora_merge_tree(tp, tenants[aid][0], tenants[aid][1]))
    eng = _engine(merged, **{**kw, "max_slots": 1})
    return generate(eng, [prompt], max_new_tokens=max_new, seeds=[seed])[0]


def _prompts(seed, lens, vocab=None):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab or CFG.vocab_size, n).astype(np.int32)
            for n in lens]


class _Buckets:
    """Records the rank width of every decode call's packed factors."""

    def __init__(self, eng):
        self.widths = []
        call = eng._call

        def spy(fn, *args, kv_kw, lora_kw=None):
            if fn is eng.family.decode and lora_kw is not None:
                lora = lora_kw["lora"]
                self.widths.append({n["a"].shape[-1] for part in lora.values()
                                    for n in part.values()})
            return call(fn, *args, kv_kw=kv_kw, lora_kw=lora_kw)

        eng._call = spy


# ---------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------

def test_register_load_evict_reload(tenants):
    reg = _registry(tenants)
    assert reg.adapter_ids == ["tenant-a", "tenant-b"]
    reg.evict("tenant-a")
    assert not reg.is_resident("tenant-a") and reg.is_registered("tenant-a")
    entry = reg.acquire("tenant-a")              # reloads from its file
    assert entry.resident and entry.loads == 2
    for path, node in (("attn", "qkv"), ("mlp", "fc")):
        assert torch.equal(entry.tree[path][node]["a"],
                           tenants["tenant-a"][0][path][node]["a"])
    reg.release("tenant-a")
    assert entry.cfg == tenants["tenant-a"][1]


def test_pinned_adapter_cannot_evict(tenants):
    reg = _registry(tenants)
    reg.acquire("tenant-a")
    with pytest.raises(ValueError, match="pinned"):
        reg.evict("tenant-a")
    with pytest.raises(ValueError, match="pinned"):
        reg.unregister("tenant-a")
    reg.release("tenant-a")
    reg.evict("tenant-a")


def test_byte_budget_lru_eviction(tenants):
    path_a, path_b = tenants["tenant-a"][2], tenants["tenant-b"][2]
    one = AdapterRegistry().register("x", path_a).nbytes
    assert one == JaxAdapterRegistry().register("x", path_a).nbytes
    t = [0.0]
    reg = AdapterRegistry(byte_budget=int(one * 3.2), clock=lambda: t[0])
    for i, p in enumerate([path_a, path_b, path_a]):
        t[0] = float(i)
        reg.register(f"t{i}", p)
    assert not reg.is_resident("t0")
    assert reg.is_resident("t1") and reg.is_resident("t2")
    assert reg.evictions == 1
    t[0] = 3.0
    reg.ensure_resident("t1")
    t[0] = 4.0
    reg.acquire("t0")
    assert not reg.is_resident("t2")
    t[0] = 5.0
    reg.acquire("t1")
    reg.acquire("t2")                  # a pinned set may exceed the budget
    assert reg.bytes_resident > reg.byte_budget
    assert reg.stats()["pinned"] == 3


def test_in_memory_entries_never_lru_evicted(tenants):
    reg = AdapterRegistry(byte_budget=1)
    reg.register("mem", tree=tenants["tenant-a"][0],
                 cfg=tenants["tenant-a"][1])
    reg.register("f1", tenants["tenant-a"][2])
    reg.register("f2", tenants["tenant-b"][2])
    assert reg.is_resident("mem") and not reg.is_resident("f1")
    assert reg.is_resident("f2")
    with pytest.raises(ValueError, match="in-memory"):
        reg.evict("mem")


REGISTRY_ERRORS = {
    "already_registered": lambda reg, t: reg.register(
        "tenant-a", t["tenant-a"][2]),
    "invalid_id": lambda reg, t: reg.register("", t["tenant-a"][2]),
    "no_source": lambda reg, t: reg.register("x"),
    "both_sources": lambda reg, t: reg.register(
        "x", t["tenant-a"][2], tree={}, cfg=None),
    "unknown_id": lambda reg, t: reg.acquire("nope"),
    "released_more": lambda reg, t: reg.release("tenant-a"),
}


@pytest.mark.parametrize("case", sorted(REGISTRY_ERRORS))
def test_registry_errors_match_jax(tenants, case):
    fn = REGISTRY_ERRORS[case]
    with pytest.raises((ValueError, KeyError)) as t:
        fn(_registry(tenants), tenants)
    with pytest.raises((ValueError, KeyError)) as j:
        fn(_registry(tenants, JaxAdapterRegistry), tenants)
    assert type(t.value) is type(j.value)
    assert str(t.value) == str(j.value)


def test_changed_on_disk_reload_rejected(params, tmp_path):
    lo, cfg = _jax_adapter(params[0]["blocks"], 21, 4)
    path = str(tmp_path / "mut.safetensors")
    jlora.save_lora(lo, cfg, path)
    reg = AdapterRegistry()
    reg.register("mut", path)
    reg.evict("mut")
    jlora.save_lora(lo, jlora.LoRAConfig(rank=4, alpha=32.0), path)
    with pytest.raises(ValueError, match="changed on disk"):
        reg.ensure_resident("mut")


# ---------------------------------------------------------------------
# the engine's validations, JAX's messages
# ---------------------------------------------------------------------

def _huge(params):
    lo, cfg = _jax_adapter(params[0]["blocks"], 11, 16)
    return lora_params_from_numpy(jax.tree.map(np.asarray, lo), "cpu"), lo, cfg


def _wrong_dims():
    other = jax_gpt2_init(jax.random.key(9),
                          JaxGPT2Config.tiny(n_layer=2, n_embd=48, n_head=2))
    lo, cfg = _jax_adapter(other["blocks"], 12, 4)
    return lora_params_from_numpy(jax.tree.map(np.asarray, lo), "cpu"), lo, cfg


SUBMIT_ERRORS = {
    "adapter_blind_engine": ({"adapters": None}, "tenant-a", None),
    "unknown_adapter": ({}, "ghost", None),
    "over_rank": ({}, "huge", _huge),
    "unserved_target": ({"lora_targets": ("qkv", "proj")}, "tenant-a",
                        None),
    "shape_mismatch": ({}, "wrong", lambda p: _wrong_dims()),
}


@pytest.mark.parametrize("case", sorted(SUBMIT_ERRORS))
def test_submit_errors_match_jax_and_roll_back_the_pin(params, tenants,
                                                       case):
    kw, aid, extra = SUBMIT_ERRORS[case]
    reg, jreg = _registry(tenants), _registry(tenants, JaxAdapterRegistry)
    if extra is not None:
        tree, jtree, jcfg = extra(params)
        reg.register(aid, tree=tree, cfg=_port_cfg(jcfg))
        jreg.register(aid, tree=jtree, cfg=jcfg)
    adapters = kw.pop("adapters", reg)
    eng = _engine(params[1], adapters=adapters, **kw)
    jeng = JaxServeEngine(jax_gpt2_family(JCFG), params[0],
                          adapters=None if adapters is None else jreg,
                          **ENGINE, **kw)
    errs = []
    for e in (eng, jeng):
        with pytest.raises((ValueError, KeyError)) as ex:
            e.submit(np.zeros((4,), np.int32), 2, adapter_id=aid)
        errs.append(ex.value)
    assert type(errs[0]) is type(errs[1]) and str(errs[0]) == str(errs[1])
    if reg.is_registered(aid):
        assert reg.entry(aid).refs == 0
    if case == "shape_mismatch":       # only that request failed
        rid = eng.submit(np.zeros((4,), np.int32), 2, adapter_id="tenant-a")
        eng.run(max_steps=50)
        assert eng.result(rid).shape == (6,)


@pytest.mark.parametrize("kw", [
    {"lora_targets": ("nope",)}, {"lora_rank_bucket_sizes": (0, 8)}],
    ids=["no_targets_found", "bad_rank_buckets"])
def test_constructor_errors_match_jax(params, tenants, kw):
    with pytest.raises(ValueError) as t:
        _engine(params[1], adapters=_registry(tenants), **kw)
    with pytest.raises(ValueError) as j:
        JaxServeEngine(jax_gpt2_family(JCFG), params[0],
                       adapters=_registry(tenants, JaxAdapterRegistry),
                       **ENGINE, **kw)
    assert str(t.value) == str(j.value)


# ---------------------------------------------------------------------
# parity: JAX's engine and the dedicated merged engines
# ---------------------------------------------------------------------

HETERO_AIDS = ["tenant-a", "tenant-b", None, "tenant-a"]


def _hetero(eng, prompts, seeds, arrivals, max_new):
    rids, done, step = {}, 0, 0
    while done < len(prompts) or eng.has_work:
        while done < len(prompts) and arrivals[done] <= step:
            kw = {} if seeds is None else {"seed": seeds[done]}
            rids[done] = eng.submit(prompts[done], max_new,
                                    adapter_id=HETERO_AIDS[done], **kw)
            done += 1
        eng.step()
        step += 1
        assert step < 500
    return [eng.result(rids[i]) for i in range(len(prompts))]


def test_heterogeneous_batch_greedy_equals_jax_and_dedicated(params,
                                                             tenants):
    reg = _registry(tenants)
    eng = _engine(params[1], adapters=reg)
    buckets = _Buckets(eng)
    prompts = _prompts(0, (5, 7, 6, 4))
    seeds = [10, 11, 12, 13]
    outs = _hetero(eng, prompts, seeds, [0, 0, 1, 3], 8)
    assert eng.metrics.peak_running >= 3
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, _dedicated(
            params[1], tenants, HETERO_AIDS[i], prompts[i], 8, seeds[i]))
    jeng = JaxServeEngine(jax_gpt2_family(JCFG), params[0],
                          adapters=_registry(tenants, JaxAdapterRegistry),
                          attn_kernel="xla", **ENGINE)
    for got, want in zip(outs, _hetero(jeng, prompts, None, [0, 0, 1, 3],
                                       8)):
        np.testing.assert_array_equal(got, np.asarray(want))
    per = eng.metrics.summary()["adapters"]
    jper = jeng.metrics.summary()["adapters"]
    for aid in ("tenant-a", "tenant-b"):
        for key in ("requests", "gen_tokens"):
            assert per[aid][key] == jper[aid][key]
    assert per["tenant-a"]["requests"] == 2
    assert per["tenant-b"]["gen_tokens"] == 8
    assert all(reg.entry(a).refs == 0 for a in reg.adapter_ids)
    # each decode call ran at one bucket of the ladder, rank 8 while
    # tenant-b was bound
    assert all(len(w) == 1 for w in buckets.widths)
    assert {w.pop() for w in buckets.widths} <= set(eng.lora_rank_buckets)


def test_heterogeneous_batch_sampled_equals_dedicated(params, tenants):
    kw = {"temperature": 0.8, "top_k": 20}
    eng = _engine(params[1], adapters=_registry(tenants), **kw)
    prompts = _prompts(1, (5, 7, 6))
    seeds = [20, 21, 22]
    rids = [eng.submit(p, 8, seed=s, adapter_id=a)
            for p, s, a in zip(prompts, seeds, HETERO_AIDS)]
    eng.run(max_steps=200)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(eng.result(rid), _dedicated(
            params[1], tenants, HETERO_AIDS[i], prompts[i], 8, seeds[i],
            **kw))


def test_prefix_cache_is_namespaced_and_parity_holds(params, tenants):
    eng = _engine(params[1], adapters=_registry(tenants))
    shared = _prompts(2, (16,))[0]
    aids = ["tenant-a", "tenant-b", None]
    w1 = [eng.submit(shared, 6, seed=30 + i, adapter_id=a)
          for i, a in enumerate(aids)]
    eng.run(max_steps=200)
    hits = eng.metrics.prefix_hit_tokens
    w2 = [eng.submit(shared, 6, seed=33 + i, adapter_id=a)
          for i, a in enumerate(aids)]
    eng.run(max_steps=200)
    assert eng.metrics.prefix_hit_tokens > hits
    for i, aid in enumerate(aids):
        for rid, seed in ((w1[i], 30 + i), (w2[i], 33 + i)):
            np.testing.assert_array_equal(eng.result(rid), _dedicated(
                params[1], tenants, aid, shared, 6, seed))


def test_pool_prefix_index_is_namespaced():
    pool = KVPool(n_layers=1, n_kv_heads=1, head_dim=4, block_size=4,
                  num_blocks=8, device="cpu")
    toks = np.arange(8, dtype=np.int32)
    blocks = pool.acquire(2)
    pool.publish(toks, blocks, 8, namespace="tenant-a")
    hit = pool.lookup(toks, namespace="tenant-a")
    assert hit.cached_tokens == 8 and hit.shared_blocks == blocks
    assert pool.lookup(toks, namespace="tenant-b").cached_tokens == 0
    assert pool.lookup(toks).cached_tokens == 0
    base = pool.acquire(2)
    pool.publish(toks, base, 8)
    assert pool.lookup(toks).shared_blocks == base
    assert pool.lookup(toks, namespace="tenant-a").shared_blocks == blocks
    # 'abc' + NUL are the bytes of token 0x00636261: the base key's own
    # NUL keeps a base prompt opening with it from aliasing 'abc'
    abc = KVPool(n_layers=1, n_kv_heads=1, head_dim=4, block_size=1,
                 num_blocks=8, device="cpu")
    blk = abc.acquire(1)
    abc.publish(np.asarray([7], np.int32), blk, 1, namespace="abc")
    assert abc.lookup(np.asarray([0x00636261, 7], np.int32)
                      ).cached_tokens == 0


def test_parity_under_preemption(params, tenants):
    small = {"max_slots": 3, "block_size": 4, "num_blocks": 14,
             "max_seq_len": 40}
    eng = _engine(params[1], adapters=_registry(tenants), **small)
    prompts = _prompts(3, (8, 9, 7))
    aids = ["tenant-a", "tenant-b", "tenant-a"]
    rids = [eng.submit(p, 12, seed=40 + i, adapter_id=a)
            for i, (p, a) in enumerate(zip(prompts, aids))]
    eng.run(max_steps=500)
    assert eng.metrics.preempted > 0
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(eng.result(rid), _dedicated(
            params[1], tenants, aids[i], prompts[i], 12, 40 + i, **small))


def test_parity_with_speculation(params, tenants):
    eng = _engine(params[1], adapters=_registry(tenants), max_slots=3,
                  max_seq_len=96, spec=SpecConfig())
    pat = _prompts(4, (4,))[0]
    rp = np.tile(pat, 5)[:18]
    rid_a = eng.submit(rp, 30, seed=50, adapter_id="tenant-a")
    rid_b = eng.submit(rp[:10], 10, seed=51, adapter_id="tenant-b")
    eng.run(max_steps=300)
    assert eng.metrics.spec_steps > 0
    np.testing.assert_array_equal(eng.result(rid_a), _dedicated(
        params[1], tenants, "tenant-a", rp, 30, 50, max_seq_len=96))
    np.testing.assert_array_equal(eng.result(rid_b), _dedicated(
        params[1], tenants, "tenant-b", rp[:10], 10, 51, max_seq_len=96))


def test_llama_parity_with_jax_and_dedicated():
    jcfg, cfg = JaxLlamaConfig.tiny(), LlamaConfig.tiny()
    jp = jax_llama_init(jax.random.key(0), jcfg)
    tp = llama_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jlo, jlcfg = _jax_adapter(jp["blocks"], 5, 4, targets=LLAMA_TARGETS)
    lo = lora_params_from_numpy(jax.tree.map(np.asarray, jlo), "cpu")
    reg = AdapterRegistry()
    reg.register("t", tree=lo, cfg=_port_cfg(jlcfg))
    kw = {"max_slots": 2, "block_size": 8, "num_blocks": 32,
          "max_seq_len": 64}
    eng = ServeEngine(llama_family(cfg), tp, device="cpu", adapters=reg,
                      **kw)
    p = _prompts(5, (6,), cfg.vocab_size)[0]
    rid = eng.submit(p, 8, seed=42, adapter_id="t")
    rid_base = eng.submit(p, 8, seed=42)
    eng.run(max_steps=100)
    merged = lora_merge_tree(tp, lo, _port_cfg(jlcfg))
    for ref_params, r in ((merged, rid), (tp, rid_base)):
        ded = ServeEngine(llama_family(cfg), ref_params, device="cpu",
                          **{**kw, "max_slots": 1})
        np.testing.assert_array_equal(eng.result(r), generate(
            ded, [p], max_new_tokens=8, seeds=[42])[0])
    jreg = JaxAdapterRegistry()
    jreg.register("t", tree=jlo, cfg=jlcfg)
    jeng = JaxServeEngine(jax_llama_family(jcfg), jp, adapters=jreg,
                          attn_kernel="xla", **kw)
    jrid = jeng.submit(p, 8, adapter_id="t")
    jeng.run(max_steps=100)
    np.testing.assert_array_equal(eng.result(rid),
                                  np.asarray(jeng.result(jrid)))


# ---------------------------------------------------------------------
# rank buckets, adapters joining and leaving
# ---------------------------------------------------------------------

def test_rank_bucket_selection(params, tenants):
    eng = _engine(params[1], adapters=_registry(tenants))
    assert eng.lora_rank_buckets == lora_rank_buckets(8) == (4, 8)
    assert eng._decode_rank_bucket() == 4
    rid = eng.submit(np.zeros((4,), np.int32), 4, adapter_id="tenant-a")
    eng.step()
    assert eng._decode_rank_bucket() == 4
    rid_b = eng.submit(np.zeros((5,), np.int32), 4, adapter_id="tenant-b")
    eng.step()
    assert eng._decode_rank_bucket() == 8
    eng.run(max_steps=100)
    assert eng._decode_rank_bucket() == 4
    assert {eng.request(r).state for r in (rid, rid_b)} == {"finished"}


def test_adapters_join_and_leave_mid_session(params, tenants, tmp_path):
    """A tenant registered and another evicted mid-session: every
    request finishes, each decode call at one bucket, and the rank-2
    tenant rides the floor bucket."""
    reg = _registry(tenants)
    eng = _engine(params[1], adapters=reg)
    eng.warmup()
    buckets = _Buckets(eng)
    rng = np.random.default_rng(7)
    rids = [eng.submit(rng.integers(0, CFG.vocab_size, n).astype(np.int32),
                       6, adapter_id=a)
            for a, n in (("tenant-a", 9), (None, 6), ("tenant-b", 7))]
    eng.run(max_steps=200)
    lo, cfg = _jax_adapter(params[0]["blocks"], 30, 2)
    path = str(tmp_path / "c.safetensors")
    jlora.save_lora(lo, cfg, path)
    reg.register("tenant-c", path)
    rids.append(eng.submit(rng.integers(0, CFG.vocab_size, 5).astype(
        np.int32), 6, adapter_id="tenant-c"))
    reg.evict("tenant-a")
    rids.append(eng.submit(rng.integers(0, CFG.vocab_size, 4).astype(
        np.int32), 6, adapter_id="tenant-a"))
    eng.run(max_steps=200)
    assert all(eng.request(r).state == "finished" for r in rids)
    assert all(len(w) == 1 for w in buckets.widths)
    assert reg.entry("tenant-a").loads == 2
    assert all(reg.entry(a).refs == 0 for a in reg.adapter_ids)


@pytest.mark.parametrize("option", ["sp", "ep"])
def test_adapters_refused_with_sp_and_ep(params, tenants, option):
    """JAX's refusals, type and message, on a rank-0 view of the mesh."""
    from quintnet_tpu_torch.core.mesh import Mesh, MeshSpec
    from quintnet_tpu_torch.models.gpt2 import GPT2Config as TCfg

    if option == "sp":
        cfg, fam_kw = CFG, {"sp_axis": "sp"}
        tp = params[1]
    else:
        cfg, fam_kw = TCfg.tiny(n_layer=2, n_experts=4, expert_top_k=2), {
            "ep_axis": "ep"}
        from quintnet_tpu_torch.models.gpt2 import gpt2_init
        tp = gpt2_init(torch.Generator().manual_seed(0), cfg)
    mesh = Mesh(MeshSpec.create(**{option: 2}), 0, {})
    with pytest.raises(NotImplementedError, match="multi-tenant adapters"):
        ServeEngine(gpt2_family(cfg), tp, device="cpu", mesh=mesh,
                    adapters=_registry(tenants), **ENGINE, **fam_kw)
