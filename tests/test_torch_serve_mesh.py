"""The port's serving meshes (``ServeEngine(mesh=, tp_axis=, sp_axis=,
ep_axis=)``) against the JAX package.

THE contracts, JAX's (``tests/test_serve.py:599``, ``tests/test_longctx.
py:414-493``, ``tests/test_serve_moe.py:133-282``): an engine on every
rank of a mesh serves the streams one device serves. tp shards the
params and the pool's heads (one sum over tp per attention and MLP); sp
splits every prefill bucket over the ranks and runs the ring over the
paged pool (``nn/attention.ring_paged_prefill``), chunked prefill too;
ep shards a MoE family's experts (ep x tp too); an axis of size 1 runs
the plain single-device code; the constructor refuses what JAX refuses,
with JAX's type and message.

Here on the CPU every mesh engine runs on each rank of ONE 4-rank gloo
world (``tests/_torch_serve_cases.py``; a 2-wide mesh beside a dp axis
the engine does not read), on JAX's weights (bridged): each rank's greedy
streams equal JAX's engine on the same mesh (8 virtual CPU devices,
``shard_map``) token for token, and its sampled streams the port's own
one-device engine (JAX draws from ``jax.random`` keys). The routing
summaries of ep2 and ep2 x tp2 equal JAX's. Since the host tier, packed
weights and adapters were ported, tp2 also serves int8 weights (each
``w_scale`` cut like its weight's out dim; greedy equal to JAX's tp2
int8 engine) and fake_quant weights (the f32 streams bit for bit), and
two LoRA tenants beside a base request (``a`` cut on its in dim, ``b``
on its out dim, GPT-2's qkv ``b`` re-blocked; equal to JAX's tp2 engine
and to dedicated one-device engines on the merged weights).
``ring_paged_prefill``'s
output slice and pools on each rank equal JAX's inside ``shard_map``
over sp = 2 within 1e-5 (f32 and int8 pools, a chunk at a nonzero
offset), the pools' unchanged blocks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from _torch_dist import run_world
from _torch_serve_cases import run_engine_job, serve_mesh_case
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2 import gpt2_to_tp_layout as jax_tp_layout
from quintnet_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quintnet_tpu.models.llama import llama_init as jax_llama_init
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu.serve import llama_family as jax_llama_family
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.core.mesh import Mesh, MeshSpec, mesh_from_sizes
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

torch.set_num_threads(1)

GPT2_KW = {"n_layer": 2, "n_positions": 256}
MOE_KW = {"n_layer": 2, "n_experts": 4, "expert_top_k": 2}
LLAMA_KW = {"n_layers": 2, "n_positions": 256}
SAMPLED = {"temperature": 0.8, "top_k": 5}
BASE = {"max_slots": 4, "block_size": 4, "num_blocks": 80,
        "max_seq_len": 200}
MOE_BASE = {"max_slots": 3, "block_size": 4, "num_blocks": 36,
            "max_seq_len": 48}
# the ring case: 4 kv heads of 8 on 2 blocks of history + a 16-token
# chunk (12 true) at offset 8
RING = {"H": 4, "Hkv": 2, "Dh": 8, "bs": 4, "start": 8, "t0": 20, "P": 16,
        "blocks": 12, "M": 8}


def _prompts(seed, lengths, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


def _wave(seed, lengths, max_new=6, seed0=50):
    return [(p, max_new, seed0 + i)
            for i, p in enumerate(_prompts(seed, lengths))]


SHORT = _wave(0, (5, 9, 3))
# two tenants of ranks 4 and 8 and a base-model request (tp2_lora)
LORA_WAVE = [(p, m, sd, aid) for (p, m, sd), aid in zip(
    _wave(4, (6, 5, 7), max_new=8, seed0=70),
    ("tenant-a", "tenant-b", None))]
LONG = _wave(1, (40,)) + _wave(2, (150,), seed0=60)
PREFIX = _prompts(3, (9, 4))
PREFIX_WAVES = [[(PREFIX[0], 4, 1)], [(PREFIX[0] + PREFIX[1], 4, 2)]]

# name -> the job every rank runs: its mesh, model, engine options and
# the request waves (each drained before the next is submitted)
JOBS = {
    "tp2": ("gpt2", {"dp": 2, "tp": 2}, BASE, [SHORT]),
    "tp2_sampled": ("gpt2", {"dp": 2, "tp": 2}, {**BASE, **SAMPLED},
                    [SHORT]),
    "tp2_int8": ("gpt2", {"dp": 2, "tp": 2}, {**BASE, "kv_dtype": "int8"},
                 [SHORT]),
    "tp2_fake_quant": ("gpt2", {"dp": 2, "tp": 2},
                       {**BASE, "kv_dtype": "fake_quant"}, [SHORT]),
    "tp2_wq_fake_quant": ("gpt2", {"dp": 2, "tp": 2},
                          {**BASE, "weights_dtype": "fake_quant"}, [SHORT]),
    "tp2_wq_int8": ("gpt2", {"dp": 2, "tp": 2},
                    {**BASE, "weights_dtype": "int8"}, [SHORT]),
    "tp2_lora": ("gpt2", {"dp": 2, "tp": 2}, BASE, [LORA_WAVE]),
    "tp2_prefix": ("gpt2", {"dp": 2, "tp": 2}, BASE, PREFIX_WAVES),
    "tp2_llama": ("llama", {"dp": 2, "tp": 2}, BASE, [SHORT]),
    "tp2_llama_int8": ("llama", {"dp": 2, "tp": 2},
                       {**BASE, "kv_dtype": "int8"}, [SHORT]),
    "sp2": ("gpt2", {"dp": 2, "sp": 2}, {**BASE, "sp_axis": "sp"},
            [SHORT + LONG[:1]]),
    "sp2_sampled": ("gpt2", {"dp": 2, "sp": 2},
                    {**BASE, **SAMPLED, "sp_axis": "sp"}, [SHORT]),
    "sp2_chunked": ("gpt2", {"dp": 2, "sp": 2},
                    {**BASE, "sp_axis": "sp", "prefill_len": 32,
                     "chunked_prefill": True, "prefill_chunk_budget": 32},
                    [LONG[1:]]),
    "sp4": ("gpt2", {"sp": 4}, {**BASE, "sp_axis": "sp"}, [LONG[:1]]),
    "sp2_llama": ("llama", {"dp": 2, "sp": 2}, {**BASE, "sp_axis": "sp"},
                  [LONG[:1]]),
    "sp2_llama_int8": ("llama", {"dp": 2, "sp": 2},
                       {**BASE, "sp_axis": "sp", "kv_dtype": "int8",
                        "prefill_len": 32, "chunked_prefill": True},
                       [LONG[1:]]),
    "ep2": ("gpt2_moe", {"dp": 2, "ep": 2}, {**MOE_BASE, "ep_axis": "ep"},
            [SHORT]),
    "ep2_sampled": ("gpt2_moe", {"dp": 2, "ep": 2},
                    {**MOE_BASE, **SAMPLED, "ep_axis": "ep",
                     "kv_dtype": "int8"}, [SHORT]),
    "ep2_prefix": ("gpt2_moe", {"dp": 2, "ep": 2},
                   {**MOE_BASE, "ep_axis": "ep"}, PREFIX_WAVES),
    "ep2tp2": ("gpt2_moe", {"ep": 2, "tp": 2},
               {**MOE_BASE, "ep_axis": "ep"}, [SHORT]),
}
KW = {"gpt2": GPT2_KW, "gpt2_moe": MOE_KW, "llama": LLAMA_KW}
# the mesh runs held to JAX's engine on the same mesh (greedy)
JAX_HELD = ("tp2", "tp2_llama", "sp2", "sp2_chunked", "sp4", "sp2_llama",
            "ep2", "ep2tp2", "tp2_wq_int8", "tp2_lora")
# tp2_lora's tenants: JAX's lora_init, moved off their zero b
TENANTS = {"tenant-a": (1, 4), "tenant-b": (2, 8)}


def _tenants():
    """id -> (JAX's numpy LoRA tree, rank, alpha) on GPT-2's blocks."""
    from quintnet_tpu.models import lora as jlora

    blocks = _jax_init("gpt2")["blocks"]
    out = {}
    for aid, (seed, rank) in TENANTS.items():
        lo = jlora.lora_init(jax.random.key(seed), blocks,
                             jlora.LoRAConfig(rank=rank, alpha=2.0 * rank))
        lo = jax.tree.map(lambda leaf: leaf + 0.02 * jax.random.normal(
            jax.random.key(seed + 100), leaf.shape), lo)
        out[aid] = (jax.tree.map(np.asarray, lo), rank, 2.0 * rank)
    return out


def _job(name):
    model, mesh, engine, waves = JOBS[name]
    job = {"family": "llama" if model == "llama" else "gpt2",
           "cfg_kw": KW[model], "params": model, "mesh": mesh,
           "engine": engine, "waves": waves}
    if name == "tp2_lora":
        job["adapters"] = _tenants()
    return job


def _jax_init(model):
    if model == "llama":
        return jax_llama_init(jax.random.key(1), JaxLlamaConfig.tiny(
            **LLAMA_KW))
    return jax_gpt2_init(jax.random.key(0), JaxGPT2Config.tiny(**KW[model]))


@pytest.fixture(scope="module")
def jparams():
    return {m: _jax_init(m) for m in KW}


@pytest.fixture(scope="module")
def trees(jparams):
    return {m: jax.tree.map(np.asarray, p) for m, p in jparams.items()}


def _ring_arrays():
    """The ring case's inputs, made from a seed with numpy: q/k/v of the
    whole chunk [1, H, P, Dh], pools [blocks*bs, Hkv, Dh] with random
    history, int8 pools with their scales, the table row [M]."""
    r = RING
    rng = np.random.default_rng(11)
    f = np.float32
    a = {"q": rng.normal(size=(1, r["H"], r["P"], r["Dh"])).astype(f),
         "k": rng.normal(size=(1, r["Hkv"], r["P"], r["Dh"])).astype(f),
         "v": rng.normal(size=(1, r["Hkv"], r["P"], r["Dh"])).astype(f),
         "table": np.array([3, 7, 1, 9, 4, 0, 0, 0], np.int32)}
    shape = (r["blocks"] * r["bs"], r["Hkv"], r["Dh"])
    hist = [rng.normal(size=shape).astype(f) for _ in range(2)]
    i8 = [rng.integers(-127, 128, size=shape).astype(np.int8)
          for _ in range(2)]
    sc = [(rng.random((r["blocks"], r["Hkv"])) * 0.02 + 0.01).astype(f)
          for _ in range(2)]
    return ({**a, "k_cache": hist[0], "v_cache": hist[1]},
            {**a, "k_cache": i8[0], "v_cache": i8[1], "k_scale": sc[0],
             "v_scale": sc[1]})


RING_CASES = {"ring_f32": 0, "ring_int8": 1}


def _ring_job(name):
    arrays = _ring_arrays()[RING_CASES[name]]
    return {"kind": "ring", "mesh": {"dp": 2, "sp": 2}, "arrays": arrays,
            "start": RING["start"], "t0": RING["t0"],
            "block_size": RING["bs"],
            "layout": "int8" if "k_scale" in arrays else "f32"}


@pytest.fixture(scope="module")
def world(trees, tmp_path_factory):
    jobs = {name: _job(name) for name in JOBS}
    jobs.update({name: _ring_job(name) for name in RING_CASES})
    ranks = run_world(serve_mesh_case, 4, tmp_path_factory.mktemp("serve"),
                      trees, jobs, timeout=300)
    assert len(ranks) == 4
    return ranks


def _port_single(name, trees):
    job = _job(name)
    engine = {k: v for k, v in job["engine"].items()
              if k not in ("sp_axis", "ep_axis")}
    return run_engine_job({**job, "engine": engine}, trees)


def _jax_mesh(sizes):
    names = tuple(sizes)
    n = int(np.prod(list(sizes.values())))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(
        tuple(sizes.values())), names)


def _jax_run(name, jparams):
    """JAX's engine on the job's mesh (its 2-wide axes; the dp axis the
    port's ranks carry beside them is left out)."""
    job = _job(name)
    model = JOBS[name][0]
    sizes = {k: v for k, v in job["mesh"].items() if k != "dp"}
    cfg = (JaxLlamaConfig.tiny(**LLAMA_KW) if model == "llama"
           else JaxGPT2Config.tiny(**KW[model]))
    params = jparams[model]
    if "tp" in sizes and model != "llama":
        params = jax_tp_layout(params, cfg, sizes["tp"])
    fam = (jax_llama_family if model == "llama" else jax_gpt2_family)(cfg)
    kw = dict(job["engine"])
    if job.get("adapters"):
        from quintnet_tpu.models.lora import LoRAConfig as JaxLoRAConfig
        from quintnet_tpu.serve import AdapterRegistry as JaxRegistry

        kw["adapters"] = JaxRegistry()
        for aid, (tree, rank, alpha) in job["adapters"].items():
            kw["adapters"].register(aid, tree=tree, cfg=JaxLoRAConfig(
                rank=rank, alpha=alpha))
    eng = JaxServeEngine(fam, params, mesh=_jax_mesh(sizes), **kw)
    outs = []
    for wave in job["waves"]:
        rids = [eng.submit(np.asarray(r[0], np.int32), r[1],
                           key=jax.random.key(r[2]),
                           adapter_id=r[3] if len(r) > 3 else None)
                for r in wave]
        while eng.has_work:
            eng.step()
        outs += [eng.result(r) for r in rids]
    return outs, eng.metrics.summary()


@pytest.fixture(scope="module")
def jax_runs(jparams):
    return {name: _jax_run(name, jparams) for name in JAX_HELD}


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.parametrize("name", JAX_HELD)
def test_mesh_engine_greedy_equals_jax_mesh_engine(world, jax_runs, name):
    want, _ = jax_runs[name]
    for r in world:
        assert _same(r[name]["streams"], want), (name, r[name]["streams"],
                                                 want)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_mesh_engine_equals_one_device_port(world, trees, name):
    """Every job, greedy or sampled, f32 or scaled pool: each rank's
    streams are the port's one-device engine's, token for token (the
    sampled chain is a pure function of (seed, position), so a mesh that
    computes the same logits draws the same tokens)."""
    want = _port_single(name, trees)["streams"]
    for r in world:
        assert _same(r[name]["streams"], want), (name, r[name]["streams"],
                                                 want)


def test_ranks_agree_on_every_host_decision(world):
    """The host scheduler reads the same tokens on every rank, so every
    rank admits, grows and retires alike: the same streams, the same
    pool occupancy, the same prefix hits and chunk counts."""
    for name in JOBS:
        first = world[0][name]
        for r in world[1:]:
            got = r[name]
            assert _same(got["streams"], first["streams"]), name
            for key in ("blocks_used", "prefix_hit_tokens",
                        "prefill_chunks", "moe"):
                assert got[key] == first[key], (name, key)


def test_fake_quant_on_tp_equals_f32_on_tp(world):
    for r in world:
        assert _same(r["tp2_fake_quant"]["streams"], r["tp2"]["streams"])


def test_fake_quant_weights_on_tp_equal_f32_on_tp(world):
    """Scaled weights on tp = 2: each ``w_scale`` cut like its weight's
    out dim (``serve/weight_quant.augment_weight_specs``); fake_quant's
    streams are the f32 streams bit for bit, and every rank accounts the
    whole tree's weight bytes, as JAX's engine does."""
    for r in world:
        assert _same(r["tp2_wq_fake_quant"]["streams"],
                     r["tp2"]["streams"])
        assert (r["tp2_wq_int8"]["weight_bytes"]
                < r["tp2"]["weight_bytes"] / 3.5)


def test_adapters_on_tp_equal_the_dedicated_merged_engines(world, trees):
    """Multi-tenant LoRA on tp = 2: the packed factors cut like their
    weights (``a`` on its in dim, ``b`` on its out dim, GPT-2's qkv ``b``
    re-blocked by the family's layout hook); each request's stream is a
    dedicated one-device engine's on that tenant's merged weights."""
    from quintnet_tpu_torch.bridge import lora_params_from_numpy
    from quintnet_tpu_torch.models.lora import LoRAConfig, lora_merge_tree

    tenants = _tenants()
    cfg = GPT2Config.tiny(**GPT2_KW)
    for i, (p, m, sd, aid) in enumerate(LORA_WAVE):
        tp = gpt2_params_from_numpy(trees["gpt2"], "cpu")
        if aid is not None:
            tree, rank, alpha = tenants[aid]
            tp = lora_merge_tree(tp, lora_params_from_numpy(tree, "cpu"),
                                 LoRAConfig(rank=rank, alpha=alpha))
        eng = ServeEngine(gpt2_family(cfg), tp, device="cpu",
                          **{**BASE, "max_slots": 1})
        rid = eng.submit(np.asarray(p, np.int32), m, seed=sd)
        eng.run()
        for r in world:
            assert np.array_equal(r["tp2_lora"]["streams"][i],
                                  eng.result(rid)), (i, aid)


@pytest.mark.parametrize("name,heads", [
    ("tp2", 2), ("tp2_int8", 2), ("tp2_llama", 1), ("tp2_llama_int8", 1),
    ("sp2", 4), ("ep2", 4), ("ep2tp2", 2)])
def test_pool_holds_the_ranks_kv_heads(world, name, heads):
    """The pool [L, slots, Hkv/tp, Dh] and a scaled pool's scales [L,
    blocks, Hkv/tp]: a tp rank holds its kv heads, sp and ep ranks all
    of them (Llama's pool holds the UNrepeated kv heads)."""
    for r in world:
        got = r[name]
        assert got["pool_shape"][2] == heads
        if got["scale_shape"] is not None:
            assert got["scale_shape"][2] == heads


@pytest.mark.parametrize("name", ["tp2_prefix", "ep2_prefix"])
def test_prefix_cache_on_tp_and_ep(world, trees, name):
    """A shared-prefix second request admits through the prefix cache on
    every rank (the same block ids: the host pool is deterministic) and
    still serves one device's stream."""
    want = _port_single(name, trees)
    for r in world:
        assert r[name]["prefix_hit_tokens"] > 0
        assert r[name]["prefix_hit_tokens"] == want["prefix_hit_tokens"]
        assert _same(r[name]["streams"], want["streams"])


def test_sp_chunked_feeds_chunks(world):
    for r in world:
        assert r["sp2_chunked"]["prefill_chunks"] >= 4
        assert r["sp2_llama_int8"]["prefill_chunks"] >= 4


@pytest.mark.parametrize("name", ["tp2", "sp2", "ep2", "ep2tp2", "sp4"])
def test_mesh_axes_match_jax(world, name):
    """The engine's axis names, as JAX's engine keeps them."""
    want = {"tp2": ("tp", None, None), "sp2": (None, "sp", None),
            "sp4": (None, "sp", None), "ep2": (None, None, "ep"),
            "ep2tp2": ("tp", None, "ep")}[name]
    for r in world:
        assert r[name]["axes"] == want


@pytest.mark.parametrize("name", ["ep2", "ep2tp2"])
def test_routing_summary_equals_jax(world, jax_runs, name):
    """The routing ledger reads the programs' own routing counts
    (pre-capacity demand per expert, drops, assignments): identical to
    JAX's engine on the same mesh, and on every rank."""
    _, summary = jax_runs[name]
    for r in world:
        got = r[name]["moe"]
        assert got["moe_routed_tokens"] > 0
        for k in ("moe_routed_tokens", "moe_dropped_tokens",
                  "moe_expert_tokens"):
            assert got[k] == summary[k], (k, got[k], summary[k])
        assert got["moe_router_entropy"] == pytest.approx(
            summary["moe_router_entropy"], abs=1e-4)


def _jax_ring(arrays):
    from quintnet_tpu.nn.attention import ring_paged_prefill
    from quintnet_tpu.serve.kv_quant import make_policy

    r = RING
    scaled = "k_scale" in arrays
    mesh = _jax_mesh({"sp": 2})
    chunk = P(None, None, "sp", None)

    def body(q, k, v, kc, vc, *sc):
        out = ring_paged_prefill(
            q, k, v, jnp.int32(r["start"]), jnp.int32(r["t0"]), kc, vc,
            sp_axis="sp", block_tables=jnp.asarray(arrays["table"]),
            block_size=r["bs"], kv_scales=tuple(sc) if sc else None,
            policy=make_policy("int8" if scaled else "f32"))
        return out

    pools = [arrays[k] for k in ("k_cache", "v_cache")]
    if scaled:
        pools += [arrays["k_scale"], arrays["v_scale"]]
    fn = jax.shard_map(
        body, mesh=mesh, in_specs=(chunk,) * 3 + (P(),) * len(pools),
        out_specs=(chunk,) + (P(),) * len(pools), check_vma=False)
    out = fn(*(jnp.asarray(arrays[k]) for k in ("q", "k", "v")),
             *map(jnp.asarray, pools))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_paged_prefill_equals_jax_in_shard_map(world, name):
    """Each rank's output slice [1, H, P/2, Dh] within 1e-5 of JAX's
    (the same slice of its sharded output) and its pools after the
    whole chunk's write within 1e-5 (int8 pools: the bytes within one
    quantization step, the scales within 1e-6), on blocks 1.. (the null
    block 0 takes the pad rows' writes, duplicates in any order); the
    blocks the chunk does not reach are untouched."""
    arrays = _ring_arrays()[RING_CASES[name]]
    o, *pools = _jax_ring(arrays)
    pl, bs = RING["P"] // 2, RING["bs"]
    for rank, r in enumerate(world):
        got = r[name]
        idx = rank % 2                         # mesh (dp, sp): sp minor
        np.testing.assert_allclose(got["o"], o[:, :, idx * pl:(idx + 1)
                                               * pl], atol=1e-5, rtol=0)
        for g, w in zip(got["pools"], pools):
            rows = bs if g.ndim == 3 else 1    # a pool's slots or scales
            g, w = g[rows:], w[rows:]
            if g.dtype == np.int8:
                assert np.abs(g.astype(np.int32)
                              - w.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(g, w, atol=1e-6 if rows == 1
                                           else 1e-5, rtol=0)
        untouched = [b for b in range(1, RING["blocks"])
                     if b not in (1, 9, 4)]
        for g, a in zip(got["pools"][:2], (arrays["k_cache"],
                                           arrays["v_cache"])):
            for b in untouched:
                assert np.array_equal(g[b * bs:(b + 1) * bs],
                                      a[b * bs:(b + 1) * bs])


# ---------------------------------------------------------------------
# the constructor: JAX's checks, errors and messages
# ---------------------------------------------------------------------

def _fake_mesh(**sizes):
    """A rank-0 view of a mesh with no process group behind it: enough
    for the constructor's checks, which all raise before any
    collective."""
    return Mesh(MeshSpec.create(**sizes), 0, {})


ERRORS = {
    "sp_axis_not_in_mesh": ("gpt2", {"sp": 2}, {"sp_axis": "spp"}),
    "sp_axis_without_mesh": ("gpt2", None, {"sp_axis": "sp"}),
    "sp_times_tp": ("gpt2", {"sp": 2, "tp": 2}, {"sp_axis": "sp"}),
    "sp_bucket_indivisible": ("gpt2", {"sp": 4},
                              {"sp_axis": "sp",
                               "prefill_bucket_sizes": (16, 18),
                               "prefill_len": 18, "max_seq_len": 24}),
    "moe_times_sp": ("gpt2_moe", {"sp": 2}, {"sp_axis": "sp"}),
    "ep_on_dense": ("gpt2", {"ep": 2}, {"ep_axis": "ep"}),
    "ep_axis_without_mesh": ("gpt2_moe", None, {"ep_axis": "ep"}),
    "ep_axis_not_in_mesh": ("gpt2_moe", {"tp": 2}, {"ep_axis": "ep"}),
    "experts_indivisible": ("gpt2_moe", {"ep": 3}, {"ep_axis": "ep"}),
    "top_k": ("gpt2_moe", None, {}, {"expert_top_k": 5}),
    "capacity": ("gpt2_moe", None, {}, {"expert_capacity": 0}),
    "capacity_factor": ("gpt2_moe", None, {}, {"capacity_factor": 0.0}),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_constructor_errors_match_jax(case, jparams, trees):
    model, sizes, kw, *cfg_kw = ERRORS[case]
    cfg_kw = {**KW[model], **(cfg_kw[0] if cfg_kw else {})}
    jcfg = JaxGPT2Config.tiny(**cfg_kw)
    cfg = GPT2Config.tiny(**cfg_kw)
    kw = {**MOE_BASE, **kw}
    with pytest.raises(Exception) as want:
        JaxServeEngine(jax_gpt2_family(jcfg), jparams[model],
                       mesh=None if sizes is None else _jax_mesh(sizes),
                       **kw)
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy

    with pytest.raises(want.type) as got:
        ServeEngine(gpt2_family(cfg), gpt2_params_from_numpy(
            trees[model], "cpu"), device="cpu",
            mesh=None if sizes is None else _fake_mesh(**sizes), **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axis", ["sp", "ep", "tp"])
def test_axis_of_size_one_runs_the_plain_engine(axis, trees):
    """engine(axis = 1) is the single-device engine: the axis name is
    None for sp and ep (tp keeps JAX's name), no shard is cut, the
    streams are the plain engine's."""
    model = "gpt2_moe" if axis == "ep" else "gpt2"
    cfg = GPT2Config.tiny(**KW[model])
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy

    params = gpt2_params_from_numpy(trees[model], "cpu")
    kw = {"sp": {"sp_axis": "sp"}, "ep": {"ep_axis": "ep"}, "tp": {}}[axis]
    eng = ServeEngine(gpt2_family(cfg), params, device="cpu",
                      mesh=mesh_from_sizes(**{axis: 1}), **MOE_BASE, **kw)
    assert (eng.tp_axis, eng.sp_axis, eng.ep_axis) == (
        ("tp" if axis == "tp" else None), None, None)
    assert all(eng.params["blocks"][k][n]["w"].shape
               == params["blocks"][k][n]["w"].shape
               for k, n in (("attn", "qkv"), ("attn", "proj")))
    plain = ServeEngine(gpt2_family(cfg), params, device="cpu", **MOE_BASE)
    prompts = [np.asarray(p, np.int32) for p, _, _ in SHORT]
    for e in (eng, plain):
        for p in prompts:
            e.submit(p, 5)
        e.run()
    assert all(np.array_equal(eng.result(i), plain.result(i))
               for i in range(len(prompts)))
