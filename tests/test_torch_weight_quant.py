"""The port's weight layout policies (quintnet_tpu_torch/serve/
weight_quant.py) against the JAX package: the cases of
``tests/test_weight_quant.py``.

- the policy ladder, its resolution and JAX's errors;
- ``quantize_params`` on JAX's weights (bridged) equals JAX's: int8 and
  fp8 bytes exactly, the per-output-channel scales within 1e-7
  relative; bf16 bytes exactly; ``weight_bytes`` equals JAX's and f32 /
  int8 >= 3.5; ``augment_weight_specs`` JAX's spec for spec;
- ``quantized_matmul`` and ``lora_delta`` against JAX's within 1e-6;
- engines: fake_quant weights bit-equal to f32's, greedy, sampled, with
  the prefix cache, speculation, chunked prefill, a fake_quant pool,
  Llama and a LoRA tenant on top (the tp2 case runs in
  ``tests/test_torch_serve_mesh.py``'s world); bf16 / int8 / fp8 greedy
  streams equal JAX's engine of the same policy token for token;
- teacher-forced NLL through the paged pool: fake_quant's equals f32's
  exactly, int8's and fp8's within JAX's gate of 0.05 of f32's, and each
  within 1e-4 of JAX's.

JAX's compile-count cases (``test_serves_and_compile_bound_holds``,
``test_zero_backend_compiles_after_warmup``) have no eager-PyTorch
meaning; the mixed staggered trace they drive is held here by every
request finishing with its full length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quintnet_tpu.analysis.specs import \
    weight_layout_policies as jax_weight_layout_policies
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from quintnet_tpu.models.llama import llama_init as jax_llama_init
from quintnet_tpu.nn import layers as jlayers
from quintnet_tpu.serve import KVPool as JaxKVPool
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu.serve import llama_family as jax_llama_family
from quintnet_tpu.serve import weight_quant as jwq
from quintnet_tpu.serve.kv_quant import paged_eval_nll as jax_eval_nll
from quintnet_tpu_torch.analysis.specs import weight_layout_policies
from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                       llama_params_from_numpy,
                                       lora_params_from_numpy)
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_partition_specs
from quintnet_tpu_torch.models.llama import LlamaConfig
from quintnet_tpu_torch.models.lora import LoRAConfig
from quintnet_tpu_torch.nn import layers as tlayers
from quintnet_tpu_torch.serve import (AdapterRegistry, KVPool, ServeEngine,
                                      SpecConfig, gpt2_family, llama_family)
from quintnet_tpu_torch.serve import weight_quant as twq
from quintnet_tpu_torch.serve.kv_quant import (KVLayoutPolicy, LayoutPolicy,
                                               dequant_roundtrip_error,
                                               make_policy, paged_eval_nll)

torch.set_num_threads(1)

JCFG = JaxGPT2Config.tiny(n_layer=2)
CFG = GPT2Config.tiny(n_layer=2)
POLICIES = ("f32", "bf16", "int8", "fp8", "fake_quant")
PACKED = ("bf16", "int8", "fp8", "fake_quant")
# scales: JAX's and the port's absmax / qmax are the same IEEE ops; the
# documented tolerance allows a last-bit difference of the reduction
SCALE_RTOL = 1e-7
NLL_GATE = 0.05          # JAX's gate (tests/test_weight_quant.py)
NLL_VS_JAX = 1e-4        # the same NLL in two packages


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _prompts(seed, lengths, vocab=None):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab or CFG.vocab_size, n).astype(np.int32)
            for n in lengths]


def _engine(tparams, weights_dtype, family=None, **kw):
    kw = {"max_slots": 3, "block_size": 4, "num_blocks": 48,
          "max_seq_len": 32, **kw}
    return ServeEngine(family or gpt2_family(CFG), tparams, device="cpu",
                       weights_dtype=weights_dtype, **kw)


def _serve(eng, prompts, max_new, *, arrivals=None, seeds=None,
           adapter_ids=None):
    """Staggered submission, run to the end; outputs in submission
    order."""
    arrivals = arrivals or [0] * len(prompts)
    seeds = seeds or [100 + i for i in range(len(prompts))]
    adapter_ids = adapter_ids or [None] * len(prompts)
    rids, done, step = {}, 0, 0
    while done < len(prompts) or eng.has_work:
        while done < len(prompts) and arrivals[done] <= step:
            rids[done] = eng.submit(prompts[done], max_new,
                                    seed=seeds[done],
                                    adapter_id=adapter_ids[done])
            done += 1
        eng.step()
        step += 1
        assert step < 1000, "engine failed to drain"
    return [eng.result(rids[i]) for i in range(len(prompts))]


def _jax_greedy(jp, weights_dtype, prompts, max_new, family=None, **kw):
    kw = {"max_slots": 3, "block_size": 4, "num_blocks": 48,
          "max_seq_len": 32, **kw}
    eng = JaxServeEngine(family or jax_gpt2_family(JCFG), jp,
                         weights_dtype=weights_dtype, attn_kernel="xla",
                         **kw)
    rids = [eng.submit(p, max_new) for p in prompts]
    eng.run()
    return eng, [eng.result(r) for r in rids]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _bytes(t):
    """A tensor's or array's raw bytes as uint8 (float8 included)."""
    if torch.is_tensor(t):
        return (t.view(torch.uint8) if t.element_size() == 1
                else t.contiguous().view(torch.uint8)).numpy()
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8)


# ---------------------------------------------------------------------
# the policy ladder
# ---------------------------------------------------------------------

def test_ladder_equals_jax():
    assert (twq.weight_policy_names() == weight_layout_policies()
            == jwq.weight_policy_names() == jax_weight_layout_policies())
    for name in POLICIES:
        t, j = twq.make_weight_policy(name), jwq.make_weight_policy(name)
        assert (t.name, t.scaled, t.qmax) == (j.name, j.scaled, j.qmax)
        assert t.store_dtype.itemsize == jnp.dtype(j.store_dtype).itemsize


def test_resolution_and_errors_match_jax():
    assert twq.make_weight_policy(None).name == "f32"
    assert twq.make_weight_policy(torch.float32).name == "f32"
    assert twq.make_weight_policy(torch.bfloat16).name == "bf16"
    p = twq.make_weight_policy("fake_quant")
    assert twq.make_weight_policy(p) is p
    with pytest.raises(ValueError) as tex:
        twq.make_weight_policy("int4")
    with pytest.raises(ValueError) as jex:
        jwq.make_weight_policy("int4")
    assert str(tex.value) == str(jex.value)
    with pytest.raises(ValueError, match="no weight policy for dtype"):
        twq.make_weight_policy(torch.int8)   # raw int8 needs the scales
    with pytest.raises(ValueError, match="no weight policy for dtype"):
        jwq.make_weight_policy(jnp.int8)


def test_one_protocol_two_faces():
    for name in POLICIES:
        pol = twq.make_weight_policy(name)
        assert isinstance(pol, twq.WeightLayoutPolicy)
        assert isinstance(pol, LayoutPolicy)
        assert not isinstance(pol, KVLayoutPolicy)
    assert not isinstance(make_policy("int8"), twq.WeightLayoutPolicy)


@pytest.mark.parametrize("name,bound", [("int8", 0.5),
                                        ("fp8", 448.0 * 2.0 ** -4)])
def test_roundtrip_bounds(name, bound):
    """Per-output-channel groups of [L, in, out]: int8's error at most
    scale / 2, fp8's at most scale * 448 * 2**-4 (half an e4m3 step at a
    binade top); fake_quant's exactly 0 with unit scales."""
    x = np.random.default_rng(3).normal(size=(2, 16, 8)).astype(np.float32)
    err, sc = dequant_roundtrip_error(twq.make_weight_policy(name), x,
                                      axes=(-2,))
    assert err.shape == sc.shape == (2, 8)
    assert bool((err <= sc * bound + 1e-6).all()) and float(err.max()) > 0
    err0, sc0 = dequant_roundtrip_error(twq.make_weight_policy("fake_quant"),
                                        x, axes=(-2,))
    assert bool((err0 == 0).all()) and bool((sc0 == 1).all())


# ---------------------------------------------------------------------
# the tree surgery, byte for byte
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", PACKED)
def test_quantize_params_equals_jax(params, name):
    jp, tp = params
    targets = twq.present_targets(tp, gpt2_family(CFG).weight_targets)
    assert targets == jwq.present_targets(
        jp, jax_gpt2_family(JCFG).weight_targets)
    tq = twq.quantize_params(tp, targets, twq.make_weight_policy(name))
    jq = jwq.quantize_params(jp, targets, jwq.make_weight_policy(name))
    for path in targets:
        t, j = _node(tq["blocks"], path), _node(jq["blocks"], path)
        assert sorted(t) == sorted(j)
        assert tuple(t["w"].shape) == j["w"].shape
        np.testing.assert_array_equal(_bytes(t["w"]), _bytes(j["w"]))
        if "w_scale" in j:
            np.testing.assert_allclose(t["w_scale"].numpy(),
                                       np.asarray(j["w_scale"]),
                                       rtol=SCALE_RTOL, atol=0)
        if "b" in j:                     # the bias stays full precision
            assert t["b"] is _node(tp["blocks"], path)["b"]
    assert tq["embedding"] is tp["embedding"]
    assert tq["blocks"]["ln1"] is tp["blocks"]["ln1"]
    assert twq.weight_bytes(tq, targets) == jwq.weight_bytes(jq, targets)


def test_f32_is_the_identity_and_missing_targets_drop(params):
    _, tp = params
    fam = gpt2_family(CFG)
    targets = twq.present_targets(tp, fam.weight_targets)
    assert twq.quantize_params(tp, targets,
                               twq.make_weight_policy("f32")) is tp
    no_mlp = {**tp, "blocks": {k: v for k, v in tp["blocks"].items()
                               if k != "mlp"}}
    assert twq.present_targets(no_mlp, fam.weight_targets) == (
        ("attn", "qkv"), ("attn", "proj"))


def test_weight_bytes_ratio_and_engine_accounting(params):
    jp, tp = params
    targets = twq.present_targets(tp, gpt2_family(CFG).weight_targets)
    b32 = twq.weight_bytes(tp, targets)
    b8 = twq.weight_bytes(twq.quantize_params(
        tp, targets, twq.make_weight_policy("int8")), targets)
    assert b32 / b8 >= 3.5
    assert _engine(tp, "int8").weight_bytes == b8
    assert _engine(tp, None).weight_bytes == b32
    jeng = JaxServeEngine(jax_gpt2_family(JCFG), jp, weights_dtype="int8",
                          max_slots=3, block_size=4, num_blocks=48,
                          max_seq_len=32)
    assert jeng.weight_bytes == b8


def test_augment_weight_specs_equals_jax():
    from quintnet_tpu.models.gpt2 import \
        gpt2_partition_specs as jax_gpt2_specs

    targets = gpt2_family(CFG).weight_targets
    t = twq.augment_weight_specs(gpt2_partition_specs(CFG, tp_axis="tp"),
                                 targets)
    j = jwq.augment_weight_specs(jax_gpt2_specs(JCFG, tp_axis="tp"),
                                 targets)
    for path in targets:
        tn, jn = _node(t["blocks"], path), _node(j["blocks"], path)
        assert tuple(tn["w_scale"]) == tuple(jn["w_scale"])
    # column-parallel scales cut with their columns, row-parallel whole
    assert t["blocks"]["attn"]["qkv"]["w_scale"][-1] == "tp"
    assert t["blocks"]["attn"]["proj"]["w_scale"][-1] is None


# ---------------------------------------------------------------------
# the seams
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", POLICIES)
def test_quantized_matmul_equals_jax(name):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(1, 16, 12)).astype(np.float32)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    tnode = twq.quantize_params(
        {"blocks": {"l": {"w": torch.tensor(w), "b": torch.tensor(b)}}},
        (("l",),), twq.make_weight_policy(name))["blocks"]["l"]
    jnode = jwq.quantize_params(
        {"blocks": {"l": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}},
        (("l",),), jwq.make_weight_policy(name))["blocks"]["l"]
    got = tlayers.linear_apply({k: v[0] if v.dim() > 1 or k == "w_scale"
                                else v for k, v in tnode.items()},
                               torch.tensor(x))
    want = jlayers.linear_apply({k: v[0] if v.ndim > 1 or k == "w_scale"
                                 else v for k, v in jnode.items()},
                                jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_lora_delta_equals_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 4, 16)).astype(np.float32)
    a = rng.normal(size=(3, 16, 8)).astype(np.float32)
    b = rng.normal(size=(3, 8, 12)).astype(np.float32)
    s = np.array([2.0, 0.0, 0.5], np.float32)
    got = tlayers.lora_delta(torch.tensor(x), {"a": torch.tensor(a),
                                               "b": torch.tensor(b)},
                             torch.tensor(s))
    want = jlayers.lora_delta(jnp.asarray(x), {"a": jnp.asarray(a),
                                               "b": jnp.asarray(b)},
                              jnp.asarray(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    assert bool((got[1] == 0).all())     # a zero scale: the base row


# ---------------------------------------------------------------------
# fake_quant weights == f32, bit for bit
# ---------------------------------------------------------------------

FAKE_CASES = {
    "greedy": {},
    "sampled": {"temperature": 0.9, "top_k": 7},
    "speculative_sampled": {"spec": SpecConfig(), "temperature": 0.7},
    "chunked_prefill": {"chunked_prefill": True, "prefill_len": 8,
                        "prefill_chunk_budget": 4},
    "kv_fake_quant": {"kv_dtype": "fake_quant"},
}


@pytest.mark.parametrize("case", sorted(FAKE_CASES))
def test_fake_quant_equals_f32(params, case):
    kw = FAKE_CASES[case]
    lengths = (5, 14, 3) if case == "chunked_prefill" else (5, 9, 3)
    prompts = _prompts(70, lengths)
    max_new = 8 if case.startswith("spec") else 6
    out32 = _serve(_engine(params[1], "f32", **kw), prompts, max_new)
    outfk = _serve(_engine(params[1], "fake_quant", **kw), prompts, max_new)
    _same(outfk, out32)


def test_fake_quant_prefix_cache_reuse(params):
    rng = np.random.default_rng(8)
    shared = rng.integers(0, CFG.vocab_size, 10).astype(np.int32)
    prompts = [np.concatenate([shared, t]) for t in _prompts(9, (3, 5, 2, 4))]
    outs = {}
    for name in ("f32", "fake_quant"):
        eng = _engine(params[1], name, max_slots=2)
        outs[name] = _serve(eng, prompts, 5, arrivals=[0, 0, 6, 6])
        assert eng.metrics.prefix_hit_tokens > 0
    _same(outs["fake_quant"], outs["f32"])


def test_fake_quant_llama_equals_f32_and_jax():
    jcfg, cfg = JaxLlamaConfig.tiny(n_layers=2), LlamaConfig.tiny(n_layers=2)
    jp = jax_llama_init(jax.random.key(1), jcfg)
    tp = llama_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    prompts = _prompts(11, (4, 7), cfg.vocab_size)
    kw = {"max_slots": 2, "num_blocks": 32, "max_seq_len": 24}
    outs = {name: _serve(_engine(tp, name, llama_family(cfg), **kw),
                         prompts, 5) for name in ("f32", "fake_quant",
                                                  "int8")}
    _same(outs["fake_quant"], outs["f32"])
    _, want = _jax_greedy(jp, "int8", prompts, 5, jax_llama_family(jcfg),
                          **kw)
    _same(outs["int8"], want)


def _tenant_lora(jp):
    """A rank-4 adapter on every GPT-2 target, made non-trivial (its b
    is zero at init), JAX's and bridged."""
    from quintnet_tpu.models import lora as jlora

    jlo = jlora.lora_init(jax.random.key(3), jp["blocks"],
                          jlora.LoRAConfig(rank=4))
    jlo = jax.tree.map(lambda leaf: leaf + 0.02 * jax.random.normal(
        jax.random.key(103), leaf.shape), jlo)
    return lora_params_from_numpy(jax.tree.map(np.asarray, jlo), "cpu")


def test_lora_stays_full_precision_on_top(params):
    """A fake_quant engine serving a LoRA tenant equals the f32 engine
    serving it, bit for bit: the delta rides on the scaled dot, and the
    packed factors keep the full-precision dtype."""
    lora = _tenant_lora(params[0])
    prompts = _prompts(12, (5, 8))
    outs = {}
    for name in ("f32", "fake_quant"):
        reg = AdapterRegistry()
        reg.register("t", tree=lora, cfg=LoRAConfig(rank=4))
        eng = _engine(params[1], name, adapters=reg, max_seq_len=48)
        outs[name] = _serve(eng, prompts, 5, adapter_ids=["t", "t"])
        assert all(d["a"].dtype == torch.float32
                   for d in eng._lora_dev.values())
    _same(outs["fake_quant"], outs["f32"])


# ---------------------------------------------------------------------
# narrow weights: the same streams as JAX's engine, the NLL gate
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ("bf16", "int8", "fp8"))
def test_narrow_weights_greedy_equals_jax(params, name):
    """A mixed staggered trace on a small pool (block 2, 12 blocks):
    every request finishes with its full length, and the streams equal
    JAX's engine of the same policy token for token."""
    prompts = _prompts(21, (3, 5, 4, 6, 3))
    kw = {"max_slots": 3, "block_size": 2, "num_blocks": 12,
          "max_seq_len": 16}
    eng = _engine(params[1], name, **kw)
    outs = _serve(eng, prompts, 5)
    assert [len(o) for o in outs] == [len(p) + 5 for p in prompts]
    assert eng.metrics.finished == len(prompts)
    s = eng.metrics.summary()
    assert s["weights_dtype"] == name
    assert s["weight_bytes"] == eng.weight_bytes > 0
    _, want = _jax_greedy(params[0], name, prompts, 5, **kw)
    _same(outs, want)


def test_paged_nll_gate_and_equal_to_jax(params):
    jp, tp = params
    rows = np.random.default_rng(13).integers(
        0, CFG.vocab_size, (4, 24)).astype(np.int32)
    geo = {"n_layers": CFG.n_layer, "n_kv_heads": CFG.n_head,
           "head_dim": CFG.n_embd // CFG.n_head, "block_size": 4,
           "num_blocks": 32}
    nll, jnll = {}, {}
    for name in ("f32", "fake_quant", "int8", "fp8"):
        targets = gpt2_family(CFG).weight_targets
        tq = twq.quantize_params(tp, targets, twq.make_weight_policy(name))
        jq = jwq.quantize_params(jp, targets, jwq.make_weight_policy(name))
        nll[name] = paged_eval_nll(gpt2_family(CFG), tq,
                                   KVPool(**geo, device="cpu"), rows)
        jnll[name] = jax_eval_nll(jax_gpt2_family(JCFG), jq,
                                  JaxKVPool(**geo), rows)
        assert abs(nll[name] - jnll[name]) < NLL_VS_JAX, name
    assert nll["fake_quant"] == nll["f32"]
    for name in ("int8", "fp8"):
        assert abs(nll[name] - nll["f32"]) < NLL_GATE, name
