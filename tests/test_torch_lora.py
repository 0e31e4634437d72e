"""LoRA in the port (models/lora.py) against the JAX package: the cases of
``tests/test_lora.py``.

On the same base weights and adapters (JAX init, bridged): zero-init
``b`` is the identity; the adapter shapes and counts; adapter-only
training moves only the adapters and follows JAX's optax Adam steps
(losses within 1e-5 relative, adapters within ``rtol=2e-4, atol=1e-5``,
``tests/test_lora.py``'s own); the spec derivation; the merged model
generates JAX's greedy stream; Llama and ViT blocks; the config's
validation; ``save_lora`` from the port loads in JAX's ``load_lora``
and the other way round, bf16 and Llama's seven targets included.

On one 4-rank gloo world (dp x tp = 2 x 2): the shard-local merge's
forward equals the single-device merged forward (``rtol=2e-4,
atol=1e-5``), and ``make_lora_train_step`` for 3 steps equals JAX's
single-device LoRA run (the tolerances of
``test_sharded_lora_training_matches_single_device``), the base
untouched bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist import run_world
from _torch_gen_cases import lora_world_case
from quintnet_tpu.models import lora as jlora
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import clm_loss as jax_clm_loss
from quintnet_tpu.models.gpt2 import gpt2_apply as jax_gpt2_apply
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2_generate import gpt2_generate as jax_generate
from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                       llama_params_from_numpy,
                                       lora_params_from_numpy,
                                       lora_params_to_numpy,
                                       vit_params_from_numpy)
from quintnet_tpu_torch.core.pytree import tree_leaves
from quintnet_tpu_torch.models.gpt2 import GPT2Config, clm_loss, gpt2_apply
from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate
from quintnet_tpu_torch.models.lora import (LLAMA_ATTN_TARGETS,
                                            LLAMA_TARGETS, LoRAConfig,
                                            load_lora, lora_init,
                                            lora_merge_tree,
                                            lora_param_count,
                                            lora_partition_specs,
                                            lora_upcast, lora_wrap,
                                            make_lora_train_step, save_lora)
from quintnet_tpu_torch.parallel.dp import accumulate_grads
from quintnet_tpu_torch.parallel.tp import block_specs
from quintnet_tpu_torch.train.trainer import Optimizer

torch.set_num_threads(1)

GPT2_KW = dict(n_layer=2)
JCFG = JaxGPT2Config.tiny(**GPT2_KW)
CFG = GPT2Config.tiny(**GPT2_KW)
LCFG = LoRAConfig(rank=4, alpha=8.0)
JLCFG = jlora.LoRAConfig(rank=4, alpha=8.0)


@pytest.fixture(scope="module")
def base():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    tp = gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ids = np.random.default_rng(0).integers(0, CFG.vocab_size,
                                            (2, 16)).astype(np.int32)
    return jp, tp, ids


def _noisy(jlo, seed=6):
    """Adapters made non-trivial (b is zero at init), as test_lora.py."""
    return jax.tree.map(
        lambda l: l + 0.01 * jax.random.normal(jax.random.key(seed),
                                               l.shape), jlo)


def _to_port(jlo):
    return lora_params_from_numpy(jax.tree.map(np.asarray, jlo), "cpu")


def _flat(tree):
    return {".".join(k): v.detach().numpy() for k, v in tree_leaves(tree)}


def test_zero_init_is_identity(base):
    _, tp, ids = base
    lora = lora_init(torch.Generator().manual_seed(1), tp["blocks"], LCFG)
    t = torch.tensor(ids).long()
    np.testing.assert_allclose(
        gpt2_apply(lora_merge_tree(tp, lora, LCFG), t, CFG).detach(),
        gpt2_apply(tp, t, CFG).detach(), rtol=1e-6, atol=1e-6)


def test_merged_forward_equals_jax(base):
    jp, tp, ids = base
    jlo = _noisy(jlora.lora_init(jax.random.key(1), jp["blocks"], JLCFG))
    want = jax.jit(lambda p, i: jax_gpt2_apply(p, i, JCFG))(
        jlora.lora_merge_tree(jp, jlo, JLCFG), jnp.asarray(ids))
    got = gpt2_apply(lora_merge_tree(tp, _to_port(jlo), LCFG),
                     torch.tensor(ids).long(), CFG)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_adapter_shapes_and_count(base):
    jp, tp, _ = base
    lora = lora_init(torch.Generator().manual_seed(1), tp["blocks"], LCFG)
    q = lora["attn"]["qkv"]
    assert tuple(q["a"].shape) == (CFG.n_layer, CFG.n_embd, 4)
    assert tuple(q["b"].shape) == (CFG.n_layer, 4, 3 * CFG.n_embd)
    assert (q["b"] == 0).all()
    bound = 1.0 / CFG.n_embd ** 0.5
    assert float(q["a"].abs().max()) <= bound
    assert sorted(_flat(lora)) == sorted(
        ".".join(str(k.key) for k in path) for path, _ in
        jax.tree_util.tree_leaves_with_path(
            jlora.lora_init(jax.random.key(1), jp["blocks"], JLCFG)))
    n_base = sum(p.numel() for _, p in tree_leaves(tp))
    assert lora_param_count(lora) == jlora.lora_param_count(
        jlora.lora_init(jax.random.key(1), jp["blocks"], JLCFG))
    assert lora_param_count(lora) < 0.2 * n_base
    up = lora_upcast({k: {kk: v.to(torch.bfloat16) for kk, v in d.items()}
                      for k, d in lora["attn"].items()})
    assert all(v.dtype == torch.float32 for _, v in tree_leaves(up))


def test_lora_training_moves_only_adapters_and_follows_jax(base):
    """10 Adam steps (lr 1e-2) of adapters alone, the port's step against
    optax's on the same init: the first gradients and step match, the
    losses fall and match, the base is unchanged bit for bit."""
    jp, tp, ids = base
    jlo = jlora.lora_init(jax.random.key(1), jp["blocks"], JLCFG)
    lora = _to_port(jlo)
    before = _flat(tp)

    fwd = jlora.lora_wrap(lambda p, i: jax_gpt2_apply(p, i, JCFG), jp, JLCFG)
    opt = optax.adam(1e-2)
    st = opt.init(jlo)

    @jax.jit
    def jstep(lo, st):
        loss, g = jax.value_and_grad(
            lambda l: jax_clm_loss(fwd(l, ids), ids))(lo)
        up, st = opt.update(g, st, lo)
        return optax.apply_updates(lo, up), st, loss

    tfwd = lora_wrap(lambda p, i: gpt2_apply(p, i, CFG), tp, LCFG)
    topt = Optimizer("adam", 1e-2)
    tst = topt.init(lora)
    step = make_lora_train_step(
        None, lambda b, lo, batch: clm_loss(tfwd(lo, batch[0]), batch[1]),
        topt)
    t = torch.tensor(ids).long()
    # the first step's gradients, each leaf within 1e-5 of its largest
    # magnitude (later steps are held by the losses: a near-zero
    # gradient's sign is float noise, and Adam's g / (|g| + eps) moves
    # its parameter by lr either way)
    _, jg = jax.jit(jax.value_and_grad(
        lambda l: jax_clm_loss(fwd(l, ids), ids)))(jlo)
    for _, leaf in tree_leaves(lora):
        leaf.requires_grad_(True)
    _, tg = accumulate_grads(
        lambda lo, b, _g: clm_loss(tfwd(lo, b[0]), b[1]), lora, (t, t), 1)
    for k, v in lora_params_to_numpy_flat(jg).items():
        got_g = tg[tuple(k.split("."))].numpy()
        assert np.abs(got_g - v).max() <= 1e-5 * max(np.abs(v).max(),
                                                      1e-30), k
    init = lora_params_to_numpy_flat(jlo)
    jl, tl = [], []
    for i in range(10):
        jlo, st, loss = jstep(jlo, st)
        jl.append(float(loss))
        lora, tst, tloss = step(tp, lora, tst, (t, t))
        tl.append(float(tloss))
        if i == 0:
            # the first update as ``tests/_torch_mesh_checks.check_step``
            # holds it: what JAX moved by a whole lr (a gradient well
            # above eps) within 1e-5 of the leaf's largest magnitude,
            # the rest (Adam's g / (|g| + eps) of float noise) within
            # the update's bound, 2 lr
            got = _flat(lora)
            for k, v in lora_params_to_numpy_flat(jlo).items():
                sure = np.abs(v - init[k]) >= 0.99 * 1e-2
                diff = np.abs(got[k] - v)
                assert diff[sure].max(initial=0.0) <= 1e-5 * np.abs(
                    v).max(), k
                assert diff.max() <= 2e-2, k
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    got = _flat(lora)
    assert float(lora["attn"]["qkv"]["b"].detach().abs().max()) > 0.0
    assert all(np.array_equal(before[k], v) for k, v in _flat(tp).items())
    assert tst["count"] == 10 and set(_flat(tst["mu"])) == set(got)


def lora_params_to_numpy_flat(jlo):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jlo)}


def test_partition_specs_follow_weight_sharding():
    specs = lora_partition_specs(block_specs(tp_axis="tp", stacked=True),
                                 LCFG)
    assert specs["attn"]["qkv"]["a"] == (None, None, None)
    assert specs["attn"]["qkv"]["b"] == (None, None, "tp")
    assert specs["attn"]["proj"]["a"] == (None, "tp", None)
    assert specs["attn"]["proj"]["b"] == (None, None, None)
    assert specs["mlp"]["fc"]["b"] == (None, None, "tp")
    # a short spec pads to the weight's rank given the blocks
    w = {"fc": {"w": torch.zeros(2, 3, 4)}}
    assert lora_partition_specs({"fc": {"w": ("tp",)}}, LCFG, blocks=w) == {
        "fc": {"a": ("tp", None, None), "b": ("tp", None, None)}}


def test_merged_model_generates_jax_stream(base):
    jp, tp, _ = base
    jlo = _noisy(jlora.lora_init(jax.random.key(2), jp["blocks"], JLCFG), 3)
    ids = np.zeros((1, 4), np.int32)
    want = jax_generate(jlora.lora_merge_tree(jp, jlo, JLCFG), ids, JCFG,
                        max_new_tokens=6)
    got = gpt2_generate(lora_merge_tree(tp, _to_port(jlo), LCFG), ids, CFG,
                        max_new_tokens=6)
    assert got.shape == (1, 10)
    np.testing.assert_array_equal(got, want)


def test_save_load_roundtrip_and_across_packages(base, tmp_path):
    jp, tp, _ = base
    lora = _to_port(_noisy(jlora.lora_init(jax.random.key(3), jp["blocks"],
                                           JLCFG)))
    p = str(tmp_path / "port.safetensors")
    save_lora(lora, LCFG, p)
    back, cfg2 = load_lora(p, device="cpu")
    assert cfg2 == LCFG
    want = _flat(lora)
    assert set(_flat(back)) == set(want)
    for k, v in _flat(back).items():
        np.testing.assert_array_equal(v, want[k])
    # the port's file in JAX's reader
    jback, jcfg = jlora.load_lora(p)
    assert (jcfg.rank, jcfg.alpha, jcfg.targets) == (
        LCFG.rank, LCFG.alpha, LCFG.targets)
    for k, v in lora_params_to_numpy_flat(jback).items():
        np.testing.assert_array_equal(v, want[k])
    # JAX's file in the port's reader
    q = str(tmp_path / "jax.safetensors")
    jlora.save_lora(jback, jcfg, q)
    tback, tcfg = load_lora(q, device="cpu")
    assert tcfg == LCFG
    for k, v in _flat(tback).items():
        np.testing.assert_array_equal(v, want[k])


def test_roundtrip_bf16_and_llama_targets_across_packages(tmp_path):
    """bf16 factors keep their dtype and the seven Llama target names
    survive the comma-joined metadata, port -> JAX -> port."""
    from quintnet_tpu_torch.models.llama import LlamaConfig, llama_init

    params = llama_init(torch.Generator().manual_seed(0), LlamaConfig.tiny())
    blocks = {k: v for k, v in params["blocks"].items()}
    blocks = jax.tree.map(lambda t: t.to(torch.bfloat16), blocks)
    cfg = LoRAConfig(rank=2, alpha=4.0, targets=LLAMA_TARGETS)
    lora = lora_init(torch.Generator().manual_seed(1), blocks, cfg)
    gen = torch.Generator().manual_seed(7)
    for _, leaf in tree_leaves(lora):
        leaf.add_((torch.randn(leaf.shape, generator=gen) * 0.1).to(
            leaf.dtype))
    assert all(v.dtype == torch.bfloat16 for _, v in tree_leaves(lora))
    p = str(tmp_path / "llama.safetensors")
    save_lora(lora, cfg, p)
    jback, jcfg = jlora.load_lora(p)
    assert jcfg.targets == LLAMA_TARGETS
    assert all(v.dtype == jnp.bfloat16 for v in jax.tree.leaves(jback))
    q = str(tmp_path / "again.safetensors")
    jlora.save_lora(jback, jcfg, q)
    back, cfg2 = load_lora(q, device="cpu")
    assert cfg2 == cfg
    want = {k: v.view(torch.int16) for k, v in
            ((".".join(k), v) for k, v in tree_leaves(lora))}
    got = {".".join(k): v for k, v in tree_leaves(back)}
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v.view(torch.int16), want[k])


def test_config_validation():
    with pytest.raises(ValueError, match="rank"):
        LoRAConfig(rank=0)
    with pytest.raises(ValueError, match="rank"):
        LoRAConfig(rank=-3)
    with pytest.raises(ValueError, match=","):
        LoRAConfig(targets=("qkv", "fc,proj"))
    with pytest.raises(ValueError, match="non-empty"):
        LoRAConfig(targets=())
    with pytest.raises(ValueError, match="no LoRA targets"):
        lora_init(torch.Generator(), {"x": {"w": torch.zeros(2, 2)}},
                  LoRAConfig(targets=("q",)))
    with pytest.raises(ValueError, match="rank"):
        lora_params_to_numpy({"fc": {"a": torch.zeros(2, 3),
                                     "b": torch.zeros(2, 2)}})
    LoRAConfig(rank=1)


def test_lora_on_llama_family_follows_jax():
    """q/v adapters (classic LoRA) on Llama: zero init is the identity,
    and 8 Adam steps follow optax's on the same init."""
    from quintnet_tpu.models.llama import LlamaConfig as JaxLlamaConfig
    from quintnet_tpu.models.llama import llama_apply as jax_llama_apply
    from quintnet_tpu.models.llama import llama_init as jax_llama_init
    from quintnet_tpu_torch.models.llama import LlamaConfig, llama_apply

    jcfg, cfg = JaxLlamaConfig.tiny(), LlamaConfig.tiny()
    jp = jax_llama_init(jax.random.key(0), jcfg)
    tp = llama_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jl_cfg = jlora.LoRAConfig(rank=2, alpha=4.0,
                              targets=jlora.LLAMA_ATTN_TARGETS)
    l_cfg = LoRAConfig(rank=2, alpha=4.0, targets=LLAMA_ATTN_TARGETS)
    jlo = jlora.lora_init(jax.random.key(1), jp["blocks"], jl_cfg)
    lora = _to_port(jlo)
    assert set(lora["attn"]) == {"q", "v"}
    ids = np.random.default_rng(0).integers(0, 128, (2, 8)).astype(np.int32)
    t = torch.tensor(ids).long()
    np.testing.assert_allclose(
        llama_apply(lora_merge_tree(tp, lora, l_cfg), t, cfg).detach(),
        llama_apply(tp, t, cfg).detach(), rtol=1e-6, atol=1e-6)

    fwd = jlora.lora_wrap(lambda p, i: jax_llama_apply(p, i, jcfg), jp,
                          jl_cfg)
    opt = optax.adam(1e-2)
    st = opt.init(jlo)

    @jax.jit
    def jstep(lo, st):
        loss, g = jax.value_and_grad(
            lambda l: jax_clm_loss(fwd(l, ids), ids))(lo)
        up, st = opt.update(g, st, lo)
        return optax.apply_updates(lo, up), st, loss

    tfwd = lora_wrap(lambda p, i: llama_apply(p, i, cfg), tp, l_cfg)
    topt = Optimizer("adam", 1e-2)
    tst = topt.init(lora)
    step = make_lora_train_step(
        None, lambda b, lo, batch: clm_loss(tfwd(lo, batch[0]), batch[1]),
        topt)
    jl, tl = [], []
    for _ in range(8):
        jlo, st, loss = jstep(jlo, st)
        jl.append(float(loss))
        lora, tst, tloss = step(tp, lora, tst, (t, t))
        tl.append(float(tloss))
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_lora_on_vit_equals_jax():
    """The same adapters on ViT blocks (qkv/proj/fc names match): zero
    init is the identity, and a non-trivial merge's logits are JAX's."""
    from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
    from quintnet_tpu.models.vit import vit_apply as jax_vit_apply
    from quintnet_tpu.models.vit import vit_init as jax_vit_init
    from quintnet_tpu_torch.models.vit import ViTConfig, vit_apply

    kw = dict(image_size=14, patch_size=7, in_channels=1, hidden_dim=16,
              depth=2, num_heads=2, num_classes=10)
    jcfg, cfg = JaxViTConfig(**kw), ViTConfig(**kw)
    jp = jax_vit_init(jax.random.key(0), jcfg)
    tp = vit_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(0).normal(size=(4, 14, 14, 1)).astype(
        np.float32)
    lcfg = LoRAConfig(rank=2, alpha=4.0)
    jl_cfg = jlora.LoRAConfig(rank=2, alpha=4.0)
    zero = _to_port(jlora.lora_init(jax.random.key(1), jp["blocks"],
                                    jl_cfg))
    tx = torch.tensor(x)
    np.testing.assert_allclose(
        vit_apply(lora_merge_tree(tp, zero, lcfg), tx, cfg).detach(),
        vit_apply(tp, tx, cfg).detach(), rtol=1e-6, atol=1e-6)
    jlo = _noisy(jlora.lora_init(jax.random.key(1), jp["blocks"], jl_cfg))
    want = jax.jit(lambda p, v: jax_vit_apply(p, v, jcfg))(
        jlora.lora_merge_tree(jp, jlo, jl_cfg), jnp.asarray(x))
    got = vit_apply(lora_merge_tree(tp, _to_port(jlo), lcfg), tx, cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------
# dp x tp = 2 x 2: one gloo world
# ---------------------------------------------------------------------

SHARDED = dict(rank=4, alpha=8.0, targets=("proj", "fc"))


@pytest.fixture(scope="module")
def sharded(base, tmp_path_factory):
    jp, _, ids = base
    jl_cfg = jlora.LoRAConfig(**SHARDED)
    jlo0 = jlora.lora_init(jax.random.key(11), jp["blocks"], jl_cfg)
    noisy = _noisy(jlora.lora_init(jax.random.key(5), jp["blocks"], jl_cfg))
    ranks = run_world(lora_world_case, 4, tmp_path_factory.mktemp("lora"),
                      jax.tree.map(np.asarray, jp), GPT2_KW,
                      {"merge": jax.tree.map(np.asarray, noisy),
                       "train": jax.tree.map(np.asarray, jlo0)},
                      SHARDED, ids, 3, 1e-2)
    return jl_cfg, jlo0, noisy, ranks


def test_tp_shard_local_merge_matches_single_device(base, sharded):
    jp, _, ids = base
    jl_cfg, _, noisy, ranks = sharded
    want = jax.jit(lambda p, i: jax_gpt2_apply(p, i, JCFG))(
        jlora.lora_merge_tree(jp, noisy, jl_cfg), jnp.asarray(ids))
    for r in ranks:
        np.testing.assert_allclose(r["merged_logits"], np.asarray(want),
                                   rtol=2e-4, atol=1e-5)


def test_sharded_lora_training_matches_single_device(base, sharded):
    jp, _, ids = base
    jl_cfg, lo, _, ranks = sharded
    fwd = jlora.lora_wrap(lambda p, i: jax_gpt2_apply(p, i, JCFG), jp,
                          jl_cfg)
    opt = optax.adam(1e-2)
    st = opt.init(lo)

    @jax.jit
    def ref_step(lo, st):
        loss, g = jax.value_and_grad(
            lambda l: jax_clm_loss(fwd(l, ids), ids))(lo)
        up, st = opt.update(g, st, lo)
        return optax.apply_updates(lo, up), st, loss

    ref_losses = []
    for _ in range(3):
        lo, st, loss = ref_step(lo, st)
        ref_losses.append(float(loss))
    want = lora_params_to_numpy_flat(lo)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=1e-5)
        assert set(r["lora"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["lora"][k], v, rtol=2e-4,
                                       atol=1e-5)
        assert r["base_unchanged"]
        assert r["moments"] == sorted(want)
