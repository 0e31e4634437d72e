"""ZeRO-3 / FSDP in the port (``training.fsdp``) on gloo CPU worlds,
against the JAX package and the single-device port.

The counterparts of ``tests/test_fsdp.py``: the spec transform and the
gather dims against JAX's ``fsdp_shard_specs`` / ``fsdp_gather_dims`` /
``fsdp_info`` on the GPT-2 and ViT specs; the tiny GPT-2 (2 layers, 4
heads, 32 wide) AdamW step with clipping under fsdp on dp = 2 (a world
of 2 ranks) and on the dry run's dp x tp = 4 x 2 (a world of 8), each
against JAX's fsdp step on the same mesh shape AND the single-device
port's step (``_torch_mesh_checks.check_step``: the loss within 1e-5
relative, every element of the gathered first moment within 1e-5 of its
leaf's largest magnitude, the gathered parameters the same way where
Adam moved them surely and within 2 lr elsewhere); every rank holding
1/dp of each shardable block leaf and of its Adam moment; SGD steps
(lr 0.05) under fsdp against the single-device port (loss ``rtol=1e-5``,
parameters ``rtol=2e-4, atol=1e-5``, test_fsdp.py's own bounds): with
gradient accumulation, with ``remat=True`` (equal to the plain fsdp step
within ``rtol=1e-5, atol=1e-6``) and for the tiny ViT (its loss also
against JAX's); ``Trainer.fit`` with evaluation under fsdp against the
single-device Trainer; and JAX's three guards with JAX's exception types
and messages. The other families (``test_fsdp.py``'s
``test_fsdp_llama_and_vit_match_single_device`` and
``test_fsdp_moe_ep_matches_single_device``): the tiny Llama's SGD step
under fsdp on dp = 2 against JAX's single-device step (loss
``rtol=1e-5``, parameters ``rtol=2e-4, atol=1e-5``), and the MoE GPT-2's
on dp x ep = 4 x 2 (the 8-rank world; its expert leaves carry ep AND an
fsdp dim) against JAX's single-device loss at ``rtol=1e-4``, the JAX
test's, with the spec transform of every family against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from _torch_dist import run_world
from _torch_dist_cases import (VIT_TINY, fsdp_dp2_world_case,
                               fsdp_dp4tp2_world_case, fsdp_sgd_step)
from _torch_mesh_checks import check_gpt2_steps, check_step
from _torch_mesh_checks import port_single_gpt2_step
from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2 import gpt2_model_spec as jax_gpt2_spec
from quintnet_tpu.models.gpt2 import \
    gpt2_partition_specs as jax_gpt2_specs
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.models.vit import vit_model_spec as jax_vit_spec
from quintnet_tpu.models import llama as jl
from quintnet_tpu.models.vit import vit_partition_specs as jax_vit_specs
from quintnet_tpu.parallel import tp as jtp
from quintnet_tpu.parallel.strategy import get_strategy as jax_get_strategy
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_model_spec,
                                            gpt2_partition_specs,
                                            gpt2_to_tp_layout)
from quintnet_tpu_torch.models.vit import ViTConfig, vit_partition_specs
from quintnet_tpu_torch.parallel import tp as tpl
from quintnet_tpu_torch.parallel.strategy import get_strategy
from quintnet_tpu_torch.train.trainer import Trainer

GPT2_KW = {"n_layer": 2}
FSDP = {"fsdp": True}
DP2_RUN = ([2], ["dp"], 1, FSDP)
DPTP_RUN = ([4, 2], ["dp", "tp"], 1, FSDP)       # __graft_entry__'s dry run
VIT_KW = dict(VIT_TINY)
MOE_KW = dict(GPT2_KW, n_experts=4, expert_top_k=2, expert_capacity=4096,
              aux_loss_weight=0.0)
SGD = {"optimizer": "sgd", "learning_rate": 0.05, "grad_clip_norm": None,
       "fsdp": True}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


def _gpt2_batch(B=8, S=16, seed=3):
    ids = np.random.default_rng(seed).integers(0, 128, (B, S))
    return ids.astype(np.int64), ids.astype(np.int64)


def _vit_batch():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((8, 14, 14, 1)).astype(np.float32),
            rng.integers(0, 10, (8,)).astype(np.int64))


@pytest.fixture(scope="module")
def inputs():
    gpt2 = jax.tree.map(np.asarray, jax_gpt2_init(
        jax.random.key(0), JaxGPT2Config.tiny(**GPT2_KW)))
    vit = jax.tree.map(np.asarray, jax_vit_init(
        jax.random.key(0), JaxViTConfig(**VIT_KW)))
    ids, labels = _gpt2_batch()
    x, y = _vit_batch()
    llama = jax.tree.map(np.asarray, jl.llama_init(
        jax.random.key(0), jl.LlamaConfig.tiny()))
    moe = jax.tree.map(np.asarray, jax_gpt2_init(
        jax.random.key(0), JaxGPT2Config.tiny(**MOE_KW)))
    return {"gpt2": gpt2, "vit": vit, "ids": ids, "labels": labels,
            "x": x, "y": y, "llama": llama, "moe": moe,
            "sgd": {"plain": ("gpt2", GPT2_KW, gpt2, ids, labels, 1, False),
                    "remat": ("gpt2", GPT2_KW, gpt2, ids, labels, 1, True),
                    "acc2": ("gpt2", GPT2_KW, gpt2, ids, labels, 2, False),
                    "vit": ("vit", VIT_KW, vit, x, y, 1, False)},
            "trainer": (gpt2, [_gpt2_batch(seed=s) for s in (4, 5)],
                        _gpt2_batch(B=4, seed=6))}


@pytest.fixture(scope="module")
def dp2(inputs, tmp_path_factory):
    ids = inputs["ids"]
    jobs = {"llama": ("steps", ("llama", {}, inputs["llama"], ids, ids,
                                {"dp": 2}), {"training": SGD})}
    return run_world(fsdp_dp2_world_case, 2, tmp_path_factory.mktemp("f2"),
                     (inputs["gpt2"], inputs["ids"], inputs["labels"],
                      [DP2_RUN]), inputs["sgd"], inputs["trainer"], jobs,
                     timeout=240)


@pytest.fixture(scope="module")
def dptp(inputs, tmp_path_factory):
    ids = inputs["ids"]
    jobs = {"moe": ("steps", ("gpt2", MOE_KW, inputs["moe"], ids, ids,
                              {"dp": 4, "ep": 2}), {"training": SGD})}
    return run_world(fsdp_dp4tp2_world_case, 8, tmp_path_factory.mktemp(
        "f8"), (inputs["gpt2"], inputs["ids"], inputs["labels"],
                [DPTP_RUN]), jobs, timeout=240)


def _tuples(jax_specs):
    return jax.tree.map(tuple, jax_specs,
                        is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("family", ["gpt2", "vit"])
@pytest.mark.parametrize("tp_axis", ["tp", None])
def test_spec_transform_and_gather_dims_match_jax(family, tp_axis):
    """The first free dim >= 1 gets the axis (a leaf with none stays
    replicated), and the per-layer gather dims and ``fsdp_info`` come from
    the same specs, as JAX's."""
    if family == "gpt2":
        port = gpt2_partition_specs(GPT2Config.tiny(), tp_axis=tp_axis,
                                    fsdp_axis="dp")
        jspec = jax_gpt2_specs(JaxGPT2Config.tiny(), tp_axis=tp_axis,
                               fsdp_axis="dp")
        fn = gpt2_partition_specs
    else:
        port = vit_partition_specs(ViTConfig(**VIT_KW), tp_axis=tp_axis,
                                   fsdp_axis="dp")
        jspec = jax_vit_specs(JaxViTConfig(**VIT_KW), tp_axis=tp_axis,
                              fsdp_axis="dp")
        fn = vit_partition_specs
    assert port == _tuples(jspec)
    assert tpl.fsdp_gather_dims(port["blocks"], "dp") == \
        jtp.fsdp_gather_dims(jspec["blocks"], "dp")
    axis, dims = tpl.fsdp_info(fn, "dp", tp_axis=tp_axis)
    assert axis == "dp" and dims == jtp.fsdp_gather_dims(jspec["blocks"],
                                                         "dp")
    assert tpl.fsdp_info(fn, None, tp_axis=tp_axis) is None
    if family == "gpt2" and tp_axis == "tp":          # test_fsdp.py's
        b = port["blocks"]
        assert b["attn"]["qkv"]["w"] == (None, "dp", "tp")
        assert b["attn"]["proj"]["w"] == (None, "tp", "dp")
        assert b["attn"]["qkv"]["b"] == (None, "tp")    # no free dim
        assert port["embedding"]["wte"] == ()


@pytest.mark.parametrize("mesh", ["dp2", "dp4_tp2"])
def test_fsdp_adamw_step_matches_jax_and_single_device(inputs, dp2, dptp,
                                                       mesh):
    ranks, run = ((dp2, DP2_RUN) if mesh == "dp2" else (dptp, DPTP_RUN))
    gathered = [r["gpt2"] for r in ranks]
    check_gpt2_steps(gathered, inputs["gpt2"], inputs["ids"],
                     inputs["labels"], [run])
    loss, want, want_mu = port_single_gpt2_step(
        inputs["gpt2"], inputs["ids"], inputs["labels"])
    tp = dict(zip(run[1], run[0])).get("tp", 1)
    cfg = GPT2Config.tiny(**GPT2_KW)
    lay = lambda d: {k: v for k, v in _flat(gpt2_to_tp_layout(  # noqa: E731
        _nest(d), cfg, tp))}
    before = dict(_flat(gpt2_to_tp_layout(inputs["gpt2"], cfg, tp)))
    for r, out in enumerate(gathered):
        assert out[0]["fsdp_axis"] == "dp"
        check_step((mesh, r), out[0], loss, lay(want), lay(want_mu), before)


def _nest(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split(".")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


@pytest.mark.parametrize("mesh", ["dp2", "dp4_tp2"])
def test_params_and_moments_are_sharded(inputs, dp2, dptp, mesh):
    """Each rank holds 1/dp of every block leaf whose spec names dp, and
    Adam's moment of it sharded the same way; a leaf with no free dim
    (the tp-sharded biases) stays whole."""
    ranks, dp = (([r["gpt2"] for r in dp2], 2) if mesh == "dp2"
                 else ([r["gpt2"] for r in dptp], 4))
    full = dict(_flat(inputs["gpt2"]))
    tp = 2 if mesh == "dp4_tp2" else 1
    sharded = 0
    for out in ranks:
        run = out[0]
        for k, (n_param, n_mu) in run["local_numel"].items():
            spec = run["specs"][k]
            split = (dp if "dp" in spec else 1) * (tp if "tp" in spec else 1)
            assert n_param * split == full[k].size, k
            assert n_mu == n_param, k
            sharded += "dp" in spec
    assert sharded >= 0.75 * len(ranks) * len(ranks[0][0]["local_numel"])


@pytest.mark.parametrize("tag", ["plain", "acc2", "vit"])
def test_fsdp_sgd_step_matches_single_device(inputs, dp2, tag):
    """SGD under fsdp on dp = 2 == the single-device port: the plain
    step, micro-batch accumulation (each rank's 4 rows in 2 micro-batches
    against 8 rows in 4 on one device) and the ViT (its loss also against
    JAX's on the same weights)."""
    name, kw, np_params, x, y, accum, remat = inputs["sgd"][tag]
    want = fsdp_sgd_step(name, kw, np_params, x, y, accum * 2, remat)
    for r in dp2:
        got = r[tag]
        assert got["fsdp_axis"] == "dp"
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert set(got["params"]) == set(want["params"])
        for k, w in want["params"].items():
            np.testing.assert_allclose(got["params"][k], w, rtol=2e-4,
                                       atol=1e-5, err_msg=f"{tag}:{k}")
    if tag == "vit":
        jmodel = jax_vit_spec(JaxViTConfig(**VIT_KW))
        jloss = jmodel.loss_fn(jax.tree.map(jnp.asarray, np_params),
                               (jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(dp2[0][tag]["loss"], float(jloss),
                                   rtol=1e-5)


def test_fsdp_remat_matches_plain(dp2):
    """The gather sits inside the checkpointed body: backward gathers
    again, and the step equals the plain fsdp step."""
    for r in dp2:
        plain, remat = r["plain"], r["remat"]
        np.testing.assert_allclose(remat["loss"], plain["loss"], rtol=1e-6)
        for k, w in plain["params"].items():
            np.testing.assert_allclose(remat["params"][k], w, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_fsdp_trainer_fit_and_eval_match_single_device(inputs, dp2):
    """``Trainer.fit`` (2 epochs of one batch, SGD with clipping) and its
    evaluation under fsdp == the single-device Trainer."""
    gpt2, batches, val = inputs["trainer"]
    config = Config.from_dict({"training": {
        "optimizer": "sgd", "learning_rate": 0.1, "grad_clip_norm": 1.0,
        "log_every": 1, "seed": 0}})
    tr = Trainer(config, gpt2_model_spec(GPT2Config.tiny(**GPT2_KW)),
                 task_type="clm", device="cpu", log_fn=lambda m: None)
    params = tree_map(lambda t: t.requires_grad_(True),
                      gpt2_params_from_numpy(gpt2, "cpu"))
    hist = tr.fit(lambda ep: [batches[ep]], epochs=2, params=params,
                  opt_state=tr.optimizer.init(params),
                  val_batches_fn=lambda ep: [val])
    want = {".".join(k): v.detach().numpy()
            for k, v in tree_leaves(tr.final_state[0])}
    for r in dp2:
        out = r["trainer"]
        assert out["fsdp_axis"] == "dp" and out["strategy"] == "dp"
        np.testing.assert_allclose(out["train_loss"], hist.train_loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(out["val_loss"], hist.val_loss, rtol=1e-5)
        for k, w in want.items():
            assert np.abs(out["params"][k] - w).max() <= \
                1e-5 * np.abs(w).max(), k


# config -> (the port's get_strategy name, JAX's), each one-process
# check: JAX raises in make_train_step, the port before any process
# group is touched, with the same type and message
GUARDS = {
    "no_dp_axis": ({"mesh_dim": [2], "mesh_name": ["tp"]}, "tp",
                   ValueError),
    "under_pp": ({"mesh_dim": [2, 2], "mesh_name": ["dp", "pp"],
                  "training": {"gradient_accumulation_steps": 2}},
                 "dp_pp", NotImplementedError),
    "with_zero1": ({"mesh_dim": [2], "mesh_name": ["dp"],
                    "training": {"optimizer": "zero1_adamw"}}, "dp",
                   ValueError),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_fsdp_guards_match_jax(case):
    d, name, exc = GUARDS[case]
    d = dict(d, training={"batch_size": 8, "fsdp": True,
                          **d.get("training", {})})
    with pytest.raises(exc) as want:
        jax_get_strategy(name, JaxConfig.from_dict(d)).make_train_step(
            jax_gpt2_spec(JaxGPT2Config.tiny()), optax.adamw(1e-3))
    with pytest.raises(exc) as got:
        get_strategy(name, Config.from_dict(d))
    assert str(got.value) == str(want.value)


def test_fsdp_llama_and_vit_match_single_device(inputs, dp2):
    """The Llama under fsdp on dp = 2 (the ViT's half is the ``vit`` case
    of :func:`test_fsdp_sgd_step_matches_single_device`): the step ==
    JAX's single-device SGD step, loss and parameters."""
    jp = jax.tree.map(jnp.asarray, inputs["llama"])
    x = jnp.asarray(inputs["ids"])
    model = jl.llama_model_spec(jl.LlamaConfig.tiny())
    loss, g = jax.value_and_grad(model.loss_fn)(jp, (x, x))
    want = dict(_flat(jax.tree.map(lambda p, d: np.asarray(p - 0.05 * d),
                                   jp, g)))
    for r in dp2:
        got = r["llama"]
        assert got["strategy"] == "dp" and got["fsdp_axis"] == "dp"
        assert got["specs"]["blocks.attn.q.w"] == (None, "dp", None)
        np.testing.assert_allclose(got["losses"], [float(loss)], rtol=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=2e-4,
                                       atol=1e-5, err_msg=k)


def test_fsdp_moe_ep_matches_single_device(inputs, dptp):
    """fsdp composes with expert parallelism: every expert leaf carries
    ep AND an fsdp dim, and the step's loss == JAX's single device."""
    x = jnp.asarray(inputs["ids"])
    ref = jax_gpt2_spec(JaxGPT2Config.tiny(**MOE_KW)).loss_fn(
        jax.tree.map(jnp.asarray, inputs["moe"]), (x, x))
    for r in dptp:
        got = r["moe"]
        assert got["strategy"] == "dp_ep" and got["fsdp_axis"] == "dp"
        assert got["specs"]["blocks.moe.w1"] == (None, "ep", "dp", None)
        np.testing.assert_allclose(got["losses"], [float(ref)], rtol=1e-4)


@pytest.mark.parametrize("tp_axis", ["tp", None])
def test_moe_and_llama_spec_transforms_match_jax(tp_axis):
    """The fsdp spec transform of the MoE GPT-2 (experts over ep) and of
    the Llama (dense and MoE) blocks, as JAX's."""
    from quintnet_tpu_torch.models.llama import (LlamaConfig,
                                                 llama_partition_specs)

    port = gpt2_partition_specs(GPT2Config.tiny(**MOE_KW), tp_axis=tp_axis,
                                ep_axis="ep", fsdp_axis="dp")
    jspec = jax_gpt2_specs(JaxGPT2Config.tiny(**MOE_KW), tp_axis=tp_axis,
                           ep_axis="ep", fsdp_axis="dp")
    assert port == _tuples(jspec)
    for kw in ({}, {"n_experts": 4}):
        port = llama_partition_specs(LlamaConfig.tiny(**kw), tp_axis=tp_axis,
                                     ep_axis="ep", fsdp_axis="dp")
        jspec = jl.llama_partition_specs(jl.LlamaConfig.tiny(**kw),
                                         tp_axis=tp_axis, ep_axis="ep",
                                         fsdp_axis="dp")
        assert port == _tuples(jspec)
