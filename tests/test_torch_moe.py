"""The port's Mixture-of-Experts layer and expert parallelism
(``nn/moe.py``, the ``ep`` strategies) against the JAX package.

The counterparts of every test of ``tests/test_moe.py``, on the same
seeds and shapes: the layer on ep = 4 and on ep x tp = 2 x 2 (a world
of 4 gloo CPU ranks) against the JAX layer on one device (capacity so
that nothing drops; ``rtol=1e-5, atol=1e-5``, the JAX tests' own);
capacity drops and the aux loss (and its router gradient) against
JAX's; tiny GPT-2-MoE SGD steps (lr 0.05) on ep = 4, dp x ep, ep x tp
and ep x pp (both schedules) against JAX's single-device steps (losses
``rtol=1e-5``, parameters ``rtol=2e-4, atol=1e-5``); the aux loss
through AFAB and 1F1B on pp = 2 against JAX's single device with the
same micro-batches (GPT-2 and ViT); ``Trainer.fit`` with evaluation on
dp x ep; ZeRO-1 AdamW on dp x ep against plain AdamW on the same mesh
(``rtol=1e-6, atol=1e-7``) and its loss against JAX's; expert choice
(one expert is a weighted dense FFN, ep = 2 against one device at
``rtol=2e-5, atol=1e-6``, training lowers the loss, the causal configs
refuse it, the ViT on dp x ep); and routing exactly as JAX routes on a
router whose probabilities tie (``lax.top_k`` puts the lower index
first), including which assignments the capacity cut drops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist import run_world
from _torch_dist_cases import jobs_world_case
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2 import gpt2_model_spec as jax_gpt2_spec
from quintnet_tpu.models.gpt2 import \
    gpt2_upcycle_to_moe as jax_gpt2_upcycle
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.models.vit import vit_model_spec as jax_vit_spec
from quintnet_tpu.nn import moe as jmoe
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                            gpt2_model_spec,
                                            gpt2_to_tp_layout,
                                            gpt2_upcycle_to_moe)
from quintnet_tpu_torch.models.llama import LlamaConfig
from quintnet_tpu_torch.nn import moe

D, H, E = 16, 32, 8
TINY_KW = dict(n_layer=2, n_experts=4, expert_top_k=2, expert_capacity=4096,
               aux_loss_weight=0.0)
PP_KW = dict(n_layer=4, n_experts=4, expert_top_k=2, expert_capacity=4096,
             aux_loss_weight=1e-2)
EP_PP_KW = dict(PP_KW, aux_loss_weight=0.0)
VIT_PP_KW = dict(image_size=14, patch_size=7, in_channels=1, hidden_dim=16,
                 depth=4, num_heads=2, num_classes=10, n_experts=4,
                 expert_top_k=2, expert_capacity=4096, aux_loss_weight=1e-2)
VIT_EC_KW = dict(image_size=14, patch_size=7, in_channels=1, hidden_dim=16,
                 depth=2, num_heads=2, num_classes=10, n_experts=4,
                 router_type="expert_choice", expert_capacity=4096,
                 aux_loss_weight=0.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _x(seed, b, t, d=D):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(
        np.float32)


def _ids(seed=0, b=8, t=16, v=128):
    ids = np.random.default_rng(seed).integers(0, v, (b, t))
    return ids.astype(np.int64)


_REFS = {}


def _jax_sgd(jmodel, params, batch, steps=1, n_micro=None, lr=0.05,
             key=None):
    """JAX's single-device SGD steps (tests/test_moe.py's references):
    the step losses and the parameters after, flat. ``n_micro``: the loss
    is the mean over that many micro-batches (the pipelines' objective).
    ``key``: computed once a module, for the cases that share it."""
    if key is not None:
        if key not in _REFS:
            _REFS[key] = _jax_sgd(jmodel, params, batch, steps, n_micro, lr)
        return _REFS[key]
    x, y = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        if n_micro is None:
            return jmodel.loss_fn(p, (x, y))
        k = len(x) // n_micro
        return jnp.mean(jnp.stack([
            jmodel.loss_fn(p, (x[i * k:(i + 1) * k], y[i * k:(i + 1) * k]))
            for i in range(n_micro)]))

    opt = optax.sgd(lr)
    state, losses = opt.init(params), []
    vg = jax.jit(jax.value_and_grad(loss_fn))
    for _ in range(steps):
        loss, g = vg(params)
        up, state = opt.update(g, state, params)
        params = optax.apply_updates(params, up)
        losses.append(float(loss))
    return losses, dict(_flat(_np_tree(params)))


def _close(got, want, rtol=2e-4, atol=1e-5):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=k)


def _jax_gpt2(kw, seed=0):
    return _np_tree(jax_gpt2_init(jax.random.key(seed),
                                  JaxGPT2Config.tiny(**kw)))


# ---------------------------------------------------------------------
# the worlds (one of 4 ranks, one of 2) and their JAX references
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    layer = _np_tree(jmoe.moe_init(jax.random.key(0), D, H, E))
    ec = _np_tree(jmoe.moe_init(jax.random.key(1), D, H, 4))
    vit_pp = _np_tree(jax_vit_init(jax.random.key(0),
                                   JaxViTConfig(**VIT_PP_KW)))
    vit_ec = _np_tree(jax_vit_init(jax.random.key(0),
                                   JaxViTConfig(**VIT_EC_KW)))
    rng = np.random.default_rng(5)
    vx = rng.normal(size=(8, 14, 14, 1)).astype(np.float32)
    vy = rng.integers(0, 10, (8,)).astype(np.int64)
    return {"layer": layer, "x": _x(1, 8, 4), "ec": ec,
            "ec_x": _x(2, 2, 16), "gpt2": _jax_gpt2(TINY_KW),
            "gpt2_pp": _jax_gpt2(PP_KW), "gpt2_ep_pp": _jax_gpt2(EP_PP_KW),
            "ids": _ids(), "vit_pp": vit_pp, "vit_ec": vit_ec, "vx": vx,
            "vy": vy}


def _w4_jobs(i):
    ids = i["ids"]
    def steps(kw, p, sizes, **k):
        return ("steps", ("gpt2", kw, p, ids, ids, sizes), k)

    return {
        "layer_ep4": ("layer", ({"ep": 4}, i["layer"], i["x"],
                                dict(n_experts=E, top_k=2,
                                     capacity=(8 // 4) * 4 * 2)), {}),
        "layer_ep2_tp2": ("layer", ({"ep": 2, "tp": 2}, i["layer"], i["x"],
                                    dict(n_experts=E, top_k=2,
                                         capacity=(8 // 2) * 4 * 2)),
                          {"tp": True}),
        "ep": steps(TINY_KW, i["gpt2"], {"ep": 4}, steps=2),
        "dp_ep": steps(TINY_KW, i["gpt2"], {"dp": 2, "ep": 2}, steps=2),
        "ep_tp": steps(TINY_KW, i["gpt2"], {"ep": 2, "tp": 2}, steps=2),
        **{f"ep_pp_{s}": steps(EP_PP_KW, i["gpt2_ep_pp"],
                               {"ep": 2, "pp": 2}, training={
                                   "schedule": s,
                                   "gradient_accumulation_steps": 2})
           for s in ("afab", "1f1b")},
        "trainer": ("trainer", (dict(n_layer=2, n_experts=4), ids,
                                {"dp": 2, "ep": 2}), {}),
        **{f"zero_{o}": steps(TINY_KW, i["gpt2"], {"dp": 2, "ep": 2},
                              training={"optimizer": o,
                                        "learning_rate": 1e-3})
           for o in ("adamw", "zero1_adamw")},
        "vit_ec": ("steps", ("vit", VIT_EC_KW, i["vit_ec"], i["vx"], i["vy"],
                             {"dp": 2, "ep": 2}),
                   {"training": {"optimizer": "adam",
                                 "learning_rate": 1e-2}, "more": 9}),
    }


def _w2_jobs(i):
    ids = i["ids"]
    jobs = {"layer_ec_ep2": ("layer", ({"ep": 2}, i["ec"], i["ec_x"],
                                       dict(n_experts=4, top_k=2, capacity=8,
                                            router="expert_choice",
                                            aux_weight=0.0)),
                             {"replicated_x": True})}
    for s in ("afab", "1f1b"):
        pp = {"schedule": s, "gradient_accumulation_steps": 2}
        jobs[f"gpt2_pp_{s}"] = ("steps", ("gpt2", PP_KW, i["gpt2_pp"], ids,
                                          ids, {"pp": 2}), {"training": pp})
        jobs[f"vit_pp_{s}"] = ("steps", ("vit", VIT_PP_KW, i["vit_pp"],
                                         i["vx"], i["vy"], {"pp": 2}),
                               {"training": pp})
    return jobs


@pytest.fixture(scope="module")
def w4(inputs, tmp_path_factory):
    return run_world(jobs_world_case, 4, tmp_path_factory.mktemp("m4"),
                     _w4_jobs(inputs), timeout=300)


@pytest.fixture(scope="module")
def w2(inputs, tmp_path_factory):
    return run_world(jobs_world_case, 2, tmp_path_factory.mktemp("m2"),
                     _w2_jobs(inputs), timeout=300)


def _ep_rows(ranks, tag):
    """A layer case's output rows put back together in ep order (the
    ranks of one ep coordinate agree)."""
    by = {}
    for r in ranks:
        y, c = r[tag]
        if c in by:
            np.testing.assert_array_equal(by[c], y)
        by[c] = y
    return np.concatenate([by[c] for c in sorted(by)])


# ---------------------------------------------------------------------
# layer goldens
# ---------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["layer_ep4", "layer_ep2_tp2"])
def test_moe_ep_matches_single_device(inputs, w4, tag):
    """ep = 4 and ep x tp = 2 x 2 layers == the JAX layer on one device
    (capacity ample on both sides: nothing drops)."""
    args = jmoe.MoEArgs(n_experts=E, top_k=2, capacity=8 * 4 * 2)
    y_ref, _ = jmoe.moe_apply(jax.tree.map(jnp.asarray, inputs["layer"]),
                              jnp.asarray(inputs["x"]), args)
    np.testing.assert_allclose(_ep_rows(w4, tag), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("expert_type", ["mlp", "swiglu"])
@pytest.mark.parametrize("capacity", [1, 3, None])
def test_moe_layer_and_grads_match_jax(expert_type, capacity):
    """One device: output, aux loss and every gradient against JAX's, at
    capacities that drop (1, 3) and the factor's (None)."""
    jp = jmoe.moe_init(jax.random.key(4), D, H, E, expert_type=expert_type)
    x = _x(3, 4, 4)
    args = dict(n_experts=E, top_k=2, capacity=capacity, aux_weight=1e-2,
                z_weight=1e-3)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jmoe.MoEArgs(**args))
        return jnp.sum(y * jnp.cos(y)) + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(),
                     jp)
    xt = torch.tensor(x).requires_grad_()
    y, aux = moe.moe_apply(p, xt, moe.MoEArgs(**args))
    ((y * torch.cos(y)).sum() + aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    for k, g in _flat(_np_tree(jg)):
        got = p
        for part in k.split("."):
            got = got[part]
        np.testing.assert_allclose(got.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_moe_capacity_drops_are_safe():
    params = _t(jmoe.moe_init(jax.random.key(0), D, H, E))
    x = torch.tensor(_x(0, 4, 4))
    y, aux = moe.moe_apply(params, x, moe.MoEArgs(n_experts=E, top_k=2,
                                                  capacity=1))
    assert torch.isfinite(y).all() and torch.isfinite(aux)
    _, _, stats = moe.moe_apply(params, x, moe.MoEArgs(
        n_experts=E, top_k=2, capacity=1), return_stats=True)
    assert float(stats["dropped"]) > 0
    assert float(stats["expert_tokens"].sum()) == 4 * 4 * 2


def test_moe_aux_loss_positive_and_differentiable():
    jp = jmoe.moe_init(jax.random.key(0), D, H, E)
    x = _x(0, 4, 4)
    args = dict(n_experts=E, top_k=2, aux_weight=1e-2, z_weight=1e-3)
    jaux, jg = jax.value_and_grad(lambda p: jmoe.moe_apply(
        p, jnp.asarray(x), jmoe.MoEArgs(**args))[1])(jp)
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(),
                     jp)
    aux = moe.moe_apply(p, torch.tensor(x), moe.MoEArgs(**args))[1]
    aux.backward()
    assert float(aux.detach()) > 0.0
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    gr = p["router"]["w"].grad.numpy()
    assert np.isfinite(gr).all() and np.abs(gr).sum() > 0.0
    np.testing.assert_allclose(gr, np.asarray(jg["router"]["w"]), rtol=1e-4,
                               atol=1e-8)


@pytest.mark.parametrize("capacity", [2, 5])
def test_tied_router_routes_as_jax(capacity):
    """A zero router: every probability ties. lax.top_k puts the lower
    index first; the port routes, cuts at capacity and combines exactly
    as JAX does."""
    jp = jmoe.moe_init(jax.random.key(2), D, H, E)
    jp = {**jp, "router": {"w": jnp.zeros_like(jp["router"]["w"])}}
    x = _x(7, 2, 8)
    args = dict(n_experts=E, top_k=2, capacity=capacity)
    jy, _, jst = jmoe.moe_apply(jp, jnp.asarray(x), jmoe.MoEArgs(**args),
                                return_stats=True)
    y, _, st = moe.moe_apply(_t(jp), torch.tensor(x), moe.MoEArgs(**args),
                             return_stats=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    assert float(st["dropped"]) == float(jst["dropped"]) > 0
    np.testing.assert_array_equal(st["expert_tokens"].numpy(),
                                  np.asarray(jst["expert_tokens"]))
    v, i = moe._route(torch.full((3, E), 1.0 / E), 2)
    assert i.tolist() == [[0, 1]] * 3


# ---------------------------------------------------------------------
# full-model goldens: strategy plumbing, gradient reduction over ep
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ep", "dp_ep", "ep_tp"])
def test_gpt2_moe_strategy_matches_single_device(inputs, w4, name):
    ids = inputs["ids"]
    jparams = jax.tree.map(jnp.asarray, inputs["gpt2"])
    losses_ref, p_ref = _jax_sgd(jax_gpt2_spec(JaxGPT2Config.tiny(**TINY_KW)),
                                 jparams, (ids, ids), steps=2, key="tiny")
    tp = 2 if name == "ep_tp" else 1
    want = dict(_flat(gpt2_to_tp_layout(_nest(p_ref), GPT2Config.tiny(
        **TINY_KW), tp)))
    for r in w4:
        got = r[name]
        assert got["strategy"] == name
        np.testing.assert_allclose(got["losses"], losses_ref, rtol=1e-5)
        _close(got["params"], want)
        assert got["specs"]["blocks.moe.w1"][1] == "ep"


@pytest.mark.parametrize("schedule", ["afab", "1f1b"])
def test_gpt2_moe_pp_aux_matches_single_device(inputs, w2, schedule):
    """pp = 2 with the aux loss on: every stage's aux through both
    schedules == one device with the same micro-batches (no ep: each
    stage's aux is the global one)."""
    ids = inputs["ids"]
    losses_ref, p_ref = _jax_sgd(
        jax_gpt2_spec(JaxGPT2Config.tiny(**PP_KW)),
        jax.tree.map(jnp.asarray, inputs["gpt2_pp"]), (ids, ids), n_micro=2,
        key="pp")
    for r in w2:
        got = r[f"gpt2_pp_{schedule}"]
        assert got["strategy"] == "pp"
        np.testing.assert_allclose(got["losses"], losses_ref, rtol=1e-5)
        _close(got["params"], p_ref)


@pytest.mark.parametrize("schedule", ["afab", "1f1b"])
def test_gpt2_moe_ep_pp_matches_single_device(inputs, w4, schedule):
    """ep x pp (aux off, for exactness across the token split)."""
    ids = inputs["ids"]
    losses_ref, p_ref = _jax_sgd(
        jax_gpt2_spec(JaxGPT2Config.tiny(**EP_PP_KW)),
        jax.tree.map(jnp.asarray, inputs["gpt2_ep_pp"]), (ids, ids),
        key="ep_pp")
    for r in w4:
        got = r[f"ep_pp_{schedule}"]
        assert got["strategy"] == "ep_pp"
        np.testing.assert_allclose(got["losses"], losses_ref, rtol=1e-5)
        _close(got["params"], p_ref)


def test_trainer_fit_eval_moe_ep(w4):
    for r in w4:
        got = r["trainer"]
        assert got["strategy"] == "dp_ep"
        assert np.isfinite(got["train_loss"][0])
        assert np.isfinite(got["val_loss"][0])


def test_gpt2_moe_zero1_dp_ep(inputs, w4):
    """ZeRO-1 AdamW over dp with ep-sharded experts == plain AdamW on the
    same mesh (elementwise update: near exact); its loss == JAX's
    single-device loss."""
    ids = inputs["ids"]
    ref = jax_gpt2_spec(JaxGPT2Config.tiny(**TINY_KW)).loss_fn(
        jax.tree.map(jnp.asarray, inputs["gpt2"]),
        (jnp.asarray(ids), jnp.asarray(ids)))
    for r in w4:
        z, plain = r["zero_zero1_adamw"], r["zero_adamw"]
        np.testing.assert_allclose(z["losses"], [float(ref)], rtol=1e-5)
        np.testing.assert_allclose(z["losses"], plain["losses"], rtol=1e-6)
        _close(z["params"], plain["params"], rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------
# expert-choice routing
# ---------------------------------------------------------------------

def test_expert_choice_one_expert_full_capacity_is_weighted_dense():
    from quintnet_tpu_torch.nn.layers import mlp_apply

    p = _t(jmoe.moe_init(jax.random.key(0), 16, 32, 1))
    x = torch.tensor(_x(0, 2, 8))
    args = moe.MoEArgs(n_experts=1, top_k=1, capacity=16,
                       router="expert_choice", aux_weight=0.0)
    y, aux = moe.moe_apply(p, x, args)
    dense = {"fc": {"w": p["w1"][0], "b": p["b1"][0]},
             "proj": {"w": p["w2"][0], "b": p["b2"][0]}}
    np.testing.assert_allclose(y.numpy(), mlp_apply(dense, x).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float(aux) == 0.0


def test_expert_choice_ep_matches_single_device(inputs, w2):
    args = jmoe.MoEArgs(n_experts=4, top_k=2, capacity=8,
                        router="expert_choice", aux_weight=0.0)
    ref, _ = jmoe.moe_apply(jax.tree.map(jnp.asarray, inputs["ec"]),
                            jnp.asarray(inputs["ec_x"]), args)
    for r in w2:
        y, _ = r["layer_ec_ep2"]
        np.testing.assert_allclose(y, np.asarray(ref), rtol=2e-5, atol=1e-6)


def test_expert_choice_trains():
    p = jax.tree.map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(),
                     jmoe.moe_init(jax.random.key(0), 16, 32, 4))
    x = torch.tensor(_x(1, 4, 8))
    target = torch.tensor(_x(2, 4, 8))
    args = moe.MoEArgs(n_experts=4, top_k=2, router="expert_choice",
                       aux_weight=0.0)
    leaves = [p["router"]["w"], p["w1"], p["b1"], p["w2"], p["b2"]]
    opt = torch.optim.Adam(leaves, lr=1e-2)
    losses = []
    for _ in range(15):
        y, aux = moe.moe_apply(p, x, args)
        loss = (y - target).square().mean() + aux
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_expert_choice_rejected_by_causal_configs():
    for cfg in (GPT2Config.tiny(n_experts=4, router_type="expert_choice"),
                LlamaConfig.tiny(n_experts=4, router_type="expert_choice")):
        with pytest.raises(ValueError, match="non-causal"):
            cfg.moe_args


@pytest.mark.parametrize("schedule", ["afab", "1f1b"])
def test_vit_moe_pp_matches_single_device(inputs, w2, schedule):
    x, y = inputs["vx"], inputs["vy"]
    losses_ref, p_ref = _jax_sgd(jax_vit_spec(JaxViTConfig(**VIT_PP_KW)),
                                 jax.tree.map(jnp.asarray, inputs["vit_pp"]),
                                 (x, y), n_micro=2, key="vit_pp")
    for r in w2:
        got = r[f"vit_pp_{schedule}"]
        np.testing.assert_allclose(got["losses"], losses_ref, rtol=1e-5)
        _close(got["params"], p_ref)


def test_vit_moe_expert_choice_trains_and_shards(inputs, w4):
    """Expert choice on the non-causal ViT: the dp x ep step's loss ==
    JAX's single-device loss, and 9 more steps lower it."""
    jmodel = jax_vit_spec(JaxViTConfig(**VIT_EC_KW))
    ref = float(jmodel.loss_fn(jax.tree.map(jnp.asarray, inputs["vit_ec"]),
                               (jnp.asarray(inputs["vx"]),
                                jnp.asarray(inputs["vy"]))))
    for r in w4:
        got = r["vit_ec"]
        assert got["strategy"] == "dp_ep"
        np.testing.assert_allclose(got["losses"], [ref], rtol=2e-4)
        assert got["more"][-1] < ref


# ---------------------------------------------------------------------
# the model-level pieces
# ---------------------------------------------------------------------

def _nest(flat):
    out = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split(".")
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def test_gpt2_moe_loss_and_grads_match_jax(inputs):
    """The whole MoE GPT-2 (aux on, capacity from the factor, so tokens
    drop): the loss and every gradient against JAX's."""
    kw = dict(n_layer=2, n_experts=4, expert_top_k=2, aux_loss_weight=1e-2,
              router_z_weight=1e-3)
    jp = jax_gpt2_init(jax.random.key(3), JaxGPT2Config.tiny(**kw))
    ids = inputs["ids"]
    jl, jg = jax.value_and_grad(jax_gpt2_spec(
        JaxGPT2Config.tiny(**kw)).loss_fn)(jp, (jnp.asarray(ids),
                                                jnp.asarray(ids)))
    p = gpt2_params_from_numpy(_np_tree(jp), "cpu")
    for _, leaf in _flat_t(p):
        leaf.requires_grad_(True)
    t = torch.tensor(ids)
    loss = gpt2_model_spec(GPT2Config.tiny(**kw)).loss_fn(p, (t, t))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = dict(_flat(_np_tree(jg)))
    for k, leaf in _flat_t(p):
        np.testing.assert_allclose(leaf.grad.numpy(), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def _flat_t(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat_t(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), tree


def test_gpt2_bf16_keeps_the_router_f32():
    """bf16 compute casts every floating leaf but the router, whose gate
    order changes under bf16 rounding (the JAX ``_cast_tree``)."""
    from quintnet_tpu_torch.nn.layers import cast_floating, keep_router_f32

    cfg = GPT2Config.tiny(n_layer=1, n_experts=4)
    p = gpt2_init(torch.Generator().manual_seed(0), cfg)
    c = cast_floating(p, torch.bfloat16, exclude=keep_router_f32)
    assert c["blocks"]["moe"]["router"]["w"].dtype == torch.float32
    assert c["blocks"]["moe"]["w1"].dtype == torch.bfloat16
    ids = torch.tensor(_ids(b=2))
    loss = gpt2_model_spec(cfg, compute_dtype=torch.bfloat16).loss_fn(
        p, (ids, ids))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)


def test_gpt2_upcycle_to_moe_near_identity(inputs):
    """Copied experts and a near-zero router: with normalised gates the
    upcycled model is the dense one up to float error; the JAX and port
    upcycles agree on every expert leaf."""
    dense_kw = dict(n_layer=2)
    moe_kw = dict(n_layer=2, n_experts=4, expert_capacity=4096)
    dense = _jax_gpt2(dense_kw)
    up = gpt2_upcycle_to_moe(gpt2_params_from_numpy(dense, "cpu"),
                             GPT2Config.tiny(**moe_kw))
    jup = _np_tree(jax_gpt2_upcycle(jax.tree.map(jnp.asarray, dense),
                                    JaxGPT2Config.tiny(**moe_kw)))
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(up["blocks"]["moe"][k].numpy(),
                                      jup["blocks"]["moe"][k])
    t = torch.tensor(_ids(b=2))
    from quintnet_tpu_torch.models.gpt2 import gpt2_apply

    base = gpt2_apply(gpt2_params_from_numpy(dense, "cpu"), t,
                      GPT2Config.tiny(**dense_kw))
    got = gpt2_apply(up, t, GPT2Config.tiny(**moe_kw))
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_trainer_fits_moe_vit():
    """``Trainer.fit`` with evaluation trains a MoE ViT (top-k, aux on) on
    one device: 5 Adam steps on one batch lower its loss."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    kw = {k: v for k, v in VIT_PP_KW.items() if k != "expert_capacity"}
    tr = Trainer(Config.from_dict({"training": {
        "optimizer": "adam", "learning_rate": 1e-2, "log_every": 0}}),
        vit_model_spec(ViTConfig(**kw)), task_type="classification",
        device="cpu", log_fn=lambda m: None)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(8, 14, 14, 1)).astype(np.float32))
    y = torch.tensor(rng.integers(0, 10, (8,)))
    hist = tr.fit(lambda ep: [(x, y)], epochs=5,
                  val_batches_fn=lambda ep: [(x, y)])
    assert hist.train_loss[-1] < hist.train_loss[0]
    assert np.isfinite(hist.val_loss[-1]) and hist.val_metric
