"""Tensor parallelism in the port (parallel/tp.py, the tp hooks of nn/,
models/ and parallel/train_step.py) on a 2-rank gloo world, against JAX.

The counterparts of ``tests/test_tp.py:36-210``: column-parallel with
the gather, row-parallel with a self-sliced input, the fused column ->
row pair, the vocab-parallel embedding (and logits), the qkv layout
round trip against JAX's functions, the tiny ViT's tp forward and its
SGD tp step against JAX's ``make_parallel_train_step`` on the same
weights, and the ``reduce_grads`` rule. Layers within ``rtol=1e-5``
(``1e-4`` for the fused pair), the ViT forward ``rtol=2e-4, atol=1e-5``
and the step's parameters ``rtol=2e-4, atol=1e-5`` (test_tp.py's own).

In the same world: the tiny GPT-2 (2 layers, 4 heads, 32 wide) AdamW
step with clipping on tp = 2 against JAX's ``get_strategy("tp")`` step
(loss within 1e-5 relative; every parameter after the step, gathered,
within 1e-5 of its leaf's largest magnitude); the two dropout
properties of ``tests/test_dropout.py:77-132`` (tp ranks agree with one
device, dp ranks draw distinct masks); and ``Trainer.fit`` for 2 steps
on dp = 2 against the one-device Trainer on the same global batches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist import run_world
from _torch_dist_cases import VIT_TINY, tp_world_case
from _torch_mesh_checks import check_gpt2_steps
from quintnet_tpu.core.mesh import mesh_from_sizes
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import cross_entropy_loss as jax_ce
from quintnet_tpu.models.vit import vit_apply as jax_vit_apply
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.models.vit import vit_partition_specs as jax_vit_specs
from quintnet_tpu.models.vit import vit_to_tp_layout as jax_vit_tp_layout
from quintnet_tpu.parallel import tp as jtp
from quintnet_tpu.parallel.train_step import \
    make_parallel_train_step as jax_parallel_step
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_from_tp_layout,
                                            gpt2_model_spec,
                                            gpt2_to_tp_layout)
from quintnet_tpu_torch.models.vit import vit_partition_specs
from quintnet_tpu_torch.parallel import tp as tpl
from quintnet_tpu_torch.parallel.strategy import get_strategy
from quintnet_tpu_torch.train.trainer import Trainer

TP = 2
VIT_CFG = dict(VIT_TINY, num_heads=4)
DROP_SEED = 3


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


def _layer_arrays():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"cw": f(8, 12), "cb": f(12), "cx": f(4, 8), "rw": f(8, 6),
            "rb": f(6), "rx": f(4, 8), "w1": f(8, 16), "w2": f(16, 8),
            "fx": f(4, 8), "table": f(10, 4),
            "ids": np.array([[0, 3, 9], [5, 4, 2]], np.int64),
            "lw": f(8, 10)}


def _gpt2_batch(B=8, S=16, masked=True):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 128, (B, S)).astype(np.int64)
    labels = ids.copy()
    if masked:
        labels[0, :4] = -100
        labels[3, -2:] = -100
    return ids, labels


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    vit = jax.tree.map(np.asarray, jax_vit_init(jax.random.key(0),
                                                JaxViTConfig(**VIT_CFG)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 14, 14, 1)).astype(np.float32)
    y = rng.integers(0, 10, (8,)).astype(np.int64)
    gpt2 = jax.tree.map(np.asarray, jax_gpt2_init(
        jax.random.key(0), JaxGPT2Config.tiny(n_layer=2)))
    ids, labels = _gpt2_batch()
    # unmasked rows: the mean of the dp ranks' token means is then the
    # global token mean, as on one device
    batches = [_gpt2_batch(masked=False) for _ in range(2)]
    batches[1] = (batches[1][0][::-1].copy(), batches[1][1][::-1].copy())
    ranks = run_world(
        tp_world_case, TP, tmp_path_factory.mktemp("tp"),
        (_layer_arrays(), vit, x, y),
        (gpt2, ids, labels, [([TP], ["tp"], 1)]),
        (gpt2, ids, labels, DROP_SEED),
        (gpt2, batches, _gpt2_batch(B=4, masked=False)), timeout=240)
    return {"ranks": ranks, "vit": vit, "x": x, "y": y, "gpt2": gpt2,
            "ids": ids, "labels": labels, "batches": batches}


def _smap(fn, in_specs, out_specs):
    from quintnet_tpu.core import collectives as jcc

    return jcc.shard_map_fn(fn, mesh_from_sizes(tp=TP), in_specs, out_specs)


def test_layers_match_jax(world):
    from jax.sharding import PartitionSpec as P

    a = {k: jnp.asarray(v) for k, v in _layer_arrays().items()}
    want = {
        "column_gather": _smap(
            lambda p, x_: jtp.column_parallel_linear(p, x_,
                                                     gather_output=True),
            ({"w": P(None, "tp"), "b": P("tp")}, P()), P())(
            {"w": a["cw"], "b": a["cb"]}, a["cx"]),
        "row_self_sliced": _smap(
            lambda p, x_: jtp.row_parallel_linear(p, x_,
                                                  input_is_parallel=False),
            ({"w": P("tp", None), "b": P()}, P()), P())(
            {"w": a["rw"], "b": a["rb"]}, a["rx"]),
        "column_then_row": _smap(
            lambda p, x_: jtp.row_parallel_linear(p["r"], jnp.maximum(
                jtp.column_parallel_linear(p["c"], x_), 0)),
            ({"c": {"w": P(None, "tp")}, "r": {"w": P("tp", None)}}, P()),
            P())({"c": {"w": a["w1"]}, "r": {"w": a["w2"]}}, a["fx"]),
        "vocab_embedding": _smap(
            lambda p, i: jtp.vocab_parallel_embedding(p, i),
            ({"table": P("tp", None)}, P()), P())({"table": a["table"]},
                                                  a["ids"]),
        "vocab_logits": _smap(
            lambda p, x_: jtp.vocab_parallel_logits(p, x_),
            ({"w": P(None, "tp")}, P()), P())({"w": a["lw"]}, a["cx"]),
    }
    dense = {"column_gather": a["cx"] @ a["cw"] + a["cb"],
             "row_self_sliced": a["rx"] @ a["rw"] + a["rb"],
             "column_then_row": jnp.maximum(a["fx"] @ a["w1"], 0) @ a["w2"],
             "vocab_embedding": a["table"][a["ids"]],
             "vocab_logits": a["cx"] @ a["lw"]}
    for name in want:
        rtol = 1e-4 if name == "column_then_row" else 1e-5
        for r in range(TP):
            got = world["ranks"][r]["tp"][name]
            np.testing.assert_allclose(got, want[name], rtol=rtol,
                                       atol=1e-6,
                                       err_msg=f"{name} rank {r} vs JAX")
            np.testing.assert_allclose(got, dense[name], rtol=rtol,
                                       atol=1e-5, err_msg=f"{name} dense")


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_qkv_layout_matches_jax(tp):
    w = np.random.default_rng(0).standard_normal((3, 8, 24)).astype(
        np.float32)
    want = np.asarray(jtp.qkv_blocked_from_standard(jnp.asarray(w), 4, tp))
    np.testing.assert_array_equal(tpl.qkv_blocked_from_standard(w, 4, tp),
                                  want)
    got_t = tpl.qkv_blocked_from_standard(torch.from_numpy(w), 4, tp)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(
        tpl.qkv_standard_from_blocked(want, 4, tp), w)
    np.testing.assert_array_equal(
        tpl.qkv_standard_from_blocked(got_t, 4, tp).numpy(), w)


def test_vit_tp_forward_matches_jax(world):
    cfg = JaxViTConfig(**VIT_CFG)
    from jax.sharding import PartitionSpec as P

    specs = jax_vit_specs(cfg, tp_axis="tp")
    p = jax_vit_tp_layout(jax.tree.map(jnp.asarray, world["vit"]), cfg, TP)
    want = _smap(lambda p_, x_: jax_vit_apply(p_, x_, cfg, tp_axis="tp"),
                 (specs, P()), P())(p, jnp.asarray(world["x"][:4]))
    ref = jax_vit_apply(jax.tree.map(jnp.asarray, world["vit"]),
                        jnp.asarray(world["x"][:4]), cfg)
    for r in range(TP):
        got = world["ranks"][r]["tp"]["vit_forward"]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-5)


def test_vit_tp_train_step_matches_jax(world):
    cfg = JaxViTConfig(**VIT_CFG)
    opt = optax.sgd(0.05)

    def tp_loss(p, batch):
        return jax_ce(jax_vit_apply(p, batch[0], cfg, tp_axis="tp"),
                      batch[1])

    step = jax_parallel_step(mesh_from_sizes(tp=TP), tp_loss, opt,
                             jax_vit_specs(cfg), batch_axes=(),
                             model_axes=("tp",), donate=False)
    pb = jax_vit_tp_layout(jax.tree.map(jnp.asarray, world["vit"]), cfg, TP)
    p_tp, _, loss = step(pb, opt.init(pb), (jnp.asarray(world["x"]),
                                            jnp.asarray(world["y"])))
    want = dict(_flat(jax.tree.map(np.asarray, p_tp)))
    specs = {".".join(k): s for k, s in tree_leaves(vit_partition_specs())}
    for r in range(TP):
        out = world["ranks"][r]["tp"]
        np.testing.assert_allclose(out["vit_step_loss"], float(loss),
                                   rtol=1e-5)
        for k, got in out["vit_step_params"].items():
            full = want[k]
            for d, part in enumerate(specs[k]):   # this rank's block of JAX's
                if part == "tp":
                    n = full.shape[d] // TP
                    full = np.take(full, range(r * n, (r + 1) * n), axis=d)
            np.testing.assert_allclose(got, full, rtol=2e-4, atol=1e-5,
                                       err_msg=f"rank {r}: {k}")


def test_reduce_grads_rule(world):
    for r in range(TP):
        out = world["ranks"][r]["tp"]
        np.testing.assert_allclose(out["reduce_rep"], np.ones((2, 2)))
        np.testing.assert_allclose(out["reduce_shard"], 0.5 * np.ones((2, 2)))


def test_gpt2_tp_adamw_step_matches_jax(world):
    check_gpt2_steps([r["gpt2"] for r in world["ranks"]], world["gpt2"],
                     world["ids"], world["labels"], [([TP], ["tp"], 1)])


def _port_single_step(np_params, ids, labels, cfg_kw, seed):
    config = Config.from_dict({"training": {"optimizer": "sgd",
                                            "learning_rate": 0.1}})
    strat = get_strategy("single", config)
    model = gpt2_model_spec(GPT2Config.tiny(**cfg_kw))
    from quintnet_tpu_torch.train.trainer import make_optimizer

    opt = make_optimizer(config)
    p = tree_map(lambda t: t.requires_grad_(True),
                 gpt2_params_from_numpy(np_params, "cpu"))
    _, _, loss = strat.make_train_step(model, opt)(
        p, opt.init(p), (torch.tensor(ids), torch.tensor(labels)),
        strat.dropout_generator(seed, "cpu"))
    return float(loss)


def test_dropout_tp_matches_single_device(world):
    """tp ranks fold no coordinate: with attention dropout off, a tp = 2
    dropout step is the one-device step (same masks)."""
    want = _port_single_step(world["gpt2"], world["ids"], world["labels"],
                             dict(n_layer=2, embd_pdrop=0.1, attn_pdrop=0.0,
                                  resid_pdrop=0.1), DROP_SEED)
    nodrop = _port_single_step(world["gpt2"], world["ids"], world["labels"],
                               dict(n_layer=2), DROP_SEED)
    assert want != nodrop                    # dropout perturbs the loss
    for r in range(TP):
        out = world["ranks"][r]["dropout"]
        np.testing.assert_allclose(out["tp"], want, rtol=1e-5)
        assert out["tp_seed"] == DROP_SEED


def test_dropout_dp_ranks_get_distinct_masks(world):
    """dp ranks fold their coordinate: distinct seeds, and the dp = 2 loss
    differs from the one-device loss on the same global batch."""
    single = _port_single_step(world["gpt2"], world["ids"], world["labels"],
                               dict(n_layer=2, embd_pdrop=0.1,
                                    attn_pdrop=0.0, resid_pdrop=0.1),
                               DROP_SEED)
    seeds = [world["ranks"][r]["dropout"]["dp_seed"] for r in range(TP)]
    assert seeds[0] == DROP_SEED and len(set(seeds)) == TP
    assert abs(world["ranks"][0]["dropout"]["dp"] - single) > 1e-7


def test_trainer_fit_dp2_equals_single_device(world):
    config = Config.from_dict({"training": {
        "optimizer": "sgd", "learning_rate": 0.1, "grad_clip_norm": 1.0,
        "log_every": 1, "seed": 0}})
    tr = Trainer(config, gpt2_model_spec(GPT2Config.tiny(n_layer=2)),
                 task_type="clm", device="cpu", log_fn=lambda m: None)
    params = tree_map(lambda t: t.requires_grad_(True),
                      gpt2_params_from_numpy(world["gpt2"], "cpu"))
    batches, val = world["batches"], _gpt2_batch(B=4, masked=False)
    hist = tr.fit(lambda ep: [batches[ep]], epochs=2, params=params,
                  opt_state=tr.optimizer.init(params),
                  val_batches_fn=lambda ep: [val])
    p, s = tr.final_state
    want_p = {".".join(k): v.detach().numpy() for k, v in tree_leaves(p)}
    for r in range(TP):
        out = world["ranks"][r]["trainer"]
        assert out["strategy"] == "dp"
        np.testing.assert_allclose(out["train_loss"], hist.train_loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(out["val_loss"], hist.val_loss, rtol=1e-5)
        for k, w in want_p.items():
            assert np.abs(out["params"][k] - w).max() <= \
                1e-5 * np.abs(w).max(), k
    assert world["ranks"][0]["trainer"]["logs"] > 0
    assert world["ranks"][1]["trainer"]["logs"] == 0     # rank 0 logs only


def test_gpt2_tp_layout_round_trip():
    p = tree_map(torch.from_numpy, jax.tree.map(np.asarray, jax_gpt2_init(
        jax.random.key(0), JaxGPT2Config.tiny(n_layer=2))))
    cfg = GPT2Config.tiny(n_layer=2)
    blocked = gpt2_to_tp_layout(p, cfg, 2)
    back = gpt2_from_tp_layout(blocked, cfg, 2)
    for (k, a), (_, b) in zip(tree_leaves(p), tree_leaves(back)):
        assert torch.equal(a, b), k
    assert not torch.equal(blocked["blocks"]["attn"]["qkv"]["w"],
                           p["blocks"]["attn"]["qkv"]["w"])
    assert gpt2_to_tp_layout(p, cfg, 1) is p
