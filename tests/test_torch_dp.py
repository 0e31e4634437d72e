"""Data parallelism in the port (parallel/dp.py) on a 4-rank gloo world,
against JAX's ``make_dp_train_step`` and the port's single-device step;
in the same world, the GPT-2 dp x tp step against JAX's.

The counterparts of ``tests/test_dp.py:30-103``: the tiny ViT, SGD 0.1,
a 16-row batch made from a seed with numpy, the same weights (JAX's
``vit_init`` through the bridge) on both sides. dp = 4, and dp = 2 with
2 micro-batches a rank, each against JAX's dp step on the same mesh
shape and against the port's one-device step on the whole batch: loss
within 1e-5 relative, every parameter within ``rtol=1e-4, atol=1e-6``
(``tests/test_dp.py``'s own tolerances). Every rank ends with the same
parameters (bit for bit), and the all-reduced gradients are the same on
every replica.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist import run_world
from _torch_dist_cases import VIT_TINY, dp_world_case
from _torch_mesh_checks import check_gpt2_steps
from quintnet_tpu.core.mesh import mesh_from_sizes
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import cross_entropy_loss as jax_ce
from quintnet_tpu.models.vit import vit_apply as jax_vit_apply
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.parallel.dp import make_dp_train_step as jax_dp_step
from quintnet_tpu_torch.bridge import vit_params_from_numpy
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
from quintnet_tpu_torch.models.vit import (ViTConfig, cross_entropy_loss,
                                           vit_apply)
from quintnet_tpu_torch.parallel.dp import accumulate_grads
from quintnet_tpu_torch.parallel.train_step import make_train_step
from quintnet_tpu_torch.train.trainer import make_optimizer

JCFG = JaxViTConfig(**VIT_TINY)
# the GPT-2 dp x tp run: mesh dims, names, micro-batches a rank
GPT2_RUNS = [([2, 2], ["dp", "tp"], 2)]
CFG = ViTConfig(**VIT_TINY)


def _data(n=16):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((n, 14, 14, 1)).astype(np.float32),
            rng.integers(0, 10, (n,)).astype(np.int32))


def _gpt2_batch(B=16, S=16):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 128, (B, S)).astype(np.int64)
    labels = ids.copy()
    labels[2, :5] = -100
    return ids, labels


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = jax.tree.map(np.asarray, jax_vit_init(jax.random.key(0), JCFG))
    x, y = _data()
    gpt2 = jax.tree.map(np.asarray, jax_gpt2_init(
        jax.random.key(0), JaxGPT2Config.tiny(n_layer=2)))
    ids, labels = _gpt2_batch()
    ranks = run_world(dp_world_case, 4, tmp_path_factory.mktemp("dp"),
                      (params, x, y), (gpt2, ids, labels, GPT2_RUNS),
                      timeout=240)
    return params, x, y, [r["dp"] for r in ranks], {
        "gpt2": gpt2, "ids": ids, "labels": labels,
        "ranks": [r["gpt2"] for r in ranks]}


def _jax_step(params, x, y, dp, accum):
    def loss_fn(p, batch):
        return jax_ce(jax_vit_apply(p, batch[0], JCFG), batch[1])

    opt = optax.sgd(0.1)
    p = jax.tree.map(jnp.asarray, params)
    step = jax_dp_step(mesh_from_sizes(dp=dp), loss_fn, opt,
                       grad_accum_steps=accum)
    p, _, loss = step(p, opt.init(p), (jnp.asarray(x), jnp.asarray(y)))
    return float(loss), dict(_flat(jax.tree.map(np.asarray, p)))


def _port_single(params, x, y):
    opt = make_optimizer(Config.from_dict({"training": {
        "optimizer": "sgd", "learning_rate": 0.1}}))
    p = tree_map(lambda t: t.requires_grad_(True),
                 vit_params_from_numpy(params, "cpu"))

    def loss_fn(p, batch, generator=None):
        return cross_entropy_loss(vit_apply(p, batch[0], CFG), batch[1])

    p, _, loss = make_train_step(loss_fn, opt)(
        p, opt.init(p), (torch.tensor(x), torch.tensor(y)))
    return float(loss), {".".join(k): v.detach().numpy()
                         for k, v in tree_leaves(p)}


def _close(got_loss, got, want_loss, want, what):
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, err_msg=what)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("run,dp,accum", [("dp4", 4, 1),
                                          ("dp2_acc2", 2, 2)])
def test_dp_step_matches_jax_and_single_device(setup, run, dp, accum):
    params, x, y, ranks, _ = setup
    loss, p = ranks[0][run + "_loss"], ranks[0][run + "_params"]
    _close(loss, p, *_jax_step(params, x, y, dp, accum), f"{run} vs JAX")
    _close(loss, p, *_port_single(params, x, y), f"{run} vs one device")
    for r in range(1, 4):                     # every replica the same
        assert ranks[r][run + "_loss"] == loss
        for k in p:
            np.testing.assert_array_equal(ranks[r][run + "_params"][k], p[k])


def test_dp_grads_identical_across_replicas(setup):
    _, _, _, ranks, _ = setup
    for r in range(1, 4):
        for a, b in zip(ranks[0]["replica_grads"], ranks[r]["replica_grads"]):
            np.testing.assert_array_equal(a, b)


def test_accumulate_grads_equals_full_batch(setup):
    params, x, y, _, _ = setup
    p = tree_map(lambda t: t.requires_grad_(True),
                 vit_params_from_numpy(params, "cpu"))
    batch = (torch.tensor(x[:8]), torch.tensor(y[:8]))

    def loss_fn(p, b, generator=None):
        return cross_entropy_loss(vit_apply(p, b[0], CFG), b[1])

    l1, g1 = accumulate_grads(loss_fn, p, batch, 1)
    l4, g4 = accumulate_grads(loss_fn, p, batch, 4)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g4[k].numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_gpt2_dp_tp_adamw_step_matches_jax(setup):
    """The tiny GPT-2 (2 layers, 4 heads, 32 wide) on dp x tp = 2 x 2, 2
    micro-batches a rank, AdamW with clipping, against JAX's
    ``get_strategy("dp_tp")`` step (``_torch_mesh_checks``: loss 1e-5
    relative, parameters 1e-5 of each leaf's largest magnitude)."""
    g = setup[4]
    check_gpt2_steps(g["ranks"], g["gpt2"], g["ids"], g["labels"],
                     GPT2_RUNS)
    assert [r[0]["coords"] for r in g["ranks"]] == [
        {"dp": 0, "tp": 0}, {"dp": 0, "tp": 1}, {"dp": 1, "tp": 0},
        {"dp": 1, "tp": 1}]
