"""JAX's GPT-2 mesh step and the comparison the port's mesh tests share
(not collected by pytest: leading underscore)."""

import jax
import jax.numpy as jnp
import numpy as np

from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_model_spec as jax_gpt2_spec
from quintnet_tpu.parallel.strategy import get_strategy as jax_get_strategy
from quintnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_to_tp_layout

ADAMW = {"optimizer": "adamw", "learning_rate": 1e-2, "weight_decay": 0.01,
         "grad_clip_norm": 0.5}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


def _jax_gpt2_step(np_params, ids, labels, mesh_dim, mesh_name, accum,
                   training=None):
    jcfg = JaxConfig.from_dict({
        "mesh_dim": mesh_dim, "mesh_name": mesh_name,
        "training": dict(ADAMW, gradient_accumulation_steps=accum,
                         **(training or {}))})
    strat = jax_get_strategy(None, jcfg)
    spec = jax_gpt2_spec(JaxGPT2Config.tiny(n_layer=2), use_flash=True)
    opt = jax_make_optimizer(jcfg)
    params = strat.shard_params(spec, jax.tree.map(jnp.asarray, np_params))
    state = strat.init_opt_state(spec, opt, params)
    batch = strat.shard_batch((jnp.asarray(ids, jnp.int32),
                               jnp.asarray(labels, jnp.int32)), spec)
    params, state, loss = strat.make_train_step(spec, opt)(params, state,
                                                            batch)
    mu = next(s.mu for s in jax.tree.leaves(
        state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    return (strat.name, float(loss),
            dict(_flat(jax.tree.map(np.asarray, params))),
            dict(_flat(jax.tree.map(np.asarray, mu))))


def port_single_gpt2_step(np_params, ids, labels):
    """The single-device port's AdamW step (``ADAMW``) on the whole batch:
    (loss, params, first moment ``mu``), flat by dotted path."""
    import torch

    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
    from quintnet_tpu_torch.models.gpt2 import gpt2_model_spec
    from quintnet_tpu_torch.parallel.strategy import get_strategy
    from quintnet_tpu_torch.train.trainer import make_optimizer

    config = Config.from_dict({"training": dict(ADAMW)})
    model = gpt2_model_spec(GPT2Config.tiny(n_layer=2), use_flash=True)
    opt = make_optimizer(config)
    params = tree_map(lambda t: t.requires_grad_(True),
                      gpt2_params_from_numpy(np_params, "cpu"))
    state = opt.init(params)
    params, state, loss = get_strategy(None, config).make_train_step(
        model, opt)(params, state, (torch.tensor(ids).long(),
                                    torch.tensor(labels).long()))

    def flat(tree):
        return {".".join(k): v.detach().numpy().copy()
                for k, v in tree_leaves(tree)}

    return float(loss), flat(params), flat(state["mu"])


def check_step(tag, run, loss, want, want_mu, before):
    """One rank's step (``run``: its loss, gathered params and ``mu``, by
    dotted path) against a reference step's (``loss``, ``want``,
    ``want_mu``) from the same parameters ``before`` (the run's layout):
    the bounds :func:`check_gpt2_steps` explains."""
    lr = ADAMW["learning_rate"]
    sure = {k: np.abs(w - before[k]) >= 0.99 * lr for k, w in want.items()}
    assert sum(m.sum() for m in sure.values()) > 0.9 * sum(
        m.size for m in sure.values())
    np.testing.assert_allclose(run["loss"], loss, rtol=1e-5)
    assert set(run["params"]) == set(want) == set(want_mu)
    for k, w in want_mu.items():
        assert np.abs(run["mu"][k] - w).max() <= 1e-5 * np.abs(w).max(), \
            (tag, "mu", k)
    for k, w in want.items():
        diff = np.abs(run["params"][k] - w)
        assert diff[sure[k]].max(initial=0.0) <= 1e-5 * np.abs(w).max(), \
            (tag, k)
        assert diff.max() <= 2 * lr, (tag, k)


def check_gpt2_steps(ranks, np_params, ids, labels, runs):
    """Each rank's loss, gathered params and gathered first moment ``mu``
    (tp-blocked layout) of every run (``(mesh_dim, mesh_name, accum[,
    training keys])``) against JAX's step on the same mesh shape: the loss within 1e-5 relative, every element of ``mu`` within
    1e-5 of its leaf's largest magnitude, and the parameters the same
    way. ``mu`` after one step is ``(1 - b1)`` times the reduced, clipped
    gradient, so it pins every element of the gradient. Adam's first
    update is ``lr g / (|g| + eps)``: where the gradient is within ~100
    ``eps`` of 0 (the key bias, whose true gradient is 0, holds only
    float noise) it scales the noise by ``lr eps / g^2``, up to an O(lr)
    change. So the parameters JAX moved by less than 0.99 lr (under a
    tenth of them) are held to the update's bound, 2 lr, and their
    gradients to the ``mu`` check above."""
    cfg = GPT2Config.tiny(n_layer=2)
    for i, (mesh_dim, mesh_name, accum, *training) in enumerate(runs):
        name, loss, want, want_mu = _jax_gpt2_step(
            np_params, ids, labels, mesh_dim, mesh_name, accum, *training)
        tp = dict(zip(mesh_name, mesh_dim)).get("tp", 1)
        before = dict(_flat(gpt2_to_tp_layout(np_params, cfg, tp)))
        for r, out in enumerate(ranks):
            assert out[i]["strategy"] == name
            check_step((name, r), out[i], loss, want, want_mu, before)
