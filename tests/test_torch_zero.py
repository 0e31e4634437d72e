"""ZeRO-1/2 in the port (parallel/zero.py, the ZeRO path of
parallel/train_step.py and the strategy) on one gloo world of 8 CPU
ranks, against replicated AdamW, JAX's chunks and JAX's step.

The counterparts of ``tests/test_zero.py:55-166`` on the tiny ViT
(depth 4, 2 heads, 16 wide; AdamW lr 1e-3, decay 0.01, clip 1.0), on
dp = 2 and dp x tp = 2 x 2 (meshes with an extra axis ``x`` of replicas,
so that one world holds every case):

- ``zero1_adamw`` and ``zero2_adamw`` equal replicated AdamW after one
  and after three steps, every leaf within 1e-6 of its largest magnitude
  (ZeRO-1 exactly). One element class is held to Adam's update bound
  instead at three steps: the attention's key bias, whose true gradient
  is 0 (attention is invariant to it), so its gradient is float noise
  that ZeRO-2's reassociated clip norm changes in the last bits, and
  Adam's ``g / (|g| + eps)`` turns that into an O(lr) step;
- ZeRO-2's chunk accumulation over 2 micro-batches equals ZeRO-1's with
  the same accumulation (the same bounds);
- the chunk-space norm (``zero.grad_weights``) equals
  ``sharded_global_norm`` within 1e-6 relative;
- each rank's Adam ``mu`` and ``nu`` chunks after one step equal JAX's
  ``zero1_adamw`` chunks for the same rank within 1e-5 of the largest
  magnitude, and hold ``ceil(n_local / dp)`` elements;
- ``adam_mu_dtype: bfloat16``: the chunk's ``mu`` is bf16 and equals the
  replicated bf16 ``mu``'s chunk bit for bit, and JAX's bf16 chunk within
  one bf16 rounding step of each element plus the f32 bound above.

The gate of ROADMAP.md item 3c: tiny GPT-2 (4 layers, 4 heads) on the 2 x
2 x 2 dp x tp x pp mesh through ``get_strategy`` (1F1B over 2
micro-batches, 32 rows of 16 tokens, clip 1.0) with ``zero2_adamw`` and
``zero1_adamw``: the loss, the gathered parameters and each rank's
``mu`` chunk against JAX's step on the same mesh and against the
single-rank port, with ``tests/_torch_mesh_checks``' bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_world
from _torch_dist_cases import (GPT2_3D, GPT2_3D_TRAINING, ZERO_TRAINING,
                               ZERO_VIT, pp_model, zero_world_case)
from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2 import gpt2_model_spec as jax_gpt2_spec
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.models.vit import vit_model_spec as jax_vit_spec
from quintnet_tpu.parallel.strategy import get_strategy as jax_get_strategy
from quintnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_to_tp_layout
from quintnet_tpu_torch.parallel import zero
from quintnet_tpu_torch.parallel.strategy import get_strategy
from quintnet_tpu_torch.parallel.tp import shard_leaf
from quintnet_tpu_torch.train.trainer import make_optimizer

WORLD = 8
LR = ZERO_TRAINING["learning_rate"]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    vit = jax.tree.map(np.asarray, jax_vit_init(jax.random.key(0),
                                                JaxViTConfig(**ZERO_VIT)))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 14, 14, 1)).astype(np.float32)
    y = rng.integers(0, 10, (16,)).astype(np.int64)
    gpt2 = jax.tree.map(np.asarray, jax_gpt2_init(
        jax.random.key(0), JaxGPT2Config.tiny(**GPT2_3D)))
    ids = rng.integers(0, 128, (GPT2_3D_TRAINING["batch_size"], 16)) \
        .astype(np.int64)
    ranks = run_world(zero_world_case, WORLD, tmp_path_factory.mktemp("zero"),
                      vit, x, y, gpt2, ids, timeout=300)
    return {"ranks": ranks, "vit": vit, "x": x, "y": y, "gpt2": gpt2,
            "ids": ids}


def _key_bias(name, shape, tp):
    """True on the key columns of the fused qkv bias (tp-blocked
    layout), False elsewhere."""
    mask = np.zeros(shape, bool)
    if name == "blocks.attn.qkv.b":
        view = mask.reshape(shape[:-1] + (tp, 3, -1))
        view[..., 1, :] = True
    return mask


def _close(got, want, name, tp, steps):
    diff = np.abs(got - want)
    key = _key_bias(name, want.shape, tp)
    assert diff[~key].max(initial=0.0) <= 1e-6 * np.abs(want).max(), name
    bound = 0.0 if steps == 1 else 2 * LR * steps
    assert diff[key].max(initial=0.0) <= max(bound, 1e-6 * np.abs(
        want).max()), name


@pytest.mark.parametrize("mesh", ["dp2", "dptp"])
@pytest.mark.parametrize("optimizer", ["zero1_adamw", "zero2_adamw"])
def test_zero_matches_replicated_adamw(world, mesh, optimizer):
    tp = 2 if mesh == "dptp" else 1
    for r, out in enumerate(world["ranks"]):
        ref, run = out[mesh]["adamw"], out[mesh][optimizer]
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-6)
        for steps in (1, 3):
            for k, want in ref[f"params{steps}"].items():
                _close(run[f"params{steps}"][k], want, k, tp, steps)
        if optimizer == "zero1_adamw":    # the same gradients, elementwise
            for steps in (1, 3):
                for k, want in ref[f"params{steps}"].items():
                    np.testing.assert_array_equal(
                        run[f"params{steps}"][k], want, err_msg=k)


def test_zero2_chunk_accumulation_matches_zero1(world):
    for out in world["ranks"]:
        z1, z2 = out["dp2"]["zero1_acc2"], out["dp2"]["zero2_acc2"]
        np.testing.assert_allclose(z2["losses"], z1["losses"], rtol=1e-6)
        for steps in (1, 3):
            for k, want in z1[f"params{steps}"].items():
                _close(z2[f"params{steps}"][k], want, k, 1, steps)


def test_chunk_space_norm_matches_clip_sharded_grads(world):
    for out in world["ranks"]:
        want, got = out["norm"]
        assert abs(got - want) <= 1e-6 * want


def _jax_zero_state(mesh_dim, mesh_name, vit, x, y, mu_dtype=None):
    """JAX's ``zero1_adamw`` step on the ViT: each device's (mu, nu)
    chunk after one step, indexed by the device's row-major position."""
    t = dict(ZERO_TRAINING, optimizer="zero1_adamw", batch_size=len(x))
    if mu_dtype:
        t["adam_mu_dtype"] = mu_dtype
    cfg = JaxConfig.from_dict({"mesh_dim": mesh_dim, "mesh_name": mesh_name,
                               "training": t})
    strat = jax_get_strategy(None, cfg)
    spec = jax_vit_spec(JaxViTConfig(**ZERO_VIT))
    opt = jax_make_optimizer(cfg)
    params = strat.shard_params(spec, jax.tree.map(jnp.asarray, vit))
    state = strat.init_opt_state(spec, opt, params)
    batch = strat.shard_batch((jnp.asarray(x), jnp.asarray(y, jnp.int32)))
    _, state, _ = strat.make_train_step(spec, opt)(params, state, batch)
    adam = next(s for s in jax.tree.leaves(
        state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    n = int(np.prod(mesh_dim))
    return ({m: np.asarray(getattr(adam, m).astype(jnp.float32))
             .reshape(n, -1) for m in ("mu", "nu")},
            str(adam.mu.dtype))


@pytest.mark.parametrize("mesh", ["dp2", "dptp"])
def test_zero_chunks_match_jax_per_rank(world, mesh):
    dims = ([2], ["dp"]) if mesh == "dp2" else ([2, 2], ["dp", "tp"])
    want, _ = _jax_zero_state(*dims, world["vit"], world["x"], world["y"])
    for out in world["ranks"]:
        run = out[mesh]["zero1_adamw"]
        c = out["coords"][mesh]
        idx = c["dp"] * 2 + c["tp"] if mesh == "dptp" else c["dp"]
        assert run["mu"].size == -(-run["n_local"] // 2)
        for m in ("mu", "nu"):
            w = want[m][idx]
            assert run[m].shape == w.shape
            assert np.abs(run[m] - w).max() <= 1e-5 * np.abs(w).max(), m


def test_zero_bf16_first_moment(world):
    want, dtype = _jax_zero_state([2], ["dp"], world["vit"], world["x"],
                                  world["y"], mu_dtype="bfloat16")
    assert dtype == "bfloat16"
    for out in world["ranks"]:
        run, rep = out["dp2"]["zero1_mu_bf16"], out["dp2"]["adamw_mu_bf16"]
        assert run["mu_dtype"] == "torch.bfloat16"
        assert run["nu_dtype"] == "torch.float32"
        i = out["coords"]["dp2"]["dp"]
        chunk = run["mu"].size
        np.testing.assert_array_equal(
            run["mu"], np.pad(rep["mu"], (0, 2 * chunk - rep["mu"].size))
            [i * chunk:(i + 1) * chunk])
        w = want["mu"][i]
        # one bf16 rounding step of the element (8 significant bits), on
        # top of the f32 moment's bound (float-noise gradients near 0)
        bad = np.abs(run["mu"] - w) > 2.0 ** -7 * np.maximum(
            np.abs(run["mu"]), np.abs(w)) + 1e-5 * np.abs(w).max()
        assert not bad.any(), (np.nonzero(bad), run["mu"][bad], w[bad])
        for steps in (1, 3):
            for k, v in rep[f"params{steps}"].items():
                np.testing.assert_array_equal(run[f"params{steps}"][k], v)


# ---------------------------------------------------------------------
# the gate of item 3c: 2 x 2 x 2, 1F1B, zero2_adamw and zero1_adamw
# ---------------------------------------------------------------------

def _jax_3d_step(gpt2, ids, optimizer):
    cfg = JaxConfig.from_dict({
        "mesh_dim": [2, 2, 2], "mesh_name": ["dp", "tp", "pp"],
        "training": dict(GPT2_3D_TRAINING, optimizer=optimizer)})
    strat = jax_get_strategy(None, cfg)
    spec = jax_gpt2_spec(JaxGPT2Config.tiny(**GPT2_3D), use_flash=True)
    opt = jax_make_optimizer(cfg)
    params = strat.shard_params(spec, jax.tree.map(jnp.asarray, gpt2))
    state = strat.init_opt_state(spec, opt, params)
    batch = strat.shard_batch((jnp.asarray(ids, jnp.int32),
                               jnp.asarray(ids, jnp.int32)), spec)
    params, state, loss = strat.make_train_step(spec, opt)(params, state,
                                                            batch)
    adam = next(s for s in jax.tree.leaves(
        state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    return (float(loss), dict(_flat(jax.tree.map(np.asarray, params))),
            np.asarray(adam.mu).reshape(WORLD, -1), strat.zero_stage)


def _single_rank_step(gpt2, ids):
    """The same step on one device: the loss, the parameters and the
    full first moment (tp-blocked layout for tp = 2)."""
    config = Config.from_dict({"training": dict(
        GPT2_3D_TRAINING, optimizer="adamw")})
    strat = get_strategy("single", config)
    model = pp_model("gpt2", GPT2_3D)
    opt = make_optimizer(config)
    p = tree_map(lambda t: t.requires_grad_(True),
                 gpt2_params_from_numpy(gpt2, "cpu"))
    st = opt.init(p)
    p, st, loss = strat.make_train_step(model, opt)(
        p, st, (torch.tensor(ids), torch.tensor(ids)))
    cfg = GPT2Config.tiny(**GPT2_3D)
    blocked = lambda t: gpt2_to_tp_layout(t, cfg, 2)  # noqa: E731
    return (float(loss),
            {".".join(k): v.detach().numpy()
             for k, v in tree_leaves(blocked(p))},
            blocked(tree_map(lambda t: t.detach(), st["mu"])))


def _rank_chunk(mu_full, coords):
    """A rank's ZeRO chunk of a whole (tp-blocked) moment tree: its tp
    and pp shard of every leaf, flattened in ``parallel/zero``'s order,
    chunk ``dp`` of 2."""
    from quintnet_tpu_torch.core.mesh import Mesh, MeshSpec
    from quintnet_tpu_torch.models.gpt2 import gpt2_partition_specs

    spec = MeshSpec.create(dp=2, tp=2, pp=2)
    rank = coords["dp"] * 4 + coords["tp"] * 2 + coords["pp"]
    mesh = Mesh(spec, rank, {})
    local = tree_map(lambda t, s: shard_leaf(t, s, mesh), mu_full,
                     gpt2_partition_specs(tp_axis="tp", pp_axis="pp"))
    order = zero.flat_order(local)
    flat = zero.flatten(dict(tree_leaves(local)), order)
    chunk = zero.chunk_size(flat.numel(), 2)
    return zero.local_chunk(flat, 2, coords["dp"], chunk).numpy()


@pytest.mark.parametrize("optimizer", ["zero2_adamw", "zero1_adamw"])
def test_3d_1f1b_zero_step_matches_jax_and_one_device(world, optimizer):
    loss, want, want_mu, stage = _jax_3d_step(world["gpt2"], world["ids"],
                                              optimizer)
    s_loss, s_params, s_mu = _single_rank_step(world["gpt2"], world["ids"])
    cfg = GPT2Config.tiny(**GPT2_3D)
    before = dict(_flat(gpt2_to_tp_layout(world["gpt2"], cfg, 2)))
    sure = {k: np.abs(w - before[k]) >= 0.99 * LR for k, w in want.items()}
    assert sum(m.sum() for m in sure.values()) > 0.9 * sum(
        m.size for m in sure.values())
    for r, out in enumerate(world["ranks"]):
        run = out["3d"][optimizer]
        assert run["strategy"] == "3d"
        assert run["zero"] == ("dp", stage)
        for ref_loss in (loss, s_loss):
            np.testing.assert_allclose(run["loss"], ref_loss, rtol=1e-5)
        assert set(run["params"]) == set(want) == set(s_params)
        for ref in (want, s_params):
            for k, w in ref.items():
                diff = np.abs(run["params"][k] - w)
                assert diff[sure[k]].max(initial=0.0) <= \
                    1e-5 * np.abs(w).max(), (optimizer, r, k)
                assert diff.max() <= 2 * LR, (optimizer, r, k)
        for ref_mu in (want_mu[r], _rank_chunk(s_mu, run["coords"])):
            assert run["mu"].shape == ref_mu.shape
            assert np.abs(run["mu"] - ref_mu).max() <= \
                1e-5 * np.abs(ref_mu).max(), (optimizer, r)
