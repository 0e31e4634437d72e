"""Pipeline parallelism in the port (parallel/pp.py, the pipeline hooks
of the models and of the train step) on one gloo world of 4 CPU ranks,
against JAX's schedules and the single-rank port.

The counterparts of ``tests/test_pp.py:64-153``: AFAB, ``1f1b``
(recompute) and ``1f1b_stored`` on tiny GPT-2 (``n_layer = 2 pp``, 4
heads, 32 wide; 8 rows of 16 tokens) and the tiny ViT (depth 4, 2
heads, 16 wide; 8 images), on pp = 2 and pp = 4 with M = 4
micro-batches. For each: the loss within 1e-5 relative and every
gradient leaf (reduced over pp, gathered whole) within 1e-5 of its
largest magnitude, against JAX's 1F1B under ``shard_map`` (and, on
GPT-2 at pp = 2, against JAX's AFAB and 1F1B-stored too; GPT-2 with
plain attention in JAX: the port's CPU path is the kernels' plain
version) and against the port's one-device gradients; the three
schedules agree with each other to the same bound.

Dropout under pp (the port's own seeds: JAX's key stream is not
reproducible in torch): on one step seed the three schedules give the
same loss and gradients within 1e-6, which shows that the 1F1B
recompute draws the forward's masks; each (micro-batch, stage) gets its
own generator seed. Also: the shift's all-to-all form (what gloo runs on
CUDA tensors) equals the point-to-point one, and ``validate_pp`` raises
as JAX's does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dist import run_world
from _torch_dist_cases import (PP_SCHEDULES, pp_model, pp_params,
                               pp_world_case)
from quintnet_tpu.core import collectives as jcc
from quintnet_tpu.core.mesh import mesh_from_sizes
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2 import gpt2_partition_specs as jax_gpt2_specs
from quintnet_tpu.models.gpt2 import gpt2_pipeline_fns as jax_gpt2_pipe
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.models.vit import vit_partition_specs as jax_vit_specs
from quintnet_tpu.models.vit import vit_pipeline_fns as jax_vit_pipe
from quintnet_tpu.parallel import pp as jpp
from quintnet_tpu.parallel.train_step import reduce_grads as jax_reduce
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
from quintnet_tpu_torch.parallel import pp
from quintnet_tpu_torch.parallel.dp import accumulate_grads

WORLD = 4
M = 4
VIT = dict(image_size=14, patch_size=7, in_channels=1, hidden_dim=16,
           depth=4, num_heads=2, num_classes=10)
DROP = dict(n_layer=4, embd_pdrop=0.1, attn_pdrop=0.1, resid_pdrop=0.1)
DROP_SEED = 7
CASES = [(name, n) for n in (2, 4) for name in ("gpt2", "vit")]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


def _kw(name, n):
    return dict(n_layer=2 * n) if name == "gpt2" else VIT


def _inputs(name, n):
    """(numpy params from JAX's init, x, y) of a case."""
    rng = np.random.default_rng(10 * n + (name == "vit"))
    if name == "gpt2":
        params = jax_gpt2_init(jax.random.key(n), JaxGPT2Config.tiny(
            **_kw(name, n)))
        ids = rng.integers(0, 128, (8, 16)).astype(np.int64)
        x, y = ids, ids.copy()
        # masked targets, as many in every row: the pipeline's mean of
        # micro-batch token means is then the one device's token mean
        y[:, :3] = -100
    else:
        params = jax_vit_init(jax.random.key(n), JaxViTConfig(**VIT))
        x = rng.standard_normal((8, 14, 14, 1)).astype(np.float32)
        y = rng.integers(0, 10, (8,)).astype(np.int64)
    return jax.tree.map(np.asarray, params), x, y


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    runs = [_case(name, n) for name, n in CASES]
    drop_np = jax.tree.map(np.asarray, jax_gpt2_init(
        jax.random.key(9), JaxGPT2Config.tiny(**DROP)))
    _, x, y, _ = runs[0][2:]
    ranks = run_world(pp_world_case, WORLD, tmp_path_factory.mktemp("pp"),
                      runs, ("gpt2", DROP, drop_np, x, y, 2, DROP_SEED), M,
                      timeout=300)
    return {"ranks": ranks, "runs": {(r[0], r[5]): r for r in runs}}


@functools.lru_cache(maxsize=None)
def _jax_golden(name, n, sched):
    return _jax_pipeline(*_case(name, n), sched)


def _case(name, n):
    return (name, _kw(name, n), *_inputs(name, n), n)


def _jax_pipeline(name, kw, np_params, x, y, n, sched):
    """JAX's schedule on a pp = n mesh: (loss, {leaf: gradient})."""
    if name == "gpt2":
        cfg = JaxGPT2Config.tiny(**kw)
        fns = jax_gpt2_pipe(cfg)
        specs = jax_gpt2_specs(cfg, tp_axis=None, pp_axis="pp")
    else:
        cfg = JaxViTConfig(**kw)
        fns = jax_vit_pipe(cfg)
        specs = jax_vit_specs(cfg, tp_axis=None, pp_axis="pp")
    spec = jpp.PipelineSpec(n_micro=M)
    if sched == "afab":
        loss_fn = jpp.make_afab_loss_fn(*fns, spec)
        grad_fn = jax.value_and_grad(loss_fn)
    else:
        grad_fn = jpp.make_1f1b_grad_fn(
            *fns, spec, store_activations=sched == "1f1b_stored")

    def local(p, b):
        loss, g = grad_fn(p, b)
        return loss, jax_reduce(g, specs, data_axes=(), model_axes=(),
                                partial_axes=("pp",))

    loss, g = jcc.shard_map_fn(local, mesh_from_sizes(pp=n),
                               in_specs=(specs, (P(), P())),
                               out_specs=(P(), specs))(
        jax.tree.map(jnp.asarray, np_params),
        (jnp.asarray(x), jnp.asarray(y, jnp.int32)))
    return float(loss), dict(_flat(jax.tree.map(np.asarray, g)))


def _single(name, kw, np_params, x, y):
    model = pp_model(name, kw)
    params = tree_map(lambda t: t.requires_grad_(True),
                      pp_params(name, np_params))
    loss, grads = accumulate_grads(model.loss_fn, params,
                                   (torch.tensor(x), torch.tensor(y)), 1)
    return float(loss), {".".join(k): g.numpy() for k, g in grads.items()}


def _check(got, want, rtol, where):
    loss, grads = got
    w_loss, w_grads = want
    assert abs(loss - w_loss) <= rtol * abs(w_loss), (where, loss, w_loss)
    assert set(grads) == set(w_grads), where
    for k, w in w_grads.items():
        assert np.abs(grads[k] - w).max() <= rtol * np.abs(w).max(), \
            (where, k)


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}_pp{b}" for a, b in CASES])
@pytest.mark.parametrize("sched", PP_SCHEDULES)
def test_schedule_matches_jax_and_one_device(world, name, n, sched):
    """Every port schedule against JAX's 1F1B (the reference's schedule;
    JAX's own tests hold its three schedules equal) and the one-device
    port."""
    run = world["runs"][(name, n)]
    want_jax = _jax_golden(name, n, "1f1b")
    want_one = _single(*run[:5])
    for r, out in enumerate(world["ranks"]):
        got = out[(name, n, sched)]
        _check(got, want_jax, 1e-5, (sched, r, "vs JAX"))
        _check(got, want_one, 1e-5, (sched, r, "vs one device"))


@pytest.mark.parametrize("sched", ["afab", "1f1b_stored"])
def test_schedule_matches_the_same_jax_schedule(world, sched):
    """AFAB and 1F1B-stored against JAX's same schedule (GPT-2, pp = 2)."""
    want = _jax_golden("gpt2", 2, sched)
    for r, out in enumerate(world["ranks"]):
        _check(out[("gpt2", 2, sched)], want, 1e-5, (sched, r))


@pytest.mark.parametrize("name,n", CASES, ids=[f"{a}_pp{b}" for a, b in CASES])
def test_three_schedules_agree(world, name, n):
    for out in world["ranks"]:
        for sched in PP_SCHEDULES[1:]:
            _check(out[(name, n, sched)], out[(name, n, "afab")], 1e-5,
                   sched)


def test_dropout_recompute_draws_the_forward_masks(world):
    """With dropout on, the three schedules on one step seed agree within
    1e-6 (1F1B recomputes each micro-batch's forward from fresh
    generators of the same seeds); the masks change the loss."""
    no_drop = world["ranks"][0][("gpt2", 2, "afab")][0]
    for out in world["ranks"]:
        base = out[("dropout", "afab")]
        for sched in PP_SCHEDULES[1:]:
            _check(out[("dropout", sched)], base, 1e-6, sched)
    assert abs(world["ranks"][0][("dropout", "afab")][0] - no_drop) > 1e-4


def test_micro_batches_and_stages_get_distinct_generators():
    g = torch.Generator().manual_seed(DROP_SEED)
    seeds = {}
    for m in range(4):
        for s in range(4):
            e, st = pp._mb_generators(g, m, s)
            seeds[(m, s)] = (e.initial_seed(), st.initial_seed())
            again = pp._mb_generators(g, m, s)
            assert (again[0].initial_seed(), again[1].initial_seed()) == \
                seeds[(m, s)]
    flat = [x for pair in seeds.values() for x in pair]
    assert len(set(flat)) == len(flat)
    assert pp._mb_generators(None, 0, 0) == (None, None)


def test_shift_all_to_all_form_equals_point_to_point(world):
    for r, out in enumerate(world["ranks"]):
        for (sh, wrap), (p2p, a2a) in out["shift"].items():
            np.testing.assert_array_equal(a2a, p2p)
            src = r - sh
            if wrap:
                src %= WORLD
            want = (np.arange(6.0).reshape(2, 3) + 10 * src
                    if 0 <= src < WORLD else np.zeros((2, 3)))
            np.testing.assert_array_equal(p2p, want)


def test_validate_pp():
    for fn in (pp.validate_pp, jpp.validate_pp):
        with pytest.raises(ValueError, match="divisible by pp=4"):
            fn(depth=6, pp_size=4)
        fn(depth=8, pp_size=4)
