"""The port's sequence parallelism (``ops/ring_attention.py``,
``ops/ulysses_attention.py``, ``core/collectives.ppermute``, the sp
threading of ``nn/``, ``models/`` and the strategies ``sp``, ``dp_sp``
and JAX's ``custom`` meshes with sp) against the JAX package.

Three gloo worlds of CPU ranks (2, 4 and 8), each running every case of
its size once (``tests/_torch_sp_cases.py``); the goldens are JAX's on
one device (or under ``shard_map`` on conftest's 8 CPU devices):

- ``ppermute`` (8 ranks, a permutation with a fixed point and members
  that send or receive nothing): values and gradients against
  ``lax.ppermute`` under ``shard_map``; its all-to-all form (gloo's on
  CUDA tensors) equals the point-to-point one;
- ring, zigzag and Ulysses on sp = 2 and 4, causal and not, with and
  without packed-segment ids: the output and the q, k, v gradients
  against JAX's ``sdpa`` on the gathered sequence (``rtol=2e-4,
  atol=2e-5`` values, ``rtol=5e-4, atol=1e-5`` gradients: JAX's
  ``tests/test_sp.py`` bounds), and one output of each (causal,
  segments, sp = 4) against the JAX function itself under
  ``shard_map``;
  Ulysses' indivisible-heads ``ValueError``;
- ``mha_apply(sp_axis=)`` with segments, and tiny GPT-2's forward on sp =
  4 (with and without ``segment_eos_id``) in each mode, against JAX's
  single-device ``mha_apply`` and ``gpt2_apply`` (``rtol=2e-3,
  atol=2e-4``, JAX's);
- the seven train-step cases of ``tests/test_sp.py:284-291`` (sp = 4 in
  each mode, dp x sp ring, tp x pp x sp ``1f1b`` over 2 micro-batches in
  each mode) from the weights ``bridge.py`` carries over, against JAX's
  single-device SGD step: loss ``rtol=1e-5``, every parameter ``rtol=
  5e-4, atol=2e-5``;
- Llama on sp = 2, zigzag and Ulysses (``tests/test_llama.py:462``), the
  same way;
- the two dry-run meshes of ``__graft_entry__.py``: GPT-2-MoE (packed
  segments) on dp x sp x ep with Ulysses and ``zero1_adamw``, and Llama
  on dp x tp x sp with ring and ``zero2_adamw``, against JAX's
  single-device AdamW step (the MoE dropless and without the aux term,
  as ``tests/_worker_5d.py`` makes it exact; parameters with Adam's
  update bound where the step is float noise, see
  ``tests/_torch_mesh_checks.check_step``); and the MoE aux term over sp
  (a per-rank load-balance loss averaged over sp) against JAX's step on
  the same mesh;
- dropout on the ring and Ulysses paths: at ``pdrop`` 0 with a
  generator the output is the plain run's bit for bit; at ``pdrop``
  0.25 the sp ranks keep 0.75 of the probabilities and draw distinct
  masks (JAX's key stream is not reproduced);
- ``Trainer.fit`` with evaluation on dp x sp against the single-device
  trainer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_world
from _torch_mesh_checks import jax_single_steps, tp_blocked
from _torch_sp_cases import ATTENTIONS, sp_world_case
from quintnet_tpu.core import collectives as jcc
from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.core.mesh import mesh_from_sizes as jax_mesh
from quintnet_tpu.models import gpt2 as jgpt2
from quintnet_tpu.models import llama as jllama
from quintnet_tpu.nn import attention as jattn
from quintnet_tpu.ops.ring_attention import (ring_attention,
                                             zigzag_ring_attention)
from quintnet_tpu.ops.ulysses_attention import ulysses_attention
from quintnet_tpu.parallel.strategy import get_strategy as jax_get_strategy
from quintnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.nn.attention import mha_init

P = jax.sharding.PartitionSpec
TINY = dict(n_layer=2)
MOE = dict(n_layer=2, n_head=4, n_experts=4, segment_eos_id=5,
           expert_capacity=4096, aux_loss_weight=0.0)
MOE_AUX = dict(n_layer=2, n_head=4, n_experts=4, aux_loss_weight=1e-2)
SGD = {"optimizer": "sgd", "learning_rate": 0.05, "grad_clip_norm": None}
ADAM = {"learning_rate": 1e-3, "grad_clip_norm": 1.0}
# (mesh, schedule, micro-batches, sp_mode) of tests/test_sp.py:284-291
STEP_CASES = {
    "sp4_ring": ({"sp": 4}, "afab", 1, "ring"),
    "sp4_ulysses": ({"sp": 4}, "afab", 1, "ulysses"),
    "dp2_sp2_ring": ({"dp": 2, "sp": 2}, "afab", 1, "ring"),
    "tp_pp_sp_1f1b_ring": ({"tp": 2, "pp": 2, "sp": 2}, "1f1b", 2, "ring"),
    "tp_pp_sp_1f1b_ulysses": ({"tp": 2, "pp": 2, "sp": 2}, "1f1b", 2,
                              "ulysses"),
    "sp4_zigzag": ({"sp": 4}, "afab", 1, "zigzag"),
    "tp_pp_sp_1f1b_zigzag": ({"tp": 2, "pp": 2, "sp": 2}, "1f1b", 2,
                             "zigzag"),
}
PERM8 = [(0, 3), (1, 0), (2, 5), (3, 1), (4, 4), (5, 2)]   # 6, 7 idle
FIXED8 = [(0, 0), (3, 3), (6, 6)]           # fixed points only; 5 idle


def _rng(seed):
    return np.random.default_rng(seed)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _size(sizes):
    return int(np.prod(list(sizes.values())))


def _port_params(family, kw, seed):
    """Tiny parameters drawn by the port's init from ``seed``, as the
    numpy tree both packages load (the JAX init is slower here and the
    goldens need only the same numbers on both sides)."""
    from quintnet_tpu_torch import bridge
    from quintnet_tpu_torch.models import gpt2, llama

    g = torch.Generator().manual_seed(seed)
    if family == "gpt2":
        return bridge.gpt2_params_to_numpy(gpt2.gpt2_init(
            g, gpt2.GPT2Config.tiny(**kw)))
    return bridge.llama_params_to_numpy(llama.llama_init(
        g, llama.LlamaConfig.tiny(**kw)))


@pytest.fixture(scope="module")
def inputs():
    r = _rng(0)
    b, h, s, d = 2, 4, 32, 8
    att = {a: r.standard_normal((b, h, s, d)).astype(np.float32)
           for a in "qkvw"}
    # packed documents: row 0 four of 8 tokens, row 1 a 5-token prefix
    att["seg"] = np.stack([np.repeat(np.arange(4), 8),
                           np.repeat([0, 1], [5, 27])]).astype(np.int32)
    ids = r.integers(0, 128, (4, 32), dtype=np.int32)
    moe_ids = r.integers(0, 128, (8, 16), dtype=np.int32)
    moe_ids[:, [3, 9]] = 5                       # separators: 3 documents
    seg_ids = ids.copy()
    seg_ids[:, [6, 13, 20]] = 5                  # 4 documents a row
    return {
        "att": att, "ids": ids, "moe_ids": moe_ids, "seg_ids": seg_ids,
        "llama_ids": r.integers(0, 128, (4, 16), dtype=np.int32),
        "gpt2": _port_params("gpt2", {}, 0),
        # MOE and MOE_AUX differ only where the parameters do not
        "moe": _port_params("gpt2", MOE, 2),
        "llama": _port_params("llama", {}, 1),
        "mha": jax.tree.map(lambda t: t.numpy(), mha_init(
            torch.Generator().manual_seed(4), 32)),
        "mha_x": r.standard_normal((2, 32, 32)).astype(np.float32),
        "perm_x": r.standard_normal((8, 3, 5)).astype(np.float32),
        "perm_w": r.standard_normal((8, 3, 5)).astype(np.float32),
    }


def _steps(family, kw, params, ids, sizes, training, sp_mode, steps=1):
    return ("steps", (family, kw, params, ids, ids, sizes),
            {"training": training, "sp_mode": sp_mode, "steps": steps})


def _w2_jobs(i):
    jobs = {"attention": ("attention", (2, i["att"]), {}),
            "dropout": ("dropout", (2, i["att"], 0.25, 7), {})}
    for mode in ("zigzag", "ulysses"):
        jobs[f"llama_{mode}"] = _steps("llama", {}, i["llama"],
                                       i["llama_ids"], {"sp": 2}, SGD, mode)
    return jobs


def _w4_jobs(i):
    jobs = {"attention": ("attention", (4, i["att"]), {}),
            "indivisible": ("indivisible", (), {}),
            "mha": ("mha", (4, i["mha"], i["mha_x"], i["att"]["seg"], 4), {}),
            "forward": ("forward", (4, {}, i["gpt2"], i["ids"]), {}),
            "forward_seg": ("forward", (4, {"segment_eos_id": 5}, i["gpt2"],
                                        i["seg_ids"]), {}),
            "trainer": ("trainer", ({"dp": 2, "sp": 2}, "zigzag", TINY,
                                    i["ids"]), {})}
    for tag, (sizes, sched, n_micro, mode) in STEP_CASES.items():
        if _size(sizes) == 4:
            jobs[tag] = _steps("gpt2", {}, i["gpt2"], i["ids"], sizes,
                               dict(SGD, schedule=sched,
                                    gradient_accumulation_steps=n_micro),
                               mode)
    return jobs


def _w8_jobs(i):
    jobs = {"ppermute": ("ppermute", (PERM8, i["perm_x"], i["perm_w"],
                                      FIXED8), {}),
            "dryrun_moe": _steps("gpt2", MOE, i["moe"], i["moe_ids"],
                                 {"dp": 2, "sp": 2, "ep": 2},
                                 dict(ADAM, optimizer="zero1_adamw"),
                                 "ulysses"),
            "dryrun_llama": _steps("llama", {}, i["llama"], i["llama_ids"],
                                   {"dp": 2, "tp": 2, "sp": 2},
                                   dict(ADAM, optimizer="zero2_adamw"),
                                   "ring"),
            "moe_aux": _steps("gpt2", MOE_AUX, i["moe"], i["moe_ids"],
                              {"dp": 2, "sp": 2, "ep": 2}, SGD, "ring")}
    for tag, (sizes, sched, n_micro, mode) in STEP_CASES.items():
        if _size(sizes) == 8:
            jobs[tag] = _steps("gpt2", {}, i["gpt2"], i["ids"], sizes,
                               dict(SGD, schedule=sched,
                                    gradient_accumulation_steps=n_micro),
                               mode)
    return jobs


@pytest.fixture(scope="module")
def w2(inputs, tmp_path_factory):
    return run_world(sp_world_case, 2, tmp_path_factory.mktemp("sp2"),
                     _w2_jobs(inputs), timeout=300)


@pytest.fixture(scope="module")
def w4(inputs, tmp_path_factory):
    return run_world(sp_world_case, 4, tmp_path_factory.mktemp("sp4"),
                     _w4_jobs(inputs), timeout=300)


@pytest.fixture(scope="module")
def w8(inputs, tmp_path_factory):
    return run_world(sp_world_case, 8, tmp_path_factory.mktemp("sp8"),
                     _w8_jobs(inputs), timeout=300)


def _worlds(request, sp):
    return request.getfixturevalue({2: "w2", 4: "w4", 8: "w8"}[sp])


def _sp_rows(ranks, tag, sp, dim, pick=lambda r: r):
    """The sp ranks' slices of one result put back together along
    ``dim`` (ranks with the same sp coordinate agree; a world of 8 with
    sp = 4 holds two replicas)."""
    parts = [pick(r[tag]) for r in ranks[:sp]]
    for i, r in enumerate(ranks[sp:], start=sp):
        np.testing.assert_array_equal(pick(r[tag]), parts[i % sp])
    return np.concatenate(parts, axis=dim)


# ---------------------------------------------------------------------
# ppermute
# ---------------------------------------------------------------------

def test_ppermute_values_and_grads_match_lax_ppermute(inputs, w8):
    x, w = inputs["perm_x"], inputs["perm_w"]
    mesh = jax_mesh(x=8)
    spec = P("x")

    def golden(perm):
        def local(xx, ww):
            y = jax.lax.ppermute(xx, "x", perm)
            g = jax.grad(lambda a: jnp.sum(jax.lax.ppermute(a, "x", perm)
                                           * ww))(xx)
            return y, g

        y, g = jcc.shard_map_fn(local, mesh, in_specs=(spec, spec),
                                out_specs=(spec, spec))(jnp.asarray(x),
                                                        jnp.asarray(w))
        return np.asarray(y), np.asarray(g)

    y, g = golden(PERM8)
    fy, fg = golden(FIXED8)
    for r, out in enumerate(w8):
        got = out["ppermute"]
        np.testing.assert_array_equal(got["y"], y[r])
        np.testing.assert_array_equal(got["grad"], g[r])
        np.testing.assert_array_equal(got["all_to_all"], got["y"])
        # fixed points only: kept or zeroed locally, nothing on the wire
        np.testing.assert_array_equal(got["fixed_y"], fy[r])
        np.testing.assert_array_equal(got["fixed_grad"], fg[r])
        assert got["fixed_calls"] == 0
    assert not y[6].any() and not y[7].any() and not g[6].any()
    assert fy[3].any() and not fy[5].any() and not fg[5].any()


# ---------------------------------------------------------------------
# the attentions against full attention on the gathered sequence
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def goldens(inputs):
    a = inputs["att"]
    q, k, v, w = (jnp.asarray(a[n]) for n in "qkvw")
    out = {}
    for causal in (False, True):
        for seg in (False, True):
            ids = jnp.asarray(a["seg"]) if seg else None

            def loss(qq, kk, vv):
                o = jattn.sdpa(qq, kk, vv, causal=causal, segment_ids=ids)
                return jnp.sum(o * w), o

            (_, o), gs = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                            has_aux=True)(q, k, v)
            out[(causal, seg)] = tuple(np.asarray(t) for t in (o, *gs))
    return out


@pytest.mark.parametrize("seg", [False, True], ids=["plain", "segments"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", ATTENTIONS)
@pytest.mark.parametrize("sp", [2, 4])
def test_sp_attention_matches_full_attention(request, goldens, sp, name,
                                             causal, seg):
    ranks = _worlds(request, sp)
    want = goldens[(causal, seg)]
    for i, (w, tol) in enumerate(zip(want, [(2e-4, 2e-5)] + [(5e-4, 1e-5)]
                                     * 3)):
        got = _sp_rows(ranks, "attention", sp, 2,
                       lambda r: r[(name, causal, seg)][i])
        np.testing.assert_allclose(got, w, rtol=tol[0], atol=tol[1],
                                   err_msg=("out", "dq", "dk", "dv")[i])


_JAX_ATTN = {"ring": ring_attention, "zigzag": zigzag_ring_attention,
             "ulysses": ulysses_attention}


@pytest.mark.parametrize("name", ATTENTIONS)
def test_sp_attention_matches_the_jax_function(inputs, w4, name):
    """Causal, with segments, sp = 4: the port's output against the JAX
    function's under ``shard_map`` (the gradients are held to the
    gathered attention's above)."""
    a = inputs["att"]
    fn = _JAX_ATTN[name]
    spec, sspec = P(None, None, "sp"), P(None, "sp")
    want = jcc.shard_map_fn(
        lambda q, k, v, seg: fn(q, k, v, axis="sp", causal=True,
                                segment_ids=seg),
        jax_mesh(sp=4), in_specs=(spec,) * 3 + (sspec,), out_specs=spec)(
        *(jnp.asarray(a[n]) for n in "qkv"), jnp.asarray(a["seg"]))
    got = _sp_rows(w4, "attention", 4, 2, lambda r: r[(name, True, True)][0])
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)


def test_ulysses_rejects_indivisible_heads(w4):
    for r in w4:
        assert "divisible" in r["indivisible"]


def test_mha_apply_sp_with_segments(inputs, w4):
    want = jattn.mha_apply(jax.tree.map(jnp.asarray, inputs["mha"]),
                           jnp.asarray(inputs["mha_x"]), num_heads=4,
                           causal=True,
                           segment_ids=jnp.asarray(inputs["att"]["seg"]))
    for mode in ATTENTIONS:
        got = _sp_rows(w4, "mha", 4, 1, lambda r: r[mode])
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-5, err_msg=mode)


@pytest.mark.parametrize("tag,kw,ids", [
    ("forward", {}, "ids"),
    ("forward_seg", {"segment_eos_id": 5}, "seg_ids")])
def test_gpt2_sp_forward_matches_single_device(inputs, w4, tag, kw, ids):
    cfg = jgpt2.GPT2Config.tiny(**kw)
    want = np.asarray(jgpt2.gpt2_apply(jax.tree.map(jnp.asarray,
                                                    inputs["gpt2"]),
                                       jnp.asarray(inputs[ids]), cfg))
    for mode in ATTENTIONS:
        got = _sp_rows(w4, tag, 4, 1, lambda r: r[mode])
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4,
                                   err_msg=mode)


# ---------------------------------------------------------------------
# train steps against JAX's single-device step
# ---------------------------------------------------------------------

def _tp_blocked(family, kw, flat, tp):
    return tp_blocked(kw, flat, tp) if family == "gpt2" else flat


_SGD_GOLDENS = {}


def _check_sgd(ranks, tag, family, kw, params, ids, sizes):
    key = (family, tuple(sorted(kw.items())))    # the same step: once
    if key not in _SGD_GOLDENS:
        _SGD_GOLDENS[key] = jax_single_steps(family, kw, params, ids, SGD)
    losses, want = _SGD_GOLDENS[key]
    want = _tp_blocked(family, kw, want, sizes.get("tp", 1))
    for r in ranks:
        run = r[tag]
        np.testing.assert_allclose(run["losses"], losses, rtol=1e-5)
        assert set(run["params"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(run["params"][k], w, rtol=5e-4,
                                       atol=2e-5, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("tag", list(STEP_CASES))
def test_gpt2_sp_train_step_matches_single_device(request, inputs, tag):
    sizes, *_ = STEP_CASES[tag]
    ranks = _worlds(request, _size(sizes))
    for r in ranks:
        assert r[tag]["strategy"] == (
            "sp" if list(sizes) == ["sp"] else
            "dp_sp" if "dp" in sizes else "custom")
    _check_sgd(ranks, tag, "gpt2", {}, inputs["gpt2"], inputs["ids"], sizes)


@pytest.mark.parametrize("mode", ["zigzag", "ulysses"])
def test_llama_sp_modes_match_single_device(inputs, w2, mode):
    _check_sgd(w2, f"llama_{mode}", "llama", {}, inputs["llama"],
               inputs["llama_ids"], {"sp": 2})


def _check_adam(ranks, tag, family, kw, params, ids, tp):
    losses, want = jax_single_steps(family, kw, params, ids,
                                    dict(ADAM, optimizer="adamw"))
    want = _tp_blocked(family, kw, want, tp)
    before = _tp_blocked(family, kw, dict(_flat(params)), tp)
    lr = ADAM["learning_rate"]
    sure = {k: np.abs(w - before[k]) >= 0.99 * lr for k, w in want.items()}
    assert sum(m.sum() for m in sure.values()) > 0.9 * sum(
        m.size for m in sure.values())
    for r in ranks:
        run = r[tag]
        np.testing.assert_allclose(run["losses"], losses, rtol=1e-5)
        for k, w in want.items():
            diff = np.abs(run["params"][k] - w)
            assert diff[sure[k]].max(initial=0.0) <= 1e-5 * np.abs(w).max(), \
                (tag, k)
            assert diff.max() <= 2 * lr, (tag, k)


def test_dryrun_gpt2_moe_dp_sp_ep_ulysses_step(inputs, w8):
    """``__graft_entry__._dryrun_sp_ep``'s mesh and step (dp x sp x ep,
    Ulysses, packed segments, zero1_adamw, clip 1.0) against one device."""
    for r in w8:
        assert r["dryrun_moe"]["strategy"] == "custom"
    _check_adam(w8, "dryrun_moe", "gpt2", MOE, inputs["moe"],
                inputs["moe_ids"], tp=1)


def test_dryrun_llama_dp_tp_sp_ring_zero2_step(inputs, w8):
    """``__graft_entry__._dryrun_llama``'s mesh and step (dp x tp x sp,
    ring, zero2_adamw, clip 1.0) against one device."""
    _check_adam(w8, "dryrun_llama", "llama", {}, inputs["llama"],
                inputs["llama_ids"], tp=2)


def test_moe_aux_loss_over_sp_matches_jax_mesh_step(inputs, w8):
    """With the load-balance term on (each rank's own over its tokens,
    averaged over sp) and the default capacity, the dp x sp x ep SGD step
    against JAX's step on the same mesh."""
    sizes = {"dp": 2, "sp": 2, "ep": 2}
    cfg = JaxConfig.from_dict({"mesh_dim": list(sizes.values()),
                               "mesh_name": list(sizes),
                               "training": dict(SGD)})
    strat = jax_get_strategy(None, cfg)
    spec = jgpt2.gpt2_model_spec(jgpt2.GPT2Config.tiny(**MOE_AUX))
    opt = jax_make_optimizer(cfg)
    p = strat.shard_params(spec, jax.tree.map(jnp.asarray, inputs["moe"]))
    s = strat.init_opt_state(spec, opt, p)
    ids = jnp.asarray(inputs["moe_ids"])
    p, _, loss = strat.make_train_step(spec, opt)(
        p, s, strat.shard_batch((ids, ids), spec))
    want = dict(_flat(_np_tree(p)))
    for r in w8:
        run = r["moe_aux"]
        np.testing.assert_allclose(run["losses"], [float(loss)], rtol=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(run["params"][k], w, rtol=5e-4,
                                       atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------
# dropout and the trainer
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sp_dropout_keeps_its_rate_with_distinct_masks(w2, mode):
    runs = [r["dropout"][mode] for r in w2]
    for run in runs:
        assert run["zero_equal"]
        assert run["masks"] >= 1
        # 0.75 kept; the bound is 5 standard deviations of the share
        sd = np.sqrt(0.75 * 0.25 / run["n"])
        assert abs(run["keep"] - 0.75) <= 5 * sd, run["keep"]
    a, b = runs[0]["first"], runs[1]["first"]
    assert a.shape == b.shape and (a != b).mean() > 0.1


def test_trainer_on_dp_sp_matches_one_device(inputs, w4):
    """``Trainer.fit`` and its evaluation on dp x sp (zigzag) against the
    same trainer on one device (the same seeded initial parameters), and
    the losses before and after its step against JAX's single-device
    AdamW steps from those parameters."""
    from quintnet_tpu_torch import bridge
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    ids = inputs["ids"]
    config = Config.from_dict({"training": {
        "batch_size": len(ids), "optimizer": "adamw", "learning_rate": 1e-3,
        "epochs": 1, "log_every": 0}})
    torch.set_num_threads(1)
    tr = Trainer(config, gpt2_model_spec(GPT2Config.tiny(**TINY)),
                 task_type="clm", device="cpu", log_fn=lambda m: None)
    t = torch.tensor(ids)
    params = tr.init_state()[0]
    np_params = bridge.gpt2_params_to_numpy(params)
    before = tr.evaluate(params, [(t, t)])["loss"]
    hist = tr.fit(lambda ep: [(t, t)], epochs=1,
                  val_batches_fn=lambda ep: [(t, t)])
    # JAX: the loss at the initial parameters, then after one step
    jax_losses, _ = jax_single_steps(
        "gpt2", TINY, np_params, ids,
        {"optimizer": "adamw", "learning_rate": 1e-3}, steps=2)
    np.testing.assert_allclose(before, jax_losses[0], rtol=1e-5)
    np.testing.assert_allclose(hist.val_loss, jax_losses[1:], rtol=1e-5)
    for r in w4:
        run = r["trainer"]
        assert run["strategy"] == "dp_sp"
        np.testing.assert_allclose(run["eval_before"], before, rtol=1e-5)
        np.testing.assert_allclose(run["eval_before"], jax_losses[0],
                                   rtol=1e-5)
        np.testing.assert_allclose(run["val_loss"], jax_losses[1:],
                                   rtol=1e-5)
        np.testing.assert_allclose(run["train_loss"], hist.train_loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(run["val_loss"], hist.val_loss,
                                   rtol=1e-5)


def test_shard_batch_on_sp_mesh_needs_the_model(w4):
    for r in w4:
        assert "needs the model" in r["trainer"]["no_model"]


def test_long_context_example_trains_on_cpu_ranks(capfd):
    """``examples/long_context.py`` spawns its sp ranks (here 2, Ulysses
    over a tiny GPT-2 at 128 positions), trains, and only rank 0 prints;
    ``--serve`` (chunked prefill) serves a prompt past its window as the
    widened engine does, and ``--serve --simulate 2`` (sp prefill) raises,
    naming its ROADMAP.md item."""
    from quintnet_tpu_torch.examples import long_context

    assert long_context.main(["--device", "cpu", "--nproc", "2", "--seq",
                              "128", "--steps", "2", "--sp-mode",
                              "ulysses"]) is None
    out = capfd.readouterr().out
    assert out.count("mesh sp=2, seq 128 -> 64/rank, sp_mode=ulysses") == 1
    assert out.count("step 1: loss") == 1
    with pytest.raises(NotImplementedError, match="item 7"):
        long_context.main(["--serve", "--simulate", "2"])
    assert len(long_context.main(["--serve", "--device", "cpu",
                                  "--serve-prompt", "150",
                                  "--serve-new", "3"])) == 3
    assert "identical to the widened single-shot engine: True" in \
        capfd.readouterr().out
