"""The port's vocab parallelism (``models/gpt2.clm_loss_vp``, the
vocab-sharded tables of GPT-2 and Llama under tp, their pipelines'
``SplitHead``, the tp decoders, padded-vocab serving) against the JAX
package.

Three gloo worlds of CPU ranks (2, 4 and 8), each running every case of
its size once (``tests/_torch_vp_cases.py``); the goldens are JAX's on
one device or under ``shard_map`` on conftest's CPU devices:

- ``clm_loss_vp`` on tp = 2 and on tp x sp = 2 x 2, with and without a
  padded vocabulary: the loss against JAX's ``clm_loss_vp`` under
  ``shard_map`` and its dense ``clm_loss`` (1e-6 relative), each rank's
  gradient of its block against JAX's per-device gradient under
  ``shard_map`` (1e-5: psum transposes to a psum in both, so each is tp x
  sp times the true block) and against the dense gradient times that
  factor;
- the five strategy cases of ``tests/test_vp.py:119-126`` (tp, dp x tp,
  3D AFAB and 1F1B over 2 micro-batches, tp x sp x pp 1F1B) for GPT-2,
  and its Llama cases (tied and untied on tp, dp x tp, 3D, tp x sp x pp),
  against JAX's single-device SGD steps at JAX's own tolerances (losses
  ``rtol=1e-4``, parameters ``rtol=2e-4, atol=1e-5``);
- padded equals unpadded (GPT-2, Llama tied): the losses, the padded rows
  of the table untouched (zero gradient), the rest the unpadded run's;
  without tp the padded columns masked (``gpt2_apply``, greedy never
  picks one); a vocabulary tp does not divide refused;
- the compositions of ``tests/test_vp.py:378, :413`` (Llama-MoE with
  segments on tp x sp x ep, GPT-2 with segments on tp x sp): the loss;
- ZeRO-1, FSDP and a sharded checkpoint on dp x tp with the vocab-sharded
  table: the same steps as the replicated table's, and the checkpoint
  back bit for bit on the same mesh and whole with no mesh;
- ``gpt2_generate_tp`` and ``llama_generate_tp`` with a padded
  vocab-parallel table (garbage in the padded rows) against one device
  on the unpadded model: greedy against JAX's ``gpt2_generate`` /
  ``llama_generate``, sampled against the port's one-device chain;
- padded-vocab GPT-2 serving: the engine's greedy streams equal JAX's
  engine on the same padded weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist import run_world
from _torch_mesh_checks import tp_blocked
from _torch_vp_cases import vp_world_case
from quintnet_tpu.core import collectives as jcc
from quintnet_tpu.core.mesh import mesh_from_sizes as jax_mesh
from quintnet_tpu.models import gpt2 as jgpt2
from quintnet_tpu.models import llama as jllama

P = jax.sharding.PartitionSpec
VOCAB = 128
SGD = {"optimizer": "sgd", "learning_rate": 0.05, "grad_clip_norm": None}
PAD_ROW = 3.7       # garbage in the padded rows: only the masks hide it
LLAMA_MOE = dict(n_experts=4, expert_top_k=2, expert_capacity=4096,
                 aux_loss_weight=0.0, segment_eos_id=5)
# (family, config kw, mesh, schedule, micro-batches)
STEP_CASES = {
    "gpt2_tp": ("gpt2", {}, {"tp": 2}, "afab", 1),
    "gpt2_dp_tp": ("gpt2", {}, {"dp": 2, "tp": 2}, "afab", 1),
    "gpt2_3d_afab": ("gpt2", {}, {"dp": 2, "tp": 2, "pp": 2}, "afab", 2),
    "gpt2_3d_1f1b": ("gpt2", {}, {"dp": 2, "tp": 2, "pp": 2}, "1f1b", 2),
    "gpt2_tp_sp_pp": ("gpt2", {}, {"tp": 2, "sp": 2, "pp": 2}, "1f1b", 2),
    "llama_tp_tied": ("llama", {}, {"tp": 2}, "afab", 1),
    "llama_tp_untied": ("llama", {"tie_embeddings": False}, {"tp": 2},
                        "afab", 1),
    "llama_dp_tp": ("llama", {}, {"dp": 2, "tp": 2}, "afab", 1),
    "llama_3d_1f1b": ("llama", {}, {"dp": 2, "tp": 2, "pp": 2}, "1f1b", 2),
    "llama_tp_sp_pp": ("llama", {}, {"tp": 2, "sp": 2, "pp": 2}, "1f1b",
                       2),
}


def _size(sizes):
    return int(np.prod(list(sizes.values())))


def _port_params(family, kw, seed):
    from quintnet_tpu_torch import bridge
    from quintnet_tpu_torch.models import gpt2, llama

    g = torch.Generator().manual_seed(seed)
    if family == "gpt2":
        return bridge.gpt2_params_to_numpy(gpt2.gpt2_init(
            g, gpt2.GPT2Config.tiny(**kw)))
    return bridge.llama_params_to_numpy(llama.llama_init(
        g, llama.LlamaConfig.tiny(**kw)))


def _padded(np_params, family, rows):
    """The table padded with ``rows`` rows of ``PAD_ROW``."""
    out = jax.tree.map(np.copy, np_params)
    key = "wte" if family == "gpt2" else "tok"
    t = out["embedding"][key]
    out["embedding"][key] = np.concatenate(
        [t, np.full((rows, t.shape[1]), PAD_ROW, np.float32)])
    return out


def _data(n=8, t=16, seed=3, vocab=VOCAB):
    """Ids and labels with a fixed 3-token prompt masked in every row (the
    same valid count on every dp shard, as ``tests/test_vp.py`` makes
    them)."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, vocab, (n, t)).astype(np.int32)
    labels = np.where(np.arange(t)[None] < 3, -100, ids).astype(np.int32)
    return ids, labels


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(0)
    ids, labels = _data()
    pad_ids, _ = _data(vocab=123, seed=7)
    pad_labels = np.where(r.uniform(size=pad_ids.shape) < 0.1, -100,
                          pad_ids).astype(np.int32)
    seg_ids = r.integers(0, VOCAB, (4, 16)).astype(np.int32)
    seg_ids[:, 6] = 5            # a separator in every row, off the sp cut
    return {
        "ids": ids, "labels": labels, "pad_ids": pad_ids,
        "pad_labels": pad_labels, "seg_ids": seg_ids,
        "logits": r.standard_normal((4, 12, VOCAB)).astype(np.float32),
        "loss_labels": np.where(r.uniform(size=(4, 12)) < 0.2, -100,
                                r.integers(0, VOCAB, (4, 12))
                                ).astype(np.int32),
        "gen_ids": r.integers(0, 123, (2, 5)).astype(np.int32),
        "gpt2": _port_params("gpt2", {}, 0),
        "gpt2_123": _port_params("gpt2", {"vocab_size": 123}, 1),
        "llama": _port_params("llama", {}, 2),
        "llama_untied": _port_params("llama", {"tie_embeddings": False}, 3),
        "llama_122": _port_params("llama", {"vocab_size": VOCAB - 6}, 4),
        "llama_moe": _port_params("llama", LLAMA_MOE, 5),
    }


def _steps(family, kw, params, ids, labels, sizes, schedule="afab",
           n_micro=1, training=None):
    return ("steps", (family, dict(kw, vocab_parallel=True), params, ids,
                      labels, sizes),
            {"training": dict(training or SGD, schedule=schedule,
                              gradient_accumulation_steps=n_micro),
             "steps": 2})


def _case_params(i, family, kw):
    return i["llama_untied"] if kw.get("tie_embeddings") is False else \
        i[family]


def _loss_jobs(i, sizes):
    return {("loss", pad): ("loss", (sizes, i["logits"], i["loss_labels"]),
                            {"vocab_size": 120 if pad else None})
            for pad in (False, True)}


def _w2_jobs(i, tmp):
    jobs = _loss_jobs(i, {"tp": 2})
    for tag, (fam, kw, sizes, sched, n) in STEP_CASES.items():
        if _size(sizes) == 2:
            jobs[tag] = _steps(fam, kw, _case_params(i, fam, kw), i["ids"],
                               i["labels"], sizes, sched, n)
    jobs["gpt2_padded"] = _steps(
        "gpt2", {"vocab_size": 123, "padded_vocab_size": VOCAB},
        _padded(i["gpt2_123"], "gpt2", 5), i["pad_ids"], i["pad_labels"],
        {"tp": 2})
    jobs["llama_padded"] = _steps(
        "llama", {"vocab_size": VOCAB - 6, "padded_vocab_size": VOCAB},
        _padded(i["llama_122"], "llama", 6), i["ids"] % (VOCAB - 6),
        i["ids"] % (VOCAB - 6), {"tp": 2})
    jobs["gpt2_generate"] = ("generate", (
        "gpt2", {"vocab_size": 123, "padded_vocab_size": VOCAB,
                 "vocab_parallel": True},
        _padded(i["gpt2_123"], "gpt2", 5), i["gen_ids"], 6, True), {})
    jobs["llama_generate"] = ("generate", (
        "llama", {"vocab_size": VOCAB - 6, "padded_vocab_size": VOCAB,
                  "vocab_parallel": True},
        _padded(i["llama_122"], "llama", 6), i["gen_ids"] % (VOCAB - 6), 5,
        False), {})
    return jobs


def _w4_jobs(i, tmp):
    jobs = _loss_jobs(i, {"tp": 2, "sp": 2})
    for tag, (fam, kw, sizes, sched, n) in STEP_CASES.items():
        if _size(sizes) == 4:
            jobs[tag] = _steps(fam, kw, _case_params(i, fam, kw), i["ids"],
                               i["labels"], sizes, sched, n)
    jobs["gpt2_seg_tp_sp"] = _steps(
        "gpt2", {"segment_eos_id": 5}, i["gpt2"], i["seg_ids"],
        i["seg_ids"], {"tp": 2, "sp": 2})
    for tag, training in (("zero1", dict(SGD, optimizer="zero1_sgd")),
                          ("fsdp", dict(SGD, fsdp=True))):
        for vp in (True, False):
            jobs[(tag, vp)] = ("steps", (
                "gpt2", {"vocab_parallel": vp}, i["gpt2"], i["ids"],
                i["labels"], {"dp": 2, "tp": 2}),
                {"training": training, "steps": 2})
    jobs["ckpt"] = ("ckpt", ({"dp": 2, "tp": 2}, i["gpt2"], i["ids"],
                             str(tmp)), {})
    return jobs


def _w8_jobs(i, tmp):
    jobs = {}
    for tag, (fam, kw, sizes, sched, n) in STEP_CASES.items():
        if _size(sizes) == 8:
            jobs[tag] = _steps(fam, kw, _case_params(i, fam, kw), i["ids"],
                               i["labels"], sizes, sched, n)
    jobs["llama_moe_seg_tp_sp_ep"] = _steps(
        "llama", LLAMA_MOE, i["llama_moe"], i["seg_ids"], i["seg_ids"],
        {"tp": 2, "sp": 2, "ep": 2})
    return jobs


@pytest.fixture(scope="module")
def w2(inputs, tmp_path_factory):
    return run_world(vp_world_case, 2, tmp_path_factory.mktemp("vp2"),
                     _w2_jobs(inputs, None), timeout=300)


@pytest.fixture(scope="module")
def w4(inputs, tmp_path_factory):
    return run_world(vp_world_case, 4, tmp_path_factory.mktemp("vp4"),
                     _w4_jobs(inputs, tmp_path_factory.mktemp("vp4ck")),
                     timeout=300)


@pytest.fixture(scope="module")
def w8(inputs, tmp_path_factory):
    return run_world(vp_world_case, 8, tmp_path_factory.mktemp("vp8"),
                     _w8_jobs(inputs, None), timeout=300)


def _worlds(request, n):
    return request.getfixturevalue({2: "w2", 4: "w4", 8: "w8"}[n])


# ---------------------------------------------------------------------
# the sharded cross-entropy against JAX's
# ---------------------------------------------------------------------

def _jax_loss_vp(logits, labels, sizes, vocab_size):
    """JAX's ``clm_loss_vp`` under ``shard_map`` on ``sizes``' mesh: the
    loss and each device's gradient of its block (``jax.grad`` inside the
    map, so psum transposes to a psum as the port's backward does),
    assembled whole."""
    sp = "sp" if "sp" in sizes else None
    mesh = jax_mesh(**sizes)
    spec = P(None, sp, "tp")

    def local(lg, lb):
        def f(x):
            return jgpt2.clm_loss_vp(x, lb, tp_axis="tp", sp_axis=sp,
                                     vocab_size=vocab_size)
        return f(lg), jax.grad(f)(lg)

    loss, grad = jax.jit(jcc.shard_map_fn(
        local, mesh, in_specs=(spec, P(None, sp)), out_specs=(P(), spec)))(
        jnp.asarray(logits), jnp.asarray(labels))
    return float(loss), np.asarray(grad)


def _dense_loss(logits, labels, vocab_size):
    def f(x):
        if vocab_size is not None:
            x = jnp.where(jnp.arange(x.shape[-1]) < vocab_size, x,
                          jnp.finfo(jnp.float32).min)
        return jgpt2.clm_loss(x, labels)
    loss, grad = jax.jit(jax.value_and_grad(f))(jnp.asarray(logits))
    return float(loss), np.asarray(grad)


def _port_blocks(ranks, tag, sizes, key):
    """The ranks' blocks of one result put together [B, T, V] (tp
    columns, sp rows)."""
    at = {(r[tag]["sp"], r[tag]["tp"]): r[tag][key] for r in ranks}
    return np.concatenate([
        np.concatenate([at[(s, t)] for t in range(sizes["tp"])], axis=-1)
        for s in range(sizes.get("sp", 1))], axis=1)


@pytest.mark.parametrize("pad", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("world", [2, 4], ids=["tp2", "tp2_sp2"])
def test_clm_loss_vp_matches_jax(request, inputs, world, pad):
    sizes = {"tp": 2} if world == 2 else {"tp": 2, "sp": 2}
    ranks = _worlds(request, world)
    vs = 120 if pad else None
    lg, lb = inputs["logits"], inputs["loss_labels"]
    want_loss, want_grad = _jax_loss_vp(lg, lb, sizes, vs)
    dense_loss, dense_grad = _dense_loss(lg, lb, vs)
    np.testing.assert_allclose(want_loss, dense_loss, rtol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r[("loss", pad)]["loss"], want_loss,
                                   rtol=1e-6)
    got = _port_blocks(ranks, ("loss", pad), sizes, "grad")
    np.testing.assert_allclose(got, want_grad, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got, dense_grad * world, rtol=1e-5,
                               atol=1e-8)
    if pad:
        assert not got[..., 120:].any()      # padded columns: no mass


# ---------------------------------------------------------------------
# train steps against JAX's single-device SGD steps
# ---------------------------------------------------------------------

_GOLDENS = {}


def _jax_sgd(family, kw, np_params, ids, labels, steps=2):
    """JAX's single-device SGD(0.05) steps on (ids, labels): the losses
    and the final parameters, flat."""
    key = (family, tuple(sorted(kw.items())), ids.tobytes(),
           labels.tobytes())
    if key in _GOLDENS:
        return _GOLDENS[key]
    if family == "gpt2":
        spec = jgpt2.gpt2_model_spec(jgpt2.GPT2Config.tiny(**kw))
    else:
        spec = jllama.llama_model_spec(jllama.LlamaConfig.tiny(**kw))
    opt = optax.sgd(0.05)
    p = jax.tree.map(jnp.asarray, np_params)
    state = opt.init(p)
    batch = (jnp.asarray(ids), jnp.asarray(labels))
    grad_fn = jax.jit(jax.value_and_grad(spec.loss_fn))
    losses = []
    for _ in range(steps):
        loss, g = grad_fn(p, batch)
        up, state = opt.update(g, state, p)
        p = optax.apply_updates(p, up)
        losses.append(float(loss))
    _GOLDENS[key] = losses, dict(_flat(jax.tree.map(np.asarray, p)))
    return _GOLDENS[key]


def _check_run(run, losses, want, family, tp, rtol_loss=1e-4):
    np.testing.assert_allclose(run["losses"], losses, rtol=rtol_loss)
    if family == "gpt2":
        want = tp_blocked({}, want, tp)
    assert set(run["params"]) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(run["params"][k], w, rtol=2e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("tag", list(STEP_CASES))
def test_vp_step_matches_single_device(request, inputs, tag):
    family, kw, sizes, *_ = STEP_CASES[tag]
    ranks = _worlds(request, _size(sizes))
    losses, want = _jax_sgd(family, kw, _case_params(inputs, family, kw),
                            inputs["ids"], inputs["labels"])
    for r in ranks:
        run = r[tag]
        assert run["specs"]["embedding." + ("wte" if family == "gpt2"
                                            else "tok")] == ("tp", None)
        _check_run(run, losses, want, family, sizes.get("tp", 1))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_padded_vocab_matches_unpadded(inputs, w2, family):
    """The padded vocab-parallel run on tp = 2 equals the unpadded model
    on one device; the padded rows get zero gradient (SGD leaves them
    exactly as they were)."""
    if family == "gpt2":
        v, base, ids, labels = 123, inputs["gpt2_123"], inputs["pad_ids"], \
            inputs["pad_labels"]
        key = "embedding.wte"
    else:
        v, base = VOCAB - 6, inputs["llama_122"]
        ids = labels = inputs["ids"] % (VOCAB - 6)
        key = "embedding.tok"
    losses, want = _jax_sgd(family, {"vocab_size": v}, base, ids, labels)
    for r in w2:
        run = r[f"{family}_padded"]
        np.testing.assert_allclose(run["losses"], losses, rtol=2e-5)
        table = run["params"][key]
        np.testing.assert_array_equal(table[v:], np.float32(PAD_ROW))
        run = dict(run, params={k: (t[:v] if k == key else t)
                                for k, t in run["params"].items()})
        _check_run(run, losses, want, family, 2, rtol_loss=2e-5)


def test_padded_vocab_masked_without_tp(inputs):
    """No tp: a vocab-parallel padded config masks its padded columns,
    equal to the unpadded model and JAX's padded forward."""
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config, clm_loss,
                                                gpt2_apply)

    base = GPT2Config.tiny(vocab_size=123)
    padded = dataclasses.replace(base, vocab_parallel=True,
                                 padded_vocab_size=VOCAB)
    ids = inputs["pad_ids"][:2, :12]
    p = _padded(inputs["gpt2_123"], "gpt2", 5)
    got = gpt2_apply(gpt2_params_from_numpy(p, "cpu"),
                     torch.tensor(ids).long(), padded)
    want = np.asarray(jgpt2.gpt2_apply(
        jax.tree.map(jnp.asarray, p), jnp.asarray(ids),
        jgpt2.GPT2Config.tiny(vocab_size=123, vocab_parallel=True,
                              padded_vocab_size=VOCAB)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    base_logits = gpt2_apply(gpt2_params_from_numpy(inputs["gpt2_123"],
                                                    "cpu"),
                             torch.tensor(ids).long(), base)
    np.testing.assert_allclose(got[..., :123].numpy(), base_logits.numpy(),
                               rtol=1e-6)
    assert (got.argmax(-1) < 123).all()
    t = torch.tensor(ids).long()
    assert abs(float(clm_loss(got, t)) - float(clm_loss(base_logits, t))) \
        <= 1e-6 * float(clm_loss(base_logits, t))


def test_vocab_tp_does_not_divide_is_refused(inputs):
    from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                           llama_params_from_numpy)
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_to_tp_layout
    from quintnet_tpu_torch.models.llama import LlamaConfig, llama_model_spec

    bad = GPT2Config.tiny(vocab_size=123, vocab_parallel=True)
    p = gpt2_params_from_numpy(inputs["gpt2_123"], "cpu")
    with pytest.raises(ValueError, match="vocab_parallel"):
        gpt2_to_tp_layout(p, bad, 2)
    gpt2_to_tp_layout(p, dataclasses.replace(bad, vocab_parallel=False), 2)
    lbad = LlamaConfig.tiny(vocab_size=127, vocab_parallel=True)
    lp = llama_params_from_numpy(inputs["llama_122"], "cpu")
    with pytest.raises(ValueError, match="vocab_parallel"):
        llama_model_spec(lbad).to_tp_layout(lp, 2)


def test_segments_compositions_match_single_device(inputs, w4, w8):
    """``tests/test_vp.py:378, :413``: Llama-MoE with segments on tp x sp
    x ep and GPT-2 with segments on tp x sp, the loss against one
    device."""
    for ranks, tag, fam, kw, params in (
            (w4, "gpt2_seg_tp_sp", "gpt2", {"segment_eos_id": 5},
             inputs["gpt2"]),
            (w8, "llama_moe_seg_tp_sp_ep", "llama", LLAMA_MOE,
             inputs["llama_moe"])):
        losses, _ = _jax_sgd(fam, kw, params, inputs["seg_ids"],
                             inputs["seg_ids"], steps=1)
        for r in ranks:
            np.testing.assert_allclose(r[tag]["losses"][0], losses[0],
                                       rtol=1e-4, err_msg=tag)


@pytest.mark.parametrize("tag", ["zero1", "fsdp"])
def test_zero_and_fsdp_shard_the_vocab_table(inputs, w4, tag):
    """dp x tp SGD steps under ZeRO-1 (the update on each rank's chunk of
    the flattened shards) or FSDP (the blocks dp-sharded too), with the
    vocab-sharded table and with the replicated one: both JAX's
    single-device steps."""
    losses, want = _jax_sgd("gpt2", {}, inputs["gpt2"], inputs["ids"],
                            inputs["labels"])
    for r in w4:
        vp, rep = r[(tag, True)], r[(tag, False)]
        assert vp["specs"]["embedding.wte"][0] == "tp"
        assert "tp" not in rep["specs"]["embedding.wte"]
        for run in (vp, rep):
            _check_run(run, losses, want, "gpt2", 2)


def test_sharded_checkpoint_round_trips_the_vocab_table(w4):
    for r in w4:
        got = r["ckpt"]
        assert got["local_wte_rows"] == VOCAB // 2
        assert got["same_mesh_equal"] and got["no_mesh_wte_equal"]


# ---------------------------------------------------------------------
# tp decoders
# ---------------------------------------------------------------------

def test_gpt2_generate_tp_vocab_parallel_matches_one_device(inputs, w2):
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.gpt2_generate import gpt2_generate

    ids = inputs["gen_ids"]
    base = jgpt2.GPT2Config.tiny(vocab_size=123)
    from quintnet_tpu.models.gpt2_generate import gpt2_generate as jgen

    want = np.asarray(jgen(jax.tree.map(jnp.asarray, inputs["gpt2_123"]),
                           jnp.asarray(ids), base, max_new_tokens=6))
    port = gpt2_params_from_numpy(inputs["gpt2_123"], "cpu")
    cfg = GPT2Config.tiny(vocab_size=123)
    sampled = gpt2_generate(port, ids, cfg, max_new_tokens=6,
                            temperature=0.8, top_k=5, seed=11)
    for r in w2:
        got = r["gpt2_generate"]
        assert got["wte_rows"] == VOCAB // 2
        np.testing.assert_array_equal(got["greedy"], want)
        np.testing.assert_array_equal(got["sampled"], sampled)


def test_llama_generate_tp_vocab_parallel_matches_one_device(inputs, w2):
    from quintnet_tpu.models.llama_generate import llama_generate as jgen

    ids = inputs["gen_ids"] % (VOCAB - 6)
    want = np.asarray(jgen(jax.tree.map(jnp.asarray, inputs["llama_122"]),
                           jnp.asarray(ids),
                           jllama.LlamaConfig.tiny(vocab_size=VOCAB - 6),
                           max_new_tokens=5))
    for r in w2:
        np.testing.assert_array_equal(r["llama_generate"]["greedy"], want)


# ---------------------------------------------------------------------
# padded-vocab serving
# ---------------------------------------------------------------------

def test_padded_vocab_serving_matches_jax(inputs):
    """``gpt2_family`` of a padded config serves: greedy streams equal the
    JAX engine's on the same padded weights (garbage padded rows), and no
    stream holds a padding id."""
    from quintnet_tpu.serve import ServeEngine as JaxServeEngine
    from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
    from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    p = _padded(inputs["gpt2_123"], "gpt2", 5)
    kw = dict(max_slots=2, block_size=4, num_blocks=32, max_seq_len=32)
    te = ServeEngine(gpt2_family(GPT2Config.tiny(
        vocab_size=123, padded_vocab_size=VOCAB)),
        gpt2_params_from_numpy(p, "cpu"), device="cpu", **kw)
    je = JaxServeEngine(jax_gpt2_family(jgpt2.GPT2Config.tiny(
        vocab_size=123, padded_vocab_size=VOCAB)),
        jax.tree.map(jnp.asarray, p), attn_kernel="xla", **kw)
    prompts = [inputs["pad_ids"][i, :n] for i, n in enumerate((5, 9, 3))]
    outs = []
    for eng in (je, te):
        rids = [eng.submit(q, 8) for q in prompts]
        eng.run()
        outs.append([eng.result(r) for r in rids])
    for w, g in zip(*outs):
        np.testing.assert_array_equal(g, w)
        assert (g < 123).all()
