"""The port's Llama (``models/llama.py``) against the JAX package.

The counterparts of ``tests/test_llama.py``'s training goldens, on JAX
weights carried over by ``bridge.llama_params_from_numpy``: the tiny
config's logits and every gradient of the CLM loss (``rtol=1e-5`` on
losses and logits, ``rtol=1e-4, atol=1e-6`` on gradients: f32 sums in
another order); the layers Llama adds (RMSNorm, SwiGLU, rotary tables
with llama3 scaling, GQA's ``repeat_kv``); remat and the flash path (the
kernels' plain versions on the CPU) equal to the plain forward
(``rtol=1e-5, atol=1e-5``, the JAX test's); GQA equal to MHA with the
k/v columns repeated; the rope scaling against JAX's
``llama3_scaled_inv_freq`` (the HF oracle itself is in
``tests/test_torch_hf_io.py``); tied embeddings,
under pp too; packed-document segment ids; Llama-MoE (one expert ==
the dense SwiGLU; upcycling near the dense model at ``2e-3``, the JAX
test's); the HF readers and writer against JAX's on the same state
dict; and the strategies on gloo CPU worlds of 2, 4 and 8 ranks
(dp, tp, dp x tp, pp with 1F1B, dp x tp x pp, ep, dp x ep, MoE under
pp) against JAX's single-device SGD step (loss ``rtol=1e-5``; the MoE
ep runs at ``2e-4``, the JAX test's; parameters ``rtol=2e-4,
atol=1e-5``). The refusals name ROADMAP.md places that exist.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist import run_world
from _torch_dist_cases import jobs_world_case
from quintnet_tpu.models import llama as jl
from quintnet_tpu.nn import attention as jattn
from quintnet_tpu.nn import layers as jlayers
from quintnet_tpu_torch.bridge import (llama_params_from_numpy,
                                       llama_params_to_numpy)
from quintnet_tpu_torch.models import llama as pl
from quintnet_tpu_torch.nn import attention as pattn
from quintnet_tpu_torch.nn import layers as players

KW = {}                                  # LlamaConfig.tiny()
TIED = {"tie_embeddings": True}
MOE = dict(n_experts=4, expert_top_k=2, expert_capacity=4096,
           aux_loss_weight=0.0)
SGD = {"optimizer": "sgd", "learning_rate": 0.05, "grad_clip_norm": None}


def _ids(b=2, s=16, seed=0, v=128):
    return np.random.default_rng(seed).integers(0, v, (b, s)).astype(
        np.int64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), tree


def _jax(kw, seed=0):
    cfg = jl.LlamaConfig.tiny(**kw)
    return cfg, jl.llama_init(jax.random.key(seed), cfg)


def _port(jparams, grad=False):
    p = llama_params_from_numpy(_np_tree(jparams), "cpu")
    if grad:
        for _, leaf in _flat(p):
            leaf.requires_grad_(True)
    return p


def _jax_sgd(kw, jparams, ids, n_micro=None):
    """JAX's single-device SGD step (lr 0.05) on the CLM loss (the mean
    over ``n_micro`` micro-batches when given): (loss, params flat)."""
    model = jl.llama_model_spec(jl.LlamaConfig.tiny(**kw))
    x = jnp.asarray(ids)

    def loss_fn(p):
        if n_micro is None:
            return model.loss_fn(p, (x, x))
        k = len(ids) // n_micro
        return jnp.mean(jnp.stack([model.loss_fn(p, (x[i * k:(i + 1) * k],
                                                     x[i * k:(i + 1) * k]))
                                   for i in range(n_micro)]))

    loss, g = jax.value_and_grad(loss_fn)(jparams)
    opt = optax.sgd(0.05)
    up, _ = opt.update(g, opt.init(jparams), jparams)
    return float(loss), dict(_flat(_np_tree(optax.apply_updates(jparams,
                                                                up))))


# ---------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [KW, TIED, MOE], ids=["untied", "tied",
                                                      "moe"])
def test_logits_loss_and_grads_match_jax(kw):
    cfg, jp = _jax(kw)
    ids = _ids()
    jlogits = jl.llama_apply(jp, jnp.asarray(ids), cfg)
    jloss, jg = jax.value_and_grad(jl.llama_model_spec(cfg).loss_fn)(
        jp, (jnp.asarray(ids), jnp.asarray(ids)))
    p = _port(jp, grad=True)
    pcfg = pl.LlamaConfig.tiny(**kw)
    t = torch.tensor(ids)
    np.testing.assert_allclose(
        pl.llama_apply(p, t, pcfg).detach().numpy(), np.asarray(jlogits),
        rtol=1e-5, atol=1e-5)
    loss = pl.llama_model_spec(pcfg).loss_fn(p, (t, t))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = dict(_flat(_np_tree(jg)))
    for k, leaf in _flat(p):
        np.testing.assert_allclose(leaf.grad.numpy(), want[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_remat_and_flashpath_match_plain():
    """remat=True and the flash path (the kernels' plain versions on the
    CPU) == the plain forward, and the plain forward == JAX's."""
    cfg, jp = _jax(KW)
    p, pcfg = _port(jp), pl.LlamaConfig.tiny()
    t = torch.tensor(_ids())
    base = pl.llama_apply(p, t, pcfg)
    np.testing.assert_allclose(
        base.numpy(), np.asarray(jl.llama_apply(jp, jnp.asarray(_ids()),
                                                cfg)), rtol=1e-5, atol=1e-5)
    for kw in ({"remat": True}, {"use_flash": True},
               {"remat": True, "use_flash": True}):
        np.testing.assert_allclose(pl.llama_apply(p, t, pcfg, **kw).numpy(),
                                   base.numpy(), rtol=1e-5, atol=1e-5)


def test_layers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        players.rms_norm_apply({"scale": torch.tensor(scale)},
                               torch.tensor(x), eps=1e-5).numpy(),
        np.asarray(jlayers.rms_norm_apply({"scale": scale}, x, eps=1e-5)),
        rtol=1e-6, atol=1e-6)
    sw = _np_tree(jlayers.swiglu_init(jax.random.key(0), 16, 24))
    np.testing.assert_allclose(
        players.swiglu_apply(jax.tree.map(torch.tensor, sw),
                             torch.tensor(x)).numpy(),
        np.asarray(jlayers.swiglu_apply(sw, x)), rtol=1e-5, atol=1e-6)
    pos = np.arange(7)
    jc, js = jattn.rope_cos_sin(jnp.asarray(pos), 8, theta=500.0)
    pc, ps = pattn.rope_cos_sin(torch.tensor(pos), 8, theta=500.0)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    q = rng.normal(size=(2, 3, 7, 8)).astype(np.float32)
    np.testing.assert_allclose(
        pattn.apply_rope(torch.tensor(q), pc, ps).numpy(),
        np.asarray(jattn.apply_rope(q, jc, js)), rtol=1e-6, atol=1e-6)
    qb = torch.tensor(q).to(torch.bfloat16)
    assert pattn.apply_rope(qb, pc, ps).dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pattn.repeat_kv(torch.tensor(q), 3).numpy(),
        np.asarray(jattn.repeat_kv(q, 3)))


def test_gqa_equals_mha_with_repeated_kv_weights():
    """GQA == MHA whose k/v columns are the GQA columns repeated a group
    (pins repeat_kv's head ORDER, HF's)."""
    cfg = pl.LlamaConfig.tiny()
    p = pl.llama_init(torch.Generator().manual_seed(0), cfg)
    rep, hd = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim

    def widen(w):
        L, D, _ = w.shape
        return w.reshape(L, D, cfg.n_kv_heads, 1, hd).expand(
            L, D, cfg.n_kv_heads, rep, hd).reshape(L, D, cfg.n_heads * hd)

    attn = dict(p["blocks"]["attn"])
    attn["k"], attn["v"] = ({"w": widen(attn[n]["w"])} for n in "kv")
    mha = {**p, "blocks": {**p["blocks"], "attn": attn}}
    t = torch.tensor(_ids())
    np.testing.assert_allclose(
        pl.llama_apply(p, t, cfg).numpy(),
        pl.llama_apply(mha, t, dataclasses.replace(
            cfg, n_kv_heads=cfg.n_heads)).numpy(), rtol=1e-5, atol=1e-5)


def test_rope_scaling_matches_hf():
    """llama3 rope scaling: the inverse frequencies against JAX's
    ``llama3_scaled_inv_freq`` (which the JAX test holds to HF) for the
    JAX test's scaling and Llama-3.2-1B's, and the logits with scaling
    past ``original_max / 2`` against JAX's."""
    for kw in ({"rope_scaling": (8.0, 1.0, 4.0, 32)}, None):
        pcfg = (pl.LlamaConfig.tiny(**kw) if kw
                else pl.LlamaConfig.llama32_1b())
        jcfg = (jl.LlamaConfig.tiny(**kw) if kw
                else jl.LlamaConfig.llama32_1b())
        np.testing.assert_allclose(
            pl.llama3_scaled_inv_freq(pcfg).numpy(),
            np.asarray(jl.llama3_scaled_inv_freq(jcfg)), rtol=1e-6)
    kw = {"rope_scaling": (8.0, 1.0, 4.0, 32)}
    cfg, jp = _jax(kw, seed=1)
    ids = _ids(s=48)
    np.testing.assert_allclose(
        pl.llama_apply(_port(jp), torch.tensor(ids),
                       pl.LlamaConfig.tiny(**kw)).numpy(),
        np.asarray(jl.llama_apply(jp, jnp.asarray(ids), cfg)),
        rtol=1e-5, atol=1e-5)
    c, _ = pl.llama_rope_tables(torch.arange(48), pl.LlamaConfig.tiny(**kw))
    jc, _ = jl.llama_rope_tables(jnp.arange(48), cfg)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)


def test_tied_embeddings_variant():
    tied = pl.LlamaConfig.tiny(tie_embeddings=True)
    params = pl.llama_init(torch.Generator().manual_seed(0), tied)
    assert "lm" not in params["head"]
    out = pl.llama_apply(params, torch.tensor(_ids()), tied)
    assert out.shape == (2, 16, tied.vocab_size)
    shapes = {k: tuple(v.shape) for k, v in _flat(params)}
    _, jp = _jax(TIED)
    assert shapes == {k: tuple(v.shape) for k, v in _flat(_np_tree(jp))}


@pytest.mark.parametrize("use_flash", [False, True])
def test_packed_segments_match_jax(use_flash):
    """``segment_eos_id``: attention never crosses a packed document's
    end, on the flash path (the kernels' plain versions) and the plain
    one, as JAX's."""
    kw = {"segment_eos_id": 7}
    cfg, jp = _jax(kw)
    ids = _ids(b=2, s=32, seed=4)
    ids[0, [5, 17]] = 7
    ids[1, 20] = 7
    want = jl.llama_model_spec(cfg).loss_fn(jp, (jnp.asarray(ids),
                                                 jnp.asarray(ids)))
    t = torch.tensor(ids)
    got = pl.llama_model_spec(pl.LlamaConfig.tiny(**kw),
                              use_flash=use_flash).loss_fn(_port(jp), (t, t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    dense = pl.llama_model_spec(pl.LlamaConfig.tiny()).loss_fn(_port(jp),
                                                               (t, t))
    assert abs(float(dense) - float(got)) > 1e-6


def test_llama_moe_one_expert_matches_dense_swiglu():
    from quintnet_tpu_torch.nn.moe import MoEArgs, moe_apply, moe_init

    p = moe_init(torch.Generator().manual_seed(0), 16, 32, 1,
                 expert_type="swiglu")
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(1))
    y, aux = moe_apply(p, x, MoEArgs(n_experts=1, top_k=1, capacity=16,
                                     aux_weight=0.0))
    dense = {"gate": {"w": p["wg"][0]}, "up": {"w": p["wu"][0]},
             "down": {"w": p["wd"][0]}}
    np.testing.assert_allclose(y.numpy(),
                               players.swiglu_apply(dense, x).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_llama_upcycle_to_moe_near_identity():
    cfg, jp = _jax(KW)
    moe_cfg = pl.LlamaConfig.tiny(**MOE)
    up = pl.llama_upcycle_to_moe(_port(jp), moe_cfg)
    assert set(up["blocks"]["moe"]) == {"router", "wg", "wu", "wd"}
    jup = _np_tree(jl.llama_upcycle_to_moe(jp, jl.LlamaConfig.tiny(**MOE),
                                           key=jax.random.key(3)))
    for k in ("wg", "wu", "wd"):
        np.testing.assert_array_equal(up["blocks"]["moe"][k].numpy(),
                                      jup["blocks"]["moe"][k])
    t = torch.tensor(_ids())
    np.testing.assert_allclose(
        pl.llama_apply(up, t, moe_cfg).numpy(),
        pl.llama_apply(_port(jp), t, pl.LlamaConfig.tiny()).numpy(),
        rtol=2e-3, atol=2e-3)


def test_bridge_round_trip_and_layout_checks():
    for kw in (KW, TIED, MOE):
        _, jp = _jax(kw)
        back = llama_params_to_numpy(_port(jp))
        for k, v in _flat(_np_tree(jp)):
            got = back
            for part in k.split("."):
                got = got[part]
            np.testing.assert_array_equal(got, v)
    _, jp = _jax(MOE)
    bad = _np_tree(jp)
    bad["blocks"]["moe"]["wg"] = bad["blocks"]["moe"]["wg"][:, :3]
    with pytest.raises(ValueError, match="experts"):
        llama_params_from_numpy(bad, "cpu")
    bad = _np_tree(_jax(KW)[1])
    del bad["blocks"]["mlp"]["up"]
    with pytest.raises(ValueError, match="not a dense Llama"):
        llama_params_from_numpy(bad, "cpu")


def test_bf16_loss_near_f32():
    cfg, jp = _jax(MOE)
    t = torch.tensor(_ids())
    p = _port(jp)
    f32 = pl.llama_model_spec(pl.LlamaConfig.tiny(**MOE)).loss_fn(p, (t, t))
    bf = pl.llama_model_spec(pl.LlamaConfig.tiny(**MOE),
                             compute_dtype=torch.bfloat16).loss_fn(p, (t, t))
    assert bf.dtype == torch.float32
    assert abs(float(bf) - float(f32)) <= 2e-2 * abs(float(f32))


REFUSED = {
    # the dense and paged serving blocks are ported (the generation
    # decoders; Llama serving, tests/test_torch_serve_llama.py), and so
    # is the HF interop (test_hf_interop_matches_jax below)
    "remat_dots": lambda: pl.llama_model_spec(pl.LlamaConfig.tiny(),
                                              remat="dots"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_name_their_roadmap_item(name):
    want = {"remat_dots": "§2"}[name]
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as e:
        REFUSED[name]()
    assert want in str(e.value)


def _hf_config(**rope):
    """A stand-in for a transformers LlamaConfig: the attributes the
    readers take (Llama-3.2-1B's, with llama3 rope scaling)."""
    import types

    return types.SimpleNamespace(
        vocab_size=128256, max_position_embeddings=131072, hidden_size=2048,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        intermediate_size=8192, rope_theta=500000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=True,
        rope_scaling=rope or {"rope_type": "llama3", "factor": 32.0,
                              "low_freq_factor": 1.0,
                              "high_freq_factor": 4.0,
                              "original_max_position_embeddings": 8192})


def _hf_interop(name, kw):
    """(the port's result, JAX's) of one HF entry on the same input: the
    tiny model's JAX params as an HF state dict (JAX's own writer)."""
    cfg, jp = _jax(kw)
    pcfg = pl.LlamaConfig.tiny(**kw)
    state = {k: np.array(v) for k, v in jl.llama_to_hf_state(
        _np_tree(jp), cfg).items()}
    if name == "from_hf_state":
        got = pl.llama_from_hf_state(
            {k: torch.from_numpy(v) for k, v in state.items()}, pcfg,
            device="cpu")
        return dict(_flat(got)), dict(_flat(
            _np_tree(jl.llama_from_hf_state(state, cfg))))
    if name == "to_hf_state":
        got = pl.llama_to_hf_state(_port(jp), pcfg)
        return got, state
    hf = _hf_config()
    return (dataclasses.asdict(pl.LlamaConfig.from_hf_config(hf)),
            dataclasses.asdict(jl.LlamaConfig.from_hf_config(hf)))


@pytest.mark.parametrize("name", ["from_hf_config", "from_hf_state",
                                  "to_hf_state"])
def test_hf_interop_matches_jax(name):
    """The three HF entries of the ROADMAP.md item 9 are served: each
    gives JAX's result on the same input, exactly (a state dict leaf for
    leaf, tied and untied heads; a config field for field, llama3 rope
    scaling included, and another rope type is refused as JAX refuses
    it)."""
    if name == "from_hf_config":
        got, want = _hf_interop(name, KW)
        common = set(got) & set(want)
        assert {k: got[k] for k in common} == {k: want[k] for k in common}
        assert got["rope_scaling"] == (32.0, 1.0, 4.0, 8192)
        with pytest.raises(NotImplementedError, match="llama3 only"):
            pl.LlamaConfig.from_hf_config(_hf_config(rope_type="yarn"))
        return
    for kw in (KW, TIED):
        got, want = _hf_interop(name, kw)
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert v.dtype == torch.float32, k
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                          err_msg=k)


# ---------------------------------------------------------------------
# the strategies: worlds of 2, 4 and 8 ranks
# ---------------------------------------------------------------------

ACC2 = {"gradient_accumulation_steps": 2, "schedule": "1f1b"}
# tag -> (model kwargs, mesh, training keys, JAX reference micro-batches)
RUNS = {
    "tp": (KW, {"tp": 2}, {}, None),
    "pp": (KW, {"pp": 2}, ACC2, None),
    "tied_pp": (TIED, {"pp": 2}, ACC2, None),
    "moe_ep": (MOE, {"ep": 2}, {}, None),
    "moe_pp": (MOE, {"pp": 2}, ACC2, 2),
    "dp": (KW, {"dp": 4}, {}, None),
    "dp_tp": (KW, {"dp": 2, "tp": 2}, {}, None),
    "moe_dp_ep": (MOE, {"dp": 2, "ep": 2}, {}, None),
    "3d": (KW, {"dp": 2, "tp": 2, "pp": 2}, ACC2, None),
}
STRATEGY = {"tp": "tp", "pp": "pp", "tied_pp": "pp", "moe_ep": "ep",
            "moe_pp": "pp", "dp": "dp", "dp_tp": "dp_tp",
            "moe_dp_ep": "dp_ep", "3d": "3d"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ids = _ids(b=4, s=16)
    jobs = {}
    for tag, (kw, sizes, training, _) in RUNS.items():
        n = int(np.prod(list(sizes.values())))
        jobs.setdefault(n, {})[tag] = (
            "steps", ("llama", kw, _np_tree(_jax(kw)[1]), ids, ids, sizes),
            {"training": dict(SGD, **training), "use_flash": True})
    out = {}
    for n, js in sorted(jobs.items()):
        ranks = run_world(jobs_world_case, n, tmp_path_factory.mktemp(
            f"l{n}"), js, timeout=300)
        out.update({tag: [r[tag] for r in ranks] for tag in js})
    return ids, out


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_strategy_loss_matches_single_device(worlds, tag):
    """One SGD step through ``get_strategy`` on the mesh == JAX's
    single-device step: the loss (the MoE ep runs at the JAX test's
    2e-4: the capacity is a rank's own) and every parameter (tied: the
    table's update carries both stages' gradients)."""
    ids, out = worlds
    kw, _, _, n_micro = RUNS[tag]
    loss, params = _jax_sgd(kw, _jax(kw)[1], ids, n_micro=n_micro)
    for r in out[tag]:
        assert r["strategy"] == STRATEGY[tag]
        np.testing.assert_allclose(r["losses"], [loss],
                                   rtol=2e-4 if "ep" in tag else 1e-5)
        assert set(r["params"]) == set(params)
        for k, w in params.items():
            np.testing.assert_allclose(r["params"][k], w, rtol=2e-4,
                                       atol=1e-5, err_msg=f"{tag}:{k}")


@pytest.mark.parametrize("kw", [KW, MOE], ids=["dense", "moe"])
def test_trainer_fits_llama(kw):
    """``Trainer.fit`` trains the tiny Llama (dense and MoE) on one
    device: 5 AdamW steps on one batch lower its loss, and evaluation
    reports the same loss ``loss_fn`` gives."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = pl.LlamaConfig.tiny(**kw)
    model = pl.llama_model_spec(cfg)
    tr = Trainer(Config.from_dict({"training": {
        "optimizer": "adamw", "learning_rate": 1e-2, "log_every": 0}}),
        model, task_type="clm", device="cpu", log_fn=lambda m: None)
    t = torch.tensor(_ids(b=4))
    hist = tr.fit(lambda ep: [(t, t)], epochs=5,
                  val_batches_fn=lambda ep: [(t, t)])
    assert hist.train_loss[-1] < hist.train_loss[0]
    params, _ = tr.final_state
    with torch.no_grad():
        want = float(model.loss_fn(params, (t, t)))
    np.testing.assert_allclose(hist.val_loss[-1], want, rtol=1e-5)
