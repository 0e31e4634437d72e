"""The port's single-device GPT-2 training (quintnet_tpu_torch/models/
gpt2.py, parallel/, train/) against the JAX package, on the CPU.

Tiny GPT-2 weights come from the JAX ``gpt2_init`` through the bridge;
batches are numpy arrays from a seed. Loss ``atol=1e-5``; gradients
``atol=1e-5, rtol=1e-4`` (f32 through 4 blocks, summed in another
order); learning rates ``atol=1e-7``; a 20-step AdamW trajectory within
1e-4 relative at every step.

bf16 compute (``compute_dtype=bfloat16``) against the JAX bf16 step on
the same weights and batch, compiled with
``xla_allow_excess_precision=False`` so that XLA rounds every bf16 op
as torch does (by default its CPU backend keeps fused elementwise chains
in f32, which is not what the program's casts say): every gradient leaf
is f32, the loss is within 2e-2 relative of the f32 loss (the JAX gate,
``tests/test_gpt2.py:173-186``), and the loss and each gradient leaf
are no farther from JAX's bf16 result than twice JAX's own bf16-to-f32
distance (max |diff| over the leaf). Why twice: the packages still
round in a few other places (torch's GELU rounds once where JAX rounds
each op of the tanh formula; the port's flash path rounds p as the
Pallas kernels do, where JAX on the CPU runs its blockwise attention in
f32), so the two bf16 results are two roundings of one f32 computation,
about sqrt(2) apart relative to one rounding's distance; measured worst
1.85 (``blocks.attn.qkv.b``, segments), loss 1.30. The bf16 first
moment follows optax bit for bit, as the jitted JAX trainer (default
compiler options) computes it.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.core.config import load_config as jax_load_config
from quintnet_tpu.core.pytree import clip_by_global_norm as jax_clip
from quintnet_tpu.core.pytree import decay_mask as jax_decay_mask
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2 import gpt2_model_spec as jax_model_spec
from quintnet_tpu.parallel.dp import accumulate_grads as jax_accumulate
from quintnet_tpu.train.trainer import make_lr_schedule as jax_lr_schedule
from quintnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.core.config import Config, MeshConfig, load_config
from quintnet_tpu_torch.core.pytree import decay_mask, tree_leaves, tree_map
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
from quintnet_tpu_torch.nn.transformer import stacked_blocks_apply
from quintnet_tpu_torch.parallel.strategy import get_strategy
from quintnet_tpu_torch.parallel.train_step import accumulate_grads
from quintnet_tpu_torch.train.metrics import accuracy, perplexity
from quintnet_tpu_torch.models.vit import (ViTConfig, vit_init,
                                           vit_model_spec)
from quintnet_tpu_torch.tools.verify_vit import verify_vit
from quintnet_tpu_torch.train.trainer import (Optimizer, Trainer,
                                              make_lr_schedule,
                                              make_optimizer)

torch.set_num_threads(1)

EOS = 7


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, jax_gpt2_init(jax.random.key(0),
                                                  JaxGPT2Config.tiny()))


def _port_params(np_tree):
    return tree_map(lambda t: t.requires_grad_(True),
                    gpt2_params_from_numpy(np_tree, "cpu"))


def _batch(seed, B=2, S=32, eos=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (B, S)).astype(np.int32)
    if eos:
        ids[:, [5, 17, 18]] = EOS
    labels = ids.copy()
    labels[0, :6] = -100                 # a masked prompt
    labels[1, -3:] = -100                # masked padding
    return ids, labels


def _torch_batch(ids, labels):
    return torch.from_numpy(ids).long(), torch.from_numpy(labels).long()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


LOSS_CASES = {
    "flash": dict(use_flash=True),
    "plain": dict(use_flash=False),
    "segments": dict(use_flash=True, cfg=dict(segment_eos_id=EOS)),
    "loss_chunk_16": dict(use_flash=True, cfg=dict(loss_chunk=16)),
    "remat": dict(use_flash=True, remat=True),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_and_every_gradient_match_jax(jax_params, name):
    c = LOSS_CASES[name]
    kw = c.get("cfg", {})
    ids, labels = _batch(0, eos="segment_eos_id" in kw)
    jspec = jax_model_spec(JaxGPT2Config.tiny(**kw), use_flash=c["use_flash"],
                           remat=c.get("remat", False))
    jbatch = (jnp.asarray(ids), jnp.asarray(labels))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jspec.loss_fn(p, jbatch)))(jax_params)

    spec = gpt2_model_spec(GPT2Config.tiny(**kw), use_flash=c["use_flash"],
                           remat=c.get("remat", False))
    params = _port_params(jax_params)
    loss, grads = accumulate_grads(spec.loss_fn, params,
                                   _torch_batch(ids, labels), 1)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    assert set(grads) == set(want)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], atol=1e-5,
                                   rtol=1e-4, err_msg=".".join(path))


def test_decay_mask_matches_jax(jax_params):
    want = dict(_flat(jax.tree.map(np.asarray, jax_decay_mask(jax_params))))
    got = dict(tree_leaves(decay_mask(_port_params(jax_params))))
    assert set(got) == set(want)
    for path, m in got.items():
        assert np.all(want[path] == m), path


SCHEDULES = {
    "constant": dict(learning_rate=3e-4),
    "constant_warmup": dict(learning_rate=1.0, warmup_steps=10),
    "cosine_warmup": dict(learning_rate=1.0, lr_schedule="cosine",
                          warmup_steps=10, decay_steps=110,
                          min_lr_ratio=0.1),
    "cosine": dict(learning_rate=2e-3, lr_schedule="cosine",
                   decay_steps=50),
    "linear_warmup": dict(learning_rate=1.0, lr_schedule="linear",
                          warmup_steps=5, decay_steps=25, min_lr_ratio=0.2),
    "linear": dict(learning_rate=1e-3, lr_schedule="linear", decay_steps=30),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_equals_optax(name):
    t = SCHEDULES[name]
    want = jax_lr_schedule(JaxConfig.from_dict({"training": t}))
    got = make_lr_schedule(Config.from_dict({"training": t}))
    if not callable(want):
        assert got == want
        return
    for count in range(0, 130):
        np.testing.assert_allclose(got(count), float(want(count)), atol=1e-7,
                                   err_msg=f"count {count}")


def test_adamw_trajectory_tracks_jax_for_20_steps(jax_params):
    """Masked AdamW, global-norm clipping, warmup + cosine, 2 micro-batches
    per step: the port's Trainer step against JAX's own single-device
    step (make_optimizer + accumulate_grads + clip_by_global_norm)."""
    t = dict(optimizer="adamw", learning_rate=3e-3, weight_decay=0.01,
             lr_schedule="cosine", warmup_steps=5, decay_steps=20,
             min_lr_ratio=0.1, grad_clip_norm=1.0, batch_size=4,
             gradient_accumulation_steps=2)
    jcfg = JaxConfig.from_dict({"training": t})
    jspec = jax_model_spec(JaxGPT2Config.tiny(), use_flash=True)
    opt = jax_make_optimizer(jcfg)

    @jax.jit
    def jax_step(p, st, batch):
        loss, g = jax_accumulate(jspec.loss_fn, p, batch, 2)
        g, _ = jax_clip(g, 1.0)
        upd, st = opt.update(g, st, p)
        return optax.apply_updates(p, upd), st, loss

    batches = [_batch(10 + i, B=4) for i in range(4)]   # cycled: it learns
    jp = jax.tree.map(jnp.asarray, jax_params)
    st = opt.init(jp)
    trainer = Trainer(Config.from_dict({"training": t}),
                      gpt2_model_spec(GPT2Config.tiny(), use_flash=True),
                      task_type="clm", device="cpu")
    params = _port_params(jax_params)
    opt_state = trainer.optimizer.init(params)
    jl, tl = [], []
    for i in range(20):
        ids, labels = batches[i % 4]
        jp, st, loss = jax_step(jp, st, (jnp.asarray(ids),
                                         jnp.asarray(labels)))
        jl.append(float(loss))
        params, opt_state, loss = trainer.step_fn(
            params, opt_state, trainer.device_batch(ids, labels))
        tl.append(float(loss))
    assert jl[-1] < jl[0] - 0.1          # the trajectory moves
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_trainer_fit_and_evaluate_on_cpu(jax_params):
    cfg = Config.from_dict({"training": dict(
        optimizer="adamw", learning_rate=1e-3, batch_size=4,
        gradient_accumulation_steps=2, log_every=1)})
    data = [_batch(20 + i, B=4) for i in range(2)]
    logs, hists = [], []
    for use_flash in (True, False):
        tr = Trainer(cfg, gpt2_model_spec(GPT2Config.tiny(),
                                          use_flash=use_flash),
                     task_type="clm", device="cpu", log_fn=logs.append)
        params = _port_params(jax_params)
        hists.append(tr.fit(lambda ep: data, epochs=2,
                            val_batches_fn=lambda ep: data[:1],
                            params=params,
                            opt_state=tr.optimizer.init(params)))
    h = hists[0]
    assert len(h.train_loss) == 2 and h.train_loss[1] < h.train_loss[0]
    np.testing.assert_allclose(h.train_loss, hists[1].train_loss, rtol=1e-5)
    assert h.best_epoch == 1 and len(h.val_metric) == 2
    ev = tr.evaluate(tr.final_state[0], data[:1])
    np.testing.assert_allclose(ev["perplexity"], np.exp(ev["loss"]),
                               rtol=1e-6)
    assert any("step 2: loss" in m for m in logs)


@pytest.mark.parametrize("use_flash", [True, False])
def test_remat_replays_the_dropout_masks(jax_params, use_flash):
    """Under remat each layer's recomputation draws the forward's masks
    again (same loss and gradients as without remat), and the generator
    ends where the forward left it."""
    # attention dropout only on the plain path: with use_flash it would
    # route to blockwise; keep the kernels' path under residual dropout
    cfg = GPT2Config.tiny(embd_pdrop=0.1, resid_pdrop=0.2,
                          attn_pdrop=0.0 if use_flash else 0.1)
    batch = _torch_batch(*_batch(3))
    out = []
    for remat in (False, True):
        spec = gpt2_model_spec(cfg, use_flash=use_flash, remat=remat)
        gen = torch.Generator().manual_seed(11)
        loss, grads = accumulate_grads(spec.loss_fn,
                                       _port_params(jax_params), batch, 1,
                                       generator=gen)
        out.append((loss, grads, torch.rand(4, generator=gen)))
    (l0, g0, r0), (l1, g1, r1) = out
    assert torch.equal(l0, l1) and torch.equal(r0, r1)
    for path in g0:
        torch.testing.assert_close(g1[path], g0[path], atol=1e-6, rtol=1e-5)


def test_from_dict_keeps_the_training_fields():
    d = dict(vocab_size=300, n_layer=2, dropout=0.05, embd_pdrop=0.1,
             attn_pdrop=0.0, resid_pdrop=0.2, loss_chunk=16,
             segment_eos_id=5, name="gpt2", expert_top_k=2)
    port, ref = GPT2Config.from_dict(d), JaxGPT2Config.from_dict(d)
    for f in ("dropout", "embd_pdrop", "attn_pdrop", "resid_pdrop",
              "loss_chunk", "segment_eos_id", "vocab_size", "n_layer"):
        assert getattr(port, f) == getattr(ref, f) == d[f], f
    assert port.pdrops == ref.pdrops and port.needs_dropout


def test_config_copy_loads_like_the_reference_yaml():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    ref = jax_load_config(str(root / "quintnet_tpu/examples/gpt2_config.yaml"))
    port = load_config(str(root / "quintnet_tpu_torch/examples/"
                                  "gpt2_config.json"))
    assert port.to_dict() == ref.to_dict()
    same = load_config(str(root / "quintnet_tpu/examples/gpt2_config.yaml"))
    assert same.to_dict() == ref.to_dict()
    assert port.training.remat_mode is False


def test_finetune_example_runs_on_one_cpu(tmp_path, capfd):
    """A config asking for pp = 2, ZeRO-1 and 1F1B: the example trains it
    as asked, 2 pipeline stages on CPU ranks (ZeRO over a dp of 1 shards
    nothing), and says so."""
    from quintnet_tpu_torch.examples import gpt2_finetune

    cfg = {"model": {"n_layer": 2}, "mesh_dim": [1, 2],
           "mesh_name": ["dp", "pp"],
           "training": {"batch_size": 4, "gradient_accumulation_steps": 2,
                        "optimizer": "zero1_adamw", "learning_rate": 1e-3,
                        "schedule": "1f1b", "log_every": 0},
           "data": {"max_seq_length": 32, "train_samples": 8,
                    "val_samples": 4}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert gpt2_finetune.main(["--config", str(path), "--tiny", "--steps",
                               "1", "--epochs", "1", "--device", "cpu"]) \
        is None
    out = capfd.readouterr().out
    assert "strategy=pp mesh={'dp': 1, 'pp': 2}" in out
    assert "schedule=1f1b optimizer=zero1_adamw" in out
    assert out.count("done in") == 1 and "forced" not in out


def test_finetune_example_takes_dp_and_tp_from_the_config(capfd):
    """The reference config's 2 x 2 x 2 dp x tp x pp mesh, 1F1B and
    zero1_adamw are trained as they stand (8 CPU ranks, one step of the
    tiny model): the example no longer rewrites the mesh or the
    optimizer."""
    from quintnet_tpu_torch.examples import gpt2_finetune

    root = Path(__file__).resolve().parents[1]
    path = root / "quintnet_tpu_torch/examples/gpt2_config.json"
    cfg = load_config(str(path))
    assert cfg.mesh.axis_sizes == {"dp": 2, "tp": 2, "pp": 2}
    assert cfg.training.optimizer == "zero1_adamw"
    assert cfg.micro_batch_size_resolved() == 32
    assert not hasattr(gpt2_finetune, "port_mesh")
    assert gpt2_finetune.main(["--tiny", "--steps", "1", "--epochs", "1",
                               "--device", "cpu"]) is None
    out = capfd.readouterr().out
    assert out.count("strategy=3d mesh={'dp': 2, 'tp': 2, 'pp': 2}") == 1
    assert "schedule=1f1b optimizer=zero1_adamw" in out
    assert out.count("done in") == 1


def test_metrics():
    logits = torch.tensor([[0.1, 2.0], [3.0, 0.0], [0.0, 1.0]])
    assert float(accuracy(logits, torch.tensor([1, 0, 0]))) == \
        pytest.approx(2 / 3)
    assert float(perplexity(torch.tensor(2.0))) == pytest.approx(np.exp(2.0))
    assert float(perplexity(torch.tensor(50.0))) == pytest.approx(np.exp(20))


def _not_ported_cases():
    """name -> what raises: a callable (``NotImplementedError`` naming
    its ROADMAP.md item), or ``(callable, exception, match)`` for a case
    whose option is now ported and that raises the ported behaviour's
    own error (fsdp with a ZeRO optimizer: JAX's ``ValueError``;
    ``verify_vit(tp=2)``: the port reads the tp from the step it reloads,
    so it takes none; an sp mesh without a joined world: the
    ``RuntimeError`` of every mesh strategy there)."""
    tiny = GPT2Config.tiny()
    spec = gpt2_model_spec(tiny)
    cfg = Config.from_dict({})
    mesh_cfg = Config.from_dict({"mesh_dim": [2], "mesh_name": ["sp"]})
    zero_cfg = Config.from_dict({"mesh_dim": [2], "mesh_name": ["dp"],
                                 "training": {"optimizer": "zero1_adamw",
                                              "fsdp": True}})
    stacked = {"w": torch.zeros(2, 3)}

    def trainer(**kw):
        return Trainer(cfg, spec, device="cpu", **kw)

    vit_moe = ViTConfig(n_experts=4, router_type="nope")

    return {
        # MoE ViT and GPT-2 are ported: a router nobody defines and
        # expert choice on a causal model raise JAX's ValueErrors
        "vit_moe": (lambda: vit_model_spec(vit_moe).loss_fn(
            vit_init(torch.Generator().manual_seed(0), vit_moe),
            (torch.zeros(1, 28, 28, 1), torch.zeros(1, dtype=torch.long))),
            ValueError, "unknown router"),
        "verify_vit_tp2": (lambda: verify_vit("no-such-dir", ViTConfig(),
                                              tp=2),
                           TypeError, "unexpected keyword argument 'tp'"),
        "fault_tolerance": lambda: trainer().fit(lambda e: [], ft=object()),
        "strategy_dp": (lambda: get_strategy("dp", zero_cfg), ValueError,
                        "ZeRO-3 subsumes 1/2"),
        # sp is ported: a 2-rank sp mesh builds, given a joined world
        "mesh_of_two": (lambda: get_strategy(None, mesh_cfg), RuntimeError,
                        "torch.distributed"),
        "remat_dots_spec": lambda: gpt2_model_spec(tiny, remat="dots"),
        "remat_dots_blocks": lambda: stacked_blocks_apply(
            stacked, torch.zeros(1, 2, 3), num_heads=1, remat="dots"),
        "moe": (lambda: gpt2_model_spec(GPT2Config.tiny(
            n_experts=4, router_type="expert_choice")), ValueError,
            "non-causal"),
    }


@pytest.mark.parametrize("name", sorted(_not_ported_cases()))
def test_options_not_ported_raise(name):
    case = _not_ported_cases()[name]
    fn, exc, match = (case if isinstance(case, tuple)
                      else (case, NotImplementedError, "ROADMAP"))
    with pytest.raises(exc, match=match) as ei:
        fn()
    if name == "fault_tolerance":
        assert "item 8" in str(ei.value)


def test_single_strategy_and_unknown_names():
    assert get_strategy("single").name == "single"
    assert get_strategy(None, Config.from_dict({})).name == "single"
    with pytest.raises(ValueError, match="unknown strategy"):
        get_strategy("nope")
    assert MeshConfig().world_size == 1


# ---------------------------------------------------------------------
# bf16 compute and the bf16 first moment
# ---------------------------------------------------------------------

BF16_CASES = {
    "flash": dict(use_flash=True),
    "plain": dict(use_flash=False),
    "segments": dict(use_flash=True, cfg=dict(segment_eos_id=EOS)),
    "loss_chunk_16": dict(use_flash=True, cfg=dict(loss_chunk=16)),
    "remat": dict(use_flash=True, remat=True),
}


def _max_diff(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _strict_value_and_grad(fn, params):
    """jit(value_and_grad(fn)) compiled without XLA's excess precision:
    each bf16 op rounds to bf16."""
    return jax.jit(jax.value_and_grad(fn)).lower(params).compile(
        compiler_options={"xla_allow_excess_precision": False})(params)


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_loss_and_every_gradient_match_jax_bf16(jax_params, name):
    c = BF16_CASES[name]
    kw = c.get("cfg", {})
    ids, labels = _batch(0, eos="segment_eos_id" in kw)
    jbatch = (jnp.asarray(ids), jnp.asarray(labels))
    want = {}
    for dt in (None, jnp.bfloat16):
        jspec = jax_model_spec(JaxGPT2Config.tiny(**kw),
                               use_flash=c["use_flash"],
                               remat=c.get("remat", False), compute_dtype=dt)
        jloss, jgrads = _strict_value_and_grad(
            lambda p: jspec.loss_fn(p, jbatch), jax_params)
        want[dt] = (float(jloss), dict(_flat(jax.tree.map(
            lambda x: np.asarray(x, np.float32), jgrads))))

    spec = gpt2_model_spec(GPT2Config.tiny(**kw), use_flash=c["use_flash"],
                           remat=c.get("remat", False),
                           compute_dtype=torch.bfloat16)
    loss, grads = accumulate_grads(spec.loss_fn, _port_params(jax_params),
                                   _torch_batch(ids, labels), 1)
    (l32, g32), (l16, g16) = want[None], want[jnp.bfloat16]
    assert loss.dtype == torch.float32
    assert abs(float(loss) - l32) <= 2e-2 * abs(l32)
    assert abs(float(loss) - l16) <= 2 * abs(l16 - l32)
    assert set(grads) == set(g16)
    for path, g in grads.items():
        assert g.dtype == torch.float32, path
        own = _max_diff(g16[path], g32[path])     # JAX's bf16 distance
        assert _max_diff(g, g16[path]) <= 2 * own, ".".join(path)


def _moment_steps(n=20, seed=5):
    """Masked AdamW with ``adam_mu_dtype: bfloat16`` (warmup + cosine) on
    tiny GPT-2's parameter shapes, JAX's ``make_optimizer`` under jit (as
    the JAX trainer runs it) and the port's, on the same f32 gradients
    from a seed."""
    t = dict(optimizer="adamw", learning_rate=3e-3, weight_decay=0.01,
             lr_schedule="cosine", warmup_steps=5, decay_steps=20,
             min_lr_ratio=0.1, adam_mu_dtype="bfloat16")
    jp0 = jax.tree.map(np.asarray, jax_gpt2_init(jax.random.key(1),
                                                 JaxGPT2Config.tiny()))
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                     * 10.0 ** rng.uniform(-4, 0))
                          .astype(np.float32), jp0) for _ in range(n)]
    opt = jax_make_optimizer(JaxConfig.from_dict({"training": t}))

    @jax.jit
    def jax_step(p, st, g):
        upd, st = opt.update(g, st, p)
        return optax.apply_updates(p, upd), st

    port_opt = make_optimizer(Config.from_dict({"training": t}))
    jp = jax.tree.map(jnp.asarray, jp0)
    st = opt.init(jp)
    params = gpt2_params_from_numpy(jp0, "cpu")
    state = port_opt.init(params)
    for g in grads:
        jp, st = jax_step(jp, st, jax.tree.map(jnp.asarray, g))
        port_opt.update(dict(_flat(tree_map(torch.from_numpy, g))), state,
                        params)
        yield jp, st, params, state


def test_bf16_first_moment_follows_optax_for_20_steps():
    """optax's order: ``mu`` updated in f32 from its stored bf16 value,
    the step's update from that unrounded ``mu``, the stored copy rounded
    afterwards. ``mu`` equals optax's bit for bit at every step; the
    parameters stay within 1e-6 of the largest magnitude of each leaf
    (``nu`` is f32 in both and summed in another order)."""
    for i, (jp, st, params, state) in enumerate(_moment_steps()):
        jmu = dict(_flat(st[0].mu))
        for path, m in tree_leaves(state["mu"]):
            assert np.array_equal(m.view(torch.int16).numpy(),
                                  np.asarray(jmu[path]).view(np.int16)), \
                (i, path)
        want = dict(_flat(jax.tree.map(np.asarray, jp)))
        for path, p in tree_leaves(params):
            assert _max_diff(p, want[path]) <= 1e-6 * np.abs(
                want[path]).max(), (i, path)
    assert state["count"] == 20


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_bf16_first_moment_dtypes_match_jax(jax_params, optimizer):
    """``adam_mu_dtype: bfloat16``: ``mu`` bf16 and ``nu`` f32 in both
    packages (JAX ``tests/test_sampling.py:90-108``); the default keeps
    both f32."""
    for mu_dtype, want in (("bfloat16", (jnp.bfloat16, torch.bfloat16)),
                           ("float32", (jnp.float32, torch.float32))):
        t = {"optimizer": optimizer, "adam_mu_dtype": mu_dtype}
        jst = jax_make_optimizer(JaxConfig.from_dict({"training": t})).init(
            jax.tree.map(jnp.asarray, jax_params))[0]
        state = make_optimizer(Config.from_dict({"training": t})).init(
            _port_params(jax_params))
        for (_, jm), (_, jn), (_, m), (_, n) in zip(
                _flat(jst.mu), _flat(jst.nu), tree_leaves(state["mu"]),
                tree_leaves(state["nu"])):
            assert (jm.dtype, m.dtype) == want
            assert (jn.dtype, n.dtype) == (jnp.float32, torch.float32)


def test_trainer_fits_in_bf16_and_ignores_training_dtype(jax_params):
    """The Trainer does not read ``training.dtype`` (the JAX Trainer does
    not): with it set and a bf16 model and first moment, ``fit`` trains
    tiny GPT-2, every parameter and ``nu`` stay f32, ``mu`` is bf16."""
    cfg = Config.from_dict({"training": dict(
        optimizer="adamw", learning_rate=3e-3, batch_size=4,
        gradient_accumulation_steps=2, log_every=0, dtype="bfloat16",
        adam_mu_dtype="bfloat16")})
    tr = Trainer(cfg, gpt2_model_spec(GPT2Config.tiny(), use_flash=True,
                                      compute_dtype=torch.bfloat16),
                 task_type="clm", device="cpu")
    assert tr.optimizer.mu_dtype == torch.bfloat16
    data = [_batch(20 + i, B=4) for i in range(2)]
    params = _port_params(jax_params)
    hist = tr.fit(lambda ep: data, epochs=3, params=params,
                  opt_state=tr.optimizer.init(params))
    assert hist.train_loss[-1] < hist.train_loss[0]
    p, st = tr.final_state
    assert all(t.dtype == torch.float32 for _, t in tree_leaves(p))
    assert all(t.dtype == torch.bfloat16 for _, t in tree_leaves(st["mu"]))
    assert all(t.dtype == torch.float32 for _, t in tree_leaves(st["nu"]))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_finetune_example_reads_training_dtype(tmp_path, capsys, dtype):
    """``training.dtype: bfloat16`` trains in bf16 (with the bf16 first
    moment); any dtype but bfloat16 and float32 raises ``ValueError``, as
    in the JAX example."""
    from quintnet_tpu_torch.examples import gpt2_finetune

    cfg = {"model": {"n_layer": 2},
           "training": {"batch_size": 4, "gradient_accumulation_steps": 2,
                        "optimizer": "adamw", "learning_rate": 1e-3,
                        "log_every": 0, "dtype": dtype,
                        "adam_mu_dtype": "bfloat16"},
           "data": {"max_seq_length": 32, "train_samples": 8,
                    "val_samples": 4}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    argv = ["--config", str(path), "--tiny", "--steps", "1", "--epochs",
            "1", "--device", "cpu"]
    if dtype == "float16":
        with pytest.raises(ValueError, match="training.dtype"):
            gpt2_finetune.main(argv)
        return
    hist = gpt2_finetune.main(argv)
    assert len(hist.train_loss) == 1 and np.isfinite(hist.train_loss[0])
    assert "dtype=bfloat16 adam_mu_dtype=bfloat16" in capsys.readouterr().out


def test_optimizer_keeps_f32_moments_in_place_by_default(jax_params):
    """Without ``mu_dtype`` the update is the f32 one, in place: the same
    tensors hold the moments after a step."""
    params = _port_params(jax_params)
    opt = Optimizer("adamw", 1e-3, weight_decay=0.01)
    state = opt.init(params)
    before = [id(t) for _, t in tree_leaves(state["mu"])]
    with torch.no_grad():
        grads = {k: torch.ones_like(v) for k, v in tree_leaves(params)}
    opt.update(grads, state, params)
    assert [id(t) for _, t in tree_leaves(state["mu"])] == before
    assert all(t.dtype == torch.float32 for _, t in tree_leaves(state["mu"]))
