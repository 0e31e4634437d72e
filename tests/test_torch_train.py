"""The port's single-device GPT-2 training (quintnet_tpu_torch/models/
gpt2.py, parallel/, train/) against the JAX package, on the CPU.

Tiny GPT-2 weights come from the JAX ``gpt2_init`` through the bridge;
batches are numpy arrays from a seed. Loss ``atol=1e-5``; gradients
``atol=1e-5, rtol=1e-4`` (f32 through 4 blocks, summed in another
order); learning rates ``atol=1e-7``; a 20-step AdamW trajectory within
1e-4 relative at every step.
"""

import json

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
from quintnet_tpu_torch.train.trainer import (Trainer, make_lr_schedule,
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


def test_finetune_example_runs_on_one_cpu(tmp_path, capsys):
    from quintnet_tpu_torch.examples import gpt2_finetune

    cfg = {"model": {"n_layer": 2}, "mesh_dim": [2, 2], "mesh_name": ["dp",
                                                                     "tp"],
           "training": {"batch_size": 4, "gradient_accumulation_steps": 2,
                        "optimizer": "zero1_adamw", "learning_rate": 1e-3,
                        "log_every": 0},
           "data": {"max_seq_length": 32, "train_samples": 8,
                    "val_samples": 4}}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    hist = gpt2_finetune.main(["--config", str(path), "--tiny", "--steps",
                               "1", "--epochs", "1", "--device", "cpu"])
    assert len(hist.train_loss) == 1 and np.isfinite(hist.train_loss[0])
    assert "forced to one device" in capsys.readouterr().out


def test_metrics():
    logits = torch.tensor([[0.1, 2.0], [3.0, 0.0], [0.0, 1.0]])
    assert float(accuracy(logits, torch.tensor([1, 0, 0]))) == \
        pytest.approx(2 / 3)
    assert float(perplexity(torch.tensor(2.0))) == pytest.approx(np.exp(2.0))
    assert float(perplexity(torch.tensor(50.0))) == pytest.approx(np.exp(20))


def _not_ported_cases():
    tiny = GPT2Config.tiny()
    spec = gpt2_model_spec(tiny)
    cfg = Config.from_dict({})
    mesh_cfg = Config.from_dict({"mesh_dim": [2], "mesh_name": ["dp"]})
    stacked = {"w": torch.zeros(2, 3)}

    def trainer(**kw):
        return Trainer(cfg, spec, device="cpu", **kw)

    return {
        "checkpoint_dir": lambda: trainer(checkpoint_dir="ckpt"),
        "resume_cursor": lambda: trainer().fit(lambda e: [], cursor=object()),
        "fault_tolerance": lambda: trainer().fit(lambda e: [], ft=object()),
        "strategy_dp": lambda: get_strategy("dp", cfg),
        "mesh_of_two": lambda: get_strategy(None, mesh_cfg),
        "remat_dots_spec": lambda: gpt2_model_spec(tiny, remat="dots"),
        "remat_dots_blocks": lambda: stacked_blocks_apply(
            stacked, torch.zeros(1, 2, 3), num_heads=1, remat="dots"),
        "adam_mu_bf16": lambda: make_optimizer(Config.from_dict(
            {"training": {"adam_mu_dtype": "bfloat16"}})),
        "bf16_compute": lambda: Trainer(
            Config.from_dict({"training": {"dtype": "bfloat16"}}), spec,
            device="cpu"),
        "bf16_compute_dtype": lambda: gpt2_model_spec(
            tiny, compute_dtype=torch.bfloat16),
        "moe": lambda: gpt2_model_spec(GPT2Config.tiny(n_experts=4)),
    }


@pytest.mark.parametrize("name", sorted(_not_ported_cases()))
def test_options_not_ported_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _not_ported_cases()[name]()


def test_single_strategy_and_unknown_names():
    assert get_strategy("single").name == "single"
    assert get_strategy(None, Config.from_dict({})).name == "single"
    with pytest.raises(ValueError, match="unknown strategy"):
        get_strategy("nope")
    assert MeshConfig().world_size == 1
