"""The port's ViT (quintnet_tpu_torch/models/vit.py) against the JAX
package's, on the CPU.

Weights come from the JAX ``vit_init`` through the bridge; images are
numpy arrays from a seed (or the MNIST fixture in ``tests/fixtures``).
Logits and loss ``atol=1e-5``; gradients ``atol=1e-5, rtol=1e-4`` (f32
through the blocks, summed in another order); 10 Adam steps within
1e-4 relative at every step; accuracy exactly equal. bf16 compute
(``compute_dtype=bfloat16``) against the JAX bf16 forward on the same
weights, compiled without XLA's excess precision (each bf16 op rounds,
as in torch): f32 logits and gradients, the loss within 2e-2 relative
of the f32 loss, and the loss and each gradient leaf no farther from
JAX's bf16 result than twice JAX's own bf16-to-f32 distance (the gate
and its reason as in ``tests/test_torch_train.py``); measured worst
1.08 (``head.fc.b``, reference width), the tiny model's loss equal.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.core.pytree import clip_by_global_norm as jax_clip
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import accuracy as jax_accuracy
from quintnet_tpu.models.vit import \
    cross_entropy_loss as jax_cross_entropy_loss
from quintnet_tpu.models.vit import vit_apply as jax_vit_apply
from quintnet_tpu.models.vit import vit_forward as jax_vit_forward
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.models.vit import vit_model_spec as jax_vit_model_spec
from quintnet_tpu.nn.layers import patchify as jax_patchify
from quintnet_tpu.parallel.dp import accumulate_grads as jax_accumulate
from quintnet_tpu.train.trainer import Trainer as JaxTrainer
from quintnet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from quintnet_tpu_torch.bridge import (vit_params_from_numpy,
                                       vit_params_to_numpy)
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.pytree import tree_map
from quintnet_tpu_torch.data.datasets import load_mnist
from quintnet_tpu_torch.models.vit import (ViTConfig, accuracy,
                                           cross_entropy_loss, vit_apply,
                                           vit_init, vit_model_spec)
from quintnet_tpu_torch.nn.layers import patchify
from quintnet_tpu_torch.parallel.train_step import accumulate_grads
from quintnet_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

FIXTURE = str(Path(__file__).resolve().parent / "fixtures" / "mnist")
TINY = dict(depth=2, hidden_dim=32, num_heads=4)
FULL = dict(depth=8, hidden_dim=64, num_heads=4)   # examples/config.yaml


def _np_params(cfg_kw, seed=0):
    return jax.tree.map(np.asarray, jax_vit_init(jax.random.key(seed),
                                                 JaxViTConfig(**cfg_kw)))


def _port_params(np_tree):
    return tree_map(lambda t: t.requires_grad_(True),
                    vit_params_from_numpy(np_tree, "cpu"))


def _images(seed, B=4, layout="nhwc"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, B).astype(np.int32)
    if layout == "nchw":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    return x, y


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("shape,p", [((2, 28, 28, 1), 7),
                                     ((3, 8, 12, 3), 4)])
def test_patchify_equals_jax_exactly(shape, p):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_patchify(jnp.asarray(x), p))
    got = patchify(torch.from_numpy(x), p).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_patchify_rejects_a_ragged_grid():
    with pytest.raises(ValueError, match="patches"):
        patchify(torch.zeros(1, 28, 28, 1), 5)


def test_bridge_round_trip_and_layout_check():
    np_tree = _np_params(TINY)
    back = vit_params_to_numpy(vit_params_from_numpy(np_tree, "cpu"))
    for (pa, a), (pb, b) in zip(_flat(np_tree), _flat(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    bad = dict(np_tree, head={"fc": np_tree["head"]["fc"]})
    with pytest.raises(ValueError, match="not a dense ViT"):
        vit_params_from_numpy(bad, "cpu")


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("size", ["tiny", "full"])
def test_logits_match_jax(layout, size):
    kw = TINY if size == "tiny" else FULL
    np_tree = _np_params(kw, seed=1)
    x, _ = _images(2, B=8, layout=layout)
    want = np.asarray(jax_vit_apply(jax.tree.map(jnp.asarray, np_tree),
                                    jnp.asarray(x), JaxViTConfig(**kw)))
    with torch.no_grad():
        got = vit_apply(vit_params_from_numpy(np_tree, "cpu"),
                        torch.from_numpy(x), ViTConfig(**kw)).numpy()
    assert got.shape == (8, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


GRAD_CASES = {
    "nhwc": dict(layout="nhwc"),
    "nchw": dict(layout="nchw"),
    "remat": dict(layout="nhwc", remat=True),
    "reference_width_remat": dict(layout="nchw", remat=True, cfg=FULL),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_loss_and_every_gradient_match_jax(name):
    c = GRAD_CASES[name]
    kw = c.get("cfg", TINY)
    np_tree = _np_params(kw, seed=3)
    x, y = _images(4, B=6, layout=c["layout"])
    jspec = jax_vit_model_spec(JaxViTConfig(**kw),
                               remat=c.get("remat", False))
    jbatch = (jnp.asarray(x), jnp.asarray(y))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jspec.loss_fn(p, jbatch)))(
            jax.tree.map(jnp.asarray, np_tree))

    spec = vit_model_spec(ViTConfig(**kw), remat=c.get("remat", False))
    loss, grads = accumulate_grads(
        spec.loss_fn, _port_params(np_tree),
        (torch.from_numpy(x), torch.from_numpy(y).long()), 1)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    assert set(grads) == set(want)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], atol=1e-5,
                                   rtol=1e-4, err_msg=".".join(path))


def test_cross_entropy_matches_torch():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((7, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 7)
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels))
    ref = torch.nn.functional.cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(labels))
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


def test_adam_on_the_mnist_fixture_tracks_jax_for_10_steps():
    """The reference training block (Adam at lr 3e-4, 2 micro-batches,
    clip 1.0; examples/config.yaml) on the 24 fixture images in batches
    of 8, 10 steps: the port's Trainer step against JAX's own
    single-device step. (At lr 1e-3 the two drift apart by ~1e-4 within
    10 steps: a ReLU unit whose pre-activation sits at its kink flips its
    gradient on a rounding difference, and Adam's normalised update
    turns that into a full step.)"""
    t = dict(optimizer="adam", learning_rate=3e-4, grad_clip_norm=1.0,
             batch_size=8, gradient_accumulation_steps=2)
    x, y = load_mnist(FIXTURE, split="train")
    assert len(x) == 24
    batches = [(x[i:i + 8], y[i:i + 8]) for i in range(0, 24, 8)]
    np_tree = _np_params(TINY, seed=7)
    jspec = jax_vit_model_spec(JaxViTConfig(**TINY))
    opt = jax_make_optimizer(JaxConfig.from_dict({"training": t}))

    @jax.jit
    def jax_step(p, st, batch):
        loss, g = jax_accumulate(jspec.loss_fn, p, batch, 2)
        g, _ = jax_clip(g, 1.0)
        upd, st = opt.update(g, st, p)
        return optax.apply_updates(p, upd), st, loss

    jp = jax.tree.map(jnp.asarray, np_tree)
    st = opt.init(jp)
    trainer = Trainer(Config.from_dict({"training": t}),
                      vit_model_spec(ViTConfig(**TINY)), device="cpu")
    params = _port_params(np_tree)
    opt_state = trainer.optimizer.init(params)
    jl, tl = [], []
    for i in range(10):
        xb, yb = batches[i % 3]
        jp, st, loss = jax_step(jp, st, (jnp.asarray(xb), jnp.asarray(yb)))
        jl.append(float(loss))
        params, opt_state, loss = trainer.step_fn(
            params, opt_state, trainer.device_batch(xb, yb))
        tl.append(float(loss))
    assert jl[-1] < jl[0] - 0.1          # the trajectory moves
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


@pytest.mark.parametrize("split", ["train", "test"])
def test_accuracy_equals_jax_exactly(split):
    """On the fixture split, with random and with briefly trained
    weights: the same argmax for every image."""
    x, y = load_mnist(FIXTURE, split=split)
    np_tree = _np_params(TINY, seed=11)
    want = float(jax_accuracy(
        jax_vit_apply(jax.tree.map(jnp.asarray, np_tree), jnp.asarray(x),
                      JaxViTConfig(**TINY)), jnp.asarray(y)))
    with torch.no_grad():
        got = float(accuracy(vit_apply(vit_params_from_numpy(np_tree, "cpu"),
                                       torch.from_numpy(x), ViTConfig(**TINY)),
                             torch.from_numpy(y)))
    assert got == want


def test_trainer_evaluate_equals_the_jax_trainer():
    """``Trainer.evaluate`` with the model's ``eval_metrics_fn``: loss
    and accuracy over 4 batches of synthetic images, against the JAX
    trainer's evaluate on the same weights (accuracy exactly)."""
    from quintnet_tpu_torch.data.datasets import (ArrayDataset, make_batches,
                                                  synthetic_mnist)

    x, y = synthetic_mnist(64, seed=3)
    ds = ArrayDataset(x, y)
    np_tree = _np_params(TINY, seed=13)
    jt = JaxTrainer(JaxConfig.from_dict({}),
                    jax_vit_model_spec(JaxViTConfig(**TINY)),
                    log_fn=lambda m: None)
    want = jt.evaluate(jax.tree.map(jnp.asarray, np_tree),
                       make_batches(ds, 16, shuffle=False))
    tr = Trainer(Config.from_dict({}), vit_model_spec(ViTConfig(**TINY)),
                 device="cpu", log_fn=lambda m: None)
    got = tr.evaluate(_port_params(np_tree),
                      make_batches(ds, 16, shuffle=False))
    assert set(got) == {"loss", "accuracy"} == set(want)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5)
    assert got["accuracy"] == want["accuracy"]


def test_fit_reports_val_accuracy_and_learns():
    from quintnet_tpu_torch.data.datasets import (ArrayDataset, make_batches,
                                                  synthetic_mnist)

    train = ArrayDataset(*synthetic_mnist(256, seed=0))
    test = ArrayDataset(*synthetic_mnist(64, seed=1))
    cfg = Config.from_dict({"training": dict(
        optimizer="adam", learning_rate=3e-3, batch_size=32, log_every=0)})
    tr = Trainer(cfg, vit_model_spec(ViTConfig(**TINY)), device="cpu",
                 log_fn=lambda m: None)
    hist = tr.fit(lambda ep: make_batches(train, 32, seed=ep), epochs=3,
                  val_batches_fn=lambda ep: make_batches(test, 32,
                                                         shuffle=False))
    assert len(hist.val_metric) == len(hist.val_loss) == 3
    assert all(0.0 <= a <= 1.0 for a in hist.val_metric)
    assert hist.train_loss[-1] < hist.train_loss[0]


def test_dropout_under_remat_replays_the_masks():
    """With dropout on, each layer's recomputation draws the forward's
    masks again: the same loss and gradients with and without remat."""
    cfg = ViTConfig(dropout=0.2, **TINY)
    np_tree = _np_params(TINY, seed=2)
    x, y = _images(6, B=4)
    out = []
    for remat in (False, True):
        spec = vit_model_spec(cfg, remat=remat)
        assert spec.needs_rng
        gen = torch.Generator().manual_seed(5)
        out.append(accumulate_grads(spec.loss_fn, _port_params(np_tree),
                                    (torch.from_numpy(x),
                                     torch.from_numpy(y).long()), 1,
                                    generator=gen))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for path in g0:
        torch.testing.assert_close(g1[path], g0[path], atol=1e-6, rtol=1e-5)


def test_init_matches_the_jax_layout_and_statistics():
    cfg = ViTConfig(**TINY)
    p = vit_init(torch.Generator().manual_seed(0), cfg)
    np_tree = _np_params(TINY)
    got = {k: tuple(v.shape) for k, v in _flat(p)}
    want = {k: tuple(v.shape) for k, v in _flat(np_tree)}
    assert got == want
    assert 0.01 < float(p["embedding"]["pos"].std()) < 0.03


@pytest.mark.parametrize("where", ["spec", "init", "forward"])
def test_moe_vit_raises_naming_roadmap(where):
    """MoE ViT was refused (ROADMAP.md §1, item 4) until it was ported:
    the spec, init and forward now take it, and the one thing left to
    raise is a router nobody defines (``ValueError``, as in JAX)."""
    cfg = ViTConfig(n_experts=4, **TINY)
    params = vit_init(torch.Generator().manual_seed(0), cfg)
    images = torch.zeros(2, cfg.image_size, cfg.image_size, 1)
    if where == "spec":
        assert vit_model_spec(cfg).partition_specs(ep_axis="ep")[
            "blocks"]["moe"]["w1"] == (None, "ep", None, None)
    elif where == "init":
        assert tuple(params["blocks"]["moe"]["w1"].shape) == (
            cfg.depth, 4, cfg.hidden_dim, cfg.mlp_hidden)
        assert "mlp" not in params["blocks"]
    else:
        assert vit_apply(params, images, cfg).shape == (2, 10)
    with pytest.raises(ValueError, match="unknown router"):
        vit_apply(params, images, dataclasses.replace(cfg,
                                                      router_type="nope"))


def test_config_from_the_reference_model_block():
    from quintnet_tpu_torch.core.config import load_config

    root = Path(__file__).resolve().parents[1]
    cfg = load_config(str(root / "quintnet_tpu_torch/examples/"
                                 "dp_config.json"))
    ref = JaxViTConfig.from_model_config(JaxConfig.from_dict(
        {"model": dict(image_size=28, patch_size=7, in_channels=1,
                       hidden_dim=64, depth=8, num_heads=4,
                       num_classes=10)}).model)
    port = ViTConfig.from_model_config(cfg.model)
    assert (port.hidden_dim, port.depth, port.num_heads, port.seq_len,
            port.mlp_hidden) == (ref.hidden_dim, ref.depth, ref.num_heads,
                                 ref.seq_len, ref.mlp_hidden) == (
                                     64, 8, 4, 17, 256)


def test_single_device_example_trains_resumes_and_verifies(tmp_path, capsys):
    """``examples/train_single_device`` on the CPU (the reference's
    dp_config.json forced to one device; no MNIST files, so the synthetic
    stand-in), resumed from its checkpoint for a second epoch, then
    ``tools/verify_vit`` reloading it from the command line."""
    from quintnet_tpu_torch.examples import train_single_device
    from quintnet_tpu_torch.tools import verify_vit

    data = tmp_path / "no_mnist"
    data.mkdir()
    ck = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--limit", "64", "--checkpoint-dir", ck,
            "--data-dir", str(data)]
    h1 = train_single_device.main(argv + ["--epochs", "1"])
    h2 = train_single_device.main(argv + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "data=synthetic_mnist" in out
    assert "continuing at epoch 1 step 0" in out
    assert len(h1.train_loss) == 1 and len(h2.train_loss) == 2
    assert h2.train_loss[0] == h1.train_loss[0]
    res = verify_vit.main(["--checkpoint-dir", ck, "--device", "cpu",
                           "--batch-size", "512", "--data-dir", str(data)])
    assert "reloaded epoch 1" in capsys.readouterr().out
    # the whole synthetic test split (the example capped its own at 64)
    assert res["n_examples"] == 4096 and 0.0 <= res["accuracy"] <= 1.0


def _max_diff(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_bf16_loss_and_every_gradient_match_jax_bf16(name):
    c = GRAD_CASES[name]
    kw = c.get("cfg", TINY)
    np_tree = _np_params(kw, seed=3)
    x, y = _images(4, B=6, layout=c["layout"])
    jcfg = JaxViTConfig(**kw)
    want = {}
    for dt in (None, jnp.bfloat16):
        def jloss_fn(p, dt=dt):
            logits, _ = jax_vit_forward(p, jnp.asarray(x), jcfg,
                                        remat=c.get("remat", False),
                                        compute_dtype=dt)
            return jax_cross_entropy_loss(logits, jnp.asarray(y))
        jparams = jax.tree.map(jnp.asarray, np_tree)
        jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn)).lower(
            jparams).compile(compiler_options={
                "xla_allow_excess_precision": False})(jparams)
        want[dt] = (float(jloss), dict(_flat(jax.tree.map(
            lambda a: np.asarray(a, np.float32), jgrads))))

    cfg = ViTConfig(**kw)
    spec = vit_model_spec(cfg, remat=c.get("remat", False),
                          compute_dtype=torch.bfloat16)
    params = _port_params(np_tree)
    loss, grads = accumulate_grads(
        spec.loss_fn, params,
        (torch.from_numpy(x), torch.from_numpy(y).long()), 1)
    with torch.no_grad():
        logits = vit_apply(params, torch.from_numpy(x), cfg,
                           compute_dtype=torch.bfloat16)
    (l32, g32), (l16, g16) = want[None], want[jnp.bfloat16]
    assert logits.dtype == torch.float32 and loss.dtype == torch.float32
    assert abs(float(loss) - l32) <= 2e-2 * abs(l32)
    assert abs(float(loss) - l16) <= 2 * abs(l16 - l32)
    assert set(grads) == set(g16)
    for path, g in grads.items():
        assert g.dtype == torch.float32, path
        own = _max_diff(g16[path], g32[path])     # JAX's bf16 distance
        assert _max_diff(g, g16[path]) <= 2 * own, ".".join(path)
