"""The port's GPT-2 (quintnet_tpu_torch/models/gpt2.py), its layers and
the weight bridge, against the JAX package.

Weights come from the JAX ``gpt2_init`` and cross through the bridge;
inputs are numpy arrays from a seed. Logits are compared at
``atol=1e-4`` (f32 through 2-4 blocks, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_apply as jax_gpt2_apply
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.nn import layers as jlayers
from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                       gpt2_params_to_numpy)
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_apply, gpt2_init
from quintnet_tpu_torch.nn import layers as tlayers

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_tiny():
    return jax.tree.map(np.asarray, jax_gpt2_init(jax.random.key(0),
                                                  JaxGPT2Config.tiny()))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_bridge_round_trip_bit_exact(jax_tiny):
    back = gpt2_params_to_numpy(gpt2_params_from_numpy(jax_tiny, "cpu"))
    a, b = dict(_flat(jax_tiny)), dict(_flat(back))
    assert a.keys() == b.keys()
    for path in a:
        assert a[path].dtype == b[path].dtype, path
        np.testing.assert_array_equal(a[path], b[path], err_msg=str(path))


def test_bridge_rejects_a_tree_that_is_not_gpt2(jax_tiny):
    bad = {**jax_tiny, "head": {}}
    with pytest.raises(ValueError, match="head.ln_f"):
        gpt2_params_from_numpy(bad, "cpu")


@pytest.mark.parametrize("n_layer", [2, 4])
def test_gpt2_apply_matches_jax(n_layer):
    jcfg = JaxGPT2Config.tiny(n_layer=n_layer)
    jp = jax_gpt2_init(jax.random.key(n_layer), jcfg)
    tp = gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 17))
    want = np.asarray(jax_gpt2_apply(jp, jnp.asarray(ids), jcfg))
    got = gpt2_apply(tp, torch.from_numpy(ids),
                     GPT2Config.tiny(n_layer=n_layer))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_base_config_shapes_match_jax():
    shapes = jax.eval_shape(
        lambda: jax_gpt2_init(jax.random.key(0), JaxGPT2Config.base()))
    want = {p: tuple(s.shape) for p, s in _flat(shapes)}
    cfg = GPT2Config.base()
    assert (cfg.vocab_size, cfg.n_positions, cfg.n_embd, cfg.n_layer,
            cfg.n_head) == (50257, 1024, 768, 12, 12)
    params = gpt2_init(torch.Generator().manual_seed(0), cfg)
    got = {p: tuple(t.shape) for p, t in _flat(params)}
    assert got == want
    ids = torch.randint(0, cfg.vocab_size, (1, 8),
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits = gpt2_apply(params, ids, cfg)
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_init_statistics_follow_the_jax_recipe():
    cfg = GPT2Config.tiny(n_embd=64)
    p = gpt2_init(torch.Generator().manual_seed(0), cfg)
    bound = 1 / np.sqrt(cfg.n_embd)
    w = p["blocks"]["attn"]["qkv"]["w"]
    assert w.shape == (cfg.n_layer, 64, 192)
    assert float(w.abs().max()) <= bound
    assert abs(float(p["embedding"]["wte"].std()) - 0.02) < 0.003
    assert torch.equal(p["head"]["ln_f"]["scale"], torch.ones(64))


def test_config_from_dict_keeps_known_fields():
    cfg = GPT2Config.from_dict({"n_layer": 3, "n_embd": 48, "n_head": 4,
                                "dropout": 0.1, "loss_chunk": 8})
    assert (cfg.n_layer, cfg.n_embd, cfg.head_dim) == (3, 48, 12)
    assert GPT2Config.medium().n_layer == 24
    assert GPT2Config.xl().n_embd == 1600


def test_sample_logits_filters():
    from quintnet_tpu_torch.models.gpt2_generate import sample_logits

    logits = torch.tensor([[0.1, 2.0, -1.0, 1.9, 0.5]] * 64)
    greedy = sample_logits(logits, temperature=0.0)
    assert greedy.tolist() == [1] * 64
    gen = torch.Generator().manual_seed(0)
    top2 = sample_logits(logits, gen, temperature=1.0, top_k=2)
    assert set(top2.tolist()) == {1, 3}
    # nucleus at 0.5 keeps the top token only (it holds >= half the mass
    # after temperature 0.1 sharpening)
    nucleus = sample_logits(logits, gen, temperature=0.1, top_p=0.5)
    assert nucleus.tolist() == [1] * 64


LAYER_X = np.random.default_rng(3).standard_normal((2, 5, 16)).astype(
    np.float32)


@pytest.mark.parametrize("name", ["layer_norm", "gelu", "linear", "mlp"])
def test_layers_match_jax(name):
    rng = np.random.default_rng(4)
    x = LAYER_X
    if name == "layer_norm":
        p = {"scale": rng.standard_normal(16).astype(np.float32),
             "bias": rng.standard_normal(16).astype(np.float32)}
        want = jlayers.layer_norm_apply(p, jnp.asarray(x))
        got = tlayers.layer_norm_apply(
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))
    elif name == "gelu":
        want = jlayers.gelu(jnp.asarray(x))
        got = tlayers.gelu(torch.from_numpy(x))
    else:
        jp = (jlayers.linear_init(jax.random.key(5), 16, 24)
              if name == "linear"
              else jlayers.mlp_init(jax.random.key(5), 16, 64))
        tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
        fn = "linear_apply" if name == "linear" else "mlp_apply"
        want = getattr(jlayers, fn)(jp, jnp.asarray(x))
        got = getattr(tlayers, fn)(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
