"""The port's Hugging Face interop against the JAX package and transformers,
on the CPU.

- GPT-2 HF files (``models/gpt2_io.py``): a file written by JAX's
  ``save_hf_gpt2`` loads in the port to equal params, and the port's
  file loads in JAX to equal params (exactly); the HF key schema
  (``transformer.`` prefix, mask buffers and ``lm_head`` skipped).
- Logits against ``transformers`` (``pytest.importorskip``): GPT-2 from
  an HF file within ``HF_ATOL``; Llama from ``llama_from_hf_state``, with
  and without llama3 rope scaling, and back through
  ``llama_to_hf_state`` into ``LlamaForCausalLM``, within ``HF_ATOL``.
- ``tools/export_gpt2`` on a checkpoint held in the tp-blocked QKV layout
  (``--tp-layout 2``) writes JAX's ``save_hf_gpt2(tp_layout=2)`` file,
  tensor for tensor.
- ``tools/eval_ppl`` from one checkpoint file: the JAX tool's loss within
  ``PPL_RTOL`` relative (perplexity too).
- ``core/config.merge_configs``, the tree helpers of ``core/pytree`` and
  ``tools/fixtures.random_token_ids``: JAX's results.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quintnet_tpu.core import pytree as jtree
from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.core.config import merge_configs as jax_merge_configs
from quintnet_tpu.models import llama as jl
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.models.gpt2_io import load_hf_gpt2 as jax_load_hf_gpt2
from quintnet_tpu.models.gpt2_io import save_hf_gpt2 as jax_save_hf_gpt2
from quintnet_tpu.parallel.tp import \
    qkv_blocked_from_standard as jax_qkv_blocked
from quintnet_tpu.tools import eval_ppl as jax_eval_ppl
from quintnet_tpu.tools.fixtures import random_token_ids as jax_token_ids
from quintnet_tpu_torch.bridge import (gpt2_params_from_numpy,
                                       llama_params_from_numpy)
from quintnet_tpu_torch.core import pytree
from quintnet_tpu_torch.core.config import Config, merge_configs
from quintnet_tpu_torch.core.pytree import tree_leaves
from quintnet_tpu_torch.models import llama as pl
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_apply
from quintnet_tpu_torch.models.gpt2_io import load_hf_gpt2, save_hf_gpt2
from quintnet_tpu_torch.tools import eval_ppl, export_gpt2
from quintnet_tpu_torch.tools.fixtures import random_token_ids
from quintnet_tpu_torch.train.checkpoint import CheckpointManager
from quintnet_tpu_torch.utils import safetensors_io as st

torch.set_num_threads(1)

TINY = dict(vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4)
# transformers and the port on the same f32 weights: the same products
# summed in another order
HF_ATOL = 1e-5
# eval_ppl's mean loss, the port against the JAX tool on one file
PPL_RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {".".join(k): v for k, v in tree_leaves(tree)}


def _jax_gpt2(seed=0, **kw):
    cfg = JaxGPT2Config(**{**TINY, **kw})
    return cfg, _np(jax_gpt2_init(jax.random.key(seed), cfg))


def _assert_equal_to_numpy(port_tree, np_tree):
    got = _flat(port_tree)
    want = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(np_tree)[0]}
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


# ---------------------------------------------------------------------
# GPT-2 HF files, both ways
# ---------------------------------------------------------------------

def test_jax_written_gpt2_file_loads_in_the_port(tmp_path):
    cfg, jp = _jax_gpt2()
    path = str(tmp_path / "jax.safetensors")
    jax_save_hf_gpt2(jp, cfg, path)
    params, pcfg = load_hf_gpt2(path, GPT2Config(**TINY), device="cpu")
    assert pcfg == GPT2Config(**TINY)
    _assert_equal_to_numpy(params, jp)


def test_port_written_gpt2_file_loads_in_jax(tmp_path):
    cfg, jp = _jax_gpt2(seed=1)
    path = str(tmp_path / "port.safetensors")
    save_hf_gpt2(gpt2_params_from_numpy(jp, "cpu"), GPT2Config(**TINY), path)
    back, _ = jax_load_hf_gpt2(path, cfg)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(_np(back))[0],
            jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    with st.SafeTensorFile(path) as f:
        assert f.metadata == {"format": "pt"}
        assert "lm_head.weight" not in f.keys()


def test_hf_key_schema_prefix_and_skipped_buffers(tmp_path):
    """The ``transformer.`` prefix is dropped, the attention mask buffers
    and the tied ``lm_head`` are skipped, and the sizes come from the
    file (the head count from the width: 12 at 768)."""
    _, jp = _jax_gpt2(n_embd=768, n_head=12, n_layer=1, vocab_size=64,
                      n_positions=16)
    path = str(tmp_path / "plain.safetensors")
    save_hf_gpt2(gpt2_params_from_numpy(jp, "cpu"),
                 GPT2Config(**{**TINY, "n_embd": 768, "n_head": 12,
                               "n_layer": 1}), path, prefix="transformer.")
    tensors = st.load_file(path)
    tensors["transformer.h.0.attn.bias"] = torch.ones(1, 1, 16, 16)
    tensors["transformer.h.0.attn.masked_bias"] = torch.tensor(-1e4)
    tensors["lm_head.weight"] = torch.zeros(64, 768)
    st.save_file(tensors, path)
    params, cfg = load_hf_gpt2(path, device="cpu")
    assert (cfg.vocab_size, cfg.n_positions, cfg.n_embd, cfg.n_layer,
            cfg.n_head) == (64, 16, 768, 1, 12)
    _assert_equal_to_numpy(params, jp)


# ---------------------------------------------------------------------
# logits against transformers
# ---------------------------------------------------------------------

def test_gpt2_logits_match_transformers(tmp_path):
    """An HF ``GPT2LMHeadModel``'s own safetensors file, loaded by the
    port: the logits within ``HF_ATOL``; the port's export of those
    params loads back into transformers to the same logits."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(
        vocab_size=TINY["vocab_size"], n_positions=TINY["n_positions"],
        n_embd=TINY["n_embd"], n_layer=TINY["n_layer"],
        n_head=TINY["n_head"], resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0)
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(hf_cfg).eval()
    model.save_pretrained(str(tmp_path / "hf"), safe_serialization=True)
    params, _ = load_hf_gpt2(str(tmp_path / "hf" / "model.safetensors"),
                             GPT2Config(**TINY), device="cpu")
    ids = torch.tensor([[1, 5, 9, 2, 77, 31, 4, 8], [3, 3, 120, 0, 64, 7,
                                                     99, 12]])
    with torch.no_grad():
        ref = model(ids).logits
        got = gpt2_apply(params, ids, GPT2Config(**TINY))
        flash = gpt2_apply(params, ids, GPT2Config(**TINY), use_flash=True)
    torch.testing.assert_close(got, ref, atol=HF_ATOL, rtol=0)
    torch.testing.assert_close(flash, ref, atol=HF_ATOL, rtol=0)

    out = str(tmp_path / "exported.safetensors")
    save_hf_gpt2(params, GPT2Config(**TINY), out)
    again = transformers.GPT2LMHeadModel(hf_cfg).eval()
    missing, unexpected = again.transformer.load_state_dict(
        st.load_file(out), strict=False)
    assert not unexpected and not [m for m in missing
                                   if not m.endswith("attn.bias")]
    again.tie_weights()
    with torch.no_grad():
        torch.testing.assert_close(again(ids).logits, ref, atol=0, rtol=0)


def _hf_llama(transformers, tied, **kw):
    cfg = pl.LlamaConfig.tiny(tie_embeddings=tied)
    return transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads,
        max_position_embeddings=cfg.n_positions, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_eps, tie_word_embeddings=tied,
        attention_bias=False, mlp_bias=False, **kw)


LLAMA_HF = {
    "untied": {"tied": False},
    "tied": {"tied": True},
    # llama3 rope scaling, the sequence past original_max / 2 so the
    # scaled lanes matter
    "rope_scaled": {"tied": False, "rope_scaling": {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 32}},
}


@pytest.mark.parametrize("name", sorted(LLAMA_HF))
def test_llama_logits_match_transformers(name):
    """``LlamaConfig.from_hf_config`` + ``llama_from_hf_state`` of an HF
    ``LlamaForCausalLM``: the logits within ``HF_ATOL``, through the
    plain and the flash attention."""
    transformers = pytest.importorskip("transformers")
    kw = dict(LLAMA_HF[name])
    tied = kw.pop("tied")
    torch.manual_seed(1)
    hf = transformers.LlamaForCausalLM(_hf_llama(transformers, tied,
                                                 **kw)).eval()
    cfg = pl.LlamaConfig.from_hf_config(hf.config)
    assert cfg.tie_embeddings == tied
    params = pl.llama_from_hf_state(hf.state_dict(), cfg, device="cpu")
    ids = torch.from_numpy(random_token_ids(cfg.vocab_size, 2, 48,
                                            seed=3)).long()
    with torch.no_grad():
        ref = hf(ids).logits
        for use_flash in (False, True):
            got = pl.llama_apply(params, ids, cfg, use_flash=use_flash)
            torch.testing.assert_close(got, ref, atol=HF_ATOL, rtol=0)


def test_llama_export_loads_in_transformers():
    """JAX-initialised weights carried into the port, exported with
    ``llama_to_hf_state`` and loaded by ``LlamaForCausalLM``: HF's logits
    equal the port's within ``HF_ATOL``."""
    transformers = pytest.importorskip("transformers")
    cfg = pl.LlamaConfig.tiny()
    jcfg = jl.LlamaConfig.tiny()
    params = llama_params_from_numpy(
        _np(jl.llama_init(jax.random.key(2), jcfg)), "cpu")
    hf = transformers.LlamaForCausalLM(_hf_llama(transformers,
                                                 False)).eval()
    missing, unexpected = hf.load_state_dict(pl.llama_to_hf_state(params,
                                                                  cfg),
                                             strict=False)
    assert not unexpected, unexpected
    assert all("rotary" in m for m in missing), missing
    ids = torch.from_numpy(random_token_ids(cfg.vocab_size, 2, 12,
                                            seed=9)).long()
    with torch.no_grad():
        torch.testing.assert_close(pl.llama_apply(params, ids, cfg),
                                   hf(ids).logits, atol=HF_ATOL, rtol=0)
    with pytest.raises(ValueError, match="dense Llama only"):
        pl.llama_to_hf_state({"blocks": {"moe": {}}}, cfg)


# ---------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2])
def test_export_gpt2_matches_jax(tmp_path, tp):
    """A checkpoint whose fused QKV is in the tp-blocked layout of ``tp``
    (a tp run's, restored whole), exported by ``tools/export_gpt2`` with
    ``--tp-layout``: JAX's ``save_hf_gpt2(tp_layout=tp)`` of the same
    params, tensor for tensor, and the standard params when read back."""
    cfg, jp = _jax_gpt2(seed=4)
    blocked = jax.tree.map(lambda x: x, jp)
    qkv = blocked["blocks"]["attn"]["qkv"]
    qkv["w"] = np.asarray(jax_qkv_blocked(qkv["w"], cfg.n_head, tp))
    qkv["b"] = np.asarray(jax_qkv_blocked(qkv["b"], cfg.n_head, tp))
    params = gpt2_params_from_numpy(blocked, "cpu")
    ck = str(tmp_path / "ck")
    CheckpointManager(ck).save(7, {"params": params, "opt": {"count": 3},
                                   "epoch": 1})
    out = str(tmp_path / "port.safetensors")
    size = ["--n-layer", "2", "--n-embd", "32", "--n-head", "4",
            "--vocab-size", "128", "--n-positions", "64"]
    assert export_gpt2.main(["--checkpoint-dir", ck, "--out", out,
                             "--tp-layout", str(tp), *size]) == 7
    want = str(tmp_path / "jax.safetensors")
    jax_save_hf_gpt2(blocked, cfg, want, tp_layout=tp)
    got, ref = st.load_file(out), st.load_file(want)
    assert got.keys() == ref.keys()
    for k in got:
        assert torch.equal(got[k], ref[k]), k
    back, _ = load_hf_gpt2(out, GPT2Config(**TINY), device="cpu")
    _assert_equal_to_numpy(back, jp)


def test_eval_ppl_matches_jax(tmp_path, monkeypatch):
    """One HF checkpoint file (JAX's ``save_hf_gpt2``, at a width whose
    head count the loader infers) scored over one text by the port's
    ``eval_ppl`` and by the JAX tool's ``main``: the loss within
    ``PPL_RTOL`` relative. The tail window's EOS padding is masked, so
    the windows carry ``real_tokens`` targets."""
    cfg, jp = _jax_gpt2(seed=5, vocab_size=264, n_embd=50, n_head=25)
    ckpt = str(tmp_path / "gpt2.safetensors")
    jax_save_hf_gpt2(jp, cfg, ckpt)
    text = tmp_path / "text.txt"
    text.write_text("Packed-stride perplexity over a small text file. "
                    * 7 + "The tail is ragged.\n")
    got = eval_ppl.evaluate(str(text), checkpoint=ckpt, seq=64, batch=2,
                            device="cpu")
    plain = eval_ppl.evaluate(str(text), checkpoint=ckpt, seq=64, batch=2,
                              device="cpu", use_flash=False)
    assert got["windows"] == -(-got["real_tokens"] // 64) == 6

    seen = []
    average = np.average

    def keep(*a, **kw):
        seen.append(average(*a, **kw))
        return seen[-1]

    with monkeypatch.context() as m:
        m.setattr(np, "average", keep)
        m.setattr(sys, "argv", ["eval_ppl", "--text", str(text),
                                "--checkpoint", ckpt, "--seq", "64",
                                "--batch", "2", "--platform", "cpu"])
        jax_eval_ppl.main()
    (want,) = seen
    np.testing.assert_allclose(got["loss"], want, rtol=PPL_RTOL)
    np.testing.assert_allclose(plain["loss"], want, rtol=PPL_RTOL)
    np.testing.assert_allclose(got["perplexity"], np.exp(want),
                               rtol=2 * PPL_RTOL)


def test_eval_ppl_cli_random_models_on_the_cpu(tmp_path, capsys):
    """The CLI without a checkpoint (a random tiny model: a plumbing
    smoke) for both families, and an empty text refused."""
    text = tmp_path / "t.txt"
    text.write_text("hello world, " * 20)
    for family in ("gpt2", "llama"):
        res = eval_ppl.main(["--text", str(text), "--family", family,
                             "--seq", "32", "--batch", "4",
                             "--device", "cpu"])
        assert np.isfinite(res["loss"]) and res["windows"] == 9
    out = capsys.readouterr().out
    assert out.count("perplexity") == 2
    (tmp_path / "empty.txt").write_text("")
    with pytest.raises(SystemExit, match="no tokens"):
        eval_ppl.main(["--text", str(tmp_path / "empty.txt"),
                       "--device", "cpu"])


# ---------------------------------------------------------------------
# merge_configs, the tree helpers, the fixtures
# ---------------------------------------------------------------------

def test_merge_configs_matches_jax():
    raw = {"mesh_dim": [2, 2], "mesh_name": ["dp", "tp"],
           "model": {"name": "gpt2", "n_layer": 4},
           "training": {"batch_size": 32, "learning_rate": 1e-3}}
    override = {"training": {"batch_size": 64, "epochs": 3},
                "model": {"n_layer": 2, "extra_key": 1},
                "strategy_name": "dp_tp"}
    got = merge_configs(Config.from_dict(raw), override)
    want = jax_merge_configs(JaxConfig.from_dict(raw), override)
    assert got.training.batch_size == 64 and got.training.epochs == 3
    assert got.training.learning_rate == 1e-3
    assert got.strategy_name == "dp_tp"
    g, w = got.to_dict(), want.to_dict()
    for section in ("mesh", "model", "training"):
        common = set(g[section]) & set(w[section])
        assert {k: g[section][k] for k in common} == \
            {k: w[section][k] for k in common}, section
    assert g["strategy_name"] == w["strategy_name"]


def _trees(seed=0):
    rng = np.random.default_rng(seed)

    def tree():
        return {"a": rng.standard_normal((3, 4)).astype(np.float32),
                "b": {"c": rng.standard_normal(5).astype(np.float32),
                      "n": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    return [tree() for _ in range(3)]


def _port(tree):
    return {k: _port(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _same(got, want, rtol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], rtol)
        return
    w = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.zeros(0, w.dtype)).dtype
    np.testing.assert_allclose(got.numpy(), w, rtol=rtol, atol=0)


TREE_HELPERS = {
    "count_params": lambda m, t: m.tree_count_params(t[0]),
    "bytes": lambda m, t: m.tree_bytes(t[0]),
    "stack": lambda m, t: m.tree_stack(t),
    "unstack": lambda m, t: m.tree_unstack(m.tree_stack(t), 3)[1],
    "zeros_like": lambda m, t: m.tree_zeros_like(t[0]),
    "add": lambda m, t: m.tree_add(t[0], t[1]),
    "scale": lambda m, t: m.tree_scale(t[0], 0.5),
    "global_norm": lambda m, t: m.global_norm(t[0]),
    "clip_by_global_norm": lambda m, t: m.clip_by_global_norm(t[0], 1.0),
    "cast": lambda m, t: m.tree_cast(t[0], None),
}


@pytest.mark.parametrize("name", sorted(TREE_HELPERS))
def test_tree_helpers_match_jax(name):
    """Each helper of ``core/pytree`` gives JAX's result on the same
    trees: exactly, but for the global norm (and the clip it scales
    by), within 1e-6 relative (f32 sums in another order)."""
    trees = _trees()
    if name == "cast":
        got = pytree.tree_cast(_port(trees[0]), torch.bfloat16)
        want = jtree.tree_cast(jax.tree.map(jnp.asarray, trees[0]),
                               jnp.bfloat16)
        assert got["b"]["n"].dtype == torch.int32
        np.testing.assert_array_equal(
            got["a"].float().numpy(),
            np.asarray(want["a"].astype(jnp.float32)))
        return
    got = TREE_HELPERS[name](pytree, [_port(t) for t in trees])
    want = TREE_HELPERS[name](jtree, [jax.tree.map(jnp.asarray, t)
                                      for t in trees])
    rtol = 1e-6 if "norm" in name else 0.0
    if name == "clip_by_global_norm":
        _same(got[0], want[0], rtol)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=rtol)
    elif isinstance(want, int):
        assert got == want
    elif name == "global_norm":
        np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    else:
        _same(got, want)


def test_random_token_ids_matches_jax():
    got = random_token_ids(50257, 2, 16, seed=3)
    want = jax_token_ids(50257, 2, 16, seed=3)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, random_token_ids(50257, 2, 16, seed=4))


def test_loaders_refuse_cuda_without_a_card(tmp_path):
    """Loading lands on the card unless the caller asks for the CPU: with
    no card, the default raises instead of running elsewhere."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    cfg, jp = _jax_gpt2()
    path = str(tmp_path / "g.safetensors")
    jax_save_hf_gpt2(jp, cfg, path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_hf_gpt2(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pl.llama_from_hf_state({}, pl.LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_ppl.evaluate(path, checkpoint=path)
