"""Checkpoints and step-granular resume on one device, on the CPU.

The port's safetensors files against the JAX package's reader and
writer (bitwise both ways); ``CheckpointManager`` (retention, no
overwrite without ``force``, torn steps raising
``CheckpointRestoreError``, ``restore_with_fallback`` walking past
them); the cursor and the cadence (the JAX cases of ``tests/test_ft.py``);
and kill-and-resume: a run cut at a saved step and resumed by a fresh
``Trainer`` equals the uncut run bit for bit (params, optimizer state,
``History``) for tiny ViT and tiny GPT-2, both with dropout on, and for
tiny GPT-2 in bf16 (``training.dtype: bfloat16``, ``adam_mu_dtype:
bfloat16``: the first moment is saved and restored as bf16).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quintnet_tpu.train.checkpoint import load_pytree as jax_load_pytree
from quintnet_tpu.train.checkpoint import save_pytree as jax_save_pytree
from quintnet_tpu.utils import safetensors_io as jax_st
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.pytree import tree_leaves
from quintnet_tpu_torch.data.datasets import (ArrayDataset, PackedLMDataset,
                                              make_batches, synthetic_mnist)
from quintnet_tpu_torch.ft import (CadenceController, TrainCursor,
                                   restore_with_fallback)
from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_model_spec
from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec
from quintnet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 CheckpointRestoreError,
                                                 keystr, load_pytree,
                                                 save_pytree)
from quintnet_tpu_torch.train.trainer import History, Trainer, make_optimizer
from quintnet_tpu_torch.utils import safetensors_io as st

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "int32": torch.int32,
          "bf16": torch.bfloat16, "int8": torch.int8}


def _tensor(name, shape=(3, 5), seed=0):
    g = torch.Generator().manual_seed(seed)
    if name in ("int32", "int8"):
        return torch.randint(-100, 100, shape, generator=g,
                             dtype=DTYPES[name])
    return torch.randn(shape, generator=g).to(DTYPES[name])


def _bits(t):
    """A tensor's bytes as an integer array (bf16 via its 16-bit
    pattern)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


# ---------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_safetensors_round_trip(tmp_path, dtype):
    tensors = {"a": _tensor(dtype), "scalar": _tensor(dtype, shape=()),
               "empty": _tensor(dtype, shape=(0, 4))}
    path = str(tmp_path / "t.safetensors")
    st.save_file(tensors, path, metadata={"k": "v"})
    back = st.load_file(path)
    assert set(back) == set(tensors)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape
        np.testing.assert_array_equal(_bits(back[k]), _bits(t))
    assert st.load_metadata(path) == {"k": "v"}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_safetensors_files_cross_between_packages(tmp_path, dtype):
    t = _tensor(dtype, seed=3)
    mine, theirs = str(tmp_path / "port.st"), str(tmp_path / "jax.st")
    st.save_file({"x": t}, mine)
    got = jax_st.load_file(mine)["x"]
    np.testing.assert_array_equal(_bits(got), _bits(t))
    arr = np.asarray(_bits(t))
    if dtype == "bf16":
        arr = arr.view(ml_dtypes.bfloat16)
    jax_st.save_file({"x": arr}, theirs)
    back = st.load_file(theirs)["x"]
    assert back.dtype == t.dtype
    np.testing.assert_array_equal(_bits(back), _bits(t))
    # the same bytes on disk either way
    assert open(mine, "rb").read() == open(theirs, "rb").read()


def test_truncated_file_raises_on_open(tmp_path):
    path = str(tmp_path / "t.st")
    st.save_file({"a": torch.zeros(64)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="truncated"):
        st.load_file(path)


def _tree():
    return {"params": {"blocks": {"attn": {"qkv": {"w": _tensor("f32"),
                                                   "b": _tensor("bf16")}}},
                       "ids": _tensor("int32"), "q": _tensor("int8")},
            "opt": {"count": 7, "lr": 0.25}, "epoch": 2}


def test_pytree_files_cross_between_packages_bitwise(tmp_path):
    tree = _tree()
    mine, theirs = str(tmp_path / "port.st"), str(tmp_path / "jax.st")
    save_pytree(mine, tree)
    assert "['params']['blocks']['attn']['qkv']['w']" in st.load_file(mine)
    jtemplate = jax.tree.map(lambda x: np.asarray(_bits(x))
                             if isinstance(x, torch.Tensor) else x, tree)
    got = dict(tree_leaves(jax_load_pytree(mine, jtemplate)))
    for path, a in tree_leaves(tree):
        np.testing.assert_array_equal(_bits(got[path]), _bits(a))

    def as_jax(x):
        if not isinstance(x, torch.Tensor):
            return x
        a = _bits(x)
        return jnp.asarray(a.view(ml_dtypes.bfloat16)
                           if x.dtype == torch.bfloat16 else a)

    jax_save_pytree(theirs, jax.tree.map(as_jax, tree))
    back = load_pytree(theirs, tree)
    assert back["opt"] == {"count": 7, "lr": 0.25} and back["epoch"] == 2
    for (pa, a), (pb, b) in zip(tree_leaves(tree), tree_leaves(back)):
        assert pa == pb
        if isinstance(a, torch.Tensor):
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(_bits(b), _bits(a))
    # without a template: nested dicts of tensors
    flat = load_pytree(mine)
    assert int(flat["opt"]["count"]) == 7
    assert torch.equal(flat["params"]["ids"], tree["params"]["ids"])
    assert keystr(("a", "b")) == "['a']['b']"


def test_jax_written_bf16_first_moment_loads_bitwise(tmp_path):
    """An optimizer state with a bf16 ``mu`` (after one update), written
    by the JAX package's ``save_pytree``, loads onto the port's template
    bitwise, ``mu`` as bf16 and ``nu`` as f32; a template that wants an
    f32 ``mu`` refuses it."""
    params = {"w": torch.randn(4, 6, generator=torch.Generator()
                               .manual_seed(0)), "b": torch.zeros(6)}
    opt = make_optimizer(Config.from_dict({"training": {
        "optimizer": "adamw", "adam_mu_dtype": "bfloat16"}}))
    state = opt.init(params)
    opt.update({(k,): torch.full_like(v, 0.3) for k, v in params.items()},
               state, params)
    path = str(tmp_path / "opt.st")

    def as_jax(x):
        if not isinstance(x, torch.Tensor):
            return x
        a = _bits(x)
        return jnp.asarray(a.view(ml_dtypes.bfloat16)
                           if x.dtype == torch.bfloat16 else a)

    jax_save_pytree(path, jax.tree.map(as_jax, state))
    back = load_pytree(path, opt.init(params))
    assert back["count"] == 1
    for key, dtype in (("mu", torch.bfloat16), ("nu", torch.float32)):
        for k, t in back[key].items():
            assert t.dtype == dtype
            np.testing.assert_array_equal(_bits(t), _bits(state[key][k]))
    with pytest.raises(ValueError, match="template wants"):
        load_pytree(path, make_optimizer(Config.from_dict({})).init(params))


def test_load_pytree_checks_the_template(tmp_path):
    path = str(tmp_path / "t.st")
    save_pytree(path, {"w": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="template wants"):
        load_pytree(path, {"w": torch.zeros(3, 2)})
    with pytest.raises(KeyError, match="not in the checkpoint"):
        load_pytree(path, {"v": torch.zeros(2, 3)})


# ---------------------------------------------------------------------
# the manager and the fallback
# ---------------------------------------------------------------------

def _state(v):
    return {"params": {"w": torch.full((4,), float(v))}, "epoch": v}


def _truncate(mgr, step):
    path = os.path.join(mgr.directory, str(step), "state.safetensors")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def test_manager_keeps_the_newest_and_never_overwrites(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s), cursor={"step": s})
    assert mgr.all_steps() == [2, 3, 4] and mgr.latest_step() == 4
    mgr.save(4, _state(40))                      # skipped: step exists
    assert float(mgr.restore()["params"]["w"][0]) == 4.0
    assert mgr.restore_cursor() == {"step": 4}
    mgr.save(4, _state(41), force=True)          # replaced, no cursor
    assert float(mgr.restore(step=4)["params"]["w"][0]) == 41.0
    assert mgr.restore_cursor(step=4) is None
    assert float(mgr.restore(step=2)["params"]["w"][0]) == 2.0
    assert mgr.step_bytes(4) > 0
    mgr.wait_until_finished()
    # a save killed before its rename leaves only a hidden directory: no
    # step lists it, and the next manager clears it
    os.makedirs(os.path.join(mgr.directory, ".tmp-9-dead"))
    assert mgr.all_steps() == [2, 3, 4]
    CheckpointManager(mgr.directory)
    assert not any(n.startswith(".tmp") for n in os.listdir(mgr.directory))


def test_restore_onto_a_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(5, {"params": {"w": torch.arange(4.0)}, "opt": {"count": 3},
                 "epoch": 1})
    template = {"params": {"w": torch.zeros(4)}, "opt": {"count": 0},
                "epoch": 0}
    got = mgr.restore(template)
    assert got["opt"]["count"] == 3 and isinstance(got["opt"]["count"], int)
    assert torch.equal(got["params"]["w"], torch.arange(4.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


@pytest.mark.parametrize("kind", ["truncated_state", "missing_cursor",
                                  "bad_cursor", "missing_state"])
def test_torn_step_raises_and_the_fallback_walks_past(tmp_path, kind):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    for s in (2, 4, 6):
        mgr.save(s, _state(s), cursor={"step": s})
    d = os.path.join(mgr.directory, "6")
    if kind == "truncated_state":
        _truncate(mgr, 6)
    elif kind == "missing_cursor":
        os.remove(os.path.join(d, "cursor.json"))
    elif kind == "bad_cursor":
        with open(os.path.join(d, "cursor.json"), "w") as f:
            f.write('{"step": ')
    else:
        os.remove(os.path.join(d, "state.safetensors"))
    with pytest.raises(CheckpointRestoreError) as ei:
        mgr.restore(step=6)
        mgr.restore_cursor(step=6)
    e = ei.value
    assert e.step == 6 and e.available == [4, 2]
    assert "Older steps exist: [4, 2]" in str(e)
    assert "restore_with_fallback" in str(e)
    logs = []
    state, cursor, step, skipped = restore_with_fallback(mgr,
                                                         log=logs.append)
    assert (step, skipped, cursor) == (4, [6], {"step": 4})
    assert float(state["params"]["w"][0]) == 4.0
    assert any("fallback" in m and "6" in m for m in logs)


def test_fallback_with_every_step_bad(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, _state(1))
    _truncate(mgr, 1)
    with pytest.raises(CheckpointRestoreError, match="all 1 step"):
        restore_with_fallback(mgr, log=lambda m: None)
    with pytest.raises(FileNotFoundError):
        restore_with_fallback(CheckpointManager(str(tmp_path / "none")))
    e = CheckpointRestoreError("d", 3, available=[], cause="x")
    assert "must re-init from scratch" in str(e)


# ---------------------------------------------------------------------
# cursor and cadence (tests/test_ft.py's cases)
# ---------------------------------------------------------------------

def test_cursor_roundtrip_json_exact():
    h = History(train_loss=[2.0, 1.5], val_loss=[1.8], val_metric=[0.5],
                wall_time_s=3.25, best_val_loss=1.8, best_epoch=0)
    c = TrainCursor(epoch=1, step_in_epoch=2, global_step=5,
                    loss_sum=2.5667000000000001, loss_count=2,
                    history=h, seed=7)
    back = TrainCursor.from_dict(json.loads(json.dumps(c.to_dict())))
    assert back == c
    assert TrainCursor.from_dict(None) is None
    d = c.to_dict()
    d["future_field"] = 1
    assert TrainCursor.from_dict(d) == c
    # a fresh History's best loss is inf: JSON carries it as Infinity
    fresh = TrainCursor(history=History())
    assert TrainCursor.from_dict(json.loads(json.dumps(
        fresh.to_dict()))) == fresh


def test_cadence_controller_or_combination():
    c = CadenceController(0, 0.0)
    assert not c.enabled and not c.should_save(10**6)
    c = CadenceController(3, 0.0)
    assert not c.should_save(2)
    assert c.should_save(3)
    c.saved(3)
    assert not c.should_save(5) and c.should_save(6)
    c = CadenceController(0, 10.0)
    assert c.enabled and not c.should_save(10**6)
    c._last_save_t -= 11
    assert c.should_save(1)


# ---------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------

class Killed(Exception):
    pass


SAMPLES, BATCH, EPOCHS = 48, 16, 2          # 3 steps an epoch, 6 in all


BF16_TRAINING = {"dtype": "bfloat16", "adam_mu_dtype": "bfloat16"}


def _model(name):
    if name == "gpt2_bf16":
        spec, train_fn, val_fn = _model("gpt2")
        return (gpt2_model_spec(GPT2Config.tiny(n_layer=2, resid_pdrop=0.1,
                                                embd_pdrop=0.1),
                                compute_dtype=torch.bfloat16),
                train_fn, val_fn)
    if name == "vit":
        spec = vit_model_spec(ViTConfig(depth=2, hidden_dim=16, num_heads=2,
                                        dropout=0.1))
        ds = ArrayDataset(*synthetic_mnist(SAMPLES, seed=0))
        val = ArrayDataset(*synthetic_mnist(16, seed=1))
        # map-style skip: the factory names its offset ``start``
        train_fn = (lambda ep, start=0: make_batches(ds, BATCH, seed=ep,
                                                     start_batch=start))
        return spec, train_fn, (lambda ep: make_batches(val, BATCH,
                                                        shuffle=False))
    spec = gpt2_model_spec(GPT2Config.tiny(n_layer=2, resid_pdrop=0.1,
                                           embd_pdrop=0.1))
    rows = np.random.default_rng(0).integers(0, 128, (SAMPLES + 16, 24))
    ds, val = PackedLMDataset(rows[:SAMPLES]), PackedLMDataset(rows[SAMPLES:])
    # a factory without an offset parameter: the trainer skips generically
    return (spec, lambda ep: ds.batches(BATCH, seed=ep),
            lambda ep: val.batches(BATCH, shuffle=False))


def _cfg(**training):
    t = {"batch_size": BATCH, "epochs": EPOCHS, "optimizer": "adamw",
         "learning_rate": 1e-3, "log_every": 0, "seed": 0,
         "gradient_accumulation_steps": 2, "grad_clip_norm": 1.0}
    t.update(training)
    return Config.from_dict({"training": t})


def _trainer(cfg, spec, ckpt=None, logs=None):
    return Trainer(cfg, spec, task_type="classification", device="cpu",
                   checkpoint_dir=ckpt,
                   log_fn=logs.append if logs is not None else lambda m: None)


def _killing(fn, after):
    """The factory ``fn``, raising ``Killed`` when the batch of global
    step ``after + 1`` is asked for (every step before it has landed and
    been saved if the cadence said so)."""
    count = {"n": 0}

    def wrap(*a, **kw):
        for b in fn(*a, **kw):
            if count["n"] == after:
                raise Killed
            count["n"] += 1
            yield b

    if "start" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        return lambda ep, start=0: wrap(ep, start)
    return lambda ep: wrap(ep)


def _assert_state_equal(a, b):
    (pa, oa), (pb, ob) = a, b
    for (ka, x), (kb, y) in zip(tree_leaves(pa), tree_leaves(pb)):
        assert ka == kb and torch.equal(x, y), ka
    assert oa["count"] == ob["count"]
    for key in ("mu", "nu"):
        for (ka, x), (_, y) in zip(tree_leaves(oa[key]),
                                   tree_leaves(ob[key])):
            assert torch.equal(x, y), (key, ka)


def _hist_fields(h):
    d = dataclasses.asdict(h)
    d.pop("wall_time_s")
    return d


CUTS = {
    # newest checkpoint: the step-5 cadence save, mid-epoch (epoch 1,
    # step 2): the resume replays step 6
    "vit_mid_epoch": ("vit", 5, (1, 2, 5), "auto"),
    "gpt2_mid_epoch": ("gpt2", 5, (1, 2, 5), "cursor"),
    # killed as epoch 1's first batch is asked for: the newest is the
    # epoch-0 boundary save at step 3
    "vit_boundary": ("vit", 3, (1, 0, 3), "cursor"),
    "gpt2_boundary": ("gpt2", 3, (1, 0, 3), "auto"),
    # bf16 compute and a bf16 first moment
    "gpt2_bf16_mid_epoch": ("gpt2_bf16", 5, (1, 2, 5), "cursor"),
}


@pytest.mark.parametrize("name", sorted(CUTS))
def test_kill_and_resume_is_bit_identical(tmp_path, name):
    model, kill_after, where, how = CUTS[name]
    spec, train_fn, val_fn = _model(model)
    extra = BF16_TRAINING if model.endswith("bf16") else {}
    ref = _trainer(_cfg(**extra), spec)
    hist_ref = ref.fit(train_fn, val_batches_fn=val_fn)

    ck = str(tmp_path / "ck")
    cfg = _cfg(save_every_steps=2, **extra)
    with pytest.raises(Killed):
        _trainer(cfg, spec, ck).fit(_killing(train_fn, kill_after),
                                    val_batches_fn=val_fn)
    logs = []
    t2 = _trainer(cfg, spec, ck, logs)
    if how == "auto":
        hist = t2.fit(train_fn, val_batches_fn=val_fn)
    else:
        params, opt_state, cursor = t2.resume_state()
        assert (cursor.epoch, cursor.step_in_epoch,
                cursor.global_step) == where
        hist = t2.fit(train_fn, val_batches_fn=val_fn, params=params,
                      opt_state=opt_state, cursor=cursor)
    assert any(f"continuing at epoch {where[0]} step {where[1]}" in m
               for m in logs), logs
    assert _hist_fields(hist) == _hist_fields(hist_ref)
    assert hist.wall_time_s > 0
    _assert_state_equal(t2.final_state, ref.final_state)
    mu_dtype = torch.bfloat16 if extra else torch.float32
    assert all(t.dtype == mu_dtype
               for _, t in tree_leaves(t2.final_state[1]["mu"]))
    # the last save is the run's end, at an epoch boundary
    mgr = CheckpointManager(ck)
    assert mgr.latest_step() == EPOCHS * SAMPLES // BATCH
    assert TrainCursor.from_dict(mgr.restore_cursor()).step_in_epoch == 0
    assert os.path.isdir(ck + "-best")


def test_torn_latest_step_resumes_from_the_previous_one(tmp_path):
    spec, train_fn, val_fn = _model("vit")
    ref = _trainer(_cfg(), spec)
    hist_ref = ref.fit(train_fn, val_batches_fn=val_fn)
    ck = str(tmp_path / "ck")
    cfg = _cfg(save_every_steps=2)
    with pytest.raises(Killed):
        _trainer(cfg, spec, ck).fit(_killing(train_fn, 5),
                                    val_batches_fn=val_fn)
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [2, 3, 5]
    _truncate(mgr, 5)
    logs = []
    t2 = _trainer(cfg, spec, ck, logs)
    hist = t2.fit(train_fn, val_batches_fn=val_fn)
    assert any("fallback" in m and "[5]" in m for m in logs), logs
    assert _hist_fields(hist) == _hist_fields(hist_ref)
    _assert_state_equal(t2.final_state, ref.final_state)
    # the replay rewrote the unreadable step
    assert float(CheckpointManager(ck).restore(step=5)["epoch"]) == 1


def test_resume_or_init_refuses_a_mid_epoch_checkpoint(tmp_path):
    spec, train_fn, _ = _model("vit")
    ck = str(tmp_path / "ck")
    cfg = _cfg(save_every_steps=2)
    with pytest.raises(Killed):
        _trainer(cfg, spec, ck).fit(_killing(train_fn, 2))
    with pytest.raises(RuntimeError, match="mid-epoch"):
        _trainer(cfg, spec, ck).resume_or_init()
    with pytest.raises(Killed):
        _trainer(_cfg(), spec, str(tmp_path / "b")).fit(
            _killing(train_fn, 3))
    params, opt_state, epoch = _trainer(_cfg(), spec,
                                        str(tmp_path / "b")).resume_or_init()
    assert epoch == 1 and opt_state["count"] == 3
    fresh = _trainer(_cfg(), spec, str(tmp_path / "none")).resume_or_init()
    assert fresh[2] == 0 and fresh[1]["count"] == 0


def test_epoch_indexed_save_resumes_at_the_next_epoch(tmp_path):
    spec, _, _ = _model("vit")
    tr = _trainer(_cfg(), spec, str(tmp_path / "ck"))
    params, opt_state = tr.init_state()
    tr.save(0, params, opt_state)
    params2, _, cursor = _trainer(_cfg(), spec,
                                  str(tmp_path / "ck")).resume_state()
    assert (cursor.epoch, cursor.step_in_epoch) == (1, 0)
    for (_, a), (_, b) in zip(tree_leaves(params), tree_leaves(params2)):
        assert torch.equal(a, b) and b.requires_grad


def test_changed_seed_refuses_to_resume(tmp_path):
    spec, train_fn, _ = _model("vit")
    ck = str(tmp_path / "ck")
    with pytest.raises(Killed):
        _trainer(_cfg(save_every_steps=2), spec, ck).fit(
            _killing(train_fn, 2))
    with pytest.raises(RuntimeError, match="training.seed"):
        _trainer(_cfg(seed=1), spec, ck).fit(train_fn)


def test_verify_vit_accuracy_equals_trainer_evaluate(tmp_path):
    from quintnet_tpu_torch.tools.verify_vit import verify_vit

    cfg_vit = ViTConfig(depth=2, hidden_dim=16, num_heads=2)
    spec = vit_model_spec(cfg_vit)
    train = ArrayDataset(*synthetic_mnist(64, seed=0))
    xte, yte = synthetic_mnist(48, seed=1)
    test = ArrayDataset(xte, yte)
    ck = str(tmp_path / "ck")
    tr = _trainer(_cfg(epochs=1, optimizer="adam",
                       gradient_accumulation_steps=1), spec, ck)
    hist = tr.fit(lambda ep: make_batches(train, 16, seed=ep),
                  val_batches_fn=lambda ep: make_batches(test, 16,
                                                         shuffle=False))
    ev = tr.evaluate(tr.final_state[0], make_batches(test, 16,
                                                     shuffle=False))
    res = verify_vit(ck, cfg_vit, data=(xte, yte), batch_size=16,
                     device="cpu")
    assert res["accuracy"] == ev["accuracy"] == hist.val_metric[-1]
    assert res["n_examples"] == 48 and res["epoch"] == 0
    np.testing.assert_allclose(res["loss"], ev["loss"], rtol=1e-6)
