"""Fault tolerance in the port: a killed and resumed run is bit-identical
to an uninterrupted one, on the CPU.

The 19 test functions of the JAX package's ``tests/test_ft.py`` on the
same tiny ViT (``VCFG``, 48 samples, batch 16, 2 epochs: 3 steps an
epoch, 6 in all). Kill modes: an in-process hard kill (``ChaosKilled``),
a real SIGTERM turned into a preemption (emergency snapshot), and a
damaged checkpoint with fallback to the previous good step. Within the
port every comparison is exact. Across the packages, from the same numpy
weights and the same kill, each epoch's loss agrees within 1e-5; the
goodput ``aggregate`` of the same attempt records, the cadence's
decisions and a cursor's JSON are equal. The JAX 2-axis case is one
2-rank gloo world (dp x tp = 1 x 2), where a SIGTERM that reaches rank 1
alone stops both ranks at the same global step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_world
from _torch_ft_cases import ft_world_case
from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.ft import ChaosMonkey as JaxChaosMonkey
from quintnet_tpu.ft import FTContext as JaxFTContext
from quintnet_tpu.ft import TrainCursor as JaxTrainCursor
from quintnet_tpu.ft.goodput import aggregate as jax_aggregate
from quintnet_tpu.ft.preempt import CadenceController as JaxCadence
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.models.vit import vit_model_spec as jax_vit_model_spec
from quintnet_tpu.train.checkpoint import save_pytree as jax_save_pytree
from quintnet_tpu.train.trainer import History as JaxHistory
from quintnet_tpu.train.trainer import Trainer as JaxTrainer
from quintnet_tpu_torch.bridge import vit_params_from_numpy
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
from quintnet_tpu_torch.data import ArrayDataset, make_batches
from quintnet_tpu_torch.data.datasets import skip_batches, synthetic_mnist
from quintnet_tpu_torch.ft import (ChaosKilled, ChaosMonkey, FTContext,
                                   GoodputMeter, PreemptionHandler,
                                   TrainCursor, TrainingPreempted,
                                   corrupt_checkpoint)
from quintnet_tpu_torch.ft.goodput import aggregate
from quintnet_tpu_torch.ft.preempt import CadenceController
from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec
from quintnet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 CheckpointRestoreError)
from quintnet_tpu_torch.train.trainer import History, Trainer

torch.set_num_threads(1)

VCFG = dict(image_size=28, patch_size=7, in_channels=1, hidden_dim=16,
            depth=2, num_heads=2, num_classes=10)

# 48 samples / batch 16 = 3 steps an epoch; 2 epochs = 6 global steps.
SAMPLES, BATCH, EPOCHS = 48, 16, 2
# JAX and the port from the same weights: each epoch's mean loss
LOSS_ATOL = 1e-5


def _cfg(**training):
    t = {"batch_size": BATCH, "epochs": EPOCHS, "optimizer": "adam",
         "learning_rate": 1e-3, "log_every": 0, "seed": 0}
    t.update(training)
    return Config.from_dict({"training": t})


def _dataset():
    return ArrayDataset(*synthetic_mnist(SAMPLES, seed=0))


def _batches_fn(ds):
    # map-style skip to the cursor: start_batch slices the shuffled index
    return lambda ep, start=0: make_batches(ds, BATCH, seed=ep,
                                            start_batch=start)


def _trainer(cfg, ckpt_dir, logs=None):
    log = logs.append if logs is not None else (lambda s: None)
    return Trainer(cfg, vit_model_spec(ViTConfig(**VCFG)),
                   task_type="classification", checkpoint_dir=ckpt_dir,
                   log_fn=log, device="cpu")


def _assert_trees_equal(a, b):
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    assert la.keys() == lb.keys()
    for k, x in la.items():
        assert torch.equal(x, lb[k]), k


def test_kill_resume_bit_identical_single_device(tmp_path):
    """Uninterrupted against kill-after-step-6 and a mid-epoch resume from
    the step-5 cadence checkpoint: params and losses bit-identical."""
    ds = _dataset()
    bf = _batches_fn(ds)
    t_ref = _trainer(_cfg(), None)
    hist_ref = t_ref.fit(bf)

    # saves land at global steps 2, 3 (epoch end) and 5; the kill after 6
    # fires before the epoch-end save, so the newest checkpoint is the
    # mid-epoch cursor (epoch 1, step 2): the resume replays step 6
    ck = str(tmp_path / "ck")
    cfg = _cfg(save_every_steps=2)
    with pytest.raises(ChaosKilled):
        _trainer(cfg, ck).fit(bf, ft=FTContext(
            chaos=ChaosMonkey(kill_at_step=6, mode="raise")))

    logs = []
    t2 = _trainer(cfg, ck, logs)
    hist = t2.fit(bf)
    assert any("continuing at epoch 1 step 2" in s for s in logs), logs
    assert hist.train_loss == hist_ref.train_loss
    assert hist.val_loss == hist_ref.val_loss
    _assert_trees_equal(t2.final_state[0], t_ref.final_state[0])


def test_kill_resume_bit_identical_2axis_mesh(tmp_path):
    """One 2-rank gloo world (dp x tp = 1 x 2): the killed and resumed
    run equals the uncut run on every rank, and a SIGTERM that reaches
    rank 1 alone after step 4 stops both ranks at global step 4 with one
    emergency step on disk, from which the run resumes bit-exact."""
    ranks = run_world(ft_world_case, 2, tmp_path, str(tmp_path / "ck"),
                      timeout=240)
    for rank, r in enumerate(ranks):
        assert r["kill"]["equal"], rank
        assert r["kill"]["losses"] == r["kill"]["ref_losses"]
        pre = r["preempt"]
        assert pre["signalled"] == (rank == 1)
        assert pre["stopped"] == (1, 1, 4)
        # epoch 0's end, then the emergency step
        assert pre["steps_on_disk"] == [3, 4]
        assert pre["equal"], rank
        assert pre["losses"] == r["kill"]["ref_losses"]
    assert ranks[0]["kill"]["losses"] == ranks[1]["kill"]["losses"]


def test_sigterm_preemption_emergency_snapshot_and_resume(tmp_path):
    """SIGTERM (sent to this process by the chaos monkey) sets the
    handler's flag, the loop finishes the in-flight step, writes one
    synchronous emergency snapshot and raises TrainingPreempted; the
    resumed run is bit-identical to an uninterrupted one and the
    restored History keeps the epochs before the stop."""
    ds = _dataset()
    bf = _batches_fn(ds)
    t_ref = _trainer(_cfg(), None)
    hist_ref = t_ref.fit(bf)

    ck = str(tmp_path / "ck")
    cfg = _cfg()      # no cadence: only the emergency snapshot
    meter = GoodputMeter()
    with PreemptionHandler() as handler:
        ft = FTContext(preemption=handler,
                       chaos=ChaosMonkey(kill_at_step=4, mode="sigterm"),
                       goodput=meter)
        with pytest.raises(TrainingPreempted) as ei:
            _trainer(cfg, ck).fit(bf, ft=ft)
    # preempted after global step 4 = epoch 1 step 1 (mid-epoch)
    assert (ei.value.epoch, ei.value.step_in_epoch) == (1, 1)
    assert ei.value.global_step == 4
    rep = meter.report(completed=False)
    assert rep["steps_run"] == 4 and rep["reached"] == 4
    assert rep["save_blocking_s"] > 0   # the emergency save is synchronous
    assert CheckpointManager(ck).all_steps() == [3, 4]

    t2 = _trainer(cfg, ck)
    hist = t2.fit(bf)
    assert hist.train_loss == hist_ref.train_loss
    _assert_trees_equal(t2.final_state[0], t_ref.final_state[0])

    # the jsonl written after the resume holds the whole run, epoch 0
    # included, and the wall time adds up over both attempts
    p = str(tmp_path / "hist.jsonl")
    hist.to_jsonl(p)
    rows = [json.loads(line) for line in open(p)]
    assert [r["epoch"] for r in rows[:-1]] == list(range(EPOCHS))
    assert rows[-1]["wall_time_s"] == pytest.approx(hist.wall_time_s,
                                                    abs=0.01)
    assert hist.wall_time_s > 0


def test_corrupt_latest_falls_back_to_previous_good_step(tmp_path):
    """Truncate the newest checkpoint: resume falls back one cadence
    interval and still reaches the bit-identical final state."""
    ds = _dataset()
    bf = _batches_fn(ds)
    ck = str(tmp_path / "ck")
    cfg = _cfg(save_every_steps=2)
    t_ref = _trainer(cfg, ck)
    hist_ref = t_ref.fit(bf)

    steps = CheckpointManager(ck).all_steps()
    assert len(steps) >= 2
    bad = steps[-1]
    corrupt_checkpoint(ck, bad, kind="truncate")

    logs = []
    t2 = _trainer(cfg, ck, logs)
    _params, _opt, cursor = t2.resume_state()
    assert cursor is not None
    assert t2._last_ckpt_step == steps[-2]
    assert cursor.global_step == steps[-2]
    assert any("fallback" in s and str(bad) in s for s in logs), logs

    t3 = _trainer(cfg, ck)
    hist = t3.fit(bf)
    assert hist.train_loss == hist_ref.train_loss
    _assert_trees_equal(t3.final_state[0], t_ref.final_state[0])


def test_corrupt_step_rewritten_on_replay(tmp_path):
    """A step the fallback proved unreadable is rewritten when the replay
    reaches it again, or the damaged copy would shadow every later save
    at that step."""
    ds = _dataset()
    bf = _batches_fn(ds)
    ck = str(tmp_path / "ck")
    cfg = _cfg(save_every_steps=2)
    _trainer(cfg, ck).fit(bf)
    bad = CheckpointManager(ck).latest_step()     # the final boundary save
    corrupt_checkpoint(ck, bad, kind="truncate")

    logs = []
    t2 = _trainer(cfg, ck, logs)
    t2.fit(bf)        # falls back one interval, replays through `bad`
    t2.wait_for_saves()
    assert any("fallback" in s for s in logs), logs

    mgr = CheckpointManager(ck)
    assert mgr.latest_step() == bad
    state = mgr.restore()         # the damaged copy was replaced
    assert set(state) >= {"params", "opt", "epoch"}
    assert mgr.restore_cursor()["step_in_epoch"] == 0


def test_cadence_on_epoch_final_batch_heals_to_boundary_cursor(tmp_path):
    """A cadence that divides the epoch lands each save on the epoch's
    last batch, at the step of the epoch-end save: the boundary save
    rewrites the mid-epoch cursor, so the newest cursor is a boundary and
    resume_or_init accepts the directory."""
    ds = _dataset()
    ck = str(tmp_path / "ck")
    cfg = _cfg(save_every_steps=3)            # == steps per epoch
    hist = _trainer(cfg, ck).fit(_batches_fn(ds))

    cur = CheckpointManager(ck).restore_cursor()
    assert (cur["epoch"], cur["step_in_epoch"]) == (EPOCHS, 0)
    assert cur["history"]["train_loss"] == hist.train_loss
    _p, _o, start_epoch = _trainer(cfg, ck).resume_or_init()
    assert start_epoch == EPOCHS


def test_preemption_handler_requires_checkpoint_dir():
    """Exit 75 means "snapshot saved, relaunch me": a trainer with nowhere
    to write the snapshot refuses the contract up front."""
    t = _trainer(_cfg(), None)
    with PreemptionHandler() as handler:
        with pytest.raises(ValueError, match="checkpoint_dir"):
            t.fit(_batches_fn(_dataset()), ft=FTContext(preemption=handler))


def test_restore_error_names_step_and_fallback(tmp_path):
    """Restoring a torn step raises a CheckpointRestoreError naming the
    step and the steps to fall back to, and the named step loads."""
    ck = str(tmp_path / "ck")
    _trainer(_cfg(save_every_steps=2), ck).fit(_batches_fn(_dataset()))

    mgr = CheckpointManager(ck)
    steps = mgr.all_steps()
    corrupt_checkpoint(ck, steps[-1], kind="truncate")
    with pytest.raises(CheckpointRestoreError) as ei:
        mgr.restore()
    err = ei.value
    assert err.step == steps[-1]
    assert err.available[0] == steps[-2]
    assert str(steps[-2]) in str(err) and "restore_with_fallback" in str(err)
    state = mgr.restore(step=err.available[0])
    assert set(state) >= {"params", "opt", "epoch"}


def test_injected_restore_failures_walk_the_fallback_chain(tmp_path):
    """``fail_restores=N`` fails the first N restore attempts without
    touching the disk, through the chaos hook: resume lands N steps back,
    and the hook runs once per attempt."""
    ck = str(tmp_path / "ck")
    cfg = _cfg(save_every_steps=2)
    _trainer(cfg, ck).fit(_batches_fn(_dataset()))
    steps = CheckpointManager(ck).all_steps()
    assert len(steps) >= 2

    chaos = ChaosMonkey(fail_restores=1)
    meter = GoodputMeter()
    _p, _o, cursor = _trainer(cfg, ck).resume_state(chaos=chaos,
                                                    goodput=meter)
    assert cursor.global_step == steps[-2]
    assert chaos.restore_failures_injected == 1
    rep = meter.report(completed=False)
    assert rep["resumed_at"] == steps[-2] and rep["fallback_steps"] == 1


def test_pre_ft_single_item_checkpoint_still_restores(tmp_path):
    """A step written by another writer as one state file with no cursor
    (here the JAX package's ``save_pytree``, a file the port's reader
    takes) restores: resume degrades to epoch granularity."""
    cfg = _cfg()
    params, opt = _trainer(cfg, str(tmp_path / "ck")).init_state()
    state = {"params": params, "opt": opt, "epoch": 2}
    step_dir = tmp_path / "ck" / "2"
    step_dir.mkdir(parents=True)
    jax_save_pytree(str(step_dir / "state.safetensors"), tree_map(
        lambda t: t.detach().numpy() if torch.is_tensor(t) else np.asarray(t),
        state))

    t2 = _trainer(cfg, str(tmp_path / "ck"))
    _p, _o, cursor = t2.resume_state()
    assert (cursor.epoch, cursor.step_in_epoch) == (3, 0)
    assert cursor.global_step == 2          # anchored at the step's index
    _assert_trees_equal(_p, params)
    assert int(CheckpointManager(str(tmp_path / "ck")).restore()["epoch"]) == 2


def test_preemption_during_eval_honored_at_epoch_boundary(tmp_path):
    """A SIGTERM that lands during evaluate() (the per-step poll cannot
    see it) does not start the next epoch: the epoch-end checkpoint is
    made durable and TrainingPreempted carries the boundary cursor."""
    ds = _dataset()
    ck = str(tmp_path / "ck")
    with PreemptionHandler() as handler:
        def val_fn(ep):
            handler.request()      # the "signal" arrives in epoch 0's eval
            return make_batches(ds, BATCH, seed=100 + ep, shuffle=False)

        with pytest.raises(TrainingPreempted) as ei:
            _trainer(_cfg(), ck).fit(_batches_fn(ds), val_batches_fn=val_fn,
                                     ft=FTContext(preemption=handler))
    assert (ei.value.epoch, ei.value.step_in_epoch) == (1, 0)
    _p, _o, cursor = _trainer(_cfg(), ck).resume_state()
    assert (cursor.epoch, cursor.step_in_epoch) == (1, 0)


def test_resume_or_init_refuses_mid_epoch_checkpoint(tmp_path):
    """An epoch-level loop is never handed mid-epoch params as an epoch
    boundary; resume_or_init raises and points at fit/resume_state."""
    ds = _dataset()
    ck = str(tmp_path / "ck")
    cfg = _cfg(save_every_steps=2)
    with pytest.raises(ChaosKilled):
        _trainer(cfg, ck).fit(_batches_fn(ds), ft=FTContext(
            chaos=ChaosMonkey(kill_at_step=6, mode="raise")))
    with pytest.raises(RuntimeError, match="mid-epoch.*resume_state"):
        _trainer(cfg, ck).resume_or_init()
    hist = _trainer(cfg, ck).fit(_batches_fn(ds))
    assert len(hist.train_loss) == EPOCHS


def test_legacy_epoch_indexed_checkpoint_degrades_cleanly(tmp_path):
    """A cursor-less, epoch-indexed save resumes at epoch granularity with
    global_step anchored at its index, so a save one step into the
    resumed run (an emergency snapshot) is not dropped."""
    ck = str(tmp_path / "ck")
    cfg = _cfg()
    t1 = _trainer(cfg, ck)
    params, opt = t1.init_state()
    t1.save(3, params, opt)

    t2 = _trainer(cfg, ck)
    _p, _o, cursor = t2.resume_state()
    assert (cursor.epoch, cursor.step_in_epoch) == (4, 0)
    assert cursor.global_step == 3
    assert t2._last_ckpt_step == 3
    cursor.global_step += 1
    cursor.step_in_epoch = 1
    assert t2.save_state(_p, _o, cursor) > 0
    assert CheckpointManager(ck).latest_step() == 4


def test_batches_fn_signature_variants():
    """The resume offset reaches only parameters named start/start_batch
    (second positional, or keyword-only)."""
    from quintnet_tpu_torch.train.trainer import _call_batches_fn

    calls = []
    res = _call_batches_fn(lambda ep, start: calls.append((ep, start)), 1, 2)
    assert res[1] is True and calls == [(1, 2)]
    res = _call_batches_fn(lambda ep, start: calls.append((ep, start)), 1, 0)
    assert res[1] is True and calls[-1] == (1, 0)

    def kw_only(ep, *, start_batch=0):
        calls.append(("kw", ep, start_batch))
    assert _call_batches_fn(kw_only, 2, 3)[1] is True
    assert calls[-1] == ("kw", 2, 3)

    def unrelated(ep, shuffle=True):
        calls.append(("un", ep, shuffle))
    assert _call_batches_fn(unrelated, 4, 2)[1] is False
    assert calls[-1] == ("un", 4, True)

    assert _call_batches_fn(lambda ep: calls.append(ep), 6, 7)[1] is False
    assert calls[-1] == 6


GOODPUT_ATTEMPTS = [
    [{"resumed_at": 0, "reached": 11, "steps_run": 11, "wall_s": 0.0,
      "save_blocking_s": 0.0, "restore_s": 0.0, "fallback_steps": 0,
      "completed": False, "synthetic": True}],
    [{"resumed_at": 0, "reached": 11, "steps_run": 11, "wall_s": 0.0,
      "save_blocking_s": 0.0, "restore_s": 0.0, "fallback_steps": 0,
      "completed": False, "synthetic": True},
     {"resumed_at": 10, "reached": 12, "steps_run": 2, "wall_s": 4.0,
      "save_blocking_s": 1.0, "restore_s": 0.5, "fallback_steps": 0,
      "completed": True}],
    [{"resumed_at": 0, "reached": 4, "steps_run": 4, "wall_s": 3.25,
      "save_blocking_s": 0.125, "restore_s": 0.0, "fallback_steps": 0,
      "completed": False},
     {"resumed_at": 4, "reached": 6, "steps_run": 2, "wall_s": 1.75,
      "save_blocking_s": 0.25, "restore_s": 0.0625, "fallback_steps": 1,
      "completed": True}],
]


def test_goodput_aggregate_incomplete_run_counts_only_checkpointed():
    """A run that never completed: useful steps stop at the last
    checkpointed step. The same attempt records give JAX's record, key
    for key."""
    g = aggregate(GOODPUT_ATTEMPTS[0], wall_s=10.0, final_step=10)
    assert g["useful_steps"] == 10 and g["lost_steps"] == 1
    g = aggregate(GOODPUT_ATTEMPTS[1], wall_s=10.0, final_step=10)
    assert g["useful_steps"] == 12 and g["lost_steps"] == 1
    for attempts in GOODPUT_ATTEMPTS:
        for kw in ({"wall_s": 10.0, "final_step": 10}, {"wall_s": 7.5},
                   {"wall_s": 0.0}):
            assert aggregate(attempts, **kw) == jax_aggregate(attempts, **kw)


def test_cursor_roundtrip_json_exact():
    """The cursor's JSON round trip is exact, and its JSON is JAX's
    cursor's, key for key."""
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
    jc = JaxTrainCursor(epoch=1, step_in_epoch=2, global_step=5,
                        loss_sum=2.5667000000000001, loss_count=2,
                        history=JaxHistory(
                            train_loss=[2.0, 1.5], val_loss=[1.8],
                            val_metric=[0.5], wall_time_s=3.25,
                            best_val_loss=1.8, best_epoch=0), seed=7)
    assert json.dumps(c.to_dict(), sort_keys=True) == json.dumps(
        jc.to_dict(), sort_keys=True)
    assert TrainCursor.from_dict(jc.to_dict()) == c


def test_cadence_controller_or_combination():
    """The step and time legs, OR-combined, decide as JAX's controller
    decides on the same sequence."""
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
    for every in (0, 1, 2, 3, 5):
        ours, theirs = CadenceController(every), JaxCadence(every)
        for step in range(1, 13):
            a, b = ours.should_save(step), theirs.should_save(step)
            assert a == b, (every, step)
            if a:
                ours.saved(step)
                theirs.saved(step)


def test_chaos_from_env():
    env = {"QT_CHAOS": json.dumps({"kill_at_step": 7, "mode": "sigterm",
                                   "fail_restores": 2})}
    m = ChaosMonkey.from_env(env)
    assert (m.kill_at_step, m.mode, m.fail_restores) == (7, "sigterm", 2)
    assert ChaosMonkey.from_env({}) is None


def test_start_batch_matches_generic_skip():
    """The map-style start_batch= slice and the generic skip give the same
    remaining batches; skipping past the end fails loudly."""
    ds = _dataset()
    a = list(make_batches(ds, BATCH, seed=3, start_batch=2))
    b = list(skip_batches(make_batches(ds, BATCH, seed=3), 2))
    assert len(a) == len(b) == 1
    np.testing.assert_array_equal(a[0][0], b[0][0])
    np.testing.assert_array_equal(a[0][1], b[0][1])
    assert list(skip_batches(make_batches(ds, BATCH, seed=3), 3)) == []
    with pytest.raises(ValueError, match="ended after 3"):
        skip_batches(make_batches(ds, BATCH, seed=3), 9)


# ---------------------------------------------------------------------
# across the packages: the same weights, the same kill
# ---------------------------------------------------------------------

def test_kill_and_resume_epoch_losses_match_jax(tmp_path):
    """From the same numpy weights, JAX's trainer and the port's each take
    the same 6 steps, killed after step 4 (cadence every 2 steps) and
    resumed by a fresh trainer: each epoch's loss agrees within
    ``LOSS_ATOL``, and the port's resumed run is bit-identical to its
    uncut run."""
    np_params = jax.tree.map(np.asarray, jax_vit_init(
        jax.random.key(3), JaxViTConfig(**VCFG)))
    ds = _dataset()
    bf = _batches_fn(ds)
    training = {"batch_size": BATCH, "epochs": EPOCHS, "optimizer": "adam",
                "learning_rate": 1e-3, "log_every": 0, "seed": 0,
                "save_every_steps": 2}

    jcfg = JaxConfig.from_dict({"mesh_dim": [1], "mesh_name": ["dp"],
                                "training": training})
    jspec = jax_vit_model_spec(JaxViTConfig(**VCFG))
    jck = str(tmp_path / "jax")
    j1 = JaxTrainer(jcfg, jspec, checkpoint_dir=jck, log_fn=lambda m: None)
    jp = jax.tree.map(jnp.asarray, np_params)
    with pytest.raises(Exception, match="chaos kill after global step 4"):
        j1.fit(bf, params=jp, opt_state=j1.optimizer.init(jp),
               ft=JaxFTContext(chaos=JaxChaosMonkey(kill_at_step=4,
                                                    mode="raise")))
    j1.wait_for_saves()
    want = JaxTrainer(jcfg, jspec, checkpoint_dir=jck,
                      log_fn=lambda m: None).fit(bf).train_loss

    def port_params():
        return tree_map(lambda t: t.requires_grad_(True),
                        vit_params_from_numpy(np_params, "cpu"))

    cfg = Config.from_dict({"training": training})
    ref = _trainer(cfg, None)
    p = port_params()
    hist_ref = ref.fit(bf, params=p, opt_state=ref.optimizer.init(p))
    ck = str(tmp_path / "port")
    t1 = _trainer(cfg, ck)
    p = port_params()
    with pytest.raises(ChaosKilled):
        t1.fit(bf, params=p, opt_state=t1.optimizer.init(p),
               ft=FTContext(chaos=ChaosMonkey(kill_at_step=4, mode="raise")))
    t2 = _trainer(cfg, ck)
    got = t2.fit(bf).train_loss

    assert got == hist_ref.train_loss
    _assert_trees_equal(t2.final_state[0], ref.final_state[0])
    assert len(got) == len(want) == EPOCHS
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
