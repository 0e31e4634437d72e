"""Sharded checkpoints on a mesh (``train/checkpoint.py``), on a gloo
world of 8 CPU ranks (dp x tp x pp = 2 x 2 x 2), against the JAX
package where it has a counterpart.

The counterparts of ``tests/test_checkpoint.py``'s sharded cases and of
``tests/test_fsdp.py``'s checkpoint case, plus what the port's own
design promises: a 3D save restored on the same mesh bit for bit (Adam's
sharded moments and ZeRO-1's per-rank chunks alike), the step's record
(``sharding.json``); the cross-mesh restore of
``test_orbax_cross_mesh_restore`` with no mesh (contents equal to JAX's
``vit_to_tp_layout``), and onto a dp = 8 mesh (the tp-blocked QKV
converted with the head count, refused without it, ZeRO chunks refused),
and with a template onto no mesh (tp = 1: converted, or refused, also to
a one-device Trainer's resume); the 3D ViT trained with checkpoints and
reloaded by ``verify_vit``, which reads the saved tp = 2 from the step
(``test_verify_vit_reload_matches_trainer_eval``'s bar: within 0.01 of
the trainer's val accuracy); a 3D ZeRO-1 GPT-2 run and an fsdp dp x tp
= 4 x 2 run cut after step 1 and resumed by a fresh Trainer equal to the
uncut run bit for bit, and step 1 restored with no mesh equal to the
uncut parameters after step 1; a truncated rank file making every rank
fall back to the same older step though only the ranks reading that
file fail; and a failed (on rank 5, or on rank 0 before or after the
others write) or killed save listing no step.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_dist import run_world
from _torch_dist_cases import CKPT_VIT, ckpt_world_case, pp_model
from quintnet_tpu.models.vit import ViTConfig as JaxViTConfig
from quintnet_tpu.models.vit import vit_init as jax_vit_init
from quintnet_tpu.models.vit import vit_to_tp_layout as jax_vit_tp_layout
from quintnet_tpu_torch.core.pytree import tree_leaves, tree_map
from quintnet_tpu_torch.data.datasets import synthetic_mnist
from quintnet_tpu_torch.models.vit import ViTConfig
from quintnet_tpu_torch.tools.verify_vit import verify_vit
from quintnet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 MeshMismatchError,
                                                 SHARDING_FILE, shard_file)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield ".".join(prefix), np.asarray(tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckmesh")
    dirs = {name: str(root / name) for name in (
        "adam", "zero1_adam", "elsewhere", "vit", "3d", "fsdp", "failed")}
    vit = jax.tree.map(np.asarray, jax_vit_init(jax.random.key(0),
                                                JaxViTConfig(**CKPT_VIT)))
    xtr, ytr = synthetic_mnist(256, seed=0)
    xte, yte = synthetic_mnist(128, seed=1)
    data = (xtr[:, 7:21, 7:21, :], ytr, xte[:, 7:21, 7:21, :], yte)
    rng = np.random.default_rng(7)
    batches = [(ids, ids) for ids in (rng.integers(0, 128, (8, 16))
                                      for _ in range(2))]
    ranks = run_world(ckpt_world_case, 8, root, vit, data, batches, dirs,
                      timeout=300)
    return {"ranks": ranks, "dirs": dirs, "vit": vit, "data": data}


@pytest.mark.parametrize("optimizer", ["adam", "zero1_adam"])
def test_sharded_round_trip_on_the_3d_mesh(world, optimizer):
    for r in world["ranks"]:
        got = r["round_trip"][optimizer]
        assert got["steps"] == [0, 5]                 # max_to_keep=2
        assert got["equal"] and got["count_type"] == "int"
    d = os.path.join(world["dirs"][optimizer], "5")
    assert sorted(os.listdir(d)) == sorted(
        [SHARDING_FILE] + [shard_file(r) for r in range(8)])
    with open(os.path.join(d, SHARDING_FILE)) as f:
        rec = json.load(f)
    assert rec["mesh"] == {"names": ["dp", "tp", "pp"], "sizes": [2, 2, 2]}
    assert rec["strategy"] == "3d" and rec["cursor"] is False
    leaves = rec["leaves"]
    qkv = leaves["['params']['blocks']['attn']['qkv']['w']"]
    assert qkv["spec"] == ["pp", None, "tp"] and not qkv["chunk"]
    assert qkv["shape"] == [4, 16, 48]                # global, saved layout
    mu = leaves["['opt']['mu']"] if optimizer == "zero1_adam" else \
        leaves["['opt']['mu']['blocks']['attn']['qkv']['w']"]
    assert mu["chunk"] == (optimizer == "zero1_adam")


def test_cross_mesh_restore_without_a_mesh_matches_jax(world):
    """``test_orbax_cross_mesh_restore``: the 3D (tp = 2) save restored in
    one process with no mesh is the whole host tree in the tp-blocked
    layout, JAX's ``vit_to_tp_layout(host, cfg, 2)``."""
    got = CheckpointManager(world["dirs"]["adam"]).restore()["params"]
    want = dict(_flat(jax_vit_tp_layout(world["vit"],
                                        JaxViTConfig(**CKPT_VIT), 2)))
    have = {".".join(k): v.numpy() for k, v in tree_leaves(got)}
    assert set(have) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(have[k], w, err_msg=k)


def test_restore_onto_another_mesh(world):
    """Onto dp = 8 (tp = 1): with the head count the QKV comes back in
    the standard layout; without it, and for ZeRO chunks, the refusal
    names both meshes."""
    want = dict(_flat(world["vit"]))
    for r in world["ranks"]:
        out = r["elsewhere"]
        for k, w in want.items():
            np.testing.assert_array_equal(out["params"][k], w, err_msg=k)
        assert "{'dp': 2, 'tp': 2, 'pp': 2}" in out["no_heads"]
        assert "{'dp': 8}" in out["no_heads"] and "num_heads" in \
            out["no_heads"]
        assert "per-rank chunk" in out["chunks"]
        assert "{'dp': 8}" in out["chunks"]


def test_template_restore_without_a_mesh_undoes_or_refuses_tp(world):
    """A tp = 2 step restored with a template in one process with no mesh
    (tp = 1): with the head count the QKV and its Adam moments come back
    in the standard layout; without it, as a one-device Trainer resuming
    the 3D ViT run has none, ``MeshMismatchError`` names both meshes
    instead of handing back a scrambled attention."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.parallel.tp import qkv_standard_from_blocked
    from quintnet_tpu_torch.train.trainer import Trainer

    mgr = CheckpointManager(world["dirs"]["adam"])
    whole = mgr.restore()
    template = tree_map(torch.zeros_like, whole)
    got = mgr.restore(template, num_heads=CKPT_VIT["num_heads"])
    have = {".".join(k): v.numpy() for k, v in tree_leaves(got["params"])}
    for k, w in _flat(world["vit"]):
        np.testing.assert_array_equal(have[k], w, err_msg=k)
    for m in ("mu", "nu"):
        qkv = whole["opt"][m]["blocks"]["attn"]["qkv"]
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(
                got["opt"][m]["blocks"]["attn"]["qkv"][leaf].numpy(),
                qkv_standard_from_blocked(qkv[leaf], CKPT_VIT["num_heads"],
                                          2).numpy(), err_msg=(m, leaf))
    with pytest.raises(MeshMismatchError, match=r"num_heads"):
        mgr.restore(template)
    one = Trainer(Config.from_dict({"training": {"optimizer": "adam"}}),
                  pp_model("vit", CKPT_VIT), task_type="classification",
                  checkpoint_dir=world["dirs"]["vit"], device="cpu",
                  log_fn=lambda m: None)
    with pytest.raises(MeshMismatchError) as ei:
        one.resume_state()
    assert "{'dp': 2, 'tp': 2, 'pp': 2}" in str(ei.value)
    assert "no mesh (one process) has tp=1" in str(ei.value)


def test_verify_vit_reload_matches_trainer_eval(world):
    """Train sharded (3D) with checkpoints, reload on one device with no
    mesh code and the tp = 2 layout undone: the accuracy the trainer
    reported."""
    reported = world["ranks"][0]["val_accuracy"]
    assert {r["val_accuracy"] for r in world["ranks"]} == {reported}
    _, _, xte, yte = world["data"]
    res = verify_vit(world["dirs"]["vit"], ViTConfig(**CKPT_VIT),
                     data=(xte, yte), batch_size=32, device="cpu")
    assert res["epoch"] == 0 and res["n_examples"] == 128
    assert abs(res["accuracy"] - reported) <= 0.01, (res, reported)


@pytest.mark.parametrize("run", ["3d", "fsdp"])
def test_cut_and_resumed_run_equals_the_uncut_run(world, run):
    """Cut after step 1 and resumed by a fresh Trainer: every parameter,
    this rank's moments (ZeRO-1 chunks; fsdp's sharded leaves) and the
    History equal the uncut run's bit for bit; step 1 restored with no
    mesh equals the uncut parameters after step 1 (the tp-blocked
    layout)."""
    for r in world["ranks"]:
        out = r[run]
        (p_u, mu_u, nu_u, h_u), (p_r, mu_r, nu_r, h_r) = (out["uncut"],
                                                           out["resumed"])
        assert h_r == h_u and len(h_u) == 2
        for got, want in ((p_r, p_u), (mu_r, mu_u), (nu_r, nu_u)):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert out["steps"] == [1, 2]
    mgr = CheckpointManager(world["dirs"][run])
    rec = mgr.sharding(1)
    assert rec["fsdp"] == (run == "fsdp")
    assert rec["zero_stage"] == (1 if run == "3d" else 0)
    got = {".".join(k): v.numpy()
           for k, v in tree_leaves(mgr.restore(step=1)["params"])}
    after1 = world["ranks"][0][run]["after1"]
    assert set(got) == set(after1)
    for k, w in after1.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_truncated_rank_file_makes_the_world_fall_back(world):
    """Rank 3's file of the newest step cut in half: only the ranks that
    read it (3 and 7, the same tp and pp coordinates) fail their own
    read, yet every rank resumes from the same older step."""
    outs = [r["truncated"] for r in world["ranks"]]
    newest = outs[0]["newest"]
    assert [o["own_read_failed"] for o in outs] == [
        r in (3, 7) for r in range(8)]
    for o in outs:
        assert o["resumed_at"] == newest - 1
        assert o["bad_steps"] == [newest]


def test_failed_or_killed_save_lists_no_step(world):
    """Rank 5 failing to write its part, or rank 0 failing to make the
    step's directory or to rename it: every rank raises (none waits in a
    collective its peers left) and nothing is listed or left."""
    for r, rank in enumerate(world["ranks"]):
        out = rank["failed_save"]
        assert out["raised"] is not None
        assert ("injected" in out["raised"]) == (r == 5)
        assert out["listed"] == [] and out["left"] == []
        for name in ("_tmp_dir", "_commit"):
            raised, listed, left = out["rank0"][name]
            assert raised is not None, name
            assert ("injected" in raised) == (r == 0), (name, raised)
            assert listed == [] and left == [], name
        assert out["listed_killed"] == []
    assert world["ranks"][0]["failed_save"]["after_clean"] == []
