"""``chip_smoke.py``'s profiler-window helpers on the CPU, with stand-in
profiles: a launch record without a device record (matched by
correlation id) is a lost record; a window is profiled again only when
a gated kernel came short beside lost records, at most
``PROFILED_WINDOWS`` windows, and the gate then counts in the window
returned."""

import types

import pytest
import torch

import chip_smoke

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _event(name, device_type, cid, parent=None):
    return types.SimpleNamespace(
        name=name, device_type=device_type, id=cid,
        cpu_parent=None if parent is None else types.SimpleNamespace(
            name=parent),
        self_device_time_total=1.0)


def _window(kernels, lost=()):
    """A profile whose launches of ``kernels`` (symbol -> count) all have
    device records, plus launches from the ops in ``lost`` whose records
    are missing."""
    events, cid = [], 0
    for sym, n in kernels.items():
        for _ in range(n):
            cid += 1
            events += [_event("cudaLaunchKernel", CPU, cid, "aten::mm"),
                       _event(f"void {sym}<64>(...)", CUDA, cid)]
    for op in lost:
        cid += 1
        events.append(_event("cuLaunchKernel", CPU, cid, op))
    events.append(_event("Memcpy HtoD (Pageable -> Device)", CUDA, cid + 1))
    return types.SimpleNamespace(events=lambda: events)


@pytest.fixture
def windows(monkeypatch):
    """Feed ``_profiled`` the given windows in turn; returns the list of
    windows it profiled."""
    queue, used = [], []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            used.append(queue.pop(0))
            return used[-1]

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return queue, used


def test_lost_records_are_launches_without_a_device_record():
    prof = _window({"k": 3}, lost=["aten::copy_", "aten::copy_",
                                   "aten::index"])
    assert chip_smoke._lost_records(prof) == {"aten::copy_": 2,
                                              "aten::index": 1}
    assert chip_smoke._lost_records(_window({"k": 3})) == {}
    # no device record at all: no device time was measured, nothing lost
    cpu_only = types.SimpleNamespace(events=lambda: [
        _event("cudaLaunchKernel", CPU, 1)])
    assert chip_smoke._lost_records(cpu_only) == {}


def test_window_with_lost_records_elsewhere_is_kept(windows, capsys):
    queue, used = windows
    queue += [_window({"flash": 4}, lost=["aten::copy_"]),
              _window({"flash": 4})]
    _, by_name = chip_smoke._profiled(lambda: None, expect={"flash": 4})
    assert len(used) == 1
    assert sum(n for _, n in by_name.values()) == 4 + 1
    assert '"lost_records": 1' in capsys.readouterr().out


def test_short_kernel_beside_lost_records_is_profiled_again(windows,
                                                            capsys):
    queue, used = windows
    queue += [_window({"flash": 3}, lost=["(no op)"]),
              _window({"flash": 4})]
    _, by_name = chip_smoke._profiled(lambda: None, expect={"flash": 4})
    assert len(used) == 2
    assert by_name["void flash<64>(...)"][1] == 4
    out = capsys.readouterr().out
    assert '"profiled_again": true' in out and '"records": 3' in out


@pytest.mark.parametrize("lost", [(), ("(no op)",)])
def test_shortfall_reaches_the_gate(windows, lost):
    """A shortfall no lost record explains is returned at once; one that
    stays through every window comes back from the last."""
    queue, used = windows
    queue += [_window({"flash": 3}, lost=lost)
              for _ in range(chip_smoke.PROFILED_WINDOWS)]
    _, by_name = chip_smoke._profiled(lambda: None, expect={"flash": 4})
    assert len(used) == (chip_smoke.PROFILED_WINDOWS if lost else 1)
    assert by_name["void flash<64>(...)"][1] == 3


def _profiled_rank(rank, world, firsts):
    """``_profiled`` on one rank of a gloo world with stand-in windows,
    the first made from ``firsts[rank]`` ((kernels, lost) for
    ``_window``), then full ones; each ``run()`` makes one all-reduce, as
    a training step does. Returns (steps run, flash records returned)."""
    import torch.distributed as dist

    windows = [_window(*firsts[rank])] + [_window({"flash": 4})] * 2

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return windows.pop(0)

        def __exit__(self, *exc):
            return False

    torch.profiler.profile = Profile       # this rank's own process
    torch.cuda.synchronize = lambda: None
    steps = []

    def run():
        t = torch.ones(1)
        dist.all_reduce(t)
        steps.append(float(t))

    _, by_name = chip_smoke._profiled(run, expect={"flash": 4},
                                      agree=chip_smoke._any_rank)
    dist.barrier()
    return len(steps), by_name["void flash<64>(...)"][1]


def test_profiling_again_is_the_worlds_decision(tmp_path):
    """Rank 0's first window came short beside a lost record, rank 1's
    did not: both profile a second window, so every rank runs as many
    steps (with their collectives) and none waits on the other."""
    from _torch_dist import run_world

    firsts = [({"flash": 3}, ["(no op)"]), ({"flash": 4}, [])]
    assert run_world(_profiled_rank, 2, tmp_path, firsts, timeout=60) == [
        (2, 4), (2, 4)]


# ---------------------------------------------------------------------
# the mesh phase's host side, on CPU ranks at a tiny size
# ---------------------------------------------------------------------

def test_first_difference_names_what_differs_first():
    ref = {"losses": [torch.tensor(2.0), torch.tensor(1.5)],
           "params": {"a.w": torch.ones(3), "b": torch.zeros(2)},
           "mu": {"a.w": torch.ones(3), "b": torch.zeros(2)},
           "nu": {"a.w": torch.ones(3), "b": torch.zeros(2)}}
    state = {k: {n: t.clone() for n, t in ref[k].items()}
             for k in ("params", "mu", "nu")}
    losses = [t.clone() for t in ref["losses"]]
    assert chip_smoke._first_difference(losses, state, ref) is None
    state["mu"]["b"][1] = 0.5
    assert chip_smoke._first_difference(losses, state, ref) == \
        "mu.b: max |diff| 0.5"
    state["params"]["a.w"][0] = torch.nextafter(torch.tensor(1.0),
                                                torch.tensor(2.0))
    assert chip_smoke._first_difference(losses, state, ref).startswith(
        "params.a.w")
    losses[1] = torch.tensor(1.5000001)
    assert chip_smoke._first_difference(losses, state, ref).startswith(
        "step 1 loss")
    assert "steps" in chip_smoke._first_difference(losses[:1], state, ref)


def test_mesh_tp2_run_on_two_cpu_ranks(tmp_path):
    """``runtime.spawn_world`` runs ``_mesh_rank`` on two gloo CPU ranks (tp = 2,
    tiny GPT-2): the results come back by rank, the first-batch gradients
    gathered whole from the tp shards (``_gather_full``) match the
    single-rank reference within the phase's f32 gates, and a rank that
    raises fails the call."""
    import dataclasses

    import numpy as np

    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config.tiny(n_layer=2)
    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 128, (8, 32)), rng.integers(0, 128, (8, 32)))
            for _ in range(chip_smoke.MESH_STEPS)]
    path = str(tmp_path / "ref.pt")
    torch.use_deterministic_algorithms(True)
    try:
        ref = chip_smoke._mesh_reference(cfg, host, 2, "cpu", path)
    finally:
        torch.use_deterministic_algorithms(False)
    run = ([2], ["tp"], 2, 8)
    ranks = runtime.spawn_world(chip_smoke._mesh_rank, 2, run, host, path,
                                dataclasses.asdict(cfg), "cpu", timeout=120,
                                store_dir=str(tmp_path))
    assert [r["rank"] for r in ranks] == [0, 1]
    assert [r["coords"] for r in ranks] == [{"tp": 0}, {"tp": 1}]
    for r in ranks:
        assert r["strategy"] == "tp"
        assert r["first_loss_rel"] <= chip_smoke.MESH_TOL["first_loss"]
        assert r["worst_grad_rel_err"] <= 1e-5        # f32 on the CPU
        assert max(r["loss_rel"]) <= chip_smoke.MESH_TOL["step_loss"]
        assert r["losses"] == ranks[0]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)
    with pytest.raises(AssertionError, match=r"rank \d raised"):
        runtime.spawn_world(chip_smoke._mesh_rank, 2, ([2], ["dp"], 1, 8),
                            host, str(tmp_path / "missing.pt"),
                            dataclasses.asdict(cfg), "cpu", timeout=120,
                            store_dir=str(tmp_path))


@pytest.mark.parametrize("name", ["pp2_afab", "dp2pp2_stored_zero2",
                                  "3d_1f1b_zero1"])
def test_mesh_pipeline_runs_on_cpu_ranks(tmp_path, name):
    """The mesh phase's pipeline runs (``MESH_RUNS``: their meshes,
    schedules, optimizers and micro-batches) on gloo CPU ranks with a
    tiny GPT-2 (4 layers, 4 heads): every rank's first loss and
    gathered first-batch gradients, step losses and (under ZeRO) Adam
    moment chunks within the phase's gates of the single-rank reference
    with the matching micro-batches, the ZeRO stage the optimizer names,
    and a ZeRO rank's optimizer state half the replicated one's."""
    import dataclasses

    import numpy as np

    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.models.gpt2 import GPT2Config

    run = chip_smoke.MESH_RUNS[name]
    mesh_dim, _, _, rows, _, optimizer = chip_smoke._run_parts(run)
    cfg = GPT2Config.tiny(n_layer=4)
    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 128, (rows, 32)),
             rng.integers(0, 128, (rows, 32)))
            for _ in range(chip_smoke.MESH_STEPS)]
    path = str(tmp_path / "ref.pt")
    torch.use_deterministic_algorithms(True)
    try:
        ref = chip_smoke._mesh_reference(cfg, host, chip_smoke._ref_micro(run),
                                         "cpu", path)
    finally:
        torch.use_deterministic_algorithms(False)
    ranks = runtime.spawn_world(chip_smoke._mesh_rank, int(np.prod(mesh_dim)),
                                run, host, path, dataclasses.asdict(cfg),
                                "cpu", timeout=180, store_dir=str(tmp_path))
    for r in ranks:
        assert r["first_loss_rel"] <= chip_smoke.MESH_TOL["first_loss"]
        assert r["worst_grad_rel_err"] <= 1e-5          # f32 on the CPU
        assert max(r["loss_rel"]) <= chip_smoke.MESH_TOL["step_loss"]
        assert r["losses"] == ranks[0]["losses"]
        if optimizer.startswith("zero"):
            assert r["zero"] == ["dp", int(optimizer[4])]
            assert max(r["moment_chunk_rel_err"].values()) <= 1e-5
            assert r["opt_state_bytes"] * 2 >= \
                r["replicated_opt_state_bytes"] >= r["opt_state_bytes"] * 2 - 8
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)
