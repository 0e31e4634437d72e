"""``chip_smoke.py``'s profiler-window helpers on the CPU, with stand-in
profiles: a launch record without a device record (matched by
correlation id) is a lost record; a window is profiled again only when
a gated kernel came short beside lost records, at most
``PROFILED_WINDOWS`` windows, and the gate then counts in the window
returned."""

import dataclasses
import os
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
    # one thread, as every rank has (chip_smoke._join_rank): a CPU
    # reduction's grouping follows the thread count
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        ref = chip_smoke._mesh_reference(cfg, host, 2, "cpu", path)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)
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
    # one thread, as every rank has (chip_smoke._join_rank): a CPU
    # reduction's grouping follows the thread count
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        ref = chip_smoke._mesh_reference(cfg, host, chip_smoke._ref_micro(run),
                                         "cpu", path)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)
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


def _tiny_run_inputs(tmp_path, name, host=None):
    """``MESH_RUNS[name]`` with a tiny GPT-2 (4 layers, 4 heads): its
    config, host batches (made unless given) and work directory, and,
    unless the run resumes another, its single-rank reference with the
    run's micro-batches (and dtype) written to a file: ``(cfg, host,
    work, path, ref)``."""
    import numpy as np

    from quintnet_tpu_torch.models.gpt2 import GPT2Config

    run = chip_smoke.MESH_RUNS[name]
    rows = chip_smoke._run_parts(run)[3]
    opts = chip_smoke._run_opts(run)
    cfg = GPT2Config.tiny(n_layer=4)
    if host is None:
        rng = np.random.default_rng(0)
        host = [(rng.integers(0, 128, (rows, 32)),
                 rng.integers(0, 128, (rows, 32)))
                for _ in range(chip_smoke.MESH_STEPS)]
    work = str(tmp_path / opts.get("resume", name))
    os.makedirs(work, exist_ok=True)
    if opts.get("resume"):
        return cfg, host, work, None, None
    path = str(tmp_path / f"ref_{name}.pt")
    # one thread, as every rank has (chip_smoke._join_rank): a CPU
    # reduction's grouping follows the thread count
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        ref = chip_smoke._mesh_reference(
            cfg, host, chip_smoke._ref_micro(run), "cpu", path,
            dtype=opts.get("dtype"))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)
    return cfg, host, work, path, ref


def _tiny_mesh_run(tmp_path, name, host=None):
    """``MESH_RUNS[name]`` on gloo CPU ranks with a tiny GPT-2 (4 layers,
    4 heads): the single-rank reference with the run's micro-batches
    (and dtype), then every rank's report; the host batches come back
    for a later run."""
    import dataclasses

    import numpy as np

    from quintnet_tpu_torch.core import runtime

    run = chip_smoke.MESH_RUNS[name]
    world = int(np.prod(run[0]))
    cfg, host, work, path, ref = _tiny_run_inputs(tmp_path, name, host)
    if path is None:
        steps = chip_smoke._cut_after_first_step(work)
        ranks = runtime.spawn_world(
            chip_smoke._resume_rank, world, run, host,
            dataclasses.asdict(cfg), "cpu", work, timeout=180,
            store_dir=str(tmp_path))
        return steps, ranks, work, host
    ranks = runtime.spawn_world(
        chip_smoke._mesh_rank, world, run, host, path,
        dataclasses.asdict(cfg), "cpu", work, timeout=180,
        store_dir=str(tmp_path))
    return ref, ranks, work, host


def test_mesh_runs_of_one_size_share_one_world(tmp_path):
    """``_mesh_world`` runs fsdp_dp2 and then pp2_afab in one world of two
    CPU ranks, as the card's mesh phase runs every world size's runs:
    each run holds its own gates (fsdp_dp2 bit for bit the single-rank
    run, pp2_afab within the f32 gates), the second undisturbed by the
    first, and each run's wall time comes back beside its report."""
    import dataclasses

    from quintnet_tpu_torch.core import runtime

    assert chip_smoke._mesh_worlds() == {
        2: ["dp2", "tp2", "fsdp_dp2", "pp2_afab", "llama_tp2",
            "llama_fsdp_dp2", "llama_moe_ep2", "sp2_ring", "sp2_zigzag",
            "sp2_ulysses", "llama_sp2_ulysses", "vp_tp2", "llama_vp_tp2"],
        4: ["dp2tp2", "fsdp_dp2tp2", "dp2pp2_stored_zero2",
            "llama_dp2pp2_1f1b_zero1", "gpt2_moe_ep2tp2", "vp_tp2_sp2"],
        8: ["3d_1f1b_zero1", "3d_bf16"], "resume": ["3d_ckpt_resume"]}
    jobs, refs = [], {}
    for name in ("fsdp_dp2", "pp2_afab"):
        cfg, host, work, path, refs[name] = _tiny_run_inputs(tmp_path, name)
        jobs.append((name, (chip_smoke.MESH_RUNS[name], host, path,
                            dataclasses.asdict(cfg), work)))
    got = runtime.spawn_world(chip_smoke._mesh_world, 2, "cpu", jobs,
                              timeout=180, store_dir=str(tmp_path))
    for g in got:
        assert list(g) == ["fsdp_dp2", "pp2_afab"]
        (fsdp, t_fsdp), (pp, t_pp) = g["fsdp_dp2"], g["pp2_afab"]
        assert fsdp["first_difference"] is None and fsdp["fsdp"] == "dp"
        assert pp["strategy"] == "pp" and pp["fsdp"] is None
        assert pp["first_loss_rel"] <= chip_smoke.MESH_TOL["first_loss"]
        assert pp["worst_grad_rel_err"] <= 1e-5         # f32 on the CPU
        assert max(pp["loss_rel"]) <= chip_smoke.MESH_TOL["step_loss"]
        assert t_fsdp > 0 and t_pp > 0


@pytest.mark.parametrize("name", ["fsdp_dp2", "fsdp_dp2tp2"])
def test_mesh_fsdp_runs_on_cpu_ranks(tmp_path, name):
    """The mesh phase's fsdp runs on gloo CPU ranks: on dp alone every
    step loss, parameter and both moments equal to the single-rank run
    bit for bit (the dp2 gate); with tp the first loss, gradients and
    step losses within the f32 gates and the gathered moments within the
    gradients' gate; each rank holding half of its blocks
    (``_check_fsdp_rank``); the optimizer state smaller than the
    replicated one's."""
    import numpy as np

    ref, ranks, _, _ = _tiny_mesh_run(tmp_path, name)
    sizes = dict(zip(*reversed(chip_smoke.MESH_RUNS[name][:2])))
    for r in ranks:
        assert r["fsdp"] == "dp"
        assert r["strategy"] == {"fsdp_dp2": "dp",
                                 "fsdp_dp2tp2": "dp_tp"}[name]
        if name == "fsdp_dp2":
            assert r["first_difference"] is None
        else:
            assert r["first_loss_rel"] <= chip_smoke.MESH_TOL["first_loss"]
            assert r["worst_grad_rel_err"] <= 1e-5      # f32 on the CPU
            assert max(r["loss_rel"]) <= chip_smoke.MESH_TOL["step_loss"]
        chip_smoke._check_fsdp_rank(name, r, sizes)
        assert r["opt_state_bytes"] < 0.8 * r["replicated_opt_state_bytes"]
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)


def test_mesh_3d_bf16_run_on_cpu_ranks(tmp_path):
    """The 3d_bf16 run (bf16 compute, bf16 Adam mu) on 8 CPU ranks
    against the single-rank bf16 run, within the train_bf16 gates."""
    ref, ranks, _, _ = _tiny_mesh_run(tmp_path, "3d_bf16")
    tol = chip_smoke.MESH_TOL_BF16
    for r in ranks:
        assert r["zero"] == ["dp", 1] and r["strategy"] == "3d"
        assert r["first_loss_rel"] <= tol["first_loss"]
        assert r["worst_grad_rel_err"] <= tol["grad"]
        assert max(r["loss_rel"]) <= tol["step_loss"]
        assert max(r["moment_chunk_rel_err"].values()) <= tol["grad"]
        # mu bf16 (2 bytes) and nu f32 (4) against 8 bytes replicated
        assert r["opt_state_bytes"] * 2 >= r["replicated_opt_state_bytes"]


def test_mesh_3d_checkpoint_resume_on_cpu_ranks(tmp_path):
    """The 3D run saves every step; cut after step 1, a fresh world of 8
    ranks resumes and takes step 2 equal to the uncut run bit for bit;
    step 1 restored with no mesh equals the uncut parameters after step
    1."""
    _, saved, work, host = _tiny_mesh_run(tmp_path, "3d_1f1b_zero1")
    assert all(len(r["save_s"]) == chip_smoke.MESH_STEPS for r in saved)
    assert saved[0]["checkpoint_bytes"] > 0
    steps, ranks, _, _ = _tiny_mesh_run(tmp_path, "3d_ckpt_resume", host)
    assert steps == [1]
    for r in ranks:
        assert r["restored_global_step"] == [1]
        assert r["first_difference"] is None and r["history_equal"]
        assert r["losses"] == saved[r["rank"]]["losses"][1:]
    one = chip_smoke._restore_without_mesh(work)
    assert one["first_difference"] is None and one["leaves"] == 16
    assert one["saved_mesh"] == {"names": ["dp", "tp", "pp"],
                                 "sizes": [2, 2, 2]}


# the new mesh runs' models cut to test size (the card's: MESH_MODELS)
TINY_SEQ = 32


def _tiny_model(name):
    """``MESH_RUNS[name]``'s model family at test size: a 4-layer tiny
    Llama, a 2-layer tiny Llama-MoE (8 SwiGLU experts, top-2) or a
    2-layer tiny GPT-2-MoE (8 mlp experts, top-2), the experts' capacity
    a micro-batch's tokens (dropless), as ``_run_model`` sets it."""
    import dataclasses

    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.llama import LlamaConfig

    run = chip_smoke.MESH_RUNS[name]
    kind = chip_smoke._run_opts(run)["model"]
    tokens = run[3] // chip_smoke._ref_micro(run) * TINY_SEQ
    if kind == "gpt2_moe":
        return GPT2Config.tiny(n_layer=2, n_experts=8, expert_top_k=2,
                               expert_capacity=tokens)
    cfg = LlamaConfig.tiny(n_layers=4)
    if kind == "llama":
        return cfg
    return dataclasses.replace(cfg, n_layers=2, n_experts=8,
                               expert_capacity=tokens)


def _filled_launches(run, ranks, cfg):
    """Reports as the card gives them: the CPU runs the kernels' plain
    versions, so the launch counts the card makes are put in (the
    stage's layers x micro-batches x steps), leaving every other gate to
    the run."""
    per_step = chip_smoke._per_step(run, chip_smoke._depth(cfg))
    for r in ranks:
        r["launches"] = {k: n * chip_smoke.MESH_STEPS
                         for k, n in per_step.items()}
        r["launches"]["paged_attention"] = 0
        r["launches_by_dtype"] = {k: {"f32": n * chip_smoke.MESH_STEPS}
                                  if n else {} for k, n in per_step.items()}
    return ranks


@pytest.mark.parametrize("world", [2, 4])
def test_llama_and_moe_mesh_runs_on_cpu_ranks(tmp_path, monkeypatch, world):
    """The slice's mesh runs (llama_tp2, llama_fsdp_dp2, llama_moe_ep2 in
    a world of 2; llama_dp2pp2_1f1b_zero1 and gpt2_moe_ep2tp2 in a world
    of 4) on gloo CPU ranks with their models at test size, each against
    its single-rank reference (the losses with the aux term), through
    ``_check_mesh_run``'s own gates (MESH_TOL: the first loss, every
    gradient leaf gathered whole over tp, pp, dp and ep, the step losses,
    the ZeRO moment chunks, fsdp's half of the blocks, and for the MoE
    runs every first-batch routing decision equal to the reference's,
    none dropped)."""
    import numpy as np

    from quintnet_tpu_torch.core import runtime

    names = [n for n in chip_smoke._mesh_worlds()[world]
             if n.startswith(("llama", "gpt2_moe"))]
    jobs, refs, cfgs = [], {}, {}
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        for name in names:
            run = chip_smoke.MESH_RUNS[name]
            cfgs[name] = cfg = _tiny_model(name)
            rng = np.random.default_rng(0)
            host = [(rng.integers(0, 128, (run[3], TINY_SEQ)),) * 2
                    for _ in range(chip_smoke.MESH_STEPS)]
            path = str(tmp_path / f"ref_{name}.pt")
            refs[name] = chip_smoke._mesh_reference(
                cfg, host, chip_smoke._ref_micro(run), "cpu", path)
            work = str(tmp_path / name)
            os.makedirs(work)
            jobs.append((name, (run, host, path, chip_smoke._model_dict(cfg),
                                work)))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)
    got = runtime.spawn_world(chip_smoke._mesh_world, world, "cpu", jobs,
                              timeout=300, store_dir=str(tmp_path))
    monkeypatch.setattr(chip_smoke, "_smi", lambda: "(no card)")
    for name in names:
        run = chip_smoke.MESH_RUNS[name]
        ranks = _filled_launches(run, [g[name][0] for g in got], cfgs[name])
        res = chip_smoke._check_mesh_run(name, run, ranks, refs[name],
                                         cfgs[name])
        assert res["layers_a_rank"] * dict(zip(run[1], run[0])).get(
            "pp", 1) == chip_smoke._depth(cfgs[name])
        for r in ranks:
            assert r["worst_grad_rel_err"] <= 1e-5      # f32 on the CPU
            if "moe" in name:
                assert r["routing"]["agree_share"] == 1.0
                assert r["routing"]["dropped"] == 0
                assert r["strategy"] in ("ep", "ep_tp")
            if name == "llama_fsdp_dp2":
                assert r["fsdp"] == "dp"
        np.testing.assert_allclose(ranks[0]["losses"], refs[name]["losses"],
                                   rtol=1e-5)


def test_moe_mesh_model_is_dropless_at_card_size():
    """The card's MoE runs set the experts' capacity to a micro-batch's
    token count, so no routing can drop; the reference takes the same
    micro-batches (ep is a batch axis)."""
    for name in ("llama_moe_ep2", "gpt2_moe_ep2tp2"):
        run = chip_smoke.MESH_RUNS[name]
        cfg = chip_smoke._run_model(run)
        seq = chip_smoke.MESH_MODELS[chip_smoke._run_opts(run)["model"]][1]
        sizes = dict(zip(run[1], run[0]))
        assert chip_smoke._ref_micro(run) == run[2] * sizes["ep"]
        assert cfg.expert_capacity == run[3] // chip_smoke._ref_micro(
            run) * seq
        assert cfg.n_experts == 8 and cfg.expert_top_k == 2
    assert "all_to_all" in chip_smoke.PROBE_GATED


SP_RUNS = ("sp2_ring", "sp2_zigzag", "sp2_ulysses")


def test_sp_mesh_runs_parse_and_share_the_two_rank_world():
    """The sequence-parallel runs: GPT-2 124M widths (4 layers) at its
    1,024 positions on sp = 2 in each mode, and Llama by Ulysses; all in
    the 2-rank world; the three GPT-2 runs one reference, the Llama run
    llama_tp2's; K1-K3 a step only under Ulysses (4 layers x 2
    micro-batches; Llama's 2 x 2); the permutation and the Ulysses
    exchange probed and gated."""
    runs = {n: chip_smoke.MESH_RUNS[n] for n in SP_RUNS
            + ("llama_sp2_ulysses",)}
    for name, run in runs.items():
        mesh_dim, mesh_name, n_micro, rows, schedule, optimizer = \
            chip_smoke._run_parts(run)
        assert (mesh_dim, mesh_name, n_micro, rows, schedule, optimizer) \
            == ([2], ["sp"], 2, 8, "afab", "adamw")
        assert name in chip_smoke._mesh_worlds()[2]
        assert not chip_smoke._exact(run)
    for name in SP_RUNS:
        cfg = chip_smoke._run_model(runs[name])
        assert (cfg.n_layer, cfg.n_embd, cfg.n_head) == (4, 768, 12)
        assert chip_smoke.MESH_MODELS["gpt2_1k"][1] == cfg.n_positions \
            == 1024
    assert len({chip_smoke._ref_key(runs[n]) for n in SP_RUNS}) == 1
    assert chip_smoke._ref_key(runs["llama_sp2_ulysses"]) == \
        chip_smoke._ref_key(chip_smoke.MESH_RUNS["llama_tp2"])
    zero = {k: 0 for k in chip_smoke.FLASH_KERNELS}
    assert chip_smoke._per_step(runs["sp2_ring"], 4) == zero
    assert chip_smoke._per_step(runs["sp2_zigzag"], 4) == zero
    assert chip_smoke._per_step(runs["sp2_ulysses"], 4) == {
        k: 8 for k in chip_smoke.FLASH_KERNELS}
    assert chip_smoke._run_model(runs["llama_sp2_ulysses"]).n_layers == 2
    assert chip_smoke._per_step(runs["llama_sp2_ulysses"], 2) == {
        k: 4 for k in chip_smoke.FLASH_KERNELS}
    for name in ("ppermute", "all_to_all_ulysses"):
        assert name in chip_smoke.PROBED and name in chip_smoke.PROBE_GATED
    # an sp2_ulysses rank's K1-K3 shape: 4 rows, 6 heads, 1,024 positions
    assert chip_smoke.ULYSSES_CASE == "sp2_ulysses_B4_H6_S1024"
    assert chip_smoke.PROBE_ULYSSES == (3, 4, 12, 512, 64)


def test_probe_collectives_on_cpu_ranks(tmp_path):
    """``_probe_rank`` on two gloo CPU ranks: every probed collective
    gives its expected value (the permutation with an idle sender and
    the Ulysses exchange at the card's shape too), and the exchange is
    timed."""
    from quintnet_tpu_torch.core import runtime

    got = runtime.spawn_world(chip_smoke._probe_rank, 2, "cpu", timeout=120,
                              store_dir=str(tmp_path))
    for r in got:
        assert all(r[k] == "ok" for k in chip_smoke.PROBED), r
        assert r["all_to_all_ulysses_ms"] > 0


def test_sp_mesh_runs_on_cpu_ranks(tmp_path, monkeypatch):
    """sp2_ring, sp2_zigzag and sp2_ulysses in one world of two gloo CPU
    ranks with a tiny GPT-2 (4 layers, 4 heads) on rows of 32, against
    one single-rank reference through ``_check_mesh_run``'s own gates
    (the first loss, every gradient leaf, the step losses): the
    sequence split over the ranks, 16 positions each."""
    import numpy as np

    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config.tiny(n_layer=4)
    run0 = chip_smoke.MESH_RUNS[SP_RUNS[0]]
    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 128, (run0[3], TINY_SEQ)),) * 2
            for _ in range(chip_smoke.MESH_STEPS)]
    path = str(tmp_path / "ref.pt")
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        ref = chip_smoke._mesh_reference(cfg, host,
                                         chip_smoke._ref_micro(run0), "cpu",
                                         path)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)
    jobs = []
    for name in SP_RUNS:
        work = str(tmp_path / name)
        os.makedirs(work)
        jobs.append((name, (chip_smoke.MESH_RUNS[name], host, path,
                            chip_smoke._model_dict(cfg), work)))
    got = runtime.spawn_world(chip_smoke._mesh_world, 2, "cpu", jobs,
                              timeout=300, store_dir=str(tmp_path))
    monkeypatch.setattr(chip_smoke, "_smi", lambda: "(no card)")
    for name in SP_RUNS:
        run = chip_smoke.MESH_RUNS[name]
        ranks = _filled_launches(run, [g[name][0] for g in got], cfg)
        res = chip_smoke._check_mesh_run(name, run, ranks, ref, cfg)
        assert res["sp_mode"] == chip_smoke._run_opts(run)["sp_mode"]
        assert res["seq_a_rank"] == 512
        for r in ranks:
            assert r["strategy"] == "sp"
            assert r["worst_grad_rel_err"] <= 1e-5      # f32 on the CPU
        np.testing.assert_allclose(ranks[0]["losses"], ref["losses"],
                                   rtol=1e-5)


VP_RUNS = ("vp_tp2", "llama_vp_tp2", "vp_tp2_sp2")


def test_vp_mesh_runs_parse():
    """The vocab-parallel runs: GPT-2 124M widths (4 layers) with its
    table padded to 50,304 rows on tp = 2 (25,152 a rank; then 16 greedy
    tokens by ``gpt2_generate_tp``), Llama-3.2-1B widths at 2 layers on
    tp = 2 (sharing llama_tp2's reference: vp without tp changes
    nothing), GPT-2 at 4 layers on tp x sp by Ulysses in the 4-rank
    world."""
    runs = {n: chip_smoke.MESH_RUNS[n] for n in VP_RUNS}
    cfgs = {n: chip_smoke._run_model(r) for n, r in runs.items()}
    for name, cfg in cfgs.items():
        assert cfg.vocab_parallel and not chip_smoke._exact(runs[name])
    g = cfgs["vp_tp2"]
    assert (g.n_layer, g.vocab_size, g.table_vocab_size) == (4, 50257, 50304)
    assert chip_smoke._run_opts(runs["vp_tp2"])["generate"] == 16
    assert cfgs["vp_tp2_sp2"].n_layer == 4
    assert cfgs["llama_vp_tp2"].table_vocab_size == 128256
    assert chip_smoke._ref_key(runs["llama_vp_tp2"]) == \
        chip_smoke._ref_key(chip_smoke.MESH_RUNS["llama_tp2"])
    assert len({chip_smoke._ref_key(r) for r in runs.values()}) == 3
    worlds = chip_smoke._mesh_worlds()
    assert {"vp_tp2", "llama_vp_tp2"} <= set(worlds[2])
    assert "vp_tp2_sp2" in worlds[4]
    assert chip_smoke._per_step(runs["vp_tp2_sp2"], 4) == {
        k: 8 for k in chip_smoke.FLASH_KERNELS}


@pytest.mark.parametrize("name,sizes", [("vp_tp2", {"tp": 2}),
                                        ("vp_tp2_sp2", {"tp": 2, "sp": 2})])
def test_vp_mesh_runs_on_cpu_ranks(tmp_path, monkeypatch, name, sizes):
    """A vocab-parallel run on gloo CPU ranks with a tiny GPT-2 whose
    table is padded 123 -> 128 rows, through ``_check_mesh_run``'s own
    gates: the first loss, every gradient leaf (the sharded table
    gathered), the step losses, the table rows a rank, the padded rows'
    zero gradient and, for vp_tp2, the tp generation against one
    device."""
    import dataclasses

    import numpy as np

    from quintnet_tpu_torch.core import runtime
    from quintnet_tpu_torch.models.gpt2 import GPT2Config

    run = chip_smoke.MESH_RUNS[name]
    assert dict(zip(run[1], run[0])) == sizes
    cfg = GPT2Config.tiny(n_layer=2, vocab_size=123, padded_vocab_size=128,
                          vocab_parallel=True)
    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 123, (run[3], TINY_SEQ)),) * 2
            for _ in range(chip_smoke.MESH_STEPS)]
    path = str(tmp_path / "ref.pt")
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        ref = chip_smoke._mesh_reference(
            dataclasses.replace(cfg, vocab_parallel=False), host,
            chip_smoke._ref_micro(run), "cpu", path)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)
    world = int(np.prod(list(sizes.values())))
    ranks = runtime.spawn_world(chip_smoke._mesh_rank, world, run, host,
                                path, chip_smoke._model_dict(cfg), "cpu",
                                timeout=300, store_dir=str(tmp_path))
    monkeypatch.setattr(chip_smoke, "_smi", lambda: "(no card)")
    ranks = _filled_launches(run, ranks, cfg)
    res = chip_smoke._check_mesh_run(name, run, ranks, ref, cfg)
    assert res["vocab"]["table_rows_a_rank"] == 64
    for r in ranks:
        assert r["worst_grad_rel_err"] <= 1e-5          # f32 on the CPU
        assert r["padded_rows_grad_max"] == 0.0
        if name == "vp_tp2":
            g = r["generate"]
            assert g["divergences"] == [] and g["padded_ids_emitted"] == 0
            assert g["tokens_agreeing"] == 2 * g["new_tokens"]
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)


def test_serve_mesh_runs_parse_and_join_the_two_rank_world():
    """The serving mesh runs (``SERVE_MESH_RUNS``): tp = 2 on GPT-2 124M
    widths at 4 layers and on Llama-3.2-1B widths at 4 layers, sp = 2 on
    GPT-2 124M widths at 4 layers
    (the 1,000-token document through buckets of 256, 128 positions a
    rank), ep = 2 on GPT-2 124M widths at 4 layers with 8 experts,
    top-2, dropless and at the default capacity factor 1.25; every mesh two ranks wide (they
    join the mesh phase's 2-rank world), and the training runs' worlds
    unchanged."""
    runs = chip_smoke.SERVE_MESH_RUNS
    assert set(runs) == {"serve_tp2", "serve_tp2_llama", "serve_sp2",
                         "serve_ep2", "serve_ep2_drops"}
    assert all(sum(v for v in r[0].values()) == 2 for r in runs.values())
    gpt2 = chip_smoke._serve_mesh_cfg("gpt2")
    assert (gpt2.n_layer, gpt2.n_embd, gpt2.n_head) == (4, 768, 12)
    llama = chip_smoke._serve_mesh_cfg("llama")
    assert (llama.n_layers, llama.dim, llama.n_heads,
            llama.n_kv_heads) == (4, 2048, 32, 8)
    moe = chip_smoke._serve_mesh_cfg("gpt2_moe")
    assert (moe.n_layer, moe.n_embd, moe.n_experts,
            moe.expert_top_k) == (4, 768, 8, 2)
    # dropless: C = each call's tokens
    assert moe.capacity_factor * moe.expert_top_k == moe.n_experts
    drops = chip_smoke._serve_mesh_cfg("gpt2_moe_drops")
    assert drops.capacity_factor == 1.25         # JAX's default
    assert drops == dataclasses.replace(moe, capacity_factor=1.25)
    from quintnet_tpu_torch.analysis.specs import prefill_buckets

    sp = runs["serve_sp2"][2]
    assert sp["prefill_len"] == 256 and sp["chunked_prefill"]
    assert all(b % 2 == 0 for b in prefill_buckets(sp["prefill_len"]))
    assert 2 in chip_smoke._mesh_worlds()


def test_serve_mesh_launches_count_on_their_ranks_head_shapes():
    """Each serving mesh run's K4 launches go to the kernels-line entry
    timed at its rank's head shape: a tp2 rank's (GPT-2 6 on 6, Llama 16
    query heads on 4 kv heads) to its own; every other run's ranks hold
    GPT-2's 12 heads and count on GPT-2's lines."""
    lines = chip_smoke.SERVE_MESH_LINES
    assert {tag for tag, _, _ in lines.values()} == {"tp2_gpt2",
                                                     "tp2_llama"}
    for name, (sizes, model, _, _) in chip_smoke.SERVE_MESH_RUNS.items():
        cfg = chip_smoke._serve_mesh_cfg(model)
        hq = getattr(cfg, "n_head", None) or cfg.n_heads
        hkv = getattr(cfg, "n_kv_heads", None) or hq
        tp = sizes.get("tp", 1)
        if name in lines:
            assert (hq // tp, hkv // tp) == lines[name][1:], name
        else:
            assert tp == 1 and (hq, hkv) == (12, 12), name


def _tiny_serve_cfg(model):
    from quintnet_tpu_torch.models.gpt2 import GPT2Config
    from quintnet_tpu_torch.models.llama import LlamaConfig

    if model == "llama":
        return LlamaConfig.tiny(n_layers=2, n_positions=512)
    if model == "gpt2_moe":
        return GPT2Config.tiny(n_layer=2, n_experts=8, expert_top_k=2,
                               capacity_factor=4.0, n_positions=1024)
    if model == "gpt2_moe_drops":
        return GPT2Config.tiny(n_layer=2, n_experts=8, expert_top_k=2,
                               n_positions=1024)
    return GPT2Config.tiny(n_layer=2, n_positions=1024)


def test_serve_mesh_runs_on_cpu_ranks(tmp_path, monkeypatch):
    """Every serving mesh run in one world of two gloo CPU ranks
    (``_mesh_world``, as the mesh phase runs them) with its model at test
    size, each against its one-device reference made by the same
    ``_serve_mesh_traffic``, through ``_check_serve_mesh``'s own gates:
    the ranks' streams equal to each other and to one device's up to
    near-ties, greedy and sampled; the document's last logits (sp); the
    routing summary (ep; with drops the ranks' own, equal, and some
    assignment dropped). Each rank reports its steady decode step and
    the collectives' share of it (none under sp: decode runs replicated,
    and the ring lives in the prefill)."""
    from quintnet_tpu_torch.core import runtime

    refs, jobs = {}, []
    for name, (_, model, _, _) in chip_smoke.SERVE_MESH_RUNS.items():
        cfg = _tiny_serve_cfg(model)
        params = chip_smoke._serve_mesh_params(cfg, "cpu")
        refs[name] = (chip_smoke._serve_mesh_traffic(name, cfg, params,
                                                     "cpu"), params, cfg)
        jobs.append((name, (chip_smoke._model_dict(cfg),)))
    got = runtime.spawn_world(chip_smoke._mesh_world, 2, "cpu", jobs,
                              timeout=600, store_dir=str(tmp_path))
    for name in chip_smoke.SERVE_MESH_RUNS:
        ref, params, cfg = refs[name]
        ranks = [g[name][0] for g in got]
        res = chip_smoke._check_serve_mesh(name, ranks, ref, params, cfg)
        assert [r["coords"] for r in res["ranks"]] == [
            {k: 0 for k in chip_smoke.SERVE_MESH_RUNS[name][0]},
            {k: 1 for k in chip_smoke.SERVE_MESH_RUNS[name][0]}]
        for mode, run in res["runs"].items():
            assert run["tokens_compared"] > 0
            div = run["divergences_at_near_ties"]
            if name == "serve_ep2_drops":
                assert div is None
                assert run["routing_summary"]["moe_dropped_tokens"] > 0
            else:
                assert len(div) <= 1, (name, mode)
        if name == "serve_sp2":
            assert res["runs"]["greedy"][
                "document_last_logits_max_abs_err"] <= 1e-5
        for r in res["ranks"]:
            assert r["decode_step_ms"] > 0
            share = r["collective_share_of_profiled_step"]
            # sp decodes replicated, with no collective
            assert (share == 0 if name == "serve_sp2" else 0 < share < 1)


# ---------------------------------------------------------------------
# the slice-19 serving phases (serve_wq, serve_tier, serve_lora)
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_gpt2():
    """A tiny GPT-2 at 1,024 positions, on one CPU thread (the test
    workers share the cores)."""
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = GPT2Config.tiny(n_layer=2, n_positions=1024)
    yield gpt2_init(torch.Generator().manual_seed(0), cfg), cfg
    torch.set_num_threads(threads)


def _on_cpu(monkeypatch):
    """The phases' own code on the CPU: the kernels' plain versions,
    which launch nothing (the launch gates apply on the card)."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SERVE_LENS", [32, 100, 60, 57, 90])


def _launch_arithmetic(run, decode_steps, admitted, layers=2):
    assert run == {"decode": layers * decode_steps,
                   "prefill": layers * admitted}


def test_serve_wq_phase_on_cpu(monkeypatch, tiny_gpt2):
    """serve_wq on a tiny GPT-2: fake_quant's streams equal the f32
    serve run's, the narrow policies pass the narrow-layout rule, the
    NLL and bytes gates hold, and each run's K4 launches by path (the
    kernels line's f32 counts) are the serve rule's arithmetic."""
    _on_cpu(monkeypatch)
    params, cfg = tiny_gpt2
    eng, _ = chip_smoke._serve_engine(params, cfg)
    rids, _, _, _ = chip_smoke._serve_script(eng, cfg)
    f32 = [eng.result(r) for r in rids]
    res, runs = chip_smoke.phase_serve_wq(params, cfg, f32)
    assert res["fake_quant"]["streams_identical_to_f32"]
    for name in ("bf16", "int8", "fp8"):
        assert res[name]["agree_with_dense"] >= 0.9
    nll = res["nll"]["paged_eval_nll"]
    assert nll["fake_quant"] == nll["f32"]
    assert res["nll"]["f32_over_int8_bytes"] >= 3.5
    assert len(runs) == len(chip_smoke.WQ_POLICIES)
    for name, run in zip(chip_smoke.WQ_POLICIES, runs):
        # the CPU launches nothing: the counts the card must show are the
        # engine's steps, held by _check_serve_run there
        assert run == {}
        assert res[name]["decode_step_ms_p50"] > 0


def test_serve_tier_phase_on_cpu(monkeypatch, tiny_gpt2):
    """serve_tier on a tiny GPT-2: the tier demotes and promotes, never
    during a decode dispatch; the streams equal the never-evicting
    pool's bit for bit; a chain demoted and promoted back byte for byte
    from an f32 and an int8 pool; the K4 arithmetic of each run."""
    _on_cpu(monkeypatch)
    params, cfg = tiny_gpt2
    res, runs = chip_smoke.phase_serve_tier(params, cfg)
    assert res["tier"]["demotions"] > 0 and res["tier"]["promotions"] > 0
    assert res["host_hit_tokens"] > 0
    assert res["decode_blocked_demotions"] == 0
    assert res["streams_identical_to_never_evicting_pool"]
    assert res["runs"]["never_evicts"]["cache_evictions"] == 0
    assert res["runs"]["tier"]["cache_evictions"] > 0
    for pool in ("f32", "int8"):
        assert res["round_trip"][pool]["blocks"] > 0
    assert len(runs) == 3
    n = 3 * chip_smoke.TIER_ROUNDS
    for run in runs:
        _launch_arithmetic(run, n * (chip_smoke.TIER_NEW - 1), n)


def test_serve_lora_phase_on_cpu(monkeypatch, tiny_gpt2):
    """serve_lora on a tiny GPT-2: every tenant's stream equals its
    dedicated merged engine's up to near-ties (none here: on the CPU the
    two orders of summation agree on every token), the decode bucket
    follows the bound adapters (every bucket of the ladder used), the
    pins are released, and each run's K4 arithmetic."""
    _on_cpu(monkeypatch)
    params, cfg = tiny_gpt2
    res, runs = chip_smoke.phase_serve_lora(params, cfg)
    for mode in ("greedy", "sampled"):
        run = res["runs"][mode]
        assert set(run["decode_calls_by_rank_bucket"]) == {4, 8, 16}
        for tenant, d in run["vs_dedicated_merged"].items():
            assert d["tokens_compared"] > 0
            assert d["tokens_agreeing"] == d["tokens_compared"], tenant
        assert run["per_adapter"]["t4"]["requests"] == 2
    stacked = res["runs"]["greedy_int8_weights"]
    assert stacked["weight_bytes"] < res["runs"]["greedy"]["weight_bytes"]
    assert len(stacked["new_tokens_equal_to_f32_run"]) == 8
    # 3 adapter runs + 4 dedicated engines for each of the two modes
    assert len(runs) == 3 + 2 * 4
    for run in runs:
        assert set(run) == {"decode", "prefill"} and run["prefill"] > 0


# ---------------------------------------------------------------------
# the slice-20 serving phase (serve_fleet)
# ---------------------------------------------------------------------

def test_serve_fleet_phase_on_cpu(monkeypatch, tiny_gpt2):
    """serve_fleet on a tiny GPT-2: both fleet runs' gates (the dense
    greedy and the single-engine sampled oracles, exactly the armed
    death, a migration, a crash dump read back, the exposition parsed),
    the inertness census equal on and off, the deadline's typed retire
    with its blocks returned, and the K4 arithmetic the card holds to
    (the CPU launches nothing, so the per-thread count is empty here)."""
    _on_cpu(monkeypatch)
    params, cfg = tiny_gpt2
    res, totals = chip_smoke.phase_serve_fleet(params, cfg)
    for mode in ("greedy", "sampled"):
        run = res["runs"][mode]
        assert run["migrations"] >= 1 and run["shed"] == 0
        assert run["replica_deaths"] == 1 and run["restarts"] == 1
        assert run["gen_tokens"] == (chip_smoke.FLEET_REQUESTS
                                     * chip_smoke.FLEET_NEW)
        assert run["crash_dump"]["ring"] == chip_smoke.FLEET_KILL[1]
        assert run["crash_dump"]["requests"] >= 1
        assert run["exposition_samples"] > 0
        assert set(run["step_ms_p50"]) == {"r0", "r1", "r2", "r1 (dead)"}
        assert run["launches_by_thread"] == {}
    greedy, sampled = res["runs"]["greedy"], res["runs"]["sampled"]
    assert greedy["tokens_checked_vs_dense"] == greedy["gen_tokens"]
    assert sampled["tokens_agreeing_with_one_engine"] == \
        sampled["tokens_compared"]
    assert totals == {k: greedy["launches_by_path"][k]
                      + sampled["launches_by_path"][k]
                      for k in ("decode", "prefill")}
    assert totals["decode"] > 0 and totals["prefill"] > 0
    inert = res["inertness"]
    assert inert["spans"] > 0 and inert["host_aten_ops_per_step"] > 0
    dl = res["deadline"]
    assert dl["generated_before_deadline"] > 0
    assert dl["blocks_held_after"] == 0
    assert dl["resubmission_prefix_hit_tokens"] > 0


def test_serve_fleet_deaths_other_than_the_armed_one_fail(monkeypatch,
                                                          tiny_gpt2,
                                                          tmp_path):
    """The phase's death gate: a run whose event log holds a death that
    was not armed (a replica whose step raised on its own, standing in
    for a kernel fault in a worker thread) fails, though every request
    finished on the other replicas."""
    _on_cpu(monkeypatch)
    params, cfg = tiny_gpt2
    real = chip_smoke._fleet_engine
    built = {"n": 0}

    def faulty(*a, **k):
        eng = real(*a, **k)
        built["n"] += 1
        if built["n"] == 1:                  # r0's first engine
            def boom():
                raise RuntimeError("kernel launch failed (injected)")
            eng.step = boom
        return eng

    monkeypatch.setattr(chip_smoke, "_fleet_engine", faulty)
    prompts = chip_smoke._fleet_prompts(cfg)[:6]
    monkeypatch.setattr(chip_smoke, "FLEET_REQUESTS", len(prompts))
    fleet, _fids, outs, launches, _wall = chip_smoke._fleet_run(
        params, cfg, prompts, str(tmp_path), {})
    assert len(outs) == len(prompts)
    with pytest.raises(AssertionError, match="expected only the armed"):
        chip_smoke._check_fleet_run(fleet, cfg, launches)


# ---------------------------------------------------------------------
# the slice-21 serving phase (serve_proc_fleet)
# ---------------------------------------------------------------------

def test_serve_proc_fleet_phase_on_cpu(monkeypatch, tiny_gpt2):
    """serve_proc_fleet on a tiny GPT-2, its replicas CPU processes built
    from chip_smoke's own builder: the colocated greedy and sampled runs
    with the real SIGKILL (one death, a migration, the restart probed,
    the crash dump's mirrored ring), the front door's stream, the
    disaggregated run's handoffs, each against its oracle, and the K4
    arithmetic each child reports (the CPU launches nothing, so the
    launch counts themselves are gated on the card)."""
    _on_cpu(monkeypatch)
    params, cfg = tiny_gpt2
    res, totals = chip_smoke.phase_serve_proc_fleet(params, cfg)
    n = chip_smoke.FLEET_REQUESTS
    for mode in ("colocated_greedy", "colocated_sampled"):
        run = res["runs"][mode]
        assert run["replica_deaths"] == 1 and run["restarts"] >= 1
        assert run["migrations"] >= 1 and run["stalls"] == 0
        assert run["journaled_at_kill"] >= chip_smoke.PROC_KILL[1]
        assert run["crash_dump"]["ring"] >= 1
        assert set(run["step_ms_p50"]) == {"p0", "p1", "p2", "p1 (dead)"}
        assert set(run["launches_by_replica"]) == {"p0", "p1", "p2"}
        assert run["launches_by_replica"]["p1"]["prefill"] == 2  # the probe
        assert run["restart_s"] > 0 and run["spawn_to_hello_s"] > 0
    greedy = res["runs"]["colocated_greedy"]
    assert greedy["tokens_checked_vs_dense"] == n * chip_smoke.FLEET_NEW
    assert greedy["front_door"]["healthz"] == "ok"
    assert greedy["front_door"]["streamed_tokens"] == chip_smoke.FLEET_NEW
    assert greedy["front_door"]["exposition_samples"] > 0
    sampled = res["runs"]["colocated_sampled"]
    assert sampled["tokens_agreeing_with_one_engine"] == \
        sampled["tokens_compared"]
    disagg = res["runs"]["disaggregated_greedy"]
    assert disagg["handoffs"] == disagg["handoff_transfers"] == n
    assert disagg["handoff_fallbacks"] == 0 and disagg["replica_deaths"] == 0
    assert disagg["tokens_agreeing_with_colocated"] == \
        disagg["tokens_compared"] == n * chip_smoke.FLEET_NEW
    assert disagg["kv_bytes_shipped"] > 0 and disagg["handoff_ms"]["n"] == n
    by = disagg["launches_by_replica"]
    assert set(by) == {"prefill0", "decode0", "decode1"}
    assert by["prefill0"] == {"decode": 0, "prefill": 2 * n}
    assert by["decode0"]["decode"] > 0 and by["decode1"]["decode"] > 0
    assert totals == {k: sum(w[k] for r in res["runs"].values()
                             for w in r["launches_by_replica"].values())
                      for k in ("decode", "prefill")}


# ---------------------------------------------------------------------
# the slice-22 checks of the resume phase (fault tolerance, HF interop)
# ---------------------------------------------------------------------

def test_resume_phase_on_cpu(monkeypatch, tmp_path):
    """The resume phase's own code on the CPU at a tiny GPT-2 (2 layers,
    a width whose head count the HF loader infers, rows of 32): the cut
    and the SIGTERM-preempted runs resumed bit for bit, the export and
    reload bit-equal, the perplexity (over 6 KB of README.md in windows
    of 128: the plain kernel versions are slow on the CPU) through the
    flash dispatcher against the plain attention, the fallback past a
    corrupted step, and the supervisor on the CPU. The launch gates are
    recorded with what they demand (the CPU launches nothing; the card
    holds the counts): n_layer x micro-batches x steps for K1-K3, and
    for eval_ppl K1 once a layer a batch and nothing else."""
    from quintnet_tpu_torch.models.gpt2 import GPT2Config

    _on_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "_smi", lambda: "cpu")
    text = tmp_path / "text.md"
    with open(chip_smoke.PPL_TEXT, encoding="utf-8") as f:
        text.write_text(f.read()[:6000], encoding="utf-8")
    monkeypatch.setattr(chip_smoke, "PPL_TEXT", str(text))
    monkeypatch.setattr(chip_smoke, "PPL_SEQ", 128)
    gates = []
    monkeypatch.setattr(chip_smoke, "_check_launches_exact",
                        lambda counts, want, what: gates.append((want, what)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = GPT2Config.tiny(n_layer=2, n_embd=50, n_head=25,
                              n_positions=1024, vocab_size=264)
        res, total = chip_smoke.phase_resume(cfg, seq=32, batch=8)
    finally:
        torch.set_num_threads(threads)
    per = 2 * 2
    want = [{"flash_fwd": per * 8, "flash_bwd_dkv": per * 8,
             "flash_bwd_dq": per * 8, "paged_attention": 0},
            {"flash_fwd": per * 4, "flash_bwd_dkv": per * 4,
             "flash_bwd_dq": per * 4, "paged_attention": 0}]
    ppl = res["perplexity"]
    batches = -(-ppl["windows"] // chip_smoke.PPL_BATCH)
    want.append({"flash_fwd": 2 * batches, "flash_bwd_dkv": 0,
                 "flash_bwd_dq": 0, "paged_attention": 0})
    assert [w for w, _ in gates] == want
    pre = res["preempted"]
    assert pre["stopped_at"] == [0, 2, 2] and pre["steps_on_disk"] == [2]
    reports = pre["goodput_reports"]
    assert [r["completed"] for r in reports] == [False, True]
    assert [r["steps_run"] for r in reports] == [2, 2]
    assert reports[1]["resumed_at"] == 2 and reports[1]["reached"] == 4
    assert reports[0]["save_blocking_s"] > 0 and reports[1]["restore_s"] > 0
    agg = pre["goodput_aggregate"]
    assert agg["useful_steps"] == 4 and agg["lost_steps"] == 0
    assert res["bit_identical"]["runs"] == ["cut", "preempted"]
    assert res["hf_export"]["step"] == 4 and res["hf_export"]["bytes"] > 0
    assert res["hf_export"]["leaves_bit_equal"] == 16
    assert ppl["windows"] > 1 and ppl["rel_diff"] <= chip_smoke.PPL_RTOL
    assert res["fallback"]["corrupt"]["hook_calls"] == [4, 2]
    assert res["fallback"]["injected"]["hook_calls"] == [4, 2]
    sup = res["supervisor"]["record"]["extras"]
    assert sup["faults_survived"] == 1 and sup["completed"] is True
    assert set(res["seconds"]) == {"cut_resume", "preempt_resume",
                                   "export_reload", "perplexity",
                                   "fallback", "supervisor"}
    assert total == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
                     "paged_attention": 0}
