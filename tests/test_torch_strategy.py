"""The port's strategy facade and runtime (parallel/strategy.py,
core/runtime.py): which strategies are ported, the axis roles of the pp
and ZeRO strategies against JAX's, what the others raise, and that the
runtime takes its backend and device from the caller.

``get_strategy`` builds ``single`` on one device here; ``auto`` picks
``dp``, ``tp`` and ``dp_tp`` on the gloo worlds of
``tests/test_torch_tp.py`` and ``tests/test_torch_dp.py`` (their runs
assert the strategy name). The pp strategies (``pp``, ``dp_pp``,
``tp_pp``, ``3d``, and ``auto`` on their meshes) and ZeRO-1/2 over dp
are built on gloo worlds of 2, 4 and 8 CPU ranks here, each held to the
roles JAX's ``get_strategy`` gives the same config (``batch_axes``,
``model_axes``, ``partial_axes``, ``zero1_axis``, ``zero_stage``), as
are ``training.fsdp`` on dp and dp x tp (``fsdp_axis``), the ep
strategies (``ep``, ``dp_ep``, ``ep_tp``, ``ep_pp``: ep is a batch
axis) and the sp ones (``sp``, ``dp_sp``, and JAX's ``custom`` on dp x
sp x ep, tp x pp x sp and dp x tp x sp: sp is a model axis; ``4d`` and
``5d`` are built by the slow goldens of ``tests/test_torch_sp_5d.py``).
fsdp under pp raises JAX's ``NotImplementedError`` before any process
group is touched.
"""

import numpy as np
import pytest
import torch

from _torch_dist import run_world
from _torch_dist_cases import strategy_case, strategy_roles
from quintnet_tpu.core.config import Config as JaxConfig
from quintnet_tpu.parallel.strategy import STRATEGY_AXES as JAX_AXES
from quintnet_tpu.parallel.strategy import get_strategy as jax_get_strategy
from quintnet_tpu_torch.core import runtime
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.parallel.strategy import STRATEGY_AXES, get_strategy


def _cfg(sizes, **training):
    return Config.from_dict({"mesh_dim": list(sizes.values()),
                             "mesh_name": list(sizes),
                             "training": training})


def test_strategy_names_are_jax_names():
    """Every strategy of the JAX package is ported: the port's table is
    JAX's, and the role cases below build those with sp too."""
    assert STRATEGY_AXES == JAX_AXES


def test_single_on_one_device():
    s = get_strategy(None, Config.from_dict({}))
    assert s.name == "single" and s.mesh.size == 1
    assert s.batch_axes == ("dp",) and s.model_axes == ()
    assert get_strategy("dp", _cfg({"dp": 1})).name == "dp"   # JAX allows


# case id -> (strategy name, mesh, training); these raised before the
# pipelines and ZeRO were ported and now build with JAX's roles
PORTED_CASES = {
    "pp": ("pp", {"pp": 2}, {}),
    "dp_pp": ("dp_pp", {"dp": 2, "pp": 2}, {}),
    "3d": ("3d", {"dp": 2, "tp": 2, "pp": 2}, {}),
    "auto_pp": (None, {"pp": 2}, {}),
    "1f1b": ("tp_pp", {"tp": 2, "pp": 2}, {"schedule": "1f1b"}),
    "zero1": ("dp", {"dp": 2}, {"optimizer": "zero1_adamw"}),
    "zero2": ("dp_tp", {"dp": 2, "tp": 2}, {"optimizer": "zero2_adam"}),
    "pp_by_name_on_one_device": ("pp", {"dp": 1}, {}),
    "fsdp_dp": ("dp", {"dp": 2}, {"fsdp": True}),
    "fsdp_dp_tp": ("dp_tp", {"dp": 2, "tp": 2}, {"fsdp": True}),
    "ep": ("ep", {"ep": 2}, {}),
    "dp_ep": ("dp_ep", {"dp": 2, "ep": 2}, {}),
    "ep_tp": ("ep_tp", {"ep": 2, "tp": 2}, {}),
    "ep_pp_1f1b": ("ep_pp", {"ep": 2, "pp": 2}, {"schedule": "1f1b"}),
    "auto_ep_zero1": (None, {"dp": 2, "ep": 2},
                      {"optimizer": "zero1_adamw"}),
    # these raised before sequence parallelism was ported
    "sp": ("sp", {"sp": 2}, {}),
    "dp_sp": (None, {"dp": 2, "sp": 2}, {}),
    "dp_sp_ep": (None, {"dp": 2, "sp": 2, "ep": 2},
                 {"optimizer": "zero1_adamw"}),
    "tp_pp_sp_1f1b": (None, {"tp": 2, "pp": 2, "sp": 2}, {"schedule": "1f1b"}),
    "dp_tp_sp_zero2": (None, {"dp": 2, "tp": 2, "sp": 2},
                       {"optimizer": "zero2_adamw"}),
}


def _jax_roles(name, sizes, training):
    s = jax_get_strategy(name, JaxConfig.from_dict({
        "mesh_dim": list(sizes.values()), "mesh_name": list(sizes),
        "training": training}))
    return {"name": s.name, "batch_axes": s.batch_axes,
            "model_axes": s.model_axes, "partial_axes": s.partial_axes,
            "zero1_axis": s.zero1_axis, "zero_stage": s.zero_stage,
            "uses_pp": s.uses_pp, "fsdp_axis": s.fsdp_axis}


@pytest.fixture(scope="module")
def roles(tmp_path_factory):
    """Every case of PORTED_CASES built on a world of its mesh's size
    (one world per size; the one-rank case in this process)."""
    by_world = {}
    for cid, (name, sizes, training) in PORTED_CASES.items():
        by_world.setdefault(int(np.prod(list(sizes.values()))), []).append(
            (cid, name, sizes, training))
    out = {}
    for n, cases in sorted(by_world.items()):
        if n == 1:
            out.update({cid: [strategy_roles(name, sizes, training)]
                        for cid, name, sizes, training in cases})
            continue
        ranks = run_world(strategy_case, n, tmp_path_factory.mktemp(f"s{n}"),
                          cases, timeout=120)
        for cid, *_ in cases:
            out[cid] = [r[cid] for r in ranks]
    return out


@pytest.mark.parametrize("case", sorted(PORTED_CASES))
def test_pp_and_zero_strategies_take_jax_roles(roles, case):
    want = _jax_roles(*PORTED_CASES[case])
    for got in roles[case]:
        assert got == want


# case id -> (strategy, mesh, training, what the NotImplementedError
# says): every strategy is ported; fsdp is refused under pp, with JAX's
# message
NOT_PORTED = {
    "fsdp": ("dp_pp", {"dp": 2, "pp": 2}, {"fsdp": True},
             "fsdp under pipeline parallelism is not wired"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_not_ported_raise_naming_their_item(case):
    name, sizes, training, says = NOT_PORTED[case]
    with pytest.raises(NotImplementedError, match=says):
        get_strategy(name, _cfg(sizes, **training))


def test_bad_names_and_meshes():
    with pytest.raises(ValueError, match="unknown strategy"):
        get_strategy("nope")
    with pytest.raises(ValueError, match="needs mesh axis 'tp'"):
        get_strategy("dp_tp", _cfg({"dp": 2, "tp": 1}))
    with pytest.raises(ValueError, match="single"):
        get_strategy("single", _cfg({"dp": 2}))
    with pytest.raises(ValueError, match="fsdp requires a dp"):
        get_strategy(None, _cfg({"dp": 1}, fsdp=True))
    with pytest.raises(RuntimeError, match="torch.distributed"):
        get_strategy("dp", _cfg({"dp": 2}))          # no world joined


def test_runtime_takes_device_and_backend_from_the_caller(monkeypatch):
    assert runtime.process_index() == 0 and runtime.process_count() == 1
    assert runtime.is_main_process() and not runtime.is_multiprocess()
    with pytest.raises(RuntimeError, match="initialize"):
        runtime.device()
    with pytest.raises(ValueError, match="rank and world_size"):
        runtime.initialize()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runtime.initialize(rank=0, world_size=1)
    with pytest.raises(ValueError, match="nccl"):
        runtime.initialize(rank=0, world_size=1, device="cpu",
                           backend="nccl")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        runtime.initialize(rank=3, world_size=4)


def test_simple_tp_example_runs_on_two_cpu_ranks(capfd):
    """``examples/simple_tp.py`` spawns the config's 2 ranks (gloo on the
    CPU, a FileStore), trains one epoch and only rank 0 prints; a rank
    that fails (``--nproc 3``: 4 heads do not split over tp = 3) makes
    the example raise."""
    from quintnet_tpu_torch.examples import simple_tp

    assert simple_tp.main(["--device", "cpu", "--epochs", "1", "--limit",
                           "64"]) is None
    out = capfd.readouterr().out
    assert out.count("strategy=tp mesh={'tp': 2} device=cpu") == 1
    assert out.count("final val_accuracy") == 1
    with pytest.raises(AssertionError, match="rank [0-2] raised"):
        simple_tp.main(["--device", "cpu", "--nproc", "3", "--epochs", "1",
                        "--limit", "64"])


def test_simple_dp_example_takes_its_world_from_nproc(capfd):
    """``--nproc 2`` trains ``dp_config.json``'s model on dp = 2 ranks,
    not the config's 4."""
    from quintnet_tpu_torch.examples import simple_dp

    assert simple_dp.main(["--device", "cpu", "--nproc", "2", "--epochs",
                           "1", "--limit", "64"]) is None
    out = capfd.readouterr().out
    assert out.count("strategy=dp mesh={'dp': 2} device=cpu") == 1


def test_simple_pp_example_runs_on_four_cpu_ranks(capfd):
    """``examples/simple_pp.py`` spawns ``pp_config.json``'s 4 stages
    (1F1B over 4 micro-batches), trains 2 steps and evaluates through the
    forward pipeline; only rank 0 prints."""
    from quintnet_tpu_torch.examples import simple_pp

    assert simple_pp.main(["--device", "cpu", "--epochs", "1", "--limit",
                           "64"]) is None
    out = capfd.readouterr().out
    assert out.count("strategy=pp mesh={'pp': 4} device=cpu") == 1
    assert out.count("final val_accuracy") == 1


def test_full_3d_example_runs_on_eight_cpu_ranks(capfd):
    """``examples/full_3d.py`` spawns ``config.json``'s 2 x 2 x 2 dp x tp x
    pp mesh (1F1B over 2 micro-batches) and trains 2 steps."""
    from quintnet_tpu_torch.examples import full_3d

    assert full_3d.main(["--device", "cpu", "--epochs", "1", "--limit",
                         "64"]) is None
    out = capfd.readouterr().out
    assert out.count("strategy=3d mesh={'dp': 2, 'tp': 2, 'pp': 2} "
                     "device=cpu") == 1
    assert out.count("final val_accuracy") == 1
