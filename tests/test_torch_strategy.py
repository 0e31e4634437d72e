"""The port's strategy facade and runtime (parallel/strategy.py,
core/runtime.py) without a world: which strategies are ported, what the
others raise, and that the runtime takes its backend and device from the
caller.

``get_strategy`` builds ``single`` on one device here; ``auto`` picks
``dp``, ``tp`` and ``dp_tp`` on the gloo worlds of
``tests/test_torch_tp.py`` and ``tests/test_torch_dp.py`` (their runs
assert the strategy name). Every strategy that needs pp, sp or ep, and
ZeRO-1/2 and fsdp over dp, raise ``NotImplementedError`` naming their
ROADMAP.md item before any process group is touched.
"""

import pytest
import torch

from quintnet_tpu.parallel.strategy import STRATEGY_AXES as JAX_AXES
from quintnet_tpu_torch.core import runtime
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.parallel.strategy import (PORTED, STRATEGY_AXES,
                                                  get_strategy)


def _cfg(sizes, **training):
    return Config.from_dict({"mesh_dim": list(sizes.values()),
                             "mesh_name": list(sizes),
                             "training": training})


def test_strategy_names_are_jax_names():
    assert STRATEGY_AXES == JAX_AXES
    assert PORTED == ("single", "dp", "tp", "dp_tp")


def test_single_on_one_device():
    s = get_strategy(None, Config.from_dict({}))
    assert s.name == "single" and s.mesh.size == 1
    assert s.batch_axes == ("dp",) and s.model_axes == ()
    assert get_strategy("dp", _cfg({"dp": 1})).name == "dp"   # JAX allows


NOT_PORTED = {
    "pp": ("pp", {"pp": 2}, {}, "item 3c"),
    "dp_pp": ("dp_pp", {"dp": 2, "pp": 2}, {}, "item 3c"),
    "3d": ("3d", {"dp": 2, "tp": 2, "pp": 2}, {}, "item 3c"),
    "auto_pp": (None, {"pp": 2}, {}, "item 3c"),
    "1f1b": ("tp_pp", {"tp": 2, "pp": 2}, {"schedule": "1f1b"}, "item 3c"),
    "sp": ("sp", {"sp": 2}, {}, "item 6"),
    "dp_sp": (None, {"dp": 2, "sp": 2}, {}, "item 6"),
    "ep": ("ep", {"ep": 2}, {}, "item 4"),
    "dp_ep": ("dp_ep", {"dp": 2, "ep": 2}, {}, "item 4"),
    "zero1": ("dp", {"dp": 2}, {"optimizer": "zero1_adamw"}, "item 3c"),
    "zero2": ("dp_tp", {"dp": 2, "tp": 2}, {"optimizer": "zero2_adam"},
              "item 3c"),
    "fsdp": ("dp", {"dp": 2}, {"fsdp": True}, "item 3c"),
    "pp_by_name_on_one_device": ("pp", {"dp": 1}, {}, "item 3c"),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_not_ported_raise_naming_their_item(case):
    name, sizes, training, item = NOT_PORTED[case]
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, §1, {item}"):
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
