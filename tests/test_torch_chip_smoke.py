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
