"""The port's utilities on the CPU: the logger, step timing, the
profiler trace and the memory report (quintnet_tpu_torch/utils/)."""

import json
import logging

import pytest
import torch

from quintnet_tpu_torch.utils import logger, profiling


def test_setup_logging_tees_to_a_file_and_log_once_dedups(tmp_path, capsys):
    log = logger.setup_logging(str(tmp_path), name="qt-test")
    logger.log_once(log, "hello")
    logger.log_once(log, "hello")
    other = logger.setup_logging(name="qt-test-other")
    logger.log_once(other, "hello")          # another logger: logged
    for h in log.handlers:
        h.flush()
    text = (tmp_path / "qt-test.log").read_text()
    assert text.count("hello") == 1
    assert capsys.readouterr().out.count("hello") == 2
    assert log.level == logging.INFO


def test_step_timer_summary():
    t = profiling.StepTimer()
    assert t.summary() == {"steps": 0, "mean_s": 0.0, "p50_s": 0.0,
                           "p99_s": 0.0}
    for _ in range(3):
        t.start()
        torch.ones(8).sum()
        t.stop()
    s = t.summary()
    assert s["steps"] == 3 and s["mean_s"] >= 0.0
    with pytest.raises(RuntimeError, match="without start"):
        t.stop()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.randn(16, 16) @ torch.randn(16, 16)
    assert prof.key_averages()
    events = json.loads((tmp_path / "trace.json").read_text())
    assert "traceEvents" in events


def test_memory_stats_and_sync_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the report is not empty")
    assert profiling.device_memory_stats() == {}
    profiling.sync()                          # a no-op, not an error

    @profiling.profile_time
    def f(x):
        return x + 1

    assert f(1) == 2
