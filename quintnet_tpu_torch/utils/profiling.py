"""Profiling: step timing, profiler traces, device memory.

Port of ``quintnet_tpu/utils/profiling.py``:

- :func:`sync`, :func:`profile_time`, :class:`StepTimer`: wall-clock
  timing that waits for the card (``torch.cuda.synchronize``) before it
  reads the clock;
- :func:`trace`: ``torch.profiler`` over CPU and CUDA activity, written
  as a Chrome trace (Perfetto loads it);
- :func:`device_memory_stats`: live, peak and total bytes per card from
  ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def sync(x: Any = None) -> None:
    """Wait for the work queued on the card (a no-op without CUDA). ``x``
    is accepted for the reference's signature: the port's streams are
    synchronised whole."""
    del x
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def profile_time(fn: Callable) -> Callable:
    """Decorator: prints the wall time of each call, synced."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(out)
        print(f"[profile] {fn.__name__}: {time.perf_counter() - t0:.4f}s")
        return out

    return wrapped


class StepTimer:
    """Collects per-step durations; reports mean/p50/p99 (the first step,
    which pays the kernels' first launch, is left out when there are
    others)."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        sync()
        self._t0 = time.perf_counter()

    def stop(self, out: Any = None):
        sync(out)
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0, "mean_s": 0.0, "p50_s": 0.0, "p99_s": 0.0}
        a = np.asarray(self.times[1:] or self.times)
        return {"steps": len(self.times), "mean_s": float(a.mean()),
                "p50_s": float(np.percentile(a, 50)),
                "p99_s": float(np.percentile(a, 99))}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body with ``torch.profiler`` (CPU, and CUDA when
    there is a card) and write ``<logdir>/trace.json``. Yields the
    profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """``{"cuda:N": {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` for
    every card (empty without CUDA)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory)}
    return out
