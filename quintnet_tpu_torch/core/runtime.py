"""Process bootstrap: one process per rank, joined by ``torch.distributed``.

Port of ``quintnet_tpu/core/runtime.py``. The JAX package joins its
processes with ``jax.distributed.initialize`` and then runs one SPMD
program over every device; the port runs one process per rank (the
reference's torchrun model) and joins them with
``torch.distributed.init_process_group``.

Both the backend and the device are the caller's: ``"nccl"`` is the
default for CUDA devices and ``"gloo"`` for the CPU, a caller may pass
``"gloo"`` with CUDA devices (several ranks sharing one card, where NCCL
refuses two ranks of one communicator on one device), and nothing
switches backend or device by itself. The JAX module's host-data
helpers (``global_array_from_host_data`` and friends) place shards of a
global array; the port's ranks hold their own shards, cut by
``parallel/strategy.Strategy.shard_batch``. :func:`spawn_world` starts
the ranks of a world on this host (the examples, tests and the chip
check); ``torchrun`` starts them otherwise.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from quintnet_tpu_torch.core.device import resolve_device


# the device ``initialize`` resolved for this process (one rank a process)
_joined = {"device": None}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize(*, backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               device=None) -> torch.device:
    """Join this process to the process group; returns its device.

    Without arguments the rank, world size and local rank come from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and
    ``init_method`` is ``env://``. ``device`` defaults to
    ``cuda:{LOCAL_RANK}``; a local rank at or past
    ``torch.cuda.device_count()`` raises unless the caller names the
    device (ranks that share a card pass ``"cuda:0"``). ``backend``
    defaults to ``"nccl"`` on CUDA and ``"gloo"`` on the CPU."""
    rank = _env_int("RANK") if rank is None else int(rank)
    world_size = (_env_int("WORLD_SIZE") if world_size is None
                  else int(world_size))
    if rank is None or world_size is None:
        raise ValueError(
            "initialize needs rank and world_size (or torchrun's RANK and "
            "WORLD_SIZE in the environment)")
    local_rank = _env_int("LOCAL_RANK")
    if device is None:
        local = rank if local_rank is None else local_rank
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize: no device named and CUDA is not available; "
                "pass device='cpu' (with backend='gloo') to run on the CPU")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"initialize: local rank {local} has no card of its own "
                f"({torch.cuda.device_count()} visible); name the device "
                f"(e.g. device='cuda:0' with backend='gloo' for ranks that "
                f"share one card)")
        device = f"cuda:{local}"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend 'nccl' needs CUDA devices; use 'gloo' on "
                         "the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    _joined["device"] = dev
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _joined["device"] = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Gate for host-side logging and IO: rank 0 only."""
    return process_index() == 0


def is_multiprocess() -> bool:
    return process_count() > 1


def device() -> torch.device:
    """The device :func:`initialize` gave this rank; raises before it."""
    if _joined["device"] is None:
        raise RuntimeError("runtime.device() before runtime.initialize()")
    return _joined["device"]


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any rank of the world
    (one max all-reduce through the default group: a CPU tensor on gloo,
    this rank's device on NCCL): how the ranks turn a local observation
    into one decision of the whole world. Without a world, ``flag``
    itself."""
    if not is_multiprocess():
        return bool(flag)
    dev = "cpu" if dist.get_backend() == "gloo" else device()
    t = torch.tensor([int(bool(flag))], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank of the world;
    without a world, ``obj`` itself."""
    if not is_multiprocess():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=device())
    return box[0]


def barrier() -> None:
    """Wait for every rank of the world (a no-op without one)."""
    if is_multiprocess():
        dist.barrier()


def _rank_main(rank, world, store, fn, args, results):
    try:
        results.put((rank, True, fn(rank, world, store, *args)))
    except BaseException:  # noqa: B036 -- reported; the parent raises
        results.put((rank, False, traceback.format_exc()))


def spawn_world(fn, world: int, *args, timeout: Optional[float] = None,
                store_dir: Optional[str] = None) -> list:
    """``[fn(rank, world, store, *args) for rank in range(world)]``, each
    rank a process of its own (``spawn``: nothing is inherited, so ``fn``
    must be importable by name), returned by rank. ``store`` is the path
    of a ``FileStore`` (in a fresh directory under ``store_dir``) for
    ``init_method=f"file://{store}"``; ``fn`` joins the world itself.

    A rank that raises or dies, or a world not done within ``timeout``
    seconds (None: no limit), raises ``AssertionError`` here, after every
    rank is stopped."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, store, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while len(got) < world:
                left = 1.0 if deadline is None else (
                    deadline - time.monotonic())
                if left <= 0:
                    raise AssertionError(
                        f"{fn.__name__}: {world} ranks not done in "
                        f"{timeout} s (done: {sorted(got)})")
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got
                            and p.exitcode not in (None, 0)]
                    if dead:
                        raise AssertionError(
                            f"{fn.__name__}: rank(s) {dead} died (exit "
                            f"codes {[procs[r].exitcode for r in dead]})")
                    continue
                if not ok:
                    raise AssertionError(f"{fn.__name__}: rank {rank} "
                                         f"raised:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            results.close()
    return [got[r] for r in range(world)]
