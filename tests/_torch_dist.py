"""Launch a gloo world of CPU processes for the port's distributed tests.

Not collected by pytest (leading underscore). ``run_world(fn, n,
tmp_path, *args)`` spawns ``n`` processes through
``core/runtime.spawn_world``, joins them with
``runtime.initialize(backend="gloo", device="cpu")`` over a ``FileStore``
under ``tmp_path`` (no ports, so concurrent xdist workers cannot
collide), runs ``fn(rank, n, *args)`` in each and returns the results by
rank. ``fn`` must be a module-level function of a module that does not
import jax (the children import it by name): the rank bodies live in
``tests/_torch_dist_cases.py``.

A rank that raises fails the call with its traceback; a world that does
not finish within ``timeout`` seconds fails it too. Either way every
child is stopped before the call returns, so a test never hangs.
"""

from __future__ import annotations

from quintnet_tpu_torch.core import runtime


def _gloo_cpu(rank, world, store, fn, *args):
    import torch

    torch.set_num_threads(1)
    runtime.initialize(backend="gloo", init_method=f"file://{store}",
                       rank=rank, world_size=world, device="cpu")
    try:
        return fn(rank, world, *args)
    finally:
        runtime.shutdown()


def run_world(fn, world: int, tmp_path, *args, timeout: float = 120.0):
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in its own process of one gloo world."""
    return runtime.spawn_world(_gloo_cpu, world, fn, *args, timeout=timeout,
                               store_dir=str(tmp_path))
