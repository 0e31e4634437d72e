"""Integrity-checked restore: fall back to the previous good checkpoint.

Port of ``quintnet_tpu/ft/restore.py``. A truncated state file or a
lost cursor must cost one checkpoint interval, not the run: the steps
are tried newest first, and the newest one whose state and cursor both
load is returned. On a mesh the walk is a decision of the whole world:
the ranks try the same steps (rank 0's listing) and pass a step only
when every rank loaded its part of it (an all-reduced flag), so a rank
whose file is damaged never resumes from another step than its peers.
``chaos`` (a :class:`~quintnet_tpu_torch.ft.chaos.ChaosMonkey`) may fail
an attempt on purpose before it reads anything (tests, the
``tools/ft_run.py`` supervisor).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from quintnet_tpu_torch.core import runtime
from quintnet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 CheckpointRestoreError,
                                                 MeshMismatchError)


def restore_with_fallback(
    mgr: CheckpointManager,
    template: Any = None,
    *,
    specs: Any = None,
    chaos=None,
    log: Callable[[str], None] = print,
) -> Tuple[Any, Optional[dict], int, List[int]]:
    """Restore the newest checkpoint that loads (``specs``: as
    :meth:`CheckpointManager.restore` takes them).

    Returns ``(state, cursor_dict, step, skipped_steps)``: ``cursor_dict``
    is None for a step saved without a cursor, ``skipped_steps`` the
    newer steps that failed (newest first). Raises
    :class:`FileNotFoundError` when the directory holds no step, and
    :class:`CheckpointRestoreError` when every step is bad; a
    :class:`MeshMismatchError` is no damaged step and is raised as it
    is. On a mesh every rank of the world calls this together.

    ``chaos``: its ``on_restore_attempt(step)`` runs before each attempt
    and may raise, which fails that attempt as a damaged step would."""
    world = mgr.mesh is not None
    steps = sorted(mgr.all_steps(), reverse=True)
    if world:
        steps = runtime.broadcast_object(steps)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {mgr.directory}")
    skipped: List[int] = []
    last_err: Optional[Exception] = None
    for step in steps:
        err = None
        try:
            if chaos is not None:
                chaos.on_restore_attempt(step)
            state = mgr.restore(template, step=step, specs=specs)
            cursor = mgr.restore_cursor(step=step)
        except MeshMismatchError:
            raise
        except (CheckpointRestoreError, OSError, ValueError) as e:
            err = e
        bad = runtime.any_rank(err is not None) if world else err is not None
        if not bad:
            if skipped:
                log(f"checkpoint fallback: step(s) {skipped} corrupt, "
                    f"resuming from previous good step {step}")
            return state, cursor, step, skipped
        if err is None:
            err = CheckpointRestoreError(
                mgr.directory, step, available=[],
                cause="another rank failed to restore its part")
        log(f"checkpoint step {step} failed to restore: {err}")
        skipped.append(step)
        last_err = err
    raise CheckpointRestoreError(
        mgr.directory, steps[0], available=[],
        cause=f"all {len(steps)} step(s) failed integrity "
              f"(tried {steps}); last error: {last_err}")
