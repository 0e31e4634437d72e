"""Integrity-checked restore: fall back to the previous good checkpoint.

Port of ``quintnet_tpu/ft/restore.py``. A truncated state file or a
lost cursor must cost one checkpoint interval, not the run: the steps
are tried newest first, and the newest one whose state and cursor both
load is returned. The ``chaos`` hook of the reference (fault injection)
is not ported yet (ROADMAP.md §1, item 8).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from quintnet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                 CheckpointRestoreError)


def restore_with_fallback(
    mgr: CheckpointManager,
    template: Any = None,
    *,
    log: Callable[[str], None] = print,
) -> Tuple[Any, Optional[dict], int, List[int]]:
    """Restore the newest checkpoint that loads.

    Returns ``(state, cursor_dict, step, skipped_steps)``: ``cursor_dict``
    is None for a step saved without a cursor, ``skipped_steps`` the
    newer steps that failed (newest first). Raises
    :class:`FileNotFoundError` when the directory holds no step, and
    :class:`CheckpointRestoreError` when every step is bad."""
    steps = sorted(mgr.all_steps(), reverse=True)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {mgr.directory}")
    skipped: List[int] = []
    last_err: Optional[Exception] = None
    for step in steps:
        try:
            state = mgr.restore(template, step=step)
            cursor = mgr.restore_cursor(step=step)
            if skipped:
                log(f"checkpoint fallback: step(s) {skipped} corrupt, "
                    f"resuming from previous good step {step}")
            return state, cursor, step, skipped
        except (CheckpointRestoreError, OSError, ValueError) as e:
            log(f"checkpoint step {step} failed to restore: {e}")
            skipped.append(step)
            last_err = e
    raise CheckpointRestoreError(
        mgr.directory, steps[0], available=[],
        cause=f"all {len(steps)} step(s) failed integrity "
              f"(tried {steps}); last error: {last_err}")
