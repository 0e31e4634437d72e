"""Preemption handling and the checkpoint cadence.

Port of ``quintnet_tpu/ft/preempt.py``. A preemption notice arrives as
SIGTERM (Ctrl-C sends SIGINT). The handler only sets a flag: the train
loop finishes the in-flight step, flushes its loss record, writes one
synchronous emergency snapshot and raises :class:`TrainingPreempted`.
Entry points turn that into ``sys.exit(PREEMPTED_EXIT_CODE)``, so a
supervisor (``quintnet_tpu_torch/tools/ft_run.py``) can tell "preempted,
relaunch me" from a real failure.

On a mesh every rank is its own process, and a signal may reach only
one of them: ``Trainer.fit`` makes the flag a decision of the whole
world after each step (an all-reduced OR), so every rank writes the
same emergency step and raises at the same global step.
"""

from __future__ import annotations

import signal
import time
from typing import Optional

# EX_TEMPFAIL: "transient failure, retry", the contract with the
# supervisor's restart loop (tools/ft_run.py)
PREEMPTED_EXIT_CODE = 75


class TrainingPreempted(Exception):
    """Raised by ``Trainer.fit`` after the emergency snapshot landed.

    Carries where the run stopped so entry points can log it; the
    snapshot itself holds everything a restart needs."""

    def __init__(self, epoch: int, step_in_epoch: int, global_step: int):
        super().__init__(
            f"preempted at epoch {epoch} step {step_in_epoch} "
            f"(global step {global_step}); emergency snapshot saved")
        self.epoch = epoch
        self.step_in_epoch = step_in_epoch
        self.global_step = global_step


class PreemptionHandler:
    """Context manager turning SIGTERM/SIGINT into a flag to poll.

    The signal handler only sets the flag (async-signal-safe by
    construction); ``Trainer.fit`` polls :attr:`triggered` after every
    step. A repeated signal stays one flag: a second SIGTERM during the
    emergency save does not interrupt it. ``request()`` sets the flag
    from code (tests, fault injection). ``signal.signal`` works in the
    main thread only, so the process that trains enters the handler in
    its main thread."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._triggered = False
        self._prev = {}

    @property
    def triggered(self) -> bool:
        return self._triggered

    def request(self, signum: Optional[int] = None, frame=None) -> None:
        del frame
        self._triggered = True
        self._signum = signum

    def __enter__(self) -> "PreemptionHandler":
        for s in self.signals:
            self._prev[s] = signal.signal(s, self.request)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return None


class CadenceController:
    """Save-every-N-steps and/or T-seconds decision, OR-combined.

    Both default to off (0): the trainer then saves at epoch ends only.
    The clock arms from the previous save (or construction), so a
    T-second cadence does not fire on step 1."""

    def __init__(self, every_steps: int = 0, every_seconds: float = 0.0):
        self.every_steps = int(every_steps or 0)
        self.every_seconds = float(every_seconds or 0.0)
        self._last_save_t = time.time()
        self._last_save_step = 0

    @property
    def enabled(self) -> bool:
        return self.every_steps > 0 or self.every_seconds > 0

    def should_save(self, global_step: int) -> bool:
        if not self.enabled:
            return False
        if (self.every_steps
                and global_step - self._last_save_step >= self.every_steps):
            return True
        return bool(self.every_seconds
                    and time.time() - self._last_save_t >= self.every_seconds)

    def saved(self, global_step: int) -> None:
        """Re-arm after any save (cadence, epoch end or emergency)."""
        self._last_save_step = global_step
        self._last_save_t = time.time()
