"""The checkpoint cadence: save every N steps and/or T seconds.

Port of ``CadenceController`` from ``quintnet_tpu/ft/preempt.py``. The
preemption handler (SIGTERM -> emergency snapshot) is not ported yet
(ROADMAP.md §1, item 8c).
"""

from __future__ import annotations

import time


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
        """Re-arm after any save (cadence or epoch end)."""
        self._last_save_step = global_step
        self._last_save_t = time.time()
