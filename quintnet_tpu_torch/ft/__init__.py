"""Fault tolerance: the train cursor, restore with fallback past damaged
steps, the save cadence, and deterministic fault injection.

Port of part of ``quintnet_tpu/ft/``: ``chaos`` (kill-at-step in every
mode, checkpoint corruption, restore failures; the serving fleet's
replica kills) is here. The preemption handler and goodput accounting
are not ported yet (ROADMAP.md §1, item 8c)."""

from quintnet_tpu_torch.ft.chaos import (CHAOS_KILL_EXIT_CODE, ChaosKilled,
                                         ChaosMonkey, corrupt_checkpoint)
from quintnet_tpu_torch.ft.cursor import TrainCursor
from quintnet_tpu_torch.ft.preempt import CadenceController
from quintnet_tpu_torch.ft.restore import restore_with_fallback

__all__ = ["CHAOS_KILL_EXIT_CODE", "CadenceController", "ChaosKilled",
           "ChaosMonkey", "TrainCursor", "corrupt_checkpoint",
           "restore_with_fallback"]
