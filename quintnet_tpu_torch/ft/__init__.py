"""Fault tolerance on one device: the train cursor, restore with
fallback past damaged steps, and the save cadence.

Port of part of ``quintnet_tpu/ft/``. The preemption handler, chaos
injection and goodput accounting are not ported yet (ROADMAP.md §1,
item 8)."""

from quintnet_tpu_torch.ft.cursor import TrainCursor
from quintnet_tpu_torch.ft.preempt import CadenceController
from quintnet_tpu_torch.ft.restore import restore_with_fallback

__all__ = ["CadenceController", "TrainCursor", "restore_with_fallback"]
