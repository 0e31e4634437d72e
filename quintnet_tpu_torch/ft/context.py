"""FTContext: the one optional argument that fault tolerance adds to
``Trainer.fit``.

Port of ``quintnet_tpu/ft/context.py``. The loop asks three questions
after each step: record this step? (goodput), inject a fault? (chaos),
were we asked to stop? (preemption). Any member may be None; a context
with none is the same as passing none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from quintnet_tpu_torch.ft.chaos import ChaosMonkey
from quintnet_tpu_torch.ft.goodput import GoodputMeter
from quintnet_tpu_torch.ft.preempt import PreemptionHandler


@dataclass
class FTContext:
    preemption: Optional[PreemptionHandler] = None
    chaos: Optional[ChaosMonkey] = None
    goodput: Optional[GoodputMeter] = None

    @property
    def preemption_requested(self) -> bool:
        """This process's flag (on a mesh ``Trainer.fit`` makes it the
        world's)."""
        return self.preemption is not None and self.preemption.triggered
