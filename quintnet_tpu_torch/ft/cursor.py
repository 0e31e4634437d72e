"""TrainCursor: the host-side train state that makes resume step-granular.

Port of ``quintnet_tpu/ft/cursor.py``. Parameters and optimizer state
survive a kill in the checkpoint's state file (``train/checkpoint.py``);
the cursor carries what the host tracks — which step of which epoch
comes next, the loss record of the epoch so far, and the run's
``History`` — as JSON in the same step directory, so the two commit
together.

No generator state is needed: the dropout generator of a step is seeded
from (config seed, epoch, step) (``Trainer.step_generator``), and the
data order is a pure function of (epoch seed, step) for the map-style
iterators in ``data/datasets.py``, so replaying from (epoch,
step_in_epoch) reproduces the uninterrupted run bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from quintnet_tpu_torch.train.trainer import History

CURSOR_VERSION = 1


@dataclass
class TrainCursor:
    """Points at the NEXT unit of work: an end-of-epoch save carries
    ``(epoch + 1, 0)``, a cadence save after batch ``i`` ``(epoch, i +
    1)``.

    ``loss_sum`` / ``loss_count``: the epoch's loss record so far as a
    sequential float64 running sum, which a resumed run continues
    (JSON round-trips binary64 exactly), so the epoch mean is
    bit-identical and the cursor stays O(1) however long the epoch."""

    epoch: int = 0
    step_in_epoch: int = 0
    global_step: int = 0
    loss_sum: float = 0.0
    loss_count: int = 0
    history: History = field(default_factory=History)
    seed: Optional[int] = None
    version: int = CURSOR_VERSION

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["history"] = dataclasses.asdict(self.history)
        return d

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["TrainCursor"]:
        """Tolerant inverse of :meth:`to_dict` (unknown keys from a newer
        writer are dropped, missing keys default)."""
        if not d:
            return None
        d = dict(d)
        hist_raw = d.pop("history", None) or {}
        names = {f.name for f in dataclasses.fields(History)}
        history = History(**{k: v for k, v in hist_raw.items() if k in names})
        names = {f.name for f in dataclasses.fields(TrainCursor)}
        cur = TrainCursor(**{k: v for k, v in d.items() if k in names})
        cur.history = history
        return cur
