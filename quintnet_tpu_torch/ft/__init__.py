"""Fault tolerance: training that survives kills with results bit-identical
to an uninterrupted run.

Port of ``quintnet_tpu/ft/``:

- :mod:`cursor`  — ``TrainCursor``: the host-side train state (epoch,
  step, the epoch's loss sum, ``History``), saved as JSON in the same
  step directory as the parameters and the optimizer state;
- :mod:`preempt` — the SIGTERM/SIGINT handler (finish the in-flight
  step, one synchronous emergency snapshot, the exit code 75) and the
  save-every-N-steps/T-seconds cadence;
- :mod:`chaos`   — deterministic fault injection (kill at step K in every
  mode, checkpoint corruption, restore failures; the serving fleet's
  replica kills);
- :mod:`restore` — restore that falls back to the previous good step
  when the newest is damaged;
- :mod:`goodput` — useful step time over wall time (checkpoint
  overhead, work lost to each fault) for the supervisor's JSON record.

The hooks reach the training loop through one object::

    from quintnet_tpu_torch.ft import FTContext, PreemptionHandler
    with PreemptionHandler() as handler:
        trainer.fit(batches_fn, ft=FTContext(preemption=handler))

``Trainer.fit`` works unchanged without an ``FTContext``: cadence saves
alone come from ``training.save_every_steps`` /
``training.save_every_seconds``.
"""

from quintnet_tpu_torch.ft.chaos import (CHAOS_KILL_EXIT_CODE, ChaosKilled,
                                         ChaosMonkey, corrupt_checkpoint)
from quintnet_tpu_torch.ft.context import FTContext
from quintnet_tpu_torch.ft.cursor import TrainCursor
from quintnet_tpu_torch.ft.goodput import GoodputMeter
from quintnet_tpu_torch.ft.preempt import (PREEMPTED_EXIT_CODE,
                                           CadenceController,
                                           PreemptionHandler,
                                           TrainingPreempted)
from quintnet_tpu_torch.ft.restore import restore_with_fallback

__all__ = ["CHAOS_KILL_EXIT_CODE", "CadenceController", "ChaosKilled",
           "ChaosMonkey", "FTContext", "GoodputMeter", "PREEMPTED_EXIT_CODE",
           "PreemptionHandler", "TrainCursor", "TrainingPreempted",
           "corrupt_checkpoint", "restore_with_fallback"]
