"""Goodput accounting: how much of the wall clock bought training.

Port of ``quintnet_tpu/ft/goodput.py``, with the same report keys and
the same JSON markers. Terms:

- **useful step time**: time spent computing steps that survive into
  the final model. With step-granular resume the surviving steps are
  ``0..final_step``; steps run after the last checkpoint before a kill
  are run again by the next attempt and count as lost.
- **checkpoint overhead**: host-blocking time inside save calls (the
  port's saves are synchronous: all of their time).
- **restore overhead**: time restoring state at (re)start.

One meter lives per process (attempt); the supervisor
(``quintnet_tpu_torch/tools/ft_run.py``) merges the attempts' reports
into the run's record with :func:`aggregate`. Step timing is the wall
clock around the loop. CUDA launches are asynchronous, so the host can
run ahead of the card: :meth:`GoodputMeter.report` first waits for the
device of the last recorded loss, or it would count host time as step
time.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

import torch


class GoodputMeter:
    def __init__(self, *, emit_markers: bool = False):
        # emit_markers: print a one-line JSON marker at resume, so a
        # supervisor can account the work lost by hard kills (such an
        # attempt never lives to emit its report; the supervisor
        # reconstructs steps_run = kill_step - resumed_at from markers)
        self.emit_markers = emit_markers
        self.t_start = time.time()
        self.resumed_at: Optional[int] = None  # global step continued from
        self.reached: int = 0                  # last completed global step
        self.steps_run: int = 0
        self.save_s: float = 0.0               # host-blocking save time
        self.restore_s: float = 0.0
        self.fallback_steps: int = 0           # damaged steps skipped
        self._last_result = None               # the last step's loss

    # -- hooks called by Trainer.fit -----------------------------------
    def on_resume(self, global_step: int, restore_s: float,
                  fallback_steps: int = 0) -> None:
        self.resumed_at = global_step
        self.reached = max(self.reached, global_step)
        self.restore_s += restore_s
        self.fallback_steps += fallback_steps
        if self.emit_markers:
            print(json.dumps({"ft_start": {"resumed_at": global_step}}),
                  flush=True)

    def on_step(self, global_step: int, result=None) -> None:
        """``result``: a tensor the step produced (its loss), kept and
        not read, so :meth:`report` can wait for the last step's device
        work before it reads the clock."""
        self.steps_run += 1
        self.reached = global_step
        if result is not None:
            self._last_result = result

    def on_save(self, blocking_s: float) -> None:
        self.save_s += blocking_s

    # -- reporting -----------------------------------------------------
    def report(self, *, completed: bool) -> Dict[str, Any]:
        last = self._last_result
        if torch.is_tensor(last) and last.device.type == "cuda":
            # the queued work ends before the clock is read: wall_s then
            # covers what the card did, not what the host launched
            torch.cuda.synchronize(last.device)
        self._last_result = None
        wall = time.time() - self.t_start
        return {
            "resumed_at": self.resumed_at or 0,
            "reached": self.reached,
            "steps_run": self.steps_run,
            "wall_s": round(wall, 4),
            "save_blocking_s": round(self.save_s, 4),
            "restore_s": round(self.restore_s, 4),
            "fallback_steps": self.fallback_steps,
            "completed": bool(completed),
        }

    def emit(self, *, completed: bool) -> None:
        """One marker line on stdout for the supervisor to collect."""
        print(json.dumps({"ft_attempt": self.report(completed=completed)}),
              flush=True)


def aggregate(attempts, *, wall_s: float,
              final_step: Optional[int] = None) -> Dict[str, Any]:
    """Merge per-attempt reports into the run's goodput record.

    ``attempts``: the ``ft_attempt`` dicts in the order the supervisor
    collected them. A hard-killed attempt emits none: the supervisor
    makes one from the ``ft_start``/``ft_kill`` markers and tags it
    ``synthetic`` (its wall clock is unknown, so it adds lost steps but
    no step timing). ``wall_s``: the supervisor's wall clock, with the
    process start-ups and restart gaps the attempts cannot see.

    ``final_step``: for a run that never completed, the last step known
    to be checkpointed. A killed attempt may have reached further, but
    steps past the last checkpoint survive into no model: they are lost,
    not useful."""
    steps_run = sum(a["steps_run"] for a in attempts)
    # useful steps: where the surviving trajectory ended
    final = max((a["reached"] for a in attempts
                 if a.get("completed")), default=0) \
        or int(final_step or 0)
    lost = max(steps_run - final, 0)
    timed = [a for a in attempts if not a.get("synthetic")]
    save_s = sum(a["save_blocking_s"] for a in timed)
    restore_s = sum(a["restore_s"] for a in timed)
    child_wall = sum(a["wall_s"] for a in timed)
    timed_steps = sum(a["steps_run"] for a in timed)
    step_s = ((child_wall - save_s - restore_s) / timed_steps
              if timed_steps else 0.0)
    useful_s = final * step_s
    return {
        "goodput": round(useful_s / wall_s, 4) if wall_s > 0 else 0.0,
        "useful_steps": final,
        "steps_run": steps_run,
        "lost_steps": lost,
        "step_time_s": round(step_s, 4),
        "checkpoint_overhead_s": round(save_s, 4),
        "restore_overhead_s": round(restore_s, 4),
        "wall_s": round(wall_s, 4),
        "attempts": len(attempts),
    }
