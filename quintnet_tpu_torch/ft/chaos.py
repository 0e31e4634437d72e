"""Deterministic fault injection for the fault-tolerance test story.

A resume path that is never exercised is broken by default; this module
makes faults repeatable so tests and the ``tools/ft_run.py`` supervisor
can inject them at an exact step and assert bit-identical recovery.

Three fault families:

- **kill-at-step-K** (:class:`ChaosMonkey`): after step K completes,
  die. ``mode='hard'`` is ``os._exit`` — no atexit, no finally, no
  flush, the closest a test gets to a yanked node; ``mode='sigterm'``
  delivers a real SIGTERM to self, exercising the graceful
  :class:`~quintnet_tpu_torch.ft.preempt.PreemptionHandler` path;
  ``mode='raise'`` raises :class:`ChaosKilled` for in-process tests
  that need to keep the interpreter (and then build a fresh Trainer to
  resume).
- **checkpoint corruption** (:func:`corrupt_checkpoint`): truncate or
  scribble over an array file inside a committed checkpoint step directory —
  the restore path must detect it and fall back to the previous step
  (ft/restore.py).
- **restore failure** (``fail_restores=N``): the first N restore
  attempts raise, exercising the fallback loop without touching disk.

Configuration is programmatic or via the ``QT_CHAOS`` env var (JSON,
e.g. ``{"kill_at_step": 7, "mode": "hard"}``) — the env route is how
the supervisor arms a fault in a child process it is about to launch.

Port of ``quintnet_tpu/ft/chaos.py`` (standard library only).
"""

from __future__ import annotations

import json
import os
import signal
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Distinct from PREEMPTED_EXIT_CODE (graceful): a hard chaos kill looks
# like an unannounced node loss. Supervisors restart on both.
CHAOS_KILL_EXIT_CODE = 113

CHAOS_ENV = "QT_CHAOS"


class ChaosKilled(Exception):
    """In-process stand-in for a hard kill (``mode='raise'``)."""

    def __init__(self, global_step: int):
        super().__init__(f"chaos kill after global step {global_step}")
        self.global_step = global_step


@dataclass
class ChaosMonkey:
    """Kill/fail injector polled by the train loop (via ``FTContext``)
    and by serving-fleet replica threads (quintnet_tpu/fleet/).

    ``kill_at_step`` counts GLOBAL steps (monotone across epochs and
    restarts), so a relaunched run armed with a later step resumes,
    passes its old death point, and dies at the new one — exactly the
    repeated-preemption scenario the supervisor test replays. When a
    fleet replica polls the monkey, the counter is that REPLICA's
    engine-step count.

    ``target`` names the fleet replica the fault is armed against
    (e.g. ``"r1"``); ``None`` targets the process/first replica.
    In-process replica kills must use ``mode='raise'`` —
    ``hard``/``sigterm`` take down the whole process, which is the
    ``tools/ft_run.py`` supervisor story (and, for serving, exactly
    what a PROCESS replica of fleet/proc.py arms: the child vanishes
    mid-step like a SIGKILL'd node). ``mode='stall'`` is the wedge
    injector: the process neither dies nor raises — it just stops
    stepping AND stops heartbeating while keeping its sockets open, so
    the missed-heartbeat detection path is testable separately from
    clean death (readers poll :attr:`stalled`). ``rearm=True`` lets a
    fleet re-arm the monkey each time it restarts the dead replica
    (repeated-failure injection for the circuit breaker) — stall
    rearm matches the kill semantics: the restarted replica's fresh
    step counter re-triggers at ``kill_at_step``; the default fires
    once.
    """

    kill_at_step: Optional[int] = None
    mode: str = "hard"  # hard | sigterm | raise | stall
    fail_restores: int = 0
    target: Optional[str] = None
    rearm: bool = False
    # KV-handoff fault (disaggregated serving, fleet/proc.py): fired
    # when the armed replica participates in a prefill→decode KV
    # transfer. 'kill' = the exporting process dies mid-transfer (an
    # abrupt exit, no reply ever sent); 'corrupt' = the exported frame
    # is bit-flipped AFTER its checksum was computed, so the importer
    # must detect it; 'stall' = the receiving side sits on the frame
    # past the dispatcher's handoff timeout. Fires once per arming
    # (``rearm=True`` re-fires on every transfer — how tests exhaust
    # the retry budget and force the local re-prefill fallback).
    handoff: Optional[str] = None   # kill | corrupt | stall
    # how long 'stall' sits on a frame — must exceed the dispatcher's
    # handoff timeout to inject anything (ProcessFleet defaults
    # handoff_timeout_s=60; a shorter sleep is just a slow success)
    handoff_stall_s: float = 90.0
    killed: bool = field(default=False, init=False)
    stalled: bool = field(default=False, init=False)
    handoff_fired: bool = field(default=False, init=False)
    restore_failures_injected: int = field(default=0, init=False)

    @staticmethod
    def from_env(env: Optional[dict] = None) -> Optional["ChaosMonkey"]:
        raw = (env if env is not None else os.environ).get(CHAOS_ENV)
        if not raw:
            return None
        spec = json.loads(raw)
        return ChaosMonkey(
            kill_at_step=spec.get("kill_at_step"),
            mode=spec.get("mode", "hard"),
            fail_restores=int(spec.get("fail_restores", 0)),
            target=spec.get("target"),
            rearm=bool(spec.get("rearm", False)),
            handoff=spec.get("handoff"),
            handoff_stall_s=float(spec.get("handoff_stall_s", 90.0)))

    def on_step_end(self, global_step: int) -> None:
        """Die if the armed step was just completed (idempotent: the
        sigterm path keeps stepping until the handler-driven snapshot
        lands, and must not re-signal every step)."""
        if self.killed or self.kill_at_step is None:
            return
        if global_step < self.kill_at_step:
            return
        self.killed = True
        if self.mode == "stall":
            # the wedge: no exception, no exit — the poller observes
            # `stalled` and stops making progress/heartbeating while
            # its connections stay open (fleet/proc.py replica_main)
            self.stalled = True
            return
        if self.mode == "raise":
            raise ChaosKilled(global_step)
        if self.mode == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        # hard: emit the one marker line the supervisor uses to account
        # lost work, then vanish without cleanup.
        print(json.dumps({"ft_kill": {"global_step": global_step}}),
              flush=True)
        sys.stdout.flush()
        os._exit(CHAOS_KILL_EXIT_CODE)

    def fire_handoff(self, kinds: Optional[Tuple[str, ...]] = None
                     ) -> Optional[str]:
        """Consume the armed KV-handoff fault: returns its kind
        ('kill'/'corrupt'/'stall') exactly once per arming — or every
        time with ``rearm=True``, which is how a test makes the
        dispatcher's retry budget run dry — and ``None`` otherwise.
        The CALLER injects the fault (the replica process serving the
        kv_export/kv_import frame, fleet/proc.py replica_main); the
        monkey only decides whether this transfer is the unlucky one.
        ``kinds`` restricts which faults THIS site can inject: an
        armed fault of another kind is left armed — NOT consumed — so
        e.g. 'corrupt' armed against a decode replica (whose import
        handler cannot flip an outgoing frame) stays live instead of
        silently burning its one shot."""
        if self.handoff is None or (self.handoff_fired
                                    and not self.rearm):
            return None
        if kinds is not None and self.handoff not in kinds:
            return None
        self.handoff_fired = True
        return self.handoff

    def rearm_now(self) -> None:
        """Reset the fired state so the fault triggers again (the
        fleet calls this when restarting a chaos-killed replica with
        ``rearm=True``). Stall and kill share the semantics: the
        restarted replica's fresh step counter re-arms the same
        ``kill_at_step``."""
        self.killed = False
        self.stalled = False
        self.handoff_fired = False

    def on_restore_attempt(self, step: int) -> None:
        """Raise for the first ``fail_restores`` attempts (counted across
        steps — the fallback loop's retry IS the next attempt)."""
        if self.restore_failures_injected < self.fail_restores:
            self.restore_failures_injected += 1
            raise OSError(
                f"chaos: injected restore failure for step {step} "
                f"({self.restore_failures_injected}/{self.fail_restores})")


def _step_array_files(ckpt_dir: str, step: int) -> List[str]:
    """Array-payload files inside one committed checkpoint step directory,
    largest first (corrupting metadata would be caught by a cheaper
    parse; the interesting fault is a torn data write)."""
    root = os.path.join(ckpt_dir, str(step))
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no step directory {root}")
    files = []
    for r, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(r, n)
            files.append((os.path.getsize(p), p))
    if not files:
        raise FileNotFoundError(f"step directory {root} has no files")
    return [p for _sz, p in sorted(files, reverse=True)]


def corrupt_checkpoint(ckpt_dir: str, step: int, *,
                       kind: str = "truncate") -> str:
    """Damage a committed checkpoint step in place; returns the path hit.

    ``truncate`` halves the largest payload file (torn write);
    ``scribble`` flips bytes mid-file keeping the size (bit rot);
    ``unlink`` removes the file outright (lost object).
    """
    path = _step_array_files(ckpt_dir, step)[0]
    size = os.path.getsize(path)
    if kind == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
    elif kind == "scribble":
        with open(path, "r+b") as f:
            f.seek(max(size // 2 - 8, 0))
            f.write(b"\xde\xad\xbe\xef" * 4)
    elif kind == "unlink":
        os.unlink(path)
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    return path
