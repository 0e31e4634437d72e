"""Crash-dump forensics: the fleet's black box file.

When a replica dies or stalls, the dispatcher already knows three
things the corpse can no longer tell anyone: the last step records it
shipped (the heartbeat-mirrored ring, fleet/proc.py — or the engine's
own ring for thread replicas, whose address space survives), the spans
of every request that was in flight there, and the fleet lifecycle
events leading up to the death. :func:`write_crash_dump` freezes all
three into one JSON post-mortem file at the moment of death — BEFORE
migration rewrites the routing state — so "why did p1 die at step 847
and what was it doing" has an artifact, not a shrug.

The file is one JSON object (versioned, like every wire payload in
this codebase) so ``tools/trace_view.py`` can render the embedded ring
+ spans straight into Perfetto, and tests can assert on structure
instead of scraping logs.

Port of ``quintnet_tpu/obs/crashdump.py`` (standard library only).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

DUMP_VERSION = 1

# process-wide monotone dump counter: two deaths in the same second
# (chaos tests do this on purpose) must not clobber each other's file
_seq = itertools.count()
_seq_lock = threading.Lock()


def write_crash_dump(dir_path: str, *, replica: str, reason: str,
                     error: Optional[str] = None,
                     ring: Optional[List[Dict]] = None,
                     traces: Optional[Dict[str, List[Dict]]] = None,
                     events: Optional[List[Dict]] = None,
                     requests: Optional[List[Dict]] = None,
                     signals: Optional[Dict] = None,
                     locks: Optional[Dict] = None,
                     extra: Optional[Dict] = None,
                     keep: Optional[int] = 16) -> str:
    """Write one post-mortem file; returns its path.

    ``reason`` is ``"death"`` or ``"stall"``; ``ring`` the replica's
    last-known step records (oldest first); ``traces`` the affected
    requests' span snapshot (``Tracer.snapshot``); ``events`` the
    recent fleet lifecycle events; ``requests`` per-request summaries
    (fid, trace id, tokens committed, migrations) the dispatcher's
    journal knows without any cooperation from the corpse; ``signals``
    the dispatcher's last pool-pressure snapshot
    (``SignalBus.snapshot()``) when the signal plane is armed;
    ``locks`` the lock-audit ledgers (``LockAudit.summary()``) when
    the fleet runs with ``lock_audit=True`` — "who was holding what,
    and for how long" is black-box material for a stall post-mortem.

    ``keep`` bounds the directory: after writing, only the newest
    ``keep`` ``crash_*.json`` files survive (a flapping replica must
    not grow the crash dir without limit); ``keep=None`` disables
    pruning."""
    if keep is not None and int(keep) < 1:
        # reject BEFORE writing: raising after the dump landed would
        # leave the directory growing un-pruned on every crash — the
        # exact condition the bound exists to prevent
        raise ValueError(f"keep must be >= 1 or None, got {keep}")
    os.makedirs(dir_path, exist_ok=True)
    with _seq_lock:
        n = next(_seq)
    stamp = time.strftime("%Y%m%dT%H%M%S")
    path = os.path.join(dir_path,
                        f"crash_{replica}_{stamp}_{n:04d}.json")
    payload = {
        "kind": "crash_dump",
        "v": DUMP_VERSION,
        "replica": replica,
        "reason": reason,
        "error": error,
        "written_at": time.time(),
        "ring": list(ring or []),
        "traces": {k: list(v) for k, v in (traces or {}).items()},
        "events": list(events or []),
        "requests": list(requests or []),
        "signals": dict(signals or {}),
        "locks": dict(locks or {}),
        "extra": dict(extra or {}),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)      # atomic: a reader never sees half a dump
    if keep is not None:
        _prune(dir_path, int(keep))
    return path


def _prune(dir_path: str, keep: int) -> None:
    """Keep the newest ``keep`` dump files (mtime order, name as the
    tiebreak — the stamp+seq suffix is monotone within a process).
    Concurrent writers racing a prune just lose already-deleted files,
    which is fine — pruning is best-effort housekeeping. ``keep`` is
    validated by the caller before the dump is written."""
    try:
        names = [n for n in os.listdir(dir_path)
                 if n.startswith("crash_") and n.endswith(".json")]
    except OSError:
        return
    if len(names) <= keep:
        return

    def _key(name: str):
        try:
            mtime = os.path.getmtime(os.path.join(dir_path, name))
        except OSError:
            mtime = 0.0
        return (mtime, name)

    names.sort(key=_key)
    for name in names[:len(names) - keep]:
        try:
            os.remove(os.path.join(dir_path, name))
        except OSError:
            pass


def load_crash_dump(path: str) -> Dict:
    """Read + validate one dump (version-checked, like the wire)."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("kind") != "crash_dump":
        raise ValueError(
            f"{path} is not a crash dump (kind="
            f"{payload.get('kind')!r})")
    if payload.get("v") != DUMP_VERSION:
        raise ValueError(
            f"{path} is crash-dump version {payload.get('v')!r}; this "
            f"build reads {DUMP_VERSION}")
    return payload
