"""Instrumented-lock runtime: the dynamic twin of the static pass in
:mod:`~quintnet_tpu_torch.analysis.threads`.

Port of ``quintnet_tpu/analysis/lockrt.py`` (pure Python there too);
the port keeps its own copy, since nothing under ``quintnet_tpu`` is
imported at run time.

The static auditor proves lock ORDER over the paths it can resolve;
this module watches the orders that actually happen. An opt-in
:class:`InstrumentedLock` is a drop-in ``threading.Lock``/``RLock``
wrapper (context manager, ``acquire``/``release``, and the full
``threading.Condition`` protocol — ``_is_owned``/``_release_save``/
``_acquire_restore`` — so ``Condition(audit.rlock("x"))`` behaves
exactly like ``Condition()``) that records, per thread, the stack of
locks currently held. Every first-time ordered pair (held A, acquiring
B) becomes an edge in a process-local order graph with the acquiring
call stack attached; the moment the REVERSE direction is observed the
acquire raises a typed :class:`LockOrderError` naming both stacks —
the deadlock is reported at the first inverted acquisition, not on the
unlucky interleaving that would actually wedge.

Ledgers per lock: acquisitions, contended acquisitions, cumulative
wait and hold seconds, max hold, and held-too-long counts against an
optional ``hold_budget_s`` — all exported by
:meth:`LockAudit.summary` as a JSON-able dict the fleet renders into
the ``quintnet_lock_*`` Prometheus families (obs/prom.py) and embeds
in crash dumps. A held-too-long WATCHDOG is available two ways:
deterministically via :meth:`LockAudit.check_held` (tests drive it
with an injected clock) or as a daemon thread
(``watchdog_interval_s=``) for long-lived fleets.

Inert by design: ``ServeFleet``/``ProcessFleet`` grow a
``lock_audit=`` flag that swaps their locks for instrumented ones;
with the flag off nothing here is constructed and the fleet's code
path is byte-identical to before this module existed. With it on, the
bookkeeping is a few dict operations per acquisition — and the
kill-migration goldens pin that audited output is token-identical to
unaudited (tests/test_torch_qtcheck_threads.py).

Standard library only — loadable by file path like lint.py/threads.py.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple


def _stack(skip: int = 2, limit: int = 8) -> str:
    """A short formatted stack for edge provenance: the acquiring
    frames, with this module's own frames trimmed."""
    frames = traceback.extract_stack()[:-skip]
    frames = [f for f in frames if "lockrt" not in f.filename][-limit:]
    return "".join(traceback.format_list(frames)).rstrip()


class LockOrderError(RuntimeError):
    """Two locks were acquired in both orders. Raised BEFORE the
    inverting acquisition blocks, carrying both acquisition stacks —
    the would-be deadlock as a readable report instead of a hang."""

    def __init__(self, first: str, second: str, *, forward_stack: str,
                 reverse_stack: str, thread: str):
        self.first = first
        self.second = second
        self.forward_stack = forward_stack
        self.reverse_stack = reverse_stack
        self.thread = thread
        super().__init__(
            f"lock-order inversion: {first} -> {second} was recorded "
            f"earlier, and thread {thread!r} now holds {second} while "
            f"acquiring {first}.\n"
            f"--- earlier {first} -> {second} acquisition ---\n"
            f"{forward_stack}\n"
            f"--- current {second} -> {first} acquisition ---\n"
            f"{reverse_stack}")


class _Ledger:
    __slots__ = ("acquisitions", "contended", "wait_s", "hold_s",
                 "max_hold_s", "held_too_long")

    def __init__(self):
        self.acquisitions = 0
        self.contended = 0
        self.wait_s = 0.0
        self.hold_s = 0.0
        self.max_hold_s = 0.0
        self.held_too_long = 0


class _Held:
    """One entry on a thread's held stack."""

    __slots__ = ("lock", "since", "depth")

    def __init__(self, lock: "InstrumentedLock", since: float):
        self.lock = lock
        self.since = since
        self.depth = 1


class LockAudit:
    """Process-local registry: the observed lock-order graph plus the
    per-lock ledgers. One audit per fleet; every lock it mints shares
    the graph, so cross-subsystem inversions (fleet lock vs a
    replica's ring lock) are visible."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 hold_budget_s: Optional[float] = None,
                 on_violation: Optional[Callable[[Dict], None]] = None,
                 watchdog_interval_s: Optional[float] = None):
        self.clock = clock
        self.hold_budget_s = hold_budget_s
        self.on_violation = on_violation
        # graph + ledgers are mutated under their own private lock (a
        # plain one — the audit must not audit itself)
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[str, str], str] = {}   # (a, b) -> stack
        self._locks: Dict[str, InstrumentedLock] = {}
        self.order_violations = 0
        self._tls = threading.local()
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        if watchdog_interval_s is not None:
            self._watchdog = threading.Thread(
                target=self._watch_loop, args=(float(watchdog_interval_s),),
                name="lock-audit-watchdog", daemon=True)
            self._watchdog.start()

    # ---- lock minting -----------------------------------------------
    def lock(self, name: str) -> "InstrumentedLock":
        return self._mint(name, threading.Lock(), reentrant=False)

    def rlock(self, name: str) -> "InstrumentedLock":
        return self._mint(name, threading.RLock(), reentrant=True)

    def condition(self, name: str) -> threading.Condition:
        """A ``Condition`` over an instrumented RLock — the drop-in
        for ``threading.Condition()`` (whose default lock IS an
        RLock)."""
        return threading.Condition(self.rlock(name))

    def _mint(self, name: str, inner,
              reentrant: bool) -> "InstrumentedLock":
        with self._mu:
            have = self._locks.get(name)
            if have is not None:
                if have.reentrant != reentrant:
                    raise ValueError(
                        f"lock name {name!r} already minted with "
                        f"reentrant={have.reentrant} — names key the "
                        f"ledgers and the order graph, reuse across "
                        f"kinds would merge two locks' stories")
                # same name, same kind: the SAME lock (a re-armed
                # subsystem replacing its predecessor keeps the node,
                # its ledger, and its edges — one story per name)
                return have
            lk = InstrumentedLock(self, name, inner, reentrant)
            self._locks[name] = lk
            return lk

    # ---- per-thread held stack --------------------------------------
    def _held(self) -> List[_Held]:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = self._tls.held = []
        return st

    # ---- order graph -------------------------------------------------
    def _note_acquire(self, lock: "InstrumentedLock") -> None:
        """Called BEFORE blocking on ``lock``; raises on an inversion."""
        held = self._held()
        for entry in held:
            if entry.lock is lock:
                if lock.reentrant:
                    return        # re-entrant re-acquire: no new edges
                self.order_violations += 1
                raise LockOrderError(
                    lock.name, lock.name,
                    forward_stack="(self-deadlock: non-reentrant lock "
                                  "re-acquired by its owner)",
                    reverse_stack=_stack(),
                    thread=threading.current_thread().name)
        if not held:
            return
        stack = None
        with self._mu:
            for entry in held:
                a, b = entry.lock.name, lock.name
                rev = self._edges.get((b, a))
                if rev is not None:
                    self.order_violations += 1
                    info = {
                        "first": b, "second": a,
                        "thread": threading.current_thread().name,
                        "forward_stack": rev,
                        "reverse_stack": _stack(),
                    }
                    cb = self.on_violation
                    err = LockOrderError(
                        b, a, forward_stack=rev,
                        reverse_stack=info["reverse_stack"],
                        thread=info["thread"])
                    break
                if (a, b) not in self._edges:
                    if stack is None:
                        stack = _stack()
                    self._edges[(a, b)] = stack
            else:
                return
        if cb is not None:
            try:
                cb(info)
            except Exception:
                pass              # observability must not mask the error
        raise err

    def _push(self, lock: "InstrumentedLock", now: float) -> None:
        held = self._held()
        for entry in held:
            if entry.lock is lock:
                entry.depth += 1
                return
        held.append(_Held(lock, now))

    def _pop(self, lock: "InstrumentedLock", now: float,
             full: bool = False) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            entry = held[i]
            if entry.lock is not lock:
                continue
            entry.depth -= 1
            if entry.depth > 0 and not full:
                return
            del held[i]
            hold = max(now - entry.since, 0.0)
            led = lock.ledger
            with self._mu:
                led.hold_s += hold
                led.max_hold_s = max(led.max_hold_s, hold)
                if (self.hold_budget_s is not None
                        and hold > self.hold_budget_s):
                    led.held_too_long += 1
            return

    # ---- watchdog ----------------------------------------------------
    def check_held(self, now: Optional[float] = None) -> List[Dict]:
        """Held-too-long check over every lock currently held by ANY
        thread (each acquisition stamps ``holder``/``held_since`` on
        its lock). Returns the offenders; deterministic with an
        injected clock, also what the watchdog thread runs."""
        if self.hold_budget_s is None:
            return []
        now = self.clock() if now is None else now
        out = []
        with self._mu:
            for name, lk in self._locks.items():
                since = lk.held_since
                if since is None:
                    continue
                age = now - since
                if age > self.hold_budget_s:
                    lk.ledger.held_too_long += 1
                    out.append({"lock": name, "held_s": age,
                                "holder": lk.holder,
                                "budget_s": self.hold_budget_s})
        return out

    def _watch_loop(self, interval: float) -> None:
        while not self._watchdog_stop.wait(interval):
            self.check_held()

    def close(self) -> None:
        self._watchdog_stop.set()

    # ---- export ------------------------------------------------------
    def summary(self) -> Dict:
        """JSON-able ledgers: what obs/prom.py renders as the
        ``quintnet_lock_*`` families and crash dumps embed."""
        with self._mu:
            locks = {
                name: {
                    "acquisitions": lk.ledger.acquisitions,
                    "contended": lk.ledger.contended,
                    "wait_s": round(lk.ledger.wait_s, 6),
                    "hold_s": round(lk.ledger.hold_s, 6),
                    "max_hold_s": round(lk.ledger.max_hold_s, 6),
                    "held_too_long": lk.ledger.held_too_long,
                }
                for name, lk in sorted(self._locks.items())}
            return {"order_edges": len(self._edges),
                    "order_violations": self.order_violations,
                    "locks": locks}

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._edges)


class InstrumentedLock:
    """Drop-in ``threading.Lock``/``RLock`` wrapper wired to a
    :class:`LockAudit` (mint via ``audit.lock(name)`` /
    ``audit.rlock(name)``). Supports the full Condition protocol so it
    can back a ``threading.Condition`` — ``wait()`` pops the audit's
    held-stack entry on the way to sleep and re-pushes on wake, so a
    waiting thread is correctly modeled as holding nothing."""

    __slots__ = ("audit", "name", "_inner", "reentrant", "ledger",
                 "holder", "held_since")

    def __init__(self, audit: LockAudit, name: str, inner,
                 reentrant: bool):
        self.audit = audit
        self.name = name
        self._inner = inner
        self.reentrant = reentrant
        self.ledger = _Ledger()
        self.holder: Optional[str] = None
        self.held_since: Optional[float] = None

    # ---- Lock protocol ----------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self.audit._note_acquire(self)
        clock = self.audit.clock
        t0 = clock()
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                return False
            with self.audit._mu:
                self.ledger.contended += 1
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
        now = clock()
        with self.audit._mu:
            self.ledger.acquisitions += 1
            self.ledger.wait_s += max(now - t0, 0.0)
        if self.holder is None:
            self.holder = threading.current_thread().name
            self.held_since = now
        self.audit._push(self, now)
        return True

    def release(self) -> None:
        self.audit._pop(self, self.audit.clock())
        if not any(e.lock is self for e in self.audit._held()):
            self.holder = None
            self.held_since = None
        self._inner.release()

    def locked(self) -> bool:
        if hasattr(self._inner, "locked"):
            return self._inner.locked()
        return self.held_since is not None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # ---- Condition protocol -----------------------------------------
    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return any(e.lock is self for e in self.audit._held())

    def _release_save(self):
        """Condition.wait: fully release (RLock: unwind every level)
        and clear the audit's held entry — a sleeping waiter holds
        nothing."""
        self.audit._pop(self, self.audit.clock(), full=True)
        self.holder = None
        self.held_since = None
        if hasattr(self._inner, "_release_save"):
            return ("r", self._inner._release_save())
        self._inner.release()
        return ("l", None)

    def _acquire_restore(self, state) -> None:
        kind, inner_state = state
        clock = self.audit.clock
        t0 = clock()
        if kind == "r":
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        now = clock()
        with self.audit._mu:
            self.ledger.acquisitions += 1
            self.ledger.wait_s += max(now - t0, 0.0)
        self.holder = threading.current_thread().name
        self.held_since = now
        self.audit._push(self, now)

    def __repr__(self) -> str:
        return (f"<InstrumentedLock {self.name!r} "
                f"{'rlock' if self.reentrant else 'lock'} "
                f"holder={self.holder!r}>")
