"""One ServeEngine on a worker thread.

The replica owns the thread that drives ``engine.step()`` and the tiny
inbox the fleet's dispatcher feeds. Everything request-shaped flows
through two callbacks back into the fleet (``on_finish``, ``on_death``)
so the fleet keeps a single source of truth for routing state.

Lock discipline (deadlock-free by construction):

- the replica's own condition lock guards ONLY the inbox and the
  pause/stop flags; the worker drains the inbox under it, releases,
  then runs the engine and fleet callbacks WITHOUT it;
- ``in_flight`` / ``outstanding_tokens`` are routing counters owned by
  the FLEET and mutated only under the fleet lock (dispatch and the
  finish/death callbacks all hold it);
- the dispatcher calls :meth:`enqueue` while holding the fleet lock —
  safe, because the worker never acquires the fleet lock while holding
  the replica lock.

Death contract: ANY exception out of the step loop (a
``ft.ChaosMonkey`` raise, a real engine bug) marks the replica DEAD
and hands the fleet every unfinished request's
:class:`~quintnet_tpu_torch.serve.scheduler.RequestProgress` — engine-known
work via ``engine.export_progress()`` (exact at the step boundary:
the committed tokens and the request's seed) plus inbox items the
worker never ingested (their original payloads). The fleet re-submits
these to healthy replicas via ``engine.restore_progress`` and the
output stream continues token-identically. The death keeps the error
but not its traceback, whose frames hold the dead engine.

Port of ``quintnet_tpu/fleet/replica.py``.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

from quintnet_tpu_torch.fleet.admission import Overloaded
from quintnet_tpu_torch.fleet.health import DEAD, HEALTHY, STOPPED


class Replica:
    """A named ServeEngine + its worker thread."""

    def __init__(self, name: str, engine_factory: Callable, *,
                 chaos=None, max_dispatch: Optional[int] = None,
                 on_finish: Callable = None, on_death: Callable = None,
                 on_reject: Callable = None, poll_s: float = 0.05):
        self.name = name
        self.engine = engine_factory()
        self.chaos = chaos
        # dispatch window: how many unfinished requests the fleet may
        # park on this replica before the rest waits in the FLEET queue
        # (where shedding policy applies) — engine slots + one refill
        self.max_dispatch = int(max_dispatch or 2 * self.engine.max_slots)
        self._on_finish = on_finish
        self._on_death = on_death
        self._on_reject = on_reject
        self._poll_s = poll_s

        self.state = HEALTHY
        self.error: Optional[BaseException] = None
        self.steps = 0              # engine steps taken (chaos counter)
        # fleet-owned routing counters (mutated under the FLEET lock)
        self.in_flight = 0
        self.outstanding_tokens = 0

        self._cv = threading.Condition()
        self._inbox: List[Tuple] = []        # (fleet_req, progress|None)
        self._paused = False
        self._stop = False
        self._rid2freq = {}                  # engine rid -> fleet request
        self._thread = threading.Thread(
            target=self._worker, name=f"fleet-{name}", daemon=True)
        self._thread.start()

    # ---- fleet-facing surface (dispatcher/fleet-lock side) -----------
    @property
    def paused(self) -> bool:
        return self._paused

    def adapter_resident(self, adapter_id: str) -> bool:
        """The router's affinity predicate: is the adapter's weight
        tree resident in THIS replica's registry right now? (Registry
        reads are registry-lock protected; the dispatcher calls this
        under the fleet lock without touching engine state.)"""
        reg = getattr(self.engine, "adapters", None)
        return reg is not None and reg.is_resident(adapter_id)

    def enqueue(self, freq, progress=None) -> None:
        """Hand one fleet request (optionally with a migration resume
        payload) to the worker."""
        with self._cv:
            self._inbox.append((freq, progress))
            self._cv.notify_all()

    def pause(self) -> None:
        """Stop stepping (and stop being a dispatch candidate); already
        dispatched work freezes in place until :meth:`resume`."""
        with self._cv:
            self._paused = True
            self._cv.notify_all()

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def stop(self, *, join_timeout: float = 10.0) -> None:
        """Clean shutdown: the worker exits without a death callback.
        In-flight requests are abandoned — the fleet errors them (this
        is the close() path, after drain has emptied the fleet)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=join_timeout)
        if self.state == HEALTHY:
            self.state = STOPPED

    def unfinished(self) -> List:
        """Fleet requests dispatched here and not yet finished (read
        under the fleet lock at death/close time)."""
        with self._cv:
            inbox = [f for f, _p in self._inbox]
        return inbox + list(self._rid2freq.values())

    def drain_inbox(self) -> List[Tuple]:
        """Take everything still in the inbox. The fleet calls this
        (under the fleet lock) when handling this replica's death: the
        worker sets DEAD and exports WITHOUT the fleet lock, so the
        dispatcher can race one last enqueue into the dead inbox —
        re-draining under the lock that enqueues are made under closes
        the window."""
        with self._cv:
            items, self._inbox = self._inbox, []
        return items

    # ---- worker ------------------------------------------------------
    def _ingest(self, freq, progress) -> None:
        # every request routes engine tokens through freq.deliver: it
        # stamps first-token time (fleet TTFT includes queue wait) and
        # forwards to the user's streaming callback when there is one
        def deliver(_rid, token, last, _freq=freq):
            _freq.deliver(token, last)

        if progress is None:
            # the fleet's deadline becomes the ENGINE's: remaining
            # budget re-anchored on this engine's clock, so a request
            # mid-decode at its deadline is retired typed
            # (DeadlineExceeded) instead of finishing a stream the
            # client abandoned
            deadline_s = freq.remaining_deadline()
            if deadline_s is not None and deadline_s <= 0:
                raise Overloaded(
                    "deadline",
                    f"request {freq.fid} reached its deadline between "
                    f"dispatch and ingest")
            rid = self.engine.submit(
                freq.prompt, freq.max_new_tokens, seed=freq.seed,
                priority=freq.priority, on_token=deliver,
                adapter_id=freq.adapter_id, deadline_s=deadline_s,
                trace_id=getattr(freq, "trace_id", None))
        else:
            # progress carries the adapter binding; restore re-pins it
            # from THIS replica's registry (loading on a cold replica)
            rid = self.engine.restore_progress(progress,
                                               on_token=deliver)
        self._rid2freq[rid] = freq

    def _worker(self) -> None:
        try:
            while True:
                with self._cv:
                    while (not self._stop and not self._inbox
                           and (self._paused
                                or not self.engine.has_work)):
                        self._cv.wait(self._poll_s)
                    if self._stop:
                        return
                    work, self._inbox = self._inbox, []
                    paused = self._paused
                for freq, progress in work:
                    try:
                        self._ingest(freq, progress)
                    except (ValueError, KeyError, Overloaded) as e:
                        # a REQUEST-scoped rejection (engine submit/
                        # restore validation, unknown adapter, typed
                        # Overloaded/DeadlineExceeded) must not kill
                        # the replica: error that request's waiter only
                        self._on_reject(self, freq, e)
                if paused or not self.engine.has_work:
                    continue
                finished = self.engine.step()
                self.steps += 1
                for rid in finished:
                    freq = self._rid2freq.pop(rid)
                    err = self.engine.request(rid).error
                    if err is not None:
                        # typed terminal failure (DeadlineExceeded):
                        # the waiter gets the error, the replica lives
                        self._on_reject(self, freq, err)
                    else:
                        self._on_finish(self, freq,
                                        self.engine.result(rid))
                if self.chaos is not None:
                    self.chaos.on_step_end(self.steps)
        except Exception as e:  # ChaosKilled or a real engine fault
            self.error = e
            self.state = DEAD
            try:
                self._on_death(self, e, self._export_unfinished())
            finally:
                # the frames hold the engine: a restart must be able to
                # free its pool
                e.__traceback__ = None

    def _export_unfinished(self) -> List[Tuple]:
        """(fleet_req, RequestProgress) for every request this replica
        held when it died: engine-known work exported exactly (committed
        tokens and seeds), never-ingested inbox items with their
        original payloads."""
        out: List[Tuple] = []
        with self._cv:
            leftover, self._inbox = self._inbox, []
        try:
            for prog in self.engine.export_progress():
                freq = self._rid2freq.pop(prog.rid, None)
                if freq is not None:
                    out.append((freq, prog))
        except Exception:
            # the engine is too broken even to export; fall back to the
            # last checkpoint the FLEET holds for each request (its
            # submit payload, or the progress from a previous
            # migration) — completion is preserved, though a streaming
            # request may see tokens since that checkpoint re-delivered
            pass
        for freq in self._rid2freq.values():
            out.append((freq, freq.progress))
        self._rid2freq.clear()
        out.extend(leftover)
        return out
