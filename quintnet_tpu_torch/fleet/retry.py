"""Shared retry policy: jittered exponential backoff with a cap, an
attempt bound, and injectable randomness/clock/sleep.

One discipline, two very different consumers:

- **replica restarts** (fleet/proc.py supervision): the original
  ``Backoff`` (fleet/health.py, now a thin alias over this class) only
  ever needed ``delay_s`` — the fleet's dispatcher owns the schedule
  and the breaker owns the permission;
- **the KV handoff** (disaggregated prefill/decode pools,
  fleet/proc.py): a bounded retry LOOP around an RPC pair that can
  fail transiently (receiver busy, checksum-corrupt frame, socket
  reset) or permanently (the source replica died and its chain with
  it). :meth:`run` owns the loop: call, catch the retryable types,
  sleep the jittered delay, try again — and re-raise the LAST error
  once attempts (or the optional wall-clock ``timeout_s``) are
  exhausted, so the caller's fallback (local re-prefill — slower,
  never wrong) fires with the real cause in hand.

The jitter envelope is pinned: attempt ``n`` (1-based) waits
``min(base_s * 2^(n-1), cap_s) * u`` with ``u`` uniform in
``[1, 1 + jitter]`` — N replicas (or N handoffs) felled by one cause
do not retry, and re-fail, in lockstep. ``rand``, ``clock`` and
``sleep`` are injectable so tests pin the envelope and determinism
without wall time.

Port of ``quintnet_tpu/fleet/retry.py`` (standard library only).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type


class RetryPolicy:
    """Jittered exponential retry/backoff policy (see module docstring).

    ``max_attempts`` bounds :meth:`run` (delay-only users ignore it);
    ``timeout_s``, when set, additionally stops retrying once the
    total wall clock spent inside :meth:`run` exceeds it — a handoff
    must not out-wait the request it is trying to accelerate."""

    def __init__(self, *, base_s: float = 0.05, cap_s: float = 5.0,
                 jitter: float = 0.25, max_attempts: int = 3,
                 timeout_s: Optional[float] = None,
                 rand: Optional[Callable[[], float]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        import random

        if base_s < 0 or cap_s < 0:
            raise ValueError(
                f"base_s/cap_s must be >= 0, got {base_s}/{cap_s}")
        if jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {jitter}")
        if max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {max_attempts}")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.jitter = float(jitter)
        self.max_attempts = int(max_attempts)
        self.timeout_s = None if timeout_s is None else float(timeout_s)
        self.rand = rand if rand is not None else random.random
        self.clock = clock
        self.sleep = sleep

    def bounded(self, timeout_s: float) -> "RetryPolicy":
        """A copy of this policy whose wall-clock budget is tightened
        to ``min(self.timeout_s, timeout_s)`` (injected rand/clock/
        sleep shared). The KV handoff derives this from the request's
        REMAINING deadline: a transfer must not out-wait the request
        it is trying to accelerate."""
        cap = (float(timeout_s) if self.timeout_s is None
               else min(self.timeout_s, float(timeout_s)))
        return RetryPolicy(base_s=self.base_s, cap_s=self.cap_s,
                           jitter=self.jitter,
                           max_attempts=self.max_attempts,
                           timeout_s=cap, rand=self.rand,
                           clock=self.clock, sleep=self.sleep)

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based): raw exponential
        capped at ``cap_s``, times a jitter factor in
        ``[1, 1 + jitter]``."""
        raw = min(self.base_s * (2 ** max(attempt - 1, 0)), self.cap_s)
        return raw * (1.0 + self.jitter * self.rand())

    def run(self, fn: Callable[[int], "object"], *,
            retry_on: Tuple[Type[BaseException], ...] = (Exception,),
            on_retry: Optional[Callable] = None):
        """Call ``fn(attempt)`` up to ``max_attempts`` times, sleeping
        the jittered delay between failures. Only exceptions matching
        ``retry_on`` are retried — anything else propagates
        immediately (a programming error must not be masked by
        retries). ``on_retry(attempt, error)`` fires before each
        re-attempt's sleep (the caller's metrics/obs hook). Exhaustion
        — by attempt count or ``timeout_s`` — re-raises the LAST
        retryable error."""
        deadline = (None if self.timeout_s is None
                    else self.clock() + self.timeout_s)
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(attempt)
            except retry_on as e:
                out_of_attempts = attempt >= self.max_attempts
                out_of_time = (deadline is not None
                               and self.clock() >= deadline)
                if out_of_attempts or out_of_time:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                self.sleep(self.delay_s(attempt))
