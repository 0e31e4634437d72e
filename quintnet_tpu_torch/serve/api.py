"""Front-end entry points over the engine.

Port of ``quintnet_tpu/serve/api.py``. ``generate`` submits everything,
drives the loop to completion and returns completions in submission
order; ``generate_stream`` delivers one request's tokens through a
callback as each engine step produces them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from quintnet_tpu_torch.serve.engine import ServeEngine
from quintnet_tpu_torch.serve.scheduler import FINISHED


def generate(engine: ServeEngine, prompts: Sequence, *, max_new_tokens,
             seeds=None, priorities=None, adapter_ids=None,
             max_steps: Optional[int] = None) -> List[np.ndarray]:
    """Run ``prompts`` to completion; one [T0_i + n_generated_i] array
    per prompt, order preserved. ``max_new_tokens``: int or per-prompt
    sequence. ``seeds``: optional per-prompt sampling seeds (JAX's
    ``keys``) — pass the seeds independent ``gpt2_generate`` calls would
    get to reproduce them; None gives each request the engine's default
    (its rid). ``adapter_ids``: optional per-prompt LoRA adapters
    (``serve/adapters.py``; None entries ride the base model). Rows stop
    early at the engine's ``eos_token_id``."""
    n = len(prompts)
    if isinstance(max_new_tokens, int):
        max_new_tokens = [max_new_tokens] * n
    if seeds is None:
        seeds = [None] * n
    if priorities is None:
        priorities = [0] * n
    if adapter_ids is None:
        adapter_ids = [None] * n
    if not (len(max_new_tokens) == len(seeds) == len(priorities)
            == len(adapter_ids) == n):
        raise ValueError("per-prompt argument lengths must match prompts")
    rids = [engine.submit(p, m, priority=pr, seed=sd, adapter_id=a)
            for p, m, sd, pr, a in zip(prompts, max_new_tokens, seeds,
                                       priorities, adapter_ids)]
    engine.run(max_steps=max_steps)
    unfinished = [r for r in rids if engine.request(r).state != FINISHED]
    if unfinished:
        detail = ", ".join(
            f"rid {r} ({engine.request(r).state}, "
            f"{len(engine.request(r).generated)}/"
            f"{engine.request(r).max_new_tokens} tokens)"
            for r in unfinished)
        raise RuntimeError(
            f"generate: {len(unfinished)} of {n} request(s) unfinished "
            f"after max_steps={max_steps}: {detail} — raise max_steps "
            f"(or submit less work per call)")
    return [engine.result(r) for r in rids]


def generate_stream(engine: ServeEngine, prompt, *, max_new_tokens: int,
                    on_token: Callable[[int, int, bool], None],
                    priority: int = 0, seed: Optional[int] = None,
                    max_steps: Optional[int] = None) -> np.ndarray:
    """Streaming single-request generation: ``on_token(rid, token,
    is_last)`` fires per token (the prefill token included). ``seed``:
    the request's sampling seed (default: its rid). Blocks until the
    request finishes; other queued requests keep progressing in the same
    steps."""
    rid = engine.submit(prompt, max_new_tokens, priority=priority,
                        seed=seed, on_token=on_token)
    steps = 0
    while engine.request(rid).state != FINISHED:
        if max_steps is not None and steps >= max_steps:
            raise RuntimeError(
                f"request {rid} unfinished after {max_steps} steps")
        engine.step()
        steps += 1
    return engine.result(rid)
