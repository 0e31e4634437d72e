"""Continuous-batching GPT-2 serving over a paged KV pool, on the card.

- :mod:`kv_pool` — refcounted KV blocks, per-request block tables, the
  prefix cache (token-keyed index, LRU retention, copy-on-write);
- :mod:`kv_quant` — the pool's layout policy (f32 / bf16 passthrough);
- :mod:`scheduler` — FCFS / priority admission, youngest-first
  preemption with exact resume;
- :mod:`families` — the GPT-2 prefill/decode contracts over the paged
  blocks;
- :mod:`engine` — the step loop;
- :mod:`api` — ``generate`` / ``generate_stream``;
- :mod:`metrics` — step gauges, TTFT / latency percentiles.
"""

from quintnet_tpu_torch.serve.api import generate, generate_stream
from quintnet_tpu_torch.serve.engine import ServeEngine, check_admissible
from quintnet_tpu_torch.serve.families import Family, gpt2_family
from quintnet_tpu_torch.serve.kv_pool import KVPool
from quintnet_tpu_torch.serve.metrics import ServeMetrics
from quintnet_tpu_torch.serve.scheduler import Request, Scheduler

__all__ = ["KVPool", "Request", "Scheduler", "ServeEngine", "ServeMetrics",
           "Family", "check_admissible", "generate", "generate_stream",
           "gpt2_family"]
