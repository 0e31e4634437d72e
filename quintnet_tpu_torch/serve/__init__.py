"""Continuous-batching GPT-2 and Llama serving over a paged KV pool, on
the card, on one device or on every rank of a tp, sp or ep mesh.

- :mod:`kv_pool` — refcounted KV blocks, per-request block tables, the
  prefix cache (token-keyed index, LRU retention, copy-on-write);
- :mod:`kv_quant` — the pool's layout policy (f32 / bf16 / fp8
  passthrough, int8 and fake_quant with per-block scales) and
  ``paged_eval_nll``;
- :mod:`scheduler` — FCFS / priority admission, youngest-first
  preemption with exact resume;
- :mod:`families` — the GPT-2 and Llama prefill/decode/verify (and
  sequence-parallel prefill) contracts over the paged blocks;
- :mod:`spec` — speculative decoding's config and n-gram drafter;
- :mod:`longctx` — chunked prefill's planning pieces and the sp
  bucket check;
- :mod:`engine` — the step loop;
- :mod:`api` — ``generate`` / ``generate_stream``;
- :mod:`metrics` — step gauges, TTFT / latency percentiles.
"""

from quintnet_tpu_torch.serve.api import generate, generate_stream
from quintnet_tpu_torch.serve.engine import ServeEngine, check_admissible
from quintnet_tpu_torch.serve.families import (Family, gpt2_family,
                                               llama_family)
from quintnet_tpu_torch.serve.kv_pool import KVPool
from quintnet_tpu_torch.serve.longctx import plan_chunks
from quintnet_tpu_torch.serve.metrics import ServeMetrics
from quintnet_tpu_torch.serve.scheduler import Request, Scheduler
from quintnet_tpu_torch.serve.spec import NgramDrafter, SpecConfig

__all__ = ["KVPool", "NgramDrafter", "Request", "Scheduler", "ServeEngine",
           "ServeMetrics", "SpecConfig", "Family", "check_admissible",
           "generate", "generate_stream", "gpt2_family", "llama_family",
           "plan_chunks"]
