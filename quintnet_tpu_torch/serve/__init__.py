"""Continuous-batching GPT-2 and Llama serving over a paged KV pool, on
the card, on one device or on every rank of a tp, sp or ep mesh.

- :mod:`kv_pool` — refcounted KV blocks, per-request block tables, the
  prefix cache (token-keyed index, LRU retention, copy-on-write);
- :mod:`kv_quant` — the pool's layout policy (f32 / bf16 / fp8
  passthrough, int8 and fake_quant with per-block scales) and
  ``paged_eval_nll``;
- :mod:`kv_tier` — the host tier under the prefix cache (demoted
  blocks, promotion under a per-step block budget);
- :mod:`weight_quant` — the weights' layout policy on the same protocol
  (int8 / fp8 per-output-channel scales, bf16, fake_quant), dequantized
  inside ``nn/layers.quantized_matmul``;
- :mod:`adapters` — multi-tenant LoRA: the adapter registry and the
  per-slot packed factors;
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

from quintnet_tpu_torch.serve.adapters import AdapterEntry, AdapterRegistry
from quintnet_tpu_torch.serve.api import generate, generate_stream
from quintnet_tpu_torch.serve.engine import ServeEngine, check_admissible
from quintnet_tpu_torch.serve.families import (Family, gpt2_family,
                                               llama_family)
from quintnet_tpu_torch.serve.kv_pool import AdmitPlan, KVPool
from quintnet_tpu_torch.serve.kv_quant import (KVLayoutPolicy, LayoutPolicy,
                                               make_policy)
from quintnet_tpu_torch.serve.kv_tier import HostTier
from quintnet_tpu_torch.serve.longctx import plan_chunks
from quintnet_tpu_torch.serve.metrics import ServeMetrics
from quintnet_tpu_torch.serve.scheduler import (Request, RequestProgress,
                                                Scheduler)
from quintnet_tpu_torch.serve.spec import NgramDrafter, SpecConfig
from quintnet_tpu_torch.serve.weight_quant import (WeightLayoutPolicy,
                                                   make_weight_policy)

__all__ = ["AdapterEntry", "AdapterRegistry", "AdmitPlan", "Family",
           "HostTier", "KVLayoutPolicy", "KVPool", "LayoutPolicy",
           "NgramDrafter", "Request", "RequestProgress", "Scheduler",
           "ServeEngine", "ServeMetrics", "SpecConfig",
           "WeightLayoutPolicy", "check_admissible", "generate",
           "generate_stream", "gpt2_family", "llama_family",
           "make_policy", "make_weight_policy", "plan_chunks"]
