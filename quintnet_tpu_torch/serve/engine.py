"""Continuous-batching step loop over the paged KV pool.

Port of ``quintnet_tpu/serve/engine.py``: greedy or sampled decoding
(``temperature``, ``top_k``, ``top_p``), prefix cache on, every KV pool
layout of the ladder (``kv_dtype``: f32, bf16, int8, fp8, fake_quant;
``serve/kv_quant.py``), every weight layout (``weights_dtype``: the same
names; ``serve/weight_quant.py``), the host KV tier (``kv_tier_bytes``,
``kv_tier_promote_budget_bytes``; ``serve/kv_tier.py``), multi-tenant
LoRA (``adapters``, ``lora_targets``, ``lora_max_rank``,
``lora_rank_bucket_sizes``; ``serve/adapters.py``), speculative decoding
(``spec=``, ``serve/spec.py``) and chunked prefill (``chunked_prefill``,
``prefill_chunk_budget``; ``serve/longctx.py``), for any family of
``serve/families.py`` (GPT-2, Llama, their MoE forms), on the CPU and on
the card, on one device or on every rank of a mesh.

Weights (``weights_dtype``): the family's ``weight_targets`` are packed
once at build, after the adapters read the full-precision tree and
before a tp rank's shards are cut; every serving matmul dequantizes
inside ``nn/layers.quantized_matmul``.

Host tier (``kv_tier_bytes`` > 0, with the prefix cache): evicting a
published block demotes it to a host record. When the queue head's
chain goes on past the device index into the tier, the request waits
``PROMOTING`` while at most the promote budget's blocks are copied back
each step (default 4 blocks), every other slot decoding meanwhile; then
its admission finds a device prefix hit. Demotions happen on the
allocation path only: ``_decode_blocked_demotions`` counts those seen
during a plain decode dispatch and stays 0.

Adapters: ``submit(adapter_id=)`` pins the adapter in the registry until
the request retires; the admitted slot's rows of the packed ``[L, S, in,
R]`` / ``[L, S, R, out]`` factors are written (zero rows: the base
model), and every prefill, decode and verify adds each slot's delta on
the targeted matmuls. Decode runs at the smallest rank bucket covering
the bound adapters, prefill and verify at the top bucket. The prefix
index is namespaced by the adapter id. Adapters compose with tp (the
factors cut like their weights) but not with sp or ep.

Serving meshes (``mesh``, a :class:`~quintnet_tpu_torch.core.mesh.Mesh`,
with ``tp_axis``, ``sp_axis``, ``ep_axis``): the port's counterpart of
JAX's ``shard_map`` step is the same engine on every rank of the mesh,
given the same requests in the same order. The host scheduler is
deterministic and reads only tokens that every rank computes from the
same bits, so every rank admits, grows, preempts and retires alike.
Those bits need no deterministic mode: rows that take no part in a step
write the same values to the null block in any order
(``ops/paged_attention.last_null_rows``), and MoE's combine sums each
token's experts in a fixed order, so under a capacity cut the dead rows
and pad columns that compete with live tokens for expert slots route
alike on every rank. tp:
the params are this rank's shards (cut here from the whole tree in the
training layout, ``Family.partition_specs``), the pool holds this rank's
kv heads, and every attention and MLP ends in one sum over tp. sp: each
prefill bucket is split over the ranks and attended by the ring over the
paged pool (``nn/attention.ring_paged_prefill``; the pool and decode are
replicated). ep: a MoE family's experts are sharded, one all-to-all each
way per MoE layer, and the routing counts of every call feed the
metrics' ``moe_*`` keys. An axis of size 1 runs the single-device
code. Per step: admit waiting requests (each prefills only the uncached
tail of its prompt, in the smallest bucket that holds it; a chunked
engine only allocates its table) -> (chunked) feed at most
``prefill_chunk_budget`` prompt tokens of chunks -> grow every active
slot's block table or preempt the youngest admission -> one batched
decode step, or one verify step, for every generating slot -> retire
finished rows.

- ``prefill``: one request at a time; the uncached tail right-padded to
  the smallest bucket of the ladder (``prefill_bucket_sizes``, or the
  powers of two up to ``prefill_len``:
  ``analysis/specs.prefill_buckets``). With a
  prefix-cache hit the table references the cached blocks and the tail
  starts at an offset; a chain that ends inside a partially-filled
  cached block is copied on write into the request's first private
  block before the tail lands (with the source block's scales, under a
  scaled policy);
- ``decode``: ONE step for all ``max_slots`` rows; inactive rows point
  at the pool's null block and their outputs are dropped;
- ``verify`` (``spec``): the decode step widened to the bucket + 1
  tokens a row (``SpecConfig.buckets``): each generating slot's last
  token and its n-gram draft, scored in one forward; the engine commits
  the longest prefix of the draft the model agrees with plus one bonus
  token, several tokens a step on predictable text and never fewer than
  one. The draft's K/V lands in TENTATIVE pool blocks, committed or
  rolled back before the step ends, so published chains never hold a
  draft position. The candidate at run position j of a slot is drawn at
  chain counter ``len(generated) + j``, the counter plain decoding
  would draw that token at, so the committed stream is the spec-off
  stream, sampled too.

Chunked prefill (``chunked_prefill=True``): a prompt longer than the
largest bucket is admitted whole (its table allocated up front) and fed
through the bucket-width prefill calls at growing offsets, at most
``prefill_chunk_budget`` tokens a step, oldest admission first; slots
already generating decode every step meanwhile. Its first token is drawn
once, after the last chunk, at counter ``len(generated)``; a
mid-prefill slot publishes the chunks that landed when it is preempted.

Sampling (``temperature > 0``): every request carries a seed
(``submit(seed=)``, by default its rid, as the JAX engine folds the rid
into ``key(0)``) and draws its token ``i`` from the port's
counter-based chain at (seed, i) (``models/gpt2_generate.
sample_logits``): the first token after its prefill, each later one
after a decode step, all rows of a step in one draw. The chain keeps no
state, so a preempted request re-prefills ``prompt + generated`` and
keeps drawing at counter ``len(generated)``: its stream is the one it
would have had uninterrupted, and the one ``gpt2_generate`` gives its
prompt at the same seed. Greedy (``temperature <= 0``) is the argmax.

Every layer of both goes through ``ops.paged_attention`` — on the card
the hand-written CUDA kernel. PyTorch runs eagerly and compiles no
programs, but the engine keeps JAX's bounded-program promise with JAX's
recompile sentinels (``analysis/recompile.py``): each prefill bucket,
the decode step (each LoRA rank bucket) and each verify bucket is one
sentinel with ``max_compiles=1`` over the abstract signature of its
per-step arguments, which is what one CUDA-graph capture would hold
(:meth:`ServeEngine.compile_counts`,
:meth:`ServeEngine.assert_compile_count`).

Lifecycle (the fleet's surface, ``fleet/``): ``submit(deadline_s=)``
with a per-step sweep that retires running and waiting requests past
their deadline with a typed :class:`~quintnet_tpu_torch.serve.
scheduler.DeadlineExceeded` (a running slot's blocks published first);
``pause_admissions`` / ``resume_admissions`` / ``drain``;
``export_progress`` / ``restore_progress`` (committed tokens and the
seed: a migrated request re-prefills ``prompt + generated`` on this
engine's own pool and keeps drawing at counter ``len(generated)``,
exact mid-prefill and mid-speculation too); and the prefix chain's
``peek_kv_chain`` / ``export_kv_chain`` / ``import_kv_chain``.

Observation (``obs/``): ``clock`` (injectable, ``time.monotonic`` by
default), ``logger`` + ``log_every`` (``ServeMetrics.log_step``),
``tracer`` (per-request spans under ``trace_id``) and ``recorder`` (a
``StepRecord`` a step). Both hooks are plain attributes (a fleet arms
them after the factory ran) and inert: they read host state the step
already holds — no ``.item()``, ``.cpu()`` or ``synchronize()`` is
added for them, so the device work and the device-to-host copies of a
step are the same with them on and off, and so are the tokens.

``attn_kernel`` takes ``"xla"`` only: the port has one paged-attention
path (the kernel on the card, its plain version on the CPU), held to
JAX's XLA path. Host<->device traffic per step is O(max_slots) integers
plus the sampled tokens; the pool and parameters stay on the device.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quintnet_tpu_torch.analysis.recompile import (RecompileError,
                                                   RecompileSentinel)
from quintnet_tpu_torch.analysis.specs import (lora_rank_buckets,
                                               prefill_buckets)
from quintnet_tpu_torch.core.device import resolve_device
from quintnet_tpu_torch.core.pytree import tree_map
from quintnet_tpu_torch.models.gpt2_generate import sample_logits
from quintnet_tpu_torch.obs.recorder import StepRecord
from quintnet_tpu_torch.parallel.tp import shard_leaf
from quintnet_tpu_torch.serve.adapters import (AdapterRegistry,
                                               adapter_factor_paths,
                                               adapter_paths, nest,
                                               packed_lora_spec_flat, tree_at)
from quintnet_tpu_torch.serve.families import Family
from quintnet_tpu_torch.serve.kv_pool import KVPool
from quintnet_tpu_torch.serve.kv_quant import make_policy
from quintnet_tpu_torch.serve.kv_tier import HostTier, PromotionState
from quintnet_tpu_torch.serve.longctx import ChunkState, validate_sp_buckets
from quintnet_tpu_torch.serve.metrics import ServeMetrics
from quintnet_tpu_torch.serve.scheduler import (FINISHED, PROMOTING, WAITING,
                                                DeadlineExceeded, Request,
                                                RequestProgress, Scheduler)
from quintnet_tpu_torch.serve.spec import NgramDrafter, SpecConfig
from quintnet_tpu_torch.serve.weight_quant import (augment_weight_specs,
                                                   make_weight_policy,
                                                   present_targets,
                                                   quantize_params,
                                                   weight_bytes)

_NO_ADAPTERS = ("this engine was built without adapters "
                "(ServeEngine(adapters=AdapterRegistry(...))); "
                "cannot serve adapter_id requests")


def check_admissible(prompt_len: int, max_new_tokens: int, *,
                     max_seq_len: int, usable_blocks: int,
                     block_size: int,
                     prefill_len: Optional[int] = None,
                     max_slots: int = 0,
                     chunked_prefill: bool = False,
                     prefix_cache: bool = True,
                     kv_tier: bool = False) -> None:
    """Submit-time rejection of requests an engine with these limits
    can NEVER run (standalone, so a dispatcher holding only
    ``limits()`` can check too). A preemption-resume prefills prompt +
    generated (up to total - 1 tokens), so ``prefill_len`` (default:
    ``max_seq_len``) must cover that, unless ``chunked_prefill``: a
    chunked engine feeds any prefill through the buckets, so only
    ``max_seq_len`` and the pool remain. ``max_slots``, ``prefix_cache``
    and ``kv_tier`` ride along in ``limits()`` and are no bound."""
    if prompt_len < 1:
        raise ValueError("empty prompt")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    total = prompt_len + int(max_new_tokens)
    if total > max_seq_len:
        raise ValueError(
            f"prompt {prompt_len} + max_new {max_new_tokens} "
            f"exceeds max_seq_len={max_seq_len}")
    if (prefill_len is not None and total - 1 > prefill_len
            and not chunked_prefill):
        raise ValueError(
            f"prompt {prompt_len} + max_new {max_new_tokens} - 1 "
            f"exceeds prefill_len={prefill_len} (resume after preemption "
            f"prefills prompt + generated tokens). Long prompts are "
            f"served by the chunked-prefill mode: "
            f"ServeEngine(chunked_prefill=True) admits any prompt the "
            f"pool can hold and feeds it through bucket-sized chunks")
    worst = -(-total // block_size)
    if worst > usable_blocks:
        raise ValueError(
            f"KV pool too small for this request: needs up to "
            f"{worst} blocks, pool has {usable_blocks} "
            f"usable (block_size={block_size})")


class ServeEngine:
    """Paged continuous-batching engine for one family on one device
    (``"cuda"`` by default; ``"cpu"`` only when asked), or on this rank
    of ``mesh``. ``max_slots`` rows decode together; the pool holds
    ``num_blocks`` blocks of ``block_size`` positions (block 0 is the
    null block)."""

    def __init__(self, family: Family, params, *, device="cuda",
                 max_slots: int = 8, block_size: int = 16,
                 num_blocks: int = 64, max_seq_len: Optional[int] = None,
                 prefill_len: Optional[int] = None,
                 prefill_bucket_sizes: Optional[Sequence[int]] = None,
                 prefix_cache: bool = True, spec=None, adapters=None,
                 lora_targets: Optional[Sequence[str]] = None,
                 lora_max_rank: int = 8,
                 lora_rank_bucket_sizes: Optional[Sequence[int]] = None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, policy: str = "fcfs",
                 mesh=None, tp_axis: str = "tp",
                 sp_axis: Optional[str] = None,
                 ep_axis: Optional[str] = None,
                 chunked_prefill: bool = False,
                 prefill_chunk_budget: Optional[int] = None,
                 kv_dtype=None, weights_dtype=None, kv_tier_bytes: int = 0,
                 kv_tier_promote_budget_bytes: Optional[int] = None,
                 attn_kernel: str = "xla", logger=None, log_every: int = 0,
                 clock=time.monotonic, tracer=None, recorder=None):
        if attn_kernel != "xla":
            raise ValueError(
                f"attn_kernel={attn_kernel!r}: the port takes 'xla' only — "
                f"it has one paged-attention path (ops/paged_attention: "
                f"the kernel on the card, its plain version on the CPU), "
                f"held to the JAX engine's attn_kernel='xla'")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.device = resolve_device(device)
        self.family = family
        self._mesh_axes(family, mesh, tp_axis, sp_axis, ep_axis, adapters)
        self.max_slots = int(max_slots)
        self.eos_token_id = eos_token_id
        self.logger = logger
        self.log_every = int(log_every)
        self.clock = clock
        # observability (obs/): a Tracer records per-request spans, a
        # StepRecorder the per-step ring; plain attributes, so a fleet
        # can arm them after its factory built the engine
        self.tracer = tracer
        self.recorder = recorder
        self.prefix_cache = bool(prefix_cache)
        # speculative decoding: None/False off, True the defaults, or a
        # SpecConfig; drafting is host-side numpy
        if spec is True:
            spec = SpecConfig()
        elif spec is False:
            spec = None
        self.spec: Optional[SpecConfig] = spec
        self.drafter = NgramDrafter(spec) if spec is not None else None
        # multi-tenant LoRA: from the full-precision tree, before packing
        self._init_adapters(family, params, adapters, lora_targets,
                            lora_max_rank, lora_rank_bucket_sizes)

        self.max_seq_len = int(max_seq_len or family.max_positions)
        if self.max_seq_len > family.max_positions:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"n_positions {family.max_positions}")
        # a preemption-resume prefills prompt + generated, up to
        # prefill_len (default: the whole sequence), so the ladder must
        # cover it
        self.prefill_len = int(prefill_len or self.max_seq_len)
        buckets = tuple(sorted(set(
            int(b) for b in (prefill_bucket_sizes
                             or prefill_buckets(self.prefill_len)))))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"invalid prefill buckets {buckets}")
        if buckets[-1] < self.prefill_len:
            raise ValueError(
                f"largest prefill bucket {buckets[-1]} does not cover "
                f"prefill_len={self.prefill_len} (a preemption-resume "
                f"prefill can need the full length)")
        self.prefill_buckets = buckets
        if self._sp is not None:
            validate_sp_buckets(buckets, self._sp.size)
        # chunked prefill: prompts past the top bucket are admitted whole
        # and fed through the bucket calls, at most this many prompt
        # tokens an engine step
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_chunk_budget = (buckets[-1]
                                     if prefill_chunk_budget is None
                                     else int(prefill_chunk_budget))
        if self.prefill_chunk_budget < 1:
            raise ValueError(
                f"prefill_chunk_budget must be >= 1; got "
                f"{self.prefill_chunk_budget}")

        # weight layout: the targets packed once, on the whole tree (a
        # row-parallel weight's scale is the absmax over its whole in
        # dim), then this rank's shards cut and moved to the device
        self.weight_policy = make_weight_policy(weights_dtype)
        self.weights_dtype = self.weight_policy.name
        self._weight_targets = present_targets(params,
                                               family.weight_targets)
        if self.weight_policy.name != "f32" and not self._weight_targets:
            raise ValueError(
                f"family {family.name!r} has no weight targets in this "
                f"param tree; weights_dtype={self.weights_dtype!r} "
                f"would be a silent no-op")
        params = quantize_params(params, self._weight_targets,
                                 self.weight_policy)
        self.weight_bytes = weight_bytes(params, self._weight_targets)
        self.params = _to_device(self._shard(params), self.device)

        self.kv_policy = make_policy(
            kv_dtype if kv_dtype is not None else family.kv_dtype)
        # a tp rank's pool holds its kv heads (and [L, N, Hkv/tp] scales)
        tp = 1 if self._tp is None else self._tp.size
        # the host tier under the prefix cache; a tp rank's records hold
        # its head shard of a block, counted as whole blocks
        self.kv_tier: Optional[HostTier] = None
        if int(kv_tier_bytes) > 0:
            if not self.prefix_cache:
                raise ValueError(
                    "kv_tier_bytes requires prefix_cache=True — the "
                    "host tier spills the prefix cache; with the "
                    "cache off there is nothing to demote")
            self.kv_tier = HostTier(byte_budget=int(kv_tier_bytes),
                                    shards=tp)
        elif int(kv_tier_bytes) < 0:
            raise ValueError(
                f"kv_tier_bytes must be >= 0; got {kv_tier_bytes}")
        self.pool = KVPool(
            n_layers=family.n_layers, n_kv_heads=family.n_kv_heads // tp,
            head_dim=family.head_dim, block_size=block_size,
            num_blocks=num_blocks, policy=self.kv_policy,
            device=self.device, prefix_cache=self.prefix_cache,
            host_tier=self.kv_tier)
        # the per-step promotion budget in blocks (whole blocks' bytes,
        # as the JAX engine counts them), 4 blocks by default
        bpb = self.pool.bytes_per_block * tp
        budget_bytes = (4 * bpb if kv_tier_promote_budget_bytes is None
                        else int(kv_tier_promote_budget_bytes))
        if budget_bytes < 1:
            raise ValueError(
                f"kv_tier_promote_budget_bytes must be >= 1; got "
                f"{budget_bytes}")
        self._promote_budget_blocks = max(1, budget_bytes // bpb)
        # promotions in flight by rid, and the rids whose promotion ran
        # already (one round an admission try: no promote/evict livelock)
        self._promoting: Dict[int, PromotionState] = {}
        self._promotion_done: set = set()
        # demotions seen during a plain decode dispatch (0 by phasing)
        self._decode_blocked_demotions = 0
        self.table_width = self.pool.blocks_for(self.max_seq_len)
        self.scheduler = Scheduler(self.pool, policy=policy)
        self.metrics = ServeMetrics(clock=self.clock)

        S, M = self.max_slots, self.table_width
        self._tok = np.zeros((S,), np.int32)
        self._pos = np.zeros((S,), np.int32)
        self._tables = np.zeros((S, M), np.int32)
        self._slot_req: List[Optional[Request]] = [None] * S
        self._slot_blocks: List[List[int]] = [[] for _ in range(S)]
        # a slot mid chunked prefill (longctx.ChunkState) owns its table
        # but rides no decode or verify step yet
        self._slot_chunk: List[Optional[ChunkState]] = [None] * S
        self._results: Dict[int, Request] = {}
        self._rid_counter = 0
        self._arrival_counter = 0
        self._admissions_paused = False

        # the bounded-program promise, enforced at call time as JAX
        # does (analysis/recompile.py): every prefill bucket, the decode
        # step and every verify bucket is its own sentinel with
        # max_compiles=1, so a drifting signature raises RecompileError
        # naming the leaf. A signature is that of the per-step arguments
        # alone (the parameter tree and the mesh axes are bound into the
        # program, never walked): what one CUDA-graph capture of the
        # program would hold. The programs hold no reference to the
        # engine, so it (its pool) is freed by refcount, not by gc.
        axes = {"tp_axis": self._tp, "ep_axis": self._ep}
        prefill_fn = (functools.partial(family.prefill_from_sp, self.params,
                                        sp_axis=self._sp)
                      if self._sp is not None
                      else functools.partial(family.prefill_from,
                                             self.params, **axes))
        self._prefills: Dict[int, RecompileSentinel] = {
            b: RecompileSentinel(f"serve.prefill[{b}]", prefill_fn,
                                 max_compiles=1)
            for b in self.prefill_buckets}
        # decode: ONE program for adapter-blind engines; with adapters,
        # one per LoRA rank bucket (the packed factors' rank dim is the
        # only signature difference). Keyed by bucket; None = the
        # adapter-blind program.
        decode_fn = functools.partial(family.decode, self.params, **axes)
        if self.adapters is None:
            self._decode_sentinel = RecompileSentinel(
                "serve.decode", decode_fn, max_compiles=1)
            self._decodes: Dict[Optional[int], RecompileSentinel] = {
                None: self._decode_sentinel}
        else:
            self._decodes = {
                r: RecompileSentinel(f"serve.decode[r{r}]", decode_fn,
                                     max_compiles=1)
                for r in self.lora_rank_buckets}
        # verify (speculative decoding): one program per draft-length
        # bucket, the run width P = k + 1
        self._verifies: Dict[int, RecompileSentinel] = {}
        if self.spec is not None:
            verify_fn = functools.partial(family.verify, self.params,
                                          **axes)
            self._verifies = {
                k: RecompileSentinel(f"serve.verify[{k}]", verify_fn,
                                     max_compiles=1)
                for k in self.spec.buckets}

    # ------------------------------------------------------------------
    # multi-tenant LoRA (serve/adapters.py)
    # ------------------------------------------------------------------
    def _init_adapters(self, family: Family, params, adapters, lora_targets,
                       lora_max_rank, lora_rank_bucket_sizes) -> None:
        """The JAX constructor's adapter set-up: None is an adapter-blind
        engine; an AdapterRegistry (or True, a fresh one) arms the
        per-slot packed factors, one (a, b) pair a targeted matmul,
        ``[L, S, in, R]`` / ``[L, S, R, out]`` on the device (this rank's
        cut under tp), zero rows for base-model slots."""
        if adapters is True:
            adapters = AdapterRegistry()
        elif adapters is False:
            adapters = None
        self.adapters: Optional[AdapterRegistry] = adapters
        if adapters is None:
            return
        targets = tuple(lora_targets or family.lora_targets)
        if not targets:
            raise ValueError(
                f"family {family.name!r} declares no default LoRA "
                f"targets; pass lora_targets=")
        self.lora_targets = targets
        self._lora_paths = adapter_paths(params["blocks"], targets)
        if not self._lora_paths:
            raise ValueError(
                f"no LoRA targets {targets} found in the model's "
                f"block tree")
        rb = tuple(sorted(set(
            int(b) for b in (lora_rank_bucket_sizes
                             or lora_rank_buckets(lora_max_rank)))))
        if not rb or rb[0] < 1:
            raise ValueError(f"invalid LoRA rank buckets {rb}")
        self.lora_rank_buckets = rb
        self.lora_max_rank = rb[-1]
        self._lora_specs = None
        if self._tp is not None:
            self._lora_specs = packed_lora_spec_flat(
                family.partition_specs(self.tp_axis)["blocks"],
                self._lora_paths)
        S, R = self.max_slots, self.lora_max_rank
        self._lora_shapes: Dict = {}
        self._lora_dev: Dict = {}
        for path in self._lora_paths:
            w = tree_at(params["blocks"], path)["w"]
            L, fin, fout = w.shape
            self._lora_shapes[path] = (L, fin, fout)
            zeros = dict(dtype=w.dtype, device=self.device)
            self._lora_dev[path] = {
                "a": self._pack_cut(torch.zeros((L, S, fin, R), **zeros),
                                    path, "a"),
                "b": self._pack_cut(torch.zeros((L, S, R, fout), **zeros),
                                    path, "b")}
        self._lora_scale = np.zeros((S,), np.float32)
        self._slot_rank = np.zeros((S,), np.int32)
        self._slot_adapter: List[Optional[str]] = [None] * S
        self._lora_args_cache: Dict = {}

    def _pack_cut(self, t: torch.Tensor, path, factor: str) -> torch.Tensor:
        """A packed factor tensor (whole) -> this rank's cut, on the
        device: ``a`` cut on its in dim, ``b`` on its out dim, as their
        weight (``packed_lora_spec_flat``)."""
        if self._lora_specs is not None:
            t = shard_leaf(t, self._lora_specs[path][factor], self.mesh)
        return t.to(self.device)

    def _adapter_shape_check(self, entry) -> None:
        """An adapter must train a subset of this engine's packed paths
        with [L, in, r] / [L, r, out] factors and a rank within the
        ladder: checked at submit, so a bad tenant file fails its own
        request, never a shared step."""
        packed = set(self._lora_paths)
        unserved = [p for p in adapter_factor_paths(entry.tree)
                    if p not in packed]
        if unserved:
            raise ValueError(
                f"adapter {entry.adapter_id!r} trains "
                f"{['.'.join(p) for p in unserved]} which this engine "
                f"does not serve (lora_targets={self.lora_targets}) — "
                f"its output would silently diverge from the merged "
                f"weights")
        found = 0
        for path in self._lora_paths:
            node = tree_at(entry.tree, path)
            if node is None:
                continue
            found += 1
            a_shape, b_shape = tuple(node["a"].shape), tuple(node["b"].shape)
            L, fin, fout = self._lora_shapes[path]
            r = a_shape[-1]
            if not (a_shape == (L, fin, r) and b_shape == (L, r, fout)):
                raise ValueError(
                    f"adapter {entry.adapter_id!r} factor shapes at "
                    f"{'.'.join(path)} ({a_shape}, {b_shape}) do not "
                    f"match this engine's blocks "
                    f"([{L}, {fin}, r], [{L}, r, {fout}])")
            if r != entry.rank:
                raise ValueError(
                    f"adapter {entry.adapter_id!r} rank mismatch at "
                    f"{'.'.join(path)}: factors have r={r}, config "
                    f"says {entry.rank}")
        if found == 0:
            raise ValueError(
                f"adapter {entry.adapter_id!r} targets none of this "
                f"engine's LoRA paths {self.lora_targets}")
        if entry.rank > self.lora_max_rank:
            raise ValueError(
                f"adapter {entry.adapter_id!r} rank {entry.rank} "
                f"exceeds the engine's top rank bucket "
                f"{self.lora_max_rank} (lora_max_rank)")

    def validate_adapter(self, adapter_id: str) -> None:
        """Can this engine serve ``adapter_id`` now? Raises ValueError or
        KeyError if not. The entry is pinned during the check."""
        if self.adapters is None:
            raise ValueError(_NO_ADAPTERS)
        entry = self.adapters.acquire(adapter_id)
        try:
            self._adapter_shape_check(entry)
        finally:
            self.adapters.release(adapter_id)

    def _pin_adapter(self, adapter_id: Optional[str]) -> None:
        """Submit-time pin and check: the adapter loads if evicted, and
        its refcount holds it resident for the request's lifetime."""
        if adapter_id is None:
            return
        if self.adapters is None:
            raise ValueError(_NO_ADAPTERS)
        entry = self.adapters.acquire(adapter_id)
        try:
            self._adapter_shape_check(entry)
        except (ValueError, KeyError):
            self.adapters.release(adapter_id)
            raise

    def _write_slot_pack(self, slot: int, factors: Dict) -> None:
        """One slot's rows ``{path: (a [L, in, R], b [L, R, out])}``
        (whole) into the packed tensors: only this slot's rows move to
        the device. The args cache views the tensors: cleared first."""
        self._lora_args_cache.clear()
        for path, (a, b) in factors.items():
            dev = self._lora_dev[path]
            dev["a"][:, slot] = self._pack_cut(a[:, None], path, "a")[:, 0]
            dev["b"][:, slot] = self._pack_cut(b[:, None], path, "b")[:, 0]

    def _bind_slot_adapter(self, slot: int, adapter_id: str) -> None:
        """The adapter's factors into the slot's rows, the rank padded
        with zeros (a target it does not train stays zero: the base
        matmul). GPT-2's qkv ``b`` is re-blocked for tp
        (``Family.lora_layout``)."""
        entry = self.adapters.ensure_resident(adapter_id)
        tp = 1 if self._tp is None else self._tp.size
        R = self.lora_max_rank
        factors = {}
        for path in self._lora_paths:
            L, fin, fout = self._lora_shapes[path]
            dtype = self._lora_dev[path]["a"].dtype
            a = torch.zeros((L, fin, R), dtype=dtype, device=self.device)
            b = torch.zeros((L, R, fout), dtype=dtype, device=self.device)
            node = tree_at(entry.tree, path)
            if node is not None:
                na, nb = node["a"], node["b"]
                if self.family.lora_layout is not None:
                    nb = self.family.lora_layout(path, nb, tp)
                r = na.shape[-1]
                a[:, :, :r] = na
                b[:, :r, :] = nb
            factors[path] = (a, b)
        self._write_slot_pack(slot, factors)
        self._lora_scale[slot] = entry.scale
        self._slot_rank[slot] = entry.rank
        self._slot_adapter[slot] = adapter_id

    def _unbind_slot_adapter(self, slot: int) -> None:
        if self._slot_adapter[slot] is None:
            return
        self._lora_args_cache.clear()
        for dev in self._lora_dev.values():
            dev["a"][:, slot] = 0
            dev["b"][:, slot] = 0
        self._lora_scale[slot] = 0.0
        self._slot_rank[slot] = 0
        self._slot_adapter[slot] = None

    def _decode_rank_bucket(self) -> int:
        """The smallest ladder bucket covering the largest rank bound to
        an occupied slot (the smallest when every slot is base: zero
        factors at any width are exact)."""
        top = max((int(self._slot_rank[s]) for s in self._active_slots()),
                  default=0)
        for b in self.lora_rank_buckets:
            if b >= top:
                return b
        raise AssertionError(
            f"bound rank {top} exceeds the top bucket — submit-time "
            f"validation should have rejected the adapter")

    def _lora_args(self, kind: str, *, slot: Optional[int] = None,
                   rank_bucket: Optional[int] = None) -> dict:
        """The ``lora``/``lora_scale`` keywords of one family call, as
        views of the packed tensors (cached until a binding changes):
        ``prefill``: the slot's [1]-row slice at the top bucket;
        ``decode``: every slot at ``rank_bucket``; ``verify``: every slot
        at the top bucket."""
        if kind == "prefill":
            key = ("prefill", slot)
            if key not in self._lora_args_cache:
                flat = {p: {"a": d["a"][:, slot:slot + 1],
                            "b": d["b"][:, slot:slot + 1]}
                        for p, d in self._lora_dev.items()}
                self._lora_args_cache[key] = {
                    "lora": nest(flat),
                    "lora_scale": self._dev(self._lora_scale[slot:slot + 1])}
            return self._lora_args_cache[key]
        R = rank_bucket if kind == "decode" else self.lora_max_rank
        key = (kind, R)
        if key not in self._lora_args_cache:
            flat = {p: {"a": d["a"][..., :R], "b": d["b"][:, :, :R, :]}
                    for p, d in self._lora_dev.items()}
            self._lora_args_cache[key] = {
                "lora": nest(flat),
                "lora_scale": self._dev(self._lora_scale)}
        return self._lora_args_cache[key]

    # ------------------------------------------------------------------
    # serving meshes
    # ------------------------------------------------------------------
    def _mesh_axes(self, family: Family, mesh, tp_axis, sp_axis,
                   ep_axis, adapters=None) -> None:
        """The JAX constructor's mesh checks, with its errors. Sets the
        axis names JAX's engine keeps (``tp_axis``, ``sp_axis``,
        ``ep_axis``; an sp or ep axis of size 1 is None) and this rank's
        :class:`~quintnet_tpu_torch.core.mesh.MeshAxis` of each axis of
        size > 1 (``_tp``, ``_sp``, ``_ep``); a mesh with every axis at
        size 1 runs exactly the single-device code."""
        self.mesh = mesh
        self.tp_axis = tp_axis if mesh is not None else None
        self.sp_axis: Optional[str] = None
        if sp_axis is not None and (mesh is None
                                    or sp_axis not in mesh.shape):
            # an explicitly requested sp axis the mesh does not carry is a
            # misconfiguration, not a degenerate case
            raise ValueError(
                f"sp_axis={sp_axis!r} is not an axis of the mesh "
                f"({None if mesh is None else tuple(mesh.shape)}); "
                f"pass a mesh with that axis (size 1 falls back to "
                f"the plain programs) or drop sp_axis")
        if (mesh is not None and sp_axis is not None
                and mesh.shape[sp_axis] > 1):
            if family.prefill_from_sp is None:
                raise ValueError(
                    f"family {family.name!r} has no sequence-parallel "
                    f"prefill path (Family.prefill_from_sp is None)")
            if tp_axis in mesh.shape and mesh.shape[tp_axis] > 1:
                raise NotImplementedError(
                    "sequence-parallel prefill does not yet compose "
                    "with tensor parallelism — use an sp-only mesh "
                    "(tp x sp is a future extension)")
            if adapters:
                raise NotImplementedError(
                    "sequence-parallel prefill does not yet compose "
                    "with multi-tenant adapters")
            self.sp_axis = sp_axis
        if self.sp_axis is not None or (
                mesh is not None and tp_axis not in mesh.shape):
            # sp-only mesh: params and pool replicated, no tp collectives
            self.tp_axis = None
        # MoE serving: an ep axis of size > 1 shards the experts (one
        # all-to-all each way per MoE layer); size 1 runs the
        # dense-replicated MoE math
        moe = getattr(family.cfg, "moe_args", None)
        self.moe_args = moe
        self._moe_on = moe is not None
        self._moe_acc: List[Dict] = []
        self.ep_axis: Optional[str] = None
        if moe is not None:
            if not 1 <= moe.top_k <= moe.n_experts:
                raise ValueError(
                    f"MoEArgs.top_k={moe.top_k} must be in "
                    f"[1, n_experts={moe.n_experts}]")
            if moe.capacity is not None and int(moe.capacity) < 1:
                raise ValueError(
                    f"MoEArgs.capacity={moe.capacity} gives every "
                    f"expert a non-positive token buffer (every "
                    f"routed token would be dropped) — pass a "
                    f"positive capacity, or None to derive it from "
                    f"capacity_factor")
            if moe.capacity is None and moe.capacity_factor <= 0:
                raise ValueError(
                    f"MoEArgs.capacity_factor={moe.capacity_factor} "
                    f"must be > 0 — it sizes the per-expert token "
                    f"buffer C = ceil(S*top_k/E * capacity_factor)")
            if self.sp_axis is not None:
                raise NotImplementedError(
                    "sequence-parallel prefill does not yet compose "
                    "with MoE families — drop sp_axis")
        if ep_axis is not None:
            if moe is None:
                raise ValueError(
                    f"ep_axis={ep_axis!r} requires an MoE family "
                    f"(cfg.n_experts > 0); this {family.name!r} config "
                    f"is dense")
            if mesh is None or ep_axis not in mesh.shape:
                raise ValueError(
                    f"ep_axis={ep_axis!r} is not an axis of the mesh "
                    f"({None if mesh is None else tuple(mesh.shape)}); "
                    f"pass a mesh with that axis (size 1 falls back to "
                    f"the dense-replicated MoE programs) or drop "
                    f"ep_axis")
            if adapters:
                raise NotImplementedError(
                    "expert-parallel serving does not yet compose "
                    "with multi-tenant adapters — drop ep_axis or "
                    "serve adapters on a replicated MoE engine")
            ep = int(mesh.shape[ep_axis])
            if moe.n_experts % ep != 0:
                raise ValueError(
                    f"n_experts={moe.n_experts} must be divisible by "
                    f"the ep axis size {ep} — each rank owns "
                    f"n_experts/ep experts (nn/moe.py moe_specs)")
            if ep > 1:
                self.ep_axis = ep_axis

        def live(name):
            return (mesh.axis(name) if name is not None
                    and mesh.shape[name] > 1 else None)

        self._tp, self._sp, self._ep = (live(self.tp_axis),
                                        live(self.sp_axis),
                                        live(self.ep_axis))

    def _shard(self, params):
        """This rank's shards of ``params`` (the whole tree in the
        family's training layout: GPT-2's fused QKV tp-blocked,
        ``gpt2_to_tp_layout``) under the family's partition specs over
        the live tp and ep axes; the tree as it is otherwise."""
        if self._tp is None and self._ep is None:
            return params
        specs = self.family.partition_specs(
            self.tp_axis if self._tp is not None else None,
            self.ep_axis if self._ep is not None else None)
        if self.weight_policy.scaled:
            # each w_scale cut like its weight's out dim
            specs = augment_weight_specs(specs, self._weight_targets)
        return tree_map(lambda t, spec: shard_leaf(t, spec, self.mesh),
                        params, specs)

    def _call(self, program: RecompileSentinel, *args, kv_kw,
              lora_kw=None):
        """One family contract on this rank through its program's
        sentinel (the per-step arguments, ``lora_kw`` the packed
        adapters' keywords, are its signature), its MoE routing stats
        (the trailing output of a MoE family) banked for the step's
        ledger; returns (logits, *pools)."""
        out = program(*args, **kv_kw, **(lora_kw or {}))
        if self._moe_on:
            *out, st = out
            self._moe_acc.append({k: v.detach().cpu().numpy()
                                  for k, v in st.items()})
        return out

    def _drain_moe(self) -> Dict[str, object]:
        """Fold the routing stats banked since the last step into
        ``record_step`` keywords. ``expert_tokens`` counts routed demand
        BEFORE the capacity cut (post-cut counts saturate at capacity
        under a hot expert)."""
        acc, self._moe_acc = self._moe_acc, []
        if not acc:
            return {}
        return {
            "moe_expert_tokens": np.sum(
                [a["expert_tokens"] for a in acc], axis=0),
            "moe_routed_tokens": float(
                np.sum([a["assigned"] for a in acc])),
            "moe_dropped_tokens": float(
                np.sum([a["dropped"] for a in acc])),
            "moe_router_entropy": float(
                np.mean([a["entropy"] for a in acc])),
        }

    # ------------------------------------------------------------------
    # the programs
    # ------------------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sample(self, logits, seeds, counters) -> torch.Tensor:
        """Every row's next token [S] from [S, V] logits: row s drawn at
        chain counter ``counters[s]`` of ``seeds[s]`` (JAX's
        ``_sample_rows``), the argmax when greedy."""
        return sample_logits(logits, seeds, counters,
                             temperature=self.temperature, top_k=self.top_k,
                             top_p=self.top_p)

    @torch.no_grad()
    def _prefill(self, ids: np.ndarray, start: int, t0: int,
                 table_row: np.ndarray, cow_src: int, cow_len: int, *,
                 slot: int = 0):
        """Copy-on-write, then prefill the tail; returns the logits [1, V]
        at position ``t0 - 1`` (the caller draws the request's next token
        from them). ``cow_len`` slots of block ``cow_src`` are copied
        into the block holding position ``start`` BEFORE the tail lands:
        the cached block stays immutable while the index references
        it. With adapters, the tail runs under ``slot``'s bound rows."""
        bs = self.pool.block_size
        k_pool, v_pool, *scales = self.pool.caches()
        if cow_len > 0:
            dst = int(table_row[min(start // bs, len(table_row) - 1)])
            for pool in (k_pool, v_pool):
                pool[:, dst * bs:dst * bs + cow_len] = \
                    pool[:, cow_src * bs:cow_src * bs + cow_len]
            # the copied slots are raw stored bytes: under a scaled
            # policy they dequantize correctly only under their own
            # block's scales
            for sc in scales:
                sc[:, dst] = sc[:, cow_src]
        program = self._prefills[ids.shape[1]]
        if self._sp is not None:
            # this rank's slice of the bucket; the ring runs inside
            pl = ids.shape[1] // self._sp.size
            ids = ids[:, self._sp.index * pl:(self._sp.index + 1) * pl]
        logits, *pools = self._call(
            program, k_pool, v_pool, self._dev(ids), start, t0,
            self._dev(table_row), bs, kv_kw=self._kv_kw(scales),
            lora_kw=(self._lora_args("prefill", slot=slot)
                     if self.adapters is not None else None))
        self.pool.update(*pools)
        return logits

    @torch.no_grad()
    def _decode(self, tok: np.ndarray, pos: np.ndarray, tables: np.ndarray,
                seeds, counters, *,
                rank_bucket: Optional[int] = None) -> np.ndarray:
        """One batched decode step; returns the next token of every row
        [S], row s drawn at (``seeds[s]``, ``counters[s]``). With
        adapters, at ``rank_bucket`` (default: the smallest covering the
        bound adapters)."""
        k_pool, v_pool, *scales = self.pool.caches()
        lora_kw = None
        if self.adapters is not None:
            if rank_bucket is None:
                rank_bucket = self._decode_rank_bucket()
            lora_kw = self._lora_args("decode", rank_bucket=rank_bucket)
        logits, *pools = self._call(
            self._decodes[rank_bucket], k_pool, v_pool, self._dev(tok),
            self._dev(pos), self._dev(tables), self.pool.block_size,
            kv_kw=self._kv_kw(scales), lora_kw=lora_kw)
        self.pool.update(*pools)
        nxt = self._sample(logits, seeds, counters)
        return nxt.to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def _verify(self, ids: np.ndarray, starts: np.ndarray,
                tail_lens: np.ndarray, tables: np.ndarray, seeds,
                counters) -> np.ndarray:
        """One batched verify step over [S, P] runs; returns the
        candidate token at every run position [S, P], row s position j
        drawn at (``seeds[s]``, ``counters[s] + j``): the token plain
        decoding would draw there."""
        k_pool, v_pool, *scales = self.pool.caches()
        logits, *pools = self._call(
            self._verifies[ids.shape[1] - 1], k_pool, v_pool,
            self._dev(ids),
            self._dev(starts), self._dev(tail_lens), self._dev(tables),
            self.pool.block_size, kv_kw=self._kv_kw(scales),
            lora_kw=(self._lora_args("verify")
                     if self.adapters is not None else None))
        self.pool.update(*pools)
        S, P, V = logits.shape
        toks = self._sample(logits.reshape(S * P, V),
                            [sd for sd in seeds for _ in range(P)],
                            [c + j for c in counters for j in range(P)])
        return toks.reshape(S, P).to(torch.int32).cpu().numpy()

    def _slot_kw(self, slot: int) -> dict:
        """``_prefill``'s slot keyword: only an engine with adapters
        takes it (the prefill call keeps its six positional arguments)."""
        return {} if self.adapters is None else {"slot": slot}

    def _kv_kw(self, scales) -> dict:
        """The contracts' quantized-KV arguments: the scale tensors and
        the policy under a scaled policy, nothing otherwise."""
        if not scales:
            return {}
        return {"kv_scales": tuple(scales), "policy": self.kv_policy}

    # ------------------------------------------------------------------
    # submission / results
    # ------------------------------------------------------------------
    def limits(self) -> Dict[str, int]:
        """The engine's static limits, the bounds
        :func:`check_admissible` takes among them, and whether a host
        tier is attached."""
        return {"max_seq_len": self.max_seq_len,
                "prefill_len": self.prefill_len,
                "usable_blocks": self.pool.usable_blocks,
                "block_size": self.pool.block_size,
                "max_slots": self.max_slots,
                "chunked_prefill": self.chunked_prefill,
                "prefix_cache": self.prefix_cache,
                "kv_tier": self.kv_tier is not None}

    # ------------------------------------------------------------------
    # the bounded-program promise (analysis/recompile.py)
    # ------------------------------------------------------------------
    def compile_stats(self) -> Dict[str, int]:
        """Program counts for the bounded-program invariant: ``decode``
        stays at 1 (adapter-blind engines) or at most
        ``len(lora_rank_buckets)``, ``prefill`` — the total across
        buckets — at most ``len(prefill_buckets)``, and (speculation
        on) ``verify`` at most ``len(spec.buckets)``, however requests
        and adapters come and go. The ``verify`` key appears only on
        spec-enabled engines."""
        out = {"prefill": sum(s.compile_count
                              for s in self._prefills.values()),
               "decode": sum(s.compile_count
                             for s in self._decodes.values())}
        if self.spec is not None:
            out["verify"] = sum(s.compile_count
                                for s in self._verifies.values())
        return out

    def compile_sentinels(self) -> Dict[str, RecompileSentinel]:
        """The per-bucket prefill sentinels (``prefill[<width>]``), the
        per-bucket verify sentinels (``verify[<k>]``, spec-enabled
        engines only) and the decode sentinel(s) — one ``decode`` key
        for adapter-blind engines, ``decode[r<rank>]`` per rank bucket
        with adapters — for callers that aggregate the promise across
        engines (``ServeFleet.assert_compile_count``)."""
        out: Dict[str, RecompileSentinel] = {
            f"prefill[{b}]": s for b, s in self._prefills.items()}
        for k, s in self._verifies.items():
            out[f"verify[{k}]"] = s
        if self.adapters is None:
            out["decode"] = self._decode_sentinel
        else:
            for r, s in self._decodes.items():
                out[f"decode[r{r}]"] = s
        return out

    def compile_counts(self) -> Dict[str, int]:
        """Per-sentinel counts keyed like :meth:`compile_sentinels`: the
        JSON-able form that crosses a process boundary (the process
        fleet's ``stats`` reply)."""
        return {k: s.compile_count
                for k, s in self.compile_sentinels().items()}

    def assert_compile_count(self, prefill: int = 1, decode: int = 1,
                             verify: Optional[int] = None):
        """Raise RecompileError unless exactly ``decode`` decode
        programs and ``prefill`` prefill programs IN TOTAL across the
        buckets ran (each bucket is capped at one by its own sentinel at
        call time). ``verify``: exact total across the verify buckets;
        None accepts any total up to ``len(spec.buckets)``. With
        adapters, ``decode`` is the exact total across the rank
        buckets."""
        if self.adapters is None:
            self._decode_sentinel.assert_compile_count(decode)
        else:
            d_total = sum(s.compile_count
                          for s in self._decodes.values())
            if d_total != decode:
                detail = ", ".join(
                    f"r{r}: {s.compile_count}"
                    for r, s in sorted(self._decodes.items()))
                raise RecompileError(
                    f"serve.decode: expected {decode} compiled "
                    f"rank-bucket program(s) in total, observed "
                    f"{d_total} ({detail})")
        total = sum(s.compile_count for s in self._prefills.values())
        if total != prefill:
            detail = ", ".join(
                f"bucket {b}: {s.compile_count}"
                for b, s in sorted(self._prefills.items()))
            raise RecompileError(
                f"serve.prefill: expected {prefill} compiled bucket "
                f"program(s) in total, observed {total} ({detail})")
        v_total = sum(s.compile_count for s in self._verifies.values())
        v_cap = verify if verify is not None else len(self._verifies)
        if (verify is not None and v_total != verify) or v_total > v_cap:
            detail = ", ".join(
                f"bucket {k}: {s.compile_count}"
                for k, s in sorted(self._verifies.items()))
            raise RecompileError(
                f"serve.verify: expected "
                f"{verify if verify is not None else f'<= {v_cap}'} "
                f"compiled bucket program(s) in total, observed "
                f"{v_total} ({detail})")

    def _enqueue(self, req: Request) -> int:
        req.submit_time = self.clock()
        self._results[req.rid] = req
        self.scheduler.submit(req)
        return req.rid

    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               seed: Optional[int] = None, on_token=None,
               adapter_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               prefill_only: bool = False) -> int:
        """Queue one request; returns its id. ``seed``: the request's
        sampling chain (default: its rid, the counterpart of the JAX
        engine's ``fold_in(key(0), rid)``); pass the seed an independent
        ``gpt2_generate`` call of the prompt gets to reproduce it token
        for token. ``on_token(rid, token, is_last)`` fires as each token
        is produced. ``adapter_id``: serve the request through that LoRA
        adapter (None: the base model), pinned in the registry until the
        request finishes. ``deadline_s``: the whole request's budget from
        now, enforced every step: a request past it, waiting or running,
        is retired with :class:`DeadlineExceeded` (``result()`` raises
        it). ``trace_id``: the request's observability identity (default
        ``req-<rid>``); never influences output. ``prefill_only``: serve
        only the prefill phase: commit and emit the first token (with its
        real last flag), then retire with the blocks published (the
        disaggregated fleet's prefill-pool dispatch; see
        :class:`Request`)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        check_admissible(prompt.size, max_new_tokens, **self.limits())
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s={deadline_s} already expired at submit")
        self._pin_adapter(adapter_id)
        rid = self._rid_counter
        self._rid_counter += 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      priority=int(priority),
                      arrival=self._arrival_counter, on_token=on_token,
                      seed=rid if seed is None else int(seed),
                      adapter_id=adapter_id,
                      deadline=(None if deadline_s is None
                                else self.clock() + float(deadline_s)),
                      trace_id=trace_id or f"req-{rid}")
        self._arrival_counter += 1
        req.prefill_only = bool(prefill_only)
        if self.tracer is not None:
            self.tracer.event(req.trace_id, "submit", rid=rid,
                              prompt_len=int(prompt.size),
                              max_new_tokens=int(max_new_tokens),
                              adapter_id=adapter_id,
                              priority=int(priority))
        return self._enqueue(req)

    def restore_progress(self, progress: RequestProgress, *,
                         on_token=None, prefill_only: bool = False) -> int:
        """Admit a request MIGRATED from another engine of the same
        (family, params, sampling settings), from its exported
        :class:`RequestProgress`. The resume is the preemption path: the
        next admission prefills ``prompt + generated`` (less any prefix
        hit in this engine's pool) and keeps drawing at counter
        ``len(generated)`` of the progress' seed, so the continuation is
        the exporter's own stream. Returns this engine's (new) request
        id; ``on_token`` fires only for tokens generated here.
        ``prefill_only``: as in :meth:`submit`."""
        prompt = np.asarray(progress.prompt, np.int32).reshape(-1)
        if len(progress.generated) >= progress.max_new_tokens:
            raise ValueError(
                f"nothing left to generate: {len(progress.generated)} of "
                f"{progress.max_new_tokens} tokens already produced")
        check_admissible(prompt.size, progress.max_new_tokens,
                         **self.limits())
        # the migrated request keeps its adapter: this engine's registry
        # loads it if it has never served (or has evicted) the tenant
        self._pin_adapter(progress.adapter_id)
        rid = self._rid_counter
        self._rid_counter += 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(progress.max_new_tokens),
                      priority=int(progress.priority),
                      arrival=self._arrival_counter, on_token=on_token,
                      seed=int(progress.seed),
                      adapter_id=progress.adapter_id,
                      deadline=(None if progress.deadline_s is None
                                else self.clock()
                                + float(progress.deadline_s)),
                      trace_id=progress.trace_id or f"req-{rid}")
        self._arrival_counter += 1
        req.generated = list(progress.generated)
        req.preemptions = int(progress.preemptions)
        req.prefill_only = bool(prefill_only)
        if self.tracer is not None:
            # the migrated timeline continues here under the same id
            self.tracer.event(req.trace_id, "restore", rid=rid,
                              generated=len(req.generated),
                              preemptions=req.preemptions,
                              adapter_id=req.adapter_id)
        return self._enqueue(req)

    def result(self, rid: int) -> np.ndarray:
        req = self._results[rid]
        if req.state != FINISHED:
            raise RuntimeError(f"request {rid} not finished "
                               f"(state={req.state})")
        if req.error is not None:
            raise req.error
        return req.output_ids()

    def request(self, rid: int) -> Request:
        return self._results[rid]

    @property
    def has_work(self) -> bool:
        return (bool(self.scheduler.waiting)
                or any(r is not None for r in self._slot_req))

    # ------------------------------------------------------------------
    # step loop
    # ------------------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is not None]

    def _clear_slot(self, slot: int) -> None:
        st = self._slot_chunk[slot]
        if st is not None and st.cow_pinned:
            # a slot cleared before its first chunk ran still holds the
            # admission's pin on the copy-on-write source
            self.pool.release([st.cow_src])
        self._slot_chunk[slot] = None
        self._slot_req[slot] = None
        self._slot_blocks[slot] = []
        self._tables[slot] = 0
        self._tok[slot] = 0
        self._pos[slot] = 0
        if self.adapters is not None:
            self._unbind_slot_adapter(slot)

    def _release_slot_blocks(self, slot: int) -> None:
        """Publish the slot's valid-KV prefix (``_pos`` positions) under
        its adapter's namespace, then drop its references — publish
        first: release retains published blocks."""
        req = self._slot_req[slot]
        blocks = self._slot_blocks[slot]
        self.pool.publish(req.output_ids(), blocks, int(self._pos[slot]),
                          namespace=req.adapter_id)
        self.pool.release(blocks)

    def _retire(self, slot: int) -> int:
        req = self._slot_req[slot]
        self._release_slot_blocks(slot)
        self._clear_slot(slot)
        req.state = FINISHED
        req.finish_time = self.clock()
        self.metrics.record_finish(req.finish_time - req.submit_time,
                                   adapter_id=req.adapter_id)
        if self.tracer is not None:
            self.tracer.event(req.trace_id, "finish", rid=req.rid,
                              generated=len(req.generated),
                              preemptions=req.preemptions,
                              handed_off=req.handed_off)
        if req.adapter_id is not None:
            self.adapters.release(req.adapter_id)   # the submit-time pin
        return req.rid

    def _fail_request(self, req: Request, error: BaseException) -> None:
        """Terminal typed failure: FINISHED, but ``result()`` raises
        ``error``; no token is emitted (the error ends the stream)."""
        req.error = error
        req.state = FINISHED
        req.finish_time = self.clock()
        if req.adapter_id is not None:
            self.adapters.release(req.adapter_id)   # the submit-time pin

    def _sweep_deadlines(self, finished: List[int]) -> None:
        """Retire every request past its deadline: running slots (their
        valid K/V published first, so a retry of the prompt re-prefills
        almost nothing) and waiting ones (a PROMOTING one keeps what its
        promotion already landed)."""
        now = self.clock()
        for slot in self._active_slots():
            req = self._slot_req[slot]
            if req.deadline is None or now < req.deadline:
                continue
            self._release_slot_blocks(slot)
            self._clear_slot(slot)
            self._fail_request(req, DeadlineExceeded(
                f"request {req.rid} exceeded its deadline after "
                f"{len(req.generated)}/{req.max_new_tokens} tokens; "
                f"retired mid-decode (blocks published)",
                rid=req.rid, generated=len(req.generated)))
            self.metrics.record_deadline_exceeded()
            if self.tracer is not None:
                self.tracer.event(req.trace_id, "deadline_exceeded",
                                  generated=len(req.generated),
                                  where="running")
            finished.append(req.rid)
        expired = [r for r in self.scheduler.waiting
                   if r.deadline is not None and now >= r.deadline]
        for req in expired:
            self.scheduler.waiting.remove(req)
            self._promoting.pop(req.rid, None)
            self._fail_request(req, DeadlineExceeded(
                f"request {req.rid} still waiting at its deadline; "
                f"never admitted", rid=req.rid, generated=0))
            self.metrics.record_deadline_exceeded()
            if self.tracer is not None:
                self.tracer.event(req.trace_id, "deadline_exceeded",
                                  generated=0, where="waiting")
            finished.append(req.rid)

    # ---- host-tier promotion (serve/kv_tier.py) ----------------------
    def _start_promotion(self, req: Request) -> bool:
        """Probe the queue head's chain across both tiers (capped at
        ``len(tokens) - 1``, as admission is); on a host hit park it
        ``PROMOTING`` with the keys to bring back."""
        tokens = req.output_ids()
        covered, keys = self.pool.plan_promotion(
            tokens, max_tokens=len(tokens) - 1, namespace=req.adapter_id)
        if not keys:
            return False
        req.state = PROMOTING
        self._promoting[req.rid] = PromotionState(req=req, keys=keys)
        if self.tracer is not None:
            self.tracer.event(req.trace_id, "kv_promote", phase="start",
                              blocks=len(keys), covered_tokens=int(covered))
        return True

    def _feed_promotions(self) -> None:
        """Advance every promotion in flight by at most the per-step
        block budget, shared among them: the copies land while the other
        slots keep decoding. A finished promotion sets its request
        WAITING, and this step's admission finds the promoted chain as a
        device hit. A promotion that can make no progress while nothing
        runs (no block can be had and no retirement will free one) is
        ended: admission re-prefills, never wedges."""
        budget = self._promote_budget_blocks
        for rid in list(self._promoting):
            if budget <= 0:
                break
            st = self._promoting[rid]
            req = st.req
            if req.state != PROMOTING:       # failed while parked
                self._promoting.pop(rid, None)
                continue
            taken, blocks = self.pool.promote_chain(
                st.keys[st.next:], max_blocks=budget)
            st.next += taken
            budget -= blocks
            if blocks and self.tracer is not None:
                self.tracer.event(req.trace_id, "kv_promote", phase="feed",
                                  blocks=blocks, remaining=st.remaining)
            if st.done or (taken == 0 and blocks == 0
                           and not self._active_slots()):
                self._promoting.pop(rid)
                self._promotion_done.add(rid)
                req.state = WAITING
                if self.tracer is not None:
                    self.tracer.event(req.trace_id, "kv_promote",
                                      phase="done", promoted_keys=st.next)

    def peek_kv_chain(self, tokens, *,
                      namespace: Optional[str] = None) -> int:
        """Token positions this engine could serve warm for ``tokens``
        (the device chain and its host-tier extension); read-only."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        return self.pool.peek_chain_tokens(tokens, namespace=namespace)

    def _preempt(self, slot: int) -> None:
        """Evict: publish + release the blocks (the chain usually
        survives until resume), requeue at the head of the line."""
        req = self._slot_req[slot]
        self._release_slot_blocks(slot)
        self._clear_slot(slot)
        req.preemptions += 1
        self.metrics.record_preempt()
        if self.tracer is not None:
            self.tracer.event(req.trace_id, "preempt",
                              generated=len(req.generated),
                              preemptions=req.preemptions)
        self.scheduler.push_front(req)

    def _append_token(self, slot: int, token: int) -> bool:
        """Record one token; True when the request is done (EOS or
        budget)."""
        req = self._slot_req[slot]
        req.generated.append(int(token))
        if req.adapter_id is not None:
            self.metrics.record_adapter_token(req.adapter_id)
        now = self.clock()
        if req.first_token_time is None:
            req.first_token_time = now
            self.metrics.record_first_token(now - req.submit_time,
                                            adapter_id=req.adapter_id)
        elif req.last_token_time is not None:
            self.metrics.record_itl(now - req.last_token_time)
        req.last_token_time = now
        done = (req.remaining_new_tokens <= 0
                or (self.eos_token_id is not None
                    and int(token) == self.eos_token_id))
        if req.on_token is not None:
            req.on_token(req.rid, int(token), done)
        return done

    def _bucket_for(self, tail_len: int) -> int:
        for b in self.prefill_buckets:
            if b >= tail_len:
                return b
        raise AssertionError(
            f"tail {tail_len} exceeds the largest bucket "
            f"{self.prefill_buckets[-1]} — submit should have rejected "
            f"this request")

    def _allocate_slot(self, slot: int, req: Request):
        """Resolve the plan the scheduler approved this step: pin its
        cached chain FIRST (the private acquire below may evict
        refcount-zero cached blocks), acquire the private blocks, build
        the slot's table row."""
        plan, req.admit_plan = req.admit_plan, None
        self.pool.acquire_cached(plan.pinned_blocks)
        new = self.pool.acquire(plan.n_new_blocks)
        assert new is not None  # admission checked the budget
        blocks = plan.shared_blocks + new
        self._slot_req[slot] = req
        self._slot_blocks[slot] = blocks
        self._tables[slot] = 0
        self._tables[slot, :len(blocks)] = blocks
        return plan

    def _trace_admit(self, req: Request, plan, *, evictions: int,
                     chunked: bool) -> None:
        """The admission's spans: the queue wait closed, and the plan's
        outcome (prefix hit, copy on write, evictions it forced)."""
        tr = self.tracer
        if tr is None:
            return
        now = self.clock()
        tr.add(req.trace_id, "queue", t0=req.submit_time, t1=now,
               preemptions=req.preemptions)
        tr.event(req.trace_id, "admit",
                 cached_tokens=int(plan.cached_tokens),
                 shared_blocks=len(plan.shared_blocks),
                 new_blocks=int(plan.n_new_blocks),
                 cow=plan.cow_src is not None, cow_len=int(plan.cow_len),
                 evictions_forced=int(evictions), chunked=chunked,
                 adapter_id=req.adapter_id)

    def _admit_one(self, slot: int, req: Request) -> Tuple[int, int]:
        """Admit ``req`` into ``slot``: reuse the longest cached prefix,
        prefill only the uncached tail. Returns (tail tokens prefilled,
        cached tokens reused)."""
        t0 = req.total_len
        tokens = req.output_ids()
        ev0 = self.pool.cache_evictions
        plan = self._allocate_slot(slot, req)
        self._trace_admit(req, plan,
                          evictions=self.pool.cache_evictions - ev0,
                          chunked=False)
        start = plan.cached_tokens
        tail = tokens[start:t0]
        bucket = self._bucket_for(len(tail))
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :len(tail)] = tail
        if self.adapters is not None and req.adapter_id is not None:
            # bound BEFORE the prefill: the tail runs under the adapter
            self._bind_slot_adapter(slot, req.adapter_id)
        logits = self._prefill(ids, start, t0, self._tables[slot],
                               plan.cow_src or 0, plan.cow_len,
                               **self._slot_kw(slot))
        tok0 = int(self._sample(logits, [req.seed],
                                [len(req.generated)])[0].item())
        if plan.cow_src is not None:
            self.pool.release([plan.cow_src])  # pinned for the copy only
        self._tok[slot] = tok0
        self._pos[slot] = t0
        self.metrics.record_admit()
        if self.tracer is not None:
            self.tracer.event(req.trace_id, "prefill", tokens=len(tail),
                              bucket=bucket, start=int(start))
        if self._finish_first_token(slot, req, tok0):
            self._retire(slot)
        return len(tail), start

    def _finish_first_token(self, slot: int, req: Request,
                            tok0: int) -> bool:
        """Commit a prefill's first token; True when the request retires
        now. A ``prefill_only`` request that is not done (EOS and
        one-token budgets finish normally) hands off: it retires with its
        blocks published, the chain a decode replica imports."""
        done = self._append_token(slot, tok0)
        if not done and req.prefill_only:
            req.handed_off = True
            done = True
        return done

    # ------------------------------------------------------------------
    # chunked prefill (serve/longctx.py)
    # ------------------------------------------------------------------
    def _admit_slot_chunked(self, slot: int, req: Request) -> int:
        """Chunked admission: the request's WHOLE table allocated now,
        no prefill yet (:meth:`_feed_chunks` streams the uncached tail).
        ``_pos`` counts the positions holding valid K/V (the cached ones
        so far), so a publish on preemption stays right. Returns the
        prefix-cache hit."""
        ev0 = self.pool.cache_evictions
        plan = self._allocate_slot(slot, req)
        self._trace_admit(req, plan,
                          evictions=self.pool.cache_evictions - ev0,
                          chunked=True)
        self._pos[slot] = plan.cached_tokens
        self._tok[slot] = 0
        req.prefilled = plan.cached_tokens
        if self.adapters is not None and req.adapter_id is not None:
            self._bind_slot_adapter(slot, req.adapter_id)
        self._slot_chunk[slot] = ChunkState(
            next=plan.cached_tokens, t0=req.total_len, cow_src=plan.cow_src,
            cow_len=plan.cow_len, cow_pinned=plan.cow_src is not None)
        return plan.cached_tokens

    def _run_chunk(self, slot: int, req: Request, st: ChunkState, n: int,
                   finished: List[int]) -> None:
        """One ``n``-token chunk at offset ``st.next`` in the smallest
        bucket that holds it: the prefill call a prefix-cache tail makes.
        Only the last chunk draws the first new token."""
        tokens = req.output_ids()
        bucket = self._bucket_for(n)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = tokens[st.next:st.next + n]
        cow = st.cow_pinned
        logits = self._prefill(ids, st.next, st.next + n, self._tables[slot],
                               st.cow_src if cow else 0,
                               st.cow_len if cow else 0,
                               **self._slot_kw(slot))
        if cow:
            self.pool.release([st.cow_src])   # pinned for the copy only
            st.cow_pinned = False
        st.next += n
        self._pos[slot] = st.next
        req.prefilled = st.next
        if self.tracer is not None:
            self.tracer.event(req.trace_id, "prefill_chunk", tokens=int(n),
                              bucket=bucket, start=st.next - n,
                              final=st.done)
        if not st.done:
            return
        self._slot_chunk[slot] = None
        tok0 = int(self._sample(logits, [req.seed],
                                [len(req.generated)])[0].item())
        self._tok[slot] = tok0
        self.metrics.record_admit()
        if self._finish_first_token(slot, req, tok0):
            finished.append(self._retire(slot))

    def _feed_chunks(self, finished: List[int]) -> Tuple[int, int]:
        """At most ``prefill_chunk_budget`` prompt tokens of chunks this
        step, oldest admission first, the whole budget to one request
        before the next. Returns (prompt tokens fed, chunks)."""
        budget = self.prefill_chunk_budget
        top = self.prefill_buckets[-1]
        tokens_done = chunks = 0
        order = sorted((s for s in self._active_slots()
                        if self._slot_chunk[s] is not None),
                       key=lambda s: self._slot_req[s].admit_seq)
        for slot in order:
            req, st = self._slot_req[slot], self._slot_chunk[slot]
            while budget > 0 and self._slot_chunk[slot] is st:
                n = min(st.remaining, top, budget)
                self._run_chunk(slot, req, st, n, finished)
                budget -= n
                tokens_done += n
                chunks += 1
            if budget <= 0:
                break
        return tokens_done, chunks

    def _grow_or_preempt(self) -> None:
        """Every active slot must hold the block its next write needs;
        when the pool is dry, evict the youngest admission. Oldest
        requests grow first."""
        order = sorted(self._active_slots(),
                       key=lambda s: self._slot_req[s].admit_seq)
        for slot in order:
            while self._slot_req[slot] is not None:
                need = self.pool.blocks_for(int(self._pos[slot]) + 1)
                if len(self._slot_blocks[slot]) >= need:
                    break
                got = self.pool.acquire(1)
                if got is not None:
                    self._tables[slot][len(self._slot_blocks[slot])] = got[0]
                    self._slot_blocks[slot].extend(got)
                    continue
                running = [self._slot_req[s] for s in self._active_slots()]
                victim = Scheduler.preempt_victim(running)
                if victim is self._slot_req[slot] and len(running) == 1:
                    raise RuntimeError(
                        f"KV pool too small for a single request of "
                        f"length {int(self._pos[slot]) + 1} "
                        f"(usable blocks: {self.pool.usable_blocks}, "
                        f"block_size: {self.pool.block_size})")
                vslot = next(s for s in self._active_slots()
                             if self._slot_req[s] is victim)
                self._preempt(vslot)

    # ------------------------------------------------------------------
    # speculative decoding (serve/spec.py)
    # ------------------------------------------------------------------
    def _propose_drafts(self, active: List[int]):
        """Every generating slot's draft ``{slot: tokens}`` when some slot
        drafted at least ``spec.min_draft`` tokens, else None (plain
        decode). A draft is at most ``remaining_new_tokens - 1`` long:
        the bonus token always fits the budget."""
        if self.drafter is None:
            return None
        drafts: Dict[int, np.ndarray] = {}
        worthwhile = False
        for slot in active:
            req = self._slot_req[slot]
            cap = min(self.spec.max_draft, req.remaining_new_tokens - 1)
            d = (self.drafter.draft(req.output_ids(), cap)
                 if cap >= 1 else np.zeros((0,), np.int32))
            drafts[slot] = d
            worthwhile |= len(d) >= self.spec.min_draft
        return drafts if worthwhile else None

    def _verify_step(self, active: List[int],
                     drafts: Dict[int, np.ndarray],
                     finished: List[int]) -> Tuple[int, int, int]:
        """One batched verify: every generating slot's run (last token +
        draft) written through the pool and scored; each slot commits the
        longest matching prefix of its draft plus one bonus token, and
        the rest rolls back. The blocks the draft needs beyond the slot's
        own are taken TENTATIVE (a draft shrinks until they can be:
        speculation never preempts); after acceptance those the committed
        length reaches are committed, the others rolled back. Returns
        (committed tokens, drafted tokens, accepted draft tokens)."""
        S = self.max_slots
        tentative: Dict[int, List[int]] = {}
        for slot in active:
            d = drafts[slot]
            pos = int(self._pos[slot])
            have = len(self._slot_blocks[slot])
            while len(d):
                need = self.pool.blocks_for(pos + len(d) + 1) - have
                if need <= 0 or self.pool.can_acquire(need):
                    break
                d = d[:-1]
            drafts[slot] = d
            need = max(0, self.pool.blocks_for(pos + len(d) + 1) - have)
            got = self.pool.tentative_acquire(need) if need else []
            assert got is not None  # can_acquire checked just above
            tentative[slot] = got
            self._tables[slot][have:have + len(got)] = got

        # the bucket of the SURVIVING drafts: the narrower call is cheaper
        P = self.spec.bucket_for(max(len(drafts[s]) for s in active)) + 1
        ids = np.zeros((S, P), np.int32)
        starts = np.zeros((S,), np.int32)
        tail_lens = np.zeros((S,), np.int32)
        tables = np.zeros_like(self._tables)   # other rows: the null block
        seeds, counters = [0] * S, [0] * S
        for slot in active:
            d, req = drafts[slot], self._slot_req[slot]
            ids[slot, 0] = self._tok[slot]
            ids[slot, 1:1 + len(d)] = d
            starts[slot] = self._pos[slot]
            tail_lens[slot] = len(d) + 1
            tables[slot] = self._tables[slot]
            seeds[slot], counters[slot] = req.seed, len(req.generated)
        toks = self._verify(ids, starts, tail_lens, tables, seeds, counters)

        committed = drafted = accepted = 0
        for slot in active:
            d, t = drafts[slot], toks[slot]
            a = 0
            while a < len(d) and int(t[a]) == int(d[a]):
                a += 1
            # commit t[0..a]: each is the token plain decoding draws
            # there; stop early on EOS or the budget
            pos0 = int(self._pos[slot])
            c, done = 0, False
            while c <= a and not done:
                done = self._append_token(slot, int(t[c]))
                c += 1
            self._tok[slot] = int(t[c - 1])
            self._pos[slot] = pos0 + c
            have0 = len(self._slot_blocks[slot])
            got = tentative[slot]
            keep = max(0, min(len(got),
                              self.pool.blocks_for(pos0 + c) - have0))
            if keep:
                self.pool.commit_tentative(got[:keep])
                self._slot_blocks[slot].extend(got[:keep])
            if got[keep:]:
                self.pool.rollback_tentative(got[keep:])
                self._tables[slot][have0 + keep:have0 + len(got)] = 0
            committed += c
            drafted += len(d)
            # committed draft tokens: t[0..c-1] but the bonus at a
            accepted += min(c, a)
            if self.tracer is not None:
                self.tracer.event(self._slot_req[slot].trace_id, "verify",
                                  committed=c, drafted=len(d),
                                  accepted=min(c, a))
            if done:
                finished.append(self._retire(slot))
        return committed, drafted, accepted

    def step(self) -> List[int]:
        """One scheduler iteration: retire requests past their deadline
        -> (host tier) feed the promotions' budget -> admit (unless
        paused) -> (chunked) feed the budget's chunks -> grow/preempt ->
        one decode step, or one verify step, for every generating slot
        -> retire. Returns the ids of the requests that finished this
        step (a deadline's retirements included)."""
        finished: List[int] = []
        prefill_tokens = prefix_hit_tokens = 0
        # the recorder's window is two host clock reads around the
        # step: no device drain is added to time it
        rec = self.recorder
        if rec is not None:
            rec_t0 = self.clock()
            rec_admitted0 = self.metrics.admitted
            rec_preempted0 = self.metrics.preempted
        self._sweep_deadlines(finished)
        if self._promoting:
            self._feed_promotions()
        while not self._admissions_paused:
            free = self._free_slots()
            if self.kv_tier is not None:
                w = self.scheduler.waiting
                # the third admission outcome, a host hit: the head's
                # chain goes on in the host tier; park it PROMOTING (one
                # round an admission try) rather than re-prefill it
                if (w and w[0].state == WAITING
                        and w[0].rid not in self._promotion_done
                        and self._start_promotion(w[0])):
                    break
            req = self.scheduler.next_admission(len(free))
            if req is None:
                break
            self._promotion_done.discard(req.rid)
            if self.chunked_prefill:
                prefix_hit_tokens += self._admit_slot_chunked(free[0], req)
                continue
            tail, hit = self._admit_one(free[0], req)
            prefill_tokens += tail
            prefix_hit_tokens += hit
            if self._slot_req[free[0]] is None:  # retired at prefill
                finished.append(req.rid)

        prefill_chunks = 0
        if self.chunked_prefill:
            fed, prefill_chunks = self._feed_chunks(finished)
            prefill_tokens += fed

        self._grow_or_preempt()

        decode_tokens = draft_tokens = accepted_draft = 0
        active = self._active_slots()
        decoding = [s for s in active if self._slot_chunk[s] is None]
        prefilling = [s for s in active if self._slot_chunk[s] is not None]
        drafts = self._propose_drafts(decoding) if decoding else None
        if drafts is not None:
            decode_tokens, draft_tokens, accepted_draft = self._verify_step(
                decoding, drafts, finished)
        elif decoding:
            tok, pos, tables = self._tok, self._pos, self._tables
            if prefilling:
                # mid-prefill rows look inactive to the decode step: their
                # write goes to the null block, not to position _pos of
                # their real table
                tok, pos, tables = tok.copy(), pos.copy(), tables.copy()
                tok[prefilling] = pos[prefilling] = 0
                tables[prefilling] = 0
            rows = self._slot_req
            # the plain decode dispatch acquires no block, so it can set
            # off no demotion copy: the counter proves it every step
            demo0 = 0 if self.kv_tier is None else self.kv_tier.demotions
            nxt = self._decode(
                tok, pos, tables,
                [r.seed if r is not None else 0 for r in rows],
                [len(r.generated) if r is not None else 0 for r in rows])
            for slot in decoding:
                token = int(nxt[slot])
                self._tok[slot] = token
                self._pos[slot] += 1
                decode_tokens += 1
                if self.tracer is not None:
                    self.tracer.event(self._slot_req[slot].trace_id,
                                      "decode", token=token,
                                      pos=int(self._pos[slot]))
                if self._append_token(slot, token):
                    finished.append(self._retire(slot))
            if self.kv_tier is not None:
                self._decode_blocked_demotions += (self.kv_tier.demotions
                                                   - demo0)

        tier = self.kv_tier
        moe_kw = self._drain_moe() if self._moe_on else {}
        self.metrics.record_step(
            running=len(self._active_slots()),
            waiting=len(self.scheduler.waiting),
            kv_blocks_used=self.pool.num_used,
            kv_blocks_total=self.pool.usable_blocks,
            kv_pool_bytes=self.pool.pool_bytes,
            kv_bytes_per_token=self.pool.bytes_per_token,
            weight_bytes=self.weight_bytes,
            weights_dtype=self.weights_dtype,
            prefill_tokens=prefill_tokens,
            decode_tokens=decode_tokens,
            prefix_hit_tokens=prefix_hit_tokens,
            spec_step=drafts is not None,
            draft_tokens=draft_tokens,
            accepted_draft_tokens=accepted_draft,
            prefill_chunks=prefill_chunks,
            kv_cache_evictions=self.pool.cache_evictions,
            kv_demotions=0 if tier is None else tier.demotions,
            kv_promotions=0 if tier is None else tier.promotions,
            kv_host_evictions=0 if tier is None else tier.evictions,
            host_hit_tokens=0 if tier is None else tier.promoted_tokens,
            host_tier_bytes=0 if tier is None else tier.bytes_used,
            decode_blocked_demotions=self._decode_blocked_demotions,
            **moe_kw)
        if rec is not None:
            m = self.metrics
            rec.record(StepRecord(
                step=m.steps, t0=rec_t0, t1=self.clock(),
                running=m.running, waiting=m.waiting,
                decoding=len(decoding), prefilling=len(prefilling),
                admitted=m.admitted - rec_admitted0,
                finished=len(finished),
                preempted=m.preempted - rec_preempted0,
                kv_blocks_used=m.kv_blocks_used,
                kv_blocks_total=m.kv_blocks_total,
                prefill_tokens=prefill_tokens,
                decode_tokens=decode_tokens,
                prefix_hit_tokens=prefix_hit_tokens,
                prefill_chunks=prefill_chunks,
                spec_step=drafts is not None, draft_tokens=draft_tokens,
                accepted_draft_tokens=accepted_draft,
                # the routing stats' host copies the metrics just used
                attrs={k: (v.tolist() if isinstance(v, np.ndarray)
                           else v) for k, v in moe_kw.items()}))
        if self.log_every:
            self.metrics.log_step(self.logger, every=self.log_every)
        return finished

    def warmup(self) -> None:
        """Run every prefill bucket, the decode step (at every LoRA rank
        bucket) and (with ``spec``) every verify bucket once before
        traffic (builds the CUDA kernel,
        warms the allocator and the BLAS handles). All-zero tables: every
        write lands in the null block; outputs are discarded and no
        request or metric state is touched."""
        zrow = np.zeros((self.table_width,), np.int32)
        for b in self.prefill_buckets:
            self._prefill(np.zeros((1, b), np.int32), 0, 1, zrow, 0, 0)
        zeros = [0] * len(self._tok)
        for rank in (self.lora_rank_buckets if self.adapters is not None
                     else (None,)):
            self._decode(np.zeros_like(self._tok), np.zeros_like(self._pos),
                         np.zeros_like(self._tables), zeros, zeros,
                         rank_bucket=rank)
        for k in (self.spec.buckets if self.spec is not None else ()):
            S = len(self._tok)
            self._verify(np.zeros((S, k + 1), np.int32),
                         np.zeros((S,), np.int32), np.ones((S,), np.int32),
                         np.zeros_like(self._tables), zeros, zeros)
        self._moe_acc.clear()      # warm-up routing is not traffic

    def run(self, *, max_steps: Optional[int] = None) -> None:
        """Step until all submitted work is finished (or ``max_steps``)."""
        steps = 0
        while self.has_work:
            if max_steps is not None and steps >= max_steps:
                break
            self.step()
            steps += 1

    # ------------------------------------------------------------------
    # pause / drain / progress export (the fleet's migration surface)
    # ------------------------------------------------------------------
    @property
    def admissions_paused(self) -> bool:
        return self._admissions_paused

    def pause_admissions(self) -> None:
        """Stop admitting from the waiting queue; active slots keep
        decoding. While paused, ``run()`` spins if only waiting work is
        left (``has_work`` counts the queue): pair pausing with
        :meth:`drain` or :meth:`step`."""
        self._admissions_paused = True

    def resume_admissions(self) -> None:
        self._admissions_paused = False

    def drain(self, *, max_steps: Optional[int] = None) -> List[int]:
        """Finish the ACTIVE slots without admitting anything new (pause
        admissions, step until no slot is occupied). Waiting requests
        stay queued: export them (:meth:`export_progress`) or
        :meth:`resume_admissions`. Returns the rids finished meanwhile."""
        self.pause_admissions()
        finished: List[int] = []
        steps = 0
        while self._active_slots():
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"drain: {len(self._active_slots())} slot(s) still "
                    f"active after {max_steps} steps")
            finished.extend(self.step())
            steps += 1
        return finished

    def export_progress(self) -> List[RequestProgress]:
        """Every UNFINISHED request's resume payload (running slots and
        the waiting queue), in rid order: the committed tokens and the
        seed, exact at any step boundary — also after the owning worker
        died between steps (the fleet's migration). Read-only."""
        now = self.clock()
        out = [self._slot_req[s].progress(now=now)
               for s in self._active_slots()]
        out += [req.progress(now=now) for req in self.scheduler.waiting]
        out.sort(key=lambda p: p.rid)
        if self.tracer is not None:
            for p in out:
                self.tracer.event(p.trace_id, "export",
                                  generated=len(p.generated),
                                  prefilled=int(p.prefilled))
        return out

    # ------------------------------------------------------------------
    # KV chain export / import (the pool's, as host data)
    # ------------------------------------------------------------------
    def export_kv_chain(self, tokens, *, namespace: Optional[str] = None,
                        trace_id: Optional[str] = None) -> Optional[Dict]:
        """The pool's published chain for ``tokens`` as host data
        (:meth:`KVPool.export_chain`); None when it is gone (the caller
        re-prefills, which is always correct: the chain is cache)."""
        chain = self.pool.export_chain(tokens, namespace=namespace)
        if self.tracer is not None:
            self.tracer.event(trace_id, "kv_export",
                              found=chain is not None,
                              n_tokens=(0 if chain is None
                                        else int(chain["n_tokens"])),
                              namespace=namespace)
        return chain

    def import_kv_chain(self, chain: Dict, *,
                        namespace: Optional[str] = None,
                        trace_id: Optional[str] = None) -> int:
        """A transferred chain into this pool as a warm prefix
        (:meth:`KVPool.import_chain`); returns the positions now cached
        (0: pool full or cache off). ``ValueError`` on a geometry or
        layout mismatch."""
        n = self.pool.import_chain(chain, namespace=namespace)
        if self.tracer is not None:
            self.tracer.event(trace_id, "kv_import", n_tokens=int(n),
                              namespace=namespace)
        return n


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
