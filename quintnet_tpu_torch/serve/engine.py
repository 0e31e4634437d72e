"""Continuous-batching step loop over the paged KV pool.

Port of ``quintnet_tpu/serve/engine.py``: greedy or sampled decoding
(``temperature``, ``top_k``, ``top_p``), prefix cache on, every KV pool
layout of the ladder (``kv_dtype``: f32, bf16, int8, fp8, fake_quant;
``serve/kv_quant.py``), speculative decoding (``spec=``,
``serve/spec.py``) and chunked prefill (``chunked_prefill``,
``prefill_chunk_budget``; ``serve/longctx.py``), for any family of
``serve/families.py`` (GPT-2, Llama, their MoE forms), on the CPU and on
the card, on one device or on every rank of a mesh.

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
the hand-written CUDA kernel. PyTorch runs eagerly, so the bucket
ladder bounds tensor shapes rather than compiled programs.

Options of the JAX constructor that this port does not serve yet raise
``NotImplementedError`` naming their ROADMAP.md item unless they hold
the JAX default ("off") value; none is ignored. ``attn_kernel`` takes
``"xla"`` only: the port has one paged-attention path (the kernel on
the card, its plain version on the CPU), held to JAX's XLA path.
Host<->device traffic per step is O(max_slots) integers plus the
sampled tokens; the pool and parameters stay on the device.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from quintnet_tpu_torch.analysis.specs import prefill_buckets
from quintnet_tpu_torch.core.device import resolve_device
from quintnet_tpu_torch.core.pytree import tree_map
from quintnet_tpu_torch.models.gpt2_generate import sample_logits
from quintnet_tpu_torch.parallel.tp import shard_leaf
from quintnet_tpu_torch.serve.families import Family
from quintnet_tpu_torch.serve.kv_pool import KVPool
from quintnet_tpu_torch.serve.kv_quant import make_policy
from quintnet_tpu_torch.serve.longctx import ChunkState, validate_sp_buckets
from quintnet_tpu_torch.serve.metrics import ServeMetrics
from quintnet_tpu_torch.serve.scheduler import (FINISHED, Request,
                                                Scheduler)
from quintnet_tpu_torch.serve.spec import NgramDrafter, SpecConfig

# constructor options of the JAX engine that are still to port, with
# the ROADMAP.md item each belongs to
_NOT_PORTED = {
    "adapters": "§1, item 7 ('Serving features'): serve/adapters.py "
                "(multi-LoRA)",
    "kv_tier_bytes": "§1, item 7 ('Serving features'): serve/kv_tier.py "
                     "(host KV tier)",
    "weights_dtype": "§1, item 7 ('Serving features'): "
                     "serve/weight_quant.py",
    "lora_targets": "§1, item 7 ('Serving features'): serve/adapters.py "
                    "(multi-LoRA)",
    "lora_max_rank": "§1, item 7 ('Serving features'): serve/adapters.py "
                     "(multi-LoRA)",
    "lora_rank_bucket_sizes": "§1, item 7 ('Serving features'): "
                              "serve/adapters.py (multi-LoRA)",
    "kv_tier_promote_budget_bytes": "§1, item 7 ('Serving features'): "
                                    "serve/kv_tier.py (host KV tier)",
    "logger": "§1, item 8 ('Fleet, obs and ft'): the engine's logger",
    "log_every": "§1, item 8 ('Fleet, obs and ft'): the engine's logger",
    "clock": "§1, item 8 ('Fleet, obs and ft'): the engine's clock",
    "tracer": "§1, item 8 ('Fleet, obs and ft'): obs/ tracing",
    "recorder": "§1, item 8 ('Fleet, obs and ft'): obs/ flight recorder",
}
# the JAX constructor's default of each option above that has one other
# than None/False/0: passing it is passing nothing
_JAX_OFF = {"lora_max_rank": 8, "clock": time.monotonic}


def _not_ported(option: str, value):
    raise NotImplementedError(
        f"ServeEngine({option}={value!r}) is not ported yet (ROADMAP.md, "
        f"{_NOT_PORTED[option]})")


def check_admissible(prompt_len: int, max_new_tokens: int, *,
                     max_seq_len: int, usable_blocks: int,
                     block_size: int,
                     prefill_len: Optional[int] = None,
                     chunked_prefill: bool = False) -> None:
    """Submit-time rejection of requests an engine with these limits
    can NEVER run (standalone, so a dispatcher holding only
    ``limits()`` can check too). A preemption-resume prefills prompt +
    generated (up to total - 1 tokens), so ``prefill_len`` (default:
    ``max_seq_len``) must cover that, unless ``chunked_prefill``: a
    chunked engine feeds any prefill through the buckets, so only
    ``max_seq_len`` and the pool remain."""
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
        for option, value in (
                ("adapters", adapters),
                ("kv_tier_bytes", kv_tier_bytes),
                ("lora_targets", lora_targets),
                ("lora_max_rank", lora_max_rank),
                ("lora_rank_bucket_sizes", lora_rank_bucket_sizes),
                ("kv_tier_promote_budget_bytes",
                 kv_tier_promote_budget_bytes),
                ("logger", logger), ("log_every", log_every),
                ("clock", clock), ("tracer", tracer),
                ("recorder", recorder)):
            off = _JAX_OFF.get(option)
            if value is off or value in (None, False, 0) or (
                    off is not None and not callable(off) and value == off):
                continue                        # the JAX "off" value
            _not_ported(option, value)
        if attn_kernel != "xla":
            raise ValueError(
                f"attn_kernel={attn_kernel!r}: the port takes 'xla' only — "
                f"it has one paged-attention path (ops/paged_attention: "
                f"the kernel on the card, its plain version on the CPU), "
                f"held to the JAX engine's attn_kernel='xla'")
        if weights_dtype not in (None, "f32"):
            _not_ported("weights_dtype", weights_dtype)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.device = resolve_device(device)
        self.family = family
        self._mesh_axes(family, mesh, tp_axis, sp_axis, ep_axis)
        self.params = _to_device(self._shard(params), self.device)
        self.max_slots = int(max_slots)
        self.eos_token_id = eos_token_id
        self.clock = time.monotonic
        self.prefix_cache = bool(prefix_cache)
        # speculative decoding: None/False off, True the defaults, or a
        # SpecConfig; drafting is host-side numpy
        if spec is True:
            spec = SpecConfig()
        elif spec is False:
            spec = None
        self.spec: Optional[SpecConfig] = spec
        self.drafter = NgramDrafter(spec) if spec is not None else None

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

        if self._sp is not None:
            validate_sp_buckets(buckets, self._sp.size)

        self.kv_policy = make_policy(
            kv_dtype if kv_dtype is not None else family.kv_dtype)
        # a tp rank's pool holds its kv heads (and [L, N, Hkv/tp] scales)
        tp = 1 if self._tp is None else self._tp.size
        self.pool = KVPool(
            n_layers=family.n_layers, n_kv_heads=family.n_kv_heads // tp,
            head_dim=family.head_dim, block_size=block_size,
            num_blocks=num_blocks, policy=self.kv_policy,
            device=self.device, prefix_cache=self.prefix_cache)
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

    # ------------------------------------------------------------------
    # serving meshes
    # ------------------------------------------------------------------
    def _mesh_axes(self, family: Family, mesh, tp_axis, sp_axis,
                   ep_axis) -> None:
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
        return tree_map(lambda t, spec: shard_leaf(t, spec, self.mesh),
                        params, specs)

    def _call(self, fn, *args, kv_kw):
        """One family contract on this rank, its MoE routing stats (the
        trailing output of a MoE family) banked for the step's ledger;
        returns (logits, *pools)."""
        out = fn(self.params, *args, **kv_kw, tp_axis=self._tp,
                 ep_axis=self._ep)
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
                 table_row: np.ndarray, cow_src: int, cow_len: int):
        """Copy-on-write, then prefill the tail; returns the logits [1, V]
        at position ``t0 - 1`` (the caller draws the request's next token
        from them). ``cow_len`` slots of block ``cow_src`` are copied
        into the block holding position ``start`` BEFORE the tail lands:
        the cached block stays immutable while the index references
        it."""
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
        if self._sp is not None:
            # this rank's slice of the bucket; the ring runs inside
            pl = ids.shape[1] // self._sp.size
            ids = ids[:, self._sp.index * pl:(self._sp.index + 1) * pl]
            logits, *pools = self.family.prefill_from_sp(
                self.params, k_pool, v_pool, self._dev(ids), start, t0,
                self._dev(table_row), bs, sp_axis=self._sp,
                **self._kv_kw(scales))
        else:
            logits, *pools = self._call(
                self.family.prefill_from, k_pool, v_pool, self._dev(ids),
                start, t0, self._dev(table_row), bs,
                kv_kw=self._kv_kw(scales))
        self.pool.update(*pools)
        return logits

    @torch.no_grad()
    def _decode(self, tok: np.ndarray, pos: np.ndarray, tables: np.ndarray,
                seeds, counters) -> np.ndarray:
        """One batched decode step; returns the next token of every row
        [S], row s drawn at (``seeds[s]``, ``counters[s]``)."""
        k_pool, v_pool, *scales = self.pool.caches()
        logits, *pools = self._call(
            self.family.decode, k_pool, v_pool, self._dev(tok),
            self._dev(pos), self._dev(tables), self.pool.block_size,
            kv_kw=self._kv_kw(scales))
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
            self.family.verify, k_pool, v_pool, self._dev(ids),
            self._dev(starts), self._dev(tail_lens), self._dev(tables),
            self.pool.block_size, kv_kw=self._kv_kw(scales))
        self.pool.update(*pools)
        S, P, V = logits.shape
        toks = self._sample(logits.reshape(S * P, V),
                            [sd for sd in seeds for _ in range(P)],
                            [c + j for c in counters for j in range(P)])
        return toks.reshape(S, P).to(torch.int32).cpu().numpy()

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
        """The admissibility bounds :func:`check_admissible` takes."""
        return {"max_seq_len": self.max_seq_len,
                "prefill_len": self.prefill_len,
                "usable_blocks": self.pool.usable_blocks,
                "block_size": self.pool.block_size,
                "chunked_prefill": self.chunked_prefill}

    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               seed: Optional[int] = None, on_token=None) -> int:
        """Queue one request; returns its id. ``seed``: the request's
        sampling chain (default: its rid, the counterpart of the JAX
        engine's ``fold_in(key(0), rid)``); pass the seed an independent
        ``gpt2_generate`` call of the prompt gets to reproduce it token
        for token. ``on_token(rid, token, is_last)`` fires as each token
        is produced."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        check_admissible(prompt.size, max_new_tokens, **self.limits())
        rid = self._rid_counter
        self._rid_counter += 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      priority=int(priority),
                      arrival=self._arrival_counter, on_token=on_token,
                      seed=rid if seed is None else int(seed))
        self._arrival_counter += 1
        req.submit_time = self.clock()
        self._results[rid] = req
        self.scheduler.submit(req)
        return rid

    def result(self, rid: int) -> np.ndarray:
        req = self._results[rid]
        if req.state != FINISHED:
            raise RuntimeError(f"request {rid} not finished "
                               f"(state={req.state})")
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

    def _release_slot_blocks(self, slot: int) -> None:
        """Publish the slot's valid-KV prefix (``_pos`` positions), then
        drop its references — publish first: release retains published
        blocks."""
        req = self._slot_req[slot]
        blocks = self._slot_blocks[slot]
        self.pool.publish(req.output_ids(), blocks, int(self._pos[slot]))
        self.pool.release(blocks)

    def _retire(self, slot: int) -> int:
        req = self._slot_req[slot]
        self._release_slot_blocks(slot)
        self._clear_slot(slot)
        req.state = FINISHED
        req.finish_time = self.clock()
        self.metrics.record_finish(req.finish_time - req.submit_time)
        return req.rid

    def _preempt(self, slot: int) -> None:
        """Evict: publish + release the blocks (the chain usually
        survives until resume), requeue at the head of the line."""
        req = self._slot_req[slot]
        self._release_slot_blocks(slot)
        self._clear_slot(slot)
        req.preemptions += 1
        self.metrics.record_preempt()
        self.scheduler.push_front(req)

    def _append_token(self, slot: int, token: int) -> bool:
        """Record one token; True when the request is done (EOS or
        budget)."""
        req = self._slot_req[slot]
        req.generated.append(int(token))
        now = self.clock()
        if req.first_token_time is None:
            req.first_token_time = now
            self.metrics.record_first_token(now - req.submit_time)
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

    def _admit_one(self, slot: int, req: Request) -> Tuple[int, int]:
        """Admit ``req`` into ``slot``: reuse the longest cached prefix,
        prefill only the uncached tail. Returns (tail tokens prefilled,
        cached tokens reused)."""
        t0 = req.total_len
        tokens = req.output_ids()
        plan = self._allocate_slot(slot, req)
        start = plan.cached_tokens
        tail = tokens[start:t0]
        ids = np.zeros((1, self._bucket_for(len(tail))), np.int32)
        ids[0, :len(tail)] = tail
        logits = self._prefill(ids, start, t0, self._tables[slot],
                               plan.cow_src or 0, plan.cow_len)
        tok0 = int(self._sample(logits, [req.seed],
                                [len(req.generated)])[0].item())
        if plan.cow_src is not None:
            self.pool.release([plan.cow_src])  # pinned for the copy only
        self._tok[slot] = tok0
        self._pos[slot] = t0
        self.metrics.record_admit()
        if self._append_token(slot, tok0):
            self._retire(slot)
        return len(tail), start

    # ------------------------------------------------------------------
    # chunked prefill (serve/longctx.py)
    # ------------------------------------------------------------------
    def _admit_slot_chunked(self, slot: int, req: Request) -> int:
        """Chunked admission: the request's WHOLE table allocated now,
        no prefill yet (:meth:`_feed_chunks` streams the uncached tail).
        ``_pos`` counts the positions holding valid K/V (the cached ones
        so far), so a publish on preemption stays right. Returns the
        prefix-cache hit."""
        plan = self._allocate_slot(slot, req)
        self._pos[slot] = plan.cached_tokens
        self._tok[slot] = 0
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
        ids = np.zeros((1, self._bucket_for(n)), np.int32)
        ids[0, :n] = tokens[st.next:st.next + n]
        cow = st.cow_pinned
        logits = self._prefill(ids, st.next, st.next + n, self._tables[slot],
                               st.cow_src if cow else 0,
                               st.cow_len if cow else 0)
        if cow:
            self.pool.release([st.cow_src])   # pinned for the copy only
            st.cow_pinned = False
        st.next += n
        self._pos[slot] = st.next
        if not st.done:
            return
        self._slot_chunk[slot] = None
        tok0 = int(self._sample(logits, [req.seed],
                                [len(req.generated)])[0].item())
        self._tok[slot] = tok0
        self.metrics.record_admit()
        if self._append_token(slot, tok0):
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
            if done:
                finished.append(self._retire(slot))
        return committed, drafted, accepted

    def step(self) -> List[int]:
        """One scheduler iteration: admit -> (chunked) feed the budget's
        chunks -> grow/preempt -> one decode step, or one verify step,
        for every generating slot -> retire. Returns the ids of the
        requests that finished this step."""
        finished: List[int] = []
        prefill_tokens = prefix_hit_tokens = 0
        while True:
            free = self._free_slots()
            req = self.scheduler.next_admission(len(free))
            if req is None:
                break
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
            nxt = self._decode(
                tok, pos, tables,
                [r.seed if r is not None else 0 for r in rows],
                [len(r.generated) if r is not None else 0 for r in rows])
            for slot in decoding:
                token = int(nxt[slot])
                self._tok[slot] = token
                self._pos[slot] += 1
                decode_tokens += 1
                if self._append_token(slot, token):
                    finished.append(self._retire(slot))

        self.metrics.record_step(
            running=len(self._active_slots()),
            waiting=len(self.scheduler.waiting),
            kv_blocks_used=self.pool.num_used,
            kv_blocks_total=self.pool.usable_blocks,
            kv_pool_bytes=self.pool.pool_bytes,
            kv_bytes_per_token=self.pool.bytes_per_token,
            prefill_tokens=prefill_tokens,
            decode_tokens=decode_tokens,
            prefix_hit_tokens=prefix_hit_tokens,
            spec_step=drafts is not None,
            draft_tokens=draft_tokens,
            accepted_draft_tokens=accepted_draft,
            prefill_chunks=prefill_chunks,
            kv_cache_evictions=self.pool.cache_evictions,
            **(self._drain_moe() if self._moe_on else {}))
        return finished

    def warmup(self) -> None:
        """Run every prefill bucket, the decode step and (with ``spec``)
        every verify bucket once before traffic (builds the CUDA kernel,
        warms the allocator and the BLAS handles). All-zero tables: every
        write lands in the null block; outputs are discarded and no
        request or metric state is touched."""
        zrow = np.zeros((self.table_width,), np.int32)
        for b in self.prefill_buckets:
            self._prefill(np.zeros((1, b), np.int32), 0, 1, zrow, 0, 0)
        zeros = [0] * len(self._tok)
        self._decode(np.zeros_like(self._tok), np.zeros_like(self._pos),
                     np.zeros_like(self._tables), zeros, zeros)
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


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
