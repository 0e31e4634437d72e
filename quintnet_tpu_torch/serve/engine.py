"""Continuous-batching step loop over the paged KV pool.

Port of ``quintnet_tpu/serve/engine.py``, default path only: one
device, greedy decoding, the f32 (or bf16 on the CPU) KV pool, prefix
cache on. Per step: admit waiting requests (each prefills only the
uncached tail of its prompt, in the smallest bucket that holds it) ->
grow every active slot's block table or preempt the youngest admission
-> one batched decode step for every active slot -> retire finished
rows.

- ``prefill``: one request at a time; the uncached tail right-padded to
  a power-of-two bucket (``analysis/specs.prefill_buckets``). With a
  prefix-cache hit the table references the cached blocks and the tail
  starts at an offset; a chain that ends inside a partially-filled
  cached block is copied on write into the request's first private
  block before the tail lands;
- ``decode``: ONE step for all ``max_slots`` rows; inactive rows point
  at the pool's null block and their outputs are dropped.

Every layer of both goes through ``ops.paged_attention`` — on the card
the hand-written CUDA kernel. PyTorch runs eagerly, so the bucket
ladder bounds tensor shapes rather than compiled programs.

Options of the JAX constructor that this port does not serve yet raise
``NotImplementedError`` naming their ROADMAP.md item; none is ignored.
Host<->device traffic per step is O(max_slots) integers plus the
sampled tokens; the pool and parameters stay on the device.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from quintnet_tpu_torch.analysis.specs import prefill_buckets
from quintnet_tpu_torch.core.device import resolve_device
from quintnet_tpu_torch.serve.families import Family
from quintnet_tpu_torch.serve.kv_pool import KVPool
from quintnet_tpu_torch.serve.kv_quant import make_policy
from quintnet_tpu_torch.serve.metrics import ServeMetrics
from quintnet_tpu_torch.serve.scheduler import (FINISHED, Request,
                                                Scheduler)

# constructor options of the JAX engine that are still to port, with
# the ROADMAP.md item each belongs to
_NOT_PORTED = {
    "spec": "'Serving features': serve/spec.py (speculative decoding)",
    "adapters": "'Serving features': serve/adapters.py (multi-LoRA)",
    "kv_tier_bytes": "'Serving features': serve/kv_tier.py (host KV tier)",
    "chunked_prefill": "'Serving features': serve/longctx.py (chunked "
                       "prefill)",
    "mesh": "'Serving features': tp/sp/ep serving meshes",
    "sp_axis": "'Serving features': serve/longctx.py (sp prefill)",
    "ep_axis": "'Serving features': MoE serving",
    "weights_dtype": "'Serving features': serve/weight_quant.py",
    "temperature": "'Generation': per-request RNG chain for sampled "
                   "serving",
}


def _not_ported(option: str, value):
    raise NotImplementedError(
        f"ServeEngine({option}={value!r}) is not ported yet (ROADMAP.md, "
        f"{_NOT_PORTED[option]})")


def check_admissible(prompt_len: int, max_new_tokens: int, *,
                     max_seq_len: int, usable_blocks: int,
                     block_size: int) -> None:
    """Submit-time rejection of requests an engine with these limits
    can NEVER run (standalone, so a dispatcher holding only
    ``limits()`` can check too). The prefill buckets cover
    ``max_seq_len``, so a preemption-resume prefill of prompt +
    generated always fits one."""
    if prompt_len < 1:
        raise ValueError("empty prompt")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    total = prompt_len + int(max_new_tokens)
    if total > max_seq_len:
        raise ValueError(
            f"prompt {prompt_len} + max_new {max_new_tokens} "
            f"exceeds max_seq_len={max_seq_len}")
    worst = -(-total // block_size)
    if worst > usable_blocks:
        raise ValueError(
            f"KV pool too small for this request: needs up to "
            f"{worst} blocks, pool has {usable_blocks} "
            f"usable (block_size={block_size})")


class ServeEngine:
    """Paged continuous-batching engine for one family on one device
    (``"cuda"`` by default; ``"cpu"`` only when asked). ``max_slots``
    rows decode together; the pool holds ``num_blocks`` blocks of
    ``block_size`` positions (block 0 is the null block)."""

    def __init__(self, family: Family, params, *, device="cuda",
                 max_slots: int = 8, block_size: int = 16,
                 num_blocks: int = 64, max_seq_len: Optional[int] = None,
                 prefix_cache: bool = True, spec=None, adapters=None,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, policy: str = "fcfs",
                 mesh=None, sp_axis: Optional[str] = None,
                 ep_axis: Optional[str] = None,
                 chunked_prefill: bool = False, kv_dtype=None,
                 weights_dtype=None, kv_tier_bytes: int = 0):
        for option, value in (
                ("spec", spec), ("adapters", adapters),
                ("kv_tier_bytes", kv_tier_bytes),
                ("chunked_prefill", chunked_prefill), ("mesh", mesh),
                ("sp_axis", sp_axis), ("ep_axis", ep_axis)):
            if value not in (None, False, 0):  # the JAX "off" values
                _not_ported(option, value)
        if weights_dtype not in (None, "f32"):
            _not_ported("weights_dtype", weights_dtype)
        if temperature > 0.0:
            _not_ported("temperature", temperature)
        self.device = resolve_device(device)
        self.family = family
        self.params = _to_device(params, self.device)
        self.max_slots = int(max_slots)
        self.eos_token_id = eos_token_id
        self.clock = time.monotonic
        self.prefix_cache = bool(prefix_cache)

        self.max_seq_len = int(max_seq_len or family.max_positions)
        if self.max_seq_len > family.max_positions:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"n_positions {family.max_positions}")
        # a preemption-resume prefills prompt + generated, up to the
        # whole sequence, so the bucket ladder covers max_seq_len
        self.prefill_buckets = prefill_buckets(self.max_seq_len)

        self.kv_policy = make_policy(
            kv_dtype if kv_dtype is not None else family.kv_dtype)
        if self.device.type == "cuda" and self.kv_policy.name != "f32":
            raise NotImplementedError(
                f"kv_dtype={self.kv_policy.name!r} on CUDA is not ported "
                f"yet: the paged-attention kernel reads f32 pools "
                f"(ROADMAP.md, 'TPU kernels to port': narrow K4 pools)")
        self.pool = KVPool(
            n_layers=family.n_layers, n_kv_heads=family.n_kv_heads,
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
        self._results: Dict[int, Request] = {}
        self._rid_counter = 0
        self._arrival_counter = 0

    # ------------------------------------------------------------------
    # the two programs
    # ------------------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.no_grad()
    def _prefill(self, ids: np.ndarray, start: int, t0: int,
                 table_row: np.ndarray, cow_src: int, cow_len: int) -> int:
        """Copy-on-write, then prefill the tail; returns the greedy
        next token. ``cow_len`` slots of block ``cow_src`` are copied
        into the block holding position ``start`` BEFORE the tail
        lands: the cached block stays immutable while the index
        references it."""
        bs = self.pool.block_size
        k_pool, v_pool = self.pool.caches()
        if cow_len > 0:
            dst = int(table_row[min(start // bs, len(table_row) - 1)])
            for pool in (k_pool, v_pool):
                pool[:, dst * bs:dst * bs + cow_len] = \
                    pool[:, cow_src * bs:cow_src * bs + cow_len]
        logits, k_pool, v_pool = self.family.prefill_from(
            self.params, k_pool, v_pool, self._dev(ids), start, t0,
            self._dev(table_row), bs)
        self.pool.update(k_pool, v_pool)
        return int(torch.argmax(logits[0]).item())

    @torch.no_grad()
    def _decode(self, tok: np.ndarray, pos: np.ndarray,
                tables: np.ndarray) -> np.ndarray:
        """One batched decode step; returns the greedy tokens [S]."""
        k_pool, v_pool = self.pool.caches()
        logits, k_pool, v_pool = self.family.decode(
            self.params, k_pool, v_pool, self._dev(tok), self._dev(pos),
            self._dev(tables), self.pool.block_size)
        self.pool.update(k_pool, v_pool)
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    # submission / results
    # ------------------------------------------------------------------
    def limits(self) -> Dict[str, int]:
        """The admissibility bounds :func:`check_admissible` takes."""
        return {"max_seq_len": self.max_seq_len,
                "usable_blocks": self.pool.usable_blocks,
                "block_size": self.pool.block_size}

    def submit(self, prompt, max_new_tokens: int, *, priority: int = 0,
               on_token=None) -> int:
        """Queue one greedy request; returns its id. ``on_token(rid,
        token, is_last)`` fires as each token is produced."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        check_admissible(prompt.size, max_new_tokens, **self.limits())
        rid = self._rid_counter
        self._rid_counter += 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      priority=int(priority),
                      arrival=self._arrival_counter, on_token=on_token)
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
        tok0 = self._prefill(ids, start, t0, self._tables[slot],
                             plan.cow_src or 0, plan.cow_len)
        if plan.cow_src is not None:
            self.pool.release([plan.cow_src])  # pinned for the copy only
        self._tok[slot] = tok0
        self._pos[slot] = t0
        self.metrics.record_admit()
        if self._append_token(slot, tok0):
            self._retire(slot)
        return len(tail), start

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

    def step(self) -> List[int]:
        """One scheduler iteration: admit -> grow/preempt -> one decode
        step for every active slot -> retire. Returns the ids of the
        requests that finished this step."""
        finished: List[int] = []
        prefill_tokens = prefix_hit_tokens = 0
        while True:
            free = self._free_slots()
            req = self.scheduler.next_admission(len(free))
            if req is None:
                break
            tail, hit = self._admit_one(free[0], req)
            prefill_tokens += tail
            prefix_hit_tokens += hit
            if self._slot_req[free[0]] is None:  # retired at prefill
                finished.append(req.rid)

        self._grow_or_preempt()

        decode_tokens = 0
        active = self._active_slots()
        if active:
            nxt = self._decode(self._tok, self._pos, self._tables)
            for slot in active:
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
            kv_cache_evictions=self.pool.cache_evictions)
        return finished

    def warmup(self) -> None:
        """Run every prefill bucket and the decode step once before
        traffic (builds the CUDA kernel, warms the allocator and the
        BLAS handles). All-zero tables: every write lands in the null
        block; outputs are discarded and no request or metric state is
        touched."""
        zrow = np.zeros((self.table_width,), np.int32)
        for b in self.prefill_buckets:
            self._prefill(np.zeros((1, b), np.int32), 0, 1, zrow, 0, 0)
        self._decode(np.zeros_like(self._tok), np.zeros_like(self._pos),
                     np.zeros_like(self._tables))

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
