"""Paged KV-cache pool: refcounted blocks + prefix cache + free list.

Port of ``quintnet_tpu/serve/kv_pool.py`` without the host tier and
chain export/import.

KV memory is one pool of ``num_blocks`` blocks of ``block_size`` token
slots shared by every in-flight request; each request's block table
references just the blocks its length needs. Device layout, per k and
v: ``[L, num_blocks * block_size, H_kv, Dh]`` tensors on the engine's
device, in the layout policy's store dtype (``serve/kv_quant.py``);
under a scaled policy (int8, fake_quant) also ``k_scale``/``v_scale``,
f32 ``[L, num_blocks, H_kv]`` per-block-per-head scales initialised to
ones. The serving kernels update them IN PLACE through per-layer
views, so :meth:`KVPool.update` only re-binds the (same) tensors.

Block 0 is the reserved NULL block: inactive rows point their table
rows and positions at it, so masked writes land where nobody reads.
The allocator hands out blocks ``[1, num_blocks)``.

Prefix caching, block-granular: every block carries a refcount; a
prefix index maps ``token_ids[:n]`` bytes (full blocks at block
boundaries, a trailing partial block at its exact count) to the block
holding positions ``[n - fill, n)``; retire/preempt PUBLISH blocks
instead of freeing them; refcount-zero published blocks are retained
in an LRU set and evicted only after the free list runs dry. A request
whose reusable chain ends inside a partial block copies it on write.

Speculative decoding's draft K/V lands in TENTATIVE blocks
(:meth:`KVPool.tentative_acquire`), which the engine commits or rolls
back within the step that took them; :meth:`KVPool.publish` refuses a
tentative block, so the prefix index only ever holds committed
positions.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from quintnet_tpu_torch.core.device import resolve_device
from quintnet_tpu_torch.serve.kv_quant import KVLayoutPolicy, make_policy

NULL_BLOCK = 0


@dataclass
class AdmitPlan:
    """Host-side admission plan for one request's token sequence:
    ``cached_tokens`` positions come from the prefix index —
    ``shared_blocks`` re-referenced whole, plus (chain ending inside a
    partial block) ``cow_src``'s first ``cow_len`` slots copied into
    the request's first private block — and ``n_new_blocks`` private
    blocks complete the table."""

    cached_tokens: int
    shared_blocks: List[int] = field(default_factory=list)
    cow_src: Optional[int] = None
    cow_len: int = 0
    n_new_blocks: int = 0

    @property
    def pinned_blocks(self) -> List[int]:
        """Blocks to refcount-pin before any allocation (allocation may
        evict refcount-zero cached blocks, this plan's own included)."""
        return self.shared_blocks + (
            [self.cow_src] if self.cow_src is not None else [])


class KVPool:
    """Refcounted block allocator + prefix cache over paged KV storage.
    ``prefix_cache=False`` disables the index (lookup misses, publish
    is a no-op, release always frees). The pools live on ``device``
    (``"cuda"`` by default; ``"cpu"`` only when asked)."""

    def __init__(self, *, n_layers: int, n_kv_heads: int, head_dim: int,
                 block_size: int, num_blocks: int,
                 policy: "KVLayoutPolicy | str | None" = None,
                 device="cuda", prefix_cache: bool = True):
        if block_size < 1 or num_blocks < 2:
            raise ValueError(
                f"need block_size >= 1 and num_blocks >= 2 (block 0 is "
                f"the reserved null block); got {block_size}, {num_blocks}")
        self.n_layers = n_layers
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.prefix_cache = bool(prefix_cache)
        self.policy: KVLayoutPolicy = make_policy(policy)
        device = resolve_device(device)
        shape = (n_layers, num_blocks * block_size, n_kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=self.policy.store_dtype,
                             device=device)
        self.v = torch.zeros(shape, dtype=self.policy.store_dtype,
                             device=device)
        self.k_scale = self.v_scale = None
        if self.policy.scaled:
            self.k_scale = torch.ones((n_layers, num_blocks, n_kv_heads),
                                      dtype=torch.float32, device=device)
            self.v_scale = torch.ones_like(self.k_scale)
        # LIFO free list (warm pages first) + O(1) membership
        self._free: List[int] = list(range(num_blocks - 1, NULL_BLOCK, -1))
        self._free_set: Set[int] = set(self._free)
        self._ref: List[int] = [0] * num_blocks
        self._index: Dict[bytes, int] = {}
        self._block_key: Dict[int, bytes] = {}
        self._cached_free: Set[int] = set()
        self._lru: Dict[int, int] = {}
        self._touch_counter = 0
        # lazy-deletion heap over (touch stamp, block)
        self._lru_heap: List[Tuple[int, int]] = []
        self._tentative: Set[int] = set()
        self.cache_evictions = 0

    # ---- accounting -------------------------------------------------
    @property
    def bytes_per_block(self) -> int:
        return self.policy.bytes_per_block(
            n_layers=self.n_layers, n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim, block_size=self.block_size)

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the pool's KV storage, scales included."""
        return self.num_blocks * self.bytes_per_block

    @property
    def bytes_per_token(self) -> float:
        return self.bytes_per_block / self.block_size

    @property
    def usable_blocks(self) -> int:
        """Blocks available to requests (null block excluded)."""
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_cached(self) -> int:
        """Refcount-zero blocks retained by the prefix index."""
        return len(self._cached_free)

    @property
    def num_available(self) -> int:
        """Blocks an acquire can produce: free + evictable cached."""
        return len(self._free) + len(self._cached_free)

    @property
    def num_used(self) -> int:
        return self.usable_blocks - self.num_free - self.num_cached

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_acquire(self, n: int) -> bool:
        return n <= self.num_available

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def is_cached(self, block: int) -> bool:
        """Is the block referenced by the prefix index (published)?"""
        return block in self._block_key

    # ---- acquire / release ------------------------------------------
    def _touch(self, b: int) -> None:
        self._touch_counter += 1
        self._lru[b] = self._touch_counter
        heapq.heappush(self._lru_heap, (self._touch_counter, b))
        if len(self._lru_heap) > 8 * self.num_blocks + 64:
            self._lru_heap = [(s, blk) for blk, s in self._lru.items()]
            heapq.heapify(self._lru_heap)

    def _evict_lru(self) -> int:
        """Drop the least-recently-touched refcount-zero cached block
        from the index and hand it back as a plain free block. Stale
        heap entries (re-touched or already evicted blocks) are skipped."""
        while self._lru_heap:
            stamp, b = heapq.heappop(self._lru_heap)
            if b in self._cached_free and self._lru.get(b) == stamp:
                break
        else:
            b = min(self._cached_free, key=self._lru.__getitem__)
        self._cached_free.remove(b)
        self._unpublish(b)
        self.cache_evictions += 1
        return b

    def _unpublish(self, b: int) -> None:
        key = self._block_key.pop(b, None)
        if key is not None and self._index.get(key) == b:
            del self._index[key]
        self._lru.pop(b, None)

    def acquire(self, n: int) -> Optional[List[int]]:
        """``n`` private blocks (refcount 1): free list first, then LRU
        eviction; None if even eviction cannot cover ``n`` (never a
        partial allocation)."""
        if n > self.num_available:
            return None
        taken: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
                self._free_set.remove(b)
            else:
                b = self._evict_lru()
            self._ref[b] = 1
            taken.append(b)
        return taken

    def acquire_cached(self, blocks: Sequence[int]) -> None:
        """Pin cached/shared blocks for one more holder."""
        for b in blocks:
            if self._ref[b] == 0:
                if b not in self._cached_free:
                    raise ValueError(
                        f"block {b} is neither referenced nor cached — "
                        f"cannot acquire it as a prefix hit")
                self._cached_free.remove(b)
            self._ref[b] += 1
            self._touch(b)

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per listed block; a block at refcount zero
        returns to the free list unless published (then it is retained,
        evictable)."""
        need: Dict[int, int] = {}
        for b in blocks:
            if not (NULL_BLOCK < b < self.num_blocks):
                raise ValueError(f"releasing invalid block id {b}")
            need[b] = need.get(b, 0) + 1
            if b in self._free_set or need[b] > self._ref[b]:
                raise ValueError(f"double free of block {b}")
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if b in self._block_key:
                    self._cached_free.add(b)
                else:
                    self._free.append(b)
                    self._free_set.add(b)

    # ---- tentative (speculative-tail) blocks -------------------------
    def is_tentative(self, block: int) -> bool:
        return block in self._tentative

    @property
    def num_tentative(self) -> int:
        return len(self._tentative)

    def tentative_acquire(self, n: int) -> Optional[List[int]]:
        """``n`` private blocks for a speculative tail, marked tentative
        until :meth:`commit_tentative` or :meth:`rollback_tentative` (the
        same allocator as :meth:`acquire`; None, never a part, when it
        cannot cover ``n``)."""
        got = self.acquire(n)
        if got is not None:
            self._tentative.update(got)
        return got

    def commit_tentative(self, blocks: Sequence[int]) -> None:
        """Accepted drafts reach into ``blocks``: they become ordinary
        private blocks of their request (the reference they hold is its
        table's)."""
        for b in blocks:
            if b not in self._tentative:
                raise ValueError(f"block {b} is not tentative")
            self._tentative.remove(b)

    def rollback_tentative(self, blocks: Sequence[int]) -> None:
        """Rejected drafts in ``blocks``: their reference is dropped and
        they go back to the allocator (never published, in no table)."""
        for b in blocks:
            if b not in self._tentative:
                raise ValueError(f"block {b} is not tentative")
            self._tentative.remove(b)
        self.release(blocks)

    # ---- prefix index -----------------------------------------------
    @staticmethod
    def _key(tokens: np.ndarray, n: int) -> bytes:
        """Index key for ``tokens[:n]``: the literal token bytes (not a
        hash, so two chains can never collide). The JAX twin prefixes
        an adapter namespace; adapters are not ported."""
        return np.ascontiguousarray(tokens[:n], dtype=np.int32).tobytes()

    def lookup(self, tokens, max_tokens: Optional[int] = None) -> AdmitPlan:
        """Longest cached chain for ``tokens``: full blocks at block
        boundaries, then the longest published partial leaf, capped at
        ``max_tokens``. Read-only."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        limit = len(tokens) if max_tokens is None else min(
            int(max_tokens), len(tokens))
        if not self.prefix_cache or limit <= 0:
            return AdmitPlan(cached_tokens=0)
        bs = self.block_size
        full: List[int] = []
        while (len(full) + 1) * bs <= limit:
            b = self._index.get(self._key(tokens, (len(full) + 1) * bs))
            if b is None:
                break
            full.append(b)
        m = len(full) * bs
        cow_src, cow_len = None, 0
        for f in range(min(bs - 1, limit - m), 0, -1):
            b = self._index.get(self._key(tokens, m + f))
            if b is not None:
                cow_src, cow_len = b, f
                break
        return AdmitPlan(cached_tokens=m + cow_len, shared_blocks=full,
                         cow_src=cow_src, cow_len=cow_len)

    def plan_admission(self, tokens, total_tokens: int) -> AdmitPlan:
        """Best ADMISSIBLE plan covering ``total_tokens`` slots: the
        longest cached chain plus private blocks. Near the capacity
        edge the longest-hit plan can need more simultaneous blocks
        than the pool holds, forever; degrade by dropping the COW hit,
        then to a cache-cold plan."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n_total = self.blocks_for(int(total_tokens))
        plan = self.lookup(tokens, max_tokens=len(tokens) - 1)
        plan.n_new_blocks = n_total - len(plan.shared_blocks)
        if self.can_admit(plan) or not plan.pinned_blocks:
            return plan
        if plan.cow_src is not None:
            plan = AdmitPlan(
                cached_tokens=len(plan.shared_blocks) * self.block_size,
                shared_blocks=plan.shared_blocks,
                n_new_blocks=plan.n_new_blocks)
            if self.can_admit(plan):
                return plan
        return AdmitPlan(cached_tokens=0, n_new_blocks=n_total)

    def can_admit(self, plan: AdmitPlan) -> bool:
        """Can ``plan.n_new_blocks`` be acquired once the plan's own
        chain is pinned (pinned blocks stop being evictable)?"""
        pinned_evictable = sum(1 for b in plan.pinned_blocks
                               if b in self._cached_free)
        return plan.n_new_blocks <= self.num_available - pinned_evictable

    def publish(self, tokens, blocks: Sequence[int],
                n_tokens: int) -> None:
        """Index ``blocks`` as the cached chain for ``tokens[:n_tokens]``
        (retire/preempt). Publish BEFORE release: release retains
        published blocks. A tentative block among those the chain uses is
        refused: published chains hold committed positions only."""
        if not self.prefix_cache or n_tokens <= 0:
            return
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n_tokens = min(int(n_tokens), len(tokens))
        q, f = divmod(n_tokens, self.block_size)
        bad = [b for b in blocks[:q + (1 if f else 0)]
               if b in self._tentative]
        if bad:
            raise ValueError(
                f"publish would index tentative block(s) {bad}: "
                f"speculative drafts must be committed or rolled back "
                f"before a request's blocks are published")
        for j in range(q):
            self._publish_one(blocks[j], self._key(
                tokens, (j + 1) * self.block_size))
        if f and q < len(blocks):
            self._publish_one(blocks[q], self._key(tokens, n_tokens))

    def _publish_one(self, b: int, key: bytes) -> None:
        cur = self._index.get(key)
        if cur == b:
            self._touch(b)
            return
        if cur is not None or b in self._block_key:
            return  # keep the incumbent mapping
        self._index[key] = b
        self._block_key[b] = key
        self._touch(b)

    # ---- device views ----------------------------------------------
    def caches(self):
        """``(k, v)`` pool tensors, plus ``(k_scale, v_scale)`` under a
        scaled policy, as the serving programs take them."""
        if self.policy.scaled:
            return self.k, self.v, self.k_scale, self.v_scale
        return self.k, self.v

    def update(self, *tensors) -> None:
        """Re-bind the pool tensors after a program ran (the port's
        programs update in place, so these are the same tensors): 2
        under a passthrough policy, 4 under a scaled one."""
        want = 4 if self.policy.scaled else 2
        if len(tensors) != want:
            raise ValueError(f"policy {self.policy.name!r} takes {want} "
                             f"pool tensors, got {len(tensors)}")
        self.k, self.v = tensors[:2]
        if self.policy.scaled:
            self.k_scale, self.v_scale = tensors[2:]
