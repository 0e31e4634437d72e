"""Paged KV-cache pool: refcounted blocks + prefix cache + free list.

Port of ``quintnet_tpu/serve/kv_pool.py``.

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

Keys are namespaced: every key is the requesting adapter's id
(``serve/adapters.py``; empty for the base model) and a NUL, then the
literal token bytes, so a chain written under one adapter is a hit only
for that adapter.

A host tier (``host_tier=``, ``serve/kv_tier.HostTier``) catches what
eviction would destroy: a published block is demoted to a host record
first (a device-to-host copy on the allocation path, never inside a
decode dispatch), and :meth:`KVPool.promote_chain` copies records back
under a block budget. Chains move as :meth:`KVPool.export_chain` /
:meth:`KVPool.import_chain` records, the tier's format.

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
from quintnet_tpu_torch.ops.paged_attention import _bytes_view
from quintnet_tpu_torch.serve.kv_quant import KVLayoutPolicy, make_policy
from quintnet_tpu_torch.serve.kv_tier import HostTier

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
    is a no-op, release always frees) and the host tier. The pools live
    on ``device`` (``"cuda"`` by default; ``"cpu"`` only when asked)."""

    def __init__(self, *, n_layers: int, n_kv_heads: int, head_dim: int,
                 block_size: int, num_blocks: int,
                 policy: "KVLayoutPolicy | str | None" = None,
                 device="cuda", prefix_cache: bool = True,
                 host_tier: Optional[HostTier] = None):
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
        self._block_fill: Dict[int, int] = {}     # published slots used
        self._cached_free: Set[int] = set()
        self._lru: Dict[int, int] = {}
        self._touch_counter = 0
        # lazy-deletion heap over (touch stamp, block)
        self._lru_heap: List[Tuple[int, int]] = []
        self._tentative: Set[int] = set()
        self.cache_evictions = 0
        # host tier: eviction demotes published blocks instead of
        # destroying them (nothing is retained without the prefix cache)
        self.host_tier = host_tier if self.prefix_cache else None

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
        if self.host_tier is not None:
            self._demote(b)
        self._cached_free.remove(b)
        self._unpublish(b)
        self.cache_evictions += 1
        return b

    def _block_slots(self, b: int) -> slice:
        return slice(b * self.block_size, (b + 1) * self.block_size)

    def _demote(self, b: int) -> bool:
        """Copy published block ``b`` to the host tier before eviction
        destroys it: one export-format record (the block's slot data as
        stored, its scale rows when scaled) under the block's prefix-index
        key. A device-to-host copy that waits for the card: it runs on
        the allocation path only, never inside a decode dispatch."""
        key = self._block_key.get(b)
        fill = self._block_fill.get(b, 0)
        if key is None or fill <= 0:
            return False
        sl = self._block_slots(b)
        rec = {"fill": int(fill), "k": _to_host(self.k[:, sl]),
               "v": _to_host(self.v[:, sl])}
        if self.policy.scaled:
            rec["k_scale"] = _to_host(self.k_scale[:, b])
            rec["v_scale"] = _to_host(self.v_scale[:, b])
        return self.host_tier.put(key, rec)

    def _unpublish(self, b: int) -> None:
        key = self._block_key.pop(b, None)
        if key is not None and self._index.get(key) == b:
            del self._index[key]
        self._block_fill.pop(b, None)
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
    def _key(tokens: np.ndarray, n: int,
             namespace: Optional[str] = None) -> bytes:
        """Index key for ``tokens[:n]``: the NUL-terminated ``namespace``
        (the adapter id; empty for the base model) and the literal token
        bytes (not a hash, so two chains can never collide). Adapter ids
        hold no NUL, so the first NUL always ends the namespace."""
        body = np.ascontiguousarray(tokens[:n], dtype=np.int32).tobytes()
        if namespace is None:
            return b"\x00" + body
        return namespace.encode("utf-8") + b"\x00" + body

    def lookup(self, tokens, max_tokens: Optional[int] = None, *,
               namespace: Optional[str] = None) -> AdmitPlan:
        """Longest cached chain for ``tokens`` under ``namespace``: full
        blocks at block boundaries, then the longest published partial
        leaf, capped at ``max_tokens``. Read-only."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        limit = len(tokens) if max_tokens is None else min(
            int(max_tokens), len(tokens))
        if not self.prefix_cache or limit <= 0:
            return AdmitPlan(cached_tokens=0)
        bs = self.block_size
        full: List[int] = []
        while (len(full) + 1) * bs <= limit:
            b = self._index.get(self._key(tokens, (len(full) + 1) * bs,
                                          namespace))
            if b is None:
                break
            full.append(b)
        m = len(full) * bs
        cow_src, cow_len = None, 0
        for f in range(min(bs - 1, limit - m), 0, -1):
            b = self._index.get(self._key(tokens, m + f, namespace))
            if b is not None:
                cow_src, cow_len = b, f
                break
        return AdmitPlan(cached_tokens=m + cow_len, shared_blocks=full,
                         cow_src=cow_src, cow_len=cow_len)

    def plan_admission(self, tokens, total_tokens: int, *,
                       namespace: Optional[str] = None) -> AdmitPlan:
        """Best ADMISSIBLE plan covering ``total_tokens`` slots: the
        longest cached chain plus private blocks. Near the capacity
        edge the longest-hit plan can need more simultaneous blocks
        than the pool holds, forever; degrade by dropping the COW hit,
        then to a cache-cold plan."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n_total = self.blocks_for(int(total_tokens))
        plan = self.lookup(tokens, max_tokens=len(tokens) - 1,
                           namespace=namespace)
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

    def publish(self, tokens, blocks: Sequence[int], n_tokens: int, *,
                namespace: Optional[str] = None) -> None:
        """Index ``blocks`` as the cached chain for ``tokens[:n_tokens]``
        (retire/preempt) under ``namespace``, the adapter whose programs
        wrote it. Publish BEFORE release: release retains published
        blocks. A tentative block among those the chain uses is refused:
        published chains hold committed positions only."""
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
                tokens, (j + 1) * self.block_size, namespace),
                self.block_size)
        if f and q < len(blocks):
            self._publish_one(blocks[q], self._key(tokens, n_tokens,
                                                   namespace), f)

    def _publish_one(self, b: int, key: bytes, fill: int) -> None:
        cur = self._index.get(key)
        if cur == b:
            self._touch(b)
            return
        if cur is not None or b in self._block_key:
            return  # keep the incumbent mapping
        self._index[key] = b
        self._block_key[b] = key
        self._block_fill[b] = fill
        self._touch(b)

    # ---- host tier: the combined walk, peek, promotion --------------
    def _walk_chain(self, tokens: np.ndarray, limit: int,
                    namespace: Optional[str]) -> Tuple[int, List[Tuple]]:
        """The longest chain covering ``tokens[:limit]`` from EITHER
        tier: :meth:`lookup`'s walk, but a boundary missing from the
        device index may be a host record. Returns ``(covered tokens,
        entries)`` in chain order: ``("dev", block, fill)`` or
        ``("host", key, fill)``. Read-only (host probes do not touch the
        tier's LRU)."""
        entries: List[Tuple] = []
        if not self.prefix_cache or limit <= 0:
            return 0, entries
        tier = self.host_tier
        bs = self.block_size
        n = 0
        while (n + 1) * bs <= limit:
            key = self._key(tokens, (n + 1) * bs, namespace)
            b = self._index.get(key)
            if b is not None:
                entries.append(("dev", b, bs))
            elif tier is not None and tier.contains(key):
                entries.append(("host", key, bs))
            else:
                break
            n += 1
        m = n * bs
        for f in range(min(bs - 1, limit - m), 0, -1):
            key = self._key(tokens, m + f, namespace)
            b = self._index.get(key)
            if b is not None:
                entries.append(("dev", b, f))
                m += f
                break
            if tier is not None and tier.contains(key):
                entries.append(("host", key, f))
                m += f
                break
        return m, entries

    def peek_chain_tokens(self, tokens, *,
                          namespace: Optional[str] = None) -> int:
        """Token positions this pool could serve warm for ``tokens``:
        the device chain and its host-tier extension. Moves, pins and
        touches nothing."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        return self._walk_chain(tokens, len(tokens), namespace)[0]

    def plan_promotion(self, tokens, max_tokens: Optional[int] = None, *,
                       namespace: Optional[str] = None,
                       ) -> Tuple[int, List[bytes]]:
        """The host records a promotion must bring back so the DEVICE
        chain covers all the combined walk does: ``(covered tokens, host
        keys)``. Empty keys: nothing to promote (a device hit, or a miss
        in both tiers). The three admission outcomes in one probe:
        device hit (covered > 0, no keys), host hit (keys), miss
        (covered == 0)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        limit = len(tokens) if max_tokens is None else min(
            int(max_tokens), len(tokens))
        if self.host_tier is None:
            return 0, []
        covered, entries = self._walk_chain(tokens, limit, namespace)
        return covered, [e[1] for e in entries if e[0] == "host"]

    def _write_blocks(self, blocks: Sequence[int], records) -> None:
        """Records' slot data (and scale rows) into ``blocks``, byte for
        byte: one scatter a pool tensor (float8 through its bytes)."""
        dev = self.k.device
        idx = torch.cat([torch.arange(b * self.block_size,
                                      (b + 1) * self.block_size)
                         for b in blocks]).to(dev)
        for pool, name in ((self.k, "k"), (self.v, "v")):
            new = torch.cat([r[name] for r in records], dim=1).to(
                dev, self.policy.store_dtype)
            _bytes_view(pool)[:, idx] = _bytes_view(new)
        if self.policy.scaled:
            barr = torch.as_tensor(list(blocks), dtype=torch.long,
                                   device=dev)
            for sc, name in ((self.k_scale, "k_scale"),
                             (self.v_scale, "v_scale")):
                sc[:, barr] = torch.stack([r[name] for r in records],
                                          dim=1).to(dev, torch.float32)

    def promote_chain(self, keys: Sequence[bytes], *,
                      max_blocks: Optional[int] = None) -> Tuple[int, int]:
        """Copy up to ``max_blocks`` host records back into fresh device
        blocks (:meth:`_write_blocks`), publish each under its own key
        and release them: the chain lands refcount-zero in the retention
        set, a device prefix hit for the next admission.

        Returns ``(keys consumed, blocks promoted)``: the engine's feed
        advances its cursor by the first and charges the second to its
        budget. A key already on the device is consumed for free. A key
        missing from the tier (its record was evicted meanwhile) cuts the
        chain there: no device walk reaches past the gap, so the rest is
        consumed unpromoted and admission re-prefills from the gap."""
        keys = list(keys)
        if self.host_tier is None or not keys:
            return len(keys), 0
        budget = len(keys) if max_blocks is None else max(0,
                                                          int(max_blocks))
        avail = self.num_available
        taken = 0
        todo: List[Tuple[bytes, Dict]] = []
        terminal = False
        for key in keys:
            if key in self._index:
                taken += 1
                continue
            if len(todo) >= budget or len(todo) >= avail:
                break       # out of budget or capacity: next step
            rec = self.host_tier.get(key)
            if rec is None:
                terminal = True
                break
            todo.append((key, rec))
            taken += 1
        if todo:
            blocks = self.acquire(len(todo))
            assert blocks is not None  # len(todo) <= num_available
            self._write_blocks(blocks, [r for _, r in todo])
            for b, (key, rec) in zip(blocks, todo):
                self._publish_one(b, key, int(rec["fill"]))
            self.release(blocks)
            self.host_tier.promotions += len(todo)
            self.host_tier.promoted_tokens += sum(
                int(r["fill"]) for _, r in todo)
        if terminal:
            taken = len(keys)
        return taken, len(todo)

    # ---- chain export / import --------------------------------------
    def export_chain(self, tokens, *,
                     namespace: Optional[str] = None) -> Optional[Dict]:
        """The longest PUBLISHED chain for ``tokens`` as host records,
        across both tiers: device blocks by one gather a pool tensor,
        host blocks from their records. Each record holds one block's slot
        data as stored and its scale rows when scaled, so an import is a
        byte-exact replica. None when nothing is cached for the prefix.
        Read-only, beyond the host records' LRU touch."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        _covered, entries = self._walk_chain(tokens, len(tokens),
                                             namespace)
        if not entries:
            return None
        bs = self.block_size
        dev = [(j, e[1]) for j, e in enumerate(entries) if e[0] == "dev"]
        if dev:
            idx = torch.cat([torch.arange(b * bs, (b + 1) * bs)
                             for _, b in dev]).to(self.k.device)
            k_all = _to_host(_bytes_view(self.k)[:, idx]).view(
                self.k.dtype)
            v_all = _to_host(_bytes_view(self.v)[:, idx]).view(
                self.v.dtype)
            if self.policy.scaled:
                barr = torch.as_tensor([b for _, b in dev],
                                       dtype=torch.long,
                                       device=self.k.device)
                ks_all = _to_host(self.k_scale[:, barr])
                vs_all = _to_host(self.v_scale[:, barr])
        dev_slot = {j: s for s, (j, _b) in enumerate(dev)}
        records: List[Dict] = []
        n_out = 0
        for j, (kind, ref, fill) in enumerate(entries):
            if kind == "dev":
                s = dev_slot[j]
                rec = {"fill": int(fill),
                       "k": k_all[:, s * bs:(s + 1) * bs],
                       "v": v_all[:, s * bs:(s + 1) * bs]}
                if self.policy.scaled:
                    rec["k_scale"] = ks_all[:, s]
                    rec["v_scale"] = vs_all[:, s]
            else:
                rec = self.host_tier.get(ref)
                if rec is None:
                    break       # a hole: ship the chain up to it
            records.append(rec)
            n_out += int(fill)
        if not records:
            return None
        return {"tokens": tokens[:n_out].copy(), "n_tokens": int(n_out),
                "policy": self.policy.name, "block_size": bs,
                "n_layers": self.n_layers, "n_kv_heads": self.n_kv_heads,
                "head_dim": self.head_dim, "blocks": records}

    def _check_chain_geometry(self, chain: Dict) -> None:
        mine = {"policy": self.policy.name,
                "block_size": self.block_size,
                "n_layers": self.n_layers,
                "n_kv_heads": self.n_kv_heads,
                "head_dim": self.head_dim}
        theirs = {k: chain[k] for k in mine}
        if theirs != mine:
            diffs = {k: (theirs[k], mine[k]) for k in mine
                     if theirs[k] != mine[k]}
            raise ValueError(
                f"KV chain layout does not match this pool "
                f"({{field: (chain, pool)}} = {diffs}) — the exporting "
                f"and importing engines must be built from the same "
                f"spec (same KV layout policy and pool geometry)")

    def import_chain(self, chain: Dict, *,
                     namespace: Optional[str] = None) -> int:
        """Admit an exported chain as a warm prefix hit: write its
        records into fresh blocks byte for byte, publish them under the
        chain's tokens, release (retained like a retired request's).
        Returns the token positions now served from cache (0 when the
        pool can hold none of it or the prefix cache is off). A chain
        larger than the pool can hold imports its longest block-aligned
        prefix that fits (the tail, any partial leaf included, is
        dropped: the chain is cache, a part of it is still correct).
        Keys already published keep their incumbent block."""
        self._check_chain_geometry(chain)
        records = chain["blocks"]
        n_tokens = int(chain["n_tokens"])
        if not self.prefix_cache or n_tokens <= 0 or not records:
            return 0
        q, f = divmod(n_tokens, self.block_size)
        if len(records) != q + (1 if f else 0):
            raise ValueError(
                f"KV chain block count {len(records)} does not cover "
                f"n_tokens={n_tokens} at block_size={self.block_size}")
        n_fit = min(len(records), self.num_available)
        if n_fit <= 0:
            return 0
        if n_fit < len(records):
            records = records[:n_fit]
            n_tokens = n_fit * self.block_size
        blocks = self.acquire(len(records))
        assert blocks is not None  # capacity checked above
        self._write_blocks(blocks, records)
        tokens = np.asarray(chain["tokens"], np.int32).reshape(-1)
        self.publish(tokens, blocks, n_tokens, namespace=namespace)
        self.release(blocks)
        return n_tokens

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


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t`` (a copy on the CPU too: a record must not
    alias the pool)."""
    return t.detach().to("cpu", copy=True)
