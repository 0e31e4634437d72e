"""Host-RAM second tier under the paged KV pool's prefix cache.

Port of ``quintnet_tpu/serve/kv_tier.py``. Without it, allocation
pressure that evicts a published chain destroys it, and the next request
for that prefix re-prefills it. With it, :meth:`KVPool._evict_lru`
DEMOTES the block here first: a host copy of its slot data exactly as
stored (the layout policy's ``store_dtype``, so int8 pools demote about
4x smaller records, plus the per-block-per-head scale rows when scaled),
one record of :meth:`KVPool.export_chain`'s format. Records are keyed by
the block's prefix-index key (the NUL-terminated adapter namespace plus
the literal token bytes), so host lookups walk the same key ladder as
device lookups and adapter namespaces stay apart across tiers.

Admission then has a third outcome besides a device hit and a miss: a
host hit, where the combined device and host walk covers more than the
device chain alone. The engine parks such a request in the
``PROMOTING`` state (``serve/scheduler.py``) and copies at most a
per-step block budget of records back to the device each step while
every other slot keeps decoding; then the ordinary admission finds the
promoted chain as a device prefix hit.

The tier is bounded: ``byte_budget`` caps the resident record bytes with
the tier's own LRU. A record evicted here is a miss, never an error:
every degraded path re-prefills, which is always token-correct.

Records are CPU tensors. On a tp rank a record holds the rank's kv-head
shard of a block; ``shards`` (the tp size) makes the tier count whole
blocks, as an unsharded tier does, so every rank evicts where it would.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def record_nbytes(rec: Dict) -> int:
    """Host bytes one demoted block record holds (slot data and scale
    rows): what the byte budget is held against."""
    n = rec["k"].nbytes + rec["v"].nbytes
    if "k_scale" in rec:
        n += rec["k_scale"].nbytes + rec["v_scale"].nbytes
    return n


class HostTier:
    """Bounded host store of demoted KV blocks, LRU-evicted.

    One record per demoted block in the ``export_chain`` per-block
    format (``{"fill", "k", "v"[, "k_scale", "v_scale"]}``), keyed by the
    block's prefix-index key. The tier is inclusive: a promoted record
    stays resident, so demoting the same block again is an overwrite.
    Single-threaded, like the pool that owns it."""

    def __init__(self, *, byte_budget: int, shards: int = 1):
        if byte_budget <= 0:
            raise ValueError(
                f"byte_budget must be > 0, got {byte_budget} "
                f"(a tier that can hold nothing is prefix_cache-only "
                f"— build the pool without a host tier instead)")
        self.byte_budget = int(byte_budget)
        self.shards = int(shards)
        self.bytes_used = 0
        # oldest -> newest: the OrderedDict is the tier's LRU
        self._records: "OrderedDict[bytes, Dict]" = OrderedDict()
        self.demotions = 0         # blocks demoted in
        self.promotions = 0        # blocks promoted back to the device
        self.promoted_tokens = 0   # token positions those blocks held
        self.evictions = 0         # records dropped for the budget

    def __len__(self) -> int:
        return len(self._records)

    def _nbytes(self, rec: Dict) -> int:
        return record_nbytes(rec) * self.shards

    def contains(self, key: bytes) -> bool:
        """Membership WITHOUT an LRU touch: the probe chain walks use
        (a walk must not rejuvenate records it never moves)."""
        return key in self._records

    def get(self, key: bytes) -> Optional[Dict]:
        """The record for ``key`` (LRU-touched), or None."""
        rec = self._records.get(key)
        if rec is not None:
            self._records.move_to_end(key)
        return rec

    def put(self, key: bytes, rec: Dict) -> bool:
        """Demote one block record, evicting least-recently-used records
        until the budget holds. A record larger than the whole budget is
        refused (False) rather than flushing the tier."""
        nbytes = self._nbytes(rec)
        if nbytes > self.byte_budget:
            return False
        old = self._records.pop(key, None)
        if old is not None:
            self.bytes_used -= self._nbytes(old)
        while self.bytes_used + nbytes > self.byte_budget:
            _k, dropped = self._records.popitem(last=False)
            self.bytes_used -= self._nbytes(dropped)
            self.evictions += 1
        self._records[key] = rec
        self.bytes_used += nbytes
        self.demotions += 1
        return True

    def summary(self) -> Dict:
        """The tier's counters as plain scalars."""
        return {"records": len(self._records),
                "bytes_used": self.bytes_used,
                "byte_budget": self.byte_budget,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "promoted_tokens": self.promoted_tokens,
                "evictions": self.evictions}


@dataclass
class PromotionState:
    """Progress of one request's host-to-device promotion (the
    ``ChunkState`` idiom of ``serve/longctx.py`` applied to copies): the
    request waits at the head of the queue in the ``PROMOTING`` state
    while the engine feeds at most its per-step block budget each step.
    When ``next`` reaches the end of ``keys`` (or the chain is cut short
    by a record evicted meanwhile) the request returns to ``WAITING`` and
    admission finds the promoted chain as a device prefix hit: whatever
    landed is cache, whatever did not is re-prefilled."""

    req: object                        # the owning scheduler Request
    keys: List[bytes] = field(default_factory=list)
    next: int = 0                      # keys[:next] already consumed

    @property
    def done(self) -> bool:
        return self.next >= len(self.keys)

    @property
    def remaining(self) -> int:
        return len(self.keys) - self.next
