"""Multi-tenant LoRA serving: the adapter registry and batch packing.

Port of ``quintnet_tpu/serve/adapters.py``. Many tenants fine-tune ONE
base model; merging each adapter into its own weights costs a replica a
tenant. S-LoRA and Punica keep the base shared and the adapters as
low-rank factors, and batch requests of different adapters into the
same forward, each row adding ``scale * (x @ A_slot) @ B_slot``
(``nn/layers.lora_delta``). This module is the host side of that:

- :class:`AdapterRegistry`: adapters by id, loaded from
  :func:`~quintnet_tpu_torch.models.lora.save_lora` safetensors files
  (onto the CPU) or registered as in-memory trees. Weights are an LRU
  under an optional ``byte_budget``: an evicted entry keeps its
  registration and reloads from its file at the next acquire.
  Refcounts pin the working set: an adapter held by a request in flight
  is never evicted.
- packing helpers: the engine binds one adapter a slot and packs them
  into stacked ``[L, S, in, r]`` / ``[L, S, r, out]`` tensors per target
  (zero rows for base-model slots: a zero adapter IS the base model),
  the rank padded to a bucket of ``analysis/specs.lora_rank_buckets``.

Every request's stream equals a dedicated engine serving that adapter's
``lora_merge_tree`` weights, up to the summation order of the delta.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from quintnet_tpu_torch.models.lora import LoRAConfig, _get, _target_paths


def adapter_paths(blocks, targets: Sequence[str]) -> List[Tuple[str, ...]]:
    """Paths (tuples of dict keys) of every adapted linear in a stacked
    block tree: the engine packs one (a, b) pair a path, in this
    order."""
    return _target_paths(blocks, targets)


def adapter_factor_paths(tree) -> List[Tuple[str, ...]]:
    """Paths of every (a, b) factor pair of a loaded adapter tree: what
    the adapter trained, whatever an engine serves. The engine refuses
    adapters with factors outside its packed paths (dropping a trained
    target would serve neither the adapter nor the base)."""
    out: List[Tuple[str, ...]] = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        if "a" in node and "b" in node and not isinstance(node["a"], dict):
            out.append(path)
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(tree, ())
    return out


def tree_at(tree, path):
    """``tree[path[0]]...[path[-1]]``, or None when a key is missing (an
    adapter that trains a subset of the engine's targets adds zero
    deltas at the rest)."""
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def nest(flat: Dict[Tuple[str, ...], object]) -> Dict:
    """{path: leaf} -> the nested dict the families take (the block
    tree's structure, so they route subtrees by name)."""
    out: Dict = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def packed_lora_spec_flat(block_specs, paths: Sequence[Tuple[str, ...]]):
    """{path: {"a": spec, "b": spec}} of the PACKED per-slot adapter
    tensors (the port's spec tuples, one entry a dim), from the stacked
    weight specs as ``models/lora.lora_partition_specs`` derives the
    training ones: for a weight spec over ``[L, in, out]``, ``a [L, S,
    in, r]`` takes the in dim's sharding and ``b [L, S, r, out]`` the out
    dim's. A column-parallel target then computes its local columns'
    delta, a row-parallel one a partial delta that the layer's sum over
    tp completes."""
    flat = {}
    for path in paths:
        wspec = tuple(_get(block_specs, path)["w"])
        wspec = wspec + (None,) * (3 - len(wspec))
        flat[path] = {"a": (None, None, wspec[-2], None),
                      "b": (None, None, None, wspec[-1])}
    return flat


def packed_lora_specs(block_specs, paths: Sequence[Tuple[str, ...]]):
    """:func:`packed_lora_spec_flat` nested like the packed tree."""
    return nest(packed_lora_spec_flat(block_specs, paths))


@dataclass
class AdapterEntry:
    """One registered adapter: its identity and config always, its
    weights while resident. ``refs`` counts pins of requests in flight;
    ``source`` is the safetensors file the weights reload from (an entry
    registered from an in-memory tree has none and is never evicted)."""

    adapter_id: str
    cfg: LoRAConfig
    source: Optional[str] = None
    tree: Optional[Dict] = None            # None <=> evicted
    nbytes: int = 0
    refs: int = 0
    last_used: float = 0.0
    loads: int = 0                         # times brought resident

    @property
    def rank(self) -> int:
        return self.cfg.rank

    @property
    def scale(self) -> float:
        return self.cfg.scale

    @property
    def resident(self) -> bool:
        return self.tree is not None

    @property
    def evictable(self) -> bool:
        return self.resident and self.refs == 0 and self.source is not None


def _tree_nbytes(tree) -> int:
    total = 0

    def walk(node):
        nonlocal total
        for v in node.values():
            if isinstance(v, dict):
                walk(v)
            else:
                total += int(v.nbytes)

    walk(tree)
    return total


def _load(source: str):
    """An adapter file's (tree, cfg), the tree on the CPU: the registry
    is a host store; binding copies one slot's factors to the device."""
    from quintnet_tpu_torch.models.lora import load_lora

    return load_lora(source, device="cpu")


class AdapterRegistry:
    """Host adapter store: register and evict by id, an LRU of weights
    under a byte budget, refcount pins (see the module docstring).

    Thread-safe (one re-entrant lock). ``byte_budget``: the resident
    weight ceiling in bytes (None: unbounded). It bounds the LRU cache,
    not the pinned working set: when every resident adapter is pinned the
    registry runs over budget rather than fail requests in flight, and
    eviction resumes as pins release."""

    def __init__(self, *, byte_budget: Optional[int] = None,
                 clock=time.monotonic, lock=None):
        if byte_budget is not None and byte_budget <= 0:
            raise ValueError(f"byte_budget must be positive or None; "
                             f"got {byte_budget}")
        self.byte_budget = byte_budget
        self.clock = clock
        # ``lock=`` takes a re-entrant analysis.lockrt InstrumentedLock
        # (audit.rlock), so a lock_audit=True fleet folds the registry
        # mutex into its order graph; re-entrant, as eviction runs under
        # registration's hold
        self._lock = lock if lock is not None else threading.RLock()
        self._entries: Dict[str, AdapterEntry] = {}
        self.evictions = 0

    # ---- registration ------------------------------------------------
    def register(self, adapter_id: str, source: Optional[str] = None, *,
                 tree: Optional[Dict] = None,
                 cfg: Optional[LoRAConfig] = None) -> AdapterEntry:
        """Make ``adapter_id`` servable, from a ``save_lora`` file
        (``source``: loaded now, reloadable after eviction) or from an
        in-memory ``(tree, cfg)`` pair (resident for good: there is no
        file to reload from). Registering an id twice raises."""
        if not adapter_id or "\x00" in adapter_id:
            raise ValueError(f"invalid adapter id {adapter_id!r}")
        if source is not None and (tree is not None or cfg is not None):
            raise ValueError(
                "register() takes a safetensors source path OR an "
                "in-memory (tree, cfg) pair, not both")
        with self._lock:
            if adapter_id in self._entries:
                raise ValueError(f"adapter {adapter_id!r} is already "
                                 f"registered")
            if source is not None:
                tree, cfg = _load(source)
            elif tree is None or cfg is None:
                raise ValueError(
                    "register() needs a safetensors source path or an "
                    "explicit (tree, cfg) pair")
            entry = AdapterEntry(adapter_id=adapter_id, cfg=cfg,
                                 source=source, tree=tree,
                                 nbytes=_tree_nbytes(tree), loads=1,
                                 last_used=self.clock())
            self._entries[adapter_id] = entry
            self._shrink_to_budget(keep=adapter_id)
            return entry

    def unregister(self, adapter_id: str) -> None:
        """Forget the adapter (refused while pinned)."""
        with self._lock:
            entry = self._require(adapter_id)
            if entry.refs > 0:
                raise ValueError(
                    f"adapter {adapter_id!r} is pinned by {entry.refs} "
                    f"in-flight request(s); cannot unregister")
            del self._entries[adapter_id]

    # ---- residency / LRU --------------------------------------------
    def _require(self, adapter_id: str) -> AdapterEntry:
        entry = self._entries.get(adapter_id)
        if entry is None:
            raise KeyError(f"unknown adapter id {adapter_id!r} "
                           f"(registered: {sorted(self._entries)})")
        return entry

    def _shrink_to_budget(self, keep: Optional[str] = None) -> None:
        if self.byte_budget is None:
            return
        while self.bytes_resident > self.byte_budget:
            cands = [e for e in self._entries.values()
                     if e.evictable and e.adapter_id != keep]
            if not cands:
                return  # everything left is pinned or has no source
            self._evict_entry(min(cands, key=lambda e: e.last_used))

    def _evict_entry(self, entry: AdapterEntry) -> None:
        entry.tree = None
        self.evictions += 1

    def ensure_resident(self, adapter_id: str) -> AdapterEntry:
        """Touch, and reload if evicted, without pinning."""
        with self._lock:
            entry = self._require(adapter_id)
            if not entry.resident:
                tree, cfg = _load(entry.source)
                if cfg != entry.cfg:
                    raise ValueError(
                        f"adapter {adapter_id!r} changed on disk: "
                        f"reloaded config {cfg} != registered "
                        f"{entry.cfg}; unregister and re-register to "
                        f"pick up the new weights")
                entry.tree = tree
                entry.nbytes = _tree_nbytes(tree)
                entry.loads += 1
            entry.last_used = self.clock()
            self._shrink_to_budget(keep=adapter_id)
            return entry

    def acquire(self, adapter_id: str) -> AdapterEntry:
        """Pin for one request in flight (loads it if evicted); pair with
        :meth:`release` when the request retires."""
        with self._lock:
            entry = self.ensure_resident(adapter_id)
            entry.refs += 1
            return entry

    def release(self, adapter_id: str) -> None:
        with self._lock:
            entry = self._require(adapter_id)
            if entry.refs <= 0:
                raise ValueError(
                    f"adapter {adapter_id!r} released more times than "
                    f"acquired")
            entry.refs -= 1
            self._shrink_to_budget()

    def evict(self, adapter_id: str) -> None:
        """Drop the weights now (the registration and its file stay).
        Refused while pinned and for entries without a file."""
        with self._lock:
            entry = self._require(adapter_id)
            if not entry.resident:
                return
            if entry.refs > 0:
                raise ValueError(
                    f"adapter {adapter_id!r} is pinned by {entry.refs} "
                    f"in-flight request(s); cannot evict")
            if entry.source is None:
                raise ValueError(
                    f"adapter {adapter_id!r} was registered from an "
                    f"in-memory tree (no reload source); unregister "
                    f"instead of evicting")
            self._evict_entry(entry)

    # ---- introspection ----------------------------------------------
    def entry(self, adapter_id: str) -> AdapterEntry:
        with self._lock:
            return self._require(adapter_id)

    def is_registered(self, adapter_id: str) -> bool:
        with self._lock:
            return adapter_id in self._entries

    def is_resident(self, adapter_id: str) -> bool:
        with self._lock:
            entry = self._entries.get(adapter_id)
            return entry is not None and entry.resident

    @property
    def adapter_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    @property
    def resident_ids(self) -> List[str]:
        with self._lock:
            return sorted(a for a, e in self._entries.items()
                          if e.resident)

    @property
    def bytes_resident(self) -> int:
        return sum(e.nbytes for e in self._entries.values() if e.resident)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "registered": len(self._entries),
                "resident": sum(1 for e in self._entries.values()
                                if e.resident),
                "pinned": sum(1 for e in self._entries.values()
                              if e.refs > 0),
                "bytes_resident": self.bytes_resident,
                "byte_budget": self.byte_budget,
                "evictions": self.evictions,
                "loads": sum(e.loads for e in self._entries.values()),
            }
