"""Serving metrics: per-step gauges + per-request latency percentiles.

A copy of ``quintnet_tpu/serve/metrics.py`` (numpy-only; the port may
not import the JAX package). Counters the engine records every step
(running/waiting/preempted, KV-block utilization, prefill vs decode
tokens) and per-request marks (submit, first token, finish) from which
TTFT and tok/s percentiles are derived. Ledgers for features the port
does not serve yet stay at zero (inert until the feature is ported):
``spec_steps``/``draft_tokens``/``accepted_draft_tokens`` (speculation),
``chunk_steps``/``chunk_tokens`` (chunked prefill),
``kv_demotions``/``kv_promotions``/``host_hit_tokens``/
``host_tier_bytes`` (the host tier), the ``moe_*`` fields (MoE), the
per-adapter TTFTs (adapters); ``weights_dtype`` stays ``"f32"``. The
copy is kept whole so ``summary()`` has the JAX package's keys.

All timing uses a caller-injectable clock so tests can drive
deterministic "wall time" without sleeping.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

# default percentile-source bound (see Reservoir): exact below this,
# documented uniform sampling above it
RESERVOIR_CAP = 4096


class Reservoir:
    """Bounded percentile source: EXACT below ``cap`` observations,
    a uniform reservoir sample (Vitter's Algorithm R) above it.

    The percentile source lists (``ttfts``/``latencies``/``itls`` and
    the per-adapter TTFTs) previously grew without limit — a
    long-running replica leaked one float per request/token forever.
    The reservoir keeps memory O(cap) while every stored element
    remains an unbiased uniform draw from the full stream, so the
    p50/p95 estimates stay honest; p99 degrades gracefully (documented
    sampling error ~1/sqrt(cap)). ``n`` is the TRUE stream count —
    ``summary()`` surfaces it so a reader can tell exact-mode
    (``n <= cap``) from sampled.

    List-compatible surface (append/extend/iter/len/bool/indexing) so
    ``aggregate()``'s pooling — extend into a plain list, percentiles
    over the pool — keeps working unchanged; pooling reservoirs pools
    their retained samples, which stays uniform per-replica.

    Deterministic: the replacement RNG is seeded per-instance, so two
    replays of the same trace summarize identically (the bench's A/B
    discipline)."""

    __slots__ = ("cap", "n", "_items", "_rng")

    def __init__(self, cap: int = RESERVOIR_CAP, *, seed: int = 0):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.n = 0
        self._items: List[float] = []
        self._rng = random.Random(seed)

    def append(self, x: float) -> None:
        self.n += 1
        if len(self._items) < self.cap:
            self._items.append(float(x))
            return
        j = self._rng.randrange(self.n)      # Algorithm R
        if j < self.cap:
            self._items[j] = float(x)

    def extend(self, xs) -> None:
        for x in xs:
            self.append(x)

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __eq__(self, other):
        if isinstance(other, Reservoir):
            return self._items == other._items
        return self._items == other

    def to_list(self) -> List[float]:
        return list(self._items)


def _pooled_pcts(groups) -> Dict[str, float]:
    """Fleet-wide percentiles over several replicas' percentile
    sources, each a ``(samples, true_n)`` pair where ``samples`` may
    be a reservoir-capped subset of a ``true_n``-long stream.

    When every group is exact (``true_n == len(samples)``) this is
    plain pooling — concatenate and take percentiles, bit-identical
    to the pre-reservoir behavior. When any replica exceeded its cap,
    naive pooling would weight every RETAINED sample equally and bias
    the fleet tail toward low-traffic replicas (a 100k-request replica
    and a 5k-request one both retain cap samples); instead each
    retained sample is weighted by the number of observations it
    represents (``true_n / len(samples)``) and the percentiles come
    from the weighted inverted CDF — an unbiased estimate of the true
    pooled distribution, since each reservoir is a uniform draw from
    its own stream."""
    groups = [(list(s), int(n)) for s, n in groups]
    total_n = sum(n for _s, n in groups)
    if all(n == len(s) for s, n in groups):
        pooled: List[float] = []
        for s, _n in groups:
            pooled.extend(s)
        return _pcts(pooled, n=total_n)
    vals: List[float] = []
    wts: List[float] = []
    for s, n in groups:
        if not s:
            continue
        w = n / len(s)
        vals.extend(s)
        wts.extend([w] * len(s))
    if not vals:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "n": total_n}
    v = np.asarray(vals, np.float64)
    w = np.asarray(wts, np.float64)
    order = np.argsort(v)
    v, w = v[order], w[order]
    cw = np.cumsum(w)
    out: Dict[str, float] = {}
    for name, p in (("p50", 50), ("p95", 95), ("p99", 99)):
        idx = int(np.searchsorted(cw, p / 100.0 * cw[-1]))
        out[name] = float(v[min(idx, len(v) - 1)])
    out["n"] = total_n
    return out


def _pcts(xs, n: Optional[int] = None) -> Dict[str, float]:
    """Percentiles over a source list/Reservoir. ``n`` reports the
    TRUE observation count behind the (possibly reservoir-sampled)
    stored values; it defaults to the source's own ``n`` (Reservoir)
    or its length (plain pooled list)."""
    stored = xs if isinstance(xs, list) else list(xs)
    if n is None:
        n = getattr(xs, "n", len(stored))
    if not stored:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "n": int(n)}
    a = np.asarray(stored, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)),
            "n": int(n)}


@dataclass
class ServeMetrics:
    clock: "callable" = time.monotonic

    # step gauges (overwritten each step) ----------------------------
    running: int = 0
    waiting: int = 0
    kv_blocks_used: int = 0
    kv_blocks_total: int = 0
    # KV capacity gauges (policy-aware, serve/kv_quant.py): the pool's
    # total device bytes and per-resident-token bytes — what makes an
    # equal-bytes capacity A/B legible next to peak_kv_utilization
    # (an int8 pool shows ~4x the blocks at the same kv_pool_bytes)
    kv_pool_bytes: int = 0
    kv_bytes_per_token: float = 0.0
    # weight layout gauges (serve/weight_quant.py): device bytes of the
    # packed weight targets (w + w_scale) and the policy name — the
    # f32/int8 weight_bytes ratio is the decode-bandwidth win the A/B
    # gate ratios (>= 3.5x for int8). Mirrored each step like
    # kv_pool_bytes; the engine owns the truth.
    weight_bytes: int = 0
    weights_dtype: str = "f32"

    # monotone counters ----------------------------------------------
    steps: int = 0
    admitted: int = 0
    preempted: int = 0
    finished: int = 0
    # requests retired MID-GENERATION (or while waiting) because their
    # deadline passed — typed DeadlineExceeded, blocks published
    # (serve/engine.py _sweep_deadlines); disjoint from `finished`
    deadline_exceeded: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    # prefix-cache ledger: hit tokens are prompt positions served from
    # the cached block chain at admission — exactly the prefill tokens
    # SAVED (they were never recomputed); prefill_tokens above counts
    # only the uncached tail actually pushed through a prefill program
    prefix_hit_tokens: int = 0
    # speculative-decoding ledger (serve/spec.py): decode_steps counts
    # decode/verify program invocations (the denominator that makes
    # multi-token commits visible: tokens_per_decode_step > 1 is the
    # speculation win); spec_steps of those ran a verify bucket;
    # draft_tokens were proposed, accepted_draft_tokens committed
    decode_steps: int = 0
    spec_steps: int = 0
    draft_tokens: int = 0
    accepted_draft_tokens: int = 0
    # chunked-prefill ledger (serve/longctx.py): prefill_chunks counts
    # chunk program invocations; chunk_steps the engine steps that ran
    # >= 1 chunk; chunk_tokens the prompt tokens those steps pushed
    # through chunk programs — chunk_tokens / chunk_steps is the
    # realized per-step prefill spend the Sarathi budget caps
    prefill_chunks: int = 0
    chunk_steps: int = 0
    chunk_tokens: int = 0
    # tiered-KV ledger (serve/kv_tier.py): CUMULATIVE pool/tier
    # counters mirrored (assigned, not summed) each step — the pool
    # owns the truth, the mirror makes eviction/demotion/promotion
    # visible to summary()/aggregate() and the Prometheus exporter.
    # kv_cache_evictions: published device blocks evicted (tier off:
    # chains destroyed; tier on: each eviction first demotes).
    # kv_demotions / kv_promotions: blocks copied device->host /
    # host->device; kv_host_evictions: host records dropped by the
    # tier's own byte-budget LRU; host_hit_tokens: token positions
    # re-promoted from host instead of re-prefilled;
    # decode_blocked_demotions: demotions observed during a plain
    # decode dispatch — structurally 0 (the bench gates it).
    kv_cache_evictions: int = 0
    kv_demotions: int = 0
    kv_promotions: int = 0
    kv_host_evictions: int = 0
    host_hit_tokens: int = 0
    decode_blocked_demotions: int = 0
    # gauge: host bytes the tier currently holds (<= its byte budget)
    host_tier_bytes: int = 0
    peak_kv_utilization: float = 0.0
    peak_running: int = 0

    # MoE routing ledger (nn/moe.py routing stats, drained by the
    # engine once per step; absent for dense families — summary()
    # gates the keys on MoE activity so dense exposition stays
    # byte-identical). moe_routed_tokens counts token-expert
    # assignments the router DEMANDED (pre-capacity-cut, summed over
    # layers and programs: S * top_k per MoE layer per invocation);
    # moe_dropped_tokens the assignments the capacity cut discarded;
    # moe_expert_tokens the cumulative per-expert demand [E] (the
    # honest skew signal — post-cut counts saturate at capacity under
    # a hot expert); entropy is the mean per-token router entropy,
    # averaged over the steps that reported it
    moe_routed_tokens: float = 0.0
    moe_dropped_tokens: float = 0.0
    moe_expert_tokens: Optional[np.ndarray] = None
    moe_entropy_sum: float = 0.0
    moe_stat_steps: int = 0

    # per-adapter ledger (multi-tenant LoRA, serve/adapters.py):
    # adapter id -> {"requests": finished, "gen_tokens": generated,
    # "ttfts": Reservoir} — the per-tenant slice of the totals above
    # (base-model traffic is the remainder)
    per_adapter: Dict[str, Dict] = field(default_factory=dict)

    # per-request marks (percentile SOURCES, reservoir-bounded: exact
    # below RESERVOIR_CAP observations, uniform sampling above — a
    # long-running replica's memory stays O(cap); summary() surfaces
    # the true count as "n" beside the percentiles) -------------------
    ttfts: Reservoir = field(default_factory=Reservoir)
    latencies: Reservoir = field(default_factory=Reservoir)
    # inter-token gaps (seconds between a request's consecutive
    # tokens, pooled across requests) — the decode-starvation signal:
    # a monolithic prefill shows up as one giant gap in every
    # concurrent stream, a budgeted chunked prefill does not
    itls: Reservoir = field(default_factory=Reservoir)
    _t0: Optional[float] = None
    _t_end: Optional[float] = None

    # ---- recording --------------------------------------------------
    def record_step(self, *, running: int, waiting: int,
                    kv_blocks_used: int, kv_blocks_total: int,
                    prefill_tokens: int, decode_tokens: int,
                    prefix_hit_tokens: int = 0,
                    spec_step: bool = False,
                    draft_tokens: int = 0,
                    accepted_draft_tokens: int = 0,
                    prefill_chunks: int = 0,
                    kv_pool_bytes: int = 0,
                    kv_bytes_per_token: float = 0.0,
                    weight_bytes: int = 0,
                    weights_dtype: str = "f32",
                    kv_cache_evictions: int = 0,
                    kv_demotions: int = 0,
                    kv_promotions: int = 0,
                    kv_host_evictions: int = 0,
                    host_hit_tokens: int = 0,
                    host_tier_bytes: int = 0,
                    decode_blocked_demotions: int = 0,
                    moe_routed_tokens: float = 0.0,
                    moe_dropped_tokens: float = 0.0,
                    moe_expert_tokens=None,
                    moe_router_entropy: Optional[float] = None) -> None:
        now = self.clock()
        if self._t0 is None:
            self._t0 = now
        self._t_end = now
        self.steps += 1
        self.running = running
        self.waiting = waiting
        self.kv_blocks_used = kv_blocks_used
        self.kv_blocks_total = kv_blocks_total
        self.kv_pool_bytes = kv_pool_bytes
        self.kv_bytes_per_token = kv_bytes_per_token
        self.weight_bytes = weight_bytes
        self.weights_dtype = weights_dtype
        self.prefill_tokens += prefill_tokens
        self.decode_tokens += decode_tokens
        self.prefix_hit_tokens += prefix_hit_tokens
        if decode_tokens > 0:
            self.decode_steps += 1
        if spec_step:
            self.spec_steps += 1
        self.draft_tokens += draft_tokens
        self.accepted_draft_tokens += accepted_draft_tokens
        self.prefill_chunks += prefill_chunks
        if prefill_chunks > 0:
            self.chunk_steps += 1
            self.chunk_tokens += prefill_tokens
        # tier ledger: cumulative mirrors (assigned, never summed —
        # the engine passes the pool/tier counters' current values)
        self.kv_cache_evictions = kv_cache_evictions
        self.kv_demotions = kv_demotions
        self.kv_promotions = kv_promotions
        self.kv_host_evictions = kv_host_evictions
        self.host_hit_tokens = host_hit_tokens
        self.host_tier_bytes = host_tier_bytes
        self.decode_blocked_demotions = decode_blocked_demotions
        self.moe_routed_tokens += float(moe_routed_tokens)
        self.moe_dropped_tokens += float(moe_dropped_tokens)
        if moe_expert_tokens is not None:
            et = np.asarray(moe_expert_tokens, np.float64)
            if self.moe_expert_tokens is None:
                self.moe_expert_tokens = np.zeros_like(et)
            self.moe_expert_tokens = self.moe_expert_tokens + et
        if moe_router_entropy is not None:
            self.moe_entropy_sum += float(moe_router_entropy)
            self.moe_stat_steps += 1
        util = kv_blocks_used / max(kv_blocks_total, 1)
        self.peak_kv_utilization = max(self.peak_kv_utilization, util)
        self.peak_running = max(self.peak_running, running)

    def record_admit(self) -> None:
        self.admitted += 1

    def record_preempt(self) -> None:
        self.preempted += 1

    def record_deadline_exceeded(self) -> None:
        self.deadline_exceeded += 1

    def _adapter(self, adapter_id: str) -> Dict:
        return self.per_adapter.setdefault(
            adapter_id,
            {"requests": 0, "gen_tokens": 0, "ttfts": Reservoir()})

    def record_adapter_token(self, adapter_id: str) -> None:
        """One generated token attributed to ``adapter_id`` (the engine
        calls this beside its committed-token bookkeeping, so adapter
        ledgers count exactly the tokens the tenant received HERE —
        a migrated request's earlier tokens stay on the exporter)."""
        self._adapter(adapter_id)["gen_tokens"] += 1

    def record_first_token(self, ttft_s: float,
                           adapter_id: Optional[str] = None) -> None:
        self.ttfts.append(ttft_s)
        if adapter_id is not None:
            self._adapter(adapter_id)["ttfts"].append(ttft_s)

    def record_itl(self, gap_s: float) -> None:
        """One inter-token gap (seconds since the same request's
        previous token)."""
        self.itls.append(gap_s)

    def record_finish(self, latency_s: float,
                      adapter_id: Optional[str] = None) -> None:
        self.finished += 1
        self.latencies.append(latency_s)
        if adapter_id is not None:
            self._adapter(adapter_id)["requests"] += 1

    # ---- reporting --------------------------------------------------
    @property
    def gen_tokens(self) -> int:
        """GENERATED tokens: every admission samples exactly one
        (prefill) token; the rest come from decode steps. The single
        definition behind ``tokens_per_sec`` — consumers (the serve
        bench) read it here rather than re-deriving it."""
        return self.decode_tokens + self.admitted

    @property
    def wall_s(self) -> float:
        if self._t0 is None or self._t_end is None:
            return 0.0
        return max(self._t_end - self._t0, 0.0)

    @property
    def prefill_tokens_saved(self) -> int:
        """Prefill tokens never computed because the prefix cache
        already held them (== prefix_hit_tokens; the name states what
        the number buys)."""
        return self.prefix_hit_tokens

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of required prefill positions served from the
        cache: hit / (hit + actually-prefilled)."""
        denom = self.prefix_hit_tokens + self.prefill_tokens
        return self.prefix_hit_tokens / denom if denom else 0.0

    @property
    def host_hit_rate(self) -> float:
        """Fraction of all warm-or-computed prefill positions that
        were served by a HOST-tier promotion rather than device cache
        or fresh prefill: host_hit / (prefix_hit + prefill). Promoted
        positions surface again as prefix_hit_tokens when the request
        admits (the promoted chain is a device hit by then), so the
        denominator already contains the numerator — the rate reads
        as "share of prefill demand the host tier rescued"."""
        denom = self.prefix_hit_tokens + self.prefill_tokens
        return self.host_hit_tokens / denom if denom else 0.0

    @property
    def tokens_per_decode_step(self) -> float:
        """Mean tokens committed per decode/verify invocation, summed
        over the batch — ~(mean active slots) for plain decoding (one
        token per active row per step), multiplied by the mean accepted
        run length when speculation commits drafts. An A/B over the
        SAME trace isolates the speculation factor; in isolation the
        number conflates concurrency with acceptance."""
        return (self.decode_tokens / self.decode_steps
                if self.decode_steps else 0.0)

    @property
    def draft_acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify step committed."""
        return (self.accepted_draft_tokens / self.draft_tokens
                if self.draft_tokens else 0.0)

    @property
    def chunk_tokens_per_step(self) -> float:
        """Mean prompt tokens pushed through chunk programs per
        chunk-running engine step — bounded above by the engine's
        ``prefill_chunk_budget`` (the Sarathi cap made observable)."""
        return (self.chunk_tokens / self.chunk_steps
                if self.chunk_steps else 0.0)

    @property
    def moe_drop_rate(self) -> float:
        """Fraction of routed token-expert assignments the capacity
        cut discarded."""
        return (self.moe_dropped_tokens / self.moe_routed_tokens
                if self.moe_routed_tokens else 0.0)

    @property
    def moe_expert_skew(self) -> float:
        """max/mean of cumulative per-expert routed demand — 1.0 is
        perfectly balanced, E is a single hot expert taking all of
        it."""
        et = self.moe_expert_tokens
        if et is None or float(np.sum(et)) == 0.0:
            return 0.0
        return float(np.max(et) / np.mean(et))

    @property
    def moe_router_entropy(self) -> float:
        """Mean per-token router-distribution entropy over the steps
        that reported one (nats; ln(E) is uniform)."""
        return (self.moe_entropy_sum / self.moe_stat_steps
                if self.moe_stat_steps else 0.0)

    def summary(self) -> Dict:
        """One JSON-able dict: throughput, TTFT/latency percentiles,
        peak pool pressure. tok/s counts GENERATED (decode + prefill-
        sampled) tokens — the serving-throughput number, not prompt
        reading speed. MoE keys appear only when routing stats were
        recorded, so a dense engine's summary is byte-identical to
        what it was before MoE serving existed."""
        wall = self.wall_s
        gen_tokens = self.gen_tokens
        out = {
            "steps": self.steps,
            "gen_tokens": gen_tokens,
            "admitted": self.admitted,
            "finished": self.finished,
            "preempted": self.preempted,
            "deadline_exceeded": self.deadline_exceeded,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefix_hit_rate": round(self.prefix_hit_rate, 4),
            "decode_steps": self.decode_steps,
            "tokens_per_decode_step": round(self.tokens_per_decode_step, 4),
            "spec_steps": self.spec_steps,
            "draft_tokens": self.draft_tokens,
            "accepted_draft_tokens": self.accepted_draft_tokens,
            "draft_acceptance_rate": round(self.draft_acceptance_rate, 4),
            "prefill_chunks": self.prefill_chunks,
            "chunk_steps": self.chunk_steps,
            "chunk_tokens": self.chunk_tokens,
            "chunk_tokens_per_step": round(self.chunk_tokens_per_step, 4),
            "kv_cache_evictions": self.kv_cache_evictions,
            "kv_demotions": self.kv_demotions,
            "kv_promotions": self.kv_promotions,
            "kv_host_evictions": self.kv_host_evictions,
            "host_hit_tokens": self.host_hit_tokens,
            "host_hit_rate": round(self.host_hit_rate, 4),
            "host_tier_bytes": self.host_tier_bytes,
            "decode_blocked_demotions": self.decode_blocked_demotions,
            "wall_s": round(wall, 4),
            "tokens_per_sec": round(gen_tokens / wall, 2) if wall > 0
            else 0.0,
            "ttft_s": _pcts(self.ttfts),
            "latency_s": _pcts(self.latencies),
            "itl_s": _pcts(self.itls),
            "peak_kv_utilization": round(self.peak_kv_utilization, 4),
            "kv_pool_bytes": self.kv_pool_bytes,
            "kv_bytes_per_token": round(self.kv_bytes_per_token, 4),
            "weight_bytes": self.weight_bytes,
            "weights_dtype": self.weights_dtype,
            "peak_running": self.peak_running,
            "adapters": {
                aid: {"requests": d["requests"],
                      "gen_tokens": d["gen_tokens"],
                      "ttft_s": _pcts(d["ttfts"])}
                for aid, d in sorted(self.per_adapter.items())},
        }
        if self.moe_stat_steps or self.moe_routed_tokens:
            out["moe_routed_tokens"] = int(self.moe_routed_tokens)
            out["moe_dropped_tokens"] = int(self.moe_dropped_tokens)
            out["moe_drop_rate"] = round(self.moe_drop_rate, 4)
            out["moe_expert_skew"] = round(self.moe_expert_skew, 4)
            out["moe_router_entropy"] = round(self.moe_router_entropy,
                                              4)
            out["moe_expert_tokens"] = (
                {str(e): int(v)
                 for e, v in enumerate(self.moe_expert_tokens)}
                if self.moe_expert_tokens is not None else {})
        return out

    def log_step(self, logger: Optional[logging.Logger], *,
                 every: int = 1) -> None:
        if logger is None or self.steps % max(every, 1):
            return
        logger.info(
            "serve step=%d running=%d waiting=%d kv=%d/%d (%.0f%%) "
            "prefill_toks=%d decode_toks=%d preempted=%d finished=%d",
            self.steps, self.running, self.waiting, self.kv_blocks_used,
            self.kv_blocks_total,
            100.0 * self.kv_blocks_used / max(self.kv_blocks_total, 1),
            self.prefill_tokens, self.decode_tokens, self.preempted,
            self.finished)


def aggregate(all_metrics: List["ServeMetrics"]) -> Dict:
    """Fleet-level roll-up of several engines' :class:`ServeMetrics`
    into one summary-shaped dict (the JAX package's fleet reads it for
    the whole-fleet throughput line).

    Counters are summed; the TTFT/latency percentile SOURCES (now
    reservoir-bounded, see :class:`Reservoir`) are pooled per replica
    with each retained sample weighted by the observations it
    represents (:func:`_pooled_pcts`) — true fleet-wide tails, not an
    average of per-replica percentiles, and not biased toward
    low-traffic replicas when a busy one exceeded its cap; the wall
    clock spans the earliest first step to the latest last step across
    replicas, so ``tokens_per_sec`` is aggregate fleet throughput, not
    a per-replica mean. Replicas that never stepped contribute
    counters only."""
    t0s = [m._t0 for m in all_metrics if m._t0 is not None]
    ends = [m._t_end for m in all_metrics if m._t_end is not None]
    wall = (max(ends) - min(t0s)) if t0s and ends else 0.0
    wall = max(wall, 0.0)
    gen_tokens = sum(m.gen_tokens for m in all_metrics)

    def _true_n(src) -> int:
        return getattr(src, "n", len(src))

    def _group(src):
        return (src, _true_n(src))

    ttft_groups = [_group(m.ttfts) for m in all_metrics]
    lat_groups = [_group(m.latencies) for m in all_metrics]
    itl_groups = [_group(m.itls) for m in all_metrics]
    # per-adapter ledgers merge the same way the totals do: counters
    # summed across replicas, TTFT sources pooled (weighted) before
    # percentiles
    adapters: Dict[str, Dict] = {}
    for m in all_metrics:
        for aid, d in m.per_adapter.items():
            agg = adapters.setdefault(
                aid, {"requests": 0, "gen_tokens": 0, "groups": []})
            agg["requests"] += d["requests"]
            agg["gen_tokens"] += d["gen_tokens"]
            agg["groups"].append(_group(d["ttfts"]))
    hit = sum(m.prefix_hit_tokens for m in all_metrics)
    host_hit = sum(m.host_hit_tokens for m in all_metrics)
    prefill = sum(m.prefill_tokens for m in all_metrics)
    dsteps = sum(m.decode_steps for m in all_metrics)
    dtok = sum(m.decode_tokens for m in all_metrics)
    drafted = sum(m.draft_tokens for m in all_metrics)
    accepted = sum(m.accepted_draft_tokens for m in all_metrics)
    out = {
        "replicas": len(all_metrics),
        "steps": sum(m.steps for m in all_metrics),
        "gen_tokens": gen_tokens,
        "admitted": sum(m.admitted for m in all_metrics),
        "finished": sum(m.finished for m in all_metrics),
        "preempted": sum(m.preempted for m in all_metrics),
        "deadline_exceeded": sum(m.deadline_exceeded
                                 for m in all_metrics),
        "prefill_tokens": prefill,
        "decode_tokens": dtok,
        "prefix_hit_tokens": hit,
        "prefill_tokens_saved": hit,
        "prefix_hit_rate": round(hit / (hit + prefill), 4)
        if (hit + prefill) else 0.0,
        "decode_steps": dsteps,
        "tokens_per_decode_step": round(dtok / dsteps, 4) if dsteps
        else 0.0,
        "spec_steps": sum(m.spec_steps for m in all_metrics),
        "draft_tokens": drafted,
        "accepted_draft_tokens": accepted,
        "draft_acceptance_rate": round(accepted / drafted, 4) if drafted
        else 0.0,
        "prefill_chunks": sum(m.prefill_chunks for m in all_metrics),
        "chunk_steps": sum(m.chunk_steps for m in all_metrics),
        "chunk_tokens": sum(m.chunk_tokens for m in all_metrics),
        "chunk_tokens_per_step": round(
            sum(m.chunk_tokens for m in all_metrics)
            / max(sum(m.chunk_steps for m in all_metrics), 1), 4),
        "kv_cache_evictions": sum(m.kv_cache_evictions
                                  for m in all_metrics),
        "kv_demotions": sum(m.kv_demotions for m in all_metrics),
        "kv_promotions": sum(m.kv_promotions for m in all_metrics),
        "kv_host_evictions": sum(m.kv_host_evictions
                                 for m in all_metrics),
        "host_hit_tokens": host_hit,
        "host_hit_rate": round(host_hit / (hit + prefill), 4)
        if (hit + prefill) else 0.0,
        # fleet host-tier residency is the SUM of the replicas' tiers
        # (each replica spills to its own host RAM)
        "host_tier_bytes": sum(m.host_tier_bytes for m in all_metrics),
        "decode_blocked_demotions": sum(m.decode_blocked_demotions
                                        for m in all_metrics),
        "wall_s": round(wall, 4),
        "tokens_per_sec": round(gen_tokens / wall, 2) if wall > 0 else 0.0,
        "ttft_s": _pooled_pcts(ttft_groups),
        "latency_s": _pooled_pcts(lat_groups),
        "itl_s": _pooled_pcts(itl_groups),
        "peak_kv_utilization": round(
            max((m.peak_kv_utilization for m in all_metrics), default=0.0),
            4),
        # fleet KV memory is the SUM of the replicas' pools; bytes per
        # token is a per-replica layout property — report the worst
        # (largest) so a mixed-policy fleet surfaces its heaviest pool
        "kv_pool_bytes": sum(m.kv_pool_bytes for m in all_metrics),
        "kv_bytes_per_token": round(
            max((m.kv_bytes_per_token for m in all_metrics), default=0.0),
            4),
        # fleet weight residency is the SUM of the replicas' packed
        # trees; the dtype roll-up names every policy in play so a
        # mixed-layout fleet is legible at a glance
        "weight_bytes": sum(m.weight_bytes for m in all_metrics),
        "weights_dtype": ",".join(sorted(
            {m.weights_dtype for m in all_metrics if m.weights_dtype}))
        or "f32",
        "peak_running": max((m.peak_running for m in all_metrics),
                            default=0),
        "adapters": {
            aid: {"requests": d["requests"],
                  "gen_tokens": d["gen_tokens"],
                  "ttft_s": _pooled_pcts(d["groups"])}
            for aid, d in sorted(adapters.items())},
    }
    # MoE roll-up mirrors summary(): counters summed across replicas,
    # per-expert demand summed elementwise, keys gated on activity so
    # a dense fleet's aggregate is unchanged
    moe_routed = sum(m.moe_routed_tokens for m in all_metrics)
    moe_steps = sum(m.moe_stat_steps for m in all_metrics)
    if moe_steps or moe_routed:
        moe_dropped = sum(m.moe_dropped_tokens for m in all_metrics)
        ets = [m.moe_expert_tokens for m in all_metrics
               if m.moe_expert_tokens is not None]
        et = np.sum(ets, axis=0) if ets else None
        out["moe_routed_tokens"] = int(moe_routed)
        out["moe_dropped_tokens"] = int(moe_dropped)
        out["moe_drop_rate"] = (round(moe_dropped / moe_routed, 4)
                                if moe_routed else 0.0)
        out["moe_expert_skew"] = (
            round(float(np.max(et) / np.mean(et)), 4)
            if et is not None and float(np.sum(et)) else 0.0)
        out["moe_router_entropy"] = (
            round(sum(m.moe_entropy_sum for m in all_metrics)
                  / moe_steps, 4) if moe_steps else 0.0)
        out["moe_expert_tokens"] = (
            {str(e): int(v) for e, v in enumerate(et)}
            if et is not None else {})
    return out
