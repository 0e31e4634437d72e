"""Declarative specs: the expected collective census of every strategy
and serving program, the shape ladders the serving engine derives its
programs from, and the expected thread spawns of the fleet.

Port of ``quintnet_tpu/analysis/specs.py`` (the port keeps its own copy:
importing anything under ``quintnet_tpu`` pulls in jax). Each
``expected_*`` function returns the per-axis collective counts
(``{axis: {op: count}}``) that one call of the program puts on the
wire, derived from program structure — parameter-leaf counts, depth,
microbatch count — never measured and pasted.
``analysis/step_audit.collective_census`` counts the real calls, and
tests/test_torch_census.py holds the two equal in gloo worlds (and each
port formula equal to JAX's where the port puts the same count on the
wire), so any change to the communication pattern of ``parallel/`` or
``serve/`` fails with a named per-axis diff.

Census terms, for reading the formulas below:

- **leaf mean** — ``reduce_grads`` averages every gradient leaf over
  the data axes: one all_reduce per parameter leaf, plus one for the
  loss.
- **row-parallel sum** — each transformer block holds two row-parallel
  projections (attention out-proj, MLP down-proj): 2 all_reduces per
  block per forward; the backward sums the replicated cotangents again
  (the autograd transpose), so a depth-L forward and backward
  contribute ``4 L``.
- **replicated-grad sum** — leaves replicated over tp (LayerNorms,
  embeddings) receive rank-partial gradients and are summed over tp:
  one all_reduce per tp-replicated leaf.
- **clip-norm sum** — ``clip_sharded_grads`` sums the local
  sum-of-squares of every SHARDED leaf over its sharding axes: one
  all_reduce per sharded leaf when ``grad_clip_norm`` is set.
- **ZeRO terms** — ZeRO-1 re-assembles updated params with ONE
  all_gather (the chunks ravel into one flat vector); ZeRO-2 replaces
  the per-leaf dp mean with ONE reduce_scatter into the rank's chunk
  plus one all_reduce for the chunk-space clip norm.

A collective over an axis of size 1 is the identity in the port and
puts nothing on the wire, so a census only ever names axes of size > 1.

This module stays free of torch imports: ``THREAD_SPAWN_SPECS`` below
is read by ``ast.literal_eval`` (analysis/threads.load_thread_specs).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

CensusDict = Dict[str, Dict[str, int]]


def _merge(*censuses: CensusDict) -> CensusDict:
    out: CensusDict = {}
    for c in censuses:
        for axis, ops in c.items():
            cur = out.setdefault(axis, {})
            for op, n in ops.items():
                cur[op] = cur.get(op, 0) + n
    return out


def _spec_axes(spec) -> set:
    axes = set()
    for part in spec:
        if isinstance(part, (tuple, list)):
            axes.update(part)
        elif part is not None:
            axes.add(part)
    return axes


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    else:
        yield tree


def spec_leaf_counts(param_specs, axis: str) -> Tuple[int, int, int]:
    """(total, replicated-over-axis, sharded-over-axis) leaf counts of a
    param-spec tree (the port's specs: nested dicts of tuples, one entry
    per dim) — the structural inputs to the formulas below."""
    leaves = list(_spec_leaves(param_specs))
    sharded = sum(1 for s in leaves if axis in _spec_axes(s))
    return len(leaves), len(leaves) - sharded, sharded


def expected_dp_train_step(n_param_leaves: int, *,
                           dp_axis: str = "dp") -> CensusDict:
    """The train step on a dp-only mesh: one mean per gradient leaf +
    the loss mean (``parallel/train_step.reduce_grads``, leaf by leaf
    in place, as JAX's pmean per leaf)."""
    return {dp_axis: {"all_reduce": n_param_leaves + 1}}


def expected_tp_train_step(depth: int, n_tp_replicated: int,
                           n_tp_sharded: int, *, tp_axis: str = "tp",
                           row_collectives_per_block: int = 2,
                           grad_clip: bool = True,
                           n_micro: int = 1) -> CensusDict:
    """tp-only train step of a stacked-block model (ViT/GPT-2 layout:
    QKV column-sharded, projections row-sharded):

      2 row-parallel sums/block x depth x (forward + backward)
        x n_micro
      + one sum per tp-replicated gradient leaf
      + one sum per tp-sharded leaf for the global clip norm.

    ``n_micro``: the gradient-accumulation micro-batches, each its own
    forward and backward (JAX's formula is the ``n_micro = 1`` case).
    No data axis -> no loss mean."""
    fwd_bwd = 2 * row_collectives_per_block * depth * n_micro
    n = fwd_bwd + n_tp_replicated + (n_tp_sharded if grad_clip else 0)
    return {tp_axis: {"all_reduce": n}}


def expected_dp_tp_train_step(n_param_leaves: int, depth: int,
                              n_tp_replicated: int, n_tp_sharded: int,
                              *, dp_axis: str = "dp",
                              tp_axis: str = "tp",
                              grad_clip: bool = True,
                              n_micro: int = 1) -> CensusDict:
    """2-axis dp x tp mesh: the dp and tp patterns compose without
    cross terms — dp sees exactly its dp-only census, tp exactly its
    tp-only one."""
    return _merge(
        expected_dp_train_step(n_param_leaves, dp_axis=dp_axis),
        expected_tp_train_step(depth, n_tp_replicated, n_tp_sharded,
                               tp_axis=tp_axis, grad_clip=grad_clip,
                               n_micro=n_micro))


def expected_zero1_train_step(n_param_leaves: int, *,
                              dp_axis: str = "dp") -> CensusDict:
    """ZeRO-1: the dp-only census plus ONE all_gather re-assembling the
    updated flat parameter vector from per-rank chunks
    (parallel/zero.py). Gradient traffic is unchanged — ZeRO-1's
    contract (state sharded, grads still all-reduced)."""
    return {dp_axis: {"all_reduce": n_param_leaves + 1, "all_gather": 1}}


def expected_zero2_train_step(*, dp_axis: str = "dp",
                              grad_clip: bool = True) -> CensusDict:
    """ZeRO-2: the per-leaf dp means collapse into ONE reduce_scatter of
    the flat grad vector straight into the rank's chunk; the loss mean
    stays; clipping sums one chunk-space sum-of-squares; one all_gather
    re-assembles params."""
    return {dp_axis: {
        "all_reduce": 1 + (1 if grad_clip else 0),
        "reduce_scatter": 1,
        "all_gather": 1,
    }}


def expected_3d_train_step(n_param_leaves: int, depth: int,
                           n_tp_replicated: int, n_tp_sharded: int,
                           n_pp_replicated: int, n_pp_sharded: int,
                           n_micro: int, pp_size: int, *,
                           dp_axis: str = "dp",
                           tp_axis: Optional[str] = "tp",
                           pp_axis: str = "pp",
                           grad_clip: bool = True,
                           store_activations: bool = False,
                           zero_stage: Optional[int] = None) -> CensusDict:
    """3D (dp x tp x pp) 1F1B train step of one rank (``depth``: the
    model's whole depth; ``tp_axis=None``: a dp x pp mesh).

    - dp: unchanged leaf means + loss mean (``zero_stage`` 1 or 2: that
      ZeRO census on dp instead);
    - tp: the forward+backward row-parallel sums run once per
      MICROBATCH over the rank's own stage, ``depth / pp_size`` blocks,
      and the memory-lean 1F1B variant (``store_activations=False``)
      recomputes each forward inside the backward — one extra forward's
      worth of sums per microbatch. Here the port differs from JAX's
      formula, which counts ``depth`` blocks per microbatch (its one
      SPMD program is pinned with every stage's whole schedule): an
      eager rank runs only its stage's blocks, and only for real
      micro-batches;
    - pp: one sum per pp-REPLICATED gradient leaf, one per pp-SHARDED
      leaf for the clip norm, one for the loss, plus the schedule's
      boundary shifts, ``2 * n_micro + 4 * (pp_size - 1)``, as JAX's.

    Under ZeRO-2 the clip norm is ONE sum of the chunk-space
    sum-of-squares over the whole mesh (parallel/zero.py), so each model
    axis's clip term is 1 instead of its sharded-leaf count (JAX's
    formulas have no ZeRO-2 on a model axis).
    """
    def clip(n_sharded: int) -> int:
        if not grad_clip:
            return 0
        return 1 if zero_stage == 2 else n_sharded

    per_block = 2
    fwd = per_block * (depth // pp_size)
    ppermutes = 2 * n_micro + 4 * (pp_size - 1)
    if zero_stage == 2:
        dp = expected_zero2_train_step(dp_axis=dp_axis, grad_clip=grad_clip)
    elif zero_stage == 1:
        dp = expected_zero1_train_step(n_param_leaves, dp_axis=dp_axis)
    else:
        dp = expected_dp_train_step(n_param_leaves, dp_axis=dp_axis)
    out = dict(dp)
    if tp_axis is not None:
        out[tp_axis] = {"all_reduce": (
            n_micro * (2 + (0 if store_activations else 1)) * fwd
            + n_tp_replicated + clip(n_tp_sharded))}
    out[pp_axis] = {"all_reduce": n_pp_replicated + clip(n_pp_sharded) + 1,
                    "ppermute": ppermutes}
    return out


# ---------------------------------------------------------------------------
# serving programs (quintnet_tpu_torch/serve/engine.py)


def expected_serve_prefill(n_layers: int, *,
                           tp_axis: Optional[str] = None,
                           vocab_parallel: bool = False) -> CensusDict:
    """One prefill call: 2 row-parallel sums per block under tp
    (attention out-proj + MLP down-proj — forward only), plus the
    vocab-parallel embedding sum and logits all_gather when the
    vocabulary is sharded. Single-device: ZERO collectives. Independent
    of the bucket width and of the prefix-cache split, so every bucket
    must match this same spec."""
    if tp_axis is None:
        return {}
    c: CensusDict = {tp_axis: {"all_reduce": 2 * n_layers}}
    if vocab_parallel:
        c[tp_axis]["all_reduce"] += 1   # vocab_parallel_embedding sum
        c[tp_axis]["all_gather"] = 1    # vocab_parallel_logits gather
    return c


def expected_serve_decode(n_layers: int, *,
                          tp_axis: Optional[str] = None,
                          vocab_parallel: bool = False) -> CensusDict:
    """One decode step for ALL slots: the prefill census — the engine
    adds batching, paging and sampling but NO collectives."""
    return expected_serve_prefill(n_layers, tp_axis=tp_axis,
                                  vocab_parallel=vocab_parallel)


def expected_serve_verify(n_layers: int, *,
                          tp_axis: Optional[str] = None,
                          vocab_parallel: bool = False) -> CensusDict:
    """One verify call: the decode census exactly — verify is the decode
    step widened to bucket+1 tokens a row."""
    return expected_serve_decode(n_layers, tp_axis=tp_axis,
                                 vocab_parallel=vocab_parallel)


def expected_serve_moe(n_layers: int, *,
                       ep_axis: Optional[str] = None,
                       tp_axis: Optional[str] = None,
                       vocab_parallel: bool = False) -> CensusDict:
    """One serving call (prefill, decode or verify) of an MoE family
    whose experts are sharded over ``ep_axis``: the dense tp census
    PLUS exactly 2 all_to_alls per MoE layer — dispatch and combine
    (nn/moe.py) — and nothing else. ``ep_axis=None`` (ep = 1 or no
    mesh) is the dense-replicated program: ZERO ep collectives."""
    c = expected_serve_prefill(n_layers, tp_axis=tp_axis,
                               vocab_parallel=vocab_parallel)
    if ep_axis is not None:
        c = dict(c)
        c[ep_axis] = dict(c.get(ep_axis, {}))
        c[ep_axis]["all_to_all"] = (
            c[ep_axis].get("all_to_all", 0) + 2 * n_layers)
    return c


def expected_serve_sp_prefill(n_layers: int, sp: int, *,
                              sp_axis: str = "sp") -> CensusDict:
    """One sequence-parallel prefill call (serve/longctx.py +
    nn/attention.ring_paged_prefill), per layer: ``sp - 1`` shifts of
    the stacked chunk K/V, and one all_gather (the chunk's K/V
    reassembled in rank order for the replicated pool write); plus ONE
    call-wide all_reduce: the masked sum that replicates position
    ``t0 - 1``'s hidden row for the logits read.

    The port's shifts differ from JAX's ``2 * sp`` a layer: JAX's ring
    is a scan of ``sp`` steps that rotates the K/V pair and its position
    vector on every step, the last rotation's result discarded; the
    port's loop rotates only between steps (``sp - 1``), and derives a
    chunk's positions from the step (the chunk a rank holds at step j
    came from rank ``i - j``), so they never go on the wire."""
    return {sp_axis: {"ppermute": (sp - 1) * n_layers,
                      "all_gather": n_layers,
                      "all_reduce": 1}}


def prefill_buckets(prefill_len: int, *, floor: int = 16) -> Tuple[int, ...]:
    """The padded-length ladder for bucketed prefill: powers of two from
    ``floor`` up to (and capped at) ``prefill_len``. A prompt tail of
    length t runs in the smallest bucket >= t."""
    if prefill_len < 1:
        raise ValueError(f"prefill_len must be >= 1; got {prefill_len}")
    out = []
    b = floor
    while b < prefill_len:
        out.append(b)
        b *= 2
    out.append(prefill_len)
    return tuple(out)


def verify_buckets(max_draft: int, *, floor: int = 2) -> Tuple[int, ...]:
    """The draft-length ladder of the speculative verify step
    (``serve/spec.py``): powers of two from ``floor`` up to (and capped
    at) ``max_draft``; ``max_draft=8`` gives ``(2, 4, 8)``. A step whose
    longest draft is k runs at the smallest bucket >= k, its width the
    bucket + 1 tokens a row (the slot's last token rides in front)."""
    if max_draft < 1:
        raise ValueError(f"max_draft must be >= 1; got {max_draft}")
    out = []
    b = floor
    while b < max_draft:
        out.append(b)
        b *= 2
    out.append(max_draft)
    return tuple(out)


def kv_layout_policies() -> Tuple[str, ...]:
    """The KV-pool layout-policy ladder (``serve/kv_quant.py``):
    ``f32``/``bf16`` passthrough, ``int8`` with per-block-per-head
    absmax scales, ``fp8`` unscaled float8_e4m3fn passthrough, and the
    ``fake_quant`` identity-scale proof policy."""
    return ("f32", "bf16", "int8", "fp8", "fake_quant")


def weight_layout_policies() -> Tuple[str, ...]:
    """The weight layout-policy ladder (``serve/weight_quant.py``):
    ``f32`` identity, ``bf16`` passthrough narrowing, ``int8``/``fp8``
    with per-output-channel absmax scales, and the ``fake_quant``
    identity-scale proof policy (bit-identical to f32)."""
    return ("f32", "bf16", "int8", "fp8", "fake_quant")


def attn_kernels() -> Tuple[str, ...]:
    """The serving attention-backend ladder: ``xla`` is the
    gathered-view reference, ``pallas`` the block-table-walking kernel
    (in the port: the plain PyTorch path and K4, chosen by the device).
    The backend must not change any census: the kernel sits strictly
    inside the per-layer attention. What differs is audited by
    ``step_audit.gathered_view_gathers``: > 0 on the plain path, 0 on
    K4's."""
    return ("xla", "pallas")


def lora_rank_buckets(max_rank: int, *, floor: int = 4) -> Tuple[int, ...]:
    """The adapter-rank ladder of multi-tenant LoRA serving
    (``serve/adapters.py``): powers of two from ``floor`` up to, and
    capped at, ``max_rank``. A decode step runs at the smallest bucket
    covering the largest bound adapter's rank; prefill and verify run at
    the top bucket."""
    if max_rank < 1:
        raise ValueError(f"max_rank must be >= 1; got {max_rank}")
    out = []
    b = floor
    while b < max_rank:
        out.append(b)
        b *= 2
    out.append(max_rank)
    return tuple(out)


# ---------------------------------------------------------------------------
# thread-spawn census (quintnet_tpu_torch/analysis/threads.py, rule QT203)

# The expected-spawn spec for the fleet/serve/obs/ops tree — the
# concurrency mirror of the collective censuses above. Every
# ``threading.Thread``/``Timer`` construction site in the audited tree
# must appear here, keyed (module, spawning symbol, target), with its
# shutdown story: ``daemon`` (does process exit reap it) and ``joined``
# (does some code path wait for it). qtcheck-threads fails BOTH
# directions — a spawn the spec lacks (new thread landed without a
# shutdown story) and a spec entry the tree lacks (thread removed,
# spec stale) — so the fleet's thread population changes only with a
# named diff here, never silently.
#
# MUST stay a pure literal: the qtcheck CLI reads it with
# ``ast.literal_eval`` (threads.load_thread_specs), with the standard
# library alone. ops/ spawns no thread.
THREAD_SPAWN_SPECS = {
    "quintnet_tpu_torch/fleet/fleet.py": [
        # in-process fleet dispatcher; close() joins it.
        {"symbol": "ServeFleet.__init__", "target": "self._dispatch_loop",
         "daemon": True, "joined": True},
    ],
    "quintnet_tpu_torch/fleet/frontdoor.py": [
        # asyncio event-loop carrier thread; stop() joins it.
        {"symbol": "FrontDoor.start", "target": "run",
         "daemon": True, "joined": True},
        # per-stream disconnect watcher; self-terminates with the
        # stream (bounded by the request), daemon as backstop.
        {"symbol": "FrontDoor._generate_stream", "target": "watch",
         "daemon": True, "joined": False},
    ],
    "quintnet_tpu_torch/fleet/proc.py": [
        # child-side stdin reader + heartbeat: live for the worker
        # process's lifetime, reaped by process exit.
        {"symbol": "replica_main", "target": "reader",
         "daemon": True, "joined": False},
        {"symbol": "replica_main", "target": "heartbeat",
         "daemon": True, "joined": False},
        # parent-side per-replica socket reader; exits on EOF when the
        # child dies or close() shuts the socket.
        {"symbol": "ProcReplica.attach", "target": "self._read_loop",
         "daemon": True, "joined": False},
        # fleet accept + dispatch loops; close() joins both.
        {"symbol": "ProcessFleet.__init__", "target": "self._accept_loop",
         "daemon": True, "joined": True},
        {"symbol": "ProcessFleet.__init__", "target": "self._dispatch_loop",
         "daemon": True, "joined": True},
        # async prefix-handoff push; bounded by the RPC
        # timeout, daemon so a hung peer can't block close().
        {"symbol": "ProcessFleet._finish", "target": "self._run_handoff",
         "daemon": True, "joined": False},
        # tiered-KV peer-fetch daemon; same bounded-RPC story.
        {"symbol": "ProcessFleet._dispatch_loop",
         "target": "self._run_peer_fetch",
         "daemon": True, "joined": False},
        # warmup fan-out: non-daemon worker threads joined in-call.
        {"symbol": "ProcessFleet.warmup", "target": "one",
         "daemon": False, "joined": True},
    ],
    "quintnet_tpu_torch/fleet/replica.py": [
        # per-replica worker; stop() joins it.
        {"symbol": "Replica.__init__", "target": "self._worker",
         "daemon": True, "joined": True},
    ],
}
