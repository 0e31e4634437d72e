"""Trainer: a config-driven epoch loop over the train step, on one device or a mesh.

Port of ``quintnet_tpu/train/trainer.py``:
:func:`make_lr_schedule` (the same values as the optax schedules the
JAX package builds), the optimizers of :func:`make_optimizer` as plain
functions over the parameter dict (AdamW is ``scale_by_adam``, then the
decay masked by key name, then the learning rate — the JAX chain, not
``torch.optim.AdamW``, which decays every leaf), :class:`History` and
:class:`Trainer` (``init_state``, ``fit``, ``evaluate`` with the
model's own metrics, checkpoints and step-granular resume).

Resume is step-granular and bit-exact: checkpoints
(``train/checkpoint.py``) carry the parameters, the optimizer state and
the host-side cursor (``ft/cursor.py``: epoch, step, the epoch's loss
sum, ``History``); the dropout generator of a step is seeded from
(config seed, epoch, step) and the map-style data order from (epoch
seed, step), so a run cut at any saved step and resumed equals the
uncut run.

``adam_mu_dtype="bfloat16"`` keeps AdamW's first moment in bf16 (the
second stays f32), in optax's order. Like the JAX Trainer, this one
does not read ``training.dtype``: the bf16 compute it names is the
model's (``gpt2_model_spec(compute_dtype=)``), chosen by the example
(``examples/gpt2_finetune.py``).

On a mesh (every strategy of ``parallel/strategy.py``, over dp, tp, pp,
sp and ep, with ``training.fsdp`` on dp and dp x tp: one process per
rank, ``core/runtime.initialize`` first) every rank builds the same
full parameters from the seed and keeps its shards
(``Strategy.shard_params``), the optimizer state comes from
``Strategy.init_opt_state`` (a flat dp chunk under ZeRO-1/2, sharded
like the blocks under fsdp), each step cuts the global batch to the
rank's rows and, under sp, its slice of the sequence
(``Strategy.shard_batch`` with the model's ``batch_specs``), only rank
0 logs, and validation metrics are averaged over dp (under sp the loss
is already the global one on every sp rank). On pp the step's loss is
summed over the stages, so every rank logs the same value, and
validation runs the forward pipeline (``Strategy.model_fns``).
Checkpoints on a mesh are one logical step written by every rank
(``train/checkpoint.py``): the parameters and moments as the ranks hold
them, the cursor once; resume restores each rank's part, and a damaged
step makes the whole world fall back to the same older one. A decision
that leads to a save (the time cadence, the best epoch) is taken by the
whole world, so no rank saves alone.

Fault tolerance (``fit(ft=FTContext(...))``, ``ft/``): after each step
the loop records the step for goodput, lets the chaos monkey inject its
fault, and polls the preemption flag; a preempted run writes one
synchronous emergency snapshot and raises ``TrainingPreempted``. On a
mesh the flag is a decision of the whole world (an all-reduced OR after
each step, taken only when the context holds a ``PreemptionHandler``),
so a signal that reaches one rank stops every rank at the same global
step with the same emergency step on disk.

Not ported (raises ``NotImplementedError`` naming its ROADMAP.md item):
``remat_policy="dots"``.
The JAX loop's host-side knobs for its asynchronous dispatch
(``sync_every``, ``prefetch``) have no use in the eager port and are
ignored.
"""

from __future__ import annotations

import inspect
import json
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from quintnet_tpu_torch.core import runtime
from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.device import resolve_device
from quintnet_tpu_torch.core.pytree import DECAY_KEYS, tree_leaves, tree_map
from quintnet_tpu_torch.parallel.strategy import (ModelSpec, Strategy,
                                                  get_strategy)


# ---------------------------------------------------------------------
# learning-rate schedules (optax's formulas)
# ---------------------------------------------------------------------

def _linear(init: float, end: float, steps: int):
    """optax.linear_schedule: init -> end over ``steps``, then end; a
    constant ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return lambda count: init

    def f(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule (exponent 1)."""
    def f(count):
        count = min(count, decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init * ((1.0 - alpha) * cos + alpha)
    return f


def _join(first, second, boundary: int):
    """optax.join_schedules with one boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def make_lr_schedule(cfg: Config):
    """The learning rate from ``cfg.training``: ``lr_schedule``
    constant | cosine | linear; ``warmup_steps`` prepends a linear
    0 -> peak ramp; cosine and linear decay to ``learning_rate *
    min_lr_ratio`` at step ``decay_steps`` (warmup included). Returns a
    float for the plain constant case, else ``count -> lr`` where
    ``count`` is the number of updates already applied."""
    t = cfg.training
    lr, name = t.learning_rate, t.lr_schedule.lower()
    if name == "constant":
        if not t.warmup_steps:
            return lr
        return _join(_linear(0.0, lr, t.warmup_steps), lambda c: lr,
                     t.warmup_steps)
    if t.decay_steps <= t.warmup_steps:
        raise ValueError(
            f"lr_schedule={name!r} needs decay_steps > warmup_steps "
            f"(got decay_steps={t.decay_steps}, warmup={t.warmup_steps})")
    end = lr * t.min_lr_ratio
    if name == "cosine":
        alpha = 0.0 if lr == 0.0 else end / lr
        return _join(_linear(0.0 if t.warmup_steps else lr, lr,
                             t.warmup_steps),
                     _cosine(lr, t.decay_steps - t.warmup_steps, alpha),
                     t.warmup_steps)
    if name == "linear":
        return _join(_linear(0.0 if t.warmup_steps else lr, lr,
                             max(t.warmup_steps, 1)),
                     _linear(lr, end, t.decay_steps - t.warmup_steps),
                     t.warmup_steps)
    raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")


# ---------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------

@dataclass
class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params)``,
    which changes ``params`` and ``state`` in place (the JAX package's
    optax chains return new trees). The state is ``{"count": int}`` plus,
    for adam and adamw, the moments ``"mu"`` and ``"nu"`` (trees like
    ``params``): every entry is saved with a checkpoint.

    ``kind``: ``"adam"`` (``scale_by_adam`` with bias correction and
    ``eps`` outside the square root, then ``-lr``), ``"adamw"`` (the
    same, plus the masked decay ``weight_decay * p`` before ``-lr``) or
    ``"sgd"`` (``-lr * g``). ``lr``: a float or ``count -> lr``, read on
    the host, so an update never syncs with the device. ``mu_dtype``:
    the first moment's storage dtype (None: the parameter's; optax's
    ``mu_dtype``), see :func:`first_moment`."""

    kind: str
    lr: object
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params) -> Dict:
        state = {"count": 0}
        if self.kind in ("adam", "adamw"):
            state["mu"] = tree_map(
                lambda p: torch.zeros_like(p, dtype=self.mu_dtype), params)
            state["nu"] = tree_map(torch.zeros_like, params)
        return state

    @torch.no_grad()
    def update(self, grads: Dict, state: Dict, params, *,
               decay_mask: Optional[Dict] = None) -> None:
        """``grads``: ``{path: gradient}`` for every leaf of ``params``.
        ``decay_mask`` (``{path: 0/1 tensor shaped like the leaf}``): the
        decay's elementwise mask, for a flat ZeRO chunk whose elements
        have no key of their own (``parallel/zero.py``; the JAX
        ``masked_decay``'s extra argument); None masks by leaf key."""
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        state["count"] += 1
        t = state["count"]
        if self.kind == "sgd":
            for path, p in tree_leaves(params):
                p.add_(grads[path], alpha=-lr)
            return
        # optax's bias corrections: 1 - decay**count in f32 (at count 1,
        # 1 - f32(0.999) is 1.3e-5 from 0.001)
        bc1, bc2 = (float(1 - np.float32(b) ** np.float32(t))
                    for b in (self.b1, self.b2))
        mu, nu = dict(tree_leaves(state["mu"])), dict(tree_leaves(state["nu"]))
        for path, p in tree_leaves(params):
            g = grads[path]
            m = mu[path]
            if m.dtype == g.dtype:
                m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            else:
                # this step's update reads the unrounded moment; only the
                # stored copy is rounded to its dtype
                m = first_moment(m, g, self.b1)
                mu[path].copy_(m)
            nu[path].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1) / ((nu[path] / bc2).sqrt() + self.eps)
            # masked decay: weight matrices and embedding tables only,
            # by the leaf's own key (``core.pytree.decay_mask``) or the
            # elementwise mask
            if self.kind == "adamw" and self.weight_decay:
                if decay_mask is not None:
                    u.add_(p * decay_mask[path], alpha=self.weight_decay)
                elif path[-1] in DECAY_KEYS:
                    u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)


def first_moment(mu, g, b1: float):
    """Adam's first moment ``(1 - b1) g + b1 mu`` in f32 from ``mu``
    stored in a narrower dtype, as the jitted JAX step computes optax's
    ``scale_by_adam(mu_dtype=bfloat16)``: the python ``b1`` meets the
    bf16 moment as a weakly typed scalar and is rounded to bf16 (0.9 ->
    0.8984375), ``b1 mu`` stays in f32 (XLA's excess precision), and
    ``(1 - b1) g`` is fused into the sum as one FMA. Both products are
    exact in f64, so the sum taken there and rounded to f32 is that FMA
    (up to a double-rounding tie)."""
    b1_narrow = float(torch.tensor(b1, dtype=mu.dtype))
    c = float(np.float32(1.0 - b1))
    return (g.double() * c + mu.double() * b1_narrow).float()


def make_optimizer(cfg: Config) -> Optimizer:
    """The optimizer ``cfg.training.optimizer`` names: adam | adamw |
    sgd. A ``zero1_``/``zero2_`` prefix names the same update with its
    state sharded over dp: the strategy reads the prefix from the config
    (``Strategy.zero1_axis``, ``zero_stage``) and the optimizer runs on
    each rank's flat chunk (``parallel/zero.py``).
    AdamW's decay defaults to 0.01. ``adam_mu_dtype="bfloat16"`` stores
    Adam's first moment in bf16 (the JAX ``mu_dtype``; ``nu`` stays
    f32)."""
    t = cfg.training
    name = t.optimizer.lower()
    if name.startswith(("zero1_", "zero2_")):
        name = name[len("zero1_"):]
    lr = make_lr_schedule(cfg)
    mu = torch.bfloat16 if t.adam_mu_dtype == "bfloat16" else None
    if name == "adam":
        return Optimizer("adam", lr, mu_dtype=mu)
    if name == "adamw":
        return Optimizer("adamw", lr, weight_decay=(
            0.01 if t.weight_decay is None else t.weight_decay),
            mu_dtype=mu)
    if name == "sgd":
        return Optimizer("sgd", lr)
    raise ValueError(f"unknown optimizer {t.optimizer!r}")


# ---------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------

@dataclass
class History:
    train_loss: List[float] = field(default_factory=list)
    val_loss: List[float] = field(default_factory=list)
    train_metric: List[float] = field(default_factory=list)
    val_metric: List[float] = field(default_factory=list)
    wall_time_s: float = 0.0
    best_val_loss: float = float("inf")
    best_epoch: int = -1

    def to_jsonl(self, path: str):
        """One JSON line per epoch, then a summary line. After a resume
        the History restored from the cursor holds the whole run, so
        rewriting the file loses no epoch; ``wall_time_s`` adds up over
        restarts."""
        with open(path, "w") as f:
            for i, tl in enumerate(self.train_loss):
                row = {"epoch": i, "train_loss": tl}
                for name, series in (("val_loss", self.val_loss),
                                     ("train_metric", self.train_metric),
                                     ("val_metric", self.val_metric)):
                    if i < len(series):
                        row[name] = series[i]
                f.write(json.dumps(row) + "\n")
            f.write(json.dumps({
                "wall_time_s": round(self.wall_time_s, 2),
                "best_val_loss": self.best_val_loss,
                "best_epoch": self.best_epoch}) + "\n")


def _call_batches_fn(fn, epoch: int, skip: int):
    """Call a batches factory, handing it the mid-epoch resume offset if
    it declares a parameter literally named ``start`` or ``start_batch``
    (second positional, or keyword-only): it then skips by itself (the
    map-style iterators of ``data/datasets.py`` slice their shuffled
    index). Returns ``(iterable, skip_consumed)``; other factories are
    skipped generically by ``fit``. Matching by name, not arity, keeps a
    factory's unrelated second parameter safe."""
    names = ("start", "start_batch")
    try:
        ps = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):   # builtins without a signature
        ps = None
    if ps is not None:
        if (len(ps) >= 2
                and ps[1].kind in (ps[1].POSITIONAL_ONLY,
                                   ps[1].POSITIONAL_OR_KEYWORD)
                and ps[1].name in names):
            return fn(epoch, skip), True
        kw = next((p.name for p in ps
                   if p.kind == p.KEYWORD_ONLY and p.name in names), None)
        if kw is not None:
            return fn(epoch, **{kw: skip}), True
    return fn(epoch), False


def _as_params(tree):
    """Restored tensors -> trainable leaves."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


class Trainer:
    """``fit()`` over ``(x, y)`` numpy batches on one device or on this
    rank of a mesh.

    ``task_type``: ``"classification"`` (the model's ``eval_metrics_fn``
    gives accuracy) or ``"clm"`` (adds perplexity to the epoch log and to
    :meth:`evaluate`). ``checkpoint_dir``: where :meth:`fit` saves (at
    each epoch end and at the ``training.save_every_steps`` /
    ``save_every_seconds`` cadence) and resumes from; the best epoch by
    val loss goes to the sibling ``<checkpoint_dir>-best``. ``device``:
    where parameters and batches live (the card unless the caller asks
    for the CPU)."""

    def __init__(self, config: Config, model: ModelSpec,
                 *, strategy: Optional[Strategy] = None,
                 optimizer: Optional[Optimizer] = None,
                 task_type: str = "classification",
                 checkpoint_dir: Optional[str] = None,
                 log_fn: Callable[[str], None] = print,
                 device="cuda"):
        self.config = config
        self.model = model
        self.device = resolve_device(device)
        self.strategy = strategy or get_strategy(config.strategy_name, config)
        self.optimizer = optimizer or make_optimizer(config)
        self.task_type = task_type
        self.checkpoint_dir = checkpoint_dir
        self.log = log_fn
        if not runtime.is_main_process():
            self.log = lambda msg: None     # one log per job: rank 0
        self.step_fn = self.strategy.make_train_step(model, self.optimizer)
        self._loss_fn, self._eval_fn = self.strategy.model_fns(model)
        self._mgrs: Dict[str, object] = {}
        self._last_ckpt_step = None     # newest step written or restored
        # steps the restore fallback proved unreadable: replay re-reaches
        # them and must rewrite them (force), or the bad step would shadow
        # every later save at that step
        self._bad_ckpt_steps: set = set()
        # whether the newest checkpoint carries a mid-epoch cursor: the
        # epoch-end save then rewrites a cadence save that landed on the
        # epoch's last batch with the boundary cursor
        self._last_ckpt_midepoch = False

    # -- state ---------------------------------------------------------
    def init_state(self, seed: Optional[int] = None):
        """Fresh parameters from ``model.init`` with a generator on the
        trainer's device seeded from ``training.seed`` (or ``seed``), and
        a fresh optimizer state. On a mesh every rank draws the same full
        parameters and keeps its shards."""
        seed = self.config.training.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = _as_params(self.strategy.shard_params(
            self.model, self.model.init(gen)))
        return params, self.strategy.init_opt_state(self.model,
                                                    self.optimizer, params)

    def resume_or_init(self, seed: Optional[int] = None):
        """``(params, opt_state, start_epoch)`` from the newest checkpoint
        at an epoch boundary, else a fresh state at epoch 0. A mid-epoch
        checkpoint (a cadence save) is no epoch boundary, and handing it
        back as one would re-apply the epoch's first steps, so it raises:
        resume through :meth:`fit` or :meth:`resume_state` instead."""
        params, opt_state, cursor = self.resume_state(seed)
        if cursor is not None and cursor.step_in_epoch:
            raise RuntimeError(
                f"latest checkpoint is mid-epoch (epoch {cursor.epoch} "
                f"step {cursor.step_in_epoch}, global step "
                f"{cursor.global_step}); resume_or_init only hands back "
                "epoch boundaries — resume via Trainer.fit() "
                "(step-granular), or resume_state() and pass its cursor "
                "to fit(params=..., opt_state=..., cursor=...)")
        return params, opt_state, (cursor.epoch if cursor is not None else 0)

    def resume_state(self, seed: Optional[int] = None, *, goodput=None,
                     chaos=None):
        """Restore the newest checkpoint that loads (a damaged step falls
        back to the previous good one, ``ft/restore.py``), else a fresh
        state. Returns ``(params, opt_state, cursor)``; ``cursor`` (a
        ``TrainCursor``) points at the next (epoch, step), None on a
        fresh state. The state comes back on the trainer's device.
        ``goodput`` (a ``GoodputMeter``) is told the restored step, the
        restore's seconds and the steps skipped; ``chaos`` (a
        ``ChaosMonkey``) may fail restore attempts on purpose."""
        params, opt_state = self.init_state(seed)
        if not self.checkpoint_dir:
            return params, opt_state, None
        mgr = self._manager()
        if mgr.latest_step() is None:
            return params, opt_state, None
        from quintnet_tpu_torch.ft.cursor import TrainCursor
        from quintnet_tpu_torch.ft.restore import restore_with_fallback

        t_restore = time.time()
        state, cursor_dict, step, skipped = restore_with_fallback(
            mgr, {"params": params, "opt": opt_state, "epoch": 0},
            specs=self._state_specs(opt_state), chaos=chaos, log=self.log)
        self._last_ckpt_step = step
        self._bad_ckpt_steps = set(skipped)
        cursor = TrainCursor.from_dict(cursor_dict)
        self._last_ckpt_midepoch = (cursor is not None
                                    and cursor.step_in_epoch != 0)
        if cursor is None:
            # a step saved without a cursor (``save``) is indexed by its
            # epoch: resume at the next epoch's start
            cursor = TrainCursor(epoch=int(state["epoch"]) + 1,
                                 global_step=step)
        if goodput is not None:
            goodput.on_resume(cursor.global_step, time.time() - t_restore,
                              len(skipped))
        self.log(f"resumed from checkpoint step {step}: continuing at "
                 f"epoch {cursor.epoch} step {cursor.step_in_epoch} "
                 f"(global step {cursor.global_step})")
        return _as_params(state["params"]), state["opt"], cursor

    def _manager(self, *, best: bool = False):
        """One CheckpointManager per directory, reused across saves (on a
        mesh, every rank's manager over the strategy's mesh)."""
        from quintnet_tpu_torch.train.checkpoint import CheckpointManager

        key = "best" if best else "main"
        if key not in self._mgrs:
            mesh = self.strategy.mesh
            self._mgrs[key] = (
                CheckpointManager(self.checkpoint_dir.rstrip("/") + "-best",
                                  max_to_keep=1, mesh=mesh) if best
                else CheckpointManager(self.checkpoint_dir, mesh=mesh))
        return self._mgrs[key]

    def _state_specs(self, opt_state):
        """The spec tree of a saved train state on the strategy's mesh
        (None on one device): the parameters' specs, the moments sharded
        like them or, under ZeRO-1/2, per-rank chunks."""
        from quintnet_tpu_torch.train.checkpoint import CHUNK

        if self.strategy.mesh.size == 1:
            return None
        ps = self.strategy.param_specs(self.model)
        opt = {k: (CHUNK if torch.is_tensor(v) else ps)
               if k in ("mu", "nu") else () for k, v in opt_state.items()}
        return {"params": ps, "opt": opt}

    def _save_meta(self):
        s = self.strategy
        return {"strategy": s.name,
                "zero_stage": 0 if s.zero1_axis is None else s.zero_stage,
                "fsdp": s.fsdp_axis is not None}

    def _agree(self, flag: bool) -> bool:
        """``flag`` as a decision of the whole world (true when any rank's
        is): a save that one rank decides alone would leave the others
        out of its collectives."""
        return runtime.any_rank(flag) if self.strategy.mesh.size > 1 \
            else flag

    def save(self, epoch: int, params, opt_state):
        """Epoch-indexed save without a cursor, for callers that drive
        their own loop (``fit`` saves through :meth:`save_state`)."""
        if not self.checkpoint_dir:
            return
        self._manager().save(
            epoch, {"params": params, "opt": opt_state, "epoch": epoch},
            specs=self._state_specs(opt_state), meta=self._save_meta())

    def save_state(self, params, opt_state, cursor, *,
                   boundary: bool = False) -> float:
        """Checkpoint the state and the cursor at step
        ``cursor.global_step``; returns the seconds it took (goodput's
        checkpoint overhead: saves are synchronous, so all of it). A step
        already written or restored is skipped (a resumed run revisits the
        step it restored from, and the state is the same by
        construction), except a step the restore fallback proved
        unreadable (rewritten) and an epoch-end save (``boundary``) at the
        step of a just-written mid-epoch cadence save (rewritten with the
        boundary cursor, so :meth:`resume_or_init` sees the boundary)."""
        if not self.checkpoint_dir:
            return 0.0
        step = cursor.global_step
        force = step in self._bad_ckpt_steps
        if self._last_ckpt_step is not None and step <= self._last_ckpt_step:
            if not (boundary and step == self._last_ckpt_step
                    and self._last_ckpt_midepoch):
                return 0.0
            force = True
        t = time.time()
        # the epoch the arrays were produced in (an end-of-epoch cursor
        # already points at the next one): what tools/verify_vit reports
        epoch = (cursor.epoch - 1 if cursor.step_in_epoch == 0
                 else cursor.epoch)
        self._manager().save(
            step, {"params": params, "opt": opt_state, "epoch": epoch},
            cursor=cursor.to_dict(), force=force,
            specs=self._state_specs(opt_state), meta=self._save_meta())
        self._last_ckpt_step = step
        self._last_ckpt_midepoch = cursor.step_in_epoch != 0
        self._bad_ckpt_steps.discard(step)
        return time.time() - t

    def save_best(self, epoch: int, params, opt_state, val_loss: float):
        """The best epoch by val loss, kept alone in the sibling
        directory ``<checkpoint_dir>-best`` (a sibling, so the main
        directory lists only step numbers)."""
        if not self.checkpoint_dir:
            return
        self._manager(best=True).save(
            epoch, {"params": params, "opt": opt_state, "epoch": epoch,
                    "val_loss": val_loss},
            specs=self._state_specs(opt_state), meta=self._save_meta())

    def wait_for_saves(self):
        """Barrier on in-flight checkpoint writes."""
        for mgr in self._mgrs.values():
            mgr.wait_until_finished()

    def device_batch(self, xb, yb):
        """A host ``(x, y)`` global batch -> this rank's block (its rows,
        and under sp its slice of the sequence: ``Strategy.shard_batch``
        with the model's ``batch_specs``; all of it on one device) as tensors
        on the trainer's device: floating arrays (images) as f32, integer
        ones (token ids, labels) as int64."""
        def put(a):
            t = torch.as_tensor(np.asarray(a))
            dtype = torch.float32 if t.is_floating_point() else torch.int64
            return t.to(self.device, dtype=dtype, non_blocking=True)

        xb, yb = self.strategy.shard_batch((xb, yb), self.model)
        return put(xb), put(yb)

    def step_generator(self, epoch: int, step: int):
        """The dropout generator of one step, seeded from (config seed,
        epoch, step) as the JAX trainer seeds its step, with this rank's
        dp coordinate folded in on a mesh
        (``Strategy.dropout_generator``); None when the model has no
        dropout."""
        if not self.model.needs_rng:
            return None
        seed = (self.config.training.seed * 2_000_003 + epoch * 1_000_003
                + step) & 0x7FFFFFFF
        return self.strategy.dropout_generator(seed, self.device)

    # -- evaluation ----------------------------------------------------
    def evaluate(self, params, batches: Iterable) -> Dict[str, float]:
        """The mean over ``batches`` of each metric (no dropout, no
        gradients): the model's ``eval_metrics_fn`` where it has one
        (ViT: loss and accuracy), else its loss; on pp the forward
        pipeline's (its micro-batches are ``gradient_accumulation_steps``
        slices of each rank's rows); clm adds perplexity. On a mesh each
        batch's metrics are averaged over the dp ranks' rows first."""
        fn = self._eval_fn
        acc: Dict[str, list] = {}
        with torch.no_grad():
            for xb, yb in batches:
                batch = self.device_batch(xb, yb)
                mets = (fn(params, batch) if fn is not None
                        else {"loss": self._loss_fn(params, batch)})
                for k, v in mets.items():
                    acc.setdefault(k, []).append(
                        self.strategy.mean_over_batch(v))
        # one device->host read per metric, then the mean of the batch
        # values in f64, as the JAX trainer takes it
        out = {k: float(np.mean(torch.stack(vs).tolist()))
               for k, vs in acc.items()}
        out.setdefault("loss", float("nan"))
        if self.task_type == "clm":
            out["perplexity"] = float(np.exp(min(out["loss"], 20.0)))
        return out

    # -- training ------------------------------------------------------
    def fit(self, train_batches_fn: Callable[..., Iterable],
            *, epochs: Optional[int] = None,
            val_batches_fn: Optional[Callable[[int], Iterable]] = None,
            params=None, opt_state=None, cursor=None, ft=None) -> History:
        """``train_batches_fn(epoch) -> iterable of (x, y)`` host batches
        (the global batch; the step cuts micro-batches). A factory whose
        second parameter is named ``start`` or ``start_batch`` receives
        the mid-epoch resume offset; others are skipped generically.

        Without ``params`` the state is the newest checkpoint's (with
        ``checkpoint_dir``) or fresh. With ``params``/``opt_state``, pass
        the ``cursor`` of :meth:`resume_state` to continue that state's
        run mid-stream; without one the state starts a fresh run at
        epoch 0. Losses stay on the device during an epoch and are read
        back at checkpoints and at the epoch's end.

        ``ft``: an optional :class:`~quintnet_tpu_torch.ft.FTContext`
        with preemption handling, fault injection and goodput accounting
        (module docstring). Cadence saves come from
        ``training.save_every_steps`` / ``save_every_seconds``, with or
        without it."""
        from quintnet_tpu_torch.data.datasets import skip_batches
        from quintnet_tpu_torch.ft.cursor import TrainCursor
        from quintnet_tpu_torch.ft.preempt import (CadenceController,
                                                   TrainingPreempted)

        epochs = epochs or self.config.training.epochs
        if ft is not None and ft.preemption is not None \
                and not self.checkpoint_dir:
            # the preemption contract is "emergency snapshot saved, exit
            # 75, relaunch me": with nowhere to write the snapshot every
            # relaunch would silently restart from epoch 0
            raise ValueError(
                "FTContext.preemption requires a checkpoint_dir: a "
                "preemption snapshot with nowhere to write would make "
                "the exit-75 relaunch contract silently discard the run "
                "— pass checkpoint_dir= to Trainer, or drop the "
                "PreemptionHandler from the context")
        goodput = ft.goodput if ft is not None else None

        def preempted() -> bool:
            # polled only with a handler; on a mesh every rank polls and
            # the flag of any rank stops them all
            if ft is None or ft.preemption is None:
                return False
            return self._agree(ft.preemption_requested)

        if params is None:
            params, opt_state, cursor = self.resume_state(
                goodput=goodput, chaos=ft.chaos if ft is not None else None)
        elif cursor is None:
            # an explicit fresh state owes nothing to a checkpoint this
            # trainer touched earlier
            self._last_ckpt_step = None
        if cursor is None:
            cursor = TrainCursor(seed=self.config.training.seed)
        if (cursor.seed is not None
                and cursor.seed != self.config.training.seed):
            raise RuntimeError(
                f"checkpoint was written with training.seed={cursor.seed} "
                f"but the config now says {self.config.training.seed}; "
                "dropout seeds and data order derive from the seed, so "
                "resuming would silently diverge from the original run")
        hist = cursor.history
        prior_wall = hist.wall_time_s   # adds up over restarts
        global_step = cursor.global_step
        start_epoch, resume_step = cursor.epoch, cursor.step_in_epoch
        t0 = time.time()
        log_every = self.config.training.log_every
        cadence = CadenceController(self.config.training.save_every_steps,
                                    self.config.training.save_every_seconds)
        cadence.saved(global_step)
        for epoch in range(start_epoch, epochs):
            losses = []
            skip = resume_step if epoch == start_epoch else 0
            # the epoch's loss record: a sequential f64 sum of the f32
            # step losses, the same computation whether the epoch ran in
            # one process or resumed from a checkpointed sum
            loss_sum = cursor.loss_sum if skip else 0.0
            loss_count = cursor.loss_count if skip else 0
            n_flushed = 0

            def flush():
                # one device->host read for the steps since the last one
                nonlocal n_flushed, loss_sum, loss_count
                if len(losses) > n_flushed:
                    for v in torch.stack(losses[n_flushed:]).tolist():
                        loss_sum += v
                        loss_count += 1
                n_flushed = len(losses)

            def cursor_at(next_epoch, next_step):
                hist.wall_time_s = prior_wall + (time.time() - t0)
                at_boundary = next_step == 0
                return TrainCursor(
                    epoch=next_epoch, step_in_epoch=next_step,
                    global_step=global_step,
                    loss_sum=0.0 if at_boundary else loss_sum,
                    loss_count=0 if at_boundary else loss_count,
                    history=hist, seed=self.config.training.seed)

            t_win = time.time()
            batches, skip_consumed = _call_batches_fn(train_batches_fn,
                                                      epoch, skip)
            if skip and not skip_consumed:
                batches = skip_batches(batches, skip)
            for i, (xb, yb) in enumerate(batches, start=skip):
                params, opt_state, loss = self.step_fn(
                    params, opt_state, self.device_batch(xb, yb),
                    self.step_generator(epoch, i))
                losses.append(loss)
                global_step += 1
                if log_every and (i + 1) % log_every == 0:
                    window = float(torch.stack(losses[-log_every:]).mean())
                    dt = time.time() - t_win
                    sps = log_every * len(xb) / max(dt, 1e-9)
                    msg = (f"epoch {epoch} step {i + 1}: loss {window:.4f} "
                           f"| {sps:.1f} samples/s")
                    if self.task_type == "clm":
                        msg += f" ({sps * xb.shape[1] / 1e3:.1f}k tok/s)"
                    self.log(msg)
                    t_win = time.time()
                # -- the fault-tolerance boundary (the step has landed) --
                if goodput is not None:
                    # the loss rides along: the report waits for its
                    # device before it reads the clock
                    goodput.on_step(global_step, loss)
                if ft is not None and ft.chaos is not None:
                    # may exit, SIGTERM this process or raise ChaosKilled
                    ft.chaos.on_step_end(global_step)
                if preempted():
                    # finish the step, then one synchronous emergency
                    # snapshot
                    flush()
                    blocked = self.save_state(params, opt_state,
                                              cursor_at(epoch, i + 1))
                    if goodput is not None:
                        goodput.on_save(blocked)
                    self.log(f"preempted: emergency snapshot at epoch "
                             f"{epoch} step {i + 1} (global step "
                             f"{global_step})")
                    raise TrainingPreempted(epoch, i + 1, global_step)
                save_now = cadence.should_save(global_step)
                if cadence.every_seconds:      # each rank's own clock
                    save_now = self._agree(save_now)
                if save_now:
                    flush()
                    blocked = self.save_state(params, opt_state,
                                              cursor_at(epoch, i + 1))
                    if goodput is not None:
                        goodput.on_save(blocked)
                    cadence.saved(global_step)
            flush()
            train_loss = (loss_sum / loss_count if loss_count
                          else float("nan"))
            hist.train_loss.append(train_loss)
            msg = f"epoch {epoch}: train_loss {train_loss:.4f}"
            if self.task_type == "clm":
                ppl = float(np.exp(min(train_loss, 20.0)))
                hist.train_metric.append(ppl)
                msg += f" ppl {ppl:.2f}"
            if val_batches_fn is not None:
                ev = self.evaluate(params, val_batches_fn(epoch))
                hist.val_loss.append(ev["loss"])
                msg += f" | val_loss {ev['loss']:.4f}"
                for k in ("perplexity", "accuracy"):
                    if k in ev:
                        hist.val_metric.append(ev[k])
                        msg += f" val_{k} {ev[k]:.4f}"
                if self._agree(ev["loss"] < hist.best_val_loss):
                    hist.best_val_loss = ev["loss"]
                    hist.best_epoch = epoch
                    self.save_best(epoch, params, opt_state, ev["loss"])
                    msg += " (best)"
            self.log(msg)
            blocked = self.save_state(params, opt_state,
                                      cursor_at(epoch + 1, 0), boundary=True)
            if goodput is not None:
                goodput.on_save(blocked)
            cadence.saved(global_step)
            if preempted():
                # the signal came during evaluation or the epoch's end
                # (the per-step poll sees it only after a step): this
                # boundary is written above; make it durable and stop
                # before an epoch that would not finish
                t_b = time.time()
                self.wait_for_saves()
                if goodput is not None:
                    goodput.on_save(time.time() - t_b)
                self.log(f"preempted: epoch {epoch} checkpoint durable "
                         f"(global step {global_step})")
                raise TrainingPreempted(epoch + 1, 0, global_step)
        t_barrier = time.time()
        self.wait_for_saves()
        if goodput is not None:
            goodput.on_save(time.time() - t_barrier)
        hist.wall_time_s = prior_wall + (time.time() - t0)
        self._final_state = (params, opt_state)
        return hist

    @property
    def final_state(self):
        """(params, opt_state) after the last fit() epoch."""
        return getattr(self, "_final_state", None)
