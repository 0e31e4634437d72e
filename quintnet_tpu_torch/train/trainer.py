"""Trainer: a config-driven epoch loop over the single-device step.

Port of ``quintnet_tpu/train/trainer.py`` for one device:
:func:`make_lr_schedule` (the same values as the optax schedules the
JAX package builds), the optimizers of :func:`make_optimizer` as plain
functions over the parameter dict (AdamW is ``scale_by_adam``, then the
decay masked by key name, then the learning rate — the JAX chain, not
``torch.optim.AdamW``, which decays every leaf), :class:`History` and
:class:`Trainer` (``init_state``, ``fit``, ``evaluate``).

Not ported (each raises ``NotImplementedError`` naming its ROADMAP.md
item): checkpoints and resume (``checkpoint_dir``, ``cursor``, ``ft``:
``train/checkpoint.py``, ``ft/*``), every strategy but ``single``,
``remat_policy="dots"``, ``adam_mu_dtype="bfloat16"`` and bf16 compute
(``training.dtype``). The JAX loop's host-side knobs for its
asynchronous dispatch (``sync_every``, ``prefetch``) have no use in the
eager port and are ignored.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.device import resolve_device
from quintnet_tpu_torch.core.pytree import decay_mask, tree_leaves, tree_map
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

def masked_decay(weight_decay: float, params):
    """Per-leaf decoupled weight decay factors: ``weight_decay`` on the
    leaves whose key is in ``core.pytree.DECAY_KEYS`` (weight matrices,
    embedding tables), 0 on biases and norm parameters."""
    return tree_map(lambda m: weight_decay if m else 0.0, decay_mask(params))


@dataclass
class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params)``,
    which changes ``params`` and ``state`` in place (the JAX package's
    optax chains return new trees).

    ``kind``: ``"adam"`` (``scale_by_adam`` with bias correction and
    ``eps`` outside the square root, then ``-lr``), ``"adamw"`` (the
    same, plus the masked decay ``weight_decay * p`` before ``-lr``) or
    ``"sgd"`` (``-lr * g``). ``lr``: a float or ``count -> lr``, read on
    the host, so an update never syncs with the device."""

    kind: str
    lr: object
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> Dict:
        state = {"count": 0}
        if self.kind in ("adam", "adamw"):
            state["mu"] = tree_map(torch.zeros_like, params)
            state["nu"] = tree_map(torch.zeros_like, params)
        if self.kind == "adamw":
            state["decay"] = dict(tree_leaves(masked_decay(
                self.weight_decay, params)))
        return state

    @torch.no_grad()
    def update(self, grads: Dict, state: Dict, params) -> None:
        """``grads``: ``{path: gradient}`` for every leaf of ``params``."""
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        state["count"] += 1
        t = state["count"]
        if self.kind == "sgd":
            for path, p in tree_leaves(params):
                p.add_(grads[path], alpha=-lr)
            return
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        mu, nu = dict(tree_leaves(state["mu"])), dict(tree_leaves(state["nu"]))
        for path, p in tree_leaves(params):
            g = grads[path]
            mu[path].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu[path].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu[path] / bc1) / ((nu[path] / bc2).sqrt() + self.eps)
            wd = state["decay"][path] if self.kind == "adamw" else 0.0
            if wd:
                u.add_(p, alpha=wd)
            p.add_(u, alpha=-lr)


def make_optimizer(cfg: Config) -> Optimizer:
    """The optimizer ``cfg.training.optimizer`` names: adam | adamw |
    sgd (a ``zero1_``/``zero2_`` prefix shards the state over dp in the
    JAX package and means nothing on one device, so it is dropped).
    AdamW's decay defaults to 0.01."""
    t = cfg.training
    name = t.optimizer.lower()
    if name.startswith(("zero1_", "zero2_")):
        name = name[len("zero1_"):]
    if t.adam_mu_dtype == "bfloat16":
        raise NotImplementedError(
            "adam_mu_dtype='bfloat16' is not ported: the port keeps both "
            "Adam moments in f32 (ROADMAP.md §1, slice 2)")
    lr = make_lr_schedule(cfg)
    if name == "adam":
        return Optimizer("adam", lr)
    if name == "adamw":
        return Optimizer("adamw", lr, weight_decay=(
            0.01 if t.weight_decay is None else t.weight_decay))
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
        """One JSON line per epoch, then a summary line."""
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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported: the port has no checkpoint or resume yet "
        f"(train/checkpoint.py, ft/*; ROADMAP.md §1, slice 2)")


class Trainer:
    """``fit()`` over ``(input_ids, labels)`` numpy batches on one device.

    ``task_type``: ``"classification"`` or ``"clm"`` (adds perplexity to
    the epoch log and to :meth:`evaluate`). ``device``: where parameters
    and batches live (the card unless the caller asks for the CPU)."""

    def __init__(self, config: Config, model: ModelSpec,
                 *, strategy: Optional[Strategy] = None,
                 optimizer: Optional[Optimizer] = None,
                 task_type: str = "classification",
                 checkpoint_dir: Optional[str] = None,
                 log_fn: Callable[[str], None] = print,
                 device="cuda"):
        if checkpoint_dir is not None:
            raise _not_ported("checkpoint_dir")
        if config.training.dtype != "float32":
            raise NotImplementedError(
                f"training.dtype={config.training.dtype!r}: bf16 compute is "
                f"not ported; the port trains in f32 (ROADMAP.md §1, "
                f"slice 2)")
        self.config = config
        self.model = model
        self.device = resolve_device(device)
        self.strategy = strategy or get_strategy(config.strategy_name, config)
        self.optimizer = optimizer or make_optimizer(config)
        self.task_type = task_type
        self.log = log_fn
        self.step_fn = self.strategy.make_train_step(model, self.optimizer)

    # -- state ---------------------------------------------------------
    def init_state(self, seed: Optional[int] = None):
        """Fresh parameters from ``model.init`` with a generator on the
        trainer's device seeded from ``training.seed`` (or ``seed``), and
        a fresh optimizer state."""
        seed = self.config.training.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          self.model.init(gen))
        return params, self.optimizer.init(params)

    def device_batch(self, xb, yb):
        """A host ``(input_ids, labels)`` pair -> int64 tensors on the
        trainer's device."""
        return tuple(torch.as_tensor(np.asarray(a)).to(
            self.device, dtype=torch.int64, non_blocking=True)
            for a in (xb, yb))

    def step_generator(self, epoch: int, step: int):
        """The dropout generator of one step, seeded from (config seed,
        epoch, step) as the JAX trainer seeds its step; None when the
        model has no dropout."""
        if not self.model.needs_rng:
            return None
        seed = (self.config.training.seed * 2_000_003 + epoch * 1_000_003
                + step) & 0x7FFFFFFF
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- evaluation ----------------------------------------------------
    def evaluate(self, params, batches: Iterable) -> Dict[str, float]:
        """Mean loss over ``batches`` (no dropout, no gradients); clm adds
        perplexity."""
        with torch.no_grad():
            losses = [self.model.loss_fn(params, self.device_batch(xb, yb))
                      for xb, yb in batches]
        out = {"loss": (float(torch.stack(losses).mean()) if losses
                        else float("nan"))}
        if self.task_type == "clm":
            out["perplexity"] = float(np.exp(min(out["loss"], 20.0)))
        return out

    # -- training ------------------------------------------------------
    def fit(self, train_batches_fn: Callable[[int], Iterable],
            *, epochs: Optional[int] = None,
            val_batches_fn: Optional[Callable[[int], Iterable]] = None,
            params=None, opt_state=None, cursor=None, ft=None) -> History:
        """``train_batches_fn(epoch) -> iterable of (x, y)`` host batches
        (the global batch; the step cuts micro-batches). Losses stay on
        the device during an epoch and are read back once at its end (and
        at each ``log_every`` window). Without ``params`` the state is
        fresh from :meth:`init_state`."""
        if cursor is not None:
            raise _not_ported("resuming from a cursor")
        if ft is not None:
            raise _not_ported("fault tolerance (ft=)")
        epochs = epochs or self.config.training.epochs
        if params is None:
            params, opt_state = self.init_state()
        hist = History()
        t0 = time.time()
        log_every = self.config.training.log_every
        for epoch in range(epochs):
            losses = []
            t_win = time.time()
            for i, (xb, yb) in enumerate(train_batches_fn(epoch)):
                params, opt_state, loss = self.step_fn(
                    params, opt_state, self.device_batch(xb, yb),
                    self.step_generator(epoch, i))
                losses.append(loss)
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
            # one device->host read per epoch; a sequential f64 mean of
            # the f32 step losses, as the JAX trainer takes it
            vals = torch.stack(losses).tolist() if losses else []
            train_loss = sum(vals) / len(vals) if vals else float("nan")
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
                if "perplexity" in ev:
                    hist.val_metric.append(ev["perplexity"])
                    msg += f" val_perplexity {ev['perplexity']:.4f}"
                if ev["loss"] < hist.best_val_loss:
                    hist.best_val_loss = ev["loss"]
                    hist.best_epoch = epoch
                    msg += " (best)"
            self.log(msg)
        hist.wall_time_s = time.time() - t0
        self._final_state = (params, opt_state)
        return hist

    @property
    def final_state(self):
        """(params, opt_state) after the last fit() epoch."""
        return getattr(self, "_final_state", None)
