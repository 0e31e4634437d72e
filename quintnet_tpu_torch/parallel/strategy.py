"""Strategy facade: which mesh axes take which role, and the train step.

Port of ``quintnet_tpu/parallel/strategy.py`` for the strategies
``single``, ``dp``, ``tp`` and ``dp_tp``. A strategy is data: the mesh
(one process per rank, ``core/mesh.py``), the axes the batch is sharded
over (``batch_axes``), the axes the model is sharded over, whose loss is
computed redundantly (``model_axes``), and the pipeline axes
(``partial_axes``). Every other strategy of the JAX package raises
``NotImplementedError`` naming its ROADMAP.md item: pp, 1F1B, ZeRO-1/2
and fsdp (§1, item 3c), ep and MoE (item 4), sp (item 6).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from quintnet_tpu_torch.core.config import Config
from quintnet_tpu_torch.core.mesh import Mesh, MeshAxis, MeshSpec, build_mesh

STRATEGY_AXES = {
    "single": (),
    "dp": ("dp",),
    "tp": ("tp",),
    "pp": ("pp",),
    "sp": ("sp",),
    "ep": ("ep",),
    "dp_tp": ("dp", "tp"),
    "dp_pp": ("dp", "pp"),
    "tp_pp": ("tp", "pp"),
    "dp_sp": ("dp", "sp"),
    "dp_ep": ("dp", "ep"),
    "ep_tp": ("ep", "tp"),
    "ep_pp": ("ep", "pp"),
    "3d": ("dp", "tp", "pp"),
    "3d_ep": ("dp", "tp", "pp", "ep"),
    "4d": ("dp", "tp", "pp", "sp"),
    "5d": ("dp", "tp", "pp", "sp", "ep"),
}
PORTED = ("single", "dp", "tp", "dp_tp")
# the ROADMAP.md item each axis of the strategies still to port waits for
AXIS_ITEMS = {
    "pp": "§1, item 3c (pipeline parallelism)",
    "ep": "§1, item 4 (MoE expert parallelism)",
    "sp": "§1, item 6 (sequence parallelism)",
}


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"{item})")


@dataclass
class ModelSpec:
    """What a model must provide to be trained.

    ``init(generator)`` -> full (host-global) param tree on
    ``generator.device``; ``loss_fn(params, batch, generator=None, *,
    tp_axis=None)`` -> scalar loss on this rank's shards, the generator
    driving training dropout and ``tp_axis`` the tp
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis` (None without tp);
    ``depth`` the layer count; ``needs_rng`` True when the model uses
    dropout; ``eval_metrics_fn(params, batch, *, tp_axis=None) -> {name:
    device scalar}`` (optional: ViT gives loss and accuracy);
    ``partition_specs(tp_axis=None)`` -> the spec tree (axis names;
    ``parallel/tp.py``) and ``to_tp_layout(params, tp)`` -> the params
    in the tp-blocked fused-QKV layout, both needed on a mesh. (The JAX
    spec's pipeline functions wait for ROADMAP.md §1, item 3c.)"""

    init: Callable[[Any], Any]
    loss_fn: Callable
    depth: int
    needs_rng: bool = False
    eval_metrics_fn: Optional[Callable] = None
    partition_specs: Optional[Callable] = None
    to_tp_layout: Optional[Callable] = None


@dataclass
class Strategy:
    """A named strategy over this rank's ``mesh``."""

    name: str
    config: Config
    mesh: Mesh
    batch_axes: Tuple[str, ...] = ()
    model_axes: Tuple[str, ...] = ()
    partial_axes: Tuple[str, ...] = ()

    def axis_or_none(self, axis: str) -> Optional[MeshAxis]:
        """The axis as seen from this rank, or None when the mesh lacks it
        or it has size 1."""
        if self.mesh.shape.get(axis, 1) <= 1:
            return None
        return self.mesh.axis(axis)

    def _axis_name(self, axis: str) -> Optional[str]:
        return axis if self.mesh.shape.get(axis, 1) > 1 else None

    # -- placement -----------------------------------------------------
    def param_specs(self, model: ModelSpec):
        if model.partition_specs is None:
            raise ValueError(f"strategy {self.name!r} needs the model's "
                             f"partition_specs")
        return model.partition_specs(tp_axis=self._axis_name("tp"))

    def shard_params(self, model: ModelSpec, params):
        """Full params (every rank holds the same, from the same seed) ->
        this rank's shards: the tp layout, then each dim that names a
        present axis cut to this rank's chunk."""
        from quintnet_tpu_torch.core.pytree import tree_map
        from quintnet_tpu_torch.parallel.tp import shard_leaf

        if self.name == "single":
            return params
        tp = self.mesh.shape.get("tp", 1)
        if tp > 1:
            params = model.to_tp_layout(params, tp)
        return tree_map(lambda x, s: shard_leaf(x, s, self.mesh), params,
                        self.param_specs(model))

    def shard_batch(self, batch):
        """A host-global batch (a tuple of numpy arrays or tensors, each
        [global_batch, ...]) -> this rank's rows along its coordinate over
        ``batch_axes``; the tp ranks of one dp coordinate take the same
        rows."""
        axes = tuple(a for a in self.batch_axes
                     if self.mesh.shape.get(a, 1) > 1)
        if not axes:
            return batch
        ax = self.mesh.axis(axes)
        out = []
        for x in batch:
            n = x.shape[0]
            if n % ax.size:
                raise ValueError(f"batch of {n} rows does not split over "
                                 f"{ax!r}")
            k = n // ax.size
            out.append(x[ax.index * k:(ax.index + 1) * k])
        return tuple(out)

    def init_opt_state(self, model: ModelSpec, optimizer, params):
        """The optimizer state of this rank's shards (every moment has
        its parameter's shape, so it is sharded like it)."""
        return optimizer.init(params)

    def dropout_generator(self, seed: int, device):
        """This rank's dropout generator for a step seeded ``seed``
        (``train_step.device_dropout_generator``: dp coordinates folded
        in, tp never)."""
        from quintnet_tpu_torch.parallel.train_step import \
            device_dropout_generator

        return device_dropout_generator(seed, self.mesh, device)

    def mean_over_batch(self, value: torch.Tensor) -> torch.Tensor:
        """A per-rank metric averaged over the batch axes (validation)."""
        from quintnet_tpu_torch.core import collectives as cc

        axes = tuple(a for a in self.batch_axes
                     if self.mesh.shape.get(a, 1) > 1)
        if not axes:
            return value
        return cc.all_reduce_(value.detach().clone(), self.mesh.axis(axes),
                              mean=True)

    # -- the step ------------------------------------------------------
    def model_fns(self, model: ModelSpec):
        """``(loss_fn(params, batch, generator=None), eval_fn(params,
        batch) or None)`` with this rank's tp axis bound."""
        tp_axis = self.axis_or_none("tp")
        if tp_axis is None:
            return model.loss_fn, model.eval_metrics_fn

        def loss(params, batch, generator=None):
            return model.loss_fn(params, batch, generator, tp_axis=tp_axis)

        ev = model.eval_metrics_fn
        if ev is not None:
            def ev(params, batch, _fn=model.eval_metrics_fn):
                return _fn(params, batch, tp_axis=tp_axis)
        return loss, ev

    def make_train_step(self, model: ModelSpec, optimizer):
        from quintnet_tpu_torch.parallel.train_step import (
            make_parallel_train_step, make_train_step)

        t = self.config.training
        loss, _ = self.model_fns(model)
        if self.name == "single":
            return make_train_step(
                loss, optimizer,
                grad_accum_steps=t.gradient_accumulation_steps,
                grad_clip_norm=t.grad_clip_norm, needs_rng=model.needs_rng)
        return make_parallel_train_step(
            self.mesh, loss, optimizer, self.param_specs(model),
            batch_axes=self.batch_axes, model_axes=self.model_axes,
            partial_axes=self.partial_axes,
            grad_accum_steps=t.gradient_accumulation_steps,
            grad_clip_norm=t.grad_clip_norm, needs_rng=model.needs_rng)


def get_strategy(name: Optional[str] = None,
                 config: Optional[Config] = None) -> Strategy:
    """Build the strategy ``name`` over ``config.mesh``; ``None`` or
    ``"auto"`` picks it from the axes of size > 1. With more than one
    rank the process group must already be joined
    (``core/runtime.initialize``) with a world of the mesh's size; every
    rank calls this in the same order (it creates the mesh's process
    groups). ``single``, ``dp``, ``tp`` and ``dp_tp`` are ported; other
    strategies raise ``NotImplementedError`` naming their ROADMAP.md
    item, unknown names ``ValueError``."""
    config = config or Config.from_dict({})
    sizes = dict(config.mesh.axis_sizes)
    active = tuple(a for a, s in sizes.items() if s > 1)
    for a in active:
        if a in AXIS_ITEMS:
            raise _not_ported(f"a mesh with {a} = {sizes[a]} (strategy "
                              f"{name or 'auto'!r})", AXIS_ITEMS[a])
    if name in (None, "auto"):
        name = next((k for k, v in STRATEGY_AXES.items()
                     if sorted(v) == sorted(active)), None)
        if name is None:
            raise ValueError(f"no strategy has exactly the axes {active}")
    elif name not in STRATEGY_AXES:
        raise ValueError(f"unknown strategy {name!r}; known: "
                         f"{sorted(STRATEGY_AXES)}")
    if name not in PORTED:
        missing = [a for a in STRATEGY_AXES[name] if a in AXIS_ITEMS]
        raise _not_ported(f"strategy {name!r}", AXIS_ITEMS[missing[0]])
    for a in STRATEGY_AXES[name]:
        if sizes.get(a, 1) <= 1 and config.mesh.world_size > 1:
            raise ValueError(f"strategy {name!r} needs mesh axis {a!r} > 1; "
                             f"mesh is {sizes}")
    if name == "single" and config.mesh.world_size > 1:
        raise ValueError(f"strategy 'single' on a mesh of "
                         f"{config.mesh.world_size} devices ({sizes})")
    t = config.training
    dp = sizes.get("dp", 1)
    if t.fsdp:
        if dp <= 1:
            raise ValueError("training.fsdp requires a dp mesh axis of size "
                             "> 1; this mesh has none")
        raise _not_ported("training.fsdp (ZeRO-3)", "§1, item 3c")
    if t.optimizer.lower().startswith(("zero1", "zero2")) and dp > 1:
        raise _not_ported(f"optimizer {t.optimizer!r} (ZeRO-1/2 state "
                          f"sharding over dp)", "§1, item 3c")
    mesh = build_mesh(MeshSpec.from_config(config.mesh))
    return Strategy(
        name=name, config=config, mesh=mesh,
        batch_axes=tuple(a for a in ("dp", "ep") if a in sizes),
        model_axes=tuple(a for a in ("tp", "sp") if sizes.get(a, 1) > 1),
        partial_axes=tuple(a for a in ("pp",) if sizes.get(a, 1) > 1))

