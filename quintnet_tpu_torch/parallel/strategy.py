"""Strategy facade: which mesh axes take which role, and the train step.

Port of ``quintnet_tpu/parallel/strategy.py`` for the strategies
``single``, ``dp``, ``tp``, ``pp``, ``dp_tp``, ``dp_pp``, ``tp_pp``,
``3d`` and those with expert parallelism, ``ep``, ``dp_ep``, ``ep_tp``,
``ep_pp`` and ``3d_ep``. A strategy is data: the mesh (one process per
rank, ``core/mesh.py``), the axes the batch is sharded over
(``batch_axes``: dp and ep, which is a data axis whose ranks also own
different experts),
the axes the model is sharded over, whose loss is computed redundantly
(``model_axes``), and the pipeline axes (``partial_axes``). With pp the
step runs ``training.schedule``'s pipeline (``parallel/pp.py``: AFAB,
``1f1b`` or ``1f1b_stored``) over ``gradient_accumulation_steps``
micro-batches; a ``zero1_``/``zero2_`` optimizer shards its state over
dp (``parallel/zero.py``); ``training.fsdp`` (ZeRO-3) stores the blocks
sharded over dp and gathers each layer just before use, so their
gradients and Adam moments live sharded too. The strategies with sp
(``sp``, ``dp_sp``, ``4d``, ``5d``) raise ``NotImplementedError`` naming
ROADMAP.md §1, item 6.
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
PORTED = ("single", "dp", "tp", "pp", "dp_tp", "dp_pp", "tp_pp", "3d",
          "ep", "dp_ep", "ep_tp", "ep_pp", "3d_ep")
# the ROADMAP.md item each axis of the strategies still to port waits for
AXIS_ITEMS = {
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
    tp_axis=None, fsdp_axis=None)`` -> scalar loss on this rank's shards,
    the generator driving training dropout, ``tp_axis`` the tp
    :class:`~quintnet_tpu_torch.core.mesh.MeshAxis` (None without tp)
    and ``fsdp_axis`` the axis the blocks are ZeRO-3-sharded over (None
    without fsdp); on a mesh with ep > 1 every function below is also
    handed ``ep_axis`` (the loss, the evaluation and the pipeline
    functions the ep :class:`~quintnet_tpu_torch.core.mesh.MeshAxis`,
    the specs its name); ``depth`` the layer count (pp must divide it);
    ``needs_rng`` True when the model uses dropout;
    ``eval_metrics_fn(params, batch, *, tp_axis=None, fsdp_axis=None) ->
    {name: device scalar}`` (optional: ViT gives loss and accuracy);
    ``partition_specs(tp_axis=None, pp_axis=None, fsdp_axis=None)`` -> the
    spec tree (axis names; ``parallel/tp.py``) and ``to_tp_layout(params,
    tp)`` -> the params in the tp-blocked fused-QKV layout, both needed
    on a mesh; ``pipeline_fns(tp_axis=None)`` -> ``(embed_fn, stage_fn,
    head_loss_fn)`` for ``parallel/pp.py`` and, optionally,
    ``pipeline_eval_fns(tp_axis=None)`` -> ``(embed_fn, stage_fn,
    head_metrics_fn)`` (without it a pp evaluation reports the loss
    alone)."""

    init: Callable[[Any], Any]
    loss_fn: Callable
    depth: int
    needs_rng: bool = False
    eval_metrics_fn: Optional[Callable] = None
    partition_specs: Optional[Callable] = None
    to_tp_layout: Optional[Callable] = None
    pipeline_fns: Optional[Callable] = None
    pipeline_eval_fns: Optional[Callable] = None


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

    @property
    def uses_pp(self) -> bool:
        return any(self.mesh.shape.get(a, 1) > 1 for a in self.partial_axes)

    @property
    def zero1_axis(self) -> Optional[str]:
        """``"dp"`` when the config asks for a ``zero1_*``/``zero2_*``
        optimizer on a mesh with dp > 1: the optimizer state is then
        sharded over dp (``parallel/zero.py``)."""
        if (self.config.training.optimizer.lower().startswith(
                ("zero1", "zero2")) and self.mesh.shape.get("dp", 1) > 1):
            return "dp"
        return None

    @property
    def fsdp_axis(self) -> Optional[str]:
        """``"dp"`` under ZeRO-3/FSDP (``training.fsdp`` on a mesh with
        dp > 1): the blocks are stored dp-sharded and each layer is
        all-gathered just before use (``nn/transformer.py``)."""
        if self.config.training.fsdp and self.mesh.shape.get("dp", 1) > 1:
            return "dp"
        return None

    @property
    def zero_stage(self) -> int:
        """2: the gradients are reduce-scattered over dp too."""
        return 2 if self.config.training.optimizer.lower().startswith(
            "zero2") else 1

    # -- placement -----------------------------------------------------
    def param_specs(self, model: ModelSpec):
        if model.partition_specs is None:
            raise ValueError(f"strategy {self.name!r} needs the model's "
                             f"partition_specs")
        kw = {}
        if self.fsdp_axis is not None:
            kw["fsdp_axis"] = self.fsdp_axis
        if self._axis_name("ep") is not None:
            kw["ep_axis"] = "ep"
        return model.partition_specs(tp_axis=self._axis_name("tp"),
                                     pp_axis=self._axis_name("pp"), **kw)

    def shard_params(self, model: ModelSpec, params):
        """Full params (every rank holds the same, from the same seed) ->
        this rank's shards: the tp layout, then each dim that names a
        present axis cut to this rank's chunk (the stacked blocks' depth
        over pp: stage s holds layers ``s L/pp .. (s + 1) L/pp - 1``;
        under fsdp one dim of each block leaf over dp)."""
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
        """The optimizer state of this rank's shards: every moment has its
        parameter's shape, so it is sharded like it (under fsdp, over dp
        too); under ZeRO-1/2 the moments are this rank's flat chunk over
        dp."""
        if self.zero1_axis is not None:
            from quintnet_tpu_torch.parallel.zero import init_chunk_state

            return init_chunk_state(optimizer, params, self.mesh,
                                    axis=self.zero1_axis)
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
        batch) or None)`` with this rank's tp and fsdp axes bound. On a
        pp mesh the loss is None (the pipeline's step has its own) and
        the evaluation is the forward pipeline (``parallel/pp.
        make_afab_eval_fn``) over the model's ``pipeline_eval_fns``, or
        the loss alone from its ``pipeline_fns``."""
        tp_axis = self.axis_or_none("tp")
        if self.uses_pp:
            return None, self._pipeline_eval_fn(model, tp_axis)
        kw = self._ep_kw()
        if tp_axis is not None:
            kw["tp_axis"] = tp_axis
        if self.fsdp_axis is not None:
            kw["fsdp_axis"] = self.mesh.axis(self.fsdp_axis)
        if not kw:
            return model.loss_fn, model.eval_metrics_fn

        def loss(params, batch, generator=None):
            return model.loss_fn(params, batch, generator, **kw)

        ev = model.eval_metrics_fn
        if ev is not None:
            def ev(params, batch, _fn=model.eval_metrics_fn):
                return _fn(params, batch, **kw)
        return loss, ev

    def _ep_kw(self) -> dict:
        """``{"ep_axis": the ep MeshAxis}`` on a mesh with ep > 1, else
        empty: models without experts never see the keyword."""
        ep = self.axis_or_none("ep")
        return {} if ep is None else {"ep_axis": ep}

    def pipeline_fns(self, model: ModelSpec):
        """The model's ``(embed_fn, stage_fn, head_loss_fn)`` on this
        rank's tp and ep axes."""
        return model.pipeline_fns(tp_axis=self.axis_or_none("tp"),
                                  **self._ep_kw())

    def _pipeline_spec(self):
        from quintnet_tpu_torch.parallel.pp import PipelineSpec

        return PipelineSpec(
            n_micro=self.config.training.gradient_accumulation_steps,
            pp_axis=self.mesh.axis("pp"))

    def _pipeline_eval_fn(self, model: ModelSpec, tp_axis):
        from quintnet_tpu_torch.parallel.pp import (SplitHead,
                                                    make_afab_eval_fn)

        if model.pipeline_eval_fns is not None:
            embed_fn, stage_fn, head = model.pipeline_eval_fns(
                tp_axis=tp_axis, **self._ep_kw())
        else:
            embed_fn, stage_fn, loss_head = self.pipeline_fns(model)
            if isinstance(loss_head, SplitHead):
                head = SplitHead(loss_head.local_fn,
                                 lambda local, y, valid, _r=loss_head.
                                 reduce_fn: {"loss": _r(local, y, valid)})
            else:
                def head(p, h, y, _h=loss_head):
                    return {"loss": _h(p, h, y)}
        return make_afab_eval_fn(embed_fn, stage_fn, head,
                                 self._pipeline_spec())

    def make_train_step(self, model: ModelSpec, optimizer):
        """The step of this strategy: one device's, the mesh step over
        accumulated micro-batches, or on pp the schedule
        ``training.schedule`` names (``afab``; ``1f1b``/``one_f_one_b``
        or ``1f1b_stored``) over ``gradient_accumulation_steps``
        micro-batches (the step's own accumulation is then 1)."""
        from quintnet_tpu_torch.parallel.train_step import (
            make_parallel_train_step, make_train_step)

        check_fsdp(self.config)
        t = self.config.training
        if self.name == "single":
            loss, _ = self.model_fns(model)
            return make_train_step(
                loss, optimizer,
                grad_accum_steps=t.gradient_accumulation_steps,
                grad_clip_norm=t.grad_clip_norm, needs_rng=model.needs_rng)
        common = dict(batch_axes=self.batch_axes, model_axes=self.model_axes,
                      partial_axes=self.partial_axes,
                      grad_clip_norm=t.grad_clip_norm,
                      zero1_axis=self.zero1_axis, zero_stage=self.zero_stage,
                      needs_rng=model.needs_rng)
        specs = self.param_specs(model)
        if not self.uses_pp:
            loss, _ = self.model_fns(model)
            return make_parallel_train_step(
                self.mesh, loss, optimizer, specs,
                grad_accum_steps=t.gradient_accumulation_steps, **common)
        from quintnet_tpu_torch.parallel.pp import (make_1f1b_grad_fn,
                                                    make_afab_loss_fn,
                                                    validate_pp)

        if model.pipeline_fns is None:
            raise ValueError(f"strategy {self.name!r} needs the model's "
                             f"pipeline_fns")
        validate_pp(model.depth, self.mesh.shape["pp"])
        fns = self.pipeline_fns(model)
        pspec = self._pipeline_spec()
        sched = t.schedule.lower()
        if sched in ("1f1b", "one_f_one_b", "1f1b_stored"):
            grad_fn = make_1f1b_grad_fn(
                *fns, pspec, store_activations=sched == "1f1b_stored")
            return make_parallel_train_step(self.mesh, None, optimizer,
                                            specs, grad_fn=grad_fn, **common)
        return make_parallel_train_step(self.mesh, make_afab_loss_fn(
            *fns, pspec), optimizer, specs, **common)


def check_fsdp(config: Config) -> None:
    """JAX's three guards on ``training.fsdp``, with its exception types
    and messages: fsdp needs a dp axis of size > 1 (``ValueError``), is
    not wired under pp (``NotImplementedError``) and subsumes ZeRO-1/2
    (``ValueError``). Decided from the config alone, so
    :func:`get_strategy` raises before any process group is touched."""
    t = config.training
    if not t.fsdp:
        return
    sizes = dict(config.mesh.axis_sizes)
    if sizes.get("dp", 1) <= 1:
        raise ValueError(
            "training.fsdp requires a dp mesh axis of size > 1 "
            f"(mesh: {sizes}); with no dp axis there is nothing to shard "
            "over — remove the flag or add dp")
    if sizes.get("pp", 1) > 1:
        raise NotImplementedError(
            "training.fsdp under pipeline parallelism is not wired (stage "
            "fns receive raw block shards); use dp/tp/sp/ep meshes, or "
            "zero1_*/zero2_* optimizers with pp")
    if t.optimizer.lower().startswith(("zero1", "zero2")):
        raise ValueError(
            "training.fsdp already shards gradients and optimizer state "
            "over dp (ZeRO-3 subsumes 1/2); use a plain adam/adamw "
            "optimizer name with fsdp")


def get_strategy(name: Optional[str] = None,
                 config: Optional[Config] = None) -> Strategy:
    """Build the strategy ``name`` over ``config.mesh``; ``None`` or
    ``"auto"`` picks it from the axes of size > 1. With more than one
    rank the process group must already be joined
    (``core/runtime.initialize``) with a world of the mesh's size; every
    rank calls this in the same order (it creates the mesh's process
    groups). ``single``, ``dp``, ``tp``, ``pp``, ``dp_tp``, ``dp_pp``,
    ``tp_pp``, ``3d``, ``ep``, ``dp_ep``, ``ep_tp``, ``ep_pp`` and
    ``3d_ep`` are ported, with ``training.fsdp`` on the meshes
    :func:`check_fsdp` allows; those with sp raise
    ``NotImplementedError`` naming their ROADMAP.md item, unknown names
    ``ValueError``."""
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
    check_fsdp(config)
    mesh = build_mesh(MeshSpec.from_config(config.mesh))
    return Strategy(
        name=name, config=config, mesh=mesh,
        batch_axes=tuple(a for a in ("dp", "ep") if a in sizes),
        model_axes=tuple(a for a in ("tp", "sp") if sizes.get(a, 1) > 1),
        partial_axes=tuple(a for a in ("pp",) if sizes.get(a, 1) > 1))

