"""Strategy facade: what a model provides, and the single-device step.

Port of ``quintnet_tpu/parallel/strategy.py`` for the ``"single"``
strategy only. The JAX package names seventeen strategies over a device
mesh; every strategy other than ``"single"``, and a config whose mesh
holds more than one device, raises ``NotImplementedError`` (ROADMAP.md
§1, slice 3: the dp x tp x pp mesh).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from quintnet_tpu_torch.core.config import Config

# every strategy name the JAX package knows (for the error message)
JAX_STRATEGIES = ("single", "dp", "tp", "pp", "sp", "ep", "dp_tp", "dp_pp",
                  "tp_pp", "dp_sp", "dp_ep", "ep_tp", "ep_pp", "3d", "3d_ep",
                  "4d", "5d")


@dataclass
class ModelSpec:
    """What a model must provide to be trained.

    ``init(generator)`` -> param tree on ``generator.device``;
    ``loss_fn(params, batch, generator=None)`` -> scalar loss, with the
    generator driving training dropout; ``depth`` the layer count;
    ``needs_rng`` True when the model uses dropout, so the step hands
    ``loss_fn`` a generator; ``eval_metrics_fn(params, batch) -> {name:
    device scalar}`` (optional: ViT gives loss and accuracy) is what
    ``Trainer.evaluate`` averages, else the loss alone. (The JAX spec's
    partition specs, pipeline functions and tp layout belong to the mesh
    strategies.)"""

    init: Callable[[Any], Any]
    loss_fn: Callable
    depth: int
    needs_rng: bool = False
    eval_metrics_fn: Optional[Callable] = None


@dataclass
class Strategy:
    """The single-device strategy: no mesh, the whole batch on one
    device."""

    name: str
    config: Config

    def make_train_step(self, model: ModelSpec, optimizer):
        from quintnet_tpu_torch.parallel.train_step import make_train_step

        t = self.config.training
        return make_train_step(
            model.loss_fn, optimizer,
            grad_accum_steps=t.gradient_accumulation_steps,
            grad_clip_norm=t.grad_clip_norm, needs_rng=model.needs_rng)


def get_strategy(name: Optional[str] = None,
                 config: Optional[Config] = None) -> Strategy:
    """``"single"`` (or ``None``/``"auto"`` on a one-device mesh) ->
    the single-device :class:`Strategy`. Other strategies raise
    ``NotImplementedError``; unknown names ``ValueError``."""
    config = config or Config.from_dict({})
    if name in (None, "auto"):
        if config.mesh.world_size > 1:
            raise NotImplementedError(
                f"a mesh of {config.mesh.world_size} devices "
                f"({config.mesh.axis_sizes}) is not ported: the port trains "
                f"on one device (strategy 'single'; ROADMAP.md §1, slice 3)")
        name = "single"
    elif name not in JAX_STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; known: "
                         f"{sorted(JAX_STRATEGIES)}")
    elif name != "single":
        raise NotImplementedError(
            f"strategy {name!r} is not ported: the port trains on one "
            f"device (strategy 'single'; ROADMAP.md §1, slice 3)")
    if config.training.fsdp:
        raise ValueError("training.fsdp requires a dp mesh axis of size > 1; "
                         "the single-device strategy has none")
    return Strategy(name="single", config=config)
