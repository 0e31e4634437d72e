"""Typed configuration: mesh, model and training fields.

Port of ``quintnet_tpu/core/config.py``: the same dataclasses, built
from the same YAML schema the reference ships, so a reference config
maps over field for field. The port trains on one device only; the
mesh fields are carried so a config round-trips, and the trainer
rejects a mesh of more than one device.

PyYAML is imported only inside :func:`load_config`, for ``.yaml`` /
``.yml`` files: the machine with the card has no PyYAML, and a ``.json``
file (JSON is a subset of YAML) loads with the standard library.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Canonical axis names. ``sp`` (sequence) and ``ep`` (expert) are
# capability upgrades over the reference's dp/tp/pp.
KNOWN_AXES = ("dp", "tp", "pp", "sp", "ep")


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only keys that are fields of ``cls`` (mirrors the tolerant
    ``from_dict`` of the reference's GPT2Config, gpt2_config.py:160-168)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class MeshConfig:
    """Mesh shape and axis naming.

    Mirrors the reference's ``mesh_dim`` / ``mesh_name`` YAML keys
    (examples/config.yaml:21-23) but validates them.
    """

    mesh_dim: List[int] = field(default_factory=lambda: [1])
    mesh_name: List[str] = field(default_factory=lambda: ["dp"])

    def __post_init__(self):
        if len(self.mesh_dim) != len(self.mesh_name):
            raise ValueError(
                f"mesh_dim {self.mesh_dim} and mesh_name {self.mesh_name} "
                "must have the same length"
            )
        if len(set(self.mesh_name)) != len(self.mesh_name):
            raise ValueError(f"duplicate axis names in {self.mesh_name}")
        for n in self.mesh_name:
            if n not in KNOWN_AXES:
                raise ValueError(f"unknown mesh axis {n!r}; known: {KNOWN_AXES}")
        for d in self.mesh_dim:
            if d < 1:
                raise ValueError(f"mesh dims must be >= 1, got {self.mesh_dim}")

    def size(self, axis: str) -> int:
        """Size of a named axis; 1 if the axis is absent (name-based, never
        positional)."""
        if axis in self.mesh_name:
            return self.mesh_dim[self.mesh_name.index(axis)]
        return 1

    @property
    def world_size(self) -> int:
        n = 1
        for d in self.mesh_dim:
            n *= d
        return n

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.mesh_name, self.mesh_dim))


@dataclass
class ModelConfig:
    """ViT-style model fields, same names as the reference YAML
    (examples/config.yaml:2-14)."""

    name: str = "vit"
    image_size: int = 28
    patch_size: int = 7
    in_channels: int = 1
    hidden_dim: int = 64
    depth: int = 8
    num_heads: int = 4
    mlp_ratio: float = 4.0
    num_classes: int = 10
    dropout: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TrainingConfig:
    """Training hyperparameters (reference: examples/config.yaml + gpt2_config.yaml)."""

    batch_size: int = 32
    micro_batch_size: Optional[int] = None
    gradient_accumulation_steps: int = 1
    epochs: int = 1
    learning_rate: float = 3e-4
    # None -> per-optimizer default (0.01 for adamw, the reference's
    # GPT2Trainer value); an explicit 0.0 really means no decay
    weight_decay: Optional[float] = None
    optimizer: str = "adam"  # adam | adamw | zero1_adamw
    # "bfloat16" stores Adam's FIRST moment in bf16 (halves that state;
    # nu stays f32 — second moments span too many decades for bf16)
    adam_mu_dtype: str = "float32"
    # ZeRO-3/FSDP: block params STORED sharded over dp (one free dim per
    # leaf) and all-gathered per layer inside the scan body — the
    # all_gather's vjp is a reduce-scatter, so gradients and optimizer
    # state arrive/live sharded too (ZeRO-1 falls out for free; use a
    # plain adam/adamw optimizer name with this, not zero1_*/zero2_*).
    # Requires dp > 1; not wired under pp (stage fns — loud error).
    fsdp: bool = False
    # LR schedule (the reference trains at a constant lr everywhere —
    # trainer.py:89, GPT2_Trainer.py:100-104; schedules are an upgrade):
    # constant | cosine | linear. warmup_steps prepends a linear 0->lr
    # ramp to any of them; cosine/linear decay to
    # learning_rate*min_lr_ratio over decay_steps TOTAL steps (incl.
    # warmup), so decay_steps > warmup_steps is required for those.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 0
    min_lr_ratio: float = 0.0
    grad_clip_norm: Optional[float] = 1.0
    seed: int = 0
    # 1f1b (vjp-recompute backward) | 1f1b_stored (store activations,
    # the reference's semantics) | afab (reference: schedule.py:39-516)
    schedule: str = "1f1b"
    # sequence-parallel attention algorithm: ring | zigzag | ulysses.
    # zigzag = load-balanced causal ring (~2x less compute at high sp,
    # ops/ring_attention.py:zigzag_ring_attention); falls back to plain
    # ring for non-causal attention automatically.
    sp_mode: str = "ring"
    dtype: str = "float32"
    param_dtype: str = "float32"
    remat: bool = False
    # remat granularity: "full" recomputes whole blocks in backward;
    # "dots" keeps matmul outputs and recomputes elementwise only
    # (jax dots_saveable policy — less recompute, more live memory)
    remat_policy: str = "full"
    # lax.scan unroll factor over the layer stack (>1 lets XLA
    # software-pipeline adjacent layers at the cost of code size)
    scan_unroll: int = 1
    log_every: int = 50
    # host-side dispatch-depth bound: sync (device->host read of the
    # loss) every N steps. Async dispatch otherwise runs unboundedly
    # ahead of execution; on the CPU-sim backend enough enqueued
    # cross-module collectives DEADLOCK XLA's in-process rendezvous
    # (parked collective waits starve the shared thunk pool — measured
    # on a 1-core/4-device sim: depth 8 safe, 16 deadlocks, ZeRO-2
    # reduce_scatter first to trip), and on any backend an unbounded
    # queue wastes host memory. The drain costs only the host dispatch
    # latency every N steps (<1% at real step times). 0 disables.
    sync_every: int = 8
    # host-side batch prefetch depth (data/datasets.prefetch_batches):
    # overlaps tokenisation/stacking with device steps. 0 disables.
    prefetch: int = 2
    # step-granular checkpoint cadence (quintnet_tpu/ft/): save the full
    # train state + cursor every N optimizer steps and/or T seconds
    # (OR-combined), async, on top of the end-of-epoch saves. 0 = only
    # epoch boundaries. Preemptible-pod guidance: docs/fault_tolerance.md.
    save_every_steps: int = 0
    save_every_seconds: float = 0.0

    @property
    def remat_mode(self):
        """The ``remat`` argument for model specs: False, True, or
        the policy string ("dots")."""
        if not self.remat:
            return False
        return self.remat_policy if self.remat_policy != "full" else True


@dataclass
class Config:
    """Top-level config: mesh + model + training + free-form extras."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    strategy_name: str = "auto"
    checkpoint_path: Optional[str] = None
    data: Dict[str, Any] = field(default_factory=dict)
    extra: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "Config":
        """Build from a (possibly reference-schema) YAML dict.

        Accepts both nested ({model: {...}, training: {...}}) and the
        reference's flat-ish schema where mesh keys live at top level
        (examples/config.yaml:16-24).
        """
        raw = dict(raw or {})

        mesh_raw = raw.get("mesh", {})
        if not mesh_raw:
            # reference flat schema: top-level mesh_dim/mesh_name, possibly
            # under a 'parallelism' block
            par = raw.get("parallelism", raw)
            mesh_raw = {
                "mesh_dim": par.get("mesh_dim", [1]),
                "mesh_name": par.get("mesh_name", ["dp"]),
            }
        mesh = MeshConfig(**_filter_kwargs(MeshConfig, mesh_raw))

        model_raw = dict(raw.get("model", {}))
        model = ModelConfig(**_filter_kwargs(ModelConfig, model_raw))
        model.extra.update(
            {k: v for k, v in model_raw.items()
             if k not in {f.name for f in dataclasses.fields(ModelConfig)}}
        )

        train_raw = dict(raw.get("training", {}))
        training = TrainingConfig(**_filter_kwargs(TrainingConfig, train_raw))

        known_top = {"mesh", "model", "training", "parallelism", "strategy_name",
                     "checkpoint_path", "data", "mesh_dim", "mesh_name"}
        extra = {k: v for k, v in raw.items() if k not in known_top}

        return Config(
            mesh=mesh,
            model=model,
            training=training,
            strategy_name=raw.get("strategy_name", raw.get("strategy", "auto")),
            checkpoint_path=raw.get("checkpoint_path"),
            data=dict(raw.get("data", {})),
            extra=extra,
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    # Convenience accessors (name-based; see module docstring).
    @property
    def dp_size(self) -> int:
        return self.mesh.size("dp")

    @property
    def tp_size(self) -> int:
        return self.mesh.size("tp")

    @property
    def pp_size(self) -> int:
        return self.mesh.size("pp")

    @property
    def sp_size(self) -> int:
        return self.mesh.size("sp")

    @property
    def ep_size(self) -> int:
        return self.mesh.size("ep")

    def micro_batch_size_resolved(self) -> int:
        """micro = batch // (grad_acc * dp * ep), the reference's formula
        (trainer.py:99-146) extended to ep, which also shards the batch
        dim (parallel/strategy.py)."""
        t = self.training
        if t.micro_batch_size is not None:
            return t.micro_batch_size
        denom = t.gradient_accumulation_steps * self.dp_size * self.ep_size
        if self.training.batch_size % denom != 0:
            raise ValueError(
                f"batch_size {t.batch_size} not divisible by "
                f"grad_acc*dp*ep = {denom}"
            )
        return t.batch_size // denom


def load_config(path: str) -> Config:
    """A ``.json`` file (standard library) or a YAML file (PyYAML,
    imported here) -> :class:`Config`."""
    with open(path, "r") as f:
        if str(path).endswith(".json"):
            raw = json.load(f)
        else:
            try:
                import yaml
            except ImportError as e:
                raise ImportError(
                    f"reading {path} needs PyYAML, which is not installed; "
                    f"pass the same config as a .json file") from e
            raw = yaml.safe_load(f)
    return Config.from_dict(raw or {})
