"""Device mesh over ``torch.distributed`` process groups.

Port of ``quintnet_tpu/core/mesh.py``. The JAX package lays its devices
out as a ``jax.sharding.Mesh`` with named axes and lets collectives
take axis names. The port runs one process per rank, so a mesh is the
row-major map from global rank to mesh coordinate (the reshape JAX's
``build_mesh`` applies to the CPU device list) plus one process group
for every line of every set of axes a collective may name: the
reference's per-dimension sub-groups (reference: core/mesh.py:213-251,
core/process_groups.py:42-181), one per line.

Every rank must create every group, in the same order, or the ranks
deadlock: :func:`build_mesh` is the one place that creates them, and it
must be called by every rank of the world.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from quintnet_tpu_torch.core.config import MeshConfig

AxisNames = Union[str, Sequence[str]]


@dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes, in layout order (later axes are minor:
    adjacent ranks differ along the last axis, so ``tp`` goes last)."""

    axes: Tuple[Tuple[str, int], ...]

    @staticmethod
    def create(**sizes: int) -> "MeshSpec":
        """``MeshSpec.create(dp=2, tp=2)``; size-1 axes are kept, so their
        names stay valid."""
        return MeshSpec(axes=tuple((k, int(v)) for k, v in sizes.items()))

    @staticmethod
    def from_config(cfg: MeshConfig) -> "MeshSpec":
        return MeshSpec(axes=tuple(zip(cfg.mesh_name, cfg.mesh_dim)))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def world_size(self) -> int:
        return int(np.prod(self.shape)) if self.axes else 1

    def size(self, axis: str) -> int:
        for n, s in self.axes:
            if n == axis:
                return s
        return 1


def rank_grid(spec: MeshSpec) -> np.ndarray:
    """Global rank at every mesh coordinate: ``arange(world).reshape``
    (row-major), as JAX's ``build_mesh`` lays out the CPU devices."""
    return np.arange(spec.world_size).reshape(spec.shape)


def axis_lines(spec: MeshSpec, axes: Sequence[str]) -> List[List[int]]:
    """The ranks of every line along ``axes`` (names in mesh order): the
    ranks that agree on every other axis, in row-major order over
    ``axes``. Lines are listed in row-major order of the other axes."""
    grid = rank_grid(spec)
    names = spec.names
    idx = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in idx]
    moved = np.transpose(grid, rest + idx)
    return [list(map(int, line))
            for line in moved.reshape(-1, int(np.prod([spec.shape[i]
                                                        for i in idx])))]


def _canonical(spec: MeshSpec, axes: AxisNames) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in spec.names:
            raise ValueError(f"axis {a!r} is not in the mesh {spec.names}")
    if list(axes) != sorted(axes, key=spec.names.index):
        raise ValueError(f"axes {axes} must be listed in mesh order "
                         f"{spec.names}")
    if len(set(axes)) != len(axes):
        raise ValueError(f"repeated axis in {axes}")
    return axes


class MeshAxis:
    """One set of mesh axes seen from this rank: its size, this rank's
    coordinate along it (row-major over the names), the ranks of its line
    and the process group over them (None when the size is 1)."""

    def __init__(self, mesh: "Mesh", names: Tuple[str, ...]):
        self.mesh, self.names = mesh, names
        self.size = int(np.prod([mesh.spec.size(a) for a in names]))
        coord = mesh.coords
        index = 0
        for a in names:
            index = index * mesh.spec.size(a) + coord[a]
        self.index = index
        line = next(ln for ln in axis_lines(mesh.spec, names)
                    if mesh.rank in ln)
        self.ranks = line
        self.group = mesh._groups.get(names)

    def __repr__(self):
        return (f"MeshAxis({'x'.join(self.names)}, size={self.size}, "
                f"index={self.index})")


class Mesh:
    """The port's counterpart of ``jax.sharding.Mesh`` for one rank:
    ``devices`` (the rank grid), ``axis_names``, ``shape`` (name -> size,
    as ``jax.sharding.Mesh.shape``), this rank's ``coords`` and
    :meth:`axis` for a collective's group."""

    def __init__(self, spec: MeshSpec, rank: int, groups: Dict):
        self.spec = spec
        self.rank = rank
        self.devices = rank_grid(spec)
        self.axis_names = spec.names
        self.shape = dict(spec.axes)
        where = np.argwhere(self.devices == rank)[0]
        self.coords = {a: int(i) for a, i in zip(spec.names, where)}
        self._groups = groups
        self._axes: Dict[Tuple[str, ...], MeshAxis] = {}

    @property
    def size(self) -> int:
        return self.spec.world_size

    def axis(self, names: AxisNames) -> MeshAxis:
        key = _canonical(self.spec, names)
        if key not in self._axes:
            self._axes[key] = MeshAxis(self, key)
        return self._axes[key]


def build_mesh(spec: MeshSpec, *, rank: Optional[int] = None) -> Mesh:
    """This rank's :class:`Mesh`. With more than one rank the process
    group must be initialized (``core/runtime.initialize``) with a world
    of exactly ``spec.world_size`` ranks; every rank must call this, in
    the same order as its other group creations. A one-rank spec needs no
    process group."""
    n = spec.world_size
    if n == 1:
        return Mesh(spec, 0, {})
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {dict(spec.axes)} needs {n} ranks joined by "
            f"torch.distributed (core/runtime.initialize); none is")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {dict(spec.axes)} needs {n} ranks, the "
                         f"world has {world}")
    me = dist.get_rank() if rank is None else int(rank)
    groups = {}
    # every subset of axes (mesh order) whose lines hold more than one
    # rank; the whole world uses the default group
    for r in range(1, len(spec.names) + 1):
        for axes in itertools.combinations(spec.names, r):
            size = int(np.prod([spec.size(a) for a in axes]))
            if size == 1:
                continue
            if size == n:
                groups[axes] = dist.group.WORLD
                continue
            for line in axis_lines(spec, axes):
                g = dist.new_group(line)
                if me in line:
                    groups[axes] = g
    return Mesh(spec, me, groups)


def mesh_from_sizes(**sizes: int) -> Mesh:
    """Shorthand: ``mesh_from_sizes(dp=2, tp=2)``."""
    return build_mesh(MeshSpec.create(**sizes))


def local_axis_index(mesh: Mesh, axis: str, rank: Optional[int] = None
                     ) -> int:
    """Coordinate of ``rank`` (default: this rank) along ``axis``."""
    rank = mesh.rank if rank is None else rank
    where = np.argwhere(mesh.devices == rank)
    if where.size == 0:
        raise ValueError(f"rank {rank} not in mesh")
    return int(where[0][mesh.axis_names.index(axis)])


def describe(mesh: Mesh) -> str:
    """Human-readable summary: the axes, then each coordinate's rank."""
    lines = [f"Mesh: {mesh.shape} ({mesh.size} ranks)"]
    for idx, r in np.ndenumerate(mesh.devices):
        lines.append(f"  {dict(zip(mesh.axis_names, idx))} -> rank {r}")
    return "\n".join(lines)
