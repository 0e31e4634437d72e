"""The port's mesh (quintnet_tpu_torch/core/mesh.py) against JAX's.

The rank -> coordinate map is JAX's ``build_mesh(...).devices`` (the
row-major reshape of the CPU devices) for the meshes [2, 2, 2], [4, 2]
and [2]; each axis's lines are the device rows of JAX's mesh along it.
On an 8-rank gloo world the process groups ``build_mesh`` creates are
checked per axis (and per pair of adjacent axes): an all_reduce over a
group sums exactly the ranks of this rank's line.
"""

import numpy as np
import pytest

from _torch_dist import run_world
from _torch_dist_cases import mesh_case
from quintnet_tpu.core.mesh import MeshSpec as JaxMeshSpec
from quintnet_tpu.core.mesh import build_mesh as jax_build_mesh
from quintnet_tpu_torch.core.config import MeshConfig
from quintnet_tpu_torch.core.mesh import (MeshSpec, axis_lines, build_mesh,
                                          describe, local_axis_index,
                                          rank_grid)

SHAPES = {"2x2x2": dict(dp=2, tp=2, pp=2), "4x2": dict(dp=4, tp=2),
          "2": dict(dp=2)}


def _jax_ids(sizes):
    mesh = jax_build_mesh(JaxMeshSpec.create(**sizes))
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rank_grid_is_jax_device_layout(shape):
    sizes = SHAPES[shape]
    ids = _jax_ids(sizes)
    np.testing.assert_array_equal(rank_grid(MeshSpec.create(**sizes)), ids)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_axis_lines_are_jax_rows(shape):
    sizes = SHAPES[shape]
    spec, ids = MeshSpec.create(**sizes), _jax_ids(sizes)
    for i, a in enumerate(spec.names):
        rows = np.moveaxis(ids, i, -1).reshape(-1, spec.size(a))
        assert axis_lines(spec, (a,)) == rows.tolist()


def test_spec_from_config_and_one_rank_mesh():
    spec = MeshSpec.from_config(MeshConfig([2, 1, 4], ["dp", "pp", "tp"]))
    assert spec.names == ("dp", "pp", "tp") and spec.shape == (2, 1, 4)
    assert spec.world_size == 8 and spec.size("tp") == 4
    assert spec.size("sp") == 1
    mesh = build_mesh(MeshSpec.create(dp=1, tp=1))
    assert mesh.axis("tp").size == 1 and mesh.axis("tp").group is None
    assert local_axis_index(mesh, "dp") == 0
    assert "rank 0" in describe(mesh)
    with pytest.raises(ValueError, match="mesh order"):
        build_mesh(MeshSpec.create(dp=1, tp=1)).axis(("tp", "dp"))


def test_needs_a_joined_world():
    with pytest.raises(RuntimeError, match="torch.distributed"):
        build_mesh(MeshSpec.create(dp=2))


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return run_world(mesh_case, 8, tmp_path_factory.mktemp("mesh"),
                     [SHAPES["2x2x2"], SHAPES["4x2"]])


@pytest.mark.parametrize("which", [0, 1])
def test_groups_sum_over_their_lines(world8, which):
    sizes = [SHAPES["2x2x2"], SHAPES["4x2"]][which]
    spec = MeshSpec.create(**sizes)
    ids = _jax_ids(sizes)
    names = spec.names
    for rank, outs in enumerate(world8):
        out = outs[which]
        where = np.argwhere(ids == rank)[0]
        assert out["coords"] == {a: int(i) for a, i in zip(names, where)}
        for k in (1, 2):
            for i in range(len(names) - k + 1):
                axes = names[i:i + k]
                line = next(ln for ln in axis_lines(spec, axes)
                            if rank in ln)
                assert out[axes] == sorted(line), (rank, axes)
                assert out[(axes, "line")] == line
                idx = 0
                for a in axes:
                    idx = idx * spec.size(a) + int(where[names.index(a)])
                assert out[(axes, "index")] == idx
