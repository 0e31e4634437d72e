"""The port's collectives (quintnet_tpu_torch/core/collectives.py) on a
4-rank gloo world, against JAX's shard_map on 4 virtual devices.

Every golden of ``tests/test_collectives.py`` — values and gradients —
is computed here by JAX (the same functions under ``shard_map``, each
device's row of the global result) and compared with what each port
rank returned, rank by rank: exactly (the values are small integers),
except the dp gradient golden, an f32 product held at ``rtol=1e-6`` as
``tests/test_collectives.py`` holds it.
The collectives the goldens do not cover (``all_to_all``, the stacked
gather, the transposes of ``reduce_scatter``, ``all_reduce_mean`` and a
wrapping shift) are held to JAX the same way. One world runs every
case (``_torch_dist.run_world``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _torch_dist import run_world
from _torch_dist_cases import collectives_case
from quintnet_tpu.core import collectives as jcc
from quintnet_tpu.core.mesh import mesh_from_sizes

N = 4


def _smap(mesh, fn, in_specs, out_specs):
    return jcc.shard_map_fn(fn, mesh, in_specs, out_specs)


def _goldens():
    """name -> the global JAX result [4, ...]: row r is device r's (one
    jitted program for all of them)."""
    return {k: np.asarray(v) for k, v in jax.jit(_golden_fn)().items()}


def _golden_fn():
    m = mesh_from_sizes(x=N)
    g = {}
    x = jnp.arange(8.0).reshape(4, 2)
    g["all_reduce_sum"] = _smap(m, lambda v: jcc.all_reduce(v, "x"),
                                (P("x"),), P("x"))(x)

    def ar_loss(v):
        y = _smap(m, lambda u: jcc.all_reduce(u, "x"), (P("x"),), P("x"))(v)
        return jnp.sum(y * jnp.arange(8.0).reshape(4, 2))
    g["all_reduce_grad"] = jax.grad(ar_loss)(jnp.ones((4, 2)))

    gather = lambda v: _smap(  # noqa: E731
        m, lambda u: jcc.all_gather(u, "x", gather_dim=-1),
        (P("x", None),), P("x", None))(v)
    g["all_gather_concat"] = gather(x)
    w = jnp.arange(32, dtype=jnp.float32).reshape(4, 8)
    g["all_gather_grad"] = jax.grad(
        lambda v: jnp.sum(gather(v) * w))(jnp.ones((4, 2)))

    g["reduce_scatter"] = _smap(
        m, lambda v: jcc.reduce_scatter(v, "x", scatter_dim=-1),
        (P("x", None),), P("x", None))(jnp.ones((4, 8)))

    fwd = lambda v: _smap(m, lambda u: jcc.send_forward(u, "x"),  # noqa
                          (P("x"),), P("x"))(v)
    g["send_forward"] = fwd(jnp.arange(4.0).reshape(4, 1) + 1.0)
    wt = jnp.asarray([[0.0], [10.0], [20.0], [30.0]])
    g["send_forward_grad"] = jax.grad(lambda v: jnp.sum(fwd(v) * wt))(
        jnp.arange(4.0).reshape(4, 1))
    g["send_backward"] = _smap(m, lambda u: jcc.send_backward(u, "x"),
                               (P("x"),), P("x"))(
        jnp.arange(4.0).reshape(4, 1) + 1.0)

    g["broadcast_from"] = _smap(
        m, lambda v: jcc.broadcast_from(v, "x", src=2), (P("x"),),
        P("x"))(jnp.arange(4.0).reshape(4, 1))

    tree = {"a": jnp.arange(4.0).reshape(4, 1), "b": jnp.ones((4, 3))}
    red = _smap(m, lambda t: jcc.tree_all_reduce_mean(t, "x"),
                ({"a": P("x"), "b": P("x")},), {"a": P("x"), "b": P("x")})(
        tree)
    g["tree_mean_a"], g["tree_mean_b"] = red["a"], red["b"]

    wm = jnp.asarray([[0.5, -1.0], [2.0, 0.25]])
    xs = jnp.arange(16.0).reshape(8, 2) / 10.0

    def local_loss(w_, x_):
        return jnp.mean(jnp.sum((x_ @ w_) ** 2, -1))

    def dp_grads(w_, x_):
        return jcc.all_reduce_mean(jax.grad(local_loss)(w_, x_), "x")[None]
    g["dp_mean_grad"] = _smap(m, dp_grads, (P(None, None), P("x", None)),
                              P("x"))(wm, xs)
    g["dp_mean_grad_ref"] = jax.grad(local_loss)(wm, xs)

    ys = jnp.arange(16.0).reshape(4, 4) * (jnp.arange(4.0)[:, None] + 1)
    g["all_to_all"] = _smap(
        m, lambda v: jcc.all_to_all(v.reshape(4, 1), "x", split_dim=0,
                                    concat_dim=1)[None],
        (P("x"),), P("x"))(ys)

    def a2a_loss(v):
        wa = jnp.arange(4.0)[None, :] + 10 * jnp.arange(4.0)[:, None]
        out = _smap(m, lambda u, w_: jcc.all_to_all(
            u, "x", split_dim=0, concat_dim=1) * w_,
            (P("x"), P("x")), P("x"))(v, wa)
        return jnp.sum(out)
    g["all_to_all_grad"] = jax.grad(a2a_loss)(
        jnp.repeat(jnp.arange(4.0) + 1.0, 4)[:, None])

    g["all_gather_stacked"] = _smap(
        m, lambda v: jcc.all_gather(v[0], "x", tiled=False)[None],
        (P("x"),), P("x"))(jnp.stack([jnp.float32([r, -r])
                                      for r in range(4)]))

    scale = (jnp.arange(4.0) + 1.0)[:, None]
    g["reduce_scatter_grad"] = jax.grad(lambda v: jnp.sum(_smap(
        m, lambda u, s: jcc.reduce_scatter(u, "x", scatter_dim=-1) * s,
        (P("x", None), P("x")), P("x", None))(v, scale)))(jnp.ones((4, 8)))
    g["all_reduce_mean_grad"] = jax.grad(lambda v: jnp.sum(_smap(
        m, lambda u, s: jcc.all_reduce_mean(u, "x") * s[:, 0],
        (P("x"), P("x")), P("x"))(v, scale)))(jnp.arange(4.0) + 1.0)
    g["shift_wrap_grad"] = jax.grad(lambda v: jnp.sum(_smap(
        m, lambda u, s: jcc.ppermute_shift(u, "x", shift=1, wrap=True)
        * s[:, 0], (P("x"), P("x")), P("x"))(v, scale)))(
        jnp.arange(4.0) + 1.0)
    return g


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_world(collectives_case, N, tmp_path_factory.mktemp("cc"))


@pytest.fixture(scope="module")
def goldens():
    return _goldens()


CASES = ["all_reduce_sum", "all_reduce_grad", "all_gather_concat",
         "all_gather_grad", "reduce_scatter", "send_forward",
         "send_forward_grad", "send_backward", "broadcast_from",
         "tree_mean_a", "tree_mean_b", "dp_mean_grad", "all_to_all",
         "all_to_all_grad", "all_gather_stacked", "reduce_scatter_grad",
         "all_reduce_mean_grad", "shift_wrap_grad"]


@pytest.mark.parametrize("name", CASES)
def test_each_rank_equals_jax(ranks, goldens, name):
    want = goldens[name].reshape(N, -1)      # row r: device r's block
    rtol = 1e-6 if name == "dp_mean_grad" else 0.0
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[name].ravel(), want[r], rtol=rtol,
                                   atol=0.0, err_msg=f"{name}, rank {r}")


def test_goldens_of_test_collectives(goldens):
    """The literal values tests/test_collectives.py asserts, so a change
    on either side shows."""
    np.testing.assert_array_equal(goldens["all_reduce_grad"],
                                  np.tile([[12.0, 16.0]], (4, 1)))
    np.testing.assert_array_equal(goldens["send_forward"].ravel(),
                                  [0.0, 1.0, 2.0, 3.0])
    np.testing.assert_array_equal(goldens["send_forward_grad"].ravel(),
                                  [10.0, 20.0, 30.0, 0.0])
    np.testing.assert_array_equal(goldens["broadcast_from"].ravel(), [2.0] * 4)
    np.testing.assert_allclose(goldens["dp_mean_grad"][0],
                               goldens["dp_mean_grad_ref"], rtol=1e-6)


def test_axis_queries(ranks):
    for r, out in enumerate(ranks):
        assert out["axis"].tolist() == [r, N]
