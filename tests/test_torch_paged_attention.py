"""The port's paged attention (quintnet_tpu_torch/ops/paged_attention.py)
and paged pool writes against the JAX package.

On the CPU the port's wrapper runs its plain version
(``paged_attention_ref``, the gathered-view math); it is held here to
the JAX Pallas kernel in interpret mode and to JAX's gathered-view
``mha_prefill_paged(attn_kernel="xla")``. Inputs are made with numpy
from a seed and fed to both packages, all in f32. Tolerance
``atol=rtol=1e-5``: the same f32 math, summed in a different order.

The CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_cuda_kernels.py`` (skipped without a card) and by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quintnet_tpu.nn import attention as jattn
from quintnet_tpu.ops.paged_attention import \
    paged_attention as jax_paged_attention
from quintnet_tpu_torch.nn import attention as tattn
from quintnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                    paged_attention_ref)

torch.set_num_threads(1)

BS, M, D = 4, 5, 8          # block size, table width, head dim
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _case(seed, *, S, Hq, Hkv, P, starts, dead=()):
    """Random q and pool; disjoint random tables (block 0 is the null
    block); dead rows keep an all-zero table and start 0."""
    rng = np.random.default_rng(seed)
    nb = 1 + S * M
    q = rng.standard_normal((S, Hq, P, D)).astype(np.float32)
    k = rng.standard_normal((nb * BS, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((nb * BS, Hkv, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.zeros((S, M), np.int32)
    for s in range(S):
        if s not in dead:
            tables[s] = perm[s * M:(s + 1) * M]
    return q, k, v, tables, np.asarray(starts, np.int32)


CASES = {
    # decode: S = 3 rows, one query each, row 2 dead (null table, pos 0)
    "decode": dict(S=3, Hq=2, Hkv=2, P=1, starts=[7, 13, 0], dead=(2,)),
    # short runs at different starts; row 1's pad queries pass the table
    "runs": dict(S=2, Hq=2, Hkv=2, P=4, starts=[0, 18]),
    "runs_offset": dict(S=2, Hq=2, Hkv=2, P=4, starts=[5, 9]),
    # GQA: 4 query heads on 2 kv heads
    "gqa": dict(S=2, Hq=4, Hkv=2, P=3, starts=[2, 11]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_kernel(name):
    q, k, v, tables, starts = _case(3, **CASES[name])
    want = jax_paged_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(tables),
                               jnp.asarray(starts), block_size=BS)
    got = paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(starts),
                          block_size=BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got.numpy()).all()


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    q, k, v, tables, starts = _case(4, **CASES["gqa"])
    before = paged_attention.launches
    a = paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(starts),
                        block_size=BS)
    b = paged_attention_ref(_t(q), _t(k), _t(v), _t(tables), _t(starts),
                            block_size=BS)
    assert torch.equal(a, b)
    assert paged_attention.launches == before


# ---------------------------------------------------------------------
# mha entry points and pool writes
# ---------------------------------------------------------------------

H = 2


@pytest.fixture(scope="module")
def mha_params():
    p = jattn.mha_init(jax.random.key(1), H * D)
    return p, jax.tree.map(lambda a: _t(np.asarray(a)), p)


def _pools(seed, nb):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((nb * BS, H, D)).astype(np.float32)
            for _ in range(2)]


def test_prefill_at_offset_matches_jax_xla(mha_params):
    """Two prefill chunks of one row through the same bucket width: the
    second starts at a non-block-aligned offset over the prefix the
    first wrote, with pad columns past its tail."""
    jp, tp = mha_params
    nb = 1 + M
    row = np.arange(1, nb, dtype=np.int32)[::-1].copy()
    kj, vj = (jnp.asarray(a) for a in _pools(6, nb))
    kt, vt = (_t(a) for a in _pools(6, nb))
    rng = np.random.default_rng(7)
    P = 8
    for start, tail in ((0, 6), (6, 5)):
        x = rng.standard_normal((1, P, H * D)).astype(np.float32)
        pos = start + np.arange(P, dtype=np.int32)
        yj, kj, vj = jattn.mha_prefill_paged(
            jp, jnp.asarray(x), kj, vj, jnp.asarray(pos), jnp.int32(tail),
            num_heads=H, block_tables=jnp.asarray(row), block_size=BS,
            attn_kernel="xla")
        yt, kt, vt = tattn.mha_prefill_paged(
            tp, _t(x), kt, vt, _t(pos), tail, num_heads=H,
            block_tables=_t(row), block_size=BS)
        # pad positions past the tail are garbage both sides; compare
        # the tail's rows only
        np.testing.assert_allclose(yt.numpy()[:, :tail],
                                   np.asarray(yj)[:, :tail], **TOL)
        real = slice(BS, None)          # the null block collects pad
        np.testing.assert_array_equal(kt.numpy()[real],
                                      np.asarray(kj)[real])
        np.testing.assert_array_equal(vt.numpy()[real],
                                      np.asarray(vj)[real])


def test_decode_matches_jax_xla(mha_params):
    jp, tp = mha_params
    S, nb = 3, 1 + 3 * M
    _, _, _, tables, pos = _case(8, S=S, Hq=H, Hkv=H, P=1,
                                 starts=[7, 13, 0], dead=(2,))
    kp, vp = _pools(9, nb)
    x = np.random.default_rng(10).standard_normal(
        (S, 1, H * D)).astype(np.float32)
    yj, kj, vj = jattn.mha_decode(
        jp, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pos), num_heads=H, block_tables=jnp.asarray(tables),
        block_size=BS)
    yt, kt, vt = tattn.mha_decode(tp, _t(x), _t(kp), _t(vp), _t(pos),
                                  num_heads=H, block_tables=_t(tables),
                                  block_size=BS)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_paged_cache_update_byte_identical():
    S, nb = 3, 1 + 3 * M
    _, _, _, tables, pos = _case(11, S=S, Hq=H, Hkv=H, P=1,
                                 starts=[3, 19, 0], dead=(2,))
    kp, vp = _pools(12, nb)
    rng = np.random.default_rng(13)
    k, v = (rng.standard_normal((S, H, D)).astype(np.float32)
            for _ in range(2))
    kj, vj = jattn.paged_cache_update(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos), block_tables=jnp.asarray(tables), block_size=BS)
    kt, vt = tattn.paged_cache_update(
        _t(kp), _t(vp), _t(k), _t(v), _t(pos), block_tables=_t(tables),
        block_size=BS)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("start,tail", [(0, 8), (3, 5), (17, 3)])
def test_paged_prefill_update_byte_identical(start, tail):
    """Pad columns and positions past the table go to the null block on
    both sides; every real block is byte-identical."""
    nb, P = 1 + M, 8
    row = np.arange(1, nb, dtype=np.int32)
    kp, vp = _pools(14, nb)
    rng = np.random.default_rng(15)
    k, v = (rng.standard_normal((H, P, D)).astype(np.float32)
            for _ in range(2))
    pos = start + np.arange(P, dtype=np.int32)
    kj, vj = jattn.paged_prefill_update(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos), jnp.int32(tail), block_tables=jnp.asarray(row),
        block_size=BS)
    kt, vt = tattn.paged_prefill_update(
        _t(kp), _t(vp), _t(k), _t(v), _t(pos), tail,
        block_tables=_t(row), block_size=BS)
    real = slice(BS, None)
    np.testing.assert_array_equal(kt.numpy()[real], np.asarray(kj)[real])
    np.testing.assert_array_equal(vt.numpy()[real], np.asarray(vj)[real])


def test_paged_gather_matches_jax():
    _, k, _, tables, _ = _case(16, S=2, Hq=2, Hkv=2, P=1, starts=[0, 0])
    want = jattn.paged_gather(jnp.asarray(k), jnp.asarray(tables),
                              block_size=BS)
    got = tattn.paged_gather(_t(k), _t(tables), block_size=BS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
