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
from quintnet_tpu_torch.ops.paged_attention import (insert_runs,
                                                    paged_attention,
                                                    paged_attention_ref,
                                                    paged_gather,
                                                    paged_gather_scales)

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
# the decode path's split-and-combine (flash-decoding), emulated
# ---------------------------------------------------------------------

def _split_kv(q, k_pool, v_pool, tables, starts, *, block_size, n_splits,
              unit=4, kv_scales=None, fresh_kv=None):
    """The CUDA decode path's arithmetic in plain torch: each row's live
    positions ``[0, min(start + P, W))`` (W = M x block_size) dealt to
    ``n_splits`` splits in units of ``unit`` positions, unit u to split u
    % n_splits (the kernel deals units of 16; smaller units spread these
    small tables over more splits); per split and query row the running
    max ``m`` (log2 units), sum ``l`` and unnormalised ``o``, a split
    with no visible position giving ``m = -inf, l = 0``; then the combine
    in split order. Scales multiply the score (K) and the probability (V)
    of their position, 1 for the fresh run's positions."""
    S, Hq, P, D = q.shape
    Hkv = k_pool.shape[1]
    G = Hq // Hkv
    W = tables.shape[1] * block_size
    raw = [paged_gather(t, tables, block_size=block_size).float()
           for t in (k_pool, v_pool)]                     # [S, Hkv, W, D]
    if kv_scales is None:
        scl = [torch.ones(raw[0].shape[:3]) for _ in range(2)]
    else:
        scl = [paged_gather_scales(x, tables, block_size=block_size)[..., 0]
               for x in kv_scales]                        # [S, Hkv, W]
    if fresh_kv is not None:
        raw = [insert_runs(r, f, starts) for r, f in zip(raw, fresh_kv)]
        ones = torch.ones((S, Hkv, P, 1))
        scl = [insert_runs(x[..., None], ones, starts)[..., 0] for x in scl]
    out = torch.empty_like(q)
    scale_log2 = np.log2(np.e) / np.sqrt(D)
    rows_i = torch.arange(G * P) % P
    for s in range(S):
        start = int(starts[s])
        live = min(start + P, W)
        for kvh in range(Hkv):
            qr = q[s, kvh * G:(kvh + 1) * G].reshape(G * P, D)
            kr, vr = raw[0][s, kvh], raw[1][s, kvh]
            sk, sv = scl[0][s, kvh], scl[1][s, kvh]
            parts = []
            for j in range(n_splits):
                t = torch.arange(live)
                t = t[t // unit % n_splits == j]
                if len(t) == 0:
                    parts.append((torch.full((G * P,), -torch.inf),
                                  torch.zeros(G * P), torch.zeros(G * P, D)))
                    continue
                x = (qr @ kr[t].T) * sk[t] * scale_log2
                x = x.masked_fill(t[None, :] > start + rows_i[:, None],
                                  -torch.inf)
                m = x.amax(dim=-1)
                p = torch.where(x == -torch.inf, 0.0,
                                torch.exp2(x - m.clamp_min(-1e30)[:, None]))
                parts.append((m, p.sum(dim=-1), (p * sv[t]) @ vr[t]))
            mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
            num, den = torch.zeros(G * P, D), torch.zeros(G * P)
            for m, l, o in parts:
                w = torch.where(m == -torch.inf, 0.0, torch.exp2(m - mx))
                num, den = num + w[:, None] * o, den + w * l
            out[s, kvh * G:(kvh + 1) * G] = (num / den[:, None]).reshape(
                G, P, D)
    return out


# GQA (4 query heads on 2 kv heads), two queries a row (the verify
# shape's pad columns), a dead row; rows of 9 and 19 positions, 3 and 5
# units of 4, so from 4 splits on the short rows leave splits empty
SPLIT_CASE = dict(S=3, Hq=4, Hkv=2, P=2, starts=[7, 17, 0], dead=(2,))


@pytest.mark.parametrize("n_splits", range(1, 9))
def test_split_and_combine_matches_plain_version(n_splits):
    q, k, v, tables, starts = map(_t, _case(17, **SPLIT_CASE))
    want = paged_attention_ref(q, k, v, tables, starts, block_size=BS)
    got = _split_kv(q, k, v, tables, starts, block_size=BS,
                    n_splits=n_splits)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("n_splits", [1, 3, 8])
def test_split_and_combine_scaled_with_fresh_run(n_splits):
    """int8 pools with per-block scales and the fresh run overriding the
    pool at ``[start, start + P)``, as a scaled policy calls the kernel."""
    q, k, v, tables, starts = map(_t, _case(18, **SPLIT_CASE))
    rng = np.random.default_rng(19)
    k, v = ((t * 40).round().clamp(-127, 127).to(torch.int8) for t in (k, v))
    nb = k.shape[0] // BS
    scales = tuple(_t(rng.uniform(0.01, 0.06, (nb, 2)).astype(np.float32))
                   for _ in range(2))
    fresh = tuple(_t(rng.standard_normal((3, 2, 2, D)).astype(np.float32))
                  for _ in range(2))
    kw = dict(block_size=BS, kv_scales=scales, fresh_kv=fresh)
    want = paged_attention_ref(q, k, v, tables, starts, **kw)
    got = _split_kv(q, k, v, tables, starts, n_splits=n_splits, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


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
