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
from test_torch_flash_attention import _tf32_matmul

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
# the prefill path's tiling in 3xTF32, emulated
# ---------------------------------------------------------------------

def _prefill_tiles(q, k_pool, v_pool, tables, starts, *, block_size,
                   rows=8, keys=4, n_split=1, kv_scales=None, fresh_kv=None):
    """The CUDA prefill path's arithmetic in plain torch. Per (row s, kv
    head) the G x P query rows are folded into one sequence, row r =
    query r // G of head kvh * G + r % G, and cut into tiles of ``rows``
    (the kernel: 64); each tile's key tiles of ``keys`` positions (the
    kernel: 64) up to its last query's position, clamped to the table,
    are dealt to ``n_split`` splits, key tile u to split u % n_split.
    Each key position's source is resolved through the table: the fresh
    run's row for ``[start, start + P)`` under a scaled policy (scales
    1), else its pool slot and its block's scales (1 when unscaled), so a
    key tile that straddles ``start`` mixes sources. Both products go
    through ``_tf32_matmul`` with 3 terms; the K scale multiplies the
    score, the V scale the probability fed to P V (the running sum takes
    the unscaled one); masked scores hold -1e30 in natural-log units (the
    kernel's online softmax). Each split keeps its own running max, sum
    and unnormalised o (a split without key tiles: -1e30, 0, 0); the
    partials combine in split order."""
    S, Hq, P, D = q.shape
    Hkv = k_pool.shape[1]
    G = Hq // Hkv
    W = tables.shape[1] * block_size
    out = torch.zeros_like(q)
    for s in range(S):
        start = int(starts[s])
        for kvh in range(Hkv):
            qr = q[s, kvh * G:(kvh + 1) * G].transpose(0, 1).reshape(G * P, D)
            o_rows = torch.zeros(G * P, D)
            for r0 in range(0, G * P, rows):
                r = torch.arange(r0, min(r0 + rows, G * P))
                pos = start + r // G
                n_keys = min(int(pos.max()) + 1, W)
                parts = []
                for split in range(n_split):
                    parts.append(_prefill_split(
                        qr[r], pos, range(split * keys, n_keys,
                                          n_split * keys), keys, n_keys,
                        tables[s], kvh, start, block_size, k_pool, v_pool,
                        kv_scales,
                        None if fresh_kv is None else
                        tuple(f[s, kvh] for f in fresh_kv)))
                mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
                num, den = torch.zeros(len(r), D), torch.zeros(len(r))
                for m, l, o in parts:
                    w = torch.exp(m - mx)
                    num, den = num + w[:, None] * o, den + w * l
                o_rows[r] = num / den[:, None]
            out[s, kvh * G:(kvh + 1) * G] = o_rows.reshape(P, G, D).transpose(
                0, 1)
    return out


def _prefill_split(qr, pos, key_starts, keys, n_keys, table, kvh, start,
                   block_size, k_pool, v_pool, kv_scales, fresh):
    """One split of a row tile: the online softmax over its key tiles
    (first positions ``key_starts``). Returns (m, l, unnormalised o)."""
    D = qr.shape[1]
    P = None if fresh is None else fresh[0].shape[0]
    neg = -1e30
    m = torch.full((len(pos),), neg)
    l = torch.zeros(len(pos))
    o = torch.zeros(len(pos), D)
    for k0 in key_starts:
        t = torch.arange(k0, min(k0 + keys, n_keys))
        blk = table[t // block_size].long()
        slot = blk * block_size + t % block_size
        kt, vt = (pool[slot, kvh].float() for pool in (k_pool, v_pool))
        sk, sv = ((sc[blk, kvh] for sc in kv_scales) if kv_scales is not None
                  else (torch.ones(len(t)), torch.ones(len(t))))
        if fresh is not None:
            rel = t - start
            run = (rel >= 0) & (rel < P)
            rc = rel.clamp(0, P - 1)
            kt = torch.where(run[:, None], fresh[0][rc], kt)
            vt = torch.where(run[:, None], fresh[1][rc], vt)
            sk = torch.where(run, 1.0, sk)
            sv = torch.where(run, 1.0, sv)
        x = _tf32_matmul(qr, kt.T, 3) * sk[None, :] / np.float32(np.sqrt(D))
        x = x.masked_fill(t[None, :] > pos[:, None], neg)
        m_new = torch.maximum(m, x.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(x > 0.5 * neg, torch.exp(x - m_new[:, None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[:, None] + _tf32_matmul(p * sv[None, :], vt, 3)
        m = m_new
    return m, l, o


# prefill-like calls: tails at block-aligned and unaligned starts (key
# tiles of 4 straddle start 5 and 9), one whose pad queries pass the
# table's end, GQA 2 and 4 folded into one row tile, two rows
PREFILL_CASES = {
    "tails": dict(S=2, Hq=2, Hkv=2, P=6, starts=[5, 9]),
    "start0": dict(S=1, Hq=2, Hkv=2, P=12, starts=[0]),
    "past_table": dict(S=1, Hq=2, Hkv=2, P=8, starts=[15]),
    "gqa2": dict(S=2, Hq=4, Hkv=2, P=5, starts=[2, 11]),
    "gqa4": dict(S=1, Hq=4, Hkv=1, P=7, starts=[6]),
}
# (rows, keys, splits) of a row tile: the kernel's 64 x 64 unsplit, small
# tiles that cut these short rows many times, and key tiles dealt to 2 and
# 4 splits (some of them empty on the short rows)
TILINGS = [(8, 4, 1), (64, 64, 1), (16, 8, 1), (8, 4, 2), (8, 2, 4)]


def _scaled(seed, q, k, v, layout):
    """``layout``'s pools and call arguments from an f32 case: int8 pools
    with random scales and a fresh run, or fake_quant (all-one scales, the
    run's slots overwritten, the true run as fresh K/V)."""
    rng = np.random.default_rng(seed)
    S, _, P, _ = q.shape
    nb, Hkv = k.shape[0] // BS, k.shape[1]
    if layout == "f32":
        return (k, v), {}
    if layout == "int8":
        k8, v8 = ((t * 40).round().clamp(-127, 127).to(torch.int8)
                  for t in (k, v))
        scales = tuple(_t(rng.uniform(0.01, 0.06, (nb, Hkv)).astype(
            np.float32)) for _ in range(2))
        fresh = tuple(_t(rng.standard_normal((S, Hkv, P, D)).astype(
            np.float32)) for _ in range(2))
        return (k8, v8), dict(kv_scales=scales, fresh_kv=fresh)
    raise ValueError(layout)


def _fake_quant_of(q, k, v, tables, starts, seed):
    """The f32 pool's run slots ``[start, start + P)`` (inside the table)
    as fresh K/V, those slots overwritten with noise, all-one scales:
    what fake_quant passes for the same attention as the f32 pool."""
    rng = np.random.default_rng(seed)
    S, _, P, _ = q.shape
    Hkv, W = k.shape[1], tables.shape[1] * BS
    fresh = [torch.zeros((S, Hkv, P, D)) for _ in range(2)]
    kw, vw = k.clone(), v.clone()
    for s in range(S):
        for i in range(P):
            t = int(starts[s]) + i
            if t >= W:
                continue
            slot = int(tables[s, t // BS]) * BS + t % BS
            fresh[0][s, :, i], fresh[1][s, :, i] = k[slot], v[slot]
            kw[slot] = _t(rng.standard_normal((Hkv, D)).astype(np.float32))
            vw[slot] = _t(rng.standard_normal((Hkv, D)).astype(np.float32))
    ones = torch.ones((k.shape[0] // BS, Hkv))
    return kw, vw, dict(kv_scales=(ones, ones), fresh_kv=tuple(fresh))


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("layout", ["f32", "int8"])
@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_tiling_matches_plain_version(name, layout, tiling):
    q, k, v, tables, starts = map(_t, _case(21, **PREFILL_CASES[name]))
    (k, v), kw = _scaled(22, q, k, v, layout)
    want = paged_attention_ref(q, k, v, tables, starts, block_size=BS, **kw)
    rows, keys, n_split = tiling
    got = _prefill_tiles(q, k, v, tables, starts, block_size=BS, rows=rows,
                         keys=keys, n_split=n_split, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_tiling_fake_quant_is_f32_bitwise(name, tiling):
    """fake_quant (all-one scales, the run from the fresh K/V) and the f32
    pool holding the run: the same bits out of the emulated tiling, and
    both within 1e-5 of the plain version."""
    q, k, v, tables, starts = map(_t, _case(23, **PREFILL_CASES[name]))
    kf, vf, kw = _fake_quant_of(q, k, v, tables, starts, 24)
    rows, keys, n_split = tiling
    a = _prefill_tiles(q, k, v, tables, starts, block_size=BS, rows=rows,
                       keys=keys, n_split=n_split)
    b = _prefill_tiles(q, kf, vf, tables, starts, block_size=BS, rows=rows,
                       keys=keys, n_split=n_split, **kw)
    assert torch.equal(a, b)
    want = paged_attention_ref(q, kf, vf, tables, starts, block_size=BS, **kw)
    np.testing.assert_allclose(b.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_prefill_tiling_matches_jax_kernel(name):
    """The emulated tiling (the kernel's 64 x 64 tiles) against the JAX
    Pallas kernel in interpret mode, f32 and int8 with a fresh run."""
    q, k, v, tables, starts = map(_t, _case(25, **PREFILL_CASES[name]))
    for layout in ("f32", "int8"):
        (kp, vp), kw = _scaled(26, q, k, v, layout)
        jkw = {key: tuple(jnp.asarray(a.numpy()) for a in val)
               for key, val in kw.items()}
        want = jax_paged_attention(
            jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
            jnp.asarray(vp.numpy()), jnp.asarray(tables.numpy()),
            jnp.asarray(starts.numpy()), block_size=BS, **jkw)
        got = _prefill_tiles(q, kp, vp, tables, starts, block_size=BS,
                             rows=64, keys=64, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
