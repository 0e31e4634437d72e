"""The port's quantized and narrow KV pools against the JAX package.

Every KV layout policy of the ladder (f32, bf16, int8, fp8, fake_quant):

- the policies' scale / quant / dequant math, byte for byte;
- ``paged_quant_window_update`` (the scaled pool write), byte for byte
  on every real pool block;
- the paged-attention kernel's plain version with scales and the
  fresh-K/V override, against the JAX Pallas kernel in interpret mode
  (fp8, which JAX's Pallas path refuses, against JAX's gathered view);
- ``mha_decode`` / ``mha_prefill_paged`` / ``mha_verify_paged``, two
  calls back to back, against JAX's ``attn_kernel="xla"`` path;
- whole engines: greedy streams identical to the JAX engine's, and
  fake_quant identical to f32;
- ``paged_eval_nll`` against JAX's.

Inputs are numpy arrays from a seed, fed to both packages. Block 0 is
the null block: dead rows and pad columns write into it on both sides
and nobody reads it, so every pool comparison leaves it out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quintnet_tpu.analysis.specs import \
    kv_layout_policies as jax_kv_layout_policies
from quintnet_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from quintnet_tpu.models.gpt2 import gpt2_init as jax_gpt2_init
from quintnet_tpu.nn import attention as jattn
from quintnet_tpu.ops.paged_attention import \
    paged_attention as jax_paged_attention
from quintnet_tpu.ops.paged_attention import \
    paged_quant_window_update as jax_window_update
from quintnet_tpu.serve import KVPool as JaxKVPool
from quintnet_tpu.serve import ServeEngine as JaxServeEngine
from quintnet_tpu.serve import gpt2_family as jax_gpt2_family
from quintnet_tpu.serve import kv_quant as jkq
from quintnet_tpu_torch.analysis.specs import kv_layout_policies
from quintnet_tpu_torch.bridge import gpt2_params_from_numpy
from quintnet_tpu_torch.models.gpt2 import GPT2Config
from quintnet_tpu_torch.nn import attention as tattn
from quintnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                    paged_attention_ref,
                                                    paged_quant_window_update)
from quintnet_tpu_torch.serve import KVPool, ServeEngine, gpt2_family
from quintnet_tpu_torch.serve import kv_quant as tkq

torch.set_num_threads(1)

POLICIES = ("f32", "bf16", "int8", "fp8", "fake_quant")
SCALED = ("int8", "fake_quant")
BS, M, D = 4, 5, 8          # block size, table width, head dim
TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------
# moving arrays between the packages
# ---------------------------------------------------------------------

_NARROW = {"bfloat16": np.int16, "float8_e4m3fn": np.uint8}


def _to_torch(a, dtype=None):
    """numpy (ml_dtypes narrow floats included) -> torch, bytes kept."""
    a = np.asarray(a)
    if a.dtype.name in _NARROW:
        raw = torch.from_numpy(np.array(a.view(_NARROW[a.dtype.name])))
        return raw.view(getattr(torch, a.dtype.name))
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _bytes(x):
    """The stored bits of a torch tensor or a JAX/numpy array, as numpy:
    narrow floats as same-width integers, so equality is bytewise."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(_NARROW[a.dtype.name]) if a.dtype.name in _NARROW else a


def _f32(x):
    """Stored values as f32 numpy, for either package."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _store_np(policy, a):
    """f32 numpy -> numpy in the JAX policy's store dtype."""
    return np.asarray(jnp.asarray(a).astype(jkq.make_policy(
        policy).store_dtype))


# ---------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------

def _policy_input(seed):
    """[3, 2, 4, 8] groups over the last two axes. Group (0, 0) has
    absmax exactly 127, so its int8 scale is exactly 1.0 and 2.5, -3.5,
    0.5, -0.5 and 126.5 are exact ties; group (1, 1) is all zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 2, 4, 8)) * 3).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 0, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    x[1, 1] = 0.0
    return x


@pytest.mark.parametrize("name", POLICIES)
def test_policy_math_byte_identical(name):
    x = _policy_input(0)
    jp, tp = jkq.make_policy(name), tkq.make_policy(name)
    assert (tp.name, tp.scaled, tp.qmax) == (jp.name, jp.scaled, jp.qmax)
    sj = jp.compute_scale(jnp.asarray(x), (2, 3))
    st = tp.compute_scale(torch.from_numpy(x), (2, 3))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for sj_b, st_b in ((sj[..., None, None], st[..., None, None]),
                       (None, None)):
        qj = jp.quant(jnp.asarray(x), sj_b)
        qt = tp.quant(torch.from_numpy(x), st_b)
        np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
        np.testing.assert_array_equal(tp.dequant(qt, st_b).numpy(),
                                      np.asarray(jp.dequant(qj, sj_b)))
    if name == "int8":
        q = tp.quant(torch.from_numpy(x), st[..., None, None])[0, 0, 0, :6]
        assert q.tolist() == [127, 2, -4, 0, 0, 126]      # half to even
        assert float(st[1, 1]) == np.float32(1e-8)        # the floor


@pytest.mark.parametrize("name", POLICIES)
def test_bytes_per_block_matches_jax(name):
    for kw in (dict(n_layers=2, n_kv_heads=4, head_dim=16, block_size=8),
               dict(n_layers=12, n_kv_heads=12, head_dim=64,
                    block_size=16)):
        assert (tkq.make_policy(name).bytes_per_block(**kw)
                == jkq.make_policy(name).bytes_per_block(**kw))
    pool_kw = dict(n_layers=2, n_kv_heads=2, head_dim=8, block_size=4,
                   num_blocks=6)
    tpool = KVPool(**pool_kw, policy=name, device="cpu")
    jpool = JaxKVPool(**pool_kw, policy=name)
    assert tpool.pool_bytes == jpool.pool_bytes
    assert len(tpool.caches()) == len(jpool.caches())
    if tpool.policy.scaled:
        assert torch.equal(tpool.k_scale, torch.ones(2, 6, 2))


def test_ladder_and_dtype_resolution_match_jax():
    assert tkq.policy_names() == jkq.policy_names() == POLICIES
    assert kv_layout_policies() == jax_kv_layout_policies()
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"),
                     (torch.float8_e4m3fn, "fp8"), (None, "f32")):
        assert tkq.make_policy(dt).name == name
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        tkq.make_policy("int4")
    with pytest.raises(ValueError, match="no passthrough policy"):
        tkq.make_policy(torch.int8)


@pytest.mark.parametrize("name", SCALED)
def test_dequant_roundtrip_error_matches_jax(name):
    x = _policy_input(1)
    ej, sj = jkq.dequant_roundtrip_error(jkq.make_policy(name), x)
    et, st = tkq.dequant_roundtrip_error(tkq.make_policy(name), x)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert (et <= st / 2 + 1e-7).all()


# ---------------------------------------------------------------------
# paged_quant_window_update
# ---------------------------------------------------------------------

H = 2


def _scaled_pool(seed, name, nb, *, stale=False):
    """A pool that already holds data: random int8 bytes under random
    scales (int8), random f32 under all-one scales (fake_quant). With
    ``stale`` every int8 slot holds +-127 under a large scale — a
    recycled block's previous owner."""
    rng = np.random.default_rng(seed)
    if name == "int8":
        if stale:
            cache = (rng.choice([-127, 127], (nb * BS, H, D))
                     .astype(np.int8))
            scales = np.full((nb, H), 0.5, np.float32)
        else:
            cache = rng.integers(-127, 128, (nb * BS, H, D)).astype(np.int8)
            scales = rng.uniform(0.01, 0.1, (nb, H)).astype(np.float32)
    else:
        cache = rng.standard_normal((nb * BS, H, D)).astype(np.float32)
        scales = np.ones((nb, H), np.float32)
    return cache, scales


def _tables(rng, S, dead=()):
    nb = 1 + S * M
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.zeros((S, M), np.int32)
    for s in range(S):
        if s not in dead:
            tables[s] = perm[s * M:(s + 1) * M]
    return tables


WINDOW_CASES = {
    # one token a row, a dead row writing into the null block
    "decode": dict(starts=[7, 13, 0], lens=[1, 1, 1], P=1, dead=(2,)),
    # a prefill run crossing a block boundary from an unaligned start
    "prefill_cross_unaligned": dict(starts=[6], lens=[7], P=8),
    # the run's pad tail passes the window end and the table's end
    "pad_tail_past_window_and_table": dict(starts=[6], lens=[10], P=20),
    # a row that writes nothing
    "row_len_zero": dict(starts=[5, 9], lens=[0, 3], P=4),
    # one token into a recycled block full of large stale bytes
    "recycled_stale": dict(starts=[8], lens=[1], P=1, stale=True),
}


@pytest.mark.parametrize("name", SCALED)
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_update_byte_identical_to_jax(name, case):
    c = WINDOW_CASES[case]
    rng = np.random.default_rng(3)
    S, P = len(c["starts"]), c["P"]
    tables = _tables(rng, S, c.get("dead", ()))
    nb = 1 + S * M
    cache, scales = _scaled_pool(4, name, nb, stale=c.get("stale", False))
    vals = (rng.standard_normal((S, H, P, D)) * 0.5).astype(np.float32)
    positions = (np.asarray(c["starts"], np.int32)[:, None]
                 + np.arange(P, dtype=np.int32)[None, :])
    lens = np.asarray(c["lens"], np.int32)
    span = tattn._quant_span(P, BS, M)
    assert span == jattn._quant_span(P, BS, M)
    cj, sj = jax_window_update(
        jkq.make_policy(name), jnp.asarray(cache), jnp.asarray(scales),
        jnp.asarray(vals), jnp.asarray(positions), jnp.asarray(lens),
        block_tables=jnp.asarray(tables), block_size=BS, max_blocks=span)
    ct, st = _to_torch(cache), _to_torch(scales)
    out = paged_quant_window_update(
        tkq.make_policy(name), ct, st, _to_torch(vals), _to_torch(positions),
        _to_torch(lens), block_tables=_to_torch(tables), block_size=BS,
        max_blocks=span)
    assert out[0] is ct and out[1] is st           # in place
    real = slice(BS, None)
    np.testing.assert_array_equal(_bytes(ct)[real], _bytes(cj)[real])
    np.testing.assert_array_equal(st.numpy()[1:], np.asarray(sj)[1:])
    if case == "recycled_stale" and name == "int8":
        blk = int(tables[0, 2])
        # the new scale is the new token's absmax, not the stale bytes'
        want = np.abs(vals[0, :, 0]).max(axis=-1) / 127
        np.testing.assert_allclose(st[blk].numpy(), want, rtol=1e-6)
        assert (ct.view(nb, BS, H, D)[blk, 1:] == 0).all()


# ---------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------

ATTN_CASES = {
    # decode: one query a row, row 2 dead (null table, start 0)
    "decode": dict(S=3, Hq=2, Hkv=2, P=1, starts=[7, 13, 0], dead=(2,)),
    # runs at offsets; row 1's pad queries pass the table
    "runs_offset": dict(S=2, Hq=2, Hkv=2, P=4, starts=[5, 18]),
    # GQA: 4 query heads on 2 kv heads
    "gqa": dict(S=2, Hq=4, Hkv=2, P=3, starts=[2, 11]),
    # verify: 3 drafts + 1 on every row
    "verify_P4": dict(S=3, Hq=2, Hkv=2, P=4, starts=[0, 6, 15]),
}


def _attn_case(seed, name, *, S, Hq, Hkv, P, starts, dead=()):
    rng = np.random.default_rng(seed)
    nb = 1 + S * M
    tables = _tables(rng, S, dead)
    q = rng.standard_normal((S, Hq, P, D)).astype(np.float32)
    fresh = [rng.standard_normal((S, Hkv, P, D)).astype(np.float32)
             for _ in range(2)]
    if name == "int8":
        pools = [rng.integers(-127, 128, (nb * BS, Hkv, D)).astype(np.int8)
                 for _ in range(2)]
        scales = [rng.uniform(0.01, 0.1, (nb, Hkv)).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [_store_np(name, rng.standard_normal(
            (nb * BS, Hkv, D)).astype(np.float32)) for _ in range(2)]
        scales = [np.ones((nb, Hkv), np.float32) for _ in range(2)]
    return (q, pools, tables, np.asarray(starts, np.int32),
            scales if name in SCALED else None,
            fresh if name in SCALED else None)


def _torch_args(q, pools, tables, starts, scales, fresh):
    kw = dict(block_size=BS)
    if scales is not None:
        kw["kv_scales"] = tuple(_to_torch(s) for s in scales)
        kw["fresh_kv"] = tuple(_to_torch(f) for f in fresh)
    return ((_to_torch(q), *(_to_torch(p) for p in pools), _to_torch(tables),
             _to_torch(starts)), kw)


@pytest.mark.parametrize("name", ("int8", "fake_quant", "bf16"))
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_version_matches_jax_kernel(name, case):
    q, pools, tables, starts, scales, fresh = _attn_case(
        5, name, **ATTN_CASES[case])
    kw = {}
    if scales is not None:
        kw = dict(kv_scales=tuple(jnp.asarray(s) for s in scales),
                  fresh_kv=tuple(jnp.asarray(f) for f in fresh))
    want = jax_paged_attention(jnp.asarray(q), *(jnp.asarray(p)
                                                 for p in pools),
                               jnp.asarray(tables), jnp.asarray(starts),
                               block_size=BS, **kw)
    args, tkw = _torch_args(q, pools, tables, starts, scales, fresh)
    got = paged_attention(*args, **tkw)
    assert torch.equal(got, paged_attention_ref(*args, **tkw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.isfinite(got.numpy()).all()


def _jax_gathered_attention(q, k_pool, v_pool, tables, starts):
    """JAX's gathered-view decode/verify math (``mha_verify_paged``'s
    xla branch after the pool write): dequantized view, GQA repeat,
    scores / sqrt(D), mask to finfo.min, softmax, probs @ V."""
    S, Hq, P, Dh = q.shape
    k_all, v_all = jattn._gather_kv(jnp.asarray(k_pool), jnp.asarray(v_pool),
                                    None, jkq.make_policy("fp8"),
                                    jnp.asarray(tables), block_size=BS)
    rep = Hq // k_all.shape[1]
    k_all, v_all = (jnp.repeat(t, rep, axis=1) for t in (k_all, v_all))
    pos = jnp.asarray(starts)[:, None] + jnp.arange(P)[None, :]
    valid = jnp.arange(k_all.shape[2])[None, None, :] <= pos[:, :, None]
    sc = jnp.einsum("bhsd,bhtd->bhst", jnp.asarray(q), k_all) / np.sqrt(Dh)
    sc = jnp.where(valid[:, None], sc, jnp.finfo(jnp.float32).min)
    probs = jax.nn.softmax(sc, axis=-1)
    return np.asarray(jnp.einsum("bhst,bhtd->bhsd", probs, v_all))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_fp8_plain_version_matches_jax_gathered_view(case):
    q, pools, tables, starts, _, _ = _attn_case(6, "fp8", **ATTN_CASES[case])
    want = _jax_gathered_attention(q, *pools, tables, starts)
    args, kw = _torch_args(q, pools, tables, starts, None, None)
    np.testing.assert_allclose(paged_attention(*args, **kw).numpy(), want,
                               **TOL)


def test_scaled_kernel_requires_fresh_kv():
    q, pools, tables, starts, scales, _ = _attn_case(
        7, "int8", **ATTN_CASES["decode"])
    args, _ = _torch_args(q, pools, tables, starts, None, None)
    with pytest.raises(ValueError, match="fresh_kv"):
        paged_attention(*args, block_size=BS,
                        kv_scales=tuple(_to_torch(s) for s in scales))


def test_fake_quant_override_equals_f32_passthrough():
    """f32 pool holding the run (passthrough) and the same pool with the
    run's slots holding garbage, all-one scales and the run as fresh
    K/V (fake_quant): the same output, bit for bit."""
    q, pools, tables, starts, _, _ = _attn_case(
        8, "f32", **ATTN_CASES["runs_offset"])
    rng = np.random.default_rng(9)
    S, _, P, _ = q.shape
    fresh = [rng.standard_normal((S, 2, P, D)).astype(np.float32)
             for _ in range(2)]
    written = [p.copy() for p in pools]
    for s in range(S):
        for i in range(P):
            t = int(starts[s]) + i
            if t < M * BS:
                slot = tables[s, t // BS] * BS + t % BS
                for w, f in zip(written, fresh):
                    w[slot] = f[s, :, i]
    args, kw = _torch_args(q, written, tables, starts, None, None)
    passthrough = paged_attention(*args, **kw)
    args, kw = _torch_args(q, pools, tables, starts,
                           [np.ones((1 + S * M, 2), np.float32)] * 2, fresh)
    assert torch.equal(paged_attention(*args, **kw), passthrough)


# ---------------------------------------------------------------------
# mha entry points, two calls back to back, against JAX's xla path
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def mha_params():
    p = jattn.mha_init(jax.random.key(1), H * D)
    return p, jax.tree.map(lambda a: _to_torch(np.asarray(a)), p)


def _pools_both(seed, name, nb):
    """The same starting pools for both packages: (jax tuple, torch
    tuple), each (k, v[, k_scale, v_scale])."""
    if name in SCALED:
        k, ks = _scaled_pool(seed, name, nb)
        v, vs = _scaled_pool(seed + 1, name, nb)
        arrs = (k, v, ks, vs)
    else:
        rng = np.random.default_rng(seed)
        arrs = tuple(_store_np(name, rng.standard_normal(
            (nb * BS, H, D)).astype(np.float32)) for _ in range(2))
    return (tuple(jnp.asarray(a) for a in arrs),
            tuple(_to_torch(a) for a in arrs))


def _split(name, pools):
    """(k, v, kv kwargs) for either package's entry points."""
    if name not in SCALED:
        return pools[0], pools[1], {}
    pol = (tkq if isinstance(pools[0], torch.Tensor) else jkq).make_policy(
        name)
    return pools[0], pools[1], dict(kv_scales=tuple(pools[2:]), policy=pol)


def _assert_pools_close(name, jp, tp, bs=None):
    """Every real block: under a scaled policy the dequantized pools
    agree within one quantization step (the block's scale: the
    projections in the two packages may differ by an ulp, and a value on
    a rounding edge then lands one step over); narrow passthrough pools
    within one step of their type."""
    if name in SCALED:
        for (cj, sj), (ct, st) in (((jp[0], jp[2]), (tp[0], tp[2])),
                                   ((jp[1], jp[3]), (tp[1], tp[3]))):
            nb = st.shape[0]
            shape = (nb, ct.shape[0] // nb, *ct.shape[1:])
            sj, st = np.asarray(sj)[1:], st.numpy()[1:]
            np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-9)
            step = np.maximum(st, sj)[:, None, :, None]
            dj = _f32(cj).reshape(shape)[1:] * sj[:, None, :, None]
            dt = _f32(ct).reshape(shape)[1:] * st[:, None, :, None]
            assert (np.abs(dt - dj) <= step * 1.0001 + 1e-7).all()
        return
    rel = {"f32": 1e-6, "bf16": 2.0 ** -7, "fp8": 2.0 ** -3}[name]
    bs = bs or BS
    for cj, ct in zip(jp[:2], tp[:2]):
        np.testing.assert_allclose(_f32(ct)[bs:], _f32(cj)[bs:], rtol=rel,
                                   atol=1e-6)


@pytest.mark.parametrize("name", POLICIES)
def test_prefill_twice_matches_jax_xla(mha_params, name):
    """Two prefill chunks of one row through the same bucket width: the
    second starts at an unaligned offset over the prefix the first
    wrote, with pad columns past its tail."""
    jparams, tparams = mha_params
    nb = 1 + M
    row = np.arange(1, nb, dtype=np.int32)[::-1].copy()
    jp, tp = _pools_both(10, name, nb)
    rng = np.random.default_rng(11)
    P = 8
    for start, tail in ((0, 6), (6, 5)):
        x = rng.standard_normal((1, P, H * D)).astype(np.float32)
        pos = start + np.arange(P, dtype=np.int32)
        kj, vj, jkw = _split(name, jp)
        yj, *jp = jattn.mha_prefill_paged(
            jparams, jnp.asarray(x), kj, vj, jnp.asarray(pos),
            jnp.int32(tail), num_heads=H, block_tables=jnp.asarray(row),
            block_size=BS, attn_kernel="xla", **jkw)
        kt, vt, tkw = _split(name, tp)
        yt, *tp = tattn.mha_prefill_paged(
            tparams, _to_torch(x), kt, vt, _to_torch(pos), tail,
            num_heads=H, block_tables=_to_torch(row), block_size=BS, **tkw)
        assert len(tp) == len(jp) == (4 if name in SCALED else 2)
        np.testing.assert_allclose(yt.numpy()[:, :tail],
                                   np.asarray(yj)[:, :tail], **TOL)
        _assert_pools_close(name, jp, tp)


@pytest.mark.parametrize("name", POLICIES)
def test_decode_twice_matches_jax_xla(mha_params, name):
    jparams, tparams = mha_params
    S = 3
    rng = np.random.default_rng(12)
    tables = _tables(rng, S, dead=(2,))
    jp, tp = _pools_both(13, name, 1 + S * M)
    pos = np.asarray([7, 12, 0], np.int32)
    for step in range(2):
        x = rng.standard_normal((S, 1, H * D)).astype(np.float32)
        kj, vj, jkw = _split(name, jp)
        yj, *jp = jattn.mha_decode(
            jparams, jnp.asarray(x), kj, vj, jnp.asarray(pos), num_heads=H,
            block_tables=jnp.asarray(tables), block_size=BS, **jkw)
        kt, vt, tkw = _split(name, tp)
        yt, *tp = tattn.mha_decode(
            tparams, _to_torch(x), kt, vt, _to_torch(pos), num_heads=H,
            block_tables=_to_torch(tables), block_size=BS, **tkw)
        np.testing.assert_allclose(yt.numpy()[:2], np.asarray(yj)[:2], **TOL)
        _assert_pools_close(name, jp, tp)
        pos = pos + np.asarray([1, 1, 0], np.int32)


@pytest.mark.parametrize("name", POLICIES)
def test_verify_twice_matches_jax_xla(mha_params, name):
    """Every row scores a run of P = 4 (3 drafts + 1) at its own start;
    row 2 is dead (tail 0); the second call continues each row after
    the tokens the first one kept."""
    jparams, tparams = mha_params
    S, P = 3, 4
    rng = np.random.default_rng(14)
    tables = _tables(rng, S, dead=(2,))
    jp, tp = _pools_both(15, name, 1 + S * M)
    starts = np.asarray([0, 6, 0], np.int32)
    tails = np.asarray([4, 3, 0], np.int32)
    for step in range(2):
        x = rng.standard_normal((S, P, H * D)).astype(np.float32)
        positions = starts[:, None] + np.arange(P, dtype=np.int32)[None, :]
        kj, vj, jkw = _split(name, jp)
        yj, *jp = jattn.mha_verify_paged(
            jparams, jnp.asarray(x), kj, vj, jnp.asarray(positions),
            jnp.asarray(tails), num_heads=H,
            block_tables=jnp.asarray(tables), block_size=BS,
            attn_kernel="xla", **jkw)
        kt, vt, tkw = _split(name, tp)
        yt, *tp = tattn.mha_verify_paged(
            tparams, _to_torch(x), kt, vt, _to_torch(positions),
            _to_torch(tails), num_heads=H, block_tables=_to_torch(tables),
            block_size=BS, **tkw)
        for s in range(S):
            np.testing.assert_allclose(yt.numpy()[s, :tails[s]],
                                       np.asarray(yj)[s, :tails[s]], **TOL)
        _assert_pools_close(name, jp, tp)
        starts = starts + tails
        tails = np.asarray([2, 4, 0], np.int32)


# ---------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------

N_LAYER = 2
JCFG = JaxGPT2Config.tiny(n_layer=N_LAYER)
CFG = GPT2Config.tiny(n_layer=N_LAYER)


@pytest.fixture(scope="module")
def params():
    jp = jax_gpt2_init(jax.random.key(0), JCFG)
    return jp, gpt2_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _engines(params, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("max_seq_len", 40)
    jp, tp = params
    return (JaxServeEngine(jax_gpt2_family(JCFG), jp, attn_kernel="xla",
                           **kw),
            ServeEngine(gpt2_family(CFG), tp, device="cpu", **kw))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
            for n in lengths]


def _drive(engines, script, after_step=None):
    """Run a request script on every engine in lockstep: entries
    ``(arrival_step, prompt, max_new)`` or ``("after", i, tail,
    max_new)`` — submitted once request ``i`` has finished, with its
    output minus the last token (whose KV was never written) plus
    ``tail`` as the prompt, so admission hits the chain request i
    published and copies its partial block on write. ``after_step()``
    runs after every step. Returns each engine's outputs in script
    order."""
    rids = [{} for _ in engines]
    step = 0
    while (len(rids[0]) < len(script)
           or any(e.has_work for e in engines)):
        for eng, ids in zip(engines, rids):
            for i, entry in enumerate(script):
                if i in ids:
                    continue
                if entry[0] == "after":
                    _, j, tail, max_new = entry
                    if j in ids and eng.request(ids[j]).state == "finished":
                        prompt = np.concatenate([eng.result(ids[j])[:-1],
                                                 tail])
                        ids[i] = eng.submit(prompt, max_new)
                elif entry[0] <= step:
                    ids[i] = eng.submit(entry[1], entry[2])
            eng.step()
        if after_step is not None:
            after_step()
        step += 1
        assert step < 500, "engine failed to drain"
    return [[eng.result(ids[i]) for i in range(len(script))]
            for eng, ids in zip(engines, rids)]


def _script(kind):
    if kind == "default":
        return [(0, p, 8) for p in _prompts(0, (5, 9, 3, 12, 7))], {}
    # staggered; request 3 shares request 0's first two blocks (a prefix
    # hit), request 5 continues request 1 (copy on write), request 6
    # continues request 5; 16 blocks under 3 slots force preemption
    p = _prompts(1, (8, 9, 6, 3, 10))
    tail = _prompts(2, (3, 2))
    return ([(0, p[0], 10), (0, p[1], 10), (1, p[2], 10),
             (2, np.concatenate([p[0][:8], p[3]]), 8), (3, p[4], 9),
             ("after", 1, tail[0], 8), ("after", 5, tail[1], 6)],
            dict(max_slots=3, num_blocks=16))


@pytest.mark.parametrize("kind", ("default", "cow_preempt"))
@pytest.mark.parametrize("name", ("int8", "fake_quant", "fp8", "bf16"))
def test_engine_streams_identical_to_jax(params, name, kind):
    script, kw = _script(kind)
    je, te = _engines(params, kv_dtype=name, **kw)
    cows = []
    prefill = te._prefill

    def spy(ids, start, t0, table_row, cow_src, cow_len):
        cows.append(cow_len)
        return prefill(ids, start, t0, table_row, cow_src, cow_len)

    te._prefill = spy

    def pools_agree():
        # the same blocks in both engines hold the same KV after every
        # step (a copy on write without the source's scales would not)
        for layer in range(N_LAYER):
            _assert_pools_close(name,
                                tuple(a[layer] for a in je.pool.caches()),
                                tuple(t[layer] for t in te.pool.caches()),
                                bs=te.pool.block_size)

    want, got = _drive([je, te], script, after_step=pools_agree)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert te.pool.pool_bytes == je.pool.pool_bytes
    if kind == "cow_preempt":
        m = te.metrics
        assert m.preempted >= 1 and m.prefix_hit_tokens >= 8
        assert any(c > 0 for c in cows), "no copy-on-write admission"
        assert (m.preempted, m.prefix_hit_tokens) == (
            je.metrics.preempted, je.metrics.prefix_hit_tokens)


def test_fake_quant_streams_identical_to_f32(params):
    script, kw = _script("cow_preempt")
    outs = {}
    for name in ("f32", "fake_quant"):
        _, te = _engines(params, kv_dtype=name, **kw)
        outs[name] = _drive([te], script)[0]
    for a, b in zip(outs["f32"], outs["fake_quant"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", POLICIES)
def test_paged_eval_nll_matches_jax(params, name):
    jparams, tparams = params
    rows = np.random.default_rng(16).integers(
        0, CFG.vocab_size, (4, 24)).astype(np.int32)
    kw = dict(n_layers=N_LAYER, n_kv_heads=CFG.n_head,
              head_dim=CFG.n_embd // CFG.n_head, block_size=4,
              num_blocks=32, policy=name)
    tpool = KVPool(**kw, device="cpu")
    want = jkq.paged_eval_nll(jax_gpt2_family(JCFG), jparams,
                              JaxKVPool(**kw), rows)
    got = tkq.paged_eval_nll(gpt2_family(CFG), tparams, tpool, rows)
    assert abs(got - want) <= 1e-5
    assert tpool.num_free == tpool.usable_blocks     # blocks released
    if name == "fake_quant":
        assert got == tkq.paged_eval_nll(
            gpt2_family(CFG), tparams, KVPool(**{**kw, "policy": "f32"},
                                              device="cpu"), rows)
