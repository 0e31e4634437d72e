"""The port's flash attention (quintnet_tpu_torch/ops/flash_kernels.py,
ops/flash_attention.py) against the JAX package, on the CPU.

The plain versions of the three kernels are held to the JAX Pallas
kernels run in interpret mode (``_flash_fwd`` / ``_flash_bwd``), the
blockwise twin to the JAX ``blockwise_attention``, and the autograd
Function to autograd through the port's plain ``sdpa``. Inputs are numpy
arrays from a seed. Tolerances: ``atol=1e-5`` on f32 values of order 1
(the sums run in another order); gradients ``atol=1e-5, rtol=1e-4``.

In bf16 (inputs rounded to bf16 once, the same values for both
packages) the plain versions round p and ds where the Pallas kernels
cast them. Gate: max |err| <= 2^-7 x max |ref| on o, dq, dk and dv (one
bf16 ulp of the largest magnitude: the outputs are rounded once on
each side), lse <= 1e-5 absolute. Measured (seeds below): dq, dk and dv
equal the Pallas kernels' (0, and 8.5e-10 on dk non-causal); o 1.2e-3
to 4.8e-3 with the JAX kernel's 32-key tiles (p is rounded against the
running max, which depends on the tile), 0 with its 64-key tiles, which
are the plain version's; lse 4.8e-7.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from quintnet_tpu.ops.flash_attention import \
    blockwise_attention as jax_blockwise
from quintnet_tpu.ops.pallas_attention import _flash_bwd, _flash_fwd
from quintnet_tpu_torch.nn.attention import sdpa
from quintnet_tpu_torch.nn.layers import dropout
from quintnet_tpu_torch.ops import flash_attention as fa
from quintnet_tpu_torch.ops.flash_kernels import (FlashAttentionFunction,
                                                  flash_bwd_dkv,
                                                  flash_bwd_dkv_ref,
                                                  flash_bwd_dq_ref,
                                                  flash_delta, flash_fwd,
                                                  flash_fwd_ref)

torch.set_num_threads(1)

SHAPE = (2, 2, 64, 16)


def _inputs(seed, shape=SHAPE, segments=False):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    seg = None
    if segments:
        B, _, S, _ = shape
        cuts = np.sort(rng.integers(1, S, (B, 3)), axis=1)
        seg = (np.arange(S)[None, :, None] >= cuts[:, None, :]).sum(
            -1).astype(np.int32)
    return q, k, v, do, seg


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# causal, non-causal, segments, and rectangular 32 x 64 JAX blocks at
# SHAPE; and the kernels' head dims 32, 64 and 128 at S = 96 and 160,
# which the bf16 forward's key tile (FWD_KEY_TILE_BF16 = 64) leaves
# ragged (the Pallas blocks divide S)
KERNEL_CASES = {
    "causal": dict(causal=True, segments=False, blocks=(32, 32)),
    "noncausal": dict(causal=False, segments=False, blocks=(32, 32)),
    "causal_segments": dict(causal=True, segments=True, blocks=(32, 32)),
    "rect_blocks_32x64": dict(causal=True, segments=False, blocks=(32, 64)),
    "d32_ragged_s96": dict(causal=True, segments=False, blocks=(32, 32),
                           shape=(1, 2, 96, 32)),
    "d64_noncausal_segments_s160": dict(causal=False, segments=True,
                                        blocks=(32, 32),
                                        shape=(1, 2, 160, 64)),
    "d128_ragged_segments_s96": dict(causal=True, segments=True,
                                     blocks=(32, 32), shape=(1, 1, 96, 128)),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_forward_plain_version_matches_pallas_kernel(name):
    c = KERNEL_CASES[name]
    q, k, v, _, seg = _inputs(0, c.get("shape", SHAPE), c["segments"])
    o_j, lse_j = _flash_fwd(_j(q), _j(k), _j(v), _j(seg), c["causal"],
                            *c["blocks"], True)
    o, lse = flash_fwd_ref(_t(q), _t(k), _t(v), _t(seg), causal=c["causal"])
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_backward_plain_versions_match_pallas_kernels(name):
    c = KERNEL_CASES[name]
    q, k, v, do, seg = _inputs(1, c.get("shape", SHAPE), c["segments"])
    o_j, lse_j = _flash_fwd(_j(q), _j(k), _j(v), _j(seg), c["causal"],
                            *c["blocks"], True)
    dq_j, dk_j, dv_j = _flash_bwd(_j(q), _j(k), _j(v), _j(seg), o_j, lse_j,
                                  _j(do), c["causal"], *c["blocks"], True)
    o = torch.from_numpy(np.array(o_j))
    lse = torch.from_numpy(np.array(lse_j)[..., 0])
    args = (_t(q), _t(k), _t(v), _t(do), lse, flash_delta(o, _t(do)),
            _t(seg))
    dk, dv = flash_bwd_dkv_ref(*args, causal=c["causal"])
    dq = flash_bwd_dq_ref(*args, causal=c["causal"])
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-4)


BF16_TOL = 2.0 ** -7    # x max |ref|: one bf16 ulp of the largest value


def _bf16(arrs):
    """f32 arrays rounded to bf16 once: the torch tensors and the JAX
    arrays of the same values."""
    ts = [None if a is None else torch.from_numpy(a).bfloat16()
          for a in arrs]
    js = [None if t is None else
          jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))
          for t in ts]
    return ts, js


def _assert_bf16_close(got, want, name):
    want = torch.from_numpy(np.asarray(want, dtype=np.float32))
    assert got.dtype == torch.bfloat16, name
    err = float((got.float() - want).abs().max())
    assert err <= BF16_TOL * float(want.abs().max()), (name, err)


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_bf16_forward_plain_version_matches_pallas_kernel(name):
    """bf16 q, k, v: o within one bf16 ulp of the largest value, lse
    (f32 in both) within 1e-5."""
    c = KERNEL_CASES[name]
    q, k, v, _, seg = _inputs(0, c.get("shape", SHAPE), c["segments"])
    (tq, tk, tv), (jq, jk, jv) = _bf16((q, k, v))
    o_j, lse_j = _flash_fwd(jq, jk, jv, _j(seg), c["causal"], *c["blocks"],
                            True)
    o, lse = flash_fwd_ref(tq, tk, tv, _t(seg), causal=c["causal"])
    assert lse.dtype == torch.float32
    _assert_bf16_close(o, o_j, "o")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_bf16_backward_plain_versions_match_pallas_kernels(name):
    """bf16 q, k, v, dO and the Pallas forward's o and lse: dq, dk, dv
    in bf16 within one bf16 ulp of the largest value."""
    c = KERNEL_CASES[name]
    q, k, v, do, seg = _inputs(1, c.get("shape", SHAPE), c["segments"])
    (tq, tk, tv, tdo), (jq, jk, jv, jdo) = _bf16((q, k, v, do))
    o_j, lse_j = _flash_fwd(jq, jk, jv, _j(seg), c["causal"], *c["blocks"],
                            True)
    dq_j, dk_j, dv_j = _flash_bwd(jq, jk, jv, _j(seg), o_j, lse_j, jdo,
                                  c["causal"], *c["blocks"], True)
    o = torch.from_numpy(np.asarray(o_j, dtype=np.float32)).bfloat16()
    lse = torch.from_numpy(np.array(lse_j)[..., 0])
    args = (tq, tk, tv, tdo, lse, flash_delta(o, tdo), _t(seg))
    dk, dv = flash_bwd_dkv_ref(*args, causal=c["causal"])
    dq = flash_bwd_dq_ref(*args, causal=c["causal"])
    for nm, got, want in (("dq", dq, dq_j), ("dk", dk, dk_j),
                          ("dv", dv, dv_j)):
        _assert_bf16_close(got, want, nm)


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_matches_jax_blockwise_ragged(causal, segments):
    q, k, v, _, seg = _inputs(2, shape=(2, 2, 50, 16), segments=segments)
    want = jax_blockwise(_j(q), _j(k), _j(v), causal=causal, block_q=16,
                         block_k=16, segment_ids=_j(seg))
    got = fa.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                 block_k=16, segment_ids=_t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_match_autograd_through_sdpa(causal, segments):
    q, k, v, do, seg = _inputs(3, shape=(2, 3, 37, 16), segments=segments)
    seg_t = _t(seg)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ref = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (q, k, v)]
    o = FlashAttentionFunction.apply(*leaves, seg_t, causal)
    o_ref = sdpa(*ref, causal=causal, segment_ids=seg_t)
    np.testing.assert_allclose(o.detach().numpy(), o_ref.detach().numpy(),
                               atol=1e-5)
    got = torch.autograd.grad(o, leaves, _t(do))
    want = torch.autograd.grad(o_ref, ref, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_wrappers_run_the_plain_version_on_cpu_and_launch_nothing():
    q, k, v, do, _ = map(_t, _inputs(4))
    before = flash_fwd.launches, flash_bwd_dkv.launches
    o, lse = flash_fwd(q, k, v, causal=True)
    o_r, lse_r = flash_fwd_ref(q, k, v, causal=True)
    assert torch.equal(o, o_r) and torch.equal(lse, lse_r)
    flash_bwd_dkv(q, k, v, do, lse, flash_delta(o, do), causal=True)
    assert (flash_fwd.launches, flash_bwd_dkv.launches) == before


def test_dispatcher_sends_attention_dropout_to_blockwise(monkeypatch):
    q, k, v, _, _ = map(_t, _inputs(5))
    calls = []

    def no_kernel(*a, **kw):
        raise AssertionError("the flash Function ran under dropout")

    real = fa.blockwise_attention
    monkeypatch.setattr(fa.FlashAttentionFunction, "apply", no_kernel)
    monkeypatch.setattr(fa, "blockwise_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    gen = torch.Generator().manual_seed(0)
    fa.flash_attention(q, k, v, causal=True, pdrop=0.1, generator=gen)
    assert len(calls) == 1 and calls[0]["pdrop"] == 0.1
    # no generator (eval) or rate 0: the kernels' path
    monkeypatch.undo()
    before = flash_fwd.launches
    for kw in (dict(pdrop=0.1), dict(pdrop=0.0, generator=gen)):
        out = fa.flash_attention(q, k, v, causal=True, **kw)
        np.testing.assert_allclose(out.numpy(), sdpa(q, k, v, causal=True)
                                   .numpy(), atol=1e-5)
    assert flash_fwd.launches == before


def test_blockwise_dropout_is_dropout_after_softmax():
    """Two key blocks: the output is dropout(softmax(s)) @ v with the
    blocks' masks side by side — the normaliser sums the undropped
    probabilities."""
    q, k, v, _, seg = _inputs(6, shape=(1, 2, 24, 8), segments=True)
    q, k, v, seg = map(_t, (q, k, v, seg))
    pdrop, bk = 0.3, 16
    got = fa.blockwise_attention(q, k, v, causal=True, block_k=bk,
                                 pdrop=pdrop, segment_ids=seg,
                                 generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    masks = [torch.rand((1, 2, 24, w), generator=gen) < 1 - pdrop
             for w in (bk, 24 - bk)]
    keep = torch.cat(masks, dim=-1)
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(8)
    vis = fa.visible_pairs(24, True, seg, q.device)
    probs = torch.softmax(scores.masked_fill(~vis, -torch.inf), dim=-1)
    want = torch.einsum("bhst,bhtd->bhsd",
                        torch.where(keep, probs / (1 - pdrop), 0.0), v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_dropout_keep_rate_and_scaling():
    x = torch.ones(20000)
    gen = torch.Generator().manual_seed(0)
    y = dropout(gen, x, 0.3, deterministic=False)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.7, rtol=1e-6)
    assert dropout(gen, x, 0.0, deterministic=False) is x
    assert dropout(gen, x, 0.3, deterministic=True) is x


# ---------------------------------------------------------------------
# the backward kernels' arithmetic (3xTF32), emulated on the CPU
# ---------------------------------------------------------------------

def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: half of the 13 dropped bits is
    added to the magnitude, then they are cleared."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, terms):
    """a @ b with TF32 operands and the products summed in f64: one product
    of the rounded operands (``terms=1``, plain TF32), or three (big x big +
    big x small + small x big with big = tf32(x), small = tf32(x - big):
    3xTF32, the backward kernels' scheme)."""
    ab, bb = _tf32(a), _tf32(b)
    out = ab.double() @ bb.double()
    if terms == 3:
        out = (out + ab.double() @ _tf32(b - bb).double()
               + _tf32(a - ab).double() @ bb.double())
    return out.float()


def _backward_in_tf32(q, k, v, do, lse, delta, terms):
    """``_probs_and_dscores`` and the three gradient products (causal, no
    segments) with every product through ``_tf32_matmul``."""
    S, D = q.shape[-2:]
    scale = 1.0 / np.sqrt(D)
    mm = lambda a, b: _tf32_matmul(a, b, terms)  # noqa: E731
    s = mm(q, k.transpose(-1, -2)) * scale
    vis = fa.visible_pairs(S, True, None, q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None]) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), do))


def _tf32_case():
    q, k, v, do = map(_t, _inputs(8, shape=(1, 2, 512, 64))[:4])
    o, lse = flash_fwd_ref(q, k, v, causal=True)
    args = (q, k, v, do, lse, flash_delta(o, do))
    want = (flash_bwd_dq_ref(*args, causal=True),
            *flash_bwd_dkv_ref(*args, causal=True))
    return args, want


def _rel_to_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_3xtf32_backward_stays_at_f32_accuracy():
    """dq, dk, dv with every product in 3xTF32 (B=1, H=2, S=512, D=64,
    causal) within 1e-5 of the f32 plain versions, relative to the
    largest magnitude."""
    args, want = _tf32_case()
    got = _backward_in_tf32(*args, terms=3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_to_max(g, w) <= 1e-5, name


def test_plain_tf32_backward_misses_the_kernel_gate():
    """The same with plain TF32 products: off by more than the card gate of
    1e-4 in each gradient, which is why the kernels split each operand."""
    args, want = _tf32_case()
    got = _backward_in_tf32(*args, terms=1)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_to_max(g, w) > 1e-4, name


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2),
                      1 + ulp * 0.75, 3.14159265], dtype=torch.float32)
    want = [1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + ulp, 3.140625]
    assert _tf32(x).tolist() == want


def _forward_in_tf32(q, k, v, terms):
    """The forward (causal, no segments) with both products through
    ``_tf32_matmul``: s = q k^T, p = exp(s - rowmax), o = p v / rowsum(p),
    lse = rowmax + log rowsum(p)."""
    S, D = q.shape[-2:]
    vis = fa.visible_pairs(S, True, None, q.device)
    s = _tf32_matmul(q, k.transpose(-1, -2), terms) / np.sqrt(D)
    s = torch.where(vis, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    return _tf32_matmul(p, v, terms) / l[..., None], m + torch.log(l)


def _tf32_forward_case():
    q, k, v = map(_t, _inputs(9, shape=(1, 2, 512, 64))[:3])
    return (q, k, v), flash_fwd_ref(q, k, v, causal=True)


def test_3xtf32_forward_stays_at_f32_accuracy():
    """o and lse with both forward products in 3xTF32 (B=1, H=2, S=512,
    D=64, causal) within 1e-5 of the f32 plain version, relative to the
    largest magnitude."""
    args, (o_r, lse_r) = _tf32_forward_case()
    o, lse = _forward_in_tf32(*args, terms=3)
    assert _rel_to_max(o, o_r) <= 1e-5
    assert _rel_to_max(lse, lse_r) <= 1e-5


def test_plain_tf32_forward_misses_the_kernel_gate():
    """The same with plain TF32 products: o off by more than the card gate
    of 1e-4, which is why the forward kernel splits each operand too."""
    args, (o_r, _) = _tf32_forward_case()
    o, _ = _forward_in_tf32(*args, terms=1)
    assert _rel_to_max(o, o_r) > 1e-4


# ---------------------------------------------------------------------
# the dispatcher's rule for calls the kernels cannot take
# ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype,takes", [
    ((2, 4, 48, 64), torch.float32, True),
    ((2, 4, 48, 32), torch.float32, True),
    ((2, 4, 48, 128), torch.float32, True),
    ((2, 4, 48, 8), torch.float32, False),        # tiny GPT-2's head dim
    ((2, 4, 48, 48), torch.float32, False),
    ((2, 4, 48, 64), torch.bfloat16, True),
    ((2, 4, 48, 64), torch.float16, False),
    ((1, 65535, 8, 64), torch.float32, True),     # the grid's y limit
    ((1, 65536, 8, 64), torch.float32, False),
    ((256, 256, 8, 64), torch.float32, False),
    ((2, 4, 48, 8), torch.bfloat16, False),
    ((2, 4, 48, 128), torch.bfloat16, True),
])
def test_routing_predicate(shape, dtype, takes):
    """One rule on shape and dtype, read by the dispatcher and by the
    wrappers' checks: large shapes as meta tensors (no memory)."""
    from quintnet_tpu_torch.ops.flash_kernels import (kernel_domain_error,
                                                      kernels_take)
    q = torch.empty(shape, dtype=dtype, device="meta")
    assert kernels_take(q) is takes
    assert (kernel_domain_error(q.shape, q.dtype) is None) is takes


def _routing_spy(monkeypatch):
    """The dispatcher as it runs for CUDA tensors (its device test
    patched), with every blockwise call recorded."""
    calls = []
    real = fa.blockwise_attention
    monkeypatch.setattr(fa, "_on_card", lambda q: True)
    monkeypatch.setattr(fa, "blockwise_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("dtype,D", [(torch.float32, 8),
                                     (torch.float32, 48),
                                     (torch.float16, 32),
                                     (torch.bfloat16, 48)])
def test_dispatcher_routes_what_the_kernels_cannot_take(monkeypatch, dtype,
                                                        D, segments):
    """Outside the kernels' domain a card call goes to the blockwise
    attention (causality and segment ids carried), counted in
    ``routed``; no kernel wrapper runs, and the output and gradients are
    the plain attention's."""
    q, k, v, do, seg = _inputs(11, shape=(2, 2, 40, D), segments=segments)
    seg_t = _t(seg)
    calls = _routing_spy(monkeypatch)

    def no_kernel(*a, **kw):
        raise AssertionError("the flash Function ran outside its domain")

    monkeypatch.setattr(fa.FlashAttentionFunction, "apply", no_kernel)
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in (q, k, v)]
    ref = [t.detach().float().requires_grad_(True) for t in leaves]
    before = fa.flash_attention.routed
    out = fa.flash_attention(*leaves, causal=True, segment_ids=seg_t)
    assert fa.flash_attention.routed == before + 1
    assert len(calls) == 1 and calls[0]["causal"] is True
    assert calls[0]["segment_ids"] is seg_t
    assert out.dtype == dtype
    want = sdpa(*ref, causal=True, segment_ids=seg_t)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.detach().float().numpy(),
                               want.detach().numpy(), atol=tol)
    got = torch.autograd.grad(out, leaves, _t(do).to(dtype))
    exp = torch.autograd.grad(want, ref, _t(do))
    for g, w in zip(got, exp):
        np.testing.assert_allclose(g.float().numpy(), w.numpy(),
                                   atol=tol * 5)


@pytest.mark.parametrize("D", [32, 64])
def test_dispatcher_routes_nothing_inside_the_domain(monkeypatch, D):
    """Inside the domain a card call goes to the flash Function (here its
    plain versions, the tensors being on the CPU) and nothing is
    routed."""
    q, k, v, _, _ = map(_t, _inputs(12, shape=(2, 2, 40, D)))
    calls = _routing_spy(monkeypatch)
    before = fa.flash_attention.routed
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.routed == before and calls == []
    np.testing.assert_allclose(out.numpy(), sdpa(q, k, v, causal=True)
                               .numpy(), atol=1e-5)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_dispatcher_takes_bf16_inside_the_domain(monkeypatch, D):
    """bf16 is inside the domain: a card call goes to the flash Function
    (its plain versions here), nothing is routed, the output is bf16 and
    within one bf16 ulp of the largest value of f32 attention on the
    same bf16 values."""
    q, k, v = (_t(a).bfloat16() for a in
               _inputs(12, shape=(2, 2, 40, D))[:3])
    calls = _routing_spy(monkeypatch)
    before = fa.flash_attention.routed
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.routed == before and calls == []
    _assert_bf16_close(out, sdpa(q.float(), k.float(), v.float(),
                                 causal=True).numpy(), "o")


def test_cpu_calls_keep_the_plain_versions_outside_the_domain():
    """On CPU tensors the dispatcher takes the flash Function's plain
    versions for any head dim, as before: nothing is routed."""
    q, k, v, _, _ = map(_t, _inputs(13, shape=(2, 2, 40, 8)))
    before = fa.flash_attention.routed
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.flash_attention.routed == before
    o_r, _ = flash_fwd_ref(q, k, v, causal=True)
    assert torch.equal(out, o_r)


def test_bf16_forward_key_tile_is_one_constant():
    """The plain forward's default ``block_k`` is the bf16 K1 kernel's key
    tile: the constant the wrapper holds the built library to, and the
    one the kernel source compiles (``kFwdKeyTileBf16``), so that p is
    rounded against the same running max on both sides."""
    import inspect
    import re

    from quintnet_tpu_torch.ops import build, flash_kernels

    default = inspect.signature(flash_kernels.flash_fwd_ref).parameters[
        "block_k"].default
    assert default == flash_kernels.FWD_KEY_TILE_BF16
    src = (build.CSRC / "flash_attention.cu").read_text()
    (tile,) = re.findall(r"constexpr int kFwdKeyTileBf16 = (\d+);", src)
    assert int(tile) == flash_kernels.FWD_KEY_TILE_BF16
    assert "return kFwdKeyTileBf16;" in src


def test_library_with_another_key_tile_is_refused(monkeypatch):
    """A flash-attention library whose bf16 forward tiles keys otherwise
    than ``FWD_KEY_TILE_BF16`` is refused when it loads, before any
    launch."""
    from quintnet_tpu_torch.ops import build, flash_kernels

    class Entry:
        def __init__(self, ret=0):
            self.ret = ret

        def __call__(self, *args):
            return self.ret

    class FakeLibrary:
        pass

    lib = FakeLibrary()
    for dt in flash_kernels.KERNEL_DTYPES.values():
        for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            setattr(lib, f"{name}_{dt}", Entry())
    lib.flash_attention_error_string = Entry(b"")
    lib.flash_fwd_bf16_key_tile = Entry(2 * flash_kernels.FWD_KEY_TILE_BF16)
    monkeypatch.setattr(build, "load", lambda name: lib)
    with pytest.raises(RuntimeError, match="tiles keys by 128"):
        flash_kernels._lib()
    lib.flash_fwd_bf16_key_tile = Entry(flash_kernels.FWD_KEY_TILE_BF16)
    assert flash_kernels._lib() is lib


def test_library_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """Each library's name hashes its source and every ``csrc/*.cuh``
    header: editing a header changes both libraries' paths (so both
    rebuild), editing a source only its own. The port's own sources:
    the wgmma, TMA and mbarrier header that the bf16 K1, K2 and K3
    include rebuilds both libraries when it changes."""
    import shutil

    from quintnet_tpu_torch.ops import build

    real = tmp_path / "real"
    shutil.copytree(build.CSRC, real)
    assert '#include "wgmma_bf16.cuh"' in (
        real / "flash_attention.cu").read_text()
    monkeypatch.setattr(build, "CSRC", real)
    libs = ("flash_attention", "paged_attention")
    before = {n: build.library_path(n) for n in libs}
    with open(real / "wgmma_bf16.cuh", "a") as f:
        f.write("// edited\n")
    assert all(build.library_path(n) != before[n] for n in libs)

    for name in ("a", "b"):
        (tmp_path / f"{name}.cu").write_text(f'#include "h.cuh"\n// {name}\n')
    (tmp_path / "h.cuh").write_text("// shared\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in ("a", "b")}
    assert build.library_path("a") == before["a"]
    (tmp_path / "h.cuh").write_text("// shared, edited\n")
    after = {n: build.library_path(n) for n in ("a", "b")}
    assert all(after[n] != before[n] for n in ("a", "b"))
    (tmp_path / "g.cuh").write_text("// a new header\n")
    added = {n: build.library_path(n) for n in ("a", "b")}
    assert all(added[n] != after[n] for n in ("a", "b"))
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// a, edited\n')
    assert build.library_path("a") != added["a"]
    assert build.library_path("b") == added["b"]
