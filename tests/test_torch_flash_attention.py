"""The port's flash attention (quintnet_tpu_torch/ops/flash_kernels.py,
ops/flash_attention.py) against the JAX package, on the CPU.

The plain versions of the three kernels are held to the JAX Pallas
kernels run in interpret mode (``_flash_fwd`` / ``_flash_bwd``), the
blockwise twin to the JAX ``blockwise_attention``, and the autograd
Function to autograd through the port's plain ``sdpa``. Inputs are numpy
arrays from a seed. Tolerances: ``atol=1e-5`` on f32 values of order 1
(the sums run in another order); gradients ``atol=1e-5, rtol=1e-4``.
"""

import jax.numpy as jnp
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


# causal, non-causal, segments, and rectangular 32 x 64 JAX blocks
KERNEL_CASES = {
    "causal": dict(causal=True, segments=False, blocks=(32, 32)),
    "noncausal": dict(causal=False, segments=False, blocks=(32, 32)),
    "causal_segments": dict(causal=True, segments=True, blocks=(32, 32)),
    "rect_blocks_32x64": dict(causal=True, segments=False, blocks=(32, 64)),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_forward_plain_version_matches_pallas_kernel(name):
    c = KERNEL_CASES[name]
    q, k, v, _, seg = _inputs(0, segments=c["segments"])
    o_j, lse_j = _flash_fwd(_j(q), _j(k), _j(v), _j(seg), c["causal"],
                            *c["blocks"], True)
    o, lse = flash_fwd_ref(_t(q), _t(k), _t(v), _t(seg), causal=c["causal"])
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_backward_plain_versions_match_pallas_kernels(name):
    c = KERNEL_CASES[name]
    q, k, v, do, seg = _inputs(1, segments=c["segments"])
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
