"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card (the
kernels have no CPU mode). This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from quintnet_tpu_torch.core.pytree import tree_map
from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                            gpt2_model_spec)
from quintnet_tpu_torch.nn.attention import sdpa
from quintnet_tpu_torch.ops.flash_kernels import (FlashAttentionFunction,
                                                  flash_bwd_dkv,
                                                  flash_bwd_dkv_ref,
                                                  flash_bwd_dq,
                                                  flash_bwd_dq_ref,
                                                  flash_delta, flash_fwd,
                                                  flash_fwd_ref)
from quintnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                    paged_attention_ref)
from quintnet_tpu_torch.parallel.train_step import accumulate_grads
from quintnet_tpu_torch.serve import ServeEngine, generate, gpt2_family

BS, M = 16, 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "the CPU tests hold its plain version to the JAX "
                    "package")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, S, Hq, Hkv, P, D, starts, dead=()):
    rng = np.random.default_rng(seed)
    nb = 1 + S * M
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.zeros((S, M), np.int32)
    for s in range(S):
        if s not in dead:
            tables[s] = perm[s * M:(s + 1) * M]
    arrs = (rng.standard_normal((S, Hq, P, D)).astype(np.float32),
            rng.standard_normal((nb * BS, Hkv, D)).astype(np.float32),
            rng.standard_normal((nb * BS, Hkv, D)).astype(np.float32),
            tables, np.asarray(starts, np.int32))
    return [torch.from_numpy(a).cuda() for a in arrs]


CASES = {
    "decode_dead_row": dict(S=4, Hq=4, Hkv=4, P=1, D=64,
                            starts=[127, 40, 3, 0], dead=(3,)),
    "prefill_offset_past_table": dict(S=1, Hq=2, Hkv=2, P=40, D=64,
                                      starts=[101]),
    "prefill_tiles": dict(S=1, Hq=2, Hkv=2, P=37, D=32, starts=[16]),
    "gqa_d128": dict(S=2, Hq=8, Hkv=2, P=3, D=128, starts=[60, 5]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda_device, name):
    args = _case(0, **CASES[name])
    before = paged_attention.launches
    got = paged_attention(*args, block_size=BS)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_ref(*args, block_size=BS)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v, tables, starts = _case(1, **CASES["decode_dead_row"])
    with pytest.raises(TypeError, match="float32"):
        paged_attention(q.half(), k, v, tables, starts, block_size=BS)
    with pytest.raises(TypeError, match="int32"):
        paged_attention(q, k, v, tables.long(), starts, block_size=BS)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q.transpose(0, 1), k, v, tables, starts,
                        block_size=BS)
    with pytest.raises(ValueError, match="block_size"):
        paged_attention(q, k, v, tables, starts, block_size=5)


@pytest.mark.cuda
def test_engine_on_card_matches_engine_on_cpu(cuda_device):
    """Tiny GPT-2: the same weights served on the card (kernel) and on
    the CPU (plain version) give the same greedy tokens, and every
    prefill and decode layer launched the kernel."""
    cfg = GPT2Config.tiny(n_layer=2)
    params = gpt2_init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 9)]
    kw = dict(max_slots=2, block_size=4, num_blocks=24, max_seq_len=40)
    cpu = ServeEngine(gpt2_family(cfg), params, device="cpu", **kw)
    card = ServeEngine(gpt2_family(cfg), params, device="cuda", **kw)
    want = generate(cpu, prompts, max_new_tokens=8)
    paged_attention.launches = 0
    got = generate(card, prompts, max_new_tokens=8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    m = card.metrics
    assert paged_attention.launches == cfg.n_layer * (m.decode_steps
                                                      + m.admitted)


# ---------------------------------------------------------------------
# flash attention (K1-K3)
# ---------------------------------------------------------------------

FLASH_CASES = {
    "causal_ragged_d64": dict(B=2, H=3, S=200, D=64, causal=True, seg=False),
    "noncausal_seg_d32": dict(B=2, H=2, S=130, D=32, causal=False, seg=True),
    "causal_seg_d128": dict(B=1, H=2, S=192, D=128, causal=True, seg=True),
    "single_row": dict(B=2, H=2, S=1, D=64, causal=True, seg=False),
    "noncausal_d128_ragged": dict(B=1, H=1, S=257, D=128, causal=False,
                                  seg=False),
}


def _flash_case(seed, B, H, S, D, causal, seg):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, H, S, D)).astype(np.float32)).cuda() for _ in range(4))
    ids = None
    if seg:
        # monotone packed documents, plus one row of shuffled ids (range
        # pruning keeps tiles live whose entries are all masked)
        cuts = np.sort(rng.integers(0, S, (B, 3)), axis=1)
        ids = (np.arange(S)[None, :, None] >= cuts[:, None, :]).sum(-1)
        ids[-1] = rng.permutation(ids[-1])
        ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    return q, k, v, do, ids


def _rel_err(got, want):
    """Max error over the reference's largest magnitude, floored at 0.01
    (with one query row dq is exactly 0: p = 1 and do.v = delta)."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernels_match_plain_versions(cuda_device, name):
    c = FLASH_CASES[name]
    q, k, v, do, seg = _flash_case(3, **c)
    causal = c["causal"]
    n = (flash_fwd.launches, flash_bwd_dkv.launches, flash_bwd_dq.launches)
    o, lse = flash_fwd(q, k, v, seg, causal=causal)
    delta = flash_delta(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, seg, causal=causal)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, seg, causal=causal)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_bwd_dkv.launches,
            flash_bwd_dq.launches) == tuple(x + 1 for x in n)
    o_r, lse_r = flash_fwd_ref(q, k, v, seg, causal=causal)
    dk_r, dv_r = flash_bwd_dkv_ref(q, k, v, do, lse_r, delta, seg,
                                   causal=causal)
    dq_r = flash_bwd_dq_ref(q, k, v, do, lse_r, delta, seg, causal=causal)
    for got, want in ((o, o_r), (lse, lse_r), (dq, dq_r), (dk, dk_r),
                      (dv, dv_r)):
        assert torch.isfinite(got).all()
        assert _rel_err(got, want) <= 1e-4


@pytest.mark.cuda
def test_flash_function_gradients_match_plain_attention(cuda_device):
    q, k, v, do, seg = _flash_case(4, B=2, H=2, S=150, D=64, causal=True,
                                   seg=True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = FlashAttentionFunction.apply(*leaves, seg, True)
    o_ref = sdpa(*ref, causal=True, segment_ids=seg)
    got = torch.autograd.grad(o, leaves, do)
    want = torch.autograd.grad(o_ref, ref, do)
    assert _rel_err(o, o_ref) <= 1e-4
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= 1e-4


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    q, k, v, do, _ = _flash_case(5, B=1, H=1, S=8, D=64, causal=True,
                                 seg=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                  v[..., :48].contiguous(), causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q.transpose(2, 3), k, v, causal=True)
    with pytest.raises(TypeError, match="int32"):
        flash_fwd(q, k, v, torch.zeros((1, 8), dtype=torch.int64,
                                       device="cuda"), causal=True)
    wide = q.expand(1, 65536, 8, 64).contiguous()
    with pytest.raises(ValueError, match="65535"):
        flash_fwd(wide, wide, wide, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,remat", [(4, False), (2, True)])
def test_tiny_training_step_on_card_matches_cpu(cuda_device, heads, remat):
    """Loss and every gradient of a 2-micro-batch step of a small GPT-2
    (D = 128 / heads, packed segments) with the flash kernels on the card
    against the plain versions on the CPU; every layer of every
    micro-batch launched each kernel (the forward twice under remat)."""
    cfg = GPT2Config.tiny(n_embd=128, n_head=heads, n_layer=2,
                          segment_eos_id=7)
    spec = gpt2_model_spec(cfg, use_flash=True, remat=remat)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, (4, 48))
    ids[:, [9, 30]] = 7
    labels = ids.copy()
    labels[:, :5] = -100
    params = gpt2_init(torch.Generator().manual_seed(1), cfg)

    def run(device):
        p = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        batch = tuple(torch.from_numpy(a).to(device) for a in (ids, labels))
        return accumulate_grads(spec.loss_fn, p, batch, 2)

    loss_cpu, grads_cpu = run("cpu")
    for fn in (flash_fwd, flash_bwd_dkv, flash_bwd_dq):
        fn.launches = 0
    loss, grads = run("cuda")
    torch.cuda.synchronize()
    n = cfg.n_layer * 2
    assert (flash_fwd.launches, flash_bwd_dkv.launches,
            flash_bwd_dq.launches) == (n * (2 if remat else 1), n, n)
    assert abs(float(loss) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    for path, g in grads_cpu.items():
        assert _rel_err(grads[path].cpu(), g) <= 1e-4, path
