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

from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
from quintnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                    paged_attention_ref)
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
