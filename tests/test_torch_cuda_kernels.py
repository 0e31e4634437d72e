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
from quintnet_tpu_torch.ops.paged_attention import (
    kernel_path, kernel_variant, paged_attention, paged_attention_ref,
    paged_quant_window_update)
from quintnet_tpu_torch.parallel.train_step import accumulate_grads
from quintnet_tpu_torch.serve import ServeEngine, generate, gpt2_family
from quintnet_tpu_torch.serve.kv_quant import make_policy

BS, M = 16, 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); "
                    "the CPU tests hold its plain version to the JAX "
                    "package")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, S, Hq, Hkv, P, D, starts, dead=(), m=M):
    rng = np.random.default_rng(seed)
    nb = 1 + S * m
    perm = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.zeros((S, m), np.int32)
    for s in range(S):
        if s not in dead:
            tables[s] = perm[s * m:(s + 1) * m]
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


# the store layouts of the KV layout policies: (pool dtype, scaled)
LAYOUTS = {"bf16": (torch.bfloat16, False), "fp8": (torch.float8_e4m3fn,
                                                     False),
           "int8": (torch.int8, True), "fake_quant": (torch.float32, True)}


def _narrow_case(seed, layout, S, Hq, Hkv, P, D, starts, dead=(), m=M):
    """A case in a policy's store layout: narrow pools from random
    values; scaled layouts get random per-block scales (all ones for
    fake_quant) and a fresh run. ``f32`` is the passthrough f32 pool."""
    q, k, v, tables, starts = _case(seed, S, Hq, Hkv, P, D, starts, dead, m)
    if layout == "f32":
        return (q, k, v, tables, starts), {}
    dtype, scaled = LAYOUTS[layout]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kw = {}
    if dtype == torch.int8:
        k, v = ((t * 40).round().clamp(-127, 127).to(torch.int8)
                for t in (k, v))
    else:
        k, v = k.to(dtype), v.to(dtype)
    if scaled:
        nb = k.shape[0] // BS
        kw["kv_scales"] = tuple(
            (torch.rand((nb, Hkv), generator=gen, device="cuda") * 0.05
             + 0.01) if dtype == torch.int8 else
            torch.ones((nb, Hkv), device="cuda") for _ in range(2))
        kw["fresh_kv"] = tuple(torch.randn((S, Hkv, P, D), generator=gen,
                                           device="cuda") for _ in range(2))
    return (q, k, v, tables, starts), kw


VARIANT_CASES = dict(CASES, verify_S8_P4=dict(
    S=8, Hq=4, Hkv=4, P=4, D=64, starts=[0, 5, 16, 31, 60, 100, 7, 0],
    dead=(7,)))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", sorted(VARIANT_CASES))
def test_kernel_variants_match_plain_version(cuda_device, layout, name):
    args, kw = _narrow_case(2, layout, **VARIANT_CASES[name])
    variant = kernel_variant(args[1], kw.get("kv_scales"))
    before = paged_attention.launches_by_variant[variant]
    got = paged_attention(*args, block_size=BS, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches_by_variant[variant] == before + 1
    want = paged_attention_ref(*args, block_size=BS, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_fake_quant_kernel_equals_f32_passthrough_bitwise(cuda_device):
    """The run written into an f32 pool (passthrough) and the same run
    as fresh K/V over a pool whose run slots hold other values, with
    all-one scales (fake_quant): bit-identical outputs."""
    q, k, v, tables, starts = _case(3, **VARIANT_CASES["verify_S8_P4"])
    S, _, P, D = q.shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    fresh = [torch.randn((S, k.shape[1], P, D), generator=gen,
                         device="cuda") for _ in range(2)]
    kw, vw = k.clone(), v.clone()
    for s in range(S):
        for i in range(P):
            t = int(starts[s]) + i
            slot = int(tables[s, t // BS]) * BS + t % BS
            kw[slot], vw[slot] = fresh[0][s, :, i], fresh[1][s, :, i]
    ones = torch.ones((k.shape[0] // BS, k.shape[1]), device="cuda")
    a = paged_attention(q, kw, vw, tables, starts, block_size=BS)
    b = paged_attention(q, k, v, tables, starts, block_size=BS,
                        kv_scales=(ones, ones), fresh_kv=tuple(fresh))
    assert torch.equal(a, b)


# the decode path (split-KV, P x Hq / Hkv <= 4 query rows a kv head). A
# table of M = 8 blocks of 16 is 128 positions and 2 splits, dealt a row's
# positions in units of 16, unit u to split u % 2; "split_edge" ends
# contexts exactly on a unit (16 positions: split 1 empty), one past it,
# exactly on a round of both splits (32), one past it, at the table's end
def _decode_cases():
    return {
        "split_edge": dict(S=6, Hq=4, Hkv=4, P=1, D=64,
                           starts=[15, 16, 31, 32, 127, 0], dead=(5,)),
        "one_position": dict(S=2, Hq=4, Hkv=4, P=1, D=64, starts=[0, 0]),
        "long_1024": dict(S=2, Hq=4, Hkv=4, P=1, D=64, starts=[1023, 511],
                          m=64),
        # 8 splits: rows of part of a round, and of fewer units than splits
        "wide_table": dict(S=3, Hq=4, Hkv=4, P=1, D=64, starts=[308, 40, 100],
                           m=64),
        "gqa2": dict(S=3, Hq=8, Hkv=4, P=1, D=64, starts=[100, 37, 0],
                     dead=(2,)),
        "gqa4": dict(S=3, Hq=8, Hkv=2, P=1, D=64, starts=[127, 16, 3]),
        "d32": dict(S=2, Hq=4, Hkv=4, P=1, D=32, starts=[77, 15]),
        "d128": dict(S=2, Hq=2, Hkv=2, P=1, D=128, starts=[90, 5]),
        # 4 values a lane where D allows no 16-byte loads (bf16, fp8, int8)
        "d36": dict(S=2, Hq=2, Hkv=2, P=1, D=36, starts=[70, 2]),
        "verify_P4": dict(S=3, Hq=4, Hkv=4, P=4, D=64, starts=[60, 124, 0],
                          dead=(2,)),
    }


def _decode_args(seed, layout, name):
    return _narrow_case(seed, layout, **_decode_cases()[name])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["f32", *sorted(LAYOUTS)])
@pytest.mark.parametrize("name", sorted(_decode_cases()))
def test_decode_path_matches_plain_version(cuda_device, layout, name):
    args, kw = _decode_args(8, layout, name)
    assert kernel_path(args[0], args[1]) == "decode"
    before = paged_attention.launches_by_path["decode"]
    got = paged_attention(*args, block_size=BS, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches_by_path["decode"] == before + 1
    want = paged_attention_ref(*args, block_size=BS, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,P,path", [
    (4, 4, 4, "decode"), (8, 2, 1, "decode"), (4, 2, 2, "decode"),
    (4, 4, 5, "prefill"), (8, 4, 3, "prefill"), (8, 1, 1, "prefill")])
def test_path_threshold(cuda_device, Hq, Hkv, P, path):
    """P x Hq / Hkv query rows a kv head: up to 4 take the decode path,
    more the prefill path; both agree with the plain version."""
    args = _case(9, S=2, Hq=Hq, Hkv=Hkv, P=P, D=64, starts=[40, 3])
    assert kernel_path(args[0], args[1]) == path
    before = dict(paged_attention.launches_by_path)
    got = paged_attention(*args, block_size=BS)
    torch.cuda.synchronize()
    after = dict(paged_attention.launches_by_path)
    assert after.get(path, 0) == before.get(path, 0) + 1
    other = "prefill" if path == "decode" else "decode"
    assert after.get(other, 0) == before.get(other, 0)
    torch.testing.assert_close(got, paged_attention_ref(*args, block_size=BS),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["f32", "int8"])
def test_decode_path_is_deterministic(cuda_device, layout):
    """Each split's partial is combined in split order, without atomics:
    two launches give bitwise-equal outputs."""
    args, kw = _decode_args(10, layout, "long_1024")
    a = paged_attention(*args, block_size=BS, **kw)
    b = paged_attention(*args, block_size=BS, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["long_1024", "gqa4"])
def test_fake_quant_decode_equals_f32_bitwise(cuda_device, name):
    """On the decode path: the f32 pool (passthrough) against the same
    pool with each row's last position overwritten, all-one scales and
    the true K/V as the fresh run (fake_quant): bit-identical outputs."""
    (q, k, v, tables, starts), _ = _decode_args(11, "f32", name)
    st = starts.long()
    slot = (tables.long().gather(1, (st // BS)[:, None])[:, 0] * BS
            + st % BS)
    fresh = tuple(t[slot][:, :, None, :].contiguous() for t in (k, v))
    k_over, v_over = k.clone(), v.clone()
    for t in (k_over, v_over):
        t[slot] = torch.randn_like(t[slot])
    ones = torch.ones((k.shape[0] // BS, k.shape[1]), device="cuda")
    a = paged_attention(q, k, v, tables, starts, block_size=BS)
    b = paged_attention(q, k_over, v_over, tables, starts, block_size=BS,
                        kv_scales=(ones, ones), fresh_kv=fresh)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the prefill path (3xTF32 on the tensor cores, more than 4 query rows a kv
# head): head dims the kernel pads (8 -> 8, 12 -> 16, 36 -> 64) or takes as
# they are (64, 128); tails at the unaligned start 37; pad queries past the
# table's 128 positions; GQA groups of 2 and 4 folded into one row tile;
# several row and key tiles on a table of 1,024 positions
def _prefill_cases():
    return {
        "d8": dict(S=1, Hq=2, Hkv=2, P=40, D=8, starts=[0]),
        "d12_start37": dict(S=1, Hq=2, Hkv=2, P=33, D=12, starts=[37]),
        "d36_start37": dict(S=1, Hq=2, Hkv=2, P=70, D=36, starts=[37]),
        "d128_start37": dict(S=1, Hq=2, Hkv=2, P=64, D=128, starts=[37]),
        "past_table": dict(S=1, Hq=2, Hkv=2, P=100, D=64, starts=[101]),
        "gqa2_p16": dict(S=2, Hq=8, Hkv=4, P=16, D=64, starts=[37, 0]),
        "gqa4_p40_start37": dict(S=1, Hq=8, Hkv=2, P=40, D=64, starts=[37]),
        "gqa4_d128": dict(S=1, Hq=8, Hkv=2, P=24, D=128, starts=[5]),
        "two_rows": dict(S=2, Hq=4, Hkv=4, P=96, D=64, starts=[0, 29]),
        "long_p300": dict(S=1, Hq=2, Hkv=2, P=300, D=64, starts=[0], m=64),
        "long_d128_start37": dict(S=1, Hq=2, Hkv=2, P=200, D=128,
                                  starts=[37], m=64),
        # key tiles split 2, 3 and 4 ways inside a cluster (P > 256 at D <=
        # 64, P > 128 at D = 128: the two above are split 2 ways)
        "split3_gqa2": dict(S=1, Hq=4, Hkv=2, P=600, D=64, starts=[37],
                            m=64),
        "split4_past_table": dict(S=1, Hq=2, Hkv=2, P=1024, D=64,
                                  starts=[37], m=64),
        "split4_d128_two_rows": dict(S=2, Hq=2, Hkv=2, P=520, D=128,
                                     starts=[0, 300], m=64),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["f32", *sorted(LAYOUTS)])
@pytest.mark.parametrize("name", sorted(_prefill_cases()))
def test_prefill_path_matches_plain_version(cuda_device, layout, name):
    args, kw = _narrow_case(13, layout, **_prefill_cases()[name])
    assert kernel_path(args[0], args[1]) == "prefill"
    before = paged_attention.launches_by_path["prefill"]
    got = paged_attention(*args, block_size=BS, **kw)
    torch.cuda.synchronize()
    assert paged_attention.launches_by_path["prefill"] == before + 1
    want = paged_attention_ref(*args, block_size=BS, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bf16", "int8", "fp8"])
def test_prefill_path_pools_not_16_byte_aligned(cuda_device, layout):
    """Narrow pools at an address that is not 16-byte aligned (but as
    aligned as the wrapper asks) take the 4-values-a-lane loads."""
    args, kw = _narrow_case(14, layout, **_prefill_cases()["gqa4_p40_start37"])
    q, k, v, tables, starts = args
    align = {"bf16": 8, "int8": 4, "fp8": 4}[layout] // k.element_size()

    def shifted(t):
        flat = torch.empty(t.numel() + align, dtype=t.dtype, device="cuda")
        out = flat[align:].view(t.shape)
        out.copy_(t)
        return out

    k, v = shifted(k), shifted(v)
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    got = paged_attention(q, k, v, tables, starts, block_size=BS, **kw)
    torch.cuda.synchronize()
    want = paged_attention_ref(q, k, v, tables, starts, block_size=BS, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["long_p300", "split4_past_table"])
@pytest.mark.parametrize("layout", ["f32", "int8"])
def test_prefill_path_is_deterministic(cuda_device, layout, name):
    """Each output element is written by one block, its key splits
    combined in a fixed order, without atomics: two launches give
    bitwise-equal outputs."""
    args, kw = _narrow_case(15, layout, **_prefill_cases()[name])
    a = paged_attention(*args, block_size=BS, **kw)
    b = paged_attention(*args, block_size=BS, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["d36_start37", "past_table", "gqa4_d128",
                                  "long_p300", "split3_gqa2"])
def test_fake_quant_prefill_equals_f32_bitwise(cuda_device, name):
    """On the prefill path: the f32 pool holding the run (passthrough)
    against the same pool with the run's slots overwritten, all-one
    scales and the run as the fresh K/V (fake_quant): bit-identical."""
    (q, k, v, tables, starts), _ = _narrow_case(16, "f32",
                                                **_prefill_cases()[name])
    S, _, P, D = q.shape
    width = tables.shape[1] * BS
    fresh = [torch.zeros((S, k.shape[1], P, D), device="cuda")
             for _ in range(2)]
    k_over, v_over = k.clone(), v.clone()
    for s in range(S):
        for i in range(P):
            t = int(starts[s]) + i
            if t >= width:
                continue
            slot = int(tables[s, t // BS]) * BS + t % BS
            fresh[0][s, :, i], fresh[1][s, :, i] = k[slot], v[slot]
            k_over[slot] = torch.randn_like(k[slot])
            v_over[slot] = torch.randn_like(v[slot])
    ones = torch.ones((k.shape[0] // BS, k.shape[1]), device="cuda")
    a = paged_attention(q, k, v, tables, starts, block_size=BS)
    b = paged_attention(q, k_over, v_over, tables, starts, block_size=BS,
                        kv_scales=(ones, ones), fresh_kv=tuple(fresh))
    torch.cuda.synchronize()
    assert kernel_path(q, k) == "prefill"
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["int8", "fake_quant"])
def test_window_update_on_card_equals_cpu(cuda_device, policy):
    """paged_quant_window_update on the card and on the CPU: the same
    pool bytes and scales on every real block."""
    rng = np.random.default_rng(4)
    S, H, D, P = 3, 4, 64, 20
    nb = 1 + S * M
    tables = np.zeros((S, M), np.int32)
    tables[:2] = rng.permutation(np.arange(1, nb))[:2 * M].reshape(2, M)
    pol = make_policy(policy)
    cache = torch.from_numpy(rng.standard_normal((nb * BS, H, D)).astype(
        np.float32) * 3)
    cache = pol.quant(cache, None if policy == "fake_quant" else
                      torch.tensor(0.05))
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, (nb, H)).astype(
        np.float32)) if policy == "int8" else torch.ones((nb, H))
    vals = torch.from_numpy(rng.standard_normal((S, H, P, D)).astype(
        np.float32))
    starts = np.asarray([37, 90, 0], np.int32)
    positions = torch.from_numpy(starts[:, None]
                                 + np.arange(P, dtype=np.int32))
    lens = torch.tensor([20, 15, 0], dtype=torch.int32)
    span = min(-(-P // BS) + 1, M)
    out = {}
    for dev in ("cpu", "cuda"):
        c, sc = cache.clone().to(dev), scales.clone().to(dev)
        paged_quant_window_update(
            pol, c, sc, vals.to(dev), positions.to(dev), lens.to(dev),
            block_tables=torch.from_numpy(tables).to(dev), block_size=BS,
            max_blocks=span)
        out[dev] = (c.cpu(), sc.cpu())
    assert torch.equal(out["cuda"][0][BS:], out["cpu"][0][BS:])
    assert torch.equal(out["cuda"][1][1:], out["cpu"][1][1:])


@pytest.mark.cuda
def test_kernel_rejects_bad_layouts(cuda_device):
    args, kw = _narrow_case(5, "int8", **CASES["decode_dead_row"])
    q, k, v, tables, starts = args
    with pytest.raises(TypeError, match="pools of one dtype"):
        paged_attention(q, k.half(), v.half(), tables, starts, block_size=BS)
    with pytest.raises(ValueError, match="fresh_kv"):
        paged_attention(*args, block_size=BS, kv_scales=kw["kv_scales"])
    with pytest.raises(ValueError, match="k_scale"):
        paged_attention(*args, block_size=BS, fresh_kv=kw["fresh_kv"],
                        kv_scales=tuple(s[1:] for s in kw["kv_scales"]))
    for dtype in (torch.int8, torch.bfloat16):
        flat = torch.zeros(k.numel() + 1, dtype=dtype, device="cuda")
        bad = flat[1:].view(k.shape)             # contiguous, misaligned
        with pytest.raises(ValueError, match="aligned"):
            paged_attention(q, bad, bad, tables, starts, block_size=BS)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "fp8", "int8",
                                      "fake_quant"])
def test_engine_on_card_matches_engine_on_cpu(cuda_device, kv_dtype):
    """Tiny GPT-2: the same weights served on the card (kernel) and on
    the CPU (plain version) give the same greedy tokens, and every
    prefill and decode layer launched the policy's kernel variant."""
    cfg = GPT2Config.tiny(n_layer=2)
    params = gpt2_init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 9)]
    kw = dict(max_slots=2, block_size=4, num_blocks=24, max_seq_len=40,
              kv_dtype=kv_dtype)
    cpu = ServeEngine(gpt2_family(cfg), params, device="cpu", **kw)
    card = ServeEngine(gpt2_family(cfg), params, device="cuda", **kw)
    want = generate(cpu, prompts, max_new_tokens=8)
    paged_attention.launches = 0
    paged_attention.launches_by_variant.clear()
    paged_attention.launches_by_path.clear()
    got = generate(card, prompts, max_new_tokens=8)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    m = card.metrics
    n = cfg.n_layer * (m.decode_steps + m.admitted)
    variant = kernel_variant(card.pool.k, card.pool.caches()[2:] or None)
    assert paged_attention.launches == n
    assert dict(paged_attention.launches_by_variant) == {variant: n}
    # decode steps of 2 rows x 1 query take the decode path, prefills
    # (buckets of >= 16 positions) the prefill path
    assert dict(paged_attention.launches_by_path) == {
        "decode": cfg.n_layer * m.decode_steps,
        "prefill": cfg.n_layer * m.admitted}


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
    # the backward kernels' tiles: 64 owned rows, 64 streamed rows (32 at
    # D = 128); segment ids that change exactly on a tile edge; and
    # "interleaved" ids, where a tile pair's id ranges overlap (so it is
    # not skipped) but no row of it has a visible key
    **{f"edge_d{D}_s{S}": dict(B=1, H=2, S=S, D=D, causal=True, seg=False)
       for D in (32, 64, 128) for S in (63, 64, 65)},
    **{f"edge_d128_s{S}_noncausal": dict(B=1, H=2, S=S, D=128,
                                         causal=False, seg=False)
       for S in (31, 32, 33)},
    # the forward's tiles at D = 32 and 64 without causality: 64 owned
    # query rows, 64 streamed key rows
    **{f"edge_d{D}_s{S}_noncausal": dict(B=1, H=2, S=S, D=D, causal=False,
                                         seg=False)
       for D in (32, 64) for S in (63, 64, 65)},
    "seg_on_tile_edges_d64": dict(B=2, H=2, S=192, D=64, causal=True,
                                  seg="edges"),
    "seg_on_tile_edges_d128": dict(B=1, H=2, S=192, D=128, causal=False,
                                   seg="edges"),
    "no_visible_key_causal": dict(B=1, H=2, S=128, D=64, causal=True,
                                  seg="interleaved"),
    "no_visible_key_noncausal": dict(B=1, H=2, S=128, D=64, causal=False,
                                     seg="interleaved"),
    # S = 300: a ragged last tile of every kernel's owned and streamed rows
    # (the bf16 K1 and K2 read it through 3-D tensor maps, which must
    # zero-fill the rows past S, not read the next head's)
    **{f"ragged_s300_d{D}": dict(B=2, H=2, S=300, D=D, causal=True,
                                 seg=False) for D in (32, 64, 128)},
    **{f"ragged_s300_d{D}_noncausal_seg": dict(B=2, H=2, S=300, D=D,
                                               causal=False, seg=True)
       for D in (32, 64, 128)},
    # an sp2_ulysses rank's call in chip_smoke.py: 4 rows, 6 of GPT-2's 12
    # heads, over all 1,024 positions after the head scatter
    "ulysses_sp2_B4_H6_S1024": dict(B=4, H=6, S=1024, D=64, causal=True,
                                    seg=False),
}


def _flash_case(seed, B, H, S, D, causal, seg):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, H, S, D)).astype(np.float32)).cuda() for _ in range(4))
    ids = None
    if seg == "edges":
        # documents of 32 rows: every 64- and 32-row tile edge is a boundary
        ids = np.tile(np.arange(S, dtype=np.int32) // 32, (B, 1))
        ids = torch.from_numpy(ids).cuda()
    elif seg == "interleaved":
        # rows 0..63 alternate ids 0 and 2, the rest are id 1: the tile
        # pairs (rows < 64, rows >= 64) have overlapping id ranges and no
        # visible pair
        ids = np.where(np.arange(S) < 64, 2 * (np.arange(S) % 2), 1)
        ids = torch.from_numpy(np.tile(ids.astype(np.int32), (B, 1))).cuda()
    elif seg:
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
@pytest.mark.parametrize("causal", [True, False])
def test_backward_kernels_are_deterministic(cuda_device, causal):
    """No atomics: each gradient element is written by one block, so two
    launches on the same inputs give bitwise-equal dk, dv and dq."""
    q, k, v, do, seg = _flash_case(7, B=2, H=3, S=200, D=64, causal=causal,
                                   seg=True)
    o, lse = flash_fwd(q, k, v, seg, causal=causal)
    delta = flash_delta(o, do)
    args = (q, k, v, do, lse, delta, seg)
    first = (*flash_bwd_dkv(*args, causal=causal),
             flash_bwd_dq(*args, causal=causal))
    second = (*flash_bwd_dkv(*args, causal=causal),
              flash_bwd_dq(*args, causal=causal))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_forward_kernel_is_deterministic(cuda_device, causal):
    """Each output row is written by one block: two launches of K1 on the
    same inputs give bitwise-equal o and lse."""
    q, k, v, _, seg = _flash_case(12, B=2, H=3, S=200, D=64, causal=causal,
                                  seg=True)
    first = flash_fwd(q, k, v, seg, causal=causal)
    second = flash_fwd(q, k, v, seg, causal=causal)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
        flash_fwd(q.half(), k.half(), v.half(), causal=True)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_fwd(q.bfloat16(), k, v.bfloat16(), causal=True)
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


@pytest.mark.cuda
def test_tiny_gpt2_flash_step_routes_and_matches_cpu(cuda_device):
    """Tiny GPT-2 (head dim 8, outside the kernels' domain) with
    ``use_flash=True`` on the card goes through the dispatcher's blockwise
    route without raising (``routed`` counts every layer of every
    micro-batch, no kernel launches) and matches the CPU: the first
    batch's loss and every gradient leaf, then the losses of two AdamW
    steps (the second reads the first update; losses, unlike the updated
    parameters, do not amplify the noise of gradients that are zero up to
    rounding, such as the key bias's)."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.ops.flash_attention import flash_attention
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = GPT2Config.tiny()
    tcfg = Config.from_dict({"training": dict(
        optimizer="adamw", learning_rate=3e-3, weight_decay=0.01,
        grad_clip_norm=1.0, batch_size=4, gradient_accumulation_steps=2)})
    spec = gpt2_model_spec(cfg, use_flash=True)
    rng = np.random.default_rng(17)
    ids = rng.integers(0, cfg.vocab_size, (4, 32))
    labels = ids.copy()
    params = gpt2_init(torch.Generator().manual_seed(2), cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(tcfg, spec, task_type="clm", device=dev)
        p = tree_map(lambda t: t.detach().clone().to(dev)
                     .requires_grad_(True), params)
        batch = trainer.device_batch(ids, labels)
        for fn in (flash_fwd, flash_bwd_dkv, flash_bwd_dq):
            fn.launches = 0
        flash_attention.routed = 0
        loss, grads = accumulate_grads(spec.loss_fn, p, batch, 2)
        state, losses = trainer.optimizer.init(p), []
        for _ in range(2):
            p, state, step_loss = trainer.step_fn(p, state, batch)
            losses.append(float(step_loss))
        torch.cuda.synchronize()
        out[dev] = (float(loss), grads, losses, flash_attention.routed)
        assert (flash_fwd.launches, flash_bwd_dkv.launches,
                flash_bwd_dq.launches) == (0, 0, 0)
    assert out["cpu"][3] == 0
    # layers x micro-batches x (the gradient pass + two steps)
    assert out["cuda"][3] == cfg.n_layer * 2 * 3
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for path, g in out["cpu"][1].items():
        assert _rel_err(out["cuda"][1][path].cpu(), g) <= 1e-4, path
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-5)
    assert out["cpu"][2][1] < out["cpu"][2][0]     # the step moved


@pytest.mark.cuda
def test_tiny_vit_on_card_matches_cpu(cuda_device):
    """A small ViT (depth 2, hidden 32, NCHW input, remat): logits, loss
    and every gradient leaf of a 2-micro-batch step on the card against
    the CPU from the same weights; its plain attention launches no
    kernel."""
    from quintnet_tpu_torch.models.vit import (ViTConfig, vit_apply,
                                               vit_init, vit_model_spec)
    from quintnet_tpu_torch.ops.flash_attention import flash_attention

    cfg = ViTConfig(depth=2, hidden_dim=32, num_heads=4)
    spec = vit_model_spec(cfg, remat=True)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((8, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 8)
    params = vit_init(torch.Generator().manual_seed(3), cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        batch = (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        for fn in (flash_fwd, flash_bwd_dkv, flash_bwd_dq):
            fn.launches = 0
        flash_attention.routed = 0
        with torch.no_grad():
            logits = vit_apply(p, batch[0], cfg)
        loss, grads = accumulate_grads(spec.loss_fn, p, batch, 2)
        torch.cuda.synchronize()
        out[dev] = (logits.cpu(), loss.detach().cpu(),
                    {k: g.cpu() for k, g in grads.items()})
        assert (flash_fwd.launches, flash_bwd_dkv.launches,
                flash_bwd_dq.launches, flash_attention.routed) == (0, 0, 0, 0)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-5,
                               rtol=0)
    for path, g in out["cpu"][2].items():
        torch.testing.assert_close(out["cuda"][2][path], g, atol=1e-5,
                                   rtol=1e-4, msg=".".join(path))


class _Cut(Exception):
    pass


@pytest.mark.cuda
def test_tiny_gpt2_resume_on_card_is_bit_identical(cuda_device, tmp_path,
                                                  monkeypatch):
    """A GPT-2 with head dim 64 (the kernels' domain) and residual
    dropout, 4 AdamW steps through K1-K3 in deterministic mode, against
    the same run cut after step 2 (a cadence save) and continued by a
    fresh trainer from the checkpoint: parameters, both moments and the
    step losses equal bit for bit, and every step launched each kernel
    once per layer and micro-batch."""
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.pytree import tree_leaves
    from quintnet_tpu_torch.ops.flash_attention import flash_attention
    from quintnet_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = GPT2Config.tiny(n_embd=128, n_head=2, n_layer=2, resid_pdrop=0.1)
    spec = gpt2_model_spec(cfg, use_flash=True)
    tcfg = Config.from_dict({"training": dict(
        optimizer="adamw", learning_rate=3e-3, weight_decay=0.01,
        grad_clip_norm=1.0, batch_size=4, gradient_accumulation_steps=2,
        save_every_steps=2, log_every=0)})
    rng = np.random.default_rng(21)
    host = [(ids, ids.copy()) for ids in
            (rng.integers(0, cfg.vocab_size, (4, 48)) for _ in range(4))]
    params = gpt2_init(torch.Generator().manual_seed(4), cfg)

    def fresh():
        return tree_map(lambda t: t.detach().clone().cuda()
                        .requires_grad_(True), params)

    def recording(tr):
        losses, step_fn = [], tr.step_fn

        def step(*a, **kw):
            out = step_fn(*a, **kw)
            losses.append(out[2])
            return out

        tr.step_fn = step
        return losses

    def cut_data(ep, start=0):
        yield from host[:2]
        raise _Cut

    def trainer(ckpt=None):
        return Trainer(tcfg, spec, task_type="clm", checkpoint_dir=ckpt,
                       device="cuda", log_fn=lambda m: None)

    for fn in (flash_fwd, flash_bwd_dkv, flash_bwd_dq):
        fn.launches = 0
    flash_attention.routed = 0
    torch.use_deterministic_algorithms(True)
    try:
        ref = trainer()
        ref_losses = recording(ref)
        p = fresh()
        ref.fit(lambda ep, start=0: iter(host[start:]), epochs=1, params=p,
                opt_state=ref.optimizer.init(p))
        first = trainer(str(tmp_path / "ck"))
        losses = recording(first)
        p = fresh()
        with pytest.raises(_Cut):
            first.fit(cut_data, epochs=1, params=p,
                      opt_state=first.optimizer.init(p))
        second = trainer(str(tmp_path / "ck"))
        p, opt_state, cursor = second.resume_state()
        assert (cursor.step_in_epoch, cursor.global_step) == (2, 2)
        losses_2 = recording(second)
        second.fit(lambda ep, start=0: iter(host[start:]), epochs=1,
                   params=p, opt_state=opt_state, cursor=cursor)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    n = cfg.n_layer * 2 * (4 + 2 + 2)
    assert (flash_fwd.launches, flash_bwd_dkv.launches,
            flash_bwd_dq.launches, flash_attention.routed) == (n, n, n, 0)
    assert len(losses + losses_2) == 4
    for a, b in zip(losses + losses_2, ref_losses):
        assert torch.equal(a, b)
    (pa, oa), (pb, ob) = second.final_state, ref.final_state
    assert oa["count"] == ob["count"] == 4
    for tree_a, tree_b in ((pa, pb), (oa["mu"], ob["mu"]),
                           (oa["nu"], ob["nu"])):
        want = dict(tree_leaves(tree_b))
        for path, t in tree_leaves(tree_a):
            assert torch.equal(t, want[path]), path


# ---------------------------------------------------------------------
# flash attention in bf16 (K1-K3 on bf16 tensor-core tiles)
# ---------------------------------------------------------------------

BF16_TOL = 2.0 ** -7     # x max |ref|: one bf16 ulp of the largest value


def _bf16_case(seed, **c):
    q, k, v, do, seg = _flash_case(seed, **c)
    return (*(t.bfloat16() for t in (q, k, v, do)), seg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_bf16_flash_kernels_match_plain_versions(cuda_device, name):
    """The bf16 kernels against their plain versions on the same bf16
    inputs (which round p and ds where the kernels do): o, dq, dk, dv in
    bf16 within one bf16 ulp of the largest value, lse (f32) within
    1e-5; every launch counted under "bf16"."""
    c = FLASH_CASES[name]
    q, k, v, do, seg = _bf16_case(3, **c)
    causal = c["causal"]
    fns = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)
    n = [fn.launches_by_dtype["bf16"] for fn in fns]
    o, lse = flash_fwd(q, k, v, seg, causal=causal)
    delta = flash_delta(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, seg, causal=causal)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, seg, causal=causal)
    torch.cuda.synchronize()
    assert [fn.launches_by_dtype["bf16"] for fn in fns] == [x + 1 for x in n]
    o_r, lse_r = flash_fwd_ref(q, k, v, seg, causal=causal)
    dk_r, dv_r = flash_bwd_dkv_ref(q, k, v, do, lse_r, delta, seg,
                                   causal=causal)
    dq_r = flash_bwd_dq_ref(q, k, v, do, lse_r, delta, seg, causal=causal)
    assert lse.dtype == torch.float32
    assert float((lse - lse_r).abs().max()) <= 1e-5
    for got, want in ((o, o_r), (dq, dq_r), (dk, dk_r), (dv, dv_r)):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        assert _rel_err(got.float(), want.float()) <= BF16_TOL


BF16_VS_F32_TOL = 2.0 ** -5  # x max |ref|: four bf16 ulps of the largest


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_bf16_dq_matches_f32_plain_version(cuda_device, name):
    """K3 in bf16 against the f32 plain version on the same bf16 values
    (lse and delta from the f32 plain forward): dq within four bf16 ulps
    of the largest value, room for the rounding of ds and of dq."""
    c = FLASH_CASES[name]
    q, k, v, do, seg = _bf16_case(3, **c)
    causal = c["causal"]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o_f, lse_f = flash_fwd_ref(qf, kf, vf, seg, causal=causal)
    delta = flash_delta(o_f, dof)
    dq = flash_bwd_dq(q, k, v, do, lse_f, delta, seg, causal=causal)
    torch.cuda.synchronize()
    dq_f = flash_bwd_dq_ref(qf, kf, vf, dof, lse_f, delta, seg,
                            causal=causal)
    assert dq.dtype == torch.bfloat16 and torch.isfinite(dq).all()
    assert _rel_err(dq.float(), dq_f) <= BF16_VS_F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_kernels_are_deterministic(cuda_device, causal, D):
    """One writer per output element in bf16 too: two launches of each
    kernel on the same inputs are bitwise equal."""
    q, k, v, do, seg = _bf16_case(7, B=2, H=3, S=200, D=D, causal=causal,
                                  seg=True)
    o, lse = flash_fwd(q, k, v, seg, causal=causal)
    args = (q, k, v, do, lse, flash_delta(o, do), seg)

    def launch_all():
        return (*flash_fwd(q, k, v, seg, causal=causal),
                *flash_bwd_dkv(*args, causal=causal),
                flash_bwd_dq(*args, causal=causal))

    first, second = launch_all(), launch_all()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fp16_is_routed_and_bf16_is_not(cuda_device):
    """fp16 lies outside the kernels' domain: the dispatcher sends it to
    the blockwise attention (counted in ``routed``, no launch); bf16
    launches the bf16 kernels."""
    from quintnet_tpu_torch.ops.flash_attention import flash_attention

    q, k, v, _, _ = _flash_case(9, B=1, H=2, S=64, D=64, causal=True,
                                seg=False)
    fns = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)
    flash_attention.routed = 0
    n = [fn.launches for fn in fns]
    out = flash_attention(q.half(), k.half(), v.half(), causal=True)
    assert out.dtype == torch.float16 and flash_attention.routed == 1
    assert [fn.launches for fn in fns] == n
    out = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                          causal=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and flash_attention.routed == 1
    assert flash_fwd.launches == n[0] + 1


@pytest.mark.cuda
def test_tiny_bf16_training_step_on_card_matches_cpu(cuda_device):
    """A 2-micro-batch step of a small GPT-2 (head dim 64, packed
    segments) in bf16 compute: the bf16 kernels on the card against the
    plain versions on the CPU, from the same f32 weights. The loss within
    1e-2 relative, each gradient leaf (f32) within 5e-2 of its largest
    magnitude (cuBLAS and the CPU round their bf16 products differently);
    every layer of every micro-batch launched each bf16 kernel and no f32
    one."""
    cfg = GPT2Config.tiny(n_embd=128, n_head=2, n_layer=2, segment_eos_id=7)
    spec = gpt2_model_spec(cfg, use_flash=True, compute_dtype=torch.bfloat16)
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
    fns = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)
    for fn in fns:
        fn.launches_by_dtype.clear()
    loss, grads = run("cuda")
    torch.cuda.synchronize()
    n = cfg.n_layer * 2
    assert [dict(fn.launches_by_dtype) for fn in fns] == [{"bf16": n}] * 3
    assert abs(float(loss) - float(loss_cpu)) <= 1e-2 * abs(float(loss_cpu))
    for path, g in grads_cpu.items():
        assert grads[path].dtype == torch.float32
        assert _rel_err(grads[path].cpu(), g) <= 5e-2, path


@pytest.mark.cuda
def test_sampling_chain_integers_equal_on_the_card(cuda_device):
    """The sampling chain's int64 hash gives the card the CPU's integers
    (one serve step's [8, 50,257] draw), and a sampled draw from the
    same logits picks the same tokens."""
    from quintnet_tpu_torch.models.gpt2_generate import (chain_bits,
                                                         sample_logits)

    seeds = list(range(8))
    ctr = [0, 1, 2, 3, 100, 1000, 31, 7]
    cpu = chain_bits(seeds, ctr, 50257, "cpu")
    assert torch.equal(chain_bits(seeds, ctr, 50257, cuda_device).cpu(),
                       cpu)
    logits = torch.randn(8, 50257, generator=torch.Generator().manual_seed(0))
    kw = dict(temperature=0.8, top_k=50, top_p=0.95)
    assert torch.equal(
        sample_logits(logits.to(cuda_device), seeds, ctr, **kw).cpu(),
        sample_logits(logits, seeds, ctr, **kw))
