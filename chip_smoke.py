#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py            # all phases, one CUDA card

Phases (any failure raises and exits non-zero; nothing is caught):

1. **kernels** — build every CUDA source of the path with ``nvcc``
   (one process per source, started together), then hold each kernel
   to its plain PyTorch version at the main paths' shapes (GPT-2 base
   heads, D = 64). Paged attention (K4, block size 16): decode rows
   with mixed context lengths and a dead row, prefill tails at start 0
   and at an offset that is not block-aligned, and a GQA case. Flash
   attention (K1 forward, K2 dK/dV, K3 dQ): (B, H, S) = (8, 12, 1024)
   causal, (4, 12, 512) causal with packed-segment ids, (2, 12, 300)
   causal with a ragged last tile, (8, 12, 256) non-causal and
   (1, 12, 4096) causal. Prints one JSON line per case with the error
   and the times of the kernel, the plain version and a PyTorch library
   call (``F.scaled_dot_product_attention``: over a view gathered
   beforehand for K4; forward, and forward+backward minus forward, for
   K1-K3 — a yardstick only, never used by the port), plus the least
   time the card could take (``bound_ms``).
2. **serve** — GPT-2 124M (random weights from seed 0) served by the
   port's ``ServeEngine`` on the card: warmup, 8 greedy requests with
   prompts of 32-400 tokens (one continues another's conversation, so
   the prefix cache hits and copies on write), run to completion. The
   kernel launch count is zeroed just before and read just after; each
   request's tokens are checked against greedy decoding by the dense
   ``gpt2_apply`` on the card (a mismatch where the dense top-2 logit
   gap is below 1e-3 is reported as a near-tie, any other fails).
   Prints decode tokens/s, TTFT p50 and, over steady decode steps, the
   step's wall time (no profiler running) against the device's busy
   time and the kernel's time (``torch.profiler``, next steps).
3. **train** — GPT-2 124M (f32, random weights from seed 0, every
   dropout rate 0) trained by the port's ``Trainer`` with AdamW (lr
   5e-5, decay 0.01, clip 1.0) on ``SummarizationDataset.synthetic``
   rows of 512 byte tokens, global batch 64 in 2 micro-batches of 32:
   the first batch's loss and every gradient leaf with flash attention
   (the K1-K3 kernels) against plain attention from the same weights,
   then 4 optimizer steps through ``Trainer.fit`` each way, the losses
   compared step by step. The flash run is the main path: the launch
   counts are zeroed just before it and read just after (12 layers x 2
   micro-batches x 4 steps of each kernel). Prints the step's wall
   time (no profiler running), tokens/s and peak memory, and over the
   next steps under ``torch.profiler`` the device's busy time and the
   three kernels' share of the step.

Then one JSON line of per-kernel numbers, the card's name and power
limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
CUDA is not available or the package is missing.

Float32 matmuls run in full f32 (TF32 off for matmul and cuDNN) so the
oracle and the kernel are compared at f32 accuracy.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM f32, CUDA cores
KERNEL_TOL = 1e-4
TIMED_ITERS = 20
DEVICE = "cuda"
TRAIN_CASE = "causal_B32_S512_train"
FLASH_KERNELS = {                # wrapper -> the TPU kernel it replaces
    "flash_fwd": "quintnet_tpu/ops/pallas_attention.py:97",
    "flash_bwd_dkv": "quintnet_tpu/ops/pallas_attention.py:259",
    "flash_bwd_dq": "quintnet_tpu/ops/pallas_attention.py:304",
}


def _wrappers():
    """Every kernel wrapper of the port's main paths, by name."""
    from quintnet_tpu_torch.ops import flash_kernels
    from quintnet_tpu_torch.ops.paged_attention import paged_attention

    out = {name: getattr(flash_kernels, name) for name in FLASH_KERNELS}
    out["paged_attention"] = paged_attention
    return out


def _zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _timed_ms(fn) -> float:
    """Mean of ``TIMED_ITERS`` launches after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(TIMED_ITERS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / TIMED_ITERS


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------

def _paged_case(gen, *, name, S, Hq, Hkv, P, starts, dead=(), D=64, bs=16,
                M=64):
    """Random q and pool, a disjoint random block table per live row
    covering its live blocks; dead rows keep an all-zero table and
    start 0 (they read the null block only)."""
    dev = DEVICE
    live_blocks = [min((st + P - 1) // bs, M - 1) + 1 for st in starts]
    n_blocks = 1 + sum(n for s, n in enumerate(live_blocks)
                       if s not in dead)
    perm = (torch.randperm(n_blocks - 1, generator=gen, device=dev)
            + 1).to(torch.int32)
    tables = torch.zeros((S, M), dtype=torch.int32, device=dev)
    used = 0
    for s, n in enumerate(live_blocks):
        if s in dead:
            continue
        tables[s, :n] = perm[used:used + n]
        used += n
    case = {
        "name": name,
        "q": torch.randn((S, Hq, P, D), generator=gen, device=dev),
        "k": torch.randn((n_blocks * bs, Hkv, D), generator=gen,
                         device=dev),
        "v": torch.randn((n_blocks * bs, Hkv, D), generator=gen,
                         device=dev),
        "tables": tables,
        "starts": torch.tensor(starts, dtype=torch.int32, device=dev),
        "bs": bs,
    }
    # the least work these inputs need: live K/V blocks read once per
    # kv head, q read and o written once, plus the index arrays; 4*D
    # flops per causally visible (query, position) pair
    kv_bytes = sum(n * bs * Hkv * D * 4 * 2
                   for n in live_blocks)       # dead rows read block 0
    io_bytes = 2 * S * Hq * P * D * 4 + tables.numel() * 4 + S * 4
    visible = sum(min(st + i + 1, M * bs) for st in starts
                  for i in range(P))
    case["bytes"] = kv_bytes + io_bytes
    case["flops"] = 4 * D * Hq * visible
    return case


def _library_fn(c):
    """F.scaled_dot_product_attention over a gathered view built
    beforehand (the gather is not timed): a yardstick only."""
    from quintnet_tpu_torch.ops.paged_attention import (paged_gather,
                                                        repeat_kv)

    q = c["q"]
    S, Hq, P, D = q.shape
    rep = Hq // c["k"].shape[1]
    k_all = repeat_kv(paged_gather(c["k"], c["tables"],
                                   block_size=c["bs"]), rep)
    v_all = repeat_kv(paged_gather(c["v"], c["tables"],
                                   block_size=c["bs"]), rep)
    T = k_all.shape[2]
    pos = c["starts"].long()[:, None] + torch.arange(P, device=DEVICE)
    mask = (torch.arange(T, device=DEVICE)[None, None, :]
            <= pos[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k_all, v_all, attn_mask=mask)


def _bound(flops, nbytes):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def _paged_cases():
    from quintnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                        paged_attention_ref)

    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    H, bs = 12, 16
    cases = [_paged_case(gen, name="decode", S=8, Hq=H, Hkv=H, P=1,
                         starts=[1023, 700, 511, 300, 129, 64, 17, 0],
                         dead=(7,))]
    for P in (16, 128, 1024):
        for st in (0, 37):
            cases.append(_paged_case(gen, name=f"prefill_P{P}_start{st}",
                                     S=1, Hq=H, Hkv=H, P=P, starts=[st]))
    cases.append(_paged_case(gen, name="decode_gqa", S=8, Hq=H, Hkv=H // 2,
                             P=1, starts=[900, 450, 31, 16, 15, 200, 5, 0],
                             dead=(7,)))
    results = []
    for c in cases:
        args = (c["q"], c["k"], c["v"], c["tables"], c["starts"])
        kw = dict(block_size=c["bs"])
        out = paged_attention(*args, **kw)
        ref = paged_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{c['name']}: kernel output not finite")
        err = float((out - ref).abs().max())
        if err > KERNEL_TOL:
            raise AssertionError(f"{c['name']}: max_abs_err {err} > "
                                 f"{KERNEL_TOL}")
        res = {"kernel": "paged_attention", "case": c["name"],
               "shape_q": list(c["q"].shape),
               "kv_heads": c["k"].shape[1], "starts": c["starts"].tolist(),
               "max_abs_err": err,
               "kernel_ms": _timed_ms(lambda: paged_attention(*args, **kw)),
               "plain_ms": _timed_ms(
                   lambda: paged_attention_ref(*args, **kw)),
               "library_ms": _timed_ms(_library_fn(c)),
               "library": "F.scaled_dot_product_attention on a "
                          "pre-gathered view (yardstick)"}
        res.update(_bound(c["flops"], c["bytes"]))
        _emit(res)
        results.append(res)
    return results


def _packed_segments(rng, B, S, n_docs=4):
    """[B, S] int32 ids of ``n_docs`` packed documents per row, cut at
    random positions (the monotone layout PackedLMDataset produces)."""
    cuts = np.sort(rng.integers(1, S, (B, n_docs - 1)), axis=1)
    return (np.arange(S)[None, :, None] >= cuts[:, None, :]).sum(-1).astype(
        np.int32)


def _visible_pairs(B, S, causal, seg):
    """The (query, key) pairs these inputs attend over, summed over the
    batch (per head): the work the kernels' loops need, not their
    tiles'."""
    if seg is None:
        return B * (S * (S + 1) // 2 if causal else S * S)
    total = 0
    for row in seg:
        for n in np.bincount(row):
            total += n * (n + 1) // 2 if causal else n * n
    return int(total)


def _flash_cases():
    """K1-K3 against their plain versions on the same inputs: the
    backward kernels take the plain forward's lse and delta."""
    from quintnet_tpu_torch.ops.flash_kernels import (flash_bwd_dkv,
                                                      flash_bwd_dkv_ref,
                                                      flash_bwd_dq,
                                                      flash_bwd_dq_ref,
                                                      flash_delta, flash_fwd,
                                                      flash_fwd_ref,
                                                      visible_pairs)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    rng = np.random.default_rng(4321)
    D, H = 64, 12
    # the first row is the train phase's shape: micro-batch 32 of 512
    shapes = [(TRAIN_CASE, 32, 512, True, False),
              ("causal_B8_S1024", 8, 1024, True, False),
              ("causal_segments_B4_S512", 4, 512, True, True),
              ("causal_ragged_B2_S300", 2, 300, True, False),
              ("noncausal_B8_S256", 8, 256, False, False),
              ("causal_B1_S4096", 1, 4096, True, False)]
    results = []
    for name, B, S, causal, use_seg in shapes:
        q, k, v, do = (torch.randn((B, H, S, D), generator=gen,
                                   device=DEVICE) for _ in range(4))
        seg_np = _packed_segments(rng, B, S) if use_seg else None
        seg = None if seg_np is None else torch.from_numpy(seg_np).to(DEVICE)
        o, lse = flash_fwd(q, k, v, seg, causal=causal)
        o_r, lse_r = flash_fwd_ref(q, k, v, seg, causal=causal)
        delta = flash_delta(o_r, do)
        bwd_in = (q, k, v, do, lse_r, delta, seg)
        dk, dv = flash_bwd_dkv(*bwd_in, causal=causal)
        dk_r, dv_r = flash_bwd_dkv_ref(*bwd_in, causal=causal)
        dq = flash_bwd_dq(*bwd_in, causal=causal)
        dq_r = flash_bwd_dq_ref(*bwd_in, causal=causal)
        torch.cuda.synchronize()
        errs = {}
        for key, got, want in (("o", o, o_r), ("lse", lse, lse_r),
                               ("dq", dq, dq_r), ("dk", dk, dk_r),
                               ("dv", dv, dv_r)):
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name}: kernel {key} not finite")
            errs[key] = float((got - want).abs().max()
                              / want.abs().max().clamp_min(1e-30))
            if errs[key] > KERNEL_TOL:
                raise AssertionError(
                    f"{name}: {key} max_abs_err / max|ref| = {errs[key]} > "
                    f"{KERNEL_TOL}")

        # SDPA yardstick: the same function, forward and forward+backward
        mask = (None if seg is None else
                visible_pairs(S, causal, seg, q.device).expand(B, 1, S, S))
        sdpa_kw = (dict(attn_mask=mask) if mask is not None
                   else dict(is_causal=causal))
        lib_fwd = _timed_ms(lambda: sdpa(q, k, v, **sdpa_kw))
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        lib_fwd_bwd = _timed_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg, **sdpa_kw), (qg, kg, vg), do))
        times = {
            "flash_fwd": (_timed_ms(lambda: flash_fwd(q, k, v, seg,
                                                      causal=causal)),
                          _timed_ms(lambda: flash_fwd_ref(q, k, v, seg,
                                                          causal=causal))),
            "flash_bwd_dkv": (
                _timed_ms(lambda: flash_bwd_dkv(*bwd_in, causal=causal)),
                _timed_ms(lambda: flash_bwd_dkv_ref(*bwd_in,
                                                    causal=causal))),
            "flash_bwd_dq": (
                _timed_ms(lambda: flash_bwd_dq(*bwd_in, causal=causal)),
                _timed_ms(lambda: flash_bwd_dq_ref(*bwd_in,
                                                   causal=causal))),
        }
        # each input read once, each output written once; 2 * D flops per
        # multiply-add over the visible pairs, 2 / 4 / 3 matmuls
        pairs = _visible_pairs(B, S, causal, seg_np) * H
        tile = B * H * S * D * 4
        row = B * H * S * 4
        seg_bytes = 0 if seg is None else B * S * 4
        work = {"flash_fwd": (2, 3 * tile + seg_bytes, tile + row),
                "flash_bwd_dkv": (4, 4 * tile + 2 * row + seg_bytes,
                                  2 * tile),
                "flash_bwd_dq": (3, 4 * tile + 2 * row + seg_bytes, tile)}
        for kern, (kernel_ms, plain_ms) in times.items():
            n_mm, read, written = work[kern]
            res = {"kernel": kern, "case": name, "B": B, "H": H, "S": S,
                   "D": D, "causal": causal, "segments": use_seg,
                   "max_abs_err": (max(errs["o"], errs["lse"])
                                   if kern == "flash_fwd" else
                                   max(errs["dk"], errs["dv"])
                                   if kern == "flash_bwd_dkv"
                                   else errs["dq"]),
                   "errors": errs,
                   "err_relative_to": "largest magnitude in the reference",
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": (lib_fwd if kern == "flash_fwd"
                                  else lib_fwd_bwd - lib_fwd),
                   "library": ("F.scaled_dot_product_attention forward "
                               "(yardstick)" if kern == "flash_fwd" else
                               "F.scaled_dot_product_attention forward+"
                               "backward minus forward: the whole backward, "
                               "dq, dk and dv (yardstick)")}
            res.update(_bound(2 * D * pairs * n_mm, read + written))
            _emit(res)
            results.append(res)
        del q, k, v, do, o, o_r, dk, dv, dq, dk_r, dv_r, dq_r, qg, kg, vg
    return results


def phase_kernels():
    from quintnet_tpu_torch.ops import build

    t0 = time.perf_counter()
    paths = build.build(["paged_attention", "flash_attention"])
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        ptxas[name] = ([ln.strip() for ln in log.read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
                       if log.exists() else ["(library was already built)"])
    _emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
           "libraries": {k: str(v.name) for k, v in paths.items()},
           "ptxas": ptxas})
    return _paged_cases(), _flash_cases()


# ---------------------------------------------------------------------
# phase 2: GPT-2 124M served on the card
# ---------------------------------------------------------------------

def _check_against_dense(params, cfg, eng, rids, prompts):
    """Teacher-forced greedy oracle: one dense forward per request over
    prompt + generated[:-1]; the argmax at each prompt-end-or-later
    position must be the engine's next token."""
    from quintnet_tpu_torch.models.gpt2 import gpt2_apply

    near_ties, checked = [], 0
    for rid, prompt in zip(rids, prompts):
        out = eng.result(rid)
        gen = out[len(prompt):]
        seq = torch.from_numpy(out[:-1].astype(np.int64)).to(DEVICE)[None]
        with torch.no_grad():
            logits = gpt2_apply(params, seq, cfg)[0]
        if not torch.isfinite(logits).all():
            raise AssertionError(f"request {rid}: dense logits not finite")
        rows = logits[len(prompt) - 1:]
        top2 = torch.topk(rows, 2, dim=-1)
        want = top2.indices[:, 0].cpu().numpy()
        gaps = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        for i, (w, g) in enumerate(zip(want, gen)):
            checked += 1
            if int(w) == int(g):
                continue
            gap = float(gaps[i])
            if gap >= 1e-3:
                raise AssertionError(
                    f"request {rid} step {i}: engine token {int(g)} != "
                    f"dense greedy {int(w)} with top-2 gap {gap}")
            near_ties.append({"rid": rid, "step": i, "engine": int(g),
                              "dense": int(w), "top2_gap": gap})
    return checked, near_ties


def _kernel_share(eng, cfg, rng) -> dict:
    """Over steady decode steps (8 rows, ~300-token contexts): the
    steps' wall time from a window run WITHOUT the profiler (it slows
    the host), then the kernel's device time, the device's busy time
    and the heaviest device ops from the next window of as many steps
    under ``torch.profiler`` (device durations do not depend on the
    host's pace)."""
    from torch.profiler import ProfilerActivity, profile

    steps = 6
    for _ in range(eng.max_slots):
        eng.submit(rng.integers(0, cfg.vocab_size, 300), 2 * steps + 8)
    eng.step()                       # admissions + first decode
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()                   # ends in a device->host token copy
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()

    # device-side events (kernels, copies) carry their own duration as
    # self device time; one stream, so their sum is the busy time
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.self_device_time_total, n + 1)
    busy_us = sum(us for us, _ in by_name.values())
    kern_us, launches = (0.0, 0)
    for name, (us, n) in by_name.items():
        if "paged_attention_f32_kernel" in name:
            kern_us, launches = kern_us + us, launches + n
    out = {"decode_steps_profiled": steps,
           "decode_step_ms": wall / steps * 1e3,
           "kernel_launches_profiled": launches,
           "device_launches_per_step": sum(n for _, n in by_name.values())
           / steps}
    if busy_us > 0:
        out["kernel_ms_per_step"] = kern_us / 1e3 / steps
        out["kernel_share_of_decode_step"] = kern_us / 1e6 / wall
        out["device_busy_ms_per_step"] = busy_us / 1e3 / steps
        out["device_idle_share"] = 1.0 - busy_us / 1e6 / wall
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        out["top_device_ops_ms_per_step"] = {
            name[:80]: us / 1e3 / steps for name, (us, _) in top}
    else:
        out["kernel_share_of_decode_step"] = "not measured (profiler " \
                                             "reported no device time)"
    return out


def phase_serve():
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from quintnet_tpu_torch.serve import ServeEngine, gpt2_family

    cfg = GPT2Config.base()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = gpt2_init(gen, cfg)
    eng = ServeEngine(gpt2_family(cfg), params, device=DEVICE, max_slots=8,
                      block_size=16, num_blocks=320)
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    lens = [32, 400, 120, 57, 250, 333, 75]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_new = 32
    steps = []                      # (wall s, admissions, decode tokens)

    def timed_step():
        a0, d0 = eng.metrics.admitted, eng.metrics.decode_tokens
        t = time.perf_counter()
        eng.step()                  # ends in a device->host token copy
        steps.append((time.perf_counter() - t, eng.metrics.admitted - a0,
                      eng.metrics.decode_tokens - d0))

    # main path: counts zeroed just before, read just after
    _zero_counts()
    rids = [eng.submit(p, max_new) for p in prompts]
    while eng.request(rids[2]).state != "finished":
        timed_step()
    # request 7 continues request 2's conversation: its prompt starts
    # with request 2's whole published chain (prompt + generated, a
    # partial last block), so admission hits the cache and copies on
    # write
    prev = eng.result(rids[2])
    follow = np.concatenate([prev[:-1], rng.integers(
        0, cfg.vocab_size, 60).astype(np.int32)])
    prompts.append(follow)
    rids.append(eng.submit(follow, max_new))
    while eng.has_work:
        timed_step()
    counts = _counts()
    launches = counts["paged_attention"]
    m = eng.metrics
    summ = m.summary()

    # every layer of every prefill and every decode step goes through
    # the kernel, and nothing else launches it
    expected = cfg.n_layer * (m.decode_steps + m.admitted)
    if launches < cfg.n_layer * m.decode_steps or launches != expected:
        raise AssertionError(
            f"paged_attention launched {launches} times; expected "
            f"n_layer x (decode steps + prefills) = {expected}")
    if m.prefix_hit_tokens < 64:
        raise AssertionError(f"prefix cache hit only "
                             f"{m.prefix_hit_tokens} tokens (< 64)")
    if m.finished != len(rids):
        raise AssertionError(f"{m.finished} of {len(rids)} finished")
    checked, near_ties = _check_against_dense(params, cfg, eng, rids,
                                              prompts)
    decode_only = [(w, d) for w, a, d in steps if a == 0]
    res = {"phase": "serve", "model": "gpt2-124M (random init, seed 0)",
           "requests": len(rids), "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": max_new, "warmup_s": warmup_s,
           "steps": m.steps, "decode_steps": m.decode_steps,
           "admitted": m.admitted, "decode_tokens": m.decode_tokens,
           "prefill_tokens": m.prefill_tokens,
           "prefix_hit_tokens": m.prefix_hit_tokens,
           "launches": counts,
           "decode_only_steps": len(decode_only),
           "decode_tokens_per_s": (sum(d for _, d in decode_only)
                                   / sum(w for w, _ in decode_only)),
           "ttft_p50_s": summ["ttft_s"]["p50"],
           "tokens_checked_vs_dense": checked, "near_ties": near_ties}
    res.update(_kernel_share(eng, cfg, rng))
    _emit(res)
    return res, counts


# ---------------------------------------------------------------------
# phase 3: GPT-2 124M trained on the card
# ---------------------------------------------------------------------

def _train_share(trainer, params, opt_state, batches) -> dict:
    """The step's wall time over steps run WITHOUT the profiler, then the
    device's busy time and the flash kernels' device time from as many
    further steps under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    n = len(batches) // 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches[:n]:
        trainer.step_fn(params, opt_state, trainer.device_batch(*b))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[n:]:
            trainer.step_fn(params, opt_state, trainer.device_batch(*b))
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.self_device_time_total, k + 1)
    busy_us = sum(us for us, _ in by_name.values())
    tokens = len(batches[0][0]) * batches[0][0].shape[1]
    out = {"steps_timed": n, "step_ms": wall * 1e3,
           "input_positions_per_s": tokens / wall,
           "peak_memory_gib": peak / 2 ** 30,
           "steps_profiled": len(batches) - n}
    if busy_us <= 0:
        out["kernel_share_of_step"] = ("not measured (profiler reported no "
                                       "device time)")
        return out
    per_step = lambda us: us / 1e3 / (len(batches) - n)  # noqa: E731
    kern = {}
    for name in FLASH_KERNELS:
        us, k = (0.0, 0)
        for ev, (t, c) in by_name.items():
            if f"{name}_f32_kernel" in ev:
                us, k = us + t, k + c
        kern[name] = {"ms_per_step": per_step(us),
                      "launches_per_step": k / (len(batches) - n),
                      "share_of_step": per_step(us) / (wall * 1e3)}
    gemm_us = sum(us for ev, (us, _) in by_name.items()
                  if "gemm" in ev.lower())
    out.update({
        "device_busy_ms_per_step": per_step(busy_us),
        "device_idle_share": 1.0 - per_step(busy_us) / (wall * 1e3),
        "flash_kernels": kern,
        "flash_share_of_step": sum(v["share_of_step"]
                                   for v in kern.values()),
        "gemm_ms_per_step": per_step(gemm_us),
        "device_ops_per_step": sum(k for _, k in by_name.values())
        / (len(batches) - n),
        "top_device_ops_ms_per_step": {
            name[:80]: per_step(us) for name, (us, _) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:8]}})
    return out


def phase_train():
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.core.pytree import tree_map
    from quintnet_tpu_torch.data import ByteTokenizer, SummarizationDataset
    from quintnet_tpu_torch.models.gpt2 import (GPT2Config, gpt2_init,
                                                gpt2_model_spec)
    from quintnet_tpu_torch.parallel.train_step import accumulate_grads
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = GPT2Config.base()          # every dropout rate 0: deterministic
    seq, batch, steps, n_micro, remat = 512, 64, 4, 2, False
    tcfg = Config.from_dict({"training": {
        "batch_size": batch, "gradient_accumulation_steps": n_micro,
        "optimizer": "adamw", "learning_rate": 5e-5, "weight_decay": 0.01,
        "grad_clip_norm": 1.0, "log_every": 0, "seed": 0}})
    ds = SummarizationDataset.synthetic(batch * 4, ByteTokenizer(),
                                        max_length=seq, seed=0)
    # one global batch per "epoch", so History.train_loss is per step;
    # 4 more batches for the timed and the profiled steps
    host = [next(iter(ds.batches(batch, seed=i))) for i in range(steps + 4)]
    params0 = gpt2_init(torch.Generator(device=DEVICE).manual_seed(0), cfg)

    def fresh():
        return tree_map(lambda p: p.detach().clone().requires_grad_(True),
                        params0)

    def trainer(use_flash):
        return Trainer(tcfg, gpt2_model_spec(cfg, remat=remat,
                                             use_flash=use_flash),
                       task_type="clm", device=DEVICE, log_fn=lambda m: None)

    flash, plain = trainer(True), trainer(False)

    # the first global batch: loss and every gradient leaf, same weights
    b0 = flash.device_batch(*host[0])
    p = fresh()
    loss_f, g_f = accumulate_grads(flash.model.loss_fn, p, b0, n_micro)
    loss_p, g_p = accumulate_grads(plain.model.loss_fn, p, b0, n_micro)
    loss_rel = abs(float(loss_f) - float(loss_p)) / abs(float(loss_p))
    if not loss_rel <= 1e-5:
        raise AssertionError(f"first-step loss: flash {float(loss_f)} vs "
                             f"plain {float(loss_p)} (rel {loss_rel})")
    grad_err = {".".join(k): float((g_f[k] - g_p[k]).abs().max()
                                   / g_p[k].abs().max().clamp_min(1e-30))
                for k in g_p}
    worst = max(grad_err, key=grad_err.get)
    if not grad_err[worst] <= 1e-3:
        raise AssertionError(f"gradient {worst}: max |flash - plain| / "
                             f"max |plain| = {grad_err[worst]} > 1e-3")
    del p, g_f, g_p

    # main path: counts zeroed just before, read just after
    params, opt_state = fresh(), None
    opt_state = flash.optimizer.init(params)
    _zero_counts()
    hist_f = flash.fit(lambda ep: [host[ep]], epochs=steps, params=params,
                       opt_state=opt_state)
    counts = _counts()
    per_kernel = cfg.n_layer * n_micro * steps
    want = {"flash_fwd": per_kernel * (2 if remat else 1),
            "flash_bwd_dkv": per_kernel, "flash_bwd_dq": per_kernel,
            "paged_attention": 0}
    if counts != want:
        raise AssertionError(f"launches {counts}; expected {want} (n_layer "
                             f"x micro-batches x steps)")

    pp = fresh()
    hist_p = plain.fit(lambda ep: [host[ep]], epochs=steps, params=pp,
                       opt_state=plain.optimizer.init(pp))
    del pp
    for i, (a, b) in enumerate(zip(hist_f.train_loss, hist_p.train_loss)):
        if not (np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise AssertionError(f"step {i}: loss flash {a} vs plain {b}")

    res = {"phase": "train", "model": "gpt2-124M f32 (random init, seed 0)",
           "global_batch": batch, "micro_batches": n_micro,
           "seq_len": seq, "steps": steps, "remat": remat,
           "optimizer": "adamw lr 5e-5 wd 0.01 clip 1.0",
           "first_loss_flash": float(loss_f), "first_loss_plain":
           float(loss_p), "first_loss_rel_diff": loss_rel,
           "worst_grad_leaf": worst, "worst_grad_rel_err": grad_err[worst],
           "loss_flash": hist_f.train_loss, "loss_plain": hist_p.train_loss,
           "fit_wall_s_flash": hist_f.wall_time_s,
           "fit_wall_s_plain": hist_p.wall_time_s, "launches": counts}
    res.update(_train_share(flash, params, opt_state, host[steps:]))
    _emit(res)
    return res, counts


# ---------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    import quintnet_tpu_torch  # noqa: F401  (fails here without the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paged_rows, flash_rows = phase_kernels()
    _res, serve_counts = phase_serve()
    _res, train_counts = phase_train()

    def entry(name, source, replaces, launches, rows, head):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"]}

    # each kernel's times at its main path's shape: the decode rows for
    # paged attention, the train micro-batch for flash attention
    kernels = [entry("paged_attention",
                     "quintnet_tpu_torch/ops/csrc/paged_attention.cu",
                     "quintnet_tpu/ops/paged_attention.py:91",
                     serve_counts["paged_attention"], paged_rows,
                     paged_rows[0])]
    for name, replaces in FLASH_KERNELS.items():
        rows = [r for r in flash_rows if r["kernel"] == name]
        kernels.append(entry(
            name, "quintnet_tpu_torch/ops/csrc/flash_attention.cu", replaces,
            train_counts[name], rows,
            next(r for r in rows if r["case"] == TRAIN_CASE)))
    _emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
