#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py            # all phases, one CUDA card

Phases (any failure raises and exits non-zero; nothing is caught):

1. **kernels** — build every CUDA source of the path with ``nvcc``
   (one process per source, started together), then hold each kernel
   to its plain PyTorch version at the main path's shapes (GPT-2 base
   heads, D = 64, block size 16): decode rows with mixed context
   lengths and a dead row, prefill tails at start 0 and at an offset
   that is not block-aligned, and a GQA case. Prints one JSON line per
   case with the error and the times of the kernel, the plain version
   and a PyTorch library call (``F.scaled_dot_product_attention`` over
   a view gathered beforehand — a yardstick only, never used by the
   port), plus the least time the card could take (``bound_ms``).
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


def phase_kernels():
    from quintnet_tpu_torch.ops import build
    from quintnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                        paged_attention_ref)

    t0 = time.perf_counter()
    paths = build.build(["paged_attention"])
    log = paths["paged_attention"].with_suffix(".log")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln]
             if log.exists() else ["(library was already built)"])
    _emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
           "libraries": {k: str(v.name) for k, v in paths.items()},
           "ptxas": ptxas})

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
        kernel_ms = _timed_ms(lambda: paged_attention(*args, **kw))
        plain_ms = _timed_ms(lambda: paged_attention_ref(*args, **kw))
        library_ms = _timed_ms(_library_fn(c))
        t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = c["flops"] / F32_FLOPS_PER_S * 1e3
        res = {"case": c["name"], "shape_q": list(c["q"].shape),
               "kv_heads": c["k"].shape[1], "starts": c["starts"].tolist(),
               "max_abs_err": err, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library": "F.scaled_dot_product_attention on a "
                          "pre-gathered view (yardstick)",
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": c["bytes"], "flops": c["flops"]}
        _emit(res)
        results.append(res)
    return results


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
    from quintnet_tpu_torch.ops.paged_attention import paged_attention
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
    paged_attention.launches = 0
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
    launches = paged_attention.launches
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
           "paged_attention_launches": launches,
           "decode_only_steps": len(decode_only),
           "decode_tokens_per_s": (sum(d for _, d in decode_only)
                                   / sum(w for w, _ in decode_only)),
           "ttft_p50_s": summ["ttft_s"]["p50"],
           "tokens_checked_vs_dense": checked, "near_ties": near_ties}
    res.update(_kernel_share(eng, cfg, rng))
    _emit(res)
    return res, launches


# ---------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on a CUDA card only", file=sys.stderr)
        return 2
    import quintnet_tpu_torch  # noqa: F401  (fails here without the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_rows = phase_kernels()
    _res, launches = phase_serve()
    head = kernel_rows[0]           # the decode shape of the main path
    _emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "quintnet_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "quintnet_tpu/ops/paged_attention.py:91",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]})
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
