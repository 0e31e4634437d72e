#!/usr/bin/env python3
"""Time K4's calls of one checkout of the port, measured as
``chip_smoke.py`` measures them, so that two versions of the kernel are
compared in one run on one card.

    python3 k4_decode_times.py                  # this checkout's port
    python3 k4_decode_times.py --root DIR       # the port in DIR (for
                                                # example `git archive` of
                                                # an earlier commit)
    python3 k4_decode_times.py --variant rows4  # this checkout's source with
                                                # the one-row decode kernel
                                                # taken out: every decode
                                                # call runs the 4-row one
    python3 k4_decode_times.py --path prefill [--root DIR] [--ttft]

Every shape in every KV layout (f32, fake_quant, int8, bf16, fp8), GPT-2
base heads (12 query and kv heads, D = 64), block size 16, table width
1,024 positions. ``--path decode`` (the default):

* ``decode``: ``chip_smoke.py``'s decode case, 8 rows with contexts of
  1,024 down to 1 position and a dead row (``DECODE_STARTS``).
* ``serve``: the shape of ``chip_smoke.py``'s profiled serve steps, 8
  rows of 309 positions each (start 308).

``--path prefill``: one row of P queries at start 0 for every bucket P in
``chip_smoke.PREFILL_BUCKETS`` (32-1,024; the serve phase's prefills
reach 32-512), each beside SDPA's yardstick (``chip_smoke._library_fn``).
``--ttft`` then serves ``chip_smoke.py``'s serve script once (GPT-2 124M,
f32 pool) and prints its TTFT p50.

Each call is held to ``paged_attention_ref`` within ``KERNEL_TOL`` and
timed by ``chip_smoke._graph_ms`` (20 calls captured in one CUDA graph,
replayed: device time), five times; the median is ``kernel_ms``. Prints
one JSON line per (shape, layout) with its bound (``chip_smoke._bound``),
then the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

REPEATS = 5
SHAPES = {"decode": {"decode": dict(S=8, P=1, starts=cs.DECODE_STARTS,
                                    dead=(7,)),
                     "serve": dict(S=8, P=1, starts=[308] * 8, dead=())},
          "prefill": {f"prefill_P{P}": dict(S=1, P=P, starts=[0], dead=())
                      for P in cs.PREFILL_BUCKETS}}
LAYOUTS = ("f32", "fake_quant", "int8", "bf16", "fp8")
# the one-row decode launches of launch_decode_any; without them a call of
# one query row a kv head runs the kDecodeRows instantiation
ONE_ROW_LAUNCHES = ("    if (one) QN_DECODE(1, kWide);\n",
                    "  if (one) QN_DECODE(1, 4);\n")


def _rows4_source(build) -> None:
    """Point ``build`` at a copy of paged_attention.cu without the one-row
    launches (kept under the gitignored build directory)."""
    src = (build.CSRC / "paged_attention.cu").read_text()
    for line in ONE_ROW_LAUNCHES:
        if src.count(line) != 1:
            raise SystemExit(f"rows4: {line.strip()!r} not found once in "
                             f"paged_attention.cu")
        src = src.replace(line, "")
    out = build.BUILD_DIR / "rows4"
    out.mkdir(parents=True, exist_ok=True)
    (out / "paged_attention.cu").write_text(src)
    for header in build.CSRC.glob("*.cuh"):
        (out / header.name).write_bytes(header.read_bytes())
    build.CSRC = out


def _ttft_p50_s() -> float:
    """TTFT p50 of ``chip_smoke.py``'s serve script (GPT-2 124M from seed
    0, f32 pool, 8 requests) through the imported port."""
    from quintnet_tpu_torch.models.gpt2 import GPT2Config, gpt2_init

    cfg = GPT2Config.base()
    params = gpt2_init(torch.Generator(device=cs.DEVICE).manual_seed(0), cfg)
    eng, _ = cs._serve_engine(params, cfg)
    rids, prompts, steps, _ = cs._serve_script(eng, cfg)
    return cs._serve_numbers(eng, rids, prompts, steps)["ttft_p50_s"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose quintnet_tpu_torch is timed")
    ap.add_argument("--variant", choices=("rows4",), default=None)
    ap.add_argument("--path", choices=tuple(SHAPES), default="decode",
                    help="the K4 path whose shapes are timed")
    ap.add_argument("--ttft", action="store_true",
                    help="also serve chip_smoke's script and print TTFT p50")
    ap.add_argument("--label", default=None,
                    help="tag for the output lines (default: the root)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_decode_times: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import quintnet_tpu_torch
    from quintnet_tpu_torch.ops import build
    from quintnet_tpu_torch.ops.paged_attention import (paged_attention,
                                                        paged_attention_ref)

    pkg = os.path.dirname(os.path.abspath(quintnet_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise SystemExit(f"quintnet_tpu_torch came from {pkg}, not {root}")
    if args.variant == "rows4":
        _rows4_source(build)
    torch.backends.cuda.matmul.allow_tf32 = False
    label = args.label or root
    for shape, kw in SHAPES[args.path].items():
        for layout in LAYOUTS:
            gen = torch.Generator(device=cs.DEVICE).manual_seed(1234)
            c = cs._paged_case(gen, name=shape, Hq=12, Hkv=12, layout=layout,
                               **kw)
            call_args = (c["q"], c["k"], c["v"], c["tables"], c["starts"])
            call_kw = dict(block_size=c["bs"], **c["kw"])
            out = paged_attention(*call_args, **call_kw)
            ref = paged_attention_ref(*call_args, **call_kw)
            err = float((out - ref).abs().max())
            if not err <= cs.KERNEL_TOL:
                raise AssertionError(f"{label} {shape} {layout}: max_abs_err "
                                     f"{err} > {cs.KERNEL_TOL}")
            times = [cs._graph_ms(lambda: paged_attention(*call_args,
                                                          **call_kw))
                     for _ in range(REPEATS)]
            row = {"label": label, "variant": args.variant, "shape": shape,
                   "layout": layout, "P": kw["P"],
                   "starts": c["starts"].tolist(), "max_abs_err": err,
                   "kernel_ms": statistics.median(times),
                   "kernel_ms_all": times}
            if args.path == "prefill":
                row["library_ms"] = cs._graph_ms(cs._library_fn(c))
            row.update(cs._bound(c["flops"], c["bytes"]))
            print(json.dumps(row), flush=True)
    if args.ttft:
        print(json.dumps({"label": label, "ttft_p50_s": _ttft_p50_s()}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
