#!/usr/bin/env python3
"""Time K4's decode-path calls of one checkout of the port, measured as
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

Two shapes, each in every KV layout (f32, fake_quant, int8, bf16, fp8),
GPT-2 base heads (12 query and kv heads, D = 64), block size 16, table
width 1,024 positions:

* ``decode``: ``chip_smoke.py``'s decode case, 8 rows with contexts of
  1,024 down to 1 position and a dead row (``DECODE_STARTS``).
* ``serve``: the shape of ``chip_smoke.py``'s profiled serve steps, 8
  rows of 309 positions each (start 308).

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
SHAPES = {"decode": dict(starts=cs.DECODE_STARTS, dead=(7,)),
          "serve": dict(starts=[308] * 8, dead=())}
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
    build.CSRC = out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose quintnet_tpu_torch is timed")
    ap.add_argument("--variant", choices=("rows4",), default=None)
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
    for shape, kw in SHAPES.items():
        for layout in LAYOUTS:
            gen = torch.Generator(device=cs.DEVICE).manual_seed(1234)
            c = cs._paged_case(gen, name=shape, S=8, Hq=12, Hkv=12, P=1,
                               layout=layout, **kw)
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
                   "layout": layout, "starts": c["starts"].tolist(),
                   "max_abs_err": err,
                   "kernel_ms": statistics.median(times),
                   "kernel_ms_all": times}
            row.update(cs._bound(c["flops"], c["bytes"]))
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
