"""Fault-tolerance supervisor: relaunch training until it completes, inject
deterministic kills, and report goodput as one JSON line:

  {"metric": "ft_goodput", "value": 0.87, "unit": "fraction", "rc": 0,
   "extras": {"faults_survived": 2, "restarts": 2, "useful_steps": 18,
   "lost_steps": 1, "checkpoint_overhead_s": .., ...}}

Port of the JAX package's ``tools/ft_run.py``, with the same record. A
child that exits with a fault-tolerance code (75: preempted, emergency
snapshot saved; 113: a hard chaos kill) is relaunched, and the
step-granular cursor in the checkpoint (``quintnet_tpu_torch/ft/``)
makes the relaunched process continue mid-epoch with bit-identical
results (``tests/test_torch_ft.py`` holds the bit-identity; this tool
drives the restart loop end to end and prices it).

Faults are armed per attempt through the ``QT_CHAOS`` environment
variable: each launch gets the next unconsumed kill of ``--kill-at``
(global step numbers: the relaunched run resumes, passes its old death
point and dies at the next armed step).

  python -m quintnet_tpu_torch.tools.ft_run                  # 2 hard kills, card
  python -m quintnet_tpu_torch.tools.ft_run --device cpu --kill-at 5,11 \\
      --kill-mode sigterm
  python -m quintnet_tpu_torch.tools.ft_run --device cpu --epochs 2 \\
      --samples 32 --save-every 1 --kill-at 3 --kill-mode sigterm  # smoke
  python -m quintnet_tpu_torch.tools.ft_run --child ...      # one attempt

Each attempt trains the tiny ViT of the JAX tool on ``synthetic_mnist``
on ``--device`` (``cuda`` by default, ``cpu`` when asked). ``--out FILE``
appends the record to a JSON list in FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the directory that holds the package: the children import it from there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------
# child: one training attempt (resumes from whatever the checkpoint holds)
# ---------------------------------------------------------------------

def run_child(args) -> int:
    from quintnet_tpu_torch.core.config import Config
    from quintnet_tpu_torch.data import ArrayDataset, make_batches
    from quintnet_tpu_torch.data.datasets import synthetic_mnist
    from quintnet_tpu_torch.ft import (PREEMPTED_EXIT_CODE, ChaosMonkey,
                                       FTContext, GoodputMeter,
                                       PreemptionHandler, TrainingPreempted)
    from quintnet_tpu_torch.models.vit import ViTConfig, vit_model_spec
    from quintnet_tpu_torch.train.trainer import Trainer

    cfg = Config.from_dict({
        "mesh_dim": [1], "mesh_name": ["dp"],
        "training": {"batch_size": args.batch_size, "epochs": args.epochs,
                     "optimizer": "adam", "learning_rate": 1e-3,
                     "log_every": 0, "seed": args.seed,
                     "save_every_steps": args.save_every},
    })
    vcfg = ViTConfig(image_size=28, patch_size=7, in_channels=1,
                     hidden_dim=16, depth=2, num_heads=2, num_classes=10)
    ds = ArrayDataset(*synthetic_mnist(args.samples, seed=args.seed))

    trainer = Trainer(cfg, vit_model_spec(vcfg), device=args.device,
                      checkpoint_dir=os.path.join(args.run_dir,
                                                  "checkpoints"))
    meter = GoodputMeter(emit_markers=True)
    ft = FTContext(chaos=ChaosMonkey.from_env(), goodput=meter)
    with PreemptionHandler() as handler:
        ft.preemption = handler
        try:
            hist = trainer.fit(
                lambda ep, start=0: make_batches(
                    ds, args.batch_size, seed=ep, start_batch=start),
                ft=ft)
        except TrainingPreempted:
            meter.emit(completed=False)
            return PREEMPTED_EXIT_CODE
    hist.to_jsonl(os.path.join(args.run_dir, "history.jsonl"))
    meter.emit(completed=True)
    return 0


# ---------------------------------------------------------------------
# supervisor: the restart loop and the goodput record
# ---------------------------------------------------------------------

def supervise(args) -> dict:
    from quintnet_tpu_torch.ft.chaos import CHAOS_ENV, CHAOS_KILL_EXIT_CODE
    from quintnet_tpu_torch.ft.goodput import aggregate
    from quintnet_tpu_torch.ft.preempt import PREEMPTED_EXIT_CODE

    os.makedirs(args.run_dir, exist_ok=True)
    kills = ([int(k) for k in args.kill_at.split(",") if k]
             if args.kill_at else [])
    child_cmd = [sys.executable, "-m", "quintnet_tpu_torch.tools.ft_run",
                 "--child", "--run-dir", args.run_dir,
                 "--epochs", str(args.epochs),
                 "--samples", str(args.samples),
                 "--batch-size", str(args.batch_size),
                 "--save-every", str(args.save_every),
                 "--seed", str(args.seed), "--device", args.device]

    attempts, faults, restarts = [], [], 0
    last_ckpt = 0                 # the newest checkpointed global step known
    t0 = time.time()
    rc = None
    while True:
        env = dict(os.environ)
        env.pop(CHAOS_ENV, None)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        armed = kills[len(faults)] if len(faults) < len(kills) else None
        if armed is not None:
            env[CHAOS_ENV] = json.dumps(
                {"kill_at_step": armed, "mode": args.kill_mode})
        print(f"[ft_run] attempt {restarts + 1}"
              + (f" (armed: kill at step {armed}, {args.kill_mode})"
                 if armed is not None else ""), flush=True)
        resumed_at, killed_at = last_ckpt, None
        p = subprocess.Popen(child_cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        for line in p.stdout:
            s = line.decode(errors="replace")
            sys.stdout.write("  " + s)
            try:
                rec = json.loads(s)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            if "ft_attempt" in rec:
                attempts.append(rec["ft_attempt"])
                # a graceful exit checkpointed its last reached step (the
                # emergency snapshot, or the run's final save)
                last_ckpt = max(last_ckpt, rec["ft_attempt"]["reached"])
            elif "ft_start" in rec:
                resumed_at = last_ckpt = rec["ft_start"]["resumed_at"]
            elif "ft_kill" in rec:
                killed_at = rec["ft_kill"]["global_step"]
                faults.append({"kind": "hard_kill", **rec["ft_kill"]})
        rc = p.wait()
        print(f"[ft_run] attempt {restarts + 1} exited rc={rc}", flush=True)
        if rc == 0:
            break
        if killed_at is not None:
            # a hard kill emits no report: account its steps, possibly
            # lost, from the markers
            attempts.append({
                "resumed_at": resumed_at, "reached": killed_at,
                "steps_run": max(killed_at - resumed_at, 0),
                "wall_s": 0.0, "save_blocking_s": 0.0, "restore_s": 0.0,
                "fallback_steps": 0, "completed": False,
                "synthetic": True})
        if rc == PREEMPTED_EXIT_CODE and armed is not None:
            # a sigterm-mode kill: a graceful snapshot, no ft_kill marker
            faults.append({"kind": "preemption", "global_step": armed})
        if restarts >= args.max_restarts:
            print(f"[ft_run] giving up after {restarts} restarts "
                  f"(last rc={rc})", file=sys.stderr)
            break
        if rc not in (PREEMPTED_EXIT_CODE, CHAOS_KILL_EXIT_CODE):
            print(f"[ft_run] rc={rc} is not a fault-tolerance code "
                  "(75/113); restarting anyway, a preemption can kill "
                  "harder than SIGTERM", file=sys.stderr)
        restarts += 1

    g = aggregate(attempts, wall_s=time.time() - t0, final_step=last_ckpt)
    return {
        "metric": "ft_goodput",
        "value": g["goodput"],
        "unit": "fraction",
        "vs_baseline": 1.0,
        "rc": 0 if rc == 0 else 1,
        "extras": {
            **{k: v for k, v in g.items() if k != "goodput"},
            "faults_injected": len(kills),
            "faults_survived": len(faults),
            "restarts": restarts,
            "kill_mode": args.kill_mode,
            "kill_at": kills,
            "save_every_steps": args.save_every,
            "epochs": args.epochs,
            "samples": args.samples,
            "batch_size": args.batch_size,
            "completed": rc == 0,
        },
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true",
                    help="internal: run one training attempt")
    ap.add_argument("--run-dir", default="runs/ft")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--samples", type=int, default=96,
                    help="synthetic dataset size (steps an epoch = "
                         "samples // batch_size)")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--save-every", type=int, default=2,
                    help="checkpoint cadence in steps "
                         "(training.save_every_steps)")
    ap.add_argument("--kill-at", default="5,11",
                    help="comma-separated global steps to kill at, one "
                         "consumed an attempt ('' = no faults)")
    ap.add_argument("--kill-mode", default="hard",
                    choices=("hard", "sigterm"))
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="append the record to this JSON list file")
    args = ap.parse_args(argv)

    if args.child:
        sys.exit(run_child(args))

    out = supervise(args)
    print(json.dumps(out), flush=True)
    if args.out:
        records = []
        if os.path.exists(args.out):
            try:
                with open(args.out) as f:
                    prev = json.load(f)
                records = prev if isinstance(prev, list) else [prev]
            except (OSError, json.JSONDecodeError):
                records = []
        records.append(out)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    sys.exit(out["rc"])


if __name__ == "__main__":
    main()
