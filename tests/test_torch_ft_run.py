"""The port's fault-tolerance supervisor end to end on the CPU:
``python -m quintnet_tpu_torch.tools.ft_run --device cpu`` with one
injected kill (a SIGTERM preemption, or a hard kill), as the JAX
package's ``tests/test_ft_bench.py`` drives its ``tools/ft_run.py``:
the supervisor relaunches, the child resumes, the run completes, and
the one-line JSON record has JAX's schema.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kill mode -> (useful steps, lost steps): 2 epochs x 2 steps, a
# checkpoint after every step. The graceful kill after step 3 snapshots
# step 3, so the relaunch runs only step 4 and nothing is lost; the hard
# kill fires after step 3 and before its cadence save, so the relaunch
# resumes from step 2 and runs step 3 again
CASES = {"sigterm": (4, 0), "hard": (4, 1)}


@pytest.mark.parametrize("mode", sorted(CASES))
def test_ft_run_survives_injected_kill(tmp_path, mode):
    useful, lost = CASES[mode]
    out_file = str(tmp_path / "ft.json")
    env = {k: v for k, v in os.environ.items() if k != "QT_CHAOS"}
    out = subprocess.run(
        [sys.executable, "-m", "quintnet_tpu_torch.tools.ft_run",
         "--device", "cpu", "--run-dir", str(tmp_path / "run"),
         "--epochs", "2", "--samples", "32", "--batch-size", "16",
         "--save-every", "1", "--kill-at", "3", "--kill-mode", mode,
         "--out", out_file],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "ft_goodput"
    assert rec["rc"] == 0
    assert rec["unit"] == "fraction"
    ex = rec["extras"]
    assert ex["completed"] is True
    assert ex["restarts"] == 1
    assert ex["faults_survived"] == 1
    assert ex["useful_steps"] == useful
    assert ex["lost_steps"] == lost
    assert ex["attempts"] == 2
    assert ex["kill_mode"] == mode and ex["kill_at"] == [3]
    assert 0 < rec["value"] <= 1
    assert set(ex) >= {"steps_run", "step_time_s", "checkpoint_overhead_s",
                       "restore_overhead_s", "wall_s", "faults_injected",
                       "save_every_steps", "epochs", "samples",
                       "batch_size"}
    # --out appends the record to a JSON list
    assert json.load(open(out_file)) == [rec]
    hist = [json.loads(line)
            for line in open(tmp_path / "run" / "history.jsonl")]
    assert [r["epoch"] for r in hist[:-1]] == [0, 1]
